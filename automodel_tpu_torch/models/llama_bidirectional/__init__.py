from automodel_tpu_torch.models.llama_bidirectional.model import (
    LlamaBidirectionalConfig, LlamaBidirectionalModel, pool_hidden)

__all__ = ["LlamaBidirectionalConfig", "LlamaBidirectionalModel", "pool_hidden"]
