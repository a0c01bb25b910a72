from automodel_tpu_torch.models.gpt2.model import GPT2Config, GPT2LMHeadModel

__all__ = ["GPT2Config", "GPT2LMHeadModel"]
