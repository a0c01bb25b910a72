"""Bidirectional Llama encoder for retrieval and embeddings (counterpart of
``automodel_tpu/models/llama_bidirectional/model.py``).

A Llama trunk with the causal mask off, a tied embedding and no LM head, and a pooling
head: the tower the biencoder recipe trains. Pooling: ``avg`` (the mask-weighted mean),
``cls`` (the first token), ``last`` (the last real token). With ``backend.attention:
flash`` the layers launch the flash kernels non-causal, the segment ids masking the
right padding (the dense decoder passes them whenever the stack is not causal).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from automodel_tpu_torch.models.common.transformer import decoder_forward
from automodel_tpu_torch.models.llama.model import LlamaConfig, LlamaForCausalLM

__all__ = ["LlamaBidirectionalConfig", "LlamaBidirectionalModel", "pool_hidden"]


def pool_hidden(hidden: torch.Tensor, mask: torch.Tensor, pooling: str) -> torch.Tensor:
    """(B, S, D) hidden states and a (B, S) real-token mask -> (B, D)."""
    if pooling == "avg":
        maskf = mask.to(hidden.dtype)
        total = (hidden * maskf[..., None]).sum(dim=1)
        return total / maskf.sum(dim=1).clamp_min(1.0)[..., None]
    if pooling == "cls":
        return hidden[:, 0]
    if pooling == "last":
        last = (mask.sum(dim=1) - 1).clamp_min(0)
        return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]
    raise ValueError(f"unknown pooling {pooling!r} (avg | cls | last)")


@dataclasses.dataclass
class LlamaBidirectionalConfig(LlamaConfig):
    pooling: str = "avg"

    def __post_init__(self):
        super().__post_init__()
        self.causal = False

    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "LlamaBidirectionalConfig":
        if hf.get("temperature", 1.0) != 1.0:
            # the contrastive loss reads the recipe's, not the tower's
            raise ValueError(f"model.config.temperature {hf['temperature']!r} has no effect: "
                             "set biencoder.temperature")
        base = LlamaConfig.from_hf(hf)
        kwargs = {f.name: getattr(base, f.name) for f in dataclasses.fields(LlamaConfig)}
        kwargs["tie_word_embeddings"] = True  # an encoder: no lm_head
        return cls(**kwargs, pooling=hf.get("pooling", "avg"))


class LlamaBidirectionalModel(LlamaForCausalLM):
    """Llama's parameters and adapter; the forward returns pooled embeddings (B, D)."""

    config_class = LlamaBidirectionalConfig

    def forward(self, input_ids, positions=None, segment_ids=None, pooled: bool = True,
                mesh=None, params=None):
        """Pooled embeddings in the compute dtype, or the final hidden states with
        ``pooled=False``; ``params``: run on these tensors instead of the module's."""
        hidden = decoder_forward(self.config, self.backend,
                                 self.param_dict() if params is None else params, input_ids,
                                 positions=positions, segment_ids=segment_ids,
                                 return_hidden=True, mesh=mesh)
        if not pooled:
            return hidden
        mask = (segment_ids != 0 if segment_ids is not None
                else torch.ones(input_ids.shape, dtype=torch.bool, device=input_ids.device))
        return pool_hidden(hidden, mask, self.config.pooling)
