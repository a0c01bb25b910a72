"""Qwen3.5-MoE, the text stack (counterpart of ``automodel_tpu/models/qwen3_5_moe/model.py``).

Qwen3-Next's hybrid decoder (``models/qwen3_next``) whose HF checkpoint stores the
DeltaNet projections apart (``in_proj_qkv`` / ``in_proj_z`` / ``in_proj_b`` /
``in_proj_a``) and the experts packed (``gate_up_proj (E, 2I, D)``, ``down_proj (E, D,
I)``): the adapter re-interleaves them into Qwen3-Next's fused layout, and the compute is
Qwen3-Next's. A ``*ForConditionalGeneration`` config gives its ``text_config``; the vision
tower's keys (``model.visual.*``) are not mapped, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from automodel_tpu_torch.models.qwen3_next.model import Qwen3NextConfig, Qwen3NextForCausalLM

__all__ = ["Qwen3_5MoeConfig", "Qwen3_5MoeForCausalLM"]


@dataclasses.dataclass
class Qwen3_5MoeConfig(Qwen3NextConfig):
    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "Qwen3_5MoeConfig":
        base = Qwen3NextConfig.from_hf(hf.get("text_config", hf))
        return cls(**{f.name: getattr(base, f.name) for f in dataclasses.fields(base)})


class Qwen3_5MoeForCausalLM(Qwen3NextForCausalLM):
    config_class = Qwen3_5MoeConfig

    def state_dict_adapter(self):
        from automodel_tpu_torch.models.qwen3_5_moe.state_dict_adapter import (
            Qwen3_5MoeStateDictAdapter)

        return Qwen3_5MoeStateDictAdapter(self.config)
