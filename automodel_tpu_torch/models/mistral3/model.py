"""Ministral-3 (counterpart of ``automodel_tpu/models/mistral3/model.py``): the Llama
decoder, configured from ``rope_parameters``: its RoPE theta, its scaling (YaRN for
Ministral-3) and the Llama-4 long-context q scaling ``llama_4_scaling_beta`` (q *= 1 +
beta * log(1 + pos // original_max_position_embeddings)). Weights take Llama's names."""

from __future__ import annotations

import dataclasses
from typing import Any

from automodel_tpu_torch.models.llama.model import LlamaConfig, LlamaForCausalLM

__all__ = ["Ministral3Config", "Ministral3ForCausalLM"]


@dataclasses.dataclass
class Ministral3Config(LlamaConfig):
    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "Ministral3Config":
        """Llama's reading of the config, then ``rope_parameters`` as JAX reads it."""
        rope = hf.get("rope_parameters") or {}
        kwargs = dataclasses.asdict(LlamaConfig.from_hf(hf))
        kwargs["rope_theta"] = rope.get("rope_theta", kwargs["rope_theta"])
        rope_type = rope.get("rope_type") or rope.get("type", "default")
        if rope_type != "default":  # rope_parameters doubles as the scaling dict
            kwargs["rope_scaling"] = {"rope_type": rope_type, **rope}
        beta = rope.get("llama_4_scaling_beta")
        if beta is not None:
            kwargs["llama4_attn_scale_beta"] = float(beta)
            kwargs["original_max_position_embeddings"] = rope.get(
                "original_max_position_embeddings", kwargs["max_position_embeddings"])
        return cls(**kwargs)


class Ministral3ForCausalLM(LlamaForCausalLM):
    config_class = Ministral3Config
