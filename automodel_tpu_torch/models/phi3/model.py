"""Phi-3 / Phi-3.5 (counterpart of ``automodel_tpu/models/phi3/model.py``).

Phi-3 is the Llama decoder (silu-gated MLP, GQA, rotate-half RoPE, RMSNorm) with a
sliding window on every layer, longrope scaling for its 128k variants and, in its HF
checkpoints, fused ``qkv_proj`` / ``gate_up_proj`` tensors (split and fused again by its
adapter). So the family rides the port's Llama; Phi-3-mini's head_dim is 96.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from automodel_tpu_torch.models.llama.model import LlamaConfig, LlamaForCausalLM

__all__ = ["Phi3Config", "Phi3ForCausalLM"]


@dataclasses.dataclass
class Phi3Config(LlamaConfig):
    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "Phi3Config":
        """Build from an HF config.json dict, as the JAX package reads it: longrope reads
        the original and the current window (both top-level keys of Phi-3's config), so
        they are folded into ``rope_scaling``."""
        rope_scaling = hf.get("rope_scaling")
        if rope_scaling:
            rope_scaling = dict(
                rope_scaling,
                original_max_position_embeddings=hf.get(
                    "original_max_position_embeddings", hf.get("max_position_embeddings", 4096)),
                max_position_embeddings=hf.get("max_position_embeddings", 4096))
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim"),
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
            original_max_position_embeddings=hf.get("original_max_position_embeddings"),
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_scaling=rope_scaling,
            partial_rotary_factor=hf.get("partial_rotary_factor", 1.0),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            sliding_window=hf.get("sliding_window"),
            initializer_range=hf.get("initializer_range", 0.02),
        )


class Phi3ForCausalLM(LlamaForCausalLM):
    """Phi-3 / Phi-3.5 text models: Llama's parameters and forward, Phi-3's adapter."""

    config_class = Phi3Config

    def state_dict_adapter(self):
        from automodel_tpu_torch.models.phi3.state_dict_adapter import Phi3StateDictAdapter

        return Phi3StateDictAdapter(self.config)
