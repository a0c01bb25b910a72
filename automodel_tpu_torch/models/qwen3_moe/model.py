"""Qwen3-MoE (counterpart of ``automodel_tpu/models/qwen3_moe/model.py``).

Qwen3 attention (per-head q/k RMSNorm, head_dim from the config) and softmax routing
with optional top-k renormalisation; every layer is MoE, or a dense prefix followed by
MoE layers (other dense/MoE interleavings raise, as in JAX).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from automodel_tpu_torch.models.common.moe_transformer import MoECausalLM, MoEDecoderConfig
from automodel_tpu_torch.moe.config import MoEConfig

__all__ = ["Qwen3MoeConfig", "Qwen3MoeForCausalLM"]


@dataclasses.dataclass
class Qwen3MoeConfig(MoEDecoderConfig):
    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "Qwen3MoeConfig":
        """Build from an HF config.json dict, with the JAX package's reading of it."""
        n_layers = hf["num_hidden_layers"]
        mlp_only = hf.get("mlp_only_layers") or []
        sparse_step = hf.get("decoder_sparse_step", 1)
        # dense-prefix patterns only (every released Qwen3-MoE checkpoint is all-MoE)
        moe_flags = [(i not in mlp_only) and sparse_step > 0 and ((i + 1) % sparse_step == 0)
                     for i in range(n_layers)]
        first_dense = moe_flags.index(True) if any(moe_flags) else n_layers
        if not all(moe_flags[first_dense:]):
            raise NotImplementedError("non-prefix dense/MoE interleavings are not supported")
        moe = MoEConfig(
            n_routed_experts=hf["num_experts"],
            n_activated_experts=hf["num_experts_per_tok"],
            dim=hf["hidden_size"],
            moe_inter_dim=hf["moe_intermediate_size"],
            score_func="softmax",
            softmax_before_topk=True,
            norm_topk_prob=hf.get("norm_topk_prob", False),
            aux_loss_coeff=hf.get("router_aux_loss_coef", 0.0),
        )
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=n_layers,
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim"),
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_scaling=hf.get("rope_scaling"),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            attention_bias=hf.get("attention_bias", False),
            qk_norm=True,
            initializer_range=hf.get("initializer_range", 0.02),
            moe=moe,
            first_k_dense_replace=first_dense,
        )


class Qwen3MoeForCausalLM(MoECausalLM):
    config_class = Qwen3MoeConfig

    def state_dict_adapter(self):
        from automodel_tpu_torch.models.qwen3_moe.state_dict_adapter import (
            Qwen3MoeStateDictAdapter)

        return Qwen3MoeStateDictAdapter(self.config)
