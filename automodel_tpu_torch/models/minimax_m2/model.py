"""MiniMax-M2 (counterpart of ``automodel_tpu/models/minimax_m2/model.py``).

GQA attention with partial rotary, resolved as JAX resolves it (``rope_parameters`` /
``partial_rotary_factor``, never the config's ``rotary_dim``) and the per-head q/k
RMSNorm when ``use_qk_norm`` says so (JAX's reading; the published model normalises the
whole projection); every layer MoE, sigmoid scores with the ``e_score_correction_bias``
that checkpoints carry (created without the noaux-tc update), no shared expert, and the
aux loss at ``router_aux_loss_coef``. The decode cache and ``generate`` are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from automodel_tpu_torch.models.common.moe_transformer import MoECausalLM, MoEDecoderConfig
from automodel_tpu_torch.models.glm4_moe.model import rope_settings
from automodel_tpu_torch.moe.config import MoEConfig

__all__ = ["MiniMaxM2Config", "MiniMaxM2ForCausalLM"]


@dataclasses.dataclass
class MiniMaxM2Config(MoEDecoderConfig):
    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "MiniMaxM2Config":
        """Build from an HF config.json dict, with the JAX package's reading of it."""
        moe = MoEConfig(
            n_routed_experts=hf.get("num_local_experts", hf.get("num_experts")),
            n_activated_experts=hf["num_experts_per_tok"],
            dim=hf["hidden_size"],
            moe_inter_dim=hf.get("moe_intermediate_size", hf["intermediate_size"]),
            score_func=hf.get("scoring_func", "sigmoid"),
            route_scale=hf.get("routed_scaling_factor", 1.0),
            norm_topk_prob=hf.get("norm_topk_prob", True),
            force_score_correction_bias=True,
            aux_loss_coeff=hf.get("router_aux_loss_coef", 0.0),
        )
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim"),
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
            **rope_settings(hf, 1.0),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            attention_bias=hf.get("attention_bias", False),
            qk_norm=hf.get("use_qk_norm", False),
            initializer_range=hf.get("initializer_range", 0.02),
            moe=moe,
            first_k_dense_replace=0,
        )


class MiniMaxM2ForCausalLM(MoECausalLM):
    config_class = MiniMaxM2Config

    def state_dict_adapter(self):
        from automodel_tpu_torch.models.minimax_m2.state_dict_adapter import (
            MiniMaxM2StateDictAdapter)

        return MiniMaxM2StateDictAdapter(self.config)
