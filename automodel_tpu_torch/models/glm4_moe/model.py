"""The GLM-4-MoE family, GLM-4.5 / 4.6 / 4.5-Air (counterpart of
``automodel_tpu/models/glm4_moe/model.py``).

GQA attention with q / k / v biases, the optional per-head q/k RMSNorm and partial
rotary (GLM ropes the first half of head_dim by default); DeepSeek-style sigmoid routing,
group-limited, with the ``e_score_correction_bias`` that the gate-bias update moves
(factor 0.001, noaux-tc), routed scaling, one shared expert and a dense layer prefix.
The decode cache and ``generate`` are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from automodel_tpu_torch.models.common.moe_transformer import MoECausalLM, MoEDecoderConfig
from automodel_tpu_torch.moe.config import MoEConfig

__all__ = ["Glm4MoeConfig", "Glm4MoeForCausalLM", "rope_settings"]


def rope_settings(hf: dict[str, Any], default_partial: float) -> dict[str, Any]:
    """``rope_theta``, ``rope_scaling`` and ``partial_rotary_factor`` as JAX reads them from
    an HF config: ``rope_parameters`` first (it doubles as the scaling spec when its
    rope_type is not the default), then the top-level keys; never ``rotary_dim``."""
    rope = hf.get("rope_parameters") or {}
    scaling = hf.get("rope_scaling") or (
        rope if rope.get("rope_type") not in (None, "default") else None)
    return dict(rope_theta=rope.get("rope_theta", hf.get("rope_theta", 10000.0)),
                rope_scaling=scaling,
                partial_rotary_factor=rope.get("partial_rotary_factor",
                                               hf.get("partial_rotary_factor", default_partial)))


@dataclasses.dataclass
class Glm4MoeConfig(MoEDecoderConfig):
    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "Glm4MoeConfig":
        """Build from an HF config.json dict, with the JAX package's reading of it."""
        moe = MoEConfig(
            n_routed_experts=hf["n_routed_experts"],
            n_activated_experts=hf["num_experts_per_tok"],
            dim=hf["hidden_size"],
            moe_inter_dim=hf["moe_intermediate_size"],
            n_shared_experts=hf.get("n_shared_experts", 1),
            n_expert_groups=max(hf.get("n_group") or 1, 1),
            n_limited_groups=max(hf.get("topk_group") or 1, 1),
            gate_bias_update_factor=0.001,  # noaux-tc loss-free balancing
            score_func="sigmoid",
            route_scale=hf.get("routed_scaling_factor", 1.0),
            norm_topk_prob=hf.get("norm_topk_prob", True),
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
            **rope_settings(hf, 0.5),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            attention_bias=hf.get("attention_bias", False),
            qk_norm=hf.get("use_qk_norm", False),
            initializer_range=hf.get("initializer_range", 0.02),
            moe=moe,
            first_k_dense_replace=hf.get("first_k_dense_replace", 1),
        )


class Glm4MoeForCausalLM(MoECausalLM):
    config_class = Glm4MoeConfig

    def state_dict_adapter(self):
        from automodel_tpu_torch.models.glm4_moe.state_dict_adapter import (
            Glm4MoeStateDictAdapter)

        return Glm4MoeStateDictAdapter(self.config)
