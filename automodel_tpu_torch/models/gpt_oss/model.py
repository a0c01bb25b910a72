"""GPT-OSS (counterpart of ``automodel_tpu/models/gpt_oss/model.py``).

Every layer is MoE, with attention sinks (a per-head logit in the softmax), sliding and
full attention layers as ``layer_types`` alternates them, biases on the attention and
expert projections and on the router, quick_geglu experts (clamped x sigmoid(1.702 x)
gate, +1 on up) and softmax after top-k, and YaRN RoPE. Generation is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from automodel_tpu_torch.models.common.moe_transformer import MoECausalLM, MoEDecoderConfig
from automodel_tpu_torch.moe.config import MoEConfig

__all__ = ["GptOssConfig", "GptOssForCausalLM"]


@dataclasses.dataclass
class GptOssConfig(MoEDecoderConfig):
    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "GptOssConfig":
        """Build from an HF config.json dict, with the JAX package's reading of it."""
        moe = MoEConfig(
            n_routed_experts=hf["num_local_experts"],
            n_activated_experts=hf["num_experts_per_tok"],
            dim=hf["hidden_size"],
            moe_inter_dim=hf["intermediate_size"],
            score_func="softmax",
            norm_topk_prob=hf.get("norm_topk_prob", False),
            aux_loss_coeff=hf.get("router_aux_loss_coef", 0.0),
            router_bias=True,
            expert_bias=True,
            expert_activation="quick_geglu",
            activation_alpha=1.702,
            activation_limit=hf.get("swiglu_limit", 7.0),
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
            rope_theta=hf.get("rope_theta", 150000.0),
            rope_scaling=hf.get("rope_scaling"),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            attention_bias=hf.get("attention_bias", True),
            attention_out_bias=hf.get("attention_bias", True),
            attention_sinks=True,
            sliding_window=hf.get("sliding_window"),
            layer_types=hf.get("layer_types"),
            initializer_range=hf.get("initializer_range", 0.02),
            moe=moe,
        )


class GptOssForCausalLM(MoECausalLM):
    """Random init (biases and sinks at 0, as the JAX package's), the MoE decoder's
    forward, and the HF adapter with the interleaved expert ``gate_up_proj``."""

    config_class = GptOssConfig

    def state_dict_adapter(self):
        from automodel_tpu_torch.models.gpt_oss.state_dict_adapter import (
            GptOssStateDictAdapter)

        return GptOssStateDictAdapter(self.config)
