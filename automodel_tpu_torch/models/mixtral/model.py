"""Mixtral-8x7B / 8x22B (counterpart of ``automodel_tpu/models/mixtral/model.py``): Llama's
GQA attention (no q/k norm) and a top-2 MoE block on every layer, on the port's MoE
decoder. HF's "top-k of the logits, then a softmax over them" equals "softmax over all,
top-k, renormalise" (softmax is monotonic, and the renormalised selected probabilities
are the softmax over the selected logits), which is the gate's ``softmax_before_topk`` and
``norm_topk_prob`` path; the full softmax also feeds the aux balance loss, as HF's
router does, at ``router_aux_loss_coef`` (0.02 by default)."""

from __future__ import annotations

import dataclasses
from typing import Any

from automodel_tpu_torch.models.common.moe_transformer import MoECausalLM, MoEDecoderConfig
from automodel_tpu_torch.moe.config import MoEConfig

__all__ = ["MixtralConfig", "MixtralForCausalLM"]


@dataclasses.dataclass
class MixtralConfig(MoEDecoderConfig):
    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "MixtralConfig":
        """Build from an HF config.json dict, as the JAX package reads it."""
        moe = MoEConfig(
            n_routed_experts=hf["num_local_experts"],
            n_activated_experts=hf.get("num_experts_per_tok", 2),
            dim=hf["hidden_size"],
            moe_inter_dim=hf["intermediate_size"],
            score_func="softmax",
            softmax_before_topk=True,
            norm_topk_prob=True,
            aux_loss_coeff=hf.get("router_aux_loss_coef", 0.02),
        )
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim"),
            max_position_embeddings=hf.get("max_position_embeddings", 32768),
            rope_theta=hf.get("rope_theta", 1e6),
            rope_scaling=hf.get("rope_scaling"),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            sliding_window=hf.get("sliding_window"),
            initializer_range=hf.get("initializer_range", 0.02),
            moe=moe,
            first_k_dense_replace=0,
        )


class MixtralForCausalLM(MoECausalLM):
    config_class = MixtralConfig

    def state_dict_adapter(self):
        from automodel_tpu_torch.models.mixtral.state_dict_adapter import (
            MixtralStateDictAdapter)

        return MixtralStateDictAdapter(self.config)
