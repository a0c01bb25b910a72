"""MiniMax-M2 HF key mapping (counterpart of
``automodel_tpu/models/minimax_m2/state_dict_adapter.py``): Qwen3-MoE's expert layout and
the gate's ``e_score_correction_bias`` (kept in f32); no dense prefix."""

from __future__ import annotations

from automodel_tpu_torch.models.common.moe_transformer import MoEDecoderConfig
from automodel_tpu_torch.models.common.state_dict import Entry, MappingAdapter
from automodel_tpu_torch.models.glm4_moe.state_dict_adapter import correction_bias_entry
from automodel_tpu_torch.models.llama.state_dict_adapter import _t, attention_entries
from automodel_tpu_torch.models.qwen3_moe.state_dict_adapter import moe_expert_entries

__all__ = ["MiniMaxM2StateDictAdapter"]


class MiniMaxM2StateDictAdapter(MappingAdapter):
    def __init__(self, cfg: MoEDecoderConfig):
        entries = [
            Entry("model.embed_tokens.weight", "embed"),
            Entry("model.norm.weight", "final_norm"),
            *attention_entries(cfg, "moe_layers"),
            Entry("model.layers.{i}.mlp.gate.weight", "moe_layers.moe.gate.weight"),
            correction_bias_entry(),
            *moe_expert_entries("model.layers.{i}.mlp", "moe_layers.moe"),
        ]
        if not cfg.tie_word_embeddings:
            entries.append(Entry("lm_head.weight", "lm_head", _t, _t))
        super().__init__(entries, cfg.num_hidden_layers, num_experts=cfg.moe.n_routed_experts)
