"""Mixtral HF key and layout mapping (counterpart of
``automodel_tpu/models/mixtral/state_dict_adapter.py``): Qwen3-MoE's expert-stacked
layout, under HF Mixtral's names: the MoE block ``block_sparse_moe``, its experts' w1
(gate), w3 (up) and w2 (down)."""

from __future__ import annotations

from automodel_tpu_torch.models.common.moe_transformer import MoEDecoderConfig
from automodel_tpu_torch.models.common.state_dict import Entry, MappingAdapter
from automodel_tpu_torch.models.llama.state_dict_adapter import _t, attention_entries
from automodel_tpu_torch.models.qwen3_moe.state_dict_adapter import _gate_up_in, _gate_up_out

__all__ = ["MixtralStateDictAdapter"]


class MixtralStateDictAdapter(MappingAdapter):
    def __init__(self, cfg: MoEDecoderConfig):
        n_layers = cfg.num_hidden_layers
        pre = "model.layers.{i}.block_sparse_moe"
        entries = [
            Entry("model.embed_tokens.weight", "embed"),
            Entry("model.norm.weight", "final_norm"),
            *attention_entries(cfg, "moe_layers"),
            Entry(f"{pre}.gate.weight", "moe_layers.moe.gate.weight"),
            Entry((f"{pre}.experts.{{e}}.w1.weight", f"{pre}.experts.{{e}}.w3.weight"),
                  "moe_layers.moe.experts.gate_up_proj", _gate_up_in, _gate_up_out),
            Entry(f"{pre}.experts.{{e}}.w2.weight", "moe_layers.moe.experts.down_proj", _t, _t),
        ]
        if not cfg.tie_word_embeddings:
            entries.append(Entry("lm_head.weight", "lm_head", _t, _t))
        super().__init__(entries, n_layers, num_experts=cfg.moe.n_routed_experts)
