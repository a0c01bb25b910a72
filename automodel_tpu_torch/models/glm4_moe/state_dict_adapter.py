"""GLM-4-MoE HF key mapping (counterpart of
``automodel_tpu/models/glm4_moe/state_dict_adapter.py``): Qwen3-MoE's per-expert tensors
plus DeepSeek's extras, the gate's ``e_score_correction_bias`` (kept in f32) and one
``shared_experts`` MLP a MoE layer, after a dense prefix."""

from __future__ import annotations

from automodel_tpu_torch.models.common.moe_transformer import MoEDecoderConfig
from automodel_tpu_torch.models.common.state_dict import Entry, MappingAdapter
from automodel_tpu_torch.models.llama.state_dict_adapter import (_t, attention_entries,
                                                                 dense_mlp_entries)
from automodel_tpu_torch.models.qwen3_moe.state_dict_adapter import moe_expert_entries

__all__ = ["Glm4MoeStateDictAdapter", "correction_bias_entry", "shared_expert_entries"]


def shared_expert_entries(moe_range, hf_name: str = "shared_experts") -> list[Entry]:
    """The shared expert's gate / up / down of each MoE layer."""
    pre, ours = f"model.layers.{{i}}.mlp.{hf_name}", "moe_layers.moe.shared_experts"
    return [Entry(f"{pre}.{hf}_proj.weight", f"{ours}.w_{w}", _t, _t, layer_range=moe_range)
            for hf, w in (("gate", "gate"), ("up", "up"), ("down", "down"))]


def correction_bias_entry(moe_range=None) -> Entry:
    return Entry("model.layers.{i}.mlp.gate.e_score_correction_bias",
                 "moe_layers.moe.gate.score_correction_bias", layer_range=moe_range,
                 keep_dtype=True)


class Glm4MoeStateDictAdapter(MappingAdapter):
    def __init__(self, cfg: MoEDecoderConfig):
        k, n_layers = cfg.first_k_dense_replace, cfg.num_hidden_layers
        moe_range = range(k, n_layers)
        entries = [
            Entry("model.embed_tokens.weight", "embed"),
            Entry("model.norm.weight", "final_norm"),
            *attention_entries(cfg, "moe_layers", layer_range=moe_range),
            Entry("model.layers.{i}.mlp.gate.weight", "moe_layers.moe.gate.weight",
                  layer_range=moe_range),
            correction_bias_entry(moe_range),
            *moe_expert_entries("model.layers.{i}.mlp", "moe_layers.moe", layer_range=moe_range),
        ]
        if cfg.moe.n_shared_experts > 0:
            entries += shared_expert_entries(moe_range)
        if k > 0:
            entries += [*attention_entries(cfg, "dense_layers", layer_range=range(k)),
                        *dense_mlp_entries(cfg, "dense_layers", layer_range=range(k))]
        if not cfg.tie_word_embeddings:
            entries.append(Entry("lm_head.weight", "lm_head", _t, _t))
        super().__init__(entries, n_layers, num_experts=cfg.moe.n_routed_experts)
