"""DeepSeek-V3 HF key and layout mapping (counterpart of
``automodel_tpu/models/deepseek_v3/state_dict_adapter.py``).

MLA's projections transpose into latent-major layouts (``wkv_b`` (r, heads, nope + v),
``wo`` (heads, v, D)); per-expert HF tensors stack into gate_up / down; the gate's
``e_score_correction_bias`` is the port's f32 ``score_correction_bias``, read and
written in f32 whatever the checkpoint's dtype.
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.models.common.state_dict import Entry, MappingAdapter
from automodel_tpu_torch.models.deepseek_v3.model import DeepseekV3Config
from automodel_tpu_torch.models.llama.state_dict_adapter import (_o_in, _o_out, _proj_in,
                                                                 _proj_out, _t,
                                                                 dense_mlp_entries)
from automodel_tpu_torch.models.qwen3_moe.state_dict_adapter import moe_expert_entries

__all__ = ["DeepseekV3StateDictAdapter"]


def _f32(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.float32)


def _mla_entries(cfg: DeepseekV3Config, ours_prefix: str, layer_range) -> list[Entry]:
    """The norms and MLA projections of the layers in ``layer_range``, both q routes."""
    n, kv = cfg.num_attention_heads, cfg.qk_nope_head_dim + cfg.v_head_dim
    pre, attn = "model.layers.{i}", "model.layers.{i}.self_attn"

    def entry(hf, ours, *fns):
        return Entry(hf, f"{ours_prefix}.{ours}", *fns, layer_range=layer_range)

    entries = [
        entry(f"{pre}.input_layernorm.weight", "attn_norm"),
        entry(f"{pre}.post_attention_layernorm.weight", "mlp_norm"),
        entry(f"{attn}.kv_a_proj_with_mqa.weight", "wkv_a", _t, _t),
        entry(f"{attn}.kv_a_layernorm.weight", "kv_a_norm"),
        entry(f"{attn}.kv_b_proj.weight", "wkv_b", _proj_in(n, kv), _proj_out(n, kv)),
        entry(f"{attn}.o_proj.weight", "wo", _o_in(n, cfg.v_head_dim), _o_out(n, cfg.v_head_dim)),
    ]
    if cfg.q_lora_rank is None:
        return entries + [entry(f"{attn}.q_proj.weight", "wq", _proj_in(n, cfg.qk_head_dim),
                                _proj_out(n, cfg.qk_head_dim))]
    return entries + [
        entry(f"{attn}.q_a_proj.weight", "wq_a", _t, _t),
        entry(f"{attn}.q_a_layernorm.weight", "q_a_norm"),
        entry(f"{attn}.q_b_proj.weight", "wq_b", _proj_in(n, cfg.qk_head_dim),
              _proj_out(n, cfg.qk_head_dim)),
    ]


class DeepseekV3StateDictAdapter(MappingAdapter):
    def __init__(self, cfg: DeepseekV3Config):
        k, n_layers = cfg.first_k_dense_replace, cfg.num_hidden_layers
        moe_range = range(k, n_layers)
        pre = "model.layers.{i}.mlp"
        entries = [
            Entry("model.embed_tokens.weight", "embed"),
            Entry("model.norm.weight", "final_norm"),
            *_mla_entries(cfg, "moe_layers", moe_range),
            Entry(f"{pre}.gate.weight", "moe_layers.moe.gate.weight", layer_range=moe_range),
            Entry(f"{pre}.gate.e_score_correction_bias",
                  "moe_layers.moe.gate.score_correction_bias", _f32, _f32, optional=True,
                  keep_dtype=True, layer_range=moe_range),
            *moe_expert_entries(pre, "moe_layers.moe", layer_range=moe_range),
        ]
        if cfg.moe.n_shared_experts > 0:
            entries += [
                Entry(f"{pre}.shared_experts.{hf}_proj.weight",
                      f"moe_layers.moe.shared_experts.w_{ours}", _t, _t, layer_range=moe_range)
                for hf, ours in (("gate", "gate"), ("up", "up"), ("down", "down"))]
        if k > 0:
            entries += [*_mla_entries(cfg, "dense_layers", range(k)),
                        *dense_mlp_entries(cfg, "dense_layers", layer_range=range(k))]
        if not cfg.tie_word_embeddings:
            entries.append(Entry("lm_head.weight", "lm_head", _t, _t))
        super().__init__(entries, n_layers, num_experts=cfg.moe.n_routed_experts)
