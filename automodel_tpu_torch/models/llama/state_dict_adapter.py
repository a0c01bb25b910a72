"""Llama HF key and layout mapping (counterpart of
``automodel_tpu/models/llama/state_dict_adapter.py``, for the members of the lineage
the port has).

HF linear weights are (out_features, in_features); the port's layout is (in, out),
or (in, heads, head_dim) / (heads, head_dim, out) for attention, so every projection
transposes and reshapes on the way in and back out.
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.models.common.state_dict import Entry, MappingAdapter
from automodel_tpu_torch.models.common.transformer import DenseDecoderConfig

__all__ = ["LlamaStateDictAdapter"]


def _proj_in(heads: int, head_dim: int):
    """HF (heads*head_dim, D) -> ours (D, heads, head_dim)."""
    return lambda w: w.T.reshape(w.shape[1], heads, head_dim).contiguous()


def _proj_out(heads: int, head_dim: int):
    return lambda w: w.reshape(w.shape[0], heads * head_dim).T.contiguous()


def _o_in(heads: int, head_dim: int):
    """HF o_proj (D, heads*head_dim) -> ours (heads, head_dim, D)."""
    return lambda w: w.T.reshape(heads, head_dim, w.shape[0]).contiguous()


def _o_out(heads: int, head_dim: int):
    return lambda w: w.reshape(heads * head_dim, w.shape[2]).T.contiguous()


def _t(w: torch.Tensor) -> torch.Tensor:
    return w.T.contiguous()


def attention_entries(cfg: DenseDecoderConfig, ours_prefix: str = "layers",
                      layer_range=None) -> list[Entry]:
    """GQA attention and the two norms of a layer (the Qwen3 q/k norms with qk_norm)."""
    n, k, h = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    pre = "model.layers.{i}"
    entries = [
        Entry(f"{pre}.input_layernorm.weight", f"{ours_prefix}.attn_norm",
              layer_range=layer_range),
        Entry(f"{pre}.post_attention_layernorm.weight", f"{ours_prefix}.mlp_norm",
              layer_range=layer_range),
        Entry(f"{pre}.self_attn.q_proj.weight", f"{ours_prefix}.wq", _proj_in(n, h),
              _proj_out(n, h), layer_range=layer_range),
        Entry(f"{pre}.self_attn.k_proj.weight", f"{ours_prefix}.wk", _proj_in(k, h),
              _proj_out(k, h), layer_range=layer_range),
        Entry(f"{pre}.self_attn.v_proj.weight", f"{ours_prefix}.wv", _proj_in(k, h),
              _proj_out(k, h), layer_range=layer_range),
        Entry(f"{pre}.self_attn.o_proj.weight", f"{ours_prefix}.wo", _o_in(n, h),
              _o_out(n, h), layer_range=layer_range),
    ]
    if cfg.qk_norm:
        entries += [
            Entry(f"{pre}.self_attn.q_norm.weight", f"{ours_prefix}.q_norm",
                  layer_range=layer_range),
            Entry(f"{pre}.self_attn.k_norm.weight", f"{ours_prefix}.k_norm",
                  layer_range=layer_range),
        ]
    return entries


def dense_mlp_entries(ours_prefix: str = "layers", layer_range=None) -> list[Entry]:
    pre = "model.layers.{i}.mlp"
    return [Entry(f"{pre}.{hf}.weight", f"{ours_prefix}.{ours}", _t, _t, layer_range=layer_range)
            for hf, ours in (("gate_proj", "w_gate"), ("up_proj", "w_up"),
                             ("down_proj", "w_down"))]


class LlamaStateDictAdapter(MappingAdapter):
    def __init__(self, cfg: DenseDecoderConfig):
        entries = [
            Entry("model.embed_tokens.weight", "embed"),
            Entry("model.norm.weight", "final_norm"),
            *attention_entries(cfg),
            *dense_mlp_entries(),
        ]
        if not cfg.tie_word_embeddings:
            entries.append(Entry("lm_head.weight", "lm_head", _t, _t))
        super().__init__(entries, cfg.num_hidden_layers)
