"""Llama-lineage HF key and layout mapping (counterpart of
``automodel_tpu/models/llama/state_dict_adapter.py``, every branch of it).

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


def _bias_in(heads: int, head_dim: int):
    """HF (heads*head_dim,) -> ours (heads, head_dim)."""
    return lambda b: b.reshape(heads, head_dim)


def _bias_out(heads: int, head_dim: int):
    return lambda b: b.reshape(heads * head_dim)


def _flat_in(heads: int, head_dim: int):
    """HF's flat (heads*head_dim,) whole-projection norm -> ours (heads, head_dim)."""
    return lambda w: w.reshape(heads, head_dim)


def _flat_out(w: torch.Tensor) -> torch.Tensor:
    return w.reshape(-1).contiguous()


def norm_entries(cfg: DenseDecoderConfig, ours_prefix: str = "layers",
                 layer_range=None) -> list[Entry]:
    """A layer's block norms under HF's names for the config's placement: the input norm
    and post_attention_layernorm (pre, sandwich), post_attention_layernorm and
    post_feedforward_layernorm on the sublayers' outputs (post: OLMo-2), one input norm
    under the parallel block (Cohere), the sandwich's post_self_attn_layernorm and
    post_mlp_layernorm (GLM-4), their biases with norm_bias, and no weights at all without
    norm_param (OLMo v1)."""
    pre = "model.layers.{i}"
    post = cfg.norm_placement == "post"
    attn_key = f"{pre}.post_attention_layernorm" if post else f"{pre}.input_layernorm"
    mlp_key = f"{pre}.post_feedforward_layernorm" if post else f"{pre}.post_attention_layernorm"
    keys = [(attn_key, "attn_norm")]
    if not cfg.parallel_block:
        keys.append((mlp_key, "mlp_norm"))
    entries = []
    if cfg.norm_param:
        entries += [Entry(f"{key}.weight", f"{ours_prefix}.{ours}", layer_range=layer_range)
                    for key, ours in keys]
    if cfg.norm_bias:
        entries += [Entry(f"{key}.bias", f"{ours_prefix}.{ours}_b", layer_range=layer_range)
                    for key, ours in keys]
    if cfg.norm_placement == "sandwich":
        entries += [Entry(f"{pre}.post_self_attn_layernorm.weight",
                          f"{ours_prefix}.attn_post_norm", layer_range=layer_range),
                    Entry(f"{pre}.post_mlp_layernorm.weight", f"{ours_prefix}.mlp_post_norm",
                          layer_range=layer_range)]
    return entries


def attention_entries(cfg: DenseDecoderConfig, ours_prefix: str = "layers",
                      layer_range=None) -> list[Entry]:
    """GQA attention and the block norms of a layer (:func:`norm_entries`): the q / k / v
    biases with attention_bias, the o bias with attention_out_bias, the sinks with
    attention_sinks (gpt-oss), and the q/k norms: Qwen3's (head_dim,) weights, Cohere+'s
    per-head (heads, head_dim) ones, or OLMo-2's whole-projection ones, flat (heads *
    head_dim,) in HF's files."""
    n, k, h = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    pre = "model.layers.{i}"
    entries = [
        *norm_entries(cfg, ours_prefix, layer_range),
        Entry(f"{pre}.self_attn.q_proj.weight", f"{ours_prefix}.wq", _proj_in(n, h),
              _proj_out(n, h), layer_range=layer_range),
        Entry(f"{pre}.self_attn.k_proj.weight", f"{ours_prefix}.wk", _proj_in(k, h),
              _proj_out(k, h), layer_range=layer_range),
        Entry(f"{pre}.self_attn.v_proj.weight", f"{ours_prefix}.wv", _proj_in(k, h),
              _proj_out(k, h), layer_range=layer_range),
        Entry(f"{pre}.self_attn.o_proj.weight", f"{ours_prefix}.wo", _o_in(n, h),
              _o_out(n, h), layer_range=layer_range),
    ]
    if cfg.attention_bias:
        entries += [
            Entry(f"{pre}.self_attn.{hf}_proj.bias", f"{ours_prefix}.b{hf}",
                  _bias_in(heads, h), _bias_out(heads, h), layer_range=layer_range)
            for hf, heads in (("q", n), ("k", k), ("v", k))]
    if cfg.attention_out_bias:
        entries.append(Entry(f"{pre}.self_attn.o_proj.bias", f"{ours_prefix}.bo",
                             layer_range=layer_range))
    if cfg.attention_sinks:
        entries.append(Entry(f"{pre}.self_attn.sinks", f"{ours_prefix}.sinks",
                             layer_range=layer_range))
    if cfg.qk_norm_whole:
        entries += [
            Entry(f"{pre}.self_attn.{x}_norm.weight", f"{ours_prefix}.{x}_norm",
                  _flat_in(heads, h), _flat_out, layer_range=layer_range)
            for x, heads in (("q", n), ("k", k))]
    elif cfg.qk_norm:
        entries += [
            Entry(f"{pre}.self_attn.q_norm.weight", f"{ours_prefix}.q_norm",
                  layer_range=layer_range),
            Entry(f"{pre}.self_attn.k_norm.weight", f"{ours_prefix}.k_norm",
                  layer_range=layer_range),
        ]
    return entries


def dense_mlp_entries(cfg: DenseDecoderConfig, ours_prefix: str = "layers",
                      layer_range=None) -> list[Entry]:
    """The dense MLP: gate / up / down, without the gate when ``cfg`` is ungated (Arcee,
    StarCoder2), under ``cfg.hf_mlp_names`` where it renames up / down (StarCoder2's c_fc
    / c_proj), with the biases of mlp_bias."""
    pre = "model.layers.{i}.mlp"
    up, down = cfg.hf_mlp_names or ("up_proj", "down_proj")
    names = [("gate_proj", "w_gate")] if cfg.mlp_gated else []
    names += [(up, "w_up"), (down, "w_down")]
    entries = [Entry(f"{pre}.{hf}.weight", f"{ours_prefix}.{ours}", _t, _t,
                     layer_range=layer_range) for hf, ours in names]
    if cfg.mlp_bias:
        entries += [Entry(f"{pre}.{hf}.bias", f"{ours_prefix}.b_{ours[2:]}",
                          layer_range=layer_range) for hf, ours in names]
    return entries


class LlamaStateDictAdapter(MappingAdapter):
    def __init__(self, cfg: DenseDecoderConfig):
        entries = [Entry("model.embed_tokens.weight", "embed")]
        if cfg.norm_param:
            entries.append(Entry("model.norm.weight", "final_norm"))
        if cfg.norm_bias:
            entries.append(Entry("model.norm.bias", "final_norm_b"))
        entries += [*attention_entries(cfg), *dense_mlp_entries(cfg)]
        if not cfg.tie_word_embeddings:
            entries.append(Entry("lm_head.weight", "lm_head", _t, _t))
        super().__init__(entries, cfg.num_hidden_layers)
