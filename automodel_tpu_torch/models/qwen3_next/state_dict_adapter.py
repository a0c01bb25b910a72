"""Qwen3-Next HF key mapping (counterpart of
``automodel_tpu/models/qwen3_next/state_dict_adapter.py``).

HF numbers the layers 0..L-1 with linear and full attention interleaved; the port stacks
each kind apart, so every per-layer entry pins its ``layer_range``. HF's fused
projections (``in_proj_qkvz``, ``in_proj_ba``, ``q_proj`` with its output gate) stay
fused: the transforms are transposes and reshapes.
"""

from __future__ import annotations

import dataclasses

import torch

from automodel_tpu_torch.models.common.state_dict import Entry, MappingAdapter
from automodel_tpu_torch.models.llama.state_dict_adapter import (_o_in, _o_out, _proj_in,
                                                                 _proj_out, _t)
from automodel_tpu_torch.models.qwen3_moe.state_dict_adapter import moe_expert_entries

__all__ = ["Qwen3NextStateDictAdapter", "full_attention_entries", "fused_in", "fused_out",
           "linear_tail_entries", "shared_expert_entries"]


def fused_in(heads: int):
    """HF (heads * M, D) -> ours (D, heads, M)."""
    return lambda w: w.T.reshape(w.shape[1], heads, -1).contiguous()


def fused_out(w: torch.Tensor) -> torch.Tensor:
    return w.reshape(w.shape[0], -1).T.contiguous()


def _conv_in(w: torch.Tensor) -> torch.Tensor:
    return w[:, 0, :]  # (C, 1, K) -> (C, K)


def _conv_out(w: torch.Tensor) -> torch.Tensor:
    return w[:, None, :]


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def linear_tail_entries(cfg, pre: str, idx) -> list[Entry]:
    """The DeltaNet layer's conv, dt_bias, A_log (kept in f32: bf16 rounding perturbs
    every step of the recurrence), gated norm and output projection."""
    hv, dv = cfg.linear_num_value_heads, cfg.linear_value_head_dim
    return [
        Entry(f"{pre}.linear_attn.conv1d.weight", "linear_layers.conv_w", _conv_in, _conv_out,
              layer_range=idx),
        Entry(f"{pre}.linear_attn.dt_bias", "linear_layers.dt_bias", layer_range=idx),
        Entry(f"{pre}.linear_attn.A_log", "linear_layers.a_log", _f32, keep_dtype=True,
              layer_range=idx),
        Entry(f"{pre}.linear_attn.norm.weight", "linear_layers.norm", layer_range=idx),
        Entry(f"{pre}.linear_attn.out_proj.weight", "linear_layers.wo", _o_in(hv, dv),
              _o_out(hv, dv), layer_range=idx),
    ]


def full_attention_entries(cfg, pre: str, idx) -> list[Entry]:
    """The gated full attention's q (fused with its gate), k, v, o and q/k norms."""
    h, kh, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    return [
        Entry(f"{pre}.self_attn.q_proj.weight", "full_layers.wq", fused_in(h), fused_out,
              layer_range=idx),
        Entry(f"{pre}.self_attn.k_proj.weight", "full_layers.wk", _proj_in(kh, dh),
              _proj_out(kh, dh), layer_range=idx),
        Entry(f"{pre}.self_attn.v_proj.weight", "full_layers.wv", _proj_in(kh, dh),
              _proj_out(kh, dh), layer_range=idx),
        Entry(f"{pre}.self_attn.o_proj.weight", "full_layers.wo", _o_in(h, dh), _o_out(h, dh),
              layer_range=idx),
        Entry(f"{pre}.self_attn.q_norm.weight", "full_layers.q_norm", layer_range=idx),
        Entry(f"{pre}.self_attn.k_norm.weight", "full_layers.k_norm", layer_range=idx),
    ]


def shared_expert_entries(pre: str, stack: str, idx, optional: bool = False) -> list[Entry]:
    """The gated shared expert's gate / up / down and its gate (optional in Qwen3.5-MoE's
    checkpoints)."""
    ours = f"{stack}.moe.shared_experts"
    return [*(Entry(f"{pre}.mlp.shared_expert.{w}_proj.weight", f"{ours}.w_{w}", _t, _t,
                    optional=optional, layer_range=idx) for w in ("gate", "up", "down")),
            Entry(f"{pre}.mlp.shared_expert_gate.weight", f"{stack}.moe.shared_expert_gate",
                  _t, _t, optional=optional, layer_range=idx)]


class Qwen3NextStateDictAdapter(MappingAdapter):
    def __init__(self, cfg):
        lin, full = cfg.linear_layer_indices, cfg.full_layer_indices
        pre = "model.layers.{i}"
        entries = [Entry("model.embed_tokens.weight", "embed"),
                   Entry("model.norm.weight", "final_norm")]
        if not cfg.tie_word_embeddings:
            entries.append(Entry("lm_head.weight", "lm_head", _t, _t))

        def stream(stack: str, idx) -> list[Entry]:
            out = [Entry(f"{pre}.input_layernorm.weight", f"{stack}.attn_norm",
                         layer_range=idx),
                   Entry(f"{pre}.post_attention_layernorm.weight", f"{stack}.mlp_norm",
                         layer_range=idx),
                   Entry(f"{pre}.mlp.gate.weight", f"{stack}.moe.gate.weight",
                         layer_range=idx),
                   *shared_expert_entries(pre, stack, idx)]
            return out + [dataclasses.replace(e, layer_range=idx)
                          for e in moe_expert_entries(f"{pre}.mlp", f"{stack}.moe")]

        if lin:
            hk = cfg.linear_num_key_heads
            entries += stream("linear_layers", lin) + [
                Entry(f"{pre}.linear_attn.in_proj_qkvz.weight", "linear_layers.wqkvz",
                      fused_in(hk), fused_out, layer_range=lin),
                Entry(f"{pre}.linear_attn.in_proj_ba.weight", "linear_layers.wba",
                      fused_in(hk), fused_out, layer_range=lin),
                *linear_tail_entries(cfg, pre, lin)]
        if full:
            entries += stream("full_layers", full) + full_attention_entries(cfg, pre, full)
        super().__init__(entries, cfg.num_hidden_layers, num_experts=cfg.moe.n_routed_experts)
