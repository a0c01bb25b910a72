"""Qwen3.5-MoE HF key mapping (counterpart of
``automodel_tpu/models/qwen3_5_moe/state_dict_adapter.py``).

The text keys sit under ``model.language_model.*``. The DeltaNet projections come apart
(``in_proj_qkv``: flat head-major [q | k | v] rows, ``in_proj_z``, ``in_proj_b``,
``in_proj_a``) and are re-interleaved into Qwen3-Next's fused per-key-head [q | k | v r |
z r] and [b | a] layouts; the experts come packed, ``gate_up_proj (E, 2I, D)`` and
``down_proj (E, D, I)``, and only transpose.
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.models.common.state_dict import Entry, MappingAdapter
from automodel_tpu_torch.models.llama.state_dict_adapter import _t
from automodel_tpu_torch.models.qwen3_next.state_dict_adapter import (
    full_attention_entries, linear_tail_entries, shared_expert_entries)

__all__ = ["Qwen3_5MoeStateDictAdapter"]


def _qkvz_in(cfg):
    hk, dk = cfg.linear_num_key_heads, cfg.linear_key_head_dim
    rdv = cfg.linear_num_value_heads // hk * cfg.linear_value_head_dim

    def f(qkv: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        d = qkv.shape[1]
        q, k, v = qkv.split([hk * dk, hk * dk, hk * rdv])
        out = torch.cat([q.reshape(hk, dk, d), k.reshape(hk, dk, d), v.reshape(hk, rdv, d),
                         z.reshape(hk, rdv, d)], dim=1)  # (Hk, M, D)
        return out.permute(2, 0, 1).contiguous()

    return f


def _qkvz_out(cfg):
    dk = cfg.linear_key_head_dim
    rdv = cfg.linear_num_value_heads // cfg.linear_num_key_heads * cfg.linear_value_head_dim

    def f(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        d = w.shape[0]
        q, k, v, z = w.permute(1, 2, 0).split([dk, dk, rdv, rdv], dim=1)
        qkv = torch.cat([q.reshape(-1, d), k.reshape(-1, d), v.reshape(-1, d)])
        return qkv.contiguous(), z.reshape(-1, d).contiguous()

    return f


def _ba_in(cfg):
    hk = cfg.linear_num_key_heads
    r = cfg.linear_num_value_heads // hk

    def f(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        d = b.shape[1]
        return torch.cat([b.reshape(hk, r, d), a.reshape(hk, r, d)], dim=1).permute(
            2, 0, 1).contiguous()

    return f


def _ba_out(cfg):
    r = cfg.linear_num_value_heads // cfg.linear_num_key_heads

    def f(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        d = w.shape[0]
        b, a = w.permute(1, 2, 0).split([r, r], dim=1)
        return b.reshape(-1, d).contiguous(), a.reshape(-1, d).contiguous()

    return f


def _packed_t(w: torch.Tensor) -> torch.Tensor:
    return w.transpose(1, 2).contiguous()


class Qwen3_5MoeStateDictAdapter(MappingAdapter):
    def __init__(self, cfg):
        lin, full = cfg.linear_layer_indices, cfg.full_layer_indices
        pre = "model.language_model.layers.{i}"
        entries = [Entry("model.language_model.embed_tokens.weight", "embed"),
                   Entry("model.language_model.norm.weight", "final_norm")]
        if not cfg.tie_word_embeddings:
            entries.append(Entry("lm_head.weight", "lm_head", _t, _t))

        def stream(stack: str, idx) -> list[Entry]:
            ours = f"{stack}.moe"
            return [
                Entry(f"{pre}.input_layernorm.weight", f"{stack}.attn_norm", layer_range=idx),
                Entry(f"{pre}.post_attention_layernorm.weight", f"{stack}.mlp_norm",
                      layer_range=idx),
                Entry(f"{pre}.mlp.gate.weight", f"{ours}.gate.weight", layer_range=idx),
                Entry(f"{pre}.mlp.experts.gate_up_proj", f"{ours}.experts.gate_up_proj",
                      _packed_t, _packed_t, layer_range=idx),
                Entry(f"{pre}.mlp.experts.down_proj", f"{ours}.experts.down_proj", _packed_t,
                      _packed_t, layer_range=idx),
                *shared_expert_entries(pre, stack, idx, optional=True),
            ]

        if lin:
            entries += stream("linear_layers", lin) + [
                Entry((f"{pre}.linear_attn.in_proj_qkv.weight",
                       f"{pre}.linear_attn.in_proj_z.weight"), "linear_layers.wqkvz",
                      _qkvz_in(cfg), _qkvz_out(cfg), layer_range=lin),
                Entry((f"{pre}.linear_attn.in_proj_b.weight",
                       f"{pre}.linear_attn.in_proj_a.weight"), "linear_layers.wba",
                      _ba_in(cfg), _ba_out(cfg), layer_range=lin),
                *linear_tail_entries(cfg, pre, lin)]
        if full:
            entries += stream("full_layers", full) + full_attention_entries(cfg, pre, full)
        super().__init__(entries, cfg.num_hidden_layers, num_experts=cfg.moe.n_routed_experts)
