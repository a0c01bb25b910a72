"""Qwen3-MoE HF key and layout mapping (counterpart of
``automodel_tpu/models/qwen3_moe/state_dict_adapter.py``).

HF stores one tensor per expert (``mlp.experts.{e}.gate_proj.weight`` ...); the port's
are expert-stacked with gate|up merged: gate_up_proj (L, E, D, 2I), down_proj
(L, E, I, D).
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.models.common.moe_transformer import MoEDecoderConfig
from automodel_tpu_torch.models.common.state_dict import Entry, MappingAdapter
from automodel_tpu_torch.models.llama.state_dict_adapter import (_t, attention_entries,
                                                                 dense_mlp_entries)

__all__ = ["Qwen3MoeStateDictAdapter", "attention_entries", "moe_expert_entries"]


def _gate_up_in(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """HF gate (I, D) + up (I, D) -> ours (D, 2I), [gate | up]."""
    return torch.cat([gate.T, up.T], dim=-1)


def _gate_up_out(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    inter = w.shape[1] // 2
    return w[:, :inter].T.contiguous(), w[:, inter:].T.contiguous()


def moe_expert_entries(prefix: str, ours_prefix: str, layer_range=None) -> list[Entry]:
    """Per-expert gate / up / down HF tensors -> stacked gate_up / down."""
    return [
        Entry((f"{prefix}.experts.{{e}}.gate_proj.weight", f"{prefix}.experts.{{e}}.up_proj.weight"),
              f"{ours_prefix}.experts.gate_up_proj", _gate_up_in, _gate_up_out,
              layer_range=layer_range),
        Entry(f"{prefix}.experts.{{e}}.down_proj.weight", f"{ours_prefix}.experts.down_proj",
              _t, _t, layer_range=layer_range),
    ]


class Qwen3MoeStateDictAdapter(MappingAdapter):
    def __init__(self, cfg: MoEDecoderConfig):
        k, n_layers = cfg.first_k_dense_replace, cfg.num_hidden_layers
        moe_range = (k, n_layers)
        entries = [
            Entry("model.embed_tokens.weight", "embed"),
            Entry("model.norm.weight", "final_norm"),
            *attention_entries(cfg, "moe_layers", layer_range=moe_range),
            Entry("model.layers.{i}.mlp.gate.weight", "moe_layers.moe.gate.weight",
                  layer_range=moe_range),
            *moe_expert_entries("model.layers.{i}.mlp", "moe_layers.moe", layer_range=moe_range),
        ]
        if k > 0:
            entries += [*attention_entries(cfg, "dense_layers", layer_range=(0, k)),
                        *dense_mlp_entries(cfg, "dense_layers", layer_range=(0, k))]
        if not cfg.tie_word_embeddings:
            entries.append(Entry("lm_head.weight", "lm_head", _t, _t))
        super().__init__(entries, n_layers, num_experts=cfg.moe.n_routed_experts)
