"""Step-3.5 HF key mapping (counterpart of
``automodel_tpu/models/step3p5/state_dict_adapter.py``).

HF ships the experts already grouped: ``moe.gate_proj`` / ``moe.up_proj`` (E, I, D) and
``moe.down_proj`` (E, D, I); the router ``moe.gate.weight`` (E, D) with the optional
``moe.router_bias``; the shared expert under ``share_expert.*``. Each of the four streams
pins its HF layers with ``layer_range``.
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.models.common.state_dict import Entry, MappingAdapter
from automodel_tpu_torch.models.llama.state_dict_adapter import (_o_in, _o_out, _proj_in,
                                                                 _proj_out, _t)

__all__ = ["Step3p5StateDictAdapter"]


def _grouped_gate_up_in(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """HF (E, I, D) gate and up -> ours (E, D, 2I), [gate | up]."""
    return torch.cat([gate.transpose(1, 2), up.transpose(1, 2)], dim=-1)


def _grouped_gate_up_out(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    inter = w.shape[-1] // 2
    return (w[..., :inter].transpose(1, 2).contiguous(),
            w[..., inter:].transpose(1, 2).contiguous())


def _grouped_t(w: torch.Tensor) -> torch.Tensor:
    return w.transpose(1, 2).contiguous()


class Step3p5StateDictAdapter(MappingAdapter):
    def __init__(self, cfg):
        pre, dh = "model.layers.{i}", cfg.head_dim
        entries = [Entry("model.embed_tokens.weight", "embed"),
                   Entry("model.norm.weight", "final_norm")]
        if not cfg.tie_word_embeddings:
            entries.append(Entry("lm_head.weight", "lm_head", _t, _t))
        for key, idx in cfg.stream_indices().items():
            n, kv = cfg.heads(idx[0])

            def entry(hf, ours, *transforms):
                return Entry(f"{pre}.{hf}", f"{key}.{ours}", *transforms, layer_range=idx)

            entries += [
                entry("input_layernorm.weight", "attn_norm"),
                entry("post_attention_layernorm.weight", "mlp_norm"),
                entry("self_attn.q_proj.weight", "wq", _proj_in(n, dh), _proj_out(n, dh)),
                entry("self_attn.k_proj.weight", "wk", _proj_in(kv, dh), _proj_out(kv, dh)),
                entry("self_attn.v_proj.weight", "wv", _proj_in(kv, dh), _proj_out(kv, dh)),
                entry("self_attn.o_proj.weight", "wo", _o_in(n, dh), _o_out(n, dh)),
                entry("self_attn.q_norm.weight", "q_norm"),
                entry("self_attn.k_norm.weight", "k_norm"),
            ]
            if cfg.use_head_wise_attn_gate:
                entries.append(entry("self_attn.g_proj.weight", "wg", _t, _t))
            if key.endswith("_mlp"):
                entries += [entry(f"mlp.{w}_proj.weight", f"w_{w}", _t, _t)
                            for w in ("gate", "up", "down")]
                continue
            entries += [entry(f"share_expert.{w}_proj.weight", f"sh_{w}", _t, _t)
                        for w in ("gate", "up", "down")]
            entries += [
                entry("moe.gate.weight", "moe.gate.weight"),
                Entry((f"{pre}.moe.gate_proj.weight", f"{pre}.moe.up_proj.weight"),
                      f"{key}.moe.experts.gate_up_proj", _grouped_gate_up_in,
                      _grouped_gate_up_out, layer_range=idx),
                entry("moe.down_proj.weight", "moe.experts.down_proj", _grouped_t, _grouped_t),
            ]
            if cfg.moe.router_bias:
                entries.append(entry("moe.router_bias", "moe.gate.bias"))
        super().__init__(entries, cfg.num_hidden_layers)
