"""Gemma 2 / 3 HF key and layout mapping (counterpart of
``automodel_tpu/models/gemma/state_dict_adapter.py``): Llama's projections and the
sandwich norms; :meth:`GemmaStateDictAdapter.from_hf` also reads a multimodal
Gemma3ForConditionalGeneration checkpoint's text backbone."""

from __future__ import annotations

from typing import Mapping

import torch

from automodel_tpu_torch.models.common.state_dict import Entry, MappingAdapter
from automodel_tpu_torch.models.gemma.model import GemmaConfig
from automodel_tpu_torch.models.llama.state_dict_adapter import (_o_in, _o_out, _proj_in,
                                                                 _proj_out, _t)

__all__ = ["GemmaStateDictAdapter"]


class GemmaStateDictAdapter(MappingAdapter):
    """Maps bare text-model keys. :meth:`from_hf` strips the language-model prefix of a
    multimodal checkpoint (both the pre- and post-4.52 transformers layouts) and drops
    the vision tower and projector tensors: the text backbone loads, vision does not."""

    _MM_PREFIXES = ("language_model.model.", "model.language_model.")

    def __init__(self, cfg: GemmaConfig):
        n, k, h = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        pre = "model.layers.{i}"
        entries = [
            Entry("model.embed_tokens.weight", "embed"),
            Entry("model.norm.weight", "final_norm"),
            Entry(f"{pre}.input_layernorm.weight", "layers.attn_norm"),
            Entry(f"{pre}.post_attention_layernorm.weight", "layers.post_attn_norm"),
            Entry(f"{pre}.pre_feedforward_layernorm.weight", "layers.pre_ffn_norm"),
            Entry(f"{pre}.post_feedforward_layernorm.weight", "layers.post_ffn_norm"),
            Entry(f"{pre}.self_attn.q_proj.weight", "layers.wq", _proj_in(n, h), _proj_out(n, h)),
            Entry(f"{pre}.self_attn.k_proj.weight", "layers.wk", _proj_in(k, h), _proj_out(k, h)),
            Entry(f"{pre}.self_attn.v_proj.weight", "layers.wv", _proj_in(k, h), _proj_out(k, h)),
            Entry(f"{pre}.self_attn.o_proj.weight", "layers.wo", _o_in(n, h), _o_out(n, h)),
            Entry(f"{pre}.mlp.gate_proj.weight", "layers.w_gate", _t, _t),
            Entry(f"{pre}.mlp.up_proj.weight", "layers.w_up", _t, _t),
            Entry(f"{pre}.mlp.down_proj.weight", "layers.w_down", _t, _t),
        ]
        if cfg.qk_norm:
            entries += [Entry(f"{pre}.self_attn.q_norm.weight", "layers.q_norm"),
                        Entry(f"{pre}.self_attn.k_norm.weight", "layers.k_norm")]
        if not cfg.tie_word_embeddings:
            entries.append(Entry("lm_head.weight", "lm_head", _t, _t))
        super().__init__(entries, cfg.num_hidden_layers)

    def from_hf(self, tensors: Mapping[str, torch.Tensor], dtype: torch.dtype | None = None,
                device: torch.device | str | None = None) -> dict[str, torch.Tensor]:
        if "model.embed_tokens.weight" not in tensors and any(
                key.startswith(p) for key in tensors for p in self._MM_PREFIXES):
            names = {}  # text-model key -> the checkpoint's
            for key in tensors:
                for p in self._MM_PREFIXES:
                    if key.startswith(p):
                        names["model." + key[len(p):]] = key
                        break
                else:
                    if key in ("language_model.lm_head.weight", "lm_head.weight"):
                        names["lm_head.weight"] = key
                    # else: the vision tower or the multi-modal projector, dropped
            tensors = _Renamed(tensors, names)
        return super().from_hf(tensors, dtype=dtype, device=device)


class _Renamed(Mapping):
    """``tensors`` under other names, read as asked (a lazy checkpoint stays lazy)."""

    def __init__(self, tensors: Mapping[str, torch.Tensor], names: dict[str, str]):
        self._tensors, self._names = tensors, names

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._tensors[self._names[key]]

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)
