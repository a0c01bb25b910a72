"""HF checkpoint <-> the port's flat state dict (counterpart of
``automodel_tpu/models/common/state_dict.py``).

An adapter is a table of :class:`Entry`: an HF key template, the port's parameter
name (``embed``, ``layers.wq``, ``moe_layers.moe.experts.gate_up_proj``: the names
``models/llama/convert.py::params_from_jax`` uses) and a transform each way. The
transforms run on CPU tensors, one HF tensor (one layer, one expert) at a time;
layers, and experts under them, are stacked here into the (L, ...) / (L, E, ...)
layout the models take. Both packages read and write the same HF layout, which is
how weights cross between them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Mapping

import torch

__all__ = ["Entry", "FusedTensorMixin", "LazyHFTensor", "MappingAdapter"]

Transform = Callable[..., Any]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


@dataclasses.dataclass
class Entry:
    """One or more HF tensors -> one (possibly per-layer / per-expert) parameter.

    ``hf`` may be a tuple of key templates: the tensors are passed together to
    ``to_ours(*tensors)`` (HF gate_proj + up_proj merged into one gate_up tensor) and
    ``to_hf`` returns a matching tuple. ``{i}`` expands over layers (within
    ``layer_range`` when set), ``{e}`` over experts, which stack under the layer dim.
    """

    hf: str | tuple[str, ...]  # e.g. "model.layers.{i}.self_attn.q_proj.weight"
    ours: str  # e.g. "layers.wq"
    to_ours: Transform = _identity
    to_hf: Transform = _identity
    optional: bool = False
    layer_range: tuple[int, int] | None = None  # [start, stop) HF layer indices
    keep_dtype: bool = False  # exempt from the load-time cast (an f32 routing bias)

    @property
    def hf_keys(self) -> tuple[str, ...]:
        return (self.hf,) if isinstance(self.hf, str) else tuple(self.hf)

    @property
    def per_layer(self) -> bool:
        return "{i}" in self.hf_keys[0]

    @property
    def per_expert(self) -> bool:
        return "{e}" in self.hf_keys[0]


def _as_tuple(results) -> tuple:
    return (results,) if isinstance(results, torch.Tensor) else tuple(results)


class MappingAdapter:
    """Applies an Entry table in either direction, stacking and unstacking layers and
    experts."""

    def __init__(self, entries: Iterable[Entry], num_layers: int, num_experts: int = 0):
        self.entries = list(entries)
        self.num_layers = num_layers
        self.num_experts = num_experts

    def _layers(self, e: Entry) -> range:
        return range(*e.layer_range) if e.layer_range is not None else range(self.num_layers)

    def _load_one(self, entry: Entry, tensors: Mapping[str, torch.Tensor], **fmt):
        arrays = []
        for tmpl in entry.hf_keys:
            key = tmpl.format(**fmt)
            if key not in tensors:
                if entry.optional:
                    return None
                raise KeyError(f"missing tensor {key!r} in checkpoint")
            arrays.append(tensors[key])
        return entry.to_ours(*arrays)

    def from_hf(self, tensors: Mapping[str, torch.Tensor], dtype: torch.dtype | None = None,
                device: torch.device | str | None = None) -> dict[str, torch.Tensor]:
        """HF flat mapping -> the port's flat state dict. Each finished parameter is
        cast to ``dtype`` (unless its entry keeps its dtype) and moved to ``device``
        before the next is read, so the host holds one parameter at a time."""
        params: dict[str, torch.Tensor] = {}
        for e in self.entries:
            if e.per_layer:
                per = []
                for i in self._layers(e):
                    if e.per_expert:
                        experts = [self._load_one(e, tensors, i=i, e=x)
                                   for x in range(self.num_experts)]
                        layer = (None if any(a is None for a in experts)
                                 else torch.stack(experts))
                    else:
                        layer = self._load_one(e, tensors, i=i)
                    if layer is None:
                        break
                    per.append(layer)
                else:
                    value = torch.stack(per)
                    del per
                    params[e.ours] = self._place(value, e, dtype, device)
            else:
                t = self._load_one(e, tensors)
                if t is not None:
                    params[e.ours] = self._place(t, e, dtype, device)
        return params

    @staticmethod
    def _place(t: torch.Tensor, e: Entry, dtype, device) -> torch.Tensor:
        cast = None if e.keep_dtype else dtype
        return t.to(device=device, dtype=cast).contiguous()

    def _store_one(self, entry: Entry, value: torch.Tensor, out: dict, dtype, **fmt) -> None:
        cast = None if entry.keep_dtype else dtype
        for tmpl, t in zip(entry.hf_keys, _as_tuple(entry.to_hf(value)), strict=True):
            out[tmpl.format(**fmt)] = t if cast is None else t.to(cast)

    def _values(self, params: Mapping[str, torch.Tensor]):
        for e in self.entries:
            if e.ours not in params:
                if e.optional:
                    continue
                raise KeyError(f"parameter {e.ours!r} is missing")
            yield e, params[e.ours]

    def to_hf(self, params: Mapping[str, torch.Tensor],
              dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
        """The port's flat state dict -> HF flat dict of CPU tensors."""
        out: dict[str, torch.Tensor] = {}
        for e, value in self._values(params):
            value = value.detach().to("cpu")
            if e.per_layer:
                for li, i in enumerate(self._layers(e)):
                    if e.per_expert:
                        for x in range(self.num_experts):
                            self._store_one(e, value[li, x], out, dtype, i=i, e=x)
                    else:
                        self._store_one(e, value[li], out, dtype, i=i)
            else:
                self._store_one(e, value, out, dtype)
        return out

    def to_hf_lazy(self, params: Mapping[str, torch.Tensor],
                   dtype: torch.dtype | None = None) -> dict[str, "LazyHFTensor"]:
        """The port's flat state dict -> flat dict of deferred HF tensors.

        Nothing is copied here: each value is a :class:`LazyHFTensor` that copies one
        layer / expert slice to the host and applies the entry's transform when it is
        materialized, so a writer that consumes them in order holds one tensor at a
        time. ``params`` may live on the card."""
        # one-slot memo: an entry with several HF keys (gate + up) transforms once
        memo: dict = {"tag": None, "results": None}

        def make(e: Entry, slicer, cast, key_idx, tag):
            def thunk():
                if memo["tag"] != tag:
                    memo["results"] = _as_tuple(e.to_hf(slicer().detach().to("cpu")))
                    memo["tag"] = tag
                t = memo["results"][key_idx]
                return t if cast is None else t.to(cast)

            return thunk

        out: dict[str, LazyHFTensor] = {}
        for e, value in self._values(params):
            cast = None if e.keep_dtype else dtype
            n_keys = len(e.hf_keys)
            itemsize = (cast or value.dtype).itemsize

            def add(slicer, numel, tag, **fmt):
                nbytes = numel * itemsize // n_keys  # shard-planning estimate
                for key_idx, tmpl in enumerate(e.hf_keys):
                    out[tmpl.format(**fmt)] = LazyHFTensor(
                        make(e, slicer, cast, key_idx, tag), nbytes)

            if e.per_layer:
                per_layer = value[0].numel() if value.shape[0] else 0
                for li, i in enumerate(self._layers(e)):
                    if e.per_expert:
                        for x in range(self.num_experts):
                            add(lambda v=value, a=li, b=x: v[a, b], per_layer // self.num_experts,
                                (id(e), li, x), i=i, e=x)
                    else:
                        add(lambda v=value, a=li: v[a], per_layer, (id(e), li), i=i)
            else:
                add(lambda v=value: v, value.numel(), (id(e),))
        return out


class LazyHFTensor:
    """A deferred HF-layout tensor: ``nbytes`` is known up front (shard planning), the
    data exists only while it is consumed (``materialize()``, a CPU tensor)."""

    def __init__(self, thunk: Callable[[], torch.Tensor], nbytes: int):
        self._thunk = thunk
        self.nbytes = int(nbytes)

    def materialize(self) -> torch.Tensor:
        return self._thunk()


class FusedTensorMixin:
    """Split fused HF tensors into the table's part keys on the way in and fuse them
    again on export (Phi-3 packs q|k|v and gate|up). Mix in before the adapter and set
    ``_fused`` (``[(fused HF suffix, [part suffixes])]``) and ``_fused_splits``
    (``{fused suffix: [part sizes along HF dim 0]}``)."""

    _fused: "list[tuple[str, list[str]]]" = []
    _fused_splits: "dict[str, list[int]]" = {}

    def _fused_keys(self, i: int, fused: str, parts: "list[str]"):
        pre = f"model.layers.{i}."
        return pre + fused, [pre + p for p in parts]

    def from_hf(self, tensors, dtype=None, device=None) -> dict:
        t = dict(tensors)
        for i in range(self.num_layers):
            for fused, parts in self._fused:
                fk, pks = self._fused_keys(i, fused, parts)
                if fk not in t:
                    continue
                for pk, part in zip(pks, torch.split(t.pop(fk), self._fused_splits[fused])):
                    t[pk] = part
        return super().from_hf(t, dtype, device)

    def to_hf(self, params, dtype=None) -> dict:
        out = super().to_hf(params, dtype)
        for i in range(self.num_layers):
            for fused, parts in self._fused:
                fk, pks = self._fused_keys(i, fused, parts)
                out[fk] = torch.cat([out.pop(pk) for pk in pks])
        return out

    def to_hf_lazy(self, params, dtype=None) -> dict:
        out = super().to_hf_lazy(params, dtype)
        for i in range(self.num_layers):
            for fused, parts in self._fused:
                fk, pks = self._fused_keys(i, fused, parts)
                lazies = [out.pop(pk) for pk in pks]
                out[fk] = LazyHFTensor(
                    lambda ls=lazies: torch.cat([x.materialize() for x in ls]),
                    sum(x.nbytes for x in lazies))
        return out
