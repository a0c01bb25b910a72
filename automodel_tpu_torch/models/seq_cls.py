"""Sequence classification on a ported decoder (counterpart of
``automodel_tpu/models/seq_cls.py``).

The decoder's LM head is dropped and a ``score`` projection (hidden -> num_labels) is
added; each row is pooled at its last real token (HF ``LlamaForSequenceClassification``'s
convention), found from the segment ids. The classifier holds every parameter; the
decoder it wraps holds none and runs as a function of them.

An MoE decoder raises NotImplementedError: its forward returns ``(hidden, stats)``, and
the JAX package's ``SequenceClassifier`` gathers from that tuple and fails with a
TypeError, so there is no reference to hold the port against.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from automodel_tpu_torch.checkpoint.safetensors_io import load_safetensors
from automodel_tpu_torch.models.auto import AutoModelForCausalLM, load_hf_config
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.common.param_module import ParamModule
from automodel_tpu_torch.models.common.state_dict import LazyHFTensor
from automodel_tpu_torch.models.hub import resolve_pretrained_path
from automodel_tpu_torch.models.llama_bidirectional.model import pool_hidden
from automodel_tpu_torch.models.llama.convert import check_params

__all__ = ["AutoModelForSequenceClassification", "SequenceClassifier"]


def _trunk(config: dict, backend: BackendConfig | None, device):
    """The decoder of an HF config dict, holding no parameters; MoE refused."""
    model_cls = AutoModelForCausalLM.model_class(config)
    base = model_cls(model_cls.config_class.from_hf(config), backend, device=device, params={})
    if getattr(base.config, "moe", None) is not None:
        raise NotImplementedError(
            f"sequence classification on an MoE decoder ({model_cls.__name__}) is not ported: "
            "the JAX package's SequenceClassifier gathers from the (hidden, stats) tuple an "
            "MoE decoder returns and fails with a TypeError, so it has no reference")
    return base


class _Shapes:
    """The classifier's parameter shapes: the decoder's without lm_head, and score."""

    def __init__(self, base, num_labels: int):
        shapes = base.config.param_shapes()
        shapes.pop("lm_head", None)
        self.shapes = dict(shapes, score=(base.config.hidden_size, num_labels))

    def param_shapes(self):
        return self.shapes


class SequenceClassifier(ParamModule):
    def __init__(self, base: nn.Module, num_labels: int, params: dict[str, torch.Tensor]):
        """``base``: the decoder, holding no parameters; ``params``: its parameters
        without lm_head, and ``score`` (hidden, num_labels)."""
        super().__init__(check_params(params, _Shapes(base, num_labels), "classifier"))
        self.base = base
        self.config = base.config
        self.num_labels = num_labels

    def logical_axes(self) -> dict[str, tuple]:
        axes = self.base.logical_axes()
        axes.pop("lm_head", None)
        axes["score"] = ("embed", None)
        return axes

    def forward(self, input_ids, positions=None, segment_ids=None, mesh=None, params=None):
        """(B, num_labels) logits in the compute dtype; ``params``: run on these tensors
        instead of the module's (a LoRA merge)."""
        params = self.param_dict() if params is None else params
        base_params = {k: v for k, v in params.items() if k != "score"}
        hidden = self.base(input_ids, positions=positions, segment_ids=segment_ids,
                           return_hidden=True, mesh=mesh, params=base_params)
        real = (segment_ids != 0 if segment_ids is not None
                else torch.ones(input_ids.shape, dtype=torch.bool, device=input_ids.device))
        pooled = pool_hidden(hidden, real, "last")
        return pooled @ params["score"].to(pooled.dtype)

    def state_dict_adapter(self):
        return _SeqClsAdapter(self.base.state_dict_adapter())


class _SeqClsAdapter:
    """The decoder's adapter without its lm_head entry, and the ``score.weight`` head
    (HF sequence-classification checkpoints: (num_labels, hidden)). A base checkpoint's
    ``lm_head.weight`` is read by no entry; a classifier's export writes none, so it
    reloads for an untied decoder too."""

    def __init__(self, base_adapter):
        self.base = base_adapter
        self.base.entries = [e for e in base_adapter.entries if e.ours != "lm_head"]

    @property
    def entries(self):
        return self.base.entries

    def from_hf(self, tensors, dtype=None, device=None) -> dict[str, torch.Tensor]:
        params = self.base.from_hf(tensors, dtype=dtype, device=device)
        if "score.weight" in tensors:
            params["score"] = tensors["score.weight"].T.to(device=device, dtype=dtype).contiguous()
        return params

    def to_hf(self, params, dtype=None) -> dict[str, torch.Tensor]:
        out = self.base.to_hf({k: v for k, v in params.items() if k != "score"}, dtype)
        score = params["score"].detach().to("cpu").T.contiguous()
        out["score.weight"] = score if dtype is None else score.to(dtype)
        return out

    def to_hf_lazy(self, params, dtype=None) -> dict[str, LazyHFTensor]:
        out = self.base.to_hf_lazy({k: v for k, v in params.items() if k != "score"}, dtype)
        score = params["score"]

        def thunk():
            t = score.detach().to("cpu").T.contiguous()
            return t if dtype is None else t.to(dtype)

        out["score.weight"] = LazyHFTensor(thunk, score.numel() * (dtype or score.dtype).itemsize)
        return out


class AutoModelForSequenceClassification:
    @classmethod
    def from_config(cls, config: dict, num_labels: int | None = None,
                    backend: BackendConfig | None = None, *, device="cuda",
                    dtype=torch.float32, generator: torch.Generator | None = None
                    ) -> SequenceClassifier:
        """Random weights from ``generator`` (seed 0 by default): the decoder's init, then
        ``score`` at std ``initializer_range``."""
        device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        base = _trunk(config, backend, device)
        n = num_labels or int(config.get("num_labels", 2))
        params = type(base)(base.config, backend, device=device, dtype=dtype,
                            generator=generator).param_dict()
        params = {k: v.detach() for k, v in params.items() if k != "lm_head"}
        score = torch.empty((base.config.hidden_size, n), device=generator.device)
        score.normal_(0.0, base.config.initializer_range, generator=generator)
        params["score"] = score.to(device=device, dtype=dtype)
        return SequenceClassifier(base, n, params)

    @classmethod
    def from_pretrained(cls, path: str, num_labels: int | None = None,
                        backend: BackendConfig | None = None, dtype=torch.float32,
                        device="cuda") -> SequenceClassifier:
        """The classifier with the weights of the local HF directory ``path``, in
        ``dtype`` on ``device``. A checkpoint without ``score.weight`` (a base model)
        gets a fresh head as JAX's: ``np.random.default_rng(0)`` normal at std
        ``initializer_range``. A hub repo id raises NotImplementedError."""
        path = resolve_pretrained_path(path)
        config = load_hf_config(path)
        base = _trunk(config, backend, device)
        n = num_labels or int(config.get("num_labels", 2))
        adapter = _SeqClsAdapter(base.state_dict_adapter())
        params = adapter.from_hf(load_safetensors(path), dtype=dtype, device=device)
        if "score" not in params:
            fresh = np.random.default_rng(0).normal(
                0, base.config.initializer_range, (base.config.hidden_size, n))
            params["score"] = torch.from_numpy(fresh.astype(np.float32)).to(device=device,
                                                                            dtype=dtype)
        return SequenceClassifier(base, n, params)
