"""Build a model from an HF model directory (counterpart of
``automodel_tpu/models/auto.py``, causal LMs).

``from_pretrained(path)`` reads ``config.json``, resolves the family through
``models/registry.py`` (an unregistered ``*ForCausalLM`` through the structural alias of
``models/structural.py``, as JAX's ``from_config`` falls back to it) and loads the
safetensors through the family's state-dict adapter: each parameter is cast to the
requested dtype and moved to the device before the next is read, so the host holds one
parameter at a time.
"""

from __future__ import annotations

import json
import os

import torch

from automodel_tpu_torch.checkpoint.safetensors_io import load_safetensors
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.hub import resolve_pretrained_path
from automodel_tpu_torch.models.llama.convert import check_params
from automodel_tpu_torch.models.registry import resolve_model_class
from automodel_tpu_torch.models.structural import (AliasedLlamaForCausalLM,
                                                   StructuralDivergence, alias_overrides)

__all__ = ["AutoModelForCausalLM", "load_hf_config"]


def load_hf_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


class AutoModelForCausalLM:
    """Build a model from an HF config dict or a local HF model directory."""

    _default_architecture = "LlamaForCausalLM"

    @classmethod
    def model_class(cls, config: dict):
        """The registered class of the config's architecture, or, for an unregistered
        Llama delta, :class:`AliasedLlamaForCausalLM`; NotImplementedError naming both the
        registry miss and the divergent field otherwise."""
        arch = (config.get("architectures") or [cls._default_architecture])[0]
        try:
            return resolve_model_class(arch)
        except NotImplementedError as missing:
            try:
                alias_overrides(arch, config)
            except StructuralDivergence as diverged:
                raise NotImplementedError(f"{missing} Auto-alias also failed: "
                                          f"{diverged}") from diverged
            return AliasedLlamaForCausalLM

    @classmethod
    def from_config(cls, config: dict, backend: BackendConfig | None = None, **kw):
        """Random weights (``device``, ``dtype``, ``generator`` as the model classes take)."""
        return cls.model_class(config).from_config(config, backend, **kw)

    @classmethod
    def from_pretrained(cls, path: str, backend: BackendConfig | None = None,
                        dtype: torch.dtype = torch.float32,
                        device: torch.device | str = "cuda"):
        """The model with the weights of the local HF directory ``path``, in ``dtype`` on
        ``device``. A hub repo id raises NotImplementedError."""
        path = resolve_pretrained_path(path)
        hf_config = load_hf_config(path)
        model_cls = cls.model_class(hf_config)
        config = model_cls.config_class.from_hf(hf_config)
        # a model without parameters is enough to hold the adapter, which needs the config
        adapter = model_cls(config, backend, device=device, params={}).state_dict_adapter()
        params = adapter.from_hf(load_safetensors(path), dtype=dtype, device=device)
        return model_cls(config, backend, device=device, dtype=dtype,
                         params=check_params(params, config, f"checkpoint {path!r}"))
