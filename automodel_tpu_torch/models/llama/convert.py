"""Carry a JAX model's parameter tree across to the PyTorch model (Llama and the MoE
decoders).

The tree is the JAX package's nested dict (stacked ``(L, ...)`` layer leaves) with
numpy leaves, as ``jax.device_get`` returns it; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from automodel_tpu_torch.models.common.moe_transformer import (MoEDecoderConfig,
                                                               moe_decoder_param_shapes)
from automodel_tpu_torch.models.common.transformer import DenseDecoderConfig, param_shapes

__all__ = ["check_params", "flatten", "params_from_jax", "to_torch"]


def to_torch(a: Any) -> torch.Tensor:
    """numpy array (bfloat16 from ml_dtypes included) -> CPU tensor, copied."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """Nested dict -> flat dict with dotted names (``moe_layers.moe.gate.weight``)."""
    flat: dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            flat |= flatten(value, f"{prefix}{key}.")
        else:
            flat[f"{prefix}{key}"] = value
    return flat


def params_from_jax(tree: Mapping[str, Any], cfg: DenseDecoderConfig) -> dict[str, torch.Tensor]:
    """Flat state dict (``embed``, ``layers.wq``, ``moe_layers.moe.experts.down_proj``, ...)
    of the port's model, checked name by name and shape by shape against ``cfg``."""
    return check_params({name: to_torch(leaf) for name, leaf in flatten(tree).items()}, cfg,
                        "JAX tree")


def check_params(flat: dict[str, torch.Tensor], cfg: DenseDecoderConfig,
                 what: str = "state dict") -> dict[str, torch.Tensor]:
    """``flat``, after checking its names and shapes against the model of ``cfg``."""
    want = (moe_decoder_param_shapes(cfg) if isinstance(cfg, MoEDecoderConfig)
            else param_shapes(cfg))
    if set(flat) != set(want):
        raise KeyError(f"{what} does not match the config: missing "
                       f"{sorted(set(want) - set(flat))}, unexpected {sorted(set(flat) - set(want))}")
    for name, shape in want.items():
        if tuple(flat[name].shape) != shape:
            raise ValueError(f"{name}: {what} shape {tuple(flat[name].shape)} != {shape}")
    return flat
