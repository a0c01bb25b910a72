"""The parameter holder shared by the port's model classes: flat tensors named as the
JAX tree flattens them (``layers.wq``, ``moe_layers.moe.experts.gate_up_proj``)."""

from __future__ import annotations

import torch
from torch import nn

from automodel_tpu_torch.models.common.logical_axes import DENSE_LAYER_AXES, logical_axes

__all__ = ["ParamModule"]


class ParamModule(nn.Module):
    """An ``nn.Module`` whose parameters are one flat dict with JAX-tree names."""

    layer_axes = DENSE_LAYER_AXES  # the family's per-layer logical-axes table

    def __init__(self, init: dict[str, torch.Tensor]):
        super().__init__()
        # ParameterDict keys cannot hold dots: "layers.wq" is stored as "layers__wq"
        self.params = nn.ParameterDict({k.replace(".", "__"): nn.Parameter(v)
                                        for k, v in init.items()})

    def param_dict(self) -> dict[str, torch.Tensor]:
        """name -> parameter, with the JAX tree's names (``layers.wq``)."""
        return {k.replace("__", "."): v for k, v in self.params.items()}

    def logical_axes(self) -> dict[str, tuple]:
        """name -> logical axes of every parameter, as the JAX model's ``logical_axes()``
        gives them (flattened to the same names)."""
        return logical_axes(self.config.param_shapes(), self.layer_axes)

    def load_params(self, tensors: dict[str, torch.Tensor]) -> None:
        """Copy ``tensors`` (flat JAX names, e.g. from ``params_from_jax``) in place."""
        own = self.param_dict()
        if set(tensors) != set(own):
            raise KeyError(f"parameter names differ: missing {sorted(set(own) - set(tensors))}, "
                           f"unexpected {sorted(set(tensors) - set(own))}")
        with torch.no_grad():
            for name, t in tensors.items():
                if tuple(t.shape) != tuple(own[name].shape):
                    raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(own[name].shape)}")
                own[name].copy_(t)
