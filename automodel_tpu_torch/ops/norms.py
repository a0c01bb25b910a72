"""Normalization ops (counterpart of ``automodel_tpu/ops/norms.py``): f32 accumulation
whatever the activation dtype, output in the input's dtype."""

from __future__ import annotations

import torch

__all__ = ["layer_norm", "rms_norm"]


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 accumulation."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm with f32 accumulation; ``offset=1.0`` gives the (1+scale) Gemma variant."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (offset + scale.float())).to(x.dtype)
