"""Normalization ops (counterpart of ``automodel_tpu/ops/norms.py``): f32 accumulation
whatever the activation dtype, output in the input's dtype."""

from __future__ import annotations

import torch

__all__ = ["layer_norm", "rms_norm"]


def layer_norm(x: torch.Tensor, scale: torch.Tensor | None = None,
               bias: torch.Tensor | None = None, eps: float = 1e-5) -> torch.Tensor:
    """Mean-centred LayerNorm over the last dim with f32 accumulation. ``scale`` None is
    the non-parametric form (OLMo v1), ``bias`` None the bias-free one (Cohere); the
    affine part stays in f32 before the cast, as the JAX package's ``layer_norm`` and the
    dense decoder's ``_centered_norm``. Per-head weights (Cohere+'s (n, h) q/k norms)
    broadcast over the leading dims."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm with f32 accumulation; ``offset=1.0`` gives the (1+scale) Gemma variant."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (offset + scale.float())).to(x.dtype)
