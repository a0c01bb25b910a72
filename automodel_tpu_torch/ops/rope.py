"""Rotary position embeddings, rotate-half convention (counterpart of
``automodel_tpu/ops/rope.py``): default, linear and llama3 frequency scaling.
Other scaling types raise until a slice needs them."""

from __future__ import annotations

import math
from typing import Any

import torch

__all__ = ["apply_rope", "rope_attention_scaling", "rope_frequencies"]


def rope_frequencies(
    head_dim: int,
    theta: float = 10000.0,
    rope_scaling: dict[str, Any] | None = None,
    partial_rotary_factor: float = 1.0,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Inverse frequencies ``(rotary_dim // 2,)`` in f32, with optional HF scaling."""
    rotary_dim = int(head_dim * partial_rotary_factor)
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=device) / rotary_dim
    inv_freq = 1.0 / (theta ** exponent)
    if not rope_scaling:
        return inv_freq
    rope_type = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
    if rope_type in ("default", None):
        return inv_freq
    if rope_type == "linear":
        return inv_freq / float(rope_scaling["factor"])
    if rope_type == "llama3":
        # transformers modeling_rope_utils._compute_llama3_parameters
        factor = float(rope_scaling["factor"])
        low_factor = float(rope_scaling.get("low_freq_factor", 1.0))
        high_factor = float(rope_scaling.get("high_freq_factor", 4.0))
        old_len = float(rope_scaling.get("original_max_position_embeddings", 8192))
        wavelen = 2 * math.pi / inv_freq
        low_wl = old_len / low_factor
        high_wl = old_len / high_factor
        smooth = (old_len / wavelen - low_factor) / (high_factor - low_factor)
        mid = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        return torch.where(wavelen > low_wl, inv_freq / factor,
                           torch.where(wavelen < high_wl, inv_freq, mid))
    raise NotImplementedError(f"rope scaling type {rope_type!r} is not ported yet")


def rope_attention_scaling(rope_scaling: dict[str, Any] | None) -> float:
    """cos/sin scale of the scaling type: 1.0 for default, linear and llama3."""
    if not rope_scaling:
        return 1.0
    rope_type = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
    if rope_type in ("default", None, "linear", "llama3"):
        return 1.0
    raise NotImplementedError(f"rope scaling type {rope_type!r} is not ported yet")


def apply_rope(
    x: torch.Tensor,  # (batch, seq, heads, head_dim)
    positions: torch.Tensor,  # (batch, seq)
    inv_freq: torch.Tensor,
    attention_scaling: float = 1.0,
) -> torch.Tensor:
    """out = x*cos + [-x2, x1]*sin with the half split at rotary_dim // 2, in f32."""
    angles = positions[..., None].float() * inv_freq  # (b, s, rot/2)
    cos = torch.cos(angles) * attention_scaling
    sin = torch.sin(angles) * attention_scaling
    cos = torch.cat([cos, cos], dim=-1)[:, :, None, :]
    sin = torch.cat([sin, sin], dim=-1)[:, :, None, :]
    rot = cos.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    out = x_rot.float() * cos + torch.cat([-x2, x1], dim=-1) * sin
    if x_pass.shape[-1]:
        return torch.cat([out.to(x.dtype), x_pass], dim=-1)
    return out.to(x.dtype)
