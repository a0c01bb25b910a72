"""Rotary position embeddings, rotate-half convention (counterpart of
``automodel_tpu/ops/rope.py``): default, linear, llama3, longrope (Phi-3) and YaRN
frequency scaling, and the cos/sin scale of YaRN and longrope. Other scaling types
raise. :func:`apply_rope_interleaved` is the complex-pair convention (DeepSeek's MLA, and
the dense decoder's ``rope_interleaved``)."""

from __future__ import annotations

import math
import warnings
from typing import Any

import torch

__all__ = ["apply_rope", "apply_rope_interleaved", "apply_rope_interleaved_tables",
           "apply_rope_tables", "rope_attention_scaling", "rope_frequencies", "rope_tables",
           "rope_tables_interleaved"]


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
    if rope_type == "longrope":
        # transformers _compute_longrope_parameters (Phi-3): per-frequency rescale factors,
        # the short ones inside the original window; the long ones only when asked for
        # (use_long_factor) and the window was extended, as the JAX package picks them
        orig = float(rope_scaling.get("original_max_position_embeddings", 4096))
        max_pos = float(rope_scaling.get("max_position_embeddings", orig))
        use_long = bool(rope_scaling.get("use_long_factor", False)) and max_pos > orig
        if not use_long and max_pos > orig:
            warnings.warn(
                "longrope: using short_factor frequencies; HF switches to long_factor for "
                f"sequences past original_max_position_embeddings ({orig:.0f}): set "
                "rope_scaling.use_long_factor: true for long-context runs so exported "
                "checkpoints match HF inference", stacklevel=2)
        ext = rope_scaling["long_factor"] if use_long else rope_scaling["short_factor"]
        return inv_freq / torch.tensor(ext, dtype=torch.float32, device=device)
    if rope_type == "yarn":
        # transformers _compute_yarn_parameters: interpolated below the ramp, extrapolated
        # above it; ``truncate`` (default true) rounds the ramp's ends outwards
        factor = float(rope_scaling["factor"])
        orig_len = float(rope_scaling.get("original_max_position_embeddings", 4096))
        beta_fast = float(rope_scaling.get("beta_fast", 32.0))
        beta_slow = float(rope_scaling.get("beta_slow", 1.0))

        def find_dim(num_rot: float) -> float:
            return (rotary_dim * math.log(orig_len / (num_rot * 2 * math.pi))) / (
                2 * math.log(theta))

        low, high = find_dim(beta_fast), find_dim(beta_slow)
        if rope_scaling.get("truncate", True):
            low, high = math.floor(low), math.ceil(high)
        low = max(low, 0)
        high = min(high, rotary_dim - 1)
        dims = torch.arange(rotary_dim // 2, dtype=torch.float32, device=device)
        ramp = ((dims - low) / max(high - low, 1e-3)).clamp(0, 1)
        mask = 1.0 - ramp
        return inv_freq / factor * (1 - mask) + inv_freq * mask
    raise NotImplementedError(f"rope scaling type {rope_type!r} is not ported yet")


def rope_attention_scaling(rope_scaling: dict[str, Any] | None) -> float:
    """cos/sin scale of the scaling type: 1.0 for default, linear and llama3; YaRN's
    mscale and longrope's sqrt(1 + ln(factor) / ln(original window)) (either one's
    ``attention_factor`` when given)."""
    if not rope_scaling:
        return 1.0
    rope_type = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
    if rope_type in ("default", None, "linear", "llama3"):
        return 1.0
    if rope_type == "yarn":
        factor = float(rope_scaling["factor"])
        attention_factor = rope_scaling.get("attention_factor")
        if attention_factor is not None:
            return float(attention_factor)

        def get_mscale(scale: float, mscale: float = 1.0) -> float:
            return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0

        # transformers reads mscale / mscale_all_dim by truthiness: 0 means the default
        mscale = rope_scaling.get("mscale")
        mscale_all_dim = rope_scaling.get("mscale_all_dim")
        if mscale and mscale_all_dim:
            return get_mscale(factor, float(mscale)) / get_mscale(factor, float(mscale_all_dim))
        return get_mscale(factor)
    if rope_type == "longrope":
        attention_factor = rope_scaling.get("attention_factor")
        if attention_factor is not None:
            return float(attention_factor)
        orig = float(rope_scaling.get("original_max_position_embeddings", 4096))
        factor = float(rope_scaling.get("max_position_embeddings", orig)) / orig
        # on the short factors too: transformers scales cos/sin by it either way
        return math.sqrt(1 + math.log(factor) / math.log(orig)) if factor > 1 else 1.0
    raise NotImplementedError(f"rope scaling type {rope_type!r} is not ported yet")


def rope_tables(positions: torch.Tensor, inv_freq: torch.Tensor,
                attention_scaling: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` of :func:`apply_rope`, (batch, seq, 1, rotary_dim) in f32. A decoder
    computes them once a forward and hands them to every layer."""
    angles = positions[..., None].float() * inv_freq  # (b, s, rot/2)
    cos = torch.cos(angles) * attention_scaling
    sin = torch.sin(angles) * attention_scaling
    return (torch.cat([cos, cos], dim=-1)[:, :, None, :],
            torch.cat([sin, sin], dim=-1)[:, :, None, :])


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """out = x*cos + [-x2, x1]*sin with the half split at rotary_dim // 2, in f32, from
    :func:`rope_tables`."""
    rot = cos.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    xf = x_rot.float()
    x1, x2 = xf.chunk(2, dim=-1)
    out = xf * cos + torch.cat([-x2, x1], dim=-1) * sin
    if x_pass.shape[-1]:
        return torch.cat([out.to(x.dtype), x_pass], dim=-1)
    return out.to(x.dtype)


def apply_rope(
    x: torch.Tensor,  # (batch, seq, heads, head_dim)
    positions: torch.Tensor,  # (batch, seq)
    inv_freq: torch.Tensor,
    attention_scaling: float = 1.0,
) -> torch.Tensor:
    """out = x*cos + [-x2, x1]*sin with the half split at rotary_dim // 2, in f32."""
    return apply_rope_tables(x, *rope_tables(positions, inv_freq, attention_scaling))


def rope_tables_interleaved(positions: torch.Tensor, inv_freq: torch.Tensor,
                            attention_scaling: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` of :func:`apply_rope_interleaved`, (batch, seq, 1, rotary_dim // 2)
    in f32, once a forward as :func:`rope_tables`."""
    angles = positions[..., None].float() * inv_freq  # (b, s, rot/2)
    return ((torch.cos(angles) * attention_scaling)[:, :, None, :],
            (torch.sin(angles) * attention_scaling)[:, :, None, :])


def apply_rope_interleaved_tables(x: torch.Tensor, cos: torch.Tensor,
                                  sin: torch.Tensor) -> torch.Tensor:
    """Complex-pair RoPE in f32 from :func:`rope_tables_interleaved`: consecutive pairs
    (x0, x1) rotate to (x0 cos - x1 sin, x0 sin + x1 cos). With fewer rotary dims than
    head_dim (GLM), the rest passes unchanged."""
    rot = 2 * cos.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    xf = x_rot.float()
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    out = out.reshape(x_rot.shape).to(x.dtype)
    if x_pass.shape[-1]:
        return torch.cat([out, x_pass], dim=-1)
    return out


def apply_rope_interleaved(
    x: torch.Tensor,  # (batch, seq, heads, head_dim)
    positions: torch.Tensor,  # (batch, seq)
    inv_freq: torch.Tensor,
    attention_scaling: float = 1.0,
) -> torch.Tensor:
    """Complex-pair RoPE in f32 (DeepSeek's MLA; Cohere, GLM, Helium and Ernie-4.5 in the
    dense decoder): see :func:`apply_rope_interleaved_tables`."""
    return apply_rope_interleaved_tables(
        x, *rope_tables_interleaved(positions, inv_freq, attention_scaling))
