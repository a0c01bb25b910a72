"""Attention dispatch (counterpart of ``automodel_tpu/ops/attention.py``).

``backend="xla"`` is the plain einsum-softmax path. ``backend="flash"`` goes to
:func:`automodel_tpu_torch.ops.flash_attention.flash_attention` under the JAX
package's guards (no extra bias, no positions, equal q/v head dim, both sequence
lengths divisible by 8); that function launches the kernels for CUDA tensors and
runs their plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["dot_product_attention"]


def _attention_bias(seq_q, seq_kv, *, causal, segment_ids_q, segment_ids_kv,
                    positions_q=None, positions_kv=None, sliding_window=None,
                    device=None):
    """Additive mask bias (0 allowed / f32 min disallowed), (b or 1, 1, sq, skv)."""
    masks = []
    if positions_q is None:
        q_pos = torch.arange(seq_q, device=device)[None, :, None]
        kv_pos = torch.arange(seq_kv, device=device)[None, None, :]
    else:
        q_pos = positions_q[:, :, None]
        kv_pos = (positions_kv if positions_kv is not None else positions_q)[:, None, :]
    if causal:
        masks.append((q_pos >= kv_pos)[:, None])
    if sliding_window is not None:
        masks.append((q_pos - kv_pos < sliding_window)[:, None])
    if segment_ids_q is not None:
        kv_seg = segment_ids_kv if segment_ids_kv is not None else segment_ids_q
        masks.append((segment_ids_q[:, :, None] == kv_seg[:, None, :])[:, None])
    if not masks:
        return None
    allowed = masks[0]
    for m in masks[1:]:
        allowed = allowed & m
    zero = torch.zeros((), dtype=torch.float32, device=allowed.device)
    neg = torch.full((), torch.finfo(torch.float32).min, device=allowed.device)
    return torch.where(allowed, zero, neg)


def dot_product_attention(
    q: torch.Tensor,  # (b, sq, n_heads, head_dim)
    k: torch.Tensor,  # (b, skv, n_kv_heads, head_dim)
    v: torch.Tensor,  # (b, skv, n_kv_heads, head_dim_v)
    *,
    causal: bool = True,
    segment_ids_q: torch.Tensor | None = None,
    segment_ids_kv: torch.Tensor | None = None,
    positions_q: torch.Tensor | None = None,
    positions_kv: torch.Tensor | None = None,
    sliding_window: int | None = None,
    softmax_scale: float | None = None,
    logit_soft_cap: float | None = None,
    sinks: torch.Tensor | None = None,
    extra_bias: torch.Tensor | None = None,
    backend: str = "xla",
) -> torch.Tensor:
    """Multi-head attention with GQA, packing segments, sliding window, soft-cap, sinks."""
    if (
        backend == "flash"
        and extra_bias is None
        and positions_q is None  # the kernels mask by absolute index, not positions
        and positions_kv is None
        and q.shape[-1] == v.shape[-1]
        and q.shape[1] % 8 == 0
        and k.shape[1] % 8 == 0
    ):
        return flash_attention(
            q, k, v, causal=causal, segment_ids_q=segment_ids_q,
            segment_ids_kv=segment_ids_kv, sliding_window=sliding_window,
            softmax_scale=softmax_scale, logit_soft_cap=logit_soft_cap, sinks=sinks)
    if backend not in ("xla", "flash"):
        raise ValueError(f"unknown attention backend {backend!r} (xla | flash)")

    b, sq, nh, hd = q.shape
    _, skv, nkv, _ = k.shape
    if softmax_scale is None:
        softmax_scale = hd**-0.5
    groups = nh // nkv
    qf = (q.float() * softmax_scale).reshape(b, sq, nkv, groups, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if logit_soft_cap is not None:
        logits = torch.tanh(logits / logit_soft_cap) * logit_soft_cap
    bias = _attention_bias(
        sq, skv, causal=causal, segment_ids_q=segment_ids_q, segment_ids_kv=segment_ids_kv,
        positions_q=positions_q, positions_kv=positions_kv, sliding_window=sliding_window,
        device=q.device)
    if bias is not None:
        logits = logits + bias[:, :, None]  # broadcast over the GQA group dim
    if extra_bias is not None:
        logits = logits + extra_bias[:, None, None].float()
    if sinks is not None:
        sink = sinks.reshape(1, nkv, groups, 1, 1).float().expand(b, nkv, groups, sq, 1)
        logits_max = torch.cat([logits, sink], dim=-1).amax(-1, keepdim=True)
        unnorm = torch.exp(logits - logits_max)
        denom = unnorm.sum(-1, keepdim=True) + torch.exp(sink - logits_max)
        probs = unnorm / denom
    else:
        probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, nh, v.shape[-1]).to(q.dtype)
