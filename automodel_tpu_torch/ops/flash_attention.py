"""Flash attention: hand-written CUDA kernels for the card, a plain version for the CPU.

Counterpart of ``automodel_tpu/ops/pallas/flash_attention.py``. The signature and the
``(batch, seq, heads, head_dim)`` layout are the JAX package's. A CUDA tensor goes to
the kernels in ``csrc/flash_attention.cu`` or raises; a CPU tensor goes to
:func:`flash_attention_reference`, a direct masked softmax in f32 that also serves as
the kernels' check on the card.

The backward is two kernels: ``flash_dq`` (q-stationary: each q tile sums its dQ over
the key tiles in order) and ``flash_dkv`` (kv-stationary dK and dV), so the gradients
are the same on every run; their plain versions are :func:`flash_dq_reference` and
:func:`flash_dkv_reference`.

The kernels take causal and non-causal masks, GQA, segment ids, a sliding window
(tiles wholly behind it are never loaded), per-head sink logits (folded into the
forward's softmax denominator, so lse holds them and the backward kernels take none; the
sinks' gradient is a reduction over lse and delta, :func:`sink_grad`), the tanh logit
soft-cap (Gemma-2: ``c tanh(s scale / c)`` before the mask, in instantiations of their
own), bf16, head_dim 64, 96 (Phi-3: the 128-wide kernels, whose tensor maps read the
columns past 96 as zeros), 128 and 256 (Gemma-2-9B, Gemma-3: tiles of their own, with
fewer keys a step). Other head dims raise on CUDA.
"""

from __future__ import annotations

import torch

__all__ = ["HEAD_DIM_LAUNCHES", "LAUNCHES", "NONCAUSAL_LAUNCHES", "SOFTCAP_LAUNCHES",
           "WINDOWED_LAUNCHES",
           "flash_attention", "flash_attention_cuda", "flash_attention_reference",
           "flash_backward", "flash_dkv", "flash_dkv_reference", "flash_dq",
           "flash_dq_reference", "flash_fwd", "sink_grad"]

NEG_INF = -1e30
_SOURCE = "flash_attention.cu"
_HEAD_DIMS = (64, 96, 128, 256)
# one count per kernel launch, so a run can show that it went through the kernels
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
# the launches of LAUNCHES that carried a sliding window
WINDOWED_LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
# the launches of LAUNCHES by head dim ("flash_fwd/d96", ...)
HEAD_DIM_LAUNCHES = {f"{name}/d{d}": 0 for name in LAUNCHES for d in _HEAD_DIMS}
# the launches of LAUNCHES that carried a logit soft-cap
SOFTCAP_LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
# the launches of LAUNCHES without the causal mask (a bidirectional encoder's)
NONCAUSAL_LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def _mask(sq, skv, causal, seg_q, seg_kv, sliding_window, device):
    """(B or 1, 1, Sq, Skv) bool allowed-mask, or None when every pair is allowed."""
    allowed = None
    q_idx = torch.arange(sq, device=device)[:, None]
    kv_idx = torch.arange(skv, device=device)[None, :]
    if causal:
        allowed = (q_idx >= kv_idx)[None, None]
    if sliding_window is not None:
        w = (q_idx - kv_idx < sliding_window)[None, None]
        allowed = w if allowed is None else allowed & w
    if seg_q is not None:
        s = (seg_q[:, :, None] == seg_kv[:, None, :])[:, None]
        allowed = s if allowed is None else allowed & s
    return allowed


def _segments(segment_ids_q, segment_ids_kv):
    if segment_ids_q is None and segment_ids_kv is None:
        return None, None
    seg_q = segment_ids_q if segment_ids_q is not None else segment_ids_kv
    seg_kv = segment_ids_kv if segment_ids_kv is not None else segment_ids_q
    return seg_q, seg_kv


def flash_attention_reference(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KH, D)
    v: torch.Tensor,  # (B, Skv, KH, D)
    *,
    causal: bool = True,
    segment_ids_q: torch.Tensor | None = None,
    segment_ids_kv: torch.Tensor | None = None,
    softmax_scale: float | None = None,
    sliding_window: int | None = None,
    logit_soft_cap: float | None = None,
    sinks: torch.Tensor | None = None,  # (H,) per-head sink logits
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' plain version: ``(o, lse)`` with o in q's dtype, lse (B*H, Sq) f32.

    Math in f32 with the TPU kernel's conventions: masked logits are -1e30, a row
    with no allowed key gives o = 0 and lse = -1e30 (or the sink logit), a sink adds
    exp(sink) to the denominator and nothing to the output. Differentiable through
    autograd for every option.
    """
    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    scale = d**-0.5 if softmax_scale is None else softmax_scale
    groups = h // kh
    qf = q.float().permute(0, 2, 1, 3)  # (B, H, Sq, D)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(groups, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(groups, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if logit_soft_cap is not None:
        s = torch.tanh(s / logit_soft_cap) * logit_soft_cap
    seg_q, seg_kv = _segments(segment_ids_q, segment_ids_kv)
    allowed = _mask(sq, skv, causal, seg_q, seg_kv, sliding_window, q.device)
    if allowed is not None:
        s = s.masked_fill(~allowed, NEG_INF)
    # the max only shifts the exponent; detached, the gradient stays exact
    m = s.amax(-1, keepdim=True).detach()
    if sinks is not None:
        sink = sinks.float().reshape(1, h, 1, 1)
        m = torch.maximum(m, sink.detach())
    p = torch.exp(s - m)
    if allowed is not None:
        p = torch.where(allowed, p, torch.zeros((), device=p.device))
    l = p.sum(-1, keepdim=True)
    if sinks is not None:
        l = l + torch.exp(sink - m)
    empty = l == 0
    safe_l = torch.where(empty, torch.ones((), device=l.device), l)
    o = torch.matmul(p / safe_l, vf)
    lse = torch.where(empty, torch.full((), NEG_INF, device=l.device), m + torch.log(safe_l))
    return o.permute(0, 2, 1, 3).to(q.dtype), lse.reshape(b * h, sq)


def _split_backward(q, k, v, do, lse, delta, want_dq, want_dkv, *, causal, segment_ids_q,
                    segment_ids_kv, softmax_scale, sliding_window, logit_soft_cap):
    """The split backward's plain arithmetic in f32, from lse and delta as the kernels
    take them: P = exp(S scale - lse), dS = P (dP - delta); dQ = dS K scale and, summed
    over each GQA group, dK = dS^T Q scale, dV = P^T dO. With a soft-cap c, S scale is
    capped first (c tanh(S scale / c)) and dS takes the factor 1 - (capped / c)^2, as
    JAX's ``_soft_cap_jac``."""
    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    scale = d**-0.5 if softmax_scale is None else softmax_scale
    groups = h // kh
    qf = q.float().permute(0, 2, 1, 3)  # (B, H, Sq, D)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(groups, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(groups, dim=1)
    dof = do.float().permute(0, 2, 1, 3)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if logit_soft_cap is not None:
        s = torch.tanh(s / logit_soft_cap) * logit_soft_cap
    seg_q, seg_kv = _segments(segment_ids_q, segment_ids_kv)
    allowed = _mask(sq, skv, causal, seg_q, seg_kv, sliding_window, q.device)
    p = torch.exp(s - lse.float().reshape(b, h, sq, 1))
    if allowed is not None:
        p = torch.where(allowed, p, torch.zeros((), device=p.device))
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta.float().reshape(b, h, sq, 1))
    if logit_soft_cap is not None:
        ds = ds * (1.0 - (s / logit_soft_cap) ** 2)
    out = []
    if want_dq:
        out.append((torch.matmul(ds, kf) * scale).permute(0, 2, 1, 3).to(q.dtype))
    if want_dkv:
        def group_sum(x):  # (B, H, Skv, D) -> (B, Skv, KH, D)
            return x.reshape(b, kh, groups, skv, d).sum(2).permute(0, 2, 1, 3)
        out.append(group_sum(torch.matmul(ds.transpose(-1, -2), qf) * scale).to(k.dtype))
        out.append(group_sum(torch.matmul(p.transpose(-1, -2), dof)).to(v.dtype))
    return tuple(out)


def flash_dq_reference(q, k, v, do, lse, delta, *, causal=True, segment_ids_q=None,
                       segment_ids_kv=None, softmax_scale=None, sliding_window=None,
                       logit_soft_cap=None):
    """``flash_dq``'s plain version: dQ in q's dtype from ``lse`` and ``delta`` ((B*H, Sq)
    f32, delta = rowsum(dO * O); with sinks, lse already holds them). For the CPU and the
    tests only."""
    return _split_backward(q, k, v, do, lse, delta, True, False, causal=causal,
                           segment_ids_q=segment_ids_q, segment_ids_kv=segment_ids_kv,
                           softmax_scale=softmax_scale, sliding_window=sliding_window,
                           logit_soft_cap=logit_soft_cap)[0]


def flash_dkv_reference(q, k, v, do, lse, delta, *, causal=True, segment_ids_q=None,
                        segment_ids_kv=None, softmax_scale=None, sliding_window=None,
                        logit_soft_cap=None):
    """``flash_dkv``'s plain version: ``(dk, dv)`` in k's and v's dtypes, summed over each
    GQA group, from ``lse`` and ``delta``. For the CPU and the tests only."""
    return _split_backward(q, k, v, do, lse, delta, False, True, causal=causal,
                           segment_ids_q=segment_ids_q, segment_ids_kv=segment_ids_kv,
                           softmax_scale=softmax_scale, sliding_window=sliding_window,
                           logit_soft_cap=logit_soft_cap)


def sink_grad(sinks, lse, delta):
    """d loss / d sinks from the forward's lse and delta ((B*H, Sq) f32): the sink column's
    p (dp - delta) with dp = 0, -sum over batch and rows of exp(sink - lse) delta; JAX's
    ``_dsinks_from_residuals``, a plain reduction on every device. In sinks' dtype."""
    h = sinks.shape[0]
    p = torch.exp(sinks.float().reshape(1, h, 1) - lse.float().reshape(-1, h, lse.shape[-1]))
    return -(p * delta.float().reshape(p.shape)).sum((0, 2)).to(sinks.dtype)


def _check_cuda(q, k, v, seg_q, seg_kv, sinks=None):
    if q.ndim == 4 and q.shape[3] not in _HEAD_DIMS:  # refused by name, on any device
        raise NotImplementedError(f"flash_attention kernels take head_dim in {_HEAD_DIMS}, "
                                  f"got {q.shape[3]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on cuda")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernels take bf16, {name} is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and 16-byte aligned")
    if q.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}")
    if seg_q is not None:
        for t, s in ((seg_q, q.shape[1]), (seg_kv, k.shape[1])):
            if t.shape != (q.shape[0], s) or t.device != q.device:
                raise ValueError(f"segment ids must be ({q.shape[0]}, {s}) on {q.device}")
    if sinks is not None and (sinks.shape != (q.shape[2],) or sinks.device != q.device):
        raise ValueError(f"sinks must be ({q.shape[2]},) on {q.device}, got "
                         f"{tuple(sinks.shape)} on {sinks.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _window(window):
    """The kernels' (has_window, window) pair."""
    return (0, 0) if window is None else (1, window)


def _count(name, window, head_dim, softcap, causal):
    LAUNCHES[name] += 1
    HEAD_DIM_LAUNCHES[f"{name}/d{head_dim}"] += 1
    if window is not None:
        WINDOWED_LAUNCHES[name] += 1
    if softcap:
        SOFTCAP_LAUNCHES[name] += 1
    if not causal:
        NONCAUSAL_LAUNCHES[name] += 1


def flash_fwd(q, k, v, seg_q, seg_kv, scale, causal, window=None, sinks=None, softcap=0.0):
    """Launch the forward kernel on checked inputs (``sinks``: None or f32 (H,),
    contiguous; ``softcap``: the logit cap c, 0 for none): ``(o, lse)``."""
    from automodel_tpu_torch.kernels.build import launch

    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    launch(_SOURCE, "flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           _ptr(seg_q), _ptr(seg_kv), _ptr(sinks), o.data_ptr(), lse.data_ptr(), b, sq, skv,
           h, kh, d, float(scale), float(softcap), int(causal), *_window(window))
    _count("flash_fwd", window, d, softcap, causal)
    return o, lse


def _delta(o, do):
    """rowsum(dO * O) as (B*H, Sq) f32, like lse; a plain reduction, as XLA's in JAX."""
    b, sq, h, _ = o.shape
    prod = do.to(torch.float32, copy=True).mul_(o)  # one f32 copy; do stays as it is
    return prod.sum(-1).transpose(1, 2).reshape(b * h, sq).contiguous()


def flash_dq(q, k, v, seg_q, seg_kv, do, lse, delta, scale, causal, window=None, softcap=0.0):
    """Launch the q-stationary dQ kernel on checked inputs (``do`` contiguous, ``delta``
    from :func:`_delta`): dQ in q's dtype, summed in the same order on every run."""
    from automodel_tpu_torch.kernels.build import launch

    b, sq, h, d = q.shape
    dq = torch.empty_like(q)
    launch(_SOURCE, "flash_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           _ptr(seg_q), _ptr(seg_kv), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
           dq.data_ptr(), b, sq, k.shape[1], h, k.shape[2], d, float(scale), float(softcap),
           int(causal), *_window(window))
    _count("flash_dq", window, d, softcap, causal)
    return dq


def flash_dkv(q, k, v, seg_q, seg_kv, do, lse, delta, scale, causal, window=None,
              softcap=0.0):
    """Launch the backward kernel without dQ on checked inputs: ``(dk, dv)``."""
    from automodel_tpu_torch.kernels.build import launch

    b, sq, h, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    launch(_SOURCE, "flash_dkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           _ptr(seg_q), _ptr(seg_kv), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
           dk.data_ptr(), dv.data_ptr(), b, sq, k.shape[1], h, k.shape[2], d, float(scale),
           float(softcap), int(causal), *_window(window))
    _count("flash_dkv", window, d, softcap, causal)
    return dk, dv


def flash_backward(q, k, v, seg_q, seg_kv, o, lse, do, scale, causal, window=None,
                   softcap=0.0):
    """``(dq, dk, dv)`` from ``flash_dq`` and ``flash_dkv``, after delta = rowsum(dO * O).
    With sinks, lse holds them: the kernels take the same inputs."""
    dq, dk, dv, _ = _backward(q, k, v, seg_q, seg_kv, o, lse, do, scale, causal, window,
                              softcap)
    return dq, dk, dv


def _backward(q, k, v, seg_q, seg_kv, o, lse, do, scale, causal, window, softcap):
    do = do.contiguous()
    delta = _delta(o, do)
    dq = flash_dq(q, k, v, seg_q, seg_kv, do, lse, delta, scale, causal, window, softcap)
    dk, dv = flash_dkv(q, k, v, seg_q, seg_kv, do, lse, delta, scale, causal, window, softcap)
    return dq, dk, dv, delta


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, sinks, scale, causal, window, softcap):
        sinks_f = None if sinks is None else sinks.float().contiguous()
        o, lse = flash_fwd(q, k, v, seg_q, seg_kv, scale, causal, window, sinks_f, softcap)
        ctx.save_for_backward(q, k, v, seg_q, seg_kv, sinks, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.scale, ctx.causal, ctx.window, ctx.softcap = scale, causal, window, softcap
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        del dlse  # lse is a residual for the backward, not a differentiated output
        q, k, v, seg_q, seg_kv, sinks, o, lse = ctx.saved_tensors
        dq, dk, dv, delta = _backward(q, k, v, seg_q, seg_kv, o, lse, do, ctx.scale, ctx.causal,
                                      ctx.window, ctx.softcap)
        dsinks = None
        if sinks is not None and ctx.needs_input_grad[5]:
            dsinks = sink_grad(sinks, lse, delta)
        return dq, dk, dv, None, None, dsinks, None, None, None, None


def flash_attention_cuda(q, k, v, *, causal=True, segment_ids_q=None, segment_ids_kv=None,
                         softmax_scale=None, sliding_window=None, logit_soft_cap=None,
                         sinks=None):
    """``(o, lse)`` from the kernels; inputs are checked first, nothing falls back.
    ``sinks`` (H,) is differentiable; its gradient is :func:`sink_grad`.
    ``logit_soft_cap`` (c > 0, or None) runs the capped instantiations."""
    seg_q, seg_kv = _segments(segment_ids_q, segment_ids_kv)
    _check_cuda(q, k, v, seg_q, seg_kv, sinks)
    if seg_q is not None:
        seg_q = seg_q.to(torch.int32).contiguous()
        seg_kv = seg_kv.to(torch.int32).contiguous()
    scale = q.shape[-1] ** -0.5 if softmax_scale is None else softmax_scale
    window = None if sliding_window is None else int(sliding_window)
    if window is not None and not 0 <= window < 2**31:
        raise ValueError(f"flash_attention: sliding_window {window} is outside the kernels' "
                         "int32 range")
    softcap = 0.0 if logit_soft_cap is None else float(logit_soft_cap)
    if logit_soft_cap is not None and not softcap > 0.0:
        raise ValueError(f"flash_attention: logit_soft_cap must be > 0, got {logit_soft_cap}")
    o, lse = _FlashAttention.apply(q, k, v, seg_q, seg_kv, sinks, float(scale), bool(causal),
                                   window, softcap)
    return o, lse


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KH, D)
    v: torch.Tensor,  # (B, Skv, KH, D)
    *,
    causal: bool = True,
    segment_ids_q: torch.Tensor | None = None,  # (B, Sq)
    segment_ids_kv: torch.Tensor | None = None,  # (B, Skv)
    softmax_scale: float | None = None,
    sliding_window: int | None = None,
    logit_soft_cap: float | None = None,
    sinks: torch.Tensor | None = None,  # (H,)
) -> torch.Tensor:
    """Flash attention over (batch, seq, heads, head_dim); returns q's shape and dtype."""
    if q.device.type == "cpu":
        o, _ = flash_attention_reference(
            q, k, v, causal=causal, segment_ids_q=segment_ids_q,
            segment_ids_kv=segment_ids_kv, softmax_scale=softmax_scale,
            sliding_window=sliding_window, logit_soft_cap=logit_soft_cap, sinks=sinks)
        return o
    o, _ = flash_attention_cuda(q, k, v, causal=causal, segment_ids_q=segment_ids_q,
                                segment_ids_kv=segment_ids_kv, softmax_scale=softmax_scale,
                                sliding_window=sliding_window, logit_soft_cap=logit_soft_cap,
                                sinks=sinks)
    return o
