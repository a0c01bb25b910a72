"""Flash attention: hand-written CUDA kernels for the card, a plain version for the CPU.

Counterpart of ``automodel_tpu/ops/pallas/flash_attention.py``. The signature and the
``(batch, seq, heads, head_dim)`` layout are the JAX package's. A CUDA tensor goes to
the kernels in ``csrc/flash_attention.cu`` (``flash_fwd``, ``flash_bwd``) or raises;
a CPU tensor goes to :func:`flash_attention_reference`, a direct masked softmax in
f32 that also serves as the kernels' check on the card.

The kernels cover what the Llama path uses: causal and non-causal masks, GQA, segment
ids, bf16 and head_dim 64. Sliding window, logit soft-cap and sinks exist only in the
plain version and raise on CUDA.
"""

from __future__ import annotations

import torch

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_cuda", "flash_attention_reference",
           "flash_bwd", "flash_fwd"]

NEG_INF = -1e30
# one count per kernel launch, so a run can show that it went through the kernels
LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0}
_SOURCE = "flash_attention.cu"
_HEAD_DIMS = (64,)


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


def _check_cuda(q, k, v, seg_q, seg_kv):
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
    if q.shape[3] not in _HEAD_DIMS:
        raise NotImplementedError(f"flash_attention kernels take head_dim in {_HEAD_DIMS}, "
                                  f"got {q.shape[3]}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}")
    if seg_q is not None:
        for t, s in ((seg_q, q.shape[1]), (seg_kv, k.shape[1])):
            if t.shape != (q.shape[0], s) or t.device != q.device:
                raise ValueError(f"segment ids must be ({q.shape[0]}, {s}) on {q.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_fwd(q, k, v, seg_q, seg_kv, scale, causal):
    """Launch the forward kernel on checked inputs: ``(o, lse)``."""
    from automodel_tpu_torch.kernels.build import check, library

    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    fn = library(_SOURCE).flash_fwd
    with torch.cuda.device(q.device):  # the launch goes to the calling thread's device
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg_q), _ptr(seg_kv),
                 o.data_ptr(), lse.data_ptr(), b, sq, skv, h, kh, d, float(scale),
                 int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_bwd(q, k, v, seg_q, seg_kv, o, lse, do, scale, causal):
    """Launch the backward kernel on checked inputs: ``(dq, dk, dv)``."""
    from automodel_tpu_torch.kernels.build import check, library

    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    do = do.contiguous()
    # delta = rowsum(dO * O), (B*H, Sq) like lse; a plain reduction, as XLA's in JAX
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, sq).contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = library(_SOURCE).flash_bwd
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg_q), _ptr(seg_kv),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b, sq, skv, h, kh, d, float(scale),
                 int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_bwd")
    LAUNCHES["flash_bwd"] += 1
    return dq.to(q.dtype), dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, scale, causal):
        o, lse = flash_fwd(q, k, v, seg_q, seg_kv, scale, causal)
        ctx.save_for_backward(q, k, v, seg_q, seg_kv, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.scale, ctx.causal = scale, causal
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        del dlse  # lse is a residual for the backward, not a differentiated output
        q, k, v, seg_q, seg_kv, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, seg_q, seg_kv, o, lse, do, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None, None


def flash_attention_cuda(q, k, v, *, causal=True, segment_ids_q=None, segment_ids_kv=None,
                         softmax_scale=None):
    """``(o, lse)`` from the kernels; inputs are checked first, nothing falls back."""
    seg_q, seg_kv = _segments(segment_ids_q, segment_ids_kv)
    _check_cuda(q, k, v, seg_q, seg_kv)
    if seg_q is not None:
        seg_q = seg_q.to(torch.int32).contiguous()
        seg_kv = seg_kv.to(torch.int32).contiguous()
    scale = q.shape[-1] ** -0.5 if softmax_scale is None else softmax_scale
    o, lse = _FlashAttention.apply(q, k, v, seg_q, seg_kv, float(scale), bool(causal))
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
    if sliding_window is not None or logit_soft_cap is not None or sinks is not None:
        raise NotImplementedError(
            "flash_fwd/flash_bwd take no sliding window, soft-cap or sinks yet "
            "(ROADMAP.md: the Gemma/gpt-oss slice)")
    o, _ = flash_attention_cuda(q, k, v, causal=causal, segment_ids_q=segment_ids_q,
                                segment_ids_kv=segment_ids_kv, softmax_scale=softmax_scale)
    return o
