"""Ring-attention chunk kernels: hand-written CUDA for the card, a plain version for the CPU.

Counterpart of ``automodel_tpu/ops/pallas/ring_chunk.py``. One ring step of context
parallelism attends the local q against one visiting kv chunk. The forward merges that
chunk's attention into the online-softmax carry (acc, m, l); the backward gives the dq
partial and the chunk's dk / dv from one recompute, given the global lse and delta.
Masks come from data: global positions (causal, sliding window) and segment ids travel
with the chunks.

Layouts are the JAX package's row form, except that positions, segment ids and the
per-row statistics are compact instead of broadcast over the TPU's 128 lanes / 8
sublanes:

  q (B*H, Sq, D)   k (B*KH, Skv, D)   v (B*KH, Skv, Dv)     H = KH * groups
  pos_q, seg_q (B, Sq) int32   pos_kv, seg_kv (B, Skv) int32   (segments optional)
  carry: acc (B*H, Sq, Dv) f32, m / l (B*H, Sq) f32
  backward: do (B*H, Sq, Dv), lse / delta (B*H, Sq) f32; dq (B*H, Sq, D),
            dk (B*KH, Skv, D), dv (B*KH, Skv, Dv) f32 accumulators

Both wrappers work in place: :func:`chunk_attention_fwd` writes the updated carry into
acc / m / l and :func:`chunk_attention_bwd` adds into dq / dk / dv (dk / dv already
summed over the GQA group, where the TPU kernel returns them per q head). CUDA tensors
go to ``ring_fwd`` / ``ring_bwd`` in ``csrc/ring_chunk.cu`` or raise; CPU tensors go to
the plain versions below. The kernels skip a (q tile, kv tile) pair that holds no
allowed pair and leave a pair that holds only allowed pairs unmasked, from the ranges
of positions and segment ids the two tiles hold: :func:`tile_class` is that rule, for
the tests and for counting; the plain versions do not use it. Given ``tile_counts``, a
(3,) int32 CUDA tensor, a kernel adds the pairs of each class it met (SKIP, PARTIAL,
FULL, over every q head forward and every kv head backward), so that a run can hold the
device's rule against :func:`tile_classes`.

The backward has two routes. By default ``ring_bwd`` adds the dq partial by TMA
reduce-adds, which land in no fixed order. When
``torch.are_deterministic_algorithms_enabled()``, or when Dv != D (the fused kernel's
shared memory does not hold MLA's widths), :func:`chunk_attention_bwd` runs ``ring_dq``
(q-stationary: each q tile sums its dQ over the chunk's key tiles in order and adds it
into dq once) and ``ring_dkv`` (``ring_bwd`` without dQ); their plain versions are
:func:`chunk_attention_dq_reference` and :func:`chunk_attention_dkv_reference`. Neither
route falls back to the other.

The JAX arguments ``block_q``, ``block_k``, ``interpret`` and ``vma`` have no
counterpart. The kernels take bf16 at the (D, Dv) pairs of :data:`HEAD_DIMS`: (64, 64)
and (128, 128), and MLA's (192, 128) (DeepSeek-V3, Moonlight), with ``ring_bwd`` at
Dv == D only; any other pair raises NotImplementedError on the card. The softmax scale
is always the caller's (DeepSeek's carries YaRN's mscale^2), never derived from D.
:data:`DIM_LAUNCHES` counts the launches by (D, Dv) beside :data:`LAUNCHES`.
"""

from __future__ import annotations

import torch

__all__ = ["DIM_LAUNCHES", "FULL", "HEAD_DIMS", "LAUNCHES", "NEG_INF", "PARTIAL", "SKIP",
           "allowed_mask", "bwd_block_q", "check_head_dims",
           "chunk_attention_bwd", "chunk_attention_bwd_reference",
           "chunk_attention_dkv_reference", "chunk_attention_dq_reference",
           "chunk_attention_fwd", "chunk_attention_fwd_reference", "ring_bwd", "ring_dkv",
           "ring_dq", "ring_fwd", "tile_class", "tile_classes"]

NEG_INF = -1e30
# one count per kernel launch, so a run can show that it went through the kernels
LAUNCHES = {"ring_fwd": 0, "ring_bwd": 0, "ring_dkv": 0, "ring_dq": 0}
_SOURCE = "ring_chunk.cu"
# the (D, Dv) pairs the kernels are instantiated at (csrc/ring_chunk.cu)
HEAD_DIMS = ((64, 64), (128, 128), (192, 128))
# launches by kernel and (D, Dv), "ring_fwd/d192v128" and the like
DIM_LAUNCHES = {f"{k}/d{d}v{dv}": 0 for k in LAUNCHES for d, dv in HEAD_DIMS
                if not (k == "ring_bwd" and d != dv)}
# tile classes (csrc/ring_chunk.cu: SKIP, PARTIAL, FULL)
SKIP, PARTIAL, FULL = 0, 1, 2
# the plain versions form (batch, H, Sq, Skv) f32 scores; they loop over batch rows so
# that one slice holds at most this many score elements (2 GiB in f32)
_SCORE_ELEMS = 1 << 29


def allowed_mask(pos_q, pos_kv, seg_q, seg_kv, causal, window):
    """(B, Sq, Skv) bool allowed-mask from positions and segments; None when unmasked."""
    allowed = None

    def _and(a, b):
        return b if a is None else a & b

    pq, pkv = pos_q[:, :, None], pos_kv[:, None, :]
    if causal:
        allowed = _and(allowed, pq >= pkv)
    if window is not None:
        allowed = _and(allowed, pq - pkv < window)
    if seg_q is not None:
        allowed = _and(allowed, seg_q[:, :, None] == seg_kv[:, None, :])
    return allowed


def tile_class(q, kv, causal, window):
    """The class of (q tile, kv tile) pairs from the ranges of ids each tile holds:
    ``q`` and ``kv`` are ``(pos_lo, pos_hi, seg_lo, seg_hi, ragged)``, over the tile's
    rows inside Sq / Skv (``seg_*`` None without segments; ``ragged``: the tile runs
    past its chunk), as ints or broadcastable tensors. SKIP when no pair is allowed,
    FULL when every pair is and neither tile is ragged, else PARTIAL."""
    qp_lo, qp_hi, qs_lo, qs_hi, q_ragged = q
    kp_lo, kp_hi, ks_lo, ks_hi, k_ragged = kv
    skip = False
    if causal:
        skip = skip | (qp_hi < kp_lo)
    if window is not None:
        skip = skip | (qp_lo - kp_hi >= window)
    if qs_lo is not None:
        skip = skip | (qs_hi < ks_lo) | (ks_hi < qs_lo)
    full = ~torch.as_tensor(q_ragged | k_ragged)
    if causal:
        full = full & (qp_lo >= kp_hi)
    if window is not None:
        full = full & (qp_hi - kp_lo < window)
    if qs_lo is not None:
        full = full & (qs_lo == qs_hi) & (ks_lo == ks_hi) & (qs_lo == ks_lo)
    return torch.where(torch.as_tensor(skip), SKIP, torch.where(full, FULL, PARTIAL))


def _tile_ranges(ids, block):
    """(lo, hi) over tiles of ``block`` rows of (B, S) ids, rows inside S only: (B, n)."""
    b, s = ids.shape
    n = -(-s // block)
    x = ids.to(torch.int64)
    # rows past S hold the extremes, so that they move neither end of a range (F.pad's
    # value goes through a float, where int64's extremes do not survive)
    lo = x.new_full((b, n * block), torch.iinfo(torch.int64).max)
    hi = x.new_full((b, n * block), torch.iinfo(torch.int64).min)
    lo[:, :s], hi[:, :s] = x, x
    return lo.view(b, n, block).amin(-1), hi.view(b, n, block).amax(-1)


def tile_classes(pos_q, pos_kv, seg_q, seg_kv, causal, window, block_q, block_kv):
    """(B, n_q, n_kv) :func:`tile_class` of every (q tile, kv tile) pair of one chunk
    step, tiles of ``block_q`` q rows and ``block_kv`` keys."""
    def ranges(pos, seg, block, dim):  # the q side along dim 1 of the result, kv along 2
        p_lo, p_hi = _tile_ranges(pos, block)
        s_lo, s_hi = (None, None) if seg is None else _tile_ranges(seg, block)
        ragged = (torch.arange(p_lo.shape[1], device=pos.device) + 1) * block > pos.shape[1]
        return tuple(None if x is None else x.unsqueeze(3 - dim)
                     for x in (p_lo, p_hi, s_lo, s_hi, ragged.expand_as(p_lo)))

    return tile_class(ranges(pos_q, seg_q, block_q, 1), ranges(pos_kv, seg_kv, block_kv, 2),
                      causal, window)


def _batch_slices(b, h, sq, skv):
    step = max(1, _SCORE_ELEMS // max(1, h * sq * skv))
    return [slice(i, min(i + step, b)) for i in range(0, b, step)]


def chunk_attention_fwd_reference(q, k, v, pos_q, pos_kv, seg_q, seg_kv, acc, m, l, *,
                                  scale, causal, window, groups, n_heads):
    """The forward kernel's plain version in f32: the updated ``(acc, m, l)`` as new
    tensors. A masked logit is NEG_INF and a masked p is 0, so a row with nothing
    allowed keeps m = NEG_INF, l = 0, acc = 0."""
    bn, sq, d = q.shape
    b, kh = bn // n_heads, n_heads // groups
    skv, dv = k.shape[1], v.shape[2]
    outs = []
    for sl in _batch_slices(b, n_heads, sq, skv):
        nb = sl.stop - sl.start
        qf = q.float().view(b, kh, groups, sq, d)[sl]
        kf = k.float().view(b, kh, 1, skv, d)[sl]
        vf = v.float().view(b, kh, 1, skv, dv)[sl]
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale  # (nb, kh, g, sq, skv)
        allowed = allowed_mask(pos_q[sl], pos_kv[sl], None if seg_q is None else seg_q[sl],
                           None if seg_kv is None else seg_kv[sl], causal, window)
        if allowed is not None:
            allowed = allowed[:, None, None]
            s = s.masked_fill(~allowed, NEG_INF)
        m_prev = m.float().view(b, kh, groups, sq, 1)[sl]
        m_new = torch.maximum(m_prev, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        if allowed is not None:
            p = p.masked_fill(~allowed, 0.0)
        alpha = torch.exp(m_prev - m_new)
        l_new = l.float().view(b, kh, groups, sq, 1)[sl] * alpha + p.sum(-1, keepdim=True)
        acc_new = (acc.float().view(b, kh, groups, sq, dv)[sl] * alpha
                   + torch.matmul(p, vf))
        outs.append((acc_new.reshape(nb * n_heads, sq, dv), m_new.reshape(nb * n_heads, sq),
                     l_new.reshape(nb * n_heads, sq)))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _chunk_grads(q, k, v, pos_q, pos_kv, seg_q, seg_kv, do, lse, delta, want_dq, want_dkv, *,
                 scale, causal, window, groups, n_heads):
    """The backward's plain arithmetic in f32: dq and / or (dk, dv) of this chunk as new
    tensors, dk / dv summed over the GQA group. p = exp(s - lse) with the global lse,
    ds = p * (dp - delta)."""
    bn, sq, d = q.shape
    b, kh = bn // n_heads, n_heads // groups
    skv, dv = k.shape[1], v.shape[2]
    dqs, dks, dvs = [], [], []
    for sl in _batch_slices(b, n_heads, sq, skv):
        nb = sl.stop - sl.start
        qf = q.float().view(b, kh, groups, sq, d)[sl]
        kf = k.float().view(b, kh, 1, skv, d)[sl]
        vf = v.float().view(b, kh, 1, skv, dv)[sl]
        dof = do.float().view(b, kh, groups, sq, dv)[sl]
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        allowed = allowed_mask(pos_q[sl], pos_kv[sl], None if seg_q is None else seg_q[sl],
                           None if seg_kv is None else seg_kv[sl], causal, window)
        if allowed is not None:
            allowed = allowed[:, None, None]
            s = s.masked_fill(~allowed, NEG_INF)
        p = torch.exp(s - lse.float().view(b, kh, groups, sq, 1)[sl])
        if allowed is not None:
            p = p.masked_fill(~allowed, 0.0)
        dp = torch.matmul(dof, vf.transpose(-1, -2))
        ds = p * (dp - delta.float().view(b, kh, groups, sq, 1)[sl])
        if want_dq:
            dqs.append((torch.matmul(ds, kf) * scale).reshape(nb * n_heads, sq, d))
        if want_dkv:
            dks.append((torch.matmul(ds.transpose(-1, -2), qf) * scale).sum(2)
                       .reshape(nb * kh, skv, d))
            dvs.append(torch.matmul(p.transpose(-1, -2), dof).sum(2).reshape(nb * kh, skv, dv))
    return tuple(torch.cat(x) for x in (dqs, dks, dvs) if x)


def chunk_attention_bwd_reference(q, k, v, pos_q, pos_kv, seg_q, seg_kv, do, lse, delta, **kw):
    """The backward kernel's plain version in f32: ``(dq, dk, dv)`` of this chunk as new
    tensors, dk / dv summed over the GQA group. p = exp(s - lse) with the global lse,
    ds = p * (dp - delta). Keywords: ``scale``, ``causal``, ``window``, ``groups``,
    ``n_heads``."""
    return _chunk_grads(q, k, v, pos_q, pos_kv, seg_q, seg_kv, do, lse, delta, True, True, **kw)


def chunk_attention_dq_reference(q, k, v, pos_q, pos_kv, seg_q, seg_kv, do, lse, delta, **kw):
    """``ring_dq``'s plain version: this chunk's dq partial (f32, new tensor)."""
    return _chunk_grads(q, k, v, pos_q, pos_kv, seg_q, seg_kv, do, lse, delta, True, False,
                        **kw)[0]


def chunk_attention_dkv_reference(q, k, v, pos_q, pos_kv, seg_q, seg_kv, do, lse, delta, **kw):
    """The plain version of ``ring_bwd`` without dQ: ``(dk, dv)`` of this chunk (f32, new
    tensors, summed over the GQA group)."""
    return _chunk_grads(q, k, v, pos_q, pos_kv, seg_q, seg_kv, do, lse, delta, False, True,
                        **kw)


def check_head_dims(d: int, dv: int) -> None:
    """NotImplementedError unless the kernels are instantiated at (D, Dv)."""
    if (d, dv) not in HEAD_DIMS:
        raise NotImplementedError(f"ring chunk kernels take (D, Dv) in {HEAD_DIMS}, got "
                                  f"({d}, {dv})")


def _check_cuda(q, k, v, pos_q, pos_kv, seg_q, seg_kv, f32, groups, n_heads):
    """Raise on anything the kernels do not take; nothing falls back."""
    for name, t in (("q", q), ("k", k), ("v", v), *f32.items()):
        if t.device.type != "cuda":
            raise ValueError(f"ring chunk kernels: {name} is on {t.device}, not a CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"ring chunk kernels: {name} must be contiguous and 16-byte aligned")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"ring chunk kernels take bf16 q/k/v, {name} is {t.dtype}")
    bn, sq, d = q.shape
    dv = v.shape[-1]
    check_head_dims(d, dv)
    shapes = {"acc": (bn, sq, dv), "m": (bn, sq), "l": (bn, sq), "lse": (bn, sq),
              "delta": (bn, sq), "dq": (bn, sq, d), "dk": tuple(k.shape), "dv": tuple(v.shape)}
    for name, t in f32.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shapes[name]:
            raise ValueError(f"ring chunk kernels: {name} must be f32 {shapes[name]}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if (n_heads % groups or bn % n_heads or k.shape[0] * groups != bn
            or k.shape[:2] != v.shape[:2]):
        raise ValueError(f"ring chunk kernels: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} for n_heads={n_heads}, groups={groups}")
    b = bn // n_heads
    for name, t, s in (("pos_q", pos_q, sq), ("pos_kv", pos_kv, k.shape[1]),
                       ("seg_q", seg_q, sq), ("seg_kv", seg_kv, k.shape[1])):
        if t is None:
            continue
        if t.shape != (b, s) or t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"ring chunk kernels: {name} must be contiguous int32 ({b}, {s}) "
                             f"on {q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if (seg_q is None) != (seg_kv is None):
        raise ValueError("ring chunk kernels: seg_q and seg_kv come together")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _counts(tile_counts, q):
    """The pointer of an optional (3,) int32 tile-count tensor on q's device."""
    if tile_counts is None:
        return None
    if (tile_counts.shape != (3,) or tile_counts.dtype != torch.int32
            or tile_counts.device != q.device):
        raise ValueError(f"ring chunk kernels: tile_counts must be int32 (3,) on {q.device}")
    return tile_counts.data_ptr()


def _window(window):
    return (0, 0) if window is None else (1, int(window))


def bwd_block_q(d: int, dv: int) -> int:
    """q rows of a step of ``ring_bwd`` / ``ring_dkv`` (their tile-count unit): 64, and 32
    at Dv != D, where dK's 64 x 192 f32 accumulator leaves fewer registers for S and dP."""
    return 64 if d == dv else 32


def _count(name, q, v):
    LAUNCHES[name] += 1
    key = f"{name}/d{q.shape[-1]}v{v.shape[-1]}"
    DIM_LAUNCHES[key] = DIM_LAUNCHES.get(key, 0) + 1


def ring_fwd(q, k, v, pos_q, pos_kv, seg_q, seg_kv, acc, m, l, *, scale, causal, window,
             groups, n_heads, tile_counts=None):
    """Launch the forward kernel on checked inputs; updates (acc, m, l) in place, and
    adds its tile counts into ``tile_counts`` when given."""
    from automodel_tpu_torch.kernels.build import launch

    bn, sq, d = q.shape
    has_window, win = _window(window)
    launch(_SOURCE, "ring_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           pos_q.data_ptr(), pos_kv.data_ptr(), _ptr(seg_q), _ptr(seg_kv), acc.data_ptr(),
           m.data_ptr(), l.data_ptr(), bn // n_heads, sq, k.shape[1], n_heads,
           n_heads // groups, d, v.shape[-1], float(scale), int(causal), has_window, win,
           _counts(tile_counts, q))
    _count("ring_fwd", q, v)
    return acc, m, l


def ring_bwd(q, k, v, pos_q, pos_kv, seg_q, seg_kv, do, lse, delta, dq, dk, dv, *, scale,
             causal, window, groups, n_heads, tile_counts=None):
    """Launch the backward kernel on checked inputs; adds into (dq, dk, dv) in place, and
    its tile counts into ``tile_counts`` when given."""
    from automodel_tpu_torch.kernels.build import launch

    bn, sq, d = q.shape
    if v.shape[-1] != d:
        raise NotImplementedError("ring_bwd takes Dv == D; Dv != D runs ring_dq + ring_dkv")
    has_window, win = _window(window)
    launch(_SOURCE, "ring_bwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           pos_q.data_ptr(), pos_kv.data_ptr(), _ptr(seg_q), _ptr(seg_kv), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           bn // n_heads, sq, k.shape[1], n_heads, n_heads // groups, d, v.shape[-1],
           float(scale), int(causal), has_window, win, _counts(tile_counts, q))
    _count("ring_bwd", q, v)
    return dq, dk, dv


def ring_dkv(q, k, v, pos_q, pos_kv, seg_q, seg_kv, do, lse, delta, dk, dv, *, scale, causal,
             window, groups, n_heads, tile_counts=None):
    """Launch the backward kernel without dQ on checked inputs (:func:`ring_dq` gives
    dq); adds into (dk, dv) in place, and its tile counts into ``tile_counts``."""
    from automodel_tpu_torch.kernels.build import launch

    bn, sq, d = q.shape
    has_window, win = _window(window)
    launch(_SOURCE, "ring_dkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           pos_q.data_ptr(), pos_kv.data_ptr(), _ptr(seg_q), _ptr(seg_kv), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bn // n_heads, sq,
           k.shape[1], n_heads, n_heads // groups, d, v.shape[-1], float(scale), int(causal),
           has_window, win, _counts(tile_counts, q))
    _count("ring_dkv", q, v)
    return dk, dv


def ring_dq(q, k, v, pos_q, pos_kv, seg_q, seg_kv, do, lse, delta, dq, *, scale, causal, window,
            groups, n_heads):
    """Launch the q-stationary dQ kernel on checked inputs; adds this chunk's dq partial
    into ``dq`` (f32) in place, summed in the same order on every run."""
    from automodel_tpu_torch.kernels.build import launch

    bn, sq, d = q.shape
    has_window, win = _window(window)
    launch(_SOURCE, "ring_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           pos_q.data_ptr(), pos_kv.data_ptr(), _ptr(seg_q), _ptr(seg_kv), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bn // n_heads, sq, k.shape[1],
           n_heads, n_heads // groups, d, v.shape[-1], float(scale), int(causal), has_window,
           win)
    _count("ring_dq", q, v)
    return dq


def chunk_attention_fwd(q, k, v, pos_q, pos_kv, seg_q, seg_kv, acc, m, l, *, scale, causal,
                        window, groups, n_heads):
    """One ring step: merge attention against a visiting kv chunk into (acc, m, l), in
    place; returns them. CUDA tensors launch ``ring_fwd`` or raise."""
    kw = dict(scale=scale, causal=causal, window=window, groups=groups, n_heads=n_heads)
    if q.device.type == "cpu":
        out = chunk_attention_fwd_reference(q, k, v, pos_q, pos_kv, seg_q, seg_kv, acc, m, l,
                                            **kw)
        for dst, src in zip((acc, m, l), out):
            dst.copy_(src)
        return acc, m, l
    _check_cuda(q, k, v, pos_q, pos_kv, seg_q, seg_kv, {"acc": acc, "m": m, "l": l},
                groups, n_heads)
    return ring_fwd(q, k, v, pos_q, pos_kv, seg_q, seg_kv, acc, m, l, **kw)


def chunk_attention_bwd(q, k, v, pos_q, pos_kv, seg_q, seg_kv, do, lse, delta, dq, dk, dv, *,
                        scale, causal, window, groups, n_heads):
    """One backward ring step: add the dq partial and the chunk's dk / dv into (dq, dk,
    dv), in place; returns them. CUDA tensors launch ``ring_bwd`` (or, with the
    deterministic-algorithms flag or at Dv != D, ``ring_dq`` and ``ring_dkv``) or
    raise."""
    kw = dict(scale=scale, causal=causal, window=window, groups=groups, n_heads=n_heads)
    split = torch.are_deterministic_algorithms_enabled() or v.shape[-1] != q.shape[-1]
    if q.device.type == "cpu":
        args = (q, k, v, pos_q, pos_kv, seg_q, seg_kv, do, lse, delta)
        out = ((chunk_attention_dq_reference(*args, **kw),
                *chunk_attention_dkv_reference(*args, **kw)) if split
               else chunk_attention_bwd_reference(*args, **kw))
        for dst, src in zip((dq, dk, dv), out):
            dst.add_(src)
        return dq, dk, dv
    if (do.dtype != q.dtype or not do.is_contiguous()
            or do.shape != (*q.shape[:2], v.shape[-1])):
        raise ValueError("ring chunk kernels: do must be contiguous, (B*H, Sq, Dv) in q's "
                         "dtype")
    _check_cuda(q, k, v, pos_q, pos_kv, seg_q, seg_kv,
                {"lse": lse, "delta": delta, "dq": dq, "dk": dk, "dv": dv}, groups, n_heads)
    if not split:
        return ring_bwd(q, k, v, pos_q, pos_kv, seg_q, seg_kv, do, lse, delta, dq, dk, dv, **kw)
    ring_dq(q, k, v, pos_q, pos_kv, seg_q, seg_kv, do, lse, delta, dq, **kw)
    ring_dkv(q, k, v, pos_q, pos_kv, seg_q, seg_kv, do, lse, delta, dk, dv, **kw)
    return dq, dk, dv
