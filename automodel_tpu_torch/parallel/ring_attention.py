"""Ring attention over the ``cp`` axis: long-context context parallelism (counterpart of
``automodel_tpu/parallel/ring_attention.py``).

q / k / v arrive sequence-sharded over ``cp``. k / v and their positions and segment
ids rotate around the ring while every shard accumulates online-softmax partials in
f32; ring step t gives shard r the kv of shard (r - t) mod cp, as JAX's ``ppermute``
j -> j + 1. Causality is enforced by global positions, which travel with the tokens,
so any layout of the sequence works, the round-robin interleave included.

The rotation is an object with one job: hand shard r the bundle of shard (r - 1) mod cp.

- :class:`FoldedRotation`, one card (``MeshContext.folded``): every cp shard lives on
  this card, stacked along the leading dim as (batch, cp) flattened (the JAX package's
  ``vmap`` over cp written out as a batch dimension). A rotation is one ``torch.roll``
  along the shard axis: a copy of the bundle on the card, no communication.
- :class:`ProcessGroupRotation`, one shard per process: ``batch_isend_irecv`` on the cp
  process group (NCCL on cards, gloo on the CPU).

Two per-step implementations:

- ``flash`` (the default): the chunk kernels (``ops/ring_chunk.py``) carry (acc, m, l)
  across ring steps, so no (S_local x S_local) score matrix is formed on the card. A
  ``torch.autograd.Function`` whose backward runs a second ring: delta once, dq
  accumulated in f32, dk / dv accumulated in f32 travelling with their chunk and home
  after cp rotations. On the CPU the chunk functions run their plain versions.
- ``dense``: plain torch partial attention (per-chunk scores), differentiated by
  autograd through the unrolled ring; the parity oracle, run only when asked for, and
  differentiable under the fold only (a process-group rotation has no autograd).

Where the port is more general: the kernels mask ragged edges, so ``flash`` takes
every local length (JAX's ``_pick_block`` sends lengths that do not tile to ``dense``).
JAX's ``kv_chunk`` sub-chunking bounds the TPU kernel's VMEM; the CUDA backward holds
dK / dV per key tile in registers, so the argument is accepted and ignored.
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.ops.ring_chunk import (NEG_INF, allowed_mask, chunk_attention_bwd,
                                                 chunk_attention_fwd)

__all__ = ["FoldedRotation", "ProcessGroupRotation", "make_ring_attention",
           "ring_attention_local", "ring_flash_backward", "ring_flash_forward"]


class FoldedRotation:
    """Rotation of the one-card fold: tensors carry all cp shards along their leading
    dim, laid out (batch, cp); shard r receives shard (r - 1) mod cp's slice."""

    def __init__(self, cp: int):
        self.cp = cp

    def __call__(self, tensors):
        if self.cp == 1:
            return list(tensors)
        return [None if x is None else x.unflatten(0, (-1, self.cp)).roll(1, 1).flatten(0, 1)
                for x in tensors]


class ProcessGroupRotation:
    """Rotation with one shard per process: send the bundle to cp rank r + 1, receive
    rank r - 1's (``torch.distributed.batch_isend_irecv`` on ``group``, default the
    world)."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.cp = dist.get_world_size(group)
        rank = dist.get_rank(group)
        peer = (lambda r: r) if group is None else (lambda r: dist.get_global_rank(group, r))
        self._next, self._prev = peer((rank + 1) % self.cp), peer((rank - 1) % self.cp)

    def __call__(self, tensors):
        if self.cp == 1:
            return list(tensors)
        dist = self._dist
        ops, out = [], []
        for x in tensors:
            if x is None:
                out.append(None)
                continue
            x = x.contiguous()
            y = torch.empty_like(x)
            ops += [dist.P2POp(dist.isend, x, self._next, self.group),
                    dist.P2POp(dist.irecv, y, self._prev, self.group)]
            out.append(y)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


def _partial_attention(q, k, v, allowed, scale):
    """Unnormalised attention of one chunk in f32: ``(acc, m, l)``.

    q (B, Sq, N, D), k (B, Sk, K, D), v (B, Sk, K, Dv); allowed (B, Sq, Sk) bool or None.
    acc (B, K, G, Sq, Dv), m / l (B, K, G, Sq).
    """
    b, sq, n, d = q.shape
    kh = k.shape[2]
    qf = q.float().reshape(b, sq, kh, n // kh, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    if allowed is not None:
        logits = logits.masked_fill(~allowed[:, None, None], NEG_INF)
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    if allowed is not None:
        # fully masked rows would otherwise contribute exp(0) = 1 per masked entry
        p = p.masked_fill(~allowed[:, None, None], 0.0)
    acc = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    return acc, m, p.sum(-1)


def _dense_ring(q, k, v, pos_q, pos_kv, seg_q, seg_kv, rotation, causal, window, scale):
    b, sq, n, _ = q.shape
    kh, dv = k.shape[2], v.shape[-1]
    g = n // kh
    acc = torch.zeros((b, kh, g, sq, dv), dtype=torch.float32, device=q.device)
    m = torch.full((b, kh, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kh, g, sq), dtype=torch.float32, device=q.device)
    kv = (k, v, pos_kv, seg_kv)
    for step in range(rotation.cp):
        k_i, v_i, pkv_i, skv_i = kv
        allowed = allowed_mask(pos_q, pkv_i, seg_q, skv_i, causal, window)
        acc_i, m_i, l_i = _partial_attention(q, k_i, v_i, allowed, scale)
        m_new = torch.maximum(m, m_i)
        alpha, beta = torch.exp(m - m_new), torch.exp(m_i - m_new)
        acc = acc * alpha[..., None] + acc_i * beta[..., None]
        l = l * alpha + l_i * beta
        m = m_new
        if step < rotation.cp - 1:
            kv = rotation(kv)
    out = acc / torch.where(l == 0.0, torch.ones((), device=l.device), l)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, n, dv).to(q.dtype)


def ring_flash_forward(q, k, v, pq, pkv, sq, skv, rotation, kw, chunk_fwd=chunk_attention_fwd):
    """The flash ring's forward over row-form tensors: q (Bl*H, S, D), k (Bl*KH, S, D),
    v (Bl*KH, S, Dv), positions / segments (Bl, S), Bl the local batch (batch x cp when
    folded). Returns ``(out, lse)``: out (Bl*H, S, Dv) in q's dtype, lse (Bl*H, S) f32 with
    NEG_INF where no key was allowed. ``chunk_fwd`` is the step function (the kernel
    wrapper; a check may pass the plain version)."""
    bl, s = pq.shape
    bn, dv = q.shape[0], v.shape[-1]
    acc = torch.zeros((bn, s, dv), dtype=torch.float32, device=q.device)
    m = torch.full((bn, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bn, s), dtype=torch.float32, device=q.device)
    bundle = (k.view(bl, -1, *k.shape[1:]), v.view(bl, -1, *v.shape[1:]), pkv, skv)
    for step in range(rotation.cp):
        k_i, v_i, pkv_i, skv_i = bundle
        chunk_fwd(q, k_i.flatten(0, 1), v_i.flatten(0, 1), pq, pkv_i, sq, skv_i, acc, m, l,
                  **kw)
        if step < rotation.cp - 1:
            bundle = rotation(bundle)
    empty = l == 0.0
    safe = torch.where(empty, torch.ones((), device=l.device), l)
    out = (acc / safe[..., None]).to(q.dtype)
    lse = torch.where(empty, torch.full((), NEG_INF, device=l.device), m + torch.log(safe))
    return out, lse


def ring_flash_backward(q, k, v, pq, pkv, sq, skv, out, lse, do, rotation, kw,
                        chunk_bwd=chunk_attention_bwd):
    """The second ring: ``(dq, dk, dv)`` in the inputs' dtypes. delta = rowsum(out * dO)
    once; dq accumulates in f32; dk / dv accumulate in f32 and travel with their chunk,
    home after cp rotations."""
    bl = pq.shape[0]
    do = do.to(q.dtype).contiguous()
    delta = (out.float() * do.float()).sum(-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k4, v4 = k.view(bl, -1, *k.shape[1:]), v.view(bl, -1, *v.shape[1:])
    bundle = (k4, v4, pkv, skv, torch.zeros(k4.shape, dtype=torch.float32, device=k.device),
              torch.zeros(v4.shape, dtype=torch.float32, device=v.device))
    for step in range(rotation.cp):
        k_i, v_i, pkv_i, skv_i, dk_i, dv_i = bundle
        chunk_bwd(q, k_i.flatten(0, 1), v_i.flatten(0, 1), pq, pkv_i, sq, skv_i, do, lse, delta,
                  dq, dk_i.flatten(0, 1), dv_i.flatten(0, 1), **kw)
        if step < rotation.cp - 1:
            bundle = rotation(bundle)
        else:
            bundle = (None,) * 4 + tuple(rotation((dk_i, dv_i)))
    dk, dv = bundle[4], bundle[5]
    return dq.to(q.dtype), dk.flatten(0, 1).to(k.dtype), dv.flatten(0, 1).to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """:func:`ring_flash_forward` with :func:`ring_flash_backward` as its gradient; the
    compact lse is the residual that lives from the forward to the backward."""

    @staticmethod
    def forward(ctx, q, k, v, pq, pkv, sq, skv, rotation, kw):
        out, lse = ring_flash_forward(q, k, v, pq, pkv, sq, skv, rotation, kw)
        ctx.save_for_backward(q, k, v, pq, pkv, sq, skv, out, lse)
        ctx.rotation, ctx.kw = rotation, kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, pq, pkv, sq, skv, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_flash_backward(q, k, v, pq, pkv, sq, skv, out, lse, do, ctx.rotation,
                                         ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


def ring_attention_local(
    q: torch.Tensor,  # (Bl, Sq_local, N, D)
    k: torch.Tensor,  # (Bl, Skv_local, K, D)
    v: torch.Tensor,  # (Bl, Skv_local, K, Dv)
    positions_q: torch.Tensor,  # (Bl, Sq_local) global positions
    positions_kv: torch.Tensor,  # (Bl, Skv_local)
    segment_ids_q: torch.Tensor | None = None,
    segment_ids_kv: torch.Tensor | None = None,
    *,
    rotation,
    causal: bool = True,
    sliding_window: int | None = None,
    softmax_scale: float | None = None,
    impl: str | None = None,  # "flash" | "dense" | None = flash
    kv_chunk: int = 4096,  # accepted for JAX's signature; see the module docstring
) -> torch.Tensor:
    """The per-shard body: this process's local shards (or, folded, every shard stacked
    along the batch dim) and the rotation that moves kv bundles around the ring."""
    del kv_chunk
    if impl not in (None, "flash", "dense"):
        raise ValueError(f"unknown ring impl {impl!r} (flash | dense | None=auto)")
    bl, sq, n, d = q.shape
    kh, skv, dv = k.shape[2], k.shape[1], v.shape[-1]
    scale = softmax_scale if softmax_scale is not None else d**-0.5
    seg_q = seg_kv = None
    if segment_ids_q is not None or segment_ids_kv is not None:
        seg_q = segment_ids_q if segment_ids_q is not None else segment_ids_kv
        seg_kv = segment_ids_kv if segment_ids_kv is not None else segment_ids_q
    if impl == "dense":
        return _dense_ring(q, k, v, positions_q, positions_kv, seg_q, seg_kv, rotation, causal,
                           sliding_window, scale)

    def ids(x):
        return None if x is None else x.to(torch.int32).contiguous()

    # rows: (Bl, S, H, D) -> (Bl*H, S, D); kv heads stay un-repeated. At Bl = 1 the
    # reshape is a strided view, and the kernels take contiguous rows only
    qf = q.transpose(1, 2).reshape(bl * n, sq, d).contiguous()
    kf = k.transpose(1, 2).reshape(bl * kh, skv, d).contiguous()
    vf = v.transpose(1, 2).reshape(bl * kh, skv, dv).contiguous()
    kw = dict(scale=float(scale), causal=bool(causal), window=sliding_window,
              groups=n // kh, n_heads=n)
    o = _RingFlash.apply(qf, kf, vf, ids(positions_q), ids(positions_kv), ids(seg_q),
                         ids(seg_kv), rotation, kw)
    return o.view(bl, n, sq, dv).transpose(1, 2)


def make_ring_attention(mesh, *, cp_axis: str = "cp", causal: bool = True,
                        sliding_window: int | None = None, softmax_scale: float | None = None,
                        impl: str | None = None):
    """Ring attention over a mesh's cp axis on global tensors. Returns ``fn(q, k, v,
    positions, segment_ids=None) -> out``: q / k / v (B, S, H, D) and positions / segment
    ids (B, S) in, (B, S, H, Dv) out, the sequence split into cp contiguous shards as
    JAX's ``P(None, cp)``. It runs the one-card fold (``mesh.folded``) or, at cp 1, a
    ring of one; a ring across processes is :func:`ring_attention_local` with a
    :class:`ProcessGroupRotation`."""
    cp = mesh.shape[cp_axis]
    if cp > 1 and not mesh.folded:
        raise NotImplementedError(
            "make_ring_attention runs the one-card fold; across processes call "
            "ring_attention_local with ProcessGroupRotation on the local shards")
    rotation = FoldedRotation(cp)

    def fn(q, k, v, positions, segment_ids=None):
        b, s = q.shape[:2]
        if s % cp:
            raise ValueError(f"sequence length {s} must divide by cp={cp}")

        def shard(x):
            return None if x is None else x.reshape(b * cp, s // cp, *x.shape[2:])

        out = ring_attention_local(
            shard(q), shard(k), shard(v), shard(positions), shard(positions),
            shard(segment_ids), shard(segment_ids), rotation=rotation, causal=causal,
            sliding_window=sliding_window, softmax_scale=softmax_scale, impl=impl)
        return out.reshape(b, s, *out.shape[2:])

    return fn
