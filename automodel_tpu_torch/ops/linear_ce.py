"""Fused linear cross-entropy: hand-written CUDA kernels for the card, a plain version
for the CPU (counterpart of ``automodel_tpu/ops/pallas/linear_ce.py``).

The loss splits as ``z - gold`` with ``z = logsumexp(h @ w)`` per token and
``gold = (h @ w)[label]``. ``gold`` is a gather-dot in plain torch (:func:`gold_logits`,
as the JAX package leaves it to XLA); ``z`` and its gradient come from the kernels in
``csrc/linear_ce.cu`` (``lce_fwd``, ``lce_bwd``), so the (tokens, vocab) logits never
exist whole in device memory.

Backward block filter (cut-cross-entropy's): a (128-token, 128-vocab) block whose
largest logit is more than ``-log(filter_eps)`` below every row's logsumexp carries no
gradient and is skipped. The test runs in torch between the kernels
(:func:`block_significance`, the counterpart of ``_block_significance``), from the
forward's per-(vocab tile, row) maxima. ``filter_eps=None`` gives exact gradients.

``lce_fwd`` and ``lce_bwd`` each have two routes, picked from the shapes before the
launch (:func:`lce_fwd_route`, :func:`lce_bwd_route`, the same rule): ``wgmma`` (their
products on the Hopper core, TMA-fed) when E and V are multiples of 8 bf16 and h and
w start 16-byte aligned, as TMA requires, else ``mma_sync`` (any E and V, e.g.
GPT-2's vocabulary of 50,257).

A frozen unembedding (no gradient asked for w, as under LoRA) takes ``lce_bwd`` with
dH alone (``need_dw=False``: the C entry points get a null dw and launch no dW
product), as JAX's jit drops the ``_bwd_dw_kernel`` call whose output nothing reads;
its dH is bitwise the full call's. ``ROUTE_LAUNCHES["lce_bwd/dh_only"]`` counts those
launches beside the route counts.

A CUDA tensor goes to the kernels or raises; a CPU tensor goes to
:func:`fused_logsumexp_reference`, in f32, which applies the same filter at a tile
given by the caller (the kernels' 128 x 128 by default; the JAX package's tiles in the
tests). The kernels read w (E, V) as it lies: row-major, or the transpose of a
row-major (V, E) tensor (a tied embedding), without a copy (:func:`kernel_operand`).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

__all__ = ["LAUNCHES", "ROUTE_LAUNCHES", "TILE_N", "TILE_V", "block_maxima",
           "block_significance", "fused_logsumexp", "fused_logsumexp_reference", "gold_logits",
           "kernel_operand", "kernel_supported", "lce_bwd", "lce_bwd_route", "lce_chunk",
           "lce_fwd", "lce_fwd_route"]

NEG_INF = -1e30
TILE_N = 128  # token tile of the kernels and of the filter
TILE_V = 128  # vocab tile of the kernels, of bmax and of the filter
# one count per kernel launch, so a run can show that it went through the kernels
LAUNCHES = {"lce_fwd": 0, "lce_bwd": 0}
# launches by route (each kernel's sum is its LAUNCHES count), and the lce_bwd launches
# that computed dH alone
ROUTE_LAUNCHES = {"lce_fwd/wgmma": 0, "lce_fwd/mma_sync": 0,
                  "lce_bwd/wgmma": 0, "lce_bwd/mma_sync": 0, "lce_bwd/dh_only": 0}
_SOURCE = "linear_ce.cu"
_CHUNK_BYTES = 256 * 2**20  # budget of the backward's (tokens, vocab chunk) bf16 buffer


def kernel_supported(e: int, v: int) -> bool:
    """True when the kernels take an (e, v) unembedding: any e, v >= 1 (the embed and
    vocab edges are masked in the kernels). Counterpart of
    ``pallas_linear_ce_supported``; tokens are padded by the caller."""
    return e >= 1 and v >= 1


def kernel_operand(w: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """The (E, V) unembedding as the kernels read it: ``(w, False)`` when w is
    row-major, ``(w.t(), True)`` when w is the transpose of a row-major (V, E) tensor
    (a tied embedding). Raises on any other layout rather than copying."""
    if w.is_contiguous():
        return w, False
    if w.t().is_contiguous():
        return w.t(), True
    raise ValueError(f"linear_ce kernels: w {tuple(w.shape)} with strides {w.stride()} is "
                     "neither row-major (E, V) nor the transpose of a row-major (V, E)")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def block_maxima(logits: torch.Tensor, block_v: int) -> torch.Tensor:
    """(num_v, N) per-(vocab block, row) maxima of (N, V) logits; a ragged last block
    takes the max of its real columns."""
    n, v = logits.shape
    pad = (-v) % block_v
    if pad:
        logits = F.pad(logits, (0, pad), value=NEG_INF)
    return logits.reshape(n, -1, block_v).amax(-1).t()


def block_significance(bmax: torch.Tensor, z: torch.Tensor, block_n: int,
                       log_eps: float) -> torch.Tensor:
    """(num_t, num_v) bool: which (token block, vocab block) carry gradient.

    A block matters when some row's block-max logit is within ``log_eps`` of its
    logsumexp; otherwise its whole softmax tile is below ``filter_eps``. ``bmax`` is
    (num_v, N); a ragged last token block counts its real rows only."""
    num_v, n = bmax.shape
    sig = (bmax - z[None, :]) > log_eps
    pad = (-n) % block_n
    if pad:
        sig = F.pad(sig, (0, pad), value=False)
    return sig.reshape(num_v, -1, block_n).any(-1).t()


class _FilteredLogsumexp(torch.autograd.Function):
    """f32 logsumexp whose backward drops the blocks the filter marks insignificant."""

    @staticmethod
    def forward(ctx, h, w, log_eps, block_n, block_v):
        s = h.float() @ w.float()
        z = torch.logsumexp(s, dim=-1)
        ctx.save_for_backward(h, w, z)
        ctx.cfg = (log_eps, block_n, block_v)
        return z

    @staticmethod
    def backward(ctx, dz):
        h, w, z = ctx.saved_tensors
        log_eps, block_n, block_v = ctx.cfg
        s = h.float() @ w.float()
        sig = block_significance(block_maxima(s, block_v), z, block_n, log_eps)
        keep = sig.repeat_interleave(block_n, 0)[: s.shape[0]]
        keep = keep.repeat_interleave(block_v, 1)[:, : s.shape[1]]
        p = torch.exp(s - z[:, None]) * dz.float()[:, None] * keep
        dh = (p @ w.float().t()).to(h.dtype)
        dw = (h.float().t() @ p).to(w.dtype)
        return dh, dw, None, None, None


def fused_logsumexp_reference(h: torch.Tensor, w: torch.Tensor, filter_eps: float | None = None,
                              block_n: int = TILE_N, block_v: int = TILE_V) -> torch.Tensor:
    """The kernels' plain version: ``logsumexp(h @ w)`` per token in f32.

    Differentiable in h and w. With ``filter_eps`` the gradient skips the
    (block_n, block_v) blocks that :func:`block_significance` marks insignificant."""
    if filter_eps is None:
        return torch.logsumexp(h.float() @ w.float(), dim=-1)
    return _FilteredLogsumexp.apply(h, w, math.log(filter_eps), block_n, block_v)


def gold_logits(h: torch.Tensor, w: torch.Tensor, local_labels: torch.Tensor) -> torch.Tensor:
    """The logit at the (localized) label column, a gather-dot in f32; labels outside
    [0, V) (ignored or in another vocab shard) give 0. Autograd's dW is a scatter-add:
    indexing's (``index_put_`` with accumulate, which sorts the indices on CUDA, so it
    sums in the same order on every run) rather than ``index_select``'s (``index_add_``,
    whose CUDA atomics land in no fixed order unless the deterministic-algorithms flag
    is set)."""
    v = w.shape[1]
    in_shard = (local_labels >= 0) & (local_labels < v)
    safe = local_labels.clamp(0, v - 1).long()
    cols = w[:, safe]  # (E, N)
    g = (h.float() * cols.t().float()).sum(-1)
    return torch.where(in_shard, g, torch.zeros_like(g))


def _check_cuda(h, w):
    """Raise unless the kernels take (h, w); returns w's storage and layout flag."""
    for name, t in (("h", h), ("w", w)):
        if t.device.type != "cuda":
            raise ValueError(f"linear_ce kernels: {name} is on {t.device}, not a CUDA device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"linear_ce kernels take bf16, {name} is {t.dtype}")
    if h.ndim != 2 or w.ndim != 2 or h.shape[1] != w.shape[0] or w.device != h.device:
        raise ValueError(f"linear_ce kernels: bad shapes h {tuple(h.shape)} w {tuple(w.shape)}")
    if not kernel_supported(*w.shape):
        raise NotImplementedError(f"linear_ce kernels: empty unembedding {tuple(w.shape)}")
    if h.shape[0] % TILE_N:
        raise ValueError(f"linear_ce kernels: tokens {h.shape[0]} not padded to {TILE_N}")
    if not h.is_contiguous():
        raise ValueError("linear_ce kernels: h must be contiguous")
    return kernel_operand(w)


def lce_fwd(h: torch.Tensor, w: torch.Tensor,
            vmajor: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward on checked inputs: ``(z (N,), bmax (ceil(V/128), N))``, f32,
    on the route :func:`lce_fwd_route` picks. ``w`` is the (E, V) unembedding, or with
    ``vmajor`` its row-major (V, E) storage."""
    from automodel_tpu_torch.kernels.build import launch

    n, e = h.shape
    v = w.shape[0] if vmajor else w.shape[1]
    num_t, num_vt = n // TILE_N, -(-v // TILE_V)
    route = lce_fwd_route(h, w, vmajor)
    if route == "wgmma":  # one partial (m, l) a 256-column tile of the core
        splits = -(-v // (2 * TILE_V))
    else:  # split the vocab so that the grid gives about two blocks per SM
        splits = min(num_vt, max(1, -(-2 * _sm_count(h.device) // num_t)))
    z = torch.empty(n, dtype=torch.float32, device=h.device)
    bmax = torch.empty((num_vt, n), dtype=torch.float32, device=h.device)
    part = torch.empty((2, splits, n), dtype=torch.float32, device=h.device)
    launch(_SOURCE, "lce_fwd_wgmma" if route == "wgmma" else "lce_fwd", h.device, h.data_ptr(),
           w.data_ptr(), z.data_ptr(), bmax.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
           n, e, v, int(vmajor), splits)
    LAUNCHES["lce_fwd"] += 1
    ROUTE_LAUNCHES[f"lce_fwd/{route}"] += 1
    return z, bmax


def lce_bwd_route(h: torch.Tensor, w: torch.Tensor, vmajor: bool = False) -> str:
    """``"wgmma"`` when TMA can map h and w (E and V multiples of 8 bf16, both starting
    16-byte aligned), else ``"mma_sync"``; decided before the launch. ``w`` as for
    :func:`lce_fwd`."""
    from automodel_tpu_torch.kernels.build import aligned16

    e = h.shape[1]
    v = w.shape[0] if vmajor else w.shape[1]
    return "wgmma" if e % 8 == 0 and v % 8 == 0 and aligned16(h, w) else "mma_sync"


lce_fwd_route = lce_bwd_route  # both kernels' wgmma routes read h and w through TMA


def lce_chunk(n: int, v: int) -> int:
    """Vocab columns of the backward's (n, chunk) bf16 buffer: a multiple of the tile
    within ``_CHUNK_BYTES``, at least one tile and at most the padded vocabulary."""
    return max(TILE_V, min(-(-v // TILE_V) * TILE_V, _CHUNK_BYTES // (2 * n) // TILE_V * TILE_V))


def lce_bwd(h, w, z, dz, sig, vmajor: bool = False,
            need_dw: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch the backward on checked inputs: ``(dh, dw)`` in bf16, dw in w's layout
    (see :func:`lce_fwd`), on the route :func:`lce_bwd_route` picks. ``sig`` is the
    (N/128, ceil(V/128)) int32 filter mask, or None for exact gradients. ``need_dw``
    False: dH alone (dw is None), counted under ``lce_bwd/dh_only``."""
    from automodel_tpu_torch.kernels.build import launch

    n, e = h.shape
    v = w.shape[0] if vmajor else w.shape[1]
    chunk = lce_chunk(n, v)
    dh = torch.empty_like(h)
    dw = torch.empty_like(w) if need_dw else None
    dl = torch.empty((n, chunk), dtype=torch.bfloat16, device=h.device)
    dh32 = torch.empty((n, e), dtype=torch.float32, device=h.device) if v > chunk else None
    z, dz = z.contiguous(), dz.float().contiguous()
    if sig is not None:
        sig = sig.to(torch.int32).contiguous()
    route = lce_bwd_route(h, w, vmajor)
    launch(_SOURCE, "lce_bwd_wgmma" if route == "wgmma" else "lce_bwd", h.device, h.data_ptr(),
           w.data_ptr(), z.data_ptr(), dz.data_ptr(), None if sig is None else sig.data_ptr(),
           dh.data_ptr(), None if dw is None else dw.data_ptr(), dl.data_ptr(),
           None if dh32 is None else dh32.data_ptr(), n, e, v, int(vmajor), chunk)
    LAUNCHES["lce_bwd"] += 1
    ROUTE_LAUNCHES[f"lce_bwd/{route}"] += 1
    if not need_dw:
        ROUTE_LAUNCHES["lce_bwd/dh_only"] += 1
    return dh, dw


class _FusedLogsumexp(torch.autograd.Function):
    """z from the kernels; w is the operand as stored ((E, V), or (V, E) with vmajor)
    and its gradient comes back in the same layout, or not at all when w needs none."""

    @staticmethod
    def forward(ctx, h, w, vmajor, log_eps):
        z, bmax = lce_fwd(h, w, vmajor)
        ctx.save_for_backward(h, w, z, bmax)
        ctx.cfg = (vmajor, log_eps)
        return z

    @staticmethod
    def backward(ctx, dz):
        h, w, z, bmax = ctx.saved_tensors
        vmajor, log_eps = ctx.cfg
        sig = None
        if log_eps is not None:
            sig = block_significance(bmax, z, TILE_N, log_eps)
        dh, dw = lce_bwd(h, w, z, dz, sig, vmajor, need_dw=ctx.needs_input_grad[1])
        return dh, dw, None, None


def fused_logsumexp(h: torch.Tensor, w: torch.Tensor,
                    filter_eps: float | None = 1e-7) -> torch.Tensor:
    """Per-token ``logsumexp(h @ w)`` (N,) f32 without the logits in device memory.

    h (N, E), w (E, V). On the CPU the plain version (filter at the kernels' tile);
    otherwise the kernels, which take bf16, N % 128 == 0, ``kernel_supported(E, V)``
    and a w that :func:`kernel_operand` accepts, and raise on anything else."""
    if h.device.type == "cpu":
        return fused_logsumexp_reference(h, w, filter_eps)
    w_store, vmajor = _check_cuda(h, w)
    log_eps = None if filter_eps is None else math.log(filter_eps)
    return _FusedLogsumexp.apply(h, w_store, vmajor, log_eps)
