"""Grouped (ragged) expert GEMM: hand-written CUDA kernels for the card, a plain version
for the CPU (counterpart of ``automodel_tpu/ops/pallas/grouped_gemm.py``).

``grouped_matmul(x, w, group_sizes)`` has ``jax.lax.ragged_dot`` semantics: rows of x
are sorted so that each group's rows are contiguous, group e owns the next
``group_sizes[e]`` rows and multiplies them by ``w[e]``. A CUDA tensor goes to the
kernels in ``csrc/grouped_gemm.cu`` through an autograd function whose residuals are
``(x, w, group_sizes)`` only, as the JAX custom VJP's: ``gmm`` for the forward and, with
w read as its transpose in place, for dX; ``tgmm`` for dW. A CPU tensor goes to
:func:`grouped_matmul_reference`, a per-group loop with f32 accumulation that also
serves as the kernels' check on the card.

``gmm`` and ``tgmm`` each have two routes, picked from the shapes before the launch
(:func:`gmm_route`, :func:`tgmm_route`): ``wgmma`` (the Hopper core, TMA-fed) when the
operands' row lengths (K and Nout; D and F) are multiples of 8 bf16 and the operands
start 16-byte aligned, as TMA requires, else ``mma_sync`` (any shape). Between them
the kernels take any N, D, F, so unlike the JAX wrapper nothing is rerouted to
another implementation: a shape or dtype they cannot take raises.
``group_sizes`` stays on the device: the wrapper derives its prefix sum there and the
grids from the static shapes (each wgmma-route block finds its rows from the prefix
sum itself), so no launch waits for the host.
"""

from __future__ import annotations

import torch

__all__ = ["LAUNCHES", "ROUTE_LAUNCHES", "gmm", "gmm_route", "grouped_matmul",
           "grouped_matmul_reference", "tgmm", "tgmm_route"]

# one count per kernel launch, so a run can show that it went through the kernels
LAUNCHES = {"gmm": 0, "tgmm": 0}
# launches by route (each kernel's sum is its LAUNCHES count)
ROUTE_LAUNCHES = {"gmm/wgmma": 0, "gmm/mma_sync": 0, "tgmm/wgmma": 0, "tgmm/mma_sync": 0}
_SOURCE = "grouped_gemm.cu"


def grouped_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                             group_sizes: torch.Tensor) -> torch.Tensor:
    """The kernels' plain version: ``out[rows of e] = x[rows of e] @ w[e]`` with f32
    accumulation, out in x's dtype; rows past ``sum(group_sizes)`` are zero.
    Differentiable in x and w through autograd (dX and dW in f32, then rounded to the
    inputs' dtypes)."""
    out = x.new_zeros((x.shape[0], w.shape[2]))
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + size, x.shape[0])
        if end > start:
            out[start:end] = (x[start:end].float() @ w[e].float()).to(x.dtype)
        start = end
    return out


def _check(x, w, group_sizes):
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"grouped_matmul: {name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"grouped_matmul kernels take bf16, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_matmul: {name} must be contiguous")
    if x.ndim != 2 or w.ndim != 3 or w.shape[1] != x.shape[1] or 0 in (*x.shape, *w.shape):
        raise ValueError(f"grouped_matmul: bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if group_sizes.shape != (w.shape[0],) or group_sizes.device != x.device:
        raise ValueError(f"grouped_matmul: group_sizes must be ({w.shape[0]},) on {x.device}")


def _ends(group_sizes: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of the group sizes, int32 on the device (no host sync)."""
    return torch.cumsum(group_sizes, 0, dtype=torch.int32)


def _route(a: torch.Tensor, b: torch.Tensor, *row_lengths: int) -> str:
    """``"wgmma"`` when TMA can map both operands (every row length a multiple of 8
    bf16, both starting 16-byte aligned), else ``"mma_sync"``."""
    from automodel_tpu_torch.kernels.build import aligned16

    return "wgmma" if all(n % 8 == 0 for n in row_lengths) and aligned16(a, b) else "mma_sync"


def gmm_route(x: torch.Tensor, w: torch.Tensor, transpose_w: bool = False) -> str:
    """gmm's route, decided before the launch: ``"wgmma"`` when K and Nout are
    multiples of 8 and x and w start 16-byte aligned, else ``"mma_sync"``."""
    return _route(x, w, x.shape[1], w.shape[1] if transpose_w else w.shape[2])


def tgmm_route(x: torch.Tensor, dout: torch.Tensor) -> str:
    """tgmm's route, decided before the launch: ``"wgmma"`` when D and F are multiples
    of 8 and x and dout start 16-byte aligned, else ``"mma_sync"``."""
    return _route(x, dout, x.shape[1], dout.shape[1])


def gmm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor, transpose_w: bool = False):
    """Launch ``gmm`` on checked inputs: ``x @ w[e]`` per group, or with
    ``transpose_w`` ``x @ w[e]^T`` (w (E, D, F) read in place; x (N, F) -> (N, D)), on
    the route :func:`gmm_route` picks."""
    from automodel_tpu_torch.kernels.build import launch

    n, k = x.shape
    n_out = w.shape[1] if transpose_w else w.shape[2]
    out = torch.empty((n, n_out), dtype=x.dtype, device=x.device)
    route = gmm_route(x, w, transpose_w)
    launch(_SOURCE, "gmm_wgmma" if route == "wgmma" else "gmm", x.device, x.data_ptr(),
           w.data_ptr(), ends.data_ptr(), out.data_ptr(), n, k, n_out, w.shape[0],
           int(transpose_w))
    LAUNCHES["gmm"] += 1
    ROUTE_LAUNCHES[f"gmm/{route}"] += 1
    return out


def tgmm(x: torch.Tensor, dout: torch.Tensor, ends: torch.Tensor, num_groups: int):
    """Launch ``tgmm`` on checked inputs: (E, D, F) with ``dw[e] = x_e^T @ dout_e``, on
    the route :func:`tgmm_route` picks."""
    from automodel_tpu_torch.kernels.build import launch

    n, d = x.shape
    f = dout.shape[1]
    dw = torch.empty((num_groups, d, f), dtype=x.dtype, device=x.device)
    route = tgmm_route(x, dout)
    launch(_SOURCE, "tgmm_wgmma" if route == "wgmma" else "tgmm", x.device, x.data_ptr(),
           dout.data_ptr(), ends.data_ptr(), dw.data_ptr(), n, d, f, num_groups)
    LAUNCHES["tgmm"] += 1
    ROUTE_LAUNCHES[f"tgmm/{route}"] += 1
    return dw


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return gmm(x, w, _ends(group_sizes))

    @staticmethod
    def backward(ctx, dout):
        x, w, group_sizes = ctx.saved_tensors
        dout = dout.contiguous()
        ends = _ends(group_sizes)
        dx = gmm(dout, w, ends, transpose_w=True) if ctx.needs_input_grad[0] else None
        dw = tgmm(x, dout, ends, w.shape[0]) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """``ragged_dot(x (N, D), w (E, D, F), group_sizes (E,))`` -> (N, F) in x's dtype.

    Contract: ``sum(group_sizes) == N`` (the MoE layer counts every routed row). A CPU
    tensor runs the plain version; a CUDA tensor the kernels, or raises."""
    if x.device.type == "cpu":
        return grouped_matmul_reference(x, w, group_sizes)
    _check(x, w, group_sizes)
    return _GroupedMatmul.apply(x, w, group_sizes.to(torch.int32))
