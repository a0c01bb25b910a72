"""The port's grouped GEMM against the JAX package's: the plain version (what a CPU
tensor runs, and what the CUDA kernels are checked against on the card) against the
Pallas kernel in interpret mode and against ``jax.lax.ragged_dot``, forward, dX and
dW, over tests/unit/test_grouped_gemm.py's groupings. Inputs from numpy seeds.
Tolerances: f32 1e-5; bf16 relative L2 1e-2 against the f32 product of the same
bf16-rounded inputs, as the JAX test bounds its kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops.pallas.grouped_gemm import grouped_matmul as jax_gmm
from automodel_tpu_torch.ops import grouped_gemm as tgg
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

GROUPINGS = {
    "balanced": (8, 8, 8, 8),
    "ragged": (3, 13, 1, 15),
    "empty_head": (0, 0, 17, 15),
    "empty_mid_tail": (11, 0, 21, 0),
    "one_big": (0, 32, 0, 0),
    "ragged_tail": (5, 9, 7, 9),  # N=30, not a multiple of the JAX row block
    "singletons": (1,) * 8,
}


def _case(sizes, d=16, f=24, seed=0):
    rng = np.random.RandomState(seed)
    n = int(sum(sizes))
    x = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(len(sizes), d, f) / np.sqrt(d)).astype(np.float32)
    dout = rng.randn(n, f).astype(np.float32)
    return x, w, np.asarray(sizes, np.int32), dout


def _torch_fwd_grads(x, w, gs, dout, dtype=torch.float32):
    xt = torch.tensor(x).to(dtype).requires_grad_()
    wt = torch.tensor(w).to(dtype).requires_grad_()
    out = tgg.grouped_matmul(xt, wt, torch.tensor(gs))
    dx, dw = torch.autograd.grad(out, (xt, wt), torch.tensor(dout).to(dtype))
    return [t.detach().float().numpy() for t in (out, dx, dw)]


def _jax_fwd_grads(fn, x, w, dout):
    out, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(dout))
    return [np.asarray(t, np.float32) for t in (out, dx, dw)]


@pytest.mark.parametrize("name", sorted(GROUPINGS))
def test_plain_version_matches_pallas_and_ragged_dot_f32(name):
    x, w, gs, dout = _case(GROUPINGS[name])
    got = _torch_fwd_grads(x, w, gs, dout)
    jgs = jnp.asarray(gs)
    for fn in (lambda a, b: jax_gmm(a, b, jgs, interpret=True),
               lambda a, b: jax.lax.ragged_dot(a, b, jgs)):
        for g, want in zip(got, _jax_fwd_grads(fn, x, w, dout)):
            np.testing.assert_allclose(g, want, atol=1e-5, rtol=1e-5)
    for e, size in enumerate(gs):  # an empty expert's dW is exactly zero
        if size == 0:
            assert np.all(got[2][e] == 0)


@pytest.mark.parametrize("name", sorted(GROUPINGS))
def test_plain_version_bf16_within_tolerance(name):
    x, w, gs, dout = _case(GROUPINGS[name], seed=1)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # noqa: E731
    xb, wb, db = bf(x), bf(w), bf(dout)
    got = _torch_fwd_grads(xb, wb, gs, db, dtype=torch.bfloat16)
    jgs = jnp.asarray(gs)
    want = _jax_fwd_grads(lambda a, b: jax.lax.ragged_dot(a, b, jgs), xb, wb, db)
    pallas = _jax_fwd_grads(
        lambda a, b: jax_gmm(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16), jgs,
                             interpret=True).astype(jnp.float32), xb, wb, db)
    for g, p, r in zip(got, pallas, want):
        for arr in (g, p):
            assert np.linalg.norm(arr - r) <= 1e-2 * max(np.linalg.norm(r), 1e-30)


def test_rows_past_the_groups_are_zero():
    """Rows no group owns (sum(group_sizes) < N) come out zero, as ragged_dot's do."""
    x, w, gs, _ = _case((3, 0, 4))
    x = np.concatenate([x, np.ones((5, x.shape[1]), np.float32)])
    got = tgg.grouped_matmul(torch.tensor(x), torch.tensor(w), torch.tensor(gs)).numpy()
    want = np.asarray(jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.all(got[7:] == 0)


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU goes to the kernels or raises: never to the plain version."""
    x = torch.empty(32, 16, dtype=torch.bfloat16, device="meta")
    w = torch.empty(4, 16, 24, dtype=torch.bfloat16, device="meta")
    gs = torch.empty(4, dtype=torch.int32, device="meta")
    before = dict(tgg.LAUNCHES)
    with pytest.raises(ValueError, match="meta"):
        tgg.grouped_matmul(x, w, gs)
    assert tgg.LAUNCHES == before


# ------------------------------------------------------------ routes

def _recorder(monkeypatch):
    """Record the C entry points the wrappers launch (name, arguments) instead of
    launching them, and fail on any call of the plain version."""
    from automodel_tpu_torch.kernels import build

    calls = []
    monkeypatch.setattr(build, "launch", lambda source, name, device, *args:
                        calls.append((name, args)))

    def no_plain(*a, **k):
        raise AssertionError("the kernels' route fell back to the plain version")

    monkeypatch.setattr(tgg, "grouped_matmul_reference", no_plain)
    return calls


@pytest.mark.parametrize("d,f,route", [(16, 24, "wgmma"), (16, 1003, "mma_sync"),
                                       (1003, 24, "mma_sync"), (1000, 1000, "wgmma")])
def test_gmm_route_is_picked_from_the_shapes(monkeypatch, d, f, route):
    """K and Nout multiples of 8 (16-byte rows for TMA) take the wgmma route for the
    forward and dX, other strides the mma.sync route; both routes take the same
    arguments (x, w, the groups' ends, out, N, K, Nout, E, transpose), and the autograd
    function launches tgmm for dW on its own route. Nothing reaches the plain version."""
    calls = _recorder(monkeypatch)
    gs = torch.tensor([5, 0, 11], dtype=torch.int32)
    x = torch.zeros(16, d, dtype=torch.bfloat16, requires_grad=True)
    w = torch.zeros(3, d, f, dtype=torch.bfloat16, requires_grad=True)
    before = dict(tgg.ROUTE_LAUNCHES)
    assert tgg.gmm_route(x, w) == tgg.gmm_route(torch.zeros(16, f), w, True) == route
    out = tgg._GroupedMatmul.apply(x, w, gs)
    out.backward(torch.zeros(16, f, dtype=torch.bfloat16))
    entry = "gmm_wgmma" if route == "wgmma" else "gmm"
    tgmm_entry = "tgmm_wgmma" if route == "wgmma" else "tgmm"  # D and F as K and Nout
    assert [name for name, _ in calls] == [entry, entry, tgmm_entry]
    fwd, dx = calls[0][1], calls[1][1]
    assert fwd[-1] == 0 and dx[-1] == 1  # w read as stored, then transposed
    assert fwd[4:8] == (16, d, f, 3) and dx[4:8] == (16, f, d, 3)
    assert tgg.ROUTE_LAUNCHES[f"gmm/{route}"] - before[f"gmm/{route}"] == 2


def test_a_misaligned_operand_takes_the_mma_sync_route():
    """A view that starts off a 16-byte boundary cannot be a TMA operand."""
    base = torch.zeros(16 * 16 + 1, dtype=torch.bfloat16)
    x = base[1:].view(16, 16)
    w = torch.zeros(2, 16, 24, dtype=torch.bfloat16)
    assert tgg.gmm_route(x, w) == "mma_sync"
    assert tgg.gmm_route(base[:256].view(16, 16), w) == "wgmma"


@pytest.mark.parametrize("d,f,route", [(16, 24, "wgmma"), (1000, 1000, "wgmma"),
                                       (16, 1003, "mma_sync"), (1003, 24, "mma_sync"),
                                       (1003, 1003, "mma_sync")])
def test_tgmm_route_is_picked_from_the_shapes(monkeypatch, d, f, route):
    """tgmm takes the wgmma route when D and F are multiples of 8 (16-byte rows of x
    and dout for TMA), else the mma.sync route; both entry points take (x, dout, the
    groups' ends, dw, N, D, F, E) in that order, the route is counted, and nothing
    reaches the plain version."""
    calls = _recorder(monkeypatch)
    gs = torch.tensor([5, 0, 11], dtype=torch.int32)
    x = torch.zeros(16, d, dtype=torch.bfloat16)
    dout = torch.zeros(16, f, dtype=torch.bfloat16)
    before = dict(tgg.ROUTE_LAUNCHES)
    assert tgg.tgmm_route(x, dout) == route
    dw = tgg.tgmm(x, dout, tgg._ends(gs), 3)
    assert dw.shape == (3, d, f) and dw.dtype == torch.bfloat16
    assert [name for name, _ in calls] == ["tgmm_wgmma" if route == "wgmma" else "tgmm"]
    args = calls[0][1]
    assert args[:4] == (x.data_ptr(), dout.data_ptr(), args[2], dw.data_ptr())
    assert args[4:] == (16, d, f, 3)
    taken = {k: tgg.ROUTE_LAUNCHES[k] - before[k] for k in before}
    assert taken == {k: int(k == f"tgmm/{route}") for k in before}


@pytest.mark.parametrize("which", ["x", "dout"])
def test_a_misaligned_tgmm_operand_takes_the_mma_sync_route(which):
    """tgmm's x or dout starting off a 16-byte boundary cannot be a TMA operand."""
    base = torch.zeros(16 * 24 + 1, dtype=torch.bfloat16)
    shapes = {"x": (16, 16), "dout": (16, 24)}
    ops = {k: torch.zeros(*v, dtype=torch.bfloat16) for k, v in shapes.items()}
    assert tgg.tgmm_route(ops["x"], ops["dout"]) == "wgmma"
    n = shapes[which][0] * shapes[which][1]
    ops[which] = base[1:n + 1].view(shapes[which])
    assert tgg.tgmm_route(ops["x"], ops["dout"]) == "mma_sync"
