"""The port's fused linear CE (ops/linear_ce.py, ops/losses.py) against the JAX package
on the same numpy inputs, at the JAX suite's size (N, E, V = 48, 128, 512). The JAX side
runs its Pallas kernels with interpret=True. On the CPU the port runs the kernels' plain
version, so these hold the plain version and the routing around the CUDA kernels.

Tolerances (f32): z within 1e-5 and dH, dW within 1e-4 absolute (the same f32 sums in
another order); bf16 inputs within 2e-2, as the JAX suite's own bf16 case.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops import losses as jloss
from automodel_tpu.ops.pallas import linear_ce as jlce
from automodel_tpu_torch.ops import linear_ce as tlce, losses as tloss
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

N, E, V = 48, 128, 512
TOL_Z, TOL_GRAD = 1e-5, 1e-4


def _data(seed=0, n=N, e=E, v=V, ignore_frac=0.25):
    rng = np.random.RandomState(seed)
    h = (rng.randn(n, e) * 0.3).astype(np.float32)
    w = (rng.randn(e, v) * 0.1).astype(np.float32)
    labels = rng.randint(0, v, (n,)).astype(np.int32)
    labels[rng.rand(n) < ignore_frac] = -100
    dz = rng.randn(n).astype(np.float32)
    return h, w, labels, dz


def _t(x, grad=False):
    return torch.tensor(np.asarray(x)).requires_grad_(grad)


def _jax_tokens_grads(h, w, labels, dz, filter_eps, vocab_offset=0):
    def f(h_, w_):
        z, gold = jloss.fused_linear_ce_tokens(h_, w_, jnp.asarray(labels), interpret=True,
                                               filter_eps=filter_eps, vocab_offset=vocab_offset)
        return (z * dz).sum() + gold.sum(), (z, gold)

    (_, (z, gold)), (dh, dw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    return [np.asarray(x) for x in (z, gold, dh, dw)]


def _port_tokens_grads(h, w, labels, dz, filter_eps, vocab_offset=0):
    ht, wt = _t(h, True), _t(w, True)
    z, gold = tloss.fused_linear_ce_tokens(ht, wt, _t(labels), vocab_offset=vocab_offset,
                                           filter_eps=filter_eps)
    ((z * _t(dz)).sum() + gold.sum()).backward()
    return [x.detach().numpy() for x in (z, gold, ht.grad, wt.grad)]


@pytest.mark.parametrize("filter_eps", [None, 1e-7], ids=["exact", "filter"])
def test_tokens_z_gold_and_grads_f32(filter_eps):
    """z, gold, dH and dW of fused_linear_ce_tokens against JAX's Pallas path."""
    h, w, labels, dz = _data()
    want = _jax_tokens_grads(h, w, labels, dz, filter_eps)
    got = _port_tokens_grads(h, w, labels, dz, filter_eps)
    for name, g, j, tol in zip(("z", "gold", "dh", "dw"), got, want,
                               (TOL_Z, TOL_Z, TOL_GRAD, TOL_GRAD)):
        np.testing.assert_allclose(g, j, atol=tol, rtol=0, err_msg=name)


def test_bf16_inputs():
    h, w, labels, _ = _data(seed=4)
    hb, wb = jnp.asarray(h).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16)
    want = float(jloss.linear_cross_entropy(hb, wb, jnp.asarray(labels), 30, impl="pallas"))
    ht = _t(h).to(torch.bfloat16).requires_grad_()
    got = tloss.linear_cross_entropy(ht, _t(w).to(torch.bfloat16), _t(labels), 30, impl="pallas")
    assert got.item() == pytest.approx(want, abs=2e-2, rel=2e-2)
    got.backward()
    assert ht.grad.dtype == torch.bfloat16


def test_token_padding():
    """37 tokens, not a multiple of any tile: padded rows leak into nothing."""
    h, w, labels, _ = _data(seed=2)
    h, labels = h[:37], labels[:37]
    want = float(jloss.linear_cross_entropy(jnp.asarray(h), jnp.asarray(w),
                                            jnp.asarray(labels), 20, impl="pallas"))
    got = float(tloss.linear_cross_entropy(_t(h), _t(w), _t(labels), 20, impl="pallas"))
    assert got == pytest.approx(want, abs=TOL_Z)


def test_all_ignored_block():
    h, w, labels, _ = _data(seed=5)
    labels[:] = -100
    ht = _t(h, True)
    loss = tloss.linear_cross_entropy(ht, _t(w), _t(labels), 1, impl="pallas")
    assert float(loss) == 0.0
    loss.backward()
    assert float(ht.grad.abs().max()) == 0.0


def test_vocab_shard_combine():
    """Two vocab shards with vocab_offset: logsumexp of z and sum of gold give the
    global loss, and each shard's partials match JAX's."""
    h, w, labels, dz = _data(seed=3)
    half = V // 2
    parts = []
    for lo, hi in ((0, half), (half, V)):
        want = _jax_tokens_grads(h, w[:, lo:hi], labels, dz, None, vocab_offset=lo)
        got = _port_tokens_grads(h, w[:, lo:hi], labels, dz, None, vocab_offset=lo)
        for g, j in zip(got, want):
            np.testing.assert_allclose(g, j, atol=TOL_GRAD, rtol=0)
        parts.append(got[:2])
    z = np.logaddexp(parts[0][0], parts[1][0])
    gold = parts[0][1] + parts[1][1]
    valid = labels != -100
    got = np.where(valid, z - gold, 0.0).sum() / 25.0
    want = float(jloss.masked_cross_entropy(jnp.asarray(h) @ jnp.asarray(w),
                                            jnp.asarray(labels), 25))
    assert got == pytest.approx(want, abs=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas", "auto"])
def test_linear_cross_entropy_impls(impl):
    """Loss and gradients of each impl against JAX's same impl (JAX's auto on the CPU
    is its blockwise path, the port's the kernels' plain version: the same values)."""
    h, w, labels, _ = _data(seed=1)
    h3, l3 = h.reshape(2, 24, E), labels.reshape(2, 24)

    def jf(h_, w_):
        return jloss.linear_cross_entropy(h_, w_, jnp.asarray(l3), 30, block_size=16, impl=impl)

    want, (jdh, jdw) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(h3), jnp.asarray(w))
    ht, wt = _t(h3, True), _t(w, True)
    got = tloss.linear_cross_entropy(ht, wt, _t(l3), 30, block_size=16, impl=impl)
    got.backward()
    assert float(got) == pytest.approx(float(want), abs=TOL_Z)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jdh), atol=TOL_GRAD, rtol=0)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), atol=TOL_GRAD, rtol=0)


def test_any_embed_takes_the_kernel_route(monkeypatch):
    """embed % 128 != 0 (64): impl="pallas" and "auto" still take the kernels' route
    (here their plain version) and match JAX; only "xla" runs the blockwise path."""
    assert tlce.kernel_supported(64, 200) and not tlce.kernel_supported(0, 200)
    calls = []
    plain = tlce.fused_logsumexp_reference
    monkeypatch.setattr(tlce, "fused_logsumexp_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    rng = np.random.RandomState(6)
    h, w = rng.randn(16, 64).astype(np.float32), rng.randn(64, 200).astype(np.float32)
    labels = rng.randint(0, 200, (16,)).astype(np.int32)
    want = float(jloss.linear_cross_entropy(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
                                            16, impl="pallas"))
    for impl, routed in (("pallas", 1), ("auto", 1), ("xla", 0)):
        calls.clear()
        got = float(tloss.linear_cross_entropy(_t(h), _t(w), _t(labels), 16, impl=impl))
        assert got == pytest.approx(want, abs=1e-4) and len(calls) == routed, impl
    with pytest.raises(ValueError, match="impl"):
        tloss.linear_cross_entropy(_t(h), _t(w), _t(labels), impl="triton")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_unembed_reaches_the_kernels_in_place(tied, dtype):
    """resolve_unembed's output, tied (embed.t()) or untied (lm_head), is a layout the
    kernels read without a copy: the embedding's own (V, E) storage when tied, the
    row-major (E, V) lm_head otherwise. Any other layout raises."""
    from automodel_tpu_torch.models.common.transformer import resolve_unembed

    params = {"embed": torch.randn(V, E)}
    if not tied:
        params["lm_head"] = torch.randn(E, V)
    w = resolve_unembed(None, params, dtype)
    assert w.shape == (E, V)
    store, vmajor = tlce.kernel_operand(w)
    assert vmajor == tied and store.is_contiguous()
    assert store.shape == ((V, E) if tied else (E, V))
    if dtype == torch.float32:
        src = params["embed"] if tied else params["lm_head"]
        assert store.data_ptr() == src.data_ptr()
    with pytest.raises(ValueError, match="row-major"):
        tlce.kernel_operand(w[:, ::2])


@pytest.mark.parametrize("denom", [None, 40])
def test_chunked_cross_entropy(denom):
    rng = np.random.RandomState(8)
    logits = rng.randn(3, 7, 50).astype(np.float32)
    labels = rng.randint(0, 50, (3, 7)).astype(np.int32)
    labels[1, 2:] = -100
    want = float(jloss.chunked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), denom))
    lt = _t(logits, True)
    got = tloss.chunked_cross_entropy(lt, _t(labels), denom)
    assert float(got) == pytest.approx(want, abs=1e-5)
    got.backward()
    gj = jax.grad(lambda x: jloss.chunked_cross_entropy(x, jnp.asarray(labels), denom))(
        jnp.asarray(logits))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gj), atol=1e-6)


def _peaked(seed=9):
    """Inputs where vocab block 0 dominates for the first 16 rows only: a constant
    feature (column 0 of h) lifts block 0's logits by 30 on those rows, so blocks 1-3
    fall below filter_eps = 1e-7 in token block 0 and stay significant elsewhere."""
    h, w, labels, dz = _data(seed)
    h[:, 0] = 0.0
    h[:16, 0] = 1.0
    w[0, :] = 0.0
    w[0, :128] = 30.0
    return h, w, labels, dz


def test_block_significance_matches_jax():
    """At JAX's backward tiles for this shape (16 tokens, 128 vocab) the port's mask
    is _block_significance's, and it skips some blocks."""
    assert jlce.pick_bwd_blocks(E, V, 128, N) == (16, 128)
    h, w, _, _ = _peaked()
    logits = h @ w
    z = np.asarray(jax.nn.logsumexp(jnp.asarray(logits), axis=-1))
    bmax = logits.reshape(N, V // 128, 128).max(-1).T  # (num_v, N)
    log_eps = math.log(1e-7)
    want = np.asarray(jlce._block_significance(jnp.asarray(bmax[:, None, :]), jnp.asarray(z),
                                               N // 16, V // 128, 16, 1, log_eps))
    got = tlce.block_significance(tlce.block_maxima(_t(logits), 128), _t(z), 16, log_eps)
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)
    assert 0 < want.sum() < want.size


def test_filtered_grads_match_jax():
    """Filter on, at JAX's tiles: the plain version's gradients equal the Pallas
    kernels' (interpret mode), and differ from the exact ones where blocks were cut."""
    h, w, _, dz = _peaked()

    def jf(h_, w_):
        return (jlce.fused_logsumexp(h_, w_, 16, 128, True, 1e-7) * dz).sum()

    jdh, jdw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    grads = {}
    for eps in (1e-7, None):
        ht, wt = _t(h, True), _t(w, True)
        z = tlce.fused_logsumexp_reference(ht, wt, eps, block_n=16, block_v=128)
        (z * _t(dz)).sum().backward()
        grads[eps] = (ht.grad.numpy(), wt.grad.numpy())
    # dH's column 0 reaches ~30 (the lifted weights): f32 sums there differ by ~1e-4
    np.testing.assert_allclose(grads[1e-7][0], np.asarray(jdh), atol=TOL_GRAD, rtol=1e-5)
    np.testing.assert_allclose(grads[1e-7][1], np.asarray(jdw), atol=TOL_GRAD, rtol=1e-5)
    assert np.abs(grads[1e-7][1] - grads[None][1]).max() > 0


def test_gold_logits_matches_jax():
    h, w, labels, _ = _data(seed=10)
    want = np.asarray(jlce.gold_logits(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels - 100)))
    got = tlce.gold_logits(_t(h), _t(w), _t(labels).long() - 100).numpy()
    np.testing.assert_allclose(got, want, atol=TOL_Z)


def test_meta_tensors_reach_the_kernel_checks(monkeypatch):
    """A tensor off the CPU goes to the kernel wrapper, whose checks raise; it never
    reaches the plain version."""
    def no_plain(*a, **k):
        raise AssertionError("the plain version was called for a meta tensor")

    monkeypatch.setattr(tlce, "fused_logsumexp_reference", no_plain)
    h = torch.empty(256, 128, device="meta", dtype=torch.bfloat16)
    w = torch.empty(128, 1000, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tlce.fused_logsumexp(h, w)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tloss.linear_cross_entropy(h[:100], w, torch.zeros(100, dtype=torch.long, device="meta"))
    with pytest.raises(ValueError, match="not a CUDA device"):
        tloss.fused_linear_ce_tokens(h, w, torch.zeros(256, dtype=torch.long, device="meta"),
                                     filter_eps=None)


def test_reference_ragged_tiles():
    """The plain version's filter on tiles that divide neither N nor V keeps its exact
    gradient when nothing is cut (random inputs, eps tiny)."""
    h, w, _, dz = _data(seed=11, n=37, v=300)
    grads = []
    for eps in (1e-30, None):
        ht, wt = _t(h, True), _t(w, True)
        (tlce.fused_logsumexp_reference(ht, wt, eps) * _t(dz)).sum().backward()
        grads.append((ht.grad, wt.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], atol=1e-6, rtol=0)
    torch.testing.assert_close(grads[0][1], grads[1][1], atol=1e-6, rtol=0)


@pytest.mark.parametrize("e,v,tied,route", [
    (128, 512, False, "wgmma"), (128, 512, True, "wgmma"), (1000, 50264, False, "wgmma"),
    (128, 1003, False, "mma_sync"), (1003, 512, True, "mma_sync"), (1000, 50257, False, "mma_sync")])
def test_lce_bwd_route_is_picked_from_the_shapes(monkeypatch, e, v, tied, route):
    """E and V multiples of 8 (16-byte rows for TMA) take lce_bwd's wgmma route, any
    other stride its mma.sync route, tied or not; lce_fwd takes the route of the same
    rule. The launch recorder stands in for the card; nothing reaches the plain
    version."""
    from automodel_tpu_torch.kernels import build

    calls = []
    monkeypatch.setattr(build, "launch", lambda source, name, device, *args:
                        calls.append((name, args)))
    monkeypatch.setattr(tlce, "_sm_count", lambda device: 132)

    def no_plain(*a, **k):
        raise AssertionError("the kernels' route fell back to the plain version")

    monkeypatch.setattr(tlce, "fused_logsumexp_reference", no_plain)
    n = 256
    h = torch.zeros(n, e, dtype=torch.bfloat16, requires_grad=True)
    w = torch.zeros((v, e) if tied else (e, v), dtype=torch.bfloat16, requires_grad=True)
    assert tlce.lce_bwd_route(h, w, tied) == route
    before = dict(tlce.ROUTE_LAUNCHES)
    z = tlce._FusedLogsumexp.apply(h, w, tied, None)
    z.backward(torch.ones(n))
    assert [name for name, _ in calls] == [
        "lce_fwd_wgmma" if route == "wgmma" else "lce_fwd",
        "lce_bwd_wgmma" if route == "wgmma" else "lce_bwd"]
    args = calls[1][1]
    assert args[4] is None and args[9:13] == (n, e, v, int(tied))  # exact: no filter mask
    assert args[13] == tlce.lce_chunk(n, v) and args[13] % tlce.TILE_V == 0
    assert (args[8] is None) == (v <= args[13])  # the f32 dH scratch only across chunks
    assert tlce.ROUTE_LAUNCHES[f"lce_bwd/{route}"] - before[f"lce_bwd/{route}"] == 1


def test_a_misaligned_hidden_state_takes_the_mma_sync_route():
    """h starting off a 16-byte boundary cannot be a TMA operand."""
    base = torch.zeros(128 * 64 + 1, dtype=torch.bfloat16)
    w = torch.zeros(64, 512, dtype=torch.bfloat16)
    assert tlce.lce_bwd_route(base[1:].view(128, 64), w) == "mma_sync"
    assert tlce.lce_bwd_route(base[:-1].view(128, 64), w) == "wgmma"


def _fwd_recorder(monkeypatch):
    """Record lce_fwd's C entry point (name, arguments) instead of launching it, with
    the card's 132 SMs, and fail on any call of the plain version."""
    from automodel_tpu_torch.kernels import build

    calls = []
    monkeypatch.setattr(build, "launch", lambda source, name, device, *args:
                        calls.append((name, args)))
    monkeypatch.setattr(tlce, "_sm_count", lambda device: 132)

    def no_plain(*a, **k):
        raise AssertionError("the kernels' route fell back to the plain version")

    monkeypatch.setattr(tlce, "fused_logsumexp_reference", no_plain)
    return calls


@pytest.mark.parametrize("n,e,v,tied,route", [
    (256, 128, 512, False, "wgmma"), (256, 128, 512, True, "wgmma"),
    (256, 1000, 50264, False, "wgmma"), (256, 8, 16, True, "wgmma"),
    (256, 128, 1003, False, "mma_sync"), (256, 1003, 512, True, "mma_sync"),
    (8192, 64, 50257, False, "mma_sync")])
def test_lce_fwd_route_is_picked_from_the_shapes(monkeypatch, n, e, v, tied, route):
    """lce_fwd takes the wgmma route when E and V are multiples of 8 (as lce_bwd does),
    else the mma.sync route. Both entry points take (h, w, z, bmax, part_m, part_l, N,
    E, V, vmajor, splits) in that order; the wgmma route's partials are one (m, l) pair
    a 256-column tile of the core (splits = ceil(V / 256)), the mma.sync route's the
    vocab split that gives ~2 blocks an SM; the wrapper's outputs are (z, bmax) either
    way. Nothing reaches the plain version."""
    calls = _fwd_recorder(monkeypatch)
    h = torch.zeros(n, e, dtype=torch.bfloat16)
    w = torch.zeros((v, e) if tied else (e, v), dtype=torch.bfloat16)
    assert tlce.lce_fwd_route(h, w, tied) == route == tlce.lce_bwd_route(h, w, tied)
    before = dict(tlce.ROUTE_LAUNCHES)
    z, bmax = tlce.lce_fwd(h, w, tied)
    num_vt = -(-v // tlce.TILE_V)
    assert z.shape == (n,) and bmax.shape == (num_vt, n)
    assert [name for name, _ in calls] == ["lce_fwd_wgmma" if route == "wgmma" else "lce_fwd"]
    args = calls[0][1]
    assert args[0] == h.data_ptr() and args[1] == w.data_ptr()
    assert args[2] == z.data_ptr() and args[3] == bmax.data_ptr()
    splits = -(-v // 256) if route == "wgmma" else min(num_vt, max(1, -(-264 // (n // 128))))
    assert args[5] - args[4] == 4 * splits * n  # part_l follows part_m's (splits, N) block
    assert args[6:] == (n, e, v, int(tied), splits)
    taken = {k: tlce.ROUTE_LAUNCHES[k] - before[k] for k in before}
    assert taken == {k: int(k == f"lce_fwd/{route}") for k in before}


@pytest.mark.parametrize("which", ["h", "w"])
def test_a_misaligned_operand_takes_lce_fwd_off_the_wgmma_route(monkeypatch, which):
    """h or w starting off a 16-byte boundary cannot be a TMA operand: lce_fwd then
    launches its mma.sync entry point."""
    calls = _fwd_recorder(monkeypatch)
    base = torch.zeros(128 * 512 + 1, dtype=torch.bfloat16)
    ops = {"h": torch.zeros(128, 64, dtype=torch.bfloat16),
           "w": torch.zeros(64, 512, dtype=torch.bfloat16)}
    ops[which] = base[1:ops[which].numel() + 1].view(ops[which].shape)
    assert tlce.lce_fwd_route(ops["h"], ops["w"]) == "mma_sync"
    tlce.lce_fwd(ops["h"], ops["w"])
    assert [name for name, _ in calls] == ["lce_fwd"]


def test_lce_chunk_keeps_the_buffer_within_its_budget():
    """The backward's (N, chunk) bf16 buffer: a multiple of the vocab tile, within the
    byte budget, at least one tile, at most the padded vocabulary."""
    for n, v in ((8192, 128256), (32768, 128256), (256, 3001), (2**20, 1000)):
        chunk = tlce.lce_chunk(n, v)
        assert chunk % tlce.TILE_V == 0 and tlce.TILE_V <= chunk <= -(-v // 128) * 128
        assert chunk == tlce.TILE_V or 2 * n * chunk <= tlce._CHUNK_BYTES
    assert tlce.lce_chunk(8192, 128256) == 16384 and tlce.lce_chunk(32768, 128256) == 4096


def _jax_pallas_calls_after_dce(h, w, argnums) -> int:
    """``pallas_call``s left in the jaxpr of JAX's fused-logsumexp gradient with respect
    to ``argnums`` once dead code is eliminated (what its jit launches)."""
    from jax.interpreters import partial_eval as pe

    def count(jaxpr):
        n = 0
        for eqn in jaxpr.eqns:
            n += eqn.primitive.name == "pallas_call"
            for value in eqn.params.values():
                for sub in value if isinstance(value, (list, tuple)) else [value]:
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        n += count(inner)
        return n

    f = lambda h_, w_: jlce.fused_logsumexp(h_, w_, 128, 256, True).sum()  # noqa: E731
    closed = jax.make_jaxpr(jax.grad(f, argnums=argnums))(jnp.asarray(h), jnp.asarray(w))
    live, _ = pe.dce_jaxpr(closed.jaxpr, [True] * len(closed.jaxpr.outvars))
    return count(live)


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen_w", "trained_w"])
@pytest.mark.parametrize("e,v,tied,route", [
    (128, 1024, False, "wgmma"), (128, 1024, True, "wgmma"), (128, 1003, False, "mma_sync"),
    (1003, 512, True, "mma_sync")])
def test_frozen_unembedding_asks_for_dh_alone(monkeypatch, e, v, tied, route, frozen):
    """With w needing no gradient (a frozen unembedding, as under LoRA) the backward
    launches lce_bwd with a null dw, counted under lce_bwd/dh_only, and returns no dW:
    the kernels JAX's jit launches, whose gradient in h alone keeps 2 of its 3 Pallas
    calls (forward and dH) after dead-code elimination. A w that needs its gradient
    gets the full call. The launch recorder stands in for the card."""
    from automodel_tpu_torch.kernels import build

    h_np, w_np, _, _ = _data(seed=3, n=256, e=128, v=1024)
    assert _jax_pallas_calls_after_dce(h_np, w_np, 0 if frozen else (0, 1)) == (2 if frozen
                                                                                 else 3)
    calls = []
    monkeypatch.setattr(build, "launch", lambda source, name, device, *args:
                        calls.append((name, args)))
    monkeypatch.setattr(tlce, "_sm_count", lambda device: 132)
    n = 256
    h = torch.zeros(n, e, dtype=torch.bfloat16, requires_grad=True)
    w = torch.zeros((v, e) if tied else (e, v), dtype=torch.bfloat16, requires_grad=not frozen)
    before = dict(tlce.ROUTE_LAUNCHES)
    z = tlce._FusedLogsumexp.apply(h, w, tied, None)
    z.backward(torch.ones(n))
    suffix = "_wgmma" if route == "wgmma" else ""
    assert [name for name, _ in calls] == [f"lce_fwd{suffix}", f"lce_bwd{suffix}"]
    assert (calls[1][1][6] is None) == frozen  # the dw pointer
    assert calls[1][1][5] is not None  # dh
    taken = {k: tlce.ROUTE_LAUNCHES[k] - before[k] for k in before}
    assert taken[f"lce_bwd/{route}"] == 1 and taken["lce_bwd/dh_only"] == int(frozen)
    assert h.grad is not None and (w.grad is None) == frozen
