"""The port's flash attention against the JAX package's Pallas kernels.

On the CPU the port's wrapper runs the kernels' plain version; the JAX side runs
the Pallas kernels in interpret mode with 32x32 blocks, as tests/unit/
test_flash_attention.py does, with the fused backward and with the split one.
Inputs come from numpy seeds; cases run at head_dim 16, 128, Phi-3's 96 and Gemma's
256 (with GQA, segments, a window and the soft-cap). Tolerances, f32 throughout: 2e-5 on O and lse,
1e-4 on the gradients. The deterministic route's plain versions (flash_dq_reference,
flash_dkv_reference) are held against the split backward's kernels (_dq_kernel,
_dkv_kernel) at 1e-4 too, and the route the wrapper takes under
torch.use_deterministic_algorithms is read from the entry points it launches. The CUDA
kernels themselves are checked on the card. With a sliding window and sinks: the plain
split backward against JAX's split kernels, the sinks' gradient (sink_grad, from lse and
delta) against JAX's _dsinks_from_residuals, and the window and sinks as the wrappers
pass them to the entry points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops.pallas import flash_attention as jfa
from automodel_tpu_torch.kernels import build
from automodel_tpu_torch.ops import flash_attention as tfa
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ATOL_FWD, ATOL_GRAD = 2e-5, 1e-4


def _inputs(seed, b, s, h, kh, d):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, s, n, d).astype(np.float32) for n in (h, kh, kh, h))
    return q, k, v, do


def _jax_o_lse(q, k, v, causal, seg_q, seg_kv):
    """JAX kernel's (O, lse[..., 0]) through its forward implementation."""
    b, sq, n, d = q.shape
    nk = k.shape[2]
    qf = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(b * n, sq, d)
    kf = jnp.asarray(k).transpose(0, 2, 1, 3).reshape(b * nk, -1, d)
    vf = jnp.asarray(v).transpose(0, 2, 1, 3).reshape(b * nk, -1, d)
    sq_l = skv_l = None
    if seg_q is not None:
        sq_l = jfa._q_lanes(jnp.repeat(jnp.asarray(seg_q), n, axis=0))
        skv_l = jfa._kv_sublanes(jnp.repeat(jnp.asarray(seg_kv), nk, axis=0))
    o, lse = jfa._flash_fwd_impl(qf, kf, vf, sq_l, skv_l, None, None, d**-0.5, causal,
                                 None, 32, 32, n // nk, True)
    return (np.asarray(o.reshape(b, n, sq, d).transpose(0, 2, 1, 3)),
            np.asarray(lse[..., 0]))


def _jax_grads(q, k, v, do, **kw):
    def f(q, k, v):
        o = jfa.flash_attention(q, k, v, interpret=True, block_q=32, block_k=32, **kw)
        return jnp.sum(o * jnp.asarray(do))
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _torch_o_lse_grads(q, k, v, do, **kw):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o, lse = tfa.flash_attention_reference(qt, kt, vt, **kw)
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.tensor(do))
    # the wrapper routes CPU tensors to the plain version (a fresh buffer may take
    # another BLAS path, so equal to f32 rounding rather than bit for bit)
    o_wrapped = tfa.flash_attention(*(torch.tensor(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(o_wrapped.numpy(), o.detach().numpy(), atol=1e-6, rtol=0)
    return o.detach().numpy(), lse.detach().numpy(), [g.numpy() for g in grads]


def _segments(b, s, pad_row_fully_masked):
    """Two packed segments per row plus right padding (id 0)."""
    seg = np.zeros((b, s), np.int32)
    seg[:, : s // 2] = 1
    seg[:, s // 2: s - 8] = 2
    seg_q = seg.copy()
    if pad_row_fully_masked:
        seg_q[:, s - 8:] = 3  # pad queries whose id no key carries: no allowed key
    return seg_q, seg


CASES = {
    "causal": dict(shape=(2, 64, 4, 4, 16), causal=True),
    "non_causal": dict(shape=(1, 64, 2, 2, 16), causal=False),
    "gqa": dict(shape=(2, 64, 8, 2, 16), causal=True),
    "packed_segments": dict(shape=(2, 64, 4, 2, 16), causal=True, segments=True),
    # head_dim 128, the Qwen3-MoE width the kernels also take (named to sort after
    # the cases above, whose seeds are their sorted positions)
    "wide_gqa_d128": dict(shape=(1, 64, 4, 2, 128), causal=True),
    "wide_packed_d128": dict(shape=(1, 64, 4, 2, 128), causal=True, segments=True),
    # head_dim 96, Phi-3's (the CUDA kernels run it in their 128-wide tiles)
    "y_d96_gqa_packed": dict(shape=(1, 64, 4, 2, 96), causal=True, segments=True),
    # head_dim 256, Gemma-2-9B's and Gemma-3's (tiles of their own in the CUDA kernels)
    "z_d256_gqa_packed": dict(shape=(1, 64, 2, 1, 256), causal=True, segments=True),
}


@pytest.mark.parametrize("fused", [True, False], ids=["fused_bwd", "split_bwd"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_pallas(name, fused, monkeypatch):
    case = CASES[name]
    if not fused:
        monkeypatch.setenv("AUTOMODEL_FLASH_FUSED_BWD", "0")
    q, k, v, do = _inputs(sorted(CASES).index(name), *case["shape"])
    seg_q = seg_kv = None
    if case.get("segments"):
        seg_q, seg_kv = _segments(q.shape[0], q.shape[1], pad_row_fully_masked=True)
    kw = dict(causal=case["causal"])
    seg_kw = {} if seg_q is None else dict(segment_ids_q=seg_q, segment_ids_kv=seg_kv)
    o_t, lse_t, grads_t = _torch_o_lse_grads(
        q, k, v, do, **kw, **{k_: torch.tensor(v_) for k_, v_ in seg_kw.items()})
    if fused:  # the forward is the same kernel either way
        o_j, lse_j = _jax_o_lse(q, k, v, case["causal"], seg_q, seg_kv)
        np.testing.assert_allclose(o_t, o_j, atol=ATOL_FWD, rtol=0)
        np.testing.assert_allclose(lse_t, lse_j, atol=ATOL_FWD, rtol=1e-6)
        if seg_q is not None:  # fully masked pad rows: O = 0, lse = -1e30
            assert np.all(o_t[:, -8:] == 0) and np.all(lse_t.reshape(q.shape[0], -1, q.shape[1])[..., -8:] == -1e30)
    grads_j = _jax_grads(q, k, v, do, **kw, **{k_: jnp.asarray(v_) for k_, v_ in seg_kw.items()})
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt, gj, atol=ATOL_GRAD, rtol=0)


@pytest.mark.parametrize("option", ["sliding_window", "logit_soft_cap", "sinks"])
def test_plain_version_options_match_pallas(option):
    """Window, soft-cap and sinks in the plain version (the CUDA kernels take all three)
    match the Pallas kernel, forward and gradients."""
    q, k, v, do = _inputs(11, 1, 64, 4, 2, 16)
    sinks = np.random.RandomState(12).randn(4).astype(np.float32)
    value = {"sliding_window": 16, "logit_soft_cap": 2.0, "sinks": sinks}[option]
    jkw = {option: jnp.asarray(value) if option == "sinks" else value}
    tkw = {option: torch.tensor(value) if option == "sinks" else value}
    o_j = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         interpret=True, block_q=32, block_k=32, **jkw))
    o_t, _, grads_t = _torch_o_lse_grads(q, k, v, do, causal=True, **tkw)
    np.testing.assert_allclose(o_t, o_j, atol=ATOL_FWD, rtol=0)
    grads_j = _jax_grads(q, k, v, do, **jkw)
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt, gj, atol=ATOL_GRAD, rtol=0)


@pytest.mark.parametrize("kw,err", [
    (dict(sliding_window=8), ValueError),  # a kernel feature: the kernels' check refuses meta
    (dict(logit_soft_cap=1.0), ValueError),  # a kernel feature, as the window
    (dict(sinks=torch.zeros(2)), ValueError),  # a kernel feature, as the window
    (dict(), ValueError),  # not a CUDA tensor
    (dict(head_dim=256), ValueError),  # the kernels take it: their input check refuses meta
    (dict(head_dim=80), NotImplementedError),  # no kernel takes it
])
def test_non_cpu_tensors_never_fall_back(kw, err):
    """A tensor off the CPU goes to the kernels or raises: never to the plain version.
    The window, soft-cap, sinks and head_dim 256 reach the kernels' input check; head_dim
    80 raises by name."""
    kw = dict(kw)
    q = torch.empty(1, 64, 2, kw.pop("head_dim", 64), dtype=torch.bfloat16, device="meta")
    before = dict(tfa.LAUNCHES)
    with pytest.raises(err):
        tfa.flash_attention(q, q, q, **kw)
    assert tfa.LAUNCHES == before


@pytest.mark.parametrize("name", list(CASES))
def test_split_plain_versions_match_pallas_split_kernels(name, monkeypatch):
    """flash_dq_reference and flash_dkv_reference, fed the plain forward's lse and
    delta = rowsum(dO * O), against JAX's split backward (_dq_kernel for dq, _dkv_kernel
    for dk / dv, interpret mode, fused backward off)."""
    monkeypatch.setenv("AUTOMODEL_FLASH_FUSED_BWD", "0")
    case = CASES[name]
    q, k, v, do = _inputs(sorted(CASES).index(name), *case["shape"])
    seg_q = seg_kv = None
    if case.get("segments"):
        seg_q, seg_kv = _segments(q.shape[0], q.shape[1], pad_row_fully_masked=True)
    kw = dict(causal=case["causal"])
    seg_kw = {} if seg_q is None else dict(segment_ids_q=seg_q, segment_ids_kv=seg_kv)
    tseg = {k_: torch.tensor(v_) for k_, v_ in seg_kw.items()}
    qt, kt, vt, dot = (torch.tensor(x) for x in (q, k, v, do))
    o, lse = tfa.flash_attention_reference(qt, kt, vt, **kw, **tseg)
    delta = tfa._delta(o, dot)
    dq = tfa.flash_dq_reference(qt, kt, vt, dot, lse, delta, **kw, **tseg)
    dk, dv = tfa.flash_dkv_reference(qt, kt, vt, dot, lse, delta, **kw, **tseg)
    grads_j = _jax_grads(q, k, v, do, **kw, **{k_: jnp.asarray(v_) for k_, v_ in seg_kw.items()})
    for got, want in zip((dq, dk, dv), grads_j):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_GRAD, rtol=0)


@pytest.fixture
def deterministic():
    """Sets torch.use_deterministic_algorithms for a test and restores it afterwards."""
    before = torch.are_deterministic_algorithms_enabled()
    yield torch.use_deterministic_algorithms
    torch.use_deterministic_algorithms(before)


def _recorded_launches(monkeypatch, fail=None):
    """Record the C entry points the wrappers launch (checked against the argument count
    build.SOURCES binds, less the stream) instead of launching them; ``fail``: the entry
    point whose launch raises, as a failed build or launch would."""
    calls = []

    def launch(source, name, device, *args):
        assert len(args) + 1 == len(build.SOURCES[source][name]), name
        calls.append(name)
        if name == fail:
            raise RuntimeError(f"{name} failed with cudaError_t 1")

    monkeypatch.setattr(build, "launch", launch)
    return calls


@pytest.mark.parametrize("flag", [False, True], ids=["default", "deterministic"])
def test_backward_launches_flash_dq_and_flash_dkv(flag, monkeypatch, deterministic):
    """flash_dq + flash_dkv with or without the deterministic-algorithms flag, each
    counted under its own name."""
    route = ["flash_dq", "flash_dkv"]
    calls = _recorded_launches(monkeypatch)
    q, k, v, do = (torch.tensor(x).to(torch.bfloat16) for x in _inputs(0, 1, 64, 4, 2, 64))
    lse = torch.zeros(4, 64)
    before = dict(tfa.LAUNCHES)
    deterministic(flag)
    dq, dk, dv = tfa.flash_backward(q, k, v, None, None, q, lse, do, 0.125, True)
    assert calls == route
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert dq.dtype == torch.bfloat16
    assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == {
        n: int(n in route) for n in before}


@pytest.mark.parametrize("flag", [False, True], ids=["default", "deterministic"])
@pytest.mark.parametrize("failing", ["flash_dq", "flash_dkv"])
def test_backward_raises_when_a_kernel_fails(flag, failing, monkeypatch, deterministic):
    """A backward kernel that fails raises; nothing else is launched in its place."""
    calls = _recorded_launches(monkeypatch, fail=failing)
    q, k, v, do = (torch.tensor(x).to(torch.bfloat16) for x in _inputs(0, 1, 64, 4, 2, 64))
    deterministic(flag)
    with pytest.raises(RuntimeError, match=failing):
        tfa.flash_backward(q, k, v, None, None, q, torch.zeros(4, 64), do, 0.125, True)
    assert calls == ["flash_dq", "flash_dkv"][:["flash_dq", "flash_dkv"].index(failing) + 1]


WINDOW_CASES = {
    # (shape (B, S, H, KH, D), causal, window, segments, sinks)
    "window_16": ((2, 64, 4, 2, 16), True, 16, False, False),
    "window_1": ((1, 64, 4, 4, 16), True, 1, False, False),
    "window_past_s": ((1, 64, 4, 2, 16), True, 100, False, False),
    "window_12_segments": ((2, 64, 4, 2, 16), True, 12, True, False),
    "window_non_causal": ((1, 64, 2, 2, 16), False, 20, False, False),
    "sinks": ((2, 64, 4, 2, 16), True, None, False, True),
    "window_sinks_segments": ((2, 64, 8, 2, 16), True, 12, True, True),
    "y_d96_window_segments": ((1, 64, 4, 2, 96), True, 20, True, False),
    "z_d256_window_sinks_segments": ((1, 64, 2, 1, 256), True, 20, True, True),
}


@pytest.mark.parametrize("name", list(WINDOW_CASES))
def test_windowed_split_plain_versions_and_dsinks_match_pallas(name, monkeypatch):
    """With a sliding window (1, one that is no multiple of a tile, one longer than S, one
    across a segment boundary) and sinks: the plain forward against JAX's forward kernel
    (O, lse), flash_dq_reference / flash_dkv_reference from its lse and delta against JAX's
    split kernels, and sink_grad against the sinks' gradient from JAX's
    _dsinks_from_residuals (interpret mode, fused backward off)."""
    monkeypatch.setenv("AUTOMODEL_FLASH_FUSED_BWD", "0")
    shape, causal, window, segments, with_sinks = WINDOW_CASES[name]
    q, k, v, do = _inputs(20 + sorted(WINDOW_CASES).index(name), *shape)
    b, s, h = shape[:3]
    sinks = np.random.RandomState(3).randn(h).astype(np.float32) if with_sinks else None
    seg_q = seg_kv = None
    if segments:
        seg_q, seg_kv = _segments(b, s, pad_row_fully_masked=True)
    kw = dict(causal=causal, sliding_window=window)
    tseg = {} if seg_q is None else dict(segment_ids_q=torch.tensor(seg_q),
                                         segment_ids_kv=torch.tensor(seg_kv))
    jseg = {} if seg_q is None else dict(segment_ids_q=jnp.asarray(seg_q),
                                         segment_ids_kv=jnp.asarray(seg_kv))
    qt, kt, vt, dot = (torch.tensor(x) for x in (q, k, v, do))
    tsinks = None if sinks is None else torch.tensor(sinks)
    o, lse = tfa.flash_attention_reference(qt, kt, vt, sinks=tsinks, **kw, **tseg)
    delta = tfa._delta(o, dot)
    dq = tfa.flash_dq_reference(qt, kt, vt, dot, lse, delta, **kw, **tseg)
    dk, dv = tfa.flash_dkv_reference(qt, kt, vt, dot, lse, delta, **kw, **tseg)

    jsinks = None if sinks is None else jnp.asarray(sinks)

    def f(q_, k_, v_, sinks_):
        out = jfa.flash_attention(q_, k_, v_, interpret=True, block_q=32, block_k=32,
                                  sinks=sinks_, **kw, **jseg)
        return jnp.sum(out * jnp.asarray(do)), out

    argnums = (0, 1, 2, 3) if sinks is not None else (0, 1, 2)
    (_, o_j), grads_j = jax.value_and_grad(f, argnums=argnums, has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jsinks)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=ATOL_FWD, rtol=0)
    for got, want in zip((dq, dk, dv), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_GRAD, rtol=0)
    if sinks is not None:
        dsinks = tfa.sink_grad(tsinks, lse, delta)
        np.testing.assert_allclose(dsinks.numpy(), np.asarray(grads_j[3]), atol=ATOL_GRAD,
                                   rtol=1e-5)
        # the plain version's own autograd gives the same sinks gradient
        ts = tsinks.clone().requires_grad_()
        o_a, _ = tfa.flash_attention_reference(qt, kt, vt, sinks=ts, **kw, **tseg)
        np.testing.assert_allclose(torch.autograd.grad(o_a, ts, dot)[0].numpy(),
                                   dsinks.numpy(), atol=ATOL_GRAD, rtol=1e-5)
    if window == 1 and not segments:  # each row sees itself alone: O is v's row
        np.testing.assert_allclose(o.numpy(), np.repeat(v, h // shape[3], axis=2), atol=1e-6)


@pytest.mark.parametrize("window,sinks", [(None, False), (128, False), (None, True),
                                          (100, True)], ids=["plain", "window", "sinks",
                                                             "window_sinks"])
def test_window_and_sinks_reach_the_entry_points(window, sinks, monkeypatch):
    """The wrappers pass (has_window, window) to all three entry points and the sinks
    (f32, (H,)) to flash_fwd only; the windowed launches are counted apart, and the
    sinks' gradient comes from lse and delta (sink_grad), in the sinks' dtype."""
    seen = {}

    def launch(source, name, device, *args):
        assert len(args) + 1 == len(build.SOURCES[source][name]), name
        seen[name] = args

    monkeypatch.setattr(build, "launch", launch)
    monkeypatch.setattr(tfa, "_check_cuda", lambda *a: None)  # CPU tensors stand in
    q, k, v, do = (torch.tensor(x).to(torch.bfloat16).requires_grad_()
                   for x in _inputs(0, 1, 64, 4, 2, 64))
    tsinks = torch.randn(4, dtype=torch.bfloat16, requires_grad=True) if sinks else None
    before, before_w = dict(tfa.LAUNCHES), dict(tfa.WINDOWED_LAUNCHES)
    o, _ = tfa.flash_attention_cuda(q, k, v, sliding_window=window, sinks=tsinks)
    grads = torch.autograd.grad(o, [t for t in (q, k, v, tsinks) if t is not None], do)
    pair = (0, 0) if window is None else (1, window)
    assert seen["flash_fwd"][-2:] == pair
    assert seen["flash_dq"][-2:] == pair and seen["flash_dkv"][-2:] == pair
    assert (seen["flash_fwd"][5] is None) == (not sinks)
    assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == dict.fromkeys(before, 1)
    assert {n: tfa.WINDOWED_LAUNCHES[n] - before_w[n] for n in before_w} == dict.fromkeys(
        before_w, int(window is not None))
    if sinks:
        assert grads[3].dtype == torch.bfloat16 and grads[3].shape == (4,)


@pytest.mark.parametrize("softcap", [None, 50.0], ids=["uncapped", "capped"])
def test_head_dim_256_reaches_the_entry_points(softcap, monkeypatch):
    """At head_dim 256 all three entry points get D = 256 beside the caller's scale
    (Gemma's 256^-0.5) and cap, nothing is refused, and the launches are counted under
    d256 (capped ones apart)."""
    seen = {}

    def launch(source, name, device, *args):
        assert len(args) + 1 == len(build.SOURCES[source][name]), name
        seen[name] = args

    monkeypatch.setattr(build, "launch", launch)
    monkeypatch.setattr(tfa, "_check_cuda", lambda *a: None)  # CPU tensors stand in
    q, k, v, do = (torch.tensor(x).to(torch.bfloat16).requires_grad_()
                   for x in _inputs(0, 1, 64, 2, 1, 256))
    before, before_c = dict(tfa.HEAD_DIM_LAUNCHES), dict(tfa.SOFTCAP_LAUNCHES)
    o, _ = tfa.flash_attention_cuda(q, k, v, softmax_scale=256**-0.5, sliding_window=1024,
                                    logit_soft_cap=softcap)
    torch.autograd.grad(o, (q, k, v), do)
    assert sorted(seen) == ["flash_dkv", "flash_dq", "flash_fwd"]
    for name, args in seen.items():
        ints, floats = [a for a in args if type(a) is int], [a for a in args if type(a) is float]
        assert 256 in ints and floats == [256**-0.5, softcap or 0.0], name
        assert args[-2:] == (1, 1024), name
    assert {n: tfa.HEAD_DIM_LAUNCHES[n] - before[n] for n in before} == {
        n: int(n.endswith("/d256")) for n in before}
    assert {n: tfa.SOFTCAP_LAUNCHES[n] - before_c[n] for n in before_c} == dict.fromkeys(
        before_c, int(softcap is not None))


def test_head_dim_96_reaches_the_entry_points(monkeypatch):
    """At head_dim 96 all three entry points get D = 96 and the softmax scale 1/sqrt(96)
    (the kernels run it in their 128-wide tiles, but the scale is never the tile's), and
    the launches are counted under d96."""
    seen = {}

    def launch(source, name, device, *args):
        assert len(args) + 1 == len(build.SOURCES[source][name]), name
        seen[name] = args

    monkeypatch.setattr(build, "launch", launch)
    monkeypatch.setattr(tfa, "_check_cuda", lambda *a: None)  # CPU tensors stand in
    q, k, v, do = (torch.tensor(x).to(torch.bfloat16).requires_grad_()
                   for x in _inputs(0, 1, 64, 4, 2, 96))
    before = dict(tfa.HEAD_DIM_LAUNCHES)
    o, _ = tfa.flash_attention_cuda(q, k, v, sliding_window=2047)
    torch.autograd.grad(o, (q, k, v), do)
    for name, args in seen.items():
        ints, floats = [a for a in args if type(a) is int], [a for a in args if type(a) is float]
        assert 96 in ints and floats == [96**-0.5, 0.0], name  # the scale; no soft-cap
    assert {n: tfa.HEAD_DIM_LAUNCHES[n] - before[n] for n in before} == {
        n: int(n.endswith("/d96")) for n in before}


SOFTCAP_CASES = {
    # (shape (B, S, H, KH, D), causal, cap, window, segments, sinks): c = 0.5 saturates tanh
    # at these scores (s scale ~ N(0, 1))
    "cap_2": ((2, 64, 4, 2, 16), True, 2.0, None, False, False),
    "cap_half_non_causal": ((1, 64, 2, 2, 16), False, 0.5, None, False, False),
    "cap_window_segments": ((2, 64, 4, 2, 16), True, 2.0, 12, True, False),
    "cap_sinks": ((1, 64, 4, 2, 16), True, 0.5, None, False, True),
    "cap_d96": ((1, 64, 4, 2, 96), True, 2.0, 20, False, False),
    "cap_window_segments_d256": ((1, 64, 2, 1, 256), True, 2.0, 20, True, False),
}


@pytest.mark.parametrize("name", list(SOFTCAP_CASES))
def test_softcap_split_plain_versions_match_pallas_split_kernels(name, monkeypatch):
    """With the tanh logit soft-cap (alone, saturating, with a window and segments, with
    sinks, at head_dim 96): the plain forward against JAX's forward kernel (O),
    flash_dq_reference / flash_dkv_reference with ``logit_soft_cap``, from its lse and
    delta, against JAX's split kernels (_dq_kernel, _dkv_kernel: interpret mode, fused
    backward off), and the plain version's own autograd against both."""
    monkeypatch.setenv("AUTOMODEL_FLASH_FUSED_BWD", "0")
    shape, causal, cap, window, segments, with_sinks = SOFTCAP_CASES[name]
    q, k, v, do = _inputs(40 + sorted(SOFTCAP_CASES).index(name), *shape)
    b, s, h = shape[:3]
    sinks = np.random.RandomState(4).randn(h).astype(np.float32) if with_sinks else None
    seg_q = seg_kv = None
    if segments:
        seg_q, seg_kv = _segments(b, s, pad_row_fully_masked=True)
    kw = dict(causal=causal, sliding_window=window, logit_soft_cap=cap)
    tseg = {} if seg_q is None else dict(segment_ids_q=torch.tensor(seg_q),
                                         segment_ids_kv=torch.tensor(seg_kv))
    jseg = {} if seg_q is None else dict(segment_ids_q=jnp.asarray(seg_q),
                                         segment_ids_kv=jnp.asarray(seg_kv))
    tsinks = None if sinks is None else torch.tensor(sinks)
    qt, kt, vt, dot = (torch.tensor(x, requires_grad=True) for x in (q, k, v, do))
    o, lse = tfa.flash_attention_reference(qt, kt, vt, sinks=tsinks, **kw, **tseg)
    autograd = torch.autograd.grad(o, (qt, kt, vt), dot)
    o, lse, dot = o.detach(), lse.detach(), dot.detach()
    delta = tfa._delta(o, dot)
    dq = tfa.flash_dq_reference(qt, kt, vt, dot, lse, delta, **kw, **tseg)
    dk, dv = tfa.flash_dkv_reference(qt, kt, vt, dot, lse, delta, **kw, **tseg)

    def f(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, interpret=True, block_q=32, block_k=32,
                                  sinks=None if sinks is None else jnp.asarray(sinks), **kw,
                                  **jseg)
        return jnp.sum(out * jnp.asarray(do)), out

    (_, o_j), grads_j = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=ATOL_FWD, rtol=0)
    for got, auto, want in zip((dq, dk, dv), autograd, grads_j):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL_GRAD,
                                   rtol=0)
        np.testing.assert_allclose(auto.numpy(), np.asarray(want), atol=ATOL_GRAD, rtol=0)


@pytest.mark.parametrize("window", [None, 100], ids=["causal", "window"])
def test_softcap_reaches_the_entry_points(window, monkeypatch):
    """The wrappers pass the cap c to all three entry points beside the scale (0.0 without
    one) and count the capped launches apart; a cap that is not positive raises."""
    seen = {}

    def launch(source, name, device, *args):
        assert len(args) + 1 == len(build.SOURCES[source][name]), name
        seen[name] = args

    monkeypatch.setattr(build, "launch", launch)
    monkeypatch.setattr(tfa, "_check_cuda", lambda *a: None)  # CPU tensors stand in
    q, k, v, do = (torch.tensor(x).to(torch.bfloat16).requires_grad_()
                   for x in _inputs(0, 1, 64, 4, 2, 128))
    before, before_c = dict(tfa.LAUNCHES), dict(tfa.SOFTCAP_LAUNCHES)
    o, _ = tfa.flash_attention_cuda(q, k, v, softmax_scale=144**-0.5, sliding_window=window,
                                    logit_soft_cap=50.0)
    torch.autograd.grad(o, (q, k, v), do)
    for name, args in seen.items():
        assert [a for a in args if type(a) is float] == [144**-0.5, 50.0], name
        assert args[-2:] == ((0, 0) if window is None else (1, window)), name
    assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == dict.fromkeys(before, 1)
    assert {n: tfa.SOFTCAP_LAUNCHES[n] - before_c[n] for n in before_c} == dict.fromkeys(
        before_c, 1)
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="logit_soft_cap"):
            tfa.flash_attention_cuda(q, k, v, logit_soft_cap=bad)
