"""The port's ring chunk functions against the JAX package's Pallas chunk kernels.

On the CPU the port's wrappers run the kernels' plain version; the JAX side runs
``ops/pallas/ring_chunk.py`` in interpret mode with 16x16 blocks, its positions,
segments and (m, l, lse, delta) broadcast over the TPU's lanes / sublanes as its ring
passes them. Inputs come from numpy seeds; f32 throughout, atol 2e-5. The CUDA kernels
themselves are checked on the card (chip_smoke.py).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops.pallas import ring_chunk as jrc
from automodel_tpu.ops.pallas.flash_attention import _kv_sublanes, _q_lanes
from automodel_tpu_torch.kernels import build
from automodel_tpu_torch.ops import ring_chunk as trc

ATOL = 2e-5
NEG_INF = -1e30

CASES = {
    "causal": dict(b=2, s=32, h=4, kh=4, d=16, dv=16),
    "gqa_segments": dict(b=2, s=32, h=8, kh=2, d=16, dv=16, segments=True),
    "window": dict(b=1, s=32, h=4, kh=2, d=16, dv=16, window=12),
    "mla_dv": dict(b=1, s=32, h=4, kh=2, d=24, dv=16),
}


def _inputs(seed, b, s, h, kh, d, dv, segments=False, **_):
    rng = np.random.RandomState(seed)
    q = rng.randn(b * h, s, d).astype(np.float32)
    ks = [rng.randn(b * kh, s, d).astype(np.float32) for _ in range(2)]
    vs = [rng.randn(b * kh, s, dv).astype(np.float32) for _ in range(2)]
    do = rng.randn(b * h, s, dv).astype(np.float32)
    # local q is the second shard; kv chunk 0 comes from the first shard, chunk 1 is local
    pos = [np.broadcast_to(np.arange(s, dtype=np.int32) + off, (b, s)).copy()
           for off in (s, 0)]
    pos_q = pos[0]
    seg = [None, None]
    seg_q = None
    if segments:
        # two documents per row, the boundary inside the local shard; the last 4 local
        # rows carry an id no key has, so their rows stay fully masked
        seg = [np.ones((b, s), np.int32), np.ones((b, s), np.int32)]
        seg[1][:, s // 2:] = 2
        seg_q = np.ones((b, s), np.int32)
        seg_q[:, s // 2:] = 2
        seg_q[:, s - 4:] = 7
        seg[1][:, s - 4:] = 3
    return q, ks, vs, do, pos_q, pos, seg_q, seg


def _kw(case):
    return dict(scale=case["d"] ** -0.5, causal=True, window=case.get("window"),
                groups=case["h"] // case["kh"], n_heads=case["h"])


def _jax_fwd(q, k, v, pq, pkv, sq, skv, acc, m, l, kw):
    lanes = lambda x: None if x is None else _q_lanes(jnp.asarray(x))  # noqa: E731
    sub = lambda x: None if x is None else _kv_sublanes(jnp.asarray(x))  # noqa: E731
    out = jrc.chunk_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lanes(pq), sub(pkv), lanes(sq), sub(skv),
        jnp.asarray(acc), _q_lanes(jnp.asarray(m)), _q_lanes(jnp.asarray(l)),
        block_q=16, block_k=16, interpret=True, **kw)
    return np.asarray(out[0]), np.asarray(out[1][..., 0]), np.asarray(out[2][..., 0])


def _jax_bwd(q, k, v, pq, pkv, sq, skv, do, lse, delta, kw):
    lanes = lambda x: None if x is None else _q_lanes(jnp.asarray(x))  # noqa: E731
    sub = lambda x: None if x is None else _kv_sublanes(jnp.asarray(x))  # noqa: E731
    dq, dk, dv = jrc.chunk_attention_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lanes(pq), sub(pkv), lanes(sq), sub(skv),
        jnp.asarray(do), _q_lanes(jnp.asarray(lse)), _q_lanes(jnp.asarray(delta)),
        block_q=16, block_k=16, interpret=True, **kw)
    g = kw["groups"]

    def group_sum(x):  # per-q-head rows -> kv rows, as the JAX ring's _gqa_sum
        x = np.asarray(x)
        return x.reshape(-1, g, *x.shape[1:]).sum(1)

    return np.asarray(dq), group_sum(dk), group_sum(dv)


def _t(x):
    return None if x is None else torch.tensor(x)


@pytest.mark.parametrize("name", list(CASES))
def test_two_ring_steps_match_jax(name):
    """Forward over two visiting chunks (the carry merges across calls), then the
    backward of each chunk against the global lse."""
    case = CASES[name]
    q, ks, vs, do, pos_q, pos, seg_q, seg = _inputs(len(name), **case)
    kw = _kw(case)
    bn, s, dv = q.shape[0], q.shape[1], case["dv"]
    acc, m, l = (np.zeros((bn, s, dv), np.float32), np.full((bn, s), NEG_INF, np.float32),
                 np.zeros((bn, s), np.float32))
    t_acc, t_m, t_l = _t(acc), _t(m), _t(l)
    before = dict(trc.LAUNCHES)
    for i in range(2):
        acc, m, l = _jax_fwd(q, ks[i], vs[i], pos_q, pos[i], seg_q, seg[i], acc, m, l, kw)
        out = trc.chunk_attention_fwd(_t(q), _t(ks[i]), _t(vs[i]), _t(pos_q), _t(pos[i]),
                                      _t(seg_q), _t(seg[i]), t_acc, t_m, t_l, **kw)
        assert out[0] is t_acc and out[1] is t_m and out[2] is t_l  # updated in place
        for got, want in zip((t_acc, t_m, t_l), (acc, m, l)):
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    if seg_q is not None:
        dead = (seg_q == 7).repeat(case["h"], 0)
        assert (m[dead] == NEG_INF).all() and (l[dead] == 0).all() and (acc[dead] == 0).all()

    lse = np.where(l == 0, NEG_INF, m + np.log(np.where(l == 0, 1.0, l))).astype(np.float32)
    delta = np.random.RandomState(3).randn(bn, s).astype(np.float32)
    dq = torch.zeros(bn, s, case["d"])
    for i in range(2):
        want = _jax_bwd(q, ks[i], vs[i], pos_q, pos[i], seg_q, seg[i], do, lse, delta, kw)
        dq_i = torch.zeros_like(dq)
        dk, dv_ = torch.zeros(ks[i].shape), torch.zeros(vs[i].shape)
        trc.chunk_attention_bwd(_t(q), _t(ks[i]), _t(vs[i]), _t(pos_q), _t(pos[i]), _t(seg_q),
                                _t(seg[i]), _t(do), _t(lse), _t(delta), dq_i, dk, dv_, **kw)
        for got, ref in zip((dq_i, dk, dv_), want):
            np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
        dq += dq_i
    assert trc.LAUNCHES == before  # the CPU ran the plain version


def test_plain_version_slices_change_no_value(monkeypatch):
    """The plain versions loop over batch slices to bound their score tensor; the
    slicing changes no value."""
    case = CASES["gqa_segments"]
    q, ks, vs, do, pos_q, pos, seg_q, seg = _inputs(5, **case)
    kw = _kw(case)
    bn, s = q.shape[:2]
    args = (_t(q), _t(ks[0]), _t(vs[0]), _t(pos_q), _t(pos[0]), _t(seg_q), _t(seg[0]))
    carry = (torch.zeros(bn, s, case["dv"]), torch.full((bn, s), NEG_INF), torch.zeros(bn, s))
    lse, delta = torch.randn(bn, s), torch.randn(bn, s)
    whole_f = trc.chunk_attention_fwd_reference(*args, *carry, **kw)
    whole_b = trc.chunk_attention_bwd_reference(*args, _t(do), lse, delta, **kw)
    monkeypatch.setattr(trc, "_SCORE_ELEMS", 1)  # one batch row a slice
    for got, want in zip(trc.chunk_attention_fwd_reference(*args, *carry, **kw) +
                         trc.chunk_attention_bwd_reference(*args, _t(do), lse, delta, **kw),
                         whole_f + whole_b):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_non_cpu_tensors_reach_the_kernel_checks():
    """A tensor off the CPU goes to the kernel route and raises there; nothing falls back
    to the plain version."""
    case = CASES["causal"]
    q, ks, vs, do, pos_q, pos, _, _ = _inputs(0, **case)

    def meta(x, dt=torch.bfloat16):
        return torch.empty(x.shape, dtype=dt, device="meta")

    bn, s = q.shape[:2]
    carry = [torch.empty(bn, s, 16, device="meta"), torch.empty(bn, s, device="meta"),
             torch.empty(bn, s, device="meta")]
    with pytest.raises(ValueError, match="not a CUDA device"):
        trc.chunk_attention_fwd(meta(q), meta(ks[0]), meta(vs[0]), meta(pos_q, torch.int32),
                                meta(pos[0], torch.int32), None, None, *carry, **_kw(case))
    with pytest.raises(ValueError, match="not a CUDA device"):
        trc.chunk_attention_bwd(meta(q), meta(ks[0]), meta(vs[0]), meta(pos_q, torch.int32),
                                meta(pos[0], torch.int32), None, None, meta(do),
                                carry[1], carry[2], torch.empty(q.shape, device="meta"),
                                torch.empty(ks[0].shape, device="meta"),
                                torch.empty(vs[0].shape, device="meta"), **_kw(case))


_CTYPE = {"const void*": "P", "void*": "P", "const int*": "P", "float*": "P",
          "const float*": "P", "int": "I", "float": "F"}


@pytest.mark.parametrize("source", sorted(build.SOURCES))
def test_ctypes_argtypes_match_the_c_entry_points(source):
    """Each bound C function takes the arguments ``build.SOURCES`` declares, in order
    (a mismatch would only show on the card, as a wrong pointer or a cut argument)."""
    import ctypes
    import os

    names = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F"}
    text = open(os.path.join(os.path.dirname(build.__file__), "..", "csrc", source)).read()
    for fn, argtypes in build.SOURCES[source].items():
        sig = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
        assert sig, f"{source}: no extern \"C\" int {fn}(...)"
        params = [" ".join(p.split()[:-1]).replace(" *", "*") for p in sig.group(1).split(",")]
        assert [_CTYPE[p] for p in params] == [names[a] for a in argtypes], fn
