"""The port's ring chunk functions against the JAX package's Pallas chunk kernels.

On the CPU the port's wrappers run the kernels' plain version; the JAX side runs
``ops/pallas/ring_chunk.py`` in interpret mode with 16x16 blocks, its positions,
segments and (m, l, lse, delta) broadcast over the TPU's lanes / sublanes as its ring
passes them (blocks of 8 where S = 40). Inputs come from numpy seeds; f32 throughout, atol
2e-5, with v narrower than q and k (MLA's Dv < D) in three cases. The deterministic
route's plain versions (chunk_attention_dq_reference, chunk_attention_dkv_reference) are
held against _chunk_bwd_kernel at the same tolerance, and the route the backward takes
under torch.use_deterministic_algorithms is read from the calls it makes. The CUDA
kernels themselves are checked on the card (chip_smoke.py).
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
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ATOL = 2e-5
NEG_INF = -1e30

CASES = {
    "causal": dict(b=2, s=32, h=4, kh=4, d=16, dv=16),
    "gqa_segments": dict(b=2, s=32, h=8, kh=2, d=16, dv=16, segments=True),
    "window": dict(b=1, s=32, h=4, kh=2, d=16, dv=16, window=12),
    "mla_dv": dict(b=1, s=32, h=4, kh=2, d=24, dv=16),
    "mla_dv_segments": dict(b=2, s=32, h=8, kh=2, d=24, dv=16, segments=True),
    # S = 40: the JAX kernel takes blocks of 8 here; the kernels' 128-row tiles run past S
    "mla_dv_ragged": dict(b=1, s=40, h=4, kh=4, d=24, dv=16, block=8),
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


def _jax_fwd(q, k, v, pq, pkv, sq, skv, acc, m, l, kw, block=16):
    lanes = lambda x: None if x is None else _q_lanes(jnp.asarray(x))  # noqa: E731
    sub = lambda x: None if x is None else _kv_sublanes(jnp.asarray(x))  # noqa: E731
    out = jrc.chunk_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lanes(pq), sub(pkv), lanes(sq), sub(skv),
        jnp.asarray(acc), _q_lanes(jnp.asarray(m)), _q_lanes(jnp.asarray(l)),
        block_q=block, block_k=block, interpret=True, **kw)
    return np.asarray(out[0]), np.asarray(out[1][..., 0]), np.asarray(out[2][..., 0])


def _jax_bwd(q, k, v, pq, pkv, sq, skv, do, lse, delta, kw, block=16):
    lanes = lambda x: None if x is None else _q_lanes(jnp.asarray(x))  # noqa: E731
    sub = lambda x: None if x is None else _kv_sublanes(jnp.asarray(x))  # noqa: E731
    dq, dk, dv = jrc.chunk_attention_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lanes(pq), sub(pkv), lanes(sq), sub(skv),
        jnp.asarray(do), _q_lanes(jnp.asarray(lse)), _q_lanes(jnp.asarray(delta)),
        block_q=block, block_k=block, interpret=True, **kw)
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
        acc, m, l = _jax_fwd(q, ks[i], vs[i], pos_q, pos[i], seg_q, seg[i], acc, m, l, kw,
                             case.get("block", 16))
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
        want = _jax_bwd(q, ks[i], vs[i], pos_q, pos[i], seg_q, seg[i], do, lse, delta, kw,
                        case.get("block", 16))
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


@pytest.mark.parametrize("counts, ok", [
    (None, True), (torch.zeros(3, dtype=torch.int32), True),
    (torch.zeros(3, dtype=torch.int64), False), (torch.zeros(4, dtype=torch.int32), False),
    (torch.zeros(3, dtype=torch.int32, device="meta"), False)])
def test_tile_counts_buffer_is_checked(counts, ok):
    """The wrappers' optional tile-count buffer: None passes no pointer, a (3,) int32
    tensor on q's device passes its own, anything else raises before a launch."""
    q = torch.zeros(2, 4, 64)
    if ok:
        assert trc._counts(counts, q) == (None if counts is None else counts.data_ptr())
    else:
        with pytest.raises(ValueError, match="tile_counts"):
            trc._counts(counts, q)


_CTYPE = {"const void*": "P", "void*": "P", "const int*": "P", "int*": "P", "float*": "P",
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


# The six ring layouts of chip_smoke's ring cases, small: (cp, B, S_local, causal, window)
# and how the ids are made. Tiles of 16 q rows x 16 keys stand in for the kernels' 128 x 128.
RING_LAYOUTS = {
    "contiguous_causal": dict(cp=4, b=1, s_loc=64, causal=True),
    "packed_segments": dict(cp=4, b=2, s_loc=64, causal=True, packed=True),
    "round_robin": dict(cp=4, b=1, s_loc=64, causal=True, round_robin=True),
    "window": dict(cp=4, b=1, s_loc=64, causal=True, window=24),
    "non_causal": dict(cp=4, b=1, s_loc=64, causal=False),
    "ragged": dict(cp=3, b=1, s_loc=50, causal=True),
}


def _ring_ids(seed, cp, b, s_loc, packed=False, round_robin=False, **_):
    """Global (B, S) positions and segment ids (None without packing) of one ring layout,
    cut into cp shards along the batch dim: (B*cp, S_local) each."""
    rng = np.random.RandomState(seed)
    s = cp * s_loc
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    seg = None
    if round_robin:
        pos[:] = np.arange(s, dtype=np.int32).reshape(cp, -1).T.reshape(-1)
    if packed:  # documents of 5-40 tokens, positions restarting in each, a padded tail
        seg = np.zeros((b, s), np.int32)
        pos[:] = 0
        for row in range(b):
            start, doc = 0, 1
            while True:
                n = rng.randint(5, 41)
                if start + n > s - 6:
                    break
                seg[row, start:start + n] = doc
                pos[row, start:start + n] = np.arange(n)
                start, doc = start + n, doc + 1
    shards = lambda x: None if x is None else torch.tensor(x.reshape(b * cp, s_loc))  # noqa: E731
    return shards(pos), shards(seg)


def _rotate(x, cp, step):
    """The kv ids that shard r holds at ring step ``step``: shard (r - step) mod cp's."""
    return None if x is None else x.unflatten(0, (-1, cp)).roll(step, 1).flatten(0, 1)


@pytest.mark.parametrize("name", list(RING_LAYOUTS))
def test_tile_class_agrees_with_allowed_mask(name):
    """At every ring step of each layout, a skipped tile holds no allowed pair and a full
    tile holds only allowed pairs and lies inside Sq / Skv, for the forward's and the
    backward's tile shapes."""
    case = RING_LAYOUTS[name]
    cp, s_loc, causal, window = case["cp"], case["s_loc"], case["causal"], case.get("window")
    pos, seg = _ring_ids(len(name), **case)
    seen = set()
    for step in range(cp):
        pkv, skv = _rotate(pos, cp, step), _rotate(seg, cp, step)
        allowed = trc.allowed_mask(pos, pkv, seg, skv, causal, window)
        if allowed is None:
            allowed = torch.ones(pos.shape[0], s_loc, s_loc, dtype=torch.bool)
        for bq, bk in ((16, 16), (8, 16)):
            cls = trc.tile_classes(pos, pkv, seg, skv, causal, window, bq, bk)
            assert cls.shape == (pos.shape[0], -(-s_loc // bq), -(-s_loc // bk))
            for r, i, j in np.ndindex(*cls.shape):
                tile = allowed[r, i * bq:(i + 1) * bq, j * bk:(j + 1) * bk]
                c = int(cls[r, i, j])
                seen.add(c)
                if c == trc.SKIP:
                    assert not tile.any(), (step, r, i, j)
                elif c == trc.FULL:
                    assert tile.all() and tile.shape == (bq, bk), (step, r, i, j)
    # every layout has tiles that need their masks; the contiguous causal ring also skips
    # and runs unmasked tiles, the non-causal one only runs unmasked (or ragged) tiles
    want = {"non_causal": {trc.FULL}, "ragged": {trc.SKIP, trc.PARTIAL, trc.FULL},
            "contiguous_causal": {trc.SKIP, trc.PARTIAL, trc.FULL}}.get(name)
    assert trc.PARTIAL in seen or name == "non_causal"
    if want is not None:
        assert seen == want


def test_tile_class_counts_of_contiguous_causal_shards():
    """cp 8 contiguous causal shards of 4096 rows at 128 x 128 tiles: the diagonal step
    classes 496 tiles skip, 32 partial and 496 full of each shard's 1024; at step t >= 1
    shard r's chunk is wholly skipped for r < t and wholly full otherwise."""
    cp, s_loc = 8, 4096
    pos = torch.arange(cp * s_loc, dtype=torch.int32).view(cp, s_loc)
    for step in range(cp):
        cls = trc.tile_classes(pos, _rotate(pos, cp, step), None, None, True, None, 128, 128)
        assert cls.shape == (cp, 32, 32)
        for r in range(cp):
            counts = [int((cls[r] == c).sum()) for c in (trc.SKIP, trc.PARTIAL, trc.FULL)]
            if step == 0:
                assert counts == [496, 32, 496]
            else:
                assert counts == ([1024, 0, 0] if r < step else [0, 0, 1024]), (step, r)


@pytest.mark.parametrize("block_q, want", [(128, [28, 15, 21]), (64, [56, 23, 49])])
def test_tile_class_counts_of_a_ragged_chunk(block_q, want):
    """cp 3 contiguous causal shards of 1000 rows (chip_smoke's ring case f) at the
    diagonal step: the ragged last kv tile is skipped by every earlier q tile, and the
    ragged tiles below the diagonal are partial, never full."""
    pos = torch.arange(3 * 1000, dtype=torch.int32).view(3, 1000)
    cls = trc.tile_classes(pos, pos, None, None, True, None, block_q, 128)
    for r in range(3):
        assert [int((cls[r] == c).sum()) for c in (trc.SKIP, trc.PARTIAL, trc.FULL)] == want
    assert (cls[:, :-1 if block_q == 128 else -2, -1] == trc.SKIP).all()


@pytest.mark.parametrize("ids, block, lo, hi", [
    ([[5, 6, 7]], 2, [[5, 7]], [[6, 7]]),
    ([[-3, 9, 2**31 - 1]], 2, [[-3, 2**31 - 1]], [[9, 2**31 - 1]]),
    ([[4, -2**31]], 4, [[-2**31]], [[4]]),
])
def test_tile_ranges_leave_rows_past_s_out(ids, block, lo, hi):
    """A tile's (lo, hi) counts only its rows inside S, whatever int32 ids they hold."""
    got = trc._tile_ranges(torch.tensor(ids, dtype=torch.int32), block)
    assert got[0].tolist() == lo and got[1].tolist() == hi


@pytest.mark.parametrize("causal,window,q,kv,want", [
    (True, None, (0, 127, None, None, False), (128, 255, None, None, False), trc.SKIP),
    (True, None, (128, 255, None, None, False), (0, 127, None, None, False), trc.FULL),
    (True, None, (128, 255, None, None, True), (0, 127, None, None, False), trc.PARTIAL),
    (True, None, (0, 127, None, None, False), (0, 127, None, None, False), trc.PARTIAL),
    (True, 64, (256, 383, None, None, False), (0, 127, None, None, False), trc.SKIP),
    (False, 200, (256, 383, None, None, False), (128, 255, None, None, False), trc.PARTIAL),
    (False, 300, (256, 383, None, None, False), (128, 255, None, None, False), trc.FULL),
    (True, None, (500, 900, 2, 2, False), (0, 300, 2, 2, False), trc.FULL),
    (True, None, (500, 900, 2, 3, False), (0, 300, 2, 2, False), trc.PARTIAL),
    (True, None, (500, 900, 3, 4, False), (0, 300, 1, 2, False), trc.SKIP),
])
def test_tile_class_rule(causal, window, q, kv, want):
    """The rule on ranges: causal, window and segment skips; full only when every pair
    is allowed and no tile is ragged."""
    assert int(trc.tile_class(q, kv, causal, window)) == want


@pytest.mark.parametrize("name", list(CASES))
def test_split_plain_versions_match_chunk_bwd_kernel(name):
    """The deterministic route's plain versions, dq and (dk, dv) apart, against JAX's
    _chunk_bwd_kernel (interpret mode) at both chunks of the case."""
    case = CASES[name]
    q, ks, vs, do, pos_q, pos, seg_q, seg = _inputs(len(name) + 7, **case)
    kw = _kw(case)
    bn, s = q.shape[:2]
    rng = np.random.RandomState(4)
    lse = (rng.randn(bn, s) + 4).astype(np.float32)
    delta = rng.randn(bn, s).astype(np.float32)
    for i in range(2):
        want = _jax_bwd(q, ks[i], vs[i], pos_q, pos[i], seg_q, seg[i], do, lse, delta, kw,
                        case.get("block", 16))
        args = (_t(q), _t(ks[i]), _t(vs[i]), _t(pos_q), _t(pos[i]), _t(seg_q), _t(seg[i]),
                _t(do), _t(lse), _t(delta))
        got = (trc.chunk_attention_dq_reference(*args, **kw),
               *trc.chunk_attention_dkv_reference(*args, **kw))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)


@pytest.fixture
def deterministic():
    """Sets torch.use_deterministic_algorithms for a test and restores it afterwards."""
    before = torch.are_deterministic_algorithms_enabled()
    yield torch.use_deterministic_algorithms
    torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("flag", [False, True], ids=["default", "deterministic"])
def test_backward_route_follows_the_deterministic_flag(flag, monkeypatch, deterministic):
    """CPU tensors take the route's plain versions (bwd, or dq then dkv under the flag)
    with the same sums; a tensor off the CPU takes ring_bwd, or ring_dq and ring_dkv
    under the flag (the launches recorded, the checks stubbed)."""
    case = CASES["gqa_segments"]
    q, ks, vs, do, pos_q, pos, seg_q, seg = _inputs(9, **case)
    kw = _kw(case)
    bn, s = q.shape[:2]
    lse, delta = torch.randn(bn, s) + 4, torch.randn(bn, s)
    args = (_t(q), _t(ks[0]), _t(vs[0]), _t(pos_q), _t(pos[0]), _t(seg_q), _t(seg[0]), _t(do),
            lse, delta)
    want = trc.chunk_attention_bwd_reference(*args, **kw)
    plain = []
    for fn in ("chunk_attention_bwd_reference", "chunk_attention_dq_reference",
               "chunk_attention_dkv_reference"):
        real = getattr(trc, fn)
        monkeypatch.setattr(trc, fn, lambda *a, _f=fn, _r=real, **k: plain.append(_f) or _r(*a, **k))
    deterministic(flag)
    out = [torch.zeros(bn, s, case["d"]), torch.zeros(ks[0].shape), torch.zeros(vs[0].shape)]
    trc.chunk_attention_bwd(*args, *out, **kw)
    assert plain == (["chunk_attention_dq_reference", "chunk_attention_dkv_reference"] if flag
                     else ["chunk_attention_bwd_reference"])
    for got, w in zip(out, want):
        torch.testing.assert_close(got, w, atol=1e-6, rtol=0)

    launched = []
    monkeypatch.setattr(trc, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(trc, "ring_bwd", lambda *a, **k: launched.append(("ring_bwd", a[10])))
    monkeypatch.setattr(trc, "ring_dq", lambda *a, **k: launched.append(("ring_dq", a[10])))
    monkeypatch.setattr(trc, "ring_dkv", lambda *a, **k: launched.append(("ring_dkv", a[10])))
    meta = [x.to("meta") for x in (*args, *out)]
    trc.chunk_attention_bwd(*meta, **kw)
    dq, dk = meta[10], meta[11]
    assert launched == ([("ring_dq", dq), ("ring_dkv", dk)] if flag else [("ring_bwd", dq)])


def test_ring_dkv_and_ring_dq_launch_their_own_entry_points(monkeypatch):
    """ring_dkv launches its own C entry point (ring_bwd's kernel without dQ) with no dq
    argument, counted under its own name; ring_dq passes dq, f32, in place."""
    calls = []
    monkeypatch.setattr(build, "launch", lambda source, name, device, *args: calls.append(
        (name, args)))
    case = CASES["causal"]
    q, ks, vs, do, pos_q, pos, _, _ = _inputs(1, **case)
    kw = _kw(case)
    bn, s = q.shape[:2]
    rows = torch.zeros(bn, s)
    dq, dk, dv = torch.zeros(bn, s, 16), torch.zeros(ks[0].shape), torch.zeros(vs[0].shape)
    args = (_t(q), _t(ks[0]), _t(vs[0]), _t(pos_q), _t(pos[0]), None, None, _t(do), rows, rows)
    before = dict(trc.LAUNCHES)
    trc.ring_dkv(*args, dk, dv, **kw)
    trc.ring_dq(*args, dq, **kw)
    (name_b, args_b), (name_q, args_q) = calls
    assert (name_b, args_b[10], args_b[11]) == ("ring_dkv", dk.data_ptr(), dv.data_ptr())
    assert (name_q, args_q[10]) == ("ring_dq", dq.data_ptr())
    assert {n: trc.LAUNCHES[n] - before[n] for n in before} == {
        "ring_fwd": 0, "ring_bwd": 0, "ring_dkv": 1, "ring_dq": 1}
    for name, a in calls:
        assert len(a) + 1 == len(build.SOURCES["ring_chunk.cu"][name])


@pytest.mark.parametrize("dims, ok", [((64, 64), True), ((128, 128), True), ((192, 128), True),
                                      ((96, 64), False), ((192, 192), False), ((96, 96), False)])
def test_head_dim_pairs_the_kernels_take(dims, ok):
    """The kernel route's check (``_check_cuda`` calls it after the device and dtype
    checks): the three instantiated (D, Dv) pairs pass, any other raises
    NotImplementedError, so nothing falls back to the plain version."""
    if ok:
        trc.check_head_dims(*dims)
    else:
        with pytest.raises(NotImplementedError, match="take \\(D, Dv\\)"):
            trc.check_head_dims(*dims)


def test_dv_below_d_takes_the_split_backward(monkeypatch, deterministic):
    """At Dv != D the backward runs ring_dq + ring_dkv whatever the deterministic flag
    says (the fused ring_bwd is Dv == D only, and refuses (192, 128) itself); on the CPU
    the split plain versions, with the fused plain version's sums."""
    case = CASES["mla_dv_segments"]
    q, ks, vs, do, pos_q, pos, seg_q, seg = _inputs(5, **case)
    kw = _kw(case)
    bn, s = q.shape[:2]
    lse, delta = torch.randn(bn, s) + 4, torch.randn(bn, s)
    args = (_t(q), _t(ks[0]), _t(vs[0]), _t(pos_q), _t(pos[0]), _t(seg_q), _t(seg[0]), _t(do),
            lse, delta)
    want = trc.chunk_attention_bwd_reference(*args, **kw)
    deterministic(False)
    plain = []
    for fn in ("chunk_attention_bwd_reference", "chunk_attention_dq_reference",
               "chunk_attention_dkv_reference"):
        real = getattr(trc, fn)
        monkeypatch.setattr(trc, fn, lambda *a, _f=fn, _r=real, **k: plain.append(_f) or _r(*a, **k))
    out = [torch.zeros(bn, s, case["d"]), torch.zeros(ks[0].shape), torch.zeros(vs[0].shape)]
    trc.chunk_attention_bwd(*args, *out, **kw)
    assert plain == ["chunk_attention_dq_reference", "chunk_attention_dkv_reference"]
    for got, w in zip(out, want):
        torch.testing.assert_close(got, w, atol=1e-6, rtol=0)

    launched = []
    monkeypatch.setattr(trc, "_check_cuda", lambda *a, **k: None)
    for fn in ("ring_bwd", "ring_dq", "ring_dkv"):
        monkeypatch.setattr(trc, fn, lambda *a, _f=fn, **k: launched.append(_f))
    trc.chunk_attention_bwd(*[x.to("meta") for x in (*args, *out)], **kw)
    assert launched == ["ring_dq", "ring_dkv"]
    monkeypatch.undo()
    with pytest.raises(NotImplementedError, match="ring_bwd takes Dv == D"):
        trc.ring_bwd(*[x.to("meta") for x in (*args, *out)], **kw)


def test_launches_are_counted_by_head_dims(monkeypatch):
    """The wrappers pass Dv beside D to the C entry points and count each launch under
    its kernel and under "kernel/d{D}v{Dv}"; the backward's q tile is 32 rows at Dv != D."""
    calls = []
    monkeypatch.setattr(build, "launch", lambda source, name, device, *args: calls.append(
        (name, args)))
    b, s, h, d, dv = 1, 64, 4, 192, 128
    q, k = torch.zeros(b * h, s, d), torch.zeros(b * h, s, d)
    v, do = torch.zeros(b * h, s, dv), torch.zeros(b * h, s, dv)
    pos, rows = torch.zeros(b, s, dtype=torch.int32), torch.zeros(b * h, s)
    kw = dict(scale=0.1, causal=True, window=None, groups=1, n_heads=h)
    before, dims_before = dict(trc.LAUNCHES), dict(trc.DIM_LAUNCHES)
    trc.ring_fwd(q, k, v, pos, pos, None, None, torch.zeros(b * h, s, dv), rows, rows, **kw)
    trc.ring_dq(q, k, v, pos, pos, None, None, do, rows, rows, torch.zeros(q.shape), **kw)
    trc.ring_dkv(q, k, v, pos, pos, None, None, do, rows, rows, torch.zeros(k.shape),
                 torch.zeros(v.shape), **kw)
    for name, args in calls:
        argtypes = build.SOURCES["ring_chunk.cu"][name]
        d_at = [i for i, t in enumerate(argtypes) if t is build._F][0] - 2  # D, Dv, scale
        assert (args[d_at], args[d_at + 1]) == (d, dv), name
    assert {n: trc.LAUNCHES[n] - before[n] for n in before} == {
        "ring_fwd": 1, "ring_bwd": 0, "ring_dkv": 1, "ring_dq": 1}
    assert {n: trc.DIM_LAUNCHES[n] - dims_before.get(n, 0) for n in trc.DIM_LAUNCHES
            if trc.DIM_LAUNCHES[n] != dims_before.get(n, 0)} == {
        "ring_fwd/d192v128": 1, "ring_dq/d192v128": 1, "ring_dkv/d192v128": 1}
    assert "ring_bwd/d192v128" not in trc.DIM_LAUNCHES
    assert (trc.bwd_block_q(64, 64), trc.bwd_block_q(128, 128), trc.bwd_block_q(192, 128)) == (
        64, 64, 32)
