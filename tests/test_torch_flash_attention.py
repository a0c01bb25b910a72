"""The port's flash attention against the JAX package's Pallas kernels.

On the CPU the port's wrapper runs the kernels' plain version; the JAX side runs
the Pallas kernels in interpret mode with 32x32 blocks, as tests/unit/
test_flash_attention.py does, with the fused backward and with the split one.
Inputs come from numpy seeds. Tolerances, f32 throughout: 2e-5 on O and lse,
1e-4 on the gradients. The CUDA kernels themselves are checked on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops.pallas import flash_attention as jfa
from automodel_tpu_torch.ops import flash_attention as tfa

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
    """Window, soft-cap and sinks exist in the plain version only (the CUDA kernels
    raise on them); they still match the Pallas kernel, forward and gradients."""
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
    (dict(sliding_window=8), NotImplementedError),
    (dict(logit_soft_cap=1.0), NotImplementedError),
    (dict(sinks=torch.zeros(2)), NotImplementedError),
    (dict(), ValueError),  # not a CUDA tensor
])
def test_non_cpu_tensors_never_fall_back(kw, err):
    """A tensor off the CPU goes to the kernels or raises: never to the plain version."""
    q = torch.empty(1, 64, 2, 64, dtype=torch.bfloat16, device="meta")
    before = dict(tfa.LAUNCHES)
    with pytest.raises(err):
        tfa.flash_attention(q, q, q, **kw)
    assert tfa.LAUNCHES == before
