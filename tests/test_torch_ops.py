"""The port's plain ops against the JAX package on the same numpy inputs (f32):
norms, rope with llama3 scaling, attention's einsum path, masked and linear CE."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops import attention as jatt, losses as jloss, norms as jnorm, rope as jrope
from automodel_tpu_torch.ops import attention as tatt, losses as tloss, norms as tnorm, rope as trope
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

RNG = np.random.RandomState(0)
ATOL = 1e-5


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    x, w = RNG.randn(2, 5, 32).astype(np.float32), RNG.randn(32).astype(np.float32)
    want = np.asarray(jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, offset))
    got = tnorm.rms_norm(_t(x), _t(w), 1e-6, offset).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_layer_norm():
    x = RNG.randn(3, 16).astype(np.float32)
    w, b = RNG.randn(16).astype(np.float32), RNG.randn(16).astype(np.float32)
    want = np.asarray(jnorm.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(tnorm.layer_norm(_t(x), _t(w), _t(b)).numpy(), want,
                               atol=ATOL, rtol=1e-5)


LLAMA3 = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}


@pytest.mark.parametrize("scaling", [None, LLAMA3, {"rope_type": "linear", "factor": 4.0}],
                         ids=["default", "llama3", "linear"])
def test_rope(scaling):
    inv_j = np.asarray(jrope.rope_frequencies(64, 500000.0, scaling))
    inv_t = trope.rope_frequencies(64, 500000.0, scaling)
    np.testing.assert_allclose(inv_t.numpy(), inv_j, rtol=1e-6)
    assert trope.rope_attention_scaling(scaling) == jrope.rope_attention_scaling(scaling)
    x = RNG.randn(2, 12, 3, 64).astype(np.float32)
    pos = np.stack([np.arange(12), np.arange(100, 112)]).astype(np.int32)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv_j)))
    got = trope.apply_rope(_t(x), _t(pos), inv_t).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_rope_unported_scaling_raises():
    """A scaling type neither package computes (HF's dynamic NTK) raises; longrope is
    ported (tests/test_torch_phi3.py)."""
    dynamic = {"rope_type": "dynamic", "factor": 2.0}
    with pytest.raises(NotImplementedError):
        trope.rope_frequencies(64, 10000.0, dynamic)
    with pytest.raises(NotImplementedError):
        trope.rope_attention_scaling(dynamic)


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, segments=True),
    dict(causal=True, sliding_window=4),
    dict(causal=True, logit_soft_cap=3.0),
    dict(causal=True, sinks=True),
    dict(causal=True, positions=True),
], ids=["causal", "non_causal", "segments", "window", "soft_cap", "sinks", "positions"])
def test_attention_einsum_path(kw):
    kw = dict(kw)
    q = RNG.randn(2, 12, 4, 8).astype(np.float32)
    k, v = RNG.randn(2, 12, 2, 8).astype(np.float32), RNG.randn(2, 12, 2, 8).astype(np.float32)
    extra = {}
    if kw.pop("segments", False):
        seg = np.array([[1] * 6 + [2] * 6, [1] * 10 + [0] * 2], np.int32)
        extra["segment_ids_q"] = seg
    if kw.pop("sinks", False):
        extra["sinks"] = RNG.randn(4).astype(np.float32)
    if kw.pop("positions", False):
        extra["positions_q"] = np.stack([np.arange(12), np.arange(12)[::-1]]).astype(np.int32)
    want = np.asarray(jatt.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), backend="xla", **kw,
        **{n: jnp.asarray(a) for n, a in extra.items()}))
    got = tatt.dot_product_attention(_t(q), _t(k), _t(v), backend="xla", **kw,
                                     **{n: _t(a) for n, a in extra.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_attention_flash_dispatch_guards():
    """backend="flash" takes the kernel path only under the JAX guards; with
    positions (or a length not divisible by 8) it runs the einsum path."""
    q = torch.randn(1, 12, 2, 8)
    pos = torch.arange(12)[None]
    out = tatt.dot_product_attention(q, q, q, backend="flash", positions_q=pos)
    ref = tatt.dot_product_attention(q, q, q, backend="xla", positions_q=pos)
    torch.testing.assert_close(out, ref)


def _ce_inputs():
    logits = RNG.randn(2, 7, 50).astype(np.float32)
    labels = RNG.randint(0, 50, (2, 7)).astype(np.int32)
    labels[0, :3] = -100
    return logits, labels


@pytest.mark.parametrize("denom", [None, 20])
def test_masked_cross_entropy(denom):
    logits, labels = _ce_inputs()
    want = float(jloss.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), denom))
    got = float(tloss.masked_cross_entropy(_t(logits), _t(labels), denom))
    assert got == pytest.approx(want, abs=1e-5)
    lt = _t(logits).requires_grad_()
    tloss.masked_cross_entropy(lt, _t(labels), denom).backward()
    gj = jax.grad(lambda x: jloss.masked_cross_entropy(x, jnp.asarray(labels), denom))(
        jnp.asarray(logits))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gj), atol=1e-6)


def test_linear_cross_entropy_plain_version():
    h = RNG.randn(2, 8, 16).astype(np.float32)
    w = RNG.randn(16, 40).astype(np.float32)
    labels = RNG.randint(0, 40, (2, 8)).astype(np.int32)
    labels[1, 5:] = -100
    want = float(jloss.linear_cross_entropy(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
                                            impl="xla", block_size=4))
    got = float(tloss.linear_cross_entropy(_t(h), _t(w), _t(labels)))
    assert got == pytest.approx(want, abs=1e-5)
    # the Pallas kernel tiles the embed dim in 128s
    h2, w2 = RNG.randn(16, 128).astype(np.float32), RNG.randn(128, 256).astype(np.float32) * 0.1
    z_j, gold_j = jloss.fused_linear_ce_tokens(jnp.asarray(h2), jnp.asarray(w2),
                                               jnp.asarray(labels.reshape(-1)), interpret=True)
    z_t, gold_t = tloss.fused_linear_ce_tokens(_t(h2), _t(w2), _t(labels.reshape(-1)))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-4)
    valid = labels.reshape(-1) != -100
    np.testing.assert_allclose(gold_t.numpy()[valid], np.asarray(gold_j)[valid], atol=1e-4)


def test_linear_cross_entropy_raises_off_cpu():
    """A tensor off the CPU goes to the CUDA kernels' wrapper, whose checks raise for a
    device, dtype or shape it does not take; nothing falls back to the plain version."""
    h = torch.empty(4, 128, device="meta", dtype=torch.bfloat16)
    w = torch.empty(128, 16, device="meta", dtype=torch.bfloat16)
    labels = torch.zeros(4, dtype=torch.long, device="meta")
    with pytest.raises(ValueError, match="not a CUDA device"):
        tloss.linear_cross_entropy(h, w, labels)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tloss.fused_linear_ce_tokens(h, w, labels)
    from automodel_tpu_torch.ops import linear_ce

    with pytest.raises(ValueError, match="not a CUDA device"):
        linear_ce.fused_logsumexp(h.float(), w)


@pytest.mark.parametrize("qk_norm", [True, False], ids=["qk_norm", "plain"])
def test_attention_block_qk_norm_matches_jax(qk_norm):
    """The decoder's attention block with Qwen3's per-head q/k RMSNorm (weights of shape
    (head_dim,), applied before RoPE) against the JAX block: output and gradients."""
    from automodel_tpu.models.common import transformer as jtr
    from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
    from automodel_tpu_torch.models.common import transformer as ttr
    from automodel_tpu_torch.models.common.backend import BackendConfig

    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16, qk_norm=qk_norm,
              rms_norm_eps=1e-6, rope_theta=1e6)
    jcfg, tcfg = jtr.DenseDecoderConfig(**kw), ttr.DenseDecoderConfig(**kw)
    rng = np.random.RandomState(5)
    shapes = {n: s for n, s in ttr.layer_shapes(tcfg).items() if n in (
        "wq", "wk", "wv", "wo", "q_norm", "k_norm")}
    assert ("q_norm" in shapes) == qk_norm and shapes.get("q_norm", (16,)) == (16,)
    lp = {n: (rng.randn(*s) * (0.3 if n.endswith("norm") else 0.2)
              + (1.0 if n.endswith("norm") else 0.0)).astype(np.float32)
          for n, s in shapes.items()}
    x = rng.randn(2, 12, 32).astype(np.float32)
    pos = np.arange(12)[None].repeat(2, 0)
    ct = rng.randn(2, 12, 32).astype(np.float32)
    inv = jrope.rope_frequencies(16, 1e6, None)

    def jax_fn(lp, x):
        out = jtr._attention_block(jcfg, JaxBackend(dtype="float32"), lp, x, jnp.asarray(pos),
                                   None, inv, 1.0, None, None)
        return jnp.sum(out * ct), out

    (_, jout), jgrads = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(x))
    tlp = {k: torch.tensor(v, requires_grad=True) for k, v in lp.items()}
    tx = torch.tensor(x, requires_grad=True)
    out = ttr.attention_block(tcfg, BackendConfig(dtype="float32"), tlp, tx, _t(pos), None,
                              trope.rope_frequencies(16, 1e6, None), 1.0)
    grads = torch.autograd.grad((out * _t(ct)).sum(), [*tlp.values(), tx])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=ATOL, rtol=1e-5)
    for g, w in zip(grads, [jgrads[0][k] for k in tlp] + [jgrads[1]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
