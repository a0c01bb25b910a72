"""The port's GPT-OSS against the JAX package's, f32: a 4-layer stack (sliding, full,
sliding, full; window 12 on sequences of 64, so the window is shorter than every
sequence and no multiple of a tile), hidden 64, 4 heads, 2 kv heads, head_dim 16, 8
experts top-2, YaRN RoPE as the published config sets it. Weights are built in JAX, the
biases (q, k, v, o, router, experts) and sinks set to nonzero random values from a numpy
seed, and carried across with params_from_jax. Under "xla" (both sides' einsum path) and
"flash" (the port's plain version on the CPU against JAX's Pallas kernel in interpret
mode): logits, the aux loss and every parameter's gradient (sinks and biases included)
agree to 1e-4 (absolute and relative, f32), and three steps of the train step (adamw,
2 microbatches) at the first two layers, 4 experts and rows of 32 give losses within
1e-4. Also: a full layer's window of None equals
JAX's window longer than any distance; the HF adapter round trip (interleaved
gate_up) through safetensors equals JAX's adapter; the ring guard (no ring for a layer
with sinks or in a stack with sliding layers) in both packages; YaRN against JAX's
rope_frequencies / rope_attention_scaling; and the GPT-OSS FLOP count."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.common import transformer as jtr
from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.gpt_oss.model import GptOssConfig as JaxGptOssConfig
from automodel_tpu.models.gpt_oss.model import GptOssForCausalLM as JaxGptOss
from automodel_tpu.models.gpt_oss.state_dict_adapter import GptOssStateDictAdapter as JaxAdapter
from automodel_tpu.ops import rope as jrope
from automodel_tpu.ops.losses import masked_cross_entropy as jax_ce
from automodel_tpu.optim.builder import build_optimizer as jax_build_optimizer
from automodel_tpu.optim.scheduler import build_lr_schedule as jax_schedule
from automodel_tpu.parallel.mesh import MeshContext as JaxMesh
from automodel_tpu.parallel.mesh import default_sharding_rules
from automodel_tpu.training.train_step import make_train_step as jax_make_train_step
from automodel_tpu.utils.flops import flops_per_token as jax_flops_per_token
from automodel_tpu_torch.checkpoint.safetensors_io import load_safetensors, save_safetensors
from automodel_tpu_torch.models.auto import AutoModelForCausalLM
from automodel_tpu_torch.models.common import moe_transformer as tmoe
from automodel_tpu_torch.models.common import transformer as ttr
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.gpt_oss.model import GptOssConfig, GptOssForCausalLM
from automodel_tpu_torch.models.llama.convert import flatten, params_from_jax
from automodel_tpu_torch.models.registry import resolve_model_class
from automodel_tpu_torch.ops import rope as trope
from automodel_tpu_torch.ops.losses import masked_cross_entropy
from automodel_tpu_torch.optim.builder import build_optimizer
from automodel_tpu_torch.optim.scheduler import build_lr_schedule
from automodel_tpu_torch.parallel.mesh import MeshContext
from automodel_tpu_torch.training.train_step import make_train_step
from automodel_tpu_torch.utils.flops import flops_per_token
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

YARN = {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0, "beta_slow": 1.0,
        "truncate": False, "original_max_position_embeddings": 4096}
HF = dict(architectures=["GptOssForCausalLM"], vocab_size=128, hidden_size=64,
          intermediate_size=32, num_hidden_layers=4, num_attention_heads=4,
          num_key_value_heads=2, head_dim=16, num_local_experts=8, num_experts_per_tok=2,
          sliding_window=12, layer_types=["sliding_attention", "full_attention"] * 2,
          max_position_embeddings=256, rope_theta=150000.0, rope_scaling=YARN,
          swiglu_limit=7.0, attention_bias=True, tie_word_embeddings=False,
          rms_norm_eps=1e-5, router_aux_loss_coef=0.9)
# the three-step test's stack: the first sliding and the first full layer, 4 experts
HF_TWO_LAYERS = dict(HF, num_hidden_layers=2, layer_types=HF["layer_types"][:2],
                     num_local_experts=4)
S = 64
ATTENTION = {"xla": ("xla", "xla"), "flash": ("flash_interpret", "flash")}
TOL = 1e-4


def _biased(params, seed=1):
    """JAX's init (biases and sinks at 0) with every bias and sink set to random values."""
    rng = np.random.RandomState(seed)
    out = jax.tree.map(np.asarray, params)
    layers, moe = out["moe_layers"], out["moe_layers"]["moe"]
    for tree, name, scale in ((layers, "bq", 0.2), (layers, "bk", 0.2), (layers, "bv", 0.2),
                              (layers, "bo", 0.2), (layers, "sinks", 1.0),
                              (moe["gate"], "bias", 0.5), (moe["experts"], "gate_up_bias", 0.2),
                              (moe["experts"], "down_bias", 0.2)):
        tree[name] = (rng.randn(*tree[name].shape) * scale).astype(np.float32)
    return out


def _jax_params(hf=HF, seed=0):
    model = JaxGptOss.from_config(hf, JaxBackend(dtype="float32", remat_policy="full"))
    return _biased(jax.device_get(model.init(jax.random.key(seed))))


def _batch(seed=0, b=2, s=S):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, (b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    seg[0, s // 2:] = 2  # two packed sequences in row 0
    seg[1, s - 6:] = 0  # right padding in row 1
    pos = np.concatenate([np.arange(s // 2), np.arange(s // 2)])[None].repeat(b, 0)
    pos[1] = np.arange(s)
    return ids, pos.astype(np.int32), seg


def _port(hf, params, attention="xla", remat_policy="mlp_dots", **backend):
    tm = GptOssForCausalLM.from_config(
        hf, BackendConfig(dtype="float32", remat_policy=remat_policy, attention=attention,
                          experts_backend="ragged_dot", **backend), device="cpu")
    tm.load_params(params_from_jax(params, tm.config))
    return tm


def test_from_hf_matches_jax():
    published = dict(HF, vocab_size=201088, hidden_size=2880, intermediate_size=2880,
                     num_hidden_layers=24, num_attention_heads=64, num_key_value_heads=8,
                     head_dim=64, num_local_experts=32, num_experts_per_tok=4,
                     sliding_window=128, max_position_embeddings=131072,
                     layer_types=["sliding_attention", "full_attention"] * 12)
    for hf in (HF, published, dict(HF, attention_bias=False, layer_types=None)):
        got, want = GptOssConfig.from_hf(hf), JaxGptOssConfig.from_hf(hf)
        assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
        for f in dataclasses.fields(got):
            if f.name != "moe":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.sliding_flags == want.sliding_flags
    assert resolve_model_class("GptOssForCausalLM") is GptOssForCausalLM
    assert ttr.layer_windows(GptOssConfig.from_hf(HF)) == [12, None, 12, None]


def test_params_from_jax_carries_biases_and_sinks():
    cfg = GptOssConfig.from_hf(HF)
    params = _jax_params()
    flat = params_from_jax(params, cfg)
    assert flat["moe_layers.bq"].shape == (4, 4, 16) and flat["moe_layers.bk"].shape == (4, 2, 16)
    assert flat["moe_layers.bo"].shape == (4, 64) and flat["moe_layers.sinks"].shape == (4, 4)
    assert flat["moe_layers.moe.gate.bias"].shape == (4, 8)
    assert flat["moe_layers.moe.experts.gate_up_bias"].shape == (4, 8, 64)
    assert flat["moe_layers.moe.experts.down_bias"].shape == (4, 8, 64)
    model = GptOssForCausalLM(cfg, device="cpu")
    assert set(model.param_dict()) == set(flat)
    # the port's init: biases and sinks at zero, as JAX's
    jinit = jax.device_get(JaxGptOss.from_config(HF).init(jax.random.key(0)))
    for name, value in flatten(jinit).items():
        if name.rsplit(".", 1)[-1] in ("bq", "bk", "bv", "bo", "sinks", "bias", "gate_up_bias",
                                       "down_bias"):
            assert not np.any(value) and not model.param_dict()[name].any(), name
    model.load_params(flat)
    np.testing.assert_array_equal(model.param_dict()["moe_layers.sinks"].detach().numpy(),
                                  params["moe_layers"]["sinks"])


def _jax_loss_fn(hf, attention, ids, pos, seg, ct):
    jm = JaxGptOss.from_config(hf, JaxBackend(dtype="float32", remat_policy="full",
                                              attention=attention,
                                              experts_backend="ragged_dot"))

    def loss(p):
        logits, stats = jm(p, jnp.asarray(ids), positions=jnp.asarray(pos),
                           segment_ids=jnp.asarray(seg), token_mask=jnp.asarray(seg != 0))
        return jnp.sum(logits * ct) + stats["aux_loss"], (logits, stats)

    return loss


@pytest.mark.parametrize("attention", list(ATTENTION))
def test_logits_loss_and_grads_match_jax(attention):
    """Every gradient, the sinks', the biases', the router bias' and the expert biases'
    included, under xla and under flash (interpret / plain version)."""
    params = _jax_params()
    ids, pos, seg = _batch()
    ct = np.random.RandomState(2).randn(*ids.shape, 128).astype(np.float32)
    (jloss, (jlogits, jstats)), jgrads = jax.value_and_grad(
        _jax_loss_fn(HF, ATTENTION[attention][0], ids, pos, seg, ct), has_aux=True)(
        jax.tree.map(jnp.asarray, params))

    tm = _port(HF, params, ATTENTION[attention][1], attention_segments=True)
    logits, stats = tm(torch.tensor(ids), positions=torch.tensor(pos),
                       segment_ids=torch.tensor(seg), token_mask=torch.tensor(seg != 0))
    loss = (logits * torch.tensor(ct)).sum() + stats["aux_loss"]
    names = list(tm.param_dict())
    grads = torch.autograd.grad(loss, list(tm.param_dict().values()))

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    np.testing.assert_allclose(stats["aux_loss"].item(), float(jstats["aux_loss"]), rtol=1e-5)
    np.testing.assert_array_equal(stats["expert_load"].numpy(), np.asarray(jstats["expert_load"]))
    jflat = flatten(jgrads)
    for name in ("moe_layers.sinks", "moe_layers.bq", "moe_layers.bo",
                 "moe_layers.moe.gate.bias", "moe_layers.moe.experts.gate_up_bias",
                 "moe_layers.moe.experts.down_bias"):
        assert np.abs(np.asarray(jflat[name])).max() > 1e-3, name  # a gradient that is tested
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jflat[n]), atol=TOL, rtol=TOL,
                                   err_msg=n)


def _train_batches(n_steps=3, grad_acc=2, s=S):
    out = []
    for step in range(n_steps):
        micro = [_batch(seed=10 * step + m, s=s) for m in range(grad_acc)]
        ids = np.stack([m[0] for m in micro])
        labels = np.where(np.stack([m[2] for m in micro]) != 0, np.roll(ids, -1, -1), -100)
        out.append({"input_ids": ids, "positions": np.stack([m[1] for m in micro]),
                    "segment_ids": np.stack([m[2] for m in micro]),
                    "labels": labels.astype(np.int32)})
    return out


SCHED = dict(max_lr=3e-3, min_lr=3e-4, lr_warmup_steps=2, lr_decay_steps=3)
OPT = dict(optimizer="adamw", weight_decay=0.1, max_grad_norm=0.5, eps=1e-5)


@pytest.mark.parametrize("attention", list(ATTENTION))
def test_three_steps_match_jax(attention):
    """Three steps of the train step (cross entropy plus the aux loss, 2 microbatches,
    adamw with clipping): the losses and gradient norms of both packages, on the stack's
    first two layers (one sliding, one full) with 4 experts (top-2), rows of 32."""
    hf = HF_TWO_LAYERS
    params = _jax_params(hf)
    coef = hf["router_aux_loss_coef"]
    batches = _train_batches(s=32)  # rows of 32: still longer than the window of 12
    jm = JaxGptOss.from_config(hf, JaxBackend(dtype="float32", remat_policy="full",
                                              attention=ATTENTION[attention][0],
                                              experts_backend="ragged_dot",
                                              attention_segments=True))

    def jax_forward_loss(p, batch, n):
        logits, stats = jm(p, batch["input_ids"], positions=batch["positions"],
                           segment_ids=batch["segment_ids"],
                           token_mask=batch["segment_ids"] != 0)
        return jax_ce(logits, batch["labels"], n) + coef * stats["aux_loss"]

    opt = jax_build_optimizer(lr=jax_schedule(**SCHED), betas=(0.9, 0.95), **OPT)
    step = jax.jit(jax_make_train_step(jax_forward_loss, opt))
    jp, state, jax_metrics = jax.tree.map(jnp.asarray, params), None, []
    state = opt.init(jp)
    for batch in batches:
        jp, state, m = step(jp, state, {k: jnp.asarray(v) for k, v in batch.items()})
        jax_metrics.append({k: float(v) for k, v in m.items()})

    tm = _port(hf, params, ATTENTION[attention][1], attention_segments=True)
    tparams = tm.param_dict()

    def forward_loss(batch, n):
        logits, stats = tm(batch["input_ids"], positions=batch["positions"],
                           segment_ids=batch["segment_ids"],
                           token_mask=batch["segment_ids"] != 0)
        return masked_cross_entropy(logits, batch["labels"], n) + coef * stats["aux_loss"]

    topt = build_optimizer(lr=build_lr_schedule(**SCHED), betas=(0.9, 0.95), **OPT)
    tstep = make_train_step(forward_loss, tparams, topt)
    tstate = topt.init(tparams)
    for batch, jmet in zip(batches, jax_metrics):
        tstate, m = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(m["loss"]) == pytest.approx(jmet["loss"], abs=TOL)
        assert float(m["grad_norm"]) == pytest.approx(jmet["grad_norm"], rel=TOL)
    want = params_from_jax(jax.device_get(jp), tm.config)
    for key, ref in want.items():
        err = (tparams[key].detach() - ref).abs().max() / ref.abs().max().clamp_min(1e-12)
        assert err <= 1e-3, f"{key}: relative error {err:.2e}"


def test_full_layer_without_window_equals_jax_long_window(monkeypatch):
    """A full layer passes no window (the unwindowed kernels); JAX's carries one longer
    than any distance (max_position_embeddings + S): the logits are the same."""
    params = _jax_params()
    ids, pos, seg = _batch()
    base = _port(HF, params, "flash")(torch.tensor(ids), positions=torch.tensor(pos),
                                      segment_ids=torch.tensor(seg))[0]
    long = HF["max_position_embeddings"] + S
    monkeypatch.setattr(tmoe, "layer_windows",
                        lambda cfg: [12 if f else long for f in cfg.sliding_flags])
    windowed = _port(HF, params, "flash")(torch.tensor(ids), positions=torch.tensor(pos),
                                          segment_ids=torch.tensor(seg))[0]
    np.testing.assert_allclose(windowed.detach().numpy(), base.detach().numpy(), atol=1e-6,
                               rtol=0)


def test_hf_adapter_round_trip_matches_jax(tmp_path):
    """HF tensors from the port's adapter, written and read back through safetensors,
    equal JAX's adapter's (interleaved gate_up and its bias), load back bitwise, and a
    directory with them loads through AutoModelForCausalLM."""
    import json

    cfg = GptOssConfig.from_hf(HF)
    params = _jax_params()
    flat = params_from_jax(params, cfg)
    model = GptOssForCausalLM(cfg, device="cpu", params=flat)
    hf = model.state_dict_adapter().to_hf(flat)
    want = JaxAdapter(JaxGptOssConfig.from_hf(HF)).to_hf(params)
    assert set(hf) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(hf[key].numpy(), np.asarray(value), err_msg=key)
    gu = flat["moe_layers.moe.experts.gate_up_proj"][0]
    hf_gu = hf["model.layers.0.mlp.experts.gate_up_proj"]
    assert torch.equal(hf_gu[..., 0::2], gu[..., :32]) and torch.equal(hf_gu[..., 1::2], gu[..., 32:])
    save_safetensors(hf, str(tmp_path))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(HF, f)
    back = model.state_dict_adapter().from_hf(load_safetensors(str(tmp_path)))
    assert set(back) == set(flat)
    for key, value in flat.items():
        assert torch.equal(back[key], value), key
    loaded = AutoModelForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    assert isinstance(loaded, GptOssForCausalLM)
    for key, value in loaded.param_dict().items():
        assert torch.equal(value.detach(), flat[key]), key
    quantized = dict(hf, **{"model.layers.0.mlp.experts.down_proj_blocks": torch.zeros(1)})
    with pytest.raises(NotImplementedError, match="down_proj_blocks"):
        model.state_dict_adapter().from_hf(quantized)


GUARD_CASES = {
    "sinks": dict(attention_sinks=True),
    "window": dict(sliding_window=8),
    # the first (full) layer of a mixed stack
    "mixed_full_layer": dict(sliding_window=8, num_hidden_layers=2,
                             layer_types=["full_attention", "sliding_attention"]),
    "neither": dict(),
    # Phi-3's geometry under cp 4 (phi3_longrope_128k.yaml): head_dim 96, heads 32 / 32 cut
    # to 4 / 4, and a window (phi3_proxy.yaml's 2047), so ordinary attention in both
    "phi3_d96_window": dict(head_dim=96, num_key_value_heads=4, sliding_window=2047),
}


@pytest.fixture(scope="module")
def cp_mesh():
    return JaxMesh(cp=4, dp_shard=2, world_size=8).build_mesh(jax.devices())


class _RingTaken(Exception):
    pass


def _no_ring(*args, **kw):
    raise _RingTaken


@pytest.mark.parametrize("name", list(GUARD_CASES))
def test_ring_guard_matches_jax(name, cp_mesh, monkeypatch):
    """With context_parallel ring and a cp axis of 4, a layer with sinks, or any layer
    of a stack with a sliding layer (the full layer of a mixed stack too, and Phi-3's
    (96, 96) layers, which carry a window), runs ordinary attention in both packages; a
    layer with neither takes the ring in both."""
    from automodel_tpu.parallel import ring_attention as jra

    kw = dict(dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=16),
              **GUARD_CASES[name])
    jcfg, tcfg = jtr.DenseDecoderConfig(**kw), ttr.DenseDecoderConfig(**kw)
    rng = np.random.RandomState(3)
    lp = {n: (rng.randn(*s) * 0.2).astype(np.float32) for n, s in ttr.layer_shapes(tcfg).items()
          if n in ("wq", "wk", "wv", "wo", "sinks")}
    x = rng.randn(2, 32, 32).astype(np.float32)
    pos = np.arange(32)[None].repeat(2, 0).astype(np.int32)
    window = ttr.layer_windows(tcfg)[0]
    any_sliding = any(jcfg.sliding_flags)
    jwindow = (None if not any_sliding else jnp.int32(window or 10_000))
    head_dim = kw["head_dim"]
    monkeypatch.setattr(jra, "make_ring_attention", _no_ring)
    monkeypatch.setattr(ttr, "make_ring_attention", _no_ring)
    taken = {}
    rules = default_sharding_rules().with_mesh(cp_mesh)
    try:
        with jax.sharding.set_mesh(cp_mesh):
            jout = np.asarray(jax.jit(lambda lp, x: jtr._attention_block(
                jcfg, JaxBackend(dtype="float32", context_parallel="ring"), lp, x,
                jnp.asarray(pos), None, jrope.rope_frequencies(head_dim, 10000.0, None), 1.0,
                jwindow,
                rules))({k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(x)))
        taken["jax"] = False
    except _RingTaken:
        taken["jax"] = True
    try:
        tout = ttr.attention_block(
            tcfg, BackendConfig(dtype="float32", context_parallel="ring"),
            {k: torch.tensor(v) for k, v in lp.items()}, torch.tensor(x), torch.tensor(pos),
            None, trope.rope_frequencies(head_dim, 10000.0, None), 1.0, mesh=MeshContext(cp=4),
            window=window)
        taken["port"] = False
    except _RingTaken:
        taken["port"] = True
    assert taken == {"jax": name == "neither", "port": name == "neither"}
    if name != "neither":
        np.testing.assert_allclose(tout.numpy(), jout, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("scaling", [
    YARN,
    dict(YARN, truncate=True),
    dict(YARN, factor=4.0, beta_fast=16.0, beta_slow=2.0, original_max_position_embeddings=2048),
    dict(YARN, mscale=0.707, mscale_all_dim=0.707),
    dict(YARN, mscale=1.0, mscale_all_dim=0),  # truthiness: 0 falls through to the default
    dict(YARN, attention_factor=1.25),
    {"type": "yarn", "factor": 8.0},
], ids=["published", "truncate", "betas", "mscale", "mscale_all_dim_0", "attention_factor",
        "defaults"])
def test_yarn_matches_jax(scaling):
    for head_dim, theta in ((64, 150000.0), (16, 10000.0)):
        want = np.asarray(jrope.rope_frequencies(head_dim, theta, scaling))
        got = trope.rope_frequencies(head_dim, theta, scaling)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert trope.rope_attention_scaling(scaling) == pytest.approx(
        jrope.rope_attention_scaling(scaling), rel=1e-12)


def test_flops_count_gpt_oss():
    """Every attention layer counts the full S^2 term, the window ignored, as JAX counts
    it; the MLP counts the top-k experts (JAX's formula reads num_experts, which GPT-OSS's
    config does not have: given it, the two agree)."""
    published = dict(HF, vocab_size=201088, hidden_size=2880, intermediate_size=2880,
                     num_hidden_layers=4, num_attention_heads=64, num_key_value_heads=8,
                     head_dim=64, num_local_experts=32, num_experts_per_tok=4,
                     sliding_window=128, layer_types=["sliding_attention", "full_attention"] * 2)
    got = flops_per_token(published, 2048)
    assert got == jax_flops_per_token(dict(published, num_experts=32), 2048)
    d, n, k, h = 2880, 64, 8, 64
    attn = 2 * d * (n + 2 * k) * h + 2 * n * h * d + 4 * 2048 * n * h
    assert got == 3 * (4 * attn + 4 * 3 * 2 * d * 2880 * 4 + 2 * d * 201088)
    # a linear layer without a DeltaNet's widths counts as attention, as JAX counts it; a
    # mamba layer is not ported
    linear = dict(published, layer_types=["linear_attention"] * 4, num_experts=32)
    assert flops_per_token(linear, 2048) == jax_flops_per_token(linear, 2048) == got
    with pytest.raises(NotImplementedError, match="mamba"):
        flops_per_token(dict(published, layer_types=["mamba"] * 4), 2048)
    assert math.isclose(got, 3 * (4 * attn + 24 * d * 2880 * 4 + 2 * d * 201088))
