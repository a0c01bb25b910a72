"""The port's gated DeltaNet op, Qwen3-Next and Qwen3.5-MoE against the JAX package's,
f32, weights and inputs from numpy seeds (``tests/torch_parity.py``).

- ``ops/gated_delta.py``: ``l2norm``, ``causal_conv1d`` (with and without packed
  segments), ``gated_rms_norm`` and ``chunk_gated_delta_rule`` (an initial state, the
  final state, S not a multiple of the chunk, the segment-start decay a packed row
  gets) equal JAX's to 1e-5, the rule's gradients too.
- ``from_hf`` equals JAX's reading on a tiny config, on ``qwen3_next_proxy.yaml``'s block
  (the ``full_attention_interval`` form), on Qwen3-Next-80B-A3B's published dict in
  ``chip_smoke.py`` and on a Qwen3.5-MoE ``text_config`` wrapper.
- A tiny Qwen3-Next (vocab 128, hidden 64, 4 layers: 3 DeltaNet (2 key heads of 8, 4
  value heads of 8) and 1 gated full-attention layer (4 heads of 16 over 2), 8 experts
  top-2 with the gated shared expert): logits, aux loss, expert load and every gradient
  under xla attention, atol 1e-4, on packed rows with padding; three train steps, losses
  within 1e-5.
- The HF adapters (Qwen3-Next's fused projections, Qwen3.5-MoE's separate ones and packed
  experts): JAX's keys and values, a bitwise round trip and a reload through
  ``from_pretrained``; ``logical_axes()`` equals JAX's.
- ``flops_per_token`` equals JAX's on every config, the proxy YAML's
  ``full_attention_interval`` form included (three DeltaNet layers a period).
- The profiler's per-scope times (``utils/tracing.py``): a scope counts its forward, its
  replay under a layer checkpoint, and the autograd nodes its ops made.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.qwen3_5_moe.model import Qwen3_5MoeForCausalLM as JaxQwen35
from automodel_tpu.models.qwen3_next.model import Qwen3NextConfig as JaxConfig
from automodel_tpu.models.qwen3_next.model import Qwen3NextForCausalLM as JaxNext
from automodel_tpu.ops import gated_delta as jgd
from automodel_tpu.utils.flops import flops_per_token as jax_flops
from automodel_tpu_torch.checkpoint.safetensors_io import save_safetensors
from automodel_tpu_torch.models.auto import AutoModelForCausalLM
from automodel_tpu_torch.models.llama.convert import flatten
from automodel_tpu_torch.models.qwen3_5_moe.model import Qwen3_5MoeConfig, Qwen3_5MoeForCausalLM
from automodel_tpu_torch.models.qwen3_next.model import Qwen3NextConfig, Qwen3NextForCausalLM
from automodel_tpu_torch.ops import gated_delta as tgd
from automodel_tpu_torch.utils import flops as tflops
from tests.torch_parity import (assert_forward_and_grads_match, batch, jax_tree, port_model,
                                trajectories)
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TINY = dict(architectures=["Qwen3NextForCausalLM"], vocab_size=128, hidden_size=64,
            intermediate_size=96, moe_intermediate_size=32, shared_expert_intermediate_size=48,
            num_hidden_layers=4, full_attention_interval=4, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, partial_rotary_factor=0.25, rope_theta=1e4,
            linear_num_value_heads=4, linear_num_key_heads=2, linear_key_head_dim=8,
            linear_value_head_dim=8, linear_conv_kernel_dim=4, num_experts=8,
            num_experts_per_tok=2, norm_topk_prob=True, router_aux_loss_coef=0.01)
QWEN35 = {"architectures": ["Qwen3_5MoeForConditionalGeneration"],
          "text_config": {k: v for k, v in TINY.items() if k != "architectures"}}


def _proxy():
    with open("examples/benchmark/qwen3_next_proxy.yaml") as f:
        return yaml.safe_load(f)["model"]["config"]


SOURCES = {"tiny": TINY, "layer_types": dict(TINY, layer_types=["linear_attention",
                                                                  "full_attention"] * 2),
           "proxy_yaml": _proxy(), "qwen3_next_80b": chip_smoke.QWEN3_NEXT_80B,
           "qwen3_5_moe": QWEN35}
T = 37  # a sequence that is not a multiple of the chunk (16)


def _rule_inputs(seed=0, b=2, h=3, dk=8, dv=6):
    rng = np.random.RandomState(seed)
    q, k = rng.randn(2, b, T, h, dk).astype(np.float32)
    v = rng.randn(b, T, h, dv).astype(np.float32)
    g = (-0.3 * np.abs(rng.randn(b, T, h))).astype(np.float32)
    g[0, 20] -= 50.0  # a packed row's second document starts at 20
    beta = (1 / (1 + np.exp(-rng.randn(b, T, h)))).astype(np.float32)
    state = rng.randn(b, h, dk, dv).astype(np.float32)
    return q, k, v, g, beta, state


def test_chunk_gated_delta_rule_matches_jax():
    args = _rule_inputs()
    ct = np.random.RandomState(1).randn(2, T, 3, 6).astype(np.float32)
    cs = np.random.RandomState(2).randn(2, 3, 8, 6).astype(np.float32)

    def jax_loss(*a):
        out, final = jgd.chunk_gated_delta_rule(*a[:5], chunk_size=16, initial_state=a[5],
                                                output_final_state=True)
        return jnp.sum(out * ct) + jnp.sum(final * cs), (out, final)

    (_, (jout, jfinal)), jgrads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=tuple(range(6)), has_aux=True))(*map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    out, final = tgd.chunk_gated_delta_rule(*targs[:5], chunk_size=16, initial_state=targs[5],
                                            output_final_state=True)
    grads = torch.autograd.grad((out * torch.tensor(ct)).sum() + (final * torch.tensor(cs)).sum(),
                                targs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    np.testing.assert_allclose(final.detach().numpy(), np.asarray(jfinal), atol=1e-5, rtol=0)
    for name, g, jg in zip("q k v g beta state".split(), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    # without an initial state, and a chunk as long as the row
    no_state, none = tgd.chunk_gated_delta_rule(*map(torch.tensor, args[:5]), chunk_size=64)
    want, _ = jgd.chunk_gated_delta_rule(*map(jnp.asarray, args[:5]), chunk_size=64)
    assert none is None
    np.testing.assert_allclose(no_state.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("packed", [False, True], ids=["one_row", "packed"])
def test_conv_norms_match_jax(packed):
    rng = np.random.RandomState(3)
    x = rng.randn(2, T, 10).astype(np.float32)
    w = rng.randn(10, 4).astype(np.float32)
    seg = None
    if packed:  # three documents in row 0, two in row 1
        seg = np.ones((2, T), np.int32)
        seg[0, 10:25], seg[0, 25:], seg[1, 30:] = 2, 3, 2
    got = tgd.causal_conv1d(torch.tensor(x), torch.tensor(w),
                            segment_ids=None if seg is None else torch.tensor(seg))
    want = jgd.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                             segment_ids=None if seg is None else jnp.asarray(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    gate, scale = rng.randn(2, T, 10).astype(np.float32), rng.randn(10).astype(np.float32)
    np.testing.assert_allclose(
        tgd.gated_rms_norm(torch.tensor(x), torch.tensor(scale), torch.tensor(gate)).numpy(),
        np.asarray(jgd.gated_rms_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(gate))),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(tgd.l2norm(torch.tensor(x)).numpy(),
                               np.asarray(jgd.l2norm(jnp.asarray(x))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", list(SOURCES))
def test_from_hf_matches_jax(name):
    hf = SOURCES[name]
    qwen35 = "text_config" in hf
    cls = Qwen3_5MoeForCausalLM if qwen35 else Qwen3NextForCausalLM
    got = cls.config_class.from_hf(hf)
    want = (JaxQwen35 if qwen35 else JaxNext).config_class.from_hf(hf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert AutoModelForCausalLM.model_class(hf) is cls
    assert got.linear_layer_indices == want.linear_layer_indices
    if name == "qwen3_next_80b":
        assert (got.head_dim, got.num_attention_heads, got.num_key_value_heads) == (256, 16, 2)
        assert got.full_layer_indices == tuple(range(3, 48, 4))


def _models(hf, seed=0, jax_cls=JaxNext, cls=Qwen3NextForCausalLM):
    params = jax_tree(cls.config_class.from_hf(hf).param_shapes(), seed, centred_norms=True)
    jm = jax_cls.from_config(hf, JaxBackend(dtype="float32", remat_policy="full"))
    return params, jm, port_model(cls, hf, params)


def test_logits_stats_and_grads_match_jax():
    params, jm, model = _models(TINY)
    stats = assert_forward_and_grads_match(jm, model, params, *batch(), vocab=128)
    assert stats["expert_load"].shape == (4, 8)
    assert model.param_dict()["linear_layers.a_log"].dtype == torch.float32


def test_three_steps_match_jax():
    params, jm, model = _models(TINY, seed=4)
    (want, _), (got, _) = trajectories(jm, model, params, 128, aux_coeff=0.01)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["qwen3_next", "qwen3_5_moe"])
def test_adapter_matches_jax_and_reloads(name, tmp_path):
    hf = TINY if name == "qwen3_next" else QWEN35
    kw = ({} if name == "qwen3_next"
          else dict(jax_cls=JaxQwen35, cls=Qwen3_5MoeForCausalLM))
    params, jm, model = _models(hf, seed=2, **kw)
    ours = model.state_dict_adapter().to_hf(model.param_dict())
    theirs = jm.state_dict_adapter().to_hf(params)
    assert set(ours) == set(theirs)
    probe = ("model.layers.0.linear_attn.in_proj_qkvz.weight" if name == "qwen3_next"
             else "model.language_model.layers.0.linear_attn.in_proj_z.weight")
    assert probe in ours
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)
    back = model.state_dict_adapter().from_hf(ours)
    for key, p in model.param_dict().items():
        assert torch.equal(back[key], p), key
    save_safetensors(ours, str(tmp_path))
    (tmp_path / "config.json").write_text(json.dumps(hf))
    loaded = AutoModelForCausalLM.from_pretrained(str(tmp_path), dtype=torch.bfloat16,
                                                  device="cpu")
    assert type(loaded) is type(model)
    for key, p in loaded.param_dict().items():
        want = model.param_dict()[key]
        assert torch.equal(p, want if key.endswith("a_log") else want.to(torch.bfloat16)), key
    assert loaded.param_dict()["linear_layers.a_log"].dtype == torch.float32


def test_logical_axes_match_jax():
    for hf, kw in ((TINY, {}), (QWEN35, dict(jax_cls=JaxQwen35, cls=Qwen3_5MoeForCausalLM))):
        _, jm, model = _models(hf, **kw)
        assert model.logical_axes() == flatten(jm.logical_axes())


@pytest.mark.parametrize("name", list(SOURCES))
def test_flops_match_jax(name):
    hf = SOURCES[name]
    for seq in (2048, 4096):
        assert tflops.flops_per_token(hf, seq) == jax_flops(hf, seq)
    text = hf.get("text_config", hf)
    kinds = tflops._layer_kinds(text.get, text["num_hidden_layers"])
    assert kinds[:4] == (["linear", "attn"] * 2 if name == "layer_types"
                         else ["linear"] * 3 + ["attn"])
    assert tflops.flops_per_token(hf, 2048) < tflops.flops_per_token(
        dict(text, layer_types=None, full_attention_interval=None), 2048)


def _counted(events, names):
    """{scope: the names of the events scope_times counts for it}."""
    from automodel_tpu_torch.utils.tracing import scope_times

    seen = {}
    for n in names:
        seen[n] = []
        scope_times(events, [n], lambda e, n=n: seen[n].append(e.name) or 0.0)
    return seen


def test_scope_times_take_forward_replay_and_backward():
    """Under a non-reentrant layer checkpoint a scope's forward range runs twice (the
    forward and the replay) and its ops' autograd nodes run outside any range:
    scope_times counts both ranges and exactly the nodes the scope's ops made."""
    from torch.utils.checkpoint import checkpoint

    from automodel_tpu_torch.utils.tracing import scoped

    gen = torch.Generator().manual_seed(0)
    w1, w2 = (torch.randn(16, 16, generator=gen).requires_grad_() for _ in range(2))
    mixer = scoped("test_mixer", lambda x: torch.tanh(x @ w1).sin() * 2)

    def layer(h):
        h = h + mixer(torch.nn.functional.layer_norm(h, (16,)))
        return h + torch.relu(h @ w2)

    x = torch.randn(4, 16, generator=gen)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        h = checkpoint(layer, checkpoint(layer, x, use_reentrant=False), use_reentrant=False)
        torch.autograd.grad(h.sum(), [w1, w2])
    got = _counted(prof.events(), ["test_mixer"])["test_mixer"]
    backward = sorted(n.rsplit(" ", 1)[-1] for n in got if n != "test_mixer")
    assert got.count("test_mixer") == 4  # 2 layers x (forward, replay)
    assert backward == sorted(["MulBackward0", "SinBackward0", "TanhBackward0",
                               "MmBackward0"] * 2)


def test_delta_net_scope_takes_its_backward():
    """A Qwen3-Next train step (mlp_dots remat, as main path 41's YAML) under the
    profiler: the delta_net scope counts the DeltaNet layers' triangular solves'
    backward nodes and no MoE node; the moe scope counts no solve."""
    from automodel_tpu_torch.models.common.backend import BackendConfig

    model = Qwen3NextForCausalLM.from_config(
        TINY, BackendConfig(dtype="float32", remat_policy="mlp_dots"), device="cpu")
    ids, pos, seg = batch()
    params = model.param_dict()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        logits, stats = model(torch.tensor(ids), torch.tensor(pos), torch.tensor(seg))
        torch.autograd.grad(logits.float().square().mean() + stats["aux_loss"],
                            list(params.values()), allow_unused=True)
    got = _counted(prof.events(), ["delta_net", "moe", "gated_attention"])
    solves = [n for n in got["delta_net"] if "SolveTriangular" in n and "Backward" in n]
    assert got["delta_net"].count("delta_net") == 6  # 3 DeltaNet layers x (forward, replay)
    assert len(solves) == 3
    assert got["gated_attention"].count("gated_attention") == 2
    assert not any("SolveTriangular" in n for n in got["moe"] + got["gated_attention"])
    assert not any("delta_net" == n for n in got["moe"])


def test_launched_us_counts_each_launch_once():
    """A kernel the profiler also links to a "Command Buffer Full" marker (a launch that
    waited for room in the queue) under its launch is counted once, with the op that
    launched it; device_time_total would sum it twice."""
    from types import SimpleNamespace

    from automodel_tpu_torch.utils.tracing import launched_us

    def ev(name, kernels=(), children=()):
        return SimpleNamespace(name=name, cpu_children=list(children),
                               kernels=[SimpleNamespace(duration=d) for d in kernels])

    full = ev("Command Buffer Full", [5.0])
    mm = ev("aten::mm", [5.0], [ev("cudaLaunchKernel", [], [full])])
    scope = ev("delta_net", [], [mm, ev("aten::add", [2.0], [ev("cudaLaunchKernel")])])
    assert launched_us(scope) == 7.0
    assert launched_us(mm) == 5.0
