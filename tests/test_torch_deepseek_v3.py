"""The port's DeepSeek-V3 family against the JAX package's, f32, weights and batches from
numpy seeds (carried into JAX's tree and the port's model by name).

- ``from_hf`` on DeepSeek-V3's, Moonlight-16B-A3B's, DeepSeek-V2-Lite's (softmax routing,
  q_lora_rank null, YaRN's mscale), Kimi-K2's (384 experts, one group) and the proxy
  YAML's config.json: every field, the MoE config, ``softmax_scale`` (YaRN's mscale^2
  included) equal JAX's exactly, the rope frequencies to rtol 1e-6.
- A tiny model (2 layers: 1 dense + 1 MoE, hidden 64, 4 heads, qk 16 + 8, v 16,
  kv_lora_rank 32, 8 experts top-2 in 4 groups of which 2 are kept, 1 shared expert, a
  nonzero correction bias) with both q routes (q_lora_rank 24 and null): logits, the
  expert load and every gradient against JAX under xla attention, atol 1e-4.
- Three train steps of 2 microbatches with the gate-bias update on (adamw with weight
  decay, which JAX's mask applies to the stacked bias): losses (atol 1e-5) and the
  correction bias after each step (atol 1e-7) equal JAX's.
- The HF adapter: JAX's key set, values bitwise equal to JAX's export, and a round trip
  through the port's safetensors and ``from_pretrained`` bitwise (the bias in f32).
- FLOPs equal JAX's ``utils/flops.py``; interleaved RoPE (full and partial rotary
  width) equals JAX's to 1e-6; a step whose update the non-finite guard skips still
  updates the correction bias, in both packages.
- MLA under ``context_parallel: ring`` (cp 4 on the one-card fold, the chunk kernels'
  plain versions at Dv < D) against JAX's model under the cp mesh: logits and every
  gradient, atol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from automodel_tpu.config.loader import load_config as jax_load_config
from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.deepseek_v3 import model as jds
from automodel_tpu.models.deepseek_v3.state_dict_adapter import (
    DeepseekV3StateDictAdapter as JaxAdapter)
from automodel_tpu.moe.gate import make_gate_bias_post_update as jax_post_update
from automodel_tpu.ops.losses import masked_cross_entropy as jax_ce
from automodel_tpu.ops.rope import apply_rope_interleaved as jax_rope_interleaved
from automodel_tpu.optim.builder import build_optimizer as jax_build_optimizer
from automodel_tpu.parallel.mesh import MeshContext as JaxMesh
from automodel_tpu.parallel.mesh import default_sharding_rules
from automodel_tpu.training.train_step import make_train_step as jax_make_train_step
from automodel_tpu.utils.flops import flops_per_token as jax_flops
from automodel_tpu_torch.checkpoint.safetensors_io import save_safetensors
from automodel_tpu_torch.models.auto import AutoModelForCausalLM
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.common.moe_transformer import moe_decoder_param_shapes
from automodel_tpu_torch.models.deepseek_v3.model import (DeepseekV3Config,
                                                          DeepseekV3ForCausalLM, mla_inv_freq)
from automodel_tpu_torch.models.llama.convert import params_from_jax
from automodel_tpu_torch.models.registry import resolve_model_class
from automodel_tpu_torch.moe.gate import make_gate_bias_post_update
from automodel_tpu_torch.ops.losses import masked_cross_entropy
from automodel_tpu_torch.ops.rope import apply_rope_interleaved
from automodel_tpu_torch.optim.builder import build_optimizer
from automodel_tpu_torch.parallel.mesh import MeshContext
from automodel_tpu_torch.training.train_step import make_train_step
from automodel_tpu_torch.utils.flops import flops_per_token
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ATOL = 1e-4
YARN_V3 = {"type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1, "mscale": 1.0,
           "mscale_all_dim": 1.0, "original_max_position_embeddings": 4096}
# deepseek-ai/DeepSeek-V3's config.json (its MoE and MLA fields)
DEEPSEEK_V3 = dict(
    architectures=["DeepseekV3ForCausalLM"], vocab_size=129280, hidden_size=7168,
    intermediate_size=18432, moe_intermediate_size=2048, num_hidden_layers=61,
    num_attention_heads=128, num_key_value_heads=128, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=256,
    num_experts_per_tok=8, n_shared_experts=1, n_group=8, topk_group=4,
    routed_scaling_factor=2.5, norm_topk_prob=True, scoring_func="sigmoid",
    topk_method="noaux_tc", first_k_dense_replace=3, max_position_embeddings=163840,
    rope_theta=10000, rope_scaling=YARN_V3, rms_norm_eps=1e-6, tie_word_embeddings=False)
# deepseek-ai/DeepSeek-V2-Lite's: softmax scores, greedy top-k, no correction bias
DEEPSEEK_V2_LITE = dict(
    architectures=["DeepseekV2ForCausalLM"], vocab_size=102400, hidden_size=2048,
    intermediate_size=10944, moe_intermediate_size=1408, num_hidden_layers=27,
    num_attention_heads=16, q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=64, num_experts_per_tok=6,
    n_shared_experts=2, n_group=1, topk_group=1, routed_scaling_factor=1.0,
    norm_topk_prob=False, scoring_func="softmax", topk_method="greedy",
    first_k_dense_replace=1, max_position_embeddings=163840, rope_theta=10000,
    rope_scaling=dict(YARN_V3, mscale=0.707, mscale_all_dim=0.707), rms_norm_eps=1e-6)
# moonshotai/Kimi-K2's shape: 384 experts in one group
KIMI_K2 = dict(DEEPSEEK_V3, architectures=["KimiK2ForCausalLM"], vocab_size=163840,
               num_attention_heads=64, n_routed_experts=384, n_group=1, topk_group=1,
               routed_scaling_factor=2.827, first_k_dense_replace=1,
               max_position_embeddings=131072,
               rope_scaling=dict(YARN_V3, factor=32.0, beta_fast=1.0))
CONFIGS = {
    "deepseek_v3": DEEPSEEK_V3,
    "moonlight": chip_smoke.MOONLIGHT_16B_A3B,
    "v2_lite": DEEPSEEK_V2_LITE,
    "kimi_k2": KIMI_K2,
    "proxy_yaml": jax_load_config(chip_smoke.DSV3_PROXY_YAML).model.config.to_dict(),
}
TINY = dict(architectures=["DeepseekV3ForCausalLM"], vocab_size=128, hidden_size=64,
            intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=2,
            num_attention_heads=4, q_lora_rank=24, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
            n_shared_experts=1, n_group=4, topk_group=2, routed_scaling_factor=2.5,
            norm_topk_prob=True, first_k_dense_replace=1, max_position_embeddings=128,
            rope_theta=10000.0, rms_norm_eps=1e-6)
Q_ROUTES = {"q_lora": 24, "direct_q": None}
BIAS = "moe_layers.moe.gate.score_correction_bias"


@pytest.mark.parametrize("name", list(CONFIGS))
def test_from_hf_matches_jax(name):
    hf = CONFIGS[name]
    got, want = DeepseekV3Config.from_hf(hf), jds.DeepseekV3Config.from_hf(hf)
    assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
    for f in dataclasses.fields(want):
        if f.name != "moe":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    for prop in ("softmax_scale", "qk_head_dim", "num_moe_layers"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.head_dim == want.qk_head_dim and got.num_key_value_heads == got.num_attention_heads
    # theta ** exponent in torch and in XLA differ in the last bit of some frequencies
    np.testing.assert_allclose(mla_inv_freq(got).numpy(), np.asarray(jds.mla_inv_freq(want)),
                               rtol=1e-6, atol=0)
    assert resolve_model_class(hf["architectures"][0]) is DeepseekV3ForCausalLM


def test_yarn_mscale_squared_and_registry():
    """V3's softmax scale is 192^-0.5 times YaRN's mscale^2 (1 + 0.1 ln 40)^2; a config
    within its original context keeps 192^-0.5; the four registry names resolve."""
    scale = DeepseekV3Config.from_hf(DEEPSEEK_V3).softmax_scale
    assert scale == pytest.approx(192**-0.5 * (1 + 0.1 * np.log(40.0)) ** 2, rel=1e-12)
    assert scale == chip_smoke.DSV3_SCALE
    short = DeepseekV3Config.from_hf(dict(DEEPSEEK_V3, max_position_embeddings=4096))
    assert short.softmax_scale == 192**-0.5
    assert DeepseekV3Config.from_hf(DEEPSEEK_V2_LITE).moe.gate_bias_update_factor == 0.0
    for arch in ("DeepseekV3ForCausalLM", "DeepseekV2ForCausalLM", "KimiK2ForCausalLM",
                 "Glm4MoeLiteForCausalLM"):
        assert resolve_model_class(arch) is DeepseekV3ForCausalLM
    with pytest.raises(NotImplementedError):
        resolve_model_class("DeepseekV32ForCausalLM")


def _jax_params(hf, seed=0):
    """The JAX tree of the config's parameters from a numpy seed: normal(0, 0.02), norms
    at 1, and a nonzero correction bias (normal(0, 0.05)) so that it takes part in the
    routing. The names and shapes are the port's, which JAX's adapter and forward read."""
    rng = np.random.RandomState(seed)
    tree: dict = {}
    for name, shape in moe_decoder_param_shapes(DeepseekV3Config.from_hf(hf)).items():
        leaf = name.rsplit(".", 1)[-1]
        value = (np.ones(shape) if leaf.endswith("norm")
                 else rng.randn(*shape) * (0.05 if leaf == "score_correction_bias" else 0.02))
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value.astype(np.float32)
    return tree


def _batch(seed=0, b=2, s=32):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, (b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    seg[0, s // 2:] = 2  # two packed sequences in row 0
    pos = np.concatenate([np.arange(s // 2), np.arange(s // 2)])[None].repeat(b, 0)
    pos[1] = np.arange(s)
    return ids, pos.astype(np.int32), seg


def _port_model(hf, params, **backend):
    model = DeepseekV3ForCausalLM.from_config(
        hf, BackendConfig(dtype="float32", remat_policy="full", **backend), device="cpu")
    model.load_params(params_from_jax(params, model.config))
    return model


@pytest.mark.parametrize("route", list(Q_ROUTES))
def test_logits_load_and_grads_match_jax(route):
    hf = dict(TINY, q_lora_rank=Q_ROUTES[route])
    params = _jax_params(hf)
    ids, pos, seg = _batch()
    ct = np.random.RandomState(1).randn(*ids.shape, hf["vocab_size"]).astype(np.float32)
    jm = jds.DeepseekV3ForCausalLM.from_config(hf, JaxBackend(dtype="float32",
                                                              remat_policy="full"))

    def jax_loss(p):
        logits, stats = jm(p, jnp.asarray(ids), positions=jnp.asarray(pos),
                           segment_ids=jnp.asarray(seg))
        return jnp.sum(logits * ct), (logits, stats)

    (want_loss, (want_logits, want_stats)), want_grads = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(params)
    model = _port_model(hf, params)
    names, leaves = zip(*model.param_dict().items())
    assert (("moe_layers.wq" in names) == (route == "direct_q")
            and ("dense_layers.wq_b" in names) == (route == "q_lora"))
    logits, stats = model(torch.tensor(ids), positions=torch.tensor(pos),
                          segment_ids=torch.tensor(seg))
    loss = (logits * torch.tensor(ct)).sum()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_array_equal(stats["expert_load"].numpy(),
                                  np.asarray(want_stats["expert_load"]))
    want = params_from_jax(jax.device_get(want_grads), model.config)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=ATOL, rtol=0,
                                   err_msg=name)


def test_three_steps_with_the_gate_bias_update_match_jax():
    """The train step's post_update (JAX's make_gate_bias_post_update) after adamw with
    weight decay: the same losses and the same correction bias after each step."""
    hf = dict(TINY, q_lora_rank=None)
    params = _jax_params(hf, seed=4)
    cfg = DeepseekV3Config.from_hf(hf)
    factor = cfg.moe.gate_bias_update_factor
    assert factor == 0.001
    stacks = []
    for step in range(3):
        micro = [_batch(seed=10 * step + i) for i in range(2)]
        labels = np.stack([np.roll(ids, -1, axis=1) for ids, _, _ in micro])
        labels[:, :, -1] = -100
        stacks.append({"input_ids": np.stack([m[0] for m in micro]),
                       "positions": np.stack([m[1] for m in micro]),
                       "segment_ids": np.stack([m[2] for m in micro]), "labels": labels})
    opt = dict(lr=1e-2, weight_decay=0.1, max_grad_norm=1.0)

    jm = jds.DeepseekV3ForCausalLM.from_config(hf, JaxBackend(dtype="float32",
                                                              remat_policy="full"))

    def jax_forward_loss(p, batch, n):
        logits, stats = jm(p, batch["input_ids"], positions=batch["positions"],
                           segment_ids=batch["segment_ids"])
        return jax_ce(logits, batch["labels"], n), {"expert_load": stats["expert_load"]}

    jopt = jax_build_optimizer(**opt)
    jstep = jax.jit(jax_make_train_step(jax_forward_loss, jopt,
                                        post_update=jax_post_update(factor)))
    jp, jstate = params, jopt.init(params)
    want_losses, want_bias = [], []
    for stack in stacks:
        jp, jstate, m = jstep(jp, jstate, jax.tree.map(jnp.asarray, stack))
        want_losses.append(float(m["loss"]))
        want_bias.append(np.asarray(jp["moe_layers"]["moe"]["gate"]["score_correction_bias"]))

    model = _port_model(hf, params)
    tparams = model.param_dict()

    def forward_loss(batch, n):
        logits, stats = model(batch["input_ids"], positions=batch["positions"],
                              segment_ids=batch["segment_ids"])
        return masked_cross_entropy(logits, batch["labels"], n), {
            "expert_load": stats["expert_load"]}

    topt = build_optimizer(**opt)
    step = make_train_step(forward_loss, tparams, topt,
                           post_update=make_gate_bias_post_update(factor))
    state = topt.init(tparams)
    for i, stack in enumerate(stacks):
        state, m = step(state, {k: torch.tensor(v) for k, v in stack.items()})
        assert float(m["loss"]) == pytest.approx(want_losses[i], abs=1e-5)
        np.testing.assert_allclose(tparams[BIAS].detach().numpy(), want_bias[i], atol=1e-7,
                                   rtol=0, err_msg=f"step {i + 1}")
    assert tparams[BIAS].dtype == torch.float32
    assert not np.allclose(want_bias[-1], params["moe_layers"]["moe"]["gate"][
        "score_correction_bias"])


def test_adapter_round_trip_matches_jax(tmp_path):
    """to_hf has JAX's keys and values (the correction bias in f32, both q routes);
    safetensors -> from_pretrained gives the parameters back bitwise."""
    for route, q_rank in Q_ROUTES.items():
        hf = dict(TINY, q_lora_rank=q_rank)
        params = _jax_params(hf, seed=2)
        model = _port_model(hf, params)
        ours = model.state_dict_adapter().to_hf(model.param_dict())
        theirs = JaxAdapter(jds.DeepseekV3Config.from_hf(hf)).to_hf(params)
        assert set(ours) == set(theirs), route
        for key, value in theirs.items():
            np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)
        bias_keys = [k for k in ours if k.endswith("e_score_correction_bias")]
        assert bias_keys == ["model.layers.1.mlp.gate.e_score_correction_bias"]
        assert ours[bias_keys[0]].dtype == torch.float32
        out = tmp_path / route
        save_safetensors(ours, str(out))
        (out / "config.json").write_text(__import__("json").dumps(hf))
        back = AutoModelForCausalLM.from_pretrained(str(out), dtype=torch.bfloat16,
                                                    device="cpu").param_dict()
        assert back[BIAS].dtype == torch.float32
        for name, p in model.param_dict().items():
            want = p if name == BIAS else p.to(torch.bfloat16)
            assert torch.equal(back[name], want), name
        again = model.state_dict_adapter().from_hf(ours, dtype=torch.float32)
        for name, p in model.param_dict().items():
            assert torch.equal(again[name], p), name


@pytest.mark.parametrize("name", ["deepseek_v3", "moonlight", "v2_lite", "proxy_yaml"])
def test_flops_match_jax(name):
    for seq in (2048, 16384):
        assert flops_per_token(CONFIGS[name], seq) == jax_flops(CONFIGS[name], seq)


def test_mla_ring_matches_jax_ring():
    """The tiny model (the low-rank q route) under context_parallel ring, cp 4 on the
    one-card fold, against JAX's under its cp mesh (dp_shard 2 x cp 4 on the conftest's
    CPU devices): MLA's q / k are 24 wide and v 16, so the ring carries Dv < D."""
    hf = TINY
    params = _jax_params(hf, seed=5)
    ids, pos, seg = _batch(seed=6, s=64)
    w = np.random.RandomState(7).randn(*ids.shape, hf["vocab_size"]).astype(np.float32)
    mesh = JaxMesh(cp=4, dp_shard=2, world_size=8).build_mesh(jax.devices())
    jm = jds.DeepseekV3ForCausalLM.from_config(hf, JaxBackend(dtype="float32",
                                                              remat_policy="full",
                                                              context_parallel="ring"))
    rules = default_sharding_rules().with_mesh(mesh)

    def loss(p):
        logits, _ = jm(p, jnp.asarray(ids), positions=jnp.asarray(pos),
                       segment_ids=jnp.asarray(seg), rules=rules)
        return jnp.sum(logits * jnp.asarray(w)), logits

    with jax.sharding.set_mesh(mesh):
        (_, want_logits), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    model = _port_model(hf, params, context_parallel="ring")
    names, leaves = zip(*model.param_dict().items())
    logits, _ = model(torch.tensor(ids), positions=torch.tensor(pos),
                      segment_ids=torch.tensor(seg), mesh=MeshContext(cp=4))
    grads = torch.autograd.grad((logits * torch.tensor(w)).sum(), leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), atol=ATOL,
                               rtol=0)
    want = params_from_jax(jax.device_get(want_grads), model.config)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=ATOL, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("rot", [8, 4], ids=["full", "partial"])
def test_apply_rope_interleaved_matches_jax(rot):
    """MLA's complex-pair RoPE on (B, S, H, 8): every column rotated, or the first
    ``rot`` (GLM-4's partial interleaved RoPE) with the rest passed through."""
    rng = np.random.RandomState(8)
    x = rng.randn(2, 16, 3, 8).astype(np.float32)
    pos = rng.randint(0, 4096, (2, 16)).astype(np.int32)
    inv_freq = (1.0 / 10000.0 ** (np.arange(0, rot, 2) / rot)).astype(np.float32)
    got = apply_rope_interleaved(torch.tensor(x), torch.tensor(pos), torch.tensor(inv_freq), 1.3)
    want = jax_rope_interleaved(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv_freq), 1.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[..., rot:].numpy(), x[..., rot:])


def test_a_skipped_step_still_updates_the_bias():
    """JAX runs post_update after the non-finite guard zeroed the update: the optimizer
    skips the step, the correction bias still moves by the step's loads. The port does
    the same."""
    load = np.array([[3.0, 0.0, 1.0, 4.0]], np.float32)
    bias0 = np.zeros((1, 4), np.float32)
    want_bias = bias0 + np.sign(load.mean(-1, keepdims=True) - load) * 1e-3

    def jax_loss(p, batch, n):
        return jnp.sum(p["w"]) * jnp.nan, {"expert_load": jnp.asarray(load)}

    jopt = jax_build_optimizer(lr=1e-2)
    jparams = {"w": jnp.ones(3), "moe_layers": {"moe": {"gate": {
        "score_correction_bias": jnp.asarray(bias0)}}}}
    jstep = jax.jit(jax_make_train_step(jax_loss, jopt, post_update=jax_post_update(1e-3),
                                        guard_nonfinite=True))
    jp, _, jm = jstep(jparams, jopt.init(jparams), {"labels": jnp.ones((1, 2, 2), jnp.int32)})
    assert bool(jm["nonfinite"])
    np.testing.assert_array_equal(np.asarray(jp["w"]), np.ones(3))
    np.testing.assert_array_equal(
        np.asarray(jp["moe_layers"]["moe"]["gate"]["score_correction_bias"]), want_bias)

    params = {"w": torch.ones(3, requires_grad=True),
              BIAS: torch.zeros(1, 4, requires_grad=True)}

    def loss(batch, n):
        return params["w"].sum() * float("nan"), {"expert_load": torch.tensor(load)}

    opt = build_optimizer(lr=1e-2)
    step = make_train_step(loss, params, opt, guard_nonfinite=True,
                           post_update=make_gate_bias_post_update(1e-3))
    _, m = step(opt.init(params), {"labels": torch.ones(1, 2, 2, dtype=torch.int64)})
    assert bool(m["nonfinite"])
    assert torch.equal(params["w"].detach(), torch.ones(3))
    np.testing.assert_array_equal(params[BIAS].detach().numpy(), want_bias)
