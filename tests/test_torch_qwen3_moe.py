"""The port's Qwen3-MoE against the JAX package's, f32: the tiny config of
tests/unit/test_moe_models_parity.py (2 layers, 8 experts, top-2; written out here, no
transformers import) at head_dim 16 and at head_dim 128. Weights are built once in JAX
and carried across with params_from_jax. Logits, aux loss, expert load and every
parameter's gradient agree: values to 1e-4, gradients to 1e-4 (absolute, f32). At
head_dim 128 the attention is flash (the port's plain version on the CPU, JAX's Pallas
kernel in interpret mode) and the experts take the pallas backend (the port's plain
version, JAX's kernel in interpret mode); at head_dim 16 both sides run xla attention
and ragged_dot experts. The remat ladder at head_dim 16: under each policy the loss and
gradients equal "full" (rtol 1e-5, atol 1e-6) and JAX's under the same policy (1e-4),
and the matmuls of forward and backward equal JAX's dot_generals (the grouped GEMM,
a kernel on the card and ragged_dot in JAX, not counted)."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.qwen3_moe.model import Qwen3MoeConfig as JaxQwen3MoeConfig
from automodel_tpu.models.qwen3_moe.model import Qwen3MoeForCausalLM as JaxQwen3Moe
from automodel_tpu_torch.models.common.backend import REMAT_POLICIES, BackendConfig
from automodel_tpu_torch.models.llama.convert import flatten, params_from_jax
from automodel_tpu_torch.models.qwen3_moe.model import Qwen3MoeConfig, Qwen3MoeForCausalLM
from automodel_tpu_torch.models.registry import resolve_model_class
from automodel_tpu_torch.moe import experts as texperts
from automodel_tpu_torch.ops.grouped_gemm import grouped_matmul_reference
from tests.test_torch_llama import MatmulCounter, jax_matmul_counts
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

HF = dict(architectures=["Qwen3MoeForCausalLM"], vocab_size=128, hidden_size=64,
          intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, head_dim=16, num_experts=8,
          num_experts_per_tok=2, decoder_sparse_step=1, mlp_only_layers=[],
          norm_topk_prob=True, max_position_embeddings=128, router_aux_loss_coef=0.001,
          rope_theta=1e6, rms_norm_eps=1e-6)
HEAD_DIMS = {"d16": dict(hf=dict(head_dim=16), attention=("xla", "xla"),
                         experts="ragged_dot"),
             "d128": dict(hf=dict(head_dim=128), attention=("flash_interpret", "flash"),
                          experts="pallas")}


def _jax_params(hf, seed=0):
    model = JaxQwen3Moe.from_config(hf, JaxBackend(dtype="float32", remat_policy="full"))
    return jax.device_get(model.init(jax.random.key(seed)))


def _batch(seed=0, b=2, s=32):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, (b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    seg[0, s // 2:] = 2  # two packed sequences in row 0
    seg[1, s - 6:] = 0  # right padding in row 1
    pos = np.concatenate([np.arange(s // 2), np.arange(s // 2)])[None].repeat(b, 0)
    pos[1] = np.arange(s)
    return ids, pos.astype(np.int32), seg


def test_from_hf_matches_jax():
    for extra in ({}, dict(mlp_only_layers=[0]), dict(head_dim=128, norm_topk_prob=False)):
        hf = dict(HF, **extra)
        got, want = Qwen3MoeConfig.from_hf(hf), JaxQwen3MoeConfig.from_hf(hf)
        assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
        for f in dataclasses.fields(got):
            if f.name != "moe":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert Qwen3MoeConfig.from_hf(dict(HF, mlp_only_layers=[0])).first_k_dense_replace == 1
    with pytest.raises(NotImplementedError, match="interleavings"):
        Qwen3MoeConfig.from_hf(dict(HF, num_hidden_layers=3, mlp_only_layers=[1]))
    assert resolve_model_class("Qwen3MoeForCausalLM") is Qwen3MoeForCausalLM
    with pytest.raises(NotImplementedError):
        resolve_model_class("NemotronHForCausalLM")


@pytest.mark.parametrize("mlp_only", [[], [0]], ids=["all_moe", "dense_prefix"])
def test_params_from_jax_carries_the_moe_tree(mlp_only):
    hf = dict(HF, mlp_only_layers=mlp_only)
    cfg = Qwen3MoeConfig.from_hf(hf)
    params = _jax_params(hf)
    flat = params_from_jax(params, cfg)
    lm = 2 - len(mlp_only)
    assert flat["moe_layers.moe.experts.gate_up_proj"].shape == (lm, 8, 64, 64)
    assert flat["moe_layers.moe.experts.down_proj"].shape == (lm, 8, 32, 64)
    assert flat["moe_layers.moe.gate.weight"].shape == (lm, 8, 64)
    assert flat["moe_layers.q_norm"].shape == (lm, 16)
    assert ("dense_layers.w_gate" in flat) == bool(mlp_only)
    model = Qwen3MoeForCausalLM(cfg, device="cpu")
    assert set(model.param_dict()) == set(flat)
    model.load_params(flat)
    np.testing.assert_array_equal(model.param_dict()["moe_layers.moe.experts.down_proj"]
                                  .detach().numpy(),
                                  params["moe_layers"]["moe"]["experts"]["down_proj"])
    bad = jax.tree.map(lambda a: a, params)
    bad["moe_layers"]["moe"]["experts"]["down_proj"] = np.zeros((lm, 8, 16, 64), np.float32)
    with pytest.raises(ValueError, match="down_proj"):
        params_from_jax(bad, cfg)


@pytest.mark.parametrize("name", list(HEAD_DIMS))
def test_logits_stats_and_grads_match_jax(name):
    spec = HEAD_DIMS[name]
    hf = dict(HF, **spec["hf"])
    params = _jax_params(hf)
    ids, pos, seg = _batch()
    mask = seg != 0
    rng = np.random.RandomState(1)
    ct = rng.randn(*ids.shape, hf["vocab_size"]).astype(np.float32)

    jm = JaxQwen3Moe.from_config(hf, JaxBackend(dtype="float32", remat_policy="full",
                                                attention=spec["attention"][0],
                                                experts_backend=spec["experts"]))

    def jax_loss(p):
        logits, stats = jm(p, jnp.asarray(ids), positions=jnp.asarray(pos),
                           segment_ids=jnp.asarray(seg), token_mask=jnp.asarray(mask))
        return jnp.sum(logits * ct) + stats["aux_loss"], (logits, stats)

    (_, (jlogits, jstats)), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))

    tm = Qwen3MoeForCausalLM.from_config(
        hf, BackendConfig(dtype="float32", remat_policy="mlp_dots",
                          attention=spec["attention"][1], experts_backend=spec["experts"]),
        device="cpu")
    tm.load_params(params_from_jax(params, tm.config))
    logits, stats = tm(torch.tensor(ids), positions=torch.tensor(pos),
                       segment_ids=torch.tensor(seg), token_mask=torch.tensor(mask))
    loss = (logits * torch.tensor(ct)).sum() + stats["aux_loss"]
    names = list(tm.param_dict())
    grads = torch.autograd.grad(loss, list(tm.param_dict().values()))

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(stats["aux_loss"].item(), float(jstats["aux_loss"]), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_array_equal(stats["expert_load"].numpy(), np.asarray(jstats["expert_load"]))
    assert stats["expert_load"].shape == (2, 8)
    assert stats["expert_load"].sum().item() == 2 * 2 * mask.sum()  # layers x top-k x valid
    jflat = flatten(jgrads)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jflat[n]), atol=1e-4, rtol=1e-4,
                                   err_msg=n)


def test_eval_forward_drops_the_aux_loss():
    cfg = Qwen3MoeConfig.from_hf(HF)
    tm = Qwen3MoeForCausalLM(cfg, BackendConfig(dtype="float32"), device="cpu")
    ids = torch.tensor(_batch()[0])
    with torch.no_grad():
        _, stats = tm(ids, training=False)
    assert stats["aux_loss"] is None and stats["expert_load"].shape == (2, 8)


REMAT_HF = dict(HF, num_hidden_layers=1)


def _jax_remat_loss(policy, ids, ct):
    jm = JaxQwen3Moe.from_config(REMAT_HF, JaxBackend(dtype="float32", remat_policy=policy,
                                                      attention="xla",
                                                      experts_backend="ragged_dot"))

    def loss(p):
        logits, stats = jm(p, jnp.asarray(ids))
        return jnp.sum(logits * ct) + stats["aux_loss"]

    return loss


class _OpaqueGroupedMatmul(torch.autograd.Function):
    """The grouped GEMM as the card runs it, a Function the dispatcher cannot see into:
    its plain version runs with the matmul count paused, forward and backward."""

    counter = None

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        with _OpaqueGroupedMatmul._paused():
            return grouped_matmul_reference(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dout):
        x, w, group_sizes = ctx.saved_tensors
        with _OpaqueGroupedMatmul._paused(), torch.enable_grad():
            x, w = x.detach().requires_grad_(), w.detach().requires_grad_()
            dx, dw = torch.autograd.grad(grouped_matmul_reference(x, w, group_sizes), (x, w),
                                         dout)
        return dx, dw, None

    @staticmethod
    @contextlib.contextmanager
    def _paused():
        counter = _OpaqueGroupedMatmul.counter
        before = counter.paused
        counter.paused = True
        try:
            yield
        finally:
            counter.paused = before


def _remat_loss_and_grads(policy, params, ids, ct, count=False):
    tm = Qwen3MoeForCausalLM.from_config(
        REMAT_HF, BackendConfig(dtype="float32", remat_policy=policy, attention="xla",
                                experts_backend="ragged_dot"), device="cpu")
    tm.load_params(params_from_jax(params, tm.config))
    with MatmulCounter() if count else contextlib.nullcontext() as counter:
        _OpaqueGroupedMatmul.counter = counter
        logits, stats = tm(torch.tensor(ids))
        loss = (logits * torch.tensor(ct)).sum() + stats["aux_loss"]
        grads = torch.autograd.grad(loss, list(tm.param_dict().values()))
    return loss, dict(zip(tm.param_dict(), grads)), counter.counts if count else None


def _remat_inputs():
    ids = np.random.RandomState(2).randint(0, 128, (2, 32)).astype(np.int32)
    ct = np.random.RandomState(3).randn(2, 32, 128).astype(np.float32)
    return _jax_params(REMAT_HF), ids, ct


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_remat_policy_matches_full_and_jax(policy):
    """Every policy gives the loss and gradients of "full" and of JAX's same policy."""
    params, ids, ct = _remat_inputs()
    loss, grads, _ = _remat_loss_and_grads(policy, params, ids, ct)
    loss_full, grads_full, _ = _remat_loss_and_grads("full", params, ids, ct)
    torch.testing.assert_close(loss, loss_full, rtol=1e-5, atol=1e-6)
    for name, g in grads.items():
        torch.testing.assert_close(g, grads_full[name], rtol=1e-5, atol=1e-6)
    want_loss, want = jax.value_and_grad(_jax_remat_loss(policy, ids, ct))(
        jax.tree.map(jnp.asarray, params))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5, atol=1e-4)
    want = flatten(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("policy", ["none", "dots", "mlp_dots", "mlp_attn_dots"])
def test_remat_replays_the_matmuls_jax_replays(policy, monkeypatch):
    """The matmuls of the forward and backward equal JAX's dot_generals under the same
    policy; the grouped GEMM (a kernel Function on the card, ragged_dot in JAX) replays
    outside both counts."""
    params, ids, ct = _remat_inputs()
    monkeypatch.setattr(texperts, "grouped_matmul", _OpaqueGroupedMatmul.apply)
    _, _, counts = _remat_loss_and_grads(policy, params, ids, ct, count=True)
    want, _ = jax_matmul_counts(jax.make_jaxpr(jax.grad(_jax_remat_loss(policy, ids, ct)))(
        jax.tree.map(jnp.asarray, params)))
    assert counts == want
