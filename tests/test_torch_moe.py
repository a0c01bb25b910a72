"""The port's MoE layers against the JAX package's, f32, from the same numpy inputs:
routing (softmax with top-k renormalisation, sigmoid with group-limited selection and
a correction bias, Mixtral-style renormalised softmax with route_scale), round-robin
routing, the grouped experts with the ``ragged_dot`` and ``pallas`` backends (JAX's
Pallas kernel in interpret mode, the port's plain version on the CPU), the capacity
path, and the whole MoE block with shared experts: outputs, aux loss, expert load and
gradients. Tolerances: 1e-5 on values, 1e-4 on gradients (f32); indices and loads
exactly. Inputs keep routing scores apart, so top-k ties (which JAX and torch may break
differently) do not occur."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.moe import experts as jexperts
from automodel_tpu.moe import gate as jgate
from automodel_tpu.moe import layers as jlayers
from automodel_tpu.moe.config import MoEConfig as JaxMoEConfig
from automodel_tpu.moe.metrics import compute_load_balance_metrics as jax_metrics
from automodel_tpu_torch.moe import experts, gate, layers
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.metrics import compute_load_balance_metrics
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ATOL, ATOL_GRAD = 1e-5, 1e-4
BASE = dict(n_routed_experts=8, n_activated_experts=2, dim=32, moe_inter_dim=16)


def _cfgs(**kw):
    return MoEConfig(**BASE, **kw), JaxMoEConfig(**BASE, **kw)


def _params(cfg, seed=0, scale=0.3):
    """Nested numpy params of one MoE block; normal(0, scale), biases small."""
    rng = np.random.RandomState(seed)
    flat = {n: (rng.randn(*s) * (0.1 if n.endswith("bias") else scale)).astype(np.float32)
            for n, s in layers.moe_param_shapes(cfg).items()}
    return layers.nest_moe_params(flat)


def _x(t=24, d=32, seed=1):
    return np.random.RandomState(seed).randn(t, d).astype(np.float32)


def _mask(t=24):
    m = np.ones(t, bool)
    m[-5:] = False
    return m


def _tt(tree):
    """numpy tree -> torch tensors that require grad."""
    if isinstance(tree, dict):
        return {k: _tt(v) for k, v in tree.items()}
    return torch.tensor(tree, requires_grad=True)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _flat(v, f"{prefix}{k}.")
        else:
            out[f"{prefix}{k}"] = v
    return out


ROUTES = {
    "softmax_norm_topk": dict(softmax_before_topk=True, norm_topk_prob=True,
                              aux_loss_coeff=0.01),
    "softmax_renorm_scaled": dict(route_scale=2.5, aux_loss_coeff=0.01, router_bias=True),
    "sigmoid_groups": dict(score_func="sigmoid", n_expert_groups=4, n_limited_groups=2,
                           gate_bias_update_factor=1e-3, norm_topk_prob=True,
                           route_scale=2.5),
}


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("name", list(ROUTES))
def test_route_matches_jax(name, masked):
    cfg, jcfg = _cfgs(**ROUTES[name])
    gp = _params(cfg)["gate"]
    x = _x()
    mask = _mask() if masked else None
    ct = np.random.RandomState(3).randn(x.shape[0], cfg.n_activated_experts).astype(np.float32)

    def jax_fn(gp, x):
        w, idx, aux, load = jgate.route(jcfg, gp, x, None if mask is None else jnp.asarray(mask))
        return jnp.sum(w * ct) + (0.0 if aux is None else aux), (w, idx, aux, load)

    (_, (jw, jidx, jaux, jload)), jgrads = jax.value_and_grad(jax_fn, argnums=(0, 1),
                                                              has_aux=True)(
        jax.tree.map(jnp.asarray, gp), jnp.asarray(x))
    tgp, tx = _tt(gp), torch.tensor(x, requires_grad=True)
    w, idx, aux, load = gate.route(cfg, tgp, tx, None if mask is None else torch.tensor(mask))
    loss = (w * torch.tensor(ct)).sum() + (0.0 if aux is None else aux)
    grads = torch.autograd.grad(loss, [*tgp.values(), tx], allow_unused=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))
    assert (aux is None) == (jaux is None)
    if aux is not None:
        np.testing.assert_allclose(aux.item(), float(jaux), atol=ATOL, rtol=0)
    want = [jgrads[0][k] for k in tgp] + [jgrads[1]]
    for g, wg in zip(grads, want):
        g = np.zeros_like(np.asarray(wg)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(wg), atol=ATOL_GRAD, rtol=0)


def test_route_frozen_gate_and_eval():
    """train_gate=False stops the router's gradient; training=False drops the aux loss."""
    cfg = MoEConfig(**BASE, aux_loss_coeff=0.01, train_gate=False)
    tgp = _tt(_params(cfg)["gate"])
    w, _, aux, _ = gate.route(cfg, tgp, torch.tensor(_x()))
    assert not w.requires_grad and aux is not None
    assert gate.route(cfg, tgp, torch.tensor(_x()), training=False)[2] is None


def test_fake_balanced_route_matches_jax():
    cfg, jcfg = _cfgs()
    x = _x()
    got = gate.fake_balanced_route(cfg, torch.tensor(x), skip_first_n_experts=1)
    want = jgate.fake_balanced_route(jcfg, jnp.asarray(x), skip_first_n_experts=1)
    for g, w in ((got[0], want[0]), (got[1], want[1]), (got[3], want[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2] is None and want[2] is None
    with pytest.raises(NotImplementedError):
        gate.fake_balanced_route(cfg, torch.tensor(x), noise=0.1)


def test_update_gate_bias_matches_jax():
    rng = np.random.RandomState(4)
    bias, load = rng.randn(8).astype(np.float32), rng.randint(0, 9, 8).astype(np.float32)
    got = gate.update_gate_bias(torch.tensor(bias), torch.tensor(load), 1e-3)
    want = jgate.update_gate_bias(jnp.asarray(bias), jnp.asarray(load), 1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7, rtol=0)


def _routing(cfg, seed=5, t=24):
    """Route once (JAX side) so both implementations get the same weights/indices."""
    _, jcfg = _cfgs(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                       if f.name not in BASE})
    gp = jax.tree.map(jnp.asarray, _params(cfg, seed)["gate"])
    w, idx, _, _ = jgate.route(jcfg, gp, jnp.asarray(_x(t, seed=seed)))
    return np.asarray(w), np.asarray(idx)


EXPERT_PATHS = {
    "ragged_dot": dict(activation="swiglu"),
    "pallas": dict(activation="swiglu"),
    "ragged_dot_quick_geglu_bias": dict(activation="quick_geglu", expert_bias=True),
    "ragged_dot_relu2": dict(activation="relu2"),
}


@pytest.mark.parametrize("name", list(EXPERT_PATHS))
def test_grouped_experts_apply_matches_jax(name):
    spec = EXPERT_PATHS[name]
    cfg, jcfg = _cfgs(expert_activation=spec["activation"],
                      expert_bias=spec.get("expert_bias", False))
    ep = _params(cfg, seed=6)["experts"]
    x, mask = _x(seed=7), _mask()
    w, idx = _routing(cfg)
    ct = np.random.RandomState(8).randn(*x.shape).astype(np.float32)
    backend = name.split("_quick")[0].split("_relu")[0]

    def jax_fn(ep, x, w):
        y = jexperts.grouped_experts_apply(jcfg, ep, x, w, jnp.asarray(idx), jnp.asarray(mask),
                                           experts_backend=backend)
        return jnp.sum(y * ct), y

    (_, jy), jgrads = jax.value_and_grad(jax_fn, argnums=(0, 1, 2), has_aux=True)(
        jax.tree.map(jnp.asarray, ep), jnp.asarray(x), jnp.asarray(w))
    tep, tx, tw = _tt(ep), torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    y = experts.grouped_experts_apply(cfg, tep, tx, tw, torch.tensor(idx), torch.tensor(mask))
    grads = torch.autograd.grad((y * torch.tensor(ct)).sum(), [*tep.values(), tx, tw])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    want = [jgrads[0][k] for k in tep] + [jgrads[1], jgrads[2]]
    for g, wg in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), atol=ATOL_GRAD, rtol=0)


@pytest.mark.parametrize("capacity_factor", [1.0, 4.0], ids=["drops", "no_drops"])
def test_capacity_experts_apply_matches_jax(capacity_factor):
    cfg, jcfg = _cfgs()
    ep = _params(cfg, seed=9)["experts"]
    x, mask = _x(seed=10), _mask()
    w, idx = _routing(cfg, seed=11)
    ct = np.random.RandomState(12).randn(*x.shape).astype(np.float32)

    def jax_fn(ep, x):
        y = jexperts.capacity_experts_apply(jcfg, ep, x, jnp.asarray(w), jnp.asarray(idx),
                                            jnp.asarray(mask), capacity_factor=capacity_factor)
        return jnp.sum(y * ct), y

    (_, jy), jgrads = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, ep), jnp.asarray(x))
    tep, tx = _tt(ep), torch.tensor(x, requires_grad=True)
    y = experts.capacity_experts_apply(cfg, tep, tx, torch.tensor(w), torch.tensor(idx),
                                       torch.tensor(mask), capacity_factor=capacity_factor)
    grads = torch.autograd.grad((y * torch.tensor(ct)).sum(), [*tep.values(), tx])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    for g, wg in zip(grads, [jgrads[0][k] for k in tep] + [jgrads[1]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), atol=ATOL_GRAD, rtol=0)


MOE_BLOCKS = {
    "qwen3": dict(cfg=dict(softmax_before_topk=True, norm_topk_prob=True,
                           aux_loss_coeff=0.001), kw={}),
    "shared_experts": dict(cfg=dict(n_shared_experts=1, shared_expert_gate=True,
                                    aux_loss_coeff=0.01), kw={}),
    "capacity": dict(cfg=dict(aux_loss_coeff=0.01), kw=dict(dispatcher="capacity")),
    "fake_balanced": dict(cfg={}, kw=dict(fake_balanced_gate=True)),
}


@pytest.mark.parametrize("name", list(MOE_BLOCKS))
def test_moe_forward_matches_jax(name):
    spec = MOE_BLOCKS[name]
    cfg, jcfg = _cfgs(**spec["cfg"])
    params = _params(cfg, seed=13)
    x = np.random.RandomState(14).randn(2, 12, 32).astype(np.float32)
    mask = np.ones((2, 12), bool)
    mask[1, -4:] = False
    ct = np.random.RandomState(15).randn(*x.shape).astype(np.float32)

    def jax_fn(p, x):
        y, aux, load = jlayers.moe_forward(jcfg, p, x, jnp.asarray(mask), **spec["kw"])
        return jnp.sum(y * ct) + (0.0 if aux is None else aux), (y, aux, load)

    (_, (jy, jaux, jload)), jgrads = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp, tx = _tt(params), torch.tensor(x, requires_grad=True)
    y, aux, load = layers.moe_forward(cfg, tp, tx, torch.tensor(mask), **spec["kw"])
    loss = (y * torch.tensor(ct)).sum() + (0.0 if aux is None else aux)
    names = list(_flat(tp))
    grads = torch.autograd.grad(loss, [*_flat(tp).values(), tx], allow_unused=True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))
    assert (aux is None) == (jaux is None)
    if aux is not None:
        np.testing.assert_allclose(aux.item(), float(jaux), atol=ATOL, rtol=0)
    jflat = _flat(jgrads[0])
    for g, wg in zip(grads, [jflat[n] for n in names] + [jgrads[1]]):
        g = np.zeros_like(np.asarray(wg)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(wg), atol=ATOL_GRAD, rtol=0)


def test_cast_keeps_the_correction_bias_f32():
    cfg = MoEConfig(**BASE, gate_bias_update_factor=1e-3)
    cast = layers.cast_moe_compute_params(_tt(_params(cfg)), torch.bfloat16)
    assert cast["gate"]["score_correction_bias"].dtype == torch.float32
    assert cast["gate"]["weight"].dtype == cast["experts"]["down_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["brief", "detailed"])
def test_load_balance_metrics_match_jax(mode):
    loads = np.random.RandomState(16).randint(0, 50, (3, 8)).astype(np.float32)
    loads[1, 2] = 0
    assert compute_load_balance_metrics(loads, mode=mode) == jax_metrics(loads, mode=mode)
