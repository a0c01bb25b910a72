"""The port's Mixtral against the JAX package's, f32, on a tiny config (vocab 128, hidden
64, 2 layers, 4 heads of 16 over 2, 8 experts top-2, aux coefficient 0.02). The same
numpy-seeded weights go through both models: logits, the aux loss, the expert load and
every gradient agree (values and gradients to rtol = atol = 1e-4), on the einsum path
with ragged_dot experts and on the flash path with the pallas experts (the port's plain
versions on the CPU, JAX's kernels in interpret mode). Also: the config, the routing
(HF's top-2 of the logits then a softmax over them, as the gate's renormalised softmax
computes it), the HF adapter's names and values (``block_sparse_moe``, w1 / w3 / w2) and
its bitwise round trip, the logical axes, and the FLOP count beside JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.mixtral.model import MixtralConfig as JaxMixtralConfig
from automodel_tpu.models.mixtral.model import MixtralForCausalLM as JaxMixtral
from automodel_tpu.moe import gate as jgate
from automodel_tpu.utils.flops import flops_per_token as jax_flops
from automodel_tpu_torch.models.auto import AutoModelForCausalLM
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.llama.convert import flatten
from automodel_tpu_torch.models.mixtral.model import MixtralConfig, MixtralForCausalLM
from automodel_tpu_torch.moe import gate
from automodel_tpu_torch.utils.flops import flops_per_token
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

HF = dict(architectures=["MixtralForCausalLM"], vocab_size=128, hidden_size=64,
          intermediate_size=32, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, num_local_experts=8, num_experts_per_tok=2,
          max_position_embeddings=256, rope_theta=1e6, rms_norm_eps=1e-5,
          router_aux_loss_coef=0.02, sliding_window=None, tie_word_embeddings=False)
PATHS = {"xla": (("xla", "ragged_dot"), ("xla", "ragged_dot")),
         "flash": (("flash_interpret", "pallas"), ("flash", "pallas"))}


def _unflatten(flat):
    tree = {}
    for name, value in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _weights(cfg, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in cfg.param_shapes().items():
        x = rng.randn(*shape).astype(np.float32)
        leaf = name.rsplit(".", 1)[-1]
        out[name] = x if leaf == "embed" else 1.0 + 0.2 * x if leaf.endswith("norm") \
            else 0.1 * x
    return out


def _batch(seed=0, b=2, s=32):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, (b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    seg[0, s // 2:] = 2
    seg[1, s - 6:] = 0
    pos = np.concatenate([np.arange(s // 2), np.arange(s // 2)])[None].repeat(b, 0)
    pos[1] = np.arange(s)
    return ids, pos.astype(np.int32), seg


def test_from_hf_matches_jax():
    for extra in ({}, dict(num_experts_per_tok=1, router_aux_loss_coef=0.0),
                  dict(sliding_window=16, head_dim=32)):
        hf = dict(HF, **extra)
        got, want = MixtralConfig.from_hf(hf), JaxMixtralConfig.from_hf(hf)
        assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
        for f in dataclasses.fields(got):
            if f.name != "moe":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
    cfg = MixtralConfig.from_hf(HF)
    assert (cfg.moe.softmax_before_topk, cfg.moe.norm_topk_prob, cfg.moe.aux_loss_coeff) == (
        True, True, 0.02)
    assert MixtralConfig.from_hf({k: v for k, v in HF.items()
                                  if k != "router_aux_loss_coef"}).moe.aux_loss_coeff == 0.02
    assert type(AutoModelForCausalLM.from_config(HF, device="cpu")) is MixtralForCausalLM


@pytest.mark.parametrize("path", list(PATHS))
def test_logits_stats_and_grads_match_jax(path):
    (j_attn, j_exp), (t_attn, t_exp) = PATHS[path]
    cfg = MixtralConfig.from_hf(HF)
    weights = _weights(cfg)
    ids, pos, seg = _batch()
    mask = seg != 0
    ct = np.random.RandomState(1).randn(*ids.shape, 128).astype(np.float32) / ids.size
    jm = JaxMixtral.from_config(HF, JaxBackend(dtype="float32", remat_policy="full",
                                               attention=j_attn, experts_backend=j_exp))

    def jax_loss(p):
        logits, stats = jm(p, jnp.asarray(ids), positions=jnp.asarray(pos),
                           segment_ids=jnp.asarray(seg), token_mask=jnp.asarray(mask))
        return jnp.sum(logits * ct) + stats["aux_loss"], (logits, stats)

    (_, (jlogits, jstats)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        _unflatten({k: jnp.asarray(v) for k, v in weights.items()}))
    tm = MixtralForCausalLM(cfg, BackendConfig(dtype="float32", remat_policy="mlp_dots",
                                               attention=t_attn, experts_backend=t_exp),
                            device="cpu")
    tm.load_params({k: torch.from_numpy(v) for k, v in weights.items()})
    logits, stats = tm(torch.from_numpy(ids), positions=torch.from_numpy(pos),
                       segment_ids=torch.from_numpy(seg), token_mask=torch.from_numpy(mask))
    names = list(tm.param_dict())
    grads = torch.autograd.grad((logits * torch.from_numpy(ct)).sum() + stats["aux_loss"],
                                list(tm.param_dict().values()))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(stats["aux_loss"].item(), float(jstats["aux_loss"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(stats["expert_load"].numpy(), np.asarray(jstats["expert_load"]))
    assert stats["expert_load"].sum().item() == 2 * 2 * mask.sum()  # layers x top-2 x valid
    jflat = flatten(jax.device_get(jgrads))
    assert set(jflat) == set(names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
def test_routing_and_aux_loss(masked):
    """Mixtral's routing: the two experts of the largest logits, weighted by a softmax over
    those two logits (HF's MixtralSparseMoeBlock), equal to the gate's softmax over all
    experts renormalised over the top two; weights, indices, load and aux loss as JAX's,
    the aux loss E / (k T^2) sum_e load_e P_e over the valid tokens."""
    cfg, jcfg = MixtralConfig.from_hf(HF).moe, JaxMixtralConfig.from_hf(HF).moe
    rng = np.random.RandomState(4)
    weight = rng.randn(8, 64).astype(np.float32)
    x = rng.randn(40, 64).astype(np.float32)
    mask = rng.rand(40) > 0.2 if masked else np.ones(40, bool)
    w, idx, aux, load = gate.route(cfg, {"weight": torch.from_numpy(weight)},
                                   torch.from_numpy(x), torch.from_numpy(mask))
    jw, jidx, jaux, jload = jgate.route(jcfg, {"weight": jnp.asarray(weight)}, jnp.asarray(x),
                                        jnp.asarray(mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6, atol=1e-7)
    logits = x @ weight.T
    top = np.argsort(-logits, axis=-1)[:, :2]
    sel = np.take_along_axis(logits, top, -1)
    hf_w = np.exp(sel - sel.max(-1, keepdims=True))
    hf_w /= hf_w.sum(-1, keepdims=True)
    np.testing.assert_array_equal(np.sort(idx.numpy(), -1), np.sort(top, -1))
    np.testing.assert_allclose(np.take_along_axis(w.numpy(), np.argsort(idx.numpy(), -1), -1),
                               np.take_along_axis(hf_w, np.argsort(top, -1), -1),
                               rtol=1e-5, atol=1e-6)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    t = mask.sum()
    counts = np.zeros(8)
    np.add.at(counts, top[mask].reshape(-1), 1)
    want = 8 / (2 * t * t) * np.sum(counts * probs[mask].sum(0))
    np.testing.assert_allclose(aux.item(), want, rtol=1e-5)


def test_adapter_matches_jax_and_round_trips():
    cfg = MixtralConfig.from_hf(HF)
    model = MixtralForCausalLM(cfg, device="cpu")
    weights = _weights(cfg, seed=2)
    flat = {k: torch.from_numpy(v) for k, v in weights.items()}
    adapter = model.state_dict_adapter()
    ours = adapter.to_hf(flat)
    theirs = JaxMixtral.from_config(HF).state_dict_adapter().to_hf(_unflatten(weights))
    assert sorted(ours) == sorted(theirs)
    assert "model.layers.1.block_sparse_moe.experts.7.w3.weight" in ours
    assert "model.layers.0.block_sparse_moe.gate.weight" in ours
    for key, value in ours.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(theirs[key]), err_msg=key)
    back = adapter.from_hf(ours)
    assert set(back) == set(flat)
    for key, value in flat.items():
        assert torch.equal(back[key], value), key


def test_logical_axes_match_jax():
    jm = JaxMixtral.from_config(HF)
    tm = MixtralForCausalLM(MixtralConfig.from_hf(HF), device="cpu")
    assert tm.logical_axes() == flatten(jm.logical_axes())


def test_flops_count_the_top2_experts():
    """The port counts Mixtral's two active experts; JAX's formula reads no
    num_local_experts and counts one dense MLP of intermediate_size: the port's count is
    JAX's plus one MLP a layer (3 x 2 D I forward, times 3 for training)."""
    d, i, L = HF["hidden_size"], HF["intermediate_size"], HF["num_hidden_layers"]
    got, want = flops_per_token(HF, 4096), jax_flops(HF, 4096)
    assert got == pytest.approx(want + 3 * L * 3 * 2 * d * i, rel=1e-12)
    dense = {k: v for k, v in HF.items() if k != "num_local_experts"}
    assert flops_per_token(dense, 4096) == pytest.approx(want, rel=1e-12)
