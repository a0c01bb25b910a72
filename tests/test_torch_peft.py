"""The port's LoRA (peft/lora.py), QLoRA quantization (quantization/qlora.py), QAT
(quantization/qat.py), logical axes and random streams against the JAX package, on the
same numpy inputs:

- logical axes and LoRA matching equal JAX's for every ported family (tiny configs),
  under the default targets, HF aliases, excludes and match_all_linear;
- merges (LoRA, DoRA, dropout with JAX's own keep-masks, int8 and nf4 bases) within
  1e-6 (f32);
- int8 and nf4 codes and scales bitwise, dequantized weights bitwise;
- fake_quant bitwise, its gradient the identity;
- a tiny Llama's adapter gradients under the merged loss within 1e-5 of jax.grad's.
"""

import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.registry import resolve_model_class as jax_model_class
from automodel_tpu.ops import losses as jlosses
from automodel_tpu.peft import lora as jlora
from automodel_tpu.quantization import qat as jqat, qlora as jqlora
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.common.logical_axes import logical_axes
from automodel_tpu_torch.models.llama.convert import flatten, params_from_jax, to_torch
from automodel_tpu_torch.models.registry import resolve_model_class
from automodel_tpu_torch.ops import losses as tlosses
from automodel_tpu_torch.peft import lora as tlora
from automodel_tpu_torch.quantization import qat as tqat, qlora as tqlora
from automodel_tpu_torch.training.rng import StatefulRNG
from tests.test_torch_deepseek_v3 import TINY as DEEPSEEK_V3
from tests.test_torch_gemma import GEMMA2, GEMMA3
from tests.test_torch_gpt_oss import HF as GPT_OSS
from tests.test_torch_llama import HF as LLAMA
from tests.test_torch_phi3 import FAMILIES as LLAMA_LINEAGE, PHI3
from tests.test_torch_qwen3_moe import HF as QWEN3_MOE
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

FAMILIES = {"llama": LLAMA, "qwen2": LLAMA_LINEAGE["qwen2"], "phi3": PHI3, "gemma2": GEMMA2,
            "gemma3": GEMMA3, "gpt_oss": GPT_OSS, "qwen3_moe": QWEN3_MOE,
            "deepseek_v3": DEEPSEEK_V3}
MATCHERS = {
    "default": {},
    "hf_aliases": dict(target_modules=["q_proj", "v_proj", "down_proj", "linear_qkv"]),
    "excludes": dict(target_modules=["*"], exclude_modules=["*wo", "moe_layers.*",
                                                            "dense_layers.*"]),
    "all_linear": dict(match_all_linear=True),
}
TOL_MERGE, TOL_GRAD = 1e-6, 1e-5


def _configs(hf):
    arch = hf["architectures"][0]
    jcls, tcls = jax_model_class(arch), resolve_model_class(arch)
    jm = jcls(jcls.config_class.from_hf(hf), JaxBackend())
    return jm, tcls, tcls.config_class.from_hf(hf)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_logical_axes_match_jax(family):
    jm, tcls, tcfg = _configs(FAMILIES[family])
    want = dict(flatten(jm.logical_axes()))
    assert logical_axes(tcfg.param_shapes(), tcls.layer_axes) == want


@pytest.mark.parametrize("matcher", list(MATCHERS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_lora_matching_matches_jax(family, matcher):
    jm, tcls, tcfg = _configs(FAMILIES[family])
    want = jlora.match_lora_paths(jm.logical_axes(), jlora.PeftConfig(**MATCHERS[matcher]))
    got = tlora.match_lora_paths(logical_axes(tcfg.param_shapes(), tcls.layer_axes),
                                 tlora.PeftConfig(**MATCHERS[matcher]))
    assert got == want and (got or matcher == "excludes")


# a tiny Llama's weights and adapter, from numpy
def _llama():
    jm, _, tcfg = _configs(LLAMA)
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda s: (rng.randn(*s.shape) * 0.05).astype(np.float32),
                          jax.eval_shape(lambda: jm.init(jax.random.key(0))))
    return jm, tcfg, params


def _adapter(params, axes, cfg, seed=1):
    """A nested JAX adapter tree with random A, B and magnitude."""
    rng = np.random.RandomState(seed)
    lora = jax.device_get(jlora.init_lora_params(params, axes, cfg, jax.random.key(seed)))
    return jax.tree.map(lambda x: (rng.randn(*x.shape) * 0.1).astype(np.float32), lora)


def _keep_masks(lora, cfg, rng):
    """JAX's dropout masks for ``rng``, by path (its merge's own fold_in)."""
    out = {}
    for path, leaf in jlora._flatten_lora(lora):
        key = jax.random.fold_in(rng, zlib.crc32(path.encode()) % (2**31))
        out[path] = np.asarray(jax.random.bernoulli(key, 1.0 - cfg.dropout,
                                                    leaf["lora_a"].shape[:-1]))
    return out


MERGES = {"lora": ({}, None), "dora": (dict(use_dora=True), None),
          "dropout": (dict(dropout=0.25), None),
          "dora_dropout": (dict(use_dora=True, dropout=0.5), None),
          "int8": ({}, "int8"), "nf4": ({}, "nf4"), "dora_nf4": (dict(use_dora=True), "nf4")}


@pytest.mark.parametrize("case", list(MERGES))
def test_merge_matches_jax(case):
    kw, scheme = MERGES[case]
    jm, tcfg, params = _llama()
    jcfg, tcfg_peft = jlora.PeftConfig(**kw), tlora.PeftConfig(**kw)
    axes = jm.logical_axes()
    lora = _adapter(params, axes, jcfg)
    jbase, tbase = params, params_from_jax(params, tcfg)
    if scheme:
        matched = jlora.match_lora_paths(axes, jcfg)
        jbase = jqlora.quantize_params(jax.tree.map(jnp.asarray, params), matched, scheme)
        tbase = tqlora.quantize_params(tbase, tlora.match_lora_paths(axes, tcfg_peft), scheme)
    rng = jax.random.key(3) if jcfg.dropout else None
    want = flatten(jax.device_get(jlora.merge_lora_params(jbase, lora, jcfg, dropout_rng=rng)))
    masks = ({k: torch.tensor(v) for k, v in _keep_masks(lora, jcfg, rng).items()}
             if rng is not None else None)
    got = tlora.merge_lora_params(tbase, {k: to_torch(v) for k, v in flatten(lora).items()},
                                  tcfg_peft, keep_masks=masks)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert not tqlora.is_quantized_leaf(got[name])
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0, atol=TOL_MERGE, err_msg=name)


def test_dropout_draws_from_the_generator():
    """A generator draws a fresh keep-mask a merge; the same generator state gives the
    same merge."""
    _, tcfg, params = _llama()
    cfg = tlora.PeftConfig(dropout=0.5)
    base = params_from_jax(params, tcfg)
    lora = tlora.init_lora_params(base, logical_axes(tcfg.param_shapes()), cfg,
                                  torch.Generator().manual_seed(0))
    lora = {k: v + 0.1 if k.endswith("lora_b") else v for k, v in lora.items()}
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    first = tlora.merge_lora_params(base, lora, cfg, g)["layers.wq"]
    second = tlora.merge_lora_params(base, lora, cfg, g)["layers.wq"]
    g.set_state(state)
    again = tlora.merge_lora_params(base, lora, cfg, g)["layers.wq"]
    assert torch.equal(first, again) and not torch.equal(first, second)


@pytest.mark.parametrize("n_stack,shape", [(1, (3, 64, 4, 16)), (0, (96, 40)),
                                           (1, (2, 37, 11)), (2, (2, 4, 48, 24))])
@pytest.mark.parametrize("scheme", ["int8", "nf4"])
def test_quantization_is_bitwise_jax(scheme, n_stack, shape):
    rng = np.random.RandomState(sum(shape))
    w = (rng.randn(*shape) * 0.05).astype(np.float32)
    w.reshape(-1)[::97] *= 20  # outliers
    want = jqlora.quantize_leaf(jnp.asarray(w), scheme, n_stack)
    got = tqlora.quantize_leaf(torch.from_numpy(w), scheme, n_stack)
    assert got.shape == tuple(want.shape) and got.scheme == scheme
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(tqlora.dequantize_leaf(got).numpy(),
                                  np.asarray(jqlora.dequantize_leaf(want)))
    assert got.nbytes == want.nbytes


def test_bf16_weight_quantizes_and_dequantizes_to_bf16():
    w = torch.randn(2, 64, 32, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    for scheme in ("int8", "nf4"):
        leaf = tqlora.quantize_leaf(w, scheme, 1)
        assert leaf.orig_dtype == "bfloat16"
        assert tqlora.dequantize_leaf(leaf).dtype == torch.bfloat16
    params = tqlora.quantize_params({"a": w, "b": w}, ["a"], "nf4")
    assert tqlora.tree_nbytes(params) == params["a"].nbytes + w.numel() * 2


@pytest.mark.parametrize("bits,group,shape", [(4, 32, (8, 64)), (8, 32, (2, 16, 48)),
                                              (4, 64, (5, 7))])
def test_fake_quant_matches_jax(bits, group, shape):
    rng = np.random.RandomState(bits + group)
    w = (rng.randn(*shape) * 0.1).astype(np.float32)
    want = np.asarray(jqat.fake_quant(jnp.asarray(w), bits, group))
    wt = torch.from_numpy(w).requires_grad_()
    got = tqat.fake_quant(wt, bits, group)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    (grad,) = torch.autograd.grad(got, wt, g)
    assert torch.equal(grad, g)  # straight through
    cfg = tqat.QATConfig(weight_bits=bits, group_size=group)
    paths = tqat.fake_quant_params({"x": wt, "y": wt}, ["x"], cfg)
    assert torch.equal(paths["x"], got) and paths["y"] is wt


@pytest.mark.parametrize("kw", [{}, dict(use_dora=True)], ids=["lora", "dora"])
def test_adapter_grads_match_jax(kw):
    """d loss / d adapter of a tiny Llama's masked CE on the merged weights (the
    adapter on q, v and the down projection)."""
    jm, tcfg, params = _llama()
    cfg = dict(kw, target_modules=["*wq", "*wv", "*w_down"])
    jcfg, tcfg_peft = jlora.PeftConfig(**cfg), tlora.PeftConfig(**cfg)
    lora = _adapter(params, jm.logical_axes(), jcfg)
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 128, (2, 16)).astype(np.int32)
    labels = rng.randint(0, 128, (2, 16)).astype(np.int32)
    labels[0, :3] = -100
    n = int((labels != -100).sum())
    jmodel = jax_model_class("LlamaForCausalLM").from_config(
        LLAMA, JaxBackend(dtype="float32", remat_policy="full"))

    def jloss(lo):
        merged = jlora.merge_lora_params(params, lo, jcfg)
        return jlosses.masked_cross_entropy(jmodel(merged, jnp.asarray(ids)),
                                            jnp.asarray(labels), n)

    want_loss, want = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, lora))
    want = flatten(jax.device_get(want))
    tmodel = resolve_model_class("LlamaForCausalLM").from_config(
        LLAMA, BackendConfig(dtype="float32"), device="cpu")
    base = params_from_jax(params, tmodel.config)
    tl = {k: to_torch(v).requires_grad_() for k, v in flatten(lora).items()}
    loss = tlora.lora_merged_loss(
        lambda merged, x, y: tlosses.masked_cross_entropy(
            tmodel(x, params=merged), y, torch.tensor(n)),
        lambda: base, tl, tcfg_peft)(torch.tensor(ids), torch.tensor(labels))
    grads = torch.autograd.grad(loss, list(tl.values()))
    assert loss.item() == pytest.approx(float(want_loss), abs=1e-5)
    for (name, _), g in zip(tl.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0, atol=TOL_GRAD, err_msg=name)
    assert tlora.count_lora_params(tl) == sum(v.size for v in want.values())


def test_init_shapes_dtypes_and_zero_b():
    """A of (*stack, fan_in, r), B zeros of (*stack, r, fan_out) (step 0 is the base),
    DoRA's magnitude the weights' column norms, the dtype rule explicit > lora_dtype >
    the weight's."""
    _, tcfg, params = _llama()
    base = params_from_jax(params, tcfg)
    axes = logical_axes(tcfg.param_shapes())
    cfg = tlora.PeftConfig(target_modules=["*wo"], use_dora=True, lora_dtype="bfloat16")
    lora = tlora.init_lora_params(base, axes, cfg, torch.Generator().manual_seed(0))
    layers, n, h, d = base["layers.wo"].shape
    assert lora["layers.wo.lora_a"].shape == (layers, n * h, 8)
    assert lora["layers.wo.lora_b"].shape == (layers, 8, d) and not lora["layers.wo.lora_b"].any()
    assert lora["layers.wo.lora_a"].dtype == torch.bfloat16
    norms = base["layers.wo"].reshape(layers, n * h, d).norm(dim=-2)
    torch.testing.assert_close(lora["layers.wo.magnitude"].float(), norms, rtol=1e-2, atol=0)
    merged = tlora.merge_lora_params(base, {k: v.float() for k, v in lora.items()}, cfg)
    torch.testing.assert_close(merged["layers.wo"], base["layers.wo"], rtol=1e-2, atol=1e-3)
    with pytest.raises(ValueError, match="matched no params"):
        tlora.init_lora_params(base, axes, tlora.PeftConfig(target_modules=["*nothing"]),
                               torch.Generator())


def test_rng_streams_round_trip():
    rng = StatefulRNG(3)
    g = rng.generator("lora_dropout")
    g.manual_seed(11)
    torch.rand(5, generator=g)
    state = rng.state_dict()
    want = torch.rand(4, generator=g)
    other = StatefulRNG(99)
    held = other.generator("lora_dropout")
    other.load_state_dict(state)
    assert other.generator("lora_dropout") is held  # restored in place
    assert torch.equal(torch.rand(4, generator=held), want)
    fresh = [StatefulRNG(3).generator(name).initial_seed() for name in ("a", "b")]
    assert fresh[0] != fresh[1] and fresh[0] == StatefulRNG(3).generator("a").initial_seed()
    assert math.isfinite(float(torch.rand(1, generator=StatefulRNG(0).generator())))
