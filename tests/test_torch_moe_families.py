"""The port's Qwen3-MoE with attention biases, GLM-4-MoE and MiniMax-M2 against the JAX
package's, f32, on tiny configs (vocab 128, hidden 64, 4 heads of 16 over 2, 8 experts
top-2): weights and batches from numpy seeds (``tests/torch_parity.py``), carried into
both by name.

- ``from_hf`` equals JAX's reading, field for field and the MoE config, on each tiny
  config, on ``glm4_moe_proxy.yaml``'s ``config:`` block and on the published dicts
  ``chip_smoke.py`` lays over its YAMLs (GLM-4.5-Air, MiniMax-M2: ``rotary_dim`` is not
  read, ``use_qk_norm`` is, as in JAX).
- Logits, the aux loss, the expert load and every gradient under xla attention, atol 1e-4,
  on packed rows with padding and the token mask.
- Three train steps of 2 microbatches (adamw with weight decay and clipping): the losses
  within 1e-5, and GLM-4-MoE's correction bias after each step (its gate-bias update)
  within 1e-7.
- The HF adapters: JAX's keys and values, a bitwise round trip, and a reload through the
  port's safetensors and ``from_pretrained`` (the correction bias in f32).
- ``logical_axes()`` equals JAX's; ``flops_per_token`` equals JAX's, but for MiniMax-M2,
  whose ``num_local_experts`` JAX's formula does not read (it counts one dense MLP where
  the port counts the top-k experts).
"""

import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.moe.gate import make_gate_bias_post_update as jax_post_update
from automodel_tpu.utils.flops import flops_per_token as jax_flops
from automodel_tpu_torch.checkpoint.safetensors_io import save_safetensors
from automodel_tpu_torch.models.auto import AutoModelForCausalLM
from automodel_tpu_torch.models.llama.convert import flatten
from automodel_tpu_torch.models.registry import resolve_model_class
from automodel_tpu_torch.moe.gate import make_gate_bias_post_update
from automodel_tpu_torch.utils.flops import flops_per_token
from tests.torch_parity import (assert_forward_and_grads_match, batch, jax_tree, port_model,
                                trajectories)
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

_BASE = dict(vocab_size=128, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, max_position_embeddings=128, rms_norm_eps=1e-6)
TINY = {
    "qwen3_moe_bias": dict(_BASE, architectures=["Qwen3MoeForCausalLM"], intermediate_size=96,
                           moe_intermediate_size=32, num_hidden_layers=2, num_experts=8,
                           num_experts_per_tok=2, norm_topk_prob=True, attention_bias=True,
                           router_aux_loss_coef=0.01, rope_theta=1e6),
    "glm4_moe": dict(_BASE, architectures=["Glm4MoeForCausalLM"], intermediate_size=96,
                     moe_intermediate_size=32, num_hidden_layers=3, first_k_dense_replace=1,
                     partial_rotary_factor=0.5, n_routed_experts=8, num_experts_per_tok=2,
                     n_shared_experts=1, n_group=4, topk_group=2, norm_topk_prob=True,
                     routed_scaling_factor=2.5, attention_bias=True, use_qk_norm=True,
                     rope_theta=1e6),
    "minimax_m2": dict(_BASE, architectures=["MiniMaxM2ForCausalLM"], intermediate_size=32,
                       num_hidden_layers=2, num_local_experts=8, num_experts_per_tok=2,
                       scoring_func="sigmoid", router_aux_loss_coef=0.01, use_qk_norm=True,
                       rotary_dim=8, rope_parameters={"rope_theta": 5e6,
                                                      "partial_rotary_factor": 0.5}),
}
JAX_MODULES = {"Qwen3MoeForCausalLM": "automodel_tpu.models.qwen3_moe.model",
               "Glm4MoeForCausalLM": "automodel_tpu.models.glm4_moe.model",
               "MiniMaxM2ForCausalLM": "automodel_tpu.models.minimax_m2.model"}
BIAS = "moe_layers.moe.gate.score_correction_bias"


def _glm_proxy():
    with open("examples/benchmark/glm4_moe_proxy.yaml") as f:
        return yaml.safe_load(f)["model"]["config"]


SOURCES = {"qwen3_moe_bias": TINY["qwen3_moe_bias"], "glm4_moe": TINY["glm4_moe"],
           "minimax_m2": TINY["minimax_m2"], "glm4_moe_proxy_yaml": _glm_proxy(),
           "glm45_air": chip_smoke.GLM45_AIR, "minimax_m2_published": chip_smoke.MINIMAX_M2}


def _classes(hf):
    arch = hf["architectures"][0]
    jax_cls = getattr(importlib.import_module(JAX_MODULES[arch]), arch)
    return AutoModelForCausalLM.model_class(hf), jax_cls


@pytest.mark.parametrize("name", list(SOURCES))
def test_from_hf_matches_jax(name):
    hf = SOURCES[name]
    cls, jax_cls = _classes(hf)
    got, want = cls.config_class.from_hf(hf), jax_cls.config_class.from_hf(hf)
    assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
    for f in dataclasses.fields(got):
        if f.name != "moe":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert resolve_model_class(hf["architectures"][0]) is cls
    if name == "minimax_m2_published":  # rotary_dim 64 is not read; use_qk_norm is
        assert (got.partial_rotary_factor, got.qk_norm, got.moe.aux_loss_coeff) == (1.0, True,
                                                                                   0.001)
    if name == "glm45_air":
        assert (got.attention_bias, got.qk_norm, got.first_k_dense_replace,
                got.moe.gate_bias_update_factor, got.partial_rotary_factor) == (
            True, False, 1, 0.001, 0.5)


def _models(name, seed=0):
    hf = TINY[name]
    cls, jax_cls = _classes(hf)
    params = jax_tree(cls.config_class.from_hf(hf).param_shapes(), seed)
    jm = jax_cls.from_config(hf, JaxBackend(dtype="float32", remat_policy="full"))
    return hf, params, jm, port_model(cls, hf, params)


@pytest.mark.parametrize("name", list(TINY))
def test_logits_stats_and_grads_match_jax(name):
    hf, params, jm, model = _models(name)
    stats = assert_forward_and_grads_match(jm, model, params, *batch(), vocab=128)
    if name == "qwen3_moe_bias":
        assert {"moe_layers.bq", "moe_layers.bk", "moe_layers.bv"} <= set(model.param_dict())
    assert (stats["aux_loss"] is None) == (name == "glm4_moe")  # GLM: no aux loss


@pytest.mark.parametrize("name", list(TINY))
def test_three_steps_match_jax(name):
    hf, params, jm, model = _models(name, seed=4)
    factor = model.config.moe.gate_bias_update_factor
    coeff = model.config.moe.aux_loss_coeff
    watch = BIAS if factor > 0 else None
    (want, want_bias), (got, got_bias) = trajectories(
        jm, model, params, 128, jax_post=jax_post_update(factor) if factor else None,
        port_post=make_gate_bias_post_update(factor) if factor else None, watch=watch,
        aux_coeff=coeff)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (factor > 0) == (name == "glm4_moe")
    for step, (g, w) in enumerate(zip(got_bias, want_bias)):
        np.testing.assert_allclose(g, w, atol=1e-7, rtol=0, err_msg=f"step {step + 1}")
    if watch:
        assert model.param_dict()[BIAS].dtype == torch.float32
        assert not np.allclose(got_bias[-1], flatten(params)[BIAS])


@pytest.mark.parametrize("name", list(TINY))
def test_adapter_matches_jax_and_reloads(name, tmp_path):
    hf, params, jm, model = _models(name, seed=2)
    ours = model.state_dict_adapter().to_hf(model.param_dict())
    theirs = jm.state_dict_adapter().to_hf(params)
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)
    back = model.state_dict_adapter().from_hf(ours)
    for key, p in model.param_dict().items():
        assert torch.equal(back[key], p), key
    save_safetensors(ours, str(tmp_path))
    (tmp_path / "config.json").write_text(json.dumps(hf))
    loaded = AutoModelForCausalLM.from_pretrained(str(tmp_path), dtype=torch.bfloat16,
                                                  device="cpu").param_dict()
    for key, p in model.param_dict().items():
        want = p if key == BIAS else p.to(torch.bfloat16)
        assert torch.equal(loaded[key], want), key
    if name != "qwen3_moe_bias":
        assert loaded[BIAS].dtype == torch.float32
        assert "model.layers.1.mlp.gate.e_score_correction_bias" in ours


@pytest.mark.parametrize("name", list(TINY))
def test_logical_axes_match_jax(name):
    hf, _, jm, model = _models(name)
    assert model.logical_axes() == flatten(jm.logical_axes())


@pytest.mark.parametrize("name", [n for n in SOURCES if n != "qwen3_moe_bias"])
def test_flops_match_jax(name):
    """Equal to JAX's count, but MiniMax-M2's: JAX's formula reads no num_local_experts
    and counts each layer's MLP as one dense MLP of intermediate_size, where the port
    counts the top-k experts (k - 1 MLPs more a layer)."""
    hf = SOURCES[name]
    for seq in (2048, 4096):
        got, want = flops_per_token(hf, seq), jax_flops(hf, seq)
        if "num_local_experts" not in hf:
            assert got == want
            continue
        d, i, k = hf["hidden_size"], hf["intermediate_size"], hf["num_experts_per_tok"]
        assert got == pytest.approx(want + 3 * hf["num_hidden_layers"] * 3 * 2 * d * i * (k - 1),
                                    rel=1e-12)
        assert got == jax_flops(dict(hf, num_experts=hf["num_local_experts"]), seq)
