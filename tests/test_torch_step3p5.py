"""The port's Step-3.5 against the JAX package's, f32, on a tiny config (vocab 128, hidden
32, head_dim 8, 4 layers: full / sliding alternating, the sliding ones at 8 heads over 4
through ``attention_other_setting`` and a window of 8, the head-wise gate, per-layer
RoPE theta and partial factors with RoPE off on one layer, MoE on layers 2-3 (8 experts
top-2, sigmoid with the router bias) beside a clamped shared expert, the dense MLP
clamped): weights and batches from numpy seeds (``tests/torch_parity.py``).

- ``from_hf`` equals JAX's reading and per-layer settings (heads, RoPE theta / factor /
  on-off, the clamps, the streams) on the tiny config, on ``step3p5_proxy.yaml``'s block
  (``moe_layers_enum`` a string) and on the Step-3.5 geometry in ``chip_smoke.py``
  (``STEP35_FLASH``, unverified against the published config).
- Logits, the expert load and every gradient under xla attention, atol 1e-4, with and
  without the clamps; three train steps of 2 microbatches, losses within 1e-5.
- The HF adapter: JAX's keys and values, a bitwise round trip and a reload through
  ``from_pretrained``; ``logical_axes()`` and ``flops_per_token`` equal JAX's (which
  reads no ``moe_num_experts``: it counts Step's MLPs as dense, and so does the port).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.step3p5.model import Step3p5Config as JaxConfig
from automodel_tpu.models.step3p5.model import Step3p5ForCausalLM as JaxStep
from automodel_tpu.utils.flops import flops_per_token as jax_flops
from automodel_tpu_torch.checkpoint.safetensors_io import save_safetensors
from automodel_tpu_torch.models.auto import AutoModelForCausalLM
from automodel_tpu_torch.models.llama.convert import flatten
from automodel_tpu_torch.models.step3p5.model import Step3p5Config, Step3p5ForCausalLM
from automodel_tpu_torch.utils.flops import flops_per_token
from tests.torch_parity import (assert_forward_and_grads_match, batch, jax_tree, port_model,
                                trajectories)
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TINY = dict(architectures=["Step3p5ForCausalLM"], vocab_size=128, hidden_size=32,
            intermediate_size=48, num_hidden_layers=4, num_attention_heads=4,
            num_attention_groups=2, head_dim=8,
            layer_types=["full_attention", "sliding_attention"] * 2,
            attention_other_setting={"num_attention_heads": 8, "num_attention_groups": 4},
            sliding_window=8, use_head_wise_attn_gate=True,
            rope_theta=[1e4, 1e4, 5e4, 5e4], partial_rotary_factors=[1.0, 1.0, 0.5, 0.5],
            use_rope_layers=[1, 1, 0, 1], moe_layers_enum="2,3", moe_num_experts=8,
            moe_top_k=2, moe_intermediate_size=16, share_expert_dims=24,
            moe_router_activation="sigmoid", use_moe_router_bias=True,
            moe_router_scaling_factor=2.0, swiglu_limits_shared=[0.05, 0.0, 0.05, 0.05])
# no gate, no router bias, softmax routing, no clamp, one RoPE for all
PLAIN = dict(TINY, use_head_wise_attn_gate=False, use_moe_router_bias=False,
             moe_router_activation="softmax", swiglu_limits_shared=None, rope_theta=1e4,
             partial_rotary_factors=None, use_rope_layers=None, moe_layers_enum=[1, 3])
CONFIGS = {"tiny": TINY, "plain": PLAIN}


def _proxy():
    with open("examples/benchmark/step3p5_proxy.yaml") as f:
        return yaml.safe_load(f)["model"]["config"]


SOURCES = {"tiny": TINY, "plain": PLAIN, "proxy_yaml": _proxy(),
           "step35_flash": chip_smoke.STEP35_FLASH}


@pytest.mark.parametrize("name", list(SOURCES))
def test_from_hf_matches_jax(name):
    hf = SOURCES[name]
    got, want = Step3p5Config.from_hf(hf), JaxConfig.from_hf(hf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for i in range(got.num_hidden_layers):
        for meth in ("attn_kind", "heads", "ffn_kind", "theta", "prf", "use_rope",
                     "shared_limit", "stream_key"):
            assert getattr(got, meth)(i) == getattr(want, meth)(i), (meth, i)
    assert got.stream_indices() == want.stream_indices()
    assert AutoModelForCausalLM.model_class(hf) is Step3p5ForCausalLM
    if name == "step35_flash":
        assert got.heads(0) == (64, 8) and got.heads(1) == (96, 8)
        assert got.moe_layers_enum == tuple(range(3, 45)) and got.moe.router_bias
        assert (got.theta(0), got.prf(0), got.theta(1), got.prf(1)) == (5e6, 0.5, 1e4, 1.0)


def _models(hf, seed=0):
    params = jax_tree(Step3p5Config.from_hf(hf).param_shapes(), seed, centred_norms=True)
    jm = JaxStep.from_config(hf, JaxBackend(dtype="float32", remat_policy="full"))
    return params, jm, port_model(Step3p5ForCausalLM, hf, params)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_load_and_grads_match_jax(name):
    params, jm, model = _models(CONFIGS[name])
    stats = assert_forward_and_grads_match(jm, model, params, *batch(), vocab=128)
    assert stats["expert_load"].shape == (2, 8)
    streams = {n.split(".")[0] for n in model.param_dict() if "." in n}
    assert streams == ({"full_mlp", "sliding_mlp", "full_moe", "sliding_moe"} if name == "tiny"
                       else {"full_mlp", "sliding_moe"})


def test_three_steps_match_jax():
    params, jm, model = _models(TINY, seed=4)
    (want, _), (got, _) = trajectories(jm, model, params, 128)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_adapter_matches_jax_and_reloads(tmp_path):
    params, jm, model = _models(TINY, seed=2)
    ours = model.state_dict_adapter().to_hf(model.param_dict())
    theirs = jm.state_dict_adapter().to_hf(params)
    assert set(ours) == set(theirs)
    assert ours["model.layers.3.moe.gate_proj.weight"].shape == (8, 16, 32)
    assert "model.layers.1.self_attn.g_proj.weight" in ours
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)
    back = model.state_dict_adapter().from_hf(ours)
    for key, p in model.param_dict().items():
        assert torch.equal(back[key], p), key
    save_safetensors(ours, str(tmp_path))
    (tmp_path / "config.json").write_text(json.dumps(TINY))
    loaded = AutoModelForCausalLM.from_pretrained(str(tmp_path), device="cpu").param_dict()
    for key, p in model.param_dict().items():
        assert torch.equal(loaded[key], p), key


def test_logical_axes_match_jax():
    params, jm, model = _models(TINY)
    assert model.logical_axes() == flatten(jm.logical_axes())


@pytest.mark.parametrize("name", list(SOURCES))
def test_flops_match_jax(name):
    for seq in (2048, 4096):
        assert flops_per_token(SOURCES[name], seq) == jax_flops(SOURCES[name], seq)
