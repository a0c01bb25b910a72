"""The port's HF state-dict adapters against the JAX package's, f32: for the same
parameters (built in JAX, carried across with params_from_jax) Llama (tied and untied)
and Qwen3-MoE (all-MoE and with a dense first layer) give the same HF keys and bitwise
equal tensors, eagerly and lazily, and read them back bitwise. Consolidated HF
directories cross between the packages both ways: a JAX export loads into the port
with equal parameters and logits within test_torch_llama.py's 1e-4, and a port export
loads through the JAX from_pretrained bitwise."""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from automodel_tpu.checkpoint.checkpointing import Checkpointer as JaxCheckpointer
from automodel_tpu.checkpoint.checkpointing import CheckpointingConfig as JaxCkptConfig
from automodel_tpu.models.auto import AutoModelForCausalLM as JaxAuto
from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.llama.model import LlamaForCausalLM as JaxLlama
from automodel_tpu.models.qwen3_moe.model import Qwen3MoeForCausalLM as JaxQwen3Moe
from automodel_tpu_torch.checkpoint.checkpointing import Checkpointer, CheckpointingConfig
from automodel_tpu_torch.models.auto import AutoModelForCausalLM
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.common.state_dict import Entry, FusedTensorMixin, MappingAdapter
from automodel_tpu_torch.models.llama.convert import flatten, params_from_jax, to_torch
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

LLAMA = dict(architectures=["LlamaForCausalLM"], vocab_size=128, hidden_size=64,
             intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=256)
QWEN3_MOE = dict(architectures=["Qwen3MoeForCausalLM"], vocab_size=128, hidden_size=64,
                 intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, head_dim=16, num_experts=4,
                 num_experts_per_tok=2, decoder_sparse_step=1, mlp_only_layers=[],
                 norm_topk_prob=True, max_position_embeddings=128, rope_theta=1e6,
                 rms_norm_eps=1e-6)
CASES = {"llama_tied": (JaxLlama, dict(LLAMA, tie_word_embeddings=True)),
         "llama_untied": (JaxLlama, dict(LLAMA, tie_word_embeddings=False)),
         "qwen3_moe": (JaxQwen3Moe, QWEN3_MOE),
         "qwen3_moe_dense_first": (JaxQwen3Moe, dict(QWEN3_MOE, mlp_only_layers=[0]))}


def _pair(name, seed=0):
    """(JAX model, its numpy params, port model holding the same params)."""
    jax_cls, hf = CASES[name]
    jm = jax_cls.from_config(hf, JaxBackend(dtype="float32", remat_policy="full"))
    params = jax.device_get(jm.init(jax.random.key(seed)))
    tm = AutoModelForCausalLM.from_config(hf, BackendConfig(dtype="float32"), device="cpu")
    tm.load_params(params_from_jax(params, tm.config))
    return jm, params, tm


def _assert_bitwise(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_to_hf_matches_jax_key_for_key(name):
    jm, params, tm = _pair(name)
    want = jm.state_dict_adapter().to_hf(params)
    adapter = tm.state_dict_adapter()
    _assert_bitwise({k: v.numpy() for k, v in adapter.to_hf(tm.param_dict()).items()}, want)
    lazy = adapter.to_hf_lazy(tm.param_dict())
    _assert_bitwise({k: v.materialize().numpy() for k, v in lazy.items()}, want)
    # the shard planner's sizes are the tensors' own
    assert all(lazy[k].nbytes == want[k].nbytes for k in want)
    back = adapter.from_hf({k: to_torch(v) for k, v in want.items()}, dtype=torch.float32)
    _assert_bitwise({k: v.numpy() for k, v in back.items()},
                    {k: v for k, v in flatten(params).items()})


def test_bf16_export_rounds_as_jax():
    jm, params, tm = _pair("llama_untied")
    want = jm.state_dict_adapter().to_hf(params, dtype=ml_dtypes.bfloat16)
    got = tm.state_dict_adapter().to_hf(tm.param_dict(), dtype=torch.bfloat16)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].view(torch.uint16).numpy(),
                                      np.asarray(want[k]).view(np.uint16), err_msg=k)


def _batch(seed=0, b=2, s=16):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 128, (b, s)).astype(np.int32),
            np.arange(s, dtype=np.int32)[None].repeat(b, 0), np.ones((b, s), np.int32))


@pytest.mark.parametrize("name", ["llama_tied", "qwen3_moe"])
def test_jax_consolidated_hf_loads_into_the_port(tmp_path, name):
    jm, params, _ = _pair(name, seed=1)
    _, hf = CASES[name]
    ck = JaxCheckpointer(JaxCkptConfig(checkpoint_dir=str(tmp_path / "ck")),
                         state_dict_adapter=jm.state_dict_adapter(), hf_config=hf)
    ck.save_hf(str(tmp_path / "hf"), jax.tree.map(jnp.asarray, params))
    tm = AutoModelForCausalLM.from_pretrained(str(tmp_path / "hf"),
                                              BackendConfig(dtype="float32"), device="cpu")
    _assert_bitwise({k: v.detach().numpy() for k, v in tm.param_dict().items()},
                    flatten(params))
    ids, pos, seg = _batch()
    want = jm(params, jnp.asarray(ids), positions=jnp.asarray(pos),
              segment_ids=jnp.asarray(seg))
    got = tm(torch.tensor(ids), positions=torch.tensor(pos), segment_ids=torch.tensor(seg))
    want, got = (want[0], got[0]) if isinstance(got, tuple) else (want, got)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["llama_untied", "qwen3_moe_dense_first"])
def test_port_consolidated_hf_loads_into_jax(tmp_path, name):
    jm, params, tm = _pair(name, seed=2)
    _, hf = CASES[name]
    ck = Checkpointer(CheckpointingConfig(checkpoint_dir=str(tmp_path / "ck")),
                      state_dict_adapter=tm.state_dict_adapter(), hf_config=hf)
    ck.save_hf(str(tmp_path / "hf"), tm.param_dict())
    with open(tmp_path / "hf" / "config.json") as f:
        assert json.load(f) == hf
    _, got = JaxAuto.from_pretrained(str(tmp_path / "hf"), JaxBackend(dtype="float32"),
                                     dtype=jnp.float32)
    _assert_bitwise(flatten(jax.device_get(got)), flatten(params))


def test_from_pretrained_places_in_dtype_and_refuses_hub_ids(tmp_path):
    _, _, tm = _pair("llama_tied")
    ck = Checkpointer(CheckpointingConfig(checkpoint_dir=str(tmp_path / "ck")),
                      state_dict_adapter=tm.state_dict_adapter(), hf_config=CASES["llama_tied"][1])
    ck.save_hf(str(tmp_path / "hf"), tm.param_dict())
    bf = AutoModelForCausalLM.from_pretrained(str(tmp_path / "hf"), dtype=torch.bfloat16,
                                              device="cpu")
    for k, v in bf.param_dict().items():
        assert v.dtype == torch.bfloat16
        assert torch.equal(v, tm.param_dict()[k].detach().to(torch.bfloat16))
    with pytest.raises(NotImplementedError, match="hub"):
        AutoModelForCausalLM.from_pretrained("meta-llama/Llama-3.2-1B", device="cpu")
    with pytest.raises(FileNotFoundError):
        AutoModelForCausalLM.from_pretrained(str(tmp_path / "nowhere" / "x" / "y"), device="cpu")
    os.remove(tmp_path / "hf" / "model.safetensors")
    with pytest.raises(FileNotFoundError):
        AutoModelForCausalLM.from_pretrained(str(tmp_path / "hf"), device="cpu")


class _Fused(FusedTensorMixin, MappingAdapter):
    _fused = [("mlp.gate_up_proj.weight", ["mlp.gate_proj.weight", "mlp.up_proj.weight"])]
    _fused_splits = {"mlp.gate_up_proj.weight": [3, 3]}


def test_fused_tensors_split_and_refuse():
    adapter = _Fused([Entry("model.layers.{i}.mlp.gate_proj.weight", "layers.g"),
                      Entry("model.layers.{i}.mlp.up_proj.weight", "layers.u")], num_layers=2)
    hf = {f"model.layers.{i}.mlp.gate_up_proj.weight": torch.randn(6, 4) for i in range(2)}
    ours = adapter.from_hf(hf)
    assert ours["layers.g"].shape == (2, 3, 4)
    torch.testing.assert_close(ours["layers.u"][1], hf["model.layers.1.mlp.gate_up_proj.weight"][3:],
                               rtol=0, atol=0)
    for out in (adapter.to_hf(ours),
                {k: v.materialize() for k, v in adapter.to_hf_lazy(ours).items()}):
        assert set(out) == set(hf) and all(torch.equal(out[k], hf[k]) for k in hf)
