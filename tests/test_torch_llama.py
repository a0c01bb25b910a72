"""The port's Llama against the JAX package's: a tiny config (vocab 128, hidden 64,
2 layers, 4 heads, 2 kv heads), weights built once in JAX and carried across with
params_from_jax. Logits agree to rtol = atol = 1e-4 (f32): the port's flash path
(the kernels' plain version on the CPU) against JAX's Pallas kernel in interpret
mode, and the two einsum paths against each other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.llama.model import LlamaForCausalLM as JaxLlama
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.llama.convert import params_from_jax
from automodel_tpu_torch.models.llama.model import LlamaConfig, LlamaForCausalLM

HF = dict(architectures=["LlamaForCausalLM"], vocab_size=128, hidden_size=64,
          intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, max_position_embeddings=256,
          rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                        "high_freq_factor": 4.0, "original_max_position_embeddings": 64})


def _jax_params(hf, seed=0):
    model = JaxLlama.from_config(hf, JaxBackend(dtype="float32", remat_policy="full"))
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


def _logits_pair(hf, jax_attention, torch_attention, segments=True):
    params = _jax_params(hf)
    ids, pos, seg = _batch()
    jm = JaxLlama.from_config(hf, JaxBackend(dtype="float32", remat_policy="full",
                                             attention=jax_attention))
    want = np.asarray(jm(params, jnp.asarray(ids), positions=jnp.asarray(pos),
                         segment_ids=jnp.asarray(seg) if segments else None))
    tm = LlamaForCausalLM.from_config(hf, BackendConfig(dtype="float32", attention=torch_attention,
                                                        remat_policy="mlp_attn_dots"),
                                      device="cpu")
    tm.load_params(params_from_jax(params, tm.config))
    got = tm(torch.tensor(ids), positions=torch.tensor(pos),
             segment_ids=torch.tensor(seg) if segments else None).detach().numpy()
    return got, want


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_flash_logits_match_pallas_interpret(tied):
    got, want = _logits_pair(dict(HF, tie_word_embeddings=tied), "flash_interpret", "flash")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("segments", [True, False], ids=["segments", "no_segments"])
def test_xla_logits_match(segments):
    got, want = _logits_pair(HF, "xla", "xla", segments=segments)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_remat_changes_no_value():
    """Per-layer checkpointing (every policy but "full") gives the same loss and grads."""
    params = params_from_jax(_jax_params(HF), LlamaConfig.from_hf(HF))
    ids, pos, seg = (torch.tensor(a) for a in _batch())
    out = {}
    for policy in ("full", "mlp_attn_dots"):
        m = LlamaForCausalLM.from_config(HF, BackendConfig(dtype="float32", attention="flash",
                                                           remat_policy=policy), device="cpu")
        m.load_params(params)
        loss = m(ids, positions=pos, segment_ids=seg).float().square().mean()
        out[policy] = torch.autograd.grad(loss, list(m.param_dict().values()))
    for a, b in zip(out["full"], out["mlp_attn_dots"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("extra", [
    dict(architectures=["Olmo2ForCausalLM"]),
    dict(architectures=["CohereForCausalLM"]),
    dict(architectures=["Qwen2ForCausalLM"], attention_bias=True),
    dict(embedding_multiplier=12.0),
    dict(no_rope_layer_interval=4),
    dict(sliding_window=128),
], ids=["olmo2", "cohere", "qwen2", "granite", "nope", "window"])
def test_unported_lineage_raises(extra):
    with pytest.raises(NotImplementedError):
        LlamaConfig.from_hf(dict(HF, **extra))


def test_backend_validates_remat_names():
    with pytest.raises(ValueError, match="remat_policy"):
        BackendConfig(remat_policy="bogus")
    assert not BackendConfig(remat_policy="full").checkpoint_layers
    assert BackendConfig(remat_policy="none").checkpoint_layers


def test_params_from_jax_checks_the_tree():
    cfg = LlamaConfig.from_hf(HF)
    params = _jax_params(HF)
    flat = params_from_jax(params, cfg)
    assert flat["layers.wq"].shape == (2, 64, 4, 16)
    bad = dict(params, layers=dict(params["layers"], wq=np.zeros((2, 64, 4, 8), np.float32)))
    with pytest.raises(ValueError, match="layers.wq"):
        params_from_jax(bad, cfg)
    with pytest.raises(KeyError):
        params_from_jax({k: v for k, v in params.items() if k != "final_norm"}, cfg)
    bf16 = jax.device_get(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params))
    t = params_from_jax(bf16, cfg)["embed"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(bf16["embed"], np.float32))
