"""The Llama lineage members the port builds from its Llama (Qwen2, Qwen3, Mistral) and
Phi-3, against the JAX package's, f32, at 2 layers on HF-shaped configs. Weights come
from a numpy seed in the JAX package's parameter tree (the q / k / v biases and q / k
norms random too) and are carried across with params_from_jax. Logits and every
parameter's gradient agree to rtol = atol = 1e-4 (test_torch_llama.py's tolerance): the
port's "flash" path (the kernels' plain version on the CPU) against JAX's "xla" einsum
path, which computes the same masks. Phi-3 runs at hidden 192 over 2 heads, so its
head_dim is 96, Phi-3-mini's. Also: the configs both packages read, longrope against
JAX's, the Llama adapter's Qwen2 biases and Qwen3 norms against JAX's, a Phi-3
directory that ``transformers`` saved (fused qkv_proj / gate_up_proj) loaded through
both packages and exported back, three train steps of the tiny Phi-3 against JAX's
under flash (JAX's Pallas kernels in interpret mode), and the Phi-3 FLOP count."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.auto import AutoModelForCausalLM as JaxAuto
from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.llama.model import LlamaForCausalLM as JaxLlama
from automodel_tpu.models.phi3.model import Phi3ForCausalLM as JaxPhi3
from automodel_tpu.ops import rope as jrope
from automodel_tpu.ops.losses import masked_cross_entropy as jax_ce
from automodel_tpu.optim.builder import build_optimizer as jax_build_optimizer
from automodel_tpu.optim.scheduler import build_lr_schedule as jax_schedule
from automodel_tpu.training.train_step import make_train_step as jax_make_train_step
from automodel_tpu.utils.flops import flops_per_token as jax_flops_per_token
from automodel_tpu_torch.models.auto import AutoModelForCausalLM
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.llama.convert import flatten, params_from_jax
from automodel_tpu_torch.models.llama.model import LlamaConfig, LlamaForCausalLM
from automodel_tpu_torch.models.phi3.model import Phi3Config, Phi3ForCausalLM
from automodel_tpu_torch.models.registry import resolve_model_class
from automodel_tpu_torch.ops import rope as trope
from automodel_tpu_torch.ops.losses import masked_cross_entropy
from automodel_tpu_torch.optim.builder import build_optimizer
from automodel_tpu_torch.optim.scheduler import build_lr_schedule
from automodel_tpu_torch.training.train_step import make_train_step
from automodel_tpu_torch.utils.flops import flops_per_token
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TOL = 1e-4
BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
            rope_theta=10000.0, rms_norm_eps=1e-6)
PHI3 = dict(BASE, architectures=["Phi3ForCausalLM"], hidden_size=192, intermediate_size=256,
            num_attention_heads=2, num_key_value_heads=2, sliding_window=12,
            max_position_embeddings=128, original_max_position_embeddings=32, rms_norm_eps=1e-5)
# longrope over Phi-3's 48 rotary frequencies (head_dim 96): the original window of 32
# extended to 128, so the short factors warn and the long ones need use_long_factor
LONGROPE = {"type": "longrope", "short_factor": np.linspace(1.0, 1.3, 48).tolist(),
            "long_factor": np.linspace(1.0, 9.0, 48).tolist()}
FAMILIES = {
    "qwen2": dict(BASE, architectures=["Qwen2ForCausalLM"], attention_bias=True,
                  rope_theta=1000000.0),
    "qwen3": dict(BASE, architectures=["Qwen3ForCausalLM"], head_dim=32),
    "mistral": dict(BASE, architectures=["MistralForCausalLM"], sliding_window=12),
    "phi3": PHI3,
    "phi3_longrope_short": dict(PHI3, rope_scaling=LONGROPE),
    "phi3_longrope_long": dict(PHI3, rope_scaling=dict(LONGROPE, use_long_factor=True)),
    "partial_rotary": dict(BASE, architectures=["LlamaForCausalLM"], partial_rotary_factor=0.75),
}


def _classes(hf):
    if hf["architectures"] == ["Phi3ForCausalLM"]:
        return JaxPhi3, Phi3ForCausalLM
    return JaxLlama, LlamaForCausalLM


def _jax_params(hf, seed=0):
    """Weights from a numpy seed in the JAX package's tree (its abstract parameters, so
    nothing is compiled): N(0, 0.02^2) matrices, q / k / v biases N(0, 0.2^2) and norms
    1 + N(0, 0.2^2), so that the biases and the q / k norms are tested."""
    jcls, _ = _classes(hf)
    rng = np.random.RandomState(seed)
    tree = {}
    for name, leaf in flatten(jcls.from_config(hf).abstract_params(jnp.float32)).items():
        *path, last = name.split(".")
        base, scale = ((1.0, 0.2) if last.endswith("norm") else
                       (0.0, 0.2) if last in ("bq", "bk", "bv") else (0.0, 0.02))
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = (base + scale * rng.randn(*leaf.shape)).astype(np.float32)
    return tree


def _batch(seed=0, b=2, s=32, vocab=128):
    """Two packed documents in row 0 (positions restarting), right padding in row 1."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    seg[0, s // 2:] = 2
    seg[1, s - 6:] = 0
    pos = np.concatenate([np.arange(s // 2), np.arange(s // 2)])[None].repeat(b, 0)
    pos[1] = np.arange(s)
    return ids, pos.astype(np.int32), seg


def _port(hf, params, attention="flash", remat_policy="full"):
    _, tcls = _classes(hf)
    tm = tcls.from_config(hf, BackendConfig(dtype="float32", attention=attention,
                                            remat_policy=remat_policy), device="cpu")
    tm.load_params(params_from_jax(params, tm.config))
    return tm


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_logits_and_grads_match_jax(family):
    """Qwen2's biases, Qwen3's q/k norms and explicit head_dim, Mistral's window, Phi-3's
    window at head_dim 96 (with longrope's short and long factors) and a partial rotary
    dimension: logits and every gradient against JAX."""
    hf = FAMILIES[family]
    params = _jax_params(hf)
    ids, pos, seg = _batch()
    ct = np.random.RandomState(2).randn(*ids.shape, hf["vocab_size"]).astype(np.float32)
    jcls, _ = _classes(hf)
    jm = jcls.from_config(hf, JaxBackend(dtype="float32", remat_policy="full"))

    def jloss(p):
        logits = jm(p, jnp.asarray(ids), positions=jnp.asarray(pos), segment_ids=jnp.asarray(seg))
        return jnp.sum(logits * ct), logits

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # longrope's short factors past the window
        (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            jax.tree.map(jnp.asarray, params))
        tm = _port(hf, params)
        logits = tm(torch.tensor(ids), positions=torch.tensor(pos), segment_ids=torch.tensor(seg))
    grads = torch.autograd.grad((logits * torch.tensor(ct)).sum(), list(tm.param_dict().values()))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
    jflat = flatten(jgrads)
    assert set(jflat) == set(tm.param_dict())
    for name, g in zip(tm.param_dict(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jflat[name]), atol=TOL, rtol=TOL,
                                   err_msg=name)


PHI3_MINI_4K = dict(architectures=["Phi3ForCausalLM"], vocab_size=32064, hidden_size=3072,
                    intermediate_size=8192, num_hidden_layers=32, num_attention_heads=32,
                    num_key_value_heads=32, max_position_embeddings=4096,
                    original_max_position_embeddings=4096, sliding_window=2047,
                    rope_theta=10000.0, rope_scaling=None, rms_norm_eps=1e-5,
                    tie_word_embeddings=False, hidden_act="silu", initializer_range=0.02)
PHI3_MINI_128K = dict(PHI3_MINI_4K, max_position_embeddings=131072, sliding_window=262144,
                      rope_scaling={"type": "longrope", "short_factor": [1.0] * 48,
                                    "long_factor": [2.0] * 48})


@pytest.mark.parametrize("hf", [
    PHI3_MINI_4K, PHI3_MINI_128K, *FAMILIES.values(),
    dict(FAMILIES["qwen2"], sliding_window=64, use_sliding_window=False, qkv_bias=True,
         attention_bias=None),
    dict(BASE, architectures=["LlamaForCausalLM"], layer_norm_eps=1e-3, rms_norm_eps=None),
], ids=["phi3_mini_4k", "phi3_mini_128k", *FAMILIES, "qwen2_window_off", "layer_norm_eps"])
def test_from_hf_matches_jax(hf):
    """Every field of the port's config equals JAX's of the same name (longrope's windows
    folded into rope_scaling, the window gated by use_sliding_window, rms_norm_eps from
    layer_norm_eps), and the architecture resolves to the port's class."""
    hf = {k: v for k, v in hf.items() if v is not None}
    jcls, tcls = _classes(hf)
    got, want = tcls.config_class.from_hf(hf), jcls.config_class.from_hf(hf)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert resolve_model_class(hf["architectures"][0]) is tcls
    assert isinstance(got, Phi3Config if tcls is Phi3ForCausalLM else LlamaConfig)


@pytest.mark.parametrize("scaling", [
    dict(LONGROPE, original_max_position_embeddings=32, max_position_embeddings=128),
    dict(LONGROPE, original_max_position_embeddings=32, max_position_embeddings=128,
         use_long_factor=True),
    dict(LONGROPE, original_max_position_embeddings=128, max_position_embeddings=128,
         use_long_factor=True),
    dict(LONGROPE, original_max_position_embeddings=32, max_position_embeddings=128,
         attention_factor=1.5),
], ids=["short_past_window", "long", "not_extended", "attention_factor"])
def test_longrope_matches_jax(scaling):
    """The frequencies and the cos/sin scale; the short factors past the original window
    warn in both packages."""
    for partial in (1.0, 0.5):
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            want = np.asarray(jrope.rope_frequencies(96 * 2 if partial == 0.5 else 96, 10000.0,
                                                     scaling, partial))
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            got = trope.rope_frequencies(96 * 2 if partial == 0.5 else 96, 10000.0, scaling,
                                         partial)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        assert len(tw) == len(jw) == int(scaling["max_position_embeddings"] >
                                         scaling["original_max_position_embeddings"]
                                         and not scaling.get("use_long_factor"))
    assert trope.rope_attention_scaling(scaling) == pytest.approx(
        jrope.rope_attention_scaling(scaling), rel=1e-12)


def _tiny_transformers_phi3(path, monkeypatch):
    monkeypatch.setenv("USE_TF", "0")  # transformers' import need not load TensorFlow
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(7)
    cfg = transformers.Phi3Config(
        vocab_size=128, hidden_size=192, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64,
        sliding_window=16, rope_scaling=None, pad_token_id=0, bos_token_id=1, eos_token_id=2)
    hf = transformers.Phi3ForCausalLM(cfg)
    hf.save_pretrained(path, safe_serialization=True)
    return {k for k in hf.state_dict() if "rotary_emb" not in k}


def test_transformers_phi3_directory_loads_and_exports(tmp_path, monkeypatch):
    """A Phi-3 saved by transformers (fused qkv_proj and gate_up_proj, head_dim 96) loads
    through the port; its logits equal JAX's from_pretrained of the same directory (f32,
    1e-4); to_hf and the lazy export give HF's key set with the fused tensors, and
    from_hf(to_hf(p)) gives p back bitwise."""
    hf_keys = _tiny_transformers_phi3(str(tmp_path), monkeypatch)
    model = AutoModelForCausalLM.from_pretrained(
        str(tmp_path), BackendConfig(dtype="float32", attention="flash"), device="cpu")
    assert isinstance(model, Phi3ForCausalLM) and model.config.head_dim == 96
    jmodel, jparams = JaxAuto.from_pretrained(
        str(tmp_path), dtype=jnp.float32, backend=JaxBackend(dtype="float32", remat_policy="full"))
    ids = np.random.RandomState(0).randint(0, 128, (2, 24))
    want = np.asarray(jmodel(jparams, jnp.asarray(ids)))
    got = model(torch.tensor(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)

    params = model.param_dict()
    adapter = model.state_dict_adapter()
    exported = adapter.to_hf(params)
    lazy = adapter.to_hf_lazy(params)
    assert set(exported) == set(lazy) == hf_keys
    assert "model.layers.1.self_attn.qkv_proj.weight" in exported
    assert exported["model.layers.0.self_attn.qkv_proj.weight"].shape == (3 * 192, 192)
    assert exported["model.layers.0.mlp.gate_up_proj.weight"].shape == (2 * 256, 192)
    for key, value in exported.items():
        assert torch.equal(lazy[key].materialize(), value), key
    back = adapter.from_hf(exported)
    assert set(back) == set(params)
    for key, value in params.items():
        assert torch.equal(back[key], value.detach()), key
    jexported = jmodel.state_dict_adapter().to_hf(jparams)
    for key, value in exported.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(jexported[key]), err_msg=key)


@pytest.mark.parametrize("family", ["qwen2", "qwen3"])
def test_llama_adapter_maps_qwen_biases_and_norms(family):
    """The port's Llama adapter writes Qwen2's q / k / v biases and Qwen3's q_norm /
    k_norm under their HF names, equal to JAX's adapter's export of the same weights,
    and reads them back bitwise."""
    hf = FAMILIES[family]
    params = _jax_params(hf)
    model = LlamaForCausalLM.from_config(hf, device="cpu")
    flat = params_from_jax(params, model.config)
    exported = model.state_dict_adapter().to_hf(flat)
    want = JaxLlama.from_config(hf).state_dict_adapter().to_hf(params)
    assert set(exported) == set(want)
    names = ({"self_attn.q_proj.bias", "self_attn.k_proj.bias", "self_attn.v_proj.bias"}
             if family == "qwen2" else {"self_attn.q_norm.weight", "self_attn.k_norm.weight"})
    assert {f"model.layers.1.{n}" for n in names} <= set(exported)
    for key, value in want.items():
        np.testing.assert_array_equal(exported[key].numpy(), np.asarray(value), err_msg=key)
    back = model.state_dict_adapter().from_hf(exported)
    assert all(torch.equal(back[k], v) for k, v in flat.items())


def _train_batches(n_steps=3, grad_acc=1):
    out = []
    for step in range(n_steps):
        micro = [_batch(seed=10 * step + m) for m in range(grad_acc)]
        ids = np.stack([m[0] for m in micro])
        labels = np.where(np.stack([m[2] for m in micro]) != 0, np.roll(ids, -1, -1), -100)
        out.append({"input_ids": ids, "positions": np.stack([m[1] for m in micro]),
                    "segment_ids": np.stack([m[2] for m in micro]),
                    "labels": labels.astype(np.int32)})
    return out


SCHED = dict(max_lr=3e-3, min_lr=3e-4, lr_warmup_steps=2, lr_decay_steps=3)
OPT = dict(optimizer="adamw", weight_decay=0.1, max_grad_norm=0.5, eps=1e-5)


def test_three_train_steps_match_jax():
    """Three steps of the tiny Phi-3 (head_dim 96, window 12, packed rows, adamw with
    clipping) under flash: JAX's Pallas kernels in interpret mode, the port's
    plain version. Losses and gradient norms to 1e-4, the parameters after to 1e-3
    relative."""
    params = _jax_params(PHI3)
    batches = _train_batches()
    jm = JaxPhi3.from_config(PHI3, JaxBackend(dtype="float32", remat_policy="full",
                                              attention="flash_interpret"))

    def jax_forward_loss(p, batch, n):
        logits = jm(p, batch["input_ids"], positions=batch["positions"],
                    segment_ids=batch["segment_ids"])
        return jax_ce(logits, batch["labels"], n)

    opt = jax_build_optimizer(lr=jax_schedule(**SCHED), betas=(0.9, 0.95), **OPT)
    step = jax.jit(jax_make_train_step(jax_forward_loss, opt))
    jp = jax.tree.map(jnp.asarray, params)
    state, jax_metrics = opt.init(jp), []
    for batch in batches:
        jp, state, m = step(jp, state, {k: jnp.asarray(v) for k, v in batch.items()})
        jax_metrics.append({k: float(v) for k, v in m.items()})

    tm = _port(PHI3, params)
    tparams = tm.param_dict()

    def forward_loss(batch, n):
        logits = tm(batch["input_ids"], positions=batch["positions"],
                    segment_ids=batch["segment_ids"])
        return masked_cross_entropy(logits, batch["labels"], n)

    topt = build_optimizer(lr=build_lr_schedule(**SCHED), betas=(0.9, 0.95), **OPT)
    tstep = make_train_step(forward_loss, tparams, topt)
    tstate = topt.init(tparams)
    for batch, jmet in zip(batches, jax_metrics):
        tstate, m = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(m["loss"]) == pytest.approx(jmet["loss"], abs=TOL)
        assert float(m["grad_norm"]) == pytest.approx(jmet["grad_norm"], rel=TOL)
    want = params_from_jax(jax.device_get(jp), tm.config)
    for key, ref in want.items():
        err = (tparams[key].detach() - ref).abs().max() / ref.abs().max().clamp_min(1e-12)
        assert err <= 1e-3, f"{key}: relative error {err:.2e}"


def test_flops_count_phi3():
    """Phi-3-mini at seq 2048: the full S^2 score term at head_dim 96 (hidden / heads), the
    window ignored, as JAX counts it."""
    got = flops_per_token(PHI3_MINI_4K, 2048)
    assert got == jax_flops_per_token(PHI3_MINI_4K, 2048)
    d, n, h, i, v = 3072, 32, 96, 8192, 32064
    attn = 2 * d * 3 * n * h + 2 * n * h * d + 4 * 2048 * n * h
    assert got == 3 * (32 * (attn + 3 * 2 * d * i) + 2 * d * v)
