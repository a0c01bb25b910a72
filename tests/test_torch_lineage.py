"""The rest of the Llama lineage in the port against the JAX package, f32, on tiny configs
(vocab 128, hidden 64, 2-4 layers, 4 heads of 16 over 2): Granite (every multiplier off
identity), SmolLM3's NoPE layers, OLMo-2 and OLMo-3, Cohere and Cohere+ (per-head q/k
LayerNorm), Cohere2 in both config formats, Arcee, GLM and GLM-4, Ministral-3 (YaRN and
the Llama-4 q scale), and the five structural aliases (Helium, Ernie-4.5, OLMo v1,
StarCoder2, StableLM). The same numpy-seeded weights go through both models: logits and
every gradient agree to rtol = atol = 1e-4, on the flash path (the port's plain version
on the CPU, JAX's Pallas kernel in interpret mode) and on the einsum path. Also: the
configs field by field, the HF adapters (names and values as JAX's, bitwise round trips),
the logical axes and the weight-decay mask, the FLOP counts, StructuralDivergence's
fields, the matmuls each remat policy replays for every new block shape (parallel, post,
sandwich, ungated), and three train_ft steps of Cohere2 against JAX's recipe."""

import dataclasses
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.config.loader import load_config as jax_load_config
from automodel_tpu.models.auto import AutoModelForCausalLM as JaxAuto
from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.common.transformer import dense_decoder_logical_axes
from automodel_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY
from automodel_tpu.models.structural import StructuralDivergence as JaxDivergence
from automodel_tpu.models.structural import classify_config as jax_classify
from automodel_tpu.models.structural import resolve_llama_delta as jax_resolve
from automodel_tpu.optim.builder import no_decay_mask as jax_no_decay_mask
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JaxTrainFt)
from automodel_tpu.utils.flops import flops_per_token as jax_flops
from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.models.auto import AutoModelForCausalLM
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.glm4.model import Glm4ForCausalLM
from automodel_tpu_torch.models.llama.convert import flatten, params_from_jax
from automodel_tpu_torch.models.llama.model import LlamaConfig, LlamaForCausalLM
from automodel_tpu_torch.models.mistral3.model import Ministral3ForCausalLM
from automodel_tpu_torch.models.mixtral.model import MixtralForCausalLM
from automodel_tpu_torch.models.registry import MODEL_REGISTRY, resolve_model_class
from automodel_tpu_torch.models.structural import (AliasedLlamaForCausalLM,
                                                   StructuralDivergence, aliased_config,
                                                   classify_config)
from automodel_tpu_torch.ops import flash_attention as tfa
from automodel_tpu_torch.optim.builder import no_decay_mask
from automodel_tpu_torch.recipes.llm import train_ft
from automodel_tpu_torch.utils.flops import flops_per_token
from tests.test_torch_llama import MatmulCounter, jax_matmul_counts
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
            rms_norm_eps=1e-5)


def _hf(arch, drop=(), **kw):
    hf = {k: v for k, v in TINY.items() if k not in drop}
    return dict(hf, architectures=[arch], **kw)


LN = ("rms_norm_eps",)  # families whose config names their LayerNorm's eps otherwise
FAMILIES = {
    "granite": _hf("GraniteForCausalLM", embedding_multiplier=12.0, residual_multiplier=0.22,
                   attention_multiplier=0.015625, logits_scaling=8.0, tie_word_embeddings=True),
    "smollm3": _hf("SmolLM3ForCausalLM", no_rope_layer_interval=2, tie_word_embeddings=True),
    "olmo2": _hf("Olmo2ForCausalLM", rms_norm_eps=1e-6),
    "olmo3": _hf("Olmo3ForCausalLM", sliding_window=8,
                 layer_types=["sliding_attention", "full_attention"]),
    "cohere": _hf("CohereForCausalLM", LN, layer_norm_eps=1e-5, logit_scale=0.0625),
    "cohere_plus": _hf("CohereForCausalLM", LN, layer_norm_eps=1e-5, logit_scale=0.0625,
                       use_qk_norm=True),
    "cohere2": _hf("Cohere2ForCausalLM", LN, layer_norm_eps=1e-5, logit_scale=0.25,
                   num_hidden_layers=4, sliding_window=8,
                   layer_types=["sliding_attention"] * 3 + ["full_attention"]),
    # the original R7B config.json: an integer pattern and no layer_types
    "cohere2_pattern": _hf("Cohere2ForCausalLM", LN, layer_norm_eps=1e-5, logit_scale=0.25,
                           num_hidden_layers=4, sliding_window=8, sliding_window_pattern=4),
    "arcee": _hf("ArceeForCausalLM"),
    "glm": _hf("GlmForCausalLM", partial_rotary_factor=0.5, attention_bias=True),
    "glm4": _hf("Glm4ForCausalLM", partial_rotary_factor=0.5, attention_bias=True),
    "ministral3": _hf("Ministral3ForCausalLM", rope_parameters=dict(
        rope_type="yarn", factor=4.0, original_max_position_embeddings=8, rope_theta=1e6,
        beta_fast=32.0, beta_slow=1.0, llama_4_scaling_beta=0.1)),
    # the structural aliases
    "helium": _hf("HeliumForCausalLM", head_dim=16),
    "ernie4_5": _hf("Ernie4_5ForCausalLM"),
    "olmo": _hf("OlmoForCausalLM", LN, clip_qkv=0.5),
    "starcoder2": _hf("Starcoder2ForCausalLM", LN, norm_epsilon=1e-5, use_bias=True,
                      hidden_act="gelu_pytorch_tanh"),
    "stablelm": _hf("StableLmForCausalLM", LN, layer_norm_eps=1e-5, use_qkv_bias=True,
                    use_parallel_residual=True, partial_rotary_factor=0.25),
}
ATTENTION = {"flash": ("flash_interpret", "flash"), "xla": ("xla", "xla")}


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
    """Flat numpy weights of ``cfg.param_shapes()``: matrices N(0, 0.1^2), the embedding
    N(0, 1), norm weights 1 + N(0, 0.2^2) and biases N(0, 0.1^2), so that each one shows
    in the logits."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in cfg.param_shapes().items():
        leaf = name.rsplit(".", 1)[-1]
        x = rng.randn(*shape).astype(np.float32)
        if leaf == "embed":
            out[name] = x
        elif leaf.endswith("norm"):
            out[name] = 1.0 + 0.2 * x
        else:
            out[name] = 0.1 * x
    return out


def _batch(seed=0, b=2, s=32):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, (b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    seg[0, s // 2:] = 2  # two packed sequences in row 0
    seg[1, s - 6:] = 0  # right padding in row 1
    pos = np.concatenate([np.arange(s // 2), np.arange(s // 2)])[None].repeat(b, 0)
    pos[1] = np.arange(s)
    return ids, pos.astype(np.int32), seg


def _port(hf, attention="xla", remat="full", weights=None):
    model = AutoModelForCausalLM.from_config(
        hf, BackendConfig(dtype="float32", attention=attention, remat_policy=remat),
        device="cpu")
    if weights is not None:
        model.load_params({k: torch.from_numpy(v) for k, v in weights.items()})
    return model


def _jax(hf, attention="xla", remat="full"):
    return JaxAuto.from_config(hf, JaxBackend(dtype="float32", attention=attention,
                                              remat_policy=remat))


@pytest.mark.parametrize("attention", list(ATTENTION))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_and_grads_match_jax(family, attention):
    hf = FAMILIES[family]
    jax_attention, port_attention = ATTENTION[attention]
    model = _port(hf, port_attention)
    weights = _weights(model.config)
    model.load_params({k: torch.from_numpy(v) for k, v in weights.items()})
    ids, pos, seg = _batch()
    ct = np.random.RandomState(1).randn(*ids.shape, 128).astype(np.float32) / ids.size
    jm = _jax(hf, jax_attention)

    def jax_loss(p):
        logits = jm(p, jnp.asarray(ids), positions=jnp.asarray(pos),
                    segment_ids=jnp.asarray(seg))
        return jnp.sum(logits * ct), logits

    (_, want), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        _unflatten({k: jnp.asarray(v) for k, v in weights.items()}))
    params = model.param_dict()
    logits = model(torch.from_numpy(ids), positions=torch.from_numpy(pos),
                   segment_ids=torch.from_numpy(seg))
    grads = torch.autograd.grad((logits * torch.from_numpy(ct)).sum(), list(params.values()))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    jflat = flatten(jax.device_get(jgrads))
    assert set(jflat) == set(params)
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_matches_jax(family):
    """The port's config of each family equals JAX's model's, field by field, and the
    class is the one JAX's registry (or its structural alias) names."""
    hf = FAMILIES[family]
    got = _port(hf).config
    want = _jax(hf).config
    assert dataclasses.asdict(got) == {k: v for k, v in dataclasses.asdict(want).items()
                                       if k in dataclasses.asdict(got)}
    arch = hf["architectures"][0]
    port_cls = type(_port(hf))
    if arch in JAX_REGISTRY:
        assert arch in MODEL_REGISTRY
        assert port_cls.__name__ == JAX_REGISTRY[arch].rsplit(":", 1)[1]
    else:
        assert port_cls is AliasedLlamaForCausalLM and arch not in MODEL_REGISTRY


def test_registry_covers_the_jax_lineage():
    """Every name JAX's registry sends to its Llama lineage (Llama, GLM-4, Ministral-3)
    builds in the port, and Mixtral resolves."""
    lineage = [a for a, t in JAX_REGISTRY.items() if t.split(":")[0].endswith(
        ("llama.model", "glm4.model", "mistral3.model"))]
    assert len(lineage) == 14
    for arch in lineage:
        assert resolve_model_class(arch) is not None, arch
        hf = _hf(arch, LN, layer_norm_eps=1e-5) if "Cohere" in arch else _hf(arch)
        cfg = resolve_model_class(arch).config_class.from_hf(hf)
        assert isinstance(cfg, LlamaConfig)
    assert resolve_model_class("Glm4ForCausalLM") is Glm4ForCausalLM
    assert resolve_model_class("GlmForCausalLM") is Glm4ForCausalLM
    assert resolve_model_class("Ministral3ForCausalLM") is Ministral3ForCausalLM
    assert resolve_model_class("MixtralForCausalLM") is MixtralForCausalLM
    assert resolve_model_class("CohereForCausalLM") is LlamaForCausalLM


@pytest.mark.parametrize("family", list(FAMILIES))
def test_adapter_matches_jax_and_round_trips(family):
    """The port's adapter writes JAX's HF names and values from the same weights, and
    reads them back bitwise (GLM-4's fused gate_up, OLMo-2's flat q/k norms, StarCoder2's
    c_fc / c_proj and biases, OLMo v1's absent norms among them)."""
    hf = FAMILIES[family]
    model = _port(hf)
    weights = _weights(model.config, seed=3)
    flat = {k: torch.from_numpy(v) for k, v in weights.items()}
    adapter = model.state_dict_adapter()
    ours = adapter.to_hf(flat)
    jax_adapter = _jax(hf).state_dict_adapter()
    theirs = jax_adapter.to_hf(_unflatten(weights))
    assert sorted(ours) == sorted(theirs)
    for key, value in ours.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(theirs[key]), err_msg=key)
    back = adapter.from_hf(ours)
    assert set(back) == set(flat)
    for key, value in flat.items():
        assert torch.equal(back[key], value), key
    lazy = {k: v.materialize() if hasattr(v, "materialize") else v
            for k, v in adapter.to_hf_lazy(flat).items()}
    assert sorted(lazy) == sorted(ours)


@pytest.mark.parametrize("family", ["olmo2", "cohere_plus", "starcoder2", "glm4", "olmo"])
def test_logical_axes_and_decay_match_jax(family):
    """The logical axes (the (heads, head_dim) q/k norms of OLMo-2 and Cohere+ among
    them) and the weight-decay mask equal JAX's. JAX decides decay by per-layer rank, so
    OLMo-2's and Cohere+'s (n, h) q/k norms take weight decay, and the port's do too."""
    hf = FAMILIES[family]
    model = _port(hf)
    jax_model = _jax(hf)
    assert model.logical_axes() == flatten(dense_decoder_logical_axes(jax_model.config))
    weights = _weights(model.config)
    got = no_decay_mask({k: torch.from_numpy(v) for k, v in weights.items()})
    assert got == flatten(jax_no_decay_mask(_unflatten(weights)))
    if "q_norm" in "".join(got) and model.config.head_qk_norm:
        assert got["layers.q_norm"] and got["layers.k_norm"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_flops_match_jax(family):
    hf = FAMILIES[family]
    assert flops_per_token(hf, 4096) == pytest.approx(jax_flops(hf, 4096), rel=1e-12)


DIVERGENT = {
    "unknown_field": _hf("BrandNewForCausalLM", fancy_gate=True),
    "activation": _hf("ApertusForCausalLM", hidden_act="xielu"),
    "no_rms_eps": _hf("SomethingForCausalLM", LN),
    "not_causal_lm": _hf("SomethingModel"),
    "stablelm_qk_layernorm": _hf("StableLmForCausalLM", LN, layer_norm_eps=1e-5,
                                 qk_layernorm=True),
    "starcoder2_act": _hf("Starcoder2ForCausalLM", LN, norm_epsilon=1e-5, hidden_act="relu"),
    "moe": _hf("SomeMoeForCausalLM", num_local_experts=8),
}


@pytest.mark.parametrize("case", list(DIVERGENT))
def test_structural_divergence_names_jax_fields(case):
    """A divergent config raises StructuralDivergence naming the same fields, with the
    same reasons, as JAX's; through AutoModelForCausalLM it is a NotImplementedError
    carrying both the registry miss and the divergence."""
    hf = DIVERGENT[case]
    arch = hf["architectures"][0]
    assert classify_config(hf, arch) == jax_classify(hf, arch)
    with pytest.raises(JaxDivergence) as want:
        jax_resolve(arch, hf)
    with pytest.raises(StructuralDivergence) as got:
        aliased_config(arch, hf)
    assert str(got.value).split(". If the")[0] == str(want.value).split(". If the")[0]
    with pytest.raises(NotImplementedError, match="Auto-alias also failed"):
        AutoModelForCausalLM.model_class(hf)


@pytest.mark.parametrize("family", ["helium", "starcoder2", "stablelm", "olmo", "ernie4_5"])
def test_alias_resolves_like_jax(family):
    hf = FAMILIES[family]
    model = AutoModelForCausalLM.from_config(hf, device="cpu")
    assert isinstance(model, AliasedLlamaForCausalLM)
    want = jax_resolve(hf["architectures"][0], hf).config
    assert dataclasses.asdict(model.config) == {
        k: v for k, v in dataclasses.asdict(want).items() if k in dataclasses.asdict(model.config)}


# one layer of each new block shape: the remat policies' replays against JAX's
BLOCKS = {"parallel": "cohere", "post": "olmo2", "sandwich": "glm4", "ungated": "arcee",
          "layernorm_biased": "starcoder2"}


@pytest.mark.parametrize("policy", ["none", "dots", "mlp_dots", "mlp_attn_dots"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_remat_replays_the_matmuls_jax_replays(block, policy, monkeypatch):
    """For the parallel block, the post and sandwich norms, the ungated MLP and the biased
    LayerNorm block: under each policy the matmuls of the forward and backward equal the
    dot_generals of JAX's grad under the same policy (outside the Pallas kernels), flash's
    stand-in runs once more than the forward where JAX's forward kernel does, and the
    loss and gradients equal the port's under "full"."""
    hf = dict(FAMILIES[BLOCKS[block]], num_hidden_layers=1)
    ids = np.random.RandomState(1).randint(0, 128, (2, 32)).astype(np.int32)
    weights = _weights(_port(hf).config)
    calls = []
    plain = tfa.flash_attention_reference
    monkeypatch.setattr(tfa, "flash_attention_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    out = {}
    for remat in (policy, "full"):
        model = _port(hf, "flash", remat, weights)
        calls.clear()
        with MatmulCounter() as counter:
            loss = model(torch.from_numpy(ids)).square().mean()
            grads = torch.autograd.grad(loss, list(model.param_dict().values()))
        out[remat] = loss, grads, counter.counts, len(calls)
    loss, grads, counts, flash_calls = out[policy]
    torch.testing.assert_close(loss, out["full"][0], rtol=1e-5, atol=1e-6)
    for g, g_full in zip(grads, out["full"][1]):
        torch.testing.assert_close(g, g_full, rtol=1e-5, atol=1e-6)
    jm = _jax(hf, "flash_interpret", policy)
    jparams = _unflatten({k: jnp.asarray(v) for k, v in weights.items()})
    want, pallas_calls = jax_matmul_counts(jax.make_jaxpr(jax.grad(
        lambda p: jnp.mean(jnp.square(jm(p, jnp.asarray(ids))))))(jparams))
    assert counts == want
    assert flash_calls + 1 == pallas_calls == 3


COHERE2_YAML = """
seed: 7
device: cpu
model:
  params_dtype: float32
  config:
    architectures: [Cohere2ForCausalLM]
    vocab_size: 128
    hidden_size: 64
    intermediate_size: 128
    num_hidden_layers: 4
    num_attention_heads: 4
    num_key_value_heads: 2
    layer_norm_eps: 1.0e-5
    logit_scale: 0.25
    sliding_window: 8
    sliding_window_pattern: 4
distributed:
  dp_shard: -1
backend:
  dtype: float32
  attention: flash
  remat_policy: mlp_attn_dots
dataset:
  _target_: automodel_tpu.data.llm.mock.MockSFTDataset
  vocab_size: 128
  seq_len: 32
  num_samples: 64
  seed: 0
micro_batch_size: 8
seq_len: 32
step_scheduler:
  grad_acc_steps: 2
  max_steps: 3
loss:
  name: linear_ce
  impl: xla
optimizer:
  optimizer: adamw
  lr: 3.0e-3
  weight_decay: 0.01
  max_grad_norm: 1.0
lr_scheduler:
  lr_warmup_steps: 1
checkpoint:
  enabled: false
"""


def _losses(path):
    import json

    with open(path) as f:
        return [r["loss"] for r in map(json.loads, f) if "loss" in r]


def test_cohere2_train_ft_losses_match_jax(tmp_path):
    """Three train_ft steps of a tiny Cohere2 (the R7B config format: 3 sliding RoPE
    layers, 1 full NoPE layer; tied linear CE with the logit scale folded into the
    unembedding; adamw with decay and clipping), the port's recipe given JAX's initial
    weights: the per-step losses agree to 1e-4."""
    cfg_path = tmp_path / "cohere2.yaml"
    cfg_path.write_text(textwrap.dedent(COHERE2_YAML))
    cfg = jax_load_config(str(cfg_path))
    cfg.set_by_path("output_dir", str(tmp_path / "jax"))
    jax_recipe = JaxTrainFt(cfg)
    jax_recipe.setup()
    params = jax.device_get(jax_recipe.params)
    jax_recipe.run_train_validation_loop()
    port_cfg = parse_args_and_load_config(["-c", str(cfg_path), "--output_dir",
                                           str(tmp_path / "port")])
    port = train_ft.TrainFinetuneRecipeForNextTokenPrediction(port_cfg)
    port.setup()
    assert port.loss_name == "linear_ce" and port.model.config.logits_scaling == 4.0
    port.model.load_params(params_from_jax(params, port.model.config))
    port.run_train_validation_loop()
    want = _losses(tmp_path / "jax" / "training.jsonl")
    got = _losses(tmp_path / "port" / "training.jsonl")
    assert len(got) == len(want) == 3
    assert got == pytest.approx(want, abs=1e-4)


def test_unembed_division_keeps_the_tied_layout():
    """Granite's logits_scaling (Cohere's logit_scale) divides the unembedding; a tied
    one stays a transposed view of a row-major (V, E) tensor, which the linear-CE
    kernels read in place."""
    from automodel_tpu_torch.models.common.transformer import resolve_unembed
    from automodel_tpu_torch.ops.linear_ce import kernel_operand

    cfg = LlamaConfig.from_hf(FAMILIES["granite"])
    params = {"embed": torch.randn(128, 64)}
    w = resolve_unembed(cfg, params, torch.bfloat16)
    store, vmajor = kernel_operand(w)
    assert vmajor and store.shape == (128, 64) and store.is_contiguous()
    torch.testing.assert_close(w.float(), (params["embed"].t() / 8.0).bfloat16().float())
