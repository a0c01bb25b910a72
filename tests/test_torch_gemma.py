"""The port's Gemma 2 / 3 against the JAX package's, f32, on tiny configs: Gemma-2 at 2
layers (sliding, full: a window of 12 on rows of 32), attention soft-cap 2 and final
soft-cap 3; Gemma-3 at 6 layers (5 sliding, 1 full, its default pattern), q / k norms and
dual RoPE (the full layer's linear scaling 8, the local base 10,000); Gemma-2 again at
head_dim 256 (2 heads over 1, query scale 256^-0.5), Gemma-2-9B's and Gemma-3's head
width. Weights come from a numpy seed in the JAX package's parameter tree, scaled so
that both caps bite (the
matrices N(0, 0.15^2), the embedding N(0, 0.3^2), the zero-centred norms N(0, 0.2^2)),
and are carried across with params_from_jax. The port's "flash" path (the kernels'
plain version on the CPU) runs against JAX's Pallas kernels in interpret mode
("flash_interpret": the soft-cap inside them): logits and every parameter's gradient
agree to rtol = atol = 1e-4. Also: the final cap on the logits path and none under
return_hidden; a full layer's window of None against JAX's window past every distance;
the configs both packages read (the multimodal wrapper's text_config too); the adapter
against JAX's (HF names, the multimodal prefixes, the round trip); three train steps of
each loss (masked CE on capped logits, linear CE on uncapped hidden states) against
JAX's; and the FLOP count."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.gemma.model import GemmaForCausalLM as JaxGemma
from automodel_tpu.ops.losses import linear_cross_entropy as jax_lce
from automodel_tpu.ops.losses import masked_cross_entropy as jax_ce
from automodel_tpu.optim.builder import build_optimizer as jax_build_optimizer
from automodel_tpu.optim.scheduler import build_lr_schedule as jax_schedule
from automodel_tpu.training.train_step import make_train_step as jax_make_train_step
from automodel_tpu.utils.flops import flops_per_token as jax_flops_per_token
from automodel_tpu_torch.models.auto import AutoModelForCausalLM
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.gemma.model import GemmaConfig, GemmaForCausalLM
from automodel_tpu_torch.models.llama.convert import flatten, params_from_jax
from automodel_tpu_torch.models.registry import resolve_model_class
from automodel_tpu_torch.ops.flash_attention import flash_attention
from automodel_tpu_torch.ops.losses import linear_cross_entropy, masked_cross_entropy
from automodel_tpu_torch.optim.builder import build_optimizer
from automodel_tpu_torch.optim.scheduler import build_lr_schedule
from automodel_tpu_torch.training.train_step import make_train_step
from automodel_tpu_torch.utils.flops import flops_per_token
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TOL = 1e-4
GEMMA2 = dict(architectures=["Gemma2ForCausalLM"], vocab_size=128, hidden_size=64,
              intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, query_pre_attn_scalar=24,
              attn_logit_softcapping=2.0, final_logit_softcapping=3.0, sliding_window=12,
              max_position_embeddings=256, rms_norm_eps=1e-6)
GEMMA3 = dict(architectures=["Gemma3ForCausalLM"], vocab_size=128, hidden_size=64,
              intermediate_size=128, num_hidden_layers=6, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, query_pre_attn_scalar=16, sliding_window=12,
              rope_theta=1_000_000.0, rope_local_base_freq=10_000.0,
              rope_scaling={"rope_type": "linear", "factor": 8.0},
              max_position_embeddings=256, rms_norm_eps=1e-6)
# Gemma-2-9B's head shape (head_dim 256, 2 q heads over 1 kv head, the query scale
# 256^-0.5) with both caps and alternating windows: the flash kernels' D=256 tiles on the card
GEMMA2_D256 = dict(GEMMA2, num_attention_heads=2, num_key_value_heads=1, head_dim=256,
                   query_pre_attn_scalar=256)
FAMILIES = {"gemma2": GEMMA2, "gemma3": GEMMA3, "gemma2_d256": GEMMA2_D256}
# the published config.json files (Hugging Face Hub) of google/gemma-2-27b and the text
# part of google/gemma-3-4b-pt (its Gemma3ForConditionalGeneration wrapper)
GEMMA2_27B = dict(architectures=["Gemma2ForCausalLM"], vocab_size=256000, hidden_size=4608,
                  intermediate_size=36864, num_hidden_layers=46, num_attention_heads=32,
                  num_key_value_heads=16, head_dim=128, query_pre_attn_scalar=144,
                  attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
                  sliding_window=4096, rope_theta=10000.0, rms_norm_eps=1e-6,
                  max_position_embeddings=8192, hidden_activation="gelu_pytorch_tanh")
GEMMA3_4B = dict(architectures=["Gemma3ForConditionalGeneration"],
                 text_config=dict(hidden_size=2560, intermediate_size=10240,
                                  num_hidden_layers=34, num_attention_heads=8,
                                  num_key_value_heads=4, head_dim=256, vocab_size=262208,
                                  query_pre_attn_scalar=256, sliding_window=1024,
                                  rope_scaling={"rope_type": "linear", "factor": 8.0},
                                  rope_local_base_freq=10000.0, rope_theta=1000000.0,
                                  max_position_embeddings=131072),
                 vision_config=dict(hidden_size=1152, intermediate_size=4304,
                                    num_hidden_layers=27, num_attention_heads=16,
                                    patch_size=14, image_size=896))


def _jax_params(hf, seed=0):
    """Weights from a numpy seed in the JAX package's tree (its abstract parameters, so
    nothing is compiled), scaled so that both soft-caps bite. Each sublayer's output is
    normed (the sandwich norms), so a gradient scales as the inverse of its weights:
    at the init's 0.02 the gradients reach the hundreds, where f32 sums in another order
    differ by more than 1e-4."""
    rng = np.random.RandomState(seed)
    tree = {}
    for name, leaf in flatten(JaxGemma.from_config(hf).abstract_params(jnp.float32)).items():
        *path, last = name.split(".")
        scale = 0.2 if last.endswith("norm") else 0.3 if last == "embed" else 0.15
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = (scale * rng.randn(*leaf.shape)).astype(np.float32)
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


def _port(hf, params):
    tm = GemmaForCausalLM.from_config(hf, BackendConfig(dtype="float32", attention="flash",
                                                        remat_policy="full"), device="cpu")
    tm.load_params(params_from_jax(params, tm.config))
    return tm


def _jax_model(hf):
    return JaxGemma.from_config(hf, JaxBackend(dtype="float32", remat_policy="full",
                                               attention="flash_interpret"))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_and_grads_match_jax(family):
    """Gemma-2's attention and final soft-caps with alternating windows, Gemma-3's q / k
    norms, dual RoPE and 5:1 windows: logits and every gradient against JAX's, on packed
    rows with restarting positions and a padded row."""
    hf = FAMILIES[family]
    params = _jax_params(hf)
    ids, pos, seg = _batch()
    # a cotangent of unit norm a token: the gradients stay O(10), where f32 holds 1e-4
    ct = (np.random.RandomState(2).randn(*ids.shape, hf["vocab_size"])
          / np.sqrt(hf["vocab_size"])).astype(np.float32)
    jm = _jax_model(hf)

    def jloss(p):
        logits = jm(p, jnp.asarray(ids), positions=jnp.asarray(pos),
                    segment_ids=jnp.asarray(seg))
        return jnp.sum(logits * ct), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    tm = _port(hf, params)
    assert tm.config.sliding_flags == ([True, False] if family.startswith("gemma2")
                                       else [True] * 5 + [False])
    logits = tm(torch.tensor(ids), positions=torch.tensor(pos), segment_ids=torch.tensor(seg))
    grads = torch.autograd.grad((logits * torch.tensor(ct)).sum(), list(tm.param_dict().values()))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
    jflat = flatten(jgrads)
    assert set(jflat) == set(tm.param_dict())
    for name, g in zip(tm.param_dict(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jflat[name]), atol=TOL, rtol=TOL,
                                   err_msg=name)


def test_final_soft_cap_on_the_logits_path_only():
    """Gemma-2's logits are c tanh((h E^T) / c) of the final hidden states h, and
    return_hidden gives h itself, uncapped, equal to JAX's (the linear-CE path of both
    packages trains on it without the final cap)."""
    params = _jax_params(GEMMA2)
    ids, pos, seg = _batch(seed=3)
    tm = _port(GEMMA2, params)
    kw = dict(positions=torch.tensor(pos), segment_ids=torch.tensor(seg))
    with torch.no_grad():
        h = tm(torch.tensor(ids), return_hidden=True, **kw)
        logits = tm(torch.tensor(ids), **kw)
        raw = h @ tm.param_dict()["embed"].t()
    cap = GEMMA2["final_logit_softcapping"]
    assert float(raw.abs().max()) > 2 * cap  # the cap bites
    np.testing.assert_allclose(logits.numpy(), (torch.tanh(raw / cap) * cap).numpy(),
                               atol=1e-6, rtol=0)
    jh = _jax_model(GEMMA2)(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                            positions=jnp.asarray(pos), segment_ids=jnp.asarray(seg),
                            return_hidden=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)


def test_full_layer_window_none_equals_jax_bound():
    """A full layer passes no window; JAX's Gemma passes max_position_embeddings + S
    there (its layers share one scan). With the soft-cap, segments and the query scale,
    the two give the same values and gradients."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.tensor(rng.randn(2, 32, n, 16).astype(np.float32), requires_grad=True)
               for n in (4, 2, 2))
    seg = torch.tensor(_batch()[2])
    kw = dict(segment_ids_q=seg, softmax_scale=24**-0.5, logit_soft_cap=2.0)
    outs = []
    for window in (None, GEMMA2["max_position_embeddings"] + 32):
        o = flash_attention(q, k, v, sliding_window=window, **kw)
        outs.append((o, *torch.autograd.grad(o.square().sum(), (q, k, v))))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hf", [
    GEMMA2, GEMMA3, GEMMA2_27B, GEMMA3_4B,
    dict(GEMMA3, sliding_window_pattern=3),
    dict(GEMMA2, layer_types=["full_attention", "sliding_attention"]),
    dict(GEMMA3, architectures=["Gemma3ForCausalLM"], attn_logit_softcapping=5.0,
         final_logit_softcapping=5.0),
], ids=["gemma2", "gemma3", "gemma2_27b", "gemma3_4b_multimodal", "pattern_3",
        "layer_types", "gemma3_caps_ignored"])
def test_from_hf_matches_jax(hf):
    """Every field of the port's config equals JAX's (from_config: the wrapper's
    text_config unwrapped), the architecture resolves to the port's class, and the
    port's from_hf reads a wrapper as from_config does."""
    got = GemmaForCausalLM.from_config(hf, device="cpu", params={}).config
    want = JaxGemma.from_config(hf).config
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert GemmaConfig.from_hf(hf) == got
    assert resolve_model_class(hf["architectures"][0]) is GemmaForCausalLM
    if hf is GEMMA2_27B:
        assert got.sliding_flags[:4] == [True, False, True, False]
        assert got.attn_logit_softcapping == 50.0 and not got.qk_norm


@pytest.mark.parametrize("family", ["gemma2", "gemma3", "multimodal"])
def test_adapter_matches_jax_and_round_trips(family):
    """to_hf gives JAX's adapter's HF names and values (Gemma-3's q / k norms among
    them); from_hf reads them back bitwise, and a multimodal checkpoint (either
    transformers layout of the language-model prefix, with vision tensors) loads its
    text backbone, in both packages alike."""
    hf = GEMMA2 if family == "gemma2" else GEMMA3
    params = _jax_params(hf)
    model = GemmaForCausalLM.from_config(hf, device="cpu", params={})
    flat = params_from_jax(params, model.config)
    adapter = model.state_dict_adapter()
    exported = adapter.to_hf(flat)
    jadapter = JaxGemma.from_config(hf).state_dict_adapter()
    want = jadapter.to_hf(params)
    assert set(exported) == set(want)
    if family != "gemma2":
        assert "model.layers.5.self_attn.k_norm.weight" in exported
    for key, value in want.items():
        np.testing.assert_array_equal(exported[key].numpy(), np.asarray(value), err_msg=key)
    if family == "multimodal":
        exported = {("model.language_model." if i % 2 else "language_model.model.")
                    + key[len("model."):]: value for i, (key, value) in enumerate(exported.items())}
        exported["vision_tower.vision_model.embeddings.patch_embedding.weight"] = torch.zeros(3)
        exported["multi_modal_projector.mm_input_projection_weight"] = torch.zeros(3)
        jback = flatten(jadapter.from_hf({k: v.numpy() for k, v in exported.items()}))
        assert set(jback) == set(flat)
    back = adapter.from_hf(exported)
    assert set(back) == set(flat)
    for key, value in flat.items():
        assert torch.equal(back[key], value), key


def _train_batches(n_steps=3):
    out = []
    for step in range(n_steps):
        ids, pos, seg = _batch(seed=10 * step)
        labels = np.where(seg != 0, np.roll(ids, -1, -1), -100)
        out.append({"input_ids": ids[None], "positions": pos[None], "segment_ids": seg[None],
                    "labels": labels[None].astype(np.int32)})
    return out


SCHED = dict(max_lr=3e-3, min_lr=3e-4, lr_warmup_steps=2, lr_decay_steps=3)
OPT = dict(optimizer="adamw", weight_decay=0.1, max_grad_norm=0.5, eps=1e-5)


@pytest.mark.parametrize("loss", ["masked_ce", "linear_ce"])
def test_three_train_steps_match_jax(loss):
    """Three steps of the tiny Gemma-2 (adamw with clipping) with the loss the recipes
    pick: masked CE over the capped logits, or linear CE over the hidden states and the
    tied embedding (no final cap: JAX's train_ft and the port's alike). Losses and
    gradient norms to 1e-4, the parameters after to 1e-3 relative."""
    params = _jax_params(GEMMA2)
    batches = _train_batches()
    jm = _jax_model(GEMMA2)

    def jax_forward_loss(p, batch, n):
        out = jm(p, batch["input_ids"], positions=batch["positions"],
                 segment_ids=batch["segment_ids"], return_hidden=loss == "linear_ce")
        if loss == "linear_ce":
            return jax_lce(out, p["embed"].T, batch["labels"], n, impl="xla", filter_eps=None)
        return jax_ce(out, batch["labels"], n)

    opt = jax_build_optimizer(lr=jax_schedule(**SCHED), betas=(0.9, 0.95), **OPT)
    step = jax.jit(jax_make_train_step(jax_forward_loss, opt))
    jp = jax.tree.map(jnp.asarray, params)
    state, jax_metrics = opt.init(jp), []
    for batch in batches:
        jp, state, m = step(jp, state, {k: jnp.asarray(v) for k, v in batch.items()})
        jax_metrics.append({k: float(v) for k, v in m.items()})

    tm = _port(GEMMA2, params)
    tparams = tm.param_dict()

    def forward_loss(batch, n):
        out = tm(batch["input_ids"], positions=batch["positions"],
                 segment_ids=batch["segment_ids"], return_hidden=loss == "linear_ce")
        if loss == "linear_ce":
            return linear_cross_entropy(out, tparams["embed"].t(), batch["labels"], n,
                                        filter_eps=None)
        return masked_cross_entropy(out, batch["labels"], n)

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


@pytest.mark.parametrize("hf", [GEMMA2_27B, GEMMA3_4B], ids=["gemma2_27b", "gemma3_4b"])
def test_flops_count_gemma(hf):
    """Gemma-2-27B at seq 2048 (head_dim 128, every layer's full S^2 term), and the
    Gemma-3 wrapper (its text model plus one image through the vision tower, amortised
    over the sequence), as JAX counts them."""
    assert flops_per_token(hf, 2048) == jax_flops_per_token(hf, 2048)
    if hf is GEMMA2_27B:
        d, n, k, h, i, v = 4608, 32, 16, 128, 36864, 256000
        attn = 2 * d * (n + 2 * k) * h + 2 * n * h * d + 4 * 2048 * n * h
        assert flops_per_token(hf, 2048) == 3 * (46 * (attn + 3 * 2 * d * i) + 2 * d * v)


def test_auto_loads_a_local_gemma_directory(tmp_path):
    """A Gemma-2 directory written by the port's safetensors writer loads through
    AutoModelForCausalLM.from_pretrained (the registry's class, its adapter) bitwise."""
    from automodel_tpu_torch.checkpoint.safetensors_io import save_safetensors

    model = GemmaForCausalLM.from_config(GEMMA2, device="cpu")
    assert all(float(p.detach().abs().max()) == 0 for n, p in model.param_dict().items()
               if n.endswith("norm"))  # zero-centred norms start at 0
    save_safetensors(model.state_dict_adapter().to_hf_lazy(model.param_dict()), str(tmp_path))
    (tmp_path / "config.json").write_text(__import__("json").dumps(GEMMA2))
    loaded = AutoModelForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    assert isinstance(loaded, GemmaForCausalLM)
    for name, value in model.param_dict().items():
        assert torch.equal(loaded.param_dict()[name], value), name
