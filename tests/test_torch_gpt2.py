"""The port's GPT-2 against the JAX package's: a tiny config (vocab 128, width 32, 2
layers, 4 heads), weights built in JAX and carried across. Logits and every gradient
within 1e-4 (f32) on the flash path (JAX's Pallas kernel in interpret mode against the
kernels' plain version) and on the einsum path; the matmuls each remat policy's backward
replays equal JAX's (GPT-2's layer names no saves); the HF adapter is JAX's and ignores
HF's attention-mask buffers; the nanoGPT shard reader gives JAX's samples (both magics,
uint16 / uint32 tokens, across shards, aligned to BOS); three train_ft steps on shards
give JAX's losses within 1e-4, with rows that carry no MFU (GPT-2's config is outside the
FLOPs formula in both packages), and a run resumed mid-epoch is bitwise the uninterrupted
one."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.config.loader import load_config as jax_load_config
from automodel_tpu.data.llm import nanogpt_dataset as jax_nanogpt
from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.gpt2.model import GPT2LMHeadModel as JaxGPT2
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JaxTrainFt)
from automodel_tpu.utils.flops import flops_per_token as jax_flops
from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.data.llm import nanogpt_dataset
from automodel_tpu_torch.models.auto import AutoModelForCausalLM
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.gpt2.model import GPT2LMHeadModel
from automodel_tpu_torch.models.llama.convert import flatten, params_from_jax
from automodel_tpu_torch.ops import flash_attention as tfa
from automodel_tpu_torch.recipes.llm import train_ft
from automodel_tpu_torch.utils.flops import flops_per_token
from tests.test_torch_llama import MatmulCounter, jax_matmul_counts
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

HF = dict(architectures=["GPT2LMHeadModel"], vocab_size=128, n_positions=64, n_embd=32,
          n_layer=2, n_head=4)
ATTENTION = {"flash": ("flash_interpret", "flash"), "xla": ("xla", "xla")}


def _jax(hf=HF, attention="xla", remat="full"):
    return JaxGPT2.from_config(hf, JaxBackend(dtype="float32", attention=attention,
                                              remat_policy=remat))


def _port(hf=HF, attention="xla", remat="full", params=None):
    model = AutoModelForCausalLM.from_config(
        hf, BackendConfig(dtype="float32", attention=attention, remat_policy=remat), device="cpu")
    if params is not None:
        model.load_params(params_from_jax(params, model.config))
    return model


def _params(seed=0):
    """JAX's init, with the biases and LayerNorm parameters moved off 0 and 1 so that
    each one shows in the logits."""
    params = jax.device_get(_jax().init(jax.random.key(seed)))
    rng = np.random.RandomState(seed)

    def moved(tree):
        return {k: moved(v) if isinstance(v, dict) else
                v + 0.1 * rng.randn(*v.shape).astype(np.float32) if k.endswith(("_b", "_w"))
                else np.asarray(v) for k, v in tree.items()}

    return moved(params)


def _batch(b=2, s=32, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, (b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    seg[0, s // 2:] = 2  # two packed sequences in row 0
    seg[1, s - 6:] = 0  # right padding in row 1
    pos = np.concatenate([np.arange(s // 2), np.arange(s // 2)])[None].repeat(b, 0)
    pos[1] = np.arange(s)
    return ids, pos.astype(np.int32), seg


@pytest.mark.parametrize("attention", list(ATTENTION))
def test_logits_and_grads_match_jax(attention):
    jax_attention, port_attention = ATTENTION[attention]
    params = _params()
    ids, pos, seg = _batch()
    ct = np.random.RandomState(1).randn(*ids.shape, 128).astype(np.float32) / ids.size
    jm = _jax(attention=jax_attention)

    def jax_loss(p):
        logits = jm(p, jnp.asarray(ids), positions=jnp.asarray(pos), segment_ids=jnp.asarray(seg))
        return jnp.sum(logits * ct), logits

    (_, want), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    model = _port(attention=port_attention, params=params)
    weights = model.param_dict()
    logits = model(torch.from_numpy(ids), positions=torch.from_numpy(pos),
                   segment_ids=torch.from_numpy(seg))
    grads = torch.autograd.grad((logits * torch.from_numpy(ct)).sum(), list(weights.values()))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    jflat = flatten(jax.device_get(jgrads))
    assert set(jflat) == set(weights)
    for name, g in zip(weights, grads):
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=1e-4, atol=1e-4, err_msg=name)
    flat_axes = flatten(jm.logical_axes())
    assert model.logical_axes() == {k: tuple(v) for k, v in flat_axes.items()}


@pytest.mark.parametrize("policy", ["none", "dots", "dots_no_batch", "mlp_dots"])
def test_remat_replays_the_matmuls_jax_replays(policy, monkeypatch):
    """Under each policy the loss and gradients equal "full", and the matmuls of the
    forward and backward equal the dot_generals of JAX's grad under the same policy
    (outside the Pallas kernels): GPT-2 names no saves, so "none" and "mlp_dots" replay
    c_attn, c_proj and c_fc (the backward needs no output of c_proj2, so the replay stops
    before it); flash's stand-in runs once more than the forward (the replay) where JAX's
    forward kernel does."""
    hf = dict(HF, n_layer=1)
    params = jax.device_get(_jax(hf).init(jax.random.key(0)))
    ids = np.random.RandomState(1).randint(0, 128, (2, 32)).astype(np.int32)
    calls = []
    plain = tfa.flash_attention_reference
    monkeypatch.setattr(tfa, "flash_attention_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    out = {}
    for remat in (policy, "full"):
        model = _port(hf, "flash", remat, params)
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
    want, pallas_calls = jax_matmul_counts(jax.make_jaxpr(jax.grad(
        lambda p: jnp.mean(jnp.square(jm(p, jnp.asarray(ids))))))(params))
    assert counts == want
    assert flash_calls + 1 == pallas_calls == 3
    replayed = {"none": 3, "dots": 0, "dots_no_batch": 0, "mlp_dots": 3}[policy]
    assert sum(counts.values()) - sum(out["full"][2].values()) == replayed


def test_adapter_matches_jax_and_ignores_the_mask_buffers():
    params = _params()
    model = _port(params=params)
    adapter = model.state_dict_adapter()
    hf = adapter.to_hf(model.param_dict())
    want = _jax().state_dict_adapter().to_hf(params)
    assert set(hf) == set(want) and "lm_head.weight" not in hf
    for key, t in hf.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[key]), err_msg=key)
    assert hf["transformer.h.0.attn.c_attn.weight"].shape == (32, 96)  # Conv1D (in, out)
    # an HF checkpoint's causal-mask buffers and tied head are read by no entry
    extra = {f"transformer.h.{i}.attn.{b}": torch.ones(1, 1, 64, 64)
             for i in range(2) for b in ("bias", "masked_bias")}
    back = adapter.from_hf({**hf, **extra, "lm_head.weight": hf["transformer.wte.weight"]})
    assert set(back) == set(model.param_dict())
    for name, t in back.items():
        assert torch.equal(t, model.param_dict()[name]), name


def test_kv_cache_and_generate_are_refused_by_name():
    model = _port()
    with pytest.raises(NotImplementedError, match="KV-cache decoding belongs to generation"):
        model(torch.zeros(1, 8, dtype=torch.long), cache={"k": None})
    with pytest.raises(NotImplementedError, match="generation"):
        model.generate(torch.zeros(1, 8, dtype=torch.long))


def _legacy_shard(path, tokens):
    header = np.zeros(256, np.int32)
    header[:3] = (jax_nanogpt.LEGACY_MAGIC, 1, len(tokens))
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(np.asarray(tokens, np.uint16).tobytes())


@pytest.mark.parametrize("layout", ["uint16", "uint32", "legacy"])
def test_nanogpt_shards_match_jax(layout, tmp_path):
    """Samples of seq_len + 1 tokens across two shards (and aligned to BOS), and the
    header's token count, as JAX reads them; a bad magic and an empty pattern raise."""
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 70000 if layout == "uint32" else 500, 1000)
    tokens[::37] = 7  # BOS
    for i, part in enumerate((tokens[:600], tokens[600:])):
        path = str(tmp_path / f"s_{i}.bin")
        if layout == "legacy":
            _legacy_shard(path, part)
        else:
            nanogpt_dataset.write_shard(path, part, np.dtype(layout))
        assert nanogpt_dataset.peek_num_tokens(path) == jax_nanogpt.peek_num_tokens(path)
    for kw in ({}, {"align_to_bos": True, "bos_token": 7}):
        ours = nanogpt_dataset.NanogptDataset(str(tmp_path / "s_*.bin"), 64, **kw)
        theirs = jax_nanogpt.NanogptDataset(str(tmp_path / "s_*.bin"), 64, **kw)
        assert len(ours) == len(theirs) == 15
        for i in range(len(ours) + 2):
            np.testing.assert_array_equal(ours[i]["input_ids"], theirs[i]["input_ids"])
        if not kw:  # sample 9 spans the two shards
            np.testing.assert_array_equal(ours[9]["input_ids"], tokens[9 * 64:10 * 64 + 1])
    (tmp_path / "bad.bin").write_bytes(np.zeros(256, np.int32).tobytes())
    with pytest.raises(ValueError, match="bad magic"):
        nanogpt_dataset.peek_num_tokens(str(tmp_path / "bad.bin"))
    with pytest.raises(FileNotFoundError):
        nanogpt_dataset.NanogptDataset(str(tmp_path / "none_*.bin"), 64)


RECIPE = """
seed: 3
device: cpu
output_dir: {out}
model:
  config:
    architectures: [GPT2LMHeadModel]
    vocab_size: 128
    n_embd: 32
    n_layer: 2
    n_head: 4
    n_positions: 64
distributed:
  dp_shard: -1
dataset:
  _target_: automodel_tpu.data.llm.nanogpt_dataset.NanogptDataset
  file_pattern: "{shards}/train_*.bin"
  seq_len: 32
backend:
  dtype: float32
  attention: flash
  remat_policy: mlp_dots
micro_batch_size: 8
seq_len: 32
step_scheduler:
  grad_acc_steps: 2
  max_steps: {steps}
  num_epochs: 3
  ckpt_every_steps: 2
optimizer:
  lr: 6.0e-3
  weight_decay: 0.01
  betas: [0.9, 0.95]
  max_grad_norm: 1.0
lr_scheduler:
  lr_warmup_steps: 1
  lr_decay_style: cosine
checkpoint:
  enabled: {ckpt}
  checkpoint_dir: {out}/ckpt
  save_consolidated: true
"""


def _config(tmp_path, out, steps=3, ckpt=False):
    shards = tmp_path / "shards"
    if not shards.exists():
        shards.mkdir()
        tokens = np.random.RandomState(0).randint(0, 128, 3000)
        for i in range(2):
            nanogpt_dataset.write_shard(str(shards / f"train_{i}.bin"), tokens[i::2])
    p = tmp_path / f"{out}.yaml"
    p.write_text(RECIPE.format(out=tmp_path / out, shards=shards, steps=steps,
                               ckpt=str(ckpt).lower()))
    return str(p)


def _rows(path):
    with open(path) as f:
        return [r for r in map(json.loads, f) if "loss" in r]


def test_train_ft_on_nanogpt_shards_matches_jax(tmp_path, monkeypatch):
    """Three steps of 2 microbatches (flash, mlp_dots, adamw with decay, clipping and a
    cosine schedule), the port given JAX's initial weights: losses within 1e-4; neither
    package's FLOPs count reads GPT-2's config, so no row carries tflops or MFU. The JAX
    recipe runs on one device: data-parallel over the conftest's 8, its compiled step
    wants GPT-2's LayerNorm weights replicated and is passed them sharded (a ValueError,
    ROADMAP.md Queue 3)."""
    cfg_path = _config(tmp_path, "jax")
    one = jax.devices()[:1]
    for name, value in (("devices", lambda *a, **k: one), ("local_devices", lambda *a, **k: one),
                        ("device_count", lambda *a, **k: 1),
                        ("local_device_count", lambda *a, **k: 1)):
        monkeypatch.setattr(jax, name, value)
    jax_recipe = JaxTrainFt(jax_load_config(cfg_path))
    jax_recipe.setup()
    params = jax.device_get(jax_recipe.params)
    jax_recipe.run_train_validation_loop()
    monkeypatch.undo()
    port_cfg = parse_args_and_load_config(["-c", cfg_path, "--output_dir",
                                           str(tmp_path / "port")])
    port = train_ft.TrainFinetuneRecipeForNextTokenPrediction(port_cfg)
    port.setup()
    assert isinstance(port.model, GPT2LMHeadModel) and port.loss_name == "masked_ce"
    port.model.load_params(params_from_jax(params, port.model.config))
    port.run_train_validation_loop()
    want, got = _rows(tmp_path / "jax" / "training.jsonl"), _rows(tmp_path / "port" / "training.jsonl")
    assert len(got) == len(want) == 3
    assert [r["loss"] for r in got] == pytest.approx([r["loss"] for r in want], abs=1e-4)
    assert not any("mfu" in r or "tflops_per_chip" in r for r in got + want)
    assert [r["num_label_tokens"] for r in got] == [512] * 3
    for count in (jax_flops, flops_per_token):
        with pytest.raises(TypeError):
            count(HF, 32)


def test_resume_mid_epoch_is_bitwise(tmp_path):
    """A 4-step run saving at steps 2 and 4; step_4 removed, a second run resumes from
    step 2 at the loader's saved cursor (mid-epoch: 93 samples, 11 batches of 8 an epoch)
    and logs the uninterrupted step-3 and step-4 losses exactly; hf/ reloads bitwise."""
    import shutil

    cfg_path = _config(tmp_path, "a", steps=4, ckpt=True)
    first = train_ft.main(argv=["-c", cfg_path])
    shutil.rmtree(tmp_path / "a" / "ckpt" / "step_4")
    again = train_ft.main(argv=["-c", cfg_path, "--output_dir", str(tmp_path / "b")])
    a, b = _rows(tmp_path / "a" / "training.jsonl"), _rows(tmp_path / "b" / "training.jsonl")
    assert [r["step"] for r in b] == [3, 4]
    assert [r["loss"] for r in b] == [r["loss"] for r in a[2:]]
    for name, t in first.model.param_dict().items():
        assert torch.equal(t, again.model.param_dict()[name]), name
    reloaded = AutoModelForCausalLM.from_pretrained(str(tmp_path / "a" / "ckpt" / "step_4" / "hf"),
                                                    device="cpu")
    for name, t in again.model.param_dict().items():
        assert torch.equal(t, reloaded.param_dict()[name]), name
