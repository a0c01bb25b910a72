"""The port's sequence classification against the JAX package's: the datasets and
collation, the classifier (a tiny Llama trunk, f32: logits and every gradient within
1e-4, on the flash path, JAX's Pallas kernel in interpret mode against the kernels'
plain version, and on the einsum path), its HF adapter and its fresh head, the MoE
refusal beside JAX's TypeError, and three train_seq_cls steps (with and without LoRA on
wq / wv, under which the head stays at its init in both) given JAX's initial weights:
per-step losses within 1e-4."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.config.loader import load_config as jax_load_config
from automodel_tpu.data.llm import column_mapped as jax_column_mapped
from automodel_tpu.data.llm import seq_cls as jax_seq_cls
from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.seq_cls import (
    AutoModelForSequenceClassification as JaxAutoSeqCls)
from automodel_tpu.recipes.llm.train_seq_cls import TrainSeqClsRecipe as JaxSeqClsRecipe
from automodel_tpu_torch.checkpoint.safetensors_io import load_safetensors, save_safetensors
from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.data.llm import column_mapped, seq_cls
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.llama.convert import flatten, to_torch
from automodel_tpu_torch.models.seq_cls import AutoModelForSequenceClassification
from automodel_tpu_torch.recipes.llm import train_seq_cls
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)
from tests.unit.test_datasets_llm import WordTokenizer

HF = dict(architectures=["LlamaForCausalLM"], vocab_size=128, hidden_size=32,
          intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, max_position_embeddings=64)
ATTENTION = {"flash": ("flash_interpret", "flash"), "xla": ("xla", "xla")}


def _jax_model(hf=HF, attention="xla", num_labels=3):
    return JaxAutoSeqCls.from_config(hf, num_labels, JaxBackend(dtype="float32",
                                                                attention=attention))


def _port_model(hf=HF, attention="xla", num_labels=3, weights=None):
    model = AutoModelForSequenceClassification.from_config(
        hf, num_labels, BackendConfig(dtype="float32", attention=attention), device="cpu")
    if weights is not None:
        model.load_params({k: to_torch(v) for k, v in flatten(weights).items()})
    return model


def _batch(b=3, s=16, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 128, (b, s)).astype(np.int32)
    seg = np.zeros((b, s), np.int32)
    for r, n in enumerate((s, 9, 1)[:b]):  # a full row, a padded one, one token
        seg[r, :n] = 1
    pos = np.where(seg > 0, np.arange(s)[None], 0).astype(np.int32)
    return ids, pos, seg


def _rows(tmp_path):
    rows = [{"text": "good movie really", "label": 1, "other": "x y"},
            {"text": "bad", "label": 0, "other": "z"},
            {"text": "not bad at all", "label": 1, "other": ""}]
    p = tmp_path / "cls.jsonl"
    p.write_text("\n".join(json.dumps(r) for r in rows))
    return str(p)


def test_datasets_and_collate_match_jax(tmp_path):
    """SeqClsDataset (text and text pair), seq_cls_collate (right padding, segment 0 on
    it, cut at seq_len) and the column-mapped SFT dataset give JAX's arrays; a JSON file
    (a list, or {"data": [...]}) reads as JAX reads it."""
    path, tok = _rows(tmp_path), WordTokenizer()
    for pair in (None, "other"):
        ours = seq_cls.SeqClsDataset(tok, path, text_pair_column=pair)
        theirs = jax_seq_cls.SeqClsDataset(tok, path, text_pair_column=pair)
        assert [ours[i] for i in range(3)] == [theirs[i] for i in range(3)]
        for seq_len in (8, 2):
            got = seq_cls.seq_cls_collate([ours[i] for i in range(3)], seq_len, 2)
            want = jax_seq_cls.seq_cls_collate([theirs[i] for i in range(3)], seq_len, 2)
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    mapping = {"context": "other", "question": "text", "answer": "label"}
    for answer_only in (True, False):
        ours = column_mapped.ColumnMappedTextInstructionDataset(path, mapping, tok,
                                                                answer_only_loss_mask=answer_only)
        theirs = jax_column_mapped.ColumnMappedTextInstructionDataset(
            path, mapping, tok, answer_only_loss_mask=answer_only)
        assert [ours[i] for i in range(3)] == [theirs[i] for i in range(3)]
        assert ours.format_prompt(ours.rows[0]) == theirs.format_prompt(theirs.rows[0])
    rows = [{"text": "a", "label": 0}]
    for i, data in enumerate((rows, {"data": rows})):
        p = tmp_path / f"rows{i}.json"
        p.write_text(json.dumps(data))
        assert column_mapped._load_rows(str(p)) == jax_column_mapped._load_rows(str(p), None)


def test_hub_dataset_ids_are_refused_by_name(tmp_path):
    with pytest.raises(NotImplementedError, match="hub dataset id"):
        seq_cls.GLUE_MRPC(WordTokenizer())
    with pytest.raises(NotImplementedError, match="subset 'sst2'"):
        seq_cls.SeqClsDataset(WordTokenizer(), "glue", config_name="sst2")
    with pytest.raises(FileNotFoundError):
        column_mapped._load_rows(str(tmp_path / "missing.jsonl"))


@pytest.mark.parametrize("attention", list(ATTENTION))
def test_logits_and_grads_match_jax(attention):
    jax_attention, port_attention = ATTENTION[attention]
    jm = _jax_model(attention=jax_attention)
    params = jax.device_get(jm.init(jax.random.key(0)))
    assert "lm_head" not in params and params["score"].shape == (32, 3)
    ids, pos, seg = _batch()
    ct = np.random.RandomState(1).randn(3, 3).astype(np.float32)

    def jax_loss(p):
        logits = jm(p, jnp.asarray(ids), positions=jnp.asarray(pos), segment_ids=jnp.asarray(seg))
        return jnp.sum(logits * ct), logits

    (_, want), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    model = _port_model(attention=port_attention, weights=params)
    assert model.logical_axes()["score"] == ("embed", None)
    weights = model.param_dict()
    logits = model(torch.from_numpy(ids), positions=torch.from_numpy(pos),
                   segment_ids=torch.from_numpy(seg))
    grads = torch.autograd.grad((logits * torch.from_numpy(ct)).sum(), list(weights.values()))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    jflat = flatten(jax.device_get(jgrads))
    assert set(jflat) == set(weights)
    for name, g in zip(weights, grads):
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("tied", [True, False])
def test_adapter_and_fresh_head_match_jax(tied, tmp_path, monkeypatch):
    """A base checkpoint (no score.weight) loads with JAX's fresh head (default_rng(0),
    std initializer_range) and JAX's trunk; the classifier's export is JAX's (score.weight
    (labels, hidden), no lm_head.weight) and reloads bitwise, the untied trunk's too.
    JAX's from_pretrained pops score.weight from the lazy safetensors mapping, which has
    no pop (every local directory raises AttributeError there, ROADMAP.md Queue 3), so
    its loader is given the tensors as a dict; its export of an untied trunk reads the
    dropped lm_head (KeyError there), so its adapter is given a stand-in one, which the
    export drops."""
    import automodel_tpu.checkpoint.safetensors_io as jax_io

    from automodel_tpu_torch.models.auto import AutoModelForCausalLM

    jax_load = jax_io.load_safetensors
    monkeypatch.setattr(jax_io, "load_safetensors", lambda path: dict(jax_load(path)))

    hf = dict(HF, tie_word_embeddings=tied)
    base = AutoModelForCausalLM.from_config(hf, device="cpu")
    base_dir = tmp_path / "base"
    save_safetensors(base.state_dict_adapter().to_hf(base.param_dict()), str(base_dir))
    (base_dir / "config.json").write_text(json.dumps(hf))
    ours = AutoModelForSequenceClassification.from_pretrained(str(base_dir), 3, device="cpu")
    jm, jparams = JaxAutoSeqCls.from_pretrained(str(base_dir), 3, dtype=jnp.float32)
    jflat = flatten(jax.device_get(jparams))
    assert set(jflat) == set(ours.param_dict())
    for name, t in ours.param_dict().items():
        np.testing.assert_array_equal(t.detach().numpy(), jflat[name], err_msg=name)
    exported = ours.state_dict_adapter().to_hf(ours.param_dict())
    stand_in = {} if tied else {"lm_head": np.zeros((32, 128), np.float32)}
    want = jm.state_dict_adapter().to_hf(dict(jax.device_get(jparams), **stand_in))
    assert set(exported) == set(want) and "lm_head.weight" not in exported
    for key, t in exported.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[key]), err_msg=key)
    lazy = ours.state_dict_adapter().to_hf_lazy(ours.param_dict())
    cls_dir = tmp_path / "cls"
    save_safetensors(lazy, str(cls_dir))
    (cls_dir / "config.json").write_text(json.dumps(hf))
    assert load_safetensors(str(cls_dir))["score.weight"].shape == (3, 32)
    again = AutoModelForSequenceClassification.from_pretrained(str(cls_dir), 3, device="cpu")
    for name, t in again.param_dict().items():
        assert torch.equal(t, ours.param_dict()[name]), name


def test_moe_base_is_refused_where_jax_raises_type_error():
    """JAX's SequenceClassifier gathers from the MoE decoder's (hidden, stats) tuple and
    fails; the port refuses the MoE base by name."""
    hf = dict(HF, architectures=["MixtralForCausalLM"], num_local_experts=4,
              num_experts_per_tok=2)
    jm = _jax_model(hf)
    params = jm.init(jax.random.key(0))
    ids, pos, seg = _batch()
    with pytest.raises(TypeError):
        jm(params, jnp.asarray(ids), positions=jnp.asarray(pos), segment_ids=jnp.asarray(seg))
    with pytest.raises(NotImplementedError, match="MoE decoder"):
        _port_model(hf)


RECIPE = """
seed: 7
device: cpu
output_dir: {out}
model:
  num_labels: 2
  params_dtype: bfloat16
  config:
    architectures: [Qwen2ForCausalLM]
    vocab_size: 64
    hidden_size: 32
    intermediate_size: 64
    num_hidden_layers: 2
    num_attention_heads: 4
    num_key_value_heads: 2
    max_position_embeddings: 64
    attention_bias: true
distributed:
  dp_shard: {dp}
backend:
  dtype: float32
  attention: flash
{peft}
dataset:
  _target_: tests.functional.test_seq_cls_recipe.ParityDataset
  num_samples: 64
micro_batch_size: 8
seq_len: 16
step_scheduler:
  grad_acc_steps: 2
  max_steps: 3
  num_epochs: 10
optimizer:
  lr: 1.0e-2
  weight_decay: 0.01
  max_grad_norm: 1.0
lr_scheduler:
  lr_warmup_steps: 1
checkpoint:
  enabled: false
"""


def _losses(path):
    with open(path) as f:
        return [r["loss"] for r in map(json.loads, f) if "loss" in r]


@pytest.mark.parametrize("peft", [False, True])
def test_train_seq_cls_losses_match_jax(peft, tmp_path, monkeypatch):
    """Three steps of 2 microbatches (f32 parameters whatever params_dtype says, as JAX's),
    the port given the JAX recipe's initial weights (and adapter): losses within 1e-4.
    Under LoRA the trainable tensors are the four factors alone and the head keeps its
    init, in both; the JAX recipe then runs on one device (its PEFT step does not run
    data-parallel over the conftest's 8, ROADMAP.md Queue 3)."""
    section = "peft:\n  target_modules: ['*wq', '*wv']\n  dim: 4\n  alpha: 8" if peft else ""
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(RECIPE.format(out=tmp_path / "jax", dp=1 if peft else -1, peft=section))
    if peft:
        one = jax.devices()[:1]
        for name, value in (("devices", lambda *a, **k: one),
                            ("local_devices", lambda *a, **k: one),
                            ("device_count", lambda *a, **k: 1),
                            ("local_device_count", lambda *a, **k: 1)):
            monkeypatch.setattr(jax, name, value)
    jax_recipe = JaxSeqClsRecipe(jax_load_config(str(cfg_path)))
    jax_recipe.setup()
    params = jax.device_get(jax_recipe.params)
    lora = jax.device_get(jax_recipe.train_params) if peft else None
    score0 = np.asarray(params["score"])
    jax_recipe.run_train_validation_loop()
    monkeypatch.undo()

    Recipe = train_seq_cls.TrainSeqClsRecipe
    build = Recipe._build_peft

    def carried(self):
        self.model.load_params({k: to_torch(v) for k, v in flatten(params).items()})
        build(self)
        if lora is not None:
            with torch.no_grad():
                for name, value in flatten(lora).items():
                    self.train_params[name].copy_(to_torch(value))

    monkeypatch.setattr(Recipe, "_build_peft", carried)
    cfg = parse_args_and_load_config(["-c", str(cfg_path), "--output_dir",
                                      str(tmp_path / "port"), "--distributed.dp_shard", "-1"])
    port = train_seq_cls.main(cfg)
    assert all(t.dtype == torch.float32 for t in port.params.values())
    if peft:
        assert sorted(port.train_params) == sorted(flatten(jax.device_get(
            jax_recipe.train_params)))
        assert len(port.train_params) == 4
        np.testing.assert_array_equal(port.params["score"].numpy(), score0)
        np.testing.assert_array_equal(np.asarray(jax_recipe.params["score"]), score0)
    want = _losses(tmp_path / "jax" / "training.jsonl")
    got = _losses(tmp_path / "port" / "training.jsonl")
    assert len(got) == len(want) == 3
    assert got == pytest.approx(want, abs=1e-4)
    assert abs(got[0] - np.log(2)) < 0.2


@pytest.mark.parametrize("command,target", [
    ("finetune seq_cls", "automodel_tpu_torch.recipes.llm.train_seq_cls"),
    ("finetune biencoder", "automodel_tpu_torch.recipes.biencoder.train_biencoder"),
    ("mine biencoder", "automodel_tpu_torch.recipes.biencoder.mine_hard_negatives")])
def test_cli_routes_the_classifier_and_encoder_recipes(command, target, tmp_path, monkeypatch):
    import importlib

    from automodel_tpu_torch.cli import app

    got = {}
    monkeypatch.setattr(importlib.import_module(target), "main",
                        lambda cfg: got.setdefault("cfg", cfg))
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(RECIPE.format(out=tmp_path, dp=-1, peft=""))
    app.main([*command.split(), "-c", str(cfg_path), "--model.num_labels", "5"])
    assert got["cfg"].get("model.num_labels") == 5
