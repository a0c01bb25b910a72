"""The port's train_ft under PEFT and QAT against the JAX package's, on one device (the
JAX recipe sees the first CPU device alone: its PEFT step does not run data-parallel
over the conftest's 8, a reference caveat in ROADMAP.md Queue 3) and one tiny Llama
(the JAX PEFT suite's model, f32, 3 steps of 2 microbatches): the same initial base and
adapter (the JAX recipe's, carried across), per-step losses within 1e-4, for LoRA, DoRA,
QLoRA int8 and nf4, and QAT switched on at step 2. Also: ``hf/`` (merged) and
``hf_adapter/`` against JAX's exports, adapter-only checkpoints, the random streams and
the peft config in the client state, a frozen base, a resume that is bitwise (dropout
on), and the CLI's routing."""

import json
import textwrap

import jax
import numpy as np
import pytest
import torch

from automodel_tpu.config.loader import load_config as jax_load_config
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JaxTrainFt)
from automodel_tpu_torch.checkpoint.safetensors_io import load_safetensors
from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.models.llama.convert import flatten, params_from_jax, to_torch
from automodel_tpu_torch.quantization.qlora import is_quantized_leaf
from automodel_tpu_torch.recipes.llm import train_ft
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TOL_LOSS = 1e-4
Recipe = train_ft.TrainFinetuneRecipeForNextTokenPrediction


def _yaml(tmp_path, section, steps=3, ckpt=False):
    cfg = f"""
    seed: 7
    device: cpu
    output_dir: {tmp_path}/out
    model:
      params_dtype: float32
      config:
        architectures: [LlamaForCausalLM]
        vocab_size: 128
        hidden_size: 64
        intermediate_size: 128
        num_hidden_layers: 2
        num_attention_heads: 4
        num_key_value_heads: 2
        max_position_embeddings: 128
    distributed:
      dp_shard: 1
    backend:
      dtype: float32
    {section}
    dataset:
      _target_: automodel_tpu.data.llm.mock.MockSFTDataset
      vocab_size: 128
      seq_len: 32
      num_samples: 64
      seed: 0
      pattern: arith
    micro_batch_size: 8
    seq_len: 32
    step_scheduler:
      grad_acc_steps: 2
      max_steps: {steps}
      num_epochs: 10
      ckpt_every_steps: {2 if ckpt else 0}
    optimizer:
      lr: 3.0e-2
      weight_decay: 0.01
      max_grad_norm: 1.0
    lr_scheduler:
      lr_warmup_steps: 2
    checkpoint:
      enabled: {str(ckpt).lower()}
      checkpoint_dir: {tmp_path}/ckpt
      save_consolidated: {str(ckpt).lower()}
    """
    p = tmp_path / "cfg.yaml"
    p.write_text(textwrap.dedent(cfg))
    return str(p)


PEFT = "peft:\n      dim: 8\n      alpha: 32\n"
VARIANTS = {
    "lora": PEFT,
    "dora": PEFT + "      use_dora: true\n",
    "qlora_int8": PEFT + "      qlora: int8\n",
    "qlora_nf4": PEFT + "      qlora: nf4\n",
    "qat": "qat:\n      weight_bits: 8\n      fake_quant_after_n_steps: 2\n",
}


def _losses(path):
    with open(path) as f:
        return [r["loss"] for r in map(json.loads, f) if "loss" in r]


def _jax_run(cfg_path, monkeypatch, out_dir):
    """The JAX recipe, run; returns it with its dense base (before any quantization)."""
    from automodel_tpu.quantization import qlora as jq

    seen = {}
    quantize = jq.quantize_params

    def recording(params, *a, **k):
        seen["dense"] = jax.device_get(params)
        return quantize(params, *a, **k)

    monkeypatch.setattr(jq, "quantize_params", recording)
    one = jax.devices()[:1]
    for name, value in (("devices", lambda *a, **k: one), ("local_devices", lambda *a, **k: one),
                        ("device_count", lambda *a, **k: 1),
                        ("local_device_count", lambda *a, **k: 1)):
        monkeypatch.setattr(jax, name, value)
    cfg = jax_load_config(cfg_path)
    cfg.set_by_path("output_dir", str(out_dir))
    recipe = JaxTrainFt(cfg)
    recipe.setup()
    dense = seen.get("dense", jax.device_get(recipe.params))
    lora = jax.device_get(recipe.train_params) if recipe.peft is not None else None
    recipe.run_train_validation_loop()
    return recipe, dense, lora


def _port_setup(cfg_path, monkeypatch, out_dir, dense, lora, *overrides):
    """The port's recipe set up on the JAX recipe's base and adapter: the base is loaded
    before the adapter is made (and QLoRA quantizes it), the adapter copied after."""
    build = Recipe._build_peft

    def carried(self):
        self.model.load_params(params_from_jax(dense, self.model.config))
        build(self)
        if lora is not None:
            with torch.no_grad():
                for name, value in flatten(lora).items():
                    self.train_params[name].copy_(to_torch(value))

    monkeypatch.setattr(Recipe, "_build_peft", carried)
    cfg = parse_args_and_load_config(["-c", cfg_path, "--output_dir", str(out_dir), *overrides])
    recipe = Recipe(cfg)
    recipe.setup()
    return recipe


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_ft_matches_jax(variant, tmp_path, monkeypatch):
    cfg_path = _yaml(tmp_path, VARIANTS[variant])
    _, dense, lora = _jax_run(cfg_path, monkeypatch, tmp_path / "jax")
    port = _port_setup(cfg_path, monkeypatch, tmp_path / "port", dense, lora)
    port.run_train_validation_loop()
    want = _losses(tmp_path / "jax" / "training.jsonl")
    got = _losses(tmp_path / "port" / "training.jsonl")
    assert len(got) == len(want) == 3
    assert got == pytest.approx(want, abs=TOL_LOSS)
    if variant.startswith("qlora"):
        assert is_quantized_leaf(port.params["layers.wq"])
        assert not is_quantized_leaf(port.params["layers.attn_norm"])


def test_checkpoints_match_jax(tmp_path, monkeypatch):
    """LoRA with saves at steps 2 and 3: step_2/hf (the merged model) and
    step_2/hf_adapter (the HF PEFT export) equal JAX's in names and shapes and agree in
    values; the DCP state holds the adapter alone; the client state has the random
    streams and the peft config; the base stays frozen."""
    cfg_path = _yaml(tmp_path, PEFT, ckpt=True)
    _, dense, lora = _jax_run(cfg_path, monkeypatch, tmp_path / "jax")
    jax_step2 = tmp_path / "ckpt" / "step_2"
    jax_hf = load_safetensors(str(jax_step2 / "hf"))
    jax_adapter = load_safetensors(str(jax_step2 / "hf_adapter" / "adapter_model.safetensors"))
    port = _port_setup(cfg_path, monkeypatch, tmp_path / "port", dense, lora,
                       "--checkpoint.checkpoint_dir", str(tmp_path / "port_ckpt"))
    port.run_train_validation_loop()
    step2 = tmp_path / "port_ckpt" / "step_2"
    hf = load_safetensors(str(step2 / "hf"))
    assert sorted(hf) == sorted(jax_hf)
    for k in jax_hf:
        torch.testing.assert_close(hf[k], jax_hf[k], atol=1e-4, rtol=1e-4)
    adapter = load_safetensors(str(step2 / "hf_adapter" / "adapter_model.safetensors"))
    assert sorted(adapter) == sorted(jax_adapter)
    assert len(adapter) == 2 * 7 * 2  # A and B of 7 projections in 2 layers
    for k in jax_adapter:
        torch.testing.assert_close(adapter[k], jax_adapter[k], atol=1e-4, rtol=1e-4)
    for name in ("hf_adapter/adapter_config.json",):
        with open(step2 / name) as f, open(jax_step2 / name) as g:
            assert json.load(f) == json.load(g)
    with open(step2 / "signature.json") as f:
        names = [k for k in json.load(f) if not k.startswith("__")]
    assert names and all(k.rsplit(".", 1)[-1] in ("lora_a", "lora_b") for k in names)
    with open(step2 / "client.json") as f:
        client = json.load(f)
    assert client["peft_config"]["dim"] == 8 and "lora_init" in client["rng"]["streams"]
    assert all(not p.requires_grad for p in port.params.values())


def test_adapter_resume_is_bitwise(tmp_path):
    """LoRA with dropout, saves at steps 2 and 3: a run resumed from step 2 (its
    dropout stream restored from client.json) ends on the uninterrupted run's step-3
    adapter bitwise."""
    cfg_path = _yaml(tmp_path, PEFT + "      dropout: 0.1\n", ckpt=True)
    args = ["-c", cfg_path]
    a = train_ft.main(argv=[*args, "--output_dir", str(tmp_path / "a")])
    final = {k: v.detach().clone() for k, v in a.train_params.items()}
    with open(tmp_path / "ckpt" / "step_2" / "client.json") as f:
        assert "lora_dropout" in json.load(f)["rng"]["streams"]
    import shutil

    shutil.rmtree(tmp_path / "ckpt" / "step_3")
    b = train_ft.main(argv=[*args, "--output_dir", str(tmp_path / "b")])
    rows = [json.loads(x) for x in open(tmp_path / "b" / "training.jsonl")]
    assert [r["step"] for r in rows if "loss" in r] == [3]
    for k, v in final.items():
        assert torch.equal(b.train_params[k].detach(), v), k


@pytest.mark.parametrize("command,target", [
    ("finetune llm", "automodel_tpu_torch.recipes.llm.train_ft"),
    ("pretrain llm", "automodel_tpu_torch.recipes.llm.train_ft"),
    ("benchmark llm", "automodel_tpu_torch.recipes.llm.benchmark")])
def test_cli_routes_to_the_port(command, target, tmp_path, monkeypatch):
    """The CLI hands the loaded config (with its overrides) to the port's recipe."""
    import importlib

    from automodel_tpu_torch.cli import app

    got = {}
    monkeypatch.setattr(importlib.import_module(target), "main", lambda cfg: got.setdefault(
        "cfg", cfg))
    cfg_path = _yaml(tmp_path, PEFT)
    app.main([*command.split(), "-c", cfg_path, "--peft.dim", "4"])
    assert got["cfg"].get("peft.dim") == 4 and got["cfg"].get("device") == "cpu"


@pytest.mark.parametrize("argv,match", [
    (["kd", "llm"], "not ported"), (["finetune", "vlm"], "not ported"),
    (["generate", "llm"], "not ported"), (["train", "llm"], "unknown recipe"),
    (["finetune", "llm", "--slurm.nodes", "2"], "slurm")])
def test_cli_refuses_what_is_not_ported(argv, match, tmp_path):
    from automodel_tpu_torch.cli import app

    with pytest.raises(SystemExit, match=match):
        app.main([*argv, "-c", _yaml(tmp_path, PEFT)])


def test_moe_gate_bias_update_is_off_under_peft(tmp_path, caplog):
    """A DeepSeek-V3-family model with the loss-free gate-bias update (noaux_tc) under
    LoRA: the recipe warns as JAX's does and the frozen correction bias stays put; the
    routed experts and the router take no adapter."""
    import logging

    import yaml

    from tests.test_torch_deepseek_v3 import TINY

    cfg = yaml.safe_load(open(_yaml(tmp_path, PEFT, steps=2)))
    cfg["model"]["config"] = dict(TINY, topk_method="noaux_tc")
    path = tmp_path / "moe.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with caplog.at_level(logging.WARNING):
        recipe = train_ft.main(argv=["-c", str(path)])
    assert "moe gate-bias update disabled under peft" in caplog.text
    bias = recipe.params["moe_layers.moe.gate.score_correction_bias"]
    assert recipe.moe.gate_bias_update_factor > 0 and not bias.any()
    # the default targets adapt the shared experts' w_gate / w_up / w_down, not the
    # routed experts or the router
    assert not any(k.startswith(("moe_layers.moe.experts.", "moe_layers.moe.gate."))
                   for k in recipe.train_params)
    assert any(k.startswith("moe_layers.moe.shared_experts.") for k in recipe.train_params)
    assert len(_losses(tmp_path / "out" / "training.jsonl")) == 2
