"""The port's train_ft and benchmark recipes against the JAX package's on one tiny
YAML (whose dataset _target_ names automodel_tpu.data.llm.mock.MockSFTDataset),
with device: cpu and the same initial weights: per-step losses agree to 1e-4 (f32).
Also: linear_ce on a CUDA device raises, and so does a run with no device and no card."""

import json
import textwrap

import jax
import pytest
import torch

from automodel_tpu.config.loader import load_config as jax_load_config
from automodel_tpu.recipes.llm.benchmark import (
    BenchmarkingRecipeForNextTokenPrediction as JaxBenchmark)
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JaxTrainFt)
from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.models.llama.convert import params_from_jax
from automodel_tpu_torch.recipes.llm import benchmark, train_ft

YAML = """
seed: 7
device: cpu
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
    tie_word_embeddings: true
distributed:
  dp_shard: -1
backend:
  dtype: float32
  attention: flash
  remat_policy: mlp_attn_dots
  attention_segments: false
dataset:
  _target_: automodel_tpu.data.llm.mock.MockSFTDataset
  vocab_size: 128
  seq_len: 32
  num_samples: 256
  seed: 0
benchmark:
  warmup_steps: 1
  timed_steps: 2
micro_batch_size: 8
seq_len: 32
step_scheduler:
  grad_acc_steps: 2
  max_steps: 3
loss:
  name: masked_ce
optimizer:
  optimizer: adafactor_nomom
  lr: 1.0e-3
  max_grad_norm: 1.0
lr_scheduler:
  lr_warmup_steps: 1
checkpoint:
  enabled: false
"""


@pytest.fixture
def cfg_path(tmp_path):
    p = tmp_path / "tiny.yaml"
    p.write_text(textwrap.dedent(YAML))
    return str(p)


def _losses(path):
    with open(path) as f:
        return [r["loss"] for r in map(json.loads, f) if "loss" in r]


def _jax_recipe(cls, cfg_path, out_dir):
    cfg = jax_load_config(cfg_path)
    cfg.set_by_path("output_dir", str(out_dir))
    recipe = cls(cfg)
    recipe.setup()
    return recipe, jax.device_get(recipe.params)


def _port_recipe(cls, cfg_path, out_dir, jax_params):
    cfg = parse_args_and_load_config(["-c", cfg_path, "--output_dir", str(out_dir)])
    recipe = cls(cfg)
    recipe.setup()
    recipe.model.load_params(params_from_jax(jax_params, recipe.model.config))
    return recipe


def test_train_ft_losses_match_jax(cfg_path, tmp_path):
    jax_recipe, params = _jax_recipe(JaxTrainFt, cfg_path, tmp_path / "jax")
    jax_recipe.run_train_validation_loop()
    port = _port_recipe(train_ft.TrainFinetuneRecipeForNextTokenPrediction, cfg_path,
                        tmp_path / "port", params)
    port.run_train_validation_loop()
    want = _losses(tmp_path / "jax" / "training.jsonl")
    got = _losses(tmp_path / "port" / "training.jsonl")
    assert len(got) == len(want) == 3
    assert got == pytest.approx(want, abs=1e-4)


def test_benchmark_losses_match_jax(cfg_path, tmp_path):
    jax_recipe, params = _jax_recipe(JaxBenchmark, cfg_path, tmp_path / "jax")
    want = jax_recipe.run_benchmark()
    port = _port_recipe(benchmark.BenchmarkingRecipeForNextTokenPrediction, cfg_path,
                        tmp_path / "port", params)
    got = port.run_benchmark()
    assert len(got["losses"]) == 3
    assert got["loss"] == pytest.approx(want["loss"], abs=1e-4)
    assert got["device_kind"] == "cpu" and got["mfu"] is None
    with open(tmp_path / "port" / "benchmark.json") as f:
        assert json.load(f)["loss"] == got["loss"]


def test_benchmark_entry_point(cfg_path, tmp_path, capsys):
    """The CLI entry point, with a profiler window over the second timed step."""
    prof = tmp_path / "prof"
    result = benchmark.main(argv=["-c", cfg_path, "--output_dir", str(tmp_path / "run"),
                                  "--benchmark.profile_start", "1",
                                  "--benchmark.profile_dir", str(prof)])
    assert len(result["losses"]) == 3
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["loss"] == result["loss"]
    with open(prof / "summary.json") as f:
        summary = json.load(f)
    assert summary["steps"] == 1 and summary["device_busy_s"] == 0.0  # no card here
    assert (prof / "trace.json").exists() and (prof / "kernels.txt").exists()
    with pytest.raises(ValueError, match="max_steps"):
        benchmark.main(argv=["-c", cfg_path, "--output_dir", str(tmp_path / "short"),
                             "--benchmark.timed_steps", "5"])


def _setup(cfg_path, *overrides):
    cfg = parse_args_and_load_config(["-c", cfg_path, *overrides])
    train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()


def test_linear_ce_on_cuda_raises(cfg_path, monkeypatch):
    """Asked for on the card, linear_ce raises before anything is built; it never
    turns into masked_ce. The same holds for the default it gets at vocab >= 65536."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="linear_ce"):
        _setup(cfg_path, "--device", "cuda", "--loss.name", "linear_ce")
    cfg = parse_args_and_load_config(["-c", cfg_path, "--device", "cuda",
                                      "--model.config.vocab_size", "65536"])
    del cfg._data["loss"]
    with pytest.raises(NotImplementedError, match="linear_ce"):
        train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()


def test_no_device_and_no_card_raises(cfg_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = parse_args_and_load_config(["-c", cfg_path])
    del cfg._data["device"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()


@pytest.mark.parametrize("override", [
    ["--distributed.tp", "2"],
    ["--distributed.dp_shard", "2"],
    ["--peft.dim", "8"],
    ["--checkpoint.enabled", "true"],
    ["--validation_dataset.seq_len", "8"],
    ["--packed_sequence.packed_sequence_size", "64"],
    ["--optimizer.optimizer", "sgd"],
], ids=["tp", "dp_shard", "peft", "checkpoint", "validation", "packing", "optimizer"])
def test_unported_options_raise(cfg_path, override):
    with pytest.raises(NotImplementedError):
        _setup(cfg_path, *override)


def test_linear_ce_plain_version_on_cpu(cfg_path, tmp_path):
    """On the CPU linear_ce runs its plain version and equals masked_ce's loss."""
    losses = {}
    for name in ("masked_ce", "linear_ce"):
        cfg = parse_args_and_load_config(["-c", cfg_path, "--loss.name", name,
                                          "--output_dir", str(tmp_path / name),
                                          "--step_scheduler.max_steps", "1"])
        r = train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg)
        r.setup()
        r.run_train_validation_loop()
        losses[name] = _losses(tmp_path / name / "training.jsonl")
    assert losses["linear_ce"] == pytest.approx(losses["masked_ce"], abs=1e-5)


def test_log_cadence(cfg_path, tmp_path):
    cfg = parse_args_and_load_config(["-c", cfg_path, "--output_dir", str(tmp_path),
                                      "--step_scheduler.log_every_steps", "2"])
    recipe = train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg)
    recipe.setup()
    recipe.run_train_validation_loop()
    with open(tmp_path / "training.jsonl") as f:
        steps = [r["step"] for r in map(json.loads, f) if "step" in r]
    assert steps == [2]
