"""The port's validation pass against the JAX package's (tests/unit/test_val_metrics.py):
on the same weights (built in JAX, carried across with params_from_jax) and the same
validation batches, the token-weighted mean loss (f64 sums on the host) agrees within
1e-5 (f32) for masked_ce and linear_ce; a pass leaves the loader's cursor where it
was, so every pass scores the same window; validation_max_batches bounds it; and the
loop writes validation.jsonl at val_every_steps and saves the best step."""

import json
import os
import textwrap

import jax
import pytest

from automodel_tpu.config.loader import load_config as jax_load_config
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JaxTrainFt)
from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.models.llama.convert import params_from_jax
from automodel_tpu_torch.recipes.llm import train_ft
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

YAML = """
seed: 5
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
backend:
  dtype: float32
  attention: xla
dataset:
  _target_: automodel_tpu.data.llm.mock.MockSFTDataset
  vocab_size: 128
  seq_len: 32
  num_samples: 64
  seed: 0
validation_dataset:
  _target_: automodel_tpu.data.llm.mock.MockSFTDataset
  vocab_size: 128
  seq_len: 32
  num_samples: 40
  seed: 1
validation_max_batches: 3
micro_batch_size: 8
seq_len: 32
step_scheduler:
  grad_acc_steps: 1
  max_steps: 2
  val_every_steps: 1
optimizer:
  lr: 1.0e-3
checkpoint:
  enabled: false
"""


MOE_MODEL = """    architectures: [Qwen3MoeForCausalLM]
    vocab_size: 128
    hidden_size: 64
    intermediate_size: 96
    moe_intermediate_size: 32
    num_hidden_layers: 2
    num_attention_heads: 4
    num_key_value_heads: 2
    head_dim: 16
    num_experts: 8
    num_experts_per_tok: 2
    norm_topk_prob: true
    router_aux_loss_coef: 0.01"""
LLAMA_MODEL = YAML[YAML.index("    architectures"):YAML.index("backend:") - 1]


@pytest.fixture
def cfg_path(tmp_path):
    p = tmp_path / "val.yaml"
    p.write_text(textwrap.dedent(YAML))
    return str(p)


def _capture(recipe):
    """Record (total, count) of each validation pass."""
    seen = []
    log = recipe._log_val_loss
    recipe._log_val_loss = lambda step, total, count, *a: (seen.append((total, count)),
                                                           log(step, total, count, *a))
    return seen


@pytest.mark.parametrize("loss,model", [("masked_ce", "llama"), ("linear_ce", "llama"),
                                        ("masked_ce", "qwen3_moe")])
def test_val_loss_matches_jax(tmp_path, loss, model):
    """The MoE case scores pure CE: validation adds no aux-loss term, as in JAX."""
    cfg_path = tmp_path / "val.yaml"
    cfg_path.write_text(YAML if model == "llama" else YAML.replace(LLAMA_MODEL, MOE_MODEL))
    cfg_path = str(cfg_path)
    jcfg = jax_load_config(cfg_path)
    jcfg.set_by_path("output_dir", str(tmp_path / "jax"))
    jcfg.set_by_path("loss.name", loss)
    jax_recipe = JaxTrainFt(jcfg)
    jax_recipe.setup()
    want = _capture(jax_recipe)
    jax_recipe._run_validation(0)
    port = train_ft.TrainFinetuneRecipeForNextTokenPrediction(parse_args_and_load_config(
        ["-c", cfg_path, "--output_dir", str(tmp_path / "port"), "--loss.name", loss]))
    port.setup()
    assert (port.moe is not None) == (model == "qwen3_moe")
    port.model.load_params(params_from_jax(jax.device_get(jax_recipe.params), port.model.config))
    got = _capture(port)
    cursor = port.val_dataloader.state_dict()
    batches = []
    step = port._eval_step
    port._eval_step = lambda b, n: (batches.append(b), step(b, n))[1]
    port._run_validation(0)
    port._run_validation(0)
    assert len(batches) == 6  # validation_max_batches a pass
    assert port.val_dataloader.state_dict() == cursor
    assert got[0] == got[1]  # the same window both times
    (total, count), (want_total, want_count) = got[0], want[0]
    assert count == want_count > 0
    assert total / count == pytest.approx(want_total / want_count, abs=1e-5)
    assert isinstance(total, float)  # summed on the host in f64


def test_loop_validates_and_saves_the_best(cfg_path, tmp_path):
    ckpt = tmp_path / "ck"
    recipe = train_ft.main(argv=["-c", cfg_path, "--output_dir", str(tmp_path / "run"),
                                 "--checkpoint.enabled", "true",
                                 "--checkpoint.checkpoint_dir", str(ckpt)])
    with open(tmp_path / "run" / "validation.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2] and all(r["val_loss"] > 0 for r in rows)
    best = min(rows, key=lambda r: r["val_loss"])["step"]
    assert recipe.checkpointer.best_step() == best
    assert os.readlink(ckpt / "best") == f"step_{best}"
    assert sorted(d for d in os.listdir(ckpt) if d.startswith("step_")) == ["step_1", "step_2"]
