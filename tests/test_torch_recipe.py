"""The port's train_ft and benchmark recipes against the JAX package's on one tiny
YAML (whose dataset _target_ names automodel_tpu.data.llm.mock.MockSFTDataset),
with device: cpu and the same initial weights: per-step losses agree to 1e-4 (f32).
Also: linear_ce on a CUDA device raises, and so does a run with no device and no card."""

import json
import os
import textwrap

import jax
import numpy as np
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
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples",
                        "llm_finetune")

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


_GMM_ARGS = "(CUtensorMap_st, CUtensorMap_st, int const*, __nv_bfloat16*, int, int, int, int)"
_LCE_ARGS = "(CUtensorMap_st, CUtensorMap_st, int, int, int, int)"


@pytest.mark.parametrize("name,cls", [
    (f"void (anonymous namespace)::gmm_sm90_kernel<false>{_GMM_ARGS}", "grouped_gemm_kernels"),
    (f"void (anonymous namespace)::gmm_sm90_kernel<true>{_GMM_ARGS}", "grouped_gemm_kernels"),
    ("void (anonymous namespace)::gmm_kernel<true>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
     "int const*, __nv_bfloat16*, int, int, int, int)", "grouped_gemm_kernels"),
    ("void (anonymous namespace)::tgmm_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, "
     "int const*, __nv_bfloat16*, int, int, int)", "grouped_gemm_kernels"),
    ("void (anonymous namespace)::tgmm_sm90_kernel(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, int const*, int, int, int, int)", "grouped_gemm_kernels"),
    ("void (anonymous namespace)::lce_sm90_kernel<false, true, (anonymous namespace)::"
     f"FwdEpi>{_LCE_ARGS}", "linear_ce_kernels"),
    ("void (anonymous namespace)::lce_sm90_kernel<false, true, (anonymous namespace)::"
     f"DLogitsEpi>{_LCE_ARGS}", "linear_ce_kernels"),
    ("void (anonymous namespace)::lce_sm90_kernel<false, false, (anonymous namespace)::"
     f"DhEpi>{_LCE_ARGS}", "linear_ce_kernels"),
    ("void (anonymous namespace)::lce_sm90_kernel<true, true, (anonymous namespace)::"
     f"DwEpi>{_LCE_ARGS}", "linear_ce_kernels"),
    ("void (anonymous namespace)::lce_fwd_kernel<false>(__nv_bfloat16 const*)", "linear_ce_kernels"),
    ("void (anonymous namespace)::flash_fwd_kernel<64>(CUtensorMap_st)", "flash_kernels"),
    ("void (anonymous namespace)::ring_bwd_kernel<128>(float*)", "ring_kernels"),
    ("void (anonymous namespace)::flash_dq_kernel<128>(CUtensorMap_st)", "flash_kernels"),
    ("void (anonymous namespace)::flash_dkv_kernel<64>(CUtensorMap_st)", "flash_kernels"),
    ("void (anonymous namespace)::ring_dq_kernel<64>(float*)", "ring_kernels"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "elementwise_other"),
])
def test_profiler_classes_each_port_kernel(name, cls):
    """The profile summary's classes take each port kernel by its demangled name, the
    wgmma-route ones (gmm_sm90_kernel, lce_sm90_kernel) included."""
    assert benchmark._kernel_class(name) == cls


def _setup(cfg_path, *overrides):
    cfg = parse_args_and_load_config(["-c", cfg_path, *overrides])
    train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()


def test_linear_ce_on_cuda_raises(cfg_path, monkeypatch):
    """On the card the recipe's linear_ce goes to the kernels: the default at vocab >=
    65536 picks it, loss.impl and loss.filter_eps are read, an unknown impl raises
    before anything is built, and a non-CPU tensor reaches the kernel checks (which
    raise on a meta tensor) instead of turning into masked_ce or the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="loss.impl"):
        _setup(cfg_path, "--device", "cuda", "--loss.impl", "cuda")
    cfg = parse_args_and_load_config(["-c", cfg_path, "--model.config.vocab_size", "65536",
                                      "--model.config.hidden_size", "128",
                                      "--dataset.vocab_size", "65536",
                                      "--loss.filter_eps", "1e-5",
                                      "--step_scheduler.max_steps", "1"])
    del cfg.loss._data["name"]
    recipe = train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg)
    recipe.setup()
    assert (recipe.loss_name, recipe.loss_impl, recipe.loss_filter_eps) == (
        "linear_ce", "auto", 1e-5)
    class MetaModel:  # the decoder's output on a non-CPU device
        config = recipe.model.config

        def __call__(self, *args, **kwargs):
            return torch.empty(8, 32, 128, dtype=torch.bfloat16, device="meta")

    recipe.model = MetaModel()
    recipe.params = {"embed": torch.empty(65536, 128, device="meta")}
    batch = {k: torch.zeros(8, 32, dtype=torch.long, device="meta")
             for k in ("input_ids", "positions", "segment_ids", "labels")}
    with pytest.raises(ValueError, match="not a CUDA device"):
        recipe._forward_loss(batch, 8)


def test_no_device_and_no_card_raises(cfg_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = parse_args_and_load_config(["-c", cfg_path])
    del cfg._data["device"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()


@pytest.mark.parametrize("override", [
    ["--distributed.tp", "2"],
    ["--distributed.dp_shard", "2"],
    ["--peft.dim", "8", "--distributed.pp", "2"],
    ["--checkpoint.enabled", "true", "--checkpoint.async_save", "true"],
    # a streaming (unsized) validation set: itertools.count stands in for one
    ["--validation_dataset._target_", "itertools.count"],
    ["--model.pretrained_model_name_or_path", "meta-llama/Llama-3.2-1B"],
    ["--optimizer.optimizer", "sgd"],
], ids=["tp", "dp_shard", "peft", "checkpoint", "validation", "hub_id", "optimizer"])
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


SEQ4096 = "examples/benchmark/llama3_2_1b_seq4096.yaml"
# the seq-4096 config cut to a CPU size; its loss, untied head and missing checkpoint
# section (checkpoint.enabled defaults to true) stay as they are
SEQ4096_TINY = ["--device", "cpu", "--model.config.hidden_size", "128",
                "--model.config.intermediate_size", "256",
                "--model.config.num_hidden_layers", "2", "--model.config.vocab_size", "512",
                "--dataset.vocab_size", "512", "--dataset.seq_len", "64", "--seq_len", "64",
                "--dataset.num_samples", "16", "--micro_batch_size", "2",
                "--step_scheduler.max_steps", "3", "--benchmark.warmup_steps", "1",
                "--benchmark.timed_steps", "2"]


def test_benchmark_accepts_the_seq4096_config(tmp_path):
    """The benchmark recipe never saves, so it takes checkpoint.enabled (the default
    true of a config with no checkpoint section) and builds no checkpointer; train_ft
    takes it and checkpoints."""
    argv = ["-c", SEQ4096, *SEQ4096_TINY, "--output_dir", str(tmp_path),
            "--checkpoint.checkpoint_dir", str(tmp_path / "ckpts")]
    cfg = parse_args_and_load_config(argv)
    assert cfg.get("checkpoint.enabled") is None and cfg.loss.name == "linear_ce"
    assert train_ft._unsupported(cfg) == []
    recipe = benchmark.BenchmarkingRecipeForNextTokenPrediction(cfg)
    recipe.setup()
    assert "lm_head" in recipe.params and recipe.loss_name == "linear_ce"
    assert recipe.checkpointer is None
    result = recipe.run_benchmark()
    assert len(result["losses"]) == 3
    assert not (tmp_path / "ckpts").exists()
    ft = train_ft.TrainFinetuneRecipeForNextTokenPrediction(parse_args_and_load_config(argv))
    ft.setup()
    assert ft.checkpointer.config.enabled


def test_seq4096_untied_head_through_params_from_jax():
    """The seq-4096 config's untied lm_head crosses from JAX by name and value."""
    from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
    from automodel_tpu.models.llama.model import LlamaForCausalLM as JaxLlama
    from automodel_tpu_torch.models.llama.model import LlamaConfig

    cfg = parse_args_and_load_config(["-c", SEQ4096, *SEQ4096_TINY])
    hf = cfg.model.config.to_dict()
    params = jax.device_get(JaxLlama.from_config(hf, JaxBackend(dtype="float32")).init(
        jax.random.key(0)))
    flat = params_from_jax(params, LlamaConfig.from_hf(hf))
    assert flat["lm_head"].shape == (128, 512)
    np.testing.assert_array_equal(flat["lm_head"].numpy(), np.asarray(params["lm_head"]))
    assert not np.array_equal(flat["lm_head"].numpy(), flat["embed"].numpy().T)


def test_packed_default_linear_ce_matches_jax(cfg_path, tmp_path):
    """vocab 65536 with no loss.name: both recipes pick linear_ce, pack documents of 20
    tokens into rows of 64 (three a row, with padding and segment ids), and take the
    same 3-step loss trajectory (f32, 1e-4). One layer and one microbatch a step; the JAX
    side replicates over its 8 CPU devices instead of sharding (the port has one device,
    the losses are the same), which halves its steps: no gathers of the sharded
    65536-row embedding."""
    over = ["--model.config.vocab_size", "65536", "--dataset.vocab_size", "65536",
            "--model.config.hidden_size", "128", "--model.config.intermediate_size", "256",
            "--dataset.seq_len", "20", "--packed_sequence.packed_sequence_size", "64",
            "--model.config.num_hidden_layers", "1", "--step_scheduler.grad_acc_steps", "1",
            "--backend.attention_segments", "true", "--optimizer.optimizer", "adamw"]
    jcfg = jax_load_config(cfg_path)
    for key, val in zip(over[::2], over[1::2]):
        jcfg.set_by_path(key[2:], {"true": True}.get(val, int(val) if val.isdigit() else val))
    jcfg.set_by_path("output_dir", str(tmp_path / "jax"))
    jcfg.set_by_path("distributed.dp_shard", 1)
    jcfg.set_by_path("distributed.dp_replicate", 8)
    del jcfg._data["loss"]
    jr = JaxTrainFt(jcfg)
    jr.setup()
    params = jax.device_get(jr.params)
    jr.run_train_validation_loop()
    cfg = parse_args_and_load_config(["-c", cfg_path, *over,
                                      "--output_dir", str(tmp_path / "port")])
    del cfg._data["loss"]
    port = train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg)
    port.setup()
    assert port.loss_name == jr.loss_name == "linear_ce" and port.seq_len == 64
    port.model.load_params(params_from_jax(params, port.model.config))
    port.run_train_validation_loop()
    want = _losses(tmp_path / "jax" / "training.jsonl")
    got = _losses(tmp_path / "port" / "training.jsonl")
    assert len(got) == len(want) == 3
    assert got == pytest.approx(want, abs=1e-4)
    with pytest.raises(ValueError, match="segment"):
        _setup(cfg_path, *over[:-4], "--backend.attention_segments", "false")


MOE_YAML = YAML.replace("""    architectures: [LlamaForCausalLM]
    vocab_size: 128
    hidden_size: 64
    intermediate_size: 128
    num_hidden_layers: 2
    num_attention_heads: 4
    num_key_value_heads: 2
    tie_word_embeddings: true""", """    architectures: [Qwen3MoeForCausalLM]
    vocab_size: 128
    hidden_size: 64
    intermediate_size: 96
    moe_intermediate_size: 32
    num_hidden_layers: 1
    num_attention_heads: 4
    num_key_value_heads: 2
    head_dim: 16
    num_experts: 4
    num_experts_per_tok: 2
    norm_topk_prob: true
    router_aux_loss_coef: 0.01""").replace("""  remat_policy: mlp_attn_dots
  attention_segments: false""", """  remat_policy: mlp_dots
  attention_segments: false
  experts_backend: pallas""").replace("""  optimizer: adafactor_nomom""", """  optimizer: adamw_lowmem""").replace(
    "seq_len: 32", "seq_len: 16")


@pytest.fixture
def moe_cfg_path(tmp_path):
    p = tmp_path / "tiny_moe.yaml"
    p.write_text(textwrap.dedent(MOE_YAML))
    return str(p)


def _moe_rows(path):
    with open(path) as f:
        return [{k: v for k, v in r.items() if k.startswith("moe_load/")}
                for r in map(json.loads, f) if "loss" in r]


def test_moe_train_ft_matches_jax(moe_cfg_path, tmp_path):
    """A tiny Qwen3-MoE (1 layer, 4 experts, top-2, aux loss 0.01, adamw_lowmem, the
    pallas experts backend, rows of 16) through both train_ft recipes: the same 3-step
    losses (f32, 1e-4) with the aux-loss term, and the same moe_load/* rows."""
    jax_recipe, params = _jax_recipe(JaxTrainFt, moe_cfg_path, tmp_path / "jax")
    jax_recipe.run_train_validation_loop()
    port = _port_recipe(train_ft.TrainFinetuneRecipeForNextTokenPrediction, moe_cfg_path,
                        tmp_path / "port", params)
    assert type(port.model).__name__ == "Qwen3MoeForCausalLM"
    assert port.moe_metrics_mode == "brief"
    port.run_train_validation_loop()
    want = _losses(tmp_path / "jax" / "training.jsonl")
    got = _losses(tmp_path / "port" / "training.jsonl")
    assert len(got) == len(want) == 3
    assert got == pytest.approx(want, abs=1e-4)
    got_rows = _moe_rows(tmp_path / "port" / "training.jsonl")
    want_rows = _moe_rows(tmp_path / "jax" / "training.jsonl")
    assert got_rows[0] and [sorted(r) for r in got_rows] == [sorted(r) for r in want_rows]
    for g, w in zip(got_rows, want_rows):
        assert g == pytest.approx(w, abs=1e-6)


def test_moe_benchmark_matches_jax(moe_cfg_path, tmp_path):
    jax_recipe, params = _jax_recipe(JaxBenchmark, moe_cfg_path, tmp_path / "jax")
    want = jax_recipe.run_benchmark()
    port = _port_recipe(benchmark.BenchmarkingRecipeForNextTokenPrediction, moe_cfg_path,
                        tmp_path / "port", params)
    got = port.run_benchmark()
    assert len(got["losses"]) == 3
    assert got["loss"] == pytest.approx(want["loss"], abs=1e-4)


def test_moe_fake_balanced_gate_trains(moe_cfg_path, tmp_path):
    """Round-robin routing leaves the router out of the loss: its gradient is zero, as
    jax.grad gives it, and the step runs (weight decay off, so the router stays put)."""
    cfg = parse_args_and_load_config(["-c", moe_cfg_path, "--output_dir", str(tmp_path),
                                      "--backend.fake_balanced_gate", "true",
                                      "--step_scheduler.max_steps", "1"])
    recipe = train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg)
    recipe.setup()
    router = recipe.params["moe_layers.moe.gate.weight"]
    before = router.detach().clone()
    recipe.run_train_validation_loop()
    assert torch.equal(router.detach(), before)
    assert len(_losses(tmp_path / "training.jsonl")) == 1


@pytest.mark.parametrize("override", [
    ["--backend.dispatcher", "a2a"],
    ["--distributed.ep", "2"],
    ["--backend.fake_balanced_gate", "true", "--backend.fake_gate_noise", "0.1"],
], ids=["a2a", "ep", "gate_noise"])
def test_unported_moe_options_raise(moe_cfg_path, override):
    with pytest.raises(NotImplementedError):
        _setup(moe_cfg_path, *override)


@pytest.mark.parametrize("recipe_cls", [train_ft.TrainFinetuneRecipeForNextTokenPrediction,
                                        benchmark.BenchmarkingRecipeForNextTokenPrediction],
                         ids=["train_ft", "benchmark"])
def test_fp8_linear_is_refused_by_name(cfg_path, recipe_cls):
    """backend.linear fp8 (JAX's fp8 projections) is listed among the unported options
    with NotImplementedError, not refused by BackendConfig with a TypeError."""
    cfg = parse_args_and_load_config(["-c", cfg_path, "--backend.linear", "fp8"])
    with pytest.raises(NotImplementedError, match="backend.linear fp8"):
        recipe_cls(cfg).setup()


@pytest.mark.parametrize("name", ["llama3_2_1b_fp8.yaml", "llama3_8b_fp8_linears.yaml"])
def test_fp8_example_configs_name_backend_linear(name):
    cfg = parse_args_and_load_config([
        "-c", os.path.join(EXAMPLES, name), "--device", "cpu",
        "--checkpoint.enabled", "false"])
    with pytest.raises(NotImplementedError, match="backend.linear fp8"):
        train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()


def test_default_linear_and_capacity_factor_are_accepted(cfg_path):
    cfg = parse_args_and_load_config(["-c", cfg_path, "--backend.linear", "default",
                                      "--backend.ep_capacity_factor", "2.0"])
    recipe = benchmark.BenchmarkingRecipeForNextTokenPrediction(cfg)
    recipe.setup()
    assert (recipe.backend.linear, recipe.backend.ep_capacity_factor) == ("default", 2.0)


def test_unknown_linear_raises_value_error(cfg_path):
    with pytest.raises(ValueError, match="unknown linear backend"):
        _setup(cfg_path, "--backend.linear", "int4")
