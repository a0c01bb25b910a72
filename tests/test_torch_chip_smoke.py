"""What of chip_smoke.py runs without a card: the loss it holds the main paths to, its
table of expected kernel launches, and the derived long-context CP config (main paths
7 and 8) through the recipes on the CPU at small widths."""

import math
import os

import numpy as np
import pytest
import torch

import chip_smoke
from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.llama.model import LlamaForCausalLM
from automodel_tpu_torch.ops.losses import masked_cross_entropy
from automodel_tpu_torch.recipes.llm import benchmark, train_ft


@pytest.mark.parametrize("hidden", [2048, 4096])
def test_random_init_loss_matches_the_model(hidden):
    """A Llama at the init scale (std 0.02) on random tokens has the loss chip_smoke
    expects; at hidden 4096 it sits 0.82 over ln(vocab), outside the 0.5 that the main
    paths allow around the expectation, so a check centred on ln(vocab) would refuse a
    correct Llama-3-8B run."""
    vocab, heads = 1000, hidden // 128
    hf = {"vocab_size": vocab, "hidden_size": hidden, "intermediate_size": 256,
          "num_hidden_layers": 1, "num_attention_heads": heads, "num_key_value_heads": 8,
          "head_dim": 128, "initializer_range": 0.02}
    model = LlamaForCausalLM.from_config(hf, BackendConfig(dtype="float32", remat_policy="full"),
                                         device="cpu",
                                         generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    ids = torch.tensor(rng.randint(0, vocab, (4, 64)))
    labels = torch.tensor(rng.randint(0, vocab, (4, 64)))
    with torch.no_grad():
        loss = masked_cross_entropy(model(ids), labels).item()
    want = chip_smoke.random_init_loss(vocab, hidden, 0.02)
    assert abs(loss - want) < 0.1
    assert want - math.log(vocab) == pytest.approx(hidden * 0.02**2 / 2)
    if hidden == 4096:
        assert loss - math.log(vocab) > 0.5


def test_expected_launches_of_the_ring_paths():
    want = chip_smoke._expected(4, 1, 7, True, ring_cp=8)
    assert (want["ring_fwd"], want["ring_bwd"], want["flash_fwd"], want["flash_bwd"]) == (
        448, 224, 0, 0)
    assert chip_smoke._expected(4, 1, 7, True)["ring_fwd"] == 0


SMALL = ["--model.config.hidden_size", "64", "--model.config.intermediate_size", "128",
         "--model.config.num_attention_heads", "4", "--model.config.num_key_value_heads", "2",
         "--model.config.head_dim", "16", "--model.config.vocab_size", "512",
         "--dataset.vocab_size", "512", "--dataset.seq_len", "256", "--seq_len", "256",
         "--device", "cpu"]


def test_cp_config_runs_through_both_recipes(tmp_path):
    """Main paths 7 and 8 at small widths: the CP config with its dataset replaced folds
    cp 8 onto one device and trains with ring attention in both recipes."""
    path = chip_smoke.cp_config(str(tmp_path))
    cfg = parse_args_and_load_config(["-c", path, *chip_smoke.llama3_8b_args(), *SMALL])
    assert cfg.backend.context_parallel == "ring" and cfg.distributed.cp == 8
    assert cfg.model.pretrained_model_name_or_path is None
    result = benchmark.main(argv=["-c", path, *chip_smoke.llama3_8b_args(), *SMALL,
                                  "--benchmark.warmup_steps", "1", "--benchmark.timed_steps",
                                  "1", "--output_dir", str(tmp_path / "bench")])
    assert len(result["losses"]) == 2 and all(map(math.isfinite, result["losses"]))

    cfg = parse_args_and_load_config([
        "-c", path, *chip_smoke.llama3_8b_args(chip_smoke.CP_LAYERS_TRAIN_FT), *SMALL,
        "--packed_sequence.packed_sequence_size", "256", "--dataset.seq_len", "32",
        "--step_scheduler.max_steps", "2", "--checkpoint.enabled", "false",
        "--output_dir", str(tmp_path / "ft")])
    recipe = train_ft.main(cfg=cfg)
    assert recipe.mesh.folded and recipe.mesh.cp == 8
    assert os.path.exists(tmp_path / "ft" / "training.jsonl")


@pytest.mark.parametrize("d,kh", [(64, 8), (128, 4)])
def test_flash_timing_inputs_have_the_named_head_dim(d, kh):
    """The flash timing rows build their tensors at the head dim and kv heads they name,
    and the bound's work is read from those tensors: at D=128 the causal forward of
    B=4, S=2048, H=32 is 137.5 GFLOP, twice D=64's."""
    (q, k, v, do), work = chip_smoke._flash_timing_inputs(torch, 1, 64, 4, kh // 4, d,
                                                          device="cpu")
    assert q.shape == do.shape == (1, 64, 4, d) and k.shape == v.shape == (1, 64, kh // 4, d)
    assert work["flash_fwd"][0] == 4 * d * 4 * 64 * 65 // 2
    b, s, h = 4, 2048, 32
    full = [torch.empty(b, s, n, d, dtype=torch.bfloat16, device="meta") for n in (h, kh, kh)]
    work = chip_smoke._flash_work(*full)
    pairs = b * h * s * (s + 1) // 2
    assert work["flash_fwd"][0] == 4 * d * pairs and work["flash_bwd"][0] == 10 * d * pairs
    assert work["flash_fwd"][0] == pytest.approx(137.5e9 * d / 128, rel=1e-3)
    qkv = 2 * b * s * d * (h + 2 * kh)
    assert work["flash_fwd"][1] == qkv + 2 * b * s * h * d + 4 * b * h * s
    assert work["flash_bwd"][1] == 2 * qkv + 4 * b * s * h * d + 4 * b * h * s


def test_ptxas_report_keeps_registers_spills_and_wgmma_serialisation():
    log = "\n".join([
        "ptxas info    : (C7514) Potential Performance Loss: wgmma.mma_async instructions are "
        "serialized due to ... in the function '_ZN4_GLOBAL16flash_fwd_kernelILi64EEEv'",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL16flash_fwd_kernelILi64EEEv' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers"])
    report = chip_smoke._ptxas_report(log)
    assert report[0].startswith("ptxas info    : (C7514)")
    assert report[1:] == [
        "flash_fwd_kernel<64>: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "flash_fwd_kernel<64>: Used 168 registers, used 16 barriers"]
