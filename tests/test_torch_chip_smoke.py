"""What of chip_smoke.py runs without a card: the loss it holds the main paths to, its
table of expected kernel launches (validation's included), the derived long-context CP
config (main paths 7 and 8) through the recipes on the CPU at small widths, and main
path 9's helpers: the stub tokenizer, the HellaSwag rows, the derived BASELINE config,
and the path itself at small widths."""

import json
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


@pytest.mark.parametrize("step", [0, 1, 3])
def test_ring_step_inputs_hand_shard_r_the_ids_of_shard_r_minus_t(step):
    """The ring timing rows' inputs at ring step t: shard r holds the k, v and positions
    of shard (r - t) mod cp, and the launch's allowed pairs and live shards are those of
    a causal ring over contiguous shards at that step."""
    cp, b, s_loc, h, kh, d = 4, 2, 8, 4, 2, 16
    x = chip_smoke._ring_step_inputs(torch, step, cp, b, s_loc, h, kh, d, device="cpu")
    base = chip_smoke._ring_step_inputs(torch, 0, cp, b, s_loc, h, kh, d, device="cpu")
    assert torch.equal(x["q"], base["q"]) and torch.equal(x["pos_q"], base["pos_q"])
    for row in range(b):
        for r in range(cp):
            src = row * cp + (r - step) % cp
            dst = row * cp + r
            assert torch.equal(x["pos_kv"][dst], base["pos_q"][src])
            assert torch.equal(x["pos_kv"][dst],
                               torch.arange(s_loc, dtype=torch.int32) + (src % cp) * s_loc)
            for name in ("k", "v"):
                assert torch.equal(x[name].view(b * cp, kh, s_loc, d)[dst],
                                   base[name].view(b * cp, kh, s_loc, d)[src])
    if step == 0:
        assert x["pairs"] == b * cp * h * s_loc * (s_loc + 1) // 2 and x["live"] == b * cp
    else:  # shards r >= t see a chunk wholly in their past, the others one in their future
        assert x["pairs"] == b * (cp - step) * h * s_loc**2 and x["live"] == b * (cp - step)
    work = chip_smoke._ring_work(x, h, kh, d)
    assert work["ring_fwd"][0] == 4 * d * x["pairs"] and work["ring_bwd"][0] == 10 * d * x["pairs"]


def test_ring_work_at_case_a():
    """The bounds of the ring timing rows at case (a) (cp 8, S_local 4096, H 32, KH 8,
    D 128): the diagonal step allows half of each shard's pairs, 1.10 TFLOP forward
    (1.112 ms at the card's bf16 peak) and 2.75 backward (2.780 ms); step 1 allows 7
    whole chunks, step 7 one."""
    a = chip_smoke.RING_A
    cp, s_loc, h, kh, d = a["cp"], a["s_loc"], a["h"], a["kh"], a["d"]
    q = torch.empty(cp * h, s_loc, d, device="meta")
    bound = {}
    for step, pairs, live in ((0, cp * h * s_loc * (s_loc + 1) // 2, cp),
                              (1, (cp - 1) * h * s_loc**2, cp - 1), (7, h * s_loc**2, 1)):
        work = chip_smoke._ring_work({"q": q, "pairs": pairs, "live": live}, h, kh, d)
        bound[step] = {n: max(fl / chip_smoke.PEAK_FLOPS, by / chip_smoke.PEAK_BYTES) * 1e3
                       for n, (fl, by) in work.items()}
        assert all(fl / chip_smoke.PEAK_FLOPS > by / chip_smoke.PEAK_BYTES
                   for fl, by in work.values())
    assert bound[0]["ring_fwd"] == pytest.approx(1.112, abs=1e-3)
    assert bound[0]["ring_bwd"] == pytest.approx(2.780, abs=1e-3)
    assert bound[7]["ring_fwd"] / bound[1]["ring_fwd"] == pytest.approx(1 / 7)


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


def test_gmm_timing_work_counts():
    """The grouped GEMM rows' bounds: 2 N D F FLOPs for the forward, dX and dW alike;
    bytes count each input once (only the weights of experts with rows) and each
    output once. At the slice's gate_up shape that is 412.3 GFLOP (0.417 ms)."""
    n, d, f, e, live = 65536, 2048, 1536, 128, 120
    work = chip_smoke._gmm_work(n, d, f, e, live)
    flops = 2 * n * d * f
    assert work["forward"][0] == work["dX"][0] == work["tgmm"][0] == flops
    assert flops / chip_smoke.PEAK_FLOPS * 1e3 == pytest.approx(0.417, abs=1e-3)
    assert work["forward"][1] == 2 * (n * d + live * d * f + n * f) + 4 * e
    assert work["dX"][1] == 2 * (n * f + live * d * f + n * d) + 4 * e  # dout in, dX out
    assert work["tgmm"][1] == 2 * (n * d + n * f + e * d * f) + 4 * e  # every dW written
    # every gmm timing lands in the kernels line: case a's forward is the row itself
    keys = chip_smoke._GMM_ROW_KEYS
    assert {p for p, _ in keys} == {"forward", "dX", "tgmm"} and {c for _, c in keys} == {"a", "b"}
    assert keys["forward", "a"] is None and keys["tgmm", "a"] is None
    assert len({v for v in keys.values() if v}) == 3


def test_lce_bwd_work_at_path7_shape():
    """lce_bwd's bound at main path 7's shape (N=32768, E=4096, V=128,256): 6NEV =
    103.3 TFLOP, 104.4 ms at the card's bf16 peak, bound by operations."""
    n, e, v = 32768, 4096, 128256
    flops, nbytes = chip_smoke._lce_work(n, e, v)
    assert flops == 6 * n * e * v and nbytes == 4 * (n * e + e * v) + 8 * n
    assert flops / chip_smoke.PEAK_FLOPS * 1e3 == pytest.approx(104.43, abs=0.01)
    assert flops / chip_smoke.PEAK_FLOPS > nbytes / chip_smoke.PEAK_BYTES


def test_flash_bound_at_the_long_shape():
    """The bound chip_smoke prints for flash at (L) (B=1, S=32768, H=32, KH=8, D=128,
    causal), from the same work count as the timed rows: 8.80 TFLOP forward, 22.0
    backward."""
    b, s, h, kh, d = 1, 32768, 32, 8, 128
    q = torch.empty(b, s, h, d, dtype=torch.bfloat16, device="meta")
    k = v = torch.empty(b, s, kh, d, dtype=torch.bfloat16, device="meta")
    work = chip_smoke._flash_work(q, k, v)
    assert work["flash_fwd"][0] == pytest.approx(8.80e12, rel=1e-3)
    assert work["flash_bwd"][0] == pytest.approx(22.0e12, rel=1e-3)
    bound = {name: max(fl / chip_smoke.PEAK_FLOPS, by / chip_smoke.PEAK_BYTES) * 1e3
             for name, (fl, by) in work.items()}
    assert bound["flash_fwd"] == pytest.approx(8.90, abs=0.01)
    assert bound["flash_bwd"] == pytest.approx(22.24, abs=0.01)


def test_main_paths_refuse_a_launch_off_the_wgmma_route():
    """Every gmm and lce_bwd launch of a main path must be on the wgmma route: the
    route counts are reset with the launch counts, and one mma_sync launch fails the
    path."""
    from automodel_tpu_torch.ops import grouped_gemm as gg, linear_ce as lce

    chip_smoke._reset_counts()
    assert set(chip_smoke._read_routes().values()) == {0}
    launches = {"gmm": 2, "lce_bwd": 1}
    gg.ROUTE_LAUNCHES["gmm/wgmma"] = 2
    lce.ROUTE_LAUNCHES["lce_bwd/wgmma"] = 1
    out = chip_smoke._check_routes("path", launches)
    assert out["gmm/wgmma"] == 2 and out["lce_bwd/mma_sync"] == 0 and out["gmm"] == 2
    gg.ROUTE_LAUNCHES["gmm/wgmma"], gg.ROUTE_LAUNCHES["gmm/mma_sync"] = 1, 1
    with pytest.raises(AssertionError, match="wgmma route"):
        chip_smoke._check_routes("path", launches)
    chip_smoke._reset_counts()


@pytest.mark.parametrize("kernel", ["tgmm", "lce_fwd"])
def test_main_paths_refuse_a_tgmm_or_lce_fwd_launch_off_the_wgmma_route(kernel):
    """tgmm and lce_fwd are held to the wgmma route on a main path as gmm and lce_bwd
    are: a path whose launches all took it passes, one mma_sync launch fails it."""
    from automodel_tpu_torch.ops import grouped_gemm as gg, linear_ce as lce

    routes = gg.ROUTE_LAUNCHES if kernel == "tgmm" else lce.ROUTE_LAUNCHES
    chip_smoke._reset_counts()
    assert set(chip_smoke._read_routes()) >= {f"{kernel}/wgmma", f"{kernel}/mma_sync"}
    launches = {"gmm": 0, "tgmm": 0, "lce_fwd": 0, "lce_bwd": 0, kernel: 8}
    routes[f"{kernel}/wgmma"] = 8
    out = chip_smoke._check_routes("path", launches)
    assert out[f"{kernel}/wgmma"] == 8 and out[f"{kernel}/mma_sync"] == 0
    routes[f"{kernel}/wgmma"], routes[f"{kernel}/mma_sync"] = 7, 1
    try:
        with pytest.raises(AssertionError, match=f"{kernel} launches, 7 of them"):
            chip_smoke._check_routes("path", launches)
    finally:
        chip_smoke._reset_counts()


def test_lce_fwd_work_at_path7_shape():
    """lce_fwd's bound at main path 7's shape (N=32768, E=4096, V=128,256): 2NEV =
    34.4 TFLOP, 34.8 ms at the card's bf16 peak, bound by operations; its bytes are h,
    w, z and bmax once each."""
    n, e, v = 32768, 4096, 128256
    nbytes = chip_smoke._lce_fwd_bytes(n, e, v)
    assert nbytes == 2 * (n * e + e * v) + 4 * n + 4 * 1002 * n
    t_ops = 2 * n * e * v / chip_smoke.PEAK_FLOPS * 1e3
    assert t_ops == pytest.approx(34.8, abs=0.05) and t_ops > nbytes / chip_smoke.PEAK_BYTES * 1e3


@pytest.mark.parametrize("mangled,name", [
    ("_ZN4_GLOBAL16flash_fwd_kernelILi64EEEv", "flash_fwd_kernel<64>"),
    ("_ZN12_GLOBAL__N_115gmm_sm90_kernelILb1EEEv14CUtensorMap_stS1_PKiP13__nv_bfloat16iii",
     "gmm_sm90_kernel<1>"),
    ("_ZN12_GLOBAL__N_115lce_sm90_kernelILb0ELb1ENS_10DLogitsEpiEEEv14CUtensorMap_stS2_iiiNS_"
     "9SigFilterES1_", "lce_sm90_kernel<0,1,DLogitsEpi>"),
    ("_ZN12_GLOBAL__N_111tgmm_kernelEPK13__nv_bfloat16S2_PKiPS0_iii", "tgmm_kernel"),
    ("_Z4mainv", "_Z4mainv")])
def test_ptxas_report_names_kernels_with_digits_and_class_arguments(mangled, name):
    """The build report shortens a kernel's mangled name to kernel<args> also when the
    name holds digits (gmm_sm90_kernel) or a template argument is a class."""
    assert chip_smoke._kernel_name(mangled) == name


def test_expected_launches_count_validation():
    """Main path 9: validation runs forward only, with no layer checkpoint, so each of its
    batches adds flash_fwd once a layer and lce_fwd once, and nothing to the backward."""
    plain = chip_smoke._expected(4, 4, 4, True)
    want = chip_smoke._expected(4, 4, 4, True, val_batches=4)
    assert want["flash_fwd"] - plain["flash_fwd"] == 16 and want["lce_fwd"] - plain["lce_fwd"] == 4
    assert {k: v for k, v in want.items() if k not in ("flash_fwd", "lce_fwd")} == {
        k: v for k, v in plain.items() if k not in ("flash_fwd", "lce_fwd")}
    assert (want["flash_fwd"], want["flash_bwd"], want["lce_fwd"], want["lce_bwd"]) == (
        144, 64, 20, 16)


def test_byte_tokenizer_and_hellaswag_rows(tmp_path):
    from automodel_tpu_torch.data.llm.hellaswag import HellaSwagDataset

    tok = chip_smoke.ByteTokenizer()
    assert tok.encode("ab") == [1, 100, 101]
    path = chip_smoke.write_hellaswag_jsonl(str(tmp_path / "rows.jsonl"), 20, seed=4)
    again = chip_smoke.write_hellaswag_jsonl(str(tmp_path / "again.jsonl"), 20, seed=4)
    assert open(path).read() == open(again).read()  # from the seed
    rows = [json.loads(line) for line in open(path)]
    assert len(rows) == 20 and all(len(r["endings"]) == 4 and 0 <= r["label"] < 4 for r in rows)
    ds = HellaSwagDataset(path_or_dataset_id=path, tokenizer=tok)
    ex = ds[0]
    assert ex["input_ids"][0] == 1 and ex["input_ids"][-1] == 2 and 0 < ex["prompt_len"]
    assert max(ex["input_ids"]) < 259


def test_baseline_config_swaps_only_model_and_data(tmp_path):
    import yaml

    path = chip_smoke.baseline_config(str(tmp_path), "/hf", "/t.jsonl", "/v.jsonl")
    with open(chip_smoke.BASELINE_YAML) as f:
        orig = yaml.safe_load(f)
    with open(path) as f:
        derived = yaml.safe_load(f)
    swapped = {"model", "dataset", "validation_dataset", "tokenizer"}
    assert {k: v for k, v in derived.items() if k not in swapped} == {
        k: v for k, v in orig.items() if k not in swapped}
    assert derived["model"] == {"pretrained_model_name_or_path": "/hf"}
    assert derived["tokenizer"] == {"_target_": "chip_smoke.ByteTokenizer"}
    cfg = parse_args_and_load_config(["-c", path, *chip_smoke.baseline_args("/ck")])
    assert cfg.dataloader.prefetch.enabled and cfg.checkpoint.save_consolidated
    assert cfg.checkpoint.checkpoint_dir == "/ck" and cfg.validation_max_batches == 2
    assert (cfg.step_scheduler.ckpt_every_steps, cfg.step_scheduler.val_every_steps,
            cfg.step_scheduler.max_steps, cfg.step_scheduler.grad_acc_steps) == (2, 2, 4, 4)
    assert (cfg.micro_batch_size, cfg.seq_len, cfg.backend.attention,
            cfg.backend.remat_policy) == (2, 2048, "flash", "none")
    assert cfg.dataset.path_or_dataset_id == "/t.jsonl"


def test_baseline_path_resumes_on_cpu(tmp_path):
    """Main path 9 at small widths on the CPU: a local HF directory written by
    write_pretrained, the derived config with prefetch, validation and checkpoints every
    2 steps; run B, resumed from step 2 after step_4 is removed, repeats run A's losses
    bitwise (no atomics on the CPU), and step_4/hf reloads to run A's final weights."""
    import shutil

    from automodel_tpu_torch.models.auto import AutoModelForCausalLM

    small = dict(chip_smoke.LLAMA32_1B, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                 head_dim=16, vocab_size=512)
    hf = chip_smoke.write_pretrained(str(tmp_path / "hf"), small, device="cpu")
    path = chip_smoke.baseline_config(
        str(tmp_path), hf, chip_smoke.write_hellaswag_jsonl(str(tmp_path / "t.jsonl"), 64, 0),
        chip_smoke.write_hellaswag_jsonl(str(tmp_path / "v.jsonl"), 16, 1))
    ckpt = str(tmp_path / "ck")
    runs = {}
    for run in ("A", "B"):
        if run == "B":
            shutil.rmtree(os.path.join(ckpt, "step_4"))
        cfg = parse_args_and_load_config([
            "-c", path, *chip_smoke.baseline_args(ckpt), "--output_dir", str(tmp_path / run),
            "--device", "cpu", "--seq_len", "256"])
        runs[run] = chip_smoke._recorded_train_ft(cfg)
        if run == "A":
            reloaded = AutoModelForCausalLM.from_pretrained(
                os.path.join(ckpt, "step_4", "hf"), device="cpu").param_dict()
            assert all(torch.equal(v, reloaded[k]) for k, v in runs[run][0].params.items())
    (_, a, rows_a, val_a), (_, b, rows_b, _) = runs["A"], runs["B"]
    assert sorted(a) == [1, 2, 3, 4] and sorted(b) == [3, 4]
    assert b[3] == a[3] and b[4] == a[4]
    assert [r["step"] for r in val_a] == [2, 4] and all(math.isfinite(r["val_loss"]) for r in val_a)
    assert [r["event"] for r in rows_b if "event" in r][0] == "checkpoint_restore"
    assert {r["step"] for r in rows_a if r.get("event") == "checkpoint_save"} == {2, 4}
