"""What of chip_smoke.py runs without a card: the loss it holds the main paths to, its
table of expected kernel launches (validation's and the deterministic route's included),
the work behind the new kernels' bounds, the order of its phases, the derived
long-context CP config (main paths 7, 8 and 10) through the recipes on the CPU at small
widths, and main path 9's helpers: the stub tokenizer, the HellaSwag rows, the derived
BASELINE config, and the path itself at small widths."""

import inspect
import json
import math
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.llama.model import LlamaForCausalLM
from automodel_tpu_torch.ops.losses import masked_cross_entropy
from automodel_tpu_torch.recipes.llm import benchmark, train_ft
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


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


@pytest.mark.parametrize("hidden,layers", [(1024, 2), (2048, 4)])
def test_random_init_loss_counts_gemmas_tied_self_logit(hidden, layers):
    """A random-init Gemma-2 (embedding scaled by sqrt(hidden), tied to the unembedding)
    scores the input token itself at about tied_self_logit: its linear-CE loss on random
    labels (the recipes' loss at a large vocabulary) is the logsumexp of that logit and
    the vocabulary's, within 0.3 (path 19's check allows 0.5)."""
    from automodel_tpu_torch.models.gemma.model import GemmaForCausalLM
    from automodel_tpu_torch.ops.losses import linear_cross_entropy

    hf = dict(chip_smoke.GEMMA2_27B, hidden_size=hidden, intermediate_size=256,
              num_hidden_layers=layers, num_attention_heads=hidden // 128,
              num_key_value_heads=hidden // 256, vocab_size=1000)
    model = GemmaForCausalLM.from_config(hf, BackendConfig(dtype="float32", remat_policy="full"),
                                         device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    ids, labels = (torch.tensor(rng.randint(0, 1000, (2, 64))) for _ in range(2))
    with torch.no_grad():
        loss = linear_cross_entropy(model(ids, return_hidden=True),
                                    model.param_dict()["embed"].t(), labels).item()
    self_logit = chip_smoke.tied_self_logit(hf)
    assert self_logit > 6  # of the order of ln(vocab) or above
    assert abs(loss - chip_smoke.random_init_loss(1000, hidden, 0.02, self_logit)) < 0.3
    assert chip_smoke.tied_self_logit(dict(hf, tie_word_embeddings=False)) == 0.0


def test_expected_launches_of_the_ring_paths():
    want = chip_smoke._expected(4, 1, 7, True, ring_cp=8)
    assert (want["ring_fwd"], want["ring_bwd"], want["flash_fwd"], want["flash_dq"]) == (
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
    assert work["flash_fwd"][0] == 4 * d * pairs and work["flash_backward"][0] == 14 * d * pairs
    assert work["flash_backward"][0] == work["flash_dq"][0] + work["flash_dkv"][0]
    assert work["flash_fwd"][0] == pytest.approx(137.5e9 * d / 128, rel=1e-3)
    qkv = 2 * b * s * d * (h + 2 * kh)
    assert work["flash_fwd"][1] == qkv + 2 * b * s * h * d + 4 * b * h * s
    assert work["flash_backward"][1] == 2 * qkv + 4 * b * s * h * d + 4 * b * h * s


@pytest.mark.parametrize("h,kh,sinks", [(16, 2, False), (8, 4, True), (4, 4, False)])
def test_reference_by_kv_groups_matches_the_whole(h, kh, sinks):
    """The flash cases' plain version over groups of KV heads (one KV head a group, as
    the 4 GiB limit makes it at case eb) gives the O, lse and every gradient that the
    plain version over all heads gives: query head i reads KV head i // (H / KH)."""
    from automodel_tpu_torch.ops import flash_attention as fa

    b, s, d = 2, 48, 16
    q, k, v, do = chip_smoke._inputs(torch, b, s, h, kh, d, seed=3, device="cpu")
    sink = torch.randn(h, generator=torch.Generator().manual_seed(4)) if sinks else None
    opts = dict(causal=True, segment_ids_q=None, sliding_window=20, logit_soft_cap=None,
                softmax_scale=None)
    whole = chip_smoke._reference_by_kv_groups(torch, fa, q, k, v, do, sink, opts)
    split = chip_smoke._reference_by_kv_groups(torch, fa, q, k, v, do, sink, opts,
                                               max_bytes=(h // kh) * b * s * s * 4)
    for a, r in [(whole[0], split[0]), (whole[1], split[1]), *zip(whole[2], split[2])]:
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)
    qr, kr, vr = (x.float().requires_grad_() for x in (q, k, v))
    o, lse = fa.flash_attention_reference(qr, kr, vr, sinks=sink, **opts)
    torch.testing.assert_close(split[0], o.detach(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(split[1], lse.detach(), rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad(o, (qr, kr, vr), do.float())
    for a, r in zip(split[2], grads):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)


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
    # every gmm timing lands in the kernels line: case a's forward is the row itself, the
    # rest (b, GPT-OSS's h and i, Mixtral's m and n, GLM-4.5-Air's o and p, Qwen3-Next's q
    # and r) keyed sub-rows
    keys = chip_smoke._GMM_ROW_KEYS
    cases = {c for c, _, _ in chip_smoke.GMM_SHAPES + chip_smoke.GPT_OSS_GMM_SHAPES
             + chip_smoke.MIXTRAL_GMM_SHAPES + chip_smoke.GLM45_GMM_SHAPES
             + chip_smoke.QWEN3_NEXT_GMM_SHAPES}
    assert {p for p, _ in keys} == {"forward", "dX", "tgmm"} and {c for _, c in keys} == cases
    assert cases == set("abhimnopqr") and len(keys) == 3 * len(cases)
    assert keys["forward", "a"] is None and keys["tgmm", "a"] is None
    assert len({v for v in keys.values() if v}) == 19
    assert keys["dX", "q"] == "dx_at_qwen3_next_gate_up"
    # Mixtral's gate_up at about 2048 rows an expert: 2 x 16,384 x 4096 x 28,672 FLOPs
    # (3.85 TFLOP, 3.89 ms at 989 TFLOP/s)
    m = chip_smoke._gmm_work(16384, 4096, 28672, 8, 8)
    assert m["forward"][0] / chip_smoke.PEAK_FLOPS * 1e3 == pytest.approx(3.891, abs=1e-3)


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
    causal), from the same work count as the timed rows: 8.80 TFLOP forward, 30.8
    backward (flash_dq and flash_dkv)."""
    b, s, h, kh, d = 1, 32768, 32, 8, 128
    q = torch.empty(b, s, h, d, dtype=torch.bfloat16, device="meta")
    k = v = torch.empty(b, s, kh, d, dtype=torch.bfloat16, device="meta")
    work = chip_smoke._flash_work(q, k, v)
    assert work["flash_fwd"][0] == pytest.approx(8.80e12, rel=1e-3)
    assert work["flash_backward"][0] == pytest.approx(30.8e12, rel=1e-3)
    bound = {name: max(fl / chip_smoke.PEAK_FLOPS, by / chip_smoke.PEAK_BYTES) * 1e3
             for name, (fl, by) in work.items()}
    assert bound["flash_fwd"] == pytest.approx(8.90, abs=0.01)
    assert bound["flash_backward"] == pytest.approx(31.13, abs=0.01)


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
    assert (want["flash_fwd"], want["flash_dq"], want["lce_fwd"], want["lce_bwd"]) == (
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
    bitwise (no atomics on the CPU), and step_4/hf reloads to run A's final weights. One
    microbatch a step and one validation batch keep the CPU's work small."""
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
            "--device", "cpu", "--seq_len", "256", "--step_scheduler.grad_acc_steps", "1",
            "--validation_max_batches", "1"])
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


def test_expected_launches_of_the_deterministic_route():
    """flash_dq and flash_dkv n each with or without the flag; under it ring_dq and
    ring_dkv take ring_bwd's launches, once a ring step each; the forward counts do not
    change."""
    plain = chip_smoke._expected(4, 4, 4, True, val_batches=4)
    det = chip_smoke._expected(4, 4, 4, True, val_batches=4, deterministic=True)
    assert det == plain and (det["flash_dq"], det["flash_dkv"]) == (64, 64)
    ring_plain = chip_smoke._expected(2, 1, 3, True, ring_cp=8)
    ring = chip_smoke._expected(2, 1, 3, True, ring_cp=8, deterministic=True)
    assert (ring_plain["ring_bwd"], ring_plain["ring_dkv"], ring_plain["ring_dq"]) == (48, 0, 0)
    assert (ring["ring_fwd"], ring["ring_bwd"], ring["ring_dkv"], ring["ring_dq"],
            ring["flash_dq"]) == (96, 0, 48, 48, 0)


def test_flash_split_work_at_shape_a():
    """The deterministic route's bounds at flash shape (a) (B=4, S=2048, H=32, KH=8,
    D=64, causal): flash_dq does 3 products a pair (103.1 GFLOP, 0.104 ms at 989
    TFLOP/s), flash_dkv 4 (137.5 GFLOP, 0.139 ms)."""
    full = [torch.empty(4, 2048, n, 64, dtype=torch.bfloat16, device="meta") for n in (32, 8, 8)]
    work = chip_smoke._flash_work(*full)
    pairs = 4 * 32 * 2048 * 2049 // 2
    assert work["flash_dq"][0] == 6 * 64 * pairs == pytest.approx(103.1e9, rel=1e-3)
    assert work["flash_dkv"][0] == 8 * 64 * pairs == pytest.approx(137.5e9, rel=1e-3)
    for name, ms in (("flash_dq", 0.104), ("flash_dkv", 0.139)):
        flops, nbytes = work[name]
        assert flops / chip_smoke.PEAK_FLOPS * 1e3 == pytest.approx(ms, abs=5e-4)
        assert flops / chip_smoke.PEAK_FLOPS > nbytes / chip_smoke.PEAK_BYTES
    qkv, rows = 2 * 4 * 2048 * 64 * (32 + 16), 4 * 4 * 32 * 2048
    assert work["flash_dq"][1] == qkv + 2 * 2 * 4 * 2048 * 32 * 64 + 2 * rows
    assert work["flash_dkv"][1] == 2 * qkv - 2 * 4 * 2048 * 32 * 64 + 2 * 4 * 2048 * 32 * 64 + 2 * rows


@pytest.mark.parametrize("step", [0, 1])
def test_ring_split_work_sums_to_a_fused_launch(step):
    """ring_dq does 3 products an allowed pair and ring_dkv 4: 7 against the fused
    launch's 5, the price of the fixed order."""
    x = chip_smoke._ring_step_inputs(torch, step, 4, 1, 8, 4, 2, 16, device="cpu")
    work = chip_smoke._ring_work(x, 4, 2, 16)
    assert work["ring_dq"][0] + work["ring_dkv"][0] == 7 * 16 * x["pairs"] * 2
    assert work["ring_bwd"][0] == 10 * 16 * x["pairs"]


def test_phase_order():
    """The twice-launch phase runs first, the kernel cases next (the ring's at (192, 128)
    after its others), then the main paths in order, the deterministic ones (main paths 9
    and 10 under the flag, in a child process) before GPT-OSS's (main paths 11 and 12),
    Phi-3's (13 and 14), the DeepSeek family's (15-17), Gemma's (18-23), the PEFT and
    QAT paths (24-29, after the nf4 check), the Llama lineage's and Mixtral's (30-32),
    the classifier and encoder recipes' (33-37) and the MoE families' and hybrids' (38-41,
    then the DeltaNet timing), then the kernels line."""
    src = inspect.getsource(chip_smoke.main)
    order = ["_twice_phase(", "_flash_phase(", "_timings(", "_window_timings(",
             "_refused_on_the_card(", "_ring_refused_on_the_card(", "_model_check(",
             "_lce_case(", "_lce_dh_case(", "_lce_timings(", "_gmm_phase(",
             "_moe_model_check(", "_ring_phase(",
             "_mla_ring_phase(", "_ring_timings(", "_mla_ring_timings(", "_ring_model_check(", '"main path 1"', '"main path 2"', '"main path 3"',
             '"main path 4"', '"main path 5"', '"main path 6"', '"main path 7"',
             '"main path 8"', '"main path 9"', "_deterministic_paths()", '"main path 11"',
             '"main path 12"', '"main path 13"', '"main path 14"', '"main path 15"',
             '"main path 16"', '"main path 17"', '"main path 18"', '"main path 19"',
             '"main path 20"', '"main path 21"', '"main path 22"', '"main path 23"',
             "_nf4_phase(", "_peft_paths()", '"main path 30"', '"main path 31"',
             "_lineage_paths()", "_encoder_paths()", "_family_paths()",
             "_delta_net_timings(", '{"kernels"']
    at = [re.search(r"(?<!\w)" + re.escape(x), src).start() for x in order]
    assert at == sorted(at)
    child = inspect.getsource(chip_smoke._deterministic_child)
    assert child.index("use_deterministic_algorithms(True)") < child.index("_baseline_path(")
    assert "deterministic=True" in child and '"main path 10"' in child
    assert 'CUBLAS_WORKSPACE_CONFIG=":4096:8"' in inspect.getsource(
        chip_smoke._deterministic_paths)


def test_deterministic_restores_the_flag():
    before = torch.are_deterministic_algorithms_enabled()
    with chip_smoke._deterministic(torch):
        assert torch.are_deterministic_algorithms_enabled()
        with chip_smoke._deterministic(torch, False):
            assert not torch.are_deterministic_algorithms_enabled()
        assert torch.are_deterministic_algorithms_enabled()
    assert torch.are_deterministic_algorithms_enabled() == before


def test_gpt_oss_config_runs_through_both_recipes(tmp_path):
    """Main paths 11 and 12 at small widths: the GPT-OSS proxy config with the published
    config's other settings (gpt_oss_args: layer_types cut to the depth, YaRN, biases,
    sinks, window 128) trains in the benchmark recipe and, packed, in train_ft. The runs
    take 2 layers (one sliding, one full), 8 of the 32 experts (top-4 still: the experts'
    plain version loops over them) and rows of 192 tokens (still longer than the window
    of 128)."""
    cfg = parse_args_and_load_config(["-c", chip_smoke.GPT_OSS_YAML, *chip_smoke.gpt_oss_args(),
                                      *SMALL])
    model = cfg.model.config
    assert model.layer_types == ["sliding_attention", "full_attention"] * 2
    assert model.rope_scaling["rope_type"] == "yarn" and model.rope_scaling["truncate"] is False
    assert sum(chip_smoke._port_config(cfg.model.config).sliding_flags) == 2
    assert chip_smoke._is_moe(cfg)
    assert cfg.backend.experts_backend == "pallas" and cfg.micro_batch_size == 8
    experts = ["--model.config.num_local_experts", "8", "--dataset.num_samples", "256"]
    result = benchmark.main(argv=["-c", chip_smoke.GPT_OSS_YAML, *chip_smoke.gpt_oss_args(2),
                                  *SMALL, *experts, "--benchmark.warmup_steps", "1",
                                  "--benchmark.timed_steps", "1", "--micro_batch_size", "2",
                                  "--dataset.seq_len", "192", "--seq_len", "192",
                                  "--output_dir", str(tmp_path / "bench")])
    assert len(result["losses"]) == 2 and all(map(math.isfinite, result["losses"]))

    cfg = parse_args_and_load_config([
        "-c", chip_smoke.GPT_OSS_YAML, *chip_smoke.gpt_oss_args(chip_smoke.GPT_OSS_LAYERS_TRAIN_FT),
        *SMALL, *experts, "--packed_sequence.packed_sequence_size", "192",
        "--dataset.seq_len", "60", "--backend.attention_segments", "true",
        "--micro_batch_size", "2", "--step_scheduler.max_steps", "2",
        "--checkpoint.enabled", "false", "--output_dir", str(tmp_path / "ft")])
    assert sum(chip_smoke._port_config(cfg.model.config).sliding_flags) == 1
    recipe = train_ft.main(cfg=cfg)
    assert type(recipe.model).__name__ == "GptOssForCausalLM"
    with open(tmp_path / "ft" / "training.jsonl") as f:
        rows = [r for r in map(json.loads, f) if "loss" in r]
    assert len(rows) == 2 and all(math.isfinite(r["loss"]) for r in rows)
    assert all(any(k.startswith("moe_load/") for k in r) for r in rows)


def test_windowed_launch_check():
    """The windowed share of a path's flash launches: 2n forward (with the replay), n of
    each backward kernel, for n = sliding layers x microbatches x steps."""
    launches = {"flash_fwd": 56, "flash_dq": 28, "flash_dkv": 28, "flash_fwd/windowed": 28,
                "flash_dq/windowed": 14, "flash_dkv/windowed": 14}
    chip_smoke._check_windowed("path", launches, 2, 1, 7)
    with pytest.raises(AssertionError, match="windowed flash launches"):
        chip_smoke._check_windowed("path", launches, 1, 1, 7)
    chip_smoke._reset_counts()
    assert chip_smoke._read_windowed() == {"flash_fwd/windowed": 0, "flash_dq/windowed": 0,
                                           "flash_dkv/windowed": 0}


def test_window_bound_at_the_gpt_oss_shape():
    """GPT-OSS's window of 128 at S=8192 allows 1,040,448 pairs a head, 1/32.25 of the
    causal 33,558,528; the bound of the windowed forward is 4 D pairs over the peak."""
    s, w = 8192, 128
    assert chip_smoke._allowed_pairs(s, w) == 8256 + (s - w) * w == 1040448
    assert chip_smoke._allowed_pairs(s) == s * (s + 1) // 2
    assert chip_smoke._allowed_pairs(100, 4096) == chip_smoke._allowed_pairs(100)
    q = torch.empty(1, s, 64, 64, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(1, s, 8, 64, dtype=torch.bfloat16, device="meta")
    work = chip_smoke._flash_work(q, kv, kv, w)
    assert work["flash_fwd"][0] == 4 * 64 * 64 * 1040448
    assert work["flash_backward"][0] == 14 * 64 * 64 * 1040448
    t_ops = work["flash_fwd"][0] / chip_smoke.PEAK_FLOPS * 1e3
    t_bytes = work["flash_fwd"][1] / chip_smoke.PEAK_BYTES * 1e3
    assert t_ops == pytest.approx(0.0172, abs=1e-4) and t_bytes > t_ops  # bound by bytes


def test_expected_launches_of_the_phi3_paths():
    """Main path 13: all 32 layers, 7 steps of one microbatch, masked CE (Phi-3's vocab is
    under 65,536): flash_fwd 448 (forward and replay), flash_dq and flash_dkv 224, every
    one windowed and at head_dim 96; main path 14: 2 layers, 2 microbatches, 4 steps."""
    for layers, micro, steps, n in ((32, 1, chip_smoke.WARMUP + chip_smoke.TIMED, 224),
                                    (chip_smoke.PHI3_LAYERS_TRAIN_FT, 2, chip_smoke.PHI3_STEPS,
                                     16)):
        want = chip_smoke._expected(layers, micro, steps, False)
        assert (want["flash_fwd"], want["flash_dq"], want["flash_dkv"]) == (2 * n, n, n)
        assert not any(v for k, v in want.items() if not k.startswith("flash_"))
        launches = dict(want, **{f"{k}/windowed": want[k] for k in ("flash_fwd", "flash_dq",
                                                                    "flash_dkv")},
                        **{f"{k}/d96": want[k] for k in ("flash_fwd", "flash_dq", "flash_dkv")})
        chip_smoke._check_windowed("path", launches, layers, micro, steps)
        chip_smoke._check_head_dim("path", launches, 96)
        with pytest.raises(AssertionError, match="head dim"):
            chip_smoke._check_head_dim("path", dict(launches, **{"flash_dq/d96": n - 1,
                                                                 "flash_dq/d128": 1}), 96)
    assert chip_smoke._port_config(chip_smoke.PHI3_MINI).head_dim == 96


SMALL_PHI3 = ["--model.config.hidden_size", "192", "--model.config.intermediate_size", "256",
              "--model.config.num_attention_heads", "2", "--model.config.num_key_value_heads",
              "2", "--model.config.vocab_size", "512", "--dataset.vocab_size", "512",
              "--dataset.seq_len", "128", "--seq_len", "128", "--device", "cpu"]


def test_phi3_config_runs_through_both_recipes(tmp_path):
    """Main paths 13 and 14 at small widths (head_dim 96 kept: hidden 192 over 2 heads):
    the Phi-3 proxy config with the published widths' other settings (phi3_args: window
    2047 on every layer, untied) in the benchmark recipe at 1 layer; phi3_mini_sft.yaml
    with phi3_sft_args from a local directory in HF's fused layout (write_pretrained),
    packed, in train_ft for 2 steps of one microbatch, with its checkpoint every 2 steps:
    step_2/hf holds the fused tensors and reloads to the final weights bitwise."""
    from automodel_tpu_torch.checkpoint.safetensors_io import load_safetensors
    from automodel_tpu_torch.models.auto import AutoModelForCausalLM

    cfg = parse_args_and_load_config(["-c", chip_smoke.PHI3_YAML, *chip_smoke.phi3_args(),
                                      *SMALL_PHI3])
    model = cfg.model.config
    assert model.architectures == ["Phi3ForCausalLM"] and model.num_hidden_layers == 32
    assert model.sliding_window == 2047 and model.tie_word_embeddings is False
    assert sum(chip_smoke._port_config(cfg.model.config).sliding_flags) == 32
    assert chip_smoke._port_config(model).head_dim == 96
    result = benchmark.main(argv=["-c", chip_smoke.PHI3_YAML, *chip_smoke.phi3_args(1),
                                  *SMALL_PHI3, "--benchmark.warmup_steps", "1",
                                  "--benchmark.timed_steps", "1", "--micro_batch_size", "2",
                                  "--output_dir", str(tmp_path / "bench")])
    assert len(result["losses"]) == 2 and all(map(math.isfinite, result["losses"]))

    small = dict(chip_smoke.PHI3_MINI, hidden_size=192, intermediate_size=256,
                 num_attention_heads=2, num_key_value_heads=2, vocab_size=512,
                 num_hidden_layers=chip_smoke.PHI3_LAYERS_TRAIN_FT)
    hf = chip_smoke.write_pretrained(str(tmp_path / "hf"), small, device="cpu")
    assert any(k.endswith("qkv_proj.weight") for k in load_safetensors(hf))
    ckpt = str(tmp_path / "ck")
    cfg = parse_args_and_load_config([
        "-c", chip_smoke.PHI3_SFT_YAML, *chip_smoke.phi3_sft_args(hf, ckpt),
        "--dataset.vocab_size", "512", "--dataset.seq_len", "60", "--seq_len", "128",
        "--packed_sequence.packed_sequence_size", "128", "--step_scheduler.grad_acc_steps", "1",
        "--step_scheduler.max_steps", "2", "--device", "cpu", "--output_dir", str(tmp_path / "ft")])
    recipe, losses, rows, _ = chip_smoke._recorded_train_ft(cfg)
    assert type(recipe.model).__name__ == "Phi3ForCausalLM" and recipe.loss_name == "masked_ce"
    assert sorted(losses) == [1, 2] and all(map(math.isfinite, losses.values()))
    assert [r["step"] for r in rows if r.get("event") == "checkpoint_save"] == [2]
    step_hf = os.path.join(ckpt, "step_2", "hf")
    names = set(load_safetensors(step_hf))
    assert {f"model.layers.{i}.{n}" for i in range(2)
            for n in ("self_attn.qkv_proj.weight", "mlp.gate_up_proj.weight")} <= names
    assert not any(n.endswith((".q_proj.weight", ".gate_proj.weight")) for n in names)
    reloaded = AutoModelForCausalLM.from_pretrained(step_hf, device="cpu").param_dict()
    assert all(torch.equal(v, reloaded[k]) for k, v in recipe.params.items())


def test_expected_launches_of_the_deepseek_paths():
    """Main path 15: the proxy's 12 layers (1 dense), 7 steps of one microbatch, linear CE,
    no flash (MLA's values are narrower than its keys); main path 16: 2 layers (1 dense),
    4 steps of 2 microbatches; main path 17: 2 layers (1 dense), ring cp 4: ring_fwd
    forward and replay a ring step, ring_dq + ring_dkv in ring_bwd's place, every launch
    at (192, 128)."""
    steps = chip_smoke.WARMUP + chip_smoke.TIMED
    p15 = chip_smoke._expected(12, 1, steps, True, moe=True, dense_prefix=1, mla=True)
    assert p15 == dict(dict.fromkeys(p15, 0), gmm=462, tgmm=154, lce_fwd=7, lce_bwd=7)
    p16 = chip_smoke._expected(chip_smoke.MOONLIGHT_LAYERS, 2, chip_smoke.MOONLIGHT_STEPS, True,
                               moe=True, dense_prefix=1, mla=True)
    assert p16 == dict(dict.fromkeys(p16, 0), gmm=48, tgmm=16, lce_fwd=8, lce_bwd=8)
    p17 = chip_smoke._expected(chip_smoke.MOONLIGHT_RING_LAYERS, 1, steps, True, moe=True,
                               ring_cp=chip_smoke.MOONLIGHT_RING_CP, dense_prefix=1, mla=True)
    assert p17 == dict(dict.fromkeys(p17, 0), gmm=42, tgmm=14, lce_fwd=7, lce_bwd=7,
                       ring_fwd=112, ring_dq=56, ring_dkv=56)
    assert chip_smoke._expected(4, 1, 7, True, ring_cp=8)["ring_bwd"] == 224  # Dv == D
    model = chip_smoke.MOONLIGHT_16B_A3B
    dims = {f"{k}/d192v128": p17[k] for k in ("ring_fwd", "ring_dq", "ring_dkv")}
    chip_smoke._check_ring_dims("path", dict(p17, **dims), model)
    with pytest.raises(AssertionError, match="D, Dv"):
        chip_smoke._check_ring_dims("path", dict(p17, **dims, **{"ring_dq/d128v128": 1}), model)
    assert chip_smoke._is_mla(model) and chip_smoke._kernel_layers(
        dict(model, num_hidden_layers=2)) == (2, 1)


SMALL_MLA = ["--model.config.hidden_size", "64", "--model.config.intermediate_size", "96",
             "--model.config.moe_intermediate_size", "32", "--model.config.num_attention_heads",
             "4", "--model.config.kv_lora_rank", "32", "--model.config.qk_nope_head_dim", "16",
             "--model.config.qk_rope_head_dim", "8", "--model.config.v_head_dim", "16",
             "--model.config.n_routed_experts", "8", "--model.config.vocab_size", "512",
             "--dataset.vocab_size", "512", "--device", "cpu"]


def test_deepseek_configs_run_through_both_recipes(tmp_path):
    """Main paths 15-17 at small widths on the CPU: the DeepSeek-V3 proxy (its q_lora_rank
    route, groups 4 / 2) in the benchmark recipe; Moonlight's published settings
    (moonlight_ring_args: q_lora_rank null, one group) under the ring on cp 4; and
    deepseek_v3_ep.yaml with moonlight_sft_args from a local HF directory in train_ft,
    real routing with the gate-bias update on, 2 steps, a save at step 2 whose hf/ holds
    the f32 correction bias and reloads bitwise."""
    from automodel_tpu_torch.checkpoint.safetensors_io import load_safetensors
    from automodel_tpu_torch.models.auto import AutoModelForCausalLM

    bench = ["--benchmark.warmup_steps", "1", "--benchmark.timed_steps", "1"]
    cfg = parse_args_and_load_config(["-c", chip_smoke.DSV3_PROXY_YAML])
    assert chip_smoke._is_mla(cfg.model.config) and chip_smoke._is_moe(cfg)
    assert cfg.model.config.q_lora_rank == 512 and cfg.backend.fake_balanced_gate
    result = benchmark.main(argv=["-c", chip_smoke.DSV3_PROXY_YAML, *SMALL_MLA, *bench,
                                  "--model.config.num_hidden_layers", "2", "--seq_len", "64",
                                  "--dataset.seq_len", "64", "--micro_batch_size", "2",
                                  "--output_dir", str(tmp_path / "p15")])
    assert len(result["losses"]) == 2 and all(map(math.isfinite, result["losses"]))

    args = chip_smoke.moonlight_ring_args()
    cfg = parse_args_and_load_config(["-c", chip_smoke.DSV3_PROXY_YAML, *args])
    assert cfg.model.config.q_lora_rank is None and cfg.model.config.n_group == 1
    assert chip_smoke._ring_cp(cfg) == 4 and cfg.seq_len == 16384
    result = benchmark.main(argv=["-c", chip_smoke.DSV3_PROXY_YAML, *args, *SMALL_MLA, *bench,
                                  "--seq_len", "128", "--dataset.seq_len", "128",
                                  "--output_dir", str(tmp_path / "p17")])
    assert len(result["losses"]) == 2 and all(map(math.isfinite, result["losses"]))

    small = dict(chip_smoke.MOONLIGHT_16B_A3B, hidden_size=64, intermediate_size=96,
                 moe_intermediate_size=32, num_attention_heads=4, kv_lora_rank=32,
                 qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
                 vocab_size=512, num_hidden_layers=2)
    hf = chip_smoke.write_pretrained(str(tmp_path / "hf"), small, device="cpu")
    ckpt = str(tmp_path / "ck")
    cfg = parse_args_and_load_config([
        "-c", chip_smoke.DSV3_EP_YAML, *chip_smoke.moonlight_sft_args(hf, ckpt),
        "--dataset.vocab_size", "512", "--dataset.seq_len", "30", "--seq_len", "64",
        "--packed_sequence.packed_sequence_size", "64", "--step_scheduler.max_steps", "2",
        "--device", "cpu", "--output_dir", str(tmp_path / "p16")])
    assert cfg.backend.dispatcher == "dense" and cfg.distributed.ep == 1
    bias = "moe_layers.moe.gate.score_correction_bias"
    recipe, losses, rows, _ = chip_smoke._recorded_train_ft(cfg)
    assert type(recipe.model).__name__ == "DeepseekV3ForCausalLM"
    assert recipe.moe.gate_bias_update_factor == 0.001 and recipe.loss_name == "masked_ce"
    assert sorted(losses) == [1, 2] and all(map(math.isfinite, losses.values()))
    moved = recipe.params[bias].detach()
    assert moved.dtype == torch.float32 and bool((moved != 0).any())
    assert torch.all((moved.abs() * 1000).round() <= 2)  # two steps of +-0.001 or 0
    assert [r["step"] for r in rows if r.get("event") == "checkpoint_save"] == [2]
    step_hf = os.path.join(ckpt, "step_2", "hf")
    names = set(load_safetensors(step_hf))
    assert "model.layers.1.mlp.gate.e_score_correction_bias" in names
    assert "model.layers.0.self_attn.kv_a_proj_with_mqa.weight" in names
    reloaded = AutoModelForCausalLM.from_pretrained(step_hf, dtype=torch.bfloat16,
                                                    device="cpu").param_dict()
    assert all(torch.equal(v, reloaded[k]) for k, v in recipe.params.items())


def test_expected_launches_of_the_gemma_paths():
    """Main path 18: the Gemma-3 proxy as it stands with flash attention, 12 layers (10
    sliding at window 1024, 2 full), 7 steps of one microbatch, linear CE, no soft-cap;
    main path 19: Gemma-2-27B's widths over it at 4 layers (2 sliding), every launch
    capped; main path 20: 2 layers (1 sliding), 2 microbatches, 4 steps, every launch
    capped; all at head_dim 128. A capped count off by one fails its path."""
    steps = chip_smoke.WARMUP + chip_smoke.TIMED
    cfg = parse_args_and_load_config(["-c", chip_smoke.GEMMA3_PROXY_YAML,
                                      *chip_smoke.gemma3_proxy_args()])
    assert cfg.backend.attention == "flash" and cfg.model.config.architectures == [
        "Gemma3ForCausalLM"]
    assert sum(chip_smoke._port_config(cfg.model.config).sliding_flags) == 10
    assert chip_smoke._capped_layers(cfg.model.config) == 0
    cfg = parse_args_and_load_config(["-c", chip_smoke.GEMMA3_PROXY_YAML,
                                      *chip_smoke.gemma2_args()])
    model = chip_smoke._port_config(cfg.model.config)
    assert (model.hidden_size, model.intermediate_size, model.num_attention_heads,
            model.num_key_value_heads, model.head_dim, model.vocab_size) == (
        4608, 36864, 32, 16, 128, 256000)
    assert (model.attn_logit_softcapping, model.final_logit_softcapping,
            model.query_pre_attn_scalar, model.sliding_window, model.qk_norm) == (
        50.0, 30.0, 144, 4096, False)
    assert model.sliding_flags == [True, False, True, False]
    assert chip_smoke._capped_layers(cfg.model.config) == 4
    assert cfg.dataset.vocab_size == 256000 and cfg.backend.attention == "flash"
    for layers, micro, n_steps, sliding, capped, n in (
            (12, 1, steps, 10, 0, 84), (chip_smoke.GEMMA2_LAYERS, 1, steps, 2, 4, 28),
            (chip_smoke.GEMMA2_LAYERS_TRAIN_FT, 2, chip_smoke.GEMMA2_STEPS, 1, 2, 16)):
        want = chip_smoke._expected(layers, micro, n_steps, True)
        assert (want["flash_fwd"], want["flash_dq"], want["flash_dkv"]) == (2 * n, n, n)
        assert (want["lce_fwd"], want["lce_bwd"]) == (micro * n_steps, micro * n_steps)
        flash = ("flash_fwd", "flash_dq", "flash_dkv")
        launches = dict(want, **{f"{k}/windowed": want[k] * sliding // layers for k in flash},
                        **{f"{k}/softcap": want[k] * capped // layers for k in flash})
        chip_smoke._check_windowed("path", launches, sliding, micro, n_steps)
        chip_smoke._check_softcap("path", launches, capped, micro, n_steps)
        with pytest.raises(AssertionError, match="soft-capped"):
            chip_smoke._check_softcap("path", dict(launches, **{"flash_dq/softcap": n + 1}),
                                      capped, micro, n_steps)
    small = dict(chip_smoke.GEMMA2_27B, num_hidden_layers=chip_smoke.GEMMA2_LAYERS_TRAIN_FT)
    assert sum(chip_smoke._port_config(small).sliding_flags) == 1
    assert chip_smoke._capped_layers(small) == 2 and chip_smoke._port_config(small).head_dim == 128


SMALL_GEMMA = ["--model.config.hidden_size", "64", "--model.config.intermediate_size", "128",
               "--model.config.num_attention_heads", "4", "--model.config.num_key_value_heads",
               "2", "--model.config.head_dim", "16", "--model.config.vocab_size", "512",
               "--dataset.vocab_size", "512", "--dataset.seq_len", "64", "--seq_len", "64",
               "--device", "cpu"]


def test_gemma_configs_run_through_both_recipes(tmp_path):
    """Main paths 18-20 at small widths on the CPU: the Gemma-3 proxy (5:1 windows, q / k
    norms, dual RoPE) and Gemma-2-27B's settings over it (gemma2_args: caps, alternating
    windows) in the benchmark recipe; gemma2_9b_sft.yaml with its dataset swapped
    (gemma2_sft_config) and gemma2_sft_args from a local HF directory, through the shared
    _pretrained_run for 2 steps with a save at step 2, whose hf/ holds Gemma's names and
    reloads bitwise."""
    bench = ["--benchmark.warmup_steps", "1", "--benchmark.timed_steps", "1",
             "--micro_batch_size", "2"]
    for name, args in (("p18", ["--model.config.num_hidden_layers", "6",
                                *chip_smoke.gemma3_proxy_args()]),
                       ("p19", chip_smoke.gemma2_args(2))):
        result = benchmark.main(argv=["-c", chip_smoke.GEMMA3_PROXY_YAML, *args, *SMALL_GEMMA,
                                      *bench, "--output_dir", str(tmp_path / name)])
        assert len(result["losses"]) == 2 and all(map(math.isfinite, result["losses"]))

    small = dict(chip_smoke.GEMMA2_27B, hidden_size=64, intermediate_size=128,
                 num_attention_heads=4, num_key_value_heads=2, head_dim=16, vocab_size=512,
                 num_hidden_layers=chip_smoke.GEMMA2_LAYERS_TRAIN_FT)
    hf = chip_smoke.write_pretrained(str(tmp_path / "hf"), small, device="cpu")
    ckpt = str(tmp_path / "ck")
    path = chip_smoke.gemma2_sft_config(str(tmp_path))
    run = chip_smoke._pretrained_run("p20", [
        "-c", path, *chip_smoke.gemma2_sft_args(hf, ckpt), "--dataset.vocab_size", "512",
        "--dataset.seq_len", "64", "--seq_len", "64", "--step_scheduler.grad_acc_steps", "1",
        "--step_scheduler.max_steps", "2", "--device", "cpu",
        "--output_dir", str(tmp_path / "p20")], ckpt, reload_dtype=torch.bfloat16)
    # no kernel launches on the CPU: the path's launch checks expect none (0 microbatches)
    chip_smoke._check_pretrained_run("p20", run, range(1, 3), run["launches"], model=small,
                                     micro=0, saves=[2])
    assert run["loss_name"] == "masked_ce" and run["hf_differ"] == []
    assert "model.layers.1.pre_feedforward_layernorm.weight" in run["hf_names"]
    assert "lm_head.weight" not in run["hf_names"]  # tied


def test_expected_launches_of_the_head_dim_256_gemma_paths():
    """Main path 21: Gemma-2-9B's widths over the Gemma-3 proxy at 8 layers (4 sliding),
    every flash launch capped; main path 22: Gemma-3-4B's text widths at all 34 layers (29
    sliding at window 1024, linear RoPE scaling 8), none capped; main path 23: 6 layers of
    the multimodal Gemma-3-4B config (5 sliding), 2 microbatches, 4 steps, none capped; all
    at head_dim 256. A launch counted at another head dim fails its path."""
    steps = chip_smoke.WARMUP + chip_smoke.TIMED
    cfg = parse_args_and_load_config(["-c", chip_smoke.GEMMA3_PROXY_YAML, *chip_smoke.gemma2_args(
        chip_smoke.GEMMA2_9B_LAYERS, chip_smoke.GEMMA2_9B)])
    model = chip_smoke._port_config(cfg.model.config)
    assert (model.hidden_size, model.intermediate_size, model.num_attention_heads,
            model.num_key_value_heads, model.head_dim, model.vocab_size) == (
        3584, 14336, 16, 8, 256, 256000)
    assert (model.attn_logit_softcapping, model.final_logit_softcapping,
            model.query_pre_attn_scalar, model.sliding_window, model.qk_norm) == (
        50.0, 30.0, 256, 4096, False)
    assert model.sliding_flags == [True, False] * 4
    assert chip_smoke._capped_layers(cfg.model.config) == 8
    assert chip_smoke._port_config(cfg.model.config).head_dim == 256
    cfg = parse_args_and_load_config(["-c", chip_smoke.GEMMA3_PROXY_YAML, *chip_smoke.gemma2_args(
        34, chip_smoke.GEMMA3_4B_TEXT)])
    model = chip_smoke._port_config(cfg.model.config)
    assert (model.hidden_size, model.intermediate_size, model.num_attention_heads,
            model.num_key_value_heads, model.head_dim, model.vocab_size,
            model.query_pre_attn_scalar, model.sliding_window, model.qk_norm) == (
        2560, 10240, 8, 4, 256, 262208, 256, 1024, True)
    assert model.rope_scaling == {"rope_type": "linear", "factor": 8.0}
    assert (model.rope_theta, model.rope_local_base_freq) == (1e6, 1e4)
    assert sum(chip_smoke._port_config(cfg.model.config).sliding_flags) == 29
    assert chip_smoke._capped_layers(cfg.model.config) == 0
    assert cfg.dataset.vocab_size == 262208 and cfg.backend.attention == "flash"
    # the multimodal config of main path 23 reads as the text model's
    text = chip_smoke._port_config(dict(
        chip_smoke.GEMMA3_4B, text_config=dict(chip_smoke.GEMMA3_4B["text_config"],
                                               num_hidden_layers=6)))
    assert (text.hidden_size, text.head_dim, text.num_hidden_layers, sum(text.sliding_flags),
            text.vocab_size, text.attn_logit_softcapping) == (2560, 256, 6, 5, 262208, None)
    flash = ("flash_fwd", "flash_dq", "flash_dkv")
    for layers, micro, n_steps, sliding, capped, n in (
            (chip_smoke.GEMMA2_9B_LAYERS, 1, steps, 4, 8, 56), (34, 1, steps, 29, 0, 238),
            (chip_smoke.GEMMA3_4B_LAYERS_TRAIN_FT, 2, chip_smoke.GEMMA3_4B_STEPS, 5, 0, 48)):
        want = chip_smoke._expected(layers, micro, n_steps, True)
        assert (want["flash_fwd"], want["flash_dq"], want["flash_dkv"]) == (2 * n, n, n)
        launches = dict(want, **{f"{k}/windowed": want[k] * sliding // layers for k in flash},
                        **{f"{k}/softcap": want[k] * capped // layers for k in flash},
                        **{f"{k}/d256": want[k] for k in flash})
        chip_smoke._check_windowed("path", launches, sliding, micro, n_steps)
        chip_smoke._check_softcap("path", launches, capped, micro, n_steps)
        chip_smoke._check_head_dim("path", launches, 256)
        with pytest.raises(AssertionError, match="head dim"):
            chip_smoke._check_head_dim("path", dict(launches, **{"flash_dq/d256": n - 1,
                                                                 "flash_dq/d128": 1}), 256)


def test_gemma_head_dim_256_configs_run_through_both_recipes(tmp_path):
    """Main paths 21-23 at small widths on the CPU: Gemma-2-9B's and Gemma-3-4B's settings
    over the Gemma-3 proxy (gemma2_args of each config) in the benchmark recipe, and
    gemma3_4b_sft.yaml as it stands with gemma2_sft_args from a local HF directory in the
    multimodal layout (write_pretrained's ``language_model.`` prefix, the wrapper's
    config.json with its vision_config), through the shared _pretrained_run for 2 steps with
    a save at step 2, whose hf/ holds Gemma's names and reloads bitwise."""
    bench = ["--benchmark.warmup_steps", "1", "--benchmark.timed_steps", "1",
             "--micro_batch_size", "2"]
    for name, args in (("p21", chip_smoke.gemma2_args(2, chip_smoke.GEMMA2_9B)),
                       ("p22", chip_smoke.gemma2_args(6, chip_smoke.GEMMA3_4B_TEXT))):
        result = benchmark.main(argv=["-c", chip_smoke.GEMMA3_PROXY_YAML, *args, *SMALL_GEMMA,
                                      *bench, "--output_dir", str(tmp_path / name)])
        assert len(result["losses"]) == 2 and all(map(math.isfinite, result["losses"]))

    small = dict(chip_smoke.GEMMA3_4B, text_config=dict(
        chip_smoke.GEMMA3_4B["text_config"], hidden_size=64, intermediate_size=128,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, vocab_size=512,
        num_hidden_layers=chip_smoke.GEMMA3_4B_LAYERS_TRAIN_FT))
    hf = chip_smoke.write_pretrained(str(tmp_path / "hf"), small, device="cpu",
                                     prefix="language_model.")
    with open(os.path.join(hf, "model.safetensors"), "rb") as f:
        header = json.loads(f.read(int.from_bytes(f.read(8), "little")))
    assert "language_model.model.layers.5.self_attn.q_norm.weight" in header
    assert not any(k.startswith("model.") for k in header)
    ckpt = str(tmp_path / "ck")
    args = ["-c", chip_smoke.GEMMA3_SFT_YAML, *chip_smoke.gemma3_proxy_args(),
            *chip_smoke.gemma2_sft_args(hf, ckpt),
            "--dataset.vocab_size", "512", "--dataset.seq_len", "64", "--seq_len", "64",
            "--step_scheduler.grad_acc_steps", "1", "--step_scheduler.max_steps", "2",
            "--device", "cpu", "--output_dir", str(tmp_path / "p23")]
    assert parse_args_and_load_config(args).backend.attention == "flash"
    run = chip_smoke._pretrained_run("p23", args, ckpt, reload_dtype=torch.bfloat16)
    chip_smoke._check_pretrained_run("p23", run, range(1, 3), run["launches"], model=small,
                                     micro=0, saves=[2])  # the CPU launches no kernel
    assert run["hf_differ"] == []
    assert "model.layers.5.post_feedforward_layernorm.weight" in run["hf_names"]


def test_expected_launches_of_the_peft_paths():
    """Main paths 24-29: under PEFT every lce_bwd launch computes dH alone and the frozen
    experts launch no tgmm (gmm's forward, replay and dX stay); a full lce_bwd on a PEFT
    path, or a dH-only one elsewhere, fails the path. Qwen2.5-7B's widths (path 25) and
    the Qwen3-MoE path's read as published."""
    from automodel_tpu_torch.ops import linear_ce as lce

    want = chip_smoke._expected(2, 2, 3, True, moe=True, peft=True)
    assert (want["gmm"], want["tgmm"], want["lce_bwd"]) == (72, 0, 6)
    assert chip_smoke._expected(16, 2, 4, True, peft=True)["flash_dq"] == 128
    launches = {"gmm": 0, "tgmm": 0, "lce_fwd": 6, "lce_bwd": 6}
    chip_smoke._reset_counts()
    try:
        lce.ROUTE_LAUNCHES.update({"lce_fwd/wgmma": 6, "lce_bwd/wgmma": 6})
        with pytest.raises(AssertionError, match="dH alone"):
            chip_smoke._check_routes("path", launches, dh_only=True)
        lce.ROUTE_LAUNCHES["lce_bwd/dh_only"] = 6
        assert chip_smoke._check_routes("path", launches, dh_only=True)["lce_bwd/dh_only"] == 6
        with pytest.raises(AssertionError, match="dH alone"):
            chip_smoke._check_routes("path", launches)
    finally:
        chip_smoke._reset_counts()
    qwen = chip_smoke._port_config(chip_smoke.QWEN25_7B)
    assert (qwen.hidden_size, qwen.intermediate_size, qwen.num_hidden_layers,
            qwen.num_attention_heads, qwen.num_key_value_heads, qwen.head_dim,
            qwen.vocab_size, qwen.attention_bias, qwen.sliding_window,
            qwen.tie_word_embeddings) == (3584, 18944, 28, 28, 4, 128, 152064, True, None,
                                          False)
    n = sum(math.prod(v) for v in qwen.param_shapes().values())
    assert 7.60e9 < n < 7.65e9


SMALL_LLAMA = dict(chip_smoke.LLAMA32_1B, hidden_size=64, intermediate_size=128,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=16, vocab_size=512)


def test_peft_configs_run_through_train_ft(tmp_path):
    """Main paths 24, 26 and 29 at small widths on the CPU, through the shared
    _pretrained_run: the LoRA file with mock data (mock_data_config) from a local HF directory,
    2 steps and a save at step 2, whose hf/ (the merged model) reloads bitwise against
    merge_lora_params of the live tensors and whose hf_adapter/ holds the q / v factors;
    the QLoRA file (nf4 on wq / wv); the QAT file with the switch at step 2."""
    from automodel_tpu_torch.checkpoint.safetensors_io import load_safetensors
    from automodel_tpu_torch.quantization.qlora import is_quantized_leaf

    hf = chip_smoke.write_pretrained(str(tmp_path / "hf"), SMALL_LLAMA, device="cpu")
    small = ["--device", "cpu", "--seq_len", "64", "--dataset.seq_len", "64"]
    ckpt = str(tmp_path / "ck")
    yaml = chip_smoke.mock_data_config(str(tmp_path), chip_smoke.LORA_YAML, 512)
    run = chip_smoke._pretrained_run("p24", [
        "-c", yaml, *chip_smoke.peft_args(str(tmp_path / "p24"), 2, 1, hf, ckpt), *small], ckpt,
        reload_dtype=torch.bfloat16)
    chip_smoke._check_pretrained_run("p24", run, range(1, 3), run["launches"],
                                     model=SMALL_LLAMA, micro=1, saves=[2],
                                     first_loss=chip_smoke.random_init_loss(512, 64, 0.02))
    assert run["hf_differ"] == [] and sorted(run["adapter"])[0] == "layers.wq.lora_a"
    adapter = load_safetensors(os.path.join(ckpt, "step_2", "hf_adapter",
                                            "adapter_model.safetensors"))
    assert tuple(adapter[chip_smoke._ADAPTER_KEY.format(1, "v", "B")].shape) == (32, 8)
    assert len(adapter) == 2 * 2 * 2

    quantized = []
    run = chip_smoke._pretrained_run("p26", [
        "-c", chip_smoke.mock_data_config(str(tmp_path), chip_smoke.QLORA_YAML, 512),
        *chip_smoke.peft_args(str(tmp_path / "p26"), 2, 1, hf), *small], None,
        on_setup=lambda r: quantized.extend(k for k, v in r.params.items()
                                             if is_quantized_leaf(v)))
    assert sorted(quantized) == ["layers.wq", "layers.wv"] and len(run["losses"]) == 2

    gemma = dict(chip_smoke.GEMMA3_4B, text_config=dict(
        chip_smoke.GEMMA3_4B["text_config"], hidden_size=64, intermediate_size=128,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, vocab_size=512,
        num_hidden_layers=2))
    hf_gemma = chip_smoke.write_pretrained(str(tmp_path / "gemma"), gemma, device="cpu",
                                           prefix="language_model.")
    run = chip_smoke._pretrained_run("p29", [
        "-c", chip_smoke.mock_data_config(str(tmp_path), chip_smoke.GEMMA3_QAT_YAML, 512),
        "--qat.fake_quant_after_n_steps", "2",
        *chip_smoke.peft_args(str(tmp_path / "p29"), 3, 1, hf_gemma, dtype=None), *small], None)
    assert run["kinds"] == ["before_qat", "train", "train"]


def test_expected_launches_of_the_lineage_paths():
    """Main path 30: Command R7B at 4 layers (3 sliding RoPE layers at window 4096, 1 full
    NoPE layer; the unembedding divided by 4), 2 microbatches, 4 steps, linear CE; main
    path 31: Mixtral-8x7B's widths over the proxy at 3 layers, 8 experts top-2, every layer
    MoE (gmm 6n, tgmm 2n); main path 32: each member's widths over llama3_2_1b.yaml, and
    the StarCoder2 proxy through the structural alias. _check_path_launches holds each
    path's windowed, soft-capped and head-dim counts, and fails on one off by one."""
    model = dict(chip_smoke.COMMAND_R7B, num_hidden_layers=chip_smoke.COMMAND_R7B_LAYERS)
    config = chip_smoke._port_config(model)
    assert config.sliding_flags == [True, True, True, False]
    assert config.nope_flags == [False, False, False, True]
    assert (config.logits_scaling, config.head_dim, config.parallel_block,
            config.rope_interleaved, config.norm_type) == (4.0, 128, True, True, "layernorm")
    assert chip_smoke._logit_std(model) == pytest.approx(0.005)
    want = chip_smoke._expected(4, 2, 4, True)
    assert (want["flash_fwd"], want["flash_dq"], want["lce_fwd"]) == (64, 32, 8)
    launches = dict(want, **{f"{k}/windowed": want[k] * 3 // 4
                             for k in ("flash_fwd", "flash_dq", "flash_dkv")},
                    **{f"{k}/softcap": 0 for k in ("flash_fwd", "flash_dq", "flash_dkv")},
                    **{f"{k}/d128": want[k] for k in ("flash_fwd", "flash_dq", "flash_dkv")})
    chip_smoke._check_path_launches("p30", launches, model, 2, 4)
    with pytest.raises(AssertionError, match="windowed"):
        chip_smoke._check_path_launches("p30", dict(launches, **{"flash_dkv/windowed": 25}),
                                        model, 2, 4)
    with pytest.raises(AssertionError, match="head dim"):
        chip_smoke._check_path_launches("p30", dict(launches, **{"flash_dq/d64": 1}), model, 2,
                                        4)

    cfg = parse_args_and_load_config(["-c", chip_smoke.MIXTRAL_YAML, *chip_smoke.mixtral_args()])
    mixtral = chip_smoke._port_config(cfg.model.config)
    assert (mixtral.hidden_size, mixtral.intermediate_size, mixtral.moe.n_routed_experts,
            mixtral.moe.n_activated_experts, mixtral.moe.aux_loss_coeff,
            mixtral.num_hidden_layers, mixtral.vocab_size) == (4096, 14336, 8, 2, 0.02, 3, 32000)
    assert chip_smoke._is_moe(cfg) and cfg.optimizer.optimizer == "adamw_lowmem"
    want = chip_smoke._expected(3, 1, chip_smoke.WARMUP + chip_smoke.TIMED, False, moe=True)
    assert (want["gmm"], want["tgmm"], want["lce_fwd"]) == (126, 42, 0)
    # JAX's formula reads no num_local_experts: one dense MLP a layer where the port
    # counts two experts
    assert chip_smoke._jax_count_mfu(cfg.model.config, 2048, 0.5) < 0.5
    assert chip_smoke._jax_count_mfu(chip_smoke.COMMAND_R7B, 2048, 0.5) == pytest.approx(0.5)

    assert [m["vocab_size"] >= 65536 for _, m, _ in chip_smoke.LINEAGE_SWEEP] == [
        False, True, True, True]
    granite = chip_smoke._port_config(chip_smoke.GRANITE_33_2B)
    assert (granite.head_dim, granite.attention_multiplier, granite.logits_scaling,
            granite.embedding_multiplier, granite.residual_multiplier) == (
        64, 0.015625, 8.0, 12.0, 0.22)
    smol = chip_smoke._port_config(dict(chip_smoke.SMOLLM3_3B, num_hidden_layers=4))
    assert smol.nope_flags == [False, False, False, True] and smol.head_dim == 128
    olmo = chip_smoke._port_config(chip_smoke.OLMO2_7B)
    assert olmo.head_dim == 128 and olmo.qk_norm_whole and olmo.norm_placement == "post"
    glm = chip_smoke._port_config(chip_smoke.GLM4_9B)
    assert (glm.partial_rotary_factor, glm.norm_placement, glm.rope_interleaved) == (
        0.5, "sandwich", True)
    cfg = parse_args_and_load_config(["-c", chip_smoke.STARCODER2_YAML])
    star = chip_smoke._port_config(cfg.model.config)
    assert type(star).__name__ == "AliasedLlamaConfig" and not star.mlp_gated
    assert cfg.optimizer.optimizer == "adafactor_momentum_free"


SMALL_WIDTHS = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=16, vocab_size=512)


def test_lineage_configs_run_through_both_recipes(tmp_path):
    """Main paths 30-32 at small widths on the CPU: Command R7B's config (its original
    format) from a local HF directory through cohere2_r7b_sft.yaml with mock data and
    command_r7b_sft_args, through the shared _pretrained_run (2 steps, a save at step 2
    whose hf/ holds one norm a layer and no lm_head and reloads bitwise); Mixtral's
    widths over the proxy, each lineage member over llama3_2_1b.yaml and the StarCoder2
    proxy (with adafactor_nomom) through the benchmark recipe, finite losses."""
    small = dict(chip_smoke.COMMAND_R7B, **SMALL_WIDTHS, num_hidden_layers=4,
                 sliding_window=16)
    hf = chip_smoke.write_pretrained(str(tmp_path / "hf"), small, device="cpu")
    ckpt = str(tmp_path / "ck")
    yaml = chip_smoke.mock_data_config(str(tmp_path), chip_smoke.COHERE2_SFT_YAML, 512)
    run = chip_smoke._pretrained_run("p30", [
        "-c", yaml, *chip_smoke.command_r7b_sft_args(hf, ckpt), "--seq_len", "64",
        "--dataset.seq_len", "64", "--dataset.vocab_size", "512",
        "--step_scheduler.max_steps", "2", "--step_scheduler.ckpt_every_steps", "2",
        "--device", "cpu", "--output_dir", str(tmp_path / "p30")], ckpt,
        reload_dtype=torch.bfloat16)
    chip_smoke._check_pretrained_run("p30", run, range(1, 3), run["launches"], model=small,
                                     micro=0, saves=[2], first_loss=chip_smoke.random_init_loss(
                                         512, 64, chip_smoke._logit_std(small)))
    assert run["loss_name"] == "masked_ce" and run["hf_differ"] == []
    assert "lm_head.weight" not in run["hf_names"]
    assert not any("post_attention_layernorm" in n for n in run["hf_names"])

    bench = ["--benchmark.warmup_steps", "1", "--benchmark.timed_steps", "1",
             "--micro_batch_size", "2", "--seq_len", "64", "--dataset.seq_len", "64",
             "--device", "cpu"]
    widths = [x for kv in SMALL_WIDTHS.items() for x in (f"--model.config.{kv[0]}", str(kv[1]))]
    runs = [(chip_smoke.MIXTRAL_YAML, [*chip_smoke.mixtral_args(2), *widths,
                                       "--dataset.vocab_size", "512"]),
            (chip_smoke.STARCODER2_YAML, ["--optimizer.optimizer", "adafactor_nomom",
                                          "--model.config.num_hidden_layers", "2", *widths,
                                          "--dataset.vocab_size", "512"])]
    for label, member, _ in chip_smoke.LINEAGE_SWEEP:
        path = chip_smoke.lineage_config(str(tmp_path), dict(member, **SMALL_WIDTHS), 2)
        os.rename(path, path := str(tmp_path / f"{label}.yaml"))
        runs.append((path, []))
    for i, (yaml, args) in enumerate(runs):
        result = benchmark.main(argv=["-c", yaml, *args, *bench,
                                      "--output_dir", str(tmp_path / f"b{i}")])
        assert len(result["losses"]) == 2 and all(map(math.isfinite, result["losses"])), yaml


def test_expected_launches_of_the_encoder_paths():
    """Main paths 33-37: the classifier's (Llama-3.2-1B at 4 layers, 4 microbatches, 4
    steps) and GPT-2's counts are train_ft's with no linear CE; the biencoder's tower runs
    twice a microbatch and a validation batch (queries, then passages); mining runs the
    tower forward only, once a layer an encoded batch. _check_path_launches wants every
    flash launch of a bidirectional config non-causal and none of a causal one, and fails
    on one off by one."""
    want = chip_smoke._expected(4, 4, 4, False)
    assert (want["flash_fwd"], want["flash_dq"], want["lce_fwd"]) == (128, 64, 0)
    bi = chip_smoke._expected(16, 1, 4, False, val_batches=2, towers=2)
    assert (bi["flash_fwd"], bi["flash_dq"], bi["flash_dkv"]) == (2 * 128 + 16 * 2 * 2, 128, 128)
    mine = chip_smoke._expected(4, 0, 0, False, val_batches=32)
    assert (mine["flash_fwd"], mine["flash_dq"]) == (128, 0)
    from automodel_tpu_torch.config.loader import load_config

    tower = load_config(chip_smoke.BIENCODER_YAML).model.config.to_dict()
    config = chip_smoke._port_config(tower)
    assert not config.causal and (config.hidden_size, config.num_hidden_layers,
                                  config.pooling) == (2048, 16, "last")
    flash = ("flash_fwd", "flash_dq", "flash_dkv")
    launches = dict(bi, **{f"{k}/{kind}": 0 for k in flash for kind in ("windowed", "softcap")},
                    **{f"{k}/noncausal": bi[k] for k in flash},
                    **{f"{k}/d64": bi[k] for k in flash})
    chip_smoke._check_path_launches("p35", launches, tower, 1, 4)
    with pytest.raises(AssertionError, match="non-causal"):
        chip_smoke._check_path_launches("p35", dict(launches, **{"flash_dq/noncausal": 127}),
                                        tower, 1, 4)
    gpt2 = load_config(chip_smoke.NANOGPT_YAML).model.config.to_dict()
    want = chip_smoke._expected(12, 1, 4, False)
    launches = dict(want, **{f"{k}/{kind}": 0 for k in flash
                             for kind in ("windowed", "softcap", "noncausal")},
                    **{f"{k}/d64": want[k] for k in flash})
    chip_smoke._check_path_launches("p37", launches, gpt2, 1, 4)
    with pytest.raises(AssertionError, match="non-causal"):
        chip_smoke._check_path_launches("p37", dict(launches, **{"flash_fwd/noncausal": 1}),
                                        gpt2, 1, 4)
    # the classifier's first loss at init, and GPT-2-124M's FLOPs by nanoGPT's count
    assert chip_smoke.classifier_init_loss(2, 2048, 0.02) == pytest.approx(0.869, abs=1e-3)
    assert chip_smoke.classifier_init_loss(3, 16, 0.001) == pytest.approx(math.log(3), abs=1e-3)
    assert chip_smoke.gpt2_mfu(gpt2, 1024, 1.0) * chip_smoke.PEAK_FLOPS == pytest.approx(
        6 * 123_689_472 + 12 * 12 * 768 * 1024)
    # the pairs a padded batch allows: 3 real tokens and 1 pad; 4 of 4
    seg = torch.tensor([[1, 1, 1, 0], [1, 1, 1, 1]])
    assert chip_smoke._segment_pairs(seg, causal=False) == 9 + 1 + 16
    assert chip_smoke._segment_pairs(seg, causal=True) == 6 + 1 + 10
    assert chip_smoke._segment_pairs(torch.ones(2, 8), True) == 2 * chip_smoke._allowed_pairs(8)


ENCODER_WIDTHS = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=16, vocab_size=512)


def test_encoder_paths_run_on_cpu(monkeypatch):
    """Main paths 33-37 through their own functions on the CPU at small widths (2 layers,
    short rows): the classifier from a local directory without a head (the fresh head,
    the save and the bitwise reload of hf/), its LoRA run on Qwen2.5's config (a frozen
    head, four trainable factors), the biencoder (validation rows, flash against xla and
    its wrong-mask controls beyond the tolerance),
    mining (every row 1-4 negatives under the margin cut, read back) and GPT-2 on nanoGPT
    shards (a bitwise resume and reload). The kernels do not launch on the CPU: the
    launches expected are none."""
    import yaml

    zero = {k: 0 for k in chip_smoke._read_counts()}
    monkeypatch.setattr(chip_smoke, "_expected", lambda *a, **k: dict(zero))
    monkeypatch.setattr(chip_smoke, "MINE_ROWS", 64)
    cpu = ["--device", "cpu"]

    def tower(path):
        with open(path) as f:
            return dict(yaml.safe_load(f)["model"]["config"], **ENCODER_WIDTHS,
                        num_hidden_layers=2)

    for fn, model, extra in (
            (chip_smoke._seq_cls_path, dict(chip_smoke.LLAMA32_1B, **ENCODER_WIDTHS,
                                            num_hidden_layers=2), ["--seq_len", "64"]),
            (chip_smoke._qwen25_seq_cls_path, dict(chip_smoke.QWEN25_7B, **ENCODER_WIDTHS,
                                                   num_hidden_layers=2), ["--seq_len", "64"]),
            (chip_smoke._biencoder_path, tower(chip_smoke.BIENCODER_YAML), [
                "--micro_batch_size", "4", "--backend.dtype", "float32"]),
            (chip_smoke._mining_path, tower(chip_smoke.MINE_YAML),
             ["--biencoder.passage_seq_len", "32"]),
            (chip_smoke._gpt2_path, dict(architectures=["GPT2LMHeadModel"], vocab_size=512,
                                         n_embd=64, n_layer=2, n_head=4, n_positions=64),
             ["--micro_batch_size", "2", "--seq_len", "64", "--dataset.seq_len", "64"])):
        routed = fn("p", model, [*cpu, *extra])
        assert routed["flash_fwd/noncausal"] == 0


def test_expected_launches_of_the_family_paths():
    """Main paths 38-41 at their depths: GLM-4.5-Air's dense first layer and 2 MoE layers,
    Qwen3-Next's period (flash on its one full-attention layer only, the grouped GEMM on
    all four), MiniMax-M2's 2 MoE layers and the Step-3.5 geometry's 4 layers (3 sliding, MoE on
    layer 3 alone after moe_layers_enum is cut); the benchmark's 7 steps of 1 microbatch,
    train_ft's 2 steps of 2."""
    got = {}
    for path, _, recipe, _, model, layers in chip_smoke.FAMILY_PATHS:
        cut = chip_smoke.at_depth(model, layers)
        attn, moe = chip_smoke._kernel_layers(cut)
        micro, steps = ((1, chip_smoke.WARMUP + chip_smoke.TIMED) if recipe == "benchmark"
                        else (2, chip_smoke.FAMILY_STEPS))
        want = chip_smoke._expected(layers, micro, steps, True, moe=True,
                                    dense_prefix=layers - moe, attn_layers=attn)
        got[path] = {k: v for k, v in want.items() if v}
        if path == "main path 40":
            assert cut["moe_layers_enum"] == "3" and len(cut["layer_types"]) == 4
            assert sum(chip_smoke._port_config(cut).sliding_flags) == 3
    assert got == {
        "main path 38": dict(flash_fwd=42, flash_dq=21, flash_dkv=21, lce_fwd=7, lce_bwd=7,
                             gmm=84, tgmm=28),
        "main path 39": dict(flash_fwd=16, flash_dq=8, flash_dkv=8, lce_fwd=4, lce_bwd=4,
                             gmm=48, tgmm=16),
        "main path 40": dict(flash_fwd=32, flash_dq=16, flash_dkv=16, lce_fwd=4, lce_bwd=4,
                             gmm=24, tgmm=8),
        "main path 41": dict(flash_fwd=14, flash_dq=7, flash_dkv=7, lce_fwd=7, lce_bwd=7,
                             gmm=168, tgmm=56)}
    # every earlier MoE family keeps its counts through _kernel_layers
    assert chip_smoke._kernel_layers(chip_smoke.MOONLIGHT_16B_A3B) == (27, 26)
    assert chip_smoke._kernel_layers(chip_smoke.MIXTRAL_8X7B | {"architectures": [
        "MixtralForCausalLM"]}) == (32, 32)
    assert chip_smoke._kernel_layers(chip_smoke.LLAMA32_1B) == (
        chip_smoke.LLAMA32_1B["num_hidden_layers"], 0)


FAMILY_WIDTHS = {
    "main path 38": dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                         num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                         n_routed_experts=8, num_experts_per_tok=2, vocab_size=512),
    "main path 39": dict(hidden_size=64, intermediate_size=32, num_attention_heads=4,
                         num_key_value_heads=2, head_dim=16, num_local_experts=8,
                         num_experts_per_tok=2, vocab_size=512),
    "main path 40": dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                         share_expert_dim=48, num_attention_heads=4, num_attention_groups=2,
                         head_dim=16, moe_num_experts=8, moe_top_k=2, vocab_size=512,
                         sliding_window=16, attention_other_setting={
                             "num_attention_heads": 6, "num_attention_groups": 2}),
    "main path 41": dict(hidden_size=64, moe_intermediate_size=32,
                         shared_expert_intermediate_size=32, num_attention_heads=4,
                         num_key_value_heads=2, head_dim=16, linear_num_value_heads=4,
                         linear_num_key_heads=2, linear_key_head_dim=16,
                         linear_value_head_dim=16, num_experts=8, num_experts_per_tok=2,
                         vocab_size=512)}


def test_family_paths_run_on_cpu(monkeypatch):
    """Main paths 38-41 through their table's runner on the CPU, each at small widths
    over its config in chip_smoke.py (the depth, the layer pattern and the routing kept): GLM-4-
    MoE and Qwen3-Next in the benchmark recipe (GLM's gate-bias update moving the bias as
    its loads say), MiniMax-M2 and Step-3.5 through train_ft from a local HF directory
    (one save, hf/ reloaded bitwise). The first losses fall within 0.5 of the random-init
    loss; Qwen3-Next's path runs one more step in the recipe's profile window (the CPU
    records no device time for its scopes). The kernels do not launch on the CPU: the
    launches expected are none."""
    zero = {k: 0 for k in chip_smoke._read_counts()}
    monkeypatch.setattr(chip_smoke, "_expected", lambda *a, **k: dict(zero))
    checked = []
    monkeypatch.setattr(chip_smoke, "_check_path_launches",
                        lambda name, launches, model, micro, steps: checked.append(name))
    cpu = ["--device", "cpu"]
    extras = {"benchmark": [*cpu, "--seq_len", "64", "--dataset.seq_len", "64",
                            "--micro_batch_size", "2"],
              "train_ft": [*cpu, "--dataset.seq_len", "30",
                           "--packed_sequence.packed_sequence_size", "64"]}
    for path, label, recipe, yaml_path, model, layers in chip_smoke.FAMILY_PATHS:
        small = dict(model, **FAMILY_WIDTHS[path])
        routed = chip_smoke._family_path(path, label, recipe, yaml_path, small, layers,
                                         extra=extras[recipe])
        assert routed["flash_fwd"] == 0
    assert [c.split(" (")[0] for c in checked] == [
        "main path 38", "main path 39", "main path 40", "main path 41", "main path 41"]
    assert checked[-1].endswith(", profiled")  # the hybrid's step in the profile window
