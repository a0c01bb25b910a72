#!/usr/bin/env python3
"""Drive the PyTorch port (automodel_tpu_torch) on one NVIDIA H100 and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. the card's name and power limit (nvidia-smi);
2. build of every CUDA source in automodel_tpu_torch/csrc (nvcc, plain C + ctypes);
3. flash_fwd / flash_bwd against their plain version (f32 from the same bf16 inputs)
   in four cases: (a) the Llama-3.2-1B training shape, (b) packed segments with
   right padding, (c) non-causal, (d) a 16k sequence;
4. kernel times at shape (a) beside the bound, the plain version and SDPA;
5. Llama-3.2-1B width at 2 layers: one forward and backward with attention "flash"
   against attention "xla" on the same weights;
6. the main path: the benchmark recipe on examples/benchmark/llama3_2_1b.yaml
   (16 layers, full width), launch counts checked against the kernel counters;
7. one JSON line of per-kernel numbers, then the result line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_YAML = os.path.join(HERE, "examples", "benchmark", "llama3_2_1b.yaml")
WARMUP, TIMED = 2, 5  # benchmark steps of the main-path run (CLI overrides)
PEAK_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# kernel vs plain version, bf16 kernel against f32 plain from the same bf16 inputs:
# O is stored in bf16 (half an ulp near |O| ~ 1-4 is up to 8e-3); lse stays f32;
# the backward rounds P and dS to bf16 for its tensor-core products
TOL_O, TOL_LSE, TOL_GRAD = 2e-2, 1e-3, 1e-2
# flash vs xla through 2 bf16 layers at full width: both paths round activations and
# gradients to bf16, so they differ by a few bf16 ulps
TOL_MODEL_LOSS, TOL_MODEL_GRAD = 1e-2, 2e-2


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def _inputs(torch, b, s, h, kh, d=64, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, n, d, device="cuda", generator=g).to(torch.bfloat16)
                   for n in (h, kh, kh, h))
    return q, k, v, do


def _kernel_case(torch, fa, name, b, s, h, kh, causal, seg=None):
    q, k, v, do = _inputs(torch, b, s, h, kh)
    qk, kk, vk = (x.clone().requires_grad_() for x in (q, k, v))
    o, lse = fa.flash_attention_cuda(qk, kk, vk, causal=causal, segment_ids_q=seg)
    grads = torch.autograd.grad(o, (qk, kk, vk), do)
    torch.cuda.synchronize()
    qr, kr, vr = (x.float().requires_grad_() for x in (q, k, v))
    o_ref, lse_ref = fa.flash_attention_reference(qr, kr, vr, causal=causal, segment_ids_q=seg)
    grads_ref = torch.autograd.grad(o_ref, (qr, kr, vr), do.float())
    err_o = (o.float() - o_ref).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    rel = [_rel_l2(a, r) for a, r in zip(grads, grads_ref)]
    err_grad = max((a.float() - r).abs().max().item() for a, r in zip(grads, grads_ref))
    print(f"case {name}: B={b} S={s} H={h} KH={kh} causal={causal} segments={seg is not None}: "
          f"O max abs {err_o:.3e} (tol {TOL_O}), lse max abs {err_lse:.3e} (tol {TOL_LSE}), "
          f"grad rel L2 dq {rel[0]:.3e} dk {rel[1]:.3e} dv {rel[2]:.3e} (tol {TOL_GRAD})",
          flush=True)
    if not (err_o <= TOL_O and err_lse <= TOL_LSE and max(rel) <= TOL_GRAD):
        raise AssertionError(f"case {name}: kernels disagree with the plain version")
    del o_ref, lse_ref, grads_ref, qr, kr, vr
    torch.cuda.empty_cache()
    return err_o, err_grad


def _time_ms(torch, fn, warmup=3, reps=20) -> float:
    """Median of ``reps`` CUDA-event timings of one call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _library_sdpa(torch, q, k, v, causal):
    """The yardstick: PyTorch's own attention call, timed here and used nowhere in the port."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), is_causal=causal,
                                          enable_gqa=True).transpose(1, 2)


def _timings(torch, fa):
    """ms of each kernel at shape (a), with bound, plain version and SDPA."""
    b, s, h, kh, d = 4, 2048, 32, 8, 64
    q, k, v, do = _inputs(torch, b, s, h, kh, seed=1)
    scale = d**-0.5
    pairs = b * h * s * (s + 1) // 2  # allowed (q, k) pairs of this causal run
    fwd_flops, bwd_flops = 4 * d * pairs, 10 * d * pairs
    qkv_bytes = 2 * (q.numel() + k.numel() + v.numel())
    fwd_bytes = qkv_bytes + 2 * q.numel() + 4 * b * h * s  # + O, lse
    bwd_bytes = qkv_bytes + 2 * 2 * q.numel() + 4 * b * h * s + qkv_bytes  # + O, dO, lse; grads
    out = {}

    o, lse = fa.flash_fwd(q, k, v, None, None, scale, True)
    fwd_ms = _time_ms(torch, lambda: fa.flash_fwd(q, k, v, None, None, scale, True))
    bwd_ms = _time_ms(torch, lambda: fa.flash_bwd(q, k, v, None, None, o, lse, do, scale, True))
    plain_fwd = _time_ms(torch, lambda: fa.flash_attention_reference(q, k, v, causal=True))
    qp, kp, vp = (x.clone().requires_grad_() for x in (q, k, v))
    o_plain, _ = fa.flash_attention_reference(qp, kp, vp, causal=True)
    plain_bwd = _time_ms(torch, lambda: torch.autograd.grad(o_plain, (qp, kp, vp), do,
                                                            retain_graph=True))
    del o_plain
    lib_fwd = _time_ms(torch, lambda: _library_sdpa(torch, q, k, v, True))
    ql, kl, vl = (x.clone().requires_grad_() for x in (q, k, v))
    o_lib = _library_sdpa(torch, ql, kl, vl, True)
    lib_bwd = _time_ms(torch, lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do,
                                                          retain_graph=True))
    del o_lib
    torch.cuda.empty_cache()
    for name, ms, flops, nbytes, plain, lib in (
            ("flash_fwd", fwd_ms, fwd_flops, fwd_bytes, plain_fwd, lib_fwd),
            ("flash_bwd", bwd_ms, bwd_flops, bwd_bytes, plain_bwd, lib_bwd)):
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        print(f"time {name} at B={b} S={s} H={h} KH={kh} D={d} causal: {ms:.3f} ms, "
              f"bound {out[name]['bound_ms']:.3f} ms ({out[name]['bound_by']}: "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), plain {plain:.3f} ms, "
              f"SDPA {lib:.3f} ms", flush=True)
    return out


def _model_check(torch):
    """flash vs xla on the same weights: Llama-3.2-1B width, 2 layers, bf16."""
    from automodel_tpu_torch.config.loader import load_config
    from automodel_tpu_torch.data.collate import sft_collate
    from automodel_tpu_torch.data.llm.mock import MockSFTDataset
    from automodel_tpu_torch.models.common.backend import BackendConfig
    from automodel_tpu_torch.models.llama.model import LlamaForCausalLM
    from automodel_tpu_torch.ops.losses import masked_cross_entropy

    hf = dict(load_config(BENCH_YAML).model.config.to_dict(), num_hidden_layers=2)
    ds = MockSFTDataset(hf["vocab_size"], 2048, num_samples=4, seed=0)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in sft_collate([ds[i] for i in range(4)], 2048).items()}
    results = {}
    for attention in ("flash", "xla"):
        backend = BackendConfig(attention=attention, attention_segments=False,
                                remat_policy="mlp_attn_dots", dtype="bfloat16")
        model = LlamaForCausalLM.from_config(
            hf, backend, device="cuda", dtype=torch.bfloat16,
            generator=torch.Generator(device="cuda").manual_seed(0))
        params = model.param_dict()
        logits = model(batch["input_ids"], positions=batch["positions"],
                       segment_ids=batch["segment_ids"])
        loss = masked_cross_entropy(logits, batch["labels"])
        grads = torch.autograd.grad(loss, list(params.values()))
        results[attention] = (loss.item(), torch.cat([g.float().flatten() for g in grads]))
        del model, params, logits, grads
        torch.cuda.empty_cache()
    d_loss = abs(results["flash"][0] - results["xla"][0])
    rel = _rel_l2(results["flash"][1], results["xla"][1])
    print(f"model check (2 layers, Llama-3.2-1B width, bf16): loss flash "
          f"{results['flash'][0]:.6f} xla {results['xla'][0]:.6f} |diff| {d_loss:.3e} "
          f"(tol {TOL_MODEL_LOSS}), grad rel L2 {rel:.3e} (tol {TOL_MODEL_GRAD})", flush=True)
    if not (d_loss <= TOL_MODEL_LOSS and rel <= TOL_MODEL_GRAD):
        raise AssertionError("flash and xla attention disagree through the model")


def _main_path(torch, fa):
    """The benchmark recipe at full Llama-3.2-1B size, through its entry point."""
    from automodel_tpu_torch.config.loader import load_config
    from automodel_tpu_torch.recipes.llm import benchmark

    cfg = load_config(BENCH_YAML)
    layers = int(cfg.model.config.num_hidden_layers)
    micro = int(cfg.get("step_scheduler.grad_acc_steps", 1))
    with tempfile.TemporaryDirectory() as out_dir:
        argv = ["-c", BENCH_YAML, "--benchmark.warmup_steps", str(WARMUP),
                "--benchmark.timed_steps", str(TIMED), "--output_dir", out_dir]
        for key in fa.LAUNCHES:
            fa.LAUNCHES[key] = 0
        result = benchmark.main(argv=argv)
        launches = dict(fa.LAUNCHES)
    want_bwd = layers * micro * (WARMUP + TIMED)
    # forward: once, plus once more when each layer's checkpoint replays it
    want = {"flash_fwd": 2 * want_bwd, "flash_bwd": want_bwd}
    print(f"main path: benchmark recipe, Llama-3.2-1B ({layers} layers, {micro} microbatch), "
          f"mb {cfg.micro_batch_size}, seq {cfg.seq_len}, "
          f"{WARMUP} warmup + {TIMED} timed steps: {result['tokens_per_sec']:.1f} tokens/s, "
          f"step {result['step_time_s'] * 1e3:.1f} ms, MFU {result['mfu']}, "
          f"peak memory {result['peak_memory_gib']} GiB, losses {result['losses']}, "
          f"launches {launches} (expected {want})", flush=True)
    ln_vocab = math.log(128256)
    if not all(math.isfinite(x) for x in result["losses"]):
        raise AssertionError("non-finite loss on the main path")
    if abs(result["loss"] - ln_vocab) > 0.5:
        raise AssertionError(f"loss {result['loss']} is not within 0.5 of ln(128256)")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != expected {want}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "automodel_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(f"card: {_card_line()}", flush=True)

    from automodel_tpu_torch.kernels import build
    from automodel_tpu_torch.ops import flash_attention as fa

    seconds = build.build_all()
    print(f"build: {seconds:.1f} s", flush=True)
    for source, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {source}: {line.strip()}")

    errs = {"flash_fwd": 0.0, "flash_bwd": 0.0}

    def note(e):
        errs["flash_fwd"] = max(errs["flash_fwd"], e[0])
        errs["flash_bwd"] = max(errs["flash_bwd"], e[1])

    note(_kernel_case(torch, fa, "a", 4, 2048, 32, 8, causal=True))
    seg = torch.zeros(2, 2048, dtype=torch.int32, device="cuda")
    seg[0, :1000], seg[0, 1000:1900] = 1, 2
    seg[1, :700], seg[1, 700:2000] = 1, 2
    note(_kernel_case(torch, fa, "b", 2, 2048, 32, 8, causal=True, seg=seg))
    note(_kernel_case(torch, fa, "c", 2, 2048, 32, 8, causal=False))
    note(_kernel_case(torch, fa, "d", 1, 16384, 4, 2, causal=True))

    timings = _timings(torch, fa)
    _model_check(torch)
    launches = _main_path(torch, fa)

    pallas = "automodel_tpu/ops/pallas/flash_attention.py"
    replaces = {"flash_fwd": (f"{pallas}:84", []),
                "flash_bwd": (f"{pallas}:192", [f"{pallas}:151", f"{pallas}:258"])}
    kernels = []
    for name in ("flash_fwd", "flash_bwd"):
        row = {"name": name, "route": "cuda",
               "source": "automodel_tpu_torch/csrc/flash_attention.cu",
               "replaces": replaces[name][0], "launches": launches[name],
               "max_abs_err": errs[name], **timings[name]}
        if replaces[name][1]:
            row["replaces_by_function"] = replaces[name][1]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {_card_line()}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
