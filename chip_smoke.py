#!/usr/bin/env python3
"""Drive the PyTorch port (automodel_tpu_torch) on one NVIDIA H100 and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. the card's name and power limit (nvidia-smi);
2. build of every CUDA source in automodel_tpu_torch/csrc (nvcc, plain C + ctypes,
   one nvcc per source, all started together), with each kernel's registers and
   spills from -Xptxas -v;
3. flash_fwd / flash_bwd against their plain version (f32 from the same bf16 inputs)
   in seven cases: (a) the Llama-3.2-1B training shape, (b) packed segments with
   right padding, (c) non-causal, (d) a 16k sequence, (e) the shape and segments of
   main path 3 (rows of 4096 packed by pack_dataset from 1000-token documents); at
   head_dim 128: (f) the Qwen3-30B-A3B training shape, (g) case e's rows and segments;
   at the tiles' edges: (h) S=1000 at head_dim 64 and 128, (i) H=KH=8, head_dim 128,
   non-causal, segment boundaries inside tiles, (j) a grid smaller than the card (B=1,
   H=4, KH=1, S=4096, head_dim 128);
4. flash kernel times at shapes (a) and (f) beside the bound, the plain version and SDPA
   (one phase alone: ``chip_smoke._timings(torch, fa, 4, 2048, 32, 4, 128)``);
5. Llama-3.2-1B width at 2 layers: one forward and backward with attention "flash"
   against attention "xla" on the same weights;
6. lce_fwd / lce_bwd (fused linear CE) against their plain version in nine cases:
   (a) N=8192, E=2048, V=128,256 with 10% ignored labels, exact; (b) the same with h
   scaled up under filter_eps=1e-7; (c) ragged N=8190 with V=50,257; (d) E=4096;
   (e) shape (b) with a tied unembedding (the (V, E) embedding read in place);
   (f) E=1000, not a multiple of the 128 tile; (g) E=1003, tied, rows not 16-byte
   aligned; (h) E=8, V=16, tied, every dimension inside one tile; (i) E=1000,
   V=50,264, a multiple of 8 but not of the 256-column tile, so lce_fwd's wgmma route
   must mask the columns past V that TMA fills with zeros; each case line names the
   routes of lce_fwd and lce_bwd (wgmma where E and V are multiples of 8, else
   mma_sync: c, f, g) and fails if others were launched;
   then their times at shape (a) beside the bound, the plain version and the
   yardstick torch.logsumexp((h @ w).float(), -1), both kernels' times at main path 7's
   shape (N=32768, E=4096) beside their bounds (lce_fwd's also beside its plain
   version and yardstick, where the card holds their logits), and the peak memory
   that one forward and backward of linear_cross_entropy adds;
7. gmm / tgmm (grouped expert GEMM: forward, dX, dW) against their plain version in
   seven cases: (a) the slice's gate_up (N=65,536 routed rows, D=2048, F=1536, E=128,
   group sizes from a softmax top-8 router), (b) its down projection (D=768, F=2048),
   (c) empty head / middle / tail experts with N, D and F off the tiles, (d) one expert
   owning every row with rows not 16-byte aligned, (e) D=16, F=24, N=30, every
   dimension inside one tile, (f) c's experts and 300 rows past the groups, whose out
   and dX must be exactly 0, (g) tgmm's ragged K steps: experts of 1, 63, 64, 65, 127,
   0 and 200 rows (starts off the 64-row steps) and 37 rows past the groups at D=256,
   F=512; each case line names the routes of gmm and tgmm (wgmma where the row
   lengths are multiples of 8, else mma_sync: c, d) and fails if others were launched;
   then gmm (forward and dX) and tgmm times at (a) and (b) beside the bound, the plain
   version and torch._grouped_mm;
8. Qwen3-30B-A3B width at 1 layer: the kernels against the plain versions on the same
   weights, with routing held fixed;
8b. ring_fwd / ring_bwd (ring-attention chunk kernels) against their plain version, one
   full folded ring forward and backward each, in six cases: (a) the slice's shape (cp 8
   folded, B 1, S_local 4096, H 32, KH 8, D 128, causal), (b) packed segments with
   positions restarting per document, (c) the round-robin layout, (d) a sliding window,
   (e) D 64, KH 2, non-causal, (f) S_local 1000 at cp 3; their times at (a)'s diagonal
   ring step beside the bound and the plain version, at ring steps 1 and cp - 1 (7 of 8
   shards' chunks wholly allowed, then wholly skipped) beside their bounds; the tiles the
   kernels count as skipped, partial and full, held against tile_classes in every case and
   at each timed step; and the whole ring against
   flash_fwd / flash_bwd and SDPA on the unsharded S 32768, with flash's bound there;
8c. Llama-3-8B width at 2 layers, seq 8192, cp 4 folded: context_parallel ring (the ring
   kernels) against allgather (the flash kernels) on the same weights;
9. main path 1: the benchmark recipe on examples/benchmark/llama3_2_1b.yaml
   (16 layers, full width, masked_ce), launch counts checked against the counters;
10. main path 2: the benchmark recipe on examples/benchmark/llama3_2_1b_seq4096.yaml
   (16 layers, full width, untied head, linear_ce, seq 4096);
11. main path 3: train_ft on the same config with no loss.name (the default picks
   linear_ce) and packing of 1000-token documents into rows of 4096;
12. main path 4: the benchmark recipe on main path 1's config (tied embedding) with
   loss.name linear_ce, so the kernels read the (V, E) embedding in place; its
   first-step loss is held against main path 1's (same weights and batch);
13. main path 5: the benchmark recipe on examples/benchmark/qwen3_moe_a3b_proxy.yaml
   with the published Qwen3-30B-A3B widths at 4 layers (QWEN3_30B_A3B, qwen3_args) and
   the pallas experts backend;
14. main path 6: train_ft on the same at 2 layers, default loss, packing 500-token
   documents into rows of 2048 (token mask from segment ids, the aux-loss term,
   moe_load/* rows);
15. main path 7: the benchmark recipe on
   examples/llm_finetune/llama3_8b_long_context_cp.yaml (cp 8 folded onto the card,
   ring attention, seq 32768, remat dots, adamw, f32 params, linear_ce) with its dataset
   section replaced by the mock dataset (cp_config) and the published Meta-Llama-3-8B
   widths at 4 layers, one microbatch a step (LLAMA3_8B, llama3_8b_args);
16. main path 8: train_ft on the same at 2 layers, default loss, 4096-token documents
   packed into rows of 32768;
17. main path 9: BASELINE config #1 (examples/llm_finetune/llama3_2_1b_hellaswag.yaml)
   through train_ft with its model section pointing at a local HF directory that the
   port's safetensors writer fills with a random-init Llama-3.2-1B (published config,
   4 of 16 layers; write_pretrained), its data sections at HellaSwag-shaped JSONL rows
   read through ByteTokenizer (baseline_config), the prefetch pipeline on, validation
   and a checkpoint with the consolidated HF export every 2 steps, 4 steps
   (baseline_args). Run A runs fresh; its step_4 is removed and run B resumes from
   step 2 in the same directory. Checks: B's step-3 loss equals A's bitwise, its step-4
   loss within TOL_RESUME_LOSS, validation.jsonl rows at steps 2 and 4, A's step_4/hf
   reloaded through from_pretrained equals A's final parameters bitwise, and the launch
   counts with validation's forward-only launches; it prints the bytes and seconds of
   each save, the restore seconds, the step times and the peak memory. Every main path
   also checks that each of its gmm, tgmm, lce_fwd and lce_bwd launches took the wgmma
   route (``launches by route`` on its line);
18. one JSON line of per-kernel numbers, the card line, then the result line.

To run one phase alone on the card, import the script: e.g.
``python3 -c "import chip_smoke, torch; chip_smoke._gmm_phase(torch, {})"``, or the
main path 5 configuration through the recipe:
``python3 -m automodel_tpu_torch.recipes.llm.benchmark -c
examples/benchmark/qwen3_moe_a3b_proxy.yaml $(python3 -c "import chip_smoke;
print(' '.join(chip_smoke.qwen3_args()))")``.

``python3 chip_smoke.py --kernel-times [ROOT]`` builds the package of the checkout at
ROOT (default: this one) and times only its gmm (forward and dX) and tgmm at a and b,
its lce_fwd and lce_bwd at N=8192 / E=2048 and at main path 7's shape, and its ring_fwd
and ring_bwd at ring case (a)'s diagonal step and step 1, on the inputs of the timing
rows, so that two checkouts' kernels can be compared on one card in one call.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_YAML = os.path.join(HERE, "examples", "benchmark", "llama3_2_1b.yaml")
SEQ4096_YAML = os.path.join(HERE, "examples", "benchmark", "llama3_2_1b_seq4096.yaml")
MOE_YAML = os.path.join(HERE, "examples", "benchmark", "qwen3_moe_a3b_proxy.yaml")
# The published widths of Qwen/Qwen3-30B-A3B (its config.json on the Hugging Face Hub)
# laid over the proxy config, at 4 of its 48 layers; every layer is MoE, so
# intermediate_size is unused. The experts run the pallas backend, as
# examples/llm_finetune/qwen3_moe_fastpath.yaml sets it.
QWEN3_30B_A3B = {
    "hidden_size": 2048, "intermediate_size": 6144, "moe_intermediate_size": 768,
    "num_attention_heads": 32, "num_key_value_heads": 4, "head_dim": 128,
    "num_experts": 128, "num_experts_per_tok": 8, "norm_topk_prob": True,
    "vocab_size": 151936, "tie_word_embeddings": False, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "router_aux_loss_coef": 0.001, "max_position_embeddings": 40960,
    "num_hidden_layers": 4,
}
MOE_LAYERS_TRAIN_FT = 2  # depth of main path 6
CP_YAML = os.path.join(HERE, "examples", "llm_finetune", "llama3_8b_long_context_cp.yaml")
# The published widths of meta-llama/Meta-Llama-3-8B (its config.json on the Hugging Face
# Hub) laid over the long-context CP config, at 4 of its 32 layers; random weights from
# the seed (no weights in the repository).
LLAMA3_8B = {
    "vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
    "tie_word_embeddings": False, "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
    "max_position_embeddings": 8192, "num_hidden_layers": 4,
}
CP_LAYERS_TRAIN_FT = 2  # depth of main path 8
BASELINE_YAML = os.path.join(HERE, "examples", "llm_finetune", "llama3_2_1b_hellaswag.yaml")
# The published config.json of meta-llama/Llama-3.2-1B (Hugging Face Hub) at 4 of its 16
# layers: main path 9 writes random weights from the seed in this shape to a local HF
# directory, which the config loads as pretrained (no weights in the repository). At 16
# layers a save (f32 parameters, both Adam moments, the HF export) would be ~15 GB.
LLAMA32_1B = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 128256,
    "hidden_size": 2048, "intermediate_size": 8192, "num_hidden_layers": 4,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 64,
    "hidden_act": "silu", "max_position_embeddings": 131072, "rope_theta": 500000.0,
    "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    "rms_norm_eps": 1e-5, "tie_word_embeddings": True, "initializer_range": 0.02,
    "bos_token_id": 128000, "eos_token_id": 128001, "torch_dtype": "bfloat16",
}
BASELINE_STEPS = 4  # max_steps of main path 9: checkpoints and validation at 2 and 4
BASELINE_VAL_BATCHES = 2  # validation_max_batches of main path 9
TOL_RESUME_LOSS = 1e-3  # run B's step 4 against run A's: flash_bwd's dQ sums by atomics


class ByteTokenizer:
    """A byte-level stand-in for the model's tokenizer (no tokenizer files in the
    repository): BOS, then one id per UTF-8 byte (byte + 3); 0 pads, 2 ends."""

    pad_token_id, bos_token_id, eos_token_id = 0, 1, 2

    def encode(self, text: str) -> list[int]:
        return [self.bos_token_id] + [b + 3 for b in text.encode()]


_WORDS = ("the man a woman then is are and of to in on with into her his they "
          "puts takes walks starts shows continues across around ball water bike "
          "camera kitchen rope slowly quickly again while holding using").split()


def write_hellaswag_jsonl(path: str, rows: int, seed: int) -> str:
    """HellaSwag-shaped rows ``{ctx, endings, label}`` of random words from ``seed``:
    contexts of 20-80 words and four endings of 5-25, as the dataset's rows run."""
    import numpy as np

    rng = np.random.RandomState(seed)

    def words(lo, hi):
        return " ".join(rng.choice(_WORDS, rng.randint(lo, hi)))

    with open(path, "w") as f:
        for _ in range(rows):
            f.write(json.dumps({"ctx": words(20, 80), "endings": [words(5, 25) for _ in range(4)],
                                "label": int(rng.randint(4))}) + "\n")
    return path


def write_pretrained(out_dir: str, config: dict = LLAMA32_1B, seed: int = 0,
                     device: str = "cuda") -> str:
    """A local HF directory (config.json and model.safetensors, bf16 as published) of a
    random-init Llama of ``config`` (Llama-3.2-1B at LLAMA32_1B's depth), written by the
    port's own writer."""
    import torch

    from automodel_tpu_torch.checkpoint.safetensors_io import save_safetensors
    from automodel_tpu_torch.models.llama.model import LlamaForCausalLM

    model = LlamaForCausalLM.from_config(
        config, device=device, dtype=torch.bfloat16,
        generator=torch.Generator(device=device).manual_seed(seed))
    save_safetensors(model.state_dict_adapter().to_hf_lazy(model.param_dict()), out_dir)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return out_dir


def baseline_config(out_dir: str, hf_dir: str, train_jsonl: str, val_jsonl: str) -> str:
    """BASELINE config #1 (examples/llm_finetune/llama3_2_1b_hellaswag.yaml) with its model
    section pointing at ``hf_dir`` and its data sections at local HellaSwag JSONL rows with
    :class:`ByteTokenizer`; every other setting is the file's. Written to ``out_dir``."""
    import yaml

    with open(BASELINE_YAML) as f:
        cfg = yaml.safe_load(f)
    hellaswag = "automodel_tpu_torch.data.llm.hellaswag.HellaSwagDataset"
    cfg["model"] = {"pretrained_model_name_or_path": hf_dir}
    cfg["dataset"] = {"_target_": hellaswag, "path_or_dataset_id": train_jsonl, "split": "train"}
    cfg["validation_dataset"] = {"_target_": hellaswag, "path_or_dataset_id": val_jsonl,
                                 "split": "validation"}
    cfg["tokenizer"] = {"_target_": "chip_smoke.ByteTokenizer"}
    path = os.path.join(out_dir, "llama3_2_1b_hellaswag_local.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def baseline_args(ckpt_dir: str) -> list[str]:
    """CLI overrides of main path 9: prefetch on, a checkpoint and a validation pass every
    2 steps over 2 batches, BASELINE_STEPS steps, the checkpoints under ``ckpt_dir``."""
    return ["--dataloader.prefetch.enabled", "true",
            "--step_scheduler.ckpt_every_steps", "2", "--step_scheduler.val_every_steps", "2",
            "--validation_max_batches", str(BASELINE_VAL_BATCHES),
            "--step_scheduler.max_steps", str(BASELINE_STEPS),
            "--checkpoint.checkpoint_dir", ckpt_dir]


def llama3_8b_args(layers: int = LLAMA3_8B["num_hidden_layers"]) -> list[str]:
    """CLI overrides that turn the CP config (with its dataset section replaced by
    :func:`cp_config`) into the slice configuration: the published widths, random
    weights, one microbatch a step, no periodic checkpoint."""
    args = []
    for key, value in dict(LLAMA3_8B, num_hidden_layers=layers).items():
        args += [f"--model.config.{key}", str(value).lower() if isinstance(value, bool)
                 else str(value)]
    return args + ["--model.pretrained_model_name_or_path", "null",
                   "--step_scheduler.grad_acc_steps", "1",
                   "--step_scheduler.ckpt_every_steps", "0"]


def cp_config(out_dir: str) -> str:
    """The CP config with its HellaSwag dataset section (no files in the repository, no
    network) replaced by the mock dataset at seq 32768, written to ``out_dir``. CLI
    overrides cannot drop the section's keys, hence a derived file."""
    import yaml

    with open(CP_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"] = {"_target_": "automodel_tpu_torch.data.llm.mock.MockSFTDataset",
                      "vocab_size": LLAMA3_8B["vocab_size"], "seq_len": cfg["seq_len"],
                      "num_samples": 64, "seed": 0}
    path = os.path.join(out_dir, "llama3_8b_long_context_cp_mock.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def qwen3_args(layers: int = QWEN3_30B_A3B["num_hidden_layers"]) -> list[str]:
    """CLI overrides that turn the proxy config into the slice configuration."""
    args = []
    for key, value in dict(QWEN3_30B_A3B, num_hidden_layers=layers).items():
        args += [f"--model.config.{key}", str(value).lower() if isinstance(value, bool)
                 else str(value)]
    return args + ["--dataset.vocab_size", str(QWEN3_30B_A3B["vocab_size"]),
                   "--backend.experts_backend", "pallas"]


WARMUP, TIMED = 2, 5  # benchmark steps of the main-path runs (CLI overrides)
TRAIN_FT_STEPS = 3  # train_ft steps of main path 3
PEAK_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# kernel vs plain version, bf16 kernel against f32 plain from the same bf16 inputs:
# O is stored in bf16 (half an ulp near |O| ~ 1-4 is up to 8e-3); lse stays f32;
# the backward rounds P and dS to bf16 for its tensor-core products
TOL_O, TOL_LSE, TOL_GRAD = 2e-2, 1e-3, 1e-2
# flash vs xla through 2 bf16 layers at full width: both paths round activations and
# gradients to bf16, so they differ by a few bf16 ulps
TOL_MODEL_LOSS, TOL_MODEL_GRAD = 1e-2, 2e-2
# Qwen3-MoE, 1 layer at the slice widths: the kernels (flash, gmm/tgmm) against the plain
# versions (xla attention, the grouped GEMM's reference) with routing held fixed; bf16
# activations and gradients as in the Llama check above
TOL_MOE_LOSS, TOL_MOE_GRAD = 1e-2, 2e-2
# main path 4 (linear_ce, tied) against main path 1 (masked_ce) at the first step, the
# same weights and batch: linear CE takes f32 logits of the bf16 h and w where masked
# CE upcasts bf16-rounded logits; the mean over 8192 tokens differs by ~1e-4
TOL_TIED_LOSS = 1e-3
# linear CE kernels vs plain version (f32 from the same bf16 inputs). z: the kernel
# accumulates the same bf16 products in f32 in another order (|z| up to ~150 in case
# b, where 1e-5 relative is 1.5e-3). dH, dW: the kernel rounds dlogits to bf16
# before its two products (as the TPU kernel does) and stores dH, dW in bf16, each
# ~2e-3 relative. Against the exact gradient with the filter on: the skipped blocks
# hold softmax mass below filter_eps per element, at most V * 1e-7 = 1.3e-2 a row.
TOL_Z, TOL_LCE_GRAD, TOL_FILTER_EXACT = 2e-3, 1e-2, 2e-2
LCE_PEAK_LIMIT_GB = 2.1  # less than one bf16 (N, V) logits tensor at N=8192 (2.1 GB)
# grouped GEMM kernels vs plain version (f32 from the same bf16 inputs), relative L2 of
# out, dX and dW: the kernels round their f32 sums to bf16 once (~2e-3 relative)
TOL_GMM = 1e-2


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _kernel_name(mangled: str) -> str:
    """``kernel<args>`` from a mangled kernel name (template arguments that are ints,
    bools or classes); the mangled name where it does not parse."""
    name = mangled.replace("12_GLOBAL__N_1", "")  # the anonymous namespace
    for m in re.finditer(r"(\d+)(?=[A-Za-z_])", name):
        start = m.end()
        ident = name[start:start + int(m.group(1))]
        if not ident.endswith("kernel"):
            continue
        rest, args = name[start + len(ident):], []
        if rest.startswith("I"):
            i = 1
            while i < len(rest) and rest[i] != "E":
                lit = re.match(r"L[ib](\d+)E", rest[i:])
                # a class: its length-prefixed name, nested (N ... E) in a namespace
                # that may be a substitution (S_)
                cls = re.match(r"(N(?:S[0-9A-Z]*_)?)?(\d+)", rest[i:])
                if lit:
                    args.append(lit.group(1))
                    i += lit.end()
                elif cls:
                    j = i + cls.end()
                    args.append(rest[j:j + int(cls.group(2))])
                    i = j + int(cls.group(2)) + (1 if cls.group(1) else 0)
                else:
                    break
        return ident + (f"<{','.join(args)}>" if args else "")
    return mangled


def _ptxas_report(log: str) -> list[str]:
    """``kernel<template args>: registers, spills`` from nvcc's -Xptxas -v output, and
    any note that ptxas serialised a kernel's wgmma instructions (C7514)."""
    out, name = [], None
    for line in log.splitlines():
        if "C7514" in line:  # ptxas serialised a kernel's wgmmas
            out.append(line.strip())
            continue
        entry = re.search(r"entry function '(\S+)'", line)
        if entry:
            name = _kernel_name(entry.group(1))
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def _inputs(torch, b, s, h, kh, d=64, seed=0, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, n, d, device=device, generator=g).to(torch.bfloat16)
                   for n in (h, kh, kh, h))
    return q, k, v, do


def _flash_work(q, k, v):
    """FLOP and byte counts of one causal flash forward and backward, read from the
    timed tensors' own shapes: {"flash_fwd": (flops, bytes), "flash_bwd": (...)}. The
    bytes count each input read once and each output written once."""
    b, s, h, d = q.shape
    pairs = b * h * s * (s + 1) // 2  # allowed (q, k) pairs of a causal run
    qkv_bytes = 2 * (q.numel() + k.numel() + v.numel())
    lse_bytes = 4 * b * h * s
    return {"flash_fwd": (4 * d * pairs, qkv_bytes + 2 * q.numel() + lse_bytes),  # + O, lse
            # + O, dO, lse read; dq, dk, dv written
            "flash_bwd": (10 * d * pairs, 2 * qkv_bytes + 2 * 2 * q.numel() + lse_bytes)}


def _kernel_case(torch, fa, name, b, s, h, kh, causal, seg=None, d=64):
    q, k, v, do = _inputs(torch, b, s, h, kh, d)
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
    print(f"case {name}: B={b} S={s} H={h} KH={kh} D={d} causal={causal} "
          f"segments={seg is not None}: "
          f"O max abs {err_o:.3e} (tol {TOL_O}), lse max abs {err_lse:.3e} (tol {TOL_LSE}), "
          f"grad rel L2 dq {rel[0]:.3e} dk {rel[1]:.3e} dv {rel[2]:.3e} (tol {TOL_GRAD})",
          flush=True)
    if not (err_o <= TOL_O and err_lse <= TOL_LSE and max(rel) <= TOL_GRAD):
        raise AssertionError(f"case {name}: kernels disagree with the plain version")
    del o_ref, lse_ref, grads_ref, qr, kr, vr
    torch.cuda.empty_cache()
    return err_o, err_grad


def _packed_segments(torch):
    """(2, 4096) segment ids as main path 3 packs them: 1000-token documents (the mock
    samples after the next-token shift), four a row, then 96 pad tokens (segment 0)."""
    from automodel_tpu_torch.data.llm.mock import MockSFTDataset
    from automodel_tpu_torch.data.llm.packed import pack_dataset, packed_collate

    packs = pack_dataset(MockSFTDataset(128256, 1000, num_samples=8, seed=0), 4096,
                         max_packs=2)
    seg = packed_collate([packs[0], packs[1]])["segment_ids"]
    return torch.from_numpy(seg).to(device="cuda", dtype=torch.int32)


def _inner_segments(torch):
    """(2, 2048) segment ids whose boundaries fall inside 64- and 128-row tiles, with a
    one-token segment and a padded tail (segment 0)."""
    seg = torch.zeros(2, 2048, dtype=torch.int32)
    for row, cuts in enumerate(((0, 37, 100, 101, 333, 1000, 1777, 2000),
                                (0, 65, 191, 700, 1203, 1300, 2048))):
        for i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
            seg[row, a:b] = i + 1
    return seg.cuda()


def _flash_phase(torch, fa, errs):
    """flash_fwd / flash_bwd cases a-j against the plain version (see the module
    docstring); the largest errors go into ``errs``."""
    errs.update({"flash_fwd": 0.0, "flash_bwd": 0.0})

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
    note(_kernel_case(torch, fa, "e", 2, 4096, 32, 8, causal=True, seg=_packed_segments(torch)))
    # head_dim 128: the Qwen3-MoE slice's shape, and main path 6's packed rows of 2048
    note(_kernel_case(torch, fa, "f", 4, 2048, 32, 4, causal=True, d=128))
    note(_kernel_case(torch, fa, "g", 2, 4096, 32, 4, causal=True, seg=_packed_segments(torch),
                      d=128))
    # the edges of the tiles: a length that is no multiple of 64 or 128, segment
    # boundaries inside a tile without the causal mask, and a grid smaller than the card
    note(_kernel_case(torch, fa, "h", 2, 1000, 32, 8, causal=True))
    note(_kernel_case(torch, fa, "h", 2, 1000, 32, 8, causal=True, d=128))
    note(_kernel_case(torch, fa, "i", 2, 2048, 8, 8, causal=False, seg=_inner_segments(torch),
                      d=128))
    note(_kernel_case(torch, fa, "j", 1, 4096, 4, 1, causal=True, d=128))


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


def _flash_timing_inputs(torch, b, s, h, kh, d, device="cuda"):
    """The tensors a flash timing row times, (q, k, v, dO) at head dim ``d``, and the
    work they hold (:func:`_flash_work`)."""
    q, k, v, do = _inputs(torch, b, s, h, kh, d, seed=1, device=device)
    return (q, k, v, do), _flash_work(q, k, v)


def _timings(torch, fa, b=4, s=2048, h=32, kh=8, d=64):
    """ms of each kernel at shape (a), or at the shape given, with bound, plain version
    and SDPA. The work behind the bound is read from the timed tensors."""
    (q, k, v, do), work = _flash_timing_inputs(torch, b, s, h, kh, d)
    scale = q.shape[-1]**-0.5
    out = {}

    o, lse = fa.flash_fwd(q, k, v, None, None, scale, True)
    fwd_ms = _time_ms(torch, lambda: fa.flash_fwd(q, k, v, None, None, scale, True))
    bwd_ms = _time_ms(torch, lambda: fa.flash_bwd(q, k, v, None, None, o, lse, do, scale, True))
    # the plain tensor work that flash_bwd's wrapper does around its kernel (delta =
    # rowsum(dO * O), dq's zeroing and bf16 cast), inside flash_bwd's time
    bwd_plain_ops = _time_ms(torch, lambda: (
        (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous(),
        torch.zeros(q.shape, dtype=torch.float32, device="cuda").to(torch.bfloat16)))
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
    for name, ms, plain, lib in (("flash_fwd", fwd_ms, plain_fwd, lib_fwd),
                                 ("flash_bwd", bwd_ms, plain_bwd, lib_bwd)):
        flops, nbytes = work[name]
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "shape": {"B": b, "S": s, "H": h, "KH": kh, "D": q.shape[-1]}}
        if name == "flash_bwd":
            out[name]["plain_tensor_ops_ms"] = bwd_plain_ops
        print(f"time {name} at B={b} S={s} H={h} KH={kh} D={q.shape[-1]} causal: {ms:.3f} ms, "
              f"bound {out[name]['bound_ms']:.3f} ms ({out[name]['bound_by']}: "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), plain {plain:.3f} ms, "
              f"SDPA {lib:.3f} ms" + (f", of it plain tensor ops {bwd_plain_ops:.3f} ms"
                                      if name == "flash_bwd" else ""), flush=True)
    return out


def _ring_layout(torch, b, cp, s_loc, h, kh, d, seed, seg=None, positions=None,
                 device="cuda"):
    """Row-form inputs of one folded ring from global (B, S, H, D) bf16 tensors: q / dO
    (B*cp*H, S_loc, D), k / v (B*cp*KH, S_loc, D), positions / segments (B*cp, S_loc)."""
    g = torch.Generator(device=device).manual_seed(seed)
    s = cp * s_loc
    q, k, v, do = (torch.randn(b, s, n, d, device=device, generator=g).to(torch.bfloat16)
                   for n in (h, kh, kh, h))
    if positions is None:
        positions = torch.arange(s, device=device, dtype=torch.int32).expand(b, s)

    def rows(x):
        x = x.reshape(b * cp, s_loc, x.shape[2], d)
        return x.transpose(1, 2).reshape(-1, s_loc, d).contiguous()

    def ids(x):
        return None if x is None else x.reshape(b * cp, s_loc).to(torch.int32).contiguous()

    return [rows(x) for x in (q, k, v, do)] + [ids(positions), ids(seg)]


def _plain_chunk_fwd(q, k, v, pq, pkv, sq, skv, acc, m, l, **kw):
    from automodel_tpu_torch.ops import ring_chunk as rc

    for dst, src in zip((acc, m, l), rc.chunk_attention_fwd_reference(
            q, k, v, pq, pkv, sq, skv, acc, m, l, **kw)):
        dst.copy_(src)


def _plain_chunk_bwd(q, k, v, pq, pkv, sq, skv, do, lse, delta, dq, dk, dv, **kw):
    from automodel_tpu_torch.ops import ring_chunk as rc

    for dst, src in zip((dq, dk, dv), rc.chunk_attention_bwd_reference(
            q, k, v, pq, pkv, sq, skv, do, lse, delta, **kw)):
        dst.add_(src)


def _counted_tiles(torch, label, launch, cls, heads):
    """One more launch, given a tile-count buffer: the (q tile, kv tile) pairs the kernel
    skipped, left partial and ran full must equal tile_classes' ``cls`` times ``heads``
    (the kernel counts over every head its grid holds)."""
    from automodel_tpu_torch.ops import ring_chunk as rc

    expected = [int((cls == c).sum()) * heads for c in (rc.SKIP, rc.PARTIAL, rc.FULL)]
    counts = torch.zeros(3, dtype=torch.int32, device="cuda")
    launch(tile_counts=counts)
    tiles = dict(zip(("skip", "partial", "full"), counts.tolist()))
    print(f"tiles of {label}: {tiles} counted by the kernel, "
          f"{dict(zip(tiles, expected))} expected by tile_classes", flush=True)
    if list(tiles.values()) != expected:
        raise AssertionError(f"{label}: the kernel's tile classes disagree with tile_classes")
    return tiles


def _ring_case_tiles(torch, name, q, k, v, do, pos, sid, kw):
    """The tiles ring_fwd and ring_bwd count at the case's diagonal ring step (each
    shard's q against its own kv), on scratch carries and accumulators, held against
    tile_classes."""
    from automodel_tpu_torch.ops import ring_chunk as rc

    f32 = dict(dtype=torch.float32, device="cuda")
    rows = q.shape[:2]
    cls = {bq: rc.tile_classes(pos, pos, sid, sid, kw["causal"], kw["window"], bq, 128)
           for bq in (128, 64)}
    _counted_tiles(torch, f"ring_fwd in ring case {name}", lambda **c: rc.ring_fwd(
        q, k, v, pos, pos, sid, sid, torch.zeros(q.shape, **f32), torch.full(rows, -1e30, **f32),
        torch.zeros(rows, **f32), **kw, **c), cls[128], kw["n_heads"])
    _counted_tiles(torch, f"ring_bwd in ring case {name}", lambda **c: rc.ring_bwd(
        q, k, v, pos, pos, sid, sid, do, torch.zeros(rows, **f32), torch.zeros(rows, **f32),
        torch.zeros(q.shape, **f32), torch.zeros(k.shape, **f32), torch.zeros(v.shape, **f32),
        **kw, **c), cls[64], kw["n_heads"] // kw["groups"])


def _ring_case(torch, name, cp, b, s_loc, h, kh, d=128, causal=True, window=None, seg=None,
               positions=None):
    """One full folded ring forward and backward through ring_fwd / ring_bwd against the
    same ring through their plain version (f32 from the same bf16 inputs), and the tiles
    the kernels count at the diagonal step against tile_classes."""
    from automodel_tpu_torch.parallel import ring_attention as ra

    q, k, v, do, pos, sid = _ring_layout(torch, b, cp, s_loc, h, kh, d, seed=cp + s_loc + d,
                                         seg=seg, positions=positions)
    rot = ra.FoldedRotation(cp)
    kw = dict(scale=d**-0.5, causal=causal, window=window, groups=h // kh, n_heads=h)
    out, lse = ra.ring_flash_forward(q, k, v, pos, pos, sid, sid, rot, kw)
    grads = ra.ring_flash_backward(q, k, v, pos, pos, sid, sid, out, lse, do, rot, kw)
    torch.cuda.synchronize()
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    out_ref, lse_ref = ra.ring_flash_forward(qf, kf, vf, pos, pos, sid, sid, rot, kw,
                                             chunk_fwd=_plain_chunk_fwd)
    grads_ref = ra.ring_flash_backward(qf, kf, vf, pos, pos, sid, sid, out_ref, lse_ref, dof, rot,
                                       kw, chunk_bwd=_plain_chunk_bwd)
    err_o = (out.float() - out_ref).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    rel = [_rel_l2(a, r) for a, r in zip(grads, grads_ref)]
    err_grad = max((a.float() - r).abs().max().item() for a, r in zip(grads, grads_ref))
    print(f"ring case {name}: cp={cp} folded, B={b} S_local={s_loc} H={h} KH={kh} D={d} "
          f"causal={causal} window={window} segments={seg is not None} "
          f"positions={'given' if positions is not None else 'arange'}: "
          f"O max abs {err_o:.3e} (tol {TOL_O}), lse max abs {err_lse:.3e} (tol {TOL_LSE}), "
          f"grad rel L2 dq {rel[0]:.3e} dk {rel[1]:.3e} dv {rel[2]:.3e} (tol {TOL_GRAD})",
          flush=True)
    if not (err_o <= TOL_O and err_lse <= TOL_LSE and max(rel) <= TOL_GRAD):
        raise AssertionError(f"ring case {name}: kernels disagree with the plain version")
    _ring_case_tiles(torch, name, q, k, v, do, pos, sid, kw)
    del q, k, v, do, out, lse, grads, qf, kf, vf, dof, out_ref, lse_ref, grads_ref
    torch.cuda.empty_cache()
    return err_o, err_grad


def _packed_ring_segments(torch, b, s, seed=0):
    """(B, S) segment ids and positions as pack_dataset lays them out: documents of
    500-3000 tokens, positions restarting at 0 in each, a tail of padding (segment 0,
    position 0)."""
    rng = __import__("random").Random(seed)
    seg = torch.zeros(b, s, dtype=torch.int32)
    pos = torch.zeros(b, s, dtype=torch.int32)
    for row in range(b):
        start, doc = 0, 1
        while True:
            n = rng.randint(500, 3000)
            if start + n > s - 100:
                break
            seg[row, start:start + n] = doc
            pos[row, start:start + n] = torch.arange(n, dtype=torch.int32)
            start, doc = start + n, doc + 1
    return seg.cuda(), pos.cuda()


def _ring_phase(torch, errs):
    """Ring kernel cases a-f against the plain version: (a) the slice's shape (cp 8
    folded, B 1, S_local 4096, H 32, KH 8, D 128, causal); (b) packed segments with
    positions restarting per document; (c) the round-robin layout of
    test_interleaved_positions_load_balance; (d) a sliding window; (e) D 64, KH 2,
    non-causal; (f) a ragged local length (S_local 1000, cp 3)."""
    errs.update({"ring_fwd": 0.0, "ring_bwd": 0.0})

    def note(e):
        errs["ring_fwd"] = max(errs["ring_fwd"], e[0])
        errs["ring_bwd"] = max(errs["ring_bwd"], e[1])

    note(_ring_case(torch, "a", 8, 1, 4096, 32, 8))
    seg, pos = _packed_ring_segments(torch, 2, 4 * 2048)
    note(_ring_case(torch, "b", 4, 2, 2048, 32, 8, seg=seg, positions=pos))
    s = 4 * 2048
    order = torch.arange(s, dtype=torch.int32).reshape(4, -1).t().reshape(-1)
    note(_ring_case(torch, "c", 4, 1, 2048, 32, 8, positions=order.cuda()[None]))
    note(_ring_case(torch, "d", 4, 1, 2048, 32, 8, window=1024))
    note(_ring_case(torch, "e", 4, 1, 2048, 16, 2, d=64, causal=False))
    note(_ring_case(torch, "f", 3, 1, 1000, 32, 8))


# ring case (a), the attention of main path 7: cp 8 folded, B 1, S_local 4096, H 32, KH 8,
# D 128, causal, contiguous shards
RING_A = dict(cp=8, b=1, s_loc=4096, h=32, kh=8, d=128)


def _ring_step_inputs(torch, step, cp, b, s_loc, h, kh, d, device="cuda"):
    """The tensors of one ring_fwd / ring_bwd launch at ring step ``step`` of a causal ring
    over contiguous shards (seed 5): q / dO of every shard and the kv bundle rotated
    ``step`` times by FoldedRotation, so shard r holds the k, v and positions of shard
    (r - step) mod cp; with the launch's allowed (q, k) pairs over every head and the
    shards that have any."""
    from automodel_tpu_torch.ops import ring_chunk as rc
    from automodel_tpu_torch.parallel import ring_attention as ra

    q, k, v, do, pos, _ = _ring_layout(torch, b, cp, s_loc, h, kh, d, seed=5, device=device)
    bundle = (k.view(b * cp, kh, s_loc, d), v.view(b * cp, kh, s_loc, d), pos)
    rot = ra.FoldedRotation(cp)
    for _ in range(step):
        bundle = rot(bundle)
    per_shard = rc.allowed_mask(pos, bundle[2], None, None, True, None).flatten(1).sum(1)
    return {"q": q, "k": bundle[0].flatten(0, 1).contiguous(),
            "v": bundle[1].flatten(0, 1).contiguous(), "do": do, "pos_q": pos,
            "pos_kv": bundle[2].contiguous(), "pairs": int(per_shard.sum()) * h,
            "live": int((per_shard > 0).sum())}


def _ring_work(x, h, kh, d):
    """FLOP and bytes of one ring_fwd / ring_bwd launch on :func:`_ring_step_inputs`'s
    tensors: the allowed pairs' products, and each input read once and each output
    written once on the shards with any allowed pair (the carry and the f32
    accumulators are read and written)."""
    s_loc = x["q"].shape[1]
    qkv = 2 * s_loc * d * (h + 2 * kh)
    ids = 4 * 2 * s_loc
    carry = 2 * 4 * (h * s_loc * d + 2 * h * s_loc)
    grads = 2 * 4 * s_loc * d * (h + 2 * kh)
    rows = 4 * 2 * h * s_loc  # lse, delta
    return {"ring_fwd": (4 * d * x["pairs"], x["live"] * (qkv + ids + carry)),
            "ring_bwd": (10 * d * x["pairs"],
                         x["live"] * (qkv + ids + 2 * h * s_loc * d + rows + grads))}


def _ring_launches(torch, steps):
    """Per ring step of ``steps`` at RING_A: its inputs and one call each of ring_fwd and
    ring_bwd through the wrappers as every checkout since the kernels were ported has
    them (keywords given to a call go on to the wrapper), on the carry of a fresh ring and the lse / delta of one whole ring forward;
    and that state (``kw``, ``out``, ``lse``, ``delta``, ``acc``, ``m``, ``l``)."""
    from automodel_tpu_torch.ops import ring_chunk as rc
    from automodel_tpu_torch.parallel import ring_attention as ra

    a = RING_A
    kw = dict(scale=a["d"]**-0.5, causal=True, window=None, groups=a["h"] // a["kh"],
              n_heads=a["h"])
    base = _ring_step_inputs(torch, 0, **a)
    q, do, pos = base["q"], base["do"], base["pos_q"]
    out, lse = ra.ring_flash_forward(q, base["k"], base["v"], pos, pos, None, None,
                                     ra.FoldedRotation(a["cp"]), kw)
    delta = (out.float() * do.float()).sum(-1)
    f32 = dict(dtype=torch.float32, device="cuda")
    acc, m, l = (torch.zeros(q.shape, **f32), torch.full(q.shape[:2], -1e30, **f32),
                 torch.zeros(q.shape[:2], **f32))
    dq = torch.zeros(q.shape, **f32)
    dk, dv = (torch.zeros(base["k"].shape, **f32) for _ in range(2))
    calls = {}
    for step in steps:
        x = base if step == 0 else _ring_step_inputs(torch, step, **a)
        k, v, pkv = x["k"], x["v"], x["pos_kv"]
        calls[step] = (x, (lambda k=k, v=v, pkv=pkv, **more: rc.ring_fwd(
                           q, k, v, pos, pkv, None, None, acc, m, l, **kw, **more)),
                       (lambda k=k, v=v, pkv=pkv, **more: rc.ring_bwd(
                           q, k, v, pos, pkv, None, None, do, lse, delta, dq, dk, dv, **kw,
                           **more)))
    return calls, dict(kw=kw, out=out, lse=lse, delta=delta, acc=acc, m=m, l=l)


def _ring_timings(torch):
    """ms of ring_fwd / ring_bwd a launch at case (a)'s diagonal ring step beside the
    bound and the plain version, and at ring step 1 (every shard's chunk wholly allowed
    or wholly skipped: 7 of 8 allowed) and step cp - 1 (7 of 8 wholly skipped), each
    beside its own bound; a bound counts the allowed (q, k) pairs of its step. At each step
    one more launch of each kernel counts the tiles it skipped, left partial and ran full
    (``tile_counts``), and those counts must equal what tile_classes expects. Then, as a
    comparison, the whole ring (cp launches and the rotations) against the port's
    flash_fwd / flash_bwd and SDPA on the unsharded sequence."""
    from automodel_tpu_torch.ops import flash_attention as fa, ring_chunk as rc
    from automodel_tpu_torch.parallel import ring_attention as ra

    a = RING_A
    cp, b, s_loc, h, kh, d = (a[n] for n in ("cp", "b", "s_loc", "h", "kh", "d"))
    calls, st = _ring_launches(torch, (0, 1, cp - 1))
    out = {"ring_fwd": {}, "ring_bwd": {}}
    for step, (x, fwd, bwd) in calls.items():
        work = _ring_work(x, h, kh, d)
        for name, fn, block_q, heads in (("ring_fwd", fwd, 128, h), ("ring_bwd", bwd, 64, kh)):
            cls = rc.tile_classes(x["pos_q"], x["pos_kv"], None, None, True, None, block_q, 128)
            tiles = _counted_tiles(torch, f"{name} at ring step {step}", fn, cls, heads)
            ms = _time_ms(torch, fn, warmup=2, reps=10)
            flops, nbytes = work[name]
            t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            row = {"ms": ms, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes", "tiles": tiles}
            print(f"time {name} at ring step {step} of cp={cp} folded B={b} S_local={s_loc} "
                  f"H={h} KH={kh} D={d} causal: {ms:.3f} ms a launch, bound "
                  f"{row['bound_ms']:.3f} ms ({row['bound_by']}: {flops / 1e12:.3f} TFLOP over "
                  f"the step's allowed pairs; {nbytes / 1e6:.1f} MB), {x['live']} of {b * cp} "
                  f"shards with allowed pairs (allowed_mask)", flush=True)
            if step == 0:
                out[name].update(row)
            else:
                out[name].setdefault("steps", {})[str(step)] = row
    for name in out:
        steps = out[name]["steps"]
        out[name]["skip_ratio"] = steps[str(cp - 1)]["ms"] / steps["1"]["ms"]
        print(f"{name}: a launch at ring step {cp - 1} takes {out[name]['skip_ratio']:.3f}x "
              f"the time of one at step 1", flush=True)

    x, kw = calls[0][0], st["kw"]
    q, k, v, do, pos = x["q"], x["k"], x["v"], x["do"], x["pos_q"]
    del calls, x
    torch.cuda.empty_cache()
    out["ring_fwd"]["plain_ms"] = _time_ms(torch, lambda: rc.chunk_attention_fwd_reference(
        q, k, v, pos, pos, None, None, st["acc"], st["m"], st["l"], **kw), warmup=1, reps=3)
    out["ring_bwd"]["plain_ms"] = _time_ms(torch, lambda: rc.chunk_attention_bwd_reference(
        q, k, v, pos, pos, None, None, do, st["lse"], st["delta"], **kw), warmup=1, reps=3)
    rot = ra.FoldedRotation(cp)
    ring_fwd_all = _time_ms(torch, lambda: ra.ring_flash_forward(q, k, v, pos, pos, None, None,
                                                                 rot, kw), warmup=1, reps=3)
    ring_bwd_all = _time_ms(torch, lambda: ra.ring_flash_backward(
        q, k, v, pos, pos, None, None, st["out"], st["lse"], do, rot, kw), warmup=1, reps=3)
    del st, q, k, v, do
    torch.cuda.empty_cache()
    for name in out:
        out[name].update({"library_ms": None,
                          "library": "no single PyTorch call computes a carried ring step"})
        print(f"time {name} at the diagonal ring step: plain {out[name]['plain_ms']:.3f} ms",
              flush=True)

    # comparison: the whole ring against one attention call over the unsharded sequence
    s = cp * s_loc
    qg, kg, vg, dog = _inputs(torch, b, s, h, kh, d)
    scale = d**-0.5
    o, lse_g = fa.flash_fwd(qg, kg, vg, None, None, scale, True)
    flash_fwd_ms = _time_ms(torch, lambda: fa.flash_fwd(qg, kg, vg, None, None, scale, True),
                            warmup=1, reps=3)
    flash_bwd_ms = _time_ms(torch, lambda: fa.flash_bwd(qg, kg, vg, None, None, o, lse_g, dog,
                                                        scale, True), warmup=1, reps=3)
    del o, lse_g
    sdpa_fwd_ms = _time_ms(torch, lambda: _library_sdpa(torch, qg, kg, vg, True), warmup=1,
                           reps=3)
    ql, kl, vl = (x.clone().requires_grad_() for x in (qg, kg, vg))
    o_lib = _library_sdpa(torch, ql, kl, vl, True)
    sdpa_bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(o_lib, (ql, kl, vl), dog,
                                                              retain_graph=True),
                           warmup=1, reps=3)
    flash_bound = {}  # flash's bound at (L), from the timed tensors
    for name, (flops, nbytes) in _flash_work(qg, kg, vg).items():
        flash_bound[name] = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
    del o_lib, ql, kl, vl, qg, kg, vg, dog
    torch.cuda.empty_cache()
    comparison = {"S": s, "ring_fwd_whole_ms": ring_fwd_all, "ring_bwd_whole_ms": ring_bwd_all,
                  "flash_fwd_ms": flash_fwd_ms, "flash_bwd_ms": flash_bwd_ms,
                  "flash_fwd_bound_ms": flash_bound["flash_fwd"],
                  "flash_bwd_bound_ms": flash_bound["flash_bwd"],
                  "sdpa_fwd_ms": sdpa_fwd_ms, "sdpa_bwd_ms": sdpa_bwd_ms}
    print(f"comparison at S={s} (B={b} H={h} KH={kh} D={d} causal): the whole folded ring "
          f"(cp={cp} launches and rotations) forward {ring_fwd_all:.3f} ms, backward "
          f"{ring_bwd_all:.3f} ms; flash_fwd {flash_fwd_ms:.3f} ms (bound "
          f"{flash_bound['flash_fwd']:.3f} ms), flash_bwd {flash_bwd_ms:.3f} ms (bound "
          f"{flash_bound['flash_bwd']:.3f} ms) on the unsharded sequence; SDPA forward "
          f"{sdpa_fwd_ms:.3f} ms, backward {sdpa_bwd_ms:.3f} ms", flush=True)
    out["ring_fwd"]["comparison_unsharded"] = comparison
    return out


def _ring_model_check(torch):
    """Ring attention (the ring kernels) against context_parallel allgather (the flash
    kernels) on the same weights: Llama-3-8B width, 2 layers, seq 8192, cp 4 folded, bf16."""
    from automodel_tpu_torch.data.collate import sft_collate
    from automodel_tpu_torch.data.llm.mock import MockSFTDataset
    from automodel_tpu_torch.models.common.backend import BackendConfig
    from automodel_tpu_torch.models.llama.model import LlamaForCausalLM
    from automodel_tpu_torch.ops.losses import masked_cross_entropy
    from automodel_tpu_torch.parallel.mesh import MeshContext

    hf = dict(LLAMA3_8B, num_hidden_layers=2)
    ds = MockSFTDataset(hf["vocab_size"], 8192, num_samples=1, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in sft_collate([ds[0]], 8192).items()}
    mesh = MeshContext(cp=4)
    results = {}
    for mode in ("ring", "allgather"):
        backend = BackendConfig(attention="flash", context_parallel=mode, remat_policy="dots",
                                dtype="bfloat16")
        model = LlamaForCausalLM.from_config(
            hf, backend, device="cuda", dtype=torch.bfloat16,
            generator=torch.Generator(device="cuda").manual_seed(0))
        params = model.param_dict()
        _reset_counts()
        logits = model(batch["input_ids"], positions=batch["positions"],
                       segment_ids=batch["segment_ids"], mesh=mesh)
        loss = masked_cross_entropy(logits, batch["labels"])
        grads = torch.autograd.grad(loss, list(params.values()))
        counts = _read_counts()
        results[mode] = (loss.item(), torch.cat([g.float().flatten() for g in grads]), counts)
        del model, params, logits, grads
        torch.cuda.empty_cache()
    d_loss = abs(results["ring"][0] - results["allgather"][0])
    rel = _rel_l2(results["ring"][1], results["allgather"][1])
    routes = (results["ring"][2]["ring_fwd"] > 0 and results["ring"][2]["flash_fwd"] == 0
              and results["allgather"][2]["flash_fwd"] > 0
              and results["allgather"][2]["ring_fwd"] == 0)
    print(f"ring model check (2 layers, Llama-3-8B width, seq 8192, cp 4 folded, bf16): loss "
          f"ring {results['ring'][0]:.6f} allgather {results['allgather'][0]:.6f} |diff| "
          f"{d_loss:.3e} (tol {TOL_MODEL_LOSS}), grad rel L2 {rel:.3e} (tol {TOL_MODEL_GRAD}); "
          f"launches ring {results['ring'][2]} allgather {results['allgather'][2]}", flush=True)
    if not (d_loss <= TOL_MODEL_LOSS and rel <= TOL_MODEL_GRAD and routes):
        raise AssertionError("ring attention disagrees with allgather through the model")


# the process-group ring (``--cp-processes N``, one process per card): Llama-3-8B heads
# over a 32768-token sequence at cp 4
PG_S_LOCAL, PG_H, PG_KH, PG_D = 8192, 32, 8, 128
# process-group ring against the fold: the same kernels on the same shards in the same
# step order; only dq's atomicAdd order differs between runs
TOL_PG_OUT, TOL_PG_GRAD = 1e-6, 1e-4


def _pg_inputs(torch, cp):
    """Global bf16 q, k, v, dO drawn on the CPU from one seed, so every process holds the
    same numbers."""
    g = torch.Generator().manual_seed(17)
    return [torch.randn(1, cp * PG_S_LOCAL, n, PG_D, generator=g).to(torch.bfloat16)
            for n in (PG_H, PG_KH, PG_KH, PG_H)]


def _pg_ring_step(torch, ring, q, k, v, do):
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    out = ring(qq, kk, vv)
    return out.detach(), torch.autograd.grad(out, (qq, kk, vv), do)


def _pg_ring_rank(out_dir: str) -> None:
    """One rank of the process-group ring: its shard on card RANK, kv bundles passed with
    batch_isend_irecv over NCCL; writes its output, gradients and time to out_dir."""
    import torch
    import torch.distributed as dist

    from automodel_tpu_torch.parallel.init import initialize_distributed
    from automodel_tpu_torch.parallel.ring_attention import (ProcessGroupRotation,
                                                             ring_attention_local)

    info = initialize_distributed(device="cuda", timeout_s=120)
    rank, cp = info.rank, info.world_size
    sl = slice(rank * PG_S_LOCAL, (rank + 1) * PG_S_LOCAL)
    q, k, v, do = (x[:, sl].cuda() for x in _pg_inputs(torch, cp))
    pos = torch.arange(sl.start, sl.stop, dtype=torch.int32, device="cuda")[None]
    rot = ProcessGroupRotation()

    def ring(a, b, c):
        return ring_attention_local(a, b, c, pos, pos, rotation=rot)

    out, grads = _pg_ring_step(torch, ring, q, k, v, do)
    times = []
    for _ in range(3):
        dist.barrier()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _pg_ring_step(torch, ring, q, k, v, do)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    torch.save({"out": out.cpu(), "grads": [g.cpu() for g in grads],
                "ms": sorted(times)[1]}, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _pg_ring_phase(torch, nproc: int) -> dict:
    """The process-group ring over ``nproc`` cards (one process each, NCCL) against the
    fold of the same ring on card 0: outputs and gradients, and the forward + backward
    time of each."""
    import socket

    from automodel_tpu_torch.parallel.mesh import MeshContext
    from automodel_tpu_torch.parallel.ring_attention import make_ring_attention

    if torch.cuda.device_count() < nproc:
        raise RuntimeError(f"--cp-processes {nproc} needs {nproc} cards, found "
                           f"{torch.cuda.device_count()}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        code = (f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke; "
                f"chip_smoke._pg_ring_rank({out_dir!r})")
        procs, logs = [], []
        for rank in range(nproc):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(nproc),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0].decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode != 0 for p in procs):
            raise AssertionError("process-group ring failed:\n" + "\n".join(logs))
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(nproc)]

    q, k, v, do = (x.cuda() for x in _pg_inputs(torch, nproc))
    pos = torch.arange(q.shape[1], dtype=torch.int32, device="cuda")[None]
    fold = make_ring_attention(MeshContext(cp=nproc))

    def ring(a, b, c):
        return fold(a, b, c, pos)

    out, grads = _pg_ring_step(torch, ring, q, k, v, do)
    fold_ms = _time_ms(torch, lambda: _pg_ring_step(torch, ring, q, k, v, do), warmup=1, reps=3)
    err_out, rel = 0.0, 0.0
    for r, got in enumerate(ranks):
        sl = slice(r * PG_S_LOCAL, (r + 1) * PG_S_LOCAL)
        err_out = max(err_out, (got["out"].cuda().float() - out[:, sl].float()).abs().max().item())
        rel = max(rel, *(_rel_l2(g.cuda(), w[:, sl]) for g, w in zip(got["grads"], grads)))
    pg_ms = max(got["ms"] for got in ranks)
    print(f"process-group ring: {nproc} processes on {nproc} cards (NCCL batch_isend_irecv), "
          f"B=1 S={nproc * PG_S_LOCAL} (S_local {PG_S_LOCAL}) H={PG_H} KH={PG_KH} D={PG_D} "
          f"causal, against the fold of the same ring on one card: O max abs {err_out:.3e} "
          f"(tol {TOL_PG_OUT}), grad rel L2 {rel:.3e} (tol {TOL_PG_GRAD}); forward + backward "
          f"{pg_ms:.3f} ms (slowest rank) against {fold_ms:.3f} ms folded on one card",
          flush=True)
    if not (err_out <= TOL_PG_OUT and rel <= TOL_PG_GRAD):
        raise AssertionError("the process-group ring disagrees with the fold")
    return {"processes": nproc, "S": nproc * PG_S_LOCAL, "max_abs_err_out": err_out,
            "grad_rel_l2": rel, "pg_ms": pg_ms, "fold_ms": fold_ms}


def _router_group_sizes(torch, tokens, d, e, k, seed=0):
    """(E,) int32 rows per expert from a softmax top-k router on random weights: the
    router's (T, D) x (D, E) product at init scale, as the MoE layer routes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(tokens, d, device="cuda", generator=g).to(torch.bfloat16)
    wg = (torch.randn(e, d, device="cuda", generator=g) * 0.02).to(torch.bfloat16)
    idx = torch.topk(torch.softmax(x.float() @ wg.float().t(), -1), k, -1).indices.reshape(-1)
    return torch.zeros(e, dtype=torch.int32, device="cuda").scatter_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int32))


def _gmm_inputs(torch, sizes, d, f, seed, extra=0):
    """x, w, dout with N = sum(sizes) + ``extra`` rows (rows past the groups)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = int(sizes.sum()) + extra
    x = torch.randn(n, d, device="cuda", generator=g).to(torch.bfloat16)
    w = (torch.randn(sizes.numel(), d, f, device="cuda", generator=g) / d**0.5).to(torch.bfloat16)
    dout = torch.randn(n, f, device="cuda", generator=g).to(torch.bfloat16)
    return x, w, dout


def _gmm_case(torch, name, sizes, d, f, extra=0):
    """gmm (forward, dX) and tgmm (dW) against the plain version in f32 from the same
    bf16 inputs; dW of an empty expert must be exactly zero, and so must out and dX on
    the ``extra`` rows past the groups; each gmm launch must take the route the wrapper
    names for its shapes."""
    from automodel_tpu_torch.ops import grouped_gemm as gg

    x, w, dout = _gmm_inputs(torch, sizes, d, f, seed=d + f, extra=extra)
    routes = {"forward": gg.gmm_route(x, w), "dX": gg.gmm_route(dout, w, transpose_w=True),
              "dW": gg.tgmm_route(x, dout)}
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = dict(gg.ROUTE_LAUNCHES)
    out = gg.grouped_matmul(xk, wk, sizes)
    dx, dw = torch.autograd.grad(out, (xk, wk), dout)
    torch.cuda.synchronize()
    taken = {k: gg.ROUTE_LAUNCHES[k] - before[k] for k in before}
    want = {k: sum(f"{'tgmm' if part == 'dW' else 'gmm'}/{r}" == k for part, r in routes.items())
            for k in before}
    xr, wr = x.float().requires_grad_(), w.float().requires_grad_()
    ref = gg.grouped_matmul_reference(xr, wr, sizes)
    rdx, rdw = torch.autograd.grad(ref, (xr, wr), dout.float())
    rel = [_rel_l2(a, r) for a, r in ((out, ref), (dx, rdx), (dw, rdw))]
    empty = sizes == 0
    n_empty = int(empty.sum())
    empty_ok = n_empty == 0 or bool((dw[empty] == 0).all())
    past = x.shape[0] - extra
    tail_ok = bool((out[past:] == 0).all() and (dx[past:] == 0).all())
    print(f"gmm case {name}: N={x.shape[0]} D={d} F={f} E={sizes.numel()} ({n_empty} empty, "
          f"largest {int(sizes.max())} rows, {extra} rows past the groups): rel L2 out "
          f"{rel[0]:.3e} dX {rel[1]:.3e} dW {rel[2]:.3e} (tol {TOL_GMM}), dW of empty experts "
          f"exactly 0: {empty_ok}, out and dX past the groups exactly 0: {tail_ok}; routes "
          f"gmm forward {routes['forward']}, gmm dX {routes['dX']}, tgmm {routes['dW']} "
          f"(launched {taken})", flush=True)
    if not (max(rel) <= TOL_GMM and empty_ok and tail_ok):
        raise AssertionError(f"gmm case {name}: kernels disagree with the plain version")
    if taken != want:
        raise AssertionError(f"gmm case {name}: routes launched {taken}, named {want}")
    err_gmm = max((out.float() - ref).abs().max().item(), (dx.float() - rdx).abs().max().item())
    err_tgmm = (dw.float() - rdw).abs().max().item()
    del x, w, dout, xk, wk, out, dx, dw, xr, wr, ref, rdx, rdw
    torch.cuda.empty_cache()
    return err_gmm, err_tgmm


def _library_grouped_mm(torch, x, w, dout, ends):
    """The yardsticks: ``torch._grouped_mm`` for the forward, dX (w transposed in place)
    and dW where this torch has it, timed here and used nowhere in the port; else one
    cuBLAS ``torch.matmul`` of the same FLOPs. Returns (name, forward fn, dX fn, dW fn)."""
    if hasattr(torch, "_grouped_mm"):
        fwd = (lambda: torch._grouped_mm(x, w, offs=ends))
        dx = (lambda: torch._grouped_mm(dout, w.transpose(-2, -1), offs=ends))
        dw = (lambda: torch._grouped_mm(x.t(), dout, offs=ends))
        try:
            fwd(), dx(), dw()
            torch.cuda.synchronize()
            return f"torch._grouped_mm (torch {torch.__version__})", fwd, dx, dw
        except RuntimeError as exc:
            print(f"  torch._grouped_mm refused these operands: {str(exc).splitlines()[0]}")
    w0 = w[0].contiguous()
    return ("torch.matmul stand-in of the same FLOPs", lambda: torch.matmul(x, w0),
            lambda: torch.matmul(dout, w0.t()), lambda: torch.matmul(x.t(), dout))


def _gmm_work(n, d, f, e, live):
    """FLOPs and bytes of gmm's forward, its dX and tgmm at N routed rows, D, F, E
    experts of which ``live`` have rows (only their weights are read); each input read
    once, each output written once, plus the (E,) int32 group offsets."""
    flops = 2 * n * d * f
    return {"forward": (flops, 2 * (n * d + live * d * f + n * f) + 4 * e),
            "dX": (flops, 2 * (n * f + live * d * f + n * d) + 4 * e),
            "tgmm": (flops, 2 * (n * d + n * f + e * d * f) + 4 * e)}


# where each grouped GEMM timing goes in the kernels line: case a's forward and tgmm
# are the rows themselves (None), the rest keyed sub-rows
_GMM_ROW_KEYS = {("forward", "a"): None, ("forward", "b"): "at_case_b", ("dX", "a"): "dx",
                 ("dX", "b"): "dx_at_case_b", ("tgmm", "a"): None, ("tgmm", "b"): "at_case_b"}


def _gmm_timings(torch, sizes):
    """ms of gmm (forward and dX) and tgmm (dW) at the slice's gate_up (a) and down (b)
    shapes, with bound, plain version and yardstick."""
    from automodel_tpu_torch.ops import grouped_gemm as gg

    out = {"gmm": {}, "tgmm": {}}
    e = sizes.numel()
    live = int((sizes > 0).sum())
    ends = gg._ends(sizes)
    for case, d, f in (("a", 2048, 1536), ("b", 768, 2048)):
        x, w, dout = _gmm_inputs(torch, sizes, d, f, seed=11)
        n = x.shape[0]
        work = _gmm_work(n, d, f, e, live)
        name, lib_fwd, lib_dx, lib_dw = _library_grouped_mm(torch, x, w, dout, ends)
        xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
        ref = gg.grouped_matmul_reference(xp, wp, sizes)
        times = {
            "forward": (_time_ms(torch, lambda: gg.gmm(x, w, ends)),
                        _time_ms(torch, lambda: gg.grouped_matmul_reference(x, w, sizes),
                                 warmup=1, reps=5),
                        _time_ms(torch, lib_fwd), gg.gmm_route(x, w)),
            "dX": (_time_ms(torch, lambda: gg.gmm(dout, w, ends, transpose_w=True)),
                   _time_ms(torch, lambda: torch.autograd.grad(ref, xp, dout, retain_graph=True),
                            warmup=1, reps=5),
                   _time_ms(torch, lib_dx), gg.gmm_route(dout, w, transpose_w=True)),
            "tgmm": (_time_ms(torch, lambda: gg.tgmm(x, dout, ends, e)),
                     _time_ms(torch, lambda: torch.autograd.grad(ref, wp, dout,
                                                                 retain_graph=True),
                              warmup=1, reps=5),
                     _time_ms(torch, lib_dw), gg.tgmm_route(x, dout))}
        for part, (ms, plain, lib, route) in times.items():
            flops, nbytes = work[part]
            t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            row = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library": name,
                   "route": route}
            kname = "tgmm" if part == "tgmm" else "gmm"
            key = _GMM_ROW_KEYS[part, case]
            if key is None:
                out[kname].update(row)
            else:
                out[kname][key] = row
            label = kname if part == kname else f"{kname} {part}"
            print(f"time {label} case {case} at N={n} D={d} F={f} E={e} ({route}): "
                  f"{ms:.3f} ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}: "
                  f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), plain {plain:.3f} ms, "
                  f"yardstick {lib:.3f} ms ({name})", flush=True)
        del x, w, dout, xp, wp, ref
        torch.cuda.empty_cache()
    return out


def _gmm_phase(torch, errs):
    """Grouped GEMM cases a-f and timings. a / b: the slice's gate_up and down shapes
    with group sizes from a softmax top-8 router over 8192 tokens and 128 experts; c:
    empty head / mid / tail experts, N not a tile multiple, D = 1000 and F = 1003; d:
    one expert owning every row, D = 1003 (rows of x and the K of dW not 16-byte
    aligned); e: D = 16, F = 24, N = 30 with an empty expert, on the wgmma route with
    every dimension inside one tile (TMA boxes past the tensor's edges); f: c's group
    sizes with 300 rows past the groups at D = 256, F = 512, on the wgmma route (its
    tail tiles zero those rows); g: tgmm's wgmma route with every kind of last K step
    (experts of 1, 63, 64, 65, 127 and 200 rows, one empty, 37 rows past the groups
    whose x must not enter the last expert's dW)."""
    sizes = _router_group_sizes(torch, 8192, 2048, 128, 8)
    ragged = torch.tensor([0, 0, 300, 0, 77, 5, 0, 1, 134, 0, 0], dtype=torch.int32,
                          device="cuda")
    owner = torch.tensor([0, 1000, 0, 0], dtype=torch.int32, device="cuda")
    small = torch.tensor([5, 0, 11, 14], dtype=torch.int32, device="cuda")
    tails = torch.tensor([1, 63, 64, 65, 127, 0, 200], dtype=torch.int32, device="cuda")
    errs.update({"gmm": 0.0, "tgmm": 0.0})
    for case in (("a", sizes, 2048, 1536), ("b", sizes, 768, 2048),
                 ("c", ragged, 1000, 1003), ("d", owner, 1003, 1000), ("e", small, 16, 24),
                 ("f", ragged, 256, 512, 300), ("g", tails, 256, 512, 37)):
        err_gmm, err_tgmm = _gmm_case(torch, *case)
        errs["gmm"] = max(errs["gmm"], err_gmm)
        errs["tgmm"] = max(errs["tgmm"], err_tgmm)
    return _gmm_timings(torch, sizes)


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


def _counters():
    from automodel_tpu_torch.ops import flash_attention as fa, grouped_gemm as gg, linear_ce as lce
    from automodel_tpu_torch.ops import ring_chunk as rc

    return fa.LAUNCHES, lce.LAUNCHES, gg.LAUNCHES, rc.LAUNCHES


def _reset_counts():
    for counter in (*_counters(), *_route_counters()):
        for key in counter:
            counter[key] = 0


def _read_counts() -> dict:
    return {k: v for counter in _counters() for k, v in counter.items()}


def _route_counters():
    from automodel_tpu_torch.ops import grouped_gemm as gg, linear_ce as lce

    return gg.ROUTE_LAUNCHES, lce.ROUTE_LAUNCHES


ROUTED = ("gmm", "tgmm", "lce_fwd", "lce_bwd")  # the kernels with a wgmma and an mma_sync route


def _read_routes() -> dict:
    """Launches of the routed kernels by route ("gmm/wgmma", "lce_fwd/mma_sync", ...)."""
    return {k: v for counter in _route_counters() for k, v in counter.items()}


def _check_routes(name, launches) -> dict:
    """Every launch of gmm, tgmm, lce_fwd and lce_bwd on a main path must have taken
    the wgmma route; returns the launches with the route counts added."""
    routes = _read_routes()
    print(f"{name}: launches by route {routes}", flush=True)
    for kernel in ROUTED:
        if routes[f"{kernel}/wgmma"] != launches.get(kernel, 0):
            raise AssertionError(f"{name}: {launches.get(kernel, 0)} {kernel} launches, "
                                 f"{routes[f'{kernel}/wgmma']} of them on the wgmma route")
    return {**launches, **routes}


def _release():
    """Free what earlier phases left behind: a recipe's reference cycles keep its model
    and optimizer state alive until the collector runs, and the benchmark's peak memory
    counts everything alive in the process."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _expected(layers, micro, steps, linear_ce, moe=False, ring_cp=1, val_batches=0):
    """Launches of each kernel in a run, n = layers x microbatches x steps.

    flash_fwd 2n (the forward, and once more when each layer's checkpoint replays it),
    flash_bwd n; lce_fwd and lce_bwd once a microbatch with linear_ce; an MoE layer's
    two expert GEMMs (gate_up, down) each launch gmm three times (the forward, the
    replay, dX) and tgmm once (dW): gmm 6n, tgmm 2n. With ring attention over cp > 1
    (``ring_cp``) the ring kernels take flash's place, once per ring step: ring_fwd
    2n x cp, ring_bwd n x cp. Validation runs forward only, with no layer checkpoint:
    ``val_batches`` (over all passes) add flash_fwd once a layer and lce_fwd once each."""
    n = layers * micro * steps
    lce_n = micro * steps if linear_ce else 0
    ring = ring_cp > 1
    return {"flash_fwd": 0 if ring else 2 * n + layers * val_batches,
            "flash_bwd": 0 if ring else n,
            "lce_fwd": lce_n + (val_batches if linear_ce else 0), "lce_bwd": lce_n,
            "gmm": 6 * n if moe else 0, "tgmm": 2 * n if moe else 0,
            "ring_fwd": 2 * n * ring_cp if ring else 0, "ring_bwd": n * ring_cp if ring else 0}


def _ring_cp(cfg) -> int:
    """The cp of a config whose attention runs the ring, else 1."""
    if cfg.get("backend.context_parallel", "allgather") != "ring":
        return 1
    return int(cfg.get("distributed.cp", 1) or 1)


def random_init_loss(vocab: int, hidden: int, std: float) -> float:
    """The cross entropy of random labels under random weights: the logits of the normed
    hidden state through W ~ N(0, std^2) have variance hidden * std^2, so the loss is
    about ln(vocab) + hidden * std^2 / 2 (0.41 over ln(vocab) at hidden 2048, 0.82 at
    4096)."""
    return math.log(vocab) + hidden * std**2 / 2


def _shown(yaml: str) -> str:
    """A config's path for the log: relative to the checkout, or the derived file's name."""
    rel = os.path.relpath(yaml, HERE)
    return os.path.basename(yaml) if rel.startswith("..") else rel


def _bench_path(name, yaml, linear_ce, overrides=()):
    """The benchmark recipe at full width, through its entry point."""
    from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
    from automodel_tpu_torch.recipes.llm import benchmark

    _release()
    cfg = parse_args_and_load_config(["-c", yaml, *overrides])
    layers = int(cfg.model.config.num_hidden_layers)
    micro = int(cfg.get("step_scheduler.grad_acc_steps", 1))
    with tempfile.TemporaryDirectory() as out_dir:
        argv = ["-c", yaml, *overrides, "--benchmark.warmup_steps", str(WARMUP),
                "--benchmark.timed_steps", str(TIMED), "--output_dir", out_dir]
        _reset_counts()
        result = benchmark.main(argv=argv)
        launches = _read_counts()
    vocab = int(cfg.model.config.vocab_size)
    want = _expected(layers, micro, WARMUP + TIMED, linear_ce,
                     moe=bool(cfg.model.config.get("num_experts")), ring_cp=_ring_cp(cfg))
    print(f"{name}: benchmark recipe on {_shown(yaml)} ({layers} layers, "
          f"{micro} microbatch, mb {cfg.micro_batch_size}, seq {cfg.seq_len}, loss "
          f"{cfg.get('loss.name')}, tied {cfg.model.config.get('tie_word_embeddings')}), {WARMUP} warmup + {TIMED} timed steps: "
          f"{result['tokens_per_sec']:.1f} tokens/s, step {result['step_time_s'] * 1e3:.1f} ms, "
          f"MFU {result['mfu']}, peak memory {result['peak_memory_gib']} GiB, losses "
          f"{result['losses']}, launches {launches} (expected {want})", flush=True)
    hidden = int(cfg.model.config.hidden_size)
    std = float(cfg.model.config.get("initializer_range", 0.02))
    want_loss = random_init_loss(vocab, hidden, std)
    if not all(math.isfinite(x) for x in result["losses"]):
        raise AssertionError(f"non-finite loss on {name}")
    if abs(result["loss"] - want_loss) > 0.5:
        raise AssertionError(f"{name}: loss {result['loss']} is not within 0.5 of "
                             f"ln({vocab}) + {hidden} * {std}^2 / 2 = {want_loss:.3f}")
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} != expected {want}")
    return _check_routes(name, launches), result["losses"]


def _train_ft_path(name, yaml, overrides):
    """train_ft through its entry point with the default loss (the vocab rule picks
    linear_ce), packed rows, TRAIN_FT_STEPS steps; an MoE model must log moe_load/*
    rows. The peak device memory is the run's, model and optimizer included."""
    import torch

    from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
    from automodel_tpu_torch.recipes.llm import train_ft

    _release()
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = parse_args_and_load_config([
            "-c", yaml, *overrides, "--step_scheduler.max_steps", str(TRAIN_FT_STEPS),
            "--checkpoint.enabled", "false", "--output_dir", out_dir])
        if cfg.get("loss") is not None:
            cfg.loss._data.pop("name", None)  # the default rule picks the loss
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        recipe = train_ft.main(cfg=cfg)
        launches = _read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(out_dir, "training.jsonl")) as f:
            rows = [r for r in map(json.loads, f) if "loss" in r]
    layers = int(cfg.model.config.num_hidden_layers)
    micro = int(cfg.get("step_scheduler.grad_acc_steps", 1))
    moe = bool(cfg.model.config.get("num_experts"))
    want = _expected(layers, micro, TRAIN_FT_STEPS, True, moe, ring_cp=_ring_cp(cfg))
    losses = [r["loss"] for r in rows]
    moe_rows = [sorted(k for k in r if k.startswith("moe_load/")) for r in rows]
    print(f"{name}: train_ft on {_shown(yaml)} ({layers} layers), default loss "
          f"{recipe.loss_name}, packed rows of {recipe.seq_len}, {len(rows)} training.jsonl "
          f"rows: losses {losses}, step times {[r['step_time_s'] for r in rows]} s, "
          f"peak memory {peak_gib} GiB, moe_load rows {len(moe_rows[0]) if moe_rows else 0} keys, launches {launches} "
          f"(expected {want})", flush=True)
    if recipe.loss_name != "linear_ce" or len(rows) != TRAIN_FT_STEPS:
        raise AssertionError(f"{name}: wrong loss or missing training.jsonl rows")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss")
    if moe and not all(moe_rows):
        raise AssertionError(f"{name}: training.jsonl rows without moe_load/* metrics")
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} != expected {want}")
    return _check_routes(name, launches)


def _recorded_train_ft(cfg):
    """Run train_ft through its recipe class, recording each step's loss unrounded (the
    training.jsonl rows round to 6 digits). Returns (recipe, {step: loss}, rows of
    training.jsonl, rows of validation.jsonl)."""
    from automodel_tpu_torch.recipes.llm import train_ft

    recipe = train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg)
    recipe.setup()
    first = recipe.step_scheduler.step + 1
    losses = []
    step_fn = recipe._train_step

    def recorded(opt_state, stack):
        opt_state, m = step_fn(opt_state, stack)
        losses.append(float(m["loss"]))
        return opt_state, m

    recipe._train_step = recorded
    recipe.run_train_validation_loop()
    rows = {}
    for name in ("training", "validation"):
        with open(os.path.join(recipe.output_dir, f"{name}.jsonl")) as f:
            rows[name] = [r for r in map(json.loads, f) if "run_header" not in r]
    return recipe, {first + i: x for i, x in enumerate(losses)}, rows["training"], \
        rows["validation"]


def _baseline_path(name):
    """BASELINE config #1 through train_ft (main path 9): a local pretrained directory,
    HellaSwag rows through the tokenizer, the prefetch pipeline, validation and a
    checkpoint (with the consolidated HF export) every 2 steps. Run A runs 4 steps fresh;
    then its step_4 is removed and run B resumes in the same checkpoint directory from
    step 2. Returns the launches of both runs."""
    import shutil

    import torch

    from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
    from automodel_tpu_torch.models.auto import AutoModelForCausalLM

    _release()
    with tempfile.TemporaryDirectory() as tmp:
        hf_dir = write_pretrained(os.path.join(tmp, "llama3_2_1b"))
        yaml = baseline_config(
            tmp, hf_dir, write_hellaswag_jsonl(os.path.join(tmp, "train.jsonl"), 512, seed=0),
            write_hellaswag_jsonl(os.path.join(tmp, "val.jsonl"), 64, seed=1))
        ckpt = os.path.join(tmp, "ckpts")
        runs = {}
        for run in ("A", "B"):
            if run == "B":  # the walk-back must find step 2
                shutil.rmtree(os.path.join(ckpt, f"step_{BASELINE_STEPS}"))
            cfg = parse_args_and_load_config(["-c", yaml, *baseline_args(ckpt), "--output_dir",
                                              os.path.join(tmp, f"run_{run}")])
            _reset_counts()
            torch.cuda.reset_peak_memory_stats()
            recipe, losses, rows, val_rows = _recorded_train_ft(cfg)
            launches = _read_counts()
            runs[run] = dict(recipe=recipe, losses=losses, rows=rows, val=val_rows,
                             launches=launches, routed=_check_routes(f"{name} run {run}", launches),
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            if run == "A":  # its consolidated HF export against its final parameters
                step_hf = os.path.join(ckpt, f"step_{BASELINE_STEPS}", "hf")
                reloaded = AutoModelForCausalLM.from_pretrained(step_hf, dtype=torch.float32,
                                                                device="cuda").param_dict()
                runs[run]["hf_differ"] = sorted(k for k, v in recipe.params.items()
                                               if not torch.equal(v, reloaded[k]))
                runs[run]["hf_bytes"] = sum(os.path.getsize(os.path.join(step_hf, f))
                                            for f in os.listdir(step_hf))
                del reloaded
            del recipe
            runs[run].pop("recipe")
            _release()
    layers = LLAMA32_1B["num_hidden_layers"]
    micro = 4  # the config's grad_acc_steps
    a, b = runs["A"], runs["B"]
    for run, r in runs.items():
        saves = [x for x in r["rows"] if x.get("event") == "checkpoint_save"]
        restores = [x for x in r["rows"] if x.get("event") == "checkpoint_restore"]
        print(f"{name} run {run}: train_ft on {_shown(BASELINE_YAML)} (model and data sections "
              f"swapped; {layers} layers, prefetch), losses {r['losses']}, step times "
              f"{[x['step_time_s'] for x in r['rows'] if 'loss' in x]} s, validation "
              f"{[(x['step'], x['val_loss']) for x in r['val']]}, saves "
              f"{[(x['step'], x['seconds'], x['bytes']) for x in saves]} (step, s, bytes), "
              f"restores {[(x['step'], x['seconds']) for x in restores]} (step, s), peak memory "
              f"{r['peak_gib']:.2f} GiB, launches {r['launches']}", flush=True)
    print(f"{name}: step_{BASELINE_STEPS}/hf {a['hf_bytes']} bytes, reloaded through "
          f"from_pretrained: {'bitwise equal' if not a['hf_differ'] else a['hf_differ']}; run B "
          f"from step {min(b['losses'])}: step-3 loss |diff| "
          f"{abs(b['losses'].get(3, math.nan) - a['losses'][3]):.3e} (bitwise "
          f"{b['losses'].get(3) == a['losses'][3]}), step-4 |diff| "
          f"{abs(b['losses'].get(4, math.nan) - a['losses'][4]):.3e} (tol {TOL_RESUME_LOSS})",
          flush=True)
    if sorted(a["losses"]) != list(range(1, BASELINE_STEPS + 1)) or sorted(b["losses"]) != [3, 4]:
        raise AssertionError(f"{name}: run A stepped {sorted(a['losses'])}, run B "
                             f"{sorted(b['losses'])} (B must resume from step 2)")
    if not all(math.isfinite(x) for r in runs.values() for x in r["losses"].values()):
        raise AssertionError(f"{name}: non-finite loss")
    if b["losses"][3] != a["losses"][3]:
        raise AssertionError(f"{name}: the resumed step-3 loss differs from the uninterrupted")
    if abs(b["losses"][4] - a["losses"][4]) > TOL_RESUME_LOSS:
        raise AssertionError(f"{name}: the resumed step-4 loss is off by more than "
                             f"{TOL_RESUME_LOSS}")
    val_steps = [x["step"] for x in a["val"] if x.get("val_loss") is not None
                 and math.isfinite(x["val_loss"])]
    if val_steps != [2, 4]:
        raise AssertionError(f"{name}: finite validation.jsonl rows at steps {val_steps}")
    if a["hf_differ"]:
        raise AssertionError(f"{name}: hf/ reloaded differs from the final parameters in "
                             f"{a['hf_differ']}")
    want_a = _expected(layers, micro, BASELINE_STEPS, True,
                       val_batches=2 * BASELINE_VAL_BATCHES)
    want_b = _expected(layers, micro, 2, True, val_batches=BASELINE_VAL_BATCHES)
    if a["launches"] != want_a or b["launches"] != want_b:
        raise AssertionError(f"{name}: kernel launches A {a['launches']} B {b['launches']} != "
                             f"expected A {want_a} B {want_b}")
    return {k: a["routed"][k] + b["routed"][k] for k in a["routed"]}


def _moe_model_check(torch):
    """Qwen3-MoE at the slice widths, 1 layer, bf16: the kernels (flash attention, gmm and
    tgmm) against the plain versions (xla attention, the grouped GEMM's reference,
    swapped in by this script) on the same weights and batch. Routing is held fixed
    (fake_balanced_gate): a bf16 near-tie could otherwise send a token to another expert
    when attention differs in the last bit."""
    from automodel_tpu_torch.data.collate import sft_collate
    from automodel_tpu_torch.data.llm.mock import MockSFTDataset
    from automodel_tpu_torch.models.common.backend import BackendConfig
    from automodel_tpu_torch.models.qwen3_moe.model import Qwen3MoeForCausalLM
    from automodel_tpu_torch.moe import experts
    from automodel_tpu_torch.ops import grouped_gemm as gg
    from automodel_tpu_torch.ops.losses import masked_cross_entropy

    hf = dict(QWEN3_30B_A3B, num_hidden_layers=1, architectures=["Qwen3MoeForCausalLM"])
    ds = MockSFTDataset(hf["vocab_size"], 2048, num_samples=2, seed=0)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in sft_collate([ds[i] for i in range(2)], 2048).items()}
    results = {}
    for kernels in (True, False):
        backend = BackendConfig(attention="flash" if kernels else "xla", remat_policy="mlp_dots",
                                dtype="bfloat16", experts_backend="pallas",
                                fake_balanced_gate=True)
        model = Qwen3MoeForCausalLM.from_config(
            hf, backend, device="cuda", dtype=torch.bfloat16,
            generator=torch.Generator(device="cuda").manual_seed(0))
        params = [p for n, p in model.param_dict().items() if not n.endswith("gate.weight")]
        experts.grouped_matmul = gg.grouped_matmul if kernels else gg.grouped_matmul_reference
        try:
            logits, _ = model(batch["input_ids"], positions=batch["positions"],
                              segment_ids=batch["segment_ids"])
            loss = masked_cross_entropy(logits, batch["labels"])
            grads = torch.autograd.grad(loss, params)
        finally:
            experts.grouped_matmul = gg.grouped_matmul
        results[kernels] = (loss.item(), torch.cat([g.float().flatten() for g in grads]))
        del model, params, logits, grads
        torch.cuda.empty_cache()
    d_loss = abs(results[True][0] - results[False][0])
    rel = _rel_l2(results[True][1], results[False][1])
    print(f"MoE model check (1 layer, Qwen3-30B-A3B width, bf16, fixed routing): loss kernels "
          f"{results[True][0]:.6f} plain {results[False][0]:.6f} |diff| {d_loss:.3e} (tol "
          f"{TOL_MOE_LOSS}), grad rel L2 {rel:.3e} (tol {TOL_MOE_GRAD})", flush=True)
    if not (d_loss <= TOL_MOE_LOSS and rel <= TOL_MOE_GRAD):
        raise AssertionError("the MoE model's kernels disagree with the plain versions")


def _lce_inputs(torch, n, e, v, seed, h_scale=1.0, tied=False):
    """h ~ N(0, h_scale^2) (normed hidden states), w ~ N(0, 0.02^2) (the init), 10%
    ignored labels; bf16 on the card. ``tied``: w is a row-major (V, E) embedding (the
    caller passes w.t() as the unembedding)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = (torch.randn(n, e, device="cuda", generator=g) * h_scale).to(torch.bfloat16)
    shape = (v, e) if tied else (e, v)
    w = (torch.randn(*shape, device="cuda", generator=g) * 0.02).to(torch.bfloat16)
    labels = torch.randint(0, v, (n,), device="cuda", generator=g)
    labels[torch.rand(n, device="cuda", generator=g) < 0.1] = -100
    return h, w, labels


def _lce_case(torch, name, n, e, v, filter_eps=None, h_scale=1.0, tied=False):
    """Kernel z, dH, dW against the plain version from the same bf16 inputs. The
    upstream gradient is the loss's: 1 for a valid label, 0 for an ignored one.
    ``tied``: the unembedding is the transpose of a row-major (V, E) embedding, and
    dW is the embedding's gradient."""
    from automodel_tpu_torch.ops import linear_ce as lce
    from automodel_tpu_torch.ops import losses

    h, w, labels = _lce_inputs(torch, n, e, v, seed=n + e + v, h_scale=h_scale, tied=tied)
    unembed = (lambda x: x.t()) if tied else (lambda x: x)
    dz = (labels != -100).float()
    route = lce.lce_bwd_route(h, *lce.kernel_operand(unembed(w)))
    fwd_route = lce.lce_fwd_route(h, *lce.kernel_operand(unembed(w)))
    hk, wk = h.clone().requires_grad_(), w.clone().requires_grad_()
    before = dict(lce.ROUTE_LAUNCHES)
    z, _ = losses.fused_linear_ce_tokens(hk, unembed(wk), labels, filter_eps=filter_eps)
    grads = torch.autograd.grad(z, (hk, wk), dz)
    torch.cuda.synchronize()
    taken = {k: lce.ROUTE_LAUNCHES[k] - before[k] for k in before}
    out = {}
    refs = [("plain", filter_eps)] + ([("exact", None)] if filter_eps is not None else [])
    for ref_name, eps in refs:
        hr, wr = h.float().requires_grad_(), w.float().requires_grad_()
        z_ref = lce.fused_logsumexp_reference(hr, unembed(wr), eps)
        g_ref = torch.autograd.grad(z_ref, (hr, wr), dz)
        out[ref_name] = ((z - z_ref).abs().max().item(),
                         [_rel_l2(a, r) for a, r in zip(grads, g_ref)],
                         max((a.float() - r).abs().max().item() for a, r in zip(grads, g_ref)))
        del hr, wr, z_ref, g_ref
        torch.cuda.empty_cache()
    err_z, rel, err_grad = out["plain"]
    line = (f"lce case {name}: N={n} E={e} V={v} tied={tied} h_scale={h_scale} "
            f"filter_eps={filter_eps}, lce_fwd route {fwd_route}, lce_bwd route {route} "
            f"(launched {taken}): "
            f"z max abs {err_z:.3e} (tol {TOL_Z}), grad rel L2 dH {rel[0]:.3e} dW {rel[1]:.3e} "
            f"(tol {TOL_LCE_GRAD})")
    ok = err_z <= TOL_Z and max(rel) <= TOL_LCE_GRAD
    if taken != {k: int(k in (f"lce_fwd/{fwd_route}", f"lce_bwd/{route}")) for k in taken}:
        print(line, flush=True)
        raise AssertionError(f"lce case {name}: launched {taken}, named lce_fwd {fwd_route}, "
                             f"lce_bwd {route}")
    if filter_eps is not None:
        z_k, bmax = lce.lce_fwd(h, w, tied)  # the backward's own decision, from the forward
        sig = lce.block_significance(bmax, z_k, lce.TILE_N, math.log(filter_eps))
        skipped = 1.0 - sig.float().mean().item()
        ex = out["exact"][1]
        line += (f"; blocks skipped {skipped:.4f}; vs exact gradient rel L2 dH {ex[0]:.3e} "
                 f"dW {ex[1]:.3e} (bound {TOL_FILTER_EXACT})")
        ok = ok and skipped > 0 and max(ex) <= TOL_FILTER_EXACT
    print(line, flush=True)
    if not ok:
        raise AssertionError(f"lce case {name}: kernels disagree with the plain version")
    del h, w, hk, wk, z, grads
    torch.cuda.empty_cache()
    return err_z, err_grad


def _library_lse(torch, h, w):
    """The yardstick: one PyTorch call chain for the same z, timed here and used
    nowhere in the port (it forms the (N, V) logits)."""
    return torch.logsumexp((h @ w).float(), -1)


def _lce_timings(torch):
    """ms of each linear-CE kernel at shape (a), with bound, plain version and yardstick."""
    from automodel_tpu_torch.ops import linear_ce as lce

    n, e, v = 8192, 2048, 128256
    h, w, _ = _lce_inputs(torch, n, e, v, seed=7)
    dz = torch.ones(n, device="cuda")
    fwd_flops = 2 * n * e * v
    bwd_flops, bwd_bytes = _lce_work(n, e, v)
    fwd_bytes = _lce_fwd_bytes(n, e, v)
    z, _ = lce.lce_fwd(h, w)
    fwd_ms = _time_ms(torch, lambda: lce.lce_fwd(h, w))
    bwd_ms = _time_ms(torch, lambda: lce.lce_bwd(h, w, z, dz, None))
    plain_fwd = _time_ms(torch, lambda: lce.fused_logsumexp_reference(h, w), warmup=1, reps=5)
    hp, wp = h.clone().requires_grad_(), w.clone().requires_grad_()
    z_plain = lce.fused_logsumexp_reference(hp, wp)
    plain_bwd = _time_ms(torch, lambda: torch.autograd.grad(z_plain, (hp, wp), dz,
                                                            retain_graph=True), warmup=1, reps=5)
    del z_plain
    torch.cuda.empty_cache()
    lib_fwd = _time_ms(torch, lambda: _library_lse(torch, h, w), warmup=1, reps=5)
    hl, wl = h.clone().requires_grad_(), w.clone().requires_grad_()
    z_lib = _library_lse(torch, hl, wl)
    lib_bwd = _time_ms(torch, lambda: torch.autograd.grad(z_lib, (hl, wl), dz, retain_graph=True),
                       warmup=1, reps=5)
    del z_lib
    torch.cuda.empty_cache()
    out = {}
    for name, ms, flops, nbytes, plain, lib in (
            ("lce_fwd", fwd_ms, fwd_flops, fwd_bytes, plain_fwd, lib_fwd),
            ("lce_bwd", bwd_ms, bwd_flops, bwd_bytes, plain_bwd, lib_bwd)):
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        print(f"time {name} at N={n} E={e} V={v}: {ms:.3f} ms, bound "
              f"{out[name]['bound_ms']:.3f} ms ({out[name]['bound_by']}: {flops / 1e12:.2f} "
              f"TFLOP, {nbytes / 1e6:.1f} MB), plain {plain:.3f} ms, yardstick {lib:.3f} ms",
              flush=True)
    out["lce_fwd"]["route"] = lce.lce_fwd_route(h, w)
    out["lce_bwd"]["route"] = lce.lce_bwd_route(h, w)
    del h, w, z, dz
    torch.cuda.empty_cache()
    out["lce_fwd"]["at_path7_shape"], out["lce_bwd"]["at_path7_shape"] = _lce_timing_large(torch)
    return out


def _lce_work(n, e, v):
    """FLOPs and bytes of lce_bwd at (N, E, V): 6NEV (the recompute and two products);
    h and w read, z and dz read, dH and dW written."""
    return 6 * n * e * v, 2 * 2 * (n * e + e * v) + 4 * n * 2


def _lce_fwd_bytes(n, e, v):
    """Bytes of lce_fwd at (N, E, V): h and w read, z (N,) and bmax (ceil(V/128), N)
    written, all once."""
    return 2 * (n * e + e * v) + 4 * n + 4 * -(-v // 128) * n


def _lce_timing_large(torch):
    """Rows of lce_fwd and lce_bwd at main path 7's shape (N = 32768 tokens, E = 4096,
    V = 128,256) beside their bounds. lce_fwd also beside its plain version and
    yardstick, each of which forms the f32 (N, V) logits (16.8 GB) and logsumexp's
    two temporaries of that size: where the card cannot hold them, the row says so.
    lce_bwd has neither: with autograd's gradient of the logits they need ~70 GB."""
    from automodel_tpu_torch.ops import linear_ce as lce

    n, e, v = 32768, LLAMA3_8B["hidden_size"], LLAMA3_8B["vocab_size"]
    h, w, _ = _lce_inputs(torch, n, e, v, seed=9)
    dz = torch.ones(n, device="cuda")
    z, _ = lce.lce_fwd(h, w)
    chunk = lce.lce_chunk(n, v)
    times = {"lce_fwd": (_time_ms(torch, lambda: lce.lce_fwd(h, w), warmup=1, reps=5),
                         2 * n * e * v, _lce_fwd_bytes(n, e, v), lce.lce_fwd_route(h, w)),
             "lce_bwd": (_time_ms(torch, lambda: lce.lce_bwd(h, w, z, dz, None), warmup=1,
                                  reps=5), *_lce_work(n, e, v), lce.lce_bwd_route(h, w))}
    del z, dz
    torch.cuda.empty_cache()
    rows = {}
    for name, (ms, flops, nbytes, route) in times.items():
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        rows[name] = {"ms": ms, "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                      "plain_ms": None, "library_ms": None, "route": route,
                      "shape": {"N": n, "E": e, "V": v},
                      "library": "not timed: with autograd the f32 logits need ~70 GB"}
        if name == "lce_bwd":
            rows[name]["chunk"] = chunk
        print(f"time {name} at N={n} E={e} V={v} ({route}"
              + (f", vocab chunks of {chunk}" if name == "lce_bwd" else "")
              + f"): {ms:.3f} ms, bound {rows[name]['bound_ms']:.3f} ms "
              f"({rows[name]['bound_by']}: {flops / 1e12:.2f} TFLOP, {nbytes / 1e6:.1f} MB)",
              flush=True)
    fwd = rows["lce_fwd"]
    for key, fn in (("library_ms", lambda: _library_lse(torch, h, w)),
                    ("plain_ms", lambda: lce.fused_logsumexp_reference(h, w))):
        try:
            fwd[key] = _time_ms(torch, fn, warmup=1, reps=3)
        except torch.cuda.OutOfMemoryError as exc:  # the row keeps None and the reason
            fwd[f"{key}_note"] = f"not timed: {str(exc).splitlines()[0][:160]}"
        torch.cuda.empty_cache()
    fwd["library"] = "torch.logsumexp((h @ w).float(), -1)"
    print(f"time lce_fwd at N={n} E={e} V={v}: plain {fwd['plain_ms']} ms, yardstick "
          f"{fwd['library_ms']} ms", flush=True)
    del h, w
    torch.cuda.empty_cache()
    return rows["lce_fwd"], rows["lce_bwd"]


def _kernel_times(torch):
    """ms of gmm (forward and dX) and tgmm at the slice's shapes (a) and (b), of lce_fwd
    and lce_bwd at N=8192, E=2048, V=128,256 and at main path 7's shape, and of ring_fwd
    and ring_bwd at ring case (a)'s diagonal step and step 1, on the inputs their timing
    rows use, called only through the wrapper calls that the package has had since the
    kernels were ported (``gmm(x, w, ends, transpose_w)``, ``tgmm(x, dout, ends, e)``,
    ``lce_fwd(h, w)``, ``lce_bwd(h, w, z, dz, None)``, ``ring_fwd(q, k, v, pos_q,
    pos_kv, seg_q, seg_kv, acc, m, l, **kw)``, ``ring_bwd(...)``), so that
    ``--kernel-times ROOT`` can time an older checkout's kernels beside this one's."""
    from automodel_tpu_torch.ops import grouped_gemm as gg
    from automodel_tpu_torch.ops import linear_ce as lce

    out = {}
    sizes = _router_group_sizes(torch, 8192, 2048, 128, 8)
    ends = gg._ends(sizes)
    for case, d, f in (("a", 2048, 1536), ("b", 768, 2048)):
        x, w, dout = _gmm_inputs(torch, sizes, d, f, seed=11)
        out[f"gmm forward {case}"] = _time_ms(torch, lambda: gg.gmm(x, w, ends))
        out[f"gmm dX {case}"] = _time_ms(torch, lambda: gg.gmm(dout, w, ends, transpose_w=True))
        out[f"tgmm {case}"] = _time_ms(torch, lambda: gg.tgmm(x, dout, ends, sizes.numel()))
        del x, w, dout
    for shape, n, e, seed, reps in (("N=8192 E=2048", 8192, 2048, 7, 20),
                                    ("N=32768 E=4096", 32768, LLAMA3_8B["hidden_size"], 9, 5)):
        h, w, _ = _lce_inputs(torch, n, e, LLAMA3_8B["vocab_size"], seed=seed)
        dz = torch.ones(n, device="cuda")
        z, _ = lce.lce_fwd(h, w)
        out[f"lce_fwd {shape}"] = _time_ms(torch, lambda: lce.lce_fwd(h, w), warmup=1, reps=reps)
        out[f"lce_bwd {shape}"] = _time_ms(torch, lambda: lce.lce_bwd(h, w, z, dz, None),
                                           warmup=1, reps=reps)
        del h, w, z, dz
        torch.cuda.empty_cache()
    calls, state = _ring_launches(torch, (0, 1))
    for step, (_, fwd, bwd) in calls.items():
        label = "diagonal step" if step == 0 else f"step {step}"
        out[f"ring_fwd (a) {label}"] = _time_ms(torch, fwd, warmup=2, reps=10)
        out[f"ring_bwd (a) {label}"] = _time_ms(torch, bwd, warmup=2, reps=10)
    del calls, state
    torch.cuda.empty_cache()
    for name, ms in out.items():
        print(f"kernel time {name}: {ms:.3f} ms", flush=True)
    return out


def _lce_memory(torch):
    """Peak device memory one forward and backward of linear_cross_entropy adds over
    its inputs (h, w, labels) and outputs (their gradients), at shape (a)."""
    from automodel_tpu_torch.ops import losses

    h, w, labels = _lce_inputs(torch, 8192, 2048, 128256, seed=3)
    h.requires_grad_()
    w.requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = losses.linear_cross_entropy(h, w, labels, impl="pallas")
    loss.backward()
    torch.cuda.synchronize()
    grads = h.grad.numel() * 2 + w.grad.numel() * 2
    extra = (torch.cuda.max_memory_allocated() - base - grads) / 1e9
    print(f"lce memory: one forward + backward of linear_cross_entropy at N=8192 E=2048 "
          f"V=128256 adds {extra:.3f} GB of peak over inputs and outputs "
          f"(limit {LCE_PEAK_LIMIT_GB} GB; loss {loss.item():.4f})", flush=True)
    if extra >= LCE_PEAK_LIMIT_GB:
        raise AssertionError("linear_cross_entropy formed a tensor as large as the logits")
    del h, w, labels, loss
    torch.cuda.empty_cache()
    return extra


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if argv and not ((argv[0] == "--cp-processes" and len(argv) == 2)
                     or (argv[0] == "--kernel-times" and len(argv) <= 2)):
        print("usage: chip_smoke.py [--cp-processes N | --kernel-times [ROOT]]",
              file=sys.stderr)
        return 2
    root = os.path.abspath(argv[1]) if argv[:1] == ["--kernel-times"] and argv[1:] else HERE
    if not os.path.isdir(os.path.join(root, "automodel_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(f"card: {_card_line()}", flush=True)

    from automodel_tpu_torch.kernels import build
    from automodel_tpu_torch.ops import flash_attention as fa

    # the plain versions and the yardsticks are f32 / bf16 products in full precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    seconds = build.build_all()
    print(f"build: {seconds:.1f} s", flush=True)
    for source, log in build.BUILD_LOGS.items():
        for line in _ptxas_report(log):
            print(f"  {source}: {line}")
    if argv:  # one option, one phase, and nothing else
        # --cp-processes N: the process-group ring across N cards; --kernel-times [ROOT]:
        # the grouped GEMM, linear-CE and ring kernels of the package in ROOT (default:
        # this checkout)
        print(json.dumps({"process_group_ring": _pg_ring_phase(torch, int(argv[1]))}
                         if argv[0] == "--cp-processes"
                         else {"kernel_times": _kernel_times(torch), "package": root}))
        print(f"card: {_card_line()}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    errs = {}
    _flash_phase(torch, fa, errs)
    timings = _timings(torch, fa)
    for name, row in _timings(torch, fa, 4, 2048, 32, 4, 128).items():
        timings[name]["at_d128"] = row
    _model_check(torch)

    errs.update({"lce_fwd": 0.0, "lce_bwd": 0.0})
    for case in (("a", 8192, 2048, 128256), ("b", 8192, 2048, 128256, 1e-7, 32.0),
                 ("c", 8190, 2048, 50257), ("d", 4096, 4096, 128256),
                 ("e", 8192, 2048, 128256, 1e-7, 32.0, True), ("f", 1024, 1000, 50257),
                 ("g", 256, 1003, 3001, None, 1.0, True), ("h", 256, 8, 16, None, 1.0, True),
                 ("i", 1024, 1000, 50264)):
        err_z, err_grad = _lce_case(torch, *case)
        errs["lce_fwd"] = max(errs["lce_fwd"], err_z)
        errs["lce_bwd"] = max(errs["lce_bwd"], err_grad)
    timings.update(_lce_timings(torch))
    _lce_memory(torch)
    timings.update(_gmm_phase(torch, errs))
    _moe_model_check(torch)
    _ring_phase(torch, errs)
    timings.update(_ring_timings(torch))
    _ring_model_check(torch)

    by_path, losses = {}, {}
    by_path["main path 1"], losses[1] = _bench_path("main path 1", BENCH_YAML, linear_ce=False)
    by_path["main path 2"], _ = _bench_path("main path 2", SEQ4096_YAML, linear_ce=True)
    by_path["main path 3"] = _train_ft_path(
        "main path 3", SEQ4096_YAML, ["--packed_sequence.packed_sequence_size", "4096",
                                      "--dataset.seq_len", "1000",
                                      "--backend.attention_segments", "true"])
    by_path["main path 4"], losses[4] = _bench_path("main path 4", BENCH_YAML, linear_ce=True,
                                                    overrides=("--loss.name", "linear_ce"))
    d_first = abs(losses[4][0] - losses[1][0])
    print(f"main path 4 vs 1 (linear_ce, tied, vs masked_ce): first-step loss |diff| "
          f"{d_first:.3e} (tol {TOL_TIED_LOSS})", flush=True)
    if d_first > TOL_TIED_LOSS:
        raise AssertionError("main path 4: tied linear_ce disagrees with masked_ce")
    by_path["main path 5"], _ = _bench_path("main path 5", MOE_YAML, linear_ce=True,
                                            overrides=qwen3_args())
    by_path["main path 6"] = _train_ft_path(
        "main path 6", MOE_YAML, [*qwen3_args(MOE_LAYERS_TRAIN_FT),
                                  "--packed_sequence.packed_sequence_size", "2048",
                                  "--dataset.seq_len", "500"])
    with tempfile.TemporaryDirectory() as cfg_dir:
        cp_yaml = cp_config(cfg_dir)
        by_path["main path 7"], _ = _bench_path("main path 7", cp_yaml, linear_ce=True,
                                                overrides=llama3_8b_args())
        by_path["main path 8"] = _train_ft_path(
            "main path 8", cp_yaml, [*llama3_8b_args(CP_LAYERS_TRAIN_FT),
                                     "--packed_sequence.packed_sequence_size", "32768",
                                     "--dataset.seq_len", "4096"])
    by_path["main path 9"] = _baseline_path("main path 9")

    flash = "automodel_tpu/ops/pallas/flash_attention.py"
    lce_src = "automodel_tpu/ops/pallas/linear_ce.py"
    gmm_src = "automodel_tpu/ops/pallas/grouped_gemm.py"
    ring_src = "automodel_tpu/ops/pallas/ring_chunk.py"
    replaces = {"flash_fwd": (f"{flash}:84", []),
                "flash_bwd": (f"{flash}:192", [f"{flash}:151", f"{flash}:258"]),
                "lce_fwd": (f"{lce_src}:105", []),
                "lce_bwd": (f"{lce_src}:137", [f"{lce_src}:163"]),
                "gmm": (f"{gmm_src}:126", []),
                "tgmm": (f"{gmm_src}:151", []),
                "ring_fwd": (f"{ring_src}:110", []),
                "ring_bwd": (f"{ring_src}:204", [])}
    sources = {"flash_fwd": "flash_attention.cu", "flash_bwd": "flash_attention.cu",
               "lce_fwd": "linear_ce.cu", "lce_bwd": "linear_ce.cu",
               "gmm": "grouped_gemm.cu", "tgmm": "grouped_gemm.cu",
               "ring_fwd": "ring_chunk.cu", "ring_bwd": "ring_chunk.cu"}
    kernels = []
    for name in replaces:
        row = {"name": name, "route": "cuda",
               "source": f"automodel_tpu_torch/csrc/{sources[name]}",
               "replaces": replaces[name][0],
               "launches": sum(counts[name] for counts in by_path.values()),
               "max_abs_err": errs[name], **timings[name],
               "launches_by_path": {p: counts[name] for p, counts in by_path.items()}}
        if replaces[name][1]:
            row["replaces_by_function"] = replaces[name][1]
        if name in ROUTED:  # main-path launches by route
            row["launches_by_route"] = {
                r: sum(counts[f"{name}/{r}"] for counts in by_path.values())
                for r in ("wgmma", "mma_sync")}
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {_card_line()}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
