"""Benchmark recipe (counterpart of ``automodel_tpu/recipes/llm/benchmark.py``):
warmup and timed train steps on mock data, with every batch staged on the device
before the timed window. Reports tokens/s, step time, model TFLOP/s, MFU against the
card's bf16 peak, and the peak device memory; writes ``benchmark.json``. Like the
JAX recipe it never saves, so it accepts ``checkpoint.enabled`` (the default) and
ignores the section.

``benchmark.profile_start`` / ``profile_end`` (timed-step indices) and
``profile_dir`` trace those steps with ``torch.profiler`` (the JAX recipe's
jax.profiler window; the trace adds overhead inside the timed steps). The window
writes ``trace.json`` (Chrome trace), ``kernels.txt`` (device time by kernel) and
``summary.json`` (device-busy seconds, idle share, the top kernels, and the device time
of each named scope of the model, forward, replay and backward: ``utils/tracing.py``).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import time

import torch

from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.config.loader import ConfigNode
from automodel_tpu_torch.data.collate import stack_batches
from automodel_tpu_torch.recipes.llm.train_ft import TrainFinetuneRecipeForNextTokenPrediction
from automodel_tpu_torch.utils.flops import mfu
from automodel_tpu_torch.utils.tracing import scope_names, scope_times

logger = logging.getLogger(__name__)

__all__ = ["BenchmarkingRecipeForNextTokenPrediction", "main"]


class BenchmarkingRecipeForNextTokenPrediction(TrainFinetuneRecipeForNextTokenPrediction):
    saves_checkpoints = False  # like the JAX benchmark: checkpoint.* is read by nobody

    def setup(self):
        super().setup()
        if self.cfg.get("checkpoint.enabled", True):
            logger.info("benchmark recipe: saves no checkpoint (checkpoint.enabled ignored)")

    def run_benchmark(self) -> dict:
        cfg = self.cfg
        warmup = int(cfg.get("benchmark.warmup_steps", 3))
        steps = int(cfg.get("benchmark.timed_steps", 10))
        if steps < 1:
            raise ValueError("benchmark.timed_steps must be >= 1")
        profile_start = cfg.get("benchmark.profile_start")
        profile_end = cfg.get("benchmark.profile_end", profile_start)
        profile_dir = cfg.get("benchmark.profile_dir") or os.path.join(self.output_dir, "profile")
        staged = [self._to_device(stack_batches(b))
                  for b in itertools.islice(self.step_scheduler, warmup + steps)]
        if len(staged) < warmup + steps:
            raise ValueError(f"the step scheduler yields {len(staged)} steps, fewer than "
                             f"{warmup} warmup + {steps} timed: raise step_scheduler.max_steps")
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        losses = []
        m = None
        for batch in staged[:warmup]:
            self.opt_state, m = self._train_step(self.opt_state, batch)
            losses.append(m["loss"])
        self._sync()
        prof = None
        t0 = time.perf_counter()
        for i, batch in enumerate(staged[warmup:]):
            if profile_start is not None and i == int(profile_start):
                prof, t_prof = _start_profiler(cuda), time.perf_counter()
            self.opt_state, m = self._train_step(self.opt_state, batch)
            losses.append(m["loss"])
            if prof is not None and i >= int(profile_end):
                self._sync()
                _stop_profiler(prof, profile_dir, time.perf_counter() - t_prof,
                               i + 1 - int(profile_start))
                prof = None
        self._sync()
        window = time.perf_counter() - t0
        if prof is not None:
            _stop_profiler(prof, profile_dir, time.perf_counter() - t_prof, steps - int(profile_start))

        mean_t = window / steps
        tokens_per_step = self.step_scheduler.grad_acc_steps * self.micro_batch_size * self.seq_len
        tps = tokens_per_step / mean_t
        fpt = self._flops_per_token  # None for a config outside the FLOPs formula
        result = {
            "step_time_s": mean_t,
            "tokens_per_sec": tps,
            "tokens_per_sec_per_chip": tps,
            "model_tflops_per_sec_per_chip": None if fpt is None else tps * fpt / 1e12,
            "mfu": None if fpt is None else mfu(tps, fpt, self.device_kind),
            "device_kind": self.device_kind,
            "n_chips": 1,
            "loss": float(m["loss"]),
            "losses": [float(x) for x in losses],
            "peak_memory_gib": (torch.cuda.max_memory_allocated(self.device) / 2**30
                                if cuda else None),
        }
        logger.info("benchmark: %s", result)
        with open(os.path.join(self.output_dir, "benchmark.json"), "w") as f:
            json.dump(result, f, indent=2)
        self.metric_logger.close()
        self.val_metric_logger.close()
        return result


def _start_profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    prof.start()
    return prof


def _device_us(event) -> float:
    """Device time of a kernel-side event (kernels, copies, memsets); 0 for host ops,
    whose device time the kernel events already carry, and for a scope's span on the
    device's timeline, which covers kernels counted already."""
    from torch.autograd import DeviceType

    if event.device_type != DeviceType.CUDA or getattr(event, "is_user_annotation", False):
        return 0.0
    return float(getattr(event, "self_device_time_total",
                         getattr(event, "self_cuda_time_total", 0.0)))


def _kernel_class(name: str) -> str:
    """Coarse class of a device event for the summary: the port's kernels, library
    GEMMs, reductions, copies, everything else (elementwise)."""
    low = name.lower()
    if any(k in low for k in ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")):
        return "flash_kernels"
    if "lce_" in low:  # lce_fwd/merge/dlogits/gemm kernels of csrc/linear_ce.cu
        return "linear_ce_kernels"
    if "gmm_kernel" in low or "gmm_sm90_kernel" in low:  # csrc/grouped_gemm.cu
        return "grouped_gemm_kernels"
    if "ring_fwd_kernel" in low or "ring_bwd_kernel" in low or "ring_dq_kernel" in low:
        return "ring_kernels"  # csrc/ring_chunk.cu
    if low.startswith("nvjet") or "gemm" in low or "cutlass" in low or "xmma" in low:
        return "gemm"
    if "reduce" in low:
        return "reduce"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "elementwise_other"


def _stop_profiler(prof, out_dir: str, window_s: float, n_steps: int) -> dict:
    """Close the window and write the trace, the per-kernel table and a summary."""
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    averages = prof.key_averages()
    events = sorted(averages, key=_device_us, reverse=True)
    with open(os.path.join(out_dir, "kernels.txt"), "w") as f:
        f.write(averages.table(sort_by="self_device_time_total", row_limit=60))
    busy_s = sum(_device_us(e) for e in events) / 1e6
    by_class: dict[str, float] = {}
    for e in events:
        if _device_us(e):
            by_class[_kernel_class(e.key)] = by_class.get(_kernel_class(e.key), 0.0) + _device_us(e) / 1e3
    summary = {
        "steps": n_steps,
        "window_s": window_s,
        "device_busy_s": busy_s,
        "idle_share": max(0.0, 1.0 - busy_s / window_s) if busy_s else None,
        "device_ms_by_class": by_class,
        "top": [{"name": e.key, "device_ms": _device_us(e) / 1e3, "calls": e.count}
                for e in events[:25] if _device_us(e) > 0],
        "device_ms_by_scope": {k: v / 1e3 for k, v in
                               scope_times(prof.events(), scope_names()).items()},
    }
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    logger.info("profile of %d step(s) written to %s: device busy %.4f s of %.4f s",
                n_steps, out_dir, busy_s, window_s)
    return summary


def main(cfg: ConfigNode | None = None, argv=None):
    if cfg is None:
        cfg = parse_args_and_load_config(argv)
    recipe = BenchmarkingRecipeForNextTokenPrediction(cfg)
    recipe.setup()
    result = recipe.run_benchmark()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
