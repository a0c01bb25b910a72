"""LR schedule (counterpart of ``automodel_tpu/optim/scheduler.py``): linear warmup
from ``init_lr`` to ``max_lr``, then cosine / linear / constant decay to ``min_lr``."""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["build_lr_schedule"]


def build_lr_schedule(
    max_lr: float,
    min_lr: float = 0.0,
    init_lr: float = 0.0,
    lr_warmup_steps: int = 0,
    lr_decay_steps: int | None = None,
    lr_decay_style: str = "cosine",
) -> Callable[[int], float]:
    """Pure step -> lr function, in f32 arithmetic like the JAX schedule."""
    import numpy as np

    if lr_decay_style not in ("cosine", "linear", "constant"):
        raise ValueError(f"unknown lr_decay_style {lr_decay_style!r}")
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        warm = f32(max(lr_warmup_steps, 1))
        warmup_lr = f32(init_lr) + f32(max_lr - init_lr) * min(step, warm) / warm
        if lr_decay_style == "constant" or lr_decay_steps is None:
            decayed = f32(max_lr)
        else:
            total = f32(max(lr_decay_steps - lr_warmup_steps, 1))
            frac = f32(min(max((step - f32(lr_warmup_steps)) / total, 0.0), 1.0))
            if lr_decay_style == "cosine":
                coeff = f32(0.5) * (f32(1.0) + f32(math.cos(f32(math.pi) * frac)))
            else:
                coeff = f32(1.0) - frac
            decayed = f32(min_lr) + f32(max_lr - min_lr) * coeff
        return float(warmup_lr if step < lr_warmup_steps else decayed)

    return schedule
