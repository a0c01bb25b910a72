"""MoE token dispatch (counterpart of ``automodel_tpu/moe/dispatch.py``), the ``dense``
dispatcher only: one device, every routed token copy computed where it is. The
expert-parallel ``a2a`` dispatcher comes with the parallel slice and raises here."""

from __future__ import annotations

import torch

from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.layers import moe_forward

__all__ = ["make_moe_block_forward"]


def make_moe_block_forward(cfg: MoEConfig, backend, *, training: bool = True):
    """``fn(moe_params, x, token_mask) -> (y, aux_loss, expert_load, dropped_frac)`` with x
    (B, S, D). ``backend.experts_backend`` "dense" takes the capacity (one-hot einsum)
    path; "ragged_dot" and "pallas" the dropless grouped GEMM, so ``dropped_frac`` is a
    constant 0."""
    if backend.dispatcher != "dense":
        raise NotImplementedError(
            f"dispatcher {backend.dispatcher!r} is not ported yet (the parallel slice)")

    def fn(moe_params, x, token_mask=None):
        y, aux, load = moe_forward(
            cfg, moe_params, x, token_mask, training=training,
            dispatcher="capacity" if backend.experts_backend == "dense" else "ragged",
            fake_balanced_gate=backend.fake_balanced_gate,
            fake_gate_noise=backend.fake_gate_noise)
        return y, aux, load, torch.zeros((), dtype=torch.float32, device=x.device)

    return fn
