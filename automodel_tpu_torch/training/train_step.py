"""The training step (counterpart of ``automodel_tpu/training/train_step.py``).

One call does what the JAX step's scan does: gradients accumulate over the stacked
microbatches, every microbatch loss is normalised by the step's global label-token
count (so the summed gradients are the global-mean gradient), the optimizer runs
once, and with ``guard_nonfinite`` a non-finite loss or gradient norm skips the
update and keeps the optimizer state.
"""

from __future__ import annotations

from typing import Callable

import torch

from automodel_tpu_torch.ops.losses import IGNORE_INDEX
from automodel_tpu_torch.optim.builder import Optimizer, apply_updates, global_norm

__all__ = ["count_label_tokens", "make_train_step"]


def count_label_tokens(labels: torch.Tensor, ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    return (labels != ignore_index).sum()


def _guard_nonfinite_update(updates, new_state, old_state, grad_norm, loss):
    """Zero the update and keep the old optimizer state when the step is non-finite.
    Returns (updates, state, nonfinite flag) without a host sync."""
    ok = torch.isfinite(grad_norm) & torch.isfinite(loss)
    updates = {k: torch.where(ok, u, torch.zeros_like(u)) for k, u in updates.items()}

    def pick(new, old):
        if isinstance(new, dict):
            return {k: pick(new[k], old[k]) for k in new}
        if isinstance(new, list):
            return [pick(n, o) for n, o in zip(new, old)]
        return torch.where(ok.to(new.device), new, old)

    return updates, pick(new_state, old_state), ~ok


def make_train_step(
    forward_loss: Callable[[dict, torch.Tensor], torch.Tensor],
    params: dict[str, torch.Tensor],
    optimizer: Optimizer,
    guard_nonfinite: bool = False,
):
    """Build ``train_step(opt_state, batch_stack) -> (opt_state, metrics)``.

    ``forward_loss(microbatch, num_label_tokens)`` returns the microbatch's CE sum
    divided by the global ``num_label_tokens``; ``params`` are the tensors it
    differentiates, updated in place. ``batch_stack`` holds (n_micro, ...) tensors.
    Metrics: ``loss``, ``grad_norm`` (before clipping), ``num_label_tokens``, and
    ``nonfinite`` under ``guard_nonfinite``; all are device scalars.
    """
    names = list(params)
    leaves = [params[n] for n in names]

    def train_step(opt_state, batch_stack):
        num_label_tokens = count_label_tokens(batch_stack["labels"])
        n_micro = batch_stack["labels"].shape[0]
        grads = None
        loss_acc = torch.zeros((), dtype=torch.float32, device=num_label_tokens.device)
        for i in range(n_micro):
            micro = {k: v[i] for k, v in batch_stack.items()}
            loss = forward_loss(micro, num_label_tokens)
            g = torch.autograd.grad(loss, leaves)
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            loss_acc = loss_acc + loss.detach().float()
        grads = dict(zip(names, grads))
        grad_norm = global_norm(grads)
        with torch.no_grad():
            updates, new_state = optimizer.update(grads, opt_state, params)
            metrics = {"loss": loss_acc, "grad_norm": grad_norm,
                       "num_label_tokens": num_label_tokens}
            if guard_nonfinite:
                updates, new_state, metrics["nonfinite"] = _guard_nonfinite_update(
                    updates, new_state, opt_state, grad_norm, loss_acc)
            apply_updates(params, updates)
        return new_state, metrics

    return train_step
