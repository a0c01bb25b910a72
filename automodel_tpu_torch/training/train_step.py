"""The training step (counterpart of ``automodel_tpu/training/train_step.py``).

One call does what the JAX step's scan does: gradients accumulate over the stacked
microbatches, every microbatch loss is normalised by the step's global label-token
count (so the summed gradients are the global-mean gradient), the optimizer runs
once, and with ``guard_nonfinite`` a non-finite loss or gradient norm skips the
update and keeps the optimizer state. A ``post_update`` (the MoE gate-bias update) runs
after the optimizer on the step's summed aux, on a skipped step too, as in JAX.
"""

from __future__ import annotations

from typing import Callable

import torch

from automodel_tpu_torch.ops.losses import IGNORE_INDEX
from automodel_tpu_torch.optim.builder import Optimizer, apply_updates, global_norm

__all__ = ["count_label_tokens", "make_eval_step", "make_train_step"]


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
    post_update: Callable[[dict, dict], None] | None = None,
):
    """Build ``train_step(opt_state, batch_stack) -> (opt_state, metrics)``.

    ``forward_loss(microbatch, num_label_tokens)`` returns the microbatch's CE sum
    divided by the global ``num_label_tokens``, or ``(loss, aux)`` with a dict of aux
    tensors (an MoE model's ``expert_load``, ``moe_aux_loss``) that are summed over the
    microbatches, as the JAX scan carry sums them; ``params`` are the tensors it
    differentiates, updated in place (under PEFT the adapter: the frozen base rides in
    ``forward_loss``'s closure, as JAX's ``with_frozen`` passes it undifferentiated).
    ``batch_stack`` holds (n_micro, ...) tensors.
    Metrics: ``loss``, ``grad_norm`` (before clipping), ``num_label_tokens``, the summed
    aux entries, and ``nonfinite`` under ``guard_nonfinite``; all are device tensors.
    ``post_update(params, aux)`` updates ``params`` in place after the optimizer, from
    the summed aux entries (JAX's hook for non-gradient updates).
    """
    names = list(params)
    leaves = [params[n] for n in names]

    def train_step(opt_state, batch_stack):
        num_label_tokens = count_label_tokens(batch_stack["labels"])
        n_micro = batch_stack["labels"].shape[0]
        grads = None
        aux_acc: dict[str, torch.Tensor] = {}
        loss_acc = torch.zeros((), dtype=torch.float32, device=num_label_tokens.device)
        for i in range(n_micro):
            micro = {k: v[i] for k, v in batch_stack.items()}
            out = forward_loss(micro, num_label_tokens)
            loss, aux = out if isinstance(out, tuple) else (out, {})
            # a parameter the loss does not reach (a router under fake_balanced_gate)
            # gets a zero gradient, as jax.grad gives it
            g = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            loss_acc = loss_acc + loss.detach().float()
            for k, v in aux.items():
                aux_acc[k] = v.detach() if k not in aux_acc else aux_acc[k] + v.detach()
        grads = dict(zip(names, grads))
        grad_norm = global_norm(grads)
        with torch.no_grad():
            updates, new_state = optimizer.update(grads, opt_state, params)
            metrics = {"loss": loss_acc, "grad_norm": grad_norm,
                       "num_label_tokens": num_label_tokens, **aux_acc}
            if guard_nonfinite:
                updates, new_state, metrics["nonfinite"] = _guard_nonfinite_update(
                    updates, new_state, opt_state, grad_norm, loss_acc)
            apply_updates(params, updates)
            if post_update is not None:
                post_update(params, aux_acc)
        return new_state, metrics

    return train_step


def make_eval_step(forward_loss: Callable[..., torch.Tensor]):
    """``eval_step(batch, num_label_tokens) -> loss`` (a device scalar): the loss of
    ``forward_loss`` without gradients, its aux entries dropped."""

    def eval_step(batch, num_label_tokens):
        with torch.no_grad():
            out = forward_loss(batch, num_label_tokens)
        return out[0] if isinstance(out, tuple) else out

    return eval_step
