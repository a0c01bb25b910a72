"""The training step (counterpart of ``automodel_tpu/training/train_step.py``).

One call does what the JAX step's scan does: gradients accumulate over the stacked
microbatches, every microbatch loss is normalised by the step's global label-token
count (so the summed gradients are the global-mean gradient), the optimizer runs
once, in place and leaf by leaf (``Optimizer.step``: the step's peak holds no full-size
copy of the gradients or moments), and with ``guard_nonfinite`` a non-finite loss or
gradient norm skips the update and keeps the optimizer state, slice by slice from a device
flag. A ``post_update`` (the MoE gate-bias update) runs after the optimizer on the step's
summed aux, on a skipped step too, as in JAX.
"""

from __future__ import annotations

from typing import Callable

import torch

from automodel_tpu_torch.ops.losses import IGNORE_INDEX
from automodel_tpu_torch.optim.builder import Optimizer, global_norm
from automodel_tpu_torch.utils.tracing import scoped

__all__ = ["count_label_tokens", "make_eval_step", "make_train_step"]


def count_label_tokens(labels: torch.Tensor, ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    return (labels != ignore_index).sum()


def _own_buffers(grads) -> list[torch.Tensor]:
    """``grads`` with a dense buffer of its own each, for the in-place sum over
    microbatches: autograd may hand two inputs the same tensor (an add passes its gradient
    to both operands), or a stride-0 one (a sum's gradient is an expanded tensor)."""
    seen, out = set(), []
    for t in grads:
        if t.data_ptr() in seen or not t.is_contiguous():
            t = t.clone(memory_format=torch.contiguous_format)
        seen.add(t.data_ptr())
        out.append(t)
    return out


@scoped("optimizer")  # the update's share of a profiled step
def _optimizer_step(optimizer: Optimizer, grads, opt_state, params, ok):
    return optimizer.step(grads, opt_state, params, ok)


def make_train_step(
    forward_loss: Callable[[dict, torch.Tensor], torch.Tensor],
    params: dict[str, torch.Tensor],
    optimizer: Optimizer,
    guard_nonfinite: bool = False,
    post_update: Callable[[dict, dict], None] | None = None,
):
    """Build ``train_step(opt_state, batch_stack) -> (opt_state, metrics)``; the step
    overwrites ``opt_state``'s tensors in place.

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
            # summed into the first microbatch's buffers: the same values as a + b,
            # without a third set of gradients at the peak
            grads = _own_buffers(g) if grads is None else [a.add_(b) for a, b in zip(grads, g)]
            loss_acc = loss_acc + loss.detach().float()
            for k, v in aux.items():
                aux_acc[k] = v.detach() if k not in aux_acc else aux_acc[k] + v.detach()
        grads = dict(zip(names, grads))
        grad_norm = global_norm(grads)
        metrics = {"loss": loss_acc, "grad_norm": grad_norm,
                   "num_label_tokens": num_label_tokens, **aux_acc}
        with torch.no_grad():
            ok = None
            if guard_nonfinite:
                ok = torch.isfinite(grad_norm) & torch.isfinite(loss_acc)
                metrics["nonfinite"] = ~ok
            new_state = _optimizer_step(optimizer, grads, opt_state, params, ok)
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
