"""Gradient-accumulation grouping and run length (counterpart of
``automodel_tpu/training/step_scheduler.py``, the part the single-device recipe uses):
yields one list of ``grad_acc_steps`` microbatches per optimizer step, a trailing
partial group at an epoch's end included, until ``max_steps`` or ``num_epochs``; says
when to log, validate and checkpoint, and is checkpointable."""

from __future__ import annotations

from typing import Any, Iterable, Iterator

__all__ = ["StepScheduler"]


class StepScheduler:
    def __init__(self, grad_acc_steps: int = 1, ckpt_every_steps: int = 0,
                 val_every_steps: int = 0, log_every_steps: int = 1, num_epochs: int = 1,
                 max_steps: int | None = None, dataloader: Iterable | None = None):
        if grad_acc_steps < 1:
            raise ValueError(f"grad_acc_steps must be >= 1, got {grad_acc_steps}")
        self.grad_acc_steps = grad_acc_steps
        self.ckpt_every_steps = ckpt_every_steps
        self.val_every_steps = val_every_steps
        self.log_every_steps = log_every_steps
        self.num_epochs = num_epochs
        self.max_steps = max_steps
        self.dataloader = dataloader
        self.step = 0  # completed optimizer steps
        self.epoch = 0

    def __iter__(self) -> Iterator[list[Any]]:
        if self.dataloader is None:
            raise ValueError("StepScheduler has no dataloader")
        while self.epoch < self.num_epochs:
            if self.max_steps is not None and self.step >= self.max_steps:
                return
            batches: list[Any] = []
            for batch in self.dataloader:
                batches.append(batch)
                if len(batches) == self.grad_acc_steps:
                    self.step += 1
                    yield batches
                    batches = []
                    if self.max_steps is not None and self.step >= self.max_steps:
                        return
            if batches:
                self.step += 1
                yield batches
                if self.max_steps is not None and self.step >= self.max_steps:
                    return
            self.epoch += 1

    # the *_at(step) forms take the consumer's step: under the prefetch pipeline the
    # scheduler's own counter runs ahead
    def is_ckpt_step_at(self, step: int) -> bool:
        return self.ckpt_every_steps > 0 and step > 0 and step % self.ckpt_every_steps == 0

    def is_val_step_at(self, step: int) -> bool:
        return self.val_every_steps > 0 and step > 0 and step % self.val_every_steps == 0

    def is_log_step_at(self, step: int) -> bool:
        return self.log_every_steps > 0 and step % self.log_every_steps == 0

    @property
    def done(self) -> bool:
        if self.max_steps is not None and self.step >= self.max_steps:
            return True
        return self.epoch >= self.num_epochs

    def state_dict(self) -> dict[str, int]:
        return {"step": self.step, "epoch": self.epoch}

    def load_state_dict(self, state: dict[str, int]) -> None:
        self.step = int(state["step"])
        self.epoch = int(state["epoch"])
