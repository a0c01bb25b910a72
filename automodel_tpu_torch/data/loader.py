"""Deterministic host-side batching (counterpart of ``automodel_tpu/data/loader.py``,
single process, sized datasets): the epoch order is a permutation seeded by
(seed + epoch), so batches come in the JAX loader's order. The position (epoch and
batch cursor) is checkpointable, and a restored loader resumes at the next batch."""

from __future__ import annotations

from typing import Any, Callable, Iterator, Sequence

import numpy as np

__all__ = ["DataLoader"]


class DataLoader:
    def __init__(self, dataset: Sequence[Any], batch_size: int,
                 collate_fn: Callable[[list[Any]], Any] | None = None, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True):
        if not hasattr(dataset, "__len__"):
            raise NotImplementedError("streaming (unsized) datasets are not ported yet")
        if drop_last and len(dataset) < batch_size:
            raise ValueError(
                f"dataset has {len(dataset)} examples < batch_size {batch_size}: "
                "every batch would be dropped (drop_last) and training would no-op")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or (lambda x: x)
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self._cursor = 0  # batch index within the epoch

    def _epoch_order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.RandomState(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Any]:
        order = self._epoch_order()
        nb = len(self)
        while self._cursor < nb:
            start = self._cursor * self.batch_size
            idx = order[start: start + self.batch_size]
            self._cursor += 1
            yield self.collate_fn([self.dataset[int(i)] for i in idx])
        self.epoch += 1
        self._cursor = 0

    def fast_forward(self, n_batches: int) -> None:
        """Advance the cursor by ``n_batches`` batches without building them; epoch
        boundaries wrap as iteration would cross them."""
        n = int(n_batches)
        if n < 0:
            raise ValueError(f"fast_forward needs n_batches >= 0, got {n}")
        nb = len(self)
        self._cursor += n
        while self._cursor >= nb and nb > 0:
            self._cursor -= nb
            self.epoch += 1

    @property
    def consumed_examples(self) -> int:
        """Examples consumed from the current epoch's permutation: its first
        ``cursor * batch_size`` entries."""
        return self._cursor * self.batch_size

    def state_dict(self) -> dict:
        # process_count records the saving pod's geometry, as the JAX loader's does
        return {"epoch": self.epoch, "cursor": self._cursor, "seed": self.seed,
                "batch_size": self.batch_size, "process_count": 1}

    def load_state_dict(self, state: dict) -> None:
        saved_bs = int(state.get("batch_size", self.batch_size) or self.batch_size)
        if saved_bs != self.batch_size:
            raise ValueError(f"dataloader state was saved with batch_size {saved_bs} but this "
                             f"loader uses {self.batch_size}")
        self.epoch = int(state["epoch"])
        self._cursor = int(state["cursor"])
        self.seed = int(state.get("seed", self.seed))
