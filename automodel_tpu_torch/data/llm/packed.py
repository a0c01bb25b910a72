"""Sequence packing (counterpart of ``automodel_tpu/data/llm/packed.py``).

Each pack is a fixed-length row whose tokens carry the 1-based index of the sequence
they came from in ``segment_ids`` (0 = padding); attention masks across segment
boundaries and positions restart per sequence. The next-token shift happens within
each sample before concatenation (``shift_example``), so the last token of one sample
never predicts the first of the next. Packs are built up front, as in the JAX package.
"""

from __future__ import annotations

import logging
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from automodel_tpu_torch.data.collate import IGNORE_INDEX, shift_example, stack_batches

logger = logging.getLogger(__name__)

__all__ = ["PackedDataset", "pack_dataset", "packed_collate"]


class PackedDataset:
    """Materialized list of fixed-length packs, each a collate-ready example dict."""

    def __init__(self, packs: list[dict[str, np.ndarray]], packed_sequence_size: int):
        self.packs = packs
        self.packed_sequence_size = packed_sequence_size

    def __len__(self) -> int:
        return len(self.packs)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        return self.packs[idx]


def pack_dataset(
    dataset: Iterable[Mapping[str, Any]],
    packed_sequence_size: int,
    pad_token_id: int = 0,
    max_packs: int | None = None,
    drop_long_samples: bool = False,
    answer_only_loss: bool = True,
) -> PackedDataset:
    """Greedy packing: fill each pack until the next sample does not fit.

    A sample longer than ``packed_sequence_size`` raises unless ``drop_long_samples``."""
    if packed_sequence_size <= 0:
        raise ValueError(f"packed_sequence_size must be positive, got {packed_sequence_size}")
    packs: list[dict[str, np.ndarray]] = []
    buf: list[tuple[np.ndarray, np.ndarray]] = []  # (input_ids, labels) per sample
    used = 0
    n_dropped = 0

    def flush():
        nonlocal used
        if not buf or (max_packs is not None and len(packs) >= max_packs):
            return
        tail = packed_sequence_size - used
        packs.append({
            "input_ids": np.concatenate([*(i for i, _ in buf),
                                         np.full(tail, pad_token_id, np.int32)]),
            "labels": np.concatenate([*(t for _, t in buf), np.full(tail, IGNORE_INDEX, np.int32)]),
            "positions": np.concatenate([*(np.arange(len(i), dtype=np.int32) for i, _ in buf),
                                         np.zeros(tail, np.int32)]),
            "segment_ids": np.concatenate([*(np.full(len(i), s + 1, np.int32)
                                             for s, (i, _) in enumerate(buf)),
                                           np.zeros(tail, np.int32)]),
        })
        buf.clear()
        used = 0

    # map-style datasets may index modulo their length (the mock ones do): walk len() items
    if hasattr(dataset, "__len__") and hasattr(dataset, "__getitem__"):
        samples = (dataset[i] for i in range(len(dataset)))
    else:
        samples = iter(dataset)
    for ex in samples:
        if max_packs is not None and len(packs) >= max_packs:
            break
        inp, tgt = shift_example(ex, answer_only_loss)
        n = len(inp)
        if n == 0:
            continue
        if n > packed_sequence_size:
            if drop_long_samples:
                n_dropped += 1
                continue
            raise ValueError(
                f"sample is too long ({n} > packed_sequence_size {packed_sequence_size}); "
                "increase packed_sequence_size or set drop_long_samples")
        if used + n > packed_sequence_size:
            flush()
        buf.append((np.asarray(inp, np.int32), np.asarray(tgt, np.int32)))
        used += n
    flush()
    if n_dropped:
        logger.warning("pack_dataset dropped %d over-length samples", n_dropped)
    if not packs:
        raise ValueError("pack_dataset produced no packs (empty dataset?)")
    return PackedDataset(packs, packed_sequence_size)


def packed_collate(examples: Sequence[Mapping[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Packs are pre-collated rows; a batch is a stack."""
    return stack_batches(examples)
