"""Batch collation for next-token prediction (counterpart of
``automodel_tpu/data/collate.py``): fixed-length padding, labels pre-shifted
(labels[t] = token[t+1], -100 ignored), positions, and segment ids (1 real, 0 pad)."""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np

__all__ = ["IGNORE_INDEX", "sft_collate", "shift_example", "stack_batches"]

IGNORE_INDEX = -100


def shift_example(ex: Mapping[str, Any], answer_only_loss: bool = True
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Per-example next-token shift -> (input_ids, labels), prompt span masked."""
    ids = np.asarray(ex["input_ids"], dtype=np.int32)
    if "labels" in ex and ex["labels"] is not None:
        tgt_full = np.asarray(ex["labels"], dtype=np.int32)
        return ids[:-1], tgt_full[1:]
    inp, tgt = ids[:-1], ids[1:].copy()
    if answer_only_loss and "prompt_len" in ex:
        cut = max(int(ex["prompt_len"]) - 1, 0)
        tgt[:cut] = IGNORE_INDEX
    return inp, tgt


def sft_collate(examples: Sequence[Mapping[str, Any]], seq_len: int, pad_token_id: int = 0,
                answer_only_loss: bool = True) -> dict[str, np.ndarray]:
    b = len(examples)
    input_ids = np.full((b, seq_len), pad_token_id, dtype=np.int32)
    labels = np.full((b, seq_len), IGNORE_INDEX, dtype=np.int32)
    segment_ids = np.zeros((b, seq_len), dtype=np.int32)
    positions = np.zeros((b, seq_len), dtype=np.int32)
    for row, ex in enumerate(examples):
        inp, tgt = shift_example(ex, answer_only_loss)
        inp, tgt = inp[:seq_len], tgt[:seq_len]
        n = len(inp)
        input_ids[row, :n] = inp
        labels[row, :n] = tgt
        segment_ids[row, :n] = 1
        positions[row, :n] = np.arange(n)
    labels[segment_ids == 0] = IGNORE_INDEX
    return {"input_ids": input_ids, "labels": labels, "positions": positions,
            "segment_ids": segment_ids}


def stack_batches(batches: Sequence[Mapping[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Stack microbatches into (n_micro, B, S) arrays, key by key."""
    return {k: np.stack([np.asarray(b[k]) for b in batches], axis=0) for k in batches[0]}
