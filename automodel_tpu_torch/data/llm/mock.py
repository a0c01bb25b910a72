"""Mock SFT dataset (counterpart of ``automodel_tpu/data/llm/mock.py``): the same
examples for the same seed, byte for byte."""

from __future__ import annotations

import time
from typing import Any

import numpy as np

__all__ = ["MockSFTDataset"]


class MockSFTDataset:
    """Deterministic synthetic examples; loss over the whole sequence.

    pattern="random": i.i.d. uniform tokens (loss stays at ln(vocab)), the benchmark
    fixture. pattern="arith": per-sample arithmetic progressions mod vocab, learnable.
    """

    def __init__(self, vocab_size: int, seq_len: int, num_samples: int = 1024, seed: int = 0,
                 pattern: str = "random", item_delay_s: float = 0.0):
        if pattern not in ("random", "arith"):
            raise ValueError(f"unknown pattern {pattern!r}")
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.num_samples = num_samples
        self.seed = seed
        self.pattern = pattern
        self.item_delay_s = float(item_delay_s)

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, i: int) -> dict[str, Any]:
        if self.item_delay_s:
            time.sleep(self.item_delay_s)
        rng = np.random.RandomState(self.seed * 100003 + i)
        # seq_len + 1 so the next-token shift still yields seq_len targets
        if self.pattern == "arith":
            step = rng.randint(1, 8)
            start = rng.randint(0, self.vocab_size)
            ids = (start + step * np.arange(self.seq_len + 1)) % self.vocab_size
        else:
            ids = rng.randint(0, self.vocab_size, size=self.seq_len + 1)
        return {"input_ids": ids.tolist(), "prompt_len": 0}
