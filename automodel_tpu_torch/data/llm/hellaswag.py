"""HellaSwag as an SFT dataset (counterpart of ``automodel_tpu/data/llm/hellaswag.py``):
the context is the prompt, the gold ending the answer; the loss covers the ending."""

from __future__ import annotations

import json
import os
from typing import Any

from automodel_tpu_torch.data.tokenize import tokenize_sft_example

__all__ = ["HellaSwagDataset"]


class HellaSwagDataset:
    """Rows ``{"ctx", "endings", "label"}`` from a local JSONL file, or from the
    ``datasets`` package for a dataset id (imported only then)."""

    def __init__(self, path_or_dataset_id: str = "rowan/hellaswag", tokenizer=None,
                 split: str = "train", limit_dataset_samples: int | None = None):
        if os.path.exists(path_or_dataset_id):
            with open(path_or_dataset_id) as f:
                rows = [json.loads(line) for line in f if line.strip()]
        else:
            import datasets as hf_datasets

            rows = list(hf_datasets.load_dataset(path_or_dataset_id, split=split))
        if limit_dataset_samples:
            rows = rows[:limit_dataset_samples]
        self.rows = rows
        self.tokenizer = tokenizer

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> dict[str, Any]:
        row = self.rows[i]
        ending = row["endings"][int(row["label"])]
        return tokenize_sft_example(self.tokenizer, row["ctx"], ending)
