"""Sequence-classification datasets (counterpart of ``automodel_tpu/data/llm/seq_cls.py``).

Examples carry ``{"input_ids", "label"}``; :func:`seq_cls_collate` right-pads them to a
fixed length with segment ids (1 real, 0 padding), so the model pools the last real
token.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np

from automodel_tpu_torch.data.llm.column_mapped import _load_rows

__all__ = ["GLUE_MRPC", "SeqClsDataset", "seq_cls_collate"]


class SeqClsDataset:
    """Text (or text-pair) classification rows from a local JSON / JSONL file."""

    def __init__(self, tokenizer, path_or_dataset_id: str, text_column: str = "text",
                 text_pair_column: str | None = None, label_column: str = "label",
                 split: str = "train", limit_dataset_samples: int | None = None,
                 config_name: str | None = None):
        self.rows = _load_rows(path_or_dataset_id, split, config_name)
        if limit_dataset_samples:
            self.rows = self.rows[:limit_dataset_samples]
        self.tokenizer = tokenizer
        self.text_column = text_column
        self.text_pair_column = text_pair_column
        self.label_column = label_column

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> dict[str, Any]:
        row = self.rows[i]
        text = str(row[self.text_column])
        if self.text_pair_column:
            sep = getattr(self.tokenizer, "sep_token", None) or "\n"
            text = text + sep + str(row[self.text_pair_column])
        return {"input_ids": self.tokenizer.encode(text), "label": int(row[self.label_column])}


class GLUE_MRPC(SeqClsDataset):
    """Sentence-pair paraphrase classification: GLUE's MRPC columns."""

    def __init__(self, tokenizer, split: str = "train", limit_dataset_samples: int | None = None,
                 path_or_dataset_id: str = "nyu-mll/glue"):
        super().__init__(tokenizer, path_or_dataset_id, text_column="sentence1",
                         text_pair_column="sentence2", label_column="label", split=split,
                         limit_dataset_samples=limit_dataset_samples, config_name="mrpc")


def seq_cls_collate(examples: Sequence[Mapping[str, Any]], seq_len: int,
                    pad_token_id: int = 0) -> dict[str, np.ndarray]:
    """``input_ids`` / ``segment_ids`` / ``positions`` (B, seq_len), right-padded and cut
    at ``seq_len``, and ``labels`` (B,), the class ids."""
    b = len(examples)
    input_ids = np.full((b, seq_len), pad_token_id, np.int32)
    segment_ids = np.zeros((b, seq_len), np.int32)
    positions = np.zeros((b, seq_len), np.int32)
    labels = np.zeros((b,), np.int32)
    for row, ex in enumerate(examples):
        ids = np.asarray(ex["input_ids"], np.int32)[:seq_len]
        n = len(ids)
        input_ids[row, :n] = ids
        segment_ids[row, :n] = 1
        positions[row, :n] = np.arange(n)
        labels[row] = int(ex["label"])
    return {"input_ids": input_ids, "segment_ids": segment_ids, "positions": positions,
            "labels": labels}
