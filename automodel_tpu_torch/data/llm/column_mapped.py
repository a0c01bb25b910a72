"""Column-mapped instruction dataset (counterpart of
``automodel_tpu/data/llm/column_mapped.py``): rows of a local JSON / JSONL file, their
columns mapped onto the (context, question, instruction, answer) roles, tokenized into
SFT examples with the prompt span masked from the loss.

:func:`_load_rows` is also the row reader of the sequence-classification and retrieval
datasets. A hub dataset id raises NotImplementedError: the PyTorch package downloads
nothing (``models/hub.py`` refuses hub model ids the same way).
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

from automodel_tpu_torch.data.tokenize import tokenize_sft_example
from automodel_tpu_torch.models.hub import looks_like_repo_id

__all__ = ["ColumnMappedTextInstructionDataset", "format_and_tokenize"]

_ROLES = ("context", "question", "instruction")


def format_and_tokenize(row: Mapping[str, Any], mapping: Mapping[str, str],
                        tokenizer, answer_only: bool) -> dict[str, Any]:
    """One SFT example of ``row``: the mapped prompt roles joined by newlines, the answer
    after them; the prompt span is masked unless ``answer_only`` is off."""
    if tokenizer is None:
        raise ValueError("tokenizer required to materialize examples")
    parts = [str(row[mapping[r]]) for r in _ROLES if r in mapping]
    ex = tokenize_sft_example(tokenizer, "\n".join(parts), str(row[mapping["answer"]]))
    if not answer_only:
        ex["prompt_len"] = 0
    return ex


def _load_rows(path_or_name: str, split: str | None = None,
               config_name: str | None = None) -> list[dict]:
    """The rows of a local ``.jsonl`` file (one JSON object a line) or ``.json`` file (a
    list, or ``{"data": [...]}``). ``split`` and ``config_name`` name a hub dataset's
    split and subset, which the PyTorch package does not download."""
    if os.path.exists(path_or_name):
        with open(path_or_name) as f:
            if path_or_name.endswith(".jsonl"):
                return [json.loads(line) for line in f if line.strip()]
            data = json.load(f)
        return data if isinstance(data, list) else data["data"]
    if looks_like_repo_id(path_or_name):
        subset = f" (subset {config_name!r})" if config_name else ""
        raise NotImplementedError(
            f"{path_or_name!r}{subset} reads as a Hugging Face hub dataset id: hub download "
            "is not ported to the PyTorch package (ROADMAP.md); pass a local JSON / JSONL file")
    raise FileNotFoundError(f"{path_or_name!r} is not a local JSON / JSONL file")


class ColumnMappedTextInstructionDataset:
    def __init__(self, path_or_dataset_id: str, column_mapping: Mapping[str, str],
                 tokenizer=None, split: str | None = None, answer_only_loss_mask: bool = True,
                 limit_dataset_samples: int | None = None):
        if "answer" not in column_mapping:
            raise ValueError("column_mapping must include an 'answer' role")
        self.rows = _load_rows(path_or_dataset_id, split)
        if limit_dataset_samples:
            self.rows = self.rows[:limit_dataset_samples]
        self.mapping = dict(column_mapping)
        self.tokenizer = tokenizer
        self.answer_only = answer_only_loss_mask

    def __len__(self) -> int:
        return len(self.rows)

    def format_prompt(self, row: Mapping[str, Any]) -> tuple[str, str]:
        """(prompt, answer) of ``row``, untokenized."""
        prompt = "\n".join(str(row[self.mapping[r]]) for r in _ROLES if r in self.mapping)
        return prompt, str(row[self.mapping["answer"]])

    def __getitem__(self, i: int) -> dict[str, Any]:
        return format_and_tokenize(self.rows[i], self.mapping, self.tokenizer, self.answer_only)
