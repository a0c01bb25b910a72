"""Retrieval (biencoder) dataset and collation (counterpart of
``automodel_tpu/data/llm/retrieval.py``).

Rows: ``{"query": str, "pos_doc": str, "neg_doc": [str, ...]}`` (the layout
``recipes/biencoder/mine_hard_negatives.py`` writes). Collation tokenizes each query
and its passage group (the positive first, then the hard negatives) into fixed-length
arrays:

    q_ids / q_seg / q_pos (B, Sq) | p_ids / p_seg / p_pos (B*(1+k), Sp) | labels (B,) = i*(1+k)

Every query's positive sits at a known row of p, so the in-batch negatives are every
other row.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Sequence

import numpy as np

from automodel_tpu_torch.data.llm.column_mapped import _load_rows

__all__ = ["RetrievalDataset", "encode_block", "retrieval_collate", "write_retrieval_jsonl"]


class RetrievalDataset:
    def __init__(self, path_or_dataset_id: str, tokenizer=None, split: str | None = None,
                 num_hard_negatives: int = 1, query_prefix: str = "", passage_prefix: str = "",
                 limit_dataset_samples: int | None = None):
        self.rows = _load_rows(path_or_dataset_id, split)
        if limit_dataset_samples:
            self.rows = self.rows[:limit_dataset_samples]
        self.tokenizer = tokenizer
        self.num_hard_negatives = num_hard_negatives
        self.query_prefix = query_prefix
        self.passage_prefix = passage_prefix

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> dict[str, Any]:
        """The query and its group of 1 + num_hard_negatives passages: the mined
        negatives cycled when there are fewer than asked, the positive repeated when
        there are none (the in-batch negatives still give signal)."""
        row = self.rows[i]
        negs = list(row.get("neg_doc") or [])
        k = self.num_hard_negatives
        if len(negs) < k:
            negs = (negs * (k // max(len(negs), 1) + 1))[:k] if negs else []
        else:
            negs = negs[:k]
        negs += [row["pos_doc"]] * (k - len(negs))
        pre = self.passage_prefix
        return {"query": self.query_prefix + str(row["query"]),
                "passages": [pre + str(row["pos_doc"])] + [pre + str(n) for n in negs]}


def encode_block(tokenizer, texts: Sequence[str], seq_len: int, pad_token_id: int = 0):
    """``(ids, seg, pos)`` (len(texts), seq_len) int32: each text's tokens cut at
    ``seq_len``, right-padded, segment 1 on its tokens and 0 on the padding."""
    ids = np.full((len(texts), seq_len), pad_token_id, np.int32)
    seg = np.zeros((len(texts), seq_len), np.int32)
    pos = np.zeros((len(texts), seq_len), np.int32)
    for r, t in enumerate(texts):
        toks = np.asarray(tokenizer.encode(t), np.int32)[:seq_len]
        n = len(toks)
        ids[r, :n] = toks
        seg[r, :n] = 1
        pos[r, :n] = np.arange(n)
    return ids, seg, pos


def retrieval_collate(examples: Sequence[Mapping[str, Any]], tokenizer, query_seq_len: int,
                      passage_seq_len: int, pad_token_id: int = 0) -> dict[str, np.ndarray]:
    b = len(examples)
    group = len(examples[0]["passages"])
    q_ids, q_seg, q_pos = encode_block(tokenizer, [e["query"] for e in examples],
                                       query_seq_len, pad_token_id)
    flat = [p for e in examples for p in e["passages"]]
    p_ids, p_seg, p_pos = encode_block(tokenizer, flat, passage_seq_len, pad_token_id)
    return {"q_ids": q_ids, "q_seg": q_seg, "q_pos": q_pos,
            "p_ids": p_ids, "p_seg": p_seg, "p_pos": p_pos,
            # one label per query: the row of p that holds its positive
            "labels": (np.arange(b) * group).astype(np.int32)}


def write_retrieval_jsonl(rows: Sequence[Mapping[str, Any]], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(dict(r)) + "\n")
