"""Hard-negative mining (counterpart of
``automodel_tpu/recipes/biencoder/mine_hard_negatives.py``).

Embeds the corpus (every distinct positive passage) and the queries with a biencoder
tower, keeps each query's top-scoring passages other than its positive as its hard
negatives, and writes the rows back as retrieval JSONL for the training recipe.

YAML: the biencoder training config plus a ``mine`` section: ``input`` (rows
``{"query", "pos_doc"}``), ``output``, ``num_negatives`` (4), ``margin`` (0.95),
``margin_type`` (``perc`` | ``abs``), ``query_prefix`` and ``passage_prefix``.
"""

from __future__ import annotations

import logging

import numpy as np

from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.config.loader import ConfigNode
from automodel_tpu_torch.data.llm.column_mapped import _load_rows
from automodel_tpu_torch.data.llm.retrieval import write_retrieval_jsonl
from automodel_tpu_torch.recipes.biencoder.train_biencoder import TrainBiencoderRecipe

logger = logging.getLogger(__name__)

__all__ = ["main", "mine_hard_negatives"]


def mine_hard_negatives(recipe: TrainBiencoderRecipe, rows: list[dict], num_negatives: int = 4,
                        margin: float = 0.95, margin_type: str = "perc",
                        query_chunk: int = 1024, query_prefix: str = "",
                        passage_prefix: str = "") -> list[dict]:
    """rows ``{"query", "pos_doc"}`` -> the same rows with ``"neg_doc": [...]``.

    Queries go in chunks of ``query_chunk``, so the scores held are (chunk, corpus).
    Candidates scoring above the cut are dropped as likely duplicates of the positive:
    ``perc``: ``margin * pos_score`` (for a positive score; at or below 0, an untrained
    tower's, the positive's score itself); ``abs``: ``pos_score - margin``. The prefixes
    go before each query and passage before encoding (E5-style instructions)."""
    if margin_type not in ("perc", "abs"):
        raise ValueError(f"margin_type must be perc|abs, got {margin_type!r}")
    corpus = sorted({str(r["pos_doc"]) for r in rows})
    doc_row = {d: i for i, d in enumerate(corpus)}
    doc_emb = recipe.encode([passage_prefix + d for d in corpus])  # (N, D)
    mined = []
    for lo in range(0, len(rows), query_chunk):
        chunk = rows[lo:lo + query_chunk]
        q_emb = recipe.encode([query_prefix + str(r["query"]) for r in chunk])
        scores = q_emb @ doc_emb.T  # (chunk, N)
        for i, r in enumerate(chunk):
            pos_idx = doc_row[str(r["pos_doc"])]
            s = scores[i].copy()
            pos_score = s[pos_idx]
            s[pos_idx] = -np.inf
            if margin_type == "abs":
                cut = pos_score - margin
            else:
                cut = margin * pos_score if pos_score > 0 else pos_score
            s[s > cut] = -np.inf
            top = np.argsort(-s)[:num_negatives]
            mined.append({**r, "neg_doc": [corpus[j] for j in top if np.isfinite(s[j])]})
    return mined


def main(cfg: ConfigNode | None = None, argv=None):
    if cfg is None:
        cfg = parse_args_and_load_config(argv)
    mine_cfg = cfg.get("mine")
    if mine_cfg is None:
        raise ValueError("config needs a mine: section (input/output)")
    recipe = TrainBiencoderRecipe(cfg)
    recipe.setup()
    mined = mine_hard_negatives(
        recipe, _load_rows(mine_cfg["input"]),
        num_negatives=int(mine_cfg.get("num_negatives", 4)),
        margin=float(mine_cfg.get("margin", 0.95)),
        margin_type=str(mine_cfg.get("margin_type", "perc")),
        query_prefix=str(mine_cfg.get("query_prefix", "")),
        passage_prefix=str(mine_cfg.get("passage_prefix", "")))
    write_retrieval_jsonl(mined, mine_cfg["output"])
    logger.info("mined %d rows -> %s", len(mined), mine_cfg["output"])
    return mined


if __name__ == "__main__":
    main()
