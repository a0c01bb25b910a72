"""Prompt / answer tokenization shared by the SFT datasets (counterpart of
``automodel_tpu/data/tokenize.py``)."""

from __future__ import annotations

from typing import Any

__all__ = ["tokenize_sft_example"]


def tokenize_sft_example(tokenizer, prompt: str, answer: str, sep: str = " ") -> dict[str, Any]:
    """Tokenize prompt + answer: ``input_ids`` (ending in EOS) and ``prompt_len``, the
    prompt's token count, which collation masks from the loss (answer-only loss)."""
    prompt_ids = tokenizer.encode(prompt)
    full_ids = list(tokenizer.encode(prompt + sep + answer))
    eos = getattr(tokenizer, "eos_token_id", None)
    if eos is not None and (not full_ids or full_ids[-1] != eos):
        full_ids = full_ids + [eos]
    return {"input_ids": full_ids, "prompt_len": len(prompt_ids)}
