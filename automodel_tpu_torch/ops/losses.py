"""Loss functions (counterpart of ``automodel_tpu/ops/losses.py``).

Every loss returns the sum over valid tokens divided by ``num_label_tokens`` (the
global count when given), so microbatch losses add up to the global mean.

- ``masked_cross_entropy``: f32 log-softmax CE with ignore_index masking.
- ``chunked_cross_entropy``: the same over sequence chunks, bounding the f32 working set.
- ``linear_cross_entropy``: hidden states and the unembedding in, CE out, without the
  full (tokens, vocab) logits. ``impl="pallas"`` (the JAX package's name) runs the CUDA
  kernels of ``ops/linear_ce.py`` on a CUDA tensor and their plain version on a CPU
  tensor; ``"xla"`` is the blockwise path (torch ops per block of tokens, each block
  recomputed in the backward); ``"auto"`` is ``"pallas"``: the kernels on the card,
  the plain version on the CPU. The kernels take every embed and vocab size
  (:func:`~automodel_tpu_torch.ops.linear_ce.kernel_supported`), so only an explicit
  ``"xla"`` runs the blockwise path; on the card the kernels' wrapper raises on what
  they do not take (not bf16, an unembedding in neither layout they read).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from automodel_tpu_torch.ops.linear_ce import TILE_N, fused_logsumexp, gold_logits

__all__ = ["IGNORE_INDEX", "LINEAR_CE_IMPLS", "chunked_cross_entropy", "fused_linear_ce_tokens",
           "linear_cross_entropy", "masked_cross_entropy"]

IGNORE_INDEX = -100
LINEAR_CE_IMPLS = ("auto", "pallas", "xla")


def _ce_sum(logits, labels, ignore_index):
    """Sum of token CE over valid labels and the count of valid labels, in f32."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logits32 = logits.float()
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, safe[..., None])[..., 0]
    tok = torch.where(valid, logz - gold, torch.zeros_like(logz))
    return tok.sum(), valid.sum()


def _mean(total, count, num_label_tokens):
    denom = count if num_label_tokens is None else num_label_tokens
    denom = torch.as_tensor(denom, device=total.device)
    return total / torch.clamp(denom, min=1).float()


def masked_cross_entropy(
    logits: torch.Tensor,  # (..., vocab)
    labels: torch.Tensor,  # (...,) int, ignore_index = masked
    num_label_tokens: torch.Tensor | int | None = None,
    ignore_index: int = IGNORE_INDEX,
) -> torch.Tensor:
    """Mean CE over valid tokens; denominator overridable with the global token count."""
    total, count = _ce_sum(logits, labels, ignore_index)
    return _mean(total, count, num_label_tokens)


def chunked_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    num_label_tokens: torch.Tensor | int | None = None,
    ignore_index: int = IGNORE_INDEX,
    num_chunks: int = 8,
) -> torch.Tensor:
    """CE computed over token chunks to bound the f32 logits working set."""
    v = logits.shape[-1]
    flat_logits, flat_labels = logits.reshape(-1, v), labels.reshape(-1)
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    count = torch.zeros((), dtype=torch.long, device=logits.device)
    for lg, lb in zip(flat_logits.tensor_split(num_chunks), flat_labels.tensor_split(num_chunks)):
        s, c = _ce_sum(lg, lb, ignore_index)
        total, count = total + s, count + c
    return _mean(total, count, num_label_tokens)


def fused_linear_ce_tokens(
    hidden2d: torch.Tensor,  # (N, embed)
    unembed: torch.Tensor,  # (embed, vocab_local)
    labels: torch.Tensor,  # (N,) GLOBAL label ids
    ignore_index: int = IGNORE_INDEX,
    vocab_offset: torch.Tensor | int = 0,
    filter_eps: float | None = 1e-7,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token ``(z, gold)`` of ``hidden2d @ unembed``, logits never whole in memory.

    Vocab-shard aware: with ``unembed`` a vocab shard and ``vocab_offset`` its global
    start, combine across shards with ``logsumexp(z)`` / ``sum(gold)`` before forming
    ``loss = z - gold``. Tokens are padded with zero rows to the kernels' tile and the
    padding is sliced off. On a CUDA tensor the kernels run or their wrapper raises."""
    del ignore_index  # ignored labels fall outside [0, V) and give gold = 0
    n = hidden2d.shape[0]
    local = labels.long() - vocab_offset
    gold = gold_logits(hidden2d, unembed, local)
    pad = (-n) % TILE_N
    h_pad = F.pad(hidden2d, (0, 0, 0, pad)) if pad else hidden2d
    z = fused_logsumexp(h_pad, unembed, filter_eps)
    return z[:n], gold


def _block_ce(h_b, l_b, unembed, ignore_index):
    return _ce_sum(h_b.float() @ unembed.float(), l_b, ignore_index)


def linear_cross_entropy(
    hidden: torch.Tensor,  # (..., embed)
    unembed: torch.Tensor,  # (embed, vocab)
    labels: torch.Tensor,  # (...,)
    num_label_tokens: torch.Tensor | int | None = None,
    ignore_index: int = IGNORE_INDEX,
    block_size: int = 1024,
    impl: str = "auto",  # auto | pallas | xla
    filter_eps: float | None = 1e-7,
) -> torch.Tensor:
    """Fused projection + CE: the (tokens, vocab) logits never exist at once."""
    if impl not in LINEAR_CE_IMPLS:
        raise ValueError(f"unknown linear_ce impl {impl!r} (choose from {list(LINEAR_CE_IMPLS)})")
    e = hidden.shape[-1]
    flat_h, flat_labels = hidden.reshape(-1, e), labels.reshape(-1)
    if impl != "xla":
        z, gold = fused_linear_ce_tokens(flat_h, unembed, flat_labels, ignore_index,
                                         filter_eps=filter_eps)
        valid = flat_labels != ignore_index
        total = torch.where(valid, z - gold, torch.zeros_like(z)).sum()
        return _mean(total, valid.sum(), num_label_tokens)
    # blockwise: one (block, vocab) f32 logits tile at a time, recomputed in the backward
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.long, device=hidden.device)
    for h_b, l_b in zip(flat_h.split(block_size), flat_labels.split(block_size)):
        s, c = checkpoint(_block_ce, h_b, l_b, unembed, ignore_index, use_reentrant=False)
        total, count = total + s, count + c
    return _mean(total, count, num_label_tokens)
