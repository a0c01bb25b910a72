"""Loss functions (counterpart of ``automodel_tpu/ops/losses.py``).

Every loss returns the sum over valid tokens divided by ``num_label_tokens`` (the
global count when given), so microbatch losses add up to the global mean.

``linear_cross_entropy`` has a plain version for CPU tensors only. Its TPU kernels
(``ops/pallas/linear_ce.py``) are not ported yet (ROADMAP.md Queue 2, the linear_ce
row), so on the card it raises rather than materialising the logits.
"""

from __future__ import annotations

import torch

__all__ = ["IGNORE_INDEX", "fused_linear_ce_tokens", "linear_cross_entropy",
           "masked_cross_entropy"]

IGNORE_INDEX = -100
_LINEAR_CE_TODO = ("linear_ce runs the Pallas kernels of ops/pallas/linear_ce.py, which "
                   "are not ported to CUDA yet (ROADMAP.md Queue 2: linear_ce); use "
                   "loss.name: masked_ce")


def _ce_sum(logits, labels, ignore_index):
    """Sum of token CE over valid labels and the count of valid labels, in f32."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logits32 = logits.float()
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, safe[..., None])[..., 0]
    tok = torch.where(valid, logz - gold, torch.zeros_like(logz))
    return tok.sum(), valid.sum()


def masked_cross_entropy(
    logits: torch.Tensor,  # (..., vocab)
    labels: torch.Tensor,  # (...,) int, ignore_index = masked
    num_label_tokens: torch.Tensor | int | None = None,
    ignore_index: int = IGNORE_INDEX,
) -> torch.Tensor:
    """Mean CE over valid tokens; denominator overridable with the global token count."""
    total, count = _ce_sum(logits, labels, ignore_index)
    denom = count if num_label_tokens is None else num_label_tokens
    denom = torch.as_tensor(denom, device=total.device)
    return total / torch.clamp(denom, min=1).float()


def linear_cross_entropy(
    hidden: torch.Tensor,  # (..., embed)
    unembed: torch.Tensor,  # (embed, vocab)
    labels: torch.Tensor,
    num_label_tokens: torch.Tensor | int | None = None,
    ignore_index: int = IGNORE_INDEX,
) -> torch.Tensor:
    """Projection + CE; CPU tensors only (plain f32 version of the fused kernels)."""
    if hidden.device.type != "cpu":
        raise NotImplementedError(_LINEAR_CE_TODO)
    logits = hidden.float() @ unembed.float()
    return masked_cross_entropy(logits, labels, num_label_tokens, ignore_index)


def fused_linear_ce_tokens(hidden2d, unembed, labels, ignore_index=IGNORE_INDEX,
                           vocab_offset=0):
    """Per-token (logsumexp, gold logit) of hidden2d @ unembed; CPU tensors only."""
    if hidden2d.device.type != "cpu":
        raise NotImplementedError(_LINEAR_CE_TODO)
    logits = hidden2d.float() @ unembed.float()
    local = (labels.long() - vocab_offset)
    in_shard = (local >= 0) & (local < unembed.shape[1]) & (labels != ignore_index)
    gold = torch.gather(logits, -1, torch.where(in_shard, local, 0)[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1), torch.where(in_shard, gold, 0.0)
