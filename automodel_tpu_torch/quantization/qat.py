"""Quantization-aware training by straight-through fake quantization (counterpart of
``automodel_tpu/quantization/qat.py``).

``fake_quant`` rounds a weight to a signed ``bits``-bit grid (absmax scales over groups
of ``group_size`` values of the flattened weight, or one group when the size does not
divide) in the forward, and passes the gradient through unchanged. The recipe applies
it to the matched weights from ``fake_quant_after_n_steps`` on.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["QATConfig", "fake_quant", "fake_quant_params"]


@dataclasses.dataclass
class QATConfig:
    enabled: bool = True
    weight_bits: int = 4
    group_size: int = 32  # absmax scaling over groups of the flattened weight
    fake_quant_after_n_steps: int | None = None  # None: from step 0
    target_modules: list[str] = dataclasses.field(default_factory=lambda: ["*"])


def _fake_quant_values(w: torch.Tensor, bits: int, group_size: int) -> torch.Tensor:
    wf = w.float().reshape(-1, group_size) if w.numel() % group_size == 0 \
        else w.float().reshape(1, -1)
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp_min(wf.abs().amax(dim=-1, keepdim=True), 1e-12) / qmax
    q = torch.clamp(torch.round(wf / scale), -qmax - 1, qmax)
    return (q * scale).reshape(w.shape).to(w.dtype)


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, bits, group_size):
        return _fake_quant_values(w, bits, group_size)

    @staticmethod
    def backward(ctx, g):
        return g, None, None  # straight through


def fake_quant(w: torch.Tensor, bits: int = 4, group_size: int = 32) -> torch.Tensor:
    """``w`` on its fake-quantized grid, in its dtype; the gradient is the identity."""
    return _FakeQuant.apply(w, bits, group_size)


def fake_quant_params(params: dict, paths: list[str], cfg: QATConfig) -> dict:
    """A new dict with the listed weights fake-quantized."""
    out = dict(params)
    for path in paths:
        out[path] = fake_quant(out[path], cfg.weight_bits, cfg.group_size)
    return out
