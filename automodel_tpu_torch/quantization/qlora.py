"""Weight-only quantization of a QLoRA base (counterpart of
``automodel_tpu/quantization/qlora.py``).

A quantized leaf is a :class:`QuantizedTensor`: codes and scales on the weight's device,
with the scheme, the dense shape and the dtype before quantization. The base stays
quantized in device memory; :func:`dequantize_params` (inside the LoRA merge, every
microbatch) rebuilds dense weights as a transient of the step.

Schemes, with the JAX package's arithmetic, so the codes and scales are bitwise its own:
- ``int8``: absmax over every dim but the stacked ones and the last (one scale per
  output channel of each stacked matrix), scale = max(amax, 1e-12) / 127, codes
  round-half-even(w / scale) clipped to [-127, 127];
- ``nf4``: 4-bit NormalFloat. Blocks of 64 values of the flattened weight (zero-padded
  at the end), scale = max(block absmax, 1e-12), each value the nearest of 16 codebook
  entries (the first on a tie), two codes a byte, high nibble first. The JAX package
  computes this on the host in numpy; here it runs in torch on the weight's device, in
  the same f32 operations (an exact division and subtraction, then argmin), and
  ``tests/test_torch_peft.py`` holds the codes bitwise against JAX's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["NF4_CODEBOOK", "QuantizedTensor", "dequantize_leaf", "dequantize_params",
           "is_quantized_leaf", "quantize_leaf", "quantize_params", "tree_nbytes"]

# 16 code values for 4-bit NormalFloat: quantiles of N(0,1) rescaled to [-1, 1] with an
# exact zero (the QLoRA paper's data type; the JAX package's values)
NF4_CODEBOOK = np.asarray(
    [-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
     -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
     0.07958029955625534, 0.16093020141124725, 0.24611230194568634, 0.33791524171829224,
     0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0],
    dtype=np.float32,
)
_NF4_BLOCK = 64
# blocks a pass of the nf4 search: a (blocks, 64, 16) f32 temporary of 268 MB
_NF4_CHUNK_BLOCKS = 1 << 16


class QuantizedTensor:
    """Codes ``q`` and scales ``scale`` (tensors on one device) of a weight of dense
    ``shape`` and ``orig_dtype`` (a torch dtype name, e.g. ``"bfloat16"``)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, scheme: str, shape: tuple,
                 orig_dtype: str = "float32"):
        self.q = q
        self.scale = scale
        self.scheme = scheme
        self.shape = tuple(shape)
        self.orig_dtype = str(orig_dtype).removeprefix("torch.")

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + \
            self.scale.numel() * self.scale.element_size()

    def __repr__(self):
        return f"QuantizedTensor({self.scheme}, shape={self.shape})"


def is_quantized_leaf(x) -> bool:
    return isinstance(x, QuantizedTensor)


def quantize_leaf(w: torch.Tensor, scheme: str = "int8", n_stack: int = 0) -> QuantizedTensor:
    """Quantize one weight; its ``n_stack`` leading dims are independent stacked
    matrices (layers, experts), each with its own scales."""
    orig_dtype = str(w.dtype)
    w = w.detach()
    if scheme == "int8":
        wf = w.float()
        reduce_dims = tuple(range(n_stack, wf.ndim - 1))
        amax = wf.abs().amax(dim=reduce_dims, keepdim=True) if reduce_dims else wf.abs()
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
        return QuantizedTensor(q, scale, "int8", wf.shape, orig_dtype)
    if scheme == "nf4":
        flat = w.float().reshape(-1)
        pad = (-flat.numel()) % _NF4_BLOCK
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        blocks = flat.reshape(-1, _NF4_BLOCK)
        scale = torch.clamp_min(blocks.abs().amax(dim=1, keepdim=True), 1e-12)
        book = torch.from_numpy(NF4_CODEBOOK).to(w.device)
        codes = torch.empty(blocks.shape, dtype=torch.uint8, device=w.device)
        for i in range(0, blocks.shape[0], _NF4_CHUNK_BLOCKS):
            normed = blocks[i:i + _NF4_CHUNK_BLOCKS] / scale[i:i + _NF4_CHUNK_BLOCKS]
            codes[i:i + _NF4_CHUNK_BLOCKS] = (normed[..., None] - book).abs().argmin(-1)
            del normed
        packed = (codes[:, 0::2] << 4) | codes[:, 1::2]  # two 4-bit codes a byte
        return QuantizedTensor(packed, scale[:, 0].contiguous(), "nf4", w.shape, orig_dtype)
    raise ValueError(f"unknown qlora scheme {scheme!r} (int8 | nf4)")


def dequantize_leaf(leaf: QuantizedTensor) -> torch.Tensor:
    """The dense weight, in its dtype before quantization."""
    dtype = getattr(torch, leaf.orig_dtype)
    if leaf.scheme == "int8":
        return (leaf.q.float() * leaf.scale).to(dtype)
    if leaf.scheme == "nf4":
        packed = leaf.q
        codes = torch.stack([packed >> 4, packed & 0x0F], dim=-1).reshape(packed.shape[0], -1)
        book = torch.from_numpy(NF4_CODEBOOK).to(packed.device)
        blocks = book[codes.long()] * leaf.scale[:, None]
        n = math.prod(leaf.shape)
        return blocks.reshape(-1)[:n].reshape(leaf.shape).to(dtype)
    raise ValueError(f"unknown qlora scheme {leaf.scheme!r}")


def quantize_params(params: dict, paths: list[str] | dict, scheme: str = "int8") -> dict:
    """A new dict with the listed names quantized. ``paths`` may be
    ``match_lora_paths``'s dict (name -> (n_stack, split)): per-stack-element scales."""
    stacks = paths if isinstance(paths, dict) else {p: (0, None) for p in paths}
    out = dict(params)
    for path, (n_stack, _split) in stacks.items():
        out[path] = quantize_leaf(out[path], scheme, n_stack)
    return out


def dequantize_params(params: dict) -> dict:
    """A dense view of a (partly) quantized dict: the quantized leaves dequantized, the
    rest as they are."""
    return {k: dequantize_leaf(v) if is_quantized_leaf(v) else v for k, v in params.items()}


def tree_nbytes(params: dict) -> int:
    """Bytes of every tensor of the dict, a quantized leaf's codes and scales."""
    return sum(v.nbytes if is_quantized_leaf(v) else v.numel() * v.element_size()
               for v in params.values())
