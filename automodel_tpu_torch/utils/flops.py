"""Analytic training FLOPs and MFU (counterpart of ``automodel_tpu/utils/flops.py``,
dense GQA decoders only).

Train FLOPs = 3 x forward. The attention score term counts the full S x S product,
as the JAX package counts it. MFU is achieved over the card's dense bf16 peak.
"""

from __future__ import annotations

from typing import Any

__all__ = ["PEAK_TFLOPS", "flops_per_token", "mfu", "peak_tflops"]

# dense bf16 peak per card, NVIDIA's data sheets (SXM parts, no sparsity)
PEAK_TFLOPS: dict[str, float] = {"h100": 989.0, "h200": 989.0}


def flops_per_token(cfg: Any, seq_len: int, training: bool = True) -> float:
    """FLOPs per token of a dense decoder given as an HF-config-like dict or object."""
    get = cfg.get if isinstance(cfg, dict) else (lambda k, d=None: getattr(cfg, k, d))
    for key in ("num_experts", "n_routed_experts", "kv_lora_rank", "layer_types",
                "hybrid_override_pattern", "vision_config", "text_config"):
        if get(key):
            raise NotImplementedError(f"flops_per_token: {key} configs are not ported yet")
    d, L, v = get("hidden_size"), get("num_hidden_layers"), get("vocab_size")
    n = get("num_attention_heads")
    k = get("num_key_value_heads", n) or n
    h = get("head_dim") or d // n
    attn = 2 * d * (n + 2 * k) * h + 2 * n * h * d + 2 * 2 * seq_len * n * h
    mlp = 3 * 2 * d * get("intermediate_size")
    fwd = L * (attn + mlp) + 2 * d * v
    return 3.0 * fwd if training else fwd


def peak_tflops(device_name: str) -> float | None:
    key = device_name.lower()
    for name, tf in PEAK_TFLOPS.items():
        if name in key:
            return tf
    return None


def mfu(tokens_per_sec: float, flops_per_tok: float, device_name: str,
        n_devices: int = 1) -> float | None:
    """Model FLOPs utilisation in [0, 1]; None for a device without a known peak."""
    peak = peak_tflops(device_name)
    if peak is None:
        return None
    return tokens_per_sec * flops_per_tok / 1e12 / (peak * n_devices)
