"""Analytic training FLOPs and MFU (counterpart of ``automodel_tpu/utils/flops.py``,
GQA and MLA decoders with a dense or MoE MLP, and a multimodal wrapper's text model with
one image through its vision tower, as JAX counts a ``text_config`` / ``vision_config``
pair: Gemma3ForConditionalGeneration).

Train FLOPs = 3 x forward. The attention score term counts the full S x S product,
as the JAX package counts it, on sliding-window layers too (``layer_types``: each
attention layer, sliding or full, counts the same); a gated DeltaNet layer (Qwen3-Next's
linear attention, named in ``layer_types`` or implied by ``full_attention_interval``)
counts its projections and its state, not S x S. Mamba layers raise. An MoE layer counts its active
experts (top-k) plus shared experts, a dense prefix (``first_k_dense_replace``) the
dense MLP; the router's product is not counted, as in JAX. The routed experts are
``num_experts``, ``n_routed_experts`` or, in GPT-OSS's and Mixtral's configs,
``num_local_experts``: JAX's formula does not read the last, so it counts a GPT-OSS or
Mixtral layer's MLP as one dense MLP of ``intermediate_size`` where this one counts its
top-k experts (Mixtral: twice JAX's MLP term). Every MLP counts three matmuls, the
ungated two-matrix MLP (Arcee, StarCoder2) too, as JAX counts it. MFU is achieved over
the card's dense bf16 peak.
"""

from __future__ import annotations

from typing import Any

__all__ = ["PEAK_TFLOPS", "flops_per_token", "mfu", "peak_tflops", "vision_tower_flops"]

# dense bf16 peak per card, NVIDIA's data sheets (SXM parts, no sparsity)
PEAK_TFLOPS: dict[str, float] = {"h100": 989.0, "h200": 989.0}


def flops_per_token(cfg: Any, seq_len: int, training: bool = True) -> float:
    """FLOPs per token of a decoder given as an HF-config-like dict or object."""
    get = _getter(cfg)
    vision, text = get("vision_config"), get("text_config")
    if text is not None:
        get = _getter(text)
    for key in ("index_topk", "hybrid_override_pattern"):
        if get(key):
            raise NotImplementedError(f"flops_per_token: {key} configs are not ported yet")
    d, L, v = get("hidden_size"), get("num_hidden_layers"), get("vocab_size")
    kinds = _layer_kinds(get, L)
    if "mamba" in kinds:
        raise NotImplementedError("flops_per_token: mamba layers are not ported yet")
    inter = get("intermediate_size")
    attn = _mla_attn(get, seq_len) if get("kv_lora_rank") else _dense_attn(get, seq_len)
    linear = _linear_attn(get) if get("linear_num_key_heads") else attn
    attn_total = sum(linear if k == "linear" else attn for k in kinds)
    n_routed = get("num_experts") or get("n_routed_experts") or get("num_local_experts") or 0
    if n_routed:
        top_k = get("num_experts_per_tok") or get("top_k") or 1
        moe_inter = get("moe_intermediate_size") or inter
        shared = get("n_shared_experts") or 0
        dense = get("first_k_dense_replace") or 0
        moe_mlp = 3 * 2 * d * moe_inter * (top_k + shared)
        mlp_total = dense * 3 * 2 * d * inter + (L - dense) * moe_mlp
    else:
        mlp_total = L * 3 * 2 * d * inter
    fwd = attn_total + mlp_total + 2 * d * v
    if vision is not None:  # one image a sequence, amortised over its tokens
        fwd += vision_tower_flops(vision) / float(seq_len)
    return 3.0 * fwd if training else fwd


def _getter(cfg: Any):
    return cfg.get if isinstance(cfg, dict) else (lambda k, d=None: getattr(cfg, k, d))


def _layer_kinds(get, L: int) -> list[str]:
    """Each layer's kind, "attn" | "linear" | "mamba", as JAX's ``_layer_kinds`` reads a
    config: from ``layer_types``, else (a Qwen3-Next config without them) every
    ``full_attention_interval``-th layer full and the rest gated DeltaNet."""
    types = get("layer_types")
    if types:
        kinds = ["linear" if "linear" in str(t) else "mamba" if "mamba" in str(t) or t == "M"
                 else "attn" for t in types]
        return (kinds * (L // len(kinds) + 1))[:L]  # a table of the repeating block
    if get("linear_num_key_heads") and get("full_attention_interval"):
        interval = int(get("full_attention_interval"))
        return ["attn" if (i + 1) % interval == 0 else "linear" for i in range(L)]
    return ["attn"] * L


def _linear_attn(get) -> float:
    """A gated DeltaNet layer (JAX's formula): the q / k / v / z and b / a projections,
    the depthwise conv, the delta rule over each value head's (dk, dv) state (decay,
    rank-1 update, readout) and the output projection; no S x S term."""
    d = get("hidden_size")
    hk, dk = get("linear_num_key_heads"), get("linear_key_head_dim")
    hv, dv = get("linear_num_value_heads"), get("linear_value_head_dim")
    conv = get("linear_conv_kernel_dim", 4) or 4
    proj = 2 * d * (2 * hk * dk + 2 * hv * dv) + 2 * d * 2 * hv
    return (proj + 2 * (2 * hk * dk + hv * dv) * conv + 6 * hv * dk * dv
            + 2 * hv * dv * d)


def vision_tower_flops(cfg: Any) -> float:
    """Forward FLOPs of one image through a ViT tower (an HF ``vision_config``), JAX's
    count: the patch embedding as a matmul, then per layer full attention and an
    ungated two-matmul MLP over the patches and one class token."""
    get = _getter(cfg)
    d, inter, layers = get("hidden_size"), get("intermediate_size"), get("num_hidden_layers")
    patch = get("patch_size", 14) or 14
    num_patches = ((get("image_size", 336) or 336) // patch) ** 2
    n_pos = num_patches + 1
    patch_embed = num_patches * 2 * (3 * patch * patch) * d
    per_token = 2 * d * 3 * d + 2 * d * d + 2 * 2 * n_pos * d + 2 * 2 * d * inter
    return float(patch_embed + n_pos * layers * per_token)


def _dense_attn(get, seq_len: int) -> float:
    """A GQA layer's attention: q / k / v / o projections and the full S x S scores."""
    d, n = get("hidden_size"), get("num_attention_heads")
    k = get("num_key_value_heads", n) or n
    h = get("head_dim") or d // n
    return 2 * d * (n + 2 * k) * h + 2 * n * h * d + 2 * 2 * seq_len * n * h


def _mla_attn(get, seq_len: int) -> float:
    """An MLA layer's attention (JAX's formula): the low-rank or direct q projection,
    the kv latent and its up-projection, o, and scores at the qk width with values at
    ``v_head_dim``."""
    d, n = get("hidden_size"), get("num_attention_heads")
    nope, rope, vh = get("qk_nope_head_dim"), get("qk_rope_head_dim"), get("v_head_dim")
    qk = nope + rope
    q_rank, kv_rank = get("q_lora_rank"), get("kv_lora_rank")
    q = 2 * d * q_rank + 2 * q_rank * n * qk if q_rank else 2 * d * n * qk
    kv = 2 * d * (kv_rank + rope) + 2 * kv_rank * n * (nope + vh)
    return q + kv + 2 * n * vh * d + 2 * seq_len * n * qk + 2 * seq_len * n * vh


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
