"""Dense decoder, training path (counterpart of
``automodel_tpu/models/common/transformer.py``).

Parameters keep the JAX package's layout: one dict, layer tensors stacked along a
leading (L, ...) axis, so the weights of one package load into the other by name
and shape, and the optimizer sees the same tensor shapes in both.

  layers: attn_norm (L,D) | wq (L,D,N,H) | wk/wv (L,D,K,H) | wo (L,N,H,D)
          | mlp_norm (L,D) | w_gate/w_up (L,D,I) | w_down (L,I,D)
  top:    embed (V,D) | final_norm (D,) | [lm_head (D,V) unless tied]

The forward unbinds the stacks once into per-layer views; the gradient of that
unbind stacks the per-layer gradients back in one copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.ops.attention import dot_product_attention
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.rope import apply_rope, rope_attention_scaling, rope_frequencies

__all__ = ["DenseDecoderConfig", "decoder_forward", "init_dense_decoder_params",
           "layer_shapes", "resolve_unembed"]


@dataclasses.dataclass
class DenseDecoderConfig:
    """Architecture knobs of a Llama-style pre-norm decoder."""

    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 16
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int | None = None
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rope_scaling: dict[str, Any] | None = None
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    causal: bool = True

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads


def layer_shapes(cfg: DenseDecoderConfig) -> dict[str, tuple[int, ...]]:
    """Per-layer parameter shapes (without the stacked L axis)."""
    d, n, k, h, i = (cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim, cfg.intermediate_size)
    return {
        "attn_norm": (d,), "wq": (d, n, h), "wk": (d, k, h), "wv": (d, k, h),
        "wo": (n, h, d), "mlp_norm": (d,), "w_gate": (d, i), "w_up": (d, i),
        "w_down": (i, d),
    }


def param_shapes(cfg: DenseDecoderConfig) -> dict[str, tuple[int, ...]]:
    """Flat name -> shape of every parameter (layer tensors as ``layers.<name>``)."""
    shapes = {"embed": (cfg.vocab_size, cfg.hidden_size)}
    shapes |= {f"layers.{n}": (cfg.num_hidden_layers, *s) for n, s in layer_shapes(cfg).items()}
    shapes["final_norm"] = (cfg.hidden_size,)
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (cfg.hidden_size, cfg.vocab_size)
    return shapes


def init_dense_decoder_params(cfg: DenseDecoderConfig, generator: torch.Generator,
                              dtype=torch.float32, device=None) -> dict[str, torch.Tensor]:
    """Random init with HF's conventions: normal(0, initializer_range), norms at 1.

    Draws on ``generator``'s device; the values are not the JAX package's (its
    generator differs), so comparisons carry weights across with
    :func:`automodel_tpu_torch.models.llama.convert.params_from_jax`.
    """
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("norm"):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            w = torch.empty(shape, dtype=torch.float32, device=generator.device)
            w.normal_(0.0, cfg.initializer_range, generator=generator)
            out[name] = w.to(device=device, dtype=dtype)
    return out


def resolve_unembed(cfg: DenseDecoderConfig, params: dict, dtype) -> torch.Tensor:
    """lm_head, or the tied embedding transposed, cast to the compute dtype."""
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].t()
    return w.to(dtype)


def _project(x, w, n_in):
    """Contract x's trailing dims with w's first ``n_in`` dims (a plain matmul)."""
    in_shape, out_shape = w.shape[:n_in], w.shape[n_in:]
    k = 1
    for s in in_shape:
        k *= s
    x2 = x.reshape(*x.shape[: x.ndim - n_in], k)
    return torch.matmul(x2, w.reshape(k, -1)).reshape(*x2.shape[:-1], *out_shape)


def _layer(cfg, backend, names, h, positions, segment_ids, inv_freq, attn_scale, *weights):
    """One pre-norm decoder layer: h + attn(norm(h)), then + mlp(norm(h))."""
    dtype = backend.torch_dtype
    lp = {n: w.to(dtype) for n, w in zip(names, weights)}
    x = rms_norm(h, lp["attn_norm"], cfg.rms_norm_eps)
    q = apply_rope(_project(x, lp["wq"], 1), positions, inv_freq, attn_scale)
    k = apply_rope(_project(x, lp["wk"], 1), positions, inv_freq, attn_scale)
    v = _project(x, lp["wv"], 1)
    # attention_segments=False: right-padded unpacked batches, where causal masking
    # alone keeps real tokens away from trailing pads (bidirectional stacks keep it)
    seg = segment_ids if (backend.attention_segments or not cfg.causal) else None
    out = dot_product_attention(q, k, v, causal=cfg.causal, segment_ids_q=seg,
                                backend=backend.attention)
    h = h + _project(out, lp["wo"], 2)
    x = rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps)
    up = _project(x, lp["w_up"], 1)
    gate = _project(x, lp["w_gate"], 1)
    return h + _project(F.silu(gate) * up, lp["w_down"], 1)


def decoder_forward(
    cfg: DenseDecoderConfig,
    backend: BackendConfig,
    params: dict[str, torch.Tensor],
    input_ids: torch.Tensor,  # (B, S) int
    positions: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    return_hidden: bool = False,
) -> torch.Tensor:
    """Logits (B, S, V) in the compute dtype, or the final hidden states."""
    dtype = backend.torch_dtype
    if positions is None:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(
            input_ids.shape)
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                                device=input_ids.device)
    attn_scale = rope_attention_scaling(cfg.rope_scaling)
    h = F.embedding(input_ids.long(), params["embed"].to(dtype))
    names = list(layer_shapes(cfg))
    per_layer = [params[f"layers.{n}"].unbind(0) for n in names]
    for i in range(cfg.num_hidden_layers):
        weights = [w[i] for w in per_layer]
        args = (cfg, backend, names, h, positions, segment_ids, inv_freq, attn_scale, *weights)
        if backend.checkpoint_layers and torch.is_grad_enabled():
            h = checkpoint(_layer, *args, use_reentrant=False)
        else:
            h = _layer(*args)
    h = rms_norm(h, params["final_norm"].to(dtype), cfg.rms_norm_eps)
    if return_hidden:
        return h
    return torch.matmul(h, resolve_unembed(cfg, params, dtype))
