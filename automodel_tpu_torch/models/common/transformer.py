"""Dense decoder, training path (counterpart of
``automodel_tpu/models/common/transformer.py``).

Parameters keep the JAX package's layout: one dict, layer tensors stacked along a
leading (L, ...) axis, so the weights of one package load into the other by name
and shape, and the optimizer sees the same tensor shapes in both.

  layers: attn_norm (L,D) | wq (L,D,N,H) | wk/wv (L,D,K,H) | wo (L,N,H,D)
          | mlp_norm (L,D) | w_gate/w_up (L,D,I) | w_down (L,I,D)
          | [bq (L,N,H), bk/bv (L,K,H) with attention_bias] | [bo (L,D) with
          attention_out_bias] | [sinks (L,N) with attention_sinks]
          | [q_norm/k_norm (L,H) with qk_norm]
  top:    embed (V,D) | final_norm (D,) | [lm_head (D,V) unless tied]

The forward unbinds the stacks once into per-layer views; the gradient of that
unbind stacks the per-layer gradients back in one copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from automodel_tpu_torch.models.common.backend import BackendConfig, checkpoint_name, remat_name
from automodel_tpu_torch.ops.attention import dot_product_attention
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.rope import (apply_rope_tables, rope_attention_scaling,
                                          rope_frequencies, rope_tables)
from automodel_tpu_torch.parallel.ring_attention import make_ring_attention

__all__ = ["DenseDecoderConfig", "attention_block", "decoder_forward", "decoder_layer",
           "init_dense_decoder_params", "init_params", "layer_shapes", "layer_windows",
           "mlp_block", "param_shapes", "project", "resolve_unembed"]


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
    partial_rotary_factor: float = 1.0  # RoPE on the first fraction of head_dim only
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # bias on the q / k / v projections
    attention_out_bias: bool = False  # gpt-oss: bias on the o projection too
    attention_sinks: bool = False  # gpt-oss: a per-head sink logit in the softmax
    initializer_range: float = 0.02
    causal: bool = True
    qk_norm: bool = False  # qwen3: RMSNorm over head_dim of each q / k head, before RoPE
    sliding_window: int | None = None
    layer_types: list[str] | None = None  # "full_attention" | "sliding_attention"

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads

    @property
    def sliding_flags(self) -> list[bool]:
        """Which layers attend through the sliding window, as the JAX package reads it."""
        if self.layer_types is not None:
            return [t == "sliding_attention" for t in self.layer_types]
        if self.sliding_window is not None:
            return [True] * self.num_hidden_layers
        return [False] * self.num_hidden_layers

    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        """Flat name -> shape of every parameter of this config's model: the hook
        through which a family with its own tree gives its shapes."""
        return param_shapes(self)


def layer_windows(cfg: DenseDecoderConfig) -> list[int | None]:
    """Each layer's sliding window, or None. JAX gives a full layer of a mixed stack a
    window longer than any distance (its layers run under one scan); here such a layer
    has none and runs the unwindowed kernels, which compute the same."""
    window = int(cfg.sliding_window or 0)
    return [window if flag else None for flag in cfg.sliding_flags]


def layer_shapes(cfg: DenseDecoderConfig) -> dict[str, tuple[int, ...]]:
    """Per-layer parameter shapes (without the stacked L axis)."""
    d, n, k, h, i = (cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim, cfg.intermediate_size)
    shapes = {
        "attn_norm": (d,), "wq": (d, n, h), "wk": (d, k, h), "wv": (d, k, h),
        "wo": (n, h, d), "mlp_norm": (d,), "w_gate": (d, i), "w_up": (d, i),
        "w_down": (i, d),
    }
    if cfg.attention_bias:
        shapes |= {"bq": (n, h), "bk": (k, h), "bv": (k, h)}
    if cfg.attention_out_bias:
        shapes |= {"bo": (d,)}
    if cfg.attention_sinks:
        shapes |= {"sinks": (n,)}
    if cfg.qk_norm:
        shapes |= {"q_norm": (h,), "k_norm": (h,)}
    return shapes


def param_shapes(cfg: DenseDecoderConfig) -> dict[str, tuple[int, ...]]:
    """Flat name -> shape of every parameter (layer tensors as ``layers.<name>``)."""
    shapes = {"embed": (cfg.vocab_size, cfg.hidden_size)}
    shapes |= {f"layers.{n}": (cfg.num_hidden_layers, *s) for n, s in layer_shapes(cfg).items()}
    shapes["final_norm"] = (cfg.hidden_size,)
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (cfg.hidden_size, cfg.vocab_size)
    return shapes


_ZERO_INIT = ("bq", "bk", "bv", "bo", "sinks")


def init_params(shapes: dict[str, tuple[int, ...]], generator: torch.Generator, std: float,
                dtype=torch.float32, device=None) -> dict[str, torch.Tensor]:
    """Random init with HF's conventions: normal(0, std), norms at 1, biases (the
    attention's bq / bk / bv / bo too) and sinks at 0, as the JAX package's init (a routing
    correction bias kept in f32). Draws on ``generator``'s device in the order of
    ``shapes``; the values are not the JAX package's (its generator differs), so
    comparisons carry weights across with
    :func:`automodel_tpu_torch.models.llama.convert.params_from_jax`."""
    out = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("norm"):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif leaf.endswith("bias") or leaf in _ZERO_INIT:
            keep_f32 = leaf == "score_correction_bias"
            out[name] = torch.zeros(shape, dtype=torch.float32 if keep_f32 else dtype,
                                    device=device)
        else:
            w = torch.empty(shape, dtype=torch.float32, device=generator.device)
            w.normal_(0.0, std, generator=generator)
            out[name] = w.to(device=device, dtype=dtype)
    return out


def init_dense_decoder_params(cfg: DenseDecoderConfig, generator: torch.Generator,
                              dtype=torch.float32, device=None) -> dict[str, torch.Tensor]:
    """Random init of every parameter of :func:`param_shapes` (see :func:`init_params`)."""
    return init_params(param_shapes(cfg), generator, cfg.initializer_range, dtype, device)


def resolve_unembed(cfg: DenseDecoderConfig, params: dict, dtype) -> torch.Tensor:
    """lm_head, or the tied embedding transposed, cast to the compute dtype. The cast
    keeps the layout, so a tied unembedding stays a transposed view of a row-major
    (V, E) tensor, which the linear-CE kernels read in place."""
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].t()
    return w.to(dtype)


def project(x, w, n_in):
    """Contract x's trailing dims with w's first ``n_in`` dims (a plain matmul)."""
    in_shape, out_shape = w.shape[:n_in], w.shape[n_in:]
    k = 1
    for s in in_shape:
        k *= s
    x2 = x.reshape(*x.shape[: x.ndim - n_in], k)
    return torch.matmul(x2, w.reshape(k, -1)).reshape(*x2.shape[:-1], *out_shape)


def attention_block(cfg, backend, lp, x, positions, segment_ids, inv_freq=None, attn_scale=1.0,
                    mesh=None, *, rope=None, window=None):
    """Self-attention of one layer on the normed input x: projections (with their biases,
    added after each projection as JAX adds them), per-head q/k RMSNorm (``qk_norm``),
    RoPE, attention with the layer's sliding ``window`` and sinks (``lp["sinks"]``), and
    the output projection (and its bias). With ``context_parallel: ring`` and a mesh whose
    cp axis is larger than 1, attention is ring attention over cp, given positions and
    segment ids whatever ``attention_segments`` says, as JAX's ``use_ring``, under JAX's
    two other guards: not for a layer with sinks, and not in a stack with any sliding
    layer (JAX's full layers there carry a window too). The softmax scale is head_dim **
    -0.5 on both paths: JAX's ``attention_multiplier`` (Granite) is refused by
    ``LlamaConfig.from_hf`` until that family is ported. The remat names (``attn_q`` /
    ``attn_k`` / ``attn_v``, ``attn_out``) sit where JAX sets them. ``rope``: the (cos,
    sin) of ``rope_tables``, else computed from ``inv_freq`` and ``attn_scale``."""
    with remat_name("attn_q"):
        q = project(x, lp["wq"], 1)
    with remat_name("attn_k"):
        k = project(x, lp["wk"], 1)
    with remat_name("attn_v"):
        v = project(x, lp["wv"], 1)
    if cfg.attention_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    if rope is None:
        rope = rope_tables(positions, inv_freq, attn_scale)
    q = apply_rope_tables(q, *rope)
    k = apply_rope_tables(k, *rope)
    sinks = lp.get("sinks")
    if (backend.context_parallel == "ring" and mesh is not None and mesh.cp > 1
            and sinks is None and not any(cfg.sliding_flags)):
        ring = make_ring_attention(mesh, causal=cfg.causal)
        out = checkpoint_name(ring(q, k, v, positions, segment_ids), "attn_out")
    else:
        # attention_segments=False: right-padded unpacked batches, where causal masking
        # alone keeps real tokens away from trailing pads (bidirectional stacks keep it)
        seg = segment_ids if (backend.attention_segments or not cfg.causal) else None
        out = checkpoint_name(dot_product_attention(
            q, k, v, causal=cfg.causal, segment_ids_q=seg, sliding_window=window, sinks=sinks,
            backend=backend.attention), "attn_out")
    o = project(out, lp["wo"], 2)
    return o + lp["bo"] if cfg.attention_out_bias else o


def decoder_layer(cfg, backend, names, h, positions, segment_ids, rope, mesh, window, *weights):
    """One pre-norm decoder layer: h + attn(norm(h)), then + mlp(norm(h)); ``rope`` is the
    forward's ``rope_tables``, ``window`` the layer's sliding window or None."""
    dtype = backend.torch_dtype
    lp = {n: w.to(dtype) for n, w in zip(names, weights)}
    x = rms_norm(h, lp["attn_norm"], cfg.rms_norm_eps)
    h = h + attention_block(cfg, backend, lp, x, positions, segment_ids, mesh=mesh, rope=rope,
                            window=window)
    return h + mlp_block(lp, rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps))


def mlp_block(lp, x):
    """The SwiGLU MLP of one layer on the normed input x, its projections named as JAX
    names them (``mlp_up``, ``mlp_gate``)."""
    with remat_name("mlp_up"):
        up = project(x, lp["w_up"], 1)
    with remat_name("mlp_gate"):
        gate = project(x, lp["w_gate"], 1)
    return project(F.silu(gate) * up, lp["w_down"], 1)


def decoder_forward(
    cfg: DenseDecoderConfig,
    backend: BackendConfig,
    params: dict[str, torch.Tensor],
    input_ids: torch.Tensor,  # (B, S) int
    positions: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    return_hidden: bool = False,
    mesh=None,
) -> torch.Tensor:
    """Logits (B, S, V) in the compute dtype, or the final hidden states. ``mesh``: a
    ``parallel.mesh.MeshContext`` (its cp axis drives ring attention), or None."""
    dtype = backend.torch_dtype
    if positions is None:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(
            input_ids.shape)
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                                cfg.partial_rotary_factor, device=input_ids.device)
    # the RoPE tables once a forward, not in each layer (and again in each replay)
    rope = rope_tables(positions, inv_freq, rope_attention_scaling(cfg.rope_scaling))
    h = F.embedding(input_ids.long(), params["embed"].to(dtype))
    names = list(layer_shapes(cfg))
    per_layer = [params[f"layers.{n}"].unbind(0) for n in names]
    layer = backend.layer_remat(decoder_layer)
    windows = layer_windows(cfg)
    for i in range(cfg.num_hidden_layers):
        weights = [w[i] for w in per_layer]
        h = layer(cfg, backend, names, h, positions, segment_ids, rope, mesh, windows[i],
                  *weights)
    h = rms_norm(h, params["final_norm"].to(dtype), cfg.rms_norm_eps)
    if return_hidden:
        return h
    return torch.matmul(h, resolve_unembed(cfg, params, dtype))
