"""Dense decoder, training path (counterpart of
``automodel_tpu/models/common/transformer.py``), with the JAX package's architecture
knobs of the Llama lineage: norm placement (pre, post, sandwich) and type (RMSNorm or the
mean-centred LayerNorm, with or without weight and bias), Cohere's parallel block,
interleaved and partial RoPE, NoPE layers, whole-projection and per-head LayerNorm q/k
norms, q/k/v clipping, ungated and biased MLPs with their activations, Granite's four
multipliers and Ministral-3's Llama-4 q scaling.

Parameters keep the JAX package's layout: one dict, layer tensors stacked along a
leading (L, ...) axis, so the weights of one package load into the other by name
and shape, and the optimizer sees the same tensor shapes in both.

  layers: attn_norm (L,D) | wq (L,D,N,H) | wk/wv (L,D,K,H) | wo (L,N,H,D)
          | mlp_norm (L,D) (none under parallel_block) | w_gate (L,D,I) (none when
          ungated) | w_up (L,D,I) | w_down (L,I,D)
          | [bq (L,N,H), bk/bv (L,K,H) with attention_bias] | [bo (L,D) with
          attention_out_bias] | [sinks (L,N) with attention_sinks]
          | [q_norm/k_norm (L,H) with qk_norm; (L,N,H)/(L,K,H) with qk_norm_whole or a
          layernorm qk_norm] | [b_gate/b_up (L,I), b_down (L,D) with mlp_bias]
          | [attn_norm_b/mlp_norm_b (L,D) with norm_bias] | [attn_post_norm /
          mlp_post_norm (L,D) with the sandwich placement]; no block norm weights at
          all without norm_param
  top:    embed (V,D) | [final_norm (D,) with norm_param] | [final_norm_b (D,) with
          norm_bias] | [lm_head (D,V) unless tied]

The forward unbinds the stacks once into per-layer views; the gradient of that
unbind stacks the per-layer gradients back in one copy.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from automodel_tpu_torch.models.common.backend import (PARALLEL_OUT, BackendConfig,
                                                       checkpoint_name, remat_name)
from automodel_tpu_torch.ops.attention import dot_product_attention
from automodel_tpu_torch.ops.norms import layer_norm, rms_norm
from automodel_tpu_torch.ops.rope import (apply_rope_interleaved_tables, apply_rope_tables,
                                          rope_attention_scaling, rope_frequencies,
                                          rope_tables, rope_tables_interleaved)
from automodel_tpu_torch.parallel.ring_attention import make_ring_attention

__all__ = ["DenseDecoderConfig", "apply_final_norm", "attention_block", "block_norm",
           "decoder_forward", "decoder_layer", "init_dense_decoder_params", "init_params",
           "layer_shapes", "layer_windows", "mlp_block", "param_shapes", "project",
           "resolve_unembed"]


@dataclasses.dataclass
class DenseDecoderConfig:
    """Architecture knobs shared by the Llama lineage (the JAX package's, field for
    field)."""

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
    rope_interleaved: bool = False  # consecutive-pair rotation (Cohere, GLM, Helium, Ernie)
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # bias on the q / k / v projections
    attention_out_bias: bool = False  # gpt-oss: bias on the o projection too
    attention_sinks: bool = False  # gpt-oss: a per-head sink logit in the softmax
    qk_norm: bool = False  # qwen3: RMSNorm over head_dim of each q / k head, before RoPE
    qk_norm_whole: bool = False  # olmo2: RMSNorm over the whole q / k projection (n*h)
    # "pre" (llama) | "post" (olmo2: the norm on the sublayer's output, none on its input)
    # | "sandwich" (glm4: the input norm and a second norm on the output)
    norm_placement: str = "pre"
    norm_type: str = "rms"  # "rms" | "layernorm" (mean-centred: cohere, starcoder2, olmo)
    norm_bias: bool = False  # starcoder2 / stablelm: a LayerNorm bias
    norm_param: bool = True  # False (olmo v1): LayerNorm without a weight
    parallel_block: bool = False  # cohere: h + attn(norm(h)) + mlp(norm(h)), one norm
    mlp_gated: bool = True  # False (arcee, starcoder2): down(act(up(x))), no gate matrix
    mlp_act: str = "silu"  # "silu" | "gelu" (tanh) | "gelu_exact" | "relu2" (arcee)
    mlp_bias: bool = False  # starcoder2: biases on the MLP projections
    clip_qkv: float | None = None  # olmo: clamp the q / k / v projections
    # the ungated MLP's HF tensor names where they differ from up_proj / down_proj
    # (starcoder2: c_fc / c_proj); None = Llama's
    hf_mlp_names: tuple[str, str] | None = None
    sliding_window: int | None = None
    layer_types: list[str] | None = None  # "full_attention" | "sliding_attention"
    # per-layer RoPE (1 = on), SmolLM3's and Cohere2's NoPE layers; None = RoPE everywhere
    no_rope_layers: list | None = None
    initializer_range: float = 0.02
    causal: bool = True
    # Granite's four scalars (1.0 / None: the Llama value, identity)
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float | None = None  # the softmax scale; None = head_dim ** -0.5
    logits_scaling: float = 1.0
    # Ministral-3's Llama-4 q scaling: q *= 1 + beta * log(1 + pos // orig)
    llama4_attn_scale_beta: float | None = None
    original_max_position_embeddings: int | None = None

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

    @property
    def nope_flags(self) -> list[bool]:
        """Which layers take no RoPE (bit 1 of JAX's ``layer_flags``)."""
        if self.no_rope_layers is None:
            return [False] * self.num_hidden_layers
        return [not on for on in self.no_rope_layers]

    @property
    def head_qk_norm(self) -> bool:
        """q / k norm weights of shape (heads, head_dim): the whole-projection RMSNorm
        (OLMo-2) or Cohere+'s per-head LayerNorm."""
        return self.qk_norm_whole or (self.qk_norm and self.norm_type == "layernorm")

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
    """Per-layer parameter shapes (without the stacked L axis), JAX's ``_layer_shapes``."""
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
    if cfg.parallel_block:
        del shapes["mlp_norm"]  # one input norm feeds both (cohere)
    if not cfg.mlp_gated:
        del shapes["w_gate"]
    if cfg.mlp_bias:
        shapes |= {"b_up": (i,), "b_down": (d,)}
        if cfg.mlp_gated:
            shapes |= {"b_gate": (i,)}
    if cfg.norm_bias:
        shapes |= {f"{name}_b": (d,) for name in ("attn_norm", "mlp_norm") if name in shapes}
    if not cfg.norm_param:  # olmo v1: the block norms hold no parameter at all
        for name in ("attn_norm", "mlp_norm"):
            shapes.pop(name, None)
    if cfg.norm_placement == "sandwich":
        shapes |= {"attn_post_norm": (d,), "mlp_post_norm": (d,)}
    if cfg.head_qk_norm:
        shapes |= {"q_norm": (n, h), "k_norm": (k, h)}
    elif cfg.qk_norm:
        shapes |= {"q_norm": (h,), "k_norm": (h,)}
    return shapes


def param_shapes(cfg: DenseDecoderConfig) -> dict[str, tuple[int, ...]]:
    """Flat name -> shape of every parameter (layer tensors as ``layers.<name>``)."""
    shapes = {"embed": (cfg.vocab_size, cfg.hidden_size)}
    shapes |= {f"layers.{n}": (cfg.num_hidden_layers, *s) for n, s in layer_shapes(cfg).items()}
    if cfg.norm_param:
        shapes["final_norm"] = (cfg.hidden_size,)
    if cfg.norm_bias:
        shapes["final_norm_b"] = (cfg.hidden_size,)
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (cfg.hidden_size, cfg.vocab_size)
    return shapes


_ZERO_INIT = ("bq", "bk", "bv", "bo", "sinks", "b_gate", "b_up", "b_down")


def init_params(shapes: dict[str, tuple[int, ...]], generator: torch.Generator, std: float,
                dtype=torch.float32, device=None) -> dict[str, torch.Tensor]:
    """Random init with HF's conventions: normal(0, std), norms at 1, biases (the
    attention's, the MLP's and the norms' ``*_b`` too) and sinks at 0, as the JAX
    package's init (a routing correction bias kept in f32). Draws on ``generator``'s
    device in the order of ``shapes``; the values are not the JAX package's (its
    generator differs), so comparisons carry weights across with
    :func:`automodel_tpu_torch.models.llama.convert.params_from_jax`."""
    out = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("norm"):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif leaf.endswith(("bias", "_b")) or leaf in _ZERO_INIT:
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
    """lm_head, or the tied embedding transposed, cast to the compute dtype, with
    Granite's ``logits_scaling`` (Cohere's ``logit_scale``, inverted) folded in as JAX
    folds it: logits / s == h @ (unembed / s). The cast and the division keep the layout,
    so a tied unembedding stays a transposed view of a row-major (V, E) tensor, which
    the linear-CE kernels read in place."""
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].t()
    w = w.to(dtype)
    scaling = getattr(cfg, "logits_scaling", 1.0)
    return w / scaling if scaling != 1.0 else w


def block_norm(cfg, x, w, b=None):
    """The block norm the config selects (JAX's ``_block_norm``): RMSNorm, or the
    mean-centred LayerNorm (``w`` None without norm_param, ``b`` its bias)."""
    if cfg.norm_type == "layernorm":
        return layer_norm(x, w, b, cfg.rms_norm_eps)
    return rms_norm(x, w, cfg.rms_norm_eps)


def apply_final_norm(cfg, params, h, dtype):
    """The final norm, whose weight and bias may be absent (OLMo v1, bias-free norms)."""
    w, b = params.get("final_norm"), params.get("final_norm_b")
    return block_norm(cfg, h, None if w is None else w.to(dtype),
                      None if b is None else b.to(dtype))


def _rms_norm_2d(x, w, eps):
    """RMSNorm over the last two dims, the whole q or k projection (OLMo-2): x (..., n, h),
    w (n, h), the weight applied after the cast, as JAX's ``_rms_norm_2d``."""
    xf = x.float()
    ms = xf.square().mean(dim=(-2, -1), keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * w


def project(x, w, n_in):
    """Contract x's trailing dims with w's first ``n_in`` dims (a plain matmul)."""
    in_shape, out_shape = w.shape[:n_in], w.shape[n_in:]
    k = 1
    for s in in_shape:
        k *= s
    x2 = x.reshape(*x.shape[: x.ndim - n_in], k)
    return torch.matmul(x2, w.reshape(k, -1)).reshape(*x2.shape[:-1], *out_shape)


def _llama4_q_scale(cfg, positions):
    """Ministral-3's (B, S) f32 factor on q: 1 + beta * log1p(floor(pos / orig))."""
    orig = cfg.original_max_position_embeddings or cfg.max_position_embeddings
    return 1.0 + cfg.llama4_attn_scale_beta * torch.log1p(torch.floor(positions.float() / orig))


def attention_block(cfg, backend, lp, x, positions, segment_ids, inv_freq=None, attn_scale=1.0,
                    mesh=None, *, rope=None, window=None, nope=False, out_name=None):
    """Self-attention of one layer on the normed input x, in JAX's order: projections
    (with their biases, added after each projection), ``clip_qkv``, the q/k norm (the
    whole-projection RMSNorm, Cohere+'s per-head LayerNorm or Qwen3's per-head RMSNorm),
    RoPE (rotate-half, or interleaved with ``rope_interleaved``; none on a NoPE layer,
    ``nope``), Ministral-3's q scale, attention at the softmax scale
    ``attention_multiplier`` (None: head_dim ** -0.5) with the layer's sliding ``window``
    and sinks (``lp["sinks"]``), and the output projection (and its bias). With
    ``context_parallel: ring`` and a mesh whose cp axis is larger than 1, attention is
    ring attention over cp, given positions and segment ids whatever
    ``attention_segments`` says, as JAX's ``use_ring``, under JAX's two other guards: not
    for a layer with sinks, and not in a stack with any sliding layer (JAX's full layers
    there carry a window too). The remat names (``attn_q`` / ``attn_k`` / ``attn_v``,
    ``attn_out``) sit where JAX sets them. ``rope``: the tables of ``rope_tables`` (or
    ``rope_tables_interleaved``), else computed from ``inv_freq`` and ``attn_scale``.
    ``out_name``: the output projection's remat name (a parallel block's
    ``PARALLEL_OUT``), or none."""
    with remat_name("attn_q"):
        q = project(x, lp["wq"], 1)
    with remat_name("attn_k"):
        k = project(x, lp["wk"], 1)
    with remat_name("attn_v"):
        v = project(x, lp["wv"], 1)
    if cfg.attention_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    if cfg.clip_qkv is not None:
        c = cfg.clip_qkv
        q, k, v = (t.clamp(-c, c) for t in (q, k, v))
    if cfg.qk_norm_whole:
        q = _rms_norm_2d(q, lp["q_norm"], cfg.rms_norm_eps)
        k = _rms_norm_2d(k, lp["k_norm"], cfg.rms_norm_eps)
    elif cfg.qk_norm and cfg.norm_type == "layernorm":
        q = layer_norm(q, lp["q_norm"], None, cfg.rms_norm_eps)
        k = layer_norm(k, lp["k_norm"], None, cfg.rms_norm_eps)
    elif cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    interleaved = cfg.rope_interleaved
    if not nope:
        if rope is None:
            tables = rope_tables_interleaved if interleaved else rope_tables
            rope = tables(positions, inv_freq, attn_scale)
        apply = apply_rope_interleaved_tables if interleaved else apply_rope_tables
        q = apply(q, *rope)
        k = apply(k, *rope)
    if cfg.llama4_attn_scale_beta is not None:
        q = q * _llama4_q_scale(cfg, positions)[..., None, None].to(q.dtype)
    scale = cfg.attention_multiplier
    sinks = lp.get("sinks")
    if (backend.context_parallel == "ring" and mesh is not None and mesh.cp > 1
            and sinks is None and not any(cfg.sliding_flags)):
        ring = make_ring_attention(mesh, causal=cfg.causal, softmax_scale=scale)
        out = checkpoint_name(ring(q, k, v, positions, segment_ids), "attn_out")
    else:
        # attention_segments=False: right-padded unpacked batches, where causal masking
        # alone keeps real tokens away from trailing pads (bidirectional stacks keep it)
        seg = segment_ids if (backend.attention_segments or not cfg.causal) else None
        out = checkpoint_name(dot_product_attention(
            q, k, v, causal=cfg.causal, segment_ids_q=seg, sliding_window=window, sinks=sinks,
            softmax_scale=scale, backend=backend.attention), "attn_out")
    with remat_name(out_name) if out_name else contextlib.nullcontext():
        o = project(out, lp["wo"], 2)
    return o + lp["bo"] if cfg.attention_out_bias else o


_MLP_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # HF "gelu_pytorch_tanh"
    "gelu_exact": F.gelu,  # HF's bare "gelu", the erf form
    "relu2": lambda x: torch.square(F.relu(x)),  # arcee
}


def mlp_block(cfg, lp, x, down_name=None):
    """The MLP of one layer on the normed input x: gated (``act(gate) * up``) or not
    (``act(up)``), with biases under ``mlp_bias``; its projections named as JAX names them
    (``mlp_up``, ``mlp_gate``), the down projection ``down_name`` (a parallel block's
    ``PARALLEL_OUT``) or none."""
    act = _MLP_ACTS[cfg.mlp_act]
    bias = cfg.mlp_bias
    with remat_name("mlp_up"):
        up = project(x, lp["w_up"], 1)
    if bias:
        up = up + lp["b_up"]
    if cfg.mlp_gated:
        with remat_name("mlp_gate"):
            gate = project(x, lp["w_gate"], 1)
        if bias:
            gate = gate + lp["b_gate"]
        h = act(gate) * up
    else:
        h = act(up)
    with remat_name(down_name) if down_name else contextlib.nullcontext():
        out = project(h, lp["w_down"], 1)
    return out + lp["b_down"] if bias else out


def decoder_layer(cfg, backend, names, h, positions, segment_ids, rope, mesh, window, nope,
                  *weights):
    """One decoder layer (JAX's ``make_layer_body``): pre-norm h + attn(norm(h)), then +
    mlp(norm(h)); "post" norms each sublayer's output instead of its input, "sandwich"
    adds a norm on the output to the input norm, and ``parallel_block`` adds attention
    and MLP of one normed input together. ``residual_multiplier`` scales each sublayer's
    output. ``rope``: the forward's tables (for a NoPE layer, those of a zero frequency, or
    None with ``nope`` set: the identity), ``window`` the layer's sliding window or None."""
    dtype = backend.torch_dtype
    lp = {n: w.to(dtype) for n, w in zip(names, weights)}

    def attention(x, out_name=None):
        return attention_block(cfg, backend, lp, x, positions, segment_ids, mesh=mesh, rope=rope,
                               window=window, nope=nope, out_name=out_name)

    if cfg.parallel_block:
        x = block_norm(cfg, h, lp.get("attn_norm"), lp.get("attn_norm_b"))
        # both output products named PARALLEL_OUT (see backend.py): a replay takes their
        # outputs, as JAX's skips them
        return (h + attention(x, out_name=PARALLEL_OUT)
                + mlp_block(cfg, lp, x, down_name=PARALLEL_OUT))
    post, sandwich = cfg.norm_placement == "post", cfg.norm_placement == "sandwich"
    x = h if post else block_norm(cfg, h, lp.get("attn_norm"), lp.get("attn_norm_b"))
    out = attention(x)
    if post:
        out = block_norm(cfg, out, lp.get("attn_norm"), lp.get("attn_norm_b"))
    elif sandwich:
        out = block_norm(cfg, out, lp["attn_post_norm"])
    if cfg.residual_multiplier != 1.0:
        out = out * cfg.residual_multiplier
    h = h + out
    x = h if post else block_norm(cfg, h, lp.get("mlp_norm"), lp.get("mlp_norm_b"))
    out = mlp_block(cfg, lp, x)
    if post:
        out = block_norm(cfg, out, lp.get("mlp_norm"), lp.get("mlp_norm_b"))
    elif sandwich:
        out = block_norm(cfg, out, lp["mlp_post_norm"])
    if cfg.residual_multiplier != 1.0:
        out = out * cfg.residual_multiplier
    return h + out


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
    attn_scale = rope_attention_scaling(cfg.rope_scaling)
    # the RoPE tables once a forward, not in each layer (and again in each replay)
    tables = rope_tables_interleaved if cfg.rope_interleaved else rope_tables
    rope = tables(positions, inv_freq, attn_scale)
    nope = cfg.nope_flags
    # JAX's NoPE layer runs RoPE at zero frequency: x * attn_scale on the rotary dims, the
    # identity at scale 1 (then skipped)
    nope_rope = (tables(positions, torch.zeros_like(inv_freq), attn_scale)
                 if any(nope) and attn_scale != 1.0 else None)
    h = F.embedding(input_ids.long(), params["embed"].to(dtype))
    if cfg.embedding_multiplier != 1.0:  # Granite; the factor in h's dtype first, as JAX's
        h = h * torch.tensor(cfg.embedding_multiplier, dtype=h.dtype)
    names = list(layer_shapes(cfg))
    per_layer = [params[f"layers.{n}"].unbind(0) for n in names]
    layer = backend.layer_remat(decoder_layer, selective=cfg.parallel_block)
    windows = layer_windows(cfg)
    for i in range(cfg.num_hidden_layers):
        weights = [w[i] for w in per_layer]
        h = layer(cfg, backend, names, h, positions, segment_ids,
                  nope_rope if nope[i] else rope, mesh, windows[i],
                  nope[i] and nope_rope is None, *weights)
    h = apply_final_norm(cfg, params, h, dtype)
    if return_hidden:
        return h
    return torch.matmul(h, resolve_unembed(cfg, params, dtype))
