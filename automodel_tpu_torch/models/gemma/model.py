"""Gemma 2 / Gemma 3, text (counterpart of ``automodel_tpu/models/gemma/model.py``).

Not a Llama config delta: the layer body is Gemma's own.

- sandwich norms: input_layernorm -> attention -> post_attention_layernorm -> + residual;
  pre_feedforward_layernorm -> GeGLU MLP -> post_feedforward_layernorm -> + residual;
- zero-centred RMSNorm weights, ``x_norm * (1 + w)`` (``rms_norm(offset=1.0)``), which
  the init sets to 0;
- the embedding scaled by sqrt(hidden_size), the factor cast to the activation dtype
  first (HF's normalizer: 68.0 for 4608 in bf16);
- the softmax scale ``query_pre_attn_scalar ** -0.5``, not head_dim's;
- the gelu-tanh gated MLP;
- Gemma-2: the tanh soft-cap on the attention logits (inside the flash kernels on the
  card) and on the final logits, sliding and full layers alternating from a sliding one;
- Gemma-3: per-head q / k RMSNorm, and dual RoPE (sliding layers ``rope_local_base_freq``
  unscaled, full layers ``rope_theta`` with ``rope_scaling``), 5 sliding layers to 1 full.

Sliding layers pass the config's window to attention and full layers pass none (JAX's
layers run under one scan and give a full layer a window longer than any distance:
the same values). Attention takes the segment ids whatever ``attention_segments`` says,
as JAX's Gemma does. Under ``return_hidden`` (the linear-CE loss) no final soft-cap is
applied, as in JAX. The layer names no remat save (JAX's Gemma names none): a policy
that lists names saves nothing in a Gemma layer. Not ported: the decode cache and
``generate``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.common.logical_axes import GEMMA_LAYER_AXES
from automodel_tpu_torch.models.common.param_module import ParamModule
from automodel_tpu_torch.models.common.transformer import init_params, project, resolve_unembed
from automodel_tpu_torch.ops.attention import dot_product_attention
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.rope import apply_rope_tables, rope_frequencies, rope_tables

__all__ = ["GemmaConfig", "GemmaForCausalLM", "gemma_layer_shapes", "gemma_param_shapes"]


@dataclasses.dataclass
class GemmaConfig:
    vocab_size: int = 262144
    hidden_size: int = 2304
    intermediate_size: int = 9216
    num_hidden_layers: int = 26
    num_attention_heads: int = 8
    num_key_value_heads: int = 4
    head_dim: int = 256
    max_position_embeddings: int = 131072
    rope_theta: float = 1_000_000.0
    rope_local_base_freq: float | None = 10_000.0  # Gemma-3's sliding-layer RoPE
    rope_scaling: dict[str, Any] | None = None  # full layers only
    query_pre_attn_scalar: float = 256.0
    rms_norm_eps: float = 1e-6
    sliding_window: int | None = 4096
    layer_types: list[str] | None = None
    attn_logit_softcapping: float | None = None  # Gemma-2
    final_logit_softcapping: float | None = None  # Gemma-2
    qk_norm: bool = True  # Gemma-3; False for Gemma-2
    tie_word_embeddings: bool = True
    initializer_range: float = 0.02
    causal: bool = True

    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "GemmaConfig":
        """Build from an HF config.json dict as the JAX package reads it: Gemma-2's layers
        alternate from a sliding one, Gemma-3's run 5 sliding to 1 full (or as
        ``sliding_window_pattern`` / ``layer_types`` say); the soft-caps are read for
        Gemma-2 only, q / k norms and the local RoPE base for Gemma-3 only. A
        Gemma3ForConditionalGeneration dict is read through its ``text_config``."""
        hf = text_config(hf)
        is_g2 = "Gemma2" in "".join(hf.get("architectures") or [])
        layer_types = hf.get("layer_types")
        if layer_types is None:
            pattern = hf.get("sliding_window_pattern") or (2 if is_g2 else 6)
            layer_types = ["full_attention" if (i + 1) % pattern == 0 else "sliding_attention"
                           for i in range(hf["num_hidden_layers"])]
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim", 256),
            max_position_embeddings=hf.get("max_position_embeddings", 131072),
            rope_theta=hf.get("rope_theta", 10000.0 if is_g2 else 1_000_000.0),
            rope_local_base_freq=None if is_g2 else hf.get("rope_local_base_freq", 10_000.0),
            rope_scaling=hf.get("rope_scaling"),
            query_pre_attn_scalar=hf.get("query_pre_attn_scalar", 256.0),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            sliding_window=hf.get("sliding_window", 4096),
            layer_types=list(layer_types),
            attn_logit_softcapping=hf.get("attn_logit_softcapping") if is_g2 else None,
            final_logit_softcapping=hf.get("final_logit_softcapping") if is_g2 else None,
            qk_norm=not is_g2,
            tie_word_embeddings=hf.get("tie_word_embeddings", True),
            initializer_range=hf.get("initializer_range", 0.02),
        )

    @property
    def sliding_flags(self) -> list[bool]:
        if self.layer_types is not None:
            return [t == "sliding_attention" for t in self.layer_types]
        return [False] * self.num_hidden_layers

    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        return gemma_param_shapes(self)


def text_config(hf: dict[str, Any]) -> dict[str, Any]:
    """The text model's config of an HF dict: a multimodal wrapper's ``text_config``
    (with the wrapper's ``architectures``), else the dict itself."""
    if "text_config" not in hf:
        return hf
    inner = dict(hf["text_config"])
    inner.setdefault("architectures", hf.get("architectures"))
    return inner


def gemma_layer_shapes(cfg: GemmaConfig) -> dict[str, tuple[int, ...]]:
    """Per-layer parameter shapes (without the stacked L axis), JAX's names."""
    d, n, k, h, i = (cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim, cfg.intermediate_size)
    shapes = {
        "attn_norm": (d,), "post_attn_norm": (d,), "pre_ffn_norm": (d,), "post_ffn_norm": (d,),
        "wq": (d, n, h), "wk": (d, k, h), "wv": (d, k, h), "wo": (n, h, d),
        "w_gate": (d, i), "w_up": (d, i), "w_down": (i, d),
    }
    if cfg.qk_norm:
        shapes |= {"q_norm": (h,), "k_norm": (h,)}
    return shapes


def gemma_param_shapes(cfg: GemmaConfig) -> dict[str, tuple[int, ...]]:
    """Flat name -> shape of every parameter (layer tensors as ``layers.<name>``)."""
    shapes = {"embed": (cfg.vocab_size, cfg.hidden_size)}
    shapes |= {f"layers.{n}": (cfg.num_hidden_layers, *s)
               for n, s in gemma_layer_shapes(cfg).items()}
    shapes["final_norm"] = (cfg.hidden_size,)
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (cfg.hidden_size, cfg.vocab_size)
    return shapes


def gemma_layer(cfg, backend, names, h, segment_ids, rope, window, *weights):
    """One Gemma layer: h + post_norm(attn(norm(h))), then + post_norm(mlp(norm(h))).
    ``rope``: the layer's (cos, sin) tables (local or full); ``window``: its sliding
    window or None."""
    dtype = backend.torch_dtype
    lp = {n: w.to(dtype) for n, w in zip(names, weights)}
    eps = cfg.rms_norm_eps
    x = rms_norm(h, lp["attn_norm"], eps, offset=1.0)
    q, k, v = project(x, lp["wq"], 1), project(x, lp["wk"], 1), project(x, lp["wv"], 1)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], eps, offset=1.0)
        k = rms_norm(k, lp["k_norm"], eps, offset=1.0)
    q, k = apply_rope_tables(q, *rope), apply_rope_tables(k, *rope)
    out = dot_product_attention(
        q, k, v, causal=cfg.causal, segment_ids_q=segment_ids, sliding_window=window,
        softmax_scale=float(cfg.query_pre_attn_scalar) ** -0.5,
        logit_soft_cap=cfg.attn_logit_softcapping, backend=backend.attention)
    h = h + rms_norm(project(out, lp["wo"], 2), lp["post_attn_norm"], eps, offset=1.0)
    x = rms_norm(h, lp["pre_ffn_norm"], eps, offset=1.0)
    act = F.gelu(project(x, lp["w_gate"], 1), approximate="tanh") * project(x, lp["w_up"], 1)
    return h + rms_norm(project(act, lp["w_down"], 1), lp["post_ffn_norm"], eps, offset=1.0)


class GemmaForCausalLM(ParamModule):
    """Holds the parameters (JAX layout, flat names) and runs the Gemma stack."""

    config_class = GemmaConfig
    layer_axes = GEMMA_LAYER_AXES

    def __init__(self, config: GemmaConfig, backend: BackendConfig | None = None, *,
                 device: torch.device | str = "cuda", dtype=torch.float32,
                 generator: torch.Generator | None = None,
                 params: dict[str, torch.Tensor] | None = None):
        """Random weights from ``generator`` (seed 0 by default; norms at 0, the
        zero-centred scale), or ``params`` as given."""
        device = torch.device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            params = init_params(gemma_param_shapes(config), generator,
                                 config.initializer_range, dtype, device)
            for name, t in params.items():
                if name.endswith("norm"):
                    t.zero_()
        super().__init__(params)
        self.config = config
        self.backend = backend or BackendConfig()

    @classmethod
    def from_config(cls, config: GemmaConfig | dict, backend: BackendConfig | None = None,
                    **kw) -> "GemmaForCausalLM":
        if isinstance(config, dict):
            config = GemmaConfig.from_hf(config)
        return cls(config, backend, **kw)

    def state_dict_adapter(self):
        from automodel_tpu_torch.models.gemma.state_dict_adapter import GemmaStateDictAdapter

        return GemmaStateDictAdapter(self.config)

    def forward(self, input_ids, positions=None, segment_ids=None, return_hidden=False,
                mesh=None, params=None):
        """Logits (B, S, V) in the compute dtype (Gemma-2: soft-capped), or the final
        hidden states. ``mesh`` is accepted and unused: JAX's Gemma has no ring branch.
        ``params``: run on these tensors instead of the module's (a LoRA merge)."""
        del mesh
        cfg, backend = self.config, self.backend
        params = self.param_dict() if params is None else params
        dtype = backend.torch_dtype
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(
                input_ids.shape)
        h = F.embedding(input_ids.long(), params["embed"].to(dtype))
        h = h * torch.tensor(cfg.hidden_size**0.5, dtype=dtype)
        # the RoPE tables once a forward: full layers scale by rope_scaling, sliding layers
        # (Gemma-3) use the unscaled local base
        device = input_ids.device
        full = rope_tables(positions, rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                                       cfg.rope_scaling, device=device))
        local = full if cfg.rope_local_base_freq is None else rope_tables(
            positions, rope_frequencies(cfg.head_dim, cfg.rope_local_base_freq, device=device))
        names = list(gemma_layer_shapes(cfg))
        per_layer = [params[f"layers.{n}"].unbind(0) for n in names]
        layer = backend.layer_remat(gemma_layer)
        window = cfg.sliding_window
        for i, sliding in enumerate(cfg.sliding_flags):
            h = layer(cfg, backend, names, h, segment_ids, local if sliding else full,
                      window if sliding else None, *[w[i] for w in per_layer])
        h = rms_norm(h, params["final_norm"].to(dtype), cfg.rms_norm_eps, offset=1.0)
        if return_hidden:
            return h
        logits = torch.matmul(h, resolve_unembed(cfg, params, dtype))
        if cfg.final_logit_softcapping:
            cap = cfg.final_logit_softcapping
            logits = torch.tanh(logits / cap) * cap
        return logits
