"""Step-3.5 (counterpart of ``automodel_tpu/models/step3p5/model.py``), training path.

A layer of its own, not the MoE decoder's: zero-centred (1 + w) RMSNorms throughout;
full and sliding attention, where the sliding layers may take other head counts
(``attention_other_setting``); per-head q/k norms; the optional head-wise sigmoid gate
``wg`` on the attention output; per-layer RoPE theta, partial rotary factor and RoPE on
or off; MoE on an arbitrary ``moe_layers_enum`` set with a clamped-SwiGLU shared expert
beside plain-SwiGLU routed experts; the dense MLP is clamped SwiGLU too (the clamp after
silu on the gate, a symmetric one on up; a limit of 0 is none).

The parameters are JAX's four streams, one per (attention kind, FFN kind) present
(``full_mlp``, ``sliding_moe``, ...), each stacked over its layers in execution order:

  {stream}.attn_norm | mlp_norm | q_norm | k_norm (L, D or dh), wq (L, D, n, dh),
  wk / wv (L, D, kv, dh), wo (L, n, dh, D), [wg (L, D, n)],
  *_mlp: w_gate / w_up (L, D, I), w_down (L, I, D);
  *_moe: sh_gate / sh_up (L, D, Ish), sh_down (L, Ish, D), moe.* (the MoE block's)

The decode cache and ``generate`` are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.common.logical_axes import STEP3P5_LAYER_AXES
from automodel_tpu_torch.models.common.param_module import ParamModule
from automodel_tpu_torch.models.common.transformer import init_params, project
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.dispatch import make_moe_block_forward
from automodel_tpu_torch.moe.layers import (cast_moe_compute_params, moe_param_shapes,
                                            nest_moe_params)
from automodel_tpu_torch.ops.attention import dot_product_attention
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.rope import apply_rope_tables, rope_frequencies, rope_tables

__all__ = ["Step3p5Config", "Step3p5ForCausalLM", "step3p5_forward"]


@dataclasses.dataclass
class Step3p5Config:
    vocab_size: int = 1024
    hidden_size: int = 256
    intermediate_size: int = 512
    num_hidden_layers: int = 4
    num_attention_heads: int = 4
    num_attention_groups: int = 2  # kv heads (HF step3p5 naming)
    head_dim: int | None = None
    layer_types: tuple[str, ...] | None = None  # "full_attention" | "sliding_attention"
    attention_other_setting: dict[str, int] | None = None  # sliding-layer head counts
    sliding_window: int | None = None
    use_head_wise_attn_gate: bool = False
    rope_theta: float | tuple[float, ...] = 10000.0
    partial_rotary_factors: tuple[float, ...] | None = None
    use_rope_layers: tuple[bool, ...] | None = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    moe_layers_enum: tuple[int, ...] = ()
    share_expert_dim: int | None = None
    swiglu_limits: tuple[float, ...] | None = None  # routed experts (unused: plain SwiGLU)
    swiglu_limits_shared: tuple[float, ...] | None = None  # dense MLP and shared expert
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    moe: MoEConfig | None = None

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads
        if self.layer_types is None:
            self.layer_types = ("full_attention",) * self.num_hidden_layers
        if self.moe_layers_enum and self.moe is None:
            raise ValueError("moe_layers_enum set but no MoEConfig")

    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "Step3p5Config":
        """Build from an HF config.json dict, with the JAX package's reading of it
        (``moe_layers_enum`` as a comma-separated string or a list)."""
        moe = None
        moe_layers = hf.get("moe_layers_enum") or ()
        if isinstance(moe_layers, str):
            moe_layers = tuple(int(x) for x in moe_layers.split(",") if x.strip())
        else:
            moe_layers = tuple(int(x) for x in moe_layers)
        if moe_layers:
            activation = hf.get("moe_router_activation", "softmax")
            moe = MoEConfig(
                n_routed_experts=hf["moe_num_experts"],
                n_activated_experts=hf.get("moe_top_k", 2),
                dim=hf["hidden_size"],
                moe_inter_dim=hf.get("moe_intermediate_size", hf["intermediate_size"]),
                n_shared_experts=0,  # the shared expert is the layer's own (clamp, width)
                score_func="sigmoid" if activation == "sigmoid" else "softmax",
                softmax_before_topk=activation == "softmax",
                route_scale=hf.get("moe_router_scaling_factor", 1.0),
                norm_topk_prob=True,
                router_bias=hf.get("use_moe_router_bias", False),
            )
        theta = hf.get("rope_theta", 10000.0)

        def per_layer(key):
            return tuple(hf[key]) if hf.get(key) else None

        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_attention_groups=hf.get("num_attention_groups", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim"),
            layer_types=tuple(hf["layer_types"]) if hf.get("layer_types") else None,
            attention_other_setting=hf.get("attention_other_setting"),
            sliding_window=hf.get("sliding_window"),
            use_head_wise_attn_gate=hf.get("use_head_wise_attn_gate", False),
            rope_theta=tuple(theta) if isinstance(theta, (list, tuple)) else theta,
            partial_rotary_factors=per_layer("partial_rotary_factors"),
            use_rope_layers=per_layer("use_rope_layers"),
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            moe_layers_enum=moe_layers,
            share_expert_dim=hf.get("share_expert_dims", hf.get("share_expert_dim")),
            swiglu_limits=per_layer("swiglu_limits"),
            swiglu_limits_shared=per_layer("swiglu_limits_shared"),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            initializer_range=hf.get("initializer_range", 0.02),
            moe=moe,
        )

    # per-layer static settings, as JAX's
    def attn_kind(self, i: int) -> str:
        return "sliding" if self.layer_types[i] == "sliding_attention" else "full"

    def heads(self, i: int) -> tuple[int, int]:
        """(query heads, kv heads) of layer i."""
        if self.attn_kind(i) == "sliding" and self.attention_other_setting:
            other = self.attention_other_setting
            return (other.get("num_attention_heads", self.num_attention_heads),
                    other.get("num_attention_groups", self.num_attention_groups))
        return self.num_attention_heads, self.num_attention_groups

    def ffn_kind(self, i: int) -> str:
        return "moe" if i in set(self.moe_layers_enum) else "mlp"

    def theta(self, i: int) -> float:
        t = self.rope_theta
        return float(t[i]) if isinstance(t, (list, tuple)) else float(t)

    def prf(self, i: int) -> float:
        return float(self.partial_rotary_factors[i]) if self.partial_rotary_factors else 1.0

    def use_rope(self, i: int) -> bool:
        if self.use_rope_layers is not None and len(self.use_rope_layers) > i:
            return bool(self.use_rope_layers[i])
        return True

    def shared_limit(self, i: int) -> float | None:
        """The clamp of layer i's dense MLP or shared expert; 0 is none, as the reference."""
        v = self.swiglu_limits_shared[i] if self.swiglu_limits_shared else None
        return float(v) if v else None

    def stream_key(self, i: int) -> str:
        return f"{self.attn_kind(i)}_{self.ffn_kind(i)}"

    def stream_indices(self) -> dict[str, tuple[int, ...]]:
        """Stream name -> its layers, in the order the streams first appear."""
        out: dict[str, list[int]] = {}
        for i in range(self.num_hidden_layers):
            out.setdefault(self.stream_key(i), []).append(i)
        return {k: tuple(v) for k, v in out.items()}

    @property
    def sliding_flags(self) -> list[bool]:
        return [self.attn_kind(i) == "sliding" for i in range(self.num_hidden_layers)]

    @property
    def num_moe_layers(self) -> int:
        return sum(self.ffn_kind(i) == "moe" for i in range(self.num_hidden_layers))

    def stream_shapes(self, key: str) -> dict[str, tuple[int, ...]]:
        """One layer's parameters of stream ``key`` (JAX's ``_stream_shapes``)."""
        d, dh = self.hidden_size, self.head_dim
        n, kv = self.heads(self.stream_indices()[key][0])
        shapes = {"attn_norm": (d,), "mlp_norm": (d,), "wq": (d, n, dh), "wk": (d, kv, dh),
                  "wv": (d, kv, dh), "wo": (n, dh, d), "q_norm": (dh,), "k_norm": (dh,)}
        if self.use_head_wise_attn_gate:
            shapes["wg"] = (d, n)
        if key.endswith("_mlp"):
            i = self.intermediate_size
            return shapes | {"w_gate": (d, i), "w_up": (d, i), "w_down": (i, d)}
        sh = self.share_expert_dim or self.intermediate_size
        shapes |= {"sh_gate": (d, sh), "sh_up": (d, sh), "sh_down": (sh, d)}
        return shapes | {f"moe.{n}": s for n, s in moe_param_shapes(self.moe).items()}

    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        shapes = {"embed": (self.vocab_size, self.hidden_size), "final_norm": (self.hidden_size,)}
        for key, idx in self.stream_indices().items():
            shapes |= {f"{key}.{n}": (len(idx), *s) for n, s in self.stream_shapes(key).items()}
        if not self.tie_word_embeddings:
            shapes["lm_head"] = (self.hidden_size, self.vocab_size)
        return shapes


def _clamped_swiglu(x, w_gate, w_up, w_down, limit):
    """Step3p5MLP: the clamp after silu on the gate, a symmetric clamp on up."""
    gate = F.silu(x @ w_gate)
    up = x @ w_up
    if limit is not None:
        gate = gate.clamp(max=limit)
        up = up.clamp(-limit, limit)
    return (gate * up) @ w_down


def _layer(cfg, backend, moe_block, i, names, h, positions, segment_ids, token_mask, rope,
           *weights):
    """Layer i of the model: (1 + w)-normed attention with the layer's heads, window, RoPE
    and gate, then its clamped-SwiGLU MLP, or its shared expert beside the routed
    experts. Returns (h, aux, load); aux and load are zeros on an MLP layer."""
    dtype, eps = backend.torch_dtype, cfg.rms_norm_eps
    lp = {n: w for n, w in zip(names, weights)}
    moe = {n[4:]: lp.pop(n) for n in list(lp) if n.startswith("moe.")}
    lp = {n: w.to(dtype) for n, w in lp.items()}
    x = rms_norm(h, lp["attn_norm"], eps, offset=1.0)
    q = rms_norm(project(x, lp["wq"], 1), lp["q_norm"], eps, offset=1.0)
    k = rms_norm(project(x, lp["wk"], 1), lp["k_norm"], eps, offset=1.0)
    v = project(x, lp["wv"], 1)
    if rope is not None:
        q, k = apply_rope_tables(q, *rope), apply_rope_tables(k, *rope)
    window = cfg.sliding_window if cfg.attn_kind(i) == "sliding" else None
    out = dot_product_attention(q, k, v, causal=True, segment_ids_q=segment_ids,
                                sliding_window=window, backend=backend.attention)
    if cfg.use_head_wise_attn_gate:
        out = out * torch.sigmoid(x @ lp["wg"])[..., None]
    h = h + project(out, lp["wo"], 2)
    x = rms_norm(h, lp["mlp_norm"], eps, offset=1.0)
    limit = cfg.shared_limit(i)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if not moe:
        n_experts = cfg.moe.n_routed_experts if cfg.moe is not None else 1
        return (h + _clamped_swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"], limit), zero,
                torch.zeros(n_experts, dtype=torch.float32, device=h.device))
    share = _clamped_swiglu(x, lp["sh_gate"], lp["sh_up"], lp["sh_down"], limit)
    y, aux, load, _ = moe_block(cast_moe_compute_params(nest_moe_params(moe), dtype), x,
                                token_mask)
    return h + share + y, zero if aux is None else aux, load


def step3p5_forward(cfg: Step3p5Config, backend: BackendConfig, params: dict[str, torch.Tensor],
                    input_ids: torch.Tensor, positions: torch.Tensor | None = None,
                    segment_ids: torch.Tensor | None = None,
                    token_mask: torch.Tensor | None = None, return_hidden: bool = False,
                    training: bool = True) -> tuple[torch.Tensor, dict[str, Any]]:
    """``(logits or hidden, stats)``; stats: ``aux_loss`` (summed over the MoE layers, or
    None when the aux loss is off) and ``expert_load`` (L_moe, E) in layer order."""
    dtype = backend.torch_dtype
    if positions is None:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(
            input_ids.shape)
    emit_aux = (cfg.moe is not None and cfg.moe.aux_loss_coeff > 0 and training
                and not backend.fake_balanced_gate)
    moe_block = (make_moe_block_forward(cfg.moe, backend, training=training)
                 if cfg.moe is not None else None)
    tables: dict[tuple[float, float], tuple[torch.Tensor, torch.Tensor]] = {}
    streams = cfg.stream_indices()
    names = {key: list(cfg.stream_shapes(key)) for key in streams}
    stacked = {key: [params[f"{key}.{n}"].unbind(0) for n in names[key]] for key in streams}
    offsets = dict.fromkeys(streams, 0)
    layer = backend.layer_remat(_layer)
    h = F.embedding(input_ids.long(), params["embed"].to(dtype))
    auxs, loads = [], []
    for i in range(cfg.num_hidden_layers):
        key = cfg.stream_key(i)
        j = offsets[key]
        offsets[key] += 1
        rope = None
        if cfg.use_rope(i):
            meta = (cfg.theta(i), cfg.prf(i))
            if meta not in tables:  # one table a distinct (theta, factor), as JAX's
                inv_freq = rope_frequencies(cfg.head_dim, meta[0], None,
                                            partial_rotary_factor=meta[1],
                                            device=input_ids.device)
                tables[meta] = rope_tables(positions, inv_freq)
            rope = tables[meta]
        h, aux, load = layer(cfg, backend, moe_block, i, names[key], h, positions,
                             segment_ids, token_mask, rope, *[w[j] for w in stacked[key]])
        if cfg.ffn_kind(i) == "moe":
            auxs.append(aux)
            loads.append(load)
    h = rms_norm(h, params["final_norm"].to(dtype), cfg.rms_norm_eps, offset=1.0)
    n_experts = cfg.moe.n_routed_experts if cfg.moe is not None else 1
    stats = {"aux_loss": torch.stack(auxs).sum() if emit_aux else None,
             "expert_load": torch.stack(loads) if loads else
             torch.zeros(0, n_experts, device=h.device)}
    if return_hidden:
        return h, stats
    unembed = params.get("lm_head")
    unembed = params["embed"].t() if unembed is None else unembed
    return torch.matmul(h, unembed.to(dtype)), stats


class Step3p5ForCausalLM(ParamModule):
    """Holds Step-3.5's parameters (JAX's streams, flat names) and runs
    :func:`step3p5_forward`; the forward returns ``(logits or hidden, stats)``."""

    config_class = Step3p5Config
    layer_axes = STEP3P5_LAYER_AXES

    def __init__(self, config: Step3p5Config, backend: BackendConfig | None = None, *,
                 device: torch.device | str = "cuda", dtype=torch.float32,
                 generator: torch.Generator | None = None,
                 params: dict[str, torch.Tensor] | None = None):
        """Random weights from ``generator`` (seed 0 by default; the norms at 0, the (1 +
        w) convention), or ``params`` as given."""
        device = torch.device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            params = init_params(config.param_shapes(), generator, config.initializer_range,
                                 dtype, device)
            for name, p in params.items():
                if name.endswith("norm"):
                    p.zero_()
        super().__init__(params)
        self.config = config
        self.backend = backend or BackendConfig()

    @classmethod
    def from_config(cls, config, backend: BackendConfig | None = None, **kw):
        if isinstance(config, dict):
            config = cls.config_class.from_hf(config)
        return cls(config, backend, **kw)

    def forward(self, input_ids, positions=None, segment_ids=None, token_mask=None,
                return_hidden=False, training=True, mesh=None, params=None):
        """``mesh`` is unused: Step-3.5 has no ring branch (JAX's attends over the whole
        sequence under any cp)."""
        del mesh
        return step3p5_forward(self.config, self.backend,
                               self.param_dict() if params is None else params, input_ids,
                               positions=positions, segment_ids=segment_ids,
                               token_mask=token_mask, return_hidden=return_hidden,
                               training=training)

    def state_dict_adapter(self):
        from automodel_tpu_torch.models.step3p5.state_dict_adapter import (
            Step3p5StateDictAdapter)

        return Step3p5StateDictAdapter(self.config)
