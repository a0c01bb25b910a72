"""Qwen3-Next (counterpart of ``automodel_tpu/models/qwen3_next/model.py``), training path.

A hybrid decoder: most layers mix tokens with the gated DeltaNet recurrence
(``ops/gated_delta.py``), every ``full_attention_interval``-th layer is gated full
attention (q carries a per-head sigmoid output gate, q/k norms are (1 + w)), and every
layer's MLP is Qwen's MoE with a gated shared expert. The parameters are two stacks in
execution order, ``linear_layers`` and ``full_layers`` (HF's fused projections stay
fused, as JAX keeps them):

  linear_layers: attn_norm | mlp_norm (L, D), wqkvz (L, D, Hk, 2dk + 2r dv) (per key
      head [q | k | v r | z r]), wba (L, D, Hk, 2r), conv_w (L, C, K), dt_bias | a_log
      (L, Hv) (a_log kept in f32), norm (L, dv), wo (L, Hv, dv, D), moe.*
  full_layers:   attn_norm | mlp_norm, wq (L, D, H, 2dh) (per head [q | gate]),
      wk / wv (L, D, KH, dh), wo (L, H, dh, D), q_norm | k_norm (L, dh), moe.*

A Python loop runs the layers (JAX scans over periods of P - 1 linear layers and a full
one; the values are the same). The decode cache and ``generate`` are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.common.logical_axes import QWEN3_NEXT_LAYER_AXES
from automodel_tpu_torch.models.common.param_module import ParamModule
from automodel_tpu_torch.models.common.transformer import init_params, project
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.dispatch import make_moe_block_forward
from automodel_tpu_torch.moe.layers import (cast_moe_compute_params, moe_param_shapes,
                                            nest_moe_params)
from automodel_tpu_torch.ops.attention import dot_product_attention
from automodel_tpu_torch.ops.gated_delta import (causal_conv1d, chunk_gated_delta_rule,
                                                 gated_rms_norm)
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.rope import (apply_rope_tables, rope_attention_scaling,
                                          rope_frequencies, rope_tables)
from automodel_tpu_torch.utils.tracing import scoped

__all__ = ["FULL", "LINEAR", "Qwen3NextConfig", "Qwen3NextForCausalLM", "qwen3_next_forward"]

LINEAR = "linear_attention"
FULL = "full_attention"


@dataclasses.dataclass
class Qwen3NextConfig:
    vocab_size: int = 1024
    hidden_size: int = 256
    intermediate_size: int = 512
    num_hidden_layers: int = 4
    layer_types: tuple[str, ...] = (LINEAR, LINEAR, LINEAR, FULL)
    # full attention
    num_attention_heads: int = 4
    num_key_value_heads: int = 2
    head_dim: int = 64
    partial_rotary_factor: float = 0.25
    rope_theta: float = 10000.0
    rope_scaling: dict[str, Any] | None = None
    # gated DeltaNet
    linear_num_value_heads: int = 4
    linear_num_key_heads: int = 2
    linear_key_head_dim: int = 32
    linear_value_head_dim: int = 32
    linear_conv_kernel_dim: int = 4
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 4096
    initializer_range: float = 0.02
    moe: MoEConfig | None = None

    def __post_init__(self):
        if self.moe is None:
            raise ValueError("Qwen3NextConfig requires a MoEConfig in .moe")
        if len(self.layer_types) != self.num_hidden_layers:
            raise ValueError("layer_types length must equal num_hidden_layers")

    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "Qwen3NextConfig":
        """Build from an HF config.json dict, with the JAX package's reading of it (the
        layer pattern from ``layer_types``, else from ``full_attention_interval``)."""
        if hf.get("mlp_only_layers"):
            raise NotImplementedError("qwen3_next dense-MLP layers are not supported")
        rope = hf.get("rope_parameters") or {}
        rope_scaling = hf.get("rope_scaling")
        if rope_scaling is None and rope.get("rope_type", "default") != "default":
            rope_scaling = rope
        layer_types = hf.get("layer_types")
        if layer_types is None:
            interval = hf.get("full_attention_interval", 4)
            layer_types = [FULL if (i + 1) % interval == 0 else LINEAR
                           for i in range(hf["num_hidden_layers"])]
        moe = MoEConfig(
            n_routed_experts=hf["num_experts"],
            n_activated_experts=hf["num_experts_per_tok"],
            dim=hf["hidden_size"],
            moe_inter_dim=hf["moe_intermediate_size"],
            n_shared_experts=1,
            shared_expert_inter_dim=hf.get("shared_expert_intermediate_size",
                                           hf["moe_intermediate_size"]),
            shared_expert_gate=True,
            score_func="softmax",
            softmax_before_topk=True,
            norm_topk_prob=hf.get("norm_topk_prob", True),
            aux_loss_coeff=hf.get("router_aux_loss_coef", 0.0),
        )
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf.get("intermediate_size", 0),
            num_hidden_layers=hf["num_hidden_layers"],
            layer_types=tuple(layer_types),
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf["num_key_value_heads"],
            head_dim=hf.get("head_dim", hf["hidden_size"] // hf["num_attention_heads"]),
            partial_rotary_factor=rope.get("partial_rotary_factor",
                                           hf.get("partial_rotary_factor", 0.25)),
            rope_theta=rope.get("rope_theta", hf.get("rope_theta", 10000.0)),
            rope_scaling=rope_scaling,
            linear_num_value_heads=hf["linear_num_value_heads"],
            linear_num_key_heads=hf["linear_num_key_heads"],
            linear_key_head_dim=hf["linear_key_head_dim"],
            linear_value_head_dim=hf["linear_value_head_dim"],
            linear_conv_kernel_dim=hf["linear_conv_kernel_dim"],
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
            initializer_range=hf.get("initializer_range", 0.02),
            moe=moe,
        )

    @property
    def linear_layer_indices(self) -> tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == LINEAR)

    @property
    def full_layer_indices(self) -> tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == FULL)

    @property
    def num_moe_layers(self) -> int:
        return self.num_hidden_layers  # every layer's MLP is the MoE block

    @property
    def conv_dim(self) -> int:
        return (2 * self.linear_num_key_heads * self.linear_key_head_dim
                + self.linear_num_value_heads * self.linear_value_head_dim)

    def linear_shapes(self) -> dict[str, tuple[int, ...]]:
        """A DeltaNet layer's parameters (JAX's ``_linear_attn_shapes``)."""
        d, hk, dk = self.hidden_size, self.linear_num_key_heads, self.linear_key_head_dim
        hv, dv = self.linear_num_value_heads, self.linear_value_head_dim
        r = hv // hk
        return {"attn_norm": (d,), "mlp_norm": (d,), "wqkvz": (d, hk, 2 * dk + 2 * r * dv),
                "wba": (d, hk, 2 * r), "conv_w": (self.conv_dim, self.linear_conv_kernel_dim),
                "dt_bias": (hv,), "a_log": (hv,), "norm": (dv,), "wo": (hv, dv, d)}

    def full_shapes(self) -> dict[str, tuple[int, ...]]:
        """A gated full-attention layer's parameters (JAX's ``_full_attn_shapes``)."""
        d, h, kh, dh = (self.hidden_size, self.num_attention_heads, self.num_key_value_heads,
                        self.head_dim)
        return {"attn_norm": (d,), "mlp_norm": (d,), "wq": (d, h, 2 * dh), "wk": (d, kh, dh),
                "wv": (d, kh, dh), "wo": (h, dh, d), "q_norm": (dh,), "k_norm": (dh,)}

    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        shapes = {"embed": (self.vocab_size, self.hidden_size), "final_norm": (self.hidden_size,)}
        moe = {f"moe.{n}": s for n, s in moe_param_shapes(self.moe).items()}
        for stack, idx, layer in (("linear_layers", self.linear_layer_indices, self.linear_shapes),
                                  ("full_layers", self.full_layer_indices, self.full_shapes)):
            if idx:
                shapes |= {f"{stack}.{n}": (len(idx), *s) for n, s in (layer() | moe).items()}
        if not self.tie_word_embeddings:
            shapes["lm_head"] = (self.hidden_size, self.vocab_size)
        return shapes


def _split_moe(lp: dict) -> dict:
    return nest_moe_params({n[4:]: lp.pop(n) for n in list(lp) if n.startswith("moe.")})


def gated_delta_attention(cfg: Qwen3NextConfig, lp: dict, x: torch.Tensor,
                          segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """The gated DeltaNet token mixer on the normed input x (B, S, D) (HF's
    ``Qwen3NextGatedDeltaNet.forward``; JAX's ``_gated_delta_attn``, training form).

    Packed rows: a log decay of -50 at each segment start, which the within-segment
    differences of the cumulative sums cancel exactly, zeroes every cross-segment path
    (the state carried, the intra-chunk attention, the chunk state's write); the conv
    masks its cross-segment taps itself."""
    b, s, _ = x.shape
    hk, dk = cfg.linear_num_key_heads, cfg.linear_key_head_dim
    hv, dv = cfg.linear_num_value_heads, cfg.linear_value_head_dim
    r = hv // hk
    qkvz = project(x, lp["wqkvz"], 1)  # (B, S, Hk, 2dk + 2r dv)
    ba = project(x, lp["wba"], 1)  # (B, S, Hk, 2r)
    q, k = qkvz[..., :dk], qkvz[..., dk:2 * dk]
    v = qkvz[..., 2 * dk:2 * dk + r * dv].reshape(b, s, hv, dv)
    z = qkvz[..., 2 * dk + r * dv:].reshape(b, s, hv, dv)
    beta = torch.sigmoid(ba[..., :r].reshape(b, s, hv).float())
    a = ba[..., r:].reshape(b, s, hv)
    g = -torch.exp(lp["a_log"].float()) * F.softplus(a.float() + lp["dt_bias"].float())
    if segment_ids is not None:
        start = torch.zeros_like(segment_ids, dtype=torch.bool)
        start[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
        g = g + torch.where(start, -50.0, 0.0)[..., None]
    mixed = torch.cat([q.reshape(b, s, hk * dk), k.reshape(b, s, hk * dk),
                       v.reshape(b, s, hv * dv)], dim=-1)
    conv = causal_conv1d(mixed, lp["conv_w"], segment_ids=segment_ids)
    q, k, v = conv.split([hk * dk, hk * dk, hv * dv], dim=-1)
    q = q.reshape(b, s, hk, dk).repeat_interleave(r, dim=2)
    k = k.reshape(b, s, hk, dk).repeat_interleave(r, dim=2)
    core, _ = chunk_gated_delta_rule(q, k, v.reshape(b, s, hv, dv), g, beta,
                                     chunk_size=min(64, s))
    core = gated_rms_norm(core, lp["norm"], z, cfg.rms_norm_eps)
    return project(core, lp["wo"], 2)


def gated_full_attention(cfg: Qwen3NextConfig, backend: BackendConfig, lp: dict,
                         x: torch.Tensor, segment_ids, rope) -> torch.Tensor:
    """Full attention with a per-head sigmoid output gate (JAX's ``_gated_full_attn``):
    q and its gate from one projection, (1 + w) q/k norms, RoPE from the tables ``rope``,
    flash (or the plain path) with the segment ids on q and kv."""
    dh, eps = cfg.head_dim, cfg.rms_norm_eps
    qg = project(x, lp["wq"], 1)
    q, gate = qg[..., :dh], qg[..., dh:]
    q = apply_rope_tables(rms_norm(q, lp["q_norm"], eps, offset=1.0), *rope)
    k = apply_rope_tables(rms_norm(project(x, lp["wk"], 1), lp["k_norm"], eps, offset=1.0),
                          *rope)
    v = project(x, lp["wv"], 1)
    out = dot_product_attention(q, k, v, causal=True, segment_ids_q=segment_ids,
                                segment_ids_kv=segment_ids, backend=backend.attention)
    return project(out * torch.sigmoid(gate), lp["wo"], 2)


# the mixers and the MoE block under JAX's scope names, for the profiler's per-scope times
_delta_net = scoped("delta_net", gated_delta_attention)
_gated_attention = scoped("gated_attention", gated_full_attention)


@scoped("moe")
def _moe(moe_block, *args):
    return moe_block(*args)


def _layer(cfg, backend, moe_block, kind, names, h, segment_ids, token_mask, rope, *weights):
    """One layer: h + mixer((1 + w)-norm(h)), then h + moe((1 + w)-norm(h)); returns (h,
    aux, load)."""
    dtype, eps = backend.torch_dtype, cfg.rms_norm_eps
    lp = dict(zip(names, weights))
    moe = cast_moe_compute_params(_split_moe(lp), dtype)
    lp = {n: (w if n == "a_log" else w.to(dtype)) for n, w in lp.items()}
    x = rms_norm(h, lp["attn_norm"], eps, offset=1.0)
    if kind == LINEAR:
        if token_mask is not None:  # the conv and the recurrence reach across positions
            x = x * token_mask[..., None].to(x.dtype)
        h = h + _delta_net(cfg, lp, x, segment_ids)
    else:
        h = h + _gated_attention(cfg, backend, lp, x, segment_ids, rope)
    y, aux, load, _ = _moe(moe_block, moe, rms_norm(h, lp["mlp_norm"], eps, offset=1.0),
                           token_mask)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + y, aux, load


def qwen3_next_forward(cfg: Qwen3NextConfig, backend: BackendConfig,
                       params: dict[str, torch.Tensor], input_ids: torch.Tensor,
                       positions: torch.Tensor | None = None,
                       segment_ids: torch.Tensor | None = None,
                       token_mask: torch.Tensor | None = None, return_hidden: bool = False,
                       training: bool = True) -> tuple[torch.Tensor, dict[str, Any]]:
    """``(logits or hidden, stats)``; stats: ``aux_loss`` (summed, or None when the aux
    loss is off) and ``expert_load`` (L, E) in layer order."""
    dtype = backend.torch_dtype
    if positions is None:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(
            input_ids.shape)
    emit_aux = cfg.moe.aux_loss_coeff > 0 and training and not backend.fake_balanced_gate
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                                cfg.partial_rotary_factor, device=input_ids.device)
    rope = rope_tables(positions, inv_freq, rope_attention_scaling(cfg.rope_scaling))
    moe_block = make_moe_block_forward(cfg.moe, backend, training=training)
    names = {LINEAR: [*cfg.linear_shapes(), *(f"moe.{n}" for n in moe_param_shapes(cfg.moe))],
             FULL: [*cfg.full_shapes(), *(f"moe.{n}" for n in moe_param_shapes(cfg.moe))]}
    stacks = {LINEAR: "linear_layers", FULL: "full_layers"}
    stacked = {kind: [params[f"{stacks[kind]}.{n}"].unbind(0) for n in names[kind]]
               for kind in set(cfg.layer_types)}
    offsets = {LINEAR: 0, FULL: 0}
    layer = backend.layer_remat(_layer)
    h = F.embedding(input_ids.long(), params["embed"].to(dtype))
    auxs, loads = [], []
    for kind in cfg.layer_types:
        j = offsets[kind]
        offsets[kind] += 1
        h, aux, load = layer(cfg, backend, moe_block, kind, names[kind], h, segment_ids,
                             token_mask, rope, *[w[j] for w in stacked[kind]])
        auxs.append(aux)
        loads.append(load)
    h = rms_norm(h, params["final_norm"].to(dtype), cfg.rms_norm_eps, offset=1.0)
    stats = {"aux_loss": torch.stack(auxs).sum() if emit_aux else None,
             "expert_load": torch.stack(loads)}
    if return_hidden:
        return h, stats
    unembed = params.get("lm_head")
    unembed = params["embed"].t() if unembed is None else unembed
    return torch.matmul(h, unembed.to(dtype)), stats


class Qwen3NextForCausalLM(ParamModule):
    """Holds Qwen3-Next's parameters (JAX's two stacks, flat names) and runs
    :func:`qwen3_next_forward`; the forward returns ``(logits or hidden, stats)``."""

    config_class = Qwen3NextConfig
    layer_axes = QWEN3_NEXT_LAYER_AXES

    def __init__(self, config: Qwen3NextConfig, backend: BackendConfig | None = None, *,
                 device: torch.device | str = "cuda", dtype=torch.float32,
                 generator: torch.Generator | None = None,
                 params: dict[str, torch.Tensor] | None = None):
        """Random weights from ``generator`` (seed 0 by default) with JAX's conventions:
        the (1 + w) norms at 0, the gated norm at 1, dt_bias at 1, a_log = log(U(1e-4,
        16)) in f32; or ``params`` as given."""
        device = torch.device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            params = init_params(config.param_shapes(), generator, config.initializer_range,
                                 dtype, device)
            for name, p in params.items():
                leaf = name.rsplit(".", 1)[-1]
                if leaf.endswith("norm"):
                    p.fill_(1.0 if leaf == "norm" else 0.0)
                elif leaf == "dt_bias":
                    p.fill_(1.0)
                elif leaf == "a_log":
                    u = torch.empty(p.shape, dtype=torch.float32, device=generator.device)
                    u.uniform_(1e-4, 16.0, generator=generator)
                    params[name] = torch.log(u).to(device)
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
        """``mesh`` is unused: Qwen3-Next has no ring branch (JAX's attends and runs the
        recurrence over the whole sequence under any cp)."""
        del mesh
        return qwen3_next_forward(self.config, self.backend,
                                  self.param_dict() if params is None else params, input_ids,
                                  positions=positions, segment_ids=segment_ids,
                                  token_mask=token_mask, return_hidden=return_hidden,
                                  training=training)

    def state_dict_adapter(self):
        from automodel_tpu_torch.models.qwen3_next.state_dict_adapter import (
            Qwen3NextStateDictAdapter)

        return Qwen3NextStateDictAdapter(self.config)
