"""MoE block: gate + grouped experts + shared experts (counterpart of
``automodel_tpu/moe/layers.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.experts import capacity_experts_apply, grouped_experts_apply
from automodel_tpu_torch.moe.gate import fake_balanced_route, route

__all__ = ["cast_moe_compute_params", "moe_forward", "moe_param_shapes", "nest_moe_params"]


def cast_moe_compute_params(moe_params: dict, dtype) -> dict:
    """Cast MoE block params to the compute dtype, keeping the routing correction bias
    f32 (bf16 rounding flips expert selection)."""
    return {
        sub: {k: (v if sub == "gate" and k == "score_correction_bias" else v.to(dtype))
              for k, v in leaves.items()}
        if isinstance(leaves, dict) else leaves.to(dtype)
        for sub, leaves in moe_params.items()
    }


def moe_param_shapes(cfg: MoEConfig) -> dict[str, tuple[int, ...]]:
    """Flat name -> shape of one MoE block's parameters, named as the JAX tree nests
    them (``gate.weight``, ``experts.gate_up_proj``, ``shared_experts.w_up``, ...)."""
    e, d, i = cfg.n_routed_experts, cfg.dim, cfg.moe_inter_dim
    up_cols = 2 * i if cfg.gated else i
    shapes = {"gate.weight": (e, d)}
    if cfg.router_bias:
        shapes["gate.bias"] = (e,)
    if cfg.has_correction_bias:
        shapes["gate.score_correction_bias"] = (e,)
    shapes |= {"experts.gate_up_proj": (e, d, up_cols), "experts.down_proj": (e, i, d)}
    if cfg.expert_bias:
        shapes |= {"experts.gate_up_bias": (e, up_cols), "experts.down_bias": (e, d)}
    if cfg.n_shared_experts > 0:
        si = cfg.shared_inter_dim
        shapes |= {"shared_experts.w_up": (d, si), "shared_experts.w_down": (si, d)}
        if cfg.shared_expert_activation == "swiglu":
            shapes["shared_experts.w_gate"] = (d, si)
        if cfg.shared_expert_gate:
            shapes["shared_expert_gate"] = (d, 1)
    return shapes


def nest_moe_params(flat: dict[str, torch.Tensor]) -> dict:
    """``{"gate.weight": t, ...}`` -> ``{"gate": {"weight": t}, ...}``, as moe_forward
    takes them."""
    out: dict = {}
    for name, t in flat.items():
        sub, _, leaf = name.rpartition(".")
        if sub:
            out.setdefault(sub, {})[leaf] = t
        else:
            out[leaf] = t
    return out


def _shared_experts_forward(cfg: MoEConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    sp = params["shared_experts"]
    up = x @ sp["w_up"]
    if cfg.shared_expert_activation == "swiglu":
        act = F.silu(x @ sp["w_gate"]) * up
    else:  # relu2
        act = torch.square(F.relu(up))
    z = act @ sp["w_down"]
    if "shared_expert_gate" in params:
        z = torch.sigmoid(x @ params["shared_expert_gate"]) * z
    return z


def moe_forward(
    cfg: MoEConfig,
    params: dict,
    x: torch.Tensor,  # (B, S, D) or (T, D)
    token_mask: torch.Tensor | None = None,  # (B, S) or (T,) bool; True = valid
    *,
    training: bool = True,
    dispatcher: str = "ragged",  # "ragged" (dropless) | "capacity" (GShard one-hot)
    capacity_factor: float = 1.25,
    fake_balanced_gate: bool = False,
    fake_gate_noise: float = 0.0,
):
    """Returns ``(y, aux_loss or None, expert_load (E,))``; y has x's shape. aux_loss is
    unscaled: the recipe adds ``aux_loss_coeff * aux_loss`` (with the token-count
    correction) to the loss."""
    shape = x.shape
    x2 = x.reshape(-1, cfg.dim)
    mask = None if token_mask is None else token_mask.reshape(-1)
    if fake_balanced_gate:
        weights, indices, aux_loss, expert_load = fake_balanced_route(cfg, x2,
                                                                      noise=fake_gate_noise)
    else:
        weights, indices, aux_loss, expert_load = route(cfg, params["gate"], x2, mask,
                                                        training=training)
    if dispatcher == "capacity":
        y = capacity_experts_apply(cfg, params["experts"], x2, weights, indices, mask,
                                   capacity_factor=capacity_factor)
    else:
        y = grouped_experts_apply(cfg, params["experts"], x2, weights, indices, mask)
    if cfg.n_shared_experts > 0:
        y = y + _shared_experts_forward(cfg, params, x2)
    return y.reshape(shape), aux_loss, expert_load
