"""Grouped expert FFNs (counterpart of ``automodel_tpu/moe/experts.py``).

Token copies are sorted by expert (a stable sort, as ``jnp.argsort``), each expert's
rows run through two grouped GEMMs (gate_up, then down) and are scatter-added back in
f32, weighted by the router. The backends keep the JAX package's names:

- ``pallas``: the grouped GEMM of ``ops/grouped_gemm.py``, whose CUDA kernels (``gmm``,
  ``tgmm``) run on the card.
- ``ragged_dot``: XLA's grouped GEMM in the JAX package, with no Pallas kernel behind
  it. The port's only grouped GEMM is the kernel, so on the card this backend launches
  the same kernels as ``pallas``.
- On the CPU both run the grouped GEMM's plain version.
- ``dense`` (:func:`capacity_experts_apply`): GShard one-hot dispatch and combine with a
  per-expert capacity, as einsums (plain products, as in JAX, with no kernel).

Weight layout: ``gate_up_proj`` (E, D, 2I) with [gate | up] on the last dim
(non-gated activations: (E, D, I)), ``down_proj`` (E, I, D).

The remat names are JAX's: ``mlp_gate`` on the gate_up product and ``mlp_act`` on the
activation, so that the ``mlp_*`` policies (``models/common/backend.py``) save them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from automodel_tpu_torch.models.common.backend import checkpoint_name, remat_name
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.ops.grouped_gemm import grouped_matmul

__all__ = ["capacity_experts_apply", "expert_activation", "grouped_experts_apply",
           "sorted_ragged_ffn"]


def expert_activation(cfg: MoEConfig, h: torch.Tensor) -> torch.Tensor:
    """Activation between the two expert GEMMs; h is (..., 2I) gated or (..., I) not.
    quick_geglu is gpt-oss's: clamp, x * sigmoid(alpha * x), +1 on the up branch."""
    if cfg.expert_activation == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        return F.silu(gate) * up
    if cfg.expert_activation == "quick_geglu":
        gate, up = h.chunk(2, dim=-1)
        gate = gate.clamp(max=cfg.activation_limit)
        up = up.clamp(-cfg.activation_limit, cfg.activation_limit)
        return gate * torch.sigmoid(cfg.activation_alpha * gate) * (up + 1.0)
    return torch.square(F.relu(h))  # relu2


def sorted_ragged_ffn(cfg: MoEConfig, params: dict, xs: torch.Tensor,
                      sorted_expert_ids: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """The FFN over rows sorted by expert: grouped GEMM gate_up -> bias -> activation ->
    grouped GEMM down -> bias."""
    h = checkpoint_name(grouped_matmul(xs, params["gate_up_proj"], group_sizes), "mlp_gate")
    if "gate_up_bias" in params:
        h = h + params["gate_up_bias"][sorted_expert_ids]
    act = checkpoint_name(expert_activation(cfg, h).to(xs.dtype), "mlp_act")
    out = grouped_matmul(act, params["down_proj"], group_sizes)
    if "down_bias" in params:
        out = out + params["down_bias"][sorted_expert_ids]
    return out


def grouped_experts_apply(
    cfg: MoEConfig,
    params: dict,
    x: torch.Tensor,  # (T, D)
    weights: torch.Tensor,  # (T, K)
    indices: torch.Tensor,  # (T, K)
    token_mask: torch.Tensor | None = None,  # (T,) bool; masked tokens contribute zero
) -> torch.Tensor:
    """Dropless grouped-GEMM expert compute; returns (T, D) in x's dtype.

    ``group_sizes`` is counted on the device by a scatter-add, so the whole block runs
    without waiting for the host."""
    t, d = x.shape
    k = indices.shape[1]
    e = cfg.n_routed_experts
    if token_mask is not None:
        weights = weights * token_mask[:, None].to(weights.dtype)

    flat_expert = indices.reshape(-1).long()  # (T*K,)
    sort_idx = torch.argsort(flat_expert, stable=True)  # token order kept within an expert
    token_ids = sort_idx // k  # source token of each sorted copy
    group_sizes = torch.zeros(e, dtype=torch.int32, device=x.device).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert, dtype=torch.int32))

    xs = x[token_ids]  # (T*K, D) gathered copies, expert-contiguous
    out = sorted_ragged_ffn(cfg, params, xs, flat_expert[sort_idx], group_sizes)

    w_sorted = weights.reshape(-1)[sort_idx].float()
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    y = y.index_add(0, token_ids, out.float() * w_sorted[:, None])
    return y.to(x.dtype)


def capacity_experts_apply(
    cfg: MoEConfig,
    params: dict,
    x: torch.Tensor,  # (T, D)
    weights: torch.Tensor,  # (T, K)
    indices: torch.Tensor,  # (T, K)
    token_mask: torch.Tensor | None = None,  # (T,) bool; masked tokens take no slots
    *,
    capacity_factor: float = 1.25,
    capacity: int | None = None,
) -> torch.Tensor:
    """GShard-style one-hot dispatch and combine with per-expert capacity; (T, D).

    Copies past an expert's capacity are dropped (contribute zero); queue positions come
    from a cumsum over tokens (k-major within a token), so earlier tokens win slots."""
    t, d = x.shape
    e, k = cfg.n_routed_experts, cfg.n_activated_experts
    if capacity is None:
        capacity = max(1, int(capacity_factor * t * k / e))

    onehot = F.one_hot(indices.long(), e).to(torch.int32)  # (T, K, E)
    if token_mask is not None:
        onehot = onehot * token_mask[:, None, None].to(torch.int32)
    flat = onehot.reshape(t * k, e)
    pos = torch.cumsum(flat, dim=0) - flat  # (T*K, E) position if routed there
    pos = (pos * flat).sum(-1).reshape(t, k)  # queue position of each copy
    keep = pos < capacity

    # (T, K, C) slot one-hot for kept copies (dropped copies -> all-zero row)
    slot = F.one_hot(torch.where(keep, pos, capacity).long(), capacity + 1)[..., :capacity]
    slot = slot.to(x.dtype)
    expert_oh = onehot.to(x.dtype)  # masked tokens already zeroed
    disp = torch.einsum("tke,tkc->tec", expert_oh, slot)
    xd = torch.einsum("tec,td->ecd", disp, x)  # (E, C, D)

    with remat_name("mlp_gate"):
        h = torch.einsum("ecd,edf->ecf", xd, params["gate_up_proj"].to(x.dtype))
    if "gate_up_bias" in params:
        h = h + params["gate_up_bias"][:, None, :]
    act = checkpoint_name(expert_activation(cfg, h).to(x.dtype), "mlp_act")
    out = torch.einsum("ecf,efd->ecd", act, params["down_proj"].to(x.dtype))
    if "down_bias" in params:
        out = out + params["down_bias"][:, None, :]

    combine = torch.einsum("tke,tkc,tk->tec", expert_oh, slot, weights.to(x.dtype))
    return torch.einsum("tec,ecd->td", combine, out)
