"""MoE routing as pure functions (counterpart of ``automodel_tpu/moe/gate.py``).

``route`` returns ``(weights, indices, aux_loss, expert_load)`` with the JAX package's
arithmetic: gate math in f32, softmax or sigmoid scores, group-limited selection,
``norm_topk_prob`` and ``route_scale``, the sequence-wise balance loss, and the load of
valid tokens per expert. Nothing here leaves the device: the load is a scatter-add,
not a ``bincount`` (which would sync to size its output).

``update_gate_bias`` is DeepSeek-V3's loss-free balancing step;
``make_gate_bias_post_update`` applies it to every MoE layer's correction bias after the
optimizer step (the train step's ``post_update``).
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.moe.config import MoEConfig

__all__ = ["fake_balanced_route", "make_gate_bias_post_update", "route", "update_gate_bias"]


def _expert_load(indices: torch.Tensor, valid: torch.Tensor, num_experts: int) -> torch.Tensor:
    """(E,) f32: for every (token, k), add the token's validity at its expert."""
    k = indices.shape[1]
    return torch.zeros(num_experts, dtype=torch.float32, device=indices.device).index_add_(
        0, indices.reshape(-1), valid[:, None].expand(-1, k).reshape(-1))


def route(
    cfg: MoEConfig,
    gate_params: dict[str, torch.Tensor],
    x: torch.Tensor,  # (T, D)
    token_mask: torch.Tensor | None = None,  # (T,) bool
    *,
    training: bool = True,
):
    """Select the top-k experts of each token.

    Returns ``(weights (T, K) in x's dtype, indices (T, K) int64, aux_loss scalar or
    None, expert_load (E,) f32)``. ``expert_load`` counts valid tokens routed to each
    expert; ``aux_loss`` is the f_i * P_i balance loss when ``aux_loss_coeff > 0`` and
    ``training``.
    """
    t = x.shape[0]
    e, k = cfg.n_routed_experts, cfg.n_activated_experts
    if token_mask is None:
        token_mask = torch.ones(t, dtype=torch.bool, device=x.device)
    gp = gate_params if cfg.train_gate else {n: p.detach() for n, p in gate_params.items()}
    scores = x.float() @ gp["weight"].float().t()
    if "bias" in gp:
        scores = scores + gp["bias"].float()

    if cfg.score_func == "softmax":
        original_scores = torch.softmax(scores, dim=-1)
        cand = original_scores
    else:  # sigmoid (DeepSeek-V3 noaux-tc)
        original_scores = torch.sigmoid(scores)
        cand = original_scores
        if "score_correction_bias" in gp:
            cand = cand + gp["score_correction_bias"]

    if cfg.n_expert_groups > 1:  # group-limited selection
        grouped = cand.reshape(t, cfg.n_expert_groups, -1)
        if "score_correction_bias" in gp:
            group_scores = torch.topk(grouped, 2, dim=-1).values.sum(-1)
        else:
            group_scores = grouped.amax(-1)
        top_groups = torch.topk(group_scores, cfg.n_limited_groups, dim=-1).indices
        group_mask = torch.zeros(t, cfg.n_expert_groups, dtype=torch.bool, device=x.device)
        group_mask.scatter_(1, top_groups, True)
        cand = torch.where(group_mask[:, :, None], grouped,
                           torch.zeros((), dtype=grouped.dtype, device=x.device)).reshape(t, e)

    indices = torch.topk(cand, k, dim=-1).indices
    if cfg.score_func == "softmax" and not cfg.softmax_before_topk:
        # re-normalize over the selected k (gpt-oss / Mixtral convention)
        weights = torch.softmax(torch.gather(scores, 1, indices), dim=-1)
    else:
        weights = torch.gather(original_scores, 1, indices)

    if cfg.norm_topk_prob and k > 1:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
        original_scores = original_scores / (original_scores.sum(-1, keepdim=True) + 1e-20)
    weights = weights * cfg.route_scale

    valid = token_mask.float()
    expert_load = _expert_load(indices, valid, e)

    aux_loss = None
    if cfg.aux_loss_coeff > 0 and training:
        # max(count, 1): an all-masked batch gives aux 0, not 0/0
        context_length = valid.sum().clamp_min(1.0)
        expert_scores = (original_scores * valid[:, None]).sum(0)  # (E,)
        f_i = expert_load * e / (k * context_length)
        p_i = expert_scores / context_length
        aux_loss = (f_i * p_i).sum()

    return weights.to(x.dtype), indices, aux_loss, expert_load


def fake_balanced_route(cfg: MoEConfig, x: torch.Tensor, *, noise: float = 0.0,
                        skip_first_n_experts: int = 0):
    """Uniform round-robin routing for benchmarking, independent of x's values.

    ``noise > 0`` draws JAX's random numbers in the JAX package; the port cannot give
    the same ones, so it raises until a slice ports it (ROADMAP.md)."""
    if noise > 0:
        raise NotImplementedError("fake_balanced_route with noise > 0 is not ported yet")
    t = x.shape[0]
    e, k = cfg.n_routed_experts, cfg.n_activated_experts
    avail = e - skip_first_n_experts
    weights = torch.full((t, k), 1.0 / k, dtype=x.dtype, device=x.device)
    indices = (torch.arange(t * k, device=x.device).reshape(t, k) % avail
               + skip_first_n_experts)
    expert_load = _expert_load(indices, torch.ones(t, device=x.device), e)
    return weights, indices, None, expert_load


def update_gate_bias(score_correction_bias: torch.Tensor, cumulative_expert_load: torch.Tensor,
                     update_factor: float) -> torch.Tensor:
    """DeepSeek-V3 loss-free balancing: the bias rises for experts below the mean load
    and falls for those above it, by sign(mean - load) * update_factor. The last dim is
    the experts': a stacked (L, E) bias and load update each layer from its own mean, as
    JAX's ``vmap`` over layers does."""
    load = cumulative_expert_load.float()
    return score_correction_bias + torch.sign(load.mean(-1, keepdim=True) - load) * update_factor


def make_gate_bias_post_update(update_factor: float):
    """The train step's ``post_update(params, aux)``: every MoE layer's
    ``score_correction_bias`` takes :func:`update_gate_bias` from the step's
    ``expert_load`` (L_moe, E), summed over its microbatches; in place."""

    def post_update(params: dict[str, torch.Tensor], aux: dict[str, torch.Tensor]) -> None:
        bias = params["moe_layers.moe.gate.score_correction_bias"]
        with torch.no_grad():
            bias.copy_(update_gate_bias(bias, aux["expert_load"], update_factor))

    return post_update
