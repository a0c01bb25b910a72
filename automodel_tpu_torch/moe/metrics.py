"""MoE expert-load-balance metrics: a copy of ``automodel_tpu/moe/metrics.py`` (numpy
only, kept here so that the port imports nothing of the JAX package). The MoE layers
return per-layer ``expert_load``; the metrics post-process the stacked (L, E) array.
"""

from __future__ import annotations

import numpy as np

__all__ = ["compute_load_balance_metrics"]


def compute_load_balance_metrics(
    expert_loads: np.ndarray,  # (L, E) tokens routed per expert per MoE layer
    *,
    mode: str = "brief",
    top_k_experts: int = 5,
    prefix: str = "moe_load",
) -> dict[str, float]:
    """Scalar metrics dict for the metric logger / wandb.

    Utilization ratio = load / ideal (ideal = mean over experts); 1.0 is perfect
    balance, > 1 overloaded (reference _compute_expert_utilization semantics).
    ``brief`` emits aggregates + global top/bottom-k; ``detailed`` adds per-layer stats.
    """
    loads = np.asarray(expert_loads, np.float64)
    if loads.ndim == 1:
        loads = loads[None]
    L, E = loads.shape
    ideal = loads.mean(axis=1, keepdims=True)  # (L, 1)
    util = np.divide(loads, ideal, out=np.ones_like(loads), where=ideal > 0)

    per_layer_max = util.max(axis=1)
    per_layer_min = util.min(axis=1)
    per_layer_std = util.std(axis=1)
    zero_frac = (loads == 0).mean(axis=1)

    metrics = {
        f"{prefix}/max_util_mean": float(per_layer_max.mean()),
        f"{prefix}/max_util_max": float(per_layer_max.max()),
        f"{prefix}/min_util_mean": float(per_layer_min.mean()),
        f"{prefix}/util_std_mean": float(per_layer_std.mean()),
        f"{prefix}/zero_expert_frac": float(zero_frac.mean()),
    }

    mean_util = util.mean(axis=0)  # (E,) average across layers
    order = np.argsort(mean_util)
    k = min(top_k_experts, E)
    for rank, e in enumerate(order[::-1][:k]):
        metrics[f"{prefix}/top{rank}_expert{e}_util"] = float(mean_util[e])
    for rank, e in enumerate(order[:k]):
        metrics[f"{prefix}/bottom{rank}_expert{e}_util"] = float(mean_util[e])

    if mode == "detailed":
        for layer in range(L):
            metrics[f"{prefix}/layer{layer}/max_util"] = float(per_layer_max[layer])
            metrics[f"{prefix}/layer{layer}/min_util"] = float(per_layer_min[layer])
            metrics[f"{prefix}/layer{layer}/util_std"] = float(per_layer_std[layer])
    return metrics
