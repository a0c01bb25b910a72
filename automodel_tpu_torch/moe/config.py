"""MoE architecture configuration: a copy of ``automodel_tpu/moe/config.py`` (device-
agnostic, kept here so that the port imports nothing of the JAX package)."""

from __future__ import annotations

import dataclasses

__all__ = ["MoEConfig"]


@dataclasses.dataclass
class MoEConfig:
    """Architecture knobs for one MoE block, shared by all MoE model families.

    Field semantics mirror the reference (components/moe/config.py:39-66):

    - ``score_func``: "softmax" (Qwen/Mixtral-style) or "sigmoid" (DeepSeek-V3 noaux-tc).
    - ``gate_bias_update_factor``: >0 enables the DeepSeek-V3 loss-free balancing
      correction bias (e_score_correction_bias), updated once per optimizer step from
      accumulated expert load.
    - ``n_expert_groups`` / ``n_limited_groups``: group-limited routing (DeepSeek-V3
      device-limited gating) — scores are grouped, only top ``n_limited_groups`` groups
      stay candidates.
    - ``expert_activation``: "swiglu" | "quick_geglu" (gpt-oss, with clamp ``activation_limit``
      and sigmoid slope ``activation_alpha`` and +1 linear offset on up) | "relu2".
    - ``norm_topk_prob``: renormalize top-k weights to sum to 1 (Qwen3-MoE style).
    """

    n_routed_experts: int
    n_activated_experts: int
    dim: int
    moe_inter_dim: int
    n_shared_experts: int = 0
    n_expert_groups: int = 1
    n_limited_groups: int = 1
    train_gate: bool = True
    gate_bias_update_factor: float = 0.0
    aux_loss_coeff: float = 0.0
    score_func: str = "softmax"
    route_scale: float = 1.0
    norm_topk_prob: bool = False
    softmax_before_topk: bool = False
    router_bias: bool = False
    expert_bias: bool = False
    expert_activation: str = "swiglu"
    activation_alpha: float = 1.702
    activation_limit: float = 7.0
    shared_expert_gate: bool = False
    shared_expert_inter_dim: int | None = None
    shared_expert_activation: str = "swiglu"
    force_score_correction_bias: bool = False  # create the buffer for HF ckpt compat

    def __post_init__(self):
        if self.score_func not in ("softmax", "sigmoid"):
            raise ValueError(f"score_func must be softmax|sigmoid, got {self.score_func!r}")
        if self.expert_activation not in ("swiglu", "quick_geglu", "relu2"):
            raise ValueError(f"unknown expert_activation {self.expert_activation!r}")
        if self.shared_expert_activation not in ("swiglu", "relu2"):
            raise ValueError(f"unknown shared_expert_activation {self.shared_expert_activation!r}")
        if self.n_routed_experts % self.n_expert_groups != 0:
            raise ValueError("n_routed_experts must divide evenly into n_expert_groups")

    @property
    def has_correction_bias(self) -> bool:
        return self.gate_bias_update_factor > 0 or self.force_score_correction_bias

    @property
    def gated(self) -> bool:
        return self.expert_activation in ("swiglu", "quick_geglu")

    @property
    def shared_inter_dim(self) -> int:
        return self.n_shared_experts * (self.shared_expert_inter_dim or self.moe_inter_dim)
