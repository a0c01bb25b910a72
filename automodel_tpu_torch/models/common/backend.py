"""Backend switchboard (counterpart of ``automodel_tpu/models/common/backend.py``).

``attention``: "xla" (plain einsum softmax) | "flash" (the CUDA kernels on the card,
their plain version on the CPU). ``context_parallel``: "allgather" | "ring"; with a mesh
whose cp axis is larger than 1, "ring" runs ring attention over cp
(``parallel/ring_attention.py``, the ring chunk kernels on the card) and "allgather" is
the ordinary attention path (on one card the whole sequence is already there).
``scan_layers`` is accepted for config compatibility and changes nothing: the port
always loops over the stacked layer parameters in Python.

Rematerialisation. The names are the JAX package's. JAX maps "full" to no
``jax.checkpoint`` at all and every other name, "none" included (policy None: save
nothing), to a per-layer ``jax.checkpoint`` that saves what the policy names. The
port keeps that split but not the named saves: "full" runs no checkpointing, and
every other name wraps each layer in ``torch.utils.checkpoint``, which saves only the
layer's input and replays the whole layer in the backward. That is coarser than the
named saves and gives the same values.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["BackendConfig", "DTYPES", "REMAT_POLICIES"]

REMAT_POLICIES = ("none", "dots", "dots_no_batch", "mlp_dots", "mlp_gate_dot",
                  "mlp_gate_attn", "mlp_act_dot", "mlp_attn_dots", "full")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclasses.dataclass
class BackendConfig:
    """Compute-backend knobs of the dense decoder.

    attention:          "xla" | "flash"
    attention_segments: pass segment ids into the attention mask (False is the fast
                        path for right-padded unpacked batches, as in JAX)
    context_parallel:   "allgather" | "ring" (see the module docstring)
    linear:             "default" | "fp8"; the recipes refuse "fp8" until its slice
                        lands
    remat_policy:       one of REMAT_POLICIES (see the module docstring)
    scan_layers:        layout-only, accepted and ignored
    dtype:              activation and compute dtype
    experts_backend:    MoE only: "ragged_dot" | "pallas" (both the grouped GEMM
                        kernels on the card, its plain version on the CPU) | "dense"
                        (capacity one-hot einsums); see moe/experts.py
    dispatcher:         MoE only: "dense"; "a2a" (expert parallel) is not ported yet
    ep_capacity_factor: a2a only: per-rank send capacity factor (accepted, unused
                        while a2a raises)
    fake_balanced_gate: MoE only: round-robin routing for benchmarks
    fake_gate_noise:    its noise (> 0 is not ported yet)
    """

    attention: str = "xla"
    attention_segments: bool = True
    context_parallel: str = "allgather"
    linear: str = "default"
    remat_policy: str = "none"
    scan_layers: bool = True
    dtype: str = "bfloat16"
    experts_backend: str = "ragged_dot"
    dispatcher: str = "dense"
    ep_capacity_factor: float = 1.5
    fake_balanced_gate: bool = False
    fake_gate_noise: float = 0.0

    def __post_init__(self):
        if self.attention not in ("xla", "flash"):
            raise ValueError(f"unknown attention backend {self.attention!r} (xla | flash)")
        if self.linear not in ("default", "fp8"):
            raise ValueError(f"unknown linear backend {self.linear!r} (default | fp8)")
        if self.context_parallel not in ("allgather", "ring"):
            raise ValueError(f"unknown context_parallel {self.context_parallel!r} "
                             "(allgather | ring)")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r} "
                             f"(choose from {list(REMAT_POLICIES)})")
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r} (choose from {list(DTYPES)})")
        if self.experts_backend not in ("ragged_dot", "pallas", "dense"):
            raise ValueError(f"unknown experts_backend {self.experts_backend!r} "
                             "(ragged_dot | pallas | dense)")
        if self.dispatcher not in ("dense", "a2a"):
            raise ValueError(f"unknown dispatcher {self.dispatcher!r} (dense | a2a)")

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def checkpoint_layers(self) -> bool:
        """True when each layer runs under torch.utils.checkpoint."""
        return self.remat_policy != "full"
