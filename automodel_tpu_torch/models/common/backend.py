"""Backend switchboard (counterpart of ``automodel_tpu/models/common/backend.py``).

``attention``: "xla" (plain einsum softmax) | "flash" (the CUDA kernels on the card,
their plain version on the CPU). ``scan_layers`` is accepted for config
compatibility and changes nothing: the port always loops over the stacked layer
parameters in Python.

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
    remat_policy:       one of REMAT_POLICIES (see the module docstring)
    scan_layers:        layout-only, accepted and ignored
    dtype:              activation and compute dtype
    """

    attention: str = "xla"
    attention_segments: bool = True
    remat_policy: str = "none"
    scan_layers: bool = True
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.attention not in ("xla", "flash"):
            raise ValueError(f"unknown attention backend {self.attention!r} (xla | flash)")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r} "
                             f"(choose from {list(REMAT_POLICIES)})")
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r} (choose from {list(DTYPES)})")

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def checkpoint_layers(self) -> bool:
        """True when each layer runs under torch.utils.checkpoint."""
        return self.remat_policy != "full"
