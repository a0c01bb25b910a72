"""Backend switchboard (counterpart of ``automodel_tpu/models/common/backend.py``).

``attention``: "xla" (plain einsum softmax) | "flash" (the CUDA kernels on the card,
their plain version on the CPU). ``context_parallel``: "allgather" | "ring"; with a mesh
whose cp axis is larger than 1, "ring" runs ring attention over cp
(``parallel/ring_attention.py``, the ring chunk kernels on the card) and "allgather" is
the ordinary attention path (on one card the whole sequence is already there).
``scan_layers`` is accepted for config compatibility and changes nothing: the port
always loops over the stacked layer parameters in Python.

Rematerialisation. The names are the JAX package's ``_REMAT_POLICIES``. "full" runs no
checkpointing. Every other name runs each layer under ``torch.utils.checkpoint`` with a
selective policy (``create_selective_checkpoint_contexts``): the forward keeps the
outputs of the aten ops the policy saves, and the backward replays the layer up to the
last tensor it needs, taking each saved op's output instead of running it again.

- "none" saves nothing; "dots" saves every matmul's output (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``), "dots_no_batch" only those without batch dimensions (``mm``, ``addmm``),
  as JAX's ``checkpoint_dots`` / ``checkpoint_dots_with_no_batch_dims`` save
  ``dot_general`` outputs.
- The others save the tensors of the names they list, where the models name them as
  JAX does: ``attn_q`` / ``attn_k`` / ``attn_v`` and ``mlp_gate`` / ``mlp_up`` (the
  projections, :func:`remat_name` around them: their matmul is saved) and ``attn_out``
  / ``mlp_act`` and the grouped GEMM's ``mlp_gate`` (:func:`checkpoint_name`: an alias
  of the tensor is saved, since the attention and grouped GEMM kernels launch outside
  the dispatcher).

The CUDA kernels launch through ctypes inside ``torch.autograd.Function``s, which the
dispatcher never sees: a replay runs them again (as JAX replays its Pallas calls,
whose residuals no policy names), and the buffers they fill (``torch.empty`` and the
like) are never saved, so a replay never writes into a saved tensor. One difference:
a saved matmul whose output the backward does not need (the down projection under
"dots") stays cached until its layer's backward, where JAX drops it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["BackendConfig", "DTYPES", "PARALLEL_OUT", "REMAT_POLICIES", "checkpoint_name",
           "remat_name"]

# policy -> (save every matmul, batched matmuls too, the names it saves)
_REMAT_POLICIES = {
    "none": (False, False, frozenset()),
    "dots": (True, True, frozenset()),
    "dots_no_batch": (True, False, frozenset()),
    "mlp_dots": (False, False, frozenset({"mlp_gate", "mlp_up"})),
    "mlp_gate_dot": (False, False, frozenset({"mlp_gate"})),
    "mlp_gate_attn": (False, False, frozenset({"mlp_gate", "attn_out"})),
    "mlp_act_dot": (False, False, frozenset({"mlp_act"})),
    "mlp_attn_dots": (False, False, frozenset({"mlp_gate", "mlp_up", "attn_k", "attn_v",
                                               "attn_out"})),
}
REMAT_POLICIES = (*_REMAT_POLICIES, "full")
# The two output products of a parallel block (Cohere: h + attn(x) + mlp(x)), which the
# dense decoder names so: no backward needs their outputs, and JAX's replay skips both,
# but a checkpoint's replay runs to the last tensor the backward saved, which the second
# product saves, so it would run the first again. Every checkpointing policy keeps their
# outputs instead (a layer that asks for it, ``layer_remat(fn, selective=True)``, takes
# the selective checkpoint under "none" too), and the replays' matmuls are JAX's.
PARALLEL_OUT = "parallel_out"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

_aten = torch.ops.aten
_MATMULS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default}
_BATCHED = {_aten.bmm.default, _aten.baddbmm.default}
_SCOPE = threading.local()  # the innermost remat name of this thread, or None


@contextlib.contextmanager
def remat_name(name: str):
    """Name what runs inside: a policy that lists ``name`` saves the matmuls in it and
    the tensors :func:`checkpoint_name` marks in it."""
    outer = getattr(_SCOPE, "name", None)
    _SCOPE.name = name
    try:
        yield
    finally:
        _SCOPE.name = outer


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` under ``name`` (JAX's ``checkpoint_name``): an alias the policy saves when it
    lists the name, for tensors that no matmul under the name produces."""
    with remat_name(name):
        return _aten.alias.default(x)


def _policy(dots: bool, batched: bool, names: frozenset, ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    name = getattr(_SCOPE, "name", None)
    named = name in names or name == PARALLEL_OUT
    if op in _MATMULS:
        saved = named or (dots and (batched or op not in _BATCHED))
    else:  # every other op replays: a kernel's output buffer is never saved
        saved = named and op is _aten.alias.default
    return CheckpointPolicy.MUST_SAVE if saved else CheckpointPolicy.PREFER_RECOMPUTE


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

    def layer_remat(self, fn, selective: bool = False):
        """``fn`` (one layer) under the policy: as it is for "full" or without grad, else
        checkpointed with the policy's saves (see the module docstring); ``selective``: a
        layer that names ``PARALLEL_OUT`` products, checkpointed selectively under "none"
        too."""
        if not self.checkpoint_layers:
            return fn
        kw = {}
        # "none" saves nothing, which a plain checkpoint does without the selective
        # policy's dispatch mode and its host time on every op
        if self.remat_policy != "none" or selective:
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts,
                functools.partial(_policy, *_REMAT_POLICIES[self.remat_policy]))

        def run(*args):
            if not torch.is_grad_enabled():
                return fn(*args)
            return checkpoint(fn, *args, use_reentrant=False, **kw)

        return run
