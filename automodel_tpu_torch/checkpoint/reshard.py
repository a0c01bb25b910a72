"""The saving topology a checkpoint records, and how two topologies differ
(counterpart of ``automodel_tpu/checkpoint/reshard.py``, one process).

The topology rides inside ``signature.json`` under :data:`TOPOLOGY_KEY`; readers
strip it before comparing parameter signatures. A changed model is a hard failure
(:class:`ModelSignatureMismatch`); a changed mesh is an elastic resume, which the
port does not have yet (``Checkpointer.load`` raises NotImplementedError for it).
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Mapping

__all__ = [
    "TOPOLOGY_KEY",
    "ModelSignatureMismatch",
    "build_topology",
    "describe_delta",
    "mesh_delta",
    "read_topology",
    "strip_topology",
]

# Key inside signature.json carrying the saving topology; the dunders keep it apart
# from parameter names.
TOPOLOGY_KEY = "__topology__"


class ModelSignatureMismatch(ValueError):
    """The checkpoint was saved from a different model (a shape or dtype differs).

    Distinct from an integrity failure, which walks back to an older step: another
    checkpoint of the same run can never fix a model change, so the verified-restore
    walk-back re-raises it instead of excluding every step and starting afresh.
    """


def build_topology(mesh_ctx: Any, process_count: int = 1) -> dict:
    """The saving topology: the mesh axis sizes of the port's ``MeshContext`` (or a
    dict of them), the process count (one process in the port) and the world size."""
    shape = dict(mesh_ctx.shape) if hasattr(mesh_ctx, "shape") else dict(mesh_ctx)
    world = int(getattr(mesh_ctx, "world_size", 0) or math.prod(int(v) for v in shape.values()))
    return {
        "mesh": {str(k): int(v) for k, v in shape.items()},
        "process_count": int(process_count),
        "world_size": world,
    }


def strip_topology(signature: Mapping[str, Any]) -> tuple[dict, dict | None]:
    """``signature.json`` contents -> (parameter signature, topology or None)."""
    sig = dict(signature)
    topo = sig.pop(TOPOLOGY_KEY, None)
    return sig, (dict(topo) if isinstance(topo, Mapping) else None)


def read_topology(step_dir: str) -> dict | None:
    """The topology a step directory was saved under, or None (no topology recorded,
    or a missing or corrupt signature)."""
    path = os.path.join(step_dir, "signature.json")
    try:
        with open(path) as f:
            _, topo = strip_topology(json.load(f))
        return topo
    except (OSError, ValueError):
        return None


def mesh_delta(saved: Mapping[str, Any] | None,
               current: Mapping[str, Any] | None) -> dict[str, tuple[int, int]]:
    """Axis-by-axis change between two topologies: ``{axis: (old, new)}``; empty when
    they are the same or either is unknown. ``process_count`` and ``world_size``
    count as axes."""
    if not saved or not current:
        return {}
    delta: dict[str, tuple[int, int]] = {}
    old_mesh = dict(saved.get("mesh") or {})
    new_mesh = dict(current.get("mesh") or {})
    for axis in sorted(set(old_mesh) | set(new_mesh)):
        old, new = int(old_mesh.get(axis, 1)), int(new_mesh.get(axis, 1))
        if old != new:
            delta[axis] = (old, new)
    for scalar in ("process_count", "world_size"):
        old = int(saved.get(scalar) or 0)
        new = int(current.get(scalar) or 0)
        if old and new and old != new:
            delta[scalar] = (old, new)
    return delta


def describe_delta(delta: Mapping[str, tuple[int, int]]) -> str:
    """One line for logs: ``dp_shard 8->4, tp 1->2``."""
    return ", ".join(f"{axis} {old}->{new}" for axis, (old, new) in delta.items())
