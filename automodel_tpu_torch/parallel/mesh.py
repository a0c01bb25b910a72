"""Mesh sizes (counterpart of ``automodel_tpu/parallel/mesh.py``, ``MeshAxis`` and
``MeshContext``; the sharding-rules half comes with the parallel slice).

The JAX package builds one ``jax.sharding.Mesh`` over its devices. The port runs one
process per card, so a mesh here is a set of validated axis sizes over the ranks of
``torch.distributed`` (one rank without a process group).

**The one-card fold.** A process that is the whole world (one rank) and is asked for
``cp > 1`` holds every cp shard on its card: the cp axis is written out as a batch
dimension (``parallel/ring_attention.py``), so the mesh spans ``cp`` virtual devices
on the one card and ``folded`` is True. The fold computes what a ring over ``cp``
cards computes, step for step; it does not split memory across cards. Every other
axis larger than 1 still needs more cards, and the recipes refuse it.
"""

from __future__ import annotations

import dataclasses

__all__ = ["MeshAxis", "MeshContext", "num_ranks"]


class MeshAxis:
    """Canonical mesh axis names, as the JAX package's."""

    PP = "pp"
    DP_REPLICATE = "dp_replicate"
    DP_SHARD = "dp_shard"
    EP = "ep"
    CP = "cp"
    TP = "tp"

    ALL = (PP, DP_REPLICATE, DP_SHARD, EP, CP, TP)


def num_ranks() -> int:
    """The ranks of the default process group, 1 without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


@dataclasses.dataclass
class MeshContext:
    """Validated parallelism sizes.

    ``dp_shard = -1`` infers the remaining world. ``world_size`` defaults to the number
    of ranks; when that is 1 and ``cp > 1`` the cp axis folds onto the one card (see the
    module docstring) and the world counts ``cp`` virtual devices.
    """

    pp: int = 1
    dp_replicate: int = 1
    dp_shard: int = -1
    ep: int = 1
    cp: int = 1
    tp: int = 1
    world_size: int | None = None
    folded: bool = dataclasses.field(default=False, init=False)

    def __post_init__(self):
        for name in ("pp", "dp_replicate", "ep", "cp", "tp"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        ranks = num_ranks() if self.world_size is None else self.world_size
        self.folded = ranks == 1 and self.cp > 1
        self.world_size = ranks * self.cp if self.folded else ranks
        fixed = self.pp * self.dp_replicate * self.ep * self.cp * self.tp
        if self.dp_shard == -1:
            if self.world_size % fixed != 0:
                raise ValueError(f"world_size {self.world_size} not divisible by "
                                 f"pp*dp_replicate*ep*cp*tp = {fixed}")
            self.dp_shard = self.world_size // fixed
        if self.dp_shard < 1:
            raise ValueError(f"dp_shard must be >= 1, got {self.dp_shard}")
        total = fixed * self.dp_shard
        if total != self.world_size:
            raise ValueError(
                f"mesh sizes pp={self.pp} x dp_replicate={self.dp_replicate} x "
                f"dp_shard={self.dp_shard} x ep={self.ep} x cp={self.cp} x tp={self.tp} "
                f"= {total} != world_size {self.world_size}")

    @property
    def shape(self) -> dict[str, int]:
        return {MeshAxis.PP: self.pp, MeshAxis.DP_REPLICATE: self.dp_replicate,
                MeshAxis.DP_SHARD: self.dp_shard, MeshAxis.EP: self.ep,
                MeshAxis.CP: self.cp, MeshAxis.TP: self.tp}

    @property
    def dp_size(self) -> int:
        """The global batch shards over this many ways."""
        return self.dp_replicate * self.dp_shard * self.ep

    @property
    def active_axes(self) -> tuple[str, ...]:
        return tuple(a for a, s in self.shape.items() if s > 1)
