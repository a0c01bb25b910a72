"""Process-group initialisation (counterpart of ``automodel_tpu/parallel/init.py``), as
far as the process-group ring needs it.

JAX wires hosts together with ``jax.distributed.initialize``; here one process per card
joins a ``torch.distributed`` process group from ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``: NCCL for cards, gloo for the CPU, with an explicit
timeout so that a missing peer fails instead of hanging. Without those variables the
process is a world of one and nothing is initialised.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os

import torch

logger = logging.getLogger(__name__)

__all__ = ["DistInfo", "initialize_distributed"]


@dataclasses.dataclass(frozen=True)
class DistInfo:
    """Rank / world view after initialisation."""

    rank: int
    world_size: int
    backend: str | None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def initialize_distributed(device: str = "cuda", timeout_s: float = 600.0) -> DistInfo:
    """Join the process group the environment names, or stay a world of one."""
    import torch.distributed as dist

    env = os.environ
    if not all(key in env for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        return DistInfo(rank=0, world_size=1, backend=None)
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if not dist.is_initialized():
        if backend == "nccl":
            torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
        dist.init_process_group(
            backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("distributed: rank %d of %d (%s)", rank, world, backend)
    return DistInfo(rank=rank, world_size=world, backend=backend)
