"""Named, checkpointable random streams (counterpart of
``automodel_tpu/training/rng.py``).

JAX derives a key per call from ``fold_in(key(seed), hash(name))`` and a counter; here
each name owns a ``torch.Generator`` on its device, seeded from the seed and the same
stable hash of the name, whose state moves as it draws. :meth:`StatefulRNG.state_dict`
holds every stream's state as JSON, so a checkpoint's ``client.json`` restores the
streams where they stood. The bits differ from JAX's ``fold_in`` bits; what a stream is
for (LoRA dropout's masks) asks only for the distribution. Python's and numpy's global
generators, which JAX's version also seeds and saves, are left alone: nothing in the
port draws from them.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["StatefulRNG"]


def _hash_name(name: str) -> int:
    """FNV-1a of the name: stable across processes (Python's hash() is salted)."""
    h = 2166136261
    for b in name.encode():
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


class StatefulRNG:
    """Named streams from one seed."""

    def __init__(self, seed: int = 42):
        self.seed = int(seed)
        self._streams: dict[str, torch.Generator] = {}

    def generator(self, name: str = "default",
                  device: torch.device | str = "cpu") -> torch.Generator:
        """The stream ``name``, created on ``device`` at its first use."""
        g = self._streams.get(name)
        if g is None:
            g = torch.Generator(device=device)
            g.manual_seed((self.seed << 32) ^ _hash_name(name))
            self._streams[name] = g
        return g

    def state_dict(self) -> dict[str, Any]:
        return {"seed": self.seed,
                "streams": {name: {"device": str(g.device), "state": g.get_state().tolist()}
                            for name, g in self._streams.items()}}

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.seed = int(state["seed"])
        for name, s in state.get("streams", {}).items():
            # in place: a step function holds on to its stream's generator
            g = self.generator(name, s["device"])
            g.set_state(torch.tensor(s["state"], dtype=torch.uint8))
