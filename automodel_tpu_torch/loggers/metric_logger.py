"""JSONL metric streams (counterpart of ``automodel_tpu/loggers/metric_logger.py``):
one flat JSON object per line in ``training.jsonl``, non-finite floats written as
null with a ``<key>_nonfinite`` flag, flushed per line."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import IO, Any

__all__ = ["MetricLogger", "MetricsSample"]


def _jsonable(v: Any) -> tuple[Any, bool]:
    """(json-safe value, had-nonfinite-floats); tensors and arrays become lists/scalars."""
    if hasattr(v, "detach"):
        v = v.detach().cpu()
    ndim = getattr(v, "ndim", None)
    if ndim == 0:
        v = v.item()
    elif ndim is not None and hasattr(v, "tolist"):
        v = v.tolist()
    if isinstance(v, float):
        if not math.isfinite(v):
            return None, True
        return round(v, 6), False
    if isinstance(v, (list, tuple)):
        items = [_jsonable(x) for x in v]
        return [x for x, _ in items], any(nf for _, nf in items)
    return v, False


@dataclasses.dataclass
class MetricsSample:
    step: int
    metrics: dict[str, Any]
    timestamp: float = dataclasses.field(default_factory=time.time)

    def to_json(self) -> str:
        rec = {"step": self.step, "ts": round(self.timestamp, 3)}
        for k, v in self.metrics.items():
            v, nonfinite = _jsonable(v)
            rec[k] = v
            if nonfinite:
                rec[f"{k}_nonfinite"] = True
        return json.dumps(rec, allow_nan=False)


class MetricLogger:
    """Append-only JSONL writer."""

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        self._fh: IO[str] | None = open(self.path, "a")

    def log(self, step: int, **metrics: Any) -> None:
        if self._fh is None:
            return
        self._fh.write(MetricsSample(step=step, metrics=metrics).to_json() + "\n")
        self._fh.flush()

    def log_header(self, **fields: Any) -> None:
        """One-time ``{"run_header": true, ...}`` row describing the run."""
        if self._fh is None:
            return
        rec: dict[str, Any] = {"run_header": True, "ts": round(time.time(), 3)}
        rec.update({k: _jsonable(v)[0] for k, v in fields.items()})
        self._fh.write(json.dumps(rec, allow_nan=False, default=str) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
