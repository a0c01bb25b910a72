"""Transient-fault retry with exponential backoff and jitter (the port's copy of
``automodel_tpu/utils/retry.py``, which it may not import).

Checkpoint and safetensors I/O on network filesystems meets transient faults; one
function owns the policy so every such touch shares the same backoff curve and
exception allowlist. Only *transient* failures retry: connection, timeout and
OS-level errors, plus a by-name set covering huggingface_hub / requests errors
without importing either. Anything else (a corrupt file, a bug) raises at once.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import random
import socket
import time
import zlib
from typing import Any, Callable, Iterable, TypeVar

logger = logging.getLogger(__name__)

__all__ = ["RetryConfig", "retry", "with_retry", "is_transient",
           "host_jitter_seed"]

F = TypeVar("F", bound=Callable[..., Any])

# transient exception *names* from libraries we must not import at module
# scope (huggingface_hub, requests, aiohttp, fsspec); matched against the
# exception's MRO so subclasses count
_TRANSIENT_NAMES = frozenset({
    "ConnectionError", "Timeout", "TimeoutError", "ReadTimeout",
    "ConnectTimeout", "ChunkedEncodingError", "HfHubHTTPError",
    "LocalEntryNotFoundError", "IncompleteRead", "ProtocolError",
    "TemporaryFailure", "ServerDisconnectedError",
})


def host_jitter_seed(ident: str | None = None) -> int:
    """Deterministic per-host jitter seed.

    Seeding from the hostname decorrelates hosts that fail together while the
    same host replays the same delay curve across restarts (reproducible,
    log-diffable). ``AUTOMODEL_RETRY_SEED`` overrides the identity for tests and
    for several workers on one host.
    """
    if ident is None:
        ident = os.environ.get("AUTOMODEL_RETRY_SEED") or socket.gethostname()
    return zlib.crc32(str(ident).encode())


_host_rng = random.Random(host_jitter_seed())


@dataclasses.dataclass(frozen=True)
class RetryConfig:
    """Backoff policy: delay_n = min(base * mult**n, max_delay) * U(1-j, 1+j).

    The jitter factor is drawn from a per-host deterministically seeded RNG
    (:func:`host_jitter_seed`), so delays always stay inside the
    ``[d*(1-j), d*(1+j)]`` envelope, hosts decorrelate, and a given host's
    curve is reproducible run to run.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.5
    max_delay_s: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.25  # +/- fraction of the computed delay

    @classmethod
    def from_dict(cls, raw: Any) -> "RetryConfig":
        if raw is None:
            return cls()
        if hasattr(raw, "to_dict"):
            raw = raw.to_dict()
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dict(raw).items() if k in known})

    def delay(self, attempt: int, rng: random.Random | None = None) -> float:
        """Seconds to sleep before retry number ``attempt`` (0-based)."""
        d = min(self.base_delay_s * self.multiplier**attempt, self.max_delay_s)
        if self.jitter:
            r = rng if rng is not None else _host_rng
            d *= 1.0 + r.uniform(-self.jitter, self.jitter)
        return max(d, 0.0)


def is_transient(exc: BaseException, extra: Iterable[type] = ()) -> bool:
    """True when ``exc`` is on the transient allowlist (by type or MRO name)."""
    if isinstance(exc, (ConnectionError, TimeoutError, *tuple(extra))):
        return True
    # OSError covers EIO/ENETDOWN-style blips, but FileNotFoundError/IsADirectory
    # etc. are deterministic — retrying them only hides real bugs
    if isinstance(exc, OSError) and not isinstance(
        exc, (FileNotFoundError, NotADirectoryError, IsADirectoryError, PermissionError)
    ):
        return True
    return any(t.__name__ in _TRANSIENT_NAMES for t in type(exc).__mro__)


def with_retry(
    fn: Callable[..., Any],
    *args: Any,
    config: RetryConfig | None = None,
    retry_on: Iterable[type] = (),
    description: str | None = None,
    sleep: Callable[[float], None] = time.sleep,
    **kwargs: Any,
) -> Any:
    """Call ``fn(*args, **kwargs)``, retrying transient failures per ``config``."""
    cfg = config or RetryConfig()
    extra = tuple(retry_on)
    what = description or getattr(fn, "__qualname__", repr(fn))
    last: BaseException | None = None
    for attempt in range(max(int(cfg.max_attempts), 1)):
        try:
            return fn(*args, **kwargs)
        except BaseException as exc:  # noqa: BLE001 - filtered just below
            if not is_transient(exc, extra):
                raise
            last = exc
            if attempt + 1 >= cfg.max_attempts:
                break
            d = cfg.delay(attempt)
            logger.warning(
                "transient failure in %s (attempt %d/%d): %s — retrying in %.1fs",
                what, attempt + 1, cfg.max_attempts, exc, d,
            )
            sleep(d)
    assert last is not None
    raise last


def retry(
    config: RetryConfig | None = None,
    *,
    retry_on: Iterable[type] = (),
    sleep: Callable[[float], None] = time.sleep,
) -> Callable[[F], F]:
    """Decorator form of :func:`with_retry`.

    >>> @retry(RetryConfig(max_attempts=5))
    ... def fetch(url): ...
    """

    def deco(fn: F) -> F:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            return with_retry(
                fn, *args, config=config, retry_on=retry_on,
                description=getattr(fn, "__qualname__", None), sleep=sleep, **kwargs,
            )

        return wrapper  # type: ignore[return-value]

    return deco
