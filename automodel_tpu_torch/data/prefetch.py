"""Overlapped input pipeline: a host prefetch thread and device double-buffering
(counterpart of ``automodel_tpu/data/prefetch.py``, one process).

- :class:`HostPrefetcher`: one background thread owns the ``StepScheduler`` iterator
  and runs collation and ``stack_batches`` off the critical path into a bounded FIFO
  queue. One producer and one consumer, so batches come in the synchronous order; an
  exception in the worker, and the end of the data, reach the consumer at the position
  where they happened.
- :class:`DevicePrefetcher`: keeps ``device_depth`` stacks already on their way to the
  device. On a CUDA device each copy runs from pinned host memory on a side stream and
  records an event; the consuming stream waits on that event before it reads the
  batch, and ``record_stream`` keeps the caching allocator from reusing the batch's
  memory before the consuming stream is done with it.
- :class:`InputPipeline`: what the recipe holds. With ``prefetch.enabled: false`` it is
  the synchronous fetch, stack and copy, with no thread.

Exact resume: the worker snapshots the scheduler and dataloader state at the yield of
each item, and ``client_states()`` hands the snapshot of the last item the training
loop *consumed* to the checkpointer (the live objects run up to ``host_depth +
device_depth`` steps ahead), so a resume replays every batch that was in flight.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Iterator

import torch

__all__ = ["DevicePrefetcher", "HostPrefetcher", "InputPipeline", "PrefetchConfig",
           "StepBatch"]


@dataclasses.dataclass
class PrefetchConfig:
    """The ``dataloader.prefetch`` YAML section."""

    enabled: bool = False
    host_depth: int = 2  # stacked batches buffered on the host
    device_depth: int = 2  # stacks already copied (or being copied) to the device

    def __post_init__(self):
        if self.host_depth < 1:
            raise ValueError(f"prefetch.host_depth must be >= 1, got {self.host_depth}")
        if self.device_depth < 1:
            raise ValueError(f"prefetch.device_depth must be >= 1, got {self.device_depth}")

    @classmethod
    def from_config(cls, raw: Any) -> "PrefetchConfig":
        if raw is None:
            return cls()
        if hasattr(raw, "to_dict"):
            raw = raw.to_dict()
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dict(raw).items() if k in known})


@dataclasses.dataclass
class StepBatch:
    """One optimizer step's input and the state to resume *before* it was consumed:
    ``client_state`` holds the scheduler / dataloader ``state_dict()`` snapshots taken
    when the item was yielded, so restoring them makes step+1 the next item."""

    step: int
    epoch: int
    stack: Any
    client_state: dict[str, Any]


class _End:
    """Queue sentinel: the scheduler iterator is exhausted."""


class _Error:
    """Queue sentinel: the worker raised; re-raised at the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_END = _End()
_NOT_READY = object()  # get_nowait(): nothing buffered yet


def _snapshot_states(scheduler: Any, dataloader: Any) -> dict[str, Any]:
    return {"step_scheduler": dict(scheduler.state_dict()),
            "dataloader": dict(dataloader.state_dict())}


class HostPrefetcher:
    """Background-thread producer of :class:`StepBatch` items. While it runs, only the
    worker thread touches the scheduler and the dataloader."""

    def __init__(self, scheduler: Any, dataloader: Any, stack_fn: Callable[[list], Any],
                 depth: int = 2, name: str = "host-prefetch"):
        self.scheduler = scheduler
        self.dataloader = dataloader
        self.stack_fn = stack_fn
        self._q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- worker side
    def _put(self, item: Any) -> bool:
        """Bounded put that close() can always interrupt."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for batches in self.scheduler:
                # the post-yield state, snapshotted before stacking so that the pair
                # (stack, state) is consistent even if stack_fn raises
                state = _snapshot_states(self.scheduler, self.dataloader)
                item = StepBatch(int(self.scheduler.step), int(self.scheduler.epoch),
                                 self.stack_fn(batches), state)
                if not self._put(item) or self._stop.is_set():
                    return
            self._put(_END)
        except BaseException as exc:  # noqa: BLE001 - re-raised at the consumer
            if not self._stop.is_set():
                self._put(_Error(exc))

    # ----------------------------------------------------------- consumer side
    def _resolve(self, item: Any) -> Any:
        if item is _END:
            self._q.put(_END)  # stay terminal for later calls
            return None
        if isinstance(item, _Error):
            self._q.put(item)
            raise item.exc
        return item

    def get(self) -> StepBatch | None:
        """The next item in order; None at the end of the data; re-raises worker errors."""
        while True:
            try:
                return self._resolve(self._q.get(timeout=0.1))
            except queue.Empty:
                if not self._thread.is_alive():
                    # the worker may have queued its last items and exited between the
                    # timeout and the liveness check: one drain, now race-free
                    try:
                        return self._resolve(self._q.get_nowait())
                    except queue.Empty:
                        return None

    def get_nowait(self) -> Any:
        """Non-blocking: a StepBatch, None (the end), or _NOT_READY."""
        try:
            return self._resolve(self._q.get_nowait())
        except queue.Empty:
            return _NOT_READY

    @property
    def ready(self) -> int:
        return self._q.qsize()

    def close(self) -> None:
        """Stop the worker and drain the queue; idempotent, and never blocks on a full
        queue (draining frees the worker's put, which checks the stop flag every 50 ms).
        Returns once the worker has exited."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                self._thread.join(timeout=0.05)


class DevicePrefetcher:
    """Keeps ``depth`` stacks in flight to the device, on the consumer thread.

    ``put_fn`` copies a host stack (a dict of numpy arrays) to the device. On a CUDA
    ``device`` the copy runs instead on a side stream from pinned memory, so step k+1's
    copy overlaps step k's compute."""

    def __init__(self, source: HostPrefetcher, put_fn: Callable[[Any], Any], depth: int = 2,
                 device: torch.device | None = None):
        self.source = source
        self.put_fn = put_fn
        self.depth = max(int(depth), 1)
        self.device = device
        self._stream = (torch.cuda.Stream(device) if device is not None and device.type == "cuda"
                        else None)
        self._buf: list[tuple[StepBatch, Any]] = []  # (item, copy-done event or None)
        self._exhausted = False
        self._pending_error: BaseException | None = None

    def _transfer(self, item: StepBatch) -> tuple[StepBatch, Any]:
        if self._stream is None:
            return dataclasses.replace(item, stack=self.put_fn(item.stack)), None
        pinned = {k: torch.from_numpy(v).pin_memory() for k, v in item.stack.items()}
        with torch.cuda.stream(self._stream):
            stack = {k: t.to(self.device, non_blocking=True) for k, t in pinned.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return dataclasses.replace(item, stack=stack), done

    def _top_up(self) -> None:
        """Start copies for every host-ready stack without blocking. Errors, from the
        worker and from the copy, wait until the items before them are consumed, so
        they surface at the same batch position as on the synchronous path."""
        while len(self._buf) < self.depth and not self._exhausted and self._pending_error is None:
            try:
                item = self.source.get_nowait()
            except BaseException as exc:  # noqa: BLE001
                self._pending_error = exc
                return
            if item is _NOT_READY:
                return
            if item is None:
                self._exhausted = True
                return
            try:
                self._buf.append(self._transfer(item))
            except BaseException as exc:  # noqa: BLE001
                self._pending_error = exc
                return

    def get(self) -> StepBatch | None:
        if not self._buf:
            if self._pending_error is not None:
                exc, self._pending_error = self._pending_error, None
                raise exc
            if self._exhausted:
                return None
            item = self.source.get()  # a true stall: wait for the host worker
            if item is None:
                self._exhausted = True
                return None
            self._buf.append(self._transfer(item))
        self._top_up()  # start the copies of k+1.. before handing back k
        item, done = self._buf.pop(0)
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in item.stack.values():
                t.record_stream(consumer)
        self._top_up()
        return item

    @property
    def ready(self) -> int:
        return len(self._buf)


class InputPipeline:
    """One ``get()`` per optimizer step: a :class:`StepBatch`, or None at the end of
    the data. ``client_states()`` is what the checkpointer persists for the scheduler
    and the dataloader."""

    def __init__(self, scheduler: Any, dataloader: Any, stack_fn: Callable[[list], Any],
                 put_fn: Callable[[Any], Any], config: PrefetchConfig | None = None,
                 device: torch.device | None = None):
        self.config = config or PrefetchConfig()
        self.scheduler = scheduler
        self.dataloader = dataloader
        self.stack_fn = stack_fn
        self.put_fn = put_fn
        self._consumed_state: dict[str, Any] | None = None
        self._host: HostPrefetcher | None = None
        self._device: DevicePrefetcher | None = None
        self._sync_it: Iterator[list] | None = None
        if self.config.enabled:
            # the consumed position until the first get(): the worker starts advancing
            # the live objects at once
            self._initial_state = _snapshot_states(scheduler, dataloader)
            self._host = HostPrefetcher(scheduler, dataloader, stack_fn,
                                        depth=self.config.host_depth)
            self._device = DevicePrefetcher(self._host, put_fn, depth=self.config.device_depth,
                                            device=device)
        else:
            self._sync_it = iter(scheduler)

    @property
    def prefetching(self) -> bool:
        return self._device is not None

    def get(self) -> StepBatch | None:
        if self._device is not None:
            item = self._device.get()
            if item is not None:
                self._consumed_state = item.client_state
            return item
        batches = next(self._sync_it, None)
        if batches is None:
            return None
        return StepBatch(step=int(self.scheduler.step), epoch=int(self.scheduler.epoch),
                         stack=self.put_fn(self.stack_fn(batches)), client_state={})

    def ready_depth(self) -> int:
        """Stacks buffered ahead of the consumer (host queue and device ring); 0 means
        the next step waits on the host."""
        if not self.prefetching:
            return 0
        return self._host.ready + self._device.ready

    def client_states(self) -> dict[str, Any]:
        """The scheduler / dataloader state to checkpoint in place of the live objects':
        the snapshot of the last consumed item when prefetching (before the first, the
        one taken before the worker started), and nothing when synchronous (the live
        objects are the consumed state)."""
        if not self.prefetching:
            return {}
        return dict(self._initial_state if self._consumed_state is None
                    else self._consumed_state)

    def close(self) -> None:
        """Stop the worker and drop the buffers; idempotent. Runs before anything
        restores scheduler or dataloader state (the worker mutates both)."""
        if self._host is not None:
            self._host.close()
        self._device = None
        self._host = None
