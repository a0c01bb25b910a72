"""Named scopes for the profiler (counterpart of ``automodel_tpu/utils/tracing.py``).

:func:`scoped` runs a block under ``torch.profiler.record_function(name)``, as the JAX
package's ``scoped`` runs it under ``jax.named_scope``. A scope's forward ops are the
ops inside that range; its replay under a layer checkpoint is a range too, inside the
backward node that first needs the layer's activations; its backward ops are the autograd
nodes the forward's ops created, which run later on the autograd thread, outside any
range. :func:`scope_times` reads all three from a profiler's events: each backward node
carries the sequence number of the forward op that made it."""

from __future__ import annotations

import functools
from typing import Callable, Iterable

import torch

__all__ = ["launched_us", "scope_names", "scope_times", "scoped"]

_NAMES: set[str] = set()  # every name scoped() has wrapped a block in


def scoped(name: str, fn: Callable | None = None):
    """Wrap ``fn`` (or decorate) so that it runs under ``record_function(name)``."""
    _NAMES.add(name)

    def wrap(f):
        @functools.wraps(f)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(name):
                return f(*args, **kwargs)

        return inner

    return wrap(fn) if fn is not None else wrap


def scope_names() -> tuple[str, ...]:
    """The names :func:`scoped` has given, sorted."""
    return tuple(sorted(_NAMES))


def _on_host(event) -> bool:
    from torch.autograd import DeviceType

    return event.device_type == DeviceType.CPU and not event.is_async


def _is_node(event) -> bool:
    return event.name.startswith("autograd::engine::evaluate_function")


def _in_backward(event) -> bool:
    """Whether ``event`` runs inside a backward node (a replay, or a node's own ops)."""
    parent = event.cpu_parent
    while parent is not None:
        if _is_node(parent):
            return True
        parent = parent.cpu_parent
    return False


def _descendants(event):
    stack = list(event.cpu_children)
    while stack:
        child = stack.pop()
        stack.extend(child.cpu_children)
        yield child


def launched_us(event) -> float:
    """us of device work launched inside ``event``: the kernels, copies and memsets the
    profiler links to it and to its subtree, but not those it links to a "Command Buffer
    Full" marker (a launch that waited for room in the queue), which the launch's own op
    lists already. ``device_time_total`` counts those twice: on the H100 a Qwen3-Next
    step's host events summed to 1,035.8 ms against 814.7 ms of kernels, and to 814.5 ms
    without the markers."""
    return sum(sum(k.duration for k in e.kernels)
               for e in (event, *_descendants(event)) if e.name != "Command Buffer Full")


def scope_times(events: Iterable, names: Iterable[str],
                time_of: Callable = launched_us) -> dict[str, float]:
    """``{name: time}`` over a profiler's ``events()`` for each scope in ``names``: the
    scope's ranges, and the backward nodes made by the ops inside them. ``time_of`` reads
    an event's time with its children's (default: :func:`launched_us`, the device time
    of the work it launched, in us). A counted event inside another of the same scope is
    part of it; one inside another scope's (a layer's replay, which runs inside the
    backward node that first needs its activations) moves its time from that scope to its
    own. Unscoped ops of such a replay (the norms, the residual adds) stay with the node
    that ran it."""
    names = set(names)
    events = list(events)
    # sequence_nr of a forward op inside a scope -> the scope. Only the forward's ranges:
    # the nodes a replay makes never run, and its thread numbers its nodes on a counter
    # of its own (the backward's), which the forward's numbers would collide with. The
    # forward runs on one thread, so its numbers are unique.
    made_by = {}
    counted = {}  # id(event) -> scope
    spans = set()
    for e in events:
        # the host's range of a scope, once: not its span on the device's timeline (a
        # user annotation there, which covers idle time and kernels counted already)
        span = (e.name, e.thread, e.time_range.start, e.time_range.end)
        if e.name in names and _on_host(e) and span not in spans:
            spans.add(span)
            counted[id(e)] = e.name
            if not _in_backward(e):
                for child in _descendants(e):
                    if child.sequence_nr >= 0:
                        made_by[child.sequence_nr] = e.name
    for e in events:
        if _is_node(e) and e.sequence_nr >= 0 and not _in_backward(e):
            scope = made_by.get(e.sequence_nr)
            if scope is not None:
                counted[id(e)] = scope
    out = {name: 0.0 for name in names}
    for e in events:
        scope = counted.get(id(e))
        if scope is None:
            continue
        parent = e.cpu_parent  # the nearest counted ancestor
        while parent is not None and id(parent) not in counted:
            parent = parent.cpu_parent
        if parent is None or counted[id(parent)] != scope:
            t = float(time_of(e))
            out[scope] += t
            if parent is not None:
                out[counted[id(parent)]] -= t
    return out
