"""Spans and counters inside the port, on the torch profiler's clock.

The port records exactly while a torch profiler records, and nothing
otherwise:

- `span(name)`: a context manager around one piece of host work.  With
  no profiler recording it returns one shared no-op context (one call
  and one check of `torch.autograd._profiler_enabled()`).  While one
  records it keeps `(name, parent, start_ns, end_ns)`, where `parent` is
  the name of the innermost span open on the same thread (None at the
  top) and both times are `time.time_ns()`, the clock on which the
  profiler stamps its own host events.
- `count(name, n=1)`: adds `n` to a running total always; while a
  profiler records it also keeps `(name, n, t_ns)`, so that a reader can
  count within a window.

The records stay in memory, in buffers of `CAPACITY` records each;
records past that are dropped and counted under the total
"trace.dropped".  Nothing here enters the profiler's own event list (no
`record_function`, no NVTX): a program span there would leave a shadow
on the device that the profiler's readers would take for device work.

Read the records beside the profiler's events, on one clock::

    with torch.profiler.profile(activities=[...]) as prof:
        run()
    trace.spans(lo_ns, hi_ns)   # (name, parent, start_ns, end_ns)
    trace.events(lo_ns, hi_ns)  # (name, n, t_ns)
    trace.totals()              # {name: total}
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

CAPACITY = 1 << 20               # records a buffer holds

_enabled = torch.autograd._profiler_enabled
_NOOP = contextlib.nullcontext()
_spans: list = []
_events: list = []
_totals: dict = {}
_totals_lock = threading.Lock()
_local = threading.local()


def _add(name: str, n: int) -> None:
    with _totals_lock:
        _totals[name] = _totals.get(name, 0) + n


def _keep(buf: list, record: tuple) -> None:
    if len(buf) < CAPACITY:
        buf.append(record)
    else:
        _add("trace.dropped", 1)


class _Span:
    __slots__ = ("name", "parent", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        _keep(_spans, (self.name, self.parent, self.start, end))
        return False


def span(name: str):
    """A span `name` of host work while a torch profiler records; the
    shared no-op context otherwise."""
    if not _enabled():
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the total `name`; while a torch profiler records, keep
    the addition with its time too."""
    _add(name, n)
    if _enabled():
        _keep(_events, (name, n, time.time_ns()))


def spans(lo_ns: int | None = None, hi_ns: int | None = None) -> list:
    """The kept spans that overlap [lo_ns, hi_ns] (all by default), as
    (name, parent, start_ns, end_ns) in the order they ended."""
    lo = -1 if lo_ns is None else lo_ns
    hi = float("inf") if hi_ns is None else hi_ns
    return [s for s in _spans if s[3] >= lo and s[2] <= hi]


def events(lo_ns: int | None = None, hi_ns: int | None = None) -> list:
    """The kept counter additions at times in [lo_ns, hi_ns] (all by
    default), as (name, n, t_ns)."""
    lo = -1 if lo_ns is None else lo_ns
    hi = float("inf") if hi_ns is None else hi_ns
    return [e for e in _events if lo <= e[2] <= hi]


def totals() -> dict:
    """Each counter's running total, since the process started."""
    with _totals_lock:
        return dict(_totals)
