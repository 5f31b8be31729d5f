"""The traced run: torch.profiler over the window, read into plain lists.

Host spans are the harness's own `torch.profiler.record_function` marks,
named `pb.<what>` (`span()` below), around each call into the program;
device operations are the trace's kernels, copies and sets on the card.
The trace is read from the profiler's own event records (building
Python event objects and trees for every event costs far more, for the
same names and times).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

PREFIX = "pb."


def span(tracing: bool, name: str):
    """A host span `pb.<name>` in a traced run; nothing otherwise."""
    if not tracing:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(PREFIX + name)


@dataclass
class Trace:
    device_ops: list = field(default_factory=list)   # (name, start, end) s
    host_spans: list = field(default_factory=list)   # (name, start, end) s
    window: tuple = (0.0, 0.0)                       # pb.window, s

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end)."""
        lo, hi = self.window
        out: list = []
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def op_seconds(self, pred) -> float:
        return sum(e - s for n, s, e in self.device_ops if pred(n))

    def op_count(self, pred) -> int:
        return sum(1 for n, _, _ in self.device_ops if pred(n))


def profile():
    from torch.profiler import ProfilerActivity, profile as _profile
    return _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def read(prof) -> Trace:
    """Device operations and the harness's host spans of a finished
    profile, in seconds on the trace's clock."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    t = Trace()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns() / 1e9
        end = s + e.duration_ns() / 1e9
        if name.startswith(PREFIX):
            if e.device_type() == cuda:
                continue                  # the span's shadow on the device
            if name == PREFIX + "window":
                t.window = (s, end)
            else:
                t.host_spans.append((name[len(PREFIX):], s, end))
        elif e.device_type() == cuda:
            t.device_ops.append((name, s, end))
    return t


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def is_h2d(name: str) -> bool:
    return name.startswith("Memcpy HtoD")


def breakdown(t: Trace, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    device's idle time in the window summed by the host span that was
    open ("harness" where none was)."""
    by_op: dict = {}
    for n, s, e in t.device_ops:
        key = n[:200]
        by_op[key] = by_op.get(key, 0.0) + (e - s)
    gaps, cur = [], t.window[0]
    for s, e in t.busy_intervals():
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t.window[1] > cur:
        gaps.append((cur, t.window[1]))
    spans = sorted(t.host_spans, key=lambda x: x[1])
    by_host: dict = {}
    k = 0
    for gs, ge in gaps:
        while k < len(spans) and spans[k][2] <= gs:
            k += 1
        covered = 0.0
        j = k
        while j < len(spans) and spans[j][1] < ge:
            n, s, e = spans[j]
            ov = min(e, ge) - max(s, gs)
            if ov > 0:
                by_host[n] = by_host.get(n, 0.0) + ov
                covered += ov
            j += 1
        by_host["harness"] = by_host.get("harness", 0.0) + (ge - gs - covered)
    rank = lambda d: [[n, v] for n, v in sorted(d.items(),
                                                 key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}
