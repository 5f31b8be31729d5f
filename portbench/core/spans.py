"""The arithmetic of the per-layer metrics that read the program's own
spans and counters (`ffmpeg_tpu_torch.trace`), shared by their reader
files under metrics/.

The program keeps its records in memory on `time.time_ns()`, the clock on
which torch.profiler stamps its host events, so they lie on the traced
run's clock once converted to seconds: each is taken inside the window
(`pb.window`) and clipped to it.  A checkout whose program has no such
module, or a run in which it recorded nothing, reads None, never 0.
"""

from __future__ import annotations


def _window_ns(ctx) -> tuple:
    lo, hi = ctx.trace.window
    return int(lo * 1e9), int(hi * 1e9)


def program_spans(ctx):
    """The program's spans inside the traced window as (name, parent,
    start s, end s), clipped to the window; None where the program keeps
    no spans."""
    try:
        from ffmpeg_tpu_torch import trace
    except ImportError:          # a program without the module
        return None
    lo, hi = _window_ns(ctx)
    if hi <= lo:
        return None
    return [(n, p, max(s, lo) / 1e9, min(e, hi) / 1e9)
            for n, p, s, e in trace.spans(lo, hi)]


def program_count(ctx, name: str):
    """The additions to the program's counter `name` inside the traced
    window; None where the program keeps no counters."""
    try:
        from ffmpeg_tpu_torch import trace
    except ImportError:          # a program without the module
        return None
    lo, hi = _window_ns(ctx)
    return sum(n for c, n, _ in trace.events(lo, hi) if c == name)


def _frames(ctx) -> int:
    return ctx.counts.get("frames", 0)


def _span_s(spans, name: str) -> float:
    return sum(e - s for n, _, s, e in spans if n == name)


def ms_per_frame(ctx, name: str):
    """ms a frame of the program's spans `name` in the traced window."""
    spans = program_spans(ctx)
    if not spans or not _frames(ctx):
        return None
    t = _span_s(spans, name)
    return t * 1e3 / _frames(ctx) if t else None


def self_ms_per_frame(ctx, name: str):
    """ms a frame of the spans `name` less the part their child spans
    (those whose parent is `name`) cover."""
    spans = program_spans(ctx)
    if not spans or not _frames(ctx):
        return None
    t = _span_s(spans, name)
    if not t:
        return None
    child = sum(e - s for _, p, s, e in spans if p == name)
    return (t - child) * 1e3 / _frames(ctx)


def _union(intervals) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _subtract(a: list, b: list) -> list:
    """Sorted disjoint intervals `a` less sorted disjoint intervals `b`."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def idle_in_pct(ctx, name: str, minus: str):
    """Share of the traced window, in %, in which the card ran nothing
    while a span `name` was open and no span `minus` was."""
    spans = program_spans(ctx)
    w = ctx.trace.window_s
    if not spans or w <= 0 or not ctx.trace.device_ops:
        return None
    open_ = _union((s, e) for n, _, s, e in spans if n == name)
    if not open_:
        return None
    open_ = _subtract(open_, _union((s, e) for n, _, s, e in spans
                                    if n == minus))
    idle = _subtract(open_, ctx.trace.busy_intervals())
    return 100.0 * sum(e - s for s, e in idle) / w
