"""The port's spans and counters (ffmpeg_tpu_torch/trace.py) and their
call sites, on the CPU: nothing recorded without a profiler, parents
kept under one, the profiler's clock, the flagship's prep spans and
table counter, and the graph's tracer counter."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch import trace
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.filters import parse_graph
from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
    MjpegTpuEntropyPipeline, TpuEntropySpec)

from torch_port_util import fixture_packets

PREP_CHILDREN = ["mjpeg.prep.wait", "mjpeg.prep.parse", "mjpeg.prep.table",
                 "mjpeg.prep.split"]


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = trace.span("a"), trace.span("b")
    assert a is b
    n_spans, n_events = len(trace.spans()), len(trace.events())
    with a:
        trace.count("test.off", 2)
    assert len(trace.spans()) == n_spans
    assert len(trace.events()) == n_events
    assert trace.totals()["test.off"] >= 2


def test_nested_spans_carry_their_parents():
    t0 = time.time_ns()
    with cpu_profile():
        with trace.span("test.outer"):
            with trace.span("test.inner"):
                trace.count("test.on", 3)
            with trace.span("test.inner2"):
                pass
    got = {s[0]: s for s in trace.spans(t0) if s[0].startswith("test.")}
    assert got["test.outer"][1] is None
    assert got["test.inner"][1] == got["test.inner2"][1] == "test.outer"
    outer = got["test.outer"]
    for name in ("test.inner", "test.inner2"):
        assert outer[2] <= got[name][2] <= got[name][3] <= outer[3]
    (ev,) = [e for e in trace.events(t0) if e[0] == "test.on"]
    assert ev[1] == 3 and got["test.inner"][2] <= ev[2] <= got["test.inner"][3]


def test_window_and_dropped(monkeypatch):
    t0 = time.time_ns()
    with cpu_profile():
        with trace.span("test.kept"):
            pass
    t1 = time.time_ns()
    assert [s[0] for s in trace.spans(t0, t1)] == ["test.kept"]
    assert trace.spans(t1 + 1, t1 + 2) == []
    dropped = trace.totals().get("trace.dropped", 0)
    monkeypatch.setattr(trace, "CAPACITY", 0)
    with cpu_profile():
        with trace.span("test.dropped"):
            trace.count("test.dropped")
    assert trace.totals()["trace.dropped"] == dropped + 2
    assert not [s for s in trace.spans(t1) if s[0] == "test.dropped"]


def test_profiler_clock_and_no_profiler_event():
    """A program span inside record_function("outer") lies within the
    profiler's own start and end of `outer`, and adds no event to its
    list."""
    t0 = time.time_ns()
    with cpu_profile() as prof:
        with record_function("outer"):
            with trace.span("test.clock"):
                time.sleep(0.002)
    events = list(prof.profiler.kineto_results.events())
    (outer,) = [e for e in events if e.name() == "outer"]
    (s,) = [s for s in trace.spans(t0) if s[0] == "test.clock"]
    assert outer.start_ns() <= s[2] < s[3] <= \
        outer.start_ns() + outer.duration_ns()
    assert not [e for e in events if e.name() == "test.clock"]


@pytest.fixture(scope="module")
def flagship():
    pkts = fixture_packets()[:2]
    spec = TpuEntropySpec(fx.W, fx.H, fx.OUT, fx.OUT, batch=2,
                          stride=fx.STRIDE)
    return MjpegTpuEntropyPipeline(spec, pkts[0], device="cpu"), pkts


def test_prep_frame_spans(flagship):
    pipe, pkts = flagship
    t0 = time.time_ns()
    with cpu_profile():
        for j, p in enumerate(pkts):
            pipe.prep_frame(p, j)
    spans = [s for s in trace.spans(t0) if s[0].startswith("mjpeg.")]
    preps = [s for s in spans if s[0] == "mjpeg.prep"]
    assert len(preps) == len(pkts)
    for prep in preps:
        inside = [s for s in spans if prep[2] <= s[2] and s[3] <= prep[3]
                  and s is not prep]
        assert sorted(s[0] for s in inside) == sorted(PREP_CHILDREN)
        assert all(s[1] == "mjpeg.prep" for s in inside)
        assert prep[1] is None


def test_tables_built_once_per_table(flagship):
    pipe, pkts = flagship
    pipe.prep_frame(pkts[0], 0)
    built = trace.totals()["mjpeg.tables_built"]
    pipe.prep_frame(pkts[0], 0)
    pipe.prep_frame(pkts[0], 1)
    assert trace.totals()["mjpeg.tables_built"] == built
    pipe._lut_cache.clear()
    pipe.prep_frame(pkts[0], 0)
    assert trace.totals()["mjpeg.tables_built"] == built + 1


def test_run_batch_span():
    pkts = fixture_packets()[:1]
    spec = TpuEntropySpec(fx.W, fx.H, fx.OUT, fx.OUT, batch=1,
                          stride=fx.STRIDE)
    pipe = MjpegTpuEntropyPipeline(spec, pkts[0], device="cpu")
    pipe.prep_frame(pkts[0], 0)
    t0 = time.time_ns()
    with cpu_profile():
        pipe.run_batch()
    assert [s[0] for s in trace.spans(t0)] == ["mjpeg.run_batch"]


def _frame(w, h):
    planes = [torch.zeros((h, w), dtype=torch.uint8),
              torch.zeros((h // 2, w // 2), dtype=torch.uint8),
              torch.zeros((h // 2, w // 2), dtype=torch.uint8)]
    return Frame.video(w, h, "yuv420p", planes=planes)


def test_graph_tracers_built():
    g = parse_graph("scale=32:24:format=rgb24,tensornorm", device="cpu")
    built = lambda: trace.totals().get("graph.tracers_built", 0)
    g.run([_frame(64, 48)])
    first = built()
    t0 = time.time_ns()
    with cpu_profile():
        g.run([_frame(64, 48)])
    assert built() == first
    assert [s[0] for s in trace.spans(t0)] == ["graph.run"]
    g.run([_frame(96, 64)])
    assert built() > first
