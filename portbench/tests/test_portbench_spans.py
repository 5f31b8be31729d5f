"""The per-layer metrics that read the program's own spans
(`portbench/core/spans.py`): each reader on a canned trace and canned
program records, the window clip, and None where nothing is recorded or
the program has no such module.  A `gpu`-marked test checks on the card
that the program's spans and the profiler's events share one clock."""

import importlib
import sys
from bisect import bisect_right

import pytest

from portbench import run as bench
from portbench.core import spans as sp
from portbench.core import trace as tr

import ffmpeg_tpu_torch
from ffmpeg_tpu_torch import trace

from portbench.tests.test_portbench_metrics import canned

NS = 100_000_000_000                      # the canned window starts at 100 s


def ms(a, b):
    return NS + int(a * 1e6), NS + int(b * 1e6)


def records():
    """Two frames' prep, the second with 0.5 ms outside its children, in
    the canned 10 ms window (busy 0-5 and 8-8.5 ms); the first begins
    before the window and a parse lies after it."""
    P = "mjpeg.prep"
    return [
        (P + ".wait", P, *ms(-1, 0.5)), (P + ".parse", P, *ms(0.5, 1)),
        (P + ".table", P, *ms(1, 1.5)), (P + ".split", P, *ms(1.5, 3)),
        (P, None, *ms(-1, 3)),
        (P + ".wait", P, *ms(4.5, 5.5)), (P + ".parse", P, *ms(5.5, 6)),
        (P + ".table", P, *ms(6, 6.5)), (P + ".split", P, *ms(6.5, 7.5)),
        (P, None, *ms(4.5, 8)),
        ("mjpeg.run_batch", None, *ms(8, 9.5)),
        ("graph.run", None, *ms(9.5, 10)),
        (P + ".parse", P, *ms(11, 12)),
    ]


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(trace, "_spans", records())
    monkeypatch.setattr(trace, "_events", [
        ("mjpeg.tables_built", 1, ms(1, 1)[0]),
        ("mjpeg.tables_built", 1, ms(6, 6)[0]),
        ("mjpeg.tables_built", 1, ms(12, 12)[0])])


def ctx(frames=2):
    return bench.Context({"name": "c"}, {}, {}, {"frames": frames}, canned())


def read(name, c):
    return bench.metric_reader(name)(c)


@pytest.mark.parametrize("name,want", [
    ("prep_parse_ms_per_frame", 1.0 / 2),
    ("prep_table_ms_per_frame", 1.0 / 2),
    ("prep_split_ms_per_frame", 2.5 / 2),
    ("upload_wait_ms_per_frame", 1.5 / 2),   # the first clipped at 0 ms
    ("enqueue_ms_per_frame", 1.5 / 2),
    ("idle_in_prep_pct", 25.0),              # idle 5.5-8 ms of 10
    ("graph_host_ms_per_frame.clip", 0.5 / 2),
])
def test_readers(program, name, want):
    assert read(name, ctx()) == pytest.approx(want)


def test_self_time_and_counts(program):
    c = ctx()
    assert sp.ms_per_frame(c, "mjpeg.prep") == pytest.approx(6.5 / 2)
    assert sp.self_ms_per_frame(c, "mjpeg.prep") == pytest.approx(0.5 / 2)
    assert sp.program_count(c, "mjpeg.tables_built") == 2


def test_idle_share_within_device_idle(program):
    c = ctx()
    assert read("idle_in_prep_pct", c) <= read("device_idle_pct", c)


NAMES = ["prep_parse_ms_per_frame", "prep_table_ms_per_frame",
         "prep_split_ms_per_frame", "upload_wait_ms_per_frame",
         "enqueue_ms_per_frame", "idle_in_prep_pct",
         "graph_host_ms_per_frame.clip"]


@pytest.mark.parametrize("name", NAMES)
def test_silent_without_records(monkeypatch, name):
    monkeypatch.setattr(trace, "_spans", [])
    assert read(name, ctx()) is None
    monkeypatch.setattr(trace, "_spans", records()[-1:])   # after the window
    assert read(name, ctx()) is None
    monkeypatch.setattr(trace, "_spans", records())
    if "_per_frame" in name:                  # no frames, nothing a frame
        assert read(name, ctx(frames=0)) is None


@pytest.mark.parametrize("name", NAMES)
def test_silent_without_the_module(monkeypatch, name):
    """A checkout whose program has no `ffmpeg_tpu_torch.trace` reads
    nothing and does not raise."""
    monkeypatch.delattr(ffmpeg_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "ffmpeg_tpu_torch.trace", None)
    assert read(name, ctx()) is None


def _covered(spans, s, e, slack):
    """Whether [s, e] lies inside one of `spans` (sorted by start) widened
    by `slack` on each side."""
    i = bisect_right([a for a, _ in spans], s + slack) - 1
    return i >= 0 and spans[i][0] - slack <= s and e <= spans[i][1] + slack


@pytest.mark.gpu
def test_prep_spans_on_the_profiler_clock(cuda_device):
    """In a 2 s traced window of `mjpeg224.b8`, every program `mjpeg.prep`
    lies within a harness `pb.prep_frame` span, within 50 us, and no
    profiler event carries a program span's name."""
    import torch
    from portbench.core.window import run_window
    b = bench.load_json(bench.ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in b["workloads"]}["mjpeg224.b8"]
    entry = {c["name"]: c for c in b["configs"]}[cell["config"]]
    cfg = bench.load_json(bench.ROOT / entry["file"])
    traffic = bench.load_json(bench.HERE / "traffic"
                              / f"{cell['traffic']}.json")
    torch.backends.cuda.matmul.allow_tf32 = False
    mod = importlib.import_module(f"portbench.paths.{cfg['path']}")
    path = mod.Path(cfg, traffic, 2 ** 31 + 77, cuda_device, True)
    for _ in range(traffic["warm_batches"]):
        path.batch()
    torch.cuda.synchronize()
    prof = tr.profile()
    prof.start()
    with tr.span(True, "window"):
        run_window(path, 2.0, 1, 1, cuda_device)
    prof.stop()
    t = tr.read(prof)
    lo, hi = (int(x * 1e9) for x in t.window)
    preps = [s for s in trace.spans(lo, hi) if s[0] == "mjpeg.prep"]
    harness = sorted((s, e) for n, s, e in t.host_spans
                     if n == "prep_frame")
    assert len(preps) >= 100
    outside = [p for p in preps
               if not _covered(harness, p[2] / 1e9, p[3] / 1e9, 50e-6)]
    assert not outside, (len(outside), outside[:3], harness[:3])
    names = {s[0] for s in trace.spans(lo, hi)}
    assert "mjpeg.prep.split" in names and "mjpeg.run_batch" in names
    events = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & events
