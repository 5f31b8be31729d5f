"""The check catches the faults a cell of this benchmark can have: the
whole of a run on the CPU at a small size, with the timed path broken
underneath (the look for a card skipped), reads `correct` false."""

import time

import pytest
import torch

from portbench import run as bench
from portbench.tests.cells import small_cell


def stale(orig):
    """A step that returns its state unchanged: every call after the
    first hands back the first call's outputs."""
    first = []

    def f(*a, **k):
        out = orig(*a, **k)
        if not first:
            first.append(out)
        return first[0]
    return f


def half(orig, planes):
    """Half of the batch left out: the second half's outputs are never
    computed (left zero)."""
    def f(*a, **k):
        out = orig(*a, **k)
        for p in planes(out):
            p[p.shape[0] // 2:] = 0
        return out
    return f


def altered(orig, planes):
    """An answer altered where it is produced: frame 0's outputs off by a
    few steps."""
    def f(*a, **k):
        out = orig(*a, **k)
        for p in planes(out):
            p[0] = p[0] + (3 if p.dtype == torch.uint8 else 0.05)
        return out
    return f


def mjpeg_target():
    from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
        MjpegTpuEntropyPipeline)
    return MjpegTpuEntropyPipeline, "run_batch", lambda out: out


def graph_target():
    from ffmpeg_tpu_torch.filters.graph import FilterGraph
    return FilterGraph, "run", lambda out: out[0].planes


FAULTS = {"stale": lambda o, planes: stale(o), "half": half,
          "altered": altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name,target", [("mjpeg224.b8", mjpeg_target),
                                         ("clipgraph.b64", graph_target)])
def test_fault_reads_not_correct(monkeypatch, fault, name, target):
    cls, method, planes = target()
    monkeypatch.setattr(cls, method,
                        FAULTS[fault](getattr(cls, method), planes))
    cell, cfg, traffic, e2e, layer = small_cell(name)
    res, checks = bench.run(cell, cfg, traffic, e2e, layer, 31337, 1.0,
                            False, torch.device("cpu"), time.perf_counter())
    assert res["correct"] is False
    assert res["failed"] > 0
    assert checks["excess_lsb"]["value"] > checks["excess_lsb"]["limit"]
