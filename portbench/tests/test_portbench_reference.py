"""A run on the CPU at a small size: the program's outputs pass the check
against the plain reference, and the reference computed in TF32 and put
in the program's place (the lower-precision control) fails it."""

import time

import pytest
import torch

from portbench import run as bench
from portbench.core.window import run_window
from portbench.tests.cells import small_cell

CELLS = ["mjpeg224.b8", "clipgraph.b64", "mjpeg224.b64"]


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_the_check(name):
    cell, cfg, traffic, e2e, layer = small_cell(name)
    res, checks = bench.run(cell, cfg, traffic, e2e, layer, 2 ** 31 + 99,
                            1.0, False, torch.device("cpu"),
                            time.perf_counter())
    assert res["correct"] and res["failed"] == 0
    assert checks["excess_lsb"]["value"] < 1e-3
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in e2e}


@pytest.mark.parametrize("name", ["mjpeg224.b8", "clipgraph.b64"])
def test_tf32_control_fails_the_check(name):
    import importlib
    cell, cfg, traffic, _, _ = small_cell(name)
    mod = importlib.import_module(f"portbench.paths.{cfg['path']}")
    path = mod.Path(cfg, traffic, 4242, torch.device("cpu"), False)
    w = run_window(path, 0.2, traffic["check_batches"], 4242,
                   torch.device("cpu"))
    path.close()
    ref = path.reference("float64")
    ctrl = path.reference("tf32")
    got = path.excess([(i, path.control(ids, ctrl), ids)
                       for i, _, ids in w.kept], ref)
    assert max(got) > cfg["check"]["excess_lsb"]
    # the float32 reference in the program's place passes
    f32 = path.reference("float32")
    got = path.excess([(i, path.control(ids, f32), ids)
                       for i, _, ids in w.kept], ref)
    assert max(got) < cfg["check"]["excess_lsb"]


def test_tf32_rounding():
    from portbench.reference.scale import to_tf32
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10,
                      -3.0 - 2 ** -9])
    got = to_tf32(x)
    # ties to even at the 10th mantissa bit; 2^-10 and 2^-9 steps kept
    assert got.tolist() == [1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10,
                            -3.0 - 2 ** -9]
