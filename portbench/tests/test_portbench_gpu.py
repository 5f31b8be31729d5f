"""The benchmark on the card: each cell runs end to end and reads correct,
its traced run gives its per-layer metrics, and a directory that holds
only the benchmark (no program) gives no result: these are marked `gpu`
and skip where there is no card.  Without a card a run gives no result.

    python3 -m pytest -q -m gpu portbench/tests
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run as bench

B = bench.load_json(bench.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in B["workloads"]]


def run(cwd, cell, seed, trace, seconds=1):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=600)


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cuda_device, cell, trace):
    r = run(bench.ROOT, cell, 2 ** 31 + 4321, trace)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    e2e, layer = bench.cell_metrics(B, cell)
    want = {m["name"] for m in (layer if trace else e2e)}
    assert set(res["metrics"]) == want
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert res["breakdown"]["device_ops"]


@pytest.mark.gpu
def test_without_the_program_no_result(cuda_device, tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run(tmp_path, CELLS[0], 1, 0)
    assert r.returncode != 0 and not r.stdout.strip()


def test_without_a_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=bench.ROOT, capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode != 0 and not r.stdout.strip()
