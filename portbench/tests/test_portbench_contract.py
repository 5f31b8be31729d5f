"""BENCHMARK.json against the benchmark's contract: every cell, config,
traffic mix and per-layer metric resolves to its files, and every name,
unit and text keeps to the allowed characters and lengths."""

import json
import re

import pytest

from portbench import run as bench

B = bench.load_json(bench.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level():
    assert set(B) == {"command", "paths", "run_seconds", *KEYS}
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in B[section]]
    assert len(names) == len(set(names))
    for e in B[section]:
        assert set(e) - {"workloads"} == KEYS[section], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert TEXT.match(e[k]), (e["name"], k)


def test_cells_resolve():
    configs = {c["name"]: c for c in B["configs"]}
    used = set()
    pairs = set()
    for w in B["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
        c = configs[w["config"]]
        used.add(c["name"])
        cfg = bench.load_json(bench.ROOT / c["file"])
        assert (bench.HERE / "paths" / f"{cfg['path']}.py").is_file()
        assert (bench.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    assert len(pairs) == len(B["workloads"])
    assert used == set(configs)
    assert len({c["file"] for c in B["configs"]}) == len(configs)
    assert all(c["file"].startswith("portbench/") for c in B["configs"])


def test_metrics_resolve():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in B["workloads"]}
    for m in B["per_layer"]:
        assert (bench.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        _, layer = bench.cell_metrics(B, w)
        assert layer, w
    layers = {}
    for m in B["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all(TEXT.match(k) for k in layers)
