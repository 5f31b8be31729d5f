"""The cells of BENCHMARK.json cut to sizes a CPU test run holds: the
configuration's sizes shrunk, its path, texture, precision and checks as
they are."""

from portbench import run as bench

ROOT = bench.ROOT

SMALL = {
    "mjpeg_pipeline": ({"width": 256, "height": 144, "frames": 5},
                       {"batch": 2, "warm_batches": 2, "check_batches": 6}),
    "clip_graph": ({"src_w": 160, "src_h": 90, "scale_w": 114, "scale_h": 64,
                    "crop": [56, 56, 28, 4], "frames_per_clip": 2},
                   {"clips": 2, "warm_batches": 2, "check_batches": 6}),
}


def small_cell(name: str):
    """(cell, config, traffic, end-to-end entries, per-layer entries) of
    cell `name`, cut."""
    b = bench.load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in b["workloads"]}[name]
    entry = {c["name"]: c for c in b["configs"]}[cell["config"]]
    cfg = bench.load_json(ROOT / entry["file"])
    traffic = bench.load_json(bench.HERE / "traffic"
                              / f"{cell['traffic']}.json")
    c, t = SMALL[cfg["path"]]
    cfg.update(c)
    traffic.update(t)
    return (cell, cfg, traffic) + bench.cell_metrics(b, name)


