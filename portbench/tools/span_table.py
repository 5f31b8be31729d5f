"""The program's own spans and counters in one traced run of a cell: for
each span name its ms a frame and its self ms a frame (less its child
spans), the share of `mjpeg.prep` its child spans cover, and each
counter's additions a frame and its total since the process started
(set-up and warm-up included), beside the run's result line.  Not a metric
of the benchmark: the figures behind the per-layer metrics that read the
same records (`portbench/core/spans.py`).

    python3 portbench/tools/span_table.py --workload <cell> --seed <n> \\
        [--seconds 20]

Prints the run's result line, then one JSON object.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from portbench import run as bench  # noqa: E402
from portbench.core import spans as sp  # noqa: E402

COUNTERS = ("mjpeg.tables_built", "graph.tracers_built")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()
    import torch
    from ffmpeg_tpu_torch import trace

    b = bench.load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in b["workloads"]}[args.workload]
    entry = {c["name"]: c for c in b["configs"]}[cell["config"]]
    cfg = bench.load_json(ROOT / entry["file"])
    traffic = bench.load_json(bench.HERE / "traffic"
                              / f"{cell['traffic']}.json")
    e2e, layer = bench.cell_metrics(b, cell["name"])
    seen = []

    class Context(bench.Context):      # keeps the run's traced context
        def __init__(self, *a):
            super().__init__(*a)
            seen.append(self)

    bench.Context = Context
    t0 = time.perf_counter()
    result, _ = bench.run(cell, cfg, traffic, e2e, layer, args.seed,
                          args.seconds, True, torch.device("cuda", 0), t0)
    print(json.dumps(result), flush=True)
    (ctx,) = seen
    spans = sp.program_spans(ctx) or []
    frames = ctx.counts["frames"]
    out = {"workload": cell["name"], "frames": frames,
           "window_s": ctx.trace.window_s,
           "frames_per_s_traced": frames / ctx.trace.window_s,
           "dropped": trace.totals().get("trace.dropped", 0),
           "device": torch.cuda.get_device_name(0), "spans": {}}
    for name in sorted({s[0] for s in spans}):
        out["spans"][name] = {
            "n": sum(1 for s in spans if s[0] == name),
            "ms_per_frame": sp.ms_per_frame(ctx, name),
            "self_ms_per_frame": sp.self_ms_per_frame(ctx, name)}
    prep = out["spans"].get("mjpeg.prep")
    if prep:
        out["prep_children_cover"] = \
            1 - prep["self_ms_per_frame"] / prep["ms_per_frame"]
    out["counters_per_frame"] = {
        c: sp.program_count(ctx, c) / frames for c in COUNTERS}
    out["totals"] = trace.totals()       # set-up and warm-up included
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
