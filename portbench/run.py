"""The benchmark of the PyTorch and CUDA port, `ffmpeg_tpu_torch`, on one
or more NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of BENCHMARK.json from the root of a checkout: builds its
inputs from the seed and the program (set-up, `setup_s`), warms up the
cell's shapes, measures a closed loop of batches for `--seconds`, then
checks a seeded sample of the window's outputs against the plain
reference under `portbench/reference/`.  With `--trace 0` it reports
the cell's end-to-end metrics, with `--trace 1` its per-layer metrics
from a torch.profiler trace of the window.  The last line of standard
output is one JSON object; the numbers compared, each with its limit,
are the last lines of standard error and the last key of that object.

A cell is data: its configuration file (configs/), its traffic file
(traffic/), the path driver its configuration names (paths/), and one
reader a per-layer metric (metrics/), each found by its name.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every build and kernel cache at a fixed place inside the checkout (the
# program's own CUDA and C++ libraries go to build/ffmpeg_tpu_torch/)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "ffmpeg_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    relatives' or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_reader(name: str):
    """metrics/<name>.py, loaded by its path (a name may hold a dot)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end, per-layer) metric entries that `cell` reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", [cell]) and m["moves"] in names]
    return e2e, layer


class Context:
    """What a per-layer metric reader sees of a traced run."""

    def __init__(self, cell, config, traffic, counts, trace):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.counts, self.trace = counts, trace


def run(cell: dict, config: dict, traffic: dict, e2e_metrics: list,
        layer_metrics: list, seed: int, seconds: float, tracing: bool,
        device, t_start: float) -> tuple:
    """One run of `cell` on `device`: (result object, checks).  Raises on
    any failure of the program; `correct` says whether its outputs
    passed the check."""
    import torch
    from portbench.core import trace as tr
    from portbench.core.window import run_window

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_build = time.perf_counter()
    mod = importlib.import_module(f"portbench.paths.{config['path']}")
    path = mod.Path(config, traffic, seed, device, tracing)
    t_warm = time.perf_counter()
    for _ in range(traffic["warm_batches"]):
        path.batch()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    path.reset_counts()
    setup_s = time.perf_counter() - t_start
    print(f"portbench: {cell['name']}: {path.describe()}; set-up "
          f"{setup_s:.3f} s: start {t_build - t_start:.3f}, inputs and "
          f"program {path.build_s}, warm-up "
          f"{time.perf_counter() - t_warm:.3f}", file=sys.stderr)

    prof = tr.profile() if tracing else None
    if prof is not None:
        prof.start()
    with tr.span(tracing, "window"):
        window = run_window(path, seconds, traffic["check_batches"], seed,
                            device)
    trace = None
    if prof is not None:
        prof.stop()
        trace = tr.read(prof)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded in the window: {found}")

    checks = {f: {"value": v, "limit": 0}
              for f, v in path.exact_checks().items()}
    path.close()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = path.reference("float64")
    excess = path.excess(window.kept, ref)
    limit = config["check"]["excess_lsb"]
    checks["excess_lsb"] = {"value": max(excess), "limit": limit}
    failed = sum(e > limit for e in excess)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": bool(correct), "attempted": window.frames_enqueued,
              "failed": int(failed)}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if not tracing:
        # a cell reports each end-to-end quantity under its metric's name
        # (the part before the first dot says which quantity)
        values = {"frames_per_s": window.frames_per_s,
                  "batch_p95_ms": window.p95_ms(), "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"].split(
            ".")[0]], "unit": m["unit"]} for m in e2e_metrics}
        lat = sorted(window.latencies_s)
        prep = path.counts.get("prep_s") or [0.0]
        print(f"portbench: {len(lat)} batches done in the window of "
              f"{window.batches} enqueued, {window.frames_done} frames; "
              f"batch latency p50 {lat[len(lat) // 2] * 1e3} ms; host prep "
              f"{sum(prep) * 1e3 / len(prep)} ms a frame", file=sys.stderr)
    else:
        ctx = Context(cell, config, traffic, path.counts, trace)
        metrics = {}
        for m in layer_metrics:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        result["breakdown"] = tr.breakdown(trace)
    result["device"] = dev
    print(f"portbench: checked {len(excess)} frames of "
          f"{len(window.kept)} batches drawn from the window",
          file=sys.stderr)
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT / config_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    e2e, layer = cell_metrics(bench, cell["name"])

    import torch
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {torch.cuda.device_count()} CUDA devices, the "
              f"cell needs {cell['chips']}", file=sys.stderr)
        return 1
    result, checks = run(cell, config, traffic, e2e, layer, args.seed,
                         args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 1
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
