"""Readings that the limits of `correct` are set from, on the card.

    python3 portbench/tools/readings.py --workload <cell> \\
        --seeds <n,n,...> [--seconds 2]

For each seed, in one process: the cell's inputs and program from the
seed, its warm-up, a window of `--seconds` at the cell's own load, and
then on the batches the check draws from that window

- `program`: the widest excess of the program's outputs over the
  rounding of the float64 reference (what a run compares);
- `control`: the same of the reference computed in TF32 (float32
  products of operands rounded to TF32's 10 mantissa bits) and put in
  the program's place, rounded as the program rounds;
- `control_hw`: the same with the card's own TF32 matmuls (float32
  reference, `allow_tf32` on).

One JSON line a seed on standard output.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from portbench import run as bench  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    import torch
    from portbench.core.window import run_window

    b = bench.load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in b["workloads"]}[args.workload]
    entry = {c["name"]: c for c in b["configs"]}[cell["config"]]
    cfg = bench.load_json(ROOT / entry["file"])
    traffic = bench.load_json(bench.HERE / "traffic"
                              / f"{cell['traffic']}.json")
    dev = torch.device("cuda", 0)
    mod = importlib.import_module(f"portbench.paths.{cfg['path']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        path = mod.Path(cfg, traffic, seed, dev, False)
        for _ in range(traffic["warm_batches"]):
            path.batch()
        w = run_window(path, args.seconds, traffic["check_batches"], seed,
                       dev)
        path.close()
        torch.cuda.empty_cache()
        ref = path.reference("float64")
        row = {"seed": seed, "frames": sum(len(k[2]) for k in w.kept),
               "program": max(path.excess(w.kept, ref))}
        ctrl = path.reference("tf32")
        row["control"] = max(path.excess(
            [(i, path.control(ids, ctrl), ids) for i, _, ids in w.kept], ref))
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        hw = path.reference("float32")
        row["control_hw"] = max(path.excess(
            [(i, path.control(ids, hw), ids) for i, _, ids in w.kept], ref))
        row["s"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        del path, w
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
