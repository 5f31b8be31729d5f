"""Run-to-run spread of a cell's metrics, the measure its bounds are set
from.

    python3 portbench/tools/spread.py --workload <cell> \\
        --seeds <n,n,...> [--sets 2] [--seconds 10] [--trace 0] \\
        --out <results.jsonl>

Runs `portbench/run.py` once a seed, one process at a time, `--sets`
times over the same seeds, and prints for each metric each set's median
and spread (the distance between the first and third quartiles of
`statistics.quantiles(values, n=4)`, as a share of the median), the
same with each set's run farthest from its median left out, and the
spread of all runs together.  Every result line is appended to `--out`,
a path from the root of the checkout.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: list) -> list:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=int, default=10)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    seeds = args.seeds.split(",")
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    with open(out, "a") as log:
        for k in range(args.sets):
            for seed in seeds:
                t = time.perf_counter()
                r = subprocess.run(
                    [sys.executable, "portbench/run.py", "--workload",
                     args.workload, "--seed", seed, "--seconds",
                     str(args.seconds), "--trace", str(args.trace)],
                    cwd=ROOT, capture_output=True, text=True, timeout=1200)
                wall = time.perf_counter() - t
                if r.returncode != 0:
                    print(f"set {k} seed {seed}: rc {r.returncode}\n"
                          f"{r.stderr[-3000:]}", flush=True)
                    return 1
                for line in r.stderr.splitlines():
                    if "set-up" in line or "batches done" in line:
                        print(line[-200:], flush=True)
                res = json.loads(r.stdout.strip().splitlines()[-1])
                res.update(set=k, seed=seed, wall_s=wall)
                log.write(json.dumps(res) + "\n")
                log.flush()
                runs.append(res)
                print(json.dumps({"set": k, "seed": seed, "wall_s": wall,
                                  "correct": res["correct"],
                                  "checks": res["checks"],
                                  **{n: m["value"] for n, m in
                                     res["metrics"].items()}}), flush=True)
    summary = {}
    for name in runs[0]["metrics"]:
        sets = [[r["metrics"][name]["value"] for r in runs if r["set"] == k]
                for k in range(args.sets)]
        summary[name] = {
            "medians": [statistics.median(v) for v in sets],
            "spreads": [spread(v) for v in sets],
            "spreads_trimmed": [spread(trimmed(v)) for v in sets],
            "spread_all": spread(sum(sets, []))}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
