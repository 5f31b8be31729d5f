"""The MJPEG cells' device stage alone, for continuity with the flagship's
earlier timing (`chip_smoke.py` phase 5): ms a batch of `run_batch`
(upload from pinned memory included) by CUDA events over back-to-back
calls on one prepared batch, and K1 alone with the card spinning while
the host queues it.  Not a metric of the benchmark: the window's
`frames_per_s` has the host prep in it.

    python3 portbench/tools/device_ms.py --workload mjpeg224.b8 --seed <n>
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from portbench import run as bench  # noqa: E402
from portbench.core.timing import cuda_ms, kernel_ms  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    import torch
    from ffmpeg_tpu_torch.ops import huffman
    from portbench.paths.mjpeg_pipeline import Path as MjpegPath

    b = bench.load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in b["workloads"]}[args.workload]
    entry = {c["name"]: c for c in b["configs"]}[cell["config"]]
    cfg = bench.load_json(ROOT / entry["file"])
    traffic = bench.load_json(bench.HERE / "traffic"
                              / f"{cell['traffic']}.json")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    path = MjpegPath(cfg, traffic, args.seed, dev, False)
    path.batch()
    pipe = path.pipe
    batch_ms = cuda_ms(pipe.run_batch, args.reps)
    regions = torch.from_numpy(pipe.regions).to(dev)
    lens, luts = pipe.program.split_regions(regions)
    k1 = kernel_ms(lambda: huffman.jpeg_scan_decode_packed(
        regions, lens, luts, pipe.hdr), 20)
    print(json.dumps({"workload": args.workload, "batch": path.batch_size,
                      "run_batch_ms": batch_ms, "k1_ms": k1,
                      "device": torch.cuda.get_device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
