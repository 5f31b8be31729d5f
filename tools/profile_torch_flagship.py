#!/usr/bin/env python3
"""Where the device time of the port's flagship batch goes, on one GPU.

Builds the flagship pipeline of ffmpeg_tpu_torch (the committed 8-frame
1920x1080 MJPEG clip, batch 8, 224x224 rgb24, bicubic), stages the batch
once, and then:

- times `run_batch` (host-to-device copy included) over N batches with
  CUDA events, without the profiler;
- traces N more batches with torch.profiler and sums each device kernel's
  own time, per batch, into the groups named in GROUPS;
- reports the device's idle share of a `run_batch` loop, 1 - (kernel time
  per batch) / (event time per batch), and the peak device memory of one
  batch.

Prints every kernel row, then the groups, then one JSON line.  Fails if
the trace holds no device time.

Usage (from the repository root, one card):

    python3 tools/profile_torch_flagship.py [--batches 20]
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# (group, substrings of the kernel name, lower-cased); first match wins
GROUPS = (
    ("K1 jpeg_scan_decode_packed", ("jpeg_scan_decode",)),
    ("H2D copy", ("memcpy htod",)),
    ("fp32 GEMMs (cuBLAS/CUTLASS)", ("gemm", "cutlass", "cublas")),
    ("copies (einsum permutes, contiguous)", ("copy", "memcpy")),
)
OTHER = "elementwise, conversions, reductions"


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return OTHER


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=20)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ffmpeg_tpu_torch.io.mjpeg import split_packets
    from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
        MjpegTpuEntropyPipeline, TpuEntropySpec)
    from ffmpeg_tpu_torch.testing import (BATCH, FIXTURE, H, OUT, STRIDE, W,
                                          packed_cap)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    pkts = split_packets(FIXTURE.read_bytes())
    spec = TpuEntropySpec(W, H, OUT, OUT, batch=BATCH, stride=STRIDE,
                          packed_cap=packed_cap(pkts))
    pipe = MjpegTpuEntropyPipeline(spec, max(pkts, key=len), device=dev)
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    n = args.batches

    for _ in range(3):                       # build K1, warm the allocator
        pipe.run_batch()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        pipe.run_batch()
    t1.record()
    t1.synchronize()
    batch_ms = t0.elapsed_time(t1) / n

    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    pipe.run_batch()
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            pipe.run_batch()
        torch.cuda.synchronize()
    rows = [(e.key, e.count / n, e.self_device_time_total / 1e3 / n)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        raise RuntimeError("the trace holds no device time")
    rows.sort(key=lambda r: -r[2])
    kern_ms = sum(r[2] for r in rows)
    groups = {}
    for name, _, ms in rows:
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + ms

    lines = [f"card: {card}",
             f"run_batch: {batch_ms} ms/batch over {n} batches of {BATCH} "
             f"(CUDA events, no profiler)",
             f"device kernels: {kern_ms} ms/batch ({n} traced batches)",
             f"idle share: {1 - kern_ms / batch_ms}",
             f"peak device memory of one batch: {peak_mib} MiB",
             "", "kernel rows, per batch: launches, ms, name"]
    lines += [f"  {c:g}\t{ms:.6f}\t{name}" for name, c, ms in rows]
    lines += ["", "groups, per batch: ms, share of kernel time"]
    lines += [f"  {ms:.6f}\t{ms / kern_ms:.4f}\t{g}"
              for g, ms in sorted(groups.items(), key=lambda x: -x[1])]
    print("\n".join(lines))
    print(json.dumps({"card": card, "batch_ms": batch_ms,
                      "kernel_ms": kern_ms,
                      "idle_share": 1 - kern_ms / batch_ms,
                      "peak_mib": peak_mib, "groups_ms": groups}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
