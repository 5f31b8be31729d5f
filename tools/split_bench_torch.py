#!/usr/bin/env python3
"""The MJPEG destuff-and-split of several checkouts of the port, timed on
the host by the same code, on the benchmark's 1080p frames.

For each checkout given (a directory that holds `ffmpeg_tpu_torch/`, for
example `git archive` of another commit unpacked under a git-ignored
folder), a child process builds that checkout's host library
(`ffmpeg_tpu_torch.native.get()`) and prints its path; this process loads
every library with ctypes and times `mjpeg_split_segments`, and
`mjpeg_split_segments_portable` where the library has it, in turns, on
the frames of `portbench/configs/mjpeg1080_rgb224.json` made from
`--seed` (72 distinct frames, ~350 KB of scan each: ~25 MB, as the
benchmark cycles them, so the scans are read mostly from DRAM).

One round splits every frame once, straight from the frame's bytes, into
the next of `--slots` output slots in turn, as `prep_frame` fills the
slots of a batch (64, as `mjpeg224.b64`: ~25 MB of output, which the
caches do not hold; 1 keeps the output in the cache); a function's time
is the round's wall time over the frames.  Every output (the return code,
the offsets and the destuffed bytes) is checked equal to the first
library's.

Prints one line per function and, last, one JSON object with the host's
CPU, each library's `mjpeg_split_isa()` where it has one, and the median
and best round of each function in microseconds a frame.

Usage (from the repository root):

    python3 tools/split_bench_torch.py [--rounds 20] [--seed 1] \\
        [--slots 64] . path/to/other/checkout
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CONFIG = ROOT / "portbench" / "configs" / "mjpeg1080_rgb224.json"
FUNCS = ("mjpeg_split_segments", "mjpeg_split_segments_portable")


def host_library(checkout: Path) -> str:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from ffmpeg_tpu_torch import native; print(native.get()._name)")
    r = subprocess.run([sys.executable, "-c", code, str(checkout)],
                       capture_output=True, text=True, timeout=600,
                       check=True)
    return r.stdout.strip().splitlines()[-1]


def bind(path: str) -> dict:
    lib = ctypes.CDLL(path)
    fns = {}
    for name in FUNCS:
        if hasattr(lib, name):
            f = getattr(lib, name)
            f.restype = ctypes.c_long
            f.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                          ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
            fns[name] = f
    isa = None
    if hasattr(lib, "mjpeg_split_isa"):
        lib.mjpeg_split_isa.restype = ctypes.c_int
        isa = lib.mjpeg_split_isa()
    return {"fns": fns, "isa": isa}


def scans(seed: int):
    """(frame bytes, scan offset) of every frame of the config, and the
    MCU count."""
    import torch
    sys.path.insert(0, str(ROOT))
    from ffmpeg_tpu_torch.codecs.mjpeg import _JpegState, _parse_until_scan
    from portbench.inputs.mjpeg import make_clip
    cfg = json.loads(CONFIG.read_text())
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    clip = make_clip(seed, cfg["width"], cfg["height"], cfg["frames"],
                     cfg["quality"], cfg["max_code_len"],
                     cfg["luma_texture"], cfg["chroma_texture"], dev)
    out = []
    for pkt in clip.packets:
        st = _JpegState()
        off, _ = _parse_until_scan(pkt, st)
        out.append((pkt, off))
    nmcu = -(-cfg["width"] // 16) * -(-cfg["height"] // 16)
    return out, nmcu


def cpu_model() -> str:
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        if line.startswith("model name"):
            return line.split(":", 1)[1].strip()
    return "unknown"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--slots", type=int, default=64)
    args = ap.parse_args()
    libs = {c: bind(host_library(Path(c).resolve())) for c in args.checkouts}
    frames, nmcu = scans(args.seed)
    cap = max(len(p) - off for p, off in frames) + 4096
    out = np.zeros((args.slots, cap), np.uint8)
    slot = [out[j % args.slots] for j in range(len(frames))]
    offs = np.zeros(nmcu + 2, np.int32)
    views = [(np.frombuffer(p, np.uint8), off) for p, off in frames]
    runs = [(c, name, f) for c, lib in libs.items()
            for name, f in lib["fns"].items()]
    want = None
    for c, name, f in runs:                       # outputs, once each
        got = []
        for (v, off), o in zip(views, slot):
            n = f(v.ctypes.data + off, len(v) - off, o.ctypes.data, cap,
                  offs.ctypes.data, nmcu)
            got.append((n, offs.copy(), o[:offs[n]].copy()))
        if want is None:
            want = got
        for (n, o, b), (wn, wo, wb) in zip(got, want):
            if n != wn or not np.array_equal(o, wo) or \
                    not np.array_equal(b, wb):
                print(f"{c} {name}: output differs", flush=True)
                return 1
    times = {(c, name): [] for c, name, _ in runs}
    for _ in range(args.rounds):
        for c, name, f in runs:
            t = time.perf_counter()
            for (v, off), o in zip(views, slot):
                f(v.ctypes.data + off, len(v) - off, o.ctypes.data, cap,
                  offs.ctypes.data, nmcu)
            times[(c, name)].append(
                (time.perf_counter() - t) / len(views) * 1e6)
    result = {"cpu": cpu_model(), "frames": len(views),
              "slots": args.slots,
              "scan_bytes": [min(len(p) - o for p, o in frames),
                             max(len(p) - o for p, o in frames)],
              "isa": {c: lib["isa"] for c, lib in libs.items()},
              "us_per_frame": {}}
    for (c, name), ts in times.items():
        med, best = statistics.median(ts), min(ts)
        print(f"{c:40s} {name:32s} median {med:8.1f} us  best {best:8.1f}",
              flush=True)
        result["us_per_frame"][f"{c}:{name}"] = {"median": med, "best": best}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
