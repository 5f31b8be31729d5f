#!/usr/bin/env python3
"""The port's two VP9 decode paths in turns on one card: the per-frame
path (CodecContext.open_decoder("vp9"): parse, argument build, DPB
upload, reconstruction, d2h and host loop filter per frame) and the
windowed decoder (models/vp9_tpu.py Vp9TpuDecoder: the whole window
parsed and built, then per frame the reconstruction against the DPB kept
on the card), over the committed 100-frame 1920x1080 bench stream, in
the order per-frame, window, window, per-frame (the second window with
emit_planes=False), after a warm decode of frames 0-1 by each.

Prints the card's name and power limit, then one line per run: frames/s
(wall); for the per-frame path the keyframe's time and the inter frames'
times (median, mean of the first and of the last 10); for the window the
split its `stats` dict gives (parse, build and the device loop, ms a
frame).  Host-timed: compare the runs of one call only.

Usage (from the repository root, one card):

    python3 tools/vp9_window_ab_torch.py
"""

import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _summary(times):
    inter = times[1:]
    return (f"keyframe {times[0]:.0f} ms; inter median "
            f"{statistics.median(inter):.1f} ms, frames 1-10 mean "
            f"{statistics.mean(inter[:10]):.1f}, last 10 mean "
            f"{statistics.mean(inter[-10:]):.1f}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("vp9_window_ab_torch: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.io.ivf import read_ivf
    from ffmpeg_tpu_torch.models.vp9_tpu import Vp9TpuDecoder
    from ffmpeg_tpu_torch.testing import VP9_BENCH, vp9_decode
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    par, _tb, pkts = read_ivf(VP9_BENCH.read_bytes())
    data = [p.data for p in pkts]
    vp9_decode(pkts[:2], dev)
    Vp9TpuDecoder(dev).decode(data[:2])

    def per_frame():
        dec = CodecContext.open_decoder(par, device=dev)
        times = []
        t0 = time.perf_counter()
        for p in pkts:
            t = time.perf_counter()
            dec.send_packet(p)
            dec.receive_frame()
            times.append((time.perf_counter() - t) * 1e3)
        wall = time.perf_counter() - t0
        print(f"per-frame [{card}]: {len(pkts) / wall:.3f} frames/s; "
              f"{_summary(times)}", flush=True)

    def window(emit):
        st = {}
        t = time.perf_counter()
        Vp9TpuDecoder(dev).decode(data, emit_planes=emit, stats=st)
        wall = time.perf_counter() - t
        n = st["frames"]
        print(f"window, emit_planes={emit} [{card}]: {n / wall:.3f} "
              f"frames/s; parse {st['parse_s'] / n * 1e3:.2f}, build "
              f"{st['build_s'] / n * 1e3:.2f}, device loop "
              f"{st['device_s'] / n * 1e3:.2f} ms a frame", flush=True)

    per_frame()
    window(True)
    window(False)
    per_frame()
    return 0


if __name__ == "__main__":
    sys.exit(main())
