#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ffmpeg_tpu_torch) on one NVIDIA GPU.

Drives the port's flagship path, 1080p MJPEG decoded and scaled to
224x224 rgb24, through its user entry point (MjpegTpuEntropyPipeline:
prep_frame, run_batch) at full size: the committed 8-frame 1920x1080
fixture, batch 8, bicubic.  Phases, one line each:

1. the device: CUDA must be available; the card's name and power limit
   as nvidia-smi reports them;
2. K1 (csrc/jpeg_huffman.cu) built from the checkout's source, timed;
3. K1 against its plain PyTorch version on the card over the whole batch,
   bit-exact int16 coefficients; frame 0 against the C++ host decoder
   (ffmpeg_tpu.native mjpeg_decode_scan), bit-exact;
4. the pipeline against the committed output of the JAX reference:
   max |diff| <= 1, at most 1% of samples differing, PSNR >= 60 dB, and
   K1 launched by the run;
5. frames/s over 30 batches timed with CUDA events, host-to-device copy
   included; a breakdown of one batch; K1 against its plain version at
   the flagship shape.

Then a JSON line with each kernel's launches, error and time, and as the
last line {"ok": true, "device": {...}}.  Any failed phase raises and
the script exits non-zero without that line.

Usage (from the repository root, one card):

    python3 chip_smoke.py
"""

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
TIMED_BATCHES = 30
K1_SOURCE = "ffmpeg_tpu_torch/csrc/jpeg_huffman.cu"
K1_REPLACES = "ffmpeg_tpu/ops/huffman.py:446"


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of fn() over reps calls, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import numpy as np
    from ffmpeg_tpu_torch import _cuda_build
    from ffmpeg_tpu_torch.io.mjpeg import split_packets
    from ffmpeg_tpu_torch.testing import (BATCH, FIXTURE, GOLDEN, H, OUT,
                                          STRIDE, W, host_decode, packed_cap)
    from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
        MjpegTpuEntropyPipeline, TpuEntropySpec)
    from ffmpeg_tpu_torch.ops import huffman

    # 1. device
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"phase 1 device: {card} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible)",
          flush=True)

    # 2. build K1 from the checkout's source
    t = time.monotonic()
    _cuda_build.build(_cuda_build.so_path())
    _cuda_build.get()
    print(f"phase 2 build: {K1_SOURCE} -> sm_90a in "
          f"{time.monotonic() - t:.3f} s", flush=True)

    # 3. K1 against its plain version, and frame 0 against the host decoder
    pkts = split_packets(FIXTURE.read_bytes())
    if len(pkts) != BATCH:
        raise RuntimeError(f"fixture has {len(pkts)} frames, not {BATCH}")
    spec = TpuEntropySpec(W, H, OUT, OUT, batch=BATCH, stride=STRIDE,
                          packed_cap=packed_cap(pkts))
    pipe = MjpegTpuEntropyPipeline(spec, max(pkts, key=len), device=dev)
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    regions = torch.from_numpy(pipe.regions).to(dev)
    lens, luts = pipe.program.split_regions(regions)
    got = huffman.jpeg_scan_decode_packed(regions, lens, luts, pipe.hdr)
    want = huffman.decode_packed_plain(regions, lens, luts, pipe.hdr)
    torch.cuda.synchronize()
    k1_err = int((got.int() - want.int()).abs().max())
    if got.shape != (BATCH, pipe.nmcu, 6, 64) or not torch.equal(got, want):
        raise RuntimeError(f"K1 differs from its plain version: max |diff| "
                           f"{k1_err}, {int((got != want).sum())} values")
    host0 = host_decode(pkts[0])
    if not np.array_equal(got[0].cpu().numpy(), host0):
        raise RuntimeError("K1 frame 0 differs from the C++ host decoder")
    print(f"phase 3 K1: {BATCH}x{pipe.nmcu} lanes bit-exact against the "
          f"plain version (max |diff| {k1_err}); frame 0 bit-exact against "
          f"mjpeg_decode_scan; {int((got != 0).sum())} nonzero "
          f"coefficients", flush=True)

    # 4. the main path, through the pipeline's entry points, against the
    #    JAX reference's committed output
    gold = np.load(GOLDEN)["planes"]
    huffman.KERNEL_LAUNCHES = 0
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    comps = pipe.run_batch()
    torch.cuda.synchronize()
    launches = huffman.KERNEL_LAUNCHES
    out = np.stack([c.cpu().numpy() for c in comps])
    if out.shape != gold.shape or out.dtype != np.uint8:
        raise RuntimeError(f"output {out.shape} {out.dtype}, golden "
                           f"{gold.shape} {gold.dtype}")
    diff = np.abs(out.astype(np.int32) - gold.astype(np.int32))
    frac = float((diff > 0).mean())
    mse = float((diff.astype(np.float64) ** 2).mean())
    psnr = 10 * np.log10(255 ** 2 / max(mse, 1e-12))
    print(f"phase 4 pipeline: {out.shape} uint8 vs JAX golden: max |diff| "
          f"{int(diff.max())}, {frac:.6%} of samples differ, PSNR "
          f"{psnr:.2f} dB; K1 launches {launches}", flush=True)
    if diff.max() > 1 or frac > 0.01 or psnr < 60 or launches < 1:
        raise RuntimeError("pipeline output outside its tolerance "
                           "(max 1 LSB, <= 1% differ, >= 60 dB) or K1 "
                           "not launched")

    # 5. timing (CUDA events; the h2d copy from pinned memory included)
    batch_ms = cuda_ms(pipe.run_batch, TIMED_BATCHES)
    fps = BATCH * 1e3 / batch_ms
    h2d_ms = cuda_ms(lambda: pipe._host.to(dev, non_blocking=True), 20)
    prog_ms = cuda_ms(lambda: pipe.program(regions), 20)
    k1_ms = cuda_ms(lambda: huffman.jpeg_scan_decode_packed(
        regions, lens, luts, pipe.hdr), 20)
    plain_ms = cuda_ms(lambda: huffman.decode_packed_plain(
        regions, lens, luts, pipe.hdr), 3)
    t = time.perf_counter()
    for _ in range(3):
        for i, p in enumerate(pkts):
            pipe.prep_frame(p, i)
    prep_ms = (time.perf_counter() - t) * 1e3 / (3 * BATCH)
    print(f"phase 5 timing [{card}]: {fps:.2f} frames/s over "
          f"{TIMED_BATCHES} batches of {BATCH} ({batch_ms:.3f} ms/batch, "
          f"h2d included); one batch: h2d {h2d_ms:.3f} ms, program "
          f"{prog_ms:.3f} ms, of which K1 {k1_ms:.3f} ms (plain version "
          f"{plain_ms:.3f} ms); host prep {prep_ms:.3f} ms/frame "
          f"(one CPU thread, not in frames/s)", flush=True)

    print(json.dumps({"kernels": [{
        "name": "jpeg_scan_decode_packed", "route": "cuda",
        "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches, "max_abs_err": k1_err,
        "ms": k1_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
