#!/usr/bin/env python3
"""K1 and K2 of several checkouts of the port, timed by the same code on
one GPU.

For each checkout given (a directory that holds `ffmpeg_tpu_torch/`, for
example `git archive` of another commit unpacked under `build/`), in the
order given, a child process imports that checkout's package, builds its
kernels, checks each kernel bit-exact against that checkout's plain
version, and times it through its entry point:

- K1, `ops.huffman.jpeg_scan_decode_packed`, on the flagship batch (the
  committed 8-frame 1920x1080 fixture, batch 8);
- K2, `ops.me.sad_cost_volume_strip`, at 1088x1920, B=16, R=8, on the
  padded luma of `mpeg2_clip` frames 1 and 0, as uint8 (the encoders'
  samples) and as float32.

Every checkout is timed by this checkout's `ffmpeg_tpu_torch/timing.py`,
loaded by path, with both of its timers: `kernel_ms` (the card spins
while the host queues the calls) and `cuda_ms` (no spin), 20 calls each,
three repeats.  Give the checkouts in turns (A B B A) to see the spread.

`--rate` also measures, with a probe kernel built into `build/rate_probe/`,
how many VABSDIFF4 (PTX `vabsdiff4.add`, K2's instruction) and IDP4A the
card issues per SM per clock, against FFMA, whose rate is published
(128 per clock per SM): the probe's FFMA rate gives the clock it ran at.

Prints one line per checkout and, last, one JSON object.

Usage (from the repository root, one card):

    python3 tools/kernel_ab_torch.py [--rate] DIR [DIR ...]
"""

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
REPS, REPEATS = 20, 3
FFMA_PER_CLK_SM = 128            # NVIDIA H100 SXM, published
SMS = 132

PROBE = r"""
#include <cstdint>
#include <cuda_runtime.h>

// 8 independent accumulator chains per thread, one instruction each per
// step: the issue rate, not a chain's latency, sets the time.
template <int OP>
__global__ void probe(uint32_t* out, int iters, uint32_t seed) {
    uint32_t a[8];
    for (int k = 0; k < 8; ++k)
        a[k] = seed + threadIdx.x * 8 + k;
    const uint32_t b = seed ^ 0x5a5a5a5au, c = seed * 2654435761u;
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            if (OP == 0)
                asm volatile("vabsdiff4.u32.u32.u32.add %0, %1, %2, %0;"
                             : "+r"(a[k]) : "r"(b), "r"(c ^ k));
            else
                asm volatile("dp4a.u32.u32 %0, %1, %2, %0;"
                             : "+r"(a[k]) : "r"(b), "r"(c ^ k));
        }
    }
    uint32_t x = 0;
    for (int k = 0; k < 8; ++k)
        x ^= a[k];
    out[blockIdx.x * blockDim.x + threadIdx.x] = x;
}

__global__ void probe_ffma(uint32_t* out, int iters, uint32_t seed) {
    float a[8];
    for (int k = 0; k < 8; ++k)
        a[k] = 1e-3f * (float)(seed + threadIdx.x * 8 + k);
    const float b = 0.999f, c = 1e-4f * (float)seed;
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
            asm volatile("fma.rn.f32 %0, %0, %1, %2;"
                         : "+f"(a[k]) : "f"(b), "f"(c));
    }
    uint32_t x = 0;
    for (int k = 0; k < 8; ++k)
        x ^= __float_as_uint(a[k]);
    out[blockIdx.x * blockDim.x + threadIdx.x] = x;
}

extern "C" int probe_launch(int op, void* out, int blocks, int threads,
                            int iters, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    uint32_t* o = (uint32_t*)out;
    if (op == 0)
        probe<0><<<blocks, threads, 0, s>>>(o, iters, 7u);
    else if (op == 1)
        probe<1><<<blocks, threads, 0, s>>>(o, iters, 7u);
    else
        probe_ffma<<<blocks, threads, 0, s>>>(o, iters, 7u);
    return (int)cudaGetLastError();
}
"""


def _timing():
    """This checkout's timers, loaded by path (not through the package,
    which in a child is another checkout's)."""
    spec = importlib.util.spec_from_file_location(
        "_ab_timing", REPO / "ffmpeg_tpu_torch" / "timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60
                          ).stdout.strip().splitlines()[0]


def one(root: Path) -> dict:
    """Check and time the kernels of the checkout at root (child)."""
    import numpy as np
    import torch
    timing = _timing()
    sys.path.insert(0, str(root))
    import ffmpeg_tpu_torch
    if Path(ffmpeg_tpu_torch.__file__).resolve().parent.parent != root:
        raise RuntimeError(f"imported {ffmpeg_tpu_torch.__file__}, not the "
                           f"package under {root}")
    from ffmpeg_tpu_torch.codecs.mpeg12_enc import _pad
    from ffmpeg_tpu_torch.io.mjpeg import split_packets
    from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
        MjpegTpuEntropyPipeline, TpuEntropySpec)
    from ffmpeg_tpu_torch.ops import huffman, me
    from ffmpeg_tpu_torch.testing import (BATCH, FIXTURE, H, OUT, STRIDE, W,
                                          mpeg2_clip, packed_cap)
    dev = torch.device("cuda", 0)
    pkts = split_packets(FIXTURE.read_bytes())
    spec = TpuEntropySpec(W, H, OUT, OUT, batch=BATCH, stride=STRIDE,
                          packed_cap=packed_cap(pkts))
    pipe = MjpegTpuEntropyPipeline(spec, max(pkts, key=len), device=dev)
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    regions = torch.from_numpy(pipe.regions).to(dev)
    lens, luts = pipe.program.split_regions(regions)
    luma = [_pad(np.asarray(f.planes[0]), 1088, 1920)
            for f in mpeg2_clip(2, 1920, 1080)]
    u8 = [torch.from_numpy(a).to(dev) for a in (luma[1], luma[0])]
    f32 = [t.float() for t in u8]
    calls = {
        "K1": (lambda: huffman.jpeg_scan_decode_packed(
                   regions, lens, luts, pipe.hdr),
               lambda: huffman.decode_packed_plain(
                   regions, lens, luts, pipe.hdr)),
        "K2 uint8": (lambda: me.sad_cost_volume_strip(*u8, 16, 8),
                     lambda: me.sad_cost_volume_strip_plain(*u8, 16, 8)),
        "K2 float32": (lambda: me.sad_cost_volume_strip(*f32, 16, 8),
                       lambda: me.sad_cost_volume_strip_plain(*f32, 16, 8)),
    }
    res = {}
    for name, (fn, plain) in calls.items():
        got, want = fn(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"{root}: {name} differs from its plain "
                               f"version")
        res[name] = {
            "kernel_ms": [timing.kernel_ms(fn, REPS) for _ in range(REPEATS)],
            "cuda_ms": [timing.cuda_ms(fn, REPS) for _ in range(REPEATS)]}
    return res


def rate_probe(timing) -> dict:
    """Per SM per clock issue rates of VABSDIFF4 and IDP4A, by FFMA."""
    import torch
    sys.path.insert(0, str(REPO))
    from ffmpeg_tpu_torch import _cuda_build
    d = REPO / "build" / "rate_probe"
    d.mkdir(parents=True, exist_ok=True)
    (d / "probe.cu").write_text(PROBE)
    so = d / "probe.so"
    nvcc = _cuda_build._nvcc()
    subprocess.run([nvcc, *_cuda_build.NVCC_FLAGS, "-shared", "-o", str(so),
                    str(d / "probe.cu")], check=True, capture_output=True,
                   timeout=600)
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(so)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    lib = ctypes.CDLL(str(so))
    lib.probe_launch.restype = ctypes.c_int
    lib.probe_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    blocks, threads, iters = SMS * 16, 256, 4096
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    per_s = {}
    for op, name in enumerate(("VABSDIFF4", "IDP4A", "FFMA")):
        def go(op=op):
            code = lib.probe_launch(op, out.data_ptr(), blocks, threads,
                                    iters, stream)
            if code:
                raise RuntimeError(f"probe {name}: CUDA error {code}")
        ms = min(timing.cuda_ms(go, 5) for _ in range(REPEATS))
        per_s[name] = blocks * threads * iters * 8 / (ms / 1e3)
    clk = per_s["FFMA"] / (SMS * FFMA_PER_CLK_SM)
    return {"sass_count": {n: sass.count(n) for n in
                           ("VABSDIFF4", "IDP.4A", "FFMA")},
            "per_s": per_s, "clock_hz_by_ffma": clk,
            "per_sm_per_clk": {n: v / (SMS * clk) for n, v in per_s.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--rate", action="store_true")
    ap.add_argument("roots", nargs="*")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if args.one:
        print(json.dumps(one(Path(args.one).resolve())))
        return 0
    card = card_line()
    runs = []
    for root in args.roots:
        root = Path(root).resolve()
        if not (root / "ffmpeg_tpu_torch").is_dir():
            raise SystemExit(f"{root} holds no ffmpeg_tpu_torch/")
        r = subprocess.run([sys.executable, __file__, "--one", str(root)],
                           capture_output=True, text=True, timeout=900)
        if r.returncode:
            raise RuntimeError(f"{root}: exit {r.returncode}\n"
                               f"{r.stderr[-4000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        runs.append({"root": str(root), **res})
        print(f"[{card}] {root.name}: " + "; ".join(
            f"{k} kernel_ms {', '.join(f'{x:.4f}' for x in v['kernel_ms'])}"
            f" cuda_ms {', '.join(f'{x:.4f}' for x in v['cuda_ms'])}"
            for k, v in res.items()), flush=True)
    summary = {"card": card, "runs": runs}
    if args.rate:
        summary["rate"] = rate_probe(_timing())
        print(f"[{card}] rate probe: {summary['rate']}", flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
