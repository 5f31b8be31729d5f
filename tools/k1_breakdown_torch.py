#!/usr/bin/env python3
"""Where K1's time goes, on one GPU: the port's JPEG Huffman kernel
(ffmpeg_tpu_torch/csrc/jpeg_huffman.cu) taken apart on the flagship batch.

Builds variants of the kernel's source by text substitution, each into
build/k1_breakdown/ (never into the source tree), and times each on the
committed 8-frame 1920x1080 fixture, batch 8:

- full: the kernel as it is (checked bit-exact against the plain version);
- walk only: the bit walk, with no coefficient list and no output;
- walk + list: the walk and the per-lane coefficient lists, no output;
- write-out only: no walk, every row written (as zeros) by its warp;
- staging only: the CTA's bytes and tables staged, nothing else.

Each time is `kernel_ms` (ffmpeg_tpu_torch/timing.py, as chip_smoke.py
times K1): the mean of 20 back-to-back launches by CUDA events, with the
card spinning first while the host queues them, three repeats each.
The variants are cut from the source at fixed lines of the kernel; the
tool raises if one of those lines is not found.  Prints one line per variant
and a JSON line; `--sass FILE` also writes the SASS of the port's
kernel library (K1 and K2) to FILE.

Usage (from the repository root, one card):

    python3 tools/k1_breakdown_torch.py [--sass FILE]
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT_DIR = REPO / "build" / "k1_breakdown"

PUT = ("        em.put((is_dc || sz > 0) && pos < 64 && coef != 0, "
       "blk * 64 + pos,\n               coef);")
NO_PUT = "        em.n += coef & 1;"
ROWS = "    for (int r = 0; r < 32; ++r) {"
NO_ROWS = "    if (sh.count[t] == 12345) out[0] = 1;\n    for (int r = 0; r < 0; ++r) {"
NBLK = "                    lens[li] > 0 ? kBlocksPerSeg : 0, em, max_iter);"


def variants(src: str) -> dict:
    for anchor in (PUT, ROWS, NBLK):
        if anchor not in src:
            raise RuntimeError(f"anchor not in the kernel source: {anchor!r}")
    no_walk = src.replace(NBLK, "                    0, em, max_iter);")
    return {
        "full": src,
        "walk only": src.replace(PUT, NO_PUT).replace(ROWS, NO_ROWS),
        "walk + list": src.replace(ROWS, NO_ROWS),
        "write-out only": no_walk,
        "staging only": no_walk.replace(ROWS, NO_ROWS),
    }


def build(vs: dict) -> dict:
    from ffmpeg_tpu_torch import _cuda_build
    nvcc = _cuda_build._nvcc()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(vs.items()):
        cu = OUT_DIR / f"v{i}.cu"
        cu.write_text(text)
        so = OUT_DIR / f"v{i}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_cuda_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out = p.communicate(timeout=600)[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out[-3000:]}")
        lib = ctypes.CDLL(str(so))
        fn = lib.jpeg_scan_decode_packed_launch
        ref = _cuda_build.get().jpeg_scan_decode_packed_launch
        fn.restype, fn.argtypes = ref.restype, ref.argtypes
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", metavar="FILE")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_breakdown: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from ffmpeg_tpu_torch.io.mjpeg import split_packets
    from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
        MjpegTpuEntropyPipeline, TpuEntropySpec)
    from ffmpeg_tpu_torch.ops import huffman
    from ffmpeg_tpu_torch.testing import (BATCH, FIXTURE, H, OUT, STRIDE, W,
                                          packed_cap)
    from ffmpeg_tpu_torch.timing import kernel_ms
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    src = (REPO / "ffmpeg_tpu_torch" / "csrc" / "jpeg_huffman.cu").read_text()
    libs = build(variants(src))

    dev = torch.device("cuda", 0)
    pkts = split_packets(FIXTURE.read_bytes())
    spec = TpuEntropySpec(W, H, OUT, OUT, batch=BATCH, stride=STRIDE,
                          packed_cap=packed_cap(pkts))
    pipe = MjpegTpuEntropyPipeline(spec, max(pkts, key=len), device=dev)
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    regions = torch.from_numpy(pipe.regions).to(dev)
    lens, luts = pipe.program.split_regions(regions)
    B, cap = regions.shape
    nmcu = lens.shape[1]
    out = torch.empty((B, nmcu, 6, 64), dtype=torch.int16, device=dev)
    want = huffman.decode_packed_plain(regions, lens, luts, pipe.hdr)
    stream = torch.cuda.current_stream().cuda_stream

    res = {}
    for name, lib in libs.items():
        def go(lib=lib):
            code = lib.jpeg_scan_decode_packed_launch(
                regions.data_ptr(), cap, lens.data_ptr(), pipe.hdr,
                luts.data_ptr(), luts.stride(0), out.data_ptr(), B, nmcu,
                huffman.MAX_ITER, stream)
            if code:
                raise RuntimeError(f"{name}: CUDA error {code}")
        go()
        torch.cuda.synchronize()
        if name == "full" and not torch.equal(out, want):
            raise RuntimeError("the full variant differs from the plain "
                               "version")
        res[name] = [kernel_ms(go, 20) for _ in range(3)]
        print(f"K1 breakdown [{card}] {name}: "
              f"{', '.join(f'{x:.4f}' for x in res[name])} ms", flush=True)
    if args.sass:
        from ffmpeg_tpu_torch import _cuda_build
        dump = subprocess.run(
            [str(Path(_cuda_build._nvcc()).parent / "cuobjdump"), "-sass",
             str(_cuda_build.so_path())], capture_output=True, text=True)
        Path(args.sass).write_text(dump.stdout)
    print(json.dumps({"card": card, "k1_breakdown_ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
