#!/usr/bin/env python
"""Write the VP9 fixtures of the PyTorch port from the JAX reference.

1. tests/data/port/vp9_1080p_100_golden.npz: for every frame of
   tests/data/bench/vp9_1080p_100.ivf (100 frames, 1920x1080), the
   sha256 of each cropped y/u/v plane, and the full planes of frames
   0-2 (frames 1-2 as differences from the frame before).  The
   reference decodes with VP9Decoder and {"native": True} (its C++
   parse, its jitted reconstruction, its host loop filter); frame 0 is
   cross-checked against its pure host decode (the Python walker).
2. tests/data/port/vp9_1080p_lf.ivf: a 1920x1080 stream with the loop
   filter on, crafted with the test suite's encode-direction walker as
   tools/gen_vp9_bench_stream.py crafts the bench stream: a keyframe at
   filter_level 32, sharpness 0, then inter frames at 48/3 and 48/0;
   tests/data/port/vp9_crafted_96x72.ivf, a small stream (a keyframe and
   three inter frames, partial superblocks, compound prediction, the
   loop filter on) for the checks that run where the crafting helpers
   cannot (no JAX); and tests/data/port/vp9_lf_golden.npz, the sha256 of
   each cropped plane of the reference's host decode of both,
   cross-checked against its native decode.

Usage (from the repository root; JAX on the CPU; the committed files
were written at the backend's optimisation level 0, and the programs
are integer-exact at any level; the bench golden compiles a program
for most frames, about 25 s each on one CPU):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_backend_optimization_level=0 \
        python tools/gen_torch_vp9_fixture.py [bench] [lf]
"""

import hashlib
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import numpy as np  # noqa: E402

BENCH = REPO / "tests" / "data" / "bench" / "vp9_1080p_100.ivf"
PORT = REPO / "tests" / "data" / "port"
GOLDEN = PORT / "vp9_1080p_100_golden.npz"
LF_STREAM = PORT / "vp9_1080p_lf.ivf"
SMALL_STREAM = PORT / "vp9_crafted_96x72.ivf"
LF_GOLDEN = PORT / "vp9_lf_golden.npz"
FULL_FRAMES = 3


def plane_hashes(frame) -> list:
    return [hashlib.sha256(np.ascontiguousarray(np.asarray(p)).tobytes())
            .hexdigest() for p in frame.planes]


def _bound_compiled_programs(keep=4):
    """The reference's native path compiles one program per frame shape
    (recon_tpu._build_program, an lru_cache of 64); holding dozens of
    1080p programs exhausts the host's memory, so drop them past `keep`."""
    import jax
    from ffmpeg_tpu.codecs.vp9 import recon_tpu
    if recon_tpu._build_program.cache_info().currsize > keep:
        recon_tpu._build_program.cache_clear()
        jax.clear_caches()


def decode(packets, opts):
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.io.stream import CodecParameters, MediaType
    from ffmpeg_tpu.utils.error import TryAgain
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="vp9")
    d = CodecContext.open_decoder(par, options=opts)
    out = []
    t = time.monotonic()
    for i, p in enumerate(packets):
        d.send_packet(p)
        _bound_compiled_programs()
        while True:
            try:
                out.append(d.receive_frame())
            except TryAgain:
                break
        if (i + 1) % 10 == 0:
            print(f"  {i + 1}/{len(packets)} packets, "
                  f"{time.monotonic() - t:.0f} s", flush=True)
    return out


def ivf_packets(path):
    from ffmpeg_tpu.io.avio import open_read
    from ffmpeg_tpu.io.formats.ivf import IvfDemuxer
    from ffmpeg_tpu.utils.error import EndOfStream
    dmx = IvfDemuxer(open_read(str(path)))
    dmx.read_header()
    pkts = []
    while True:
        try:
            pkts.append(dmx.read_packet())
        except EndOfStream:
            return pkts


def bench_golden():
    pkts = ivf_packets(BENCH)
    t = time.monotonic()
    frames = decode(pkts, {"native": True})
    print(f"native decode of {len(pkts)} packets: {len(frames)} frames, "
          f"{time.monotonic() - t:.1f} s", flush=True)
    t = time.monotonic()
    host0 = decode(pkts[:1], {})[0]
    print(f"host decode of frame 0: {time.monotonic() - t:.1f} s",
          flush=True)
    for a, b in zip(frames[0].planes, host0.planes):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise SystemExit("frame 0: native decode differs from the "
                             "host decode")
    write_golden(np.array([plane_hashes(f) for f in frames]),
                 np.array([f.key_frame for f in frames]),
                 [[np.asarray(p) for p in frames[i].planes]
                  for i in range(FULL_FRAMES)])


def write_golden(hashes, keyframe, planes):
    """The bench golden: per-frame hashes, keyframe flags, and the full
    planes of the first frames, frame i > 0 stored as its difference
    from frame i - 1 modulo 256 (ffmpeg_tpu_torch.testing.vp9_golden_planes
    undoes it), which keeps the file near 2.6 MB."""
    out = {"hashes": hashes, "keyframe": keyframe}
    for i, cur in enumerate(planes):
        for name, p, q in zip("yuv", cur, planes[i - 1] if i else cur):
            out[f"{name}{i}"] = (p - q if i else p).astype(np.uint8)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)", flush=True)


def _craft(width, height, seed, key_kw, inter_kws, **plan_kw):
    import test_vp9 as K
    import test_vp9_inter as I
    rng = np.random.default_rng(seed)
    s = I.CraftSession(width=width, height=height)
    s.key(K.Plan(rng, **plan_kw.get("key", {})), **key_kw)
    for kw in inter_kws:
        s.inter(I.InterPlan(rng, **plan_kw.get("inter", {})), **kw)
    return s.frames


def _golden_hashes(path):
    pkts = ivf_packets(path)
    host = decode(pkts, {})
    nat = decode(pkts, {"native": True})
    for i, (a, b) in enumerate(zip(host, nat)):
        if plane_hashes(a) != plane_hashes(b):
            raise SystemExit(f"{path.name} frame {i}: native differs from "
                             f"host")
    return np.array([plane_hashes(f) for f in host])


def lf_streams():
    from gen_vp9_bench_stream import ivf_wrap
    t = time.monotonic()
    frames = _craft(
        1920, 1080, 32, {"filter_level": 32, "sharpness": 0},
        [{"filter_level": 48, "sharpness": 3},
         {"filter_level": 48, "sharpness": 0}],
        key={"split_p": 0.03, "skip_p": 0.75, "maxn": 3, "amp": 30},
        inter={"inter_p": 0.97, "newmv_p": 0.25, "mv_amp": 40,
               "skip_p": 0.8, "split_p": 0.03, "maxn": 2, "amp": 24})
    LF_STREAM.write_bytes(ivf_wrap(frames, 1920, 1080))
    print(f"wrote {LF_STREAM} ({LF_STREAM.stat().st_size} bytes) in "
          f"{time.monotonic() - t:.1f} s", flush=True)
    frames = _craft(
        96, 72, 9, {"filter_level": 24},
        [{"filter_level": 36, "sharpness": 3, "signbias": (0, 0, 1)},
         {"filter_level": 20, "hp": True},
         {"filter_level": 44, "sharpness": 5, "filtermode": 3}],
        inter={"comp_p": 0.3})
    SMALL_STREAM.write_bytes(ivf_wrap(frames, 96, 72))
    print(f"wrote {SMALL_STREAM} ({SMALL_STREAM.stat().st_size} bytes)",
          flush=True)
    t = time.monotonic()
    np.savez_compressed(LF_GOLDEN, lf=_golden_hashes(LF_STREAM),
                        small=_golden_hashes(SMALL_STREAM))
    print(f"wrote {LF_GOLDEN} in {time.monotonic() - t:.1f} s", flush=True)


def main():
    t = time.monotonic()
    which = sys.argv[1:] or ["bench", "lf"]
    if "bench" in which:
        bench_golden()
    if "lf" in which:
        lf_streams()
    print(f"done in {time.monotonic() - t:.1f} s")


if __name__ == "__main__":
    main()
