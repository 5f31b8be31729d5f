#!/usr/bin/env python
"""Write the H.264 fixtures of the PyTorch port from the JAX reference.

1. tests/data/port/h264_1080p_cabac.h264: three pictures at 1920x1088
   (120x68 macroblocks; the crafting helpers write no cropping, so the
   decoded frames are 1088 rows high), each one CABAC slice with the
   deblocking filter on, crafted with the test suite's encode-direction
   writers from fixed seeds, as tests/test_h264_cabac.py
   test_cabac_b_gop_exact composes them: an IDR I picture
   (craft_cabac_i), a P picture (craft_cabac_p, frame_num 1, POC lsb 4)
   and a B picture between them in output order (craft_cabac_b,
   frame_num 2, POC lsb 2).
2. tests/data/port/h264_crafted_small.h264: a small CAVLC + CABAC stream
   at 64x48 for the checks that run where the crafting helpers cannot
   (no JAX): I_4x4, I_PCM and I_16x16 IDR pictures, P and B pictures
   over two references, P pictures with two active references and the
   deblocking filter, and a CABAC I + P pair with the filter on.
3. tests/data/port/h264_1080p_golden.npz: the sha256 of every y/u/v
   plane of the reference's default decode (H264Decoder with no options:
   the host reconstruction, concealment and deblocking; the oracle of
   the port's tests) of the 1080p stream (`cabac_1080p`, shape (3, 3)),
   of the small stream (`small`) and of the truncated-slice stream of
   tests/test_h264_highfeat.py test_error_concealment_truncated_slice
   (`truncated`, an I_16x16 IDR and a P picture cut to 60% of its
   bytes), in output order; and that stream's bytes
   (`truncated_stream`, uint8).

Usage (from the repository root; the reference's host decode takes
about 5.7 ms a macroblock on one CPU, so the three 1080p pictures take
minutes: about 3 minutes in all, 16 s of it crafting the 1080p stream
and 144 s its reference decode):

    JAX_PLATFORMS=cpu python tools/gen_torch_h264_fixture.py
"""

import hashlib
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import numpy as np  # noqa: E402

PORT = REPO / "tests" / "data" / "port"
CABAC_STREAM = PORT / "h264_1080p_cabac.h264"
SMALL_STREAM = PORT / "h264_crafted_small.h264"
GOLDEN = PORT / "h264_1080p_golden.npz"
MB_W, MB_H = 120, 68
SEEDS = (41, 51, 61)          # I, P, B (test_cabac_b_gop_exact, seed 1)


def plane_hashes(frame) -> list:
    return [hashlib.sha256(np.ascontiguousarray(np.asarray(p)).tobytes())
            .hexdigest() for p in frame.planes]


def reference_decode(stream: bytes) -> list:
    """The reference's default decoder (the oracle of the port's
    tests), drained."""
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.core.packet import Packet
    from ffmpeg_tpu.io.stream import CodecParameters, MediaType
    from ffmpeg_tpu.utils.rational import Rational
    d = CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="h264"))
    return d.decode_all([Packet(data=stream, pts=0,
                                time_base=Rational(1, 25))])


def craft_cabac_1080p() -> bytes:
    import test_h264_cabac as C
    i, p, b = SEEDS
    return (C.craft_cabac_i(mb_w=MB_W, mb_h=MB_H, seed=i, deblock=True)
            + C.craft_cabac_p(mb_w=MB_W, mb_h=MB_H, frame_num=1, seed=p,
                              deblock=True, poc_lsb=4)
            + C.craft_cabac_b(mb_w=MB_W, mb_h=MB_H, frame_num=2,
                              poc_lsb=2, seed=b, deblock=True))


def with_refs(n, build):
    """build() with test_h264's SPS writer declaring n reference
    frames (the composition of the reference's multi-reference tests)."""
    import test_h264 as H
    orig = H.make_sps
    H.make_sps = lambda mb_w=4, mb_h=3: orig(mb_w, mb_h, num_ref=n)
    try:
        return build()
    finally:
        H.make_sps = orig


def craft_small() -> bytes:
    import test_h264 as H
    import test_h264_cabac as C
    s = H.craft_i4x4(mb_w=4, mb_h=3, seed=11)
    s += H.craft_ipcm(mb_w=4, mb_h=3, seed=2)
    s += with_refs(2, lambda: H.craft_i16x16_residual(seed=9))
    s += H.craft_p_frame_poc(1, 4, seed=29)
    s += H.craft_b_frame(frame_num=2, poc_lsb=2, seed=49)
    s += with_refs(2, lambda: H.craft_i16x16_residual(seed=3))
    s += H.craft_p_frame(frame_num=1, seed=81)
    s += H.craft_p_frame(frame_num=2, seed=91, num_ref=2)
    s += H.craft_p_frame(frame_num=3, seed=96, num_ref=2, deblock=True)
    s += C.craft_cabac_i(seed=3, deblock=True)
    s += C.craft_cabac_p(frame_num=1, seed=4, deblock=True)
    return s


def truncated_stream() -> bytes:
    """tests/test_h264_highfeat.py test_error_concealment_truncated_slice:
    the last 40% of the P picture's bytes cut."""
    import test_h264_highfeat as HF
    p_full = HF._craft_p(1, seed=61)
    return HF._i_frame(5) + p_full[:len(p_full) - int(len(p_full) * 0.4)]


def main():
    t0 = time.time()
    if not CABAC_STREAM.exists():
        CABAC_STREAM.write_bytes(craft_cabac_1080p())
        print(f"crafted {CABAC_STREAM.name}: {CABAC_STREAM.stat().st_size} "
              f"B in {time.time() - t0:.1f} s", flush=True)
    if not SMALL_STREAM.exists():
        SMALL_STREAM.write_bytes(craft_small())
    trunc = truncated_stream()
    out = {}
    for key, data in (("small", SMALL_STREAM.read_bytes()),
                      ("truncated", trunc),
                      ("cabac_1080p", CABAC_STREAM.read_bytes())):
        t = time.time()
        frames = reference_decode(data)
        out[key] = np.array([plane_hashes(f) for f in frames])
        print(f"{key}: {len(frames)} frames, {frames[0].width}x"
              f"{frames[0].height}, reference host decode "
              f"{time.time() - t:.1f} s", flush=True)
    out["truncated_stream"] = np.frombuffer(trunc, np.uint8)
    np.savez(GOLDEN, **out)
    print(f"wrote {GOLDEN.name} ({GOLDEN.stat().st_size} B) in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
