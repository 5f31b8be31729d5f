#!/usr/bin/env python
"""Write the HEVC fixtures of the PyTorch port from the JAX reference.

1. tests/data/port/hevc_1080p_sao_deblock.hevc: an IDR and one P frame
   at 1920x1080 (CTB 32, 8 bits) with SAO and the deblocking filter on,
   crafted with the test suite's encode-direction walker
   (tests/test_hevc.py craft_gop) from a fixed seed: the bench stream
   (tests/data/bench/hevc_1080p.hevc) has both filters off.
   tests/data/port/hevc_crafted_64x64.hevc: a small stream (an IDR, then
   P and B frames with reordering, SAO and deblocking) for the checks
   that run where the crafting helpers cannot (no JAX).
2. tests/data/port/hevc_1080p_golden.npz: the sha256 of every cropped
   y/u/v plane of the reference's host decode (HevcDecoder with no
   options: inline host reconstruction, host deblock and SAO) of the
   bench stream's 3 frames (`bench`, shape (3, 3)), of the 1080p
   crafted stream's 2 frames (`sao_deblock`, shape (2, 3)) and of the
   small stream's 5 (`small`), in output order.

Usage (from the repository root; the host decode uses no JAX device
program; about 25 s for the bench stream on one CPU, and about as long
for crafting and decoding the 1080p stream):

    JAX_PLATFORMS=cpu python tools/gen_torch_hevc_fixture.py
"""

import hashlib
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import numpy as np  # noqa: E402

BENCH = REPO / "tests" / "data" / "bench" / "hevc_1080p.hevc"
PORT = REPO / "tests" / "data" / "port"
SAO_STREAM = PORT / "hevc_1080p_sao_deblock.hevc"
SMALL_STREAM = PORT / "hevc_crafted_64x64.hevc"
GOLDEN = PORT / "hevc_1080p_golden.npz"
SEED = 20


def plane_hashes(frame) -> list:
    return [hashlib.sha256(np.ascontiguousarray(np.asarray(p)).tobytes())
            .hexdigest() for p in frame.planes]


def reference_decode(stream: bytes) -> list:
    """The reference's host decoder (the oracle of the port's tests)."""
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.core.packet import Packet
    from ffmpeg_tpu.io.stream import CodecParameters, MediaType
    d = CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="hevc"))
    return d.decode_all([Packet(data=stream, pts=0)]) + d.decode_all([None])


def craft_sao_deblock() -> bytes:
    """IDR + P at 1920x1080 with SAO and deblocking, from SEED; the
    plan's coefficient density is cut so that the stream stays under
    1 MB."""
    import test_hevc as T
    rng = np.random.default_rng(SEED)
    stream, n = T.craft_gop(
        lambda: T.InterPlan(rng, maxn=2, amp=24, cbf_p=0.35, split_p=0.4),
        n_frames=2, width=1920, height=1080, sao=True,
        pps_kw=dict(deblock=True))
    assert n == 2
    return stream


def craft_small() -> bytes:
    import test_hevc as T
    rng = np.random.default_rng(SEED + 1)
    stream, n = T.craft_gop(
        lambda: T.InterPlan(rng, maxn=10, amp=40), n_frames=5,
        gop_kind="B", sao=True, pps_kw=dict(deblock=True))
    assert n == 5
    return stream


def main():
    t0 = time.time()
    if not SAO_STREAM.exists():
        SAO_STREAM.write_bytes(craft_sao_deblock())
        print(f"crafted {SAO_STREAM.name}: {SAO_STREAM.stat().st_size} B "
              f"in {time.time() - t0:.1f} s")
    if not SMALL_STREAM.exists():
        SMALL_STREAM.write_bytes(craft_small())
    out = {}
    for key, path in (("bench", BENCH), ("sao_deblock", SAO_STREAM),
                      ("small", SMALL_STREAM)):
        t = time.time()
        frames = reference_decode(path.read_bytes())
        out[key] = np.array([plane_hashes(f) for f in frames])
        print(f"{key}: {len(frames)} frames, {frames[0].width}x"
              f"{frames[0].height}, reference host decode "
              f"{time.time() - t:.1f} s")
    np.savez(GOLDEN, **out)
    print(f"wrote {GOLDEN.name} ({GOLDEN.stat().st_size} B) in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
