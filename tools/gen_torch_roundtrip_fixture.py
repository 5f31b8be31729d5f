#!/usr/bin/env python
"""Write the encoders' round-trip golden that the PyTorch port is checked
against.

Runs the JAX package on the CPU on the clip of
ffmpeg_tpu_torch.testing.mpeg2_clip at 1920x1080 (made from a seed on
every machine, not committed) and writes
tests/data/port/roundtrip_1080p_golden.npz, which holds hashes, sizes and
PSNRs only:

- `clip_sha256`: a checksum of the clip's first RT_FRAMES (8) frames;
- the H.264 encoder with its defaults (qp 26, gop 25, me_range 8,
  subpel 2) on the first 2 frames, I then P: `h264_packet_sha256` (2,)
  and `h264_packet_bytes` (2,); `h264_plane_sha256` (2, 3), the sha256
  of the reference H.264 decoder's y/u/v planes of those packets (the
  SPS crops 1088 rows to 1080), which must equal the encoder's
  reconstruction cropped (the tool checks it);
- `mpeg2_psnr` (4,): the PSNR in dB against the source of the reference
  MPEG-2 decoder's planes of the reference encoder's I P P P packets at
  testing.ENC_OPTIONS (its quantiser matrices permuted, as it ships), and
  `mpeg2_packet_bytes` (4,);
- `mjpeg_packet_bytes` (8,): the reference MJPEG encoder's packets of the
  first 8 frames at testing.MJPEG_ENC_OPTIONS (the flagship's options),
  and `mjpeg_psnr` (8,): the PSNR in dB of the reference flagship
  pipeline's 224x224 rgb24 decode of them, as one batch, against the
  source frames through the reference's scale at
  testing.MJPEG_TARGET_SPEC.

The card's machine has no JAX, so the reference's answers are committed.
Usage (several minutes: the reference's 1080p H.264 P frame and its
decode run in Python):

    JAX_PLATFORMS=cpu python tools/gen_torch_roundtrip_fixture.py
"""

from __future__ import annotations

import hashlib
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from ffmpeg_tpu_torch import testing as fx  # noqa: E402

W, H = 1920, 1080


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _par(codec_id: str):
    from ffmpeg_tpu.io.stream import CodecParameters, MediaType
    return CodecParameters(codec_type=MediaType.VIDEO, codec_id=codec_id,
                           width=W, height=H)


def _ref_frames(frames):
    """The clip's frames as the reference's Frames (numpy planes)."""
    from ffmpeg_tpu.core.frame import Frame
    return [Frame.video(W, H, "yuv420p",
                        planes=[np.asarray(p) for p in f.planes],
                        pts=f.pts, time_base=f.time_base) for f in frames]


def h264(frames) -> dict:
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.core.packet import Packet
    enc = CodecContext.open_encoder(_par("h264"))
    pkts, recons = [], []
    for f in frames[:fx.H264_ENC_FRAMES]:
        t = time.perf_counter()
        pkts += enc.codec.encode(f)
        recons.append([np.array(p[:H // (1 + (i > 0)), :W // (1 + (i > 0))])
                       for i, p in enumerate(enc.codec._recon)])
        print(f"h264 encode: {len(pkts[-1].data)} bytes in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    dec = CodecContext.open_decoder(_par("h264"))
    out = dec.decode_all([Packet(data=b"".join(p.data for p in pkts),
                                 pts=0)])
    print(f"h264 decode: {len(out)} frames in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    planes = [[np.asarray(p) for p in f.planes] for f in out]
    assert [p.shape for p in planes[0]] == [(H, W), (H // 2, W // 2),
                                            (H // 2, W // 2)]
    for got, want in zip(planes, recons):
        for a, b in zip(got, want):
            assert np.array_equal(a, b), "decode differs from the recon"
    return {"h264_packet_sha256": np.array([_sha(np.frombuffer(
                p.data, np.uint8)) for p in pkts]),
            "h264_packet_bytes": np.array([len(p.data) for p in pkts],
                                          np.int64),
            "h264_plane_sha256": np.array([[_sha(p) for p in f]
                                           for f in planes])}


def mpeg2(frames) -> dict:
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.core.packet import Packet
    from ffmpeg_tpu.utils.rational import Rational
    src = frames[:fx.ENC_FRAMES]
    enc = CodecContext.open_encoder(_par("mpeg2video"),
                                    options=dict(fx.ENC_OPTIONS))
    pkts = []
    t = time.perf_counter()
    for f in src:
        enc.send_frame(f)
        pkts.append(enc.receive_packet())
    print(f"mpeg2 encode: {[len(p.data) for p in pkts]} bytes in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    dec = CodecContext.open_decoder(_par("mpeg2video"))
    out = dec.decode_all([Packet(data=p.data, pts=i,
                                 time_base=Rational(1, 25))
                          for i, p in enumerate(pkts)])
    print(f"mpeg2 decode: {len(out)} frames in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    assert [f.pict_type for f in out] == ["I", "P", "P", "P"]
    psnr = [fx.recon_psnr([np.asarray(p) for p in f.planes], s)
            for f, s in zip(out, src)]
    print(f"mpeg2 psnr: {psnr}", flush=True)
    return {"mpeg2_psnr": np.array(psnr, np.float64),
            "mpeg2_packet_bytes": np.array([len(p.data) for p in pkts],
                                           np.int64)}


def mjpeg(frames) -> dict:
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.codecs.mjpeg import _JpegState, _parse_until_scan
    from ffmpeg_tpu.models.mjpeg_tpu_entropy import (
        MjpegTpuEntropyPipeline, TpuEntropySpec)
    from ffmpeg_tpu.scale.swscale import Scaler
    enc = CodecContext.open_encoder(_par("mjpeg"),
                                    options=dict(fx.MJPEG_ENC_OPTIONS))
    t = time.perf_counter()
    pkts = []
    for f in frames[:fx.RT_FRAMES]:
        enc.send_frame(f)
        pkts.append(enc.receive_packet().data)
    print(f"mjpeg encode: {[len(p) for p in pkts]} bytes in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    # the same spec as testing.mjpeg_pipeline_rgb builds for the port
    max_scan = max(len(p) - _parse_until_scan(p, _JpegState())[0]
                   for p in pkts)
    cap = 2 * (-(-W // 16)) * (-(-H // 16)) + 512 * 12 + max_scan \
        + fx.MJPEG_SEGMENT_STRIDE + 128
    spec = TpuEntropySpec(W, H, fx.OUT, fx.OUT, batch=len(pkts),
                          stride=fx.MJPEG_SEGMENT_STRIDE, packed_cap=cap)
    pipe = MjpegTpuEntropyPipeline(spec, max(pkts, key=len))
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    got = np.stack([np.asarray(c) for c in pipe.run_batch()])
    sc = Scaler(src_w=W, src_h=H, **fx.MJPEG_TARGET_SPEC)
    want = np.stack([np.stack([np.asarray(c) for c in sc.run(
        [np.asarray(p) for p in f.planes[:3]])])
        for f in frames[:fx.RT_FRAMES]], axis=1)
    psnr = fx.rgb_psnr(got, want)
    print(f"mjpeg psnr: {psnr}", flush=True)
    return {"mjpeg_packet_bytes": np.array([len(p) for p in pkts],
                                           np.int64),
            "mjpeg_psnr": np.array(psnr, np.float64)}


def main() -> None:
    clip = fx.mpeg2_clip(fx.RT_FRAMES, W, H)
    frames = _ref_frames(clip)
    out = {"clip_sha256": np.array(fx.clip_checksum(clip))}
    out.update(mjpeg(frames))
    out.update(mpeg2(frames))
    out.update(h264(frames))
    fx.ROUNDTRIP_GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(fx.ROUNDTRIP_GOLDEN, **out)
    print(f"{fx.ROUNDTRIP_GOLDEN}: "
          f"{fx.ROUNDTRIP_GOLDEN.stat().st_size} bytes")


if __name__ == "__main__":
    main()
