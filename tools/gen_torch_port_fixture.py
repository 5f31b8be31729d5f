#!/usr/bin/env python
"""Write the flagship fixture that the PyTorch port is checked against.

Runs the JAX package on the CPU and writes two files under
tests/data/port/:

- flagship_1080p_8.mjpeg: 8 frames of `testsrc` at 1920x1080, encoded
  with the options bench.py uses for the flagship clip (quality 88, one
  MCU per restart interval, optimal Huffman tables capped at 8 bits);
- flagship_1080p_8_golden.npz: `planes`, the reference
  MjpegTpuEntropyPipeline's output on that clip, shape (3, 8, 224, 224)
  uint8 (the three rgb24 components), decoded as one batch of 8 with
  stride 192 and the packed cap sized as bench.py sizes it.

The card's machine has no JAX, so the clip and the reference's answer
on it are committed.  Usage:

    JAX_PLATFORMS=cpu python tools/gen_torch_port_fixture.py
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

W, H, OUT = 1920, 1080, 224
NFRAMES = 8
BATCH = 8
STRIDE = 192
OUT_DIR = REPO / "tests" / "data" / "port"
CLIP = OUT_DIR / "flagship_1080p_8.mjpeg"
GOLDEN = OUT_DIR / "flagship_1080p_8_golden.npz"


def encode_clip() -> list:
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.filters import get_filter
    from ffmpeg_tpu.io.stream import CodecParameters, MediaType
    from ffmpeg_tpu.scale.swscale import scale_frame
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="mjpeg",
                          width=W, height=H)
    enc = CodecContext.open_encoder(
        par, options={"quality": 88, "restart_interval": 1,
                      "huffman": "optimal", "max_code_len": 8})
    src = get_filter("testsrc")(f"size={W}x{H}")
    pkts = []
    for fr in src.generate(NFRAMES):
        enc.send_frame(scale_frame(fr, W, H, "yuv420p", dst_range=True))
        pkts.append(enc.receive_packet().data)
    return pkts


def packed_cap(pkts) -> int:
    """bench.py's tight cap: the largest scan in the clip plus header."""
    from ffmpeg_tpu.codecs.mjpeg import _JpegState, _parse_until_scan
    max_scan = 0
    for p in pkts:
        off, _ = _parse_until_scan(p, _JpegState())
        max_scan = max(max_scan, len(p) - off)
    hdr = 2 * (-(-W // 16)) * (-(-H // 16)) + 512 * 12
    return hdr + max_scan + STRIDE + 128


def reference_planes(pkts) -> np.ndarray:
    from ffmpeg_tpu.models.mjpeg_tpu_entropy import (
        MjpegTpuEntropyPipeline, TpuEntropySpec)
    spec = TpuEntropySpec(W, H, OUT, OUT, batch=BATCH, stride=STRIDE,
                          packed_cap=packed_cap(pkts))
    pipe = MjpegTpuEntropyPipeline(spec, max(pkts, key=len))
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    return np.stack([np.asarray(c) for c in pipe.run_batch()])


def main() -> None:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    pkts = encode_clip()
    CLIP.write_bytes(b"".join(pkts))
    planes = reference_planes(pkts)
    assert planes.shape == (3, NFRAMES, OUT, OUT) and planes.dtype == np.uint8
    np.savez_compressed(GOLDEN, planes=planes)
    print(f"{CLIP}: {CLIP.stat().st_size} bytes, {len(pkts)} frames")
    print(f"{GOLDEN}: planes {planes.shape}")


if __name__ == "__main__":
    main()
