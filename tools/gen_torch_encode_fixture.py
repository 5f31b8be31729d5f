#!/usr/bin/env python
"""Write the MPEG-2 encode golden that the PyTorch port is checked against.

Runs the JAX package on the CPU on the clip of
ffmpeg_tpu_torch.testing.mpeg2_clip at 1920x1080 (made from a seed on
every machine, not committed) and writes
tests/data/port/mpeg2_1080p_ippp_golden.npz with:

- `clip_sha256`: a checksum of the clip's first ENC_FRAMES frames;
- `pair_mvs` (68, 120, 2) int32 and `pair_costs` (68, 120) float32: the
  reference's motion_search(frame 1, frame 0) on the padded 1088x1920
  luma, block 16, search 8 — an exact pair for K2;
- for an I P P P encode through the reference's CodecContext at fixed
  qscale (testing.ENC_OPTIONS), the reference as it ships (its quantiser
  matrices scattered through ZIGZAG, as the port's are): `packet_bytes`
  (4,); `psnr` (4,), the PSNR in dB of the encoder's reconstruction
  after each frame against the source; and `p_mvs` (3, 68, 120, 2)
  int32, the motion search grid of each P frame against the encoder's
  reconstructed reference.

The card's machine has no JAX, so the reference's answer is committed.
Usage:

    JAX_PLATFORMS=cpu python tools/gen_torch_encode_fixture.py
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from ffmpeg_tpu_torch import testing as fx  # noqa: E402

W, H = 1920, 1080


def main() -> None:
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.codecs.mpeg12_enc import _pad
    from ffmpeg_tpu.io.stream import CodecParameters, MediaType
    from ffmpeg_tpu.ops.me import motion_search

    frames = fx.mpeg2_clip(fx.ENC_FRAMES, W, H)
    ph, pw = -(-H // 16) * 16, -(-W // 16) * 16
    luma = [_pad(np.asarray(f.planes[0]), ph, pw) for f in frames]
    pair_mvs, pair_costs = motion_search(luma[1], luma[0], 16, 8)

    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="mpeg2video",
                          width=W, height=H)
    ctx = CodecContext.open_encoder(par, options=dict(fx.ENC_OPTIONS))
    enc = ctx.codec
    sizes, psnr, p_mvs = [], [], []
    for i, f in enumerate(frames):
        if i % fx.ENC_GOP:
            # the search the encoder is about to run on this P frame
            p_mvs.append(np.asarray(motion_search(luma[i], enc._recon[0],
                                                  16, enc.SEARCH)[0]))
        ctx.send_frame(f)
        sizes.append(len(ctx.receive_packet().data))
        psnr.append(fx.recon_psnr(enc._recon, f))
        print(f"frame {i}: {sizes[-1]} bytes, {psnr[-1]:.4f} dB")

    fx.ENCODE_GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        fx.ENCODE_GOLDEN, clip_sha256=np.array(fx.clip_checksum(frames)),
        pair_mvs=np.asarray(pair_mvs, np.int32),
        pair_costs=np.asarray(pair_costs, np.float32),
        packet_bytes=np.array(sizes, np.int64),
        psnr=np.array(psnr, np.float64),
        p_mvs=np.stack(p_mvs).astype(np.int32))
    print(f"{fx.ENCODE_GOLDEN}: {fx.ENCODE_GOLDEN.stat().st_size} bytes")


if __name__ == "__main__":
    main()
