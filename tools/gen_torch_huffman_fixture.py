#!/usr/bin/env python
"""Write the standard-table MJPEG fixture of the general scan decode.

Encodes the first 2 frames of `testsrc` at 1920x1080 (full-range
yuv420p) with the port's MJPEG encoder on the CPU at quality 88, one MCU
per restart interval and its default Huffman tables (ITU T.81 Annex K,
codes of up to 16 bits), and writes the packets, one after the other, to
tests/data/port/huffman_annexk_1080p_2.mjpeg.  chip_smoke.py phase 32
decodes them with ops/huffman.jpeg_scan_decode on the card.

Uses only the port (no JAX).  Usage, from the repository root:

    python tools/gen_torch_huffman_fixture.py
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
W, H, NFRAMES = 1920, 1080, 2
OPTIONS = {"quality": 88, "restart_interval": 1}     # Annex K tables


def encode(w: int = W, h: int = H, n: int = NFRAMES) -> list:
    """The packets of the first n testsrc frames at w x h."""
    sys.path.insert(0, str(REPO))
    from ffmpeg_tpu_torch.codecs import CodecContext, EncoderParameters
    from ffmpeg_tpu_torch.filters import get_filter
    from ffmpeg_tpu_torch.scale.swscale import scale_frame
    enc = CodecContext.open_encoder(EncoderParameters("mjpeg", w, h),
                                    dict(OPTIONS), device="cpu")
    src = get_filter("testsrc")(f"size={w}x{h}")
    src.device = "cpu"
    pkts = []
    for fr in src.generate(n):
        enc.send_frame(scale_frame(fr, w, h, "yuv420p", device="cpu",
                                   dst_range=True))
        pkts.append(enc.receive_packet().data)
    return pkts


def main() -> None:
    sys.path.insert(0, str(REPO))
    from ffmpeg_tpu_torch.testing import HUFFMAN_ANNEXK
    data = b"".join(encode())
    HUFFMAN_ANNEXK.write_bytes(data)
    print(f"{HUFFMAN_ANNEXK.relative_to(REPO)}: {len(data)} bytes")


if __name__ == "__main__":
    main()
