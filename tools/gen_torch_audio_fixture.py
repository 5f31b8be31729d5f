#!/usr/bin/env python
"""Write the golden that the port's audio frontend is checked against.

Runs the JAX package on the CPU over the committed clip
tests/data/bench/aac48k.adts (939 ADTS frames of 48 kHz stereo AAC-LC,
20.03 s) and writes tests/data/port/aac48k_frontend_golden.npz, two
float32 arrays:

- `resampled`, (1, 320512): the reference's ADTS demuxer,
  CodecContext.open_decoder(...).decode_frames over every packet, the
  decoded planes concatenated, then SwrContext(48000, "stereo", "fltp",
  16000, "mono", "fltp"): convert of the whole utterance, then the flush
  (`benchrows.audio_frontend_row`'s pass on the whole clip);
- `decoded`, (2, 32768): the first 32 decoded frames.

The card's machine has no JAX, so the reference's answers are committed.
Usage:

    JAX_PLATFORMS=cpu python tools/gen_torch_audio_fixture.py
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

CLIP = REPO / "tests" / "data" / "bench" / "aac48k.adts"
GOLDEN = REPO / "tests" / "data" / "port" / "aac48k_frontend_golden.npz"
NPACKETS, GOLDEN_FRAMES = 939, 32


def main() -> None:
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.io import open_input
    from ffmpeg_tpu.resample.swresample import SwrContext
    d = open_input(str(CLIP))
    pkts = list(d.packets())
    assert len(pkts) == NPACKETS, len(pkts)
    frames = CodecContext.open_decoder(d.streams[0].codecpar) \
        .decode_frames(pkts)
    pcm = np.concatenate([f.audio_data for f in frames], axis=1)
    swr = SwrContext(48000, "stereo", "fltp", 16000, "mono", "fltp")
    out = np.concatenate([swr.convert(pcm), swr.flush()], axis=1)
    decoded = pcm[:, :GOLDEN_FRAMES * 1024]
    assert pcm.shape == (2, NPACKETS * 1024) and pcm.dtype == np.float32
    assert out.shape == (1, 320512) and out.dtype == np.float32
    np.savez_compressed(GOLDEN, resampled=out, decoded=decoded)
    print(f"{GOLDEN}: resampled {out.shape}, decoded {decoded.shape}, "
          f"{GOLDEN.stat().st_size} bytes")


if __name__ == "__main__":
    main()
