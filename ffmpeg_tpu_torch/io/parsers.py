"""Packet parsers — frame-boundary splitters (analog of libavcodec's
av_parser_parse2 layer, 68 parsers in the reference; here the ones the
stream demuxers need to emit codec-frame-aligned packets).

The port's copy of ffmpeg_tpu/io/parsers.py, held equal to it by
tests/test_torch_io_containers.py.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

_ADTS_RATES = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
               16000, 12000, 11025, 8000, 7350]


def split_adts(data: bytes) -> Tuple[List[bytes], int, bytes]:
    """Split a byte run into complete ADTS frames.
    Returns (frames, sample_rate, remainder)."""
    frames = []
    rate = 0
    i = 0
    n = len(data)
    while i + 7 <= n:
        if data[i] != 0xFF or (data[i + 1] & 0xF6) != 0xF0:
            i += 1
            continue
        flen = (data[i + 3] & 3) << 11 | data[i + 4] << 3 | data[i + 5] >> 5
        if flen < 7:
            i += 1
            continue
        if i + flen > n:
            break
        rate = _ADTS_RATES[(data[i + 2] >> 2) & 15]
        frames.append(data[i:i + flen])
        i += flen
    return frames, rate, data[i:]


def split_mpeg_audio(data: bytes) -> Tuple[List[bytes], int, bytes]:
    """Split MPEG audio (layer II/III) frames. Returns (frames, rate, rest)."""
    bitrates_v1l3 = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192,
                     224, 256, 320, 0]
    bitrates_v1l2 = [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
                     256, 320, 384, 0]
    rates = [44100, 48000, 32000, 0]
    frames = []
    rate = 0
    i = 0
    n = len(data)
    while i + 4 <= n:
        if data[i] != 0xFF or (data[i + 1] & 0xE0) != 0xE0:
            i += 1
            continue
        ver = (data[i + 1] >> 3) & 3        # 3 = MPEG1
        layer = (data[i + 1] >> 1) & 3      # 1=III, 2=II, 3=I
        br_idx = data[i + 2] >> 4
        sr_idx = (data[i + 2] >> 2) & 3
        pad = (data[i + 2] >> 1) & 1
        if ver != 3 or layer == 0 or br_idx in (0, 15) or sr_idx == 3:
            i += 1
            continue
        sr = rates[sr_idx]
        br = (bitrates_v1l3 if layer == 1 else bitrates_v1l2)[br_idx] * 1000
        if layer == 3:  # layer I
            flen = (12 * br // sr + pad) * 4
        else:
            flen = 144 * br // sr + pad
        if flen <= 4 or i + flen > n:
            break
        rate = sr
        frames.append(data[i:i + flen])
        i += flen
    return frames, rate, data[i:]


# registry keyed by codec_id
SPLITTERS = {
    "aac": split_adts,
    "mp3": split_mpeg_audio,
    "mp2": split_mpeg_audio,
}
