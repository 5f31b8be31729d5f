"""NAL unit handling: Annex-B / AVCC splitting and emulation-prevention
byte removal (reference: libavcodec/h2645_parse.c).

The port's copy of ffmpeg_tpu/codecs/h264/nal.py, held equal to it by
tests/test_torch_hevc_host.py."""

from __future__ import annotations

from typing import List, Tuple

NAL_SLICE = 1
NAL_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_AUD = 9


def unescape(data: bytes) -> bytes:
    """Remove 00 00 03 emulation prevention bytes."""
    if b"\x00\x00\x03" not in data:
        return data
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        j = data.find(b"\x00\x00\x03", i)
        if j < 0:
            out += data[i:]
            break
        out += data[i:j + 2]
        i = j + 3
    return bytes(out)


def split_annexb(data: bytes) -> List[bytes]:
    """Split an Annex-B byte stream into raw NAL units (no start codes)."""
    nals = []
    i = 0
    n = len(data)
    while True:
        j = data.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        j += 3
        k = data.find(b"\x00\x00\x01", j)
        end = n if k < 0 else (k - 1 if k > 0 and data[k - 1] == 0 else k)
        nal = data[j:end].rstrip(b"\x00") or data[j:end]
        if nal:
            nals.append(nal)
        if k < 0:
            break
        i = k
    return nals


def split_avcc(data: bytes, nal_size: int = 4) -> List[bytes]:
    nals = []
    i = 0
    while i + nal_size <= len(data):
        ln = int.from_bytes(data[i:i + nal_size], "big")
        i += nal_size
        nals.append(data[i:i + ln])
        i += ln
    return nals


def parse_nal_header(nal: bytes) -> Tuple[int, int]:
    """→ (nal_ref_idc, nal_unit_type)."""
    b = nal[0]
    return (b >> 5) & 3, b & 0x1F
