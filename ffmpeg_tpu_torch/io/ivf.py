"""IVF stream reader: one packet per frame of a VP8/VP9/AV1 IVF file.

Counterpart of ffmpeg_tpu/io/formats/ivf.py IvfDemuxer (reference:
libavformat/ivfdec.c).  Same rules: a 32-byte header with the magic
"DKIF", the fourcc, the width and height and the time base (rate and
scale, 1/25 where zero); then per frame a 12-byte header (size, 64-bit
pts) and the frame's bytes.  Each packet is a key packet with dts = pts
on the stream's time base; a tail shorter than a frame header, or a
truncated last frame, ends the stream.  The demuxer registry of the
reference is not ported: this reader stands alone, as io/adts.py does.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

from ..core.packet import PKT_FLAG_KEY, Packet
from ..utils.error import InvalidData
from ..utils.rational import Rational
from .stream import CodecParameters, MediaType

_FOURCC = {b"VP80": "vp8", b"VP90": "vp9", b"AV01": "av1"}


def read_ivf(data: bytes) -> Tuple[CodecParameters, Rational, List[Packet]]:
    """The stream parameters, time base and packets of an IVF byte
    string."""
    if len(data) < 32:
        raise InvalidData("ivf: short header")
    if data[:4] != b"DKIF":
        raise InvalidData("ivf: bad magic")
    fourcc = data[8:12]
    if fourcc not in _FOURCC:
        raise InvalidData("ivf: unknown fourcc")
    w, h, den, num = struct.unpack("<HHII", data[12:24])
    par = CodecParameters(codec_type=MediaType.VIDEO,
                          codec_id=_FOURCC[fourcc], width=w, height=h)
    tb = Rational(num or 1, den or 25)
    pkts: List[Packet] = []
    pos = 32
    while len(data) - pos >= 12:
        size, pts = struct.unpack("<IQ", data[pos:pos + 12])
        pos += 12
        if pos + size > len(data):
            break
        pkts.append(Packet(data=data[pos:pos + size], pts=pts, dts=pts,
                           stream_index=0, time_base=tb,
                           flags=PKT_FLAG_KEY))
        pos += size
    return par, tb, pkts
