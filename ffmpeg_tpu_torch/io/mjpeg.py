"""Raw MJPEG stream demuxer: concatenated JPEG images, one packet per
SOI..EOI span.

Counterpart of ffmpeg_tpu/io/formats/img_mjpeg.py MjpegDemuxer.  Same
split rule: a packet ends at the first FFD9 after the
previous one, spans of 4 bytes or less are dropped, and anything but
zero padding after the last EOI is an error.
"""

from __future__ import annotations

from typing import List

from ..utils.error import InvalidData


def split_packets(data: bytes) -> List[bytes]:
    """Cut a raw .mjpeg byte string into JPEG images at EOI."""
    out = []
    i = 0
    while True:
        idx = data.find(b"\xFF\xD9", i)
        if idx < 0:
            break
        if idx + 2 - i > 4:
            out.append(data[i:idx + 2])
        i = idx + 2
    if data[i:].strip(b"\x00"):
        raise InvalidData("mjpeg: trailing garbage after the last EOI")
    return out

