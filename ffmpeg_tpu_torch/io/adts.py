"""Raw ADTS AAC stream demuxer: one packet per ADTS frame.

Counterpart of ffmpeg_tpu/io/formats/adts.py AdtsDemuxer (reference:
libavformat/aacdec.c).  Same rules: the first header gives the stream's
parameters (sample rate, `default_layout` of the channel configuration or
stereo where it is 0, 1024 samples per frame); each packet is one whole
frame, header included, with pts stepping by 1024 on time base 1/rate; a
frame that does not start with the sync word raises, and a truncated
last frame, or a tail shorter than a header, ends the stream.
"""

from __future__ import annotations

from typing import List, Tuple

from ..core.packet import PKT_FLAG_KEY, Packet
from ..formats.channel_layout import default_layout
from ..utils.error import InvalidData
from ..utils.rational import Rational
from .stream import CodecParameters, MediaType

_RATES = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
          16000, 12000, 11025, 8000, 7350]


def _synced(data: bytes, i: int) -> bool:
    return data[i] == 0xFF and (data[i + 1] & 0xF6) == 0xF0


def read_adts(data: bytes) -> Tuple[CodecParameters, List[Packet]]:
    """The stream parameters and the packets of a raw ADTS byte string."""
    if len(data) < 7 or not _synced(data, 0):
        raise InvalidData("adts: bad sync")
    sr_idx = (data[2] >> 2) & 15
    if sr_idx >= len(_RATES):
        raise InvalidData(f"adts: bad sample rate index {sr_idx}")
    ch_cfg = (data[2] & 1) << 2 | data[3] >> 6
    rate = _RATES[sr_idx]
    par = CodecParameters(
        codec_type=MediaType.AUDIO, codec_id="aac", sample_rate=rate,
        ch_layout=default_layout(ch_cfg if ch_cfg else 2), frame_size=1024)
    tb = Rational(1, rate)
    pkts: List[Packet] = []
    i = pts = 0
    while len(data) - i >= 7:
        if not _synced(data, i):
            raise InvalidData("adts: lost sync")
        flen = (data[i + 3] & 3) << 11 | data[i + 4] << 3 | data[i + 5] >> 5
        if flen < 7:
            raise InvalidData(f"adts: frame length {flen}")
        if i + flen > len(data):
            break
        pkts.append(Packet(data=data[i:i + flen], pts=pts, dts=pts,
                           duration=1024, flags=PKT_FLAG_KEY, time_base=tb))
        pts += 1024
        i += flen
    return par, pkts
