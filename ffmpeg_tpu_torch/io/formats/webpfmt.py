"""WebP image demuxer (reference: libavformat/img2dec.c
webp_pipe/image_webp_pipe): the whole RIFF file is one packet.

The port's copy of ffmpeg_tpu/io/formats/webpfmt.py, held equal to it by
tests/test_torch_io_containers.py.
"""

from __future__ import annotations

import struct

from ...core.packet import Packet, PKT_FLAG_KEY
from ...utils.error import EndOfStream, InvalidData
from ..demux import Demuxer, register_demuxer
from ..mux import Muxer, register_muxer
from ..stream import CodecParameters, MediaType
from ...utils.rational import Rational


@register_demuxer
class WebPDemuxer(Demuxer):
    name = "webp_pipe"
    extensions = ("webp",)

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
            return 99
        return 0

    def read_header(self) -> None:
        head = self.r.read(30)
        self.r.seek(0)
        if head[:4] != b"RIFF" or head[8:12] != b"WEBP":
            raise InvalidData("webp: bad signature")
        w = h = 0
        if head[12:16] == b"VP8 " and len(head) >= 30:
            # keyframe tag + start code + dims
            if head[23:26] == b"\x9d\x01\x2a":
                w = struct.unpack("<H", head[26:28])[0] & 0x3FFF
                h = struct.unpack("<H", head[28:30])[0] & 0x3FFF
        par = CodecParameters(codec_type=MediaType.VIDEO,
                              codec_id="webp", width=w, height=h)
        self.add_stream(codecpar=par, time_base=Rational(1, 25))
        self._done = False

    def read_packet(self) -> Packet:
        if self._done:
            raise EndOfStream()
        data = self.r.read(1 << 30)
        self._done = True
        return Packet(data=data, stream_index=0, pts=0, dts=0,
                      flags=PKT_FLAG_KEY, time_base=Rational(1, 25))


@register_muxer
class WebPMuxer(Muxer):
    """Single-image .webp writer (the codec packet is the file)."""

    name = "webp"
    extensions = ("webp",)
    default_video_codec = "webp"

    def _write_header(self) -> None:
        pass

    def _write_packet(self, pkt: Packet) -> None:
        self.w.write(bytes(pkt.data))
