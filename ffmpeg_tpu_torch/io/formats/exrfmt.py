"""OpenEXR image demuxer (reference: libavformat/img2dec.c
exr_pipe): the whole file is one packet.

The port's copy of ffmpeg_tpu/io/formats/exrfmt.py, held equal to it by
tests/test_torch_io_containers.py.
"""

from __future__ import annotations

from ...core.packet import Packet, PKT_FLAG_KEY
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from ..demux import Demuxer, register_demuxer
from ..stream import CodecParameters, MediaType

_MAGIC = b"\x76\x2f\x31\x01"


@register_demuxer
class ExrDemuxer(Demuxer):
    name = "exr_pipe"
    extensions = ("exr",)

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        return 99 if head[:4] == _MAGIC else 0

    def read_header(self) -> None:
        head = self.r.peek(4)
        if head[:4] != _MAGIC:
            raise InvalidData("exr: bad magic")
        par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="exr")
        self.add_stream(codecpar=par, time_base=Rational(1, 25))
        self._done = False

    def read_packet(self) -> Packet:
        if self._done:
            raise EndOfStream()
        data = self.r.read(1 << 30)
        self._done = True
        return Packet(data=data, stream_index=0, pts=0, dts=0,
                      flags=PKT_FLAG_KEY, time_base=Rational(1, 25))
