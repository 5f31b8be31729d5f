"""IVF container demuxer + muxer (reference: libavformat/ivfdec.c /
ivfenc.c): 32-byte header + per-frame 12-byte headers; carries
VP8/VP9/AV1 elementary streams.

The port's copy of ffmpeg_tpu/io/formats/ivf.py, held equal to it by
tests/test_torch_io_formats.py.
"""

from __future__ import annotations

import struct

from ...core.packet import Packet, PKT_FLAG_KEY
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from ..demux import Demuxer, register_demuxer
from ..mux import Muxer, register_muxer
from ..stream import CodecParameters, MediaType

_FOURCC = {b"VP80": "vp8", b"VP90": "vp9", b"AV01": "av1"}
_CODEC = {v: k for k, v in _FOURCC.items()}


@register_demuxer
class IvfDemuxer(Demuxer):
    name = "ivf"
    long_name = "On2 IVF"
    extensions = ("ivf",)

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        if head[:4] == b"DKIF" and len(head) >= 12 and \
                head[8:12] in _FOURCC:
            return 100
        return 0

    def read_header(self) -> None:
        hd = self.r.read_exact(32)
        if hd[:4] != b"DKIF":
            raise InvalidData("ivf: bad magic")
        fourcc = hd[8:12]
        if fourcc not in _FOURCC:
            raise InvalidData("ivf: unknown fourcc")
        w, h, den, num = struct.unpack("<HHII", hd[12:24])
        par = CodecParameters(codec_type=MediaType.VIDEO,
                              codec_id=_FOURCC[fourcc], width=w,
                              height=h)
        tb = Rational(num or 1, den or 25)
        self.add_stream(codecpar=par, time_base=tb)

    def read_packet(self) -> Packet:
        hd = self.r.read(12)
        if len(hd) < 12:
            raise EndOfStream()
        size, pts = struct.unpack("<IQ", hd)
        data = self.r.read_exact(size)
        return Packet(data=data, pts=pts, dts=pts, stream_index=0,
                      time_base=self.streams[0].time_base,
                      flags=PKT_FLAG_KEY)


@register_muxer
class IvfMuxer(Muxer):
    name = "ivf"
    long_name = "On2 IVF"
    extensions = ("ivf",)
    default_video_codec = "vp9"

    def _write_header(self) -> None:
        st = self.streams[0]
        if st.codecpar.codec_id not in _CODEC:
            raise InvalidData("ivf: unsupported codec")
        tb = st.time_base
        self.w.write(b"DKIF" + struct.pack(
            "<HH4sHHIIQ", 0, 32, _CODEC[st.codecpar.codec_id],
            st.codecpar.width, st.codecpar.height, tb.den, tb.num, 0))
        self._count = 0

    def _write_packet(self, pkt) -> None:
        if pkt is None:
            return
        self.w.write(struct.pack("<IQ", len(pkt.data),
                                 max(0, pkt.pts or 0)))
        self.w.write(pkt.data)
        self._count += 1

    def _write_trailer(self) -> None:
        # back-patch the frame count
        if getattr(self.w, "seekable", False):
            end = self.w.tell()
            self.w.seek(24)
            self.w.write(struct.pack("<I", self._count))
            self.w.seek(end)
