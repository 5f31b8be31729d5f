"""Raw MLP / TrueHD demuxer (reference: libavformat/rawdec.c mlp/thd
entries + the access-unit packetization of libavcodec/mlp_parser.c).

Packets are whole access units: 2-byte check-nibble + 12-bit length
(in 16-bit words), timing word, optional major sync.

The port's copy of ffmpeg_tpu/io/formats/mlpraw.py, held equal to it by
tests/test_torch_io_containers.py.
"""

from __future__ import annotations

from ...core.packet import Packet, PKT_FLAG_KEY
from ...formats.channel_layout import default_layout
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from ..demux import Demuxer, register_demuxer
from ..stream import CodecParameters, MediaType

_SYNC_MLP = b"\xf8\x72\x6f\xbb"
_SYNC_THD = b"\xf8\x72\x6f\xba"


def _rate(code):
    if code == 0xF:
        return 48000
    return (44100 if code & 8 else 48000) << (code & 7)


class _MlpBase(Demuxer):
    sync = _SYNC_MLP
    codec = "mlp"

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        i = head.find(cls.sync)
        if 4 <= i <= 4096 + 4 and i % 2 == 0:
            return 55
        return 0

    def read_header(self) -> None:
        head = self.r.peek(64)
        i = head.find(self.sync)
        if i < 4:
            raise InvalidData("mlp: no major sync")
        if self.codec == "mlp":
            rate_code = head[i + 4 + 1] >> 4
            arr = ((head[i + 6] & 0x7) << 2) | (head[i + 7] >> 6)
            del arr
        else:
            rate_code = head[i + 4] >> 4
        rate = _rate(rate_code)
        au = 40 << (rate_code & 7)
        par = CodecParameters(
            codec_type=MediaType.AUDIO, codec_id=self.codec,
            sample_rate=rate, ch_layout=default_layout(2),
            frame_size=au)
        self.add_stream(codecpar=par, time_base=Rational(1, rate))
        self._pts = 0
        self._au = au

    def read_packet(self) -> Packet:
        head = self.r.peek(4)
        if len(head) < 4:
            raise EndOfStream()
        length = (int.from_bytes(head[:2], "big") & 0xFFF) * 2
        if length < 4:
            raise InvalidData("mlp: bad AU length")
        data = self.r.read_exact(length)
        key = self.sync in data[4:8 + 28]
        pkt = Packet(data=data, pts=self._pts, dts=self._pts,
                     duration=self._au,
                     flags=PKT_FLAG_KEY if key else 0,
                     time_base=self.streams[0].time_base)
        self._pts += self._au
        return pkt


@register_demuxer
class MlpDemuxer(_MlpBase):
    name = "mlp"
    long_name = "raw MLP"
    extensions = ("mlp",)
    sync = _SYNC_MLP
    codec = "mlp"


@register_demuxer
class TrueHdDemuxer(_MlpBase):
    name = "truehd"
    long_name = "raw TrueHD"
    extensions = ("thd",)
    sync = _SYNC_THD
    codec = "truehd"
