"""Raw DTS (.dts) demuxer (reference: libavformat/dtsdec.c probe;
frame sizing per the core bitstream header, dca.c:86). Splits the
elementary stream into core frames at 0x7FFE8001 sync words.

The port's copy of ffmpeg_tpu/io/formats/dtsraw.py, held equal to it by
tests/test_torch_host_codecs.py.
"""

from __future__ import annotations

from ...codecs import dca_tables as T
from ...core.packet import Packet, PKT_FLAG_KEY
from ...formats.channel_layout import default_layout
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from ..demux import Demuxer, register_demuxer
from ..stream import CodecParameters, MediaType

_SYNC = b"\x7f\xfe\x80\x01"


def _frame_info(head: bytes):
    """→ (frame_size, sample_rate, channels, nsamples) or None."""
    if len(head) < 10 or head[:4] != _SYNC:
        return None
    v = int.from_bytes(head[4:10], "big")   # 48 bits after sync
    npcmblocks = ((v >> 34) & 0x7F) + 1
    frame_size = ((v >> 20) & 0x3FFF) + 1
    audio_mode = (v >> 14) & 0x3F
    sr_code = (v >> 10) & 0xF
    if frame_size < 96 or npcmblocks & 7 or audio_mode >= 16:
        return None
    rate = T.SAMPLE_RATES[sr_code]
    if not rate:
        return None
    lfe = (head[10] >> 1) & 3 if len(head) > 10 else 0
    nch = T.CHANNELS[audio_mode] + (1 if lfe in (1, 2) else 0)
    return frame_size, rate, nch, npcmblocks * 32


@register_demuxer
class DtsDemuxer(Demuxer):
    name = "dts"
    long_name = "raw DTS"
    extensions = ("dts",)

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        good = 0
        i = 0
        while i + 11 <= len(head) and good < 4:
            fi = _frame_info(head[i:i + 11])
            if fi is None:
                break
            good += 1
            i += fi[0]
        return 55 if good >= 3 else (25 if good == 2 else 0)

    def read_header(self) -> None:
        self._resync()
        fi = _frame_info(self.r.peek(11))
        if fi is None:
            raise InvalidData("dts: no syncframe")
        _, rate, nch, nsamples = fi
        par = CodecParameters(
            codec_type=MediaType.AUDIO, codec_id="dts",
            sample_rate=rate, ch_layout=default_layout(nch),
            frame_size=nsamples)
        self.add_stream(codecpar=par, time_base=Rational(1, rate))
        self._pts = 0

    def _resync(self) -> None:
        skipped = 0
        while skipped < 65536:
            head = self.r.peek(11)
            if len(head) < 11:
                raise EndOfStream()
            if _frame_info(head) is not None:
                return
            self.r.skip(1)
            skipped += 1
        raise InvalidData("dts: lost sync")

    def read_packet(self) -> Packet:
        self._resync()
        fi = _frame_info(self.r.peek(11))
        if fi is None:
            raise EndOfStream()
        data = self.r.read_exact(fi[0])
        pkt = Packet(data=data, pts=self._pts, dts=self._pts,
                     duration=fi[3], stream_index=0,
                     flags=PKT_FLAG_KEY,
                     time_base=Rational(1, fi[1]))
        self._pts += fi[3]
        return pkt
