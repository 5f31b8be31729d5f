"""ADTS AAC demuxer + muxer (reference: libavformat/aacdec.c / adtsenc.c).

The port's copy of ffmpeg_tpu/io/formats/adts.py, held equal to it by
tests/test_torch_io_formats.py.
"""

from __future__ import annotations

from ...core.packet import Packet, PKT_FLAG_KEY
from ...formats.channel_layout import default_layout
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from ..demux import Demuxer, register_demuxer
from ..mux import Muxer, register_muxer
from ..stream import CodecParameters, MediaType

_RATES = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
          16000, 12000, 11025, 8000, 7350]


@register_demuxer
class AdtsDemuxer(Demuxer):
    name = "aac"
    long_name = "raw ADTS AAC"
    extensions = ("aac", "adts")

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        # count consecutive valid ADTS frames
        i = 0
        good = 0
        while i + 7 < len(head) and good < 3:
            if head[i] != 0xFF or (head[i + 1] & 0xF6) != 0xF0:
                break
            flen = (head[i + 3] & 3) << 11 | head[i + 4] << 3 | head[i + 5] >> 5
            if flen < 7:
                break
            good += 1
            i += flen
        return (60 if good >= 2 else 20 if good == 1 else 0)

    def read_header(self) -> None:
        head = self.r.peek(7)
        if len(head) < 7 or head[0] != 0xFF or (head[1] & 0xF6) != 0xF0:
            raise InvalidData("adts: bad sync")
        sr_idx = (head[2] >> 2) & 15
        ch_cfg = (head[2] & 1) << 2 | head[3] >> 6
        rate = _RATES[sr_idx]
        par = CodecParameters(
            codec_type=MediaType.AUDIO, codec_id="aac", sample_rate=rate,
            ch_layout=default_layout(ch_cfg if ch_cfg else 2),
            frame_size=1024)
        self.add_stream(codecpar=par, time_base=Rational(1, rate))
        self._pts = 0

    def read_packet(self) -> Packet:
        head = self.r.peek(7)
        if len(head) < 7:
            raise EndOfStream()
        if head[0] != 0xFF or (head[1] & 0xF6) != 0xF0:
            raise InvalidData("adts: lost sync")
        flen = (head[3] & 3) << 11 | head[4] << 3 | head[5] >> 5
        data = self.r.read_exact(flen)
        pkt = Packet(data=data, pts=self._pts, dts=self._pts, duration=1024,
                     flags=PKT_FLAG_KEY, time_base=self.streams[0].time_base)
        self._pts += 1024
        return pkt


@register_muxer
class AdtsMuxer(Muxer):
    name = "adts"
    extensions = ("aac", "adts")
    default_audio_codec = "aac"
    interleave = False

    def _write_header(self) -> None:
        par = self.streams[0].codecpar
        self._sr_idx = _RATES.index(par.sample_rate) \
            if par.sample_rate in _RATES else 4
        self._ch_cfg = min(par.channels, 6)

    def _write_packet(self, pkt: Packet) -> None:
        if len(pkt.data) > 2 and pkt.data[0] == 0xFF and \
                (pkt.data[1] & 0xF6) == 0xF0:
            self.w.write(pkt.data)      # already ADTS
            return
        flen = len(pkt.data) + 7
        hdr = bytearray(7)
        hdr[0] = 0xFF
        hdr[1] = 0xF1                   # MPEG-4, layer 0, no CRC
        hdr[2] = (1 << 6) | (self._sr_idx << 2) | (self._ch_cfg >> 2)
        hdr[3] = ((self._ch_cfg & 3) << 6) | ((flen >> 11) & 3)
        hdr[4] = (flen >> 3) & 0xFF
        hdr[5] = ((flen & 7) << 5) | 0x1F
        hdr[6] = 0xFC
        self.w.write(bytes(hdr))
        self.w.write(pkt.data)
