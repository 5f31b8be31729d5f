"""Raw AC-3 (.ac3) demuxer (reference: libavformat/ac3dec.c probe +
ac3_parser.c frame sizing). Splits the elementary stream into
1536-sample syncframes using the A/52 frame size table.

The port's copy of ffmpeg_tpu/io/formats/ac3raw.py, held equal to it by
tests/test_torch_io_formats.py.
"""

from __future__ import annotations

from ...core.packet import Packet, PKT_FLAG_KEY
from ...formats.channel_layout import default_layout
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from ..demux import Demuxer, register_demuxer
from ..stream import CodecParameters, MediaType
from ...codecs import ac3_tables as T


def _frame_info(head: bytes):
    """→ (frame_size, sample_rate, channels, codec_id, nsamples)
    or None (ac3_parser.c:288 ff_ac3_parse_header sizing)."""
    if len(head) < 8 or head[:2] != b"\x0b\x77":
        return None
    bsid = head[5] >> 3
    if bsid > 16:
        return None
    if bsid <= 10:                      # plain AC-3
        sr_code = head[4] >> 6
        fsc = head[4] & 0x3F
        if sr_code == 3 or fsc > 37:
            return None
        sr_shift = max(bsid, 8) - 8
        acmod = head[6] >> 5
        # lfe position depends on the mix level fields; probe-level
        # nch is enough (full parse happens in the decoder)
        nch = T.CHANNELS_TAB[acmod]
        return (T.FRAME_SIZE_TAB[fsc][sr_code] * 2,
                T.SAMPLE_RATE_TAB[sr_code] >> sr_shift, nch, "ac3",
                1536)
    # E-AC-3: 11-bit frame size follows type(2)+substreamid(3)
    frame_type = head[2] >> 6
    if frame_type == 3:
        return None
    frame_size = (((head[2] & 0x07) << 8 | head[3]) + 1) * 2
    sr_code = head[4] >> 6
    if sr_code == 3:
        nblocks = 6
        rate = T.SAMPLE_RATE_TAB[(head[4] >> 4) & 3] // 2
    else:
        nblocks = (1, 2, 3, 6)[(head[4] >> 4) & 3]
        rate = T.SAMPLE_RATE_TAB[sr_code]
    acmod = (head[4] >> 1) & 7
    lfe = head[4] & 1
    return (frame_size, rate, T.CHANNELS_TAB[acmod] + lfe, "eac3",
            nblocks * 256)


@register_demuxer
class Ac3Demuxer(Demuxer):
    name = "ac3"
    long_name = "raw AC-3"
    extensions = ("ac3",)

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        good = 0
        i = 0
        while i + 8 <= len(head) and good < 4:
            fi = _frame_info(head[i:i + 8])
            if fi is None:
                break
            good += 1
            i += fi[0]
        return 55 if good >= 3 else (25 if good == 2 else 0)

    def read_header(self) -> None:
        self._resync()
        fi = _frame_info(self.r.peek(8))
        if fi is None:
            raise InvalidData("ac3: no syncframe")
        _, rate, nch, codec_id, nsamples = fi
        par = CodecParameters(
            codec_type=MediaType.AUDIO, codec_id=codec_id,
            sample_rate=rate, ch_layout=default_layout(nch),
            frame_size=nsamples)
        self.add_stream(codecpar=par, time_base=Rational(1, rate))
        self._pts = 0

    def _resync(self) -> None:
        skipped = 0
        while skipped < 65536:
            head = self.r.peek(8)
            if len(head) < 8:
                raise EndOfStream()
            if _frame_info(head) is not None:
                return
            self.r.skip(1)
            skipped += 1
        raise InvalidData("ac3: lost sync")

    def read_packet(self) -> Packet:
        self._resync()
        fi = _frame_info(self.r.peek(8))
        if fi is None:
            raise EndOfStream()
        data = self.r.read_exact(fi[0])
        pkt = Packet(data=data, pts=self._pts, dts=self._pts,
                     duration=fi[4], stream_index=0,
                     flags=PKT_FLAG_KEY, time_base=Rational(1, fi[1]))
        self._pts += fi[4]
        return pkt


@register_demuxer
class Eac3Demuxer(Ac3Demuxer):
    name = "eac3"
    long_name = "raw E-AC-3"
    extensions = ("eac3", "ec3")
