"""FLAC container demuxer (reference: libavformat/flacdec.c + flac_parser.c).

Parses the fLaC metadata blocks into extradata, then splits frames by
scanning for validated frame headers (sync + header-CRC8 check, the same
strategy the reference's flac parser uses).

The port's copy of ffmpeg_tpu/io/formats/flac.py, held equal to it by
tests/test_torch_host_codecs.py.
"""

from __future__ import annotations

import numpy as np

from ...core.packet import Packet, PKT_FLAG_KEY
from ...formats.channel_layout import default_layout
from ...utils.error import EndOfStream, InvalidData
from ..demux import Demuxer, register_demuxer, PROBE_SCORE_MAX
from ..stream import CodecParameters, MediaType

_CRC8_TABLE = None


def _crc8(data: bytes) -> int:
    global _CRC8_TABLE
    if _CRC8_TABLE is None:
        t = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
            t.append(c)
        _CRC8_TABLE = t
    crc = 0
    for b in data:
        crc = _CRC8_TABLE[crc ^ b]
    return crc


def _header_len(data: bytes, i: int) -> int:
    """Validate a frame header at i; return header length or 0."""
    if data[i] != 0xFF or (data[i + 1] & 0xFC) != 0xF8:
        return 0
    bs = data[i + 2] >> 4
    sr = data[i + 2] & 15
    ch = data[i + 3] >> 4
    bps = (data[i + 3] >> 1) & 7
    if bs == 0 or sr == 15 or ch >= 11 or bps in (3, 7):
        return 0
    j = i + 4
    # UTF-8 coded number
    b = data[j]
    j += 1
    if b >= 0x80:
        n = 0
        while b & (0x80 >> n):
            n += 1
        if n < 2 or n > 7:
            return 0
        j += n - 1
    if bs == 6:
        j += 1
    elif bs == 7:
        j += 2
    if sr == 12:
        j += 1
    elif sr in (13, 14):
        j += 2
    if j >= len(data):
        return 0
    if _crc8(data[i:j]) != data[j]:
        return 0
    return j + 1 - i


@register_demuxer
class FlacDemuxer(Demuxer):
    name = "flac"
    extensions = ("flac",)

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        return PROBE_SCORE_MAX if head[:4] == b"fLaC" else 0

    def read_header(self) -> None:
        r = self.r
        if r.read(4) != b"fLaC":
            raise InvalidData("flac: no marker")
        streaminfo = None
        while True:
            hdr = r.read_exact(4)
            last = hdr[0] >> 7
            btype = hdr[0] & 0x7F
            size = hdr[1] << 16 | hdr[2] << 8 | hdr[3]
            body = r.read_exact(size)
            if btype == 0:
                streaminfo = body
            if last:
                break
        if streaminfo is None or len(streaminfo) < 34:
            raise InvalidData("flac: no STREAMINFO")
        from ...codecs.bitstream import BitReader
        br = BitReader(streaminfo)
        br.skip(16 + 16 + 24 + 24)
        rate = br.get(20)
        channels = br.get(3) + 1
        bps = br.get(5) + 1
        total = br.get(36)
        par = CodecParameters(
            codec_type=MediaType.AUDIO, codec_id="flac",
            sample_rate=rate, ch_layout=default_layout(channels),
            bits_per_raw_sample=bps, extradata=streaminfo)
        from ...utils.rational import Rational
        st = self.add_stream(codecpar=par, time_base=Rational(1, rate))
        if total:
            st.duration = total
            self.duration = total * 1000000 // rate
        self._buf = b""
        self._pts = 0
        self._bs_cache = {}

    def _block_samples(self, frame: bytes) -> int:
        from ...codecs.bitstream import BitReader
        br = BitReader(frame)
        br.skip(16)
        bs_code = br.get(4)
        br.skip(4 + 4 + 3 + 1)
        # utf8
        b = br.get(8)
        if b >= 0x80:
            n = 0
            while b & (0x80 >> n):
                n += 1
            for _ in range(n - 1):
                br.get(8)
        if bs_code == 6:
            return br.get(8) + 1
        if bs_code == 7:
            return br.get(16) + 1
        from ...codecs.flac import _BLOCKSIZES
        return _BLOCKSIZES[bs_code]

    def read_packet(self) -> Packet:
        # accumulate enough data, find the NEXT header after position 0
        while True:
            if len(self._buf) >= 16 and _header_len(self._buf, 0):
                nxt = self._find_next(4)
                if nxt is not None:
                    frame, self._buf = self._buf[:nxt], self._buf[nxt:]
                    return self._emit(frame)
            chunk = self.r.read(1 << 16)
            if not chunk:
                if self._buf and _header_len(self._buf + b"\x00" * 16, 0):
                    frame, self._buf = self._buf, b""
                    return self._emit(frame)
                if self._buf.strip(b"\x00"):
                    self._buf = b""
                raise EndOfStream()
            self._buf += chunk

    def _find_next(self, start: int):
        data = self._buf
        i = start
        limit = len(data) - 16
        while i < limit:
            if data[i] == 0xFF and (data[i + 1] & 0xFC) == 0xF8 and \
                    _header_len(data, i):
                return i
            i += 1
        return None

    def _emit(self, frame: bytes) -> Packet:
        n = self._block_samples(frame)
        pkt = Packet(data=frame, pts=self._pts, dts=self._pts, duration=n,
                     flags=PKT_FLAG_KEY, time_base=self.streams[0].time_base)
        self._pts += n
        return pkt
