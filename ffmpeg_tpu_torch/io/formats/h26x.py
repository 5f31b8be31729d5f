"""Raw Annex-B H.264/HEVC/VVC demuxers (reference:
libavformat/h264dec.c, hevcdec.c, vvcdec.c raw demuxers + parser AU
splitting). Packets are access units: leading parameter sets attach
to the next VCL NAL; a new AU starts at a slice whose
first-slice-of-picture bit is set.

The port's copy of ffmpeg_tpu/io/formats/h26x.py, held equal to it by
tests/test_torch_io_formats.py.
"""

from __future__ import annotations

from ...core.packet import Packet, PKT_FLAG_KEY
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from ..demux import Demuxer, register_demuxer
from ..stream import CodecParameters, MediaType


def _nal_type(nal: bytes) -> int:
    return nal[0] & 0x1F


def _first_mb_zero(nal: bytes) -> bool:
    # ue(v) == 0 <=> first bit after the header is 1
    return len(nal) > 1 and bool(nal[1] & 0x80)


@register_demuxer
class H264RawDemuxer(Demuxer):
    name = "h264"
    long_name = "raw H.264 video (Annex B)"
    extensions = ("h264", "264", "avc")

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        i = 0
        sps = pps = idr = 0
        while True:
            j = head.find(b"\x00\x00\x01", i)
            if j < 0 or j + 4 > len(head):
                break
            t = head[j + 3] & 0x1F
            if t == 7:
                sps += 1
            elif t == 8:
                pps += 1
            elif t in (1, 5):
                idr += 1
            i = j + 3
        return 52 if (sps and pps and idr) else 0

    def read_header(self) -> None:
        chunks = []
        while not self.r.at_eof():
            b = self.r.read(1 << 20)
            if not b:
                break
            chunks.append(b)
        self._buf = b"".join(chunks)
        if b"\x00\x00\x01" not in self._buf:
            raise InvalidData("h264: no start code")
        par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="h264")
        self.add_stream(codecpar=par, time_base=Rational(1, 25))
        self._pos = 0
        self._pts = 0

    def _next_nal(self, pos):
        j = self._buf.find(b"\x00\x00\x01", pos)
        if j < 0:
            return None, len(self._buf)
        start = j + 3
        k = self._buf.find(b"\x00\x00\x01", start)
        end = len(self._buf) if k < 0 else \
            (k - 1 if k > 0 and self._buf[k - 1] == 0 else k)
        return (j, start, end), end

    def read_packet(self) -> Packet:
        if self._pos >= len(self._buf):
            raise EndOfStream()
        au_start = None
        seen_vcl = False
        pos = self._pos
        while True:
            span, nxt = self._next_nal(pos)
            if span is None:
                if au_start is None:
                    raise EndOfStream()
                end = len(self._buf)
                break
            scode, start, end_nal = span
            nal = self._buf[start:end_nal]
            t = _nal_type(nal) if nal else 0
            if au_start is None:
                au_start = scode
            if t in (1, 5):
                if seen_vcl and _first_mb_zero(nal):
                    end = scode
                    break
                seen_vcl = True
            elif seen_vcl and t in (7, 8, 9, 6):
                end = scode
                break
            pos = end_nal
        data = self._buf[au_start:end]
        self._pos = end
        pkt = Packet(data=data, pts=self._pts, dts=self._pts, duration=1,
                     stream_index=0, flags=PKT_FLAG_KEY,
                     time_base=Rational(1, 25))
        self._pts += 1
        return pkt


@register_demuxer
class VvcRawDemuxer(Demuxer):
    """Raw Annex-B VVC/H.266 (reference: libavformat/vvcdec.c). AU
    split: a new AU starts at a VCL NAL whose
    sh_picture_header_in_slice_header_flag (first payload bit) is
    set, or at a PH NAL."""

    name = "vvc"
    long_name = "raw H.266/VVC video (Annex B)"
    extensions = ("vvc", "h266", "266")

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        i = 0
        sps = pps = irap = 0
        while True:
            j = head.find(b"\x00\x00\x01", i)
            if j < 0 or j + 5 > len(head):
                break
            b0, b1 = head[j + 3], head[j + 4]
            t = (b1 >> 3) & 0x1F
            # forbidden/reserved zero, nuh_layer_id 0, tid+1 != 0
            if (b0 & 0xC0) or b0 & 0x3F or not (b1 & 7):
                i = j + 3
                continue
            if t == 15:
                sps += 1
            elif t == 16:
                pps += 1
            elif 7 <= t <= 10:                 # IDR/CRA/GDR
                irap += 1
            i = j + 3
        return 52 if (sps and pps and irap) else 0

    def read_header(self) -> None:
        chunks = []
        while not self.r.at_eof():
            b = self.r.read(1 << 20)
            if not b:
                break
            chunks.append(b)
        self._buf = b"".join(chunks)
        if b"\x00\x00\x01" not in self._buf:
            raise InvalidData("vvc: no start code")
        par = CodecParameters(codec_type=MediaType.VIDEO,
                              codec_id="vvc")
        self.add_stream(codecpar=par, time_base=Rational(1, 25))
        self._pos = 0
        self._pts = 0

    def _next_nal(self, pos):
        j = self._buf.find(b"\x00\x00\x01", pos)
        if j < 0:
            return None, len(self._buf)
        start = j + 3
        k = self._buf.find(b"\x00\x00\x01", start)
        end = len(self._buf) if k < 0 else \
            (k - 1 if k > 0 and self._buf[k - 1] == 0 else k)
        return (j, start, end), end

    def read_packet(self) -> Packet:
        if self._pos >= len(self._buf):
            raise EndOfStream()
        au_start = None
        seen_vcl = False
        pos = self._pos
        while True:
            span, nxt = self._next_nal(pos)
            if span is None:
                if au_start is None:
                    raise EndOfStream()
                end = len(self._buf)
                break
            scode, start, end_nal = span
            nal = self._buf[start:end_nal]
            t = (nal[1] >> 3) & 0x1F if len(nal) > 1 else 31
            first_slice = len(nal) > 2 and bool(nal[2] & 0x80)
            if au_start is None:
                au_start = scode
            if t <= 10:                        # VCL
                if seen_vcl and first_slice:
                    end = scode
                    break
                seen_vcl = True
            elif seen_vcl and t in (14, 15, 16, 17, 19, 20, 23):
                end = scode
                break
            pos = end_nal
        data = self._buf[au_start:end]
        self._pos = end
        pkt = Packet(data=data, pts=self._pts, dts=self._pts,
                     duration=1, stream_index=0, flags=PKT_FLAG_KEY,
                     time_base=Rational(1, 25))
        self._pts += 1
        return pkt


@register_demuxer
class HevcRawDemuxer(Demuxer):
    """Raw Annex-B HEVC (reference: libavformat/hevcdec.c). AU split:
    a new AU starts at a VCL NAL whose first_slice_segment_in_pic_flag
    (first bit after the 2-byte header) is set."""

    name = "hevc"
    long_name = "raw HEVC video (Annex B)"
    extensions = ("hevc", "h265", "265")

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        i = 0
        vps = sps = pps = irap = 0
        while True:
            j = head.find(b"\x00\x00\x01", i)
            if j < 0 or j + 5 > len(head):
                break
            b0 = head[j + 3]
            t = (b0 >> 1) & 0x3F
            if b0 & 0x81 or (head[j + 4] & 0xF8) != 0:
                i = j + 3
                continue
            if t == 32:
                vps += 1
            elif t == 33:
                sps += 1
            elif t == 34:
                pps += 1
            elif 16 <= t <= 23:
                irap += 1
            i = j + 3
        return 52 if (sps and pps and irap) else 0

    def read_header(self) -> None:
        chunks = []
        while not self.r.at_eof():
            b = self.r.read(1 << 20)
            if not b:
                break
            chunks.append(b)
        self._buf = b"".join(chunks)
        if b"\x00\x00\x01" not in self._buf:
            raise InvalidData("hevc: no start code")
        par = CodecParameters(codec_type=MediaType.VIDEO,
                              codec_id="hevc")
        self.add_stream(codecpar=par, time_base=Rational(1, 25))
        self._pos = 0
        self._pts = 0

    def _next_nal(self, pos):
        j = self._buf.find(b"\x00\x00\x01", pos)
        if j < 0:
            return None, len(self._buf)
        start = j + 3
        k = self._buf.find(b"\x00\x00\x01", start)
        end = len(self._buf) if k < 0 else \
            (k - 1 if k > 0 and self._buf[k - 1] == 0 else k)
        return (j, start, end), end

    def read_packet(self) -> Packet:
        if self._pos >= len(self._buf):
            raise EndOfStream()
        au_start = None
        seen_vcl = False
        pos = self._pos
        while True:
            span, nxt = self._next_nal(pos)
            if span is None:
                if au_start is None:
                    raise EndOfStream()
                end = len(self._buf)
                break
            scode, start, end_nal = span
            nal = self._buf[start:end_nal]
            t = (nal[0] >> 1) & 0x3F if nal else 63
            first_slice = len(nal) > 2 and bool(nal[2] & 0x80)
            if au_start is None:
                au_start = scode
            if t <= 21:                        # VCL
                if seen_vcl and first_slice:
                    end = scode
                    break
                seen_vcl = True
            elif seen_vcl and t in (32, 33, 34, 35, 39):
                end = scode
                break
            pos = end_nal
        data = self._buf[au_start:end]
        self._pos = end
        pkt = Packet(data=data, pts=self._pts, dts=self._pts, duration=1,
                     stream_index=0, flags=PKT_FLAG_KEY,
                     time_base=Rational(1, 25))
        self._pts += 1
        return pkt
