"""Packet parsers — frame-boundary detection over byte streams
(reference: libavcodec/parsers.c av_parser_parse2 surface).

A Parser consumes arbitrary byte chunks and emits complete frames.
Stateful: partial frames are buffered across feed() calls, flush()
drains the tail.

The port's copy of ffmpeg_tpu/codecs/parsers.py, held equal to it by
tests/test_torch_bsf_av1.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Type

from ..utils.error import InvalidData

_PARSERS: Dict[str, Type["Parser"]] = {}


def register_parser(cls):
    for n in (cls.name, *getattr(cls, "aliases", ())):
        _PARSERS[n] = cls
    return cls


def parser_names() -> List[str]:
    return sorted(_PARSERS)


def get_parser(codec_id: str) -> Optional["Parser"]:
    cls = _PARSERS.get(codec_id)
    return cls() if cls else None


class Parser:
    name = "?"

    def __init__(self):
        self.buf = b""

    def feed(self, data: bytes) -> List[bytes]:
        self.buf += data
        return self._split()

    def flush(self) -> List[bytes]:
        out = self._split()
        if self.buf:
            out.append(self.buf)
            self.buf = b""
        return out

    def _split(self) -> List[bytes]:
        raise NotImplementedError


class _FixedHeaderParser(Parser):
    """Sync-word + computable frame length (adts/mpegaudio/ac3 shape)."""

    MIN_HDR = 7

    def frame_len(self, hdr: bytes) -> Optional[int]:
        raise NotImplementedError

    def _split(self) -> List[bytes]:
        out = []
        while True:
            i = self._sync(self.buf)
            if i < 0:
                # keep a tail in case a syncword straddles the boundary
                self.buf = self.buf[-(self.MIN_HDR - 1):] \
                    if len(self.buf) >= self.MIN_HDR else self.buf
                return out
            if i:
                self.buf = self.buf[i:]
            if len(self.buf) < self.MIN_HDR:
                return out
            n = self.frame_len(self.buf[:self.MIN_HDR])
            if not n:
                self.buf = self.buf[1:]
                continue
            if len(self.buf) < n:
                return out
            out.append(self.buf[:n])
            self.buf = self.buf[n:]

    def _sync(self, b: bytes) -> int:
        raise NotImplementedError


@register_parser
class AdtsParser(_FixedHeaderParser):
    name = "aac"
    aliases = ("aac_adts",)
    MIN_HDR = 7

    def _sync(self, b):
        for i in range(len(b) - 1):
            if b[i] == 0xFF and (b[i + 1] & 0xF6) == 0xF0:
                return i
        return -1

    def frame_len(self, h):
        return ((h[3] & 3) << 11) | (h[4] << 3) | (h[5] >> 5)


@register_parser
class MpegAudioParser(_FixedHeaderParser):
    name = "mp3"
    aliases = ("mp2", "mp1", "mpegaudio")
    MIN_HDR = 4

    def _sync(self, b):
        for i in range(len(b) - 1):
            if b[i] == 0xFF and (b[i + 1] & 0xE0) == 0xE0:
                return i
        return -1

    def frame_len(self, h):
        from ..io.formats.mp3raw import _frame_info
        fi = _frame_info(int.from_bytes(h[:4], "big"))
        return fi[0] if fi else 0


@register_parser
class Ac3Parser(_FixedHeaderParser):
    name = "ac3"
    MIN_HDR = 6

    _FRMSIZE = None

    def _sync(self, b):
        return b.find(b"\x0b\x77")

    def frame_len(self, h):
        # A/52 table 5.18 frame sizes from fscod/frmsizecod
        fscod = h[4] >> 6
        frmsizecod = h[4] & 0x3F
        if fscod == 3 or frmsizecod >= 38:
            return 0
        bitrates = [32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192,
                    224, 256, 320, 384, 448, 512, 576, 640]
        br = bitrates[frmsizecod >> 1]
        if fscod == 0:              # 48 kHz
            return 2 * br * 2
        if fscod == 1:              # 44.1 kHz
            return 2 * (br * 96000 // 44100 + (frmsizecod & 1))
        return 3 * br * 2           # 32 kHz


class _StartCodeParser(Parser):
    """Start-code streams: split on picture/AU boundaries."""

    def _boundaries(self, b: bytes) -> List[int]:
        raise NotImplementedError

    def _split(self) -> List[bytes]:
        cuts = self._boundaries(self.buf)
        out = []
        if len(cuts) >= 2:
            for a, b in zip(cuts[:-1], cuts[1:]):
                out.append(self.buf[a:b])
            self.buf = self.buf[cuts[-1]:]
        return out


@register_parser
class MpegVideoParser(_StartCodeParser):
    """MPEG-1/2 elementary stream: one picture per packet."""

    name = "mpeg2video"
    aliases = ("mpeg1video",)

    def _boundaries(self, b):
        cuts = []
        i = 0
        while True:
            j = b.find(b"\x00\x00\x01", i)
            if j < 0 or j + 3 >= len(b):
                break
            code = b[j + 3]
            if code == 0x00 or code == 0xB3:   # picture or seq header
                if code == 0x00 or not cuts:
                    if not cuts or j > cuts[-1]:
                        cuts.append(j)
            i = j + 3
        return cuts


@register_parser
class MjpegParser(Parser):
    """SOI..EOI frame splitter."""

    name = "mjpeg"

    def _split(self):
        out = []
        while True:
            soi = self.buf.find(b"\xff\xd8")
            if soi < 0:
                self.buf = self.buf[-1:]
                return out
            eoi = self.buf.find(b"\xff\xd9", soi + 2)
            if eoi < 0:
                if soi:
                    self.buf = self.buf[soi:]
                return out
            out.append(self.buf[soi:eoi + 2])
            self.buf = self.buf[eoi + 2:]


@register_parser
class H264Parser(Parser):
    """Annex B access-unit splitter: a new AU starts at an AUD, SPS,
    or a VCL NAL with first_mb_in_slice == 0 following a VCL NAL
    (h264_parser.c heuristic subset)."""

    name = "h264"

    def _split(self):
        b = self.buf
        starts = []
        i = 0
        while True:
            j = b.find(b"\x00\x00\x01", i)
            if j < 0 or j + 3 >= len(b):
                break
            sc = j - 1 if j > 0 and b[j - 1] == 0 else j
            ntype = b[j + 3] & 0x1F
            first_mb_zero = False
            if ntype in (1, 5) and j + 4 < len(b):
                first_mb_zero = bool(b[j + 4] & 0x80)  # ue(0) = '1'
            starts.append((sc, ntype, first_mb_zero))
            i = j + 3
        cuts = []
        saw_vcl = False
        for (pos, ntype, fmz) in starts:
            if ntype == 9 or ntype in (7, 8):
                if saw_vcl:
                    cuts.append(pos)
                    saw_vcl = False
            elif ntype in (1, 5):
                if saw_vcl and fmz:
                    cuts.append(pos)
                saw_vcl = True
        out = []
        prev = 0
        for c in cuts:
            out.append(b[prev:c] if prev else b[:c])
            prev = c
        if cuts:
            self.buf = b[cuts[-1]:]
        # drop any leading garbage before the first start code
        if out and not out[0].startswith((b"\x00\x00\x01",
                                          b"\x00\x00\x00\x01")):
            k = out[0].find(b"\x00\x00\x01")
            if k > 0:
                out[0] = out[0][k - 1 if out[0][k - 1:k] == b"\x00"
                                else k:]
        return out


@register_parser
class HevcParser(Parser):
    """HEVC access-unit splitter (hevc_parser.c scope): new AU at AUD /
    VPS/SPS/PPS-after-VCL / first_slice_segment_in_pic_flag."""

    name = "hevc"
    aliases = ("h265",)

    def _split(self):
        b = self.buf
        starts = []
        i = 0
        while True:
            j = b.find(b"\x00\x00\x01", i)
            if j < 0 or j + 4 >= len(b):
                break
            sc = j - 1 if j > 0 and b[j - 1] == 0 else j
            ntype = (b[j + 3] >> 1) & 0x3F
            first_slice = False
            if ntype <= 31 and j + 5 < len(b):
                first_slice = bool(b[j + 5] & 0x80)
            starts.append((sc, ntype, first_slice))
            i = j + 3
        cuts = []
        saw_vcl = False
        for pos, ntype, first in starts:
            if ntype == 35 or ntype in (32, 33, 34):   # AUD / VPS/SPS/PPS
                if saw_vcl:
                    cuts.append(pos)
                    saw_vcl = False
            elif ntype <= 31:                           # VCL
                if saw_vcl and first:
                    cuts.append(pos)
                saw_vcl = True
        out = []
        prev = 0
        for c in cuts:
            out.append(b[prev:c] if prev else b[:c])
            prev = c
        if cuts:
            self.buf = b[cuts[-1]:]
        return out
