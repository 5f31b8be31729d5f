"""Matroska/WebM demuxer (reference: libavformat/matroskadec.c, 5.1k LoC).

EBML parse of Segment → Tracks/Info → Clusters → SimpleBlocks/BlockGroups,
with lacing (Xiph/fixed/EBML) and per-track codec private → extradata.

The port's copy of ffmpeg_tpu/io/formats/matroska.py, held equal to it
by tests/test_torch_io_formats.py.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ...core.packet import Packet, PKT_FLAG_KEY
from ...formats.channel_layout import default_layout
from ...utils.error import EndOfStream, InvalidData, NotSupported
from ...utils.rational import NOPTS, Rational
from ..demux import Demuxer, register_demuxer, PROBE_SCORE_MAX
from ..stream import CodecParameters, MediaType

# EBML ids
EBML_HEADER = 0x1A45DFA3
SEGMENT = 0x18538067
INFO = 0x1549A966
TIMESTAMP_SCALE = 0x2AD7B1
TRACKS = 0x1654AE6B
TRACK_ENTRY = 0xAE
TRACK_NUMBER = 0xD7
TRACK_TYPE = 0x83
CODEC_ID = 0x86
CODEC_PRIVATE = 0x63A2
DEFAULT_DURATION = 0x23E383
CODEC_DELAY = 0x56AA
SEEK_PREROLL = 0x56BB
VIDEO = 0xE0
COLOUR = 0x55B0
PIXEL_WIDTH = 0xB0
PIXEL_HEIGHT = 0xBA
AUDIO = 0xE1
SAMPLING_FREQ = 0xB5
OUT_SAMPLING_FREQ = 0x78B5
CHANNELS = 0x9F
BIT_DEPTH = 0x6264
CLUSTER = 0x1F43B675
CLUSTER_TIMESTAMP = 0xE7
SIMPLE_BLOCK = 0xA3
BLOCK_GROUP = 0xA0
BLOCK = 0xA1
BLOCK_DURATION = 0x9B
REFERENCE_BLOCK = 0xFB
DURATION = 0x4489
SEEK_HEAD = 0x114D9B74
CUES = 0x1C53BB6B

_CODEC_MAP = {
    "V_MPEG4/ISO/AVC": "h264", "V_MPEGH/ISO/HEVC": "hevc",
    "V_VP8": "vp8", "V_VP9": "vp9", "V_AV1": "av1",
    "V_MPEG4/ISO/ASP": "mpeg4", "V_MPEG4/ISO/SP": "mpeg4",
    "V_MPEG2": "mpeg2video", "V_MPEG1": "mpeg1video",
    "V_MJPEG": "mjpeg", "V_THEORA": "theora",
    "V_FFV1": "ffv1", "V_PRORES": "prores",
    "V_UNCOMPRESSED": "rawvideo",
    "A_AAC": "aac", "A_MPEG/L3": "mp3", "A_MPEG/L2": "mp2",
    "A_AC3": "ac3", "A_EAC3": "eac3", "A_DTS": "dts",
    "A_VORBIS": "vorbis", "A_OPUS": "opus", "A_FLAC": "flac",
    "A_ALAC": "alac", "A_TRUEHD": "truehd",
    "A_PCM/INT/LIT": "pcm_s16le", "A_PCM/INT/BIG": "pcm_s16be",
    "A_PCM/FLOAT/IEEE": "pcm_f32le", "A_MS/ACM": "ms_acm",
    "S_TEXT/UTF8": "subrip", "S_TEXT/ASS": "ass", "S_HDMV/PGS": "pgssub",
    "S_TEXT/WEBVTT": "webvtt",
}


@dataclass
class _Track:
    number: int = 0
    type: int = 0
    codec_id: str = ""
    codec_private: bytes = b""
    default_duration: int = 0
    codec_delay: int = 0          # ns
    width: int = 0
    height: int = 0
    sample_rate: float = 0.0
    channels: int = 1
    bit_depth: int = 16
    stream_index: int = -1
    colour: dict = None           # Colour element fields
    mastering: dict = None        # MasteringMetadata
    max_cll: int = 0
    max_fall: int = 0


class _Ebml:
    """EBML primitive reader over avio."""

    def __init__(self, r):
        self.r = r

    def read_id(self) -> Optional[int]:
        b0 = self.r.read(1)
        if not b0:
            return None
        b = b0[0]
        if b & 0x80:
            n = 1
        elif b & 0x40:
            n = 2
        elif b & 0x20:
            n = 3
        elif b & 0x10:
            n = 4
        else:
            raise InvalidData("ebml: bad id")
        v = b
        for _ in range(n - 1):
            v = v << 8 | self.r.read_exact(1)[0]
        return v

    def read_size(self) -> int:
        b = self.r.read_exact(1)[0]
        mask = 0x80
        n = 1
        while n <= 8 and not (b & mask):
            mask >>= 1
            n += 1
        if n > 8:
            raise InvalidData("ebml: bad size")
        v = b & (mask - 1)
        unknown = (b & ~((b & (mask - 1)) | mask)) == 0 and (b & (mask - 1)) == mask - 1
        for _ in range(n - 1):
            nb = self.r.read_exact(1)[0]
            v = v << 8 | nb
        # unknown-size element: all value bits set
        if v == (1 << (7 * n)) - 1:
            return -1
        return v

    def read_uint(self, size: int) -> int:
        v = 0
        for b in self.r.read_exact(size):
            v = v << 8 | b
        return v

    def read_float(self, size: int) -> float:
        data = self.r.read_exact(size)
        if size == 4:
            return struct.unpack(">f", data)[0]
        if size == 8:
            return struct.unpack(">d", data)[0]
        if size == 0:
            return 0.0
        raise InvalidData("ebml: bad float size")


@register_demuxer
class MatroskaDemuxer(Demuxer):
    name = "matroska"
    long_name = "Matroska / WebM"
    extensions = ("mkv", "webm", "mka", "mk3d")

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        return PROBE_SCORE_MAX if head[:4] == b"\x1aE\xdf\xa3" else 0

    def read_header(self) -> None:
        self.e = _Ebml(self.r)
        self._timescale = 1000000      # ns per tick
        self._tracks: Dict[int, _Track] = {}
        self._queue: List[Packet] = []
        self._cluster_ts = 0
        self._segment_end = None

        # EBML header
        eid = self.e.read_id()
        if eid != EBML_HEADER:
            raise InvalidData("matroska: no EBML header")
        self.r.skip(self.e.read_size())
        # Segment
        eid = self.e.read_id()
        if eid != SEGMENT:
            raise InvalidData("matroska: no Segment")
        seg_size = self.e.read_size()
        if seg_size >= 0:
            self._segment_end = self.r.tell() + seg_size
        # parse until first cluster
        while True:
            pos = self.r.tell()
            eid = self.e.read_id()
            if eid is None:
                break
            size = self.e.read_size()
            if eid == INFO:
                self._parse_info(self.r.tell() + size)
            elif eid == TRACKS:
                self._parse_tracks(self.r.tell() + size)
            elif eid == CLUSTER:
                self._cluster_end = self.r.tell() + size if size >= 0 else None
                self._in_cluster = True
                break
            else:
                if size < 0:
                    raise InvalidData("matroska: unknown-size non-cluster")
                self.r.skip(size)
        self._finalize_streams()

    def _parse_info(self, end: int) -> None:
        dur_ticks = None
        while self.r.tell() < end:
            eid = self.e.read_id()
            size = self.e.read_size()
            if eid == TIMESTAMP_SCALE:
                self._timescale = self.e.read_uint(size)
            elif eid == DURATION:
                dur_ticks = self.e.read_float(size)
            else:
                self.r.skip(size)
        if dur_ticks:
            self.duration = int(dur_ticks * self._timescale // 1000)

    def _parse_tracks(self, end: int) -> None:
        while self.r.tell() < end:
            eid = self.e.read_id()
            size = self.e.read_size()
            if eid == TRACK_ENTRY:
                self._parse_track_entry(self.r.tell() + size)
            else:
                self.r.skip(size)

    def _parse_track_entry(self, end: int) -> None:
        t = _Track()
        while self.r.tell() < end:
            eid = self.e.read_id()
            size = self.e.read_size()
            if eid == TRACK_NUMBER:
                t.number = self.e.read_uint(size)
            elif eid == TRACK_TYPE:
                t.type = self.e.read_uint(size)
            elif eid == CODEC_ID:
                t.codec_id = self.r.read_exact(size).decode("ascii", "replace")
            elif eid == CODEC_PRIVATE:
                t.codec_private = self.r.read_exact(size)
            elif eid == DEFAULT_DURATION:
                t.default_duration = self.e.read_uint(size)
            elif eid == CODEC_DELAY:
                t.codec_delay = self.e.read_uint(size)
            elif eid == VIDEO:
                vend = self.r.tell() + size
                while self.r.tell() < vend:
                    vid = self.e.read_id()
                    vsize = self.e.read_size()
                    if vid == PIXEL_WIDTH:
                        t.width = self.e.read_uint(vsize)
                    elif vid == PIXEL_HEIGHT:
                        t.height = self.e.read_uint(vsize)
                    elif vid == COLOUR:
                        self._parse_colour(t, self.r.tell() + vsize)
                    else:
                        self.r.skip(vsize)
            elif eid == AUDIO:
                aend = self.r.tell() + size
                while self.r.tell() < aend:
                    aid = self.e.read_id()
                    asize = self.e.read_size()
                    if aid in (SAMPLING_FREQ, OUT_SAMPLING_FREQ):
                        t.sample_rate = self.e.read_float(asize)
                    elif aid == CHANNELS:
                        t.channels = self.e.read_uint(asize)
                    elif aid == BIT_DEPTH:
                        t.bit_depth = self.e.read_uint(asize)
                    else:
                        self.r.skip(asize)
            else:
                self.r.skip(size)
        self._tracks[t.number] = t

    _MATRIX = {0: "rgb", 1: "bt709", 4: "fcc", 5: "bt470bg",
               6: "smpte170m", 7: "smpte240m", 9: "bt2020nc",
               10: "bt2020c"}
    _TRC = {1: "bt709", 6: "smpte170m", 7: "smpte240m", 8: "linear",
            13: "iec61966-2-1", 14: "bt2020-10", 15: "bt2020-12",
            16: "smpte2084", 18: "arib-std-b67"}
    _PRIM = {1: "bt709", 5: "bt470bg", 6: "smpte170m",
             7: "smpte240m", 9: "bt2020", 11: "smpte431",
             12: "smpte432"}

    def _parse_colour(self, t, end: int) -> None:
        """Colour element (Matroska v4 / matroskadec.c colour
        handling): CICP codes + mastering display metadata."""
        c = {}
        md = {}
        while self.r.tell() < end:
            cid = self.e.read_id()
            csize = self.e.read_size()
            if cid == 0x55B1:
                c["matrix"] = self.e.read_uint(csize)
            elif cid == 0x55B9:
                c["range"] = self.e.read_uint(csize)
            elif cid == 0x55BA:
                c["trc"] = self.e.read_uint(csize)
            elif cid == 0x55BB:
                c["primaries"] = self.e.read_uint(csize)
            elif cid == 0x55BC:
                t.max_cll = self.e.read_uint(csize)
            elif cid == 0x55BD:
                t.max_fall = self.e.read_uint(csize)
            elif cid == 0x55D0:
                mend = self.r.tell() + csize
                keys = {0x55D1: "rx", 0x55D2: "ry", 0x55D3: "gx",
                        0x55D4: "gy", 0x55D5: "bx", 0x55D6: "by",
                        0x55D7: "wx", 0x55D8: "wy",
                        0x55D9: "max_luminance",
                        0x55DA: "min_luminance"}
                while self.r.tell() < mend:
                    mid = self.e.read_id()
                    msize = self.e.read_size()
                    if mid in keys:
                        md[keys[mid]] = self.e.read_float(msize)
                    else:
                        self.r.skip(msize)
            else:
                self.r.skip(csize)
        t.colour = c
        if md:
            t.mastering = md

    def _finalize_streams(self) -> None:
        for num in sorted(self._tracks):
            t = self._tracks[num]
            codec = _CODEC_MAP.get(t.codec_id, t.codec_id.lower())
            ctype = {1: MediaType.VIDEO, 2: MediaType.AUDIO,
                     17: MediaType.SUBTITLE}.get(t.type, MediaType.DATA)
            par = CodecParameters(codec_type=ctype, codec_id=codec,
                                  extradata=t.codec_private)
            if ctype == MediaType.VIDEO:
                par.width = t.width
                par.height = t.height
                if t.colour:
                    c = t.colour
                    par.color_space = self._MATRIX.get(
                        c.get("matrix", -1), par.color_space)
                    par.color_trc = self._TRC.get(
                        c.get("trc", -1), par.color_trc)
                    par.color_primaries = self._PRIM.get(
                        c.get("primaries", -1), par.color_primaries)
                    rng = c.get("range")
                    if rng == 1:
                        par.color_range = "tv"
                    elif rng == 2:
                        par.color_range = "pc"
                if t.mastering:
                    par.mastering_display = dict(t.mastering)
                if t.max_cll or t.max_fall:
                    par.content_light = {"max_cll": t.max_cll,
                                         "max_fall": t.max_fall}
                if t.default_duration:
                    par.framerate = Rational(1000000000, t.default_duration).reduce()
            elif ctype == MediaType.AUDIO:
                par.sample_rate = int(t.sample_rate)
                par.ch_layout = default_layout(t.channels)
                par.bits_per_coded_sample = t.bit_depth
            # timestamps are in timescale ticks (default: ms)
            st = self.add_stream(codecpar=par,
                                 time_base=Rational(self._timescale, 1000000000).reduce())
            t.stream_index = st.index

    # ------------------------------------------------------------------ packets
    def read_packet(self) -> Packet:
        while not self._queue:
            self._parse_more()
        return self._queue.pop(0)

    def _parse_more(self) -> None:
        r = self.r
        if r.at_eof():
            raise EndOfStream()
        eid = self.e.read_id()
        if eid is None:
            raise EndOfStream()
        size = self.e.read_size()
        if eid == CLUSTER:
            return            # descend
        if eid == CLUSTER_TIMESTAMP:
            self._cluster_ts = self.e.read_uint(size)
        elif eid == SIMPLE_BLOCK:
            self._parse_block(r.read_exact(size), None, keyflag_from_block=True)
        elif eid == BLOCK_GROUP:
            end = r.tell() + size
            block = None
            has_ref = False
            duration = 0
            while r.tell() < end:
                bid = self.e.read_id()
                bsize = self.e.read_size()
                if bid == BLOCK:
                    block = r.read_exact(bsize)
                elif bid == REFERENCE_BLOCK:
                    has_ref = True
                    r.skip(bsize)
                elif bid == BLOCK_DURATION:
                    duration = self.e.read_uint(bsize)
                else:
                    r.skip(bsize)
            if block:
                self._parse_block(block, not has_ref, duration=duration)
        else:
            if size < 0:
                raise InvalidData("matroska: unknown size element in cluster")
            r.skip(size)

    def _parse_block(self, data: bytes, key: Optional[bool],
                     keyflag_from_block: bool = False, duration: int = 0) -> None:
        # track number (EBML vint)
        b = data[0]
        mask = 0x80
        n = 1
        while n <= 8 and not (b & mask):
            mask >>= 1
            n += 1
        tnum = b & (mask - 1)
        for i in range(1, n):
            tnum = tnum << 8 | data[i]
        i = n
        rel_ts = struct.unpack(">h", data[i:i + 2])[0]
        flags = data[i + 2]
        i += 3
        if keyflag_from_block:
            key = bool(flags & 0x80)
        lacing = (flags >> 1) & 3
        t = self._tracks.get(tnum)
        if t is None or t.stream_index < 0:
            return
        ts = self._cluster_ts + rel_ts
        if t.codec_delay:
            ts -= t.codec_delay // self._timescale

        payloads: List[bytes] = []
        if lacing == 0:
            payloads = [data[i:]]
        else:
            nframes = data[i] + 1
            i += 1
            sizes = []
            if lacing == 2:      # fixed
                total = len(data) - i
                each = total // nframes
                sizes = [each] * nframes
            elif lacing == 1:    # Xiph
                for _ in range(nframes - 1):
                    v = 0
                    while True:
                        v += data[i]
                        if data[i] != 255:
                            i += 1
                            break
                        i += 1
                    sizes.append(v)
                sizes.append(len(data) - i - sum(sizes))
            else:                # EBML lacing
                # first size: vint
                b0 = data[i]
                mask = 0x80
                ln = 1
                while not (b0 & mask):
                    mask >>= 1
                    ln += 1
                v = b0 & (mask - 1)
                for k in range(1, ln):
                    v = v << 8 | data[i + k]
                i += ln
                sizes.append(v)
                for _ in range(nframes - 2):
                    b0 = data[i]
                    mask = 0x80
                    ln = 1
                    while not (b0 & mask):
                        mask >>= 1
                        ln += 1
                    sv = b0 & (mask - 1)
                    for k in range(1, ln):
                        sv = sv << 8 | data[i + k]
                    i += ln
                    # signed vint delta
                    sv -= (1 << (7 * ln - 1)) - 1
                    sizes.append(sizes[-1] + sv)
                sizes.append(len(data) - i - sum(sizes))
            for s in sizes:
                payloads.append(data[i:i + s])
                i += s

        st = self.streams[t.stream_index]
        dur_ticks = duration or (
            t.default_duration * st.time_base.den //
            (st.time_base.num * 1000000000) if t.default_duration else 0)
        step = dur_ticks if dur_ticks else 0
        for j, payload in enumerate(payloads):
            self._queue.append(Packet(
                data=payload, pts=ts + j * step, dts=NOPTS,
                duration=step, stream_index=t.stream_index,
                flags=PKT_FLAG_KEY if key or t.type == 2 else 0,
                time_base=st.time_base))
