"""MP4 / MOV / ISO-BMFF demuxer (reference: libavformat/mov.c, ~12.5k LoC;
this covers the sample-table core: moov box tree → flattened per-sample
index → packets in interleaved file order, plus fragmented (moof) files).

Design difference from the reference: instead of lazily walking stbl
chunk/sample structures per read, we flatten each trak's sample tables
into numpy arrays at open time (offset, size, dts, cts, keyflag) and merge
all tracks into one file-order index — simpler, O(1) per packet, and seek
is a binary search.

The port's copy of ffmpeg_tpu/io/formats/mov.py, held equal to it by
tests/test_torch_io_formats.py.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...core.packet import Packet, PKT_FLAG_KEY
from ...formats.channel_layout import default_layout
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import NOPTS, Rational
from ..demux import Demuxer, register_demuxer, PROBE_SCORE_MAX
from ..stream import CodecParameters, MediaType

_VIDEO_TAGS = {
    b"avc1": "h264", b"avc3": "h264", b"hvc1": "hevc", b"hev1": "hevc",
    b"vp08": "vp8", b"vp09": "vp9", b"av01": "av1",
    b"mp4v": "mpeg4", b"jpeg": "mjpeg", b"mjpa": "mjpeg", b"mjpb": "mjpeg",
    b"png ": "png", b"apcn": "prores", b"apch": "prores", b"apcs": "prores",
    b"apco": "prores", b"ap4h": "prores", b"ap4x": "prores",
    b"AVdn": "dnxhd", b"FFV1": "ffv1", b"raw ": "rawvideo",
    b"v210": "v210", b"gif ": "gif",
}
_AUDIO_TAGS = {
    b"mp4a": "aac", b"alac": "alac", b"ac-3": "ac3", b"ec-3": "eac3",
    b"Opus": "opus", b"fLaC": "flac", b"mp3 ": "mp3", b".mp3": "mp3",
    b"sowt": "pcm_s16le", b"twos": "pcm_s16be", b"lpcm": "pcm_s16le",
    b"fl32": "pcm_f32be", b"fl64": "pcm_f64be", b"in24": "pcm_s24be",
    b"in32": "pcm_s32be", b"raw ": "pcm_u8", b"ulaw": "pcm_mulaw",
    b"alaw": "pcm_alaw", b"samr": "amr_nb",
}
_SUB_TAGS = {
    b"tx3g": "mov_text", b"text": "mov_text",
    b"mp4s": "dvd_subtitle",
}
_OBJECT_TYPES = {          # esds objectTypeIndication → codec (mp4 registry)
    0x40: "aac", 0x66: "aac", 0x67: "aac", 0x68: "aac",
    0x69: "mp3", 0x6B: "mp3", 0x20: "mpeg4", 0x21: "h264", 0x23: "hevc",
    0x60: "mpeg2video", 0x61: "mpeg2video", 0x62: "mpeg2video",
    0x63: "mpeg2video", 0x64: "mpeg2video", 0x65: "mpeg2video",
    0x6A: "mpeg1video", 0x6C: "mjpeg", 0x6D: "png",
    0xDD: "vorbis", 0xA9: "dts", 0xA5: "ac3",
}


@dataclass
class _Track:
    index: int
    codecpar: CodecParameters = field(default_factory=CodecParameters)
    timescale: int = 1000
    duration: int = 0
    # flattened tables
    offsets: Optional[np.ndarray] = None
    sizes: Optional[np.ndarray] = None
    dts: Optional[np.ndarray] = None
    cts_off: Optional[np.ndarray] = None
    keys: Optional[np.ndarray] = None
    # raw boxes pending flatten
    stts: list = field(default_factory=list)
    ctts: list = field(default_factory=list)
    stsc: list = field(default_factory=list)
    stsz: Optional[np.ndarray] = None
    stco: Optional[np.ndarray] = None
    stss: Optional[np.ndarray] = None
    edit_offset: int = 0       # media time shift from elst


class _Box:
    __slots__ = ("type", "start", "size", "end")

    def __init__(self, type_, start, size):
        self.type = type_
        self.start = start
        self.size = size
        self.end = start + size


@register_demuxer
class MovDemuxer(Demuxer):
    name = "mov"
    long_name = "QuickTime / MOV / MP4 / ISO-BMFF"
    extensions = ("mp4", "mov", "m4a", "m4v", "3gp", "mj2", "qt")

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        if len(head) >= 12:
            tag = head[4:8]
            if tag in (b"ftyp", b"moov", b"mdat", b"free", b"wide", b"skip",
                       b"pnot", b"moof", b"styp"):
                return PROBE_SCORE_MAX
        return 0

    # ------------------------------------------------------------------ header
    def read_header(self) -> None:
        self._tracks: List[_Track] = []
        self._timescale = 1000
        self._have_moov = False
        self._frag_samples: List[tuple] = []   # fragmented mode
        self._trex: Dict[int, tuple] = {}      # track_id → defaults
        self._track_by_id: Dict[int, _Track] = {}

        size = self.r.size
        pos = 0
        while True:
            box = self._read_box_header(pos)
            if box is None:
                break
            if box.type == b"moov":
                self._parse_container(box, self._parse_moov_child)
                self._have_moov = True
            elif box.type == b"moof":
                self._parse_moof(box)
            elif box.type == b"sidx":
                pass
            pos = box.end
            if size is not None and pos >= size:
                break
        if not self._have_moov:
            raise InvalidData("mov: no moov box")
        self._finalize()

    def _read_box_header(self, pos: int) -> Optional[_Box]:
        # global budget: corrupted sizes can make nested container
        # walks quadratic in the file size (mov.c guards similarly);
        # real files have a few hundred boxes
        self._box_budget = getattr(self, "_box_budget", 100000) - 1
        if self._box_budget < 0:
            raise InvalidData("mov: too many boxes (corrupt sizes)")
        try:
            self.r.seek(pos)
            hdr = self.r.read(8)
        except Exception:
            return None
        if len(hdr) < 8:
            return None
        size = struct.unpack(">I", hdr[:4])[0]
        typ = hdr[4:8]
        start = pos + 8
        if size == 1:
            size = struct.unpack(">Q", self.r.read_exact(8))[0]
            start = pos + 16
            size -= 16
        elif size == 0:
            size = (self.r.size or 0) - pos - 8
        else:
            size -= 8
        return _Box(typ, start, size)

    def _parse_container(self, box: _Box, child_fn) -> None:
        pos = box.start
        while pos + 8 <= box.end:
            child = self._read_box_header(pos)
            if child is None or child.size < 0:
                break
            child_fn(child)
            pos = child.end

    # --- moov children --------------------------------------------------------
    def _parse_moov_child(self, box: _Box) -> None:
        if box.type == b"mvhd":
            self.r.seek(box.start)
            ver = self.r.u8()
            self.r.skip(3)
            if ver == 1:
                self.r.skip(16)
                self._timescale = self.r.rb32()
                dur = self.r.rb64()
            else:
                self.r.skip(8)
                self._timescale = self.r.rb32()
                dur = self.r.rb32()
            if self._timescale:
                self.duration = dur * 1000000 // self._timescale
        elif box.type == b"trak":
            self._cur = _Track(index=len(self._tracks))
            self._tracks.append(self._cur)
            self._parse_container(box, self._parse_trak_child)
        elif box.type == b"mvex":
            self._parse_container(box, self._parse_mvex_child)
        elif box.type == b"udta":
            pass

    def _parse_mvex_child(self, box: _Box) -> None:
        if box.type == b"trex":
            self.r.seek(box.start)
            self.r.skip(4)
            track_id = self.r.rb32()
            self.r.skip(4)  # default sample description index
            d_dur = self.r.rb32()
            d_size = self.r.rb32()
            d_flags = self.r.rb32()
            self._trex[track_id] = (d_dur, d_size, d_flags)

    def _parse_trak_child(self, box: _Box) -> None:
        t = self._cur
        if box.type == b"tkhd":
            self.r.seek(box.start)
            ver = self.r.u8()
            self.r.skip(3)
            self.r.skip(16 if ver == 1 else 8)
            track_id = self.r.rb32()
            self._track_by_id[track_id] = t
        elif box.type == b"mdia":
            self._parse_container(box, self._parse_trak_child)
        elif box.type == b"mdhd":
            self.r.seek(box.start)
            ver = self.r.u8()
            self.r.skip(3)
            if ver == 1:
                self.r.skip(16)
                t.timescale = self.r.rb32()
                t.duration = self.r.rb64()
            else:
                self.r.skip(8)
                t.timescale = self.r.rb32()
                t.duration = self.r.rb32()
        elif box.type == b"hdlr":
            self.r.seek(box.start)
            self.r.skip(8)
            handler = self.r.read(4)
            mt = {
                b"vide": MediaType.VIDEO, b"soun": MediaType.AUDIO,
                b"text": MediaType.SUBTITLE, b"sbtl": MediaType.SUBTITLE,
                b"subp": MediaType.SUBTITLE,
            }.get(handler)
            # QuickTime movs carry a second hdlr (the data handler,
            # e.g. 'dhlr'/'alis') inside minf — ignore unknown handlers
            if mt is not None:
                t.codecpar.codec_type = mt
        elif box.type == b"minf":
            self._parse_container(box, self._parse_trak_child)
        elif box.type == b"stbl":
            self._parse_container(box, self._parse_stbl_child)
        elif box.type == b"edts":
            self._parse_container(box, self._parse_edts_child)

    def _parse_edts_child(self, box: _Box) -> None:
        if box.type != b"elst":
            return
        t = self._cur
        self.r.seek(box.start)
        ver = self.r.u8()
        self.r.skip(3)
        n = self.r.rb32()
        for _ in range(n):
            if ver == 1:
                seg_dur = self.r.rb64()
                media_time = struct.unpack(">q", self.r.read_exact(8))[0]
            else:
                seg_dur = self.r.rb32()
                media_time = struct.unpack(">i", self.r.read_exact(4))[0]
            self.r.skip(4)
            if media_time >= 0:
                t.edit_offset = media_time
                break

    # --- stbl -------------------------------------------------------------------
    def _parse_stbl_child(self, box: _Box) -> None:
        t = self._cur
        r = self.r
        if box.type == b"stsd":
            r.seek(box.start)
            r.skip(4)
            n = r.rb32()
            if n >= 1:
                self._parse_sample_entry(box.start + 8, t)
        elif box.type == b"stts":
            r.seek(box.start)
            r.skip(4)
            n = r.rb32()
            raw = np.frombuffer(r.read_exact(n * 8), ">u4").reshape(n, 2)
            t.stts = raw.astype(np.int64)
        elif box.type == b"ctts":
            r.seek(box.start)
            r.skip(4)
            n = r.rb32()
            raw = np.frombuffer(r.read_exact(n * 8), ">u4").reshape(n, 2)
            cnt = raw[:, 0].astype(np.int64)
            off = raw[:, 1].astype(np.int64)
            off = np.where(off >= 1 << 31, off - (1 << 32), off)  # signed v0
            t.ctts = (cnt, off)
        elif box.type == b"stsc":
            r.seek(box.start)
            r.skip(4)
            n = r.rb32()
            raw = np.frombuffer(r.read_exact(n * 12), ">u4").reshape(n, 3)
            t.stsc = raw.astype(np.int64)
        elif box.type == b"stsz":
            r.seek(box.start)
            r.skip(4)
            fixed = r.rb32()
            n = r.rb32()
            if fixed:
                t.stsz = np.full(n, fixed, np.int64)
            else:
                t.stsz = np.frombuffer(r.read_exact(n * 4), ">u4").astype(np.int64)
        elif box.type == b"stco":
            r.seek(box.start)
            r.skip(4)
            n = r.rb32()
            t.stco = np.frombuffer(r.read_exact(n * 4), ">u4").astype(np.int64)
        elif box.type == b"co64":
            r.seek(box.start)
            r.skip(4)
            n = r.rb32()
            t.stco = np.frombuffer(r.read_exact(n * 8), ">u8").astype(np.int64)
        elif box.type == b"stss":
            r.seek(box.start)
            r.skip(4)
            n = r.rb32()
            t.stss = np.frombuffer(r.read_exact(n * 4), ">u4").astype(np.int64) - 1

    def _parse_sample_entry(self, pos: int, t: _Track) -> None:
        r = self.r
        r.seek(pos)
        size = r.rb32()
        fmt = r.read(4)
        end = pos + size
        par = t.codecpar
        par.codec_tag = struct.unpack(">I", fmt)[0]
        r.skip(6 + 2)  # reserved + data_reference_index
        if par.codec_type == MediaType.VIDEO:
            par.codec_id = _VIDEO_TAGS.get(fmt, fmt.decode("latin1").strip())
            r.skip(16)
            par.width = r.rb16()
            par.height = r.rb16()
            r.skip(4 + 4 + 4 + 2 + 32)
            par.bits_per_coded_sample = r.rb16()
            r.skip(2)
            self._parse_extensions(r.tell(), end, t)
        elif par.codec_type == MediaType.AUDIO:
            par.codec_id = _AUDIO_TAGS.get(fmt, fmt.decode("latin1").strip())
            version = r.rb16()
            r.skip(6)
            channels = r.rb16()
            par.bits_per_coded_sample = r.rb16()
            r.skip(4)
            par.sample_rate = r.rb32() >> 16
            if version == 1:
                r.skip(16)
            elif version == 2:
                r.skip(4)
                rate = struct.unpack(">d", r.read_exact(8))[0]
                par.sample_rate = int(rate)
                channels = r.rb32()
                r.skip(20)
            par.ch_layout = default_layout(channels or 1)
            self._parse_extensions(r.tell(), end, t)
        else:
            par.codec_id = _SUB_TAGS.get(
                fmt, fmt.decode("latin1").strip())
            if par.codec_id == "mov_text":
                # tx3g sample entry body = decoder extradata
                r.seek(pos + 16)
                par.extradata = r.read(max(0, end - pos - 16))

    def _parse_extensions(self, pos: int, end: int, t: _Track) -> None:
        """avcC / hvcC / esds / dfLa / dOps... → extradata."""
        r = self.r
        par = t.codecpar
        while pos + 8 <= end:
            r.seek(pos)
            size = r.rb32()
            typ = r.read(4)
            if size < 8:
                break
            body_end = pos + size
            if typ in (b"avcC", b"hvcC", b"vpcC", b"av1C", b"dfLa", b"dOps",
                       b"alac", b"glbl"):
                par.extradata = r.read(size - 8)
            elif typ == b"esds":
                data = r.read(size - 8)
                self._parse_esds(data, par)
            elif typ == b"wave":
                self._parse_extensions(pos + 8, body_end, t)
            elif typ == b"pasp":
                h = r.rb32()
                v = r.rb32()
                if v:
                    par.sample_aspect_ratio = Rational(h, v)
            pos = body_end

    @staticmethod
    def _parse_esds(data: bytes, par: CodecParameters) -> None:
        i = 4  # version/flags
        n = len(data)

        def read_descr(i) -> Tuple[int, int, int]:
            tag = data[i]
            i += 1
            ln = 0
            for _ in range(4):
                b = data[i]
                i += 1
                ln = (ln << 7) | (b & 0x7F)
                if not b & 0x80:
                    break
            return tag, ln, i

        while i < n:
            tag, ln, i = read_descr(i)
            if tag == 0x03:      # ES_Descriptor
                i += 3
            elif tag == 0x04:    # DecoderConfig
                oti = data[i]
                par.codec_id = _OBJECT_TYPES.get(oti, par.codec_id)
                i += 13
            elif tag == 0x05:    # DecoderSpecificInfo
                par.extradata = data[i:i + ln]
                return
            else:
                i += ln

    # ------------------------------------------------------------------ moof
    def _parse_moof(self, moof: _Box) -> None:
        self._moof_start = moof.start - 8
        self._parse_container(moof, self._parse_moof_child)

    def _parse_moof_child(self, box: _Box) -> None:
        if box.type == b"traf":
            self._traf = {"base": self._moof_start, "track": None,
                          "dts": 0, "d_dur": 0, "d_size": 0, "d_flags": 0}
            self._parse_container(box, self._parse_traf_child)

    def _parse_traf_child(self, box: _Box) -> None:
        r = self.r
        tf = self._traf
        if box.type == b"tfhd":
            r.seek(box.start)
            flags = r.rb32() & 0xFFFFFF
            track_id = r.rb32()
            tf["track"] = self._track_by_id.get(track_id)
            d = self._trex.get(track_id, (0, 0, 0))
            tf["d_dur"], tf["d_size"], tf["d_flags"] = d
            if flags & 0x01:
                tf["base"] = r.rb64()
            if flags & 0x02:
                r.skip(4)
            if flags & 0x08:
                tf["d_dur"] = r.rb32()
            if flags & 0x10:
                tf["d_size"] = r.rb32()
            if flags & 0x20:
                tf["d_flags"] = r.rb32()
        elif box.type == b"tfdt":
            r.seek(box.start)
            ver = r.u8()
            r.skip(3)
            tf["dts"] = r.rb64() if ver == 1 else r.rb32()
        elif box.type == b"trun":
            t = tf["track"]
            if t is None:
                return
            r.seek(box.start)
            flags = r.rb32() & 0xFFFFFF
            count = r.rb32()
            offset = tf["base"]
            if flags & 0x01:
                offset += struct.unpack(">i", r.read_exact(4))[0]
            first_flags = None
            if flags & 0x04:
                first_flags = r.rb32()
            dts = tf["dts"]
            pos = offset
            for si in range(count):
                dur = r.rb32() if flags & 0x100 else tf["d_dur"]
                sz = r.rb32() if flags & 0x200 else tf["d_size"]
                sflags = r.rb32() if flags & 0x400 else (
                    first_flags if si == 0 and first_flags is not None
                    else tf["d_flags"])
                cts = struct.unpack(">i", r.read_exact(4))[0] if flags & 0x800 else 0
                key = not (sflags >> 16 & 0x1)
                self._frag_samples.append(
                    (t.index, pos, sz, dts, cts, key))
                pos += sz
                dts += dur
            tf["dts"] = dts

    # ------------------------------------------------------------------ finalize
    def _finalize(self) -> None:
        entries = []   # (offset, track_idx, size, dts, cts, key)
        for t in self._tracks:
            par = t.codecpar
            st = self.add_stream(codecpar=par,
                                 time_base=Rational(1, t.timescale))
            st.duration = t.duration
            if par.codec_type == MediaType.VIDEO and t.duration and t.stsz is not None:
                n = len(t.stsz)
                if n and t.duration:
                    st.avg_frame_rate = Rational(n * t.timescale, t.duration).reduce()
            if t.stsz is None or t.stco is None or len(t.stsc) == 0:
                continue
            nsamples = len(t.stsz)
            # chunk → first-sample mapping from stsc
            offsets = np.zeros(nsamples, np.int64)
            stsc = t.stsc
            nchunks = len(t.stco)
            si = 0
            for e in range(len(stsc)):
                first_chunk = stsc[e][0] - 1
                per = stsc[e][1]
                last_chunk = (stsc[e + 1][0] - 1) if e + 1 < len(stsc) else nchunks
                for c in range(first_chunk, last_chunk):
                    if si >= nsamples:
                        break
                    cnt = min(per, nsamples - si)
                    base = t.stco[c]
                    sz = t.stsz[si:si + cnt]
                    offs = base + np.concatenate([[0], np.cumsum(sz[:-1])])
                    offsets[si:si + cnt] = offs
                    si += cnt
            # dts from stts
            dts = np.zeros(nsamples, np.int64)
            pos = 0
            cur = 0
            for cnt, delta in t.stts:
                cnt = min(cnt, nsamples - pos)
                dts[pos:pos + cnt] = cur + np.arange(cnt) * delta
                cur += cnt * delta
                pos += cnt
            # cts offsets
            cts = np.zeros(nsamples, np.int64)
            if t.ctts:
                ccnt, coff = t.ctts
                pos = 0
                for c, o in zip(ccnt, coff):
                    c = min(c, nsamples - pos)
                    cts[pos:pos + c] = o
                    pos += c
            keys = np.ones(nsamples, bool)
            if t.stss is not None:
                keys[:] = False
                keys[t.stss[t.stss < nsamples]] = True
            if t.edit_offset:
                dts = dts - t.edit_offset
            for i in range(nsamples):
                entries.append((int(offsets[i]), t.index, int(t.stsz[i]),
                                int(dts[i]), int(cts[i]), bool(keys[i])))
        for (tidx, pos, sz, dts, cts, key) in self._frag_samples:
            t = self._tracks[tidx]
            d = dts - t.edit_offset if t.edit_offset else dts
            entries.append((pos, tidx, sz, d, cts, key))
        entries.sort(key=lambda e: e[0])
        self._index = entries
        self._cursor = 0

    # ------------------------------------------------------------------ packets
    def read_packet(self) -> Packet:
        if self._cursor >= len(self._index):
            raise EndOfStream()
        off, tidx, sz, dts, cts, key = self._index[self._cursor]
        self._cursor += 1
        self.r.seek(off)
        data = self.r.read_exact(sz)
        st = self.streams[tidx]
        return Packet(data=data, pts=dts + cts, dts=dts, stream_index=tidx,
                      duration=0, pos=off, time_base=st.time_base,
                      flags=PKT_FLAG_KEY if key else 0)

    def seek(self, stream_index: int, ts: int, flags: int = 0) -> None:
        """Seek to the latest keyframe of stream_index with dts <= ts."""
        best = 0
        for i, (off, tidx, sz, dts, cts, key) in enumerate(self._index):
            if tidx != stream_index:
                continue
            if dts <= ts and key:
                best = i
            if dts > ts:
                break
        self._cursor = best
