"""DASH muxer (reference: libavformat/dashenc.c:2318): static VOD MPD
with one fragmented-MP4 representation per stream, SegmentTemplate +
SegmentTimeline addressing, segments cut on keyframes at seg_duration.

The fMP4 writer is the movenc fragment path re-done natively: an init
segment (ftyp + moov with empty sample tables + mvex/trex) and per-
segment styp + moof(mfhd, traf(tfhd, tfdt, trun)) + mdat, with
default-base-is-moof addressing. File layout matches dashenc.c
defaults: init-stream{N}.m4s / chunk-stream{N}-{number:05d}.m4s next
to the MPD.

The port's copy of ffmpeg_tpu/io/formats/dashenc.py, held equal to it by
tests/test_torch_io_streaming.py.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

from ...core.packet import Packet
from ...utils.error import InvalidData
from ...utils.rational import NOPTS
from ..mux import Muxer, register_muxer
from ..stream import MediaType
from .movenc import _Box, sample_entry

_TFHD_DEFAULT_BASE_IS_MOOF = 0x020000
_TRUN_DATA_OFFSET = 0x01
_TRUN_SAMPLE_DURATION = 0x100
_TRUN_SAMPLE_SIZE = 0x200
_TRUN_SAMPLE_FLAGS = 0x400
_TRUN_SAMPLE_CTS = 0x800
_FLAG_SYNC = 0x02000000        # sample_depends_on=2 (I-frame)
_FLAG_NONSYNC = 0x01010000    # depends_on=1 + non-sync


class _FragRep:
    """One stream's fragmented-MP4 representation."""

    def __init__(self, st, timescale: int):
        self.st = st
        self.timescale = timescale
        self.samples: List[tuple] = []   # (data, dur, cts, key)
        self.seg_durations: List[int] = []   # in timescale units
        self.seq = 1
        self.base_dts = 0                # tfdt of the pending segment

    # ---------------------------------------------------------- init
    def init_segment(self) -> bytes:
        st = self.st
        par = st.codecpar
        ftyp = _Box("ftyp")
        ftyp.raw(b"iso5")
        ftyp.b32(0x200)
        ftyp.raw(b"iso5iso6mp41dash")
        moov = _Box("moov")
        mvhd = _Box("mvhd")
        mvhd.b32(0)
        mvhd.b32(0)
        mvhd.b32(0)
        mvhd.b32(1000)
        mvhd.b32(0)                      # duration unknown (fragmented)
        mvhd.b32(0x00010000)
        mvhd.b16(0x0100)
        mvhd.b16(0)
        mvhd.b32(0)
        mvhd.b32(0)
        for v in (0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000):
            mvhd.b32(v)
        for _ in range(6):
            mvhd.b32(0)
        mvhd.b32(2)
        moov.box(mvhd)

        trak = _Box("trak")
        tkhd = _Box("tkhd")
        tkhd.b32(0x7)
        tkhd.b32(0)
        tkhd.b32(0)
        tkhd.b32(1)                      # track id
        tkhd.b32(0)
        tkhd.b32(0)                      # duration
        tkhd.b32(0)
        tkhd.b32(0)
        tkhd.b16(0)
        tkhd.b16(0)
        tkhd.b16(0x0100 if par.codec_type == MediaType.AUDIO else 0)
        tkhd.b16(0)
        for v in (0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000):
            tkhd.b32(v)
        tkhd.b32(par.width << 16)
        tkhd.b32(par.height << 16)
        trak.box(tkhd)

        mdia = _Box("mdia")
        mdhd = _Box("mdhd")
        mdhd.b32(0)
        mdhd.b32(0)
        mdhd.b32(0)
        mdhd.b32(self.timescale)
        mdhd.b32(0)
        mdhd.b16(0x55C4)
        mdhd.b16(0)
        mdia.box(mdhd)
        hdlr = _Box("hdlr")
        hdlr.b32(0)
        hdlr.b32(0)
        is_video = par.codec_type == MediaType.VIDEO
        hdlr.raw(b"vide" if is_video else b"soun")
        hdlr.b32(0)
        hdlr.b32(0)
        hdlr.b32(0)
        hdlr.raw(b"VideoHandler\x00" if is_video else
                 b"SoundHandler\x00")
        mdia.box(hdlr)

        minf = _Box("minf")
        if is_video:
            vmhd = _Box("vmhd")
            vmhd.b32(1)
            vmhd.b16(0)
            for _ in range(3):
                vmhd.b16(0)
            minf.box(vmhd)
        else:
            smhd = _Box("smhd")
            smhd.b32(0)
            smhd.b32(0)
            minf.box(smhd)
        dinf = _Box("dinf")
        dref = _Box("dref")
        dref.b32(0)
        dref.b32(1)
        url = _Box("url ")
        url.b32(1)
        dref.box(url)
        dinf.box(dref)
        minf.box(dinf)

        stbl = _Box("stbl")
        stsd = _Box("stsd")
        stsd.b32(0)
        stsd.b32(1)
        stsd.box(sample_entry(st))
        stbl.box(stsd)
        for tag in ("stts", "stsc", "stsz", "stco"):
            b = _Box(tag)
            b.b32(0)
            if tag == "stsz":
                b.b32(0)
            b.b32(0)
            stbl.box(b)
        minf.box(stbl)
        mdia.box(minf)
        trak.box(mdia)
        moov.box(trak)

        mvex = _Box("mvex")
        trex = _Box("trex")
        trex.b32(0)
        trex.b32(1)                      # track id
        trex.b32(1)                      # default sample descr idx
        trex.b32(0)
        trex.b32(0)
        trex.b32(0)
        mvex.box(trex)
        moov.box(mvex)
        return ftyp.bytes() + moov.bytes()

    # ------------------------------------------------------- segment
    def add(self, data: bytes, dur: int, cts: int, key: bool):
        self.samples.append((data, dur, cts, key))

    def flush_segment(self) -> Optional[bytes]:
        if not self.samples:
            return None
        styp = _Box("styp")
        styp.raw(b"msdh")
        styp.b32(0)
        styp.raw(b"msdhmsix")

        have_cts = any(s[2] for s in self.samples)
        moof = _Box("moof")
        mfhd = _Box("mfhd")
        mfhd.b32(0)
        mfhd.b32(self.seq)
        moof.box(mfhd)
        traf = _Box("traf")
        tfhd = _Box("tfhd")
        tfhd.b32(_TFHD_DEFAULT_BASE_IS_MOOF)
        tfhd.b32(1)                      # track id
        traf.box(tfhd)
        tfdt = _Box("tfdt")
        tfdt.b32(0x01000000)             # version 1
        tfdt.b64(self.base_dts)
        traf.box(tfdt)
        trun = _Box("trun")
        flags = (_TRUN_DATA_OFFSET | _TRUN_SAMPLE_DURATION
                 | _TRUN_SAMPLE_SIZE | _TRUN_SAMPLE_FLAGS)
        if have_cts:
            flags |= _TRUN_SAMPLE_CTS
        trun.b32(flags)
        trun.b32(len(self.samples))
        trun.b32(0)                      # data offset patched below
        for data, dur, cts, key in self.samples:
            trun.b32(dur)
            trun.b32(len(data))
            trun.b32(_FLAG_SYNC if key else _FLAG_NONSYNC)
            if have_cts:
                trun.b32(cts)
        traf.box(trun)
        moof.box(traf)
        moof_bytes = bytearray(moof.bytes())
        # patch trun data_offset: mdat payload starts at moof size + 8
        off = moof_bytes.index(b"trun") + 4 + 8
        struct.pack_into(">i", moof_bytes, off,
                         len(moof_bytes) + 8)
        mdat = _Box("mdat")
        total_dur = 0
        for data, dur, _, _ in self.samples:
            mdat.raw(data)
            total_dur += dur
        self.seg_durations.append(total_dur)
        self.base_dts += total_dur
        self.seq += 1
        self.samples = []
        return styp.bytes() + bytes(moof_bytes) + mdat.bytes()


_CODECS_ATTR = {"h264": "avc1.64001f", "hevc": "hvc1.1.6.L93.B0",
                "mjpeg": "mp4v.6C", "mpeg4": "mp4v.20.9",
                "aac": "mp4a.40.2", "mp3": "mp4a.40.34",
                "flac": "fLaC", "opus": "opus"}


@register_muxer
class DashMuxer(Muxer):
    """`url` is the .mpd path; init/chunk files land next to it.
    Options: seg_duration (seconds, default 5 like dashenc.c)."""

    name = "dash"
    extensions = ("mpd",)
    flags_no_file = True
    seg_duration = 5.0

    def _write_header(self) -> None:
        self._dir = os.path.dirname(self.url) or "."
        self._reps: List[_FragRep] = []
        self._seg_t0: List[Optional[float]] = []
        for st in self.streams:
            tb = st.time_base
            ts = tb.den if tb.num == 1 else int(round(tb.den / tb.num))
            rep = _FragRep(st, ts)
            self._reps.append(rep)
            self._seg_t0.append(None)
            with open(self._init_path(st.index), "wb") as f:
                f.write(rep.init_segment())
        self._prev: List[Optional[tuple]] = [None] * len(self.streams)

    def _init_path(self, i: int) -> str:
        return os.path.join(self._dir, f"init-stream{i}.m4s")

    def _chunk_path(self, i: int, num: int) -> str:
        return os.path.join(self._dir,
                            f"chunk-stream{i}-{num:05d}.m4s")

    def _emit(self, i: int, pkt: Packet) -> None:
        """Queue the previous packet of stream i with its final
        duration (from dts delta when missing)."""
        rep = self._reps[i]
        prev = self._prev[i]
        if prev is not None:
            pdata, pdts, ppts, pdur, pkey = prev
            if not pdur and pkt is not None:
                dts = pkt.dts if pkt.dts != NOPTS else pkt.pts
                pdur = max(1, dts - pdts)
            cts = (ppts - pdts) if ppts != NOPTS else 0
            rep.add(pdata, pdur or 1, cts, pkey)
        if pkt is None:
            self._prev[i] = None
            return
        dts = pkt.dts if pkt.dts != NOPTS else pkt.pts
        self._prev[i] = (bytes(pkt.data), dts, pkt.pts,
                         pkt.duration or 0, pkt.is_keyframe)

    def _write_packet(self, pkt: Packet) -> None:
        i = pkt.stream_index
        st = self.streams[i]
        rep = self._reps[i]
        tb = st.time_base
        t = (pkt.pts * tb.num / tb.den) if pkt.pts != NOPTS and tb.den \
            else None
        cut = False
        if t is not None:
            if self._seg_t0[i] is None:
                self._seg_t0[i] = t
            elif (t - self._seg_t0[i] >= float(self.seg_duration)
                  and (pkt.is_keyframe
                       or st.codecpar.codec_type != MediaType.VIDEO)):
                cut = True
        if cut:
            self._emit(i, None)          # drain pending into segment
            seg = rep.flush_segment()
            if seg:
                with open(self._chunk_path(i, rep.seq - 1), "wb") as f:
                    f.write(seg)
            self._seg_t0[i] = t
        self._emit(i, pkt)

    def _write_trailer(self) -> None:
        for i, rep in enumerate(self._reps):
            self._emit(i, None)
            seg = rep.flush_segment()
            if seg:
                with open(self._chunk_path(i, rep.seq - 1), "wb") as f:
                    f.write(seg)
        self._write_mpd()

    def _write_mpd(self) -> None:
        total = 0.0
        for rep in self._reps:
            if rep.seg_durations:
                total = max(total, sum(rep.seg_durations)
                            / rep.timescale)
        lines = [
            '<?xml version="1.0" encoding="utf-8"?>',
            '<MPD xmlns="urn:mpeg:dash:schema:mpd:2011"',
            '\tprofiles="urn:mpeg:dash:profile:isoff-live:2011"',
            '\ttype="static"',
            f'\tmediaPresentationDuration="PT{total:.3f}S"',
            '\tminBufferTime="PT2.0S">',
            '\t<Period id="0" start="PT0.0S">',
        ]
        aset = 0
        for i, rep in enumerate(self._reps):
            par = rep.st.codecpar
            is_video = par.codec_type == MediaType.VIDEO
            ctype = "video" if is_video else "audio"
            codecs = _CODECS_ATTR.get(par.codec_id, par.codec_id)
            lines.append(
                f'\t\t<AdaptationSet id="{aset}" '
                f'contentType="{ctype}" segmentAlignment="true">')
            attrs = f'id="{i}" mimeType="{ctype}/mp4" ' \
                    f'codecs="{codecs}" bandwidth="200000"'
            if is_video:
                attrs += f' width="{par.width}" height="{par.height}"'
            else:
                attrs += f' audioSamplingRate="{par.sample_rate}"'
            lines.append(f'\t\t\t<Representation {attrs}>')
            lines.append(
                f'\t\t\t\t<SegmentTemplate timescale="{rep.timescale}" '
                f'initialization="init-stream{i}.m4s" '
                f'media="chunk-stream{i}-$Number%05d$.m4s" '
                f'startNumber="1">')
            lines.append('\t\t\t\t\t<SegmentTimeline>')
            t = 0
            k = 0
            durs = rep.seg_durations
            while k < len(durs):
                r = 0
                while k + r + 1 < len(durs) and \
                        durs[k + r + 1] == durs[k]:
                    r += 1
                s = f'\t\t\t\t\t\t<S t="{t}" d="{durs[k]}"'
                if r:
                    s += f' r="{r}"'
                lines.append(s + ' />')
                t += durs[k] * (r + 1)
                k += r + 1
            lines.append('\t\t\t\t\t</SegmentTimeline>')
            lines.append('\t\t\t\t</SegmentTemplate>')
            lines.append('\t\t\t</Representation>')
            lines.append('\t\t</AdaptationSet>')
            aset += 1
        lines.append('\t</Period>')
        lines.append('</MPD>')
        with open(self.url, "w") as f:
            f.write("\n".join(lines) + "\n")
