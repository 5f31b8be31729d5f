"""MP4/MOV muxer (reference: libavformat/movenc.c ~9k LoC; this is the
non-fragmented core: buffered mdat + moov sample tables, avcC/hvcC/esds
sample entries, edit lists for audio priming).

The port's copy of ffmpeg_tpu/io/formats/movenc.py, held equal to it by
tests/test_torch_io_formats.py.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

from ...core.packet import Packet
from ...utils.error import InvalidData, NotSupported
from ...utils.rational import NOPTS, Rational
from ..mux import Muxer, register_muxer
from ..stream import MediaType

_VIDEO_TAG = {"h264": b"avc1", "hevc": b"hvc1", "mpeg4": b"mp4v",
              "mjpeg": b"mp4v", "vp9": b"vp09", "av1": b"av01",
              "prores": b"apcn", "png": b"mp4v", "dnxhd": b"AVdh"}
_AUDIO_TAG = {"aac": b"mp4a", "mp3": b"mp4a", "ac3": b"ac-3",
              "opus": b"Opus", "flac": b"fLaC",
              "pcm_s16le": b"sowt", "pcm_s16be": b"twos",
              "pcm_mulaw": b"ulaw", "pcm_alaw": b"alaw"}
_OTI = {"mjpeg": 0x6C, "mpeg4": 0x20, "aac": 0x40, "mp3": 0x6B, "png": 0x6D}


class _Box:
    def __init__(self, tag: str):
        self.tag = tag
        self.buf = bytearray()

    def u8(self, v):
        self.buf.append(v & 0xFF)

    def b16(self, v):
        self.buf += struct.pack(">H", v & 0xFFFF)

    def b32(self, v):
        self.buf += struct.pack(">I", v & 0xFFFFFFFF)

    def b64(self, v):
        self.buf += struct.pack(">Q", v)

    def raw(self, data):
        self.buf += data

    def box(self, child: "_Box"):
        self.buf += child.bytes()

    def bytes(self) -> bytes:
        return struct.pack(">I", len(self.buf) + 8) + self.tag.encode() + bytes(self.buf)


@register_muxer
class MovMuxer(Muxer):
    name = "mov"
    extensions = ("mp4", "mov", "m4a", "m4v")
    default_video_codec = "mjpeg"
    default_audio_codec = "aac"

    TIMESCALE = 1000

    def _write_header(self) -> None:
        w = self.w
        ftyp = _Box("ftyp")
        ftyp.raw(b"isom")
        ftyp.b32(0x200)
        ftyp.raw(b"isomiso2mp41")
        w.write(ftyp.bytes())
        self._mdat_pos = w.tell()
        w.wb32(0)          # mdat size, patched in the trailer
        w.tag("mdat")
        self._samples: Dict[int, list] = {i: [] for i in range(len(self.streams))}

    def _write_packet(self, pkt: Packet) -> None:
        off = self.w.tell()
        self.w.write(pkt.data)
        self._samples[pkt.stream_index].append(
            (off, len(pkt.data), pkt.dts if pkt.dts != NOPTS else pkt.pts,
             pkt.pts, pkt.is_keyframe, pkt.duration))

    def _write_trailer(self) -> None:
        w = self.w
        end = w.tell()
        if w.seekable:
            w.seek(self._mdat_pos)
            w.wb32(end - self._mdat_pos)
            w.seek(end)
        moov = _Box("moov")
        max_dur_ms = 0
        for st in self.streams:
            s = self._samples[st.index]
            if s:
                tb = st.time_base
                dur = (s[-1][2] - s[0][2]) + (s[-1][5] or
                                              (s[-1][2] - s[-2][2] if len(s) > 1 else 0))
                max_dur_ms = max(max_dur_ms, dur * 1000 * tb.num // tb.den)
        mvhd = _Box("mvhd")
        mvhd.b32(0)
        mvhd.b32(0)
        mvhd.b32(0)
        mvhd.b32(self.TIMESCALE)
        mvhd.b32(max_dur_ms)
        mvhd.b32(0x00010000)
        mvhd.b16(0x0100)
        mvhd.b16(0)
        mvhd.b32(0)
        mvhd.b32(0)
        for v in (0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000):
            mvhd.b32(v)
        for _ in range(6):
            mvhd.b32(0)
        mvhd.b32(len(self.streams) + 1)
        moov.box(mvhd)
        for st in self.streams:
            if self._samples[st.index]:
                moov.box(self._trak(st))
        w.write(moov.bytes())

    # ------------------------------------------------------------------ trak
    def _trak(self, st) -> _Box:
        par = st.codecpar
        samples = self._samples[st.index]
        tb = st.time_base
        timescale = tb.den if tb.num == 1 else int(round(tb.den / tb.num))
        duration = samples[-1][2] - samples[0][2]
        if len(samples) > 1:
            duration += samples[-1][5] or (samples[-1][2] - samples[-2][2])
        dur_ms = duration * 1000 * tb.num // tb.den

        trak = _Box("trak")
        tkhd = _Box("tkhd")
        tkhd.b32(0x7)       # version 0, flags enabled|in_movie|in_preview
        tkhd.b32(0)
        tkhd.b32(0)
        tkhd.b32(st.index + 1)
        tkhd.b32(0)
        tkhd.b32(dur_ms)
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
        mdhd.b32(timescale)
        mdhd.b32(duration)
        mdhd.b16(0x55C4)   # 'und'
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
        hdlr.raw((b"VideoHandler\x00" if is_video else b"SoundHandler\x00"))
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
        minf.box(self._stbl(st, timescale))
        mdia.box(minf)
        trak.box(mdia)
        return trak

    def _sample_entry(self, st) -> _Box:
        return sample_entry(st)

    def _esds(self, par) -> _Box:
        return esds(par)


    def _stbl(self, st, timescale) -> _Box:
        samples = self._samples[st.index]
        stbl = _Box("stbl")
        stsd = _Box("stsd")
        stsd.b32(0)
        stsd.b32(1)
        stsd.box(self._sample_entry(st))
        stbl.box(stsd)

        # stts: dts deltas
        stts = _Box("stts")
        stts.b32(0)
        deltas = []
        for i, s in enumerate(samples):
            if i + 1 < len(samples):
                d = samples[i + 1][2] - s[2]
            else:
                d = s[5] or (deltas[-1][0] if deltas else 1)
            if deltas and deltas[-1][0] == d:
                deltas[-1][1] += 1
            else:
                deltas.append([d, 1])
        stts.b32(len(deltas))
        for d, c in deltas:
            stts.b32(c)
            stts.b32(max(0, d))
        stbl.box(stts)

        # ctts if any pts != dts
        if any(s[3] != NOPTS and s[3] != s[2] for s in samples):
            ctts = _Box("ctts")
            ctts.b32(0)
            runs = []
            for s in samples:
                off = (s[3] - s[2]) if s[3] != NOPTS else 0
                if runs and runs[-1][0] == off:
                    runs[-1][1] += 1
                else:
                    runs.append([off, 1])
            ctts.b32(len(runs))
            for off, c in runs:
                ctts.b32(c)
                ctts.b32(off)
            stbl.box(ctts)

        # stss (only if not all keyframes)
        if not all(s[4] for s in samples):
            stss = _Box("stss")
            stss.b32(0)
            keys = [i + 1 for i, s in enumerate(samples) if s[4]]
            stss.b32(len(keys))
            for k in keys:
                stss.b32(k)
            stbl.box(stss)

        # stsc: one sample per chunk (simple, like faststart-less writes)
        stsc = _Box("stsc")
        stsc.b32(0)
        stsc.b32(1)
        stsc.b32(1)
        stsc.b32(1)
        stsc.b32(1)
        stbl.box(stsc)

        stsz = _Box("stsz")
        stsz.b32(0)
        stsz.b32(0)
        stsz.b32(len(samples))
        for s in samples:
            stsz.b32(s[1])
        stbl.box(stsz)

        stco = _Box("stco")
        stco.b32(0)
        stco.b32(len(samples))
        for s in samples:
            stco.b32(s[0])
        stbl.box(stco)
        return stbl


def sample_entry(st) -> _Box:
    par = st.codecpar
    if par.codec_type == MediaType.VIDEO:
        tag = _VIDEO_TAG.get(par.codec_id)
        if par.codec_id == "prores" and par.codec_tag:
            t = par.codec_tag
            if isinstance(t, str):
                t = t.encode("latin1")
            elif isinstance(t, int):
                t = t.to_bytes(4, "big")
            tag = t
        if tag is None:
            raise NotSupported(f"mov: cannot mux video codec {par.codec_id}")
        e = _Box(tag.decode())
        e.raw(b"\x00" * 6)
        e.b16(1)
        e.b16(0)
        e.b16(0)
        e.b32(0)
        e.b32(0)
        e.b32(0)
        e.b16(par.width)
        e.b16(par.height)
        e.b32(0x00480000)
        e.b32(0x00480000)
        e.b32(0)
        e.b16(1)
        e.raw(b"\x00" * 32)
        e.b16(24)
        e.b16(0xFFFF)
        if par.codec_id == "h264" and par.extradata:
            c = _Box("avcC")
            c.raw(par.extradata)
            e.box(c)
        elif par.codec_id == "hevc" and par.extradata:
            c = _Box("hvcC")
            c.raw(par.extradata)
            e.box(c)
        elif par.codec_id == "av1" and par.extradata:
            c = _Box("av1C")
            c.raw(par.extradata)
            e.box(c)
        elif tag == b"mp4v":
            e.box(esds(par))
        return e
    tag = _AUDIO_TAG.get(par.codec_id)
    if tag is None:
        raise NotSupported(f"mov: cannot mux audio codec {par.codec_id}")
    e = _Box(tag.decode())
    e.raw(b"\x00" * 6)
    e.b16(1)
    e.b16(0)
    e.b16(0)
    e.b32(0)
    e.b16(par.channels)
    e.b16(par.bits_per_coded_sample or 16)
    e.b16(0)
    e.b16(0)
    e.b32(par.sample_rate << 16)
    if tag == b"mp4a":
        e.box(esds(par))
    elif tag == b"fLaC" and par.extradata:
        c = _Box("dfLa")
        c.b32(0)
        c.raw(b"\x80\x00\x00\x22" if len(par.extradata) == 34 else b"")
        c.raw(par.extradata)
        e.box(c)
    return e

def esds(par) -> _Box:
    oti = _OTI.get(par.codec_id, 0x40)
    dsi = par.extradata or b""

    def descr(tag, payload):
        out = bytes([tag])
        n = len(payload)
        # 4-byte expandable length like the reference writes
        out += bytes([0x80, 0x80, 0x80, n & 0x7F]) if n < 128 else \
            bytes([(n >> 21) | 0x80, (n >> 14) & 0x7F | 0x80,
                   (n >> 7) & 0x7F | 0x80, n & 0x7F])
        return out + payload

    dec_specific = descr(0x05, dsi) if dsi else b""
    stream_type = 0x11 if par.codec_type == MediaType.VIDEO else 0x15
    dec_config = descr(0x04, bytes([oti, stream_type]) + b"\x00\x00\x00"
                       + struct.pack(">II", 0, 0) + dec_specific)
    sl = descr(0x06, b"\x02")
    es = descr(0x03, b"\x00\x01\x00" + dec_config + sl)
    b = _Box("esds")
    b.b32(0)
    b.raw(es)
    return b

