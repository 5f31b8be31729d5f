"""AVI demuxer (reference: libavformat/avidec.c core: hdrl/strl parse +
movi chunk walk + idx1 keyframe flags).

The port's copy of ffmpeg_tpu/io/formats/avi.py, held equal to it by
tests/test_torch_io_containers.py.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

from ...core.packet import Packet, PKT_FLAG_KEY
from ...formats.channel_layout import default_layout
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from ..demux import Demuxer, register_demuxer, PROBE_SCORE_MAX
from ..stream import CodecParameters, MediaType

_VIDEO_FOURCC = {
    b"MJPG": "mjpeg", b"mjpg": "mjpeg", b"jpeg": "mjpeg",
    b"H264": "h264", b"h264": "h264", b"X264": "h264", b"avc1": "h264",
    b"HEVC": "hevc", b"hvc1": "hevc",
    b"mpg2": "mpeg2video", b"MPG2": "mpeg2video",
    b"mpg1": "mpeg1video", b"MPG1": "mpeg1video",
    b"XVID": "mpeg4", b"xvid": "mpeg4", b"DIVX": "mpeg4", b"FMP4": "mpeg4",
    b"DX50": "mpeg4", b"mp4v": "mpeg4",
    b"VP80": "vp8", b"VP90": "vp9",
    b"FFV1": "ffv1", b"png ": "png", b"MPNG": "png",
    b"\x00\x00\x00\x00": "rawvideo", b"DIB ": "rawvideo",
    b"I420": "rawvideo", b"IYUV": "rawvideo", b"YV12": "rawvideo",
    b"YUY2": "rawvideo", b"UYVY": "rawvideo", b"NV12": "rawvideo",
    b"Y800": "rawvideo",
}
# raw fourcc → pixel format (riff.c / raw.c tag tables)
_RAW_PIXFMT = {
    b"I420": "yuv420p", b"IYUV": "yuv420p", b"YV12": "yuv420p",
    b"YUY2": "yuyv422", b"UYVY": "uyvy422", b"NV12": "nv12",
    b"Y800": "gray",
}
_AUDIO_TAG = {0x0001: None, 0x0003: None, 0x0055: "mp3", 0x00FF: "aac",
              0x2000: "ac3", 0x0006: "pcm_alaw", 0x0007: "pcm_mulaw"}


@register_demuxer
class AviDemuxer(Demuxer):
    name = "avi"
    extensions = ("avi",)

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        if head[:4] == b"RIFF" and head[8:12] in (b"AVI ", b"AVIX"):
            return PROBE_SCORE_MAX
        return 0

    def read_header(self) -> None:
        r = self.r
        if r.tag() != b"RIFF":
            raise InvalidData("avi: not RIFF")
        r.rl32()
        if r.tag() != b"AVI ":
            raise InvalidData("avi: not AVI")
        self._movi_start = None
        self._movi_end = None
        self._pending = None
        self._rates: List[Rational] = []
        while not r.at_eof():
            tag = r.tag()
            size = r.rl32()
            end = r.tell() + size + (size & 1)
            if tag == b"LIST":
                ltype = r.tag()
                if ltype == b"movi":
                    self._movi_start = r.tell()
                    self._movi_end = end
                    break
                elif ltype in (b"hdrl", b"strl"):
                    continue      # descend
                else:
                    r.skip(end - r.tell())
            elif tag == b"strh":
                self._parse_strh(r.read_exact(size))
                if size & 1:
                    r.skip(1)
            elif tag == b"strf":
                self._parse_strf(r.read_exact(size))
                if size & 1:
                    r.skip(1)
            else:
                r.skip(end - r.tell())
        if self._movi_start is None:
            raise InvalidData("avi: no movi")
        self._counts: Dict[int, int] = {}
        self._idx1 = None          # parsed lazily on seek

    def _parse_strh(self, d: bytes) -> None:
        fcc_type = d[0:4]
        fcc = d[4:8]
        scale, rate = struct.unpack("<II", d[20:28])
        tb = Rational(scale or 1, rate or 25)
        if fcc_type == b"vids":
            codec = _VIDEO_FOURCC.get(fcc, fcc.decode("latin1").strip().lower())
            par = CodecParameters(codec_type=MediaType.VIDEO, codec_id=codec)
            if fcc in _RAW_PIXFMT:
                par.pix_fmt = _RAW_PIXFMT[fcc]
            self.add_stream(codecpar=par, time_base=tb)
        elif fcc_type == b"auds":
            par = CodecParameters(codec_type=MediaType.AUDIO, codec_id="?")
            self.add_stream(codecpar=par, time_base=tb)
        else:
            par = CodecParameters(codec_type=MediaType.DATA)
            self.add_stream(codecpar=par, time_base=tb)
        self._pending_par = self.streams[-1].codecpar

    def _parse_strf(self, d: bytes) -> None:
        par = getattr(self, "_pending_par", None)
        if par is None:
            return
        if par.codec_type == MediaType.VIDEO and len(d) >= 40:
            w, h = struct.unpack("<ii", d[4:12])
            par.width, par.height = w, abs(h)
            # avienc extends biSize past the 40-byte
            # BITMAPINFOHEADER to append codec extradata
            if len(d) > 40:
                par.extradata = d[40:]
        elif par.codec_type == MediaType.AUDIO and len(d) >= 16:
            wtag, ch, rate, _, ba, bits = struct.unpack("<HHIIHH", d[:16])
            from .wav import _TAG_TO_CODEC, _pcm_codec
            codec = _TAG_TO_CODEC.get(wtag) or _pcm_codec(wtag, bits)
            par.codec_id = codec
            par.sample_rate = rate
            par.ch_layout = default_layout(ch)
            par.block_align = ba
            par.bits_per_coded_sample = bits
            if len(d) >= 18:
                cb = struct.unpack("<H", d[16:18])[0]
                if cb and len(d) >= 18 + cb:
                    par.extradata = d[18:18 + cb]
            st = self.streams[-1]
            st.time_base = Rational(1, rate)
        self._pending_par = None

    def _load_idx1(self):
        """Parse the idx1 index (entries per stream with keyframe flags
        and movi-relative offsets); restores the read position."""
        if self._idx1 is not None:
            return
        self._idx1 = {i: [] for i in range(len(self.streams))}
        if not self.r.seekable or self._movi_end is None:
            return
        pos = self.r.tell()
        try:
            self.r.seek(self._movi_end)
            counts = {i: 0 for i in range(len(self.streams))}
            while not self.r.at_eof():
                tag = self.r.read(4)
                if tag != b"idx1":
                    break
                size = self.r.rl32()
                data = self.r.read_exact(size)
                for i in range(0, len(data) - 15, 16):
                    ck = data[i:i + 4]
                    flags, off, _sz = struct.unpack("<III",
                                                    data[i + 4:i + 16])
                    try:
                        sid = int(ck[:2])
                    except ValueError:
                        continue
                    if sid >= len(self.streams):
                        continue
                    st = self.streams[sid]
                    n = counts[sid]
                    self._idx1[sid].append(
                        (n, off, bool(flags & 0x10)))
                    if st.codecpar.codec_type == MediaType.AUDIO and \
                            st.codecpar.block_align:
                        counts[sid] = n + _sz // st.codecpar.block_align
                    else:
                        counts[sid] = n + 1
                break
        finally:
            self.r.seek(pos)

    def seek(self, stream_index: int, ts: int, flags: int = 0) -> None:
        """Keyframe-aware seek using the idx1 index."""
        self._load_idx1()
        entries = self._idx1.get(stream_index) or []
        if not entries:
            raise InvalidData("avi: no index for seeking")
        best = entries[0]
        for e in entries:
            if e[0] <= ts and e[2]:
                best = e
            if e[0] > ts:
                break
        # offsets are relative to the 'movi' fourcc (start - 4)
        self.r.seek(self._movi_start - 4 + best[1])
        # reset per-stream counters to the index's packet numbering by
        # replaying counts up to the seek point
        self._pending = None
        self._counts = {}
        for sid, ents in self._idx1.items():
            n = 0
            for e in ents:
                if self._movi_start - 4 + e[1] >= self.r.tell():
                    break
                n = e[0]
            self._counts[sid] = n
        self._counts[stream_index] = best[0]

    def _emit(self, sid: int, data: bytes) -> Packet:
        st = self.streams[sid]
        n = self._counts.get(sid, 0)
        if st.codecpar.codec_type == MediaType.AUDIO and \
                st.codecpar.block_align:
            dur = len(data) // st.codecpar.block_align
        else:
            dur = 1
        pkt = Packet(data=data, pts=n, dts=n,
                     duration=dur, stream_index=sid,
                     flags=PKT_FLAG_KEY, time_base=st.time_base)
        self._counts[sid] = n + dur
        return pkt

    def read_packet(self) -> Packet:
        r = self.r
        if self._pending:
            sid, data, off = self._pending
            ba = self.streams[sid].codecpar.block_align
            end = off + 1024 * ba
            if end >= len(data):
                self._pending = None
                return self._emit(sid, data[off:])
            self._pending = (sid, data, end)
            return self._emit(sid, data[off:end])
        while True:
            if self._movi_end is not None and r.tell() >= self._movi_end:
                raise EndOfStream()
            if r.at_eof():
                raise EndOfStream()
            tag = r.read(4)
            if len(tag) < 4:
                raise EndOfStream()
            if tag == b"LIST":
                r.rl32()
                r.tag()
                continue
            if tag in (b"idx1", b"RIFF"):
                raise EndOfStream()
            size = r.rl32()
            # stream id: '00dc', '01wb', etc.
            try:
                sid = int(tag[:2])
            except ValueError:
                r.skip(size + (size & 1))
                continue
            data = r.read_exact(size)
            if size & 1:
                r.skip(1)
            if sid >= len(self.streams):
                continue
            st = self.streams[sid]
            # PCM-style small constant sample size: split big chunks into
            # <=1024-sample packets like the reference
            # (avidec.c:1510-1516 — "arbitrary multiplier to avoid tiny
            # packets for raw PCM data")
            ba = st.codecpar.block_align or 0
            if (st.codecpar.codec_type == MediaType.AUDIO and
                    1 < ba < 32 and len(data) > 1024 * ba):
                self._pending = (sid, data, 1024 * ba)
                return self._emit(sid, data[:1024 * ba])
            return self._emit(sid, data)


# ---------------------------------------------------------------------------
# Muxer (reference: libavformat/avienc.c — RIFF/hdrl/strl header, movi chunk
# stream, idx1 index; sizes back-patched on seekable outputs)

from ..mux import Muxer, register_muxer   # noqa: E402

_CODEC_FOURCC = {
    "mjpeg": b"MJPG", "h264": b"H264", "hevc": b"HEVC",
    "mpeg1video": b"mpg1", "mpeg2video": b"mpg2", "mpeg4": b"FMP4",
    "vp8": b"VP80", "vp9": b"VP90", "ffv1": b"FFV1", "png": b"MPNG",
    "rawvideo": b"\x00\x00\x00\x00",
}


@register_muxer
class AviMuxer(Muxer):
    name = "avi"
    extensions = ("avi",)
    default_video_codec = "mjpeg"
    default_audio_codec = "pcm_s16le"

    def _write_header(self) -> None:
        from .wav import _CODEC_TO_TAG
        w = self.w
        w.tag("RIFF")
        self._riff_pos = w.tell()
        w.wl32(0)
        w.tag("AVI ")

        vstreams = [s for s in self.streams
                    if s.codecpar.codec_type == MediaType.VIDEO]
        vpar = vstreams[0].codecpar if vstreams else None

        # hdrl list -----------------------------------------------------------
        w.tag("LIST")
        hdrl_pos = w.tell()
        w.wl32(0)
        w.tag("hdrl")
        w.tag("avih")
        w.wl32(56)
        if vstreams:
            tb = vstreams[0].time_base
            w.wl32(int(1000000 * tb.num / tb.den))
        else:
            w.wl32(0)
        w.wl32(0)                        # max bytes/sec
        w.wl32(0)                        # padding
        w.wl32(0x10)                     # AVIF_HASINDEX
        self._avih_frames_pos = w.tell()
        w.wl32(0)                        # total frames (patched)
        w.wl32(0)                        # initial frames
        w.wl32(len(self.streams))
        w.wl32(1 << 20)                  # suggested buffer
        w.wl32(vpar.width if vpar else 0)
        w.wl32(vpar.height if vpar else 0)
        w.write(b"\x00" * 16)

        self._len_pos = []
        self._counts = [0] * len(self.streams)
        for st in self.streams:
            par = st.codecpar
            w.tag("LIST")
            strl_pos = w.tell()
            w.wl32(0)
            w.tag("strl")
            w.tag("strh")
            w.wl32(56)
            if par.codec_type == MediaType.VIDEO:
                fcc = _CODEC_FOURCC.get(par.codec_id)
                if fcc is None:
                    raise InvalidData(f"avi: cannot mux codec {par.codec_id}")
                w.tag("vids")
                w.write(fcc)
                w.wl32(0); w.wl16(0); w.wl16(0); w.wl32(0)
                w.wl32(st.time_base.num)          # dwScale
                w.wl32(st.time_base.den)          # dwRate
                w.wl32(0)
                self._len_pos.append(w.tell())
                w.wl32(0)                         # dwLength (patched)
                w.wl32(1 << 20)
                w.wl32(0xFFFFFFFF)                # quality
                w.wl32(0)                         # sample size
                w.wl16(0); w.wl16(0)
                w.wl16(par.width); w.wl16(par.height)
                w.tag("strf")
                w.wl32(40)
                w.wl32(40); w.wl32(par.width); w.wl32(par.height)
                w.wl16(1); w.wl16(24)
                w.write(fcc if fcc != b"\x00\x00\x00\x00" else b"\x00" * 4)
                w.wl32(par.width * par.height * 3)
                w.wl32(0); w.wl32(0); w.wl32(0); w.wl32(0)
            elif par.codec_type == MediaType.AUDIO:
                if par.codec_id not in _CODEC_TO_TAG:
                    raise InvalidData(f"avi: cannot mux codec {par.codec_id}")
                tag, bits = _CODEC_TO_TAG[par.codec_id]
                ch = par.channels
                ba = ch * bits // 8
                w.tag("auds")
                w.wl32(0)
                w.wl32(0); w.wl16(0); w.wl16(0); w.wl32(0)
                w.wl32(1)                         # dwScale
                w.wl32(par.sample_rate)           # dwRate
                w.wl32(0)
                self._len_pos.append(w.tell())
                w.wl32(0)                         # dwLength in samples
                w.wl32(1 << 16)
                w.wl32(0xFFFFFFFF)
                w.wl32(ba)                        # sample size
                w.wl16(0); w.wl16(0); w.wl16(0); w.wl16(0)
                w.tag("strf")
                w.wl32(16)
                w.wl16(tag); w.wl16(ch)
                w.wl32(par.sample_rate)
                w.wl32(par.sample_rate * ba)
                w.wl16(ba); w.wl16(bits)
            else:
                raise InvalidData("avi: unsupported stream type")
            end = w.tell()
            if w.seekable:
                w.seek(strl_pos); w.wl32(end - strl_pos - 4); w.seek(end)
        end = w.tell()
        if w.seekable:
            w.seek(hdrl_pos); w.wl32(end - hdrl_pos - 4); w.seek(end)

        # movi list -----------------------------------------------------------
        w.tag("LIST")
        self._movi_pos = w.tell()
        w.wl32(0)
        w.tag("movi")
        self._index: List[tuple] = []

    def _chunk_tag(self, st) -> bytes:
        kind = b"dc" if st.codecpar.codec_type == MediaType.VIDEO else b"wb"
        return b"%02d" % st.index + kind

    def _write_packet(self, pkt: Packet) -> None:
        w = self.w
        st = self.streams[pkt.stream_index]
        tag = self._chunk_tag(st)
        # offset in idx1 is relative to the 'movi' fourcc
        off = w.tell() - (self._movi_pos + 4)
        self._index.append((tag, bool(pkt.flags & PKT_FLAG_KEY),
                            off, len(pkt.data)))
        w.write(tag)
        w.wl32(len(pkt.data))
        w.write(pkt.data)
        if len(pkt.data) & 1:
            w.write(b"\x00")
        if st.codecpar.codec_type == MediaType.AUDIO and \
                st.codecpar.block_align:
            self._counts[st.index] += len(pkt.data) // st.codecpar.block_align
        elif st.codecpar.codec_type == MediaType.AUDIO and pkt.duration:
            self._counts[st.index] += pkt.duration
        else:
            self._counts[st.index] += 1

    def _write_trailer(self) -> None:
        w = self.w
        movi_end = w.tell()
        w.tag("idx1")
        w.wl32(16 * len(self._index))
        for tag, key, off, size in self._index:
            w.write(tag)
            w.wl32(0x10 if key else 0)
            w.wl32(off)
            w.wl32(size)
        end = w.tell()
        if not w.seekable:
            return
        w.seek(self._riff_pos)
        w.wl32(end - self._riff_pos - 4)
        w.seek(self._movi_pos)
        w.wl32(movi_end - self._movi_pos - 4)
        nvframes = max((self._counts[s.index] for s in self.streams
                        if s.codecpar.codec_type == MediaType.VIDEO),
                       default=0)
        w.seek(self._avih_frames_pos)
        w.wl32(nvframes)
        for st, pos in zip(self.streams, self._len_pos):
            w.seek(pos)
            w.wl32(self._counts[st.index])
        w.seek(end)
