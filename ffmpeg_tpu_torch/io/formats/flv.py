"""FLV demuxer (reference: libavformat/flvdec.c).

Header 'FLV' + version + type flags + data offset, then a stream of
tags, each preceded by the previous tag's size: type u8 (8 audio /
9 video / 18 script-data), u24 payload size, u24+u8 timestamp (ms),
u24 stream id. Video payload leads with frame-type/codec-id nibbles
(AVC adds an AVCPacketType byte + s24 composition time and carries
avcC extradata in packet type 0); audio leads with the sound-format
nibble (AAC adds an AACPacketType byte and carries AudioSpecificConfig
in packet type 0). The onMetaData script tag is AMF0; we parse the
top-level number fields (width/height/framerate/duration) and ignore
the rest, like the reference's amf_parse_object fast path.

The port's copy of ffmpeg_tpu/io/formats/flv.py, held equal to it by
tests/test_torch_io_containers.py.
"""

from __future__ import annotations

import struct
from typing import Optional

from ...core.packet import Packet, PKT_FLAG_KEY
from ...formats.channel_layout import default_layout
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from ..demux import Demuxer, register_demuxer
from ..stream import CodecParameters, MediaType

_VIDEO_CODECS = {
    2: "flv1", 3: "flashsv", 4: "vp6f", 5: "vp6a", 6: "flashsv2",
    7: "h264", 12: "hevc",
}
_AUDIO_CODECS = {
    0: "pcm_s16le", 1: "adpcm_swf", 2: "mp3", 3: "pcm_s16le",
    4: "nellymoser", 5: "nellymoser", 6: "nellymoser",
    7: "pcm_alaw", 8: "pcm_mulaw", 10: "aac", 11: "speex", 14: "mp3",
}
_RATES = [5512, 11025, 22050, 44100]


def _amf_read(data: bytes, pos: int):
    """Minimal AMF0 value reader → (value, new_pos); nested structures
    return dict/list, unknown types raise."""
    t = data[pos]
    pos += 1
    if t == 0:          # number
        return struct.unpack(">d", data[pos:pos + 8])[0], pos + 8
    if t == 1:          # bool
        return bool(data[pos]), pos + 1
    if t == 2:          # string
        n = struct.unpack(">H", data[pos:pos + 2])[0]
        return data[pos + 2:pos + 2 + n].decode("utf-8", "replace"), \
            pos + 2 + n
    if t == 3 or t == 8:   # object / ECMA array
        if t == 8:
            pos += 4       # array length hint
        out = {}
        while pos + 2 <= len(data):
            n = struct.unpack(">H", data[pos:pos + 2])[0]
            key = data[pos + 2:pos + 2 + n].decode("utf-8", "replace")
            pos += 2 + n
            if pos < len(data) and data[pos] == 9 and not key:
                return out, pos + 1       # object end marker
            v, pos = _amf_read(data, pos)
            out[key] = v
        return out, pos
    if t == 10:         # strict array
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        pos += 4
        out = []
        for _ in range(n):
            v, pos = _amf_read(data, pos)
            out.append(v)
        return out, pos
    if t == 11:         # date
        return struct.unpack(">d", data[pos:pos + 8])[0], pos + 10
    if t in (5, 6):     # null / undefined
        return None, pos
    raise InvalidData(f"flv: AMF type {t}")


@register_demuxer
class FlvDemuxer(Demuxer):
    name = "flv"
    long_name = "FLV (Flash Video)"
    extensions = ("flv",)

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        if head[:3] == b"FLV" and len(head) > 8 and head[3] == 1:
            return 100
        return 0

    def read_header(self) -> None:
        r = self.r
        hdr = r.read_exact(9)
        if hdr[:3] != b"FLV":
            raise InvalidData("flv: bad signature")
        flags = hdr[4]
        data_off = struct.unpack(">I", hdr[5:9])[0]
        if data_off > 9:
            r.skip(data_off - 9)
        self._vindex: Optional[int] = None
        self._aindex: Optional[int] = None
        self._has_video = bool(flags & 1)
        self._has_audio = bool(flags & 4)
        self._meta = {}
        self._queue = []
        # read tags until both advertised streams are identified (or a
        # few tags deep) so stream info is available before packets
        tries = 0
        while tries < 32:
            need_v = self._has_video and self._vindex is None
            need_a = self._has_audio and self._aindex is None
            if not need_v and not need_a and tries > 0:
                break
            try:
                pkt = self._read_tag()
            except EndOfStream:
                break
            if pkt is not None:
                self._queue.append(pkt)
            tries += 1

    def _video_stream(self, codec_id: int) -> int:
        if self._vindex is None:
            par = CodecParameters(
                codec_type=MediaType.VIDEO,
                codec_id=_VIDEO_CODECS.get(codec_id,
                                           f"flv_video_{codec_id}"))
            if "width" in self._meta:
                par.width = int(self._meta["width"])
            if "height" in self._meta:
                par.height = int(self._meta["height"])
            st = self.add_stream(codecpar=par, time_base=Rational(1, 1000))
            self._vindex = st.index
        return self._vindex

    def _audio_stream(self, fmt: int, rate_idx: int, stereo: int) -> int:
        if self._aindex is None:
            codec = _AUDIO_CODECS.get(fmt, f"flv_audio_{fmt}")
            rate = 8000 if fmt == 14 else _RATES[rate_idx]
            if fmt == 4:
                rate = 16000
            if fmt in (5, 7, 8, 11):
                rate = 8000 if fmt != 5 else 8000
            ch = 2 if stereo else 1
            if fmt == 10:
                rate, ch = 44100, 2      # real params come from ASC
            par = CodecParameters(codec_type=MediaType.AUDIO,
                                  codec_id=codec, sample_rate=rate,
                                  ch_layout=default_layout(ch))
            if codec == "pcm_s16le":
                par.block_align = 2 * ch
                par.bits_per_coded_sample = 16
            st = self.add_stream(codecpar=par, time_base=Rational(1, 1000))
            self._aindex = st.index
        return self._aindex

    def _read_tag(self) -> Optional[Packet]:
        r = self.r
        r.read_exact(4)                     # previous tag size
        h = r.read(11)
        if len(h) < 11:
            raise EndOfStream()
        ttype = h[0] & 0x1F
        size = struct.unpack(">I", b"\0" + h[1:4])[0]
        ts = struct.unpack(">I", b"\0" + h[4:7])[0] | (h[7] << 24)
        if ts & 0x80000000:
            ts -= 1 << 32                   # extended ts is signed
        payload = r.read_exact(size)
        if ttype == 18:                     # script data (metadata)
            try:
                name, pos = _amf_read(payload, 0)
                val, _ = _amf_read(payload, pos)
                if name == "onMetaData" and isinstance(val, dict):
                    self._meta.update(val)
                    for k in ("width", "height", "duration", "framerate"):
                        if k in val:
                            self.metadata[k] = str(val[k])
            except (InvalidData, IndexError, struct.error):
                pass
            return None
        if ttype == 9 and size >= 1:        # video
            frame_type = payload[0] >> 4
            codec_id = payload[0] & 15
            if frame_type == 5:             # server command frame
                return None
            sidx = self._video_stream(codec_id)
            st = self.streams[sidx]
            body = payload[1:]
            pts = dts = ts
            if codec_id in (7, 12):         # AVC / HEVC: packet type+cts
                if len(body) < 4:
                    return None
                avc_type = body[0]
                cts = struct.unpack(">i", bytes([0]) + body[1:4])[0]
                if cts & 0x800000:
                    cts -= 1 << 24
                body = body[4:]
                if avc_type == 0:           # sequence header (avcC/hvcC)
                    st.codecpar.extradata = body
                    return None
                if avc_type == 2:           # end of stream
                    return None
                pts = dts + cts
            elif codec_id in (4, 5):        # VP6: 1 adjustment byte
                body = body[1 if codec_id == 4 else 2:]
            if not body:
                return None
            return Packet(data=body, pts=pts, dts=dts, stream_index=sidx,
                          flags=PKT_FLAG_KEY if frame_type == 1 else 0,
                          time_base=st.time_base)
        if ttype == 8 and size >= 1:        # audio
            fmt = payload[0] >> 4
            rate_idx = (payload[0] >> 2) & 3
            stereo = payload[0] & 1
            sidx = self._audio_stream(fmt, rate_idx, stereo)
            st = self.streams[sidx]
            body = payload[1:]
            if fmt == 10:                   # AAC: packet type byte
                if not body:
                    return None
                if body[0] == 0:            # AudioSpecificConfig
                    asc = body[1:]
                    st.codecpar.extradata = asc
                    if len(asc) >= 2:
                        rate_i = ((asc[0] & 7) << 1) | (asc[1] >> 7)
                        rates = [96000, 88200, 64000, 48000, 44100,
                                 32000, 24000, 22050, 16000, 12000,
                                 11025, 8000, 7350]
                        if rate_i < len(rates):
                            st.codecpar.sample_rate = rates[rate_i]
                        ch = (asc[1] >> 3) & 15
                        if ch:
                            st.codecpar.ch_layout = default_layout(ch)
                    return None
                body = body[1:]
            if not body:
                return None
            return Packet(data=body, pts=ts, dts=ts, stream_index=sidx,
                          flags=PKT_FLAG_KEY, time_base=st.time_base)
        return None

    def read_packet(self) -> Packet:
        while True:
            if self._queue:
                return self._queue.pop(0)
            pkt = self._read_tag()
            if pkt is not None:
                return pkt


# ---------------------------------------------------------------------------
# Muxer (reference: libavformat/flvenc.c — header, onMetaData AMF script
# tag, audio/video tags with codec-nibble headers, AAC sequence header)
# ---------------------------------------------------------------------------

from ..mux import Muxer, register_muxer   # noqa: E402

_AUDIO_FMT = {"aac": 10, "mp3": 2, "pcm_s16le": 3, "pcm_alaw": 7,
              "pcm_mulaw": 8, "speex": 11}
_VIDEO_FMT = {"flv1": 2, "h264": 7, "hevc": 12, "vp6f": 4}


def _amf_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def _amf_number(v: float) -> bytes:
    return b"\x00" + struct.pack(">d", v)


@register_muxer
class FlvMuxer(Muxer):
    name = "flv"
    long_name = "FLV (Flash Video)"
    extensions = ("flv",)

    def _write_header(self) -> None:
        w = self.w
        has_a = any(st.codecpar.codec_type == MediaType.AUDIO
                    for st in self.streams)
        has_v = any(st.codecpar.codec_type == MediaType.VIDEO
                    for st in self.streams)
        flags = (4 if has_a else 0) | (1 if has_v else 0)
        w.write(b"FLV\x01" + bytes([flags]) + struct.pack(">I", 9))
        self._prev_size = 0
        self._sent_seq = set()
        # onMetaData script tag
        meta = b"\x02" + _amf_string("onMetaData")
        fields = []
        for st in self.streams:
            p = st.codecpar
            if p.codec_type == MediaType.VIDEO:
                fields += [(b"width", p.width), (b"height", p.height)]
            elif p.codec_type == MediaType.AUDIO:
                fields += [(b"audiosamplerate", p.sample_rate),
                           (b"stereo", p.channels == 2)]
        body = b"\x08" + struct.pack(">I", len(fields))
        for k, v in fields:
            body += struct.pack(">H", len(k)) + k
            if isinstance(v, bool):
                body += b"\x01" + (b"\x01" if v else b"\x00")
            else:
                body += _amf_number(float(v))
        body += b"\x00\x00\x09"
        self._write_tag(18, 0, meta + body)

    def _write_tag(self, ttype: int, ts_ms: int, payload: bytes) -> None:
        w = self.w
        w.write(struct.pack(">I", self._prev_size))
        ts = ts_ms & 0xFFFFFFFF
        w.write(bytes([ttype])
                + struct.pack(">I", len(payload))[1:]
                + struct.pack(">I", ts & 0xFFFFFF)[1:]
                + bytes([(ts >> 24) & 0xFF])
                + b"\x00\x00\x00" + payload)
        self._prev_size = 11 + len(payload)

    def _audio_hdr(self, par) -> bytes:
        fmt = _AUDIO_FMT.get(par.codec_id)
        if fmt is None:
            raise InvalidData(f"flv: unsupported audio {par.codec_id}")
        rates = {5512: 0, 11025: 1, 22050: 2, 44100: 3}
        rate = 3 if fmt == 10 else rates.get(par.sample_rate, 3)
        stereo = 1 if par.channels == 2 else 0
        return bytes([(fmt << 4) | (rate << 2) | (1 << 1) | stereo])

    def _write_packet(self, pkt) -> None:
        st = self.streams[pkt.stream_index]
        par = st.codecpar
        ts_ms = pkt.pts
        if pkt.time_base and pkt.pts is not None:
            ts_ms = (pkt.pts * 1000 * pkt.time_base.num
                     // pkt.time_base.den)
        ts_ms = int(ts_ms or 0)
        if par.codec_type == MediaType.AUDIO:
            hdr = self._audio_hdr(par)
            if par.codec_id == "aac":
                if pkt.stream_index not in self._sent_seq:
                    self._sent_seq.add(pkt.stream_index)
                    self._write_tag(8, 0, hdr + b"\x00"
                                    + (par.extradata or b""))
                self._write_tag(8, ts_ms, hdr + b"\x01" + pkt.data)
            else:
                self._write_tag(8, ts_ms, hdr + pkt.data)
        elif par.codec_type == MediaType.VIDEO:
            codec = _VIDEO_FMT.get(par.codec_id)
            if codec is None:
                raise InvalidData(f"flv: unsupported video {par.codec_id}")
            key = 1 if (pkt.flags & PKT_FLAG_KEY) else 2
            first = bytes([(key << 4) | codec])
            if codec in (7, 12):
                if pkt.stream_index not in self._sent_seq:
                    self._sent_seq.add(pkt.stream_index)
                    self._write_tag(9, 0, bytes([0x10 | codec, 0])
                                    + b"\x00\x00\x00"
                                    + (par.extradata or b""))
                cts = 0
                dts_ms = ts_ms
                if pkt.dts is not None and pkt.time_base:
                    dts_ms = (pkt.dts * 1000 * pkt.time_base.num
                              // pkt.time_base.den)
                    cts = ts_ms - dts_ms
                self._write_tag(9, int(dts_ms),
                                first + b"\x01"
                                + struct.pack(">i", cts)[1:] + pkt.data)
            else:
                self._write_tag(9, ts_ms, first + pkt.data)

    def _write_trailer(self) -> None:
        self.w.write(struct.pack(">I", self._prev_size))
