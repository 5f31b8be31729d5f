"""Matroska/WebM muxer (reference: libavformat/matroskaenc.c).

EBML document writer: header → Segment(unknown size) → Info → Tracks →
Clusters of SimpleBlocks → Cues. Millisecond timestamp scale, clusters
cut on video keyframes / 5 s / 1 MiB like the reference defaults.
Duration is patched at trailer time when the output is seekable.

The port's copy of ffmpeg_tpu/io/formats/matroskaenc.py, held equal to
it by tests/test_torch_io_formats.py.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

from ...core.packet import PKT_FLAG_KEY, Packet
from ...io.stream import MediaType
from ...utils.error import NotSupported
from ...utils.rational import Rational
from ..mux import Muxer, register_muxer
from .matroska import _CODEC_MAP

_REV_CODEC: Dict[str, str] = {}
for k, v in _CODEC_MAP.items():
    _REV_CODEC.setdefault(v, k)

_TRACK_TYPE = {MediaType.VIDEO: 1, MediaType.AUDIO: 2,
               MediaType.SUBTITLE: 17}

TIMESTAMP_SCALE = 1_000_000          # ns per tick -> ms timestamps
_MS = Rational(1, 1000)


def _vint_size(v: int) -> bytes:
    """EBML element size (data-size vint)."""
    for n in range(1, 9):
        if v < (1 << (7 * n)) - 1:
            return ((1 << (7 * n)) | v).to_bytes(n, "big")
    raise ValueError("ebml size too large")


def _vint_track(v: int) -> bytes:
    return _vint_size(v)


def _uint_bytes(v: int) -> bytes:
    n = max(1, (v.bit_length() + 7) // 8)
    return v.to_bytes(n, "big")


def _elem(eid: int, payload: bytes) -> bytes:
    nid = (eid.bit_length() + 7) // 8
    return eid.to_bytes(nid, "big") + _vint_size(len(payload)) + payload


def _e_uint(eid: int, v: int) -> bytes:
    return _elem(eid, _uint_bytes(v))


def _e_str(eid: int, s: str) -> bytes:
    return _elem(eid, s.encode())


def _e_float(eid: int, v: float) -> bytes:
    return _elem(eid, struct.pack(">d", v))


_MATRIX_CODE = {"rgb": 0, "bt709": 1, "fcc": 4, "bt470bg": 5,
                "smpte170m": 6, "smpte240m": 7, "bt2020nc": 9,
                "bt2020c": 10}
_TRC_CODE = {"bt709": 1, "smpte170m": 6, "smpte240m": 7,
             "linear": 8, "iec61966-2-1": 13, "srgb": 13,
             "bt2020-10": 14, "bt2020-12": 15, "smpte2084": 16,
             "arib-std-b67": 18}
_PRIM_CODE = {"bt709": 1, "bt470bg": 5, "smpte170m": 6,
              "smpte240m": 7, "bt2020": 9, "smpte431": 11,
              "smpte432": 12}


@register_muxer
class MatroskaMuxer(Muxer):
    name = "matroska"
    long_name = "Matroska"
    extensions = ("mkv", "webm")
    default_video_codec = "mjpeg"
    default_audio_codec = "pcm_s16le"

    CLUSTER_MS = 5000
    CLUSTER_BYTES = 1 << 20

    def _write_header(self) -> None:
        w = self.w
        w.write(_elem(0x1A45DFA3, b"".join([
            _e_uint(0x4286, 1),          # EBMLVersion
            _e_uint(0x42F7, 1),          # EBMLReadVersion
            _e_uint(0x42F2, 4),          # EBMLMaxIDLength
            _e_uint(0x42F3, 8),          # EBMLMaxSizeLength
            _e_str(0x4282, "matroska"),  # DocType
            _e_uint(0x4287, 4),          # DocTypeVersion
            _e_uint(0x4285, 2),          # DocTypeReadVersion
        ])))
        # Segment with unknown size (streaming layout, like the
        # reference's live mode; trailer patches Duration only)
        w.write(b"\x18\x53\x80\x67" + b"\x01" + b"\xff" * 7)
        self._seg_start = w.tell()
        app = "ffmpeg_tpu"
        info = [_e_uint(0x2AD7B1, TIMESTAMP_SCALE),
                _e_str(0x4D80, app), _e_str(0x5741, app)]
        self._dur_pos = None
        if w.seekable:
            # Duration placeholder: the trailing 8-byte float, patched
            # in the trailer
            info.append(_e_float(0x4489, 0.0))
            full = _elem(0x1549A966, b"".join(info))
            self._dur_pos = w.tell() + len(full) - 8
            w.write(full)
        else:
            w.write(_elem(0x1549A966, b"".join(info)))

        tracks = []
        for st in self.streams:
            par = st.codecpar
            cid = _REV_CODEC.get(par.codec_id)
            if cid is None:
                raise NotSupported(f"matroska: codec {par.codec_id!r}")
            ent = [_e_uint(0xD7, st.index + 1),       # TrackNumber
                   _e_uint(0x73C5, st.index + 1),     # TrackUID
                   _e_uint(0x83, _TRACK_TYPE.get(par.codec_type, 1)),
                   _e_uint(0x9C, 0),                  # FlagLacing
                   _e_str(0x86, cid)]
            if par.extradata:
                ent.append(_elem(0x63A2, bytes(par.extradata)))
            if par.codec_type == MediaType.VIDEO:
                video = [_e_uint(0xB0, par.width),
                         _e_uint(0xBA, par.height)]
                colour = self._colour_element(par)
                if colour:
                    video.append(colour)
                ent.append(_elem(0xE0, b"".join(video)))
                fr = getattr(par, "framerate", None)
                if fr and getattr(fr, "num", 0):
                    ent.append(_e_uint(0x23E383,
                                       10 ** 9 * fr.den // fr.num))
            elif par.codec_type == MediaType.AUDIO:
                ent.append(_elem(0xE1, b"".join([
                    _e_float(0xB5, float(par.sample_rate or 48000)),
                    _e_uint(0x9F, par.channels or 1),
                    _e_uint(0x6264, getattr(par, "bits_per_sample", 0)
                            or 16)])))
            tracks.append(_elem(0xAE, b"".join(ent)))
        w.write(_elem(0x1654AE6B, b"".join(tracks)))
        self._cluster: List[bytes] = []
        self._cluster_ts = 0
        self._cluster_bytes = 0
        self._cluster_open = False
        self._max_ts = 0
        self._cues: List[tuple] = []

    # ------------------------------------------------------------ packets
    def _colour_element(self, par) -> bytes:
        """Colour element with CICP codes + mastering display /
        content light metadata (matroskaenc.c mkv_write_video_color
        analog). Empty bytes when nothing is tagged."""
        parts = []
        m = _MATRIX_CODE.get(getattr(par, "color_space", ""))
        if m is not None:
            parts.append(_e_uint(0x55B1, m))
        t = _TRC_CODE.get(getattr(par, "color_trc", ""))
        if t is not None:
            parts.append(_e_uint(0x55BA, t))
        p = _PRIM_CODE.get(getattr(par, "color_primaries", ""))
        if p is not None:
            parts.append(_e_uint(0x55BB, p))
        rng = getattr(par, "color_range", "unspecified")
        if rng in ("tv", "mpeg", "limited"):
            parts.append(_e_uint(0x55B9, 1))
        elif rng in ("pc", "jpeg", "full"):
            parts.append(_e_uint(0x55B9, 2))
        cl = getattr(par, "content_light", None)
        if cl:
            parts.append(_e_uint(0x55BC, int(cl.get("max_cll", 0))))
            parts.append(_e_uint(0x55BD,
                                 int(cl.get("max_fall", 0))))
        md = getattr(par, "mastering_display", None)
        if md:
            ids = {"rx": 0x55D1, "ry": 0x55D2, "gx": 0x55D3,
                   "gy": 0x55D4, "bx": 0x55D5, "by": 0x55D6,
                   "wx": 0x55D7, "wy": 0x55D8,
                   "max_luminance": 0x55D9,
                   "min_luminance": 0x55DA}
            inner = [
                _e_float(ids[k], float(md[k]))
                for k in ids if k in md]
            if inner:
                parts.append(_elem(0x55D0, b"".join(inner)))
        if not parts:
            return b""
        return _elem(0x55B0, b"".join(parts))

    def _pkt_ms(self, pkt: Packet) -> int:
        tb = pkt.time_base or self.streams[pkt.stream_index].time_base
        ts = pkt.pts if pkt.pts is not None else (pkt.dts or 0)
        return int(round(ts * tb.num * 1000 / tb.den))

    def _flush_cluster(self):
        if self._cluster_open:
            self.w.write(_elem(0x1F43B675, b"".join(self._cluster)))
            self._cluster = []
            self._cluster_open = False

    def _write_packet(self, pkt: Packet) -> None:
        ms = self._pkt_ms(pkt)
        self._max_ts = max(self._max_ts, ms)
        key = bool(pkt.flags & PKT_FLAG_KEY)
        is_video = (self.streams[pkt.stream_index].codecpar.codec_type
                    == MediaType.VIDEO)
        need_new = (not self._cluster_open
                    or (is_video and key and self._cluster_bytes > 0)
                    or ms - self._cluster_ts > self.CLUSTER_MS
                    or ms - self._cluster_ts < 0
                    or self._cluster_bytes > self.CLUSTER_BYTES)
        if need_new:
            self._flush_cluster()
            self._cluster_ts = ms
            self._cluster = [_e_uint(0xE7, max(0, ms))]
            self._cluster_bytes = 0
            self._cluster_open = True
            if is_video and key:
                self._cues.append((ms, pkt.stream_index + 1,
                                   self.w.tell()))
        rel = ms - self._cluster_ts
        flags = 0x80 if key else 0x00
        block = (_vint_track(pkt.stream_index + 1)
                 + struct.pack(">hB", rel, flags) + bytes(pkt.data))
        self._cluster.append(_elem(0xA3, block))
        self._cluster_bytes += len(pkt.data)

    def _write_trailer(self) -> None:
        self._flush_cluster()
        if self._cues:
            cues = []
            for ms, track, pos in self._cues:
                cues.append(_elem(0xBB, b"".join([
                    _e_uint(0xB3, max(0, ms)),
                    _elem(0xB7, b"".join([
                        _e_uint(0xF7, track),
                        _e_uint(0xF1, pos - self._seg_start)]))])))
            self.w.write(_elem(0x1C53BB6B, b"".join(cues)))
        if self._dur_pos is not None:
            end = self.w.tell()
            self.w.seek(self._dur_pos)
            self.w.write(struct.pack(">d", float(self._max_ts)))
            self.w.seek(end)
