"""Bitstream filters (analog of libavcodec/bsf/, 52 BSFs in the reference).

Implemented: null, h264_mp4toannexb / hevc_mp4toannexb (length-prefixed →
Annex-B with parameter-set injection), extract_extradata (h264/hevc),
noise (fault injection, like bsf/noise.c for resilience testing),
setts-style timestamp shift, chomp, dump_extradata.

The port's copy of ffmpeg_tpu/codecs/bsf.py, held equal to it by
tests/test_torch_bsf_av1.py.
The filters are host code on the packets' bytes; noise keeps the
reference's seeded numpy generator, so its output is the reference's
byte for byte.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Type

import numpy as np

from ..core.packet import Packet
from ..utils.rational import NOPTS
from ..utils.error import InvalidData
from ..io.stream import CodecParameters

_BSFS: Dict[str, Type["BitstreamFilter"]] = {}


def register_bsf(cls):
    _BSFS[cls.name] = cls
    return cls


def bsf_names() -> List[str]:
    return sorted(_BSFS)


def get_bsf(name: str, par: Optional[CodecParameters] = None, **opts):
    cls = _BSFS.get(name)
    if cls is None:
        raise InvalidData(f"unknown bitstream filter {name!r}")
    return cls(par, **opts)


class BitstreamFilter:
    name = "?"

    def __init__(self, par: Optional[CodecParameters] = None, **opts):
        self.par = par
        for k, v in opts.items():
            setattr(self, k, v)

    def filter(self, pkt: Packet) -> List[Packet]:
        return [pkt]


@register_bsf
class NullBsf(BitstreamFilter):
    name = "null"


@register_bsf
class ChompBsf(BitstreamFilter):
    """Strip trailing zero bytes (bsf/chomp.c)."""

    name = "chomp"

    def filter(self, pkt: Packet) -> List[Packet]:
        pkt.data = pkt.data.rstrip(b"\x00")
        return [pkt]


def _parse_avcc(extradata: bytes):
    """avcC → (nal_length_size, [sps...], [pps...])."""
    if len(extradata) < 7 or extradata[0] != 1:
        raise InvalidData("not avcC extradata")
    nal_size = (extradata[4] & 3) + 1
    i = 5
    nsps = extradata[i] & 0x1F
    i += 1
    sps = []
    for _ in range(nsps):
        ln = struct.unpack(">H", extradata[i:i + 2])[0]
        sps.append(extradata[i + 2:i + 2 + ln])
        i += 2 + ln
    npps = extradata[i]
    i += 1
    pps = []
    for _ in range(npps):
        ln = struct.unpack(">H", extradata[i:i + 2])[0]
        pps.append(extradata[i + 2:i + 2 + ln])
        i += 2 + ln
    return nal_size, sps, pps


def _split_length_prefixed(data: bytes, nal_size: int) -> List[bytes]:
    nals = []
    i = 0
    while i + nal_size <= len(data):
        ln = int.from_bytes(data[i:i + nal_size], "big")
        i += nal_size
        nals.append(data[i:i + ln])
        i += ln
    return nals


@register_bsf
class H264Mp4ToAnnexB(BitstreamFilter):
    """length-prefixed AVC → Annex-B start codes + SPS/PPS before IDR
    (bsf/h264_mp4toannexb.c semantics)."""

    name = "h264_mp4toannexb"

    def __init__(self, par=None, **opts):
        super().__init__(par, **opts)
        self.nal_size = 4
        self.sps: List[bytes] = []
        self.pps: List[bytes] = []
        if par is not None and par.extradata and par.extradata[0] == 1:
            self.nal_size, self.sps, self.pps = _parse_avcc(par.extradata)

    def filter(self, pkt: Packet) -> List[Packet]:
        if self.par is not None and (not pkt.data or
                                     (self.par.extradata or b"")[:1] != b"\x01"
                                     and not self.sps):
            return [pkt]   # already annex-b
        out = bytearray()
        for nal in _split_length_prefixed(pkt.data, self.nal_size):
            if not nal:
                continue
            ntype = nal[0] & 0x1F
            if ntype == 5 and self.sps:   # IDR: prepend parameter sets
                for ps in self.sps + self.pps:
                    out += b"\x00\x00\x00\x01" + ps
                self.sps = []   # once per stream like the reference default
            out += b"\x00\x00\x00\x01" + nal
        pkt.data = bytes(out)
        return [pkt]


@register_bsf
class ExtractExtradata(BitstreamFilter):
    """Pull SPS/PPS NALs out of Annex-B h264 streams into side data."""

    name = "extract_extradata"

    @staticmethod
    def _annexb_nals(data: bytes) -> List[bytes]:
        nals = []
        i = 0
        n = len(data)
        while True:
            j = data.find(b"\x00\x00\x01", i)
            if j < 0:
                break
            start = j + 3
            k = data.find(b"\x00\x00\x01", start)
            end = k - (1 if k > 0 and data[k - 1] == 0 else 0) if k >= 0 else n
            nals.append(data[start:end])
            if k < 0:
                break
            i = k
        return nals

    def filter(self, pkt: Packet) -> List[Packet]:
        ps = []
        for nal in self._annexb_nals(pkt.data):
            if nal and (nal[0] & 0x1F) in (7, 8):
                ps.append(b"\x00\x00\x00\x01" + nal)
        if ps:
            pkt.side_data["new_extradata"] = b"".join(ps)
        return [pkt]


@register_bsf
class NoiseBsf(BitstreamFilter):
    """Fault injection: corrupt packet bytes (bsf/noise.c analog). Options:
    amount = corrupt 1 byte every `amount` bytes; seed for determinism."""

    name = "noise"
    amount = 100
    seed = 0

    def __init__(self, par=None, **opts):
        super().__init__(par, **opts)
        self._rng = np.random.default_rng(int(self.seed))

    def filter(self, pkt: Packet) -> List[Packet]:
        data = bytearray(pkt.data)
        n = len(data)
        amount = max(1, int(self.amount))
        for i in range(n // amount):
            pos = int(self._rng.integers(0, n))
            data[pos] ^= int(self._rng.integers(1, 256))
        pkt.data = bytes(data)
        return [pkt]


@register_bsf
class SetTsBsf(BitstreamFilter):
    """Shift/scale timestamps (setts analog). Options: offset (ticks)."""

    name = "setts"
    offset = 0

    def filter(self, pkt: Packet) -> List[Packet]:
        from ..utils.rational import NOPTS
        if pkt.pts != NOPTS:
            pkt.pts += int(self.offset)
        if pkt.dts != NOPTS:
            pkt.dts += int(self.offset)
        return [pkt]


@register_bsf
class DumpExtradata(BitstreamFilter):
    """Prepend stream extradata to keyframes (dump_extradata.c analog)."""

    name = "dump_extradata"

    def __init__(self, par=None, **opts):
        super().__init__(par, **opts)
        self._done = False

    def filter(self, pkt: Packet) -> List[Packet]:
        if not self._done and self.par is not None and self.par.extradata \
                and pkt.is_keyframe:
            pkt.data = self.par.extradata + pkt.data
            self._done = True
        return [pkt]


@register_bsf
class H264MetadataBsf(BitstreamFilter):
    """Edit H.264 parameter-set syntax in-stream via the CBS framework
    (bsf/h264_metadata.c analog). Options: level=<idc>, profile=<idc>,
    max_ref_frames=<n>. Unsupported/opaque units pass through."""

    name = "h264_metadata"
    level = None
    profile = None
    max_ref_frames = None

    def filter(self, pkt: Packet) -> List[Packet]:
        from .cbs import CodedBitstream
        from .h264 import nal as _nal
        from ..utils.error import InvalidData as _ID
        out = bytearray()
        data = bytes(pkt.data)
        # Annex B walk preserving start-code lengths
        i = 0
        units = []
        starts = []
        pos = 0
        while True:
            j = data.find(b"\x00\x00\x01", pos)
            if j < 0:
                break
            sc = 4 if j > 0 and data[j - 1] == 0 else 3
            nstart = j + 3
            k = data.find(b"\x00\x00\x01", nstart)
            end = len(data) if k < 0 else (k - 1 if data[k - 1] == 0
                                           and k > 0 else k)
            units.append((data[j - (sc - 3):j + 3] if sc == 4
                          else data[j:j + 3], data[nstart:end]))
            pos = nstart
        if not units:
            return [pkt]
        for sc, unit in units:
            try:
                obj = CodedBitstream.read_nal(unit)
            except _ID:
                obj = None
            if obj is not None and obj["_nal_type"] == 7:
                if self.level is not None:
                    obj["level_idc"] = int(self.level)
                if self.profile is not None:
                    obj["profile_idc"] = int(self.profile)
                if self.max_ref_frames is not None:
                    obj["max_num_ref_frames"] = int(self.max_ref_frames)
                unit = CodedBitstream.write_nal(obj)
            out += sc + unit
        new = Packet(data=bytes(out), pts=pkt.pts, dts=pkt.dts,
                     duration=pkt.duration, flags=pkt.flags,
                     stream_index=pkt.stream_index,
                     time_base=pkt.time_base)
        return [new]


def _parse_hvcc(extradata: bytes):
    """hvcC → (nal_size, [parameter-set NALs]) (hevc_mp4toannexb.c)."""
    if len(extradata) < 23 or extradata[0] != 1:
        raise InvalidData("hvcC: bad header")
    nal_size = (extradata[21] & 3) + 1
    ps: List[bytes] = []
    pos = 23
    for _ in range(extradata[22]):
        pos += 1                                 # array completeness+type
        n = int.from_bytes(extradata[pos:pos + 2], "big")
        pos += 2
        for _ in range(n):
            ln = int.from_bytes(extradata[pos:pos + 2], "big")
            ps.append(extradata[pos + 2:pos + 2 + ln])
            pos += 2 + ln
    return nal_size, ps


@register_bsf
class HevcMp4ToAnnexB(BitstreamFilter):
    """length-prefixed HEVC → Annex-B, VPS/SPS/PPS before IRAP
    (bsf/hevc_mp4toannexb.c semantics)."""

    name = "hevc_mp4toannexb"

    def __init__(self, par=None, **opts):
        super().__init__(par, **opts)
        self.nal_size = 4
        self.ps: List[bytes] = []
        if par is not None and par.extradata and par.extradata[0] == 1 \
                and len(par.extradata) > 22:
            self.nal_size, self.ps = _parse_hvcc(par.extradata)

    def filter(self, pkt: Packet) -> List[Packet]:
        if pkt is None:
            return []
        if not self.ps and not (self.par and (self.par.extradata or b"")
                                [:1] == b"\x01"):
            return [pkt]   # already annex-b
        out = bytearray()
        # Per-packet got_irap, as the reference: prepend the parameter sets
        # before the FIRST IRAP of every packet (mid-stream join/seek), but
        # not when the packet already carries its own PS NALs before it.
        got_irap = False
        seen_ps = False
        for nal in _split_length_prefixed(pkt.data, self.nal_size):
            if len(nal) < 2:
                continue
            ntype = (nal[0] >> 1) & 0x3F
            if 32 <= ntype <= 34:                # VPS/SPS/PPS in-band
                seen_ps = True
            if (16 <= ntype <= 23 and self.ps and not got_irap
                    and not seen_ps):
                for ps in self.ps:
                    out += b"\x00\x00\x00\x01" + ps
            if 16 <= ntype <= 23:
                got_irap = True
            out += b"\x00\x00\x00\x01" + nal
        pkt.data = bytes(out)
        return [pkt]


@register_bsf
class Vp9SuperframeSplit(BitstreamFilter):
    """Split VP9 superframes into one packet per coded frame
    (bsf/vp9_superframe_split.c)."""

    name = "vp9_superframe_split"

    def filter(self, pkt: Packet) -> List[Packet]:
        if pkt is None:
            return []
        from .vp9 import split_superframe
        subs = split_superframe(bytes(pkt.data))
        out = []
        for i, sub in enumerate(subs):
            np = Packet(data=sub, pts=pkt.pts if i == len(subs) - 1
                        else NOPTS,
                        dts=pkt.dts, duration=pkt.duration,
                        flags=pkt.flags, stream_index=pkt.stream_index,
                        time_base=pkt.time_base)
            out.append(np)
        return out


@register_bsf
class Vp9Superframe(BitstreamFilter):
    """Merge invisible VP9 frames with the next visible one into a
    superframe (bsf/vp9_superframe.c)."""

    name = "vp9_superframe"

    def __init__(self, par=None, **opts):
        super().__init__(par, **opts)
        self._pending: List[Packet] = []

    @staticmethod
    def _is_visible(data: bytes) -> bool:
        if not data:
            return False
        b0 = data[0]
        if (b0 >> 6) != 2:            # frame marker
            return True
        profile = ((b0 >> 5) & 1) | (((b0 >> 4) & 1) << 1)
        bit = 3 if profile < 3 else 2  # skip reserved bit for profile 3
        show_existing = (b0 >> bit) & 1
        if show_existing:
            return True
        # frame_type(1) then show_frame(1)
        return bool((b0 >> (bit - 2)) & 1)

    @staticmethod
    def _build_superframe(frames: List[bytes]) -> bytes:
        sizes = [len(f) for f in frames]
        nbytes = max(1, (max(sizes).bit_length() + 7) // 8)
        marker = 0xC0 | ((nbytes - 1) << 3) | (len(frames) - 1)
        idx = bytearray([marker])
        for sz in sizes:
            idx += sz.to_bytes(nbytes, "little")
        idx.append(marker)
        return b"".join(frames) + bytes(idx)

    def filter(self, pkt: Packet) -> List[Packet]:
        if pkt is None:
            out = self._pending
            self._pending = []
            return out
        data = bytes(pkt.data)
        if not self._is_visible(data):
            self._pending.append(pkt)
            return []
        if not self._pending:
            return [pkt]
        frames = [bytes(p.data) for p in self._pending] + [data]
        self._pending = []
        pkt.data = self._build_superframe(frames)
        return [pkt]


def _annexb_units(data: bytes):
    """→ [(start_code_bytes, nal_bytes)] preserving start-code lengths."""
    units = []
    pos = 0
    while True:
        j = data.find(b"\x00\x00\x01", pos)
        if j < 0:
            break
        sc = 4 if j > 0 and data[j - 1] == 0 else 3
        nstart = j + 3
        k = data.find(b"\x00\x00\x01", nstart)
        end = len(data) if k < 0 else (k - 1 if k > 0 and data[k - 1] == 0
                                       else k)
        units.append((data[j - 1:nstart] if sc == 4 else data[j:nstart],
                      data[nstart:end]))
        pos = nstart
    return units


@register_bsf
class HevcMetadataBsf(BitstreamFilter):
    """Edit HEVC parameter-set syntax in-stream via the CBS framework
    (bsf/h265_metadata.c analog). Options:

      level=<idc*30 or idc>    general_level_idc (VPS+SPS PTL)
      sample_aspect_ratio=W:H  VUI aspect ratio (writes idc 255 SAR)
      video_format=<0..5>, video_full_range_flag=<0|1>
      colour_primaries=, transfer_characteristics=, matrix_coeffs=
      chroma_sample_loc_type=<0..5>
      tick_rate=NUM:DEN        VUI timing (time_scale:num_units)
      crop_left/right/top/bottom=<px> (conformance window, chroma units
      applied per chroma format like the reference)

    Unsupported/opaque units pass through untouched."""

    name = "hevc_metadata"
    level = None
    sample_aspect_ratio = None
    video_format = None
    video_full_range_flag = None
    colour_primaries = None
    transfer_characteristics = None
    matrix_coeffs = None
    chroma_sample_loc_type = None
    tick_rate = None
    crop_left = None
    crop_right = None
    crop_top = None
    crop_bottom = None

    def _edit_vui(self, obj):
        def ensure(flag):
            if not obj.get(flag):
                obj[flag] = 1

        ensure("vui_parameters_present_flag")
        for k, default in (
                ("aspect_ratio_info_present_flag", 0),
                ("overscan_info_present_flag", 0),
                ("video_signal_type_present_flag", 0),
                ("chroma_loc_info_present_flag", 0),
                ("neutral_chroma_indication_flag", 0),
                ("field_seq_flag", 0),
                ("frame_field_info_present_flag", 0),
                ("default_display_window_flag", 0),
                ("vui_timing_info_present_flag", 0),
                ("bitstream_restriction_flag", 0)):
            obj.setdefault(k, default)
        if self.sample_aspect_ratio is not None:
            w, h = str(self.sample_aspect_ratio).replace("/", ":").split(":")
            obj["aspect_ratio_info_present_flag"] = 1
            obj["aspect_ratio_idc"] = 255
            obj["sar_width"] = int(w)
            obj["sar_height"] = int(h)
        if self.video_format is not None or \
                self.video_full_range_flag is not None or \
                self.colour_primaries is not None or \
                self.transfer_characteristics is not None or \
                self.matrix_coeffs is not None:
            obj["video_signal_type_present_flag"] = 1
            obj.setdefault("video_format", 5)
            obj.setdefault("video_full_range_flag", 0)
            obj.setdefault("colour_description_present_flag", 0)
            if self.video_format is not None:
                obj["video_format"] = int(self.video_format)
            if self.video_full_range_flag is not None:
                obj["video_full_range_flag"] = int(self.video_full_range_flag)
            if self.colour_primaries is not None or \
                    self.transfer_characteristics is not None or \
                    self.matrix_coeffs is not None:
                obj["colour_description_present_flag"] = 1
                obj.setdefault("colour_primaries", 2)
                obj.setdefault("transfer_characteristics", 2)
                obj.setdefault("matrix_coeffs", 2)
                if self.colour_primaries is not None:
                    obj["colour_primaries"] = int(self.colour_primaries)
                if self.transfer_characteristics is not None:
                    obj["transfer_characteristics"] = \
                        int(self.transfer_characteristics)
                if self.matrix_coeffs is not None:
                    obj["matrix_coeffs"] = int(self.matrix_coeffs)
        if self.chroma_sample_loc_type is not None:
            obj["chroma_loc_info_present_flag"] = 1
            obj["chroma_sample_loc_type_top_field"] = \
                int(self.chroma_sample_loc_type)
            obj["chroma_sample_loc_type_bottom_field"] = \
                int(self.chroma_sample_loc_type)
        if self.tick_rate is not None:
            num, den = str(self.tick_rate).replace("/", ":").split(":")
            obj["vui_timing_info_present_flag"] = 1
            obj["vui_num_units_in_tick"] = int(den)
            obj["vui_time_scale"] = int(num)
            obj.setdefault("vui_poc_proportional_to_timing_flag", 0)
            obj.setdefault("vui_hrd_parameters_present_flag", 0)

    def filter(self, pkt: Packet) -> List[Packet]:
        from .cbs import HevcCodedBitstream
        from ..utils.error import InvalidData as _ID
        data = bytes(pkt.data)
        units = _annexb_units(data)
        if not units:
            return [pkt]
        out = bytearray()
        for sc, unit in units:
            try:
                obj = HevcCodedBitstream.read_nal(unit)
            except _ID:
                obj = None
            if obj is not None:
                if self.level is not None and "general_level_idc" in obj:
                    lv = float(self.level)
                    obj["general_level_idc"] = \
                        round(lv * 30) if lv < 8.1 else int(lv)
                if obj["_nal_type"] == 33:
                    self._edit_vui(obj)
                    crop = {"crop_left": "conf_win_left_offset",
                            "crop_right": "conf_win_right_offset",
                            "crop_top": "conf_win_top_offset",
                            "crop_bottom": "conf_win_bottom_offset"}
                    if any(getattr(self, k) is not None for k in crop):
                        sub = 2 if obj["chroma_format_idc"] in (1, 2) \
                            else 1
                        obj["conformance_window_flag"] = 1
                        for k, fk in crop.items():
                            obj.setdefault(fk, 0)
                            v = getattr(self, k)
                            if v is not None:
                                obj[fk] = int(v) // sub
                unit = HevcCodedBitstream.write_nal(obj)
            out += sc + unit
        new = Packet(data=bytes(out), pts=pkt.pts, dts=pkt.dts,
                     duration=pkt.duration, flags=pkt.flags,
                     stream_index=pkt.stream_index,
                     time_base=pkt.time_base)
        return [new]


@register_bsf
class Av1MetadataBsf(BitstreamFilter):
    """Edit AV1 sequence-header OBU syntax (bsf/av1_metadata.c analog).
    Options: color_primaries, transfer_characteristics,
    matrix_coefficients, color_range (tv|pc|0|1),
    chroma_sample_position (unknown|vertical|colocated|0..3).
    Other OBUs pass through byte-identical."""

    name = "av1_metadata"
    color_primaries = None
    transfer_characteristics = None
    matrix_coefficients = None
    color_range = None
    chroma_sample_position = None

    _CSP = {"unknown": 0, "vertical": 1, "colocated": 2}
    _RANGE = {"tv": 0, "pc": 1}

    def filter(self, pkt: Packet) -> List[Packet]:
        from . import av1 as A
        data = bytes(pkt.data)
        try:
            obus = A.split_obus(data)
        except InvalidData:
            return [pkt]
        out = bytearray()
        for obu in obus:
            if obu.type == A.OBU_SEQUENCE_HEADER:
                s = A.parse_sequence_header(obu.payload)
                if self.color_primaries is not None or \
                        self.transfer_characteristics is not None or \
                        self.matrix_coefficients is not None:
                    s.color_description_present = 1
                    if self.color_primaries is not None:
                        s.color_primaries = int(self.color_primaries)
                    if self.transfer_characteristics is not None:
                        s.transfer_characteristics = \
                            int(self.transfer_characteristics)
                    if self.matrix_coefficients is not None:
                        s.matrix_coefficients = \
                            int(self.matrix_coefficients)
                if self.color_range is not None:
                    s.color_range = self._RANGE.get(
                        str(self.color_range), None)
                    if s.color_range is None:
                        s.color_range = int(self.color_range)
                if self.chroma_sample_position is not None and \
                        s.subsampling_x and s.subsampling_y:
                    v = self._CSP.get(str(self.chroma_sample_position))
                    s.chroma_sample_position = (
                        v if v is not None
                        else int(self.chroma_sample_position))
                out += A.wrap_obu(A.OBU_SEQUENCE_HEADER,
                                  A.write_sequence_header(s))
            else:
                out += obu.raw
        new = Packet(data=bytes(out), pts=pkt.pts, dts=pkt.dts,
                     duration=pkt.duration, flags=pkt.flags,
                     stream_index=pkt.stream_index,
                     time_base=pkt.time_base)
        return [new]


@register_bsf
class Dts2PtsBsf(BitstreamFilter):
    """Derive missing DTS from PTS for reordered streams
    (bsf/dts2pts.c scope, reordering-heap method): packets arrive in
    decode order; the k-th smallest PTS seen so far is the DTS of the
    k-th packet once `delay` packets of lookahead are buffered, which
    is exact whenever `delay` >= the stream's reorder depth (the
    reference derives the same order from the H.264 POC GOP tree)."""

    name = "dts2pts"
    delay = 2

    def __init__(self, par=None, **opts):
        super().__init__(par, **opts)
        import heapq
        self._heapq = heapq
        self._pts_heap: List[int] = []
        self._queue: List[Packet] = []
        self._dur = 0

    def _drain(self, flush=False) -> List[Packet]:
        out = []
        want = 0 if flush else int(self.delay)
        shift = int(self.delay) * (self._dur or 1)
        while self._queue and len(self._queue) > want:
            pkt = self._queue.pop(0)
            # k-th smallest pts, shifted back by the reorder delay so
            # dts <= pts holds for every packet (x264-style bumping)
            pkt.dts = self._heapq.heappop(self._pts_heap) - shift
            out.append(pkt)
        return out

    def filter(self, pkt: Optional[Packet]) -> List[Packet]:
        if pkt is None:
            return self._drain(flush=True)
        if pkt.pts != NOPTS:
            if not self._dur:
                self._dur = max(int(pkt.duration or 0), 0)
            self._heapq.heappush(self._pts_heap, pkt.pts)
            self._queue.append(pkt)
            return self._drain()
        return [pkt]
