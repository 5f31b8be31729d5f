"""SPS / PPS parsing (reference: libavcodec/h264_ps.c). Frame-coded
4:2:0 8-bit profiles incl. High (scaling lists + 8x8 transform).

The port's copy of ffmpeg_tpu/codecs/h264/params.py, held equal to it by
tests/test_torch_h264_host.py."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ...utils.error import NotSupported
from .bits import Bits

# default scaling lists, zigzag order (spec Tables 7-3/7-4)
DEFAULT_4X4_INTRA = [6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32,
                     32, 37, 37, 42]
DEFAULT_4X4_INTER = [10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27,
                     27, 30, 30, 34]
DEFAULT_8X8_INTRA = [
    6, 10, 10, 13, 11, 13, 16, 16, 16, 16, 18, 18, 18, 18, 18, 23,
    23, 23, 23, 23, 23, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27,
    27, 27, 27, 27, 29, 29, 29, 29, 29, 29, 29, 29, 31, 31, 31, 31,
    31, 31, 31, 33, 33, 33, 33, 33, 33, 36, 36, 36, 36, 38, 38, 40]
DEFAULT_8X8_INTER = [
    9, 13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21,
    21, 21, 21, 21, 21, 22, 22, 22, 22, 22, 22, 22, 24, 24, 24, 24,
    24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27,
    27, 27, 27, 28, 28, 28, 28, 28, 28, 30, 30, 30, 30, 32, 32, 33]

# zigzag index -> raster position
ZZ4 = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]
ZZ8 = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
       12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
       35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
       58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


def _parse_scaling_list(b: Bits, size: int):
    """scaling_list() of 7.3.2.1.1.1: returns values in zigzag order or
    None for 'use default'."""
    last, nxt = 8, 8
    out = []
    for i in range(size):
        if nxt != 0:
            nxt = (last + b.se() + 256) % 256
            if i == 0 and nxt == 0:
                return None
        val = last if nxt == 0 else nxt
        out.append(val)
        last = val
    return out


def _zz_to_raster(vals, size):
    zz = ZZ4 if size == 16 else ZZ8
    out = [0] * size
    for i, v in enumerate(vals):
        out[zz[i]] = v
    return out


def parse_scaling_matrices(b: Bits, n8: int, fallback4, fallback8):
    """Shared SPS/PPS scaling-matrix parse with fall-back rules
    (Table 7-2). fallback4/(8): (6,16)/(2,64) raster arrays used when a
    list's present flag is 0 at the rule-A/B anchor indices.
    Returns raster (6, 16) and (2, 64) numpy arrays."""
    s4 = [None] * 6
    s8 = [None] * max(2, n8)
    for i in range(6 + n8):
        present = b.get1()
        vals = _parse_scaling_list(b, 16 if i < 6 else 64) if present \
            else False               # False = absent, None = use-default
        if i < 6:
            s4[i] = vals
        else:
            s8[i - 6] = vals
    out4 = np.zeros((6, 16), np.int32)
    defaults4 = (DEFAULT_4X4_INTRA, DEFAULT_4X4_INTER)
    for i in range(6):
        v = s4[i]
        if v is False:               # absent: fall-back rule
            if i in (0, 3):
                out4[i] = fallback4[i] if fallback4 is not None else \
                    _zz_to_raster(defaults4[i // 3], 16)
            else:
                out4[i] = out4[i - 1]
        elif v is None:              # explicit use-default
            out4[i] = _zz_to_raster(defaults4[i // 3], 16)
        else:
            out4[i] = _zz_to_raster(v, 16)
    out8 = np.zeros((2, 64), np.int32)
    defaults8 = (DEFAULT_8X8_INTRA, DEFAULT_8X8_INTER)
    for i in range(2):
        v = s8[i] if i < len(s8) else False
        if v is False:
            out8[i] = fallback8[i] if fallback8 is not None else \
                _zz_to_raster(defaults8[i], 64)
        elif v is None:
            out8[i] = _zz_to_raster(defaults8[i], 64)
        else:
            out8[i] = _zz_to_raster(v, 64)
    return out4, out8


_FLAT4 = np.full((6, 16), 16, np.int32)
_FLAT8 = np.full((2, 64), 16, np.int32)


@dataclass
class SPS:
    profile_idc: int = 66
    level_idc: int = 30
    sps_id: int = 0
    chroma_format_idc: int = 1
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    log2_max_frame_num: int = 4
    poc_type: int = 0
    log2_max_poc_lsb: int = 4
    delta_pic_order_always_zero: bool = False
    num_ref_frames: int = 1
    gaps_in_frame_num_allowed: bool = False
    mb_width: int = 0
    mb_height: int = 0
    frame_mbs_only: bool = True
    mb_aff: bool = False
    direct_8x8_inference: bool = True
    crop_left: int = 0
    crop_right: int = 0
    crop_top: int = 0
    crop_bottom: int = 0
    scaling4: object = None          # (6, 16) raster or None (flat)
    scaling8: object = None          # (2, 64) raster or None (flat)

    @property
    def width(self) -> int:
        return self.mb_width * 16 - 2 * (self.crop_left + self.crop_right)

    @property
    def height(self) -> int:
        # frame height; for interlaced SPS mb_height counts field MB
        # rows and the vertical crop unit doubles (7.4.2.1.1)
        mult = 2 - int(self.frame_mbs_only)
        return self.mb_height * 16 * mult \
            - 2 * mult * (self.crop_top + self.crop_bottom)


def parse_sps(rbsp: bytes) -> SPS:
    b = Bits(rbsp)
    s = SPS()
    s.profile_idc = b.get(8)
    b.get(8)                    # constraint flags + reserved
    s.level_idc = b.get(8)
    s.sps_id = b.ue()
    if s.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138,
                         139, 134, 135):
        s.chroma_format_idc = b.ue()
        if s.chroma_format_idc == 3:
            b.get1()            # separate_colour_plane
        s.bit_depth_luma = b.ue() + 8
        s.bit_depth_chroma = b.ue() + 8
        b.get1()                # qpprime_y_zero_transform_bypass
        if b.get1():            # seq_scaling_matrix_present
            s.scaling4, s.scaling8 = parse_scaling_matrices(
                b, 2, None, None)
    if s.chroma_format_idc != 1:
        raise NotSupported("h264: only 4:2:0 chroma supported")
    if not 8 <= s.bit_depth_luma <= 14 or \
            s.bit_depth_chroma != s.bit_depth_luma:
        raise NotSupported("h264: bit depth must be 8..14, luma==chroma")
    s.log2_max_frame_num = b.ue() + 4
    s.poc_type = b.ue()
    if s.poc_type == 0:
        s.log2_max_poc_lsb = b.ue() + 4
    elif s.poc_type == 1:
        s.delta_pic_order_always_zero = bool(b.get1())
        b.se()
        b.se()
        for _ in range(b.ue()):
            b.se()
    s.num_ref_frames = b.ue()
    s.gaps_in_frame_num_allowed = bool(b.get1())
    s.mb_width = b.ue() + 1
    s.mb_height = b.ue() + 1
    s.frame_mbs_only = bool(b.get1())
    if not s.frame_mbs_only:
        # PAFF: mb_height counts FIELD macroblock rows; the frame is
        # twice that. MBAFF remains unsupported.
        s.mb_aff = bool(b.get1())
        if s.mb_aff:
            raise NotSupported("h264: MBAFF")
    s.direct_8x8_inference = bool(b.get1())
    if b.get1():                # frame_cropping
        s.crop_left = b.ue()
        s.crop_right = b.ue()
        s.crop_top = b.ue()
        s.crop_bottom = b.ue()
    return s


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    cabac: bool = False
    pic_order_present: bool = False
    num_ref_idx: tuple = (1, 1)
    weighted_pred: bool = False
    weighted_bipred_idc: int = 0
    init_qp: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present: bool = False
    constrained_intra_pred: bool = False
    redundant_pic_cnt_present: bool = False
    transform_8x8_mode: bool = False
    second_chroma_qp_index_offset: int = 0
    # resolved weight matrices, raster order (flat 16s when absent)
    scaling4: object = None
    scaling8: object = None


def parse_pps(rbsp: bytes, sps_map: Optional[dict] = None) -> PPS:
    b = Bits(rbsp)
    p = PPS()
    p.pps_id = b.ue()
    p.sps_id = b.ue()
    p.cabac = bool(b.get1())
    p.pic_order_present = bool(b.get1())
    if b.ue() != 0:             # num_slice_groups - 1
        raise NotSupported("h264: FMO slice groups")
    p.num_ref_idx = (b.ue() + 1, b.ue() + 1)
    p.weighted_pred = bool(b.get1())
    p.weighted_bipred_idc = b.get(2)
    p.init_qp = b.se() + 26
    b.se()                      # init_qs
    p.chroma_qp_index_offset = b.se()
    p.deblocking_filter_control_present = bool(b.get1())
    p.constrained_intra_pred = bool(b.get1())
    p.redundant_pic_cnt_present = bool(b.get1())
    sps = (sps_map or {}).get(p.sps_id)
    sps4 = getattr(sps, "scaling4", None) if sps else None
    sps8 = getattr(sps, "scaling8", None) if sps else None
    if b.more_rbsp():
        p.transform_8x8_mode = bool(b.get1())
        if b.get1():            # pic_scaling_matrix_present
            p.scaling4, p.scaling8 = parse_scaling_matrices(
                b, 2 if p.transform_8x8_mode else 0, sps4, sps8)
        p.second_chroma_qp_index_offset = b.se()
    else:
        p.second_chroma_qp_index_offset = p.chroma_qp_index_offset
    # resolve the effective weight matrices (PPS > SPS > flat)
    if p.scaling4 is None:
        p.scaling4 = sps4 if sps4 is not None else _FLAT4
    if p.scaling8 is None:
        p.scaling8 = sps8 if sps8 is not None else _FLAT8
    return p
