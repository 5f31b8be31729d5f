"""HEVC parameter sets + slice header (ITU-T H.265 7.3.2/7.3.6;
reference: libavcodec/hevc/ps.c, hevcdec.c hls_slice_header).

Scope: Main/Main10/Main12 profiles, 4:2:0, frame pictures.
The NAL escape format is identical to H.264 (emulation prevention).

The port's copy of ffmpeg_tpu/codecs/hevc/params.py, held equal to it by
tests/test_torch_hevc_host.py."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ...utils.error import InvalidData, NotSupported
from ..h264.bits import Bits
from . import tables as T

# NAL unit types (spec Table 7-1)
NAL_TRAIL_N, NAL_TRAIL_R = 0, 1
NAL_BLA_W_LP = 16
NAL_IDR_W_RADL, NAL_IDR_N_LP, NAL_CRA = 19, 20, 21
NAL_VPS, NAL_SPS, NAL_PPS = 32, 33, 34
NAL_AUD, NAL_EOS, NAL_EOB, NAL_FD = 35, 36, 37, 38
NAL_SEI_PREFIX, NAL_SEI_SUFFIX = 39, 40


_DEFAULT_SL_INTRA = [
    16, 16, 16, 16, 17, 18, 21, 24,
    16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29,
    16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47,
    18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88,
    24, 25, 29, 36, 47, 65, 88, 115]
_DEFAULT_SL_INTER = [
    16, 16, 16, 16, 17, 18, 20, 24,
    16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28,
    16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41,
    18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71,
    24, 25, 28, 33, 41, 54, 71, 91]


class ScalingList:
    """Dequant scale matrices (spec 7.3.4 scaling_list_data / Table
    7-5/7-6 defaults; reference hevc/ps.c).  sl[size][matrix] is the
    raster-order 4x4 (size 0) or 8x8 base matrix; 16x16/32x32 expand
    by pixel replication with an explicit DC in sl_dc."""

    def __init__(self):
        self.sl = [[[16] * (16 if sz == 0 else 64) for _ in range(6)]
                   for sz in range(4)]
        self.sl_dc = [[16] * 6, [16] * 6]
        for sz in (1, 2, 3):
            for m in range(6):
                self.sl[sz][m] = list(_DEFAULT_SL_INTRA if m < 3
                                      else _DEFAULT_SL_INTER)

    def matrix(self, log2, matrix_id):
        """(n, n) int64 scale factors for an n=2**log2 TU, DC
        substituted for 16/32 (cabac.c pos mapping + dc_scale)."""
        base = np.asarray(self.sl[log2 - 2][matrix_id],
                          np.int64)
        if log2 == 2:
            m = base.reshape(4, 4)
        else:
            m = base.reshape(8, 8)
            if log2 > 3:
                r = 1 << (log2 - 3)
                m = np.repeat(np.repeat(m, r, 0), r, 1)
        m = m.copy()
        if log2 >= 4:
            m[0, 0] = self.sl_dc[log2 - 4][matrix_id]
        return m


def parse_scaling_list_data(b: Bits) -> ScalingList:
    sl = ScalingList()
    for size_id in range(4):
        for matrix_id in range(0, 6, 3 if size_id == 3 else 1):
            if not b.get1():              # scaling_list_pred_mode
                delta = b.ue()
                if delta:
                    delta *= 3 if size_id == 3 else 1
                    if matrix_id < delta:
                        raise InvalidData("hevc: bad scaling list "
                                          "pred delta")
                    sl.sl[size_id][matrix_id] = \
                        list(sl.sl[size_id][matrix_id - delta])
                    if size_id > 1:
                        sl.sl_dc[size_id - 2][matrix_id] = \
                            sl.sl_dc[size_id - 2][matrix_id - delta]
            else:
                next_coef = 8
                coef_num = min(64, 1 << (4 + (size_id << 1)))
                if size_id > 1:
                    dc = b.se() + 8
                    if not 1 <= dc <= 255:
                        raise InvalidData("hevc: bad scaling DC")
                    sl.sl_dc[size_id - 2][matrix_id] = dc
                    next_coef = dc
                sx = T.DIAG4_X if size_id == 0 else T.DIAG8_X
                sy = T.DIAG4_Y if size_id == 0 else T.DIAG8_Y
                n = 4 if size_id == 0 else 8
                for i in range(coef_num):
                    pos = n * int(sy[i]) + int(sx[i])
                    next_coef = (next_coef + 256 + b.se()) % 256
                    sl.sl[size_id][matrix_id][pos] = next_coef
    return sl


def is_irap(t):
    return 16 <= t <= 23


def is_slice(t):
    return t <= 21


def _profile_tier_level(b: Bits, max_sub_layers: int):
    b.get(2)               # profile_space
    b.get1()               # tier
    profile_idc = b.get(5)
    for _ in range(32):
        b.get1()           # compatibility flags
    for _ in range(48):
        b.get1()           # progressive/interlaced/... + reserved
    level_idc = b.get(8)
    sub_flags = []
    for _ in range(max_sub_layers - 1):
        sub_flags.append((b.get1(), b.get1()))
    if max_sub_layers > 1:
        for _ in range(8 - (max_sub_layers - 1)):
            b.get(2)       # reserved
    for pf, lf in sub_flags:
        if pf:
            raise NotSupported("hevc: sub-layer PTL")
        if lf:
            b.get(8)
    return profile_idc, level_idc


@dataclass
class HevcSPS:
    sps_id: int = 0
    chroma_format_idc: int = 1
    width: int = 0                 # coded luma size
    height: int = 0
    crop_left: int = 0             # conformance window (luma units)
    crop_right: int = 0
    crop_top: int = 0
    crop_bottom: int = 0
    bit_depth: int = 8
    log2_max_poc_lsb: int = 8
    log2_min_cb: int = 3
    log2_ctb: int = 6
    log2_min_tb: int = 2
    log2_max_tb: int = 5
    max_trafo_depth_inter: int = 0
    max_trafo_depth_intra: int = 0
    temporal_mvp: bool = False
    num_reorder: int = 0
    scaling_list_enabled: bool = False
    amp_enabled: bool = False
    sao_enabled: bool = False
    pcm_enabled: bool = False
    strong_intra_smoothing: bool = False
    scaling_list: object = None

    @property
    def ctb_width(self):
        return (self.width + (1 << self.log2_ctb) - 1) >> self.log2_ctb

    @property
    def ctb_height(self):
        return (self.height + (1 << self.log2_ctb) - 1) >> self.log2_ctb


def parse_sps(rbsp: bytes) -> HevcSPS:
    b = Bits(rbsp)
    s = HevcSPS()
    b.get(4)                              # sps_video_parameter_set_id
    max_sub = b.get(3) + 1
    b.get1()                              # temporal_id_nesting
    _profile_tier_level(b, max_sub)
    s.sps_id = b.ue()
    s.chroma_format_idc = b.ue()
    if s.chroma_format_idc == 3:
        b.get1()
    if s.chroma_format_idc != 1:
        raise NotSupported("hevc: only 4:2:0")
    s.width = b.ue()
    s.height = b.ue()
    if b.get1():                          # conformance_window
        # offsets are in chroma units; x2 for 4:2:0 luma (7.4.3.2.1)
        s.crop_left = b.ue() * 2
        s.crop_right = b.ue() * 2
        s.crop_top = b.ue() * 2
        s.crop_bottom = b.ue() * 2
    s.bit_depth = b.ue() + 8
    if b.ue() + 8 != s.bit_depth or s.bit_depth not in (8, 10, 12):
        raise NotSupported("hevc: bit depth (Main/Main10/Main12 only)")
    s.log2_max_poc_lsb = b.ue() + 4
    sub_ordering = b.get1()
    for _ in range(max_sub if sub_ordering else 1):
        b.ue()                            # max_dec_pic_buffering - 1
        s.num_reorder = b.ue()
        b.ue()                            # max_latency_increase + 1
    s.log2_min_cb = b.ue() + 3
    s.log2_ctb = s.log2_min_cb + b.ue()
    s.log2_min_tb = b.ue() + 2
    s.log2_max_tb = s.log2_min_tb + b.ue()
    s.max_trafo_depth_inter = b.ue()
    s.max_trafo_depth_intra = b.ue()
    s.scaling_list_enabled = bool(b.get1())
    if s.scaling_list_enabled:
        s.scaling_list = parse_scaling_list_data(b) if b.get1() \
            else ScalingList()
    s.amp_enabled = bool(b.get1())
    s.sao_enabled = bool(b.get1())
    s.pcm_enabled = bool(b.get1())
    if s.pcm_enabled:
        raise NotSupported("hevc: PCM")
    num_st_rps = b.ue()
    if num_st_rps:
        raise NotSupported("hevc: short-term RPS in SPS")
    if b.get1():                          # long_term_ref_pics_present
        raise NotSupported("hevc: long-term refs")
    s.temporal_mvp = bool(b.get1())
    if s.temporal_mvp:
        raise NotSupported("hevc: temporal MVP")
    s.strong_intra_smoothing = bool(b.get1())
    # vui / extensions ignored
    return s


@dataclass
class HevcPPS:
    pps_id: int = 0
    sps_id: int = 0
    sign_data_hiding: bool = False
    cabac_init_present: bool = False
    init_qp: int = 26
    constrained_intra_pred: bool = False
    transform_skip: bool = False
    cu_qp_delta_enabled: bool = False
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets_present: bool = False
    deblocking_override_enabled: bool = False
    deblocking_disabled: bool = False
    beta_offset: int = 0
    tc_offset: int = 0
    loop_filter_across_slices: bool = True
    num_ref_idx_l0_default: int = 1
    num_ref_idx_l1_default: int = 1
    weighted_pred: bool = False
    weighted_bipred: bool = False
    lists_modification_present: bool = False
    log2_parallel_merge_level: int = 2
    tiles_enabled: bool = False
    entropy_coding_sync: bool = False     # WPP
    num_tile_cols: int = 1
    num_tile_rows: int = 1
    uniform_spacing: bool = True
    col_widths: tuple = ()                # explicit, in CTBs (all cols)
    row_heights: tuple = ()
    loop_filter_across_tiles: bool = True
    scaling_list: object = None

    def tile_bounds(self, sps):
        """→ (col_bd, row_bd): CTB boundary lists, len = n+1
        (spec 6.5.1 colBd/rowBd)."""
        cw, ch = sps.ctb_width, sps.ctb_height
        nc, nr = self.num_tile_cols, self.num_tile_rows
        if not self.tiles_enabled:
            return [0, cw], [0, ch]
        if self.uniform_spacing:
            col = [(i * cw) // nc for i in range(nc + 1)]
            row = [(i * ch) // nr for i in range(nr + 1)]
        else:
            col = [0]
            for w in self.col_widths[:nc - 1]:
                col.append(col[-1] + w)
            col.append(cw)                # last column = remainder
            row = [0]
            for h in self.row_heights[:nr - 1]:
                row.append(row[-1] + h)
            row.append(ch)
            if any(b - a <= 0 for a, b in zip(col, col[1:])) or \
                    any(b - a <= 0 for a, b in zip(row, row[1:])):
                raise InvalidData("hevc: tile sizes do not cover "
                                  "the picture")
        return col, row


def parse_pps(rbsp: bytes) -> HevcPPS:
    b = Bits(rbsp)
    p = HevcPPS()
    p.pps_id = b.ue()
    p.sps_id = b.ue()
    if b.get1():                          # dependent_slice_segments
        raise NotSupported("hevc: dependent slice segments")
    b.get1()                              # output_flag_present
    if b.get(3):                          # num_extra_slice_header_bits
        raise NotSupported("hevc: extra slice header bits")
    p.sign_data_hiding = bool(b.get1())
    p.cabac_init_present = bool(b.get1())
    p.num_ref_idx_l0_default = b.ue() + 1
    p.num_ref_idx_l1_default = b.ue() + 1
    p.init_qp = b.se() + 26
    p.constrained_intra_pred = bool(b.get1())
    if p.constrained_intra_pred:
        raise NotSupported("hevc: constrained intra pred")
    p.transform_skip = bool(b.get1())
    p.cu_qp_delta_enabled = bool(b.get1())
    if p.cu_qp_delta_enabled:
        p.diff_cu_qp_delta_depth = b.ue()
    p.cb_qp_offset = b.se()
    p.cr_qp_offset = b.se()
    p.slice_chroma_qp_offsets_present = bool(b.get1())
    p.weighted_pred = bool(b.get1())
    p.weighted_bipred = bool(b.get1())
    if p.weighted_pred or p.weighted_bipred:
        raise NotSupported("hevc: weighted prediction")
    if b.get1():                          # transquant_bypass
        raise NotSupported("hevc: transquant bypass")
    p.tiles_enabled = bool(b.get1())
    p.entropy_coding_sync = bool(b.get1())
    if p.tiles_enabled and p.entropy_coding_sync:
        raise NotSupported("hevc: tiles + WPP combined")
    if p.tiles_enabled:
        p.num_tile_cols = b.ue() + 1
        p.num_tile_rows = b.ue() + 1
        p.uniform_spacing = bool(b.get1())
        if not p.uniform_spacing:
            # explicit widths: n-1 coded, the last is the remainder —
            # resolved against the SPS in tile_bounds (unknown here),
            # so store the coded ones and a marker
            cw = [b.ue() + 1 for _ in range(p.num_tile_cols - 1)]
            rh = [b.ue() + 1 for _ in range(p.num_tile_rows - 1)]
            p.col_widths = tuple(cw)
            p.row_heights = tuple(rh)
        p.loop_filter_across_tiles = bool(b.get1())
    p.loop_filter_across_slices = bool(b.get1())
    if b.get1():                          # deblocking_filter_control
        p.deblocking_override_enabled = bool(b.get1())
        p.deblocking_disabled = bool(b.get1())
        if not p.deblocking_disabled:
            p.beta_offset = b.se() * 2
            p.tc_offset = b.se() * 2
    if b.get1():                          # pps_scaling_list_data
        p.scaling_list = parse_scaling_list_data(b)
    p.lists_modification_present = bool(b.get1())
    p.log2_parallel_merge_level = b.ue() + 2
    if p.log2_parallel_merge_level != 2:
        raise NotSupported("hevc: parallel merge level > 2")
    b.get1()                              # slice_header_extension
    return p


@dataclass
class HevcSliceHeader:
    first_slice: bool = True
    pps_id: int = 0
    slice_type: int = 2                   # 0 B, 1 P, 2 I
    poc_lsb: int = 0
    # short-term RPS: lists of (delta_poc, used_by_curr) with delta
    # relative to the current POC (negative for "before" pics)
    rps_neg: list = field(default_factory=list)
    rps_pos: list = field(default_factory=list)
    num_ref_idx: tuple = (0, 0)           # active refs (L0, L1)
    mvd_l1_zero: bool = False
    cabac_init: bool = False
    # ref_pic_lists_modification: per-list tuple of temp-list indices
    # or None when the default order applies (spec 7.3.6.2 / 8.3.4)
    list_entry: list = field(default_factory=lambda: [None, None])
    max_num_merge_cand: int = 5
    sao_luma: bool = False
    sao_chroma: bool = False
    qp: int = 26
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    deblocking_disabled: bool = False
    beta_offset: int = 0
    tc_offset: int = 0
    entry_points: list = field(default_factory=list)  # substream sizes
                                          # in RBSP bytes (all but last)
    data_bit_pos: int = 0                 # first bit after alignment


def parse_slice_header(rbsp: bytes, nal_type: int, sps: HevcSPS,
                       pps_map: dict) -> HevcSliceHeader:
    b = Bits(rbsp)
    sh = HevcSliceHeader()
    sh.first_slice = bool(b.get1())
    if not sh.first_slice:
        raise NotSupported("hevc: multi-slice pictures")
    if is_irap(nal_type):
        b.get1()                          # no_output_of_prior_pics
    sh.pps_id = b.ue()
    pps = pps_map.get(sh.pps_id)
    if pps is None:
        raise InvalidData("hevc: unknown PPS")
    sh.slice_type = b.ue()
    if sh.slice_type > 2:
        raise InvalidData("hevc: bad slice_type")
    if nal_type not in (NAL_IDR_W_RADL, NAL_IDR_N_LP):
        sh.poc_lsb = b.get(sps.log2_max_poc_lsb)
        if b.get1():                      # short_term_ref_pic_set_sps
            raise InvalidData("hevc: SPS has no short-term RPS")
        # explicit st_ref_pic_set(0): no inter-RPS prediction flag
        # (stRpsIdx == 0, spec 7.3.7)
        num_neg = b.ue()
        num_pos = b.ue()
        poc = 0
        for _ in range(num_neg):
            poc -= b.ue() + 1             # delta_poc_s0_minus1
            sh.rps_neg.append((poc, bool(b.get1())))
        poc = 0
        for _ in range(num_pos):
            poc += b.ue() + 1             # delta_poc_s1_minus1
            sh.rps_pos.append((poc, bool(b.get1())))
    elif sh.slice_type != 2:
        raise InvalidData("hevc: P/B slice in IDR picture")
    if sps.sao_enabled:
        sh.sao_luma = bool(b.get1())
        sh.sao_chroma = bool(b.get1())
    if sh.slice_type != 2:                # P or B
        n0, n1 = pps.num_ref_idx_l0_default, pps.num_ref_idx_l1_default
        if b.get1():                      # num_ref_idx_active_override
            n0 = b.ue() + 1
            if sh.slice_type == 0:
                n1 = b.ue() + 1
        sh.num_ref_idx = (n0, n1 if sh.slice_type == 0 else 0)
        n_total_curr = sum(u for _, u in sh.rps_neg) + \
            sum(u for _, u in sh.rps_pos)
        if pps.lists_modification_present and n_total_curr > 1:
            # ref_pic_lists_modification (7.3.6.2): explicit temp-list
            # indices, ceil(log2(NumPicTotalCurr)) bits each
            nbits = (n_total_curr - 1).bit_length()
            nlists = 2 if sh.slice_type == 0 else 1
            for ll in range(nlists):
                if b.get1():              # ref_pic_list_modification_l{ll}
                    sh.list_entry[ll] = [
                        b.get(nbits)
                        for _ in range(sh.num_ref_idx[ll])]
        if sh.slice_type == 0:
            sh.mvd_l1_zero = bool(b.get1())
        if pps.cabac_init_present:
            sh.cabac_init = bool(b.get1())
        sh.max_num_merge_cand = 5 - b.ue()
        if not 1 <= sh.max_num_merge_cand <= 5:
            raise InvalidData("hevc: bad max_num_merge_cand")
    sh.qp = pps.init_qp + b.se()
    if pps.slice_chroma_qp_offsets_present:
        sh.cb_qp_offset = b.se()
        sh.cr_qp_offset = b.se()
    sh.deblocking_disabled = pps.deblocking_disabled
    sh.beta_offset = pps.beta_offset
    sh.tc_offset = pps.tc_offset
    if pps.deblocking_override_enabled and b.get1():
        sh.deblocking_disabled = bool(b.get1())
        if not sh.deblocking_disabled:
            sh.beta_offset = b.se() * 2
            sh.tc_offset = b.se() * 2
    if pps.loop_filter_across_slices and \
            (sh.sao_luma or sh.sao_chroma or not sh.deblocking_disabled):
        b.get1()                          # slice_loop_filter_across_slices
    if pps.tiles_enabled or pps.entropy_coding_sync:
        n_ep = b.ue()                     # num_entry_point_offsets
        if n_ep:
            olen = b.ue() + 1
            sh.entry_points = [b.get(olen) + 1 for _ in range(n_ep)]
    # byte_alignment(): one '1' bit then zeros to the boundary
    if b.get1() != 1:
        raise InvalidData("hevc: bad slice header alignment")
    sh.data_bit_pos = (b.pos + 7) & ~7
    return sh
