"""VVC parameter sets + headers, minimal-toolset profile (ITU-T H.266
7.3.2; reference vvc/ps.c:1495 + cbs_h266_syntax_template.c:1056).

Scope: the "craftable core" of VVC — single layer, 4:2:0 8/10-bit,
single tile/slice, picture header in slice header, quadtree-only
partitioning (MTT depth 0), DCT-2 transforms, every optional tool
(ALF/SAO/LMCS/MTS/LFNST/ISP/MRL/MIP/CCLM/IBC/palette/dep-quant/...)
switched off in the SPS. Enabled-tool paths raise NotSupported; the
parser follows the exact CBS syntax order so reference-encoded
minimal streams parse identically.

The port's copy of ffmpeg_tpu/codecs/vvc/params.py, held equal to it by
tests/test_torch_vvc.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ...utils.error import InvalidData, NotSupported
from ..h264.bits import Bits

# nal_unit_type (Table 5)
NAL_TRAIL, NAL_STSA, NAL_RADL, NAL_RASL = 0, 1, 2, 3
NAL_IDR_W_RADL, NAL_IDR_N_LP, NAL_CRA, NAL_GDR = 7, 8, 9, 10
NAL_OPI, NAL_DCI, NAL_VPS, NAL_SPS, NAL_PPS = 12, 13, 14, 15, 16
NAL_PREFIX_APS, NAL_SUFFIX_APS, NAL_PH, NAL_AUD = 17, 18, 19, 20
NAL_EOS, NAL_EOB, NAL_PREFIX_SEI, NAL_SUFFIX_SEI = 21, 22, 23, 24


def is_idr(t):
    return t in (NAL_IDR_W_RADL, NAL_IDR_N_LP)


def is_slice(t):
    return t in (NAL_TRAIL, NAL_STSA, NAL_RADL, NAL_RASL,
                 NAL_IDR_W_RADL, NAL_IDR_N_LP, NAL_CRA, NAL_GDR)


def nal_type(unit: bytes) -> int:
    return (unit[1] >> 3) & 0x1F


@dataclass
class VvcSPS:
    sps_id: int = 0
    chroma_format_idc: int = 1
    log2_ctu: int = 5
    width: int = 0
    height: int = 0
    bit_depth: int = 8
    log2_min_cb: int = 2
    log2_min_qt_intra: int = 2
    max_mtt_depth_intra: int = 0
    log2_max_bt_intra: int = 2      # == min_qt when mtt depth 0
    log2_max_tt_intra: int = 2
    log2_min_qt_inter: int = 2
    max_mtt_depth_inter: int = 0
    log2_max_bt_inter: int = 2
    log2_max_tt_inter: int = 2
    max_num_merge_cand: int = 6
    log2_parallel_merge_level: int = 2
    log2_max_poc_lsb: int = 8
    qp_table: list = field(default_factory=list)   # chroma QP map

    @property
    def ctb_width(self):
        return -(-self.width >> self.log2_ctu)

    @property
    def ctb_height(self):
        return -(-self.height >> self.log2_ctu)


@dataclass
class VvcPPS:
    pps_id: int = 0
    sps_id: int = 0
    init_qp: int = 26
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    deblocking_disabled: bool = False


@dataclass
class VvcSliceHeader:
    slice_type: int = 2                  # 0=B 1=P 2=I
    poc_lsb: int = 0
    qp: int = 26
    data_bit_pos: int = 0
    mvd_l1_zero: bool = False
    # per-list short-term ref entries as signed POC deltas, applied
    # cumulatively from the current POC (refs.c:560 poc_base chain)
    rpl_deltas: tuple = ((), ())
    num_ref_idx_active: tuple = (0, 0)


def _ptl(b, read, w=None, max_sub=1):
    """profile_tier_level(1, 0): general_profile 7b, tier, level,
    frame-only, multilayer, gci (absent) + align, no sublayers, no
    sub-profiles."""
    if read:
        b.get(7)                          # general_profile_idc
        b.get1()                          # tier
        b.get(8)                          # general_level_idc
        b.get1()                          # ptl_frame_only
        b.get1()                          # ptl_multilayer
        if b.get1():                      # gci_present
            raise NotSupported("vvc: general constraints info")
        while b.pos % 8:
            b.get1()                      # gci alignment
        b.get(8)                          # ptl_num_sub_profiles
    else:
        w.u(1, 7)                         # Main 10 profile idc = 1
        w.u(0, 1)
        w.u(35, 8)                        # level 2.0 (35)
        w.u(1, 1)                         # frame only
        w.u(0, 1)                         # multilayer
        w.u(0, 1)                         # gci_present = 0
        while len(w.bits) % 8:
            w.u(0, 1)
        w.u(0, 8)                         # num_sub_profiles


def parse_sps(rbsp: bytes) -> VvcSPS:
    b = Bits(rbsp)
    s = VvcSPS()
    s.sps_id = b.get(4)
    if b.get(4):
        raise NotSupported("vvc: VPS")
    if b.get(3):                          # max_sublayers_minus1
        raise NotSupported("vvc: sublayers")
    s.chroma_format_idc = b.get(2)
    if s.chroma_format_idc != 1:
        raise NotSupported("vvc: only 4:2:0")
    s.log2_ctu = b.get(2) + 5
    if s.log2_ctu > 6:
        raise InvalidData("vvc: bad ctu size")
    ptl_present = b.get1()
    if ptl_present:
        _ptl(b, read=True)
        b.get1()                          # sps_gdr_enabled
    else:
        b.get1()
    if b.get1():                          # ref_pic_resampling
        raise NotSupported("vvc: ref pic resampling")
    s.width = b.ue()
    s.height = b.ue()
    if b.get1():                          # conformance window
        raise NotSupported("vvc: conformance window")
    if b.get1():                          # subpic info
        raise NotSupported("vvc: subpictures")
    s.bit_depth = b.ue() + 8
    if s.bit_depth not in (8, 10):
        raise NotSupported("vvc: bit depth")
    b.get1()                              # entropy_coding_sync (WPP)
    b.get1()                              # entry_point_offsets_present
    s.log2_max_poc_lsb = b.get(4) + 4
    if b.get1():                          # poc_msb_cycle
        raise NotSupported("vvc: poc msb cycle")
    if b.get(2) or b.get(2):              # extra ph/sh bytes
        raise NotSupported("vvc: extra header bits")
    if ptl_present:                       # dpb_parameters
        b.ue(), b.ue(), b.ue()
    s.log2_min_cb = b.ue() + 2
    if b.get1():                          # partition_constraints_override
        raise NotSupported("vvc: partition override")
    s.log2_min_qt_intra = b.ue() + s.log2_min_cb
    s.max_mtt_depth_intra = b.ue()
    if s.max_mtt_depth_intra:
        s.log2_max_bt_intra = b.ue() + s.log2_min_qt_intra
        s.log2_max_tt_intra = b.ue() + s.log2_min_qt_intra
    else:
        s.log2_max_bt_intra = s.log2_min_qt_intra
        s.log2_max_tt_intra = s.log2_min_qt_intra
    if b.get1():                          # qtbtt_dual_tree_intra
        raise NotSupported("vvc: dual tree")
    s.log2_min_qt_inter = b.ue() + s.log2_min_cb
    s.max_mtt_depth_inter = b.ue()
    if s.max_mtt_depth_inter:
        s.log2_max_bt_inter = b.ue() + s.log2_min_qt_inter
        s.log2_max_tt_inter = b.ue() + s.log2_min_qt_inter
    else:
        s.log2_max_bt_inter = s.log2_min_qt_inter
        s.log2_max_tt_inter = s.log2_min_qt_inter
    if s.log2_ctu > 5 and b.get1():       # max_luma_transform_size_64
        raise NotSupported("vvc: 64pt transform")
    if b.get1():                          # transform_skip
        raise NotSupported("vvc: transform skip")
    if b.get1():                          # mts
        raise NotSupported("vvc: MTS")
    if b.get1():                          # lfnst
        raise NotSupported("vvc: LFNST")
    # chroma tool block (chroma_format_idc != 0)
    if b.get1():                          # joint_cbcr
        raise NotSupported("vvc: joint CbCr")
    same_qp_table = b.get1()
    if not same_qp_table:
        raise NotSupported("vvc: split chroma QP tables")
    start = b.se() + 26
    npts = b.ue() + 1
    qp_in, qp_diff = [], []
    for _ in range(npts):
        qp_in.append(b.ue())
        qp_diff.append(b.ue())
    s.qp_table = derive_chroma_qp_table(s.bit_depth, start, qp_in,
                                        qp_diff)
    for name in ("sao", "alf"):
        if b.get1():
            raise NotSupported(f"vvc: {name}")
    if b.get1():                          # lmcs
        raise NotSupported("vvc: LMCS")
    if b.get1() or b.get1():              # weighted pred/bipred
        raise NotSupported("vvc: weighted prediction")
    if b.get1():                          # long_term_ref_pics
        raise NotSupported("vvc: long-term refs")
    if b.get1():                          # idr_rpl_present
        raise NotSupported("vvc: idr rpl")
    rpl1_same = b.get1()
    for _ in range(1 if rpl1_same else 2):
        if b.ue():                        # sps_num_ref_pic_lists
            raise NotSupported("vvc: SPS ref pic lists")
    if b.get1():                          # ref_wraparound
        raise NotSupported("vvc: wraparound")
    if b.get1():                          # temporal_mvp
        raise NotSupported("vvc: TMVP")
    for name in ("amvr", "bdof"):
        if b.get1():
            raise NotSupported(f"vvc: {name}")
    if b.get1():                          # smvd
        raise NotSupported("vvc: SMVD")
    if b.get1():                          # dmvr
        raise NotSupported("vvc: DMVR")
    if b.get1():                          # mmvd
        raise NotSupported("vvc: MMVD")
    s.max_num_merge_cand = 6 - b.ue()
    if b.get1():                          # sbt
        raise NotSupported("vvc: SBT")
    if b.get1():                          # affine
        raise NotSupported("vvc: affine")
    if b.get1():                          # bcw
        raise NotSupported("vvc: BCW")
    if b.get1():                          # ciip
        raise NotSupported("vvc: CIIP")
    if b.get1():                          # gpm
        raise NotSupported("vvc: GPM")
    s.log2_parallel_merge_level = b.ue() + 2
    for name in ("isp", "mrl", "mip"):
        if b.get1():
            raise NotSupported(f"vvc: {name}")
    if b.get1():                          # cclm
        raise NotSupported("vvc: CCLM")
    b.get1()                              # chroma_horizontal_collocated
    b.get1()                              # chroma_vertical_collocated
    if b.get1():                          # palette
        raise NotSupported("vvc: palette")
    if b.get1():                          # ibc
        raise NotSupported("vvc: IBC")
    if b.get1():                          # ladf
        raise NotSupported("vvc: LADF")
    if b.get1():                          # explicit scaling list
        raise NotSupported("vvc: scaling lists")
    if b.get1():                          # dep_quant
        raise NotSupported("vvc: dependent quantization")
    if b.get1():                          # sign_data_hiding
        raise NotSupported("vvc: sign data hiding")
    if b.get1():                          # virtual_boundaries
        raise NotSupported("vvc: virtual boundaries")
    if b.get1():                          # timing_hrd
        raise NotSupported("vvc: HRD")
    b.get1()                              # field_seq
    if b.get1():                          # vui present
        raise NotSupported("vvc: VUI")
    if b.get1():                          # extension
        raise NotSupported("vvc: SPS extension")
    return s


def derive_chroma_qp_table(bit_depth, start, qp_in_minus1, qp_diff):
    """ChromaQpTable derivation (spec 7.4.3.4 semantics, one table)."""
    qp_bd_offset = 6 * (bit_depth - 8)
    npts = len(qp_in_minus1)
    qp_in = [start]
    qp_out = [start]
    for i in range(npts):
        qp_in.append(qp_in[-1] + qp_in_minus1[i] + 1)
        # delta_qp_out = minus1 ^ diff (NOT minus1+1; ps.c:107)
        qp_out.append(qp_out[-1] + (qp_in_minus1[i] ^ qp_diff[i]))
    table = [0] * (64 + qp_bd_offset)

    def t(i):
        return table[i + qp_bd_offset]

    def sett(i, v):
        table[i + qp_bd_offset] = max(-qp_bd_offset, min(63, v))

    sett(qp_in[0], qp_out[0])
    for k in range(qp_in[0] - 1, -qp_bd_offset - 1, -1):
        sett(k, t(k + 1) - 1)
    for i in range(npts):
        sh = (qp_in_minus1[i] + 1) >> 1
        m = qp_in_minus1[i] + 1
        for j in range(1, m + 1):
            sett(qp_in[i] + j,
                 t(qp_in[i]) + ((qp_out[i + 1] - qp_out[i]) * j + sh)
                 // m if m else t(qp_in[i]))
    for k in range(qp_in[-1] + 1, 64):
        sett(k, t(k - 1) + 1)
    return table


def parse_pps(rbsp: bytes) -> VvcPPS:
    b = Bits(rbsp)
    p = VvcPPS()
    p.pps_id = b.get(6)
    p.sps_id = b.get(4)
    if b.get1():                          # mixed_nalu_types
        raise NotSupported("vvc: mixed nalu types")
    b.ue()                                # pic_width (== SPS)
    b.ue()                                # pic_height
    if b.get1():                          # conformance window
        raise NotSupported("vvc: pps conformance window")
    if b.get1():                          # scaling window
        raise NotSupported("vvc: scaling window")
    b.get1()                              # output_flag_present
    if not b.get1():                      # no_pic_partition
        raise NotSupported("vvc: tiles/slices partitioning")
    if b.get1():                          # subpic id mapping
        raise NotSupported("vvc: subpic ids")
    b.get1()                              # cabac_init_present
    b.ue(), b.ue()                        # num_ref_idx_default x2
    b.get1()                              # rpl1_idx_present
    if b.get1() or b.get1():              # weighted pred/bipred
        raise NotSupported("vvc: pps weighted pred")
    if b.get1():                          # ref_wraparound
        raise NotSupported("vvc: pps wraparound")
    p.init_qp = b.se() + 26
    if b.get1():                          # cu_qp_delta_enabled
        raise NotSupported("vvc: cu qp delta")
    if b.get1():                          # chroma_tool_offsets_present
        p.cb_qp_offset = b.se()
        p.cr_qp_offset = b.se()
        if b.get1():                      # joint_cbcr offset present
            raise NotSupported("vvc: joint cbcr offset")
        if b.get1():                      # slice chroma qp offsets
            raise NotSupported("vvc: slice chroma qp offsets")
        if b.get1():                      # cu chroma qp offset list
            raise NotSupported("vvc: chroma qp offset list")
    if b.get1():                          # deblocking_filter_control
        if b.get1():                      # override_enabled
            raise NotSupported("vvc: deblock override")
        p.deblocking_disabled = bool(b.get1())
        if not p.deblocking_disabled:
            b.se(), b.se(), b.se(), b.se(), b.se(), b.se()
    b.get1()                              # picture_header_extension
    b.get1()                              # slice_header_extension
    if b.get1():                          # pps_extension
        raise NotSupported("vvc: PPS extension")
    return p


def parse_slice_header(rbsp: bytes, ntype: int, sps: VvcSPS,
                       pps_map: dict) -> VvcSliceHeader:
    """slice_header with picture_header_structure inline
    (sh_picture_header_in_slice_header_flag == 1; minimal PH is just
    5 flags + pps id + poc lsb given every optional tool is off)."""
    b = Bits(rbsp)
    sh = VvcSliceHeader()
    if not b.get1():                      # sh_picture_header_in_sh
        raise NotSupported("vvc: separate picture header")
    gdr_or_irap = b.get1()                # ph_gdr_or_irap_pic_flag
    b.get1()                              # ph_non_ref_pic_flag
    if gdr_or_irap and b.get1():          # ph_gdr_pic_flag
        raise NotSupported("vvc: GDR pictures")
    inter_allowed = b.get1()
    if inter_allowed:
        b.get1()                          # ph_intra_slice_allowed
    pps_id = b.ue()
    pps = pps_map.get(pps_id)
    if pps is None:
        raise InvalidData("vvc: unknown PPS")
    sh.poc_lsb = b.get(sps.log2_max_poc_lsb)
    if inter_allowed:
        # PH inter block with TMVP/MMVD/WP off collapses to
        # ph_mvd_l1_zero_flag (cbs_h266_syntax_template.c:2941)
        sh.mvd_l1_zero = bool(b.get1())
    # slice_header tail
    sh.slice_type = b.ue() if inter_allowed else 2
    if sh.slice_type > 2:
        raise InvalidData("vvc: bad slice type")
    if is_idr(ntype) or ntype == NAL_CRA:
        b.get1()                          # sh_no_output_of_prior_pics
    rpl = [[], []]
    if not is_idr(ntype):
        # ref_pic_lists: both structs inline (no SPS RPLs, no LT)
        for lx in range(2):
            n = b.ue()
            if n > 15:
                raise InvalidData("vvc: too many ref entries")
            for _ in range(n):
                abs_delta = b.ue() + 1
                sign = b.get1()
                rpl[lx].append(-abs_delta if sign else abs_delta)
    sh.rpl_deltas = (tuple(rpl[0]), tuple(rpl[1]))
    # sh_num_ref_idx_active_override (cbs template:3243)
    active = [0, 0]
    if sh.slice_type != 2:
        n_lists = 2 if sh.slice_type == 0 else 1
        minus1 = [0, 0]
        override = 1
        if len(rpl[0]) > 1 or (sh.slice_type == 0 and len(rpl[1]) > 1):
            override = b.get1()
            if override:
                for i in range(n_lists):
                    if len(rpl[i]) > 1:
                        minus1[i] = b.ue()
        for i in range(n_lists):
            if override:
                active[i] = minus1[i] + 1
            else:
                active[i] = min(len(rpl[i]), 1)   # pps defaults are 1
            if active[i] <= 0 or active[i] > len(rpl[i]):
                raise InvalidData("vvc: no refs for inter slice")
    sh.num_ref_idx_active = tuple(active)
    sh.qp = pps.init_qp + b.se()          # sh_qp_delta
    if b.get1() != 1:                     # byte alignment: 1 then 0s
        raise InvalidData("vvc: bad slice header alignment")
    sh.data_bit_pos = (b.pos + 7) & ~7
    return sh
