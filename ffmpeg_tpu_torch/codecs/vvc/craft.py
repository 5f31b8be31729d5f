"""VVC minimal-toolset stream crafting: SPS/PPS/slice writers that
mirror params.py's parsers bit for bit (the HEVC crafted-stream test
method applied to H.266). Also the seed of a future encoder's header
layer.

The port's copy of ffmpeg_tpu/codecs/vvc/craft.py, held equal to it by
tests/test_torch_vvc.py.
"""

from __future__ import annotations

from .cabac import VvcCabacEncoder
from .ctu import CtuCoder, FrameDec
from . import params as P


class BW:
    def __init__(self):
        self.bits = []

    def u(self, v, n):
        for k in range(n - 1, -1, -1):
            self.bits.append((v >> k) & 1)

    def ue(self, v):
        v += 1
        n = v.bit_length()
        for _ in range(n - 1):
            self.bits.append(0)
        self.u(v, n)

    def se(self, v):
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def rbsp(self) -> bytes:
        bits = self.bits + [1]
        while len(bits) % 8:
            bits.append(0)
        out = bytearray(len(bits) // 8)
        for i, b in enumerate(bits):
            out[i >> 3] |= b << (7 - (i & 7))
        return bytes(out)


def _escape(rbsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def vnal(ntype: int, rbsp: bytes) -> bytes:
    """VVC NAL: forbidden(1)=0, reserved(1)=0, layer_id(6)=0,
    type(5), tid+1(3)=1."""
    hdr = bytes([0, (ntype << 3) | 1])
    return b"\x00\x00\x00\x01" + hdr + _escape(rbsp)


def write_ptl(w):
    w.u(1, 7)            # general_profile_idc (Main 10)
    w.u(0, 1)            # tier
    w.u(35, 8)           # level 2.0
    w.u(1, 1)            # ptl_frame_only
    w.u(0, 1)            # ptl_multilayer
    w.u(0, 1)            # gci_present = 0
    while len(w.bits) % 8:
        w.u(0, 1)        # gci alignment zeros
    w.u(0, 8)            # ptl_num_sub_profiles


def make_sps(width, height, log2_ctu=5, log2_min_cb=2,
             log2_min_qt=3, bit_depth=8, mtt_depth_intra=0,
             log2_max_bt=None, log2_max_tt=None,
             log2_min_qt_inter=None, mtt_depth_inter=0,
             log2_max_bt_inter=None, log2_max_tt_inter=None,
             max_num_merge_cand=6):
    """log2_max_bt/tt default to the CTU size when MTT is on (the
    least restrictive legal values; tt capped at min(6, ctu))."""
    w = BW()
    w.u(0, 4)            # sps_id
    w.u(0, 4)            # vps_id
    w.u(0, 3)            # max_sublayers_minus1
    w.u(1, 2)            # chroma_format_idc 4:2:0
    w.u(log2_ctu - 5, 2)
    w.u(1, 1)            # ptl_dpb_hrd_params_present (required, no VPS)
    write_ptl(w)
    w.u(0, 1)            # gdr_enabled
    w.u(0, 1)            # ref_pic_resampling
    w.ue(width)
    w.ue(height)
    w.u(0, 1)            # conformance_window
    w.u(0, 1)            # subpic_info_present
    w.ue(bit_depth - 8)
    w.u(0, 1)            # entropy_coding_sync
    w.u(0, 1)            # entry_point_offsets_present
    w.u(4, 4)            # log2_max_poc_lsb - 4 (= 8)
    w.u(0, 1)            # poc_msb_cycle
    w.u(0, 2)            # extra ph bytes
    w.u(0, 2)            # extra sh bytes
    # dpb_parameters (ptl present)
    w.ue(1)              # max_dec_pic_buffering - 1
    w.ue(0)              # max_num_reorder
    w.ue(0)              # max_latency_increase + 1
    w.ue(log2_min_cb - 2)
    w.u(0, 1)            # partition_constraints_override
    w.ue(log2_min_qt - log2_min_cb)
    w.ue(mtt_depth_intra)  # max_mtt_hierarchy_depth_intra
    if mtt_depth_intra:
        bt = log2_ctu if log2_max_bt is None else log2_max_bt
        tt = min(6, log2_ctu) if log2_max_tt is None else log2_max_tt
        w.ue(bt - log2_min_qt)   # log2_diff_max_bt_min_qt_intra
        w.ue(tt - log2_min_qt)   # log2_diff_max_tt_min_qt_intra
    w.u(0, 1)            # qtbtt_dual_tree_intra
    qti = log2_min_qt if log2_min_qt_inter is None \
        else log2_min_qt_inter
    w.ue(qti - log2_min_cb)  # log2_diff_min_qt_min_cb_inter_slice
    w.ue(mtt_depth_inter)    # max_mtt_hierarchy_depth_inter_slice
    if mtt_depth_inter:
        bt = log2_ctu if log2_max_bt_inter is None \
            else log2_max_bt_inter
        tt = min(6, log2_ctu) if log2_max_tt_inter is None \
            else log2_max_tt_inter
        w.ue(bt - qti)   # log2_diff_max_bt_min_qt_inter_slice
        w.ue(tt - qti)   # log2_diff_max_tt_min_qt_inter_slice
    if log2_ctu > 5:
        w.u(0, 1)        # max_luma_transform_size_64
    w.u(0, 1)            # transform_skip
    w.u(0, 1)            # mts
    w.u(0, 1)            # lfnst
    w.u(0, 1)            # joint_cbcr
    w.u(1, 1)            # same_qp_table_for_chroma
    w.se(0)              # qp_table_start_minus26
    w.ue(0)              # num_points_in_qp_table - 1
    w.ue(0)              # delta_qp_in_val_minus1[0]
    w.ue(0)              # delta_qp_diff_val[0]
    w.u(0, 1)            # sao
    w.u(0, 1)            # alf
    w.u(0, 1)            # lmcs
    w.u(0, 1)            # weighted_pred
    w.u(0, 1)            # weighted_bipred
    w.u(0, 1)            # long_term_ref_pics
    w.u(0, 1)            # idr_rpl_present
    w.u(1, 1)            # rpl1_same_as_rpl0
    w.ue(0)              # num_ref_pic_lists[0]
    w.u(0, 1)            # ref_wraparound
    w.u(0, 1)            # temporal_mvp
    w.u(0, 1)            # amvr
    w.u(0, 1)            # bdof
    w.u(0, 1)            # smvd
    w.u(0, 1)            # dmvr
    w.u(0, 1)            # mmvd
    w.ue(6 - max_num_merge_cand)  # six_minus_max_num_merge_cand
    w.u(0, 1)            # sbt
    w.u(0, 1)            # affine
    w.u(0, 1)            # bcw
    w.u(0, 1)            # ciip
    w.u(0, 1)            # gpm
    w.ue(0)              # log2_parallel_merge_level - 2
    w.u(0, 1)            # isp
    w.u(0, 1)            # mrl
    w.u(0, 1)            # mip
    w.u(0, 1)            # cclm
    w.u(1, 1)            # chroma_horizontal_collocated
    w.u(1, 1)            # chroma_vertical_collocated
    w.u(0, 1)            # palette
    w.u(0, 1)            # ibc
    w.u(0, 1)            # ladf
    w.u(0, 1)            # explicit_scaling_list
    w.u(0, 1)            # dep_quant
    w.u(0, 1)            # sign_data_hiding
    w.u(0, 1)            # virtual_boundaries
    w.u(0, 1)            # timing_hrd
    w.u(0, 1)            # field_seq
    w.u(0, 1)            # vui_present
    w.u(0, 1)            # sps_extension
    return vnal(P.NAL_SPS, w.rbsp())


def make_pps(width, height, init_qp=26, cb_qp_offset=0,
             cr_qp_offset=0):
    w = BW()
    w.u(0, 6)            # pps_id
    w.u(0, 4)            # sps_id
    w.u(0, 1)            # mixed_nalu_types
    w.ue(width)
    w.ue(height)
    w.u(0, 1)            # conformance_window
    w.u(0, 1)            # scaling_window_explicit
    w.u(0, 1)            # output_flag_present
    w.u(1, 1)            # no_pic_partition
    w.u(0, 1)            # subpic_id_mapping
    w.u(0, 1)            # cabac_init_present
    w.ue(0)              # num_ref_idx_default[0] - 1
    w.ue(0)              # num_ref_idx_default[1] - 1
    w.u(0, 1)            # rpl1_idx_present
    w.u(0, 1)            # weighted_pred
    w.u(0, 1)            # weighted_bipred
    w.u(0, 1)            # ref_wraparound
    w.se(init_qp - 26)
    w.u(0, 1)            # cu_qp_delta_enabled
    if cb_qp_offset or cr_qp_offset:
        w.u(1, 1)        # chroma_tool_offsets_present
        w.se(cb_qp_offset)
        w.se(cr_qp_offset)
        w.u(0, 1)        # joint_cbcr_qp_offset_present
        w.u(0, 1)        # slice_chroma_qp_offsets_present
        w.u(0, 1)        # cu_chroma_qp_offset_list
    else:
        w.u(0, 1)
    # deblocking: control present, no override, DISABLED
    w.u(1, 1)
    w.u(0, 1)            # override_enabled
    w.u(1, 1)            # deblocking_filter_disabled
    w.u(0, 1)            # picture_header_extension
    w.u(0, 1)            # slice_header_extension
    w.u(0, 1)            # pps_extension
    return vnal(P.NAL_PPS, w.rbsp())


def slice_header_bits(qp_delta=0, poc_lsb=0, idr=True):
    """slice with PH inline, minimal toolset, I slice inferred."""
    w = BW()
    w.u(1, 1)            # sh_picture_header_in_slice_header
    w.u(1, 1)            # ph_gdr_or_irap_pic_flag
    w.u(0, 1)            # ph_non_ref_pic_flag
    w.u(0, 1)            # ph_gdr_pic_flag
    w.u(0, 1)            # ph_inter_slice_allowed (intra inferred 1)
    w.ue(0)              # pps_id
    w.u(poc_lsb, 8)      # ph_pic_order_cnt_lsb
    if idr:
        w.u(0, 1)        # sh_no_output_of_prior_pics
    w.se(qp_delta)       # sh_qp_delta
    w.u(1, 1)            # byte alignment one-bit
    while len(w.bits) % 8:
        w.u(0, 1)
    return w


def slice_header_bits_inter(slice_type, poc_lsb, rpl_deltas,
                            n_active, qp_delta=0):
    """TRAIL P/B slice with PH inline: inter-allowed PH adds
    ph_intra_slice_allowed + ph_mvd_l1_zero; the SH tail carries
    sh_slice_type, both ref_pic_list_structs and the
    num_ref_idx_active override (cbs_h266_syntax_template.c:3152)."""
    w = BW()
    w.u(1, 1)            # sh_picture_header_in_slice_header
    w.u(0, 1)            # ph_gdr_or_irap (no gdr flag coded)
    w.u(0, 1)            # ph_non_ref_pic_flag
    w.u(1, 1)            # ph_inter_slice_allowed
    w.u(1, 1)            # ph_intra_slice_allowed
    w.ue(0)              # pps_id
    w.u(poc_lsb, 8)      # ph_pic_order_cnt_lsb
    w.u(0, 1)            # ph_mvd_l1_zero_flag
    w.ue(slice_type)     # sh_slice_type (0=B, 1=P)
    for lst in rpl_deltas:
        w.ue(len(lst))   # num_ref_entries
        for d in lst:    # cumulative signed POC deltas
            w.ue(abs(d) - 1)          # abs_delta_poc_st
            w.u(1 if d < 0 else 0, 1)  # strp_entry_sign_flag
    n_lists = 2 if slice_type == 0 else 1
    if len(rpl_deltas[0]) > 1 or \
            (slice_type == 0 and len(rpl_deltas[1]) > 1):
        w.u(1, 1)        # sh_num_ref_idx_active_override
        for i in range(n_lists):
            if len(rpl_deltas[i]) > 1:
                w.ue(n_active[i] - 1)
    w.se(qp_delta)       # sh_qp_delta
    w.u(1, 1)            # byte alignment one-bit
    while len(w.bits) % 8:
        w.u(0, 1)
    return w


def _cabac_payload(hw, enc):
    bits = hw.bits + enc.bitstring()
    while len(bits) % 8:
        bits.append(0)
    payload = bytearray(len(bits) // 8)
    for i, b in enumerate(bits):
        payload[i >> 3] |= b << (7 - (i & 7))
    return bytes(payload)


def craft_gop(frames, width, height, log2_ctu=5, log2_min_cb=3,
              log2_min_qt=3, qp_delta=0, init_qp=26, bit_depth=8,
              cb_qp_offset=0, cr_qp_offset=0, mtt_depth_intra=0,
              mtt_depth_inter=0, log2_max_bt=None, log2_max_tt=None,
              nrefs=(2, 1), max_num_merge_cand=6):
    """→ annex-B stream: SPS + PPS + IDR + TRAIL P/B slices.
    `frames` is a list of ('I'|'P'|'B', plan); the first must be 'I'.
    Frame k has POC k and references the nrefs most recent frames
    (low-delay: both lists point backwards, so decode order == POC
    order). min CB 8 keeps every inter CU >= 8x8 (no 4:2:0 local
    dual tree, w+h > 12 everywhere)."""
    from ..h264 import nal as N
    if frames[0][0] != "I":
        raise ValueError("vvc craft: GOP must start with an I frame")
    sps_nal = make_sps(width, height, log2_ctu=log2_ctu,
                       log2_min_cb=log2_min_cb,
                       log2_min_qt=log2_min_qt, bit_depth=bit_depth,
                       mtt_depth_intra=mtt_depth_intra,
                       log2_max_bt=log2_max_bt,
                       log2_max_tt=log2_max_tt,
                       mtt_depth_inter=mtt_depth_inter,
                       log2_max_bt_inter=log2_max_bt,
                       log2_max_tt_inter=log2_max_tt,
                       max_num_merge_cand=max_num_merge_cand)
    pps_nal = make_pps(width, height, init_qp=init_qp,
                       cb_qp_offset=cb_qp_offset,
                       cr_qp_offset=cr_qp_offset)
    sps = P.parse_sps(N.unescape(sps_nal[6:]))
    pps = P.parse_pps(N.unescape(pps_nal[6:]))
    out = sps_nal + pps_nal
    for poc, (kind, plan) in enumerate(frames):
        if kind == "I":
            if poc:
                raise ValueError("vvc craft: only the first frame "
                                 "may be I")
            sh = P.VvcSliceHeader(qp=init_qp + qp_delta, poc_lsb=poc)
            dec = FrameDec(sps, pps, sh)
            enc = VvcCabacEncoder()
            CtuCoder(dec, enc, encode=True,
                     plan=plan).code_slice_data()
            hw = slice_header_bits(qp_delta, poc_lsb=poc)
            out += vnal(P.NAL_IDR_W_RADL, _cabac_payload(hw, enc))
            continue
        st = 0 if kind == "B" else 1
        n0 = min(nrefs[0], poc)
        n1 = min(nrefs[1], poc) if st == 0 else 0
        rpl = ([-1] * n0, [-1] * n1)
        n_active = (n0, n1)
        rpl_poc = ([poc - 1 - k for k in range(n0)],
                   [poc - 1 - k for k in range(n1)])
        sh = P.VvcSliceHeader(slice_type=st, poc_lsb=poc,
                              qp=init_qp + qp_delta,
                              rpl_deltas=rpl,
                              num_ref_idx_active=n_active)
        dec = FrameDec(sps, pps, sh, rpl_poc=rpl_poc)
        enc = VvcCabacEncoder()
        CtuCoder(dec, enc, encode=True, plan=plan).code_slice_data()
        hw = slice_header_bits_inter(st, poc, rpl, n_active, qp_delta)
        out += vnal(P.NAL_TRAIL, _cabac_payload(hw, enc))
    return out


def craft_frame(plan, width, height, log2_ctu=5, log2_min_qt=3,
                qp_delta=0, init_qp=26, bit_depth=8,
                cb_qp_offset=0, cr_qp_offset=0, log2_min_cb=2,
                mtt_depth_intra=0, log2_max_bt=None,
                log2_max_tt=None):
    """→ annex-B stream: SPS + PPS + one IDR I slice."""
    from ..h264 import nal as N
    sps_nal = make_sps(width, height, log2_ctu=log2_ctu,
                       log2_min_cb=log2_min_cb,
                       log2_min_qt=log2_min_qt, bit_depth=bit_depth,
                       mtt_depth_intra=mtt_depth_intra,
                       log2_max_bt=log2_max_bt,
                       log2_max_tt=log2_max_tt)
    pps_nal = make_pps(width, height, init_qp=init_qp,
                       cb_qp_offset=cb_qp_offset,
                       cr_qp_offset=cr_qp_offset)
    sps = P.parse_sps(N.unescape(sps_nal[6:]))
    pps = P.parse_pps(N.unescape(pps_nal[6:]))
    sh = P.VvcSliceHeader(qp=init_qp + qp_delta)
    dec = FrameDec(sps, pps, sh)
    enc = VvcCabacEncoder()
    CtuCoder(dec, enc, encode=True, plan=plan).code_slice_data()
    hw = slice_header_bits(qp_delta)
    bits = hw.bits + enc.bitstring()
    while len(bits) % 8:
        bits.append(0)
    payload = bytearray(len(bits) // 8)
    for i, b in enumerate(bits):
        payload[i >> 3] |= b << (7 - (i & 7))
    return sps_nal + pps_nal + vnal(P.NAL_IDR_W_RADL, bytes(payload))
