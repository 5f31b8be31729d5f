"""Coded bitstream syntax framework (reference: libavcodec/cbs.h:396 +
cbs_h264_syntax_template.c).

Declarative read/MODIFY/write of parameter-set syntax: each unit type
is described once as a field table (name, descriptor, optional
condition), and the same table drives both the reader and the writer,
so read->write round-trips are bit-exact and edited fields re-encode
correctly. This powers the metadata bitstream filters and future
encoders' header generation.

Descriptors: ("u", n) fixed n bits; "ue"/"se" Exp-Golomb; ("u", name)
width taken from a previously-parsed field; "bytes" consumes the rest.
Conditions are callables over the partially-parsed dict.

The port's copy of ffmpeg_tpu/codecs/cbs.py, held equal to it by
tests/test_torch_bsf_av1.py.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Union

from ..utils.error import InvalidData

Field = Tuple  # (name, descriptor[, condition])


class _BitReader:
    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0
        self.n = len(data) * 8

    def u(self, nbits: int) -> int:
        if self.pos + nbits > self.n:
            raise InvalidData("cbs: out of bits")
        v = 0
        for _ in range(nbits):
            v = (v << 1) | ((self.d[self.pos >> 3] >> (7 - (self.pos & 7)))
                            & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 32:
                raise InvalidData("cbs: bad exp-golomb")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


class _BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def u(self, v: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def ue(self, v: int):
        k = v + 1
        nb = k.bit_length()
        self.u(0, nb - 1)
        self.u(k, nb)

    def se(self, v: int):
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def rbsp(self) -> bytes:
        bits = self.bits + [1]
        while len(bits) % 8:
            bits.append(0)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | bits[i + j]
            out.append(b)
        return bytes(out)


class SyntaxTable:
    """One unit type: an ordered field table shared by reader/writer."""

    def __init__(self, name: str, fields: List[Field]):
        self.name = name
        self.fields = fields

    def read(self, rbsp: bytes) -> Dict:
        br = _BitReader(rbsp)
        out: Dict = {"_type": self.name}
        self._read_fields(br, self.fields, out)
        # everything after the table must be exactly the RBSP stop bit:
        # otherwise the unit carries syntax we would silently drop
        last_one = -1
        for i in range(len(rbsp) * 8):
            if (rbsp[i >> 3] >> (7 - (i & 7))) & 1:
                last_one = i
        if last_one != br.pos:
            raise InvalidData(
                f"cbs: trailing syntax in {self.name} not covered by "
                "the template")
        return out

    def _read_fields(self, br, fields, out):
        for f in fields:
            name, desc = f[0], f[1]
            cond = f[2] if len(f) > 2 else None
            if cond is not None and not cond(out):
                continue
            if isinstance(desc, tuple) and desc[0] == "u":
                width = desc[1] if isinstance(desc[1], int) \
                    else out[desc[1]]
                out[name] = br.u(width)
            elif desc == "ue":
                out[name] = br.ue()
            elif desc == "se":
                out[name] = br.se()
            elif isinstance(desc, tuple) and desc[0] == "repeat":
                count_of, sub = desc[1], desc[2]
                n = count_of(out) if callable(count_of) else out[count_of]
                lst = []
                for _ in range(n):
                    item: Dict = {}
                    item.update(out)        # expose outer fields to conds
                    self._read_fields(br, sub, item)
                    lst.append({k: v for k, v in item.items()
                                if k in [g[0] for g in sub]})
                out[name] = lst
            else:
                raise ValueError(desc)

    def write(self, obj: Dict) -> bytes:
        bw = _BitWriter()
        self._write_fields(bw, self.fields, obj)
        return bw.rbsp()

    def _write_fields(self, bw, fields, obj):
        for f in fields:
            name, desc = f[0], f[1]
            cond = f[2] if len(f) > 2 else None
            if cond is not None and not cond(obj):
                continue
            if isinstance(desc, tuple) and desc[0] == "u":
                width = desc[1] if isinstance(desc[1], int) \
                    else obj[desc[1]]
                bw.u(obj[name], width)
            elif desc == "ue":
                bw.ue(obj[name])
            elif desc == "se":
                bw.se(obj[name])
            elif isinstance(desc, tuple) and desc[0] == "repeat":
                for item in obj[name]:
                    merged = dict(obj)
                    merged.update(item)
                    self._write_fields(bw, desc[2], merged)
            else:
                raise ValueError(desc)


# --------------------------------------------------------------------------
# H.264 parameter sets (cbs_h264_syntax_template.c sps/pps subset:
# everything our decoder supports, conditions mirroring 7.3.2.1/7.3.2.2)

_PROFILES_EXT = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139,
                 134, 135)

H264_SPS = SyntaxTable("sps", [
    ("profile_idc", ("u", 8)),
    ("constraint_flags", ("u", 8)),
    ("level_idc", ("u", 8)),
    ("sps_id", "ue"),
    ("chroma_format_idc", "ue",
     lambda o: o["profile_idc"] in _PROFILES_EXT),
    ("separate_colour_plane_flag", ("u", 1),
     lambda o: o.get("chroma_format_idc") == 3),
    ("bit_depth_luma_minus8", "ue",
     lambda o: o["profile_idc"] in _PROFILES_EXT),
    ("bit_depth_chroma_minus8", "ue",
     lambda o: o["profile_idc"] in _PROFILES_EXT),
    ("qpprime_y_zero_transform_bypass_flag", ("u", 1),
     lambda o: o["profile_idc"] in _PROFILES_EXT),
    ("seq_scaling_matrix_present_flag", ("u", 1),
     lambda o: o["profile_idc"] in _PROFILES_EXT),
    ("log2_max_frame_num_minus4", "ue"),
    ("pic_order_cnt_type", "ue"),
    ("log2_max_pic_order_cnt_lsb_minus4", "ue",
     lambda o: o["pic_order_cnt_type"] == 0),
    ("delta_pic_order_always_zero_flag", ("u", 1),
     lambda o: o["pic_order_cnt_type"] == 1),
    ("offset_for_non_ref_pic", "se",
     lambda o: o["pic_order_cnt_type"] == 1),
    ("offset_for_top_to_bottom_field", "se",
     lambda o: o["pic_order_cnt_type"] == 1),
    ("num_ref_frames_in_pic_order_cnt_cycle", "ue",
     lambda o: o["pic_order_cnt_type"] == 1),
    ("offsets_for_ref_frame",
     ("repeat", lambda o: o.get("num_ref_frames_in_pic_order_cnt_cycle",
                                0),
      [("offset_for_ref_frame", "se")]),
     lambda o: o["pic_order_cnt_type"] == 1),
    ("max_num_ref_frames", "ue"),
    ("gaps_in_frame_num_value_allowed_flag", ("u", 1)),
    ("pic_width_in_mbs_minus1", "ue"),
    ("pic_height_in_map_units_minus1", "ue"),
    ("frame_mbs_only_flag", ("u", 1)),
    ("mb_adaptive_frame_field_flag", ("u", 1),
     lambda o: not o["frame_mbs_only_flag"]),
    ("direct_8x8_inference_flag", ("u", 1)),
    ("frame_cropping_flag", ("u", 1)),
    ("frame_crop_left_offset", "ue",
     lambda o: o["frame_cropping_flag"]),
    ("frame_crop_right_offset", "ue",
     lambda o: o["frame_cropping_flag"]),
    ("frame_crop_top_offset", "ue",
     lambda o: o["frame_cropping_flag"]),
    ("frame_crop_bottom_offset", "ue",
     lambda o: o["frame_cropping_flag"]),
    ("vui_parameters_present_flag", ("u", 1)),
    # VUI is carried opaque for now (bit-exact passthrough needs the
    # full template; reject edits when present)
])

H264_PPS = SyntaxTable("pps", [
    ("pps_id", "ue"),
    ("sps_id", "ue"),
    ("entropy_coding_mode_flag", ("u", 1)),
    ("bottom_field_pic_order_in_frame_present_flag", ("u", 1)),
    ("num_slice_groups_minus1", "ue"),
    ("num_ref_idx_l0_default_active_minus1", "ue"),
    ("num_ref_idx_l1_default_active_minus1", "ue"),
    ("weighted_pred_flag", ("u", 1)),
    ("weighted_bipred_idc", ("u", 2)),
    ("pic_init_qp_minus26", "se"),
    ("pic_init_qs_minus26", "se"),
    ("chroma_qp_index_offset", "se"),
    ("deblocking_filter_control_present_flag", ("u", 1)),
    ("constrained_intra_pred_flag", ("u", 1)),
    ("redundant_pic_cnt_present_flag", ("u", 1)),
])


def _strip_rbsp_trailing(obj_bits_consumed_ok=True):
    pass


class CodedBitstream:
    """Read/modify/write for parameter-set NAL units (ff_cbs_* API)."""

    TABLES = {7: H264_SPS, 8: H264_PPS}

    @staticmethod
    def read_nal(unit: bytes) -> Optional[Dict]:
        """Annex-B-less NAL (header byte + EBSP). Returns the syntax
        dict (with _nal_ref_idc/_nal_type) or None if unsupported."""
        from .h264 import nal as _nal
        ref_idc, ntype = _nal.parse_nal_header(unit)
        table = CodedBitstream.TABLES.get(ntype)
        if table is None:
            return None
        rbsp = _nal.unescape(unit[1:])
        obj = table.read(rbsp)
        if obj.get("vui_parameters_present_flag"):
            raise InvalidData("cbs: VUI passthrough not supported")
        if obj.get("seq_scaling_matrix_present_flag"):
            raise InvalidData("cbs: scaling matrices not supported")
        obj["_nal_ref_idc"] = ref_idc
        obj["_nal_type"] = ntype
        return obj

    @staticmethod
    def write_nal(obj: Dict) -> bytes:
        table = CodedBitstream.TABLES[obj["_nal_type"]]
        rbsp = table.write(obj)
        # PPS keeps any trailing extension bits it had? we only support
        # base syntax; emulation-prevention escape:
        out = bytearray([(obj["_nal_ref_idc"] << 5) | obj["_nal_type"]])
        zeros = 0
        for b in rbsp:
            if zeros >= 2 and b <= 3:
                out.append(3)
                zeros = 0
            out.append(b)
            zeros = zeros + 1 if b == 0 else 0
        return bytes(out)


# --------------------------------------------------------------------------
# H.265/HEVC parameter sets (cbs_h265_syntax_template.c subset: the
# Main/Main10/Main12 syntax our decoder supports; conditions mirror
# ITU-T H.265 7.3.2.1-7.3.2.3 + Annex E VUI). Single temporal layer
# (max_sub_layers_minus1 == 0); scaling-list data, HRD and short-term
# RPS in the SPS are detected by the trailing-coverage check and
# rejected rather than silently dropped.

_HEVC_PTL = [
    ("general_profile_space", ("u", 2)),
    ("general_tier_flag", ("u", 1)),
    ("general_profile_idc", ("u", 5)),
    ("general_profile_compatibility_flags", ("u", 32)),
    ("general_progressive_source_flag", ("u", 1)),
    ("general_interlaced_source_flag", ("u", 1)),
    ("general_non_packed_constraint_flag", ("u", 1)),
    ("general_frame_only_constraint_flag", ("u", 1)),
    ("general_reserved_zero_43bits_hi", ("u", 32)),
    ("general_reserved_zero_43bits_lo", ("u", 11)),
    ("general_inbld_flag", ("u", 1)),
    ("general_level_idc", ("u", 8)),
]

_HEVC_VUI = [
    ("aspect_ratio_info_present_flag", ("u", 1)),
    ("aspect_ratio_idc", ("u", 8),
     lambda o: o["aspect_ratio_info_present_flag"]),
    ("sar_width", ("u", 16), lambda o: o.get("aspect_ratio_idc") == 255),
    ("sar_height", ("u", 16), lambda o: o.get("aspect_ratio_idc") == 255),
    ("overscan_info_present_flag", ("u", 1)),
    ("overscan_appropriate_flag", ("u", 1),
     lambda o: o["overscan_info_present_flag"]),
    ("video_signal_type_present_flag", ("u", 1)),
    ("video_format", ("u", 3),
     lambda o: o["video_signal_type_present_flag"]),
    ("video_full_range_flag", ("u", 1),
     lambda o: o["video_signal_type_present_flag"]),
    ("colour_description_present_flag", ("u", 1),
     lambda o: o["video_signal_type_present_flag"]),
    ("colour_primaries", ("u", 8),
     lambda o: o.get("colour_description_present_flag")),
    ("transfer_characteristics", ("u", 8),
     lambda o: o.get("colour_description_present_flag")),
    ("matrix_coeffs", ("u", 8),
     lambda o: o.get("colour_description_present_flag")),
    ("chroma_loc_info_present_flag", ("u", 1)),
    ("chroma_sample_loc_type_top_field", "ue",
     lambda o: o["chroma_loc_info_present_flag"]),
    ("chroma_sample_loc_type_bottom_field", "ue",
     lambda o: o["chroma_loc_info_present_flag"]),
    ("neutral_chroma_indication_flag", ("u", 1)),
    ("field_seq_flag", ("u", 1)),
    ("frame_field_info_present_flag", ("u", 1)),
    ("default_display_window_flag", ("u", 1)),
    ("def_disp_win_left_offset", "ue",
     lambda o: o["default_display_window_flag"]),
    ("def_disp_win_right_offset", "ue",
     lambda o: o["default_display_window_flag"]),
    ("def_disp_win_top_offset", "ue",
     lambda o: o["default_display_window_flag"]),
    ("def_disp_win_bottom_offset", "ue",
     lambda o: o["default_display_window_flag"]),
    ("vui_timing_info_present_flag", ("u", 1)),
    ("vui_num_units_in_tick", ("u", 32),
     lambda o: o["vui_timing_info_present_flag"]),
    ("vui_time_scale", ("u", 32),
     lambda o: o["vui_timing_info_present_flag"]),
    ("vui_poc_proportional_to_timing_flag", ("u", 1),
     lambda o: o["vui_timing_info_present_flag"]),
    ("vui_num_ticks_poc_diff_one_minus1", "ue",
     lambda o: o.get("vui_poc_proportional_to_timing_flag")),
    ("vui_hrd_parameters_present_flag", ("u", 1),
     lambda o: o["vui_timing_info_present_flag"]),
    ("bitstream_restriction_flag", ("u", 1)),
    ("tiles_fixed_structure_flag", ("u", 1),
     lambda o: o["bitstream_restriction_flag"]),
    ("motion_vectors_over_pic_boundaries_flag", ("u", 1),
     lambda o: o["bitstream_restriction_flag"]),
    ("restricted_ref_pic_lists_flag", ("u", 1),
     lambda o: o["bitstream_restriction_flag"]),
    ("min_spatial_segmentation_idc", "ue",
     lambda o: o["bitstream_restriction_flag"]),
    ("max_bytes_per_pic_denom", "ue",
     lambda o: o["bitstream_restriction_flag"]),
    ("max_bits_per_min_cu_denom", "ue",
     lambda o: o["bitstream_restriction_flag"]),
    ("log2_max_mv_length_horizontal", "ue",
     lambda o: o["bitstream_restriction_flag"]),
    ("log2_max_mv_length_vertical", "ue",
     lambda o: o["bitstream_restriction_flag"]),
]

HEVC_VPS = SyntaxTable("vps", [
    ("vps_video_parameter_set_id", ("u", 4)),
    ("vps_base_layer_internal_flag", ("u", 1)),
    ("vps_base_layer_available_flag", ("u", 1)),
    ("vps_max_layers_minus1", ("u", 6)),
    ("vps_max_sub_layers_minus1", ("u", 3)),
    ("vps_temporal_id_nesting_flag", ("u", 1)),
    ("vps_reserved_0xffff_16bits", ("u", 16)),
    *_HEVC_PTL,
    ("vps_sub_layer_ordering_info_present_flag", ("u", 1)),
    ("ordering_info",
     ("repeat", lambda o: (o["vps_max_sub_layers_minus1"] + 1
                           if o["vps_sub_layer_ordering_info_present_flag"]
                           else 1),
      [("vps_max_dec_pic_buffering_minus1", "ue"),
       ("vps_max_num_reorder_pics", "ue"),
       ("vps_max_latency_increase_plus1", "ue")])),
    ("vps_max_layer_id", ("u", 6)),
    ("vps_num_layer_sets_minus1", "ue"),
    ("layer_sets",
     ("repeat", lambda o: o["vps_num_layer_sets_minus1"],
      [("layer_id_included",
        ("repeat", lambda o: o["vps_max_layer_id"] + 1,
         [("layer_id_included_flag", ("u", 1))]))])),
    ("vps_timing_info_present_flag", ("u", 1)),
    ("vps_num_units_in_tick", ("u", 32),
     lambda o: o["vps_timing_info_present_flag"]),
    ("vps_time_scale", ("u", 32),
     lambda o: o["vps_timing_info_present_flag"]),
    ("vps_poc_proportional_to_timing_flag", ("u", 1),
     lambda o: o["vps_timing_info_present_flag"]),
    ("vps_num_ticks_poc_diff_one_minus1", "ue",
     lambda o: o.get("vps_poc_proportional_to_timing_flag")),
    ("vps_num_hrd_parameters", "ue",
     lambda o: o["vps_timing_info_present_flag"]),
    ("vps_extension_flag", ("u", 1)),
])

HEVC_SPS = SyntaxTable("sps", [
    ("sps_video_parameter_set_id", ("u", 4)),
    ("sps_max_sub_layers_minus1", ("u", 3)),
    ("sps_temporal_id_nesting_flag", ("u", 1)),
    *_HEVC_PTL,
    ("sps_seq_parameter_set_id", "ue"),
    ("chroma_format_idc", "ue"),
    ("separate_colour_plane_flag", ("u", 1),
     lambda o: o["chroma_format_idc"] == 3),
    ("pic_width_in_luma_samples", "ue"),
    ("pic_height_in_luma_samples", "ue"),
    ("conformance_window_flag", ("u", 1)),
    ("conf_win_left_offset", "ue",
     lambda o: o["conformance_window_flag"]),
    ("conf_win_right_offset", "ue",
     lambda o: o["conformance_window_flag"]),
    ("conf_win_top_offset", "ue",
     lambda o: o["conformance_window_flag"]),
    ("conf_win_bottom_offset", "ue",
     lambda o: o["conformance_window_flag"]),
    ("bit_depth_luma_minus8", "ue"),
    ("bit_depth_chroma_minus8", "ue"),
    ("log2_max_pic_order_cnt_lsb_minus4", "ue"),
    ("sps_sub_layer_ordering_info_present_flag", ("u", 1)),
    ("ordering_info",
     ("repeat", lambda o: (o["sps_max_sub_layers_minus1"] + 1
                           if o["sps_sub_layer_ordering_info_present_flag"]
                           else 1),
      [("sps_max_dec_pic_buffering_minus1", "ue"),
       ("sps_max_num_reorder_pics", "ue"),
       ("sps_max_latency_increase_plus1", "ue")])),
    ("log2_min_luma_coding_block_size_minus3", "ue"),
    ("log2_diff_max_min_luma_coding_block_size", "ue"),
    ("log2_min_luma_transform_block_size_minus2", "ue"),
    ("log2_diff_max_min_luma_transform_block_size", "ue"),
    ("max_transform_hierarchy_depth_inter", "ue"),
    ("max_transform_hierarchy_depth_intra", "ue"),
    ("scaling_list_enabled_flag", ("u", 1)),
    ("sps_scaling_list_data_present_flag", ("u", 1),
     lambda o: o["scaling_list_enabled_flag"]),
    ("amp_enabled_flag", ("u", 1)),
    ("sample_adaptive_offset_enabled_flag", ("u", 1)),
    ("pcm_enabled_flag", ("u", 1)),
    ("num_short_term_ref_pic_sets", "ue"),
    ("long_term_ref_pics_present_flag", ("u", 1)),
    ("sps_temporal_mvp_enabled_flag", ("u", 1)),
    ("strong_intra_smoothing_enabled_flag", ("u", 1)),
    ("vui_parameters_present_flag", ("u", 1)),
    *[(n, d, (lambda o, c=(f[2] if len(f) > 2 else None):
              o["vui_parameters_present_flag"]
              and (c(o) if c else True)))
      for f in _HEVC_VUI for n, d in [(f[0], f[1])]],
    ("sps_extension_present_flag", ("u", 1)),
])

HEVC_PPS = SyntaxTable("pps", [
    ("pps_pic_parameter_set_id", "ue"),
    ("pps_seq_parameter_set_id", "ue"),
    ("dependent_slice_segments_enabled_flag", ("u", 1)),
    ("output_flag_present_flag", ("u", 1)),
    ("num_extra_slice_header_bits", ("u", 3)),
    ("sign_data_hiding_enabled_flag", ("u", 1)),
    ("cabac_init_present_flag", ("u", 1)),
    ("num_ref_idx_l0_default_active_minus1", "ue"),
    ("num_ref_idx_l1_default_active_minus1", "ue"),
    ("init_qp_minus26", "se"),
    ("constrained_intra_pred_flag", ("u", 1)),
    ("transform_skip_enabled_flag", ("u", 1)),
    ("cu_qp_delta_enabled_flag", ("u", 1)),
    ("diff_cu_qp_delta_depth", "ue",
     lambda o: o["cu_qp_delta_enabled_flag"]),
    ("pps_cb_qp_offset", "se"),
    ("pps_cr_qp_offset", "se"),
    ("pps_slice_chroma_qp_offsets_present_flag", ("u", 1)),
    ("weighted_pred_flag", ("u", 1)),
    ("weighted_bipred_flag", ("u", 1)),
    ("transquant_bypass_enabled_flag", ("u", 1)),
    ("tiles_enabled_flag", ("u", 1)),
    ("entropy_coding_sync_enabled_flag", ("u", 1)),
    ("num_tile_columns_minus1", "ue",
     lambda o: o["tiles_enabled_flag"]),
    ("num_tile_rows_minus1", "ue", lambda o: o["tiles_enabled_flag"]),
    ("uniform_spacing_flag", ("u", 1),
     lambda o: o["tiles_enabled_flag"]),
    ("column_widths",
     ("repeat", lambda o: o["num_tile_columns_minus1"],
      [("column_width_minus1", "ue")]),
     lambda o: o["tiles_enabled_flag"]
     and not o["uniform_spacing_flag"]),
    ("row_heights",
     ("repeat", lambda o: o["num_tile_rows_minus1"],
      [("row_height_minus1", "ue")]),
     lambda o: o["tiles_enabled_flag"]
     and not o["uniform_spacing_flag"]),
    ("loop_filter_across_tiles_enabled_flag", ("u", 1),
     lambda o: o["tiles_enabled_flag"]),
    ("pps_loop_filter_across_slices_enabled_flag", ("u", 1)),
    ("deblocking_filter_control_present_flag", ("u", 1)),
    ("deblocking_filter_override_enabled_flag", ("u", 1),
     lambda o: o["deblocking_filter_control_present_flag"]),
    ("pps_deblocking_filter_disabled_flag", ("u", 1),
     lambda o: o["deblocking_filter_control_present_flag"]),
    ("pps_beta_offset_div2", "se",
     lambda o: (o["deblocking_filter_control_present_flag"]
                and not o["pps_deblocking_filter_disabled_flag"])),
    ("pps_tc_offset_div2", "se",
     lambda o: (o["deblocking_filter_control_present_flag"]
                and not o["pps_deblocking_filter_disabled_flag"])),
    ("pps_scaling_list_data_present_flag", ("u", 1)),
    ("lists_modification_present_flag", ("u", 1)),
    ("log2_parallel_merge_level_minus2", "ue"),
    ("slice_segment_header_extension_present_flag", ("u", 1)),
    ("pps_extension_present_flag", ("u", 1)),
])


class HevcCodedBitstream:
    """Read/modify/write for HEVC parameter-set NAL units
    (ff_cbs_h265 analog; two-byte nal_unit_header per 7.3.1.2)."""

    TABLES = {32: HEVC_VPS, 33: HEVC_SPS, 34: HEVC_PPS}

    @staticmethod
    def read_nal(unit: bytes) -> Optional[Dict]:
        if len(unit) < 3:
            return None
        ntype = (unit[0] >> 1) & 0x3F
        table = HevcCodedBitstream.TABLES.get(ntype)
        if table is None:
            return None
        from .h264 import nal as _nal
        rbsp = _nal.unescape(unit[2:])
        obj = table.read(rbsp)
        obj["_nal_type"] = ntype
        obj["_layer_id"] = ((unit[0] & 1) << 5) | (unit[1] >> 3)
        obj["_temporal_id_plus1"] = unit[1] & 7
        return obj

    @staticmethod
    def write_nal(obj: Dict) -> bytes:
        table = HevcCodedBitstream.TABLES[obj["_nal_type"]]
        rbsp = table.write(obj)
        hdr = bytes([(obj["_nal_type"] << 1) | (obj["_layer_id"] >> 5),
                     ((obj["_layer_id"] & 31) << 3)
                     | obj["_temporal_id_plus1"]])
        out = bytearray(hdr)
        zeros = 0
        for b in rbsp:
            if zeros >= 2 and b <= 3:
                out.append(3)
                zeros = 0
            out.append(b)
            zeros = zeros + 1 if b == 0 else 0
        return bytes(out)
