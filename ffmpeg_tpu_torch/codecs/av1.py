"""AV1 at reference scope — OBU layer, sequence/frame header syntax,
parser, frame split/merge BSFs and a shell decoder.

The reference's native AV1 support is a CBS-parse + hwaccel shell
(libavcodec/av1dec.c:1546 — software reconstruction is intentionally
delegated to external libs), plus cbs_av1.c syntax (de)serialisation,
av1_parser.c, av1_frame_split/av1_frame_merge BSFs and av1dec raw
demux.  This module provides the same scope, re-derived from the AV1
bitstream specification (not translated): leb128/OBU framing, the full
sequence_header_obu() syntax, uncompressed_header() through frame/render
size (the stream-introspection subset: frame type, show flags,
dimensions, order hint, refresh mask), a crafting writer used by the
tests, and the packetisation tooling around them.  Actual tile
reconstruction raises NotSupported exactly like the reference does
without a hwaccel.

The port's copy of ffmpeg_tpu/codecs/av1.py, held equal to it by
tests/test_torch_bsf_av1.py.
The shell decoder parses its headers on the host and raises
NotSupported, as the reference's does; the decode backstop
(codecs/codec.py) lets that error through.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..utils.error import EndOfStream, InvalidData, NotSupported
from ..io.stream import CodecParameters, MediaType
from .bitstream import BitReader, BitWriter
from .bsf import BitstreamFilter, register_bsf
from .codec import DeviceCodec, register_decoder
from .parsers import Parser, register_parser

# OBU types (spec 6.2.2)
OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_METADATA = 5
OBU_FRAME = 6
OBU_REDUNDANT_FRAME_HEADER = 7
OBU_TILE_LIST = 8
OBU_PADDING = 15

KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME, SWITCH_FRAME = 0, 1, 2, 3
PRIMARY_REF_NONE = 7
SELECT_SCREEN_CONTENT_TOOLS = 2
SELECT_INTEGER_MV = 2
NUM_REF_FRAMES = 8
REFS_PER_FRAME = 7


# --------------------------------------------------------------------------
# leb128 + OBU framing (spec 4.10.5, 5.3)

def leb128_read(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    for i in range(8):
        if pos >= len(data):
            raise InvalidData("av1: truncated leb128")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << (7 * i)
        if not (b & 0x80):
            return value, pos
    raise InvalidData("av1: leb128 too long")


def leb128_write(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


@dataclass
class Obu:
    type: int
    payload: bytes
    temporal_id: int = 0
    spatial_id: int = 0
    raw: bytes = b""          # full OBU incl. header+size field


def split_obus(data: bytes) -> List[Obu]:
    """Split a byte string into OBUs (obu_has_size_field form)."""
    out: List[Obu] = []
    pos = 0
    n = len(data)
    while pos < n:
        start = pos
        hdr = data[pos]
        pos += 1
        if hdr & 0x80:
            raise InvalidData("av1: obu_forbidden_bit set")
        otype = (hdr >> 3) & 0xF
        ext = (hdr >> 2) & 1
        has_size = (hdr >> 1) & 1
        tid = sid = 0
        if ext:
            if pos >= n:
                raise InvalidData("av1: truncated obu extension")
            tid = data[pos] >> 5
            sid = (data[pos] >> 3) & 3
            pos += 1
        if has_size:
            size, pos = leb128_read(data, pos)
        else:
            size = n - pos      # last OBU extends to end (low-overhead fmt)
        if pos + size > n:
            raise InvalidData("av1: obu overruns buffer")
        out.append(Obu(otype, data[pos:pos + size], tid, sid,
                       data[start:pos + size]))
        pos += size
    return out


def wrap_obu(otype: int, payload: bytes) -> bytes:
    hdr = bytes([(otype << 3) | 0x02])          # has_size_field=1
    return hdr + leb128_write(len(payload)) + payload


# --------------------------------------------------------------------------
# sequence header (spec 5.5)

@dataclass
class Av1SequenceHeader:
    seq_profile: int = 0
    still_picture: int = 0
    reduced_still_picture_header: int = 0
    seq_level_idx: List[int] = field(default_factory=lambda: [0])
    seq_tier: List[int] = field(default_factory=lambda: [0])
    operating_point_idc: List[int] = field(default_factory=lambda: [0])
    decoder_model_info_present: int = 0
    equal_picture_interval: int = 0
    buffer_removal_time_length: int = 0
    frame_presentation_time_length: int = 0
    decoder_model_present_for_op: List[int] = field(default_factory=list)
    initial_display_delay_present: int = 0
    frame_width_bits: int = 16
    frame_height_bits: int = 16
    max_frame_width: int = 0
    max_frame_height: int = 0
    frame_id_numbers_present: int = 0
    delta_frame_id_length: int = 0
    additional_frame_id_length: int = 0
    use_128x128_superblock: int = 0
    enable_filter_intra: int = 0
    enable_intra_edge_filter: int = 0
    enable_interintra_compound: int = 0
    enable_masked_compound: int = 0
    enable_warped_motion: int = 0
    enable_dual_filter: int = 0
    enable_order_hint: int = 0
    enable_jnt_comp: int = 0
    enable_ref_frame_mvs: int = 0
    force_screen_content_tools: int = SELECT_SCREEN_CONTENT_TOOLS
    force_integer_mv: int = SELECT_INTEGER_MV
    order_hint_bits: int = 0
    enable_superres: int = 0
    enable_cdef: int = 0
    enable_restoration: int = 0
    bit_depth: int = 8
    mono_chrome: int = 0
    color_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    color_description_present: int = 0
    color_range: int = 0
    subsampling_x: int = 1
    subsampling_y: int = 1
    chroma_sample_position: int = 0
    separate_uv_delta_q: int = 0
    film_grain_params_present: int = 0

    @property
    def pix_fmt(self) -> str:
        if self.mono_chrome:
            base = "gray"
            return {8: "gray", 10: "gray10le", 12: "gray12le"}[self.bit_depth]
        sub = (self.subsampling_x, self.subsampling_y)
        fam = {(1, 1): "yuv420p", (1, 0): "yuv422p", (0, 0): "yuv444p"}[sub]
        if self.bit_depth == 8:
            return fam
        return f"{fam}{self.bit_depth}le"


def _timing_info(r: BitReader) -> int:
    r.get(32)                                 # num_units_in_display_tick
    r.get(32)                                 # time_scale
    equal = r.get(1)
    if equal:
        # uvlc(): count leading zeros, read that many bits
        lead = 0
        while not r.get(1):
            lead += 1
            if lead > 31:
                raise InvalidData("av1: uvlc overrun")
        if lead:
            r.get(lead)
    return equal


def parse_sequence_header(payload: bytes) -> Av1SequenceHeader:
    r = BitReader(payload)
    s = Av1SequenceHeader()
    s.seq_profile = r.get(3)
    if s.seq_profile > 2:
        raise InvalidData("av1: bad seq_profile")
    s.still_picture = r.get(1)
    s.reduced_still_picture_header = r.get(1)
    buffer_delay_len = 0
    if s.reduced_still_picture_header:
        s.seq_level_idx = [r.get(5)]
        s.seq_tier = [0]
        s.operating_point_idc = [0]
    else:
        if r.get(1):                          # timing_info_present
            s.equal_picture_interval = _timing_info(r)
            s.decoder_model_info_present = r.get(1)
            if s.decoder_model_info_present:
                buffer_delay_len = r.get(5) + 1
                r.get(32)                     # num_units_in_decoding_tick
                s.buffer_removal_time_length = r.get(5) + 1
                s.frame_presentation_time_length = r.get(5) + 1
        s.initial_display_delay_present = r.get(1)
        n_ops = r.get(5) + 1
        s.operating_point_idc, s.seq_level_idx, s.seq_tier = [], [], []
        for _ in range(n_ops):
            s.operating_point_idc.append(r.get(12))
            lvl = r.get(5)
            s.seq_level_idx.append(lvl)
            s.seq_tier.append(r.get(1) if lvl > 7 else 0)
            dm = r.get(1) if s.decoder_model_info_present else 0
            s.decoder_model_present_for_op.append(dm)
            if dm:
                r.get(buffer_delay_len)       # decoder_buffer_delay
                r.get(buffer_delay_len)       # encoder_buffer_delay
                r.get(1)                      # low_delay_mode_flag
            if s.initial_display_delay_present and r.get(1):
                r.get(4)                      # initial_display_delay_minus_1
    s.frame_width_bits = r.get(4) + 1
    s.frame_height_bits = r.get(4) + 1
    s.max_frame_width = r.get(s.frame_width_bits) + 1
    s.max_frame_height = r.get(s.frame_height_bits) + 1
    if not s.reduced_still_picture_header:
        s.frame_id_numbers_present = r.get(1)
    if s.frame_id_numbers_present:
        s.delta_frame_id_length = r.get(4) + 2
        s.additional_frame_id_length = r.get(3) + 1
    s.use_128x128_superblock = r.get(1)
    s.enable_filter_intra = r.get(1)
    s.enable_intra_edge_filter = r.get(1)
    if s.reduced_still_picture_header:
        s.force_screen_content_tools = SELECT_SCREEN_CONTENT_TOOLS
        s.force_integer_mv = SELECT_INTEGER_MV
    else:
        s.enable_interintra_compound = r.get(1)
        s.enable_masked_compound = r.get(1)
        s.enable_warped_motion = r.get(1)
        s.enable_dual_filter = r.get(1)
        s.enable_order_hint = r.get(1)
        if s.enable_order_hint:
            s.enable_jnt_comp = r.get(1)
            s.enable_ref_frame_mvs = r.get(1)
        if r.get(1):                          # seq_choose_screen_content_tools
            s.force_screen_content_tools = SELECT_SCREEN_CONTENT_TOOLS
        else:
            s.force_screen_content_tools = r.get(1)
        if s.force_screen_content_tools > 0:
            if r.get(1):                      # seq_choose_integer_mv
                s.force_integer_mv = SELECT_INTEGER_MV
            else:
                s.force_integer_mv = r.get(1)
        else:
            s.force_integer_mv = SELECT_INTEGER_MV
        if s.enable_order_hint:
            s.order_hint_bits = r.get(3) + 1
    s.enable_superres = r.get(1)
    s.enable_cdef = r.get(1)
    s.enable_restoration = r.get(1)
    # color_config() (spec 5.5.2)
    high = r.get(1)
    if s.seq_profile == 2 and high:
        s.bit_depth = 12 if r.get(1) else 10
    else:
        s.bit_depth = 10 if high else 8
    s.mono_chrome = 0 if s.seq_profile == 1 else r.get(1)
    s.color_description_present = r.get(1)
    if s.color_description_present:
        s.color_primaries = r.get(8)
        s.transfer_characteristics = r.get(8)
        s.matrix_coefficients = r.get(8)
    if s.mono_chrome:
        s.color_range = r.get(1)
        s.subsampling_x = s.subsampling_y = 1
    elif (s.color_primaries == 1 and s.transfer_characteristics == 13
          and s.matrix_coefficients == 0):    # sRGB triple
        s.color_range = 1
        s.subsampling_x = s.subsampling_y = 0
    else:
        s.color_range = r.get(1)
        if s.seq_profile == 0:
            s.subsampling_x = s.subsampling_y = 1
        elif s.seq_profile == 1:
            s.subsampling_x = s.subsampling_y = 0
        else:
            if s.bit_depth == 12:
                s.subsampling_x = r.get(1)
                s.subsampling_y = r.get(1) if s.subsampling_x else 0
            else:
                s.subsampling_x, s.subsampling_y = 1, 0
        if s.subsampling_x and s.subsampling_y:
            s.chroma_sample_position = r.get(2)
    if not s.mono_chrome:
        s.separate_uv_delta_q = r.get(1)
    s.film_grain_params_present = r.get(1)
    return s


def write_sequence_header(s: Av1SequenceHeader) -> bytes:
    """Craft a sequence_header_obu payload (test/tooling writer).

    Only the field combinations this module itself produces are
    supported: no timing/decoder-model info, single operating point.
    """
    w = BitWriter()
    w.put(s.seq_profile, 3)
    w.put(s.still_picture, 1)
    w.put(s.reduced_still_picture_header, 1)
    if s.reduced_still_picture_header:
        w.put(s.seq_level_idx[0], 5)
    else:
        w.put(0, 1)                           # timing_info_present
        w.put(0, 1)                           # initial_display_delay_present
        w.put(0, 5)                           # operating_points_cnt_minus_1
        w.put(s.operating_point_idc[0], 12)
        w.put(s.seq_level_idx[0], 5)
        if s.seq_level_idx[0] > 7:
            w.put(s.seq_tier[0], 1)
    w.put(s.frame_width_bits - 1, 4)
    w.put(s.frame_height_bits - 1, 4)
    w.put(s.max_frame_width - 1, s.frame_width_bits)
    w.put(s.max_frame_height - 1, s.frame_height_bits)
    if not s.reduced_still_picture_header:
        w.put(s.frame_id_numbers_present, 1)
    if s.frame_id_numbers_present:
        w.put(s.delta_frame_id_length - 2, 4)
        w.put(s.additional_frame_id_length - 1, 3)
    w.put(s.use_128x128_superblock, 1)
    w.put(s.enable_filter_intra, 1)
    w.put(s.enable_intra_edge_filter, 1)
    if not s.reduced_still_picture_header:
        w.put(s.enable_interintra_compound, 1)
        w.put(s.enable_masked_compound, 1)
        w.put(s.enable_warped_motion, 1)
        w.put(s.enable_dual_filter, 1)
        w.put(s.enable_order_hint, 1)
        if s.enable_order_hint:
            w.put(s.enable_jnt_comp, 1)
            w.put(s.enable_ref_frame_mvs, 1)
        if s.force_screen_content_tools == SELECT_SCREEN_CONTENT_TOOLS:
            w.put(1, 1)
        else:
            w.put(0, 1)
            w.put(s.force_screen_content_tools, 1)
        if s.force_screen_content_tools > 0:
            if s.force_integer_mv == SELECT_INTEGER_MV:
                w.put(1, 1)
            else:
                w.put(0, 1)
                w.put(s.force_integer_mv, 1)
        if s.enable_order_hint:
            w.put(s.order_hint_bits - 1, 3)
    w.put(s.enable_superres, 1)
    w.put(s.enable_cdef, 1)
    w.put(s.enable_restoration, 1)
    # color_config
    if s.seq_profile == 2 and s.bit_depth == 12:
        w.put(1, 1)
        w.put(1, 1)
    elif s.seq_profile == 2 and s.bit_depth == 10:
        w.put(1, 1)
        w.put(0, 1)
    else:
        w.put(1 if s.bit_depth == 10 else 0, 1)
    if s.seq_profile != 1:
        w.put(s.mono_chrome, 1)
    w.put(s.color_description_present, 1)
    if s.color_description_present:
        w.put(s.color_primaries, 8)
        w.put(s.transfer_characteristics, 8)
        w.put(s.matrix_coefficients, 8)
    srgb = (s.color_primaries == 1 and s.transfer_characteristics == 13
            and s.matrix_coefficients == 0)
    if s.mono_chrome:
        w.put(s.color_range, 1)
    elif not srgb:
        w.put(s.color_range, 1)
        if s.seq_profile == 2 and s.bit_depth == 12:
            w.put(s.subsampling_x, 1)
            if s.subsampling_x:
                w.put(s.subsampling_y, 1)
        if s.subsampling_x and s.subsampling_y:
            w.put(s.chroma_sample_position, 2)
    if not s.mono_chrome:
        w.put(s.separate_uv_delta_q, 1)
    w.put(s.film_grain_params_present, 1)
    w.put(1, 1)                               # trailing one bit
    w.align()
    return w.bytes()


# --------------------------------------------------------------------------
# frame header — stream-introspection subset of uncompressed_header()
# (spec 5.9.2): through frame/render size for intra frames; for inter
# frames through the ref-frame-idx list and frame_size_with_refs.

@dataclass
class Av1FrameHeader:
    show_existing_frame: int = 0
    frame_to_show_map_idx: int = 0
    frame_type: int = KEY_FRAME
    show_frame: int = 1
    error_resilient_mode: int = 0
    disable_cdf_update: int = 0
    frame_size_override: int = 0
    order_hint: int = 0
    refresh_frame_flags: int = 0xFF
    width: int = 0
    height: int = 0
    render_width: int = 0
    render_height: int = 0
    superres_denom: int = 8
    ref_frame_idx: List[int] = field(default_factory=list)

    @property
    def is_intra(self) -> bool:
        return self.frame_type in (KEY_FRAME, INTRA_ONLY_FRAME)

    @property
    def is_key(self) -> bool:
        return self.frame_type == KEY_FRAME


def _frame_size(r: BitReader, seq: Av1SequenceHeader,
                h: Av1FrameHeader) -> None:
    if h.frame_size_override:
        h.width = r.get(seq.frame_width_bits) + 1
        h.height = r.get(seq.frame_height_bits) + 1
    else:
        h.width, h.height = seq.max_frame_width, seq.max_frame_height
    # superres_params()
    use = r.get(1) if seq.enable_superres else 0
    h.superres_denom = r.get(3) + 9 if use else 8
    # render_size()
    if r.get(1):
        h.render_width = r.get(16) + 1
        h.render_height = r.get(16) + 1
    else:
        h.render_width, h.render_height = h.width, h.height


def parse_frame_header(payload: bytes, seq: Av1SequenceHeader,
                       ref_sizes: Optional[list] = None,
                       temporal_id: int = 0,
                       spatial_id: int = 0) -> Av1FrameHeader:
    """Parse uncompressed_header() through frame/render size.

    ref_sizes: optional 8-entry list of (w, h, rw, rh) kept by the
    caller, used to resolve frame_size_with_refs() for inter frames
    and updated in place from refresh_frame_flags.
    """
    r = BitReader(payload)
    h = Av1FrameHeader()
    id_len = (seq.additional_frame_id_length + seq.delta_frame_id_length
              if seq.frame_id_numbers_present else 0)
    if seq.reduced_still_picture_header:
        h.frame_type, h.show_frame = KEY_FRAME, 1
        h.frame_size_override = 0
        _frame_size(r, seq, h)
        _update_refs(ref_sizes, h)
        return h
    h.show_existing_frame = r.get(1)
    if h.show_existing_frame:
        h.frame_to_show_map_idx = r.get(3)
        if seq.decoder_model_info_present and not seq.equal_picture_interval:
            r.get(seq.frame_presentation_time_length)  # temporal_point_info
        if seq.frame_id_numbers_present:
            r.get(id_len)                     # display_frame_id
        if ref_sizes is not None:
            w, hh, rw, rh = ref_sizes[h.frame_to_show_map_idx]
            h.width, h.height = w, hh
            h.render_width, h.render_height = rw, rh
        return h
    h.frame_type = r.get(2)
    h.show_frame = r.get(1)
    if h.show_frame:
        if seq.decoder_model_info_present and not seq.equal_picture_interval:
            r.get(seq.frame_presentation_time_length)  # temporal_point_info
    else:
        r.get(1)                              # showable_frame
    if h.frame_type == SWITCH_FRAME or \
            (h.frame_type == KEY_FRAME and h.show_frame):
        h.error_resilient_mode = 1
    else:
        h.error_resilient_mode = r.get(1)
    h.disable_cdf_update = r.get(1)
    allow_screen_content = seq.force_screen_content_tools
    if seq.force_screen_content_tools == SELECT_SCREEN_CONTENT_TOOLS:
        allow_screen_content = r.get(1)
    if allow_screen_content:
        if seq.force_integer_mv == SELECT_INTEGER_MV:
            r.get(1)                          # force_integer_mv
    if seq.frame_id_numbers_present:
        r.get(id_len)                         # current_frame_id
    if h.frame_type == SWITCH_FRAME:
        h.frame_size_override = 1
    else:
        h.frame_size_override = r.get(1)
    if seq.order_hint_bits:
        h.order_hint = r.get(seq.order_hint_bits)
    if not (h.is_intra or h.error_resilient_mode):
        r.get(3)                              # primary_ref_frame
    if seq.decoder_model_info_present and r.get(1):
        # buffer_removal_time_present_flag (spec 5.9.2)
        for op, idc in enumerate(seq.operating_point_idc):
            if not (seq.decoder_model_present_for_op[op:op + 1] or [0])[0]:
                continue
            in_t = (idc >> temporal_id) & 1
            in_s = (idc >> (spatial_id + 8)) & 1
            if idc == 0 or (in_t and in_s):
                r.get(seq.buffer_removal_time_length)  # buffer_removal_time
    if h.frame_type == SWITCH_FRAME or \
            (h.frame_type == KEY_FRAME and h.show_frame):
        h.refresh_frame_flags = 0xFF
    else:
        h.refresh_frame_flags = r.get(8)
    if (not h.is_intra or h.refresh_frame_flags != 0xFF) and \
            h.error_resilient_mode and seq.enable_order_hint:
        for _ in range(NUM_REF_FRAMES):
            r.get(seq.order_hint_bits)        # ref_order_hint
    if h.is_intra:
        _frame_size(r, seq, h)
    else:
        short = r.get(1) if seq.enable_order_hint else 0
        if short:
            r.get(3)                          # last_frame_idx
            r.get(3)                          # gold_frame_idx
            h.ref_frame_idx = [-1] * REFS_PER_FRAME
        for i in range(REFS_PER_FRAME):
            if not short:
                h.ref_frame_idx.append(r.get(3))
            # delta_frame_id_minus_1 is read per-ref even with
            # frame_refs_short_signaling (spec 5.9.2 loop)
            if seq.frame_id_numbers_present:
                r.get(seq.delta_frame_id_length)
        if h.frame_size_override and not h.error_resilient_mode:
            # frame_size_with_refs()
            found = 0
            for idx in h.ref_frame_idx:
                if r.get(1):
                    found = 1
                    if ref_sizes is not None and 0 <= idx < NUM_REF_FRAMES:
                        w, hh, rw, rh = ref_sizes[idx]
                        h.width, h.height = w, hh
                        h.render_width, h.render_height = rw, rh
                    break
            if not found:
                _frame_size(r, seq, h)
            elif seq.enable_superres:
                use = r.get(1)
                h.superres_denom = r.get(3) + 9 if use else 8
        else:
            _frame_size(r, seq, h)
    _update_refs(ref_sizes, h)
    return h


def _update_refs(ref_sizes: Optional[list], h: Av1FrameHeader) -> None:
    if ref_sizes is None or h.show_existing_frame:
        return
    entry = (h.width, h.height, h.render_width, h.render_height)
    for i in range(NUM_REF_FRAMES):
        if h.refresh_frame_flags & (1 << i):
            ref_sizes[i] = entry


def write_frame_header(h: Av1FrameHeader, seq: Av1SequenceHeader) -> bytes:
    """Craft an uncompressed frame-header payload (crafting subset:
    no frame ids, no order hints unless enabled, intra frames sized
    explicitly, inter frames with explicit ref_frame_idx)."""
    w = BitWriter()
    if seq.reduced_still_picture_header:
        raise NotSupported("av1 writer: reduced headers")
    w.put(h.show_existing_frame, 1)
    if h.show_existing_frame:
        w.put(h.frame_to_show_map_idx, 3)
        w.put(1, 1)
        w.align()
        return w.bytes()
    w.put(h.frame_type, 2)
    w.put(h.show_frame, 1)
    if not h.show_frame:
        w.put(1, 1)                           # showable_frame
    if not (h.frame_type == SWITCH_FRAME or
            (h.frame_type == KEY_FRAME and h.show_frame)):
        w.put(h.error_resilient_mode, 1)
    w.put(h.disable_cdf_update, 1)
    if seq.force_screen_content_tools == SELECT_SCREEN_CONTENT_TOOLS:
        w.put(0, 1)                           # allow_screen_content_tools=0
    if h.frame_type != SWITCH_FRAME:
        w.put(h.frame_size_override, 1)
    if seq.order_hint_bits:
        w.put(h.order_hint, seq.order_hint_bits)
    if not (h.is_intra or h.error_resilient_mode):
        w.put(PRIMARY_REF_NONE, 3)
    if not (h.frame_type == SWITCH_FRAME or
            (h.frame_type == KEY_FRAME and h.show_frame)):
        w.put(h.refresh_frame_flags, 8)
    if (not h.is_intra or h.refresh_frame_flags != 0xFF) and \
            h.error_resilient_mode and seq.enable_order_hint:
        for _ in range(NUM_REF_FRAMES):
            w.put(0, seq.order_hint_bits)
    def put_size():
        if h.frame_size_override:
            w.put(h.width - 1, seq.frame_width_bits)
            w.put(h.height - 1, seq.frame_height_bits)
        if seq.enable_superres:
            w.put(0, 1)
        w.put(0, 1)                           # render same as frame
    if h.is_intra:
        put_size()
    else:
        if seq.enable_order_hint:
            w.put(0, 1)                       # frame_refs_short_signaling=0
        for idx in (h.ref_frame_idx or [0] * REFS_PER_FRAME):
            w.put(idx, 3)
        if h.frame_size_override and not h.error_resilient_mode:
            for _ in (h.ref_frame_idx or [0] * REFS_PER_FRAME):
                w.put(0, 1)                   # found_ref=0
            put_size()
        else:
            put_size()
    w.put(1, 1)                               # trailing bit
    w.align()
    return w.bytes()


# --------------------------------------------------------------------------
# extradata (ISOBMFF av1C, AV1-ISOBMFF §2.3)

def parse_av1c(extradata: bytes) -> Optional[Av1SequenceHeader]:
    if len(extradata) < 4 or (extradata[0] >> 7) != 1:
        return None
    for obu in split_obus(extradata[4:]):
        if obu.type == OBU_SEQUENCE_HEADER:
            return parse_sequence_header(obu.payload)
    return None


def build_av1c(seq_obu: bytes, seq: Av1SequenceHeader) -> bytes:
    b0 = 0x81                                 # marker=1, version=1
    b1 = (seq.seq_profile << 5) | seq.seq_level_idx[0]
    b2 = ((seq.seq_tier[0] << 7)
          | ((1 if seq.bit_depth > 8 else 0) << 6)
          | ((1 if seq.bit_depth == 12 else 0) << 5)
          | (seq.mono_chrome << 4)
          | (seq.subsampling_x << 3) | (seq.subsampling_y << 2)
          | seq.chroma_sample_position)
    return bytes([b0, b1, b2, 0]) + seq_obu


# --------------------------------------------------------------------------
# shell decoder — same stance as the reference (av1dec.c:1546): full
# header parse, DPB bookkeeping, reconstruction requires an accelerator
# backend the platform does not provide in software.

@register_decoder
class Av1Decoder(DeviceCodec):
    codec_id = "av1"
    codec_type = MediaType.VIDEO

    def __init__(self, par: CodecParameters, options=None, *,
                 device="cuda"):
        super().__init__(par, options, device=device)
        self.seq: Optional[Av1SequenceHeader] = None
        self.ref_sizes = [(0, 0, 0, 0)] * NUM_REF_FRAMES
        if par.extradata:
            self.seq = parse_av1c(par.extradata)

    def parse_packet(self, data: bytes) -> List[Av1FrameHeader]:
        """Header-parse one temporal unit; returns frame headers."""
        headers: List[Av1FrameHeader] = []
        for obu in split_obus(data):
            if obu.type == OBU_SEQUENCE_HEADER:
                self.seq = parse_sequence_header(obu.payload)
            elif obu.type in (OBU_FRAME_HEADER, OBU_FRAME):
                if self.seq is None:
                    raise InvalidData("av1: frame before sequence header")
                headers.append(parse_frame_header(
                    obu.payload, self.seq, self.ref_sizes))
        return headers

    def decode(self, pkt):
        if pkt is None:
            return []
        self.parse_packet(bytes(pkt.data))    # validates the bitstream
        raise NotSupported(
            "av1: software tile reconstruction is out of scope at "
            "reference parity (av1dec.c is a hwaccel-only shell); "
            "stream parse/remux/probe are supported")


# --------------------------------------------------------------------------
# parser: split a raw OBU stream into temporal units (av1_parser.c scope)

@register_parser
class Av1Parser(Parser):
    name = "av1"

    def __init__(self):
        super().__init__()
        self.seq: Optional[Av1SequenceHeader] = None
        self.ref_sizes = [(0, 0, 0, 0)] * NUM_REF_FRAMES
        self.key_flags: List[bool] = []

    def _split(self) -> List[bytes]:
        out: List[bytes] = []
        pos = 0
        tu_start = None
        data = self.buf
        n = len(data)
        while pos < n:
            hdr = data[pos]
            if hdr & 0x80:
                raise InvalidData("av1 parser: forbidden bit")
            otype = (hdr >> 3) & 0xF
            ext = (hdr >> 2) & 1
            has_size = (hdr >> 1) & 1
            p = pos + 1 + ext
            if not has_size:
                break                         # can't frame without sizes
            if p >= n:
                break
            try:
                size, p = leb128_read(data, p)
            except InvalidData:
                break
            if p + size > n:
                break
            if otype == OBU_TEMPORAL_DELIMITER:
                if tu_start is not None:
                    out.append(self._emit(data[tu_start:pos]))
                tu_start = pos
            elif tu_start is None:
                tu_start = pos
            pos = p + size
        if tu_start is not None and tu_start > 0:
            self.buf = data[tu_start:]
        elif pos and tu_start is None:
            self.buf = data[pos:]
        return out

    def flush(self) -> List[bytes]:
        out = self._split()
        if self.buf:
            out.append(self._emit(self.buf))
            self.buf = b""
        return out

    def _emit(self, tu: bytes) -> bytes:
        key = False
        for obu in split_obus(tu):
            if obu.type == OBU_SEQUENCE_HEADER:
                self.seq = parse_sequence_header(obu.payload)
            elif obu.type in (OBU_FRAME_HEADER, OBU_FRAME) and self.seq:
                h = parse_frame_header(obu.payload, self.seq, self.ref_sizes)
                key = key or h.is_key
        self.key_flags.append(key)
        return tu


# --------------------------------------------------------------------------
# BSFs (av1_frame_split.c / av1_frame_merge.c scope)

@register_bsf
class Av1FrameSplitBsf(BitstreamFilter):
    """Split temporal units into one packet per frame."""

    name = "av1_frame_split"

    def filter(self, pkt):
        if pkt is None:
            return []
        obus = split_obus(bytes(pkt.data))
        groups: List[List[Obu]] = []
        pending: List[Obu] = []
        for obu in obus:
            if obu.type == OBU_TEMPORAL_DELIMITER:
                continue
            if obu.type in (OBU_FRAME_HEADER, OBU_FRAME):
                groups.append(pending + [obu])
                pending = []
            elif obu.type == OBU_TILE_GROUP and groups:
                groups[-1].append(obu)
            else:
                pending.append(obu)
        if pending:
            if groups:
                groups[-1].extend(pending)
            else:
                groups.append(pending)
        out = []
        for i, grp in enumerate(groups):
            np = dataclasses.replace(
                pkt, data=b"".join(o.raw for o in grp))
            if i:
                np.pts = NOPTS
                np.dts = NOPTS
            out.append(np)
        return out


@register_bsf
class Av1FrameMergeBsf(BitstreamFilter):
    """Merge frame packets back into temporal units (TD-delimited)."""

    name = "av1_frame_merge"

    def __init__(self, par=None, **opts):
        super().__init__(par, **opts)
        self._acc = None

    def filter(self, pkt):
        if pkt is None:
            if self._acc is not None:
                out, self._acc = [self._acc], None
                return out
            return []
        data = bytes(pkt.data)
        obus = split_obus(data)
        starts_tu = bool(obus) and obus[0].type == OBU_TEMPORAL_DELIMITER
        if starts_tu or self._acc is None:
            out = [self._acc] if self._acc is not None else []
            body = data if starts_tu else wrap_obu(
                OBU_TEMPORAL_DELIMITER, b"") + data
            self._acc = dataclasses.replace(pkt, data=body)
            return out
        self._acc = dataclasses.replace(
            self._acc, data=bytes(self._acc.data) + data)
        return []


# --------------------------------------------------------------------------
# raw OBU demuxer (av1dec.c `obu` low-overhead / annexb demuxers' scope:
# the size-field OBU stream form, as emitted by aomenc --obu)

from ..io.demux import Demuxer, register_demuxer  # noqa: E402
from ..core.packet import Packet, PKT_FLAG_KEY  # noqa: E402
from ..utils.rational import NOPTS, Rational  # noqa: E402


@register_demuxer
class Av1ObuDemuxer(Demuxer):
    name = "obu"
    long_name = "AV1 low overhead OBU"
    extensions = ("obu",)

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        # temporal delimiter with size field: 0x12 0x00
        if len(head) >= 2 and head[0] == 0x12 and head[1] == 0x00:
            try:
                obus = split_obus(bytes(head[:64]))
            except InvalidData:
                obus = []
            for obu in obus:
                if obu.type == OBU_SEQUENCE_HEADER:
                    return 75
            return 25 if obus else 0
        return 0

    def read_header(self) -> None:
        chunks = []
        while True:
            c = self.r.read(1 << 20)
            if not c:
                break
            chunks.append(c)
        data = b"".join(chunks)
        parser = Av1Parser()
        self._tus = parser.feed(data) + parser.flush()
        self._keys = parser.key_flags
        self._idx = 0
        seq = parser.seq
        par = CodecParameters(
            codec_type=MediaType.VIDEO, codec_id="av1",
            width=seq.max_frame_width if seq else 0,
            height=seq.max_frame_height if seq else 0)
        if seq:
            par.pix_fmt = seq.pix_fmt
        self.add_stream(codecpar=par, time_base=Rational(1, 25))

    def read_packet(self) -> Packet:
        if self._idx >= len(self._tus):
            raise EndOfStream()
        i = self._idx
        self._idx += 1
        flags = PKT_FLAG_KEY if (i < len(self._keys) and self._keys[i]) \
            else 0
        return Packet(data=self._tus[i], pts=i, dts=i, stream_index=0,
                      time_base=self.streams[0].time_base, flags=flags)
