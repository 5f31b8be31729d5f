"""VP8 frame header (RFC 6386 §9; reference: libavcodec/vp8.c
vp8_decode_frame_header): the uncompressed tag, the bool-coded first
partition (segmentation, filter, quants, probability updates) and the
token-partition layout.

The port's copy of ffmpeg_tpu/codecs/vp8/header.py, held equal to it by
tests/test_torch_vp8_webp.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ...utils.error import InvalidData
from ..vp9.bool import BoolDecoder
from . import tables_gen as T


@dataclass
class VP8Header:
    keyframe: bool = True
    profile: int = 0
    invisible: bool = False
    width: int = 0
    height: int = 0
    colorspace: int = 0
    fullrange: int = 0
    # segmentation
    seg_enabled: bool = False
    seg_update_map: bool = False
    seg_absolute: bool = False
    seg_base_quant: list = field(default_factory=lambda: [0] * 4)
    seg_filter_level: list = field(default_factory=lambda: [0] * 4)
    segmentid_probs: list = field(default_factory=lambda: [255] * 3)
    # loop filter
    filter_simple: int = 0
    filter_level: int = 0
    sharpness: int = 0
    lf_delta_enabled: bool = False
    lf_ref_delta: list = field(default_factory=lambda: [0] * 4)
    lf_mode_delta: list = field(default_factory=lambda: [0] * 8)
    # quant (per segment): luma_qmul, luma_dc_qmul, chroma_qmul
    qmat: list = None
    # inter
    update_golden: int = 0
    update_altref: int = 0
    update_last: int = 1
    sign_bias: list = field(default_factory=lambda: [0, 0, 0, 0])
    update_probabilities: bool = False
    mbskip_enabled: bool = False
    intra_prob: int = 0
    last_prob: int = 0
    golden_prob: int = 0


class Probs:
    """Per-frame probability set (vp8.h VP8Context.prob)."""

    def __init__(self):
        # token[ctx 0..3][coeff pos 0..15][nnz 0..2][11]
        self.token = np.zeros((4, 16, 3, 11), np.int32)
        for i in range(4):
            for j in range(16):
                self.token[i][j] = \
                    T.TOKEN_DEFAULT_PROBS[i][int(T.COEFF_BAND[j])]
        self.pred16x16 = T.PRED16_PROB_INTER.copy()
        self.pred8x8c = T.PRED8x8C_PROB_INTER.copy()
        self.mvc = T.MV_DEFAULT_PROB.copy()
        self.segmentid = np.full(3, 255, np.int32)
        self.mbskip = 0

    def copy(self):
        o = object.__new__(Probs)
        o.token = self.token.copy()
        o.pred16x16 = self.pred16x16.copy()
        o.pred8x8c = self.pred8x8c.copy()
        o.mvc = self.mvc.copy()
        o.segmentid = self.segmentid.copy()
        o.mbskip = self.mbskip
        return o


def rac_sint(c, bits):
    if not c.bit():
        return 0
    v = c.literal(bits)
    return -v if c.bit() else v


def rac_sint2(c, bits):
    """flag-less variant (update_lf_deltas style): magnitude + sign."""
    v = c.literal(bits)
    return -v if c.bit() else v


def get_quants(c, h):
    yac = c.literal(7)
    ydc_d = rac_sint(c, 4)
    y2dc_d = rac_sint(c, 4)
    y2ac_d = rac_sint(c, 4)
    uvdc_d = rac_sint(c, 4)
    uvac_d = rac_sint(c, 4)
    h.qmat = []

    def q(tab, v):
        return int(tab[max(0, min(127, v))])

    for i in range(4):
        if h.seg_enabled:
            base = h.seg_base_quant[i]
            if not h.seg_absolute:
                base += yac
        else:
            base = yac
        luma = (q(T.DC_QLOOKUP, base + ydc_d), q(T.AC_QLOOKUP, base))
        luma_dc = (q(T.DC_QLOOKUP, base + y2dc_d) * 2,
                   max(8, q(T.AC_QLOOKUP, base + y2ac_d) * 101581 >> 16))
        chroma = (min(132, q(T.DC_QLOOKUP, base + uvdc_d)),
                  q(T.AC_QLOOKUP, base + uvac_d))
        h.qmat.append({"luma": luma, "luma_dc": luma_dc,
                       "chroma": chroma})


def parse_header(data: bytes, probs_saved: Probs = None,
                 prev_header: VP8Header = None):
    """→ (VP8Header, Probs working copy, first-partition BoolDecoder,
    list of token-partition BoolDecoders)."""
    if len(data) < 3:
        raise InvalidData("vp8: short frame")
    h = VP8Header()
    tag = data[0] | (data[1] << 8) | (data[2] << 16)
    h.keyframe = not (tag & 1)
    h.profile = (tag >> 1) & 7
    h.invisible = not (tag & 0x10)
    part1_size = tag >> 5
    pos = 3
    if h.keyframe:
        if data[3:6] != b"\x9d\x01\x2a":
            raise InvalidData("vp8: bad start code")
        h.width = (data[6] | (data[7] << 8)) & 0x3FFF
        h.height = (data[8] | (data[9] << 8)) & 0x3FFF
        pos = 10
        probs = Probs()
    else:
        if prev_header is None or probs_saved is None:
            raise InvalidData("vp8: inter frame without state")
        h.width = prev_header.width
        h.height = prev_header.height
        h.lf_delta_enabled = prev_header.lf_delta_enabled
        h.lf_ref_delta = list(prev_header.lf_ref_delta)
        h.lf_mode_delta = list(prev_header.lf_mode_delta)
        h.seg_enabled = prev_header.seg_enabled
        h.seg_absolute = prev_header.seg_absolute
        h.seg_base_quant = list(prev_header.seg_base_quant)
        h.seg_filter_level = list(prev_header.seg_filter_level)
        probs = probs_saved.copy()
    if pos + part1_size > len(data):
        raise InvalidData("vp8: truncated first partition")
    c = BoolDecoder(data[pos:pos + part1_size])
    rest = data[pos + part1_size:]

    if h.keyframe:
        h.colorspace = c.bit()
        h.fullrange = c.bit()
    h.seg_enabled = bool(c.bit())
    if h.seg_enabled:
        h.seg_update_map = bool(c.bit())
        upd_feat = c.bit()
        if upd_feat:
            h.seg_absolute = bool(c.bit())
            for i in range(4):
                h.seg_base_quant[i] = rac_sint(c, 7)
            for i in range(4):
                h.seg_filter_level[i] = rac_sint(c, 6)
        if h.seg_update_map:
            for i in range(3):
                probs.segmentid[i] = c.literal(8) if c.bit() else 255
    else:
        h.seg_update_map = False
    h.filter_simple = c.bit()
    h.filter_level = c.literal(6)
    h.sharpness = c.literal(3)
    if c.bit():                           # lf_delta enabled
        h.lf_delta_enabled = True
        if c.bit():                       # update
            for i in range(4):
                if c.bit():
                    h.lf_ref_delta[i] = rac_sint2(c, 6)
            for i in range(4, 8):         # modes I4x4..SPLIT
                if c.bit():
                    h.lf_mode_delta[i] = rac_sint2(c, 6)
    else:
        h.lf_delta_enabled = False
    # token partitions
    n_parts = 1 << c.literal(2)
    sizes = rest[:3 * (n_parts - 1)]
    rest = rest[3 * (n_parts - 1):]
    parts = []
    for i in range(n_parts - 1):
        sz = sizes[3 * i] | (sizes[3 * i + 1] << 8) | \
            (sizes[3 * i + 2] << 16)
        if sz > len(rest):
            raise InvalidData("vp8: bad partition size")
        parts.append(BoolDecoder(rest[:sz]))
        rest = rest[sz:]
    parts.append(BoolDecoder(rest))
    get_quants(c, h)
    if not h.keyframe:
        # both update flags precede the optional source codes
        # (vp8.c update_refs)
        gflag = c.bit()
        aflag = c.bit()
        h.update_golden = _ref_to_update(c, 2, gflag)
        h.update_altref = _ref_to_update(c, 3, aflag)
        h.sign_bias[2] = c.bit()
        h.sign_bias[3] = c.bit()
    h.update_probabilities = bool(c.bit())
    # snapshot for restore at frame end (vp8.c:846 prob[1] = prob[0])
    snapshot = None if h.update_probabilities else probs.copy()
    h.update_last = h.keyframe or c.bit()
    # token probability updates
    for i in range(4):
        for j in range(8):
            for k in range(3):
                for tk in range(11):
                    if c.get(int(T.TOKEN_UPDATE_PROBS[i][j][k][tk])):
                        p = c.literal(8)
                        for pos_ in T.COEFF_BAND_INDEXES[j]:
                            if pos_ < 0:
                                break
                            probs.token[i][pos_][k][tk] = p
    h.mbskip_enabled = bool(c.bit())
    if h.mbskip_enabled:
        probs.mbskip = c.literal(8)
    if not h.keyframe:
        h.intra_prob = c.literal(8)
        h.last_prob = c.literal(8)
        h.golden_prob = c.literal(8)
        if c.bit():
            for i in range(4):
                probs.pred16x16[i] = c.literal(8)
        if c.bit():
            for i in range(3):
                probs.pred8x8c[i] = c.literal(8)
        for i in range(2):
            for j in range(19):
                if c.get(int(T.MV_UPDATE_PROB[i][j])):
                    v = c.literal(7) << 1
                    probs.mvc[i][j] = v + (not v)
    return h, probs, snapshot, c, parts


def _ref_to_update(c, ref, flag):
    """vp8.c ref_to_update: → 0 none, 1 previous, 2/3 golden/altref
    cross-copy, 4 current."""
    if flag:
        return 4                          # current frame
    v = c.literal(2)
    if v == 1:
        return 1
    if v == 2:
        return 5 - ref                    # the other one (2<->3)
    return 0
