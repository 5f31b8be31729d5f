"""VP9 frame headers: uncompressed (plain bits, spec §6.2/§7.2;
reference: libavcodec/vp9.c decode_frame_header) and the bool-coded
compressed header (tx mode + forward probability updates, including
the inter-frame mode/filter/ref/MV tables). Profile-0 8-bit scope;
segmentation and scaled references are rejected.

The port's copy of ffmpeg_tpu/codecs/vp9/header.py, held equal to it by
tests/test_torch_host_copies.py."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ...utils.error import InvalidData, NotSupported
from ..h264.bits import Bits
from . import tables_gen as T
from .bool import BoolDecoder

SYNCCODE = 0x498342
TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_SWITCHABLE = 0, 1, 2, 3, 4


@dataclass
class VP9Header:
    profile: int = 0
    keyframe: bool = True
    show_frame: bool = True
    errorres: bool = False
    intraonly: bool = False
    show_existing: int = -1               # ref slot to re-show, or -1
    resetctx: int = 0
    refreshrefmask: int = 0xFF
    refidx: list = field(default_factory=lambda: [0, 0, 0])
    signbias: list = field(default_factory=lambda: [0, 0, 0])
    highprecisionmvs: bool = False
    filtermode: int = 4                   # FILTER_SWITCHABLE
    allowcompinter: bool = False
    fixcompref: int = 0
    varcompref: list = field(default_factory=lambda: [0, 0])
    comppredmode: int = 0                 # PRED_SINGLEREF
    use_last_frame_mvs: bool = False
    width: int = 0
    height: int = 0
    refreshctx: bool = True
    parallelmode: bool = False
    framectxid: int = 0
    filter_level: int = 0
    sharpness: int = 0
    lf_delta_enabled: bool = False
    lf_ref_delta: list = field(default_factory=lambda: [1, 0, -1, -1])
    lf_mode_delta: list = field(default_factory=lambda: [0, 0])
    yac_qi: int = 0
    ydc_qdelta: int = 0
    uvdc_qdelta: int = 0
    uvac_qdelta: int = 0
    lossless: bool = False
    log2_tile_cols: int = 0
    log2_tile_rows: int = 0
    compressed_size: int = 0
    txfmmode: int = TX_SWITCHABLE
    uncompressed_bits: int = 0            # bit length of part 1
    # derived quantizers
    qmul: tuple = ((0, 0), (0, 0))
    # per-(ref, mode!=zero) loop filter levels (4, 2)
    lflvl_mat: object = None
    lflvl: int = 0


def _sbits_inv(b: Bits, n: int) -> int:
    v = b.get(n)
    return -v if b.get1() else v


def parse_uncompressed(data: bytes, last_invisible=False,
                       lf_deltas=None, ref_dims=None) -> VP9Header:
    """ref_dims: per-slot (w, h) of the 8 reference frames (inter);
    lf_deltas: carried-over (ref_delta, mode_delta) lists."""
    b = Bits(data)
    h = VP9Header()
    if lf_deltas is not None:
        h.lf_ref_delta = list(lf_deltas[0])
        h.lf_mode_delta = list(lf_deltas[1])
    if b.get(2) != 2:
        raise InvalidData("vp9: bad frame marker")
    h.profile = b.get1() | (b.get1() << 1)
    if h.profile == 3:
        h.profile += b.get1()
    if h.profile != 0:
        raise NotSupported(f"vp9: profile {h.profile}")
    if b.get1():                          # show_existing_frame
        h.show_existing = b.get(3)
        return h
    h.keyframe = not b.get1()
    h.show_frame = bool(b.get1())
    h.errorres = bool(b.get1())
    h.use_last_frame_mvs = not h.errorres and not last_invisible
    if h.keyframe:
        if b.get(24) != SYNCCODE:
            raise InvalidData("vp9: bad sync code")
        cs = b.get(3)                     # color_space
        if cs == 7:
            raise NotSupported("vp9: sRGB")
        b.get1()                          # color_range
        h.refreshrefmask = 0xFF
        h.width = b.get(16) + 1
        h.height = b.get(16) + 1
        if b.get1():                      # render size
            b.get(32)
    else:
        h.intraonly = bool(b.get1()) if not h.show_frame else False
        h.resetctx = 0 if h.errorres else b.get(2)
        if h.intraonly:
            if b.get(24) != SYNCCODE:
                raise InvalidData("vp9: bad sync code")
            h.refreshrefmask = b.get(8)
            h.width = b.get(16) + 1
            h.height = b.get(16) + 1
            if b.get1():
                b.get(32)
        else:
            h.refreshrefmask = b.get(8)
            for i in range(3):
                h.refidx[i] = b.get(3)
                h.signbias[i] = b.get1() if not h.errorres else \
                    (b.get1() and 0)
            if ref_dims is None or any(
                    ref_dims[h.refidx[i]] is None for i in range(3)):
                raise InvalidData("vp9: reference not available")
            if b.get1():
                h.width, h.height = ref_dims[h.refidx[0]]
            elif b.get1():
                h.width, h.height = ref_dims[h.refidx[1]]
            elif b.get1():
                h.width, h.height = ref_dims[h.refidx[2]]
            else:
                h.width = b.get(16) + 1
                h.height = b.get(16) + 1
            for i in range(3):
                if ref_dims[h.refidx[i]] != (h.width, h.height):
                    raise NotSupported("vp9: scaled reference")
            if b.get1():                  # display size
                b.get(32)
            h.highprecisionmvs = bool(b.get1())
            h.filtermode = 4 if b.get1() else b.get(2)
            h.allowcompinter = (
                h.signbias[0] != h.signbias[1] or
                h.signbias[0] != h.signbias[2])
            if h.allowcompinter:
                if h.signbias[0] == h.signbias[1]:
                    h.fixcompref = 2
                    h.varcompref = [0, 1]
                elif h.signbias[0] == h.signbias[2]:
                    h.fixcompref = 1
                    h.varcompref = [0, 2]
                else:
                    h.fixcompref = 0
                    h.varcompref = [1, 2]
    h.refreshctx = not h.errorres and bool(b.get1())
    if h.errorres:
        h.refreshctx = False
        h.parallelmode = True
    else:
        h.parallelmode = bool(b.get1())
    h.framectxid = b.get(2)
    if h.keyframe or h.intraonly:
        h.framectxid = 0                  # libvpx ignores it here
    # loop filter (deltas reset on key/errorres/intraonly)
    if h.keyframe or h.errorres or h.intraonly:
        h.lf_ref_delta = [1, 0, -1, -1]
        h.lf_mode_delta = [0, 0]
    h.filter_level = b.get(6)
    h.sharpness = b.get(3)
    if b.get1():                          # lf delta enabled
        h.lf_delta_enabled = True
        if b.get1():                      # update
            for i in range(4):
                if b.get1():
                    h.lf_ref_delta[i] = _sbits_inv(b, 6)
            for i in range(2):
                if b.get1():
                    h.lf_mode_delta[i] = _sbits_inv(b, 6)
    # quantization
    h.yac_qi = b.get(8)
    h.ydc_qdelta = _sbits_inv(b, 4) if b.get1() else 0
    h.uvdc_qdelta = _sbits_inv(b, 4) if b.get1() else 0
    h.uvac_qdelta = _sbits_inv(b, 4) if b.get1() else 0
    h.lossless = (h.yac_qi == 0 and h.ydc_qdelta == 0 and
                  h.uvdc_qdelta == 0 and h.uvac_qdelta == 0)
    if h.lossless:
        raise NotSupported("vp9: lossless (WHT)")
    if b.get1():                          # segmentation enabled
        raise NotSupported("vp9: segmentation")
    # tiling
    sb_cols = (h.width + 63) >> 6
    min_log2 = 0
    while sb_cols > (64 << min_log2):
        min_log2 += 1
    max_log2 = 0
    while (sb_cols >> max_log2) >= 4:
        max_log2 += 1
    max_log2 = max(0, max_log2 - 1)
    h.log2_tile_cols = min_log2
    while max_log2 > h.log2_tile_cols:
        if b.get1():
            h.log2_tile_cols += 1
        else:
            break
    h.log2_tile_rows = b.get1()
    if h.log2_tile_rows:
        h.log2_tile_rows += b.get1()
    h.compressed_size = b.get(16)
    if not h.compressed_size:
        raise InvalidData("vp9: empty compressed header")
    h.uncompressed_bits = b.pos
    # derived quantizer multipliers (bpp 8)
    qydc = max(0, min(255, h.yac_qi + h.ydc_qdelta))
    quvdc = max(0, min(255, h.yac_qi + h.uvdc_qdelta))
    quvac = max(0, min(255, h.yac_qi + h.uvac_qdelta))
    h.qmul = ((int(T.DC_QLOOKUP[0][qydc]), int(T.AC_QLOOKUP[0][h.yac_qi])),
              (int(T.DC_QLOOKUP[0][quvdc]), int(T.AC_QLOOKUP[0][quvac])))
    h.lflvl = h.filter_level
    # per-(ref+1, mode!=zero) filter levels (vp9.c:782)
    lvl = h.filter_level
    mat = np.full((4, 2), lvl, np.int32)
    if h.lf_delta_enabled:
        sh = int(lvl >= 32)
        mat[0, 0] = mat[0, 1] = np.clip(
            lvl + (h.lf_ref_delta[0] << sh), 0, 63)
        for j in range(1, 4):
            for m in range(2):
                mat[j, m] = np.clip(
                    lvl + ((h.lf_ref_delta[j] +
                            h.lf_mode_delta[m]) << sh), 0, 63)
    h.lflvl_mat = mat
    return h


INV_MAP_TABLE = [
    7, 20, 33, 46, 59, 72, 85, 98, 111, 124, 137, 150, 163, 176,
    189, 202, 215, 228, 241, 254, 1, 2, 3, 4, 5, 6, 8, 9,
    10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 21, 22, 23, 24,
    25, 26, 27, 28, 29, 30, 31, 32, 34, 35, 36, 37, 38, 39,
    40, 41, 42, 43, 44, 45, 47, 48, 49, 50, 51, 52, 53, 54,
    55, 56, 57, 58, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69,
    70, 71, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 83, 84,
    86, 87, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97, 99, 100,
    101, 102, 103, 104, 105, 106, 107, 108, 109, 110, 112, 113, 114,
    115, 116, 117, 118, 119, 120, 121, 122, 123, 125, 126, 127, 128,
    129, 130, 131, 132, 133, 134, 135, 136, 138, 139, 140, 141, 142,
    143, 144, 145, 146, 147, 148, 149, 151, 152, 153, 154, 155, 156,
    157, 158, 159, 160, 161, 162, 164, 165, 166, 167, 168, 169, 170,
    171, 172, 173, 174, 175, 177, 178, 179, 180, 181, 182, 183, 184,
    185, 186, 187, 188, 190, 191, 192, 193, 194, 195, 196, 197, 198,
    199, 200, 201, 203, 204, 205, 206, 207, 208, 209, 210, 211, 212,
    213, 214, 216, 217, 218, 219, 220, 221, 222, 223, 224, 225, 226,
    227, 229, 230, 231, 232, 233, 234, 235, 236, 237, 238, 239, 240,
    242, 243, 244, 245, 246, 247, 248, 249, 250, 251, 252, 253, 253,
]


def _inv_recenter_nonneg(v, m):
    if v > 2 * m:
        return v
    if v & 1:
        return m - ((v + 1) >> 1)
    return m + (v >> 1)


def update_prob(c: BoolDecoder, p: int) -> int:
    """Differential probability update (vp9.c update_prob)."""
    if not c.bit():
        d = c.literal(4)
    elif not c.bit():
        d = c.literal(4) + 16
    elif not c.bit():
        d = c.literal(5) + 32
    else:
        d = c.literal(7)
        if d >= 65:
            d = (d << 1) - 65 + c.bit()
        d += 64
    if p <= 128:
        return 1 + _inv_recenter_nonneg(INV_MAP_TABLE[d], p - 1)
    return 255 - _inv_recenter_nonneg(INV_MAP_TABLE[d], 255 - p)


class ProbContext:
    """One saved frame context (vp9dec.h prob_ctx): all mode/MV probs
    plus the 3-term coefficient model."""

    FIELDS = [("y_mode", "DEFAULT_YMODE"), ("uv_mode", "DEFAULT_UVMODE"),
              ("filter", "DEFAULT_FILTER"), ("mv_mode", "DEFAULT_MVMODE"),
              ("intra", "DEFAULT_INTRA"), ("comp", "DEFAULT_COMP"),
              ("single_ref", "DEFAULT_SINGLEREF"),
              ("comp_ref", "DEFAULT_COMPREF"),
              ("tx32p", "DEFAULT_TX32P"), ("tx16p", "DEFAULT_TX16P"),
              ("tx8p", "DEFAULT_TX8P"), ("skip", "DEFAULT_SKIP"),
              ("mv_joint", "DEFAULT_MVJOINT"),
              ("mv_comp", "DEFAULT_MVCOMP"),
              ("partition", "DEFAULT_PARTITION")]

    def __init__(self):
        for name, src in self.FIELDS:
            setattr(self, name, getattr(T, src).copy())
        self.coef3 = T.DEFAULT_COEF_PROBS.copy()  # (4,2,2,6,6,3)

    def copy(self):
        o = object.__new__(type(self))
        for name, _ in self.FIELDS:
            setattr(o, name, getattr(self, name).copy())
        o.coef3 = self.coef3.copy()
        if hasattr(self, "coef"):
            o.coef = self.coef.copy()
        return o


class FrameProbs(ProbContext):
    """Working per-frame probabilities: a context copy with the
    model-expanded 11-term coefficient probs."""

    def __init__(self, ctx=None):
        if ctx is None:
            super().__init__()
        else:
            for name, _ in self.FIELDS:
                setattr(self, name, getattr(ctx, name).copy())
            self.coef3 = ctx.coef3.copy()
        self.coef = np.zeros((4, 2, 2, 6, 6, 11), np.int32)

    def expand(self, tx, j, k, l, m, p3):
        self.coef3[tx, j, k, l, m] = p3
        self.coef[tx, j, k, l, m, :3] = p3
        self.coef[tx, j, k, l, m, 3:] = T.MODEL_PARETO8[p3[2]]


def _mv_prob_upd(c, arr, idx):
    if c.get(252):
        arr[idx] = (c.literal(7) << 1) | 1


def parse_compressed(h: VP9Header, data: bytes,
                     ctx: ProbContext = None) -> FrameProbs:
    """Compressed header (vp9.c:930ff): forward updates applied to a
    working copy of the saved context `ctx` (defaults when None)."""
    c = BoolDecoder(data)
    if c.get(128):
        raise InvalidData("vp9: bad compressed-header marker bit")
    probs = FrameProbs(ctx)
    h.txfmmode = c.literal(2)
    if h.txfmmode == 3:
        h.txfmmode += c.bit()
    if h.txfmmode == TX_SWITCHABLE:
        for i in range(2):
            if c.get(252):
                probs.tx8p[i] = update_prob(c, int(probs.tx8p[i]))
        for i in range(2):
            for j in range(2):
                if c.get(252):
                    probs.tx16p[i][j] = update_prob(
                        c, int(probs.tx16p[i][j]))
        for i in range(2):
            for j in range(3):
                if c.get(252):
                    probs.tx32p[i][j] = update_prob(
                        c, int(probs.tx32p[i][j]))
    # coefficient probabilities
    ref_coef = ctx.coef3 if ctx is not None else T.DEFAULT_COEF_PROBS
    for tx in range(4):
        upd = c.bit()
        for j in range(2):
            for k in range(2):
                for l in range(6):
                    for m in range(6):
                        if l == 0 and m >= 3:
                            break
                        ref = ref_coef[tx, j, k, l, m]
                        p3 = list(int(v) for v in ref)
                        if upd:
                            for n in range(3):
                                if c.get(252):
                                    p3[n] = update_prob(c, p3[n])
                        probs.expand(tx, j, k, l, m, p3)
        if h.txfmmode == tx:
            break
    for i in range(3):
        if c.get(252):
            probs.skip[i] = update_prob(c, int(probs.skip[i]))
    if h.keyframe or h.intraonly:
        return probs

    # inter-frame forward updates
    for i in range(7):
        for j in range(3):
            if c.get(252):
                probs.mv_mode[i][j] = update_prob(
                    c, int(probs.mv_mode[i][j]))
    if h.filtermode == 4:                 # FILTER_SWITCHABLE
        for i in range(4):
            for j in range(2):
                if c.get(252):
                    probs.filter[i][j] = update_prob(
                        c, int(probs.filter[i][j]))
    for i in range(4):
        if c.get(252):
            probs.intra[i] = update_prob(c, int(probs.intra[i]))
    if h.allowcompinter:
        h.comppredmode = c.bit()
        if h.comppredmode:
            h.comppredmode += c.bit()
        if h.comppredmode == 2:           # PRED_SWITCHABLE
            for i in range(5):
                if c.get(252):
                    probs.comp[i] = update_prob(c, int(probs.comp[i]))
    else:
        h.comppredmode = 0                # PRED_SINGLEREF
    if h.comppredmode != 1:               # != PRED_COMPREF
        for i in range(5):
            for j in range(2):
                if c.get(252):
                    probs.single_ref[i][j] = update_prob(
                        c, int(probs.single_ref[i][j]))
    if h.comppredmode != 0:               # != PRED_SINGLEREF
        for i in range(5):
            if c.get(252):
                probs.comp_ref[i] = update_prob(
                    c, int(probs.comp_ref[i]))
    for i in range(4):
        for j in range(9):
            if c.get(252):
                probs.y_mode[i][j] = update_prob(
                    c, int(probs.y_mode[i][j]))
    for i in range(4):
        for j in range(4):
            for k in range(3):
                if c.get(252):
                    probs.partition[3 - i][j][k] = update_prob(
                        c, int(probs.partition[3 - i][j][k]))
    # MV probabilities use the literal (v<<1)|1 update form
    for i in range(3):
        _mv_prob_upd(c, probs.mv_joint, i)
    for i in range(2):
        mc = probs.mv_comp[i]
        _mv_prob_upd(c, mc, 0)            # sign
        for j in range(10):
            _mv_prob_upd(c, mc, 1 + j)    # classes
        _mv_prob_upd(c, mc, 11)           # class0
        for j in range(10):
            _mv_prob_upd(c, mc, 12 + j)   # bits
    for i in range(2):
        mc = probs.mv_comp[i]
        for j in range(2):
            for k in range(3):
                _mv_prob_upd(c, mc, 22 + 3 * j + k)  # class0_fp
        for j in range(3):
            _mv_prob_upd(c, mc, 28 + j)   # fp
    if h.highprecisionmvs:
        for i in range(2):
            mc = probs.mv_comp[i]
            _mv_prob_upd(c, mc, 31)       # class0_hp
            _mv_prob_upd(c, mc, 32)       # hp
    return probs
