"""VP9 superblock walker: partitions, keyframe intra modes, tx size,
skip flags, coefficient tokens and inline reconstruction (VP9 spec §8;
reference: libavcodec/vp9.c decode_sb, vp9block.c decode_mode /
decode_coeffs, vp9recon.c intra_recon). One walker serves decode
(BoolDecoder) and encode (BoolEncoder + Plan) for crafted-stream
differential tests, the strategy proven on H.264/HEVC.

The port's copy of ffmpeg_tpu/codecs/vp9/block.py, held equal to it by
tests/test_torch_host_copies.py."""

from __future__ import annotations

import numpy as np

from ...utils.error import InvalidData, NotSupported
from . import intra as IP
from . import itxfm as TX
from . import tables_gen as T

# block sizes (ffmpeg vp9shared.h enum BlockSize order)
BS_64x64, BS_64x32, BS_32x64, BS_32x32, BS_32x16, BS_16x32, \
    BS_16x16, BS_16x8, BS_8x16, BS_8x8, BS_8x4, BS_4x8, BS_4x4 = range(13)

PARTITION_NONE, PARTITION_H, PARTITION_V, PARTITION_SPLIT = range(4)

TX_4X4, TX_8X8, TX_16X16, TX_32X32 = range(4)

DC_PRED = 2                               # intra.py mode numbering

# per-bs max tx and ctx-update values (vp9block.c decode_mode statics)
MAX_TX_FOR_BS = [TX_32X32, TX_32X32, TX_32X32, TX_32X32, TX_16X16,
                 TX_16X16, TX_16X16, TX_8X8, TX_8X8, TX_8X8, TX_4X4,
                 TX_4X4, TX_4X4]
LEFT_CTX = [0x0, 0x8, 0x0, 0x8, 0xC, 0x8, 0xC, 0xE, 0xC, 0xE, 0xF,
            0xE, 0xF]
ABOVE_CTX = [0x0, 0x0, 0x8, 0x8, 0x8, 0xC, 0xC, 0xC, 0xE, 0xE, 0xE,
             0xF, 0xF]

# scan/neighbour tables per (tx, txtp); 32x32 only has the default
_SCANS = {
    (0, 0): (T.SCAN_4X4_DEF, T.NB_4X4_DEF),
    (0, 1): (T.SCAN_4X4_COL, T.NB_4X4_COL),
    (0, 2): (T.SCAN_4X4_ROW, T.NB_4X4_ROW),
    (0, 3): (T.SCAN_4X4_DEF, T.NB_4X4_DEF),
    (1, 0): (T.SCAN_8X8_DEF, T.NB_8X8_DEF),
    (1, 1): (T.SCAN_8X8_COL, T.NB_8X8_COL),
    (1, 2): (T.SCAN_8X8_ROW, T.NB_8X8_ROW),
    (1, 3): (T.SCAN_8X8_DEF, T.NB_8X8_DEF),
    (2, 0): (T.SCAN_16X16_DEF, T.NB_16X16_DEF),
    (2, 1): (T.SCAN_16X16_COL, T.NB_16X16_COL),
    (2, 2): (T.SCAN_16X16_ROW, T.NB_16X16_ROW),
    (2, 3): (T.SCAN_16X16_DEF, T.NB_16X16_DEF),
    (3, 0): (T.SCAN_32X32_DEF, T.NB_32X32_DEF),
    (3, 1): (T.SCAN_32X32_DEF, T.NB_32X32_DEF),
    (3, 2): (T.SCAN_32X32_DEF, T.NB_32X32_DEF),
    (3, 3): (T.SCAN_32X32_DEF, T.NB_32X32_DEF),
}

BAND_COUNTS = (
    (1, 2, 3, 4, 3, 16 - 13),
    (1, 2, 3, 4, 11, 64 - 21),
    (1, 2, 3, 4, 11, 256 - 21),
    (1, 2, 3, 4, 11, 1024 - 21),
)

# mode -> TxfmType for luma <32x32 (vp9data.c intra_txfm_type);
# inter modes (10-13) always use DCT_DCT
INTRA_TXFM_TYPE = [TX.ADST_DCT, TX.DCT_ADST, TX.DCT_DCT, TX.DCT_DCT,
                   TX.ADST_ADST, TX.ADST_DCT, TX.DCT_ADST, TX.ADST_DCT,
                   TX.DCT_ADST, TX.ADST_ADST,
                   TX.DCT_DCT, TX.DCT_DCT, TX.DCT_DCT, TX.DCT_DCT]

NEARESTMV, NEARMV, ZEROMV, NEWMV = 10, 11, 12, 13

# inter-mode context from (above, left) mode ctx (vp9block.c:316)
INTER_MODE_CTX_LUT = np.array(
    [[6] * 10 + [5, 5, 5, 5]] * 10 +
    [[5] * 10 + [2, 2, 1, 3],
     [5] * 10 + [2, 2, 1, 3],
     [5] * 10 + [1, 1, 0, 3],
     [5] * 10 + [3, 3, 3, 4]], np.int32)

# sub-8x8 mode-ctx MI offset per bs (vp9block.c:583 off[])
INTER_MODE_CTX_OFF = [3, 0, 0, 1, 0, 0, 0, 0, 0, 0]

# y_mode prob row for sub-8x8-capable sizes (vp9block.c size_group)
SIZE_GROUP = [3, 3, 3, 3, 2, 2, 2, 1, 1, 1]

# filter tree index -> FilterMode (vp9data.c ff_vp9_filter_lut):
# SMOOTH=0, REGULAR=1, SHARP=2, BILINEAR=3
FILTER_LUT = [1, 0, 2]


class BIO:
    """Symmetric bool-coder front: decode reads, encode writes the
    plan-supplied value and returns it."""

    def __init__(self, core, encode=False):
        self.core = core
        self.encode = encode

    def b(self, prob, v=None):
        if self.encode:
            self.core.put(v, prob)
            return v
        return self.core.get(prob)

    def bit(self, v=None):
        return self.b(128, v)

    def tree(self, tree, probs, v=None):
        if self.encode:
            self.core.tree(tree, probs, v)
            return v
        i = 0
        while True:
            i = tree[i][self.core.get(probs[i])]
            if i <= 0:
                return -i


def new_counts():
    """Per-frame symbol counters for backward adaptation
    (vp9dec.h struct VP9TileData.counts)."""
    z = np.zeros
    return {
        "eob": z((4, 2, 2, 6, 6, 2), np.int64),
        "coef": z((4, 2, 2, 6, 6, 3), np.int64),
        "skip": z((3, 2), np.int64),
        "intra": z((4, 2), np.int64),
        "comp": z((5, 2), np.int64),
        "comp_ref": z((5, 2), np.int64),
        "single_ref": z((5, 2, 2), np.int64),
        "partition": z((4, 4, 4), np.int64),
        "tx32p": z((2, 4), np.int64),
        "tx16p": z((2, 3), np.int64),
        "tx8p": z((2, 2), np.int64),
        "filter": z((4, 3), np.int64),
        "mv_mode": z((7, 4), np.int64),
        "mv_joint": z(4, np.int64),
        "y_mode": z((4, 10), np.int64),
        "uv_mode": z((10, 10), np.int64),
        "mv_comp": {
            "sign": z((2, 2), np.int64),
            "classes": z((2, 11), np.int64),
            "class0": z((2, 2), np.int64),
            "bits": z((2, 10, 2), np.int64),
            "class0_fp": z((2, 2, 4), np.int64),
            "fp": z((2, 4), np.int64),
            "class0_hp": z((2, 2), np.int64),
            "hp": z((2, 2), np.int64),
        },
    }


class FrameState:
    """Whole-frame decode/encode state for one frame. For inter
    frames, `refs` holds the three active reference planes
    (y, u, v, width, height) selected by h.refidx, and
    prev_mv_ref/prev_mv_xy the previous frame's MV grid
    (REF_FRAME_MVPAIR analog)."""

    def __init__(self, h, probs, refs=None, prev_mv=None):
        self.h = h
        self.probs = probs
        self.refs = refs or []
        self.cols = (h.width + 7) >> 3    # MI units (8px)
        self.rows = (h.height + 7) >> 3
        self.sb_cols = (h.width + 63) >> 6
        self.sb_rows = (h.height + 63) >> 6
        wp, hp = self.sb_cols * 64, self.sb_rows * 64
        self.y = np.zeros((hp, wp), np.uint8)
        self.u = np.zeros((hp >> 1, wp >> 1), np.uint8)
        self.v = np.zeros((hp >> 1, wp >> 1), np.uint8)
        c = self.sb_cols * 8
        self.above_partition = np.zeros(c, np.int32)
        self.above_skip = np.zeros(c, np.int32)
        self.above_txfm = np.zeros(c, np.int32)
        self.above_mode = np.full(2 * c, DC_PRED, np.int32)
        self.above_y_nnz = np.zeros(2 * c, np.int32)
        self.above_uv_nnz = [np.zeros(c, np.int32),
                             np.zeros(c, np.int32)]
        # inter-frame contexts (8px granularity; above_mode8 mirrors
        # the reference's mode ctx reuse at MI granularity)
        self.above_intra = np.zeros(c, np.int32)
        self.above_comp = np.zeros(c, np.int32)
        self.above_ref = np.zeros(c, np.int32)
        self.above_filter = np.zeros(c, np.int32)
        # inter frames seed the mode ctx with NEARESTMV (vp9.c:1724)
        self._mode0 = DC_PRED if (h.keyframe or h.intraonly) else 10
        self.above_mode8 = np.full(c, self._mode0, np.int32)
        self.above_mv_ctx = np.zeros((2 * c, 2, 2), np.int32)
        # whole-frame MV grid (VP9mvrefPair): slot-relative ref ids
        # (-1 = intra) + the block's b->mv[3] pair
        r = self.sb_rows * 8
        self.mv_ref = np.full((r, c, 2), -1, np.int32)
        self.mv_xy = np.zeros((r, c, 2, 2), np.int32)
        if prev_mv is not None:
            self.prev_mv_ref, self.prev_mv_xy = prev_mv
        else:
            self.prev_mv_ref = np.full((r, c, 2), -1, np.int32)
            self.prev_mv_xy = np.zeros((r, c, 2, 2), np.int32)
        self.counts = new_counts()
        self.recorder = None              # set for device recon
        # loop filter inputs
        self.lf_lvl = np.zeros((self.rows, self.cols), np.int32)
        r4 = self.sb_rows * 16
        c4 = self.sb_cols * 16
        self.wd_v = np.zeros((r4, c4), np.int32)     # luma, 4px grid
        self.wd_h = np.zeros((r4, c4), np.int32)
        self.wd_v_uv = np.zeros((r4 >> 1, c4 >> 1), np.int32)
        self.wd_h_uv = np.zeros((r4 >> 1, c4 >> 1), np.int32)

    def new_tile_left(self):
        self.left_partition = np.zeros(8, np.int32)
        self.left_skip = np.zeros(8, np.int32)
        self.left_txfm = np.zeros(8, np.int32)
        self.left_mode = np.full(16, DC_PRED, np.int32)
        self.left_y_nnz = np.zeros(16, np.int32)
        self.left_uv_nnz = [np.zeros(8, np.int32),
                            np.zeros(8, np.int32)]
        self.left_intra = np.zeros(8, np.int32)
        self.left_comp = np.zeros(8, np.int32)
        self.left_ref = np.zeros(8, np.int32)
        self.left_filter = np.zeros(8, np.int32)
        # 16 entries: the sub-8x8 mode-ctx offset can read up to
        # left_mode8[row7 + 3], which sees the per-row reset
        # (vp9dec.h left_mode_ctx[16]; NEARESTMV seed on inter frames)
        self.left_mode8 = np.full(16, self._mode0, np.int32)
        self.left_mv_ctx = np.zeros((16, 2, 2), np.int32)


class TileWalker:
    def __init__(self, fs: FrameState, core, encode=False, plan=None,
                 tile_col_start=0, tile_col_end=None):
        self.fs = fs
        self.io = BIO(core, encode)
        self.plan = plan
        self.tile_col_start = tile_col_start  # MI units
        self.tile_col_end = tile_col_end if tile_col_end is not None \
            else fs.cols

    # -- superblock recursion (vp9.c decode_sb) ------------------------
    def decode_sb(self, row, col, bl):
        fs, io = self.fs, self.io
        ctx = ((int(fs.above_partition[col]) >> (3 - bl)) & 1) | \
            (((int(self.fs.left_partition[row & 7]) >> (3 - bl)) & 1)
             << 1)
        h = fs.h
        if h.keyframe or h.intraonly:
            p = T.KF_PARTITION_PROBS[bl][ctx]
        else:
            p = fs.probs.partition[bl][ctx]
        hbs = 4 >> bl
        bp = None
        if bl == 3:                       # BL_8X8
            bp = self._partition(row, col, bl, p, (0, 1, 2, 3))
            self.decode_block(row, col, bl, bp)
        elif col + hbs < fs.cols:
            if row + hbs < fs.rows:
                bp = self._partition(row, col, bl, p, (0, 1, 2, 3))
                if bp == PARTITION_NONE:
                    self.decode_block(row, col, bl, bp)
                elif bp == PARTITION_H:
                    self.decode_block(row, col, bl, bp)
                    self.decode_block(row + hbs, col, bl, bp)
                elif bp == PARTITION_V:
                    self.decode_block(row, col, bl, bp)
                    self.decode_block(row, col + hbs, bl, bp)
                else:
                    self.decode_sb(row, col, bl + 1)
                    self.decode_sb(row, col + hbs, bl + 1)
                    self.decode_sb(row + hbs, col, bl + 1)
                    self.decode_sb(row + hbs, col + hbs, bl + 1)
            else:
                v = None
                if io.encode:
                    v = 1 if self.plan.partition(row, col, bl,
                                                 (1, 3)) == 3 else 0
                if io.b(int(p[1]), v):
                    bp = PARTITION_SPLIT
                    self.decode_sb(row, col, bl + 1)
                    self.decode_sb(row, col + hbs, bl + 1)
                else:
                    bp = PARTITION_H
                    self.decode_block(row, col, bl, PARTITION_H)
        elif row + hbs < fs.rows:
            v = None
            if io.encode:
                v = 1 if self.plan.partition(row, col, bl,
                                             (2, 3)) == 3 else 0
            if io.b(int(p[2]), v):
                bp = PARTITION_SPLIT
                self.decode_sb(row, col, bl + 1)
                self.decode_sb(row + hbs, col, bl + 1)
            else:
                bp = PARTITION_V
                self.decode_block(row, col, bl, PARTITION_V)
        else:
            bp = PARTITION_SPLIT
            self.decode_sb(row, col, bl + 1)
        fs.counts["partition"][bl][ctx][bp] += 1

    def _partition(self, row, col, bl, p, allowed):
        v = None
        if self.io.encode:
            v = self.plan.partition(row, col, bl, allowed)
        return self.io.tree(T.PARTITION_TREE, p, v)

    # -- one block (vp9block.c decode_mode + coeffs + recon) -----------
    def decode_block(self, row, col, bl, bp):
        fs, io = self.fs, self.io
        h = fs.h
        cnt = fs.counts
        bs = bl * 3 + bp
        w4 = int(T.BWH_TAB[1][bs][0])     # MI units
        h4 = int(T.BWH_TAB[1][bs][1])
        w4c = min(fs.cols - col, w4)      # picture-clamped
        h4c = min(fs.rows - row, h4)
        row7 = row & 7
        have_a = row > 0
        have_l = col > self.tile_col_start
        max_tx = MAX_TX_FOR_BS[bs]
        is_key = h.keyframe or h.intraonly
        self.row, self.col = row, col
        self.min_mv = (-(128 + col * 64), -(128 + row * 64))
        self.max_mv = (128 + (fs.cols - col - w4) * 64,
                       128 + (fs.rows - row - h4) * 64)
        self.b = b = {"bs": bs, "comp": 0, "ref": [0, 0],
                      "mv": [[(0, 0), (0, 0)] for _ in range(4)]}

        # skip flag
        c = int(self.fs.left_skip[row7]) + int(fs.above_skip[col])
        v = None
        if io.encode:
            v = 1 if self.plan.skip(row, col, bs) else 0
        skip = io.b(int(fs.probs.skip[c]), v)
        cnt["skip"][c][skip] += 1

        # intra/inter flag
        if is_key:
            intra = 1
        else:
            if have_a:
                if have_l:
                    c = int(fs.above_intra[col]) + \
                        int(self.fs.left_intra[row7])
                    c += int(c == 2)
                else:
                    c = 2 * int(fs.above_intra[col])
            elif have_l:
                c = 2 * int(self.fs.left_intra[row7])
            else:
                c = 0
            v = None
            if io.encode:
                v = 0 if self.plan.is_inter(row, col, bs) else 1
            bit = io.b(int(fs.probs.intra[c]), 1 - v if io.encode
                       else None)
            cnt["intra"][c][bit] += 1
            intra = 1 - bit
        b["intra"] = intra

        # tx size
        if (intra or not skip) and h.txfmmode == 4:  # TX_SWITCHABLE
            if have_a:
                a_tx = max_tx if fs.above_skip[col] else \
                    int(fs.above_txfm[col])
                if have_l:
                    l_tx = max_tx if self.fs.left_skip[row7] else \
                        int(self.fs.left_txfm[row7])
                    c = int(a_tx + l_tx > max_tx)
                else:
                    c = 1 if fs.above_skip[col] else \
                        int(int(fs.above_txfm[col]) * 2 > max_tx)
            elif have_l:
                c = 1 if self.fs.left_skip[row7] else \
                    int(int(self.fs.left_txfm[row7]) * 2 > max_tx)
            else:
                c = 1
            want = None
            if io.encode:
                want = self.plan.tx(row, col, max_tx)
            tx = self._tx_size(max_tx, c, want)
        else:
            tx = min(max_tx, h.txfmmode)
        b["tx"] = tx

        modes = [0, 0, 0, 0]
        uvmode = 0
        filter_id = 0
        if is_key:
            # keyframe intra (above/left mode ctx at 4px granularity)
            a = fs.above_mode[col * 2:col * 2 + 2]
            l = self.fs.left_mode[row7 * 2:row7 * 2 + 2]
            if bs > BS_8x8:               # sub-8x8: up to 4 modes
                modes[0] = a[0] = self._ymode(int(a[0]), int(l[0]),
                                              row, col, 0)
                if bs != BS_8x4:
                    modes[1] = self._ymode(int(a[1]), modes[0],
                                           row, col, 1)
                    l[0] = a[1] = modes[1]
                else:
                    l[0] = a[1] = modes[1] = modes[0]
                if bs != BS_4x8:
                    modes[2] = a[0] = self._ymode(int(a[0]), int(l[1]),
                                                  row, col, 2)
                    if bs != BS_8x4:
                        modes[3] = self._ymode(int(a[1]), modes[2],
                                               row, col, 3)
                        l[1] = a[1] = modes[3]
                    else:
                        l[1] = a[1] = modes[3] = modes[2]
                else:
                    modes[2] = modes[0]
                    l[1] = a[1] = modes[3] = modes[1]
            else:
                m = self._ymode(int(a[0]), int(l[0]), row, col, 0)
                modes = [m, m, m, m]
                fs.above_mode[col * 2:col * 2 + w4 * 2] = m
                self.fs.left_mode[row7 * 2:row7 * 2 + h4 * 2] = m
            uv = None
            if io.encode:
                uv = self.plan.uvmode(row, col, modes[3])
            uvmode = io.tree(T.INTRAMODE_TREE,
                             T.KF_UVMODE_PROBS[modes[3]], uv)
        elif intra:
            modes, uvmode = self._intra_in_inter_modes(row, col, bs)
        else:
            modes, uvmode, filter_id = self._inter_modes(
                row, col, bs, skip, have_a, have_l)

        uvtx = tx - int(w4 * 2 == (1 << tx) or h4 * 2 == (1 << tx))
        b["uvtx"] = uvtx
        b["mode"] = modes

        # context write-back (SET_CTXS)
        fs.above_skip[col:col + w4] = skip
        fs.above_txfm[col:col + w4] = tx
        fs.above_partition[col:col + w4] = ABOVE_CTX[bs]
        self.fs.left_skip[row7:row7 + h4] = skip
        self.fs.left_txfm[row7:row7 + h4] = tx
        self.fs.left_partition[row7:row7 + h4] = LEFT_CTX[bs]
        if not is_key:
            vref = b["ref"][h.signbias[h.varcompref[0]]
                            if b["comp"] else 0]
            fs.above_intra[col:col + w4] = intra
            fs.above_comp[col:col + w4] = b["comp"]
            fs.above_mode8[col:col + w4] = modes[3]
            self.fs.left_intra[row7:row7 + h4] = intra
            self.fs.left_comp[row7:row7 + h4] = b["comp"]
            self.fs.left_mode8[row7:row7 + h4] = modes[3]
            if not intra:
                fs.above_ref[col:col + w4] = vref
                self.fs.left_ref[row7:row7 + h4] = vref
                if h.filtermode == 4:     # FILTER_SWITCHABLE
                    fs.above_filter[col:col + w4] = filter_id
                    self.fs.left_filter[row7:row7 + h4] = filter_id
            # MV context write-back (4px granularity)
            if bs > BS_8x8:
                mv = b["mv"]
                self.fs.left_mv_ctx[row7 * 2 + 0] = np.array(
                    mv[1], np.int32)
                self.fs.left_mv_ctx[row7 * 2 + 1] = np.array(
                    mv[3], np.int32)
                fs.above_mv_ctx[col * 2 + 0] = np.array(
                    mv[2], np.int32)
                fs.above_mv_ctx[col * 2 + 1] = np.array(
                    mv[3], np.int32)
            else:
                m3 = np.array(b["mv"][3], np.int32)
                fs.above_mv_ctx[col * 2:col * 2 + w4c * 2] = m3
                self.fs.left_mv_ctx[row7 * 2:row7 * 2 + h4c * 2] = m3
            # whole-frame MV grid
            if intra:
                fs.mv_ref[row:row + h4c, col:col + w4c] = -1
            else:
                fs.mv_ref[row:row + h4c, col:col + w4c, 0] = \
                    b["ref"][0]
                fs.mv_ref[row:row + h4c, col:col + w4c, 1] = \
                    b["ref"][1] if b["comp"] else -1
                fs.mv_xy[row:row + h4c, col:col + w4c, 0] = \
                    np.array(b["mv"][3][0], np.int32)
                if b["comp"]:
                    fs.mv_xy[row:row + h4c, col:col + w4c, 1] = \
                        np.array(b["mv"][3][1], np.int32)

        # coefficients
        eobs = blocks = None
        uveobs = uvblocks = None
        if skip:
            fs.above_y_nnz[col * 2:col * 2 + w4 * 2] = 0
            self.fs.left_y_nnz[row7 * 2:row7 * 2 + h4 * 2] = 0
            for pl in range(2):
                fs.above_uv_nnz[pl][col:col + w4] = 0
                self.fs.left_uv_nnz[pl][row7:row7 + h4] = 0
        else:
            eobs, blocks, uveobs, uvblocks = self._coeffs(
                row, col, bs, tx, uvtx, modes, intra)
            if not any(eobs.values()) and \
                    not any(uveobs[0].values()) and \
                    not any(uveobs[1].values()) and \
                    bs <= BS_8x8 and not intra:
                # all-zero inter small block counts as skipped for the
                # loop filter and skip context (vp9block.c:1311)
                skip = 1
                fs.above_skip[col:col + w4] = 1
                self.fs.left_skip[row7:row7 + h4] = 1

        # loop filter level + edge masks
        if not io.encode:
            lvl = int(h.lflvl_mat[0 if intra else b["ref"][0] + 1]
                      [int(modes[3] != ZEROMV and not intra
                           and not is_key)])
            fs.lf_lvl[row:row + h4c, col:col + w4c] = lvl
            self._mask_edges(row, col, w4, h4, tx, uvtx, bs,
                             skip_inter=(not intra and skip))

        # reconstruction (inline host path, or record for device
        # replay — recon_tpu.py)
        if not io.encode:
            if fs.recorder is not None:
                if intra:
                    fs.recorder.record_intra(
                        self, row, col, bs, tx, uvtx, modes, uvmode,
                        eobs, blocks, uveobs, uvblocks)
                else:
                    fs.recorder.record_inter(
                        self, row, col, bs, tx, uvtx, eobs, blocks,
                        uveobs, uvblocks)
            elif intra:
                self._recon(row, col, bs, tx, uvtx, modes, uvmode,
                            eobs, blocks, uveobs, uvblocks)
            else:
                from .inter import inter_recon
                inter_recon(self, row, col, bs, tx, uvtx, eobs,
                            blocks, uveobs, uvblocks)

    # -- inter-frame mode decoding (vp9block.c decode_mode) ------------
    def _intra_in_inter_modes(self, row, col, bs):
        """Intra block inside an inter frame: modes from the frame's
        y_mode/uv_mode prob tables, no neighbour ctx."""
        fs, io = self.fs, self.io
        cnt = fs.counts
        p = fs.probs

        def ym(grp, i):
            v = None
            if io.encode:
                v = self.plan.ymode(row, col, i, 0, 0)
            m = io.tree(T.INTRAMODE_TREE, [int(x) for x in
                                           p.y_mode[grp]], v)
            cnt["y_mode"][grp][m] += 1
            return m

        modes = [0, 0, 0, 0]
        if bs > BS_8x8:
            modes[0] = ym(0, 0)
            modes[1] = ym(0, 1) if bs != BS_8x4 else modes[0]
            if bs != BS_4x8:
                modes[2] = ym(0, 2)
                modes[3] = ym(0, 3) if bs != BS_8x4 else modes[2]
            else:
                modes[2] = modes[0]
                modes[3] = modes[1]
        else:
            sz = SIZE_GROUP[bs]
            m = ym(sz, 0)
            modes = [m, m, m, m]
        v = None
        if io.encode:
            v = self.plan.uvmode(row, col, modes[3])
        uvmode = io.tree(T.INTRAMODE_TREE,
                         [int(x) for x in p.uv_mode[modes[3]]], v)
        cnt["uv_mode"][modes[3]][uvmode] += 1
        return modes, uvmode

    def _inter_modes(self, row, col, bs, skip, have_a, have_l):
        from . import mvs
        fs, io = self.fs, self.io
        h = fs.h
        p = fs.probs
        cnt = fs.counts
        b = self.b
        row7 = row & 7

        # compound flag
        if h.comppredmode != 2:           # not PRED_SWITCHABLE
            b["comp"] = int(h.comppredmode == 1)  # PRED_COMPREF
        else:
            c = self._comp_ctx(row, col, have_a, have_l)
            v = None
            if io.encode:
                v = 1 if self.plan.comp(row, col) else 0
            b["comp"] = io.b(int(p.comp[c]), v)
            cnt["comp"][c][b["comp"]] += 1

        # references
        if b["comp"]:
            fix_idx = h.signbias[h.fixcompref]
            var_idx = 1 - fix_idx
            b["ref"][fix_idx] = h.fixcompref
            c = self._comp_ref_ctx(row, col, have_a, have_l)
            v = None
            if io.encode:
                want = self.plan.ref2(row, col)
                v = int(want == h.varcompref[1])
            bit = io.b(int(p.comp_ref[c]), v)
            cnt["comp_ref"][c][bit] += 1
            b["ref"][var_idx] = h.varcompref[bit]
        else:
            c = self._single_ref_ctx1(row, col, have_a, have_l)
            want = self.plan.ref1(row, col) if io.encode else None
            bit = io.b(int(p.single_ref[c][0]),
                       None if want is None else int(want != 0))
            cnt["single_ref"][c][0][bit] += 1
            if not bit:
                b["ref"][0] = 0
            else:
                c = self._single_ref_ctx2(row, col, have_a, have_l)
                bit = io.b(int(p.single_ref[c][1]),
                           None if want is None else int(want == 2))
                cnt["single_ref"][c][1][bit] += 1
                b["ref"][0] = 1 + bit

        modes = [0, 0, 0, 0]
        if bs <= BS_8x8:
            off = INTER_MODE_CTX_OFF[bs]
            c = INTER_MODE_CTX_LUT[
                int(fs.above_mode8[col + off])][
                int(self.fs.left_mode8[row7 + off])]
            v = None
            if io.encode:
                v = self.plan.inter_mode(row, col, 0)
            m = io.tree(T.INTER_MODE_TREE,
                        [int(x) for x in p.mv_mode[c]], v)
            cnt["mv_mode"][c][m - 10] += 1
            modes = [m, m, m, m]

        # interpolation filter
        if h.filtermode == 4:             # FILTER_SWITCHABLE
            if have_a and int(fs.above_mode8[col]) >= 10:
                if have_l and int(self.fs.left_mode8[row7]) >= 10:
                    c = int(self.fs.left_filter[row7]) \
                        if int(fs.above_filter[col]) == \
                        int(self.fs.left_filter[row7]) else 3
                else:
                    c = int(fs.above_filter[col])
            elif have_l and int(self.fs.left_mode8[row7]) >= 10:
                c = int(self.fs.left_filter[row7])
            else:
                c = 3
            v = None
            if io.encode:
                v = self.plan.filter(row, col)
            filter_id = io.tree(T.FILTER_TREE,
                                [int(x) for x in p.filter[c]], v)
            cnt["filter"][c][filter_id] += 1
            b["filter"] = FILTER_LUT[filter_id]
        else:
            filter_id = 0
            b["filter"] = h.filtermode

        plan_mv = self.plan.newmv if io.encode else None
        if bs > BS_8x8:
            c = INTER_MODE_CTX_LUT[int(fs.above_mode8[col])][
                int(self.fs.left_mode8[row7])]

            def sub_mode(i):
                v = None
                if io.encode:
                    v = self.plan.inter_mode(row, col, i)
                m = io.tree(T.INTER_MODE_TREE,
                            [int(x) for x in p.mv_mode[c]], v)
                cnt["mv_mode"][c][m - 10] += 1
                return m

            modes[0] = sub_mode(0)
            b["mv"][0] = mvs.fill_mv(
                self, modes[0], 0,
                plan_mv(row, col, 0) if io.encode else None)
            if bs != BS_8x4:
                modes[1] = sub_mode(1)
                b["mv"][1] = mvs.fill_mv(
                    self, modes[1], 1,
                    plan_mv(row, col, 1) if io.encode else None)
            else:
                modes[1] = modes[0]
                b["mv"][1] = list(b["mv"][0])
            if bs != BS_4x8:
                modes[2] = sub_mode(2)
                b["mv"][2] = mvs.fill_mv(
                    self, modes[2], 2,
                    plan_mv(row, col, 2) if io.encode else None)
                if bs != BS_8x4:
                    modes[3] = sub_mode(3)
                    b["mv"][3] = mvs.fill_mv(
                        self, modes[3], 3,
                        plan_mv(row, col, 3) if io.encode else None)
                else:
                    modes[3] = modes[2]
                    b["mv"][3] = list(b["mv"][2])
            else:
                modes[2] = modes[0]
                b["mv"][2] = list(b["mv"][0])
                modes[3] = modes[1]
                b["mv"][3] = list(b["mv"][1])
        else:
            b["mv"][0] = mvs.fill_mv(
                self, modes[0], -1,
                plan_mv(row, col, 0) if io.encode else None)
            b["mv"][1] = list(b["mv"][0])
            b["mv"][2] = list(b["mv"][0])
            b["mv"][3] = list(b["mv"][0])
        return modes, 0, filter_id

    def _comp_ctx(self, row, col, have_a, have_l):
        """comppred-switchable context (vp9block.c:344)."""
        fs = self.fs
        h = fs.h
        row7 = row & 7
        a_c = int(fs.above_comp[col])
        l_c = int(self.fs.left_comp[row7])
        a_i = int(fs.above_intra[col])
        l_i = int(self.fs.left_intra[row7])
        a_r = int(fs.above_ref[col])
        l_r = int(self.fs.left_ref[row7])
        fix = h.fixcompref
        if have_a:
            if have_l:
                if a_c and l_c:
                    return 4
                if a_c:
                    return 2 + int(l_i or l_r == fix)
                if l_c:
                    return 2 + int(a_i or a_r == fix)
                return int((not a_i and a_r == fix) ^
                           (not l_i and l_r == fix))
            return 3 if a_c else int(not a_i and a_r == fix)
        if have_l:
            return 3 if l_c else int(not l_i and l_r == fix)
        return 1

    def _comp_ref_ctx(self, row, col, have_a, have_l):
        """compound variable-ref context (vp9block.c:385)."""
        fs = self.fs
        h = fs.h
        row7 = row & 7
        a_c = int(fs.above_comp[col])
        l_c = int(self.fs.left_comp[row7])
        a_i = int(fs.above_intra[col])
        l_i = int(self.fs.left_intra[row7])
        a_r = int(fs.above_ref[col])
        l_r = int(self.fs.left_ref[row7])
        var1 = h.varcompref[1]
        if have_a:
            if have_l:
                if a_i:
                    if l_i:
                        return 2
                    return 1 + 2 * int(l_r != var1)
                if l_i:
                    return 1 + 2 * int(a_r != var1)
                if l_r == a_r and a_r == var1:
                    return 0
                if not l_c and not a_c:
                    if (a_r == h.fixcompref and
                            l_r == h.varcompref[0]) or \
                            (l_r == h.fixcompref and
                             a_r == h.varcompref[0]):
                        return 4
                    return 3 if a_r == l_r else 1
                if not l_c:
                    if a_r == var1 and l_r != var1:
                        return 1
                    return 2 if (l_r == var1 and a_r != var1) else 4
                if not a_c:
                    if l_r == var1 and a_r != var1:
                        return 1
                    return 2 if (a_r == var1 and l_r != var1) else 4
                return 4 if l_r == a_r else 2
            if a_i:
                return 2
            if a_c:
                return 4 * int(a_r != var1)
            return 3 * int(a_r != var1)
        if have_l:
            if l_i:
                return 2
            if l_c:
                return 4 * int(l_r != var1)
            return 3 * int(l_r != var1)
        return 2

    def _single_ref_ctx1(self, row, col, have_a, have_l):
        """single_ref bit-0 context (vp9block.c:487)."""
        fs = self.fs
        h = fs.h
        row7 = row & 7
        a_c = int(fs.above_comp[col])
        l_c = int(self.fs.left_comp[row7])
        a_i = int(fs.above_intra[col])
        l_i = int(self.fs.left_intra[row7])
        a_r = int(fs.above_ref[col])
        l_r = int(self.fs.left_ref[row7])
        if have_a and not a_i:
            if have_l and not l_i:
                if l_c:
                    if a_c:
                        return 1 + int(not h.fixcompref or not l_r or
                                       not a_r)
                    return 3 * int(not a_r) + \
                        int(not h.fixcompref or not l_r)
                if a_c:
                    return 3 * int(not l_r) + \
                        int(not h.fixcompref or not a_r)
                return 2 * int(not l_r) + 2 * int(not a_r)
            if a_i:
                return 2
            if a_c:
                return 1 + int(not h.fixcompref or not a_r)
            return 4 * int(not a_r)
        if have_l and not l_i:
            if l_i:
                return 2
            if l_c:
                return 1 + int(not h.fixcompref or not l_r)
            return 4 * int(not l_r)
        return 2

    def _single_ref_ctx2(self, row, col, have_a, have_l):
        """single_ref bit-1 context (vp9block.c:528)."""
        fs = self.fs
        h = fs.h
        row7 = row & 7
        a_c = int(fs.above_comp[col])
        l_c = int(self.fs.left_comp[row7])
        a_i = int(fs.above_intra[col])
        l_i = int(self.fs.left_intra[row7])
        a_r = int(fs.above_ref[col])
        l_r = int(self.fs.left_ref[row7])
        fix1 = h.fixcompref == 1
        if have_a:
            if have_l:
                if l_i:
                    if a_i:
                        return 2
                    if a_c:
                        return 1 + 2 * int(fix1 or a_r == 1)
                    if not a_r:
                        return 3
                    return 4 * int(a_r == 1)
                if a_i:
                    if l_i:
                        return 2
                    if l_c:
                        return 1 + 2 * int(fix1 or l_r == 1)
                    if not l_r:
                        return 3
                    return 4 * int(l_r == 1)
                if a_c:
                    if l_c:
                        if l_r == a_r:
                            return 3 * int(fix1 or l_r == 1)
                        return 2
                    if not l_r:
                        return 1 + 2 * int(fix1 or a_r == 1)
                    return 3 * int(l_r == 1) + int(fix1 or a_r == 1)
                if l_c:
                    if not a_r:
                        return 1 + 2 * int(fix1 or l_r == 1)
                    return 3 * int(a_r == 1) + int(fix1 or l_r == 1)
                if not a_r:
                    if not l_r:
                        return 3
                    return 4 * int(l_r == 1)
                if not l_r:
                    return 4 * int(a_r == 1)
                return 2 * int(l_r == 1) + 2 * int(a_r == 1)
            if a_i or (not a_c and not a_r):
                return 2
            if a_c:
                return 3 * int(fix1 or a_r == 1)
            return 4 * int(a_r == 1)
        if have_l:
            if l_i or (not l_c and not l_r):
                return 2
            if l_c:
                return 3 * int(fix1 or l_r == 1)
            return 4 * int(l_r == 1)
        return 2

    def _tx_size(self, max_tx, c, want):
        io = self.io
        probs = self.fs.probs
        cnt = self.fs.counts
        if max_tx == TX_32X32:
            p = probs.tx32p[c]
            tx = io.b(int(p[0]), None if want is None else
                      int(want > 0))
            if tx:
                tx += io.b(int(p[1]), None if want is None else
                           int(want > 1))
                if tx == 2:
                    tx += io.b(int(p[2]), None if want is None else
                               int(want > 2))
            cnt["tx32p"][c][tx] += 1
        elif max_tx == TX_16X16:
            p = probs.tx16p[c]
            tx = io.b(int(p[0]), None if want is None else
                      int(want > 0))
            if tx:
                tx += io.b(int(p[1]), None if want is None else
                           int(want > 1))
            cnt["tx16p"][c][tx] += 1
        elif max_tx == TX_8X8:
            tx = io.b(int(probs.tx8p[c]), None if want is None else
                      int(want > 0))
            cnt["tx8p"][c][tx] += 1
        else:
            tx = TX_4X4
        return tx

    def _ymode(self, a, l, row, col, i):
        v = None
        if self.io.encode:
            v = self.plan.ymode(row, col, i, a, l)
        return self.io.tree(T.INTRAMODE_TREE, T.KF_YMODE_PROBS[a][l], v)

    # -- coefficient tokens (vp9block.c decode_coeffs) ------------------
    def _coeff_block(self, levels_or_none, n_coeffs, is32, p, nnz,
                     scan, nb, band_counts, qmul, out,
                     cnt3=None, eob2=None):
        """One tx block. Returns eob (scan positions consumed).
        cnt3/eob2: (6,6,3)/(6,6,2) count slices for adaptation."""
        io = self.io
        enc = io.encode
        lv = levels_or_none
        if enc:
            sv = np.asarray([lv.flat[k] for k in scan[:n_coeffs]])
            nz = np.nonzero(sv)[0]
            last = int(nz[-1]) if len(nz) else -1
        i = 0
        band = 0
        band_left = band_counts[band]
        tp = p[0][nnz]
        cache = np.zeros(1024, np.int32)
        while True:
            val = io.b(int(tp[0]),
                       None if not enc else int(i <= last))
            eob2[band][nnz][val] += 1
            if not val:
                break
            while True:                   # zero-run (skip_eob)
                zv = None
                if enc:
                    zv = int(sv[i] != 0)
                if io.b(int(tp[1]), zv):
                    break
                cnt3[band][nnz][0] += 1
                if not band_left:
                    raise InvalidData("vp9: bad band")
                band_left -= 1
                if not band_left and band < 5:
                    band += 1
                    band_left = band_counts[band]
                cache[scan[i]] = 0
                nnz = (1 + cache[nb[i][0]] + cache[nb[i][1]]) >> 1
                tp = p[band][nnz]
                i += 1
                if i == n_coeffs:
                    return i
            rc = int(scan[i])
            av = abs(int(sv[i])) if enc else None
            if not io.b(int(tp[2]), None if not enc else int(av > 1)):
                cnt3[band][nnz][1] += 1
                val = 1
                cache[rc] = 1
            else:
                cnt3[band][nnz][2] += 1
                if not io.b(int(tp[3]),
                            None if not enc else int(av > 4)):
                    if not io.b(int(tp[4]),
                                None if not enc else int(av > 2)):
                        cache[rc] = val = 2
                    else:
                        val = 3 + io.b(int(tp[5]),
                                       None if not enc else int(av > 3))
                        cache[rc] = 3
                elif not io.b(int(tp[6]),
                              None if not enc else int(av > 10)):
                    cache[rc] = 4
                    if not io.b(int(tp[7]),
                                None if not enc else int(av > 6)):
                        val = 5 + io.b(159, None if not enc else
                                       int(av - 5))
                    else:
                        val = 7 + 2 * io.b(165, None if not enc else
                                           (av - 7) >> 1)
                        val += io.b(145, None if not enc else
                                    (av - 7) & 1)
                else:                     # cat 3-6
                    cache[rc] = 5
                    if not io.b(int(tp[8]),
                                None if not enc else int(av > 34)):
                        if not io.b(int(tp[9]),
                                    None if not enc else int(av > 18)):
                            d = None if not enc else av - 11
                            val = 11 + 4 * io.b(173, None if d is None
                                                else (d >> 2) & 1)
                            val += 2 * io.b(148, None if d is None
                                            else (d >> 1) & 1)
                            val += io.b(140, None if d is None
                                        else d & 1)
                        else:
                            d = None if not enc else av - 19
                            val = 19 + 8 * io.b(176, None if d is None
                                                else (d >> 3) & 1)
                            val += 4 * io.b(155, None if d is None
                                            else (d >> 2) & 1)
                            val += 2 * io.b(140, None if d is None
                                            else (d >> 1) & 1)
                            val += io.b(135, None if d is None
                                        else d & 1)
                    elif not io.b(int(tp[10]),
                                  None if not enc else int(av > 66)):
                        d = None if not enc else av - 35
                        val = 35
                        for k, pr in enumerate((180, 157, 141, 134,
                                                130)):
                            val += io.b(pr, None if d is None else
                                        (d >> (4 - k)) & 1) << (4 - k)
                    else:
                        d = None if not enc else av - 67
                        val = 67
                        cat6 = (254, 254, 254, 252, 249, 243, 230,
                                196, 177, 153, 140, 133, 130, 129)
                        for k, pr in enumerate(cat6):
                            sh = 13 - k
                            val += io.b(pr, None if d is None else
                                        (d >> sh) & 1) << sh
            if not band_left:
                raise InvalidData("vp9: bad band")
            band_left -= 1
            if not band_left and band < 5:
                band += 1
                band_left = band_counts[band]
            neg = io.bit(None if not enc else int(sv[i] < 0))
            if not enc:
                q = val * int(qmul[1 if i else 0])
                q = -q if neg else q
                if is32:
                    q = abs(q) // 2 * (-1 if q < 0 else 1)
                # the reference stores coefficients as int16
                out.flat[rc] = ((q + 0x8000) & 0xFFFF) - 0x8000
            nnz = (1 + cache[nb[i][0]] + cache[nb[i][1]]) >> 1
            i += 1
            if i >= n_coeffs:
                break
            tp = p[band][nnz]
        return i

    def _coeffs(self, row, col, bs, tx, uvtx, modes, intra=1):
        fs, io = self.fs, self.io
        probs = fs.probs
        h = fs.h
        inter = int(not intra)
        w4 = int(T.BWH_TAB[1][bs][0]) * 2     # 4px units
        h4 = int(T.BWH_TAB[1][bs][1]) * 2
        end_x = min(2 * (fs.cols - col), w4)
        end_y = min(2 * (fs.rows - row), h4)
        row7 = row & 7
        a = fs.above_y_nnz[col * 2:col * 2 + w4]
        l = self.fs.left_y_nnz[row7 * 2:row7 * 2 + h4]
        step1d = 1 << tx
        ybc = BAND_COUNTS[tx]
        uvbc = BAND_COUNTS[uvtx]
        p = probs.coef[tx][0][inter]      # [band][nnz][11]
        cnt3 = fs.counts["coef"][tx][0][inter]
        eob2 = fs.counts["eob"][tx][0][inter]
        eobs = {}
        blocks = {}
        # merge ctx for larger tx
        if tx > 0:
            s = step1d
            for n in range(0, end_y, s):
                l[n] = 1 if l[n:n + s].any() else 0
            for n in range(0, end_x, s):
                a[n] = 1 if a[n:n + s].any() else 0
        n = 0
        for y in range(0, end_y, step1d):
            for x in range(0, end_x, step1d):
                mode = modes[y * 2 + x if bs > BS_8x8 and
                             tx == TX_4X4 else 0]
                txtp = INTRA_TXFM_TYPE[mode] if tx != TX_32X32 \
                    else TX.DCT_DCT
                scan, nb = _SCANS[(tx, txtp)]
                lv = None
                out = None
                if io.encode:
                    lv = self.plan.levels(row, col, 0, 1 << (tx + 2),
                                          n)
                else:
                    out = np.zeros((step1d * 4, step1d * 4), np.int64)
                ret = self._coeff_block(lv, 16 * step1d * step1d,
                                        tx == TX_32X32, p,
                                        int(a[x]) + int(l[y]), scan,
                                        nb, ybc, h.qmul[0], out,
                                        cnt3, eob2)
                a[x] = l[y] = 1 if ret else 0
                eobs[n] = ret
                blocks[n] = out
                n += step1d * step1d
        # splat merged ctx back
        if tx > 0:
            s = step1d
            for base in range(0, end_y, s):
                l[base:base + min(s, end_y - base)] = l[base]
            for base in range(0, end_x, s):
                a[base:base + min(s, end_x - base)] = a[base]
            if end_x < w4:
                a[end_x:] = 0
            if end_y < h4:
                l[end_y:] = 0

        # chroma
        uvstep = 1 << uvtx
        w4c, h4c = w4 >> 1, h4 >> 1
        end_xc, end_yc = end_x >> 1, end_y >> 1
        scan, nb = _SCANS[(uvtx, TX.DCT_DCT)]
        p = probs.coef[uvtx][1][inter]
        cnt3 = fs.counts["coef"][uvtx][1][inter]
        eob2 = fs.counts["eob"][uvtx][1][inter]
        uveobs = {0: {}, 1: {}}
        uvblocks = {0: {}, 1: {}}
        for pl in range(2):
            a = fs.above_uv_nnz[pl][col:col + w4c]
            lft = self.fs.left_uv_nnz[pl][row7:row7 + h4c]
            if uvtx > 0:
                s = uvstep
                for nn in range(0, end_yc, s):
                    lft[nn] = 1 if lft[nn:nn + s].any() else 0
                for nn in range(0, end_xc, s):
                    a[nn] = 1 if a[nn:nn + s].any() else 0
            n = 0
            for y in range(0, end_yc, uvstep):
                for x in range(0, end_xc, uvstep):
                    lv = None
                    out = None
                    if io.encode:
                        lv = self.plan.levels(row, col, 1 + pl,
                                              uvstep * 4, n)
                    else:
                        out = np.zeros((uvstep * 4, uvstep * 4),
                                       np.int64)
                    ret = self._coeff_block(
                        lv, 16 * uvstep * uvstep, uvtx == TX_32X32,
                        p, int(a[x]) + int(lft[y]), scan, nb, uvbc,
                        h.qmul[1], out, cnt3, eob2)
                    a[x] = lft[y] = 1 if ret else 0
                    uveobs[pl][n] = ret
                    uvblocks[pl][n] = out
                    n += uvstep * uvstep
            if uvtx > 0:
                s = uvstep
                for base in range(0, end_yc, s):
                    lft[base:base + min(s, end_yc - base)] = lft[base]
                for base in range(0, end_xc, s):
                    a[base:base + min(s, end_xc - base)] = a[base]
                if end_xc < w4c:
                    a[end_xc:] = 0
                if end_yc < h4c:
                    lft[end_yc:] = 0
        return eobs, blocks, uveobs, uvblocks

    # -- reconstruction (vp9recon.c intra_recon) ------------------------
    def _edges(self, plane, px_w, px_h, x0, y0, n, mode, have_top,
               have_left, have_right, tx4):
        """check_intra_mode analog → (mode', left, top, tl) in the
        bottom-up left convention of intra.py."""
        mode_conv = {
            IP.VERT: (IP.DC_127, IP.VERT, IP.DC_127, IP.VERT),
            IP.HOR: (IP.DC_129, IP.DC_129, IP.HOR, IP.HOR),
            IP.DC: (IP.DC_128, IP.TOP_DC, IP.LEFT_DC, IP.DC),
            IP.DDL: (IP.DC_127, IP.DDL, IP.DC_127, IP.DDL),
            IP.DDR: (IP.DDR, IP.DDR, IP.DDR, IP.DDR),
            IP.VR: (IP.VR, IP.VR, IP.VR, IP.VR),
            IP.HD: (IP.HD, IP.HD, IP.HD, IP.HD),
            IP.VL: (IP.DC_127, IP.VL, IP.DC_127, IP.VL),
            IP.HU: (IP.DC_129, IP.DC_129, IP.HU, IP.HU),
            IP.TM: (IP.DC_129, IP.VERT, IP.HOR, IP.TM),
        }
        needs = {
            IP.VERT: (0, 1, 0, 0, 0), IP.HOR: (1, 0, 0, 0, 0),
            IP.DC: (1, 1, 0, 0, 0), IP.DDL: (0, 1, 0, 1, 0),
            IP.DDR: (1, 1, 1, 0, 0), IP.VR: (1, 1, 1, 0, 0),
            IP.HD: (1, 1, 1, 0, 0), IP.VL: (0, 1, 0, 1, 0),
            IP.HU: (1, 0, 0, 0, 1), IP.TM: (1, 1, 1, 0, 0),
            IP.LEFT_DC: (1, 0, 0, 0, 0), IP.TOP_DC: (0, 1, 0, 0, 0),
            IP.DC_128: (0, 0, 0, 0, 0), IP.DC_127: (0, 0, 0, 0, 0),
            IP.DC_129: (0, 0, 0, 0, 0),
        }
        mode = mode_conv[mode][(have_left << 1) | have_top]
        needs_left, needs_top, needs_tl, needs_tr, invert = needs[mode]
        top = np.full(2 * n, 127, np.int32)
        left = np.full(n, 129, np.int32)
        tl = 128 + (1 if have_top else -1)
        if needs_top or needs_tl:
            n_have = px_w - x0
            if have_top:
                m = min(2 * n if (tx4 and needs_tr and have_right)
                        else n, n_have)
                m = min(m, 2 * n)
                top[:m] = plane[y0 - 1, x0:x0 + m]
                if m < 2 * n:
                    top[m:] = top[m - 1]
                if needs_tr and tx4:
                    if not (have_right and n + 4 <= n_have):
                        top[n:n + 4] = top[n - 1]
            if needs_tl and have_left and have_top:
                tl = int(plane[y0 - 1, x0 - 1])
        if needs_left:
            if have_left:
                n_have = px_h - y0
                m = min(n, n_have)
                colv = plane[y0:y0 + m, x0 - 1].astype(np.int32)
                if invert:                # top-down (HOR_UP)
                    left[:m] = colv
                    if m < n:
                        left[m:] = left[m - 1]
                else:                     # bottom-up
                    left[n - m:] = colv[::-1]
                    if m < n:
                        left[:n - m] = left[n - m]
            # else keep 129 fill
        return mode, left, top, tl

    def _recon(self, row, col, bs, tx, uvtx, modes, uvmode, eobs,
               blocks, uveobs, uvblocks):
        fs = self.fs
        w4 = int(T.BWH_TAB[1][bs][0]) * 2
        h4 = int(T.BWH_TAB[1][bs][1]) * 2
        end_x = min(2 * (fs.cols - col), w4)
        end_y = min(2 * (fs.rows - row), h4)
        step1d = 1 << tx
        px = col * 8
        py = row * 8
        pw = fs.cols * 8                  # decodable width (luma)
        ph = fs.rows * 8
        n = 0
        for y in range(0, end_y, step1d):
            for x in range(0, end_x, step1d):
                mode = modes[2 * y + x if bs > BS_8x8 and
                             tx == TX_4X4 else 0]
                size = step1d * 4
                x0 = px + x * 4
                y0 = py + y * 4
                have_top = row > 0 or y > 0
                have_left = col > self.tile_col_start or x > 0
                m, left, top, tl = self._edges(
                    fs.y, pw, ph, x0, y0, size, mode, have_top,
                    have_left, x < w4 - 1, tx == TX_4X4)
                pred = IP.predict(m, size, left, top, tl)
                fs.y[y0:y0 + size, x0:x0 + size] = \
                    np.clip(pred, 0, 255).astype(np.uint8)
                eob = eobs[n] if eobs else 0
                if eob:
                    txtp = INTRA_TXFM_TYPE[mode] if tx != TX_32X32 \
                        else TX.DCT_DCT
                    TX.itxfm_add(fs.y[y0:y0 + size, x0:x0 + size],
                                 blocks[n], txtp, eob)
                n += step1d * step1d
        # chroma
        uvstep = 1 << uvtx
        end_xc, end_yc = end_x >> 1, end_y >> 1
        w4c = w4 >> 1
        pxc, pyc = px >> 1, py >> 1
        pwc, phc = pw >> 1, ph >> 1
        for pl, plane in ((0, fs.u), (1, fs.v)):
            n = 0
            for y in range(0, end_yc, uvstep):
                for x in range(0, end_xc, uvstep):
                    size = uvstep * 4
                    x0 = pxc + x * 4
                    y0 = pyc + y * 4
                    have_top = row > 0 or y > 0
                    have_left = col > self.tile_col_start or x > 0
                    m, left, top, tl = self._edges(
                        plane, pwc, phc, x0, y0, size, uvmode,
                        have_top, have_left, x < w4c - 1,
                        uvtx == TX_4X4)
                    pred = IP.predict(m, size, left, top, tl)
                    plane[y0:y0 + size, x0:x0 + size] = \
                        np.clip(pred, 0, 255).astype(np.uint8)
                    eob = uveobs[pl][n] if uveobs else 0
                    if eob:
                        TX.itxfm_add(plane[y0:y0 + size, x0:x0 + size],
                                     uvblocks[pl][n], TX.DCT_DCT, eob)
                    n += uvstep * uvstep

    # -- loop filter masks (vp9block.c mask_edges) ----------------------
    def _mask_edges(self, row, col, w4, h4, tx, uvtx, bs,
                    skip_inter=False):
        fs = self.fs
        # clamp to picture
        w = min(w4, fs.cols - col)
        h = min(h4, fs.rows - row)
        if skip_inter:
            self._mask_plane_skip(row, col, w, h, tx, uvtx)
            return
        self._mask_plane(fs.wd_v, fs.wd_h, row, col, w, h, tx, 0, 0,
                         fs.cols, fs.rows)
        self._mask_plane_uv(row, col, w, h, uvtx)

    def _mask_plane_skip(self, row, col, w, h, tx, uvtx):
        """skip_inter blocks: only the block's outer (top/left) edges
        are filtered (vp9block.c mask_edges else-branch)."""
        fs = self.fs
        wd_v, wd_h = fs.wd_v, fs.wd_h
        r2, c2 = row * 2, col * 2
        if tx != TX_4X4:
            wd = 8 if tx == TX_8X8 else 16
            wd_h[r2, c2:c2 + w * 2] = np.maximum(
                wd_h[r2, c2:c2 + w * 2], wd)
            wd_v[r2:r2 + h * 2, c2] = np.maximum(
                wd_v[r2:r2 + h * 2, c2], wd)
        else:
            wv = 8 if (col & 3) == 0 else 4
            wd_v[r2:r2 + h * 2, c2] = np.maximum(
                wd_v[r2:r2 + h * 2, c2], wv)
            wh = 8 if (row & 3) == 0 else 4
            wd_h[r2, c2:c2 + w * 2] = np.maximum(
                wd_h[r2, c2:c2 + w * 2], wh)
        # chroma (4:2:0): 4px chroma grid = MI granularity
        wd_v, wd_h = fs.wd_v_uv, fs.wd_h_uv
        if uvtx == TX_4X4:
            if h == 1:
                if row & 1:
                    return
                if row + 1 < fs.rows:
                    h += 1
            if w == 1:
                if col & 1:
                    return
                if col + 1 < fs.cols:
                    w += 1
        if uvtx != TX_4X4:
            wdt = 8 if (uvtx == TX_8X8 or h == 1) else 16
            wd_h[row, col:col + w] = np.maximum(
                wd_h[row, col:col + w], wdt)
            wdl = 8 if (uvtx == TX_8X8 or w == 1) else 16
            wd_v[row:row + h, col] = np.maximum(
                wd_v[row:row + h, col], wdl)
        else:
            wv = 8 if (col & 7) == 0 else 4
            wd_v[row:row + h, col] = np.maximum(
                wd_v[row:row + h, col], wv)
            wh = 8 if (row & 7) == 0 else 4
            wd_h[row, col:col + w] = np.maximum(
                wd_h[row, col:col + w], wh)

    def _mask_plane(self, wd_v, wd_h, row, col, w, h, tx, ss_h, ss_v,
                    cols, rows):
        """Luma mask_edges (ss flags 0)."""
        if tx == TX_4X4:
            for yy in range(h):           # MI rows
                wide_row = (yy + row) % 4 == 0 if False else \
                    ((row + yy) & 3) == 0
                for xx in range(w):
                    x8 = col + xx
                    y8 = row + yy
                    # vertical edges: at 32px-aligned cols wd8 else wd4
                    wv = 8 if (x8 & 3) == 0 else 4
                    wd_v[y8 * 2:y8 * 2 + 2, x8 * 2] = np.maximum(
                        wd_v[y8 * 2:y8 * 2 + 2, x8 * 2], wv)
                    # inner vertical 4px edge
                    wd_v[y8 * 2:y8 * 2 + 2, x8 * 2 + 1] = np.maximum(
                        wd_v[y8 * 2:y8 * 2 + 2, x8 * 2 + 1], 4)
                    # horizontal edges
                    wh = 8 if (y8 & 3) == 0 else 4
                    wd_h[y8 * 2, x8 * 2:x8 * 2 + 2] = np.maximum(
                        wd_h[y8 * 2, x8 * 2:x8 * 2 + 2], wh)
                    wd_h[y8 * 2 + 1, x8 * 2:x8 * 2 + 2] = np.maximum(
                        wd_h[y8 * 2 + 1, x8 * 2:x8 * 2 + 2], 4)
            return
        step = 1 << (tx - 1)              # MI units between edges
        wd = 8 if tx == TX_8X8 else 16
        for yy in range(h):
            y8 = row + yy
            for xx in range(0, w, step):
                if ((col + xx) & (step - 1)) == 0:
                    x8 = col + xx
                    wd_v[y8 * 2:y8 * 2 + 2, x8 * 2] = np.maximum(
                        wd_v[y8 * 2:y8 * 2 + 2, x8 * 2], wd)
        for yy in range(0, h, step):
            if ((row + yy) & (step - 1)) == 0:
                y8 = row + yy
                for xx in range(w):
                    x8 = col + xx
                    wd_h[y8 * 2, x8 * 2:x8 * 2 + 2] = np.maximum(
                        wd_h[y8 * 2, x8 * 2:x8 * 2 + 2], wd)

    def _mask_plane_uv(self, row, col, w, h, uvtx):
        """Chroma mask_edges for 4:2:0: positions at chroma 4px =
        luma MI granularity."""
        fs = self.fs
        wd_v, wd_h = fs.wd_v_uv, fs.wd_h_uv
        if uvtx == TX_4X4:
            # blocks smaller than 16x16 luma: only even MI cols/rows
            # contribute; extend by one when not at the frame edge
            if h == 1:
                if row & 1:
                    return
                if row + 1 < fs.rows:
                    h += 1
            if w == 1:
                if col & 1:
                    return
                if col + 1 < fs.cols:
                    w += 1
            for yy in range(row, row + h):
                for xx in range(col, col + w):
                    wv = 8 if (xx & 7) == 0 else 4
                    wd_v[yy, xx] = max(int(wd_v[yy, xx]), wv)
                    wh = 8 if (yy & 7) == 0 else 4
                    wd_h[yy, xx] = max(int(wd_h[yy, xx]), wh)
            return
        step = 1 << uvtx                  # MI units between uv edges
        wd = 8 if uvtx == TX_8X8 else 16
        # odd clipped extents with 16/32 uv tx: the last marked edge
        # falls back to the 8-wide filter (mask_edges "off the visible
        # edge" rule)
        odd_w = uvtx > TX_8X8 and (w & 1)
        odd_h = uvtx > TX_8X8 and (h & 1)
        for yy in range(row, row + h):
            for xx in range(col, col + w):
                if (xx & (step - 1)) == 0:
                    wv = 8 if (odd_w and xx - col == w - 1) else wd
                    wd_v[yy, xx] = max(int(wd_v[yy, xx]), wv)
                if (yy & (step - 1)) == 0:
                    wh = 8 if (odd_h and yy - row == h - 1) else wd
                    wd_h[yy, xx] = max(int(wd_h[yy, xx]), wh)
