"""VVC inter prediction for the minimal toolset: merge/AMVP luma MV
derivation with HMVP (reference vvc/mvs.c:502-830 merge,
:1433-1640 AMVP, :1888-1960 round/clip/hmvp) and whole-CU translation
MC with the VVC 8-tap 1/16-pel luma / 4-tap 1/32-pel chroma filters
(vvc/data.c:1735 Table 27, :1877 Table 33;
h26x/h2656_inter_template.c interpolation shifts).

The port's copy of ffmpeg_tpu/codecs/vvc/inter.py, held equal to it by
tests/test_torch_vvc.py.
"""

from __future__ import annotations

import numpy as np

PF_INTRA, PF_L0, PF_L1, PF_BI = 0, 1, 2, 3

# Table 27, hpelIfIdx == 0 (the only filter the minimal toolset uses)
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [0, 1, -3, 63, 4, -2, 1, 0],
    [-1, 2, -5, 62, 8, -3, 1, 0],
    [-1, 3, -8, 60, 13, -4, 1, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 52, 26, -8, 3, -1],
    [-1, 3, -9, 47, 31, -10, 4, -1],
    [-1, 4, -11, 45, 34, -10, 4, -1],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [-1, 4, -10, 34, 45, -11, 4, -1],
    [-1, 4, -10, 31, 47, -9, 3, -1],
    [-1, 3, -8, 26, 52, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
    [0, 1, -4, 13, 60, -8, 3, -1],
    [0, 1, -3, 8, 62, -5, 2, -1],
    [0, 1, -2, 4, 63, -3, 1, 0]], np.int64)

# Table 33 (1x chroma; numerically the intra fC table)
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0], [-1, 63, 2, 0], [-2, 62, 4, 0], [-2, 60, 7, -1],
    [-2, 58, 10, -2], [-3, 57, 12, -2], [-4, 56, 14, -2],
    [-4, 55, 15, -2], [-4, 54, 16, -2], [-5, 53, 18, -2],
    [-6, 52, 20, -2], [-6, 49, 24, -3], [-6, 46, 28, -4],
    [-5, 44, 29, -4], [-4, 42, 30, -4], [-4, 39, 33, -4],
    [-4, 36, 36, -4], [-4, 33, 39, -4], [-4, 30, 42, -4],
    [-4, 29, 44, -5], [-4, 28, 46, -6], [-3, 24, 49, -6],
    [-2, 20, 52, -6], [-2, 18, 53, -5], [-2, 16, 54, -4],
    [-2, 15, 55, -4], [-2, 14, 56, -4], [-2, 12, 57, -3],
    [-2, 10, 58, -2], [-1, 7, 60, -2], [0, 4, 62, -2],
    [0, 2, 63, -1]], np.int64)

MAX_NUM_HMVP_CANDS = 5


class Mvf:
    """MvField: per-4x4 motion (mvs in 1/16 luma samples)."""

    __slots__ = ("pred_flag", "mv", "ref_idx")

    def __init__(self, pred_flag=PF_INTRA, mv=None, ref_idx=None):
        self.pred_flag = pred_flag
        self.mv = [[0, 0], [0, 0]] if mv is None else mv
        self.ref_idx = [0, 0] if ref_idx is None else ref_idx

    def copy(self):
        return Mvf(self.pred_flag,
                   [list(self.mv[0]), list(self.mv[1])],
                   list(self.ref_idx))


def mvf_equal(n, o):
    """compare_mv_ref_idx (mvs.c:40)."""
    if o is None or n.pred_flag != o.pred_flag:
        return False
    for i in range(2):
        if n.pred_flag & (i + 1):
            if n.ref_idx[i] != o.ref_idx[i] or n.mv[i] != o.mv[i]:
                return False
    return True


def round_mv(mv, lshift, rshift):
    """ff_vvc_round_mv (mvs.c:1888)."""
    if rshift:
        off = 1 << (rshift - 1)
        return [((mv[0] + off - (mv[0] >= 0)) >> rshift) * (1 << lshift),
                ((mv[1] + off - (mv[1] >= 0)) >> rshift) * (1 << lshift)]
    return [mv[0] * (1 << lshift), mv[1] * (1 << lshift)]


def clip_mv(mv):
    lo, hi = -(1 << 17), (1 << 17) - 1
    return [max(lo, min(hi, mv[0])), max(lo, min(hi, mv[1]))]


class NbCtx:
    """Neighbour positions + availability (mvs.c:581
    init_neighbour_context + check_available). `dec` is the FrameDec;
    availability uses the parse-progress `decoded` map (the analog of
    the reference's cb_width tab) plus the CTU-boundary rules."""

    A0, A1, A2, B0, B1, B2, B3 = range(7)

    def __init__(self, dec, x0, y0, w, h):
        self.dec = dec
        log2_ctu = dec.sps.log2_ctu
        ctb = 1 << log2_ctu
        W, H = dec.sps.width, dec.sps.height
        x0b, y0b = x0 & (ctb - 1), y0 & (ctb - 1)
        cand_left = x0 > 0
        cand_up = y0 > 0
        cand_up_left = x0 > 0 and y0 > 0
        if x0b + w == ctb:
            sap = y0 > 0 and not y0b
        else:
            sap = cand_up
        cand_up_right = sap and (x0 + w) < W
        # A0 below-left (mvs.c:562 is_a0_available): must stay above
        # the CTU bottom row and be already parsed
        max_y = min(H, ((y0 >> log2_ctu) + 1) << log2_ctu)
        a0_ok = x0 > 0 and y0 + h < max_y and \
            dec.decoded[(y0 + h) >> 2, (x0 - 1) >> 2]
        self.pos = [
            (x0 - 1, y0 + h, a0_ok),               # A0
            (x0 - 1, y0 + h - 1, cand_left),       # A1
            (x0 - 1, y0, cand_left),               # A2
            (x0 + w, y0 - 1, cand_up_right),       # B0
            (x0 + w - 1, y0 - 1, cand_up),         # B1
            (x0 - 1, y0 - 1, cand_up_left),        # B2
            (x0, y0 - 1, cand_up),                 # B3
        ]

    def available(self, idx):
        """check_available (mvs.c:622) for an inter CU: parsed and
        inter-coded."""
        x, y, flag = self.pos[idx]
        if not flag:
            return False
        dec = self.dec
        x4, y4 = x >> 2, y >> 2
        if not dec.decoded[y4, x4]:
            return False
        return dec.mvf_pf[y4, x4] != PF_INTRA

    def mvf(self, idx):
        x, y, _ = self.pos[idx]
        return get_mvf(self.dec, x, y)


def get_mvf(dec, x, y):
    x4, y4 = x >> 2, y >> 2
    return Mvf(int(dec.mvf_pf[y4, x4]),
               [[int(dec.mvf_mv[y4, x4, 0, 0]),
                 int(dec.mvf_mv[y4, x4, 0, 1])],
                [int(dec.mvf_mv[y4, x4, 1, 0]),
                 int(dec.mvf_mv[y4, x4, 1, 1])]],
               [int(dec.mvf_ref[y4, x4, 0]),
                int(dec.mvf_ref[y4, x4, 1])])


def set_mvf(dec, x0, y0, w, h, mvf):
    """ff_vvc_set_mvf (mvs.c:256)."""
    x4, y4 = x0 >> 2, y0 >> 2
    n4w, n4h = w >> 2, h >> 2
    dec.mvf_pf[y4:y4 + n4h, x4:x4 + n4w] = mvf.pred_flag
    for i in range(2):
        dec.mvf_mv[y4:y4 + n4h, x4:x4 + n4w, i, 0] = mvf.mv[i][0]
        dec.mvf_mv[y4:y4 + n4h, x4:x4 + n4w, i, 1] = mvf.mv[i][1]
        dec.mvf_ref[y4:y4 + n4h, x4:x4 + n4w, i] = mvf.ref_idx[i]


def set_intra_mvf(dec, x0, y0, w, h):
    """ff_vvc_set_intra_mvf (mvs.c:271)."""
    set_mvf(dec, x0, y0, w, h, Mvf(PF_INTRA))


# ------------------------------------------------------------- merge
def merge_mode(dec, hmvp, x0, y0, w, h, merge_idx, is_b,
               num_ref_idx_active):
    """8.5.2.2/8.5.2.3-8.5.2.5 (mvs.c:802 mv_merge_mode), TMVP off.
    Returns the selected MvField."""
    sps = dec.sps
    nb = NbCtx(dec, x0, y0, w, h)
    cand_list = []
    nb_list = {}

    def spatial():
        order = ((NbCtx.B1, None), (NbCtx.A1, NbCtx.B1),
                 (NbCtx.B0, NbCtx.B1), (NbCtx.A0, NbCtx.A1))
        for n, old in order:
            cand = nb.mvf(n) if nb.available(n) else None
            nb_list[n] = cand
            if cand is not None and \
                    not mvf_equal(cand, nb_list.get(old)):
                cand_list.append(cand)
                if merge_idx == len(cand_list) - 1:
                    return True
        if len(cand_list) != 4:
            cand = nb.mvf(NbCtx.B2) if nb.available(NbCtx.B2) \
                else None
            if cand is not None and \
                    not mvf_equal(cand, nb_list.get(NbCtx.A1)) and \
                    not mvf_equal(cand, nb_list.get(NbCtx.B1)):
                cand_list.append(cand)
                if merge_idx == len(cand_list) - 1:
                    return True
        return False

    def history():
        for i in range(1, len(hmvp) + 1):
            if len(cand_list) >= sps.max_num_merge_cand - 1:
                break
            hcand = hmvp[len(hmvp) - i]
            same = i <= 2 and (
                mvf_equal(hcand, nb_list.get(NbCtx.A1)) or
                mvf_equal(hcand, nb_list.get(NbCtx.B1)))
            if not same:
                cand_list.append(hcand.copy())
                if merge_idx == len(cand_list) - 1:
                    return True
        return False

    def pairwise():
        """8.5.2.4 (mvs.c:737)."""
        if len(cand_list) <= 1:
            return False
        p0, p1 = cand_list[0], cand_list[1]
        cand = Mvf(0)
        for i in range(1 + is_b):
            mask = i + 1
            if p0.pred_flag & mask:
                cand.pred_flag |= mask
                cand.ref_idx[i] = p0.ref_idx[i]
                if p1.pred_flag & mask:
                    mv = [p0.mv[i][0] + p1.mv[i][0],
                          p0.mv[i][1] + p1.mv[i][1]]
                    cand.mv[i] = round_mv(mv, 0, 1)
                else:
                    cand.mv[i] = list(p0.mv[i])
            elif p1.pred_flag & mask:
                cand.pred_flag |= mask
                cand.mv[i] = list(p1.mv[i])
                cand.ref_idx[i] = p1.ref_idx[i]
        if cand.pred_flag:
            cand_list.append(cand)
            return True
        return False

    if spatial() or history():
        return cand_list[merge_idx]
    if pairwise() and merge_idx == len(cand_list) - 1:
        return cand_list[merge_idx]
    # 8.5.2.5 zero-motion fill (mvs.c:776)
    num_ref = num_ref_idx_active[0] if not is_b else \
        min(num_ref_idx_active[0], num_ref_idx_active[1])
    zero_idx = 0
    while len(cand_list) < sps.max_num_merge_cand:
        cand = Mvf(PF_L0 + (is_b << 1))
        ridx = zero_idx if zero_idx < num_ref else 0
        cand.ref_idx = [ridx, ridx]
        cand_list.append(cand)
        if merge_idx == len(cand_list) - 1:
            break
        zero_idx += 1
    return cand_list[merge_idx]


# -------------------------------------------------------------- AMVP
def amvp(dec, hmvp, x0, y0, w, h, lx, ref_idx, mvp_flag, amvr_shift,
         rpl):
    """8.5.2.8 luma MVP (mvs.c:1596 mvp). rpl[lx] is the list of ref
    POCs. Returns the predictor mv (1/16 units, amvr-rounded)."""
    nb = NbCtx(dec, x0, y0, w, h)
    poc = rpl[lx][ref_idx[lx]]

    def cand_at(n):
        """mvp_candidate (mvs.c:1433): same-POC ref in lx, else ly."""
        mvf = nb.mvf(n)
        for ll in (lx, 1 - lx):
            if (mvf.pred_flag & (ll + 1)) and \
                    rpl[ll][mvf.ref_idx[ll]] == poc:
                return list(mvf.mv[ll])
        return None

    def from_nbs(nbs):
        for n in nbs:
            if nb.available(n):
                mv = cand_at(n)
                if mv is not None:
                    return round_mv(mv, amvr_shift, amvr_shift)
        return None

    num_cands = 0
    mv_a = from_nbs((NbCtx.A0, NbCtx.A1))
    if mv_a is not None:
        if mvp_flag == num_cands:
            return mv_a
        num_cands += 1
    mv_b = from_nbs((NbCtx.B0, NbCtx.B1, NbCtx.B2))
    if mv_b is not None and (mv_a is None or mv_b != mv_a):
        if mvp_flag == num_cands:
            return mv_b
        num_cands += 1
    # history candidates (mvs.c:1568); TMVP off
    for i in range(1, min(4, len(hmvp)) + 1):
        hcand = hmvp[i - 1]
        for j in range(2):
            ll = (1 - lx) if j else lx
            if (hcand.pred_flag & (ll + 1)) and \
                    poc == rpl[ll][hcand.ref_idx[ll]]:
                if mvp_flag == num_cands:
                    return round_mv(hcand.mv[ll], amvr_shift,
                                    amvr_shift)
                num_cands += 1
    return [0, 0]


def update_hmvp(hmvp, dec, x0, y0, w, h, plevel):
    """8.5.2.16 (mvs.c:1915/1941): FIFO with pruning; gated on the
    parallel-merge-level rule."""
    if not ((x0 + w) >> plevel > x0 >> plevel and
            (y0 + h) >> plevel > y0 >> plevel):
        return
    mvf = get_mvf(dec, x0, y0)
    for i, old in enumerate(hmvp):
        if mvf_equal(mvf, old):
            del hmvp[i]
            break
    else:
        if len(hmvp) == MAX_NUM_HMVP_CANDS:
            del hmvp[0]
    hmvp.append(mvf)


# ---------------------------------------------------------------- MC
def _region(plane, x0, y0, nx, ny):
    """Rows y0..y0+ny-1, cols x0..x0+nx-1; the index clamp IS the
    emulated-edge replication (vvc/inter.c:60)."""
    H, W = plane.shape
    ys = np.clip(np.arange(y0, y0 + ny), 0, H - 1)
    xs = np.clip(np.arange(x0, x0 + nx), 0, W - 1)
    return plane[np.ix_(ys, xs)].astype(np.int64)


def _filt_h(block, taps, w):
    """Horizontal FIR: block (rows, w+taps-1) -> (rows, w)."""
    out = np.zeros((block.shape[0], w), np.int64)
    for k in range(taps.shape[0]):
        out += taps[k] * block[:, k:k + w]
    return out


def _filt_v(block, taps, h):
    out = np.zeros((h, block.shape[1]), np.int64)
    for k in range(taps.shape[0]):
        out += taps[k] * block[k:k + h, :]
    return out


def _mc_14bit(plane, x, y, w, h, mx, my, filters, eb, bd):
    """Interpolate to the 14-bit intermediate domain
    (h2656_inter_template.c put_pixels/put_luma_h/v/hv: h pass
    >> (bd-8), v-after-h pass >> 6, copy << (14-bd))."""
    ntaps = filters.shape[1]
    if not mx and not my:
        return _region(plane, x, y, w, h) << (14 - bd)
    if mx and my:
        src = _region(plane, x - eb, y - eb, w + ntaps - 1,
                      h + ntaps - 1)
        tmp = _filt_h(src, filters[mx], w) >> (bd - 8)
        f = filters[my]
        res = np.zeros((h, w), np.int64)
        for k in range(ntaps):
            res += f[k] * tmp[k:k + h, :]
        return res >> 6
    if mx:
        src = _region(plane, x - eb, y, w + ntaps - 1, h)
        return _filt_h(src, filters[mx], w) >> (bd - 8)
    src = _region(plane, x, y - eb, w, h + ntaps - 1)
    return _filt_v(src, filters[my], h) >> (bd - 8)


def mc_block_14bit(plane, x0, y0, w, h, mvx, mvy, is_chroma, bd):
    """One list's prediction in the 14-bit domain. Coordinates are in
    the plane's own sample units; mv in 1/16 (luma) or 1/32 (chroma)
    of those units."""
    if is_chroma:
        frac_bits, filters, eb = 5, CHROMA_FILTERS, 1
    else:
        frac_bits, filters, eb = 4, LUMA_FILTERS, 3
    mx = mvx & ((1 << frac_bits) - 1)
    my = mvy & ((1 << frac_bits) - 1)
    x = x0 + (mvx >> frac_bits)
    y = y0 + (mvy >> frac_bits)
    return _mc_14bit(plane, x, y, w, h, mx, my, filters, eb, bd)


def mc_uni_pixels(plane, x0, y0, w, h, mvx, mvy, is_chroma, bd):
    """Uni-pred final pixels (put_uni_*: +offset >> (14-bd), clip)."""
    val = mc_block_14bit(plane, x0, y0, w, h, mvx, mvy, is_chroma, bd)
    shift = 14 - bd
    off = 1 << (shift - 1)
    return np.clip((val + off) >> shift, 0, (1 << bd) - 1)


def mc_avg_pixels(v0, v1, bd):
    """Bi-pred average (vvc/inter_template.c:185 avg)."""
    shift = max(3, 15 - bd)
    off = 1 << (shift - 1)
    return np.clip((v0 + v1 + off) >> shift, 0, (1 << bd) - 1)


def predict_inter(dec, rpl_frames, x0, y0, w, h, mvf):
    """Whole-CU translation prediction into (y, u, v) pixel blocks.
    rpl_frames[lx][ref_idx] = (y, u, v) numpy planes of the ref."""
    bd = dec.bd
    outs = []
    if mvf.pred_flag == PF_BI:
        for c in range(3):
            is_c = c > 0
            acc = []
            for i in range(2):
                ref = rpl_frames[i][mvf.ref_idx[i]][c]
                x, y = (x0 >> 1, y0 >> 1) if is_c else (x0, y0)
                ww, hh = (w >> 1, h >> 1) if is_c else (w, h)
                acc.append(mc_block_14bit(
                    ref, x, y, ww, hh, mvf.mv[i][0], mvf.mv[i][1],
                    is_c, bd))
            outs.append(mc_avg_pixels(acc[0], acc[1], bd))
    else:
        lx = mvf.pred_flag - PF_L0
        refs = rpl_frames[lx][mvf.ref_idx[lx]]
        for c in range(3):
            is_c = c > 0
            x, y = (x0 >> 1, y0 >> 1) if is_c else (x0, y0)
            ww, hh = (w >> 1, h >> 1) if is_c else (w, h)
            outs.append(mc_uni_pixels(
                refs[c], x, y, ww, hh, mvf.mv[lx][0], mvf.mv[lx][1],
                is_c, bd))
    return outs
