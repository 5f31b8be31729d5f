"""HEVC motion vector derivation: spatial merge candidates (spec
8.5.3.1.2), AMVP (8.5.3.1.6/8.5.3.2.6-8) and deblocking boundary
strengths (8.7.2.4). Mirrors libavcodec/hevc/mvs.c + filter.c
ff_hevc_deblocking_boundary_strengths semantics exactly; temporal MVP
and long-term refs are outside the supported profile (params.py walls).

The motion field lives in FrameDec at 4x4 granularity: pf (0 intra /
1 L0 / 2 L1 / 3 BI), mv[list][component], ref_idx[list]. Reference
pictures are identified by POC (unique within a CVS), standing in for
the reference's DPB-pointer comparisons.

The port's copy of ffmpeg_tpu/codecs/hevc/mvs.py, held equal to it by
tests/test_torch_hevc_host.py."""

from __future__ import annotations

PF_INTRA, PF_L0, PF_L1, PF_BI = 0, 1, 2, 3

# combined bi-pred candidate index pairs (mvs.c l0_l1_cand_idx)
L0_L1_CAND_IDX = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
                  (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))


class MvField:
    __slots__ = ("pf", "mv", "ref_idx")

    def __init__(self, pf=PF_INTRA, mv=None, ref_idx=None):
        self.pf = pf
        self.mv = mv or [(0, 0), (0, 0)]
        self.ref_idx = ref_idx or [0, 0]

    def copy(self):
        return MvField(self.pf, [self.mv[0], self.mv[1]],
                       list(self.ref_idx))


def tab_mvf(dec, x, y):
    """Motion field at luma position (x, y) as an MvField view."""
    x4, y4 = x >> 2, y >> 2
    return MvField(int(dec.pf[y4, x4]),
                   [(int(dec.mvx[y4, x4, 0]), int(dec.mvy[y4, x4, 0])),
                    (int(dec.mvx[y4, x4, 1]), int(dec.mvy[y4, x4, 1]))],
                   [int(dec.refidx[y4, x4, 0]),
                    int(dec.refidx[y4, x4, 1])])


def set_mvf(dec, x0, y0, w, h, f: MvField):
    x4, y4 = x0 >> 2, y0 >> 2
    nx, ny = max(1, w >> 2), max(1, h >> 2)
    dec.pf[y4:y4 + ny, x4:x4 + nx] = f.pf
    for ll in range(2):
        dec.mvx[y4:y4 + ny, x4:x4 + nx, ll] = f.mv[ll][0]
        dec.mvy[y4:y4 + ny, x4:x4 + nx, ll] = f.mv[ll][1]
        dec.refidx[y4:y4 + ny, x4:x4 + nx, ll] = f.ref_idx[ll]


def _same_mv(a: MvField, b: MvField) -> bool:
    """compare_mv_ref_idx (mvs.c:99)."""
    if a.pf != b.pf:
        return False
    if a.pf == PF_BI:
        return (a.ref_idx[0] == b.ref_idx[0] and a.mv[0] == b.mv[0]
                and a.ref_idx[1] == b.ref_idx[1] and a.mv[1] == b.mv[1])
    if a.pf == PF_L0:
        return a.ref_idx[0] == b.ref_idx[0] and a.mv[0] == b.mv[0]
    if a.pf == PF_L1:
        return a.ref_idx[1] == b.ref_idx[1] and a.mv[1] == b.mv[1]
    return False


def _clip8(v):
    return max(-128, min(127, v))


def _clip16(v):
    return max(-32768, min(32767, v))


def mv_scale(mv, td, tb):
    """mv_scale (mvs.c:116): POC-distance scaling. C division
    truncates toward zero; num is positive so |q| = num // |td|."""
    td = _clip8(td)
    tb = _clip8(tb)
    num = 0x4000 + abs(td) // 2
    tx = num // td if td > 0 else -(num // -td)
    sf = max(-4096, min(4095, (tb * tx + 32) >> 6))
    px = sf * mv[0]
    py = sf * mv[1]
    return (_clip16((px + 127 + (px < 0)) >> 8),
            _clip16((py + 127 + (py < 0)) >> 8))


def _zscan_avail(dec, x_cur, y_cur, xn, yn):
    """6.4.1 z-scan order block availability (mvs.c:64): earlier in
    tile-scan z order AND in the same tile."""
    if not dec.same_tile(x_cur, y_cur, xn, yn):
        return False
    sps = dec.sps
    if (yn >> sps.log2_ctb) < (y_cur >> sps.log2_ctb) or \
            (xn >> sps.log2_ctb) < (x_cur >> sps.log2_ctb):
        return True
    return int(dec.zs[yn >> 2, xn >> 2]) <= \
        int(dec.zs[y_cur >> 2, x_cur >> 2])


def neighbour_flags(dec, x0, y0, w, h):
    """ff_hevc_set_neighbour_available (mvs.c:43) for single-slice
    pictures (tile-aware): (left, bottom_left, up, up_right_sap,
    up_left)."""
    sps = dec.sps
    ctb = 1 << sps.log2_ctb
    x0b = x0 & (ctb - 1)
    y0b = y0 & (ctb - 1)
    cx, cy = x0 >> sps.log2_ctb, y0 >> sps.log2_ctb
    tid = dec.tile_id
    cur_t = tid[cy, cx]
    ctb_left = x0 >= ctb and tid[cy, cx - 1] == cur_t
    ctb_up = y0 >= ctb and tid[cy - 1, cx] == cur_t
    cand_up = bool(ctb_up or y0b)
    cand_left = bool(ctb_left or x0b)
    if x0b or y0b:
        cand_up_left = cand_left and cand_up
    else:
        cand_up_left = x0 >= ctb and y0 >= ctb and \
            tid[cy - 1, cx - 1] == cur_t
    if x0b + w == ctb:
        ctb_up_right = y0 >= ctb and cx + 1 < sps.ctb_width and \
            tid[cy - 1, cx + 1] == cur_t
        sap = ctb_up_right and not y0b
    else:
        sap = cand_up
    cand_bl = 0 if (y0 + h) >= sps.height else cand_left
    return cand_left, cand_bl, cand_up, sap, cand_up_left


def derive_merge(dec, cu_x, cu_y, x0, y0, w, h, part_mode, part_idx,
                 merge_idx):
    """8.5.3.1.1/8.5.3.1.2 → MvField for the PU
    (ff_hevc_luma_mv_merge_mode)."""
    sh = dec.sh
    left, bl, up, sap, ul = neighbour_flags(dec, x0, y0, w, h)

    def avail(cand, xn, yn):
        return bool(cand) and \
            int(dec.pf[yn >> 2, xn >> 2]) != PF_INTRA

    xa1, ya1 = x0 - 1, y0 + h - 1
    xb1, yb1 = x0 + w - 1, y0 - 1
    xb0, yb0 = x0 + w, y0 - 1
    xa0, ya0 = x0 - 1, y0 + h
    xb2, yb2 = x0 - 1, y0 - 1
    cands = []

    if part_idx == 1 and part_mode == "Nx2N":
        a1 = False
    else:
        a1 = avail(left, xa1, ya1)
        if a1:
            cands.append(tab_mvf(dec, xa1, ya1))
    if part_idx == 1 and part_mode == "2NxN":
        b1 = False
    else:
        b1 = avail(up, xb1, yb1)
        if b1:
            c = tab_mvf(dec, xb1, yb1)
            if not (a1 and _same_mv(c, tab_mvf(dec, xa1, ya1))):
                cands.append(c)
    b0 = avail(sap, xb0, yb0) and xb0 < dec.sps.width and \
        _zscan_avail(dec, x0, y0, xb0, yb0)
    if b0:
        c = tab_mvf(dec, xb0, yb0)
        if not (b1 and _same_mv(c, tab_mvf(dec, xb1, yb1))):
            cands.append(c)
    a0 = avail(bl, xa0, ya0) and ya0 < dec.sps.height and \
        _zscan_avail(dec, x0, y0, xa0, ya0)
    if a0:
        c = tab_mvf(dec, xa0, ya0)
        if not (a1 and _same_mv(c, tab_mvf(dec, xa1, ya1))):
            cands.append(c)
    if len(cands) != 4:
        b2 = avail(ul, xb2, yb2)
        if b2:
            c = tab_mvf(dec, xb2, yb2)
            if not (a1 and _same_mv(c, tab_mvf(dec, xa1, ya1))) and \
                    not (b1 and _same_mv(c, tab_mvf(dec, xb1, yb1))):
                cands.append(c)
    # (temporal candidate: sps.temporal_mvp unsupported, never present)
    n_orig = len(cands)
    is_b = sh.slice_type == 0
    if is_b and 1 < n_orig < sh.max_num_merge_cand:
        for i0, i1 in L0_L1_CAND_IDX[:n_orig * (n_orig - 1)]:
            if len(cands) >= sh.max_num_merge_cand:
                break
            c0, c1 = cands[i0], cands[i1]
            if (c0.pf & PF_L0) and (c1.pf & PF_L1) and \
                    (dec.rpl[0][c0.ref_idx[0]] != dec.rpl[1][c1.ref_idx[1]]
                     or c0.mv[0] != c1.mv[1]):
                cands.append(MvField(PF_BI, [c0.mv[0], c1.mv[1]],
                                     [c0.ref_idx[0], c1.ref_idx[1]]))
    nb_refs = sh.num_ref_idx[0] if not is_b else \
        min(sh.num_ref_idx[0], sh.num_ref_idx[1])
    zero_idx = 0
    while len(cands) <= merge_idx:
        ri = zero_idx if zero_idx < nb_refs else 0
        cands.append(MvField(PF_BI if is_b else PF_L0,
                             [(0, 0), (0, 0)], [ri, ri]))
        zero_idx += 1
    out = cands[merge_idx].copy()
    if out.pf == PF_BI and w + h == 12:
        out.pf = PF_L0
    return out


def derive_mvp(dec, x0, y0, w, h, lx, ref_idx, mvp_flag):
    """8.5.3.1.6 AMVP → predictor Mv (ff_hevc_luma_mv_mvp_mode)."""
    left, bl, up, sap, ul = neighbour_flags(dec, x0, y0, w, h)
    poc = dec.poc
    target_poc = dec.rpl[lx][ref_idx]
    ly = 1 - lx

    def pf_at(xn, yn):
        return int(dec.pf[yn >> 2, xn >> 2])

    def avail(cand, xn, yn):
        return bool(cand) and pf_at(xn, yn) != PF_INTRA

    def mp_mx(xn, yn, pl):
        """same-reference-picture candidate (mv_mp_mode_mx)."""
        f = tab_mvf(dec, xn, yn)
        if (f.pf >> pl) & 1 and \
                dec.rpl[pl][f.ref_idx[pl]] == target_poc:
            return f.mv[pl]
        return None

    def mp_mx_lt(xn, yn, pl):
        """any-reference with POC scaling (mv_mp_mode_mx_lt,
        short-term only)."""
        f = tab_mvf(dec, xn, yn)
        if (f.pf >> pl) & 1:
            mv = f.mv[pl]
            neigh_poc = dec.rpl[pl][f.ref_idx[pl]]
            if neigh_poc != target_poc:
                td = (poc - neigh_poc) or 1    # dist_scale guard
                mv = mv_scale(mv, td, poc - target_poc)
            return mv
        return None

    xa0, ya0 = x0 - 1, y0 + h
    xa1, ya1 = x0 - 1, y0 + h - 1
    a0_ok = avail(bl, xa0, ya0) and ya0 < dec.sps.height and \
        _zscan_avail(dec, x0, y0, xa0, ya0)
    a1_ok = avail(left, xa1, ya1)
    is_scaled = a0_ok or a1_ok
    mxa = None
    for xn, yn, ok in ((xa0, ya0, a0_ok), (xa1, ya1, a1_ok)):
        if not ok:
            continue
        mxa = mp_mx(xn, yn, lx) or mp_mx(xn, yn, ly)
        if mxa is not None:
            break
    if mxa is None:
        for xn, yn, ok in ((xa0, ya0, a0_ok), (xa1, ya1, a1_ok)):
            if not ok:
                continue
            mxa = mp_mx_lt(xn, yn, lx)
            if mxa is None:
                mxa = mp_mx_lt(xn, yn, ly)
            if mxa is not None:
                break

    xb0, yb0 = x0 + w, y0 - 1
    xb1, yb1 = x0 + w - 1, y0 - 1
    xb2, yb2 = x0 - 1, y0 - 1
    b0_ok = avail(sap, xb0, yb0) and xb0 < dec.sps.width and \
        _zscan_avail(dec, x0, y0, xb0, yb0)
    b1_ok = avail(up, xb1, yb1)
    b2_ok = avail(ul, xb2, yb2)
    mxb = None
    for xn, yn, ok in ((xb0, yb0, b0_ok), (xb1, yb1, b1_ok),
                       (xb2, yb2, b2_ok)):
        if not ok:
            continue
        mxb = mp_mx(xn, yn, lx) or mp_mx(xn, yn, ly)
        if mxb is not None:
            break
    if not is_scaled:                     # mvs.c scalef: re-derive B
        if mxb is not None:
            mxa = mxb
        mxb = None
        for xn, yn, ok in ((xb0, yb0, b0_ok), (xb1, yb1, b1_ok),
                           (xb2, yb2, b2_ok)):
            if not ok:
                continue
            mxb = mp_mx_lt(xn, yn, lx)
            if mxb is None:
                mxb = mp_mx_lt(xn, yn, ly)
            if mxb is not None:
                break
    cands = []
    if mxa is not None:
        cands.append(mxa)
    if mxb is not None and (mxa is None or mxa != mxb):
        cands.append(mxb)
    while len(cands) < 2:
        cands.append((0, 0))
    return cands[mvp_flag]


# ---------------------------------------------------------------------------
# deblocking boundary strengths (filter.c boundary_strength +
# ff_hevc_deblocking_boundary_strengths)


def _mv_bs(dec, cf: MvField, nf: MvField):
    """MV-based strength for two inter blocks (filter.c:588)."""
    rpl = dec.rpl

    def big(a, b):
        return abs(a[0] - b[0]) >= 4 or abs(a[1] - b[1]) >= 4

    if cf.pf == PF_BI and nf.pf == PF_BI:
        c0 = rpl[0][cf.ref_idx[0]]
        c1 = rpl[1][cf.ref_idx[1]]
        n0 = rpl[0][nf.ref_idx[0]]
        n1 = rpl[1][nf.ref_idx[1]]
        if c0 == n0 and c0 == c1 and n0 == n1:
            return 1 if ((big(nf.mv[0], cf.mv[0]) or
                          big(nf.mv[1], cf.mv[1])) and
                         (big(nf.mv[1], cf.mv[0]) or
                          big(nf.mv[0], cf.mv[1]))) else 0
        if n0 == c0 and n1 == c1:
            return 1 if (big(nf.mv[0], cf.mv[0]) or
                         big(nf.mv[1], cf.mv[1])) else 0
        if n1 == c0 and n0 == c1:
            return 1 if (big(nf.mv[1], cf.mv[0]) or
                         big(nf.mv[0], cf.mv[1])) else 0
        return 1
    if cf.pf != PF_BI and nf.pf != PF_BI:
        if cf.pf & PF_L0:
            a, ref_a = cf.mv[0], rpl[0][cf.ref_idx[0]]
        else:
            a, ref_a = cf.mv[1], rpl[1][cf.ref_idx[1]]
        if nf.pf & PF_L0:
            b, ref_b = nf.mv[0], rpl[0][nf.ref_idx[0]]
        else:
            b, ref_b = nf.mv[1], rpl[1][nf.ref_idx[1]]
        if ref_a == ref_b:
            return 1 if big(a, b) else 0
        return 1
    return 1


def boundary_strengths(dec, x0, y0, log2_size):
    """Record bS for the left/upper edges of the unit at (x0, y0) and
    its internal 8-aligned PU edges (filter.c:742). Called at each TU
    leaf and at CU level when the CU codes no transform tree."""
    size = 1 << log2_size
    is_intra = int(dec.pf[y0 >> 2, x0 >> 2]) == PF_INTRA

    def bs_pair(xp, yp, xq, yq, with_cbf):
        cf = tab_mvf(dec, xq, yq)
        nf = tab_mvf(dec, xp, yp)
        if cf.pf == PF_INTRA or nf.pf == PF_INTRA:
            return 2
        if with_cbf and (dec.cbf_luma_map[yq >> 2, xq >> 2] or
                         dec.cbf_luma_map[yp >> 2, xp >> 2]):
            return 1
        return _mv_bs(dec, cf, nf)

    if y0 > 0 and not (y0 & 7):
        for i in range(0, size, 4):
            if x0 + i >= dec.sps.width:
                break
            dec.bs_h[y0 >> 2, (x0 + i) >> 2] = bs_pair(
                x0 + i, y0 - 1, x0 + i, y0, True)
    if x0 > 0 and not (x0 & 7):
        for i in range(0, size, 4):
            if y0 + i >= dec.sps.height:
                break
            dec.bs_v[(y0 + i) >> 2, x0 >> 2] = bs_pair(
                x0 - 1, y0 + i, x0, y0 + i, True)
    if log2_size > 2 and not is_intra:
        for j in range(8, size, 8):
            if y0 + j >= dec.sps.height:
                break
            for i in range(0, size, 4):
                if x0 + i >= dec.sps.width:
                    break
                dec.bs_h[(y0 + j) >> 2, (x0 + i) >> 2] = bs_pair(
                    x0 + i, y0 + j - 1, x0 + i, y0 + j, False)
        for j in range(0, size, 4):
            if y0 + j >= dec.sps.height:
                break
            for i in range(8, size, 8):
                if x0 + i >= dec.sps.width:
                    break
                dec.bs_v[(y0 + j) >> 2, (x0 + i) >> 2] = bs_pair(
                    x0 + i - 1, y0 + j, x0 + i, y0 + j, False)
