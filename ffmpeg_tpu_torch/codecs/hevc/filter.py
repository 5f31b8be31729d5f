"""HEVC in-loop deblocking filter, exact integer math (spec 8.7.2;
reference: libavcodec/hevc/filter.c hevc_loop_filter_luma/chroma).

Host numpy implementation operating on the whole picture: all vertical
edges first, then all horizontal edges (the spec's two-pass order,
which libavcodec reproduces CTB-by-CTB with lag). Edge positions come
from the per-4x4 TU/PU boundary maps FrameDec collects during CTU
parsing; for intra pictures every marked edge has bS = 2.

The port's copy of ffmpeg_tpu/codecs/hevc/filter.py, held equal to it by
tests/test_torch_hevc_host.py."""

from __future__ import annotations

import numpy as np

from . import tables as T

# Table 8-12 (H.265): beta' indexed by Q in 0..51, tc' by Q in 0..53
BETATABLE = np.asarray(T.BETA_TABLE, np.int32)
TCTABLE = np.asarray(T.TC_TABLE, np.int32)

assert len(BETATABLE) == 52 and len(TCTABLE) == 54


_PMAX = 255          # module-level sample max, set per call by the
                     # frame drivers below (host path is single-thread)


def _clipP(v):
    return max(0, min(_PMAX, v))


def _clip3(lo, hi, v):
    return max(lo, min(hi, v))


def _luma_edge(get, put, tc, beta, no_p=False, no_q=False):
    """Filter one 4-line luma edge segment. get(i, k) returns sample k
    of line i where k in -4..3 maps p3 p2 p1 p0 q0 q1 q2 q3; put(i, k,
    v) stores. Exact per spec 8.7.2.5.3/8.7.2.5.7."""
    p = [[get(i, -1 - j) for j in range(4)] for i in range(4)]  # p0..p3
    q = [[get(i, j) for j in range(4)] for i in range(4)]
    dp0 = abs(p[0][2] - 2 * p[0][1] + p[0][0])
    dp3 = abs(p[3][2] - 2 * p[3][1] + p[3][0])
    dq0 = abs(q[0][2] - 2 * q[0][1] + q[0][0])
    dq3 = abs(q[3][2] - 2 * q[3][1] + q[3][0])
    d0, d3 = dp0 + dq0, dp3 + dq3
    if d0 + d3 >= beta:
        return
    def dsam(i, d):
        return (2 * d < (beta >> 2)
                and abs(p[i][3] - p[i][0]) + abs(q[i][0] - q[i][3])
                < (beta >> 3)
                and abs(p[i][0] - q[i][0]) < ((5 * tc + 1) >> 1))
    if dsam(0, d0) and dsam(3, d3):
        tc2 = 2 * tc
        for i in range(4):
            P, Q = p[i], q[i]
            if not no_p:
                put(i, -1, _clip3(P[0] - tc2, P[0] + tc2,
                    (P[2] + 2 * P[1] + 2 * P[0] + 2 * Q[0] + Q[1] + 4)
                    >> 3))
                put(i, -2, _clip3(P[1] - tc2, P[1] + tc2,
                    (P[2] + P[1] + P[0] + Q[0] + 2) >> 2))
                put(i, -3, _clip3(P[2] - tc2, P[2] + tc2,
                    (2 * P[3] + 3 * P[2] + P[1] + P[0] + Q[0] + 4) >> 3))
            if not no_q:
                put(i, 0, _clip3(Q[0] - tc2, Q[0] + tc2,
                    (P[1] + 2 * P[0] + 2 * Q[0] + 2 * Q[1] + Q[2] + 4)
                    >> 3))
                put(i, 1, _clip3(Q[1] - tc2, Q[1] + tc2,
                    (P[0] + Q[0] + Q[1] + Q[2] + 2) >> 2))
                put(i, 2, _clip3(Q[2] - tc2, Q[2] + tc2,
                    (P[0] + Q[0] + Q[1] + 3 * Q[2] + 2 * Q[3] + 4) >> 3))
        return
    # weak filter
    side_thresh = (beta + (beta >> 1)) >> 3
    filt_p = dp0 + dp3 < side_thresh
    filt_q = dq0 + dq3 < side_thresh
    for i in range(4):
        P, Q = p[i], q[i]
        delta = (9 * (Q[0] - P[0]) - 3 * (Q[1] - P[1]) + 8) >> 4
        if abs(delta) >= tc * 10:
            continue
        delta = _clip3(-tc, tc, delta)
        if not no_p:
            put(i, -1, _clipP(P[0] + delta))
            if filt_p:
                dp = _clip3(-(tc >> 1), tc >> 1,
                            (((P[2] + P[0] + 1) >> 1) - P[1] + delta)
                            >> 1)
                put(i, -2, _clipP(P[1] + dp))
        if not no_q:
            put(i, 0, _clipP(Q[0] - delta))
            if filt_q:
                dq = _clip3(-(tc >> 1), tc >> 1,
                            (((Q[2] + Q[0] + 1) >> 1) - Q[1] - delta)
                            >> 1)
                put(i, 1, _clipP(Q[1] + dq))


def _chroma_edge(get, put, tc, no_p=False, no_q=False):
    """One 4-line chroma edge segment (spec 8.7.2.5.5)."""
    for i in range(4):
        p1, p0 = get(i, -2), get(i, -1)
        q0, q1 = get(i, 0), get(i, 1)
        delta = _clip3(-tc, tc, ((((q0 - p0) * 4) + p1 - q1 + 4) >> 3))
        if not no_p:
            put(i, -1, _clipP(p0 + delta))
        if not no_q:
            put(i, 0, _clipP(q0 - delta))


def deblock_frame(dec):
    """Deblock dec.y/u/v in place, driven by the per-4x4 boundary
    strength maps dec.bs_v/bs_h (filled during CTU parsing per
    filter.c ff_hevc_deblocking_boundary_strengths)."""
    sh, sps = dec.sh, dec.sps
    if sh.deblocking_disabled:
        return
    global _PMAX
    bd = sps.bit_depth
    _PMAX = (1 << bd) - 1
    bdsh = bd - 8        # beta/tc scale (spec 8.7.2.5.3: << (bd-8))
    if dec.pps.tiles_enabled and not dec.pps.loop_filter_across_tiles:
        # edges on inner tile boundaries are not filtered
        for cb in dec.col_bd[1:-1]:
            dec.bs_v[:, (cb << sps.log2_ctb) >> 2] = 0
        for rb in dec.row_bd[1:-1]:
            dec.bs_h[(rb << sps.log2_ctb) >> 2, :] = 0
    W, H = sps.width, sps.height
    qp = dec.qp
    from .recon import chroma_qp

    def luma_params(bs):
        idxb = _clip3(0, 51, qp + sh.beta_offset)
        beta = int(BETATABLE[idxb]) << bdsh
        idxt = _clip3(0, 53, qp + 2 * (bs - 1) + sh.tc_offset)
        return beta, int(TCTABLE[idxt]) << bdsh

    y = dec.y.astype(np.int32)

    # --- luma vertical edges (x multiple of 8), 4-row segments
    for x in range(8, W, 8):
        col = dec.bs_v[:, x >> 2]
        if not col.any():
            continue
        for y0 in range(0, H, 4):
            bs = int(col[y0 >> 2])
            if not bs:
                continue
            beta, tc = luma_params(bs)
            if not tc:
                continue
            _luma_edge(lambda i, k: int(y[y0 + i, x + k]),
                       lambda i, k, v: y.__setitem__((y0 + i, x + k),
                                                     v),
                       tc, beta)
    # --- luma horizontal edges (y multiple of 8), 4-col segments
    for yy in range(8, H, 8):
        row = dec.bs_h[yy >> 2, :]
        if not row.any():
            continue
        for x0 in range(0, W, 4):
            bs = int(row[x0 >> 2])
            if not bs:
                continue
            beta, tc = luma_params(bs)
            if not tc:
                continue
            _luma_edge(lambda i, k: int(y[yy + k, x0 + i]),
                       lambda i, k, v: y.__setitem__((yy + k, x0 + i),
                                                     v),
                       tc, beta)
    dec.y[:] = y.astype(dec.y.dtype)

    # --- chroma (4:2:0): edges on 16-luma grid, bS == 2 only
    for c_idx, pl in ((1, dec.u), (2, dec.v)):
        off = (dec.pps.cb_qp_offset if c_idx == 1
               else dec.pps.cr_qp_offset)
        off += (dec.sh.cb_qp_offset if c_idx == 1
                else dec.sh.cr_qp_offset)
        qpc = chroma_qp(qp, off)
        tc = int(TCTABLE[_clip3(0, 53, qpc + 2 + sh.tc_offset)]) << bdsh
        if not tc:
            continue
        c = pl.astype(np.int32)
        cH, cW = c.shape
        for x in range(16, W, 16):          # luma coords
            xc = x >> 1
            for y0 in range(0, H, 8):       # 4 chroma rows per segment
                if (y0 >> 1) + 4 > cH:
                    break
                if int(dec.bs_v[y0 >> 2, x >> 2]) != 2:
                    continue
                _chroma_edge(
                    lambda i, k: int(c[(y0 >> 1) + i, xc + k]),
                    lambda i, k, v: c.__setitem__(
                        ((y0 >> 1) + i, xc + k), v), tc)
        for yy in range(16, H, 16):
            yc = yy >> 1
            for x0 in range(0, W, 8):
                if (x0 >> 1) + 4 > cW:
                    break
                if int(dec.bs_h[yy >> 2, x0 >> 2]) != 2:
                    continue
                _chroma_edge(
                    lambda i, k: int(c[yc + k, (x0 >> 1) + i]),
                    lambda i, k, v: c.__setitem__(
                        (yc + k, (x0 >> 1) + i), v), tc)
        pl[:] = c.astype(pl.dtype)


# EO class -> (neighbour a dy,dx ; neighbour b dy,dx)  (spec 8.7.3)
_EO_NEIGH = ((0, -1, 0, 1), (-1, 0, 1, 0),
             (-1, -1, 1, 1), (-1, 1, 1, -1))


def sao_frame(dec):
    """Sample-adaptive offset (spec 8.7.3; filter.c sao_filter_CTB).
    Input is the deblocked picture; every CTB reads neighbours from
    the pre-SAO copy, so the whole pass is one vectorized step per
    (CTB, component)."""
    sps, sh = dec.sps, dec.sh
    if not (sh.sao_luma or sh.sao_chroma):
        return
    bd = sps.bit_depth
    pmax = (1 << bd) - 1
    # spec 7.4.9.3: offsets are coded at min(bd,10) precision and
    # scaled up by (bd - min(bd, 10)) — nonzero only for Main12
    osc = bd - min(bd, 10)
    # with loop_filter_across_tiles off, EO neighbours may not cross
    # tile boundaries (treated like picture edges, spec 8.7.3)
    restrict_tiles = (dec.pps.tiles_enabled
                      and not dec.pps.loop_filter_across_tiles)
    ctb = 1 << sps.log2_ctb
    for c_idx, pl in enumerate((dec.y, dec.u, dec.v)):
        if c_idx == 0 and not sh.sao_luma:
            continue
        if c_idx > 0 and not sh.sao_chroma:
            continue
        shift = 0 if c_idx == 0 else 1
        src = pl.astype(np.int32)        # pre-SAO deblocked input
        out = src.copy()
        H, W = src.shape
        for ry in range(sps.ctb_height):
            for rx in range(sps.ctb_width):
                t = int(dec.sao_type[ry, rx, c_idx])
                if not t:
                    continue
                x0 = (rx << sps.log2_ctb) >> shift
                y0 = (ry << sps.log2_ctb) >> shift
                x1 = min(x0 + (ctb >> shift), W)
                y1 = min(y0 + (ctb >> shift), H)
                vals = dec.sao_offset[ry, rx, c_idx] << osc
                blk = src[y0:y1, x0:x1]
                if t == 1:               # band offset
                    band = blk >> (bd - 5)       # 32 bands
                    pos = int(dec.sao_band_pos[ry, rx, c_idx])
                    lut = np.zeros(32, np.int32)
                    for i in range(4):
                        lut[(pos + i) & 31] = vals[i + 1]
                    out[y0:y1, x0:x1] = np.clip(blk + lut[band],
                                                0, pmax)
                    continue
                # edge offset: neighbours from the pre-SAO picture
                ady, adx, bdy, bdx = _EO_NEIGH[
                    int(dec.sao_eo_class[ry, rx, c_idx])]
                ys = np.arange(y0, y1)[:, None]
                xs = np.arange(x0, x1)[None, :]
                lo_y, hi_y, lo_x, hi_x = 0, H - 1, 0, W - 1
                if restrict_tiles:
                    tc = next(i for i in range(len(dec.col_bd) - 1)
                              if dec.col_bd[i] <= rx < dec.col_bd[i + 1])
                    tr = next(i for i in range(len(dec.row_bd) - 1)
                              if dec.row_bd[i] <= ry < dec.row_bd[i + 1])
                    lo_x = max(lo_x, (dec.col_bd[tc] << sps.log2_ctb)
                               >> shift)
                    hi_x = min(hi_x, ((dec.col_bd[tc + 1]
                                       << sps.log2_ctb) >> shift) - 1)
                    lo_y = max(lo_y, (dec.row_bd[tr] << sps.log2_ctb)
                               >> shift)
                    hi_y = min(hi_y, ((dec.row_bd[tr + 1]
                                       << sps.log2_ctb) >> shift) - 1)
                ok = ((ys + min(ady, bdy) >= lo_y)
                      & (ys + max(ady, bdy) <= hi_y)
                      & (xs + min(adx, bdx) >= lo_x)
                      & (xs + max(adx, bdx) <= hi_x))
                ya = np.clip(ys + ady, 0, H - 1)
                xa = np.clip(xs + adx, 0, W - 1)
                yb = np.clip(ys + bdy, 0, H - 1)
                xb = np.clip(xs + bdx, 0, W - 1)
                a = src[ya, xa]
                b = src[yb, xb]
                edge = 2 + np.sign(blk - a) + np.sign(blk - b)
                # remap: 0->1, 1->2, 2->0, 3->3, 4->4
                cat = np.where(edge == 2, 0,
                               np.where(edge < 2, edge + 1, edge))
                res = np.clip(blk + np.asarray(vals, np.int32)[cat],
                              0, pmax)
                out[y0:y1, x0:x1] = np.where(ok, res, blk)
        pl[:] = out.astype(pl.dtype)
