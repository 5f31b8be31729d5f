"""H.264 in-loop deblocking filter (ITU-T H.264 §8.7; reference:
libavcodec/h264_loopfilter.c). Exact integer per-edge filtering; the
whole-plane vectorized variant lives in ops/deblock.py for the display
path — this one is the conformance-exact reconstruction filter.

The port's copy of ffmpeg_tpu/codecs/h264/loopfilter.py, held equal to it by
tests/test_torch_h264_host.py."""

from __future__ import annotations

import numpy as np

from . import tables as T


def _clip3(x, lo, hi):
    return max(lo, min(hi, x))


def _filter_luma_edge(P, Q, bs, index_a, beta, scale=1, maxv=255):
    """P/Q: lists of 4 samples each side (p3..p0 / q0..q3) per pixel row.
    Returns filtered (P, Q). alpha/beta/tc0 pre-scale by 1<<(bd-8)
    (spec 8.7.2.2 high-bit-depth threshold scaling)."""
    alpha = T.ALPHA_TABLE[52 + index_a] * scale
    p3, p2, p1, p0 = P
    q0, q1, q2, q3 = Q
    if abs(p0 - q0) >= alpha or abs(p1 - p0) >= beta or \
            abs(q1 - q0) >= beta:
        return P, Q
    if bs < 4:
        tc0 = T.TC0_TABLE[52 + index_a][bs] * scale
        ap = abs(p2 - p0) < beta
        aq = abs(q2 - q0) < beta
        tc = tc0 + (1 if ap else 0) + (1 if aq else 0)
        delta = _clip3((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
        np0 = _clip3(p0 + delta, 0, maxv)
        nq0 = _clip3(q0 - delta, 0, maxv)
        np1 = p1 + _clip3((p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1,
                          -tc0, tc0) if ap else p1
        nq1 = q1 + _clip3((q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1,
                          -tc0, tc0) if aq else q1
        return (p3, p2, np1, np0), (nq0, nq1, q2, q3)
    # bS == 4
    strong = abs(p0 - q0) < (alpha >> 2) + 2
    if strong and abs(p2 - p0) < beta:
        np0 = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
        np1 = (p2 + p1 + p0 + q0 + 2) >> 2
        np2 = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
    else:
        np0 = (2 * p1 + p0 + q1 + 2) >> 2
        np1, np2 = p1, p2
    if strong and abs(q2 - q0) < beta:
        nq0 = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
        nq1 = (q2 + q1 + q0 + p0 + 2) >> 2
        nq2 = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3
    else:
        nq0 = (2 * q1 + q0 + p1 + 2) >> 2
        nq1, nq2 = q1, q2
    return (p3, np2, np1, np0), (nq0, nq1, nq2, q3)


def _filter_chroma_edge(p1, p0, q0, q1, bs, index_a, beta, scale=1,
                        maxv=255):
    alpha = T.ALPHA_TABLE[52 + index_a] * scale
    if abs(p0 - q0) >= alpha or abs(p1 - p0) >= beta or \
            abs(q1 - q0) >= beta:
        return p0, q0
    if bs < 4:
        tc = T.TC0_TABLE[52 + index_a][bs] * scale + 1
        delta = _clip3((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
        return _clip3(p0 + delta, 0, maxv), _clip3(q0 - delta, 0, maxv)
    return (2 * p1 + p0 + q1 + 2) >> 2, (2 * q1 + q0 + p1 + 2) >> 2


def deblock_frame(dec, alpha_off=0, beta_off=0):
    """Filter all MB edges in raster order; vertical edges first per MB
    (spec 8.7). `dec` is a SliceDecoder with y/u/v, mb_qp, mb_intra,
    nnz_y; I-frames: MB edges bS 4, internal bS 3 when coeffs present."""
    sps = dec.sps
    nmbx, nmby = sps.mb_width, sps.mb_height
    scale = 1 << (dec.bd - 8)
    maxv = (1 << dec.bd) - 1
    qoff = dec.qp_bd_offset

    def chroma_qp_f(qp, coff):
        qpi = _clip3(qp + coff, -qoff, 51)
        return qpi if qpi < 0 else T.CHROMA_QP_8BIT[qpi]
    qpc_off = dec.pps.chroma_qp_index_offset
    qpc2_off = dec.pps.second_chroma_qp_index_offset

    def blk_motion(bx, by):
        """→ list of (picture-id, mv) pairs for the 4x4 block."""
        out = []
        for lst in range(2):
            r = int(dec.mv_ref[lst, by, bx])
            if r < 0:
                continue
            lstref = dec.list0 if lst == 0 else dec.list1
            pic = id(lstref[r]) if r < len(lstref) else (-1 - lst)
            out.append((pic, (int(dec.mv[lst, by, bx, 0]),
                              int(dec.mv[lst, by, bx, 1]))))
        return out

    def mv_far(a, b):
        return abs(a[0] - b[0]) >= 4 or abs(a[1] - b[1]) >= 4

    # 8x8-transform MBs: a 4x4 cell is "coded" when its 8x8 block is
    nnz_eff = dec.nnz_y.copy()
    if dec.trans8.any():
        g = dec.nnz_y.reshape(nmby * 2, 2, nmbx * 2, 2).max((1, 3))
        t8c = np.repeat(np.repeat(dec.trans8, 2, 0), 2, 1)
        g = np.where(t8c, g, 0)
        nnz_eff = np.where(
            np.repeat(np.repeat(t8c, 2, 0), 2, 1),
            np.repeat(np.repeat(g, 2, 0), 2, 1), nnz_eff)

    def seg_bs(bxp, byp, bxq, byq, mb_edge):
        if dec.mb_intra[byp // 4, bxp // 4] or \
                dec.mb_intra[byq // 4, bxq // 4]:
            return 4 if mb_edge else 3
        if nnz_eff[byp, bxp] > 0 or nnz_eff[byq, bxq] > 0:
            return 2
        # spec 8.7.2.1: compare by reference PICTURE, list-agnostic
        P = blk_motion(bxp, byp)
        Q = blk_motion(bxq, byq)
        if len(P) != len(Q):
            return 1
        if sorted(p[0] for p in P) != sorted(q[0] for q in Q):
            return 1
        if len(P) == 1:
            return 1 if mv_far(P[0][1], Q[0][1]) else 0
        if len(P) == 2:
            if P[0][0] == P[1][0]:       # same picture used twice
                ok = (not mv_far(P[0][1], Q[0][1]) and
                      not mv_far(P[1][1], Q[1][1])) or \
                     (not mv_far(P[0][1], Q[1][1]) and
                      not mv_far(P[1][1], Q[0][1]))
                return 0 if ok else 1
            for pic, mv in P:
                qmv = next(q[1] for q in Q if q[0] == pic)
                if mv_far(mv, qmv):
                    return 1
        return 0

    for mby in range(nmby):
        for mbx in range(nmbx):
            if not dec.mb_avail[mby, mbx]:
                continue
            qp_cur = int(dec.mb_qp[mby, mbx])
            # ---- vertical edges (filter across columns) ----------------
            for e in range(4):
                if e in (1, 3) and dec.trans8[mby, mbx]:
                    continue           # 8x8 transform: no inner edges
                x = mbx * 16 + e * 4
                if e == 0:
                    if mbx == 0:
                        continue
                    qp_p = int(dec.mb_qp[mby, mbx - 1])
                else:
                    qp_p = qp_cur
                qp_avg = (qp_p + qp_cur + 1) >> 1
                ia = _clip3(qp_avg + alpha_off, 0, 51)
                beta = T.BETA_TABLE[
                    52 + _clip3(qp_avg + beta_off, 0, 51)] * scale
                if T.ALPHA_TABLE[52 + ia] == 0:
                    continue
                bxq = mbx * 4 + e
                for row in range(mby * 16, mby * 16 + 16):
                    byq = row // 4
                    bs = seg_bs(bxq - 1, byq, bxq, byq, e == 0)
                    if bs == 0:
                        continue
                    Pv = tuple(int(dec.y[row, x - 4 + k]) for k in range(4))
                    Qv = tuple(int(dec.y[row, x + k]) for k in range(4))
                    Pn, Qn = _filter_luma_edge(Pv, Qv, bs, ia, beta,
                                               scale, maxv)
                    for k in range(4):
                        dec.y[row, x - 4 + k] = Pn[k]
                        dec.y[row, x + k] = Qn[k]
                if e in (0, 2):
                    cxe = mbx * 8 + (e // 2) * 4
                    for ci, plane in enumerate((dec.u, dec.v)):
                        coff = qpc_off if ci == 0 else qpc2_off
                        qpc = (chroma_qp_f(qp_p, coff)
                               + chroma_qp_f(qp_cur, coff) + 1) >> 1
                        cia = _clip3(qpc + alpha_off, 0, 51)
                        cbeta = T.BETA_TABLE[
                            52 + _clip3(qpc + beta_off, 0, 51)] * scale
                        if T.ALPHA_TABLE[52 + cia] == 0:
                            continue
                        for row in range(mby * 8, mby * 8 + 8):
                            byq = (row * 2) // 4
                            bs = seg_bs(bxq - 1, byq, bxq, byq, e == 0)
                            if bs == 0:
                                continue
                            p1, p0 = int(plane[row, cxe - 2]), \
                                int(plane[row, cxe - 1])
                            q0, q1 = int(plane[row, cxe]), \
                                int(plane[row, cxe + 1])
                            np0, nq0 = _filter_chroma_edge(
                                p1, p0, q0, q1, bs, cia, cbeta,
                                scale, maxv)
                            plane[row, cxe - 1] = np0
                            plane[row, cxe] = nq0
            # ---- horizontal edges ---------------------------------------
            for e in range(4):
                if e in (1, 3) and dec.trans8[mby, mbx]:
                    continue           # 8x8 transform: no inner edges
                y = mby * 16 + e * 4
                if e == 0:
                    if mby == 0:
                        continue
                    qp_p = int(dec.mb_qp[mby - 1, mbx])
                else:
                    qp_p = qp_cur
                qp_avg = (qp_p + qp_cur + 1) >> 1
                ia = _clip3(qp_avg + alpha_off, 0, 51)
                beta = T.BETA_TABLE[
                    52 + _clip3(qp_avg + beta_off, 0, 51)] * scale
                if T.ALPHA_TABLE[52 + ia] == 0:
                    continue
                byq = mby * 4 + e
                for col in range(mbx * 16, mbx * 16 + 16):
                    bxq = col // 4
                    bs = seg_bs(bxq, byq - 1, bxq, byq, e == 0)
                    if bs == 0:
                        continue
                    Pv = tuple(int(dec.y[y - 4 + k, col]) for k in range(4))
                    Qv = tuple(int(dec.y[y + k, col]) for k in range(4))
                    Pn, Qn = _filter_luma_edge(Pv, Qv, bs, ia, beta,
                                               scale, maxv)
                    for k in range(4):
                        dec.y[y - 4 + k, col] = Pn[k]
                        dec.y[y + k, col] = Qn[k]
                if e in (0, 2):
                    cye = mby * 8 + (e // 2) * 4
                    for ci, plane in enumerate((dec.u, dec.v)):
                        coff = qpc_off if ci == 0 else qpc2_off
                        qpc = (chroma_qp_f(qp_p, coff)
                               + chroma_qp_f(qp_cur, coff) + 1) >> 1
                        cia = _clip3(qpc + alpha_off, 0, 51)
                        cbeta = T.BETA_TABLE[
                            52 + _clip3(qpc + beta_off, 0, 51)] * scale
                        if T.ALPHA_TABLE[52 + cia] == 0:
                            continue
                        for col in range(mbx * 8, mbx * 8 + 8):
                            bxq = (col * 2) // 4
                            bs = seg_bs(bxq, byq - 1, bxq, byq, e == 0)
                            if bs == 0:
                                continue
                            p1, p0 = int(plane[cye - 2, col]), \
                                int(plane[cye - 1, col])
                            q0, q1 = int(plane[cye, col]), \
                                int(plane[cye + 1, col])
                            np0, nq0 = _filter_chroma_edge(
                                p1, p0, q0, q1, bs, cia, cbeta,
                                scale, maxv)
                            plane[cye - 1, col] = np0
                            plane[cye, col] = nq0
