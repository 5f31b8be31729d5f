"""H.264 reconstruction from parse tensors — exact-integer numpy path
(reference: libavcodec/h264_mb.c ff_h264_hl_decode_mb, the per-MB hot
loop at h264_slice.c:2571).

Consumes the SliceDecoder parse outputs (dequantized coefficient blocks,
intra modes, per-4x4 motion vectors / reference indices, availability
flags) and fills dec.y/u/v in decode order. recon_tpu.py is the batched
device implementation of the same function; tests assert byte equality.

The port's copy of ffmpeg_tpu/codecs/h264/recon_host.py, held equal to it by
tests/test_torch_h264_host.py."""

from __future__ import annotations

import numpy as np

from . import recon
from .inter import mc_chroma, mc_luma

# zscan order of 4x4 blocks inside an MB: (x4, y4) offsets
_BLK_XY = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (3, 0), (2, 1), (3, 1),
           (0, 2), (1, 2), (0, 3), (1, 3), (2, 2), (3, 2), (2, 3), (3, 3)]


def _add_residual(plane, x, y, block, maxv=255):
    if not block.any():
        return
    dst = plane[y:y + 4, x:x + 4].copy()
    recon.idct4_add(dst, block.astype(np.int64), maxv)
    plane[y:y + 4, x:x + 4] = dst


def _add_residual8(plane, x, y, block, maxv=255):
    dst = plane[y:y + 8, x:x + 8].copy()
    recon.idct8_add(dst, block.astype(np.int64), maxv)
    plane[y:y + 8, x:x + 8] = dst


_BLK8_XY = ((0, 0), (1, 0), (0, 1), (1, 1))


def _luma_residual_mb(dec, mbx, mby):
    """Add the luma residual of one MB (4x4 or 8x8 transform)."""
    if dec.trans8[mby, mbx]:
        for dx8, dy8 in _BLK8_XY:
            bx8, by8 = mbx * 2 + dx8, mby * 2 + dy8
            blk = dec.coeff8_y[by8, bx8]
            if blk.any():
                _add_residual8(dec.y, bx8 * 8, by8 * 8, blk,
                               (1 << dec.bd) - 1)
        return
    bx, by = mbx * 4, mby * 4
    for sy in range(4):
        for sx in range(4):
            _add_residual(dec.y, (bx + sx) * 4, (by + sy) * 4,
                          dec.coeff_y[by + sy, bx + sx],
                          (1 << dec.bd) - 1)


def build_weight_arrays(dec, sh):
    """Per-4x4 prediction weights/offsets/denoms resolved from the
    slice's pred_weight_table or the implicit-bipred POC derivation
    (8.4.2.3); defaults (w=1, o=0, d=0) reproduce plain averaging.
    Shared by the host and device reconstruction paths."""
    n4y, n4x = dec.mv_ref.shape[1:]
    wl = np.ones((2, n4y, n4x), np.int32)
    ol = np.zeros((2, n4y, n4x), np.int32)
    dl = np.zeros((n4y, n4x), np.int32)
    wu = np.ones((2, n4y, n4x), np.int32)
    ou = np.zeros((2, n4y, n4x), np.int32)
    wv = np.ones((2, n4y, n4x), np.int32)
    ov = np.zeros((2, n4y, n4x), np.int32)
    dc_ = np.zeros((n4y, n4x), np.int32)
    if sh is not None and sh.weights is not None:
        inter = ~np.repeat(np.repeat(dec.mb_intra, 4, 0), 4, 1)
        dl[inter] = sh.luma_log2_denom
        dc_[inter] = sh.chroma_log2_denom
        for lst in range(2):
            for r, wt in enumerate(sh.weights[lst]):
                m = dec.mv_ref[lst] == r
                wl[lst][m], ol[lst][m] = wt[0], wt[1]
                wu[lst][m], ou[lst][m] = wt[2], wt[3]
                wv[lst][m], ov[lst][m] = wt[4], wt[5]
    elif sh is not None and sh.slice_type == 1 and \
            dec.pps.weighted_bipred_idc == 2:
        bi = (dec.mv_ref[0] >= 0) & (dec.mv_ref[1] >= 0)
        for r0 in range(len(dec.list0)):
            for r1 in range(len(dec.list1)):
                m = bi & (dec.mv_ref[0] == r0) & (dec.mv_ref[1] == r1)
                if not m.any():
                    continue
                w0, w1 = _implicit_w(dec.poc,
                                     dec.list0[r0].get("poc", 0),
                                     dec.list1[r1].get("poc", 0))
                for warr, val in ((wl, (w0, w1)), (wu, (w0, w1)),
                                  (wv, (w0, w1))):
                    warr[0][m], warr[1][m] = val
                dl[m] = 5
                dc_[m] = 5
    return wl, ol, dl, wu, ou, wv, ov, dc_


def _implicit_w(poc_cur, poc0, poc1):
    """Implicit bipred weights (8.4.2.3.1; h264_direct.c
    ff_h264_init_poc-adjacent derivation)."""
    if poc0 == poc1:
        return 32, 32

    def clip3(lo, hi, v):
        return max(lo, min(hi, v))

    tb = clip3(-128, 127, poc_cur - poc0)
    td = clip3(-128, 127, poc1 - poc0)
    num = 16384 + (abs(td) >> 1)
    tx = num // td if td > 0 else -(num // -td)
    dsf = clip3(-1024, 1023, (tb * tx + 32) >> 6)
    w1 = dsf >> 2
    if w1 < -64 or w1 > 128:
        return 32, 32
    return 64 - w1, w1


def _wp_uni(p, w, o, d, maxv=255):
    v = ((p.astype(np.int64) * w + ((1 << d) >> 1)) >> d) + o
    return np.clip(v, 0, maxv).astype(p.dtype)


def _wp_bi(p0, p1, w0, w1, o0, o1, d, maxv=255):
    v = ((p0.astype(np.int64) * w0 + p1.astype(np.int64) * w1
          + (1 << d)) >> (d + 1)) + ((o0 + o1 + 1) >> 1)
    return np.clip(v, 0, maxv).astype(p0.dtype)


def _recon_inter_mb(dec, mbx, mby, list0, list1):
    bx, by = mbx * 4, mby * 4
    wl, ol, dl, wu, ou, wv, ov, dc_ = dec.wp
    for sy in range(4):
        for sx in range(4):
            bx4, by4 = bx + sx, by + sy
            x, y = bx4 * 4, by4 * 4
            cx, cy = x // 2, y // 2
            preds = []
            lists = []
            for lst, lstref in ((0, list0), (1, list1)):
                r = int(dec.mv_ref[lst, by4, bx4])
                if r < 0:
                    continue
                ry, ru, rv = lstref[r]["planes"]
                mvx = int(dec.mv[lst, by4, bx4, 0])
                mvy = int(dec.mv[lst, by4, bx4, 1])
                preds.append((mc_luma(ry, mvx, mvy, x, y, 4, 4,
                                      bd=dec.bd),
                              mc_chroma(ru, mvx, mvy, cx, cy, 2, 2,
                                        bd=dec.bd),
                              mc_chroma(rv, mvx, mvy, cx, cy, 2, 2,
                                        bd=dec.bd)))
                lists.append(lst)
            if not preds:
                continue
            d, dcb = int(dl[by4, bx4]), int(dc_[by4, bx4])
            maxv = (1 << dec.bd) - 1
            if len(preds) == 2:
                out = tuple(
                    _wp_bi(a, b, int(wt[0][by4, bx4]),
                           int(wt[1][by4, bx4]), int(ot[0][by4, bx4]),
                           int(ot[1][by4, bx4]), dd, maxv)
                    for (a, b), wt, ot, dd in zip(
                        zip(*preds), (wl, wu, wv), (ol, ou, ov),
                        (d, dcb, dcb)))
            else:
                l0 = lists[0]
                out = tuple(
                    _wp_uni(a, int(wt[l0, by4, bx4]),
                            int(ot[l0, by4, bx4]), dd, maxv)
                    for a, wt, ot, dd in zip(
                        preds[0], (wl, wu, wv), (ol, ou, ov),
                        (d, dcb, dcb)))
            dec.y[y:y + 4, x:x + 4] = out[0]
            dec.u[cy:cy + 2, cx:cx + 2] = out[1]
            dec.v[cy:cy + 2, cx:cx + 2] = out[2]
    # luma residual
    _luma_residual_mb(dec, mbx, mby)
    # chroma residual
    for pl, co in ((dec.u, dec.coeff_u), (dec.v, dec.coeff_v)):
        for dy in range(2):
            for dx in range(2):
                _add_residual(pl, mbx * 8 + dx * 4, mby * 8 + dy * 4,
                              co[mby * 2 + dy, mbx * 2 + dx],
                              (1 << dec.bd) - 1)


def _recon_intra_mb(dec, mbx, mby):
    bx, by = mbx * 4, mby * 4
    x0, y0 = mbx * 16, mby * 16
    i16 = int(dec.i16_mode[mby, mbx])
    avail_l, avail_t = (bool(f) for f in dec.mb_nbr_avail[mby, mbx])
    if dec.trans8[mby, mbx]:
        for dx8, dy8 in _BLK8_XY:
            bx8, by8 = mbx * 2 + dx8, mby * 2 + dy8
            px, py = bx8 * 8, by8 * 8
            al, at, atr, atl = (bool(f)
                                for f in dec.blk8_avail[by8, bx8])
            pred = recon.pred8x8(dec.y, px, py,
                                 int(dec.i8_pred[by8, bx8]),
                                 al, at, atr, atl, bd=dec.bd)
            dec.y[py:py + 8, px:px + 8] = \
                np.clip(pred, 0, (1 << dec.bd) - 1).astype(dec.y.dtype)
            blk = dec.coeff8_y[by8, bx8]
            if blk.any():
                _add_residual8(dec.y, px, py, blk,
                               (1 << dec.bd) - 1)
        _recon_intra_chroma(dec, mbx, mby, avail_l, avail_t)
        return
    if i16 >= 0:
        pred = recon.pred16x16(dec.y, x0, y0, i16, avail_l, avail_t,
                               bd=dec.bd)
        dec.y[y0:y0 + 16, x0:x0 + 16] = \
            np.clip(pred, 0, (1 << dec.bd) - 1).astype(dec.y.dtype)
        for sy in range(4):
            for sx in range(4):
                _add_residual(dec.y, x0 + sx * 4, y0 + sy * 4,
                              dec.coeff_y[by + sy, bx + sx],
                              (1 << dec.bd) - 1)
    else:
        for blk in range(16):
            dx, dy = _BLK_XY[blk]
            bx4, by4 = bx + dx, by + dy
            px, py = x0 + dx * 4, y0 + dy * 4
            al, at, atr, atl = (bool(f) for f in dec.blk_avail[by4, bx4])
            pred = recon.pred4x4(dec.y, px, py, int(dec.i4_pred[by4, bx4]),
                                 al, at, atr, atl, bd=dec.bd)
            dec.y[py:py + 4, px:px + 4] = \
                np.clip(pred, 0, (1 << dec.bd) - 1).astype(dec.y.dtype)
            _add_residual(dec.y, px, py, dec.coeff_y[by4, bx4],
                          (1 << dec.bd) - 1)
    _recon_intra_chroma(dec, mbx, mby, avail_l, avail_t)


def _recon_intra_chroma(dec, mbx, mby, avail_l, avail_t):
    cmode = int(dec.chroma_imode[mby, mbx])
    cx0, cy0 = mbx * 8, mby * 8
    for pl, co in ((dec.u, dec.coeff_u), (dec.v, dec.coeff_v)):
        pred = recon.pred_chroma8x8(pl, cx0, cy0, cmode, avail_l,
                                    avail_t, bd=dec.bd)
        pl[cy0:cy0 + 8, cx0:cx0 + 8] = \
            np.clip(pred, 0, (1 << dec.bd) - 1).astype(pl.dtype)
        for dy in range(2):
            for dx in range(2):
                _add_residual(pl, cx0 + dx * 4, cy0 + dy * 4,
                              co[mby * 2 + dy, mbx * 2 + dx],
                              (1 << dec.bd) - 1)


def reconstruct(dec) -> None:
    """Fill dec.y/u/v from the parse tensors, MB raster order (decode
    order for the supported single-slice-group streams)."""
    sps = dec.sps
    list0 = dec.list0
    if not list0 and dec.ref_frame is not None:
        list0 = [{"planes": dec.ref_frame}]
    list1 = dec.list1
    if not hasattr(dec, "wp"):
        dec.wp = build_weight_arrays(dec, getattr(dec, "last_sh", None))
    for mby in range(sps.mb_height):
        for mbx in range(sps.mb_width):
            if not dec.mb_avail[mby, mbx]:
                continue
            if dec.is_pcm[mby, mbx]:
                py_, pu_, pv_ = dec.pcm[mby * sps.mb_width + mbx]
                dec.y[mby * 16:mby * 16 + 16,
                      mbx * 16:mbx * 16 + 16] = py_
                dec.u[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = pu_
                dec.v[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = pv_
            elif dec.mb_intra[mby, mbx]:
                _recon_intra_mb(dec, mbx, mby)
            else:
                _recon_inter_mb(dec, mbx, mby, list0, list1)
