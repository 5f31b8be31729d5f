"""H.264 exact-integer transforms and intra prediction (reference:
libavcodec/h264idct_template.c, h264pred_template.c). numpy int32 —
bit-exact per ITU-T H.264 §8.3/§8.5. The batched-residual path is shaped
so the per-MB IDCTs can later move to a fused TPU matmul like mpeg12.

The port's copy of ffmpeg_tpu/codecs/h264/recon.py, held equal to it by
tests/test_torch_h264_host.py."""

from __future__ import annotations

from typing import Optional

import numpy as np

DEQUANT_INIT = [(10, 13, 16), (11, 14, 18), (13, 16, 20),
                (14, 18, 23), (16, 20, 25), (18, 23, 29)]

# zigzag scan for 4x4 (raster index order)
ZIGZAG4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15])

# field scan for 4x4 / 8x8 coefficients in field-coded pictures
# (spec Table 8-12 / 8-13; h264_slice.c:52 field_scan / field_scan8x8)
FIELD4 = np.array([0, 4, 1, 8, 12, 5, 9, 13, 2, 6, 10, 14,
                   3, 7, 11, 15])
FIELD8 = np.array([
    0, 8, 16, 1, 9, 24, 32, 17,
    2, 25, 40, 48, 56, 33, 10, 3,
    18, 41, 49, 57, 26, 11, 4, 19,
    34, 42, 50, 58, 27, 12, 5, 20,
    35, 43, 51, 59, 28, 13, 6, 21,
    36, 44, 52, 60, 29, 14, 22, 37,
    45, 53, 61, 30, 7, 15, 38, 46,
    54, 62, 23, 31, 39, 47, 55, 63])

_V_IDX = np.zeros(16, np.int32)     # raster pos → dequant column 0/1/2
for _x in range(16):
    _V_IDX[_x] = (_x & 1) + ((_x >> 2) & 1)


def dequant4(levels_raster: np.ndarray, qp: int,
             weights: Optional[np.ndarray] = None) -> np.ndarray:
    """levels in raster order (16,) → dequantized block (spec 8.5.9 +
    8.5.12.1 low-qp rounding), with an optional raster scaling list
    (defaults to Flat_16, for which this reduces to (c*v) << qp/6)."""
    v = np.array(DEQUANT_INIT[qp % 6], np.int64)[_V_IDX]
    c = levels_raster.astype(np.int64)
    if weights is None:
        return (c * v) << (qp // 6)
    m = qp // 6
    ls = np.asarray(weights, np.int64) * v
    if m >= 4:
        return (c * ls) << (m - 4)
    return _rshift_round(c * ls, 4 - m)


def _rshift_round(x: np.ndarray, n: int) -> np.ndarray:
    """Spec-style (x + 2^(n-1)) >> n on signed ints (arithmetic)."""
    return (x + (1 << (n - 1))) >> n


# 8x8 dequant normAdjust (spec 8.5.9 Table; libavcodec/h264_ps.c
# dequant8_coeff_init): value class by (y%4, x%4)
_V8_CLASS = np.array([0, 3, 4, 3, 3, 1, 5, 1, 4, 5, 2, 5, 3, 1, 5, 1],
                     np.int64)
_V8_INIT = [[20, 18, 32, 19, 25, 24], [22, 19, 35, 21, 28, 26],
            [26, 23, 42, 24, 33, 31], [28, 25, 45, 26, 35, 33],
            [32, 28, 51, 30, 40, 38], [36, 32, 58, 34, 46, 43]]
_V8 = np.zeros((6, 64), np.int64)
for _m in range(6):
    for _i in range(64):
        _y, _x = _i >> 3, _i & 7
        _V8[_m, _i] = _V8_INIT[_m][_V8_CLASS[(_y % 4) * 4 + (_x % 4)]]


def dequant8(levels_raster: np.ndarray, qp: int,
             weights: Optional[np.ndarray] = None) -> np.ndarray:
    """(64,) raster levels → dequantized 8x8 block (spec 8.5.13.1)."""
    c = levels_raster.astype(np.int64)
    w = np.asarray(weights, np.int64) if weights is not None else 16
    ls = w * _V8[qp % 6]
    m = qp // 6
    if m >= 6:
        return (c * ls) << (m - 6)
    return _rshift_round(c * ls, 6 - m)


def idct8_add(dst: np.ndarray, block: np.ndarray,
              maxv: int = 255) -> None:
    """In-place: dst(8,8) pixels += idct8(block(64,) raster int) — the
    exact integer transform of spec 8.5.12.3 (h264idct8_add)."""
    b = block.astype(np.int64).reshape(8, 8)

    def pass1(x):
        # x: (..., 8) along the transform axis
        a0 = x[0] + x[4]
        a2 = x[0] - x[4]
        a4 = (x[2] >> 1) - x[6]
        a6 = (x[6] >> 1) + x[2]
        b0 = a0 + a6
        b2 = a2 + a4
        b4 = a2 - a4
        b6 = a0 - a6
        a1 = -x[3] + x[5] - x[7] - (x[7] >> 1)
        a3 = x[1] + x[7] - x[3] - (x[3] >> 1)
        a5 = -x[1] + x[7] + x[5] + (x[5] >> 1)
        a7 = x[3] + x[5] + x[1] + (x[1] >> 1)
        b1 = a1 + (a7 >> 2)
        b7 = a7 - (a1 >> 2)
        b3 = a3 + (a5 >> 2)
        b5 = (a3 >> 2) - a5
        return np.stack([b0 + b7, b2 + b5, b4 + b3, b6 + b1,
                         b6 - b1, b4 - b3, b2 - b5, b0 - b7])

    # spec order: horizontal 1-D transform of each row, then vertical
    # (the reference's "vertical-first" loop runs on TRANSPOSED blocks
    # — its 8x8 scan tables are transposed)
    t = pass1([b[:, i] for i in range(8)])       # -> (h_out, row)
    s = pass1([t[:, k] for k in range(8)])       # -> (v_out, h_out)
    r = (s + 32) >> 6
    out = np.clip(dst.astype(np.int64) + r, 0, maxv)
    dst[:] = out.astype(dst.dtype)


def idct4_add(dst: np.ndarray, block: np.ndarray,
              maxv: int = 255) -> None:
    """In-place: dst(4,4) pixels += idct(block(16,) raster int)."""
    b = block.astype(np.int64).reshape(4, 4).copy()
    b[0, 0] += 32
    z0 = b[0] + b[2]
    z1 = b[0] - b[2]
    z2 = (b[1] >> 1) - b[3]
    z3 = b[1] + (b[3] >> 1)
    r = np.stack([z0 + z3, z1 + z2, z1 - z2, z0 - z3])
    z0 = r[:, 0] + r[:, 2]
    z1 = r[:, 0] - r[:, 2]
    z2 = (r[:, 1] >> 1) - r[:, 3]
    z3 = r[:, 1] + (r[:, 3] >> 1)
    out = np.stack([z0 + z3, z1 + z2, z1 - z2, z0 - z3], axis=1) >> 6
    np.clip(dst.astype(np.int64) + out, 0, maxv, out=out)
    dst[:] = out.astype(dst.dtype)


def luma_dc_transform(dc_levels: np.ndarray, qp: int,
                      w0: int = 16) -> np.ndarray:
    """4x4 Hadamard + dequant for Intra16x16 DC (spec 8.5.10); levels in
    raster order → per-4x4-block DC values (4,4). w0 = scaling list
    entry 0 (16 for the flat default)."""
    b = dc_levels.astype(np.int64).reshape(4, 4)
    h = np.array([[1, 1, 1, 1], [1, 1, -1, -1],
                  [1, -1, -1, 1], [1, -1, 1, -1]], np.int64)
    t = h @ b @ h.T
    qmul = (DEQUANT_INIT[qp % 6][0] * int(w0)) << (qp // 6 + 2)
    return (t * qmul + 128) >> 8


def chroma_dc_transform(dc_levels: np.ndarray, qp: int,
                        w0: int = 16) -> np.ndarray:
    """2x2 transform + dequant (spec 8.5.11)."""
    b = dc_levels.astype(np.int64).reshape(2, 2)
    t = np.array([[b[0, 0] + b[0, 1] + b[1, 0] + b[1, 1],
                   b[0, 0] - b[0, 1] + b[1, 0] - b[1, 1]],
                  [b[0, 0] + b[0, 1] - b[1, 0] - b[1, 1],
                   b[0, 0] - b[0, 1] - b[1, 0] + b[1, 1]]], np.int64)
    qmul = (DEQUANT_INIT[qp % 6][0] * int(w0)) << (qp // 6 + 2)
    return (t * qmul) >> 7


# ---------------------------------------------------------------------------
# Intra prediction.  All functions take the plane, position and
# availability flags, returning the predicted block.

def pred4x4(plane, x, y, mode, avail_l, avail_t, avail_tr,
            avail_tl, bd=8):
    # invalid streams can request a mode whose reference samples are
    # unavailable (the reference errors the slice; we conceal with DC)
    if (not avail_l and mode in (1, 4, 5, 6, 8)) or \
            (not avail_t and mode in (0, 3, 4, 5, 6, 7)):
        mode = 2
    p = plane.astype(np.int32)
    left = p[y:y + 4, x - 1] if avail_l else None
    top = p[y - 1, x:x + 4] if avail_t else None
    tl = int(p[y - 1, x - 1]) if avail_tl else None
    if avail_t:
        if avail_tr:
            tr = p[y - 1, x + 4:x + 8]
            if len(tr) < 4:
                tr = np.concatenate([tr, np.full(4 - len(tr), top[3])])
        else:
            tr = np.full(4, top[3], np.int32)
        t8 = np.concatenate([top, tr])
    if mode == 0:                                  # vertical
        return np.tile(top, (4, 1))
    if mode == 1:                                  # horizontal
        return np.tile(left[:, None], (1, 4))
    if mode == 2:                                  # DC
        if avail_l and avail_t:
            dc = (int(left.sum()) + int(top.sum()) + 4) >> 3
        elif avail_l:
            dc = (int(left.sum()) + 2) >> 2
        elif avail_t:
            dc = (int(top.sum()) + 2) >> 2
        else:
            dc = 1 << (bd - 1)
        return np.full((4, 4), dc, np.int32)
    out = np.zeros((4, 4), np.int32)
    if mode == 3:                                  # diagonal down-left
        for j in range(4):
            for i in range(4):
                k = i + j
                if k == 6:
                    out[j, i] = (t8[6] + 3 * t8[7] + 2) >> 2
                else:
                    out[j, i] = (t8[k] + 2 * t8[k + 1] + t8[k + 2] + 2) >> 2
        return out
    # spec-style reference accessors: t(-1) == l(-1) == top-left sample
    def t(k):
        return tl if k < 0 else int(t8[k])

    def l(k):
        return tl if k < 0 else int(left[k])

    if mode == 4:                                  # diagonal down-right
        for j in range(4):
            for i in range(4):
                if i > j:
                    out[j, i] = (t(i - j - 2) + 2 * t(i - j - 1)
                                 + t(i - j) + 2) >> 2
                elif i < j:
                    out[j, i] = (l(j - i - 2) + 2 * l(j - i - 1)
                                 + l(j - i) + 2) >> 2
                else:
                    out[j, i] = (t(0) + 2 * tl + l(0) + 2) >> 2
        return out
    if mode == 5:                                  # vertical-right (8.3.1.2.6)
        for j in range(4):
            for i in range(4):
                z = 2 * i - j
                if z >= 0 and z % 2 == 0:
                    k = i - (j >> 1)
                    out[j, i] = (t(k - 1) + t(k) + 1) >> 1
                elif z > 0:
                    k = i - (j >> 1)
                    out[j, i] = (t(k - 2) + 2 * t(k - 1) + t(k) + 2) >> 2
                elif z == -1:
                    out[j, i] = (l(0) + 2 * tl + t(0) + 2) >> 2
                else:
                    k = j - 2 * i
                    out[j, i] = (l(k - 1) + 2 * l(k - 2) + l(k - 3) + 2) >> 2
        return out
    if mode == 6:                                  # horizontal-down (8.3.1.2.7)
        for j in range(4):
            for i in range(4):
                z = 2 * j - i
                if z >= 0 and z % 2 == 0:
                    k = j - (i >> 1)
                    out[j, i] = (l(k - 1) + l(k) + 1) >> 1
                elif z > 0:
                    k = j - (i >> 1)
                    out[j, i] = (l(k - 2) + 2 * l(k - 1) + l(k) + 2) >> 2
                elif z == -1:
                    out[j, i] = (t(0) + 2 * tl + l(0) + 2) >> 2
                else:
                    k = i - 2 * j
                    out[j, i] = (t(k - 1) + 2 * t(k - 2) + t(k - 3) + 2) >> 2
        return out
    if mode == 7:                                  # vertical-left
        for j in range(4):
            for i in range(4):
                k = i + (j >> 1)
                if j % 2 == 0:
                    out[j, i] = (t8[k] + t8[k + 1] + 1) >> 1
                else:
                    out[j, i] = (t8[k] + 2 * t8[k + 1] + t8[k + 2] + 2) >> 2
        return out
    if mode == 8:                                  # horizontal-up
        for j in range(4):
            for i in range(4):
                z = i + 2 * j
                if z > 5:
                    out[j, i] = left[3]
                elif z == 5:
                    out[j, i] = (left[2] + 3 * left[3] + 2) >> 2
                elif z % 2 == 0:
                    out[j, i] = (left[j + (i >> 1)] +
                                 left[j + (i >> 1) + 1] + 1) >> 1
                else:
                    out[j, i] = (left[j + (i >> 1)] +
                                 2 * left[j + (i >> 1) + 1] +
                                 left[j + (i >> 1) + 2] + 2) >> 2
        return out
    raise ValueError(f"bad intra4x4 mode {mode}")


def filter_ref8(left, top, tl, avail_l, avail_t, avail_tr, avail_tl):
    """Reference sample filtering for Intra_8x8 (spec 8.3.2.2.1).
    left: (8,) int or None; top: (16,) int (tr half replicated from
    top[7] when avail_tr is False) or None; tl: int or None.
    Returns (left', top', tl')."""
    lf = tf = tlf = None
    if avail_t:
        t = top.astype(np.int64)
        tf = np.empty(16, np.int64)
        if avail_tl:
            tf[0] = (tl + 2 * t[0] + t[1] + 2) >> 2
        else:
            tf[0] = (3 * t[0] + t[1] + 2) >> 2
        tf[1:15] = (t[0:14] + 2 * t[1:15] + t[2:16] + 2) >> 2
        tf[15] = (t[14] + 3 * t[15] + 2) >> 2
    if avail_tl:
        if avail_t and avail_l:
            tlf = (top[0] + 2 * tl + left[0] + 2) >> 2
        elif avail_t:
            tlf = (3 * tl + top[0] + 2) >> 2
        elif avail_l:
            tlf = (3 * tl + left[0] + 2) >> 2
        else:
            tlf = tl
    if avail_l:
        ll = left.astype(np.int64)
        lf = np.empty(8, np.int64)
        if avail_tl:
            lf[0] = (tl + 2 * ll[0] + ll[1] + 2) >> 2
        else:
            lf[0] = (3 * ll[0] + ll[1] + 2) >> 2
        lf[1:7] = (ll[0:6] + 2 * ll[1:7] + ll[2:8] + 2) >> 2
        lf[7] = (ll[6] + 3 * ll[7] + 2) >> 2
    return lf, tf, tlf


def pred8x8(plane, x, y, mode, avail_l, avail_t, avail_tr,
            avail_tl, bd=8):
    """Intra_8x8 luma prediction (spec 8.3.2.2.2-8.3.2.2.10) on
    FILTERED reference samples."""
    # invalid streams can request a mode whose reference samples are
    # unavailable (the reference errors the slice; we conceal with DC)
    if (not avail_l and mode in (1, 4, 5, 6, 8)) or \
            (not avail_t and mode in (0, 3, 4, 5, 6, 7)):
        mode = 2
    p = plane.astype(np.int64)
    raw_l = p[y:y + 8, x - 1] if avail_l else None
    raw_tl = int(p[y - 1, x - 1]) if avail_tl else None
    raw_t = None
    if avail_t:
        t8 = p[y - 1, x:x + 8]
        if avail_tr:
            tr = p[y - 1, x + 8:x + 16]
            if len(tr) < 8:
                tr = np.concatenate([tr, np.full(8 - len(tr), t8[7])])
        else:
            tr = np.full(8, t8[7], np.int64)
        raw_t = np.concatenate([t8, tr])
    left, top, tl = filter_ref8(raw_l, raw_t, raw_tl,
                                avail_l, avail_t, avail_tr, avail_tl)
    out = np.zeros((8, 8), np.int64)
    if mode == 0:                                  # vertical
        return np.tile(top[:8], (8, 1))
    if mode == 1:                                  # horizontal
        return np.tile(left[:, None], (1, 8))
    if mode == 2:                                  # DC
        if avail_l and avail_t:
            dc = (int(left.sum()) + int(top[:8].sum()) + 8) >> 4
        elif avail_l:
            dc = (int(left.sum()) + 4) >> 3
        elif avail_t:
            dc = (int(top[:8].sum()) + 4) >> 3
        else:
            dc = 1 << (bd - 1)
        return np.full((8, 8), dc, np.int64)

    def t(k):
        return tl if k < 0 else int(top[k])

    def l(k):
        return tl if k < 0 else int(left[k])

    for j in range(8):
        for i in range(8):
            if mode == 3:                          # diagonal down-left
                k = i + j
                if k == 14:
                    out[j, i] = (t(14) + 3 * t(15) + 2) >> 2
                else:
                    out[j, i] = (t(k) + 2 * t(k + 1) + t(k + 2) + 2) >> 2
            elif mode == 4:                        # diagonal down-right
                if i > j:
                    k = i - j
                    out[j, i] = (t(k - 2) + 2 * t(k - 1) + t(k) + 2) >> 2
                elif i < j:
                    k = j - i
                    out[j, i] = (l(k - 2) + 2 * l(k - 1) + l(k) + 2) >> 2
                else:
                    out[j, i] = (t(0) + 2 * tl + l(0) + 2) >> 2
            elif mode == 5:                        # vertical-right
                z = 2 * i - j
                k = i - (j >> 1)
                if z >= 0 and z % 2 == 0:
                    out[j, i] = (t(k - 1) + t(k) + 1) >> 1
                elif z > 0:
                    out[j, i] = (t(k - 2) + 2 * t(k - 1) + t(k) + 2) >> 2
                elif z == -1:
                    out[j, i] = (l(0) + 2 * tl + t(0) + 2) >> 2
                else:
                    k = j - 2 * i
                    out[j, i] = (l(k - 1) + 2 * l(k - 2) + l(k - 3) + 2) >> 2
            elif mode == 6:                        # horizontal-down
                z = 2 * j - i
                k = j - (i >> 1)
                if z >= 0 and z % 2 == 0:
                    out[j, i] = (l(k - 1) + l(k) + 1) >> 1
                elif z > 0:
                    out[j, i] = (l(k - 2) + 2 * l(k - 1) + l(k) + 2) >> 2
                elif z == -1:
                    out[j, i] = (t(0) + 2 * tl + l(0) + 2) >> 2
                else:
                    k = i - 2 * j
                    out[j, i] = (t(k - 1) + 2 * t(k - 2) + t(k - 3) + 2) >> 2
            elif mode == 7:                        # vertical-left
                k = i + (j >> 1)
                if j % 2 == 0:
                    out[j, i] = (t(k) + t(k + 1) + 1) >> 1
                else:
                    out[j, i] = (t(k) + 2 * t(k + 1) + t(k + 2) + 2) >> 2
            elif mode == 8:                        # horizontal-up
                z = i + 2 * j
                if z > 13:
                    out[j, i] = l(7)
                elif z == 13:
                    out[j, i] = (l(6) + 3 * l(7) + 2) >> 2
                elif z % 2 == 0:
                    k = j + (i >> 1)
                    out[j, i] = (l(k) + l(k + 1) + 1) >> 1
                else:
                    k = j + (i >> 1)
                    out[j, i] = (l(k) + 2 * l(k + 1) + l(k + 2) + 2) >> 2
            else:
                raise ValueError(f"bad intra8x8 mode {mode}")
    return out


def pred16x16(plane, x, y, mode, avail_l, avail_t, bd=8):
    p = plane.astype(np.int32)
    if mode == 0:                                  # vertical
        return np.tile(p[y - 1, x:x + 16], (16, 1))
    if mode == 1:                                  # horizontal
        return np.tile(p[y:y + 16, x - 1][:, None], (1, 16))
    if mode == 2:                                  # DC
        if avail_l and avail_t:
            dc = (int(p[y:y + 16, x - 1].sum()) +
                  int(p[y - 1, x:x + 16].sum()) + 16) >> 5
        elif avail_l:
            dc = (int(p[y:y + 16, x - 1].sum()) + 8) >> 4
        elif avail_t:
            dc = (int(p[y - 1, x:x + 16].sum()) + 8) >> 4
        else:
            dc = 1 << (bd - 1)
        return np.full((16, 16), dc, np.int32)
    # plane (mode 3)
    top = p[y - 1, x - 1:x + 16].astype(np.int64)
    left = p[y - 1:y + 16, x - 1].astype(np.int64)
    h = sum((i + 1) * (int(top[9 + i]) - int(top[7 - i])) for i in range(8))
    v = sum((i + 1) * (int(left[9 + i]) - int(left[7 - i])) for i in range(8))
    a = 16 * (int(left[16]) + int(top[16]))
    b = (5 * h + 32) >> 6
    c = (5 * v + 32) >> 6
    jj, ii = np.mgrid[0:16, 0:16]
    out = (a + b * (ii - 7) + c * (jj - 7) + 16) >> 5
    return np.clip(out, 0, (1 << bd) - 1)


def pred_chroma8x8(plane, x, y, mode, avail_l, avail_t, bd=8):
    p = plane.astype(np.int32)
    if mode == 1:                                  # horizontal
        return np.tile(p[y:y + 8, x - 1][:, None], (1, 8))
    if mode == 2:                                  # vertical
        return np.tile(p[y - 1, x:x + 8], (8, 1))
    if mode == 3:                                  # plane
        top = p[y - 1, x - 1:x + 8].astype(np.int64)
        left = p[y - 1:y + 8, x - 1].astype(np.int64)
        h = sum((i + 1) * (int(top[5 + i]) - int(top[3 - i]))
                for i in range(4))
        v = sum((i + 1) * (int(left[5 + i]) - int(left[3 - i]))
                for i in range(4))
        a = 16 * (int(left[8]) + int(top[8]))
        b = (17 * h + 16) >> 5
        c = (17 * v + 16) >> 5
        jj, ii = np.mgrid[0:8, 0:8]
        return np.clip((a + b * (ii - 3) + c * (jj - 3) + 16) >> 5,
                       0, (1 << bd) - 1)
    # DC (mode 0): per-4x4 quadrant rules (spec 8.3.4.1)
    out = np.zeros((8, 8), np.int32)
    for qy in range(2):
        for qx in range(2):
            tsum = int(p[y - 1, x + qx * 4:x + qx * 4 + 4].sum()) \
                if avail_t else None
            lsum = int(p[y + qy * 4:y + qy * 4 + 4, x - 1].sum()) \
                if avail_l else None
            if qx == qy:        # corner blocks use both when available
                if tsum is not None and lsum is not None:
                    dc = (tsum + lsum + 4) >> 3
                elif tsum is not None:
                    dc = (tsum + 2) >> 2
                elif lsum is not None:
                    dc = (lsum + 2) >> 2
                else:
                    dc = 1 << (bd - 1)
            elif qx == 1:       # top-right prefers top
                if tsum is not None:
                    dc = (tsum + 2) >> 2
                elif lsum is not None:
                    dc = (lsum + 2) >> 2
                else:
                    dc = 1 << (bd - 1)
            else:               # bottom-left prefers left
                if lsum is not None:
                    dc = (lsum + 2) >> 2
                elif tsum is not None:
                    dc = (tsum + 2) >> 2
                else:
                    dc = 1 << (bd - 1)
            out[qy * 4:qy * 4 + 4, qx * 4:qx * 4 + 4] = dc
    return out
