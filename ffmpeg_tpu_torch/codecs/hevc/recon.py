"""HEVC intra prediction + inverse transforms, exact integer math
(spec 8.4.4/8.6; reference: libavcodec/hevc/pred_template.c,
dsp_template.c). numpy host implementation.

The port's copy of ffmpeg_tpu/codecs/hevc/recon.py, held equal to it by
tests/test_torch_hevc_host.py."""

from __future__ import annotations

import numpy as np

from . import tables as T


def _clip16(x):
    return np.clip(x, -32768, 32767)


def idct(coef: np.ndarray, bd: int = 8) -> np.ndarray:
    """Inverse DCT-II, any size in {4, 8, 16, 32}. coef: (n, n) int.
    Two passes: vertical (shift 7) then horizontal (shift 20 - bd),
    int16 clipping between and after (dsp_template.c IDCT)."""
    n = coef.shape[0]
    t = {4: T.T4, 8: T.T8, 16: T.T16, 32: T.T32}[n].astype(np.int64)
    c = coef.astype(np.int64)
    sh2 = 20 - bd
    tmp = _clip16((t.T @ c + 64) >> 7)
    return _clip16((tmp @ t + (1 << (sh2 - 1))) >> sh2)


def idst4(coef: np.ndarray, bd: int = 8) -> np.ndarray:
    """4x4 inverse DST-VII (intra luma 4x4; transform_4x4_luma)."""
    s = T.DST4.astype(np.int64)
    c = coef.astype(np.int64)
    sh2 = 20 - bd
    tmp = _clip16((s.T @ c + 64) >> 7)
    return _clip16((tmp @ s + (1 << (sh2 - 1))) >> sh2)


def dequant_factors(qp: int, log2_size: int, bd: int = 8):
    """→ (scale, shift, add): level' = clip16((level*scale*16+add)>>shift)
    for flat scaling (spec 8.6.3 with m = 16)."""
    shift = bd + log2_size - 5
    add = 1 << (shift - 1)
    scale = T.LEVEL_SCALE[qp % 6] << (qp // 6)
    return scale, shift, add


def chroma_qp(qp_y: int, offset: int, bd: int = 8) -> int:
    qp_i = max(-6 * (bd - 8), min(57, qp_y + offset))
    if qp_i < 30:
        return qp_i
    if qp_i > 43:
        return qp_i - 6
    return T.QP_C[qp_i - 30]


# ---------------------------------------------------------------------------
# reference sample array construction (pred_template.c intra_pred):
# left[-1..2n-1] / top[-1..2n-1] with ffmpeg's substitution cascade.


def build_refs(plane, x, y, size, cand_l, cand_bl, cand_t, cand_tr,
               cand_tl, pic_w, pic_h, bd: int = 8):
    """→ (left, top) int arrays of length 2*size+1; index 0 is the
    corner sample (-1, -1), entries 1.. are the side samples."""
    n = size
    dc_fill = 1 << (bd - 1)
    left = np.zeros(2 * n + 1, np.int64)
    top = np.zeros(2 * n + 1, np.int64)
    p = plane
    bl_size = min(y + 2 * n, pic_h) - (y + n)
    tr_size = min(x + 2 * n, pic_w) - (x + n)
    if cand_tl:
        left[0] = top[0] = int(p[y - 1, x - 1])
    if cand_t:
        top[1:n + 1] = p[y - 1, x:x + n]
    if cand_tr:
        top[n + 1:n + 1 + tr_size] = p[y - 1, x + n:x + n + tr_size]
        top[n + 1 + tr_size:] = top[n + tr_size]
    if cand_l:
        left[1:n + 1] = p[y:y + n, x - 1]
    if cand_bl:
        left[n + 1:n + 1 + bl_size] = p[y + n:y + n + bl_size, x - 1]
        left[n + 1 + bl_size:] = left[n + bl_size]

    # substitution cascade (pred_template.c "Infer the unavailable")
    if not cand_bl:
        if cand_l:
            left[n + 1:] = left[n]
        elif cand_tl:
            left[1:] = left[0]
            cand_l = True
        elif cand_t:
            left[0] = top[1]
            left[1:] = left[0]
            cand_tl = cand_l = True
        elif cand_tr:
            top[1:n + 1] = top[n + 1]
            left[0] = top[n + 1]
            left[1:] = left[0]
            cand_t = cand_tl = cand_l = True
        else:
            left[0] = dc_fill
            top[:] = dc_fill
            left[:] = dc_fill
    if not cand_l:
        left[1:n + 1] = left[n + 1]
    if not cand_tl:
        left[0] = left[1]
    if not cand_t:
        top[1:n + 1] = left[0]
    if not cand_tr:
        top[n + 1:] = top[n]
    top[0] = left[0]
    return left, top


def filter_refs(left, top, size, strong_ok, bd: int = 8):
    """[1 2 1] reference smoothing (+ optional 32x32 strong bilinear).
    Arrays are the (2n+1)-layout of build_refs. Returns new arrays."""
    n = size
    if strong_ok:
        threshold = 1 << (bd - 5)
        if abs(int(top[0]) + int(top[2 * n]) - 2 * int(top[n])) < \
                threshold and \
                abs(int(left[0]) + int(left[2 * n]) - 2 * int(left[n])) \
                < threshold:
            ft = np.empty_like(top)
            fl = np.empty_like(left)
            ft[0] = top[0]
            fl[0] = left[0]
            ft[2 * n] = top[2 * n]
            fl[2 * n] = left[2 * n]
            i = np.arange(1, 2 * n)
            ft[1:2 * n] = (
                (64 - i) * int(top[0]) + i * int(top[2 * n]) + 32) >> 6
            fl[1:2 * n] = (
                (64 - i) * int(left[0]) + i * int(left[2 * n]) + 32) >> 6
            return fl, ft
    fl = np.empty_like(left)
    ft = np.empty_like(top)
    # corner: (left[1] + 2*corner + top[1] + 2) >> 2
    fl[0] = ft[0] = (left[1] + 2 * left[0] + top[1] + 2) >> 2
    # interior 3-tap; last sample copied
    fl[1:2 * n] = (left[0:2 * n - 1] + 2 * left[1:2 * n]
                   + left[2:2 * n + 1] + 2) >> 2
    ft[1:2 * n] = (top[0:2 * n - 1] + 2 * top[1:2 * n]
                   + top[2:2 * n + 1] + 2) >> 2
    fl[2 * n] = left[2 * n]
    ft[2 * n] = top[2 * n]
    return fl, ft


def pred_intra(left, top, size, mode, c_idx, bd: int = 8):
    """Prediction block (size, size) int64 from (possibly filtered)
    refs in the (2n+1)-layout."""
    n = size
    pmax = (1 << bd) - 1
    out = np.zeros((n, n), np.int64)
    l = left[1:]                       # l[0..2n-1]
    t = top[1:]
    corner = int(left[0])
    if mode == 0:                      # planar
        xx = np.arange(n)
        yy = np.arange(n)
        out = ((n - 1 - xx)[None, :] * l[:n][:, None]
               + (xx + 1)[None, :] * int(t[n])
               + (n - 1 - yy)[:, None] * t[:n][None, :]
               + (yy + 1)[:, None] * int(l[n]) + n) >> \
            (int(np.log2(n)) + 1)
        return out
    if mode == 1:                      # DC
        dc = (int(l[:n].sum()) + int(t[:n].sum()) + n) >> \
            (int(np.log2(n)) + 1)
        out[:, :] = dc
        if c_idx == 0 and n < 32:
            out[0, 0] = (l[0] + 2 * dc + t[0] + 2) >> 2
            out[0, 1:] = (t[1:n] + 3 * dc + 2) >> 2
            out[1:, 0] = (l[1:n] + 3 * dc + 2) >> 2
        return out
    angle = T.INTRA_PRED_ANGLE[mode - 2]
    # ref[] indexed -n..2n-1 (offset n): main side with corner at -1
    ref = np.zeros(3 * n + 1, np.int64)
    OFF = n
    if mode >= 18:
        ref[OFF - 1] = corner
        ref[OFF:OFF + 2 * n] = t[:2 * n]
        last = (n * angle) >> 5
        if angle < 0 and last < -1:
            # projection onto the side array; xk = -1 lands one slot
            # BELOW the corner in ffmpeg's top[x-1] layout
            inv = T.INV_ANGLE[mode - 11]
            for xk in range(last, 0):
                idx = -1 + ((xk * inv + 128) >> 8)
                ref[OFF + xk - 1] = corner if idx < 0 else l[idx]
        for yy in range(n):
            idx = ((yy + 1) * angle) >> 5
            fact = ((yy + 1) * angle) & 31
            seg = ref[OFF + idx:OFF + idx + n + 1]
            if fact:
                out[yy] = ((32 - fact) * seg[:n] + fact * seg[1:n + 1]
                           + 16) >> 5
            else:
                out[yy] = seg[:n]
        if mode == 26 and c_idx == 0 and n < 32:
            out[:, 0] = np.clip(t[0] + ((l[:n] - corner) >> 1), 0, pmax)
        return out
    ref[OFF - 1] = corner
    ref[OFF:OFF + 2 * n] = l[:2 * n]
    last = (n * angle) >> 5
    if angle < 0 and last < -1:
        inv = T.INV_ANGLE[mode - 11]
        for xk in range(last, 0):
            idx = -1 + ((xk * inv + 128) >> 8)
            ref[OFF + xk - 1] = corner if idx < 0 else t[idx]
    for xx in range(n):
        idx = ((xx + 1) * angle) >> 5
        fact = ((xx + 1) * angle) & 31
        seg = ref[OFF + idx:OFF + idx + n + 1]
        if fact:
            out[:, xx] = ((32 - fact) * seg[:n] + fact * seg[1:n + 1]
                          + 16) >> 5
        else:
            out[:, xx] = seg[:n]
    if mode == 10 and c_idx == 0 and n < 32:
        out[0, :] = np.clip(l[0] + ((t[:n] - corner) >> 1), 0, pmax)
    return out


def smoothing_applies(mode, size, c_idx):
    """spec 8.4.4.2.3 filterFlag (sizes 8..32, luma)."""
    if c_idx != 0 or mode == 1 or size == 4:
        return False
    thresh = {8: 7, 16: 1, 32: 0}[size]
    if mode == 0:
        min_dist = min(abs(0 - 26), abs(0 - 10))
    else:
        min_dist = min(abs(mode - 26), abs(mode - 10))
    return min_dist > thresh
