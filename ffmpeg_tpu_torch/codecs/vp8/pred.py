"""VP8 intra predictors, exact integer math (RFC 6386 §12;
reference: libavcodec/h264pred.c VP8 variants + vp8.c
check_intra_pred*_mode_emuedge). All functions take explicit edge
arrays; the callers fabricate frame-border edges (top=127, left=129)
per the reference's copy_dst/xchg rules.

The port's copy of ffmpeg_tpu/codecs/vp8/pred.py, held equal to it by
tests/test_torch_vp8_webp.py.
"""

from __future__ import annotations

import numpy as np

(VERT, HOR, DC, DDL, DDR, VR, HD, VL, HU, TM,
 VERT_PLAIN, HOR_PLAIN, DC_127, DC_129) = range(14)

# 16x16 / chroma 8x8 modes (h264pred order: DC,HOR?) — VP8 uses
# DC_PRED8x8=0, HOR=1, VERT=2, PLANE(TM)=3 + edge variants
(P_DC, P_HOR, P_VERT, P_TM, P_LEFT_DC, P_TOP_DC, P_DC_128,
 P_DC_127, P_DC_129) = range(9)


def _clip(v):
    return np.clip(v, 0, 255)


def pred4x4(mode, t, tr, l, lt):
    """→ (4,4) int32. t/l: 4-entry top/left, tr: 4-entry top-right,
    lt: corner scalar."""
    out = np.empty((4, 4), np.int32)
    t0, t1, t2, t3 = (int(v) for v in t)
    t4, t5, t6, t7 = (int(v) for v in tr)
    l0, l1, l2, l3 = (int(v) for v in l)
    lt = int(lt)
    if mode == VERT:                      # vertical_vp8: filtered top
        row = [(lt + 2 * t0 + t1 + 2) >> 2, (t0 + 2 * t1 + t2 + 2) >> 2,
               (t1 + 2 * t2 + t3 + 2) >> 2, (t2 + 2 * t3 + t4 + 2) >> 2]
        out[:] = np.asarray(row)[None, :]
    elif mode == VERT_PLAIN:              # h264 vertical
        out[:] = np.asarray([t0, t1, t2, t3])[None, :]
    elif mode == HOR:                     # horizontal_vp8: filtered
        col = [(lt + 2 * l0 + l1 + 2) >> 2, (l0 + 2 * l1 + l2 + 2) >> 2,
               (l1 + 2 * l2 + l3 + 2) >> 2, (l2 + 2 * l3 + l3 + 2) >> 2]
        out[:] = np.asarray(col)[:, None]
    elif mode == HOR_PLAIN:
        out[:] = np.asarray([l0, l1, l2, l3])[:, None]
    elif mode == DC:
        out[:] = (l0 + l1 + l2 + l3 + t0 + t1 + t2 + t3 + 4) >> 3
    elif mode == DC_127:
        out[:] = 127
    elif mode == DC_129:
        out[:] = 129
    elif mode == TM:
        tt = np.asarray([t0, t1, t2, t3])
        ll = np.asarray([l0, l1, l2, l3])
        out[:] = _clip(tt[None, :] + ll[:, None] - lt)
    elif mode == DDL:                     # h264 down_left
        v = [(t0 + t2 + 2 * t1 + 2) >> 2, (t1 + t3 + 2 * t2 + 2) >> 2,
             (t2 + t4 + 2 * t3 + 2) >> 2, (t3 + t5 + 2 * t4 + 2) >> 2,
             (t4 + t6 + 2 * t5 + 2) >> 2, (t5 + t7 + 2 * t6 + 2) >> 2,
             (t6 + 3 * t7 + 2) >> 2]
        for y in range(4):
            for x in range(4):
                out[y, x] = v[x + y]
    elif mode == DDR:
        v = [(l3 + 2 * l2 + l1 + 2) >> 2, (l2 + 2 * l1 + l0 + 2) >> 2,
             (l1 + 2 * l0 + lt + 2) >> 2, (l0 + 2 * lt + t0 + 2) >> 2,
             (lt + 2 * t0 + t1 + 2) >> 2, (t0 + 2 * t1 + t2 + 2) >> 2,
             (t1 + 2 * t2 + t3 + 2) >> 2]
        for y in range(4):
            for x in range(4):
                out[y, x] = v[3 + x - y]
    elif mode == VR:
        out[0, 0] = out[2, 1] = (lt + t0 + 1) >> 1
        out[0, 1] = out[2, 2] = (t0 + t1 + 1) >> 1
        out[0, 2] = out[2, 3] = (t1 + t2 + 1) >> 1
        out[0, 3] = (t2 + t3 + 1) >> 1
        out[1, 0] = out[3, 1] = (l0 + 2 * lt + t0 + 2) >> 2
        out[1, 1] = out[3, 2] = (lt + 2 * t0 + t1 + 2) >> 2
        out[1, 2] = out[3, 3] = (t0 + 2 * t1 + t2 + 2) >> 2
        out[1, 3] = (t1 + 2 * t2 + t3 + 2) >> 2
        out[2, 0] = (lt + 2 * l0 + l1 + 2) >> 2
        out[3, 0] = (l0 + 2 * l1 + l2 + 2) >> 2
    elif mode == VL:                      # vertical_left_vp8
        out[0, 0] = (t0 + t1 + 1) >> 1
        out[0, 1] = out[2, 0] = (t1 + t2 + 1) >> 1
        out[0, 2] = out[2, 1] = (t2 + t3 + 1) >> 1
        out[0, 3] = out[2, 2] = (t3 + t4 + 1) >> 1
        out[1, 0] = (t0 + 2 * t1 + t2 + 2) >> 2
        out[1, 1] = out[3, 0] = (t1 + 2 * t2 + t3 + 2) >> 2
        out[1, 2] = out[3, 1] = (t2 + 2 * t3 + t4 + 2) >> 2
        out[1, 3] = out[3, 2] = (t3 + 2 * t4 + t5 + 2) >> 2
        out[2, 3] = (t4 + 2 * t5 + t6 + 2) >> 2
        out[3, 3] = (t5 + 2 * t6 + t7 + 2) >> 2
    elif mode == HD:
        out[0, 0] = out[1, 2] = (lt + l0 + 1) >> 1
        out[0, 1] = out[1, 3] = (l0 + 2 * lt + t0 + 2) >> 2
        out[0, 2] = (lt + 2 * t0 + t1 + 2) >> 2
        out[0, 3] = (t0 + 2 * t1 + t2 + 2) >> 2
        out[1, 0] = out[2, 2] = (l0 + l1 + 1) >> 1
        out[1, 1] = out[2, 3] = (lt + 2 * l0 + l1 + 2) >> 2
        out[2, 0] = out[3, 2] = (l1 + l2 + 1) >> 1
        out[2, 1] = out[3, 3] = (l0 + 2 * l1 + l2 + 2) >> 2
        out[3, 0] = (l2 + l3 + 1) >> 1
        out[3, 1] = (l1 + 2 * l2 + l3 + 2) >> 2
    elif mode == HU:
        out[0, 0] = (l0 + l1 + 1) >> 1
        out[0, 1] = (l0 + 2 * l1 + l2 + 2) >> 2
        out[0, 2] = out[1, 0] = (l1 + l2 + 1) >> 1
        out[0, 3] = out[1, 1] = (l1 + 2 * l2 + l3 + 2) >> 2
        out[1, 2] = out[2, 0] = (l2 + l3 + 1) >> 1
        out[1, 3] = out[2, 1] = (l2 + 2 * l3 + l3 + 2) >> 2
        out[2, 2] = out[2, 3] = out[3, 0] = out[3, 1] = out[3, 2] = \
            out[3, 3] = l3
    else:
        raise AssertionError(mode)
    return out


def convert_mode_nxn(mode, mb_x, mb_y):
    """check_intra_pred8x8_mode_emuedge for 16x16/8x8 modes."""
    if mode == P_DC:
        if not mb_x:
            return P_TOP_DC if mb_y else P_DC_128
        return mode if mb_y else P_LEFT_DC
    if mode == P_VERT:
        return P_DC_127 if not mb_y else mode
    if mode == P_HOR:
        return P_DC_129 if not mb_x else mode
    if mode == P_TM:
        if not mb_x:
            return P_VERT if mb_y else P_DC_129
        return mode if mb_y else P_HOR
    return mode


def pred_nxn(mode, plane, y0, x0, n):
    """16x16 / 8x8 whole-block prediction → (n, n) int32 written by
    the caller. plane indexed at (y0, x0)."""
    if mode == P_DC:
        s = int(plane[y0 - 1, x0:x0 + n].astype(np.int32).sum()) + \
            int(plane[y0:y0 + n, x0 - 1].astype(np.int32).sum())
        v = (s + n) >> (n.bit_length())
        return np.full((n, n), v, np.int32)
    if mode == P_LEFT_DC:
        s = int(plane[y0:y0 + n, x0 - 1].astype(np.int32).sum())
        return np.full((n, n), (s + (n >> 1)) >> (n.bit_length() - 1),
                       np.int32)
    if mode == P_TOP_DC:
        s = int(plane[y0 - 1, x0:x0 + n].astype(np.int32).sum())
        return np.full((n, n), (s + (n >> 1)) >> (n.bit_length() - 1),
                       np.int32)
    if mode == P_DC_128:
        return np.full((n, n), 128, np.int32)
    if mode == P_DC_127:
        return np.full((n, n), 127, np.int32)
    if mode == P_DC_129:
        return np.full((n, n), 129, np.int32)
    if mode == P_VERT:
        return np.tile(plane[y0 - 1, x0:x0 + n].astype(np.int32),
                       (n, 1))
    if mode == P_HOR:
        return np.tile(plane[y0:y0 + n, x0 - 1].astype(np.int32)
                       [:, None], (1, n))
    if mode == P_TM:
        lt = int(plane[y0 - 1, x0 - 1])
        top = plane[y0 - 1, x0:x0 + n].astype(np.int32)
        left = plane[y0:y0 + n, x0 - 1].astype(np.int32)
        return _clip(top[None, :] + left[:, None] - lt)
    raise AssertionError(mode)
