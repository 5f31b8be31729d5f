"""VP8 inter prediction: 6/4-tap sub-pel MC with edge emulation and
the split-MV chroma averaging rules, exact integer math (RFC 6386
§18; reference: libavcodec/vp8dsp.c put_vp8_epel* + vp8.c
vp8_mc_luma/chroma/part, inter_predict).

The port's copy of ffmpeg_tpu/codecs/vp8/mc.py, held equal to it by
tests/test_torch_vp8_webp.py.
"""

from __future__ import annotations

import numpy as np

# subpel_filters[phase-1][6] (vp8dsp.c); phase 0 = copy
FILTERS = np.array([
    [0, 6, 123, 12, 1, 0],
    [2, 11, 108, 36, 8, 1],
    [0, 9, 93, 50, 6, 0],
    [3, 16, 77, 77, 16, 3],
    [0, 6, 50, 93, 9, 0],
    [1, 8, 36, 108, 11, 2],
    [0, 1, 12, 123, 6, 0],
], np.int64)

# number of left/total-extra/right extra pixels per phase
SUB_IDX = np.array([[0, 1, 2, 1, 2, 1, 2, 1],
                    [0, 3, 5, 3, 5, 3, 5, 3],
                    [0, 2, 3, 2, 3, 2, 3, 2]], np.int32)


def _tap(win, phase, axis, n_out, four):
    """Apply the 6- or 4-tap filter along axis; win already offset so
    the first needed sample is at index 0."""
    F = FILTERS[phase - 1]
    acc = np.zeros((n_out, win.shape[1]) if axis == 0
                   else (win.shape[0], n_out), np.int64)
    taps = ((1, -F[1]), (2, F[2]), (3, F[3]), (4, -F[4])) if four \
        else ((0, F[0]), (1, -F[1]), (2, F[2]), (3, F[3]),
              (4, -F[4]), (5, F[5]))
    base = 1 if four else 0
    for k, w in taps:
        kk = k - base
        if axis == 0:
            acc += w * win[kk:kk + n_out, :].astype(np.int64)
        else:
            acc += w * win[:, kk:kk + n_out].astype(np.int64)
    return np.clip((acc + 64) >> 7, 0, 255)


def mc_block(dst, dy, dx, bh, bw, ref, y, x, mvx, mvy, shift, w, h):
    """One MC block: shift 2 for luma (phase=(mv*2)&7), 3 for chroma
    (phase=mv&7). w,h: padded plane dims (MB multiples)."""
    if mvx == 0 and mvy == 0:
        rows = np.clip(np.arange(y, y + bh), 0, h - 1)
        cols = np.clip(np.arange(x, x + bw), 0, w - 1)
        dst[dy:dy + bh, dx:dx + bw] = ref[np.ix_(rows, cols)]
        return
    if shift == 2:
        px = (mvx * 2) & 7
        py = (mvy * 2) & 7
    else:
        px = mvx & 7
        py = mvy & 7
    x = x + (mvx >> shift)
    y = y + (mvy >> shift)
    if px == 0 and py == 0:               # full-pel motion: copy
        rows = np.clip(np.arange(y, y + bh), 0, h - 1)
        cols = np.clip(np.arange(x, x + bw), 0, w - 1)
        dst[dy:dy + bh, dx:dx + bw] = ref[np.ix_(rows, cols)]
        return
    lx = int(SUB_IDX[0][px])              # left extra (also tap sel)
    ly = int(SUB_IDX[0][py])
    ex = int(SUB_IDX[1][px])              # total extra
    ey = int(SUB_IDX[1][py])
    rows = np.clip(np.arange(y - ly, y + bh + (ey - ly)), 0, h - 1)
    cols = np.clip(np.arange(x - lx, x + bw + (ex - lx)), 0, w - 1)
    win = ref[np.ix_(rows, cols)].astype(np.int64)
    if px and py:
        # horizontal into a clamped uint8 tmp, then vertical
        tmp = _tap(win, px, 1, bw, lx == 1)
        out = _tap(tmp, py, 0, bh, ly == 1)
    elif px:
        out = _tap(win, px, 1, bw, lx == 1)
    else:
        out = _tap(win, py, 0, bh, ly == 1)
    dst[dy:dy + bh, dx:dx + bw] = out.astype(np.uint8)


def _uv_avg(bmv, y, x):
    sx = sum(bmv[(2 * y + dy) * 4 + 2 * x + dx][0]
             for dy in (0, 1) for dx in (0, 1))
    sy = sum(bmv[(2 * y + dy) * 4 + 2 * x + dx][1]
             for dy in (0, 1) for dx in (0, 1))

    def rnd(v):
        return (v + 2 + (-1 if v < 0 else 0)) >> 2
    return rnd(sx), rnd(sy)


def mc_part(fs, ref, x_off, y_off, bx, by, bw, bh, mv):
    """vp8_mc_part: one luma部分 + its chroma."""
    ry, ru, rv = ref
    w, h = fs.mb_w * 16, fs.mb_h * 16
    mc_block(fs.y, y_off + by, x_off + bx, bh, bw, ry,
             y_off + by, x_off + bx, mv[0], mv[1], 2, w, h)
    xc, yc = (x_off >> 1) + (bx >> 1), (y_off >> 1) + (by >> 1)
    for dstp, refp in ((fs.u, ru), (fs.v, rv)):
        mc_block(dstp, yc, xc, bh >> 1, bw >> 1, refp, yc, xc,
                 mv[0], mv[1], 3, w >> 1, h >> 1)


def inter_predict(fs, mb, ref, mb_x, mb_y):
    """vp8.c inter_predict."""
    x_off, y_off = mb_x * 16, mb_y * 16
    part = mb["partitioning"]
    bmv = mb["bmv"]
    if part == 4:                         # SPLITMVMODE_NONE
        mc_part(fs, ref, x_off, y_off, 0, 0, 16, 16, mb["mv"])
    elif part == 3:                       # 4x4
        ry, ru, rv = ref
        w, h = fs.mb_w * 16, fs.mb_h * 16
        for y in range(4):
            for x in range(4):
                mv = bmv[4 * y + x]
                mc_block(fs.y, y_off + 4 * y, x_off + 4 * x, 4, 4,
                         ry, y_off + 4 * y, x_off + 4 * x,
                         mv[0], mv[1], 2, w, h)
        for y in range(2):
            for x in range(2):
                uvmv = _uv_avg(bmv, y, x)
                for dstp, refp in ((fs.u, ru), (fs.v, rv)):
                    mc_block(dstp, (y_off >> 1) + 4 * y,
                             (x_off >> 1) + 4 * x, 4, 4, refp,
                             (y_off >> 1) + 4 * y, (x_off >> 1) + 4 * x,
                             uvmv[0], uvmv[1], 3, w >> 1, h >> 1)
    elif part == 0:                       # 16x8
        mc_part(fs, ref, x_off, y_off, 0, 0, 16, 8, bmv[0])
        mc_part(fs, ref, x_off, y_off, 0, 8, 16, 8, bmv[1])
    elif part == 1:                       # 8x16
        mc_part(fs, ref, x_off, y_off, 0, 0, 8, 16, bmv[0])
        mc_part(fs, ref, x_off, y_off, 8, 0, 8, 16, bmv[1])
    else:                                 # 8x8
        mc_part(fs, ref, x_off, y_off, 0, 0, 8, 8, bmv[0])
        mc_part(fs, ref, x_off, y_off, 8, 0, 8, 8, bmv[1])
        mc_part(fs, ref, x_off, y_off, 0, 8, 8, 8, bmv[2])
        mc_part(fs, ref, x_off, y_off, 8, 8, 8, 8, bmv[3])
