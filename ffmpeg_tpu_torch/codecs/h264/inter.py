"""H.264 inter prediction: quarter-pel luma (6-tap Wiener) and eighth-pel
chroma interpolation, exact integer per ITU-T H.264 §8.4.2.2 (reference:
libavcodec/h264qpel_template.c, h264chroma_template.c), plus the median
motion-vector predictor (§8.4.1.3).

The port's copy of ffmpeg_tpu/codecs/h264/inter.py, held equal to it by
tests/test_torch_h264_host.py."""

from __future__ import annotations

import numpy as np


def _gather(ref: np.ndarray, y0: int, x0: int, h: int, w: int) -> np.ndarray:
    """Edge-clamped int-pel region (h, w) starting at (y0, x0)."""
    ys = np.clip(np.arange(y0, y0 + h), 0, ref.shape[0] - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, ref.shape[1] - 1)
    return ref[np.ix_(ys, xs)].astype(np.int64)


def _tap6(a):
    """6-tap (1,-5,20,20,-5,1) along the first axis; len-5 output rows."""
    return (a[:-5] - 5 * a[1:-4] + 20 * a[2:-3] + 20 * a[3:-2]
            - 5 * a[4:-1] + a[5:])


def mc_luma(ref: np.ndarray, mvx: int, mvy: int, x: int, y: int,
            w: int, h: int, bd: int = 8) -> np.ndarray:
    """Motion-compensated (h, w) luma block at quarter-pel mv."""
    maxv = (1 << bd) - 1
    xi, yi = x + (mvx >> 2), y + (mvy >> 2)
    xf, yf = mvx & 3, mvy & 3
    if xf == 0 and yf == 0:
        return _gather(ref, yi, xi, h, w).astype(ref.dtype)
    # padded int-pel region: 2 left/top, 3 right/bottom (+1 for quarter avg)
    pad = _gather(ref, yi - 2, xi - 2, h + 6, w + 6)

    def clip8(v):
        return np.clip(v, 0, maxv)

    # horizontal halfpel rows b at every int row (rows 0..h+5 → need h+6)
    b_full = (_tap6(pad.T).T + 16) >> 5          # (h+6, w+1)
    b_full = clip8(b_full)
    # vertical halfpel h at every int col
    h_full = (_tap6(pad) + 16) >> 5              # (h+1, w+6)
    h_full = clip8(h_full)
    # center j: 6-tap vertically over unnormalized horizontal intermediates
    b1 = _tap6(pad.T).T                          # (h+6, w+1)
    j_full = clip8((_tap6(b1) + 512) >> 10)      # (h+1, w+1)

    G = pad[2:2 + h + 1, 2:2 + w + 1]            # int pels (+1 row/col)
    b = b_full[2:2 + h + 1, :]                   # aligned with G cols
    hh = h_full[:, 2:2 + w + 1]
    j = j_full

    def avg(a, c):
        return (a + c + 1) >> 1

    if yf == 0:                                  # (1..3, 0)
        if xf == 1:
            out = avg(G[:h, :w], b[:h, :w])
        elif xf == 2:
            out = b[:h, :w]
        else:
            out = avg(b[:h, :w], G[:h, 1:w + 1])
    elif xf == 0:                                # (0, 1..3)
        if yf == 1:
            out = avg(G[:h, :w], hh[:h, :w])
        elif yf == 2:
            out = hh[:h, :w]
        else:
            out = avg(hh[:h, :w], G[1:h + 1, :w])
    elif xf == 2:                                # (2, 1..3)
        if yf == 1:
            out = avg(b[:h, :w], j[:h, :w])
        elif yf == 2:
            out = j[:h, :w]
        else:
            out = avg(b[1:h + 1, :w], j[:h, :w])
    elif yf == 2:                                # (1/3, 2)
        if xf == 1:
            out = avg(hh[:h, :w], j[:h, :w])
        else:
            out = avg(hh[:h, 1:w + 1], j[:h, :w])
    else:                                        # diagonal quarters
        bb = b[:h, :w] if yf == 1 else b[1:h + 1, :w]
        hhh = hh[:h, :w] if xf == 1 else hh[:h, 1:w + 1]
        out = avg(bb, hhh)
    return out.astype(ref.dtype)


def mc_chroma(ref: np.ndarray, mvx: int, mvy: int, x: int, y: int,
              w: int, h: int, bd: int = 8) -> np.ndarray:
    """Eighth-pel bilinear chroma (mv in luma quarter units → chroma
    eighth units are the same integer values)."""
    xi, yi = x + (mvx >> 3), y + (mvy >> 3)
    xf, yf = mvx & 7, mvy & 7
    pad = _gather(ref, yi, xi, h + 1, w + 1)
    A = pad[:h, :w]
    B = pad[:h, 1:w + 1]
    C = pad[1:h + 1, :w]
    D = pad[1:h + 1, 1:w + 1]
    out = ((8 - xf) * (8 - yf) * A + xf * (8 - yf) * B +
           (8 - xf) * yf * C + xf * yf * D + 32) >> 6
    return out.astype(ref.dtype)


def median_mv(a, b, c):
    """Component-wise median of three mvs (None = unavailable)."""
    # availability fallback rules are applied by the caller (8.4.1.3.1)
    ax, ay = a
    bx, by = b
    cx, cy = c
    mx = ax + bx + cx - min(ax, bx, cx) - max(ax, bx, cx)
    my = ay + by + cy - min(ay, by, cy) - max(ay, by, cy)
    return mx, my
