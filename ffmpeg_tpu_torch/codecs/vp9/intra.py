"""VP9 intra predictors, exact integer math (VP9 spec §8.5.2;
reference: libavcodec/vp9dsp_template.c). Convention mirrors the
reference: `top` is indexed 0..2n-1 with top[-1] the corner (passed
separately as `tl`); `left` holds the left column BOTTOM-UP
(left[n-1-y] = pixel at row y) except HOR_UP, whose caller fills it
top-down (invert_left).

The port's copy of ffmpeg_tpu/codecs/vp9/intra.py, held equal to it by
tests/test_torch_host_copies.py."""

from __future__ import annotations

import numpy as np

(VERT, HOR, DC, DDL, DDR, VR, HD, VL, HU, TM,
 LEFT_DC, TOP_DC, DC_128, DC_127, DC_129) = range(15)


def predict(mode, n, left, top, tl):
    """→ (n, n) int array. left/top are int arrays (left len n,
    top len 2n), tl the corner sample."""
    out = np.empty((n, n), np.int32)
    if mode == VERT:
        out[:] = top[:n][None, :]
    elif mode == HOR:
        out[:] = left[n - 1 - np.arange(n)][:, None]
    elif mode == DC:
        dc = (int(left[:n].sum()) + int(top[:n].sum()) + n) >> \
            (n.bit_length())
        out[:] = dc
    elif mode == LEFT_DC:
        out[:] = (int(left[:n].sum()) + (n >> 1)) >> (n.bit_length() - 1)
    elif mode == TOP_DC:
        out[:] = (int(top[:n].sum()) + (n >> 1)) >> (n.bit_length() - 1)
    elif mode == DC_128:
        out[:] = 128
    elif mode == DC_127:
        out[:] = 127
    elif mode == DC_129:
        out[:] = 129
    elif mode == TM:
        lm = left[n - 1 - np.arange(n)].astype(np.int32) - int(tl)
        out[:] = np.clip(top[:n][None, :] + lm[:, None], 0, 255)
    elif mode == DDL:
        v = np.empty(n - 1, np.int32)
        t = top
        v[:n - 2] = (t[:n - 2] + 2 * t[1:n - 1] + t[2:n] + 2) >> 2
        v[n - 2] = (t[n - 2] + 3 * t[n - 1] + 2) >> 2
        if n == 4:
            # 4x4 reads 8 top samples (vp9dsp diag_downleft_4x4)
            a = t[:8]
            vals = (a[:6] + 2 * a[1:7] + a[2:8] + 2) >> 2
            for y in range(4):
                for x in range(4):
                    k = x + y
                    out[y, x] = vals[k] if k < 6 else a[7]
            out[3, 3] = a[7]
            return out
        for j in range(n):
            k = n - 1 - j
            out[j, :k] = v[j:j + k]
            out[j, k:] = t[n - 1]
    elif mode == DDR:
        v = np.empty(2 * n - 1, np.int32)
        lf, t = left, top
        v[:n - 2] = (lf[:n - 2] + 2 * lf[1:n - 1] + lf[2:n] + 2) >> 2
        v[n + 1:] = (t[:n - 2] + 2 * t[1:n - 1] + t[2:n] + 2) >> 2
        v[n - 2] = (lf[n - 2] + 2 * lf[n - 1] + tl + 2) >> 2
        v[n - 1] = (lf[n - 1] + 2 * tl + t[0] + 2) >> 2
        v[n] = (tl + 2 * t[0] + t[1] + 2) >> 2
        for j in range(n):
            out[j] = v[n - 1 - j:2 * n - 1 - j]
    elif mode == VR:
        h = n // 2
        ve = np.empty(n + h - 1, np.int32)
        vo = np.empty(n + h - 1, np.int32)
        lf, t = left, top
        for i in range(h - 2):
            vo[i] = (lf[i * 2 + 3] + 2 * lf[i * 2 + 2]
                     + lf[i * 2 + 1] + 2) >> 2
            ve[i] = (lf[i * 2 + 4] + 2 * lf[i * 2 + 3]
                     + lf[i * 2 + 2] + 2) >> 2
        vo[h - 2] = (lf[n - 1] + 2 * lf[n - 2] + lf[n - 3] + 2) >> 2
        ve[h - 2] = (tl + 2 * lf[n - 1] + lf[n - 2] + 2) >> 2
        ve[h - 1] = (tl + t[0] + 1) >> 1
        vo[h - 1] = (lf[n - 1] + 2 * tl + t[0] + 2) >> 2
        for i in range(n - 1):
            ve[h + i] = (t[i] + t[i + 1] + 1) >> 1
            pm1 = tl if i == 0 else t[i - 1]
            vo[h + i] = (pm1 + 2 * t[i] + t[i + 1] + 2) >> 2
        for j in range(h):
            out[2 * j] = ve[h - 1 - j:h - 1 - j + n]
            out[2 * j + 1] = vo[h - 1 - j:h - 1 - j + n]
    elif mode == HD:
        v = np.empty(3 * n - 2, np.int32)
        lf, t = left, top
        for i in range(n - 2):
            v[i * 2] = (lf[i + 1] + lf[i] + 1) >> 1
            v[i * 2 + 1] = (lf[i + 2] + 2 * lf[i + 1] + lf[i] + 2) >> 2
            pm1 = tl if i == 0 else t[i - 1]
            v[n * 2 + i] = (pm1 + 2 * t[i] + t[i + 1] + 2) >> 2
        v[n * 2 - 2] = (tl + lf[n - 1] + 1) >> 1
        v[n * 2 - 4] = (lf[n - 1] + lf[n - 2] + 1) >> 1
        v[n * 2 - 1] = (t[0] + 2 * tl + lf[n - 1] + 2) >> 2
        v[n * 2 - 3] = (tl + 2 * lf[n - 1] + lf[n - 2] + 2) >> 2
        for j in range(n):
            out[j] = v[n * 2 - 2 - j * 2:n * 3 - 2 - j * 2]
    elif mode == VL:
        ve = np.empty(n - 1, np.int32)
        vo = np.empty(n - 1, np.int32)
        t = top
        ve[:n - 2] = (t[:n - 2] + t[1:n - 1] + 1) >> 1
        vo[:n - 2] = (t[:n - 2] + 2 * t[1:n - 1] + t[2:n] + 2) >> 2
        ve[n - 2] = (t[n - 2] + t[n - 1] + 1) >> 1
        vo[n - 2] = (t[n - 2] + 3 * t[n - 1] + 2) >> 2
        if n == 4:
            # 4x4 reads 7 top samples (vert_left_4x4)
            a = t[:7]
            E = (a[:5] + a[1:6] + 1) >> 1
            O = (a[:5] + 2 * a[1:6] + a[2:7] + 2) >> 2
            grid = [[E[0], E[1], E[2], E[3]],
                    [O[0], O[1], O[2], O[3]],
                    [E[1], E[2], E[3], E[4]],
                    [O[1], O[2], O[3], O[4]]]
            return np.array(grid, np.int32)
        for j in range(n // 2):
            k = n - 1 - j
            out[2 * j, :k] = ve[j:j + k]
            out[2 * j, k:] = t[n - 1]
            out[2 * j + 1, :k] = vo[j:j + k]
            out[2 * j + 1, k:] = t[n - 1]
    elif mode == HU:
        # left is TOP-DOWN here (invert_left)
        lf = left
        if n == 4:
            l0, l1, l2, l3 = int(lf[0]), int(lf[1]), int(lf[2]), \
                int(lf[3])
            g = [[(l0 + l1 + 1) >> 1, (l0 + 2 * l1 + l2 + 2) >> 2,
                  (l1 + l2 + 1) >> 1, (l1 + 2 * l2 + l3 + 2) >> 2],
                 [(l1 + l2 + 1) >> 1, (l1 + 2 * l2 + l3 + 2) >> 2,
                  (l2 + l3 + 1) >> 1, (l2 + 3 * l3 + 2) >> 2],
                 [(l2 + l3 + 1) >> 1, (l2 + 3 * l3 + 2) >> 2, l3, l3],
                 [l3, l3, l3, l3]]
            return np.array(g, np.int32)
        v = np.empty(2 * n - 2, np.int32)
        for i in range(n - 2):
            v[i * 2] = (lf[i] + lf[i + 1] + 1) >> 1
            v[i * 2 + 1] = (lf[i] + 2 * lf[i + 1] + lf[i + 2] + 2) >> 2
        v[2 * n - 4] = (lf[n - 2] + lf[n - 1] + 1) >> 1
        v[2 * n - 3] = (lf[n - 2] + 3 * lf[n - 1] + 2) >> 2
        for j in range(n):
            if j < n // 2:
                out[j] = v[j * 2:j * 2 + n]
            else:
                k = 2 * n - 2 - j * 2
                out[j, :k] = v[j * 2:j * 2 + k]
                out[j, k:] = lf[n - 1]
    else:
        raise AssertionError(mode)
    return out
