"""VP9 in-loop deblocking filter, exact integer math (VP9 spec §8.8;
reference: libavcodec/vp9dsp_template.c loop_filter + vp9lpf.c).
Applied per superblock in raster order — all vertical edges of the SB,
then all horizontal edges — using the per-4px filter-width maps built
during block decode (mask_edges analog) and the per-MI filter level.

The port's copy of ffmpeg_tpu/codecs/vp9/lf.py, held equal to it by
tests/test_torch_host_copies.py."""

from __future__ import annotations

import numpy as np


def _luts(sharp):
    lim = np.zeros(64, np.int32)
    mblim = np.zeros(64, np.int32)
    for i in range(1, 64):
        limit = i
        if sharp > 0:
            limit >>= (sharp + 3) >> 2
            limit = min(limit, 9 - sharp)
        limit = max(limit, 1)
        lim[i] = limit
        mblim[i] = 2 * (i + 2) + limit
    return lim, mblim


def _clip(v):
    return max(0, min(255, v))


def _clip_s(v):
    return max(-128, min(127, v))


def _filter_edge(px, get, put, E, I, H, wd):
    """One 4-sample edge segment; get(i, k)/put(i, k, v) address
    sample k (p side negative) of line i (vp9dsp loop_filter)."""
    F = 1
    for i in range(4):
        p3, p2, p1, p0 = get(i, -4), get(i, -3), get(i, -2), get(i, -1)
        q0, q1, q2, q3 = get(i, 0), get(i, 1), get(i, 2), get(i, 3)
        fm = (abs(p3 - p2) <= I and abs(p2 - p1) <= I and
              abs(p1 - p0) <= I and abs(q1 - q0) <= I and
              abs(q2 - q1) <= I and abs(q3 - q2) <= I and
              abs(p0 - q0) * 2 + (abs(p1 - q1) >> 1) <= E)
        if not fm:
            continue
        if wd >= 16:
            p7, p6, p5, p4 = get(i, -8), get(i, -7), get(i, -6), \
                get(i, -5)
            q4, q5, q6, q7 = get(i, 4), get(i, 5), get(i, 6), get(i, 7)
            flat8out = (abs(p7 - p0) <= F and abs(p6 - p0) <= F and
                        abs(p5 - p0) <= F and abs(p4 - p0) <= F and
                        abs(q4 - q0) <= F and abs(q5 - q0) <= F and
                        abs(q6 - q0) <= F and abs(q7 - q0) <= F)
        flat8in = False
        if wd >= 8:
            flat8in = (abs(p3 - p0) <= F and abs(p2 - p0) <= F and
                       abs(p1 - p0) <= F and abs(q1 - q0) <= F and
                       abs(q2 - q0) <= F and abs(q3 - q0) <= F)
        if wd >= 16 and flat8out and flat8in:
            put(i, -7, (p7 * 7 + p6 * 2 + p5 + p4 + p3 + p2 + p1 + p0
                        + q0 + 8) >> 4)
            put(i, -6, (p7 * 6 + p6 + p5 * 2 + p4 + p3 + p2 + p1 + p0
                        + q0 + q1 + 8) >> 4)
            put(i, -5, (p7 * 5 + p6 + p5 + p4 * 2 + p3 + p2 + p1 + p0
                        + q0 + q1 + q2 + 8) >> 4)
            put(i, -4, (p7 * 4 + p6 + p5 + p4 + p3 * 2 + p2 + p1 + p0
                        + q0 + q1 + q2 + q3 + 8) >> 4)
            put(i, -3, (p7 * 3 + p6 + p5 + p4 + p3 + p2 * 2 + p1 + p0
                        + q0 + q1 + q2 + q3 + q4 + 8) >> 4)
            put(i, -2, (p7 * 2 + p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0
                        + q0 + q1 + q2 + q3 + q4 + q5 + 8) >> 4)
            put(i, -1, (p7 + p6 + p5 + p4 + p3 + p2 + p1 + p0 * 2
                        + q0 + q1 + q2 + q3 + q4 + q5 + q6 + 8) >> 4)
            put(i, 0, (p6 + p5 + p4 + p3 + p2 + p1 + p0 + q0 * 2
                       + q1 + q2 + q3 + q4 + q5 + q6 + q7 + 8) >> 4)
            put(i, 1, (p5 + p4 + p3 + p2 + p1 + p0 + q0 + q1 * 2
                       + q2 + q3 + q4 + q5 + q6 + q7 * 2 + 8) >> 4)
            put(i, 2, (p4 + p3 + p2 + p1 + p0 + q0 + q1 + q2 * 2
                       + q3 + q4 + q5 + q6 + q7 * 3 + 8) >> 4)
            put(i, 3, (p3 + p2 + p1 + p0 + q0 + q1 + q2 + q3 * 2
                       + q4 + q5 + q6 + q7 * 4 + 8) >> 4)
            put(i, 4, (p2 + p1 + p0 + q0 + q1 + q2 + q3 + q4 * 2
                       + q5 + q6 + q7 * 5 + 8) >> 4)
            put(i, 5, (p1 + p0 + q0 + q1 + q2 + q3 + q4 + q5 * 2
                       + q6 + q7 * 6 + 8) >> 4)
            put(i, 6, (p0 + q0 + q1 + q2 + q3 + q4 + q5 + q6 * 2
                       + q7 * 7 + 8) >> 4)
        elif wd >= 8 and flat8in:
            put(i, -3, (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3)
            put(i, -2, (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3)
            put(i, -1, (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3)
            put(i, 0, (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3)
            put(i, 1, (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3)
            put(i, 2, (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3)
        else:
            hev = abs(p1 - p0) > H or abs(q1 - q0) > H
            if hev:
                f = _clip_s(p1 - q1)
                f = _clip_s(3 * (q0 - p0) + f)
                f1 = min(f + 4, 127) >> 3
                f2 = min(f + 3, 127) >> 3
                put(i, -1, _clip(p0 + f2))
                put(i, 0, _clip(q0 - f1))
            else:
                f = _clip_s(3 * (q0 - p0))
                f1 = min(f + 4, 127) >> 3
                f2 = min(f + 3, 127) >> 3
                put(i, -1, _clip(p0 + f2))
                put(i, 0, _clip(q0 - f1))
                f = (f1 + 1) >> 1
                put(i, -2, _clip(p1 + f))
                put(i, 1, _clip(q1 - f))


def loopfilter_frame(fs):
    """Deblock fs.y/u/v in place (single-pass per SB, cols then rows;
    tile boundaries ARE filtered, per spec)."""
    h = fs.h
    if not h.filter_level:
        return
    lim_lut, mblim_lut = _luts(h.sharpness)
    planes = [(fs.y, fs.wd_v, fs.wd_h, 0),
              (fs.u, fs.wd_v_uv, fs.wd_h_uv, 1),
              (fs.v, fs.wd_v_uv, fs.wd_h_uv, 1)]
    pw = fs.cols * 8
    ph = fs.rows * 8
    for sb_r in range(fs.sb_rows):
        for sb_c in range(fs.sb_cols):
            for plane, wd_v, wd_h, ss in planes:
                arr = plane.astype(np.int32)
                n4 = 16 >> ss             # 4px cols per SB
                y4a = sb_r * n4
                x4a = sb_c * n4
                lim_w = (pw >> ss) >> 2   # total 4px cols in plane
                lim_h = (ph >> ss) >> 2
                dirty = False
                # vertical edges, left to right
                for x4 in range(x4a, min(x4a + n4, lim_w)):
                    if x4 == 0:
                        continue
                    x = x4 * 4
                    for y4 in range(y4a, min(y4a + n4, lim_h)):
                        wd = int(wd_v[y4, x4])
                        if not wd:
                            continue
                        lvl = int(fs.lf_lvl[y4 >> (1 - ss),
                                            x4 >> (1 - ss)])
                        if not lvl:
                            continue
                        y0 = y4 * 4
                        _filter_edge(
                            arr, lambda i, k: int(arr[y0 + i, x + k]),
                            lambda i, k, v: arr.__setitem__(
                                (y0 + i, x + k), v),
                            int(mblim_lut[lvl]), int(lim_lut[lvl]),
                            lvl >> 4, wd)
                        dirty = True
                # horizontal edges, top to bottom
                for y4 in range(y4a, min(y4a + n4, lim_h)):
                    if y4 == 0:
                        continue
                    y = y4 * 4
                    for x4 in range(x4a, min(x4a + n4, lim_w)):
                        wd = int(wd_h[y4, x4])
                        if not wd:
                            continue
                        lvl = int(fs.lf_lvl[y4 >> (1 - ss),
                                            x4 >> (1 - ss)])
                        if not lvl:
                            continue
                        x = x4 * 4
                        _filter_edge(
                            arr, lambda i, k: int(arr[y + k, x + i]),
                            lambda i, k, v: arr.__setitem__(
                                (y + k, x + i), v),
                            int(mblim_lut[lvl]), int(lim_lut[lvl]),
                            lvl >> 4, wd)
                        dirty = True
                if dirty or True:
                    plane[:arr.shape[0], :arr.shape[1]] = \
                        arr.astype(np.uint8)
