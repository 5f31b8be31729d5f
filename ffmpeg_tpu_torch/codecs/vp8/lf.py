"""VP8 in-loop deblocking filter, exact integer math (RFC 6386 §15;
reference: libavcodec/vp8dsp.c loop filters + vp8.c filter_mb /
filter_level_for_mb). Runs per MB in raster order on the recon
planes.

The port's copy of ffmpeg_tpu/codecs/vp8/lf.py, held equal to it by
tests/test_torch_vp8_webp.py.
"""

from __future__ import annotations

import numpy as np

# indexed [keyframe][filter_level] (vp8.c hev_thresh_lut)
HEV_THRESH_LUT = (
    [0] * 15 + [1] * 5 + [2] * 20 + [3] * 24,   # inter frame
    [0] * 15 + [1] * 25 + [2] * 24,             # keyframe
)


def _c8(v):
    return max(0, min(255, v))


def _cs(v):
    return max(-128, min(127, v))


def _get8(arr, get):
    return [int(get(k)) for k in range(-4, 4)]


def _normal_limit(p3, p2, p1, p0, q0, q1, q2, q3, E, I):
    return (2 * abs(p0 - q0) + (abs(p1 - q1) >> 1) <= E and
            abs(p3 - p2) <= I and abs(p2 - p1) <= I and
            abs(p1 - p0) <= I and abs(q3 - q2) <= I and
            abs(q2 - q1) <= I and abs(q1 - q0) <= I)


def _filter_common(px, put, p1, p0, q0, q1, is4tap):
    a = 3 * (q0 - p0)
    if is4tap:
        a += _cs(p1 - q1)
    a = _cs(a)
    f1 = min(a + 4, 127) >> 3
    f2 = min(a + 3, 127) >> 3
    put(-1, _c8(p0 + f2))
    put(0, _c8(q0 - f1))
    if not is4tap:
        a = (f1 + 1) >> 1
        put(-2, _c8(p1 + a))
        put(1, _c8(q1 - a))


def _filter_mbedge(put, p3, p2, p1, p0, q0, q1, q2, q3):
    w = _cs(p1 - q1)
    w = _cs(w + 3 * (q0 - p0))
    a0 = (27 * w + 63) >> 7
    a1 = (18 * w + 63) >> 7
    a2 = (9 * w + 63) >> 7
    put(-3, _c8(p2 + a2))
    put(-2, _c8(p1 + a1))
    put(-1, _c8(p0 + a0))
    put(0, _c8(q0 - a0))
    put(1, _c8(q1 - a1))
    put(2, _c8(q2 - a2))


def _edge(plane, vert, x0, y0, n, E, I, hev_t, inner):
    """Filter one n-sample edge at (x0, y0): vertical edge (column
    x0) over rows y0..y0+n, or horizontal over columns."""
    for i in range(n):
        if vert:
            def get(k):
                return int(plane[y0 + i, x0 + k])

            def put(k, v):
                plane[y0 + i, x0 + k] = v
        else:
            def get(k):
                return int(plane[y0 + k, x0 + i])

            def put(k, v):
                plane[y0 + k, x0 + i] = v
        p3, p2, p1, p0, q0, q1, q2, q3 = _get8(plane, get)
        if not _normal_limit(p3, p2, p1, p0, q0, q1, q2, q3, E, I):
            continue
        hev = abs(p1 - p0) > hev_t or abs(q1 - q0) > hev_t
        if inner:
            _filter_common(None, put, p1, p0, q0, q1, hev)
        else:
            if hev:
                _filter_common(None, put, p1, p0, q0, q1, True)
            else:
                _filter_mbedge(put, p3, p2, p1, p0, q0, q1, q2, q3)


def _edge_simple(plane, vert, x0, y0, flim):
    for i in range(16):
        if vert:
            def get(k):
                return int(plane[y0 + i, x0 + k])

            def put(k, v):
                plane[y0 + i, x0 + k] = v
        else:
            def get(k):
                return int(plane[y0 + k, x0 + i])

            def put(k, v):
                plane[y0 + k, x0 + i] = v
        p1, p0, q0, q1 = (int(get(k)) for k in (-2, -1, 0, 1))
        if 2 * abs(p0 - q0) + (abs(p1 - q1) >> 1) <= flim:
            _filter_common(None, put, p1, p0, q0, q1, True)


def filter_level_for_mb(s, mb):
    """→ (filter_level, inner_limit, inner_filter)
    (vp8.c filter_level_for_mb)."""
    if s["seg_enabled"]:
        lvl = s["seg_filter_level"][mb["segment"]]
        if not s["seg_absolute"]:
            lvl += s["filter_level"]
    else:
        lvl = s["filter_level"]
    if s["lf_delta_enabled"]:
        lvl += s["lf_ref_delta"][mb["ref_frame"]]
        lvl += s["lf_mode_delta"][mb["mode"]]
    lvl = max(0, min(63, lvl))
    il = lvl
    sharp = s["sharpness"]
    if sharp:
        il >>= (sharp + 3) >> 2
        il = min(il, 9 - sharp)
    il = max(il, 1)
    inner = (not mb["skip"]) or mb["mode"] in (4, 7)  # I4x4 / SPLIT
    return lvl, il, inner


def filter_mb(y, u, v, mb_x, mb_y, lvl, il, inner, keyframe):
    """Normal loop filter for one MB (vp8.c filter_mb)."""
    if not lvl:
        return
    bedge = lvl * 2 + il
    mbedge = bedge + 4
    hev_t = HEV_THRESH_LUT[1 if keyframe else 0][lvl]
    x0, y0 = mb_x * 16, mb_y * 16
    xc, yc = mb_x * 8, mb_y * 8
    if mb_x:
        _edge(y, True, x0, y0, 16, mbedge, il, hev_t, False)
        _edge(u, True, xc, yc, 8, mbedge, il, hev_t, False)
        _edge(v, True, xc, yc, 8, mbedge, il, hev_t, False)
    if inner:
        for dx in (4, 8, 12):
            _edge(y, True, x0 + dx, y0, 16, bedge, il, hev_t, True)
        _edge(u, True, xc + 4, yc, 8, bedge, il, hev_t, True)
        _edge(v, True, xc + 4, yc, 8, bedge, il, hev_t, True)
    if mb_y:
        _edge(y, False, x0, y0, 16, mbedge, il, hev_t, False)
        _edge(u, False, xc, yc, 8, mbedge, il, hev_t, False)
        _edge(v, False, xc, yc, 8, mbedge, il, hev_t, False)
    if inner:
        for dy in (4, 8, 12):
            _edge(y, False, x0, y0 + dy, 16, bedge, il, hev_t, True)
        _edge(u, False, xc, yc + 4, 8, bedge, il, hev_t, True)
        _edge(v, False, xc, yc + 4, 8, bedge, il, hev_t, True)


def filter_mb_simple(y, mb_x, mb_y, lvl, il, inner):
    if not lvl:
        return
    bedge = 2 * lvl + il
    mbedge = bedge + 4
    x0, y0 = mb_x * 16, mb_y * 16
    if mb_x:
        _edge_simple(y, True, x0, y0, mbedge)
    if inner:
        for dx in (4, 8, 12):
            _edge_simple(y, True, x0 + dx, y0, bedge)
    if mb_y:
        _edge_simple(y, False, x0, y0, mbedge)
    if inner:
        for dy in (4, 8, 12):
            _edge_simple(y, False, x0, y0 + dy, bedge)
