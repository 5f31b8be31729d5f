"""HEVC inter prediction: 8-tap luma / 4-tap chroma interpolation with
exact integer math (spec 8.5.4.2.2, Tables 8-11/8-13; reference:
libavcodec/hevc/dsp_template.c put_hevc_qpel/epel*). Host numpy; out-of
-picture reads replicate the border (edge emulation).

The port's copy of ffmpeg_tpu/codecs/hevc/inter.py, held equal to it by
tests/test_torch_hevc_host.py."""

from __future__ import annotations

import numpy as np

# Table 8-11: luma quarter-sample filters, taps at offsets -3..4
LUMA_FILTERS = (
    (0, 0, 0, 64, 0, 0, 0, 0),
    (-1, 4, -10, 58, 17, -5, 1, 0),
    (-1, 4, -11, 40, 40, -11, 4, -1),
    (0, 1, -5, 17, 58, -10, 4, -1),
)
# Table 8-13: chroma eighth-sample filters, taps at offsets -1..2
CHROMA_FILTERS = (
    (0, 64, 0, 0),
    (-2, 58, 10, -2),
    (-4, 54, 16, -2),
    (-6, 46, 28, -4),
    (-4, 36, 36, -4),
    (-4, 28, 46, -6),
    (-2, 16, 54, -4),
    (-2, 10, 58, -2),
)


def _window(ref, y0, x0, h, w):
    """(h, w) window at (y0, x0) with border replication."""
    ys = np.clip(np.arange(y0, y0 + h), 0, ref.shape[0] - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, ref.shape[1] - 1)
    return ref[np.ix_(ys, xs)].astype(np.int32)


def _conv_h(a, taps):
    w = a.shape[1] - len(taps) + 1
    out = np.zeros((a.shape[0], w), np.int64)
    for i, t in enumerate(taps):
        if t:
            out += t * a[:, i:i + w].astype(np.int64)
    return out


def _conv_v(a, taps):
    h = a.shape[0] - len(taps) + 1
    out = np.zeros((h, a.shape[1]), np.int64)
    for i, t in enumerate(taps):
        if t:
            out += t * a[i:i + h].astype(np.int64)
    return out


def mc_luma(ref, x0, y0, w, h, mv, bd=8):
    """14-bit-scale prediction block (put_hevc_qpel: h/v single pass
    >> (bd-8), hv second pass >> 6; copy path << (14-bd))."""
    s1 = bd - 8
    xi = x0 + (mv[0] >> 2)
    yi = y0 + (mv[1] >> 2)
    fx = mv[0] & 3
    fy = mv[1] & 3
    if fx == 0 and fy == 0:
        return _window(ref, yi, xi, h, w) << (14 - bd)
    if fy == 0:
        a = _window(ref, yi, xi - 3, h, w + 7)
        return _conv_h(a, LUMA_FILTERS[fx]) >> s1
    if fx == 0:
        a = _window(ref, yi - 3, xi, h + 7, w)
        return _conv_v(a, LUMA_FILTERS[fy]) >> s1
    a = _window(ref, yi - 3, xi - 3, h + 7, w + 7)
    tmp = _conv_h(a, LUMA_FILTERS[fx]) >> s1
    return _conv_v(tmp, LUMA_FILTERS[fy]) >> 6


def mc_chroma(ref, x0, y0, w, h, mv, bd=8):
    """14-bit-scale chroma block; mv in luma quarter-pel units →
    chroma eighth-pel (put_hevc_epel)."""
    s1 = bd - 8
    xi = x0 + (mv[0] >> 3)
    yi = y0 + (mv[1] >> 3)
    fx = mv[0] & 7
    fy = mv[1] & 7
    if fx == 0 and fy == 0:
        return _window(ref, yi, xi, h, w) << (14 - bd)
    if fy == 0:
        a = _window(ref, yi, xi - 1, h, w + 3)
        return _conv_h(a, CHROMA_FILTERS[fx]) >> s1
    if fx == 0:
        a = _window(ref, yi - 1, xi, h + 3, w)
        return _conv_v(a, CHROMA_FILTERS[fy]) >> s1
    a = _window(ref, yi - 1, xi - 1, h + 3, w + 3)
    tmp = _conv_h(a, CHROMA_FILTERS[fx]) >> s1
    return _conv_v(tmp, CHROMA_FILTERS[fy]) >> 6


def uni_out(raw, bd=8):
    """Unweighted uni-prediction output (shift 14-bd, round)."""
    sh = 14 - bd
    return np.clip((raw + (1 << (sh - 1))) >> sh, 0, (1 << bd) - 1)


def bi_out(raw0, raw1, bd=8):
    """Unweighted bi-prediction average (shift 15-bd, round)."""
    sh = 15 - bd
    return np.clip((raw0 + raw1 + (1 << (sh - 1))) >> sh,
                   0, (1 << bd) - 1)


def predict_pu(dec, x0, y0, w, h, f):
    """Write the motion-compensated prediction for one PU into the
    current picture planes (hevcdec.c hls_prediction_unit MC part)."""
    bd = dec.bd
    raws_y = []
    raws_u = []
    raws_v = []
    for ll in range(2):
        if not (f.pf >> ll) & 1:
            continue
        ry, ru, rv = dec.refs[ll][f.ref_idx[ll]]
        mv = f.mv[ll]
        raws_y.append(mc_luma(ry, x0, y0, w, h, mv, bd=bd))
        raws_u.append(mc_chroma(ru, x0 >> 1, y0 >> 1, w >> 1, h >> 1,
                                mv, bd=bd))
        raws_v.append(mc_chroma(rv, x0 >> 1, y0 >> 1, w >> 1, h >> 1,
                                mv, bd=bd))
    if len(raws_y) == 2:
        py = bi_out(raws_y[0], raws_y[1], bd=bd)
        pu = bi_out(raws_u[0], raws_u[1], bd=bd)
        pv = bi_out(raws_v[0], raws_v[1], bd=bd)
    else:
        py = uni_out(raws_y[0], bd=bd)
        pu = uni_out(raws_u[0], bd=bd)
        pv = uni_out(raws_v[0], bd=bd)
    dt = dec.y.dtype
    dec.y[y0:y0 + h, x0:x0 + w] = py.astype(dt)
    xc, yc, wc, hc = x0 >> 1, y0 >> 1, w >> 1, h >> 1
    dec.u[yc:yc + hc, xc:xc + wc] = pu.astype(dt)
    dec.v[yc:yc + hc, xc:xc + wc] = pv.astype(dt)
