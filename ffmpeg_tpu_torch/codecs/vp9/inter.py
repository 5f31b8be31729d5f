"""VP9 inter prediction: 8-tap/bilinear sub-pel MC with edge
emulation, compound averaging, and the sub-8x8 chroma MV averaging
rules, exact integer math (VP9 spec §8.5.2.3; reference:
libavcodec/vp9recon.c inter_recon + vp9_mc_template.c +
vp9dsp_template.c do_8tap_*). 4:2:0 8-bit scope; unscaled refs only
(ref dims must equal the frame's).

The port's copy of ffmpeg_tpu/codecs/vp9/inter.py, held equal to it by
tests/test_torch_host_copies.py."""

from __future__ import annotations

import numpy as np

from . import tables_gen as T
from . import itxfm as TX
from .block import BS_8x8, BS_8x4, BS_4x8, ZEROMV

# bilinear "filter" phases: f[3] = 128 - 16*phase, f[4] = 16*phase,
# others 0 (vp9dsp_template.c do_bilin_1d). Built as an 8-tap row so
# one code path serves all four filters.
_BILIN = np.zeros((16, 8), np.int32)
for _i in range(16):
    _BILIN[_i, 3] = 128 - _i * 8
    _BILIN[_i, 4] = _i * 8

FILTERS = np.concatenate([np.asarray(T.SUBPEL_FILTERS, np.int32),
                          _BILIN[None]], 0)   # [4][16][8]


def _tap(win, F, axis, n_out):
    """8-tap filter along axis over a window; returns clipped uint8-
    range int32 of length n_out along that axis."""
    acc = np.zeros(
        (n_out, win.shape[1]) if axis == 0 else (win.shape[0], n_out),
        np.int64)
    for k in range(8):
        if axis == 0:
            acc += int(F[k]) * win[k:k + n_out, :].astype(np.int64)
        else:
            acc += int(F[k]) * win[:, k:k + n_out].astype(np.int64)
    return np.clip((acc + 64) >> 7, 0, 255).astype(np.int32)


def mc_block(dst, dy, dx, bh, bw, ref, y, x, mvx, mvy, shift, filt,
             w, h, avg):
    """One MC call (vp9recon.c mc_luma/chroma_unscaled). shift: 3 for
    luma (phase = (mv&7)<<1), 4 for chroma (phase = mv&15). w,h: the
    reference frame's display dims (edge replication bound)."""
    x = x + (mvx >> shift)
    y = y + (mvy >> shift)
    mask = (1 << shift) - 1
    px = (mvx & mask) << (4 - shift)
    py = (mvy & mask) << (4 - shift)
    hx = 1 if px else 0
    hy = 1 if py else 0
    rows = np.clip(np.arange(y - 3 * hy, y + bh + 4 * hy), 0, h - 1)
    cols = np.clip(np.arange(x - 3 * hx, x + bw + 4 * hx), 0, w - 1)
    win = ref[np.ix_(rows, cols)].astype(np.int32)
    if hx and hy:
        tmp = _tap(win, FILTERS[filt][px], 1, bw)
        pred = _tap(tmp, FILTERS[filt][py], 0, bh)
    elif hx:
        pred = _tap(win, FILTERS[filt][px], 1, bw)
    elif hy:
        pred = _tap(win, FILTERS[filt][py], 0, bh)
    else:
        pred = win
    if avg:
        d = dst[dy:dy + bh, dx:dx + bw].astype(np.int32)
        pred = (d + pred + 1) >> 1
    dst[dy:dy + bh, dx:dx + bw] = pred.astype(np.uint8)


def _rdiv2(s):
    return (s + 1) // 2 if s >= 0 else -((-s + 1) // 2)


def _rdiv4(s):
    return (s + 2) // 4 if s >= 0 else -((-s + 2) // 4)


def _avg_mv(*mvs):
    n = len(mvs)
    sx = sum(m[0] for m in mvs)
    sy = sum(m[1] for m in mvs)
    if n == 2:
        return (_rdiv2(sx), _rdiv2(sy))
    return (_rdiv4(sx), _rdiv4(sy))


def mc_calls(w, row, col, bs):
    """Enumerate the mc_block invocations for one inter block as
    tuples (plane 0/1/2, li, dy, dx, bh, bw, mvx, mvy, shift) —
    shared by the host executor (inter_pred) and the device recorder
    (recorder.py), so the sub-8x8 chroma MV averaging rules live in
    exactly one place. dst position == src base position for every
    call (vp9_mc_template.c)."""
    b = w.b
    py0 = row * 8
    px0 = col * 8
    out = []
    for li in range(2 if b["comp"] else 1):
        mv = [b["mv"][k][li] for k in range(4)]
        if bs == BS_8x4:
            out.append((0, li, py0, px0, 4, 8, mv[0][0], mv[0][1], 3))
            out.append((0, li, py0 + 4, px0, 4, 8,
                        mv[2][0], mv[2][1], 3))
            uvmv = _avg_mv(mv[0], mv[2])
        elif bs == BS_4x8:
            out.append((0, li, py0, px0, 8, 4, mv[0][0], mv[0][1], 3))
            out.append((0, li, py0, px0 + 4, 8, 4,
                        mv[1][0], mv[1][1], 3))
            uvmv = _avg_mv(mv[0], mv[1])
        elif bs > BS_8x8:                 # BS_4x4
            for k, (oy, ox) in enumerate(((0, 0), (0, 4),
                                          (4, 0), (4, 4))):
                out.append((0, li, py0 + oy, px0 + ox, 4, 4,
                            mv[k][0], mv[k][1], 3))
            uvmv = _avg_mv(mv[0], mv[1], mv[2], mv[3])
        else:
            bw = int(T.BWH_TAB[0][bs][0]) * 4
            bh = int(T.BWH_TAB[0][bs][1]) * 4
            out.append((0, li, py0, px0, bh, bw,
                        mv[0][0], mv[0][1], 3))
            uvbw = int(T.BWH_TAB[1][bs][0]) * 4
            uvbh = int(T.BWH_TAB[1][bs][1]) * 4
            for pl in (1, 2):
                out.append((pl, li, py0 >> 1, px0 >> 1, uvbh, uvbw,
                            mv[0][0], mv[0][1], 4))
            continue
        for pl in (1, 2):                 # sub-8x8 chroma: one 4x4
            out.append((pl, li, py0 >> 1, px0 >> 1, 4, 4,
                        uvmv[0], uvmv[1], 4))
    return out


def inter_pred(w, row, col, bs):
    """MC for one block into the frame planes
    (vp9_mc_template.c inter_pred, 4:2:0)."""
    fs = w.fs
    b = w.b
    filt = b["filter"]
    for pl, li, dy, dx, bh, bw, mvx, mvy, shift in \
            mc_calls(w, row, col, bs):
        ry, ru, rv, rw, rh = fs.refs[b["ref"][li]]
        if pl == 0:
            plane, rp, pw, ph = fs.y, ry, rw, rh
        else:
            plane = fs.u if pl == 1 else fs.v
            rp = ru if pl == 1 else rv
            pw, ph = (rw + 1) >> 1, (rh + 1) >> 1
        mc_block(plane, dy, dx, bh, bw, rp, dy, dx, mvx, mvy,
                 shift, filt, pw, ph, li == 1)


def inter_recon(w, row, col, bs, tx, uvtx, eobs, blocks, uveobs,
                uvblocks):
    """MC + residual add (vp9recon.c inter_recon)."""
    fs = w.fs
    inter_pred(w, row, col, bs)
    if eobs is None:
        return
    w4 = int(T.BWH_TAB[1][bs][0]) * 2     # 4px units
    h4 = int(T.BWH_TAB[1][bs][1]) * 2
    end_x = min(2 * (fs.cols - col), w4)
    end_y = min(2 * (fs.rows - row), h4)
    step1d = 1 << tx
    px = col * 8
    py = row * 8
    n = 0
    for y in range(0, end_y, step1d):
        for x in range(0, end_x, step1d):
            size = step1d * 4
            if eobs[n]:
                TX.itxfm_add(fs.y[py + y * 4:py + y * 4 + size,
                                  px + x * 4:px + x * 4 + size],
                             blocks[n], TX.DCT_DCT, eobs[n])
            n += step1d * step1d
    uvstep = 1 << uvtx
    end_xc, end_yc = end_x >> 1, end_y >> 1
    pxc, pyc = px >> 1, py >> 1
    for pl, plane in ((0, fs.u), (1, fs.v)):
        n = 0
        for y in range(0, end_yc, uvstep):
            for x in range(0, end_xc, uvstep):
                size = uvstep * 4
                if uveobs[pl][n]:
                    TX.itxfm_add(
                        plane[pyc + y * 4:pyc + y * 4 + size,
                              pxc + x * 4:pxc + x * 4 + size],
                        uvblocks[pl][n], TX.DCT_DCT, uveobs[pl][n])
                n += uvstep * uvstep
    return
