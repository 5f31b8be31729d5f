"""VP9 in-loop deblocking filter on a device, in PyTorch: the port of
ffmpeg_tpu/codecs/vp9/lf_tpu.py (reference: libavcodec/vp9dsp_template.c
loop_filter + vp9.c loopfilter_sb).

The host filter (lf.py) walks superblocks in raster order with
data-dependent Python; here the same math runs over the superblocks in
the same order, each edge filtering a 64 (chroma 32) lane slab with
branchless selects, bit-exact against the host path.  It is the device
oracle of the loop filter: the per-frame decoder runs the host's
lf.loopfilter_frame, as the reference's does.

Where the reference is one compiled program (`_lf_kernel`, a fori_loop
over superblocks with a fori_loop over each superblock's edges), the
port runs eagerly:
 * the superblock loop and the edge loops are host loops;
 * an edge whose filter is off on every lane (its position, width map
   and level, all on the host) is skipped: the reference filters it as
   a pass-through;
 * the per-lane parameters (E, I, the HEV threshold, the width and the
   gate) are gathered for the whole frame in one vectorized step per
   plane and direction, where the reference gathers them per edge
   (sb_body's lvl_params, _rep), so an edge reads views of them;
 * edge_filter computes the 8- and 16-wide flat filters as window sums
   of one cumulative sum over the edge-clamped samples, where the
   reference writes each output's sum out; the integer results are the
   same.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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


_idx_cache: dict = {}


def _cols(device, key, cols):
    k = (str(device), key)
    t = _idx_cache.get(k)
    if t is None:
        t = _idx_cache[k] = torch.as_tensor(np.asarray(cols, np.int64),
                                            device=device)
    return t


# slab columns: 0..7 = p7..p0, 8..15 = q0..q7, so sample k (p side < 0)
# is column 8 + k
_REF16 = [7] * 8 + [8] * 8                       # p0 for p side, q0 for q
_EXT8 = [8 + min(max(j, -4), 3) for j in range(-6, 6)]
_EXT16 = [8 + min(max(j, -8), 7) for j in range(-14, 14)]


def edge_filter(slab, E, I, Hthr, wd, gate):
    """One vertical-edge slab (N, 16) int32: p7..p0 | q0..q7. Per-row
    params (N,). Returns the filtered slab (unfiltered rows pass
    through). Exact integer port of vp9dsp loop_filter."""
    s = slab
    dev = s.device
    p1, p0, q0, q1 = s[:, 6], s[:, 7], s[:, 8], s[:, 9]
    # |p2-p3|, |p1-p2|, |p0-p1|, |q0-p0|, |q1-q0|, |q2-q1|, |q3-q2|
    d = (s[:, 5:12] - s[:, 4:11]).abs()
    pq1 = p1 - q1
    fm = ((torch.maximum(d[:, 0:3].amax(1), d[:, 4:7].amax(1)) <= I) &
          (d[:, 3] * 2 + (pq1.abs() >> 1) <= E))
    flat = (s - s[:, _cols(dev, "ref16", _REF16)]).abs()
    flat8in = flat[:, 4:12].amax(1) <= 1
    flat8out = torch.maximum(flat[:, 0:4].amax(1), flat[:, 12:16].amax(1)) <= 1
    g = gate & fm
    sel16 = g & (wd >= 16) & flat8out & flat8in
    sel8 = g & (wd >= 8) & flat8in & ~sel16
    seln = g & ~sel16 & ~sel8

    # narrow filter (4px)
    hev = (d[:, 2] > Hthr) | (d[:, 4] > Hthr)
    base = 3 * (q0 - p0)
    f = torch.where(hev, base + pq1.clamp(-128, 127), base).clamp(-128, 127)
    f1 = (f + 4).clamp(max=127) >> 3
    f2 = (f + 3).clamp(max=127) >> 3
    fi = (f1 + 1) >> 1
    narrow = torch.stack([torch.where(hev, p1, (p1 + fi).clamp(0, 255)),
                          (p0 + f2).clamp(0, 255), (q0 - f1).clamp(0, 255),
                          torch.where(hev, q1, (q1 - fi).clamp(0, 255))], 1)

    # 8-wide flat filter: out[k] = (sum of samples k-3..k+3, clamped to
    # p3..q3, + sample k + 4) >> 3 for k = -3..2
    cs = F.pad(s[:, _cols(dev, "ext8", _EXT8)].cumsum(1, dtype=torch.int32),
               (1, 0))
    e8 = (cs[:, 7:13] - cs[:, 0:6] + s[:, 5:11] + 4) >> 3
    # 16-wide flat filter: out[k] = (sum of samples k-7..k+7, clamped to
    # p7..q7, + sample k + 8) >> 4 for k = -7..6
    cs = F.pad(s[:, _cols(dev, "ext16", _EXT16)].cumsum(1, dtype=torch.int32),
               (1, 0))
    w16 = (cs[:, 15:29] - cs[:, 0:14] + s[:, 1:15] + 8) >> 4

    m16 = torch.where(sel16[:, None], w16, s[:, 1:15])        # cols 1..14
    m8 = torch.where(sel8[:, None], e8, m16[:, 4:10])         # cols 5..10
    m4 = torch.where(seln[:, None], narrow, m8[:, 1:5])       # cols 6..9
    return torch.cat([s[:, :1], m16[:, :4], m8[:, :1], m4, m8[:, 5:],
                      m16[:, 10:], s[:, 15:]], 1)


def _rep(v, n):
    return v.repeat_interleave(n)


def _params(wd, lvl, lim_lut, mblim_lut):
    """Per-lane (E, I, HEV threshold, width, gate) maps from a width map
    and a level map of the same shape."""
    return (mblim_lut[lvl], lim_lut[lvl], lvl >> 4, wd, (wd > 0) & (lvl > 0))


def _plane_params(maps, lvl8, lim_lut, mblim_lut, device):
    """For each plane kind and direction, the per-lane parameter maps:
    rows of pixels x 4px edge columns for vertical edges, 4px edge rows x
    columns of pixels for horizontal ones (the reference's sb_body reads
    the same values per edge: wd4 via _rep, lvl via y_v_lvl & co.).
    maps = (wd_v, wd_h, wd_v_uv, wd_h_uv), FrameState's width maps."""
    def t(a):
        # widened on the device: the windowed decoder ships int8 maps
        return torch.as_tensor(a, device=device).to(torch.int32)
    L = t(lvl8)
    wd_v, wd_h, wd_v_uv, wd_h_uv = (t(m) for m in maps)
    luma_v = _params(wd_v.repeat_interleave(4, 0),
                     L.repeat_interleave(8, 0).repeat_interleave(2, 1),
                     lim_lut, mblim_lut)
    luma_h = _params(wd_h.repeat_interleave(4, 1),
                     L.repeat_interleave(2, 0).repeat_interleave(8, 1),
                     lim_lut, mblim_lut)
    chroma_v = _params(wd_v_uv.repeat_interleave(4, 0),
                       L.repeat_interleave(4, 0), lim_lut, mblim_lut)
    chroma_h = _params(wd_h_uv.repeat_interleave(4, 1),
                       L.repeat_interleave(4, 1), lim_lut, mblim_lut)
    return luma_v, luma_h, chroma_v, chroma_h


def _alive(maps, lvl8):
    """Host maps of the edges whose filter is on for some lane: luma and
    chroma, vertical and horizontal, at 4px edge granularity, from the
    host width maps (wd_v, wd_h, wd_v_uv, wd_h_uv) and levels."""
    wd_v, wd_h, wd_v_uv, wd_h_uv = maps
    lv = lvl8 > 0
    luma = np.repeat(np.repeat(lv, 2, 0), 2, 1)
    return ((wd_v > 0) & luma, (wd_h > 0) & luma,
            (wd_v_uv > 0) & lv, (wd_h_uv > 0) & lv)


def _v_edges(pl, n, prm, al, lim_wp, r0, x40, halo=8, x4_off=0):
    """The n // 4 vertical edges from 4px edge column x40 over rows
    r0..r0+n, left to right, in place.  pl is padded by 8 rows and
    `halo` columns (8: the whole frame's padding; a column shard's halo
    in lf_sharded); prm and al are indexed by pl's own edge columns,
    x4_off is their global 4px offset (for the frame-edge gate)."""
    for x4 in range(x40, x40 + n // 4):
        # the gate's position terms, on the host
        if not (0 < x4 + x4_off < lim_wp) or not al[r0 // 4:(r0 + n) // 4,
                                                    x4].any():
            continue
        x = x4 * 4 + halo - 8
        E, I, Hh, wd, gate = (p[r0:r0 + n, x4] for p in prm)
        pl[r0 + 8:r0 + 8 + n, x:x + 16] = edge_filter(
            pl[r0 + 8:r0 + 8 + n, x:x + 16], E, I, Hh, wd, gate)


def _h_edges(pl, n, prm, al, lim_hp, c0, y40, halo=8):
    """The n // 4 horizontal edges from 4px edge row y40 over columns
    c0..c0+n, top to bottom, in place (pl as in _v_edges)."""
    for y4 in range(y40, y40 + n // 4):
        if not (0 < y4 < lim_hp) or not al[y4, c0 // 4:(c0 + n) // 4].any():
            continue
        yy, xc = y4 * 4, c0 + halo
        E, I, Hh, wd, gate = (p[y4, c0:c0 + n] for p in prm)
        pl[yy:yy + 16, xc:xc + n] = edge_filter(
            pl[yy:yy + 16, xc:xc + n].T, E, I, Hh, wd, gate).T


def sb_body(r, c, planes, params, alive, dims, halos=(8, 8), x4_off=(0, 0)):
    """Filter all edges of superblock (r, c) in reference order:
    vertical edges left→right, then horizontal top→bottom, in place.
    planes = (y, u, v) int32, padded by 8 rows and by halos (luma,
    chroma) columns; params = _plane_params; alive = _alive; dims = the
    4px edge limits (lim_w, lim_h, lim_wc, lim_hc); x4_off = the global
    4px offset of the planes' first column (luma, chroma)."""
    y, u, v = planes
    luma_v, luma_h, chroma_v, chroma_h = params
    al_v, al_h, al_vc, al_hc = alive
    lim_w, lim_h, lim_wc, lim_hc = dims
    _v_edges(y, 64, luma_v, al_v, lim_w, r * 64, c * 16, halos[0], x4_off[0])
    _h_edges(y, 64, luma_h, al_h, lim_h, c * 64, r * 16, halos[0])
    for pl in (u, v):
        _v_edges(pl, 32, chroma_v, al_vc, lim_wc, r * 32, c * 8, halos[1],
                 x4_off[1])
        _h_edges(pl, 32, chroma_h, al_hc, lim_hc, c * 32, r * 8, halos[1])


def loopfilter_planes(planes, maps, lvl8, lim, mblim, dims, device):
    """The filter of whole (y, u, v) planes (SB-aligned, host or device)
    on `device`: maps = (wd_v, wd_h, wd_v_uv, wd_h_uv), lvl8 the
    (sb_rows * 8, sb_cols * 8) levels, lim/mblim = _luts, dims as in
    sb_body.  Returns the filtered planes as uint8 tensors there."""
    device = torch.device(device)

    def pad8(a):
        return F.pad(torch.as_tensor(a, device=device).to(torch.int32),
                     (8, 8, 8, 8))

    planes = tuple(pad8(p) for p in planes)
    params = _plane_params(maps, lvl8, torch.as_tensor(lim, device=device),
                           torch.as_tensor(mblim, device=device), device)
    alive = _alive(maps, lvl8)
    for r in range(lvl8.shape[0] // 8):
        for c in range(lvl8.shape[1] // 8):
            sb_body(r, c, planes, params, alive, dims)
    return tuple(p[8:-8, 8:-8].to(torch.uint8) for p in planes)


def frame_lf_args(fs):
    """(maps, lvl8, lim, mblim, dims) of a FrameState: its width maps,
    its levels on the superblock grid, the sharpness tables and the 4px
    edge limits of its MI dims."""
    lim, mblim = _luts(fs.h.sharpness)
    lvl8 = np.zeros((fs.sb_rows * 8, fs.sb_cols * 8), np.int32)
    lvl8[:fs.rows, :fs.cols] = fs.lf_lvl
    pw, ph = fs.cols * 8, fs.rows * 8
    dims = (pw >> 2, ph >> 2, pw >> 3, ph >> 3)
    return (fs.wd_v, fs.wd_h, fs.wd_v_uv, fs.wd_h_uv), lvl8, lim, mblim, dims


def loopfilter_frame_tpu(fs, device="cuda"):
    """Loop filter of FrameState planes on `device`; mutates fs.y/u/v.
    Bit-exact vs lf.loopfilter_frame.  Returns the filtered planes on
    the device (uint8, fs's shapes), or None when the frame's filter
    level is 0."""
    if not fs.h.filter_level:
        return None
    out = loopfilter_planes((fs.y, fs.u, fs.v), *frame_lf_args(fs), device)
    fs.y[:] = out[0].cpu().numpy()
    fs.u[:] = out[1].cpu().numpy()
    fs.v[:] = out[2].cpu().numpy()
    return out
