"""VP9 in-loop deblock as a wavefront over superblocks, in PyTorch: the
port of ffmpeg_tpu/codecs/vp9/lf_wave.py (reference: libavcodec/vp9.c
loopfilter_sb order; vp9dsp loop_filter).

lf_tpu.py runs the reference's raster superblock loop, 510 superblocks
one after another at 1080p.  The raster order's true dependency set is
{left, top, top-right} (an SB's vertical edges write up to 7 px into the
LEFT neighbour and its horizontal edges up to 7 px into the TOP
neighbour, whose bottom-right corner the top-right neighbour's vertical
edge also touches), so the schedule d = 2*r + c is exact: every SB of a
step depends only on earlier steps, and the 80x80 working tiles of one
step's SBs are disjoint (their column gap is >= 2 SBs).  1080p (17x30
SBs) runs in 62 steps, d = 0 .. 2*16 + 29, instead of 510 (the
reference's docstring says 61).  The edge math is lf_tpu's
edge_filter, so the result is bit-exact against the host filter.

Each step gathers the tiles of all its SBs at once (luma 80x80, chroma
48x48 with an 8-px halo), filters them edge by edge, each edge ONE
edge_filter call over the lanes of every tile of the step (K*64 luma
lanes; 2*K*32 chroma lanes, u and v stacked, since they share their
parameters), and writes the tiles back once.

Where the reference is one compiled program (a lax.scan over the steps,
the tiles vmapped), the port runs eagerly:
 * the steps hold exact lists of SBs.  The reference pads every step to
   the widest step's count and sends the padding lanes to a scratch band
   below the plane (:127-157), only so that lax.scan sees one shape; the
   port has neither the padding nor the band, and no -100 position
   sentinels for padding lanes;
 * a step's tiles are gathered and scattered by one index over the flat
   padded plane (tile bases plus a fixed offset grid), where the
   reference vmaps dynamic_slice and loops dynamic_update_slice;
 * the per-lane parameters (E, I, the HEV threshold, the width and the
   gate, the reference's _lvl_params :35 and _rep, here lf_tpu._params)
   are computed for the whole frame once and laid out edge-major in
   step order, so an edge of a step reads contiguous slices;
 * an edge whose gate is off on every lane of a step (its frame-edge
   position, width and level, all known on the host: lf_tpu._alive) is
   skipped, as is a step with no live edge; the reference filters them
   as pass-throughs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.error import InvalidData
from .lf_tpu import _alive, _plane_params, edge_filter

T = 64          # luma SB size
PAD = 8         # halo pixels kept around each tile
TL = T + 2 * PAD            # 80: luma tile side
TC = T // 2 + 2 * PAD       # 48: chroma tile side


def _schedule(sb_rows, sb_cols):
    """Per-step (kmax-padded) SB index arrays for d = 2r + c (the
    reference's, which its tests and this module's layout read)."""
    nsteps = 2 * (sb_rows - 1) + sb_cols
    steps = []
    kmax = 0
    for d in range(nsteps):
        sbs = [(r, d - 2 * r) for r in range(sb_rows)
               if 0 <= d - 2 * r < sb_cols]
        steps.append(sbs)
        kmax = max(kmax, len(sbs))
    rs = np.zeros((nsteps, kmax), np.int32)
    cs = np.zeros((nsteps, kmax), np.int32)
    valid = np.zeros((nsteps, kmax), bool)
    for i, sbs in enumerate(steps):
        for j, (r, c) in enumerate(sbs):
            rs[i, j], cs[i, j], valid[i, j] = r, c, True
    return rs, cs, valid


@dataclass(frozen=True)
class _Layout:
    """The frame geometry's step lists and gather indices.  SBs are
    listed in step order (`order`, flat r*sb_cols + c, on the device;
    `order_h` on the host); step i holds entries steps[i] = (a, b) of
    it.  Chroma lists each step's SBs twice,
    u's then v's, at entries (2a, 2b).  pos: per edge and listed SB,
    whether the edge's frame-edge position gate is on (luma v, luma h,
    chroma v, chroma h; host arrays, and on the device in the lane
    layout's order as pos_t)."""
    steps: tuple
    order_h: np.ndarray
    order: torch.Tensor
    order2: torch.Tensor
    ybase: torch.Tensor
    cbase: torch.Tensor
    ygrid: torch.Tensor
    cgrid: torch.Tensor
    pos: tuple
    pos_t: tuple


@functools.lru_cache(maxsize=8)
def _layout(sb_rows, sb_cols, hp, wp, dims, device) -> _Layout:
    lim_w, lim_h, lim_wc, lim_hc = dims
    rs, cs, valid = _schedule(sb_rows, sb_cols)
    r, c = rs[valid].astype(np.int64), cs[valid].astype(np.int64)
    counts = valid.sum(1)
    ends = np.cumsum(counts)
    steps = tuple(zip((ends - counts).tolist(), ends.tolist()))
    # chroma: each step's entries twice (u, then v)
    two = np.concatenate([np.r_[a:b, a:b] for a, b in steps])
    wpy, hpc, wpc = wp + 2 * PAD, hp // 2 + 2 * PAD, wp // 2 + 2 * PAD
    uv = np.concatenate([np.r_[np.zeros(b - a, np.int64),
                               np.ones(b - a, np.int64)] for a, b in steps])
    e16, e8 = np.arange(16)[:, None], np.arange(8)[:, None]
    pos = ((c * 16 + e16 > 0) & (c * 16 + e16 < lim_w),
           (r * 16 + e16 > 0) & (r * 16 + e16 < lim_h),
           (c * 8 + e8 > 0) & (c * 8 + e8 < lim_wc),
           (r * 8 + e8 > 0) & (r * 8 + e8 < lim_hc))
    dev = torch.device(device)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)
    grid = np.arange(TL)
    cgrid = np.arange(TC)
    return _Layout(
        steps=steps,
        order_h=r * sb_cols + c,
        order=t(r * sb_cols + c),
        order2=t((r * sb_cols + c)[two]),
        ybase=t(r * T * wpy + c * T),
        cbase=t(uv * hpc * wpc + (r * (T // 2) * wpc + c * (T // 2))[two]),
        ygrid=t(grid[:, None] * wpy + grid[None, :]),
        cgrid=t(cgrid[:, None] * wpc + cgrid[None, :]),
        pos=pos,
        pos_t=(t(pos[0]), t(pos[1]), t(pos[2][:, two]), t(pos[3][:, two])))


def _edge_major(prm, vertical, n, pos_t, order, sb_rows, sb_cols):
    """One plane kind and direction's per-lane parameter maps
    (lf_tpu._plane_params: E, I, Hthr, wd, gate) laid out as
    [edge, listed SB x lane] in `order`, the gate ANDed with the edges'
    position gates: an edge of a step reads a contiguous slice."""
    ne = n // 4
    st = torch.stack([p.to(torch.int32) for p in prm])
    if vertical:        # [px rows, 4px columns]: lanes are rows
        st = st.view(5, sb_rows, n, sb_cols, ne).permute(0, 4, 1, 3, 2)
    else:               # [4px rows, px columns]: lanes are columns
        st = st.view(5, sb_rows, ne, sb_cols, n).permute(0, 2, 1, 3, 4)
    st = st.reshape(5, ne, sb_rows * sb_cols, n).index_select(2, order)
    gate = (st[4] != 0) & pos_t[:, :, None]
    return (tuple(st[k].view(ne, -1) for k in range(4))
            + (gate.view(ne, -1),))


def _live(maps, lvl8, lay, sb_rows, sb_cols):
    """Host bools [edge, step]: whether the edge's gate is on for some
    lane of the step (luma v, luma h, chroma v, chroma h)."""
    al_v, al_h, al_vc, al_hc = _alive(maps, lvl8)
    nsb = sb_rows * sb_cols
    per_sb = (al_v.reshape(sb_rows, 16, sb_cols, 16).any(1)
              .reshape(nsb, 16).T,
              al_h.reshape(sb_rows, 16, sb_cols, 16).any(3)
              .transpose(1, 0, 2).reshape(16, nsb),
              al_vc.reshape(sb_rows, 8, sb_cols, 8).any(1)
              .reshape(nsb, 8).T,
              al_hc.reshape(sb_rows, 8, sb_cols, 8).any(3)
              .transpose(1, 0, 2).reshape(8, nsb))
    starts = [a for a, _b in lay.steps]
    return tuple(np.logical_or.reduceat(m[:, lay.order_h] & p, starts,
                                        axis=1)
                 for m, p in zip(per_sb, lay.pos))


def _filter_tiles(tiles, n, prm_v, prm_h, live_v, live_h):
    """All of one step's tiles (K, n+16, n+16) int32, filtered in place:
    the n/4 vertical edges left to right, then the n/4 horizontal edges
    top to bottom; the reference's _filter_tile_luma (:41, n=64) and
    _filter_tile_chroma (:71, n=32), vmapped there over the tiles, here
    one edge_filter call per edge over the K*n lanes of all of them.
    prm_*: (E, I, Hthr, wd, gate), each [edge, K*n] for these tiles'
    lanes; live_*: host bools per edge (a dead edge is skipped)."""
    K = tiles.shape[0]
    for e in range(n // 4):
        if live_v[e]:
            x = PAD + 4 * e
            slab = tiles[:, PAD:PAD + n, x - 8:x + 8]
            out = edge_filter(slab.reshape(K * n, 16),
                              *(p[e] for p in prm_v))
            slab.copy_(out.view(K, n, 16))
    for e in range(n // 4):
        if live_h[e]:
            y = PAD + 4 * e
            slab = tiles[:, y - 8:y + 8, PAD:PAD + n].transpose(1, 2)
            out = edge_filter(slab.reshape(K * n, 16),
                              *(p[e] for p in prm_h))
            slab.copy_(out.view(K, n, 16))


def loopfilter_wavefront(y8, u8, v8, wd_v, wd_h, wd_v_uv, wd_h_uv,
                         lvl8, lim, mblim, sb_rows, sb_cols, dims):
    """y8/u8/v8: unpadded uint8/int32 planes (SB-padded dims), tensors on
    the one device the filter runs on (anything else raises InvalidData:
    numpy planes are not moved anywhere); the width
    maps and lvl8 (FrameState's, and the per-MI levels) and the lim/mblim
    LUTs are host arrays, read on the host for the dead-edge skip; dims =
    the 4px edge limits (lim_w, lim_h, lim_wc, lim_hc).  Returns filtered
    int32 planes of the same shapes.  Bit-exact vs lf_tpu and lf.py."""
    if not all(isinstance(p, torch.Tensor) for p in (y8, u8, v8)):
        raise InvalidData("vp9 loop filter: the planes must be tensors")
    dev = y8.device
    if u8.device != dev or v8.device != dev:
        raise InvalidData(f"vp9 loop filter: planes on {y8.device}, "
                          f"{u8.device} and {v8.device}")
    hp, wp = y8.shape
    maps = tuple(np.asarray(m) for m in (wd_v, wd_h, wd_v_uv, wd_h_uv))
    lvl8 = np.asarray(lvl8)
    lay = _layout(sb_rows, sb_cols, hp, wp, tuple(int(d) for d in dims),
                  str(dev))
    # a PAD halo and no scratch band below it (the reference's :127-157):
    # no step has padding lanes to send there
    y = F.pad(y8.to(torch.int32), (PAD,) * 4)
    c = F.pad(torch.stack([u8, v8]).to(torch.int32), (PAD,) * 4)
    live = _live(maps, lvl8, lay, sb_rows, sb_cols)
    if any(lv.any() for lv in live):
        params = _plane_params(
            maps, lvl8, torch.as_tensor(np.asarray(lim, np.int32), device=dev),
            torch.as_tensor(np.asarray(mblim, np.int32), device=dev), dev)
        prm = [_edge_major(p, vert, n, pt, order, sb_rows, sb_cols)
               for p, vert, n, pt, order in zip(
                   params, (True, False, True, False), (T, T, T // 2, T // 2),
                   lay.pos_t, (lay.order, lay.order, lay.order2,
                               lay.order2))]
        # (flat plane, tile bases, offset grid, SB side, parameters,
        # live edges, entries per SB: chroma lists u's and v's)
        kinds = ((y.view(-1), lay.ybase, lay.ygrid, T, prm[0:2], live[0:2],
                  1),
                 (c.view(-1), lay.cbase, lay.cgrid, T // 2, prm[2:4],
                  live[2:4], 2))
        for i, (a, b) in enumerate(lay.steps):
            for flat, base, grid, n, (pv, ph), (lv, lh), m in kinds:
                if not (lv[:, i].any() or lh[:, i].any()):
                    continue
                a2, b2 = m * a, m * b
                idx = base[a2:b2, None, None] + grid
                tiles = flat[idx]
                _filter_tiles(tiles, n,
                              [p[:, a2 * n:b2 * n] for p in pv],
                              [p[:, a2 * n:b2 * n] for p in ph],
                              lv[:, i], lh[:, i])
                flat[idx] = tiles
    return (y[PAD:PAD + hp, PAD:PAD + wp],
            c[0, PAD:PAD + hp // 2, PAD:PAD + wp // 2],
            c[1, PAD:PAD + hp // 2, PAD:PAD + wp // 2])
