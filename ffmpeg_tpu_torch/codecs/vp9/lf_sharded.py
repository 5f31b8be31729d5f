"""VP9 loop filter across a device mesh, in PyTorch: tile columns
sharded over the 'spatial' axis, pipelined SB-row wavefront with halo
exchange; counterpart of ffmpeg_tpu/codecs/vp9/lf_sharded.py (the
tile-across-devices pattern of vp9.c:1996 tile decode).

The deblocker's cross-SB dependency graph is (r,c) ← (r,c-1) and
(r,c) ← (r-1,c+1), so shard k may filter SB row r at step t = 2r + k:
T = 2·sb_rows + n steps in all, known on the host.  At each step an
active shard (1) takes fresh 16-px column halos (8 for chroma) from both
neighbours, (2) filters its SB row with lf_tpu's edge passes, writing
INTO the halos too (the tile-boundary vertical edge writes up to 7px
into the left neighbour, interior edges up to 3px into the right), and
(3) sends the edited halos back to their owners.  Two neighbouring
shards are never active in the same step, so the owners are idle and
the merge needs no arbitration.  At the mesh's outer edges the halos
are zeros, the unsharded filter's padding.  The result is bit-exact with
the unsharded filter.

Within a superblock the edges stay sequential, each reading the output
of the one before (an edge's 16-px slab overlaps its neighbour's), as in
lf_tpu: the path is launch-bound.

Where the reference computes every shard at every step and keeps the
active ones' results with `jnp.where`, the port runs only the active
shards: the schedule is on the host, so the list is exact.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...parallel.mesh import Mesh, axis_devices, to_device
from .lf_tpu import _alive, _plane_params, frame_lf_args, sb_body

_HALOS = (16, 8)                 # luma, chroma halo columns


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _strip(a, k: int, n: int):
    """Column strip k of n of a 2-D array or tensor."""
    w = a.shape[1] // n
    return a[:, k * w:(k + 1) * w]


def make_sharded_lf(mesh: Mesh, sb_rows: int, sb_cols_local: int, dims,
                    axis: str = "spatial"):
    """→ fn(y, u, v, wd_v, wd_h, wd_v_uv, wd_h_uv, lvl8, lim, mblim) →
    the filtered (y, u, v), int32, on the first shard's device.  Planes
    are (Hp+16, Wp) etc — rows pre-padded by 8, columns exact; each goes
    to its shard's device in column strips, as do the maps.  dims =
    (lim_w, lim_h, lim_wc, lim_hc) global 4px extents."""
    devices = axis_devices(mesh, axis)
    n_sh = len(devices)
    T = 2 * sb_rows + n_sh

    def fn(y, u, v, wd_v, wd_h, wd_v_uv, wd_h_uv, lvl8, lim, mblim):
        maps = [_host(m) for m in (wd_v, wd_h, wd_v_uv, wd_h_uv)]
        lvl8 = _host(lvl8)
        # the shards' planes, maps and per-lane parameters
        shards = []
        for k, dev in enumerate(devices):
            mk = tuple(_strip(m, k, n_sh) for m in maps)
            lk = _strip(lvl8, k, n_sh)
            planes = [to_device(_strip(torch.as_tensor(p), k, n_sh),
                                dev).to(torch.int32) for p in (y, u, v)]
            prm = _plane_params(mk, lk, to_device(torch.as_tensor(lim), dev),
                                to_device(torch.as_tensor(mblim), dev), dev)
            shards.append((planes, prm, _alive(mk, lk)))
        wl, wlc = shards[0][0][0].shape[1], shards[0][0][1].shape[1]

        for t in range(T):
            for k in range(n_sh):
                if (t - k) % 2 or not 0 <= (t - k) // 2 < sb_rows:
                    continue            # inactive: the reference discards it
                r = (t - k) // 2
                planes, prm, alive = shards[k]
                exts = []
                for i, pl in enumerate(planes):
                    h = _HALOS[min(i, 1)]
                    left = (to_device(shards[k - 1][0][i][:, -h:], pl.device)
                            if k > 0 else pl.new_zeros(pl.shape[0], h))
                    right = (to_device(shards[k + 1][0][i][:, :h], pl.device)
                             if k + 1 < n_sh else
                             pl.new_zeros(pl.shape[0], h))
                    exts.append(torch.cat([left, pl, right], dim=1))
                for c in range(sb_cols_local):
                    sb_body(r, c, exts, prm, alive, dims, _HALOS,
                            (k * wl // 4, k * wlc // 4))
                # own columns home; the edited halos back to their owners
                for i, (pl, ext) in enumerate(zip(planes, exts)):
                    h = _HALOS[min(i, 1)]
                    pl.copy_(ext[:, h:-h])
                    if k > 0:
                        shards[k - 1][0][i][:, -h:].copy_(ext[:, :h])
                    if k + 1 < n_sh:
                        shards[k + 1][0][i][:, :h].copy_(ext[:, -h:])
        return tuple(torch.cat([to_device(s[0][i], devices[0])
                                for s in shards], dim=1) for i in range(3))

    return fn


def loopfilter_sharded(fs, mesh: Mesh, axis: str = "spatial"):
    """Filter fs planes with tile columns sharded over `mesh`; mutates
    fs.y/u/v, bit-exact vs lf.loopfilter_frame.  Returns the filtered
    planes (uint8) on the first shard's device, or None when the frame's
    filter level is 0.  Requires sb_cols divisible by the mesh axis
    size."""
    if not fs.h.filter_level:
        return None
    n_sh = mesh.shape[axis]
    if fs.sb_cols % n_sh:
        raise ValueError("sb_cols must divide over the mesh axis")
    maps, lvl8, lim, mblim, dims = frame_lf_args(fs)

    def padr(a):                          # pad rows only
        return F.pad(torch.from_numpy(a).to(torch.int32), (0, 0, 8, 8))

    fn = make_sharded_lf(mesh, fs.sb_rows, fs.sb_cols // n_sh, dims, axis)
    out = tuple(p[8:-8].to(torch.uint8) for p in
                fn(padr(fs.y), padr(fs.u), padr(fs.v), *maps, lvl8, lim,
                   mblim))
    fs.y[:], fs.u[:], fs.v[:] = (p.cpu().numpy() for p in out)
    return out
