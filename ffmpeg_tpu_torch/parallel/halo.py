"""Halo exchange for spatially-sharded stencil filters; counterpart of
ffmpeg_tpu/parallel/halo.py ("the deblock filter crosses tile edges
exactly like a stencil halo").

A plane sharded by rows over the mesh's 'spatial' axis cannot filter
the edges that straddle shard boundaries without its neighbours' border
rows.  `halo_exchange` moves those rows between the shards' devices
(mesh.ppermute); `sharded_deblock` applies ops/deblock.deblock_plane to
each shard with block-aligned halos attached and equals the unsharded
filter exactly.  This is the tile-parallel communication pattern that
VP9/HEVC tile decoding uses (codecs/vp9/lf_sharded.py,
codecs/hevc/filter_tpu.sharded_filters).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .mesh import Mesh, axis_devices, ppermute, to_device

_POISON = 10000


def halo_exchange(shards: Sequence[torch.Tensor],
                  halo: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """shards: the (rows, w) blocks along one mesh axis, in axis order.
    Returns each shard's (top, bottom): the `halo` boundary rows owned by
    the previous/next shard.  At the mesh edges the halos are poisoned
    with a large offset so threshold-gated stencils treat the frame
    border as unfilterable (matching the unsharded filter, which has no
    edge there)."""
    n = len(shards)
    fwd = [(i, (i + 1) % n) for i in range(n)]       # bottom -> next
    bwd = [((i + 1) % n, i) for i in range(n)]       # top -> previous
    from_prev = ppermute([s[-halo:] for s in shards], fwd)
    from_next = ppermute([s[:halo] for s in shards], bwd)
    from_prev[0] += _POISON
    from_next[-1] += _POISON
    return list(zip(from_prev, from_next))


def sharded_deblock(plane: torch.Tensor, mesh: Mesh, qp: int = 30,
                    block: int = 8, axis: str = "spatial") -> torch.Tensor:
    """Row-sharded deblock with halo exchange; equals the unsharded
    ops/deblock.deblock_plane on the same plane.  Returns a tensor of the
    plane's shape and dtype on the plane's device."""
    from ..ops.deblock import deblock_plane

    halo = block        # block-aligned halo keeps the edge grid intact
    devices = axis_devices(mesh, axis)
    nsh = len(devices)
    h = plane.shape[0]
    if h % (nsh * block) != 0:
        raise ValueError("shard boundaries must be block-aligned")
    rows = h // nsh
    shards = [to_device(plane[k * rows:(k + 1) * rows], d).to(torch.float32)
              for k, d in enumerate(devices)]
    out = []
    for shard, (top, bottom) in zip(shards, halo_exchange(shards, halo)):
        ext = torch.cat([top, shard, bottom], dim=0)
        out.append(deblock_plane(ext, qp=qp, block=block)[halo:halo + rows])
    return torch.cat([to_device(o, plane.device) for o in out],
                     dim=0).to(plane.dtype)
