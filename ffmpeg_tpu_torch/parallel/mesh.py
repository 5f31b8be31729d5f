"""Device mesh & sharding helpers (the multi-device story); counterpart
of ffmpeg_tpu/parallel/mesh.py.

FFmpeg has no distributed runtime; the equivalents here:
  * data axis  — independent frames/clips sharded across devices (the
    analog of frame-pipeline threading)
  * spatial axis — rows or columns of a frame sharded across devices for
    tile-parallel stages (the analog of slice/tile threading), with halo
    exchange between neighbours (parallel/halo.py).

One process drives every position of the mesh, as the reference's
single controller does: a `Mesh` is a grid of `torch.device`s, and a
device may appear more than once (eight `cpu` entries in the tests,
n × `cuda:0` on a one-card machine, distinct cards where a machine has
several).  A sharded value holds one tensor per position, on that
position's device.  The collectives of the reference's shard_map bodies
are plain functions over a list of shards ordered by their position
along one mesh axis: `ppermute` copies each shard to its target's device
(a new tensor even on the same device: a halo never aliases its
sender's plane), a shard's axis index is its place in the list, and the
axis size is the list's length.  No process group is involved, so
nothing here needs `torch.distributed`.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """An n-dimensional grid of torch.devices with named axes."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.array(devices, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(grid[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-d device grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def make_mesh(n_devices: Optional[int] = None,
              spatial: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh with ('data', 'spatial') axes. spatial divides n_devices.
    Without `devices`, every visible CUDA card."""
    if devices is not None:
        devs = list(devices)
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if not devs:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "`devices`")
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n % spatial:
        raise ValueError(f"spatial={spatial} does not divide {n} devices")
    return Mesh([devs[i:i + spatial] for i in range(0, n, spatial)],
                ("data", "spatial"))


def axis_devices(mesh: Mesh, axis: str) -> List[torch.device]:
    """The devices along `axis`, at index 0 of every other axis: where a
    computation replicated over the other axes runs (once: each replica
    would hold the same values)."""
    i = mesh.axis_names.index(axis)
    idx = tuple(slice(None) if j == i else 0
                for j in range(len(mesh.axis_names)))
    return list(mesh.devices[idx])


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A copy of `t` on `device`, always a new tensor (`t.to(device)`
    returns `t` itself when it is there already)."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def ppermute(shards: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """lax.ppermute over one mesh axis: out[dst] is a copy of
    shards[src] on shards[dst]'s device for each (src, dst) of `perm`;
    a position that receives nothing gets zeros."""
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for src, dst in perm:
        out[dst] = to_device(shards[src], shards[dst].device)
    return [torch.zeros_like(s) if o is None else o
            for s, o in zip(shards, out)]


# ---------------------------------------------------------------------------
# sharded values


@dataclass(frozen=True)
class Sharding:
    """NamedSharding's counterpart: tensor dim i is split over the mesh
    axis spec[i] (None, or a dim past the spec: not split)."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    def dim_axis(self, dim: int) -> Optional[str]:
        return self.spec[dim] if dim < len(self.spec) else None


class ShardedTensor:
    """One chunk per mesh position, each on that position's device
    (`shards[position]`, a position being an index tuple into
    mesh.devices), with the global `shape`."""

    def __init__(self, shards: Dict[tuple, torch.Tensor],
                 sharding: Sharding, shape: torch.Size):
        self.shards = shards
        self.sharding = sharding
        self.shape = torch.Size(shape)

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on `device` (default: the first position's):
        the chunks concatenated along each split dim, one replica of each
        taken along the axes the value is replicated over."""
        mesh = self.sharding.mesh
        names = mesh.axis_names
        split = [self.sharding.dim_axis(d) for d in range(len(self.shape))]
        if device is None:
            device = mesh.devices.flat[0]

        def build(dim: int, pos: list) -> torch.Tensor:
            if dim == len(self.shape):
                return to_device(self.shards[tuple(pos)], device)
            ax = split[dim]
            if ax is None:
                return build(dim + 1, pos)
            parts = []
            for i in range(mesh.shape[ax]):
                pos[names.index(ax)] = i
                parts.append(build(dim + 1, pos))
            pos[names.index(ax)] = 0
            return torch.cat(parts, dim=dim)

        return build(0, [0] * len(names))


def put(x, sharding: Sharding) -> ShardedTensor:
    """jax.device_put(x, NamedSharding): split x (a tensor or array) into
    one chunk per mesh position and copy each to its device."""
    x = torch.as_tensor(x)
    mesh = sharding.mesh
    names = mesh.axis_names
    for d in range(x.ndim):
        ax = sharding.dim_axis(d)
        if ax is not None and x.shape[d] % mesh.shape[ax]:
            raise ValueError(f"dim {d} ({x.shape[d]}) does not split over "
                             f"'{ax}' ({mesh.shape[ax]})")
    shards = {}
    for pos in itertools.product(*(range(s) for s in mesh.devices.shape)):
        chunk = x
        for d in range(x.ndim):
            ax = sharding.dim_axis(d)
            if ax is not None:
                n = x.shape[d] // mesh.shape[ax]
                chunk = chunk.narrow(d, pos[names.index(ax)] * n, n)
        shards[pos] = to_device(chunk, mesh.devices[pos])
    return ShardedTensor(shards, sharding, x.shape)


def batch_sharding(mesh: Mesh, spatial_dim: Optional[int] = None,
                   ndim: int = 3) -> Sharding:
    """Sharding for a batch-of-planes array (N, ..., H, W): batch over
    'data', optionally H over 'spatial'."""
    spec: list = [None] * ndim
    spec[0] = "data"
    if spatial_dim is not None:
        spec[spatial_dim] = "spatial"
    return Sharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_batch(mesh: Mesh, arrays: List,
                spatial_dim: Optional[int] = None) -> List[ShardedTensor]:
    """Place each (N, ...) array with batch sharded over 'data'."""
    return [put(a, batch_sharding(mesh, spatial_dim, np.ndim(a)))
            for a in arrays]
