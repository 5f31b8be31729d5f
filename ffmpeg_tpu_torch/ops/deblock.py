"""Block-edge deblocking stencil (counterpart of ffmpeg_tpu/ops/deblock.py;
analog of the h264dsp loop filter / mpegvideo deblock).

Every internal block edge of a plane filters at once: strided slices
select the p1 p0 | q0 q1 sample lines, the strength test is elementwise,
and the filtered p0/q0 lines are written back into a copy.  The
reference jits `deblock_plane`; here it runs eagerly on the device of its
input, on planes with any leading batch dims.  `_ALPHA` and `_BETA` are
the port's own copies of the reference's tables.
"""

from __future__ import annotations

import numpy as np
import torch

# alpha/beta thresholds indexed by qp (H.264 Table 8-16 shape; trimmed)
_ALPHA = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28,
    32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144,
    162, 182, 203, 226, 255, 255], np.float32)
_BETA = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8,
    9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15,
    16, 16, 17, 17, 18, 18], np.float32)


def _lines(x: torch.Tensor, axis: int, offset: int, block: int,
           nedges: int) -> torch.Tensor:
    """The sample line at `offset` from every internal edge along `axis`:
    indices block+offset, 2*block+offset, ..., nedges*block+offset."""
    start = block + offset
    return x.narrow(axis, start, (nedges - 1) * block + 1)[
        (Ellipsis, slice(None, None, block)) if axis == -1 else
        (Ellipsis, slice(None, None, block), slice(None))]


def _filter_edges(x: torch.Tensor, qp: int, axis: int,
                  block: int) -> torch.Tensor:
    """Filter the p1 p0 | q0 q1 samples across every internal edge along
    `axis` (-1: vertical edges, -2: horizontal) of float32 `x` (normal
    bS<4 H.264-style filter, elementwise); returns a new tensor."""
    alpha = float(_ALPHA[min(qp, 51)])
    beta = float(_BETA[min(qp, 51)])
    n = x.shape[axis]
    nedges = n // block - 1
    if nedges <= 0 or alpha == 0:
        return x
    p1, p0, q0, q1 = (_lines(x, axis, o, block, nedges)
                      for o in (-2, -1, 0, 1))
    f = ((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta) & \
        ((q1 - q0).abs() < beta)
    delta = torch.clamp((((q0 - p0) * 4) + (p1 - q1)) / 8.0, -2.0, 2.0)
    p0n = torch.where(f, p0 + delta, p0)
    q0n = torch.where(f, q0 - delta, q0)
    x = x.clone()
    _lines(x, axis, -1, block, nedges).copy_(p0n)
    _lines(x, axis, 0, block, nedges).copy_(q0n)
    return x


def deblock_plane(plane: torch.Tensor, qp: int = 30,
                  block: int = 8) -> torch.Tensor:
    """Deblock all internal block edges (vertical then horizontal) of a
    (..., H, W) plane. Returns the same dtype."""
    from ..filters.base import as_f32, to_dtype
    x = as_f32(plane)
    x = _filter_edges(x, qp, -1, block)   # vertical edges (along width)
    x = _filter_edges(x, qp, -2, block)   # horizontal edges
    out = torch.clamp(torch.round(x), 0, 255)
    return to_dtype(out, plane.dtype)
