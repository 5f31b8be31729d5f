"""3D LUT colour transform (counterpart of ffmpeg_tpu/scale/lut3d.py;
analog of libavfilter/vf_lut3d.c and its .cube loader).

`parse_cube` and `identity_lut` are host copies of the reference's.
`apply_lut3d` maps (..., 3) float RGB through an (N, N, N, 3) table on
the device of its input: each cell corner is one gather from the table
flattened to (N^3, 3) at the flat index (r * N + g) * N + b, and the
tetrahedral (default) or trilinear blend is elementwise.  The reference
jits it, and XLA's CPU backend contracts each blend's `a*b + c*d` into
fma(a, b, c*d); the port computes the same fused multiply-adds (each
product and sum exact in float64, rounded once to float32), eagerly on
the device of the input.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def parse_cube(text: str) -> Tuple[np.ndarray, float, float]:
    """Parse an Adobe/Resolve .cube file → ((N,N,N,3) float32 table with
    [r][g][b] indexing, domain_min, domain_max). vf_lut3d.c parse_cube
    reads entries red-fastest."""
    size = None
    dmin, dmax = 0.0, 1.0
    vals = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        key = parts[0].upper()
        if key == "LUT_3D_SIZE":
            size = int(parts[1])
        elif key == "DOMAIN_MIN":
            dmin = float(parts[1])
        elif key == "DOMAIN_MAX":
            dmax = float(parts[1])
        elif key in ("TITLE", "LUT_1D_SIZE", "LUT_3D_INPUT_RANGE"):
            continue
        else:
            try:
                vals.append([float(parts[0]), float(parts[1]),
                             float(parts[2])])
            except (ValueError, IndexError):
                continue
    if size is None or len(vals) != size ** 3:
        raise ValueError(f"cube: bad file (size={size}, {len(vals)} entries)")
    # file order: r fastest, then g, then b  → reshape (b,g,r,3) → transpose
    t = np.asarray(vals, np.float32).reshape(size, size, size, 3)
    return np.ascontiguousarray(t.transpose(2, 1, 0, 3)), dmin, dmax


def identity_lut(size: int = 17) -> np.ndarray:
    g = np.linspace(0.0, 1.0, size, dtype=np.float32)
    r, gg, b = np.meshgrid(g, g, g, indexing="ij")
    return np.stack([r, gg, b], axis=-1)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c rounded once, as a fused multiply-add: the product
    of two float32 values is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def apply_lut3d(rgb: torch.Tensor, lut: torch.Tensor,
                method: str = "tetrahedral") -> torch.Tensor:
    """Map (..., 3) float RGB in [0,1] through an (N,N,N,3) LUT on the
    same device.

    Tetrahedral interpolation (the vf_lut3d default): the unit cube cell
    is split into 6 tetrahedra by the ordering of the fractional
    coordinates; the result is a 4-point barycentric blend, branchless
    via selects.
    """
    n = lut.shape[0]
    flat = lut.reshape(n * n * n, 3)
    x = torch.clamp(rgb, 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(torch.floor(x).to(torch.int32), 0, n - 2)
    f = x - i0
    i1 = i0 + 1

    def at(ir, ig, ib):
        return flat[((ir * n + ig) * n + ib).long()]

    r0, g0, b0 = i0[..., 0], i0[..., 1], i0[..., 2]
    r1, g1, b1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fr, fg, fb = f[..., 0:1], f[..., 1:2], f[..., 2:3]

    if method == "trilinear":
        c000, c001 = at(r0, g0, b0), at(r0, g0, b1)
        c010, c011 = at(r0, g1, b0), at(r0, g1, b1)
        c100, c101 = at(r1, g0, b0), at(r1, g0, b1)
        c110, c111 = at(r1, g1, b0), at(r1, g1, b1)
        c00 = _fma(c000, 1 - fb, c001 * fb)
        c01 = _fma(c010, 1 - fb, c011 * fb)
        c10 = _fma(c100, 1 - fb, c101 * fb)
        c11 = _fma(c110, 1 - fb, c111 * fb)
        c0 = _fma(c00, 1 - fg, c01 * fg)
        c1 = _fma(c10, 1 - fg, c11 * fg)
        return _fma(c0, 1 - fr, c1 * fr)

    # tetrahedral: order fr/fg/fb and walk the two intermediate corners
    c000 = at(r0, g0, b0)
    c111 = at(r1, g1, b1)
    fr_, fg_, fb_ = fr[..., 0], fg[..., 0], fb[..., 0]

    rg = fr_ >= fg_
    gb = fg_ >= fb_
    rb = fr_ >= fb_
    # biggest axis steps first, then the middle one; ties collapse to
    # zero-weight corners so any consistent tiebreak is exact
    big_r = rg & rb
    big_g = (~rg) & gb
    big_b = ~(big_r | big_g)
    small_r = (~rg) & (~rb)
    small_g = rg & (~gb)
    small_b = rb & gb
    mid_r = ~(big_r | small_r)
    mid_g = ~(big_g | small_g)
    mid_b = ~(big_b | small_b)

    s1r = torch.where(big_r, r1, r0)
    s1g = torch.where(big_g, g1, g0)
    s1b = torch.where(big_b, b1, b0)
    s2r = torch.where(big_r | mid_r, r1, r0)
    s2g = torch.where(big_g | mid_g, g1, g0)
    s2b = torch.where(big_b | mid_b, b1, b0)
    c1 = at(s1r, s1g, s1b)
    c2 = at(s2r, s2g, s2b)

    fmax = torch.maximum(torch.maximum(fr_, fg_), fb_)
    fmin = torch.minimum(torch.minimum(fr_, fg_), fb_)
    fmid = fr_ + fg_ + fb_ - fmax - fmin
    w0 = (1.0 - fmax)[..., None]
    w1 = (fmax - fmid)[..., None]
    w2 = (fmid - fmin)[..., None]
    w3 = fmin[..., None]
    return _fma(c111, w3, _fma(c2, w2, _fma(c000, w0, c1 * w1)))
