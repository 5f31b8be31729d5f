"""Colorspace matrices and level math (the port's copy of
ffmpeg_tpu/scale/colorspace.py; analog of libswscale/csputils.c +
libavutil/csp.c).

All math is derived in *normalized* space: Y', R', G', B' in [0, 1] and
Cb/Cr in [-0.5, 0.5]. Level (range) scaling to/from code values is a
separate affine op so the optimizer can fold it into adjacent linear ops.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..utils.error import InvalidData

# Kr, Kb per colorspace (csp.c luma coefficient table)
LUMA_COEFFS = {
    "bt709": (0.2126, 0.0722),
    "bt470bg": (0.299, 0.114),     # BT.601-625
    "smpte170m": (0.299, 0.114),   # BT.601-525
    "bt601": (0.299, 0.114),
    "smpte240m": (0.212, 0.087),
    "fcc": (0.30, 0.11),
    "bt2020nc": (0.2627, 0.0593),
    "bt2020c": (0.2627, 0.0593),
    "unspecified": (0.2126, 0.0722),   # default to 709 like most tools
}


def yuv2rgb_matrix(colorspace: str) -> np.ndarray:
    """3x3 matrix M so that [R,G,B]^T = M @ [Y, Cb, Cr]^T in normalized space."""
    if colorspace == "ycgco":
        # R = Y - Cg + Co ; G = Y + Cg ; B = Y - Cg - Co  (Cb=Cg, Cr=Co)
        return np.array([[1, -1, 1], [1, 1, 0], [1, -1, -1]], np.float64)
    if colorspace == "rgb":
        return np.eye(3)
    if colorspace not in LUMA_COEFFS:
        raise InvalidData(f"unknown colorspace {colorspace!r}")
    kr, kb = LUMA_COEFFS[colorspace]
    kg = 1.0 - kr - kb
    return np.array([
        [1.0, 0.0, 2.0 * (1.0 - kr)],
        [1.0, -2.0 * kb * (1.0 - kb) / kg, -2.0 * kr * (1.0 - kr) / kg],
        [1.0, 2.0 * (1.0 - kb), 0.0],
    ], np.float64)


def rgb2yuv_matrix(colorspace: str) -> np.ndarray:
    if colorspace == "ycgco":
        return np.linalg.inv(yuv2rgb_matrix("ycgco"))
    if colorspace == "rgb":
        return np.eye(3)
    if colorspace not in LUMA_COEFFS:
        raise InvalidData(f"unknown colorspace {colorspace!r}")
    kr, kb = LUMA_COEFFS[colorspace]
    kg = 1.0 - kr - kb
    return np.array([
        [kr, kg, kb],
        [-0.5 * kr / (1 - kb), -0.5 * kg / (1 - kb), 0.5],
        [0.5, -0.5 * kg / (1 - kr), -0.5 * kb / (1 - kr)],
    ], np.float64)


def yuv_levels(depth: int, full_range: bool) -> Tuple[float, float, float, float]:
    """(y_offset, y_scale, c_offset, c_scale): code = norm * scale + offset.

    Limited (MPEG): Y 16..235, C 16..240 at 8 bit, scaled by 2^(d-8).
    Full (JPEG): Y 0..2^d-1, C centered at 2^(d-1) with span 2^d-1.
    """
    if full_range:
        m = (1 << depth) - 1
        return 0.0, float(m), float(1 << (depth - 1)), float(m)
    s = float(1 << (depth - 8))
    return 16.0 * s, 219.0 * s, 128.0 * s, 224.0 * s


def rgb_levels(depth: int, full_range: bool = True) -> Tuple[float, float]:
    """(offset, scale) for R'G'B' code values. Limited-range RGB is rare but
    supported (e.g. video-range output)."""
    if full_range:
        return 0.0, float((1 << depth) - 1)
    s = float(1 << (depth - 8))
    return 16.0 * s, 219.0 * s


# chroma siting offsets in luma-coordinate units, per AVChromaLocation.
# (dx, dy): position of the chroma sample relative to the top-left luma of
# its 2x2 (or 2x1) group.
CHROMA_LOC_OFFSETS = {
    "left": (0.0, 0.5),
    "center": (0.5, 0.5),
    "topleft": (0.0, 0.0),
    "top": (0.5, 0.0),
    "bottomleft": (0.0, 1.0),
    "bottom": (0.5, 1.0),
    "unspecified": (0.0, 0.5),  # default = left (MPEG-2/4, H.26x)
}


def chroma_offset(loc: str, log2_sub_w: int, log2_sub_h: int) -> Tuple[float, float]:
    """(ox, oy) of chroma sample 0 in luma coords; 0 when not subsampled."""
    dx, dy = CHROMA_LOC_OFFSETS.get(loc, CHROMA_LOC_OFFSETS["unspecified"])
    ox = dx * ((1 << log2_sub_w) - 1) if log2_sub_w else 0.0
    oy = dy * ((1 << log2_sub_h) - 1) if log2_sub_h else 0.0
    return ox, oy
