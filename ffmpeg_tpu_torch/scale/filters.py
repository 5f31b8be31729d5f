"""Resize filter-bank builders (the port's copy of
ffmpeg_tpu/scale/filters.py; analog of libswscale/utils.c initFilter +
libswresample-style windowed kernels).

A resize along one axis is a dense (out_n, in_n) matrix of polyphase
filter taps, so the whole resize is two matrix products (V @ img @ H^T).
Matrices are built on the host in float64 and handed over as float32.

Grid convention: center-aligned sampling like the reference's default
(src = (dst + 0.5) * in/out - 0.5), with explicit source/dest offsets so
chroma siting (colorspace.chroma_offset) plumbs straight in.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

from ..utils.error import InvalidData

# flag names match SWS_* scaler selection (swscale.h)
FILTERS = ("fast_bilinear", "bilinear", "bicubic", "experimental", "neighbor",
           "area", "bicublin", "gauss", "sinc", "lanczos", "spline")


def _kernel(name: str, param: float | None):
    """Return (support, f(x)) continuous kernel."""
    if name in ("bilinear", "fast_bilinear", "bicublin", "triangle"):
        return 1.0, lambda x: np.maximum(0.0, 1.0 - np.abs(x))
    if name == "neighbor":
        return 0.5001, lambda x: (np.abs(x) <= 0.5).astype(np.float64)
    if name == "area":
        # box; stretched by the scale factor for true area averaging
        return 0.5, lambda x: (np.abs(x) <= 0.5).astype(np.float64)
    if name == "bicubic":
        a = -0.6 if param is None else -abs(param)

        def cubic(x):
            x = np.abs(x)
            x2 = x * x
            x3 = x2 * x
            return np.where(
                x < 1.0, (a + 2) * x3 - (a + 3) * x2 + 1,
                np.where(x < 2.0, a * x3 - 5 * a * x2 + 8 * a * x - 4 * a, 0.0))
        return 2.0, cubic
    if name == "lanczos":
        a = 3.0 if param is None else float(param)

        def lanczos(x):
            x = np.abs(x)
            px = np.pi * x
            with np.errstate(invalid="ignore", divide="ignore"):
                v = a * np.sin(px) * np.sin(px / a) / (px * px)
            return np.where(x < 1e-8, 1.0, np.where(x < a, v, 0.0))
        return a, lanczos
    if name == "gauss":
        p = 3.0 if param is None else float(param)
        # swscale gauss: 2^(-p*x^2) with quality param p, support ~ sqrt(8/p)
        return math.sqrt(8.0 / p) + 1.0, lambda x: np.power(2.0, -p * x * x)
    if name == "sinc":
        def sinc(x):
            px = np.pi * x
            with np.errstate(invalid="ignore", divide="ignore"):
                v = np.sin(px) / px
            return np.where(np.abs(x) < 1e-8, 1.0, v)
        return 4.0, sinc
    if name == "spline":
        # cubic B-spline (Mitchell B=1, C=0)
        def bspline(x):
            x = np.abs(x)
            return np.where(
                x < 1.0, (4.0 + x * x * (3.0 * x - 6.0)) / 6.0,
                np.where(x < 2.0, ((2.0 - x) ** 3) / 6.0, 0.0))
        return 2.0, bspline
    if name == "experimental":
        return 4.0, lambda x: np.exp(-2.0 * x * x) * np.sinc(x)
    raise InvalidData(f"unknown scale filter {name!r}")


def resize_matrix(out_n: int, in_n: int, filter_name: str = "bicubic",
                  param: float | None = None, antialias: bool = True,
                  scale: float | None = None,
                  src_off: float = 0.0, dst_off: float = 0.0,
                  src_step: float = 1.0, dst_step: float = 1.0) -> np.ndarray:
    """Build the (out_n, in_n) tap matrix for one axis.

    Coordinates: source sample i sits at `src_off + i*src_step`, dest sample
    j at `dst_off + j*dst_step`, both in a common (luma) coordinate space
    scaled so the *image extents* map via the global `scale` (in/out in that
    space). For plain same-grid resizes use the defaults.
    """
    if scale is None:
        scale = in_n / out_n if out_n else 1.0
    # dest sample j's center in source-sample units:
    j = np.arange(out_n, dtype=np.float64)
    center = ((dst_off + j * dst_step + 0.5) * scale - 0.5 - src_off) / src_step

    support, f = _kernel(filter_name, param)
    # downscale: stretch kernel for anti-aliasing (like initFilter's xInc>1 path)
    eff_scale = scale * dst_step / src_step
    stretch = max(1.0, eff_scale) if (antialias and filter_name != "neighbor") else 1.0
    radius = support * stretch

    lo = np.floor(center - radius).astype(np.int64)
    ntaps = int(math.ceil(2 * radius)) + 1
    offs = np.arange(ntaps, dtype=np.int64)
    idx = lo[:, None] + offs[None, :]                  # (out_n, ntaps)
    x = (idx.astype(np.float64) - center[:, None]) / stretch
    w = f(x)
    # clamp indices (edge replication like the reference's edge handling)
    idx = np.clip(idx, 0, in_n - 1)
    # normalize
    s = w.sum(axis=1, keepdims=True)
    s[s == 0] = 1.0
    w = w / s
    m = np.zeros((out_n, in_n), np.float64)
    np.add.at(m, (np.repeat(np.arange(out_n), ntaps), idx.reshape(-1)), w.reshape(-1))
    return m.astype(np.float32)
