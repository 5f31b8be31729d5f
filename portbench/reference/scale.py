"""Plain resize and colour arithmetic of libswscale's semantics, for the
references: a frozen numpy copy of the bicubic filter bank of the
program's `scale/filters.py` (`resize_matrix`, itself swscale's
initFilter with centre-aligned sampling and edge replication) and of its
BT.601 matrix and levels (`scale/colorspace.py`), kept in float64.

Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Kr, Kb of BT.601 (ITU-R BT.470 System B, G)
KR, KB = 0.299, 0.114


def yuv2rgb() -> np.ndarray:
    """M with [R, G, B] = M [Y, Cb, Cr], all normalised (Y in [0, 1],
    chroma in [-0.5, 0.5])."""
    kg = 1.0 - KR - KB
    return np.array([[1.0, 0.0, 2.0 * (1.0 - KR)],
                     [1.0, -2.0 * KB * (1.0 - KB) / kg,
                      -2.0 * KR * (1.0 - KR) / kg],
                     [1.0, 2.0 * (1.0 - KB), 0.0]])


def bicubic_matrix(out_n: int, in_n: int, scale: float, src_off: float = 0.0,
                   src_step: float = 1.0, a: float = -0.6) -> np.ndarray:
    """(out_n, in_n) float64 taps: output j samples the source at
    ((j + 0.5) * scale - 0.5 - src_off) / src_step in source samples, with
    the cubic of parameter `a` stretched by the downscale factor (area
    anti-aliasing), indices clamped to the edge, rows normalised to 1."""
    j = np.arange(out_n, dtype=np.float64)
    center = ((j + 0.5) * scale - 0.5 - src_off) / src_step
    stretch = max(1.0, scale / src_step)
    radius = 2.0 * stretch
    lo = np.floor(center - radius).astype(np.int64)
    ntaps = int(math.ceil(2 * radius)) + 1
    idx = lo[:, None] + np.arange(ntaps)[None, :]
    x = np.abs((idx - center[:, None]) / stretch)
    w = np.where(x < 1.0, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
                 np.where(x < 2.0, a * x ** 3 - 5 * a * x ** 2 + 8 * a * x
                          - 4 * a, 0.0))
    idx = np.clip(idx, 0, in_n - 1)
    s = w.sum(axis=1, keepdims=True)
    s[s == 0] = 1.0
    m = np.zeros((out_n, in_n))
    np.add.at(m, (np.repeat(np.arange(out_n), ntaps), idx.reshape(-1)),
              (w / s).reshape(-1))
    return m


def plane_matrices(src_w: int, src_h: int, dst_w: int, dst_h: int,
                   chroma: bool):
    """(vertical (dst_h, h), horizontal (dst_w, w)) taps for a 4:2:0
    plane resized straight to the destination's full grid, chroma sited
    at the centre of its 2x2 luma samples (swscale's default)."""
    sx, sy = src_w / dst_w, src_h / dst_h
    if not chroma:
        return (bicubic_matrix(dst_h, src_h, sy),
                bicubic_matrix(dst_w, src_w, sx))
    return (bicubic_matrix(dst_h, -(-src_h // 2), sy, 0.5, 2.0),
            bicubic_matrix(dst_w, -(-src_w // 2), sx, 0.5, 2.0))


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even: what a
    tensor core does to each operand of a TF32 matmul."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in `precision`: "float64"; "float32" (TF32 off); "tf32",
    float32 products of operands rounded to TF32, the lower-precision
    control."""
    if precision == "float64":
        return a.double() @ b.double()
    a, b = a.float(), b.float()
    if precision == "tf32":
        a, b = to_tf32(a), to_tf32(b)
    return a @ b


def dtype_of(precision: str) -> torch.dtype:
    return torch.float64 if precision == "float64" else torch.float32
