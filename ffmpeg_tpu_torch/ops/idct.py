"""8x8 block transforms (analog of libavcodec idctdsp/fdctdsp +
simple_idct).

Counterpart of ffmpeg_tpu/ops/idct.py: the zigzag tables, the DCT basis,
`idct8x8` and `fdct8x8`, and the fused JPEG plane transforms.  Every
product runs in full float32 (the reference pins Precision.HIGHEST):
each entry point raises if TF32 or a lower float32 matmul precision is
allowed.  Rounding is half to even in both packages (`jnp.round`,
`torch.round`).  The reference's `jax.jit` wrappers are plain functions
here: PyTorch runs eagerly.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..scale.ops import require_full_fp32

# zigzag scan order (same table as the reference's ff_zigzag_direct)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

UNZIGZAG = np.argsort(ZIGZAG).astype(np.int32)


@lru_cache(maxsize=1)
def _dct8_matrix() -> np.ndarray:
    """Orthonormal-style JPEG IDCT basis: A[u, x] = C(u)/2 cos((2x+1)uπ/16)."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    a = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16.0)
    a[0, :] *= 1.0 / np.sqrt(2.0)
    return a


def idct8x8(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) DCT coeffs → samples (float32): A^T F A, in full
    float32 (the reference pins Precision.HIGHEST): raises if TF32 or a
    lower float32 matmul precision is allowed."""
    require_full_fp32()
    a = torch.as_tensor(_dct8_matrix(), dtype=torch.float32,
                        device=blocks.device)
    return torch.einsum("ux,...uv,vy->...xy", a,
                        blocks.to(torch.float32), a)


def fdct8x8(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) samples → DCT coeffs (float32): A F A^T, in full
    float32."""
    require_full_fp32()
    a = torch.as_tensor(_dct8_matrix(), dtype=torch.float32,
                        device=blocks.device)
    return torch.einsum("ux,...xy,vy->...uv", a,
                        blocks.to(torch.float32), a)


@lru_cache(maxsize=32)
def _recon_matrix(s: int, ncoeff: int) -> np.ndarray:
    """(s*s, ncoeff) matrix mapping the first `ncoeff` zigzag DCT coeffs of
    an 8x8 block to an s×s pixel tile (s=8: exact IDCT; s<8: exact
    block-average downsample of the IDCT, a DCT-domain scaled decode).
    The whole 2-D transform becomes one (blocks, ncoeff)@(ncoeff, s²)
    matmul."""
    a = _dct8_matrix()           # A[u, x]
    # pix[x*8+y, u*8+v] = A[u,x] * A[v,y]
    w_full = np.einsum("ux,vy->xyuv", a, a).reshape(64, 64)
    r = 8 // s
    g = np.zeros((s * s, 64))
    for bx in range(s):
        for by in range(s):
            for ix in range(r):
                for iy in range(r):
                    g[bx * s + by, (bx * r + ix) * 8 + (by * r + iy)] = \
                        1.0 / (r * r)
    w_s = g @ w_full             # (s², 64) in raster coeff order
    w_zz = w_s[:, ZIGZAG]        # columns reordered to zigzag
    return np.ascontiguousarray(w_zz[:, :ncoeff]).astype(np.float32)


@lru_cache(maxsize=64)
def _recon_weights(s: int, ncoeff: int, device: torch.device) -> torch.Tensor:
    """_recon_matrix on `device`, copied there once."""
    return torch.as_tensor(_recon_matrix(s, ncoeff), device=device)


def jpeg_plane_reconstruct(coeffs_zz: torch.Tensor, qtab: torch.Tensor,
                           out_h: int, out_w: int, bit_depth: int = 8,
                           scale: int = 1) -> torch.Tensor:
    """Fused JPEG plane reconstruction, batched over leading dims.

    coeffs_zz: (..., rows, cols, L) int16, first L zigzag coefficients per
               block, as produced by the host entropy stage (L=64 full).
    qtab:      (64,) quantizer, zigzag order (first L entries used).
    scale:     1, 2, 4 or 8 — output is downscaled by `scale` (DCT-domain),
               out_h/out_w are in the downscaled grid.
    Returns (..., out_h, out_w) uint8/uint16 plane (cropped from s×s
    tiles).
    """
    require_full_fp32()
    *lead, rows, cols, ncoeff = coeffs_zz.shape
    dev = coeffs_zz.device
    s = 8 // scale
    w = _recon_weights(s, ncoeff, dev)                     # (s², L)
    q = torch.as_tensor(qtab, device=dev).to(torch.float32)[:ncoeff]
    wq = w * q[None, :]                                   # fold dequant
    flat = coeffs_zz.reshape(*lead, rows * cols, ncoeff).to(torch.float32)
    pix = torch.matmul(flat, wq.T)
    level = 1 << (bit_depth - 1)
    maxv = (1 << bit_depth) - 1
    pix = torch.clamp(pix + (level + 0.5), 0, maxv)  # +0.5: round by the
    pix = pix.reshape(*lead, rows, cols, s, s)        # truncating cast
    nd = pix.ndim
    perm = tuple(range(nd - 4)) + (nd - 4, nd - 2, nd - 3, nd - 1)
    plane = pix.permute(perm).reshape(*lead, rows * s, cols * s)
    dtype = torch.uint8 if bit_depth <= 8 else torch.uint16
    return plane[..., :out_h, :out_w].to(dtype)


def jpeg_block_transform(coeffs_zz: torch.Tensor, qtab: torch.Tensor,
                         out_h: int, out_w: int,
                         bit_depth: int = 8) -> torch.Tensor:
    """The per-plane decode path's entry: jpeg_plane_reconstruct at
    scale 1."""
    return jpeg_plane_reconstruct(coeffs_zz, qtab, out_h, out_w, bit_depth)


def jpeg_forward_transform(plane: torch.Tensor, qtab: torch.Tensor,
                           rows: int, cols: int) -> torch.Tensor:
    """Fused JPEG plane analysis for the encoder: tile → level shift →
    FDCT → quantize → zigzag.  plane: (rows*8, cols*8) float32/uint8.
    Returns (rows, cols, 64) int32 zigzag quantized coefficients."""
    x = plane.to(torch.float32) - 128.0
    blocks = x.reshape(rows, 8, cols, 8).permute(0, 2, 1, 3)
    coeffs = fdct8x8(blocks).reshape(rows, cols, 64)
    zz = coeffs[..., torch.as_tensor(ZIGZAG, dtype=torch.int64,
                                     device=plane.device)]
    q = torch.round(zz / torch.as_tensor(qtab, device=plane.device)
                    .to(torch.float32))
    return q.to(torch.int32)
