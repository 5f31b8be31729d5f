"""8x8 block transforms (analog of libavcodec idctdsp + simple_idct).

Counterpart of the first part of ffmpeg_tpu/ops/idct.py: the zigzag
tables, the IDCT basis and `idct8x8`.  The rest of that module
(`fdct8x8`, `jpeg_plane_reconstruct`, `jpeg_block_transform`, ...) is
not ported yet.
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
