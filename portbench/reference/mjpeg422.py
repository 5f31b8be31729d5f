"""Plain reference of the camera MJPEG cell: 4:2:2 baseline JPEG
coefficients (RFC 2435 type 64: an MCU of Y0 Y1, Cb, Cr) to rgb24 at the
output size, step by step in float64.

The steps are `mjpeg.MjpegReference`'s: from the quantised coefficients
the generator encoded, dequantise, de-zigzag, the 8x8 inverse DCT with
the +128 level shift, the MCU layout (here Y blocks 2x1), the planes cut
to the frame, each plane resized straight to the output's grid (bicubic,
swscale's taps), full range BT.601 to RGB, unrounded before the resize
as the program.  Only two things differ: the layout, and the chroma
planes' grid, half the width and the full height, chroma sited at the
centre of each horizontal pair of luma samples (swscale's default for
4:2:2 "center", which moves nothing vertically).

Nothing here imports the program.
"""

from __future__ import annotations

import torch

from . import scale
from .mjpeg import MjpegReference


def plane_matrices_422(src_w: int, src_h: int, dst_w: int, dst_h: int):
    """(vertical (dst_h, h), horizontal (dst_w, ceil(w / 2))) taps for a
    4:2:2 chroma plane resized straight to the destination's grid."""
    return (scale.bicubic_matrix(dst_h, src_h, src_h / dst_h),
            scale.bicubic_matrix(dst_w, -(-src_w // 2), src_w / dst_w, 0.5,
                                 2.0))


class Mjpeg422Reference(MjpegReference):
    """Reference for 4:2:2 frames of one size and one pair of quantisation
    tables; `rgb` (inherited) runs in `precision` on `device`."""

    def __init__(self, width: int, height: int, out_w: int, out_h: int,
                 q_luma, q_chroma, device, precision: str = "float64"):
        super().__init__(width, height, out_w, out_h, q_luma, q_chroma,
                         device, precision)
        dt = scale.dtype_of(precision)
        self.mats[1] = tuple(
            torch.as_tensor(m, dtype=dt, device=device)
            for m in plane_matrices_422(width, height, out_w, out_h))

    def _planes(self, coef: torch.Tensor):
        """(my, mx, 4, 64) zigzag coefficients -> Y, Cb, Cr sample planes
        cut to the frame (level shift included)."""
        my, mx = coef.shape[:2]
        f = coef.to(self.a.dtype)
        f = torch.cat([f[:, :, :2] * self.q[0], f[:, :, 2:] * self.q[1]], 2)
        f = f[..., self.unzig].reshape(my, mx, 4, 8, 8)   # natural order
        at = self.a.T.contiguous()
        x = scale.matmul(scale.matmul(at, f, self.p), self.a, self.p) + 128.0
        y = x[:, :, :2].permute(0, 3, 1, 2, 4).reshape(my * 8, mx * 16)
        y = y[:self.h, :self.w]
        cw = -(-self.w // 2)
        cb, cr = (x[:, :, k].permute(0, 2, 1, 3).reshape(my * 8, mx * 8)
                  [:self.h, :cw] for k in (2, 3))
        return y, cb, cr
