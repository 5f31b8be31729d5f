"""Plain reference of the MJPEG cell: 4:2:0 baseline JPEG coefficients to
rgb24 at the output size, step by step in float64.

From the quantised coefficients that the benchmark's generator encoded
(Huffman coding is lossless, so they are what a correct entropy decode
gives): dequantise, de-zigzag, the 8x8 inverse DCT with the +128 level
shift, the 2x2 MCU layout, the planes cut to the frame, each plane
resized straight to the output's grid (bicubic, swscale's taps), full
range BT.601 to RGB.  Returns the RGB code values before rounding; the
program's rgb24 is their rounding, clamped to 0..255.

As the flagship pipeline does, the decoded samples are not rounded or
clamped to 8 bits before the resize (its operators fold the inverse DCT
and the resize into one linear map).

Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import scale

# natural index of zigzag position k
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def idct_matrix() -> np.ndarray:
    """A[u, x] = C(u)/2 cos((2x+1)u pi/16); samples = A^T F A."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    a = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16.0)
    a[0] /= np.sqrt(2.0)
    return a


class MjpegReference:
    """Reference for frames of one size and one pair of quantisation
    tables; `rgb` runs in `precision` (scale.matmul) on `device`."""

    def __init__(self, width: int, height: int, out_w: int, out_h: int,
                 q_luma, q_chroma, device, precision: str = "float64"):
        self.w, self.h = width, height
        self.p = precision
        dt = scale.dtype_of(precision)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        self.a = t(idct_matrix())
        self.q = t(np.stack([q_luma, q_chroma]))  # zigzag, as the DQT
        self.unzig = torch.as_tensor(np.argsort(ZIGZAG), device=device)
        self.mats = [tuple(t(m) for m in scale.plane_matrices(
            width, height, out_w, out_h, chroma)) for chroma in (False, True)]
        self.m = t(scale.yuv2rgb())

    def _planes(self, coef: torch.Tensor):
        """(my, mx, 6, 64) zigzag coefficients -> Y, Cb, Cr sample planes
        cut to the frame (level shift included)."""
        my, mx = coef.shape[:2]
        f = coef.to(self.a.dtype)
        f = torch.cat([f[:, :, :4] * self.q[0], f[:, :, 4:] * self.q[1]], 2)
        f = f[..., self.unzig].reshape(my, mx, 6, 8, 8)   # natural order
        at = self.a.T.contiguous()
        x = scale.matmul(scale.matmul(at, f, self.p), self.a, self.p) + 128.0
        y = x[:, :, :4].reshape(my, mx, 2, 2, 8, 8).permute(0, 2, 4, 1, 3, 5)
        y = y.reshape(my * 16, mx * 16)[:self.h, :self.w]
        ch, cw = -(-self.h // 2), -(-self.w // 2)
        cb, cr = (x[:, :, k].permute(0, 2, 1, 3).reshape(my * 8, mx * 8)
                  [:ch, :cw] for k in (4, 5))
        return y, cb, cr

    def rgb(self, coef: torch.Tensor) -> torch.Tensor:
        """(3, out_h, out_w) RGB code values before rounding."""
        y, cb, cr = self._planes(coef)
        comps = []
        for plane, off, (mv, mh) in ((y, 0.0, self.mats[0]),
                                     (cb, 128.0, self.mats[1]),
                                     (cr, 128.0, self.mats[1])):
            r = scale.matmul(scale.matmul(mv, plane - off, self.p),
                             mh.T.contiguous(), self.p)
            comps.append(r)
        yuv = torch.stack(comps)                    # code units, chroma - 128
        return scale.matmul(self.m, yuv.reshape(3, -1), self.p).reshape(
            yuv.shape)
