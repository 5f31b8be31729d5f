"""Plain reference of the clip-graph cell: limited-range BT.601 yuv420p
planes scaled to rgb24 (bicubic, swscale's taps, chroma sited at the
centre) and cropped, in float64.  Returns the RGB code values before
rounding inside the crop; the graph's output is their rounding, clamped
to 0..255, normalised by tensornorm.

Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import scale


class ClipGraphReference:
    def __init__(self, src_w: int, src_h: int, dst_w: int, dst_h: int,
                 crop, device, precision: str = "float64"):
        cw, ch, cx, cy = crop
        self.p = precision
        dt = scale.dtype_of(precision)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        self.mats = []
        for chroma in (False, True):
            mv, mh = scale.plane_matrices(src_w, src_h, dst_w, dst_h, chroma)
            self.mats.append((t(mv[cy:cy + ch]), t(mh[cx:cx + cw].T)))
        self.m = t(scale.yuv2rgb())

    def rgb(self, y: torch.Tensor, u: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
        """(n, 3, crop h, crop w) from (n, h, w), (n, h/2, w/2) x 2 uint8."""
        comps = []
        for plane, (off, span), (mv, mht) in (
                (y, (16.0, 219.0), self.mats[0]),
                (u, (128.0, 224.0), self.mats[1]),
                (v, (128.0, 224.0), self.mats[1])):
            x = (plane.to(mv.dtype) - off) / span
            comps.append(scale.matmul(scale.matmul(mv, x, self.p), mht,
                                      self.p))
        yuv = torch.stack(comps, 1)                  # (n, 3, h, w)
        n, _, h, w = yuv.shape
        rgb = scale.matmul(self.m, yuv.transpose(0, 1).reshape(3, -1), self.p)
        return 255.0 * rgb.reshape(3, n, h, w).transpose(0, 1)
