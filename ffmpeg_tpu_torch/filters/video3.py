"""Point/blur video filters (counterpart of ffmpeg_tpu/filters/video3.py;
analogs of libavfilter vf_negate.c, vf_eq.c, vf_boxblur.c, vf_unsharp.c,
vf_hue.c).  All are TraceableFilters: they compose with the rest of the
chain and run eagerly on the planes' device, on planes with any leading
batch dims; the blurs use cumulative sums (O(1) per pixel, any radius).
Arithmetic is float32 (int32 for negate), as the reference's jnp."""

from __future__ import annotations

import numpy as np
import torch

from ..formats import pixfmt as _pf
from ..utils.options import opt_float, opt_int
from .base import (TraceableFilter, as_f32, as_i32, edge_pad, rdiv,
                   register_filter, to_dtype)


@register_filter
class NegateFilter(TraceableFilter):
    """Invert every component (vf_negate)."""

    name = "negate"
    OPTIONS = (opt_int("negate_alpha", default=0),)

    def make_tracer(self, props):
        desc = _pf.get(props.format)
        maxv = [(1 << c.depth) - 1 for c in desc.comp]

        def fn(comps):
            out = []
            for i, c in enumerate(comps):
                if i == 3 and not self.negate_alpha:
                    out.append(c)
                else:
                    out.append(to_dtype(maxv[i] - as_i32(c), c.dtype))
            return out
        return fn, props


@register_filter
class EqFilter(TraceableFilter):
    """Brightness / contrast / saturation / gamma (vf_eq semantics:
    brightness [-1,1], contrast [-1000,1000] around 1, saturation [0,3],
    gamma (0,10])."""

    name = "eq"
    OPTIONS = (opt_float("contrast", default=1.0),
               opt_float("brightness", default=0.0),
               opt_float("saturation", default=1.0),
               opt_float("gamma", default=1.0))

    def make_tracer(self, props):
        desc = _pf.get(props.format)
        if desc.is_rgb:
            raise ValueError("eq: YUV input required")
        c = float(self.contrast)
        b = float(self.brightness) * 255.0
        sat = float(self.saturation)
        g = float(self.gamma)

        def fn(comps):
            y = as_f32(comps[0])
            y = (y - 128.0) * c + 128.0 + b
            if g != 1.0:
                y = torch.pow(rdiv(torch.clamp(y, 0.0, 255.0), 255.0),
                              1.0 / g) * 255.0
            out = [to_dtype(torch.clamp(torch.round(y), 0, 255),
                            comps[0].dtype)]
            for ch in comps[1:3]:
                x = (as_f32(ch) - 128.0) * sat + 128.0
                out.append(to_dtype(torch.clamp(torch.round(x), 0, 255),
                                    ch.dtype))
            return out + list(comps[3:])
        return fn, props


def _box1d(x: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """Box average of width 2r+1 along axis with edge clamping, exact
    rational normalization (computed via cumulative sums)."""
    if r <= 0:
        return x
    n = x.shape[axis]
    cs = torch.cumsum(edge_pad(x, r, axis), dim=axis)
    zero = torch.zeros_like(cs.narrow(axis, 0, 1))
    cs = torch.cat([zero, cs], dim=axis)
    hi = cs.narrow(axis, 2 * r + 1, n)
    lo = cs.narrow(axis, 0, n)
    return rdiv(hi - lo, 2 * r + 1)


@register_filter
class BoxBlurFilter(TraceableFilter):
    """Separable box blur, per-plane radii + power (vf_boxblur)."""

    name = "boxblur"
    OPTIONS = (opt_int("luma_radius", default=2),
               opt_int("luma_power", default=1),
               opt_int("chroma_radius", default=-1),
               opt_int("chroma_power", default=-1))

    def make_tracer(self, props):
        desc = _pf.get(props.format)
        lr = int(self.luma_radius)
        lp = max(0, int(self.luma_power))
        cr = int(self.chroma_radius)
        cp = int(self.chroma_power)
        if cr < 0:
            cr = lr
        if cp < 0:
            cp = lp

        def blur(x, r, p):
            y = as_f32(x)
            for _ in range(p):
                y = _box1d(_box1d(y, r, -1), r, -2)
            return to_dtype(torch.clamp(torch.round(y), 0, 255), x.dtype)

        def fn(comps):
            out = []
            for i, c in enumerate(comps):
                r, p = (lr, lp) if (i == 0 or desc.is_rgb) else (cr, cp)
                out.append(blur(c, r, p))
            return out
        return fn, props


@register_filter
class UnsharpFilter(TraceableFilter):
    """Sharpen/blur: out = in + amount * (in - box(in)) (vf_unsharp with
    a box kernel; amount>0 sharpens, <0 blurs)."""

    name = "unsharp"
    OPTIONS = (opt_int("luma_msize_x", default=5),
               opt_int("luma_msize_y", default=5),
               opt_float("luma_amount", default=1.0),
               opt_float("chroma_amount", default=0.0))

    def make_tracer(self, props):
        desc = _pf.get(props.format)
        rx = max(0, (int(self.luma_msize_x) - 1) // 2)
        ry = max(0, (int(self.luma_msize_y) - 1) // 2)
        la = float(self.luma_amount)
        ca = float(self.chroma_amount)

        def sharpen(x, amount):
            if amount == 0.0:
                return x
            y = as_f32(x)
            blur = _box1d(_box1d(y, rx, -1), ry, -2)
            out = y + amount * (y - blur)
            return to_dtype(torch.clamp(torch.round(out), 0, 255), x.dtype)

        def fn(comps):
            out = []
            for i, c in enumerate(comps):
                amount = la if (i == 0 or desc.is_rgb) else ca
                out.append(sharpen(c, amount))
            return out
        return fn, props


@register_filter
class HueFilter(TraceableFilter):
    """Hue rotation (degrees) + saturation on the chroma plane (vf_hue)."""

    name = "hue"
    OPTIONS = (opt_float("h", default=0.0), opt_float("s", default=1.0))

    def make_tracer(self, props):
        desc = _pf.get(props.format)
        if desc.is_rgb:
            raise ValueError("hue: YUV input required")
        rad = float(self.h) * np.pi / 180.0
        s = float(self.s)
        c_, s_ = float(np.cos(rad) * s), float(np.sin(rad) * s)

        def fn(comps):
            u = as_f32(comps[1]) - 128.0
            v = as_f32(comps[2]) - 128.0
            nu = u * c_ - v * s_ + 128.0
            nv = u * s_ + v * c_ + 128.0
            return [comps[0],
                    to_dtype(torch.clamp(torch.round(nu), 0, 255),
                             comps[1].dtype),
                    to_dtype(torch.clamp(torch.round(nv), 0, 255),
                             comps[2].dtype),
                    ] + list(comps[3:])
        return fn, props
