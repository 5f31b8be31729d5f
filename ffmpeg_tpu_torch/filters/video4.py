"""Additional video filters (counterpart of ffmpeg_tpu/filters/video4.py;
analogs of vf_gblur/avgblur/edgedetect/swapuv/monochrome/vignette/
drawgrid/framestep/select/tmix/noise/blend.c).

The traceable filters run eagerly on the planes' device, on planes with
any leading batch dims, in float32 as the reference's jnp (its float64
numpy kernels taps meet the planes as float32).  tmix keeps its history
on the planes' device; vnoise draws its noise from numpy's generator,
seeded as the reference's, and uploads the draw; blend computes in
float64 on the planes' device, as the reference does in numpy.
"""

from __future__ import annotations

from collections import deque
from functools import lru_cache
from typing import List, Optional

import numpy as np
import torch

from ..core.frame import Frame
from ..utils import eval as _eval
from ..utils.error import InvalidData
from ..utils.options import opt_float, opt_int, opt_str
from .base import (Filter, TraceableFilter, _tensor_planes, as_f32, as_f64,
                   as_i32, edge_pad, register_filter, sqrt_rn, tdiv,
                   to_dtype, where_value)


def _taps(xp: torch.Tensor, k, axis: int, n: int) -> torch.Tensor:
    """sum(k[i] * xp[i:i + n] along axis), in the reference's order."""
    acc = None
    for i, w in enumerate(k):
        t = float(w) * xp.narrow(axis, i, n)
        acc = t if acc is None else acc + t
    return acc


def _sep_conv(plane: torch.Tensor, k) -> torch.Tensor:
    """Separable symmetric convolution with edge replication; taps in
    float32."""
    r = (len(k) - 1) // 2
    kk = np.asarray(k, np.float32)
    x = as_f32(plane)
    x = _taps(edge_pad(x, r, -2), kk, -2, x.shape[-2])
    x = _taps(edge_pad(x, r, -1), kk, -1, plane.shape[-1])
    return x


@register_filter
class GBlurFilter(TraceableFilter):
    """Gaussian blur (vf_gblur.c)."""

    name = "gblur"
    OPTIONS = (opt_float("sigma", default=0.5),
               opt_int("steps", default=1))

    def make_tracer(self, props):
        sigma = max(1e-3, float(self.sigma))
        r = max(1, int(3 * sigma + 0.5))
        t = np.arange(-r, r + 1)
        k = np.exp(-0.5 * (t / sigma) ** 2)
        k /= k.sum()
        steps = max(1, int(self.steps))

        def fn(comps):
            out = []
            for p in comps:
                x = p
                for _ in range(steps):
                    x = _sep_conv(x, k)
                out.append(to_dtype(torch.clamp(torch.round(x), 0, 255),
                                    p.dtype))
            return out
        return fn, props


@register_filter
class AvgBlurFilter(TraceableFilter):
    """Box blur (vf_avgblur.c)."""

    name = "avgblur"
    OPTIONS = (opt_int("sizeX", default=1), opt_int("sizeY", default=0))

    def make_tracer(self, props):
        rx = max(1, int(self.sizeX))
        ry = int(self.sizeY) or rx
        kx = np.float32(np.ones(2 * rx + 1) / (2 * rx + 1))
        ky = np.float32(np.ones(2 * ry + 1) / (2 * ry + 1))

        def fn(comps):
            out = []
            for p in comps:
                x = as_f32(p)
                x = _taps(edge_pad(x, ry, -2), ky, -2, p.shape[-2])
                x = _taps(edge_pad(x, rx, -1), kx, -1, p.shape[-1])
                out.append(to_dtype(torch.clamp(torch.round(x), 0, 255),
                                    p.dtype))
            return out
        return fn, props


@register_filter
class EdgeDetectFilter(TraceableFilter):
    """Sobel-magnitude edge detector (vf_edgedetect.c, mode=wires)."""

    name = "edgedetect"
    OPTIONS = (opt_float("low", default=0.08),
               opt_float("high", default=0.196))

    def make_tracer(self, props):
        lo = float(self.low) * 255
        hi = float(self.high) * 255

        def fn(comps):
            y = as_f32(comps[0])
            yp = edge_pad(edge_pad(y, 1, -2), 1, -1)
            gx = (yp[..., :-2, 2:] + 2 * yp[..., 1:-1, 2:] + yp[..., 2:, 2:]
                  - yp[..., :-2, :-2] - 2 * yp[..., 1:-1, :-2]
                  - yp[..., 2:, :-2])
            gy = (yp[..., 2:, :-2] + 2 * yp[..., 2:, 1:-1] + yp[..., 2:, 2:]
                  - yp[..., :-2, :-2] - 2 * yp[..., :-2, 1:-1]
                  - yp[..., :-2, 2:])
            mag = sqrt_rn(gx * gx + gy * gy) / 4
            e = torch.where(mag >= hi, 255.0,
                            torch.where(mag >= lo, mag, 0.0))
            out = [to_dtype(torch.clamp(torch.round(e), 0, 255),
                            comps[0].dtype)]
            for p in comps[1:]:
                out.append(_neutral(p))
            return out
        return fn, props


def _neutral(p: torch.Tensor) -> torch.Tensor:
    """jnp.full_like(p, 128)."""
    return torch.full_like(p, 128)


@register_filter
class SwapUVFilter(TraceableFilter):
    """Swap chroma planes (vf_swapuv.c)."""

    name = "swapuv"

    def make_tracer(self, props):
        def fn(comps):
            if len(comps) >= 3:
                return [comps[0], comps[2], comps[1]] + list(comps[3:])
            return comps
        return fn, props


@register_filter
class MonochromeFilter(TraceableFilter):
    """Drop chroma to neutral (vf_monochrome.c at default params)."""

    name = "monochrome"

    def make_tracer(self, props):
        def fn(comps):
            return [comps[0]] + [_neutral(p) for p in comps[1:]]
        return fn, props


@lru_cache(maxsize=8)
def _gain_map(h: int, w: int, angle: float) -> np.ndarray:
    """vignette's float32 gain map, made in float64 as the reference's
    (about 0.1 s at 1080p, so made once per size and angle)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    dx = (xx - (w - 1) / 2) / ((w - 1) / 2)
    dy = (yy - (h - 1) / 2) / ((h - 1) / 2)
    dist = np.sqrt(dx * dx + dy * dy) / np.sqrt(2)
    gain = np.cos(angle * dist) ** 4
    return gain.astype(np.float32)


@register_filter
class VignetteFilter(TraceableFilter):
    """Radial light falloff (vf_vignette.c, simplified constant angle):
    the gain map is made on the host in float64, as the reference's, and
    copied to the planes' device once as float32."""

    name = "vignette"
    OPTIONS = (opt_float("angle", default=np.pi / 5),)

    def make_tracer(self, props):
        gmap = _gain_map(props.height, props.width, float(self.angle))
        on = {}

        def fn(comps):
            dev = comps[0].device
            if dev not in on:
                on[dev] = torch.as_tensor(gmap, device=dev)
            out = [to_dtype(torch.clamp(torch.round(
                as_f32(comps[0]) * on[dev]), 0, 255), comps[0].dtype)]
            out.extend(comps[1:])
            return out
        return fn, props


@register_filter
class DrawGridFilter(TraceableFilter):
    """Grid overlay on luma (vf_drawgrid.c, luma-only draw)."""

    name = "drawgrid"
    OPTIONS = (opt_int("width", default=64), opt_int("height", default=64),
               opt_int("thickness", default=1),
               opt_int("luma", default=255))

    def make_tracer(self, props):
        gw, gh = max(2, int(self.width)), max(2, int(self.height))
        t = max(1, int(self.thickness))
        h, w = props.height, props.width
        mask = np.zeros((h, w), bool)
        mask[:, [c for c in range(w) if c % gw < t]] = True
        mask[[r for r in range(h) if r % gh < t], :] = True
        on = {}

        def fn(comps):
            dev = comps[0].device
            if dev not in on:
                on[dev] = torch.as_tensor(mask, device=dev)
            y = where_value(on[dev], int(self.luma), comps[0])
            return [y] + list(comps[1:])
        return fn, props


@register_filter
class FrameStepFilter(Filter):
    """Keep every Nth frame (vf_framestep.c)."""

    name = "framestep"
    OPTIONS = (opt_int("step", default=1),)

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._n = 0

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        keep = self._n % max(1, int(self.step)) == 0
        self._n += 1
        return [frame] if keep else []


@register_filter
class SelectFilter(Filter):
    """Frame selection by expression over n (f_select.c subset:
    variables n, selected_n)."""

    name = "select"
    OPTIONS = (opt_str("expr", default="1"),)

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._n = 0
        self._sel = 0

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        v = _eval.eval_expr(str(self.expr),
                            {"n": self._n, "selected_n": self._sel})
        self._n += 1
        if v:
            self._sel += 1
            return [frame]
        return []


@register_filter
class TMixFilter(Filter):
    """Average the last N frames (vf_tmix.c, uniform weights); the
    history is float32 planes on the planes' device, and the output is
    uint8 whatever the input's type, as in the reference."""

    name = "tmix"
    OPTIONS = (opt_int("frames", default=3),)

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._hist: deque = deque(maxlen=max(1, int(self.frames)))

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        self._hist.append([as_f32(p) for p in _tensor_planes(frame.planes)])
        out = frame.clone_props()
        n = len(self._hist)
        planes = []
        for i in range(len(frame.planes)):
            acc = self._hist[0][i]
            for h in list(self._hist)[1:]:
                acc = acc + h[i]
            planes.append(to_dtype(torch.clamp(torch.round(tdiv(acc, n)), 0,
                                               255),
                                   torch.uint8))
        out.planes = planes
        return [out]


@register_filter
class VideoNoiseFilter(Filter):
    """Additive uniform noise on all planes (vf_noise.c 'u' flag).  The
    noise is numpy's draw from the reference's generator and seed, made
    on the host per plane in the reference's order and copied to the
    planes' device in the narrowest type that holds it."""

    name = "vnoise"
    OPTIONS = (opt_int("strength", default=12), opt_int("seed", default=0))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._rng = np.random.default_rng(int(self.seed))

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        s = int(self.strength)
        wire = np.int8 if s < 128 else np.int16 if s < 1 << 15 else np.int32
        out = frame.clone_props()
        planes = []
        for p in _tensor_planes(frame.planes):
            noise = self._rng.integers(-s, s + 1, tuple(p.shape))
            n = torch.as_tensor(noise.astype(wire), device=p.device)
            planes.append(to_dtype(torch.clamp(as_i32(p) + n, 0, 255),
                                   torch.uint8))
        out.planes = planes
        return [out]


@register_filter
class BlendFilter(Filter):
    """Blend two inputs per-pixel (vf_blend.c subset: all_mode with
    all_opacity), inputs aligned by framesync; float64 on the planes'
    device, uint8 out, as the reference in numpy."""

    name = "blend"
    n_inputs = 2
    OPTIONS = (opt_str("all_mode", default="average"),
               opt_float("all_opacity", default=1.0))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        from .framesync import FrameSync
        self._fs = FrameSync(2)

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        self._fs.push(frame, pad)
        out = []
        for top, bottom in self._fs.events():
            out.append(self._blend(top, bottom))
        return out

    def _blend(self, a: Frame, b: Frame) -> Frame:
        mode = str(self.all_mode)
        op = float(self.all_opacity)
        out = a.clone_props()
        planes = []
        for pa, pb in zip(_tensor_planes(a.planes), _tensor_planes(b.planes)):
            x = as_f64(pa)
            y = as_f64(pb)
            if y.shape != x.shape:
                y = y[:x.shape[0], :x.shape[1]].expand(x.shape)
            if mode == "average":
                v = (x + y) / 2
            elif mode == "addition":
                v = torch.clamp(x + y, max=255)
            elif mode == "subtract":
                v = torch.clamp(x - y, min=0)
            elif mode == "lighten":
                v = torch.maximum(x, y)
            elif mode == "darken":
                v = torch.minimum(x, y)
            elif mode == "multiply":
                v = tdiv(x * y, 255)
            elif mode == "normal":
                v = y
            else:
                raise InvalidData(f"blend: unknown mode {mode!r}")
            v = x * (1 - op) + v * op
            planes.append(to_dtype(torch.clamp(torch.round(v), 0, 255),
                                   torch.uint8))
        out.planes = planes
        return out
