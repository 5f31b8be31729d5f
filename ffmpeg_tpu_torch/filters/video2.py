"""More video filters (counterpart of ffmpeg_tpu/filters/video2.py):
overlay (2-input, FIFO pairing), split, the psnr/ssim metric sinks, the
yadif deinterlacer, drawbox, fade, deblock and lut3d, analogs of the
corresponding vf_*.c filters.

Every filter computes on the device of its planes.  Where the reference
copies planes through numpy on every frame (overlay, yadif, fade), the
port keeps them where they are; yadif's previous frame stays there too.
psnr and ssim compute their scores in float64 on that device, as the
reference does in numpy; a score is a host float.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..core.frame import Frame
from ..formats import pixfmt as _pf
from ..utils import eval as _eval
from ..utils.error import InvalidData
from ..utils.log import LogMixin
from ..utils.options import opt_int, opt_str
from .base import (Filter, TraceableFilter, _tensor_planes, as_f32, as_f64,
                   max_of, rdiv, register_filter, tdiv, to_dtype,
                   where_value)
from .video import _comp_dims


@register_filter
class SplitFilter(Filter):
    name = "split"
    n_outputs = 2

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        return [frame]      # graph fan-out duplicates by linking consumers


@register_filter
class OverlayFilter(Filter):
    """Overlay second input onto first at (x, y) (vf_overlay analog).
    Simple framesync: pairs frames FIFO (same-rate inputs)."""

    name = "overlay"
    n_inputs = 2
    OPTIONS = (opt_str("x", default="0"), opt_str("y", default="0"))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._q = [deque(), deque()]

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is not None:
            self._q[pad].append(frame)
        out = []
        while self._q[0] and self._q[1]:
            main = self._q[0].popleft()
            over = self._q[1].popleft()
            out.append(self._blend(main, over))
        if frame is None and self._q[0] and not self._q[1]:
            # overlay ended: pass main through
            out.extend(self._q[0])
            self._q[0].clear()
        return out

    def _blend(self, main: Frame, over: Frame) -> Frame:
        names = {"W": main.width, "H": main.height,
                 "w": over.width, "h": over.height,
                 "main_w": main.width, "main_h": main.height,
                 "overlay_w": over.width, "overlay_h": over.height}
        x = int(_eval.eval_expr(str(self.x), names))
        y = int(_eval.eval_expr(str(self.y), names))
        if _pf.get(main.format).name != _pf.get(over.format).name:
            raise InvalidData("overlay: inputs must share pixel format "
                              "(insert a format filter)")
        desc = _pf.get(main.format)
        out = main.clone_props()
        planes = []
        mps, ops = _tensor_planes(main.planes), _tensor_planes(over.planes)
        alpha = None
        if _pf.get(over.format).has_alpha:
            maxv = (1 << desc.comp[-1].depth) - 1
            alpha = tdiv(as_f32(ops[-1]), maxv)
        for i, (mp, op) in enumerate(zip(mps, ops)):
            cw, ch = _comp_dims(main.format, i, over.width, over.height)
            cx, cy = _comp_dims(main.format, i, x, y)
            # clip overlay region to the main frame
            region = mp[cy:cy + ch, cx:cx + cw]
            oh, ow = region.shape
            src = op[:oh, :ow]
            if alpha is not None and i < len(mps) - 1:
                aw = alpha[:oh * (over.height // ch or 1):
                           max(1, over.height // ch),
                           :ow * (over.width // cw or 1):
                           max(1, over.width // cw)]
                aw = aw[:oh, :ow]
                blended = to_dtype(as_f32(src) * aw +
                                   as_f32(region) * (1 - aw), mp.dtype)
            else:
                blended = src
            res = mp.clone()
            res[cy:cy + oh, cx:cx + ow] = blended
            planes.append(res)
        out.planes = planes
        return out


class _MetricBase(Filter, LogMixin):
    n_inputs = 2

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._q = [deque(), deque()]
        self.scores: List[float] = []

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is not None:
            self._q[pad].append(frame)
        out = []
        while self._q[0] and self._q[1]:
            a = self._q[0].popleft()
            b = self._q[1].popleft()
            self.scores.append(self._score(a, b))
            out.append(a)
        return out


@register_filter
class PsnrFilter(_MetricBase):
    """Average PSNR between two inputs (vf_psnr analog); scores exposed on
    the filter instance and logged at EOF."""

    name = "psnr"

    def _score(self, a: Frame, b: Frame) -> float:
        total = 0.0
        npx = 0
        maxv = (1 << _pf.get(a.format).comp[0].depth) - 1
        for pa, pb in zip(_tensor_planes(a.planes), _tensor_planes(b.planes)):
            d = as_f64(pa) - as_f64(pb)
            total = total + (d * d).sum()
            npx += d.numel()
        mse = float(total) / max(1, npx)
        return 10 * np.log10(maxv * maxv / mse) if mse else float("inf")


@register_filter
class SsimFilter(_MetricBase):
    """Global SSIM on the luma plane (vf_ssim's per-frame average analog)."""

    name = "ssim"

    def _score(self, a: Frame, b: Frame) -> float:
        x = as_f64(_tensor_planes(a.planes)[0])
        y = as_f64(_tensor_planes(b.planes)[0])
        c1 = (0.01 * 255) ** 2
        c2 = (0.03 * 255) ** 2
        mx, my = x.mean(), y.mean()
        vx, vy = x.var(unbiased=False), y.var(unbiased=False)
        cov = ((x - mx) * (y - my)).mean()
        return float(((2 * mx * my + c1) * (2 * cov + c2)) /
                     ((mx * mx + my * my + c1) * (vx + vy + c2)))


@register_filter
class YadifFilter(Filter):
    """Deinterlacer (vf_yadif analog, mode 0: one frame per frame): the
    spatial/temporal prediction and the spatial check are whole-plane
    ops on the planes' device; the previous frame stays there."""

    name = "yadif"
    OPTIONS = (opt_int("mode", default=0, min=0, max=3),
               opt_int("parity", default=-1, min=-1, max=1))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._prev: Optional[Frame] = None
        self._field = 0

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            self._prev = None
            return []
        prev = self._prev or frame
        out = frame.clone_props()
        parity = self.parity if self.parity >= 0 else \
            (0 if frame.top_field_first else 1)
        out.planes = [self._deint(p, q, parity)
                      for p, q in zip(_tensor_planes(frame.planes),
                                      _tensor_planes(prev.planes))]
        out.interlaced = False
        self._prev = frame
        return [out]

    @staticmethod
    def _deint(cur: torch.Tensor, prev: torch.Tensor,
               parity: int) -> torch.Tensor:
        c = as_f32(cur)
        p = as_f32(prev)
        up = torch.roll(c, 1, dims=-2)
        down = torch.roll(c, -1, dims=-2)
        spatial = (up + down) * 0.5
        temporal = p
        # simple spatial-temporal blend clipped to neighbor range (yadif core)
        lo = torch.minimum(up, down)
        hi = torch.maximum(up, down)
        interp = torch.minimum(torch.maximum(temporal, lo), hi) * 0.5 + \
            spatial * 0.5
        h = cur.shape[-2]
        rows = torch.arange(h, device=cur.device)[:, None]
        keep = (rows % 2) == parity
        out = torch.where(keep, c, interp)
        return to_dtype(out, cur.dtype)


@register_filter
class DrawBoxFilter(TraceableFilter):
    """drawbox (vf_drawbox analog): the box's border at the component's
    maximum on luma (and RGB) and its midpoint on chroma; `color` is
    accepted and not read, as in the reference."""

    name = "drawbox"
    OPTIONS = (opt_str("x", default="0"), opt_str("y", default="0"),
               opt_str("w", default="iw"), opt_str("h", default="ih"),
               opt_str("color", default="black"),
               opt_int("thickness", default=3))

    def make_tracer(self, props):
        names = {"iw": props.width, "ih": props.height,
                 "in_w": props.width, "in_h": props.height}
        x = int(_eval.eval_expr(str(self.x), names))
        y = int(_eval.eval_expr(str(self.y), names))
        w = int(_eval.eval_expr(str(self.w), names))
        h = int(_eval.eval_expr(str(self.h), names))
        t = self.thickness
        desc = _pf.get(props.format)
        # box color per component: luma white-ish borders by default
        vals = [((1 << c.depth) - 1 if i == 0 or desc.is_rgb else
                 1 << (c.depth - 1)) for i, c in enumerate(desc.comp)]

        def fn(comps):
            out = []
            for i, comp in enumerate(comps):
                cw, chh = _comp_dims(props.format, i, w, h)
                cx, cy = _comp_dims(props.format, i, x, y)
                ct = max(1, _comp_dims(props.format, i, t, t)[0])
                hh, ww = comp.shape[-2], comp.shape[-1]
                yy = torch.arange(hh, device=comp.device)[:, None]
                xx = torch.arange(ww, device=comp.device)[None, :]
                inside = (yy >= cy) & (yy < cy + chh) & (xx >= cx) & \
                    (xx < cx + cw)
                inner = (yy >= cy + ct) & (yy < cy + chh - ct) & \
                        (xx >= cx + ct) & (xx < cx + cw - ct)
                border = inside & ~inner
                out.append(where_value(border, vals[i], comp))
            return out
        return fn, props


@register_filter
class FadeFilter(Filter):
    """Fade in/out over N frames (vf_fade analog)."""

    name = "fade"
    OPTIONS = (opt_str("type", default="in"),
               opt_int("start_frame", default=0),
               opt_int("nb_frames", default=25))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._n = 0

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        idx = self._n
        self._n += 1
        rel = (idx - self.start_frame) / max(1, self.nb_frames)
        a = np.clip(rel if self.type == "in" else 1 - rel, 0.0, 1.0)
        if a >= 1.0:
            return [frame]
        # the float64 factor meets float32 planes as float32, as XLA takes
        # a numpy scalar with x64 off
        a = float(np.float32(a))
        desc = _pf.get(frame.format)
        out = frame.clone_props()
        planes = []
        for i, p in enumerate(_tensor_planes(frame.planes)):
            arr = as_f32(p)
            if not desc.is_rgb and i in (1, 2):
                mid = 1 << (desc.comp[i].depth - 1)
                arr = (arr - mid) * a + mid
            else:
                black = 16.0 if (not desc.is_rgb and
                                 frame.color_range != "pc") else 0.0
                arr = (arr - black) * a + black
            planes.append(to_dtype(arr, p.dtype))
        out.planes = planes
        return [out]


@register_filter
class DeblockFilter(TraceableFilter):
    """Block-edge deblocking (vf_deblock analog, libavfilter/vf_deblock.c)
    on the whole-plane stencil of ops/deblock.py.  Samples clip at the
    container's maximum (65535 for 9-16 bit planes), as in the
    reference."""

    name = "deblock"
    OPTIONS = (opt_int("strength", default=30),   # maps to qp threshold index
               opt_int("block", default=8))

    def make_tracer(self, props):
        from ..ops.deblock import _filter_edges
        qp, block = int(self.strength), int(self.block)

        def fn(comps):
            out = []
            for comp in comps:
                x = as_f32(comp)
                x = _filter_edges(x, qp, -1, block)
                x = _filter_edges(x, qp, -2, block)
                maxv = float(max_of(comp.dtype)) if \
                    not comp.is_floating_point() else 1.0
                out.append(to_dtype(torch.clamp(torch.round(x), 0, maxv),
                                    comp.dtype))
            return out
        return fn, props


@register_filter
class Lut3dFilter(TraceableFilter):
    """Apply a 3D LUT from a .cube file (vf_lut3d analog). Requires an RGB
    input format — insert `format=rgb24`/`gbrp` upstream like ffmpeg does.
    The first three components go in as (r, g, b) in the format's
    component order, as in the reference (for gbrp: g, b, r)."""

    name = "lut3d"
    OPTIONS = (opt_str("file", default=""),
               opt_str("interp", default="tetrahedral"))

    def make_tracer(self, props):
        from ..scale.lut3d import apply_lut3d, identity_lut, parse_cube
        if self.file:
            try:
                with open(self.file) as f:
                    lut, dmin, dmax = parse_cube(f.read())
            except (OSError, ValueError) as e:
                raise InvalidData(f"lut3d: {e}")
        else:
            lut, dmin, dmax = identity_lut(17), 0.0, 1.0
        desc = _pf.get(props.format)
        if not desc.is_rgb or len(desc.comp) < 3:
            raise InvalidData("lut3d: RGB input required (use format filter)")
        method = self.interp
        if method not in ("tetrahedral", "trilinear"):
            raise InvalidData(f"lut3d: unknown interp {method}")
        maxv = float((1 << desc.comp[0].depth) - 1)
        scale = 1.0 / (dmax - dmin)
        on = {}

        def fn(comps):
            dev = comps[0].device
            if dev not in on:           # the table, copied there once
                on[dev] = torch.as_tensor(lut, device=dev)
            rgb = rdiv(torch.stack([as_f32(c) for c in comps[:3]], dim=-1),
                       maxv)
            rgb = (rgb - dmin) * scale
            out = apply_lut3d(rgb, on[dev], method=method)
            out = torch.clamp(torch.round(out * maxv), 0, maxv)
            dt = comps[0].dtype
            res = [to_dtype(out[..., i], dt) for i in range(3)]
            return res + list(comps[3:])
        return fn, props
