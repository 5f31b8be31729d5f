"""Core video filters (counterpart of ffmpeg_tpu/filters/video.py; analogs
of libavfilter/vf_*.c).

Traceable filters (crop/pad/flip/transpose/format/scale/normalize/lut)
compose into one function of the planes, run eagerly on their device;
rate/timestamp filters (fps, trim, setpts) are host-side control flow.
Every traceable filter indexes the last two dims, so planes with leading
batch dims go through as they are.

Torch has no negative-step slice: the flips are `torch.flip`.  Flips and
pads of 16-bit planes run on their int16 view of the same bits, because
torch implements few ops for uint16.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import imgutils
from ..core.frame import Frame
from ..formats import pixfmt as _pf
from ..scale.ops import compile_ops
from ..scale.swscale import ScaleSpec, build_ops
from ..utils import eval as _eval
from ..utils.error import InvalidData
from ..utils.options import (Option, OptType, opt_bool, opt_float, opt_int,
                             opt_str)
from ..utils.rational import NOPTS, Rational, rescale_q
from .base import Filter, TraceableFilter, VideoProps, register_filter

# unsigned types torch supports only barely, and their signed views
_SIGNED = {torch.uint16: (torch.int16, np.uint16, np.int16),
           torch.uint32: (torch.int32, np.uint32, np.int32)}


def _comp_dims(fmt: str, i: int, w: int, h: int) -> Tuple[int, int]:
    return imgutils.component_dims(_pf.get(fmt), i, w, h)


def _flip(c: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    s = _SIGNED.get(c.dtype)
    if s is None:
        return torch.flip(c, dims)
    return torch.flip(c.view(s[0]), dims).view(c.dtype)


@register_filter
class NullFilter(Filter):
    name = "null"
    description = "pass through"


@register_filter
class CopyFilter(TraceableFilter):
    name = "copy"
    description = "copy frames"

    def make_tracer(self, props):
        return (lambda comps: comps), props


@register_filter
class FormatFilter(TraceableFilter):
    name = "format"
    description = "convert pixel format"
    OPTIONS = (opt_str("pix_fmts"),)

    def make_tracer(self, props: VideoProps):
        want = (self.pix_fmts or "").split("|")[0]
        if not want:
            raise InvalidData("format: pix_fmts required")
        dst = _pf.get(want).name
        if dst == _pf.get(props.format).name:
            return (lambda comps: comps), props
        spec = ScaleSpec(src_w=props.width, src_h=props.height,
                         src_fmt=props.format, dst_w=props.width,
                         dst_h=props.height, dst_fmt=dst,
                         src_range=props.color_range == "pc",
                         src_colorspace=props.color_space
                         if props.color_space not in ("unspecified", "rgb")
                         else "bt470bg")
        fn = compile_ops(build_ops(spec))
        kind_rgb = _pf.get(dst).is_rgb
        out = replace(props, format=dst,
                      color_range="pc" if kind_rgb else props.color_range,
                      color_space="rgb" if kind_rgb else props.color_space)
        return fn, out


@register_filter
class ScaleFilter(TraceableFilter):
    name = "scale"
    description = "resize and/or convert pixel format"
    OPTIONS = (
        opt_str("w", default="iw"), opt_str("h", default="ih"),
        opt_str("flags", default="bicubic"),
        opt_str("format"),
        Option("in_range", type=OptType.STRING, default=None),
        Option("out_range", type=OptType.STRING, default=None),
        opt_float("param0", default=float("nan")),
        opt_bool("force_original_aspect_ratio", default=False),
    )

    def make_tracer(self, props: VideoProps):
        names = {"iw": props.width, "ih": props.height,
                 "in_w": props.width, "in_h": props.height,
                 "a": props.width / props.height,
                 "sar": float(props.sample_aspect_ratio) or 1.0,
                 "hsub": 1 << _pf.get(props.format).log2_chroma_w,
                 "vsub": 1 << _pf.get(props.format).log2_chroma_h}
        w = int(_eval.eval_expr(str(self.w), {**names, "oh": 0, "ow": 0}))
        h = int(_eval.eval_expr(str(self.h), {**names, "ow": w, "oh": 0}))
        if w <= 0 and h <= 0:
            w, h = props.width, props.height
        if w <= 0:
            step = -w or 1
            w = round(props.width * h / props.height / step) * step
        if h <= 0:
            step = -h or 1
            h = round(props.height * w / props.width / step) * step
        dst_fmt = _pf.get(self.format).name if self.format else props.format
        filt = str(self.flags).split("+")[0] or "bicubic"
        src_range = props.color_range == "pc" or \
            self.in_range in ("pc", "jpeg", "full")
        dst_range = (self.out_range in ("pc", "jpeg", "full")) \
            if self.out_range else src_range
        param = None if (self.param0 != self.param0) else self.param0
        spec = ScaleSpec(
            src_w=props.width, src_h=props.height, src_fmt=props.format,
            dst_w=w, dst_h=h, dst_fmt=dst_fmt, filter=filt, param=param,
            src_range=src_range, dst_range=dst_range,
            src_colorspace=props.color_space
            if props.color_space not in ("unspecified", "rgb") else "bt470bg")
        fn = compile_ops(build_ops(spec))
        kind_rgb = _pf.get(dst_fmt).is_rgb
        out = replace(props, width=w, height=h, format=_pf.get(dst_fmt).name,
                      color_range="pc" if (kind_rgb or dst_range) else "tv",
                      color_space="rgb" if kind_rgb else props.color_space)
        return fn, out


@register_filter
class CropFilter(TraceableFilter):
    name = "crop"
    description = "crop the frame"
    OPTIONS = (
        opt_str("w", default="iw"), opt_str("h", default="ih"),
        opt_str("x", default="(in_w-out_w)/2"),
        opt_str("y", default="(in_h-out_h)/2"),
        opt_bool("exact", default=False),
    )

    def make_tracer(self, props: VideoProps):
        names = {"iw": props.width, "ih": props.height,
                 "in_w": props.width, "in_h": props.height}
        w = int(_eval.eval_expr(str(self.w), names))
        h = int(_eval.eval_expr(str(self.h), names))
        names.update({"ow": w, "oh": h, "out_w": w, "out_h": h})
        x = int(_eval.eval_expr(str(self.x), names))
        y = int(_eval.eval_expr(str(self.y), names))
        desc = _pf.get(props.format)
        # snap crop origin to chroma grid (like vf_crop non-exact mode)
        x &= ~((1 << desc.log2_chroma_w) - 1)
        y &= ~((1 << desc.log2_chroma_h) - 1)
        if w <= 0 or h <= 0 or x < 0 or y < 0 or \
                x + w > props.width or y + h > props.height:
            raise InvalidData(f"crop: invalid area {w}x{h}+{x}+{y}")
        fmt = props.format

        def fn(comps):
            out = []
            for i, c in enumerate(comps):
                cw, ch_ = _comp_dims(fmt, i, w, h)
                cx, cy = _comp_dims(fmt, i, x, y)
                out.append(c[..., cy:cy + ch_, cx:cx + cw])
            return out
        return fn, replace(props, width=w, height=h)


@register_filter
class PadFilter(TraceableFilter):
    name = "pad"
    description = "pad the frame"
    OPTIONS = (
        opt_str("w", default="iw"), opt_str("h", default="ih"),
        opt_str("x", default="(ow-iw)/2"), opt_str("y", default="(oh-ih)/2"),
        opt_str("color", default="black"),
    )

    def make_tracer(self, props: VideoProps):
        names = {"iw": props.width, "ih": props.height,
                 "in_w": props.width, "in_h": props.height}
        w = int(_eval.eval_expr(str(self.w), names))
        h = int(_eval.eval_expr(str(self.h), names))
        if w < props.width:
            w = props.width
        if h < props.height:
            h = props.height
        names.update({"ow": w, "oh": h, "out_w": w, "out_h": h})
        x = int(_eval.eval_expr(str(self.x), names))
        y = int(_eval.eval_expr(str(self.y), names))
        desc = _pf.get(props.format)
        x &= ~((1 << desc.log2_chroma_w) - 1)
        y &= ~((1 << desc.log2_chroma_h) - 1)
        fmt = props.format
        fill = imgutils.fill_black(fmt, 2, 2,
                                   limited_range=props.color_range != "pc")
        fills = [float(np.asarray(f)[0, 0]) for f in fill]

        def fn(comps):
            out = []
            for i, c in enumerate(comps):
                cw, ch_ = _comp_dims(fmt, i, w, h)
                iw, ih_ = _comp_dims(fmt, i, props.width, props.height)
                cx, cy = _comp_dims(fmt, i, x, y)
                pads = (cx, cw - iw - cx, cy, ch_ - ih_ - cy)
                s = _SIGNED.get(c.dtype)
                if s is None:
                    v = fills[i] if c.is_floating_point() else int(fills[i])
                    out.append(F.pad(c, pads, mode="constant", value=v))
                else:
                    v = int(np.array(int(fills[i]), s[1]).view(s[2]))
                    out.append(F.pad(c.view(s[0]), pads, mode="constant",
                                     value=v).view(c.dtype))
            return out
        return fn, replace(props, width=w, height=h)


@register_filter
class HFlipFilter(TraceableFilter):
    name = "hflip"
    description = "horizontal flip"

    def make_tracer(self, props):
        return (lambda comps: [_flip(c, (-1,)) for c in comps]), props


@register_filter
class VFlipFilter(TraceableFilter):
    name = "vflip"
    description = "vertical flip"

    def make_tracer(self, props):
        return (lambda comps: [_flip(c, (-2,)) for c in comps]), props


@register_filter
class TransposeFilter(TraceableFilter):
    name = "transpose"
    description = "rotate/transpose"
    OPTIONS = (opt_int("dir", default=0, min=0, max=3),)
    # 0=ccw+vflip 1=cw 2=ccw 3=cw+vflip (matching vf_transpose)

    def make_tracer(self, props: VideoProps):
        d = self.dir
        flips = {0: (), 1: (-1,), 2: (-2,), 3: (-2, -1)}[d]

        def fn(comps):
            out = []
            for c in comps:
                t = torch.swapaxes(c, -1, -2)
                out.append(_flip(t, flips) if flips else t)
            return out
        return fn, replace(props, width=props.height, height=props.width)


@register_filter
class NormalizeFilter(TraceableFilter):
    """ML-dataloader normalize: uint RGB → float (x/scale - mean)/std.
    (No direct reference analog; covers the BASELINE 'normalize' stage.)
    The float32 operations run in the reference's order."""

    name = "tensornorm"
    OPTIONS = (
        opt_str("mean", default="0.485:0.456:0.406"),
        opt_str("std", default="0.229:0.224:0.225"),
        opt_float("scale", default=255.0),
    )

    def make_tracer(self, props: VideoProps):
        mean = [float(x) for x in str(self.mean).replace(",", ":").split(":")]
        std = [float(x) for x in str(self.std).replace(",", ":").split(":")]
        nc = _pf.get(props.format).nb_components
        if len(mean) == 1:
            mean *= nc
        if len(std) == 1:
            std *= nc
        sc = self.scale

        def fn(comps):
            return [(c.to(torch.float32) / sc - m) / s
                    for c, m, s in zip(comps, mean, std)]
        return fn, props

    def update_frame_props(self, frame, out_props):
        frame = super().update_frame_props(frame, out_props)
        return frame


@register_filter
class LutFilter(TraceableFilter):
    """Per-component expression LUT (vf_lut analog): c0..c3/val exprs are
    precomputed into tables on the host, applied as a gather on the
    planes' device.  Every index is in range by construction (a sample
    is at most maxval), so the gather needs no clamp."""

    name = "lut"
    OPTIONS = (opt_str("c0", default="val"), opt_str("c1", default="val"),
               opt_str("c2", default="val"), opt_str("c3", default="val"))

    def make_tracer(self, props: VideoProps):
        desc = _pf.get(props.format)
        maxv = (1 << desc.depth) - 1
        tables = []
        for i in range(desc.nb_components):
            expr = [self.c0, self.c1, self.c2, self.c3][i]
            vals = np.arange(maxv + 1, dtype=np.float64)
            out = np.array([_eval.eval_expr(str(expr), {
                "val": v, "maxval": maxv, "minval": 0, "w": props.width,
                "h": props.height}) for v in vals])
            tables.append(np.clip(np.round(out), 0, maxv)
                          .astype(desc.component_dtype()))
        on: Dict[torch.device, List[torch.Tensor]] = {}

        def fn(comps):
            dev = comps[0].device
            if dev not in on:           # the tables, copied there once
                on[dev] = [torch.as_tensor(t, device=dev) for t in tables]
            return [t[c.long()] for t, c in zip(on[dev], comps)]
        return fn, props


# ---------------------------------------------------------------------------
# host-side control filters
# ---------------------------------------------------------------------------

def _rate(r: str) -> Rational:
    if "/" in r:
        n, d = r.split("/")
        return Rational(int(n), int(d))
    return Rational.from_float(float(r))


@register_filter
class FpsFilter(Filter):
    """Constant frame rate by dup/drop (vf_fps.c semantics)."""

    name = "fps"
    OPTIONS = (opt_str("fps", default="25"),)

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._rate = None
        self._next_out = 0
        self._last: Optional[Frame] = None
        self._out_tb = None

    def _ensure_rate_from_opt(self):
        self._rate = _rate(str(self.fps))
        self._out_tb = self._rate.inv()

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        out: List[Frame] = []
        if frame is None:
            if self._last is not None:
                f = self._last.clone_props()
                f.pts = self._next_out
                f.time_base = self._out_tb
                f.duration = 1
                out.append(f)
                self._last = None
            return out
        if self._rate is None:
            self._ensure_rate_from_opt()
        if frame.pts == NOPTS:
            raise InvalidData("fps: frames need pts")
        # target output index for this frame's pts
        t = rescale_q(frame.pts, frame.time_base, self._out_tb)
        if self._last is None:
            self._next_out = t
            self._last = frame
            return []
        while self._next_out < t:
            f = self._last.clone_props()
            f.pts = self._next_out
            f.time_base = self._out_tb
            f.duration = 1
            out.append(f)
            self._next_out += 1
        self._last = frame
        return out

    def configure(self, in_props):
        p = in_props[0]
        self._ensure_rate_from_opt()
        return replace(p, time_base=self._out_tb, frame_rate=self._rate)


@register_filter
class TrimFilter(Filter):
    """Keep frames inside [start, end) seconds (vf_trim)."""

    name = "trim"
    OPTIONS = (opt_float("start", default=0.0),
               opt_float("end", default=float("inf")),
               opt_int("start_frame", default=-1),
               opt_int("end_frame", default=-1))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._count = 0

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        idx = self._count
        self._count += 1
        if self.start_frame >= 0 or self.end_frame >= 0:
            lo = self.start_frame if self.start_frame >= 0 else 0
            hi = self.end_frame if self.end_frame >= 0 else 1 << 60
            return [frame] if lo <= idx < hi else []
        t = frame.best_effort_pts_seconds()
        if t is None:
            return [frame]
        return [frame] if self.start <= t < self.end else []


@register_filter
class SetPtsFilter(Filter):
    name = "setpts"
    OPTIONS = (opt_str("expr", default="PTS"),)

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._n = 0
        self._prev = float("nan")

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        names = {"PTS": frame.pts if frame.pts != NOPTS else float("nan"),
                 "N": self._n, "TB": float(frame.time_base) or 1.0,
                 "PREV_OUTPTS": self._prev,
                 "STARTPTS": 0}
        v = _eval.eval_expr(str(self.expr), names)
        f = frame.clone_props()
        f.pts = int(round(v))
        self._prev = v
        self._n += 1
        return [f]
