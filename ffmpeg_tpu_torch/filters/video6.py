"""Video filter breadth, batch 2 (counterpart of
ffmpeg_tpu/filters/video6.py; reference analogs noted per class): plane
shuffling/extraction, stacking/tiling, border fill, limiter, 3x3
neighbourhood ops (dilation/erosion/median/deflate/inflate,
sobel/prewitt), component LUT expressions (lutyuv/lutrgb), colour
balance/mixing/keying, masked merge, SAR/DAR setters, temporal
loop/reverse/tpad, rotation, and the testsrc2/mandelbrot sources.

The reference computes these in numpy on the host.  The port computes
the same functions in PyTorch on the planes' device (the sources on the
filter's device), never moving a plane off it: integer work in int32,
and float64 where the reference computes in float64 (colour balance,
mixer, keys, masked merge, rotation, mandelbrot), float32 where it does
(sobel/prewitt).  The LUT filters build their tables on the host, as
the reference, and gather on the device.  Data movement of 16-bit planes
runs on their int16 view of the same bits.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..core.frame import Frame
from ..formats import pixfmt as _pf
from ..utils import eval as _eval
from ..utils.error import InvalidData
from ..utils.options import Option, OptType, opt_float, opt_int, opt_str
from ..utils.rational import Rational
from .base import (Filter, _tensor_planes, as_f32, as_f64, as_i32, bit_value,
                   bits, edge_pad, host_dtype, register_filter, sqrt_rn,
                   tdiv, to_dtype, unbits)
from .sources import SourceFilter, grid


def _planes(frame):
    return _tensor_planes(frame.planes)


def _emit(frame, planes):
    f = frame.clone_props()
    f.planes = planes
    return f


# ------------------------------------------------- plane manipulation
@register_filter
class ExtractPlanesFilter(Filter):
    """vf_extractplanes: one frame per requested plane (like
    channelsplit, consumers select by side_data['plane'])."""

    name = "extractplanes"
    OPTIONS = (opt_str("planes", default="y"),)

    _NAMES = {"y": 0, "u": 1, "v": 2, "r": 2, "g": 0, "b": 1,
              "a": 3}

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        req = [p for p in str(self.planes).split("+") if p]
        out = []
        ps = _planes(frame)
        desc = _pf.get(frame.format)
        for name in req:
            idx = self._NAMES.get(name)
            if idx is None or idx >= len(ps):
                raise InvalidData(f"extractplanes: no plane {name}")
            plane = ps[idx]
            fmt = "gray" if desc.depth <= 8 else "gray16le"
            f = Frame.video(plane.shape[1], plane.shape[0], fmt,
                            planes=[plane.clone()], pts=frame.pts,
                            time_base=frame.time_base)
            f.side_data["plane"] = name
            out.append(f)
        return out


@register_filter
class ShufflePlanesFilter(Filter):
    """vf_shuffleplanes: reorder planes by map0..map3."""

    name = "shuffleplanes"
    OPTIONS = (opt_int("map0", default=0), opt_int("map1", default=1),
               opt_int("map2", default=2), opt_int("map3", default=3))

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        ps = _planes(frame)
        m = [self.map0, self.map1, self.map2, self.map3][:len(ps)]
        if any(i >= len(ps) for i in m):
            raise InvalidData("shuffleplanes: map out of range")
        return [_emit(frame, [ps[i].clone() for i in m])]


def _cat(planes: List[torch.Tensor], dim: int) -> torch.Tensor:
    """np.concatenate for any container (on the int16 view of 16-bit
    planes)."""
    return unbits(torch.cat([bits(p) for p in planes], dim=dim),
                  planes[0].dtype)


# ---------------------------------------------------------- stacking
class _StackBase(Filter):
    n_inputs = 2
    OPTIONS = (opt_int("inputs", default=2),)

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._q = [deque() for _ in range(max(2, int(self.inputs)))]

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is not None:
            self._q[pad].append(frame)
        out = []
        n = int(self.inputs)
        while all(q for q in self._q[:n]):
            frames = [q.popleft() for q in self._q[:n]]
            planes = []
            per = [_planes(f) for f in frames]
            for i in range(len(frames[0].planes)):
                planes.append(_cat([p[i] for p in per], self._axis))
            f = frames[0].clone_props()
            f.planes = planes
            if self._axis == 1:
                f.width = sum(fr.width for fr in frames)
            else:
                f.height = sum(fr.height for fr in frames)
            out.append(f)
        return out


@register_filter
class HStackFilter(_StackBase):
    name = "hstack"
    description = "stack inputs horizontally"
    _axis = 1


@register_filter
class VStackFilter(_StackBase):
    name = "vstack"
    description = "stack inputs vertically"
    _axis = 0


@register_filter
class TileFilter(Filter):
    """vf_tile: arrange N successive frames into a grid."""

    name = "tile"
    OPTIONS = (opt_str("layout", default="6x5"),)

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        wxh = str(self.layout).split("x")
        self._gw, self._gh = int(wxh[0]), int(wxh[1])
        self._buf = []

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        need = self._gw * self._gh
        if frame is not None:
            self._buf.append(frame)
            if len(self._buf) < need:
                return []
        elif not self._buf:
            return []
        while len(self._buf) < need:       # pad final tile (clone)
            self._buf.append(self._buf[-1])
        frames, self._buf = self._buf[:need], self._buf[need:]
        per = [_planes(f) for f in frames]
        planes = []
        for i in range(len(frames[0].planes)):
            rows = [_cat([per[gy * self._gw + gx][i]
                          for gx in range(self._gw)], 1)
                    for gy in range(self._gh)]
            planes.append(_cat(rows, 0))
        f = frames[0].clone_props()
        f.planes = planes
        f.width = frames[0].width * self._gw
        f.height = frames[0].height * self._gh
        return [f]


# ------------------------------------------------------------ borders
@register_filter
class FillBordersFilter(Filter):
    """vf_fillborders modes fixed/smear/mirror."""

    name = "fillborders"
    OPTIONS = (opt_int("left", default=0), opt_int("right", default=0),
               opt_int("top", default=0), opt_int("bottom", default=0),
               opt_str("mode", default="smear"),
               opt_int("color", default=0))

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        desc = _pf.get(frame.format)
        out = []
        for i, plane in enumerate(_planes(frame)):
            hs = desc.log2_chroma_w if i in (1, 2) and \
                not desc.is_rgb else 0
            vs = desc.log2_chroma_h if i in (1, 2) and \
                not desc.is_rgb else 0
            l, r = self.left >> hs, self.right >> hs
            t, b = self.top >> vs, self.bottom >> vs
            p = bits(plane)
            h, w = p.shape
            q = p.clone()
            mode = str(self.mode)
            if mode == "fixed":
                val = bit_value(self.color, plane.dtype)
                q[:t] = val
                q[h - b:] = val
                q[:, :l] = val
                q[:, w - r:] = val
            elif mode == "mirror":
                if t:
                    q[:t] = p[t:2 * t].flip(0)
                if b:
                    q[h - b:] = p[h - 2 * b:h - b].flip(0)
                if l:
                    q[:, :l] = q[:, l:2 * l].flip(1)
                if r:
                    q[:, w - r:] = q[:, w - 2 * r:w - r].flip(1)
            else:                           # smear
                if t:
                    q[:t] = q[t]
                if b:
                    q[h - b:] = q[h - b - 1]
                if l:
                    q[:, :l] = q[:, l:l + 1]
                if r:
                    q[:, w - r:] = q[:, w - r - 1:w - r]
            out.append(unbits(q, plane.dtype))
        return [_emit(frame, out)]


def _check_bounds(dtype: torch.dtype, *vals: int) -> None:
    """numpy's refusal of a Python int outside the array's type (the
    reference's np.clip raises OverflowError there)."""
    info = np.iinfo(host_dtype(dtype))
    for v in vals:
        if not info.min <= v <= info.max:
            raise OverflowError(f"Python integer {v} out of bounds for "
                                f"{info.dtype}")


@register_filter
class LimiterFilter(Filter):
    """vf_limiter: clamp plane values to [min, max].  A bound outside
    the plane's type raises OverflowError, as numpy's clip does in the
    reference (so the default max=65535 raises on 8-bit planes)."""

    name = "limiter"
    OPTIONS = (opt_int("min", default=0),
               opt_int("max", default=65535),
               opt_str("planes", default="15"))

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        mask = int(str(self.planes), 0)
        out = []
        for i, p in enumerate(_planes(frame)):
            if mask & (1 << i):
                _check_bounds(p.dtype, self.min, self.max)
                out.append(to_dtype(as_i32(p).clamp(self.min, self.max),
                                    p.dtype))
            else:
                out.append(p.clone())
        return [_emit(frame, out)]


# ------------------------------------------------ 3x3 neighborhood ops
def _pad(x: torch.Tensor, r: int, mode: str) -> torch.Tensor:
    """np.pad(x, r, mode) of a 2-D plane: "edge" replicates, "reflect"
    mirrors without repeating the edge sample."""
    if mode == "edge":
        return edge_pad(edge_pad(x, r, -2), r, -1)
    return _reflect(_reflect(x, r, -2), r, -1)


def _reflect(x: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """np.pad's "reflect" along one axis (the edge sample not repeated)."""
    n = x.shape[axis]
    idx = torch.arange(-r, n + r, device=x.device).abs()
    return x.index_select(axis, torch.where(idx > n - 1, 2 * (n - 1) - idx,
                                            idx))


def _shifts(q: torch.Tensor, h: int, w: int, n: int):
    """The n*n windows q[dy:dy + h, dx:dx + w] in the reference's order."""
    return [q[dy:dy + h, dx:dx + w] for dy in range(n) for dx in range(n)]


class _NeighborBase(Filter):
    OPTIONS = (opt_str("planes", default="15"),)

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        mask = int(str(self.planes), 0)
        out = []
        for i, p in enumerate(_planes(frame)):
            if mask & (1 << i):
                out.append(to_dtype(self._apply(p), p.dtype))
            else:
                out.append(p.clone())
        return [_emit(frame, out)]


@register_filter
class DilationFilter(_NeighborBase):
    name = "dilation"

    def _apply(self, p):
        h, w = p.shape
        return torch.stack(_shifts(_pad(as_i32(p), 1, "edge"), h, w, 3)) \
            .amax(dim=0)


@register_filter
class ErosionFilter(_NeighborBase):
    name = "erosion"

    def _apply(self, p):
        h, w = p.shape
        return torch.stack(_shifts(_pad(as_i32(p), 1, "edge"), h, w, 3)) \
            .amin(dim=0)


@register_filter
class MedianFilter(_NeighborBase):
    """The median of the (2r+1)^2 window (np.median: for an odd count
    the middle sample, which torch.median's lower median equals)."""

    name = "median"
    OPTIONS = (opt_str("planes", default="15"),
               opt_int("radius", default=1))

    def _apply(self, p):
        r = int(self.radius)
        h, w = p.shape
        n = 2 * r + 1
        stk = torch.stack(_shifts(_pad(as_i32(p), r, "edge"), h, w, n))
        return torch.median(stk, dim=0).values


@register_filter
class InflateFilter(_NeighborBase):
    """vf_neighbor inflate: dst = min(max(avg8, p), p + threshold)
    with avg8 the truncated mean of the 8 neighbours
    (vf_neighbor.c:194); threshold defaults to full range so the
    clamp reduces to max(avg8, p)."""

    name = "inflate"
    _GT = True

    def _apply(self, p):
        # vf_neighbor borders: vertical edges replicate (nh/ph
        # clamps), horizontal edges mirror one pixel
        x = as_i32(p)
        h, w = p.shape
        n9 = _shifts(_reflect(edge_pad(x, 1, -2), 1, -1), h, w, 3)
        s = None
        for k, v in enumerate(n9):
            if k != 4:
                s = v if s is None else s + v
        avg = s // 8
        return torch.maximum(avg, x) if self._GT else torch.minimum(avg, x)


@register_filter
class DeflateFilter(InflateFilter):
    name = "deflate"
    _GT = False


class _GradientBase(_NeighborBase):
    """|gradient| of the 3x3 mirrored window in float32 (the products
    are integers, so any order of the sums is exact), scaled, offset,
    clipped to [0, 255] and truncated to the plane's type."""

    OPTIONS = (opt_str("planes", default="15"),
               opt_float("scale", default=1.0),
               opt_float("delta", default=0.0))

    def _apply(self, p):
        h, w = p.shape
        n9 = _shifts(_pad(as_f32(p), 1, "reflect"), h, w, 3)

        def conv(k):
            acc = None
            for v, c in zip(n9, k):
                if c:
                    t = v * float(c)
                    acc = t if acc is None else acc + t
            return acc
        gx, gy = conv(self._KX), conv(self._KY)
        v = sqrt_rn(gx * gx + gy * gy) * float(np.float32(self.scale)) \
            + float(np.float32(self.delta))
        return torch.clamp(v, 0, 255)


@register_filter
class SobelFilter(_GradientBase):
    name = "sobel"
    _KX = [-1, 0, 1, -2, 0, 2, -1, 0, 1]
    _KY = [-1, -2, -1, 0, 0, 0, 1, 2, 1]


@register_filter
class PrewittFilter(_GradientBase):
    name = "prewitt"
    _KX = [-1, 0, 1, -1, 0, 1, -1, 0, 1]
    _KY = [-1, -1, -1, 0, 0, 0, 1, 1, 1]


# ----------------------------------------------------- LUT expressions
class _LutBase(Filter):
    def _lut(self, expr, depth, minval=None, maxval=None):
        full = (1 << depth) - 1
        mn = 0 if minval is None else minval
        mx = full if maxval is None else maxval
        lut = np.empty(full + 1, np.int64)
        for v in range(full + 1):
            neg = min(max(mx + mn - v, mn), mx)
            # the reference truncates with a C int cast (vf_lut.c:334)
            lut[v] = int(_eval.eval_expr(
                expr, {"val": v, "maxval": mx, "minval": mn,
                       "negval": neg,
                       "clipval": min(max(v, mn), mx)}))
        return np.clip(lut, 0, full)

    def _gather(self, lut: np.ndarray, p: torch.Tensor) -> torch.Tensor:
        """lut[p] on p's device, in p's type.  Every index is in range:
        a d-bit sample is at most the table's last entry."""
        t = torch.as_tensor(lut.astype(np.int32), device=p.device)
        return to_dtype(t[as_i32(p).long()], p.dtype)


@register_filter
class LutYuvFilter(_LutBase):
    """vf_lut (lutyuv): per-component expressions in 'val'. Limited
    range: minval/maxval are 16/235 (luma) and 16/240 (chroma) as in
    the reference's non-JPEG YUV path."""

    name = "lutyuv"
    OPTIONS = (opt_str("y", default="val"),
               opt_str("u", default="val"),
               opt_str("v", default="val"))

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        desc = _pf.get(frame.format)
        exprs = [str(self.y), str(self.u), str(self.v)]
        out = []
        for i, p in enumerate(_planes(frame)):
            if i < 3:
                d = desc.comp[i].depth
                mn = 16 << (d - 8)
                mx = (235 if i == 0 else 240) << (d - 8)
                out.append(self._gather(self._lut(exprs[i], d, mn, mx), p))
            else:
                out.append(p.clone())
        return [_emit(frame, out)]


@register_filter
class LutRgbFilter(_LutBase):
    """vf_lut (lutrgb) on planar RGB (gbrp plane order g,b,r)."""

    name = "lutrgb"
    OPTIONS = (opt_str("r", default="val"),
               opt_str("g", default="val"),
               opt_str("b", default="val"))

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        desc = _pf.get(frame.format)
        exprs = [str(self.g), str(self.b), str(self.r)]   # plane order
        out = []
        for i, p in enumerate(_planes(frame)):
            if i < 3:
                out.append(self._gather(
                    self._lut(exprs[i], desc.comp[i].depth), p))
            else:
                out.append(p.clone())
        return [_emit(frame, out)]


# ------------------------------------------------------------- color
def _u8(x: torch.Tensor) -> torch.Tensor:
    """np.round(x).astype(np.uint8) of values already within [0, 255]."""
    return to_dtype(torch.round(x), torch.uint8)


def _clip_u8(x: torch.Tensor) -> torch.Tensor:
    """np.clip(np.round(x), 0, 255).astype(np.uint8)."""
    return to_dtype(torch.clamp(torch.round(x), 0, 255), torch.uint8)


@register_filter
class ColorBalanceFilter(Filter):
    """vf_colorbalance: shadow/midtone/highlight shifts per RGB on
    planar RGB input."""

    name = "colorbalance"
    OPTIONS = tuple(opt_float(n, default=0.0) for n in
                    ("rs", "gs", "bs", "rm", "gm", "bm",
                     "rh", "gh", "bh"))

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        ps = _planes(frame)
        g, b, r = [tdiv(as_f64(p), 255.0) for p in ps[:3]]

        def adjust(p, s, m, h):
            sh = torch.clamp(s * (1 - p) ** 2, -1, 1)
            mi = torch.clamp(m * (1 - torch.abs(2 * p - 1)) ** 2, -1, 1)
            hi = torch.clamp(h * p ** 2, -1, 1)
            return torch.clamp(p + sh + mi + hi, 0, 1)

        r2 = adjust(r, self.rs, self.rm, self.rh)
        g2 = adjust(g, self.gs, self.gm, self.gh)
        b2 = adjust(b, self.bs, self.bm, self.bh)
        out = [_u8(g2 * 255), _u8(b2 * 255), _u8(r2 * 255)]
        out += [p.clone() for p in ps[3:]]
        return [_emit(frame, out)]


@register_filter
class ColorChannelMixerFilter(Filter):
    """vf_colorchannelmixer: 4x4 channel matrix on planar RGB(A)."""

    name = "colorchannelmixer"
    OPTIONS = tuple(
        opt_float(n, default=(1.0 if n in ("rr", "gg", "bb", "aa")
                              else 0.0))
        for n in ("rr", "rg", "rb", "ra", "gr", "gg", "gb", "ga",
                  "br", "bg", "bb", "ba", "ar", "ag", "ab", "aa"))

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        ps = _planes(frame)
        g, b, r = [as_f64(p) for p in ps[:3]]
        a = as_f64(ps[3]) if len(ps) > 3 else None
        az = a if a is not None else 0.0
        r2 = self.rr * r + self.rg * g + self.rb * b + self.ra * az
        g2 = self.gr * r + self.gg * g + self.gb * b + self.ga * az
        b2 = self.br * r + self.bg * g + self.bb * b + self.ba * az
        out = [_clip_u8(g2), _clip_u8(b2), _clip_u8(r2)]
        if a is not None:
            a2 = self.ar * r + self.ag * g + self.ab * b \
                + self.aa * az
            out.append(_clip_u8(a2))
        return [_emit(frame, out)]


def _parse_color(c):
    c = str(c).lstrip("#")
    named = {"black": (0, 0, 0), "white": (255, 255, 255),
             "red": (255, 0, 0), "green": (0, 128, 0),
             "lime": (0, 255, 0), "blue": (0, 0, 255)}
    if c.lower() in named:
        return named[c.lower()]
    if c.startswith("0x"):
        c = c[2:]
    v = int(c, 16)
    return ((v >> 16) & 255, (v >> 8) & 255, v & 255)


def _key_alpha(d: torch.Tensor, similarity, blend) -> torch.Tensor:
    sim = max(float(similarity), 1e-6)
    bl = float(blend)
    if bl > 0:
        return torch.clamp(tdiv(d - sim, bl), 0, 1) * 255
    return (d > sim) * 255.0


@register_filter
class ColorKeyFilter(Filter):
    """vf_colorkey: RGB distance keying -> alpha on RGBA-ish
    planar input (adds an alpha plane)."""

    name = "colorkey"
    OPTIONS = (opt_str("color", default="black"),
               opt_float("similarity", default=0.01),
               opt_float("blend", default=0.0))

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        ps = _planes(frame)
        g, b, r = [as_f64(p) for p in ps[:3]]
        kr, kg, kb = _parse_color(self.color)
        d = tdiv(torch.sqrt((r - kr) ** 2 + (g - kg) ** 2 + (b - kb) ** 2),
                 255.0 * math.sqrt(3))
        alpha = _key_alpha(d, self.similarity, self.blend)
        out = [p.clone() for p in ps[:3]]
        out.append(_u8(alpha))
        f = frame.clone_props()
        f.planes = out
        f.format = "gbrap"
        return [f]


@register_filter
class ChromaKeyFilter(Filter):
    """vf_chromakey: UV-plane distance keying on YUV input."""

    name = "chromakey"
    OPTIONS = (opt_str("color", default="lime"),
               opt_float("similarity", default=0.01),
               opt_float("blend", default=0.0))

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        ps = _planes(frame)
        kr, kg, kb = _parse_color(self.color)
        # BT.601 limited-range key chroma
        ku = round(-0.148 * kr - 0.291 * kg + 0.439 * kb + 128)
        kv = round(0.439 * kr - 0.368 * kg - 0.071 * kb + 128)
        u = as_f64(ps[1])
        v = as_f64(ps[2])
        d = tdiv(torch.sqrt((u - ku) ** 2 + (v - kv) ** 2), 255.0)
        alpha = _key_alpha(d, self.similarity, self.blend)
        # upsample alpha to luma size
        desc = _pf.get(frame.format)
        ay = alpha.repeat_interleave(1 << desc.log2_chroma_h, dim=0) \
            .repeat_interleave(1 << desc.log2_chroma_w, dim=1)
        ay = ay[:ps[0].shape[0], :ps[0].shape[1]]
        out = [p.clone() for p in ps[:3]]
        out.append(_u8(ay))
        f = frame.clone_props()
        f.planes = out
        f.format = {"yuv420p": "yuva420p", "yuv422p": "yuva422p",
                    "yuv444p": "yuva444p"}.get(frame.format,
                                               frame.format)
        return [f]


@register_filter
class MaskedMergeFilter(Filter):
    """vf_maskedmerge: out = base*(1-mask) + overlay*mask
    (3 inputs: base, overlay, mask)."""

    name = "maskedmerge"
    n_inputs = 3

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._q = [deque(), deque(), deque()]

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is not None:
            self._q[pad].append(frame)
        out = []
        while all(self._q):
            base, over, mask = (q.popleft() for q in self._q)
            planes = []
            mps = _planes(mask)
            for i, (pb, po) in enumerate(zip(_planes(base),
                                             _planes(over))):
                m = tdiv(as_f64(mps[min(i, len(mps) - 1)]), 255.0)
                if m.shape != pb.shape:
                    m = m[:pb.shape[0], :pb.shape[1]]
                v = as_f64(pb) * (1 - m) + as_f64(po) * m
                planes.append(to_dtype(torch.round(v), pb.dtype))
            f = base.clone_props()
            f.planes = planes
            out.append(f)
        return out


# ------------------------------------------------------- SAR / timing
@register_filter
class SetSarFilter(Filter):
    name = "setsar"
    OPTIONS = (opt_str("sar", default="1"),)

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        s = str(self.sar).replace(":", "/")
        if "/" in s:
            n, d = s.split("/")
            sar = Rational(int(n), int(d))
        else:
            sar = Rational(int(float(s)), 1)
        f = frame.clone_props()
        f.planes = list(frame.planes)
        f.sample_aspect_ratio = sar
        return [f]


@register_filter
class SetDarFilter(Filter):
    name = "setdar"
    OPTIONS = (opt_str("dar", default="1"),)

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        s = str(self.dar).replace(":", "/")
        if "/" in s:
            n, d = (int(x) for x in s.split("/"))
        else:
            n, d = int(float(s)), 1
        f = frame.clone_props()
        f.planes = list(frame.planes)
        f.sample_aspect_ratio = Rational(n * frame.height,
                                         d * frame.width)
        return [f]


@register_filter
class LoopFilter2(Filter):
    """vf_loop: repeat a captured window of frames `loop` extra
    times."""

    name = "loop"
    OPTIONS = (opt_int("loop", default=0),
               opt_int("size", default=0),
               opt_int("start", default=0))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._buf = []
        self._n = 0
        self._pts = 0
        self._dur = 1

    def _stamp(self, frame):
        f = frame.clone_props()
        f.planes = list(frame.planes)
        f.pts = self._pts
        self._pts += self._dur
        return f

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        size = int(self.size)
        if frame is not None:
            if frame.duration:
                self._dur = frame.duration
            idx = self._n
            self._n += 1
            if size and self.start <= idx < self.start + size:
                self._buf.append(frame)
            return [self._stamp(frame)]
        out = []
        for _ in range(max(0, int(self.loop))):
            for f in self._buf:
                out.append(self._stamp(f))
        return out


@register_filter
class ReverseFilter(Filter):
    """vf_reverse: buffer everything, emit reversed at EOF."""

    name = "reverse"

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._buf = []

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is not None:
            self._buf.append(frame)
            return []
        pts = [f.pts for f in self._buf]
        out = []
        for f, p in zip(reversed(self._buf), pts):
            g = f.clone_props()
            g.planes = list(f.planes)
            g.pts = p
            out.append(g)
        self._buf = []
        return out


@register_filter
class TpadFilter(Filter):
    """vf_tpad: pad with cloned (or black) frames at start/stop; a
    "black" frame is all zeros, as in the reference."""

    name = "tpad"
    OPTIONS = (opt_int("start", default=0),
               opt_int("stop", default=0),
               opt_str("start_mode", default="add"),
               opt_str("stop_mode", default="clone"))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._first_done = False
        self._last = None
        self._pts = 0
        self._dur = 1

    def _clone(self, frame, black):
        f = frame.clone_props()
        if black:
            f.planes = [torch.zeros_like(p) for p in _planes(frame)]
        else:
            f.planes = list(frame.planes)
        f.pts = self._pts
        self._pts += self._dur
        return f

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        out = []
        if frame is not None:
            if frame.duration:
                self._dur = frame.duration
            if not self._first_done:
                self._first_done = True
                black = str(self.start_mode) == "add"
                for _ in range(int(self.start)):
                    out.append(self._clone(frame, black))
            self._last = frame
            out.append(self._clone(frame, False))
            return out
        if self._last is not None:
            black = str(self.stop_mode) == "add"
            for _ in range(int(self.stop)):
                out.append(self._clone(self._last, black))
        return out


@register_filter
class RotateFilter(Filter):
    """vf_rotate: arbitrary-angle rotation with bilinear sampling
    (static angle expression), in float64 on the planes' device."""

    name = "rotate"
    OPTIONS = (opt_str("angle", default="0"),
               opt_str("a", default=""),
               opt_int("fillcolor", default=0))

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        expr = str(self.a) or str(self.angle)
        ang = _eval.eval_expr(expr, {"PI": math.pi, "n": 0, "t": 0})
        ca, sa = math.cos(ang), math.sin(ang)
        desc = _pf.get(frame.format)
        out = []
        for i, p in enumerate(_planes(frame)):
            h, w = p.shape
            cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
            yy, xx = grid(h, w, p.device)
            xc = xx.to(torch.float64) - cx
            yc = yy.to(torch.float64) - cy
            sx = ca * xc + sa * yc + cx
            sy = -sa * xc + ca * yc + cy
            valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) \
                & (sy <= h - 1)
            x0c = torch.floor(sx).long().clamp(0, w - 2)
            y0c = torch.floor(sy).long().clamp(0, h - 2)
            fx = sx - x0c
            fy = sy - y0c
            pf = as_f64(p)
            v = (pf[y0c, x0c] * (1 - fx) * (1 - fy)
                 + pf[y0c, x0c + 1] * fx * (1 - fy)
                 + pf[y0c + 1, x0c] * (1 - fx) * fy
                 + pf[y0c + 1, x0c + 1] * fx * fy)
            fill = self.fillcolor if (desc.is_rgb or i == 0) \
                else (1 << (desc.comp[min(i, 2)].depth - 1))
            v = torch.where(valid, v, float(fill))
            out.append(to_dtype(torch.clamp(
                torch.round(v), 0, (1 << desc.comp[0].depth) - 1), p.dtype))
        return [_emit(frame, out)]


# ----------------------------------------------------------- sources
@register_filter
class TestSrc2Source(SourceFilter):
    """vsrc_testsrc2: colored moving gradient pattern (not
    pixel-identical to the reference, same role)."""

    name = "testsrc2"
    OPTIONS = (Option("size", type=OptType.IMAGE_SIZE,
                      default=(320, 240)),
               Option("rate", type=OptType.VIDEO_RATE,
                      default=Rational(25, 1)))

    def generate(self, nframes: int) -> Iterator[Frame]:
        w, h = self.size
        tb = self.rate.inv()
        yy, xx = grid(h, w, self.device)
        for i in range(nframes):
            r = ((xx * 256 // max(1, w) + 4 * i) ^ yy) % 256
            g = ((yy * 256 // max(1, h) + 2 * i)
                 ^ (xx >> 1)) % 256
            b = ((xx + yy) // 2 + 6 * i) % 256
            f = Frame.video(w, h, "rgb24",
                            planes=[r.to(torch.uint8),
                                    g.to(torch.uint8),
                                    b.to(torch.uint8)],
                            pts=i, time_base=tb)
            f.duration = 1
            yield f


@register_filter
class MandelbrotSource(SourceFilter):
    """vsrc_mandelbrot: zooming Mandelbrot render.  z = z*z + c runs in
    float64 on the filter's device with numpy's complex product spelled
    out ((a*a - b*b) + c.re, (a*b + b*a) + c.im); |z| > 2 is tested as
    |z|^2 > 4 (the reference's hypot differs from it only within an ulp
    of 2), in IEEE products and sums that every device rounds alike; the
    sample grid is numpy's linspace, made on the host."""

    name = "mandelbrot"
    OPTIONS = (Option("size", type=OptType.IMAGE_SIZE,
                      default=(640, 480)),
               Option("rate", type=OptType.VIDEO_RATE,
                      default=Rational(25, 1)),
               opt_int("maxiter", default=128))

    def generate(self, nframes: int) -> Iterator[Frame]:
        w, h = self.size
        tb = self.rate.inv()
        dev = self.device
        cx, cy = -0.743644, 0.131826
        maxiter = int(self.maxiter)
        for i in range(nframes):
            scale = 3.0 * (0.97 ** i)
            x = np.linspace(cx - scale / 2, cx + scale / 2, w)
            y = np.linspace(cy - scale * h / (2 * w),
                            cy + scale * h / (2 * w), h)
            cr = torch.as_tensor(x, device=dev)[None, :].expand(h, w)
            ci = torch.as_tensor(y, device=dev)[:, None].expand(h, w)
            zr = torch.zeros((h, w), dtype=torch.float64, device=dev)
            zi = torch.zeros_like(zr)
            it = torch.zeros((h, w), dtype=torch.int32, device=dev)
            alive = torch.ones((h, w), dtype=torch.bool, device=dev)
            for k in range(maxiter):
                nr = (zr * zr - zi * zi) + cr
                ni = (zr * zi + zi * zr) + ci
                zr = torch.where(alive, nr, zr)
                zi = torch.where(alive, ni, zi)
                esc = zr * zr + zi * zi > 4.0
                it = torch.where(alive & esc, k, it)
                alive = alive & ~esc
            t = tdiv(it.to(torch.float64), max(1, maxiter))
            r = torch.round(255 * torch.clamp(3 * t, 0, 1))
            g = torch.round(255 * torch.clamp(3 * t - 1, 0, 1))
            b = torch.round(255 * torch.clamp(3 * t - 2, 0, 1))
            f = Frame.video(w, h, "rgb24",
                            planes=[to_dtype(r, torch.uint8),
                                    to_dtype(g, torch.uint8),
                                    to_dtype(b, torch.uint8)],
                            pts=i, time_base=tb)
            f.duration = 1
            yield f
