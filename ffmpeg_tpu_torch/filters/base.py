"""Filter framework (counterpart of ffmpeg_tpu/filters/base.py; analog of
libavfilter's AVFilter/AVFilterPad).

Two filter species:
  * TraceableFilter — pure per-frame transforms of component planes
    (crop, pad, scale, format, normalize...).  `make_tracer(props)`
    returns (fn, out_props), fn mapping a list of component tensors to a
    list of component tensors, with any leading batch dims.  The graph
    composes consecutive traceable filters into one FusedChain
    (filters/graph.py).  Where the reference jits each fn, the port calls
    the composition eagerly (no torch.compile, no CUDA graph), cached per
    input props as the reference caches its jitted programs.
  * Filter — generic: consumes/produces Frames via process(); used for
    rate-changing (fps, trim) and timestamp filters.

A traceable filter runs on the device of the frame's planes and never
moves them off it.  A filter with device state of its own (the resampling
audio filters) makes it on `device`, which the graph sets to its own.
Options use the reference's string surface
("scale=640:480:flags=bicubic" / positional args in OPTIONS order).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

import torch

from .. import trace
from ..core.frame import Frame, device_planes
from ..io.stream import MediaType
from ..utils.error import FilterNotFound, InvalidData
from ..utils.log import LogMixin
from ..utils.options import OptionsMixin
from ..utils.rational import Rational

_FILTERS: Dict[str, Type["Filter"]] = {}


def register_filter(cls: Type["Filter"]) -> Type["Filter"]:
    _FILTERS[cls.name] = cls
    return cls


def filter_names() -> List[str]:
    return sorted(_FILTERS)


def get_filter(name: str) -> Type["Filter"]:
    cls = _FILTERS.get(name)
    if cls is None:
        raise FilterNotFound(f"no such filter: {name!r}")
    return cls


@dataclass(frozen=True)
class VideoProps:
    width: int
    height: int
    format: str
    time_base: Rational
    frame_rate: Rational = Rational(0, 1)
    sample_aspect_ratio: Rational = Rational(0, 1)
    color_range: str = "unspecified"
    color_space: str = "unspecified"

    media_type = MediaType.VIDEO


@dataclass(frozen=True)
class AudioProps:
    sample_rate: int
    format: str
    channels: int
    time_base: Rational
    layout: str = ""

    media_type = MediaType.AUDIO


class Filter(OptionsMixin, LogMixin):
    """Generic filter: frames in → frames out."""

    name = "?"
    description = ""
    n_inputs = 1
    n_outputs = 1
    media_type = MediaType.VIDEO
    device = torch.device("cuda")

    def __init__(self, args: str = "", **opts):
        self.init_options()
        self._parse_args(args)
        for k, v in opts.items():
            self.set_option(k, v)
        self.log_name = self.name
        self.out_props = None

    def _parse_args(self, args: str) -> None:
        if not args:
            return
        positional = [o.name for o in type(self).mro_options()
                      if o.type.value != "const"]
        idx = 0
        for part in _split_filter_args(args):
            if "=" in part:
                k, _, v = part.partition("=")
                self.set_option(k, v)
            else:
                if idx >= len(positional):
                    raise InvalidData(f"{self.name}: too many args")
                self.set_option(positional[idx], part)
                idx += 1

    # --- configuration -------------------------------------------------------
    def configure(self, in_props: Sequence) -> object:
        """Given input pad props, validate + return output props."""
        self.out_props = in_props[0] if in_props else None
        return self.out_props

    # --- runtime -------------------------------------------------------------
    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        """frame=None signals EOF on that pad; return output frames."""
        if frame is None:
            return []
        return [frame]


class TraceableFilter(Filter):
    """Per-frame pure transform; fusable into the chain's composition."""

    def make_tracer(self, props) -> Tuple[Callable, object]:
        """Return (fn(comps)->comps, out_props)."""
        raise NotImplementedError

    def configure(self, in_props: Sequence) -> object:
        _, out = self.make_tracer(in_props[0])
        self.out_props = out
        return out

    def update_frame_props(self, frame: Frame, out_props) -> Frame:
        if isinstance(out_props, VideoProps):
            frame.width = out_props.width
            frame.height = out_props.height
            frame.format = out_props.format
            if out_props.color_range != "unspecified":
                frame.color_range = out_props.color_range
            if out_props.color_space != "unspecified":
                frame.color_space = out_props.color_space
        return frame

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        props = _props_of(frame)
        cache = self.__dict__.setdefault("_tracer_cache", {})
        hit = cache.get(props)
        if hit is None:
            trace.count("graph.tracers_built")
            hit = cache[props] = self.make_tracer(props)
        fn, out_props = hit
        out = frame.clone_props()
        out.planes = list(fn(_tensor_planes(frame.planes)))
        return [self.update_frame_props(out, out_props)]


def _tensor_planes(planes) -> List[torch.Tensor]:
    """The planes as tensors where they lie: tensors as they are, numpy
    planes as host tensors; planes on two devices raise InvalidData."""
    dev = next((p.device for p in planes if isinstance(p, torch.Tensor)),
               torch.device("cpu"))
    return device_planes(planes, dev)


def _props_of(frame: Frame):
    if frame.is_video:
        return VideoProps(frame.width, frame.height, frame.format,
                          frame.time_base,
                          sample_aspect_ratio=frame.sample_aspect_ratio,
                          color_range=frame.color_range,
                          color_space=frame.color_space)
    return AudioProps(frame.sample_rate, frame.format,
                      frame.ch_layout.nb_channels if frame.ch_layout else
                      len(frame.planes), frame.time_base)


def props_of(frame: Frame):
    return _props_of(frame)


def _split_filter_args(s: str) -> List[str]:
    """Split on ':' honoring quoting and \\ escapes (like av_get_token)."""
    out = []
    cur = []
    esc = False
    quote = None
    for ch in s:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            esc = True
        elif quote:
            if ch == quote:
                quote = None
            else:
                cur.append(ch)
        elif ch in "'\"":
            quote = ch
        elif ch == ":":
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return [p for p in out if p != ""]


# ---------------------------------------------------------------------------
# sample helpers shared by the video filters
# ---------------------------------------------------------------------------
# 9-16 bit planes come as uint16 (from numpy) or as int16 holding the same
# bits (the decoders' planes); torch implements few ops for uint16, so
# arithmetic widens to int32/float32 first and data movement runs on the
# int16 view of the same bits.

_UNSIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32}
# the value range of each container, as the reference's numpy/XLA types
# hold it (an int16 plane is a uint16 container)
_RANGE = {torch.uint8: (0, 255), torch.uint16: (0, 65535),
          torch.int16: (0, 65535), torch.int32: (-2 ** 31, 2 ** 31 - 1)}


def as_i32(c: torch.Tensor) -> torch.Tensor:
    """The samples as int32 (an int16 plane's bits read as uint16)."""
    if c.dtype == torch.int16:
        return c.to(torch.int32) & 0xFFFF
    return c.to(torch.int32)


def as_f32(c: torch.Tensor) -> torch.Tensor:
    """The samples as float32 (an int16 plane's bits read as uint16)."""
    if c.dtype == torch.int16:
        return as_i32(c).to(torch.float32)
    return c.to(torch.float32)


def as_f64(c: torch.Tensor) -> torch.Tensor:
    if c.dtype == torch.int16:
        return as_i32(c).to(torch.float64)
    return c.to(torch.float64)


def max_of(dtype: torch.dtype) -> int:
    """The container's largest value (numpy's iinfo of the reference's
    type)."""
    return _RANGE[dtype][1]


def to_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast as the reference's types do: float to integer truncates and
    saturates at the container's range (XLA's convert), integer to
    integer wraps.  torch leaves an out-of-range float cast undefined,
    so it is clamped here first."""
    if x.is_floating_point() and not dtype.is_floating_point:
        lo, hi = _RANGE[dtype]
        x = torch.nan_to_num(x, nan=0.0).clamp(lo, hi).to(torch.int32)
    if dtype in _UNSIGNED_VIEW and x.dtype == torch.int32:
        return x.to(_UNSIGNED_VIEW[dtype]).view(dtype)
    return x.to(dtype)


def bits(c: torch.Tensor) -> torch.Tensor:
    """The signed view of an unsigned 16/32-bit plane (same bits), for
    data movement; other planes as they are."""
    v = _UNSIGNED_VIEW.get(c.dtype)
    return c if v is None else c.view(v)


def unbits(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of bits(): the plane back in its container type."""
    return x if x.dtype == dtype else x.view(dtype)


def bit_value(v: int, dtype: torch.dtype) -> int:
    """A sample value as the bits() view holds it."""
    if dtype in _UNSIGNED_VIEW:
        n = 16 if dtype == torch.uint16 else 32
        v &= (1 << n) - 1
        return v - (1 << n) if v >= 1 << (n - 1) else v
    return v


def where_value(mask: torch.Tensor, v: int,
                c: torch.Tensor) -> torch.Tensor:
    """jnp.where(mask, v cast to c's type, c) for any container."""
    return unbits(bits(c).masked_fill(mask, bit_value(v, c.dtype)), c.dtype)


def host_dtype(dtype: torch.dtype):
    """The numpy type the reference holds such a plane in."""
    import numpy as np
    return {torch.uint8: np.uint8, torch.uint16: np.uint16,
            torch.int16: np.uint16, torch.int32: np.int32,
            torch.float32: np.float32, torch.float64: np.float64}[dtype]


def rdiv(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as the reference's jitted filters compute it: XLA's CPU
    backend turns a float32 division by a constant into a multiplication
    by the constant's float32 reciprocal (x / 255.0 differs from that in
    3 of 4 samples of 0..65535)."""
    import numpy as np
    return x * float(np.float32(1.0) / np.float32(c))



def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of x >= 0, as numpy's and
    XLA's (an IEEE sqrt instruction).  torch's CPU sqrt may miss by an ulp
    (its vector math library, whose accuracy mode is per thread), which
    moves a truncation at an exact integer root: the root is moved to the
    float32 whose rounding interval holds x, tested exactly in float64
    (the squares of midpoints of float32 values are exact there)."""
    r = torch.sqrt(x)
    xd = x.double()
    for _ in range(2):
        hi = torch.nextafter(r, torch.full_like(r, float("inf")))
        lo = torch.nextafter(r, torch.zeros_like(r))
        rd = r.double()
        up = ((rd + hi.double()) * 0.5) ** 2 < xd
        down = ((rd + lo.double()) * 0.5) ** 2 > xd
        r = torch.where(up, hi, torch.where(down, lo, r))
    return r


def tdiv(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c correctly rounded on every device, as numpy's and the
    reference's eager jnp division: CUDA's torch divides by a Python
    scalar as a multiplication by its reciprocal, which differs in the
    last bit; a 0-d tensor on x's device divides elementwise."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def edge_pad(x: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """x padded by r samples at both ends of `axis`, edge-replicated
    (np.pad's "edge" along one axis)."""
    n = x.shape[axis]
    idx = torch.arange(-r, n + r, device=x.device).clamp(0, n - 1)
    return x.index_select(axis, idx)
