"""Public scaling / pixel-format / colorspace conversion API.

Counterpart of ffmpeg_tpu/scale/swscale.py (reference: libswscale
swscale.h:439 sws_scale_frame, graph.c pass graph, ops.c op compiler).
A Scaler lowers a conversion spec to the typed op list of scale/ops.py,
optimizes it, and runs it eagerly on batch-of-frames component planes
(N, h_c, w_c) on its device, which is the card unless the caller names
another.  The filter banks, colour matrices and pixel-format tables are
the port's own numpy copies (`scale/filters.py`, `scale/colorspace.py`,
`formats/pixfmt.py`), held equal to the reference's by its tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.frame import Frame, device_planes
from ..formats import pixfmt as _pf
from ..utils.error import InvalidData, NotSupported
from . import colorspace as csp
from . import filters as _filters
from .ops import (FromFloat, Linear, Op, ResizeAxis, SelectComps, ToFloat,
                  compile_ops, optimize)


def _kind(desc: _pf.PixFmtDescriptor) -> str:
    if desc.is_rgb:
        return "rgb"
    if desc.nb_components < 3:
        return "gray"
    return "yuv"


def _levels(desc: _pf.PixFmtDescriptor, comp_idx: int, full_range: bool):
    """(offset, scale) mapping code values ↔ normalized for one component."""
    c = desc.comp[comp_idx]
    if desc.is_float:
        return 0.0, 1.0
    k = _kind(desc)
    is_alpha = desc.has_alpha and comp_idx == desc.nb_components - 1
    if is_alpha:
        return 0.0, float((1 << c.depth) - 1)
    if k == "rgb":
        return csp.rgb_levels(c.depth, True)
    # yuv / gray
    y_off, y_sc, c_off, c_sc = csp.yuv_levels(c.depth, full_range)
    if k == "yuv" and comp_idx in (1, 2):
        return c_off, c_sc
    return y_off, y_sc


def _comp_grid(desc: _pf.PixFmtDescriptor, comp_idx: int, w: int, h: int,
               chroma_loc: str):
    """(n_x, n_y, step_x, step_y, off_x, off_y) in luma coordinates."""
    if comp_idx in (1, 2) and _kind(desc) == "yuv":
        cw, ch = desc.chroma_dims(w, h)
        ox, oy = csp.chroma_offset(chroma_loc, desc.log2_chroma_w,
                                   desc.log2_chroma_h)
        return cw, ch, float(1 << desc.log2_chroma_w), float(1 << desc.log2_chroma_h), ox, oy
    return w, h, 1.0, 1.0, 0.0, 0.0


@dataclass(frozen=True)
class ScaleSpec:
    src_w: int
    src_h: int
    src_fmt: str
    dst_w: int
    dst_h: int
    dst_fmt: str
    filter: str = "bicubic"
    param: Optional[float] = None
    src_colorspace: str = "bt470bg"     # swscale defaults to BT.601 when unset
    dst_colorspace: str = "bt470bg"
    src_range: bool = False             # full range?
    dst_range: bool = False
    # swscale's legacy paths assume center-sited chroma in both axes, so
    # "center" is the compatibility default; pass "left" (MPEG siting) for
    # standards-exact positioning.
    src_chroma_loc: str = "center"
    dst_chroma_loc: str = "center"
    dither: Optional[str] = None
    antialias: bool = True


def build_ops(s: ScaleSpec) -> List[Op]:
    src = _pf.get(s.src_fmt)
    dst = _pf.get(s.dst_fmt)
    if src.flags & (_pf.FLAG_PAL | _pf.FLAG_BITSTREAM) or \
       dst.flags & (_pf.FLAG_PAL | _pf.FLAG_BITSTREAM):
        raise NotSupported(f"pal/bitstream formats in scaler: {src.name}->{dst.name}")
    sk, dk = _kind(src), _kind(dst)
    # full-range is implied for RGB, gray (JPEG-style convention, like the
    # reference's gray↔yuv handling) and float formats
    src_range = s.src_range or sk in ("rgb", "gray") or src.is_float
    dst_range = s.dst_range or dk in ("rgb", "gray") or dst.is_float

    ops: List[Op] = []
    ops.append(ToFloat(
        offsets=tuple(_levels(src, i, src_range)[0] for i in range(src.nb_components)),
        scales=tuple(_levels(src, i, src_range)[1] for i in range(src.nb_components)),
    ))

    need_csc = (
        (sk != dk and not (sk == "gray" and dk == "yuv")
         and not (sk == "yuv" and dk == "gray"))
        or (sk == "yuv" and dk == "yuv"
            and s.src_colorspace != s.dst_colorspace)
    )

    scale_x = s.src_w / s.dst_w
    scale_y = s.src_h / s.dst_h

    if need_csc:
        # 1. resize every src comp from its own grid straight to the dst
        #    LUMA grid (swscale full_chroma_int semantics: chroma is
        #    interpolated to full destination resolution before conversion)
        ops.extend(_resize_to_full_dst_grid(src, s, scale_x, scale_y))
        # 2. colorspace matrix in normalized space
        m = np.eye(3)
        if sk == "yuv":
            m = csp.yuv2rgb_matrix(s.src_colorspace)
        elif sk == "gray":
            m = np.array([[1.0], [1.0], [1.0]])
        if dk == "yuv":
            m = csp.rgb2yuv_matrix(s.dst_colorspace) @ m
        elif dk == "gray":
            m = csp.rgb2yuv_matrix(s.dst_colorspace)[0:1, :] @ m
        if not (m.shape[0] == m.shape[1] and np.allclose(m, np.eye(m.shape[0]))):
            ops.append(Linear(m, np.zeros(m.shape[0])))
        cur_nb = m.shape[0]
        # alpha adaptation
        spec = list(range(cur_nb))
        if dst.has_alpha:
            spec.append(cur_nb if src.has_alpha else 1.0)
        ops.append(SelectComps(tuple(spec)))
        # 3. downsample chroma to the dst grid if dst is subsampled YUV
        if dk == "yuv" and (dst.log2_chroma_w or dst.log2_chroma_h):
            ops.extend(_chroma_downsample_ops(dst, s))
    else:
        # kind-compatible: adapt comps first, then per-comp grid resize
        spec: list = list(range(min(src.nb_components, 1)))
        if dk == "yuv":
            spec = [0, 0.0, 0.0] if sk == "gray" else [0, 1, 2]
        elif dk == "gray":
            spec = [0]
        elif dk == "rgb":
            spec = [0, 1, 2]
        if dst.has_alpha:
            spec.append(src.nb_components - 1 if src.has_alpha else 1.0)
        ops.append(SelectComps(tuple(spec)))
        ops.extend(_resize_comp_to_comp(src, dst, s, scale_x, scale_y))

    ops.append(FromFloat(
        offsets=tuple(_levels(dst, i, dst_range)[0] for i in range(dst.nb_components)),
        scales=tuple(_levels(dst, i, dst_range)[1] for i in range(dst.nb_components)),
        maxval=tuple((1 << dst.comp[i].depth) - 1 for i in range(dst.nb_components)),
        dtype=dst.component_dtype(),
        dither=s.dither,
    ) if not dst.is_float else _FloatOut())
    return optimize(ops)


class _FloatOut(Op):
    def apply(self, comps):
        return [c.to(torch.float32) for c in comps]


def _resize_to_full_dst_grid(src, s: ScaleSpec, scale_x, scale_y) -> List[Op]:
    """Each src comp, from its own grid, to the full dst luma grid."""
    mats_h, mats_v = [], []
    for i in range(src.nb_components):
        snx, sny, ssx, ssy, sox, soy = _comp_grid(src, i, s.src_w, s.src_h,
                                                  s.src_chroma_loc)
        mh = _filters.resize_matrix(s.dst_w, snx, s.filter, s.param, s.antialias,
                                    scale=scale_x, src_step=ssx, src_off=sox)
        mv = _filters.resize_matrix(s.dst_h, sny, s.filter, s.param, s.antialias,
                                    scale=scale_y, src_step=ssy, src_off=soy)
        mats_h.append(None if (s.dst_w == snx and _is_identity(mh)) else mh)
        mats_v.append(None if (s.dst_h == sny and _is_identity(mv)) else mv)
    out = []
    if any(m is not None for m in mats_v):
        out.append(ResizeAxis(-2, tuple(mats_v)))
    if any(m is not None for m in mats_h):
        out.append(ResizeAxis(-1, tuple(mats_h)))
    return out


def _chroma_downsample_ops(dst, s: ScaleSpec) -> List[Op]:
    """Comps are at the dst luma grid; bring chroma comps to dst chroma grid."""
    cw, ch, dx, dy, ox, oy = _comp_grid(dst, 1, s.dst_w, s.dst_h,
                                        s.dst_chroma_loc)
    nb = dst.nb_components
    mh = _filters.resize_matrix(cw, s.dst_w, s.filter, s.param, s.antialias,
                                scale=1.0, dst_step=dx, dst_off=ox)
    mv = _filters.resize_matrix(ch, s.dst_h, s.filter, s.param, s.antialias,
                                scale=1.0, dst_step=dy, dst_off=oy)
    mats_h = tuple([None, mh, mh] + [None] * (nb - 3))
    mats_v = tuple([None, mv, mv] + [None] * (nb - 3))
    return [ResizeAxis(-2, mats_v), ResizeAxis(-1, mats_h)]


def _resize_comp_to_comp(src, dst, s: ScaleSpec, scale_x, scale_y) -> List[Op]:
    """No CSC: each dst comp comes from the matching src comp's own grid."""
    mats_h, mats_v = [], []
    for i in range(dst.nb_components):
        # source comp index mirrors SelectComps in build_ops
        si = i if i < src.nb_components else 0
        if dst.has_alpha and i == dst.nb_components - 1:
            si = src.nb_components - 1 if src.has_alpha else None
        if si is None or (_kind(src) == "gray" and i in (1, 2) and _kind(dst) == "yuv"):
            # a synthesized constant comp is made at the src luma grid and
            # still needs the resize to the dst grid
            si = 0
        snx, sny, ssx, ssy, sox, soy = _comp_grid(src, min(si, src.nb_components - 1),
                                                  s.src_w, s.src_h, s.src_chroma_loc)
        dnx, dny, dsx, dsy, dox, doy = _comp_grid(dst, i, s.dst_w, s.dst_h,
                                                  s.dst_chroma_loc)
        mh = _filters.resize_matrix(dnx, snx, s.filter, s.param, s.antialias,
                                    scale=scale_x, src_step=ssx, src_off=sox,
                                    dst_step=dsx, dst_off=dox)
        mv = _filters.resize_matrix(dny, sny, s.filter, s.param, s.antialias,
                                    scale=scale_y, src_step=ssy, src_off=soy,
                                    dst_step=dsy, dst_off=doy)
        mats_h.append(None if (dnx == snx and _is_identity(mh)) else mh)
        mats_v.append(None if (dny == sny and _is_identity(mv)) else mv)
    out = []
    if any(m is not None for m in mats_v):
        out.append(ResizeAxis(-2, tuple(mats_v)))
    if any(m is not None for m in mats_h):
        out.append(ResizeAxis(-1, tuple(mats_h)))
    return out


def _is_identity(m: np.ndarray) -> bool:
    return m.shape[0] == m.shape[1] and np.allclose(m, np.eye(m.shape[0]), atol=1e-6)


class Scaler:
    """sws context: build the op list once, run it on many batches."""

    def __init__(self, device: torch.device | str = "cuda", **kw):
        self.device = torch.device(device)
        self.spec = ScaleSpec(**kw)
        self.ops = build_ops(self.spec)
        self._fn = compile_ops(self.ops)

    def run(self, comps: Sequence) -> List[torch.Tensor]:
        """comps: per-component tensors or numpy arrays (..., h_c, w_c) in
        native dtype.  Tensors on the scaler's device go in as they are,
        numpy arrays are copied there once, and a tensor on another device
        raises InvalidData.  The outputs stay on the device."""
        return self._fn(device_planes(comps, self.device))

    def scale_frame(self, frame: Frame) -> Frame:
        """Scale one Frame; its output planes are tensors on the scaler's
        device."""
        s = self.spec
        if (frame.width, frame.height) != (s.src_w, s.src_h):
            raise InvalidData("frame size does not match scaler spec")
        out_comps = self.run(frame.planes)
        out = frame.clone_props()
        out.width, out.height = s.dst_w, s.dst_h
        out.format = _pf.get(s.dst_fmt).name
        out.planes = list(out_comps)
        dk = _kind(_pf.get(s.dst_fmt))
        out.color_range = "pc" if (s.dst_range or dk == "rgb") else "tv"
        out.color_space = "rgb" if dk == "rgb" else s.dst_colorspace
        return out


@lru_cache(maxsize=64)
def _cached_scaler(device: str, items: tuple) -> Scaler:
    return Scaler(device, **dict(items))


def get_scaler(device: torch.device | str = "cuda", **kw) -> Scaler:
    return _cached_scaler(str(torch.device(device)), tuple(sorted(kw.items())))


def scale_frame(frame: Frame, dst_w: int, dst_h: int, dst_fmt: str,
                device: torch.device | str = "cuda", **kw) -> Frame:
    """One-shot API (sws_scale_frame analog) with the reference's
    defaults: the source colour space and range are the frame's.  Scalers
    are cached per device and spec."""
    if frame.color_space not in ("unspecified", "rgb"):
        kw.setdefault("src_colorspace", frame.color_space)
    kw.setdefault("src_range", frame.color_range == "pc")
    sc = get_scaler(
        device, src_w=frame.width, src_h=frame.height, src_fmt=frame.format,
        dst_w=dst_w, dst_h=dst_h, dst_fmt=dst_fmt, **kw)
    return sc.scale_frame(frame)
