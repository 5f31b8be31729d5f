"""Pixel format descriptors (the port's copy of the part of
ffmpeg_tpu/formats/pixfmt.py it reads; analog of libavutil/pixdesc.h).

The port's scaler and encoder read a descriptor's components (depth),
chroma subsampling, flags and sample dtype.  The table holds the
software formats of the reference's main table: planar and semi-planar
YUV, gray, packed and planar RGB, packed 4:2:2, pal8 and mono.  The
reference's later additions (big-endian and MSB-aligned variants, float
and 32-bit RGB, Bayer, XYZ, hardware surfaces) are not carried.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np

from ..utils.error import InvalidData

# Flags — values match AV_PIX_FMT_FLAG_* (pixdesc.h).
FLAG_BE = 1 << 0
FLAG_PAL = 1 << 1
FLAG_BITSTREAM = 1 << 2
FLAG_HWACCEL = 1 << 3
FLAG_PLANAR = 1 << 4
FLAG_RGB = 1 << 5
FLAG_ALPHA = 1 << 7
FLAG_BAYER = 1 << 8
FLAG_FLOAT = 1 << 9


@dataclass(frozen=True)
class ComponentDesc:
    """One component's location (pixdesc.h AVComponentDescriptor)."""

    plane: int    # which data plane
    step: int     # bytes between successive samples (bits if BITSTREAM)
    offset: int   # byte offset of first sample within step
    shift: int    # right-shift to extract value
    depth: int    # meaningful bits


@dataclass(frozen=True)
class PixFmtDescriptor:
    name: str
    nb_components: int
    log2_chroma_w: int
    log2_chroma_h: int
    flags: int
    comp: Tuple[ComponentDesc, ...]
    # components in fixed order: Y,U,V,A ; R,G,B,A ; gray Y(,A)

    @property
    def is_planar(self) -> bool:
        return bool(self.flags & FLAG_PLANAR)

    @property
    def is_rgb(self) -> bool:
        return bool(self.flags & FLAG_RGB)

    @property
    def is_float(self) -> bool:
        return bool(self.flags & FLAG_FLOAT)

    @property
    def is_be(self) -> bool:
        return bool(self.flags & FLAG_BE)

    @property
    def has_alpha(self) -> bool:
        return bool(self.flags & FLAG_ALPHA)

    @property
    def nb_planes(self) -> int:
        return 1 + max(c.plane for c in self.comp)

    @property
    def depth(self) -> int:
        return max(c.depth for c in self.comp)

    def chroma_dims(self, width: int, height: int) -> Tuple[int, int]:
        cw = (width + (1 << self.log2_chroma_w) - 1) >> self.log2_chroma_w
        ch = (height + (1 << self.log2_chroma_h) - 1) >> self.log2_chroma_h
        return cw, ch

    def component_dtype(self) -> np.dtype:
        if self.is_float:
            return np.dtype(np.float32) if self.depth == 32 \
                else np.dtype(np.float16)
        if self.depth <= 8:
            return np.dtype(np.uint8)
        if self.depth <= 16:
            return np.dtype(np.uint16)
        return np.dtype(np.uint32)


_REGISTRY: Dict[str, PixFmtDescriptor] = {}
_ALIASES: Dict[str, str] = {}


def register(desc: PixFmtDescriptor,
             aliases: Sequence[str] = ()) -> PixFmtDescriptor:
    _REGISTRY[desc.name] = desc
    for a in aliases:
        _ALIASES[a] = desc.name
    return desc


def get(name) -> PixFmtDescriptor:
    if isinstance(name, PixFmtDescriptor):
        return name
    n = str(name)
    n = _ALIASES.get(n, n)
    d = _REGISTRY.get(n)
    if d is None:
        raise InvalidData(f"unknown pixel format {name!r}")
    return d


def all_formats() -> Dict[str, PixFmtDescriptor]:
    return dict(_REGISTRY)


# --- generators (compress the pixdesc.c table) ------------------------------

def _planar_yuv(name, lw, lh, depth=8, alpha=False, be=False):
    nb = 4 if alpha else 3
    step = 1 if depth <= 8 else 2
    flags = FLAG_PLANAR | (FLAG_BE if be else 0) | (FLAG_ALPHA if alpha else 0)
    comp = [ComponentDesc(p, step, 0, 0, depth) for p in range(nb)]
    register(PixFmtDescriptor(name, nb, lw, lh, flags, tuple(comp)))


def _planar_rgb(name, depth=8, alpha=False, be=False, flt=False):
    nb = 4 if alpha else 3
    step = 1 if depth <= 8 else (4 if flt else 2)
    flags = FLAG_PLANAR | FLAG_RGB | (FLAG_BE if be else 0) | \
        (FLAG_ALPHA if alpha else 0) | (FLAG_FLOAT if flt else 0)
    # GBR plane order like the reference's gbrp: R on plane 2, G on 0, B on 1
    planes = (2, 0, 1, 3)
    comp = [ComponentDesc(planes[i], step, 0, 0, depth) for i in range(nb)]
    register(PixFmtDescriptor(name, nb, 0, 0, flags, tuple(comp)))


def _packed_rgb(name, order, depth=8, be=False):
    """order: string like 'rgb', 'bgra', 'argb' giving byte positions."""
    bpc = 1 if depth <= 8 else 2
    step = len(order) * bpc
    flags = FLAG_RGB | (FLAG_BE if be else 0) | \
        (FLAG_ALPHA if "a" in order else 0)
    pos = {ch: i for i, ch in enumerate(order)}
    comp = tuple(ComponentDesc(0, step, pos[ch] * bpc, 0, depth)
                 for ch in ("r", "g", "b", "a")[:len(order)])
    register(PixFmtDescriptor(name, len(order), 0, 0, flags, comp))


def _semiplanar(name, lw, lh, depth=8, swapped=False, shift=0):
    """NV12-family: plane0 = Y, plane1 = interleaved UV (or VU)."""
    bpc = 1 if depth <= 8 else 2
    u_off, v_off = (bpc, 0) if swapped else (0, bpc)
    comp = (ComponentDesc(0, bpc, 0, shift, depth),
            ComponentDesc(1, 2 * bpc, u_off, shift, depth),
            ComponentDesc(1, 2 * bpc, v_off, shift, depth))
    register(PixFmtDescriptor(name, 3, lw, lh, FLAG_PLANAR, comp))


# --- the table ---------------------------------------------------------------

_planar_yuv("yuv420p", 1, 1)
_planar_yuv("yuv422p", 1, 0)
_planar_yuv("yuv444p", 0, 0)
_planar_yuv("yuv410p", 2, 2)
_planar_yuv("yuv411p", 2, 0)
_planar_yuv("yuv440p", 0, 1)
_planar_yuv("yuva420p", 1, 1, alpha=True)
_planar_yuv("yuva422p", 1, 0, alpha=True)
_planar_yuv("yuva444p", 0, 0, alpha=True)
# "J" range aliases (deprecated full-range names map to the base fmt)
_ALIASES.update({"yuvj420p": "yuv420p", "yuvj422p": "yuv422p",
                 "yuvj444p": "yuv444p", "yuvj440p": "yuv440p",
                 "yuvj411p": "yuv411p"})

for d in (9, 10, 12, 14, 16):
    for sub, lw, lh in (("420", 1, 1), ("422", 1, 0), ("444", 0, 0)):
        _planar_yuv(f"yuv{sub}p{d}le", lw, lh, depth=d)
        _planar_yuv(f"yuv{sub}p{d}be", lw, lh, depth=d, be=True)
for d in (10, 12, 16):
    for sub, lw, lh in (("420", 1, 1), ("422", 1, 0), ("444", 0, 0)):
        _planar_yuv(f"yuva{sub}p{d}le", lw, lh, depth=d, alpha=True)
_ALIASES.update({f"yuv{s}p{d}": f"yuv{s}p{d}le"
                 for s in ("420", "422", "444") for d in (9, 10, 12, 14, 16)})

register(PixFmtDescriptor("gray", 1, 0, 0, 0,
                          (ComponentDesc(0, 1, 0, 0, 8),)),
         aliases=["gray8", "y8"])
register(PixFmtDescriptor("gray10le", 1, 0, 0, FLAG_PLANAR,
                          (ComponentDesc(0, 2, 0, 0, 10),)))
register(PixFmtDescriptor("gray12le", 1, 0, 0, FLAG_PLANAR,
                          (ComponentDesc(0, 2, 0, 0, 12),)))
register(PixFmtDescriptor("gray16le", 1, 0, 0, 0,
                          (ComponentDesc(0, 2, 0, 0, 16),)),
         aliases=["gray16", "y16"])
register(PixFmtDescriptor("gray16be", 1, 0, 0, FLAG_BE,
                          (ComponentDesc(0, 2, 0, 0, 16),)))
register(PixFmtDescriptor("grayf32le", 1, 0, 0, FLAG_FLOAT,
                          (ComponentDesc(0, 4, 0, 0, 32),)),
         aliases=["grayf32"])
register(PixFmtDescriptor("ya8", 2, 0, 0, FLAG_ALPHA,
                          (ComponentDesc(0, 2, 0, 0, 8),
                           ComponentDesc(0, 2, 1, 0, 8))))

_packed_rgb("rgb24", "rgb")
_packed_rgb("bgr24", "bgr")
_packed_rgb("rgba", "rgba")
_packed_rgb("bgra", "bgra")
_packed_rgb("argb", "argb")
_packed_rgb("abgr", "abgr")
_packed_rgb("rgb48le", "rgb", depth=16)
_packed_rgb("rgb48be", "rgb", depth=16, be=True)
_packed_rgb("rgba64le", "rgba", depth=16)
_packed_rgb("rgba64be", "rgba", depth=16, be=True)
for _name, _offs in (("0rgb", (1, 2, 3)), ("rgb0", (0, 1, 2)),
                     ("0bgr", (3, 2, 1)), ("bgr0", (2, 1, 0))):
    register(PixFmtDescriptor(_name, 3, 0, 0, FLAG_RGB, tuple(
        ComponentDesc(0, 4, o, 0, 8) for o in _offs)))

# 16-bit packed small RGB (565/555/444): a shift on a uint16 unit
for _name, _bits, _shifts, _be in (
    ("rgb565le", (5, 6, 5), (11, 5, 0), False),
    ("rgb565be", (5, 6, 5), (11, 5, 0), True),
    ("bgr565le", (5, 6, 5), (0, 5, 11), False),
    ("rgb555le", (5, 5, 5), (10, 5, 0), False),
    ("bgr555le", (5, 5, 5), (0, 5, 10), False),
    ("rgb444le", (4, 4, 4), (8, 4, 0), False),
    ("bgr444le", (4, 4, 4), (0, 4, 8), False),
):
    register(PixFmtDescriptor(
        _name, 3, 0, 0, FLAG_RGB | (FLAG_BE if _be else 0),
        tuple(ComponentDesc(0, 2, 0, sh, b) for b, sh in zip(_bits, _shifts))))
_ALIASES.update({"rgb565": "rgb565le", "rgb555": "rgb555le",
                 "bgr565": "bgr565le"})

_planar_rgb("gbrp")
for d in (9, 10, 12, 14, 16):
    _planar_rgb(f"gbrp{d}le", depth=d)
_planar_rgb("gbrap", alpha=True)
_planar_rgb("gbrap10le", depth=10, alpha=True)
_planar_rgb("gbrap12le", depth=12, alpha=True)
_planar_rgb("gbrap16le", depth=16, alpha=True)
_planar_rgb("gbrpf32le", depth=32, flt=True)
_planar_rgb("gbrapf32le", depth=32, alpha=True, flt=True)
_ALIASES.update({"gbrp10": "gbrp10le", "gbrp12": "gbrp12le",
                 "gbrp16": "gbrp16le", "gbrpf32": "gbrpf32le"})

_semiplanar("nv12", 1, 1)
_semiplanar("nv21", 1, 1, swapped=True)
_semiplanar("nv16", 1, 0)
_semiplanar("nv24", 0, 0)
_semiplanar("p010le", 1, 1, depth=10, shift=6)
_semiplanar("p012le", 1, 1, depth=12, shift=4)
_semiplanar("p016le", 1, 1, depth=16)
_semiplanar("p210le", 1, 0, depth=10, shift=6)
_semiplanar("p216le", 1, 0, depth=16)
_ALIASES.update({"p010": "p010le", "p016": "p016le"})

register(PixFmtDescriptor("yuyv422", 3, 1, 0, 0, (
    ComponentDesc(0, 2, 0, 0, 8), ComponentDesc(0, 4, 1, 0, 8),
    ComponentDesc(0, 4, 3, 0, 8))))
register(PixFmtDescriptor("uyvy422", 3, 1, 0, 0, (
    ComponentDesc(0, 2, 1, 0, 8), ComponentDesc(0, 4, 0, 0, 8),
    ComponentDesc(0, 4, 2, 0, 8))))
register(PixFmtDescriptor("yvyu422", 3, 1, 0, 0, (
    ComponentDesc(0, 2, 0, 0, 8), ComponentDesc(0, 4, 3, 0, 8),
    ComponentDesc(0, 4, 1, 0, 8))))

register(PixFmtDescriptor("pal8", 1, 0, 0, FLAG_PAL,
                          (ComponentDesc(0, 1, 0, 0, 8),)))
register(PixFmtDescriptor("monow", 1, 0, 0, FLAG_BITSTREAM,
                          (ComponentDesc(0, 1, 0, 0, 1),)))
register(PixFmtDescriptor("monob", 1, 0, 0, FLAG_BITSTREAM,
                          (ComponentDesc(0, 1, 0, 0, 1),)))
