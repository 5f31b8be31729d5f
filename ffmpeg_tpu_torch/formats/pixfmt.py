"""Pixel format registry (the port's copy of ffmpeg_tpu/formats/pixfmt.py;
analog of libavutil/pixdesc.{c,h} + pixfmt.h).

Descriptor-driven like FFmpeg's (pixfmt.h lists ~271 formats; the
descriptor table in pixdesc.c drives all generic (un)packing): the
port's scaler, encoders and filters read a descriptor's components,
chroma subsampling, flags and sample dtype.  The table, the aliases and
the colour enums are the reference's, held equal to them by
tests/test_torch_host_copies.py and tests/test_torch_api_parity.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

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
    # order of components is fixed: YUV(A) → Y,U,V,A ; RGB(A) → R,G,B,A ; gray → Y(,A)

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

    def bits_per_pixel(self) -> int:
        """av_get_bits_per_pixel (pixdesc.c): average bits per pixel, with
        chroma components weighted by their subsampling."""
        total = 0.0
        for i, c in enumerate(self.comp):
            sub = self.log2_chroma_w + self.log2_chroma_h if (i in (1, 2) and not self.is_rgb) else 0
            total += c.depth / (1 << sub)
        return int(total)

    def chroma_dims(self, width: int, height: int) -> Tuple[int, int]:
        cw = -(-width >> self.log2_chroma_w) if width % (1 << self.log2_chroma_w) else width >> self.log2_chroma_w
        ch = -(-height >> self.log2_chroma_h) if height % (1 << self.log2_chroma_h) else height >> self.log2_chroma_h
        cw = (width + (1 << self.log2_chroma_w) - 1) >> self.log2_chroma_w
        ch = (height + (1 << self.log2_chroma_h) - 1) >> self.log2_chroma_h
        return cw, ch

    def plane_dims(self, plane: int, width: int, height: int) -> Tuple[int, int]:
        """(w, h) in sample positions of a given plane (a semi-planar UV
        plane has chroma_w positions, each holding 2 interleaved samples)."""
        if self._plane_is_chroma(plane):
            return self.chroma_dims(width, height)
        return width, height

    def _plane_is_chroma(self, plane: int) -> bool:
        if self.is_rgb:
            return False
        for i, c in enumerate(self.comp):
            if c.plane == plane and i in (1, 2):
                return True
        return False

    def plane_width_mult(self, plane: int) -> int:
        """samples per pixel-position in this plane (e.g. NV12 plane1 = 2)."""
        return sum(1 for c in self.comp if c.plane == plane)

    def component_dtype(self) -> np.dtype:
        if self.is_float:
            return np.dtype(np.float32) if self.depth == 32 else np.dtype(np.float16)
        if self.depth <= 8:
            return np.dtype(np.uint8)
        if self.depth <= 16:
            return np.dtype(np.uint16)
        return np.dtype(np.uint32)


_REGISTRY: Dict[str, PixFmtDescriptor] = {}
_ALIASES: Dict[str, str] = {}


def register(desc: PixFmtDescriptor, aliases: Sequence[str] = ()) -> PixFmtDescriptor:
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


def exists(name: str) -> bool:
    try:
        get(name)
        return True
    except InvalidData:
        return False


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
    flags = FLAG_RGB | (FLAG_BE if be else 0) | (FLAG_ALPHA if "a" in order else 0)
    pos = {ch: i for i, ch in enumerate(order)}
    nb = len(order)
    names = "rgba"[:4] if "a" in order else "rgb"
    comp = []
    for ch in ("r", "g", "b", "a")[:nb]:
        comp.append(ComponentDesc(0, step, pos[ch] * bpc, 0, depth))
    register(PixFmtDescriptor(name, nb, 0, 0, flags, tuple(comp)))


def _semiplanar(name, lw, lh, depth=8, swapped=False, shift=0):
    """NV12-family: plane0 = Y, plane1 = interleaved UV (or VU)."""
    bpc = 1 if depth <= 8 else 2
    flags = FLAG_PLANAR
    u_off, v_off = (bpc, 0) if swapped else (0, bpc)
    comp = (
        ComponentDesc(0, bpc, 0, shift, depth),
        ComponentDesc(1, 2 * bpc, u_off, shift, depth),
        ComponentDesc(1, 2 * bpc, v_off, shift, depth),
    )
    register(PixFmtDescriptor(name, 3, lw, lh, flags, comp))


# --- the table ---------------------------------------------------------------

# planar YUV, 8-bit
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

# planar YUV, high bit depth (le only on the wire-level we also keep be)
for d in (9, 10, 12, 14, 16):
    for sub, lw, lh in (("420", 1, 1), ("422", 1, 0), ("444", 0, 0)):
        _planar_yuv(f"yuv{sub}p{d}le", lw, lh, depth=d)
        _planar_yuv(f"yuv{sub}p{d}be", lw, lh, depth=d, be=True)
for d in (10, 12, 16):
    for sub, lw, lh in (("420", 1, 1), ("422", 1, 0), ("444", 0, 0)):
        _planar_yuv(f"yuva{sub}p{d}le", lw, lh, depth=d, alpha=True)
_ALIASES.update({f"yuv{s}p{d}": f"yuv{s}p{d}le"
                 for s in ("420", "422", "444") for d in (9, 10, 12, 14, 16)})

# gray
register(PixFmtDescriptor("gray", 1, 0, 0, 0, (ComponentDesc(0, 1, 0, 0, 8),)),
         aliases=["gray8", "y8"])
register(PixFmtDescriptor("gray10le", 1, 0, 0, FLAG_PLANAR, (ComponentDesc(0, 2, 0, 0, 10),)))
register(PixFmtDescriptor("gray12le", 1, 0, 0, FLAG_PLANAR, (ComponentDesc(0, 2, 0, 0, 12),)))
register(PixFmtDescriptor("gray16le", 1, 0, 0, 0, (ComponentDesc(0, 2, 0, 0, 16),)),
         aliases=["gray16", "y16"])
register(PixFmtDescriptor("gray16be", 1, 0, 0, FLAG_BE, (ComponentDesc(0, 2, 0, 0, 16),)))
register(PixFmtDescriptor("grayf32le", 1, 0, 0, FLAG_FLOAT, (ComponentDesc(0, 4, 0, 0, 32),)),
         aliases=["grayf32"])
register(PixFmtDescriptor("ya8", 2, 0, 0, FLAG_ALPHA,
                          (ComponentDesc(0, 2, 0, 0, 8), ComponentDesc(0, 2, 1, 0, 8))))

# packed RGB
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
register(PixFmtDescriptor("0rgb", 3, 0, 0, FLAG_RGB, (
    ComponentDesc(0, 4, 1, 0, 8), ComponentDesc(0, 4, 2, 0, 8), ComponentDesc(0, 4, 3, 0, 8))))
register(PixFmtDescriptor("rgb0", 3, 0, 0, FLAG_RGB, (
    ComponentDesc(0, 4, 0, 0, 8), ComponentDesc(0, 4, 1, 0, 8), ComponentDesc(0, 4, 2, 0, 8))))
register(PixFmtDescriptor("0bgr", 3, 0, 0, FLAG_RGB, (
    ComponentDesc(0, 4, 3, 0, 8), ComponentDesc(0, 4, 2, 0, 8), ComponentDesc(0, 4, 1, 0, 8))))
register(PixFmtDescriptor("bgr0", 3, 0, 0, FLAG_RGB, (
    ComponentDesc(0, 4, 2, 0, 8), ComponentDesc(0, 4, 1, 0, 8), ComponentDesc(0, 4, 0, 0, 8))))

# 16-bit packed small RGB (565/555/444): expressed via shift on a uint16 unit
for name, bits, shifts, be in (
    ("rgb565le", (5, 6, 5), (11, 5, 0), False),
    ("rgb565be", (5, 6, 5), (11, 5, 0), True),
    ("bgr565le", (5, 6, 5), (0, 5, 11), False),
    ("rgb555le", (5, 5, 5), (10, 5, 0), False),
    ("bgr555le", (5, 5, 5), (0, 5, 10), False),
    ("rgb444le", (4, 4, 4), (8, 4, 0), False),
    ("bgr444le", (4, 4, 4), (0, 4, 8), False),
):
    comp = tuple(ComponentDesc(0, 2, 0, sh, b) for b, sh in zip(bits, shifts))
    register(PixFmtDescriptor(name, 3, 0, 0, FLAG_RGB | (FLAG_BE if be else 0), comp))
_ALIASES.update({"rgb565": "rgb565le", "rgb555": "rgb555le", "bgr565": "bgr565le"})

# planar RGB (GBR plane order like the reference)
_planar_rgb("gbrp")
for d in (9, 10, 12, 14, 16):
    _planar_rgb(f"gbrp{d}le", depth=d)
_planar_rgb("gbrap", alpha=True)
_planar_rgb("gbrap10le", depth=10, alpha=True)
_planar_rgb("gbrap12le", depth=12, alpha=True)
_planar_rgb("gbrap16le", depth=16, alpha=True)
_planar_rgb("gbrpf32le", depth=32, flt=True)
_planar_rgb("gbrapf32le", depth=32, alpha=True, flt=True)
_ALIASES.update({"gbrp10": "gbrp10le", "gbrp12": "gbrp12le", "gbrp16": "gbrp16le",
                 "gbrpf32": "gbrpf32le"})

# semi-planar
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

# packed YUV 4:2:2
register(PixFmtDescriptor("yuyv422", 3, 1, 0, 0, (
    ComponentDesc(0, 2, 0, 0, 8), ComponentDesc(0, 4, 1, 0, 8), ComponentDesc(0, 4, 3, 0, 8))))
register(PixFmtDescriptor("uyvy422", 3, 1, 0, 0, (
    ComponentDesc(0, 2, 1, 0, 8), ComponentDesc(0, 4, 0, 0, 8), ComponentDesc(0, 4, 2, 0, 8))))
register(PixFmtDescriptor("yvyu422", 3, 1, 0, 0, (
    ComponentDesc(0, 2, 0, 0, 8), ComponentDesc(0, 4, 3, 0, 8), ComponentDesc(0, 4, 1, 0, 8))))

# pal8 & mono
register(PixFmtDescriptor("pal8", 1, 0, 0, FLAG_PAL, (ComponentDesc(0, 1, 0, 0, 8),)))
register(PixFmtDescriptor("monow", 1, 0, 0, FLAG_BITSTREAM, (ComponentDesc(0, 1, 0, 0, 1),)))
register(PixFmtDescriptor("monob", 1, 0, 0, FLAG_BITSTREAM, (ComponentDesc(0, 1, 0, 0, 1),)))



# --- registry completion toward the full pixdesc.c table ---------------------

# remaining planar YUV combinations
_planar_yuv("yuv440p10le", 0, 1, depth=10)
_planar_yuv("yuv440p10be", 0, 1, depth=10, be=True)
_planar_yuv("yuv440p12le", 0, 1, depth=12)
_planar_yuv("yuv440p12be", 0, 1, depth=12, be=True)
for d in (9, 10, 12, 16):
    for sub, lw, lh in (("420", 1, 1), ("422", 1, 0), ("444", 0, 0)):
        if f"yuva{sub}p{d}le" not in _REGISTRY:
            _planar_yuv(f"yuva{sub}p{d}le", lw, lh, depth=d, alpha=True)
        _planar_yuv(f"yuva{sub}p{d}be", lw, lh, depth=d, alpha=True,
                    be=True)

# big-endian planar RGB + float variants
for d in (9, 10, 12, 14, 16):
    _planar_rgb(f"gbrp{d}be", depth=d, be=True)
for d in (10, 12, 14, 16):
    if f"gbrap{d}le" not in _REGISTRY:
        _planar_rgb(f"gbrap{d}le", depth=d, alpha=True)
    _planar_rgb(f"gbrap{d}be", depth=d, alpha=True, be=True)
_planar_rgb("gbrpf32be", depth=32, be=True, flt=True)
_planar_rgb("gbrapf32be", depth=32, alpha=True, be=True, flt=True)
if "gbrapf32le" not in _REGISTRY:
    _planar_rgb("gbrapf32le", depth=32, alpha=True, flt=True)

# packed RGB remainder
_packed_rgb("rgb48be2", "rgb", depth=16, be=True) if False else None
for nm, order, be in (("bgr48le", "bgr", False), ("bgr48be", "bgr", True),
                      ("bgra64le", "bgra", False),
                      ("bgra64be", "bgra", True)):
    if nm not in _REGISTRY:
        _packed_rgb(nm, order, depth=16, be=be)
for nm in ("rgb444be", "rgb555be", "bgr444be", "bgr555be", "bgr565be"):
    base = nm[:-2] + "le"
    if base in _REGISTRY and nm not in _REGISTRY:
        d0 = _REGISTRY[base]
        register(PixFmtDescriptor(nm, d0.nb_components, d0.log2_chroma_w,
                                  d0.log2_chroma_h, d0.flags | FLAG_BE,
                                  d0.comp))

# low-bit packed RGB (bitstream-ish formats kept as descriptors)
register(PixFmtDescriptor("rgb8", 3, 0, 0, FLAG_RGB,
                          (ComponentDesc(0, 1, 0, 5, 3),
                           ComponentDesc(0, 1, 0, 2, 3),
                           ComponentDesc(0, 1, 0, 0, 2))))
register(PixFmtDescriptor("bgr8", 3, 0, 0, FLAG_RGB,
                          (ComponentDesc(0, 1, 0, 0, 3),
                           ComponentDesc(0, 1, 0, 3, 3),
                           ComponentDesc(0, 1, 0, 6, 2))))

# gray remainder
_planar_yuv("gray9le", 0, 0, depth=9) if False else None
for d in (9, 14):
    register(PixFmtDescriptor(f"gray{d}le", 1, 0, 0, FLAG_PLANAR,
                              (ComponentDesc(0, 2, 0, 0, d),)))
    register(PixFmtDescriptor(f"gray{d}be", 1, 0, 0,
                              FLAG_PLANAR | FLAG_BE,
                              (ComponentDesc(0, 2, 0, 0, d),)))
for d in (10, 12):
    register(PixFmtDescriptor(f"gray{d}be", 1, 0, 0,
                              FLAG_PLANAR | FLAG_BE,
                              (ComponentDesc(0, 2, 0, 0, d),)))
register(PixFmtDescriptor("grayf32be", 1, 0, 0, FLAG_FLOAT | FLAG_BE,
                          (ComponentDesc(0, 4, 0, 0, 32),)))
register(PixFmtDescriptor("ya16le", 2, 0, 0, FLAG_ALPHA,
                          (ComponentDesc(0, 4, 0, 0, 16),
                           ComponentDesc(0, 4, 2, 0, 16))))
register(PixFmtDescriptor("ya16be", 2, 0, 0, FLAG_ALPHA | FLAG_BE,
                          (ComponentDesc(0, 4, 0, 0, 16),
                           ComponentDesc(0, 4, 2, 0, 16))))

# semiplanar remainder
_semiplanar("nv42", 0, 0, swapped=True)
_semiplanar("nv20le", 1, 0, depth=10)
_semiplanar("p410le", 0, 0, depth=10, shift=6)
_semiplanar("p412le", 0, 0, depth=12, shift=4)
_semiplanar("p416le", 0, 0, depth=16)

# packed 4:4:4 / alpha YUV
register(PixFmtDescriptor("ayuv64le", 4, 0, 0, FLAG_ALPHA,
                          (ComponentDesc(0, 8, 2, 0, 16),
                           ComponentDesc(0, 8, 4, 0, 16),
                           ComponentDesc(0, 8, 6, 0, 16),
                           ComponentDesc(0, 8, 0, 0, 16))))
register(PixFmtDescriptor("vuya", 4, 0, 0, FLAG_ALPHA,
                          (ComponentDesc(0, 4, 2, 0, 8),
                           ComponentDesc(0, 4, 1, 0, 8),
                           ComponentDesc(0, 4, 0, 0, 8),
                           ComponentDesc(0, 4, 3, 0, 8))))
register(PixFmtDescriptor("uyyvyy411", 3, 2, 0, FLAG_BITSTREAM,
                          (ComponentDesc(0, 6, 1, 0, 8),
                           ComponentDesc(0, 6, 0, 0, 8),
                           ComponentDesc(0, 6, 3, 0, 8))))
register(PixFmtDescriptor("y210le", 3, 1, 0, 0,
                          (ComponentDesc(0, 4, 0, 6, 10),
                           ComponentDesc(0, 8, 2, 6, 10),
                           ComponentDesc(0, 8, 6, 6, 10))))
register(PixFmtDescriptor("y212le", 3, 1, 0, 0,
                          (ComponentDesc(0, 4, 0, 4, 12),
                           ComponentDesc(0, 8, 2, 4, 12),
                           ComponentDesc(0, 8, 6, 4, 12))))
register(PixFmtDescriptor("xv30le", 3, 0, 0, 0,
                          (ComponentDesc(0, 4, 0, 10, 10),
                           ComponentDesc(0, 4, 0, 0, 10),
                           ComponentDesc(0, 4, 0, 20, 10))))
register(PixFmtDescriptor("xv36le", 3, 0, 0, 0,
                          (ComponentDesc(0, 8, 2, 4, 12),
                           ComponentDesc(0, 8, 0, 4, 12),
                           ComponentDesc(0, 8, 4, 4, 12))))

# Bayer mosaics (FLAG_BAYER; single plane)
for pat in ("bggr", "rggb", "gbrg", "grbg"):
    register(PixFmtDescriptor(f"bayer_{pat}8", 3, 1, 1, FLAG_BAYER,
                              (ComponentDesc(0, 1, 0, 0, 8),) * 3))
    register(PixFmtDescriptor(f"bayer_{pat}16le", 3, 1, 1, FLAG_BAYER,
                              (ComponentDesc(0, 2, 0, 0, 16),) * 3))
    register(PixFmtDescriptor(f"bayer_{pat}16be", 3, 1, 1,
                              FLAG_BAYER | FLAG_BE,
                              (ComponentDesc(0, 2, 0, 0, 16),) * 3))

# XYZ (DCI)
register(PixFmtDescriptor("xyz12le", 3, 0, 0, FLAG_RGB,
                          (ComponentDesc(0, 6, 0, 4, 12),
                           ComponentDesc(0, 6, 2, 4, 12),
                           ComponentDesc(0, 6, 4, 4, 12))))
register(PixFmtDescriptor("xyz12be", 3, 0, 0, FLAG_RGB | FLAG_BE,
                          (ComponentDesc(0, 6, 0, 4, 12),
                           ComponentDesc(0, 6, 2, 4, 12),
                           ComponentDesc(0, 6, 4, 4, 12))))

_ALIASES.update({"yuv440p10": "yuv440p10le", "yuv440p12": "yuv440p12le",
                 "ya16": "ya16le", "y210": "y210le", "y212": "y212le",
                 "xv30": "xv30le", "xv36": "xv36le",
                 "ayuv64": "ayuv64le", "nv20": "nv20le"})


# --- pixdesc.c parity: remaining software formats ---------------------------

# The full-range JPEG names (yuvj420p, yuvj422p, yuvj444p, yuvj440p,
# yuvj411p) stay the aliases set above: get() reads an alias before the
# table, so a registration under those names could never be returned,
# and the table holds none.
register(PixFmtDescriptor("yuv411p", 3, 2, 0, FLAG_PLANAR, (
    ComponentDesc(0, 1, 0, 0, 8), ComponentDesc(1, 1, 0, 0, 8),
    ComponentDesc(2, 1, 0, 0, 8)))) if not exists("yuv411p") else None

# half/float gray + luma-alpha
register(PixFmtDescriptor("grayf16le", 1, 0, 0, FLAG_FLOAT,
                          (ComponentDesc(0, 2, 0, 0, 16),)))
register(PixFmtDescriptor("grayf16be", 1, 0, 0, FLAG_FLOAT | FLAG_BE,
                          (ComponentDesc(0, 2, 0, 0, 16),)))
register(PixFmtDescriptor("gray32le", 1, 0, 0, FLAG_PLANAR,
                          (ComponentDesc(0, 4, 0, 0, 32),)))
register(PixFmtDescriptor("gray32be", 1, 0, 0, FLAG_PLANAR | FLAG_BE,
                          (ComponentDesc(0, 4, 0, 0, 32),)))
for nm, sz, dep, fl in (("yaf16le", 4, 16, FLAG_FLOAT),
                        ("yaf16be", 4, 16, FLAG_FLOAT | FLAG_BE),
                        ("yaf32le", 8, 32, FLAG_FLOAT),
                        ("yaf32be", 8, 32, FLAG_FLOAT | FLAG_BE)):
    register(PixFmtDescriptor(nm, 2, 0, 0, fl | FLAG_ALPHA,
                              (ComponentDesc(0, sz, 0, 0, dep),
                               ComponentDesc(0, sz, sz // 2, 0, dep))))

# half-float / 32-bit planar RGB
_planar_rgb("gbrpf16le", depth=16, flt=True)
_planar_rgb("gbrpf16be", depth=16, be=True, flt=True)
_planar_rgb("gbrapf16le", depth=16, alpha=True, flt=True)
_planar_rgb("gbrapf16be", depth=16, alpha=True, be=True, flt=True)
register(PixFmtDescriptor("gbrap32le", 4, 0, 0,
                          FLAG_PLANAR | FLAG_RGB | FLAG_ALPHA, (
    ComponentDesc(2, 4, 0, 0, 32), ComponentDesc(0, 4, 0, 0, 32),
    ComponentDesc(1, 4, 0, 0, 32), ComponentDesc(3, 4, 0, 0, 32))))
register(PixFmtDescriptor("gbrap32be", 4, 0, 0,
                          FLAG_PLANAR | FLAG_RGB | FLAG_ALPHA
                          | FLAG_BE, (
    ComponentDesc(2, 4, 0, 0, 32), ComponentDesc(0, 4, 0, 0, 32),
    ComponentDesc(1, 4, 0, 0, 32), ComponentDesc(3, 4, 0, 0, 32))))

# MSB-aligned planar variants (data in the top bits of 16-bit units)
for d in (10, 12):
    sh = 16 - d
    for base, fl in (("gbrp", FLAG_PLANAR | FLAG_RGB),
                     ("yuv444p", FLAG_PLANAR)):
        comp = (ComponentDesc(2 if base == "gbrp" else 0, 2, 0, sh, d),
                ComponentDesc(0 if base == "gbrp" else 1, 2, 0, sh, d),
                ComponentDesc(1 if base == "gbrp" else 2, 2, 0, sh, d))
        register(PixFmtDescriptor(f"{base}{d}msble", 3, 0, 0, fl,
                                  comp))
        register(PixFmtDescriptor(f"{base}{d}msbbe", 3, 0, 0,
                                  fl | FLAG_BE, comp))

# packed float / 32-bit RGB
for nm, order, sz, dep, fl in (
        ("rgbf16le", "rgb", 2, 16, FLAG_FLOAT),
        ("rgbf16be", "rgb", 2, 16, FLAG_FLOAT | FLAG_BE),
        ("rgbf32le", "rgb", 4, 32, FLAG_FLOAT),
        ("rgbf32be", "rgb", 4, 32, FLAG_FLOAT | FLAG_BE),
        ("rgbaf16le", "rgba", 2, 16, FLAG_FLOAT | FLAG_ALPHA),
        ("rgbaf16be", "rgba", 2, 16,
         FLAG_FLOAT | FLAG_ALPHA | FLAG_BE),
        ("rgbaf32le", "rgba", 4, 32, FLAG_FLOAT | FLAG_ALPHA),
        ("rgbaf32be", "rgba", 4, 32,
         FLAG_FLOAT | FLAG_ALPHA | FLAG_BE),
        ("rgb96le", "rgb", 4, 32, 0),
        ("rgb96be", "rgb", 4, 32, FLAG_BE),
        ("rgba128le", "rgba", 4, 32, FLAG_ALPHA),
        ("rgba128be", "rgba", 4, 32, FLAG_ALPHA | FLAG_BE)):
    n = len(order)
    step = sz * n
    comp = tuple(ComponentDesc(0, step, sz * i, 0, dep)
                 for i in range(n))
    register(PixFmtDescriptor(nm, n, 0, 0, FLAG_RGB | fl, comp))

# X2RGB10-style packed 10-bit in one 32-bit word
for nm, shifts, be in (("x2rgb10le", (20, 10, 0), False),
                       ("x2rgb10be", (20, 10, 0), True),
                       ("x2bgr10le", (0, 10, 20), False),
                       ("x2bgr10be", (0, 10, 20), True)):
    comp = tuple(ComponentDesc(0, 4, 0, sh, 10) for sh in shifts)
    register(PixFmtDescriptor(nm, 3, 0, 0,
                              FLAG_RGB | (FLAG_BE if be else 0),
                              comp))

# 1/4-bit RGB
register(PixFmtDescriptor("rgb4", 3, 0, 0, FLAG_RGB | FLAG_BITSTREAM,
                          (ComponentDesc(0, 4, 0, 3, 1),
                           ComponentDesc(0, 4, 0, 1, 2),
                           ComponentDesc(0, 4, 0, 0, 1))))
register(PixFmtDescriptor("bgr4", 3, 0, 0, FLAG_RGB | FLAG_BITSTREAM,
                          (ComponentDesc(0, 4, 0, 0, 1),
                           ComponentDesc(0, 4, 0, 1, 2),
                           ComponentDesc(0, 4, 0, 3, 1))))
register(PixFmtDescriptor("rgb4_byte", 3, 0, 0, FLAG_RGB,
                          (ComponentDesc(0, 1, 0, 3, 1),
                           ComponentDesc(0, 1, 0, 1, 2),
                           ComponentDesc(0, 1, 0, 0, 1))))
register(PixFmtDescriptor("bgr4_byte", 3, 0, 0, FLAG_RGB,
                          (ComponentDesc(0, 1, 0, 0, 1),
                           ComponentDesc(0, 1, 0, 1, 2),
                           ComponentDesc(0, 1, 0, 3, 1))))

# packed 4:4:4 YUV byte orders
register(PixFmtDescriptor("ayuv", 4, 0, 0, FLAG_ALPHA,
                          (ComponentDesc(0, 4, 1, 0, 8),
                           ComponentDesc(0, 4, 2, 0, 8),
                           ComponentDesc(0, 4, 3, 0, 8),
                           ComponentDesc(0, 4, 0, 0, 8))))
register(PixFmtDescriptor("ayuv64be", 4, 0, 0,
                          FLAG_ALPHA | FLAG_BE,
                          (ComponentDesc(0, 8, 2, 0, 16),
                           ComponentDesc(0, 8, 4, 0, 16),
                           ComponentDesc(0, 8, 6, 0, 16),
                           ComponentDesc(0, 8, 0, 0, 16))))
register(PixFmtDescriptor("uyva", 4, 0, 0, FLAG_ALPHA,
                          (ComponentDesc(0, 4, 1, 0, 8),
                           ComponentDesc(0, 4, 0, 0, 8),
                           ComponentDesc(0, 4, 2, 0, 8),
                           ComponentDesc(0, 4, 3, 0, 8))))
register(PixFmtDescriptor("vuyx", 3, 0, 0, 0,
                          (ComponentDesc(0, 4, 2, 0, 8),
                           ComponentDesc(0, 4, 1, 0, 8),
                           ComponentDesc(0, 4, 0, 0, 8))))
register(PixFmtDescriptor("vyu444", 3, 0, 0, 0,
                          (ComponentDesc(0, 3, 1, 0, 8),
                           ComponentDesc(0, 3, 0, 0, 8),
                           ComponentDesc(0, 3, 2, 0, 8))))

# packed 10/12/16-bit 4:2:2 / 4:4:4 big-endian counterparts + v30x
for nm in ("y210be", "y212be", "xv30be", "xv36be"):
    d0 = _REGISTRY[nm[:-2] + "le"]
    register(PixFmtDescriptor(nm, d0.nb_components, d0.log2_chroma_w,
                              d0.log2_chroma_h, d0.flags | FLAG_BE,
                              d0.comp))
register(PixFmtDescriptor("y216le", 3, 1, 0, 0,
                          (ComponentDesc(0, 4, 0, 0, 16),
                           ComponentDesc(0, 8, 2, 0, 16),
                           ComponentDesc(0, 8, 6, 0, 16))))
register(PixFmtDescriptor("y216be", 3, 1, 0, FLAG_BE,
                          (ComponentDesc(0, 4, 0, 0, 16),
                           ComponentDesc(0, 8, 2, 0, 16),
                           ComponentDesc(0, 8, 6, 0, 16))))
register(PixFmtDescriptor("v30xle", 3, 0, 0, 0,
                          (ComponentDesc(0, 4, 0, 12, 10),
                           ComponentDesc(0, 4, 0, 2, 10),
                           ComponentDesc(0, 4, 0, 22, 10))))
register(PixFmtDescriptor("v30xbe", 3, 0, 0, FLAG_BE,
                          (ComponentDesc(0, 4, 0, 12, 10),
                           ComponentDesc(0, 4, 0, 2, 10),
                           ComponentDesc(0, 4, 0, 22, 10))))
register(PixFmtDescriptor("xv48le", 3, 0, 0, 0,
                          (ComponentDesc(0, 8, 2, 0, 16),
                           ComponentDesc(0, 8, 0, 0, 16),
                           ComponentDesc(0, 8, 4, 0, 16))))
register(PixFmtDescriptor("xv48be", 3, 0, 0, FLAG_BE,
                          (ComponentDesc(0, 8, 2, 0, 16),
                           ComponentDesc(0, 8, 0, 0, 16),
                           ComponentDesc(0, 8, 4, 0, 16))))

# big-endian semiplanar counterparts + p212
_semiplanar("p212le", 1, 0, depth=12, shift=4)
for nm in ("p010be", "p012be", "p016be", "p210be", "p212be",
           "p216be", "p410be", "p412be", "p416be", "nv20be"):
    d0 = _REGISTRY[nm[:-2] + "le"]
    register(PixFmtDescriptor(nm, d0.nb_components, d0.log2_chroma_w,
                              d0.log2_chroma_h, d0.flags | FLAG_BE,
                              d0.comp))

# hardware surface placeholders (FLAG_HWACCEL, opaque)
for nm in ("vaapi", "cuda", "vulkan", "qsv", "vdpau", "drm_prime",
           "opencl", "d3d11", "d3d12", "d3d11va_vld", "dxva2_vld",
           "videotoolbox_vld", "mediacodec", "mmal", "amf",
           "cuarray", "ohcodec"):
    register(PixFmtDescriptor(nm, 0, 0, 0, FLAG_HWACCEL, ()))

_ALIASES.update({"rgbf32": "rgbf32le", "rgbaf32": "rgbaf32le",
                 "rgbf16": "rgbf16le", "rgbaf16": "rgbaf16le",
                 "gbrpf16": "gbrpf16le", "grayf16": "grayf16le",
                 "x2rgb10": "x2rgb10le", "x2bgr10": "x2bgr10le",
                 "y216": "y216le", "xv48": "xv48le",
                 "v30x": "v30xle", "p212": "p212le"})


# --- colorspace / range enums (pixfmt.h AVColorSpace etc.) -------------------

class ColorRange:
    UNSPECIFIED = "unspecified"
    MPEG = "tv"       # limited
    JPEG = "pc"       # full


class ColorSpace:
    RGB = "rgb"
    BT709 = "bt709"
    UNSPECIFIED = "unspecified"
    FCC = "fcc"
    BT470BG = "bt470bg"   # = BT601-625
    SMPTE170M = "smpte170m"  # = BT601-525
    SMPTE240M = "smpte240m"
    YCGCO = "ycgco"
    BT2020_NCL = "bt2020nc"
    BT2020_CL = "bt2020c"


class ColorPrimaries:
    BT709 = "bt709"
    UNSPECIFIED = "unspecified"
    BT470BG = "bt470bg"
    SMPTE170M = "smpte170m"
    BT2020 = "bt2020"
    SMPTE432 = "smpte432"  # P3 D65


class ColorTransfer:
    BT709 = "bt709"
    UNSPECIFIED = "unspecified"
    GAMMA22 = "gamma22"
    GAMMA28 = "gamma28"
    SMPTE170M = "smpte170m"
    LINEAR = "linear"
    SRGB = "iec61966-2-1"
    PQ = "smpte2084"
    HLG = "arib-std-b67"
