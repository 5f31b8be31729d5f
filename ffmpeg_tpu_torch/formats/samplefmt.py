"""Audio sample formats (the port's copy of ffmpeg_tpu/formats/samplefmt.py;
analog of libavutil/samplefmt.{c,h}).

Audio planes are host numpy arrays; these descriptors drive the host-side
pack/unpack for I/O, codecs and the resampler.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from ..utils.error import InvalidData


@dataclass(frozen=True)
class SampleFmtDescriptor:
    name: str
    dtype: np.dtype
    planar: bool
    bits: int

    @property
    def bytes_per_sample(self) -> int:
        return self.dtype.itemsize

    @property
    def packed_alt(self) -> str:
        return self.name.rstrip("p") if self.planar else self.name

    @property
    def planar_alt(self) -> str:
        return self.name if self.planar else self.name + "p"


_REGISTRY: Dict[str, SampleFmtDescriptor] = {}


def _reg(name, dtype, planar, bits):
    _REGISTRY[name] = SampleFmtDescriptor(name, np.dtype(dtype), planar, bits)


_reg("u8", np.uint8, False, 8)
_reg("s16", np.int16, False, 16)
_reg("s32", np.int32, False, 32)
_reg("s64", np.int64, False, 64)
_reg("flt", np.float32, False, 32)
_reg("dbl", np.float64, False, 64)
_reg("u8p", np.uint8, True, 8)
_reg("s16p", np.int16, True, 16)
_reg("s32p", np.int32, True, 32)
_reg("s64p", np.int64, True, 64)
_reg("fltp", np.float32, True, 32)
_reg("dblp", np.float64, True, 64)


def get(name) -> SampleFmtDescriptor:
    if isinstance(name, SampleFmtDescriptor):
        return name
    d = _REGISTRY.get(str(name))
    if d is None:
        raise InvalidData(f"unknown sample format {name!r}")
    return d


def all_formats() -> Dict[str, SampleFmtDescriptor]:
    return dict(_REGISTRY)


def to_float(x: np.ndarray, fmt) -> np.ndarray:
    """Convert integer PCM to float32 in [-1, 1) (audioconvert.c scaling)."""
    d = get(fmt)
    if d.dtype.kind == "f":
        return x.astype(np.float32)
    if d.name.startswith("u8"):
        return (x.astype(np.float32) - 128.0) / 128.0
    scale = float(1 << (d.bits - 1))
    return x.astype(np.float32) / scale


def from_float(x: np.ndarray, fmt) -> np.ndarray:
    """float32 [-1,1) → target integer format with clipping + rounding."""
    d = get(fmt)
    if d.dtype.kind == "f":
        return x.astype(d.dtype)
    if d.name.startswith("u8"):
        y = np.clip(np.rint(x * 128.0 + 128.0), 0, 255)
        return y.astype(np.uint8)
    scale = float(1 << (d.bits - 1))
    y = np.clip(np.rint(x * scale), -scale, scale - 1)
    return y.astype(d.dtype)
