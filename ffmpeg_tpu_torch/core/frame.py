"""Frame — the media frame container (the port's copy of
ffmpeg_tpu/core/frame.py; analog of AVFrame, libavutil/frame.h:472).

Video planes are per component (Y, U, V[, A] or R, G, B[, A]), each
(h_c, w_c), or (N, h_c, w_c) for a batch of frames.  Decoders and filters
put torch tensors on their device there; a caller may hand in numpy
planes, which the scaler and the filter graph move to their device once.
Nothing moves a video plane to the host except where the caller asks:
`numpy()` and `to_bytes()`.

Audio planes are per channel, each (nb_samples,), host numpy arrays as
the reference's are: its windowing, overlap-add, rematrix and dither all
run on the host, and the device stages (the IMDCT, the resampler's FIR)
copy their inputs to the card and their results back.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..formats import pixfmt as _pf
from ..formats import samplefmt as _sf
from ..formats.channel_layout import ChannelLayout, default_layout
from ..utils.error import InvalidData
from ..utils.rational import NOPTS, Rational
from . import imgutils


def host_array(plane) -> np.ndarray:
    """A plane as a host numpy array: a tensor is copied off its device
    (the one explicit device-to-host move), anything else goes through
    np.asarray."""
    if isinstance(plane, torch.Tensor):
        return plane.detach().cpu().numpy()
    return np.asarray(plane)


def on_device(t: torch.Tensor, device: torch.device) -> bool:
    """Whether `t` lies on `device` ("cuda" with no index takes any
    card)."""
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


def device_planes(planes, device: torch.device | str) -> List[torch.Tensor]:
    """Planes as tensors on `device`: numpy planes are copied there once,
    tensors already there are passed as they are, and a tensor on another
    device raises InvalidData: it is never moved silently."""
    device = torch.device(device)
    out = []
    for p in planes:
        if isinstance(p, torch.Tensor):
            if not on_device(p, device):
                raise InvalidData(f"plane on {p.device}, expected {device}")
            out.append(p)
        else:
            a = np.ascontiguousarray(p)
            if not a.flags.writeable:      # torch refuses read-only views
                a = a.copy()
            out.append(torch.as_tensor(a, device=device))
    return out


@dataclass
class Frame:
    pts: int = NOPTS
    duration: int = 0
    time_base: Rational = field(default_factory=lambda: Rational(0, 1))
    side_data: Dict[str, Any] = field(default_factory=dict)
    opaque: Any = None
    key_frame: bool = True
    pict_type: str = "?"      # I/P/B/S/i/b/?

    width: int = 0
    height: int = 0
    format: Optional[str] = None            # pix_fmt name
    sample_aspect_ratio: Rational = field(
        default_factory=lambda: Rational(0, 1))
    color_range: str = "unspecified"
    color_space: str = "unspecified"
    color_primaries: str = "unspecified"
    color_trc: str = "unspecified"
    chroma_location: str = "left"
    interlaced: bool = False
    top_field_first: bool = False

    # audio
    sample_rate: int = 0
    nb_samples: int = 0
    ch_layout: Optional[ChannelLayout] = None

    planes: List[Any] = field(default_factory=list)

    @property
    def is_video(self) -> bool:
        return self.width > 0 and self.height > 0

    @property
    def is_audio(self) -> bool:
        return self.nb_samples > 0 or (self.sample_rate > 0
                                       and not self.is_video)

    @staticmethod
    def video(width: int, height: int, fmt: str, planes, **kw) -> "Frame":
        """A video frame of the given planes; the format name is
        normalised through the pixel-format registry."""
        f = Frame(width=width, height=height, format=str(_pf.get(fmt).name),
                  **kw)
        f.planes = list(planes)
        return f

    @staticmethod
    def from_bytes(buf: bytes, fmt: str, width: int, height: int,
                   device: torch.device | str = "cuda", **kw) -> "Frame":
        """Raw picture bytes (host) → a frame whose planes are tensors on
        `device`."""
        comps = imgutils.unpack(buf, fmt, width, height)
        return Frame.video(width, height, fmt,
                           planes=device_planes(comps, device), **kw)

    def to_bytes(self) -> bytes:
        """The planes copied to the host and packed as raw picture bytes."""
        comps = [host_array(p) for p in self.planes]
        return imgutils.pack(comps, self.format, self.width, self.height)

    @staticmethod
    def audio(data, sample_rate: int, fmt: str = "fltp",
              ch_layout: Optional[ChannelLayout] = None, **kw) -> "Frame":
        """data: (channels, nb_samples), numpy or a tensor (copied to the
        host); the planes are host numpy arrays."""
        data = np.atleast_2d(host_array(data))
        ch, n = data.shape
        return Frame(
            sample_rate=sample_rate, nb_samples=n,
            ch_layout=ch_layout or default_layout(ch),
            format=_sf.get(fmt).name,
            planes=[data[c] for c in range(ch)], **kw)

    @property
    def audio_data(self) -> np.ndarray:
        """(channels, nb_samples) host array of the audio planes; tensor
        planes are copied to the host."""
        return np.stack([host_array(p) for p in self.planes])

    @property
    def pix_desc(self) -> Optional[_pf.PixFmtDescriptor]:
        if self.is_video and self.format:
            return _pf.get(self.format)
        return None

    def numpy(self) -> "Frame":
        """A copy of the frame with every plane moved to the host as
        numpy."""
        f = self.clone_props()
        f.planes = [host_array(p) for p in self.planes]
        desc = self.pix_desc
        if desc is not None and desc.component_dtype() == np.uint16:
            # 10-16 bit planes live on the device as int16 (torch has no
            # general uint16); the host gets the format's type
            f.planes = [a.astype(np.uint16) if a.dtype == np.int16 else a
                        for a in f.planes]
        return f

    def clone_props(self) -> "Frame":
        """Copy metadata, share plane references (av_frame_ref analog)."""
        f = replace(self)
        f.planes = list(self.planes)
        f.side_data = dict(self.side_data)
        return f

    def best_effort_pts_seconds(self) -> Optional[float]:
        if self.pts == NOPTS or not self.time_base:
            return None
        return self.pts * self.time_base.num / self.time_base.den

    def __repr__(self) -> str:  # pragma: no cover
        if self.is_video:
            return (f"<Frame video {self.width}x{self.height} "
                    f"{self.format} pts={self.pts}>")
        return (f"<Frame audio {self.nb_samples}s@{self.sample_rate} "
                f"{self.format} pts={self.pts}>")
