"""Frame — the video frame container (the port's copy of the video half of
ffmpeg_tpu/core/frame.py; analog of AVFrame, libavutil/frame.h:472).

Planes are per component (Y, U, V[, A] or R, G, B[, A]), each (h_c, w_c)
numpy arrays on the host.  The audio half comes with the audio slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional

from ..formats import pixfmt as _pf
from ..utils.rational import NOPTS, Rational


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

    planes: List[Any] = field(default_factory=list)

    @staticmethod
    def video(width: int, height: int, fmt: str, planes, **kw) -> "Frame":
        """A video frame of the given planes; the format name is
        normalised through the pixel-format registry."""
        f = Frame(width=width, height=height, format=str(_pf.get(fmt).name),
                  **kw)
        f.planes = list(planes)
        return f

    def clone_props(self) -> "Frame":
        """Copy metadata, share plane references (av_frame_ref analog)."""
        f = replace(self)
        f.planes = list(self.planes)
        f.side_data = dict(self.side_data)
        return f

    def __repr__(self) -> str:  # pragma: no cover
        return (f"<Frame video {self.width}x{self.height} {self.format} "
                f"pts={self.pts}>")
