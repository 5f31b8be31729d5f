"""Packet — compressed data unit (the port's copy of
ffmpeg_tpu/core/packet.py; analog of AVPacket, libavcodec/packet.h)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

from ..utils.rational import NOPTS, Rational

# flags — match AV_PKT_FLAG_*
PKT_FLAG_KEY = 0x0001
PKT_FLAG_CORRUPT = 0x0002
PKT_FLAG_DISCARD = 0x0004


@dataclass
class Packet:
    data: bytes = b""
    pts: int = NOPTS
    dts: int = NOPTS
    duration: int = 0
    pos: int = -1
    stream_index: int = 0
    flags: int = 0
    time_base: Rational = field(default_factory=lambda: Rational(0, 1))
    side_data: Dict[str, Any] = field(default_factory=dict)
    opaque: Any = None

    @property
    def is_keyframe(self) -> bool:
        return bool(self.flags & PKT_FLAG_KEY)

    @property
    def size(self) -> int:
        return len(self.data)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"<Packet stream={self.stream_index} size={self.size} "
                f"pts={self.pts} dts={self.dts}"
                f"{' K' if self.is_keyframe else ''}>")
