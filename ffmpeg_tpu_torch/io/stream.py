"""Stream & codec parameter containers (the port's copy of
ffmpeg_tpu/io/stream.py; analog of AVStream / AVCodecParameters,
libavformat/avformat.h + libavcodec/codec_par.h).

The fields are the reference's; `ch_layout` holds a
`formats.channel_layout.ChannelLayout`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..utils.rational import NOPTS, Rational


class MediaType:
    VIDEO = "video"
    AUDIO = "audio"
    SUBTITLE = "subtitle"
    DATA = "data"
    ATTACHMENT = "attachment"


@dataclass
class CodecParameters:
    codec_type: str = MediaType.DATA
    codec_id: str = "none"
    codec_tag: int = 0
    extradata: bytes = b""
    bit_rate: int = 0
    # video
    width: int = 0
    height: int = 0
    pix_fmt: Optional[str] = None
    sample_aspect_ratio: Rational = field(default_factory=lambda: Rational(0, 1))
    field_order: str = "progressive"
    color_range: str = "unspecified"
    color_space: str = "unspecified"
    color_primaries: str = "unspecified"
    color_trc: str = "unspecified"
    chroma_location: str = "unspecified"
    framerate: Rational = field(default_factory=lambda: Rational(0, 1))
    bits_per_coded_sample: int = 0
    bits_per_raw_sample: int = 0
    # HDR static metadata (AVMasteringDisplayMetadata /
    # AVContentLightMetadata analogs): dicts or None
    mastering_display: Optional[dict] = None
    content_light: Optional[dict] = None
    # audio
    sample_rate: int = 0
    sample_fmt: Optional[str] = None
    ch_layout: Optional[Any] = None
    frame_size: int = 0
    block_align: int = 0

    @property
    def channels(self) -> int:
        return self.ch_layout.nb_channels if self.ch_layout else 0

    def copy(self) -> "CodecParameters":
        import copy
        return copy.copy(self)


@dataclass
class StreamInfo:
    index: int = 0
    id: int = 0
    codecpar: CodecParameters = field(default_factory=CodecParameters)
    time_base: Rational = field(default_factory=lambda: Rational(1, 90000))
    start_time: int = NOPTS
    duration: int = NOPTS
    nb_frames: int = 0
    avg_frame_rate: Rational = field(default_factory=lambda: Rational(0, 1))
    r_frame_rate: Rational = field(default_factory=lambda: Rational(0, 1))
    metadata: Dict[str, str] = field(default_factory=dict)
    disposition: int = 0
    # demuxer-internal
    priv: Any = None

    @property
    def codec_type(self) -> str:
        return self.codecpar.codec_type
