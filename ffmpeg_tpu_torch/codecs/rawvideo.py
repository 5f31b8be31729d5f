"""rawvideo decoder/encoder (libavcodec/rawdec.c / rawenc.c).

The port's copy of ffmpeg_tpu/codecs/rawvideo.py, held equal to it by
tests/test_torch_io_formats.py.  The decoder makes the one upload of a
raw picture, to the device it is opened on (Frame.from_bytes); the
encoder makes the one device-to-host copy of a video frame
(Frame.numpy().to_bytes()).
"""

from __future__ import annotations

from typing import List, Optional

from ..core.frame import Frame
from ..core.packet import Packet, PKT_FLAG_KEY
from ..io.stream import MediaType
from ..utils.error import InvalidData
from .codec import DeviceCodec, register_decoder, register_encoder


@register_decoder
class RawVideoDecoder(DeviceCodec):
    codec_id = "rawvideo"
    codec_type = MediaType.VIDEO

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None:
            return []
        p = self.par
        if not p.width or not p.pix_fmt:
            raise InvalidData("rawvideo: missing dimensions/pix_fmt")
        f = Frame.from_bytes(pkt.data, p.pix_fmt, p.width, p.height,
                             device=self.device, pts=pkt.pts,
                             duration=pkt.duration, time_base=pkt.time_base)
        f.sample_aspect_ratio = p.sample_aspect_ratio
        f.color_range = p.color_range if p.color_range != "unspecified" else f.color_range
        f.color_space = p.color_space
        f.chroma_location = p.chroma_location if p.chroma_location != "unspecified" else f.chroma_location
        return [f]


@register_encoder
class RawVideoEncoder(DeviceCodec):
    codec_id = "rawvideo"
    codec_type = MediaType.VIDEO
    is_encoder = True

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        return [Packet(data=frame.numpy().to_bytes(), pts=frame.pts,
                       dts=frame.pts, duration=frame.duration,
                       flags=PKT_FLAG_KEY, time_base=frame.time_base)]


@register_decoder
class WrappedFrameDecoder(DeviceCodec):
    """wrapped_avframe analog: packets whose payload IS a Frame object."""

    codec_id = "wrapped_frame"
    codec_type = MediaType.VIDEO

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None:
            return []
        if not isinstance(pkt.opaque, Frame):
            raise InvalidData("wrapped_frame packet without Frame payload")
        return [pkt.opaque]
