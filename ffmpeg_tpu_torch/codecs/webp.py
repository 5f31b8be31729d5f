"""WebP decoder (reference: libavcodec/webp.c).

Lossy WebP is a VP8 intra frame in a RIFF container (decoded with
codecs/vp8); VP8X extended files are unwrapped (EXIF/ICC/XMP chunks
skipped). Lossless (VP8L) and alpha land separately.

The port's copy of ffmpeg_tpu/codecs/webp.py, held equal to it by
tests/test_torch_vp8_webp.py.
The decoder puts each picture on the device it is opened on with one
upload (device_planes); the encoder copies a frame's planes to the
host once (Frame.numpy).
"""

from __future__ import annotations

import struct
from typing import List, Optional

from ..core.frame import Frame, device_planes
from ..core.packet import Packet
from ..io.stream import MediaType
from ..utils.error import InvalidData, NotSupported
from ..utils.rational import Rational
from .codec import DeviceCodec, register_decoder, register_encoder
from .vp8 import VP8Core


def parse_riff(data: bytes):
    """→ list of (fourcc, payload) chunks inside RIFF/WEBP."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise InvalidData("webp: not a RIFF/WEBP file")
    pos = 12
    out = []
    while pos + 8 <= len(data):
        fourcc = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        payload = data[pos + 8:pos + 8 + size]
        out.append((fourcc, payload))
        pos += 8 + size + (size & 1)
    return out


@register_decoder
class WebPDecoder(DeviceCodec):
    codec_id = "webp"
    codec_type = MediaType.VIDEO

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        chunks = parse_riff(bytes(pkt.data))
        vp8_data = vp8l_data = None
        for fourcc, payload in chunks:
            if fourcc == b"VP8 ":
                vp8_data = payload
            elif fourcc == b"VP8L":
                vp8l_data = payload
            elif fourcc == b"ALPH":
                raise NotSupported("webp: alpha channel")
        if vp8l_data is not None:
            from .webp_vp8l import decode_vp8l
            W, H, argb = decode_vp8l(vp8l_data)
            f = Frame.video(
                W, H, "argb",
                planes=device_planes([argb.reshape(H, W * 4).copy()],
                                     self.device),
                pts=pkt.pts if pkt.pts is not None else 0,
                time_base=pkt.time_base or Rational(1, 25))
            f.key_frame = True
            return [f]
        if vp8_data is None:
            raise InvalidData("webp: no image chunk")
        h, fs = VP8Core().decode_frame(vp8_data)
        W, H = h.width, h.height
        f = Frame.video(W, H, "yuv420p",
                        planes=device_planes([
                            fs.y[:H, :W].copy(),
                            fs.u[:(H + 1) >> 1, :(W + 1) >> 1].copy(),
                            fs.v[:(H + 1) >> 1, :(W + 1) >> 1].copy()],
                            self.device),
                        pts=pkt.pts if pkt.pts is not None else 0,
                        time_base=pkt.time_base or Rational(1, 25))
        f.key_frame = True
        return [f]


@register_encoder
class WebPEncoder(DeviceCodec):
    """Lossless WebP (VP8L) encoder for argb/rgba/rgb24 frames."""

    codec_id = "webp"
    codec_type = MediaType.VIDEO
    is_encoder = True

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        import numpy as np
        from ..formats import pixfmt as _pf
        from .webp_vp8l_enc import encode_vp8l, wrap_webp_lossless
        fmt = _pf.get(frame.format).name
        w, h = frame.width, frame.height
        raw = np.frombuffer(frame.numpy().to_bytes(), np.uint8)
        if fmt == "argb":
            argb = raw.reshape(h, w, 4)
        elif fmt == "rgba":
            px = raw.reshape(h, w, 4)
            argb = px[:, :, [3, 0, 1, 2]]
        elif fmt == "rgb24":
            px = raw.reshape(h, w, 3)
            argb = np.concatenate(
                [np.full((h, w, 1), 255, np.uint8), px], -1)
        else:
            raise NotSupported(f"webp enc: pix_fmt {fmt}")
        payload = wrap_webp_lossless(
            encode_vp8l(np.ascontiguousarray(argb),
                        subtract_green=True))
        return [Packet(data=payload, pts=frame.pts, dts=frame.pts,
                       stream_index=0, time_base=frame.time_base)]


def wrap_webp(vp8_frame: bytes) -> bytes:
    """Wrap a VP8 keyframe into a minimal lossy .webp file."""
    chunk = b"VP8 " + struct.pack("<I", len(vp8_frame)) + vp8_frame
    if len(vp8_frame) & 1:
        chunk += b"\x00"
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + \
        chunk
