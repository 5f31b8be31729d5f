"""Raw MJPEG stream demuxer + image2 (file-pattern) demuxer/muxer
(analogs of libavformat/rawdec.c mjpeg_demuxer and img2dec.c/img2enc.c).

The port's copy of ffmpeg_tpu/io/formats/img_mjpeg.py, held equal to it
by tests/test_torch_io_formats.py.
"""

from __future__ import annotations

import glob
import os
import re

from ...core.packet import Packet, PKT_FLAG_KEY
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from .. import avio
from ..demux import Demuxer, register_demuxer
from ..mux import Muxer, register_muxer
from ..stream import CodecParameters, MediaType


@register_demuxer
class MjpegDemuxer(Demuxer):
    """Concatenated JPEG images → one packet per SOI..EOI span."""

    name = "mjpeg"
    extensions = ("mjpg", "mjpeg", "jpg", "jpeg")
    framerate = Rational(25, 1)

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        if head[:2] == b"\xFF\xD8" and head[2:3] == b"\xFF":
            # APPn/DQT right after SOI → JPEG
            return 50
        return 0

    def read_header(self) -> None:
        rate = self.framerate if isinstance(self.framerate, Rational) else \
            Rational(int(self.framerate), 1)
        par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="mjpeg",
                              framerate=rate)
        self.add_stream(codecpar=par, time_base=rate.inv())
        self._pts = 0
        self._buf = b""

    def read_packet(self) -> Packet:
        # accumulate until EOI marker (FFD9) outside entropy stuffing
        while True:
            idx = self._find_eoi(self._buf)
            if idx >= 0:
                data, self._buf = self._buf[:idx + 2], self._buf[idx + 2:]
                if len(data) > 4:
                    pkt = Packet(data=data, pts=self._pts, dts=self._pts,
                                 duration=1, flags=PKT_FLAG_KEY,
                                 time_base=self.streams[0].time_base)
                    self._pts += 1
                    return pkt
                continue
            chunk = self.r.read(1 << 16)
            if not chunk:
                if self._buf.strip(b"\x00"):
                    raise EndOfStream("trailing garbage")
                raise EndOfStream()
            self._buf += chunk

    @staticmethod
    def _find_eoi(buf: bytes) -> int:
        i = 0
        while True:
            i = buf.find(b"\xFF\xD9", i)
            if i < 0:
                return -1
            return i


@register_demuxer
class Image2Demuxer(Demuxer):
    """File-pattern image sequence (img-%03d.jpg) or single image."""

    name = "image2"
    extensions = ()
    framerate = Rational(25, 1)
    pattern_type = "auto"
    flags_no_file = True

    _CODEC_BY_EXT = {"jpg": "mjpeg", "jpeg": "mjpeg", "png": "png",
                     "bmp": "bmp", "ppm": "ppm", "pgm": "pgm",
                     "tif": "tiff", "tiff": "tiff", "webp": "webp",
                     "exr": "exr", "qoi": "qoi"}

    def __init__(self, r, url=""):
        super().__init__(r, url)
        self._files = []
        self._idx = 0

    def read_header(self) -> None:
        url = self.url
        if "%" in url:
            rx = re.sub(r"%0?(\d*)d", r"(\\d+)", os.path.basename(url))
            d = os.path.dirname(url) or "."
            files = sorted(f for f in os.listdir(d)
                           if re.fullmatch(rx, f))
            self._files = [os.path.join(d, f) for f in files]
        elif "*" in url:
            self._files = sorted(glob.glob(url))
        else:
            self._files = [url]
        if not self._files:
            raise InvalidData(f"image2: no files match {url!r}")
        ext = self._files[0].rsplit(".", 1)[-1].lower()
        codec = self._CODEC_BY_EXT.get(ext, "mjpeg")
        rate = self.framerate if isinstance(self.framerate, Rational) else \
            Rational(int(self.framerate), 1)
        par = CodecParameters(codec_type=MediaType.VIDEO, codec_id=codec,
                              framerate=rate)
        self.add_stream(codecpar=par, time_base=rate.inv())
        self._pts = 0

    def read_packet(self) -> Packet:
        if self._idx >= len(self._files):
            raise EndOfStream()
        with open(self._files[self._idx], "rb") as f:
            data = f.read()
        self._idx += 1
        pkt = Packet(data=data, pts=self._pts, dts=self._pts, duration=1,
                     flags=PKT_FLAG_KEY, time_base=self.streams[0].time_base)
        self._pts += 1
        return pkt


@register_demuxer
class ImagePipeDemuxer(Demuxer):
    """Single-image signature-probed input (img2dec.c *_pipe
    demuxers): png/bmp/ppm/pgm files open without -f image2."""

    name = "image_pipe"
    extensions = ("png", "bmp", "ppm", "pgm", "qoi", "tif", "tiff")

    _SIGS = ((b"\x89PNG\r\n\x1a\n", "png"), (b"BM", "bmp"),
             (b"P6", "ppm"), (b"P5", "pgm"), (b"qoif", "qoi"),
             (b"II*\x00", "tiff"), (b"MM\x00*", "tiff"))

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        for sig, _ in cls._SIGS:
            if head[:len(sig)] == sig:
                return 60
        return 0

    def read_header(self) -> None:
        head = self.r.read(8)
        self.r.seek(0)
        codec = "png"
        for sig, cid in self._SIGS:
            if head[:len(sig)] == sig:
                codec = cid
                break
        par = CodecParameters(codec_type=MediaType.VIDEO,
                              codec_id=codec,
                              framerate=Rational(25, 1))
        self.add_stream(codecpar=par, time_base=Rational(1, 25))
        self._done = False

    def read_packet(self) -> Packet:
        if self._done:
            raise EndOfStream()
        data = self.r.read(1 << 30)
        self._done = True
        return Packet(data=data, stream_index=0, pts=0, dts=0,
                      duration=1, flags=PKT_FLAG_KEY,
                      time_base=self.streams[0].time_base)


@register_muxer
class Image2Muxer(Muxer):
    """Writes each packet as its own file (img-%03d.jpg patterns)."""

    name = "image2"
    extensions = ("jpg", "jpeg", "png", "bmp", "ppm", "pgm", "qoi",
                  "tif", "tiff")
    default_video_codec = "mjpeg"
    interleave = False
    flags_no_file = True

    def _write_header(self) -> None:
        self._count = 0

    def _write_packet(self, pkt: Packet) -> None:
        url = self.url
        if "%" in url:
            path = url % (self._count + 1)
        elif self._count == 0:
            path = url
        else:
            raise InvalidData("image2: multiple frames need a %d pattern")
        with open(path, "wb") as f:
            f.write(pkt.data)
        self._count += 1


@register_muxer
class MjpegMuxer(Muxer):
    name = "mjpeg"
    extensions = ("mjpg", "mjpeg")
    default_video_codec = "mjpeg"
    interleave = False

    def _write_header(self) -> None:
        pass

    def _write_packet(self, pkt: Packet) -> None:
        self.w.write(pkt.data)


@register_demuxer
class MpegVideoDemuxer(Demuxer):
    """Raw MPEG-1/2 elementary stream (libavformat/mpegvideodec.c analog):
    one packet per coded picture (split on picture start codes)."""

    name = "mpegvideo"
    extensions = ("m1v", "m2v", "mpg", "mpgv")
    framerate = Rational(25, 1)

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        # sequence header start code at buffer head
        return 60 if head[:4] == b"\x00\x00\x01\xb3" else 0

    def read_header(self) -> None:
        rate = self.framerate if isinstance(self.framerate, Rational) else \
            Rational(int(self.framerate), 1)
        par = CodecParameters(codec_type=MediaType.VIDEO,
                              codec_id="mpeg2video", framerate=rate)
        self.add_stream(codecpar=par, time_base=rate.inv())
        self._buf = b""
        self._pts = 0

    def read_packet(self) -> Packet:
        while True:
            # find the second picture start code; emit everything before it
            first = self._buf.find(b"\x00\x00\x01\x00")
            if first >= 0:
                nxt = self._buf.find(b"\x00\x00\x01\x00", first + 4)
                if nxt >= 0:
                    # back up over any headers (seq/gop) preceding next pic
                    cut = nxt
                    for code in (b"\x00\x00\x01\xb3", b"\x00\x00\x01\xb8"):
                        k = self._buf.rfind(code, first + 4, nxt)
                        if k >= 0:
                            cut = min(cut, k)
                    data, self._buf = self._buf[:cut], self._buf[cut:]
                    pkt = Packet(data=data, pts=self._pts, dts=self._pts,
                                 duration=1, flags=PKT_FLAG_KEY,
                                 time_base=self.streams[0].time_base)
                    self._pts += 1
                    return pkt
            chunk = self.r.read(1 << 16)
            if not chunk:
                if self._buf.strip(b"\x00"):
                    data, self._buf = self._buf, b""
                    pkt = Packet(data=data, pts=self._pts, dts=self._pts,
                                 duration=1, flags=PKT_FLAG_KEY,
                                 time_base=self.streams[0].time_base)
                    self._pts += 1
                    return pkt
                raise EndOfStream()
            self._buf += chunk
