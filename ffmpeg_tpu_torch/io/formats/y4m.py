"""YUV4MPEG2 (.y4m) demuxer + muxer (analog of libavformat/yuv4mpegdec.c /
yuv4mpegenc.c) — the raw-video interchange format FATE leans on.

The port's copy of ffmpeg_tpu/io/formats/y4m.py, held equal to it by
tests/test_torch_io_formats.py.
"""

from __future__ import annotations

from ...core.imgutils import image_buffer_size
from ...core.packet import Packet, PKT_FLAG_KEY
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from ..demux import Demuxer, register_demuxer, PROBE_SCORE_MAX
from ..mux import Muxer, register_muxer
from ..stream import CodecParameters, MediaType

_C_TO_PIXFMT = {
    "420jpeg": ("yuv420p", "center"), "420mpeg2": ("yuv420p", "left"),
    "420paldv": ("yuv420p", "topleft"), "420": ("yuv420p", "left"),
    "411": ("yuv411p", "left"), "422": ("yuv422p", "left"),
    "444": ("yuv444p", "left"), "444alpha": ("yuva444p", "left"),
    "mono": ("gray", "left"), "mono16": ("gray16le", "left"),
    "420p10": ("yuv420p10le", "left"), "422p10": ("yuv422p10le", "left"),
    "444p10": ("yuv444p10le", "left"),
    "420p12": ("yuv420p12le", "left"), "422p12": ("yuv422p12le", "left"),
    "444p12": ("yuv444p12le", "left"),
    "420p16": ("yuv420p16le", "left"), "444p16": ("yuv444p16le", "left"),
}
_PIXFMT_TO_C = {
    "yuv420p": "420mpeg2", "yuv422p": "422", "yuv444p": "444",
    "yuv411p": "411", "gray": "mono", "gray16le": "mono16",
    "yuva444p": "444alpha",
    "yuv420p10le": "420p10", "yuv422p10le": "422p10", "yuv444p10le": "444p10",
    "yuv420p12le": "420p12", "yuv420p16le": "420p16",
}


@register_demuxer
class Y4MDemuxer(Demuxer):
    name = "yuv4mpegpipe"
    long_name = "YUV4MPEG pipe"
    extensions = ("y4m",)

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        return PROBE_SCORE_MAX if head.startswith(b"YUV4MPEG2 ") else 0

    def read_header(self) -> None:
        line = self._read_line()
        if not line.startswith(b"YUV4MPEG2"):
            raise InvalidData("not y4m")
        w = h = 0
        rate = Rational(25, 1)
        sar = Rational(0, 1)
        pix = "yuv420p"
        loc = "left"
        interlace = "p"
        for tok in line.split()[1:]:
            c, v = chr(tok[0]), tok[1:].decode()
            if c == "W":
                w = int(v)
            elif c == "H":
                h = int(v)
            elif c == "F":
                n, d = v.split(":")
                rate = Rational(int(n), int(d))
            elif c == "A":
                n, d = v.split(":")
                sar = Rational(int(n), int(d))
            elif c == "C":
                if v not in _C_TO_PIXFMT:
                    raise InvalidData(f"y4m: unknown colorspace {v}")
                pix, loc = _C_TO_PIXFMT[v]
            elif c == "I":
                interlace = v
        if not w or not h:
            raise InvalidData("y4m: missing dimensions")
        par = CodecParameters(
            codec_type=MediaType.VIDEO, codec_id="rawvideo",
            width=w, height=h, pix_fmt=pix, framerate=rate,
            sample_aspect_ratio=sar, chroma_location=loc)
        st = self.add_stream(codecpar=par, time_base=rate.inv())
        st.avg_frame_rate = rate
        self._frame_size = image_buffer_size(pix, w, h)
        self._pts = 0

    def _read_line(self) -> bytes:
        out = bytearray()
        while True:
            b = self.r.read(1)
            if not b:
                raise EndOfStream()
            if b == b"\n":
                return bytes(out)
            out += b
            if len(out) > 512:
                raise InvalidData("y4m: header line too long")

    def read_packet(self) -> Packet:
        if self.r.at_eof():
            raise EndOfStream()
        line = self._read_line()
        if not line.startswith(b"FRAME"):
            raise InvalidData("y4m: bad FRAME marker")
        data = self.r.read_exact(self._frame_size)
        pkt = Packet(data=data, pts=self._pts, dts=self._pts, duration=1,
                     stream_index=0, flags=PKT_FLAG_KEY,
                     time_base=self.streams[0].time_base)
        self._pts += 1
        return pkt


@register_muxer
class Y4MMuxer(Muxer):
    name = "yuv4mpegpipe"
    extensions = ("y4m",)
    default_video_codec = "rawvideo"

    def _write_header(self) -> None:
        if len(self.streams) != 1 or self.streams[0].codec_type != MediaType.VIDEO:
            raise InvalidData("y4m: exactly one rawvideo stream required")
        par = self.streams[0].codecpar
        if par.pix_fmt not in _PIXFMT_TO_C:
            raise InvalidData(f"y4m: unsupported pix_fmt {par.pix_fmt}")
        rate = par.framerate if par.framerate else self.streams[0].time_base.inv()
        sar = par.sample_aspect_ratio
        hdr = f"YUV4MPEG2 W{par.width} H{par.height} F{rate.num}:{rate.den} Ip" \
              f" A{sar.num}:{sar.den} C{_PIXFMT_TO_C[par.pix_fmt]}\n"
        self.w.write(hdr.encode())

    def _write_packet(self, pkt: Packet) -> None:
        self.w.write(b"FRAME\n")
        self.w.write(pkt.data)
