"""GIF container (reference: libavformat/gifdec.c demuxer + gif.c muxer).

Demuxer: extradata = header + logical screen descriptor + GCT; each packet
carries one frame's GCE + image descriptor + LZW sub-blocks, with pts in a
1/100 s time base accumulated from GCE delays.  Muxer: writes the header,
NETSCAPE loop extension, the encoder's packets verbatim, and the trailer.

The port's copy of ffmpeg_tpu/io/formats/gif.py, held equal to it by
tests/test_torch_host_codecs.py.
"""

from __future__ import annotations

import struct
from typing import Optional

from ...core.packet import Packet, PKT_FLAG_KEY
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from ..demux import Demuxer, register_demuxer, PROBE_SCORE_MAX
from ..mux import Muxer, register_muxer
from ..stream import CodecParameters, MediaType


def _skip_subblocks(buf: bytes, pos: int) -> int:
    while pos < len(buf):
        sz = buf[pos]
        pos += 1
        if sz == 0:
            break
        pos += sz
    return pos


@register_demuxer
class GifDemuxer(Demuxer):
    name = "gif"
    extensions = ("gif",)

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        if head[:6] in (b"GIF87a", b"GIF89a"):
            return PROBE_SCORE_MAX
        return 0

    def read_header(self) -> None:
        chunks = []
        while not self.r.at_eof():
            b = self.r.read(1 << 20)
            if not b:
                break
            chunks.append(b)
        self._buf = b"".join(chunks)
        if self._buf[:6] not in (b"GIF87a", b"GIF89a"):
            raise InvalidData("gif: bad signature")
        w, h = struct.unpack("<HH", self._buf[6:10])
        flags = self._buf[10]
        pos = 13
        if flags & 0x80:
            pos += 3 * (2 << (flags & 7))
        par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="gif",
                              width=w, height=h,
                              extradata=self._buf[:pos])
        self.add_stream(codecpar=par, time_base=Rational(1, 100))
        self._pos = pos
        self._pts = 0

    def read_packet(self) -> Packet:
        buf = self._buf
        pos = self._pos
        start = pos
        delay = 0
        while pos < len(buf):
            b = buf[pos]
            if b == 0x21:                          # extension
                label = buf[pos + 1] if pos + 1 < len(buf) else 0
                if label == 0xF9 and pos + 5 < len(buf):
                    delay = struct.unpack("<H", buf[pos + 4:pos + 6])[0]
                    pos = _skip_subblocks(buf, pos + 2)
                elif label == 0xFF:                # application (loop) — skip
                    nxt = _skip_subblocks(buf, pos + 2)
                    if pos == start:
                        start = nxt
                    pos = nxt
                else:
                    pos = _skip_subblocks(buf, pos + 2)
            elif b == 0x2C:                        # image descriptor
                flags = buf[pos + 9]
                pos += 10
                if flags & 0x80:
                    pos += 3 * (2 << (flags & 7))
                pos += 1                           # min code size
                pos = _skip_subblocks(buf, pos)
                pkt = Packet(data=buf[start:pos], pts=self._pts,
                             dts=self._pts, duration=delay or 2,
                             stream_index=0, flags=PKT_FLAG_KEY,
                             time_base=Rational(1, 100))
                self._pts += delay or 2
                self._pos = pos
                return pkt
            elif b == 0x3B:
                break
            else:
                pos += 1
        raise EndOfStream()


@register_muxer
class GifMuxer(Muxer):
    name = "gif"
    extensions = ("gif",)
    default_video_codec = "gif"

    def _write_header(self) -> None:
        if len(self.streams) != 1 or \
                self.streams[0].codecpar.codec_type != MediaType.VIDEO:
            raise InvalidData("gif: exactly one video stream required")
        par = self.streams[0].codecpar
        w = self.w
        w.write(b"GIF89a")
        w.wl16(par.width or 0)
        w.wl16(par.height or 0)
        # GCT present, 8-bit color resolution, 256 entries
        w.write(bytes([0x80 | 0x70 | 0x07, 0, 0]))
        from ...codecs.gif import _web_palette
        pal = _web_palette()
        gct = bytearray(768)
        gct[:pal.size] = pal.tobytes()
        w.write(bytes(gct))
        # NETSCAPE2.0 infinite loop
        w.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")

    def _write_packet(self, pkt: Packet) -> None:
        self.w.write(pkt.data)

    def _write_trailer(self) -> None:
        self.w.write(b"\x3b")
