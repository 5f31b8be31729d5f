"""Test-oracle muxers: framecrc / framemd5 / md5 / crc / null (analogs of
libavformat/framecrcenc.c, hashenc.c, nullenc.c). These are FATE's
comparison surface — byte-compatible with the reference so golden files
diff directly (with -fflags +bitexact semantics: no #software line).

The port's copy of ffmpeg_tpu/io/formats/hashenc.py, held equal to it by
tests/test_torch_io_formats.py.
"""

from __future__ import annotations

import hashlib
import zlib

from ...core.packet import Packet
from ...utils.rational import NOPTS
from ..mux import Muxer, register_muxer
from ..stream import MediaType


def _ts(v: int) -> str:
    return "N/A" if v == NOPTS else str(v)


class _FrameHashBase(Muxer):
    """Shared header block (#tb/#media_type/#codec_id/... lines)."""

    interleave = True

    def _write_header(self) -> None:
        lines = []
        version = getattr(self, "format_version", None)
        if version:
            lines.append(f"#format: {version}")
        for st in self.streams:
            par = st.codecpar
            lines.append(f"#tb {st.index}: {st.time_base.num}/{st.time_base.den}")
            lines.append(f"#media_type {st.index}: {par.codec_type}")
            lines.append(f"#codec_id {st.index}: {par.codec_id}")
            if par.codec_type == MediaType.AUDIO:
                lines.append(f"#sample_rate {st.index}: {par.sample_rate}")
                lines.append(f"#channel_layout_name {st.index}: "
                             f"{par.ch_layout.describe() if par.ch_layout else 'unknown'}")
            elif par.codec_type == MediaType.VIDEO:
                lines.append(f"#dimensions {st.index}: {par.width}x{par.height}")
                sar = par.sample_aspect_ratio
                lines.append(f"#sar {st.index}: {sar.num}/{sar.den}")
        self.w.write(("\n".join(lines) + "\n").encode())

    def _hash(self, data: bytes) -> str:
        raise NotImplementedError

    def _write_packet(self, pkt: Packet) -> None:
        # column layout matches framecrcenc.c: %d, %10ld, %10ld, %8d, %8d, hash
        line = (f"{pkt.stream_index}, {_ts(pkt.dts):>10}, {_ts(pkt.pts):>10}, "
                f"{pkt.duration:>8}, {len(pkt.data):>8}, {self._hash(pkt.data)}")
        flags = ""
        if pkt.flags & 0x1:
            flags += "K"
        if pkt.flags & 0x4:
            flags += "D"
        # reference prints side data/flags after; framecrc keeps it minimal
        if flags and flags != "K":
            line += f", {flags}"
        self.w.write((line + "\n").encode())


@register_muxer
class FrameCrcMuxer(_FrameHashBase):
    name = "framecrc"

    def _hash(self, data: bytes) -> str:
        # the reference seeds adler32 with 0, not the standard 1
        return f"0x{zlib.adler32(data, 0) & 0xFFFFFFFF:08x}"


@register_muxer
class FrameMd5Muxer(_FrameHashBase):
    name = "framemd5"
    format_version = "frame checksums"

    def _hash(self, data: bytes) -> str:
        return hashlib.md5(data).hexdigest()


@register_muxer
class Md5Muxer(Muxer):
    """Single hash over all packet payloads in mux order."""

    name = "md5"
    interleave = True

    def _write_header(self) -> None:
        self._md5 = hashlib.md5()

    def _write_packet(self, pkt: Packet) -> None:
        self._md5.update(pkt.data)

    def _write_trailer(self) -> None:
        self.w.write(f"MD5={self._md5.hexdigest()}\n".encode())


@register_muxer
class CrcMuxer(Muxer):
    name = "crc"
    interleave = True

    def _write_header(self) -> None:
        self._crc = 0

    def _write_packet(self, pkt: Packet) -> None:
        self._crc = zlib.adler32(pkt.data, self._crc)

    def _write_trailer(self) -> None:
        self.w.write(f"CRC=0x{self._crc & 0xFFFFFFFF:08x}\n".encode())


@register_muxer
class NullMuxer(Muxer):
    name = "null"
    interleave = False

    def _write_header(self) -> None:
        pass

    def _write_packet(self, pkt: Packet) -> None:
        pass


@register_muxer
class HashMuxer(Muxer):
    """Whole-stream hash muxer (hashenc.c `hash`): SHA-256 by default,
    algorithm selectable via the `hash` option (md5/sha1/sha256/sha512)."""

    name = "hash"
    interleave = False
    hash = "sha256"

    def _write_header(self) -> None:
        self._h = hashlib.new(self.hash)

    def _write_packet(self, pkt: Packet) -> None:
        self._h.update(pkt.data)

    def _write_trailer(self) -> None:
        self.w.write(f"{self._h.name.upper()}="
                     f"{self._h.hexdigest()}\n".encode())
