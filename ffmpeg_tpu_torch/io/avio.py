"""Byte I/O abstraction (analog of AVIOContext, libavformat/avio.h:398 +
aviobuf.c). File/pipe/memory backends with buffered reads, peek, and the
integer read/write helpers every (de)muxer uses. Protocol resolution
mirrors url_find_protocol (avio.c:317): scheme prefix → backend.

The port's copy of ffmpeg_tpu/io/avio.py, held equal to it by
tests/test_torch_io_formats.py.
"""

from __future__ import annotations

import io
import os
import struct
import sys
from typing import Optional, Union

from ..utils.error import EndOfStream, InvalidData, ProtocolNotFound


class Reader:
    """Buffered, seekable-when-possible byte reader."""

    def __init__(self, f, size: Optional[int] = None, owns: bool = True):
        self._f = f
        self._peek = b""
        self._pos = 0
        self.size = size
        self.owns = owns
        self.seekable = hasattr(f, "seek") and _is_seekable(f)

    # --- core ---------------------------------------------------------------
    def read(self, n: int) -> bytes:
        out = b""
        if self._peek:
            out, self._peek = self._peek[:n], self._peek[n:]
            n -= len(out)
        if n > 0:
            out += self._f.read(n)
        self._pos += len(out)
        return out

    def read_exact(self, n: int) -> bytes:
        b = self.read(n)
        if len(b) < n:
            raise EndOfStream(f"short read: wanted {n}, got {len(b)}")
        return b

    def peek(self, n: int) -> bytes:
        while len(self._peek) < n:
            chunk = self._f.read(n - len(self._peek))
            if not chunk:
                break
            self._peek += chunk
        return self._peek[:n]

    def skip(self, n: int) -> None:
        if self.seekable and not self._peek:
            self._f.seek(n, os.SEEK_CUR)
            self._pos += n
        else:
            while n > 0:
                b = self.read(min(n, 1 << 20))
                if not b:
                    raise EndOfStream("skip past EOF")
                n -= len(b)

    def tell(self) -> int:
        return self._pos

    def seek(self, pos: int) -> None:
        if not self.seekable:
            raise InvalidData("stream not seekable")
        self._f.seek(pos)
        self._pos = pos
        self._peek = b""

    def at_eof(self) -> bool:
        return len(self.peek(1)) == 0

    def close(self) -> None:
        if self.owns and self._f is not sys.stdin.buffer:
            self._f.close()

    # --- integer helpers (aviobuf.c avio_r*) ---------------------------------
    def u8(self) -> int:
        return self.read_exact(1)[0]

    def rl16(self) -> int:
        return struct.unpack("<H", self.read_exact(2))[0]

    def rl24(self) -> int:
        b = self.read_exact(3)
        return b[0] | b[1] << 8 | b[2] << 16

    def rl32(self) -> int:
        return struct.unpack("<I", self.read_exact(4))[0]

    def rl64(self) -> int:
        return struct.unpack("<Q", self.read_exact(8))[0]

    def rb16(self) -> int:
        return struct.unpack(">H", self.read_exact(2))[0]

    def rb24(self) -> int:
        b = self.read_exact(3)
        return b[0] << 16 | b[1] << 8 | b[2]

    def rb32(self) -> int:
        return struct.unpack(">I", self.read_exact(4))[0]

    def rb64(self) -> int:
        return struct.unpack(">Q", self.read_exact(8))[0]

    def tag(self) -> bytes:
        return self.read_exact(4)


class Writer:
    """Buffered byte writer with integer helpers (avio_w*)."""

    def __init__(self, f, owns: bool = True):
        self._f = f
        self._pos = 0
        self.owns = owns
        self.seekable = hasattr(f, "seek") and _is_seekable(f)

    def write(self, data: bytes) -> None:
        self._f.write(data)
        self._pos += len(data)

    def tell(self) -> int:
        return self._pos

    def seek(self, pos: int) -> None:
        self._f.seek(pos)
        self._pos = pos

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        if self.owns and self._f is not sys.stdout.buffer:
            self._f.close()

    def u8(self, v):
        self.write(bytes([v & 0xFF]))

    def wl16(self, v):
        self.write(struct.pack("<H", v & 0xFFFF))

    def wl24(self, v):
        self.write(bytes([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF]))

    def wl32(self, v):
        self.write(struct.pack("<I", v & 0xFFFFFFFF))

    def wl64(self, v):
        self.write(struct.pack("<Q", v & (2**64 - 1)))

    def wb16(self, v):
        self.write(struct.pack(">H", v & 0xFFFF))

    def wb24(self, v):
        self.write(bytes([(v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF]))

    def wb32(self, v):
        self.write(struct.pack(">I", v & 0xFFFFFFFF))

    def wb64(self, v):
        self.write(struct.pack(">Q", v & (2**64 - 1)))

    def tag(self, t: Union[str, bytes]):
        self.write(t.encode() if isinstance(t, str) else t)


def _is_seekable(f) -> bool:
    try:
        f.seek(f.tell() if hasattr(f, "tell") else 0, os.SEEK_CUR)
        return True
    except (OSError, io.UnsupportedOperation, ValueError):
        return False


def open_read(url) -> Reader:
    """Protocol resolution for input (file / pipe / fd / data / memory)."""
    if isinstance(url, Reader):
        return url
    if isinstance(url, (bytes, bytearray, memoryview)):
        return Reader(io.BytesIO(bytes(url)), size=len(url))
    if hasattr(url, "read"):
        return Reader(url, owns=False)
    s = str(url)
    if s == "-" or s.startswith("pipe:") or s.startswith("fd:"):
        if s in ("-", "pipe:", "pipe:0", "fd:"):
            return Reader(sys.stdin.buffer)
        fd = int(s.split(":", 1)[1])
        return Reader(os.fdopen(fd, "rb"))
    if s.startswith("file:"):
        s = s[5:]
    elif s.startswith(("concat:", "subfile,", "cache:", "async:")):
        from .protocols import open_nested
        f = open_nested(s)
        return Reader(f, size=getattr(f, "size", None))
    elif "://" in s:
        from .protocols import open_url
        f = open_url(s)
        if f is None:
            raise ProtocolNotFound(f"protocol of {url!r} not supported yet")
        return Reader(f, size=getattr(f, "size", None))
    f = open(s, "rb")
    return Reader(f, size=os.fstat(f.fileno()).st_size)


def open_write(url) -> Writer:
    if isinstance(url, Writer):
        return url
    if hasattr(url, "write"):
        return Writer(url, owns=False)
    s = str(url)
    if s == "-" or s.startswith("pipe:"):
        return Writer(sys.stdout.buffer)
    if s.startswith("file:"):
        s = s[5:]
    elif "://" in s:
        from .protocols import open_url_write
        f = open_url_write(s)
        if f is None:
            raise ProtocolNotFound(f"protocol of {url!r} not supported yet")
        return Writer(f, owns=True)
    return Writer(open(s, "wb"))
