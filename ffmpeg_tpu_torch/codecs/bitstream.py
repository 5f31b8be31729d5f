"""Host bitstream readers/writers (the port's copy of
ffmpeg_tpu/codecs/bitstream.py; analog of libavcodec get_bits.h /
put_bits.h). Pure Python, for control-plane parsing (headers, side
info); bulk entropy loops are C++ under csrc/host/."""

from __future__ import annotations

from ..utils.error import InvalidData


class BitReader:
    """MSB-first bit reader over bytes."""

    __slots__ = ("data", "nbits", "pos")

    def __init__(self, data: bytes, offset_bits: int = 0):
        self.data = data
        self.nbits = len(data) * 8
        self.pos = offset_bits

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        if p + n > self.nbits:
            raise InvalidData("bitstream overread")
        self.pos = p + n
        start = p >> 3
        end = (p + n + 7) >> 3
        chunk = int.from_bytes(self.data[start:end], "big")
        total = (end - start) * 8
        return (chunk >> (total - (p & 7) - n)) & ((1 << n) - 1)

    def get_signed(self, n: int) -> int:
        v = self.get(n)
        return v - (1 << n) if v >> (n - 1) else v

    def peek(self, n: int) -> int:
        """Peek n bits; reads past EOF return zero-padding on the RIGHT
        (keeps left alignment — vital for LUT-based huffman lookups)."""
        p = self.pos
        pad = 0
        if p + n > self.nbits:
            avail = self.nbits - p
            if avail <= 0:
                return 0
            pad = n - avail
            n = avail
        start = p >> 3
        end = (p + n + 7) >> 3
        chunk = int.from_bytes(self.data[start:end], "big")
        total = (end - start) * 8
        return ((chunk >> (total - (p & 7) - n)) & ((1 << n) - 1)) << pad

    def skip(self, n: int) -> None:
        self.pos += n

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def unary(self, max_run: int = 1 << 20) -> int:
        """Count zeros until a 1 (consumes the 1)."""
        count = 0
        while count < max_run:
            if self.get(1):
                return count
            count += 1
        raise InvalidData("unary overrun")

    def rice(self, k: int) -> int:
        q = self.unary()
        r = self.get(k) if k else 0
        v = (q << k) | r
        return (v >> 1) ^ -(v & 1)     # zigzag to signed

    def bits_left(self) -> int:
        return self.nbits - self.pos

    def byte_position(self) -> int:
        return (self.pos + 7) >> 3


class BitWriter:
    """MSB-first bit writer."""

    __slots__ = ("buf", "acc", "n")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, n: int) -> None:
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.buf.append((self.acc >> (self.n - 8)) & 0xFF)
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def put_signed(self, value: int, n: int) -> None:
        self.put(value & ((1 << n) - 1), n)

    def align(self, pad: int = 0) -> None:
        while self.n:
            self.put(pad & 1, 1)

    def bytes(self) -> bytes:
        assert self.n == 0, "unaligned bitstream"
        return bytes(self.buf)

    def bit_length(self) -> int:
        return len(self.buf) * 8 + self.n
