"""H.264 RBSP bit reading: MSB-first reader + Exp-Golomb (reference:
libavcodec/get_bits.h + golomb.h semantics).

The port's copy of ffmpeg_tpu/codecs/h264/bits.py, held equal to it by
tests/test_torch_host_copies.py."""

from __future__ import annotations

from ...utils.error import InvalidData


class Bits:
    __slots__ = ("d", "pos", "n")

    def __init__(self, data: bytes):
        self.d = data + b"\x00" * 8
        self.pos = 0
        self.n = len(data) * 8

    def get(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        p = self.pos
        self.pos = p + nbits
        end = p + nbits
        first = p >> 3
        last = (end + 7) >> 3
        v = int.from_bytes(self.d[first:last], "big")
        return (v >> ((last << 3) - end)) & ((1 << nbits) - 1)

    def get1(self) -> int:
        p = self.pos
        self.pos = p + 1
        return (self.d[p >> 3] >> (7 - (p & 7))) & 1

    def peek(self, nbits: int) -> int:
        p = self.pos
        v = self.get(nbits)
        self.pos = p
        return v

    def ue(self) -> int:
        """Unsigned Exp-Golomb."""
        zeros = 0
        while self.get1() == 0:
            zeros += 1
            if zeros > 31:
                raise InvalidData("h264: bad exp-golomb")
        return (1 << zeros) - 1 + (self.get(zeros) if zeros else 0)

    def se(self) -> int:
        """Signed Exp-Golomb."""
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def more_rbsp(self) -> bool:
        """True if data remains before the rbsp_stop_one_bit."""
        if self.pos >= self.n:
            return False
        rest = self.n - self.pos
        if rest > 8:
            return True
        tail = self.peek(rest)
        return tail != (1 << (rest - 1))
