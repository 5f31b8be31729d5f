"""VP8/VP9 boolean (range) coder, both directions (RFC 6386 §7;
reference: libavcodec/vpx_rac.h, vp89_rac.h). The decoder mirrors the
spec's 16-bit-window formulation; the encoder is the RFC's carry-
propagating arithmetic encoder, used to craft differential test
streams.

The port's copy of ffmpeg_tpu/codecs/vp9/bool.py, held equal to it by
tests/test_torch_host_copies.py."""

from __future__ import annotations


class BoolDecoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 2
        b0 = data[0] if len(data) > 0 else 0
        b1 = data[1] if len(data) > 1 else 0
        self.value = (b0 << 8) | b1
        self.range = 255
        self.bit_count = 0

    def get(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            ret = 1
            self.range -= split
            self.value -= big
        else:
            ret = 0
            self.range = split
        while self.range < 128:
            self.value = (self.value << 1) & 0xFFFF
            self.range <<= 1
            self.bit_count += 1
            if self.bit_count == 8:
                self.bit_count = 0
                if self.pos < len(self.data):
                    self.value |= self.data[self.pos]
                    self.pos += 1
        return ret

    def bit(self) -> int:
        return self.get(128)

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get(128)
        return v

    def tree(self, tree, probs) -> int:
        i = 0
        while True:
            i = tree[i][self.get(probs[i])]
            if i <= 0:
                return -i


class BoolEncoder:
    def __init__(self):
        self.range = 255
        self.bottom = 0
        self.bit_count = 24
        self.out = bytearray()

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int):
        bit = int(bit)
        prob = int(prob)
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append((self.bottom >> 24) & 0xFF)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def bit(self, b: int):
        self.put(b, 128)

    def literal(self, v: int, n: int):
        for k in range(n - 1, -1, -1):
            self.put((v >> k) & 1, 128)

    def tree(self, tree, probs, value: int):
        """Emit the bits selecting `value` (a terminal, stored negated
        in the tree)."""
        path = []

        def walk(i):
            for b in (0, 1):
                nxt = tree[i][b]
                if nxt == -value and (nxt < 0 or (nxt == 0 and
                                                  value == 0)):
                    path.append((i, b))
                    return True
                if nxt > 0:
                    path.append((i, b))
                    if walk(nxt):
                        return True
                    path.pop()
            return False

        ok = walk(0)
        assert ok, f"value {value} not in tree"
        for i, b in path:
            self.put(b, probs[i])

    def finish(self) -> bytes:
        for _ in range(32):
            self.bit(0)
        return bytes(self.out)
