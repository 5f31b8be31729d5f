"""Opus range decoder + end-of-frame raw bits (RFC 6716 §4.1;
reference: libavcodec/opus/rc.c).

A copy of ffmpeg_tpu/codecs/opus/rc.py, held equal to it by
tests/test_torch_host_copies.py.  Host code, as in the
JAX package: it imports neither torch nor the JAX package."""

from __future__ import annotations

RC_TOP = 1 << 31
RC_BOT = RC_TOP >> 8


def ilog(x: int) -> int:
    n = 0
    while x > 0:
        n += 1
        x >>= 1
    return n


class RangeCoder:
    def __init__(self, data: bytes):
        self.data = data
        b0 = data[0] if data else 0
        self.range = 128
        self.value = 127 - (b0 >> 1)
        self.total_bits = 9
        # raw bits (read backwards from the end)
        self.rb_bytes = len(data)
        self.rb_pos = len(data)
        self.rb_cacheval = 0
        self.rb_cachelen = 0
        self._bitpos = 7                 # bits consumed at the front
        self._normalize()

    def _get_front_bits(self, n: int) -> int:
        """MSB-first bits from the front of the frame."""
        v = 0
        for _ in range(n):
            byte = self._bitpos >> 3
            bit = 7 - (self._bitpos & 7)
            d = self.data[byte] if byte < len(self.data) else 0
            v = (v << 1) | ((d >> bit) & 1)
            self._bitpos += 1
        return v

    def _normalize(self):
        while self.range <= RC_BOT:
            self.value = ((self.value << 8) |
                          (self._get_front_bits(8) ^ 0xFF)) & (RC_TOP - 1)
            self.range <<= 8
            self.total_bits += 8

    def _update(self, scale, low, high, total):
        self.value -= scale * (total - high)
        if low:
            self.range = scale * (high - low)
        else:
            self.range -= scale * (total - high)
        self._normalize()

    def dec_cdf(self, cdf) -> int:
        total = int(cdf[0])
        scale = self.range // total
        symbol = self.value // scale + 1
        symbol = total - min(symbol, total)
        k = 0
        while int(cdf[1 + k]) <= symbol:
            k += 1
        high = int(cdf[1 + k])
        low = int(cdf[k]) if k else 0
        self._update(scale, low, high, total)
        return k

    def dec_log(self, bits: int) -> int:
        scale = self.range >> bits
        if self.value >= scale:
            self.value -= scale
            self.range -= scale
            k = 0
        else:
            self.range = scale
            k = 1
        self._normalize()
        return k

    def get_raw(self, count: int) -> int:
        while self.rb_bytes and self.rb_cachelen < count:
            self.rb_pos -= 1
            self.rb_cacheval |= self.data[self.rb_pos] << self.rb_cachelen
            self.rb_cachelen += 8
            self.rb_bytes -= 1
        value = self.rb_cacheval & ((1 << count) - 1) if count else 0
        self.rb_cacheval >>= count
        self.rb_cachelen = max(0, self.rb_cachelen - count)
        self.total_bits += count
        return value

    def dec_uint(self, size: int) -> int:
        bits = ilog(size - 1)
        total = ((size - 1) >> (bits - 8)) + 1 if bits > 8 else size
        scale = self.range // total
        k = self.value // scale + 1
        k = total - min(k, total)
        self._update(scale, k, k + 1, total)
        if bits > 8:
            k = k << (bits - 8) | self.get_raw(bits - 8)
            return min(k, size - 1)
        return k

    def dec_uint_step(self, k0: int) -> int:
        total = (k0 + 1) * 3 + k0
        scale = self.range // total
        symbol = self.value // scale + 1
        symbol = total - min(symbol, total)
        k = symbol // 3 if symbol < (k0 + 1) * 3 else symbol - (k0 + 1) * 2
        if k <= k0:
            self._update(scale, 3 * k, 3 * (k + 1), total)
        else:
            self._update(scale, (k - 1 - k0) + 3 * (k0 + 1),
                         (k - k0) + 3 * (k0 + 1), total)
        return k

    def dec_uint_tri(self, qn: int) -> int:
        total = ((qn >> 1) + 1) * ((qn >> 1) + 1)
        scale = self.range // total
        center = self.value // scale + 1
        center = total - min(center, total)
        if center < total >> 1:
            k = (_isqrt(8 * center + 1) - 1) >> 1
            low = k * (k + 1) >> 1
            symbol = k + 1
        else:
            k = (2 * (qn + 1) - _isqrt(8 * (total - center - 1) + 1)) >> 1
            low = total - ((qn + 1 - k) * (qn + 2 - k) >> 1)
            symbol = qn + 1 - k
        self._update(scale, low, low + symbol, total)
        return k

    def dec_laplace(self, symbol: int, decay: int) -> int:
        value = 0
        low = 0
        scale = self.range >> 15
        center = self.value // scale + 1
        center = (1 << 15) - min(center, 1 << 15)
        if center >= symbol:
            value += 1
            low = symbol
            symbol = 1 + (((32768 - 32 - symbol) * (16384 - decay))
                          >> 15)
            while symbol > 1 and center >= low + 2 * symbol:
                value += 1
                symbol *= 2
                low += symbol
                symbol = (((symbol - 2) * decay) >> 15) + 1
            if symbol <= 1:
                distance = (center - low) >> 1
                value += distance
                low += 2 * distance
            if center < low + symbol:
                value = -value
            else:
                low += symbol
        self._update(scale, low, min(low + symbol, 32768), 32768)
        return value

    def tell(self) -> int:
        return self.total_bits - ilog(self.range)

    def tell_frac(self) -> int:
        total_bits = self.total_bits << 3
        rcbuffer = ilog(self.range)
        rng = self.range >> (rcbuffer - 16)
        for _ in range(3):
            rng = (rng * rng) >> 15
            bit = rng >> 16
            rcbuffer = (rcbuffer << 1) | bit
            rng >>= bit
        return total_bits - rcbuffer


def _isqrt(v: int) -> int:
    import math
    r = int(math.isqrt(v))
    return r


class RangeEncoder:
    """Opus range encoder (RFC 6716 §4.1 / libopus entenc.c
    semantics), producing frames our RangeCoder and the reference
    decoder accept.  Used to craft differential test streams."""

    def __init__(self):
        self.low = 0
        self.rng = 1 << 31
        self.rem = -1                   # buffered byte awaiting carry
        self.ext = 0                    # run of 0xFF bytes buffered
        self.out = bytearray()
        self.end_window = 0             # raw bits (written from end)
        self.nend_bits = 0

    # ---- internals ----------------------------------------------------
    def _carry_out(self, c: int):
        if c != 0xFF:
            carry = c >> 8
            if self.rem >= 0:
                self.out.append((self.rem + carry) & 0xFF)
            while self.ext > 0:
                self.out.append((0xFF + carry) & 0xFF)
                self.ext -= 1
            self.rem = c & 0xFF
        else:
            self.ext += 1

    def _normalize(self):
        while self.rng <= (1 << 23):
            self._carry_out(self.low >> 23)
            self.low = (self.low << 8) & ((1 << 31) - 1)
            self.rng <<= 8

    def _encode(self, fl: int, fh: int, ft: int):
        r = self.rng // ft
        if fl > 0:
            self.low += self.rng - r * (ft - fl)
            self.rng = r * (fh - fl)
        else:
            self.rng -= r * (ft - fh)
        self._normalize()

    # ---- public -------------------------------------------------------
    def enc_cdf(self, k: int, cdf) -> None:
        """Encode symbol k against an ffmpeg-layout CDF table
        (cdf[0]=total, cdf[1..]=cumulative highs)."""
        total = int(cdf[0])
        fl = int(cdf[k]) if k else 0
        fh = int(cdf[1 + k])
        self._encode(fl, fh, total)

    def enc_log(self, bit: int, bits: int) -> None:
        r = self.rng >> bits
        if bit:
            self.low += self.rng - r
            self.rng = r
        else:
            self.rng -= r
        self._normalize()

    def enc_uint(self, value: int, size: int) -> None:
        bits = ilog(size - 1)
        if bits > 8:
            total = ((size - 1) >> (bits - 8)) + 1
            self._encode(value >> (bits - 8),
                         (value >> (bits - 8)) + 1, total)
            self.put_raw(value & ((1 << (bits - 8)) - 1), bits - 8)
        else:
            self._encode(value, value + 1, size)

    def put_raw(self, value: int, count: int) -> None:
        """Raw bits, read back LSB-first from the frame tail."""
        self.end_window |= (value & ((1 << count) - 1)) << \
            self.nend_bits
        self.nend_bits += count

    def finish(self) -> bytes:
        """→ the encoded frame."""
        low, rng = self.low, self.rng
        l = 32 - ilog(rng)
        msk = ((1 << 31) - 1) >> l
        end = (low + msk) & ~msk
        if (end | msk) >= low + rng:
            l += 1
            msk >>= 1
            end = (low + msk) & ~msk
        while l > 0:
            self._carry_out(end >> 23)
            end = (end << 8) & ((1 << 31) - 1)
            l -= 8
        if self.rem >= 0 or self.ext > 0:
            self._carry_out(0)
        data = bytearray(self.out)
        # append raw bits at the tail (LSB-first from the last byte)
        nbytes = (self.nend_bits + 7) >> 3
        tail = bytearray(nbytes)
        w = self.end_window
        for i in range(nbytes):
            tail[nbytes - 1 - i] = w & 0xFF
            w >>= 8
        # the range stream and raw bits may share the boundary byte;
        # here we simply concatenate (crafted frames keep them
        # disjoint) — pad a zero byte between when raw bits exist
        data += tail
        if not data:
            data = bytearray(1)
        return bytes(data)
