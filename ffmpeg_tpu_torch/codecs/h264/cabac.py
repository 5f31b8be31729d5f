"""CABAC arithmetic coding core, spec-exact (ITU-T H.264 §9.3.3.2
decoding / §9.3.4 encoding; reference: libavcodec/cabac_functions.h —
re-derived from the standard's flowcharts, not the reference's
table-packed fast path).

The port's copy of ffmpeg_tpu/codecs/h264/cabac.py, held equal to it by
tests/test_torch_hevc_host.py."""

from __future__ import annotations

from typing import List

from .cabac_tables import RANGE_TAB_LPS, TRANS_IDX_LPS


def _clip3(lo, hi, x):
    return max(lo, min(hi, x))


def init_contexts(table, qp: int) -> List[list]:
    """→ list of [state, mps] per ctxIdx from (m, n) init pairs."""
    out = []
    qp = _clip3(0, 51, qp)
    for m, n in table:
        pre = _clip3(1, 126, ((m * qp) >> 4) + n)
        if pre <= 63:
            out.append([63 - pre, 0])
        else:
            out.append([pre - 64, 1])
    return out


class CabacDecoder:
    """Spec 9.3.3.2: 9-bit range/offset with bit-at-a-time renorm."""

    def __init__(self, data: bytes):
        self.d = data + b"\x00" * 4
        self.nbits = len(data) * 8
        self.pos = 0
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._bit()

    def _bit(self) -> int:
        p = self.pos
        self.pos = p + 1
        return (self.d[p >> 3] >> (7 - (p & 7))) & 1

    def decision(self, ctx) -> int:
        state, mps = ctx
        r_lps = RANGE_TAB_LPS[state][(self.range >> 6) & 3]
        self.range -= r_lps
        if self.offset >= self.range:
            bit = 1 - mps
            self.offset -= self.range
            self.range = r_lps
            if state == 0:
                ctx[1] = 1 - mps
            ctx[0] = TRANS_IDX_LPS[state]
        else:
            bit = mps
            if state < 62:
                ctx[0] = state + 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return bit

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self._bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return 0


class CabacEncoder:
    """Spec 9.3.4 arithmetic encoder (used by the test harness to craft
    conformant streams; also the seed of a future encoder)."""

    def __init__(self):
        self.low = 0
        self.range = 510
        self.outstanding = 0
        self.first = True
        self.bits: List[int] = []

    def _put(self, b: int):
        if self.first:
            self.first = False
        else:
            self.bits.append(b)
        while self.outstanding:
            self.bits.append(1 - b)
            self.outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx, bit: int):
        state, mps = ctx
        r_lps = RANGE_TAB_LPS[state][(self.range >> 6) & 3]
        self.range -= r_lps
        if bit != mps:
            self.low += self.range
            self.range = r_lps
            if state == 0:
                ctx[1] = 1 - mps
            ctx[0] = TRANS_IDX_LPS[state]
        else:
            if state < 62:
                ctx[0] = state + 1
        self._renorm()

    def bypass(self, bit: int):
        self.low <<= 1
        if bit:
            self.low += self.range
        if self.low >= 1024:
            self.low -= 1024
            self._put(1)
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def terminate(self, end: int):
        self.range -= 2
        if end:
            self.low += self.range
            self.range = 2
            self._renorm()
            # flush (spec EncodeFlush)
            self._put((self.low >> 9) & 1)
            self.bits.append((self.low >> 8) & 1)
            self.bits.append(1)          # stop bit of the rbsp
        else:
            self._renorm()

    def bitstring(self) -> List[int]:
        return self.bits
