"""VVC CABAC core (ITU-T H.266 §9.3; reference vvc/cabac.c:818-960
vvc_get_cabac/cabac_init_state — re-derived from the standard's
two-rate probability model, mirroring the H.264 engine's style).

Differences from H.264/HEVC CABAC: each context keeps TWO probability
estimates with different adaptation windows (state0 10-bit, state1
15-bit) whose sum drives the LPS range computation directly (no
64-state table), and per-context adaptation shifts come from a fourth
init-value row.

The port's copy of ffmpeg_tpu/codecs/vvc/cabac.py, held equal to it by
tests/test_torch_vvc.py.
"""

from __future__ import annotations

from typing import List

from .tables import INIT_VALUES, NUM_CONTEXTS


def _clip3(lo, hi, x):
    return max(lo, min(hi, x))


def init_contexts(init_type: int, qp: int) -> List[list]:
    """→ per-ctx [state0, state1, shift0, shift1]
    (spec 9.3.2.2; cabac.c:818 cabac_init_state)."""
    qp = _clip3(0, 63, qp)
    out = []
    for i in range(NUM_CONTEXTS):
        init_value = INIT_VALUES[init_type][i]
        shift_idx = INIT_VALUES[3][i]
        m = (init_value >> 3) - 4
        n = ((init_value & 7) * 18) + 1
        pre = _clip3(1, 127, ((m * (qp - 16)) >> 1) + n)
        sh0 = (shift_idx >> 2) + 2
        sh1 = (shift_idx & 3) + 3 + sh0
        out.append([pre << 3, pre << 7, sh0, sh1])
    return out


def _lps_range(rng: int, ctx) -> tuple:
    """→ (valMps, ivlLpsRange) per spec 9.3.4.3.2.2."""
    q = rng >> 5
    p_state = ctx[1] + (ctx[0] << 4)
    val_mps = p_state >> 14
    lps = ((q * ((32767 - p_state if val_mps else p_state) >> 9))
           >> 1) + 4
    return val_mps, lps


def _update(ctx, bit: int) -> None:
    ctx[0] = ctx[0] - (ctx[0] >> ctx[2]) + ((1023 * bit) >> ctx[2])
    ctx[1] = ctx[1] - (ctx[1] >> ctx[3]) + ((16383 * bit) >> ctx[3])


class VvcCabacDecoder:
    """Spec 9.3.4.3: 9-bit range/offset, bit-at-a-time renorm."""

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
        val_mps, lps = _lps_range(self.range, ctx)
        self.range -= lps
        if self.offset >= self.range:
            bit = 1 - val_mps
            self.offset -= self.range
            self.range = lps
        else:
            bit = val_mps
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        _update(ctx, bit)
        return bit

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self._bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def bypass_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bypass()
        return v

    def terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return 0


class VvcCabacEncoder:
    """Arithmetic-encoding dual of the decoder (crafting harness)."""

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
        val_mps, lps = _lps_range(self.range, ctx)
        self.range -= lps
        if bit != val_mps:
            self.low += self.range
            self.range = lps
        self._renorm()
        _update(ctx, bit)

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

    def bypass_bits(self, v: int, n: int):
        for k in range(n - 1, -1, -1):
            self.bypass((v >> k) & 1)

    def terminate(self, end: int):
        self.range -= 2
        if end:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put((self.low >> 9) & 1)
            self.bits.append((self.low >> 8) & 1)
            self.bits.append(1)          # rbsp_stop_one_bit
        else:
            self._renorm()

    def bitstring(self) -> List[int]:
        return self.bits
