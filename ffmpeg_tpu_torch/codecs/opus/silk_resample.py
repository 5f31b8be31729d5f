"""SILK → 48 kHz resampler replicating the reference decoder's
libswresample configuration exactly (opus/dec.c opus_init_resample:
filter_size=16, Kaiser beta 9, exact-rational phases; libswresample
resample.c build_filter + resample_common, float path).

The reference mirrors the first filter_length input samples as
pre-history (resample.c invert_initial_buffer) and feeds
silk_resample_delay[bw] samples of silence first; both are
reproduced so outputs align sample-exactly.

A copy of ffmpeg_tpu/codecs/opus/silk_resample.py, held equal to it by
tests/test_torch_host_copies.py.  Host code, as in the
JAX package: it imports neither torch nor the JAX package."""

from __future__ import annotations

import math

import numpy as np

f32 = np.float32

_PHASES = {8000: 6, 12000: 4, 16000: 3}
_DELAY = {8000: 4, 12000: 8, 16000: 11}
TAPS = 16
_CENTER = (TAPS - 1) // 2          # 7


def _bessel_i0(x: float) -> float:
    s = 1.0
    t = 1.0
    k = 1
    while True:
        t *= (x / (2 * k)) ** 2
        s += t
        if t < 1e-21 * s:
            return s
        k += 1


def _build_bank(pc: int) -> np.ndarray:
    """float32 (pc, TAPS) bank per build_filter with factor=1.0."""
    ph_nb = pc if pc % 2 else pc // 2 + 1
    bank = np.zeros((pc + 1, TAPS), f32)
    sin_lut = [math.sin(math.pi * ph / pc) * (1 if _CENTER & 1 else -1)
               for ph in range(ph_nb)]
    norm = 0.0
    rows = []
    for ph in range(ph_nb):
        s = sin_lut[ph]
        tab = []
        for i in range(TAPS):
            x = math.pi * ((i - _CENTER) - ph / pc)
            if x == 0:
                y = 1.0
            else:
                y = s / x
            w = 2.0 * x / (TAPS * math.pi)
            y *= _bessel_i0(9.0 * math.sqrt(max(1 - w * w, 0.0)))
            tab.append(y)
            s = -s
            if ph == 0:
                norm += y
        rows.append(tab)
    for ph in range(ph_nb):
        for i in range(TAPS):
            bank[ph, i] = f32(rows[ph][i] / norm)
        if pc % 2 == 0:
            for i in range(TAPS):
                bank[pc - ph, TAPS - 1 - i] = bank[ph, i]
    return bank[:pc]


class SilkResampler:
    def __init__(self, in_rate: int, channels: int):
        self.pc = _PHASES[in_rate]
        self.bank = _build_bank(self.pc)
        self.channels = channels
        self.bufs = [np.zeros(_DELAY[in_rate], f32)
                     for _ in range(channels)]
        self.next_out = 0              # next output index (phase units)

    def convert(self, chans, out_cap: int):
        """feed per-channel float32 arrays, produce up to out_cap
        output samples per channel → list of arrays."""
        for c in range(self.channels):
            self.bufs[c] = np.concatenate([self.bufs[c],
                                           np.asarray(chans[c], f32)])
        total = len(self.bufs[0])
        if total < TAPS + 1:
            return [np.zeros(0, f32) for _ in range(self.channels)]
        avail = (total - 8) * self.pc - self.next_out
        n = max(0, min(out_cap, avail))
        outs = []
        for c in range(self.channels):
            buf = self.bufs[c]
            out = np.zeros(n, f32)
            for j in range(n):
                idx = self.next_out + j
                phase = idx % self.pc
                base = idx // self.pc - _CENTER
                fr = self.bank[phase]
                val = f32(0.0)
                val2 = f32(0.0)
                for i in range(0, TAPS - 1, 2):
                    p0 = base + i
                    p1 = base + i + 1
                    x0 = buf[p0 if p0 >= 0 else -p0]
                    x1 = buf[p1 if p1 >= 0 else -p1]
                    val = f32(val + f32(x0 * fr[i]))
                    val2 = f32(val2 + f32(x1 * fr[i + 1]))
                out[j] = f32(val + val2)
            outs.append(out)
        self.next_out += n
        return outs

    def flush(self, n: int):
        """emit n tail samples after mirroring the buffered input
        (libswresample resample_flush appends a time-reversed copy of
        the unconsumed in_buffer)."""
        count = len(self.bufs[0]) - (self.next_out // self.pc) + \
            _CENTER
        if count <= 0 or n <= 0:
            return [np.zeros(0, f32) for _ in range(self.channels)]
        tails = [b[-count:][::-1].copy() for b in self.bufs]
        return self.convert(tails, n)
