"""Opus CELT layer decoder (counterpart of ffmpeg_tpu/codecs/opus/celt.py;
RFC 6716 §4.3; reference: libavcodec/opus/dec_celt.c, celt.c bit
allocation, pvq.c band quantization). Host float decode with the IMDCT
on the decoder's device (ops/tx.py): the half-length inverse MDCT equals
the middle window [N/2, 3N/2) of the full transform, scaled 1/32768
(libavutil/tx MDCT convention).

The host code is the reference's, statement for statement: the range
decoder, PVQ, the energies, anti-collapse and denormalisation in float64
numpy with its 32-bit LCG.  Where the reference makes one IMDCT per
output channel and short block, the port makes one per frame over all
of them, (channels·blocks, blocksize), with one copy to the device and
one back (codecs/audio_tx.py); no transform's input depends on another's
output.  The windowing (`_fmul_window`), the comb postfilter and the
de-emphasis then run on the host in the reference's order.  `stats`,
when a list, gets each frame's split."""

from __future__ import annotations

import math

import numpy as np
import torch

from ...ops import tx
from ...utils.error import InvalidData
from .. import audio_tx
from . import tables_gen as T
from .rc import RangeCoder, ilog

MAX_BANDS = 21
VECTORS = 11
ALLOC_STEPS = 6
FINE_OFFSET = 21
MAX_FINE_BITS = 8
QTHETA_OFFSET = 4
QTHETA_OFFSET_TWOPHASE = 16
POSTFILTER_MINPERIOD = 15
ENERGY_SILENCE = -28.0
OVERLAP = 120
SHORT_BLOCKSIZE = 120

SPREAD_NONE, SPREAD_LIGHT, SPREAD_NORMAL, SPREAD_AGGRESSIVE = range(4)


def _tdiv(a, b):
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _pvq_u(n, k):
    """U(N, K) (tab.c ff_celt_pvq_u_row indexing: rows fold N>K)."""
    if n > k:
        n, k = k, n
    # row n (n <= 14), entry k
    return int(T.PVQ_U[T.PVQ_U_ROW[n] + k])


def _pvq_v(n, k):
    return _pvq_u(n, k) + _pvq_u(n, k + 1)


class Block:
    def __init__(self):
        self.energy = np.zeros(MAX_BANDS)
        self.prev_energy = np.full((2, MAX_BANDS), ENERGY_SILENCE)
        self.lin_energy = np.zeros(MAX_BANDS)
        self.buf = np.zeros(2048)
        self.pf_period = self.pf_period_old = self.pf_period_new = 15
        self.pf_gains = np.zeros(3)
        self.pf_gains_old = np.zeros(3)
        self.pf_gains_new = np.zeros(3)
        self.emph_coeff = 0.0
        self.collapse_masks = np.zeros(MAX_BANDS, np.int64)
        self.coeffs = np.zeros(960)


class CeltDecoder:
    def __init__(self, output_channels: int,
                 device: torch.device | str = "cuda"):
        self.output_channels = output_channels
        self.device = torch.device(device)
        self.stats = None
        self.block = [Block(), Block()]
        self.seed = 0

    def _rng(self):
        self.seed = (1664525 * self.seed + 1013904223) & 0xFFFFFFFF
        return self.seed

    # ------------------------------------------------------------------
    def decode(self, rc: RangeCoder, channels, frame_size, start_band,
               end_band):
        f = self
        timer = audio_tx.start(self.device, self.stats)
        f.channels = channels
        f.start_band = start_band
        f.end_band = end_band
        f.framebits = len(rc.data) * 8
        f.size = int(math.log2(frame_size // SHORT_BLOCKSIZE))
        f.silence = 0
        f.transient = 0
        f.anticollapse = 0
        f.tf_change = [0] * MAX_BANDS
        f.pulses = [0] * MAX_BANDS
        f.fine_bits = [0] * MAX_BANDS
        f.fine_priority = [0] * MAX_BANDS
        f.caps = [0] * MAX_BANDS
        f.remaining = 0
        f.remaining2 = 0
        f.coded_bands = 0
        f.spread = SPREAD_NORMAL
        f.intensity_stereo = 0
        f.dual_stereo = 0
        f.apply_phase_inv = True

        for i in range(channels):
            self.block[i].coeffs = np.zeros(frame_size)
            self.block[i].collapse_masks[:] = 0

        consumed = rc.tell()
        if consumed >= f.framebits:
            f.silence = 1
        elif consumed == 1:
            f.silence = rc.dec_log(15)
        if f.silence:
            rc.total_bits += f.framebits - rc.tell()

        consumed = self._parse_postfilter(rc)
        if f.size != 0 and consumed + 3 <= f.framebits:
            f.transient = rc.dec_log(3)
        f.blocks = (1 << f.size) if f.transient else 1
        f.blocksize = frame_size // f.blocks

        if channels == 1:
            for i in range(MAX_BANDS):
                self.block[0].energy[i] = max(self.block[0].energy[i],
                                              self.block[1].energy[i])

        self._coarse_energy(rc)
        self._tf_changes(rc)
        self._bitalloc(rc)
        self._fine_energy(rc)
        self._quant_bands(rc)

        if f.anticollapse_needed:
            f.anticollapse = rc.get_raw(1)
        self._final_energy(rc)

        for i in range(channels):
            block = self.block[i]
            if f.anticollapse:
                self._anticollapse(block)
            self._denormalize(block)

        # mono/stereo output adaptation
        downmix = False
        if self.output_channels < channels:
            self.block[0].coeffs[:frame_size] += \
                self.block[1].coeffs[:frame_size]
            downmix = True
        elif self.output_channels > channels:
            self.block[1].coeffs = self.block[0].coeffs.copy()

        if f.silence:
            for i in range(2):
                self.block[i].energy[:] = ENERGY_SILENCE
            self.block[0].coeffs[:] = 0
            self.block[1].coeffs[:] = 0

        out = np.zeros((self.output_channels, frame_size))
        halves = self._imdct_halves(
            [self.block[i].coeffs[j::f.blocks][:f.blocksize]
             for i in range(self.output_channels) for j in range(f.blocks)],
            timer)
        for i in range(self.output_channels):
            block = self.block[i]
            for j in range(f.blocks):
                dst_off = 1024 + j * f.blocksize
                h = halves[i * f.blocks + j]
                seg = block.buf[dst_off + OVERLAP // 2:
                                dst_off + OVERLAP // 2 + f.blocksize]
                seg[:] = h
                self._fmul_window(block.buf, dst_off)
            if downmix:
                block.buf[1024:1024 + frame_size] *= 0.5
            self._postfilter(block, frame_size)
            # deemphasis
            x = block.buf[1024 - frame_size:1024]
            c = 0.8500061035
            coeff = block.emph_coeff
            y = np.empty(frame_size)
            for k in range(frame_size):
                coeff = x[k] + coeff * c
                y[k] = coeff
            if not math.isfinite(coeff):
                coeff = 0.0
            block.emph_coeff = coeff
            out[i] = y

        if channels == 1:
            self.block[1].energy[:] = self.block[0].energy

        for i in range(2):
            block = self.block[i]
            if not f.transient:
                block.prev_energy[1] = block.prev_energy[0].copy()
                block.prev_energy[0] = block.energy.copy()
            else:
                block.prev_energy[0] = np.minimum(block.prev_energy[0],
                                                  block.energy)
            block.prev_energy[0][:f.start_band] = ENERGY_SILENCE
            block.energy[:f.start_band] = 0
            block.prev_energy[0][f.end_band:] = ENERGY_SILENCE
            block.energy[f.end_band:] = 0

        self.seed = rc.range
        return out

    # -- IMDCT + windowing ------------------------------------------------
    def _imdct_halves(self, coeffs, timer=None):
        """The half-length IMDCT of each of `coeffs` (equal lengths n) in
        one device call → (len(coeffs), n) float64."""
        n = len(coeffs[0])
        z = audio_tx.run(lambda x: tx.imdct(x, n, scale=1.0 / 32768.0),
                         np.stack(coeffs), self.device, timer, self.stats)
        return z[:, n // 2: n // 2 + n]

    def _fmul_window(self, buf, off):
        """vector_fmul_window(dst=buf+off, src0=buf+off,
        src1=buf+off+60, ff_celt_window, 60)."""
        ln = OVERLAP // 2
        win = T.WINDOW
        s0 = buf[off:off + ln].copy()
        s1 = buf[off + ln:off + 2 * ln].copy()
        for m in range(ln):
            j = ln - 1 - m
            buf[off + m] = s0[m] * win[2 * ln - 1 - m] \
                - s1[j] * win[m]
            buf[off + 2 * ln - 1 - m] = s0[m] * win[m] \
                + s1[j] * win[2 * ln - 1 - m]

    # -- header pieces ------------------------------------------------------
    def _parse_postfilter(self, rc):
        f = self
        for i in range(2):
            self.block[i].pf_gains_new[:] = 0
        consumed = rc.tell()
        if f.start_band == 0 and consumed + 16 <= f.framebits:
            if rc.dec_log(1):
                octave = rc.dec_uint(6)
                period = (16 << octave) + rc.get_raw(4 + octave) - 1
                gain = 0.09375 * (rc.get_raw(3) + 1)
                tapset = rc.dec_cdf(T.MODEL_TAPSET) \
                    if rc.tell() + 2 <= f.framebits else 0
                taps = T.POSTFILTER_TAPS.reshape(3, 3)[tapset]
                for i in range(2):
                    b = self.block[i]
                    b.pf_period_new = max(period, POSTFILTER_MINPERIOD)
                    b.pf_gains_new[:] = gain * taps
            consumed = rc.tell()
        return consumed

    def _coarse_energy(self, rc):
        f = self
        prev = [0.0, 0.0]
        alpha = float(T.ALPHA_COEF[f.size])
        beta = float(T.BETA_COEF[f.size])
        model = T.COARSE_ENERGY_DIST[f.size][0]
        if rc.tell() + 3 <= f.framebits and rc.dec_log(3):
            alpha = 0.0
            beta = 1.0 - 4915.0 / 32768.0
            model = T.COARSE_ENERGY_DIST[f.size][1]
        for i in range(MAX_BANDS):
            for j in range(f.channels):
                block = self.block[j]
                if i < f.start_band or i >= f.end_band:
                    block.energy[i] = 0.0
                    continue
                available = f.framebits - rc.tell()
                if available >= 15:
                    k = min(i, 20) << 1
                    value = float(rc.dec_laplace(
                        int(model[k]) << 7, int(model[k + 1]) << 6))
                elif available >= 2:
                    x = rc.dec_cdf(T.MODEL_ENERGY_SMALL)
                    value = (x >> 1) ^ -(x & 1)
                elif available >= 1:
                    value = -float(rc.dec_log(1))
                else:
                    value = -1.0
                block.energy[i] = max(-9.0, block.energy[i]) * alpha \
                    + prev[j] + value
                prev[j] += beta * value

    def _fine_energy(self, rc):
        f = self
        for i in range(f.start_band, f.end_band):
            if not f.fine_bits[i]:
                continue
            for j in range(f.channels):
                q2 = rc.get_raw(f.fine_bits[i])
                offset = (q2 + 0.5) * (1 << (14 - f.fine_bits[i])) \
                    / 16384.0 - 0.5
                self.block[j].energy[i] += offset

    def _final_energy(self, rc):
        f = self
        bits_left = f.framebits - rc.tell()
        for priority in range(2):
            i = f.start_band
            while i < f.end_band and bits_left >= f.channels:
                if f.fine_priority[i] != priority or \
                        f.fine_bits[i] >= MAX_FINE_BITS:
                    i += 1
                    continue
                for j in range(f.channels):
                    q2 = rc.get_raw(1)
                    offset = (q2 - 0.5) * \
                        (1 << (14 - f.fine_bits[i] - 1)) / 16384.0
                    self.block[j].energy[i] += offset
                    bits_left -= 1
                i += 1

    def _tf_changes(self, rc):
        f = self
        diff = 0
        tf_changed = 0
        bits = 2 if f.transient else 4
        consumed = rc.tell()
        tf_select_bit = int(f.size != 0 and
                            consumed + bits + 1 <= f.framebits)
        tf = [0] * MAX_BANDS
        for i in range(f.start_band, f.end_band):
            if consumed + bits + tf_select_bit <= f.framebits:
                diff ^= rc.dec_log(bits)
                consumed = rc.tell()
                tf_changed |= diff
            tf[i] = diff
            bits = 4 if f.transient else 5
        tf_select = 0
        ts = T.TF_SELECT[f.size][f.transient]
        if tf_select_bit and ts[0][tf_changed] != ts[1][tf_changed]:
            tf_select = rc.dec_log(1)
        for i in range(f.start_band, f.end_band):
            f.tf_change[i] = int(ts[tf_select][tf[i]])

    # -- bit allocation (celt.c ff_celt_bitalloc, decode side) ------------
    def _bitalloc(self, rc):
        f = self
        nc = f.channels

        def normc(bits):
            return bits << (nc - 1) << f.size >> 2

        skip_startband = f.start_band
        skip_bit = 0
        intensitystereo_bit = 0
        dualstereo_bit = 0
        dynalloc = 6
        extrabits = 0
        boost = [0] * MAX_BANDS
        trim_offset = [0] * MAX_BANDS
        threshold = [0] * MAX_BANDS
        bits1 = [0] * MAX_BANDS
        bits2 = [0] * MAX_BANDS

        if rc.tell() + 4 <= f.framebits:
            f.spread = rc.dec_cdf(T.MODEL_SPREAD)
        else:
            f.spread = SPREAD_NORMAL

        for i in range(MAX_BANDS):
            f.caps[i] = normc(
                (int(T.STATIC_CAPS[f.size][nc - 1][i]) + 64)
                * int(T.FREQ_RANGE[i]))

        tbits_8ths = f.framebits << 3
        for i in range(f.start_band, f.end_band):
            quanta = int(T.FREQ_RANGE[i]) << (nc - 1) << f.size
            quanta = min(quanta << 3, max(6 << 3, quanta))
            b_dynalloc = dynalloc
            while rc.tell_frac() + (b_dynalloc << 3) < tbits_8ths \
                    and boost[i] < f.caps[i]:
                if not rc.dec_log(b_dynalloc):
                    break
                boost[i] += quanta
                tbits_8ths -= quanta
                b_dynalloc = 1
            if boost[i]:
                dynalloc = max(dynalloc - 1, 2)

        f.alloc_trim = 5
        if rc.tell_frac() + (6 << 3) <= tbits_8ths:
            f.alloc_trim = rc.dec_cdf(T.MODEL_ALLOC_TRIM)

        tbits_8ths = (f.framebits << 3) - rc.tell_frac() - 1
        f.anticollapse_needed = 0
        if f.transient and f.size >= 2 and \
                tbits_8ths >= ((f.size + 2) << 3):
            f.anticollapse_needed = 1 << 3
        tbits_8ths -= f.anticollapse_needed
        if tbits_8ths >= 1 << 3:
            skip_bit = 1 << 3
        tbits_8ths -= skip_bit
        if nc == 2:
            intensitystereo_bit = int(
                T.LOG2_FRAC[f.end_band - f.start_band])
            if intensitystereo_bit <= tbits_8ths:
                tbits_8ths -= intensitystereo_bit
                if tbits_8ths >= 1 << 3:
                    dualstereo_bit = 1 << 3
                    tbits_8ths -= 1 << 3
            else:
                intensitystereo_bit = 0

        for i in range(f.start_band, f.end_band):
            trim = f.alloc_trim - 5 - f.size
            band = int(T.FREQ_RANGE[i]) * (f.end_band - i - 1)
            duration = f.size + 3
            scale = duration + nc - 1
            threshold[i] = max(3 * int(T.FREQ_RANGE[i]) << duration
                               >> 4, nc << 3)
            trim_offset[i] = trim * (band << scale) >> 6
            if int(T.FREQ_RANGE[i]) << f.size == 1:
                trim_offset[i] -= nc << 3

        low, high = 1, VECTORS - 1
        while low <= high:
            center = (low + high) >> 1
            done = total = 0
            for i in range(f.end_band - 1, f.start_band - 1, -1):
                bandbits = normc(int(T.FREQ_RANGE[i])
                                 * int(T.STATIC_ALLOC[center][i]))
                if bandbits:
                    bandbits = max(bandbits + trim_offset[i], 0)
                bandbits += boost[i]
                if bandbits >= threshold[i] or done:
                    done = 1
                    total += min(bandbits, f.caps[i])
                elif bandbits >= nc << 3:
                    total += nc << 3
            if total > tbits_8ths:
                high = center - 1
            else:
                low = center + 1
        high = low
        low -= 1

        for i in range(f.start_band, f.end_band):
            bits1[i] = normc(int(T.FREQ_RANGE[i])
                             * int(T.STATIC_ALLOC[low][i]))
            bits2[i] = f.caps[i] if high >= VECTORS else \
                normc(int(T.FREQ_RANGE[i])
                      * int(T.STATIC_ALLOC[high][i]))
            if bits1[i]:
                bits1[i] = max(bits1[i] + trim_offset[i], 0)
            if bits2[i]:
                bits2[i] = max(bits2[i] + trim_offset[i], 0)
            if low:
                bits1[i] += boost[i]
            bits2[i] += boost[i]
            if boost[i]:
                skip_startband = i
            bits2[i] = max(bits2[i] - bits1[i], 0)

        low, high = 0, 1 << ALLOC_STEPS
        for _ in range(ALLOC_STEPS):
            center = (low + high) >> 1
            done = total = 0
            for j in range(f.end_band - 1, f.start_band - 1, -1):
                bandbits = bits1[j] + (center * bits2[j]
                                       >> ALLOC_STEPS)
                if bandbits >= threshold[j] or done:
                    done = 1
                    total += min(bandbits, f.caps[j])
                elif bandbits >= nc << 3:
                    total += nc << 3
            if total > tbits_8ths:
                high = center
            else:
                low = center

        done = total = 0
        for i in range(f.end_band - 1, f.start_band - 1, -1):
            bandbits = bits1[i] + (low * bits2[i] >> ALLOC_STEPS)
            if bandbits >= threshold[i] or done:
                done = 1
            else:
                bandbits = (nc << 3) if bandbits >= nc << 3 else 0
            bandbits = min(bandbits, f.caps[i])
            f.pulses[i] = bandbits
            total += bandbits

        # band skipping
        f.coded_bands = f.end_band
        while True:
            j = f.coded_bands - 1
            if j == skip_startband:
                tbits_8ths += skip_bit
                break
            remaining = tbits_8ths - total
            span = int(T.FREQ_BANDS[j + 1]) - \
                int(T.FREQ_BANDS[f.start_band])
            bandbits = _tdiv(remaining, span)
            remaining -= bandbits * span
            allocation = f.pulses[j] + bandbits * int(T.FREQ_RANGE[j])
            allocation += max(
                remaining - (int(T.FREQ_BANDS[j])
                             - int(T.FREQ_BANDS[f.start_band])), 0)
            if allocation >= max(threshold[j], (nc + 1) << 3):
                if rc.dec_log(1):
                    break
                total += 1 << 3
                allocation -= 1 << 3
            total -= f.pulses[j]
            if intensitystereo_bit:
                total -= intensitystereo_bit
                intensitystereo_bit = int(
                    T.LOG2_FRAC[j - f.start_band])
                total += intensitystereo_bit
            f.pulses[j] = (nc << 3) if allocation >= nc << 3 else 0
            total += f.pulses[j]
            f.coded_bands -= 1

        f.intensity_stereo = 0
        f.dual_stereo = 0
        if intensitystereo_bit:
            f.intensity_stereo = f.start_band + rc.dec_uint(
                f.coded_bands + 1 - f.start_band)
        if f.intensity_stereo <= f.start_band:
            tbits_8ths += dualstereo_bit
        elif dualstereo_bit:
            f.dual_stereo = rc.dec_log(1)

        remaining = tbits_8ths - total
        span = int(T.FREQ_BANDS[f.coded_bands]) - \
            int(T.FREQ_BANDS[f.start_band])
        bandbits = _tdiv(remaining, span)
        remaining -= bandbits * span
        for i in range(f.start_band, f.coded_bands):
            bits = min(remaining, int(T.FREQ_RANGE[i]))
            f.pulses[i] += bits + bandbits * int(T.FREQ_RANGE[i])
            remaining -= bits

        extrabits = 0
        i = f.start_band
        for i in range(f.start_band, f.coded_bands):
            n = int(T.FREQ_RANGE[i]) << f.size
            prev_extra = extrabits
            f.pulses[i] += extrabits
            if n > 1:
                extrabits = max(f.pulses[i] - f.caps[i], 0)
                f.pulses[i] -= extrabits
                dof = n * nc + int(nc == 2 and n > 2 and
                                   not f.dual_stereo and
                                   i < f.intensity_stereo)
                temp = dof * (int(T.LOG_FREQ_RANGE[i]) + (f.size << 3))
                offset = (temp >> 1) - dof * FINE_OFFSET
                if n == 2:
                    offset += dof << 1
                if f.pulses[i] + offset < 2 * (dof << 3):
                    offset += temp >> 2
                elif f.pulses[i] + offset < 3 * (dof << 3):
                    offset += temp >> 3
                fine_bits = (f.pulses[i] + offset + (dof << 2)) \
                    // (dof << 3)
                max_bits = min((f.pulses[i] >> 3) >> (nc - 1),
                               MAX_FINE_BITS)
                max_bits = max(max_bits, 0)
                f.fine_bits[i] = max(0, min(fine_bits, max_bits))
                f.fine_priority[i] = int(
                    f.fine_bits[i] * (dof << 3) >= f.pulses[i] + offset)
                f.pulses[i] -= f.fine_bits[i] << (nc - 1) << 3
            else:
                extrabits = max(f.pulses[i] - (nc << 3), 0)
                f.pulses[i] -= extrabits
                f.fine_bits[i] = 0
                f.fine_priority[i] = 1
            if extrabits > 0:
                fineextra = min(extrabits >> (nc + 2),
                                MAX_FINE_BITS - f.fine_bits[i])
                f.fine_bits[i] += fineextra
                fineextra <<= nc + 2
                f.fine_priority[i] = int(
                    fineextra >= extrabits - prev_extra)
                extrabits -= fineextra
        f.remaining = extrabits
        for i in range(f.coded_bands, f.end_band):
            f.fine_bits[i] = f.pulses[i] >> (nc - 1) >> 3
            f.pulses[i] = 0
            f.fine_priority[i] = int(f.fine_bits[i] < 1)

    # -- band quantization (celt.c ff_celt_quant_bands) --------------------
    def _quant_bands(self, rc):
        f = self
        norm1 = np.zeros(8 * 100)
        norm2 = np.zeros(8 * 100)
        totalbits = (f.framebits << 3) - f.anticollapse_needed
        update_lowband = 1
        lowband_offset = 0
        for i in range(f.start_band, f.end_band):
            cm = [(1 << f.blocks) - 1, (1 << f.blocks) - 1]
            band_offset = int(T.FREQ_BANDS[i]) << f.size
            band_size = int(T.FREQ_RANGE[i]) << f.size
            X = self.block[0].coeffs[band_offset:
                                     band_offset + band_size]
            Y = self.block[1].coeffs[band_offset:
                                     band_offset + band_size] \
                if f.channels == 2 else None
            consumed = rc.tell_frac()
            effective_lowband = -1
            b = 0
            if i != f.start_band:
                f.remaining -= consumed
            f.remaining2 = totalbits - consumed - 1
            if i <= f.coded_bands - 1:
                curr_balance = _tdiv(f.remaining,
                                     min(3, f.coded_bands - i))
                b = max(0, min(min(f.remaining2 + 1,
                                   f.pulses[i] + curr_balance), 16383))
            if (int(T.FREQ_BANDS[i]) - int(T.FREQ_RANGE[i]) >=
                    int(T.FREQ_BANDS[f.start_band]) or
                    i == f.start_band + 1) and \
                    (update_lowband or lowband_offset == 0):
                lowband_offset = i
            if i == f.start_band + 1:
                count = (int(T.FREQ_RANGE[i])
                         - int(T.FREQ_RANGE[i - 1])) << f.size
                norm1[band_offset:band_offset + count] = \
                    norm1[band_offset - count:band_offset]
                if f.channels == 2:
                    norm2[band_offset:band_offset + count] = \
                        norm2[band_offset - count:band_offset]
            if lowband_offset != 0 and (f.spread != SPREAD_AGGRESSIVE
                                        or f.blocks > 1
                                        or f.tf_change[i] < 0):
                effective_lowband = max(
                    int(T.FREQ_BANDS[f.start_band]),
                    int(T.FREQ_BANDS[lowband_offset])
                    - int(T.FREQ_RANGE[i]))
                foldstart = lowband_offset
                while True:
                    foldstart -= 1
                    if int(T.FREQ_BANDS[foldstart]) <= \
                            effective_lowband:
                        break
                foldend = lowband_offset - 1
                while True:
                    foldend += 1
                    if not (foldend < i and int(T.FREQ_BANDS[foldend])
                            < effective_lowband
                            + int(T.FREQ_RANGE[i])):
                        break
                cm[0] = cm[1] = 0
                for j in range(foldstart, foldend):
                    cm[0] |= int(self.block[0].collapse_masks[j])
                    cm[1] |= int(
                        self.block[f.channels - 1].collapse_masks[j])
            if f.dual_stereo and i == f.intensity_stereo:
                f.dual_stereo = 0
                s0 = int(T.FREQ_BANDS[f.start_band]) << f.size
                norm1[s0:band_offset] = (norm1[s0:band_offset]
                                         + norm2[s0:band_offset]) / 2
            nl1 = norm1[effective_lowband << f.size:] \
                if effective_lowband != -1 else None
            nl2 = norm2[effective_lowband << f.size:] \
                if effective_lowband != -1 else None
            if f.dual_stereo:
                cm[0] = self._quant_band(
                    rc, i, X, None, band_size, b >> 1, f.blocks, nl1,
                    f.size, norm1[band_offset:], 0, 1.0, None, cm[0])
                cm[1] = self._quant_band(
                    rc, i, Y, None, band_size, b >> 1, f.blocks, nl2,
                    f.size, norm2[band_offset:], 0, 1.0, None, cm[1])
            else:
                cm[0] = self._quant_band(
                    rc, i, X, Y, band_size, b, f.blocks, nl1, f.size,
                    norm1[band_offset:], 0, 1.0, None,
                    cm[0] | cm[1])
                cm[1] = cm[0]
            self.block[0].collapse_masks[i] = cm[0] & 0xFF
            self.block[f.channels - 1].collapse_masks[i] = cm[1] & 0xFF
            f.remaining += f.pulses[i] + consumed
            update_lowband = int(b > band_size << 3)

    # -- PVQ (pvq.c quant_band_template, decode direction) -----------------
    def _quant_band(self, rc, band, X, Y, N, b, blocks, lowband,
                    duration, lowband_out, level, gain,
                    lowband_scratch, fill):
        f = self
        stereo = Y is not None
        split = stereo
        imid = iside = 0
        N0 = N
        X0 = X                            # full band (tail ops span N0)
        N_B = N // blocks
        N_B0 = N_B
        B0 = blocks
        time_divide = 0
        recombine = 0
        inv = 0
        mid = side = 0.0
        longblocks = B0 == 1
        cm = 0

        if N == 1:
            xs = [X] + ([Y] if stereo else [])
            for x in xs:
                sign = 0
                if f.remaining2 >= 1 << 3:
                    sign = rc.get_raw(1)
                    f.remaining2 -= 1 << 3
                x[0] = 1.0 - 2.0 * sign
            if lowband_out is not None:
                lowband_out[0] = X[0]
            return 1

        if not stereo and level == 0:
            tf_change = f.tf_change[band]
            if tf_change > 0:
                recombine = tf_change
            if lowband is not None and \
                    (recombine or ((N_B & 1) == 0 and tf_change < 0)
                     or B0 > 1):
                scratch = lowband[:N].copy()
                lowband = scratch
            for k in range(recombine):
                if lowband is not None:
                    _haar1(lowband, N >> k, 1 << k)
                fill = int(T.BIT_INTERLEAVE[fill & 0xF]) | \
                    int(T.BIT_INTERLEAVE[fill >> 4]) << 2
            blocks >>= recombine
            N_B <<= recombine
            while (N_B & 1) == 0 and tf_change < 0:
                if lowband is not None:
                    _haar1(lowband, N_B, blocks)
                fill |= fill << blocks
                blocks <<= 1
                N_B >>= 1
                time_divide += 1
                tf_change += 1
            B0 = blocks
            N_B0 = N_B
            if B0 > 1 and lowband is not None:
                _deinterleave_hadamard(lowband, N_B >> recombine,
                                       B0 << recombine, longblocks)

        cache_off = int(T.CACHE_INDEX[(duration + 1) * MAX_BANDS
                                      + band])
        cache = T.CACHE_BITS[cache_off:]
        if not stereo and duration >= 0 and \
                b > int(cache[int(cache[0])]) + 12 and N > 2:
            N >>= 1
            Y = X[N:]
            X = X[:N]
            split = 1
            duration -= 1
            if blocks == 1:
                fill = (fill & 1) | (fill << 1)
            blocks = (blocks + 1) >> 1

        if split:
            itheta = 0
            pulse_cap = int(T.LOG_FREQ_RANGE[band]) + duration * 8
            offset = (pulse_cap >> 1) - \
                (QTHETA_OFFSET_TWOPHASE if stereo and N == 2
                 else QTHETA_OFFSET)
            qn = 1 if (stereo and band >= f.intensity_stereo) else \
                _compute_qn(N, b, offset, pulse_cap, stereo)
            tell = rc.tell_frac()
            if qn != 1:
                if stereo and N > 2:
                    itheta = rc.dec_uint_step(qn // 2)
                elif stereo or B0 > 1:
                    itheta = rc.dec_uint(qn + 1)
                else:
                    itheta = rc.dec_uint_tri(qn)
                itheta = itheta * 16384 // qn
            elif stereo:
                inv = rc.dec_log(2) if (b > 2 << 3 and
                                        f.remaining2 > 2 << 3) else 0
                if not f.apply_phase_inv:
                    inv = 0
                itheta = 0
            qalloc = rc.tell_frac() - tell
            b -= qalloc

            orig_fill = fill
            if itheta == 0:
                imid = 32767
                iside = 0
                fill &= (1 << blocks) - 1
                delta = -16384
            elif itheta == 16384:
                imid = 0
                iside = 32767
                fill &= ((1 << blocks) - 1) << blocks
                delta = 16384
            else:
                imid = _celt_cos(itheta)
                iside = _celt_cos(16384 - itheta)
                delta = _round_mul16((N - 1) << 7,
                                     _log2tan(iside, imid))
            mid = imid / 32768.0
            side = iside / 32768.0

            if N == 2 and stereo:
                mbits = b
                sbits = (1 << 3) if (itheta != 0 and itheta != 16384) \
                    else 0
                mbits -= sbits
                c = itheta > 8192
                f.remaining2 -= qalloc + sbits
                x2 = Y if c else X
                y2 = X if c else Y
                sign = rc.get_raw(1) if sbits else 0
                sign = 1 - 2 * sign
                cm = self._quant_band(rc, band, x2, None, N, mbits,
                                      blocks, lowband, duration,
                                      lowband_out, level, gain,
                                      lowband_scratch, orig_fill)
                y2[0] = -sign * x2[1]
                y2[1] = sign * x2[0]
                X *= mid
                Y *= side
                tmp0, tmp1 = X[0], X[1]
                X[0] = tmp0 - Y[0]
                Y[0] = tmp0 + Y[0]
                X[1] = tmp1 - Y[1]
                Y[1] = tmp1 + Y[1]
            else:
                next_lowband2 = None
                next_lowband_out1 = None
                next_level = 0
                if B0 > 1 and not stereo and (itheta & 0x3FFF):
                    if itheta > 8192:
                        delta -= delta >> (4 - duration)
                    else:
                        delta = min(0, delta
                                    + (N << 3 >> (5 - duration)))
                mbits = max(0, min(_tdiv(b - delta, 2), b))
                sbits = b - mbits
                f.remaining2 -= qalloc
                if lowband is not None and not stereo:
                    next_lowband2 = lowband[N:]
                if stereo:
                    next_lowband_out1 = lowband_out
                else:
                    next_level = level + 1
                rebalance = f.remaining2
                if mbits >= sbits:
                    cm = self._quant_band(
                        rc, band, X, None, N, mbits, blocks, lowband,
                        duration, next_lowband_out1, next_level,
                        1.0 if stereo else gain * mid,
                        lowband_scratch, fill)
                    rebalance = mbits - (rebalance - f.remaining2)
                    if rebalance > 3 << 3 and itheta != 0:
                        sbits += rebalance - (3 << 3)
                    cmt = self._quant_band(
                        rc, band, Y, None, N, sbits, blocks,
                        next_lowband2, duration, None, next_level,
                        gain * side, None, fill >> blocks)
                    cm |= cmt << ((B0 >> 1) & (int(stereo) - 1))
                else:
                    cm = self._quant_band(
                        rc, band, Y, None, N, sbits, blocks,
                        next_lowband2, duration, None, next_level,
                        gain * side, None, fill >> blocks)
                    cm <<= (B0 >> 1) & (int(stereo) - 1)
                    rebalance = sbits - (rebalance - f.remaining2)
                    if rebalance > 3 << 3 and itheta != 16384:
                        mbits += rebalance - (3 << 3)
                    cm |= self._quant_band(
                        rc, band, X, None, N, mbits, blocks, lowband,
                        duration, next_lowband_out1, next_level,
                        1.0 if stereo else gain * mid,
                        lowband_scratch, fill)
        else:
            q = _bits2pulses(cache, b)
            curr_bits = _pulses2bits(cache, q)
            f.remaining2 -= curr_bits
            while f.remaining2 < 0 and q > 0:
                f.remaining2 += curr_bits
                q -= 1
                curr_bits = _pulses2bits(cache, q)
                f.remaining2 -= curr_bits
            if q != 0:
                k = q if q < 8 else (8 + (q & 7)) << ((q >> 3) - 1)
                cm = self._alg_unquant(rc, X, N, k, f.spread, blocks,
                                       gain)
            else:
                cm_mask = (1 << blocks) - 1
                fill &= cm_mask
                if fill:
                    if lowband is None:
                        for i in range(N):
                            r = self._rng()
                            if r >= 0x80000000:
                                r -= 0x100000000
                            X[i] = float(r >> 20)
                        cm = cm_mask
                    else:
                        for i in range(N):
                            X[i] = lowband[i] + \
                                (1.0 / 256 if self._rng() & 0x8000
                                 else -1.0 / 256)
                        cm = fill
                    _renormalize(X, N, gain)
                else:
                    X[:N] = 0

        if stereo:
            if N > 2:
                _stereo_merge(X, Y, mid, N)
            if inv:
                Y[:N] *= -1
        elif level == 0:
            if B0 > 1:
                _interleave_hadamard(X0, N_B >> recombine,
                                     B0 << recombine, longblocks)
            N_B = N_B0
            blocks = B0
            for k in range(time_divide):
                blocks >>= 1
                N_B <<= 1
                cm |= cm >> blocks
                _haar1(X0, N_B, blocks)
            for k in range(recombine):
                cm = int(T.BIT_DEINTERLEAVE[cm])
                _haar1(X0, N0 >> k, 1 << k)
            blocks <<= recombine
            if lowband_out is not None:
                n = math.sqrt(N0)
                lowband_out[:N0] = n * X0[:N0]
            cm &= (1 << blocks) - 1
        return cm

    def _alg_unquant(self, rc, X, N, K, spread, blocks, gain):
        idx = rc.dec_uint(_pvq_v(N, K))
        y, norm = _cwrsi(N, K, idx)
        gain /= math.sqrt(norm)
        X[:N] = gain * np.asarray(y, np.float64)
        _exp_rotation(X, N, blocks, K, spread)
        return _collapse_mask(y, N, blocks)

    # -- post ---------------------------------------------------------------
    def _anticollapse(self, block):
        f = self
        for i in range(f.start_band, f.end_band):
            renorm = False
            depth = (1 + f.pulses[i]) // (int(T.FREQ_RANGE[i])
                                          << f.size)
            thresh = 2.0 ** (-1.0 - 0.125 * depth)
            sqrt_1 = 1.0 / math.sqrt(int(T.FREQ_RANGE[i]) << f.size)
            off = int(T.FREQ_BANDS[i]) << f.size
            nb = int(T.FREQ_RANGE[i])
            prev0 = block.prev_energy[0][i]
            prev1 = block.prev_energy[1][i]
            if f.channels == 1:
                b1 = self.block[1]
                prev0 = max(prev0, b1.prev_energy[0][i])
                prev1 = max(prev1, b1.prev_energy[1][i])
            ediff = max(0.0, block.energy[i] - min(prev0, prev1))
            r = 2.0 ** (1 - ediff)
            if f.size == 3:
                r *= math.sqrt(2)
            r = min(thresh, r) * sqrt_1
            for k in range(1 << f.size):
                if not (int(block.collapse_masks[i]) & (1 << k)):
                    for j in range(nb):
                        block.coeffs[off + (j << f.size) + k] = \
                            r if self._rng() & 0x8000 else -r
                    renorm = True
            if renorm:
                seg = block.coeffs[off:off + (nb << f.size)]
                _renormalize(seg, nb << f.size, 1.0)

    def _denormalize(self, block):
        f = self
        for i in range(f.start_band, f.end_band):
            off = int(T.FREQ_BANDS[i]) << f.size
            n = int(T.FREQ_RANGE[i]) << f.size
            log_norm = block.energy[i] + float(T.MEAN_ENERGY[i])
            norm = 2.0 ** min(log_norm, 32.0)
            block.lin_energy[i] = norm
            block.coeffs[off:off + n] *= norm

    def _postfilter(self, block, frame_size):
        f = self
        length = f.blocksize * f.blocks
        self._pf_transition(block, 1024)
        block.pf_period_old = block.pf_period
        block.pf_gains_old = block.pf_gains.copy()
        block.pf_period = block.pf_period_new
        block.pf_gains = block.pf_gains_new.copy()
        if length > OVERLAP:
            self._pf_transition(block, 1024 + OVERLAP)
            if block.pf_gains[0] > 1e-7 and length - 2 * OVERLAP > 0:
                self._pf_apply(block, 1024 + 2 * OVERLAP,
                               length - 2 * OVERLAP)
            block.pf_period_old = block.pf_period
            block.pf_gains_old = block.pf_gains.copy()
        block.buf[:1024 + OVERLAP // 2] = \
            block.buf[length:length + 1024 + OVERLAP // 2]

    def _pf_transition(self, block, off):
        t0 = block.pf_period_old
        t1 = block.pf_period
        g0 = block.pf_gains_old
        g1 = block.pf_gains
        if g1[0] == 0.0 and g0[0] == 0.0:
            return
        data = block.buf
        x1 = data[off - t1 + 1]
        x2 = data[off - t1]
        x3 = data[off - t1 - 1]
        x4 = data[off - t1 - 2]
        for i in range(OVERLAP):
            w = float(T.WINDOW2[i])
            x0 = data[off + i - t1 + 2]
            data[off + i] += \
                (1.0 - w) * g0[0] * data[off + i - t0] + \
                (1.0 - w) * g0[1] * (data[off + i - t0 - 1]
                                     + data[off + i - t0 + 1]) + \
                (1.0 - w) * g0[2] * (data[off + i - t0 - 2]
                                     + data[off + i - t0 + 2]) + \
                w * g1[0] * x2 + \
                w * g1[1] * (x1 + x3) + \
                w * g1[2] * (x0 + x4)
            x4 = x3
            x3 = x2
            x2 = x1
            x1 = x0

    def _pf_apply(self, block, off, length):
        period = block.pf_period
        g = block.pf_gains
        data = block.buf
        x4 = data[off - period - 2]
        x3 = data[off - period - 1]
        x2 = data[off - period]
        x1 = data[off - period + 1]
        for i in range(length):
            x0 = data[off + i - period + 2]
            data[off + i] += g[0] * x2 + g[1] * (x1 + x3) + \
                g[2] * (x0 + x4)
            x4 = x3
            x3 = x2
            x2 = x1
            x1 = x0


# ---------------------------------------------------------------------------
# PVQ helpers (pvq.c)


def _celt_cos(x):
    x = ((x * x) + 4096) >> 13
    x = (32767 - x) + _round_mul16(
        x, -7651 + _round_mul16(x, 8277 + _round_mul16(-626, x)))
    return x + 1


def _round_mul16(a, b):
    return (a * b + 16384) >> 15


def _log2tan(isin, icos):
    lc = ilog(icos)
    ls = ilog(isin)
    icos <<= 15 - lc
    isin <<= 15 - ls
    return (ls << 11) - (lc << 11) + \
        _round_mul16(isin, _round_mul16(isin, -2597) + 7932) - \
        _round_mul16(icos, _round_mul16(icos, -2597) + 7932)


def _bits2pulses(cache, bits):
    low, high = 0, int(cache[0])
    bits -= 1
    for _ in range(6):
        center = (low + high + 1) >> 1
        if int(cache[center]) >= bits:
            high = center
        else:
            low = center
    lo_bits = -1 if low == 0 else int(cache[low])
    return low if bits - lo_bits <= int(cache[high]) - bits else high


def _pulses2bits(cache, pulses):
    return 0 if pulses == 0 else int(cache[pulses]) + 1


def _compute_qn(N, b, offset, pulse_cap, stereo):
    N2 = 2 * N - 1
    if stereo and N == 2:
        N2 -= 1
    qb = min(b - pulse_cap - (4 << 3), (b + N2 * offset) // N2,
             8 << 3)
    if qb < (1 << 3 >> 1):
        return 1
    qn = ((int(T.QN_EXP2[qb & 0x7]) >> (14 - (qb >> 3))) + 1) >> 1 << 1
    return qn


def _cwrsi(N, K, i):
    """Index → pulse vector (pvq.c celt_cwrsi). Returns (y, norm)."""
    y = []
    norm = 0

    def U(n, k):
        return _pvq_u(n, k)

    while N > 2:
        if K >= N:
            p = U(N, K + 1)
            s = -1 if i >= p else 0
            if s:
                i -= p
            k0 = K
            q = U(N, N)
            if q > i:
                K = N
                while True:
                    K -= 1
                    p = U(N, K)
                    if p <= i:
                        break
            else:
                p = U(N, K)
                while p > i:
                    K -= 1
                    p = U(N, K)
            i -= p
            val = (k0 - K + s) ^ s
            norm += val * val
            y.append(val)
        else:
            p = U(N, K)
            q = U(N, K + 1)
            if p <= i < q:
                i -= p
                y.append(0)
            else:
                s = -1 if i >= q else 0
                if s:
                    i -= q
                k0 = K
                while True:
                    K -= 1
                    p = U(N, K)
                    if p <= i:
                        break
                i -= p
                val = (k0 - K + s) ^ s
                norm += val * val
                y.append(val)
        N -= 1
    # N == 2
    p = 2 * K + 1
    s = -1 if i >= p else 0
    if s:
        i -= p
    k0 = K
    K = (i + 1) // 2
    if K:
        i -= 2 * K - 1
    val = (k0 - K + s) ^ s
    norm += val * val
    y.append(val)
    # N == 1
    s = -i
    val = (K + s) ^ s
    norm += val * val
    y.append(val)
    return y, max(norm, 1e-15)


def _exp_rotation_impl(X, off, length, stride, c, s):
    for i in range(length - stride):
        x1 = X[off + i]
        x2 = X[off + i + stride]
        X[off + i + stride] = c * x2 + s * x1
        X[off + i] = c * x1 - s * x2
    for i in range(length - 2 * stride - 1, -1, -1):
        x1 = X[off + i]
        x2 = X[off + i + stride]
        X[off + i + stride] = c * x2 + s * x1
        X[off + i] = c * x1 - s * x2


def _exp_rotation(X, length, stride, K, spread):
    if 2 * K >= length or spread == SPREAD_NONE:
        return
    gain = length / (length + (20 - 5 * spread) * K)
    theta = math.pi * gain * gain / 4
    c = math.cos(theta)
    s = math.sin(theta)
    stride2 = 0
    if length >= stride << 3:
        stride2 = 1
        while (stride2 * stride2 + stride2) * stride + \
                (stride >> 2) < length:
            stride2 += 1
    length //= stride
    for i in range(stride):
        if stride2:
            _exp_rotation_impl(X, i * length, length, stride2, s, c)
        _exp_rotation_impl(X, i * length, length, 1, c, s)


def _collapse_mask(y, N, B):
    if B <= 1:
        return 1
    N0 = N // B
    mask = 0
    for i in range(B):
        for j in range(N0):
            if y[i * N0 + j]:
                mask |= 1 << i
    return mask


def _stereo_merge(X, Y, mid, N):
    xp = float(np.dot(X[:N], Y[:N])) * mid
    side = float(np.dot(Y[:N], Y[:N]))
    e0 = mid * mid + side - 2 * xp
    e1 = mid * mid + side + 2 * xp
    if e0 < 6e-4 or e1 < 6e-4:
        Y[:N] = X[:N]
        return
    g0 = 1.0 / math.sqrt(e0)
    g1 = 1.0 / math.sqrt(e1)
    for i in range(N):
        v0 = mid * X[i]
        v1 = Y[i]
        X[i] = g0 * (v0 - v1)
        Y[i] = g1 * (v0 + v1)


def _haar1(X, N0, stride):
    s = math.sqrt(0.5)
    N0 >>= 1
    for i in range(stride):
        for j in range(N0):
            a = X[stride * (2 * j) + i]
            b = X[stride * (2 * j + 1) + i]
            X[stride * (2 * j) + i] = (a + b) * s
            X[stride * (2 * j + 1) + i] = (a - b) * s


def _hadamard_order(stride, hadamard):
    base = stride - 2 if hadamard else 30
    return T.HADAMARD_ORDER[base:base + stride]


def _interleave_hadamard(X, N0, stride, hadamard):
    order = _hadamard_order(stride, hadamard)
    N = N0 * stride
    tmp = np.empty(N)
    for i in range(stride):
        for j in range(N0):
            tmp[j * stride + i] = X[int(order[i]) * N0 + j]
    X[:N] = tmp


def _deinterleave_hadamard(X, N0, stride, hadamard):
    order = _hadamard_order(stride, hadamard)
    N = N0 * stride
    tmp = np.empty(N)
    for i in range(stride):
        for j in range(N0):
            tmp[int(order[i]) * N0 + j] = X[j * stride + i]
    X[:N] = tmp


def _renormalize(X, N, gain):
    g = 1e-15 + float(np.dot(X[:N], X[:N]))
    X[:N] *= gain / math.sqrt(g)
