"""Opus SILK decoder (RFC 6716 §4.2; reference:
libavcodec/opus/silk.c).  The LP layer of Opus: range-coded gains,
NLSF codebooks with fixed-point LSF→LPC conversion, long-term
prediction with 5-tap filters, and shell-coded excitation, followed
by float LTP+LPC synthesis at 8/12/16 kHz.

The fixed-point sections (LSF stabilisation, LPC stability check,
bandwidth expansion) are exact integer ports; the synthesis runs in
float32 like the reference so the recursive filters track it
bit-closely.

A copy of ffmpeg_tpu/codecs/opus/silk.py, held equal to it by
tests/test_torch_host_copies.py.  Host code, as in the
JAX package: it imports neither torch nor the JAX package."""

from __future__ import annotations

import numpy as np

from . import tables_gen as T

SILK_HISTORY = 322
SILK_MAX_LAG = 288 + 2          # 288 + LTP_ORDER // 2
LTP_ORDER = 5

f32 = np.float32


def _i32(x):
    """wrap to int32"""
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


def _mulh(a, b):
    """high 32 bits of the signed 64-bit product"""
    return (a * b) >> 32


def _mull(a, b, s):
    return (a * b) >> s


def _round_mull(a, b, s):
    return (((a * b) >> (s - 1)) + 1) >> 1


def _i16(x):
    """wrap to int16 (the reference stores Q12 LPCs in int16_t and
    relies on wraparound when the quirky maxabs scan fails to clamp)"""
    x &= 0xFFFF
    return x - 0x10000 if x >= 0x8000 else x


def _sat_sub32(a, b):
    v = a - b
    return max(-0x80000000, min(0x7FFFFFFF, v))


def _ilog(x):
    n = 0
    while x > 0:
        n += 1
        x >>= 1
    return n


class SilkFrame:
    def __init__(self):
        self.coded = 0
        self.log_gain = 0
        self.nlsf = np.zeros(16, np.int16)
        self.lpc = np.zeros(16, f32)
        self.output = np.zeros(2 * SILK_HISTORY, f32)
        self.lpc_history = np.zeros(2 * SILK_HISTORY, f32)
        self.primarylag = 0
        self.prev_voiced = 0

    def flush(self):
        if not self.coded:
            return
        self.output[:] = 0
        self.lpc_history[:] = 0
        self.lpc[:] = 0
        self.nlsf[:] = 0
        self.log_gain = 0
        self.primarylag = 0
        self.prev_voiced = 0
        self.coded = 0


def _stabilize_lsf(nlsf, order, min_delta):
    for _ in range(20):
        min_diff = 0
        k = 0
        for i in range(order + 1):
            low = int(nlsf[i - 1]) if i != 0 else 0
            high = int(nlsf[i]) if i != order else 32768
            diff = (high - low) - int(min_delta[i])
            if diff < min_diff:
                min_diff = diff
                k = i
        if min_diff == 0:
            return
        if k == 0:
            nlsf[0] = int(min_delta[0])
        elif k == order:
            nlsf[order - 1] = 32768 - int(min_delta[order])
        else:
            min_center = 0
            max_center = 32768
            for i in range(k):
                min_center += int(min_delta[i])
            min_center += int(min_delta[k]) >> 1
            for i in range(order, k, -1):
                max_center -= int(min_delta[i])
            max_center -= int(min_delta[k]) >> 1
            center_val = int(nlsf[k - 1]) + int(nlsf[k])
            center_val = (center_val >> 1) + (center_val & 1)
            center_val = min(max_center, max(min_center, center_val))
            nlsf[k - 1] = center_val - (int(min_delta[k]) >> 1)
            nlsf[k] = int(nlsf[k - 1]) + int(min_delta[k])
    # fallback: sort + push apart
    vals = sorted(int(v) for v in nlsf[:order])
    for i, v in enumerate(vals):
        nlsf[i] = v
    if nlsf[0] < int(min_delta[0]):
        nlsf[0] = int(min_delta[0])
    for i in range(1, order):
        nlsf[i] = max(int(nlsf[i]),
                      min(int(nlsf[i - 1]) + int(min_delta[i]), 32767))
    if nlsf[order - 1] > 32768 - int(min_delta[order]):
        nlsf[order - 1] = 32768 - int(min_delta[order])
    for i in range(order - 2, -1, -1):
        if nlsf[i] > int(nlsf[i + 1]) - int(min_delta[i + 1]):
            nlsf[i] = int(nlsf[i + 1]) - int(min_delta[i + 1])


def _is_lpc_stable(lpc, order):
    dc_resp = 0
    row = [0] * 16
    prevrow = None
    totalinvgain = 1 << 30
    for k in range(order):
        dc_resp += int(lpc[k])
        row[k] = int(lpc[k]) * 4096
    if dc_resp >= 4096:
        return 0
    k = order - 1
    while True:
        if abs(row[k]) > 16773022:
            return 0
        rc = -(row[k] * 128)
        gaindiv = (1 << 30) - _mulh(rc, rc)
        totalinvgain = _i32(_mulh(totalinvgain, gaindiv) << 2)
        if k == 0:
            return int(totalinvgain >= 107374)
        fbits = _ilog(gaindiv)
        gain = ((1 << 29) - 1) // (gaindiv >> (fbits + 1 - 16))
        error = (1 << 29) - _mull(_i32(gaindiv << (15 + 16 - fbits)),
                                  gain, 16)
        # C evaluates error*gain in (wrapping) 32-bit int before the
        # shift
        gain = _i32(_i32(gain << 16) + (_i32(error * gain) >> 13))
        prevrow = list(row)
        for j in range(k):
            x = _sat_sub32(prevrow[j],
                           _round_mull(prevrow[k - j - 1], rc, 31))
            tmp = _round_mull(x, gain, fbits)
            if tmp < -0x80000000 or tmp > 0x7FFFFFFF:
                return 0
            row[j] = tmp
        k -= 1


def _lsp2poly(lsp, pol, half_order):
    pol[0] = 65536
    pol[1] = -lsp[0]
    for i in range(1, half_order):
        pol[i + 1] = pol[i - 1] * 2 - _round_mull(lsp[2 * i], pol[i],
                                                  16)
        for j in range(i, 1, -1):
            pol[j] += pol[j - 2] - _round_mull(lsp[2 * i], pol[j - 1],
                                               16)
        pol[1] -= lsp[2 * i]


def _lsf2lpc(nlsf, order):
    """→ float32 lpc coefficients (silk_lsf2lpc)."""
    lsp = [0] * 16
    ordering = T.SILK_LSF_ORDERING_NBMB if order == 10 else \
        T.SILK_LSF_ORDERING_WB
    for k in range(order):
        index = int(nlsf[k]) >> 8
        offset = int(nlsf[k]) & 255
        k2 = int(ordering[k])
        v = int(T.SILK_COSINE[index]) * 256
        v += (int(T.SILK_COSINE[index + 1]) -
              int(T.SILK_COSINE[index])) * offset
        lsp[k2] = (v + 4) >> 3
    p = [0] * 9
    q = [0] * 9
    _lsp2poly(lsp[0:], p, order >> 1)
    _lsp2poly(lsp[1:], q, order >> 1)
    lpc32 = [0] * 16
    for k in range(order >> 1):
        p_tmp = p[k + 1] + p[k]
        q_tmp = q[k + 1] - q[k]
        lpc32[k] = -q_tmp - p_tmp
        lpc32[order - k - 1] = q_tmp - p_tmp
    lpc = [0] * 16
    for i in range(10):
        maxabs = 0
        k = 0
        # quirk: the reference scans FFABS(lpc32[k]) — the index is
        # the running argmax, not j — so maxabs ends up |lpc32[0]|
        # (silk.c "limit the range" loop); replicated verbatim
        for j in range(order):
            x = abs(lpc32[k])
            if x > maxabs:
                maxabs = x
                k = j
        maxabs = (maxabs + 16) >> 5
        if maxabs > 32767:
            maxabs = min(maxabs, 163838)
            chirp_base = chirp = \
                65470 - ((maxabs - 32767) << 14) // ((maxabs * (k + 1)) >> 2)
            for k in range(order):
                lpc32[k] = _round_mull(lpc32[k], chirp, 16)
                chirp = (chirp_base * chirp + 32768) >> 16
        else:
            break
    else:
        i = 10
    if i == 10:
        for k in range(order):
            x = (lpc32[k] + 16) >> 5
            lpc[k] = max(-32768, min(32767, x))
            lpc32[k] = lpc[k] << 5
    else:
        for k in range(order):
            lpc[k] = _i16((lpc32[k] + 16) >> 5)
    i = 1
    while i <= 16 and not _is_lpc_stable(lpc, order):
        chirp_base = chirp = 65536 - (1 << i)
        for k in range(order):
            lpc32[k] = _round_mull(lpc32[k], chirp, 16)
            lpc[k] = _i16((lpc32[k] + 16) >> 5)
            chirp = (chirp_base * chirp + 32768) >> 16
        i += 1
    return np.array([c / 4096.0 for c in lpc[:order]], f32)


class SilkDecoder:
    """ff_silk_* (silk.c): stateful superframe decoder."""

    def __init__(self, output_channels: int):
        self.output_channels = output_channels
        self.frame = [SilkFrame(), SilkFrame()]
        self.prev_stereo_weights = np.zeros(2, f32)
        self.stereo_weights = np.zeros(2, f32)
        self.prev_coded_channels = 0
        self.midonly = 0
        self.subframes = 0
        self.sflength = 0
        self.flength = 0
        self.nlsf_interp_factor = 0
        self.bandwidth = 0
        self.wb = 0

    def flush(self):
        self.frame[0].flush()
        self.frame[1].flush()
        self.prev_stereo_weights[:] = 0

    # ---- parameter decode ---------------------------------------------

    def _decode_lpc(self, frame, rc, voiced):
        order = 16 if self.wb else 10
        lsf_i1 = rc.dec_cdf(T.SILK_MODEL_LSF_S1[self.wb][voiced])
        lsf_i2 = [0] * order
        sel = T.SILK_LSF_S2_MODEL_SEL_WB if self.wb else \
            T.SILK_LSF_S2_MODEL_SEL_NBMB
        for i in range(order):
            index = int(sel[lsf_i1][i])
            lsf_i2[i] = rc.dec_cdf(T.SILK_MODEL_LSF_S2[index]) - 4
            if lsf_i2[i] == -4:
                lsf_i2[i] -= rc.dec_cdf(T.SILK_MODEL_LSF_S2_EXT)
            elif lsf_i2[i] == 4:
                lsf_i2[i] += rc.dec_cdf(T.SILK_MODEL_LSF_S2_EXT)
        lsf_res = [0] * order
        qstep = 9830 if self.wb else 11796
        wsel = T.SILK_LSF_WEIGHT_SEL_WB if self.wb else \
            T.SILK_LSF_WEIGHT_SEL_NBMB
        wtab = T.SILK_LSF_PRED_WEIGHTS_WB if self.wb else \
            T.SILK_LSF_PRED_WEIGHTS_NBMB
        for i in range(order - 1, -1, -1):
            v = lsf_i2[i] * 1024
            if lsf_i2[i] < 0:
                v += 102
            elif lsf_i2[i] > 0:
                v -= 102
            v = (v * qstep) >> 16
            if i + 1 < order:
                weight = int(wtab[int(wsel[lsf_i1][i])][i])
                v += (lsf_res[i + 1] * weight) >> 8
            lsf_res[i] = v
        nlsf = np.zeros(16, np.int16)
        cb = T.SILK_LSF_CODEBOOK_WB if self.wb else \
            T.SILK_LSF_CODEBOOK_NBMB
        wmod = T.SILK_MODEL_LSF_WEIGHT_WB if self.wb else \
            T.SILK_MODEL_LSF_WEIGHT_NBMB
        for i in range(order):
            cur = int(cb[lsf_i1][i])
            weight = int(wmod[lsf_i1][i])
            # C division truncates toward zero (residual is signed)
            num = lsf_res[i] * 16384
            q = abs(num) // weight
            value = cur * 128 + (-q if num < 0 else q)
            nlsf[i] = max(0, min(32767, value))
        spacing = T.SILK_LSF_MIN_SPACING_WB if self.wb else \
            T.SILK_LSF_MIN_SPACING_NBMB
        _stabilize_lsf(nlsf, order, spacing)

        has_lpc_leadin = 0
        lpc_leadin = None
        if self.subframes == 4:
            offset = rc.dec_cdf(T.SILK_MODEL_LSF_INTERPOLATION_OFFSET)
            if offset != 4 and frame.coded:
                has_lpc_leadin = 1
                if offset != 0:
                    nlsf_leadin = np.zeros(16, np.int16)
                    for i in range(order):
                        nlsf_leadin[i] = int(frame.nlsf[i]) + \
                            ((int(nlsf[i]) - int(frame.nlsf[i])) *
                             offset >> 2)
                    lpc_leadin = _lsf2lpc(nlsf_leadin, order)
                else:
                    lpc_leadin = frame.lpc[:order].copy()
            else:
                offset = 4
            self.nlsf_interp_factor = offset
            lpc = _lsf2lpc(nlsf, order)
        else:
            self.nlsf_interp_factor = 4
            lpc = _lsf2lpc(nlsf, order)
        frame.nlsf[:order] = nlsf[:order]
        frame.lpc[:order] = lpc
        return lpc_leadin, lpc, order, has_lpc_leadin

    def _count_children(self, rc, model, total, child):
        if total != 0:
            off = ((total - 1 + 5) * (total - 1)) >> 1
            row = T.SILK_MODEL_PULSE_LOCATION[model]
            child[0] = rc.dec_cdf(row[off:])
            child[1] = total - child[0]
        else:
            child[0] = 0
            child[1] = 0

    def _decode_excitation(self, rc, qoffset_high, active, voiced):
        seed = rc.dec_cdf(T.SILK_MODEL_LCG_SEED)
        shellblocks = int(T.SILK_SHELL_BLOCKS[self.bandwidth]
                          [self.subframes >> 2])
        ratelevel = rc.dec_cdf(T.SILK_MODEL_EXC_RATE[voiced])
        pulsecount = [0] * 20
        lsbcount = [0] * 20
        for i in range(shellblocks):
            pulsecount[i] = rc.dec_cdf(
                T.SILK_MODEL_PULSE_COUNT[ratelevel])
            if pulsecount[i] == 17:
                while pulsecount[i] == 17:
                    lsbcount[i] += 1
                    if lsbcount[i] == 10:
                        break
                    pulsecount[i] = rc.dec_cdf(
                        T.SILK_MODEL_PULSE_COUNT[9])
                if lsbcount[i] == 10:
                    pulsecount[i] = rc.dec_cdf(
                        T.SILK_MODEL_PULSE_COUNT[10])
        excitation = [0] * 320
        for i in range(shellblocks):
            if pulsecount[i] == 0:
                continue
            loc = excitation
            base = 16 * i
            b1 = [0, 0]
            b2 = [0, 0]
            b3 = [0, 0]
            b4 = [0, 0]
            self._count_children(rc, 0, pulsecount[i], b1)
            pos = base
            for bidx in range(2):
                self._count_children(rc, 1, b1[bidx], b2)
                for cidx in range(2):
                    self._count_children(rc, 2, b2[cidx], b3)
                    for didx in range(2):
                        self._count_children(rc, 3, b3[didx], b4)
                        loc[pos] = b4[0]
                        loc[pos + 1] = b4[1]
                        pos += 2
        for i in range(shellblocks << 4):
            for _ in range(lsbcount[i >> 4]):
                excitation[i] = (excitation[i] << 1) | \
                    rc.dec_cdf(T.SILK_MODEL_EXCITATION_LSB)
        for i in range(shellblocks << 4):
            if excitation[i] != 0:
                sign = rc.dec_cdf(T.SILK_MODEL_EXCITATION_SIGN
                                  [active + voiced][qoffset_high]
                                  [min(pulsecount[i >> 4], 6)])
                if sign == 0:
                    excitation[i] *= -1
        out = np.zeros(shellblocks << 4, f32)
        qoff = int(T.SILK_QUANT_OFFSET[voiced][qoffset_high])
        for i in range(shellblocks << 4):
            value = excitation[i]
            ex = value * 256 | qoff
            if value < 0:
                ex += 20
            elif value > 0:
                ex -= 20
            seed = (196314165 * seed + 907633515) & 0xFFFFFFFF
            if seed & 0x80000000:
                ex *= -1
            seed = (seed + value) & 0xFFFFFFFF
            out[i] = f32(ex / 8388608.0)
        return out

    # ---- frame decode -------------------------------------------------

    def _decode_frame(self, rc, frame_num, channel, coded_channels,
                      active, active1, redundant):
        frame = self.frame[channel]
        if coded_channels == 2 and channel == 0:
            n = rc.dec_cdf(T.SILK_MODEL_STEREO_S1)
            wi0 = rc.dec_cdf(T.SILK_MODEL_STEREO_S2) + 3 * (n // 5)
            ws0 = rc.dec_cdf(T.SILK_MODEL_STEREO_S3)
            wi1 = rc.dec_cdf(T.SILK_MODEL_STEREO_S2) + 3 * (n % 5)
            ws1 = rc.dec_cdf(T.SILK_MODEL_STEREO_S3)
            w = [0, 0]
            for i, (wi, ws) in enumerate(((wi0, ws0), (wi1, ws1))):
                w[i] = int(T.SILK_STEREO_WEIGHTS[wi]) + \
                    (((int(T.SILK_STEREO_WEIGHTS[wi + 1]) -
                       int(T.SILK_STEREO_WEIGHTS[wi])) * 6554) >> 16) \
                    * (ws * 2 + 1)
            self.stereo_weights[0] = f32((w[0] - w[1]) / 8192.0)
            self.stereo_weights[1] = f32(w[1] / 8192.0)
            if active1:
                self.midonly = 0
            else:
                self.midonly = rc.dec_cdf(T.SILK_MODEL_MID_ONLY)
        if not active:
            qoffset_high = rc.dec_cdf(
                T.SILK_MODEL_FRAME_TYPE_INACTIVE)
            voiced = 0
        else:
            typ = rc.dec_cdf(T.SILK_MODEL_FRAME_TYPE_ACTIVE)
            qoffset_high = typ & 1
            voiced = typ >> 1

        sf_gain = [0.0] * 4
        sf_pitchlag = [0] * 4
        sf_ltptaps = [None] * 4
        for i in range(self.subframes):
            if i == 0 and (frame_num == 0 or not frame.coded):
                x = rc.dec_cdf(
                    T.SILK_MODEL_GAIN_HIGHBITS[active + voiced])
                log_gain = (x << 3) | rc.dec_cdf(
                    T.SILK_MODEL_GAIN_LOWBITS)
                if frame.coded:
                    log_gain = max(log_gain, frame.log_gain - 16)
            else:
                delta_gain = rc.dec_cdf(T.SILK_MODEL_GAIN_DELTA)
                log_gain = max((delta_gain << 1) - 16,
                               frame.log_gain + delta_gain - 4)
                log_gain = max(0, min(63, log_gain))
            frame.log_gain = log_gain
            lg = (log_gain * 0x1D1C71 >> 16) + 2090
            ipart = lg >> 7
            fpart = lg & 127
            lingain = (1 << ipart) + \
                ((-174 * fpart * (128 - fpart) >> 16) + fpart) * \
                ((1 << ipart) >> 7)
            sf_gain[i] = f32(lingain / 65536.0)

        lpc_leadin, lpc_body, order, has_lpc_leadin = \
            self._decode_lpc(frame, rc, voiced)

        if voiced:
            lag_absolute = (not frame_num) or (not frame.prev_voiced)
            primarylag = 0
            if not lag_absolute:
                delta = rc.dec_cdf(T.SILK_MODEL_PITCH_DELTA)
                if delta:
                    primarylag = frame.primarylag + delta - 9
                else:
                    lag_absolute = True
            if lag_absolute:
                models = [T.SILK_MODEL_PITCH_LOWBITS_NB,
                          T.SILK_MODEL_PITCH_LOWBITS_MB,
                          T.SILK_MODEL_PITCH_LOWBITS_WB]
                highbits = rc.dec_cdf(T.SILK_MODEL_PITCH_HIGHBITS)
                lowbits = rc.dec_cdf(models[self.bandwidth])
                primarylag = int(T.SILK_PITCH_MIN_LAG[self.bandwidth]) + \
                    highbits * int(T.SILK_PITCH_SCALE[self.bandwidth]) + \
                    lowbits
            frame.primarylag = primarylag
            if self.subframes == 2:
                if self.bandwidth == 0:
                    offsets = T.SILK_PITCH_OFFSET_NB10MS[
                        rc.dec_cdf(T.SILK_MODEL_PITCH_CONTOUR_NB10MS)]
                else:
                    offsets = T.SILK_PITCH_OFFSET_MBWB10MS[
                        rc.dec_cdf(
                            T.SILK_MODEL_PITCH_CONTOUR_MBWB10MS)]
            else:
                if self.bandwidth == 0:
                    offsets = T.SILK_PITCH_OFFSET_NB20MS[
                        rc.dec_cdf(T.SILK_MODEL_PITCH_CONTOUR_NB20MS)]
                else:
                    offsets = T.SILK_PITCH_OFFSET_MBWB20MS[
                        rc.dec_cdf(
                            T.SILK_MODEL_PITCH_CONTOUR_MBWB20MS)]
            mn = int(T.SILK_PITCH_MIN_LAG[self.bandwidth])
            mx = int(T.SILK_PITCH_MAX_LAG[self.bandwidth])
            for i in range(self.subframes):
                sf_pitchlag[i] = max(mn, min(mx,
                                             primarylag +
                                             int(offsets[i])))
            ltpfilter = rc.dec_cdf(T.SILK_MODEL_LTP_FILTER)
            sels = [T.SILK_MODEL_LTP_FILTER0_SEL,
                    T.SILK_MODEL_LTP_FILTER1_SEL,
                    T.SILK_MODEL_LTP_FILTER2_SEL]
            taps = [T.SILK_LTP_FILTER0_TAPS, T.SILK_LTP_FILTER1_TAPS,
                    T.SILK_LTP_FILTER2_TAPS]
            for i in range(self.subframes):
                index = rc.dec_cdf(sels[ltpfilter])
                sf_ltptaps[i] = np.array(
                    [int(t) / 128.0 for t in taps[ltpfilter][index]],
                    f32)

        if voiced and frame_num == 0:
            ltpscale = f32(int(T.SILK_LTP_SCALE_FACTOR[
                rc.dec_cdf(T.SILK_MODEL_LTP_SCALE_INDEX)]) / 16384.0)
        else:
            ltpscale = f32(15565.0 / 16384.0)

        residual = np.zeros(SILK_MAX_LAG + SILK_HISTORY, f32)
        exc = self._decode_excitation(rc, qoffset_high, active,
                                      voiced)
        residual[SILK_MAX_LAG:SILK_MAX_LAG + len(exc)] = exc

        if self.output_channels == channel or redundant:
            return

        # synthesis (float32, reference op order)
        for i in range(self.subframes):
            lpc_coeff = lpc_leadin if (i < 2 and has_lpc_leadin) \
                else lpc_body
            dst_off = SILK_HISTORY + i * self.sflength
            res_off = SILK_MAX_LAG + i * self.sflength
            lpc_off = SILK_HISTORY + i * self.sflength
            out = frame.output
            lpch = frame.lpc_history
            if voiced:
                if i < 2 or self.nlsf_interp_factor == 4:
                    out_end = -i * self.sflength
                    scale = ltpscale
                else:
                    out_end = -(i - 2) * self.sflength
                    scale = f32(1.0)
                for j in range(-sf_pitchlag[i] - LTP_ORDER // 2,
                               out_end):
                    s = out[dst_off + j]
                    for k in range(order):
                        s = f32(s - f32(lpc_coeff[k] *
                                        out[dst_off + j - k - 1]))
                    s = min(f32(1.0), max(f32(-1.0), s))
                    residual[res_off + j] = f32(f32(s * scale) /
                                                sf_gain[i])
                if out_end:
                    rescale = f32(sf_gain[i - 1] / sf_gain[i])
                    for j in range(out_end, 0):
                        residual[res_off + j] = \
                            f32(residual[res_off + j] * rescale)
                for j in range(self.sflength):
                    s = residual[res_off + j]
                    base = res_off + j - sf_pitchlag[i] + \
                        LTP_ORDER // 2
                    for k in range(LTP_ORDER):
                        s = f32(s + f32(sf_ltptaps[i][k] *
                                        residual[base - k]))
                    residual[res_off + j] = s
            for j in range(self.sflength):
                s = f32(residual[res_off + j] * sf_gain[i])
                for k in range(1, order + 1):
                    s = f32(s + f32(lpc_coeff[k - 1] *
                                    lpch[lpc_off + j - k]))
                lpch[lpc_off + j] = s
                out[dst_off + j] = min(f32(1.0), max(f32(-1.0), s))

        frame.prev_voiced = voiced
        frame.lpc_history[:SILK_HISTORY] = \
            frame.lpc_history[self.flength:
                              self.flength + SILK_HISTORY]
        frame.output[:SILK_HISTORY] = \
            frame.output[self.flength:self.flength + SILK_HISTORY]
        frame.coded = 1

    def _unmix_ms(self, l, r):
        flen = self.flength
        mid = self.frame[0].output
        side = self.frame[1].output
        moff = SILK_HISTORY - flen
        soff = SILK_HISTORY - flen
        w0_prev = f32(self.prev_stereo_weights[0])
        w1_prev = f32(self.prev_stereo_weights[1])
        w0 = f32(self.stereo_weights[0])
        w1 = f32(self.stereo_weights[1])
        n1 = int(T.SILK_STEREO_INTERP_LEN[self.bandwidth])
        for i in range(n1):
            interp0 = f32(w0_prev + f32(i * f32(w0 - w0_prev) / n1))
            interp1 = f32(w1_prev + f32(i * f32(w1 - w1_prev) / n1))
            p0 = f32(0.25) * f32(f32(mid[moff + i - 2] +
                                     2 * mid[moff + i - 1]) +
                                 mid[moff + i])
            lv = f32(f32(f32(1 + interp1) * mid[moff + i - 1]) +
                     side[soff + i - 1] + f32(interp0 * p0))
            rv = f32(f32(f32(1 - interp1) * mid[moff + i - 1]) -
                     side[soff + i - 1] - f32(interp0 * p0))
            l[i] = min(f32(1.0), max(f32(-1.0), lv))
            r[i] = min(f32(1.0), max(f32(-1.0), rv))
        for i in range(n1, flen):
            p0 = f32(0.25) * f32(f32(mid[moff + i - 2] +
                                     2 * mid[moff + i - 1]) +
                                 mid[moff + i])
            lv = f32(f32(f32(1 + w1) * mid[moff + i - 1]) +
                     side[soff + i - 1] + f32(w0 * p0))
            rv = f32(f32(f32(1 - w1) * mid[moff + i - 1]) -
                     side[soff + i - 1] - f32(w0 * p0))
            l[i] = min(f32(1.0), max(f32(-1.0), lv))
            r[i] = min(f32(1.0), max(f32(-1.0), rv))
        self.prev_stereo_weights[:] = self.stereo_weights

    def decode_superframe(self, rc, output, bandwidth, coded_channels,
                          duration_ms):
        """output: list of np arrays (n,) float32 per output channel.
        → samples per channel."""
        nb_frames = 1 + (duration_ms > 20) + (duration_ms > 40)
        self.subframes = duration_ms // nb_frames // 5
        self.sflength = 20 * (bandwidth + 2)
        self.flength = self.sflength * self.subframes
        self.bandwidth = bandwidth
        self.wb = 1 if bandwidth == 2 else 0

        if coded_channels > self.prev_coded_channels:
            self.frame[1].flush()
        self.prev_coded_channels = coded_channels

        active = [[0] * 6, [0] * 6]
        redundancy = [0, 0]
        for i in range(coded_channels):
            for j in range(nb_frames):
                active[i][j] = rc.dec_log(1)
            redundancy[i] = rc.dec_log(1)
        for i in range(coded_channels):
            if redundancy[i] and duration_ms > 20:
                redundancy[i] = rc.dec_cdf(
                    T.SILK_MODEL_LBRR_FLAGS_40 if duration_ms == 40
                    else T.SILK_MODEL_LBRR_FLAGS_60)
        for i in range(nb_frames):
            for j in range(coded_channels):
                if redundancy[j] & (1 << i):
                    active1 = 0 if (j == 0 and
                                    not (redundancy[1] & (1 << i))) \
                        else 1
                    self._decode_frame(rc, i, j, coded_channels, 1,
                                       active1, 1)
            self.midonly = 0
        for i in range(nb_frames):
            for j in range(coded_channels):
                if self.midonly:
                    break
                active1 = active[1][i] if coded_channels > 1 else 0
                self._decode_frame(rc, i, j, coded_channels,
                                   active[j][i], active1, 0)
            if self.midonly and self.frame[1].coded:
                self.frame[1].flush()
            if coded_channels == 1 or self.output_channels == 1:
                src = self.frame[0].output[
                    SILK_HISTORY - self.flength - 2:
                    SILK_HISTORY - 2]
                for j in range(self.output_channels):
                    output[j][i * self.flength:
                              (i + 1) * self.flength] = src
            else:
                self._unmix_ms(
                    output[0][i * self.flength:(i + 1) * self.flength],
                    output[1][i * self.flength:(i + 1) * self.flength])
            self.midonly = 0
        return nb_frames * self.flength
