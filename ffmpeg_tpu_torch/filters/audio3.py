"""Loudness filters: ebur128 (ITU-R BS.1770 / EBU R128 meter) and
loudnorm (EBU R128 two-pass/linear normalizer).

Reference behavior: libavfilter/f_ebur128.c (K-weighting biquads
config_audio_input:383, 100 ms gating blocks with 75 %/ overlap,
histogram-gated integrated loudness + LRA percentiles) and
libavfilter/af_loudnorm.c (linear mode :815). The measurement core is
block-based rather than a per-sample ring cache: 400 ms / 3 s window
powers are sums of the last 4 / 30 100-ms block energies, which is
numerically identical at the 100-ms decision points the reference
evaluates.

The port's copy of ffmpeg_tpu/filters/audio3.py: audio planes are host numpy
arrays in the port, and these filters run on the host as the
reference's do, with no device step; tests/test_torch_filters_audio.py
holds each one's output equal to the reference's."""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..core.frame import Frame
from ..formats import samplefmt as _sf
from ..utils.options import opt_bool, opt_float, opt_int, opt_str
from .base import Filter, register_filter

ABS_THRES = -70.0
ABS_UP_THRES = 10.0
HIST_GRAIN = 100
HIST_SIZE = int((ABS_UP_THRES - ABS_THRES) * HIST_GRAIN) + 1
_HIST_LOUDNESS = np.arange(HIST_SIZE) / HIST_GRAIN + ABS_THRES
_HIST_ENERGY = 10.0 ** ((_HIST_LOUDNESS + 0.691) / 10.0)


def _loudness(power):
    return -0.691 + 10.0 * math.log10(max(power, 1e-30))


def _hist_pos(loudness):
    return int(min(max((loudness - ABS_THRES) * HIST_GRAIN, 0),
                   HIST_SIZE - 1))


def _k_weighting_coeffs(rate):
    """Pre (shelving) + RLB (high-pass) biquads, the reference's
    reverse-engineered 48 kHz parametrization rescaled to `rate`
    (f_ebur128.c:391)."""
    f0 = 1681.974450955533
    G = 3.999843853973347
    Q = 0.7071752369554196
    K = math.tan(math.pi * f0 / rate)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    pre_b = [(Vh + Vb * K / Q + K * K) / a0,
             2.0 * (K * K - Vh) / a0,
             (Vh - Vb * K / Q + K * K) / a0]
    pre_a = [1.0, 2.0 * (K * K - 1.0) / a0,
             (1.0 - K / Q + K * K) / a0]
    f0 = 38.13547087602444
    Q = 0.5003270373238773
    K = math.tan(math.pi * f0 / rate)
    d0 = 1.0 + K / Q + K * K
    rlb_b = [1.0, -2.0, 1.0]
    rlb_a = [1.0, 2.0 * (K * K - 1.0) / d0,
             (1.0 - K / Q + K * K) / d0]
    return (pre_b, pre_a), (rlb_b, rlb_a)


def _lfilter(b, a, x, zi):
    """Direct-form II transposed biquad over axis -1 with state."""
    try:
        from scipy.signal import lfilter
        return lfilter(b, a, x, axis=-1, zi=zi)
    except ImportError:                       # pragma: no cover
        y = np.empty_like(x)
        z = zi.copy()
        for n in range(x.shape[-1]):
            xn = x[..., n]
            yn = b[0] * xn + z[..., 0]
            z[..., 0] = b[1] * xn + z[..., 1] - a[1] * yn
            z[..., 1] = b[2] * xn - a[2] * yn
            y[..., n] = yn
        return y, z


class _R128State:
    """Streaming BS.1770 meter over (channels, samples) float input."""

    def __init__(self, rate, nch, ch_weights=None):
        self.rate = rate
        self.nch = nch
        (self.pre_b, self.pre_a), (self.rlb_b, self.rlb_a) = \
            _k_weighting_coeffs(rate)
        self.z_pre = np.zeros((nch, 2))
        self.z_rlb = np.zeros((nch, 2))
        self.weights = np.asarray(
            ch_weights if ch_weights is not None
            else _default_weights(nch))
        self.block = rate // 10
        self._carry = np.zeros((nch, 0))
        self.block_sums: List[np.ndarray] = []   # per-ch z^2 sums
        self.hist400 = np.zeros(HIST_SIZE, np.int64)
        self.hist3000 = np.zeros(HIST_SIZE, np.int64)
        self.sum_kept_400 = 0.0
        self.n_kept_400 = 0
        self.sum_kept_3000 = 0.0
        self.n_kept_3000 = 0
        self.integrated = ABS_THRES
        self.lra = 0.0
        self.lra_low = 0.0
        self.lra_high = 0.0
        self.momentary = ABS_THRES
        self.short_term = ABS_THRES
        self.sample_peak = 0.0

    def push(self, x: np.ndarray):
        """x: (channels, samples) float64 in [-1, 1]."""
        self.sample_peak = max(self.sample_peak,
                               float(np.abs(x).max(initial=0.0)))
        y, self.z_pre = _lfilter(self.pre_b, self.pre_a, x,
                                 self.z_pre)
        z, self.z_rlb = _lfilter(self.rlb_b, self.rlb_a, y,
                                 self.z_rlb)
        z2 = np.concatenate([self._carry, z * z], axis=1)
        nfull = z2.shape[1] // self.block
        for k in range(nfull):
            seg = z2[:, k * self.block:(k + 1) * self.block]
            self.block_sums.append(seg.sum(axis=1))
            self._tick()
        self._carry = z2[:, nfull * self.block:]

    def _power(self, nblocks):
        tail = self.block_sums[-nblocks:]
        s = np.sum(tail, axis=0)
        return max(float(np.dot(self.weights, s))
                   / (nblocks * self.block), 1e-12)

    def _tick(self):
        nb = len(self.block_sums)
        power_400 = self._power(4) if nb >= 4 else 1e-12
        power_3000 = self._power(30) if nb >= 30 else 1e-12
        self.momentary = _loudness(power_400)
        self.short_term = _loudness(power_3000)

        if self.momentary >= ABS_THRES:
            self.hist400[_hist_pos(self.momentary)] += 1
            self.sum_kept_400 += power_400
            self.n_kept_400 += 1
            rel = _loudness(self.sum_kept_400
                            / self.n_kept_400) - 10.0
            pos = _hist_pos(rel)
            counts = self.hist400[pos:]
            n = counts.sum()
            if n:
                self.integrated = _loudness(
                    float(np.dot(counts, _HIST_ENERGY[pos:])) / n)

        if self.short_term >= ABS_THRES:
            self.hist3000[_hist_pos(self.short_term)] += 1
            self.sum_kept_3000 += power_3000
            self.n_kept_3000 += 1
            rel = _loudness(self.sum_kept_3000
                            / self.n_kept_3000) - 20.0
            pos = _hist_pos(rel)
            counts = self.hist3000[pos:]
            total = counts.sum()
            if total:
                csum = np.cumsum(counts)
                lo_target = int(10 * total * 0.01 + 0.5)
                hi_target = int(95 * total * 0.01 + 0.5)
                lo_i = int(np.searchsorted(csum, lo_target))
                self.lra_low = _HIST_LOUDNESS[pos + lo_i]
                # high bound: largest bin whose below-count < 95 %
                # (the reference's top-down scan, f_ebur128.c:822)
                below = csum - counts
                hi = np.nonzero(below < hi_target)[0]
                if len(hi):
                    self.lra_high = _HIST_LOUDNESS[pos + hi[-1]]
                self.lra = self.lra_high - self.lra_low


def _default_weights(nch):
    """BS.1770 channel weights: surrounds x1.41, LFE x0 (f_ebur128.c
    config_audio_output). Uses the default layout convention
    (FL FR FC LFE BL BR ...)."""
    if nch == 1:
        return [1.0]
    if nch == 2:
        return [1.0, 1.0]
    w = [1.0] * nch
    if nch >= 4:
        w[3] = 0.0 if nch >= 5 else w[3]      # LFE in 5.1-style
    if nch in (5, 6):
        for i in (nch - 2, nch - 1):
            w[i] = 1.41
    if nch == 6:
        w[3] = 0.0
    if nch == 4:                              # quad: two backs
        w[2] = w[3] = 1.41
    return w


@register_filter
class Ebur128Filter(Filter):
    """EBU R128 meter: passes audio through, injects lavfi.r128.*
    side data, prints a summary on EOF."""

    name = "ebur128"
    description = "EBU R128 loudness meter"
    media_type = "audio"
    OPTIONS = (
        opt_str("peak", default="none"),
        opt_bool("metadata", default=False),
        opt_int("target", default=-23),
    )

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._st: Optional[_R128State] = None

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            if self._st is not None:
                from ..utils.log import LogLevel
                st = self._st
                self.log(
                    LogLevel.INFO,
                    f"Summary:\n  Integrated loudness:\n"
                    f"    I: {st.integrated:.1f} LUFS\n"
                    f"  Loudness range:\n"
                    f"    LRA: {st.lra:.1f} LU\n"
                    f"  Sample peak:\n"
                    f"    Peak: "
                    f"{20*math.log10(max(st.sample_peak,1e-12)):.1f}"
                    " dBFS")
            return []
        if self._st is None:
            self._st = _R128State(frame.sample_rate,
                                  len(frame.planes))
        x = _sf.to_float(frame.audio_data, frame.format) \
            .astype(np.float64)
        self._st.push(x)
        st = self._st
        f = frame.clone_props()
        f.planes = list(frame.planes)
        f.side_data = dict(frame.side_data)
        f.side_data.update({
            "lavfi.r128.M": st.momentary,
            "lavfi.r128.S": st.short_term,
            "lavfi.r128.I": st.integrated,
            "lavfi.r128.LRA": st.lra,
            "lavfi.r128.sample_peak":
                20 * math.log10(max(st.sample_peak, 1e-12)),
        })
        return [f]

    @property
    def stats(self):
        st = self._st
        if st is None:
            return None
        return {
            "I": st.integrated, "LRA": st.lra,
            "LRA.low": st.lra_low, "LRA.high": st.lra_high,
            "sample_peak":
                20 * math.log10(max(st.sample_peak, 1e-12)),
            "M": st.momentary, "S": st.short_term,
        }


@register_filter
class LoudnormFilter(Filter):
    """EBU R128 normalizer.

    Linear (two-pass) mode matches the reference exactly: constant
    gain target_i - measured_i (af_loudnorm.c:815), entered when the
    four measured_* values are provided and the true-peak/LRA
    constraints hold. The single-pass dynamic mode is an original
    streaming design (short-term-loudness-tracking gain with a hard
    true-peak ceiling), matching the reference's targets but not its
    sample-exact output."""

    name = "loudnorm"
    description = "EBU R128 loudness normalization"
    media_type = "audio"
    OPTIONS = (
        opt_float("i", default=-24.0), opt_float("I", default=-24.0),
        opt_float("lra", default=7.0), opt_float("LRA", default=7.0),
        opt_float("tp", default=-2.0), opt_float("TP", default=-2.0),
        opt_float("measured_i", default=0.0),
        opt_float("measured_I", default=0.0),
        opt_float("measured_lra", default=0.0),
        opt_float("measured_LRA", default=0.0),
        opt_float("measured_tp", default=99.0),
        opt_float("measured_TP", default=99.0),
        opt_float("measured_thresh", default=-70.0),
        opt_float("offset", default=0.0),
        opt_bool("linear", default=True),
        opt_bool("dual_mono", default=False),
        opt_str("print_format", default="none"),
    )

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._st: Optional[_R128State] = None
        self._gain_db = None
        self._dyn_gain = None

    def _opt2(self, a, b, default):
        va, vb = getattr(self, a), getattr(self, b)
        if va != default:
            return va
        return vb

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        target_i = self._opt2("i", "I", -24.0)
        target_tp = self._opt2("tp", "TP", -2.0)
        target_lra = self._opt2("lra", "LRA", 7.0)
        measured_i = self._opt2("measured_i", "measured_I", 0.0)
        measured_tp = self._opt2("measured_tp", "measured_TP", 99.0)
        measured_lra = self._opt2("measured_lra", "measured_LRA",
                                  0.0)

        x = _sf.to_float(frame.audio_data, frame.format) \
            .astype(np.float64)

        if self._gain_db is None and self.linear \
                and measured_i != 0.0 and measured_tp != 99.0 \
                and self.measured_thresh != -70.0 \
                and measured_lra != 0.0:
            off = target_i - measured_i
            if measured_tp + off <= target_tp \
                    and measured_lra <= target_lra:
                self._gain_db = off + self.offset

        if self._gain_db is not None:
            y = x * (10.0 ** (self._gain_db / 20.0))
        else:
            # dynamic mode: short-term tracking gain
            if self._st is None:
                self._st = _R128State(frame.sample_rate,
                                      len(frame.planes))
                self._dyn_gain = 1.0
            self._st.push(x)
            st = self._st
            ref = st.short_term if st.short_term > ABS_THRES \
                else st.momentary
            if ref > ABS_THRES:
                want = 10.0 ** ((target_i - ref) / 20.0)
            else:
                want = self._dyn_gain
            # smooth toward the wanted gain (one step per frame)
            self._dyn_gain += 0.2 * (want - self._dyn_gain)
            y = x * self._dyn_gain

        # hard true-peak ceiling
        ceil = 10.0 ** (target_tp / 20.0)
        peak = np.abs(y).max(initial=0.0)
        if peak > ceil:
            y = y * (ceil / peak)

        out = _sf.from_float(y, frame.format)
        f = frame.clone_props()
        f.planes = [out[c] for c in range(out.shape[0])]
        return [f]
