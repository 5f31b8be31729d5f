"""Biquad EQ family + delay/echo audio filters (analogs of
af_biquads.c lowpass/highpass/bandpass/equalizer/bass/treble,
af_adelay.c, af_aecho.c). RBJ Audio-EQ-Cookbook coefficients; the IIR
recursion runs on the host (direct form II transposed), matching the
reference's scalar loop.

The port's copy of ffmpeg_tpu/filters/audio2.py: audio planes are host numpy
arrays in the port, and these filters run on the host as the
reference's do, with no device step; tests/test_torch_filters_audio.py
holds each one's output equal to the reference's."""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..core.frame import Frame
from ..formats import samplefmt as _sf
from ..utils.options import opt_float, opt_str
from .base import Filter, register_filter


class _BiquadBase(Filter):
    media_type = "audio"
    OPTIONS = (opt_float("frequency", default=3000.0),
               opt_float("width", default=0.707),
               opt_float("gain", default=0.0))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._state = None          # (z1, z2) per channel
        self._coeffs = None

    def _make_coeffs(self, sr: float):
        f0 = min(float(self.frequency), sr / 2 * 0.999)
        q = max(1e-3, float(self.width))
        a_gain = 10 ** (float(self.gain) / 40)
        w0 = 2 * math.pi * f0 / sr
        alpha = math.sin(w0) / (2 * q)
        cw = math.cos(w0)
        kind = self.name
        if kind == "lowpass":
            b = [(1 - cw) / 2, 1 - cw, (1 - cw) / 2]
            a = [1 + alpha, -2 * cw, 1 - alpha]
        elif kind == "highpass":
            b = [(1 + cw) / 2, -(1 + cw), (1 + cw) / 2]
            a = [1 + alpha, -2 * cw, 1 - alpha]
        elif kind == "bandpass":
            b = [alpha, 0.0, -alpha]
            a = [1 + alpha, -2 * cw, 1 - alpha]
        elif kind == "equalizer":
            b = [1 + alpha * a_gain, -2 * cw, 1 - alpha * a_gain]
            a = [1 + alpha / a_gain, -2 * cw, 1 - alpha / a_gain]
        elif kind == "bass":      # low shelf
            s = math.sqrt(a_gain) * 2 * alpha
            b = [a_gain * ((a_gain + 1) - (a_gain - 1) * cw + s),
                 2 * a_gain * ((a_gain - 1) - (a_gain + 1) * cw),
                 a_gain * ((a_gain + 1) - (a_gain - 1) * cw - s)]
            a = [(a_gain + 1) + (a_gain - 1) * cw + s,
                 -2 * ((a_gain - 1) + (a_gain + 1) * cw),
                 (a_gain + 1) + (a_gain - 1) * cw - s]
        elif kind == "treble":    # high shelf
            s = math.sqrt(a_gain) * 2 * alpha
            b = [a_gain * ((a_gain + 1) + (a_gain - 1) * cw + s),
                 -2 * a_gain * ((a_gain - 1) + (a_gain + 1) * cw),
                 a_gain * ((a_gain + 1) + (a_gain - 1) * cw - s)]
            a = [(a_gain + 1) - (a_gain - 1) * cw + s,
                 2 * ((a_gain - 1) - (a_gain + 1) * cw),
                 (a_gain + 1) - (a_gain - 1) * cw - s]
        else:
            raise ValueError(kind)
        a0 = a[0]
        return ([x / a0 for x in b], [x / a0 for x in a])

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        x = _sf.to_float(frame.audio_data, frame.format).astype(np.float64)
        if self._coeffs is None:
            self._coeffs = self._make_coeffs(frame.sample_rate)
            self._state = np.zeros((x.shape[0], 2))
        (b0, b1, b2), (_a0, a1, a2) = self._coeffs
        y = np.empty_like(x)
        for c in range(x.shape[0]):
            z1, z2 = self._state[c]
            xc = x[c]
            yc = y[c]
            for n in range(xc.shape[0]):
                v = b0 * xc[n] + z1
                z1 = b1 * xc[n] - a1 * v + z2
                z2 = b2 * xc[n] - a2 * v
                yc[n] = v
            self._state[c] = (z1, z2)
        out = frame.clone_props()
        y16 = _sf.from_float(y.astype(np.float32), frame.format)
        out.planes = [y16[c] for c in range(y16.shape[0])]
        return [out]


for _name in ("lowpass", "highpass", "bandpass", "equalizer", "bass",
              "treble"):
    cls = type(f"{_name.capitalize()}Filter", (_BiquadBase,),
               {"name": _name})
    register_filter(cls)


@register_filter
class ADelayFilter(Filter):
    """Per-channel delay in ms, zero-padded head (af_adelay.c)."""

    name = "adelay"
    media_type = "audio"
    OPTIONS = (opt_str("delays", default="0"),)

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._pending = None

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        x = _sf.to_float(frame.audio_data, frame.format)
        nch = x.shape[0]
        if self._pending is None:
            dl = [float(v) for v in str(self.delays).split("|")]
            while len(dl) < nch:
                dl.append(dl[-1])
            self._pending = [
                np.zeros(int(d * frame.sample_rate / 1000), np.float32)
                for d in dl[:nch]]
        outs = []
        n = x.shape[1]
        for c in range(nch):
            buf = np.concatenate([self._pending[c], x[c]])
            outs.append(buf[:n])
            self._pending[c] = buf[n:]
        y = _sf.from_float(np.stack(outs), frame.format)
        out = frame.clone_props()
        out.planes = [y[c] for c in range(nch)]
        return [out]


@register_filter
class AEchoFilter(Filter):
    """Echo: out = in*in_gain + sum(decay_i * in[t-delay_i]) * out_gain
    (af_aecho.c, feed-forward form)."""

    name = "aecho"
    media_type = "audio"
    OPTIONS = (opt_float("in_gain", default=0.6),
               opt_float("out_gain", default=0.3),
               opt_str("delays", default="1000"),
               opt_str("decays", default="0.5"))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._hist = None

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        x = _sf.to_float(frame.audio_data, frame.format).astype(np.float64)
        sr = frame.sample_rate
        delays = [max(1, int(float(v) * sr / 1000))
                  for v in str(self.delays).split("|")]
        decays = [float(v) for v in str(self.decays).split("|")]
        maxd = max(delays)
        if self._hist is None:
            self._hist = np.zeros((x.shape[0], maxd))
        buf = np.concatenate([self._hist, x], axis=1)
        y = x * float(self.in_gain)
        for d, g in zip(delays, decays):
            y = y + g * buf[:, maxd - d:maxd - d + x.shape[1]] \
                * float(self.out_gain)
        self._hist = buf[:, -maxd:]
        out = frame.clone_props()
        yq = _sf.from_float(np.clip(y, -1, 1).astype(np.float32),
                            frame.format)
        out.planes = [yq[c] for c in range(yq.shape[0])]
        return [out]
