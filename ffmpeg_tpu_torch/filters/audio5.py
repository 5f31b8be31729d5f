"""Audio filter breadth batch 2: afade, asetpts, amerge/join,
channelmap, stereo field tools (extrastereo, stereowiden,
crystalizer), modulation (tremolo, vibrato), anoisesrc source.
Reference analogs: af_afade.c, f_setpts.c (audio side), af_amerge.c,
af_join.c, af_channelmap.c, af_extrastereo.c, af_stereowiden.c,
af_crystalizer.c, af_tremolo.c, af_vibrato.c, asrc_anoisesrc.c.

The port's copy of ffmpeg_tpu/filters/audio5.py: audio planes are host numpy
arrays in the port, and these filters run on the host as the
reference's do, with no device step; tests/test_torch_filters_audio.py
holds each one's output equal to the reference's."""

from __future__ import annotations

import math
from collections import deque
from typing import Iterator, List, Optional

import numpy as np

from ..core.frame import Frame
from ..formats import samplefmt as _sf
from ..formats.channel_layout import default_layout
from ..utils.error import InvalidData
from ..utils.options import opt_float, opt_int, opt_str
from ..utils.rational import Rational
from .base import Filter, register_filter
from .sources import SourceFilter
from .video import SetPtsFilter


def _audio(frame):
    return _sf.to_float(frame.audio_data, frame.format) \
        .astype(np.float64)


def _emit(frame, x):
    out = _sf.from_float(x, frame.format)
    f = frame.clone_props()
    f.planes = [out[c] for c in range(out.shape[0])]
    return f


@register_filter
class AFadeFilter(Filter):
    """af_afade: fade in/out over a sample window (triangular
    curve)."""

    name = "afade"
    media_type = "audio"
    OPTIONS = (opt_str("type", default="in"),
               opt_int("start_sample", default=0),
               opt_int("nb_samples", default=44100),
               opt_float("start_time", default=-1.0),
               opt_float("duration", default=-1.0))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._pos = 0

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        start = int(self.start_sample)
        nsmp = int(self.nb_samples)
        if float(self.start_time) >= 0:
            start = int(float(self.start_time) * frame.sample_rate)
        if float(self.duration) >= 0:
            nsmp = int(float(self.duration) * frame.sample_rate)
        x = _audio(frame)
        idx = np.arange(x.shape[1]) + self._pos
        self._pos += x.shape[1]
        rel = (idx - start) / max(1, nsmp)
        gain = np.clip(rel, 0.0, 1.0)
        if str(self.type) != "in":
            gain = 1.0 - gain
        return [_emit(frame, x * gain[None, :])]


@register_filter
class ASetPtsFilter(SetPtsFilter):
    name = "asetpts"
    media_type = "audio"


@register_filter
class AMergeFilter(Filter):
    """af_amerge: concatenate the channels of N inputs."""

    name = "amerge"
    media_type = "audio"
    n_inputs = 2
    OPTIONS = (opt_int("inputs", default=2),)

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._q = [deque() for _ in range(max(2, int(self.inputs)))]

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is not None:
            self._q[pad].append(frame)
        out = []
        n = int(self.inputs)
        while all(q for q in self._q[:n]):
            frames = [q.popleft() for q in self._q[:n]]
            ns = min(f.nb_samples for f in frames)
            x = np.concatenate([_audio(f)[:, :ns] for f in frames],
                               axis=0)
            f0 = frames[0]
            out.append(Frame.audio(x.astype(np.float32),
                                   f0.sample_rate, "fltp",
                                   default_layout(x.shape[0]),
                                   pts=f0.pts,
                                   time_base=f0.time_base))
        return out


@register_filter
class JoinFilter(AMergeFilter):
    """af_join: like amerge but with an explicit output layout."""

    name = "join"
    OPTIONS = (opt_int("inputs", default=2),
               opt_str("channel_layout", default="stereo"))


@register_filter
class ChannelMapFilter(Filter):
    """af_channelmap: reorder channels per 'map' (indices)."""

    name = "channelmap"
    media_type = "audio"
    OPTIONS = (opt_str("map", default=""),)

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        m = [int(t) for t in str(self.map).replace("|", " ")
             .replace("-", " ").split() if t != ""]
        x = _audio(frame)
        if any(i >= x.shape[0] for i in m):
            raise InvalidData("channelmap: index out of range")
        y = x[m] if m else x
        f0 = frame
        return [Frame.audio(y.astype(np.float32), f0.sample_rate,
                            "fltp", default_layout(y.shape[0]),
                            pts=f0.pts, time_base=f0.time_base)]


@register_filter
class ExtraStereoFilter(Filter):
    """af_extrastereo: widen by scaling the L/R difference by m."""

    name = "extrastereo"
    media_type = "audio"
    OPTIONS = (opt_float("m", default=2.5),
               opt_int("c", default=1))

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        x = _audio(frame)
        if x.shape[0] != 2:
            raise InvalidData("extrastereo: needs stereo")
        mean = (x[0] + x[1]) * 0.5
        l = mean + float(self.m) * (x[0] - mean)
        r = mean + float(self.m) * (x[1] - mean)
        y = np.stack([l, r])
        if int(self.c):
            y = np.clip(y, -1.0, 1.0)
        return [_emit(frame, y)]


@register_filter
class StereoWidenFilter(Filter):
    """af_stereowiden: delayed inverted crossfeed."""

    name = "stereowiden"
    media_type = "audio"
    OPTIONS = (opt_float("delay", default=20.0),      # ms
               opt_float("feedback", default=0.3),
               opt_float("crossfeed", default=0.3),
               opt_float("drymix", default=0.8))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._hist = None

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        x = _audio(frame).astype(np.float32)
        if x.shape[0] != 2:
            raise InvalidData("stereowiden: needs stereo")
        d = max(1, int(float(self.delay) * frame.sample_rate
                       / 1000.0))
        if self._hist is None or self._hist.shape[1] != d:
            self._hist = np.zeros((2, d), np.float32)
        buf = np.concatenate([self._hist, x], axis=1)
        fb = np.float32(self.feedback)
        cf = np.float32(self.crossfeed)
        dry = np.float32(self.drymix)
        n = x.shape[1]
        dl = buf[:, :n]                       # delayed by d samples
        # af_stereowiden.c: inverted crossfeed + inverted delayed
        # opposite channel, no clipping
        l = dry * x[0] - cf * x[1] - fb * dl[1]
        r = dry * x[1] - cf * x[0] - fb * dl[0]
        self._hist = buf[:, -d:].copy()
        return [_emit(frame, np.stack([l, r]).astype(np.float64))]


@register_filter
class CrystalizerFilter(Filter):
    """af_crystalizer: expand the per-sample delta:
    out = in + (in - prev) * mult."""

    name = "crystalizer"
    media_type = "audio"
    OPTIONS = (opt_float("i", default=2.0),
               opt_int("c", default=1))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._prev = None

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        x = _audio(frame)
        if self._prev is None or self._prev.shape[0] != x.shape[0]:
            self._prev = np.zeros(x.shape[0])
        prev = np.concatenate([self._prev[:, None], x[:, :-1]],
                              axis=1)
        y = x + (x - prev) * float(self.i)
        self._prev = x[:, -1].copy()
        if int(self.c):
            y = np.clip(y, -1.0, 1.0)
        return [_emit(frame, y)]


@register_filter
class TremoloFilter(Filter):
    """af_tremolo: sinusoidal amplitude modulation."""

    name = "tremolo"
    media_type = "audio"
    OPTIONS = (opt_float("f", default=5.0),
               opt_float("d", default=0.5))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._idx = 0
        self._table = None

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        x = _audio(frame)
        sr = frame.sample_rate
        if self._table is None:
            # af_tremolo.c:100 — one quantized LFO period, cosine
            # phase, gain in [1-d, 1]
            size = round(sr / float(self.f) + 0.5)
            offset = 1.0 - float(self.d) / 2.0
            i = np.arange(size)
            env = np.sin(2 * np.pi *
                         np.mod(float(self.f) * i / sr + 0.25, 1.0))
            self._table = env * (1 - abs(offset)) + offset
        n = x.shape[1]
        idx = (self._idx + np.arange(n)) % len(self._table)
        self._idx = int((self._idx + n) % len(self._table))
        return [_emit(frame, x * self._table[idx][None, :])]


@register_filter
class VibratoFilter(Filter):
    """af_vibrato: sinusoidal delay modulation (pitch wobble) with
    linear interpolation over a short ring buffer."""

    name = "vibrato"
    media_type = "audio"
    OPTIONS = (opt_float("f", default=5.0),
               opt_float("d", default=0.5))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._hist = None
        self._widx = 0
        self._wave = None
        self._buf_size = 0

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        x = _audio(frame)
        sr = frame.sample_rate
        if self._wave is None:
            # af_vibrato.c config_input: 5 ms ring buffer, one-period
            # sine wave table in [0, buf_size-1], phase 3pi/2
            self._buf_size = round(sr * 0.005 + 0.5)
            size = round(sr / float(self.f) + 0.5)
            po = int(0.75 * size + 0.5)
            pt = (np.arange(size) + po) % size
            self._wave = ((np.sin(pt / size * 2 * np.pi) + 1) / 2) \
                * (self._buf_size - 1)
            self._hist = np.zeros((x.shape[0], self._buf_size))
        bs = self._buf_size
        n = x.shape[1]
        widx = (self._widx + np.arange(n)) % len(self._wave)
        self._widx = int((self._widx + n) % len(self._wave))
        wt = float(self.d) * self._wave[widx]
        k = np.floor(wt).astype(int)
        dec = wt - k
        # slot (buf_index + k) holds input sample n - buf_size + k
        buf = np.concatenate([self._hist, x], axis=1)
        base = np.arange(n) + bs
        s1 = base - bs + k
        s2 = np.where(k + 1 >= bs, base - bs, s1 + 1)
        y = buf[:, s1] * (1 - dec) + buf[:, s2] * dec
        self._hist = buf[:, -bs:].copy()
        return [_emit(frame, y)]


@register_filter
class ANoiseSource(SourceFilter):
    """asrc_anoisesrc: white/pink/brown noise."""

    name = "anoisesrc"
    media_type = "audio"
    OPTIONS = (opt_str("color", default="white"),
               opt_int("sample_rate", default=48000),
               opt_float("amplitude", default=1.0),
               opt_int("seed", default=0),
               opt_int("samples_per_frame", default=1024))

    def generate(self, nframes: int) -> Iterator[Frame]:
        rng = np.random.default_rng(int(self.seed))
        n = int(self.samples_per_frame)
        sr = int(self.sample_rate)
        pos = 0
        state = 0.0
        b = np.zeros(7)
        for _ in range(nframes):
            w = rng.standard_normal(n)
            color = str(self.color)
            if color == "pink":
                out = np.empty(n)
                for i in range(n):
                    b[0] = 0.99886 * b[0] + w[i] * 0.0555179
                    b[1] = 0.99332 * b[1] + w[i] * 0.0750759
                    b[2] = 0.96900 * b[2] + w[i] * 0.1538520
                    b[3] = 0.86650 * b[3] + w[i] * 0.3104856
                    b[4] = 0.55000 * b[4] + w[i] * 0.5329522
                    b[5] = -0.7616 * b[5] - w[i] * 0.0168980
                    out[i] = (b[:6].sum() + b[6] + w[i] * 0.5362) \
                        * 0.11
                    b[6] = w[i] * 0.115926
            elif color in ("brown", "red"):
                out = np.empty(n)
                for i in range(n):
                    state = (state + 0.02 * w[i]) / 1.02
                    out[i] = state * 3.5
            else:
                out = w * 0.3
            x = (out * float(self.amplitude)).astype(np.float32)
            f = Frame.audio(np.clip(x, -1, 1)[None, :], sr, "fltp",
                            default_layout(1), pts=pos,
                            time_base=Rational(1, sr))
            pos += n
            yield f
