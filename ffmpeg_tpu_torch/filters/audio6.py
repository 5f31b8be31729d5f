"""Round-5 audio filter breadth: dynaudnorm, compand, acompressor,
agate, alimiter, silenceremove — analogs of the corresponding af_*.c
dynamics filters. All operate on fltp frames; envelope state carries
across frames (stream processing, same contract as the reference).

The port's copy of ffmpeg_tpu/filters/audio6.py: audio planes are host numpy
arrays in the port, and these filters run on the host as the
reference's do, with no device step; tests/test_torch_filters_audio.py
holds each one's output equal to the reference's."""

from __future__ import annotations

import math
from collections import deque
from typing import List, Optional

import numpy as np

from ..core.frame import Frame
from ..formats import samplefmt as _sf
from ..utils.options import opt_float, opt_int, opt_str
from .base import Filter, register_filter


def _to_float(frame):
    return np.asarray(_sf.to_float(frame.audio_data, frame.format))


def _emit(frame, x):
    y = _sf.from_float(x.astype(np.float32), frame.format)
    f = frame.clone_props()
    f.planes = [y[c] for c in range(y.shape[0])]
    return f


@register_filter
class DynAudNormFilter(Filter):
    """Dynamic Audio Normalizer (af_dynaudnorm.c core idea): per
    500ms-class frame, compute the peak-based maximum gain, cap it by
    `maxgain`, then smooth the gain sequence with a centered Gaussian
    window before applying — local loudness equalization without
    pumping."""

    name = "dynaudnorm"
    media_type = "audio"
    OPTIONS = (opt_int("f", default=500, min=10, max=8000),  # ms
               opt_int("g", default=31, min=3, max=301),     # filter size
               opt_float("p", default=0.95),                 # target peak
               opt_float("m", default=10.0))                 # max gain

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        g = self.g | 1                    # odd
        sigma = (g - 1) / (2.0 * 2.7)
        k = np.arange(g) - (g - 1) / 2
        w = np.exp(-(k * k) / (2 * sigma * sigma))
        self._win = w / w.sum()
        self._gains: deque = deque()
        self._frames: deque = deque()

    def _gain(self, x):
        peak = float(np.abs(x).max()) or 1e-9
        return min(self.p / peak, self.m)

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        out = []
        g = len(self._win)
        half = g // 2
        if frame is not None:
            x = _to_float(frame)
            self._frames.append((frame, x))
            self._gains.append(self._gain(x))
            if len(self._frames) > half:
                out.append(self._pop(flush=False))
        else:
            while self._frames:
                out.append(self._pop(flush=True))
        return out

    def _pop(self, flush):
        frame, x = self._frames.popleft()
        gains = list(self._gains)
        g = len(self._win)
        # centered smoothing window over the gain sequence (edges
        # replicate)
        seq = np.array(gains, np.float64)
        need = g - len(seq)
        if need > 0:
            seq = np.concatenate([np.full(need // 2 + need % 2,
                                          seq[0]), seq,
                                  np.full(need // 2, seq[-1])])
        smoothed = float(np.convolve(seq, self._win, "valid")[0]) \
            if len(seq) >= g else float(seq.mean())
        self._gains.popleft()
        return _emit(frame, x * min(smoothed, self.m))


def _db(x):
    return 20.0 * math.log10(max(abs(x), 1e-10))


@register_filter
class CompandFilter(Filter):
    """af_compand.c: per-sample envelope follower (attack/decay) +
    piecewise-linear dB transfer curve."""

    name = "compand"
    media_type = "audio"
    OPTIONS = (opt_str("attacks", default="0"),
               opt_str("decays", default="0.8"),
               opt_str("points", default="-70/-70|-60/-20|1/0"),
               opt_float("soft-knee", default=0.01),
               opt_float("gain", default=0.0),
               opt_float("volume", default=0.0),
               opt_float("delay", default=0.0))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._attack = float(str(self.attacks).split()[0].split("|")[0])
        self._decay = float(str(self.decays).split()[0].split("|")[0])
        pts = []
        for seg in str(self.points).replace("|", " ").split():
            i, o = seg.split("/")
            pts.append((float(i), float(o)))
        pts.sort()
        self._pts = pts
        self._env = 10 ** (self.volume / 20.0)

    def _transfer_db(self, in_db):
        pts = self._pts
        if in_db <= pts[0][0]:
            return pts[0][1] + (in_db - pts[0][0])
        for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
            if in_db <= x1:
                t = (in_db - x0) / max(x1 - x0, 1e-9)
                return y0 + t * (y1 - y0)
        x0, y0 = pts[-1]
        return y0

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        x = _to_float(frame)
        sr = frame.sample_rate
        a = 1.0 - math.exp(-1.0 / (sr * max(self._attack, 1e-6))) \
            if self._attack > 0 else 1.0
        d = 1.0 - math.exp(-1.0 / (sr * max(self._decay, 1e-6))) \
            if self._decay > 0 else 1.0
        env = self._env
        mono = np.abs(x).max(axis=0)
        gains = np.empty(mono.shape, np.float64)
        for i in range(mono.shape[0]):
            v = float(mono[i])
            if v > env:
                env += (v - env) * a
            else:
                env += (v - env) * d
            out_db = self._transfer_db(_db(env)) + self.gain
            gains[i] = 10 ** (out_db / 20.0) / max(env, 1e-10)
        self._env = env
        return [_emit(frame, x * gains[None, :])]


class _SideChainBase(Filter):
    """Shared attack/release envelope + gain computer
    (af_sidechaincompress.c family)."""

    media_type = "audio"

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._env = 0.0

    def _envelope(self, level, sr):
        a = math.exp(-1.0 / (sr * max(self.attack / 1000.0, 1e-6)))
        r = math.exp(-1.0 / (sr * max(self.release / 1000.0, 1e-6)))
        env = self._env
        out = np.empty(level.shape, np.float64)
        for i in range(level.shape[0]):
            v = float(level[i])
            env = (1 - a) * v + a * env if v > env else \
                (1 - r) * v + r * env
            out[i] = env
        self._env = env
        return out

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        x = _to_float(frame)
        level = np.abs(x).mean(axis=0)
        env = self._envelope(level, frame.sample_rate)
        gains = self._gain(np.maximum(env, 1e-10))
        return [_emit(frame, x * gains[None, :])]


@register_filter
class ACompressorFilter(_SideChainBase):
    """af_sidechaincompress.c acompressor: downward compression above
    threshold with ratio + makeup, soft knee."""

    name = "acompressor"
    OPTIONS = (opt_float("threshold", default=0.125),
               opt_float("ratio", default=2.0),
               opt_float("attack", default=20.0),
               opt_float("release", default=250.0),
               opt_float("makeup", default=1.0),
               opt_float("knee", default=2.82843))

    def _gain(self, env):
        thr_db = _db(self.threshold)
        knee_db = 20 * np.log10(self.knee)
        e_db = 20 * np.log10(env)
        over = e_db - thr_db
        # soft knee quadratic interpolation
        red = np.where(
            over <= -knee_db / 2, 0.0,
            np.where(over >= knee_db / 2,
                     over * (1 - 1 / self.ratio),
                     (over + knee_db / 2) ** 2 / (2 * knee_db)
                     * (1 - 1 / self.ratio)))
        return 10 ** (-red / 20.0) * self.makeup


@register_filter
class AGateFilter(_SideChainBase):
    """af_agate.c: downward expansion below threshold."""

    name = "agate"
    OPTIONS = (opt_float("threshold", default=0.125),
               opt_float("ratio", default=2.0),
               opt_float("attack", default=20.0),
               opt_float("release", default=250.0),
               opt_float("range", default=0.06125),
               opt_float("makeup", default=1.0))

    def _gain(self, env):
        thr = self.threshold
        gains = np.where(env >= thr, 1.0,
                         np.maximum((env / thr) ** (self.ratio - 1),
                                    self.range))
        return gains * self.makeup


@register_filter
class ALimiterFilter(Filter):
    """af_alimiter.c (simplified zero-attack): hard gain ceiling with
    smoothed release."""

    name = "alimiter"
    media_type = "audio"
    OPTIONS = (opt_float("limit", default=1.0),
               opt_float("level_in", default=1.0),
               opt_float("level_out", default=1.0),
               opt_float("release", default=50.0))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._gain = 1.0

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        x = _to_float(frame) * self.level_in
        sr = frame.sample_rate
        rel = math.exp(-1.0 / (sr * max(self.release / 1000.0, 1e-6)))
        peak = np.abs(x).max(axis=0)
        g = self._gain
        gains = np.empty(peak.shape, np.float64)
        for i in range(peak.shape[0]):
            want = min(1.0, self.limit / max(float(peak[i]), 1e-10))
            g = want if want < g else (1 - rel) * want + rel * g
            gains[i] = g
        self._gain = g
        return [_emit(frame, x * gains[None, :] * self.level_out)]


@register_filter
class SilenceRemoveFilter(Filter):
    """af_silenceremove.c (start/stop trimming): drop leading silence
    below `start_threshold` until `start_duration` of signal appears;
    squeeze mid-stream silences longer than `stop_duration`."""

    name = "silenceremove"
    media_type = "audio"
    OPTIONS = (opt_float("start_threshold", default=0.0),
               opt_float("start_duration", default=0.0),
               opt_float("stop_threshold", default=0.0),
               opt_float("stop_duration", default=0.0))

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._started = self.start_threshold <= 0

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        x = _to_float(frame)
        if not self._started:
            loud = np.abs(x).max(axis=0) > self.start_threshold
            idx = np.argmax(loud) if loud.any() else -1
            if idx < 0:
                return []
            self._started = True
            x = x[:, idx:]
            if x.shape[1] == 0:
                return []
        if self.stop_threshold > 0:
            keep = np.abs(x).max(axis=0) > self.stop_threshold
            if not keep.any():
                return []
            x = x[:, keep]
        f = frame.clone_props()
        y = _sf.from_float(x.astype(np.float32), frame.format)
        f.planes = [y[c] for c in range(y.shape[0])]
        f.nb_samples = x.shape[1]
        return [f]
