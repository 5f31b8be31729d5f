"""Core audio filters (counterpart of ffmpeg_tpu/filters/audio.py; analogs
of libavfilter/af_*.c).

Audio planes are host numpy arrays, and every filter here works on the
host, as the reference's do, except the resampling ones (aresample,
aformat), whose SwrContext runs its FIR on the graph's device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.frame import Frame
from ..formats import samplefmt as _sf
from ..formats.channel_layout import ChannelLayout
from ..resample.swresample import SwrContext
from ..utils import eval as _eval
from ..utils.options import opt_float, opt_int, opt_str
from ..utils.rational import NOPTS, Rational
from .base import Filter, register_filter


@register_filter
class ANullFilter(Filter):
    name = "anull"
    media_type = "audio"


@register_filter
class VolumeFilter(Filter):
    name = "volume"
    media_type = "audio"
    OPTIONS = (opt_str("volume", default="1.0"),)

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        vol = _eval.eval_expr(str(self.volume).replace("dB", "")) \
            if "dB" not in str(self.volume) else \
            10 ** (_eval.eval_expr(str(self.volume).replace("dB", "")) / 20)
        x = _sf.to_float(frame.audio_data, frame.format)
        y = _sf.from_float(x * vol, frame.format)
        f = frame.clone_props()
        f.planes = [y[c] for c in range(y.shape[0])]
        return [f]


class _ResampleBase(Filter):
    media_type = "audio"

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._ctx: Optional[SwrContext] = None
        self._in_props = None
        self._out_samples = 0

    def _target(self, frame: Frame):
        raise NotImplementedError

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            if self._ctx is None:
                return []
            out = self._ctx.flush()
            return [self._emit(out)] if out.shape[1] else []
        rate, layout, fmt = self._target(frame)
        if self._ctx is None:
            self._ctx = SwrContext(
                frame.sample_rate,
                frame.ch_layout or ChannelLayout.unspec(len(frame.planes)),
                frame.format, rate, layout, fmt, device=self.device)
            self._out = (rate, ChannelLayout.from_string(layout), fmt)
        y = self._ctx.convert(frame.audio_data)
        return [self._emit(y)] if y.shape[1] else []

    def _emit(self, y: np.ndarray) -> Frame:
        rate, layout, fmt = self._out
        f = Frame.audio(y, rate, fmt, layout)
        f.pts = self._out_samples
        f.time_base = Rational(1, rate)
        self._out_samples += y.shape[1]
        return f


@register_filter
class AResampleFilter(_ResampleBase):
    name = "aresample"
    OPTIONS = (opt_int("sample_rate", default=0),)

    def _parse_args(self, args):
        # aresample=16000 positional form
        if args and "=" not in args:
            self.set_option("sample_rate", args)
        else:
            super()._parse_args(args)

    def _target(self, frame: Frame):
        rate = self.sample_rate or frame.sample_rate
        return rate, frame.ch_layout or ChannelLayout.unspec(len(frame.planes)), frame.format


@register_filter
class AFormatFilter(_ResampleBase):
    name = "aformat"
    OPTIONS = (opt_str("sample_fmts"), opt_str("sample_rates"),
               opt_str("channel_layouts"))

    def _target(self, frame: Frame):
        fmt = (self.sample_fmts or frame.format).split("|")[0]
        rate = int((self.sample_rates or str(frame.sample_rate)).split("|")[0])
        layout = (self.channel_layouts or "").split("|")[0] or \
            (frame.ch_layout or ChannelLayout.unspec(len(frame.planes)))
        return rate, layout, fmt


@register_filter
class ATrimFilter(Filter):
    name = "atrim"
    media_type = "audio"
    OPTIONS = (opt_float("start", default=0.0),
               opt_float("end", default=float("inf")))

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        if frame.pts == NOPTS or not frame.time_base:
            return [frame]
        tb = float(frame.time_base)
        t0 = frame.pts * tb
        t1 = t0 + frame.nb_samples / frame.sample_rate
        if t1 <= self.start or t0 >= self.end:
            return []
        if t0 >= self.start and t1 <= self.end:
            return [frame]
        # partial overlap: cut samples
        s0 = max(0, int(round((self.start - t0) * frame.sample_rate)))
        s1 = frame.nb_samples - max(0, int(round((t1 - self.end) * frame.sample_rate)))
        x = frame.audio_data[:, s0:s1]
        f = Frame.audio(x, frame.sample_rate, frame.format, frame.ch_layout,
                        pts=frame.pts + s0, time_base=frame.time_base)
        return [f]


@register_filter
class APadFilter(Filter):
    name = "apad"
    media_type = "audio"
    OPTIONS = (opt_int("pad_len", default=0),)

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._last: Optional[Frame] = None

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is not None:
            self._last = frame
            return [frame]
        if self.pad_len and self._last is not None:
            z = np.zeros((len(self._last.planes), self.pad_len),
                         _sf.get(self._last.format).dtype)
            f = Frame.audio(z, self._last.sample_rate, self._last.format,
                            self._last.ch_layout,
                            pts=(self._last.pts + self._last.nb_samples
                                 if self._last.pts != NOPTS else NOPTS),
                            time_base=self._last.time_base)
            return [f]
        return []


@register_filter
class ASplitFilter(Filter):
    name = "asplit"
    media_type = "audio"
    n_outputs = 2

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        return [frame]


@register_filter
class AMixFilter(Filter):
    """Mix N inputs sample-wise (af_amix analog, duration=shortest)."""

    name = "amix"
    media_type = "audio"
    n_inputs = 2
    OPTIONS = (opt_int("inputs", default=2),)

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        from collections import deque
        self._q = [deque() for _ in range(max(2, self.inputs))]

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is not None:
            self._q[pad].append(frame)
        out = []
        while all(q for q in self._q[:self.inputs]):
            frames = [q.popleft() for q in self._q[:self.inputs]]
            n = min(f.nb_samples for f in frames)
            mixed = sum(_sf.to_float(f.audio_data[:, :n], f.format)
                        for f in frames) / self.inputs
            f0 = frames[0]
            out.append(Frame.audio(mixed.astype(np.float32), f0.sample_rate,
                                   "fltp", f0.ch_layout, pts=f0.pts,
                                   time_base=f0.time_base))
        return out


@register_filter
class ChannelSplitFilter(Filter):
    """Split channels into mono streams (af_channelsplit analog): output
    frames carry side_data['channel'] = index; graph outputs one stream
    per registered sink label."""

    name = "channelsplit"
    media_type = "audio"

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        out = []
        for c in range(len(frame.planes)):
            f = Frame.audio(frame.audio_data[c:c + 1], frame.sample_rate,
                            frame.format, None, pts=frame.pts,
                            time_base=frame.time_base)
            f.side_data["channel"] = c
            out.append(f)
        return out


@register_filter
class PanFilter(Filter):
    """Simple gain matrix mixer (af_pan's numeric subset):
    pan=<n_out>:<gain list row-major> e.g. pan=1:0.5:0.5 for stereo→mono."""

    name = "pan"
    media_type = "audio"
    OPTIONS = (opt_str("spec", default="1:1"),)

    def _parse_args(self, args):
        if args:
            self.set_option("spec", args)

    def process(self, frame: Optional[Frame], pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        parts = [float(x) for x in str(self.spec).split(":")]
        n_out = int(parts[0])
        gains = np.array(parts[1:], np.float32)
        n_in = len(frame.planes)
        m = gains.reshape(n_out, n_in)
        x = _sf.to_float(frame.audio_data, frame.format)
        y = (m @ x).astype(np.float32)
        return [Frame.audio(y, frame.sample_rate, "fltp", None,
                            pts=frame.pts, time_base=frame.time_base)]
