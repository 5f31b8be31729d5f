"""Source filters (counterpart of ffmpeg_tpu/filters/sources.py; analogs
of vsrc_testsrc.c color/testsrc and asrc_sine.c / anullsrc).

The video sources make their planes on the filter's `device`: the
graph's device when the filter sits in a graph, else the card unless the
caller sets `device` first.  The audio sources make host planes, as the
port's audio frames are.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..core.frame import Frame
from ..formats.channel_layout import default_layout
from ..utils.options import Option, OptType, opt_float, opt_int, opt_str
from ..utils.rational import Rational
from .base import Filter, register_filter


class SourceFilter(Filter):
    """Generates frames; use .generate(n) or iterate."""

    n_inputs = 0

    def generate(self, nframes: int) -> Iterator[Frame]:
        raise NotImplementedError


def grid(h: int, w: int, device) -> tuple:
    """np.mgrid[0:h, 0:w] as int64 tensors on `device`."""
    yy = torch.arange(h, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, device=device)[None, :].expand(h, w)
    return yy, xx


@register_filter
class ColorSource(SourceFilter):
    name = "color"
    OPTIONS = (opt_str("color", default="black"),
               Option("size", type=OptType.IMAGE_SIZE, default=(320, 240)),
               Option("rate", type=OptType.VIDEO_RATE, default=Rational(25, 1)))

    _COLORS = {"black": (0, 0, 0), "white": (255, 255, 255),
               "red": (255, 0, 0), "green": (0, 255, 0), "blue": (0, 0, 255),
               "gray": (128, 128, 128), "yellow": (255, 255, 0)}

    def generate(self, nframes: int) -> Iterator[Frame]:
        w, h = self.size
        c = self._COLORS.get(str(self.color), (0, 0, 0))
        if isinstance(self.color, str) and self.color.startswith("0x"):
            v = int(self.color, 16)
            c = (v >> 16 & 255, v >> 8 & 255, v & 255)
        planes = [torch.full((h, w), c[i], dtype=torch.uint8,
                             device=self.device) for i in range(3)]
        tb = self.rate.inv()
        for i in range(nframes):
            f = Frame.video(w, h, "rgb24",
                            planes=[p.clone() for p in planes],
                            pts=i, time_base=tb)
            f.duration = 1
            yield f


@register_filter
class TestSource(SourceFilter):
    """Deterministic moving test pattern (testsrc-like; not bit-compatible
    with the reference's testsrc2 drawing code)."""

    name = "testsrc"
    OPTIONS = (Option("size", type=OptType.IMAGE_SIZE, default=(320, 240)),
               Option("rate", type=OptType.VIDEO_RATE, default=Rational(25, 1)))

    def generate(self, nframes: int) -> Iterator[Frame]:
        w, h = self.size
        tb = self.rate.inv()
        yy, xx = grid(h, w, self.device)
        for i in range(nframes):
            r = ((xx * 255 // max(1, w)) + i * 7) % 256
            g = ((yy * 255 // max(1, h)) + i * 3) % 256
            b = ((xx + yy + i * 11) // 2) % 256
            f = Frame.video(w, h, "rgb24",
                            planes=[r.to(torch.uint8), g.to(torch.uint8),
                                    b.to(torch.uint8)],
                            pts=i, time_base=tb)
            f.duration = 1
            yield f


@register_filter
class SineSource(SourceFilter):
    name = "sine"
    media_type = "audio"
    OPTIONS = (opt_float("frequency", default=440.0),
               opt_int("sample_rate", default=44100),
               opt_float("amplitude", default=0.5),
               opt_int("samples_per_frame", default=1024))

    def generate(self, nframes: int) -> Iterator[Frame]:
        n = self.samples_per_frame
        pos = 0
        for i in range(nframes):
            t = (np.arange(n) + pos) / self.sample_rate
            x = (self.amplitude *
                 np.sin(2 * np.pi * self.frequency * t)).astype(np.float32)
            f = Frame.audio(x[None, :], self.sample_rate, "fltp",
                            default_layout(1), pts=pos,
                            time_base=Rational(1, self.sample_rate))
            pos += n
            yield f


@register_filter
class ANullSource(SourceFilter):
    name = "anullsrc"
    media_type = "audio"
    OPTIONS = (opt_int("sample_rate", default=44100),
               opt_int("channels", default=2),
               opt_int("samples_per_frame", default=1024))

    def generate(self, nframes: int) -> Iterator[Frame]:
        n = self.samples_per_frame
        pos = 0
        for i in range(nframes):
            x = np.zeros((self.channels, n), np.float32)
            f = Frame.audio(x, self.sample_rate, "fltp",
                            default_layout(self.channels), pts=pos,
                            time_base=Rational(1, self.sample_rate))
            pos += n
            yield f


@register_filter
class NullSink(Filter):
    name = "nullsink"
    n_outputs = 0

    def process(self, frame, pad=0):
        return []
