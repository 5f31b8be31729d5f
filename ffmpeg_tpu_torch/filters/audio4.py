"""Time/convolution audio filters: atempo (WSOLA tempo change) and
afir (FFT convolution with a streamed impulse response).

Reference behavior: libavfilter/af_atempo.c (hann-windowed fragments
of 2^floor(log2(rate/24)) samples, frequency-domain correlation
alignment, 50 % overlap feathering; tempo range [0.5, 100]) and
libavfilter/af_afir.c (partitioned frequency-domain convolution of
input 0 with the IR delivered on input 1; dry/wet mix and IR gain
normalization). Both are re-implemented on numpy FFTs; atempo is a
perceptual filter so parity is behavioral (duration scaling, tonal
continuity), not sample-exact.

The port's copy of ffmpeg_tpu/filters/audio4.py: audio planes are host numpy
arrays in the port, and these filters run on the host as the
reference's do, with no device step; tests/test_torch_filters_audio.py
holds each one's output equal to the reference's."""

from __future__ import annotations

from collections import deque
from typing import List, Optional

import numpy as np

from ..core.frame import Frame
from ..formats import samplefmt as _sf
from ..utils.error import InvalidData
from ..utils.options import opt_float, opt_int, opt_str
from .base import Filter, register_filter


@register_filter
class AtempoFilter(Filter):
    """WSOLA time-stretch: output duration = input / tempo, pitch
    preserved."""

    name = "atempo"
    description = "adjust audio tempo"
    media_type = "audio"
    OPTIONS = (opt_float("tempo", default=1.0),)

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        if not 0.5 <= float(self.tempo) <= 100.0:
            raise InvalidData("atempo: tempo out of [0.5, 100]")
        self._buf = None                  # (ch, n) accumulated input
        self._props = None
        self._pos = 0.0                   # ideal input read position
        self._consumed = 0                # samples dropped from buf
        self._tail = None                 # overlap tail (ch, half)
        self._pts = None

    def _window(self, rate):
        w = rate // 24
        return 1 << max(6, w.bit_length() - 1)

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        tempo = float(self.tempo)
        if frame is not None:
            x = _sf.to_float(frame.audio_data, frame.format) \
                .astype(np.float64)
            if self._buf is None:
                self._buf = x
                self._props = frame
                self._pts = frame.pts or 0
            else:
                self._buf = np.concatenate([self._buf, x], axis=1)
            if abs(tempo - 1.0) < 1e-9:
                return [frame]
        elif self._buf is None or abs(tempo - 1.0) < 1e-9:
            return []

        rate = self._props.sample_rate
        win = self._window(rate)
        half = win // 2
        hann = 0.5 - 0.5 * np.cos(
            2 * np.pi * np.arange(win) / win)
        search = half // 2
        out_chunks = []
        flush = frame is None

        while True:
            start = int(round(self._pos)) - self._consumed
            need = start + win + (search if not flush else 0)
            if start < 0:
                start = 0
            if self._buf.shape[1] < need and not flush:
                break
            if flush and self._buf.shape[1] - start < half:
                break
            seg_end = min(start + win, self._buf.shape[1])
            seg = self._buf[:, start:seg_end]
            if seg.shape[1] < win:
                seg = np.pad(seg, ((0, 0),
                                   (0, win - seg.shape[1])))
            if self._tail is not None and search > 0 and not flush:
                # align by cross-correlating the tail with
                # candidate offsets (FFT correlation, af_atempo.c:68)
                lim = self._buf.shape[1] - win
                best, best_v = 0, -np.inf
                ref = self._tail.sum(axis=0)
                n = half
                cand_base = start
                region_end = min(start + search, max(lim, start))
                cors = []
                for off in range(0, region_end - start + 1,
                                 max(1, search // 16) or 1):
                    s2 = self._buf[:, cand_base + off:
                                   cand_base + off + n]
                    if s2.shape[1] < n:
                        break
                    v = float(np.dot(ref, s2.sum(axis=0)))
                    if v > best_v:
                        best_v, best = v, off
                start += best
                seg_end = min(start + win, self._buf.shape[1])
                seg = self._buf[:, start:seg_end]
                if seg.shape[1] < win:
                    seg = np.pad(seg, ((0, 0),
                                       (0, win - seg.shape[1])))
            wseg = seg * hann
            if self._tail is None:
                out_chunks.append(seg[:, :half])
            else:
                out_chunks.append(self._tail + wseg[:, :half])
            self._tail = wseg[:, half:]
            self._pos += half * tempo
            drop = int(round(self._pos)) - self._consumed - win
            if drop > 0:
                drop = min(drop, self._buf.shape[1])
                self._buf = self._buf[:, drop:]
                self._consumed += drop
            if flush and int(round(self._pos)) - self._consumed \
                    >= self._buf.shape[1]:
                break

        if flush and self._tail is not None:
            out_chunks.append(self._tail)
            self._tail = None

        if not out_chunks:
            return []
        y = np.concatenate(out_chunks, axis=1)
        f = Frame.audio(y.astype(np.float32), rate, "fltp",
                        self._props.ch_layout, pts=self._pts,
                        time_base=self._props.time_base)
        self._pts += y.shape[1]
        return [f]


@register_filter
class AfirFilter(Filter):
    """FIR convolution: input 0 convolved with the impulse response
    streamed on input 1 (fully buffered before output starts, as the
    reference does)."""

    name = "afir"
    description = "FIR convolution with an IR stream"
    media_type = "audio"
    n_inputs = 2
    OPTIONS = (
        opt_float("dry", default=1.0),
        opt_float("wet", default=1.0),
        opt_float("irnorm", default=1.0),
        opt_float("irgain", default=1.0),
    )

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        self._ir_parts: List[np.ndarray] = []
        self._ir = None                   # (ch, taps) or (1, taps)
        self._irf = None                  # FFT of IR per channel
        self._fft_n = 0
        self._blk = 0
        self._main_q: deque = deque()
        self._overlap = None
        self._props = None
        self._pts = None

    def _finalize_ir(self):
        ir = np.concatenate(self._ir_parts, axis=1) \
            if self._ir_parts else np.zeros((1, 1))
        # IR gain per afir_template.c ir_gain: irnorm<0 -> none,
        # ==0 -> 1/sum, >0 -> 1/||ir||_p  (default p=1)
        p = float(self.irnorm)
        if p < 0:
            gain = 1.0
        elif p == 0:
            s = ir.sum()
            gain = 1.0 / s if s else 1.0
        else:
            s = (np.abs(ir) ** p).sum() ** (1.0 / p)
            gain = 1.0 / s if s else 1.0
        self._ir = ir * (gain * float(self.irgain))
        taps = ir.shape[1]
        self._blk = 1 << max(8, (2 * taps - 1).bit_length() - 1)
        self._fft_n = self._blk + taps - 1
        n = 1 << (self._fft_n - 1).bit_length()
        self._fft_n = n
        self._irf = np.fft.rfft(self._ir, n=n, axis=1)

    def _run_main(self, flush=False):
        out = []
        if self._irf is None:
            return out
        taps = self._ir.shape[1]
        while self._main_q:
            fr = self._main_q.popleft()
            x = _sf.to_float(fr.audio_data, fr.format) \
                .astype(np.float64)
            nch = x.shape[0]
            if self._overlap is None:
                self._overlap = np.zeros((nch, taps - 1))
                self._props = fr
                self._pts = fr.pts or 0
            y = np.zeros_like(x)
            pos = 0
            while pos < x.shape[1]:
                blk = x[:, pos:pos + self._blk]
                m = blk.shape[1]
                X = np.fft.rfft(blk, n=self._fft_n, axis=1)
                irf = self._irf if self._irf.shape[0] == nch \
                    else np.repeat(self._irf, nch, axis=0)[:nch]
                conv = np.fft.irfft(X * irf, n=self._fft_n,
                                    axis=1)[:, :m + taps - 1]
                seg = conv[:, :m].copy()
                ov = self._overlap.shape[1]
                if ov:
                    k = min(ov, m)
                    seg[:, :k] += self._overlap[:, :k]
                    newov = np.zeros_like(self._overlap)
                    if ov > k:
                        newov[:, :ov - k] = self._overlap[:, k:]
                    tail = conv[:, m:]
                    newov[:, :tail.shape[1]] += tail
                    self._overlap = newov
                y[:, pos:pos + m] = seg
                pos += m
            # wet==1 -> pure convolution; wet<1 crossfades with the
            # dry signal
            wet = float(self.wet)
            mixed = y if wet == 1.0 else \
                x * (1.0 - min(wet, 1.0)) + y * wet
            f = Frame.audio(np.clip(mixed, -1, 1)
                            .astype(np.float32),
                            fr.sample_rate, "fltp", fr.ch_layout,
                            pts=fr.pts, time_base=fr.time_base)
            out.append(f)
        if flush and self._overlap is not None \
                and np.abs(self._overlap).max() > 1e-9 \
                and self._props is not None:
            f = Frame.audio(np.clip(self._overlap, -1, 1)
                            .astype(np.float32),
                            self._props.sample_rate, "fltp",
                            self._props.ch_layout,
                            time_base=self._props.time_base)
            out.append(f)
            self._overlap = None
        return out

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if pad == 1:
            if frame is None:
                if self._irf is None:
                    self._finalize_ir()
                return self._run_main()
            self._ir_parts.append(
                _sf.to_float(frame.audio_data, frame.format)
                .astype(np.float64))
            return []
        if frame is None:
            if self._irf is None and self._ir_parts:
                self._finalize_ir()
            return self._run_main(flush=True)
        self._main_q.append(frame)
        if self._irf is not None:
            return self._run_main()
        return []
