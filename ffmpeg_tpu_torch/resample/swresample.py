"""Audio conversion pipeline (counterpart of
ffmpeg_tpu/resample/swresample.py; analog of libswresample/swresample.{c,h}).

Pipeline, chosen at init exactly like swr_init (swresample.c:223-396):
  input → to float32 planar → rematrix (float64 on the host) → polyphase
  FIR resample (gather + weighted reduction on the device) → dither (host)
  → output format.

The resampler is streaming: arbitrary chunk sizes in, exact rational
position tracking in host int64 (no drift), flush() drains the tail.  It
runs on the *output* channel count, after the rematrix.  Each process()
call copies the pending input, the window starts and the phases to the
device once, runs the FIR there and copies the result back once.  The
reference pads each chunk to a power-of-two bucket for jit shape reuse;
the port does not, and reads past the data see zeros, as the reference's
reads into its bucket padding do.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.frame import Frame, host_array
from ..formats import samplefmt as _sf
from ..formats.channel_layout import ChannelLayout
from ..scale.ops import require_full_fp32
from ..utils.error import InvalidData
from . import fir, rematrix as _rm


def _fir_kernel(buf: torch.Tensor, starts: torch.Tensor,
                phases_idx: torch.Tensor, bank: torch.Tensor,
                taps: int) -> torch.Tensor:
    """buf (ch, n), starts (m,), phases_idx (m,), bank (P, T) → (ch, m),
    on the device of its inputs: out[c, i] = sum_t buf[c, starts[i] + t] *
    bank[phases_idx[i], t], with zeros past the end of buf.  Starts are
    never negative (the buffer holds the filter's history), so each window
    is one row of buf's unfold over `taps` appended zeros."""
    n = buf.shape[1]
    padded = F.pad(buf, (0, taps))
    windows = padded.unfold(1, taps, 1).index_select(
        1, starts.clamp(0, n))                              # (ch, m, T)
    w = bank.index_select(0, phases_idx)                    # (m, T)
    require_full_fp32()
    return torch.einsum("cmt,mt->cm", windows, w)


class Resampler:
    """Streaming polyphase sample-rate converter; the FIR runs on
    `device`."""

    def __init__(self, in_rate: int, out_rate: int, channels: int,
                 filter_size: int = 32, cutoff: Optional[float] = None,
                 window: str = "kaiser", beta: float = 9.0,
                 max_phases: int = 1024,
                 device: torch.device | str = "cuda"):
        if in_rate <= 0 or out_rate <= 0:
            raise InvalidData("bad sample rates")
        self.device = torch.device(device)
        self.in_rate, self.out_rate = in_rate, out_rate
        g = math.gcd(in_rate, out_rate)
        self.num = in_rate // g     # input samples per output step (rational)
        self.den = out_rate // g
        ratio = in_rate / out_rate
        if cutoff is None:
            cutoff = 0.97 * min(1.0, 1.0 / ratio)
        # stretch the filter when downsampling (anti-alias), like
        # swresample's filter_length scaling
        self.taps = max(4, int(math.ceil(filter_size * max(1.0, ratio))) & ~1)
        self.phases = self.den if self.den <= max_phases else max_phases
        self.exact_phase = self.phases == self.den
        bank = fir.build_filter_bank(self.taps, self.phases, cutoff,
                                     window, beta)
        self.bank = torch.from_numpy(bank.astype(np.float32)).to(self.device)
        self.center = self.taps // 2 - 1
        # streaming state: buffer primed with center zeros of history
        self._buf = np.zeros((channels, self.center), np.float32)
        self._buf_start = -self.center   # absolute input index of buf[0]
        self._out_count = 0              # next output index to produce
        self._in_total = 0               # total input samples received
        self.channels = channels

    def _positions(self, k0: int, k1: int):
        k = np.arange(k0, k1, dtype=np.int64)
        pos_num = k * self.num                       # position = pos_num/den
        ipos = pos_num // self.den
        frac = pos_num - ipos * self.den
        if self.exact_phase:
            ph = frac.astype(np.int64)
        else:
            ph = (frac * self.phases) // self.den
        return ipos, ph

    def process(self, x: np.ndarray, final: bool = False) -> np.ndarray:
        """x: (channels, n) float32. Returns (channels, m) float32."""
        x = np.atleast_2d(np.asarray(x, np.float32))
        if x.size:
            self._buf = np.concatenate([self._buf, x], axis=1)
            self._in_total += x.shape[1]
        if final:
            pad = np.zeros((self.channels, self.taps), np.float32)
            self._buf = np.concatenate([self._buf, pad], axis=1)

        # how many outputs can we produce? need ipos - center + taps <= avail
        avail_end = self._buf_start + self._buf.shape[1]
        if final:
            k_max = -(-self._in_total * self.den // self.num)  # ceil
        else:
            # largest exclusive k with floor(k*num/den) <= avail_end+center-taps
            lim = avail_end + self.center - self.taps
            if lim < 0:
                k_max = self._out_count
            else:
                k_max = ((lim + 1) * self.den + self.num - 1) // self.num
        k_max = max(k_max, self._out_count)
        m = int(k_max - self._out_count)
        if m == 0:
            return np.zeros((self.channels, 0), np.float32)

        ipos, ph = self._positions(self._out_count, k_max)
        starts = ipos - self.center - self._buf_start
        dev = self.device
        out = _fir_kernel(
            torch.from_numpy(self._buf).to(dev),
            torch.from_numpy(starts.astype(np.int32)).to(dev),
            torch.from_numpy(ph.astype(np.int32)).to(dev),
            self.bank, self.taps)
        out = out.cpu().numpy()

        self._out_count = k_max
        # drop consumed input (keep enough history for the next window)
        min_start = int(ipos[-1]) - self.center
        drop = max(0, min_start - self._buf_start)
        drop = min(drop, self._buf.shape[1])
        self._buf = self._buf[:, drop:]
        self._buf_start += drop
        return out

    def flush(self) -> np.ndarray:
        return self.process(np.zeros((self.channels, 0), np.float32), final=True)

    @property
    def delay_samples(self) -> int:
        """Pending output samples still inside the filter (swr_get_delay)."""
        produced_if_flushed = -(-self._in_total * self.den // self.num)
        return int(produced_if_flushed - self._out_count)


class SwrContext:
    """Full conversion context (swr_alloc_set_opts2 analog); the resampler's
    FIR runs on `device`, the rest on the host."""

    def __init__(self, in_rate: int, in_layout, in_fmt: str,
                 out_rate: int, out_layout, out_fmt: str,
                 filter_size: int = 32, cutoff: Optional[float] = None,
                 dither: Optional[str] = None,
                 device: torch.device | str = "cuda"):
        self.in_rate, self.out_rate = in_rate, out_rate
        self.in_layout = ChannelLayout.from_string(in_layout)
        self.out_layout = ChannelLayout.from_string(out_layout)
        self.in_fmt = _sf.get(in_fmt)
        self.out_fmt = _sf.get(out_fmt)
        self.dither = dither
        self.matrix = None
        if self.in_layout.nb_channels != self.out_layout.nb_channels or \
                (self.in_layout.mask and self.out_layout.mask
                 and self.in_layout.mask != self.out_layout.mask):
            self.matrix = _rm.build_matrix(self.in_layout, self.out_layout)
        self.resampler = None
        if in_rate != out_rate:
            self.resampler = Resampler(in_rate, out_rate,
                                       self.out_layout.nb_channels,
                                       filter_size=filter_size, cutoff=cutoff,
                                       device=device)
        self._rng = np.random.default_rng(0)

    def set_matrix(self, matrix: np.ndarray) -> None:
        self.matrix = np.asarray(matrix, np.float64)

    def convert(self, data, final: bool = False) -> np.ndarray:
        """data: (in_ch, n) in in_fmt dtype (planar; numpy, or a tensor,
        copied to the host) or None to flush.
        Returns (out_ch, m) in out_fmt dtype (planar), on the host."""
        if data is None:
            data = np.zeros((self.in_layout.nb_channels, 0), self.in_fmt.dtype)
            final = True
        x = np.atleast_2d(host_array(data))
        f = _sf.to_float(x, self.in_fmt)
        if self.matrix is not None:
            f = (self.matrix @ f.astype(np.float64)).astype(np.float32)
        if self.resampler is not None:
            f = self.resampler.process(f, final=final)
        if self.dither and self.out_fmt.dtype.kind in "iu":
            f = self._apply_dither(f)
        return _sf.from_float(f, self.out_fmt)

    # error-feedback noise-shaping filters (published coefficient sets;
    # the reference ships per-rate presets in noise_shaping_data.c)
    _NS_FILTERS = {
        # Lipshitz et al. (1991) 5-tap F-weighted, 44.1/48 kHz
        "lipshitz": [2.033, -2.165, 1.959, -1.590, 0.6149],
        # E-weighted 9-tap (Wannamaker)
        "f_weighted": [2.412, -3.370, 3.937, -4.174, 3.353, -2.205,
                       1.281, -0.569, 0.0847],
        # low-order Shibata-style
        "shibata": [2.8720729351043701172, -5.0413231849670410156,
                    6.2442994117736816406, -5.8483986854553222656,
                    3.7067542076110839844, -1.0495119094848632812,
                    -1.1830236911773681641, 2.1126792430877685547,
                    -1.9094531536102294922, 0.99913084506988525391,
                    -0.17063215374946594238, -0.15374617278575897217],
    }

    def _apply_dither(self, f: np.ndarray) -> np.ndarray:
        """Dither + optional noise shaping before integer output
        (reference: libswresample/dither.c swri_dither/noise shaping)."""
        lsb = 1.0 / (1 << (self.out_fmt.bits - 1))
        method = self.dither
        if method == "rectangular":
            return f + (self._rng.random(f.shape).astype(np.float32)
                        - 0.5) * lsb
        if method in ("tpdf", "triangular"):
            noise = (self._rng.random(f.shape)
                     - self._rng.random(f.shape)).astype(np.float32)
            return f + noise * lsb
        if method == "triangular_hp":
            # high-passed TPDF: difference of consecutive uniform noise
            u = self._rng.random((f.shape[0], f.shape[1] + 1)) - 0.5
            return f + np.diff(u, axis=1).astype(np.float32) * lsb
        coeffs = self._NS_FILTERS.get(method)
        if coeffs is None:
            raise ValueError(f"swr: unknown dither {self.dither!r}")
        # error-feedback noise shaping with TPDF dither (sequential
        # recursion; host-side like the reference's C loop)
        c = np.asarray(coeffs, np.float64)
        taps = len(c)
        out = np.empty_like(f)
        dith = (self._rng.random(f.shape)
                - self._rng.random(f.shape)) * lsb
        for ch in range(f.shape[0]):
            err = np.zeros(taps)
            x = f[ch].astype(np.float64)
            y = np.empty_like(x)
            for n in range(x.shape[0]):
                pred = x[n] + (c * err).sum()
                q = np.round((pred + dith[ch, n]) / lsb) * lsb
                y[n] = q
                err[1:] = err[:-1]
                err[0] = pred - q
            out[ch] = y.astype(np.float32)
        return out

    def flush(self) -> np.ndarray:
        return self.convert(None)

    def convert_frame(self, frame: Frame, final: bool = False) -> Frame:
        out = self.convert(frame.audio_data if frame is not None else None,
                           final=final)
        return Frame.audio(out, self.out_rate, self.out_fmt.name,
                           self.out_layout,
                           pts=frame.pts if frame is not None else None or 0)
