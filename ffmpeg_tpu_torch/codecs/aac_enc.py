"""AAC-LC encoder (counterpart of ffmpeg_tpu/codecs/aac_enc.py; ISO
14496-3; reference: libavcodec/aacenc*.c).

The analysis MDCT runs on the encoder's device (ops/tx.py): one call per
`encode()` over every block that the call codes, (blocks·channels, 2048),
with one copy to the device and one back (codecs/audio_tx.py), where the
reference makes one call per 1024-sample frame.  Each block's window
reads only input samples (the previous block is the previous input), so
no transform waits for another.  Every decision after the MDCT (the
scalefactors, the quantiser, the codebooks, the packing) is the
reference's host code in float64, in its order.  `stats`, when a list,
gets each call's split.

Rate control is constant-quality
(a quality-scaled allowed-distortion per scalefactor band, the
two-loop search reduced to a direct scalefactor solve per band) with
long windows only; the output is plain ADTS that the reference
decoder reads.

Syntax emitted: ADTS header, SCE (mono) or CPE without
common_window/M-S (stereo), section data with run-length codebook
sections, differential scalefactor coding, and spectral huffman for
codebooks 1-11 including escapes."""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..core.packet import Packet
from ..io.stream import MediaType
from ..utils.rational import Rational
from ..formats import samplefmt as _sf
from ..ops import tx
from . import audio_tx
from .codec import Codec, register_encoder
from .bitstream import BitWriter
from . import aac_tables as T

SAMPLE_RATES = [96000, 88200, 64000, 48000, 44100, 32000, 24000,
                22050, 16000, 12000, 11025, 8000, 7350]

_CB_INFO = {1: (4, True, 1), 2: (4, True, 1), 3: (4, False, 2),
            4: (4, False, 2), 5: (2, True, 4), 6: (2, True, 4),
            7: (2, False, 7), 8: (2, False, 7), 9: (2, False, 12),
            10: (2, False, 12), 11: (2, False, 16)}

# smallest codebook usable for a band's max absolute value
_MAXVAL_CB = [0, 1, 3, 5, 5, 7, 7, 7, 9, 9, 9, 9, 9, 11, 11, 11, 11]


def _quantize(x: np.ndarray, sf: int) -> np.ndarray:
    """AAC quantizer: round(|x|^(3/4) * 2^(-3/16*sf')) with the 0.4054
    magic offset (aacenc quantize_bands)."""
    a = np.abs(x) * (2.0 ** (-sf / 4.0))
    q = np.floor(a ** 0.75 + 0.4054).astype(np.int64)
    return np.where(x < 0, -q, q)


class _SpectralCoder:
    def __init__(self, bw: BitWriter):
        self.bw = bw

    def _code(self, cb: int, idx: int):
        self.bw.put(int(T.SPECTRAL_CODES[cb - 1][idx]),
                    int(T.SPECTRAL_BITS[cb - 1][idx]))

    def encode_band(self, cb: int, vals: np.ndarray):
        dim, signed, lav = _CB_INFO[cb]
        bw = self.bw
        for k in range(0, len(vals), dim):
            tup = [int(v) for v in vals[k:k + dim]]
            while len(tup) < dim:
                tup.append(0)
            if cb == 11:
                clip = [min(abs(v), 16) for v in tup]
            elif not signed:
                clip = [abs(v) for v in tup]
            else:
                clip = tup
            if dim == 4:
                if signed:
                    idx = ((clip[0] + 1) * 27 + (clip[1] + 1) * 9 +
                           (clip[2] + 1) * 3 + (clip[3] + 1))
                else:
                    idx = (clip[0] * 27 + clip[1] * 9 + clip[2] * 3 +
                           clip[3])
            else:
                m = lav + 1 if cb == 11 else \
                    (2 * lav + 1 if signed else lav + 1)
                if signed:
                    idx = (clip[0] + lav) * m + (clip[1] + lav)
                else:
                    idx = clip[0] * m + clip[1]
            self._code(cb, idx)
            if not signed:
                for v in tup:
                    if v:
                        bw.put(1 if v < 0 else 0, 1)
            if cb == 11:
                for v in tup:
                    a = abs(v)
                    if a >= 16:
                        # escape: unary extension + mantissa
                        nb = a.bit_length() - 1
                        for _ in range(nb - 4):
                            bw.put(1, 1)
                        bw.put(0, 1)
                        bw.put(a - (1 << nb), nb)


@register_encoder
class AacEncoder(Codec):
    codec_id = "aac"
    codec_type = MediaType.AUDIO
    is_encoder = True

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = audio_tx.open_device(device)
        self.stats: Optional[list] = None
        self.sample_rate = par.sample_rate or 44100
        if self.sample_rate not in SAMPLE_RATES:
            raise ValueError(f"aac: unsupported rate "
                             f"{self.sample_rate}")
        self.sr_index = SAMPLE_RATES.index(self.sample_rate)
        self.channels = (par.ch_layout.nb_channels
                         if par.ch_layout else 1)
        if self.channels > 2:
            raise ValueError("aac: >2 channels not supported")
        opts = options or {}
        # quality 1 (best) .. 5; scales the allowed noise floor
        self.quality = float(opts.get("quality", 2))
        self.swb_offset = list(T.SWB_OFFSET_1024[self.sr_index]) + \
            [1024]
        self.num_swb = int(T.NUM_SWB_1024[self.sr_index])
        self.max_sfb = self.num_swb
        self._prev = np.zeros((self.channels, 1024), np.float64)
        self._fifo = np.zeros((self.channels, 0), np.float64)
        self._window = tx.sine_window(2048).astype(np.float64)
        self._nframes = 0
        self._pts0 = None
        # calibrate the forward-MDCT scale against the decoder's
        # imdct convention (scale=1/512/65536 + sine-window OLA) by
        # running an actual analysis→synthesis roundtrip on a probe
        probe = np.sin(np.arange(4096) * 0.05)
        w = self._window
        blocks = [probe[i:i + 2048] * w for i in (0, 1024, 2048)]
        specs = audio_tx.run(lambda x: tx.mdct(x, 1024), np.stack(blocks),
                             self.device)
        recs = audio_tx.run(lambda x: tx.imdct(x, 1024,
                                               scale=1.0 / 512 / 65536),
                            specs, self.device)
        # middle 1024 of the probe = tail of block0 + head of block1
        ola = recs[0][1024:] * w[1024:] + recs[1][:1024] * w[:1024]
        ref = probe[1024:2048]
        g = float(np.dot(ola, ref) / np.dot(ref, ref))
        self._spec_scale = 1.0 / g

    # ---- per-band coding ------------------------------------------------

    def decide(self, spec: np.ndarray):
        """The band decisions of one channel's scaled spectrum (1024,):
        (levels, scalefactors, codebooks) per band, as the reference's
        individual_channel_stream makes them."""
        nb = self.max_sfb
        offs = self.swb_offset
        band_q: List[np.ndarray] = []
        band_sf = [0] * nb
        band_cb = [0] * nb
        gref = math.sqrt(float(np.mean(spec * spec)) + 1e-12)
        for b in range(nb):
            x = spec[offs[b]:offs[b + 1]]
            energy = float(np.sum(x * x))
            peak = float(np.max(np.abs(x))) if len(x) else 0.0
            if energy < 1e-2 or peak <= 0:
                band_q.append(np.zeros(len(x), np.int64))
                continue
            # allowed RMS error: relative to the band (constant SNR,
            # coarser with quality and band index) but floored by a
            # fraction of the frame-wide level (simple masking proxy)
            rel = 10.0 ** (-(3.6 - 0.35 * self.quality - 0.03 * b))
            target = max(math.sqrt(energy / len(x)) * rel,
                         gref * 10.0 ** (-(4.4 - 0.3 * self.quality)))
            # scalefactor so the quantization step ~ matches target:
            # err ≈ 2^(sf/4) * 0.35 per line in the x^{3/4} domain
            sf = int(round(4 * math.log2(max(target, 1e-9) / 0.35)))
            # clamp so the largest value stays codable (<8191)
            while peak * 2 ** (-sf / 4.0) > 7500 ** (4.0 / 3.0):
                sf += 1
            sf = max(-100, min(155, sf))
            q = _quantize(x, sf)
            if not np.any(q):
                band_q.append(q)
                continue
            band_q.append(q)
            band_sf[b] = sf
            mx = int(np.max(np.abs(q)))
            band_cb[b] = _MAXVAL_CB[mx] if mx < len(_MAXVAL_CB) \
                else 11
        # zero bands get cb 0
        for b in range(nb):
            if band_cb[b] == 0:
                band_sf[b] = 0
        # scalefactor diffs are limited to ±60: smooth
        prev = None
        for b in range(nb):
            if band_cb[b] == 0:
                continue
            if prev is not None:
                band_sf[b] = max(prev - 60, min(prev + 60,
                                                band_sf[b]))
                if band_sf[b] != prev:
                    pass
                band_q[b] = _quantize(
                    spec[offs[b]:offs[b + 1]], band_sf[b])
                mx = int(np.max(np.abs(band_q[b])))
                band_cb[b] = (_MAXVAL_CB[mx]
                              if mx < len(_MAXVAL_CB) else 11) \
                    if mx else 0
            prev = band_sf[b] if band_cb[b] else prev
        return band_q, band_sf, band_cb

    def _encode_channel(self, bw: BitWriter, spec: np.ndarray):
        """one individual_channel_stream with its ics_info."""
        nb = self.max_sfb
        band_q, band_sf, band_cb = self.decide(spec)
        # global gain = first coded band's sf (offset convention:
        # decoder starts its accumulator at global_gain and our sf
        # values live in the same 2^{sf/4} domain as 'sf-100' there,
        # so store sf+100)
        first = next((b for b in range(nb) if band_cb[b]), None)
        global_gain = (band_sf[first] + 100) if first is not None \
            else 100
        bw.put(global_gain & 0xFF, 8)
        # ics_info
        bw.put(0, 1)                      # ics_reserved
        bw.put(0, 2)                      # ONLY_LONG
        bw.put(0, 1)                      # sine window
        bw.put(self.max_sfb, 6)
        bw.put(0, 1)                      # no prediction
        # section_data (5-bit lengths, esc 31)
        b = 0
        while b < nb:
            cb = band_cb[b]
            run = 1
            while b + run < nb and band_cb[b + run] == cb:
                run += 1
            bw.put(cb, 4)
            left = run
            while left >= 31:
                bw.put(31, 5)
                left -= 31
            bw.put(left, 5)
            b += run
        # scale_factor_data
        sf_prev = global_gain - 100
        for b in range(nb):
            if not band_cb[b]:
                continue
            diff = band_sf[b] - sf_prev
            assert -60 <= diff <= 60
            bw.put(int(T.SCALEFACTOR_CODES[diff + 60]),
                   int(T.SCALEFACTOR_BITS[diff + 60]))
            sf_prev = band_sf[b]
        bw.put(0, 1)                      # no pulse
        bw.put(0, 1)                      # no tns
        bw.put(0, 1)                      # no gain control
        sc = _SpectralCoder(bw)
        for b in range(nb):
            if band_cb[b]:
                sc.encode_band(band_cb[b], band_q[b])

    def _spectra(self, blocks: List[np.ndarray]) -> np.ndarray:
        """The scaled MDCT of each of `blocks` ((ch, 1024) each, in order)
        windowed with the block before it, in one device call →
        (len(blocks), ch, 1024) float64; `_prev` becomes the last block."""
        nch = self.channels
        win = np.stack([np.concatenate([prev, block], axis=1)
                        for prev, block in zip([self._prev] + blocks[:-1],
                                               blocks)]) * \
            self._window[None, None, :]
        self._prev = blocks[-1].copy()
        spec = audio_tx.run(lambda x: tx.mdct(x, 1024),
                            win.reshape(len(blocks) * nch, 2048),
                            self.device, audio_tx.start(self.device,
                                                        self.stats),
                            self.stats)
        return spec.reshape(len(blocks), nch, 1024) * self._spec_scale

    def _encode_frame(self, spec: np.ndarray) -> bytes:
        """spec (ch, 1024), one block's scaled MDCT → one ADTS frame."""
        nch = self.channels
        bw = BitWriter()
        if nch == 1:
            bw.put(0, 3)                  # SCE
            bw.put(0, 4)                  # instance
            self._encode_channel(bw, spec[0])
        else:
            bw.put(1, 3)                  # CPE
            bw.put(0, 4)
            bw.put(0, 1)                  # common_window = 0
            self._encode_channel(bw, spec[0])
            self._encode_channel(bw, spec[1])
        bw.put(7, 3)                      # END
        bw.align()
        payload = bw.bytes()
        ln = len(payload) + 7
        h = BitWriter()
        h.put(0xFFF, 12)
        h.put(1, 1)                       # MPEG-4... (ID=1: MPEG-2? 0)
        h.put(0, 2)
        h.put(1, 1)                       # no CRC
        h.put(1, 2)                       # profile LC (object type-1)
        h.put(self.sr_index, 4)
        h.put(0, 1)
        h.put(self.channels, 3)
        h.put(0, 4)
        h.put(ln, 13)
        h.put(0x7FF, 11)
        h.put(0, 2)                       # one raw data block
        return h.bytes() + payload

    # ---- Codec interface ------------------------------------------------

    def encode(self, frame) -> List[Packet]:
        out: List[Packet] = []
        if frame is not None:
            x = _sf.to_float(frame.audio_data, frame.format)
            if self._pts0 is None:
                self._pts0 = frame.pts if frame.pts is not None else 0
            self._fifo = np.concatenate(
                [self._fifo, np.asarray(x, np.float64)], axis=1)
        flush = frame is None
        blocks = []
        while self._fifo.shape[1] >= 1024 or \
                (flush and self._fifo.shape[1] > 0):
            block = self._fifo[:, :1024]
            if block.shape[1] < 1024:
                block = np.pad(block,
                               ((0, 0), (0, 1024 - block.shape[1])))
            self._fifo = self._fifo[:, 1024:]
            blocks.append(block)
        last = blocks[-1] if blocks else self._prev
        tail = flush and last is not None and np.any(last)
        if tail:
            # final frame to flush the MDCT overlap
            blocks.append(np.zeros((self.channels, 1024), np.float64))
        if not blocks:
            return out
        for spec in self._spectra(blocks):
            data = self._encode_frame(spec)
            pts = (self._pts0 or 0) + self._nframes * 1024
            out.append(Packet(data=data, pts=pts, dts=pts,
                              duration=1024, flags=1,
                              time_base=Rational(1,
                                                 self.sample_rate)))
            self._nframes += 1
        return out
