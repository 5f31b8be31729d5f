"""FFV1 encoder, version 1 with the FF range coder (reference:
libavcodec/ffv1enc.c, rangecoder.{c,h}, ffv1enc_template.c).

Lossless intra encode: median prediction with context-modelled
residuals coded by adaptive binary range-coder states.  The bitstream
interoperates with the reference decoder (differential tests decode
our output with the reference binary and compare byte-exact against
the input) and with our own Ffv1Decoder.

Scope: version 1 (header inline on keyframes), ac=1 (range coder,
default state-transition table), small (3-neighbour) context model,
single slice, YUV planar 8-16 bit (+gray, +alpha) and RGB/RGBA via
the JPEG2000 reversible colour transform.  The quant table is our
own 11-level layout — the table is carried in the header, so any
conforming decoder reads it (ffv1dec.c read_quant_table).

The port's copy of ffmpeg_tpu/codecs/ffv1_enc.py, held equal to it by
tests/test_torch_image_codecs.py.
The encoder copies a frame's planes to the host once (Frame.numpy,
which gives 16-bit planes their unsigned type).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.frame import Frame
from ..core.packet import Packet, PKT_FLAG_KEY
from ..io.stream import MediaType
from ..utils.error import NotSupported
from .codec import DeviceCodec, register_encoder
from .ffv1 import CONTEXT_SIZE, _ONE_STATE, _ZERO_STATE, _fold, _mid_pred


class _RacEnc:
    """FF range encoder (rangecoder.h renorm_encoder/put_rac,
    carry handled via the outstanding-byte chain)."""

    __slots__ = ("low", "rng", "out", "ob", "oc", "zero", "one")

    def __init__(self):
        self.low = 0
        self.rng = 0xFF00
        self.out = bytearray()
        self.ob = -1          # outstanding byte (-1 = none yet)
        self.oc = 0           # outstanding 0xFF/0x00 run length
        self.zero = _ZERO_STATE
        self.one = _ONE_STATE

    def _renorm(self):
        low = self.low
        if low <= 0xFF00 or low >= 0x10000:
            m = 0xFF if low <= 0xFF00 else 0x00
            b = (self.ob + (0 if low <= 0xFF00 else 1)) & 0xFF
            if self.ob >= 0:
                self.out.append(b)
            if self.oc:
                self.out.extend(bytes([m]) * self.oc)
                self.oc = 0
            self.ob = low >> 8
        else:
            self.oc += 1
        self.low = (low & 0xFF) << 8
        self.rng <<= 8

    def put(self, state: np.ndarray, idx: int, bit: int):
        s = int(state[idx])
        r1 = (self.rng * s) >> 8
        if bit:
            self.low += self.rng - r1
            self.rng = r1
            state[idx] = self.one[s]
        else:
            self.rng -= r1
            state[idx] = self.zero[s]
        if self.rng < 0x100:
            self._renorm()

    def put_symbol(self, state: np.ndarray, v: int, is_signed: int):
        """ffv1enc.c put_symbol_inline: zero flag, unary exponent,
        mantissa MSB-first, sign — with the >9 clamping."""
        if v == 0:
            self.put(state, 0, 1)
            return
        a = abs(v) if is_signed else v
        e = a.bit_length() - 1
        self.put(state, 0, 0)
        if e <= 9:
            for i in range(e):
                self.put(state, 1 + i, 1)
            self.put(state, 1 + e, 0)
            for i in range(e - 1, -1, -1):
                self.put(state, 22 + i, (a >> i) & 1)
            if is_signed:
                self.put(state, 11 + e, int(v < 0))
        else:
            for i in range(e):
                self.put(state, 1 + min(i, 9), 1)
            self.put(state, 10, 0)
            for i in range(e - 1, -1, -1):
                self.put(state, 22 + min(i, 9), (a >> i) & 1)
            if is_signed:
                self.put(state, 21, int(v < 0))

    def terminate(self) -> bytes:
        """ff_rac_terminate(c, 0): round low up, flush twice."""
        self.rng = 0xFF
        self.low += 0xFF
        self._renorm()
        self.rng = 0xFF
        self._renorm()
        return bytes(self.out)


# Our 11-level quant layout (levels must be consecutive from 0 so the
# run-length header coding round-trips; boundaries are an encoder
# choice, carried in the header).
_QBOUNDS = (1, 3, 7, 15, 31)


def _build_quant_table() -> np.ndarray:
    """(5, 256) int32 with dims 3/4 zero (small context model)."""
    pos = np.zeros(128, np.int64)
    for b in _QBOUNDS:
        pos[b:] += 1
    qt = np.zeros((5, 256), np.int64)
    scale = 1
    for d in range(3):
        nlev = len(_QBOUNDS) + 1           # 6 → 11 signed values
        qt[d, :128] = scale * pos
        for i in range(1, 128):
            qt[d, 256 - i] = -qt[d, i]
        qt[d, 128] = -qt[d, 127]
        scale *= 2 * nlev - 1
    return qt.astype(np.int32), (scale + 1) // 2


def _write_quant_table(rac: _RacEnc, table: np.ndarray):
    """ffv1enc.c write_quant_table: run lengths over the positive
    half, symbol = len-1 (pairs with ffv1.py _read_quant_table)."""
    state = np.full(CONTEXT_SIZE, 128, np.int32)
    last = 0
    for i in range(1, 128):
        if table[i] != table[i - 1]:
            rac.put_symbol(state, i - last - 1, 0)
            last = i
    rac.put_symbol(state, 128 - last - 1, 0)


_YUV_SHIFTS = {"yuv420p": (1, 1), "yuv422p": (1, 0), "yuv444p": (0, 0),
               "yuv410p": (2, 2), "yuv411p": (2, 0), "yuv440p": (0, 1)}


@register_encoder
class Ffv1Encoder(DeviceCodec):
    codec_id = "ffv1"
    codec_type = MediaType.VIDEO
    is_encoder = True

    def __init__(self, par, options=None, *, device="cuda"):
        super().__init__(par, options, device=device)
        self.width = par.width
        self.height = par.height
        fmt = par.pix_fmt or "yuv420p"
        self.fmt = fmt
        self.bits = 8
        self.colorspace = 0
        self.chroma_planes = 1
        self.chroma_h = self.chroma_v = 0
        self.transparency = 0
        base = fmt
        for suff in ("16le", "14le", "12le", "10le", "9le"):
            if fmt.endswith(suff):
                self.bits = int(suff[:-2])
                base = fmt[:-len(suff)]
                break
        if base.startswith("gbrap"):
            self.colorspace = 1
            self.transparency = 1
        elif base.startswith("gbrp"):
            self.colorspace = 1
        elif base.startswith("gray"):
            self.chroma_planes = 0
        else:
            if base.startswith("yuva"):
                self.transparency = 1
                base = "yuv" + base[4:]
            if base not in _YUV_SHIFTS:
                raise NotSupported(f"ffv1enc: pix_fmt {fmt}")
            self.chroma_h, self.chroma_v = _YUV_SHIFTS[base]
        self.quant_table, self.context_count = _build_quant_table()
        self._states = None
        par.codec_id = "ffv1"

    # ---- per-line encode (mirror of ffv1.py _decode_line, ac path) ----

    def _encode_line(self, rac, w, prev, cur, bits, qt, states):
        mask = (1 << bits) - 1
        q0, q1, q2 = qt[0], qt[1], qt[2]
        for x in range(w):
            L = cur[x + 1]
            LT = prev[x + 1]
            T = prev[x + 2]
            RT = prev[x + 3]
            context = (int(q0[(L - LT) & 255]) +
                       int(q1[(LT - T) & 255]) +
                       int(q2[(T - RT) & 255]))
            v = cur[x + 2]
            pred = _mid_pred(L, L + T - LT, T)
            diff = _fold(v - pred, bits)
            if context < 0:
                context = -context
                diff = -diff
            rac.put_symbol(states[context], diff, 1)

    def _encode_plane(self, rac, data, bits, states):
        """data: (h, w) int64 samples already in coded space."""
        h, w = data.shape
        rows = [[0] * (w + 6), [0] * (w + 6)]
        wrap = bits == 16
        for y in range(h):
            prev = rows[y & 1]
            cur = rows[1 - (y & 1)]
            line = data[y]
            if wrap:
                # decoder stores int16-wrapped samples (ffv1.py wrap)
                for x in range(w):
                    v = int(line[x])
                    cur[x + 2] = v - 0x10000 if v >= 0x8000 else v
            else:
                for x in range(w):
                    cur[x + 2] = int(line[x])
            cur[1] = prev[2]
            prev[w + 2] = prev[w + 1]
            self._encode_line(rac, w, prev, cur, bits, self.quant_table,
                              states)

    def _encode_rgb(self, rac, planes):
        """ffv1enc_template.c encode_rgb_frame: forward RCT, plane p
        coded with state plane (p+1)//2 at bits+1; the 9..15-bit
        no-alpha plane swap mirrors the decoder."""
        bits = self.bits
        nb = bits + 1
        offset = 1 << bits
        msk = (1 << nb) - 1
        n = 3 + self.transparency
        swap = (not self.transparency) and 8 < bits < 16
        if swap:
            g = planes[1].astype(np.int64)
            b = planes[0].astype(np.int64)
        else:
            g = planes[0].astype(np.int64)
            b = planes[1].astype(np.int64)
        r = planes[2].astype(np.int64)
        b = b - g
        r = r - g
        g = g + ((b + r) >> 2)
        coded = [g & msk, (b + offset) & msk, (r + offset) & msk]
        if n == 4:
            coded.append(planes[3].astype(np.int64) & msk)
        h, w = coded[0].shape
        rows = [[[0] * (w + 6), [0] * (w + 6)] for _ in range(n)]
        states = self._states
        for y in range(h):
            for p in range(n):
                sp = rows[p][y & 1]
                cp = rows[p][1 - (y & 1)]
                line = coded[p][y]
                for x in range(w):
                    cp[x + 2] = int(line[x])
                cp[1] = sp[2]
                sp[w + 2] = sp[w + 1]
                si = (p + 1) // 2
                self._encode_line(rac, w, sp, cp, nb,
                                  self.quant_table, states[si])

    # ---- header -------------------------------------------------------

    def _write_header(self, rac):
        state = np.full(CONTEXT_SIZE, 128, np.int32)
        rac.put_symbol(state, 1, 0)                    # version
        rac.put_symbol(state, 1, 0)                    # ac = range coder
        rac.put_symbol(state, self.colorspace, 0)
        rac.put_symbol(state, self.bits if self.bits != 8 else 0, 0)
        rac.put(state, 0, self.chroma_planes)
        rac.put_symbol(state, self.chroma_h, 0)
        rac.put_symbol(state, self.chroma_v, 0)
        rac.put(state, 0, self.transparency)
        for d in range(5):
            _write_quant_table(rac, self.quant_table[d])

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        rac = _RacEnc()
        keystate = np.full(1, 128, np.int32)
        rac.put(keystate, 0, 1)                        # keyframe
        self._write_header(rac)
        nplanes = 2 + self.transparency
        self._states = [np.full((self.context_count, CONTEXT_SIZE), 128,
                                np.int32) for _ in range(nplanes)]
        planes = frame.numpy().planes
        if self.colorspace == 1:
            self._encode_rgb(rac, planes)
        else:
            self._encode_plane(rac, planes[0].astype(np.int64),
                               self.bits, self._states[0])
            if self.chroma_planes:
                self._encode_plane(rac, planes[1].astype(np.int64),
                                   self.bits, self._states[1])
                self._encode_plane(rac, planes[2].astype(np.int64),
                                   self.bits, self._states[1])
            if self.transparency:
                self._encode_plane(rac, planes[-1].astype(np.int64),
                                   self.bits, self._states[2])
        data = rac.terminate()
        return [Packet(data=data, pts=frame.pts, dts=frame.pts,
                       duration=frame.duration, flags=PKT_FLAG_KEY,
                       time_base=frame.time_base)]
