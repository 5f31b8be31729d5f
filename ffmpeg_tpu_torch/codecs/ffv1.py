"""FFV1 decoder, versions 0-3 (reference: libavcodec/ffv1dec.c,
ffv1_parse.c, rangecoder.{c,h}, ffv1dec_template.c).

Lossless intra codec: median prediction with context-modelled
residuals, coded either by the FF range coder (adaptive binary
states) or adaptive Golomb-Rice with run mode.  Both coders are
implemented; output is byte-exact against the reference across
YUV 8-16 bit (incl. alpha) and RGB/RGBA (JPEG2000-RCT, 8-16
bit).

The port's copy of ffmpeg_tpu/codecs/ffv1.py, held equal to it by
tests/test_torch_image_codecs.py.
The range and Golomb decoders stay on the host; each picture's planes,
allocated anew for every frame, go to the device the decoder is opened
on in one upload (device_planes).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.frame import Frame, device_planes
from ..core.packet import Packet
from ..io.stream import MediaType
from ..utils.error import InvalidData, NotSupported
from .codec import DeviceCodec, register_decoder

CONTEXT_SIZE = 32
LOG2_RUN = [
    0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
    4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24]


def _build_rac_states(factor: int, max_p: int):
    one = 1 << 32
    one_state = np.zeros(256, np.int32)
    last_p8 = 0
    p = one // 2
    for _ in range(128):
        p8 = (256 * p + one // 2) >> 32
        if p8 <= last_p8:
            p8 = last_p8 + 1
        if last_p8 and last_p8 < 256 and p8 <= max_p:
            one_state[last_p8] = p8
        p += ((one - p) * factor + one // 2) >> 32
        last_p8 = p8
    for i in range(256 - max_p, max_p + 1):
        if one_state[i]:
            continue
        p = (i * one + 128) >> 8
        p += ((one - p) * factor + one // 2) >> 32
        p8 = (256 * p + one // 2) >> 32
        if p8 <= i:
            p8 = i + 1
        if p8 > max_p:
            p8 = max_p
        one_state[i] = p8
    zero_state = np.zeros(256, np.int32)
    for i in range(1, 255):
        zero_state[i] = 256 - one_state[256 - i]
    return zero_state, one_state


_ZERO_STATE, _ONE_STATE = _build_rac_states(int(0.05 * (1 << 32)),
                                            256 - 8)


class _Rac:
    """FF range decoder (rangecoder.h)."""

    __slots__ = ("data", "pos", "end", "low", "rng", "overread",
                 "zero", "one")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 2
        self.end = len(data)
        self.rng = 0xFF00
        self.low = (data[0] << 8 | data[1]) if len(data) >= 2 else 0
        self.overread = 0
        self.zero = _ZERO_STATE
        self.one = _ONE_STATE
        if self.low >= 0xFF00:
            self.low = 0xFF00
            self.end = self.pos

    def set_tables(self, zero, one):
        """AC_RANGE_CUSTOM_TAB: per-stream state transitions applied
        to slice coders (ffv1.c ff_ffv1_init_slice_state)."""
        self.zero = zero
        self.one = one

    def _refill(self):
        self.rng <<= 8
        self.low <<= 8
        if self.pos < self.end:
            self.low += self.data[self.pos]
            self.pos += 1
        else:
            self.overread += 1

    def get(self, state: np.ndarray, idx: int) -> int:
        s = int(state[idx])
        range1 = (self.rng * s) >> 8
        self.rng -= range1
        if self.low < self.rng:
            state[idx] = self.zero[s]
            if self.rng < 0x100:
                self._refill()
            return 0
        self.low -= self.rng
        state[idx] = self.one[s]
        self.rng = range1
        if self.rng < 0x100:
            self._refill()
        return 1

    def get_symbol(self, state: np.ndarray, is_signed: int) -> int:
        if self.get(state, 0):
            return 0
        e = 0
        while self.get(state, 1 + min(e, 9)):
            e += 1
            if e > 31:
                raise InvalidData("ffv1: bad symbol")
        a = 1
        for i in range(e - 1, -1, -1):
            a += a + self.get(state, 22 + min(i, 9))
        neg = -(is_signed and self.get(state, 11 + min(e, 10)))
        return (a ^ neg) - neg


class _Bits:
    """MSB-first reader with golomb-rice helpers."""

    __slots__ = ("data", "bitpos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.bitpos = 0
        self.nbits = len(data) * 8

    def get1(self) -> int:
        p = self.bitpos
        self.bitpos += 1
        byte = p >> 3
        if byte >= len(self.data):
            return 0
        return (self.data[byte] >> (7 - (p & 7))) & 1

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get1()
        return v

    def peek32(self) -> int:
        p = self.bitpos
        byte = p >> 3
        chunk = self.data[byte:byte + 6] + b"\x00" * 6
        v = int.from_bytes(chunk[:6], "big")
        v >>= 48 - 32 - (p & 7)
        return v & 0xFFFFFFFF

    def ur_golomb(self, k: int, limit: int, esc_len: int) -> int:
        buf = self.peek32()
        log = max(buf.bit_length() - 1, 0)   # av_log2
        if log > 31 - limit:
            buf >>= log - k
            buf += (30 - log) << k
            self.bitpos += 32 + k - log
            return buf
        self.bitpos += limit
        v = self.get(esc_len)
        return v + limit - 1

    def sr_golomb(self, k: int, limit: int, esc_len: int) -> int:
        v = self.ur_golomb(k, limit, esc_len)
        return (v >> 1) ^ -(v & 1)


def _fold(diff: int, bits: int) -> int:
    diff &= (1 << bits) - 1
    if diff >> (bits - 1):
        diff -= 1 << bits
    return diff


def _mid_pred(a, b, c):
    if a > b:
        if c > b:
            c = min(a, c)
        else:
            c = b
    else:
        if b > c:
            c = max(a, c)
        else:
            c = b
    return c


class _VlcState:
    __slots__ = ("drift", "error_sum", "bias", "count")

    def __init__(self):
        self.drift = 0
        self.error_sum = 4
        self.bias = 0
        self.count = 1

    def update(self, v: int):
        drift = self.drift + v
        count = self.count
        self.error_sum += abs(v)
        if count == 128:
            count >>= 1
            drift >>= 1
            self.error_sum >>= 1
        count += 1
        if drift <= -count:
            self.bias = max(self.bias - 1, -128)
            drift = max(drift + count, -count + 1)
        elif drift > 0:
            self.bias = min(self.bias + 1, 127)
            drift = min(drift - count, 0)
        self.drift = drift
        self.count = count


@register_decoder
class Ffv1Decoder(DeviceCodec):
    codec_id = "ffv1"
    codec_type = MediaType.VIDEO

    def __init__(self, par, options=None, *, device="cuda"):
        super().__init__(par, options, device=device)
        self.version = 0
        self.ac = 0
        self.colorspace = 0
        self.bits = 8
        self.chroma_planes = 1
        self.chroma_h = 1
        self.chroma_v = 1
        self.transparency = 0
        self.quant_tables = None          # (5, 256) int32 (v0/1)
        self.context_count = 0
        self.plane_states = None          # per-plane rac states
        self.plane_vlc = None             # per-plane VlcState lists
        self.key_ok = False
        self.width = par.width or 0
        self.height = par.height or 0
        # version >= 2 (global header in extradata)
        self.num_h = 1
        self.num_v = 1
        self.qtabs = []                   # list of (5, 256) tables
        self.qtab_counts = []
        self.initial_states = {}
        self.ec = 0
        self.slice_state = {}             # (slice idx) → state dict
        self.custom_zero = None           # ac==2 transition tables
        self.custom_one = None
        if par.extradata:
            self._read_extra_header(bytes(par.extradata))

    def _read_state_transition(self, rac, state):
        """ac==2: per-stream range-coder transition deltas, applied
        on top of the default table (ffv1_parse.c:104-107, 228-237).
        Decoded with the shared header state; the header coder itself
        keeps the default tables."""
        one = np.zeros(256, np.int32)
        for i in range(1, 256):
            st = rac.get_symbol(state, 1) + int(_ONE_STATE[i])
            if st < 1 or st > 255:
                raise InvalidData("ffv1: bad state transition")
            one[i] = st
        zero = np.zeros(256, np.int32)
        for j in range(1, 256):
            zero[256 - j] = 256 - one[j]
        self.custom_one = one
        self.custom_zero = zero

    def _read_extra_header(self, ed: bytes):
        rac = _Rac(ed)
        state = np.full(CONTEXT_SIZE, 128, np.int32)
        v = rac.get_symbol(state, 0)
        if v < 2 or v > 3:
            raise NotSupported(f"ffv1: global header version {v}")
        self.version = v
        if v > 2:
            rac.end -= 4                  # trailing CRC
            rac.get_symbol(state, 0)      # micro_version
        self.ac = rac.get_symbol(state, 0)
        if self.ac == 2:
            self._read_state_transition(rac, state)
        self.colorspace = rac.get_symbol(state, 0)
        self.bits = rac.get_symbol(state, 0) or 8
        if self.colorspace > 1 or self.bits > 16:
            raise NotSupported("ffv1: colorspace/bit depth")
        self.chroma_planes = rac.get(state, 0)
        self.chroma_h = rac.get_symbol(state, 0)
        self.chroma_v = rac.get_symbol(state, 0)
        self.transparency = rac.get(state, 0)
        self.num_h = 1 + rac.get_symbol(state, 0)
        self.num_v = 1 + rac.get_symbol(state, 0)
        ntab = rac.get_symbol(state, 0)
        self.qtabs = []
        self.qtab_counts = []
        for _ in range(ntab):
            qt = np.zeros((5, 256), np.int32)
            cc = 1
            for i in range(5):
                qt[i], ret = self._read_quant_table(rac, cc)
                cc *= ret
            self.qtabs.append(qt)
            self.qtab_counts.append((cc + 1) // 2)
        state2 = np.full((32, CONTEXT_SIZE), 128, np.int32)
        for t in range(ntab):
            if rac.get(state, 0):
                cc = self.qtab_counts[t]
                init = np.zeros((cc, CONTEXT_SIZE), np.int32)
                for j in range(cc):
                    for k in range(CONTEXT_SIZE):
                        pred = int(init[j - 1][k]) if j else 128
                        init[j][k] = (pred + rac.get_symbol(
                            state2[k], 1)) & 0xFF
                self.initial_states[t] = init
        if v > 2:
            self.ec = rac.get_symbol(state, 0)
            rac.get_symbol(state, 0)      # intra flag (3.4)

    # ---- header ---------------------------------------------------------

    def _read_quant_table(self, rac, scale):
        state = np.full(CONTEXT_SIZE, 128, np.int32)
        table = np.zeros(256, np.int32)
        i = 0
        v = 0
        while i < 128:
            ln = rac.get_symbol(state, 0) + 1
            if ln > 128 - i or ln <= 0:
                raise InvalidData("ffv1: bad quant table")
            for _ in range(ln):
                table[i] = scale * v
                i += 1
            v += 1
        for i in range(1, 128):
            table[256 - i] = -table[i]
        table[128] = -table[127]
        return table, 2 * v - 1

    def _read_header(self, rac):
        state = np.full(CONTEXT_SIZE, 128, np.int32)
        v = rac.get_symbol(state, 0)
        if v >= 2:
            raise NotSupported(f"ffv1: version {v} (only 0/1)")
        self.version = v
        self.ac = rac.get_symbol(state, 0)
        if self.ac == 2:                  # custom state transition
            self._read_state_transition(rac, state)
        self.colorspace = rac.get_symbol(state, 0)
        if v > 0:
            b = rac.get_symbol(state, 0)
            self.bits = b or 8
        else:
            self.bits = 8
        if self.colorspace > 1 or self.bits > 16:
            raise NotSupported("ffv1: colorspace/bit depth")
        self.chroma_planes = rac.get(state, 0)
        self.chroma_h = rac.get_symbol(state, 0)
        self.chroma_v = rac.get_symbol(state, 0)
        self.transparency = rac.get(state, 0)
        qt = np.zeros((5, 256), np.int32)
        context_count = 1
        for i in range(5):
            qt[i], ret = self._read_quant_table(rac, context_count)
            context_count *= ret
            if context_count > 32768:
                raise InvalidData("ffv1: context count")
        self.quant_tables = qt
        self.context_count = (context_count + 1) // 2
        nplanes = 2 + int(self.transparency)
        if self.ac != 0:
            self.plane_states = [
                np.full((self.context_count, CONTEXT_SIZE), 128,
                        np.int32) for _ in range(nplanes)]
        else:
            self.plane_vlc = [
                [_VlcState() for _ in range(self.context_count)]
                for _ in range(nplanes)]

    def _clear_state(self):
        if self.ac != 0:
            for st in self.plane_states:
                st[:] = 128
        else:
            for vl in self.plane_vlc:
                for s in vl:
                    s.__init__()

    # ---- plane decode ---------------------------------------------------

    def _decode_line(self, rac, gb, w, prev, cur, plane, bits, qt,
                     pstates, wrap=False):
        five = bool(qt[3][127] or qt[4][127])
        ac = self.ac
        if ac != 0:
            states = pstates
        else:
            vstates = pstates
        run_count = 0
        run_mode = 0
        run_index = self._run_index
        x = 0
        while x < w:
            # pixel x lives at offset x+2; src[-1] = x+1, src[-2] = x.
            # cur still holds row y-2 at columns >= x (two-buffer
            # ping-pong), which is exactly the reference's TT source.
            L = cur[x + 1]
            LT = prev[x + 1]
            T = prev[x + 2]
            RT = prev[x + 3]
            if five:
                LL = cur[x]
                TT = cur[x + 2]
                context = (int(qt[0][(L - LT) & 255]) +
                           int(qt[1][(LT - T) & 255]) +
                           int(qt[2][(T - RT) & 255]) +
                           int(qt[3][(LL - L) & 255]) +
                           int(qt[4][(TT - T) & 255]))
            else:
                context = (int(qt[0][(L - LT) & 255]) +
                           int(qt[1][(LT - T) & 255]) +
                           int(qt[2][(T - RT) & 255]))
            if context < 0:
                context = -context
                sign = 1
            else:
                sign = 0
            if ac != 0:
                diff = rac.get_symbol(states[context], 1)
            else:
                if context == 0 and run_mode == 0:
                    run_mode = 1
                if run_mode:
                    if run_count == 0 and run_mode == 1:
                        if gb.get1():
                            run_count = 1 << LOG2_RUN[run_index]
                            if x + run_count <= w:
                                run_index += 1
                        else:
                            if LOG2_RUN[run_index]:
                                run_count = gb.get(
                                    LOG2_RUN[run_index])
                            else:
                                run_count = 0
                            if run_index:
                                run_index -= 1
                            run_mode = 2
                    if cur[x + 1] == prev[x + 1]:
                        while run_count > 1 and w - x > 1:
                            cur[x + 2] = prev[x + 2]
                            x += 1
                            run_count -= 1
                    else:
                        while run_count > 1 and w - x > 1:
                            cur[x + 2] = _mid_pred(
                                cur[x + 1],
                                cur[x + 1] + prev[x + 2] -
                                prev[x + 1], prev[x + 2])
                            x += 1
                            run_count -= 1
                    run_count -= 1
                    if run_count < 0:
                        run_mode = 0
                        run_count = 0
                        st = vstates[context]
                        diff = self._vlc_symbol(gb, st, bits)
                        if diff >= 0:
                            diff += 1
                    else:
                        diff = 0
                else:
                    diff = self._vlc_symbol(gb, vstates[context],
                                            bits)
            if sign:
                diff = -diff
            L = cur[x + 1]
            LT = prev[x + 1]
            T = prev[x + 2]
            pred = _mid_pred(L, L + T - LT, T)
            v = (pred + diff) & ((1 << bits) - 1)
            # 16-bit YUV: reference sample buffers are int16_t, so
            # samples wrap to signed — affects mid_pred (the context
            # diffs are mod-256 and thus wrap-invariant)
            if wrap and v >= 0x8000:
                v -= 0x10000
            cur[x + 2] = v
            x += 1
        self._run_index = run_index

    def _vlc_symbol(self, gb, st, bits):
        i = st.count
        k = 0
        while i < st.error_sum:
            k += 1
            i += i
        if k > bits:
            k = bits
        v = gb.sr_golomb(k, 12, bits)
        v ^= (2 * st.drift + st.count) >> 31 if \
            (2 * st.drift + st.count) < 0 else 0
        ret = _fold(v + st.bias, bits)
        st.update(v)
        return ret

    def _decode_plane(self, rac, gb, w, h, plane, qt, pstates,
                      out, ox, oy):
        # two ping-pong rows with a 2-cell left border (reference
        # sample_buffer: memset once, rows swapped, never cleared)
        rows = [[0] * (w + 6), [0] * (w + 6)]
        self._run_index = 0
        wrap = self.bits == 16
        mask = (1 << self.bits) - 1
        for y in range(h):
            prev = rows[y & 1]
            cur = rows[1 - (y & 1)]
            # borders: sample[1][-1] = sample[0][0];
            # sample[0][w] = sample[0][w-1]
            cur[1] = prev[2]
            prev[w + 2] = prev[w + 1]
            self._decode_line(rac, gb, w, prev, cur, plane, self.bits,
                              qt, pstates, wrap=wrap)
            out[oy + y, ox:ox + w] = \
                np.asarray(cur[2:w + 2], np.int64) & mask

    # ---- frame ----------------------------------------------------------

    def _slice_planes(self, idx, key, qt_idx):
        """per-slice adaptive coder state (cleared on keyframes).

        qt_idx is a tuple of quant-table indices, one per coded
        plane (luma/G, chroma/BR, alpha) — ffv1dec.c
        decode_slice_header's plane loop."""
        st = self.slice_state.get(idx)
        if st is None or key or st["qt"] != qt_idx:
            st = {"qt": qt_idx}
            for p, t in zip(("y", "c", "a"), qt_idx):
                cc = self.qtab_counts[t] if self.qtabs else \
                    self.context_count
                if self.ac != 0:
                    init = self.initial_states.get(t)
                    if init is not None:
                        st[p] = init.copy()
                    else:
                        st[p] = np.full((cc, CONTEXT_SIZE), 128,
                                        np.int32)
                else:
                    st[p] = [_VlcState() for _ in range(cc)]
            self.slice_state[idx] = st
        return st

    # ---- RGB (JPEG2000-RCT) ---------------------------------------------

    def _decode_rgb(self, rac, gb, w, h, qts, sts, planes, ox, oy):
        """Interleaved per-row G,B,R(,A) decode + inverse RCT
        (ffv1dec_template.c decode_rgb_frame).  Plane p uses state
        plane (p+1)//2; sample range is bits+1 under RCT with
        offset = 1<<bits (ff_ffv1_compute_bits_per_plane: for
        combined_version < 0x40008, i.e. all v<=3, every plane codes
        bits_raw+1 bits).  run_index resets once per slice, not per
        plane."""
        bits_raw = self.bits
        offset = 1 << bits_raw
        nb = bits_raw + 1
        n = 3 + int(self.transparency)
        maskv = (1 << bits_raw) - 1
        # 9..15-bit RGB without alpha: the reference's int16 store
        # path writes (b, g, r) to planes (0, 1, 2) — the g/b roles
        # in the RCT are historically swapped vs the plane names
        # (encoder mirrors it, so the stream stays lossless)
        swap = (not self.transparency) and 8 < bits_raw < 16
        rows = [[[0] * (w + 6), [0] * (w + 6)] for _ in range(n)]
        self._run_index = 0
        for y in range(h):
            dec = []
            for p in range(n):
                sp = rows[p][y & 1]
                cp = rows[p][1 - (y & 1)]
                cp[1] = sp[2]
                sp[w + 2] = sp[w + 1]
                si = (p + 1) // 2
                self._decode_line(rac, gb, w, sp, cp, si, nb,
                                  qts[si], sts[si])
                dec.append(cp)
            d0, d1, d2 = dec[0], dec[1], dec[2]
            d3 = dec[3] if n == 4 else None
            p0 = planes[0][oy + y]
            p1 = planes[1][oy + y]
            p2 = planes[2][oy + y]
            p3 = planes[3][oy + y] if n == 4 else None
            for x in range(w):
                g = d0[x + 2]
                b = d1[x + 2] - offset
                r = d2[x + 2] - offset
                g -= (b + r) >> 2
                b += g
                r += g
                if swap:
                    p0[ox + x] = b & maskv
                    p1[ox + x] = g & maskv
                else:
                    p0[ox + x] = g & maskv
                    p1[ox + x] = b & maskv
                p2[ox + x] = r & maskv
                if n == 4:
                    p3[ox + x] = d3[x + 2] & maskv

    def _output_fmt(self):
        if self.colorspace == 1:
            base = "gbrap" if self.transparency else "gbrp"
        else:
            base = {(1, 1): "yuv420p", (1, 0): "yuv422p",
                    (0, 0): "yuv444p", (2, 2): "yuv410p",
                    (2, 0): "yuv411p", (0, 1): "yuv440p"}[
                        (self.chroma_h, self.chroma_v)]
            if self.transparency:
                base = "yuva" + base[3:]
        return base if self.bits <= 8 else f"{base}{self.bits}le"

    def _alloc_planes(self, w, h):
        dt = np.uint8 if self.bits <= 8 else np.uint16
        if self.colorspace == 1:
            n = 4 if self.transparency else 3
            return [np.zeros((h, w), dt) for _ in range(n)]
        cw = -(-w >> self.chroma_h)
        ch = -(-h >> self.chroma_v)
        pl = [np.zeros((h, w), dt), np.zeros((ch, cw), dt),
              np.zeros((ch, cw), dt)]
        if self.transparency:
            pl.append(np.zeros((h, w), dt))
        return pl

    def _decode_slice_v3(self, data, idx, key, planes, frame_rac):
        if idx == 0:
            rac = frame_rac
            rac.end = len(data)
        else:
            rac = _Rac(data)
        if self.ac == 2:                  # ffv1.c:99-105
            rac.set_tables(self.custom_zero, self.custom_one)
        state = np.full(CONTEXT_SIZE, 128, np.int32)
        sx = rac.get_symbol(state, 0)
        sy = rac.get_symbol(state, 0)
        sw = rac.get_symbol(state, 0) + 1
        sh = rac.get_symbol(state, 0) + 1
        nplanes = 2 + int(self.transparency)
        qidx = tuple(rac.get_symbol(state, 0) for _ in range(nplanes))
        rac.get_symbol(state, 0)          # picture structure
        rac.get_symbol(state, 0)          # sar num
        rac.get_symbol(state, 0)          # sar den
        W, H = self.width, self.height
        x0 = W * sx // self.num_h
        y0 = H * sy // self.num_v
        x1 = W * (sx + sw) // self.num_h
        y1 = H * (sy + sh) // self.num_v
        st = self._slice_planes(idx, key, qidx)
        gb = None
        if self.ac == 0:
            rac.get(np.full(1, 129, np.int32), 0)   # flush bit (3.2+)
            gb = _Bits(data[rac.pos - 1:])
        w = x1 - x0
        h = y1 - y0
        if self.colorspace == 1:
            self._decode_rgb(rac, gb, w, h,
                             [self.qtabs[qidx[0]],
                              self.qtabs[qidx[1]],
                              self.qtabs[qidx[2]] if len(qidx) > 2
                              else None],
                             [st["y"], st["c"], st.get("a")],
                             planes, x0, y0)
            return
        if not self.chroma_planes and self.transparency:
            raise NotSupported("ffv1: gray+alpha")
        cw = -(-w >> self.chroma_h)
        ch = -(-h >> self.chroma_v)
        cx = x0 >> self.chroma_h
        cy = y0 >> self.chroma_v
        self._decode_plane(rac, gb, w, h, 0, self.qtabs[qidx[0]],
                           st["y"], planes[0], x0, y0)
        if self.chroma_planes:
            self._decode_plane(rac, gb, cw, ch, 1,
                               self.qtabs[qidx[1]], st["c"],
                               planes[1], cx, cy)
            self._decode_plane(rac, gb, cw, ch, 1,
                               self.qtabs[qidx[1]], st["c"],
                               planes[2], cx, cy)
        if self.transparency:
            self._decode_plane(rac, gb, w, h, 2,
                               self.qtabs[qidx[2]], st["a"],
                               planes[3], x0, y0)

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        data = bytes(pkt.data)
        rac = _Rac(data)
        keystate = np.full(1, 128, np.int32)
        key = rac.get(keystate, 0)
        w = self.width
        h = self.height
        if self.version >= 2:
            if not key and not self.key_ok:
                raise InvalidData("ffv1: no keyframe yet")
            self.key_ok = True
            # locate slices from the tail length fields
            trailer = 3 + 5 * (1 if self.ec else 0)
            bounds = []
            end = len(data)
            while end > 3 + trailer:
                if end - trailer < 0:
                    break
                sz = int.from_bytes(data[end - trailer:
                                         end - trailer + 3], "big")
                ln = sz + trailer
                if ln > end or ln <= trailer:
                    break
                bounds.append((end - ln, end))
                end -= ln
                if len(bounds) >= self.num_h * self.num_v:
                    break
            bounds.reverse()
            if len(bounds) != self.num_h * self.num_v:
                raise InvalidData("ffv1: slice chain broken")
            planes = self._alloc_planes(w, h)
            for i, (p0, p1) in enumerate(bounds):
                if i == 0:
                    self._decode_slice_v3(data[:p1], i, key, planes,
                                          rac)
                else:
                    self._decode_slice_v3(data[p0:p1], i, key,
                                          planes, None)
            f = Frame.video(w, h, self._output_fmt(),
                            planes=device_planes(planes, self.device),
                            pts=pkt.pts, time_base=pkt.time_base)
            f.key_frame = bool(key)
            f.pict_type = "I"
            return [f]
        # version 0/1: single slice, header inline on keyframes
        if key:
            self._read_header(rac)
            self.key_ok = True
        elif not self.key_ok:
            raise InvalidData("ffv1: non-keyframe without keyframe")
        if key:
            self._clear_state()
        if not w or not h:
            raise InvalidData("ffv1: unknown dimensions")
        if self.ac == 2:                  # applied after header read
            rac.set_tables(self.custom_zero, self.custom_one)
        gb = None
        if self.ac == 0:
            ac_bytes = rac.pos - 1
            gb = _Bits(data[ac_bytes:])
        planes = self._alloc_planes(w, h)
        if self.colorspace == 1:
            qt = self.quant_tables
            self._decode_rgb(rac, gb, w, h, [qt, qt, qt],
                             [self._plane_state(0),
                              self._plane_state(1),
                              self._plane_state(2)
                              if self.transparency else None],
                             planes, 0, 0)
        else:
            if not self.chroma_planes and self.transparency:
                raise NotSupported("ffv1: gray+alpha")
            cw = -(-w >> self.chroma_h)
            ch = -(-h >> self.chroma_v)
            self._decode_plane(rac, gb, w, h, 0, self.quant_tables,
                               self._plane_state(0), planes[0], 0, 0)
            if self.chroma_planes:
                self._decode_plane(
                    rac, gb, cw, ch, 1, self.quant_tables,
                    self._plane_state(1), planes[1], 0, 0)
                self._decode_plane(
                    rac, gb, cw, ch, 1, self.quant_tables,
                    self._plane_state(1), planes[2], 0, 0)
            else:
                planes[1][:] = 1 << (self.bits - 1)
                planes[2][:] = 1 << (self.bits - 1)
            if self.transparency:
                self._decode_plane(
                    rac, gb, w, h, 2, self.quant_tables,
                    self._plane_state(2), planes[3], 0, 0)
        f = Frame.video(w, h, self._output_fmt(),
                        planes=device_planes(planes, self.device),
                        pts=pkt.pts, time_base=pkt.time_base)
        f.key_frame = bool(key)
        f.pict_type = "I"
        return [f]

    def _plane_state(self, plane):
        if self.ac != 0:
            return self.plane_states[plane]
        return self.plane_vlc[plane]

    def flush_state(self):
        self.key_ok = False
