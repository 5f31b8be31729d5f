"""MP3 (MPEG-1/2/2.5 audio Layer III) decoder.

Reference: libavcodec/mpegaudiodec_template.c + mpegaudiodec_common.c.
Counterpart of ffmpeg_tpu/codecs/mp3.py.  Host/device split: the serial
bit work (header/side info/scalefactors/Huffman, bit reservoir) runs on
the host; requantization, stereo and alias reduction are vectorized
numpy (the reference's host code, copied); the hybrid IMDCT filterbank
and the 32-band polyphase synthesis run on the decoder's device
(ops/mp3fb.py), one call of each per packet over all its granules and
time slots.  Layers I and II share the synthesis filterbank.  The
overlap and the synthesis FIFO stay tensors on the device between
packets; each packet's PCM comes back to the host in one copy.

`stats`, when a list, gets one dict per decoded packet: host ms (the
parse, and the copies' host time), the h2d bytes, and the device split
by CUDA events on a card (by the host's clock on the CPU): h2d, the
filterbank, d2h."""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..core.frame import Frame
from ..core.packet import Packet
from ..formats.channel_layout import default_layout
from ..utils.error import InvalidData
from ..utils.rational import Rational
from ..io.stream import MediaType
from .codec import Codec, register_decoder
from . import mp3_tables as T
from ..ops import mp3fb
from .vp9.recon_tpu import _Timer

SBLIMIT = 32
MODE_EXT_MS = 2
MODE_EXT_I = 1


# ---------------------------------------------------------------------------
# Huffman LUT construction (ff_vlc_init_from_lengths code assignment:
# sequential left-aligned canonical codes in table order)

def _build_lut(entries):
    """entries: [(len, symbol)] → (maxlen, np arrays sym/len indexed by
    maxlen-bit prefix)."""
    maxlen = max(l for l, _ in entries)
    size = 1 << maxlen
    sym_t = np.zeros(size, np.int32)
    len_t = np.zeros(size, np.int8)
    code = 0
    for l, sym in entries:
        base = (code >> (32 - l)) << (maxlen - l)
        n = 1 << (maxlen - l)
        sym_t[base:base + n] = sym
        len_t[base:base + n] = l
        code += 1 << (32 - l)
    return maxlen, sym_t, len_t


_HUFF_LUTS = []          # 15 pair tables (index 0 unused -> vlc 1..15)
_QUAD_LUTS = []


def _init_tables():
    if _HUFF_LUTS:
        return
    pos = 0
    for n in T.HUFF_SIZES:
        entries = [(T.HUFF_LENS[pos + i], T.HUFF_SYMBOLS[pos + i])
                   for i in range(n)]
        _HUFF_LUTS.append(_build_lut(entries))
        pos += n
    for codes, bits in zip(T.QUAD_CODES, T.QUAD_BITS):
        maxlen = max(bits)
        size = 1 << maxlen
        sym_t = np.zeros(size, np.int32)
        len_t = np.zeros(size, np.int8)
        for sym in range(16):
            l = bits[sym]
            base = codes[sym] << (maxlen - l)
            n = 1 << (maxlen - l)
            sym_t[base:base + n] = sym
            len_t[base:base + n] = l
        _QUAD_LUTS.append((maxlen, sym_t, len_t))


_BAND_INDEX_LONG = None   # (9, 23) half-sample (pair) offsets


def _band_index_long():
    global _BAND_INDEX_LONG
    if _BAND_INDEX_LONG is None:
        idx = np.zeros((9, 23), np.int32)
        for i in range(9):
            k = 0
            for j in range(22):
                k += T.BAND_SIZE_LONG[i][j] >> 1
                idx[i][j + 1] = k
        _BAND_INDEX_LONG = idx
    return _BAND_INDEX_LONG


# ---------------------------------------------------------------------------

class _Bits:
    """MSB-first bit reader with absolute positions; reads past the end
    return zero bits (the decoder clamps to part2_3_length anyway)."""

    __slots__ = ("d", "pos", "n")

    def __init__(self, data: bytes):
        self.d = data + b"\x00" * 8     # zero tail for safe overpeek
        self.pos = 0
        self.n = len(data) * 8

    def get(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        p = self.pos
        self.pos = p + nbits
        end = p + nbits
        first = p >> 3
        last = (end + 7) >> 3
        v = int.from_bytes(self.d[first:last], "big")
        return (v >> ((last << 3) - end)) & ((1 << nbits) - 1)

    def peek(self, nbits: int) -> int:
        p = self.pos
        v = self.get(nbits)
        self.pos = p
        return v


class _Granule:
    __slots__ = ("part23", "big_values", "global_gain", "scalefac_compress",
                 "block_type", "switch_point", "table_select",
                 "subblock_gain", "preflag", "scalefac_scale",
                 "count1_table", "region_size", "long_end", "short_start",
                 "scale_factors", "sb_hybrid")

    def __init__(self):
        self.table_select = [0, 0, 0]
        self.subblock_gain = [0, 0, 0]
        self.region_size = [0, 0, 0]
        self.scale_factors = np.zeros(40, np.int32)
        self.sb_hybrid = np.zeros(576, np.float32)


_FREQS = [44100, 48000, 32000]
_BR_V1L3 = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
            320, 0]
_BR_V2L3 = [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
            160, 0]


@register_decoder
class Mp3Decoder(Codec):
    """MPEG audio Layers II and III (Layer II methods attached below)."""

    codec_id = "mp3"
    codec_type = MediaType.AUDIO
    aliases = ("mp2", "mp1")

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        self.stats: Optional[list] = None
        self._timer: Optional[_Timer] = None
        _init_tables()
        self._resv = b""
        self._resv_valid = False
        self._overlap = None        # (ch, 32, 18) on the device
        self._fifo = None           # (ch, 16, 64) on the device
        self._csa = self._make_csa()
        self._is_mpeg1 = None

    @staticmethod
    def _make_csa():
        ci = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041,
                       -0.0142, -0.0037], np.float64)
        cs = 1.0 / np.sqrt(1.0 + ci * ci)
        ca = ci * cs
        return cs.astype(np.float32), ca.astype(np.float32)

    def flush_state(self) -> None:
        self._resv = b""
        self._resv_valid = False
        self._overlap = None
        self._fifo = None

    # --- device filterbank -----------------------------------------------------
    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def _filterbank(self, xr: np.ndarray, bt: np.ndarray) -> np.ndarray:
        """Layer III: the hybrid IMDCT and the synthesis of one packet's
        (ngr, ch, 32, 18) spectra with their (ngr, ch, 32) block types on
        the device, the overlap and FIFO carried there → (ch, ngr*576)
        host PCM."""
        def imdct_synth(xr_d, bt_d):
            sb, self._overlap = mp3fb.imdct_packet(xr_d, bt_d, self._overlap)
            return self._synth(sb)
        return self._run(imdct_synth, xr, bt)

    def _synthesize(self, sb: np.ndarray) -> np.ndarray:
        """Layers I and II: the synthesis of (ch, slots, 32) subband
        samples on the device → (ch, slots*32) host PCM."""
        return self._run(self._synth, sb)

    def _synth(self, sb: torch.Tensor) -> torch.Tensor:
        pcm, self._fifo = mp3fb.synth_packet(sb, self._fifo)
        return pcm

    def _run(self, fn, *host: np.ndarray) -> np.ndarray:
        """fn over `host` arrays copied to the device, its result copied
        back once; the split into `stats` when it is a list."""
        tm = self._timer
        if tm is not None:
            tm.host_mark("parse")
            tm.h2d_bytes = sum(a.nbytes for a in host)
            tm.dev_mark("h2d")
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in host]
        if tm is not None:
            tm.dev_mark("filterbank")
        out = fn(*args)
        if tm is not None:
            tm.dev_mark("d2h")
        pcm = out.cpu().numpy()
        if tm is not None:
            tm.dev_mark("end")
            tm.host_mark("device")
            self.stats.append({"host": dict(tm.host),
                               "h2d_bytes": tm.h2d_bytes,
                               "d2h_bytes": pcm.nbytes,
                               "device": tm.device_ms()})
        return pcm

    # --- header ---------------------------------------------------------------
    def _parse_header(self, h: int):
        if (h >> 21) & 0x7FF != 0x7FF:
            raise InvalidData("mp3: bad sync")
        ver = (h >> 19) & 3            # 3=MPEG1, 2=MPEG2, 0=MPEG2.5
        layer = 4 - ((h >> 17) & 3)
        if layer not in (1, 2, 3):
            raise InvalidData(f"mp3: layer {layer} not supported")
        br_idx = (h >> 12) & 15
        sr_idx = (h >> 10) & 3
        if sr_idx >= 3:
            raise InvalidData("mp3: bad sample rate")
        mode = (h >> 6) & 3
        mode_ext = (h >> 4) & 3
        lsf = 0 if ver == 3 else 1
        mpeg25 = 1 if ver == 0 else 0
        rate = _FREQS[sr_idx] >> (lsf + mpeg25)
        # sample_rate_index in table space: 0..8
        sri = sr_idx + 3 * (lsf + mpeg25)
        nch = 1 if mode == 3 else 2
        return lsf, mpeg25, sri, rate, nch, mode, mode_ext, br_idx, layer

    # --- scale factors ----------------------------------------------------------
    def _read_scale_factors_mpeg1(self, bits, g, g_prev, ch, gr, scfsi):
        slen1 = T.SLEN_TABLE[0][g.scalefac_compress]
        slen2 = T.SLEN_TABLE[1][g.scalefac_compress]
        sf = g.scale_factors
        if g.block_type == 2:
            n = 17 if g.switch_point else 18
            for i in range(n):
                sf[i] = bits.get(slen1) if slen1 else 0
            for i in range(n, 35):
                sf[i] = bits.get(slen2) if slen2 else 0
            sf[35:39] = 0
        else:
            groups = ((0, 6, slen1), (6, 11, slen1), (11, 16, slen2),
                      (16, 21, slen2))
            for gi, (a, b, sl) in enumerate(groups):
                if gr == 1 and (scfsi & (0x8 >> gi)):
                    sf[a:b] = g_prev.scale_factors[a:b]
                else:
                    for i in range(a, b):
                        sf[i] = bits.get(sl) if sl else 0
            sf[21] = 0

    def _read_scale_factors_lsf(self, bits, g, ch, mode_ext):
        # ISO 13818-3 2.4.3.2 (lsf_sf_expand)
        sc = g.scalefac_compress
        is_chan = (mode_ext & MODE_EXT_I) and ch == 1
        if is_chan:
            sc >>= 1
        slen = [0, 0, 0, 0]
        if not is_chan:
            if sc < 400:
                slen[0] = (sc >> 4) // 5
                slen[1] = (sc >> 4) % 5
                slen[2] = (sc & 15) >> 2
                slen[3] = sc & 3
                tindex2 = 0
            elif sc < 500:
                sc -= 400
                slen[0] = (sc >> 2) // 5
                slen[1] = (sc >> 2) % 5
                slen[2] = sc & 3
                slen[3] = 0
                tindex2 = 1
            else:
                sc -= 500
                slen[0] = sc // 3
                slen[1] = sc % 3
                slen[2] = slen[3] = 0
                if g.block_type == 2:
                    g.preflag = 0
                else:
                    g.preflag = 1
                tindex2 = 2
        else:
            if sc < 180:
                slen[0] = sc // 36
                slen[1] = (sc % 36) // 6
                slen[2] = (sc % 36) % 6
                slen[3] = 0
                tindex2 = 3
            elif sc < 244:
                sc -= 180
                slen[0] = (sc & 63) >> 4
                slen[1] = (sc & 15) >> 2
                slen[2] = sc & 3
                slen[3] = 0
                tindex2 = 4
            else:
                sc -= 244
                slen[0] = sc // 3
                slen[1] = sc % 3
                slen[2] = slen[3] = 0
                tindex2 = 5
        if g.block_type == 2:
            tindex = 2 if g.switch_point else 1
        else:
            tindex = 0
        sf = g.scale_factors
        j = 0
        for k in range(4):
            n = T.LSF_NSF_TABLE[tindex2][tindex][k]
            sl = slen[k]
            for _ in range(n):
                sf[j] = bits.get(sl) if sl else 0
                j += 1
        sf[j:40] = 0

    # --- huffman + requant -------------------------------------------------------
    def _huffman(self, bits, g, exponents, end_pos, sri):
        out = g.sb_hybrid
        out[:] = 0.0
        s_index = 0
        for region in range(3):
            npairs = g.region_size[region]
            tsel = g.table_select[region]
            vlc_idx, linbits = T.HUFF_DATA[tsel]
            if vlc_idx == 0:
                s_index += npairs * 2
                continue
            maxlen, sym_t, len_t = _HUFF_LUTS[vlc_idx - 1]
            for _ in range(npairs):
                if bits.pos >= end_pos:
                    break
                pf = bits.peek(maxlen)
                sym = sym_t[pf]
                l = len_t[pf]
                if l == 0:
                    raise InvalidData("mp3: bad huffman code")
                bits.pos += int(l)
                x, y = sym >> 4, sym & 15
                for val, idx in ((x, s_index), (y, s_index + 1)):
                    if val:
                        if val == 15 and linbits:
                            val += bits.get(linbits)
                        v = float(val) ** (4.0 / 3.0)
                        if bits.get(1):
                            v = -v
                        out[idx] = v * _exp2_quarter(exponents[idx])
                s_index += 2
        # count1 region
        maxlen, sym_t, len_t = _QUAD_LUTS[g.count1_table]
        while bits.pos < end_pos and s_index <= 572:
            pf = bits.peek(maxlen)
            sym = sym_t[pf]
            l = len_t[pf]
            bits.pos += int(l)
            for j in range(4):
                if sym & (8 >> j):
                    v = 1.0
                    if bits.get(1):
                        v = -1.0
                    if s_index + j < 576:
                        out[s_index + j] = v * _exp2_quarter(
                            exponents[min(s_index + j, 575)])
            s_index += 4
        if bits.pos > end_pos and s_index >= 4:
            # overread: roll back the last quad (mpegaudiodec huffman_decode
            # bits_left < 0 handling)
            s_index -= 4
            out[s_index:s_index + 4] = 0.0
        bits.pos = end_pos

    # --- granule pipeline ---------------------------------------------------------
    def _exponents(self, g, sri):
        exps = np.zeros(576, np.int32)
        gain = g.global_gain - 210
        shift = g.scalefac_scale + 1
        pretab = T.PRETAB if g.preflag else [0] * 22
        bsl = T.BAND_SIZE_LONG[sri]
        pos = 0
        for i in range(g.long_end):
            v = gain - ((int(g.scale_factors[i]) + pretab[i]) << shift)
            exps[pos:pos + bsl[i]] = v
            pos += bsl[i]
        if g.short_start < 13:
            bss = T.BAND_SIZE_SHORT[sri]
            gains = [gain - (sg << 3) for sg in g.subblock_gain]
            k = g.long_end
            for i in range(g.short_start, 13):
                for l in range(3):
                    v = gains[l] - (int(g.scale_factors[k]) << shift)
                    k += 1
                    exps[pos:pos + bss[i]] = v
                    pos += bss[i]
        return exps

    def _stereo(self, g0, g1, sri, mode_ext, lsf):
        if mode_ext & MODE_EXT_I:
            self._intensity_ms(g0, g1, sri, mode_ext, lsf)
        elif mode_ext & MODE_EXT_MS:
            a = g0.sb_hybrid.copy()
            g0.sb_hybrid[:] = a + g1.sb_hybrid
            g1.sb_hybrid[:] = a - g1.sb_hybrid
            # 1/sqrt(2) folded into global gain by the encoder (ISO note)

    def _intensity_ms(self, g0, g1, sri, mode_ext, lsf):
        isqrt2 = 1.0 / math.sqrt(2.0)
        if not lsf:
            tanv = np.tan(np.arange(7) * (np.pi / 12.0))
            is_t0 = np.where(np.isfinite(tanv), tanv / (1 + tanv), 1.0)
            is_t1 = np.where(np.isfinite(tanv), 1.0 / (1 + tanv), 0.0)
            sf_max = 7
        else:
            i = np.arange(16)
            e = 2.0 ** (-((i + 1) >> 1) *
                        (1.0 if (g1.scalefac_compress & 1) else 0.5))
            is_t0 = np.where(i % 2 == 1, e, 1.0)
            is_t1 = np.where(i % 2 == 1, 1.0, e)
            is_t0[0] = 1.0
            is_t1[0] = 1.0
            sf_max = 16
        tab0, tab1 = g0.sb_hybrid, g1.sb_hybrid
        bsl = T.BAND_SIZE_LONG[sri]
        bss = T.BAND_SIZE_SHORT[sri]

        def ms(a, b):
            if mode_ext & MODE_EXT_MS:
                t = tab0[a:b].copy()
                tab0[a:b] = (t + tab1[a:b]) * isqrt2
                tab1[a:b] = (t - tab1[a:b]) * isqrt2

        pos = 576
        if g1.short_start < 13:
            nzf = [False, False, False]
            k = (13 - g1.short_start) * 3 + g1.long_end - 3
            for i in range(12, g1.short_start - 1, -1):
                if i != 11:
                    k -= 3
                ln = bss[i]
                for l in (2, 1, 0):
                    pos -= ln
                    if not nzf[l]:
                        if np.any(tab1[pos:pos + ln] != 0):
                            nzf[l] = True
                        else:
                            sf = int(g1.scale_factors[k + l])
                            if sf >= sf_max:
                                nzf[l] = True
                            else:
                                t = tab0[pos:pos + ln].copy()
                                tab0[pos:pos + ln] = t * is_t0[sf]
                                tab1[pos:pos + ln] = t * is_t1[sf]
                                continue
                    ms(pos, pos + ln)
            nz = any(nzf)
        else:
            nz = False
        for i in range(g1.long_end - 1, -1, -1):
            ln = bsl[i]
            pos -= ln
            if not nz:
                if np.any(tab1[pos:pos + ln] != 0):
                    nz = True
                else:
                    sf = int(g1.scale_factors[20 if i == 21 else i])
                    if sf >= sf_max:
                        nz = True
                    else:
                        t = tab0[pos:pos + ln].copy()
                        tab0[pos:pos + ln] = t * is_t0[sf]
                        tab1[pos:pos + ln] = t * is_t1[sf]
                        continue
            ms(pos, pos + ln)

    def _reorder(self, g, sri):
        if g.block_type != 2:
            return
        start = 36 if g.switch_point else 0
        x = g.sb_hybrid
        pos = start
        bss = T.BAND_SIZE_SHORT[sri]
        for i in range(g.short_start, 13):
            ln = bss[i]
            blk = x[pos:pos + 3 * ln].reshape(3, ln)
            x[pos:pos + 3 * ln] = blk.T.ravel()
            pos += 3 * ln

    def _antialias(self, g):
        if g.block_type == 2:
            if not g.switch_point:
                return
            n = 1
        else:
            n = SBLIMIT - 1
        cs, ca = self._csa
        x = g.sb_hybrid
        for b in range(1, n + 1):
            p = 18 * b
            lo = x[p - 8:p][::-1].copy()     # x[p-1-j] j=0..7
            hi = x[p:p + 8].copy()
            x[p - 8:p] = (lo * cs - hi * ca)[::-1]
            x[p:p + 8] = hi * cs + lo * ca

    # --- main ----------------------------------------------------------------
    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or len(pkt.data) < 4:
            return []
        self._timer = _Timer(self.device) if self.stats is not None \
            else None
        data = pkt.data
        h = int.from_bytes(data[:4], "big")
        lsf, mpeg25, sri, rate, nch, mode, mode_ext, br_idx, layer = \
            self._parse_header(h)
        crc = not (h & 0x10000)
        bits = _Bits(data)
        bits.pos = 32 + (16 if crc else 0)
        if layer == 1:
            return self._decode_layer1(bits, pkt, lsf, rate, nch, mode,
                                       mode_ext, br_idx)
        if layer == 2:
            return self._decode_layer2(bits, pkt, lsf, rate, nch, mode,
                                       mode_ext, br_idx)

        ngr = 1 if lsf else 2
        granules = [[_Granule() for _ in range(nch)] for _ in range(ngr)]
        if not lsf:
            main_data_begin = bits.get(9)
            bits.get(3 if nch == 2 else 5)   # private
            scfsi = [bits.get(4) for _ in range(nch)]
        else:
            main_data_begin = bits.get(8)
            bits.get(2 if nch == 2 else 1)
            scfsi = [0] * nch

        for gr in range(ngr):
            for ch in range(nch):
                g = granules[gr][ch]
                g.part23 = bits.get(12)
                g.big_values = bits.get(9)
                if g.big_values > 288:
                    raise InvalidData("mp3: big_values too big")
                g.global_gain = bits.get(8)
                if (mode_ext & (MODE_EXT_MS | MODE_EXT_I)) == MODE_EXT_MS:
                    g.global_gain -= 2
                g.scalefac_compress = bits.get(9 if lsf else 4)
                g.preflag = 0
                if bits.get(1):              # window switching
                    g.block_type = bits.get(2)
                    if g.block_type == 0:
                        raise InvalidData("mp3: reserved block type")
                    g.switch_point = bits.get(1)
                    for i in range(2):
                        g.table_select[i] = bits.get(5)
                    g.table_select[2] = 0
                    for i in range(3):
                        g.subblock_gain[i] = bits.get(3)
                    # init_short_region
                    if g.block_type == 2 and not g.switch_point:
                        g.region_size[0] = 72 // 2 if sri == 8 else 36 // 2
                    else:
                        if sri <= 2:
                            g.region_size[0] = 36 // 2
                        elif sri != 8:
                            g.region_size[0] = 54 // 2
                        else:
                            g.region_size[0] = 108 // 2
                    g.region_size[1] = 576 // 2
                else:
                    g.block_type = 0
                    g.switch_point = 0
                    for i in range(3):
                        g.table_select[i] = bits.get(5)
                    ra1 = bits.get(4)
                    ra2 = bits.get(3)
                    bil = _band_index_long()[sri]
                    g.region_size[0] = int(bil[ra1 + 1])
                    g.region_size[1] = int(bil[min(ra1 + ra2 + 2, 22)])
                if not lsf:
                    g.preflag = bits.get(1)
                g.scalefac_scale = bits.get(1)
                g.count1_table = bits.get(1)
                # region sizes -> truncated to big_values, in pairs
                g.region_size[2] = 576 // 2
                j = 0
                for i in range(3):
                    k = min(g.region_size[i], g.big_values)
                    g.region_size[i] = k - j
                    j = k
                # band indexes
                if g.block_type == 2:
                    if g.switch_point:
                        g.long_end = 8 if sri <= 2 else 6
                        g.short_start = 3
                    else:
                        g.long_end = 0
                        g.short_start = 0
                else:
                    g.long_end = 22
                    g.short_start = 13

        # ---- bit reservoir --------------------------------------------------
        cur_main = data[bits.pos // 8:]
        if main_data_begin:
            if not self._resv_valid or main_data_begin > len(self._resv):
                # cannot decode this frame; keep feeding the reservoir
                self._resv = (self._resv + cur_main)[-511:]
                self._resv_valid = True
                return []
            main = self._resv[len(self._resv) - main_data_begin:] + cur_main
        else:
            main = cur_main
        self._resv = (self._resv + cur_main)[-511:]
        self._resv_valid = True

        mb = _Bits(main)
        nsamples = 576 * ngr
        for gr in range(ngr):
            for ch in range(nch):
                g = granules[gr][ch]
                start = mb.pos
                if not lsf:
                    self._read_scale_factors_mpeg1(
                        mb, g, granules[0][ch], ch, gr, scfsi[ch])
                else:
                    self._read_scale_factors_lsf(mb, g, ch, mode_ext)
                exps = self._exponents(g, sri)
                self._huffman(mb, g, exps, start + g.part23, sri)
            if nch == 2:
                self._stereo(granules[gr][0], granules[gr][1], sri,
                             mode_ext, lsf)
            for ch in range(nch):
                g = granules[gr][ch]
                self._reorder(g, sri)
                self._antialias(g)

        # ---- filterbank (device): every granule of the packet at once --------
        if self._overlap is None or self._overlap.shape[0] != nch:
            self._overlap = self._zeros(nch, 32, 18)
            self._fifo = self._zeros(nch, 16, 64)
        xr = np.stack([[granules[gr][ch].sb_hybrid.reshape(32, 18)
                        for ch in range(nch)] for gr in range(ngr)])
        bt = np.zeros((ngr, nch, 32), np.int32)
        for gr in range(ngr):
            for ch in range(nch):
                g = granules[gr][ch]
                bt[gr, ch, :] = g.block_type
                if g.block_type == 2 and g.switch_point:
                    bt[gr, ch, :2] = 0   # mixed: first 2 subbands are long
        pcm = self._filterbank(xr, bt)

        f = Frame.audio(pcm, rate, "fltp", default_layout(nch),
                        pts=pkt.pts,
                        time_base=pkt.time_base or Rational(1, rate))
        f.duration = nsamples
        return [f]



def _l2_requant(mant, steps):
    """ISO 11172-3 Layer II requantization to (-1, 1) float."""
    return (2.0 * mant + 1.0 - steps) / steps


_SF_TABLE = 2.0 * (2.0 ** (-1.0 / 3.0)) ** np.arange(64)


class _Mp2Mixin:
    def _decode_layer2(self, bits, pkt, lsf, rate, nch, mode, mode_ext,
                       br_idx):
        """Layer II (ISO 11172-3 §2.4.3.3 / mpegaudiodec_template.c
        mp_decode_layer2). Bit allocation + scalefactors on host, the
        32-band polyphase synthesis shared with Layer III on device."""
        bitrate = (_BR_V2L3 if lsf else
                   [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
                    256, 320, 384, 0])[br_idx]
        ch_bitrate = bitrate // nch
        if not lsf:
            if (rate == 48000 and ch_bitrate >= 56) or \
                    (56 <= ch_bitrate <= 80):
                table = 0
            elif rate != 48000 and ch_bitrate >= 96:
                table = 1
            elif rate != 32000 and ch_bitrate <= 48:
                table = 2
            else:
                table = 3
        else:
            table = 4
        sblimit = T.SBLIMITS[table]
        alloc = T.ALLOC_TABLES[table]
        bound = (mode_ext + 1) * 4 if mode == 1 else sblimit
        bound = min(bound, sblimit)

        bit_alloc = np.zeros((2, sblimit), np.int32)
        j = 0
        for i in range(bound):
            nb = alloc[j]
            for ch in range(nch):
                bit_alloc[ch, i] = bits.get(nb)
            j += 1 << nb
        for i in range(bound, sblimit):
            nb = alloc[j]
            v = bits.get(nb)
            bit_alloc[0, i] = v
            bit_alloc[1, i] = v
            j += 1 << nb

        scale_code = np.zeros((2, sblimit), np.int32)
        for i in range(sblimit):
            for ch in range(nch):
                if bit_alloc[ch, i]:
                    scale_code[ch, i] = bits.get(2)
        sf = np.zeros((2, sblimit, 3), np.int32)
        for i in range(sblimit):
            for ch in range(nch):
                if not bit_alloc[ch, i]:
                    continue
                code = scale_code[ch, i]
                if code == 0:
                    sf[ch, i] = [bits.get(6), bits.get(6), bits.get(6)]
                elif code == 2:
                    v = bits.get(6)
                    sf[ch, i] = [v, v, v]
                elif code == 1:
                    a, c = bits.get(6), bits.get(6)
                    sf[ch, i] = [a, a, c]
                else:
                    a, c = bits.get(6), bits.get(6)
                    sf[ch, i] = [a, c, c]

        sb = np.zeros((nch, 36, 32), np.float32)
        for k in range(3):
            for l in range(0, 12, 3):
                j = 0
                for i in range(sblimit):
                    nb = alloc[j]
                    for ch in range(nch if i < bound else 1):
                        b = bit_alloc[ch, i]
                        if b:
                            qindex = alloc[j + b]
                            qbits = T.QUANT_BITS[qindex]
                            steps = T.QUANT_STEPS[qindex]
                            scale = _SF_TABLE[sf[ch, i, k]]
                            if qbits < 0:       # grouped: 3 values
                                v = bits.get(-qbits)
                                for m in range(3):
                                    mant = v % steps
                                    v //= steps
                                    sb[ch, k * 12 + l + m, i] = \
                                        _l2_requant(mant, steps) * scale
                            else:
                                for m in range(3):
                                    mant = bits.get(qbits)
                                    sb[ch, k * 12 + l + m, i] = \
                                        _l2_requant(mant, steps) * scale
                            if i >= bound:      # jstereo shared samples
                                sb[1, k * 12 + l:k * 12 + l + 3, i] = \
                                    sb[0, k * 12 + l:k * 12 + l + 3, i] \
                                    * _SF_TABLE[sf[1, i, k]] / scale \
                                    if bit_alloc[1, i] else 0.0
                    j += 1 << nb

        # synthesis: all 36 slots in one call (shared with mp3)
        if self._fifo is None or self._fifo.shape[0] != nch:
            self._fifo = self._zeros(nch, 16, 64)
        pcm = self._synthesize(sb)
        f = Frame.audio(pcm, rate, "fltp", default_layout(nch),
                        pts=pkt.pts,
                        time_base=pkt.time_base or Rational(1, rate))
        f.duration = 1152
        return [f]


class _Mp1Mixin:
    def _decode_layer1(self, bits, pkt, lsf, rate, nch, mode, mode_ext,
                       br_idx):
        """Layer I (ISO 11172-3 §2.4.3.2 / mpegaudiodec_template.c
        mp_decode_layer1): 4-bit allocation, one 6-bit scalefactor and
        12 linear samples per subband; synthesis shared with II/III."""
        bound = (mode_ext + 1) * 4 if mode == 1 else 32
        alloc = np.zeros((2, 32), np.int32)
        for i in range(bound):
            for ch in range(nch):
                alloc[ch, i] = bits.get(4)
        for i in range(bound, 32):
            v = bits.get(4)
            alloc[0, i] = alloc[1, i] = v
        sf = np.zeros((2, 32), np.int32)
        for i in range(32):
            for ch in range(nch):
                if alloc[ch, i]:
                    sf[ch, i] = bits.get(6)
        sb = np.zeros((nch, 12, 32), np.float32)
        for j in range(12):
            for i in range(32):
                if i < bound:
                    for ch in range(nch):
                        n = alloc[ch, i]
                        if n:
                            b = n + 1
                            v = bits.get(b)
                            x = (2 * v + 1 - (1 << b)) / float((1 << b) - 1)
                            sb[ch, j, i] = x * _SF_TABLE[sf[ch, i]]
                else:
                    n = alloc[0, i]
                    if n:
                        b = n + 1
                        v = bits.get(b)
                        x = (2 * v + 1 - (1 << b)) / float((1 << b) - 1)
                        for ch in range(nch):
                            sb[ch, j, i] = x * _SF_TABLE[sf[ch, i]]
        if self._fifo is None or self._fifo.shape[0] != nch:
            self._fifo = self._zeros(nch, 16, 64)
        pcm = self._synthesize(sb)
        f = Frame.audio(pcm, rate, "fltp", default_layout(nch),
                        pts=pkt.pts,
                        time_base=pkt.time_base or Rational(1, rate))
        f.duration = 384
        return [f]


Mp3Decoder._decode_layer2 = _Mp2Mixin._decode_layer2
Mp3Decoder._decode_layer1 = _Mp1Mixin._decode_layer1


_EXP2_TABLE = None


def _exp2_quarter(e: int) -> float:
    """2^(e/4) via a table over the useful exponent range."""
    global _EXP2_TABLE
    if _EXP2_TABLE is None:
        _EXP2_TABLE = 2.0 ** (np.arange(-800, 800) * 0.25)
    return _EXP2_TABLE[int(e) + 800]
