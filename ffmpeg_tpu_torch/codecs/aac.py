"""AAC decoder (counterpart of ffmpeg_tpu/codecs/aac.py; reference:
libavcodec/aac/aacdec*.c).  The LC core: SCE/CPE/LFE elements, section/
scalefactor/spectral Huffman, PNS, M/S and intensity stereo, TNS, and the
four window sequences; and HE-AAC v1/v2: SBR (aacsbr.py) and PS
(aacps.py) on the core's PCM, at twice the core's rate, 2048 samples a
packet, PS upmixing a mono SCE to stereo.

Split: the bitstream work on the host (Python, with the spectral Huffman
walk in the port's C++, `csrc/host/aac_spectral.cpp`); the IMDCT on the
decoder's device through ops/tx.py; window and overlap-add in numpy on
the host; SBR and PS on the host in numpy, as in the reference.
`decode_frames` parses every packet first, then runs one device IMDCT
per window class over the whole batch and copies each class's result to
the host once, then runs each packet's SBR in packet order.  A packet's
SBR payloads are read where the parse finds them but decoded when that
packet's SBR runs (`_SbrPayloads`), so that each SBR context reads its
payloads and applies them in the reference's order, one packet after
the other.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Optional

import numpy as np
import torch

from .. import native
from .aacsbr import SBRContext
from ..core.frame import Frame
from ..core.packet import Packet
from ..formats.channel_layout import default_layout
from ..io.stream import MediaType
from ..ops import tx
from ..utils.error import InvalidData, NotSupported
from . import aac_tables as T
from .bitstream import BitReader
from .codec import Codec, register_decoder

SAMPLE_RATES = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                16000, 12000, 11025, 8000, 7350]

# element types
SCE, CPE, CCE, LFE, DSE, PCE, FIL, END = range(8)
# special codebooks
ZERO_BT, NOISE_BT, INTENSITY_BT2, INTENSITY_BT = 0, 13, 14, 15
ESC_BT = 11

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = range(4)

# IMDCT scales: 2/N x 2^-16 normalisation (PCM in [-1, 1))
LONG_SCALE = 1.0 / 512 / 65536
SHORT_SCALE = 1.0 / 64 / 65536


def _build_lut(codes, bits):
    maxlen = max(bits)
    lut_sym = np.zeros(1 << maxlen, np.int32)
    lut_len = np.zeros(1 << maxlen, np.uint8)
    for i, (c, l) in enumerate(zip(codes, bits)):
        lo = c << (maxlen - l)
        hi = lo + (1 << (maxlen - l))
        lut_sym[lo:hi] = i
        lut_len[lo:hi] = l
    return lut_sym, lut_len, maxlen


_SPECTRAL_LUTS = [_build_lut(T.SPECTRAL_CODES[i], T.SPECTRAL_BITS[i])
                  for i in range(11)]
_SF_LUT = _build_lut(T.SCALEFACTOR_CODES, T.SCALEFACTOR_BITS)

# codebook properties: (dim, signed, lav)
_CB_INFO = {1: (4, True, 1), 2: (4, True, 1), 3: (4, False, 2),
            4: (4, False, 2), 5: (2, True, 4), 6: (2, True, 4),
            7: (2, False, 7), 8: (2, False, 7), 9: (2, False, 12),
            10: (2, False, 12), 11: (2, False, 16)}


def _huff(br: BitReader, lut) -> int:
    sym, lens, maxlen = lut
    look = br.peek(maxlen)
    l = lens[look]
    if l == 0:
        raise InvalidData("aac: bad huffman code")
    br.skip(int(l))
    return int(sym[look])


@lru_cache(maxsize=1)
def _spectral_blob():
    """The eleven spectral LUTs flattened for the C++ walker, built once:
    (symbols, lengths, offsets, max lengths)."""
    syms, lens, offs, maxl = [], [], [0], []
    for s, ln, m in _SPECTRAL_LUTS:
        syms.append(s.astype(np.int32))
        lens.append(ln.astype(np.uint8))
        offs.append(offs[-1] + len(s))
        maxl.append(m)
    return (np.concatenate(syms), np.concatenate(lens),
            np.asarray(offs, np.int32), np.asarray(maxl, np.int32))


@dataclass
class ICSInfo:
    window_sequence: int = ONLY_LONG
    window_shape: int = 0
    max_sfb: int = 0
    num_windows: int = 1
    num_window_groups: int = 1
    group_len: List[int] = field(default_factory=lambda: [1])
    swb_offset: List[int] = field(default_factory=list)
    num_swb: int = 0


@dataclass
class _SbrPayloads:
    """One packet's SBR extension payloads (FIL elements of type
    EXT_SBR_DATA or EXT_SBR_DATA_CRC), found by the parse: the packet's
    raw data block, the core's sample rate then, and for each payload in
    bitstream order the element it follows ("sce"/"cpe", tag), its CRC
    flag and the bit position where it starts."""
    data: bytes
    sample_rate: int
    ext: list = field(default_factory=list)


@dataclass
class ChannelData:
    coeffs: np.ndarray = None        # (1024,) float
    ics: ICSInfo = None
    band_cb: list = None             # [group][sfb] codebook
    band_sf: list = None             # [group][sfb] scalefactor value


def decode_spectral(br: BitReader, ics: ICSInfo, band_cb: list) -> np.ndarray:
    """Quantised spectral coefficients of one ICS by the port's C++
    (`aac_decode_spectral`); advances `br` past them."""
    lib = native.get()
    syms, lens, offs, maxl = _spectral_blob()
    out = np.zeros(1024, np.int32)
    cb_arr = np.asarray(band_cb, np.int32).reshape(-1)
    swb = np.asarray(ics.swb_offset[:ics.max_sfb + 1], np.int32)
    gl = np.asarray(ics.group_len[:ics.num_window_groups], np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    pos = lib.aac_decode_spectral(
        bytes(br.data), br.nbits, br.pos,
        cb_arr.ctypes.data_as(i32p), swb.ctypes.data_as(i32p),
        gl.ctypes.data_as(i32p), ics.num_window_groups, ics.max_sfb,
        1 if ics.window_sequence == EIGHT_SHORT else 0,
        syms.ctypes.data_as(i32p),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offs.ctypes.data_as(i32p), maxl.ctypes.data_as(i32p),
        out.ctypes.data_as(i32p))
    if pos < 0:
        raise InvalidData("aac: bad huffman code")
    br.pos = pos
    return out.astype(np.float64)


def decode_spectral_plain(br: BitReader, ics: ICSInfo,
                          band_cb: list) -> np.ndarray:
    """The C++ walker's plain version: the reference's Python loop."""
    coeffs = np.zeros(1024, np.float64)
    base = 0
    for g in range(ics.num_window_groups):
        glen = ics.group_len[g]
        for sfb in range(ics.max_sfb):
            cb = band_cb[g][sfb]
            lo = ics.swb_offset[sfb]
            hi = ics.swb_offset[sfb + 1]
            if cb in (ZERO_BT, NOISE_BT, INTENSITY_BT, INTENSITY_BT2):
                continue
            dim, signed, lav = _CB_INFO[cb]
            lut = _SPECTRAL_LUTS[cb - 1]
            for w in range(glen):
                off = base + w * 128 + lo
                n = hi - lo
                k = 0
                while k < n:
                    idx = _huff(br, lut)
                    if dim == 4:
                        if signed:
                            vals = [idx // 27 % 3 - 1, idx // 9 % 3 - 1,
                                    idx // 3 % 3 - 1, idx % 3 - 1]
                        else:
                            vals = [idx // 27 % 3, idx // 9 % 3,
                                    idx // 3 % 3, idx % 3]
                    else:
                        m = lav + 1 if cb == ESC_BT else \
                            (2 * lav + 1 if signed else lav + 1)
                        if signed:
                            vals = [idx // m - lav, idx % m - lav]
                        else:
                            vals = [idx // m, idx % m]
                    if not signed:
                        for i, v in enumerate(vals):
                            if v:
                                if br.get(1):
                                    vals[i] = -v
                    if cb == ESC_BT:
                        for i, v in enumerate(vals):
                            if abs(v) == 16:
                                nb = 4
                                while br.get(1):
                                    nb += 1
                                esc = br.get(nb) | (1 << nb)
                                vals[i] = esc if v > 0 else -esc
                    for i, v in enumerate(vals):
                        if k + i < n:
                            coeffs[off + k + i] = v
                    k += dim
        base += 128 * glen if ics.window_sequence == EIGHT_SHORT else 1024
    return coeffs


class _Windows:
    _cache = {}

    @classmethod
    def get(cls, shape: int, n: int) -> np.ndarray:
        key = (shape, n)
        w = cls._cache.get(key)
        if w is None:
            if shape:
                w = tx.kbd_window(n, 4.0 if n == 2048 else 6.0)
            else:
                w = tx.sine_window(n)
            cls._cache[key] = w.astype(np.float32)
        return cls._cache[key]


@register_decoder
class AacDecoder(Codec):
    codec_id = "aac"
    codec_type = MediaType.AUDIO

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        self.sample_rate = par.sample_rate
        self.sr_index = None
        self.channels = par.channels
        if par.extradata:
            self._parse_asc(par.extradata)
        self._overlap = {}      # channel key → (1024,) float
        self._prev_shape = {}
        self._sbr = {}          # element key → SBRContext
        # PNS noise generator state (aac/aacdec.c:1353 — one LCG per
        # decoder, advanced per noise coefficient in decode order)
        self._random_state = 0x1F2E3D4C

    def _lcg_noise(self, n: int) -> np.ndarray:
        """n pseudorandom int32s from the reference's LCG
        (aacdec_proc_template.c lcg_random), cast to float."""
        s = self._random_state
        out = np.empty(n, np.float64)
        for i in range(n):
            s = (s * 1664525 + 1013904223) & 0xFFFFFFFF
            out[i] = np.float32(s - 0x100000000 if s >= 0x80000000
                                else s)
        self._random_state = s
        return out

    def _parse_asc(self, asc: bytes) -> None:
        """AudioSpecificConfig (ISO 14496-3 1.6.2.1)."""
        br = BitReader(asc)
        aot = br.get(5)
        if aot == 31:
            aot = 32 + br.get(6)
        sr_idx = br.get(4)
        rate = br.get(24) if sr_idx == 15 else SAMPLE_RATES[sr_idx]
        ch_cfg = br.get(4)
        if aot == 5 or aot == 29:   # HE-AAC: explicit SBR — use core
            br.get(4)
            aot = br.get(5)
        if aot not in (1, 2, 3, 4, 6):
            raise NotSupported(f"aac: audio object type {aot}")
        self.sample_rate = rate
        self.sr_index = SAMPLE_RATES.index(rate) if rate in SAMPLE_RATES else sr_idx
        if ch_cfg:
            self.channels = {1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 6, 7: 8}.get(ch_cfg, ch_cfg)

    # ------------------------------------------------------------------ decode
    def decode_frames(self, pkts: List[Packet]) -> List[Frame]:
        """Batched utterance decode: host entropy, scale and TNS for all
        packets first (so the PNS generator advances in decode order), then
        one device IMDCT per window class over the whole batch, then the
        host's window and overlap-add."""
        parsed = self.parse_packets(pkts)
        self.batched_imdct(parsed)
        return self.overlap_add(parsed)

    def parse_packets(self, pkts: List[Packet]) -> list:
        """Host stage of decode_frames: [(packet, channel outputs, SBR
        payloads or None)]."""
        return [(pkt, *self._parse_frame(bytes(pkt.data)))
                for pkt in pkts if pkt is not None and pkt.data]

    def batched_imdct(self, parsed: list) -> None:
        """Device stage of decode_frames: one IMDCT for all long channels
        and one for all short ones, each class's coefficients copied to the
        device once and its samples back once."""
        longs, shorts = [], []
        for _pkt, outputs, _sbr in parsed:
            for _key, ch in outputs:
                if ch.ics.window_sequence == EIGHT_SHORT:
                    shorts.append(ch)
                else:
                    longs.append(ch)
        if longs:
            spec = np.stack([c.coeffs.astype(np.float32) for c in longs])
            buf = self._imdct(spec, 1024, LONG_SCALE)
            for c, b in zip(longs, buf):
                c._imdct = b
        if shorts:
            spec = np.stack([c.coeffs.reshape(8, 128).astype(np.float32)
                             for c in shorts])
            buf = self._imdct(spec.reshape(-1, 128), 128, SHORT_SCALE)
            buf = buf.reshape(len(shorts), 8, 256)
            for c, b in zip(shorts, buf):
                c._imdct = b

    def overlap_add(self, parsed: list) -> List[Frame]:
        """Host stage after the IMDCT: window, overlap-add and SBR, one
        frame per packet, in packet order."""
        frames = []
        for pkt, outputs, sbr in parsed:
            pcm = np.stack([self._reconstruct(key, ch)
                            for key, ch in outputs])
            frames.append(self._frame(pcm, pkt, outputs, sbr))
        return frames

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        outputs, sbr = self._parse_frame(bytes(pkt.data))
        pcm = np.stack([self._reconstruct(key, ch) for key, ch in outputs])
        return [self._frame(pcm, pkt, outputs, sbr)]

    def _frame(self, pcm: np.ndarray, pkt: Packet, outputs: list,
               sbr: Optional[_SbrPayloads]) -> Frame:
        """The packet's frame from its core PCM, through SBR (and PS)
        when the packet carries SBR data."""
        rate, dur = self.sample_rate, 1024
        if sbr is not None and self._decode_sbr(sbr):
            pcm, rate, dur = self._apply_sbr(outputs, pcm, sbr.sample_rate)
        # the reference float decoder does not clamp its output
        # (aacdec.c float path writes raw floats)
        nch = pcm.shape[0]
        f = Frame.audio(pcm.astype(np.float32), rate, "fltp",
                        self.par.ch_layout if (self.par.ch_layout and
                                               self.par.channels == nch)
                        else default_layout(nch),
                        pts=pkt.pts, time_base=pkt.time_base)
        f.duration = dur
        return f

    def _decode_sbr(self, sbr: _SbrPayloads) -> set:
        """Decode one packet's SBR payloads into their elements' contexts,
        in bitstream order → the elements whose payload decoded.  A
        payload that raises stops the packet's SBR payloads there, as the
        reference's parse loop stops at it (such a payload reaches the end
        of the packet, so no element follows it)."""
        applied = set()
        for elem_key, crc, pos in sbr.ext:
            ctx = self._sbr.get(elem_key)
            if ctx is None:
                ctx = self._sbr[elem_key] = SBRContext(sbr.sample_rate)
            br = BitReader(sbr.data)
            br.pos = pos
            try:
                ctx.decode_extension(br, crc, elem_key[0])
            except (InvalidData, NotSupported):
                break
            applied.add(elem_key)
        return applied

    def _apply_sbr(self, outputs, pcm, sample_rate):
        """Run SBR per element; → (pcm2x, rate, duration)."""
        out = []
        idx = 0
        for key, _ in outputs:
            if key[0] == "cpe" and key[2] == "r":
                continue                  # handled with the pair
            elem_key = (key[0], key[1])
            ctx = self._sbr.get(elem_key)
            if ctx is None:
                # element without its own SBR data in an SBR stream:
                # still run it through the QMF analysis/synthesis banks
                # (SBRContext with no header decoded = zero high band =
                # clean interpolating 2x upsample), matching the
                # reference's sbr_apply on non-SBR elements
                # (libavcodec/aacsbr_template.c ff_aac_sbr_apply).
                ctx = self._sbr[elem_key] = SBRContext(sample_rate)
            nch = 2 if key[0] == "cpe" else 1
            chans = [pcm[idx + c] for c in range(nch)]
            out.extend(ctx.apply(key[0], chans))
            idx += nch
        return np.stack(out), sample_rate * 2, 2048

    def _imdct(self, spec: np.ndarray, n: int, scale: float) -> np.ndarray:
        """IMDCT of host coefficients on the decoder's device: one copy
        there, one back."""
        x = torch.from_numpy(spec).to(self.device)
        return tx.imdct(x, n, scale=scale).cpu().numpy()

    def _parse_frame(self, data: bytes):
        """Host-side parse of one raw/ADTS AAC frame → (channel outputs,
        SBR payloads or None): entropy + scalefactors + TNS applied,
        coeffs ready for the IMDCT; the SBR payloads found, to be decoded
        by _decode_sbr when the packet's PCM is ready."""
        if len(data) > 7 and data[0] == 0xFF and (data[1] & 0xF6) == 0xF0:
            # inline ADTS header
            hdr = BitReader(data)
            hdr.skip(12 + 1 + 2 + 1)
            hdr.skip(2)
            sr_idx = hdr.get(4)
            hdr.skip(1)
            ch_cfg = hdr.get(3)
            self.sample_rate = SAMPLE_RATES[sr_idx]
            self.sr_index = sr_idx
            if ch_cfg:
                self.channels = ch_cfg if ch_cfg < 7 else 8
            crc_absent = data[1] & 1
            data = data[7 if crc_absent else 9:]
        if self.sr_index is None:
            if self.sample_rate in SAMPLE_RATES:
                self.sr_index = SAMPLE_RATES.index(self.sample_rate)
            else:
                raise InvalidData("aac: unknown sample rate")
        br = BitReader(data)
        outputs = []     # (key, samples)
        last_elem = None                  # ("sce"/"cpe", tag)
        sbr = None
        while True:
            try:
                elem = br.get(3)
                if elem == END:
                    break
                if elem in (SCE, LFE):
                    tag = br.get(4)
                    ch = self._decode_ics_element(br)
                    self._apply_scalefactors(ch)
                    self._apply_tns(ch)
                    outputs.append((("sce", tag, len(outputs)), ch))
                    last_elem = ("sce", tag) if elem == SCE else None
                elif elem == CPE:
                    tag = br.get(4)
                    pair = self._decode_cpe(br)
                    outputs.append((("cpe", tag, "l", len(outputs)), pair[0]))
                    outputs.append((("cpe", tag, "r", len(outputs)), pair[1]))
                    last_elem = ("cpe", tag)
                elif elem == FIL:
                    cnt = br.get(4)
                    if cnt == 15:
                        cnt += br.get(8) - 1
                    endpos = br.pos + 8 * cnt
                    if cnt and last_elem is not None:
                        ext = br.peek(4)
                        if ext in (13, 14):     # EXT_SBR_DATA(_CRC)
                            if sbr is None:
                                sbr = _SbrPayloads(data, self.sample_rate)
                            sbr.ext.append((last_elem, ext == 14,
                                            br.pos + 4))
                    br.pos = endpos
                elif elem == DSE:
                    br.get(4)
                    align = br.get(1)
                    cnt = br.get(8)
                    if cnt == 255:
                        cnt += br.get(8)
                    if align:
                        br.align()
                    br.skip(8 * cnt)
                elif elem == PCE:
                    self._skip_pce(br)
                else:
                    raise NotSupported(f"aac: element type {elem}")
            except (InvalidData, NotSupported):
                # desync after valid elements (stray bits, unparsed
                # extensions): keep decoded elements, AV_EF_* lenient mode
                if outputs:
                    break
                raise
            if br.bits_left() < 3:
                break
        if not outputs:
            raise InvalidData("aac: no elements decoded")
        return outputs, sbr

    def _skip_pce(self, br: BitReader) -> None:
        br.get(4)
        br.get(2)
        br.get(4)
        nfront = br.get(4)
        nside = br.get(4)
        nback = br.get(4)
        nlfe = br.get(2)
        ndata = br.get(3)
        ncc = br.get(4)
        if br.get(1):
            br.get(4)
        if br.get(1):
            br.get(4)
        if br.get(1):
            br.get(3)
        for _ in range(nfront + nside + nback):
            br.get(5)
        for _ in range(nlfe + ndata):
            br.get(4)
        for _ in range(ncc):
            br.get(5)
        br.align()
        cmt = br.get(8)
        br.skip(8 * cmt)

    # -------------------------------------------------------------- elements
    def _decode_ics_info(self, br: BitReader) -> ICSInfo:
        ics = ICSInfo()
        if br.get(1):
            raise InvalidData("aac: ics_reserved != 0")
        ics.window_sequence = br.get(2)
        ics.window_shape = br.get(1)
        if ics.window_sequence == EIGHT_SHORT:
            ics.max_sfb = br.get(4)
            grouping = br.get(7)
            ics.num_windows = 8
            ics.group_len = [1]
            for i in range(7):
                if grouping & (1 << (6 - i)):
                    ics.group_len[-1] += 1
                else:
                    ics.group_len.append(1)
            ics.num_window_groups = len(ics.group_len)
            ics.num_swb = T.NUM_SWB_128[self.sr_index]
            ics.swb_offset = list(T.SWB_OFFSET_128[self.sr_index]) + [128]
        else:
            ics.max_sfb = br.get(6)
            ics.num_windows = 1
            ics.num_window_groups = 1
            ics.group_len = [1]
            ics.num_swb = T.NUM_SWB_1024[self.sr_index]
            ics.swb_offset = list(T.SWB_OFFSET_1024[self.sr_index]) + [1024]
            if br.get(1):
                raise NotSupported("aac: predictor/LTP data")
        if ics.max_sfb > ics.num_swb:
            raise InvalidData("aac: max_sfb > num_swb")
        return ics

    def _decode_section(self, br: BitReader, ics: ICSInfo) -> list:
        bits = 3 if ics.window_sequence == EIGHT_SHORT else 5
        esc = (1 << bits) - 1
        band_cb = []
        for g in range(ics.num_window_groups):
            cbs = []
            k = 0
            while k < ics.max_sfb:
                cb = br.get(4)
                sect_len = 0
                while True:
                    inc = br.get(bits)
                    sect_len += inc
                    if inc != esc:
                        break
                if k + sect_len > ics.max_sfb:
                    raise InvalidData("aac: section overflow")
                cbs.extend([cb] * sect_len)
                k += sect_len
            band_cb.append(cbs)
        return band_cb

    def _decode_scalefactors(self, br: BitReader, ics: ICSInfo,
                             band_cb: list, global_gain: int) -> list:
        band_sf = []
        offset = [global_gain, global_gain - 90, 0]   # sf, noise, intensity
        noise_first = True
        for g in range(ics.num_window_groups):
            sfs = []
            for sfb in range(ics.max_sfb):
                cb = band_cb[g][sfb]
                if cb == ZERO_BT:
                    sfs.append(0)
                elif cb in (INTENSITY_BT, INTENSITY_BT2):
                    offset[2] += _huff(br, _SF_LUT) - 60
                    sfs.append(offset[2])
                elif cb == NOISE_BT:
                    if noise_first:
                        offset[1] += br.get(9) - 256
                        noise_first = False
                    else:
                        offset[1] += _huff(br, _SF_LUT) - 60
                    # aacdec.c decode_scalefactors clips the noise
                    # gain to [-100, 155] (accumulator unclipped)
                    sfs.append(min(155, max(-100, offset[1])))
                else:
                    offset[0] += _huff(br, _SF_LUT) - 60
                    if not (0 <= offset[0] <= 255):
                        raise InvalidData("aac: scalefactor out of range")
                    sfs.append(offset[0])
            band_sf.append(sfs)
        return band_sf

    def _decode_tns(self, br: BitReader, ics: ICSInfo) -> dict:
        is_short = ics.window_sequence == EIGHT_SHORT
        n_filt_bits = 1 if is_short else 2
        len_bits = 4 if is_short else 6
        order_bits = 3 if is_short else 5
        tns = {"filters": [[] for _ in range(ics.num_windows)]}
        for w in range(ics.num_windows):
            n_filt = br.get(n_filt_bits)
            if n_filt:
                coef_res = br.get(1)
            for _ in range(n_filt):
                length = br.get(len_bits)
                order = br.get(order_bits)
                if order:
                    direction = br.get(1)
                    coef_compress = br.get(1)
                    coef_len = coef_res + 3 - coef_compress
                    coefs = [br.get(coef_len) for _ in range(order)]
                    tns["filters"][w].append(
                        (length, order, direction, coef_res, coef_compress, coefs))
                else:
                    tns["filters"][w].append((length, 0, 0, 0, 0, []))
        return tns

    def _decode_ics_element(self, br: BitReader, common_ics: Optional[ICSInfo] = None
                            ) -> ChannelData:
        global_gain = br.get(8)
        ics = common_ics or self._decode_ics_info(br)
        band_cb = self._decode_section(br, ics)
        band_sf = self._decode_scalefactors(br, ics, band_cb, global_gain)
        pulse = None
        if br.get(1):
            if ics.window_sequence == EIGHT_SHORT:
                raise InvalidData("aac: pulse in short window")
            npulse = br.get(2) + 1
            start_sfb = br.get(6)
            pulse = []
            for _ in range(npulse):
                pulse.append((br.get(5), br.get(4)))
            pulse = (start_sfb, pulse)
        tns = None
        if br.get(1):
            tns = self._decode_tns(br, ics)
        if br.get(1):
            raise NotSupported("aac: gain control (SSR)")
        coeffs = decode_spectral(br, ics, band_cb)
        if pulse is not None:
            start_sfb, pulses = pulse
            k = ics.swb_offset[start_sfb]
            for off, amp in pulses:
                k += off
                if coeffs[k] > 0:
                    coeffs[k] += amp
                else:
                    coeffs[k] -= amp
        ch = ChannelData(coeffs=coeffs, ics=ics, band_cb=band_cb,
                         band_sf=band_sf)
        ch.tns = tns
        return ch

    def _decode_cpe(self, br: BitReader):
        common = br.get(1)
        ms_mask = 0
        ms_used = None
        if common:
            ics = self._decode_ics_info(br)
            ms_mask = br.get(2)
            if ms_mask == 1:
                ms_used = [[br.get(1) for _ in range(ics.max_sfb)]
                           for _ in range(ics.num_window_groups)]
            elif ms_mask == 3:
                raise InvalidData("aac: reserved ms_mask")
            chl = self._decode_ics_element(br, common_ics=ics)
            chr_ = self._decode_ics_element(br, common_ics=ics)
        else:
            chl = self._decode_ics_element(br)
            chr_ = self._decode_ics_element(br)

        self._apply_scalefactors(chl)
        self._apply_scalefactors(chr_)

        if common:
            self._apply_ms_is(chl, chr_, ms_mask, ms_used)
        self._apply_tns(chl)
        self._apply_tns(chr_)
        return chl, chr_

    # ----------------------------------------------------------- reconstruction
    def _apply_scalefactors(self, ch: ChannelData) -> None:
        ics = ch.ics
        x = ch.coeffs
        out = np.sign(x) * np.abs(x) ** (4.0 / 3.0)
        base = 0
        for g in range(ics.num_window_groups):
            glen = ics.group_len[g]
            for sfb in range(ics.max_sfb):
                cb = ch.band_cb[g][sfb]
                lo, hi = ics.swb_offset[sfb], ics.swb_offset[sfb + 1]
                for w in range(glen):
                    off = base + w * 128 if ics.window_sequence == EIGHT_SHORT else base
                    sl = slice(off + lo, off + hi)
                    if cb == NOISE_BT:
                        # aacdec_proc_template.c NOISE_BT: raw LCG
                        # int32s scaled so the BAND energy (not
                        # per-sample) equals sf^2
                        noise = self._lcg_noise(hi - lo)
                        energy = float(np.sum(
                            noise.astype(np.float32) ** 2,
                            dtype=np.float32))
                        sf = 2.0 ** (0.25 * ch.band_sf[g][sfb])
                        out[sl] = noise * (sf / math.sqrt(energy))
                    elif cb in (INTENSITY_BT, INTENSITY_BT2):
                        pass   # handled in _apply_ms_is using the right ch
                    elif cb != ZERO_BT:
                        out[sl] *= 2.0 ** (0.25 * (ch.band_sf[g][sfb] - 100))
            base += 128 * glen if ics.window_sequence == EIGHT_SHORT else 1024
        ch.coeffs = out

    def _apply_ms_is(self, chl: ChannelData, chr_: ChannelData,
                     ms_mask: int, ms_used) -> None:
        ics = chl.ics
        base = 0
        for g in range(ics.num_window_groups):
            glen = ics.group_len[g]
            for sfb in range(ics.max_sfb):
                lo, hi = ics.swb_offset[sfb], ics.swb_offset[sfb + 1]
                cb_r = chr_.band_cb[g][sfb]
                is_band = cb_r in (INTENSITY_BT, INTENSITY_BT2)
                ms_on = ms_mask == 2 or (ms_mask == 1 and ms_used[g][sfb])
                for w in range(glen):
                    off = base + w * 128 if ics.window_sequence == EIGHT_SHORT else base
                    sl = slice(off + lo, off + hi)
                    if is_band:
                        sign = -1.0 if cb_r == INTENSITY_BT2 else 1.0
                        if ms_on:
                            sign = -sign
                        scale = sign * 2.0 ** (-0.25 * chr_.band_sf[g][sfb])
                        chr_.coeffs[sl] = chl.coeffs[sl] * scale
                    elif ms_on:
                        l = chl.coeffs[sl].copy()
                        r = chr_.coeffs[sl]
                        chl.coeffs[sl] = l + r
                        chr_.coeffs[sl] = l - r
            base += 128 * glen if ics.window_sequence == EIGHT_SHORT else 1024

    def _apply_tns(self, ch: ChannelData) -> None:
        tns = getattr(ch, "tns", None)
        if not tns:
            return
        ics = ch.ics
        is_short = ics.window_sequence == EIGHT_SHORT
        mmax = (T.TNS_MAX_BANDS_128 if is_short else
                T.TNS_MAX_BANDS_1024)[self.sr_index]
        wlen = 128 if is_short else 1024
        for w, filters in enumerate(tns["filters"]):
            bottom = ics.num_swb
            for (length, order, direction, coef_res, coef_compress, coefs) \
                    in filters:
                top = bottom
                bottom = max(0, top - length)
                if order == 0:
                    continue
                lpc = _tns_lpc(coefs, order, coef_res, coef_compress)
                start_b = min(bottom, mmax, ics.max_sfb)
                end_b = min(top, mmax, ics.max_sfb)
                start = ics.swb_offset[start_b]
                end = ics.swb_offset[end_b]
                if end <= start:
                    continue
                seg = ch.coeffs[w * wlen + start: w * wlen + end]
                _tns_filter(seg, lpc, direction)

    def _reconstruct(self, key, ch: ChannelData) -> np.ndarray:
        """IMDCT (batched by decode_frames, else here on the device) +
        window + overlap-add on the host → 1024 PCM samples."""
        ics = ch.ics
        prev = self._overlap.get(key)
        if prev is None:
            prev = np.zeros(1024, np.float32)
        prev_shape = self._prev_shape.get(key, ics.window_shape)

        pre = getattr(ch, "_imdct", None)   # decode_frames batch
        if ics.window_sequence == EIGHT_SHORT:
            if pre is not None:
                buf = pre
            else:
                specs = ch.coeffs.reshape(8, 128).astype(np.float32)
                buf = self._imdct(specs, 128, SHORT_SCALE)
            w_cur = _Windows.get(ics.window_shape, 256)
            w_prev = _Windows.get(prev_shape, 256)
            frames = np.empty((8, 256), np.float32)
            frames[0] = buf[0] * np.concatenate([w_prev[:128], w_cur[128:]])
            for i in range(1, 8):
                frames[i] = buf[i] * w_cur
            # overlap-add the 8 short frames into a 2048 buffer at offset 448
            acc = np.zeros(2048, np.float32)
            acc[:1024] = prev
            pos = 448
            for i in range(8):
                acc[pos:pos + 256] += frames[i]
                pos += 128
            out = acc[:1024]
            new_overlap = acc[1024:]
        else:
            if pre is not None:
                buf = pre
            else:
                spec = ch.coeffs.astype(np.float32)
                buf = self._imdct(spec, 1024, LONG_SCALE)
            wl_prev = _Windows.get(prev_shape, 2048)
            wl_cur = _Windows.get(ics.window_shape, 2048)
            ws_cur = _Windows.get(ics.window_shape, 256)
            ws_prev = _Windows.get(prev_shape, 256)
            first = buf[:1024].copy()
            second = buf[1024:].copy()
            if ics.window_sequence in (ONLY_LONG, LONG_START):
                first *= wl_prev[:1024]
            else:  # LONG_STOP: flat head + short rise at 448
                first[:448] = 0.0
                first[448:576] *= ws_prev[:128]
                # region 576.. stays unwindowed (flat 1s)
            if ics.window_sequence in (ONLY_LONG, LONG_STOP):
                second *= wl_cur[1024:]
            else:  # LONG_START: flat 1s then short fall at 576, zeros after
                second[448:576] *= ws_cur[128:]
                second[576:] = 0.0
            out = prev + first
            new_overlap = second
        self._overlap[key] = new_overlap
        self._prev_shape[key] = ics.window_shape
        return out

    def flush_state(self) -> None:
        self._overlap.clear()
        self._prev_shape.clear()


def _tns_lpc(coefs, order, coef_res, coef_compress):
    """Decode TNS reflection coeffs → direct-form LPC (ISO 14496-3 4.6.9)."""
    bits = coef_res + 3 - coef_compress
    m = 1 << (bits - 1)
    iqfac = (m - 0.5) / (math.pi / 2.0)
    iqfac_m = (m + 0.5) / (math.pi / 2.0)
    refl = []
    for c in coefs:
        v = c - 2 * m if c >= m else c
        refl.append(math.sin(v / (iqfac if v >= 0 else iqfac_m)))
    # reflection → direct-form coefficients (step-up recursion)
    lpc = [1.0]
    for i, k in enumerate(refl, start=1):
        new = [1.0]
        for j in range(1, i):
            new.append(lpc[j] + k * lpc[i - j])
        new.append(k)
        lpc = new
    return np.array(lpc[1:])


def _tns_filter(seg: np.ndarray, lpc: np.ndarray, direction: int) -> None:
    """All-pole synthesis filter over the band (in place)."""
    n = len(seg)
    order = len(lpc)
    if direction:
        idx = range(n - 1, -1, -1)
    else:
        idx = range(n)
    hist = [0.0] * order
    for i in idx:
        y = seg[i]
        for j in range(order):
            y -= lpc[j] * hist[j]
        hist = [y] + hist[:-1]
        seg[i] = y
