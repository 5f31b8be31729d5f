"""AC-3 / E-AC-3 (ATSC A/52, ETSI TS 102 366) decoder (reference:
libavcodec/ac3dec.c, eac3dec.c, ac3_parser.c, ac3.c:180 bit
allocation).

Counterpart of ffmpeg_tpu/codecs/ac3.py.  Host/device split follows
the framework's audio pattern (see mp3.py): bit allocation,
exponent/mantissa entropy decode, (un)coupling, spectral extension and
AHT run on the host (the reference's host code, copied); the synthesis
filterbank (256-pt half-IMDCT as a full-float32 matmul + KBD window
overlap-add) runs on the decoder's device via ops/ac3fb.py, one call per
frame over all its blocks and channels, where the reference makes one
host-device round trip per channel per block.  Each block's parse fills
its scaled coefficients and block-switch flags; the (channels, 128)
delay stays a tensor on the device between frames, and each frame's PCM
comes back to the host in one copy.

`stats`, when a list, gets one dict per decoded frame, as the MP3
decoder's: host ms (the parse, and the copies' host time), the h2d
bytes, and the device split (h2d, filterbank, d2h).

Scope: plain AC-3 (bsid <= 10) and E-AC-3 (bsid 11-16) independent
substream 0 — all channel modes incl. LFE, channel coupling, stereo
rematrixing, dynamic range gains, dithered zero-bit mantissas
(replicating the reference's lagged-Fibonacci dither PRNG so
differential tests match to float rounding), spectral extension (SPX)
and the adaptive hybrid transform (AHT: 6-block DCT + vector/gain
adaptive quantization). Not supported (same as the reference):
enhanced coupling, reduced sample rates, dependent substreams."""

from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np
import torch

from ..core.frame import Frame
from ..core.packet import Packet
from ..io.stream import MediaType
from ..utils.error import InvalidData, NotSupported
from ..utils.rational import Rational
from . import ac3_tables as T
from . import eac3_tables as E
from .bitstream import BitReader
from .codec import Codec, register_decoder
from ..ops import ac3fb
from .vp9.recon_tpu import _Timer

EXP_REUSE, EXP_D15, EXP_D25, EXP_D45 = 0, 1, 2, 3
CPL = 0                     # coupling pseudo-channel index

# E-AC-3 frame types
FT_INDEPENDENT, FT_DEPENDENT, FT_AC3_CONVERT, FT_RESERVED = 0, 1, 2, 3


class _Lfg:
    """av_lfg-compatible lagged Fibonacci PRNG (libavutil/lfg.c:32):
    state[8:] from iterated MD5 of the seed, x[n] = x[n-24] + x[n-55]."""

    def __init__(self, seed: int = 0):
        self.state = [0] * 64
        tmp = bytearray(16)          # digest feeds back into the buffer
        for i in range(8, 64, 4):
            tmp[0:4] = seed.to_bytes(4, "little")
            tmp[4] = i
            tmp[:] = hashlib.md5(bytes(tmp)).digest()
            for j in range(4):
                self.state[i + j] = int.from_bytes(tmp[4 * j:4 * j + 4],
                                                   "little")
        self.index = 0

    def get(self) -> int:
        s = self.state
        i = self.index
        v = (s[(i - 24) & 63] + s[(i - 55) & 63]) & 0xFFFFFFFF
        s[i & 63] = v
        self.index = i + 1
        return v

    def get_signed(self) -> int:
        v = self.get()
        return v - (1 << 32) if v >= (1 << 31) else v


def _calc_psd(exps, start, end):
    """Exponent → PSD mapping + log-add band integration (A/52 §7.2.2.1,
    reference ac3.c:180 ff_ac3_bit_alloc_calc_psd)."""
    psd = np.zeros(256, np.int32)
    psd[start:end] = 3072 - (exps[start:end].astype(np.int32) << 7)
    band_psd = np.zeros(50, np.int32)
    b = start
    band = T.BIN_TO_BAND_TAB[start]
    while True:
        v = int(psd[b])
        b += 1
        band_end = min(T.BAND_START_TAB[band + 1], end)
        while b < band_end:
            mx = max(v, int(psd[b]))
            adr = min(mx - ((v + int(psd[b]) + 1) >> 1), 255)
            v = mx + T.LOG_ADD_TAB[adr]
            b += 1
        band_psd[band] = v
        band += 1
        if end <= T.BAND_START_TAB[band]:
            break
    return psd, band_psd


def _lowcomp1(a, b0, b1, c):
    if b0 + 256 == b1:
        return c
    if b0 > b1:
        return max(a - 64, 0)
    return a


def _lowcomp(a, b0, b1, bin_):
    if bin_ < 7:
        return _lowcomp1(a, b0, b1, 384)
    if bin_ < 20:
        return _lowcomp1(a, b0, b1, 320)
    return max(a - 128, 0)


def _calc_mask(ba, band_psd, start, end, fast_gain, is_lfe, dba):
    """Excitation + masking curve (A/52 §7.2.2.2-3, ac3.c:204)."""
    excite = np.zeros(50, np.int32)
    band_start = T.BIN_TO_BAND_TAB[start]
    band_end = T.BIN_TO_BAND_TAB[end - 1] + 1
    fastleak = slowleak = 0
    if band_start == 0:
        lowcomp = _lowcomp1(0, band_psd[0], band_psd[1], 384)
        excite[0] = band_psd[0] - fast_gain - lowcomp
        lowcomp = _lowcomp1(lowcomp, band_psd[1], band_psd[2], 384)
        excite[1] = band_psd[1] - fast_gain - lowcomp
        begin = 7
        for band in range(2, 7):
            if not (is_lfe and band == 6):
                lowcomp = _lowcomp1(lowcomp, band_psd[band],
                                    band_psd[band + 1], 384)
            fastleak = band_psd[band] - fast_gain
            slowleak = band_psd[band] - ba["slow_gain"]
            excite[band] = fastleak - lowcomp
            if not (is_lfe and band == 6):
                if band_psd[band] <= band_psd[band + 1]:
                    begin = band + 1
                    break
        for band in range(begin, min(band_end, 22)):
            if not (is_lfe and band == 6):
                lowcomp = _lowcomp(lowcomp, band_psd[band],
                                   band_psd[band + 1], band)
            fastleak = max(fastleak - ba["fast_decay"],
                           band_psd[band] - fast_gain)
            slowleak = max(slowleak - ba["slow_decay"],
                           band_psd[band] - ba["slow_gain"])
            excite[band] = max(fastleak - lowcomp, slowleak)
        begin = 22
    else:                       # coupling channel
        begin = band_start
        fastleak = (ba["cpl_fast_leak"] << 8) + 768
        slowleak = (ba["cpl_slow_leak"] << 8) + 768
    for band in range(begin, band_end):
        fastleak = max(fastleak - ba["fast_decay"],
                       band_psd[band] - fast_gain)
        slowleak = max(slowleak - ba["slow_decay"],
                       band_psd[band] - ba["slow_gain"])
        excite[band] = max(fastleak, slowleak)

    mask = np.zeros(50, np.int32)
    for band in range(band_start, band_end):
        tmp = ba["db_per_bit"] - band_psd[band]
        if tmp > 0:
            excite[band] += tmp >> 2
        mask[band] = max(T.HEARING_THRESHOLD_TAB[band >> ba["sr_shift"]]
                         [ba["sr_code"]], excite[band])
    if dba is not None:
        band = band_start
        for off, ln, val in dba:
            band += off
            if band >= 50 or ln > 50 - band:
                raise InvalidData("ac3: bad delta bit allocation")
            delta = (val - 3) * 128 if val >= 4 else (val - 4) * 128
            for _ in range(ln):
                mask[band] += delta
                band += 1
    return mask


def _calc_bap(mask, psd, start, end, snr_offset, floor, bap_tab):
    """Masking → bit allocation pointers (ac3dsp.c bit_alloc_calc_bap).
    bap_tab is BAP_TAB for plain mantissas, HEBAP_TAB for AHT."""
    bap = np.zeros(256, np.uint8)
    if snr_offset == -960:
        return bap
    b = start
    band = T.BIN_TO_BAND_TAB[start]
    while True:
        m = (max(int(mask[band]) - snr_offset - floor, 0) & 0x1FE0) + floor
        band += 1
        band_end = min(T.BAND_START_TAB[band], end)
        while b < band_end:
            addr = min(max((int(psd[b]) - m) >> 5, 0), 63)
            bap[b] = bap_tab[addr]
            b += 1
        if end <= band_end:
            break
    return bap


def _i32(v):
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _idct6(pm):
    """6-point IDCT of AHT pre-mantissas, 24-bit fixed point
    (eac3dec.c:165 idct6)."""
    C0, C1, C2 = 10273905, 11863283, 3070444
    odd1 = pm[1] - pm[3] - pm[5]
    even2 = (pm[2] * C0) >> 23
    tmp = (pm[4] * C1) >> 23
    odd0 = ((pm[1] + pm[5]) * C2) >> 23
    even0 = pm[0] + (tmp >> 1)
    even1 = pm[0] - tmp
    t = even0
    even0 = t + even2
    even2 = t - even2
    t = odd0
    odd0 = t + pm[1] + pm[3]
    odd2 = t + pm[5] - pm[3]
    pm[0] = even0 + odd0
    pm[1] = even1 + odd1
    pm[2] = even2 + odd2
    pm[3] = even2 - odd2
    pm[4] = even1 - odd1
    pm[5] = even0 - odd0


@register_decoder
class Ac3Decoder(Codec):
    codec_id = "ac3"
    codec_type = MediaType.AUDIO

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        self.stats: Optional[list] = None
        self._timer: Optional[_Timer] = None
        self._dith = _Lfg(0)
        self._delay = None          # (channels, 128) on the device
        self._pts = None

    # ------------------------------------------------------------------
    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        data = pkt.data
        frames = []
        pos = 0
        while pos + 8 <= len(data):
            if data[pos:pos + 2] != b"\x0b\x77":
                pos += 1
                continue
            f = self._decode_frame(data[pos:], pkt)
            if f is None:
                break
            frame, size = f
            if frame is not None:
                frames.append(frame)
            pos += size
        return frames

    def _decode_frame(self, buf, pkt):
        if len(buf) < 8:
            raise InvalidData("ac3: short frame")
        self._timer = _Timer(self.device) if self.stats is not None \
            else None
        bsid = buf[5] >> 3
        if bsid > 16:
            raise InvalidData("ac3: bad bsid")
        b = BitReader(buf)
        b.skip(16)                  # sync word
        if bsid <= 10:
            return self._frame_ac3(b, buf, pkt, bsid)
        return self._frame_eac3(b, buf, pkt)

    # ---- AC-3 frame ---------------------------------------------------
    def _frame_ac3(self, b, buf, pkt, bsid):
        b.skip(16)                  # crc1
        sr_code = b.get(2)
        if sr_code == 3:
            raise InvalidData("ac3: bad sample rate code")
        frame_size_code = b.get(6)
        if frame_size_code > 37:
            raise InvalidData("ac3: bad frame size code")
        b.skip(5)                   # bsid (already read)
        sr_shift = max(bsid, 8) - 8
        sample_rate = T.SAMPLE_RATE_TAB[sr_code] >> sr_shift
        frame_size = T.FRAME_SIZE_TAB[frame_size_code][sr_code] * 2
        if len(buf) < frame_size:
            raise InvalidData("ac3: truncated frame")
        b.skip(3)                   # bsmod
        acmod = b.get(3)
        if acmod == 2:
            b.skip(2)               # dsurmod
        else:
            if (acmod & 1) and acmod != 1:
                b.skip(2)           # cmixlev
            if acmod & 4:
                b.skip(2)           # surmixlev
        lfe_on = b.get(1)
        fbw = T.CHANNELS_TAB[acmod]
        channels = fbw + lfe_on
        # rest of BSI (A/52 §5.4.2; ac3_parser.c:82 — the bsid==6 xbsi
        # fields occupy the same 14-bit slots as the timecodes)
        for _ in range(2 if acmod == 0 else 1):
            b.skip(5)               # dialnorm
            if b.get(1):
                b.skip(8)           # compr
            if b.get(1):
                b.skip(8)           # langcod
            if b.get(1):
                b.skip(7)           # audio production info
        b.skip(2)                   # copyright + original
        if b.get(1):
            b.skip(14)              # timecod1 / xbsi1
        if b.get(1):
            b.skip(14)              # timecod2 / xbsi2
        if b.get(1):                # addbsie
            n = b.get(6)
            b.skip(8 * (n + 1))

        st = _FrameState(channels, fbw, lfe_on, acmod, sr_code, sr_shift)
        pcm = self._decode_blocks(b, st, 6)
        return self._emit(st, pcm, sample_rate, pkt), frame_size

    # ---- E-AC-3 frame -------------------------------------------------
    def _frame_eac3(self, b, buf, pkt):
        frame_type = b.get(2)
        if frame_type == FT_RESERVED:
            raise InvalidData("eac3: reserved frame type")
        substreamid = b.get(3)
        frame_size = (b.get(11) + 1) * 2
        if len(buf) < frame_size:
            raise InvalidData("eac3: truncated frame")
        sr_code = b.get(2)
        if sr_code == 3:
            raise NotSupported("eac3: reduced sample rate")
        num_blocks = E.EAC3_BLOCKS[b.get(2)]
        sample_rate = T.SAMPLE_RATE_TAB[sr_code]
        acmod = b.get(3)
        lfe_on = b.get(1)
        if frame_type == FT_DEPENDENT or substreamid:
            # only independent substream 0 is decoded (eac3dec.c:306)
            return None, frame_size
        fbw = T.CHANNELS_TAB[acmod]
        channels = fbw + lfe_on
        self._eac3_bsi(b, frame_type, acmod, lfe_on, num_blocks)
        st = _FrameState(channels, fbw, lfe_on, acmod, sr_code, 0,
                         eac3=True, num_blocks=num_blocks,
                         frame_type=frame_type)
        self._eac3_audfrm(b, st, frame_size)
        pcm = self._decode_blocks(b, st, num_blocks)
        return self._emit(st, pcm, sample_rate, pkt), frame_size

    def _decode_blocks(self, b, st, num_blocks):
        """Parse the frame's blocks on the host, then run the filterbank
        of all of them in one device call → (channels, blocks*256) host
        PCM.  A block that fails to parse raises after the blocks before
        it went through the filterbank, so the delay is what the
        reference leaves (it filters block by block)."""
        channels = st.channels
        if self._delay is None or self._delay.shape[0] != channels:
            self._delay = torch.zeros((channels, 128), dtype=torch.float32,
                                      device=self.device)
        xf = np.zeros((num_blocks, channels, 256), np.float32)
        switched = np.zeros((num_blocks, channels), bool)
        for blk in range(num_blocks):
            try:
                self._decode_block(b, st, blk, xf[blk], switched[blk])
            except Exception:
                if blk:
                    self._filterbank(xf[:blk], switched[:blk])
                raise
        return self._filterbank(xf, switched, self._timer)

    def _filterbank(self, xf, switched, timer=None):
        """ac3fb.frame over (blocks, channels, 256) host coefficients on
        the device, the delay carried there → (channels, blocks*256)
        host PCM; the split into `stats` when `timer` is given."""
        if timer is not None:
            timer.host_mark("parse")
            timer.dev_mark("h2d")
        x = torch.from_numpy(xf).to(self.device)
        if timer is not None:
            timer.dev_mark("filterbank")
        out, self._delay = ac3fb.frame(x, switched, self._delay)
        if timer is not None:
            timer.dev_mark("d2h")
        pcm = out.cpu().numpy()
        if timer is not None:
            timer.dev_mark("end")
            timer.host_mark("device")
            self.stats.append({"host": dict(timer.host),
                               "h2d_bytes": xf.nbytes,
                               "d2h_bytes": pcm.nbytes,
                               "device": timer.device_ms()})
        return pcm

    def _emit(self, st, pcm, sample_rate, pkt):
        # decoded (AC-3 order, LFE last) → native output order
        # (ff_ac3_dec_channel_map: out[i] = decoded[map[i]])
        cmap = E.DEC_CHANNEL_MAP[st.acmod][st.lfe_on]
        out = pcm[[cmap[i] for i in range(st.channels)]]
        from ..formats.channel_layout import default_layout
        fr = Frame.audio(out, sample_rate, "fltp",
                         default_layout(st.channels), pts=pkt.pts,
                         time_base=pkt.time_base or
                         Rational(1, sample_rate))
        fr.duration = pcm.shape[1]
        return fr

    def _eac3_bsi(self, b, frame_type, acmod, lfe_on, num_blocks):
        """E-AC-3 BSI metadata — parsed for bit position only
        (ac3_parser.c:130 eac3_parse_header)."""
        b.skip(5)                   # bsid (already read)
        for _ in range(1 if acmod else 2):
            b.skip(5)               # dialnorm
            if b.get(1):
                b.skip(8)           # compr
        if b.get(1):                # mixing metadata
            if acmod > 2:
                b.skip(2)           # preferred_downmix
                if acmod & 1:
                    b.skip(6)       # ltrt/loro center mix levels
                if acmod & 4:
                    b.skip(6)       # ltrt/loro surround mix levels
            if lfe_on and b.get(1):
                b.skip(5)           # lfe mix level
            if frame_type == FT_INDEPENDENT:
                for _ in range(1 if acmod else 2):
                    if b.get(1):
                        b.skip(6)   # program scale factor
                if b.get(1):
                    b.skip(6)       # external program scale factor
                mde = b.get(2)
                if mde == 1:
                    b.skip(5)
                elif mde == 2:
                    b.skip(12)
                elif mde == 3:
                    b.skip((b.get(5) + 2) * 8)
                if acmod < 2:       # pan info for mono / dual mono
                    for _ in range(1 if acmod else 2):
                        if b.get(1):
                            b.skip(14)
                if b.get(1):        # mixing configuration
                    for _ in range(num_blocks):
                        if num_blocks == 1 or b.get(1):
                            b.skip(5)
        if b.get(1):                # informational metadata
            b.skip(3 + 2)           # bsmod, copyright+original
            if acmod == 2:
                b.skip(4)           # dsurmod + dheadphonmod
            if acmod >= 6:
                b.skip(2)           # dsurexmod
            for _ in range(1 if acmod else 2):
                if b.get(1):
                    b.skip(8)       # mix level / room type / adconv
            b.skip(1)               # source sample rate code
        if frame_type == FT_INDEPENDENT and num_blocks != 6:
            b.skip(1)               # converter sync flag
        if frame_type == FT_AC3_CONVERT and \
                (num_blocks == 6 or b.get(1)):
            b.skip(6)               # original frame size code
        if b.get(1):                # additional BSI
            n = b.get(6)
            b.skip(8 * (n + 1))

    def _eac3_audfrm(self, b, st, frame_size):
        """Audio frame syntax flags + per-frame strategy data
        (eac3dec.c:288 ff_eac3_parse_header, audfrm part)."""
        nb = st.num_blocks
        fbw = st.fbw
        nch = st.channels
        if nb == 6:
            ac3_expstr = b.get(1)
            parse_aht = b.get(1)
        else:
            ac3_expstr = 1
            parse_aht = 0
        st.snr_offset_strategy = b.get(2)
        parse_transproc = b.get(1)
        st.block_switch_syntax = b.get(1)
        st.dither_flag_syntax = b.get(1)
        if not st.dither_flag_syntax:
            for ch in range(1, fbw + 1):
                st.dither_flag[ch] = 1
        st.bit_allocation_syntax = b.get(1)
        if not st.bit_allocation_syntax:
            st.ba["slow_decay"] = T.SLOW_DECAY_TAB[2]
            st.ba["fast_decay"] = T.FAST_DECAY_TAB[1]
            st.ba["slow_gain"] = T.SLOW_GAIN_TAB[1]
            st.ba["db_per_bit"] = T.DB_PER_BIT_TAB[2]
            st.ba["floor"] = T.FLOOR_TAB[7]
        st.fast_gain_syntax = b.get(1)
        st.dba_syntax = b.get(1)
        st.skip_syntax = b.get(1)
        parse_spx_atten = b.get(1)
        # coupling use per block
        num_cpl_blocks = 0
        if st.acmod > 1:
            for blk in range(nb):
                st.cpl_strategy_exists[blk] = \
                    1 if blk == 0 else b.get(1)
                if st.cpl_strategy_exists[blk]:
                    st.cpl_in_use[blk] = b.get(1)
                else:
                    st.cpl_in_use[blk] = st.cpl_in_use[blk - 1]
                num_cpl_blocks += st.cpl_in_use[blk]
        # exponent strategies
        if ac3_expstr:
            for blk in range(nb):
                for ch in range(0 if st.cpl_in_use[blk] else 1,
                                fbw + 1):
                    st.exp_strategy[blk][ch] = b.get(2)
        else:
            first = 0 if (st.acmod > 1 and num_cpl_blocks) else 1
            for ch in range(first, fbw + 1):
                idx = b.get(5)
                for blk in range(6):
                    st.exp_strategy[blk][ch] = E.FRM_EXPSTR[idx][blk]
        if st.lfe_on:
            for blk in range(nb):
                st.exp_strategy[blk][st.lfe_ch] = b.get(1)
        if st.frame_type == FT_INDEPENDENT and \
                (nb == 6 or b.get(1)):
            b.skip(5 * fbw)         # converter exponent strategies
        # AHT usage
        if parse_aht:
            st.channel_uses_aht[CPL] = 0
            for ch in range(1 if num_cpl_blocks != 6 else 0, nch + 1):
                use = 1
                for blk in range(1, 6):
                    if st.exp_strategy[blk][ch] != EXP_REUSE or \
                            (ch == CPL and
                             st.cpl_strategy_exists[blk]):
                        use = 0
                        break
                st.channel_uses_aht[ch] = use and b.get(1)
        # per-frame SNR offset
        if st.snr_offset_strategy == 0:
            csnr = (b.get(6) - 15) << 4
            snr = (csnr + b.get(4)) << 2
            for ch in range(0, nch + 1):
                st.snr_offset[ch] = snr
        # transient pre-noise processing (side info, ignored)
        if parse_transproc:
            for ch in range(1, fbw + 1):
                if b.get(1):
                    b.skip(18)
        # spectral extension attenuation
        for ch in range(1, fbw + 1):
            if parse_spx_atten and b.get(1):
                st.spx_atten_code[ch] = b.get(5)
            else:
                st.spx_atten_code[ch] = -1
        # block start info (unused)
        if nb > 1 and b.get(1):
            b.skip((nb - 1) * (4 + max((frame_size - 2).bit_length()
                                       - 1, 0)))

    # ------------------------------------------------------------------
    def _decode_block(self, b, st, blk, xf_out, switched_out):
        """Parse one audio block: its scaled coefficients into xf_out
        (channels, 256) and its block-switch flags into switched_out
        (channels,); the filterbank runs per frame (_filterbank)."""
        fbw = st.fbw
        eac3 = st.eac3
        nch = st.channels
        lfe_ch = st.lfe_ch
        # block switch + dither flags
        if st.block_switch_syntax:
            for ch in range(1, fbw + 1):
                st.block_switch[ch] = b.get(1)
        if st.dither_flag_syntax:
            for ch in range(1, fbw + 1):
                st.dither_flag[ch] = b.get(1)
        # dynamic range (read order: ch2 gain first in dual mono,
        # matching the do/while in ac3dec.c:985)
        for i in range((1 if st.acmod == 0 else 0), -1, -1):
            if b.get(1):
                st.dynrng[i] = T.DYNAMIC_RANGE_TAB[b.get(8)]
            elif blk == 0:
                st.dynrng[i] = 1.0
        # spectral extension strategy (E-AC-3)
        if eac3 and (blk == 0 or b.get(1)):
            st.spx_in_use = b.get(1)
            if st.spx_in_use:
                self._spx_strategy(b, st, blk)
        if not eac3 or not st.spx_in_use:
            st.spx_in_use = 0
            for ch in range(1, fbw + 1):
                st.channel_uses_spx[ch] = 0
                st.first_spx_coords[ch] = 1
        if st.spx_in_use:
            self._spx_coordinates(b, st)
        # coupling strategy
        if st.cpl_strategy_exists[blk] if eac3 else b.get(1):
            self._coupling_strategy(b, st, blk)
        elif not eac3:
            if blk == 0:
                raise InvalidData(
                    "ac3: coupling strategy missing in block 0")
            st.cpl_in_use[blk] = st.cpl_in_use[blk - 1]
        cpl_in_use = st.cpl_in_use[blk]
        if cpl_in_use:
            self._coupling_coordinates(b, st, blk)
        # rematrixing
        if st.acmod == 2:
            if (eac3 and blk == 0) or b.get(1):
                nbands = 4
                if cpl_in_use and st.start_freq[CPL] <= 61:
                    nbands -= 1 + (st.start_freq[CPL] == 37)
                elif st.spx_in_use and st.spx_src_start_freq <= 61:
                    nbands -= 1
                st.num_rematrixing_bands = nbands
                st.rematrixing_flags = [b.get(1) for _ in range(nbands)]
            elif blk == 0:
                st.num_rematrixing_bands = 0
        # exponent strategies (AC-3: per block; E-AC-3: from frame hdr)
        first = CPL if cpl_in_use else 1
        if not eac3:
            for ch in range(first, nch + 1):
                st.exp_strategy[blk][ch] = b.get(
                    1 if ch == lfe_ch and st.lfe_on else 2)
        # channel bandwidth
        for ch in range(1, fbw + 1):
            st.start_freq[ch] = 0
            if st.exp_strategy[blk][ch] != EXP_REUSE:
                if st.channel_in_cpl[ch]:
                    st.end_freq[ch] = st.start_freq[CPL]
                elif st.channel_uses_spx[ch]:
                    st.end_freq[ch] = st.spx_src_start_freq
                else:
                    bw = b.get(6)
                    if bw > 60:
                        raise InvalidData("ac3: bad bandwidth code")
                    st.end_freq[ch] = bw * 3 + 73
                gs = 3 << (st.exp_strategy[blk][ch] - 1)
                st.num_exp_groups[ch] = (st.end_freq[ch] + gs - 4) // gs
        if cpl_in_use and st.exp_strategy[blk][CPL] != EXP_REUSE:
            st.num_exp_groups[CPL] = \
                (st.end_freq[CPL] - st.start_freq[CPL]) // \
                (3 << (st.exp_strategy[blk][CPL] - 1))
        if st.lfe_on:
            st.start_freq[lfe_ch] = 0
            st.end_freq[lfe_ch] = 7
            st.num_exp_groups[lfe_ch] = 2
        # exponents
        for ch in range(first, nch + 1):
            if st.exp_strategy[blk][ch] != EXP_REUSE:
                absexp = b.get(4) << (1 if ch == CPL else 0)
                st.dexps[ch][0] = absexp
                self._decode_exponents(
                    b, st.exp_strategy[blk][ch], st.num_exp_groups[ch],
                    absexp, st.dexps[ch],
                    st.start_freq[ch] + (1 if ch != CPL else 0))
                if ch != CPL and ch != (lfe_ch if st.lfe_on else -1):
                    b.skip(2)       # gainrng
        # bit allocation info
        if st.bit_allocation_syntax:
            if b.get(1):
                st.ba["slow_decay"] = \
                    T.SLOW_DECAY_TAB[b.get(2)] >> st.sr_shift
                st.ba["fast_decay"] = \
                    T.FAST_DECAY_TAB[b.get(2)] >> st.sr_shift
                st.ba["slow_gain"] = T.SLOW_GAIN_TAB[b.get(2)]
                st.ba["db_per_bit"] = T.DB_PER_BIT_TAB[b.get(2)]
                st.ba["floor"] = T.FLOOR_TAB[b.get(3)]
            elif blk == 0:
                raise InvalidData("ac3: bit allocation info missing")
        # snr offsets + (AC-3) fast gains
        if not eac3 or blk == 0:
            if st.snr_offset_strategy and b.get(1):
                csnr = (b.get(6) - 15) << 4
                snr = 0
                for ch in range(first, nch + 1):
                    if ch == first or st.snr_offset_strategy == 2:
                        snr = (csnr + b.get(4)) << 2
                    st.snr_offset[ch] = snr
                    if not eac3:
                        st.fast_gain[ch] = T.FAST_GAIN_TAB[b.get(3)]
            elif not eac3 and blk == 0:
                raise InvalidData("ac3: snr offsets missing in block 0")
        # fast gain (E-AC-3)
        if st.fast_gain_syntax and b.get(1):
            for ch in range(first, nch + 1):
                st.fast_gain[ch] = T.FAST_GAIN_TAB[b.get(3)]
        elif eac3 and blk == 0:
            for ch in range(first, nch + 1):
                st.fast_gain[ch] = T.FAST_GAIN_TAB[4]
        # E-AC-3 to AC-3 converter SNR offset
        if st.frame_type == FT_INDEPENDENT and b.get(1):
            b.skip(10)
        # coupling leak
        if cpl_in_use:
            if st.first_cpl_leak or b.get(1):
                st.ba["cpl_fast_leak"] = b.get(3)
                st.ba["cpl_slow_leak"] = b.get(3)
            elif not eac3 and blk == 0:
                raise InvalidData("ac3: coupling leak missing")
            st.first_cpl_leak = 0
        # delta bit allocation
        if st.dba_syntax and b.get(1):
            for ch in range(first, fbw + 1):
                st.dba_mode[ch] = b.get(2)
                if st.dba_mode[ch] == 3:
                    raise InvalidData("ac3: reserved dba mode")
            for ch in range(first, fbw + 1):
                if st.dba_mode[ch] == 2:        # DBA_NEW
                    nseg = b.get(3) + 1
                    st.dba[ch] = [(b.get(5), b.get(4), b.get(3))
                                  for _ in range(nseg)]
        elif blk == 0:
            for ch in range(0, nch + 1):
                st.dba_mode[ch] = 0
        # bit allocation (recomputed every block; the reference's staged
        # caching is a CPU optimization with identical results)
        for ch in range(first, nch + 1):
            psd, band_psd = _calc_psd(st.dexps[ch], st.start_freq[ch],
                                      st.end_freq[ch])
            dba = st.dba[ch] if st.dba_mode[ch] in (1, 2) else None
            mask = _calc_mask(st.ba, band_psd, st.start_freq[ch],
                              st.end_freq[ch], st.fast_gain[ch],
                              ch == lfe_ch and st.lfe_on, dba)
            bap_tab = E.HEBAP_TAB if st.channel_uses_aht[ch] else \
                T.BAP_TAB
            st.bap[ch] = _calc_bap(mask, psd, st.start_freq[ch],
                                   st.end_freq[ch], st.snr_offset[ch],
                                   st.ba["floor"], bap_tab)
        # skip field
        if st.skip_syntax and b.get(1):
            b.skip(8 * b.get(9))
        # mantissas
        coeffs = np.zeros((nch + 1, 256), np.int64)
        m = {"b1": 0, "b2": 0, "b4": 0,
             "b1v": [0, 0], "b2v": [0, 0], "b4v": 0}
        got_cpl = False
        for ch in range(1, nch + 1):
            self._coeffs_ch(b, st, blk, ch, coeffs[ch], m)
            if st.channel_in_cpl.get(ch):
                if not got_cpl:
                    self._coeffs_ch(b, st, blk, CPL, coeffs[CPL], m)
                    self._uncouple(st, coeffs)
                    got_cpl = True
        # zero dithered coupling bins for non-dithering channels
        for ch in range(1, fbw + 1):
            if st.channel_in_cpl.get(ch) and not st.dither_flag[ch]:
                for i in range(st.start_freq[CPL], st.end_freq[CPL]):
                    if st.bap[CPL][i] == 0:
                        coeffs[ch][i] = 0
        # rematrixing
        if st.acmod == 2:
            end = min(st.end_freq[1], st.end_freq[2])
            for bnd in range(st.num_rematrixing_bands):
                if st.rematrixing_flags[bnd]:
                    lo = T.REMATRIX_BAND_TAB[bnd]
                    hi = min(end, T.REMATRIX_BAND_TAB[bnd + 1])
                    t0 = coeffs[1][lo:hi].copy()
                    coeffs[1][lo:hi] = t0 + coeffs[2][lo:hi]
                    coeffs[2][lo:hi] = t0 - coeffs[2][lo:hi]
        # scale to float (headroom + dynamic range gain)
        xf = np.zeros((nch + 1, 256), np.float32)   # row 0: coupling
        for ch in range(1, nch + 1):
            gain = st.dynrng[2 - ch if st.acmod == 0 and ch <= 2 else 0]
            xf[ch] = coeffs[ch].astype(np.float32) * np.float32(
                gain / 4194304.0)
        # spectral extension of the high bins (E-AC-3)
        if st.spx_in_use:
            self._apply_spx(st, xf)
        # the filterbank's input; the LFE channel never switches
        xf_out[:] = xf[1:]
        for ch in range(1, nch + 1):
            if ch != lfe_ch or not st.lfe_on:
                switched_out[ch - 1] = st.block_switch[ch]

    # ---- coupling -----------------------------------------------------
    def _decode_band_structure(self, b, st, blk, eac3, start_subband,
                               end_subband, default, struct):
        """Band structure for coupling / SPX (ac3dec.c:639): 1 per
        subband boundary means merge with the previous band."""
        n_sub = end_subband - start_subband
        if blk == 0:
            struct[:len(default)] = default
        if not eac3 or b.get(1):
            for sb in range(n_sub - 1):
                struct[start_subband + 1 + sb] = b.get(1)
        n_bands = n_sub
        sizes = [12]
        for sb in range(1, n_sub):
            if struct[start_subband + sb]:
                n_bands -= 1
                sizes[-1] += 12
            else:
                sizes.append(12)
        return n_bands, sizes

    def _coupling_strategy(self, b, st, blk):
        fbw = st.fbw
        if not st.eac3:
            st.cpl_in_use[blk] = b.get(1)
        if st.cpl_in_use[blk]:
            if st.acmod < 2:
                raise InvalidData("ac3: coupling in mono")
            if st.eac3 and b.get(1):
                raise NotSupported("eac3: enhanced coupling")
            if st.eac3 and st.acmod == 2:
                st.channel_in_cpl[1] = 1
                st.channel_in_cpl[2] = 1
            else:
                for ch in range(1, fbw + 1):
                    st.channel_in_cpl[ch] = b.get(1)
            if st.acmod == 2:
                st.phase_flags_in_use = b.get(1)
            cpl_start = b.get(4)
            if st.spx_in_use:
                cpl_end = (st.spx_src_start_freq - 37) // 12
            else:
                cpl_end = b.get(4) + 3
            if cpl_start >= cpl_end:
                raise InvalidData("ac3: bad coupling range")
            st.start_freq[CPL] = cpl_start * 12 + 37
            st.end_freq[CPL] = cpl_end * 12 + 37
            nb, sizes = self._decode_band_structure(
                b, st, blk, st.eac3, cpl_start, cpl_end,
                E.DEFAULT_CPL_BAND_STRUCT, st.cpl_band_struct)
            st.cpl_band_sizes = sizes
        else:
            for ch in range(1, fbw + 1):
                st.channel_in_cpl[ch] = 0
                st.first_cpl_coords[ch] = 1
            st.first_cpl_leak = st.eac3
            st.phase_flags_in_use = 0

    def _coupling_coordinates(self, b, st, blk):
        coords_exist = False
        for ch in range(1, st.fbw + 1):
            if st.channel_in_cpl[ch]:
                if (st.eac3 and st.first_cpl_coords[ch]) or b.get(1):
                    st.first_cpl_coords[ch] = 0
                    coords_exist = True
                    master = 3 * b.get(2)
                    for bnd in range(len(st.cpl_band_sizes)):
                        cexp = b.get(4)
                        cmant = b.get(4)
                        if cexp == 15:
                            v = cmant << 22
                        else:
                            v = (cmant + 16) << 21
                        st.cpl_coords[ch][bnd] = v >> (cexp + master)
                elif blk == 0:
                    raise InvalidData("ac3: cpl coords missing")
            else:
                st.first_cpl_coords[ch] = 1
        if st.acmod == 2 and coords_exist:
            nb = len(st.cpl_band_sizes)
            st.phase_flags = [b.get(1) if st.phase_flags_in_use else 0
                              for _ in range(nb)]

    # ---- spectral extension ------------------------------------------
    def _spx_strategy(self, b, st, blk):
        """SPX channel set + frequency ranges (ac3dec.c:705)."""
        fbw = st.fbw
        if st.acmod == 1:
            st.channel_uses_spx[1] = 1
        else:
            bits = b.get(fbw)
            for ch in range(fbw, 0, -1):
                st.channel_uses_spx[ch] = bits & 1
                bits >>= 1
        dst_start = b.get(2)
        start_subband = b.get(3) + 2
        if start_subband > 7:
            start_subband += start_subband - 7
        end_subband = b.get(3) + 5
        if end_subband > 7:
            end_subband += end_subband - 7
        dst_start = dst_start * 12 + 25
        src_start = start_subband * 12 + 25
        dst_end = end_subband * 12 + 25
        if start_subband >= end_subband:
            raise InvalidData("eac3: bad spx range")
        if dst_start >= src_start:
            raise InvalidData("eac3: bad spx copy start")
        st.spx_dst_start_freq = dst_start
        st.spx_src_start_freq = src_start
        st.spx_dst_end_freq = dst_end
        nb, sizes = self._decode_band_structure(
            b, st, blk, True, start_subband, end_subband,
            E.DEFAULT_SPX_BAND_STRUCT, st.spx_band_struct)
        st.num_spx_bands = nb
        st.spx_band_sizes = sizes

    def _spx_coordinates(self, b, st):
        """Per-channel SPX blending coordinates (ac3dec.c:766)."""
        f32 = np.float32
        for ch in range(1, st.fbw + 1):
            if st.channel_uses_spx[ch]:
                if st.first_spx_coords[ch] or b.get(1):
                    st.first_spx_coords[ch] = 0
                    spx_blend = f32(b.get(5)) * f32(1.0 / 32)
                    master = b.get(2) * 3
                    bin_ = st.spx_src_start_freq
                    for bnd in range(st.num_spx_bands):
                        bandsize = st.spx_band_sizes[bnd]
                        nratio = f32(
                            f32(bin_ + (bandsize >> 1)) /
                            f32(st.spx_dst_end_freq)) - spx_blend
                        nratio = min(max(nratio, f32(0.0)), f32(1.0))
                        nblend = np.sqrt(f32(3.0) * nratio,
                                         dtype=np.float32)
                        sblend = np.sqrt(f32(1.0) - nratio,
                                         dtype=np.float32)
                        bin_ += bandsize
                        exp = b.get(4)
                        mant = b.get(2)
                        if exp == 15:
                            mant <<= 1
                        else:
                            mant += 4
                        mant <<= 25 - exp - master
                        coord = f32(mant) * f32(1.0 / (1 << 23))
                        st.spx_noise_blend[ch][bnd] = nblend * coord
                        st.spx_signal_blend[ch][bnd] = sblend * coord
            else:
                st.first_spx_coords[ch] = 1

    def _apply_spx(self, st, xf):
        """Copy low-band coefficients into the extension region, then
        blend with noise per band (eac3dec.c:56)."""
        f32 = np.float32
        # copy-section mapping + wrap flags
        wrapflag = [0] * len(st.spx_band_sizes)
        wrapflag[0] = 1
        copy_sizes = []
        bin_ = st.spx_dst_start_freq
        for bnd, bandsize in enumerate(st.spx_band_sizes):
            if bin_ + bandsize > st.spx_src_start_freq:
                copy_sizes.append(bin_ - st.spx_dst_start_freq)
                bin_ = st.spx_dst_start_freq
                wrapflag[bnd] = 1
            i = 0
            while i < bandsize:
                if bin_ == st.spx_src_start_freq:
                    copy_sizes.append(bin_ - st.spx_dst_start_freq)
                    bin_ = st.spx_dst_start_freq
                csize = min(bandsize - i, st.spx_src_start_freq - bin_)
                bin_ += csize
                i += csize
        copy_sizes.append(bin_ - st.spx_dst_start_freq)
        for ch in range(1, st.fbw + 1):
            if not st.channel_uses_spx[ch]:
                continue
            row = xf[ch]
            bin_ = st.spx_src_start_freq
            for cs in copy_sizes:
                row[bin_:bin_ + cs] = \
                    row[st.spx_dst_start_freq:
                        st.spx_dst_start_freq + cs]
                bin_ += cs
            # RMS energy per band (C float accumulation order)
            rms = []
            bin_ = st.spx_src_start_freq
            for bandsize in st.spx_band_sizes:
                accum = f32(0.0)
                for i in range(bandsize):
                    c = row[bin_ + i]
                    accum = f32(accum + f32(c * c))
                bin_ += bandsize
                rms.append(np.sqrt(f32(accum / f32(bandsize)),
                                   dtype=np.float32))
            # notch filter at copy-region wrap points
            if st.spx_atten_code[ch] >= 0:
                atten = E.SPX_ATTEN_TAB[st.spx_atten_code[ch]]
                bin_ = st.spx_src_start_freq - 2
                for bnd, bandsize in enumerate(st.spx_band_sizes):
                    if wrapflag[bnd]:
                        row[bin_] *= atten[0]
                        row[bin_ + 1] *= atten[1]
                        row[bin_ + 2] *= atten[2]
                        row[bin_ + 3] *= atten[1]
                        row[bin_ + 4] *= atten[0]
                    bin_ += bandsize
            # noise-blended scaling
            bin_ = st.spx_src_start_freq
            for bnd, bandsize in enumerate(st.spx_band_sizes):
                nscale = f32(st.spx_noise_blend[ch][bnd] * rms[bnd] *
                             f32(1.0 / -2147483648.0))
                sscale = st.spx_signal_blend[ch][bnd]
                for i in range(bandsize):
                    noise = f32(nscale * f32(self._dith.get_signed()))
                    row[bin_] = f32(row[bin_] * sscale) + noise
                    bin_ += 1

    # ---- exponents / mantissas ---------------------------------------
    @staticmethod
    def _decode_exponents(b, strategy, ngrps, absexp, dexps, start):
        group_size = strategy + (strategy == EXP_D45)
        dexp = []
        for _ in range(ngrps):
            v = b.get(7)
            if v >= 125:
                raise InvalidData("ac3: bad exponent group")
            dexp.extend(T.UNGROUP_3_IN_7[v])
        prev = absexp
        j = start
        for d in dexp:
            prev += d - 2
            if not 0 <= prev <= 24:
                raise InvalidData("ac3: exponent out of range")
            for _ in range(group_size):
                dexps[j] = prev
                j += 1

    def _coeffs_ch(self, b, st, blk, ch, coeffs, m):
        """decode_transform_coeffs_ch: AHT channels take all 6 blocks
        of pre-mantissas from block 0 (ac3dec.c:491)."""
        if not st.channel_uses_aht[ch]:
            self._decode_mantissas(b, st, ch, coeffs, m)
        else:
            if blk == 0:
                self._decode_aht_ch(b, st, ch)
            pm = st.pre_mantissa[ch]
            exps = st.dexps[ch]
            for bin_ in range(st.start_freq[ch], st.end_freq[ch]):
                coeffs[bin_] = int(pm[bin_][blk]) >> int(exps[bin_])

    def _decode_aht_ch(self, b, st, ch):
        """AHT: GAQ gains + 6 pre-mantissas per bin, then a 6-point
        IDCT over the block axis (eac3dec.c:195)."""
        gaq_mode = b.get(2)
        end_bap = 12 if gaq_mode < 2 else 17
        bap = st.bap[ch]
        gaq_gain = []
        if gaq_mode in (1, 2):          # EAC3_GAQ_12 / _14
            for bin_ in range(st.start_freq[ch], st.end_freq[ch]):
                if 7 < bap[bin_] < end_bap:
                    gaq_gain.append(b.get(1) << (gaq_mode - 1))
        elif gaq_mode == 3:             # EAC3_GAQ_124
            gc = 2
            for bin_ in range(st.start_freq[ch], st.end_freq[ch]):
                if 7 < bap[bin_] < 17:
                    if gc == 2:
                        code = min(b.get(5), 26)
                        gaq_gain.extend(T.UNGROUP_3_IN_5[code])
                        gc = 0
                    else:
                        gc += 1
        # NOTE the reference's gc++ == 2 post-increment: gc counts 2,
        # then resets to 0 and counts 0,1,2 → one group per 3 bins
        pm = st.pre_mantissa[ch]
        gs = 0
        for bin_ in range(st.start_freq[ch], st.end_freq[ch]):
            hebap = int(bap[bin_])
            bits = E.BITS_VS_HEBAP[hebap]
            row = [0] * 6
            if hebap == 0:
                for blk in range(6):
                    row[blk] = (self._dith.get() & 0x7FFFFF) - 0x400000
            elif hebap < 8:
                v = b.get(bits)
                vq = E.MANTISSA_VQ[hebap][v]
                for blk in range(6):
                    row[blk] = int(vq[blk]) << 8
            else:
                if gaq_mode != 0 and hebap < end_bap:
                    log_gain = gaq_gain[gs]
                    gs += 1
                else:
                    log_gain = 0
                gbits = bits - log_gain
                for blk in range(6):
                    mant = b.get_signed(gbits)
                    if log_gain and mant == -(1 << (gbits - 1)):
                        # large mantissa
                        mbits = bits - (2 - log_gain)
                        mant = b.get_signed(mbits)
                        mant = _i32((mant & 0xFFFFFFFF) <<
                                    (23 - (mbits - 1)))
                        if mant >= 0:
                            bb = 1 << (23 - log_gain)
                        else:
                            bb = E.GAQ_REMAP_2_4_B[hebap - 8][
                                log_gain - 1] << 8
                        mant = _i32(mant + ((
                            E.GAQ_REMAP_2_4_A[hebap - 8][log_gain - 1]
                            * mant) >> 15) + bb)
                    else:
                        mant *= 1 << (24 - bits)
                        if not log_gain:
                            mant = _i32(mant + (
                                (E.GAQ_REMAP_1[hebap - 8] * mant)
                                >> 15))
                    row[blk] = mant
            _idct6(row)
            pm[bin_] = row

    def _decode_mantissas(self, b, st, ch, coeffs, m):
        """A/52 §7.3 mantissa quantization (ac3dec.c:395)."""
        dither = (ch == CPL) or st.dither_flag[ch]
        exps = st.dexps[ch]
        bap = st.bap[ch]
        for freq in range(st.start_freq[ch], st.end_freq[ch]):
            bp = bap[freq]
            if bp == 0:
                if dither:
                    mant = (((self._dith.get() >> 8) * 181) >> 8) - 5931008
                else:
                    mant = 0
            elif bp == 1:
                if m["b1"]:
                    m["b1"] -= 1
                    mant = m["b1v"][m["b1"]]
                else:
                    v = T.BAP1_MANTISSAS[b.get(5)]
                    mant, m["b1v"][1], m["b1v"][0] = v[0], v[1], v[2]
                    m["b1"] = 2
            elif bp == 2:
                if m["b2"]:
                    m["b2"] -= 1
                    mant = m["b2v"][m["b2"]]
                else:
                    v = T.BAP2_MANTISSAS[b.get(7)]
                    mant, m["b2v"][1], m["b2v"][0] = v[0], v[1], v[2]
                    m["b2"] = 2
            elif bp == 3:
                mant = T.BAP3_MANTISSAS[b.get(3)]
            elif bp == 4:
                if m["b4"]:
                    m["b4"] = 0
                    mant = m["b4v"]
                else:
                    v = T.BAP4_MANTISSAS[b.get(7)]
                    mant, m["b4v"] = v[0], v[1]
                    m["b4"] = 1
            elif bp == 5:
                mant = T.BAP5_MANTISSAS[b.get(4)]
            else:
                nbits = T.QUANTIZATION_TAB[bp]
                mant = b.get_signed(nbits) << (24 - nbits)
            # arithmetic right shift, same as the reference's C shift
            coeffs[freq] = mant >> int(exps[freq])

    @staticmethod
    def _uncouple(st, coeffs):
        """Reconstruct coupled channels (A/52 §7.4.3, ac3dec.c:355)."""
        bin_ = st.start_freq[CPL]
        for band, size in enumerate(st.cpl_band_sizes):
            band_start, band_end = bin_, bin_ + size
            for ch in range(1, st.fbw + 1):
                if st.channel_in_cpl.get(ch):
                    coord = st.cpl_coords[ch][band] << 5
                    for i in range(band_start, band_end):
                        v = (int(coeffs[CPL][i]) * 16 * coord)
                        coeffs[ch][i] = v >> 32
                    if ch == 2 and st.phase_flags[band]:
                        coeffs[2][band_start:band_end] = \
                            -coeffs[2][band_start:band_end]
            bin_ = band_end


@register_decoder
class Eac3Decoder(Ac3Decoder):
    codec_id = "eac3"


class _FrameState:
    def __init__(self, channels, fbw, lfe_on, acmod, sr_code, sr_shift,
                 eac3=False, num_blocks=6, frame_type=FT_AC3_CONVERT):
        self.channels = channels
        self.fbw = fbw
        self.lfe_on = lfe_on
        self.lfe_ch = fbw + 1
        self.acmod = acmod
        self.sr_shift = sr_shift
        self.eac3 = eac3
        self.num_blocks = num_blocks
        self.frame_type = frame_type if eac3 else FT_AC3_CONVERT
        self.block_switch = [0] * (channels + 1)
        self.dither_flag = [0] * (channels + 1)
        self.dynrng = [1.0, 1.0]
        self.cpl_strategy_exists = [0] * num_blocks
        self.cpl_in_use = [0] * num_blocks
        self.channel_in_cpl = {ch: 0 for ch in range(1, fbw + 1)}
        self.first_cpl_coords = {ch: 1 for ch in range(1, fbw + 1)}
        self.phase_flags_in_use = 0
        self.phase_flags = [0] * 18
        self.cpl_band_sizes = []
        self.cpl_band_struct = [0] * 18
        self.cpl_coords = {ch: [0] * 18 for ch in range(1, fbw + 1)}
        self.num_rematrixing_bands = 0
        self.rematrixing_flags = []
        self.start_freq = {CPL: 0}
        self.end_freq = {CPL: 0}
        self.num_exp_groups = {}
        self.exp_strategy = [[EXP_REUSE] * (channels + 1)
                             for _ in range(max(num_blocks, 6))]
        self.dexps = {ch: np.zeros(256, np.int8)
                      for ch in range(0, channels + 1)}
        self.bap = {ch: np.zeros(256, np.uint8)
                    for ch in range(0, channels + 1)}
        self.snr_offset = {ch: 0 for ch in range(0, channels + 1)}
        self.fast_gain = {ch: 0 for ch in range(0, channels + 1)}
        self.dba_mode = {ch: 0 for ch in range(0, channels + 1)}
        self.dba = {ch: None for ch in range(0, channels + 1)}
        self.ba = {"sr_code": sr_code, "sr_shift": sr_shift,
                   "slow_decay": 0, "fast_decay": 0, "slow_gain": 0,
                   "db_per_bit": 0, "floor": 0,
                   "cpl_fast_leak": 0, "cpl_slow_leak": 0}
        # syntax flags: AC-3 fixed values (ac3dec.c:209-217) replaced
        # by the E-AC-3 frame header when eac3
        self.snr_offset_strategy = 2
        self.block_switch_syntax = 1
        self.dither_flag_syntax = 1
        self.bit_allocation_syntax = 1
        self.fast_gain_syntax = 0
        self.first_cpl_leak = 1 if eac3 else 0   # eac3dec.c:511
        self.dba_syntax = 1
        self.skip_syntax = 1
        # E-AC-3 extensions
        self.channel_uses_aht = {ch: 0 for ch in range(0, channels + 1)}
        self.pre_mantissa = {ch: np.zeros((256, 6), np.int64)
                             for ch in range(0, channels + 1)}
        self.spx_in_use = 0
        self.channel_uses_spx = {ch: 0 for ch in range(1, fbw + 1)}
        self.first_spx_coords = {ch: 1 for ch in range(1, fbw + 1)}
        self.spx_atten_code = {ch: -1 for ch in range(1, fbw + 1)}
        self.spx_src_start_freq = 0
        self.spx_dst_start_freq = 0
        self.spx_dst_end_freq = 0
        self.num_spx_bands = 0
        self.spx_band_sizes = []
        self.spx_band_struct = [0] * 17
        self.spx_noise_blend = {ch: np.zeros(18, np.float32)
                                for ch in range(1, fbw + 1)}
        self.spx_signal_blend = {ch: np.zeros(18, np.float32)
                                 for ch in range(1, fbw + 1)}
