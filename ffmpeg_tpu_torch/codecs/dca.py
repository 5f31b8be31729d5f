"""DCA (DTS Coherent Acoustics) core decoder.

Implements the core-substream path of ETSI TS 102 114: frame header,
coding header, subframe side info (bit allocation, transients, scale
factors), subband audio (Huffman / block codes / linear), inverse
ADPCM, high-frequency VQ, joint intensity, LFE, and the 32-band QMF
synthesis filterbank. Extension substreams (XCH/XXCH/X96/XLL/EXSS)
are skipped.

Reference behavior: libavcodec/dca_core.c (parse_frame_header:83,
parse_coding_header:154, parse_subframe_header:404,
parse_subframe_audio:627, filter_frame_float:2161) and
libavcodec/dcadsp.c / synth_filter.c for the DSP path. Tables come
from tools/gen_dca_tables.py.

The port's copy of ffmpeg_tpu/codecs/dca.py, held equal to it by
tests/test_torch_host_codecs.py.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.frame import Frame
from ..core.packet import Packet
from ..io.stream import MediaType
from ..utils.error import InvalidData, NotSupported
from ..utils.rational import Rational
from . import dca_tables as T
from .bitstream import BitReader
from .codec import DeviceCodec, register_decoder

SYNC = 0x7FFE8001
SUBBAND_SAMPLES = 8
SUBBANDS = 32
ADPCM_COEFFS = 4
LFE_HISTORY = 8
PCMBLOCK_SAMPLES = 32
CODE_BOOKS = 10
ABITS_MAX = 26

BLOCK_CODE_NBITS = [7, 10, 12, 13, 15, 17, 19]

# primary channel -> speaker for each audio_mode (dca_core.c:41);
# speakers: 0=C 1=L 2=R 3=Ls 4=Rs
PRM_CH_TO_SPKR = [
    [0], [1, 2], [1, 2], [1, 2], [1, 2],
    [0, 1, 2], [1, 2, 3], [0, 1, 2, 3], [1, 2, 3, 4],
    [0, 1, 2, 3, 4],
]


def clip23(a):
    return np.clip(a, -(1 << 23), (1 << 23) - 1)


def _norm(a, bits):
    return (a + (1 << (bits - 1))) >> bits


class _Huff:
    """Canonical prefix decoder from (code, len, sym) triples."""

    __slots__ = ("lut", "maxlen")

    def __init__(self, triples):
        self.lut = {}
        self.maxlen = 0
        for code, ln, sym in triples:
            self.lut[(ln, code)] = sym
            self.maxlen = max(self.maxlen, ln)

    def read(self, br: BitReader) -> int:
        code = 0
        for ln in range(1, self.maxlen + 1):
            code = (code << 1) | br.get(1)
            sym = self.lut.get((ln, code))
            if sym is not None:
                return sym
        raise InvalidData("dca: invalid huffman code")


_H_QUANT = [[_Huff(t) for t in grp] for grp in T.HUFF_QUANT]
_H_BITALLOC = [_Huff(t) for t in T.HUFF_BITALLOC]
_H_SCALES = [_Huff(t) for t in T.HUFF_SCALES]
_H_TMODE = [_Huff(t) for t in T.HUFF_TMODE]

# 32-point inverse MDCT matrix matching av_tx's naive inverse
# (tx_template.c ff_tx_mdct_naive_inv with len=32): out[0:16] uses
# cos((2j+1)*pi/128*(63-2i)), out[16:32] = -cos(...*(97+2i)).
def _imdct32_matrix():
    m = np.zeros((32, 32))
    j = np.arange(32)
    for i in range(16):
        m[i] = np.cos((2 * j + 1) * (np.pi / 128) * (63 - 2 * i))
        m[i + 16] = -np.cos((2 * j + 1) * (np.pi / 128)
                            * (97 + 2 * i))
    return m


_IMDCT32 = _imdct32_matrix()


class _QmfState:
    __slots__ = ("hist1", "offset", "hist2")

    def __init__(self):
        self.hist1 = np.zeros(1024)
        self.offset = 0
        self.hist2 = np.zeros(32)


def _synth_block(st: _QmfState, window, inp, scale):
    """synth_filter_float (synth_filter.c:26) for one 32-sample
    block."""
    buf = st.hist1
    off = st.offset
    buf[off:off + 32] = _IMDCT32 @ inp
    out = np.empty(32)
    i = np.arange(16)
    a = st.hist2[:16].copy()
    b = st.hist2[16:].copy()
    c = np.zeros(16)
    d = np.zeros(16)
    for j in range(0, 512, 64):
        base = off + j if j < 512 - off else off + j - 512
        a += window[i + j] * (-buf[base + 15 - i])
        b += window[i + j + 16] * buf[base + i]
        c += window[i + j + 32] * buf[base + 16 + i]
        d += window[i + j + 48] * buf[base + 31 - i]
    out[:16] = a * scale
    out[16:] = b * scale
    st.hist2[:16] = c
    st.hist2[16:] = d
    st.offset = (off - 32) & 511
    return out


class _ChannelState:
    """Per-channel persistent state across frames."""

    __slots__ = ("adpcm_hist", "qmf")

    def __init__(self):
        # (band, 4) ADPCM history
        self.adpcm_hist = np.zeros((SUBBANDS, ADPCM_COEFFS),
                                   np.int64)
        self.qmf = _QmfState()


@register_decoder
class DcaDecoder(DeviceCodec):
    codec_id = "dts"
    aliases = ("dca",)
    codec_type = MediaType.AUDIO

    def __init__(self, par, options=None, *, device="cuda"):
        super().__init__(par, options, device=device)
        self._buf = b""
        self._ch_state = {}
        self._lfe_hist = np.zeros(LFE_HISTORY, np.int64)

    # ------------------------------------------------------ frame split
    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None:
            return []
        self._buf += pkt.data or b""
        frames = []
        while True:
            i = self._buf.find(b"\x7f\xfe\x80\x01")
            if i < 0 or len(self._buf) - i < 16:
                break
            hdr = BitReader(self._buf[i:i + 16])
            hdr.get(32)
            hdr.get(1)                        # normal_frame
            hdr.get(5)                        # deficit
            hdr.get(1)                        # crc
            hdr.get(7)                        # npcmblocks
            frame_size = hdr.get(14) + 1
            if len(self._buf) - i < frame_size:
                break
            data = self._buf[i:i + frame_size]
            self._buf = self._buf[i + frame_size:]
            f = self._decode_frame(data, pkt)
            if f is not None:
                frames.append(f)
        return frames

    # ------------------------------------------------------ core frame
    def _decode_frame(self, data: bytes, pkt) -> Optional[Frame]:
        br = BitReader(data)
        if br.get(32) != SYNC:
            raise InvalidData("dca: bad sync")
        br.get(1)                             # normal_frame
        if br.get(5) + 1 != PCMBLOCK_SAMPLES:
            raise NotSupported("dca: deficit samples")
        crc_present = br.get(1)
        npcmblocks = br.get(7) + 1            # subband samples/band
        if npcmblocks & (SUBBAND_SAMPLES - 1):
            raise InvalidData("dca: pcm block count")
        br.get(14)                            # frame_size
        audio_mode = br.get(6)
        if audio_mode >= len(PRM_CH_TO_SPKR):
            raise NotSupported("dca: audio mode")
        sr_code = br.get(4)
        sample_rate = T.SAMPLE_RATES[sr_code]
        if not sample_rate:
            raise InvalidData("dca: sample rate")
        br_code = br.get(5)
        bit_rate = T.BIT_RATES[br_code]
        if br.get(1):
            raise InvalidData("dca: reserved bit")
        drc_present = br.get(1)
        br.get(1)                             # ts_present
        br.get(1)                             # aux_present
        br.get(1)                             # hdcd_master
        br.get(3)                             # ext_audio_type
        br.get(1)                             # ext_audio_present
        sync_ssf = br.get(1)
        lfe_present = br.get(2)               # 1=128x, 2=64x
        if lfe_present == 3:
            raise InvalidData("dca: lfe flag")
        predictor_history = br.get(1)
        if crc_present:
            br.get(16)
        filter_perfect = br.get(1)
        br.get(4)                             # encoder_rev
        br.get(2)                             # copy_hist
        pcmr_code = br.get(3)
        if not T.BITS_PER_SAMPLE[pcmr_code]:
            raise InvalidData("dca: pcm resolution")
        br.get(1)                             # sumdiff_front
        br.get(1)                             # sumdiff_surround
        br.get(4)                             # dialog norm

        nchannels = T.CHANNELS[audio_mode]

        # ---------------------------------------------- coding header
        nsubframes = br.get(4) + 1
        if br.get(3) + 1 != nchannels:
            raise InvalidData("dca: channel count mismatch")
        nsubbands = [br.get(5) + 2 for _ in range(nchannels)]
        if max(nsubbands) > SUBBANDS:
            raise InvalidData("dca: subband count")
        vq_start = [br.get(5) + 1 for _ in range(nchannels)]
        joint_idx = [br.get(3) for _ in range(nchannels)]
        tmode_sel = [br.get(2) for _ in range(nchannels)]
        scale_sel = [br.get(3) for _ in range(nchannels)]
        if 7 in scale_sel:
            raise InvalidData("dca: scale codebook")
        bitalloc_sel = [br.get(3) for _ in range(nchannels)]
        if 7 in bitalloc_sel:
            raise InvalidData("dca: bitalloc codebook")
        quant_sel = [[0] * CODE_BOOKS for _ in range(nchannels)]
        for n in range(CODE_BOOKS):
            for ch in range(nchannels):
                quant_sel[ch][n] = br.get(
                    T.QUANT_INDEX_SEL_NBITS[n])
        scale_adj = [[4194304] * CODE_BOOKS
                     for _ in range(nchannels)]
        for n in range(CODE_BOOKS):
            for ch in range(nchannels):
                if quant_sel[ch][n] < T.QUANT_INDEX_GROUP_SIZE[n]:
                    scale_adj[ch][n] = T.SCALE_FACTOR_ADJ[br.get(2)]
        if crc_present:
            br.get(16)

        # persistent state
        for ch in range(nchannels):
            if ch not in self._ch_state:
                self._ch_state[ch] = _ChannelState()
        if not predictor_history:
            for ch in range(nchannels):
                self._ch_state[ch].adpcm_hist[:] = 0

        sb = np.zeros((nchannels, SUBBANDS,
                       ADPCM_COEFFS + npcmblocks), np.int64)
        for ch in range(nchannels):
            sb[ch, :, :ADPCM_COEFFS] = self._ch_state[ch].adpcm_hist
        nlfe_total = npcmblocks // (4 >> (lfe_present == 2)) \
            if lfe_present else 0
        lfe = np.zeros(LFE_HISTORY + (nlfe_total or 0), np.int64)
        lfe[:LFE_HISTORY] = self._lfe_hist

        scale_factors = np.zeros((nchannels, SUBBANDS, 2), np.int64)
        joint_scale = np.zeros((nchannels, SUBBANDS), np.int64)
        step_table = T.LOSSLESS_QUANT if bit_rate == 3 \
            else T.LOSSY_QUANT

        def parse_scale(idx, sel):
            if sel > 5:
                table, size = T.SCALE_FACTOR_QUANT7, 128
            else:
                table, size = T.SCALE_FACTOR_QUANT6, 64
            if sel < 5:
                idx += _H_SCALES[sel].read(br)
            else:
                idx = br.get(sel + 1)
            if not 0 <= idx < size:
                raise InvalidData("dca: scale index")
            return idx, table[idx]

        sub_pos = 0
        lfe_pos = LFE_HISTORY
        for sf in range(nsubframes):
            nssf = br.get(2) + 1
            br.get(3)                         # partial sample count
            pmode = [[br.get(1) for _ in range(nsubbands[ch])]
                     for ch in range(nchannels)]
            pvq = [[br.get(12) if pmode[ch][band] else 0
                    for band in range(nsubbands[ch])]
                   for ch in range(nchannels)]
            abits = [[0] * SUBBANDS for _ in range(nchannels)]
            for ch in range(nchannels):
                sel = bitalloc_sel[ch]
                for band in range(vq_start[ch]):
                    if sel < 5:
                        v = _H_BITALLOC[sel].read(br)
                    else:
                        v = br.get(sel - 1)
                    if v > ABITS_MAX:
                        raise InvalidData("dca: abits")
                    abits[ch][band] = v
            tmode = [[0] * SUBBANDS for _ in range(nchannels)]
            if nssf > 1:
                for ch in range(nchannels):
                    sel = tmode_sel[ch]
                    for band in range(vq_start[ch]):
                        if abits[ch][band]:
                            tmode[ch][band] = \
                                _H_TMODE[sel].read(br)
            for ch in range(nchannels):
                sel = scale_sel[ch]
                sidx = 0
                for band in range(vq_start[ch]):
                    if abits[ch][band]:
                        sidx, s0 = parse_scale(sidx, sel)
                        scale_factors[ch, band, 0] = s0
                        if tmode[ch][band]:
                            sidx, s1 = parse_scale(sidx, sel)
                            scale_factors[ch, band, 1] = s1
                    else:
                        scale_factors[ch, band, 0] = 0
                for band in range(vq_start[ch], nsubbands[ch]):
                    sidx, s0 = parse_scale(sidx, sel)
                    scale_factors[ch, band, 0] = s0
            joint_sel = [0] * nchannels
            for ch in range(nchannels):
                if joint_idx[ch]:
                    joint_sel[ch] = br.get(3)
                    if joint_sel[ch] == 7:
                        raise InvalidData("dca: joint codebook")
            for ch in range(nchannels):
                src = joint_idx[ch] - 1
                if src >= 0:
                    sel = joint_sel[ch]
                    for band in range(nsubbands[ch],
                                      nsubbands[src]):
                        if sel < 5:
                            jidx = _H_SCALES[sel].read(br) + 64
                        else:
                            jidx = br.get(sel + 1) + 64
                        if not 0 <= jidx < 129:
                            raise InvalidData("dca: joint scale")
                        joint_scale[ch, band] = \
                            T.JOINT_SCALE_FACTORS[jidx]
            if drc_present:
                br.get(8)
            if crc_present:
                br.get(16)

            # ---------------------------------------- subframe audio
            nsamples = nssf * SUBBAND_SAMPLES
            if sub_pos + nsamples > npcmblocks:
                raise InvalidData("dca: subband overflow")

            # high-frequency VQ subbands (dcadsp.c decode_hf)
            for ch in range(nchannels):
                for band in range(vq_start[ch], nsubbands[ch]):
                    vqi = br.get(10)
                    coeff = T.HIGH_FREQ_VQ[vqi].astype(np.int64)
                    scale = int(scale_factors[ch, band, 0])
                    vals = clip23((coeff[:nsamples] * scale
                                   + (1 << 3)) >> 4)
                    sb[ch, band, ADPCM_COEFFS + sub_pos:
                       ADPCM_COEFFS + sub_pos + nsamples] = vals

            # LFE
            if lfe_present:
                nlfe = 2 * lfe_present * nssf
                audio = [br.get_signed(8) for _ in range(nlfe)]
                index = br.get(8)
                if index >= 128:
                    raise InvalidData("dca: lfe scale")
                scale = T.SCALE_FACTOR_QUANT7[index]
                scale = _norm(4697620 * scale, 23)  # x 0.035
                for n in range(nlfe):
                    lfe[lfe_pos + n] = clip23(
                        (audio[n] * scale) >> 4)
                lfe_pos += nlfe

            for ssf in range(nssf):
                for ch in range(nchannels):
                    for band in range(vq_start[ch]):
                        ab = abits[ch][band]
                        audio, huff = self._extract_audio(
                            br, ab, quant_sel[ch])
                        step = int(step_table[ab])
                        tr = tmode[ch][band]
                        scale = int(scale_factors[
                            ch, band, 0 if (tr == 0 or ssf < tr)
                            else 1])
                        if huff:
                            scale = int(clip23(_norm(
                                scale_adj[ch][ab - 1] * scale,
                                22)))
                        # ff_dca_core_dequantize (dca_core.h:226)
                        step_scale = step * scale
                        shift = 0
                        if step_scale > (1 << 23):
                            shift = (step_scale >> 23) \
                                .bit_length()
                            step_scale >>= shift
                        vals = clip23(_norm(
                            audio * step_scale, 22 - shift))
                        ofs = ADPCM_COEFFS + sub_pos \
                            + ssf * SUBBAND_SAMPLES
                        sb[ch, band, ofs:ofs + SUBBAND_SAMPLES] \
                            = vals
                if (ssf == nssf - 1 or sync_ssf) \
                        and br.get(16) != 0xFFFF:
                    raise InvalidData("dca: DSYNC")

            # inverse ADPCM over this subframe
            for ch in range(nchannels):
                for band in range(nsubbands[ch]):
                    if pmode[ch][band]:
                        coeff = T.ADPCM_VB[pvq[ch][band]] \
                            .astype(np.int64)
                        row = sb[ch, band]
                        for j in range(nsamples):
                            p = ADPCM_COEFFS + sub_pos + j
                            hist = row[p - 4:p]
                            pred = int(hist[3]) * coeff[0] \
                                + int(hist[2]) * coeff[1] \
                                + int(hist[1]) * coeff[2] \
                                + int(hist[0]) * coeff[3]
                            pred = clip23(_norm(int(pred), 13))
                            row[p] = clip23(row[p] + pred)

            # joint intensity (dcadsp.c decode_joint)
            for ch in range(nchannels):
                src = joint_idx[ch] - 1
                if src >= 0:
                    for band in range(nsubbands[ch],
                                      nsubbands[src]):
                        js = int(joint_scale[ch, band])
                        seg = sb[src, band,
                                 ADPCM_COEFFS + sub_pos:
                                 ADPCM_COEFFS + sub_pos
                                 + nsamples]
                        sb[ch, band, ADPCM_COEFFS + sub_pos:
                           ADPCM_COEFFS + sub_pos + nsamples] = \
                            clip23(_norm(seg * js, 17))

            sub_pos += nsamples

        # carry state
        for ch in range(nchannels):
            nsb = nsubbands[ch]
            if joint_idx[ch]:
                nsb = max(nsb, nsubbands[joint_idx[ch] - 1])
            self._ch_state[ch].adpcm_hist[:nsb] = \
                sb[ch, :nsb, npcmblocks:npcmblocks + ADPCM_COEFFS]
            self._ch_state[ch].adpcm_hist[nsb:] = 0
        if lfe_present:
            self._lfe_hist = lfe[nlfe_total:nlfe_total
                                 + LFE_HISTORY].copy()

        # --------------------------------------------- QMF synthesis
        window = T.FIR_32BANDS_PERFECT if filter_perfect \
            else T.FIR_32BANDS_NONPERFECT
        nsamples_pcm = npcmblocks * PCMBLOCK_SAMPLES
        spkr_map = PRM_CH_TO_SPKR[audio_mode]
        out = {}
        sign = np.where((np.arange(32) - 1) & 2, -1.0, 1.0)
        for ch in range(nchannels):
            pcm = np.empty(nsamples_pcm)
            st = self._ch_state[ch].qmf
            for j in range(npcmblocks):
                inp = sign * sb[ch, :, ADPCM_COEFFS + j]
                pcm[j * 32:(j + 1) * 32] = _synth_block(
                    st, window, inp, 1.0 / (1 << 17))
            out[spkr_map[ch]] = pcm

        if lfe_present:
            dec_select = int(lfe_present == 1)     # 1 => 128x
            fir = T.LFE_FIR_128 if dec_select else T.LFE_FIR_64
            factor = 64 << dec_select
            ncoeffs = 8 >> dec_select
            nlfes = npcmblocks >> (dec_select + 1)
            pcm = np.empty(nsamples_pcm)
            for i in range(nlfes):
                hist = lfe[LFE_HISTORY + i - ncoeffs + 1:
                           LFE_HISTORY + i + 1][::-1].astype(float)
                for j in range(factor // 2):
                    a = float(np.dot(
                        fir[j * ncoeffs:(j + 1) * ncoeffs], hist))
                    b = float(np.dot(
                        fir[255 - j * ncoeffs - (ncoeffs - 1):
                            256 - j * ncoeffs][::-1], hist))
                    pcm[i * factor + j] = a
                    pcm[i * factor + factor // 2 + j] = b
            out[5] = pcm                     # LFE speaker slot

        # ffmpeg native order: FL FR FC LFE SL SR (subset present)
        order = []
        have = set(out)
        if 1 in have:
            order += [1, 2]                  # L R
        if 0 in have:
            order.append(0)                  # C
        if 5 in have:
            order.append(5)                  # LFE
        if 3 in have:
            order += [3, 4]                  # Ls Rs
        chans = np.stack([out[k] for k in order]) \
            .astype(np.float32)

        f = Frame.audio(chans, int(sample_rate), fmt="fltp",
                        pts=pkt.pts if pkt else 0)
        f.time_base = (pkt.time_base if pkt else None) \
            or Rational(1, int(sample_rate))
        return f

    def _extract_audio(self, br, ab, qsel):
        """extract_audio (dca_core.c:588): huffman / block codes /
        linear. Returns (np.int64[8], used_huffman)."""
        if ab == 0:
            return np.zeros(SUBBAND_SAMPLES, np.int64), False
        if ab <= CODE_BOOKS:
            sel = qsel[ab - 1]
            if sel < T.QUANT_INDEX_GROUP_SIZE[ab - 1]:
                h = _H_QUANT[ab - 1][sel]
                return np.array([h.read(br)
                                 for _ in range(SUBBAND_SAMPLES)],
                                np.int64), True
            if ab <= 7:
                nb = BLOCK_CODE_NBITS[ab - 1]
                code1 = br.get(nb)
                code2 = br.get(nb)
                levels = int(T.QUANT_LEVELS[ab])
                offset = (levels - 1) // 2
                audio = np.empty(SUBBAND_SAMPLES, np.int64)
                for n in range(4):
                    audio[n] = code1 % levels - offset
                    code1 //= levels
                for n in range(4, 8):
                    audio[n] = code2 % levels - offset
                    code2 //= levels
                if code1 or code2:
                    raise InvalidData("dca: block code")
                return audio, False
        return np.array([br.get_signed(ab - 3)
                         for _ in range(SUBBAND_SAMPLES)],
                        np.int64), False
