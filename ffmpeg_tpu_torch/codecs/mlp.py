"""MLP / TrueHD lossless audio decoder (reference:
libavcodec/mlpdec.c, mlp_parse.c, mlpdsp.c, mlp.c tables).

Host-side decode: MLP is bit-serial entropy + short IIR/FIR lossless
prediction + primitive-matrix reconstruction — control-heavy integer
work that belongs on the CPU (SURVEY §7 host-entropy split). Output is
bit-exact vs the reference (lossless codec ⇒ the tests require
byte-identical PCM).

Scope: MLP (format sync 0xf8726fbb) and TrueHD (0xf8726fba) with
standard layouts; all substreams decoded; 16-bit streams emit s16p,
20/24-bit emit s32p (the reference's sample_fmt selection).

The port's copy of ffmpeg_tpu/codecs/mlp.py, held equal to it by
tests/test_torch_host_codecs.py.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.frame import Frame
from ..core.packet import Packet
from ..io.stream import MediaType
from ..utils.error import InvalidData, NotSupported
from .bitstream import BitReader
from .codec import DeviceCodec, register_decoder

MAX_CHANNELS = 10          # matrix channels incl. 2 MLP noise channels
MAX_MATRICES = 15
FIR, IIR = 0, 1

# quantization word sizes (mlp_parse.c mlp_quants)
_QUANTS = [16, 20, 24, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]

# channel counts per MLP channel arrangement (mlp.c ff_mlp_ch_info
# group1+group2 channel totals)
_MLP_CHANNELS = [1, 2, 3, 4, 3, 4, 5, 3, 4, 5, 4, 5, 6, 4, 5, 4, 5,
                 6, 5, 5, 6]


def _mlp_samplerate(code):
    if code == 0xF:
        return 0
    return (44100 if code & 8 else 48000) << (code & 7)


def _truehd_channels(arrangement):
    # bit counts of the 13-bit arrangement (truehd_channels): each set
    # bit contributes its group size
    counts = [2, 1, 1, 2, 2, 1, 1, 1, 2, 1, 1, 1, 1]
    n = 0
    for i in range(13):
        if arrangement & (1 << i):
            n += counts[i]
    return n


# huffman codebooks (mlp.c ff_mlp_huffman_tables): (code, len) per
# symbol index; index maps linearly via sign_huff_offset
_HUFF = [
    [(0x01, 9), (0x01, 8), (0x01, 7), (0x01, 6), (0x01, 5), (0x01, 4),
     (0x01, 3), (0x04, 3), (0x05, 3), (0x06, 3), (0x07, 3), (0x03, 3),
     (0x05, 4), (0x09, 5), (0x11, 6), (0x21, 7), (0x41, 8), (0x81, 9)],
    [(0x01, 9), (0x01, 8), (0x01, 7), (0x01, 6), (0x01, 5), (0x01, 4),
     (0x01, 3), (0x02, 2), (0x03, 2), (0x03, 3), (0x05, 4), (0x09, 5),
     (0x11, 6), (0x21, 7), (0x41, 8), (0x81, 9)],
    [(0x01, 9), (0x01, 8), (0x01, 7), (0x01, 6), (0x01, 5), (0x01, 4),
     (0x01, 3), (0x01, 1), (0x03, 3), (0x05, 4), (0x09, 5), (0x11, 6),
     (0x21, 7), (0x41, 8), (0x81, 9)],
]


def _build_lut(entries):
    maxlen = max(l for _, l in entries)
    sym = np.full(1 << maxlen, -1, np.int32)
    ln = np.zeros(1 << maxlen, np.uint8)
    for i, (c, l) in enumerate(entries):
        lo = c << (maxlen - l)
        hi = lo + (1 << (maxlen - l))
        sym[lo:hi] = i
        ln[lo:hi] = l
    return sym, ln, maxlen


_HUFF_LUTS = [_build_lut(t) for t in _HUFF]


class _Filter:
    def __init__(self):
        self.order = 0
        self.shift = 0
        self.coeff = np.zeros(8, np.int64)
        self.state = np.zeros(8, np.int64)


class _ChParams:
    def __init__(self):
        self.fir = _Filter()
        self.iir = _Filter()
        self.huff_offset = 0
        self.sign_huff_offset = -(1 << 23)
        self.codebook = 0
        self.huff_lsbs = 24


class _SubStream:
    def __init__(self):
        self.restart_seen = False
        self.min_channel = 0
        self.max_channel = 0
        self.max_matrix_channel = 0
        self.noise_type = 0
        self.noise_shift = 0
        self.noisegen_seed = 0
        self.data_check_present = False
        self.param_presence_flags = 0xFF
        self.num_matrices = 0
        self.matrix_out_ch = [0] * MAX_MATRICES
        self.lsb_bypass = [0] * MAX_MATRICES
        self.matrix_coeff = np.zeros((MAX_MATRICES, MAX_CHANNELS),
                                     np.int64)
        self.matrix_noise_shift = [0] * MAX_MATRICES
        self.blocksize = 8
        self.blockpos = 0
        self.output_shift = np.zeros(MAX_CHANNELS, np.int32)
        self.quant_step_size = np.zeros(MAX_CHANNELS, np.int32)
        self.ch_assign = list(range(MAX_CHANNELS))
        self.cp = [_ChParams() for _ in range(MAX_CHANNELS)]
        self.end_of_stream = False


# presence flag bits (mlpdec.c PARAM_*)
P_PRESENCE, P_PRESENT = 0, 0
PARAM_BLOCKSIZE = 1 << 7
PARAM_MATRIX = 1 << 6
PARAM_OUTSHIFT = 1 << 5
PARAM_QUANTSTEP = 1 << 4
PARAM_FIR = 1 << 3
PARAM_IIR = 1 << 2
PARAM_HUFFOFFSET = 1 << 1
PARAM_PRESENCE = 1 << 0


def _sbits(b: BitReader, n: int) -> int:
    v = b.get(n)
    return v - (1 << n) if v >> (n - 1) else v


@register_decoder
class MlpDecoder(DeviceCodec):
    codec_id = "mlp"
    aliases = ("truehd",)
    codec_type = MediaType.AUDIO

    def __init__(self, par, options=None, *, device="cuda"):
        super().__init__(par, options, device=device)
        self.truehd = par.codec_id == "truehd"
        self.params_valid = False
        self.num_substreams = 0
        self.access_unit_size = 0
        self.access_unit_size_pow2 = 0
        self.sample_rate = 0
        self.group1_bits = 24
        self.channels = 0
        self.ss = [_SubStream() for _ in range(4)]
        self.samples = None        # (au_size, MAX_CHANNELS) int64
        self.bypassed = None       # (au_size, MAX_MATRICES) int64

    # ------------------------------------------------------------ sync
    def _read_major_sync(self, b: BitReader):
        if b.get(24) != 0xF8726F:
            raise InvalidData("mlp: bad major sync")
        stream_type = b.get(8)
        if stream_type == 0xBB:            # MLP
            self.group1_bits = _QUANTS[b.get(4)]
            b.get(4)                       # group2 bits
            ratebits = b.get(4)
            self.sample_rate = _mlp_samplerate(ratebits)
            b.get(4)                       # group2 rate
            b.skip(11)
            arr = b.get(5)
            if arr >= len(_MLP_CHANNELS):
                raise NotSupported("mlp: channel arrangement")
            self.channels = _MLP_CHANNELS[arr]
        elif stream_type == 0xBA:          # TrueHD
            self.group1_bits = 24
            ratebits = b.get(4)
            self.sample_rate = _mlp_samplerate(ratebits)
            b.skip(4)
            b.get(2)                       # modifier stream 0
            b.get(2)                       # modifier stream 1
            arr1 = b.get(5)
            b.get(2)                       # modifier stream 2
            arr2 = b.get(13)
            self.channels = _truehd_channels(arr2) or \
                _truehd_channels(arr1)
        else:
            raise InvalidData("mlp: unknown stream type")
        self.access_unit_size = 40 << (ratebits & 7)
        self.access_unit_size_pow2 = 64 << (ratebits & 7)
        b.skip(48)
        b.get(1)                           # is_vbr
        b.get(15)                          # peak bitrate
        self.num_substreams = b.get(4)
        b.skip(2)
        b.get(2)                           # extended_substream_info
        self.substream_info = b.get(8)
        self.params_valid = True

    @staticmethod
    def _major_sync_size(data: bytes) -> int:
        # mlp_parse.c mlp_get_major_sync_size: 28 bytes, +2 per
        # extension block when the extension flag nibble is set
        # 28 bytes for MLP; TrueHD adds 2 + 2*extensions when
        # buf[25] & 1 (mlp_get_major_sync_size)
        size = 28
        if len(data) >= 28 and data[:4] == b"\xf8\x72\x6f\xba" \
                and data[25] & 1:
            size += 2 + (data[26] >> 4) * 2
        return size

    # --------------------------------------------------------- restart
    def _read_restart(self, b: BitReader, s: _SubStream):
        if b.get(13) != 0x31EA >> 1:
            raise InvalidData("mlp: bad restart sync")
        s.noise_type = b.get(1)
        if not self.truehd and s.noise_type:
            raise InvalidData("mlp: bad noise type")
        b.skip(16)                         # output timestamp
        s.min_channel = b.get(4)
        s.max_channel = b.get(4)
        s.max_matrix_channel = b.get(4)
        lim = 5 if not self.truehd else 7
        if s.max_matrix_channel > lim or \
                s.max_channel + 1 < s.min_channel:
            raise InvalidData("mlp: bad channel range")
        s.noise_shift = b.get(4)
        s.noisegen_seed = b.get(23)
        b.skip(19)
        s.data_check_present = bool(b.get(1))
        b.get(8)                           # lossless check (warn only)
        b.skip(16)
        s.ch_assign = [0] * MAX_CHANNELS
        for ch in range(s.max_matrix_channel + 1):
            ca = b.get(6)
            if ca > s.max_matrix_channel:
                raise NotSupported("mlp: channel assignment")
            s.ch_assign[ca] = ch
        b.get(8)                           # restart header checksum
        s.param_presence_flags = 0xFF
        s.num_matrices = 0
        s.blocksize = 8
        s.output_shift[:] = 0
        s.quant_step_size[:] = 0
        for ch in range(s.min_channel, s.max_channel + 1):
            s.cp[ch] = _ChParams()
        s.restart_seen = True

    # ---------------------------------------------------------- params
    def _sign_huff(self, s: _SubStream, ch: int) -> int:
        cp = s.cp[ch]
        lsb_bits = cp.huff_lsbs - int(s.quant_step_size[ch])
        sign_shift = lsb_bits + (2 - cp.codebook if cp.codebook
                                 else -1)
        off = cp.huff_offset
        if cp.codebook > 0:
            off -= 7 << lsb_bits
        if sign_shift >= 0:
            off -= 1 << sign_shift
        return off

    def _read_filter(self, b: BitReader, s: _SubStream, ch: int,
                     which: int):
        fp = s.cp[ch].fir if which == FIR else s.cp[ch].iir
        max_order = 4 if which == IIR else 8
        order = b.get(4)
        if order > max_order:
            raise InvalidData("mlp: filter order")
        fp.order = order
        if order:
            fp.shift = b.get(4)
            coeff_bits = b.get(5)
            coeff_shift = b.get(3)
            if not 1 <= coeff_bits <= 16 or coeff_bits + coeff_shift > 16:
                raise InvalidData("mlp: filter coeff bits")
            for i in range(order):
                fp.coeff[i] = _sbits(b, coeff_bits) << coeff_shift
            if b.get(1):
                if which == FIR:
                    raise InvalidData("mlp: FIR state")
                state_bits = b.get(4)
                state_shift = b.get(4)
                for i in range(order):
                    fp.state[i] = (_sbits(b, state_bits) << state_shift
                                   ) if state_bits else 0

    def _read_matrix(self, b: BitReader, s: _SubStream):
        s.num_matrices = b.get(4)
        lim = 6 if not self.truehd else 8
        if s.num_matrices > lim:
            raise InvalidData("mlp: too many matrices")
        for mat in range(s.num_matrices):
            s.matrix_out_ch[mat] = b.get(4)
            frac_bits = b.get(4)
            s.lsb_bypass[mat] = b.get(1)
            if s.matrix_out_ch[mat] > s.max_matrix_channel or \
                    frac_bits > 14:
                raise InvalidData("mlp: matrix params")
            max_chan = s.max_matrix_channel
            if not s.noise_type:
                max_chan += 2
            for ch in range(max_chan + 1):
                coeff = 0
                if b.get(1):
                    coeff = _sbits(b, frac_bits + 2)
                s.matrix_coeff[mat][ch] = coeff << (14 - frac_bits)
            s.matrix_noise_shift[mat] = b.get(4) if s.noise_type else 0

    def _read_channel_params(self, b: BitReader, s: _SubStream,
                             ch: int):
        cp = s.cp[ch]
        if s.param_presence_flags & PARAM_FIR and b.get(1):
            self._read_filter(b, s, ch, FIR)
        if s.param_presence_flags & PARAM_IIR and b.get(1):
            self._read_filter(b, s, ch, IIR)
        if cp.fir.order + cp.iir.order > 8:
            raise InvalidData("mlp: filter orders")
        if cp.fir.order and cp.iir.order and \
                cp.fir.shift != cp.iir.shift:
            raise InvalidData("mlp: filter shifts")
        if not cp.fir.order and cp.iir.order:
            cp.fir.shift = cp.iir.shift
        if s.param_presence_flags & PARAM_HUFFOFFSET and b.get(1):
            cp.huff_offset = _sbits(b, 15)
        cp.codebook = b.get(2)
        cp.huff_lsbs = b.get(5)
        if cp.codebook > 0 and cp.huff_lsbs > 24:
            raise InvalidData("mlp: huff_lsbs")

    def _read_decoding_params(self, b: BitReader, s: _SubStream):
        recompute = 0
        if s.param_presence_flags & PARAM_PRESENCE and b.get(1):
            s.param_presence_flags = b.get(8)
        if s.param_presence_flags & PARAM_BLOCKSIZE and b.get(1):
            s.blocksize = b.get(9)
            if s.blocksize < 8 or s.blocksize > self.access_unit_size:
                raise InvalidData("mlp: blocksize")
        if s.param_presence_flags & PARAM_MATRIX and b.get(1):
            self._read_matrix(b, s)
        if s.param_presence_flags & PARAM_OUTSHIFT and b.get(1):
            for ch in range(s.max_matrix_channel + 1):
                s.output_shift[ch] = max(0, _sbits(b, 4))
        if s.param_presence_flags & PARAM_QUANTSTEP and b.get(1):
            for ch in range(s.max_channel + 1):
                s.quant_step_size[ch] = b.get(4)
                recompute |= 1 << ch
        for ch in range(s.min_channel, s.max_channel + 1):
            if b.get(1):
                recompute |= 1 << ch
                self._read_channel_params(b, s, ch)
        for ch in range(s.max_channel + 1):
            if recompute & (1 << ch):
                cp = s.cp[ch]
                if cp.codebook > 0 and \
                        cp.huff_lsbs < s.quant_step_size[ch]:
                    raise InvalidData("mlp: quant > huff_lsbs")
                cp.sign_huff_offset = self._sign_huff(s, ch)

    # ----------------------------------------------------------- block
    def _read_block(self, b: BitReader, s: _SubStream):
        if s.data_check_present:
            b.get(16)
        if s.blockpos + s.blocksize > self.access_unit_size:
            raise InvalidData("mlp: too many samples")
        bs = s.blocksize
        pos0 = s.blockpos
        self.bypassed[pos0:pos0 + bs, :] = 0
        for i in range(bs):
            for mat in range(s.num_matrices):
                if s.lsb_bypass[mat]:
                    self.bypassed[pos0 + i, mat] = b.get(1)
            for ch in range(s.min_channel, s.max_channel + 1):
                cp = s.cp[ch]
                lsb_bits = cp.huff_lsbs - int(s.quant_step_size[ch])
                result = 0
                if cp.codebook:
                    sym, ln, maxlen = _HUFF_LUTS[cp.codebook - 1]
                    look = b.peek(maxlen)
                    l = int(ln[look])
                    if l == 0:
                        raise InvalidData("mlp: bad huffman code")
                    b.skip(l)
                    result = int(sym[look])
                if lsb_bits > 0:
                    result = (result << lsb_bits) + b.get(lsb_bits)
                result += cp.sign_huff_offset
                result <<= int(s.quant_step_size[ch])
                self.samples[pos0 + i, ch] = result
        for ch in range(s.min_channel, s.max_channel + 1):
            self._filter_channel(s, ch, pos0, bs)
        s.blockpos += bs

    @staticmethod
    def _wrap32(x: int) -> int:
        return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)

    def _filter_channel(self, s: _SubStream, ch: int, pos0: int,
                        bs: int):
        # lossless prediction (mlpdsp.c mlp_filter_channel): result =
        # int32(accum>>shift + residual) & MSB_MASK(quant); the IIR
        # state stores result - accum
        cp = s.cp[ch]
        firo, iiro = cp.fir.order, cp.iir.order
        shift = cp.fir.shift
        mask = -(1 << int(s.quant_step_size[ch]))
        fir_state = cp.fir.state
        iir_state = cp.iir.state
        fc = [int(c) for c in cp.fir.coeff[:firo]]
        ic = [int(c) for c in cp.iir.coeff[:iiro]]
        buf = self.samples
        w32 = self._wrap32
        for i in range(bs):
            residual = int(buf[pos0 + i, ch])
            accum = 0
            for o in range(firo):
                accum += int(fir_state[o]) * fc[o]
            for o in range(iiro):
                accum += int(iir_state[o]) * ic[o]
            accum >>= shift
            result = w32(w32(accum + residual) & mask)
            fir_state[1:] = fir_state[:-1]
            fir_state[0] = result
            iir_state[1:] = iir_state[:-1]
            iir_state[0] = w32(result - accum)
            buf[pos0 + i, ch] = result

    # ----------------------------------------------------------- noise
    def _noise_2ch(self, s: _SubStream):
        # mlpdec.c generate_2_noise_channels (u32 LFSR)
        seed = s.noisegen_seed & 0xFFFFFFFF
        mc = s.max_matrix_channel

        def s8(x):
            return ((x & 0xFF) ^ 0x80) - 0x80

        for i in range(s.blockpos):
            shr7 = (seed >> 7) & 0xFFFF
            self.samples[i, mc + 1] = s8(seed >> 15) << s.noise_shift
            self.samples[i, mc + 2] = s8(shr7) << s.noise_shift
            seed = ((seed << 16) ^ shr7 ^ (shr7 << 5)) & 0xFFFFFFFF
        s.noisegen_seed = seed

    def _noise_buffer(self, s: _SubStream):
        # TrueHD 0x31eb noise (mlpdec.c fill_noise_buffer)
        _NOISE = _NOISE_TABLE
        seed = s.noisegen_seed & 0xFFFFFFFF
        out = np.zeros(self.access_unit_size_pow2, np.int64)
        for i in range(self.access_unit_size_pow2):
            shr15 = (seed >> 15) & 0xFF
            out[i] = _NOISE[shr15]
            seed = ((seed << 8) ^ shr15 ^ (shr15 << 5)) & 0xFFFFFFFF
        s.noisegen_seed = seed
        return out

    # ----------------------------------------------------------- output
    def _output(self, s: _SubStream, pkt) -> Frame:
        maxchan = s.max_matrix_channel
        noise = None
        if not s.noise_type:
            self._noise_2ch(s)
            maxchan += 2
        else:
            noise = self._noise_buffer(s)
        for mat in range(s.num_matrices):
            dest = s.matrix_out_ch[mat]
            coeffs = s.matrix_coeff[mat][:maxchan + 1]
            qmask = -(1 << int(s.quant_step_size[dest]))
            nshift = s.matrix_noise_shift[mat]
            index = s.num_matrices - mat
            index2 = 2 * index + 1
            bp = s.blockpos
            acc = (self.samples[:bp, :maxchan + 1]
                   * coeffs[None, :]).sum(axis=1)      # int64 exact
            if nshift:
                idxs = (index + index2 * np.arange(bp)) \
                    & (self.access_unit_size_pow2 - 1)
                acc = acc + (noise[idxs] << (nshift + 7))
            w32 = self._wrap32
            qm = int(qmask)
            self.samples[:bp, dest] = [
                w32(w32(int(a) >> 14) & qm) + int(bypv)
                for a, bypv in zip(acc, self.bypassed[:bp, mat])]
        # pack (ff_mlp_pack_output)
        nch = s.max_matrix_channel + 1
        out = np.zeros((nch, s.blockpos), np.int64)
        for out_ch in range(nch):
            mat_ch = s.ch_assign[out_ch]
            sample = self.samples[:s.blockpos, mat_ch] \
                << int(s.output_shift[mat_ch])
            out[out_ch] = ((sample + (1 << 31)) & 0xFFFFFFFF) \
                - (1 << 31)
        is32 = self.group1_bits > 16
        if is32:
            planes = [(((out[c] << 8) + (1 << 31)) % (1 << 32)
                       - (1 << 31)).astype(np.int32)
                      for c in range(nch)]
            fmt = "s32p"
        else:
            planes = [(out[c] >> 8).astype(np.int16)
                      for c in range(nch)]
            fmt = "s16p"
        from ..formats.channel_layout import default_layout
        f = Frame.audio(np.stack(planes), self.sample_rate, fmt,
                        default_layout(nch),
                        pts=pkt.pts if pkt else 0,
                        time_base=pkt.time_base if pkt else None)
        f.duration = s.blockpos
        return f

    # ------------------------------------------------------------- AU
    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        buf = bytes(pkt.data)
        if len(buf) < 4:
            raise InvalidData("mlp: short packet")
        length = (int.from_bytes(buf[:2], "big") & 0xFFF) * 2
        if length < 4 or length > len(buf):
            raise InvalidData("mlp: bad AU length")
        b = BitReader(buf[4:length])
        header_size = 4
        if b.peek(31) == 0xF8726FBA >> 1:
            ms_size = self._major_sync_size(buf[4:length])
            self._read_major_sync(b)
            b.pos = ms_size * 8
            header_size += ms_size
        if not self.params_valid:
            self.warning("mlp: no stream parameters yet; skipping")
            return []
        if self.samples is None or \
                len(self.samples) != self.access_unit_size:
            self.samples = np.zeros(
                (self.access_unit_size, MAX_CHANNELS), np.int64)
            self.bypassed = np.zeros(
                (self.access_unit_size, MAX_MATRICES), np.int64)

        sub_len = []
        substream_start = 0
        hdr2 = 0
        for _sub in range(self.num_substreams):
            extraword = b.get(1)
            b.get(1)                       # nonrestart_substr
            b.get(1)                       # checkdata_present
            b.get(1)
            end = b.get(12) * 2
            hdr2 += 2
            if extraword:
                if not self.truehd:
                    raise InvalidData("mlp: extraword in MLP")
                b.skip(16)
                hdr2 += 2
            end = min(end, length - header_size - hdr2)
            if end < substream_start:
                raise InvalidData("mlp: bad substream directory")
            sub_len.append(end - substream_start)
            substream_start = end

        data_off = header_size + hdr2
        for sub in range(self.num_substreams):
            s = self.ss[sub]
            sb = BitReader(buf[data_off:data_off + sub_len[sub]])
            s.blockpos = 0
            while True:
                if sb.get(1):
                    if sb.get(1):
                        self._read_restart(sb, s)
                    if not s.restart_seen:
                        break
                    self._read_decoding_params(sb, s)
                if not s.restart_seen:
                    break
                self._read_block(sb, s)
                if sb.pos >= sub_len[sub] * 8:
                    raise InvalidData("mlp: substream overrun")
                if sb.get(1):
                    break
            if s.restart_seen:
                sb.skip((-sb.pos) & 15)
                if sub_len[sub] * 8 - sb.pos >= 32:
                    if sb.get(16) != 0xD234:
                        raise InvalidData("mlp: bad end sync")
                    shorten = sb.get(16)
                    if self.truehd and shorten & 0x2000:
                        s.blockpos -= min(shorten & 0x1FFF, s.blockpos)
                    elif not self.truehd and shorten != 0xD234:
                        raise InvalidData("mlp: bad end marker")
                    s.end_of_stream = True
            data_off += sub_len[sub]

        last = self.num_substreams - 1
        if not self.ss[last].restart_seen:
            return []
        f = self._output(self.ss[last], pkt)
        for sub in range(self.num_substreams):
            if self.ss[sub].end_of_stream:
                self.ss[sub].end_of_stream = False
                self.params_valid = False
        return [f]


# TrueHD noise table (mlpdec.c noise_table)
_NOISE_TABLE = np.array([
    30, 51, 22, 54, 3, 7, -4, 38, 14, 55, 46, 81, 22, 58, -3, 2,
    52, 31, -7, 51, 15, 44, 74, 30, 85, -17, 10, 33, 18, 80, 28, 62,
    10, 32, 23, 69, 72, 26, 35, 17, 73, 60, 8, 56, 2, 6, -2, -5,
    51, 4, 11, 50, 66, 76, 21, 44, 33, 47, 1, 26, 64, 48, 57, 40,
    38, 16, -10, -28, 92, 22, -18, 29, -10, 5, -13, 49, 19, 24, 70, 34,
    61, 48, 30, 14, -6, 25, 58, 33, 42, 60, 67, 17, 54, 17, 22, 30,
    67, 44, -9, 50, -11, 43, 40, 32, 59, 82, 13, 49, -14, 55, 60, 36,
    48, 49, 31, 47, 15, 12, 4, 65, 1, 23, 29, 39, 45, -2, 84, 69,
    0, 72, 37, 57, 27, 41, -15, -16, 35, 31, 14, 61, 24, 0, 27, 24,
    16, 41, 55, 34, 53, 9, 56, 12, 25, 29, 53, 5, 20, -20, -8, 20,
    13, 28, -3, 78, 38, 16, 11, 62, 46, 29, 21, 24, 46, 65, 43, -23,
    89, 18, 74, 21, 38, -12, 19, 12, -19, 8, 15, 33, 4, 57, 9, -8,
    36, 35, 26, 28, 7, 83, 63, 79, 75, 11, 3, 87, 37, 47, 34, 40,
    39, 19, 20, 42, 27, 34, 39, 77, 13, 42, 59, 64, 45, -1, 32, 37,
    45, -5, 53, -6, 7, 36, 50, 23, 6, 32, 9, -21, 18, 71, 27, 52,
    -25, 31, 35, 42, -1, 68, 63, 52, 26, 43, 66, 37, 41, 25, 40, 70],
    np.int64)
