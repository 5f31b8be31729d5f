"""IMA WAV + Microsoft ADPCM decode/encode (reference:
libavcodec/adpcm.c:1521/1634, adpcmenc.c:216/285).

Block-based 4-bit speech/audio coding over int16 PCM. Decode is
bit-exact and our encodes are byte-identical to the reference's
(non-trellis path) given the same input and block size.

The port's copy of ffmpeg_tpu/codecs/adpcm.py, held equal to it by
tests/test_torch_host_codecs.py.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.frame import Frame
from ..core.packet import Packet, PKT_FLAG_KEY
from ..io.stream import MediaType
from ..utils.error import InvalidData, NotSupported
from ..utils.rational import Rational
from . import adpcm_tables as A
from .codec import DeviceCodec, register_decoder, register_encoder


def _clip16(v):
    return max(-32768, min(32767, v))


class _ImaState:
    __slots__ = ("predictor", "step_index", "prev_sample")

    def __init__(self):
        self.predictor = 0
        self.step_index = 0
        self.prev_sample = 0

    def expand(self, nibble):
        """ff_adpcm_ima_qt_expand_nibble (adpcm.c:557)."""
        step = A.STEP_TABLE[self.step_index]
        idx = self.step_index + A.INDEX_TABLE[nibble]
        self.step_index = max(0, min(88, idx))
        diff = step >> 3
        if nibble & 4:
            diff += step
        if nibble & 2:
            diff += step >> 1
        if nibble & 1:
            diff += step >> 2
        if nibble & 8:
            self.predictor = _clip16(self.predictor - diff)
        else:
            self.predictor = _clip16(self.predictor + diff)
        return self.predictor

    def compress(self, sample):
        """adpcm_ima_compress_sample (adpcmenc.c:216)."""
        delta = sample - self.prev_sample
        step = A.STEP_TABLE[self.step_index]
        nibble = min(7, abs(delta) * 4 // step) + (8 if delta < 0
                                                   else 0)
        d = step * A.YAMAHA_DIFFLOOKUP[nibble]
        # C division truncates toward zero
        self.prev_sample = _clip16(
            self.prev_sample + (abs(d) // 8) * (1 if d >= 0 else -1))
        self.step_index = max(0, min(88, self.step_index +
                                     A.INDEX_TABLE[nibble]))
        return nibble


class _MsState:
    __slots__ = ("coeff1", "coeff2", "idelta", "sample1", "sample2")

    def __init__(self):
        self.coeff1 = self.coeff2 = 0
        self.idelta = 0
        self.sample1 = self.sample2 = 0

    def expand(self, nibble):
        """adpcm_ms_expand_nibble (adpcm.c:663); / 64 is C-truncating."""
        p = self.sample1 * self.coeff1 + self.sample2 * self.coeff2
        predictor = abs(p) // 64 * (1 if p >= 0 else -1)
        predictor += (nibble - 0x10 if nibble & 8 else nibble) * \
            self.idelta
        self.sample2 = self.sample1
        self.sample1 = _clip16(predictor)
        self.idelta = (A.ADAPTATION_TABLE[nibble] * self.idelta) >> 8
        if self.idelta < 16:
            self.idelta = 16
        return self.sample1

    def compress(self, sample):
        """adpcm_ms_compress_sample (adpcmenc.c:285)."""
        p = self.sample1 * self.coeff1 + self.sample2 * self.coeff2
        predictor = abs(p) // 64 * (1 if p >= 0 else -1)
        nib = sample - predictor
        bias = self.idelta // 2 if nib >= 0 else -(self.idelta // 2)
        nib = nib + bias
        nib = abs(nib) // self.idelta * (1 if nib >= 0 else -1)
        nib = max(-8, min(7, nib)) & 0x0F
        predictor += (nib - 0x10 if nib & 8 else nib) * self.idelta
        self.sample2 = self.sample1
        self.sample1 = _clip16(predictor)
        self.idelta = (A.ADAPTATION_TABLE[nib] * self.idelta) >> 8
        if self.idelta < 16:
            self.idelta = 16
        return nib


@register_decoder
class AdpcmImaWavDecoder(DeviceCodec):
    codec_id = "adpcm_ima_wav"
    codec_type = MediaType.AUDIO

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        par = self.par
        ch = par.channels
        ba = par.block_align
        if (par.bits_per_coded_sample or 4) != 4:
            raise NotSupported("adpcm_ima_wav: only 4-bit")
        if ba < 4 * ch:
            raise InvalidData("adpcm_ima_wav: bad block align")
        data = bytes(pkt.data)
        spb = (ba - 4 * ch) // ch * 2 + 1
        nblocks = len(data) // ba
        out = np.zeros((ch, nblocks * spb), np.int16)
        for n in range(nblocks):
            blk = data[n * ba:(n + 1) * ba]
            states = []
            for i in range(ch):
                st = _ImaState()
                st.predictor = int.from_bytes(
                    blk[4 * i:4 * i + 2], "little", signed=True)
                st.step_index = blk[4 * i + 2]
                if st.step_index > 88:
                    raise InvalidData("adpcm_ima_wav: step index")
                out[i, n * spb] = st.predictor
                states.append(st)
            pos = 4 * ch
            for g in range((spb - 1) // 8):
                for i in range(ch):
                    st = states[i]
                    base = n * spb + 1 + g * 8
                    for m in range(4):
                        v = blk[pos]
                        pos += 1
                        out[i, base + 2 * m] = st.expand(v & 0x0F)
                        out[i, base + 2 * m + 1] = st.expand(v >> 4)
        return [self._frame(out, pkt)]

    def _frame(self, out, pkt):
        from ..formats.channel_layout import default_layout
        fr = Frame.audio(out, self.par.sample_rate, "s16p",
                         default_layout(out.shape[0]), pts=pkt.pts,
                         time_base=pkt.time_base or
                         Rational(1, self.par.sample_rate))
        fr.duration = out.shape[1]
        return fr


@register_decoder
class AdpcmMsDecoder(AdpcmImaWavDecoder):
    codec_id = "adpcm_ms"

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        par = self.par
        ch = par.channels
        if ch > 2:
            raise NotSupported("adpcm_ms: >2 channels")
        ba = par.block_align
        if ba < 7 * ch:
            raise InvalidData("adpcm_ms: bad block align")
        data = bytes(pkt.data)
        spb = (ba - 7 * ch) * 2 // ch + 2
        nblocks = len(data) // ba
        out = np.zeros((ch, nblocks * spb), np.int16)
        st = 1 if ch == 2 else 0
        for n in range(nblocks):
            blk = data[n * ba:(n + 1) * ba]
            states = [_MsState() for _ in range(ch)]
            pos = 0
            for i in range(ch):
                bp = blk[pos]
                pos += 1
                if bp > 6:
                    raise InvalidData("adpcm_ms: block predictor")
                states[i].coeff1 = A.ADAPT_COEFF1[bp]
                states[i].coeff2 = A.ADAPT_COEFF2[bp]
            for i in range(ch):
                states[i].idelta = int.from_bytes(
                    blk[pos:pos + 2], "little", signed=True)
                pos += 2
            for i in range(ch):
                states[i].sample1 = int.from_bytes(
                    blk[pos:pos + 2], "little", signed=True)
                pos += 2
            for i in range(ch):
                states[i].sample2 = int.from_bytes(
                    blk[pos:pos + 2], "little", signed=True)
                pos += 2
            for i in range(ch):
                out[i, n * spb] = states[i].sample2
                out[i, n * spb + 1] = states[i].sample1
            idx = n * spb + 2
            for _ in range(ba - 7 * ch):
                byte = blk[pos]
                pos += 1
                if ch == 1:
                    out[0, idx] = states[0].expand(byte >> 4)
                    out[0, idx + 1] = states[0].expand(byte & 0x0F)
                    idx += 2
                else:
                    out[0, idx] = states[0].expand(byte >> 4)
                    out[1, idx] = states[1].expand(byte & 0x0F)
                    idx += 1
        return [self._frame(out, pkt)]


class _AdpcmEncoderBase(DeviceCodec):
    codec_type = MediaType.AUDIO
    is_encoder = True

    def __init__(self, par, options=None, *, device="cuda"):
        super().__init__(par, options, device=device)
        self.block_size = int((options or {}).get("block_size", 1024))
        self._buf = None            # (ch, n) int16 carry
        self._pts = None

    def _gather(self, frame):
        ch = self.par.channels
        if frame is not None:
            pcm = np.stack([np.asarray(p) for p in frame.planes])
            if pcm.dtype != np.int16:
                raise NotSupported("adpcm enc: s16 input only")
            if self._pts is None:
                self._pts = frame.pts if frame.pts is not None else 0
            self._buf = pcm if self._buf is None else \
                np.concatenate([self._buf, pcm], axis=1)
        return self._buf if self._buf is not None else \
            np.zeros((ch, 0), np.int16)


@register_encoder
class AdpcmImaWavEncoder(_AdpcmEncoderBase):
    codec_id = "adpcm_ima_wav"

    def __init__(self, par, options=None, *, device="cuda"):
        super().__init__(par, options, device=device)
        ch = max(par.channels, 1)
        par.block_align = self.block_size
        par.bits_per_coded_sample = 4
        par.frame_size = (self.block_size - 4 * ch) * 8 // (4 * ch) + 1
        self._states = [_ImaState() for _ in range(ch)]

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        buf = self._gather(frame)
        ch = self.par.channels
        spb = self.par.frame_size
        pkts = []
        while buf.shape[1] >= spb or (frame is None and buf.shape[1]):
            blk = buf[:, :spb]
            if blk.shape[1] < spb:      # final short block: pad
                pad = np.repeat(blk[:, -1:], spb - blk.shape[1], 1)
                blk = np.concatenate([blk, pad], 1)
            buf = buf[:, spb:]
            pkts.append(self._encode_block(blk))
        self._buf = buf
        return pkts

    def _encode_block(self, blk):
        ch = self.par.channels
        out = bytearray()
        for i in range(ch):
            st = self._states[i]
            st.prev_sample = int(blk[i, 0])
            out += int(st.prev_sample).to_bytes(2, "little",
                                                signed=True)
            out.append(st.step_index)
            out.append(0)
        blocks = (blk.shape[1] - 1) // 8
        for g in range(blocks):
            for i in range(ch):
                st = self._states[i]
                for j in range(0, 8, 2):
                    s0 = int(blk[i, 1 + g * 8 + j])
                    s1 = int(blk[i, 1 + g * 8 + j + 1])
                    v = st.compress(s0)
                    v |= st.compress(s1) << 4
                    out.append(v)
        pts = self._pts
        dur = blk.shape[1]
        self._pts = pts + dur
        return Packet(data=bytes(out), pts=pts, dts=pts, duration=dur,
                      flags=PKT_FLAG_KEY,
                      time_base=Rational(1, self.par.sample_rate))


@register_encoder
class AdpcmMsEncoder(_AdpcmEncoderBase):
    codec_id = "adpcm_ms"

    def __init__(self, par, options=None, *, device="cuda"):
        super().__init__(par, options, device=device)
        ch = max(par.channels, 1)
        if ch > 2:
            raise NotSupported("adpcm_ms enc: mono/stereo only")
        par.block_align = self.block_size
        par.bits_per_coded_sample = 4
        par.frame_size = (self.block_size - 7 * ch) * 2 // ch + 2
        self._states = [_MsState() for _ in range(ch)]
        # wav extradata: wSamplesPerBlock, wNumCoef, 7 coeff pairs
        ed = bytearray()
        ed += par.frame_size.to_bytes(2, "little")
        ed += (7).to_bytes(2, "little")
        for i in range(7):
            ed += (A.ADAPT_COEFF1[i] * 4).to_bytes(2, "little",
                                                   signed=True)
            ed += (A.ADAPT_COEFF2[i] * 4).to_bytes(2, "little",
                                                   signed=True)
        par.extradata = bytes(ed)

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        buf = self._gather(frame)
        spb = self.par.frame_size
        pkts = []
        while buf.shape[1] >= spb or (frame is None and buf.shape[1]):
            blk = buf[:, :spb]
            if blk.shape[1] < spb:
                pad = np.repeat(blk[:, -1:], spb - blk.shape[1], 1)
                blk = np.concatenate([blk, pad], 1)
            buf = buf[:, spb:]
            pkts.append(self._encode_block(blk))
        self._buf = buf
        return pkts

    def _encode_block(self, blk):
        ch = self.par.channels
        st = 1 if ch == 2 else 0
        states = self._states
        out = bytearray()
        for i in range(ch):
            out.append(0)               # block predictor 0
            states[i].coeff1 = A.ADAPT_COEFF1[0]
            states[i].coeff2 = A.ADAPT_COEFF2[0]
        for i in range(ch):
            if states[i].idelta < 16:
                states[i].idelta = 16
            out += int(states[i].idelta).to_bytes(2, "little",
                                                  signed=True)
        for i in range(ch):
            states[i].sample2 = int(blk[i, 0])
        for i in range(ch):
            states[i].sample1 = int(blk[i, 1])
            out += int(states[i].sample1).to_bytes(2, "little",
                                                   signed=True)
        for i in range(ch):
            out += int(states[i].sample2).to_bytes(2, "little",
                                                   signed=True)
        # interleaved sample stream from index 2
        flat = blk[:, 2:].T.reshape(-1)
        pos = 0
        for _ in range(self.par.block_align - 7 * ch):
            n0 = states[0].compress(int(flat[pos]))
            n1 = states[st].compress(int(flat[pos + 1]))
            out.append((n0 << 4) | n1)
            pos += 2
        pts = self._pts
        dur = blk.shape[1]
        self._pts = pts + dur
        return Packet(data=bytes(out), pts=pts, dts=pts, duration=dur,
                      flags=PKT_FLAG_KEY,
                      time_base=Rational(1, self.par.sample_rate))
