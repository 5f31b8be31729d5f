"""FLAC decoder (reference: libavcodec/flacdec.c).

Host-only lossless codec: frame header + subframe parse, Rice residual
decode, fixed/LPC prediction reconstruction (integer-exact), inter-channel
decorrelation. Bit-exact against the reference by construction.

The port's copy of ffmpeg_tpu/codecs/flac.py, held equal to it by
tests/test_torch_host_codecs.py.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.frame import Frame
from ..core.packet import Packet
from ..formats.channel_layout import default_layout
from ..io.stream import MediaType
from ..utils.error import InvalidData, NotSupported
from .bitstream import BitReader
from .codec import DeviceCodec, register_decoder

_BLOCKSIZES = [0, 192, 576, 1152, 2304, 4608, 0, 0,
               256, 512, 1024, 2048, 4096, 8192, 16384, 32768]
_RATES = [0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
          32000, 44100, 48000, 96000, 0, 0, 0, 0]
_BPS = [0, 8, 12, 0, 16, 20, 24, 32]


def _read_utf8(br: BitReader) -> int:
    b = br.get(8)
    if b < 0x80:
        return b
    n = 0
    while b & (0x80 >> n):
        n += 1
    v = b & (0x7F >> n)
    for _ in range(n - 1):
        v = (v << 6) | (br.get(8) & 0x3F)
    return v


def _decode_residual(br: BitReader, blocksize: int, order: int) -> np.ndarray:
    method = br.get(2)
    if method > 1:
        raise InvalidData("flac: bad residual method")
    kbits = 4 + method
    escape = (1 << kbits) - 1
    porder = br.get(4)
    nparts = 1 << porder
    res = np.zeros(blocksize - order, np.int64)
    idx = 0
    psize = blocksize >> porder
    for p in range(nparts):
        n = psize - (order if p == 0 else 0)
        k = br.get(kbits)
        if k == escape:
            nb = br.get(5)
            for i in range(n):
                res[idx + i] = br.get_signed(nb) if nb else 0
        else:
            for i in range(n):
                res[idx + i] = br.rice(k)
        idx += n
    return res


def _predict_fixed(warm: np.ndarray, res: np.ndarray, order: int) -> np.ndarray:
    out = np.empty(len(warm) + len(res), np.int64)
    out[:order] = warm
    coefs = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}[order]
    o = order
    for i, r in enumerate(res):
        acc = r
        for j, c in enumerate(coefs):
            acc += c * out[o + i - 1 - j]
        out[o + i] = acc
    return out


def _predict_lpc(warm: np.ndarray, res: np.ndarray, coefs: List[int],
                 shift: int) -> np.ndarray:
    order = len(warm)
    out = np.empty(order + len(res), np.int64)
    out[:order] = warm
    c = np.array(coefs, np.int64)
    for i, r in enumerate(res):
        pred = int(np.dot(c, out[i + order - 1::-1][:order])) >> shift
        out[order + i] = r + pred
    return out


@register_decoder
class FlacDecoder(DeviceCodec):
    codec_id = "flac"
    codec_type = MediaType.AUDIO

    def __init__(self, par, options=None, *, device="cuda"):
        super().__init__(par, options, device=device)
        self._stream_bps = 16
        self._stream_rate = par.sample_rate
        self._channels = par.channels or 2
        if par.extradata and len(par.extradata) >= 34:
            si = par.extradata
            # STREAMINFO (possibly with 'fLaC' + block header prefix)
            if si[:4] == b"fLaC":
                si = si[8:]
            elif len(si) > 34:
                si = si[-34:]
            br = BitReader(si)
            br.skip(16 + 16 + 24 + 24)
            self._stream_rate = br.get(20)
            self._channels = br.get(3) + 1
            self._stream_bps = br.get(5) + 1

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        br = BitReader(pkt.data)
        sync = br.get(14)
        if sync != 0x3FFE:
            raise InvalidData("flac: bad sync")
        br.skip(1)
        br.skip(1)  # blocking strategy
        bs_code = br.get(4)
        sr_code = br.get(4)
        ch_code = br.get(4)
        bps_code = br.get(3)
        br.skip(1)
        _read_utf8(br)
        if bs_code == 6:
            blocksize = br.get(8) + 1
        elif bs_code == 7:
            blocksize = br.get(16) + 1
        else:
            blocksize = _BLOCKSIZES[bs_code]
        if sr_code == 12:
            br.get(8)
        elif sr_code in (13, 14):
            br.get(16)
        rate = _RATES[sr_code] if sr_code < 12 else self._stream_rate
        rate = rate or self._stream_rate
        bps = _BPS[bps_code] or self._stream_bps
        br.skip(8)  # header CRC

        if ch_code < 8:
            nch = ch_code + 1
            mode = "indep"
        else:
            nch = 2
            mode = {8: "left_side", 9: "right_side", 10: "mid_side"}.get(ch_code)
            if mode is None:
                raise InvalidData("flac: bad channel mode")

        chans = []
        for c in range(nch):
            ch_bps = bps
            if (mode == "left_side" and c == 1) or \
               (mode == "right_side" and c == 0) or \
               (mode == "mid_side" and c == 1):
                ch_bps += 1
            chans.append(self._subframe(br, blocksize, ch_bps))

        if mode == "left_side":
            left, side = chans
            chans = [left, left - side]
        elif mode == "right_side":
            side, right = chans
            chans = [side + right, right]
        elif mode == "mid_side":
            mid, side = chans
            m2 = (mid << 1) | (side & 1)
            chans = [(m2 + side) >> 1, (m2 - side) >> 1]

        x = np.stack(chans)
        if bps <= 16:
            data = np.clip(x, -(1 << 15), (1 << 15) - 1).astype(np.int16)
            fmt = "s16"
        else:
            data = (x << (32 - bps)).astype(np.int32)
            fmt = "s32"
        f = Frame.audio(data, rate, fmt,
                        self.par.ch_layout or default_layout(nch),
                        pts=pkt.pts, time_base=pkt.time_base)
        return [f]

    def _subframe(self, br: BitReader, blocksize: int, bps: int) -> np.ndarray:
        if br.get(1):
            raise InvalidData("flac: bad subframe padding")
        stype = br.get(6)
        wasted = 0
        if br.get(1):
            wasted = 1 + br.unary()
            bps -= wasted
        if stype == 0:        # constant
            v = br.get_signed(bps)
            out = np.full(blocksize, v, np.int64)
        elif stype == 1:      # verbatim
            out = np.array([br.get_signed(bps) for _ in range(blocksize)],
                           np.int64)
        elif 8 <= stype <= 12:  # fixed, order = stype - 8
            order = stype - 8
            warm = np.array([br.get_signed(bps) for _ in range(order)], np.int64)
            res = _decode_residual(br, blocksize, order)
            out = _predict_fixed(warm, res, order)
        elif stype >= 32:     # LPC, order = (stype & 31) + 1
            order = (stype & 31) + 1
            warm = np.array([br.get_signed(bps) for _ in range(order)], np.int64)
            prec = br.get(4) + 1
            if prec == 16:
                raise InvalidData("flac: bad lpc precision")
            shift = br.get_signed(5)
            coefs = [br.get_signed(prec) for _ in range(order)]
            res = _decode_residual(br, blocksize, order)
            out = _predict_lpc(warm, res, coefs, shift)
        else:
            raise InvalidData(f"flac: bad subframe type {stype}")
        if wasted:
            out = out << wasted
        return out
