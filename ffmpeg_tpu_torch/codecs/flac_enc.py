"""FLAC encoder (reference: libavcodec/flacenc.c).

Lossless: fixed predictors (orders 0-4, chosen per subframe by residual
magnitude) + Rice-coded residuals, independent channels, fixed block
size. The residual analysis (order selection over the whole block) is
vectorized; bit packing is host-serial like the reference.

The port's copy of ffmpeg_tpu/codecs/flac_enc.py, held equal to it by
tests/test_torch_host_codecs.py.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np

from ..core.frame import Frame
from ..core.packet import PKT_FLAG_KEY, Packet
from ..formats import samplefmt as _sf
from ..io.stream import MediaType
from ..utils.error import NotSupported
from .codec import DeviceCodec, register_encoder

_CRC8_POLY = 0x07
_CRC16_POLY = 0x8005


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ _CRC8_POLY) & 0xFF if crc & 0x80 \
                else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ _CRC16_POLY) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


class _BW:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, v: int, n: int):
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.buf.append((self.acc >> (self.n - 8)) & 0xFF)
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def align(self):
        if self.n:
            self.put(0, 8 - self.n)

    def utf8(self, v: int):
        if v < 0x80:
            self.put(v, 8)
            return
        bs = []
        while v > 0:
            bs.append(v & 0x3F)
            v >>= 6
        nb = len(bs)
        while nb > 1 and bs[-1] >= (1 << (7 - nb)):
            bs.append(0)
            nb += 1
        lead = (0xFF << (8 - nb - 1)) & 0xFF
        self.put(lead | bs[-1], 8)
        for b in reversed(bs[:-1]):
            self.put(0x80 | b, 8)


def _rice_k(res: np.ndarray) -> int:
    """Rice parameter minimizing the estimated size."""
    u = (np.abs(res.astype(np.int64)) * 2).sum()
    n = max(1, len(res))
    k = 0
    while (n << (k + 1)) < u and k < 14:
        k += 1
    return k


def _write_rice(bw: _BW, res: np.ndarray, k: int):
    for v in res.astype(np.int64):
        u = int((v << 1) ^ (v >> 63))       # zigzag
        q = u >> k
        bw.put(0, q)
        bw.put(1, 1)
        if k:
            bw.put(u & ((1 << k) - 1), k)


@register_encoder
class FlacEncoder(DeviceCodec):
    codec_id = "flac"
    codec_type = MediaType.AUDIO
    is_encoder = True

    BLOCK = 4096

    def __init__(self, par, options=None, *, device="cuda"):
        super().__init__(par, options, device=device)
        self._buf: Optional[np.ndarray] = None
        self._frame_idx = 0
        self._md5 = hashlib.md5()
        self._total = 0
        self._header_sent = False
        self._sr = 0
        self._nch = 0

    # ------------------------------------------------------------------
    def _streaminfo(self) -> bytes:
        bw = _BW()
        bw.put(self.BLOCK, 16)
        bw.put(self.BLOCK, 16)
        bw.put(0, 24)
        bw.put(0, 24)
        bw.put(self._sr, 20)
        bw.put(self._nch - 1, 3)
        bw.put(16 - 1, 5)
        bw.put(0, 36)               # total samples unknown (streaming)
        return bytes(bw.buf) + b"\x00" * 16   # md5 filled by muxer? zeros

    def _header(self) -> bytes:
        si = self._streaminfo()
        return (b"fLaC" + bytes([0x80]) + len(si).to_bytes(3, "big")
                + si)

    def _encode_block(self, x: np.ndarray) -> bytes:
        """x: (nch, n) int16."""
        n = x.shape[1]
        bw = _BW()
        bw.put(0b11111111111110, 14)
        bw.put(0, 1)                 # reserved
        bw.put(0, 1)                 # fixed blocksize stream
        if n == 4096:
            bs_code, bs_tail = 12, None
        elif n == 576:
            bs_code, bs_tail = 2, None
        elif n <= 256:
            bs_code, bs_tail = 6, n - 1      # 8-bit tail
        else:
            bs_code, bs_tail = 7, n - 1      # 16-bit tail
        bw.put(bs_code, 4)
        sr_code = {44100: 9, 48000: 10, 32000: 8, 96000: 11,
                   22050: 6, 24000: 7, 16000: 5, 8000: 4}.get(self._sr, 0)
        bw.put(sr_code, 4)
        bw.put(self._nch - 1, 4)     # independent channels
        bw.put(4, 3)                 # 16 bps
        bw.put(0, 1)
        bw.utf8(self._frame_idx)
        if bs_tail is not None:
            bw.put(bs_tail, 8 if bs_code == 6 else 16)
        bw.align()
        hdr = bytes(bw.buf)
        bw.buf = bytearray(hdr)
        bw.put(_crc8(hdr), 8)

        for ch in range(self._nch):
            s = x[ch].astype(np.int64)
            # pick the fixed predictor order with the smallest |residual|
            best, best_res = 0, s
            cur = s
            cost = np.abs(s).sum()
            for order in range(1, 5):
                cur = np.diff(cur)
                if len(s) <= order:
                    break
                c = np.abs(cur).sum() + 1  # warmup overhead nudge
                if c < cost:
                    cost = c
                    best = order
                    best_res = cur
            bw.put(0, 1)
            bw.put(0b001000 | best, 6)   # SUBFRAME_FIXED, order
            bw.put(0, 1)                 # no wasted bits
            for i in range(best):
                bw.put(int(s[i]) & 0xFFFF, 16)
            res = best_res
            bw.put(0, 2)                 # rice method 0
            bw.put(0, 4)                 # partition order 0
            k = _rice_k(res)
            bw.put(k, 4)
            _write_rice(bw, res, k)
        bw.align()
        body = bytes(bw.buf)
        bw.buf = bytearray(body)
        bw.put(_crc16(body), 16)
        self._frame_idx += 1
        return bytes(bw.buf)

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        out: List[Packet] = []
        if frame is not None:
            x = _sf.to_float(frame.audio_data, frame.format)
            s16 = np.clip(np.rint(x * 32768.0), -32768, 32767) \
                .astype(np.int16)
            if not self._header_sent:
                self._sr = frame.sample_rate
                self._nch = s16.shape[0]
                if self._nch > 8:
                    raise NotSupported("flac enc: >8 channels")
                out.append(Packet(data=self._header(), pts=0, dts=0,
                                  flags=PKT_FLAG_KEY,
                                  time_base=frame.time_base))
                self._header_sent = True
            self._buf = s16 if self._buf is None else \
                np.concatenate([self._buf, s16], axis=1)
        while self._buf is not None and (
                self._buf.shape[1] >= self.BLOCK
                or (frame is None and self._buf.shape[1] > 0)):
            n = min(self.BLOCK, self._buf.shape[1])
            blk, self._buf = self._buf[:, :n], self._buf[:, n:]
            pts = self._total
            self._total += n
            out.append(Packet(data=self._encode_block(blk), pts=pts,
                              dts=pts, duration=n, flags=PKT_FLAG_KEY))
            if frame is not None:
                break
        return out
