"""PCM codec family (libavcodec/pcm.c): generated decoders/encoders for all
integer/float widths + A-law/mu-law companding.

The port's copy of ffmpeg_tpu/codecs/pcm.py, held equal to it by
tests/test_torch_io_formats.py.  PCM is host work on host audio
planes: the codecs take the device that open_decoder and open_encoder
hand every codec, and keep it unused.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.frame import Frame
from ..core.packet import Packet, PKT_FLAG_KEY
from ..formats.channel_layout import default_layout
from ..io.stream import MediaType
from ..utils.error import InvalidData
from ..utils.rational import Rational
from .codec import DeviceCodec, register_decoder, register_encoder

# codec_id → (numpy dtype or special, sample_fmt name, bytes/sample)
_PCM_SPECS = {
    "pcm_u8": (np.dtype(np.uint8), "u8", 1),
    "pcm_s8": (np.dtype(np.int8), "u8", 1),
    "pcm_s16le": (np.dtype("<i2"), "s16", 2),
    "pcm_s16be": (np.dtype(">i2"), "s16", 2),
    "pcm_s24le": ("s24le", "s32", 3),
    "pcm_s24be": ("s24be", "s32", 3),
    "pcm_s32le": (np.dtype("<i4"), "s32", 4),
    "pcm_s32be": (np.dtype(">i4"), "s32", 4),
    "pcm_s64le": (np.dtype("<i8"), "s64", 8),
    "pcm_f32le": (np.dtype("<f4"), "flt", 4),
    "pcm_f32be": (np.dtype(">f4"), "flt", 4),
    "pcm_f64le": (np.dtype("<f8"), "dbl", 8),
    "pcm_f64be": (np.dtype(">f8"), "dbl", 8),
}


def _decode_samples(codec_id: str, data: bytes, channels: int) -> np.ndarray:
    spec = _PCM_SPECS[codec_id]
    if spec[0] == "s24le" or spec[0] == "s24be":
        b = np.frombuffer(data, np.uint8)
        b = b[: len(b) - len(b) % (3 * channels)].reshape(-1, 3)
        if spec[0] == "s24le":
            v = (b[:, 0].astype(np.int32) | b[:, 1].astype(np.int32) << 8
                 | b[:, 2].astype(np.int32) << 16)
        else:
            v = (b[:, 2].astype(np.int32) | b[:, 1].astype(np.int32) << 8
                 | b[:, 0].astype(np.int32) << 16)
        v = (v << 8) >> 8  # sign extend
        x = (v << 8).astype(np.int32)  # s24 stored in high bits of s32 like ffmpeg
    else:
        dt = spec[0]
        usable = len(data) - len(data) % (dt.itemsize * channels)
        x = np.frombuffer(data[:usable], dt)
        if codec_id == "pcm_s8":
            x = ((x.astype(np.int16) + 128)).astype(np.uint8)
        if dt.byteorder == ">":
            x = x.astype(dt.newbyteorder("<"))
    n = x.shape[0] // channels
    return np.ascontiguousarray(x[: n * channels].reshape(n, channels).T)


def _encode_samples(codec_id: str, x: np.ndarray) -> bytes:
    spec = _PCM_SPECS[codec_id]
    inter = np.ascontiguousarray(x.T)          # (n, ch)
    if spec[0] in ("s24le", "s24be"):
        v = (inter.astype(np.int32) >> 8).reshape(-1)
        b = np.zeros((v.shape[0], 3), np.uint8)
        if spec[0] == "s24le":
            b[:, 0] = v & 0xFF
            b[:, 1] = (v >> 8) & 0xFF
            b[:, 2] = (v >> 16) & 0xFF
        else:
            b[:, 2] = v & 0xFF
            b[:, 1] = (v >> 8) & 0xFF
            b[:, 0] = (v >> 16) & 0xFF
        return b.tobytes()
    dt = spec[0]
    if codec_id == "pcm_s8":
        inter = (inter.astype(np.int16) - 128).astype(np.int8)
    return inter.astype(dt).tobytes()


def _make_decoder(cid: str):
    class _PcmDecoder(DeviceCodec):
        codec_id = cid
        codec_type = MediaType.AUDIO

        def decode(self, pkt: Optional[Packet]) -> List[Frame]:
            if pkt is None or not pkt.data:
                return []
            ch = self.par.channels or 1
            x = _decode_samples(cid, pkt.data, ch)
            f = Frame.audio(x, self.par.sample_rate, _PCM_SPECS[cid][1],
                            self.par.ch_layout or default_layout(ch),
                            pts=pkt.pts, time_base=pkt.time_base)
            f.duration = x.shape[1]
            return [f]
    _PcmDecoder.__name__ = f"PcmDecoder_{cid}"
    return register_decoder(_PcmDecoder)


def _make_encoder(cid: str):
    class _PcmEncoder(DeviceCodec):
        codec_id = cid
        codec_type = MediaType.AUDIO
        is_encoder = True

        def encode(self, frame: Optional[Frame]) -> List[Packet]:
            if frame is None:
                return []
            from ..formats import samplefmt as _sf
            x = frame.audio_data
            # convert whatever float/int the frame carries to target
            want_fmt = _PCM_SPECS[cid][1]
            if frame.format != want_fmt:
                x = _sf.from_float(_sf.to_float(x, frame.format.rstrip("p")), want_fmt)
            return [Packet(data=_encode_samples(cid, x), pts=frame.pts,
                           dts=frame.pts, duration=frame.nb_samples,
                           flags=PKT_FLAG_KEY, time_base=frame.time_base)]
    _PcmEncoder.__name__ = f"PcmEncoder_{cid}"
    return register_encoder(_PcmEncoder)


for _cid in _PCM_SPECS:
    _make_decoder(_cid)
    _make_encoder(_cid)


# --- companded PCM (alaw/mulaw, pcm_alaw_tablegen analog) ---------------------

def _alaw_decode_table() -> np.ndarray:
    t = np.zeros(256, np.int16)
    for i in range(256):
        v = i ^ 0x55
        seg = (v & 0x70) >> 4
        mant = v & 0x0F
        val = (mant << 4) + 8
        if seg:
            val = (val + 0x100) << (seg - 1)
        t[i] = -val if v & 0x80 else val
    return t


def _mulaw_decode_table() -> np.ndarray:
    t = np.zeros(256, np.int16)
    for i in range(256):
        v = ~i & 0xFF
        seg = (v & 0x70) >> 4
        mant = v & 0x0F
        val = ((mant << 3) + 0x84) << seg
        val -= 0x84
        t[i] = -val if v & 0x80 else val
    return t


def _make_law_decoder(cid: str, table: np.ndarray):
    class _LawDecoder(DeviceCodec):
        codec_id = cid
        codec_type = MediaType.AUDIO
        _table = table

        def decode(self, pkt: Optional[Packet]) -> List[Frame]:
            if pkt is None or not pkt.data:
                return []
            ch = self.par.channels or 1
            v = self._table[np.frombuffer(pkt.data, np.uint8)]
            n = v.shape[0] // ch
            x = v[: n * ch].reshape(n, ch).T
            f = Frame.audio(x, self.par.sample_rate, "s16",
                            self.par.ch_layout or default_layout(ch),
                            pts=pkt.pts, time_base=pkt.time_base)
            return [f]
    _LawDecoder.__name__ = f"LawDecoder_{cid}"
    return register_decoder(_LawDecoder)


_make_law_decoder("pcm_alaw", _alaw_decode_table())
_make_law_decoder("pcm_mulaw", _mulaw_decode_table())
