"""WAV/RIFF demuxer + muxer (analog of libavformat/wavdec.c / wavenc.c).

The port's copy of ffmpeg_tpu/io/formats/wav.py, held equal to it by
tests/test_torch_io_formats.py.
"""

from __future__ import annotations

import struct

from ...core.packet import Packet, PKT_FLAG_KEY
from ...formats.channel_layout import default_layout
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import NOPTS, Rational
from ..demux import Demuxer, register_demuxer, PROBE_SCORE_MAX
from ..mux import Muxer, register_muxer
from ..stream import CodecParameters, MediaType

# WAVE format tags → codec ids (riff.c tag table subset)
_TAG_TO_CODEC = {
    0x0001: None,          # PCM int — depends on bits
    0x0003: None,          # PCM float
    0x0006: "pcm_alaw",
    0x0007: "pcm_mulaw",
    0x0055: "mp3",
    0x2000: "ac3",
    0x00FF: "aac",
    0x0002: "adpcm_ms",
    0x0011: "adpcm_ima_wav",
}


def _samples_per_block(codec_id, block_align, channels):
    """ADPCM packet durations are in samples, not blocks."""
    if codec_id == "adpcm_ima_wav":
        return (block_align - 4 * channels) // channels * 2 + 1
    if codec_id == "adpcm_ms":
        return (block_align - 7 * channels) * 2 // channels + 2
    return 1


def _pcm_codec(tag: int, bits: int) -> str:
    if tag == 0x0003:
        return {32: "pcm_f32le", 64: "pcm_f64le"}.get(bits, "pcm_f32le")
    return {8: "pcm_u8", 16: "pcm_s16le", 24: "pcm_s24le",
            32: "pcm_s32le", 64: "pcm_s64le"}.get(bits, "pcm_s16le")


_CODEC_TO_TAG = {
    "pcm_u8": (0x0001, 8), "pcm_s16le": (0x0001, 16), "pcm_s24le": (0x0001, 24),
    "pcm_s32le": (0x0001, 32), "pcm_f32le": (0x0003, 32), "pcm_f64le": (0x0003, 64),
    "pcm_alaw": (0x0006, 8), "pcm_mulaw": (0x0007, 8),
    "adpcm_ima_wav": (0x0011, 4), "adpcm_ms": (0x0002, 4),
}


@register_demuxer
class WavDemuxer(Demuxer):
    name = "wav"
    long_name = "WAV / WAVE (Waveform Audio)"
    extensions = ("wav", "w64")

    BLOCK_SAMPLES = 4096   # samples per output packet, like wavdec's max_size logic

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
            return PROBE_SCORE_MAX
        return 0

    def read_header(self) -> None:
        r = self.r
        if r.tag() != b"RIFF":
            raise InvalidData("not RIFF")
        r.rl32()
        if r.tag() != b"WAVE":
            raise InvalidData("not WAVE")
        fmt = None
        self._data_left = 0
        while not r.at_eof():
            try:
                tag = r.tag()
                size = r.rl32()
            except EndOfStream:
                break
            if tag == b"fmt ":
                fmt = r.read_exact(size)
                if size & 1:
                    r.skip(1)
            elif tag == b"data":
                self._data_left = size if size != 0xFFFFFFFF else -1
                break
            else:
                r.skip(size + (size & 1))
        if fmt is None:
            raise InvalidData("wav: no fmt chunk")
        wtag, channels, rate, byte_rate, block_align, bits = \
            struct.unpack("<HHIIHH", fmt[:16])
        if wtag == 0xFFFE and len(fmt) >= 26:  # WAVE_FORMAT_EXTENSIBLE
            wtag = struct.unpack("<H", fmt[24:26])[0]
        codec = _TAG_TO_CODEC.get(wtag)
        if codec is None:
            codec = _pcm_codec(wtag, bits)
        par = CodecParameters(
            codec_type=MediaType.AUDIO, codec_id=codec, codec_tag=wtag,
            sample_rate=rate, ch_layout=default_layout(channels),
            block_align=block_align or (channels * max(1, bits // 8)),
            bits_per_coded_sample=bits, bit_rate=byte_rate * 8)
        if codec.startswith("adpcm") and len(fmt) > 18:
            cb = struct.unpack("<H", fmt[16:18])[0]
            par.extradata = fmt[18:18 + cb]
        st = self.add_stream(codecpar=par, time_base=Rational(1, rate))
        self._spb = _samples_per_block(codec, par.block_align,
                                       channels)
        if self._data_left > 0 and block_align:
            st.duration = self._data_left // block_align * self._spb
            self.duration = st.duration * 1000000 // rate
        self._pts = 0
        self._data_start = r.tell()
        self._data_size = self._data_left

    def read_packet(self) -> Packet:
        st = self.streams[0]
        ba = st.codecpar.block_align
        want = self.BLOCK_SAMPLES * ba
        if self._data_left == 0:
            raise EndOfStream()
        if self._data_left > 0:
            want = min(want, self._data_left)
        data = self.r.read(want)
        if not data:
            raise EndOfStream()
        if self._data_left > 0:
            self._data_left -= len(data)
        n = (len(data) // ba if ba else 0) * self._spb
        pkt = Packet(data=data, pts=self._pts, dts=self._pts,
                     duration=n, stream_index=0, flags=PKT_FLAG_KEY,
                     time_base=st.time_base)
        self._pts += n
        return pkt

    def seek(self, stream_index: int, ts: int, flags: int = 0) -> None:
        """Sample-accurate byte seek (ts in the stream time base =
        samples)."""
        if not self.r.seekable:
            raise InvalidData("wav: stream not seekable")
        ba = self.streams[0].codecpar.block_align or 1
        off = max(0, ts) // self._spb * ba if self._spb > 1 \
            else max(0, ts) * ba
        if self._data_size > 0:
            off = min(off, self._data_size)
        self.r.seek(self._data_start + off)
        self._pts = off // ba * self._spb
        if self._data_size > 0:
            self._data_left = self._data_size - off


@register_muxer
class WavMuxer(Muxer):
    name = "wav"
    extensions = ("wav",)
    default_audio_codec = "pcm_s16le"

    def _write_header(self) -> None:
        if len(self.streams) != 1 or self.streams[0].codec_type != MediaType.AUDIO:
            raise InvalidData("wav: exactly one audio stream required")
        par = self.streams[0].codecpar
        if par.codec_id not in _CODEC_TO_TAG:
            raise InvalidData(f"wav: cannot mux codec {par.codec_id}")
        tag, bits = _CODEC_TO_TAG[par.codec_id]
        ch = par.channels
        if par.codec_id.startswith("adpcm"):
            ba = par.block_align
            ed = bytes(par.extradata or b"")
            byte_rate = par.sample_rate * ba // max(
                _samples_per_block(par.codec_id, ba, ch), 1)
        else:
            ba = ch * bits // 8
            ed = b""
            byte_rate = par.sample_rate * ba
        w = self.w
        w.tag("RIFF")
        self._riff_size_pos = w.tell()
        w.wl32(0)                      # patched in trailer
        w.tag("WAVE")
        w.tag("fmt ")
        w.wl32(16 if not ed and not par.codec_id.startswith("adpcm")
               else 18 + len(ed))
        w.wl16(tag)
        w.wl16(ch)
        w.wl32(par.sample_rate)
        w.wl32(byte_rate)
        w.wl16(ba)
        w.wl16(bits)
        if ed or par.codec_id.startswith("adpcm"):
            w.wl16(len(ed))
            if ed:
                w.write(ed)
        w.tag("data")
        self._data_size_pos = w.tell()
        w.wl32(0)
        self._data_bytes = 0

    def _write_packet(self, pkt: Packet) -> None:
        self.w.write(pkt.data)
        self._data_bytes += len(pkt.data)

    def _write_trailer(self) -> None:
        w = self.w
        if w.seekable:
            end = w.tell()
            w.seek(self._riff_size_pos)
            w.wl32(end - 8)
            w.seek(self._data_size_pos)
            w.wl32(self._data_bytes)
            w.seek(end)
