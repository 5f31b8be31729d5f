"""Raw MPEG audio (.mp3/.mp2) demuxer (reference: libavformat/mp3dec.c
sync/probe core; ID3v2 skipping). Splits the byte stream into frame
packets using header frame sizes.

The port's copy of ffmpeg_tpu/io/formats/mp3raw.py, held equal to it by
tests/test_torch_io_formats.py.
"""

from __future__ import annotations

from ...core.packet import Packet, PKT_FLAG_KEY
from ...formats.channel_layout import default_layout
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from ..demux import Demuxer, register_demuxer
from ..stream import CodecParameters, MediaType

_FREQS = [44100, 48000, 32000]
_BITRATES = {
    # (lsf, layer) -> kbps table
    (0, 3): [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
             256, 320, 0],
    (0, 2): [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
             320, 384, 0],
    (0, 1): [0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352,
             384, 416, 448, 0],
    (1, 3): [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
             160, 0],
    (1, 2): [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
             160, 0],
    (1, 1): [0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192,
             224, 256, 0],
}


def _frame_info(h: int):
    """header u32 → (frame_size, samples, rate, nch, layer) or None."""
    if (h >> 21) & 0x7FF != 0x7FF:
        return None
    ver = (h >> 19) & 3
    if ver == 1:
        return None
    layer = 4 - ((h >> 17) & 3)
    if layer == 4:
        return None
    lsf = 0 if ver == 3 else 1
    mpeg25 = 1 if ver == 0 else 0
    br_idx = (h >> 12) & 15
    sr_idx = (h >> 10) & 3
    if sr_idx >= 3 or br_idx in (0, 15):
        return None
    pad = (h >> 9) & 1
    rate = _FREQS[sr_idx] >> (lsf + mpeg25)
    br = _BITRATES[(lsf, layer)][br_idx] * 1000
    if layer == 1:
        size = (br * 12 // rate + pad) * 4
        samples = 384
    elif layer == 2:
        size = br * 144 // rate + pad
        samples = 1152
    else:
        size = br * 144 // (rate << lsf) + pad
        samples = 1152 >> lsf
    nch = 1 if ((h >> 6) & 3) == 3 else 2
    return size, samples, rate, nch, layer


@register_demuxer
class Mp3Demuxer(Demuxer):
    name = "mp3"
    long_name = "raw MPEG audio (MP2/MP3)"
    extensions = ("mp3", "mp2", "mpa")

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        i = 0
        if head[:3] == b"ID3":
            return 60        # ID3v2 header implies mpeg audio
        good = 0
        while i + 4 <= len(head) and good < 4:
            fi = _frame_info(int.from_bytes(head[i:i + 4], "big"))
            if fi is None or fi[0] <= 4:
                break
            good += 1
            i += fi[0]
        return 55 if good >= 3 else (25 if good == 2 else 0)

    def read_header(self) -> None:
        head = self.r.peek(10)
        if head[:3] == b"ID3":
            from .. import id3v2
            total = id3v2.tag_size(head)
            tag = self.r.read(total)
            meta, chapters, pics = id3v2.parse(tag)
            self.metadata.update(meta)
            for ch in chapters:
                self.chapters.append(
                    (ch.element_id, ch.start_ms, ch.end_ms, ch.metadata))
            if pics:
                self.metadata.setdefault("attached_pic_mime", pics[0][0])
        self._resync()
        head = self.r.peek(4)
        fi = _frame_info(int.from_bytes(head[:4], "big"))
        if fi is None:
            raise InvalidData("mp3: no frame")
        _, samples, rate, nch, layer = fi
        par = CodecParameters(
            codec_type=MediaType.AUDIO,
            codec_id="mp3" if layer == 3 else f"mp{layer}",
            sample_rate=rate, ch_layout=default_layout(nch),
            frame_size=samples)
        self.add_stream(codecpar=par, time_base=Rational(1, rate))
        self._pts = 0
        self._samples = samples

    def _resync(self) -> None:
        skipped = 0
        while skipped < 65536:
            head = self.r.peek(4)
            if len(head) < 4:
                raise EndOfStream()
            if _frame_info(int.from_bytes(head, "big")) is not None:
                return
            self.r.skip(1)
            skipped += 1
        raise InvalidData("mp3: lost sync")

    def read_packet(self) -> Packet:
        self._resync()
        head = self.r.peek(4)
        if len(head) < 4:
            raise EndOfStream()
        fi = _frame_info(int.from_bytes(head, "big"))
        data = self.r.read_exact(fi[0])
        pkt = Packet(data=data, pts=self._pts, dts=self._pts,
                     duration=fi[1], stream_index=0, flags=PKT_FLAG_KEY,
                     time_base=Rational(1, fi[2]))
        self._pts += fi[1]
        return pkt
