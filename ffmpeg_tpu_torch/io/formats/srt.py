"""SRT subtitle demuxer/muxer (libavformat/srtdec.c / srtenc.c analogs).

The port's copy of ffmpeg_tpu/io/formats/srt.py, held equal to it by
tests/test_torch_io_containers.py.
"""

from __future__ import annotations

import re
from typing import List

from ...core.packet import Packet, PKT_FLAG_KEY
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from ..demux import Demuxer, register_demuxer
from ..mux import Muxer, register_muxer
from ..stream import CodecParameters, MediaType

_TS_RE = re.compile(
    r"(\d+):(\d+):(\d+)[,.](\d+)\s*-->\s*(\d+):(\d+):(\d+)[,.](\d+)")


def _ms(h, m, s, ms):
    return ((int(h) * 60 + int(m)) * 60 + int(s)) * 1000 + int(ms)


@register_demuxer
class SrtDemuxer(Demuxer):
    name = "srt"
    extensions = ("srt",)

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        try:
            text = head.decode("utf-8-sig", "strict")[:512]
        except UnicodeDecodeError:
            return 0
        return 60 if _TS_RE.search(text) else 0

    def read_header(self) -> None:
        par = CodecParameters(codec_type=MediaType.SUBTITLE,
                              codec_id="subrip")
        self.add_stream(codecpar=par, time_base=Rational(1, 1000))
        text = self.r.read(1 << 24).decode("utf-8-sig", "replace")
        self._cues = []
        for block in re.split(r"\r?\n\r?\n", text):
            block = block.strip()
            if not block:
                continue
            lines = block.splitlines()
            ts_line = None
            for li, line in enumerate(lines):
                m = _TS_RE.search(line)
                if m:
                    ts_line = li
                    break
            if ts_line is None:
                continue
            g = m.groups()
            start = _ms(*g[:4])
            end = _ms(*g[4:])
            payload = "\n".join(lines[ts_line + 1:])
            self._cues.append((start, end, payload))
        self._idx = 0

    def read_packet(self) -> Packet:
        if self._idx >= len(self._cues):
            raise EndOfStream()
        start, end, payload = self._cues[self._idx]
        self._idx += 1
        return Packet(data=payload.encode("utf-8"), pts=start, dts=start,
                      duration=end - start, flags=PKT_FLAG_KEY,
                      time_base=Rational(1, 1000))


@register_muxer
class SrtMuxer(Muxer):
    name = "srt"
    extensions = ("srt",)
    interleave = False

    def _write_header(self) -> None:
        self._n = 0

    @staticmethod
    def _fmt(ms: int) -> str:
        s, ms = divmod(ms, 1000)
        m, s = divmod(s, 60)
        h, m = divmod(m, 60)
        return f"{h:02d}:{m:02d}:{s:02d},{ms:03d}"

    def _write_packet(self, pkt: Packet) -> None:
        self._n += 1
        st = self.streams[pkt.stream_index]
        from ...utils.rational import rescale_q, Rational as R
        ms = rescale_q(pkt.pts, st.time_base, R(1, 1000))
        dur = rescale_q(pkt.duration, st.time_base, R(1, 1000))
        text = pkt.data.decode("utf-8", "replace")
        self.w.write(
            f"{self._n}\n{self._fmt(ms)} --> {self._fmt(ms + dur)}\n"
            f"{text}\n\n".encode("utf-8"))
