"""WebVTT subtitle demuxer/muxer (libavformat/webvttdec.c /
webvttenc.c analogs): WEBVTT magic, optional cue identifiers and cue
settings, NOTE/STYLE/REGION blocks, hh:mm:ss.mmm or mm:ss.mmm timing.

The port's copy of ffmpeg_tpu/io/formats/webvtt.py, held equal to it by
tests/test_torch_io_containers.py.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from ...core.packet import Packet, PKT_FLAG_KEY
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational, rescale_q
from ..demux import Demuxer, register_demuxer
from ..mux import Muxer, register_muxer
from ..stream import CodecParameters, MediaType

_TS_RE = re.compile(
    r"(?:(\d+):)?(\d{2}):(\d{2})\.(\d{3})\s*-->\s*"
    r"(?:(\d+):)?(\d{2}):(\d{2})\.(\d{3})(.*)")


def _ms(h, m, s, ms) -> int:
    return ((int(h or 0) * 60 + int(m)) * 60 + int(s)) * 1000 + int(ms)


@register_demuxer
class WebVttDemuxer(Demuxer):
    name = "webvtt"
    extensions = ("vtt",)

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        try:
            text = head.decode("utf-8-sig", "strict")[:16]
        except UnicodeDecodeError:
            return 0
        return 100 if text.startswith("WEBVTT") else 0

    def read_header(self) -> None:
        raw = bytearray()
        while True:
            chunk = self.r.read(1 << 24)
            if not chunk:
                break
            raw += chunk
        text = bytes(raw).decode("utf-8-sig", "replace")
        if not text.startswith("WEBVTT"):
            raise InvalidData("webvtt: missing magic")
        par = CodecParameters(codec_type=MediaType.SUBTITLE,
                              codec_id="webvtt")
        self.add_stream(codecpar=par, time_base=Rational(1, 1000))
        self._cues: List[Tuple[int, int, str, str, str]] = []
        for block in re.split(r"\r?\n\r?\n", text)[1:]:
            block = block.strip("\r\n")
            if not block:
                continue
            lines = block.splitlines()
            if lines[0].split()[:1] and lines[0].split()[0] in (
                    "NOTE", "STYLE", "REGION"):
                continue
            cid = ""
            ts_line = 0
            m = _TS_RE.match(lines[0])
            if m is None and len(lines) > 1:
                cid = lines[0].strip()
                ts_line = 1
                m = _TS_RE.match(lines[ts_line])
            if m is None:
                continue
            g = m.groups()
            start = _ms(*g[:4])
            end = _ms(*g[4:8])
            settings = (g[8] or "").strip()
            payload = "\n".join(lines[ts_line + 1:])
            self._cues.append((start, end, payload, cid, settings))
        self._idx = 0

    def read_packet(self) -> Packet:
        if self._idx >= len(self._cues):
            raise EndOfStream()
        start, end, payload, cid, settings = self._cues[self._idx]
        self._idx += 1
        pkt = Packet(data=payload.encode("utf-8"), pts=start, dts=start,
                     duration=end - start, flags=PKT_FLAG_KEY,
                     time_base=Rational(1, 1000))
        if cid:
            pkt.side_data["webvtt_identifier"] = cid.encode("utf-8")
        if settings:
            # matches the reference's AV_PKT_DATA_WEBVTT_SETTINGS side data
            pkt.side_data["webvtt_settings"] = settings.encode("utf-8")
        return pkt


@register_muxer
class WebVttMuxer(Muxer):
    name = "webvtt"
    extensions = ("vtt",)
    interleave = False

    def _write_header(self) -> None:
        self.w.write(b"WEBVTT\n")

    @staticmethod
    def _fmt(ms: int) -> str:
        s, ms = divmod(ms, 1000)
        m, s = divmod(s, 60)
        h, m = divmod(m, 60)
        return f"{h:02d}:{m:02d}:{s:02d}.{ms:03d}"

    def _write_packet(self, pkt: Packet) -> None:
        st = self.streams[pkt.stream_index]
        ms = rescale_q(pkt.pts, st.time_base, Rational(1, 1000))
        dur = rescale_q(pkt.duration, st.time_base, Rational(1, 1000))
        out = ["\n"]
        cid = pkt.side_data.get("webvtt_identifier")
        if cid:
            out.append(cid.decode("utf-8", "replace") + "\n")
        settings = pkt.side_data.get("webvtt_settings")
        line = f"{self._fmt(ms)} --> {self._fmt(ms + dur)}"
        if settings:
            line += " " + settings.decode("utf-8", "replace")
        out.append(line + "\n")
        out.append(pkt.data.decode("utf-8", "replace") + "\n")
        self.w.write("".join(out).encode("utf-8"))
