"""ASS/SSA subtitle demuxer + muxer (reference: libavformat/assdec.c,
assenc.c).

Packets carry the reference's event wire format
"ReadOrder,Layer,Style,Name,MarginL,MarginR,MarginV,Effect,Text"
with pts/duration in centiseconds (time base 1/100); the script
header (everything up to and including the [Events] Format line)
travels as stream extradata.

The port's copy of ffmpeg_tpu/io/formats/assfmt.py, held equal to it by
tests/test_torch_io_containers.py.
"""

from __future__ import annotations

import re
from typing import List

from ...core.packet import Packet, PKT_FLAG_KEY
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational, rescale_q
from ..demux import Demuxer, register_demuxer
from ..mux import Muxer, register_muxer
from ..stream import CodecParameters, MediaType

_DIALOGUE_RE = re.compile(
    r"Dialogue:\s*([^,]*),(\d+):(\d+):(\d+)[.:](\d+),"
    r"(\d+):(\d+):(\d+)[.:](\d+),(.*)")


def _cs(h, m, s, cs):
    return ((int(h) * 60 + int(m)) * 60 + int(s)) * 100 + int(cs)


@register_demuxer
class AssDemuxer(Demuxer):
    name = "ass"
    extensions = ("ass", "ssa")

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        text = head.decode("utf-8-sig", "replace").lstrip("\r\n \t")
        if text.startswith("[Script Info]"):
            return 60
        return 0

    def read_header(self) -> None:
        text = self.r.read(1 << 24).decode("utf-8-sig", "replace")
        header_lines = []
        events = []
        readorder = 0
        for line in text.splitlines():
            m = _DIALOGUE_RE.match(line.strip())
            if m is None:
                header_lines.append(line)
                continue
            g = m.groups()
            start = _cs(*g[1:5])
            end = _cs(*g[5:9])
            if end <= start:
                # zero/negative-duration events stay in the header
                # (assdec.c read_dialogue)
                header_lines.append(line)
                continue
            layer_field = g[0].strip()
            lm = re.match(r"-?\d+", layer_field)
            layer = int(lm.group(0)) if lm else 0
            payload = f"{readorder},{layer},{g[9]}".rstrip("\r\n")
            readorder += 1
            events.append((start, end - start, payload))
        events.sort(key=lambda ev: ev[0])
        par = CodecParameters(codec_type=MediaType.SUBTITLE,
                              codec_id="ass")
        par.extradata = ("\n".join(header_lines).rstrip("\n") +
                         "\n").encode("utf-8")
        self.add_stream(codecpar=par, time_base=Rational(1, 100))
        self._events = events
        self._idx = 0

    def read_packet(self) -> Packet:
        if self._idx >= len(self._events):
            raise EndOfStream()
        start, dur, payload = self._events[self._idx]
        self._idx += 1
        return Packet(data=payload.encode("utf-8"), pts=start,
                      dts=start, duration=dur, flags=PKT_FLAG_KEY,
                      stream_index=0, time_base=Rational(1, 100))


def _ts(cs: int) -> str:
    """assenc.c write_packet timestamp format (clamped at 9h)."""
    hh = cs // 360000
    mm = (cs // 6000) % 60
    ss = (cs // 100) % 60
    hs = cs % 100
    if hh > 9:
        hh, mm, ss, hs = 9, 59, 59, 99
    return f"{hh}:{mm:02d}:{ss:02d}.{hs:02d}"


@register_muxer
class AssMuxer(Muxer):
    name = "ass"
    extensions = ("ass", "ssa")
    interleave = False

    def _write_header(self) -> None:
        par = self.streams[0].codecpar
        ed = bytes(par.extradata or b"")
        if ed:
            txt = ed.decode("utf-8", "replace")
            if not txt.endswith("\n"):
                txt += "\n"
            self.w.write(txt.encode("utf-8"))
        else:
            self.w.write(
                b"[Script Info]\nScriptType: v4.00+\n\n[Events]\n"
                b"Format: Layer, Start, End, Style, Name, MarginL, "
                b"MarginR, MarginV, Effect, Text\n")

    def _write_packet(self, pkt: Packet) -> None:
        st = self.streams[pkt.stream_index]
        tb = pkt.time_base or st.time_base
        start = rescale_q(pkt.pts, tb, Rational(1, 100))
        dur = rescale_q(pkt.duration or 0, tb, Rational(1, 100))
        text = bytes(pkt.data).decode("utf-8", "replace")
        parts = text.split(",", 2)
        if len(parts) < 3:
            raise InvalidData("ass: bad event payload")
        _ro, layer, rest = parts
        rest = rest.rstrip("\r\n")
        self.w.write(
            f"Dialogue: {layer},{_ts(start)},{_ts(start + dur)},"
            f"{rest}\n".encode("utf-8"))
