"""DASH (MPEG-DASH, ISO 23009-1) VOD demuxer (reference:
libavformat/dashdec.c — which requires libxml2; this one uses the
stdlib ElementTree).

Supports static MPDs with SegmentTemplate ($RepresentationID$,
$Number$ incl. %0Nd format, $Time$, SegmentTimeline), SegmentList and
single-file SegmentBase representations. One representation per
adaptation set is selected (highest bandwidth). Segments are fetched
eagerly per representation and demuxed with the fragmented-MP4/WebM
demuxers; packets are interleaved across sets by DTS.

The port's copy of ffmpeg_tpu/io/formats/dash.py, held equal to it by
tests/test_torch_protocols.py.
"""

from __future__ import annotations

import io
import re
from typing import List, Optional
from urllib.parse import urljoin

from ...core.packet import Packet
from ...utils.error import EndOfStream, InvalidData
from .. import avio
from ..demux import Demuxer, register_demuxer, open_input

_NS = "{urn:mpeg:dash:schema:mpd:2011}"


def _iso_duration(s: str) -> float:
    """ISO 8601 duration (PT1H2M3.5S) → seconds."""
    m = re.match(r"^PT(?:(\d+(?:\.\d+)?)H)?(?:(\d+(?:\.\d+)?)M)?"
                 r"(?:(\d+(?:\.\d+)?)S)?$", s or "")
    if not m:
        return 0.0
    h, mi, se = (float(v) if v else 0.0 for v in m.groups())
    return h * 3600 + mi * 60 + se


def _tag(e):
    return e.tag.split("}")[-1]


def _find(e, name):
    for c in e:
        if _tag(c) == name:
            return c
    return None


def _findall(e, name):
    return [c for c in e if _tag(c) == name]


def _tmpl_sub(t: str, rep_id: str, number: Optional[int] = None,
              time: Optional[int] = None) -> str:
    def repl(m):
        body = m.group(1)
        if body == "RepresentationID":
            return str(rep_id)
        name, _, fmt = body.partition("%")
        val = {"Number": number, "Time": time,
               "Bandwidth": 0}.get(name)
        if val is None:
            return m.group(0)
        if fmt:
            return ("%" + fmt) % val
        return str(val)

    t = re.sub(r"\$([^$]*)\$", repl, t)
    return t.replace("$$", "$")


class _RepStream:
    """One representation: init + media segments → a sub-demuxer.
    Fetching stops gracefully at the first missing segment (estimated
    counts can overshoot by one)."""

    def __init__(self, urls: List[str], byte_ranges=None):
        buf = io.BytesIO()
        for i, u in enumerate(urls):
            try:
                r = avio.open_read(u)
            except Exception:
                if i >= 2:
                    break
                raise
            if byte_ranges and byte_ranges[i]:
                lo, hi = byte_ranges[i]
                r.read(lo)
                buf.write(r.read(hi - lo + 1))
            else:
                buf.write(r.read(1 << 30))
            r.close()
        buf.seek(0)
        self.demux = open_input(buf)
        self.pending: Optional[Packet] = None
        self.done = False

    def peek(self) -> Optional[Packet]:
        if self.pending is None and not self.done:
            try:
                self.pending = self.demux.read_packet()
            except EndOfStream:
                self.done = True
        return self.pending

    def pop(self) -> Packet:
        p = self.pending
        self.pending = None
        return p


@register_demuxer
class DashDemuxer(Demuxer):
    name = "dash"
    extensions = ("mpd",)

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        if b"<MPD" in head[:2048]:
            return 100
        return 0

    def read_header(self) -> None:
        import xml.etree.ElementTree as ET
        text = self.r.read(1 << 22)
        root = ET.fromstring(text)
        if _tag(root) != "MPD":
            raise InvalidData("dash: not an MPD")
        self._duration_sec = _iso_duration(
            root.get("mediaPresentationDuration", "")) or 3600.0
        base = self.url or ""
        mpd_base = _find(root, "BaseURL")
        if mpd_base is not None and mpd_base.text:
            base = urljoin(base, mpd_base.text.strip())
        period = _find(root, "Period")
        if period is None:
            raise InvalidData("dash: no Period")
        self._reps: List[_RepStream] = []
        self._map: List[tuple] = []       # (rep idx, sub stream idx)
        for aset in _findall(period, "AdaptationSet"):
            reps = _findall(aset, "Representation")
            if not reps:
                continue
            reps.sort(key=lambda r: int(r.get("bandwidth", "0")))
            rep = reps[-1]
            urls, ranges = self._segment_urls(aset, rep, base)
            rs = _RepStream(urls, ranges)
            ridx = len(self._reps)
            self._reps.append(rs)
            for st in rs.demux.streams:
                self._map.append((ridx, st.index))
                self.add_stream(codecpar=st.codecpar.copy(),
                                time_base=st.time_base)

        if not self._reps:
            raise InvalidData("dash: no representations")

    def _segment_urls(self, aset, rep, base):
        rep_id = rep.get("id", "0")
        tmpl = _find(rep, "SegmentTemplate")
        if tmpl is None:
            tmpl = _find(aset, "SegmentTemplate")
        if tmpl is not None:
            init = tmpl.get("initialization")
            media = tmpl.get("media")
            start_num = int(tmpl.get("startNumber", "1"))
            urls = []
            if init:
                urls.append(urljoin(base, _tmpl_sub(init, rep_id)))
            timeline = _find(tmpl, "SegmentTimeline")
            if timeline is not None:
                t = 0
                num = start_num
                for seg in _findall(timeline, "S"):
                    if seg.get("t") is not None:
                        t = int(seg.get("t"))
                    d = int(seg.get("d"))
                    r = int(seg.get("r", "0"))
                    for _ in range(r + 1):
                        urls.append(urljoin(base, _tmpl_sub(
                            media, rep_id, number=num, time=t)))
                        t += d
                        num += 1
            else:
                dur = int(tmpl.get("duration", "0"))
                timescale = int(tmpl.get("timescale", "1"))
                total = self._mpd_duration_sec()
                n = max(1, int(total * timescale / max(dur, 1) + 0.999)) \
                    if dur else 1
                for k in range(n):
                    urls.append(urljoin(base, _tmpl_sub(
                        media, rep_id, number=start_num + k,
                        time=k * dur)))
            return urls, None
        slist = _find(rep, "SegmentList")
        if slist is None:
            slist = _find(aset, "SegmentList")
        burl = _find(rep, "BaseURL")
        burl_txt = burl.text.strip() if (burl is not None and
                                         burl.text) else None
        if slist is not None:
            urls = []
            init = _find(slist, "Initialization")
            if init is not None and init.get("sourceURL"):
                urls.append(urljoin(base, init.get("sourceURL")))
            for su in _findall(slist, "SegmentURL"):
                if su.get("media"):
                    urls.append(urljoin(base, su.get("media")))
            if not urls and burl_txt:
                # single-file mode: ranges tile the one file — read it
                # whole (Initialization@range + SegmentURL@mediaRange)
                return [urljoin(base, burl_txt)], None
            return urls, None
        if burl_txt:
            return [urljoin(base, burl_txt)], None
        raise InvalidData("dash: unsupported segment addressing")

    def _mpd_duration_sec(self) -> float:
        return getattr(self, "_duration_sec", 3600.0)

    def read_packet(self) -> Packet:
        # pick the rep whose next packet has the lowest time
        best = None
        best_t = None
        for ridx, rs in enumerate(self._reps):
            p = rs.peek()
            if p is None:
                continue
            tb = rs.demux.streams[p.stream_index].time_base
            ts = p.dts if p.dts is not None else (p.pts or 0)
            t = ts * tb.num / tb.den if tb and tb.den else 0.0
            if best_t is None or t < best_t:
                best = ridx
                best_t = t
        if best is None:
            raise EndOfStream()
        rs = self._reps[best]
        pkt = rs.pop()
        out_idx = self._map.index((best, pkt.stream_index))
        pkt.stream_index = out_idx
        pkt.time_base = self.streams[out_idx].time_base
        return pkt
