"""HLS demuxer (reference: libavformat/hls.c media-playlist path).

Parses an M3U8 media playlist (or picks the highest-bandwidth variant from
a master playlist), then walks segments sequentially — each segment is
demuxed by the inner format (MPEG-TS usually) with MPEG-TS timestamp
continuity preserved across segments. #EXT-X-KEY METHOD=AES-128 segments
are decrypted with utils/aes.py (hls.c open_input key handling): IV
defaults to the big-endian media sequence number when absent.

The port's copy of ffmpeg_tpu/io/formats/hls.py, held equal to it by
tests/test_torch_protocols.py.
"""

from __future__ import annotations

import io
import os
from typing import List, Optional
from urllib.parse import urljoin

from ...core.packet import Packet
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import NOPTS
from ..demux import Demuxer, register_demuxer, open_input
from .. import avio


def _resolve(base: str, ref: str) -> str:
    if "://" in ref or os.path.isabs(ref):
        return ref
    if "://" in base:
        return urljoin(base, ref)
    return os.path.join(os.path.dirname(base), ref)


class _Segment:
    __slots__ = ("url", "duration", "key_url", "iv", "seq")

    def __init__(self, url, duration, key_url, iv, seq):
        self.url = url
        self.duration = duration
        self.key_url = key_url
        self.iv = iv
        self.seq = seq


def parse_m3u8(text: str, base_url: str):
    """→ (segments, variant_urls). Media playlists fill segments; master
    playlists fill variants (bandwidth, url)."""
    segments: List[_Segment] = []
    variants = []
    duration = 0.0
    key_url = None
    iv = None
    seq = 0
    pending_variant_bw = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#EXTM3U"):
            continue
        if line.startswith("#EXT-X-MEDIA-SEQUENCE:"):
            seq = int(line.split(":", 1)[1])
        elif line.startswith("#EXTINF:"):
            duration = float(line.split(":", 1)[1].split(",")[0])
        elif line.startswith("#EXT-X-KEY:"):
            attrs = _attrs(line.split(":", 1)[1])
            if attrs.get("METHOD", "NONE") == "NONE":
                key_url, iv = None, None
            elif attrs.get("METHOD") == "AES-128":
                key_url = _resolve(base_url, attrs["URI"])
                ivs = attrs.get("IV")
                iv = bytes.fromhex(ivs[2:]) if ivs else None
            else:
                raise InvalidData(f"hls: method {attrs.get('METHOD')!r} "
                                  "not supported")
        elif line.startswith("#EXT-X-STREAM-INF:"):
            attrs = _attrs(line.split(":", 1)[1])
            pending_variant_bw = int(attrs.get("BANDWIDTH", 0))
        elif line.startswith("#"):
            continue
        else:
            if pending_variant_bw is not None:
                variants.append((pending_variant_bw,
                                 _resolve(base_url, line)))
                pending_variant_bw = None
            else:
                segments.append(_Segment(_resolve(base_url, line), duration,
                                         key_url, iv, seq))
                seq += 1
    return segments, variants


def _attrs(s: str) -> dict:
    """Split `K=V,K2="v,2"` attribute lists (quotes protect commas)."""
    out = {}
    in_q = False
    cur: List[str] = []
    parts: List[str] = []
    for ch in s:
        if ch == '"':
            in_q = not in_q
        elif ch == "," and not in_q:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    for p in parts:
        if "=" in p:
            k, v = p.split("=", 1)
            out[k.strip()] = v.strip()
    return out


@register_demuxer
class HlsDemuxer(Demuxer):
    name = "hls"
    extensions = ("m3u8", "m3u")

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        if head.startswith(b"#EXTM3U"):
            return 100
        return 0

    def read_header(self) -> None:
        text = self.r.read(1 << 22).decode("utf-8", "replace")
        segments, variants = parse_m3u8(text, self.url or "")
        if variants and not segments:
            # master playlist: take the highest-bandwidth variant
            variants.sort(key=lambda v: v[0])
            url = variants[-1][1]
            sub = avio.open_read(url)
            segments, _ = parse_m3u8(
                sub.read(1 << 22).decode("utf-8", "replace"), url)
            sub.close()
        if not segments:
            raise InvalidData("hls: empty playlist")
        self._segments = segments
        self._keys: dict = {}
        self._idx = 0
        self._cur = self._open_segment(0)
        for st in self._cur.streams:
            self.add_stream(codecpar=st.codecpar.copy(),
                            time_base=st.time_base)

    def _open_segment(self, i: int) -> Demuxer:
        seg = self._segments[i]
        if seg.key_url is None:
            return open_input(seg.url)
        key = self._keys.get(seg.key_url)
        if key is None:
            kr = avio.open_read(seg.key_url)
            key = kr.read(16)
            kr.close()
            if len(key) != 16:
                raise InvalidData("hls: bad AES-128 key")
            self._keys[seg.key_url] = key
        iv = seg.iv if seg.iv is not None else seg.seq.to_bytes(16, "big")
        r = avio.open_read(seg.url)
        ct = r.read(1 << 30)
        r.close()
        from ...utils.aes import cbc_decrypt
        return open_input(io.BytesIO(cbc_decrypt(key, iv, ct)))

    def read_packet(self) -> Packet:
        while True:
            try:
                return self._cur.read_packet()
            except EndOfStream:
                self._cur.close()
                self._idx += 1
                if self._idx >= len(self._segments):
                    raise
                self._cur = self._open_segment(self._idx)


# ---------------------------------------------------------------------------
# Muxer (reference: libavformat/hlsenc.c VOD path): segment via the segment
# muxer machinery, then emit the media playlist at trailer time.

from ..mux import Muxer, register_muxer   # noqa: E402
from .concat_seg import SegmentMuxer      # noqa: E402


@register_muxer
class HlsMuxer(SegmentMuxer):
    """VOD HLS: url is the .m3u8 path; segments land next to it as
    <stem><index>.ts. Options: hls_time (target duration seconds),
    hls_segment_filename (printf pattern)."""

    name = "hls"
    extensions = ("m3u8",)
    flags_no_file = True
    hls_time = 2.0
    hls_segment_filename = ""

    def _write_header(self) -> None:
        self.segment_time = float(self.hls_time)
        stem = self.url[:-5] if self.url.endswith(".m3u8") else self.url
        self._pattern = self.hls_segment_filename or (stem + "%d.ts")
        self._durations: List[float] = []
        self._seg_t0 = None
        self._last_t = None
        self._real_url = self.url
        self.url = self._pattern
        super()._write_header()

    def _write_packet(self, pkt: Packet) -> None:
        st = self.streams[pkt.stream_index]
        if pkt.pts != NOPTS and st.time_base.den:
            t = pkt.pts * st.time_base.num / st.time_base.den
            if self._seg_t0 is None:
                self._seg_t0 = t
            self._last_t = t + (pkt.duration or 0) * st.time_base.num \
                / st.time_base.den
        before = self._seg_idx
        super()._write_packet(pkt)
        if self._seg_idx != before:      # rolled into a new segment
            self._durations.append((self._last_t or 0) - (self._seg_t0 or 0))
            self._seg_t0 = self._last_t

    def _write_trailer(self) -> None:
        super()._write_trailer()
        if self._seg_t0 is not None:
            self._durations.append((self._last_t or 0) - self._seg_t0)
        target = max([d for d in self._durations] + [float(self.hls_time)])
        lines = ["#EXTM3U", "#EXT-X-VERSION:3",
                 f"#EXT-X-TARGETDURATION:{int(target + 0.999)}",
                 "#EXT-X-MEDIA-SEQUENCE:0",
                 "#EXT-X-PLAYLIST-TYPE:VOD"]
        for i, d in enumerate(self._durations):
            lines.append(f"#EXTINF:{max(d, 0):.6f},")
            lines.append(os.path.basename(self._pattern % i
                                          if "%" in self._pattern
                                          else f"{self._pattern}.{i}"))
        lines.append("#EXT-X-ENDLIST")
        with open(self._real_url, "w") as f:
            f.write("\n".join(lines) + "\n")
