"""Concat demuxer + segment muxer (analogs of libavformat/concatdec.c and
segment.c) — playlist-style input and resumable segmented output, the
checkpoint/restart story from SURVEY.md §5.

The port's copy of ffmpeg_tpu/io/formats/concat_seg.py, held equal to it by
tests/test_torch_io_streaming.py.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ...core.packet import Packet
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import NOPTS, Rational, rescale_q
from ..demux import Demuxer, register_demuxer, open_input
from ..mux import Muxer, register_muxer, open_output, _MUXERS
from ..stream import CodecParameters


@register_demuxer
class ConcatDemuxer(Demuxer):
    """ffconcat playlists: lines of `file <path>`; streams must match."""

    name = "concat"
    extensions = ("ffconcat", "concat")

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        return 80 if head.startswith(b"ffconcat version 1.0") else 0

    def read_header(self) -> None:
        base = os.path.dirname(self.url) if self.url else "."
        self._files: List[str] = []
        text = self.r.read(1 << 20).decode("utf-8", "replace")
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("ffconcat"):
                continue
            if line.startswith("file "):
                path = line[5:].strip().strip("'\"")
                if not os.path.isabs(path):
                    path = os.path.join(base, path)
                self._files.append(path)
        if not self._files:
            raise InvalidData("concat: no files")
        self._idx = 0
        self._cur = open_input(self._files[0])
        for st in self._cur.streams:
            self.add_stream(codecpar=st.codecpar.copy(),
                            time_base=st.time_base)
        self._offsets = [0] * len(self.streams)   # pts offset per stream
        self._maxes = [0] * len(self.streams)

    def read_packet(self) -> Packet:
        while True:
            try:
                pkt = self._cur.read_packet()
                if pkt.pts != NOPTS:
                    pkt.pts += self._offsets[pkt.stream_index]
                    if pkt.dts != NOPTS:
                        pkt.dts += self._offsets[pkt.stream_index]
                    self._maxes[pkt.stream_index] = max(
                        self._maxes[pkt.stream_index],
                        pkt.pts + (pkt.duration or 1))
                return pkt
            except EndOfStream:
                self._cur.close()
                self._idx += 1
                if self._idx >= len(self._files):
                    raise
                self._offsets = list(self._maxes)
                self._cur = open_input(self._files[self._idx])


@register_muxer
class SegmentMuxer(Muxer):
    """Split output into timed segments: url must contain %d; options:
    segment_time (seconds), segment_format (inner muxer name)."""

    name = "segment"
    flags_no_file = True
    segment_time = 2.0
    segment_format = "mpegts"
    interleave = False

    def _write_header(self) -> None:
        self._seg_idx = 0
        self._seg_start_ts = None
        self._inner: Optional[Muxer] = None
        self._open_segment()

    def _open_segment(self) -> None:
        if self._inner is not None:
            self._inner.write_trailer()
            self._inner.close()
        path = self.url % self._seg_idx if "%" in self.url else \
            f"{self.url}.{self._seg_idx}"
        fmt = self.segment_format
        if fmt == "mpegts" and "mpegts" not in _MUXERS:
            fmt = "mov"
        self._inner = open_output(path, format=fmt)
        for st in self.streams:
            self._inner.add_stream(st.codecpar, time_base=st.time_base)
        self._seg_idx += 1
        self._seg_start_ts = None

    def _write_packet(self, pkt: Packet) -> None:
        st = self.streams[pkt.stream_index]
        if pkt.pts != NOPTS and st.time_base.den:
            t = pkt.pts * st.time_base.num / st.time_base.den
            if self._seg_start_ts is None:
                self._seg_start_ts = t
            elif pkt.is_keyframe and pkt.stream_index == 0 and \
                    t - self._seg_start_ts >= float(self.segment_time):
                self._open_segment()
                self._seg_start_ts = t
        self._inner.write_packet(pkt)

    def _write_trailer(self) -> None:
        if self._inner is not None:
            self._inner.write_trailer()
            self._inner.close()
            self._inner = None
