"""Demuxer framework (analog of libavformat/demux.c).

Reference behaviors kept: probe-score format autodetection (demux.c:132-177),
open by name override, packet iteration with per-stream time bases, generic
seek. Demuxers are host-only Python; registration is declarative like
FFInputFormat (demux.h:66).

The port's copy of ffmpeg_tpu/io/demux.py, held equal to it by
tests/test_torch_io_formats.py.  The registry holds the formats that
io/__init__.py imports and the obu demuxer of codecs/av1.py.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Type

from ..core.packet import Packet
from ..utils.error import (DemuxerNotFound, EndOfStream, FFTPUError,
                           InvalidData)
from ..utils.log import LogMixin
from ..utils.rational import NOPTS, Rational, rescale_q
from . import avio
from .stream import StreamInfo

PROBE_SCORE_MAX = 100
PROBE_SCORE_EXTENSION = 50

_DEMUXERS: Dict[str, Type["Demuxer"]] = {}


def register_demuxer(cls: Type["Demuxer"]) -> Type["Demuxer"]:
    _DEMUXERS[cls.name] = cls
    return cls


def demuxer_names() -> List[str]:
    return sorted(_DEMUXERS)


class Demuxer(LogMixin):
    """Base input format. Subclasses set `name`, `extensions`, implement
    `probe(head)->score`, `read_header()`, `read_packet()->Packet`."""

    name = "?"
    long_name = ""
    extensions: tuple = ()
    mime_types: tuple = ()
    flags_no_file = False

    def __init__(self, r: avio.Reader, url: str = ""):
        self.r = r
        self.url = url
        self.streams: List[StreamInfo] = []
        self.metadata: Dict[str, str] = {}
        self.chapters: List = []       # (id, start_ms, end_ms, metadata)
        self.duration = NOPTS          # in AV_TIME_BASE (microseconds)
        self.start_time = NOPTS
        self.bit_rate = 0
        self.log_name = self.name

    # --- interface ------------------------------------------------------------
    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        return 0

    def read_header(self) -> None:
        raise NotImplementedError

    def read_packet(self) -> Packet:
        """Next packet in file order; raises EndOfStream at EOF."""
        raise NotImplementedError

    def seek(self, stream_index: int, ts: int, flags: int = 0) -> None:
        """Default: the generic read-based seek (the index-less fallback
        of libavformat/seek.c): rewind, re-read the header, and scan
        forward queueing from the last keyframe at-or-before ts."""
        self.seek_generic(stream_index, ts, flags)

    def seek_generic(self, stream_index: int, ts: int,
                     flags: int = 0) -> None:
        from collections import deque
        if not getattr(self.r, "seekable", True):
            raise InvalidData(f"{self.name}: input not seekable")
        self.r.seek(0)
        self.streams.clear()
        self.metadata.clear()
        self.read_header()
        group: List[Packet] = []
        while True:
            try:
                pkt = self.read_packet()
            except EndOfStream:
                break
            is_target = pkt.stream_index == stream_index
            pts = pkt.pts if pkt.pts is not None else pkt.dts
            if is_target and (pkt.flags & 1) and \
                    (pts is None or pts <= ts):
                group = [pkt]          # newest keyframe at-or-before ts
                continue
            if not group:
                if is_target:          # no keyframe seen yet: keep all
                    group = [pkt]
                continue
            group.append(pkt)
            if is_target and pts is not None and pts >= ts:
                break                  # reached the target timestamp
        self._seek_buf = deque(group)

    def _next_packet(self) -> Packet:
        buf = getattr(self, "_seek_buf", None)
        if buf:
            return buf.popleft()
        try:
            return self.read_packet()
        except FFTPUError:
            raise
        except (MemoryError, RecursionError, KeyboardInterrupt,
                SystemExit):
            raise
        except Exception as e:      # noqa: BLE001 — contract boundary
            # demux.c contract: malformed containers produce
            # AVERROR_INVALIDDATA, never crash the caller
            raise InvalidData(
                f"{type(self).__name__}: malformed input "
                f"({type(e).__name__}: {e})") from e

    def close(self) -> None:
        if self.r is not None:
            self.r.close()

    # --- helpers ----------------------------------------------------------------
    def add_stream(self, **kw) -> StreamInfo:
        st = StreamInfo(index=len(self.streams), **kw)
        self.streams.append(st)
        return st

    def packets(self) -> Iterator[Packet]:
        while True:
            try:
                yield self._next_packet()
            except EndOfStream:
                return

    def stream_of(self, pkt: Packet) -> StreamInfo:
        return self.streams[pkt.stream_index]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _ext_of(url: str) -> str:
    base = str(url).rsplit("/", 1)[-1]
    return base.rsplit(".", 1)[-1].lower() if "." in base else ""


def probe_format(head: bytes, filename: str = "") -> Optional[Type[Demuxer]]:
    """Score all registered demuxers (av_probe_input_format analog)."""
    best, best_score = None, 0
    ext = _ext_of(filename)
    for cls in _DEMUXERS.values():
        score = cls.probe(head, filename)
        if score == 0 and ext and ext in cls.extensions:
            score = PROBE_SCORE_EXTENSION
        if score > best_score:
            best, best_score = cls, score
    return best



def _read_header_guarded(d):
    try:
        d.read_header()
    except FFTPUError:
        raise
    except (MemoryError, RecursionError, KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:          # noqa: BLE001 — contract boundary
        raise InvalidData(
            f"{type(d).__name__}: malformed header "
            f"({type(e).__name__}: {e})") from e
    return d


def open_input(url, format: Optional[str] = None, **options) -> Demuxer:
    """avformat_open_input analog: probe (or take explicit format), read
    header, return ready demuxer."""
    if format is not None:
        cls = _DEMUXERS.get(format)
        if cls is None:
            raise DemuxerNotFound(format)
        if cls.flags_no_file:
            d = cls(None, url=str(url))
            for k, v in options.items():
                setattr(d, k, v)
            _read_header_guarded(d)
            return d
        r = avio.open_read(url)
    elif isinstance(url, str) and ("%" in url or "*" in url):
        cls = _DEMUXERS["image2"]
        d = cls(None, url=url)
        for k, v in options.items():
            setattr(d, k, v)
        _read_header_guarded(d)
        return d
    elif isinstance(url, str) and url.startswith("rtsp://"):
        d = _DEMUXERS["rtsp"](None, url=url)
        for k, v in options.items():
            setattr(d, k, v)
        _read_header_guarded(d)
        return d
    else:
        r = avio.open_read(url)
    if format is None:
        head = r.peek(4096)
        cls = probe_format(head, str(url))
        if cls is None:
            raise DemuxerNotFound(f"could not determine format of {url!r}")
    d = cls(r, url=str(url))
    for k, v in options.items():
        setattr(d, k, v)
    _read_header_guarded(d)
    return d
