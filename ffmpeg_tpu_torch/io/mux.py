"""Muxer framework (analog of libavformat/mux.c).

Keeps the reference's lifecycle (write_header / write_packet / write_trailer,
mux.c:478,722,746) and DTS interleaving semantics (interleave_packet): packets
from multiple streams are buffered and emitted in monotonically increasing
DTS order compared across time bases.

The port's copy of ffmpeg_tpu/io/mux.py, held equal to it by
tests/test_torch_io_formats.py.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Type

from ..core.packet import Packet
from ..utils.error import InvalidData, MuxerNotFound
from ..utils.log import LogMixin
from ..utils.rational import NOPTS, Rational, compare_ts, rescale_q
from . import avio
from .stream import CodecParameters, StreamInfo

_MUXERS: Dict[str, Type["Muxer"]] = {}


def register_muxer(cls: Type["Muxer"]) -> Type["Muxer"]:
    _MUXERS[cls.name] = cls
    return cls


def muxer_names() -> List[str]:
    return sorted(_MUXERS)


class Muxer(LogMixin):
    name = "?"
    long_name = ""
    extensions: tuple = ()
    # default codecs for stream setup (like FFOutputFormat audio/video_codec)
    default_video_codec: Optional[str] = None
    default_audio_codec: Optional[str] = None
    interleave = True
    flags_no_file = False     # muxer manages its own file(s) (segment/image2)

    def __init__(self, w: avio.Writer, url: str = ""):
        self.w = w
        self.url = url
        self.streams: List[StreamInfo] = []
        self.metadata: Dict[str, str] = {}
        self.log_name = self.name
        self._queue: list = []
        self._seq = 0
        self._header_written = False
        self.bitexact = True

    # --- stream setup ----------------------------------------------------------
    def add_stream(self, codecpar: CodecParameters,
                   time_base: Optional[Rational] = None, **kw) -> StreamInfo:
        st = StreamInfo(index=len(self.streams), codecpar=codecpar.copy(),
                        time_base=time_base or Rational(1, 90000), **kw)
        self.streams.append(st)
        return st

    # --- interface ----------------------------------------------------------------
    def write_header(self) -> None:
        self._write_header()
        self._header_written = True

    def _write_header(self) -> None:
        raise NotImplementedError

    def _write_packet(self, pkt: Packet) -> None:
        raise NotImplementedError

    def _write_trailer(self) -> None:
        pass

    # --- packet path (av_interleaved_write_frame analog) -----------------------
    def write_packet(self, pkt: Optional[Packet]) -> None:
        """pkt with stream_index + timestamps in that stream's time_base;
        None flushes the interleaving queue."""
        if not self._header_written:
            self.write_header()
        if pkt is None:
            self._flush_queue(all_out=True)
            return
        if not self.interleave or len(self.streams) <= 1:
            self._write_packet(pkt)
            return
        key = pkt.dts if pkt.dts != NOPTS else pkt.pts
        heapq.heappush(self._queue, (_TsKey(key, self.streams[pkt.stream_index].time_base),
                                     self._seq, pkt))
        self._seq += 1
        self._flush_queue(all_out=False)

    def _flush_queue(self, all_out: bool) -> None:
        # emit while every stream has something queued (or draining)
        while self._queue:
            if not all_out:
                queued_streams = {p.stream_index for _, _, p in self._queue}
                if len(queued_streams) < len(self.streams):
                    break
            _, _, pkt = heapq.heappop(self._queue)
            self._write_packet(pkt)

    def write_trailer(self) -> None:
        self._flush_queue(all_out=True)
        self._write_trailer()
        self.w.flush()

    def close(self) -> None:
        self.w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.write_trailer()
        self.close()


class _TsKey:
    """Orderable timestamp across time bases."""

    __slots__ = ("ts", "tb")

    def __init__(self, ts, tb):
        self.ts = ts if ts != NOPTS else 0
        self.tb = tb

    def __lt__(self, other):
        return compare_ts(self.ts, self.tb, other.ts, other.tb) < 0


def _guess_format(url: str) -> Optional[Type[Muxer]]:
    ext = str(url).rsplit(".", 1)[-1].lower() if "." in str(url) else ""
    for cls in _MUXERS.values():
        if ext and ext in cls.extensions:
            return cls
    return None


def open_output(url, format: Optional[str] = None, **kw) -> Muxer:
    if format is not None:
        cls = _MUXERS.get(format)
        if cls is None:
            raise MuxerNotFound(format)
    else:
        cls = _guess_format(url)
        if cls is None:
            raise MuxerNotFound(f"cannot guess output format for {url!r}")
    if cls.flags_no_file:
        import io as _io
        w = avio.Writer(_io.BytesIO(), owns=True)
    else:
        w = avio.open_write(url)
    m = cls(w, url=str(url))
    for k, v in kw.items():
        setattr(m, k, v)
    return m
