"""Packet-level sync queue: the -shortest / limiting-stream logic.

Analog of fftools/sync_queue.c (semantics from its header comment and
sq_send/stream_update_ts/finish_stream, sync_queue.c:54-109,174-260):
every stream is a FIFO ordered by end timestamp; the queue head is the
limiting stream with the smallest head (largest-seen) timestamp, and
only packets that END at or before that head may leave the queue. When
a stream finishes, its final head timestamp becomes the finish line:
any stream whose head reaches it is also finished, and buffered packets
ending beyond it are dropped at flush — so all outputs stop together at
the earliest-ending stream, with bounded buffering in between.

The port's copy of ffmpeg_tpu/cli/sync_queue.py, held equal to it by
tests/test_torch_cli.py.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class _SqStream:
    tb_num: int
    tb_den: int
    head_us: Optional[int] = None       # largest END timestamp seen
    finished: bool = False
    fifo: deque = field(default_factory=deque)


class SyncQueue:
    """All streams are limiting (the -shortest configuration)."""

    def __init__(self):
        self.streams: List[_SqStream] = []
        self.head_finished_us: Optional[int] = None
        self.finished = False

    def add_stream(self, time_base) -> int:
        self.streams.append(_SqStream(time_base.num, time_base.den))
        return len(self.streams) - 1

    def _end_us(self, st: _SqStream, pkt) -> Optional[int]:
        ts = pkt.pts if pkt.pts is not None else pkt.dts
        if ts is None:
            return None
        dur = pkt.duration or 0
        num, den = st.tb_num, st.tb_den
        if pkt.time_base:
            num, den = pkt.time_base.num, pkt.time_base.den
        return (ts + dur) * 1000000 * num // den

    def send(self, idx: int, pkt) -> List[Tuple[int, object]]:
        """Queue a packet; returns (idx, pkt) pairs ready for muxing."""
        st = self.streams[idx]
        if self.finished or st.finished:
            return self._release()
        end = self._end_us(st, pkt)
        if end is not None:
            if st.head_us is None or end > st.head_us:
                st.head_us = end
        st.fifo.append((end, pkt))
        # a stream that caught up with a finished stream's final head is
        # itself finished (stream_update_ts → finish_stream)
        if (self.head_finished_us is not None and st.head_us is not None
                and st.head_us >= self.head_finished_us):
            self._finish_one(idx)
        return self._release()

    def _finish_one(self, idx: int) -> None:
        st = self.streams[idx]
        if st.finished:
            return
        st.finished = True
        if st.head_us is not None:
            if self.head_finished_us is None or \
                    st.head_us < self.head_finished_us:
                self.head_finished_us = st.head_us
        # propagate to streams already past the new finish line
        for j, other in enumerate(self.streams):
            if (not other.finished and other.head_us is not None
                    and self.head_finished_us is not None
                    and other.head_us >= self.head_finished_us):
                self._finish_one(j)
        if all(s.finished for s in self.streams):
            self.finished = True

    def finish(self, idx: int) -> List[Tuple[int, object]]:
        """No more packets for stream idx (EOF or frame limit)."""
        self._finish_one(idx)
        return self._release()

    def finish_all(self) -> List[Tuple[int, object]]:
        for i in range(len(self.streams)):
            self._finish_one(i)
        return self._release()

    def _global_head_us(self) -> Optional[int]:
        head = None
        for st in self.streams:
            if st.head_us is None:
                if st.finished:
                    continue            # empty finished stream: ignore
                return None             # wait for a ts in every stream
            if head is None or st.head_us < head:
                head = st.head_us
        return head

    def _release(self) -> List[Tuple[int, object]]:
        out = []
        head = self._global_head_us()
        if head is None:
            if not self.finished:
                return out
            head = -1                   # everything unreleasable: drop
        for i, st in enumerate(self.streams):
            while st.fifo:
                end, pkt = st.fifo[0]
                ok = end is None or end <= head
                if ok:
                    st.fifo.popleft()
                    out.append((i, pkt))
                elif self.finished:
                    st.fifo.popleft()   # beyond the finish line: drop
                else:
                    break
        return out
