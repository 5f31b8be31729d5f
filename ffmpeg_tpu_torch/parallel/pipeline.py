"""Host dataflow pipeline (analog of fftools' Scheduler, ffmpeg_sched.c).

One thread per stage connected by bounded queues — demux → entropy-decode →
device transform → mux — so the serial host work (container parsing,
Huffman/CABAC) overlaps the work queued on the card (the flagship's
run_batch: K1 and the reconstruction's contractions), the P5 strategy
from SURVEY.md §2.9. Backpressure is the bounded queue itself (the
reference's DTS-choke generalization is unnecessary with single-output
pipelines; multi-output sync lives in the muxer's interleaving queue).

The port's copy of ffmpeg_tpu/parallel/pipeline.py, held equal to it by
tests/test_torch_vvc.py.
"""

from __future__ import annotations

import queue
import threading
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Iterable, List, Optional

_EOF = object()


@dataclass
class StageStats:
    name: str = ""
    items: int = 0
    busy_s: float = 0.0


class Pipeline:
    """pipeline = Pipeline([gen_fn, map_fn1, map_fn2, ...]) ; run() drives
    items from the generator through each mapping stage in its own thread.

    A stage is either the source (an iterable/generator) or a callable
    item → item | list[item] | None (None drops). The final stage's results
    are yielded by run()."""

    def __init__(self, source: Iterable, stages: List[Callable],
                 queue_size: int = 8, names: Optional[List[str]] = None):
        self.source = source
        self.stages = stages
        self.queue_size = queue_size
        self.names = names or [f"stage{i}" for i in range(len(stages))]
        self.stats = [StageStats(n) for n in ["source"] + self.names]
        self._error: Optional[BaseException] = None

    def run(self):
        """Generator of final-stage outputs."""
        import time
        qs = [queue.Queue(self.queue_size) for _ in range(len(self.stages) + 1)]
        threads = []

        def src_worker():
            try:
                t0 = time.monotonic()
                for item in self.source:
                    self.stats[0].items += 1
                    qs[0].put(item)
                self.stats[0].busy_s = time.monotonic() - t0
            except BaseException as e:   # noqa: BLE001
                self._error = e
            finally:
                qs[0].put(_EOF)

        def stage_worker(i, fn):
            try:
                while True:
                    item = qs[i].get()
                    if item is _EOF:
                        break
                    t0 = time.monotonic()
                    out = fn(item)
                    self.stats[i + 1].busy_s += time.monotonic() - t0
                    self.stats[i + 1].items += 1
                    if out is None:
                        continue
                    if isinstance(out, list):
                        for o in out:
                            qs[i + 1].put(o)
                    else:
                        qs[i + 1].put(out)
            except BaseException as e:   # noqa: BLE001
                self._error = e
            finally:
                qs[i + 1].put(_EOF)

        threads.append(threading.Thread(target=src_worker, daemon=True))
        for i, fn in enumerate(self.stages):
            threads.append(threading.Thread(target=stage_worker,
                                            args=(i, fn), daemon=True))
        for t in threads:
            t.start()
        while True:
            item = qs[-1].get()
            if item is _EOF:
                break
            yield item
        for t in threads:
            t.join(timeout=30)
        if self._error is not None:
            raise self._error


def batched(iterable: Iterable, n: int) -> Iterable[list]:
    """Group items into lists of n (tail may be short)."""
    buf: list = []
    for item in iterable:
        buf.append(item)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf


class Scheduler:
    """Multi-output dataflow scheduler with the reference's DTS-choke
    backpressure (ffmpeg_sched.c:1446-1497 schedule_update_locked +
    ffmpeg_sched.h:30-89 architecture notes).

    One thread per output branch, bounded packet queues between the
    source and each branch. The source is CHOKED (blocked) whenever
    pushing the next packet would let the fastest output run more than
    `tolerance` DTS units ahead of the trailing output — the policy
    that keeps multi-output memory bounded in TIME, not just in
    packets: a slow sink caps how far every other branch may advance,
    so queues cannot grow without bound even when one output consumes
    packets at a very different per-packet rate.

    Usage:
        sch = Scheduler(tolerance=64)
        sch.add_output("fast", fast_sink)
        sch.add_output("slow", slow_sink)
        sch.run(packets, dts_of=lambda p: p.dts)
    Each sink_fn is called once per packet, in order, on its own
    thread. Exceptions propagate to run().
    """

    def __init__(self, tolerance: int = 64, queue_size: int = 8):
        self.tolerance = tolerance
        self.queue_size = queue_size
        self._outputs: List[tuple] = []
        self._error: Optional[BaseException] = None
        self.max_queued = 0               # high-water mark, for tests

    def add_output(self, name: str, sink_fn: Callable[[Any], None]):
        self._outputs.append((name, sink_fn))

    def run(self, source: Iterable, dts_of: Callable[[Any], int]):
        n = len(self._outputs)
        if n == 0:
            return
        qs = [queue.Queue(self.queue_size) for _ in range(n)]
        # last DTS fully consumed by each output (None = none yet)
        done_dts: List[Optional[int]] = [None] * n
        cv = threading.Condition()

        def out_worker(i, sink):
            try:
                while True:
                    item = qs[i].get()
                    if item is _EOF:
                        break
                    sink(item)
                    with cv:
                        done_dts[i] = dts_of(item)
                        cv.notify_all()
            except BaseException as e:   # noqa: BLE001
                self._error = e
                with cv:
                    done_dts[i] = None
                    cv.notify_all()

        threads = [threading.Thread(target=out_worker, args=(i, s),
                                    daemon=True)
                   for i, (_, s) in enumerate(self._outputs)]
        for t in threads:
            t.start()
        try:
            for pkt in source:
                dts = dts_of(pkt)
                # choke: wait until the trailing output is within
                # tolerance of the packet about to be distributed
                with cv:
                    def trailing():
                        vals = [d for d in done_dts]
                        if any(v is None for v in vals):
                            # an output with nothing consumed yet only
                            # counts once packets are in flight
                            vals = [v if v is not None else -1
                                    for v in vals]
                        return min(vals)

                    while (self._error is None
                           and dts - trailing() > self.tolerance
                           and trailing() >= 0):
                        cv.wait(timeout=1.0)
                if self._error is not None:
                    break
                for i in range(n):
                    qs[i].put(pkt)
                self.max_queued = max(self.max_queued,
                                      max(q.qsize() for q in qs))
        finally:
            for q in qs:
                q.put(_EOF)
            for t in threads:
                t.join(timeout=30)
        if self._error is not None:
            raise self._error
