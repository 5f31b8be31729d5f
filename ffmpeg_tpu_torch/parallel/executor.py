"""Priority task-graph executor (analog of libavutil/executor.c:142-195
+ the VVC per-CTU scheduler vvc/thread.h:28) — the P4 parallelism
strategy from SURVEY §2.9.

Tasks carry a priority and a readiness check; `Executor.submit` makes a
task visible, workers repeatedly pick the highest-priority READY task
and run it. A task's `run` callback typically completes a pipeline
stage and then re-submits the task at the next stage (or submits its
dependents) — the same dependency-counting dataflow the reference's
VVC decoder drives per CTU (parse → intra → reconstruct → filter).

The executor schedules host work (entropy decode, parameter derivation,
the VVC decoder's numpy reconstruction per CTU) in Python threads; the
stages on the card are queued behind it by whoever submits them.  The
dependency logic is identical either way.

The port's copy of ffmpeg_tpu/parallel/executor.py, held equal to it by
tests/test_torch_vvc.py.
"""

from __future__ import annotations

import heapq
import threading
from typing import Callable, List, Optional


class Task:
    """One schedulable unit (AVTask analog). Subclass or pass
    callables: `ready()` says whether the task can run now; `run()`
    does the work and may submit more tasks."""

    __slots__ = ("priority", "run", "ready", "_seq")

    def __init__(self, run: Callable[[], None], priority: int = 0,
                 ready: Optional[Callable[[], bool]] = None):
        self.priority = priority
        self.run = run
        self.ready = ready or (lambda: True)
        self._seq = 0

    def __lt__(self, other):
        return (self.priority, self._seq) < (other.priority,
                                             other._seq)


class Executor:
    """av_executor_alloc/execute analog: N worker threads draining a
    priority queue of ready tasks. Tasks whose `ready()` is false are
    parked and re-examined whenever any task completes (the
    reference's ready-callback wakeup, executor.c:142-195)."""

    def __init__(self, workers: int = 2):
        self._cv = threading.Condition()
        self._heap: List[Task] = []
        self._parked: List[Task] = []
        self._seq = 0
        self._pending = 0            # submitted but not finished
        self._error: Optional[BaseException] = None
        self._quit = False
        self._threads = [threading.Thread(target=self._work,
                                          daemon=True)
                         for _ in range(max(1, workers))]
        for t in self._threads:
            t.start()

    # ----------------------------------------------------------- api
    def submit(self, task: Task) -> None:
        """av_executor_execute analog."""
        with self._cv:
            self._seq += 1
            task._seq = self._seq
            self._pending += 1
            if task.ready():
                heapq.heappush(self._heap, task)
            else:
                self._parked.append(task)
            self._cv.notify()

    def wait(self) -> None:
        """Block until every submitted task has finished; re-raises
        the first worker exception."""
        with self._cv:
            while self._pending and self._error is None:
                self._cv.wait(timeout=0.5)
            if self._error is not None:
                err = self._error
                self._error = None
                raise err

    def close(self) -> None:
        with self._cv:
            self._quit = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------- workers
    def _next_ready_locked(self) -> Optional[Task]:
        # wake parked tasks whose deps resolved
        still = []
        for t in self._parked:
            if t.ready():
                heapq.heappush(self._heap, t)
            else:
                still.append(t)
        self._parked = still
        if self._heap:
            return heapq.heappop(self._heap)
        return None

    def _work(self) -> None:
        while True:
            with self._cv:
                task = None
                while task is None:
                    if self._quit or self._error is not None:
                        return
                    task = self._next_ready_locked()
                    if task is None:
                        self._cv.wait(timeout=0.2)
            try:
                task.run()
            except BaseException as e:   # noqa: BLE001
                with self._cv:
                    self._error = e
                    self._pending -= 1
                    self._cv.notify_all()
                return
            with self._cv:
                self._pending -= 1
                # completion may unblock parked tasks
                self._cv.notify_all()
