"""framesync — N-input frame aligner (the port's copy of
ffmpeg_tpu/filters/framesync.py; reference: libavfilter/framesync.c).

Pairs frames from multiple inputs by presentation time: the FIRST input
is the sync master; for every master frame each secondary input
contributes its latest frame with pts <= master pts (EOF_MODE repeat —
the reference's ts_sync_mode default for overlay-style filters).
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional

from ..core.frame import Frame
from ..utils.rational import Rational


def _pts_sec(frame: Frame) -> float:
    tb = frame.time_base or Rational(1, 25)
    pts = frame.pts if frame.pts is not None else 0
    return pts * tb.num / tb.den


class FrameSync:
    """Feed frames per input pad; events() yields aligned tuples."""

    def __init__(self, n_inputs: int):
        self.n = n_inputs
        self.queues: List[deque] = [deque() for _ in range(n_inputs)]
        self.latest: List[Optional[Frame]] = [None] * n_inputs
        self.eof = [False] * n_inputs

    def push(self, frame: Optional[Frame], pad: int) -> None:
        if frame is None:
            self.eof[pad] = True
        else:
            self.queues[pad].append(frame)

    def _secondary_ready(self, t: float, pad: int) -> bool:
        """A secondary can serve time t when its next queued frame is
        beyond t (so `latest` is final for t) or it hit EOF."""
        q = self.queues[pad]
        while q and _pts_sec(q[0]) <= t:
            self.latest[pad] = q.popleft()
        if q or self.eof[pad]:
            return True
        # not yet decidable unless we have no frame at all and EOF
        return self.latest[pad] is not None and not q and self.eof[pad]

    def events(self) -> List[List[Frame]]:
        out = []
        while self.queues[0]:
            master = self.queues[0][0]
            t = _pts_sec(master)
            group = [master]
            ok = True
            for pad in range(1, self.n):
                if not self._secondary_ready(t, pad):
                    ok = False
                    break
                group.append(self.latest[pad])
            if not ok:
                break
            self.queues[0].popleft()
            out.append(group)
        return out
