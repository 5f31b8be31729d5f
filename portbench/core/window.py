"""The measured window: a closed loop of batches on the host's clock, each
batch completed by a CUDA event recorded after its work.

Batch i's host work starts when the path's `batch()` is called and ends
when its outputs are complete on the device.  An event recorded on an
idle stream right after a synchronize at the window's start ties the
device's clock to the host's, so every completion event reads as a host
time without a synchronize inside the loop.

A seeded reservoir keeps the outputs of `keep` batches, drawn uniformly
from all the window's batches, for the check after the window.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field


@dataclass
class Window:
    seconds: float
    batches: int = 0                  # batches enqueued in the window
    frames_enqueued: int = 0
    frames_done: int = 0              # frames of batches done in the window
    latencies_s: list = field(default_factory=list)
    kept: list = field(default_factory=list)   # (batch, outputs, frame ids)

    @property
    def frames_per_s(self) -> float:
        return self.frames_done / self.seconds

    def p95_ms(self) -> float:
        """Nearest-rank 95th percentile of the batches' latencies."""
        lat = sorted(self.latencies_s)
        if not lat:
            raise RuntimeError("no batch completed inside the window")
        return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3


def _sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def run_window(path, seconds: float, keep: int, seed: int,
               device) -> Window:
    """Call `path.batch()` until `seconds` have passed on the host's clock;
    `path.batch()` returns (outputs, frame ids) and bounds the batches in
    flight itself."""
    import torch
    cuda = device.type == "cuda"
    rng = random.Random(seed)
    w = Window(seconds)
    starts, ends, sizes = [], [], []
    _sync(device)
    t0 = time.perf_counter()
    if cuda:
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
    while time.perf_counter() - t0 < seconds:
        ts = time.perf_counter()
        outs, ids = path.batch()
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:                              # CPU ops finish before they return
            ev = time.perf_counter()
        starts.append(ts)
        ends.append(ev)
        sizes.append(len(ids))
        i = w.batches
        if len(w.kept) < keep:
            w.kept.append((i, outs, ids))
        else:
            j = rng.randrange(i + 1)
            if j < keep:
                w.kept[j] = (i, outs, ids)
        w.batches += 1
    _sync(device)
    end = t0 + seconds
    for ts, ev, n in zip(starts, ends, sizes):
        done = t0 + e0.elapsed_time(ev) / 1e3 if cuda else ev
        w.frames_enqueued += n
        if done <= end:
            w.frames_done += n
            w.latencies_s.append(done - ts)
    return w
