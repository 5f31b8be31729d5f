"""Device timers by CUDA events, frozen from the program's
`ffmpeg_tpu_torch/timing.py` (as of the benchmark's first version) so
that a later change to the program cannot change how it is timed here.

- `cuda_ms`: events around `reps` back-to-back calls; the host queues the
  calls while the card runs them, so a call shorter than its launch is
  timed at the host's launch rate;
- `kernel_ms`: the same, but the card first spins (`torch.cuda._sleep`)
  while the host queues every call, so only the device's time enters.
"""

from __future__ import annotations

import time

SPIN_CYCLES = 50_000_000         # kernel_ms: the card spins ~25 ms first


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of fn() over reps calls, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_ms(fn, reps: int) -> float:
    """Mean device ms per call of fn() over reps back-to-back calls, by
    CUDA events, with the card spinning while the host queues them;
    raises if queueing the calls took longer than half the spin."""
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    ev[1].record()
    t = time.perf_counter()
    ev[2].record()
    for _ in range(reps):
        fn()
    ev[3].record()
    queue_ms = (time.perf_counter() - t) * 1e3
    ev[3].synchronize()
    spin_ms = ev[0].elapsed_time(ev[1])
    if queue_ms > spin_ms / 2:
        raise RuntimeError(f"queueing {reps} calls took {queue_ms:.3f} ms, "
                           f"more than half the {spin_ms:.3f} ms spin")
    return ev[2].elapsed_time(ev[3]) / reps
