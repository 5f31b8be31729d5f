#!/usr/bin/env python
"""Count the PyTorch operator dispatches of the port's H.264 device
stage, per picture, on the CPU: a lower bound for the kernels a card
launches for the same work (views dispatch and launch nothing; most
other operators launch one kernel).  It is what a prediction of the
launch count is made from before a chip run.

It decodes the committed crafted 1920x1088 I P B CABAC stream
(tests/data/port/h264_1080p_cabac.h264, deblocking on) through
open_decoder("h264") on the CPU and prints, per picture: the
dispatches of recon_tpu.reconstruct in all, of its intra wavefront and
of its deblock wavefront, each wavefront's steps and dispatches per
step, and the host parse's time on this CPU (a CPU time, not a device
metric).

Usage (from the repository root; about 15 s):

    python tools/h264_dispatch_count_torch.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from ffmpeg_tpu_torch.codecs.h264 import recon_tpu  # noqa: E402
from ffmpeg_tpu_torch.testing import H264_CABAC, h264_decode  # noqa: E402


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _counted(fn, into):
    """fn, its dispatches appended to `into` per call (an enclosing
    count sees them too)."""
    def wrapped(*a, **k):
        c = _Count()
        with c:
            out = fn(*a, **k)
        into.append(c.n)
        return out
    return wrapped


def main():
    names = ("reconstruct", "_stage_intra", "deblock_wavefront")
    real = {n: getattr(recon_tpu, n) for n in names}
    total, intra, deblock, stats = [], [], [], []
    recon_tpu.reconstruct = _counted(real["reconstruct"], total)
    recon_tpu._stage_intra = _counted(real["_stage_intra"], intra)
    recon_tpu.deblock_wavefront = _counted(real["deblock_wavefront"],
                                           deblock)
    try:
        h264_decode(H264_CABAC.read_bytes(), "cpu", None, stats)
    finally:
        for n, f in real.items():
            setattr(recon_tpu, n, f)
    for i, (st, t, a, d) in enumerate(zip(stats, total, intra, deblock)):
        ia, da = st["intra_steps"], st["deblock_steps"]
        print(f"{H264_CABAC.name} picture {i} (slice type "
              f"{st['slice_type']}): reconstruct {t} dispatches; intra "
              f"wavefront {a} over {ia} steps"
              f" ({a / max(ia, 1):.0f} a step); deblock wavefront {d} over "
              f"{da} steps ({d / max(da, 1):.0f} a step); the rest "
              f"{t - a - d}; host parse {st['host']['parse']:.1f} ms on "
              f"this CPU")


if __name__ == "__main__":
    main()
