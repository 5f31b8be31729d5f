#!/usr/bin/env python
"""Count the PyTorch operator dispatches of the port's HEVC device stage,
per picture, on the CPU: a lower bound for the kernels a card launches
for the same work (views dispatch and launch nothing; most other
operators launch one kernel).  It is what a prediction of the launch
count is made from before a chip run.

For each committed 1920x1080 stream (the bench stream, deblock and SAO
off; the crafted SAO + deblock stream) it decodes through
open_decoder("hevc") on the CPU and prints, per picture: its intra
dependency levels, the dispatches of recon_tpu.reconstruct and of
filter_tpu.filters_tpu, and the host parse's time on this CPU (a CPU
time, not a device metric).

Usage (from the repository root; about 30 s):

    python tools/hevc_dispatch_count_torch.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from ffmpeg_tpu_torch.codecs import hevc as H  # noqa: E402
from ffmpeg_tpu_torch.codecs.hevc import recon_tpu  # noqa: E402
from ffmpeg_tpu_torch.testing import (HEVC_BENCH, HEVC_SAO,  # noqa: E402
                                      hevc_decode)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _counted(fn, into):
    def wrapped(*a, **k):
        c = _Count()
        with c:
            out = fn(*a, **k)
        into.append(c.n)
        return out
    return wrapped


def main():
    real_r, real_f = recon_tpu.reconstruct, H.filters_tpu
    for path in (HEVC_BENCH, HEVC_SAO):
        recon, filt, stats = [], [], []
        recon_tpu.reconstruct = _counted(real_r, recon)
        H.filters_tpu = _counted(real_f, filt)
        try:
            hevc_decode(path.read_bytes(), "cpu", None, stats)
        finally:
            recon_tpu.reconstruct, H.filters_tpu = real_r, real_f
        for i, (st, r, f) in enumerate(zip(stats, recon, filt)):
            print(f"{path.name} picture {i} (slice type "
                  f"{st['slice_type']}, {st['levels']} intra levels): "
                  f"reconstruct {r} dispatches, filters_tpu {f}; host "
                  f"parse {st['host']['parse']:.1f} ms on this CPU")


if __name__ == "__main__":
    main()
