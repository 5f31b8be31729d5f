#!/usr/bin/env python3
"""Count the PyTorch operations each video-filter chain of chip_smoke.py
phase 24 (ffmpeg_tpu_torch.testing.FILTER_CHAINS) dispatches per input
frame: the kernels an eager run launches on a card, one per op, less
the views, which launch none.  The counts depend on the graph, not on
the device or the size, so this runs on the CPU at a small size.

    python3 tools/filter_ops_count_torch.py [--size 192x108]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from ffmpeg_tpu_torch import testing as fx  # noqa: E402
from ffmpeg_tpu_torch.filters import parse_graph  # noqa: E402

# ops that return a view of their input and launch no kernel
VIEWS = {"view", "_unsafe_view", "expand", "slice", "select", "narrow",
         "alias", "as_strided", "t", "transpose", "permute", "unsqueeze",
         "squeeze", "detach", "lift_fresh", "_reshape_alias", "unbind",
         "split"}


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] not in VIEWS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="192x108")
    w, h = (int(x) for x in ap.parse_args().size.split("x"))
    for chain in fx.FILTER_CHAINS:
        feeds = fx.filter_chain_inputs(chain, w, h)
        count = _Count()
        with count:
            fx.run_graph(parse_graph(chain.graph_text(), device="cpu"),
                         feeds, chain.outs, chain.eof_early)
        n = len(feeds[chain.inputs[0][0]])
        print(f"{chain.name:20s} {count.n / n:8.1f} ops per input frame "
              f"({count.n} over {n})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
