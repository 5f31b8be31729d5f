#!/usr/bin/env python
"""Write the video filters' golden that the PyTorch port is checked
against on the card (chip_smoke.py phase 24).

Runs the JAX package on the CPU over the chains of
ffmpeg_tpu_torch.testing.FILTER_CHAINS and the sources of
FILTER_SOURCES at 1920x1080, on the seeded frames of
testing.filter_clip (made from a seed on every machine, not committed),
and writes:

- tests/data/port/filters_5.cube, the chains' 5-point LUT
  (testing.cube_text);
- tests/data/port/filters_1080p_golden.npz, for each chain and output
  label `<chain>/<out>`:
  - `meta`: a JSON list with each output frame's pts, size, format and
    plane shapes and types;
  - for a chain whose bar is exact: `sha256`, each plane's sha256
    (frames, planes);
  - for the others: `tl<i>` and `br<i>`, plane i of frame 0 in its
    top-left and bottom-right corners of testing.CORNER x CORNER luma
    samples (testing.corner_size: fewer on a subsampled plane);
  and `<chain>/scores`, a JSON dict of the metric filters' scores; for
  each source `source/<name>/...` in the same way.

The card's machine has no JAX, so the reference's answers are committed.
Usage (about four minutes here, most of it the reference's numpy median,
atadenoise and colorspace at 1080p):

    JAX_PLATFORMS=cpu python tools/gen_torch_filters_fixture.py
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from ffmpeg_tpu.core.frame import Frame  # noqa: E402
from ffmpeg_tpu.filters import get_filter, parse_graph  # noqa: E402
from ffmpeg_tpu.utils.rational import Rational  # noqa: E402
from ffmpeg_tpu_torch import testing as fx  # noqa: E402

W, H = 1920, 1080


def _record(out: dict, key: str, frames: list, bar: str) -> None:
    meta = []
    for f in frames:
        planes = [np.asarray(p) for p in f.planes]
        meta.append({"pts": int(f.pts), "size": [f.width, f.height],
                     "format": f.format,
                     "planes": [[list(p.shape), p.dtype.str]
                                for p in planes]})
    out[f"{key}/meta"] = np.array(json.dumps(meta))
    if bar == "exact":
        out[f"{key}/sha256"] = np.array(
            [[hashlib.sha256(np.ascontiguousarray(p).tobytes()).hexdigest()
              for p in map(np.asarray, f.planes)] for f in frames])
        return
    for i, p in enumerate(map(np.asarray, frames[0].planes)):
        ch, cw = fx.corner_size(frames[0].format, i)
        out[f"{key}/tl{i}"] = np.ascontiguousarray(p[:ch, :cw])
        out[f"{key}/br{i}"] = np.ascontiguousarray(p[-ch:, -cw:])


def main() -> int:
    fx.FILTER_CUBE.write_text(fx.cube_text())
    out = {}
    for chain in fx.FILTER_CHAINS:
        t = time.time()
        feeds = fx.filter_chain_inputs(chain, W, H, (Frame, Rational))
        g = parse_graph(chain.graph_text())
        got = fx.run_graph(g, feeds, chain.outs, chain.eof_early)
        for o in chain.outs:
            _record(out, f"{chain.name}/{o}", got[o], chain.bar)
        out[f"{chain.name}/scores"] = np.array(json.dumps(
            fx.chain_scores(g, chain)))
        print(f"{chain.name}: {[len(got[o]) for o in chain.outs]} frames "
              f"in {time.time() - t:.1f} s", flush=True)
    for name, args, n, bar in fx.FILTER_SOURCES:
        src = get_filter(name)(":".join(a for a in (args, f"size={W}x{H}")
                                        if a))
        _record(out, f"source/{name}", list(src.generate(n)), bar)
    np.savez_compressed(fx.FILTERS_GOLDEN, **out)
    print(f"wrote {fx.FILTERS_GOLDEN} "
          f"({fx.FILTERS_GOLDEN.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
