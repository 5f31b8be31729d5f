#!/usr/bin/env python
"""Write tests/data/port/vvc_av1_streams.npz, the crafted VVC and AV1
streams that chip_smoke.py's phase 30 and the port's tests read.

The JAX package's own writers make them on the CPU:

- each GOP of ffmpeg_tpu_torch.testing.VVC_GOPS (the 832x480 low-delay
  I P B B with MTT and two references in each list, and the 416x240
  10-bit GOP), crafted by ffmpeg_tpu/codecs/vvc/craft.py with
  tests/test_vvc_inter.py's plan (testing.craft_vvc), as `<name>`, and
  the sha256 of each plane of each picture of the JAX package's
  VvcDecoder as `<name>_sha256` (serial; the tool asserts that
  threads=4 gives the same planes);
- the AV1 OBU stream of testing.craft_av1 (AV1_TUS temporal units of
  1920x1080) written by ffmpeg_tpu/codecs/av1.py's writers, as `av1`
  (the units joined) and `av1_lengths`.

The card's machine has no JAX, so the streams and the reference's
answers are committed.  About 20 s on the CPU.  Usage:

    JAX_PLATFORMS=cpu python tools/gen_torch_vvc_av1_fixture.py
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

from ffmpeg_tpu.codecs import CodecContext  # noqa: E402
from ffmpeg_tpu.codecs import av1 as ref_av1  # noqa: E402
from ffmpeg_tpu.codecs.vvc import craft as ref_craft  # noqa: E402
from ffmpeg_tpu.codecs.vvc.ctu import Plan  # noqa: E402
from ffmpeg_tpu.core.packet import Packet  # noqa: E402
from ffmpeg_tpu.io.stream import CodecParameters, MediaType  # noqa: E402
from ffmpeg_tpu_torch import testing as fx  # noqa: E402


def decode(data: bytes, threads: int = 1) -> list:
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="vvc")
    frames = CodecContext.open_decoder(
        par, options={"threads": threads}).decode_all(
            [Packet(data=data, pts=0)])
    return [hashlib.sha256(np.ascontiguousarray(p).tobytes()).hexdigest()
            for f in frames for p in f.planes]


def main() -> int:
    out = {}
    for name, (seed, kinds, w, h, plan_kw, kw) in fx.VVC_GOPS.items():
        data = fx.craft_vvc(ref_craft, Plan, seed, kinds, w, h, plan_kw,
                            **kw)
        shas = decode(data)
        assert len(shas) == 3 * len(kinds), name
        assert decode(data, threads=4) == shas, name
        out[name] = np.frombuffer(data, np.uint8)
        out[f"{name}_sha256"] = np.array(shas)
        print(f"{name}: {len(data)} bytes, {len(kinds)} pictures",
              flush=True)
    tus = fx.craft_av1(ref_av1)
    out["av1"] = np.frombuffer(b"".join(tus), np.uint8)
    out["av1_lengths"] = np.array([len(t) for t in tus], np.int64)
    np.savez_compressed(fx.VVC_AV1, **out)
    print(f"wrote {fx.VVC_AV1} ({fx.VVC_AV1.stat().st_size} bytes; AV1 "
          f"{len(tus)} units, {sum(map(len, tus))} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
