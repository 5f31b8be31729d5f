#!/usr/bin/env python
"""Write the golden that the port's decode→scale and decoder → graph
paths are checked against.

Runs the JAX package on the CPU over the committed 8-frame 1080p MJPEG
clip (tests/data/port/flagship_1080p_8.mjpeg) and writes
tests/data/port/flagship_1080p_8_decode_scale_golden.npz, two uint8
arrays:

- `decode_scale`, (3, 8, 224, 224): the reference's
  jax.jit(build_decode_scale(DecodeScaleSpec.auto(1920, 1080, 224, 224)))
  (lowres 2, 12 coefficients per block) on all 8 frames as one batch,
  with the coefficients from the reference's own mjpeg_decode_scan at
  L=12, made as tests/test_pipeline.py makes them;
- `graph`, (3, 2, 224, 224): the reference's MjpegDecoder and
  parse_graph("scale=224:224:format=rgb24") on frames 0 and 1.

The card's machine has no JAX, so the reference's answers are committed.
Usage:

    JAX_PLATFORMS=cpu python tools/gen_torch_decode_scale_fixture.py
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

W, H, OUT = 1920, 1080, 224
NFRAMES, GRAPH_FRAMES = 8, 2
GRAPH_TEXT = f"scale={OUT}:{OUT}:format=rgb24"
DATA = REPO / "tests" / "data" / "port"
CLIP = DATA / "flagship_1080p_8.mjpeg"
GOLDEN = DATA / "flagship_1080p_8_decode_scale_golden.npz"


def packets() -> list:
    from ffmpeg_tpu.io import open_input
    return [p.data for p in open_input(str(CLIP), format="mjpeg").packets()]


def reference_coeffs(pkt: bytes, spec):
    """tests/test_pipeline.py:90-109 for one frame: the reference's
    mjpeg_decode_scan at L=spec.ncoeff, and the quantiser tables."""
    from ffmpeg_tpu import native
    from ffmpeg_tpu.codecs.mjpeg import _JpegState, _parse_until_scan
    ly, lx = spec.luma_blocks
    cy, cx = spec.chroma_blocks
    L = spec.ncoeff
    st = _JpegState()
    off, _ = _parse_until_scan(pkt, st)
    outs, specs = [], []
    for comp in st.components:
        bw = lx if comp.h == 2 else cx
        bh = ly if comp.v == 2 else cy
        specs.append((comp.dc_tab, comp.ac_tab, comp.h, comp.v, bw))
        outs.append(np.zeros((bh * bw, L), np.int16))
    sa = (ctypes.c_int * (5 * len(specs)))(*[v for s in specs for v in s])
    op = (ctypes.POINTER(ctypes.c_int16) * len(outs))(
        *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)) for o in outs])
    scan = pkt[off:]
    ret = native.get().mjpeg_decode_scan(
        scan, len(scan), st.dc_counts.tobytes(), st.dc_values.tobytes(),
        st.ac_counts.tobytes(), st.ac_values.tobytes(),
        sa, len(specs), lx // 2, ly // 2, st.restart_interval, L, op)
    assert ret == 0, ret
    qy = st.qtabs[st.components[0].q_idx].astype(np.int32)
    qc = st.qtabs[st.components[1].q_idx].astype(np.int32)
    return (outs[0].reshape(ly, lx, L), outs[1].reshape(cy, cx, L),
            outs[2].reshape(cy, cx, L), qy, qc)


def decode_scale(pkts) -> np.ndarray:
    from ffmpeg_tpu.models.mjpeg_pipeline import (
        DecodeScaleSpec, build_decode_scale, pack_coeffs)
    spec = DecodeScaleSpec.auto(W, H, OUT, OUT)
    assert (spec.lowres, spec.ncoeff) == (2, 12), spec
    per = [reference_coeffs(p, spec) for p in pkts]
    for q in per[1:]:
        assert np.array_equal(q[3], per[0][3]) and \
            np.array_equal(q[4], per[0][4]), "quantiser tables vary"
    args = [pack_coeffs(np.stack([f[i] for f in per])) for i in range(3)]
    out = jax.jit(build_decode_scale(spec))(*args, per[0][3], per[0][4])
    return np.stack([np.asarray(c) for c in out])


def graph(pkts) -> np.ndarray:
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.core.packet import Packet
    from ffmpeg_tpu.filters import parse_graph
    from ffmpeg_tpu.io.stream import CodecParameters, MediaType
    dec = CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="mjpeg"))
    frames = dec.decode_all([Packet(data=p) for p in pkts])
    out = parse_graph(GRAPH_TEXT).run(frames)
    assert [f.format for f in out] == ["rgb24"] * len(pkts)
    return np.stack([np.stack([np.asarray(p) for p in f.planes])
                     for f in out], axis=1)


def main() -> None:
    pkts = packets()
    assert len(pkts) == NFRAMES
    ds = decode_scale(pkts)
    gr = graph(pkts[:GRAPH_FRAMES])
    assert ds.shape == (3, NFRAMES, OUT, OUT) and ds.dtype == np.uint8
    assert gr.shape == (3, GRAPH_FRAMES, OUT, OUT) and gr.dtype == np.uint8
    np.savez_compressed(GOLDEN, decode_scale=ds, graph=gr)
    print(f"{GOLDEN}: decode_scale {ds.shape}, graph {gr.shape}, "
          f"{GOLDEN.stat().st_size} bytes")


if __name__ == "__main__":
    main()
