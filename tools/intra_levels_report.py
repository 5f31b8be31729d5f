#!/usr/bin/env python
"""Report how the port's ProRes and DNxHD levels differ from the
reference's at 1920x1080, and how far each difference lies from the
decision point that float64 puts it at.

Runs the reference's transform on CPU JAX and the port's on the CPU
(torch) on testing.intra_clip_frame(1920, 1080), and prints per plane
testing.undecided_levels (the differing levels, the largest step, how
many lie farther than float32's error bound from a tie or boundary, the
largest distance over that bound) and, of the differing levels, how
many are not exact in float64 (farther than 1e-9 of a step from the
decision point) with the largest such distance in steps.  It is the
measurement behind the encoders' tie-aware bar
(tests/torch_port_util.py assert_levels_at_ties).

Usage (about 10 s):

    JAX_PLATFORMS=cpu python tools/intra_levels_report.py
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from ffmpeg_tpu_torch import testing as fx  # noqa: E402

W, H = 1920, 1080


def _inexact(got, want, x, mode: str):
    sel = got != want
    xs = np.abs(x[sel])
    dist = (np.abs(xs - np.floor(xs) - 0.5) if mode == "round"
            else np.abs(xs - np.round(xs)))
    far = dist[dist > 1e-9]
    return int(far.size), float(far.max(initial=0.0))


def main() -> None:
    import jax.numpy as jnp
    import torch
    from ffmpeg_tpu.ops.idct import fdct8x8 as ref_fdct
    from ffmpeg_tpu.codecs.prores_enc import _QMAT_FLAT4, ProresEncoder
    from ffmpeg_tpu.io.stream import CodecParameters, MediaType
    from ffmpeg_tpu_torch.codecs.dnxhd_enc import _enc_tables
    from ffmpeg_tpu_torch.codecs.prores_enc import quantise_plane
    from ffmpeg_tpu_torch.ops.idct import fdct8x8

    src = fx.intra_clip_frame(W, H)
    ref = ProresEncoder(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="prores", width=W, height=H,
        pix_fmt="yuv422p10le"), {"qscale": fx.INTRA_QSCALE})
    tb = _enc_tables(1271)
    Hp = -(-H // 16) * 16
    for name, p in zip("yuv", src.planes):
        pad = np.pad(p, ((0, Hp - p.shape[0]), (0, 0)), mode="edge")
        blocks = fx.plane_blocks(pad)
        want = ref._quant_blocks(blocks.reshape(-1, 8, 8), _QMAT_FLAT4) \
            .reshape(*blocks.shape[:2], 64)
        got = quantise_plane(torch.from_numpy(pad.astype(np.int16)),
                             _QMAT_FLAT4, fx.INTRA_QSCALE, False).numpy()
        x, tol = fx.prores_decisions(blocks, _QMAT_FLAT4, fx.INTRA_QSCALE,
                                     False)
        print(f"prores {name}: {fx.undecided_levels(got, want, x, tol, 'trunc')}"
              f"; not exact in float64 (count, largest distance in steps): "
              f"{_inexact(got, want, x, 'trunc')}", flush=True)
        g = blocks.astype(np.float32)
        rc = np.asarray(ref_fdct(jnp.asarray(g.reshape(-1, 8, 8)))) \
            .reshape(g.shape)
        pc = fdct8x8(torch.from_numpy(g)).numpy()
        scale = (tb["lw"] if name == "y" else tb["cw"]) * fx.INTRA_QSCALE
        want = fx.dnxhd_levels(rc, scale, fx.INTRA_QSCALE)
        got = fx.dnxhd_levels(pc, scale, fx.INTRA_QSCALE)
        x, tol = fx.dnxhd_decisions(g, scale, fx.INTRA_QSCALE)
        print(f"dnxhd {name}: {fx.undecided_levels(got, want, x, tol, 'round')}"
              f"; not exact in float64: {_inexact(got, want, x, 'round')}",
              flush=True)


if __name__ == "__main__":
    main()
