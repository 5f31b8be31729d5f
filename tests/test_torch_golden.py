"""The committed 1080p fixture and the JAX reference's output on it
(tests/data/port, written by tools/gen_torch_port_fixture.py), which the
card's check holds the port against.  Here, on the CPU, the reference is
run again on frames 0-1 to tie the golden to the reference, and the
port's plain pipeline is held to the same golden.

Tolerance: max |diff| <= 1 (and for the port <= 1% of samples, PSNR
>= 60 dB): float32 sums in another order (another batch size, another
framework) before floor(x + 0.5)."""

import numpy as np

from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
    MjpegTpuEntropyPipeline, TpuEntropySpec)
from ffmpeg_tpu_torch import testing as fx

from torch_port_util import fixture_packets


def _golden():
    g = np.load(fx.GOLDEN)["planes"]
    assert g.shape == (3, 8, fx.OUT, fx.OUT) and g.dtype == np.uint8
    return g


def test_fixture_is_the_flagship_clip():
    from ffmpeg_tpu.codecs.mjpeg import _JpegState, _parse_until_scan
    pkts = fixture_packets()
    assert len(pkts) == 8 and 0.9e6 < fx.FIXTURE.stat().st_size < 1.4e6
    for p in pkts:
        st = _JpegState()
        _parse_until_scan(p, st)
        assert (st.width, st.height, st.restart_interval) == (fx.W, fx.H, 1)
        assert [(c.h, c.v) for c in st.components] == [(2, 2), (1, 1), (1, 1)]
        assert not st.dc_counts[:, 8:].any() and not st.ac_counts[:, 8:].any()


def test_reference_reproduces_golden():
    from ffmpeg_tpu.models.mjpeg_tpu_entropy import (
        MjpegTpuEntropyPipeline as RefPipeline, TpuEntropySpec as RefSpec)
    pkts = fixture_packets()
    spec = RefSpec(fx.W, fx.H, fx.OUT, fx.OUT, batch=2,
                   stride=fx.STRIDE, packed_cap=fx.packed_cap(pkts))
    pipe = RefPipeline(spec, max(pkts, key=len))
    pipe.prep_frame(pkts[0], 0)
    pipe.prep_frame(pkts[1], 1)
    got = np.stack([np.asarray(c) for c in pipe.run_batch()])
    d = np.abs(got.astype(np.int32) - _golden()[:, :2].astype(np.int32))
    assert d.max() <= 1


def test_port_plain_pipeline_matches_golden():
    pkts = fixture_packets()
    spec = TpuEntropySpec(fx.W, fx.H, fx.OUT, fx.OUT, batch=2,
                          stride=fx.STRIDE, packed_cap=fx.packed_cap(pkts))
    pipe = MjpegTpuEntropyPipeline(spec, max(pkts, key=len), device="cpu")
    pipe.prep_frame(pkts[0], 0)
    pipe.prep_frame(pkts[1], 1)
    got = np.stack([c.numpy() for c in pipe.run_batch()])
    d = np.abs(got.astype(np.int32) - _golden()[:, :2].astype(np.int32))
    mse = (d.astype(np.float64) ** 2).mean()
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
    assert 10 * np.log10(255 ** 2 / max(mse, 1e-12)) >= 60
