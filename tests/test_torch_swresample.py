"""The port's resampler (ffmpeg_tpu_torch/resample/) against the
reference's (ffmpeg_tpu/resample/ on CPU JAX), on the CPU, on the same
seeded inputs.

Tolerances:
- the filter bank and the rematrix coefficients bit-exact (both are the
  same float64 numpy code on the host);
- resampled samples within 1e-6 of the reference (outputs of magnitude
  <= 1, float32 sums of 32 to 96 products in another order, where one
  float32 ulp at 0.5 is 6e-8);
- the output lengths, `delay_samples` and, without resampling, the
  dithered integer output bit-exact: the positions are the same host
  int64 arithmetic and the dither draws from the same generator.
"""

import numpy as np
import pytest
import torch

from ffmpeg_tpu.formats.channel_layout import ChannelLayout as RefLayout
from ffmpeg_tpu.resample import swresample as ref_swr
from ffmpeg_tpu.resample.rematrix import build_matrix as ref_build_matrix
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.formats.channel_layout import ChannelLayout
from ffmpeg_tpu_torch.resample import swresample as swr
from ffmpeg_tpu_torch.resample.rematrix import build_matrix
from ffmpeg_tpu_torch.utils.rational import Rational

TOL = 1e-6


def _sine(rate, freq, n, ch=1, seed=0, noise=0.01):
    t = np.arange(n) / rate
    x = 0.5 * np.sin(2 * np.pi * freq * t)
    noise = np.random.default_rng(seed).normal(0, noise, (ch, n))
    return (np.tile(x, (ch, 1)) + noise).astype(np.float32)


def _oneshot(r, x):
    return np.concatenate([r.process(x), r.flush()], axis=1)


RATES = [(48000, 16000), (44100, 48000), (48000, 44100), (8000, 48000),
         (11025, 96000)]


@pytest.mark.parametrize("rates", RATES, ids=[f"{a}-{b}" for a, b in RATES])
def test_resampler_matches_reference(rates):
    """One shot plus flush: same bank, phases and length; samples within
    TOL.  11025 → 96000 needs 1280 phases, above max_phases: the
    inexact-phase branch (1024 phases)."""
    in_rate, out_rate = rates
    x = _sine(in_rate, 440.0, in_rate // 4, ch=2, noise=0.0)
    got_r = swr.Resampler(in_rate, out_rate, 2, device="cpu")
    want_r = ref_swr.Resampler(in_rate, out_rate, 2)
    assert (got_r.taps, got_r.phases, got_r.exact_phase, got_r.center) == \
        (want_r.taps, want_r.phases, want_r.exact_phase, want_r.center)
    assert got_r.exact_phase == (rates != (11025, 96000))
    np.testing.assert_array_equal(got_r.bank.numpy(), np.asarray(want_r.bank))
    got, want = _oneshot(got_r, x), _oneshot(want_r, x)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert abs(got.shape[1] - x.shape[1] * out_rate // in_rate) <= 2
    assert float(np.abs(got - want).max()) <= TOL
    # tests/test_swresample.py::test_sine_quality on the port
    m = got.shape[1]
    k = np.arange(m)
    ideal = 0.5 * np.sin(2 * np.pi * 440.0 * (k / out_rate))
    err = got[0, 100:m - 100] - ideal[100:m - 100]
    assert 10 * np.log10((ideal[100:m - 100] ** 2).mean()
                         / (err ** 2).mean()) > 60


def test_streaming_matches_oneshot_and_reference():
    """Random chunks, one process() each, then the flush: equal to the
    one-shot run (within TOL) and to the reference fed the same chunks
    (same lengths per call, samples within TOL)."""
    x = _sine(48000, 1234.5, 9601, ch=2)
    one = _oneshot(swr.Resampler(48000, 16000, 2, device="cpu"), x)
    got_r = swr.Resampler(48000, 16000, 2, device="cpu")
    want_r = ref_swr.Resampler(48000, 16000, 2)
    rng = np.random.default_rng(7)
    got, want, pos = [], [], 0
    while pos < x.shape[1]:
        step = int(rng.integers(1, 997))
        got.append(got_r.process(x[:, pos:pos + step]))
        want.append(want_r.process(x[:, pos:pos + step]))
        assert got[-1].shape == want[-1].shape
        assert got_r.delay_samples == want_r.delay_samples
        pos += step
    got.append(got_r.flush())
    want.append(want_r.flush())
    got, want = np.concatenate(got, axis=1), np.concatenate(want, axis=1)
    assert got.shape == one.shape == want.shape
    assert float(np.abs(got - one).max()) <= TOL
    assert float(np.abs(got - want).max()) <= TOL


def test_delay_samples_equal_reference():
    got_r = swr.Resampler(48000, 16000, 1, device="cpu")
    want_r = ref_swr.Resampler(48000, 16000, 1)
    for n in (4800, 1, 95, 0, 3000):
        got_r.process(np.zeros((1, n), np.float32))
        want_r.process(np.zeros((1, n), np.float32))
        assert got_r.delay_samples == want_r.delay_samples
        assert 0 <= got_r.delay_samples <= 32
    got_r.flush()
    assert got_r.delay_samples == 0


def test_fir_reads_zeros_past_the_data():
    """The reference clamps indices into its power-of-two bucket, whose
    padding is zeros; the port has no bucket and reads zeros past the
    data.  Windows that reach past the end of a 1000-sample buffer agree
    with the reference's kernel on the same buffer in its 1024 bucket."""
    rng = np.random.default_rng(3)
    buf = rng.standard_normal((2, 1000)).astype(np.float32)
    starts = np.array([0, 500, 968, 969, 990, 999, 1000], np.int32)
    phases = np.array([0, 1, 2, 0, 1, 2, 0], np.int32)
    bank = rng.standard_normal((3, 32)).astype(np.float32)
    got = swr._fir_kernel(torch.from_numpy(buf), torch.from_numpy(starts),
                          torch.from_numpy(phases), torch.from_numpy(bank),
                          32).numpy()
    bucket = np.zeros((2, 1024), np.float32)
    bucket[:, :1000] = buf
    want = np.asarray(ref_swr._fir_kernel(bucket, starts, phases, bank, 32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got[:, -1].tolist() == [0.0, 0.0]


def test_flush_windows_reach_past_the_input():
    """The flush reads the `taps` zeros appended past the input: a short
    convert (fewer samples than the filter) plus flush equals the
    reference's."""
    x = _sine(48000, 300.0, 50, ch=1)
    got_c = swr.SwrContext(48000, "mono", "fltp", 16000, "mono", "fltp",
                           device="cpu")
    want_c = ref_swr.SwrContext(48000, "mono", "fltp", 16000, "mono", "fltp")
    got = [got_c.convert(x), got_c.flush()]
    want = [want_c.convert(x), want_c.flush()]
    assert [g.shape for g in got] == [w.shape for w in want] == \
        [(1, 1), (1, 16)]
    assert float(np.abs(got[1] - want[1]).max()) <= TOL


@pytest.mark.parametrize("src,dst,rates", [
    ("5.1", "stereo", (48000, 48000)), ("5.1", "stereo", (48000, 16000)),
    ("mono", "stereo", (48000, 48000)), ("mono", "stereo", (16000, 48000)),
    ("stereo", "mono", (48000, 16000))])
def test_rematrix_matches_reference(src, dst, rates):
    np.testing.assert_array_equal(
        build_matrix(ChannelLayout.from_string(src),
                     ChannelLayout.from_string(dst)),
        ref_build_matrix(RefLayout.from_string(src),
                         RefLayout.from_string(dst)))
    nin = ChannelLayout.from_string(src).nb_channels
    x = _sine(rates[0], 700.0, 2400, ch=nin, seed=1)
    got_c = swr.SwrContext(rates[0], src, "fltp", rates[1], dst, "fltp",
                           device="cpu")
    want_c = ref_swr.SwrContext(rates[0], src, "fltp", rates[1], dst, "fltp")
    assert (got_c.resampler is None) == (want_c.resampler is None)
    if got_c.resampler is not None:     # runs on the output's channels
        assert got_c.resampler.channels == \
            ChannelLayout.from_string(dst).nb_channels
    got = np.concatenate([got_c.convert(x), got_c.flush()], axis=1)
    want = np.concatenate([want_c.convert(x), want_c.flush()], axis=1)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL


def test_set_matrix_and_formats_match_reference():
    x = (np.random.default_rng(5).integers(-30000, 30000, (2, 300))
         .astype(np.int16))
    m = np.array([[0.25, 0.75]])
    got_c = swr.SwrContext(44100, "stereo", "s16", 44100, "mono", "u8",
                           device="cpu")
    want_c = ref_swr.SwrContext(44100, "stereo", "s16", 44100, "mono", "u8")
    got_c.set_matrix(m)
    want_c.set_matrix(m)
    got, want = got_c.convert(x), want_c.convert(x)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    ident = swr.SwrContext(48000, "stereo", "s16", 48000, "stereo", "s16",
                           device="cpu")
    np.testing.assert_array_equal(ident.convert(x), x)


DITHERS = ["rectangular", "tpdf", "triangular", "triangular_hp",
           "lipshitz", "f_weighted", "shibata"]


@pytest.mark.parametrize("method", DITHERS)
def test_dither_presets_bit_exact(method):
    """Every dither and noise-shaping preset, two calls in a row (the
    generator's state carries over), bit-exact with the reference."""
    x = _sine(44100, 440.0, 600, ch=2, seed=2) * 0.6
    got_c = swr.SwrContext(44100, "stereo", "fltp", 44100, "stereo", "s16",
                           dither=method, device="cpu")
    want_c = ref_swr.SwrContext(44100, "stereo", "fltp", 44100, "stereo",
                                "s16", dither=method)
    for part in (x[:, :350], x[:, 350:]):
        got, want = got_c.convert(part), want_c.convert(part)
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, want)


def test_unknown_dither_raises_as_the_reference():
    for mod, kw in ((swr, {"device": "cpu"}), (ref_swr, {})):
        c = mod.SwrContext(8000, "mono", "flt", 8000, "mono", "s16",
                           dither="nope", **kw)
        with pytest.raises(ValueError, match="unknown dither"):
            c.convert(np.zeros((1, 4), np.float32))


def test_convert_frame_and_tensor_input():
    x = _sine(48000, 500.0, 960, ch=2)
    c = swr.SwrContext(48000, "stereo", "fltp", 16000, "mono", "fltp",
                       device="cpu")
    f = c.convert_frame(Frame.audio(torch.from_numpy(x), 48000, "fltp",
                                    pts=7, time_base=Rational(1, 48000)))
    assert f.is_audio and f.sample_rate == 16000 and f.pts == 7
    assert f.ch_layout.describe() == "mono" and f.format == "fltp"
    assert all(isinstance(p, np.ndarray) for p in f.planes)
    want_c = ref_swr.SwrContext(48000, "stereo", "fltp", 16000, "mono",
                                "fltp")
    want = want_c.convert(x)
    assert f.audio_data.shape == want.shape
    assert float(np.abs(f.audio_data - want).max()) <= TOL
    assert c.convert_frame(None).nb_samples == \
        want_c.convert(None).shape[1]
