"""The port's transform engine (ffmpeg_tpu_torch/ops/tx.py) against the
reference's (ffmpeg_tpu/ops/tx.py on CPU JAX), on the CPU: every kind and
direction at the sizes of tests/test_tx.py (2048 and 4096 through the
4-step FFT), on the same seeded inputs.

Tolerances: within 1e-5 of the reference output's full scale (its
largest magnitude), for every kind: both sides compute the same float32
matrices built the same way in float64, and differ only in the order of
the float32 sums.  The checks of tests/test_tx.py against numpy and the
identities (round trips, TDAC) hold on the port with their tolerances.
"""

import numpy as np
import pytest
import torch

from ffmpeg_tpu.ops import tx as ref_tx
from ffmpeg_tpu_torch.ops import tx
from ffmpeg_tpu_torch.utils.error import InvalidData

REL = 1e-5


def _close_to_reference(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got.numpy() - want).max())
    assert err <= REL * scale, (err, scale)


def _both(kind, n, inverse, scale, x):
    """The transform on both packages: (port tensor, reference array)."""
    got = tx.tx_init(kind, n, inverse, scale, device="cpu")(
        torch.from_numpy(x))
    want = ref_tx.tx_init(kind, n, inverse, scale)(x)
    return got, want


def _pairs(shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (2,)).astype(np.float32)


@pytest.mark.parametrize("inverse,scale", [(False, 1.0), (True, None)],
                         ids=["forward", "inverse"])
@pytest.mark.parametrize("n", [64, 256, 2048, 4096])
def test_fft_matches_reference(n, inverse, scale):
    x = _pairs((3, n), n)
    got, want = _both("fft", n, inverse, scale or 1.0 / n, x)
    _close_to_reference(got, want)
    if not inverse:     # tests/test_tx.py::test_fft_matches_numpy
        z = x[..., 0] + 1j * x[..., 1]
        y = got[..., 0].numpy() + 1j * got[..., 1].numpy()
        np.testing.assert_allclose(y, np.fft.fft(z), atol=2e-2 * np.sqrt(n))


def test_fft_roundtrip():
    z = _pairs((256,), 1)
    f = tx.tx_init("fft", 256, device="cpu")
    fi = tx.tx_init("fft", 256, inverse=True, scale=1.0 / 256, device="cpu")
    back = fi(f(torch.from_numpy(z))).numpy()
    np.testing.assert_allclose(back, z, atol=1e-4)


@pytest.mark.parametrize("n", [128, 256])
def test_rdft_matches_reference(n):
    x = np.random.default_rng(2).standard_normal((4, n)).astype(np.float32)
    got, want = _both("rdft", n, False, 1.0, x)
    _close_to_reference(got, want)
    y = got[..., 0].numpy() + 1j * got[..., 1].numpy()
    np.testing.assert_allclose(y, np.fft.rfft(x), atol=1e-3)
    spec = np.array(want)
    back, want_back = _both("rdft", n, True, 1.0, spec)
    _close_to_reference(back, want_back)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-4)


@pytest.mark.parametrize("kind,n,scale", [
    ("dct2", 8, 1.0), ("dct2", 64, 1.0), ("dct2", 480, 1.0),
    ("dct3", 8, 1 / 16), ("dct3", 64, 1 / 128), ("dct3", 480, 1 / 960),
    ("dct2", 32, 1.0), ("dct4", 64, 1.0), ("dct1", 33, 1.0),
    ("dct1", 64, 0.5), ("dst1", 31, 1.0), ("dst1", 64, 1.0)])
def test_dct_dst_match_reference(kind, n, scale):
    x = np.random.default_rng(4).standard_normal((5, n)).astype(np.float32)
    got, want = _both(kind, n, False, scale, x)
    _close_to_reference(got, want)


@pytest.mark.parametrize("n", [8, 64, 480])
def test_dct2_dct3_inverse_pair(n):
    x = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    d2 = tx.tx_init("dct2", n, device="cpu")
    d3 = tx.tx_init("dct3", n, scale=1.0 / (2 * n), device="cpu")
    np.testing.assert_allclose(d3(d2(torch.from_numpy(x))).numpy(), x,
                               atol=1e-3)


def test_dct4_self_inverse():
    x = np.random.default_rng(6).standard_normal(64).astype(np.float32)
    d4 = tx.tx_init("dct4", 64, device="cpu")
    np.testing.assert_allclose(d4(d4(torch.from_numpy(x))).numpy() / 128,
                               x, atol=1e-3)


@pytest.mark.parametrize("n", [128, 1024])
@pytest.mark.parametrize("scale", [1.0, 2.0 ** -25], ids=["1", "aac"])
def test_mdct_imdct_match_reference(n, scale):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((6, 2 * n)).astype(np.float32)
    got, want = _both("mdct", n, False, scale, x)
    _close_to_reference(got, want)
    c = rng.standard_normal((6, n)).astype(np.float32)
    got, want = _both("mdct", n, True, scale, c)
    _close_to_reference(got, want)
    assert tuple(tx.imdct(torch.from_numpy(c), n, scale).shape) == (6, 2 * n)


@pytest.mark.parametrize("n", [128, 1024])
def test_mdct_tdac_perfect_reconstruction(n):
    """Windowed MDCT → IMDCT with 50% overlap-add reconstructs the
    signal (tests/test_tx.py's check, on the port)."""
    rng = np.random.default_rng(7)
    nblocks = 6
    sig = rng.standard_normal(n * (nblocks + 1)).astype(np.float32)
    win = tx.sine_window(2 * n).astype(np.float32)
    recon = np.zeros_like(sig)
    for b in range(nblocks):
        seg = torch.from_numpy(sig[b * n:(b + 2) * n] * win)
        out = tx.imdct(tx.mdct(seg, n), n, scale=2.0 / n).numpy() * win
        recon[b * n:(b + 2) * n] += out
    np.testing.assert_allclose(recon[n:nblocks * n], sig[n:nblocks * n],
                               atol=1e-2)


def test_batched_leading_axes_match_single():
    x = np.random.default_rng(8).standard_normal((2, 3, 256)) \
        .astype(np.float32)
    y = tx.mdct(torch.from_numpy(x), 128)
    assert tuple(y.shape) == (2, 3, 128)
    np.testing.assert_allclose(y[1, 2].numpy(),
                               tx.mdct(torch.from_numpy(x[1, 2]), 128)
                               .numpy(), atol=1e-5, rtol=1e-5)


def test_windows_equal_reference():
    for n in (256, 2048):
        np.testing.assert_array_equal(tx.sine_window(n),
                                      ref_tx.sine_window(n))
        for alpha in (4.0, 6.0):
            np.testing.assert_array_equal(tx.kbd_window(n, alpha),
                                          ref_tx.kbd_window(n, alpha))
    w = tx.kbd_window(256)
    np.testing.assert_allclose(w[:128] ** 2 + w[128:] ** 2, 1.0, atol=1e-9)


def test_raises_where_the_reference_raises():
    for mod, kw in ((tx, {"device": "cpu"}), (ref_tx, {})):
        with pytest.raises(NotImplementedError, match="mdct size"):
            mod.tx_init("mdct", 8192, True, **kw)
        with pytest.raises(NotImplementedError, match="power-of-2"):
            mod.tx_init("fft", 1025, **kw)
        with pytest.raises(ValueError, match="unknown transform"):
            mod.tx_init("dct9", 8, **kw)


def test_matrices_cached_per_device_and_refuse_other_devices():
    f = tx.tx_init("mdct", 128, True, 0.5, device="cpu")
    assert tx.tx_init("mdct", 128, True, 0.5, device="cpu") is f
    g = tx.tx_init("mdct", 128, True, 0.5, device="meta")
    assert g is not f
    with pytest.raises(InvalidData):
        g(torch.zeros(2, 128))
    with pytest.raises(InvalidData):
        f(torch.zeros(2, 128, device="meta"))


def test_tf32_refused():
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full float32"):
            tx.imdct(torch.zeros(1, 128), 128)
    finally:
        torch.set_float32_matmul_precision(prev)
