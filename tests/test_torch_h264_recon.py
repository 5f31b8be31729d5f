"""The port's H.264 device reconstruction (codecs/h264/recon_tpu.py) on
the CPU, fed the reference's own parse: every picture of a stream is
captured from the reference's decoder before its reconstruction
(testing.h264_slice_from_reference), reconstructed by the port's
`reconstruct`, and held byte-exact (tolerance 0) to the reference's
final planes of that picture: its host path (recon_host, conceal,
loopfilter) on the matrix of tests/test_h264_tpu.py, the trans8 / I_8x8
cases of tests/test_h264_8x8.py, explicit and implicit weighted
prediction of tests/test_h264_highfeat.py and a concealed picture; and
its jitted device program (recon="tpu") on an I P B CABAC GOP.  Also
the residual butterflies at the int16 extremes and the half-pel planes
against the reference's functions, and the wavefronts' lanes at the
picture's last macroblock row and column."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffmpeg_tpu.codecs.h264 import recon_tpu as ref_tpu
from ffmpeg_tpu_torch.codecs.h264 import recon_tpu

from torch_h264_util import STREAMS, ref_pictures

CASES = ["ipcm", "i16_mode0", "i16_mode3", "i16_residual", "i4",
         "cabac_i_deblocked", "p_gop0", "p_gop_deblocked", "b_frames1",
         "b_temporal4", "p_multiref", "cabac_gop3", "cabac_b",
         "cabac_b_multiref", "i8x8_cavlc", "i8x8_cabac_deblocked",
         "p_trans8_cavlc", "p_trans8_cabac", "scaling_matrices",
         "weighted_explicit", "weighted_large", "implicit_bipred4",
         "long_term6", "paff_field_gop", "truncated_p", "truncated_idr"]


def _check(caps, what):
    assert caps
    for i, (dec, (alpha, beta, deblock), want) in enumerate(caps):
        got = recon_tpu.reconstruct(dec, "cpu", alpha, beta, deblock)
        for n, g, w in zip("yuv", got, want):
            assert g.dtype == torch.uint8
            np.testing.assert_array_equal(
                g.numpy(), w, err_msg=f"{what} picture {i} plane {n}")


@pytest.mark.parametrize("name", CASES)
def test_reconstruct_matches_reference_host_path(name, monkeypatch):
    _check(ref_pictures(STREAMS[name](), monkeypatch), name)


def test_reconstruct_matches_reference_device_program(monkeypatch):
    """The reference's jitted recon_tpu.reconstruct (recon="tpu") on
    the CPU: an I P B CABAC GOP with deblocking."""
    _check(ref_pictures(STREAMS["cabac_b"](), monkeypatch,
                        {"recon": "tpu"}), "cabac_b (reference program)")


def test_residual_butterflies_at_int16_extremes():
    rng = np.random.default_rng(5)
    ext = np.array([-32768, 32767, -32767, 0, 1, -1], np.int32)
    c4 = rng.choice(ext, (64, 16)).astype(np.int32)
    c4[:8] = rng.integers(-32768, 32768, (8, 16))
    c8 = rng.choice(ext, (32, 64)).astype(np.int32)
    c8[:4] = rng.integers(-32768, 32768, (4, 64))
    np.testing.assert_array_equal(
        recon_tpu._idct_blocks(torch.from_numpy(c4)).numpy(),
        np.asarray(ref_tpu._idct_blocks(jnp.asarray(c4))))
    np.testing.assert_array_equal(
        recon_tpu._idct8_blocks(torch.from_numpy(c8)).numpy(),
        np.asarray(ref_tpu._idct8_blocks(jnp.asarray(c8))))
    n4 = c4[:48].reshape(3, 4, 4, 16)
    np.testing.assert_array_equal(
        recon_tpu._residual_plane(torch.from_numpy(n4[0])).numpy(),
        np.asarray(ref_tpu._residual_plane(jnp.asarray(n4[0]))))


def test_halfpel_planes_match_reference():
    rng = np.random.default_rng(7)
    g = rng.integers(0, 256, (2, 24, 40)).astype(np.int32)
    got = recon_tpu._halfpel_planes(
        recon_tpu._pad_replicate(torch.from_numpy(g), 8)).numpy()
    want = np.stack([np.asarray(a) for a in ref_tpu._halfpel_planes(
        ref_tpu._pad_replicate(jnp.asarray(g), 8))])
    np.testing.assert_array_equal(got, want)


def test_wavefront_lanes_reach_last_row_and_column(monkeypatch):
    """The intra batches and the deblock batches of an all-intra
    picture with the filter on hold the last macroblock row and column
    (and the last diagonal); their planes match there too."""
    caps = ref_pictures(STREAMS["cabac_i_deblocked"](), monkeypatch)
    dec, (alpha, beta, _), want = caps[0]
    nmbx, nmby = dec.sps.mb_width, dec.sps.mb_height
    _fn, fa = recon_tpu.prepare(dec, "cpu")
    last = (nmbx - 1) + 2 * (nmby - 1)
    assert fa.steps[0] == 0 and fa.steps[-1] == last
    da = recon_tpu.deblock_args(dec, alpha, beta, "cpu")
    assert da.steps[-1] == last
    W = nmbx * 16
    for name, luma, vertical, hb, _hp in da.kinds:
        if not luma:
            continue
        base = da.pack.get(hb).numpy()
        rows, cols = base // W, base % W
        assert rows.max() // 16 == nmby - 1, name
        assert cols.max() // 16 == nmbx - 1, name
    got = recon_tpu.reconstruct(dec, "cpu", alpha, beta, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[-16:], w[-16:])
        np.testing.assert_array_equal(g.numpy()[:, -8:], w[:, -8:])
