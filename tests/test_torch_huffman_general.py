"""The port's general-length scan decode (ffmpeg_tpu_torch/ops/huffman.py
`jpeg_scan_decode`, `build_jpeg_luts`) against the reference's, on the CPU.

The same numpy inputs go through the reference's jitted
`jpeg_scan_decode` on CPU JAX and through the port's on CPU tensors; the
coefficients must be equal, bit for bit.  The frames are made by the
reference encoder with its default (Annex K) tables, whose codes run to
16 bits, so that K1's <= 9-bit path could not decode them."""

import numpy as np
import pytest
import torch

from ffmpeg_tpu_torch.codecs.mjpeg import (_JpegState, _parse_until_scan,
                                           scan_decode)
from ffmpeg_tpu_torch.ops import huffman
from ffmpeg_tpu_torch.testing import scan_segments

from torch_port_util import encode_jpeg


def _reference(buf, bitpos, valid, luts, **kw):
    import jax
    import jax.numpy as jnp
    from ffmpeg_tpu.ops.huffman import jpeg_scan_decode
    blk_end = kw.pop("blk_end", None)
    fn = jax.jit(jpeg_scan_decode, static_argnames=(
        "blocks_per_seg", "comp_of_blk", "max_iter"))
    out = fn(jnp.asarray(buf), jnp.asarray(bitpos), jnp.asarray(valid),
             jnp.asarray(luts), blk_end=None if blk_end is None
             else jnp.asarray(blk_end), **kw)
    return np.asarray(out)


def _port(buf, bitpos, valid, luts, stats=None, **kw):
    blk_end = kw.pop("blk_end", None)
    out = huffman.jpeg_scan_decode(
        torch.from_numpy(buf), torch.from_numpy(bitpos),
        torch.from_numpy(valid), torch.from_numpy(luts),
        blk_end=None if blk_end is None else torch.from_numpy(blk_end),
        stats=stats, **kw)
    assert out.dtype == torch.int32
    return out.numpy()


def _host_420(data: bytes, mx: int, my: int, nseg: int, ri: int):
    """The C++ host decoder's blocks in the lanes' (nseg, 6 * ri, 64)
    order, zero past the last MCU."""
    y, u, v = (c.astype(np.int32) for c in scan_decode(data).coeffs)
    y = y.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4)
    mcus = np.concatenate([y.reshape(-1, 4, 64), u.reshape(-1, 1, 64),
                           v.reshape(-1, 1, 64)], axis=1)
    pad = np.zeros((nseg * ri - len(mcus), 6, 64), np.int32)
    return np.concatenate([mcus, pad]).reshape(nseg, 6 * ri, 64)


@pytest.mark.parametrize("w,h,quality,ri", [
    (128, 96, 85, 1), (128, 96, 30, 1), (256, 128, 92, 2),
    (144, 112, 85, 4),
])
def test_annex_k_frames_match_reference_and_host(w, h, quality, ri):
    """The cases of test_huffman_tpu.py::test_device_huffman_matches_host:
    standard tables, one restart interval of `ri` MCUs a lane."""
    data = encode_jpeg(w, h, quality, restart_interval=ri,
                       huffman="default")
    st, buf, bitpos, blk_end, (mx, my) = scan_segments(data)
    luts = huffman.build_jpeg_luts(st)
    valid = np.ones(len(bitpos), bool)
    kw = dict(blocks_per_seg=6 * ri, blk_end=blk_end)
    got = _port(buf, bitpos, valid, luts, **kw)
    np.testing.assert_array_equal(got, _reference(buf, bitpos, valid, luts,
                                                  **kw))
    np.testing.assert_array_equal(got, _host_420(data, mx, my, len(bitpos),
                                                 ri))


def test_short_last_restart_interval():
    """35 MCUs in intervals of 4: the last lane holds 3 MCUs, and its
    blk_end stops it there although its bits would go on."""
    data = encode_jpeg(112, 80, 80, restart_interval=4, huffman="default")
    st, buf, bitpos, blk_end, (mx, my) = scan_segments(data)
    assert blk_end[-1] == 18 and (blk_end[:-1] == 24).all()
    luts = huffman.build_jpeg_luts(st)
    valid = np.ones(len(bitpos), bool)
    kw = dict(blocks_per_seg=24, blk_end=blk_end)
    got = _port(buf, bitpos, valid, luts, **kw)
    np.testing.assert_array_equal(got, _reference(buf, bitpos, valid, luts,
                                                  **kw))
    np.testing.assert_array_equal(got, _host_420(data, mx, my, len(bitpos),
                                                 4))
    assert not got[-1, 18:].any()


def test_padding_lanes_decode_nothing():
    """Every third lane and four appended lanes are padding (valid
    False): they stay zero, and the others decode as before."""
    data = encode_jpeg(96, 64, 85, huffman="default")
    st, buf, bitpos, _, (mx, my) = scan_segments(data)
    n = len(bitpos)
    bitpos = np.concatenate([bitpos, np.zeros(4, np.int32)])
    valid = np.ones(n + 4, bool)
    valid[::3] = False
    valid[n:] = False
    luts = huffman.build_jpeg_luts(st)
    got = _port(buf, bitpos, valid, luts)
    np.testing.assert_array_equal(got, _reference(buf, bitpos, valid, luts))
    host = _host_420(data, mx, my, n, 1)
    np.testing.assert_array_equal(got[:n][valid[:n]], host[valid[:n]])
    assert not got[~valid].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_random_bytes_and_tables(seed):
    """Random scan bytes and random table entries (lengths 0..16, any
    symbol): zero-length entries, starts near and past the buffer's end
    (the clamped peek), positions past 63 (the dropped write) and lanes
    still busy at max_iter, for both the Annex K tables and random ones."""
    rng = np.random.default_rng(seed)
    L, nb = 96, 600
    buf = rng.integers(0, 256, nb, dtype=np.uint8)
    bitpos = rng.integers(0, nb * 8, L).astype(np.int32)
    bitpos[:8] = nb * 8 - rng.integers(0, 48, 8)      # at the buffer's end
    valid = rng.random(L) < 0.9
    blk_end = rng.integers(0, 7, L).astype(np.int32)
    std = huffman.build_jpeg_luts(
        scan_segments(encode_jpeg(32, 32, 85, huffman="default"))[0])
    rand = ((rng.integers(0, 17, (4, 65536)) << 8)
            | rng.integers(0, 256, (4, 65536))).astype(np.int32)
    for luts in (std, rand):
        for kw in ({}, {"blk_end": blk_end}):
            got = _port(buf, bitpos, valid, luts, **kw)
            np.testing.assert_array_equal(
                got, _reference(buf, bitpos, valid, luts, **kw))


def test_random_bytes_three_components():
    """comp_of_blk=(0, 1, 2), three blocks a lane, on random bytes with
    the Annex K tables."""
    rng = np.random.default_rng(7)
    buf = rng.integers(0, 256, 400, dtype=np.uint8)
    bitpos = rng.integers(0, 3200, 64).astype(np.int32)
    valid = np.ones(64, bool)
    luts = huffman.build_jpeg_luts(
        scan_segments(encode_jpeg(32, 32, 85, huffman="default"))[0])
    kw = dict(blocks_per_seg=3, comp_of_blk=(0, 1, 2))
    np.testing.assert_array_equal(
        _port(buf, bitpos, valid, luts, **kw),
        _reference(buf, bitpos, valid, luts, **kw))


def test_444_frame_three_components():
    """A 4:4:4 frame (one Y, one Cb, one Cr block an MCU) with
    comp_of_blk=(0, 1, 2) against the reference and the host decoder."""
    data = encode_jpeg(64, 48, 85, pix_fmt="yuv444p", huffman="default")
    st, buf, bitpos, blk_end, (mx, my) = scan_segments(data)
    assert [(c.h, c.v) for c in st.components] == [(1, 1)] * 3
    luts = huffman.build_jpeg_luts(st)
    valid = np.ones(len(bitpos), bool)
    kw = dict(blocks_per_seg=3, comp_of_blk=(0, 1, 2), blk_end=blk_end)
    got = _port(buf, bitpos, valid, luts, **kw)
    np.testing.assert_array_equal(got, _reference(buf, bitpos, valid, luts,
                                                  **kw))
    y, u, v = (c.astype(np.int32).reshape(-1, 64)
               for c in scan_decode(data).coeffs)
    np.testing.assert_array_equal(got, np.stack([y, u, v], axis=1))


@pytest.mark.parametrize("max_iter", [1, 13])
def test_max_iter_cuts_lanes_short(max_iter):
    """A step cap below what the lanes need: the port runs exactly
    max_iter steps (13 is no multiple of the 8-step busy check) and stops
    where the reference stops."""
    data = encode_jpeg(128, 96, 92, huffman="default")
    st, buf, bitpos, _, _ = scan_segments(data)
    luts = huffman.build_jpeg_luts(st)
    valid = np.ones(len(bitpos), bool)
    stats = {}
    got = _port(buf, bitpos, valid, luts, stats=stats, max_iter=max_iter)
    assert stats["steps"] == max_iter
    np.testing.assert_array_equal(
        got, _reference(buf, bitpos, valid, luts, max_iter=max_iter))
    full_stats = {}
    full = _port(buf, bitpos, valid, luts, stats=full_stats)
    assert full_stats["steps"] > max_iter
    assert not np.array_equal(got, full)


@pytest.mark.parametrize("opts", [{"huffman": "default"},
                                  {"huffman": "optimal"}])
def test_build_jpeg_luts_matches_reference(opts):
    from ffmpeg_tpu.codecs.mjpeg import _JpegState as RefState
    from ffmpeg_tpu.codecs.mjpeg import _parse_until_scan as ref_parse
    from ffmpeg_tpu.ops.huffman import build_jpeg_luts
    data = encode_jpeg(96, 64, 70, **opts)
    st, rst = _JpegState(), RefState()
    _parse_until_scan(data, st)
    ref_parse(data, rst)
    got = huffman.build_jpeg_luts(st)
    assert got.dtype == np.int32 and got.shape == (4, 65536)
    np.testing.assert_array_equal(got, build_jpeg_luts(rst))


def test_codes_longer_than_9_bits_are_decoded():
    """The Annex K tables hold codes of 10-16 bits: build_jpeg_luts9
    refuses them, and a decode with those LUT entries zeroed gives other
    coefficients than the full tables, which equal the host decoder's."""
    data = encode_jpeg(128, 96, 95, huffman="default")
    st, buf, bitpos, _, (mx, my) = scan_segments(data)
    with pytest.raises(ValueError, match="longer than 9 bits"):
        huffman.build_jpeg_luts9(st)
    luts = huffman.build_jpeg_luts(st)
    cut = np.where((luts >> 8) > 9, 0, luts).astype(np.int32)
    assert (cut != luts).any()
    valid = np.ones(len(bitpos), bool)
    got = _port(buf, bitpos, valid, luts)
    np.testing.assert_array_equal(got, _host_420(data, mx, my, len(bitpos),
                                                 1))
    assert not np.array_equal(_port(buf, bitpos, valid, cut), got)


@pytest.mark.parametrize("luts_device,luts_len,match", [
    ("meta", 65536, "several devices"), ("cpu", 512, "not \\(4, 65536\\)")])
def test_bad_inputs_raise(luts_device, luts_len, match):
    """Inputs on two devices, and tables of another shape than
    build_jpeg_luts gives (the lookup would read past them), raise."""
    with pytest.raises(ValueError, match=match):
        huffman.jpeg_scan_decode(
            torch.zeros(16, dtype=torch.uint8),
            torch.zeros(1, dtype=torch.int32),
            torch.ones(1, dtype=torch.bool),
            torch.zeros((4, luts_len), dtype=torch.int32,
                        device=luts_device))
