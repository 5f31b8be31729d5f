"""The port's plain segment-parallel Huffman decoder (K1's oracle and CPU
path) against the reference's three decoders: the JAX jpeg_scan_decode9,
the Pallas kernel jpeg_scan_decode9_pl in interpret mode, and the C++
host decoder mjpeg_decode_scan.  Integer paths: exact equality."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffmpeg_tpu import native
from ffmpeg_tpu.codecs.mjpeg import _JpegState, _parse_until_scan
from ffmpeg_tpu.ops import huffman as ref_huffman
from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
    MjpegTpuEntropyPipeline, TpuEntropySpec)
from ffmpeg_tpu_torch.ops import huffman
from ffmpeg_tpu_torch import testing as fx

from torch_port_util import (encode_jpeg, fixture_packets,
                             reference_coefficients)

S = 192


def _strided(data: bytes, stride: int = S):
    """(rows (nmcu, stride) u8, lens (nmcu,) i32, lut9) of one frame."""
    st = _JpegState()
    off, _ = _parse_until_scan(data, st)
    nmcu = -(-st.width // 16) * -(-st.height // 16)
    rows = np.zeros((nmcu, stride), np.uint8)
    lens = np.zeros(nmcu, np.int32)
    scan = data[off:]
    n = native.get().mjpeg_split_segments_strided(
        scan, len(scan), rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        stride, nmcu + 1, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    assert n == nmcu
    return rows, lens, ref_huffman.build_jpeg_luts9(st)


def _port9(rows, valid, lut9, cur0=None):
    return huffman.jpeg_scan_decode9(
        torch.from_numpy(rows), torch.from_numpy(valid),
        torch.from_numpy(lut9),
        None if cur0 is None else torch.from_numpy(cur0)).numpy()


def test_build_jpeg_luts9_is_the_reference_function():
    """The port keeps its own copy of the table builder; it computes
    the reference's function on the tables of frames made at several
    qualities."""
    assert huffman.build_jpeg_luts9 is not ref_huffman.build_jpeg_luts9
    for quality in (30, 85, 92):
        st = _JpegState()
        _parse_until_scan(encode_jpeg(128, 96, quality), st)
        np.testing.assert_array_equal(huffman.build_jpeg_luts9(st),
                                      ref_huffman.build_jpeg_luts9(st))


@pytest.mark.parametrize("w,h,quality", [
    (128, 96, 85), (128, 96, 30), (256, 128, 92), (144, 112, 85)])
def test_plain_decoder_matches_host(w, h, quality):
    data = encode_jpeg(w, h, quality)
    rows, lens, lut9 = _strided(data, 512)
    got = _port9(rows, np.ones(len(lens), bool), lut9)
    assert got.dtype == np.int32 and got.shape == (len(lens), 6, 64)
    np.testing.assert_array_equal(got, fx.host_decode(data))


def test_plain_decoder_matches_xla_and_pallas_two_tables():
    """Two frames whose DHTs differ; per-frame tables in one call, and the
    cur0 path (lanes shifted by a per-lane byte offset), as in the
    reference's test_pallas_scan_decode_interpret_matches_xla."""
    w, h = 96, 64
    frames = [_strided(encode_jpeg(w, h, q)) for q in (90, 35)]
    assert not np.array_equal(frames[0][2], frames[1][2])
    nmcu = len(frames[0][1])
    rows = np.concatenate([f[0] for f in frames])
    lens = np.concatenate([f[1] for f in frames])
    luts = np.stack([f[2] for f in frames])
    ref = np.concatenate([np.asarray(ref_huffman.jpeg_scan_decode9(
        jnp.asarray(f[0]), jnp.ones(nmcu, bool), jnp.asarray(f[2])))
        for f in frames])
    pl = np.asarray(ref_huffman.jpeg_scan_decode9_pl(
        rows, lens, luts, interpret=True))
    np.testing.assert_array_equal(pl, ref)
    valid = np.ones(2 * nmcu, bool)
    np.testing.assert_array_equal(_port9(rows, valid, luts), ref)
    for f in range(2):
        np.testing.assert_array_equal(
            _port9(frames[f][0], valid[:nmcu], frames[f][2]),
            ref[f * nmcu:(f + 1) * nmcu])

    offs = np.random.default_rng(7).integers(0, 64, 2 * nmcu).astype(np.int32)
    rows2 = np.zeros((2 * nmcu, S + 64), np.uint8)
    for i, o in enumerate(offs):
        rows2[i, o:o + S] = rows[i]
    np.testing.assert_array_equal(_port9(rows2, valid, luts, offs * 8), ref)
    pl2 = np.asarray(ref_huffman.jpeg_scan_decode9_pl(
        rows2, lens, luts, interpret=True, cur0=offs * 8))
    np.testing.assert_array_equal(pl2, ref)


def test_plain_decoder_matches_xla_on_random_bytes():
    """Random segment bytes (valid codes, corrupt codes, runs past the
    row end, the iteration cap) and invalid lanes: the port follows the
    reference's exact semantics, int16 wrap-around included."""
    rng = np.random.default_rng(11)
    lut9 = _strided(encode_jpeg(96, 64, 50))[2]
    L = 96
    rows = rng.integers(0, 256, (L, 64)).astype(np.uint8)
    rows[::7] = 0xFF                  # long ones runs: long codes, big sizes
    valid = rng.random(L) < 0.9
    cur0 = rng.integers(0, 16, L).astype(np.int32)
    ref = np.asarray(ref_huffman.jpeg_scan_decode9(
        jnp.asarray(rows), jnp.asarray(valid), jnp.asarray(lut9),
        cur0=jnp.asarray(cur0)))
    got = _port9(rows, valid, lut9, cur0)
    np.testing.assert_array_equal(got, ref)
    assert not got[~valid].any()


def _packed_batch(pkts, w, h, stride=S):
    # an output size equal to neither plane's (an identity resize has no
    # operator to fuse)
    spec = TpuEntropySpec(w, h, 48, 40, batch=len(pkts), stride=stride)
    pipe = MjpegTpuEntropyPipeline(spec, max(pkts, key=len), device="cpu")
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    regions = torch.from_numpy(pipe.regions.copy())
    lens, luts = pipe.program.split_regions(regions)
    return pipe, regions, lens, luts


def test_packed_decode_matches_reference_device_stage():
    """K1's entry point on packed regions (CPU: the plain version) against
    the reference's own window gather + jpeg_scan_decode9 on the same
    bytes, for two frames with different DHTs."""
    w, h = 128, 96
    pkts = [encode_jpeg(w, h, 85, frame=0), encode_jpeg(w, h, 85, frame=3)]
    pipe, regions, lens, luts = _packed_batch(pkts, w, h)
    assert not torch.equal(luts[0], luts[1])
    before = huffman.KERNEL_LAUNCHES
    got = huffman.jpeg_scan_decode_packed(regions, lens, luts, pipe.hdr)
    assert huffman.KERNEL_LAUNCHES == before    # the CPU launches nothing
    assert got.dtype == torch.int16 and got.shape == (2, pipe.nmcu, 6, 64)
    want = reference_coefficients(regions.numpy(), pipe.nmcu, S)
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)
    for b, p in enumerate(pkts):
        np.testing.assert_array_equal(got[b].numpy(), fx.host_decode(p))


def test_packed_decode_fixture_frame_matches_host():
    """One 1080p frame of the fixture (68 MCU rows: 1080 is not a multiple
    of 16) against the C++ host decoder."""
    pkt = fixture_packets()[0]
    pipe, regions, lens, luts = _packed_batch([pkt], 1920, 1080)
    got = huffman.jpeg_scan_decode_packed(regions, lens, luts, pipe.hdr)
    np.testing.assert_array_equal(got[0].numpy(), fx.host_decode(pkt))


def test_packed_decode_padding_lanes_and_bad_inputs():
    w, h = 64, 32
    pipe, regions, lens, luts = _packed_batch([encode_jpeg(w, h)], w, h)
    lens0 = lens.clone()
    lens0[0, 3:] = 0
    got = huffman.jpeg_scan_decode_packed(regions, lens0, luts, pipe.hdr)
    full = huffman.jpeg_scan_decode_packed(regions, lens, luts, pipe.hdr)
    assert torch.equal(got[0, :3], full[0, :3]) and not got[0, 3:].any()
    with pytest.raises(ValueError):
        huffman.jpeg_scan_decode_packed(regions.to("meta"), lens.to("meta"),
                                        luts.to("meta"), pipe.hdr)
    with pytest.raises(ValueError):
        huffman.jpeg_scan_decode_packed(regions, lens.long(), luts, pipe.hdr)
    with pytest.raises(ValueError):
        huffman.jpeg_scan_decode_packed(regions, lens, luts[:, :256],
                                        pipe.hdr)
