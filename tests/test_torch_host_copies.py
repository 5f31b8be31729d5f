"""The port's own copies of the reference's host modules against the
reference, on the CPU: the pixel-format descriptors, the colour matrices
and levels, the resize filter banks, the JPEG Huffman tables, Rational
arithmetic, the exception classes, and the host C++ (scan split and
sequential decode) on every frame of the 1080p fixture, byte-exact."""

import ctypes
import dataclasses

import numpy as np
import pytest

from ffmpeg_tpu import native as ref_native
from ffmpeg_tpu.codecs.mjpeg import _JpegState, _parse_until_scan
from ffmpeg_tpu.formats import pixfmt as ref_pf
from ffmpeg_tpu.ops import huffman as ref_huffman
from ffmpeg_tpu.scale import colorspace as ref_csp
from ffmpeg_tpu.scale import filters as ref_filters
from ffmpeg_tpu.utils import error as ref_error
from ffmpeg_tpu.utils.rational import Rational as RefRational
from ffmpeg_tpu_torch import native
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.core.packet import PKT_FLAG_KEY, Packet
from ffmpeg_tpu_torch.formats import pixfmt
from ffmpeg_tpu_torch.ops import huffman
from ffmpeg_tpu_torch.scale import colorspace, filters
from ffmpeg_tpu_torch.testing import host_decode
from ffmpeg_tpu_torch.utils import error
from ffmpeg_tpu_torch.utils.rational import NOPTS, Rational

from torch_port_util import encode_jpeg, fixture_packets


def test_pixfmt_descriptors_equal_reference():
    port = pixfmt.all_formats()
    assert len(port) > 100
    for name, desc in port.items():
        assert dataclasses.asdict(desc) == dataclasses.asdict(
            ref_pf.get(name)), name
        assert desc.component_dtype() == ref_pf.get(name).component_dtype()
        assert desc.chroma_dims(1919, 1081) == \
            ref_pf.get(name).chroma_dims(1919, 1081)
    for alias, name in pixfmt._ALIASES.items():
        assert pixfmt.get(alias).name == ref_pf.get(alias).name == name
    for flag in ("FLAG_BE", "FLAG_PAL", "FLAG_BITSTREAM", "FLAG_HWACCEL",
                 "FLAG_PLANAR", "FLAG_RGB", "FLAG_ALPHA", "FLAG_BAYER",
                 "FLAG_FLOAT"):
        assert getattr(pixfmt, flag) == getattr(ref_pf, flag)
    with pytest.raises(error.InvalidData):
        pixfmt.get("no-such-format")


@pytest.mark.parametrize("cs", sorted(ref_csp.LUMA_COEFFS)
                         + ["ycgco", "rgb"])
def test_colorspace_matrices_equal_reference(cs):
    np.testing.assert_array_equal(colorspace.yuv2rgb_matrix(cs),
                                  ref_csp.yuv2rgb_matrix(cs))
    np.testing.assert_array_equal(colorspace.rgb2yuv_matrix(cs),
                                  ref_csp.rgb2yuv_matrix(cs))


def test_colorspace_levels_equal_reference():
    for depth in (8, 9, 10, 12, 16):
        for full in (False, True):
            assert colorspace.yuv_levels(depth, full) == \
                ref_csp.yuv_levels(depth, full)
            assert colorspace.rgb_levels(depth, full) == \
                ref_csp.rgb_levels(depth, full)
    for loc in ref_csp.CHROMA_LOC_OFFSETS:
        for sw, sh in ((1, 1), (1, 0), (0, 0), (2, 2)):
            assert colorspace.chroma_offset(loc, sw, sh) == \
                ref_csp.chroma_offset(loc, sw, sh)


@pytest.mark.parametrize("name", filters.FILTERS)
def test_resize_matrix_equal_reference(name):
    assert filters.FILTERS == ref_filters.FILTERS
    for args, kw in [((224, 1920), {}), ((64, 48), {"antialias": False}),
                     ((480, 270), dict(scale=4.0, src_step=2.0,
                                       src_off=0.5)),
                     ((8, 16), dict(dst_step=2.0, dst_off=0.5, scale=1.0))]:
        np.testing.assert_array_equal(
            filters.resize_matrix(*args, name, **kw),
            ref_filters.resize_matrix(*args, name, **kw))


def test_jpeg_luts_equal_reference():
    """build_jpeg_luts9 on every fixture frame's tables (optimal Huffman
    tables, one set per frame), build_lut on each of their DHTs, and the
    refusal of a code longer than 9 bits."""
    for pkt in fixture_packets():
        st = _JpegState()
        _parse_until_scan(pkt, st)
        np.testing.assert_array_equal(huffman.build_jpeg_luts9(st),
                                      ref_huffman.build_jpeg_luts9(st))
        for t in range(2):
            for counts, values in ((st.dc_counts[t], st.dc_values[t]),
                                   (st.ac_counts[t], st.ac_values[t])):
                np.testing.assert_array_equal(
                    huffman.build_lut(counts, values),
                    ref_huffman.build_lut(counts, values))
    st = _JpegState()
    _parse_until_scan(encode_jpeg(64, 48, huffman="default"), st)
    for fn in (huffman.build_jpeg_luts9, ref_huffman.build_jpeg_luts9):
        with pytest.raises(ValueError, match="longer than 9 bits"):
            fn(st)


def test_rational_equal_reference():
    rng = np.random.default_rng(7)
    for _ in range(200):
        a, b, c, d = (int(x) for x in rng.integers(-50, 51, 4))
        b, d = b or 1, d or 7
        p, q = Rational(a, b), Rational(c, d)
        r, s = RefRational(a, b), RefRational(c, d)
        for op in ("__add__", "__sub__", "__mul__"):
            got, want = getattr(p, op)(q), getattr(r, op)(s)
            assert (got.num, got.den) == (want.num, want.den), op
        if c:
            got, want = p / q, r / s
            assert (got.num, got.den) == (want.num, want.den)
        assert p.cmp(q) == r.cmp(s) and (p < q) == (r < s)
        assert float(p) == float(r) and bool(p) == bool(r)
        assert (p.reduce().num, p.reduce().den) == (r.reduce().num,
                                                    r.reduce().den)


def test_errors_packet_frame_mirror_reference():
    for name in ("FFTPUError", "TryAgain", "EndOfStream", "InvalidData",
                 "NotSupported", "EncoderNotFound"):
        cls = getattr(error, name)
        assert issubclass(cls, error.FFTPUError)
        assert cls.__doc__ == getattr(ref_error, name).__doc__
    pkt = Packet(data=b"abc", flags=PKT_FLAG_KEY)
    assert pkt.size == 3 and pkt.is_keyframe and pkt.pts == NOPTS
    f = Frame.video(4, 2, "yuvj420p", planes=[np.zeros((2, 4), np.uint8)],
                    pts=3, time_base=Rational(1, 25))
    assert (f.format, f.width, f.height, f.pts) == ("yuv420p", 4, 2, 3)
    g = f.clone_props()
    assert g.planes == f.planes and g.planes is not f.planes


def _split(lib, scan, nmcu):
    out = np.zeros(len(scan) + 64, np.uint8)
    offs = np.zeros(nmcu + 2, np.int32)
    n = lib.mjpeg_split_segments(
        scan, len(scan), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(out), offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), nmcu)
    return n, offs[:n + 1].copy(), out[:offs[n]].copy()


def _ref_host_decode(pkt):
    """The reference library's mjpeg_decode_scan, through the port's
    `host_decode` with its library swapped for the reference's."""
    from ffmpeg_tpu_torch import testing
    saved = testing.native
    try:
        testing.native = ref_native
        return host_decode(pkt)
    finally:
        testing.native = saved


@pytest.mark.parametrize("frame", range(8))
def test_host_cpp_equals_reference(frame):
    """The port's C++ copy against ffmpeg_tpu.native on a fixture frame:
    split offsets and destuffed bytes, and the host decoder's
    coefficients, byte-exact."""
    pkt = fixture_packets()[frame]
    st = _JpegState()
    off, _ = _parse_until_scan(pkt, st)
    nmcu = -(-st.width // 16) * -(-st.height // 16)
    got = _split(native.get(), pkt[off:], nmcu)
    want = _split(ref_native.get(), pkt[off:], nmcu)
    assert got[0] == want[0] == nmcu
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    coef = host_decode(pkt)
    assert coef.shape == (nmcu, 6, 64)
    np.testing.assert_array_equal(coef, _ref_host_decode(pkt))
