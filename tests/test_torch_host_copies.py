"""The port's own copies of the reference's host modules against the
reference, on the CPU: the pixel-format descriptors, the colour matrices
and levels, the resize filter banks, the JPEG Huffman tables, Rational
arithmetic and timestamp rescaling, the exception classes, the host C++
(scan split and sequential decode) on every frame of the 1080p fixture,
byte-exact, and the split's vector and portable paths on crafted scans
as well; and the host modules of the decode → filter graph slice:
logging, the expression language, the option system, the stream
containers, image packing and the frame's byte and host conversions; and
the host modules of the audio frontend: sample formats, channel layouts,
the FIR bank (bit-exact), the rematrix, the bit reader and writer, the
AAC tables, the ADTS demuxer on the committed clip, and the C++ AAC
spectral decoder against its Python walker and the reference's; and the
host half of the VP9 decoder: its tables and the H.264 bit reader, the
bool coder, the frame headers, the 1-D inverse transforms (on torch
int32 tensors too), the intra and inter predictors, the loop filter's
tables, the C++ tile walk's records on all 100 frames of the bench
stream, and the IVF reader; and the audio decoders' tables (MPEG audio,
AC-3, E-AC-3, SBR, PS), the MP3 Huffman tables built from them, and the
AC-3 bit allocation on seeded exponents; and the video filters' host
copies: the .cube parser and identity LUT, the deblock thresholds, the
sources' colour table, the colour parsers and plane names of video6,
the luma, transfer, primaries and range tables of video5 and video7,
the colorspace filter's matrices, and the frame aligner; and the
host copies of the last audio slice: the Opus range decoder, SILK, its
resampler and tables and the Vorbis tables, and the audio filters of
audio2-audio6, statement for statement (their code equals the
reference's, the module docstring aside), the range decoder on every
frame of the committed Opus streams and the resampler on seeded input;
and the I/O layer's error classes and timestamp comparison."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

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


def _outcome(fn, *args):
    """fn(*args), or the class name of what it raised."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - compared, not swallowed
        return type(e).__name__


def test_pixfmt_descriptors_equal_reference():
    port = pixfmt.all_formats()
    assert len(port) > 100
    for name, desc in port.items():
        ref = ref_pf.get(name)
        assert dataclasses.asdict(desc) == dataclasses.asdict(ref), name
        # a hardware surface has no components: both raise alike
        assert _outcome(desc.component_dtype) == \
            _outcome(ref.component_dtype), name
        assert desc.chroma_dims(1919, 1081) == ref.chroma_dims(1919, 1081)
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
                 "NotSupported", "EncoderNotFound", "DecoderNotFound",
                 "FilterNotFound", "OptionNotFound"):
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


def test_io_errors_and_compare_ts_mirror_reference():
    """The I/O layer's error classes (DemuxerNotFound, MuxerNotFound,
    ProtocolNotFound: their names, bases and docs) and av_compare_ts."""
    from ffmpeg_tpu.utils.rational import compare_ts as ref_compare_ts
    from ffmpeg_tpu_torch.utils.rational import compare_ts
    for name in ("DemuxerNotFound", "MuxerNotFound", "ProtocolNotFound"):
        cls, ref = getattr(error, name), getattr(ref_error, name)
        assert [b.__name__ for b in cls.__mro__] == \
            [b.__name__ for b in ref.__mro__]
        assert cls.__doc__ == ref.__doc__
    rng = np.random.default_rng(4)
    for _ in range(200):
        a, b = (int(x) for x in rng.integers(-10**6, 10**6, 2))
        n1, d1, n2, d2 = (int(x) for x in rng.integers(1, 90001, 4))
        assert compare_ts(a, Rational(n1, d1), b, Rational(n2, d2)) == \
            ref_compare_ts(a, RefRational(n1, d1), b, RefRational(n2, d2))
    assert compare_ts(3, Rational(1, 3), 1, Rational(1, 1)) == 0


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
    from ffmpeg_tpu_torch.codecs import mjpeg
    saved = mjpeg.native
    try:
        mjpeg.native = ref_native
        return host_decode(pkt)
    finally:
        mjpeg.native = saved


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



def _split_run(fn, scan: bytes, cap: int, max_segs: int, fill: int):
    """fn on `scan` into an output of `cap` bytes (pre-filled with `fill`,
    with 64 more bytes beyond it) and max_segs + 2 offsets (pre-filled,
    with 8 more): the return code, all the offsets and all the bytes."""
    out = np.full(cap + 64, fill, np.uint8)
    offs = np.full(max(max_segs, 0) + 10, -7, np.int32)
    n = fn(scan, len(scan), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
           cap, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_segs)
    return n, offs, out


def _plain(rng, n):
    return rng.integers(0, 255, n).astype(np.uint8)     # no 0xFF


def _split_cases(case):
    """(scan, out_cap, max_segs) triples of one case of
    test_split_segments_equal_reference."""
    rng = np.random.default_rng(2025)
    if case.startswith("fixture"):
        pkt = fixture_packets()[int(case[-1])]
        st = _JpegState()
        off, _ = _parse_until_scan(pkt, st)
        nmcu = -(-st.width // 16) * -(-st.height // 16)
        scan = pkt[off:]
        return [(scan, len(scan) + 64, nmcu), (scan, len(scan), nmcu + 5)]
    out = []
    if case == "offsets":
        # FF 00, FF Dn and both back to back at every offset of a 64-byte
        # chunk, across its two 32-byte halves and the 64-byte edge
        for o in range(64):
            for lead in (0, 1, 63, 64, 65, 200):
                s = _plain(rng, lead + 448)
                s[lead + o:lead + o + 2] = (0xFF, 0x00)
                s[lead + 128 + o:lead + 130 + o] = (0xFF, 0xD0 + o % 8)
                s[lead + 256 + o:lead + 260 + o] = (0xFF, 0x00,
                                                    0xFF, 0xD7 - o % 8)
                out.append((s.tobytes() + b"\xFF\xD9", len(s) + 64, 16))
        # markers every few bytes, as a restart scan, and a long run
        for gap in (2, 3, 5, 17, 40, 63, 64, 65, 130):
            s = _plain(rng, 2000)
            for j in range(gap, 1990, gap + 2):
                s[j:j + 2] = (0xFF, 0xD0 + j % 8 if j % 3 else 0x00)
            out.append((s.tobytes(), len(s) + 8, 2000))
        out.append((_plain(rng, 5000).tobytes(), 6000, 4))
    elif case == "ff_last":
        for n in (1, 2, 63, 64, 65, 127, 128, 129, 300, 1000):
            s = _plain(rng, n)
            s[-1] = 0xFF
            out.append((s.tobytes(), n + 64, 8))
    elif case == "eoi_mid":
        for at in (0, 5, 64, 127, 130, 700):
            s = _plain(rng, 1000)
            s[at // 2] = 0xFF
            s[at // 2 + 1] = 0x00
            s[at:at + 2] = (0xFF, 0xD9)
            s[at + 40:at + 42] = (0xFF, 0xD3)
            out.append((s.tobytes(), 1100, 8))
    elif case == "sizes":
        for n in (0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 191, 192, 193):
            s = _plain(rng, n)
            if n > 20:
                s[10:12] = (0xFF, 0xD1)
            out.append((s.tobytes(), n + 64, 4))
    elif case == "out_cap":
        # the output runs out at, just before and just after edges of 16 to
        # 1024 bytes, and around the 192 bytes of room the chunks need
        s = _plain(rng, 1500)
        for j in range(30, 1490, 37):
            s[j:j + 2] = (0xFF, 0x00 if j % 2 else 0xD0 + j % 8)
        for edge in (16, 32, 64, 128, 192, 256, 512, 1024):
            for cap in (edge - 1, edge, edge + 1):
                out.append((s.tobytes(), cap, 100))
        out.append((s.tobytes(), len(s), 100))
    elif case == "max_segs":
        # one restart marker more than max_segs allows
        for gap in (3, 40, 100):
            s = _plain(rng, 1200)
            js = list(range(gap, 1190, gap + 2))
            for j in js:
                s[j:j + 2] = (0xFF, 0xD0 + j % 8)
            out.append((s.tobytes(), 1300, len(js)))
            out.append((s.tobytes(), 1300, len(js) - 1))
        out.append((b"", 64, 0))
    return out


SPLIT_CASES = [f"fixture{i}" for i in range(8)] + [
    "offsets", "ff_last", "eoi_mid", "sizes", "out_cap", "max_segs"]


@pytest.mark.parametrize("path", ["dispatched", "portable"])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_segments_equal_reference(case, path):
    """The port's vectorised split (the path the CPU selects, and the
    portable one) against the reference library's byte loop: the return
    code, every offset written and every byte of the output buffer, the
    bytes past the destuffed output included, which neither changes."""
    lib = native.get()
    fn = lib.mjpeg_split_segments if path == "dispatched" \
        else lib.mjpeg_split_segments_portable
    codes = set()
    for k, (scan, cap, max_segs) in enumerate(_split_cases(case)):
        got = _split_run(fn, scan, cap, max_segs, 0x5A + k)
        want = _split_run(ref_native.get().mjpeg_split_segments, scan, cap,
                          max_segs, 0x5A + k)
        assert got[0] == want[0], (k, len(scan), cap, max_segs)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        codes.add(int(want[0] > 0) if want[0] >= 0 else int(want[0]))
    expect = {"out_cap": {1, -2}, "max_segs": {1, -1, -3}}.get(case, {1})
    assert codes == expect
    assert lib.mjpeg_split_isa() in (0, 2)


# --- the host modules of the decode → filter graph slice -------------------

def test_log_levels_and_mixin_equal_reference(capsys):
    from ffmpeg_tpu.utils import log as ref_log
    from ffmpeg_tpu_torch.utils import log
    assert {k: int(v) for k, v in log.LogLevel.__members__.items()} == \
        {k: int(v) for k, v in ref_log.LogLevel.__members__.items()}
    assert {int(k): v for k, v in log._NAMES.items()} == \
        {int(k): v for k, v in ref_log._NAMES.items()}
    seen = []
    prev = log.get_level()
    try:
        log.set_callback(lambda ctx, lvl, msg: seen.append((lvl, msg)))
        log.set_level("warning")

        class Ctx(log.LogMixin):
            log_name = "ctx"
        Ctx().info("hidden")
        Ctx().error("shown")
    finally:
        log.set_callback(None)
        log.set_level(prev)
    assert seen == [(log.LogLevel.INFO, "hidden"),
                    (log.LogLevel.ERROR, "shown")]
    assert capsys.readouterr().err == "[ctx] shown\n"


EXPRS = [
    # the default expressions of filters/video.py, with their names
    ("iw", {"iw": 64}), ("ih", {"ih": 48}),
    ("(in_w-out_w)/2", {"in_w": 64, "out_w": 40}),
    ("(in_h-out_h)/2", {"in_h": 48, "out_h": 30}),
    ("(ow-iw)/2", {"ow": 80, "iw": 64}), ("(oh-ih)/2", {"oh": 64, "ih": 48}),
    ("val", {"val": 17}), ("PTS", {"PTS": 12}),
    # and others
    ("iw/2", {"iw": 1919}), ("-2", {}), ("maxval-val", {"maxval": 255,
                                                         "val": 3}),
    ("clip(val*2,0,255)", {"val": 200}), ("2*PTS", {"PTS": 7}),
    ("N*10+3", {"N": 4}), ("if(gt(a,1),a*2,a/2)", {"a": 1.5}),
    ("1.5e3+0x10-2^3^2", {}), ("sqrt(-1)", {}), ("0/0", {}), ("1/0", {}),
    ("10k+1Ki+2M", {}), ("st(0,5);ld(0)*2", {}), ("floor(-2.5)+ceil(2.1)",
                                                    {}),
    ("round(2.5)+round(-2.5)+trunc(-1.7)", {}), ("mod(7,3)+7%3", {}),
    ("hypot(3,4)+atan2(1,1)+gcd(12,18)", {}), ("PI*E-PHI", {}),
    ("between(5,1,10)+lerp(0,10,0.25)+bitand(12,10)", {}),
    ("not(0)+!1+isnan(NAN)+isinf(INF)", {}), ("lt(1,2)*lte(2,2)*eq(3,3)",
                                              {}),
]


@pytest.mark.parametrize("expr,names", EXPRS, ids=[e[0] for e in EXPRS])
def test_eval_expr_equal_reference(expr, names):
    from ffmpeg_tpu.utils import eval as ref_eval
    from ffmpeg_tpu_torch.utils import eval as port_eval
    if ";" in expr:         # two statements sharing the register file
        a, b = expr.split(";")
        got, want = [0.0] * 10, [0.0] * 10
        port_eval.eval_expr(a, names, state=got)
        ref_eval.eval_expr(a, names, state=want)
        g = port_eval.eval_expr(b, names, state=got)
        w = ref_eval.eval_expr(b, names, state=want)
    else:
        g = port_eval.eval_expr(expr, names)
        w = ref_eval.eval_expr(expr, names)
    assert (g == w) or (g != g and w != w), (g, w)


@pytest.mark.parametrize("expr", ["unknown_name", "1+", "max(1)", "(1",
                                  "2 3", "foo(1)"])
def test_eval_expr_rejects_what_the_reference_rejects(expr):
    from ffmpeg_tpu.utils import eval as ref_eval
    from ffmpeg_tpu.utils.error import InvalidData as RefInvalidData
    from ffmpeg_tpu_torch.utils import eval as port_eval
    with pytest.raises(RefInvalidData):
        ref_eval.eval_expr(expr)
    with pytest.raises(error.InvalidData):
        port_eval.eval_expr(expr)


def test_eval_random_keeps_the_reference_seeding():
    import random
    from ffmpeg_tpu.utils import eval as ref_eval
    from ffmpeg_tpu_torch.utils import eval as port_eval
    random.seed(3)
    got = [port_eval.eval_expr("random(0)") for _ in range(3)]
    random.seed(3)
    want = [ref_eval.eval_expr("random(0)") for _ in range(3)]
    assert got == want


def _opt_classes():
    from ffmpeg_tpu.utils import options as ro
    from ffmpeg_tpu_torch.utils import options as po

    def make(m):
        class C(m.OptionsMixin):
            OPTIONS = (m.opt_int("n", default=3, min=0, max=100),
                       m.opt_float("x", default=0.5),
                       m.opt_str("s", default="iw"),
                       m.opt_bool("b"),
                       m.opt_rational("r"),
                       m.Option("flags", type=m.OptType.FLAGS, default=0,
                                unit="fl"),
                       m.opt_const("fast", 1, "fl"),
                       m.opt_const("slow", 2, "fl"),
                       m.Option("size", type=m.OptType.IMAGE_SIZE),
                       m.Option("dur", type=m.OptType.DURATION, default=0),
                       m.Option("d", type=m.OptType.DICT))
        return C
    return make(po), make(ro), po, ro


@pytest.mark.parametrize("name,value", [
    ("n", "7"), ("n", "2*3+1"), ("x", "1/4"), ("x", 2), ("s", 5),
    ("b", "yes"), ("b", "off"), ("b", "auto"), ("r", "30000/1001"),
    ("r", "ntsc"), ("r", 2.5), ("r", "16:9"), ("flags", "fast+slow"),
    ("flags", "slow"), ("flags", "fast+slow-fast"), ("size", "hd720"),
    ("size", "320x240"), ("dur", "1:02.5"), ("dur", "1500ms"),
    ("d", "a=1:b=2")])
def test_options_convert_as_the_reference(name, value):
    P, R, _, _ = _opt_classes()
    p, r = P(), R()
    p.init_options()
    r.init_options()
    p.set_option(name, value)
    r.set_option(name, value)
    g, w = p.get_option(name), r.get_option(name)
    if hasattr(w, "num"):
        g, w = (g.num, g.den), (w.num, w.den)
    assert g == w
    assert p.option_names() == r.option_names()


def test_options_reject_as_the_reference():
    from ffmpeg_tpu.utils.error import (InvalidData as RefInvalidData,
                                        OptionNotFound as RefNotFound)
    P, R, _, _ = _opt_classes()
    for cls, inv, nf in ((P, error.InvalidData, error.OptionNotFound),
                         (R, RefInvalidData, RefNotFound)):
        o = cls()
        with pytest.raises(nf):
            o.set_option("nope", 1)
        with pytest.raises(inv):
            o.set_option("n", "500")
        with pytest.raises(inv):
            o.set_option("b", "maybe")


def test_rational_rescale_equal_reference():
    from ffmpeg_tpu.utils import rational as rr
    from ffmpeg_tpu_torch.utils import rational as pr
    assert {k: int(v) for k, v in pr.Rounding.__members__.items()} == \
        {k: int(v) for k, v in rr.Rounding.__members__.items()}
    rng = np.random.default_rng(11)
    for _ in range(300):
        a = int(rng.integers(-10**12, 10**12))
        bn, bd, cn, cd = (int(x) for x in rng.integers(1, 90001, 4))
        for rnd in (0, 1, 2, 3, 5):
            assert pr.rescale_q_rnd(a, Rational(bn, bd), Rational(cn, cd),
                                    pr.Rounding(rnd)) == \
                rr.rescale_q_rnd(a, RefRational(bn, bd), RefRational(cn, cd),
                                 rr.Rounding(rnd))
        assert pr.rescale_q(a, Rational(bn, bd), Rational(cn, cd)) == \
            rr.rescale_q(a, RefRational(bn, bd), RefRational(cn, cd))
    assert pr.rescale_rnd(NOPTS, 1, 2, pr.Rounding.NEAR_INF
                          | pr.Rounding.PASS_MINMAX) == NOPTS
    for v in (25.0, 29.97, 0.1, 30000 / 1001, float("nan"), float("inf"),
              -float("inf"), 1e-9):
        got, want = Rational.from_float(v), RefRational.from_float(v)
        assert (got.num, got.den) == (want.num, want.den)
    assert Rational(3, 7).inv() == Rational(7, 3)
    assert hash(Rational(1, 25)) == hash(Rational(1, 25))


def test_stream_containers_equal_reference():
    from ffmpeg_tpu.io import stream as rs
    from ffmpeg_tpu_torch.io import stream as ps
    for k in ("VIDEO", "AUDIO", "SUBTITLE", "DATA", "ATTACHMENT"):
        assert getattr(ps.MediaType, k) == getattr(rs.MediaType, k)
    for cls in ("CodecParameters", "StreamInfo"):
        got = {f.name for f in dataclasses.fields(getattr(ps, cls))}
        want = {f.name for f in dataclasses.fields(getattr(rs, cls))}
        assert got == want, cls
    p, r = ps.CodecParameters(), rs.CodecParameters()
    for f in dataclasses.fields(p):
        if f.name in ("sample_aspect_ratio", "framerate"):
            assert getattr(p, f.name) == Rational(0, 1)
        else:
            assert getattr(p, f.name) == getattr(r, f.name), f.name
    assert p.channels == 0 and p.copy() is not p
    s = ps.StreamInfo(codecpar=ps.CodecParameters(codec_type="video"))
    assert s.codec_type == "video" and s.time_base == Rational(1, 90000)


@pytest.mark.parametrize("fmt", ["yuv420p", "yuv422p10le", "rgb24",
                                 "bgra", "nv12", "gray", "gray16le",
                                 "yuyv422", "rgb565le", "p010le",
                                 "yuva420p", "gbrp", "monow"])
def test_imgutils_and_frame_bytes_equal_reference(fmt):
    from ffmpeg_tpu.core import imgutils as ref_img
    from ffmpeg_tpu.core.frame import Frame as RefFrame
    from ffmpeg_tpu_torch.core import imgutils
    w, h = 34, 18
    size = imgutils.image_buffer_size(fmt, w, h)
    assert size == ref_img.image_buffer_size(fmt, w, h)
    buf = np.random.default_rng(4).integers(0, 256, size, np.uint8) \
        .tobytes()
    got = imgutils.unpack(buf, fmt, w, h)
    want = ref_img.unpack(buf, fmt, w, h)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g, r)
    assert imgutils.pack(got, fmt, w, h) == ref_img.pack(want, fmt, w, h)
    for lim in (False, True):
        for g, r in zip(imgutils.fill_black(fmt, w, h, lim),
                        ref_img.fill_black(fmt, w, h, lim)):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
    for i in range(len(got)):
        assert imgutils.component_dims(pixfmt.get(fmt), i, w, h) == \
            ref_img.component_dims(ref_pf.get(fmt), i, w, h)
    f = Frame.from_bytes(buf, fmt, w, h, device="cpu", pts=5,
                         time_base=Rational(1, 25))
    assert all(isinstance(p, torch.Tensor) for p in f.planes)
    assert f.to_bytes() == RefFrame.from_bytes(buf, fmt, w, h).to_bytes()
    n = f.numpy()
    assert all(isinstance(p, np.ndarray) for p in n.planes)
    assert n.pix_desc == pixfmt.get(fmt) and f.is_video and not f.is_audio
    assert f.best_effort_pts_seconds() == \
        RefFrame(pts=5, time_base=RefRational(1, 25)) \
        .best_effort_pts_seconds() == 0.2


def test_frame_classification_equal_reference():
    from ffmpeg_tpu.core.frame import Frame as RefFrame
    for kw in ({}, {"width": 4, "height": 2}, {"sample_rate": 48000},
               {"nb_samples": 10}, {"width": 4, "height": 2,
                                    "sample_rate": 8000}):
        p, r = Frame(**kw), RefFrame(**kw)
        assert (p.is_video, p.is_audio, p.pix_desc) == \
            (r.is_video, r.is_audio, r.pix_desc)
    assert Frame(pts=NOPTS).best_effort_pts_seconds() is None
    assert Frame(pts=3).best_effort_pts_seconds() is None


# --- the host modules of the audio frontend --------------------------------

def test_samplefmt_equal_reference():
    from ffmpeg_tpu.formats import samplefmt as ref_sf
    from ffmpeg_tpu_torch.formats import samplefmt as sf
    assert sorted(sf.all_formats()) == sorted(ref_sf.all_formats())
    x = np.random.default_rng(5).uniform(-1.2, 1.2, (2, 300)) \
        .astype(np.float32)
    for name, d in sf.all_formats().items():
        r = ref_sf.get(name)
        assert (d.name, d.dtype, d.planar, d.bits, d.bytes_per_sample,
                d.packed_alt, d.planar_alt) == \
            (r.name, r.dtype, r.planar, r.bits, r.bytes_per_sample,
             r.packed_alt, r.planar_alt)
        with np.errstate(invalid="ignore"):     # s64: 2**63 does not fit
            y = sf.from_float(x, name)
            want = ref_sf.from_float(x, name)
        assert y.dtype == r.dtype
        np.testing.assert_array_equal(y, want)
        np.testing.assert_array_equal(sf.to_float(y, name),
                                      ref_sf.to_float(y, name))
    with pytest.raises(error.InvalidData):
        sf.get("s24")


def test_channel_layouts_equal_reference():
    from ffmpeg_tpu.formats import channel_layout as ref_cl
    from ffmpeg_tpu_torch.formats import channel_layout as cl
    assert cl.CHANNELS == ref_cl.CHANNELS and cl._NAMED == ref_cl._NAMED

    def same(a, b):
        assert (a.mask, a.nb_channels, a.channel_names(), a.describe()) \
            == (b.mask, b.nb_channels, b.channel_names(), b.describe())
        for name in cl.CHANNELS[:12]:
            assert (a.index_of(name), a.has(name)) == \
                (b.index_of(name), b.has(name))
    for n in range(10):
        same(cl.default_layout(n), ref_cl.default_layout(n))
        same(cl.ChannelLayout.unspec(n), ref_cl.ChannelLayout.unspec(n))
    for s in [*cl._NAMED, "3c", "6", 2, "FL+FR+LFE", "FC", " stereo "]:
        same(cl.ChannelLayout.from_string(s),
             ref_cl.ChannelLayout.from_string(s))
    for bad in ("FL+XX", "surround", "c"):
        with pytest.raises(error.InvalidData):
            cl.ChannelLayout.from_string(bad)


@pytest.mark.parametrize("taps,phases,cutoff,window,beta", [
    (96, 1, 0.97 / 3, "kaiser", 9.0), (32, 160, 0.97, "kaiser", 9.0),
    (32, 1024, 0.97, "kaiser", 9.0), (64, 7, 0.5, "blackman_nuttall", 0.0),
    (16, 3, 0.8, "rect", 0.0), (48, 147, 0.9, "kaiser", 6.0)])
def test_fir_bank_bit_exact(taps, phases, cutoff, window, beta):
    from ffmpeg_tpu.resample import fir as ref_fir
    from ffmpeg_tpu_torch.resample import fir
    got = fir.build_filter_bank(taps, phases, cutoff, window, beta)
    assert got.dtype == np.float64 and got.shape == (phases, taps)
    np.testing.assert_array_equal(
        got, ref_fir.build_filter_bank(taps, phases, cutoff, window, beta))


def test_rematrix_equal_reference():
    from ffmpeg_tpu.formats.channel_layout import ChannelLayout as RefCL
    from ffmpeg_tpu.resample import rematrix as ref_rm
    from ffmpeg_tpu_torch.formats.channel_layout import ChannelLayout, _NAMED
    from ffmpeg_tpu_torch.resample import rematrix
    names = [*_NAMED, "FL+FR+LFE", "FC+LFE"]
    for a in names:
        for b in names:
            for kw in ({}, {"lfe_mix": 0.5, "normalize": False}):
                np.testing.assert_array_equal(
                    rematrix.build_matrix(ChannelLayout.from_string(a),
                                          ChannelLayout.from_string(b), **kw),
                    ref_rm.build_matrix(RefCL.from_string(a),
                                        RefCL.from_string(b), **kw))
    np.testing.assert_array_equal(
        rematrix.build_matrix(ChannelLayout.unspec(3), ChannelLayout.unspec(2)),
        ref_rm.build_matrix(RefCL.unspec(3), RefCL.unspec(2)))


def test_bitstream_equal_reference():
    from ffmpeg_tpu.codecs import bitstream as ref_bs
    from ffmpeg_tpu_torch.codecs import bitstream as bs
    rng = np.random.default_rng(9)
    ops = [(int(v), int(n)) for v, n in zip(rng.integers(-2 ** 20, 2 ** 20,
                                                          400),
                                            rng.integers(1, 24, 400))]
    w, rw = bs.BitWriter(), ref_bs.BitWriter()
    for i, (v, n) in enumerate(ops):
        for x in (w, rw):
            x.put_signed(v, n) if i % 3 else x.put(abs(v), n)
        assert w.bit_length() == rw.bit_length()
    w.align(1)
    rw.align(1)
    data = w.bytes()
    assert data == rw.bytes()
    r, rr = bs.BitReader(data, 5), ref_bs.BitReader(data, 5)
    for i, (_, n) in enumerate(ops):
        if r.bits_left() < 128:
            break
        for name, args in (("peek", (n,)), ("get_signed", (n,)),
                           ("get", (n,)), ("unary", ()), ("rice", (i % 4,)),
                           ("bits_left", ()), ("byte_position", ())):
            assert getattr(r, name)(*args) == getattr(rr, name)(*args), name
        if i % 50 == 0:
            r.align()
            rr.align()
    r.pos = rr.pos = len(data) * 8 - 3
    assert r.peek(12) == rr.peek(12)
    with pytest.raises(error.InvalidData):
        r.get(4)


def test_aac_tables_equal_reference():
    from ffmpeg_tpu.codecs import aac as ref_aac
    from ffmpeg_tpu.codecs import aac_tables as ref_t
    from ffmpeg_tpu_torch.codecs import aac, aac_tables
    names = [n for n in vars(ref_t) if n.isupper()]
    assert len(names) == 32 and sorted(names) == sorted(
        n for n in vars(aac_tables) if n.isupper())
    for n in names:
        assert getattr(aac_tables, n) == getattr(ref_t, n), n
    for n in ("SAMPLE_RATES", "_CB_INFO", "SCE", "CPE", "LFE", "FIL", "END",
              "ZERO_BT", "NOISE_BT", "INTENSITY_BT", "INTENSITY_BT2",
              "ESC_BT", "ONLY_LONG", "EIGHT_SHORT"):
        assert getattr(aac, n) == getattr(ref_aac, n), n
    for got, want in zip(aac._SPECTRAL_LUTS + [aac._SF_LUT],
                         ref_aac._SPECTRAL_LUTS + [ref_aac._SF_LUT]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_adts_demuxer_equals_reference(tmp_path):
    """Every packet's bytes, pts and fields and the stream's parameters
    on the committed clip; the same sync errors and the same end at a
    truncated frame."""
    from ffmpeg_tpu.io import open_input
    from ffmpeg_tpu_torch.io.adts import read_adts
    from ffmpeg_tpu_torch.testing import AAC_CLIP
    data = AAC_CLIP.read_bytes()
    par, pkts = read_adts(data)
    d = open_input(str(AAC_CLIP))
    ref = list(d.packets())
    assert len(pkts) == len(ref) == 939
    for a, b in zip(pkts, ref):
        assert (a.data, a.pts, a.dts, a.duration, a.flags,
                a.time_base.num, a.time_base.den) == \
            (b.data, b.pts, b.dts, b.duration, b.flags, b.time_base.num,
             b.time_base.den)
    rp = d.streams[0].codecpar
    assert (par.codec_type, par.codec_id, par.sample_rate, par.channels,
            par.ch_layout.mask, par.frame_size) == \
        (rp.codec_type, rp.codec_id, rp.sample_rate, rp.channels,
         rp.ch_layout.mask, rp.frame_size) == ("audio", "aac", 48000, 2, 3,
                                               1024)
    cut = data[:len(data) - 100]
    lost = bytearray(data)
    lost[len(pkts[0].data)] = 0
    for blob, name in ((cut, "cut.aac"), (bytes(lost), "lost.aac")):
        (tmp_path / name).write_bytes(blob)
    assert len(read_adts(cut)[1]) == len(list(
        open_input(str(tmp_path / "cut.aac")).packets())) == 938
    with pytest.raises(error.InvalidData, match="lost sync"):
        read_adts(bytes(lost))
    ref_it = open_input(str(tmp_path / "lost.aac")).packets()
    next(ref_it)
    with pytest.raises(ref_error.InvalidData, match="lost sync"):
        next(ref_it)
    with pytest.raises(error.InvalidData, match="bad sync"):
        read_adts(b"\x00" + data[1:])


def _spectral_cases(monkeypatch):
    """(bytes, bit position, ICSInfo, band codebooks): every ICS of the
    committed clip's first 16 packets as the port's decoder meets them,
    then seeded random bytes under random long and short ICSs."""
    from ffmpeg_tpu_torch.codecs import aac
    from ffmpeg_tpu_torch.io.adts import read_adts
    from ffmpeg_tpu_torch.testing import AAC_CLIP
    cases = []
    real = aac.decode_spectral

    def record(br, ics, band_cb):
        cases.append((bytes(br.data), br.pos, ics, band_cb))
        return real(br, ics, band_cb)
    monkeypatch.setattr(aac, "decode_spectral", record)
    par, pkts = read_adts(AAC_CLIP.read_bytes())
    aac.AacDecoder(par, device="cpu").parse_packets(pkts[:16])
    monkeypatch.setattr(aac, "decode_spectral", real)
    assert len(cases) == 32
    rng = np.random.default_rng(21)
    cbs = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15]
    for i in range(24):
        ics = aac.ICSInfo()
        if i % 2:
            ics.window_sequence, ics.num_windows = aac.EIGHT_SHORT, 8
            cuts = sorted(rng.choice(np.arange(1, 8), int(rng.integers(0, 4)),
                                     replace=False).tolist())
            ics.group_len = np.diff([0, *cuts, 8]).tolist()
            ics.swb_offset = list(aac.T.SWB_OFFSET_128[3]) + [128]
            ics.num_swb = aac.T.NUM_SWB_128[3]
        else:
            ics.swb_offset = list(aac.T.SWB_OFFSET_1024[3]) + [1024]
            ics.num_swb = aac.T.NUM_SWB_1024[3]
        ics.num_window_groups = len(ics.group_len)
        ics.max_sfb = int(rng.integers(1, ics.num_swb + 1))
        band_cb = [[int(c) for c in rng.choice(cbs, ics.max_sfb)]
                   for _ in range(ics.num_window_groups)]
        size = 40 if i % 3 == 2 else 1200     # short: reads past the end
        data = rng.integers(0, 256, size, np.uint8).tobytes()
        cases.append((data, int(rng.integers(0, 64)), ics, band_cb))
    return cases


def test_aac_spectral_cpp_equals_walker_and_reference(monkeypatch):
    """The port's C++ aac_decode_spectral, its Python walker (the plain
    version) and the reference's spectral decode (its C++, and its Python
    walker with the native library set aside) give the same coefficients
    and end position, or all refuse the bits (a bad code, or a read past
    the end), on every case of _spectral_cases."""
    from ffmpeg_tpu.codecs import aac as ref_aac
    from ffmpeg_tpu.codecs.bitstream import BitReader as RefBitReader
    from ffmpeg_tpu.io.stream import CodecParameters as RefCodecParameters
    from ffmpeg_tpu_torch.codecs import aac
    from ffmpeg_tpu_torch.codecs.bitstream import BitReader
    ref_dec = ref_aac.AacDecoder(RefCodecParameters(
        codec_type="audio", codec_id="aac", sample_rate=48000))

    def run(fn, reader, data, pos, ics, band_cb):
        br = reader(data)
        br.pos = pos
        try:
            return fn(br, ics, band_cb).tolist(), br.pos
        except (error.InvalidData, ref_error.InvalidData):
            return "refused"
    cases = _spectral_cases(monkeypatch)
    outcomes = []
    for case in cases:
        got = [run(aac.decode_spectral, BitReader, *case),
               run(aac.decode_spectral_plain, BitReader, *case),
               run(ref_dec._decode_spectral, RefBitReader, *case)]
        with monkeypatch.context() as m:
            m.setattr(ref_aac._NativeSpectral, "_state", False)
            got.append(run(ref_dec._decode_spectral, RefBitReader, *case))
        assert got[1:] == got[:1] * 3
        outcomes.append(got[0] == "refused")
    assert sum(outcomes[:32]) == 0 and 0 < sum(outcomes) < len(cases) - 32


# -- VP9: the port's copies of the host half of codecs/vp9/ ----------------

def _vp9_streams():
    """Crafted streams (as tests/test_vp9_recon_tpu.py builds them) and
    the bench stream's first five packets: [(name, [frame bytes])]."""
    import test_vp9 as K
    import test_vp9_inter as I
    from ffmpeg_tpu_torch.io.ivf import read_ivf
    from ffmpeg_tpu_torch.testing import VP9_BENCH
    out = [("kf", [K.craft_frame(K.Plan(np.random.default_rng(0)))]),
           ("tiles", [K.craft_frame(K.Plan(np.random.default_rng(4)),
                                    width=512, height=128,
                                    tile_cols_log2=1, filter_level=30,
                                    sharpness=3)])]
    rng = np.random.default_rng(7)
    s = I.CraftSession()
    s.key(K.Plan(rng))
    s.inter(I.InterPlan(rng, comp_p=0.5), signbias=(0, 0, 1), hp=True)
    s.inter(I.InterPlan(rng), filtermode=2, filter_level=20)
    out.append(("inter", s.frames))
    _par, _tb, pkts = read_ivf(VP9_BENCH.read_bytes())
    out.append(("bench", [p.data for p in pkts[:5]]))
    return out


def test_vp9_tables_and_h264_bits_equal_reference():
    from ffmpeg_tpu.codecs.h264 import bits as ref_bits
    from ffmpeg_tpu.codecs.vp9 import tables_gen as ref_T
    from ffmpeg_tpu_torch.codecs.h264 import bits
    from ffmpeg_tpu_torch.codecs.vp9 import tables_gen as T
    names = [n for n in dir(ref_T) if n.isupper()]
    assert len(names) > 40 and names == [n for n in dir(T) if n.isupper()]
    for n in names:
        a, b = getattr(T, n), getattr(ref_T, n)
        assert a.dtype == b.dtype, n
        np.testing.assert_array_equal(a, b, err_msg=n)
    data = np.random.default_rng(3).integers(0, 256, 64, np.uint8).tobytes()
    x, y = bits.Bits(data), ref_bits.Bits(data)
    for k in range(40):
        if k % 3 == 0:
            assert x.ue() == y.ue()
        elif k % 3 == 1:
            assert x.se() == y.se()
        else:
            assert x.get(k % 17) == y.get(k % 17)
        assert x.pos == y.pos and x.more_rbsp() == y.more_rbsp()


def test_vp9_bool_decoder_equals_reference():
    from ffmpeg_tpu.codecs.vp9 import bool as ref_bool
    from ffmpeg_tpu.codecs.vp9 import tables_gen as ref_T
    from ffmpeg_tpu_torch.codecs.vp9 import bool as vbool
    rng = np.random.default_rng(8)
    for size in (1, 7, 300):
        data = rng.integers(0, 256, size, np.uint8).tobytes()
        a, b = vbool.BoolDecoder(data), ref_bool.BoolDecoder(data)
        for k in range(600):
            p = int(rng.integers(1, 256))
            if k % 7 == 0:
                assert a.literal(5) == b.literal(5)
            elif k % 11 == 0:
                probs = rng.integers(1, 256, 9)
                assert a.tree(ref_T.INTRAMODE_TREE, probs) == \
                    b.tree(ref_T.INTRAMODE_TREE, probs)
            else:
                assert a.get(p) == b.get(p)
    enc, ref_enc = vbool.BoolEncoder(), ref_bool.BoolEncoder()
    for k in range(500):
        bit, p = int(rng.integers(0, 2)), int(rng.integers(1, 256))
        enc.put(bit, p)
        ref_enc.put(bit, p)
    assert enc.finish() == ref_enc.finish()


def _vp9_header_fields(h):
    out = {}
    for k, v in dataclasses.asdict(h).items():
        out[k] = np.asarray(v).tolist() if v is not None else None
    return out


def test_vp9_headers_equal_reference():
    """parse_uncompressed and parse_compressed (every probability table,
    the expanded coefficient model included) on the crafted streams and
    the bench stream's first frames, from the same saved context."""
    from ffmpeg_tpu.codecs.vp9 import header as ref_header
    from ffmpeg_tpu_torch.codecs.vp9 import header
    n = 0
    for name, frames in _vp9_streams():
        k = ref_header.parse_uncompressed(frames[0])      # the keyframe
        dims = [(k.width, k.height)] * 8
        for data in frames:
            h = header.parse_uncompressed(data, False, None, dims)
            rh = ref_header.parse_uncompressed(data, False, None, dims)
            assert _vp9_header_fields(h) == _vp9_header_fields(rh), name
            pos = (h.uncompressed_bits + 7) // 8
            comp = data[pos:pos + h.compressed_size]
            p = header.parse_compressed(h, comp, header.ProbContext())
            rp = ref_header.parse_compressed(rh, comp,
                                             ref_header.ProbContext())
            for f, _ in ref_header.ProbContext.FIELDS + [("coef3", 0),
                                                         ("coef", 0)]:
                np.testing.assert_array_equal(getattr(p, f), getattr(rp, f),
                                              err_msg=f"{name} {f}")
            assert _vp9_header_fields(h) == _vp9_header_fields(rh)
            n += 1
    assert n == 10


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_vp9_itxfm_kernels_equal_reference(n):
    """Each 1-D kernel on random int32 columns: the port's copy on torch
    int32 tensors (stack=torch.stack, as recon_tpu calls it) and on
    numpy int64 (the host path) against the reference's on numpy int32
    and int64; then itxfm_add on random blocks of every type."""
    from ffmpeg_tpu.codecs.vp9 import itxfm as ref_tx
    from ffmpeg_tpu_torch.codecs.vp9 import itxfm as tx
    rng = np.random.default_rng(n)
    x = rng.integers(-(1 << 15), 1 << 15, (n, 96)).astype(np.int32)
    for kind in ("dct", "adst"):
        if (n, kind) not in ref_tx._KERNELS:
            continue
        want32 = ref_tx._KERNELS[(n, kind)](x)
        got32 = tx._KERNELS[(n, kind)](torch.from_numpy(x),
                                       stack=torch.stack)
        assert got32.dtype == torch.int32
        np.testing.assert_array_equal(got32.numpy(), want32)
        np.testing.assert_array_equal(
            tx._KERNELS[(n, kind)](x.astype(np.int64)),
            ref_tx._KERNELS[(n, kind)](x.astype(np.int64)))
    for txtp in range(4):
        block = (rng.integers(-600, 600, (n, n))
                 * (rng.random((n, n)) < 0.2)).astype(np.int32)
        dst = rng.integers(0, 256, (n, n)).astype(np.uint8)
        a, b = dst.copy(), dst.copy()
        eob = int((block != 0).sum()) or 1
        tx.itxfm_add(a, block, txtp if n < 32 else 0, eob)
        ref_tx.itxfm_add(b, block, txtp if n < 32 else 0, eob)
        np.testing.assert_array_equal(a, b)


def test_vp9_intra_and_inter_predictors_equal_reference():
    from ffmpeg_tpu.codecs.vp9 import inter as ref_inter
    from ffmpeg_tpu.codecs.vp9 import intra as ref_intra
    from ffmpeg_tpu_torch.codecs.vp9 import inter, intra
    rng = np.random.default_rng(12)
    for n in (4, 8, 16, 32):
        for mode in range(15):
            left = rng.integers(0, 256, n).astype(np.int32)
            top = rng.integers(0, 256, 2 * n).astype(np.int32)
            tl = int(rng.integers(0, 256))
            np.testing.assert_array_equal(
                intra.predict(mode, n, left, top, tl),
                ref_intra.predict(mode, n, left, top, tl))
    np.testing.assert_array_equal(inter.FILTERS, ref_inter.FILTERS)
    ref = rng.integers(0, 256, (72, 96)).astype(np.uint8)
    for k in range(40):
        bh, bw = (4, 8, 16)[k % 3], (8, 4, 16, 32)[k % 4]
        y, x = int(rng.integers(0, 72 - bh)), int(rng.integers(0, 96 - bw))
        mvx, mvy = (int(v) for v in rng.integers(-200, 200, 2))
        shift, filt, avg = 3 + k % 2, k % 4, bool(k % 5 == 0)
        pre = rng.integers(0, 256, (bh, bw)).astype(np.uint8)
        a, b = pre.copy(), pre.copy()
        inter.mc_block(a, 0, 0, bh, bw, ref, y, x, mvx, mvy, shift, filt,
                       96, 72, avg)
        ref_inter.mc_block(b, 0, 0, bh, bw, ref, y, x, mvx, mvy, shift,
                           filt, 96, 72, avg)
        np.testing.assert_array_equal(a, b)


def test_vp9_lf_luts_equal_reference():
    from ffmpeg_tpu.codecs.vp9 import lf as ref_lf
    from ffmpeg_tpu_torch.codecs.vp9 import lf
    from ffmpeg_tpu_torch.codecs.vp9.lf_tpu import _luts
    for sharp in range(8):
        for a, b, c in zip(lf._luts(sharp), _luts(sharp),
                           ref_lf._luts(sharp)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)


def test_vp9_native_record_equals_reference():
    """The port's C++ tile walk (csrc/host/vp9_parse.cpp, built by the
    port's native.py) against the reference's on all 100 frames of the
    bench stream: every record array, the level count, the grids the
    next frame and the loop filter read, and the adaptation counts."""
    from ffmpeg_tpu.codecs.vp9 import VP9Core as RefCore
    from ffmpeg_tpu_torch.codecs.vp9 import VP9Core
    from ffmpeg_tpu_torch.io.ivf import read_ivf
    from ffmpeg_tpu_torch.testing import VP9_BENCH
    _par, _tb, pkts = read_ivf(VP9_BENCH.read_bytes())
    port, ref = VP9Core(native=True, device="cpu"), RefCore(native=True)
    port.capture, ref.capture = [], []
    for p in pkts:
        port.decode_frame(p.data)
        ref.decode_frame(p.data)
        (_h, fs, rec), (_rh, rfs, rrec) = port.capture[-1], ref.capture[-1]
        assert rec.max_level == rrec.max_level
        for cls in rrec.mc_arr:
            np.testing.assert_array_equal(rec.mc_arr[cls], rrec.mc_arr[cls])
        for arrs, rarrs in ((rec.tu_arr, rrec.tu_arr),
                            (rec.in_arr, rrec.in_arr)):
            assert list(arrs) == list(rarrs)
            for cls in rarrs:
                for a, b in zip(arrs[cls], rarrs[cls]):
                    np.testing.assert_array_equal(a, b)
        for g in ("mv_ref", "mv_xy", "lf_lvl", "wd_v", "wd_h", "wd_v_uv",
                  "wd_h_uv"):
            np.testing.assert_array_equal(getattr(fs, g), getattr(rfs, g))
        for k, v in rfs.counts.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    np.testing.assert_array_equal(fs.counts[k][kk], vv)
            else:
                np.testing.assert_array_equal(fs.counts[k], v)
    assert len(port.capture) == 100
    assert port.capture[0][2].max_level == 579


def test_ivf_reader_equals_reference(tmp_path):
    """Every packet's bytes, pts and flags and the stream's parameters on
    the committed streams; the same end at a truncated frame."""
    from ffmpeg_tpu.io import open_input
    from ffmpeg_tpu_torch.io.ivf import read_ivf
    from ffmpeg_tpu_torch.testing import VP9_BENCH, VP9_LF
    for path in (VP9_BENCH, VP9_LF):
        data = path.read_bytes()
        par, tb, pkts = read_ivf(data)
        d = open_input(str(path))
        ref = list(d.packets())
        assert len(pkts) == len(ref) > 0
        for a, b in zip(pkts, ref):
            assert (a.data, a.pts, a.dts, a.flags, a.time_base.num,
                    a.time_base.den) == (b.data, b.pts, b.dts, b.flags,
                                         b.time_base.num, b.time_base.den)
        rp = d.streams[0].codecpar
        assert (par.codec_type, par.codec_id, par.width, par.height) == \
            (rp.codec_type, rp.codec_id, rp.width, rp.height)
        assert (tb.num, tb.den) == (d.streams[0].time_base.num,
                                    d.streams[0].time_base.den)
    cut = VP9_LF.read_bytes()[:-100]
    (tmp_path / "cut.ivf").write_bytes(cut)
    assert len(read_ivf(cut)[2]) == len(list(
        open_input(str(tmp_path / "cut.ivf")).packets())) == 2
    with pytest.raises(error.InvalidData, match="bad magic"):
        read_ivf(b"XKIF" + cut[4:])


def _same(a, b) -> bool:
    """Deep equality of nested lists, tuples, numbers and arrays."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("name", ["mp3_tables", "ac3_tables", "eac3_tables",
                                  "aacsbr_tables", "ps_tables",
                                  "vorbis_tables", "opus.tables_gen"])
def test_audio_decoder_tables_equal_reference(name):
    import importlib
    ref = importlib.import_module(f"ffmpeg_tpu.codecs.{name}")
    port = importlib.import_module(f"ffmpeg_tpu_torch.codecs.{name}")
    names = sorted(n for n in vars(ref) if n.isupper())
    assert names and names == sorted(n for n in vars(port) if n.isupper())
    for n in names:
        assert _same(getattr(port, n), getattr(ref, n)), n


def test_mp3_luts_and_ac3_bit_allocation_equal_reference():
    """The MP3 decoder's Huffman LUTs, band indices and antialias
    coefficients; the AC-3 PSD, masking curve and bap of seeded
    exponents, for the AC-3 and the high-efficiency bap tables."""
    from ffmpeg_tpu.codecs import ac3 as ref_ac3
    from ffmpeg_tpu.codecs import mp3 as ref_mp3
    from ffmpeg_tpu_torch.codecs import ac3, mp3
    ref_mp3._init_tables()
    mp3._init_tables()
    for got, want in zip(mp3._HUFF_LUTS + mp3._QUAD_LUTS,
                         ref_mp3._HUFF_LUTS + ref_mp3._QUAD_LUTS):
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(mp3._band_index_long(),
                                  ref_mp3._band_index_long())
    for g, w in zip(mp3.Mp3Decoder._make_csa(),
                    ref_mp3.Mp3Decoder._make_csa()):
        np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(12)
    ba = {"sr_code": 1, "sr_shift": 0, "slow_decay": 15, "fast_decay": 83,
          "slow_gain": 1344, "db_per_bit": 2048, "floor": 0x2F0,
          "cpl_fast_leak": 0, "cpl_slow_leak": 0}
    for end in (253, 181, 37):
        exps = rng.integers(0, 25, 256).astype(np.int8)
        psd, band = ac3._calc_psd(exps, 0, end)
        rpsd, rband = ref_ac3._calc_psd(exps, 0, end)
        np.testing.assert_array_equal(psd, rpsd)
        np.testing.assert_array_equal(band, rband)
        mask = ac3._calc_mask(ba, band, 0, end, 1280, end == 37, None)
        np.testing.assert_array_equal(mask, ref_ac3._calc_mask(
            ba, rband, 0, end, 1280, end == 37, None))
        for tab, ref_tab in ((ac3.T.BAP_TAB, ref_ac3.T.BAP_TAB),
                             (ac3.E.HEBAP_TAB, ref_ac3.E.HEBAP_TAB)):
            np.testing.assert_array_equal(
                ac3._calc_bap(mask, psd, 0, end, 40, ba["floor"], tab),
                ref_ac3._calc_bap(mask, rpsd, 0, end, 40, ba["floor"],
                                  ref_tab))


def test_video_filter_tables_equal_reference():
    from ffmpeg_tpu.filters import framesync as ref_fs
    from ffmpeg_tpu.filters import sources as ref_src
    from ffmpeg_tpu.filters import video5 as ref_v5
    from ffmpeg_tpu.filters import video6 as ref_v6
    from ffmpeg_tpu.filters import video7 as ref_v7
    from ffmpeg_tpu.ops import deblock as ref_deblock
    from ffmpeg_tpu.scale import lut3d as ref_lut3d
    from ffmpeg_tpu_torch.filters import framesync, sources, video5, video6
    from ffmpeg_tpu_torch.filters import video7
    from ffmpeg_tpu_torch.ops import deblock
    from ffmpeg_tpu_torch.scale import lut3d
    for a, b in ((deblock._ALPHA, ref_deblock._ALPHA),
                 (deblock._BETA, ref_deblock._BETA)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for n in (2, 9, 17, 33, 65):
        a, b = lut3d.identity_lut(n), ref_lut3d.identity_lut(n)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    cube = "TITLE x\nLUT_3D_SIZE 2\nDOMAIN_MIN 0.1 0.1 0.1\n" \
        "DOMAIN_MAX 0.9 0.9 0.9\n" + "\n".join(
            f"{r * 0.7:.3f} {g * 0.9:.3f} {b * 0.5 + 0.2:.3f}"
            for b in range(2) for g in range(2) for r in range(2))
    (t, lo, hi), (rt, rlo, rhi) = lut3d.parse_cube(cube), \
        ref_lut3d.parse_cube(cube)
    np.testing.assert_array_equal(t, rt)
    assert (lo, hi) == (rlo, rhi) == (0.1, 0.9)
    assert sources.ColorSource._COLORS == ref_src.ColorSource._COLORS
    assert video6.ExtractPlanesFilter._NAMES == \
        ref_v6.ExtractPlanesFilter._NAMES
    for c in ("black", "Lime", "#ff8000", "0x123456", "green", "abcdef"):
        assert video6._parse_color(c) == ref_v6._parse_color(c)
    assert (video6.SobelFilter._KX, video6.SobelFilter._KY,
            video6.PrewittFilter._KX, video6.PrewittFilter._KY) == \
        (ref_v6.SobelFilter._KX, ref_v6.SobelFilter._KY,
         ref_v6.PrewittFilter._KX, ref_v6.PrewittFilter._KY)
    assert video5._LUMA == ref_v5._LUMA
    for x in (0.0, 0.5, 1.0, 4.0, 100.0):
        assert video5._hable(x) == ref_v5._hable(x)
    for name in ("_CSP_COEFFS", "_TRC", "_PRIMARIES", "_WP_D65",
                 "_SPACE_ALIASES", "_LUT_LO", "_LUT_HI", "_I16_HI"):
        assert getattr(video7, name) == getattr(ref_v7, name), name
    assert video7.ColorspaceFilter._ALL == ref_v7.ColorspaceFilter._ALL
    for sp in video7._CSP_COEFFS:
        np.testing.assert_array_equal(
            video7._yuv2rgb_matrix(video7._CSP_COEFFS[sp]),
            ref_v7._yuv2rgb_matrix(ref_v7._CSP_COEFFS[sp]))
    for pr in video7._PRIMARIES:
        np.testing.assert_array_equal(
            video7._rgb2xyz(video7._PRIMARIES[pr]),
            ref_v7._rgb2xyz(ref_v7._PRIMARIES[pr]))
    # the frame aligner: the same groups on the same pts streams
    pts = [[0, 1, 2, 3, 4], [0, 2, 3], [1, 4]]
    got = []
    for mod, fmod in ((framesync, Frame), (ref_fs, None)):
        from ffmpeg_tpu.core.frame import Frame as RefFrame
        F = fmod or RefFrame
        R = Rational if fmod else RefRational
        fs = mod.FrameSync(3)
        out = []
        for k in range(5):
            for pad, ps in enumerate(pts):
                if k < len(ps):
                    fs.push(F(pts=ps[k], time_base=R(1, 25)), pad)
            out += [[f and f.pts for f in g] for g in fs.events()]
        for pad in range(3):
            fs.push(None, pad)
        out += [[f and f.pts for f in g] for g in fs.events()]
        got.append(out)
    assert got[0] == got[1] and len(got[0]) >= 3


HOST_COPIES = ["codecs/vorbis_tables.py", "codecs/opus/tables_gen.py",
               "codecs/opus/rc.py", "codecs/opus/silk.py",
               "codecs/opus/silk_resample.py", "filters/audio2.py",
               "filters/audio3.py", "filters/audio4.py", "filters/audio5.py",
               "filters/audio6.py"]


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_copy_code_equals_reference(rel):
    """The port's copy has the reference's code, statement for statement:
    the syntax trees without the module docstring are equal."""
    import ast
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent

    def body(pkg):
        tree = ast.parse((root / pkg / rel).read_text())
        stmts = tree.body
        if stmts and isinstance(stmts[0], ast.Expr) and \
                isinstance(stmts[0].value, ast.Constant):
            stmts = stmts[1:]
        return [ast.dump(x) for x in stmts]
    assert body("ffmpeg_tpu_torch") == body("ffmpeg_tpu")


def _rc_walk(rc_mod, data: bytes) -> list:
    """A fixed sequence of the range decoder's calls over one frame, with
    its state after each."""
    from ffmpeg_tpu_torch.codecs.opus import tables_gen as T
    rc = rc_mod.RangeCoder(data)
    out = [(rc.range, rc.value, rc.tell(), rc.tell_frac())]
    for i in range(40):
        op = i % 8
        if op == 0:
            v = rc.dec_log(1 + i % 15)
        elif op == 1:
            v = rc.dec_cdf(T.MODEL_SPREAD)
        elif op == 2:
            v = rc.dec_uint(3 + 37 * i)
        elif op == 3:
            v = rc.get_raw(1 + i % 9)
        elif op == 4:
            v = rc.dec_laplace(100 << 7, 60 << 6)
        elif op == 5:
            v = rc.dec_uint_step(1 + i % 3)
        elif op == 6:
            v = rc.dec_uint_tri(2 + i % 13)
        else:
            v = rc.dec_cdf(T.MODEL_ALLOC_TRIM)
        out.append((v, rc.range, rc.value, rc.total_bits, rc.tell(),
                    rc.tell_frac()))
    return out


def test_opus_range_decoder_equals_reference_on_recorded_packets():
    """Both range decoders over every frame of every committed Opus stream
    (tests/data/port/audio_codecs_streams.npz), the same calls in the
    same order: the same symbols, range, value and bit counts."""
    from ffmpeg_tpu.codecs import opus as ref_opus
    from ffmpeg_tpu.codecs.opus import rc as ref_rc
    from ffmpeg_tpu_torch import testing as fx
    from ffmpeg_tpu_torch.codecs.opus import rc
    frames = [f for n in fx.CELT_STREAM_NAMES + fx.SILK_STREAM_NAMES
              for p in fx.codec_stream(n)["packets"]
              for f in ref_opus.parse_packet(p)[2] if f]
    assert len(frames) > 250
    for f in frames:
        assert _rc_walk(rc, f) == _rc_walk(ref_rc, f)
    for v in (0, 1, 2, 99, 10 ** 6, 2 ** 40 + 7):
        assert rc._isqrt(v) == ref_rc._isqrt(v)
    enc, ref_enc = rc.RangeEncoder(), ref_rc.RangeEncoder()
    for e in (enc, ref_enc):
        for i in range(50):
            e.enc_log(i % 3 == 0, 1 + i % 5)
            e.enc_uint(i * 7 % 300, 300)
            e.put_raw(i & 15, 4)
    assert enc.finish() == ref_enc.finish()


def test_silk_resampler_equals_reference():
    """The SILK → 48 kHz banks, and convert / flush on seeded input carried
    over three calls at each SILK rate."""
    from ffmpeg_tpu.codecs.opus import silk_resample as ref_sr
    from ffmpeg_tpu_torch.codecs.opus import silk_resample as sr
    rng = np.random.default_rng(9)
    for rate in (8000, 12000, 16000):
        np.testing.assert_array_equal(sr._build_bank(48000 // rate),
                                      ref_sr._build_bank(48000 // rate))
        a, b = sr.SilkResampler(rate, 2), ref_sr.SilkResampler(rate, 2)
        for n in (rate // 100, rate // 50, 7):
            x = [rng.standard_normal(n).astype(np.float32) * 0.3
                 for _ in range(2)]
            for got, want in zip(a.convert(x, 960), b.convert(x, 960)):
                np.testing.assert_array_equal(got, want)
        for got, want in zip(a.flush(40), b.flush(40)):
            np.testing.assert_array_equal(got, want)
