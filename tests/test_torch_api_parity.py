"""Behaviour of the public host names that the port carries for name
parity with the reference (tests/test_torch_parity.py checks that they
exist): each against the reference's on the CPU."""

import dataclasses
import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import ffmpeg_tpu
from ffmpeg_tpu.codecs import mpeg12 as ref_mpeg12
from ffmpeg_tpu.filters import get_filter as ref_get_filter
from ffmpeg_tpu.filters.base import VideoProps as RefVideoProps
from ffmpeg_tpu.formats import pixfmt as ref_pf
from ffmpeg_tpu.models import mjpeg_tpu_entropy as ref_entropy
from ffmpeg_tpu.utils import error as ref_error
from ffmpeg_tpu.utils import rational as ref_rat

import ffmpeg_tpu_torch
from ffmpeg_tpu_torch import codecs
from ffmpeg_tpu_torch.codecs import codec as codec_mod
from ffmpeg_tpu_torch.codecs import mpeg12
from ffmpeg_tpu_torch.codecs.mpeg12_enc import Mpeg2Encoder
from ffmpeg_tpu_torch.filters import get_filter
from ffmpeg_tpu_torch.filters.base import VideoProps
from ffmpeg_tpu_torch.formats import pixfmt
from ffmpeg_tpu_torch.models import mjpeg_tpu_entropy
from ffmpeg_tpu_torch.utils import error
from ffmpeg_tpu_torch.utils import rational as rat

SIZES = [(1920, 1080), (1919, 1081), (1, 1), (7, 3), (641, 359)]


@pytest.mark.parametrize("name", sorted(pixfmt.all_formats()))
def test_pixfmt_geometry_matches_reference(name):
    desc, ref = pixfmt.get(name), ref_pf.get(name)
    assert desc.bits_per_pixel() == ref.bits_per_pixel()
    for plane in range(4):
        assert desc.plane_width_mult(plane) == ref.plane_width_mult(plane)
        assert desc._plane_is_chroma(plane) == ref._plane_is_chroma(plane)
        for w, h in SIZES:
            assert desc.plane_dims(plane, w, h) == \
                ref.plane_dims(plane, w, h), (plane, w, h)


def test_pixfmt_table_and_exists_match_reference():
    # the reference also registers the yuvj names, which its get() never
    # returns (they are aliases first); the port registers them only as
    # aliases
    shadowed = {n for n in ref_pf.all_formats() if n in ref_pf._ALIASES}
    assert set(pixfmt.all_formats()) == set(ref_pf.all_formats()) - shadowed
    assert pixfmt._ALIASES == ref_pf._ALIASES
    names = (set(ref_pf.all_formats()) | set(ref_pf._ALIASES)
             | {"no-such-format", "", "YUV420P", "yuv420p "})
    for n in sorted(names):
        assert pixfmt.exists(n) == ref_pf.exists(n), n
    assert pixfmt.exists("nv12") and not pixfmt.exists("no-such-format")


@pytest.mark.parametrize("cls", ["ColorRange", "ColorSpace",
                                 "ColorPrimaries", "ColorTransfer"])
def test_colour_enums_match_reference(cls):
    def attrs(c):
        return {k: v for k, v in vars(c).items() if not k.startswith("_")}
    got = attrs(getattr(pixfmt, cls))
    assert got and got == attrs(getattr(ref_pf, cls))


rationals = st.builds(lambda n, d: (n, d), st.integers(-10 ** 12, 10 ** 12),
                      st.integers(1, 10 ** 9))


@settings(max_examples=200, deadline=None)
@given(a=st.integers(-2 ** 62, 2 ** 62), b=st.integers(0, 2 ** 40),
       c=st.integers(1, 2 ** 40))
def test_rescale_matches_reference(a, b, c):
    assert rat.rescale(a, b, c) == ref_rat.rescale(a, b, c)


@settings(max_examples=200, deadline=None)
@given(x=rationals, y=rationals)
def test_gcd_q_matches_reference(x, y):
    got = rat.gcd_q(rat.Rational(*x), rat.Rational(*y))
    want = ref_rat.gcd_q(ref_rat.Rational(*x), ref_rat.Rational(*y))
    assert (got.num, got.den) == (want.num, want.den)


@settings(max_examples=100, deadline=None)
@given(ts=st.integers(-2 ** 62, 2 ** 62), tb=rationals.filter(
    lambda r: r[0] > 0))
def test_time_base_q_matches_reference(ts, tb):
    assert rat.TIME_BASE == ref_rat.TIME_BASE == 1000000
    q, rq = rat.TIME_BASE_Q, ref_rat.TIME_BASE_Q
    assert (q.num, q.den) == (rq.num, rq.den) == (1, 1000000)
    assert rat.rescale_q(ts, q, rat.Rational(*tb)) == \
        ref_rat.rescale_q(ts, rq, ref_rat.Rational(*tb))


def test_bug_error_class_chain():
    def chain(c):
        return [k.__name__ for k in c.__mro__]
    assert chain(error.BugError) == chain(ref_error.BugError) == \
        ["BugError", "FFTPUError", "Exception", "BaseException", "object"]
    assert error.BugError.__doc__ == ref_error.BugError.__doc__
    with pytest.raises(error.FFTPUError):
        raise error.BugError("invariant")


def test_i_zz_matches_reference():
    got = [mpeg12.i_zz(p) for p in range(64)]
    assert got == [ref_mpeg12.i_zz(p) for p in range(64)]
    assert sorted(got) == list(range(64))


def test_registered_toy_decoder_is_listed_then_removed():
    @codecs.register_decoder
    class ToyDecoder(codecs.Codec):
        codec_id = "toy_parity_codec"
        aliases = ("toy_parity_alias",)

    try:
        names = codecs.decoder_names()
        assert {"toy_parity_codec", "toy_parity_alias"} <= set(names)
        assert "toy_parity_codec" not in codecs.encoder_names()
    finally:
        for k in ("toy_parity_codec", "toy_parity_alias"):
            codec_mod._DECODERS.pop(k, None)
    assert "toy_parity_codec" not in codecs.decoder_names()


def test_registered_toy_encoder_is_listed_then_removed():
    @codecs.register_encoder
    class ToyEncoder(codecs.Codec):
        codec_id = "toy_parity_encoder"
        is_encoder = True

    try:
        assert "toy_parity_encoder" in codecs.encoder_names()
    finally:
        codec_mod._ENCODERS.pop("toy_parity_encoder", None)
    assert "toy_parity_encoder" not in codecs.encoder_names()


def test_codec_class_attributes_match_reference():
    from ffmpeg_tpu.codecs.codec import Codec as RefCodec
    from ffmpeg_tpu.codecs.mpeg12_enc import Mpeg2Encoder as RefMpeg2
    for attr in ("is_encoder", "capabilities"):
        assert getattr(codecs.Codec, attr) == getattr(RefCodec, attr)
    assert Mpeg2Encoder.is_encoder is RefMpeg2.is_encoder is True
    assert Mpeg2Encoder.codec_type == RefMpeg2.codec_type


def test_package_exports_match_reference():
    from ffmpeg_tpu_torch import Frame, Packet, Rational, log
    from ffmpeg_tpu_torch.core.frame import Frame as F2
    from ffmpeg_tpu_torch.core.packet import Packet as P2
    from ffmpeg_tpu_torch.utils import log as log2
    assert (Frame, Packet, Rational, log) == (F2, P2, rat.Rational, log2)
    assert ffmpeg_tpu_torch.__all__ == ffmpeg_tpu.__all__
    import ffmpeg_tpu.codecs as ref_codecs
    assert codecs.__all__ == ref_codecs.__all__
    for n in codecs.__all__:
        assert getattr(codecs, n) is getattr(codec_mod, n)


def test_entropy_spec_fields_match_reference():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(mjpeg_tpu_entropy.TpuEntropySpec) == \
        fields(ref_entropy.TpuEntropySpec)
    spec = mjpeg_tpu_entropy.TpuEntropySpec(1920, 1080, 224, 224,
                                            lut_bits=8)
    assert spec.mcus == ref_entropy.TpuEntropySpec(1920, 1080, 224,
                                                   224).mcus


def test_normalize_update_frame_props_matches_reference():
    def run(get, props_cls, rational):
        f = get("tensornorm")("")
        frame = types.SimpleNamespace(width=1, height=1, format="rgb24",
                                      color_range="pc",
                                      color_space="unspecified")
        out = f.update_frame_props(frame, props_cls(
            224, 160, "rgbf32le", rational(1, 25), color_space="bt709"))
        assert out is frame
        return vars(out)
    assert run(get_filter, VideoProps, rat.Rational) == \
        run(ref_get_filter, RefVideoProps, ref_rat.Rational)
