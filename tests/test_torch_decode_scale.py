"""The host-entropy decode→scale path (ffmpeg_tpu_torch/models/
mjpeg_pipeline.py) and the `entry()` twin (ffmpeg_tpu_torch/entry.py)
against the reference's, on the CPU; and the committed golden of the
reference (tests/data/port/flagship_1080p_8_decode_scale_golden.npz,
written by tools/gen_torch_decode_scale_fixture.py), tied to the
reference here and held against the port.

Tolerance: outputs within 1 LSB on <= 1% of samples (float32 sums in
another order, another batch size, before floor(x + 0.5)); for the port
against the golden also PSNR >= 60 dB, the bounds the card's check uses.
Specs, example arguments and the wire bitcast are exact."""

import numpy as np
import pytest
import torch

from ffmpeg_tpu.models import mjpeg_pipeline as ref
from ffmpeg_tpu_torch import entry
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.models import mjpeg_pipeline as port

from torch_port_util import fixture_packets

AUTO = (fx.W, fx.H, fx.OUT, fx.OUT)


def _close(got, want, psnr=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())
    if psnr:
        mse = (d.astype(np.float64) ** 2).mean()
        assert 10 * np.log10(255 ** 2 / max(mse, 1e-12)) >= 60


def _spec_fields(s):
    return (s.width, s.height, s.sub_w, s.sub_h, s.out_w, s.out_h,
            s.out_fmt, s.filter, s.lowres, s.ncoeff, s.luma_blocks,
            s.chroma_blocks, s.chroma_dims)


@pytest.mark.parametrize("size", [
    (1920, 1080, 224, 224), (1280, 720, 224, 224), (640, 360, 224, 224),
    (3840, 2160, 224, 224), (3840, 2160, 256, 256), (256, 192, 128, 128),
    (1919, 1081, 112, 112), (4096, 2160, 240, 135), (100, 60, 24, 16)])
@pytest.mark.parametrize("sub", [(2, 2), (2, 1), (1, 1)])
def test_spec_auto_and_properties_equal_reference(size, sub):
    assert _spec_fields(port.DecodeScaleSpec.auto(*size, *sub)) == \
        _spec_fields(ref.DecodeScaleSpec.auto(*size, *sub))
    assert _spec_fields(port.DecodeScaleSpec(*size[:2])) == \
        _spec_fields(ref.DecodeScaleSpec(*size[:2]))


def test_auto_picks_lowres_2_for_the_flagship():
    s = port.DecodeScaleSpec.auto(*AUTO)
    assert (s.lowres, s.ncoeff, s.luma_blocks, s.chroma_blocks) == \
        (2, 12, (136, 240), (68, 120))


@pytest.mark.parametrize("batch,seed", [(2, 0), (3, 5)])
def test_example_args_byte_equal(batch, seed):
    spec = port.DecodeScaleSpec(width=256, height=192, out_w=128, out_h=128)
    rspec = ref.DecodeScaleSpec(width=256, height=192, out_w=128, out_h=128)
    got = port.example_args(spec, batch, seed)
    want = ref.example_args(rspec, batch, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_unpack_coeffs_is_the_little_endian_bitcast():
    a = np.random.default_rng(1).integers(-2048, 2048, (2, 3, 4, 12)) \
        .astype(np.int16)
    wire = port.pack_coeffs(a)
    got = port._unpack_coeffs(torch.from_numpy(wire))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), a)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref._unpack_coeffs(wire)))
    strided = torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(wire, 1, 2))).transpose(1, 2)
    np.testing.assert_array_equal(port._unpack_coeffs(strided).numpy(), a)
    with pytest.raises(ValueError):
        port._unpack_coeffs(torch.zeros(2, 3, dtype=torch.uint8))


def test_entry_twin_matches_reference_entry():
    import jax
    import __graft_entry__ as ge
    rfn, rargs = ge.entry()
    want = jax.jit(rfn)(*rargs)
    fn, args = entry.entry(device="cpu")
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for a in args)
    for a, r in zip(args, rargs):
        assert a.numpy().tobytes() == np.asarray(r).tobytes()
    got = fn(*args)
    assert [tuple(o.shape) for o in got] == [(2, 128, 128)] * 3
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    assert port.cached_decode_scale(entry.SPEC) is \
        port.cached_decode_scale(entry.SPEC)


def _fixture_args(spec, frames):
    per = [fx.scan_coeffs(p, spec.ncoeff) for p in frames]
    wire = [port.pack_coeffs(np.stack([f[i] for f in per]))
            for i in range(3)]
    return wire, per[0][3], per[0][4]


def _golden():
    g = np.load(fx.DECODE_SCALE_GOLDEN)
    assert g["decode_scale"].shape == (3, 8, fx.OUT, fx.OUT)
    assert g["graph"].shape == (3, fx.GRAPH_FRAMES, fx.OUT, fx.OUT)
    assert g["decode_scale"].dtype == g["graph"].dtype == np.uint8
    return g


def test_port_coefficients_equal_reference_host_decode():
    """The port's C++ at L=12 gives the reference's coefficients."""
    import importlib.util
    spec_ = importlib.util.spec_from_file_location(
        "gen_fixture", fx.DATA.parent.parent.parent / "tools"
        / "gen_torch_decode_scale_fixture.py")
    gen = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(gen)
    spec = ref.DecodeScaleSpec.auto(*AUTO)
    pkt = fixture_packets()[3]
    for g, w in zip(fx.scan_coeffs(pkt, spec.ncoeff),
                    gen.reference_coeffs(pkt, spec)):
        np.testing.assert_array_equal(g, w)


def test_decode_scale_fixture_frame0_reference_port_golden():
    """Frame 0 at the 1080p auto spec: the reference reproduces its
    golden, and the port matches both."""
    spec = port.DecodeScaleSpec.auto(*AUTO)
    wire, qy, qc = _fixture_args(spec, fixture_packets()[:1])
    want = np.stack([np.asarray(c) for c in ref.build_decode_scale(
        ref.DecodeScaleSpec.auto(*AUTO))(*wire, qy, qc)])
    got = np.stack([c.numpy() for c in port.build_decode_scale(spec)(
        *[torch.from_numpy(w) for w in wire], torch.from_numpy(qy),
        torch.from_numpy(qc))])
    gold = _golden()["decode_scale"][:, :1]
    _close(want, gold)
    _close(got, want)
    _close(got, gold, psnr=True)


def test_graph_golden_frame0_reference_and_port():
    """The decoder → scale graph on frame 0: the reference reproduces
    its golden, and the port (decoder and graph on the CPU) matches it."""
    from ffmpeg_tpu.codecs import CodecContext as RefCtx
    from ffmpeg_tpu.core.packet import Packet as RefPacket
    from ffmpeg_tpu.filters import parse_graph as ref_parse_graph
    from ffmpeg_tpu.io.stream import CodecParameters as RefParams
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.core.packet import Packet
    from ffmpeg_tpu_torch.filters import parse_graph
    from ffmpeg_tpu_torch.io.stream import CodecParameters
    pkt = fixture_packets()[0]
    gold = _golden()["graph"][:, 0]
    rf = RefCtx.open_decoder(RefParams(codec_type="video", codec_id="mjpeg")
                             ).decode_all([RefPacket(data=pkt)])
    want = ref_parse_graph(fx.GRAPH_TEXT).run(rf)[0]
    _close(np.stack([np.asarray(p) for p in want.planes]), gold)
    pf = CodecContext.open_decoder(CodecParameters(codec_id="mjpeg"),
                                   device="cpu").decode_all(
                                       [Packet(data=pkt)])
    g = parse_graph(fx.GRAPH_TEXT, device="cpu")
    assert [n.filter.name for n in g.nodes] == ["scale"]
    got = g.run(pf)[0]
    assert (got.format, got.width, got.height) == ("rgb24", fx.OUT, fx.OUT)
    _close(np.stack([p.numpy() for p in got.planes]), gold, psnr=True)
