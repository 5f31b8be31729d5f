"""The port's MJPEG decoder (ffmpeg_tpu_torch/codecs/mjpeg.py
`MjpegDecoder`, through `CodecContext.open_decoder`) and the one-shot
`scale_frame` against the reference's, on the CPU.

Tolerance: the decoded planes within 1 LSB on <= 1% of samples (both
packages decode the scan with the same C++ and transform in float32,
summing in their own orders before the truncating cast); frame props,
pts and counts exact.  The decode backstop turns malformed input into
InvalidData as the reference's does, but lets a fault of the card or of
a build through unchanged."""

import numpy as np
import pytest
import torch

from ffmpeg_tpu.codecs import CodecContext as RefCodecContext
from ffmpeg_tpu.core.frame import Frame as RefFrame
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io.stream import CodecParameters as RefParams
from ffmpeg_tpu.scale.swscale import scale_frame as ref_scale_frame
from ffmpeg_tpu_torch import native
from ffmpeg_tpu_torch.codecs import CodecContext, decoder_names
from ffmpeg_tpu_torch.codecs.mjpeg import MjpegDecoder
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType
from ffmpeg_tpu_torch.scale.swscale import scale_frame
from ffmpeg_tpu_torch.utils.error import DecoderNotFound, InvalidData
from ffmpeg_tpu_torch.utils.rational import Rational

from torch_port_util import encode_jpeg, fixture_packets


def _within_one_lsb(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape and got.numpy().dtype == want.dtype
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(),
                                                      (d > 0).mean())


def _decode_both(pkts, par=None):
    par = par or {}
    ref = RefCodecContext.open_decoder(RefParams(
        codec_type="video", codec_id="mjpeg", **par))
    port = CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="mjpeg", **par), device="cpu")
    want = ref.decode_all([RefPacket(data=p, pts=i) for i, p in
                           enumerate(pkts)])
    got = port.decode_all([Packet(data=p, pts=i) for i, p in
                           enumerate(pkts)])
    return want, got


@pytest.mark.parametrize("w,h,opts", [
    (64, 48, {}),
    (72, 40, {"restart_interval": 4, "huffman": "default"}),
    (64, 48, {"pix_fmt": "yuv422p"}),
    (48, 32, {"pix_fmt": "yuv444p"}),
    (64, 48, {"pix_fmt": "yuv440p"}),
], ids=["420", "420-ri4", "422", "444", "440"])
def test_decoder_matches_reference(w, h, opts):
    data = encode_jpeg(w, h, **opts)
    want, got = _decode_both([data, data])
    assert len(got) == len(want) == 2
    assert got[0].format == opts.get("pix_fmt", "yuv420p")
    for r, p in zip(want, got):
        assert (p.width, p.height, p.format, p.pts, p.color_range,
                p.color_space, p.chroma_location) == \
            (r.width, r.height, r.format, r.pts, r.color_range,
             r.color_space, r.chroma_location)
        assert len(p.planes) == len(r.planes)
        for a, b in zip(p.planes, r.planes):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            _within_one_lsb(a, b)


def _port_jpeg(w, h, pix_fmt):
    """One frame through the port's MJPEG encoder on the CPU (one MCU per
    restart interval, optimal tables): testing.mpeg2_clip's luma and
    seeded chroma planes of the format's size."""
    from ffmpeg_tpu_torch.codecs import EncoderParameters
    from ffmpeg_tpu_torch.testing import mpeg2_clip
    sx, sy = {"yuv420p": (2, 2), "yuv422p": (2, 1), "yuv444p": (1, 1),
              "yuv440p": (1, 2)}[pix_fmt]
    rng = np.random.default_rng(w * h)
    planes = [np.asarray(mpeg2_clip(1, w, h)[0].planes[0])] + [
        rng.integers(40, 220, (-(-h // sy), -(-w // sx))).astype(np.uint8)
        for _ in range(2)]
    enc = CodecContext.open_encoder(
        EncoderParameters("mjpeg", w, h),
        {"quality": 85, "restart_interval": 1, "huffman": "optimal"},
        device="cpu")
    enc.send_frame(Frame.video(w, h, pix_fmt, planes=planes))
    return enc.receive_packet().data


@pytest.mark.parametrize("pix_fmt", ["yuv420p", "yuv422p", "yuv444p",
                                     "yuv440p"])
@pytest.mark.parametrize("w,h", [(37, 23), (33, 19)])
def test_decoder_matches_reference_at_odd_sizes(w, h, pix_fmt):
    """Sizes that are no multiple of the MCU, in every subsampling, on
    streams of the port's own encoder."""
    want, got = _decode_both([_port_jpeg(w, h, pix_fmt)])
    assert len(got) == len(want) == 1
    r, p = want[0], got[0]
    assert (p.width, p.height, p.format) == (r.width, r.height, r.format) \
        == (w, h, pix_fmt)
    assert len(p.planes) == len(r.planes) == 3
    for a, b in zip(p.planes, r.planes):
        assert tuple(a.shape) == np.asarray(b).shape
        _within_one_lsb(a, b)


def test_decoder_on_a_fixture_frame():
    """One 1080p frame of the committed clip."""
    want, got = _decode_both(fixture_packets()[:1])
    assert got[0].format == want[0].format == "yuv420p"
    assert [tuple(p.shape) for p in got[0].planes] == \
        [(1080, 1920), (540, 960), (540, 960)]
    for a, b in zip(got[0].planes, want[0].planes):
        _within_one_lsb(a, b)


def test_decoder_registry_and_params():
    assert {"mjpeg", "jpeg", "jpegls_off"} <= set(decoder_names())
    with pytest.raises(DecoderNotFound):
        CodecContext.open_decoder(CodecParameters(codec_id="no-such-codec"),
                                  device="cpu")
    ctx = CodecContext.open_decoder(
        CodecParameters(codec_type=MediaType.VIDEO, codec_id="jpeg",
                        color_primaries="bt709"), device="cpu")
    assert isinstance(ctx.codec, MjpegDecoder)
    assert ctx.codec.device == torch.device("cpu")
    f = ctx.decode_all([Packet(data=encode_jpeg(32, 16), pts=7,
                               time_base=Rational(1, 25))])[0]
    assert (f.pts, f.time_base, f.color_primaries) == \
        (7, Rational(1, 25), "bt709")


def test_open_decoder_defaults_to_the_card():
    import inspect
    sig = inspect.signature(CodecContext.open_decoder)
    assert sig.parameters["device"].default == "cuda"
    assert inspect.signature(MjpegDecoder).parameters["device"].default \
        == "cuda"
    assert inspect.signature(scale_frame).parameters["device"].default \
        == "cuda"


@pytest.mark.parametrize("data", [
    b"\xFF\xD8\xFF\xD9", b"garbage", b"\xFF\xD8" + b"\x00" * 64])
def test_malformed_input_is_invalid_data(data):
    ref = RefCodecContext.open_decoder(RefParams(codec_id="mjpeg"))
    port = CodecContext.open_decoder(CodecParameters(codec_id="mjpeg"),
                                     device="cpu")
    from ffmpeg_tpu.utils.error import InvalidData as RefInvalidData
    with pytest.raises(RefInvalidData):
        ref.send_packet(RefPacket(data=data))
    with pytest.raises(InvalidData):
        port.send_packet(Packet(data=data))


def test_truncated_scan_is_invalid_data():
    data = encode_jpeg(64, 48)
    ctx = CodecContext.open_decoder(CodecParameters(codec_id="mjpeg"),
                                    device="cpu")
    with pytest.raises(InvalidData):
        ctx.send_packet(Packet(data=data[:len(data) // 3]))


@pytest.mark.parametrize("exc", [
    native.NativeBuildError("g++ failed (1)"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
    RuntimeError("float32 matmuls must run in full float32: set ..."),
], ids=["build", "cuda", "oom", "tf32"])
def test_backstop_passes_device_and_build_faults(monkeypatch, exc):
    """A fault of the card or of a build is not bad input: the backstop
    lets it through unchanged, where the reference would say InvalidData."""
    ctx = CodecContext.open_decoder(CodecParameters(codec_id="mjpeg"),
                                    device="cpu")

    def fail(*_):
        raise exc
    monkeypatch.setattr(ctx.codec, "reconstruct", fail)
    with pytest.raises(type(exc)) as info:
        ctx.send_packet(Packet(data=encode_jpeg(32, 16)))
    assert info.value is exc


def test_backstop_passes_a_failed_host_build(monkeypatch):
    """The host scan's library failing to build surfaces as the build
    error, not as InvalidData (the reference falls back to Python)."""
    def fail():
        raise native.NativeBuildError("g++ failed (1)")
    monkeypatch.setattr(native, "get", fail)
    ctx = CodecContext.open_decoder(CodecParameters(codec_id="mjpeg"),
                                    device="cpu")
    with pytest.raises(native.NativeBuildError):
        ctx.send_packet(Packet(data=encode_jpeg(32, 16)))


def test_scale_frame_one_shot_matches_reference():
    """The reference's defaults: source colour space and range from the
    frame; the output planes stay tensors where the scaler runs."""
    pkt = encode_jpeg(96, 64)
    rf = RefCodecContext.open_decoder(RefParams(codec_id="mjpeg")) \
        .decode_all([RefPacket(data=pkt)])[0]
    pf = CodecContext.open_decoder(CodecParameters(codec_id="mjpeg"),
                                   device="cpu") \
        .decode_all([Packet(data=pkt)])[0]
    for fmt, kw in (("rgb24", {}), ("yuv420p", {"dst_range": True}),
                    ("gray", {"filter": "bilinear"})):
        want = ref_scale_frame(rf, 48, 32, fmt, **kw)
        got = scale_frame(pf, 48, 32, fmt, device="cpu", **kw)
        assert (got.width, got.height, got.format, got.color_range,
                got.color_space) == (want.width, want.height, want.format,
                                     want.color_range, want.color_space)
        for a, b in zip(got.planes, want.planes):
            assert isinstance(a, torch.Tensor)
            _within_one_lsb(a, b)
    # numpy planes go through too, copied to the scaler's device
    npf = RefFrame.video(96, 64, "yuv420p",
                         planes=[np.asarray(p) for p in rf.planes],
                         color_range="pc")
    got = scale_frame(Frame.video(96, 64, "yuv420p", planes=npf.planes,
                                  color_range="pc"), 48, 32, "rgb24",
                      device="cpu")
    for a, b in zip(got.planes, ref_scale_frame(npf, 48, 32,
                                                "rgb24").planes):
        _within_one_lsb(a, b)
