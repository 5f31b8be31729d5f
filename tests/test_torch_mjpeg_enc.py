"""The port's MJPEG encoder (ffmpeg_tpu_torch/codecs/mjpeg_enc.py) against
the reference (ffmpeg_tpu/codecs/mjpeg_enc.py), on the CPU.

Bar: the device transform's coefficients within one quantiser step of
the reference's on at most 1e-3 of positions (both FDCTs are float32,
summed in their own orders: tests/test_torch_idct.py's bar); the host
packing byte-identical wherever the coefficients are (the reference's
coefficients packed by the port give the reference's packet); the
tables, package_merge and build_optimal_table equal to the reference's.
Round trips: the port's packets through the port's MjpegDecoder and the
reference's (within 1 LSB of each other), and through the flagship
pipeline."""

import numpy as np
import pytest

from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.codecs import mjpeg_enc as ref_enc
from ffmpeg_tpu.core.frame import Frame as RefFrame
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io.stream import CodecParameters as RefParams
from ffmpeg_tpu.ops.idct import jpeg_forward_transform as ref_transform
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import CodecContext, EncoderParameters
from ffmpeg_tpu_torch.codecs import mjpeg_enc as port_enc
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType
from torch_port_util import assert_levels_at_ties

CHROMA = {"yuv420p": (2, 2), "yuv422p": (2, 1), "yuv444p": (1, 1),
          "yuv440p": (1, 2), "gray": None}


def clip_frame(w, h, fmt, seed=0):
    """A textured frame in `fmt`: testing.mpeg2_clip's luma, chroma
    planes of the format's size made from a seed."""
    y = np.asarray(fx.mpeg2_clip(1, w, h, seed)[0].planes[0])
    planes = [y]
    if CHROMA[fmt]:
        sx, sy = CHROMA[fmt]
        rng = np.random.default_rng(seed + 1)
        ch, cw = -(-h // sy), -(-w // sx)
        planes += [rng.integers(60, 200, (ch, cw)).astype(np.uint8)
                   for _ in range(2)]
    return planes


def _frames(w, h, fmt, seed=0):
    planes = clip_frame(w, h, fmt, seed)
    return (RefFrame.video(w, h, fmt, planes=planes, pts=seed),
            Frame.video(w, h, fmt, planes=planes, pts=seed))


def _ref_coeffs(rf, enc, pads=None):
    """The reference's device analysis of one frame, as its encode runs
    it (the same padding and jpeg_forward_transform calls); `pads`, when
    a list, gets each component's padded plane."""
    planes = [np.asarray(p) for p in rf.planes]
    fmt = rf.format
    ncomp = 1 if fmt == "gray" else 3
    hs, vs = ref_enc._SAMPLING[fmt]
    hmax, vmax = (hs, vs) if ncomp == 3 else (1, 1)
    samp = [(hmax, vmax)] + [(1, 1)] * (ncomp - 1)
    q = [ref_enc._scale_qtab(ref_enc.STD_LUMA_Q, enc.quality)] + \
        [ref_enc._scale_qtab(ref_enc.STD_CHROMA_Q, enc.quality)] * \
        (ncomp - 1)
    mx, my = -(-rf.width // (8 * hmax)), -(-rf.height // (8 * vmax))
    out = []
    for ci in range(ncomp):
        p = planes[ci]
        ch, cw = p.shape
        rows, cols = my * samp[ci][1], mx * samp[ci][0]
        pad = np.empty((rows * 8, cols * 8), p.dtype)
        pad[:ch, :cw] = p
        pad[ch:, :cw] = p[ch - 1:ch, :]
        pad[:, cw:] = pad[:, cw - 1:cw]
        if pads is not None:
            pads.append(pad)
        out.append(np.asarray(ref_transform(pad, q[ci], rows, cols))
                   .reshape(rows, cols, 64))
    return out, q, samp, mx, my, ncomp


def _within_one_step(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(),
                                                      (d > 0).mean())


@pytest.mark.parametrize("w,h,fmt,opts", [
    (96, 64, "yuv420p", {}),
    (37, 23, "yuv420p", {"huffman": "optimal", "restart_interval": 1}),
    (33, 19, "yuv422p", {"quality": 50}),
    (64, 48, "yuv444p", {"huffman": "optimal", "max_code_len": 8}),
    (40, 24, "yuv440p", {"restart_interval": 3}),
    (48, 40, "gray", {"quality": 95}),
    (320, 176, "yuv420p", dict(fx.MJPEG_ENC_OPTIONS)),
], ids=["420", "420-odd-optimal-ri1", "422-odd-q50", "444-optimal8",
        "440-ri3", "gray-q95", "420-flagship-options"])
def test_encoder_matches_reference(w, h, fmt, opts):
    rf, pf = _frames(w, h, fmt)
    ref = RefContext.open_encoder(RefParams(
        codec_type="video", codec_id="mjpeg", width=w, height=h),
        options=dict(opts))
    port = CodecContext.open_encoder(EncoderParameters("mjpeg", w, h),
                                     dict(opts), device="cpu")
    want_pkt = ref.codec.encode(rf)[0]
    port.send_frame(pf)
    got_pkt = port.receive_packet()
    want = _ref_coeffs(rf, ref.codec)
    got = port.codec.transform(pf)
    assert got[2:] == want[2:]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[0], want[0]):
        assert a.dtype == np.int32
        _within_one_step(a, b)
    # the packing, byte for byte, on the reference's coefficients
    assert port.codec._pack(pf, *want) == want_pkt.data
    if all(np.array_equal(a, b) for a, b in zip(got[0], want[0])):
        assert got_pkt.data == want_pkt.data
    assert abs(len(got_pkt.data) / len(want_pkt.data) - 1) <= 1e-3
    assert (got_pkt.flags, got_pkt.pts) == (want_pkt.flags, want_pkt.pts)


@pytest.mark.parametrize("w,h,fmt,opts", [
    (17, 9, "yuv440p", {"huffman": "optimal"}),
    (31, 47, "yuv420p", {"quality": 100, "restart_interval": 7}),
    (65, 33, "yuv422p", {"huffman": "optimal", "max_code_len": 16}),
], ids=["440-optimal", "420-q100-ri7", "422-optimal16"])
def test_encoder_small_frames_at_float32_ties(w, h, fmt, opts):
    """Small frames, where one differing coefficient is more than 1e-3 of
    the positions: every coefficient within one step of the reference's
    and each differing one on a rounding tie that float32 cannot decide
    (torch_port_util.assert_levels_at_ties); the packing byte-identical
    on the reference's coefficients."""
    rf, pf = _frames(w, h, fmt)
    ref = RefContext.open_encoder(RefParams(
        codec_type="video", codec_id="mjpeg", width=w, height=h),
        options=dict(opts))
    port = CodecContext.open_encoder(EncoderParameters("mjpeg", w, h),
                                     dict(opts), device="cpu")
    want_pkt = ref.codec.encode(rf)[0]
    pads = []
    want = _ref_coeffs(rf, ref.codec, pads)
    got = port.codec.transform(pf)
    assert got[2:] == want[2:]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    for a, b, pad, q in zip(got[0], want[0], pads, want[1]):
        x, tol = fx.jpeg_decisions(fx.plane_blocks(pad), q)
        assert_levels_at_ties(a, b, x, tol, "round")
    assert port.codec._pack(pf, *want) == want_pkt.data


def test_reference_gray_optimal_fault():
    """A fault of the reference that the port keeps: with
    huffman=optimal a gray frame's unused chroma tables are built from
    empty histograms, and build_optimal_table's degenerate table has a
    count and no value, so _huff_codes raises IndexError in both."""
    rf, pf = _frames(16, 16, "gray")
    opts = {"huffman": "optimal"}
    ref = RefContext.open_encoder(RefParams(
        codec_type="video", codec_id="mjpeg", width=16, height=16),
        options=dict(opts))
    with pytest.raises(IndexError):
        ref.codec.encode(rf)
    port = CodecContext.open_encoder(EncoderParameters("mjpeg", 16, 16),
                                     dict(opts), device="cpu")
    with pytest.raises(IndexError):
        port.codec.encode(pf)
    assert port_enc.build_optimal_table({}) == \
        ref_enc.build_optimal_table({}) == ([1] + [0] * 15, [])


@pytest.mark.parametrize("limit", [8, 9, 16])
def test_optimal_tables_equal_reference(limit):
    rng = np.random.default_rng(limit)
    for n in (1, 2, 12, 40, 162):
        syms = rng.choice(256, n, replace=False)
        freqs = {int(s): int(c) for s, c in
                 zip(syms, rng.geometric(0.01, n))}
        assert port_enc.package_merge(freqs, limit) == \
            ref_enc.package_merge(freqs, limit)
        if n <= 2 ** limit - 1:
            spec = port_enc.build_optimal_table(freqs, limit)
            assert spec == ref_enc.build_optimal_table(freqs, limit)
            codes, lens = port_enc._huff_codes(spec)
            want = ref_enc._huff_codes(spec)
            np.testing.assert_array_equal(codes, want[0])
            np.testing.assert_array_equal(lens, want[1])
            assert max(lens) <= limit


def test_tables_and_bit_writer_equal_reference():
    for name in ("STD_LUMA_Q", "STD_CHROMA_Q"):
        np.testing.assert_array_equal(getattr(port_enc, name),
                                      getattr(ref_enc, name))
    for name in ("STD_DC_LUMA", "STD_DC_CHROMA", "STD_AC_LUMA",
                 "STD_AC_CHROMA", "_SAMPLING"):
        assert getattr(port_enc, name) == getattr(ref_enc, name)
    for q in (1, 10, 49, 50, 88, 100):
        np.testing.assert_array_equal(
            port_enc._scale_qtab(port_enc.STD_LUMA_Q, q),
            ref_enc._scale_qtab(ref_enc.STD_LUMA_Q, q))
    rng = np.random.default_rng(4)
    blocks = rng.laplace(0, 3, (50, 64)).astype(np.int32)
    blocks[::7, 20:] = 0
    codes = port_enc._huff_codes(port_enc.STD_AC_LUMA)
    dc = port_enc._huff_codes(port_enc.STD_DC_LUMA)
    a, b = port_enc._BitWriter(), ref_enc._BitWriter()
    pa = port_enc._encode_blocks(a, blocks, *dc, *codes, 3)
    pb = ref_enc._encode_blocks(b, blocks, *dc, *codes, 3)
    a.flush()
    b.flush()
    assert (bytes(a.buf), pa) == (bytes(b.buf), pb)
    ha, hb = [[0] * 257 for _ in range(4)], [[0] * 257 for _ in range(4)]
    assert port_enc._block_stats(blocks, 0, ha[0], ha[1]) == \
        ref_enc._block_stats(blocks, 0, hb[0], hb[1])
    assert ha == hb


@pytest.mark.parametrize("fmt", ["yuv420p", "yuv422p", "yuv444p",
                                 "yuv440p"])
def test_port_packets_decode_in_both_decoders(fmt):
    """Round trip: the port's packet through the port's MjpegDecoder and
    the reference's, within 1 LSB of each other, near the source."""
    rf, pf = _frames(37, 23, fmt, seed=2)
    port = CodecContext.open_encoder(EncoderParameters("mjpeg", 37, 23),
                                     {"quality": 90}, device="cpu")
    port.send_frame(pf)
    data = port.receive_packet().data
    want = RefContext.open_decoder(RefParams(codec_id="mjpeg")) \
        .decode_all([RefPacket(data=data)])[0]
    got = CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="mjpeg"), device="cpu") \
        .decode_all([Packet(data=data)])[0]
    assert (got.width, got.height, got.format) == (37, 23, fmt)
    for a, b, src in zip(got.planes, want.planes, pf.planes):
        d = np.abs(a.numpy().astype(np.int32) - np.asarray(b, np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 0.01
        assert a.shape == src.shape
        e = a.numpy().astype(np.float64) - src
        assert 10 * np.log10(255 ** 2 / (e * e).mean()) > 30


def test_port_packets_through_the_flagship_pipeline():
    """Round trip through the flagship pipeline (K1's plain version here)
    at 320x176: the port's packets and the reference's give the same
    224x224 rgb24 PSNR against the source's scale within 0.05 dB."""
    w, h = 320, 176
    frames = fx.mpeg2_clip(2, w, h)
    port = CodecContext.open_encoder(EncoderParameters("mjpeg", w, h),
                                     dict(fx.MJPEG_ENC_OPTIONS),
                                     device="cpu")
    ref = RefContext.open_encoder(RefParams(
        codec_type="video", codec_id="mjpeg", width=w, height=h),
        options=dict(fx.MJPEG_ENC_OPTIONS))
    pp, rp = [], []
    for f in frames:
        port.send_frame(f)
        pp.append(port.receive_packet().data)
        rp.append(ref.codec.encode(f)[0].data)
    target = fx.mjpeg_target_rgb(frames, "cpu")
    got = fx.rgb_psnr(fx.mjpeg_pipeline_rgb(pp, "cpu", w, h), target)
    want = fx.rgb_psnr(fx.mjpeg_pipeline_rgb(rp, "cpu", w, h), target)
    assert min(got) > 35
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05)


def test_device_defaults_and_stats():
    import inspect
    assert inspect.signature(port_enc.MjpegEncoder).parameters[
        "device"].default == "cuda"
    ctx = CodecContext.open_encoder(EncoderParameters("mjpeg", 32, 16),
                                    device="cpu")
    assert isinstance(ctx.codec, port_enc.MjpegEncoder)
    ctx.codec.stats = []
    ctx.send_frame(_frames(32, 16, "yuv420p")[1])
    assert ctx.receive_packet().data[:2] == b"\xff\xd8"
    (st,) = ctx.codec.stats
    assert st["transform"] > 0 and st["pack"] > 0
    frame = Frame.video(32, 16, "rgb24", planes=[np.zeros((16, 96),
                                                          np.uint8)])
    from ffmpeg_tpu_torch.utils.error import NotSupported
    with pytest.raises(NotSupported):
        ctx.codec.encode(frame)


def test_mjpeg_golden_matches_reference():
    """The round-trip golden's MJPEG entries, tied to the reference on
    frame 0 of the 1920x1080 clip: its encoder's packet size, and its
    flagship pipeline's rgb24 PSNR against the source's scale (run here
    as a batch of one, the golden's as a batch of eight: the same
    arithmetic per frame, summed by XLA in an order that may differ in
    the last bit, so within 0.001 dB)."""
    from ffmpeg_tpu.codecs.mjpeg import _JpegState, _parse_until_scan
    from ffmpeg_tpu.models.mjpeg_tpu_entropy import (
        MjpegTpuEntropyPipeline, TpuEntropySpec)
    from ffmpeg_tpu.scale.swscale import Scaler
    g = np.load(fx.ROUNDTRIP_GOLDEN)
    f = fx.mpeg2_clip(1, fx.W, fx.H)[0]
    ref = RefContext.open_encoder(RefParams(
        codec_type="video", codec_id="mjpeg", width=fx.W, height=fx.H),
        options=dict(fx.MJPEG_ENC_OPTIONS))
    pkt = ref.codec.encode(f)[0].data
    assert len(pkt) == int(g["mjpeg_packet_bytes"][0])
    scan = len(pkt) - _parse_until_scan(pkt, _JpegState())[0]
    cap = 2 * 120 * 68 + 512 * 12 + scan + fx.MJPEG_SEGMENT_STRIDE + 128
    pipe = MjpegTpuEntropyPipeline(TpuEntropySpec(
        fx.W, fx.H, fx.OUT, fx.OUT, batch=1,
        stride=fx.MJPEG_SEGMENT_STRIDE, packed_cap=cap), pkt)
    pipe.prep_frame(pkt, 0)
    got = np.stack([np.asarray(c) for c in pipe.run_batch()])
    sc = Scaler(src_w=fx.W, src_h=fx.H, **fx.MJPEG_TARGET_SPEC)
    want = np.stack([np.asarray(c) for c in sc.run(
        [np.asarray(p) for p in f.planes])])[:, None]
    psnr = fx.rgb_psnr(got, want)
    np.testing.assert_allclose(psnr, g["mjpeg_psnr"][:1], rtol=0,
                               atol=1e-3)
