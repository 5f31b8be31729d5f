"""The port's MPEG-2 encoder (ffmpeg_tpu_torch/codecs/mpeg12_enc.py)
against the reference (ffmpeg_tpu/codecs/mpeg12_enc.py), on the CPU, on
the moving-gradient clip of tests/test_mpeg2_enc.py (160x128, 8 frames).

The reference's encoder quantises with its default matrices permuted
(it scatters the raster-order tables through ZIGZAG), so its
reconstruction is not what a decoder makes of its stream.  The port
computes what the reference computes, permutation included; the
comparisons below run the reference as it ships (`_ref_ctx`), and
`test_reference_matrix_fault` keeps the fault in view.

The device's float32 DCT rounds differently from the reference's in the
last bits, so rare levels differ: MVs from one reference picture are
identical, packet sizes agree within 1%, stream PSNR within 0.1 dB."""

import numpy as np
import pytest
import torch

from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.codecs import mpeg12_enc as ref_enc
from ffmpeg_tpu.codecs import mpeg12_tables as ref_tables
from ffmpeg_tpu.core.frame import Frame
from ffmpeg_tpu.core.packet import PKT_FLAG_KEY, Packet
from ffmpeg_tpu.io.stream import CodecParameters, MediaType
from ffmpeg_tpu.ops.me import motion_search as ref_motion_search
from ffmpeg_tpu.utils import error as ref_error
from ffmpeg_tpu.utils.rational import Rational
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import CodecContext, EncoderParameters
from ffmpeg_tpu_torch.codecs import mpeg12_enc as port_enc
from ffmpeg_tpu_torch.codecs import mpeg12_tables as port_tables
from ffmpeg_tpu_torch.ops import me
from ffmpeg_tpu_torch.utils.error import (EncoderNotFound, EndOfStream,
                                          NotSupported, TryAgain)

W, H, N = 160, 128, 8
PH, PW = -(-H // 16) * 16, -(-W // 16) * 16
FIXED_Q = {"qscale": 4, "gop_size": 4}
RATE_CONTROL = {"bit_rate": 1_500_000, "gop_size": 8}


@pytest.fixture(scope="module")
def frames():
    return fx.mpeg2_clip(N, W, H)


def _ref_par():
    return CodecParameters(codec_type=MediaType.VIDEO,
                           codec_id="mpeg2video", width=W, height=H)


def _ref_ctx(opts):
    return RefContext.open_encoder(_ref_par(), options=dict(opts))


def _port_ctx(opts):
    return CodecContext.open_encoder(
        EncoderParameters("mpeg2video", W, H), dict(opts), device="cpu")


def _encode(ctx, frames, port):
    """Encode through send_frame/receive_packet; keep each packet, the
    reconstruction after each frame and each P frame's MV grid."""
    enc = ctx.codec
    out = {"pkts": [], "recon": [], "grids": []}
    for f in frames:
        is_p = enc._recon is not None and enc.frame_idx % enc.gop_size
        if is_p and not port:
            y = ref_enc._pad(np.asarray(f.planes[0]), PH, PW)
            out["grids"].append(np.asarray(ref_motion_search(
                y, enc._recon[0], 16, enc.SEARCH)[0]))
        ctx.send_frame(f)
        out["pkts"].append(ctx.receive_packet())
        out["recon"].append(tuple(p.copy() for p in enc._recon))
        if is_p and port:
            out["grids"].append(enc.last_mv_grid)
    return out


def _stream_psnr(recons, frames):
    """PSNR over every sample of every frame of a stream."""
    mse = np.mean([10 ** (-fx.recon_psnr(r, f) / 10) for r, f in
                   zip(recons, frames)]) * 255 ** 2
    return 10 * np.log10(255 ** 2 / mse)


def _ref_decode(data):
    dec = RefContext.open_decoder(_ref_par())
    return dec.decode_all([Packet(data=data + b"\x00\x00\x01\xb7", pts=0,
                                  time_base=Rational(1, 25))])


@pytest.fixture(scope="module")
def fixed_q(frames):
    return (_encode(_ref_ctx(FIXED_Q), frames, port=False),
            _encode(_port_ctx(FIXED_Q), frames, port=True))


def _assert_close_streams(ref, port, frames):
    rs = [len(p.data) for p in ref["pkts"]]
    ps = [len(p.data) for p in port["pkts"]]
    assert all(abs(p / r - 1) <= 0.01 for r, p in zip(rs, ps)), (rs, ps)
    assert [p.flags for p in port["pkts"]] == [p.flags for p in ref["pkts"]]
    assert abs(_stream_psnr(port["recon"], frames)
               - _stream_psnr(ref["recon"], frames)) <= 0.1


def test_tables_equal_reference():
    names = [k for k in vars(ref_tables) if k.isupper()]
    assert names == [k for k in vars(port_tables) if k.isupper()]
    for k in names:
        assert getattr(port_tables, k) == getattr(ref_tables, k), k


@pytest.mark.parametrize("fn", ["_quant_intra", "_quant_inter",
                                "_dequant_intra", "_dequant_inter"])
def test_quantisers_equal_reference(fn):
    rng = np.random.default_rng(len(fn))
    m = np.array(ref_tables.DEFAULT_INTRA_MATRIX, np.int32)
    zz = port_enc.ZIGZAG
    for qscale in (2, 8, 31):
        for _ in range(20):
            x = (rng.normal(0, 300, 64) if fn.startswith("_quant")
                 else rng.integers(-40, 41, 64)).astype(np.float32)
            if fn == "_quant_intra":
                x[0] = abs(x[0]) * 4
            want = getattr(ref_enc, fn)(x, qscale, m, zz)
            got = getattr(port_enc, fn)(x, qscale, m, zz)
            np.testing.assert_array_equal(got, want)


def test_bit_writers_equal_reference():
    rng = np.random.default_rng(3)
    a, b = ref_enc._BW(), port_enc._BW()
    for _ in range(300):
        run, level = int(rng.integers(0, 40)), int(rng.integers(-300, 300))
        ref_enc._write_rl(a, run, level or 1)
        port_enc._write_rl(b, run, level or 1)
        d = int(rng.integers(-40, 40))
        ref_enc._write_mv_delta(a, d, 2)
        port_enc._write_mv_delta(b, d, 2)
    a.start_code(0xB3)
    b.start_code(0xB3)
    assert bytes(b.buf) == bytes(a.buf) and a.nbits() == b.nbits()


def test_fixed_qscale_stream_matches_reference(fixed_q, frames):
    ref, port = fixed_q
    _assert_close_streams(ref, port, frames)
    assert len(port["grids"]) == len(ref["grids"]) == 6
    for g, want in zip(port["grids"], ref["grids"]):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, want)


def test_negative_motion_floors_like_reference(frames):
    """The clip played backwards moves by (-2, -3): the coded MVs are
    (mv // 2) * 2 = (-2, -4), floored as in the reference."""
    back = frames[:4][::-1]
    ref = _encode(_ref_ctx(FIXED_Q), back, port=False)
    port = _encode(_port_ctx(FIXED_Q), back, port=True)
    assert (port["grids"][0][2:-2, 2:-2] == (-2, -3)).all()
    for g, want in zip(port["grids"], ref["grids"]):
        np.testing.assert_array_equal(g, want)
    _assert_close_streams(ref, port, back)


def test_rate_control_stream_matches_reference(frames):
    ref = _encode(_ref_ctx(RATE_CONTROL), frames, port=False)
    port = _encode(_port_ctx(RATE_CONTROL), frames, port=True)
    _assert_close_streams(ref, port, frames)


def test_p_frame_from_reference_state_has_identical_mvs(frames):
    """Encode three frames with the reference, carry its state over, and
    encode the fourth in both packages from the same reference
    picture."""
    ref = _ref_ctx(FIXED_Q)
    _encode(ref, frames[:3], port=False)
    port = _port_ctx(FIXED_Q)
    state = port_enc.state_from_reference(ref.codec)
    port.codec.load_state(state)
    assert state["frame_idx"] == 3
    assert all(p.dtype == np.uint8 for p in state["_recon"])
    r = _encode(ref, frames[3:4], port=False)
    p = _encode(port, frames[3:4], port=True)
    np.testing.assert_array_equal(p["grids"][0], r["grids"][0])
    rs, ps = len(r["pkts"][0].data), len(p["pkts"][0].data)
    assert abs(ps / rs - 1) <= 0.01
    with pytest.raises(ValueError):
        port.codec.load_state({"weights": 0})


def test_port_stream_decodes_to_its_reconstruction(fixed_q, frames):
    """The port's stream, decoded by the reference decoder, against the
    reference's own stream decoded.  Every I frame agrees within the
    port's 1 LSB float32 tolerance (on this clip 0.62% and 2.36% of the
    samples differ).  P frames predict from each encoder's own
    reconstruction, so a level that rounds the other way in one encoder
    carries into every later frame of the GOP, whatever the matrices'
    order: there the decoded frames are held to the source within 0.1 dB
    of the reference's (0.021 dB at most on this clip).  `test_p_frames_from_one_state_agree` holds the P-frame path
    itself, without that carry, as tightly as the I-frame path."""
    ref, port = fixed_q
    got = _ref_decode(b"".join(p.data for p in port["pkts"]))
    want = _ref_decode(b"".join(p.data for p in ref["pkts"]))
    assert len(got) == len(want) == N
    for g, w, pkt, f in zip(got, want, port["pkts"], frames):
        gp = [np.asarray(a) for a in g.planes[:3]]
        wp = [np.asarray(a) for a in w.planes[:3]]
        if pkt.flags & PKT_FLAG_KEY:
            diff = np.concatenate([np.abs(a.astype(np.int32)
                                          - b.astype(np.int32)).ravel()
                                   for a, b in zip(gp, wp)])
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.05
        assert abs(fx.recon_psnr(gp, f) - fx.recon_psnr(wp, f)) <= 0.1


def _raster(ctx):
    """An encoder of either package set to quantise with the default
    matrices in raster order (instance attributes only)."""
    enc = ctx.codec
    enc.intra_m_raster = np.array(enc.intra_matrix, np.int32)
    enc.inter_m_raster = np.array(enc.inter_matrix, np.int32)
    return ctx


@pytest.mark.parametrize("raster", [False, True],
                         ids=["as_shipped", "raster_matrices"])
def test_p_frames_from_one_state_agree(frames, raster):
    """The witness for the P-frame tolerance above.  Before each frame the
    reference's state, its reconstructed picture included, is carried
    into a fresh port encoder, and both encode that one frame: each P
    frame is coded from the same reference picture in both packages, so
    no difference carries over from an earlier frame.  Then P frames agree
    as closely as I frames do: MVs equal, packet sizes within 0.1%, the
    encoders' reconstructions within 2 LSB, on at most 3% of the samples,
    and 2 LSB apart on at most 0.2% of them (a level that rounds the
    other way after the float32 DCT, plus the IDCT's own rounding; on
    this clip at most 2.73% and 0.12%, both on an I frame).  The same
    holds with both encoders set to raster-order matrices, so the bound
    does not rest on the reference's permutation."""
    ref = _raster(_ref_ctx(FIXED_Q)) if raster else _ref_ctx(FIXED_Q)
    for i, f in enumerate(frames):
        port = _port_ctx(FIXED_Q)
        port.codec.load_state(port_enc.state_from_reference(ref.codec))
        r = _encode(ref, [f], port=False)
        p = _encode(port, [f], port=True)
        assert p["pkts"][0].flags == r["pkts"][0].flags
        assert len(p["grids"]) == len(r["grids"]) == int(i % FIXED_Q["gop_size"] > 0)
        for g, want in zip(p["grids"], r["grids"]):
            np.testing.assert_array_equal(g, want)
        rs, ps = len(r["pkts"][0].data), len(p["pkts"][0].data)
        assert abs(ps / rs - 1) <= 1e-3, (i, rs, ps)
        diff = np.concatenate([np.abs(a.astype(np.int32)
                                      - b.astype(np.int32)).ravel()
                               for a, b in zip(p["recon"][0],
                                               r["recon"][0])])
        assert diff.max() <= 2, i
        assert (diff > 0).mean() <= 0.03 and (diff > 1).mean() <= 2e-3, i


def test_reference_matrix_fault(frames):
    """The reference as it ships: its own decoder does not reconstruct
    its stream as its encoder did (tens of LSBs on the first I frame)."""
    ctx = _ref_ctx(FIXED_Q)
    ref = _encode(ctx, frames[:1], port=False)
    got = _ref_decode(ref["pkts"][0].data)
    y = np.asarray(got[0].planes[0]).astype(np.int32)
    assert np.abs(y - ref["recon"][0][0][:H, :W].astype(np.int32)).max() > 8


def test_two_pass_matches_reference(frames, tmp_path):
    def two_pass(ctx_of, port):
        stats = tmp_path / f"{'port' if port else 'ref'}.log"
        opts = {"bit_rate": 1_200_000, "gop_size": 4, "stats_file":
                str(stats)}
        first = ctx_of({**opts, "pass": 1, "qscale": 8})
        _encode(first, frames[:4], port)
        first.send_frame(None)
        with pytest.raises(EndOfStream if port else ref_error.EndOfStream):
            first.receive_packet()
        log = [tuple(map(int, ln.split()))
               for ln in stats.read_text().splitlines()]
        return log, _encode(ctx_of({**opts, "pass": 2}), frames[:4], port)

    ref_log, ref = two_pass(_ref_ctx, port=False)
    port_log, port = two_pass(_port_ctx, port=True)
    assert [t[:2] for t in port_log] == [t[:2] for t in ref_log]
    assert all(abs(p[2] / r[2] - 1) <= 0.01
               for r, p in zip(ref_log, port_log))
    assert [len(p.data) for p in port["pkts"]] and all(
        abs(len(p.data) / len(r.data) - 1) <= 0.01
        for r, p in zip(ref["pkts"], port["pkts"]))


def test_encoder_api(frames):
    with pytest.raises(EncoderNotFound):
        CodecContext.open_encoder(EncoderParameters("nope", W, H),
                                  device="cpu")
    ctx = CodecContext.open_encoder(_ref_par(), {"gop_size": 1},
                                    device="cpu")
    assert isinstance(ctx.codec, port_enc.Mpeg2Encoder)
    assert ctx.codec.device == torch.device("cpu")
    with pytest.raises(TryAgain):
        ctx.receive_packet()
    for f in frames[:2]:
        ctx.send_frame(f)
        pkt = ctx.receive_packet()
        assert pkt.flags & PKT_FLAG_KEY and pkt.pts == f.pts
    ctx.send_frame(None)
    with pytest.raises(EndOfStream):
        ctx.receive_packet()
    rgb = Frame.video(W, H, "rgb24", pts=0, time_base=Rational(1, 25))
    with pytest.raises(NotSupported):
        _port_ctx({}).send_frame(rgb)


def test_golden_pair_on_cpu():
    """The committed 1080p golden's clip is the one mpeg2_clip makes, and
    K2's plain version gives the reference's MVs and costs on its
    pair."""
    g = np.load(fx.ENCODE_GOLDEN)
    clip = fx.mpeg2_clip(fx.ENC_FRAMES, 1920, 1080)
    assert fx.clip_checksum(clip) == str(g["clip_sha256"])
    y = [torch.from_numpy(port_enc._pad(np.asarray(f.planes[0]), 1088,
                                        1920)) for f in clip[:2]]
    mvs, cost = me.motion_search(y[1], y[0], 16, 8)
    np.testing.assert_array_equal(mvs.numpy(), g["pair_mvs"])
    np.testing.assert_array_equal(cost.numpy(), g["pair_costs"])
