"""The port's H.264 encoder (ffmpeg_tpu_torch/codecs/h264_enc.py) against
the reference (ffmpeg_tpu/codecs/h264_enc.py), on the CPU.

Bar: byte-identical packets, tolerance 0.  Every step but the motion
search is integer host code copied statement for statement, and the
search's costs are exact integer sums in both packages (the port's K2
contract, the reference's XLA form), so nothing may differ.  The cases
are those of tests/test_h264_enc.py (GOP, qp sweep, static scene, IDR
refresh, subpel motion, the cropped size), on the same frames.  Round
trip: the port's packets through the port's H264Decoder give the
encoder's reconstruction, cropped."""

import numpy as np
import pytest
import torch

from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.codecs import h264_enc as ref_enc
from ffmpeg_tpu.core.frame import Frame as RefFrame
from ffmpeg_tpu.io.stream import CodecParameters as RefParams
from ffmpeg_tpu.ops.me import sad_cost_volume as ref_sad_cost_volume
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import CodecContext, EncoderParameters
from ffmpeg_tpu_torch.codecs import h264_enc as port_enc
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType
from ffmpeg_tpu_torch.ops import me
from ffmpeg_tpu_torch.utils.rational import Rational

from test_h264_enc import H, W, _smooth, _source_frames


def _port_frames(frames):
    return [Frame.video(f.width, f.height, "yuv420p",
                        planes=[np.asarray(p) for p in f.planes], pts=f.pts)
            for f in frames]


def _encode_both(frames, w=W, h=H, **opts):
    """Each package's packets, and the port's reconstruction after each
    frame."""
    ref = RefContext.open_encoder(RefParams(
        codec_type="video", codec_id="h264", width=w, height=h),
        options=dict(opts))
    port = CodecContext.open_encoder(EncoderParameters("h264", w, h),
                                     dict(opts), device="cpu")
    rp, pp, recons = [], [], []
    for rf, pf in zip(frames, _port_frames(frames)):
        rp += ref.codec.encode(rf)
        port.send_frame(pf)
        pp.append(port.receive_packet())
        recons.append([p.copy() for p in port.codec._recon])
    return rp, pp, recons


def _assert_identical(rp, pp):
    assert len(pp) == len(rp)
    for r, p in zip(rp, pp):
        assert p.data == r.data
        assert (p.flags, p.pts, p.dts) == (r.flags, r.pts, r.dts)


def _port_decode(pkts):
    dec = CodecContext.open_decoder(
        CodecParameters(codec_type=MediaType.VIDEO, codec_id="h264"),
        device="cpu")
    return dec.decode_all([Packet(data=b"".join(p.data for p in pkts),
                                  pts=0, time_base=Rational(1, 25))])


def _assert_round_trip(pkts, recons, w=W, h=H):
    frames = _port_decode(pkts)
    assert len(frames) == len(recons)
    for f, rec in zip(frames, recons):
        assert (f.width, f.height) == (w, h)
        for plane, r, (ph, pw) in zip(f.planes, rec,
                                      ((h, w), (h // 2, w // 2),
                                       (h // 2, w // 2))):
            assert isinstance(plane, torch.Tensor)
            np.testing.assert_array_equal(plane.numpy(), r[:ph, :pw])


def test_host_copies_equal_reference():
    """The CAVLC residual writer, the bit writer, escaping and NAL
    framing, and the forward transform and quantiser against the
    reference's on seeded input."""
    rng = np.random.default_rng(11)
    a, b = port_enc._BW(), ref_enc._BW()
    for _ in range(400):
        n = int(rng.choice([4, 15, 16]))
        nc = int(rng.choice([-1, 0, 1, 2, 3, 5, 9])) if n == 4 else \
            int(rng.integers(0, 17))
        lv = [int(x) if rng.random() < 0.4 else 0 for x in
              rng.laplace(0, 4, n).round()]
        assert port_enc.write_residual(a, lv, n, nc) == \
            ref_enc.write_residual(b, lv, n, nc)
        v = int(rng.integers(-300, 300))
        a.se(v)
        b.se(v)
    assert a.bits == b.bits
    rbsp = a.rbsp()
    assert rbsp == b.rbsp()
    zeros = bytes([0, 0, 1, 0, 0, 0, 0, 0, 3, 7]) + rbsp
    assert port_enc._nal(3, 5, zeros) == ref_enc._nal(3, 5, zeros)
    for qp in (0, 17, 26, 51):
        blk = rng.integers(-255, 256, (4, 4))
        c = port_enc._fdct4(blk)
        np.testing.assert_array_equal(c, ref_enc._fdct4(blk))
        for intra in (True, False):
            np.testing.assert_array_equal(
                port_enc._quant4(c, qp, intra, not intra),
                ref_enc._quant4(c, qp, intra, not intra))


def test_gop_matches_reference_and_round_trips():
    rp, pp, recons = _encode_both(_source_frames(5), qp=26)
    _assert_identical(rp, pp)
    assert [p.flags for p in pp] == [1, 0, 0, 0, 0]
    _assert_round_trip(pp, recons)


@pytest.mark.parametrize("qp", [18, 30, 38])
def test_qp_sweep_matches_reference(qp):
    rp, pp, recons = _encode_both(_source_frames(3, seed=qp), qp=qp)
    _assert_identical(rp, pp)
    _assert_round_trip(pp, recons)


def test_static_scene_skips_match_reference():
    f0 = _source_frames(1)[0]
    frames = [f0] + [RefFrame.video(W, H, "yuv420p",
                                    planes=[np.asarray(p).copy()
                                            for p in f0.planes], pts=t)
                     for t in range(1, 4)]
    rp, pp, recons = _encode_both(frames, qp=26)
    _assert_identical(rp, pp)
    assert all(len(p.data) <= 40 for p in pp[1:])
    assert len(pp[-1].data) <= 12
    _assert_round_trip(pp, recons)


def test_idr_refresh_matches_reference():
    rp, pp, recons = _encode_both(_source_frames(6, seed=3), qp=26, g=3)
    _assert_identical(rp, pp)
    assert pp[0].flags and pp[3].flags
    _assert_round_trip(pp, recons)


def test_subpel_motion_matches_reference():
    rng = np.random.default_rng(0)
    big = _smooth((rng.random((H * 2 + 32, W * 2 + 32)) * 255)
                  .astype(np.uint8)).astype(float)
    frames = []
    for t in range(4):
        y = big[t:t + 2 * H:2, t:t + 2 * W:2].astype(np.uint8)
        c = np.full((H // 2, W // 2), 128, np.uint8)
        frames.append(RefFrame.video(W, H, "yuv420p",
                                     planes=[y, c.copy(), c.copy()], pts=t))
    full = _encode_both(frames, qp=26, subpel=0)
    sub = _encode_both(frames, qp=26, subpel=2)
    _assert_identical(*full[:2])
    _assert_identical(*sub[:2])
    assert sum(len(p.data) for p in sub[1][1:]) < \
        sum(len(p.data) for p in full[1][1:])
    _assert_round_trip(sub[1], sub[2])


def test_cropped_size_matches_reference_and_pads_the_search(monkeypatch):
    """60x44: the encoder pads to 64x48 before the search, so K2 (here
    its plain version) and the reference's XLA form see whole blocks and
    give the same costs; the decoder crops back to 60x44."""
    seen = []
    search = port_enc.motion_search

    def spy(cur, ref, block=16, search_range=8, **kw):
        seen.append((cur.clone(), ref.clone()))
        return search(cur, ref, block, kw.get("search", search_range))
    monkeypatch.setattr(port_enc, "motion_search", spy)
    frames = _source_frames(2, seed=5, w=60, h=44)
    rp, pp, recons = _encode_both(frames, w=60, h=44, qp=26)
    _assert_identical(rp, pp)
    _assert_round_trip(pp, recons, w=60, h=44)
    assert len(seen) == 1
    cur, ref = seen[0]
    assert cur.shape == ref.shape == (48, 64)
    assert cur.dtype == ref.dtype == torch.uint8
    k2 = me.sad_cost_volume_strip_plain(cur, ref, 16, 8).numpy()
    want = np.asarray(ref_sad_cost_volume(cur.numpy(), ref.numpy(), 16, 8))
    np.testing.assert_array_equal(k2, want)


def test_p_frame_from_reference_state_is_identical():
    """Two frames encoded by the reference, its state carried over, and
    the third encoded by both from the same reference picture."""
    frames = _source_frames(3, seed=7)
    ref = RefContext.open_encoder(RefParams(
        codec_type="video", codec_id="h264", width=W, height=H),
        options={"qp": 28, "me_range": 6})
    for f in frames[:2]:
        ref.codec.encode(f)
    port = CodecContext.open_encoder(EncoderParameters("h264", W, H),
                                     device="cpu")
    state = port_enc.state_from_reference(ref.codec)
    port.codec.load_state(state)
    assert state["frame_idx"] == 2 and state["qp"] == 28
    assert state["search"] == 6
    assert all(p.dtype == np.uint8 for p in state["_recon"])
    want = ref.codec.encode(frames[2])[0]
    got = port.codec.encode(_port_frames(frames[2:])[0])[0]
    assert got.data == want.data and got.flags == 0
    with pytest.raises(ValueError):
        port.codec.load_state({"weights": 0})


def test_motion_search_failure_propagates(monkeypatch):
    """The reference turns any exception of its search into zero MVs;
    the port raises it out of encode."""
    class Boom(RuntimeError):
        pass

    def fail(*_a, **_k):
        raise Boom("search failed")
    monkeypatch.setattr(port_enc, "motion_search", fail)
    enc = CodecContext.open_encoder(EncoderParameters("h264", W, H),
                                    device="cpu").codec
    frames = _port_frames(_source_frames(2))
    assert enc.encode(frames[0])[0].flags == 1      # I: no search
    with pytest.raises(Boom):
        enc.encode(frames[1])


def test_stats_split_and_defaults():
    import inspect
    assert inspect.signature(port_enc.H264Encoder).parameters[
        "device"].default == "cuda"
    ctx = CodecContext.open_encoder(EncoderParameters("h264", W, H),
                                    device="cpu")
    enc = ctx.codec
    assert isinstance(enc, port_enc.H264Encoder)
    assert (enc.qp, enc.gop, enc.search, enc.subpel) == (26, 25, 8, 2)
    enc.stats = []
    for f in _port_frames(_source_frames(2)):
        enc.encode(f)
    i, p = enc.stats
    assert (i["type"], p["type"]) == ("I", "P")
    assert "search" not in i and i["subpel"] == 0.0
    for k in ("h2d", "search", "d2h", "subpel", "mb_loop"):
        assert p[k] >= 0.0
    assert p["wall"] >= p["search"] + p["subpel"]
    assert me.KERNEL_LAUNCHES == 0


def test_h264_i_picture_matches_the_golden():
    """The round-trip golden's H.264 I picture, tied to the reference:
    the reference encoder's 1920x1080 I packet and its reconstruction
    (decoder-exact; the fixture tool checks it against the reference's
    decode) against the committed hashes.  The reference takes about a
    minute here; the port's own 1080p packets are held to these hashes
    on the card (chip_smoke.py phase 17)."""
    import hashlib
    g = np.load(fx.ROUNDTRIP_GOLDEN)
    f = fx.mpeg2_clip(1, fx.W, fx.H)[0]
    ref = RefContext.open_encoder(RefParams(
        codec_type="video", codec_id="h264", width=fx.W, height=fx.H))
    pkt = ref.codec.encode(RefFrame.video(
        fx.W, fx.H, "yuv420p", planes=[np.asarray(p) for p in f.planes],
        pts=0))[0]
    assert hashlib.sha256(pkt.data).hexdigest() == \
        str(g["h264_packet_sha256"][0])
    assert len(pkt.data) == int(g["h264_packet_bytes"][0])
    for i, (p, want) in enumerate(zip(ref.codec._recon,
                                      g["h264_plane_sha256"][0])):
        s = 1 + (i > 0)
        assert fx.plane_sha256(p[:fx.H // s, :fx.W // s]) == str(want)
