"""The port's MPEG-1/2 decoder (ffmpeg_tpu_torch/codecs/mpeg12.py
`Mpeg12Decoder`, through `CodecContext.open_decoder`) against the
reference's (ffmpeg_tpu/codecs/mpeg12.py), on the CPU.

Bar, against the reference's decoder on the same packets: I pictures
within 1 LSB on at most 1% of samples, every picture at 60 dB or more
(the host parse is copied and integer; the IDCT is float32 in both,
summed in their own orders, and a sample on a rounding boundary may
land one step apart, which MC then carries into later pictures).

The streams are those of tests/test_mpeg12.py, made by the same
invocations of the reference binary, byte for byte, so that
tests/golden.py replays them: IPB, IP, intra, interlaced IP and IPB,
MPEG-1, and the truncated slice; the reference's TS demuxer takes the
elementary stream out.  Then both packages' MPEG-2 encodes of
testing.mpeg2_clip at 160x128: the port's own packets through the
port's decoder is the encoder's round trip."""

import subprocess

import numpy as np
import pytest
import torch

import refutil
from conftest import requires_ref

from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io import open_input
from ffmpeg_tpu.io.stream import CodecParameters as RefParams
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import (CodecContext, EncoderParameters,
                                     decoder_names)
from ffmpeg_tpu_torch.codecs import mpeg12 as port_dec
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType
from ffmpeg_tpu_torch.utils.error import InvalidData
from ffmpeg_tpu_torch.utils.rational import Rational

from test_mpeg12 import W as TS_W, H as TS_H, _make_ts

ENC_W, ENC_H = 160, 128


def _ts_stream(tmp_path, nframes, extra):
    ts = _make_ts(tmp_path, nframes, extra)
    d = open_input(str(ts))
    return b"".join(p.data for p in d.packets() if p.stream_index == 0)


def _m1v_packets(tmp_path, nframes):
    """tests/test_mpeg12.py's MPEG-1 elementary stream, one packet per
    picture from the reference's demuxer."""
    p = tmp_path / "v.m1v"
    subprocess.run([str(refutil.REF), "-v", "error", "-f", "lavfi",
                    "-i", f"testsrc2=size={TS_W}x{TS_H}:rate=25",
                    "-frames:v", str(nframes), "-c:v", "mpeg1video",
                    "-q:v", "4", "-g", "5", "-bf", "0", "-pix_fmt",
                    "yuv420p", "-f", "mpeg1video", "-y", str(p)],
                   check=True, capture_output=True)
    return [pk.data for pk in open_input(str(p)).packets()]


def _decode_both(pkts, codec_id="mpeg2video", options=None):
    ref = RefContext.open_decoder(RefParams(
        codec_type="video", codec_id=codec_id), options=options)
    port = CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id=codec_id), options,
        device="cpu")
    want = ref.decode_all([RefPacket(data=p, pts=i,
                                     time_base=Rational(1, 25))
                           for i, p in enumerate(pkts)])
    got = port.decode_all([Packet(data=p, pts=i, time_base=Rational(1, 25))
                           for i, p in enumerate(pkts)])
    return want, got


def _assert_bar(want, got):
    """The MPEG-2 bar; returns the worst PSNR."""
    assert len(got) == len(want) and len(got) > 0
    worst = np.inf
    for r, p in zip(want, got):
        assert (p.width, p.height, p.format, p.pict_type, p.key_frame,
                p.pts) == (r.width, r.height, r.format, r.pict_type,
                           r.key_frame, r.pts)
        for a, b in zip(p.planes, r.planes):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            a = a.numpy().astype(np.int32)
            b = np.asarray(b).astype(np.int32)
            assert a.shape == b.shape
            d = np.abs(a - b)
            if r.pict_type == "I":
                assert d.max() <= 1 and (d > 0).mean() <= 0.01
            worst = min(worst, refutil.psnr(a, b))
    assert worst >= 60, worst
    return worst


@requires_ref
@pytest.mark.parametrize("nframes,extra,types", [
    (3, ["-g", "1"], "III"),
    (20, ["-g", "12", "-bf", "0"], "IPPP"),
    (12, ["-g", "12", "-bf", "2"], "IBBP"),
    (16, ["-flags", "+ildct+ilme", "-bf", "0", "-g", "8",
          "-alternate_scan", "1"], "IPPP"),
    (12, ["-flags", "+ildct+ilme", "-bf", "2", "-g", "12"], "IBBP"),
], ids=["intra", "ip", "ipb", "interlaced-ip", "interlaced-ipb"])
def test_mpeg2_streams_match_reference(tmp_path, nframes, extra, types):
    es = _ts_stream(tmp_path, nframes, extra)
    want, got = _decode_both([es])
    assert len(got) == nframes
    assert "".join(f.pict_type for f in got[:4]) == types[:4]
    _assert_bar(want, got)


@requires_ref
def test_mpeg1_stream_matches_reference(tmp_path):
    pkts = _m1v_packets(tmp_path, 10)
    assert len(pkts) == 10
    want, got = _decode_both(pkts, "mpeg1video")
    _assert_bar(want, got)


@requires_ref
def test_truncated_slice_explodes_or_conceals(tmp_path):
    """err_detect=explode raises InvalidData; otherwise the damaged
    slice is concealed as the reference conceals it."""
    pkt = _m1v_packets(tmp_path, 1)[0]
    cut = pkt[:len(pkt) // 2]
    port = CodecContext.open_decoder(CodecParameters(
        codec_id="mpeg1video"), {"err_detect": "explode"}, device="cpu")
    with pytest.raises(InvalidData):
        port.decode_all([Packet(data=cut, pts=0)])
    want, got = _decode_both([cut], "mpeg1video")
    assert len(got) == 1
    _assert_bar(want, got)


def _encode(ctx, frames):
    pkts = []
    for f in frames:
        ctx.send_frame(f)
        pkts.append(ctx.receive_packet().data)
    return pkts


@pytest.fixture(scope="module")
def encodes():
    """Both packages' MPEG-2 encodes of the 160x128 clip, I P P P P P P
    P at fixed qscale with a GOP of 4 (two I frames)."""
    frames = fx.mpeg2_clip(8, ENC_W, ENC_H)
    opts = {"qscale": 4, "gop_size": 4}
    ref = RefContext.open_encoder(RefParams(
        codec_type="video", codec_id="mpeg2video", width=ENC_W,
        height=ENC_H), options=dict(opts))
    port = CodecContext.open_encoder(EncoderParameters(
        "mpeg2video", ENC_W, ENC_H), dict(opts), device="cpu")
    return frames, {"reference": _encode(ref, frames),
                    "port": _encode(port, frames)}


@pytest.mark.parametrize("which", ["reference", "port"])
def test_encoder_streams_match_reference(encodes, which):
    """Each encoder's packets, one per picture, through both decoders;
    the port's own packets through the port's decoder is its round
    trip."""
    frames, pkts = encodes
    want, got = _decode_both(pkts[which])
    assert [f.pict_type for f in got] == list("IPPPIPPP")
    _assert_bar(want, got)
    # the decode is the source at the encoder's quality (its permuted
    # matrices cost it some 6 dB: ROADMAP.md §3)
    for f, src in zip(got, frames):
        assert fx.recon_psnr([p.numpy() for p in f.planes], src) > 30


def test_odd_size_crops_and_pads_like_reference():
    """A 72x40 I P P stream (the MB grid is 80x48): the reference crops
    each picture and edge-pads it again for the next prediction; the
    port keeps its reference pictures padded on the device the same
    way."""
    frames = fx.mpeg2_clip(3, 72, 40)
    port = CodecContext.open_encoder(EncoderParameters("mpeg2video", 72, 40),
                                     {"qscale": 6}, device="cpu")
    want, got = _decode_both(_encode(port, frames))
    assert [tuple(p.shape) for p in got[0].planes] == [(40, 72), (20, 36),
                                                        (20, 36)]
    _assert_bar(want, got)


def test_registry_device_and_stats():
    import inspect
    assert {"mpeg2video", "mpeg1video"} <= set(decoder_names())
    assert inspect.signature(port_dec.Mpeg12Decoder).parameters[
        "device"].default == "cuda"
    ctx = CodecContext.open_decoder(CodecParameters(codec_id="mpeg1video"),
                                    device="cpu")
    assert isinstance(ctx.codec, port_dec.Mpeg12Decoder)
    assert ctx.codec.device == torch.device("cpu")
    port = CodecContext.open_encoder(EncoderParameters("mpeg2video", 64, 48),
                                     {"qscale": 6}, device="cpu")
    pkts = _encode(port, fx.mpeg2_clip(2, 64, 48))
    dec = CodecContext.open_decoder(CodecParameters(codec_id="mpeg2video"),
                                    device="cpu")
    dec.codec.stats = []
    out = dec.decode_all([Packet(data=p, pts=i) for i, p in enumerate(pkts)])
    assert [f.pict_type for f in out] == ["I", "P"]
    i, p = dec.codec.stats
    assert (i["type"], p["type"]) == ("I", "P")
    assert set(i["device"]) == {"h2d", "residual"}
    assert set(p["device"]) == {"h2d", "residual", "mc"}
    assert set(p["host"]) == {"parse", "queue", "wait"}
    assert p["h2d_bytes"] > i["h2d_bytes"] == 4 * 6 * 64 * 4 * 3 + 4 * 12


def test_reference_pictures_stay_device_tensors():
    port = CodecContext.open_encoder(EncoderParameters("mpeg2video", 64, 48),
                                     {"qscale": 6}, device="cpu")
    pkts = _encode(port, fx.mpeg2_clip(3, 64, 48))
    dec = CodecContext.open_decoder(CodecParameters(codec_id="mpeg2video"),
                                    device="cpu")
    out = dec.decode_all([Packet(data=p, pts=i) for i, p in enumerate(pkts)])
    assert len(out) == 3
    assert all(isinstance(p, torch.Tensor) for p in dec.codec._next)
    assert [tuple(p.shape) for p in dec.codec._next] == [(48, 64), (24, 32),
                                                         (24, 32)]


def test_mpeg2_golden_psnr_matches_reference():
    """The round-trip golden's MPEG-2 entries, tied to the reference on
    their cheap part, the I picture: its encoder's packet of frame 0 of
    the 1920x1080 clip at testing.ENC_OPTIONS, its size, and its
    decoder's PSNR of it against the source (the P pictures' entries
    come from the same two calls in tools/gen_torch_roundtrip_fixture.py,
    and take the reference some 30 s more here)."""
    g = np.load(fx.ROUNDTRIP_GOLDEN)
    assert fx.clip_checksum(fx.mpeg2_clip(fx.RT_FRAMES, fx.W, fx.H)) == \
        str(g["clip_sha256"])
    f = fx.mpeg2_clip(1, fx.W, fx.H)[0]
    enc = RefContext.open_encoder(RefParams(
        codec_type="video", codec_id="mpeg2video", width=fx.W,
        height=fx.H), options=dict(fx.ENC_OPTIONS))
    pkt = enc.codec.encode(f)[0].data
    assert len(pkt) == int(g["mpeg2_packet_bytes"][0])
    dec = RefContext.open_decoder(RefParams(codec_id="mpeg2video"))
    (out,) = dec.decode_all([RefPacket(data=pkt, pts=0)])
    psnr = fx.recon_psnr([np.asarray(p) for p in out.planes], f)
    assert psnr == float(g["mpeg2_psnr"][0])
