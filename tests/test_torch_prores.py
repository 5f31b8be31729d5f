"""The port's ProRes decoder and encoder (ffmpeg_tpu_torch/codecs/prores.py
and prores_enc.py) against the reference's (ffmpeg_tpu/codecs/prores.py,
prores_enc.py), on the CPU.

Decoder bar, against the reference decoder on the same packets: within
1 LSB on at most 1% of samples and at least 60 dB at the format's peak
(the host parse is copied and integer; the IDCT is float32 in both,
summed in their own orders, so a sample on a rounding boundary may land
one step apart).  The streams: tests/test_prores.py's, made by the same
invocations of the reference binary, byte for byte, so that
tests/golden.py replays them (4:2:2 10-bit, an odd size, and 4:4:4
decoded at 12 bits), and crafted ones with custom quantiser matrices and
slice qscales above 128.

Encoder bar: the device transform's levels within one step of the
reference's, each differing level on a truncation boundary that float32
cannot decide (torch_port_util.assert_levels_at_ties); the packets
byte-identical when packed from the reference's levels; the port's
packets decoded by the reference decoder above 55 dB, the reference's
own bar (tests/test_prores_enc.py)."""

import numpy as np
import pytest
import torch

from conftest import requires_ref
from torch_port_util import assert_levels_at_ties

from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.codecs import prores as ref_dec
from ffmpeg_tpu.codecs import prores_enc as ref_enc
from ffmpeg_tpu.core.frame import Frame as RefFrame
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io import open_input
from ffmpeg_tpu.io.stream import CodecParameters as RefParams
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import CodecContext
from ffmpeg_tpu_torch.codecs import prores as port_dec
from ffmpeg_tpu_torch.codecs import prores_enc as port_enc
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType

from test_prores import _encode as _ref_binary_encode

BITS = {"yuv422p10le": 10, "yuv444p10le": 10, "yuv444p12le": 12,
        "yuv422p12le": 12}


def _port_decoder(codec_id="prores", codec_tag=0, device="cpu"):
    return CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id=codec_id,
        codec_tag=codec_tag), device=device)


def _decode_both(pkts, codec_id="prores", codec_tag=0):
    ref = RefContext.open_decoder(RefParams(
        codec_type="video", codec_id=codec_id, codec_tag=codec_tag))
    want = ref.decode_all([RefPacket(data=p, pts=i)
                           for i, p in enumerate(pkts)])
    got = _port_decoder(codec_id, codec_tag).decode_all(
        [Packet(data=p, pts=i) for i, p in enumerate(pkts)])
    return want, got


def _assert_decoder_bar(want, got) -> float:
    """The decoder bar; returns the worst PSNR."""
    assert len(got) == len(want) and len(got) > 0
    worst = np.inf
    for r, p in zip(want, got):
        assert (p.width, p.height, p.format, p.pts) == \
            (r.width, r.height, r.format, r.pts)
        peak = (1 << BITS[p.format]) - 1
        for a, b in zip(p.planes, r.planes):
            assert isinstance(a, torch.Tensor) and a.dtype == torch.int16
            a = a.numpy().astype(np.int32)
            b = np.asarray(b).astype(np.int32)
            assert a.shape == b.shape
            d = np.abs(a - b)
            assert d.max() <= 1 and (d > 0).mean() <= 0.01, \
                (d.max(), (d > 0).mean())
            mse = float((d.astype(np.float64) ** 2).mean())
            worst = min(worst, 10 * np.log10(peak ** 2 / max(mse, 1e-12)))
    assert worst >= 60, worst
    return worst


def _smooth(w, h, bits, is444, i=0):
    """tests/test_prores_enc.py's content at any size: sinusoids."""
    mx = (1 << bits) - 1
    cw = w if is444 else w // 2
    mid, amp = 1 << (bits - 1), mx // 4
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((mid + amp * np.sin(xx / 9 + i) + amp / 2 * np.cos(yy / 7))
         .astype(np.int64)) & mx
    u = ((mid + amp / 3 * np.sin(xx[:, :cw] / 5 + i)).astype(np.int64)) & mx
    v = ((mid + amp / 3 * np.cos(yy[:, :cw] / 6)).astype(np.int64)) & mx
    return [p.astype(np.uint16) for p in (y, u, v)]


def _content(w, h, bits, is444, seed=0):
    """Textured planes of `bits` samples (the clip's luma, noise chroma)."""
    rng = np.random.default_rng(seed)
    mx = (1 << bits) - 1
    y = np.asarray(fx.mpeg2_clip(1, w, h, seed)[0].planes[0],
                   np.int64) << (bits - 8)
    cw = w if is444 else w // 2
    ch = [rng.integers(mx // 8, mx - mx // 8, (h, cw)) for _ in range(2)]
    return [p.astype(np.uint16) for p in [y] + ch]


# ---------------------------------------------------------------- host copies
def test_host_copies_equal_reference():
    np.testing.assert_array_equal(port_dec.PROGRESSIVE_SCAN,
                                  ref_dec.PROGRESSIVE_SCAN)
    for name in ("_FIRST_DC_CB", "_DC_CB", "_RUN_CB", "_LEV_CB"):
        assert getattr(port_dec, name) == getattr(ref_dec, name), name
    np.testing.assert_array_equal(port_enc._QMAT_FLAT4, ref_enc._QMAT_FLAT4)
    for mb_w in (1, 3, 7, 8, 9, 120, 121):
        for sw in (1, 2, 4, 8):
            assert port_enc._slice_layout(mb_w, sw) == \
                ref_enc._slice_layout(mb_w, sw)
    rng = np.random.default_rng(3)
    for cb in sorted({*ref_dec._DC_CB, *ref_dec._RUN_CB, *ref_dec._LEV_CB,
                      ref_dec._FIRST_DC_CB}):
        vals = [int(v) for v in rng.integers(0, 3000, 40)] + list(range(8))
        a, b = port_enc._BitWriter(), ref_enc._BitWriter()
        for v in vals:
            port_enc._put_codeword(a, cb, v)
            ref_enc._put_codeword(b, cb, v)
        data = a.flush()
        assert data == b.flush()
        bits, rbits = port_dec._Bits(data), ref_dec._Bits(data)
        assert [port_dec._codeword(bits, cb) for _ in vals] == \
            [ref_dec._codeword(rbits, cb) for _ in vals] == vals
    q = rng.laplace(0, 4, (16, 64)).astype(np.int32)
    q[:, 30:] = 0
    a, b = port_enc._BitWriter(), ref_enc._BitWriter()
    port_enc._encode_dcs(a, q[:, 0])
    port_enc._encode_acs(a, q)
    ref_enc._encode_dcs(b, q[:, 0])
    ref_enc._encode_acs(b, q)
    data = a.flush()
    assert data == b.flush()
    out = np.zeros((16, 64), np.int32)
    port_dec._entropy(data, out)
    np.testing.assert_array_equal(ref_dec.ProresDecoder._entropy(data, 16),
                                  out)
    np.testing.assert_array_equal(out, q)


# ---------------------------------------------------------------- decoder
@requires_ref
@pytest.mark.parametrize("size,pix,profile,frames", [
    ("128x96", "yuv422p10le", None, 2),
    ("320x180", "yuv422p10le", 3, 1),
    ("128x96", "yuv444p10le", 4, 1),
    ("130x98", "yuv422p10le", None, 1),
], ids=["422-standard", "422-hq", "4444-12bit", "422-odd"])
def test_decoder_matches_reference(tmp_path, size, pix, profile, frames):
    """tests/test_prores.py's streams (the 4444 profile decodes at 12
    bits, as the reference's does)."""
    path = _ref_binary_encode(tmp_path, size=size, pix=pix, profile=profile,
                              frames=frames)
    d = open_input(str(path))
    par = d.streams[0].codecpar
    pkts = [p.data for p in d.packets()]
    assert len(pkts) == frames
    want, got = _decode_both(pkts, par.codec_id, par.codec_tag)
    _assert_decoder_bar(want, got)
    if profile == 4:
        assert got[0].format == "yuv444p12le"


def _craft(w, h, fmt, seed):
    """A packet of the reference encoder whose frame header carries
    custom quantiser matrices and whose slices carry qscale codes above
    128 (as the reference decoder reads them: (code - 96) << 2) and
    below, every one of 1..224 possible."""
    bits, is444 = BITS[fmt], fmt.startswith("yuv444")
    par = RefParams(codec_type=MediaType.VIDEO, codec_id="prores",
                    width=w, height=h, pix_fmt=fmt)
    enc = RefContext.open_encoder(par, options={"qscale": 2})
    pkt = bytearray(enc.codec.encode(RefFrame.video(
        w, h, fmt, planes=_content(w, h, bits, is444, seed), pts=0))[0].data)
    rng = np.random.default_rng(seed)
    fh = 8                                  # past the icpf atom header
    assert pkt[fh + 19] == 0x03             # both matrices present
    pkt[fh + 20:fh + 148] = rng.integers(1, 64, 128, dtype=np.uint8).tobytes()
    pic = fh + int.from_bytes(pkt[fh:fh + 2], "big")
    n = int.from_bytes(pkt[pic + 5:pic + 7], "big")
    sizes = [int.from_bytes(pkt[pic + 8 + 2 * i:pic + 10 + 2 * i], "big")
             for i in range(n)]
    pos = pic + 8 + 2 * n
    for i, s in enumerate(sizes):
        pkt[pos + 1] = int(rng.integers(129, 225)) if i % 3 else \
            int(rng.integers(1, 129))
        pos += s
    return bytes(pkt), enc.codec.tag.decode()


@pytest.mark.parametrize("w,h,fmt", [(96, 48, "yuv422p10le"),
                                     (72, 40, "yuv444p12le")],
                         ids=["422-10bit", "444-12bit"])
def test_decoder_custom_qmat_and_high_qscale(w, h, fmt):
    pkt, tag = _craft(w, h, fmt, seed=w)
    want, got = _decode_both([pkt], "prores", tag)
    assert got[0].format == fmt
    _assert_decoder_bar(want, got)


def test_one_device_pass_per_plane(monkeypatch):
    """The dequantise + IDCT runs once per plane per picture (the
    reference runs it three times per slice)."""
    calls = []
    real = port_dec.idct8x8
    monkeypatch.setattr(port_dec, "idct8x8",
                        lambda x: calls.append(x.shape) or real(x))
    pkt, tag = _craft(160, 64, "yuv422p10le", seed=1)
    dec = _port_decoder(codec_tag=tag)
    dec.codec.stats = []
    f = dec.decode_all([Packet(data=pkt, pts=0)])[0]
    assert len(calls) == 3
    assert [s[0] for s in calls] == [160 // 8 * 64 // 8,
                                     80 // 8 * 64 // 8,
                                     80 // 8 * 64 // 8]
    (st,) = dec.codec.stats
    assert st["h2d_bytes"] == dec.codec.last_parsed.nbytes() > 0
    assert set(st["device"]) == {"h2d", "transform"}
    assert [tuple(p.shape) for p in f.planes] == [(64, 160), (64, 80),
                                                  (64, 80)]
    planes = port_dec.reconstruct(dec.codec.last_parsed, "cpu")
    for a, b in zip(planes, f.planes):
        assert torch.equal(a, b)


def test_device_defaults_and_numpy_gives_uint16():
    import inspect
    for cls in (port_dec.ProresDecoder, port_enc.ProresEncoder):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    pkt, tag = _craft(32, 16, "yuv422p10le", seed=2)
    f = _port_decoder(codec_tag=tag).decode_all([Packet(data=pkt)])[0]
    assert all(p.device.type == "cpu" and p.dtype == torch.int16
               for p in f.planes)
    assert all(p.dtype == np.uint16 for p in f.numpy().planes)
    from ffmpeg_tpu_torch.utils.error import NotSupported
    with pytest.raises(NotSupported):
        CodecContext.open_encoder(CodecParameters(
            codec_id="prores", width=16, height=16, pix_fmt="yuv420p"),
            device="cpu")


# ---------------------------------------------------------------- encoder
def _ref_levels(enc, planes):
    """The reference's device analysis of one frame, as its encode runs
    it (the same edge padding, grid and _quant_blocks), with the padded
    planes."""
    w, h = enc.width, enc.height
    W, H = -(-w // 16) * 16, -(-h // 16) * 16
    out, pads = [], []
    for i, p in enumerate(planes):
        tw = W if (enc.is444 or i == 0) else W // 2
        pad = np.pad(np.asarray(p).astype(np.uint16),
                     ((0, H - p.shape[0]), (0, tw - p.shape[1])),
                     mode="edge")
        g = enc._grid_blocks(pad, 8, 8)
        out.append(enc._quant_blocks(g.reshape(-1, 8, 8), ref_enc._QMAT_FLAT4)
                   .reshape(g.shape[0], g.shape[1], 64))
        pads.append(pad)
    return out, pads


def _encoders(w, h, fmt, qscale):
    ref = RefContext.open_encoder(RefParams(
        codec_type=MediaType.VIDEO, codec_id="prores", width=w, height=h,
        pix_fmt=fmt), options={"qscale": qscale})
    port = CodecContext.open_encoder(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="prores", width=w, height=h,
        pix_fmt=fmt), {"qscale": qscale}, device="cpu")
    return ref, port


@pytest.mark.parametrize("w,h,fmt,qscale", [
    (120, 70, "yuv422p10le", 4),
    (33, 17, "yuv422p10le", 1),
    (130, 98, "yuv444p12le", 4),
    (64, 48, "yuv422p10le", 128),
    (17, 35, "yuv444p12le", 9),
], ids=["422", "422-odd-q1", "444-12bit-odd", "422-q128", "444-odd-q9"])
def test_encoder_matches_reference(w, h, fmt, qscale):
    bits, is444 = BITS[fmt], fmt.startswith("yuv444")
    planes = _content(w, h, bits, is444, seed=w + h)
    ref, port = _encoders(w, h, fmt, qscale)
    want_pkt = ref.codec.encode(RefFrame.video(w, h, fmt, planes=planes,
                                               pts=3))[0]
    port.send_frame(Frame.video(w, h, fmt, planes=planes, pts=3))
    got_pkt = port.receive_packet()
    want, pads = _ref_levels(ref.codec, planes)
    got = port.codec.transform(Frame.video(w, h, fmt, planes=planes))
    for a, b, pad in zip(got, want, pads):
        assert a.dtype == np.int32 and a.shape == b.shape
        x, tol = fx.prores_decisions(fx.plane_blocks(pad),
                                     ref_enc._QMAT_FLAT4, qscale,
                                     bits == 12)
        assert_levels_at_ties(a, b, x, tol, "trunc")
    # the packing, byte for byte, on the reference's levels
    assert port.codec._pack(want) == want_pkt.data
    if all(np.array_equal(a, b) for a, b in zip(got, want)):
        assert got_pkt.data == want_pkt.data
    assert (got_pkt.flags, got_pkt.pts) == (want_pkt.flags, want_pkt.pts)
    assert port.par.codec_tag == ref.par.codec_tag


@pytest.mark.parametrize("w,h,fmt", [(120, 70, "yuv422p10le"),
                                     (37, 21, "yuv444p12le")],
                         ids=["422", "444-12bit-odd"])
def test_port_packets_decode_in_both_decoders(w, h, fmt):
    """Round trip: the port's packet through the reference decoder
    above 55 dB against the source (tests/test_prores_enc.py's bar), and
    through the port's decoder within the decoder bar of the
    reference's decode."""
    bits, is444 = BITS[fmt], fmt.startswith("yuv444")
    planes = _smooth(w, h, bits, is444)
    _ref, port = _encoders(w, h, fmt, 4)
    port.codec.stats = []
    port.send_frame(Frame.video(w, h, fmt, planes=planes, pts=0))
    pkt = port.receive_packet().data
    (st,) = port.codec.stats
    assert st["transform"] > 0 and st["pack"] > 0
    want, got = _decode_both([pkt], "prores", port.par.codec_tag)
    assert min(fx.plane_psnr(want[0].planes, planes, bits)) > 55
    _assert_decoder_bar(want, got)


def test_golden_matches_reference_at_1080p():
    """The intra golden's ProRes entries, tied to the reference at
    1920x1080 (its encode ~10 s here): the reference encoder's packet
    equals the golden's sha256 and size; the port's transform of the
    same frame on the CPU is within the tie-aware bar of the reference's
    levels."""
    import hashlib
    g = np.load(fx.INTRA_GOLDEN)
    src = fx.intra_clip_frame(1920, 1080)
    assert fx.clip_checksum([src]) == str(g["clip_sha256"])
    ref, port = _encoders(1920, 1080, "yuv422p10le", fx.INTRA_QSCALE)
    pkt = ref.codec.encode(RefFrame.video(1920, 1080, "yuv422p10le",
                                          planes=src.planes, pts=0))[0].data
    assert hashlib.sha256(pkt).hexdigest() == str(g["prores_packet_sha256"])
    assert len(pkt) == int(g["prores_packet_bytes"])
    want, pads = _ref_levels(ref.codec, src.planes)
    got = port.codec.transform(src)
    diff = 0
    for a, b, pad in zip(got, want, pads):
        x, tol = fx.prores_decisions(fx.plane_blocks(pad),
                                     ref_enc._QMAT_FLAT4, fx.INTRA_QSCALE,
                                     False)
        diff += assert_levels_at_ties(a, b, x, tol, "trunc")["diff"]
    assert diff < 1e-2 * sum(a.size for a in got)
