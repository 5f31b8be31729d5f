"""The port's DNxHD/DNxHR decoder and encoder (ffmpeg_tpu_torch/codecs/
dnxhd.py, dnxhd_enc.py, dnxhd_tables.py) against the reference's
(ffmpeg_tpu/codecs/dnxhd.py, dnxhd_enc.py), on the CPU.

Decoder bar, against the reference decoder on the same packets: within
1 LSB on at most 1% of samples and at least 60 dB at the format's peak
(the host VLC walk is copied and integer; the IDCT is float32 in both,
summed in their own orders).  The streams: tests/test_dnxhd.py's, made
by the same invocations of the reference binary, byte for byte, so that
tests/golden.py replays them (LB, SQ, HQ, HQX 10-bit, an odd size), and
crafted ones for what the reference binary's streams leave out: 4:4:4
(CID 1270) at 10 and 12 bits and 4:2:2 at 12 bits.

Encoder bar: the levels of the device FDCT within one step of the
reference's, each differing level on a rounding tie that float32
cannot decide (torch_port_util.assert_levels_at_ties; the DC is
sum/8, on an exact tie in about one block in eight); the packets
byte-identical when packed from the reference's coefficients; the
port's packets decoded by the reference decoder above 55 dB at 10 bits
and 45 dB at 8, the reference's own bars (tests/test_dnxhd_enc.py)."""

import subprocess

import numpy as np
import pytest
import torch

import refutil
from conftest import requires_ref
from torch_port_util import assert_levels_at_ties

from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.codecs import dnxhd as ref_dec
from ffmpeg_tpu.codecs import dnxhd_enc as ref_enc
from ffmpeg_tpu.codecs import dnxhd_tables as ref_tables
from ffmpeg_tpu.core.frame import Frame as RefFrame
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io import open_input
from ffmpeg_tpu.io.stream import CodecParameters as RefParams
from ffmpeg_tpu.ops.idct import fdct8x8 as ref_fdct
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import CodecContext
from ffmpeg_tpu_torch.codecs import dnxhd as port_dec
from ffmpeg_tpu_torch.codecs import dnxhd_enc as port_enc
from ffmpeg_tpu_torch.codecs import dnxhd_tables as port_tables
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType

BITS = {"yuv422p": 8, "yuv422p10le": 10, "yuv422p12le": 12,
        "yuv444p10le": 10, "yuv444p12le": 12}


def _decode_both(pkts):
    ref = RefContext.open_decoder(RefParams(codec_type="video",
                                            codec_id="dnxhd"))
    want = ref.decode_all([RefPacket(data=p, pts=i)
                           for i, p in enumerate(pkts)])
    got = CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="dnxhd"), device="cpu") \
        .decode_all([Packet(data=p, pts=i) for i, p in enumerate(pkts)])
    return want, got


def _assert_decoder_bar(want, got) -> float:
    assert len(got) == len(want) and len(got) > 0
    worst = np.inf
    for r, p in zip(want, got):
        assert (p.width, p.height, p.format, p.pts) == \
            (r.width, r.height, r.format, r.pts)
        bits = BITS[p.format]
        for a, b in zip(p.planes, r.planes):
            assert isinstance(a, torch.Tensor)
            assert a.dtype == (torch.uint8 if bits == 8 else torch.int16)
            a = a.numpy().astype(np.int32)
            b = np.asarray(b).astype(np.int32)
            assert a.shape == b.shape
            d = np.abs(a - b)
            assert d.max() <= 1 and (d > 0).mean() <= 0.01, \
                (d.max(), (d > 0).mean())
            mse = float((d.astype(np.float64) ** 2).mean())
            peak = (1 << bits) - 1
            worst = min(worst, 10 * np.log10(peak ** 2 / max(mse, 1e-12)))
    assert worst >= 60, worst
    return worst


# ---------------------------------------------------------------- host copies
def test_tables_and_host_copies_equal_reference():
    names = sorted(n for n in vars(ref_tables) if n.isupper())
    assert names == sorted(n for n in vars(port_tables) if n.isupper())
    for n in names:
        assert getattr(port_tables, n) == getattr(ref_tables, n), n
    assert port_dec._HR_PREFIXES == ref_dec._HR_PREFIXES
    for cid in ref_tables.CID_TABLE:
        for bd in (8, 10, 12):
            try:
                b = ref_dec._tables(cid, bd)
            except IndexError:
                # an 8-bit CID's 12-entry DC table read as 14 entries at
                # more than 8 bits: both raise
                with pytest.raises(IndexError):
                    port_dec._tables(cid, bd)
                continue
            a = port_dec._tables(cid, bd)
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], tuple):
                    assert a[k][0] == b[k][0]
                    for x, y in zip(a[k][1:], b[k][1:]):
                        np.testing.assert_array_equal(x, y)
                elif isinstance(a[k], np.ndarray):
                    np.testing.assert_array_equal(a[k], b[k])
                else:
                    assert a[k] == b[k], k
        ea, eb = port_enc._enc_tables(cid), ref_enc._enc_tables(cid)
        for k in ea:
            if isinstance(ea[k], np.ndarray):
                np.testing.assert_array_equal(ea[k], eb[k])
            else:
                assert ea[k] == eb[k], k


def test_vectorised_levels_equal_quant():
    """testing.dnxhd_levels, the checks' form of the encoder's quant over
    whole arrays, gives DnxhdEncoder.quant's levels."""
    enc = CodecContext.open_encoder(CodecParameters(
        codec_id="dnxhd", width=32, height=16, pix_fmt="yuv422p10le"),
        {"qscale": 3}, device="cpu").codec
    rng = np.random.default_rng(0)
    blocks = rng.normal(0, 300, (300, 8, 8)).astype(np.float32)
    blocks[::3, 4:] = 0
    blocks[::5, 0, 0] = np.float32(812.5)        # DC ties
    for scale in (enc.tb["lw"] * 3, enc.tb["cw"] * 3):
        np.testing.assert_array_equal(
            fx.dnxhd_levels(blocks, scale, 3),
            np.stack([enc.quant(b, scale) for b in blocks]))


# ---------------------------------------------------------------- decoder
@requires_ref
@pytest.mark.parametrize("profile,pix,w,h,frames", [
    ("dnxhr_lb", "yuv422p", 256, 128, 2),
    ("dnxhr_sq", "yuv422p", 256, 128, 2),
    ("dnxhr_hq", "yuv422p", 256, 128, 2),
    ("dnxhr_hqx", "yuv422p10le", 256, 128, 2),
    ("dnxhr_sq", "yuv422p", 260, 130, 1),
], ids=["lb", "sq", "hq", "hqx-10bit", "sq-odd"])
def test_decoder_matches_reference(tmp_path, profile, pix, w, h, frames):
    """tests/test_dnxhd.py's streams, by its invocation of the reference
    binary, byte for byte."""
    p = tmp_path / f"{profile}.mov"
    subprocess.run(
        [str(refutil.REF), "-v", "error", "-f", "lavfi",
         "-i", f"testsrc2=size={w}x{h}:rate=25", "-frames:v", str(frames),
         "-c:v", "dnxhd", "-profile:v", profile, "-pix_fmt", pix,
         "-y", str(p)], check=True, capture_output=True)
    pkts = [x.data for x in open_input(str(p)).packets()]
    assert len(pkts) == frames
    want, got = _decode_both(pkts)
    assert got[0].format == pix
    _assert_decoder_bar(want, got)


def _craft(w, h, cid, bit_depth, seed):
    """A DNxHR packet of random levels, written with the reference's own
    _put_dc/_put_ac on the CID's tables: 4:4:4 (12 blocks a macroblock,
    Y Y U U V V per half) where the CID says so."""
    e = ref_tables.CID_TABLE[cid]
    is444 = e["is444"]
    enc = RefContext.open_encoder(RefParams(
        codec_type=MediaType.VIDEO, codec_id="dnxhd", width=16, height=16,
        pix_fmt="yuv422p10le")).codec
    enc.tb = ref_enc._enc_tables(cid)
    rng = np.random.default_rng(seed)
    mb_w, mb_h = -(-w // 16), -(-h // 16)
    nblk = 12 if is444 else 8
    rows = []
    for _ in range(mb_h):
        bw = ref_enc._BitWriter()
        last_dc = [1 << (bit_depth + 2)] * 3
        for _x in range(mb_w):
            bw.put(11, int(rng.integers(1, 40)))
            bw.put(1, 0)
            for n in range(nblk):
                comp = (n >> 1) % 3 if is444 else \
                    (0 if (n & 2) == 0 else 1 + (n & 1))
                zz = np.zeros(64, np.int64)
                zz[0] = last_dc[comp] + int(rng.integers(-40, 41))
                k = int(rng.integers(0, 20))
                pos = rng.choice(np.arange(1, 64), k, replace=False)
                zz[pos] = rng.integers(-30, 31, k)
                enc._put_dc(bw, int(zz[0]) - last_dc[comp])
                last_dc[comp] = int(zz[0])
                enc._put_ac(bw, zz)
        rows.append(bw.flush())
    hdr = bytearray(0x280)
    hdr[0:5] = b"\x00\x00\x02\x80\x01"
    hdr[0x18:0x1a] = h.to_bytes(2, "big")
    hdr[0x1a:0x1c] = w.to_bytes(2, "big")
    hdr[0x21] = {8: 1, 10: 2, 12: 3}[bit_depth] << 5
    hdr[0x28:0x2c] = cid.to_bytes(4, "big")
    hdr[0x2c] = 0x40 if is444 else 0
    hdr[0x16c:0x16e] = mb_h.to_bytes(2, "big")
    off = 0
    for i, r in enumerate(rows):
        hdr[0x170 + 4 * i:0x174 + 4 * i] = off.to_bytes(4, "big")
        off += len(r)
    return bytes(hdr) + b"".join(rows)


@pytest.mark.parametrize("w,h,cid,bd,fmt", [
    (48, 32, 1270, 10, "yuv444p10le"),
    (40, 23, 1270, 12, "yuv444p12le"),
    (50, 18, 1271, 12, "yuv422p12le"),
], ids=["444-10bit", "444-12bit-odd", "422-12bit-odd"])
def test_decoder_crafted_444_and_12bit(w, h, cid, bd, fmt):
    pkt = _craft(w, h, cid, bd, seed=w)
    want, got = _decode_both([pkt])
    assert got[0].format == fmt
    _assert_decoder_bar(want, got)


def test_one_device_pass_per_picture(monkeypatch):
    """The IDCT runs once per picture over all its blocks (the reference
    runs it once per macroblock row), and `reconstruct` replays the
    picture's parse."""
    calls = []
    real = port_dec.idct8x8
    monkeypatch.setattr(port_dec, "idct8x8",
                        lambda x: calls.append(tuple(x.shape)) or real(x))
    pkt = _craft(64, 48, 1270, 10, seed=3)
    dec = CodecContext.open_decoder(CodecParameters(codec_id="dnxhd"),
                                    device="cpu")
    dec.codec.stats = []
    f = dec.decode_all([Packet(data=pkt)])[0]
    assert calls == [(3, 4, 12, 8, 8)]
    (st,) = dec.codec.stats
    assert st["h2d_bytes"] == dec.codec.last_parsed.nbytes() > 0
    for a, b in zip(port_dec.reconstruct(dec.codec.last_parsed, "cpu"),
                    f.planes):
        assert torch.equal(a, b)
    import inspect
    for cls in (port_dec.DnxhdDecoder, port_enc.DnxhdEncoder):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    assert all(p.dtype == np.uint16 for p in f.numpy().planes)


# ---------------------------------------------------------------- encoder
def _ref_coefs(w, h, planes):
    """The reference encoder's FDCT of a frame, as its encode runs it
    (edge padding to the macroblock grid, raw samples), and the padded
    planes' blocks."""
    import jax.numpy as jnp
    W, H = -(-w // 16) * 16, -(-h // 16) * 16
    coefs, blocks = {}, {}
    for name, p, tw in zip("yuv", planes, (W, W // 2, W // 2)):
        pad = np.pad(np.asarray(p), ((0, H - p.shape[0]),
                                     (0, tw - p.shape[1])), mode="edge")
        g = fx.plane_blocks(pad).astype(np.float32)
        coefs[name] = np.asarray(ref_fdct(jnp.asarray(
            g.reshape(-1, 8, 8)))).reshape(g.shape)
        blocks[name] = g
    return coefs, blocks


def _content(w, h, bits, seed):
    rng = np.random.default_rng(seed)
    dt = np.uint16 if bits > 8 else np.uint8
    y = np.asarray(fx.mpeg2_clip(1, w, h, seed)[0].planes[0],
                   np.int64) << (bits - 8)
    mx = (1 << bits) - 1
    ch = [rng.integers(mx // 8, mx - mx // 8, (h, w // 2))
          for _ in range(2)]
    return [p.astype(dt) for p in [y] + ch]


def _encoders(w, h, fmt, qscale):
    ref = RefContext.open_encoder(RefParams(
        codec_type=MediaType.VIDEO, codec_id="dnxhd", width=w, height=h,
        pix_fmt=fmt), options={"qscale": qscale})
    port = CodecContext.open_encoder(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="dnxhd", width=w, height=h,
        pix_fmt=fmt), {"qscale": qscale}, device="cpu")
    return ref, port


def _check_levels(port, got, want, blocks) -> int:
    """The tie-aware bar on every plane's levels; returns the count of
    differing levels."""
    tb, qs, diff = port.tb, port.qscale, 0
    for name in "yuv":
        scale = (tb["lw"] if name == "y" else tb["cw"]) * qs
        x, tol = fx.dnxhd_decisions(blocks[name], scale, qs)
        diff += assert_levels_at_ties(
            fx.dnxhd_levels(got[name], scale, qs),
            fx.dnxhd_levels(want[name], scale, qs), x, tol, "round")["diff"]
    return diff


@pytest.mark.parametrize("w,h,fmt,qscale", [
    (128, 80, "yuv422p10le", 4),
    (66, 34, "yuv422p", 4),
    (48, 32, "yuv422p10le", 1),
    (40, 24, "yuv422p", 30),
], ids=["hqx", "hq-odd", "hqx-q1", "hq-q30"])
def test_encoder_matches_reference(w, h, fmt, qscale):
    planes = _content(w, h, BITS[fmt], seed=w)
    ref, port = _encoders(w, h, fmt, qscale)
    want_pkt = ref.codec.encode(RefFrame.video(w, h, fmt, planes=planes,
                                               pts=1))[0]
    port.send_frame(Frame.video(w, h, fmt, planes=planes, pts=1))
    got_pkt = port.receive_packet()
    want, blocks = _ref_coefs(w, h, planes)
    got = port.codec.transform(Frame.video(w, h, fmt, planes=planes))
    diff = _check_levels(port.codec, got, want, blocks)
    # the quantise and packing, byte for byte, on the reference's FDCT
    assert port.codec._pack(want) == want_pkt.data
    if diff == 0:
        assert got_pkt.data == want_pkt.data
    assert (got_pkt.flags, got_pkt.pts) == (want_pkt.flags, want_pkt.pts)
    assert port.par.codec_tag == ref.par.codec_tag


@pytest.mark.parametrize("fmt,gate", [("yuv422p10le", 55.0),
                                      ("yuv422p", 45.0)],
                         ids=["10bit", "8bit"])
def test_port_packets_decode_in_both_decoders(fmt, gate):
    """Round trip on tests/test_dnxhd_enc.py's content at 128x80: the
    port's packets through the reference decoder above its gate, and
    through the port's decoder within the decoder bar."""
    from test_dnxhd_enc import _content as enc_content
    bits = BITS[fmt]
    _ref, port = _encoders(128, 80, fmt, 4)
    port.codec.stats = []
    pkts, src = [], enc_content(bits)
    for i, planes in enumerate(src):
        port.send_frame(Frame.video(128, 80, fmt, planes=planes, pts=i))
        pkts.append(port.receive_packet().data)
    assert all(s["transform"] > 0 and s["pack"] > 0
               for s in port.codec.stats)
    want, got = _decode_both(pkts)
    for f, planes in zip(want, src):
        assert min(fx.plane_psnr(f.planes, planes, bits)) > gate
    _assert_decoder_bar(want, got)


def test_transform_at_1080p_within_the_tie_bar():
    """The golden's frame at 1920x1080: the port's FDCT on the CPU gives
    the reference's levels within the tie-aware bar (the reference's
    full 1080p encode, ~25 s of Python quantise loop here, runs only in
    tools/gen_torch_intra_fixture.py)."""
    src = fx.intra_clip_frame(1920, 1080)
    assert fx.clip_checksum([src]) == str(np.load(fx.INTRA_GOLDEN)
                                          ["clip_sha256"])
    _ref, port = _encoders(1920, 1080, "yuv422p10le", fx.INTRA_QSCALE)
    want, blocks = _ref_coefs(1920, 1080, src.planes)
    got = port.codec.transform(src)
    diff = _check_levels(port.codec, got, want, blocks)
    assert diff < 1e-2 * 1920 * 1088 * 2
