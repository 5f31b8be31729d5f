"""The port's MPEG-4 Part 2 and H.263 decoders (ffmpeg_tpu_torch/codecs/
mpeg4.py, mpeg4_tables.py) against the reference's
(ffmpeg_tpu/codecs/mpeg4.py), on the CPU.

Bar, against the reference's decoder on the same packets: I pictures
within 1 LSB on at most 1% of samples, every picture at 60 dB or more
(tests/test_torch_mpeg12.py's `_assert_bar`: the host parse, the MC and
the rounding are copied and integer; the IDCT is float32 in both,
summed in their own orders, and a sample on a rounding boundary may
land one step apart, which MC then carries into later pictures).

The streams are the nine of tests/test_mpeg4.py, made by the same
invocations of the reference binary, byte for byte, each in a fresh
tmp_path (an existing output path changes the key), so that
tests/golden.py replays them; the reference's demuxer takes the packets
out.  The three committed in tests/data/port/mpeg4_streams.npz (which
chip_smoke.py decodes on the card) are tied to the reference here."""

import hashlib
import subprocess

import numpy as np
import pytest
import torch

import refutil
from conftest import requires_ref

from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.codecs import mpeg4 as ref_mod
from ffmpeg_tpu.codecs import mpeg4_tables as ref_tables
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io.demux import open_input
from ffmpeg_tpu.io.stream import CodecParameters as RefParams
from ffmpeg_tpu.utils.error import EndOfStream
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import CodecContext, decoder_names
from ffmpeg_tpu_torch.codecs import mpeg4 as port_mod
from ffmpeg_tpu_torch.codecs import mpeg4_tables as port_tables
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType

from test_mpeg4 import W, H, _make
from test_torch_mpeg12 import _assert_bar


def _demux(path):
    d = open_input(str(path))
    par = d.streams[0].codecpar
    pkts = []
    while True:
        try:
            pkts.append(d.read_packet())
        except EndOfStream:
            break
    return par, pkts


def _port_params(par):
    return CodecParameters(codec_type=MediaType.VIDEO,
                           codec_id=par.codec_id, width=par.width,
                           height=par.height,
                           extradata=bytes(par.extradata or b""))


def _decode_both(par, pkts, stats=None):
    want = RefContext.open_decoder(par).decode_all(pkts)
    port = CodecContext.open_decoder(_port_params(par), device="cpu")
    port.codec.stats = stats
    got = port.decode_all([Packet(data=bytes(p.data), pts=p.pts,
                                  time_base=p.time_base) for p in pkts])
    return want, got


def _h263(tmp_path, name, size, frames, extra):
    """tests/test_mpeg4.py's H.263 invocations, as they are."""
    p = tmp_path / name
    subprocess.run(
        [str(refutil.REF), "-v", "error", "-f", "lavfi", "-i",
         f"testsrc2=size={size}:rate=25", "-frames:v", str(frames),
         "-c:v", "h263", *extra, "-y", str(p)], check=True)
    return p


def _mov(tmp_path):
    p = tmp_path / "m.mp4"
    subprocess.run(
        [str(refutil.REF), "-v", "error", "-f", "lavfi", "-i",
         f"testsrc2=size={W}x{H}:rate=25", "-frames:v", "8",
         "-c:v", "mpeg4", "-q:v", "4", "-y", str(p)], check=True)
    return p


STREAMS = {
    "intra_p": lambda t: _make(t, "ip.avi", ["-q:v", "4", "-bf", "0",
                                             "-g", "5"]),
    "bframes": lambda t: _make(t, "b.avi", ["-q:v", "4", "-bf", "2"],
                               frames=15),
    "4mv": lambda t: _make(t, "mv4.avi", ["-q:v", "4", "-flags", "+mv4"]),
    "mpeg_quant": lambda t: _make(t, "mq.avi", ["-q:v", "6",
                                                "-mpeg_quant", "1"]),
    "rate_control_dquant": lambda t: _make(t, "rc.avi",
                                           ["-b:v", "150k", "-bf", "1"],
                                           frames=20),
    "qcif_unaligned": lambda t: _make(t, "odd.avi", ["-q:v", "5"],
                                      size="180x130"),
    "mov_container": _mov,
    "h263_baseline": lambda t: _h263(t, "h263.avi", f"{W}x{H}", 10,
                                     ["-q:v", "5"]),
    "h263_cif_rc": lambda t: _h263(t, "h263cif.avi", "352x288", 8,
                                   ["-b:v", "400k"]),
}


@requires_ref
@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_matches_reference(tmp_path, name):
    par, pkts = _demux(STREAMS[name](tmp_path))
    stats = []
    want, got = _decode_both(par, pkts, stats)
    _assert_bar(want, got)
    assert len(stats) == len(got)
    assert all(s["host"]["parse"] > 0 and "mc" in s["host"] for s in stats)
    if name == "bframes":
        assert {f.pict_type for f in got} == {"I", "P", "B"}
    if name == "4mv":
        assert {f.pict_type for f in got} == {"I", "P"}


@pytest.mark.parametrize("name", fx.MPEG4_STREAM_NAMES)
def test_committed_streams_match_reference(name):
    """mpeg4_streams.npz against the reference: its decoder gives the
    committed sha256 on the committed packets, and the port's decode is
    within the bar of it."""
    st = fx.mpeg4_stream(name)
    par = RefParams(codec_type="video", codec_id=st["codec_id"],
                    width=st["width"], height=st["height"],
                    extradata=st["extradata"])
    from ffmpeg_tpu.utils.rational import Rational
    rp = [RefPacket(data=p, pts=t, time_base=Rational(1, 25))
          for p, t in zip(st["packets"], st["pts"])]
    want, got = _decode_both(par, rp)
    assert [f.pict_type for f in want] == st["types"]
    assert [[hashlib.sha256(np.ascontiguousarray(np.asarray(p)).tobytes())
             .hexdigest() for p in f.planes] for f in want] == st["sha256"]
    _assert_bar(want, got)
    assert max(st["width"], st["height"]) <= 352


def test_tables_and_host_copies_equal_reference():
    names = sorted(n for n in vars(ref_tables) if n.isupper())
    assert names == sorted(n for n in vars(port_tables) if n.isupper())
    for n in names:
        np.testing.assert_array_equal(getattr(port_tables, n),
                                      getattr(ref_tables, n))
    for n in ("ZIGZAG", "ALT_HORIZONTAL", "ALT_VERTICAL", "_INTRA_MAXLEV",
              "_INTRA_MAXRUN", "_INTER_MAXLEV", "_INTER_MAXRUN"):
        np.testing.assert_array_equal(getattr(port_mod, n),
                                      getattr(ref_mod, n))
    for n in ("DC_THRESHOLD", "CHROMA_ROUNDTAB", "QUANT_TAB", "H263_FORMATS",
              "_INTRA_MCBPC", "_INTER_MCBPC", "_CBPY", "_MV", "_DC_LUM",
              "_DC_CHROM", "_RL_INTRA", "_RL_INTER"):
        assert getattr(port_mod, n) == getattr(ref_mod, n), n
    rng = np.random.default_rng(2)
    ref = rng.integers(0, 256, (40, 56)).astype(np.uint8)
    for _ in range(60):
        sx, sy = (int(v) for v in rng.integers(-20, 60, 2))
        dxy, rnd = int(rng.integers(0, 4)), int(rng.integers(0, 2))
        for h, w in ((16, 16), (8, 8)):
            np.testing.assert_array_equal(
                port_mod._hpel(ref, sx, sy, dxy, h, w, rnd),
                ref_mod._hpel(ref, sx, sy, dxy, h, w, rnd))
    for a, b, c in rng.integers(-50, 50, (50, 3)).tolist():
        assert port_mod._mid_pred(a, b, c) == ref_mod._mid_pred(a, b, c)
        if c:
            assert port_mod._cdiv(a, abs(c)) == ref_mod._cdiv(a, abs(c))
            assert port_mod._rounded_div(a, abs(c)) == \
                ref_mod._rounded_div(a, abs(c))


def test_device_defaults_and_device_planes():
    import inspect
    assert {"mpeg4", "h263"} <= set(decoder_names())
    for cls in (port_mod.Mpeg4Decoder, port_mod.H263Decoder):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    st = fx.mpeg4_stream("mpeg4_4mv")
    w, h = st["width"], st["height"]
    dec = CodecContext.open_decoder(CodecParameters(
        codec_id=st["codec_id"], extradata=st["extradata"]), device="cpu")
    out = dec.decode_all([Packet(data=p, pts=t) for p, t in
                          zip(st["packets"][:2], st["pts"])])
    assert [f.pict_type for f in out] == st["types"][:2]
    for f in out:
        assert all(isinstance(p, torch.Tensor) and p.device.type == "cpu"
                   and p.dtype == torch.uint8 for p in f.planes)
        assert [tuple(p.shape) for p in f.planes] == \
            [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
