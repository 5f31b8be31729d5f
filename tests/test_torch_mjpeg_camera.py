"""Camera MJPEG (RFC 2435 type 64: 4:2:2, the Annex K Huffman tables, a
restart marker every MCU row) through the port's flagship pipeline on the
CPU, at 256x72 (16 MCUs a row, 9 rows, so 9 segments a frame, whose
lengths do not fill the region's 16-byte header row).

The frames come from the benchmark's RFC 2435 generator
(portbench/inputs/rtpjpeg.py) and the planes are held to its float64
plain reference (portbench/reference/mjpeg422.py); neither imports the
program.  Coefficients are exact.  The rgb24 outputs are held to the
rounding of the reference's values: the widest gap by which a sample
lies outside it must stay under 0.01 of an 8-bit step.  The program
computes in float32, so it misses by ~2e-5; the same reference computed
in TF32 (10 mantissa bits) and put in the program's place misses by
~0.2, and must fail the bound.  Each test takes about a second."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ffmpeg_tpu_torch.codecs.mjpeg import (_JpegState, _parse_until_scan,
                                           scan_decode)
from ffmpeg_tpu_torch.io.mjpeg import split_packets
from ffmpeg_tpu_torch.models import mjpeg_tpu_entropy as model
from ffmpeg_tpu_torch.ops import huffman
from ffmpeg_tpu_torch import testing as fx

from portbench.inputs.rtpjpeg import make_clip
from portbench.reference.mjpeg422 import Mjpeg422Reference
from portbench.reference.scale import to_tf32

REPO = Path(__file__).resolve().parent.parent
W, H, OUT_W, OUT_H, FRAMES = 256, 72, 64, 48, 3
ROW = W // 16                     # MCUs a row, the restart interval
EXCESS_LSB = 0.01


def _texture():
    cfg = json.loads((REPO / "portbench" / "configs"
                      / "rtpjpeg1080_422_rgb224.json").read_text())
    return cfg["luma_texture"], cfg["chroma_texture"]


_CLIP = {}


def _clip():
    if not _CLIP:
        _CLIP["c"] = make_clip(2 ** 33 + 26, W, H, FRAMES, 88, 1,
                               *_texture(), "cpu")
    return _CLIP["c"]


def _pipe(pkts, **kw):
    kw = {"width": W, "height": H, **kw}
    spec = model.TpuEntropySpec(out_w=OUT_W, out_h=OUT_H, batch=len(pkts),
                                stride=2048, **kw)
    pipe = model.MjpegTpuEntropyPipeline(spec, pkts[0], device="cpu")
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    return pipe


def _state(pkt):
    st = _JpegState()
    _parse_until_scan(pkt, st)
    return st


def _excess(rgb: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap of uint8 `rgb` outside the rounding of `want`
    clamped to 0..255, in 8-bit steps."""
    gap = (rgb.double() - want.double().clamp(0, 255)).abs().max()
    return max(0.0, float(gap) - 0.5)


def test_stream_is_rfc2435_type64_with_long_codes():
    c = _clip()
    st = _state(c.packets[0])
    assert [(k.h, k.v) for k in st.components] == [(2, 1), (1, 1), (1, 1)]
    assert st.restart_interval == ROW
    assert st.ac_counts[0][15] == 0x7D          # Annex K luma AC, 16 bits
    assert (c.long_codes > 0).all(), c.long_codes
    stream = _pipe(c.packets[:1])._stream
    assert (stream.sampling, stream.restart_interval, stream.longest,
            stream.two_level, stream.mcus) == ("yuv422p", ROW, 16, True,
                                               (ROW, H // 8))


def test_coefficients_equal_generator_and_host_decoder():
    c = _clip()
    pipe = _pipe(c.packets)
    regions = torch.from_numpy(pipe.regions.copy())
    lens, luts = pipe.program.split_regions(regions)
    assert lens.shape == (FRAMES, H // 8) and luts.dtype == torch.uint8
    got = huffman.jpeg_scan_decode_packed(
        regions, lens, luts, pipe.hdr, mcus_per_seg=ROW, blocks_per_mcu=4,
        nmcu=pipe.nmcu)
    for f, pkt in enumerate(c.packets):
        want = c.frame_coef(f).reshape(-1, 4, 64)
        assert torch.equal(got[f].long(), want)
        y, u, v = scan_decode(pkt).coeffs
        host = np.concatenate([y.reshape(-1, 2, 64), u.reshape(-1, 1, 64),
                               v.reshape(-1, 1, 64)], axis=1)
        assert np.array_equal(got[f].numpy(), host)


def test_planes_match_plain_reference_and_tf32_fails():
    c = _clip()
    got = torch.stack(list(_pipe(c.packets).run_batch()), 1)
    assert got.dtype == torch.uint8 and got.shape == (FRAMES, 3, OUT_H,
                                                      OUT_W)
    ref = Mjpeg422Reference(W, H, OUT_W, OUT_H, c.q_luma, c.q_chroma, "cpu")
    tf32 = Mjpeg422Reference(W, H, OUT_W, OUT_H, c.q_luma, c.q_chroma,
                             "cpu", "tf32")
    worst = 0.0
    for f in range(FRAMES):
        want = ref.rgb(c.frame_coef(f))
        assert _excess(got[f], want) < EXCESS_LSB
        ctrl = torch.floor(tf32.rgb(c.frame_coef(f)) + 0.5).clamp(0, 255)
        worst = max(worst, _excess(ctrl.to(torch.uint8), want))
    assert worst > EXCESS_LSB, worst
    assert torch.equal(to_tf32(torch.tensor([1.0 + 2 ** -11])),
                       torch.tensor([1.0]))


def _patched(pkt: bytes, marker: int, payload: bytes) -> bytes:
    """`pkt` with the payload of its first `marker` segment replaced."""
    i = pkt.index(bytes([0xFF, marker]))
    n = int.from_bytes(pkt[i + 2:i + 4], "big")
    assert len(payload) == n - 2
    return pkt[:i + 4] + payload + pkt[i + 2 + n:]


def _without(pkt: bytes, marker: int) -> bytes:
    i = pkt.index(bytes([0xFF, marker]))
    return pkt[:i] + pkt[i + 4 + int.from_bytes(pkt[i + 2:i + 4], "big")
                         - 2:]


def _sof(pkt: bytes, y: int, c: int) -> bytes:
    i = pkt.index(b"\xff\xc0") + 4
    return _patched(pkt, 0xC0, pkt[i:i + 6] + bytes([1, y, 0, 2, c, 1, 3,
                                                      c, 1]))


@pytest.mark.parametrize("case,match", [
    ("no restart markers", "no restart markers"),
    ("interval not whole rows", "neither 1 nor whole rows"),
    ("4:4:4", "sampling"),
    ("4:1:1", "sampling"),
    ("spec of another size", "spec"),
])
def test_unsupported_streams_raise(case, match):
    pkt = _clip().packets[0]
    kw = {}
    if case == "no restart markers":
        pkt = _without(pkt, 0xDD)
    elif case == "interval not whole rows":
        pkt = _patched(pkt, 0xDD, (ROW + 3).to_bytes(2, "big"))
    elif case == "4:4:4":
        pkt = _sof(pkt, 0x11, 0x11)
    elif case == "4:1:1":
        pkt = _sof(pkt, 0x41, 0x11)
    else:
        kw = {"width": W + 16}
    with pytest.raises(ValueError, match=match):
        _pipe([pkt], **kw)


def test_frame_that_changes_the_stream_raises():
    c = _clip()
    pipe = _pipe(c.packets[:1])
    other = _patched(c.packets[1], 0xDD, (2 * ROW).to_bytes(2, "big"))
    with pytest.raises(ValueError, match="changed mid-stream"):
        pipe.prep_frame(other, 0)
    pkts = split_packets(fx.FIXTURE.read_bytes())[:1]
    spec = model.TpuEntropySpec(fx.W, fx.H, fx.OUT, fx.OUT, batch=1,
                                stride=fx.STRIDE)
    with pytest.raises(ValueError, match="changed mid-stream"):
        model.MjpegTpuEntropyPipeline(spec, pkts[0], device="cpu") \
            .prep_frame(_sof(pkts[0], 0x21, 0x11), 0)


@pytest.mark.parametrize("source", ["annexk_fixture", "flagship_fixture",
                                    "camera"])
def test_two_level_tables_expand_to_the_16_bit_tables(source):
    if source == "camera":
        pkt = _clip().packets[0]
    else:
        path = fx.HUFFMAN_ANNEXK if source == "annexk_fixture" \
            else fx.FIXTURE
        pkt = split_packets(path.read_bytes())[0]
    st = _state(pkt)
    tables = huffman.build_jpeg_tables16(st)
    assert tables.dtype == np.uint8 and tables.shape == (
        huffman.TABLE16_BYTES,)
    np.testing.assert_array_equal(
        huffman.luts16_from_tables(torch.from_numpy(tables)).numpy(),
        huffman.build_jpeg_luts(st))


def test_overfull_table_raises():
    st = _state(_clip().packets[0])
    st.ac_counts[0][1] = 5                       # 5 codes of 2 bits
    with pytest.raises(ValueError, match="overflows"):
        huffman.build_jpeg_tables16(st)


def test_annexk_420_one_mcu_segments_take_the_two_level_tables():
    """The Annex K 4:2:0 fixture, a restart marker every MCU: its codes of
    up to 16 bits send it to the camera format, one MCU of 6 blocks a
    segment, equal to the host decoder.  A stream whose first frame fits
    the flagship's 9 bits keeps the flagship's format, and a later frame
    with longer codes is refused there."""
    pkt = split_packets(fx.HUFFMAN_ANNEXK.read_bytes())[0]
    spec = model.TpuEntropySpec(fx.W, fx.H, fx.OUT, fx.OUT, batch=1,
                                stride=fx.STRIDE)
    pipe = model.MjpegTpuEntropyPipeline(spec, pkt, device="cpu")
    pipe.prep_frame(pkt, 0)
    assert pipe._stream.longest == 16 and pipe._stream.two_level
    assert pipe.nseg == pipe.nmcu
    regions = torch.from_numpy(pipe.regions.copy())
    lens, luts = pipe.program.split_regions(regions)
    got = huffman.jpeg_scan_decode_packed(regions, lens, luts, pipe.hdr,
                                          mcus_per_seg=1, blocks_per_mcu=6)
    np.testing.assert_array_equal(got[0].numpy(), fx.host_decode(pkt))
    first = split_packets(fx.FIXTURE.read_bytes())[0]
    flagship = model.MjpegTpuEntropyPipeline(spec, first, device="cpu")
    assert flagship._stream.longest <= 9 and not flagship._stream.two_level
    with pytest.raises(ValueError, match="longer than 9 bits"):
        flagship.prep_frame(pkt, 0)


@pytest.mark.parametrize("kind", ["flagship", "camera"])
def test_split_regions_gives_the_split_lengths(kind):
    """The program's segment lengths are the split's: the camera format's
    u32le lengths are read in place (a view of the regions, no copy), the
    flagship's u16le ones widened."""
    if kind == "camera":
        pipe = _pipe(_clip().packets)
        assert pipe.tab == 48 and not pipe.regions[:, 36:48].any()
        want = pipe.regions[:, :4 * pipe.nseg].view("<u4")
    else:
        pkts = split_packets(fx.FIXTURE.read_bytes())[:2]
        spec = model.TpuEntropySpec(fx.W, fx.H, fx.OUT, fx.OUT, batch=2,
                                    stride=fx.STRIDE,
                                    packed_cap=fx.packed_cap(pkts))
        pipe = model.MjpegTpuEntropyPipeline(spec, pkts[0], device="cpu")
        for i, p in enumerate(pkts):
            pipe.prep_frame(p, i)
        assert not pipe._stream.two_level
        assert pipe.hdr == 2 * pipe.nmcu + 6144
        want = pipe.regions[:, :2 * pipe.nseg].view("<u2")
    regions = torch.from_numpy(pipe.regions)
    lens, _ = pipe.program.split_regions(regions)
    assert lens.dtype == torch.int32 and lens.shape == want.shape
    np.testing.assert_array_equal(lens.numpy(), want)
    assert (lens.data_ptr() == regions.data_ptr()) == (kind == "camera")
