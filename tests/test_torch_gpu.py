"""The port on the card: its kernels against their plain PyTorch
versions, bit-exact: K1 (ffmpeg_tpu_torch/csrc/jpeg_huffman.cu, both
of its formats: the flagship's and the camera MJPEG of RFC 2435) and K2
(ffmpeg_tpu_torch/csrc/sad_cost_volume.cu); and the PyTorch-only paths
(the MJPEG decoder, the filter graph, build_decode_scale and entry())
against the same code on the CPU and the reference's committed output,
within 1 LSB; the audio frontend's stages against their CPU runs; and
the VP9 decoder and its device loop filter, byte-exact against the CPU
run, the host filter and the reference's committed hashes; the H.264
decoder's transforms, inter prediction and wavefronts against the CPU
run, and its streams against the reference's committed hashes; K2 on
the H.264 encoder's planes, and the encoders' round trips (H.264,
MPEG-2, MJPEG through the flagship pipeline, ProRes, DNxHD) and the
MPEG-4 and H.263 decoders against the CPU; the audio decoders' device
filterbanks (mp3fb, ac3fb) and the MPEG audio, AC-3/E-AC-3 and HE-AAC
decoders on the committed audio streams against the CPU; the video
filters' chains of chip_smoke.py phase 24, their sources, deblock_plane
and apply_lut3d against the CPU; the transforms of the last audio slice
at its sizes, the AAC encoder against the reference's committed packets
and decisions, the Vorbis and Opus streams against the CPU and the
reference's committed PCM, and chip_smoke.py phase 25's audio filter
chains against the CPU and the committed golden; and the CLI
(ffmpeg_tpu_torch.cli.ffmpeg.main on the card) on phase 26's command (b)
at the crafted VP9 stream against the reference CLI's committed text;
the GIF decoder's planes on the card against the CPU decode, and
chip_smoke.py phase 28's command (l) (the flagship over loopback HTTP)
against the same command from the file; the PNG, FFV1 and VP8 decoders'
planes on the card against the CPU decode, and phase 29's command (t)
(the VP8 clip to MPEG-2 through the CLI, K2 once per P frame) against
the CLI on the CPU and the reference's committed sizes; the VVC
decoder on small crafted GOPs (serial and threads=4) against the CPU and
on the committed 10-bit GOP against the reference's sha256, and phase
30's -bsf and AV1 copy commands against the reference CLI's sha256;
and the multi-device layer over mesh positions that are all the card
(sharded_deblock, the sharded VP9 loop filter, sharded_filters and
dryrun_multichip) against the unsharded paths on the card and the CPU.
Marked
`gpu`: they need a CUDA device (and nvcc for the kernels), and skip
without one.  They use no jax, so on a machine with a
card and without jax they run without tests/conftest.py (which imports
jax):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
    MjpegTpuEntropyPipeline, TpuEntropySpec)
from ffmpeg_tpu_torch import entry
from ffmpeg_tpu_torch.codecs import CodecContext, EncoderParameters
from ffmpeg_tpu_torch.codecs.mpeg12_enc import state_from_reference
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.filters import parse_graph
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType
from ffmpeg_tpu_torch.models.mjpeg_pipeline import (DecodeScaleSpec,
                                                    build_decode_scale,
                                                    pack_coeffs)
from ffmpeg_tpu_torch.ops import huffman, me
from ffmpeg_tpu_torch.utils.error import InvalidData
from ffmpeg_tpu_torch import testing as fx

from torch_port_util import fixture_packets

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 and K2 are CUDA kernels)")
    return torch.device("cuda", 0)


def _packed(pkts, w, h, out, stride, cap, device):
    spec = TpuEntropySpec(w, h, out, out, batch=len(pkts), stride=stride,
                          packed_cap=cap)
    pipe = MjpegTpuEntropyPipeline(spec, max(pkts, key=len), device=device)
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    regions = torch.from_numpy(pipe.regions).to(device)
    return (pipe, regions) + pipe.program.split_regions(regions)


def _check_k1(pipe, regions, lens, luts):
    before = huffman.KERNEL_LAUNCHES
    got = huffman.jpeg_scan_decode_packed(regions, lens, luts, pipe.hdr)
    torch.cuda.synchronize()
    assert huffman.KERNEL_LAUNCHES == before + 1
    want = huffman.decode_packed_plain(regions, lens, luts, pipe.hdr)
    assert got.is_cuda and got.dtype == torch.int16
    assert torch.equal(got, want)
    return got


def test_k1_matches_plain_fixture(cuda):
    pkts = fixture_packets()
    _check_k1(*_packed(pkts, fx.W, fx.H, fx.OUT, fx.STRIDE,
                       fx.packed_cap(pkts), cuda))


def test_k1_matches_plain_on_corrupt_bytes_and_padding_lanes(cuda):
    pkts = fixture_packets()[:2]
    pipe, regions, lens, luts = _packed(pkts, fx.W, fx.H, fx.OUT,
                                        fx.STRIDE, fx.packed_cap(pkts), cuda)
    assert not torch.equal(luts[0], luts[1])
    rng = np.random.default_rng(5)
    junk = regions.clone()
    junk[:, pipe.hdr:] = torch.from_numpy(rng.integers(
        0, 256, tuple(junk[:, pipe.hdr:].shape), dtype=np.uint8)).to(cuda)
    lens0 = lens.clone()
    lens0[:, ::5] = 0                         # padding lanes
    _check_k1(pipe, junk, lens0, luts)


def _camera_regions(device, frames, w=1920, h=1080):
    """RFC 2435 type-64 frames of the benchmark's generator (4:2:2, the
    Annex K tables, a restart marker every MCU row), staged by the
    pipeline: (clip, pipeline, regions, lens, tables) on `device`."""
    import json
    from pathlib import Path
    from portbench.inputs.rtpjpeg import make_clip
    cfg = json.loads((Path(__file__).resolve().parent.parent / "portbench"
                      / "configs" / "rtpjpeg1080_422_rgb224.json").read_text())
    clip = make_clip(2 ** 33 + 5, w, h, frames, 88, 1, cfg["luma_texture"],
                     cfg["chroma_texture"], "cpu")
    spec = TpuEntropySpec(w, h, 224, 224, batch=frames,
                          stride=16384 if w == 1920 else 2048)
    pipe = MjpegTpuEntropyPipeline(spec, max(clip.packets, key=len),
                                   device=device)
    for i, p in enumerate(clip.packets):
        pipe.prep_frame(p, i)
    regions = torch.from_numpy(pipe.regions).to(device)
    return (clip, pipe, regions) + pipe.program.split_regions(regions)


def test_k1_camera_matches_generator_and_plain(cuda):
    """The camera format's kernel on 1080p type-64 frames (135 segments
    of 120 MCUs, codes of up to 16 bits): equal to the generator's
    coefficients, and to the plain version on the first frame."""
    clip, pipe, regions, lens, tables = _camera_regions(cuda, 4)
    kw = dict(mcus_per_seg=120, blocks_per_mcu=4, nmcu=pipe.nmcu)
    before = (huffman.KERNEL_LAUNCHES, huffman.ROWS_KERNEL_LAUNCHES)
    got = huffman.jpeg_scan_decode_packed(regions, lens, tables, pipe.hdr,
                                          **kw)
    torch.cuda.synchronize()
    assert (huffman.KERNEL_LAUNCHES, huffman.ROWS_KERNEL_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert got.is_cuda and got.shape == (4, 16200, 4, 64)
    for f in range(4):
        assert torch.equal(got[f].cpu().long(),
                           clip.frame_coef(f).reshape(-1, 4, 64))
    want = huffman.decode_packed_plain(regions[:1].cpu(), lens[:1].cpu(),
                                       tables[:1].cpu(), pipe.hdr, **kw)
    assert torch.equal(got[:1].cpu(), want)


def test_k1_camera_matches_plain_on_corrupt_bytes_and_padding_lanes(cuda):
    clip, pipe, regions, lens, tables = _camera_regions(cuda, 2, 256, 72)
    kw = dict(mcus_per_seg=16, blocks_per_mcu=4, nmcu=pipe.nmcu)
    rng = np.random.default_rng(5)
    junk = regions.clone()
    junk[:, pipe.hdr:] = torch.from_numpy(rng.integers(
        0, 256, tuple(junk[:, pipe.hdr:].shape), dtype=np.uint8)).to(cuda)
    lens0 = lens.clone()
    lens0[:, ::4] = 0                         # padding lanes
    got = huffman.jpeg_scan_decode_packed(junk, lens0, tables, pipe.hdr,
                                          **kw)
    want = huffman.decode_packed_plain(junk.cpu(), lens0.cpu(),
                                       tables.cpu(), pipe.hdr, **kw)
    assert torch.equal(got.cpu(), want)


def test_k1_camera_format_on_annexk_420_one_mcu_segments(cuda):
    """The Annex K 4:2:0 fixture (two 1080p frames, a restart marker
    every MCU, codes of up to 16 bits) takes the camera format with one
    MCU of 6 blocks a segment, 8160 lanes a frame: the camera kernel's
    coefficients equal the plain version's and the C++ host decoder's."""
    from ffmpeg_tpu_torch.io.mjpeg import split_packets
    pkts = split_packets(fx.HUFFMAN_ANNEXK.read_bytes())
    spec = TpuEntropySpec(fx.W, fx.H, fx.OUT, fx.OUT, batch=len(pkts),
                          stride=fx.STRIDE)
    pipe = MjpegTpuEntropyPipeline(spec, max(pkts, key=len), device=cuda)
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    stream = pipe._stream
    assert stream.two_level and stream.bpm == 6 and pipe.nseg == pipe.nmcu
    regions = torch.from_numpy(pipe.regions).to(cuda)
    lens, tables = pipe.program.split_regions(regions)
    kw = dict(mcus_per_seg=1, blocks_per_mcu=6, nmcu=pipe.nmcu)
    before = huffman.ROWS_KERNEL_LAUNCHES
    got = huffman.jpeg_scan_decode_packed(regions, lens, tables, pipe.hdr,
                                          **kw)
    torch.cuda.synchronize()
    assert huffman.ROWS_KERNEL_LAUNCHES == before + 1
    assert got.shape == (len(pkts), 8160, 6, 64)
    want = huffman.decode_packed_plain(regions.cpu(), lens.cpu(),
                                       tables.cpu(), pipe.hdr, **kw)
    assert torch.equal(got.cpu(), want)
    for i, p in enumerate(pkts):
        assert np.array_equal(got[i].cpu().numpy(), fx.host_decode(p))


def test_camera_pipeline_on_card_matches_cpu(cuda):
    """Two 256x72 type-64 frames through prep_frame and run_batch on the
    card and on the CPU: the rgb24 planes within 1 LSB (float32 sums in
    another order before the rounding), on at most 1% of samples."""
    pkts = _camera_regions("cpu", 2, 256, 72)[0].packets
    outs = []
    for dev in (cuda, "cpu"):
        spec = TpuEntropySpec(256, 72, 64, 48, batch=2, stride=2048)
        pipe = MjpegTpuEntropyPipeline(spec, pkts[0], device=dev)
        for i, p in enumerate(pkts):
            pipe.prep_frame(p, i)
        outs.append([c.cpu() for c in pipe.run_batch()])
    for g, w in zip(*outs):
        d = (g.int() - w.int()).abs()
        assert d.max() <= 1 and (d > 0).float().mean() <= 0.01


def test_general_scan_decode_on_card_matches_cpu(cuda):
    """ops/huffman.jpeg_scan_decode on the standard-table fixture's first
    frame: the card's run equals the CPU's on the same inputs, and both
    the C++ host decoder's."""
    from ffmpeg_tpu_torch.io.mjpeg import split_packets
    pkt = split_packets(fx.HUFFMAN_ANNEXK.read_bytes())[0]
    args = fx.general_scan_inputs(pkt, "cpu")
    want = huffman.jpeg_scan_decode(*args)
    got = huffman.jpeg_scan_decode(*(a.to(cuda) for a in args))
    assert got.is_cuda and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(want.numpy(), fx.host_decode(pkt))
    with pytest.raises(ValueError, match="several devices"):
        huffman.jpeg_scan_decode(args[0].to(cuda), *args[1:])


def test_pipeline_on_card_matches_golden(cuda):
    pkts = fixture_packets()
    spec = TpuEntropySpec(fx.W, fx.H, fx.OUT, fx.OUT, batch=8,
                          stride=fx.STRIDE, packed_cap=fx.packed_cap(pkts))
    pipe = MjpegTpuEntropyPipeline(spec, max(pkts, key=len), device=cuda)
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    got = np.stack([c.cpu().numpy() for c in pipe.run_batch()])
    d = np.abs(got.astype(np.int32)
               - np.load(fx.GOLDEN)["planes"].astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


def _k2_planes(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    if kind == "u8":
        return [rng.integers(0, 256, (h, w)).astype(np.uint8)
                for _ in range(2)]
    if kind == "frac":
        cur = rng.integers(0, 256, (h, w)).astype(np.float32)
        ref = np.roll(cur, (3, -5), (0, 1)) + rng.normal(0, 2, (h, w)) - 4
        return [cur, ref.astype(np.float32)]
    return [np.full((h, w), 200, np.uint8)] * 2          # flat: all ties


@pytest.mark.parametrize("h,w,B,R,kind", [
    (1088, 1920, 16, 8, "u8"),      # the encoder's shape
    (1080, 1910, 16, 8, "u8"),      # neither side a multiple of the block
    (1088, 1920, 16, 8, "frac"),    # truncation, negative samples
    (1088, 1920, 16, 8, "flat"),
    (72, 136, 8, 2, "u8"),
    (40, 152, 16, 4, "frac"),
    (64, 96, 32, 16, "u8"),         # the largest block and radius
])
def test_k2_matches_plain(cuda, h, w, B, R, kind):
    cur, ref = (torch.from_numpy(a).to(cuda)
                for a in _k2_planes(kind, h, w, seed=h + w))
    before = me.KERNEL_LAUNCHES
    got = me.sad_cost_volume_strip(cur, ref, B, R)
    torch.cuda.synchronize()
    assert me.KERNEL_LAUNCHES == before + 1
    want = me.sad_cost_volume_strip_plain(cur, ref, B, R)
    assert got.is_cuda and got.dtype == torch.float32
    assert torch.equal(got, want)
    mvs, _ = me.motion_search(cur, ref, B, R)
    if kind == "flat":
        assert bool((mvs == -R).all())


def test_k2_rejects_out_of_range_on_card(cuda):
    cur = torch.zeros((64, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        me.sad_cost_volume_strip(cur, cur, 64, 8)


def test_encoder_on_card_launches_k2_per_p_frame(cuda):
    """I P P through the entry point on the card: one K2 launch per P
    frame; then the fourth frame from the same reference picture on the
    card and on the CPU gives the same MVs."""
    frames = fx.mpeg2_clip(4, 160, 128)
    par = EncoderParameters("mpeg2video", 160, 128)
    opts = {"qscale": 4, "gop_size": 4}
    ctx = CodecContext.open_encoder(par, opts, device=cuda)
    before = me.KERNEL_LAUNCHES
    for f in frames[:3]:
        ctx.send_frame(f)
        assert ctx.receive_packet().data
    assert me.KERNEL_LAUNCHES == before + 2
    cpu = CodecContext.open_encoder(par, opts, device="cpu")
    cpu.codec.load_state(state_from_reference(ctx.codec))
    for c in (ctx, cpu):
        c.send_frame(frames[3])
        assert c.receive_packet().data
    np.testing.assert_array_equal(ctx.codec.last_mv_grid,
                                  cpu.codec.last_mv_grid)


def _within_one_lsb(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())


def _decode(pkts, device):
    ctx = CodecContext.open_decoder(
        CodecParameters(codec_type=MediaType.VIDEO, codec_id="mjpeg"),
        device=device)
    return ctx.decode_all([Packet(data=p, pts=i) for i, p in enumerate(pkts)])


def test_decoder_on_card_matches_cpu(cuda):
    """The MJPEG decoder's planes are CUDA tensors within 1 LSB of the
    same decoder on the CPU."""
    pkts = fixture_packets()[:2]
    got, want = _decode(pkts, cuda), _decode(pkts, "cpu")
    assert [f.pts for f in got] == [0, 1]
    for g, w in zip(got, want):
        assert (g.format, g.color_range) == ("yuv420p", "pc")
        for a, b in zip(g.planes, w.planes):
            assert a.is_cuda and a.dtype == torch.uint8
            _within_one_lsb(a.cpu().numpy(), b.numpy())


def test_graph_on_card_matches_golden_and_cpu(cuda):
    """Decoder -> scale graph on the card against the reference's golden;
    the fused scale+tensornorm against the CPU tensornorm of those planes;
    planes on the CPU refused by a graph on the card."""
    frames = _decode(fixture_packets()[:fx.GRAPH_FRAMES], cuda)
    rgb = parse_graph(fx.GRAPH_TEXT, device=cuda).run(frames)
    got = np.stack([np.stack([p.cpu().numpy() for p in f.planes])
                    for f in rgb], axis=1)
    _within_one_lsb(got, np.load(fx.DECODE_SCALE_GOLDEN)["graph"])
    g = parse_graph(fx.GRAPH_TEXT + ",tensornorm", device=cuda)
    assert [n.filter.name for n in g.nodes] == ["scale+tensornorm"]
    norm = parse_graph("tensornorm", device="cpu").run(
        [f.numpy() for f in rgb])
    for f, n in zip(g.run(frames), norm):
        for a, b in zip(f.planes, n.planes):
            assert a.is_cuda and a.dtype == torch.float32
            assert float((a.cpu() - b).abs().max()) <= 1e-6
    host = frames[0].clone_props()
    host.planes = [p.cpu() for p in frames[0].planes]
    with pytest.raises(InvalidData):
        g.feed(host)


def test_dataloader_graph_on_card_matches_cpu(cuda):
    """benchrows.dataloader_row's graph on batched planes (4 frames of
    64x64 here) on the card, against the same graph on the CPU."""
    text = "scale=56:56:format=rgb24,crop=50:50:3:3," \
        "tensornorm=mean=0.45:std=0.225"
    rng = np.random.default_rng(0)
    planes = [rng.integers(0, 256, s, np.uint8)
              for s in ((4, 64, 64), (4, 32, 32), (4, 32, 32))]
    got = parse_graph(text, device=cuda).run(
        [Frame.video(64, 64, "yuv420p", planes=planes)])[0]
    want = parse_graph(text, device="cpu").run(
        [Frame.video(64, 64, "yuv420p", planes=planes)])[0]
    for a, b in zip(got.planes, want.planes):
        assert a.is_cuda and tuple(a.shape) == (4, 50, 50)
        assert float((a.cpu() - b).abs().max()) <= 1 / (255 * 0.225) + 1e-5


def test_decode_scale_entry_on_card_matches_cpu(cuda):
    """entry() runs on the card by default, within 1 LSB of its CPU run;
    the 1080p auto spec on fixture frame 0 against the golden."""
    fn, args = entry.entry()
    assert all(a.is_cuda for a in args)
    cfn, cargs = entry.entry(device="cpu")
    for a, b in zip(fn(*args), cfn(*cargs)):
        assert a.is_cuda
        _within_one_lsb(a.cpu().numpy(), b.numpy())
    spec = DecodeScaleSpec.auto(fx.W, fx.H, fx.OUT, fx.OUT)
    c = fx.scan_coeffs(fixture_packets()[0], spec.ncoeff)
    out = build_decode_scale(spec)(
        *[torch.from_numpy(pack_coeffs(x[None])).to(cuda) for x in c[:3]],
        *[torch.from_numpy(q).to(cuda) for q in c[3:]])
    _within_one_lsb(np.stack([o.cpu().numpy() for o in out]),
                    np.load(fx.DECODE_SCALE_GOLDEN)["decode_scale"][:, :1])


# --- the audio frontend: tx, the resampler's FIR, decode_frames -----------

@pytest.mark.parametrize("kind,n,inverse", [
    ("mdct", 1024, True), ("mdct", 128, True), ("mdct", 1024, False),
    ("fft", 256, False), ("fft", 4096, True), ("rdft", 256, False),
    ("dct2", 64, False), ("dct4", 64, False)])
def test_tx_on_card_matches_cpu(cuda, kind, n, inverse):
    """Each transform on the card within 1e-5 of full scale of the same
    transform on the CPU (tests/test_torch_tx.py's bound against the
    reference; float32 sums in another order)."""
    from ffmpeg_tpu_torch.ops import tx
    rng = np.random.default_rng(n)
    shape = {"fft": (6, n, 2), "mdct": (6, n if inverse else 2 * n)}.get(
        kind, (6, n))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    want = tx.tx_init(kind, n, inverse, device="cpu")(x)
    got = tx.tx_init(kind, n, inverse, device=cuda)(x.to(cuda))
    assert got.is_cuda and got.dtype == torch.float32
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())
    with pytest.raises(InvalidData):
        tx.tx_init(kind, n, inverse, device=cuda)(x)


@pytest.mark.parametrize("rates", [(48000, 16000), (44100, 48000),
                                   (11025, 96000)])
def test_resampler_on_card_matches_cpu(cuda, rates):
    """The streaming resampler with its FIR on the card, in uneven chunks
    and a flush, within 1e-6 of the same resampler on the CPU."""
    from ffmpeg_tpu_torch.resample.swresample import Resampler
    x = np.random.default_rng(3).uniform(-0.9, 0.9, (2, rates[0] // 2)) \
        .astype(np.float32)
    card, cpu = (Resampler(*rates, 2, device=d) for d in (cuda, "cpu"))
    assert card.bank.is_cuda
    outs = []
    for r in (card, cpu):
        chunks = [r.process(x[:, a:b]) for a, b in
                  ((0, 1000), (1000, 1001), (1001, x.shape[1]))]
        outs.append(np.concatenate(chunks + [r.flush()], axis=1))
    assert isinstance(outs[0], np.ndarray) and outs[0].shape == outs[1].shape
    assert float(np.abs(outs[0] - outs[1]).max()) <= 1e-6


def test_aac_decode_frames_on_card_matches_cpu(cuda):
    """decode_frames on the card (one IMDCT for the 96 long channels of
    the committed clip's first 48 packets) within 1e-5 of the CPU run
    (tests/test_torch_aac.py's bound: the IMDCT's float32 sums in
    another order); host numpy planes."""
    from ffmpeg_tpu_torch.io.adts import read_adts
    par, pkts = read_adts(fx.AAC_CLIP.read_bytes())
    got, want = (CodecContext.open_decoder(par, device=d).decode_frames(
        pkts[:48]) for d in (cuda, "cpu"))
    assert len(got) == len(want) == 48
    for g, w in zip(got, want):
        assert all(isinstance(p, np.ndarray) for p in g.planes)
        assert float(np.abs(g.audio_data - w.audio_data).max()) <= 1e-5


@pytest.mark.parametrize("opts", [None, {"native": False,
                                         "device_recon": True}])
def test_vp9_decoder_on_card_matches_cpu_and_golden(cuda, opts):
    """The committed small crafted VP9 stream (keyframe, three inter
    frames, compound prediction, loop filter on) through
    open_decoder("vp9") on the card, on the C++-parse path and on the
    walker's replay: planes on the card, equal to the port's CPU run and
    to the reference's hashes."""
    from ffmpeg_tpu_torch.io.ivf import read_ivf
    _par, _tb, pkts = read_ivf(fx.VP9_SMALL.read_bytes())
    gold = np.load(fx.VP9_LF_GOLDEN)["small"]
    got = fx.vp9_decode(pkts, cuda, opts)
    want = fx.vp9_decode(pkts, "cpu", opts)
    assert len(got) == len(want) == len(gold)
    for g, w, h in zip(got, want, gold):
        assert all(p.is_cuda for p in g.planes)
        for a, b in zip(g.planes, w.planes):
            assert torch.equal(a.cpu(), b)
        assert [fx.plane_sha256(p) for p in g.planes] == list(h)


def test_vp9_bench_first_frames_on_card_match_golden(cuda):
    """Frames 0-2 of the committed 1920x1080 stream on the card against
    the reference's golden planes."""
    from ffmpeg_tpu_torch.io.ivf import read_ivf
    gold = np.load(fx.VP9_GOLDEN)
    _par, _tb, pkts = read_ivf(fx.VP9_BENCH.read_bytes())
    for i, f in enumerate(fx.vp9_decode(pkts[:3], cuda)):
        for p, w in zip(f.planes, fx.vp9_golden_planes(gold, i)):
            assert p.is_cuda
            np.testing.assert_array_equal(p.cpu().numpy(), w)


def test_vp9_loop_filter_on_card_matches_host(cuda):
    """loopfilter_frame_tpu on the card against the host's
    lf.loopfilter_frame on the pre-filter state of each frame of the
    small crafted stream."""
    import copy
    from ffmpeg_tpu_torch.codecs.vp9 import VP9Core, lf, recon_tpu
    from ffmpeg_tpu_torch.codecs.vp9.lf_tpu import loopfilter_frame_tpu
    from ffmpeg_tpu_torch.io.ivf import read_ivf
    _par, _tb, pkts = read_ivf(fx.VP9_SMALL.read_bytes())
    core = VP9Core(native=True, device=cuda)
    core.capture = []
    for p in pkts:
        core.decode_frame(p.data)
        _h, fs, rec = core.capture[-1]
        recon_tpu.reconstruct(fs, rec, cuda)
        host = copy.copy(fs)
        host.y, host.u, host.v = fs.y.copy(), fs.u.copy(), fs.v.copy()
        lf.loopfilter_frame(host)
        out = loopfilter_frame_tpu(fs, cuda)
        for a, b, t in zip((host.y, host.u, host.v), (fs.y, fs.u, fs.v),
                           out):
            np.testing.assert_array_equal(b, a)
            assert t.is_cuda and np.array_equal(t.cpu().numpy(), a)


def test_vp9_wavefront_on_card_matches_cpu_and_host(cuda):
    """loopfilter_wavefront on the card against its CPU run and the
    host's lf.loopfilter_frame, on the pre-filter state of each frame of
    the small crafted stream (loop filter on)."""
    import copy
    from ffmpeg_tpu_torch.codecs.vp9 import VP9Core, lf, recon_tpu
    from ffmpeg_tpu_torch.codecs.vp9.lf_tpu import _luts
    from ffmpeg_tpu_torch.codecs.vp9.lf_wave import loopfilter_wavefront
    from ffmpeg_tpu_torch.io.ivf import read_ivf
    _par, _tb, pkts = read_ivf(fx.VP9_SMALL.read_bytes())
    core = VP9Core(native=True, device=cuda)
    core.capture = []
    for p in pkts:
        core.decode_frame(p.data)
        h, fs, rec = core.capture[-1]
        recon_tpu.reconstruct(fs, rec, cuda)
        lvl8 = np.zeros((fs.sb_rows * 8, fs.sb_cols * 8), np.int32)
        lvl8[:fs.rows, :fs.cols] = fs.lf_lvl
        pw, ph = fs.cols * 8, fs.rows * 8
        args = (fs.wd_v, fs.wd_h, fs.wd_v_uv, fs.wd_h_uv, lvl8,
                *_luts(h.sharpness), fs.sb_rows, fs.sb_cols,
                (pw >> 2, ph >> 2, pw >> 3, ph >> 3))
        planes = [torch.from_numpy(a.copy()) for a in (fs.y, fs.u, fs.v)]
        got = loopfilter_wavefront(*(a.to(cuda) for a in planes), *args)
        want = loopfilter_wavefront(*planes, *args)
        host = copy.copy(fs)
        host.y, host.u, host.v = fs.y.copy(), fs.u.copy(), fs.v.copy()
        lf.loopfilter_frame(host)
        for g, w, a in zip(got, want, (host.y, host.u, host.v)):
            assert g.is_cuda and torch.equal(g.cpu(), w)
            np.testing.assert_array_equal(w.numpy().astype(np.uint8), a)
        fs.y[:], fs.u[:], fs.v[:] = host.y, host.u, host.v


def test_vp9_windowed_decoder_on_card_matches_cpu_and_golden(cuda):
    """Vp9TpuDecoder on the card over the small crafted stream: planes on
    the card, equal to its CPU run and to the reference's hashes; the
    checksum path equal to the CPU's."""
    from ffmpeg_tpu_torch.io.ivf import read_ivf
    from ffmpeg_tpu_torch.models.vp9_tpu import Vp9TpuDecoder
    _par, _tb, pkts = read_ivf(fx.VP9_SMALL.read_bytes())
    data = [p.data for p in pkts]
    gold = np.load(fx.VP9_LF_GOLDEN)["small"]
    got = Vp9TpuDecoder(device=cuda).decode(data, emit_planes=True)
    want = Vp9TpuDecoder(device="cpu").decode(data, emit_planes=True)
    assert len(got) == len(want) == len(gold)
    for g, w, h in zip(got, want, gold):
        assert all(p.is_cuda for p in g)
        for a, b in zip(g, w):
            assert torch.equal(a.cpu(), b)
        assert [fx.plane_sha256(p) for p in g] == list(h)
    sums = Vp9TpuDecoder(device=cuda).decode(data)
    assert [int(s) for s in sums] == [
        int(s) for s in Vp9TpuDecoder(device="cpu").decode(data)]


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_hevc_residual_transform_on_card_matches_cpu(cuda, bd):
    """recon_tpu's float64 transform products on the card, at every TU
    class and transform kind, extreme coefficients included, equal to
    the CPU's (the reference's int32 matmul has no CUDA counterpart)."""
    from ffmpeg_tpu_torch.codecs.hevc import recon_tpu
    from ffmpeg_tpu_torch.codecs.hevc.recorder import K_DST, K_IDCT, K_TSKIP
    rng = np.random.default_rng(bd)
    for is_luma, n in recon_tpu._CLASSES:
        coef = rng.integers(-32768, 32768, (64, n, n)).astype(np.int32)
        coef[0], coef[1] = 32767, -32768
        kinds = [K_IDCT] + ([K_DST] if is_luma and n == 4 else []) \
            + ([K_TSKIP] if n == 4 else [])
        kind = rng.choice(kinds, 64).astype(np.int32)
        args = (n, is_luma, bd, frozenset(kinds))
        want = recon_tpu._residual_blocks(torch.from_numpy(coef),
                                          torch.from_numpy(kind), *args)
        got = recon_tpu._residual_blocks(torch.from_numpy(coef).to(cuda),
                                         torch.from_numpy(kind).to(cuda),
                                         *args)
        assert got.is_cuda and torch.equal(got.cpu(), want)


def test_hevc_decoder_on_card_matches_cpu_and_golden(cuda):
    """The small crafted I P B stream (SAO, deblocking, reordering) on
    both paths, and frames 0-1 of the 1920x1080 bench stream, through
    open_decoder("hevc") on the card: planes on the card, equal to the
    CPU run and to the reference's hashes."""
    gold = np.load(fx.HEVC_GOLDEN)
    data = fx.HEVC_SMALL.read_bytes()
    want = fx.hevc_decode(data, "cpu")
    for opts in (None, {"device_recon": False}):
        got = fx.hevc_decode(data, cuda, opts)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert all(p.is_cuda for p in g.planes)
            assert all(torch.equal(a.cpu(), b)
                       for a, b in zip(g.planes, w.planes))
        assert [[fx.plane_sha256(p) for p in f.planes] for f in got] == \
            gold["small"].tolist()
    # frames 0-1 of the bench stream
    pics = fx.hevc_pictures(fx.HEVC_BENCH.read_bytes())
    got = fx.hevc_decode(b"".join(pics[:2]), cuda)
    assert [[fx.plane_sha256(p) for p in f.planes] for f in got] == \
        gold["bench"][:2].tolist()


def test_h264_transforms_on_card_match_cpu(cuda):
    """The 4x4 and 8x8 residual butterflies at the int16 extremes."""
    from ffmpeg_tpu_torch.codecs.h264 import recon_tpu
    rng = np.random.default_rng(5)
    ext = np.array([-32768, 32767, -32767, 0, 1, -1], np.int32)
    for fn, n in ((recon_tpu._idct_blocks, 16),
                  (recon_tpu._idct8_blocks, 64)):
        c = torch.from_numpy(rng.choice(ext, (512, n)).astype(np.int32))
        got = fn(c.to(cuda))
        assert got.is_cuda and torch.equal(got.cpu(), fn(c))


def test_h264_inter_on_card_matches_cpu(cuda):
    """The half-pel planes and the luma and chroma gathers over two
    references, every quarter-pel phase, MVs reaching past the edges."""
    from ffmpeg_tpu_torch.codecs.h264 import recon_tpu as R
    rng = np.random.default_rng(11)
    n4y, n4x = 12, 16
    g = torch.from_numpy(rng.integers(0, 256, (2, 48, 64)).astype(
        np.int32))
    c = torch.from_numpy(rng.integers(0, 256, (2, 24, 32)).astype(
        np.int32))
    mv = torch.from_numpy(rng.integers(-160, 160, (2, n4y, n4x, 2))
                          .astype(np.int32))
    slot = torch.from_numpy(rng.integers(-1, 2, (2, n4y, n4x)).astype(
        np.int32))

    def run(dev):
        st = R._halfpel_planes(R._pad_replicate(g.to(dev), R._PAD))
        cp = R._pad_replicate(c.to(dev), R._PAD_C)
        return [R._inter_luma(st, mv.to(dev), slot.to(dev), 0),
                R._inter_luma(st, mv.to(dev), slot.to(dev), 1),
                R._inter_chroma(cp, mv.to(dev), slot.to(dev), 1)]
    for a, b in zip(run(cuda), run("cpu")):
        assert a.is_cuda and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("key", ["small", "truncated"])
def test_h264_decoder_on_card_matches_cpu_and_golden(cuda, key):
    """The small crafted stream (I_4x4, I_PCM, I_16x16, P, B, two
    references, deblocking: both wavefronts) and the truncated-slice
    stream (concealment) through open_decoder("h264") on the card, both
    paths: planes on the card, equal to the CPU run and the golden."""
    gold = np.load(fx.H264_GOLDEN)
    data = fx.H264_SMALL.read_bytes() if key == "small" else \
        gold["truncated_stream"].tobytes()
    want = fx.h264_decode(data, "cpu")
    for opts in (None, {"recon": "host"}):
        got = fx.h264_decode(data, cuda, opts)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert all(p.is_cuda for p in g.planes)
            assert all(torch.equal(a.cpu(), b)
                       for a, b in zip(g.planes, w.planes))
        assert [[fx.plane_sha256(p) for p in f.planes] for f in got] == \
            gold[key].tolist()


def test_h264_1080p_on_card_matches_golden(cuda):
    """The crafted 1920x1088 I P B CABAC stream with deblocking on the
    card against the reference's hashes."""
    gold = np.load(fx.H264_GOLDEN)
    stats = []
    got = fx.h264_decode(fx.H264_CABAC.read_bytes(), cuda, None, stats)
    assert all(p.is_cuda for f in got for p in f.planes)
    assert [[fx.plane_sha256(p) for p in f.planes] for f in got] == \
        gold["cabac_1080p"].tolist()
    assert [s["slice_type"] for s in stats] == [2, 0, 1]


def test_k2_on_h264_encoder_planes_matches_plain(cuda):
    """K2 on what the H.264 encoder uploads: the padded 1088x1920 uint8
    luma of clip frames 1 and 0, B=16, R=8, against its plain version."""
    frames = fx.mpeg2_clip(2, fx.W, fx.H)
    cur, ref = (torch.from_numpy(np.pad(np.asarray(f.planes[0]),
                                        ((0, 8), (0, 0)), mode="edge"))
                .to(cuda) for f in frames[::-1])
    got = me.sad_cost_volume_strip(cur, ref, 16, 8)
    assert torch.equal(got, me.sad_cost_volume_strip_plain(cur, ref, 16, 8))


def _encode_all(ctx, frames):
    out = []
    for f in frames:
        ctx.send_frame(f)
        out.append(ctx.receive_packet().data)
    return out


def test_h264_round_trip_on_card_matches_cpu(cuda):
    """I P P at 200x120 (padded to 208x128 for the search) on the card:
    one K2 launch per P frame, packets byte-identical to the CPU's, and
    open_decoder("h264") on the card gives the encoder's reconstruction."""
    frames = fx.mpeg2_clip(3, 200, 120)
    par = EncoderParameters("h264", 200, 120)
    card = CodecContext.open_encoder(par, device=cuda)
    before = me.KERNEL_LAUNCHES
    got = _encode_all(card, frames)
    assert me.KERNEL_LAUNCHES == before + 2
    assert got == _encode_all(CodecContext.open_encoder(par, device="cpu"),
                              frames)
    dec = fx.h264_decode(b"".join(got), cuda)
    assert len(dec) == 3 and all(p.is_cuda for p in dec[2].planes)
    for p, r in zip(dec[2].planes, card.codec._recon):
        np.testing.assert_array_equal(p.cpu().numpy(), r[:p.shape[0],
                                                          :p.shape[1]])


def test_mpeg2_round_trip_on_card_matches_cpu(cuda):
    """The MPEG-2 encoder's I P P P at 200x120 on the card, decoded by
    open_decoder("mpeg2video") on the card and on the CPU: I pictures
    within 1 LSB on <= 1% of samples, every picture >= 60 dB."""
    frames = fx.mpeg2_clip(4, 200, 120)
    pkts = _encode_all(CodecContext.open_encoder(
        EncoderParameters("mpeg2video", 200, 120), {"qscale": 6},
        device=cuda), frames)

    def dec(device):
        return CodecContext.open_decoder(
            CodecParameters(codec_id="mpeg2video"), device=device) \
            .decode_all([Packet(data=p, pts=i) for i, p in enumerate(pkts)])
    got, want = dec(cuda), dec("cpu")
    assert [f.pict_type for f in got] == ["I", "P", "P", "P"]
    for g, w in zip(got, want):
        for a, b in zip(g.planes, w.planes):
            assert a.is_cuda
            a, b = a.cpu().numpy(), b.numpy()
            if g.pict_type == "I":
                _within_one_lsb(a, b)
            d = (a.astype(np.float64) - b) ** 2
            assert d.mean() == 0 or 10 * np.log10(255 ** 2 / d.mean()) >= 60


def test_mjpeg_round_trip_on_card_matches_cpu(cuda):
    """The MJPEG encoder with the flagship's options at 320x176 on the
    card: coefficients within one step of the CPU's on <= 1e-3 of
    positions; its packets through the flagship pipeline (K1) on the card
    within 1 LSB of the pipeline on the CPU."""
    frames = fx.mpeg2_clip(2, 320, 176)
    par = EncoderParameters("mjpeg", 320, 176)
    card = CodecContext.open_encoder(par, dict(fx.MJPEG_ENC_OPTIONS),
                                     device=cuda)
    cpu = CodecContext.open_encoder(par, dict(fx.MJPEG_ENC_OPTIONS),
                                    device="cpu")
    for f in frames:
        for a, b in zip(card.codec.transform(f)[0],
                        cpu.codec.transform(f)[0]):
            d = np.abs(a.astype(np.int64) - b)
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    pkts = _encode_all(card, frames)
    before = huffman.KERNEL_LAUNCHES
    got = fx.mjpeg_pipeline_rgb(pkts, cuda, 320, 176)
    assert huffman.KERNEL_LAUNCHES == before + 1
    _within_one_lsb(got, fx.mjpeg_pipeline_rgb(pkts, "cpu", 320, 176))


@pytest.mark.parametrize("codec", ["prores", "dnxhd"])
def test_intra_round_trip_on_card_matches_cpu(cuda, codec):
    """The ProRes or DNxHD encoder at 200x120 (10-bit 4:2:2) on the card:
    levels within one step of the CPU's, each difference on a tie or
    boundary that float32 cannot decide; its packet decoded on the card
    within 1 LSB on <= 1% of samples of the same parse's device stage on
    the CPU, at >= 60 dB."""
    import importlib
    src = fx.intra_clip_frame(200, 120)
    par = CodecParameters(codec_id=codec, width=200, height=120,
                          pix_fmt="yuv422p10le")
    card = CodecContext.open_encoder(par, device=cuda)
    cpu = CodecContext.open_encoder(par, device="cpu")
    r = fx.intra_levels_check(card.codec, cpu.codec, src)
    assert r["step"] <= 1 and r["off"] == 0, r
    card.send_frame(src)
    pkt = card.receive_packet()
    dec = CodecContext.open_decoder(CodecParameters(
        codec_id=codec, codec_tag=par.codec_tag), device=cuda)
    got = dec.decode_all([pkt])[0]
    mod = importlib.import_module(f"ffmpeg_tpu_torch.codecs.{codec}")
    want = mod.reconstruct(dec.codec.last_parsed, "cpu")
    for a, b in zip(got.planes, want):
        assert a.is_cuda
        a, b = a.cpu().numpy().astype(np.int32), b.numpy().astype(np.int32)
        d = np.abs(a - b)
        assert d.max() <= 1 and (d > 0).mean() <= 0.01
        mse = (d.astype(np.float64) ** 2).mean()
        assert mse == 0 or 10 * np.log10(1023 ** 2 / mse) >= 60
    assert min(fx.plane_psnr(got.planes, src.planes, 10)) > 45


@pytest.mark.parametrize("name", fx.MPEG4_STREAM_NAMES)
def test_mpeg4_streams_on_card_match_cpu(cuda, name):
    """The committed MPEG-4 and H.263 streams through their decoders on
    the card and on the CPU: I pictures within 1 LSB on <= 1% of
    samples, every picture >= 60 dB, planes on the card."""
    st = fx.mpeg4_stream(name)

    def dec(device):
        return CodecContext.open_decoder(CodecParameters(
            codec_id=st["codec_id"], extradata=st["extradata"]),
            device=device).decode_all([Packet(data=p, pts=t) for p, t in
                                       zip(st["packets"], st["pts"])])
    got, want = dec(cuda), dec("cpu")
    assert [f.pict_type for f in got] == st["types"]
    for g, w in zip(got, want):
        for a, b in zip(g.planes, w.planes):
            assert a.is_cuda
            a, b = a.cpu().numpy(), b.numpy()
            if g.pict_type == "I":
                _within_one_lsb(a, b)
            d = (a.astype(np.float64) - b) ** 2
            assert d.mean() == 0 or 10 * np.log10(255 ** 2 / d.mean()) >= 60



# --- the audio decoders: mp3fb, ac3fb, the committed streams --------------

def test_mp3fb_on_card_matches_cpu(cuda):
    """The packet forms of the MP3 filterbank on the card, two packets in
    a row with the overlap and FIFO carried on the card, within 1e-5 of
    the largest magnitude of the CPU run (phase 12's bound for tx.imdct:
    float32 sums in another order); block types 0-3 and mixed blocks."""
    from ffmpeg_tpu_torch.ops import mp3fb
    rng = np.random.default_rng(23)
    state = {d: (torch.zeros(2, 32, 18, device=d),
                 torch.zeros(2, 16, 64, device=d)) for d in (cuda, "cpu")}
    for _ in range(2):
        xr = torch.from_numpy((rng.standard_normal((2, 2, 32, 18)) * 0.05)
                              .astype(np.float32))
        bt = torch.from_numpy(rng.integers(0, 4, (2, 2, 32)).astype(np.int32))
        bt[0, 0, :2] = 0
        out = {}
        for d in (cuda, "cpu"):
            sb, ov = mp3fb.imdct_packet(xr.to(d), bt.to(d), state[d][0])
            pcm, fifo = mp3fb.synth_packet(sb, state[d][1])
            state[d] = ov, fifo
            out[d] = pcm
        assert out[cuda].is_cuda and state[cuda][1].is_cuda
        want = out["cpu"]
        assert float((out[cuda].cpu() - want).abs().max()) <= \
            1e-5 * float(want.abs().max())


def test_ac3fb_on_card_matches_cpu(cuda):
    """ac3fb.frame on the card (6 blocks of 5.1, some switched, the LFE
    never) within 1e-5 of the largest magnitude of the CPU run, the delay
    carried over two frames on the card (phase 12's bound for tx.imdct:
    float32 sums in another order)."""
    from ffmpeg_tpu_torch.ops import ac3fb
    rng = np.random.default_rng(24)
    delay = {d: torch.zeros(6, 128, device=d) for d in (cuda, "cpu")}
    for _ in range(2):
        xf = torch.from_numpy((rng.standard_normal((6, 6, 256)) * 0.1)
                              .astype(np.float32))
        sw = rng.random((6, 6)) < 0.3
        sw[:, 5] = False
        out = {}
        for d in (cuda, "cpu"):
            out[d], delay[d] = ac3fb.frame(xf.to(d), sw, delay[d])
        assert out[cuda].is_cuda and delay[cuda].is_cuda
        assert float((out[cuda].cpu() - out["cpu"]).abs().max()) <= \
            1e-5 * float(out["cpu"].abs().max())


@pytest.mark.parametrize("name", fx.AUDIO_STREAM_NAMES)
def test_audio_streams_on_card_match_cpu(cuda, name):
    """Each committed audio stream through its decoder on the card and on
    the CPU, within the stream's bar (testing.audio_bar), and its first
    packets against the reference's committed PCM; host numpy planes."""
    st = fx.audio_stream(name)
    got, want = fx.audio_decode(st, cuda), fx.audio_decode(st, "cpu")
    assert len(got) == len(want) == len(st["packets"])
    assert all(isinstance(p, np.ndarray) for f in got for p in f.planes)
    tol, snr = fx.audio_bar(name)
    a, b = fx.audio_pcm(got), fx.audio_pcm(want)
    peak = max(1.0, float(np.abs(b).max()))
    assert tol is None or float(np.abs(a - b).max()) <= tol * peak
    assert fx.snr_db(a, b) >= snr
    n = fx.AUDIO_PREFIX_PACKETS
    pre = np.concatenate([f.audio_data for f in got[:n]], axis=1)
    assert fx.snr_db(pre, st["prefix"]) >= snr


def _filter_bar(got, want, bar):
    """Two runs' frames: props exact, planes under the chain's bar."""
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.pts, a.width, a.height, a.format) == \
            (b.pts, b.width, b.height, b.format)
        for x, y in zip(a.numpy().planes, b.numpy().planes):
            assert x.dtype == y.dtype and x.shape == y.shape
            d = np.abs(x.astype(np.float64) - y.astype(np.float64))
            if bar == "exact":
                assert d.max() == 0
            elif bar == "lsb":
                assert d.max() <= 1 and (d > 0).mean() <= 0.01
            else:
                assert d.max() <= 1e-6 * max(1.0, float(np.abs(y).max()))


@pytest.mark.parametrize("name", [c.name for c in fx.FILTER_CHAINS])
def test_filter_chains_on_card_match_cpu(cuda, name):
    """Each module's filters (chip_smoke.py phase 24's chains) through
    parse_graph on the card at 256x144 against the same graph on the CPU,
    under the chain's bar; the planes on the card; the metric scores
    within 1e-9 relative."""
    chain = next(c for c in fx.FILTER_CHAINS if c.name == name)
    feeds = fx.filter_chain_inputs(chain, 256, 144)
    g = parse_graph(chain.graph_text(), device=cuda)
    got = fx.run_graph(g, feeds, chain.outs, chain.eof_early)
    gc = parse_graph(chain.graph_text(), device="cpu")
    want = fx.run_graph(gc, feeds, chain.outs, chain.eof_early)
    for o in chain.outs:
        assert all(p.is_cuda for f in got[o] for p in f.planes)
        _filter_bar(got[o], want[o], chain.bar)
    for k, sc in fx.chain_scores(g, chain).items():
        ref = fx.chain_scores(gc, chain)[k]
        assert all(abs(a - b) <= 1e-9 * abs(b) for a, b in zip(sc, ref))


@pytest.mark.parametrize("name,args,n,bar", fx.FILTER_SOURCES,
                         ids=[s[0] for s in fx.FILTER_SOURCES])
def test_filter_sources_on_card_match_cpu(cuda, name, args, n, bar):
    from ffmpeg_tpu_torch.filters import get_filter
    a = ":".join(x for x in (args, "size=256x144") if x)
    made = []
    for d in (cuda, torch.device("cpu")):
        src = get_filter(name)(a)
        src.device = d
        made.append(list(src.generate(n)))
    assert all(p.is_cuda for f in made[0] for p in f.planes)
    _filter_bar(made[0], made[1], bar)


def test_deblock_and_lut3d_on_card_match_cpu(cuda):
    from ffmpeg_tpu_torch.ops.deblock import deblock_plane
    from ffmpeg_tpu_torch.scale.lut3d import apply_lut3d, parse_cube
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(0, 256, (2, 144, 256), np.uint8))
    got = deblock_plane(x.to(cuda), qp=45, block=8)
    assert got.is_cuda
    assert torch.equal(got.cpu(), deblock_plane(x, qp=45, block=8))
    lut = torch.from_numpy(parse_cube(fx.cube_text())[0])
    rgb = torch.from_numpy(rng.random((144, 256, 3)).astype(np.float32))
    for method in ("tetrahedral", "trilinear"):
        a = apply_lut3d(rgb.to(cuda), lut.to(cuda), method)
        assert a.is_cuda
        assert torch.equal(a.cpu(), apply_lut3d(rgb, lut, method))


# --- the rest of the audio: AAC encoder, Vorbis, Opus, audio filters ------

@pytest.mark.parametrize("kind,n,scale", [
    ("mdct", 1024, 1.0), ("imdct", 1024, 1.0 / 512 / 65536),
    ("imdct", 1024, 1.0), ("imdct", 128, 1.0), ("imdct", 120, 1 / 32768),
    ("imdct", 240, 1 / 32768), ("imdct", 480, 1 / 32768),
    ("imdct", 960, 1 / 32768)])
def test_audio_codec_transforms_on_card_match_cpu(cuda, kind, n, scale):
    """tx.mdct / tx.imdct at the slice's sizes and scales (the AAC
    encoder, Vorbis, CELT) on a batch on the card, within 1e-5 of the CPU
    run's largest magnitude (phase 12's bound: float32 sums in another
    order)."""
    from ffmpeg_tpu_torch.ops import tx
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal(
        (16, 2 * n if kind == "mdct" else n)).astype(np.float32))
    fn = getattr(tx, kind)
    got, want = fn(x.to(cuda), n, scale), fn(x, n, scale)
    assert got.is_cuda
    assert float((got.cpu() - want).abs().max()) <= \
        1e-5 * float(want.abs().max())


@pytest.mark.parametrize("name", fx.AAC_CHIP_CASES)
def test_aac_encoder_on_card_matches_reference(cuda, name):
    """The AAC encoder on the card against the reference's committed
    packets, decisions and decode SNR (testing.aac_check's bar)."""
    r = fx.aac_check(name, cuda)
    assert r["packets"] == len(np.load(fx.AUDIO_CODECS)[f"{name}_sizes"])


@pytest.mark.parametrize("name", fx.CODEC_STREAM_NAMES)
def test_codec_streams_on_card_match_cpu(cuda, name):
    """Each committed Vorbis and Opus stream through open_decoder on the
    card and on the CPU, within testing.audio_bar's bar, and its first
    packets against the reference's committed PCM."""
    st = fx.codec_stream(name)
    a = np.concatenate([f.audio_data for f in fx.codec_decode(st, cuda)], 1)
    b = np.concatenate([f.audio_data for f in fx.codec_decode(st, "cpu")], 1)
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= fx.AUDIO_DECODE_TOL
    assert fx.snr_db(a, b) >= fx.AUDIO_DECODE_MIN_SNR
    pre = np.concatenate([f.audio_data for f in fx.codec_decode(
        st, cuda, n=fx.CODEC_PREFIX_PACKETS)], 1)
    assert pre.shape == st["prefix"].shape
    assert float(np.abs(pre - st["prefix"]).max()) <= fx.AUDIO_DECODE_TOL
    assert fx.snr_db(pre, st["prefix"]) >= fx.AUDIO_DECODE_MIN_SNR


@pytest.mark.parametrize("name", list(fx.AUDIO_CHAINS))
def test_audio_chains_on_card_match_golden(cuda, name):
    """Each audio filter module's chain through parse_graph on the card
    (its final aresample's FIR there) against the CPU graph and the
    committed golden, within 1e-5 of full scale (the FIR's float32
    sums); the host filters alone bit-equal to the golden's sha256."""
    z = np.load(fx.AUDIO_CODECS)
    inputs = fx.audio_chain_inputs()
    host = fx.run_audio_chain(lambda t: parse_graph(t, device=cuda), name,
                              inputs, resample=False)
    fx.audio_chain_host_check(host, z, name)
    got = fx.run_audio_chain(lambda t: parse_graph(t, device=cuda), name,
                             inputs)
    cpu = fx.run_audio_chain(lambda t: parse_graph(t, device="cpu"), name,
                             inputs)
    for ref in (cpu, z[f"chain_{name}"]):
        assert got.shape == ref.shape
        assert float(np.abs(got - ref).max()) <= 1e-5


def test_cli_vp9_framemd5_on_card_matches_reference(cuda, tmp_path):
    """Command (b) of chip_smoke.py's phase 26 on the crafted 96x72 VP9
    stream: demux, decode on the card, the rawvideo encoder's one copy
    to the host, framemd5, equal to the reference CLI's text."""
    import json
    from ffmpeg_tpu_torch.cli.ffmpeg import main
    argv = [str(fx.VP9_SMALL) if a == str(fx.VP9_BENCH) else a
            for a in fx.cli_commands(tmp_path)["b"]]
    assert main(argv, device=cuda) == 0
    assert (tmp_path / "out_vp9.md5").read_text() == json.loads(
        fx.CLI_GOLDEN.read_text())["b_small_framemd5"]


@pytest.mark.parametrize("name", ["vorbis_noise", "celt_sine",
                                  "hybrid_cfg13"])
def test_cli_ogg_on_card_matches_golden_and_direct_decode(cuda, tmp_path,
                                                          name):
    """Command (j) of chip_smoke.py's phase 27 on one Ogg file: demux,
    decode on the card, f32le; the reference CLI's sample count and
    open_decoder's samples on the same packets on the card within the
    audio bar."""
    import json
    from ffmpeg_tpu_torch.cli.ffmpeg import main
    fx.write_cli_ogg(tmp_path)
    assert main(fx.cli_container_commands(tmp_path)[f"j_{name}"],
                device=cuda) == 0
    st = fx.codec_stream(name)
    got = np.fromfile(tmp_path / f"{name}.f32", np.float32).reshape(
        -1, st["channels"]).T
    assert got.shape[1] == json.loads(fx.CLI_GOLDEN.read_text())[
        "j_samples"][name]
    want = np.concatenate([f.audio_data for f in fx.codec_decode(st, cuda)],
                          1)
    n = min(got.shape[1], want.shape[1])
    assert np.abs(got[:, :n] - want[:, :n]).max() <= fx.AUDIO_DECODE_TOL
    assert fx.snr_db(got[:, :n], want[:, :n]) >= fx.AUDIO_DECODE_MIN_SNR


def test_cli_ts_and_avi_remux_and_decode_on_card(cuda, tmp_path):
    """Commands (g) and (i) of phase 27 at small size: the crafted H.264
    stream copied into MPEG-TS and the MJPEG fixture's first frames into
    AVI, each decoded on the card from the new container to framemd5,
    equal to the same decode from the source file."""
    from ffmpeg_tpu_torch.cli.ffmpeg import main
    for src, ext, extra in ((fx.H264_SMALL, "ts", []),
                            (fx.FIXTURE, "avi", ["-frames:v", "2"])):
        box = tmp_path / f"o.{ext}"
        assert main(["-i", str(src), *extra, "-c", "copy", str(box)],
                    device=cuda) == 0
        md5 = []
        for inp in (src, box):
            out = tmp_path / f"{inp.name}.md5"
            assert main(["-i", str(inp), "-frames:v", "2", "-f",
                         "framemd5", str(out)], device=cuda) == 0
            md5.append([ln.rsplit(",", 1)[1] for ln in out.read_text()
                        .splitlines() if ln and not ln.startswith("#")])
        assert md5[0] == md5[1] and len(md5[0]) == 2


def test_gif_decode_on_card_matches_cpu(cuda):
    """The committed GIF of the reference binary (testing.HOST_GIF)
    through open_decoder("gif") on the card: rgba planes on the card,
    equal to the CPU decode."""
    import io
    from ffmpeg_tpu_torch.io import open_input
    data = fx.host_codec_file(fx.HOST_GIF)
    out = []
    for dev in (cuda, "cpu"):
        d = open_input(io.BytesIO(data))
        ctx = CodecContext.open_decoder(d.streams[0].codecpar, device=dev)
        out.append(ctx.decode_all(list(d.packets())))
    assert len(out[0]) == len(out[1]) == 4
    for g, w in zip(*out):
        assert all(p.device.type == "cuda" for p in g.planes)
        for a, b in zip(g.planes, w.planes):
            assert torch.equal(a.cpu(), b)


def test_cli_over_http_on_card_matches_the_file(cuda, tmp_path):
    """Command (l) of chip_smoke.py's phase 28 at two frames: the
    flagship fixture read over a loopback HTTP server and scaled on the
    card, byte-equal to the same command on the file."""
    from ffmpeg_tpu_torch.cli.ffmpeg import main
    srv, th, base = fx.serve_http(fx.DATA.parent)
    try:
        outs = []
        for i, src in enumerate((f"{base}/port/{fx.FIXTURE.name}",
                                 str(fx.FIXTURE))):
            out = tmp_path / f"o{i}.rgb"
            assert main(["-i", src, "-frames:v", "2", "-vf", "scale=224:224",
                         "-pix_fmt", "rgb24", "-f", "rawvideo", str(out)],
                        device=cuda) == 0
            outs.append(out.read_bytes())
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(10)
    assert outs[0] == outs[1] and len(outs[0]) == 2 * 224 * 224 * 3


def _decode_on(dev, data: bytes):
    import io
    from ffmpeg_tpu_torch.io import open_input
    d = open_input(io.BytesIO(data))
    return CodecContext.open_decoder(d.streams[0].codecpar, device=dev
                                     ).decode_all(list(d.packets()))


@pytest.mark.parametrize("name", ["png_rgb24", "png_rgba", "png_gray16be",
                                  "png_rgb48be", "ffv1_gop6",
                                  "ffv1_444p16-slices",
                                  "ffv1_yuva444p10le", "vp8_inter_0",
                                  "vp8_inter_golden_altref", "vp8_kf_lf40"])
def test_image_and_video_decoders_on_card_match_cpu(cuda, name):
    """The committed PNG, FFV1 and VP8 streams
    (testing.IMAGE_CODECS) through open_decoder on the card: every plane
    on the card, equal to the CPU decode, and the pictures' bytes those
    of the reference binary's decode."""
    import hashlib
    data = fx.image_stream(name)
    got, want = (_decode_on(dev, data) for dev in (cuda, "cpu"))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.format == w.format
        assert all(p.device.type == "cuda" for p in g.planes)
        for a, b in zip(g.planes, w.planes):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    raw = b"".join(f.to_bytes() for f in got)
    assert hashlib.sha256(raw).hexdigest() == fx.image_golden(name)


def test_cli_vp8_to_mpeg2_on_card_launches_k2(cuda, tmp_path):
    """Phase 29's command (t): the committed 640x352 VP8 clip to MPEG-2
    through the CLI on the card, K2 launched once per P frame, the
    packets' sizes within 1% of the same command's on the CPU (the
    motion search's plain version) and of the reference's committed
    sizes."""
    import json
    from ffmpeg_tpu_torch.cli.ffmpeg import main
    from ffmpeg_tpu_torch.io import open_input
    src = tmp_path / "vp8.ivf"
    src.write_bytes(fx.image_stream("vp8_clip"))
    outs = []
    for dev in (cuda, "cpu"):
        out = tmp_path / f"o_{torch.device(dev).type}.mkv"
        me.KERNEL_LAUNCHES = 0
        assert main(["-i", str(src), "-c:v", "mpeg2video", str(out)],
                    device=dev) == 0
        d = open_input(str(out))
        outs.append(([p.data for p in d.packets()], me.KERNEL_LAUNCHES))
        d.close()
    (got, k2), (want, k2_cpu) = outs
    assert k2 == len(got) - 1 == 3 and k2_cpu == 0
    sizes = json.loads(fx.CLI_GOLDEN.read_text())["t_m2v_packet_bytes"]
    for ref in (sizes, [len(x) for x in want]):
        assert len(ref) == len(got)
        assert max(abs(len(a) / b - 1) for a, b in zip(got, ref)) <= 0.01


@pytest.mark.parametrize("gop", [(20, "IPBB", 96, 64, {"stop_p": 0.5},
                                  {"mtt_depth_inter": 2,
                                   "mtt_depth_intra": 2, "nrefs": (2, 2)}),
                                 (18, "IPBB", 64, 64, {"amp": 40},
                                  {"bit_depth": 10, "nrefs": (2, 2)})])
def test_vvc_gops_on_card_match_cpu(cuda, gop):
    """Small GOPs crafted by the port's own writer (testing.craft_vvc, the
    recipe of the reference's tests): open_decoder("vvc") on the card,
    serial and with threads=4, every plane on the card and equal to the
    CPU decode (8-bit and 10-bit)."""
    from ffmpeg_tpu_torch.codecs.vvc import craft
    from ffmpeg_tpu_torch.codecs.vvc.ctu import Plan
    seed, kinds, w, h, plan_kw, kw = gop
    data = fx.craft_vvc(craft, Plan, seed, kinds, w, h, plan_kw, **kw)
    outs = []
    for dev, threads in ((cuda, 1), (cuda, 4), ("cpu", 1)):
        outs.append(CodecContext.open_decoder(
            CodecParameters(codec_id="vvc"), {"threads": threads},
            device=dev).decode_all([Packet(data=data, pts=0)]))
    assert len(outs[0]) == len(kinds)
    for a, b, c in zip(*outs):
        assert all(p.device.type == "cuda" for p in a.planes + b.planes)
        for x, y, z in zip(a.planes, b.planes, c.planes):
            assert torch.equal(x, y) and torch.equal(x.cpu(), z)


def test_committed_vvc_gop_on_card_matches_reference(cuda):
    """The committed 416x240 10-bit GOP (phase 30 (y)) on the card: the
    reference decoder's sha256, uint16 planes."""
    import hashlib
    frames = CodecContext.open_decoder(
        CodecParameters(codec_id="vvc"), device=cuda).decode_all(
        [Packet(data=fx.vvc_av1_stream("vvc10_416x240"), pts=0)])
    assert all(p.dtype == torch.uint16 for f in frames for p in f.planes)
    assert [hashlib.sha256(p.cpu().numpy().tobytes()).hexdigest()
            for f in frames for p in f.planes] == \
        fx.vvc_golden("vvc10_416x240")


@pytest.mark.parametrize("name", ["w_noise", "w_vp9", "x_ivf", "x_mp4",
                                  "x_mkv", "x_split"])
def test_cli_bsf_and_av1_remux_on_card_match_reference(cuda, tmp_path,
                                                       name):
    """Phase 30's -bsf and AV1 commands through the CLI on the card: the
    reference CLI's sha256 (cli_golden.json)."""
    import hashlib
    import json
    from ffmpeg_tpu_torch.cli.ffmpeg import main
    fx.write_vvc_av1_sources(tmp_path)
    assert main(fx.bsf_av1_vvc_commands(tmp_path)[name], device=cuda) == 0
    sha = hashlib.sha256((tmp_path / fx.BSF_FILES[name]).read_bytes())
    assert sha.hexdigest() == json.loads(
        fx.CLI_GOLDEN.read_text())["w_sha256"][name]


# ---------------------------------------------------------------------------
# the multi-device layer, every mesh position the card (chip_smoke.py
# phase 31 (a)-(d) at small sizes)


def test_sharded_deblock_on_card_matches_unsharded(cuda):
    """sharded_deblock over 4 positions of the card against deblock_plane
    on the card and on the CPU, on blocky content that it filters."""
    from ffmpeg_tpu_torch.ops.deblock import deblock_plane
    from ffmpeg_tpu_torch.parallel.halo import sharded_deblock
    from ffmpeg_tpu_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (16, 8)).repeat(8, 0).repeat(8, 1)
    plane = torch.from_numpy(np.clip(base + rng.integers(-3, 4, (128, 64)),
                                     0, 255).astype(np.uint8))
    got = sharded_deblock(plane.to(cuda),
                          make_mesh(4, spatial=4, devices=[cuda] * 4), qp=40)
    want = deblock_plane(plane, qp=40)
    assert got.is_cuda and not torch.equal(want, plane)
    assert torch.equal(got, deblock_plane(plane.to(cuda), qp=40))
    assert torch.equal(got.cpu(), want)


def test_vp9_loopfilter_sharded_on_card_matches_host(cuda):
    """loopfilter_sharded over 2 positions of the card against the host's
    lf.loopfilter_frame on the pre-filter state of each frame of the
    small crafted stream (2 superblock columns)."""
    import copy
    from ffmpeg_tpu_torch.codecs.vp9 import VP9Core, lf, recon_tpu
    from ffmpeg_tpu_torch.codecs.vp9.lf_sharded import loopfilter_sharded
    from ffmpeg_tpu_torch.io.ivf import read_ivf
    from ffmpeg_tpu_torch.parallel.mesh import make_mesh
    _par, _tb, pkts = read_ivf(fx.VP9_SMALL.read_bytes())
    mesh = make_mesh(2, spatial=2, devices=[cuda] * 2)
    core = VP9Core(native=True, device=cuda)
    core.capture = []
    n = 0
    for p in pkts:
        core.decode_frame(p.data)
        h, fs, rec = core.capture[-1]
        if not h.filter_level:
            continue
        recon_tpu.reconstruct(fs, rec, cuda)
        host = copy.copy(fs)
        host.y, host.u, host.v = fs.y.copy(), fs.u.copy(), fs.v.copy()
        lf.loopfilter_frame(host)
        out = loopfilter_sharded(fs, mesh)
        for a, b, t in zip((host.y, host.u, host.v), (fs.y, fs.u, fs.v),
                           out):
            np.testing.assert_array_equal(b, a)
            assert t.is_cuda and np.array_equal(t.cpu().numpy(), a)
        n += 1
    assert n


def test_hevc_sharded_filters_on_card_match_filters_tpu(cuda):
    """sharded_filters over 2 positions of the card (one CTB column each)
    on the small crafted stream's first picture, against filters_tpu on
    the card and on the CPU."""
    import copy
    from ffmpeg_tpu_torch.codecs.hevc import filter_tpu, recon_tpu
    from ffmpeg_tpu_torch.parallel.mesh import make_mesh
    ctx = CodecContext.open_decoder(CodecParameters(codec_id="hevc"),
                                    device=cuda)
    ctx.codec.capture = []
    ctx.decode_all([Packet(data=p, pts=i) for i, p in
                    enumerate(fx.hevc_pictures(fx.HEVC_SMALL.read_bytes()))])
    dec, rec = ctx.codec.capture[0]
    pre = recon_tpu.reconstruct(dec, rec, cuda)
    sdec = copy.copy(dec)
    sdec.y, sdec.u, sdec.v = pre
    got = filter_tpu.sharded_filters(
        sdec, make_mesh(2, spatial=2, devices=[cuda] * 2))
    want = filter_tpu.filters_tpu(dec, *pre)
    cpu = filter_tpu.filters_tpu(dec, *(p.cpu() for p in pre))
    assert any(not torch.equal(w, p) for w, p in zip(want, pre))
    for g, w, c in zip(got, want, cpu):
        assert g.is_cuda and torch.equal(g, w) and torch.equal(g.cpu(), c)


def test_dryrun_multichip_on_card(cuda):
    """entry.dryrun_multichip over 4 positions of the card: each of its
    five legs passes its own check against its unsharded counterpart."""
    legs = entry.dryrun_multichip(4, device=cuda)
    assert all(t.is_cuda for t in legs["decode_scale"])
    assert legs["deblock"].is_cuda and legs["audio"].is_cuda
