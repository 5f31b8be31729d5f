"""The PyTorch port imports and runs with jax and the JAX package absent.

The check runs in a subprocess, because this test process has imported
jax and ffmpeg_tpu already (tests/conftest.py and the other tests): a
meta-path finder refuses every `jax` and every `ffmpeg_tpu` module, then
the port is imported, its pipeline built on a packet of the 1080p
fixture, and its plain path run on the CPU; then three frames go through
the MPEG-2 encoder's entry point on the CPU; then a fixture frame through
the MJPEG decoder, a parsed filter graph and the one-shot scale_frame,
and the entry() twin and build_decode_scale at the 1080p auto spec; then
the audio frontend: the committed ADTS clip's first packets through the
demuxer, decode_frames, the resampler and the audio graph, and tx; then
the VP9 decoder: the committed small crafted stream through the IVF
reader and open_decoder("vp9") on both of its device paths, against the
reference's hashes, and the device loop filter; then the windowed VP9
decoder on the same stream against the same hashes, and the wavefront
loop filter; then the HEVC decoder, on its device path and its host
path (device_recon=False), over the committed small crafted stream
against the reference's hashes; then the H.264 decoder, on its device
path and its host path (recon="host"), over its committed small
crafted stream against the reference's hashes; then the encoders' round
trips: the H.264 encoder's I and P through the H.264 decoder, the MPEG-2
encoder's packets through the MPEG-1/2 decoder, and the MJPEG encoder's
packet through the MJPEG decoder; then the intra codecs: a frame through
the ProRes and the DNxHD encoder and back through their decoders, and
the MPEG-4 and H.263 decoders on committed streams; then the audio
decoders (MPEG audio Layers I-III, AC-3 and E-AC-3, HE-AAC with SBR and
PS) on the first packets of the committed audio streams, against the
reference's committed PCM; then the video filters of video2-video8 and
sources.py in four parsed chains and a source, and deblock_plane and
apply_lut3d; then the rest of the audio: the AAC encoder on a seeded
signal, the Vorbis and Opus decoders (CELT, SILK, hybrid) on the first
packets of committed streams against the reference's committed PCM, and
an audio filter chain of audio6; then the CLI and I/O layer: every module
of cli/, io/ (avio, demux, mux, parsers, id3v2, rtmp,
protocols and the 35 format modules), utils/aes.py and the rawvideo,
PCM, FLAC, GIF, DCA, MLP and ADPCM codecs imported, the crafted VP9
stream through main() to framemd5, the crafted H.264 stream remuxed to
Matroska and probed and remuxed to MPEG-TS and from it to FLV, and an
Ogg Opus file decoded; then the protocols and host codecs: the AAC clip's
TS into HLS, encrypted with AES-128 and read back over a loopback HTTP
server, and each committed stream of testing.HOST_CODECS decoded by
main() to the reference CLI's sha256; then the image codecs, FFV1, VP8,
WebP and the subtitle codecs: their modules imported and registered,
committed PNG, FFV1, VP8, TIFF, QOI and EXR files decoded by main() (to
the reference binary's sha256 where the fixture holds it), and an rgba
picture encoded to WebP and QOI and a yuv420p one to FFV1; then the
bitstream filters, AV1 and VVC: a -bsf noise copy and the AV1 stream
copied into IVF and through av1_frame_split to the reference CLI's
sha256, the committed 10-bit VVC GOP to the reference CLI's framemd5,
and the host Pipeline; then the multi-device layer's dryrun_multichip
over four cpu positions; then the package's exports, and the general
scan decode on a fixture frame and on a frame of
tools/gen_torch_huffman_fixture.py's encoder, each against the C++ host
decoder; all on the CPU."""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if (name in ("jax", "ffmpeg_tpu")
                or name.startswith(("jax.", "jaxlib", "ffmpeg_tpu."))):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, _Block())
sys.path.insert(0, sys.argv[1])

import numpy as np
import torch
from ffmpeg_tpu_torch.io.mjpeg import split_packets
from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
    MjpegTpuEntropyPipeline, TpuEntropySpec)
from ffmpeg_tpu_torch.ops import huffman
from ffmpeg_tpu_torch.scale.swscale import Scaler
from ffmpeg_tpu_torch.testing import host_decode, packed_cap

pkts = split_packets(open(sys.argv[2], "rb").read())
spec = TpuEntropySpec(1920, 1080, 224, 224, batch=1, stride=192,
                      packed_cap=packed_cap(pkts))
pipe = MjpegTpuEntropyPipeline(spec, pkts[0], device="cpu")
pipe.prep_frame(pkts[0], 0)
out = pipe.run_batch()
assert [tuple(c.shape) for c in out] == [(1, 224, 224)] * 3
assert all(c.dtype == torch.uint8 for c in out)
assert huffman.KERNEL_LAUNCHES == 0
regions = torch.from_numpy(pipe.regions)
coef = huffman.jpeg_scan_decode_packed(
    regions, *pipe.program.split_regions(regions), pipe.hdr)
assert np.array_equal(coef[0].numpy(), host_decode(pkts[0]))
sc = Scaler("cpu", src_w=32, src_h=16, src_fmt="yuv420p", dst_w=16,
            dst_h=8, dst_fmt="rgb24")
sc.run([np.zeros((16, 32), np.uint8), np.zeros((8, 16), np.uint8),
        np.zeros((8, 16), np.uint8)])
from ffmpeg_tpu_torch.codecs import CodecContext, EncoderParameters
from ffmpeg_tpu_torch.ops import me
from ffmpeg_tpu_torch.testing import mpeg2_clip
enc = CodecContext.open_encoder(EncoderParameters("mpeg2video", 64, 48),
                                {"qscale": 6, "gop_size": 4}, device="cpu")
for f in mpeg2_clip(3, 64, 48):
    enc.send_frame(f)
    assert enc.receive_packet().data
assert enc.codec.last_mv_grid.shape == (3, 4, 2)
assert me.KERNEL_LAUNCHES == 0
from ffmpeg_tpu_torch.codecs import CodecContext
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.entry import entry
from ffmpeg_tpu_torch.filters import parse_graph
from ffmpeg_tpu_torch.io.stream import CodecParameters
from ffmpeg_tpu_torch.models.mjpeg_pipeline import (
    DecodeScaleSpec, cached_decode_scale, pack_coeffs)
from ffmpeg_tpu_torch.scale.swscale import scale_frame
from ffmpeg_tpu_torch.testing import scan_coeffs
dec = CodecContext.open_decoder(CodecParameters(codec_id="mjpeg"),
                                device="cpu")
fr = dec.decode_all([Packet(data=pkts[0])])[0]
assert fr.planes[0].shape == (1080, 1920) and fr.planes[0].device.type == "cpu"
g = parse_graph("scale=224:224:format=rgb24,tensornorm", device="cpu")
out = g.run([fr])[0]
assert [tuple(p.shape) for p in out.planes] == [(224, 224)] * 3
assert scale_frame(fr, 64, 36, "rgb24", device="cpu").planes[0].shape \
    == (36, 64)
fn, args = entry(device="cpu")
assert [tuple(o.shape) for o in fn(*args)] == [(2, 128, 128)] * 3
spec = DecodeScaleSpec.auto(1920, 1080, 224, 224)
cy_, cu_, cv_, qy, qc = scan_coeffs(pkts[0], spec.ncoeff)
o = cached_decode_scale(spec)(*[torch.from_numpy(pack_coeffs(c[None]))
                                for c in (cy_, cu_, cv_)],
                              torch.from_numpy(qy), torch.from_numpy(qc))
assert [tuple(x.shape) for x in o] == [(1, 224, 224)] * 3
from ffmpeg_tpu_torch.filters import filter_names
from ffmpeg_tpu_torch.io.adts import read_adts
from ffmpeg_tpu_torch.ops import tx
from ffmpeg_tpu_torch.testing import AAC_CLIP, audio_frontend
par, apk = read_adts(AAC_CLIP.read_bytes())
afr, aout = audio_frontend(par, apk[:8], "cpu")
assert len(afr) == 8 and afr[0].audio_data.shape == (2, 1024)
assert aout.shape == (1, 2731) and aout.dtype == np.float32
g = parse_graph("aresample=16000,aformat=channel_layouts=mono", device="cpu")
assert sum(f.nb_samples for f in g.run(afr)) == 2731    # ceil(8192 / 3)
assert {"aresample", "aformat", "amix", "pan"} <= set(filter_names())
assert tuple(tx.imdct(torch.zeros(3, 128), 128).shape) == (3, 256)
assert tuple(tx.fft(torch.zeros(2, 2048, 2)).shape) == (2, 2048, 2)
from ffmpeg_tpu_torch.codecs import decoder_names
from ffmpeg_tpu_torch.codecs.vp9 import VP9Core, recon_tpu
from ffmpeg_tpu_torch.codecs.vp9.lf_tpu import loopfilter_frame_tpu
from ffmpeg_tpu_torch.io.ivf import read_ivf
from ffmpeg_tpu_torch.testing import (VP9_LF_GOLDEN, VP9_SMALL, plane_sha256,
                                      vp9_decode)
assert "vp9" in decoder_names()
vpar, _tb, vpk = read_ivf(VP9_SMALL.read_bytes())
vgold = np.load(VP9_LF_GOLDEN)["small"]
for opts in (None, {"native": False, "device_recon": True}):
    vfr = vp9_decode(vpk, "cpu", opts)
    assert [[plane_sha256(p) for p in f.planes] for f in vfr] == \
        vgold.tolist()
vcore = VP9Core(native=True, device="cpu")
vcore.capture = []
vcore.decode_frame(vpk[0].data)
_h, vfs, vrec = vcore.capture[0]
recon_tpu.reconstruct(vfs, vrec, "cpu")
assert loopfilter_frame_tpu(vfs, "cpu")[0].shape == (128, 128)
from ffmpeg_tpu_torch.codecs.vp9.lf_tpu import _luts
from ffmpeg_tpu_torch.codecs.vp9.lf_wave import loopfilter_wavefront
from ffmpeg_tpu_torch.models.vp9_tpu import Vp9TpuDecoder
wfr = Vp9TpuDecoder(device="cpu").decode([p.data for p in vpk],
                                         emit_planes=True)
assert [[plane_sha256(p) for p in f] for f in wfr] == vgold.tolist()
lvl8 = np.zeros((vfs.sb_rows * 8, vfs.sb_cols * 8), np.int32)
lvl8[:vfs.rows, :vfs.cols] = vfs.lf_lvl
wy, _wu, _wv = loopfilter_wavefront(
    *(torch.from_numpy(p) for p in (vfs.y, vfs.u, vfs.v)), vfs.wd_v,
    vfs.wd_h, vfs.wd_v_uv, vfs.wd_h_uv, lvl8, *_luts(_h.sharpness), vfs.sb_rows, vfs.sb_cols,
    (32, 32, 16, 16))
assert wy.shape == (128, 128) and wy.dtype == torch.int32
from ffmpeg_tpu_torch.codecs.hevc import HevcDecoder, filter_tpu, recon_tpu
from ffmpeg_tpu_torch.testing import HEVC_GOLDEN, HEVC_SMALL, hevc_decode
assert "hevc" in decoder_names()
hgold = np.load(HEVC_GOLDEN)["small"].tolist()
for opts in (None, {"device_recon": False}):
    hfr = hevc_decode(HEVC_SMALL.read_bytes(), "cpu", opts)
    assert [[plane_sha256(p) for p in f.planes] for f in hfr] == hgold
from ffmpeg_tpu_torch.codecs.h264 import H264Decoder, recon_tpu
from ffmpeg_tpu_torch.testing import H264_GOLDEN, H264_SMALL, h264_decode
assert "h264" in decoder_names()
agold = np.load(H264_GOLDEN)["small"].tolist()
for opts in (None, {"recon": "host"}):
    afr = h264_decode(H264_SMALL.read_bytes(), "cpu", opts)
    assert [[plane_sha256(p) for p in f.planes] for f in afr] == agold
from ffmpeg_tpu_torch.codecs import encoder_names
assert {"h264", "mjpeg", "mpeg2video"} <= set(encoder_names())
assert {"mpeg2video", "mpeg1video"} <= set(decoder_names())
clip = mpeg2_clip(2, 64, 48)
henc = CodecContext.open_encoder(EncoderParameters("h264", 64, 48),
                                 device="cpu")
hdata = b""
for f in clip:
    henc.send_frame(f)
    hdata += henc.receive_packet().data
hfr = h264_decode(hdata, "cpu")
assert len(hfr) == 2
for p, r in zip(hfr[1].planes, henc.codec._recon):
    assert np.array_equal(p.numpy(), r)
menc = CodecContext.open_encoder(EncoderParameters("mpeg2video", 64, 48),
                                 {"qscale": 6}, device="cpu")
mpk = []
for f in clip:
    menc.send_frame(f)
    mpk.append(Packet(data=menc.receive_packet().data))
mfr = CodecContext.open_decoder(CodecParameters(codec_id="mpeg2video"),
                                device="cpu").decode_all(mpk)
assert [f.pict_type for f in mfr] == ["I", "P"]
assert mfr[1].planes[0].shape == (48, 64)
jenc = CodecContext.open_encoder(EncoderParameters("mjpeg", 64, 48),
                                 device="cpu")
jenc.send_frame(clip[0])
jfr = CodecContext.open_decoder(CodecParameters(codec_id="mjpeg"),
                                device="cpu").decode_all(
    [Packet(data=jenc.receive_packet().data)])
assert jfr[0].planes[0].shape == (48, 64)
from ffmpeg_tpu_torch.testing import (intra_clip_frame, mpeg4_stream,
                                      plane_psnr)
assert {"prores", "dnxhd"} <= set(encoder_names())
assert {"prores", "apch", "ap4h", "dnxhd", "mpeg4", "h263"} <= \
    set(decoder_names())
isrc = intra_clip_frame(48, 32)
for cid in ("prores", "dnxhd"):
    ipar = CodecParameters(codec_id=cid, width=48, height=32,
                           pix_fmt="yuv422p10le")
    ienc = CodecContext.open_encoder(ipar, device="cpu")
    ienc.send_frame(isrc)
    ifr = CodecContext.open_decoder(CodecParameters(
        codec_id=cid, codec_tag=ipar.codec_tag), device="cpu").decode_all(
        [ienc.receive_packet()])[0]
    assert ifr.format == "yuv422p10le"
    assert min(plane_psnr(ifr.planes, isrc.planes, 10)) > 45
for name in ("mpeg4_4mv", "h263_cif_rc"):
    vst = mpeg4_stream(name)
    vfr = CodecContext.open_decoder(CodecParameters(
        codec_id=vst["codec_id"], extradata=vst["extradata"]),
        device="cpu").decode_all([Packet(data=p, pts=t) for p, t in
                                  zip(vst["packets"][:2], vst["pts"])])
    assert [f.pict_type for f in vfr] == ["I", "P"]
    assert vfr[1].planes[0].shape == (vst["height"], vst["width"])
from ffmpeg_tpu_torch.testing import (AUDIO_PREFIX_PACKETS, audio_bar,
                                      audio_decode, audio_stream, snr_db)
assert {"mp3", "mp2", "mp1", "ac3", "eac3", "aac"} <= set(decoder_names())
for name in ("mp3_reservoir", "mp2_stereo", "mp1_stereo", "ac3_stereo",
             "eac3_aht_spx", "aac_ps"):
    ast = audio_stream(name)
    afr = audio_decode(ast, "cpu", n=AUDIO_PREFIX_PACKETS)
    apcm = np.concatenate([f.audio_data for f in afr], axis=1)
    atol, asnr = audio_bar(name)
    peak = max(1.0, float(np.abs(ast["prefix"]).max()))
    assert apcm.shape == ast["prefix"].shape, name
    assert atol is None or np.abs(apcm - ast["prefix"]).max() <= atol * peak
    assert snr_db(apcm, ast["prefix"]) >= asnr, name
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.filters import (framesync, get_filter, sources,  # noqa
                                      video2, video3, video4, video5,
                                      video6, video7, video8)
from ffmpeg_tpu_torch.utils.rational import Rational
from ffmpeg_tpu_torch.ops.deblock import deblock_plane
from ffmpeg_tpu_torch.scale.lut3d import apply_lut3d, identity_lut
from ffmpeg_tpu_torch.testing import filter_clip
assert len(filter_names()) == 125
vclip = filter_clip(0, 3, 32, 16, "yuv420p", interlaced=True)
vin = [Frame.video(32, 16, "yuv420p", planes=p, pts=k,
                   time_base=Rational(1, 25), interlaced=True,
                   top_field_first=True) for k, p in enumerate(vclip)]
for text in ("yadif,deblock,negate,eq=contrast=1.2,boxblur,hue=h=10",
             "bwdif,hqdn3d,gblur,vignette,tmix,vnoise,cas",
             "format=pix_fmts=gbrp,lut3d,colortemperature,lutrgb,rotate=a=0.2",
             "colorspace=all=bt709:iall=bt601-6-625,median,sobel,tpad=stop=1"):
    vout = parse_graph(text, device="cpu").run(vin)
    assert len(vout) >= 3 and all(p.device.type == "cpu"
                                  for f in vout for p in f.planes), text
src = get_filter("mandelbrot")("size=16x8:maxiter=8")
src.device = torch.device("cpu")
assert next(iter(src.generate(1))).planes[0].shape == (8, 16)
assert deblock_plane(torch.zeros(16, 16, dtype=torch.uint8)).shape == (16, 16)
assert apply_lut3d(torch.zeros(4, 3), torch.from_numpy(identity_lut(5))
                   ).shape == (4, 3)
from ffmpeg_tpu_torch.testing import (AUDIO_CODECS, CODEC_PREFIX_PACKETS,
                                      aac_decode, aac_encode, aac_signal,
                                      audio_chain_inputs, codec_decode,
                                      codec_stream, run_audio_chain)
assert "aac" in encoder_names() and {"vorbis", "opus"} <= set(decoder_names())
sig = aac_signal(3000, 48000, 2)
apk, _aenc, _adec = aac_encode(sig, 48000, 2, "cpu")
assert len(apk) == 4 and aac_decode(apk, 48000, "cpu").shape == (2, 4096)
for name in ("vorbis_noise", "celt_noise", "silk_stereo", "hybrid_cfg13"):
    cst = codec_stream(name)
    cpcm = np.concatenate([f.audio_data for f in codec_decode(
        cst, "cpu", n=CODEC_PREFIX_PACKETS)], axis=1)
    assert cpcm.shape == cst["prefix"].shape, name
    assert snr_db(cpcm, cst["prefix"]) >= 100, name
chain = run_audio_chain(lambda t: parse_graph(t, device="cpu"), "audio6",
                        audio_chain_inputs())
assert chain.shape == np.load(AUDIO_CODECS)["chain_audio6"].shape
import importlib
import contextlib
import io
import json
import tempfile
from pathlib import Path
for mod in ("cli.ffmpeg", "cli.ffprobe", "cli.sync_queue", "cli.textformat",
            "io.avio", "io.demux", "io.mux", "io.parsers",
            "io.id3v2", "io.rtmp", "io.protocols", "utils.aes",
            "codecs.rawvideo", "codecs.pcm", "codecs.flac",
            "codecs.flac_enc", "codecs.gif", "codecs.dca_tables",
            "codecs.dca", "codecs.mlp", "codecs.adpcm_tables",
            "codecs.adpcm", "codecs.png", "codecs.tiff", "codecs.images",
            "codecs.exr", "codecs.ffv1", "codecs.ffv1_enc",
            "codecs.subtitles", "codecs.subtitles2", "codecs.webp",
            "codecs.webp_vp8l", "codecs.webp_vp8l_enc", "codecs.cbs",
            "codecs.bsf", "codecs.parsers", "codecs.av1", "parallel",
            "parallel.executor", "parallel.pipeline", "parallel.mesh",
            "parallel.halo", "codecs.vp9.lf_sharded",
            *(f"codecs.vvc.{m}" for m in (
                "tables", "cabac", "params", "inter", "ctu", "craft")),
            *(f"codecs.vp8.{m}" for m in (
                "tables_gen", "idct", "pred", "mc", "lf", "header",
                "block")),
            *(f"io.formats.{m}" for m in (
                "y4m", "rawvideo", "wav", "hashenc", "img_mjpeg", "ivf",
                "h26x", "adts", "mp3raw", "ac3raw", "matroska",
                "matroskaenc", "mov", "movenc", "ogg", "mpegts", "avi",
                "flv", "mlpraw", "webpfmt", "exrfmt", "srt", "webvtt",
                "assfmt", "concat_seg", "tee_fifo", "dashenc", "rtp",
                "rtpenc", "flac", "gif", "hls", "dash", "dtsraw"))):
    importlib.import_module(f"ffmpeg_tpu_torch.{mod}")
from ffmpeg_tpu_torch.cli.ffmpeg import main as cli_main
from ffmpeg_tpu_torch.cli.ffprobe import main as probe_main
from ffmpeg_tpu_torch.testing import CLI_GOLDEN, H264_SMALL, cli_commands
with tempfile.TemporaryDirectory() as tmp:
    argv = [str(VP9_SMALL) if a.endswith("vp9_1080p_100.ivf") else a
            for a in cli_commands(tmp)["b"]]
    assert cli_main(argv, device="cpu") == 0
    assert Path(tmp, "out_vp9.md5").read_text() == json.loads(
        CLI_GOLDEN.read_text())["b_small_framemd5"]
    assert cli_main(["-i", str(H264_SMALL), "-c", "copy", f"{tmp}/o.mkv"],
                    device="cpu") == 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert probe_main(["-show_streams", "-of", "json", f"{tmp}/o.mkv"],
                          device="cpu") == 0
    assert json.loads(buf.getvalue())["streams"][0]["codec_name"] == "h264"
    from ffmpeg_tpu_torch.testing import codec_stream, codec_stream_ogg
    cst = codec_stream("celt_mono")
    Path(tmp, "c.ogg").write_bytes(codec_stream_ogg(cst))
    assert cli_main(["-i", f"{tmp}/c.ogg", "-f", "f32le", f"{tmp}/c.f32"],
                    device="cpu") == 0
    assert Path(tmp, "c.f32").stat().st_size == 4 * 23880
    assert cli_main(["-i", str(H264_SMALL), "-c", "copy", f"{tmp}/o.ts"],
                    device="cpu") == 0
    assert cli_main(["-i", f"{tmp}/o.ts", "-c", "copy", f"{tmp}/o.flv"],
                    device="cpu") == 0
    import hashlib
    from ffmpeg_tpu_torch import testing as fx
    from ffmpeg_tpu_torch.io import open_input
    d = Path(tmp)
    assert cli_main(["-i", str(AAC_CLIP), "-c", "copy", "-frames:a", "40",
                     f"{tmp}/a.ts"], device="cpu") == 0
    assert cli_main(["-i", f"{tmp}/a.ts", "-c", "copy", "-f", "hls",
                     f"{tmp}/aac.m3u8"], device="cpu") == 0
    fx.write_hls_aes(d)
    srv, th, base = fx.serve_http(d)
    try:
        hls = open_input(f"{base}/aac_enc.m3u8")
        got = [p.data for p in hls.packets()]
        hls.close()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(10)
    ts = open_input(f"{tmp}/a.ts")
    assert got == [p.data for p in ts.packets()] and len(got) >= 20
    ts.close()
    fx.write_host_codec_streams(d)
    for name in fx.HOST_CODEC_STREAMS:
        argv = fx.host_codec_command(d, name)
        assert cli_main(argv, device="cpu") == 0, name
        assert hashlib.sha256(Path(argv[-1]).read_bytes()).hexdigest() \
            == fx.host_codec_golden(name), name
    from ffmpeg_tpu_torch.codecs import encoder_names
    assert {"png", "tiff", "bmp", "ppm", "qoi", "exr", "ffv1", "vp8", "webp",
            "subrip", "ass", "webvtt", "mov_text", "pgssub"} <= \
        set(decoder_names())
    assert {"png", "tiff", "bmp", "ppm", "qoi", "ffv1", "webp",
            "mov_text"} <= set(encoder_names())
    for name, ext in (("png_rgb48be", "png"), ("ffv1_gop6", "avi"),
                      ("vp8_inter_golden_altref", "ivf"),
                      ("tiff_yuv420p_lzw", "tif"), ("qoi_rgba", "qoi"),
                      ("exr_rgb_c3", "exr")):
        Path(tmp, f"i.{ext}").write_bytes(fx.image_stream(name))
        argv = ["-i", f"{tmp}/i.{ext}", "-f", "rawvideo", f"{tmp}/o.raw"]
        assert cli_main(argv, device="cpu") == 0, name
        if f"{name}_ref_sha256" in np.load(fx.IMAGE_CODECS).files:
            assert hashlib.sha256(Path(tmp, "o.raw").read_bytes()
                                  ).hexdigest() == fx.image_golden(name)
        Path(tmp, "o.raw").unlink()
    Path(tmp, "o.rgba").write_bytes(bytes(range(256)) * 2)
    for codec, fmt, mux in (("webp", "rgba", "webp"), ("qoi", "rgba",
                                                      "image2"),
                            ("ffv1", "yuv420p", "matroska")):
        assert cli_main(["-f", "rawvideo", "-pixel_format", fmt, "-s",
                         "16x8", "-i", f"{tmp}/o.rgba", "-c:v", codec,
                         "-f", mux, f"{tmp}/o.{codec}"], device="cpu") == 0, \
            codec
    from ffmpeg_tpu_torch.codecs.bsf import bsf_names
    assert {"av1", "vvc", "h266"} <= set(decoder_names())
    assert {"noise", "dts2pts", "av1_frame_split"} <= set(bsf_names())
    fx.write_vvc_av1_sources(d)
    gold = json.loads(CLI_GOLDEN.read_text())
    cmds = fx.bsf_av1_vvc_commands(d)
    for name in ("w_noise", "x_ivf", "x_split"):
        assert cli_main(cmds[name], device="cpu") == 0, name
        assert hashlib.sha256((d / fx.BSF_FILES[name]).read_bytes()
                              ).hexdigest() == gold["w_sha256"][name], name
    assert cli_main(cmds["y_10"], device="cpu") == 0
    assert (d / "out_vvc10.md5").read_text() == gold["y_10_framemd5"]
    from ffmpeg_tpu_torch.parallel.pipeline import Pipeline
    assert list(Pipeline(range(4), [lambda x: x + 1]).run()) == [1, 2, 3, 4]
from ffmpeg_tpu_torch.entry import dryrun_multichip
assert set(dryrun_multichip(4, device="cpu")) == {
    "decode_scale", "decode_scale_diff", "audio", "deblock", "vp9",
    "hevc"}
assert me.KERNEL_LAUNCHES == 0
from ffmpeg_tpu_torch import Frame, Packet, Rational, log
from ffmpeg_tpu_torch.codecs import Codec, register_decoder, register_encoder
from ffmpeg_tpu_torch.testing import general_scan_inputs
import importlib.util
spec = importlib.util.spec_from_file_location(
    "gen_torch_huffman_fixture",
    sys.argv[1] + "/tools/gen_torch_huffman_fixture.py")
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
k1_before = huffman.KERNEL_LAUNCHES
for pkt in (pkts[0], tool.encode(64, 48, 1)[0]):
    coef = huffman.jpeg_scan_decode(*general_scan_inputs(pkt, "cpu"))
    assert np.array_equal(coef.numpy(), host_decode(pkt))
assert huffman.KERNEL_LAUNCHES == k1_before
bad = sorted(m for m in sys.modules
             if m in ("jax", "ffmpeg_tpu")
             or m.startswith(("jax.", "ffmpeg_tpu.")))
assert not bad, bad
print("PORT_OK")
"""


def test_port_runs_with_jax_blocked():
    fixture = REPO / "tests" / "data" / "port" / "flagship_1080p_8.mjpeg"
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(REPO),
                        str(fixture)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "PORT_OK" in r.stdout


def test_port_sources_never_import_jax():
    """No source of the port, nor the scripts that run on the card,
    imports jax or anything of the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|ffmpeg_tpu)\b", re.M)
    files = [*(REPO / "ffmpeg_tpu_torch").rglob("*.py"),
             REPO / "chip_smoke.py",
             *(REPO / "tools" / n for n in ("k1_breakdown_torch.py",
                                            "kernel_ab_torch.py",
                                            "vp9_window_ab_torch.py",
                                            "vp9_mc_ab_torch.py",
                                            "hevc_dispatch_count_torch.py",
                                            "h264_dispatch_count_torch.py",
                                            "filter_ops_count_torch.py",
                                            "split_bench_torch.py",
                                            "gen_torch_huffman_fixture.py"))]
    hits = [str(p.relative_to(REPO)) for p in files
            if pat.search(p.read_text())]
    assert not hits, hits


def test_camera_benchmark_files_never_import_jax():
    """The camera MJPEG cell's files under portbench/ run on the card,
    which has no JAX: none imports jax or the JAX package, and the RFC
    2435 generator and the 4:2:2 plain reference import nothing of the
    port either (the tests hold the port to them)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|ffmpeg_tpu)\b", re.M)
    port = re.compile(r"^\s*(import|from)\s+(ffmpeg_tpu_torch)\b", re.M)
    bench = REPO / "portbench"
    plain = [bench / "inputs" / "rtpjpeg.py",
             bench / "reference" / "mjpeg422.py"]
    driven = [bench / "paths" / "rtpjpeg_pipeline.py",
              bench / "metrics" / "k1_lane_skew.py"]
    for p in plain + driven:
        src = p.read_text()
        assert not pat.search(src), p
        if p in plain:
            assert not port.search(src), p


def test_chip_smoke_imports_only_the_port():
    """The card's machine has no JAX: the smoke script names neither jax
    nor the reference package, only ffmpeg_tpu_torch."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|ffmpeg_tpu)\b", re.M)
    hits = pat.findall((REPO / "chip_smoke.py").read_text())
    assert not hits, hits


def test_roundtrip_fixture_tool_takes_its_answers_from_the_reference():
    """tools/gen_torch_roundtrip_fixture.py runs the reference by design,
    so it stays out of the no-jax check above; of the port it imports
    only the shared constants and helpers of ffmpeg_tpu_torch.testing,
    so no answer in the golden comes from the code it checks."""
    src = (REPO / "tools" / "gen_torch_roundtrip_fixture.py").read_text()
    port = set(re.findall(r"^\s*(?:from|import)\s+(ffmpeg_tpu_torch[\w.]*)"
                          r"(?:\s+import\s+(\w+))?", src, re.M))
    assert port == {("ffmpeg_tpu_torch", "testing")}, port
    assert re.search(r"^\s*from ffmpeg_tpu\.codecs import", src, re.M)


def test_intra_fixture_tool_takes_its_answers_from_the_reference():
    """tools/gen_torch_intra_fixture.py runs the reference by design, like
    the round-trip tool above: of the port it imports only
    ffmpeg_tpu_torch.testing, and the codecs it runs are the
    reference's."""
    src = (REPO / "tools" / "gen_torch_intra_fixture.py").read_text()
    port = set(re.findall(r"^\s*(?:from|import)\s+(ffmpeg_tpu_torch[\w.]*)"
                          r"(?:\s+import\s+(\w+))?", src, re.M))
    assert port == {("ffmpeg_tpu_torch", "testing")}, port
    assert re.search(r"^\s*from ffmpeg_tpu\.codecs import CodecContext",
                     src, re.M)


def test_filters_fixture_tool_takes_its_answers_from_the_reference():
    """tools/gen_torch_filters_fixture.py runs the reference by design,
    like the tools above: of the port it imports only
    ffmpeg_tpu_torch.testing (the chains, their seeded inputs and the
    graph runner), and the filters it runs are the reference's."""
    src = (REPO / "tools" / "gen_torch_filters_fixture.py").read_text()
    port = set(re.findall(r"^\s*(?:from|import)\s+(ffmpeg_tpu_torch[\w.]*)"
                          r"(?:\s+import\s+(\w+))?", src, re.M))
    assert port == {("ffmpeg_tpu_torch", "testing")}, port
    assert re.search(r"^\s*from ffmpeg_tpu\.filters import", src, re.M)


def test_audio_fixture_tool_takes_its_answers_from_the_reference():
    """tools/gen_torch_audio_fixture.py runs the reference by design, like
    the tools above: of the port it imports only ffmpeg_tpu_torch.testing
    (its paths and stream names), and the decoders it runs are the
    reference's."""
    src = (REPO / "tools" / "gen_torch_audio_fixture.py").read_text()
    port = set(re.findall(r"^\s*(?:from|import)\s+(ffmpeg_tpu_torch[\w.]*)"
                          r"(?:\s+import\s+(\w+))?", src, re.M))
    assert port == {("ffmpeg_tpu_torch", "testing")}, port
    assert re.search(r"^\s*from ffmpeg_tpu\.codecs import CodecContext",
                     src, re.M)


def test_audio_codecs_fixture_tool_takes_its_answers_from_the_reference():
    """tools/gen_torch_audio_codecs_fixture.py runs the reference by
    design, like the tools above: of the port it imports only
    ffmpeg_tpu_torch.testing (names, seeded inputs, the chain runner),
    and the encoder, decoders and filters it runs are the reference's."""
    src = (REPO / "tools" / "gen_torch_audio_codecs_fixture.py").read_text()
    port = set(re.findall(r"^\s*(?:from|import)\s+(ffmpeg_tpu_torch[\w.]*)"
                          r"(?:\s+import\s+(\w+))?", src, re.M))
    assert port == {("ffmpeg_tpu_torch", "testing")}, port
    assert re.search(r"^\s*from ffmpeg_tpu\.codecs import CodecContext",
                     src, re.M)
    assert re.search(r"^\s*from ffmpeg_tpu\.filters import parse_graph",
                     src, re.M)


def test_host_codecs_fixture_tool_takes_its_answers_from_the_reference():
    """tools/gen_torch_host_codecs_fixture.py runs the reference by
    design, like the tools above: of the port it imports only
    ffmpeg_tpu_torch.testing (the stream names, paths and commands), its
    streams are the reference binary's encodes replayed through
    tests/golden.py by the reference tests' own helpers, and the decodes
    it hashes are the reference CLI's."""
    src = (REPO / "tools" / "gen_torch_host_codecs_fixture.py").read_text()
    port = set(re.findall(r"^\s*(?:from|import)\s+(ffmpeg_tpu_torch[\w.]*)"
                          r"(?:\s+import\s+(\w+))?", src, re.M))
    assert port == {("ffmpeg_tpu_torch", "testing")}, port
    assert re.search(r"^\s*from ffmpeg_tpu\.cli\.ffmpeg import main", src,
                     re.M)
    for mod in ("conftest", "refutil", "test_dca", "test_flac_png",
                "test_ogg"):
        assert re.search(rf"^import {mod}\b", src, re.M), mod


def test_cli_fixture_tool_takes_its_answers_from_the_reference():
    """tools/gen_torch_cli_fixture.py runs the reference's CLI by design,
    like the tools above: of the port it imports only
    ffmpeg_tpu_torch.testing (the command lines, paths and the seeded
    clip), and the CLI, probe and muxer it runs are the reference's."""
    src = (REPO / "tools" / "gen_torch_cli_fixture.py").read_text()
    port = set(re.findall(r"^\s*(?:from|import)\s+(ffmpeg_tpu_torch[\w.]*)"
                          r"(?:\s+import\s+(\w+))?", src, re.M))
    assert port == {("ffmpeg_tpu_torch", "testing")}, port
    assert re.search(r"^\s*from ffmpeg_tpu\.cli\.ffmpeg import main", src,
                     re.M)
    assert re.search(r"^\s*from ffmpeg_tpu\.cli\.ffprobe import main",
                     src, re.M)


def test_image_codecs_fixture_tool_takes_its_answers_from_the_reference():
    """tools/gen_torch_image_codecs_fixture.py runs the reference by
    design, like the tools above: of the port it imports only
    ffmpeg_tpu_torch.testing (the stream names, sizes and paths), its
    FFV1, TIFF, QOI and PNG files and their decodes are the reference
    binary's replayed through tests/golden.py by the reference tests'
    own helpers, and its VP8, EXR and subtitle streams are made by the
    reference's tests and codecs."""
    src = (REPO / "tools" / "gen_torch_image_codecs_fixture.py").read_text()
    port = set(re.findall(r"^\s*(?:from|import)\s+(ffmpeg_tpu_torch[\w.]*)"
                          r"(?:\s+import\s+(\w+))?", src, re.M))
    assert port == {("ffmpeg_tpu_torch", "testing")}, port
    for mod in ("conftest", "refutil", "test_exr", "test_ffv1",
                "test_qoi_tiff", "test_subtitles2", "test_vp8",
                "test_vp8_inter"):
        assert re.search(rf"^import {mod}\b", src, re.M), mod
    assert re.search(r"^from ffmpeg_tpu\.codecs import CodecContext", src,
                     re.M)
    assert re.search(r"^from ffmpeg_tpu\.codecs\.webp import wrap_webp",
                     src, re.M)
