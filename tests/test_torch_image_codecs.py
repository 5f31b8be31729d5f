"""The port's image, FFV1 and subtitle codecs (codecs/png.py, tiff.py,
images.py, exr.py, ffv1.py, ffv1_enc.py, subtitles.py, subtitles2.py)
against the reference's, on the CPU.

- Each module is the reference's code: its top-level statements equal
  the reference's as syntax trees, but for those named in CHANGED: the
  codecs take the device that open_decoder and open_encoder hand them
  (DeviceCodec); the decoders put each picture on that device with one
  upload (device_planes, Frame.from_bytes), and the encoders read a
  frame's planes on the host through host_array or Frame.numpy.
- Each decoder's frames equal the reference decoder's, plane for plane,
  dtype and field for field, on the reference binary's FFV1, TIFF, QOI
  and PNG files of tests/data/port/image_codecs_streams.npz (16-bit and
  alpha formats included), and the binary's own decode where the
  reference's test compares planes with it.  EXR is float numpy in both
  packages on the same host: the bar is bit equality, and it holds.
- Every encoder (PNG, TIFF, PNM, BMP, QOI, FFV1 at each format of
  tests/test_ffv1_enc.py, and the subtitle encoders) writes the
  reference encoder's bytes.
- A frame a decoder has returned does not change when the decoder goes
  on: on the CPU a plane may share memory with the decoder's buffers.
- The subtitle decoders give the reference's frames on the same packets:
  SubRip, ASS, WebVTT, mov_text with style boxes, PGS display sets with
  an object split over two segments.
- The registries: the port decodes every codec id the reference does
  (av1, vvc and h266 too, since codecs/av1.py and vvc/ were ported), and
  encodes every one.
"""

import hashlib

import numpy as np
import pytest
import torch

from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.codecs import decoder_names as ref_decoder_names
from ffmpeg_tpu.codecs import encoder_names as ref_encoder_names
from ffmpeg_tpu.core.frame import Frame as RefFrame
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io import open_input as ref_open_input
from ffmpeg_tpu.io.stream import CodecParameters as RefPar
from ffmpeg_tpu.io.stream import MediaType as RefType
from ffmpeg_tpu.utils.rational import Rational as RefRational
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import (CodecContext, decoder_names,
                                     encoder_names)
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.io import open_input
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType
from ffmpeg_tpu_torch.utils.rational import Rational

from torch_io_util import differing, plain

_DEVICE = {"<imports>"}
CHANGED = {
    "codecs/png.py": _DEVICE | {"PngDecoder", "PngEncoder"},
    "codecs/tiff.py": _DEVICE | {"TiffDecoder", "TiffEncoder"},
    "codecs/images.py": _DEVICE | {"PnmDecoder", "PnmEncoder", "BmpDecoder",
                                   "BmpEncoder", "QoiDecoder", "QoiEncoder"},
    "codecs/exr.py": _DEVICE | {"ExrDecoder"},
    "codecs/ffv1.py": _DEVICE | {"Ffv1Decoder"},
    "codecs/ffv1_enc.py": _DEVICE | {"Ffv1Encoder"},
    "codecs/subtitles.py": _DEVICE | {"SrtDecoder", "SrtEncoder",
                                      "AssDecoder", "AssEncoder",
                                      "WebVttDecoder", "WebVttEncoder"},
    "codecs/subtitles2.py": _DEVICE | {"MovTextDecoder", "MovTextEncoder",
                                       "PgsDecoder"},
}
EXT = {"ffv1": "avi", "tiff": "tif", "qoi": "qoi", "png": "png",
       "exr": "exr"}
Z = np.load(fx.IMAGE_CODECS)
FILES = [k for k in Z.files if k.split("_")[0] in EXT
         and not k.endswith(("_ref_sha256", "_ref_bytes"))]


@pytest.mark.parametrize("rel", list(CHANGED))
def test_module_is_the_reference_code(rel):
    assert differing(rel) == CHANGED[rel]


def test_registries_equal_the_references():
    """Every decoder name of the reference's registry (av1, vvc and its
    alias h266 since codecs/av1.py and vvc/ came), and every encoder
    name."""
    assert decoder_names() == ref_decoder_names()
    assert {"av1", "vvc", "h266"} <= set(decoder_names())
    assert encoder_names() == ref_encoder_names()
    assert {"apng", "pbm", "pgm", "pnm", "srt", "ssa", "tx3g",
            "pgssub"} <= set(decoder_names())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("image_codecs")
    for k in FILES:
        (d / f"{k}.{EXT[k.split('_')[0]]}").write_bytes(Z[k].tobytes())
    return d


def _decode_both(path):
    """Both packages' demuxer and decoder on `path`: (ref frames, port
    frames)."""
    d = ref_open_input(str(path))
    ref = RefContext.open_decoder(d.streams[0].codecpar).decode_all(
        list(d.packets()))
    dp = open_input(str(path))
    got = CodecContext.open_decoder(dp.streams[0].codecpar,
                                    device="cpu").decode_all(
        list(dp.packets()))
    return ref, got


@pytest.mark.parametrize("name", FILES)
def test_decoder_gives_the_reference_frames(files, name):
    ref, got = _decode_both(files / f"{name}.{EXT[name.split('_')[0]]}")
    assert len(got) == len(ref) >= 1
    assert plain(got) == plain(ref)
    for f in got:
        assert all(isinstance(p, torch.Tensor) and p.device.type == "cpu"
                   for p in f.planes)
    if f"{name}_ref_sha256" in Z.files:
        # the binary's rawvideo decode, in the format it decoded to
        data = b"".join(f.to_bytes() for f in got)
        assert hashlib.sha256(data).hexdigest() == fx.image_golden(name)


def test_exr_planes_are_float32_on_the_device_bit_equal(files):
    ref, got = _decode_both(files / "exr_clip.exr")
    assert got[0].format == "gbrpf32le" and got[0].width == fx.EXR_W
    for a, b in zip(got[0].planes, ref[0].planes):
        assert a.dtype == torch.float32
        assert np.array_equal(a.numpy().view(np.uint32),
                              np.asarray(b).view(np.uint32))


def test_returned_frames_do_not_change(files):
    """The decoders keep state across pictures (FFV1's contexts over a
    GOP, each decoder's buffers); on the CPU a plane may share memory
    with them, so each frame is held after the later pictures."""
    for name in ("ffv1_gop6", "ffv1_v1-rice", "ffv1_slices4"):
        d = open_input(str(files / f"{name}.avi"))
        dec = CodecContext.open_decoder(d.streams[0].codecpar, device="cpu")
        pkts = list(d.packets())
        first = dec.codec.decode(pkts[0])[0]
        snap = [p.clone() for p in first.planes]
        for pkt in pkts[1:]:
            dec.codec.decode(pkt)
        assert all(torch.equal(a, b) for a, b in zip(first.planes, snap))
    for name in ("tiff_rgb24_lzw", "qoi_rgba", "png_rgb48be",
                 "exr_rgb_c3"):
        path = files / f"{name}.{EXT[name.split('_')[0]]}"
        d = open_input(str(path))
        pkt = list(d.packets())[0]
        dec = CodecContext.open_decoder(d.streams[0].codecpar, device="cpu")
        first = dec.codec.decode(pkt)[0]
        snap = [p.clone() for p in first.planes]
        for _ in range(2):
            again = dec.codec.decode(pkt)[0]
            for p in again.planes:
                p.zero_()
        assert all(torch.equal(a, b) for a, b in zip(first.planes, snap))


# --- the encoders ----------------------------------------------------------

def _frames_both(fmt, planes_list, tb=(1, 25)):
    w = planes_list[0][0].shape[1]
    h = planes_list[0][0].shape[0]
    ref = [RefFrame.video(w, h, fmt, planes=[np.asarray(p) for p in pl],
                          pts=i, time_base=RefRational(*tb))
           for i, pl in enumerate(planes_list)]
    port = [Frame.video(w, h, fmt, planes=[torch.from_numpy(
        np.ascontiguousarray(p)) for p in pl], pts=i, time_base=Rational(*tb))
        for i, pl in enumerate(planes_list)]
    return ref, port


def _encode_both(codec_id, fmt, planes_list, options=None):
    h, w = planes_list[0][0].shape
    ref_f, port_f = _frames_both(fmt, planes_list)
    ref = RefContext.open_encoder(RefPar(
        codec_type=RefType.VIDEO, codec_id=codec_id, width=w, height=h,
        pix_fmt=fmt), options)
    port = CodecContext.open_encoder(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id=codec_id, width=w, height=h,
        pix_fmt=fmt), options, device="cpu")
    want = [ref.codec.encode(f)[0] for f in ref_f]
    got = [port.codec.encode(f)[0] for f in port_f]
    return plain(want), plain(got), got


def _seeded_planes(fmt, w, h, n=1, seed=0):
    """n pictures of seeded planes of `fmt` (smooth with noise)."""
    from ffmpeg_tpu_torch.formats import pixfmt
    from ffmpeg_tpu_torch.core.imgutils import component_dims
    desc = pixfmt.get(fmt)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pl = []
        for c in range(desc.nb_components):
            cw, ch = component_dims(desc, c, w, h)
            mx = (1 << desc.comp[c].depth) - 1
            base = (np.arange(cw)[None] * 3 + np.arange(ch)[:, None] * 5
                    + 11 * i) % (mx + 1)
            noise = rng.integers(0, max(mx // 16, 2), (ch, cw))
            pl.append(((base + noise) & mx).astype(desc.component_dtype()))
        out.append(pl)
    return out


@pytest.mark.parametrize("codec_id,fmt,options", [
    ("png", "rgb24", None), ("png", "rgba", None), ("png", "gray", None),
    ("png", "ya8", None), ("png", "gray16be", None),
    ("png", "rgb48be", None), ("png", "rgba64be", None),
    ("tiff", "rgb24", None), ("tiff", "rgb24", {"compression_algo": "raw"}),
    ("tiff", "rgb24", {"compression_algo": "deflate"}),
    ("tiff", "rgba", None), ("tiff", "gray", None),
    ("ppm", "rgb24", None), ("ppm", "gray", None), ("bmp", "rgb24", None),
    ("qoi", "rgb24", None), ("qoi", "rgba", None),
])
def test_image_encoder_writes_the_reference_bytes(codec_id, fmt, options):
    for w, h in ((64, 48), (37, 23)):
        want, got, pkts = _encode_both(codec_id, fmt, _seeded_planes(
            fmt, w, h, seed=w), options)
        assert got == want
        back = CodecContext.open_decoder(CodecParameters(
            codec_type=MediaType.VIDEO, codec_id=codec_id), device="cpu"
            ).decode_all(pkts)
        assert back[0].width == w and back[0].height == h


_FFV1_CASES = [("yuv420p", 8), ("yuv422p", 8), ("yuv444p", 8),
               ("yuva420p", 8), ("yuv420p10le", 10), ("yuv444p16le", 16),
               ("gray", 8), ("gbrp", 8), ("gbrap", 8), ("gbrp12le", 12)]


@pytest.mark.parametrize("fmt,bits", _FFV1_CASES,
                         ids=[c[0] for c in _FFV1_CASES])
def test_ffv1_encoder_writes_the_reference_bytes(fmt, bits):
    """tests/test_ffv1_enc.py's formats, on two small seeded pictures;
    both decoders give the source back (lossless)."""
    planes = _seeded_planes(fmt, 40, 24, n=2, seed=bits)
    want, got, pkts = _encode_both("ffv1", fmt, planes)
    assert got == want
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="ffv1",
                          width=40, height=24)
    back = CodecContext.open_decoder(par, device="cpu").decode_all(pkts)
    ref_back = RefContext.open_decoder(RefPar(
        codec_type=RefType.VIDEO, codec_id="ffv1", width=40, height=24)
        ).decode_all([RefPacket(data=p.data) for p in pkts])
    # gray comes back as yuv444p with mid-grey chroma, as the
    # reference's decoder gives it
    assert back[0].format == ref_back[0].format == (
        "yuv444p" if fmt == "gray" else fmt)
    assert plain([f.planes for f in back]) == \
        plain([f.planes for f in ref_back])
    for f, src in zip(back, planes):
        assert all(np.array_equal(a, b) for a, b in
                   zip(f.numpy().planes, src))


def test_ffv1_encoder_reads_int16_planes_as_their_format():
    """16-bit planes on the device are int16 where a decoder made them
    so; the encoder reads them through Frame.numpy as the format's
    unsigned samples."""
    planes = _seeded_planes("yuv444p16le", 24, 16, seed=2)[0]
    want, _, _ = _encode_both("ffv1", "yuv444p16le", [planes])
    port = CodecContext.open_encoder(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="ffv1", width=24, height=16,
        pix_fmt="yuv444p16le"), device="cpu")
    f = Frame.video(24, 16, "yuv444p16le", planes=[
        torch.from_numpy(p.view(np.int16).copy()) for p in planes], pts=0,
        time_base=Rational(1, 25))
    assert plain([port.codec.encode(f)[0]]) == want


# --- the subtitle codecs ---------------------------------------------------

def _sub_both(codec_id, payloads, pts=None):
    """Both decoders on the same packets: (ref frames, port frames)."""
    pts = pts or [i * 1000 for i in range(len(payloads))]
    ref = RefContext.open_decoder(RefPar(codec_type=RefType.SUBTITLE,
                                         codec_id=codec_id))
    port = CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.SUBTITLE, codec_id=codec_id), device="cpu")
    want = ref.decode_all([RefPacket(data=p, pts=t, duration=900,
                                     time_base=RefRational(1, 1000))
                           for p, t in zip(payloads, pts)])
    got = port.decode_all([Packet(data=p, pts=t, duration=900,
                                  time_base=Rational(1, 1000))
                           for p, t in zip(payloads, pts)])
    return want, got


SUBS = {
    "subrip": [b"Hello <b>world</b>", "Zweite <i>Zeile</i>\nmit Ümlaut"
               .encode(), b"<font color=\"red\">x</font>"],
    "srt": [b"alias <u>line</u>"],
    "ass": [b"0,0,Default,,0,0,0,,{\\b1}Bold{\\b0} and\\Nnext",
            b"1,0,Default,Name,0,0,0,,plain\\hspaced", b"not an event"],
    "ssa": [b"2,0,Default,,0,0,0,,{\\i1}ssa"],
    "webvtt": [b"<v Bob>Hi &amp; bye</v>", b"<c.red>a</c> &lt;b&gt;"],
}


@pytest.mark.parametrize("codec_id", list(SUBS))
def test_text_subtitle_decoder_gives_the_reference_frames(codec_id):
    want, got = _sub_both(codec_id, SUBS[codec_id])
    assert plain(got) == plain(want) and len(got) == len(SUBS[codec_id])


@pytest.mark.parametrize("codec_id", ["subrip", "ass", "webvtt",
                                      "mov_text"])
def test_subtitle_encoder_writes_the_reference_bytes(codec_id):
    texts = ["Hello world", "two\nlines & <tags>", "Héllo wörld"]
    ref = RefContext.open_encoder(RefPar(codec_type=RefType.SUBTITLE,
                                         codec_id=codec_id))
    port = CodecContext.open_encoder(CodecParameters(
        codec_type=MediaType.SUBTITLE, codec_id=codec_id), device="cpu")
    assert port.par.extradata == ref.par.extradata
    for i, t in enumerate(texts):
        rf, pf = RefFrame(pts=i * 40), Frame(pts=i * 40)
        for f in (rf, pf):
            f.side_data["text"] = t
            if i == 1 and codec_id == "ass":
                f.side_data["ass"] = "7,0,Default,,0,0,0,,kept as is"
        assert plain(port.codec.encode(pf)) == plain(ref.codec.encode(rf))
    assert port.codec.device == torch.device("cpu")


def test_movtext_decoder_gives_the_reference_frames():
    """The reference encoder's packets and two with styl boxes (bold; a
    second box with italic and underline, colours)."""
    pkts = fx.movtext_packets()
    assert len(pkts) == len(fx.MOVTEXT_TEXTS) + 2
    for cid in ("mov_text", "tx3g"):
        want, got = _sub_both(cid, pkts)
        assert plain(got) == plain(want)
    assert got[-1].side_data["styles"][0]["italic"]
    assert got[-1].side_data["styles"][1]["underline"]
    assert r"\b1" in got[-2].side_data["ass"]


@pytest.mark.parametrize("name", ["pgs_display_set", "pgs_sd_canvas",
                                  "pgs_fragmented"])
def test_pgs_decoder_gives_the_reference_frames(name):
    data = fx.image_stream(name)
    for cid in ("hdmv_pgs_subtitle", "pgssub"):
        want, got = _sub_both(cid, [data, data], [0, 9000])
        assert plain(got) == plain(want) and len(got) == 2
    rects = got[0].side_data["rects"]
    assert rects and rects[0]["rgba"].dtype == np.uint8


def test_pgs_rle_equals_the_reference():
    from ffmpeg_tpu.codecs.subtitles2 import decode_pgs_rle as ref_rle
    from ffmpeg_tpu_torch.codecs.subtitles2 import decode_pgs_rle
    import test_subtitles2
    rng = np.random.default_rng(3)
    for shape in ((16, 40), (3, 300), (1, 1)):
        idx = rng.integers(0, 4, shape).astype(np.uint8)
        rle = test_subtitles2._rle_encode(idx)
        assert np.array_equal(decode_pgs_rle(rle, shape[1], shape[0]),
                              ref_rle(rle, shape[1], shape[0]))
    errors = []
    for fn in (ref_rle, decode_pgs_rle):
        with pytest.raises(Exception) as e:
            fn(b"\x01\x02", 8, 8)
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[1] == errors[0]


@pytest.mark.parametrize("cut", [5, 40, -3])
def test_pgs_truncated_display_set_fails_as_the_reference(cut):
    """A display set cut short: both decoders refuse it with the same
    error, or give the same frames."""
    data = fx.image_stream("pgs_fragmented")[:cut]
    outcome = []
    for ctx, par, pkt in (
            (RefContext, RefPar(codec_type=RefType.SUBTITLE,
                                codec_id="hdmv_pgs_subtitle"), RefPacket),
            (CodecContext, CodecParameters(codec_type=MediaType.SUBTITLE,
                                           codec_id="hdmv_pgs_subtitle"),
             Packet)):
        dec = ctx.open_decoder(par) if ctx is RefContext else \
            ctx.open_decoder(par, device="cpu")
        try:
            outcome.append(plain(dec.decode_all([pkt(data=data, pts=0)])))
        except Exception as e:      # noqa: BLE001 — compared below
            outcome.append((type(e).__name__, str(e)))
    assert outcome[1] == outcome[0]


# --- the CLI ---------------------------------------------------------------

_CLI_CASES = [("png", "rgb24", "image2", "png"),
              ("tiff", "rgb24", "image2", "tif"),
              ("bmp", "rgb24", "image2", "bmp"),
              ("ppm", "rgb24", "image2", "ppm"),
              ("qoi", "rgba", "image2", "qoi"),
              ("webp", "rgba", "webp", "webp"),
              ("ffv1", "yuv420p", "matroska", "mkv")]


def _both_clis(argv_of) -> list:
    """argv_of(side) run by the reference's CLI and the port's (on the
    CPU): their return codes."""
    from ffmpeg_tpu.cli.ffmpeg import main as ref_main
    from ffmpeg_tpu_torch.cli.ffmpeg import main
    return [ref_main(argv_of("ref")), main(argv_of("port"), device="cpu")]


@pytest.mark.parametrize("codec,pix,mux,ext", _CLI_CASES,
                         ids=[c[0] for c in _CLI_CASES])
def test_cli_encode_and_decode_equal_the_references(tmp_path, codec, pix,
                                                    mux, ext):
    """Phase 29's commands at 40x24 through both CLIs: the raw picture
    (two for FFV1) to the codec, then its file back to rawvideo; the
    files equal, the decodes equal and lossless (but the lossless WebP
    decode, which neither CLI can write: see test_torch_vp8_webp.py)."""
    w, h = 40, 24
    n = 2 if codec == "ffv1" else 1
    planes = _seeded_planes(pix, w, h, n=n, seed=len(codec))
    src = b"".join(Frame.video(w, h, pix, planes=p).to_bytes()
                   for p in planes)
    (tmp_path / "src.raw").write_bytes(src)
    rcs = _both_clis(lambda side: [
        "-f", "rawvideo", "-pixel_format", pix, "-s", f"{w}x{h}", "-i",
        str(tmp_path / "src.raw"), "-c:v", codec, "-f", mux,
        str(tmp_path / f"{side}.{ext}")])
    assert rcs == [0, 0]
    data = (tmp_path / f"port.{ext}").read_bytes()
    assert data == (tmp_path / f"ref.{ext}").read_bytes()
    if codec == "webp":
        return
    rcs = _both_clis(lambda side: [
        "-i", str(tmp_path / f"{side}.{ext}"), "-f", "rawvideo",
        "-pix_fmt", pix, str(tmp_path / f"{side}_back.raw")])
    assert rcs == [0, 0]
    back = (tmp_path / "port_back.raw").read_bytes()
    assert back == (tmp_path / "ref_back.raw").read_bytes() == src


def test_cli_input_format_and_pix_fmt_as_the_reference(tmp_path):
    """Two ways in which the reference's CLI differs from FFmpeg's, kept
    by the port (ROADMAP.md §3): `-pix_fmt` before `-i` is an option of
    the output (the rawvideo input stays yuv420p; its `-pixel_format`
    sets the input), and an input's `-f` is kept for the output after
    it, so `-f rawvideo -i x -c:v ffv1 o.mkv` writes the raw FFV1
    packets into o.mkv."""
    rng = np.random.default_rng(9)
    (tmp_path / "src.raw").write_bytes(
        rng.integers(0, 256, 32 * 16 * 3, np.uint8).tobytes())
    rcs = _both_clis(lambda side: [
        "-f", "rawvideo", "-s", "32x16", "-i", str(tmp_path / "src.raw"),
        "-c:v", "ffv1", str(tmp_path / f"{side}.mkv")])
    assert rcs == [0, 0]
    data = (tmp_path / "port.mkv").read_bytes()
    assert data == (tmp_path / "ref.mkv").read_bytes()
    assert data[:4] != b"\x1a\x45\xdf\xa3"          # no EBML header
    # 1536 bytes read as two yuv420p pictures, each converted to rgb24
    rcs = _both_clis(lambda side: [
        "-f", "rawvideo", "-pix_fmt", "rgb24", "-s", "32x16", "-i",
        str(tmp_path / "src.raw"), str(tmp_path / f"{side}.rgb")])
    assert rcs == [0, 0]
    data = (tmp_path / "port.rgb").read_bytes()
    assert data == (tmp_path / "ref.rgb").read_bytes()
    assert len(data) == 2 * 32 * 16 * 3
