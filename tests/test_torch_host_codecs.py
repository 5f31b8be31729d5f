"""The port's host codecs (codecs/flac.py, flac_enc.py, gif.py,
dca_tables.py, dca.py, mlp.py, adpcm_tables.py, adpcm.py) and their
containers (io/formats/flac.py, gif.py, dtsraw.py) against the
reference's, on the CPU.

- Each module is the reference's code: its top-level statements equal
  the reference's as syntax trees, but for those named in CHANGED: the
  codecs take the device that open_decoder and open_encoder hand them
  (DeviceCodec), and the GIF decoder puts its frame's planes on that
  device in one upload, its encoder copying a frame's RGB to the host
  once.
- Each decoder's frames equal the reference decoder's, sample for sample
  and field for field, on the reference binary's streams of
  tests/data/port/host_codecs_streams.npz (DTS 5.1, TrueHD, MLP, ADPCM
  IMA and MS, FLAC, FLAC in Ogg, a GIF) and on FLAC in Matroska and MOV.
  DCA is float64 numpy in both packages, on the same host: the bar is
  equality, and it holds.
- The FLAC, GIF and ADPCM encoders write the reference encoders' bytes.
- The demuxers give the reference's packets and probe scores.
"""

import hashlib

import numpy as np
import pytest
import torch

from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.codecs import gif as ref_gif
from ffmpeg_tpu.core.frame import Frame as RefFrame
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.formats.channel_layout import default_layout as ref_layout
from ffmpeg_tpu.io import open_input as ref_open_input
from ffmpeg_tpu.io import probe_format as ref_probe
from ffmpeg_tpu.io.stream import CodecParameters as RefPar
from ffmpeg_tpu.io.stream import MediaType as RefType
from ffmpeg_tpu.utils.error import EndOfStream as RefEndOfStream
from ffmpeg_tpu.utils.error import TryAgain as RefTryAgain
from ffmpeg_tpu.utils.rational import Rational as RefRational
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import CodecContext, gif
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.formats.channel_layout import default_layout
from ffmpeg_tpu_torch.io import open_input, probe_format
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType
from ffmpeg_tpu_torch.utils.error import EndOfStream, TryAgain
from ffmpeg_tpu_torch.utils.rational import Rational

from torch_io_util import (assert_same_demux, demuxed, differing, mux_with,
                           plain, to_port)

_DEVICE_CODEC = {"<imports>"}
CHANGED = {
    "codecs/flac.py": _DEVICE_CODEC | {"FlacDecoder"},
    "codecs/flac_enc.py": _DEVICE_CODEC | {"FlacEncoder"},
    "codecs/gif.py": _DEVICE_CODEC | {"GifDecoder", "GifEncoder",
                                      "upload_rgba"},
    "codecs/dca_tables.py": set(),
    "codecs/dca.py": _DEVICE_CODEC | {"DcaDecoder"},
    "codecs/mlp.py": _DEVICE_CODEC | {"MlpDecoder"},
    "codecs/adpcm_tables.py": set(),
    "codecs/adpcm.py": _DEVICE_CODEC | {"AdpcmImaWavDecoder",
                                        "_AdpcmEncoderBase",
                                        "AdpcmImaWavEncoder",
                                        "AdpcmMsEncoder"},
    "io/formats/flac.py": set(),
    "io/formats/gif.py": set(),
    "io/formats/dtsraw.py": set(),
}
STREAMS = list(fx.HOST_CODEC_STREAMS) + [fx.HOST_GIF]


@pytest.mark.parametrize("rel", list(CHANGED))
def test_module_is_the_reference_code(rel):
    assert differing(rel) == CHANGED[rel]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_codecs")
    fx.write_host_codec_streams(d)
    (d / "gif_ref.gif").write_bytes(fx.host_codec_file(fx.HOST_GIF))
    return d


def _path(files, name):
    ext = "gif" if name == fx.HOST_GIF else fx.HOST_CODEC_STREAMS[name][0]
    return files / f"{name}.{ext}"


def _fmt(name):
    return None if name == fx.HOST_GIF else fx.HOST_CODEC_STREAMS[name][1]


def _decode_both(path, fmt=None):
    """Both packages' demuxer and decoder on `path`: (ref frames, port
    frames, the port's decoder)."""
    kw = {} if fmt is None else {"format": fmt}
    d = ref_open_input(str(path), **kw)
    ref_pkts = list(d.packets())
    ref = RefContext.open_decoder(d.streams[0].codecpar).decode_all(
        ref_pkts)
    dp = open_input(str(path), **kw)
    ctx = CodecContext.open_decoder(dp.streams[0].codecpar, device="cpu")
    got = ctx.decode_all(list(dp.packets()))
    return ref, got, ctx.codec


@pytest.mark.parametrize("name", STREAMS)
def test_demuxer_gives_the_reference_packets(files, name):
    kw = {} if _fmt(name) is None else {"format": _fmt(name)}
    assert_same_demux(str(_path(files, name)), n_min=1, **kw)
    head = _path(files, name).read_bytes()[:4096]
    want = ref_probe(head, str(_path(files, name)))
    assert probe_format(head, str(_path(files, name))).name == want.name


@pytest.mark.parametrize("name", STREAMS)
def test_decoder_gives_the_reference_frames(files, name):
    ref, got, codec = _decode_both(_path(files, name), _fmt(name))
    assert len(got) == len(ref) >= 1
    assert plain(got) == plain(ref)
    assert codec.device == torch.device("cpu")


@pytest.mark.parametrize("name", list(fx.HOST_CODEC_STREAMS))
def test_cli_decode_equals_the_reference_clis(files, tmp_path, name):
    """The port's CLI on the committed stream writes the bytes whose
    sha256 the fixture holds from the reference's CLI."""
    from ffmpeg_tpu_torch.cli.ffmpeg import main
    args = fx.host_codec_command(files, name)
    args[-1] = str(tmp_path / args[-1].rsplit("/", 1)[1])
    assert main(args, device="cpu") == 0
    data = open(args[-1], "rb").read()
    assert hashlib.sha256(data).hexdigest() == fx.host_codec_golden(name)


@pytest.mark.parametrize("container,name", [("matroska", "o.mkv"),
                                            ("mov", "o.mov")])
def test_flac_in_matroska_and_mov_decodes_as_the_reference(files, tmp_path,
                                                           container, name):
    streams, pkts = demuxed(_path(files, "flac_stereo"))
    out = mux_with(tmp_path, "ref", container, name, streams, pkts)
    assert name in out
    path = tmp_path / "ref" / name
    assert_same_demux(str(path), n_min=len(pkts))
    ref, got, _ = _decode_both(path)
    assert plain(got) == plain(ref) and len(got) == len(pkts)


def test_gif_decoder_puts_its_planes_on_its_device(files):
    d = open_input(str(_path(files, fx.HOST_GIF)))
    ctx = CodecContext.open_decoder(d.streams[0].codecpar, device="cpu")
    frames = ctx.decode_all(list(d.packets()))
    assert len(frames) == 4
    for f in frames:
        assert f.format == "rgba" and len(f.planes) == 4
        assert all(isinstance(p, torch.Tensor) and p.device.type == "cpu"
                   and p.is_contiguous() and p.shape == (64, 96)
                   for p in f.planes)
    canvas = np.arange(5 * 7 * 4, dtype=np.uint8).reshape(5, 7, 4)
    planes = gif.upload_rgba(canvas, "cpu")
    assert [p.numpy().tolist() for p in planes] == \
        [canvas[..., c].tolist() for c in range(4)]


# --- the encoders ----------------------------------------------------------

def _encode(ctx, frames):
    out = []
    for f in [*frames, None]:
        ctx.send_frame(f)
        while True:
            try:
                out.append(ctx.receive_packet())
            except (TryAgain, EndOfStream, RefTryAgain, RefEndOfStream):
                break
    return out


def _audio_encode_both(codec_id, pcm, rate, fmt="s16p"):
    ch = pcm.shape[0]
    ref = RefContext.open_encoder(RefPar(
        codec_type=RefType.AUDIO, codec_id=codec_id, sample_rate=rate,
        ch_layout=ref_layout(ch)))
    port = CodecContext.open_encoder(CodecParameters(
        codec_type=MediaType.AUDIO, codec_id=codec_id, sample_rate=rate,
        ch_layout=default_layout(ch)), device="cpu")
    step = 1000
    want = _encode(ref, [RefFrame.audio(pcm[:, i:i + step], rate, fmt,
                                        ref_layout(ch), pts=i)
                         for i in range(0, pcm.shape[1], step)])
    got = _encode(port, [Frame.audio(pcm[:, i:i + step], rate, fmt,
                                     default_layout(ch), pts=i)
                         for i in range(0, pcm.shape[1], step)])
    return plain(want), plain(got)


@pytest.mark.parametrize("codec_id,ch,rate", [
    ("flac", 1, 44100), ("flac", 2, 48000), ("flac", 2, 16000),
    ("adpcm_ima_wav", 1, 16000), ("adpcm_ima_wav", 2, 44100),
    ("adpcm_ms", 1, 16000), ("adpcm_ms", 2, 44100)])
def test_audio_encoder_writes_the_reference_bytes(codec_id, ch, rate):
    rng = np.random.default_rng(ch * rate)
    n = 4096 * 2 + 777
    t = np.arange(n) / rate
    pcm = np.stack([np.sin(2 * np.pi * (300 + 100 * c) * t) * 12000
                    + rng.standard_normal(n) * 500
                    for c in range(ch)]).astype(np.int16)
    want, got = _audio_encode_both(codec_id, pcm, rate)
    assert got == want and len(want) >= 2


def test_flac_encoder_on_float_input_writes_the_reference_bytes():
    rng = np.random.default_rng(4)
    pcm = (rng.standard_normal((2, 5000)) * 0.3).astype(np.float32)
    want, got = _audio_encode_both("flac", pcm, 32000, "fltp")
    assert got == want


@pytest.mark.parametrize("w,h,n", [(64, 48, 3), (37, 23, 2)])
def test_gif_encoder_writes_the_reference_bytes(tmp_path, w, h, n):
    rgb = fx.gif_clip(n, w, h, seed=w)
    tb = Rational(1, 10)
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="gif",
                          width=w, height=h, pix_fmt="rgb24")
    port = CodecContext.open_encoder(par, device="cpu")
    ref = RefContext.open_encoder(RefPar(
        codec_type=RefType.VIDEO, codec_id="gif", width=w, height=h,
        pix_fmt="rgb24"))
    got = _encode(port, [Frame.video(w, h, "rgb24", planes=[
        torch.from_numpy(np.ascontiguousarray(rgb[i, ..., c]))
        for c in range(3)], pts=i, duration=1, time_base=tb)
        for i in range(n)])
    want = _encode(ref, [RefFrame.video(w, h, "rgb24", planes=[
        rgb[i, ..., c] for c in range(3)], pts=i, duration=1,
        time_base=RefRational(1, 10)) for i in range(n)])
    assert plain(got) == plain(want) and len(got) == n
    streams = [(RefPar(codec_type=RefType.VIDEO, codec_id="gif", width=w,
                       height=h), RefRational(1, 10))]
    files = {side: mux_with(tmp_path, side, "gif", "o.gif", streams, want)
             for side in ("ref", "port")}
    assert files["port"] == files["ref"]


def test_write_cli_gif_writes_the_reference_encoders_file(tmp_path):
    """testing.write_cli_gif (the port's encoder and muxer) on a small
    clip gives the bytes of the reference's encoder and muxer."""
    rgb = fx.gif_clip(3, 40, 30)
    p = fx.write_cli_gif(tmp_path / "p.gif", rgb)
    tb = RefRational(1, 10)
    par = RefPar(codec_type=RefType.VIDEO, codec_id="gif", width=40,
                 height=30, pix_fmt="rgb24", framerate=RefRational(10, 1))
    pkts = _encode(RefContext.open_encoder(par), [RefFrame.video(
        40, 30, "rgb24", planes=[rgb[i, ..., c] for c in range(3)], pts=i,
        duration=1, time_base=tb) for i in range(3)])
    want = mux_with(tmp_path, "ref", "gif", "o.gif", [(par, tb)], pkts)
    assert p.read_bytes() == want["o.gif"]
    ref, got, _ = _decode_both(p)
    assert plain(got) == plain(ref)


def test_flac_encoders_header_packet_fails_the_decoder_as_the_reference():
    """A fault of the reference that the port keeps: the FLAC encoder's
    first packet is its fLaC header and STREAMINFO (MD5 zero), which a
    container stores as a frame and the decoder then refuses."""
    pcm = np.zeros((1, 5000), np.int16)
    want, got = _audio_encode_both("flac", pcm, 16000)
    assert got == want
    head = got[0][1]["data"]
    assert head[:4] == b"fLaC" and head[-16:] == bytes(16)
    errors = []
    for ctx, pkt in ((RefContext, RefPacket), (CodecContext, Packet)):
        dec = (ctx.open_decoder(RefPar(codec_id="flac")) if ctx is RefContext
               else ctx.open_decoder(CodecParameters(codec_id="flac"),
                                     device="cpu"))
        with pytest.raises(Exception) as e:
            dec.decode_all([pkt(data=head)])
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[1] == errors[0] and "bad sync" in errors[0][1]


def test_gif_helpers_equal_the_reference():
    rng = np.random.default_rng(0)
    for n, alphabet in ((1000, 256), (5000, 16), (64, 4)):
        idx = rng.integers(0, alphabet, n).astype(np.uint8)
        mcs = max(2, int(np.ceil(np.log2(alphabet))))
        enc = gif.lzw_encode(idx, mcs)
        assert enc == ref_gif.lzw_encode(idx, mcs)
        assert np.array_equal(gif.lzw_decode(enc, mcs, n),
                              ref_gif.lzw_decode(enc, mcs, n))
    rgb = rng.integers(0, 256, (40, 40, 3)).astype(np.uint8)
    assert np.array_equal(gif._quantize(rgb), ref_gif._quantize(rgb))
    assert np.array_equal(gif._web_palette(), ref_gif._web_palette())


def test_frames_cross_to_the_port_decoder(files):
    """The reference demuxer's packets, carried into the port's classes,
    decode to the reference decoder's frames (the decoders read only
    the packets, not the demuxer that made them)."""
    for name in ("dts_5_1", "adpcm_ms", "flac_ogg"):
        streams, pkts = demuxed(_path(files, name))
        par = streams[0][0]
        want = RefContext.open_decoder(par).decode_all(pkts)
        got = CodecContext.open_decoder(to_port(par), device="cpu"
                                        ).decode_all(to_port(pkts))
        assert plain(got) == plain(want), name
