"""More command lines through both CLIs (the port's with device="cpu"),
on small inputs: the encoders and decoders that tests/test_torch_cli.py
leaves out, and the containers, subtitle formats and streams of
io/formats/ogg.py, mpegts.py, avi.py, flv.py, srt.py, webvtt.py and
assfmt.py.

Bars:
- byte-equal where the path is exact: the H.264 and AAC encoders (into
  Matroska, FLV, ADTS, M4A and MPEG-TS: their extradata and packets),
  the HEVC, MP3, AC-3, E-AC-3 and VP9 decoders, volume, stream copy
  into and out of MPEG-TS, AVI and FLV, the decodes of what those
  files carry, and the subtitle remuxes; where the reference's CLI
  refuses a command, the port's refuses it alike;
- MP2, MP1, HE-AAC (SBR, PS), AAC from MPEG-TS, Vorbis and Opus from
  Ogg to 16-bit PCM: within 1 LSB on at most 1% of samples (the float
  decoders' last bits, test_torch_mp3.py, test_torch_aac_sbr.py,
  test_torch_vorbis.py, test_torch_opus.py); aresample to another rate
  within one 16-bit step (test_torch_cli.py); MPEG-4 Part 2 from AVI
  within 1 LSB on at most 1% of samples (test_torch_mpeg4.py);
- ProRes and DNxHD into MOV: the port's packets are its encoder's on
  the frames the CLI decodes, and its levels within one step of the
  reference's, each difference a tie or truncation boundary that
  float32 cannot decide (torch_port_util.assert_levels_at_ties).
"""

import numpy as np
import pytest

from ffmpeg_tpu.cli.ffmpeg import main as ref_main
from ffmpeg_tpu.io import open_input as ref_open_input
from ffmpeg_tpu.io import open_output as ref_open_output
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.cli.ffmpeg import main
from ffmpeg_tpu_torch.codecs import CodecContext
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.io import open_input

from conftest import own_y4m_clip
from torch_io_util import DATA, seeded_wav
from torch_port_util import assert_levels_at_ties

SRT = ("1\n00:00:01,000 --> 00:00:03,500\nHello <i>world</i>\n\n"
       "2\n00:00:04,000 --> 00:00:06,000\nSecond line\nwith a break\n")
VTT = ("WEBVTT\n\n00:00:01.000 --> 00:00:02.000\nhi\n\nid\n"
       "00:00:03.000 --> 00:00:04.000 align:start\nthere\n")
ASS = ("[Script Info]\nScriptType: v4.00+\n\n[Events]\nFormat: Layer, "
       "Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text\n"
       "Dialogue: 0,0:00:01.00,0:00:03.50,Default,,0,0,0,,Hello\n"
       "Dialogue: 0,0:00:04.00,0:00:05.00,Default,,0,0,0,,{\\i1}x{\\i0}\n")


@pytest.fixture(scope="module")
def inp(tmp_path_factory):
    """The inputs: name → path."""
    d = tmp_path_factory.mktemp("in")
    out = {"y4m": own_y4m_clip(d / "in.y4m"),
           "wav": seeded_wav(d / "in.wav", n=4000),
           "wav48": seeded_wav(d / "w48.wav", rate=48000, n=24000,
                               channels=2),
           "vp9": DATA / "port" / "vp9_crafted_96x72.ivf",
           "h264": DATA / "port" / "h264_crafted_small.h264",
           "hevc": DATA / "port" / "hevc_crafted_64x64.hevc"}
    adts = fx.AAC_CLIP.read_bytes()
    i = 0
    for _ in range(40):
        i += (adts[i + 3] & 3) << 11 | adts[i + 4] << 3 | adts[i + 5] >> 5
    out["aac"] = d / "in.aac"
    out["aac"].write_bytes(adts[:i])
    # the encoder's input: the first 12 of those frames
    j = 0
    for _ in range(12):
        j += (adts[j + 3] & 3) << 11 | adts[j + 4] << 3 | adts[j + 5] >> 5
    out["aac12"] = d / "in12.aac"
    out["aac12"].write_bytes(adts[:j])
    z = np.load(DATA / "port" / "audio_streams.npz")
    for name, ext in (("mp3_reservoir", "mp3"), ("ac3_stereo", "ac3"),
                      ("eac3_5_1", "eac3"), ("mp2_stereo", "mp2"),
                      ("mp1_stereo", "mp2"), ("aac_sbr", "aac"),
                      ("aac_ps", "aac")):
        out[name] = d / f"{name}.{ext}"
        out[name].write_bytes(z[f"{name}_data"].tobytes())
    for name in ("vorbis_stereo", "celt_sine", "silk_cfg1_20ms"):
        out[name] = d / f"{name}.ogg"
        out[name].write_bytes(fx.codec_stream_ogg(fx.codec_stream(name)))
    for name, text in (("srt", SRT), ("vtt", VTT), ("ass", ASS)):
        out[name] = d / f"s.{name}"
        out[name].write_text(text)
    out["mjpeg"] = d / "clip.mjpeg"
    out["y4m10"] = d / "clip10.y4m"
    for argv in (["-i", str(out["y4m"]), "-c:v", "mjpeg", "-q:v", "4",
                  str(out["mjpeg"])],
                 ["-i", str(out["y4m"]), "-pix_fmt", "yuv422p10le",
                  str(out["y4m10"])]):
        assert ref_main(argv) == 0
    # the containers of this slice, written by the reference's CLI
    for name, src, ext in (("h264_ts", "h264", "ts"), ("aac_ts", "aac",
                                                       "ts"),
                           ("mjpeg_avi", "mjpeg", "avi"),
                           ("h264_flv", "h264", "flv"),
                           ("aac_flv", "aac", "flv")):
        out[name] = d / f"{name}.{ext}"
        assert ref_main(["-i", str(out[src]), "-c", "copy",
                         str(out[name])]) == 0
    # the committed MPEG-4 Part 2 stream with B frames, in AVI
    from ffmpeg_tpu.core.packet import Packet as RefPacket
    from ffmpeg_tpu.io.stream import CodecParameters as RefPar
    from ffmpeg_tpu.utils.rational import Rational as RefRational
    st = fx.mpeg4_stream("mpeg4_bframes")
    out["mpeg4_avi"] = d / "mpeg4.avi"
    m = ref_open_output(str(out["mpeg4_avi"]))
    m.add_stream(RefPar(codec_type="video", codec_id="mpeg4",
                        width=st["width"], height=st["height"],
                        extradata=st["extradata"],
                        framerate=RefRational(25, 1)),
                 time_base=RefRational(1, 25))
    for k, (data, pts, typ) in enumerate(zip(st["packets"], st["pts"],
                                             st["types"])):
        m.write_packet(RefPacket(data=data, pts=pts, dts=k,
                                 flags=int(typ == "I"),
                                 time_base=RefRational(1, 25)))
    m.write_trailer()
    m.close()
    return out


def _both(tmp_path, inp, args, outs):
    """The command through both CLIs, each writing into its own
    directory ({d} in an argument); {name} is an input's path.  Returns
    {side: (rc, {output: bytes})}."""
    res = {}
    for side, fn in (("ref", ref_main),
                     ("port", lambda a: main(a, device="cpu"))):
        d = tmp_path / side
        d.mkdir(parents=True)
        argv = [a.format(d=d, **{k: str(v) for k, v in inp.items()})
                for a in args]
        rc = fn(argv)
        res[side] = (rc, {o: (d / o).read_bytes() for o in outs
                          if (d / o).exists()})
    return res


def _cmd(src, *args, out):
    return ["-i", "{%s}" % src, *args, "{d}/" + out], [out]


EXACT = {
    # encoders: packets and extradata
    "h264-enc-mkv": _cmd("y4m", "-frames:v", "2", "-c:v", "h264",
                          out="o.mkv"),
    "h264-enc-flv": _cmd("y4m", "-frames:v", "2", "-c:v", "h264",
                          out="o.flv"),
    "aac-enc-adts": _cmd("aac12", "-c:a", "aac", out="o.aac"),
    "aac-enc-m4a": _cmd("aac12", "-c:a", "aac", out="o.m4a"),
    "aac-enc-mkv": _cmd("aac12", "-c:a", "aac", out="o.mkv"),
    "aac-enc-flv": _cmd("aac12", "-c:a", "aac", out="o.flv"),
    "aac-enc-ts": _cmd("aac12", "-c:a", "aac", out="o.ts"),
    # decoders and filters
    "hevc-framemd5": _cmd("hevc", "-f", "framemd5", out="o.md5"),
    "hevc-y4m": _cmd("hevc", out="o.y4m"),
    "mp3-s16le": _cmd("mp3_reservoir", "-f", "s16le", out="o.sw"),
    "mp3-wav": _cmd("mp3_reservoir", out="o.wav"),
    "ac3-s16le": _cmd("ac3_stereo", "-f", "s16le", out="o.sw"),
    "eac3-ac2": _cmd("eac3_5_1", "-ac", "2", "-f", "s16le", out="o.sw"),
    "vp9-scale": _cmd("vp9", "-vf", "scale=48:36", out="o.y4m"),
    "af-volume": _cmd("wav", "-af", "volume=2,aresample=8000",
                      out="o.wav"),
    "mjpeg-copy-mov": _cmd("mjpeg", "-c", "copy", out="o.mov"),
    # stream copy into the containers of this slice
    "h264-copy-ts": _cmd("h264", "-c", "copy", out="o.ts"),
    "h264-copy-flv": _cmd("h264", "-c", "copy", out="o.flv"),
    "mjpeg-copy-avi": _cmd("mjpeg", "-c", "copy", out="o.avi"),
    "aac-copy-ts": _cmd("aac", "-c", "copy", out="o.ts"),
    "aac-copy-flv": _cmd("aac", "-c", "copy", out="o.flv"),
    "mp3-copy-ts": _cmd("mp3_reservoir", "-c", "copy", out="o.ts"),
    "ac3-copy-ts": _cmd("ac3_stereo", "-c", "copy", out="o.ts"),
    "wav-copy-avi": _cmd("wav", "-c", "copy", out="o.avi"),
    "wav-flv": _cmd("wav48", out="o.flv"),
    "avi-copy-avi": _cmd("mjpeg_avi", "-c", "copy", out="o.avi"),
    # out of them
    "ts-h264-framemd5": _cmd("h264_ts", "-f", "framemd5", out="o.md5"),
    "ts-aac-copy-adts": _cmd("aac_ts", "-c", "copy", out="o.aac"),
    "ts-copy-mkv": _cmd("h264_ts", "-c", "copy", out="o.mkv"),
    "avi-mjpeg-framemd5": _cmd("mjpeg_avi", "-f", "framemd5", out="o.md5"),
    "avi-copy-mkv": _cmd("mjpeg_avi", "-c", "copy", out="o.mkv"),
    "avi-mpeg4-copy-mp4": _cmd("mpeg4_avi", "-c", "copy", out="o.mp4"),
    "flv-h264-framemd5": _cmd("h264_flv", "-f", "framemd5", out="o.md5"),
    "flv-copy-mp4": _cmd("h264_flv", "-c", "copy", out="o.mp4"),
    "flv-aac-copy-m4a": _cmd("aac_flv", "-c", "copy", out="o.m4a"),
    "ogg-copy-mka": _cmd("vorbis_stereo", "-c", "copy", out="o.mkv"),
    # subtitles (mapped: the CLI maps video and audio by default)
    "srt-srt": _cmd("srt", "-map", "0", "-c", "copy", out="o.srt"),
    "srt-vtt": _cmd("srt", "-map", "0", "-c", "copy", out="o.vtt"),
    "vtt-srt": _cmd("vtt", "-map", "0", "-c", "copy", out="o.srt"),
    "vtt-vtt": _cmd("vtt", "-map", "0", "-c", "copy", out="o.vtt"),
    "ass-ass": _cmd("ass", "-map", "0", "-c", "copy", out="o.ass"),
    "ass-srt": _cmd("ass", "-map", "0", "-c", "copy", out="o.srt"),
    "srt-mkv": _cmd("srt", "-map", "0", "-c", "copy", out="o.mkv"),
}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_command_writes_the_reference_bytes(tmp_path, inp, name):
    args, outs = EXACT[name]
    r = _both(tmp_path, inp, args, outs)
    assert r["ref"][0] == r["port"][0] == 0
    assert r["port"][1] == r["ref"][1]
    assert set(r["ref"][1]) == set(outs) and all(r["ref"][1].values())


# the reference's CLI refuses these: the port refuses them alike
REFUSED = {
    "srt-to-ass": _cmd("srt", "-map", "0", "-c", "copy", out="o.ass"),
    "rawvideo-to-flv": _cmd("y4m", out="o.flv"),
    "pcm-to-ts": _cmd("wav48", out="o.ts"),
    "eac3-copy-ts": _cmd("eac3_5_1", "-c", "copy", out="o.ts"),
    "aac-copy-avi": _cmd("aac", "-c", "copy", out="o.avi"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_command_refused_as_the_reference(tmp_path, inp, name):
    args, outs = REFUSED[name]
    r = _both(tmp_path, inp, args, outs)
    assert r["ref"][0] == r["port"][0] == 1
    assert r["port"][1] == r["ref"][1]


def _s16(data: bytes, header: int) -> np.ndarray:
    return np.frombuffer(data[header:], "<i2").astype(np.int32)


@pytest.mark.parametrize("src,out", [
    ("mp2_stereo", "o.sw"), ("mp1_stereo", "o.sw"), ("aac_sbr", "o.sw"),
    ("aac_ps", "o.sw"), ("aac_ts", "o.sw"), ("aac_flv", "o.sw"),
    ("vorbis_stereo", "o.wav"), ("celt_sine", "o.wav"),
    ("silk_cfg1_20ms", "o.wav")])
def test_float_decoders_within_one_lsb(tmp_path, inp, src, out):
    args = ["-f", "s16le"] if out == "o.sw" else []
    r = _both(tmp_path, inp, *_cmd(src, *args, out=out))
    assert r["ref"][0] == r["port"][0] == 0
    got, want = r["port"][1][out], r["ref"][1][out]
    header = 44 if out.endswith(".wav") else 0
    assert got[:header] == want[:header]
    a, b = _s16(got, header), _s16(want, header)
    assert a.shape == b.shape and a.size > 2000
    d = np.abs(a - b)
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(),
                                                      (d > 0).mean())


def test_aresample_to_another_rate_within_one_lsb(tmp_path, inp):
    """The 8 kHz 16-bit WAV through volume and aresample to 16 kHz float:
    within one step of the input's 16-bit samples (test_torch_cli.py's
    aresample bar)."""
    r = _both(tmp_path, inp, *_cmd("wav", "-af",
                                   "volume=0.5,aresample=16000", "-f",
                                   "f32le", out="o.f32"))
    assert r["ref"][0] == r["port"][0] == 0
    a = np.frombuffer(r["port"][1]["o.f32"], "<f4").astype(np.float64)
    b = np.frombuffer(r["ref"][1]["o.f32"], "<f4").astype(np.float64)
    assert a.shape == b.shape == (8000,)
    d = np.abs(a - b) * 32768
    assert d.max() <= 1 + 1e-6 and (d > 0).mean() <= 0.01


def test_mpeg4_from_avi_within_one_lsb(tmp_path, inp):
    """The committed MPEG-4 Part 2 stream with B frames, read from AVI and
    decoded: within 1 LSB on at most 1% of samples (the IDCT's float32
    order; test_torch_mpeg4.py's bar)."""
    r = _both(tmp_path, inp, *_cmd("mpeg4_avi", "-f", "rawvideo",
                                   out="o.yuv"))
    assert r["ref"][0] == r["port"][0] == 0
    a = np.frombuffer(r["port"][1]["o.yuv"], np.uint8).astype(np.int16)
    b = np.frombuffer(r["ref"][1]["o.yuv"], np.uint8).astype(np.int16)
    assert a.shape == b.shape == (15 * 176 * 144 * 3 // 2,)
    d = np.abs(a - b)
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


def _mov_packets(path) -> list:
    d = open_input(str(path))
    pkts = [p.data for p in d.packets()]
    d.close()
    return pkts


def _prores_levels(planes, w, h, fmt):
    """Both encoders' levels of one frame (the reference's device
    analysis as its encode runs it) with the float64 decisions."""
    from test_torch_prores import _encoders, _ref_levels
    from ffmpeg_tpu.codecs import prores_enc as ref_enc
    ref, port = _encoders(w, h, fmt, 4)
    want, pads = _ref_levels(ref.codec, planes)
    got = port.codec.transform(Frame.video(w, h, fmt, planes=planes))
    for a, b, pad in zip(got, want, pads):
        x, tol = fx.prores_decisions(fx.plane_blocks(pad),
                                     ref_enc._QMAT_FLAT4, 4, False)
        assert_levels_at_ties(np.asarray(a), b, x, tol, "trunc")


def _dnxhd_levels(planes, w, h, fmt):
    from test_torch_dnxhd import _check_levels, _encoders, _ref_coefs
    _ref, port = _encoders(w, h, fmt, 4)
    want, blocks = _ref_coefs(w, h, planes)
    got = port.codec.transform(Frame.video(w, h, fmt, planes=planes))
    _check_levels(port.codec, got, want, blocks)


@pytest.mark.parametrize("codec", ["prores", "dnxhd"])
def test_intra_encoder_into_mov_within_the_tie_bar(tmp_path, inp, codec):
    """The 128x96 clip at yuv422p10le into MOV: both CLIs write a packet
    per frame; the port's packets are the port encoder's on the frames
    its CLI decodes, and on each frame the port's levels are within the
    tie bar of the reference's."""
    r = _both(tmp_path, inp, *_cmd("y4m10", "-c:v", codec, out="o.mov"))
    assert r["ref"][0] == r["port"][0] == 0
    pk = {s: _mov_packets(tmp_path / s / "o.mov") for s in ("ref", "port")}
    assert len(pk["port"]) == len(pk["ref"]) == 5
    par, frames = fx.cli_encoder_input(inp["y4m10"], codec, "cpu")
    ctx = CodecContext.open_encoder(par, {}, device="cpu")
    assert pk["port"] == [p.data for p in fx.encode_all(ctx, frames)]
    d = ref_open_input(str(inp["y4m10"]))
    w, h = d.streams[0].codecpar.width, d.streams[0].codecpar.height
    from ffmpeg_tpu.codecs import CodecContext as RefContext
    for f in RefContext.open_decoder(d.streams[0].codecpar).decode_all(
            list(d.packets())):
        planes = [np.asarray(p) for p in f.planes]
        (_prores_levels if codec == "prores" else _dnxhd_levels)(
            planes, w, h, "yuv422p10le")


def test_phase27_goldens_hold_the_port_on_the_cpu(tmp_path, capsys):
    """chip_smoke.py's phase 27 goldens (tools/gen_torch_cli_fixture.py)
    against the port's CLI on the CPU where that is cheap: (g)'s AVI and
    (i)'s MPEG-TS (sha256), (j)'s sample counts of three Ogg files, and
    (k)'s probe of the AVI, the AAC TS and the Ogg Vorbis file."""
    import hashlib
    import json
    from ffmpeg_tpu_torch.cli.ffprobe import main as probe
    gold = json.loads(fx.CLI_GOLDEN.read_text())
    cmds = fx.cli_container_commands(tmp_path)
    fx.write_cli_ogg(tmp_path)
    for name, out in (("g_avi", "out.avi"), ("i_ts", "out_aac.ts")):
        assert main(cmds[name], device="cpu") == 0
        assert hashlib.sha256((tmp_path / out).read_bytes()).hexdigest() \
            == gold[f"{name}_sha256"]
    for name in ("vorbis_noise", "celt_16k", "hybrid_cfg13"):
        assert main(cmds[f"j_{name}"], device="cpu") == 0
        size = (tmp_path / f"{name}.f32").stat().st_size
        assert size == 4 * fx.codec_stream(name)["channels"] * \
            gold["j_samples"][name]
    assert set(gold["k_probe"]) == set(fx.CLI_PROBE_FILES)
    assert set(gold["j_samples"]) == set(fx.CLI_OGG_STREAMS)
    for f in ("out.avi", "out_aac.ts", "vorbis_sine.ogg"):
        capsys.readouterr()
        assert probe([*fx.CLI_PROBE_ARGS, str(tmp_path / f)],
                     device="cpu") == 0
        assert capsys.readouterr().out == gold["k_probe"][f], f
    ts = fx.probe_without_sizes(gold["k_probe"]["out_mpeg2.ts"])
    assert ts["streams"][0]["codec_name"] == "mpeg2video"
    assert len(ts["packets"]) == fx.CLI_MPEG2_FRAMES
