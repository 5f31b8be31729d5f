"""The port's CLIs (ffmpeg_tpu_torch/cli/ffmpeg.py and ffprobe.py, with
sync_queue.py and textformat.py) against the reference's, on the CPU:
the same command lines through both, the port's with device="cpu", on
the same small inputs (the 128x96 clip of tests/test_cli.py, the
committed crafted VP9 and H.264 streams, a seeded WAV, a Matroska file
of both, the first frames of the committed ADTS clip).

Bars:
- byte-equal where the path is exact: stream copy, framecrc/framemd5
  (pts, duration, size and hash of every packet), y4m, wav, s16le, the
  Matroska and MP4 remuxes, -ss/-t, -frames, -map, -shortest, -progress,
  -print_graphs_file, and every fftpu-probe section and writer;
- where a float32 device stage decides, the bar of the port's own test
  of that stage: scale and format within 1 LSB on <= 1% of samples
  (test_torch_filters.py); the MJPEG decode likewise
  (test_torch_mjpeg_decode.py); aresample within 1 LSB of s16 and 1e-5
  of float (test_torch_filters.py, test_torch_audio_frontend.py); the
  MJPEG encoder's packets within 1e-3 of the reference's sizes
  (test_torch_mjpeg_enc.py) and the MPEG-2 encoder's within 1%, with
  equal flags and the stream's PSNR within 0.1 dB (test_torch_mpeg2_enc.
  py); and there the port's CLI writes what the port's own encoder makes
  of the frames the CLI decoded, byte for byte;
- -bsf:v, -bsf:a and -bsf byte-equal to the reference CLI's output
  (codecs/bsf.py; test_torch_bsf_av1.py holds every filter).
"""

import inspect
import json
import re

import numpy as np
import pytest

from ffmpeg_tpu.cli import ffmpeg as ref_cli
from ffmpeg_tpu.cli.ffmpeg import main as ref_main
from ffmpeg_tpu.cli.ffprobe import main as ref_probe
from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.io import open_input as ref_open_input
from ffmpeg_tpu.io import open_output as ref_open_output
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.cli import ffmpeg as cli
from ffmpeg_tpu_torch.cli.ffmpeg import main
from ffmpeg_tpu_torch.cli.ffprobe import main as probe
from ffmpeg_tpu_torch.codecs import CodecContext
from ffmpeg_tpu_torch.io import open_input
from ffmpeg_tpu_torch.utils.error import NotSupported

from conftest import own_y4m_clip
from torch_io_util import DATA, differing, plain, seeded_wav

CLI_MODULES = {
    "cli/sync_queue.py": set(), "cli/textformat.py": set(),
    "cli/ffmpeg.py": {"<imports>", "_build_fc_chain", "_build_chain",
                      "transcode", "main"},
    "cli/ffprobe.py": {"<imports>", "main"},
}


@pytest.mark.parametrize("rel", sorted(CLI_MODULES))
def test_cli_module_is_the_reference_code_but_where_named(rel):
    assert differing(rel) == CLI_MODULES[rel]


@pytest.fixture(scope="module")
def inp(tmp_path_factory):
    """The inputs: name → path."""
    d = tmp_path_factory.mktemp("in")
    out = {"y4m": own_y4m_clip(d / "in.y4m"),
           "wav": seeded_wav(d / "in.wav", n=4000),
           "vp9": DATA / "port" / "vp9_crafted_96x72.ivf",
           "h264": DATA / "port" / "h264_crafted_small.h264"}
    # 40 frames of the committed ADTS clip
    adts = fx.AAC_CLIP.read_bytes()
    i = 0
    for _ in range(40):
        i += (adts[i + 3] & 3) << 11 | adts[i + 4] << 3 | adts[i + 5] >> 5
    out["aac"] = d / "in.aac"
    out["aac"].write_bytes(adts[:i])
    # the H.264 stream and 1 s of the WAV's PCM in one Matroska file
    out["av"] = d / "av.mkv"
    vd = ref_open_input(str(out["h264"]))
    ad = ref_open_input(str(seeded_wav(d / "long.wav", n=8000)))
    m = ref_open_output(str(out["av"]))
    m.add_stream(vd.streams[0].codecpar, time_base=vd.streams[0].time_base)
    m.add_stream(ad.streams[0].codecpar, time_base=ad.streams[0].time_base)
    for p in ad.packets():
        p.stream_index = 1
        m.write_packet(p)
    for p in vd.packets():
        m.write_packet(p)
    m.write_trailer()
    m.close()
    out["mjpeg"] = d / "clip.mjpeg"
    assert ref_main(["-i", str(out["y4m"]), "-c:v", "mjpeg", "-q:v", "4",
                     "-y", str(out["mjpeg"])]) == 0
    out["mpeg2"] = fx.write_y4m(d / "mpeg2.y4m", fx.mpeg2_clip(3, 64, 48))
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


EXACT = {
    "copy-framecrc": (["-i", "{y4m}", "-c", "copy", "-f", "framecrc",
                       "{d}/o.crc"], ["o.crc"]),
    "frames-limit": (["-i", "{y4m}", "-frames:v", "2", "-y", "{d}/o.y4m"],
                     ["o.y4m"]),
    "ss-t-input": (["-ss", "0.08", "-t", "0.08", "-i", "{y4m}", "-y",
                    "{d}/o.y4m"], ["o.y4m"]),
    "y4m-framemd5": (["-i", "{y4m}", "-f", "framemd5", "{d}/o.md5"],
                     ["o.md5"]),
    "y4m-md5-crc": (["-i", "{y4m}", "-f", "md5", "{d}/o.md5"], ["o.md5"]),
    "vp9-framemd5": (["-i", "{vp9}", "-frames:v", "3", "-f", "framemd5",
                      "{d}/o.md5"], ["o.md5"]),
    "vp9-copy-ivf": (["-i", "{vp9}", "-c", "copy", "{d}/o.ivf"], ["o.ivf"]),
    "vp9-copy-mkv": (["-i", "{vp9}", "-c", "copy", "{d}/o.mkv"], ["o.mkv"]),
    "h264-copy-mkv": (["-i", "{h264}", "-c", "copy", "{d}/o.mkv"],
                      ["o.mkv"]),
    "h264-copy-mp4": (["-i", "{h264}", "-c", "copy", "{d}/o.mp4"],
                      ["o.mp4"]),
    "h264-framemd5": (["-i", "{h264}", "-f", "framemd5", "{d}/o.md5"],
                      ["o.md5"]),
    "wav-copy": (["-i", "{wav}", "-c", "copy", "-y", "{d}/o.wav"],
                 ["o.wav"]),
    "wav-framemd5": (["-i", "{wav}", "-f", "framemd5", "{d}/o.md5"],
                     ["o.md5"]),
    "wav-s16le": (["-i", "{wav}", "-f", "s16le", "{d}/o.sw"], ["o.sw"]),
    "wav-copy-mkv": (["-i", "{wav}", "-c", "copy", "{d}/o.mkv"], ["o.mkv"]),
    "aac-copy-adts": (["-i", "{aac}", "-c", "copy", "{d}/o.aac"], ["o.aac"]),
    "aac-copy-m4a": (["-i", "{aac}", "-c", "copy", "{d}/o.m4a"], ["o.m4a"]),
    "av-framemd5": (["-i", "{av}", "-f", "framemd5", "{d}/o.md5"],
                    ["o.md5"]),
    "av-copy-mp4": (["-i", "{av}", "-c", "copy", "{d}/o.mp4"], ["o.mp4"]),
    "map-two-outputs": (["-v", "error", "-i", "{av}", "-map", "0:v:0",
                         "-c:v", "copy", "-y", "{d}/v.mkv", "-map", "0:a:0",
                         "-c:a", "pcm_s16le", "-y", "{d}/a.wav"],
                        ["v.mkv", "a.wav"]),
    "shortest": (["-v", "error", "-i", "{av}", "-c", "copy", "-shortest",
                  "-y", "{d}/s.mkv"], ["s.mkv"]),
    "progress": (["-i", "{y4m}", "-progress", "{d}/p.txt", "-y",
                  "{d}/o.y4m"], ["p.txt", "o.y4m"]),
    "mjpeg-copy-mkv": (["-i", "{mjpeg}", "-c", "copy", "{d}/o.mkv"],
                       ["o.mkv"]),
}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_command_writes_the_reference_bytes(tmp_path, inp, name):
    args, outs = EXACT[name]
    r = _both(tmp_path, inp, args, outs)
    assert r["ref"][0] == r["port"][0] == 0
    assert r["port"][1] == r["ref"][1]
    assert set(r["ref"][1]) == set(outs) and all(r["ref"][1].values())


def test_print_graphs_file_equals_the_reference(tmp_path, inp):
    r = _both(tmp_path, inp, ["-i", "{y4m}", "-vf", "scale=64:48",
                              "-print_graphs_file", "{d}/g.json", "-y",
                              "{d}/o.y4m"], ["g.json"])
    assert r["ref"][0] == r["port"][0] == 0
    docs = [json.loads(r[s][1]["g.json"].decode().replace(
        str(tmp_path / s), "D")) for s in ("ref", "port")]
    assert docs[1] == docs[0]
    assert docs[0]["chains"][0]["mode"] == "transcode"


def test_ffreport_logs_the_command_line(tmp_path, inp, monkeypatch):
    from ffmpeg_tpu.utils import log as ref_log
    from ffmpeg_tpu_torch.utils import log
    reports = []
    for side, fn, mod in (("ref", ref_main, ref_log),
                          ("port", lambda a: main(a, device="cpu"), log)):
        rep = tmp_path / f"{side}.log"
        monkeypatch.setenv("FFREPORT", f"file={rep}")
        # the report stays open after the run: close it with the test
        monkeypatch.setattr(mod, "_report_file", mod._report_file)
        assert fn(["-i", str(inp["y4m"]), "-y",
                   str(tmp_path / f"{side}.y4m")]) == 0
        reports.append(rep.read_text().replace(
            str(tmp_path / f"{side}.y4m"), "OUT"))
    assert "fftpu command line" in reports[0]
    assert reports[1] == reports[0]


def _lsb(got: bytes, want: bytes, frac=0.01):
    a = np.frombuffer(got, np.uint8).astype(np.int16)
    b = np.frombuffer(want, np.uint8).astype(np.int16)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max() <= 1 and (d > 0).mean() <= frac, (d.max(),
                                                      (d > 0).mean())


@pytest.mark.parametrize("args,out", [
    (["-i", "{y4m}", "-vf", "scale=64:48", "-y", "{d}/o.y4m"], "o.y4m"),
    (["-i", "{y4m}", "-s", "80x60", "-pix_fmt", "yuv444p", "-y",
      "{d}/o.y4m"], "o.y4m"),
    (["-i", "{y4m}", "-filter_complex", "[0:v]scale=48:32[o]", "-map",
      "[o]", "-y", "{d}/o.y4m"], "o.y4m"),
    (["-i", "{y4m}", "-pix_fmt", "rgb24", "-f", "rawvideo", "{d}/o.rgb"],
     "o.rgb"),
    (["-i", "{mjpeg}", "-vf", "scale=32:24", "-pix_fmt", "rgb24", "-f",
      "rawvideo", "{d}/o.rgb"], "o.rgb"),
    (["-i", "{mjpeg}", "-f", "rawvideo", "{d}/o.yuv"], "o.yuv"),
], ids=["scale", "size-pix_fmt", "filter_complex", "rgb24", "mjpeg-scale",
        "mjpeg-decode"])
def test_video_filters_and_decoders_within_one_lsb(tmp_path, inp, args, out):
    r = _both(tmp_path, inp, args, [out])
    assert r["ref"][0] == r["port"][0] == 0
    got, want = r["port"][1][out], r["ref"][1][out]
    if out.endswith(".y4m"):
        # frame headers equal, samples within the scale bar
        assert got.split(b"FRAME")[0] == want.split(b"FRAME")[0]
        assert got.count(b"FRAME\n") == want.count(b"FRAME\n") == 5
        got, want = got.replace(b"FRAME\n", b""), want.replace(b"FRAME\n",
                                                               b"")
    _lsb(got, want)


def test_audio_resample_within_one_lsb(tmp_path, inp):
    r = _both(tmp_path, inp, ["-i", "{wav}", "-ar", "16000", "-y",
                              "{d}/o.wav"], ["o.wav"])
    assert r["ref"][0] == r["port"][0] == 0
    got, want = r["port"][1]["o.wav"], r["ref"][1]["o.wav"]
    assert got[:44] == want[:44]
    a = np.frombuffer(got[44:], "<i2").astype(np.int32)
    b = np.frombuffer(want[44:], "<i2").astype(np.int32)
    assert a.shape == b.shape == (8000,)
    assert np.abs(a - b).max() <= 1


def test_aac_frontend_command_within_the_frontend_bar(tmp_path, inp):
    """Command (e) of chip_smoke.py's phase 26 on the clip's first 40
    frames: AAC decode, downmix and resample to 16 kHz mono float."""
    r = _both(tmp_path, inp, ["-i", "{aac}", "-ar", "16000", "-ac", "1",
                              "-f", "f32le", "{d}/o.f32"], ["o.f32"])
    assert r["ref"][0] == r["port"][0] == 0
    a = np.frombuffer(r["port"][1]["o.f32"], "<f4")
    b = np.frombuffer(r["ref"][1]["o.f32"], "<f4")
    assert a.shape == b.shape and a.size > 13000
    assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(b).max())


def _direct_encode(y4m, codec, opts):
    """The port's encoder on the frames the port's CLI decodes from the
    y4m, with the CLI's parameters: its packets' bytes."""
    par, frames = fx.cli_encoder_input(y4m, codec, "cpu")
    ctx = CodecContext.open_encoder(par, dict(opts), device="cpu")
    return [p.data for p in fx.encode_all(ctx, frames)]


def test_mjpeg_encode_within_the_encoder_bar(tmp_path, inp):
    r = _both(tmp_path, inp, ["-i", "{y4m}", "-c:v", "mjpeg", "-q:v", "3",
                              "-y", "{d}/o.mjpeg"], ["o.mjpeg"])
    assert r["ref"][0] == r["port"][0] == 0
    pk = {}
    for side in ("ref", "port"):
        d = open_input(str(tmp_path / side / "o.mjpeg"))
        pk[side] = [p.data for p in d.packets()]
    assert len(pk["port"]) == len(pk["ref"]) == 5
    for a, b in zip(pk["port"], pk["ref"]):
        assert abs(len(a) / len(b) - 1) <= 1e-3
    assert pk["port"] == _direct_encode(inp["y4m"], "mjpeg",
                                        {"quality": 91})


def test_mpeg2_encode_within_the_encoder_bar(tmp_path, inp):
    """Command (d) of phase 26 at 64x48: -c:v mpeg2video into Matroska
    (the reference has no raw MPEG video muxer: .m2v raises
    MuxerNotFound in both CLIs)."""
    r = _both(tmp_path, inp, ["-i", "{mpeg2}", "-c:v", "mpeg2video",
                              "{d}/o.mkv"], ["o.mkv"])
    assert r["ref"][0] == r["port"][0] == 0
    pk, psnr = {}, {}
    src = fx.mpeg2_clip(3, 64, 48)
    for side in ("ref", "port"):
        d = ref_open_input(str(tmp_path / side / "o.mkv"))
        pk[side] = list(d.packets())
        frames = RefContext.open_decoder(d.streams[0].codecpar).decode_all(
            pk[side])
        psnr[side] = np.mean([fx.recon_psnr([np.asarray(p) for p in
                                             f.planes], s)
                              for f, s in zip(frames, src)])
    assert len(pk["port"]) == len(pk["ref"]) == 3
    for a, b in zip(pk["port"], pk["ref"]):
        assert abs(len(a.data) / len(b.data) - 1) <= 0.01
        assert (a.flags, a.pts, a.dts) == (b.flags, b.pts, b.dts)
    assert abs(psnr["port"] - psnr["ref"]) <= 0.1
    assert [p.data for p in pk["port"]] == _direct_encode(
        inp["mpeg2"], "mpeg2video", {})
    for fn in (ref_main, lambda a: main(a, device="cpu")):
        assert fn(["-i", str(inp["mpeg2"]), "-c:v", "mpeg2video",
                   str(tmp_path / "o.m2v")]) == 1


PROBES = [
    ("streams-format-" + w, ["-show_streams", "-show_format", "-of", w,
                             "{y4m}"])
    for w in ("default", "json", "csv", "flat", "ini", "compact", "xml",
              "mermaid")] + [
    ("packets-csv", ["-show_packets", "-of", "csv", "{y4m}"]),
    ("frames-mjpeg", ["-show_frames", "-of", "json", "-f", "mjpeg",
                      "{mjpeg}"]),
    ("frames-packets-vp9", ["-show_frames", "-show_packets", "-of", "json",
                            "{vp9}"]),
    ("frames-packets-h264", ["-show_frames", "-show_packets", "-of",
                             "json", "{h264}"]),
    ("packets-wav", ["-show_packets", "-show_streams", "-of", "json",
                     "{wav}"]),
    ("packets-aac", ["-show_packets", "-show_streams", "-of", "json",
                     "{aac}"]),
    ("frames-y4m", ["-show_frames", "-of", "flat", "{y4m}"]),
    ("av-all", ["-show_packets", "-show_streams", "-show_format",
                "-show_chapters", "-of", "json", "{av}"]),
    ("av-frames-v", ["-show_frames", "-select_streams", "v", "-of", "json",
                     "{av}"]),
    ("select-a", ["-show_streams", "-select_streams", "a", "-of", "json",
                  "{av}"]),
    ("select-v0", ["-show_streams", "-select_streams", "v:0", "-of", "json",
                   "{av}"]),
    ("select-1", ["-show_packets", "-select_streams", "1", "-of", "csv",
                  "{av}"]),
]


@pytest.mark.parametrize("name,args", PROBES, ids=[p[0] for p in PROBES])
def test_probe_prints_the_reference_text(inp, capsys, name, args):
    argv = [a.format(**{k: str(v) for k, v in inp.items()}) for a in args]
    assert ref_probe(argv) == 0
    want = capsys.readouterr().out
    assert probe(argv, device="cpu") == 0
    got = capsys.readouterr().out
    assert got == want and len(want) > 40


@pytest.mark.parametrize("name", ["wav", "aac", "av"])
def test_probe_frames_of_audio_fail_as_the_reference(inp, name):
    """-show_frames on an audio stream: the reference's _frame_dict reads
    `fr.channels`, which Frame does not have (cli/ffprobe.py:76), so the
    probe ends with AttributeError; the port's copy does the same."""
    for fn in (ref_probe, lambda a: probe(a, device="cpu")):
        with pytest.raises(AttributeError, match="channels"):
            fn(["-show_frames", "-of", "json", str(inp[name])])


def test_probe_of_the_remuxes_prints_the_reference_text(tmp_path, inp,
                                                        capsys):
    """Command (f) of phase 26 at small size: the probe of the H.264
    stream's Matroska and MP4 remuxes (each side probing its own)."""
    r = _both(tmp_path, inp, ["-i", "{h264}", "-c", "copy", "{d}/o.mkv"],
              ["o.mkv"])
    assert r["ref"][0] == r["port"][0] == 0
    for side, fn in (("ref", ref_probe),
                     ("port", lambda a: probe(a, device="cpu"))):
        assert fn(["-show_streams", "-show_packets", "-of", "json",
                   str(tmp_path / side / "o.mkv")]) == 0
    texts = capsys.readouterr().out
    half = len(texts) // 2
    assert texts[:half] == texts[half:]


@pytest.mark.parametrize("bsf", ["-bsf:v", "-bsf:a", "-bsf"])
def test_bsf_raises_named_not_supported(tmp_path, inp, bsf):
    """Once refused while codecs/bsf.py was unported: the seeded noise
    filter on a copied stream (video, audio, or every stream) writes the
    reference CLI's bytes."""
    src = "{wav}" if bsf == "-bsf:a" else "{y4m}"
    out = "o.wav" if bsf == "-bsf:a" else "o.y4m"
    r = _both(tmp_path, inp, ["-i", src, "-c", "copy", bsf,
                              "noise=amount=50:seed=7", "-y",
                              "{d}/" + out], [out])
    assert r["ref"][0] == r["port"][0] == 0
    assert r["port"][1][out] == r["ref"][1][out]
    clean = tmp_path / "clean"
    clean.mkdir()
    argv = ["-i", str(inp["wav" if bsf == "-bsf:a" else "y4m"]), "-c",
            "copy", "-y", str(clean / out)]
    assert main(argv, device="cpu") == 0
    assert (clean / out).read_bytes() != r["port"][1][out]


def test_map_of_a_second_input_raises_not_supported(tmp_path, inp):
    """-map 1:v names an input the CLI does not have.  The reference means
    to raise NotSupported but never imports it (cli/ffmpeg.py:301), so
    it raises NameError; the port raises NotSupported and returns 1."""
    argv = ["-i", str(inp["y4m"]), "-map", "1:v", "-y",
            str(tmp_path / "o.y4m")]
    with pytest.raises(NameError, match="NotSupported"):
        ref_main(argv)
    assert main(argv, device="cpu") == 1
    with pytest.raises(NotSupported, match="single-input"):
        cli.transcode(cli.parse_args(argv), "cpu")


def test_options_parse_as_the_reference():
    argv = ["-y", "-v", "error", "-ss", "1.5", "-t", "2", "-f", "y4m",
            "-s", "64x48", "-r", "30000/1001", "-ar", "8000", "-ac", "2",
            "-pixel_format", "gray", "-i", "a.y4m", "-c:v", "mjpeg",
            "-c:a", "pcm_f32le", "-vf", "hflip", "-af", "anull", "-q:v",
            "5", "-frames:v", "3", "-shortest", "-an", "-map", "0:v:0",
            "-g", "12", "-fflags", "+bitexact", "-filter_complex",
            "[0:v]null[o]", "o.mkv", "-c", "copy", "-bsf", "x", "p.mp4"]
    assert plain(cli.parse_args(argv)) == plain(ref_cli.parse_args(argv))


def test_help_lists_the_ported_formats_and_codecs(capsys):
    assert main([]) == 0
    text = capsys.readouterr().out
    assert text.startswith("usage: fftpu-torch")
    for line in ("demuxers: aac, ac3, ass, avi, concat, dash, dts, eac3",
                 "muxers: adts, ass, avi, crc, dash, f32le, fifo, flv",
                 "pcm_s16le", "rawvideo", "mpeg2video", "scale"):
        assert line in text


def test_main_runs_on_the_card_unless_told_otherwise(tmp_path, inp):
    """Both CLIs default to device="cuda"; here, with no card, the run
    stops with the device's error, which is no FFTPUError, and nothing
    carries on on the CPU."""
    from ffmpeg_tpu_torch.cli import ffprobe
    for fn in (main, cli.transcode, ffprobe.main):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        main(["-i", str(inp["y4m"]), "-y", str(tmp_path / "o.y4m")])
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        probe(["-show_frames", str(inp["y4m"])])


def test_decode_backstop_passes_a_torch_without_cuda_through(inp):
    """A fault of the port found with the CLI: on a torch built without
    CUDA a tensor on the card raises AssertionError ("Torch not compiled
    with CUDA enabled"), which the decode backstop read as malformed
    input (InvalidData, so the CLI printed an error and returned 1).  It
    passes through now, as a RuntimeError from CUDA always did."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    d = open_input(str(inp["y4m"]))
    dec = CodecContext.open_decoder(d.streams[0].codecpar)
    with pytest.raises(AssertionError, match="CUDA"):
        dec.send_packet(next(d.packets()))


def test_decoded_frames_carry_the_reference_metadata(inp):
    """Every field of every decoded frame but its planes (pts, duration,
    time base, key_frame, pict_type, aspect ratio, colour fields, sample
    rate, layout, format) equals the reference decoder's, for each input
    the commands above decode."""
    skip = {"planes", "opaque"}
    for name in ("y4m", "wav", "vp9", "h264", "mjpeg", "aac", "mpeg2"):
        out = []
        for opener, ctx, kw in ((ref_open_input, RefContext, {}),
                                (open_input, CodecContext,
                                 {"device": "cpu"})):
            d = opener(str(inp[name]))
            dec = ctx.open_decoder(d.streams[0].codecpar, **kw)
            frames = dec.decode_all(list(d.packets())[:6])
            out.append([{k: v for k, v in plain(f)[1].items()
                         if k not in skip} for f in frames])
        assert out[1] == out[0] and out[0], name


def test_encoded_packets_carry_the_reference_metadata(tmp_path, inp):
    """The rawvideo and PCM encoders' packets (pts, dts, duration, flags,
    time base): the framecrc lines of a decode → encode of each input."""
    for name in ("y4m", "wav", "vp9", "aac"):
        r = _both(tmp_path / name, inp, ["-i", "{%s}" % name, "-f",
                                         "framecrc", "{d}/o.crc"],
                  ["o.crc"])
        if name == "aac":
            # the decoded samples differ in the last bits; the lines'
            # timestamps, durations and sizes do not
            r = {s: (rc, {"o.crc": re.sub(rb"0x[0-9a-f]{8}", b"",
                                          o["o.crc"])})
                 for s, (rc, o) in r.items()}
        assert r["port"] == r["ref"], name


def test_y4m_writer_equals_the_reference_muxer(tmp_path):
    """testing.write_y4m (chip_smoke.py's input of command (d)) writes the
    bytes the reference's y4m muxer writes (tools/gen_torch_cli_fixture.
    py's input of the same command)."""
    from ffmpeg_tpu.core.frame import Frame as RefFrame
    from ffmpeg_tpu.core.packet import Packet as RefPacket
    from ffmpeg_tpu.io.stream import CodecParameters as RefPar
    from ffmpeg_tpu.utils.rational import Rational as RefRational
    clip = fx.mpeg2_clip(2, 64, 48)
    fx.write_y4m(tmp_path / "port.y4m", clip)
    m = ref_open_output(str(tmp_path / "ref.y4m"), format="yuv4mpegpipe")
    m.add_stream(RefPar(codec_type="video", codec_id="rawvideo", width=64,
                        height=48, pix_fmt="yuv420p",
                        framerate=RefRational(25, 1)),
                 time_base=RefRational(1, 25))
    for i, f in enumerate(clip):
        m.write_packet(RefPacket(data=RefFrame.video(
            64, 48, "yuv420p", planes=list(f.planes)).to_bytes(), pts=i,
            dts=i, duration=1))
    m.write_trailer()
    m.close()
    assert (tmp_path / "port.y4m").read_bytes() == \
        (tmp_path / "ref.y4m").read_bytes()


def test_cli_golden_holds_the_port_on_the_cpu(tmp_path, capsys):
    """Phase 26's committed goldens (tools/gen_torch_cli_fixture.py)
    against the port's CLI on the CPU where that is cheap: command (b) on
    the crafted VP9 stream, (c)'s Matroska and MP4 remuxes of the 1080p
    H.264 stream (sha256) and (f)'s probe of them."""
    import hashlib
    gold = json.loads(fx.CLI_GOLDEN.read_text())
    cmds = fx.cli_commands(tmp_path)
    small = [str(fx.VP9_SMALL) if a == str(fx.VP9_BENCH) else a
             for a in cmds["b"]]
    assert main(small, device="cpu") == 0
    assert (tmp_path / "out_vp9.md5").read_text() == \
        gold["b_small_framemd5"]
    for ext in ("mkv", "mp4"):
        assert main(cmds[f"c_{ext}"], device="cpu") == 0
        path = tmp_path / f"out.{ext}"
        assert hashlib.sha256(path.read_bytes()).hexdigest() == \
            gold[f"c_{ext}_sha256"]
        capsys.readouterr()
        assert probe([*fx.CLI_PROBE_ARGS, str(path)], device="cpu") == 0
        assert capsys.readouterr().out == gold[f"f_probe_{ext}"]
    assert gold["e_max_abs_diff"] <= 1e-5
    assert fx.probe_without_sizes(gold["f_probe_mpeg2"])["streams"][0][
        "codec_name"] == "mpeg2video"
