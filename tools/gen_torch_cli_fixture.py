#!/usr/bin/env python
"""Write the CLI goldens that chip_smoke.py's phase 26 checks the port's
CLI against.

Runs the JAX package's CLI (ffmpeg_tpu.cli.ffmpeg and ffprobe) on the
CPU on the command lines of ffmpeg_tpu_torch.testing.cli_commands and
writes tests/data/port/cli_golden.json:

- `b_framemd5`: command (b)'s framemd5 text, three frames of the
  committed 1920x1080 VP9 bench stream, and `b_small_framemd5`, the same
  command on the committed crafted 96x72 stream (testing.VP9_SMALL) for
  tests/test_torch_gpu.py;
- `c_mkv_sha256`, `c_mp4_sha256`: the sha256 of command (c)'s Matroska
  and MP4 remuxes of the committed 1920x1088 H.264 stream, and
  `c_framemd5`, the framemd5 text of the Matroska file's first frame;
- `f_probe_mkv`, `f_probe_mp4`: `-show_streams -show_packets -of json`
  of those two files, and `f_probe_mpeg2`: the same of the reference's
  own command (d), the MPEG-2 encode of CLI_MPEG2_FRAMES frames of
  mpeg2_clip at 1920x1080 into Matroska, with `d_packet_bytes`, its
  packets' sizes;
- `e_max_abs_diff`: command (e)'s float output against the committed
  aac48k_frontend_golden.npz `resampled`, which stays command (e)'s
  golden (the tool fails if they differ by more than 1e-5);
- phase 27 (testing.cli_container_commands, in the same directory):
  `g_avi_sha256` and `i_ts_sha256`, the sha256 of the flagship's MJPEG
  copied into AVI and of the ADTS clip copied into MPEG-TS; `j_samples`,
  the samples per channel of each Ogg file's float output (the Ogg files
  of testing.write_cli_ogg); `k_probe`, `-show_streams -show_packets -of
  json` of each file of testing.CLI_PROBE_FILES, `out_mpeg2.ts` being the
  reference's own command (d) copied into MPEG-TS;
- phase 28 (testing.cli_protocol_commands, in the same directory, over a
  loopback HTTP server (testing.serve_http) and the reference's
  RtmpServer as testing.rtmp_relay): `m_hls_sha256` and `m_enc_sha256`,
  the sha256 of each file of the HLS muxer's playlist and segments and
  of the AES-128 copy testing.write_hls_aes makes of them;
  `m_f32_equals_ts`, `n_f32_equals_ts` and `m_samples`, `n_samples`:
  whether the HLS and RTMP decodes are byte-equal to command (i)'s, and
  their samples; `n_media`, the messages the relay took; `o_streaminfo`,
  the FLAC file's first 42 bytes (its fLaC marker and STREAMINFO), and
  `o_lossless`, whether its decode is byte-equal to the direct s16le;
  `p_gif_sha256`, the sha256 of testing.write_cli_gif's file written by
  the reference's GIF encoder and muxer, and `p_framemd5`, its framemd5
  text; `q_probe`, fftpu-probe's text of testing.tagged_mp3 with the
  file's path as "{path}";
- phase 29 (testing.image_commands on testing.write_image_sources, in a
  directory of its own): `r_sha256`, the sha256 of the PNG, TIFF, BMP,
  PPM and QOI files the encoders write (each decodes back to its source,
  which the tool asserts); `r_exr_sha256`, the EXR picture's gbrpf32le;
  `s_mkv_sha256` and `s_framemd5`, the FFV1 Matroska file and its
  framemd5 text (its md5s are the source's, asserted), and
  `s_raw_sha256`, each FFV1 stream's rawvideo decode (the reference
  binary's, asserted); `t_framemd5`, the VP8 clip's framemd5 text, and `t_m2v_packet_bytes`,
  the sizes of its MPEG-2 packets; `u_webp_sha256` and `u_ll_sha256`,
  the lossy WebP's decode and the lossless WebP file; `v_probe`,
  `-show_format -show_streams` of testing.IMAGE_PROBE_FILES with each
  file's path as "{path}";
- phase 30 (testing.bsf_av1_vvc_commands on testing.write_vvc_av1_sources,
  in phase 26's directory): `w_sha256`, the sha256 of each output of
  testing.BSF_FILES (the bitstream filters' files and framemd5 texts,
  and the AV1 stream copied into IVF, MP4 and Matroska and through
  av1_frame_split and av1_metadata; the copies' packets are the
  stream's units, asserted), `w_refused`, the error class of each
  command the reference's transcode refuses, `x_probe`, the AV1 IVF's
  probe (testing.AV1_PROBE_ARGS) with its path as "{path}",
  `x_decode_error`, the reference decoder's error on the AV1 stream
  (class and text), `y_framemd5` and `y_10_framemd5`, the VVC GOPs'
  framemd5 texts, and `y_m2v_packet_bytes`, the sizes of the 832x480
  GOP's MPEG-2 packets.

The card's machine has no JAX, so the reference's answers are committed.
About seven minutes on the CPU: the reference's H.264 decode of the 1080p
I picture, and phase 28's AES-128 encryption (CBC, one block after
another: about 100 s).  Usage:

    JAX_PLATFORMS=cpu python tools/gen_torch_cli_fixture.py
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from ffmpeg_tpu.cli.ffmpeg import main as ref_main  # noqa: E402
from ffmpeg_tpu.cli.ffprobe import main as ref_probe  # noqa: E402
from ffmpeg_tpu.core.frame import Frame  # noqa: E402
from ffmpeg_tpu.core.packet import Packet  # noqa: E402
from ffmpeg_tpu.io import open_input, open_output  # noqa: E402
from ffmpeg_tpu.io.stream import CodecParameters, MediaType  # noqa: E402
from ffmpeg_tpu.utils.rational import Rational  # noqa: E402
from ffmpeg_tpu_torch import testing as fx  # noqa: E402


def write_clip(path: Path, w: int = 1920, h: int = 1080) -> None:
    """mpeg2_clip's frames as a y4m through the reference's muxer."""
    m = open_output(str(path), format="yuv4mpegpipe")
    m.add_stream(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="rawvideo", width=w, height=h,
        pix_fmt="yuv420p", framerate=Rational(25, 1)),
        time_base=Rational(1, 25))
    for i, f in enumerate(fx.mpeg2_clip(fx.CLI_MPEG2_FRAMES, w, h)):
        data = Frame.video(w, h, "yuv420p",
                           planes=[np.asarray(p) for p in f.planes]
                           ).to_bytes()
        m.write_packet(Packet(data=data, pts=i, dts=i, duration=1))
    m.write_trailer()
    m.close()


def probe_text(path: Path) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ref_probe([*fx.CLI_PROBE_ARGS, str(path)]) == 0
    return buf.getvalue()


def containers(d: Path, out: dict) -> None:
    """Phase 27's goldens, in the directory of phase 26's commands (with
    command (d)'s output there)."""
    fx.write_cli_ogg(d)
    cmds = fx.cli_container_commands(d)
    for name in ("g_avi", "h_ts", "i_ts") + tuple(
            f"j_{n}" for n in fx.CLI_OGG_STREAMS):
        assert ref_main(cmds[name]) == 0, name
    out["g_avi_sha256"] = hashlib.sha256(
        (d / "out.avi").read_bytes()).hexdigest()
    out["i_ts_sha256"] = hashlib.sha256(
        (d / "out_aac.ts").read_bytes()).hexdigest()
    out["j_samples"] = {
        n: (d / f"{n}.f32").stat().st_size // 4 // fx.codec_stream(n)[
            "channels"] for n in fx.CLI_OGG_STREAMS}
    out["k_probe"] = {f: probe_text(d / f) for f in fx.CLI_PROBE_FILES}
    print("phase 27 goldens done", flush=True)


def write_gif(path: Path) -> None:
    """testing.write_cli_gif's file, through the reference's GIF encoder
    and muxer."""
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.utils.error import EndOfStream, TryAgain
    rgb = fx.gif_clip()
    n, h, w, _ = rgb.shape
    tb = Rational(1, 10)
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="gif",
                          width=w, height=h, pix_fmt="rgb24",
                          framerate=Rational(10, 1))
    enc = CodecContext.open_encoder(par)
    m = open_output(str(path), format="gif")
    m.add_stream(par, time_base=tb)
    frames = [Frame.video(w, h, "rgb24", planes=[rgb[i, ..., c]
                                                 for c in range(3)],
                          pts=i, duration=1, time_base=tb)
              for i in range(n)]
    for f in [*frames, None]:
        enc.send_frame(f)
        while True:
            try:
                m.write_packet(enc.receive_packet())
            except (TryAgain, EndOfStream):
                break
    m.write_trailer()
    m.close()


def protocols(d: Path, out: dict) -> None:
    """Phase 28's goldens, in a directory that holds command (i)'s
    outputs."""
    import threading
    from ffmpeg_tpu.io.rtmp import RtmpServer

    def sha(path: Path) -> str:
        return hashlib.sha256(path.read_bytes()).hexdigest()
    srv, th, base = fx.serve_http(d, fx.DATA.parent)
    relay, got = RtmpServer(), {}
    cmds = fx.cli_protocol_commands(
        d, base, f"rtmp://127.0.0.1:{relay.port}/live/k")
    try:
        assert ref_main(cmds["m_hls"]) == 0
        out["m_hls_sha256"] = {p.name: sha(p) for p in sorted(
            d.glob("aac*")) if "_enc" not in p.name}
        fx.write_hls_aes(d)
        out["m_enc_sha256"] = {p.name: sha(p) for p in sorted(
            d.glob("aac_enc*"))}
        out["m_enc_sha256"]["aac.key"] = sha(d / "aac.key")
        t = threading.Thread(target=fx.rtmp_relay, args=(relay, got, 60.0))
        t.start()
        for name in ("m_f32", "n_pub", "n_f32", "o_flac", "o_s16",
                     "o_direct", "p_md5"):
            if name == "p_md5":
                write_gif(d / "clip.gif")
            assert ref_main(cmds[name]) == 0, name
        t.join(30)
        assert not t.is_alive() and "error" not in got, got.get("error")
    finally:
        relay.close()
        srv.shutdown()
        srv.server_close()
        th.join(10)
    ts = (d / "out_ts.f32").read_bytes()
    for k, f in (("m", "out_hls.f32"), ("n", "out_rtmp.f32")):
        out[f"{k}_f32_equals_ts"] = (d / f).read_bytes() == ts
        out[f"{k}_samples"] = (d / f).stat().st_size // 4
    out["n_media"] = len(got["media"])
    out["o_streaminfo"] = (d / "out.flac").read_bytes()[:42].hex()
    out["o_lossless"] = (d / "out_flac.s16").read_bytes() == \
        (d / "out_direct.s16").read_bytes()
    out["p_gif_sha256"] = sha(d / "clip.gif")
    out["p_framemd5"] = (d / "out_gif.md5").read_text()
    mp3 = d / fx.PROBE_MP3
    mp3.write_bytes(fx.tagged_mp3())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ref_probe([*fx.PROBE_MP3_ARGS, str(mp3)]) == 0
    out["q_probe"] = buf.getvalue().replace(str(mp3), "{path}")
    print("phase 28 goldens done", flush=True)


def images(d: Path, out: dict) -> None:
    """Phase 29's goldens (testing.image_commands), in directory `d`."""
    def sha(path: Path) -> str:
        return hashlib.sha256(path.read_bytes()).hexdigest()
    fx.write_image_sources(d)
    cmds = fx.image_commands(d)
    for name, argv in cmds.items():
        assert ref_main(argv) == 0, name
    r = [f"out.{e}" for e in fx.IMAGE_ENCODES] + ["out.qoi"]
    out["r_sha256"] = {f: sha(d / f) for f in r}
    assert all((d / f"out_{e}.rgb").read_bytes() == (d / "src.rgb")
               .read_bytes() for e in fx.IMAGE_ENCODES), "r not lossless"
    assert (d / "out_qoi.rgba").read_bytes() == \
        (d / "src.rgba").read_bytes(), "QOI not lossless"
    out["r_exr_sha256"] = sha(d / "out_exr.raw")
    out["s_mkv_sha256"] = sha(d / "out_ffv1.mkv")
    out["s_framemd5"] = (d / "out_ffv1.md5").read_text()
    md5s = [ln.rsplit(",", 1)[1].strip() for ln in
            out["s_framemd5"].splitlines() if ln and ln[0] != "#"]
    assert md5s == fx.image_source_md5s(), "FFV1 not lossless"
    out["s_raw_sha256"] = {n: sha(d / f"out_ffv1_{n}.yuv")
                           for n in fx.CLI_FFV1_STREAMS}
    assert all(out["s_raw_sha256"][n] == fx.image_golden(f"ffv1_{n}")
               for n in fx.CLI_FFV1_STREAMS), out["s_raw_sha256"]
    out["t_framemd5"] = (d / "out_vp8.md5").read_text()
    dm = open_input(str(d / "out_vp8_m2v.mkv"))
    out["t_m2v_packet_bytes"] = [len(p.data) for p in dm.packets()]
    dm.close()
    out["u_webp_sha256"] = sha(d / "out_webp.yuv")
    out["u_ll_sha256"] = sha(d / "out_ll.webp")
    probe = {}
    for f in fx.IMAGE_PROBE_FILES:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert ref_probe([*fx.IMAGE_PROBE_ARGS, str(d / f)]) == 0
        probe[f] = buf.getvalue().replace(str(d / f), "{path}")
    out["v_probe"] = probe
    print("phase 29 goldens done", flush=True)


def bsf_av1_vvc(d: Path, out: dict) -> None:
    """Phase 30's goldens, in the directory of phase 26's commands (with
    command (c)'s out.mp4 there)."""
    from ffmpeg_tpu.cli import ffmpeg as ref_cli
    from ffmpeg_tpu.codecs import CodecContext
    fx.write_vvc_av1_sources(d)
    cmds = fx.bsf_av1_vvc_commands(d)
    refused = {}
    for name, argv in cmds.items():
        rc = ref_main(argv)
        if rc != 0:
            try:
                ref_cli.transcode(ref_cli.parse_args(argv))
            except Exception as e:      # noqa: BLE001 — its class is kept
                refused[name] = type(e).__name__
            assert name in refused, name
        print(f"command {name}: rc {rc}", flush=True)
    assert set(refused) == {"w_unknown"}, refused
    out["w_refused"] = refused
    out["w_sha256"] = {k: hashlib.sha256((d / f).read_bytes()).hexdigest()
                       for k, f in fx.BSF_FILES.items()}
    tus = fx.av1_units()
    for ext in ("ivf", "mp4", "mkv"):
        dm = open_input(str(d / f"av1.{ext}"))
        assert [bytes(p.data) for p in dm.packets()] == tus, ext
        dm.close()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ref_probe([*fx.AV1_PROBE_ARGS, str(d / "av1.ivf")]) == 0
    out["x_probe"] = buf.getvalue().replace(str(d / "av1.ivf"), "{path}")
    dm = open_input(str(d / "av1.obu"))
    try:
        CodecContext.open_decoder(dm.streams[0].codecpar).decode_all(
            list(dm.packets()))
    except Exception as e:              # noqa: BLE001 — its class is kept
        out["x_decode_error"] = [type(e).__name__, str(e)]
    dm.close()
    assert out["x_decode_error"][0] == "NotSupported"
    out["y_framemd5"] = (d / "out_vvc.md5").read_text()
    out["y_10_framemd5"] = (d / "out_vvc10.md5").read_text()
    dm = open_input(str(d / "out_vvc_m2v.mkv"))
    out["y_m2v_packet_bytes"] = [len(p.data) for p in dm.packets()]
    dm.close()
    print("phase 30 goldens done", flush=True)


def main() -> int:
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        cmds = fx.cli_commands(d)
        for name in ("b", "c_mkv", "c_mp4", "c_md5", "e"):
            assert ref_main(cmds[name]) == 0, name
            print(f"command {name} done", flush=True)
        out["b_framemd5"] = (d / "out_vp9.md5").read_text()
        small = [str(fx.VP9_SMALL) if a == str(fx.VP9_BENCH) else a
                 for a in cmds["b"]]
        assert ref_main(small) == 0
        out["b_small_framemd5"] = (d / "out_vp9.md5").read_text()
        for ext in ("mkv", "mp4"):
            out[f"c_{ext}_sha256"] = hashlib.sha256(
                (d / f"out.{ext}").read_bytes()).hexdigest()
            out[f"f_probe_{ext}"] = probe_text(d / f"out.{ext}")
        out["c_framemd5"] = (d / "out_h264.md5").read_text()
        e = np.fromfile(d / "out.f32", np.float32)
        gold = np.load(fx.AUDIO_GOLDEN)["resampled"][0]
        assert e.shape == gold.shape, (e.shape, gold.shape)
        out["e_max_abs_diff"] = float(np.abs(e - gold).max())
        assert out["e_max_abs_diff"] <= 1e-5, out["e_max_abs_diff"]
        write_clip(d / "mpeg2_clip.y4m")
        assert ref_main(cmds["d"]) == 0
        out["f_probe_mpeg2"] = probe_text(d / "out_mpeg2.mkv")
        dm = open_input(str(d / "out_mpeg2.mkv"))
        out["d_packet_bytes"] = [len(p.data) for p in dm.packets()]
        dm.close()
        containers(d, out)
        assert ref_main(fx.cli_container_commands(d)["i_f32"]) == 0
        protocols(d, out)
        bsf_av1_vvc(d, out)
    with tempfile.TemporaryDirectory() as tmp:
        images(Path(tmp), out)
    fx.CLI_GOLDEN.write_text(json.dumps(out, indent=1, sort_keys=True)
                             + "\n")
    print(f"wrote {fx.CLI_GOLDEN} ({fx.CLI_GOLDEN.stat().st_size} bytes); "
          f"command (e) within {out['e_max_abs_diff']:.3g} of "
          f"{fx.AUDIO_GOLDEN.name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
