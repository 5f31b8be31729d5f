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
  reference's own command (d) copied into MPEG-TS.

The card's machine has no JAX, so the reference's answers are committed.
About four minutes on the CPU, nearly all of it the reference's H.264
decode of the 1080p I picture.  Usage:

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
    fx.CLI_GOLDEN.write_text(json.dumps(out, indent=1, sort_keys=True)
                             + "\n")
    print(f"wrote {fx.CLI_GOLDEN} ({fx.CLI_GOLDEN.stat().st_size} bytes); "
          f"command (e) within {out['e_max_abs_diff']:.3g} of "
          f"{fx.AUDIO_GOLDEN.name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
