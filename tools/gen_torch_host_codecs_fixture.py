#!/usr/bin/env python
"""Write tests/data/port/host_codecs_streams.npz, the streams that the
port's FLAC, DTS, MLP/TrueHD, ADPCM and GIF decoders are held to, and
the JAX package's CLI decode of each, from the JAX package on the CPU:

- each stream of ffmpeg_tpu_torch.testing.HOST_CODEC_STREAMS, and the
  GIF testing.HOST_GIF, as its file's bytes (`<name>`): the reference
  binary's encodes of the reference's own tests, by the very invocations
  of tests/test_dca.py test_dca_5_1_with_lfe, test_mlp.py
  test_truehd_stereo and test_mlp_stereo_sine, test_adpcm.py
  test_adpcm_decode_exact (stereo, both codecs), test_flac_png.py
  test_flac_stereo_bit_exact, test_ogg.py's FLAC case and test_gif.py
  test_decode_reference_gif, each in a fresh directory, so that
  tests/golden.py replays them (a replay miss stops the tool);
- for each stream of HOST_CODEC_STREAMS, the sha256 and length of the
  reference CLI's (ffmpeg_tpu.cli.ffmpeg) decode of the file to the raw
  format its test compares in (testing.host_codec_command;
  `<name>_ref_sha256`, `<name>_ref_bytes`).

The card's machine has no JAX and no reference binary, so these answers
are committed.  Usage (about 30 s):

    JAX_PLATFORMS=cpu python tools/gen_torch_host_codecs_fixture.py
"""

from __future__ import annotations

import hashlib
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import conftest  # noqa: E402,F401  (installs tests/golden.py's replay)
import refutil  # noqa: E402
import test_dca  # noqa: E402
import test_flac_png  # noqa: E402
import test_ogg  # noqa: E402
from ffmpeg_tpu.cli.ffmpeg import main as ref_main  # noqa: E402
from ffmpeg_tpu_torch import testing as fx  # noqa: E402


def _ref(args: list, **kw) -> None:
    subprocess.run([str(refutil.REF), "-v", "error", *args], check=True,
                   **kw)


def _dts_5_1(t: Path) -> Path:
    w = t / "in.wav"
    test_dca._mkwav(w, 6, seed=3)
    return test_dca._encode(t, ["-i", str(w)],
                            ["-af", "aformat=channel_layouts=5.1"])


def _mlp(codec: str, label: str):
    """test_mlp.py _roundtrip's encode of its stereo sine."""
    def make(t: Path) -> Path:
        fmt = "mlp" if codec == "mlp" else "truehd"
        f = t / f"{label}.{'mlp' if codec == 'mlp' else 'thd'}"
        _ref(["-f", "lavfi", "-i", "sine=frequency=440:sample_rate=48000",
              "-ac", "2", "-t", "0.4", "-c:a", codec, "-strict", "-2",
              "-f", fmt, "-y", str(f)], capture_output=True)
        return f
    return make


def _adpcm(codec: str):
    def make(t: Path) -> Path:
        p = t / "a.wav"
        _ref(["-f", "lavfi", "-i",
              "anoisesrc=duration=0.4:colour=pink:seed=9,"
              "aformat=sample_fmts=s16:channel_layouts=stereo",
              "-c:a", codec, "-y", str(p)])
        return p
    return make


def _flac_stereo(t: Path) -> Path:
    x = test_flac_png._noise_s16(48000, 2, 0.3, 7)
    x[:, 1] = (x[:, 0] * 0.7 + x[:, 1] * 0.1).astype(np.int16)
    return test_flac_png._flac_file(
        t, ["-f", "s16le", "-ar", "48000", "-ac", "2", "-i", "-"],
        stdin=x.tobytes())


def _gif(t: Path) -> Path:
    p = t / "ref.gif"
    _ref(["-f", "lavfi", "-i", "testsrc2=size=96x64:rate=10", "-frames:v",
          "4", "-y", str(p)], capture_output=True)
    return p


RECIPES = {
    "dts_5_1": _dts_5_1,
    "truehd_stereo": _mlp("truehd", "t2"),
    "mlp_stereo": _mlp("mlp", "s2"),
    "adpcm_ima_wav": _adpcm("adpcm_ima_wav"),
    "adpcm_ms": _adpcm("adpcm_ms"),
    "flac_stereo": _flac_stereo,
    "flac_ogg": lambda t: test_ogg._make_ogg(t, "flac", ()),
    fx.HOST_GIF: _gif,
}


def make(name: str) -> bytes:
    with tempfile.TemporaryDirectory() as d:
        try:
            return RECIPES[name](Path(d)).read_bytes()
        except pytest.skip.Exception as e:      # a replay miss
            raise SystemExit(f"{name}: the reference binary's stream is "
                             f"not in tests/data/golden ({e})") from e


def main() -> int:
    assert set(RECIPES) == set(fx.HOST_CODEC_STREAMS) | {fx.HOST_GIF}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        for name in RECIPES:
            out[name] = np.frombuffer(make(name), np.uint8)
        for name, (ext, *_) in fx.HOST_CODEC_STREAMS.items():
            (d / f"{name}.{ext}").write_bytes(out[name].tobytes())
            args = fx.host_codec_command(d, name)
            assert ref_main(args) == 0, name
            data = Path(args[-1]).read_bytes()
            out[f"{name}_ref_sha256"] = np.array(
                hashlib.sha256(data).hexdigest())
            out[f"{name}_ref_bytes"] = np.array(len(data))
            print(f"{name}: {out[name].size} bytes, reference decode "
                  f"{len(data)} bytes", flush=True)
    np.savez_compressed(fx.HOST_CODECS, **out)
    print(f"wrote {fx.HOST_CODECS} ({fx.HOST_CODECS.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
