#!/usr/bin/env python
"""Write the audio goldens that the port is checked against.

Runs the JAX package on the CPU and writes, under tests/data/port/:

- `frontend`: aac48k_frontend_golden.npz, the audio frontend's golden
  on the committed clip tests/data/bench/aac48k.adts (939 ADTS frames of
  48 kHz stereo AAC-LC, 20.03 s), two float32 arrays:
  - `resampled`, (1, 320512): the reference's ADTS demuxer,
    CodecContext.open_decoder(...).decode_frames over every packet, the
    decoded planes concatenated, then SwrContext(48000, "stereo", "fltp",
    16000, "mono", "fltp"): convert of the whole utterance, then the
    flush (`benchrows.audio_frontend_row`'s pass on the whole clip);
  - `decoded`, (2, 32768): the first 32 decoded frames.
- `streams`: audio_streams.npz, the audio decoders' streams
  (ffmpeg_tpu_torch.testing.AUDIO_STREAM_NAMES), each about 1 s, made by
  the recipes of the reference's own tests (the reference binary's
  encodes replay through tests/golden.py: the invocations are kept byte
  for byte):
  - eac3_5_1: tests/test_eac3.py::test_eac3_5_1 (pink noise, 5.1,
    48 kHz, 384 kb/s);
  - ac3_stereo: tests/test_ac3.py::test_ac3_stereo (two detuned tones
    and noise, 44.1 kHz, 128 kb/s);
  - eac3_aht_spx: tests/test_eac3_crafted.py's writers, 16 mono frames
    with the adaptive hybrid transform (GAQ mode 3) then 16 stereo
    frames with spectral extension;
  - mp3_reservoir: tests/test_mp3.py::test_bit_reservoir's 5 frames
    (one frame's main data at the tail of the frame before) 8 times;
    mp3_short: its short-block frame and mp3_ms its M/S stereo frame,
    40 times each;
  - mp2_stereo: 38 of its Layer II stereo frames; mp1_stereo: 115 of
    its Layer I stereo frames;
  - aac_sbr and aac_ps: tests/test_aacsbr.py's and tests/test_aacps.py's
    SBR (seed 0) and SBR + PS (test_ps_basic, seed 1) payloads spliced
    into the reference binary's AAC-LC encode of the noise core
    (24 kHz).
  For each: the packets as the reference's demuxer gives them (the AAC
  frames as spliced, pts i*1024), the codec and sample rate, and the
  reference decoder's PCM of the first AUDIO_PREFIX_PACKETS packets.

The card's machine has no JAX, so the reference's answers are committed.
Usage:

    JAX_PLATFORMS=cpu python tools/gen_torch_audio_fixture.py [frontend] [streams]

(no argument: both).
"""

from __future__ import annotations

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

import conftest  # noqa: E402,F401  (installs tests/golden.py's replay)
from ffmpeg_tpu_torch import testing as fx  # noqa: E402

CLIP = REPO / "tests" / "data" / "bench" / "aac48k.adts"
NPACKETS, GOLDEN_FRAMES = 939, 32


def frontend() -> None:
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.io import open_input
    from ffmpeg_tpu.resample.swresample import SwrContext
    d = open_input(str(CLIP))
    pkts = list(d.packets())
    assert len(pkts) == NPACKETS, len(pkts)
    frames = CodecContext.open_decoder(d.streams[0].codecpar) \
        .decode_frames(pkts)
    pcm = np.concatenate([f.audio_data for f in frames], axis=1)
    swr = SwrContext(48000, "stereo", "fltp", 16000, "mono", "fltp")
    out = np.concatenate([swr.convert(pcm), swr.flush()], axis=1)
    decoded = pcm[:, :GOLDEN_FRAMES * 1024]
    assert pcm.shape == (2, NPACKETS * 1024) and pcm.dtype == np.float32
    assert out.shape == (1, 320512) and out.dtype == np.float32
    np.savez_compressed(fx.AUDIO_GOLDEN, resampled=out, decoded=decoded)
    print(f"{fx.AUDIO_GOLDEN}: resampled {out.shape}, decoded "
          f"{decoded.shape}, {fx.AUDIO_GOLDEN.stat().st_size} bytes")


def _eac3_5_1(tmp: Path) -> Path:
    """tests/test_eac3.py::test_eac3_5_1's invocation, as it is."""
    import refutil
    graph = ";".join(
        f"anoisesrc=duration=1:colour=pink:seed={i}[c{i}]"
        for i in range(6))
    graph += (";" + "".join(f"[c{i}]" for i in range(6)) +
              "amerge=inputs=6,"
              "aformat=sample_fmts=s16:channel_layouts=5.1[out]")
    p = tmp / "six.eac3"
    subprocess.run([str(refutil.REF), "-v", "error", "-filter_complex",
                    graph, "-map", "[out]", "-c:a", "eac3", "-b:a",
                    "384k", "-y", str(p)],
                   check=True, capture_output=True)
    return p


def _files(tmp: Path) -> dict:
    """name → the file the reference's demuxer reads."""
    import test_ac3
    import test_eac3_crafted as ec
    import test_mp3 as tm
    from test_torch_mp3 import reservoir_stream

    def write(name, data):
        p = tmp / name
        p.write_bytes(data)
        return p
    return {
        "eac3_5_1": _eac3_5_1(tmp),
        "ac3_stereo": test_ac3._encode_stereo(tmp, 44100, "128k"),
        "eac3_aht_spx": write("ahtspx.eac3", b"".join(
            [ec.craft_aht_frame(300 + i, 3) for i in range(16)]
            + [ec.craft_spx_frame(50 + i) for i in range(16)])),
        "mp3_reservoir": write("resv.mp3", reservoir_stream() * 8),
        "mp3_short": write("s.mp3", tm.craft_frame(
            pairs=((1, 1), (1, 0)), block_type=2, global_gain=190) * 40),
        "mp3_ms": write("ms.mp3", tm.craft_frame(
            pairs=((1, 1), (0, 2)), table_select=5, global_gain=188,
            nch=2, ms=True) * 40),
        "mp2_stereo": write("t.mp2", b"".join(
            tm.craft_mp2_frame(seed=s, nch=2) for s in range(38))),
        "mp1_stereo": write("t.mp1", b"".join(
            tm.craft_mp1_frame(seed=s, nch=2) for s in range(115))),
    }


def _aac_streams(tmp: Path) -> dict:
    """name → the spliced ADTS frames (core rate 24 kHz)."""
    from test_aacps import write_ps_payload
    from test_aacsbr import _make_lc_noise, splice_sbr
    lc = _make_lc_noise(tmp)
    rng = np.random.default_rng(1)
    return {"aac_sbr": splice_sbr(lc, 24000, seed=0),
            "aac_ps": splice_sbr(lc, 24000, seed=1,
                                 ext_bits=write_ps_payload(rng))}


def streams() -> None:
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.core.packet import Packet
    from ffmpeg_tpu.io import open_input
    from ffmpeg_tpu.io.stream import CodecParameters, MediaType
    from ffmpeg_tpu.utils.rational import Rational
    found = {}
    with tempfile.TemporaryDirectory() as d:
        for name, path in _files(Path(d)).items():
            inp = open_input(str(path))
            st = [s for s in inp.streams
                  if s.codecpar.codec_type == MediaType.AUDIO][0]
            par = st.codecpar
            pkts = [p for p in inp.packets() if p.stream_index == st.index]
            found[name] = (par.codec_id, par.sample_rate,
                           [bytes(p.data) for p in pkts],
                           [p.pts for p in pkts])
    with tempfile.TemporaryDirectory() as d:
        for name, frames in _aac_streams(Path(d)).items():
            found[name] = ("aac", 24000, frames,
                           [i * 1024 for i in range(len(frames))])
    assert tuple(found) == fx.AUDIO_STREAM_NAMES, tuple(found)
    out = {}
    for name, (codec_id, rate, data, pts) in found.items():
        ref = CodecContext.open_decoder(CodecParameters(
            codec_type=MediaType.AUDIO, codec_id=codec_id,
            sample_rate=rate))
        tb = Rational(1, rate)
        frames = ref.decode_all([Packet(data=p, pts=t, time_base=tb) for p, t
                                 in zip(data[:fx.AUDIO_PREFIX_PACKETS], pts)])
        prefix = np.concatenate([np.asarray(f.audio_data, np.float32)
                                 for f in frames], axis=1)
        print(f"{name}: {codec_id} at {rate} Hz, {len(data)} packets, "
              f"{sum(map(len, data))} bytes; prefix {prefix.shape} at "
              f"{frames[0].sample_rate} Hz", flush=True)
        out[f"{name}_data"] = np.frombuffer(b"".join(data), np.uint8)
        out[f"{name}_sizes"] = np.array([len(p) for p in data], np.int64)
        out[f"{name}_pts"] = np.array(pts, np.int64)
        out[f"{name}_params"] = np.array([codec_id, str(rate)])
        out[f"{name}_prefix"] = prefix
    np.savez_compressed(fx.AUDIO_STREAMS, **out)
    print(f"{fx.AUDIO_STREAMS}: {fx.AUDIO_STREAMS.stat().st_size} bytes")


if __name__ == "__main__":
    for what in sys.argv[1:] or ["frontend", "streams"]:
        {"frontend": frontend, "streams": streams}[what]()
