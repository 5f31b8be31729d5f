"""The Vorbis and Opus streams of the port's audio-codec tests and of
tests/data/port/audio_codecs_streams.npz, made by the recipes of the
reference's own tests: the reference binary's encodes of
tests/test_vorbis.py and test_opus.py (they replay through
tests/golden.py, so each invocation is kept byte for byte and runs in a
fresh directory), and the SILK, hybrid and mode-switch streams crafted
by tests/test_opus_silk.py's writers with its seeds and configs; and
the reference's decode of a stream.

`make_stream(name, tmp)` → {codec_id, sample_rate, channels, extradata,
packets, pts, time_base}, as the reference's matroska demuxer gives the
binary's streams and as test_opus_silk.py's decode_ours feeds the
crafted ones."""

from __future__ import annotations

import struct
import subprocess
from pathlib import Path

import numpy as np

import refutil
import test_opus
import test_opus_silk as ts
import test_vorbis


def _noise_wav(tmp: Path, seed: int, scale: float) -> Path:
    """test_vorbis_noise's / test_opus_celt_noise_transients' input."""
    rng = np.random.default_rng(seed)
    n = 24000
    pcm = (rng.standard_normal((n, 2)) * scale).astype(np.int16)
    wav = tmp / "in.wav"
    body = pcm.tobytes()
    wav.write_bytes(
        b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVEfmt " +
        struct.pack("<IHHIIHH", 16, 1, 2, 48000, 192000, 4, 16) +
        b"data" + struct.pack("<I", len(body)) + body)
    return wav


def _vorbis_noise(tmp: Path) -> Path:
    wav = _noise_wav(tmp, 7, 6000)
    p = tmp / "n.mka"
    subprocess.run([str(refutil.REF), "-v", "error", "-i", str(wav),
                    "-c:a", "vorbis", "-strict", "-2", "-f",
                    "matroska", "-y", str(p)], check=True)
    return p


def _celt_noise(tmp: Path) -> Path:
    wav = _noise_wav(tmp, 3, 8000)
    p = tmp / "n.mka"
    subprocess.run([str(refutil.REF), "-v", "error", "-i", str(wav),
                    "-c:a", "opus", "-strict", "-2", "-f", "matroska",
                    "-y", str(p)], check=True)
    return p


_FILES = {
    "vorbis_sine": lambda t: test_vorbis._make(
        t, "sine=frequency=440:duration=0.6", "m.mka"),
    "vorbis_stereo": lambda t: test_vorbis._make(
        t, "sine=frequency=440:duration=0.6", "s.mka", ch=2),
    "vorbis_noise": _vorbis_noise,
    "celt_sine": lambda t: test_opus._make(
        t, "sine=frequency=440:duration=0.5", "s.mka"),
    "celt_mono": lambda t: test_opus._make(
        t, "sine=frequency=880:duration=0.5", "m.mka", ch=1),
    "celt_noise": _celt_noise,
    "celt_256k": lambda t: test_opus._make(
        t, "sine=frequency=200:duration=0.5", "hr.mka",
        extra=("-b:a", "256k")),
    "celt_16k": lambda t: test_opus._make(
        t, "sine=frequency=440:duration=0.5", "lb.mka",
        extra=("-b:a", "16k")),
}

# name → (seed, config, channels, packets) of test_opus_silk.py's cases
_SILK = {
    "silk_cfg1_20ms": (101, 1, 1, 20),
    "silk_cfg5_20ms": (105, 5, 1, 20),
    "silk_cfg9_20ms": (109, 9, 1, 20),
    "silk_10ms": (7, 8, 1, 20),
    "silk_60ms": (11, 11, 1, 8),
    "silk_nb_40ms": (31, 2, 1, 10),
    "silk_stereo": (23, 9, 2, 20),
}
_HYBRID = {
    "hybrid_cfg13": (513, 13, 1, 15),
    "hybrid_cfg15": (515, 15, 1, 15),
    "hybrid_stereo_10ms": (71, 12, 2, 15),
}


def _demux(path: Path) -> dict:
    from ffmpeg_tpu.io.demux import open_input
    d = open_input(str(path))
    par = d.streams[0].codecpar
    pkts = list(d.packets())
    tb = pkts[0].time_base
    return {"codec_id": par.codec_id, "sample_rate": par.sample_rate,
            "channels": par.ch_layout.nb_channels,
            "extradata": bytes(par.extradata or b""),
            "packets": [bytes(p.data) for p in pkts],
            "pts": [int(p.pts) for p in pkts], "time_base": (tb.num, tb.den)}


def _crafted(pkts, config: int, channels: int) -> dict:
    """test_opus_silk.py decode_ours's packets and parameters."""
    dur48 = int(ts.T.FRAME_DURATION[config])
    return {"codec_id": "opus", "sample_rate": 48000, "channels": channels,
            "extradata": ts.opus_head(channels), "packets": list(pkts),
            "pts": [i * dur48 for i in range(len(pkts))],
            "time_base": (1, 48000)}


def _mode_switch(tmp: Path) -> dict:
    """test_mode_switch's stream: SILK, reference-encoded CELT, SILK."""
    src = tmp / "celt.mkv"
    subprocess.run(
        [str(refutil.REF), "-v", "error", "-f", "lavfi", "-i",
         "sine=frequency=500:sample_rate=48000", "-t", "0.4",
         "-c:a", "opus", "-strict", "-2", "-f", "matroska",
         str(src)], check=True)
    celt_pkts = _demux(src)["packets"]
    silk_pkts = ts.make_stream(77, 9, 1, 8)
    return _crafted(silk_pkts[:4] + celt_pkts[2:8] + silk_pkts[4:], 9, 1)


def make_stream(name: str, tmp: Path) -> dict:
    """One stream of testing.CODEC_STREAM_NAMES, made in `tmp` (a fresh
    directory)."""
    if name in _FILES:
        return _demux(_FILES[name](tmp))
    if name in _SILK:
        seed, config, ch, n = _SILK[name]
        return _crafted(ts.make_stream(seed, config, ch, n), config, ch)
    if name in _HYBRID:
        seed, config, ch, n = _HYBRID[name]
        return _crafted(ts.make_hybrid_stream(seed, config, ch, n),
                        config, ch)
    if name == "mode_switch":
        return _mode_switch(tmp)
    raise KeyError(name)


def ref_decode(st: dict, n=None) -> list:
    """The reference's decoder over the first `n` (all) packets of a
    stream, drained: its frames."""
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.core.packet import Packet
    from ffmpeg_tpu.formats.channel_layout import default_layout
    from ffmpeg_tpu.io.stream import CodecParameters, MediaType
    from ffmpeg_tpu.utils.rational import Rational
    dec = CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.AUDIO, codec_id=st["codec_id"],
        sample_rate=st["sample_rate"],
        ch_layout=default_layout(st["channels"]),
        extradata=st["extradata"]))
    tb = Rational(*st["time_base"])
    return dec.decode_all([Packet(data=p, pts=t, time_base=tb)
                           for p, t in zip(st["packets"][:n], st["pts"])])


def pcm(frames) -> np.ndarray:
    """The frames' samples, (channels, n) float32 (the channel count is
    the same over each of these streams)."""
    return np.concatenate([np.asarray(f.audio_data, np.float32)
                           for f in frames], axis=1)


def port_stream(st: dict) -> dict:
    """A stream of make_stream in testing.codec_stream's form."""
    from ffmpeg_tpu_torch.utils.rational import Rational
    return {**st, "time_base": Rational(*st["time_base"])}


def assert_close(got: np.ndarray, want: np.ndarray, tol: float = None,
                 min_snr: float = None) -> None:
    """testing.audio_bar's bar: the same shape, max |diff| <= tol (1e-5)
    of full scale (PCM in [-1, 1)) and >= min_snr (100) dB."""
    from ffmpeg_tpu_torch import testing as fx
    tol = fx.AUDIO_DECODE_TOL if tol is None else tol
    min_snr = fx.AUDIO_DECODE_MIN_SNR if min_snr is None else min_snr
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    snr = fx.snr_db(got, want)
    assert err <= tol * max(1.0, float(np.abs(want).max(initial=0.0))) \
        and snr >= min_snr, (err, snr)


_MADE: dict = {}


def made(name: str, tmp_path_factory) -> dict:
    """make_stream(name) once per test process, in a fresh directory."""
    if name not in _MADE:
        _MADE[name] = make_stream(name, tmp_path_factory.mktemp(name))
    return _MADE[name]
