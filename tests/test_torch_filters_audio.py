"""The port's host audio filters (ffmpeg_tpu_torch/filters/audio2.py-
audio6.py, 29 filters) against the reference's (ffmpeg_tpu/filters/
audio2.py-audio6.py), on the CPU: each through both packages'
parse_graph (the port's on the CPU) on the same seeded frames, in fltp
and s16, mono and stereo; the multi-input filters (amerge, join, afir)
on labelled pads; the anoisesrc source's colours; and the options and
inputs of the reference's own tests (tests/test_filters3.py,
test_filters_r5.py, test_loudness.py, test_filters_breadth.py), through
the filter objects as those tests drive them, test_loudness.py's at
their full length; and the audio chains' golden that the card is held
to (testing.AUDIO_CHAINS) against both packages.

Bar: equality.  Both packages run the same numpy and scipy code on the
host, so every output frame has the same format, sample count, pts and
samples, bit for bit; where the reference raises (a stereo tool on a
mono input), the port raises the same exception.  The chains' final
aresample is the one exception: its bar is stated in its test.
"""

import numpy as np
import pytest

from ffmpeg_tpu.core.frame import Frame as RefFrame
from ffmpeg_tpu.filters import filter_names as ref_filter_names
from ffmpeg_tpu.filters import get_filter as ref_get_filter
from ffmpeg_tpu.filters import parse_graph as ref_parse
from ffmpeg_tpu.formats.channel_layout import default_layout as ref_layout
from ffmpeg_tpu.utils.rational import Rational as RefRational
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.filters import (audio2, audio3, audio4, audio5,
                                      audio6, filter_names, get_filter,
                                      parse_graph)
from ffmpeg_tpu_torch.formats.channel_layout import default_layout
from ffmpeg_tpu_torch.utils.rational import Rational

SR = 48000
MODULES = (audio2, audio3, audio4, audio5, audio6)
NAMES = [n for n in filter_names()
         if any(c.__module__ in {m.__name__ for m in MODULES}
                for c in get_filter(n).__mro__)]

# (filter, args) on one input, in the graph's text form
SINGLE = [
    ("lowpass", "frequency=2000"), ("highpass", "frequency=300:width=0.5"),
    ("bandpass", "frequency=1000:width=2"),
    ("equalizer", "frequency=1500:width=1:gain=-6"), ("bass", "gain=6"),
    ("treble", "frequency=5000:gain=-4"), ("adelay", "delays=10|25"),
    ("aecho", "0.8:0.7:40|90:0.5|0.3"), ("ebur128", ""),
    ("loudnorm", "I=-16:TP=-1.5"), ("atempo", "1.5"), ("atempo", "0.7"),
    ("afade", "type=in:duration=0.02"),
    ("afade", "type=out:start_sample=1000:nb_samples=2000"),
    ("asetpts", "PTS-STARTPTS"), ("channelmap", "map=1|0"),
    ("extrastereo", "m=2.5"), ("stereowiden", ""), ("crystalizer", "i=2"),
    ("tremolo", "f=8:d=0.7"), ("vibrato", "f=6:d=0.4"),
    ("dynaudnorm", "f=50:g=5"),
    ("compand", "attacks=0.01:decays=0.2:points=-80/-80|-20/-10|0/-3"),
    ("acompressor", "threshold=0.1:ratio=4:makeup=1"),
    ("agate", "threshold=0.3:ratio=3"), ("alimiter", "limit=0.5"),
    ("silenceremove", "start_threshold=0.02:start_duration=0.005"),
]
# (graph, its input labels and their channel counts)
MULTI = [
    ("[a][b]amerge=inputs=2", {"a": 1, "b": 1}),
    ("[a][b]join=inputs=2:channel_layout=stereo", {"a": 1, "b": 1}),
    ("[in][ir]afir", {"in": 2, "ir": 1}),
    ("[in][ir]afir=dry=0.5:wet=0.7:irnorm=0", {"in": 2, "ir": 2}),
]
FORMATS = [("fltp", 1), ("fltp", 2), ("s16", 1), ("s16", 2)]


def _signal(seed: int, ch: int, n: int) -> np.ndarray:
    """Seeded (ch, n) float samples in [-1, 1): tones and noise with a
    quiet head (for the gates and silenceremove)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = np.stack([0.5 * np.sin(2 * np.pi * (300 + 170 * c) * t + c) +
                  0.15 * rng.standard_normal(n) for c in range(ch)])
    x[:, :n // 6] *= 0.002
    return np.clip(x, -1, 1 - 2 ** -15)


def _frames(x: np.ndarray, fmt: str, frame: int = 1024):
    """(port frames, reference frames) of `x` in `fmt`, `frame` samples
    each, pts in samples."""
    data = (np.round(x * 32767).astype(np.int16) if fmt == "s16"
            else x.astype(np.float32))
    port, ref = [], []
    for i in range(0, data.shape[1], frame):
        d = np.ascontiguousarray(data[:, i:i + frame])
        port.append(Frame.audio(d.copy(), SR, fmt,
                                default_layout(d.shape[0]), pts=i,
                                time_base=Rational(1, SR)))
        ref.append(RefFrame.audio(d.copy(), SR, fmt, ref_layout(d.shape[0]),
                                  pts=i, time_base=RefRational(1, SR)))
    return port, ref


def _run(g, feeds: dict) -> list:
    out = []
    for label, frames in feeds.items():
        for f in frames:
            g.feed(f, label)
            out.extend(g.pull("out"))
    for label in feeds:
        g.feed_eof(label)
        out.extend(g.pull("out"))
    return out


def _assert_same(got: list, want: list) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.format, a.nb_samples, a.sample_rate, a.pts) == \
            (b.format, b.nb_samples, b.sample_rate, b.pts)
        assert len(a.planes) == len(b.planes)
        for p, q in zip(a.planes, b.planes):
            p, q = np.asarray(p), np.asarray(q)
            assert p.dtype == q.dtype and np.array_equal(p, q)


def _same_outcome(port_fn, ref_fn) -> None:
    """Both calls give the same frames, or raise exceptions of the same
    name (each package has its own error classes) and message."""
    try:
        want = ref_fn()
    except Exception as e:          # noqa: BLE001 — compared below
        with pytest.raises(Exception) as got:
            port_fn()
        assert (type(got.value).__name__, str(got.value)) == \
            (type(e).__name__, str(e))
        return
    _assert_same(port_fn(), want)


def _both(text: str, port_feeds: dict, ref_feeds: dict) -> None:
    """The graph through both packages' parse_graph."""
    _same_outcome(lambda: _run(parse_graph(text, device="cpu"), port_feeds),
                  lambda: _run(ref_parse(text), ref_feeds))


def test_all_29_filters_registered():
    assert len(NAMES) == 29
    assert set(NAMES) <= set(filter_names()) and \
        set(NAMES) <= set(ref_filter_names())
    assert filter_names() == ref_filter_names()
    covered = {n for n, _ in SINGLE} | {"amerge", "join", "afir",
                                        "anoisesrc"}
    assert covered == set(NAMES)


@pytest.mark.parametrize("fmt,ch", FORMATS, ids=[f"{f}-{c}ch"
                                                 for f, c in FORMATS])
@pytest.mark.parametrize("name,args", SINGLE,
                         ids=[f"{n}:{a}" for n, a in SINGLE])
def test_filter_equals_reference(name, args, fmt, ch):
    port, ref = _frames(_signal(len(args) + ch, ch, 3 * 1024 + 200), fmt)
    text = f"{name}={args}" if args else name
    _both(text, {"in": port}, {"in": ref})


@pytest.mark.parametrize("fmt", ["fltp", "s16"])
@pytest.mark.parametrize("text,inputs", MULTI,
                         ids=[t for t, _ in MULTI])
def test_multi_input_filter_equals_reference(text, inputs, fmt):
    pf, rf = {}, {}
    for i, (label, ch) in enumerate(inputs.items()):
        n = 129 if label == "ir" else 3 * 1024
        x = _signal(10 + i, ch, n)
        if label == "ir":
            x *= np.exp(-np.arange(n) / 20.0)
        pf[label], rf[label] = _frames(x, fmt)
    _both(text, pf, rf)


@pytest.mark.parametrize("args", [
    "color=white:seed=1", "color=pink:sample_rate=44100:seed=1",
    "color=brown:amplitude=0.3:seed=2", "color=white:samples_per_frame=500",
    "color=blue:seed=3", "color=violet:seed=3"])
def test_anoisesrc_equals_reference(args):
    port = get_filter("anoisesrc")(args)
    ref = ref_get_filter("anoisesrc")(args)
    _same_outcome(lambda: list(port.generate(4)),
                  lambda: list(ref.generate(4)))


def _sine(n, amp=0.5, f=440.0):
    """tests/test_filters_r5.py `_sine`: (2, n) float32."""
    t = np.arange(n) / SR
    s = (amp * np.sin(2 * np.pi * f * t)).astype(np.float32)
    return np.stack([s, s])


def _silence_head():
    x = _sine(8192, amp=0.5)
    x[:, :4000] = 0.0
    return [x]


# The reference's own tests' options and inputs, driven as those tests
# drive the filter objects: (filter, args, input blocks).
REPLAYED = [
    ("lowpass", "frequency=1000", lambda: [_signal(1, 1, 4800)]),
    ("adelay", "delays=100", lambda: [_signal(2, 1, 4800)]),
    ("aecho", "in_gain=1.0:out_gain=1.0:delays=100:decays=0.5",
     lambda: [_signal(3, 1, 8000)]),
    ("dynaudnorm", "", lambda: [_sine(4096, amp=0.05)] * 8),
    ("compand", "attacks=0.01:decays=0.1:points=-70/-70|-20/-20|0/-10",
     lambda: [_sine(8192, amp=0.9)]),
    ("acompressor", "threshold=0.1:ratio=4:makeup=1",
     lambda: [_sine(8192, amp=0.8)]),
    ("agate", "threshold=0.3:ratio=3", lambda: [_sine(8192, amp=0.05)]),
    ("alimiter", "limit=0.5", lambda: [_sine(8192, amp=0.95)]),
    ("silenceremove", "start_threshold=0.01:start_duration=0",
     _silence_head),
    ("loudnorm", "I=-20:TP=-2:LRA=11:measured_I=-12.8:measured_TP=-3.3:"
     "measured_LRA=2.3:measured_thresh=-22.8:linear=true",
     lambda: [_signal(4, 2, 4800)] * 3),
    ("loudnorm", "I=-20:TP=-2", lambda: [_signal(5, 2, 4800) * 0.1] * 6),
    ("atempo", "0.75", lambda: [_signal(6, 2, 4800)] * 3),
    ("atempo", "2.0", lambda: [_signal(7, 1, 4800)] * 3),
    ("tremolo", "f=8:d=0.7", lambda: [_signal(8, 2, 4800)] * 2),
    ("vibrato", "f=6:d=0.4", lambda: [_signal(9, 2, 4800)] * 2),
    ("crystalizer", "i=2", lambda: [_signal(10, 2, 4800)] * 2),
    ("extrastereo", "m=2.5", lambda: [_signal(11, 2, 4800)] * 2),
    ("stereowiden", "", lambda: [_signal(12, 2, 4800)] * 2),
    ("afade", "type=in:duration=0.25", lambda: [_signal(13, 2, 4800)] * 5),
    ("channelmap", "map=1|0", lambda: [_signal(14, 2, 4800)]),
    ("ebur128", "", lambda: [_signal(15, 2, 4800)] * 10),
]


@pytest.mark.parametrize("name,args,blocks", REPLAYED,
                         ids=[f"{n}:{a}" for n, a, _ in REPLAYED])
def test_reference_tests_cases_equal_reference(name, args, blocks):
    port, ref = get_filter(name)(args), ref_get_filter(name)(args)
    got, want = [], []
    for x in blocks():
        got += port.process(Frame.audio(x.astype(np.float32), SR,
                                        fmt="fltp"))
        want += ref.process(RefFrame.audio(x.astype(np.float32), SR,
                                           fmt="fltp"))
    got += port.process(None)
    want += ref.process(None)
    _assert_same(got, want)
    if name == "ebur128":
        assert port.stats == ref.stats


def test_afir_ir_on_pad_one_equals_reference():
    """tests/test_loudness.py::test_afir_matches_numpy_convolve's drive:
    the IR on pad 1, its EOF, then the signal."""
    rng = np.random.default_rng(0)
    sig = (rng.standard_normal((1, 9000)) * 0.2).astype(np.float32)
    ir = np.array([[1.0, 0.5, 0.25]], np.float32)
    out = []
    for get, fr in ((get_filter, Frame), (ref_get_filter, RefFrame)):
        f = get("afir")("")
        f.process(fr.audio(ir, SR, fmt="fltp"), pad=1)
        f.process(None, pad=1)
        o = []
        for i in range(0, 9000, 4800):
            o += f.process(fr.audio(sig[:, i:i + 4800], SR, fmt="fltp"))
        out.append(o + f.process(None))
    _assert_same(*out)


def _feed(flt, x, frame, chunk=4800, flush=True):
    """tests/test_loudness.py `_feed`: `x` in fltp frames of `chunk`
    samples (through `frame`, either package's Frame), then EOF."""
    outs = []
    for i in range(0, x.shape[1], chunk):
        outs += flt.process(frame.audio(
            x[:, i:i + chunk].astype(np.float32), SR, fmt="fltp"))
    if flush:
        outs += flt.process(None)
    return outs


def _r128_sine():
    """test_ebur128_reference_sine's input: 5 s of a -18 dBFS 997 Hz
    stereo sine."""
    t = np.arange(SR * 5) / SR
    return np.tile(10 ** (-18 / 20) * np.sin(2 * np.pi * 997 * t), (2, 1))


def _loudness_noise():
    """tests/test_loudness.py `_noise`: 4 s of stereo noise, its second
    half 10 dB down, as the s16 WAV it writes reads back."""
    rng = np.random.default_rng(4)
    n = SR * 4
    env = np.concatenate([np.full(n // 2, 1.0), np.full(n - n // 2, 0.3)])
    x = rng.standard_normal((2, n)) * 0.15 * env
    pcm = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    return pcm.astype(np.float64) / 32768.0


def _quiet_noise():
    """test_loudnorm_dynamic_hits_target's input: 6 s of quiet noise."""
    return np.random.default_rng(0).standard_normal((2, SR * 6)) * 0.02


# tests/test_loudness.py's full-length inputs (ebur128's 3 s short-term
# window and loudness range, loudnorm's short-term tracking):
# (filter, args, input, EOF fed, the output metered by ebur128 after)
LOUDNESS = [
    ("ebur128", "", _r128_sine, False, False),
    ("ebur128", "", _loudness_noise, False, False),
    ("loudnorm", "I=-20:TP=-2:LRA=11:measured_I=-12.8:measured_TP=-3.3:"
     "measured_LRA=2.3:measured_thresh=-22.8:linear=true", _loudness_noise,
     True, False),
    ("loudnorm", "I=-20:TP=-2", _quiet_noise, True, True),
]


@pytest.mark.parametrize("name,args,signal,flush,meter", LOUDNESS,
                         ids=["ebur128-sine-5s", "ebur128-noise-4s",
                              "loudnorm-linear-noise-4s",
                              "loudnorm-dynamic-6s"])
def test_loudness_reference_inputs_equal_reference(name, args, signal,
                                                   flush, meter):
    """ebur128 and loudnorm on the inputs of tests/test_loudness.py, fed
    as that file's `_feed` does: the same frames and the same ebur128
    stats (after loudnorm, those of the meter the reference test runs on
    loudnorm's output)."""
    x = signal()
    port, ref = get_filter(name)(args), ref_get_filter(name)(args)
    got = _feed(port, x, Frame, flush=flush)
    want = _feed(ref, x, RefFrame, flush=flush)
    _assert_same(got, want)
    if name == "ebur128":
        assert port.stats == ref.stats
        assert np.isfinite(port.stats["LRA"]) and port.stats["I"] > -70
    if meter:
        stats = []
        for get, fr, out in ((get_filter, Frame, got),
                             (ref_get_filter, RefFrame, want)):
            m = get("ebur128")("")
            y = np.concatenate([o.audio_data for o in out], axis=1)
            _feed(m, y.astype(np.float64), fr, flush=False)
            stats.append(m.stats)
        assert stats[0] == stats[1]


def _chain_inputs():
    """testing.audio_chain_inputs, and the same frames as the
    reference's Frames."""
    port = fx.audio_chain_inputs()
    ref = {k: [RefFrame.audio(f.audio_data, f.sample_rate, "fltp",
                              ref_layout(f.audio_data.shape[0]), pts=f.pts,
                              time_base=RefRational(1, f.sample_rate))
               for f in v]
           for k, v in port.items()}
    return port, ref


@pytest.mark.parametrize("name", list(fx.AUDIO_CHAINS))
def test_audio_chain_golden_ties_to_reference_and_port(name):
    """The audio chains' golden in audio_codecs_streams.npz, which the
    card is held to: the reference's parse_graph now and the port's on
    the CPU each give host filters bit-equal to its sha256, and after
    aresample within 1e-6 of its output (the bar of the port's aresample
    against the reference's in tests/test_torch_filters.py; the
    reference's own FIR is held to it too, since XLA's CPU code may round
    differently on another CPU)."""
    z = np.load(fx.AUDIO_CODECS)
    port_in, ref_in = _chain_inputs()
    for parse, inputs in ((ref_parse, ref_in),
                          (lambda t: parse_graph(t, device="cpu"), port_in)):
        fx.audio_chain_host_check(
            fx.run_audio_chain(parse, name, inputs, resample=False), z, name)
        out = fx.run_audio_chain(parse, name, inputs)
        want = z[f"chain_{name}"]
        assert out.shape == want.shape
        assert float(np.abs(out - want).max()) <= 1e-6
