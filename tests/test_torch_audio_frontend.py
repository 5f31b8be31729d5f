"""The port's audio frontend as a whole, on the CPU: the committed clip
(tests/data/bench/aac48k.adts, 939 ADTS frames of 48 kHz stereo AAC-LC,
20.03 s) through the port's ADTS demuxer, `decode_frames` and
SwrContext(48000 stereo → 16000 mono fltp), against the JAX package run
on the same clip and against the reference's committed golden
(tests/data/port/aac48k_frontend_golden.npz, written by
tools/gen_torch_audio_fixture.py); the graph
`aresample=16000,aformat=channel_layouts=mono` on the first 200 packets;
and tests/test_aac.py's Whisper-frontend pipeline against the recorded
reference decode.

Tolerances: decoded PCM and the 16 kHz output within 5e-6 at >= 110 dB
SNR of the JAX package (measured 6.9e-7 / 130.6 dB and 2.1e-7 /
134.3 dB: the IMDCT's and the FIR's float32 sums in another order); the
golden equal to the JAX package's run within 1e-6 (the same code; XLA's
CPU code may differ by machine); the graph's outputs within 1e-5 of the
golden's, over the outputs the rest of the clip does not reach; the
Whisper pipeline > 30 dB against the recorded reference, as test_aac.py
asks of the JAX package.
"""

import subprocess

import numpy as np
import pytest

import refutil
from conftest import requires_ref

from ffmpeg_tpu.codecs import CodecContext as RefCodecContext
from ffmpeg_tpu.filters import parse_graph as ref_parse_graph
from ffmpeg_tpu.io import open_input
from ffmpeg_tpu.resample.swresample import SwrContext as RefSwrContext
from ffmpeg_tpu_torch.codecs import CodecContext
from ffmpeg_tpu_torch.filters import parse_graph
from ffmpeg_tpu_torch.io.adts import read_adts
from ffmpeg_tpu_torch.resample.swresample import SwrContext
from ffmpeg_tpu_torch.testing import (AAC_CLIP, AUDIO_GOLDEN,
                                      AUDIO_GOLDEN_FRAMES,
                                      AUDIO_GRAPH_PACKETS, AUDIO_GRAPH_TEXT,
                                      audio_frontend, graph_prefix, snr_db)

TOL, MIN_SNR = 5e-6, 110.0


@pytest.fixture(scope="module")
def reference():
    """The JAX package on the whole clip: decoded PCM and 16 kHz output."""
    d = open_input(str(AAC_CLIP))
    frames = RefCodecContext.open_decoder(d.streams[0].codecpar) \
        .decode_frames(list(d.packets()))
    pcm = np.concatenate([f.audio_data for f in frames], axis=1)
    swr = RefSwrContext(48000, "stereo", "fltp", 16000, "mono", "fltp")
    return pcm, np.concatenate([swr.convert(pcm), swr.flush()], axis=1)


@pytest.fixture(scope="module")
def port():
    par, pkts = read_adts(AAC_CLIP.read_bytes())
    frames, out = audio_frontend(par, pkts, "cpu")
    return np.concatenate([f.audio_data for f in frames], axis=1), out


@pytest.fixture(scope="module")
def golden():
    g = np.load(AUDIO_GOLDEN)
    return g["decoded"], g["resampled"]


def test_golden_is_the_reference_output(reference, golden):
    pcm, out = reference
    g_pcm, g_out = golden
    assert g_out.shape == out.shape == (1, 320512)
    assert g_pcm.shape == (2, AUDIO_GOLDEN_FRAMES * 1024)
    assert float(np.abs(g_out - out).max()) <= 1e-6
    assert float(np.abs(g_pcm - pcm[:, :g_pcm.shape[1]]).max()) <= 1e-6


@pytest.mark.parametrize("what", ["decoded", "resampled"])
def test_port_matches_reference_on_whole_clip(reference, port, what):
    i = ["decoded", "resampled"].index(what)
    got, want = port[i], reference[i]
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape == ((2, 939 * 1024), (1, 320512))[i]
    assert float(np.abs(got - want).max()) <= TOL
    assert snr_db(got, want) >= MIN_SNR


def test_port_matches_golden(port, golden):
    pcm, out = port
    g_pcm, g_out = golden
    for got, want in ((pcm[:, :g_pcm.shape[1]], g_pcm), (out, g_out)):
        assert float(np.abs(got - want).max()) <= TOL
        assert snr_db(got, want) >= MIN_SNR


def test_graph_on_first_packets_matches_golden_and_reference(golden):
    par, pkts = read_adts(AAC_CLIP.read_bytes())
    pkts = pkts[:AUDIO_GRAPH_PACKETS]
    frames = CodecContext.open_decoder(par, device="cpu").decode_frames(pkts)
    g = parse_graph(AUDIO_GRAPH_TEXT, device="cpu")
    assert [n.filter.name for n in g.nodes] == ["aresample", "aformat"]
    out = g.run(frames)
    assert all(f.sample_rate == 16000 and f.ch_layout.describe() == "mono"
               for f in out)
    got = np.concatenate([f.audio_data for f in out], axis=1)
    n = graph_prefix(AUDIO_GRAPH_PACKETS)
    assert got.shape[1] > n
    assert float(np.abs(got[:, :n] - golden[1][:, :n]).max()) <= 1e-5
    d = open_input(str(AAC_CLIP))
    ref_frames = RefCodecContext.open_decoder(d.streams[0].codecpar) \
        .decode_frames(list(d.packets())[:AUDIO_GRAPH_PACKETS])
    want = np.concatenate([f.audio_data for f in ref_parse_graph(
        AUDIO_GRAPH_TEXT).run(ref_frames)], axis=1)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL
    assert [f.pts for f in out] == \
        [f.pts for f in ref_parse_graph(AUDIO_GRAPH_TEXT).run(ref_frames)]


@requires_ref
def test_whisper_frontend_pipeline(tmp_path):
    """tests/test_aac.py::test_whisper_frontend_pipeline on the port, its
    invocations byte for byte (the recorded oracle replays them), at its
    30 dB against the reference decoder, and within TOL of the JAX
    package on the same stream."""
    p = tmp_path / "w.aac"
    subprocess.run([str(refutil.REF), "-v", "error", "-f", "lavfi",
                    "-i", "sine=frequency=440:sample_rate=48000",
                    "-af", "aformat=channel_layouts=stereo",
                    "-t", "0.5", "-c:a", "aac", "-b:a", "128k",
                    "-f", "adts", "-y", str(p)],
                   check=True, capture_output=True)
    par, pkts = read_adts(p.read_bytes())
    dec = CodecContext.open_decoder(par, device="cpu")
    swr = SwrContext(48000, "stereo", "fltp", 16000, "mono", "flt",
                     device="cpu")
    ref_dec = RefCodecContext.open_decoder(
        open_input(str(p)).streams[0].codecpar)
    ref_swr = RefSwrContext(48000, "stereo", "fltp", 16000, "mono", "flt")
    chunks, ref_chunks = [], []
    for f, rf in zip(dec.decode_all(pkts),
                     ref_dec.decode_all(open_input(str(p)).packets())):
        y, ry = swr.convert(f.audio_data), ref_swr.convert(rf.audio_data)
        assert y.shape == ry.shape
        if y.size:
            chunks.append(y)
            ref_chunks.append(ry)
    chunks.append(swr.flush())
    ref_chunks.append(ref_swr.flush())
    ours = np.concatenate(chunks, axis=1)
    theirs = np.concatenate(ref_chunks, axis=1)
    assert ours.shape == theirs.shape
    assert float(np.abs(ours - theirs).max()) <= TOL
    raw = subprocess.run(
        [str(refutil.REF), "-v", "error", "-f", "aac", "-i", str(p),
         "-ar", "16000", "-ac", "1", "-f", "s16le", "-"],
        check=True, capture_output=True).stdout
    ref = np.frombuffer(raw, np.int16).astype(np.float64)[None, :] / 32768.0
    n = min(ours.shape[1], ref.shape[1])
    assert snr_db(ours[:, 500:n - 500], ref[:, 500:n - 500]) > 30
