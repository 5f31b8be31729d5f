"""HE-AAC through the port's AAC decoder: SBR (ffmpeg_tpu_torch/codecs/
aacsbr.py, aacsbr_tables.py) and PS (aacps.py, ps_tables.py) on the
port's AAC-LC core (codecs/aac.py), against the reference's decoder
(ffmpeg_tpu/codecs/aac.py with its aacsbr.py and aacps.py on CPU JAX),
on the CPU, through both of the port's entry points: `decode` (packet by
packet) and `decode_frames` (one batched IMDCT, then each packet's SBR
in packet order).

The streams are the cases of tests/test_aacsbr.py and tests/test_aacps.py,
built by their own helpers: the reference binary's AAC-LC encode of a
noise core (or of a sine, for the sine-core case) at 24 kHz, replayed
through tests/golden.py, with crafted SBR payloads (and PS extensions)
spliced into every frame.  Each is also decoded by the reference binary
(the same replayed invocation as the reference's tests), and the port
holds the reference's own bar against it.

Bars.  Against the reference's decode of the same packets: the core
differs from the reference's in float32 rounding only (its IMDCT's sums
in another order), and SBR's LPC and envelope gains carry that further.
On the ten noise-core cases the port measured 117.7-128.3 dB, max
|diff| 1.2e-6 to 2.3e-5 (phase 12's bar of 1e-5 does not hold for two
of them), so the bar is the SNR, >= 100 dB.  On the sine core SBR's
covariance is ill-conditioned (the reference's own note in
tests/test_aacsbr.py::test_sbr_sine_core): the port measured 35.4-37.1
dB against the reference (max |diff| 0.032), which itself differs
between its `decode` and `decode_frames` by up to 0.050 there, so the
bar is the reference's own against the binary, 25 dB.  Against the
reference binary the port measured 117.5-129.4 dB on noise cores and
33.5-35.3 dB on the sine core (the reference 31.8 dB); the bars are
the reference's: 80 dB for SBR and 60 dB for PS on noise cores, 25 dB
on the sine core (tests/test_aacsbr.py, tests/test_aacps.py).
The committed SBR and PS streams of tests/data/port/audio_streams.npz,
which chip_smoke.py decodes on the card, are tied to the reference
here."""

import subprocess

import numpy as np
import pytest

import refutil
from conftest import requires_ref

from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.codecs import aacps as ref_ps
from ffmpeg_tpu.codecs import aacsbr as ref_sbr
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io.stream import CodecParameters as RefParams
from ffmpeg_tpu.utils.rational import Rational as RefRational
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import CodecContext, aac
from ffmpeg_tpu_torch.codecs import aacps, aacsbr
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType
from ffmpeg_tpu_torch.utils.rational import Rational

from test_aacps import write_ps_payload
from test_aacsbr import _make_lc, _make_lc_noise, splice_sbr

RATE = 24000
SNR_NOISE, SNR_SINE = fx.AUDIO_DECODE_MIN_SNR, 25.0


def _sbr(seed, **kw):
    return lambda t: splice_sbr(_make_lc_noise(t), RATE, seed=seed, **kw)


def _ps(seed, **ps_kw):
    """test_aacps.py::_run_ps's stream."""
    def make(t):
        rng = np.random.default_rng(seed)
        ps_bits = write_ps_payload(rng, **ps_kw)
        return splice_sbr(_make_lc_noise(t), RATE, seed=seed,
                          ext_bits=ps_bits)
    return make


# name → (frames maker, the reference's bar against the binary, dB)
CASES = {
    "sbr_sce_seed0": (_sbr(0), 80.0),
    "sbr_sce_seed3": (_sbr(3), 80.0),
    "sbr_multi_env": (_sbr(7, num_env_log2=2, freq_res=1), 80.0),
    "sbr_no_invf": (_sbr(11, invf=0, noise_start=25), 80.0),
    "sbr_sine_core": (lambda t: splice_sbr(_make_lc(t), RATE, seed=0), 25.0),
    "ps_basic_seed1": (_ps(1), 60.0),
    "ps_basic_seed5": (_ps(5), 60.0),
    "ps_iid_fine": (_ps(9, iid_mode=4, icc_mode=1, iid_range=10), 60.0),
    "ps_multi_env": (_ps(13, num_env_idx=2), 60.0),
    "ps_34_bands": (_ps(17, iid_mode=2, icc_mode=2), 60.0),
    "ps_ipdopd": (_ps(21, ipdopd=True), 60.0),
}


def _binary(tmp_path, frames, name):
    """The reference binary's decode (tests/test_aacsbr.py's and
    test_aacps.py's invocation, replayed): (channels, n) float32, its
    mono SBR output as one channel."""
    f = tmp_path / name
    f.write_bytes(b"".join(frames))
    wav = tmp_path / "ref.wav"
    subprocess.run(
        [str(refutil.REF), "-v", "error", "-i", str(f), "-c:a",
         "pcm_f32le", "-y", str(wav)], check=True)
    raw = wav.read_bytes()
    pcm = np.frombuffer(raw[raw.find(b"data") + 8:], np.float32)
    return pcm.reshape(-1, 2).T


def _reference(frames):
    ref = RefContext.open_decoder(RefParams(
        codec_type="audio", codec_id="aac", sample_rate=RATE))
    return ref.decode_all([RefPacket(data=f, pts=i * 1024,
                                     time_base=RefRational(1, RATE))
                           for i, f in enumerate(frames)])


def _port(frames, batched):
    dec = CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.AUDIO, codec_id="aac", sample_rate=RATE),
        device="cpu")
    pkts = [Packet(data=f, pts=i * 1024, time_base=Rational(1, RATE))
            for i, f in enumerate(frames)]
    return dec.decode_frames(pkts) if batched else dec.decode_all(pkts)


def _snr(a, b):
    n = min(a.shape[-1], b.shape[-1])
    return fx.snr_db(a[..., :n], b[..., :n])


@requires_ref
@pytest.mark.parametrize("name", list(CASES))
def test_he_aac_matches_reference(tmp_path, name):
    make, binary_bar = CASES[name]
    frames = make(tmp_path)
    want = _reference(frames)
    wpcm = np.concatenate([np.asarray(f.audio_data) for f in want], axis=1)
    ps = name.startswith("ps")
    assert wpcm.shape[0] == (2 if ps else 1)
    bar = SNR_SINE if "sine" in name else SNR_NOISE
    binary = _binary(tmp_path, frames, "hev2.aac" if ps else "he.aac")
    if not ps:
        # the binary guesses HE-AAC v2 for mono SBR: without PS data both
        # channels are copies of the mono decode
        assert np.array_equal(binary[0], binary[1])
        binary = binary[:1]
    for batched in (False, True):
        got = _port(frames, batched)
        assert len(got) == len(want) == len(frames)
        for g, w in zip(got, want):
            assert (g.pts, g.sample_rate, g.nb_samples, g.duration) == \
                (w.pts, w.sample_rate, w.nb_samples, w.duration) == \
                (g.pts, 2 * RATE, 2048, 2048)
            assert g.ch_layout.mask == w.ch_layout.mask
        pcm = np.concatenate([f.audio_data for f in got], axis=1)
        snr = fx.snr_db(pcm, wpcm)
        assert snr >= bar, (batched, snr, float(np.abs(pcm - wpcm).max()))
        assert _snr(pcm, binary) > binary_bar
    if ps:
        assert not np.allclose(pcm[0], pcm[1])


def test_sbr_payloads_are_decoded_in_packet_order():
    """decode_frames parses every packet before any SBR runs; each
    packet's payloads are still read and applied in the reference's
    order, so its output equals `decode`'s packet by packet (the core's
    IMDCT batched or not: within the noise bar), and its SBR contexts end
    in the same state."""
    st = fx.audio_stream("aac_sbr")
    dec_a = CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.AUDIO, codec_id="aac", sample_rate=RATE),
        device="cpu")
    dec_b = CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.AUDIO, codec_id="aac", sample_rate=RATE),
        device="cpu")
    pkts = [Packet(data=p, pts=t) for p, t in zip(st["packets"], st["pts"])]
    a = fx.audio_pcm(dec_a.decode_frames(pkts))
    b = fx.audio_pcm(dec_b.decode_all(pkts))
    assert fx.snr_db(a, b) >= SNR_NOISE
    (ka, ca), = dec_a.codec._sbr.items()
    (kb, cb), = dec_b.codec._sbr.items()
    assert ka == kb == ("sce", 0)
    assert ca.data[0].t_env_num_env_old == cb.data[0].t_env_num_env_old
    np.testing.assert_array_equal(ca.data[0].env_facs_q,
                                  cb.data[0].env_facs_q)


AAC_NAMES = [n for n in fx.AUDIO_STREAM_NAMES if n.startswith("aac_")]


@pytest.mark.parametrize("name", AAC_NAMES)
def test_committed_streams_match_reference(name):
    """audio_streams.npz's SBR and PS streams against the reference: its
    decoder gives the committed PCM on the committed packets' prefix, and
    the port's decode_frames of them holds the bar against it (the whole
    streams are those of sbr_sce_seed0 and ps_basic_seed1 above;
    chip_smoke.py holds the card's decode of the whole stream against the
    CPU's)."""
    st = fx.audio_stream(name)
    n = fx.AUDIO_PREFIX_PACKETS
    want = _reference(st["packets"][:n])
    np.testing.assert_array_equal(np.concatenate(
        [np.asarray(f.audio_data) for f in want], axis=1), st["prefix"])
    got = fx.audio_decode(st, "cpu", n=n)
    tol, snr = fx.audio_bar(name)
    assert tol is None
    assert fx.snr_db(fx.audio_pcm(got), fx.audio_pcm(want)) >= snr


def test_sbr_and_ps_constants_equal_reference():
    """The QMF matrix and the PS Huffman codes are the reference's (the
    tables: tests/test_torch_host_copies.py)."""
    np.testing.assert_array_equal(aacsbr._imdct64_matrix(),
                                  ref_sbr._imdct64_matrix())
    for n in ("HUFF_ENC", "IID_DF0", "IID_DF1", "ICC_DF", "IPD_DF",
              "OPD_DF"):
        assert getattr(aacps, n) == getattr(ref_ps, n), n
    assert aac.SBRContext is aacsbr.SBRContext


def test_reference_decode_frames_reads_the_first_sbr_payload_twice(
        monkeypatch):
    """A fault of the reference, recorded: its decode_frames
    (ffmpeg_tpu/codecs/aac.py:213-218) parses packets until it meets SBR
    data, then decodes every packet again from the start, so the first
    packet's SBR payload is read into its context twice (26 reads for 25
    packets).  The port's decode_frames reads each payload once, as both
    decoders' `decode` do."""
    st = fx.audio_stream("aac_sbr")
    reads = []
    for mod in (ref_sbr, aacsbr):
        real = mod.SBRContext.decode_extension

        def counting(self, *a, _real=real, _mod=mod):
            reads.append(_mod)
            return _real(self, *a)
        monkeypatch.setattr(mod.SBRContext, "decode_extension", counting)
    ref = RefContext.open_decoder(RefParams(
        codec_type="audio", codec_id="aac", sample_rate=RATE))
    ref.decode_frames([RefPacket(data=p, pts=t)
                       for p, t in zip(st["packets"], st["pts"])])
    assert reads.count(ref_sbr) == len(st["packets"]) + 1
    fx.audio_decode(st, "cpu")
    assert reads.count(aacsbr) == len(st["packets"])
