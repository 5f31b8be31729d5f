"""The port's AC-3 and E-AC-3 decoder (ffmpeg_tpu_torch/codecs/ac3.py, with
ops/ac3fb.py, ac3_tables.py and eac3_tables.py) against the reference's
(ffmpeg_tpu/codecs/ac3.py, ops/ac3fb.py on CPU JAX), on the CPU.

- the streams of tests/test_ac3.py (mono sine, stereo tones, pink noise
  at 32 kHz) and tests/test_eac3.py (stereo noise, 5.1 noise), made by
  the same invocations of the reference binary, byte for byte, each in a
  fresh tmp_path, so that tests/golden.py replays them; the reference's
  demuxer takes the packets out;
- the crafted frames of tests/test_eac3_crafted.py: the adaptive hybrid
  transform with each GAQ mode and an SNR sweep, and spectral extension;
- `ac3fb.imdct_half` and `overlap_window` against the reference's, and
  the frame call the decoder runs (`ac3fb.frame`: all blocks and
  channels at once) against the reference's per-block chain, with
  block-switched blocks, an LFE channel that never switches, and 1, 2,
  3 and 6 blocks;
- the state carried across frames: a reference decoder's delay and
  dither generator moved into a port decoder mid-stream
  (`testing.transplant_audio_state`), and a block that fails to parse
  leaving the delay where the reference's is;
- the committed streams of tests/data/port/audio_streams.npz that
  chip_smoke.py decodes on the card, tied to the reference.

Bar (phase 12's audio bar): max |diff| <= 1e-5 of full scale (PCM in
[-1, 1)) and >= 100 dB against the reference's decode of the same
packets (the reference's own bar against the binary is 3e-5,
tests/test_ac3.py).  The parse, the bit allocation and the dither are
the reference's integer code; the filterbank is the same float32
products (measured equal to the last bit on this CPU, max |diff| 0)."""

import subprocess

import numpy as np
import pytest
import torch

import refutil
from conftest import requires_ref

from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.codecs import ac3 as ref_ac3
from ffmpeg_tpu.io import open_input
from ffmpeg_tpu.io.stream import MediaType as RefMediaType
from ffmpeg_tpu.ops import ac3fb as ref_fb
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import decoder_names
from ffmpeg_tpu_torch.codecs import ac3 as port_ac3
from ffmpeg_tpu_torch.ops import ac3fb

import test_ac3
import test_eac3_crafted as crafted
from test_torch_mp3 import _open_port, _pcm, _port, _run, assert_bar


def _eac3_5_1(tmp_path):
    """tests/test_eac3.py::test_eac3_5_1's invocation, as it is."""
    graph = ";".join(
        f"anoisesrc=duration=1:colour=pink:seed={i}[c{i}]"
        for i in range(6))
    graph += (";" + "".join(f"[c{i}]" for i in range(6)) +
              "amerge=inputs=6,"
              "aformat=sample_fmts=s16:channel_layouts=5.1[out]")
    p = tmp_path / "six.eac3"
    subprocess.run([str(refutil.REF), "-v", "error", "-filter_complex",
                    graph, "-map", "[out]", "-c:a", "eac3", "-b:a",
                    "384k", "-y", str(p)],
                   check=True, capture_output=True)
    return p


def _eac3_stereo_noise(tmp_path):
    """tests/test_eac3.py::test_eac3_stereo_noise's invocation."""
    import test_eac3
    return test_eac3._encode(
        tmp_path, "s.eac3", "anoisesrc=duration=1:colour=pink:seed=11,"
        "aformat=sample_fmts=s16:channel_layouts=stereo", 44100,
        extra=("-b:a", "128k"))


STREAMS = {
    "ac3_mono_sine": lambda t: test_ac3._encode(
        t, "m.ac3", "sine=frequency=440:duration=1", 48000),
    "ac3_stereo": lambda t: test_ac3._encode_stereo(t, 44100, "128k"),
    "ac3_noise_32k": lambda t: test_ac3._encode(
        t, "n.ac3", "anoisesrc=duration=1:colour=pink:seed=7,"
        "aformat=sample_fmts=s16", 32000, extra=("-b:a", "160k")),
    "eac3_stereo_noise": _eac3_stereo_noise,
    "eac3_5_1": _eac3_5_1,
}


def _demux(path):
    d = open_input(str(path))
    st = [s for s in d.streams
          if s.codecpar.codec_type == RefMediaType.AUDIO][0]
    return st.codecpar, [p for p in d.packets()
                         if p.stream_index == st.index]


def _decode_both(path):
    par, pkts = _demux(path)
    want = RefContext.open_decoder(par).decode_all(pkts)
    dec = _open_port(par.codec_id, par.sample_rate)
    dec.codec.stats = []
    got = dec.decode_all(_port(pkts))
    assert len(dec.codec.stats) == len(got)
    return got, want


@requires_ref
@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_matches_reference(tmp_path, name):
    got, want = _decode_both(STREAMS[name](tmp_path))
    pcm = assert_bar(got, want)
    assert float(np.abs(pcm).max()) > 0.05
    if name == "eac3_5_1":
        assert len(got[0].planes) == 6


CRAFTED = {
    **{f"aht_gaq{g}": (lambda g=g: [crafted.craft_aht_frame(100 * g + i, g)
                                    for i in range(4)]) for g in range(4)},
    "aht_snr_sweep": lambda: [crafted.craft_aht_frame(
        7 + i, 3, csnr=10 + 8 * i, fsnr=(3 * i) & 15, bwcode=20 + 10 * i)
        for i in range(4)],
    "spx": lambda: [crafted.craft_spx_frame(50 + i) for i in range(4)],
    "spx_no_atten_recoord": lambda: [crafted.craft_spx_frame(
        90 + i, csnr=24, atten=False, recoord=True) for i in range(4)],
}


@pytest.mark.parametrize("name", list(CRAFTED))
def test_crafted_eac3_matches_reference(tmp_path, name):
    """AHT with GAQ and SPX, which the reference binary's encoder never
    emits; full scale here is the crafted mantissas' (up to ~22), so the
    bar is relative to it."""
    p = tmp_path / f"{name}.eac3"
    p.write_bytes(b"".join(CRAFTED[name]()))
    got, want = _decode_both(p)
    peak = max(1.0, float(np.abs(fx.audio_pcm(want)).max()))
    assert_bar(got, want, tol=fx.AUDIO_DECODE_TOL * peak)


def test_filterbank_matches_reference():
    """The window and matrices are the reference's; imdct_half at 256 and
    128 and overlap_window (batched over blocks) against the reference's
    on seeded inputs."""
    np.testing.assert_array_equal(ac3fb.window(), ref_fb.window())
    for n in (256, 128):
        np.testing.assert_array_equal(ac3fb._imdct_matrix(n),
                                      ref_fb._imdct_matrix(n))
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((12, 256)) * 0.1).astype(np.float32)
    for xs in (x, x[:, 0::2]):
        got = ac3fb.imdct_half(torch.from_numpy(xs.copy())).numpy()
        _close(got, ref_fb.imdct_half(xs))
    d = (rng.standard_normal((5, 128)) * 0.3).astype(np.float32)
    h = (rng.standard_normal((5, 128)) * 0.3).astype(np.float32)
    got = ac3fb.overlap_window(torch.from_numpy(d), torch.from_numpy(h))
    for i in range(5):
        np.testing.assert_array_equal(got[i].numpy(),
                                      ref_fb.overlap_window(d[i], h[i]))


def _close(got, want):
    """float32 sums of up to 256 terms in another order: within 1e-6 of
    the largest magnitude (measured up to 6e-7 of it)."""
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= \
        1e-6 * float(np.abs(want).max())


def _ref_blocks(xf, switched, delay):
    """The reference decoder's per-block, per-channel filterbank
    (ffmpeg_tpu/codecs/ac3.py _decode_block's tail)."""
    delay = delay.copy()
    nblk, nch = switched.shape
    out = np.zeros((nch, nblk * 256), np.float32)
    for blk in range(nblk):
        for ch in range(nch):
            d = delay[ch]
            if switched[blk, ch]:
                h1 = ref_fb.imdct_half(xf[blk, ch][0::2])
                h2 = ref_fb.imdct_half(xf[blk, ch][1::2])
                out[ch, blk * 256:(blk + 1) * 256] = \
                    ref_fb.overlap_window(d, h1)
                delay[ch] = h2
            else:
                h = ref_fb.imdct_half(xf[blk, ch])
                out[ch, blk * 256:(blk + 1) * 256] = \
                    ref_fb.overlap_window(d, h[:128])
                delay[ch] = h[128:]
    return out, delay


@pytest.mark.parametrize("nblk", [1, 2, 3, 6])
def test_frame_call_equals_per_block_chain(nblk):
    """ac3fb.frame over every block and channel against the reference's
    per-block chain, three frames in a row with the delay carried: 5.1
    with the LFE (last channel) never switched and the others switched
    at random, and a frame with no switched block; the delay it was given
    is not written."""
    rng = np.random.default_rng(nblk)
    nch = 6
    delay_t = torch.zeros(nch, 128)
    delay_n = np.zeros((nch, 128), np.float32)
    for f in range(3):
        xf = (rng.standard_normal((nblk, nch, 256)) * 0.1).astype(np.float32)
        sw = rng.random((nblk, nch)) < (0.4 if f != 1 else 0.0)
        sw[:, -1] = False                   # LFE
        keep = delay_t.clone()
        pcm, new = ac3fb.frame(torch.from_numpy(xf), sw, delay_t)
        assert torch.equal(delay_t, keep)
        want, delay_n = _ref_blocks(xf, sw, delay_n)
        assert tuple(pcm.shape) == (nch, nblk * 256)
        _close(pcm.numpy(), want)
        _close(new.numpy(), delay_n)
        delay_t = new


@requires_ref
def test_state_transplanted_mid_stream(tmp_path):
    """The reference decodes the stereo stream's first 10 frames; its
    delay and dither generator move into a fresh port decoder, and both
    decode the rest."""
    par, pkts = _demux(STREAMS["ac3_stereo"](tmp_path))
    ref = RefContext.open_decoder(par).codec
    _run(ref, pkts[:10])
    port = _open_port(par.codec_id, par.sample_rate).codec
    fx.transplant_audio_state(ref, port)
    assert port._dith.state == ref._dith.state
    assert_bar(_run(port, _port(pkts[10:])), _run(ref, pkts[10:]))


@requires_ref
def test_failed_block_leaves_the_reference_delay(tmp_path):
    """A frame whose block 3 fails to parse raises in both decoders, and
    the delay is what the reference leaves (its blocks 0-2 filtered):
    the frame after decodes equal."""
    par, pkts = _demux(STREAMS["ac3_stereo"](tmp_path))
    ref = RefContext.open_decoder(par).codec
    port = _open_port(par.codec_id, par.sample_rate).codec
    for mod, dec in ((ref_ac3, ref), (port_ac3, port)):
        def failing(self, b, st, blk, *a,
                    _real=mod.Ac3Decoder._decode_block, _err=mod.InvalidData):
            if blk == 3 and getattr(self, "fail", False):
                raise _err("ac3: block 3")
            return _real(self, b, st, blk, *a)
        dec._decode_block = failing.__get__(dec)
    _run(ref, pkts[:4])
    _run(port, _port(pkts[:4]))
    ref.fail = port.fail = True
    with pytest.raises(ref_ac3.InvalidData):
        ref.decode(pkts[4])
    with pytest.raises(port_ac3.InvalidData):
        port.decode(_port(pkts[4:5])[0])
    ref.fail = port.fail = False
    np.testing.assert_allclose(port._delay.numpy(), ref._delay, atol=1e-6)
    assert_bar(_run(port, _port(pkts[5:8])), _run(ref, pkts[5:8]))


AC3_NAMES = [n for n in fx.AUDIO_STREAM_NAMES if "ac3" in n]


@pytest.mark.parametrize("name", AC3_NAMES)
def test_committed_streams_match_reference(name):
    """audio_streams.npz's AC-3 and E-AC-3 streams against the reference:
    its decoder gives the committed PCM on the committed packets' prefix,
    and the port's decode of them holds the bar against it (the whole
    streams are the recorded ones of STREAMS and the crafted frames of
    CRAFTED, which the tests above decode; chip_smoke.py holds the card's
    decode of the whole stream against the CPU's)."""
    from ffmpeg_tpu.core.packet import Packet as RefPacket
    from ffmpeg_tpu.io.stream import CodecParameters as RefParams
    from ffmpeg_tpu.utils.rational import Rational
    st = fx.audio_stream(name)
    n = fx.AUDIO_PREFIX_PACKETS
    rp = [RefPacket(data=p, pts=t, time_base=Rational(1, st["sample_rate"]))
          for p, t in zip(st["packets"], st["pts"])]
    ref = RefContext.open_decoder(RefParams(
        codec_type="audio", codec_id=st["codec_id"],
        sample_rate=st["sample_rate"])).codec
    want = _run(ref, rp[:n])
    np.testing.assert_array_equal(_pcm(want), st["prefix"])
    peak = max(1.0, float(np.abs(st["prefix"]).max()))
    tol, snr = fx.audio_bar(name)
    assert_bar(fx.audio_decode(st, "cpu", n=n), want, tol * peak, snr)


def test_registered_with_device_default_and_device_delay():
    import inspect
    assert {"ac3", "eac3"} <= set(decoder_names())
    for cls in (port_ac3.Ac3Decoder, port_ac3.Eac3Decoder):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    a, b = port_ac3._Lfg(0), ref_ac3._Lfg(0)
    assert [a.get_signed() for _ in range(200)] == \
        [b.get_signed() for _ in range(200)]
    pm = list(range(-3, 3))
    qm = list(pm)
    port_ac3._idct6(pm)
    ref_ac3._idct6(qm)
    assert pm == qm
    st = fx.audio_stream("eac3_aht_spx")
    dec = _open_port(st["codec_id"], st["sample_rate"]).codec
    from ffmpeg_tpu_torch.core.packet import Packet
    dec.decode(Packet(data=st["packets"][0]))
    assert isinstance(dec._delay, torch.Tensor)
    assert dec._delay.device.type == "cpu" and dec._delay.shape == (1, 128)
