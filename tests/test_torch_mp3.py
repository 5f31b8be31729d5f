"""The port's MPEG audio decoder, Layers I-III (ffmpeg_tpu_torch/codecs/
mp3.py, with ops/mp3fb.py and mp3_tables.py), against the reference's
(ffmpeg_tpu/codecs/mp3.py, ops/mp3fb.py on CPU JAX), on the CPU.

- every crafted stream of tests/test_mp3.py, built by its own helpers:
  long tone, short blocks, gain/table 15, M/S and L/R stereo, count1
  quads, linbits, preflag, the bit reservoir, MP2 mono and stereo, LSF,
  and Layer I mono and stereo; the reference's demuxer takes the packets
  out, and both decoders decode the same packets;
- `mp3fb.imdct_granule`/`synth_granule` against the reference's on
  seeded inputs (block types 0-3, mixed blocks, state carried over 3
  granules), and the batched packet forms the decoder runs
  (`imdct_packet`, `synth_packet`) against the per-granule chains;
- the state carried across packets: a reference decoder's overlap,
  synthesis FIFO and bit reservoir moved into a port decoder mid-stream
  (`testing.transplant_audio_state`), `flush_state`, and the reset when
  the channel count changes;
- the committed streams of tests/data/port/audio_streams.npz that
  chip_smoke.py decodes on the card, tied to the reference.

Bar (phase 12's audio bar): max |diff| <= 1e-5 of full scale (PCM in
[-1, 1)) and >= 100 dB against the reference's decode of the same
packets.  The host parse is the reference's code; the filterbank is
float32 in both, its sums in other orders (measured up to 4.8e-7 on
Layer I's crafted frames, whose peak is 4.4)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.codecs import mp3 as ref_mp3
from ffmpeg_tpu.io import open_input
from ffmpeg_tpu.ops import mp3fb as ref_fb
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import CodecContext, decoder_names
from ffmpeg_tpu_torch.codecs import mp3 as port_mp3
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType
from ffmpeg_tpu_torch.ops import mp3fb

from test_mp3 import (_huff_code, craft_frame, craft_frame_lsf,
                      craft_mp1_frame, craft_mp2_frame)

TOL, MIN_SNR = fx.AUDIO_DECODE_TOL, fx.AUDIO_DECODE_MIN_SNR


def reservoir_stream() -> bytes:
    """tests/test_mp3.py::test_bit_reservoir's stream: frame 3's main data
    at the tail of frame 2 (main_data_begin), between plain frames."""
    size = 144 * 320000 // 44100
    base = craft_frame(pairs=((1, 1), (2, 0)), table_select=5,
                       global_gain=190)
    md = base[21:]
    bits = 0
    for _ in range(2):
        for (x, y) in ((1, 1), (2, 0)):
            _c, ln = _huff_code(5, x, y)
            bits += ln + (1 if x else 0) + (1 if y else 0)
    k = (bits + 7) // 8
    f1 = base[:size - k] + md[:k]
    b = bytearray(base[:21])
    b[4] = (k >> 1) & 0xFF
    b[5] = (b[5] & 0x7F) | ((k & 1) << 7)
    f2 = bytes(b) + b"\x00" * (size - 21)
    return base + f1 + f2 + base * 2


STREAMS = {
    "long_tone": ("t.mp3", lambda: craft_frame(
        pairs=((1, 1), (2, 0), (0, 3)), table_select=5,
        global_gain=190) * 8),
    "short_blocks": ("s.mp3", lambda: craft_frame(
        pairs=((1, 1), (1, 0)), block_type=2, global_gain=190) * 8),
    "gain_table15": ("g.mp3", lambda: craft_frame(
        pairs=((3, 2), (5, 7)), global_gain=180, table_select=15) * 8),
    "stereo_ms": ("ms.mp3", lambda: craft_frame(
        pairs=((1, 1), (0, 2)), table_select=5, global_gain=188, nch=2,
        ms=True) * 8),
    "stereo_lr": ("lr.mp3", lambda: craft_frame(
        pairs=((2, 1),), table_select=5, global_gain=190, nch=2) * 8),
    "count1_quads": ("q.mp3", lambda: craft_frame(
        pairs=((1, 1),), table_select=5, global_gain=190,
        quads=((1, 0, -1, 0), (0, 1, 0, -1))) * 8),
    "linbits": ("e.mp3", lambda: craft_frame(
        pairs=((1, 1),), escapes=((16, 15),), table_select=16,
        global_gain=170) * 8),
    "preflag_scale": ("sf.mp3", lambda: craft_frame(
        pairs=((1, 1), (2, 2), (0, 3)), table_select=5, global_gain=185,
        sfc=5, scalefacs=(1, 0, 2), preflag=1, sf_scale=1) * 8),
    "bit_reservoir": ("resv.mp3", reservoir_stream),
    "mp2_mono": ("m.mp2", lambda: b"".join(
        craft_mp2_frame(seed=s, nch=1) for s in range(6))),
    "mp2_stereo": ("t.mp2", lambda: b"".join(
        craft_mp2_frame(seed=s, nch=2) for s in range(6))),
    "lsf": ("lsf.mp3", lambda: craft_frame_lsf() * 10),
    "mp1_mono": ("m.mp1", lambda: b"".join(
        craft_mp1_frame(seed=s, nch=1) for s in range(4))),
    "mp1_stereo": ("t.mp1", lambda: b"".join(
        craft_mp1_frame(seed=s, nch=2) for s in range(4))),
}


def _demux(path):
    d = open_input(str(path))
    return d.streams[0].codecpar, list(d.packets())


def _port(ref_pkts):
    return [Packet(data=bytes(p.data), pts=p.pts, time_base=p.time_base)
            for p in ref_pkts]


def _open_port(codec_id, rate=0):
    return CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.AUDIO, codec_id=codec_id, sample_rate=rate),
        device="cpu")


def _run(codec, pkts):
    """Packets through a codec's decode, one at a time: the state carries
    on across calls (CodecContext.decode_all drains)."""
    return [f for p in pkts for f in codec.decode(p)]


def _pcm(frames):
    return np.concatenate([np.asarray(f.audio_data) for f in frames], axis=1)


def assert_bar(got, want, tol=TOL, min_snr=MIN_SNR):
    """The frames' properties equal, their PCM within the bar."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.pts, g.sample_rate, g.nb_samples, g.format, g.duration) \
            == (w.pts, w.sample_rate, w.nb_samples, w.format, w.duration)
        assert g.ch_layout.mask == w.ch_layout.mask
        assert all(isinstance(p, np.ndarray) and p.dtype == np.float32
                   for p in g.planes)
        assert g.audio_data.shape == np.asarray(w.audio_data).shape
    a, b = fx.audio_pcm(got), fx.audio_pcm(want)
    err, snr = float(np.abs(a - b).max()), fx.snr_db(a, b)
    assert (tol is None or err <= tol) and snr >= min_snr, (err, snr)
    return a


@pytest.mark.parametrize("name", list(STREAMS))
def test_crafted_stream_matches_reference(tmp_path, name):
    fname, make = STREAMS[name]
    p = tmp_path / fname
    p.write_bytes(make())
    par, pkts = _demux(p)
    want = RefContext.open_decoder(par).decode_all(pkts)
    dec = _open_port(par.codec_id, par.sample_rate)
    dec.codec.stats = []
    got = dec.decode_all(_port(pkts))
    pcm = assert_bar(got, want)
    assert float(np.abs(pcm).max()) > 1e-3
    assert len(dec.codec.stats) == len(got)
    assert all(s["h2d_bytes"] > 0 and set(s["device"]) ==
               {"h2d", "filterbank", "d2h"} for s in dec.codec.stats)


def _granules(seed, ch=2, n=3):
    """n granules of seeded spectra, block types 0-3 and mixed blocks."""
    rng = np.random.default_rng(seed)
    xr = (rng.standard_normal((n, ch, 32, 18)) * 0.05).astype(np.float32)
    bt = rng.integers(0, 4, (n, ch, 32)).astype(np.int32)
    bt[0] = 2
    bt[0, 0, :2] = 0                    # mixed: first two subbands long
    bt[-1, -1] = [0, 1, 2, 3] * 8
    return xr, bt


def _ref_chain(xr, bt, ch):
    ov = jnp.zeros((ch, 32, 18), jnp.float32)
    fifo = jnp.zeros((ch, 16, 64), jnp.float32)
    sbs, pcms = [], []
    for g in range(len(xr)):
        sb, ov = ref_fb.imdct_granule(jnp.asarray(xr[g]), jnp.asarray(bt[g]),
                                      ov)
        out, fifo = ref_fb.synth_granule(sb, fifo)
        sbs.append(np.asarray(sb))
        pcms.append(np.asarray(out))
    return sbs, pcms, np.asarray(ov), np.asarray(fifo)


@pytest.mark.parametrize("seed", [0, 1])
def test_filterbank_granules_match_reference(seed):
    """imdct_granule and synth_granule, state carried over 3 granules,
    against the reference's; the constant matrices are the reference's."""
    for n in ("_imdct36_matrix", "_imdct12_matrix", "_windows",
              "_short_window", "_synth_matrix", "_synth_window"):
        np.testing.assert_array_equal(getattr(mp3fb, n)(),
                                      getattr(ref_fb, n)())
    xr, bt = _granules(seed)
    sbs, pcms, ov_want, fifo_want = _ref_chain(xr, bt, 2)
    ov = torch.zeros(2, 32, 18)
    fifo = torch.zeros(2, 16, 64)
    for g in range(3):
        sb, ov = mp3fb.imdct_granule(torch.from_numpy(xr[g]),
                                     torch.from_numpy(bt[g]), ov)
        out, fifo = mp3fb.synth_granule(sb, fifo)
        assert tuple(sb.shape) == (2, 18, 32) and tuple(out.shape) == (2, 576)
        assert float(np.abs(sb.numpy() - sbs[g]).max()) <= 1e-6
        assert float(np.abs(out.numpy() - pcms[g]).max()) <= 1e-6
    assert float(np.abs(ov.numpy() - ov_want).max()) <= 1e-6
    assert float(np.abs(fifo.numpy() - fifo_want).max()) <= 1e-6


@pytest.mark.parametrize("ngr,slots", [(2, 36), (1, 12), (3, 54)])
def test_packet_forms_equal_granule_chains(ngr, slots):
    """imdct_packet over a packet's granules equals the per-granule chain,
    and synth_packet over its slots (36 for Layer II, 12 for Layer I,
    18*ngr for Layer III) equals 18-slot (or fewer) synth_granule calls;
    neither writes the state it was given."""
    xr, bt = _granules(7, n=ngr)
    ov0 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 32, 18)).astype(np.float32) * 0.01)
    fifo0 = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 16, 64)).astype(np.float32) * 0.01)
    keep = ov0.clone(), fifo0.clone()
    sb, ov = mp3fb.imdct_packet(torch.from_numpy(xr), torch.from_numpy(bt),
                                ov0)
    ov_c, chain = ov0, []
    for g in range(ngr):
        s, ov_c = mp3fb.imdct_granule(torch.from_numpy(xr[g]),
                                      torch.from_numpy(bt[g]), ov_c)
        chain.append(s)
    assert torch.equal(sb, torch.cat(chain, dim=1))
    assert torch.equal(ov, ov_c)
    subs = (np.random.default_rng(5).standard_normal((2, slots, 32)) * 0.1) \
        .astype(np.float32)
    pcm, fifo = mp3fb.synth_packet(torch.from_numpy(subs), fifo0)
    f, outs = fifo0, []
    for a in range(0, slots, 18):
        o, f = mp3fb.synth_granule(torch.from_numpy(subs[:, a:a + 18]), f)
        outs.append(o)
    assert float((pcm - torch.cat(outs, dim=1)).abs().max()) <= 1e-6
    assert torch.equal(fifo, f)
    assert torch.equal(ov0, keep[0]) and torch.equal(fifo0, keep[1])


def test_state_transplanted_mid_stream(tmp_path):
    """The reference decodes the reservoir stream's first 2 packets; its
    overlap, FIFO and bit reservoir move into a fresh port decoder, and
    both decode the rest (packet 3's main data lies in packet 2)."""
    p = tmp_path / "resv.mp3"
    p.write_bytes(reservoir_stream() * 2)
    par, pkts = _demux(p)
    ref = RefContext.open_decoder(par).codec
    _run(ref, pkts[:2])
    port = _open_port(par.codec_id, par.sample_rate).codec
    fx.transplant_audio_state(ref, port)
    assert port._fifo.dtype == torch.float32
    want = _run(ref, pkts[2:])
    got = _run(port, _port(pkts[2:]))
    assert_bar(got, want)
    assert float(np.abs(got[0].audio_data).max()) > 1e-3   # the reservoir frame


def test_channel_change_and_flush_reset_as_reference(tmp_path):
    """A mono stream, then a stereo one, then a flush and the mono one
    again, through one decoder: the overlap and FIFO reset where the
    reference's do."""
    a, b = tmp_path / "a.mp3", tmp_path / "b.mp3"
    a.write_bytes(STREAMS["short_blocks"][1]())
    b.write_bytes(STREAMS["stereo_ms"][1]())
    (par, pa), (_, pb) = _demux(a), _demux(b)
    ref = RefContext.open_decoder(par).codec
    port = _open_port(par.codec_id, par.sample_rate).codec
    for pk in (pa[:3], pb[:3], None, pa[:3]):
        if pk is None:
            ref.flush_state()
            port.flush_state()
            assert port._overlap is None and port._fifo is None
            continue
        got = _run(port, _port(pk))
        assert_bar(got, _run(ref, pk))
        assert port._fifo.shape[0] == len(got[-1].planes)
        assert port._overlap.shape[0] == len(got[-1].planes)


MP3_NAMES = [n for n in fx.AUDIO_STREAM_NAMES if n.startswith("mp")]


@pytest.mark.parametrize("name", MP3_NAMES)
def test_committed_streams_match_reference(name):
    """audio_streams.npz's MPEG audio streams against the reference: its
    decoder gives the committed PCM on the committed packets' prefix, and
    the port's decode of them holds the bar against it (the whole streams
    repeat the crafted frames of STREAMS, which the test above decodes;
    chip_smoke.py holds the card's decode of the whole stream against the
    CPU's)."""
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
    assert_bar(fx.audio_decode(st, "cpu", n=n), want, *fx.audio_bar(name))


def test_registered_with_device_default_and_device_state(tmp_path):
    import inspect
    assert {"mp3", "mp2", "mp1"} <= set(decoder_names())
    assert inspect.signature(port_mp3.Mp3Decoder).parameters[
        "device"].default == "cuda"
    for n in ("SBLIMIT", "MODE_EXT_MS", "MODE_EXT_I", "_FREQS", "_BR_V1L3",
              "_BR_V2L3"):
        assert getattr(port_mp3, n) == getattr(ref_mp3, n), n
    np.testing.assert_array_equal(port_mp3._SF_TABLE, ref_mp3._SF_TABLE)
    p = tmp_path / "s.mp3"
    p.write_bytes(STREAMS["short_blocks"][1]())
    par, pkts = _demux(p)
    dec = _open_port(par.codec_id, par.sample_rate)
    dec.decode_all(_port(pkts[:2]))
    for t in (dec.codec._overlap, dec.codec._fifo):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
