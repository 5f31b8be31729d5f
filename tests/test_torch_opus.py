"""The port's Opus decoder (ffmpeg_tpu_torch/codecs/opus/: the TOC parse,
CELT with its IMDCT on the decoder's device, SILK, its resampler,
hybrid and the mode switches) against the reference's
(ffmpeg_tpu/codecs/opus/, the CELT IMDCT on CPU JAX), on the CPU:

- the five CELT streams of tests/test_opus.py, the reference binary's
  encodes (sine, mono, noise with transients, short blocks and
  anti-collapse, 256 kb/s, 16 kb/s), made by the same recorded
  invocations, each in a fresh directory, so that tests/golden.py
  replays them;
- the SILK streams (configs 1, 5, 9 at 20 ms, 10 ms, 60 ms, NB 40 ms,
  stereo), the hybrid streams (configs 13 and 15 mono, 12 stereo at
  10 ms) and the SILK → CELT → SILK mode-switch stream of
  tests/test_opus_silk.py, crafted by its writers with its seeds.

Bar (testing.audio_bar): max |diff| <= 1e-5 of full scale and >= 100
dB against the reference's decode of the same packets, at the same
sample count.  SILK is the reference's host code and decodes bit-exact;
the CELT IMDCT is float32 in both, its sums in other orders (measured up
to 8.3e-7 on the noise stream, 124.6 dB).  The port makes one IMDCT per
CELT frame over every channel and short block, where the reference makes
one per channel and block; that batch equals per-block calls within
1e-5 of full scale.
"""

import pytest
import torch

from ffmpeg_tpu.codecs import opus as ref_opus
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import decoder_names
from ffmpeg_tpu_torch.codecs import opus
from ffmpeg_tpu_torch.codecs.opus import celt
from ffmpeg_tpu_torch.ops import tx

import torch_audio_codecs_util as util

NAMES = fx.CELT_STREAM_NAMES + fx.SILK_STREAM_NAMES


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_reference(name, tmp_path_factory):
    st = util.made(name, tmp_path_factory)
    want = util.pcm(util.ref_decode(st))
    got = util.pcm(fx.codec_decode(util.port_stream(st), "cpu"))
    util.assert_close(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_ties_to_reference(name, tmp_path_factory):
    """audio_codecs_streams.npz's stream against the one made now (the
    binary's replayed encode or test_opus_silk.py's writers), and its
    prefix against the reference's decode of its first
    CODEC_PREFIX_PACKETS packets."""
    st = util.made(name, tmp_path_factory)
    z = fx.codec_stream(name)
    assert z["packets"] == st["packets"] and z["pts"] == st["pts"]
    assert (z["codec_id"], z["sample_rate"], z["channels"],
            z["extradata"]) == (st["codec_id"], st["sample_rate"],
                                st["channels"], st["extradata"])
    assert (z["time_base"].num, z["time_base"].den) == st["time_base"]
    util.assert_close(z["prefix"], util.pcm(util.ref_decode(
        st, fx.CODEC_PREFIX_PACKETS)))


@pytest.mark.parametrize("name", ["celt_noise", "hybrid_stereo_10ms",
                                  "mode_switch"])
def test_one_imdct_per_celt_frame(name, monkeypatch, tmp_path_factory):
    """One tx.imdct call per CELT frame, over every output channel and
    short block, (channels·blocks, blocksize); none for a SILK frame;
    each call's split in `stats`."""
    st = util.made(name, tmp_path_factory)
    calls = []
    imdct = tx.imdct

    def counting(x, n, scale=1.0):
        calls.append((tuple(x.shape), n))
        return imdct(x, n, scale)
    monkeypatch.setattr(celt.tx, "imdct", counting)
    stats = []
    fx.codec_decode(util.port_stream(st), "cpu", stats)
    want = []            # each CELT frame's samples over its channels
    for p in st["packets"]:
        config, _stereo, frames = ref_opus.parse_packet(p)
        if config >= 12:
            size = int(opus.T.FRAME_DURATION[config])
            want += [st["channels"] * size for f in frames if f]
    assert len(calls) == len(want) == len(stats)
    assert [rows * n for (rows, n), _ in calls] == want
    assert all(n == nn and n in (120, 240, 480, 960) for (_, n), nn in calls)
    if name == "celt_noise":
        # transient frames: eight short blocks a channel
        assert ((16, 120), 120) in calls and ((2, 960), 960) in calls


def test_batched_imdct_matches_per_block(monkeypatch, tmp_path_factory):
    """The noise stream (transients, short blocks, anti-collapse) with one
    IMDCT per channel and block, as the reference calls it, against the
    batched decode: within 1e-5 of full scale."""
    st = util.port_stream(util.made("celt_noise", tmp_path_factory))
    batched = util.pcm(fx.codec_decode(st, "cpu"))
    imdct = tx.imdct
    monkeypatch.setattr(celt.tx, "imdct", lambda x, n, scale=1.0: torch.cat(
        [imdct(row[None], n, scale) for row in x]))
    single = util.pcm(fx.codec_decode(st, "cpu"))
    util.assert_close(single, batched)


@pytest.mark.parametrize("name", ["mode_switch", "celt_sine"])
def test_flush_state_as_reference(name, tmp_path_factory):
    """Part of the stream, flush_state (a seek: the CELT, SILK and
    resampler state and the pre-skip reset), the rest, then the drain:
    the same output as the reference's decoder driven the same way."""
    from ffmpeg_tpu.codecs import CodecContext as RefContext
    from ffmpeg_tpu.core.packet import Packet as RefPacket
    from ffmpeg_tpu.formats.channel_layout import default_layout
    from ffmpeg_tpu.io.stream import CodecParameters, MediaType
    raw = util.made(name, tmp_path_factory)
    st = util.port_stream(raw)
    ref = RefContext.open_decoder(CodecParameters(
        codec_type=MediaType.AUDIO, codec_id="opus", sample_rate=48000,
        ch_layout=default_layout(raw["channels"]),
        extradata=raw["extradata"]))
    port = fx.codec_decoder(st, "cpu")
    got, want = [], []
    pkts = fx.codec_packets(st)
    for i, p in enumerate(pkts):
        if i == 6:
            ref.flush()
            port.flush()
        port.send_packet(p)
        ref.send_packet(RefPacket(data=p.data, pts=p.pts))
        got.extend(_drain(port))
        want.extend(_drain(ref))
    port.send_packet(None)
    ref.send_packet(None)
    got.extend(_drain(port))
    want.extend(_drain(ref))
    assert len(got) == len(want)
    util.assert_close(util.pcm(got), util.pcm(want))


def _drain(dec):
    from ffmpeg_tpu.utils.error import EndOfStream as RefEnd
    from ffmpeg_tpu.utils.error import TryAgain as RefTryAgain
    from ffmpeg_tpu_torch.utils.error import EndOfStream, TryAgain
    out = []
    while True:
        try:
            out.append(dec.receive_frame())
        except (TryAgain, RefTryAgain, EndOfStream, RefEnd):
            return out


def test_toc_parse_equals_reference(tmp_path_factory):
    """parse_packet on every packet of every stream, and on code 1-3
    packets (CBR, VBR, padding) and malformed ones, as the reference."""
    from ffmpeg_tpu.utils.error import InvalidData as RefInvalid
    from ffmpeg_tpu_torch.utils.error import InvalidData
    pkts = [p for n in NAMES for p in fx.codec_stream(n)["packets"]]
    toc = bytes([(16 << 3) | 3])
    pkts += [bytes([(16 << 3) | 1]) + b"\x01\x02\x03\x04",
             bytes([(16 << 3) | 2]) + b"\x02\x01\x02\x03\x04",
             toc + bytes([0x83]) + b"\x01\x02" + b"abcdef",
             toc + bytes([0xC2, 3, 2]) + b"xyzuvw\x00\x00\x00",
             toc + bytes([0x02]) + b"abcd"]
    for p in pkts:
        assert opus.parse_packet(p) == ref_opus.parse_packet(p)
    for bad in (b"", bytes([(16 << 3) | 1]) + b"\x01\x02\x03",
                toc + b"\x00", toc):
        with pytest.raises(RefInvalid):
            ref_opus.parse_packet(bad)
        with pytest.raises(InvalidData):
            opus.parse_packet(bad)


def test_registered_and_defaults_to_the_card(tmp_path_factory):
    import inspect
    assert "opus" in decoder_names()
    assert inspect.signature(opus.OpusDecoder).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fx.codec_decoder(util.port_stream(
                util.made("silk_10ms", tmp_path_factory)), "cuda")
