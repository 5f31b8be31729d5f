"""The port's Vorbis decoder (ffmpeg_tpu_torch/codecs/vorbis.py, with
vorbis_tables.py) against the reference's (ffmpeg_tpu/codecs/vorbis.py,
its IMDCT on CPU JAX), on the CPU, on the three streams of
tests/test_vorbis.py: the reference binary's encodes (sine, the same
sine as "stereo coupled", wideband noise), made by the same recorded
invocations, each in a fresh directory, so that tests/golden.py replays
them; the reference's matroska demuxer takes the packets out.

Bar (testing.audio_bar): max |diff| <= 1e-5 of full scale and >= 100
dB against the reference's decode of the same packets, at the same
sample count.  The host parse is the reference's code; the IMDCT is
float32 in both, its sums in other orders (measured up to 4.3e-7 on the
noise stream, 128.9 dB).  The port makes one IMDCT per packet over the
channels, where the reference makes one per channel; that batch equals
per-channel calls within 1e-5 of full scale.
"""

import numpy as np
import pytest
import torch

from ffmpeg_tpu.codecs import vorbis as ref_vorbis
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import decoder_names
from ffmpeg_tpu_torch.codecs import vorbis
from ffmpeg_tpu_torch.ops import tx

import torch_audio_codecs_util as util

NAMES = fx.VORBIS_STREAM_NAMES


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_reference(name, tmp_path_factory):
    st = util.made(name, tmp_path_factory)
    want = util.pcm(util.ref_decode(st))
    got = util.pcm(fx.codec_decode(util.port_stream(st), "cpu"))
    util.assert_close(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_ties_to_reference(name, tmp_path_factory):
    """audio_codecs_streams.npz's stream against the one made now, and its
    prefix against the reference's decode of that stream's first
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


def test_one_imdct_per_packet(monkeypatch, tmp_path_factory):
    """One tx.imdct call per audio packet, over every channel with a
    floor, (channels, n/2); and its split in `stats`."""
    st = util.made("vorbis_noise", tmp_path_factory)
    calls = []
    imdct = tx.imdct

    def counting(x, n, scale=1.0):
        calls.append((tuple(x.shape), n))
        return imdct(x, n, scale)
    monkeypatch.setattr(vorbis.tx, "imdct", counting)
    stats = []
    frames = fx.codec_decode(util.port_stream(st), "cpu", stats)
    assert len(calls) == len(st["packets"]) == len(stats)
    assert all(shape == (2, n) for shape, n in calls)
    # the reference binary's encoder codes these streams in long blocks
    assert {n for _, n in calls} == {1024}
    assert len(frames) == len(st["packets"]) - 1
    assert all(s["h2d_bytes"] * 2 == s["d2h_bytes"] for s in stats)


def test_batched_imdct_matches_per_channel(monkeypatch, tmp_path_factory):
    """The decode with one IMDCT per channel, as the reference calls it,
    against the batched decode: within 1e-5 of full scale."""
    st = util.port_stream(util.made("vorbis_noise", tmp_path_factory))
    batched = util.pcm(fx.codec_decode(st, "cpu"))
    imdct = tx.imdct
    monkeypatch.setattr(vorbis.tx, "imdct", lambda x, n, scale=1.0: torch.cat(
        [imdct(row[None], n, scale) for row in x]))
    single = util.pcm(fx.codec_decode(st, "cpu"))
    util.assert_close(single, batched)


def test_flush_state_and_fresh_decoder_as_reference(tmp_path_factory):
    """Half the stream, flush_state (a seek), the rest: the same output as
    the reference's decoder driven the same way."""
    from ffmpeg_tpu.codecs import CodecContext as RefContext
    from ffmpeg_tpu.core.packet import Packet as RefPacket
    from ffmpeg_tpu.formats.channel_layout import default_layout
    from ffmpeg_tpu.io.stream import CodecParameters, MediaType
    raw = util.made("vorbis_sine", tmp_path_factory)
    st = util.port_stream(raw)
    ref = RefContext.open_decoder(CodecParameters(
        codec_type=MediaType.AUDIO, codec_id="vorbis",
        sample_rate=raw["sample_rate"], ch_layout=default_layout(2),
        extradata=raw["extradata"]))
    port = fx.codec_decoder(st, "cpu")
    pkts = fx.codec_packets(st)
    got, want = [], []
    for i, p in enumerate(pkts):
        if i == 10:
            ref.flush()
            port.flush()
        for dec, out, pk in ((port, got, p),
                             (ref, want, RefPacket(data=p.data, pts=p.pts))):
            dec.send_packet(pk)
            out.extend(_drain(dec))
    util.assert_close(util.pcm(got), util.pcm(want))
    assert len(got) == len(want) == len(pkts) - 2


def _drain(dec):
    from ffmpeg_tpu.utils.error import TryAgain as RefTryAgain
    from ffmpeg_tpu_torch.utils.error import TryAgain
    out = []
    while True:
        try:
            out.append(dec.receive_frame())
        except (TryAgain, RefTryAgain):
            return out


def test_xiph_split_and_setup_equal_reference(tmp_path_factory):
    """The Xiph-laced extradata split and the parsed setup (blocksizes,
    codebook count, floors, residues, modes) as the reference's."""
    st = util.made("vorbis_noise", tmp_path_factory)
    ed = st["extradata"]
    assert vorbis._split_xiph(ed) == ref_vorbis._split_xiph(ed)
    assert vorbis._split_xiph(b"") == ref_vorbis._split_xiph(b"") == []
    port = fx.codec_decoder(util.port_stream(st), "cpu").codec
    from ffmpeg_tpu.io.stream import CodecParameters
    ref = ref_vorbis.VorbisDecoder(CodecParameters(extradata=ed))
    assert (port.channels, port.sample_rate, port.blocksize, port.modes) \
        == (ref.channels, ref.sample_rate, ref.blocksize, ref.modes)
    assert [(b.dim, b.lookup_type) for b in port.books] == \
        [(b.dim, b.lookup_type) for b in ref.books]
    np.testing.assert_array_equal(vorbis.INVERSE_DB_TABLE,
                                  ref_vorbis.INVERSE_DB_TABLE)


def test_registered_and_defaults_to_the_card(tmp_path_factory):
    import inspect
    assert "vorbis" in decoder_names()
    assert inspect.signature(vorbis.VorbisDecoder).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fx.codec_decoder(util.port_stream(
                util.made("vorbis_sine", tmp_path_factory)), "cuda")
