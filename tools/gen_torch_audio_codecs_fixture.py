#!/usr/bin/env python
"""Write tests/data/port/audio_codecs_streams.npz, the answers that the
port's AAC encoder, Vorbis and Opus decoders and audio filters are held
to on the card, from the JAX package on the CPU:

- every stream of ffmpeg_tpu_torch.testing.CODEC_STREAM_NAMES, made by
  tests/torch_audio_codecs_util.py from the recipes of the reference's
  tests/test_vorbis.py, test_opus.py and test_opus_silk.py (the
  reference binary's encodes replay through tests/golden.py), each in a
  fresh directory: its packets, pts and time base, extradata, codec,
  rate and channels (`<name>_data`, `_sizes`, `_pts`, `_params`,
  `_extradata`), and the reference decoder's PCM of its first
  CODEC_PREFIX_PACKETS packets (`<name>_prefix`);
- for each case of testing.AAC_ENC_CASES, the reference encoder's
  packets on testing.aac_signal at that quality: their sha256 and
  sizes, the SNR of the reference decoder's decode of them
  (testing.aac_snr) and the encoder's MDCT scale; for the cases of
  testing.AAC_CHIP_CASES also the band decisions in its packets as the
  reference decoder parses them (levels and scalefactors, int16;
  `ref_decisions`);
- for each chain of testing.AUDIO_CHAINS, the reference's parse_graph
  over testing.audio_chain_inputs: the output (`chain_<name>`), and the
  sha256 and shape of the output without the final aresample
  (`chain_<name>_host`, `chain_<name>_host_shape`; the filters before
  aresample are the same numpy in both packages, so their bar is
  equality).

The card's machine has no JAX, so these answers are committed.  Usage
(about 45 s):

    JAX_PLATFORMS=cpu python tools/gen_torch_audio_codecs_fixture.py
"""

from __future__ import annotations

import hashlib
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


def streams(out: dict) -> None:
    import torch_audio_codecs_util as util
    for name in fx.CODEC_STREAM_NAMES:
        with tempfile.TemporaryDirectory() as d:
            st = util.make_stream(name, Path(d))
        prefix = util.pcm(util.ref_decode(st, fx.CODEC_PREFIX_PACKETS))
        print(f"{name}: {st['codec_id']} {st['channels']} ch, "
              f"{len(st['packets'])} packets, {sum(map(len, st['packets']))} "
              f"bytes; prefix {prefix.shape}", flush=True)
        out[f"{name}_data"] = np.frombuffer(b"".join(st["packets"]),
                                            np.uint8)
        out[f"{name}_sizes"] = np.array([len(p) for p in st["packets"]],
                                        np.int64)
        out[f"{name}_pts"] = np.array(st["pts"], np.int64)
        out[f"{name}_params"] = np.array(
            [st["codec_id"], str(st["sample_rate"]), str(st["channels"]),
             *map(str, st["time_base"])])
        out[f"{name}_extradata"] = np.frombuffer(st["extradata"], np.uint8)
        out[f"{name}_prefix"] = prefix


def ref_decisions(pkts, rate: int, ch: int) -> tuple:
    """The band decisions in the reference encoder's packets, as the
    reference decoder parses them (the levels before dequantisation and
    each band's scalefactor in the encoder's convention: global-gain
    offset removed, 0 where the band is not coded): ((frames, ch, 1024)
    int64, (frames, ch, bands) int64)."""
    from ffmpeg_tpu.codecs import aac as ref_aac
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.io.stream import CodecParameters, MediaType
    got = []
    parse = ref_aac.AacDecoder._decode_ics_element

    def capture(self, br, common_ics=None):
        c = parse(self, br, common_ics)
        got.append((c.coeffs.copy(), list(c.band_cb[0]),
                    list(c.band_sf[0])))
        return c
    ref_aac.AacDecoder._decode_ics_element = capture
    try:
        CodecContext.open_decoder(CodecParameters(
            codec_type=MediaType.AUDIO, codec_id="aac",
            sample_rate=rate)).decode_all(pkts)
    finally:
        ref_aac.AacDecoder._decode_ics_element = parse
    levels = np.array([c for c, _, _ in got], np.int64)
    sfs = np.array([[s - 100 if cb else 0 for cb, s in zip(cbs, sf)]
                    for _, cbs, sf in got], np.int64)
    return (levels.reshape(-1, ch, 1024),
            sfs.reshape(len(levels) // ch, ch, -1))


def aac(out: dict) -> None:
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.formats.channel_layout import default_layout
    from ffmpeg_tpu.io.stream import CodecParameters, MediaType
    from test_aac_enc import _encode, _our_decode
    for name, (rate, ch, n, q) in fx.AAC_ENC_CASES.items():
        sig = fx.aac_signal(n, rate, ch)
        pkts = _encode(sig, rate, q)
        snr = fx.aac_snr(_our_decode(pkts, rate, ch), sig)
        enc = CodecContext.open_encoder(CodecParameters(
            codec_type=MediaType.AUDIO, codec_id="aac", sample_rate=rate,
            ch_layout=default_layout(ch)), {"quality": q}).codec
        levels, sfs = ref_decisions(pkts, rate, ch)
        assert len(levels) == len(pkts), (levels.shape, len(pkts))
        out[f"{name}_sha256"] = np.array(
            [hashlib.sha256(bytes(p.data)).hexdigest() for p in pkts])
        out[f"{name}_sizes"] = np.array([len(p.data) for p in pkts],
                                        np.int64)
        out[f"{name}_snr"] = np.float64(snr)
        out[f"{name}_scale"] = np.float64(enc._spec_scale)
        if name in fx.AAC_CHIP_CASES:
            out[f"{name}_levels"] = levels.astype(np.int16)
            out[f"{name}_sf"] = sfs.astype(np.int16)
        print(f"{name}: {len(pkts)} packets, {sum(len(p.data) for p in pkts)}"
              f" bytes, decode SNR {snr:.4f} dB", flush=True)


def chains(out: dict) -> None:
    from ffmpeg_tpu.core.frame import Frame
    from ffmpeg_tpu.filters import parse_graph
    from ffmpeg_tpu.formats.channel_layout import default_layout
    from ffmpeg_tpu.utils.rational import Rational
    inputs = {k: [Frame.audio(f.audio_data, f.sample_rate, "fltp",
                              default_layout(f.audio_data.shape[0]),
                              pts=f.pts, time_base=Rational(1, f.sample_rate))
                  for f in v]
              for k, v in fx.audio_chain_inputs().items()}
    for name in fx.AUDIO_CHAINS:
        host = fx.run_audio_chain(parse_graph, name, inputs, False)
        out[f"chain_{name}"] = fx.run_audio_chain(parse_graph, name, inputs)
        out[f"chain_{name}_host"] = np.array(fx.audio_chain_digest(host))
        out[f"chain_{name}_host_shape"] = np.array(host.shape, np.int64)
        print(f"{name}: {host.shape} → {out[f'chain_{name}'].shape}",
              flush=True)


if __name__ == "__main__":
    out: dict = {}
    streams(out)
    aac(out)
    chains(out)
    np.savez_compressed(fx.AUDIO_CODECS, **out)
    print(f"{fx.AUDIO_CODECS}: {fx.AUDIO_CODECS.stat().st_size} bytes")
