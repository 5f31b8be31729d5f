"""The port's AAC-LC decoder (ffmpeg_tpu_torch/codecs/aac.py) against the
reference's (ffmpeg_tpu/codecs/aac.py on CPU JAX), on the CPU:

- the committed clip's first 48 packets (48 kHz stereo CPEs, long sine
  windows) through `decode_frames` (one batched IMDCT) and `decode` (per
  packet);
- the recorded reference-oracle streams of tests/test_aac.py, made by the
  same invocations, byte for byte, so that tests/golden.py replays the
  same streams and decodes: the click train that forces EIGHT_SHORT, the
  stereo CPE with M/S, and the 44.1 kHz mono SCE;
- raw packets with AudioSpecificConfig extradata, the refusal of an
  object type the decoder lacks, and a FIL element's SBR data decoded as
  the reference decodes it (tests/test_torch_aac_sbr.py has the SBR and
  PS streams).

Tolerance: 1e-5 absolute on PCM in [-1, 1) against the reference's
decode (the same host arithmetic; the IMDCT's float32 sums differ in
order only, measured 6.9e-7 on the whole committed clip), and the
oracle's own SNR bounds of tests/test_aac.py against the recorded decode.
"""

import subprocess

import numpy as np
import pytest

import refutil
from conftest import requires_ref

from ffmpeg_tpu.codecs import CodecContext as RefCodecContext
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io import open_input
from ffmpeg_tpu.io.stream import CodecParameters as RefCodecParameters
from ffmpeg_tpu_torch.codecs import CodecContext, aac
from ffmpeg_tpu_torch.codecs.bitstream import BitReader, BitWriter
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.formats.channel_layout import default_layout
from ffmpeg_tpu_torch.io.adts import read_adts
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType
from ffmpeg_tpu_torch.testing import AAC_CLIP, snr_db
from ffmpeg_tpu_torch.utils.error import NotSupported

TOL = 1e-5


def _port_decode(par, pkts, batched):
    ctx = CodecContext.open_decoder(par, device="cpu")
    return ctx.decode_frames(pkts) if batched else ctx.decode_all(pkts)


def _ref_decode(path_or_bytes, batched, n=None):
    d = open_input(str(path_or_bytes))
    pkts = list(d.packets())[:n]
    ctx = RefCodecContext.open_decoder(d.streams[0].codecpar)
    return ctx.decode_frames(pkts) if batched else ctx.decode_all(pkts)


def _same_frames(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.pts, g.sample_rate, g.nb_samples, g.format, g.duration) \
            == (w.pts, w.sample_rate, w.nb_samples, w.format, w.duration)
        assert g.ch_layout.mask == w.ch_layout.mask
        assert (g.time_base.num, g.time_base.den) == (w.time_base.num,
                                                      w.time_base.den)
        assert all(isinstance(p, np.ndarray) for p in g.planes)
    a = np.concatenate([f.audio_data for f in got], axis=1)
    b = np.concatenate([np.asarray(f.audio_data) for f in want], axis=1)
    assert a.dtype == np.float32 and a.shape == b.shape
    assert float(np.abs(a - b).max()) <= TOL
    return a


@pytest.mark.parametrize("batched", [True, False],
                         ids=["decode_frames", "decode"])
def test_committed_clip_first_48_packets(batched):
    par, pkts = read_adts(AAC_CLIP.read_bytes())
    got = _port_decode(par, pkts[:48], batched)
    pcm = _same_frames(got, _ref_decode(AAC_CLIP, batched, 48))
    assert pcm.shape == (2, 48 * 1024)


def _window_sequences(par, pkts):
    dec = aac.AacDecoder(par, device="cpu")
    return {ch.ics.window_sequence
            for _, outs, _sbr in dec.parse_packets(pkts) for _, ch in outs}


def test_decode_frames_equals_decode_and_batches_one_imdct_per_class(
        monkeypatch):
    par, pkts = read_adts(AAC_CLIP.read_bytes())
    calls = []
    real = aac.tx.imdct

    def counting(x, n, scale=1.0):
        calls.append((tuple(x.shape), n))
        return real(x, n, scale)
    monkeypatch.setattr(aac.tx, "imdct", counting)
    a = _port_decode(par, pkts[:24], True)
    assert calls == [((48, 1024), 1024)]
    b = _port_decode(par, pkts[:24], False)
    assert len(calls) == 1 + 48
    for fa, fb in zip(a, b):
        np.testing.assert_allclose(fa.audio_data, fb.audio_data, atol=1e-6)
    assert _window_sequences(par, pkts[:24]) == {aac.ONLY_LONG}


# --- the recorded oracle streams of tests/test_aac.py ----------------------
# Each helper repeats test_aac.py's invocation byte for byte: the golden
# cache is keyed by the command line and the input bytes.

def _make_adts(tmp_path, lavfi, name, extra=()):
    p = tmp_path / name
    subprocess.run([str(refutil.REF), "-v", "error", "-f", "lavfi",
                    "-i", lavfi, *extra, "-c:a", "aac", "-b:a", "96k",
                    "-f", "adts", "-y", str(p)],
                   check=True, capture_output=True)
    return p


def _ref(path, ch):
    raw = subprocess.run(
        [str(refutil.REF), "-v", "error", "-f", "aac", "-i", str(path),
         "-f", "s16le", "-"], check=True, capture_output=True).stdout
    return np.frombuffer(raw, np.int16).astype(np.float64).reshape(-1, ch).T / 32768.0


def _mono_sine(tmp_path):
    return _make_adts(tmp_path, "sine=frequency=440:sample_rate=44100",
                      "m.aac", extra=("-t", "1"))


def _stereo_cpe(tmp_path):
    n = 44100
    t = np.arange(n) / 44100
    left = 0.4 * np.sin(2 * np.pi * 523.25 * t) + 0.1 * np.sin(2 * np.pi * 1200 * t)
    right = 0.4 * np.sin(2 * np.pi * 523.25 * t) - 0.1 * np.sin(2 * np.pi * 1200 * t)
    pcm = np.stack([left, right], 1)
    s16 = (np.clip(pcm, -1, 1) * 32767).astype(np.int16)
    p = tmp_path / "s.aac"
    subprocess.run([str(refutil.REF), "-v", "error", "-f", "s16le",
                    "-ar", "44100", "-ac", "2", "-i", "-",
                    "-c:a", "aac", "-b:a", "128k", "-f", "adts", "-y", str(p)],
                   input=s16.tobytes(), check=True, capture_output=True)
    return p


def _transients(tmp_path):
    n = 44100 // 2
    pcm = np.zeros(n)
    pcm[::3000] = 0.9
    pcm += 0.05 * np.sin(2 * np.pi * 800 * np.arange(n) / 44100)
    s16 = (np.clip(pcm, -1, 1) * 32767).astype(np.int16)
    p = tmp_path / "t.aac"
    subprocess.run([str(refutil.REF), "-v", "error", "-f", "s16le",
                    "-ar", "44100", "-ac", "1", "-i", "-",
                    "-c:a", "aac", "-b:a", "96k", "-f", "adts", "-y", str(p)],
                   input=s16.tobytes(), check=True, capture_output=True)
    return p


# (stream maker, channels, oracle SNR bound of test_aac.py)
STREAMS = {"mono_sce": (_mono_sine, 1, 40), "stereo_cpe_ms": (_stereo_cpe, 2, 35),
           "short_windows": (_transients, 1, 25)}


@requires_ref
@pytest.mark.parametrize("batched", [True, False],
                         ids=["decode_frames", "decode"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_recorded_stream_matches_reference(tmp_path, monkeypatch, name,
                                           batched):
    make, nch, bound = STREAMS[name]
    path = make(tmp_path)
    par, pkts = read_adts(path.read_bytes())
    assert par.sample_rate == 44100 and par.channels == nch
    ms_masks = []
    real = aac.AacDecoder._apply_ms_is

    def spy(self, chl, chr_, ms_mask, ms_used):
        ms_masks.append(ms_mask)
        return real(self, chl, chr_, ms_mask, ms_used)
    monkeypatch.setattr(aac.AacDecoder, "_apply_ms_is", spy)
    got = _port_decode(par, pkts, batched)
    pcm = _same_frames(got, _ref_decode(path, batched))
    assert pcm.shape[0] == nch
    seqs = _window_sequences(par, pkts)
    if name == "short_windows":
        assert seqs == {aac.LONG_START, aac.EIGHT_SHORT, aac.LONG_STOP}
    if name == "stereo_cpe_ms":
        assert any(m for m in ms_masks), ms_masks     # M/S on some band
    ref = _ref(path, nch)
    n = min(pcm.shape[1], ref.shape[1])
    assert snr_db(pcm[:, :n], ref[:, :n]) > bound


# --- extradata, refusals ---------------------------------------------------

def _asc(aot: int, sr_idx: int, ch_cfg: int) -> bytes:
    w = BitWriter()
    w.put(aot, 5)
    w.put(sr_idx, 4)
    w.put(ch_cfg, 4)
    if aot == 5:            # explicit HE-AAC: extension rate, core type
        w.put(sr_idx, 4)
        w.put(2, 5)
    w.align()
    return w.bytes()


@pytest.mark.parametrize("aot", [2, 5])
def test_raw_packets_with_asc_match_reference(aot):
    """Headerless packets and an AudioSpecificConfig (the MP4 path):
    AAC-LC, and explicit HE-AAC signalling without SBR data (the core
    decodes, as in the reference)."""
    _, pkts = read_adts(AAC_CLIP.read_bytes())
    raw = [p.data[7:] for p in pkts[:12]]
    asc = _asc(aot, 3, 2)
    par = CodecParameters(codec_type=MediaType.AUDIO, codec_id="aac",
                          extradata=asc, ch_layout=default_layout(2))
    got = _port_decode(par, [Packet(data=r, pts=i * 1024)
                             for i, r in enumerate(raw)], True)
    ref_ctx = RefCodecContext.open_decoder(RefCodecParameters(
        codec_type="audio", codec_id="aac", extradata=asc))
    want = ref_ctx.decode_frames([RefPacket(data=r, pts=i * 1024)
                                  for i, r in enumerate(raw)])
    assert got[0].sample_rate == 48000
    _same_frames(got, want)


def test_unsupported_object_type_raises():
    par = CodecParameters(codec_type=MediaType.AUDIO, codec_id="aac",
                          extradata=_asc(7, 3, 2))
    with pytest.raises(NotSupported, match="object type 7"):
        CodecContext.open_decoder(par, device="cpu")


def _with_fill(pkt: bytes, par, ext: int) -> bytes:
    """The ADTS packet cut after its CPE, then a FIL element whose
    extension type is `ext` (13: EXT_SBR_DATA) with a zero payload, then
    END; the header's frame length rewritten."""
    raw = pkt[7:]
    dec = aac.AacDecoder(par, device="cpu")
    dec.sr_index = 3
    br = BitReader(raw)
    assert br.get(3) == aac.CPE
    br.get(4)
    dec._decode_cpe(br)
    src, w = BitReader(raw), BitWriter()
    left = br.pos
    while left:
        n = min(16, left)
        w.put(src.get(n), n)
        left -= n
    for value, bits in ((aac.FIL, 3), (2, 4), (ext, 4), (0, 12),
                        (aac.END, 3)):
        w.put(value, bits)
    w.align()
    body = w.bytes()
    flen = len(body) + 7
    h = bytearray(pkt[:7])
    h[3] = (h[3] & 0xFC) | (flen >> 11) & 3
    h[4] = (flen >> 3) & 0xFF
    h[5] = (h[5] & 0x1F) | (flen & 7) << 5
    return bytes(h) + body


def test_sbr_data_raises_not_supported():
    """A FIL element with SBR data after a channel element: the port runs
    SBR there as the reference does, through both entry points (before
    SBR was ported this case held the port's NotSupported; it keeps its
    name).  A plain packet, then three whose SBR payload carries no
    header (the QMF banks' 2x upsample of the core), equal the
    reference's decode: the first at 48 kHz, the others at 96 kHz with
    2048 samples; the same packets with a plain fill extension decode at
    the core rate."""
    par, pkts = read_adts(AAC_CLIP.read_bytes())
    fill = [Packet(data=_with_fill(p.data, par, 0), pts=p.pts,
                   time_base=p.time_base) for p in pkts[:3]]
    sbr = [Packet(data=_with_fill(p.data, par, 13), pts=p.pts,
                  time_base=p.time_base) for p in pkts[1:4]]
    assert [f.sample_rate for f in _port_decode(par, fill, True)] == \
        [48000] * 3
    ref = RefCodecContext.open_decoder(RefCodecParameters(
        codec_type="audio", codec_id="aac", sample_rate=48000))
    assert ref.codec._parse_frame(sbr[0].data)[1]   # the reference's SBR
    want = ref.decode_all([RefPacket(data=p.data, pts=p.pts,
                                     time_base=p.time_base)
                           for p in fill[:1] + sbr])
    assert [(f.sample_rate, f.nb_samples) for f in want] == \
        [(48000, 1024)] + [(96000, 2048)] * 3
    for batched in (True, False):
        _same_frames(_port_decode(par, fill[:1] + sbr, batched), want)
