"""The port's container modules that need no new codec (io/parsers.py and
io/formats/ogg.py, mpegts.py, avi.py, flv.py, mlpraw.py, webpfmt.py,
exrfmt.py, srt.py, webvtt.py and assfmt.py) against the reference's, on
the CPU.

- Each module is the reference's code: its top-level statements equal
  the reference's as syntax trees.
- Each muxer (MPEG-TS, AVI, FLV, WebP, SRT, WebVTT, ASS), fed the same
  packets as the reference's, writes the same bytes, or raises the same
  error where the reference refuses a codec.  The packets: the H.264,
  HEVC, MPEG-2, MPEG-4 Part 2, MJPEG and raw video of the committed
  fixtures and the port's encoder; AAC, MP3, MP2, AC-3, E-AC-3 and PCM
  audio; subtitles read from crafted text files.
- Each demuxer gives the reference's streams and packets (plain: data,
  pts, dts, duration, flags, stream index, position, side data) on the
  files the reference's muxers wrote, on crafted MLP, TrueHD, WebP, EXR
  and subtitle files, and on Ogg files of the committed Vorbis and Opus
  packets whose pages testing.ogg_stream writes (the reference has no
  Ogg muxer): packets across pages, several in a page, 255-byte lacing
  edges, an end-trimmed last page and two multiplexed streams.
- The Ogg demuxer's Vorbis extradata is the xiph-laced layout the port's
  Vorbis decoder reads: packets demuxed from an Ogg file decode as the
  committed packets do.
- parsers.SPLITTERS split ADTS and MPEG audio as the reference's do.
- The ported demuxers' probes score every head as the reference's, and
  the registry holds them in the reference's order.
"""

import struct

import numpy as np
import pytest

from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io import demux as ref_demux
from ffmpeg_tpu.io import parsers as ref_parsers
from ffmpeg_tpu.io import probe_format as ref_probe
from ffmpeg_tpu.io.stream import CodecParameters as RefPar
from ffmpeg_tpu.io.stream import MediaType as RefType
from ffmpeg_tpu.utils.rational import Rational as RefRational
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import CodecContext
from ffmpeg_tpu_torch.codecs.vorbis import _split_xiph
from ffmpeg_tpu_torch.io import demux, open_input, parsers, probe_format

from torch_io_util import (DATA, SOURCES, assert_same_decode,
                           assert_same_demux, demuxed,
                           differing, mux_with)

MODULES = ["io/parsers.py"] + [f"io/formats/{m}.py" for m in (
    "ogg", "mpegts", "avi", "flv", "mlpraw", "webpfmt", "exrfmt", "srt",
    "webvtt", "assfmt")]


@pytest.mark.parametrize("rel", MODULES)
def test_module_is_the_reference_code(rel):
    assert differing(rel) == set()


# --- crafted inputs ----------------------------------------------------------

SRT = ("﻿1\r\n00:00:01,000 --> 00:00:03,500\r\nHello <i>world</i>\r\n"
       "\r\n2\n00:00:04,000 --> 00:00:06,000\nSecond line\nwith a break\n\n"
       "3\n00:01:02.250 --> 00:01:04.750\n{\\an8}Styled & text\n")

VTT = """WEBVTT - sample

NOTE a comment block
spanning two lines

STYLE
::cue { color: lime }

intro
00:00:01.000 --> 00:00:03.500 align:start position:10%
Hello <b>world</b> &amp;友達

01:00.250 --> 01:02.000
Second cue
with two lines

00:01:05.000 --> 00:01:06.500
third
"""

ASS = """[Script Info]
; a comment
ScriptType: v4.00+
PlayResX: 384
PlayResY: 288

[V4+ Styles]
Format: Name, Fontname, Fontsize, PrimaryColour, Bold, Alignment
Style: Default,Arial,16,&Hffffff,0,2

[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:01.00,0:00:03.50,Default,,0,0,0,,Hello {\\i1}world{\\i0}
Comment: 0,0:00:02.00,0:00:03.00,Default,,0,0,0,,not shown
Dialogue: 1,0:00:04.00,0:00:06.00,Default,Bob,10,10,5,,Second\\Nline
Dialogue: 0,0:01:02.25,0:01:04.75,Default,,0,0,0,,{\\an8}Styled
"""


def _mlp(sync: bytes, rate_byte: int, n: int, seed: int) -> bytes:
    """Raw MLP/TrueHD access units: the check nibble and 12-bit length in
    16-bit words, a timing word, a major sync (with the rate code the
    demuxer reads) every eighth unit, seeded payload."""
    rng = np.random.default_rng(seed)
    out = b""
    for i in range(n):
        body = b""
        if i % 8 == 0:
            body = sync + bytes([rate_byte, rate_byte]) + bytes(22)
        body += rng.integers(0, 256, 2 * int(rng.integers(8, 40)),
                             np.uint8).tobytes()
        words = (len(body) + 4) // 2
        out += struct.pack(">HH", 0xF000 | words, i * 40 & 0xFFFF) + body
    return out


def _webp(w: int, h: int, seed: int) -> bytes:
    """A RIFF WEBP file with a VP8 chunk: keyframe tag, start code and
    dimensions, then seeded bytes."""
    rng = np.random.default_rng(seed)
    vp8 = (b"\x50\x02\x00\x9d\x01\x2a" + struct.pack("<HH", w, h)
           + rng.integers(0, 256, 300, np.uint8).tobytes())
    body = b"WEBP" + b"VP8 " + struct.pack("<I", len(vp8)) + vp8
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _exr(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return b"\x76\x2f\x31\x01" + struct.pack("<I", 2) + rng.integers(
        0, 256, 500, np.uint8).tobytes()


def _ogg_pages(data: bytes) -> list:
    """An Ogg stream cut into its pages."""
    out, i = [], 0
    while i < len(data):
        n = data[i + 26]
        size = 27 + n + sum(data[i + 27:i + 27 + n])
        out.append(data[i:i + size])
        i += size
    return out


def _ogg_edges(name: str, serial: int = 1) -> bytes:
    """The headers of a committed stream and seeded packets of 255, 510,
    254, 256, 0, 4000 and 1 bytes (lacing edges, an empty packet, one
    over many pages) on 600-byte pages."""
    st = fx.codec_stream(name)
    rng = np.random.default_rng(len(name))
    pkts = [bytes(st["packets"][0][:1]) + rng.bytes(n - 1) if n else b""
            for n in (255, 510, 254, 256, 0, 4000, 1)]
    headers = [st["extradata"], fx.OPUS_TAGS] if st["codec_id"] == "opus" \
        else _split_xiph(st["extradata"])
    return fx.ogg_stream(headers, pkts, [960 * (i + 1) for i in
                                         range(len(pkts))],
                         serial=serial, page_bytes=600)


def _ogg_mux(a: bytes, b: bytes) -> bytes:
    """Two logical streams in one file: both BOS pages first, then the
    pages taken in turn."""
    pa, pb = _ogg_pages(a), _ogg_pages(b)
    rest = []
    for i in range(max(len(pa), len(pb))):
        rest += pa[1 + i:2 + i] + pb[1 + i:2 + i]
    return b"".join([pa[0], pb[0]] + rest)


OGG = {
    **{f"{n}_{pb}": (lambda n=n, pb=pb: fx.codec_stream_ogg(
        fx.codec_stream(n), page_bytes=pb))
       for n in ("vorbis_sine", "vorbis_noise", "celt_sine", "celt_mono",
                 "celt_256k", "silk_cfg1_20ms", "hybrid_cfg13",
                 "mode_switch")
       for pb in (4096, 100)},
    "celt_16k_trimmed": lambda: fx.codec_stream_ogg(
        fx.codec_stream("celt_16k"), eos_granule=24000),
    "vorbis_stereo_trimmed": lambda: fx.codec_stream_ogg(
        fx.codec_stream("vorbis_stereo"), page_bytes=300,
        eos_granule=25000),
    "opus_edges": lambda: _ogg_edges("celt_noise"),
    "vorbis_edges": lambda: _ogg_edges("vorbis_sine"),
    "vorbis_opus_muxed": lambda: _ogg_mux(
        fx.codec_stream_ogg(fx.codec_stream("vorbis_sine"), page_bytes=500),
        _ogg_edges("celt_mono", serial=2)),
}


# --- the reference's packets: SOURCES and the committed streams --------------

def _raw_audio(tmp, name: str, ext: str):
    z = np.load(DATA / "port" / "audio_streams.npz")
    p = tmp / f"{name}.{ext}"
    p.write_bytes(z[f"{name}_data"].tobytes())
    return demuxed(p)


def _mpeg2(tmp):
    """Three pictures of the port's MPEG-2 encoder at 48x32, through the
    reference's raw MPEG video demuxer."""
    from ffmpeg_tpu_torch.codecs import EncoderParameters
    enc = CodecContext.open_encoder(EncoderParameters("mpeg2video", 48, 32),
                                    {"qscale": 6}, device="cpu")
    data = b""
    for f in fx.mpeg2_clip(3, 48, 32):
        enc.send_frame(f)
        data += enc.receive_packet().data
    (tmp / "c.m2v").write_bytes(data)
    return demuxed(tmp / "c.m2v")


def _mpeg4():
    """The committed MPEG-4 Part 2 stream with B frames, in decode
    order, with its extradata."""
    st = fx.mpeg4_stream("mpeg4_bframes")
    par = RefPar(codec_type=RefType.VIDEO, codec_id="mpeg4",
                 width=st["width"], height=st["height"],
                 extradata=st["extradata"], framerate=RefRational(25, 1))
    tb = RefRational(1, 25)
    pkts = [RefPacket(data=d, pts=t, dts=i, flags=int(k == "I"),
                      time_base=tb)
            for i, (d, t, k) in enumerate(zip(st["packets"], st["pts"],
                                              st["types"]))]
    return [(par, tb)], pkts


def _subs(tmp, name: str, text: str):
    p = tmp / name
    p.write_text(text, encoding="utf-8")
    return demuxed(p)


def _webp_source():
    par = RefPar(codec_type=RefType.VIDEO, codec_id="webp", width=40,
                 height=24)
    return [(par, RefRational(1, 25))], [RefPacket(
        data=_webp(40, 24, 3), pts=0, dts=0, flags=1,
        time_base=RefRational(1, 25))]


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("src")
    out = {k: v for k, v in SOURCES.items()}
    out.update({
        "hevc": lambda: demuxed(DATA / "port" / "hevc_crafted_64x64.hevc"),
        "mpeg2": lambda: _mpeg2(tmp),
        "mpeg4": _mpeg4,
        "mp3": lambda: _raw_audio(tmp, "mp3_reservoir", "mp3"),
        "mp2": lambda: _raw_audio(tmp, "mp2_stereo", "mp2"),
        "ac3": lambda: _raw_audio(tmp, "ac3_stereo", "ac3"),
        "eac3": lambda: _raw_audio(tmp, "eac3_5_1", "eac3"),
        "srt": lambda: _subs(tmp, "s.srt", SRT),
        "vtt": lambda: _subs(tmp, "s.vtt", VTT),
        "ass": lambda: _subs(tmp, "s.ass", ASS),
        "webp": _webp_source,
    })
    return out


# (format, file name, source)
MUXES = [
    ("mpegts", "h.ts", "h264"), ("mpegts", "e.ts", "hevc"),
    ("mpegts", "m.ts", "mpeg2"), ("mpegts", "p4.ts", "mpeg4"),
    ("mpegts", "a.ts", "aac"), ("mpegts", "m3.ts", "mp3"),
    ("mpegts", "m2.ts", "mp2"), ("mpegts", "c.ts", "ac3"),
    ("mpegts", "av.ts", "av"), ("mpegts", "j.ts", "mjpeg"),
    ("mpegts", "x.ts", "eac3"),
    ("avi", "j.avi", "mjpeg"), ("avi", "r.avi", "rawvideo"),
    ("avi", "p.avi", "pcm_s16le"), ("avi", "s.avi", "pcm_s16le_stereo"),
    ("avi", "h.avi", "h264"), ("avi", "p4.avi", "mpeg4"),
    ("avi", "m3.avi", "mp3"), ("avi", "av.avi", "av"),
    ("avi", "c.avi", "ac3"), ("avi", "f.avi", "pcm_f32le"),
    ("avi", "jp.avi", "mjpeg_pcm"),
    ("flv", "h.flv", "h264"), ("flv", "a.flv", "aac"),
    ("flv", "av.flv", "av"), ("flv", "m3.flv", "mp3"),
    ("flv", "e.flv", "hevc"), ("flv", "r.flv", "rawvideo"),
    ("flv", "p.flv", "pcm_s16le"),
    ("webp", "o.webp", "webp"),
    ("srt", "o.srt", "srt"), ("webvtt", "o.vtt", "vtt"),
    ("ass", "o.ass", "ass"), ("webvtt", "s.vtt", "srt"),
    ("srt", "v.srt", "vtt"), ("ass", "s.ass", "srt"),
]


@pytest.fixture(scope="module")
def written(tmp_path_factory, sources):
    """Each case of MUXES written by both packages' muxers."""
    out, cache = {}, {}
    for fmt, name, src in MUXES:
        if src not in cache:
            cache[src] = sources[src]()
        streams, pkts = cache[src]
        tmp = tmp_path_factory.mktemp(f"{fmt}_{src}")
        out[(fmt, name, src)] = (tmp, mux_with(tmp, "ref", fmt, name,
                                               streams, pkts),
                                 mux_with(tmp, "port", fmt, name, streams,
                                          pkts))
    return out


# the cases the reference refuses, with its error
REFUSED = {("flv", "r.flv", "rawvideo"), ("avi", "m3.avi", "mp3"),
           ("avi", "av.avi", "av"), ("avi", "c.avi", "ac3"),
           ("ass", "s.ass", "srt"), ("mpegts", "x.ts", "eac3")}


@pytest.mark.parametrize("case", MUXES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_muxer_writes_the_reference_bytes(written, case):
    _tmp, ref, port = written[case]
    assert port == ref
    if case in REFUSED:
        assert ref == "InvalidData"
    else:
        assert isinstance(ref, dict) and ref and all(ref.values()), ref


@pytest.mark.parametrize("case", [c for c in MUXES if c not in REFUSED],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_demuxer_reads_the_reference_muxers_files(written, case):
    tmp = written[case][0]
    assert_same_demux(str(tmp / "ref" / case[1]))


@pytest.fixture(scope="module")
def crafted(tmp_path_factory):
    """Files of the demuxers that have no muxer here: name → path."""
    tmp = tmp_path_factory.mktemp("crafted")
    files = {
        "a.mlp": _mlp(b"\xf8\x72\x6f\xbb", 0x08, 20, 1),
        "b.thd": _mlp(b"\xf8\x72\x6f\xba", 0x10, 20, 2),
        "c.mlp": _mlp(b"\xf8\x72\x6f\xbb", 0x99, 9, 3),
        "i.webp": _webp(640, 360, 4), "i.exr": _exr(5),
        "s.srt": SRT.encode(), "s.vtt": VTT.encode(), "s.ass": ASS.encode(),
        **{f"{k}.ogg": v() for k, v in OGG.items()},
    }
    for name, data in files.items():
        (tmp / name).write_bytes(data)
    return {name: tmp / name for name in files}


CRAFTED = ["a.mlp", "b.thd", "c.mlp", "i.webp", "i.exr", "s.srt", "s.vtt",
           "s.ass"] + [f"{k}.ogg" for k in OGG]


@pytest.mark.parametrize("name", CRAFTED)
def test_demuxer_reads_the_crafted_files(crafted, name):
    assert_same_demux(str(crafted[name]))


@pytest.mark.parametrize("name", ["i.webp", "i.exr"])
def test_crafted_images_decode_as_the_reference(crafted, name):
    """The crafted WebP and EXR files, once only demuxed here since the
    port had no decoder for them: their seeded bytes after a valid
    header fail both packages' decoders alike."""
    out = assert_same_decode(crafted[name])
    assert out[0] == "InvalidData", out


def test_webp_muxers_file_decodes_as_the_reference(written):
    """The WebP muxer's file of the crafted VP8 chunk: both packages'
    decoders read its seeded bytes as the same 40x24 picture."""
    tmp = written[("webp", "o.webp", "webp")][0]
    for side in ("ref", "port"):
        out = assert_same_decode(tmp / side / "o.webp")
        assert len(out) == 1 and out[0][1]["width"] == 40, out


def test_mlp_files_open_by_name(crafted, tmp_path):
    """A raw TrueHD stream without its extension, opened by format name;
    and a file with no major sync in its first bytes refused alike."""
    p = tmp_path / "x.bin"
    p.write_bytes(crafted["b.thd"].read_bytes())
    assert_same_demux(str(p), format="truehd")
    q = tmp_path / "y.bin"
    q.write_bytes(bytes(64))
    errors = []
    from ffmpeg_tpu.io import open_input as ref_open_input
    for opener in (ref_open_input, open_input):
        with pytest.raises(Exception) as e:
            opener(str(q), format="mlp")
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[1] == errors[0]


@pytest.mark.parametrize("name", ["vorbis_sine", "celt_mono",
                                  "silk_cfg1_20ms"])
def test_ogg_packets_decode_as_the_committed_packets(tmp_path, name):
    """Ogg Vorbis: the demuxer's extradata is the xiph-laced layout the
    decoder takes (the committed CodecPrivate), Ogg Opus: OpusHead; the
    demuxed packets decode on the port's decoder to the samples of the
    committed packets."""
    st = fx.codec_stream(name)
    p = tmp_path / "x.ogg"
    p.write_bytes(fx.codec_stream_ogg(st, page_bytes=300))
    d = open_input(str(p))
    par = d.streams[0].codecpar
    assert par.extradata == st["extradata"]
    pkts = list(d.packets())
    assert [p.data for p in pkts] == st["packets"]
    got = CodecContext.open_decoder(par, device="cpu").decode_all(pkts)
    want = fx.codec_decode(st, "cpu")
    a = np.concatenate([np.asarray(f.audio_data) for f in got], 1)
    b = np.concatenate([np.asarray(f.audio_data) for f in want], 1)
    assert a.shape == b.shape and np.array_equal(a, b)


def test_ogg_writer_lays_out_pages_as_specified():
    """testing.ogg_stream: one header per page, BOS first, EOS last,
    continued packets flagged, a granule position only on pages that
    complete a packet, page sequence numbers in order, and the CRC of
    RFC 3533 (CRC-32, polynomial 0x04C11DB7, over the page with its CRC
    field zeroed)."""
    data = _ogg_edges("celt_noise")
    pages = _ogg_pages(data)
    assert b"".join(pages) == data
    htypes = [p[5] for p in pages]
    granules = [struct.unpack("<q", p[6:14])[0] for p in pages]
    assert htypes[0] == 2 and htypes[-1] & 4 and htypes[1] == 0
    assert [struct.unpack("<I", p[18:22])[0] for p in pages] == \
        list(range(len(pages)))
    for p, h, g in zip(pages[2:], htypes[2:], granules[2:]):
        lacing = p[27:27 + p[26]]
        assert sum(lacing) + 27 + len(lacing) == len(p)
        assert (g == -1) == all(n == 255 for n in lacing)
    assert any(h & 1 for h in htypes)
    for p in pages:
        crc = 0
        for b in p[:22] + bytes(4) + p[26:]:
            crc ^= b << 24
            for _ in range(8):
                crc = ((crc << 1) ^ 0x04C11DB7 if crc & 0x80000000
                       else crc << 1) & 0xFFFFFFFF
        assert struct.unpack("<I", p[22:26])[0] == crc


def test_splitters_split_as_the_reference():
    """parsers.SPLITTERS (the MPEG-TS demuxer's re-framing of AAC, MP3
    and MP2 payloads) on the committed streams, whole and cut at odd
    offsets."""
    z = np.load(DATA / "port" / "audio_streams.npz")
    streams = {"aac": fx.AAC_CLIP.read_bytes()[:20000],
               "mp3": z["mp3_reservoir_data"].tobytes(),
               "mp2": z["mp2_stereo_data"].tobytes()}
    assert set(parsers.SPLITTERS) == set(ref_parsers.SPLITTERS)
    for codec, data in streams.items():
        for cut in (len(data), 7001, 333):
            got = parsers.SPLITTERS[codec](data[:cut])
            want = ref_parsers.SPLITTERS[codec](data[:cut])
            assert got == want and (got[0] or cut == 333)
    assert parsers.split_adts(b"junk" + streams["aac"][:5000]) == \
        ref_parsers.split_adts(b"junk" + streams["aac"][:5000])


def _heads(written, crafted):
    heads = [(f.read_bytes()[:4096], str(f)) for f in crafted.values()]
    for (_fmt, name, _src), (tmp, ref, _port) in written.items():
        if isinstance(ref, dict):
            heads += [((tmp / "ref" / f).read_bytes()[:4096],
                       str(tmp / "ref" / f)) for f in ref]
    return heads


def test_probes_score_as_the_reference(written, crafted):
    """Each ported demuxer of this slice scores every head (the files
    above, under their own names and under names of every extension) as
    the reference's demuxer of that name, and probe_format picks the
    reference's choice."""
    names = ["ogg", "mpegts", "avi", "flv", "mlp", "truehd", "webp_pipe",
             "exr_pipe", "srt", "webvtt", "ass"]
    heads = _heads(written, crafted)
    exts = {e for n in names for e in ref_demux._DEMUXERS[n].extensions}
    for head, fn in heads:
        for name in names:
            port, ref = demux._DEMUXERS[name], ref_demux._DEMUXERS[name]
            assert port.extensions == ref.extensions
            for f in [fn, "x.bin"] + [f"x.{e}" for e in sorted(exts)]:
                assert port.probe(head, f) == ref.probe(head, f), (name, f)
        want = ref_probe(head, fn)
        assert probe_format(head, fn).name == want.name, fn


# the reference registry's demuxer names, in its order of registration
# (its codecs/av1.py registers "obu" when its codecs package loads, so
# obu's place follows the order of imports, in both packages)
REFERENCE_ORDER = (
    "exr_pipe", "webvtt", "wav", "yuv4mpegpipe", "rawvideo", "s16le",
    "mjpeg", "image2", "image_pipe", "mpegvideo", "mov", "flac", "aac",
    "matroska", "mpegts", "avi", "concat", "srt", "gif", "hls", "mp3",
    "h264", "vvc", "hevc", "obu", "ac3", "eac3", "dts", "ivf", "dash",
    "webp_pipe", "sdp", "rtsp", "ass", "ogg", "flv", "mlp", "truehd")


def test_registration_follows_the_reference_order():
    """Ties in score go to the first registered, in both packages, so
    the port registers its demuxers in the reference's order."""
    assert set(demux._DEMUXERS) == set(REFERENCE_ORDER)
    assert [n for n in demux._DEMUXERS if n != "obu"] == \
        [n for n in REFERENCE_ORDER if n != "obu"]
    assert list(ref_demux._DEMUXERS) == list(demux._DEMUXERS)
