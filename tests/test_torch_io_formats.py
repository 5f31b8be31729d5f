"""The port's I/O layer (ffmpeg_tpu_torch/io/: avio, demux, mux and the
14 format modules of io/formats/ that came with the CLI, with
codecs/rawvideo.py and pcm.py) against the reference's, on the CPU
(test_torch_io_containers.py and test_torch_io_streaming.py hold the
later ones).

- Each module is the reference's code: its top-level statements equal the
  reference's as syntax trees, but for those named here, which the tests
  below hold to the reference's behaviour.
- Each ported muxer, fed the same packets as the reference's, writes the
  same bytes (or raises the same error where the reference refuses a
  codec).
- Each ported demuxer gives the same streams (CodecParameters, time base,
  durations) and the same packets (data, pts, dts, duration, flags,
  stream index, position, side data) on the files the reference's muxers
  wrote and on the committed fixtures; seeking lands on the same packets.
- probe_format picks the reference's demuxer: every demuxer scores the
  heads the unported demuxers' claims once held as the reference's does,
  and an AV1 OBU stream, once refused, opens through codecs/av1.py's obu
  demuxer as the reference's.  A GIF file and an HLS playlist, once
  claimed so too, open as the reference's.
- URLs (concat:, subfile,, cache:, async:, http://) open through
  io/protocols.py as the reference's, and an ID3v2-tagged MP3 through
  io/id3v2.py.
- The port's older readers io/adts.py, io/ivf.py and io/mjpeg.py give the
  packets of the new demuxers.
"""

import copy

import numpy as np
import pytest

from ffmpeg_tpu.io import open_input as ref_open_input
from ffmpeg_tpu.io import open_output as ref_open_output
from ffmpeg_tpu.io import probe_format as ref_probe
from ffmpeg_tpu_torch.io import (avio, demuxer_names, muxer_names,
                                 open_input, open_output, probe_format)
from ffmpeg_tpu_torch.io.adts import read_adts
from ffmpeg_tpu_torch.io.ivf import read_ivf
from ffmpeg_tpu_torch.io.mjpeg import split_packets
from ffmpeg_tpu_torch.utils.error import DemuxerNotFound, ProtocolNotFound

from torch_io_util import (DATA, SOURCES, assert_same_decode,
                           assert_same_demux, differing,
                           mux_with, plain)

FORMATS = ["y4m", "rawvideo", "wav", "hashenc", "img_mjpeg", "ivf", "h26x",
           "adts", "ac3raw", "matroska", "matroskaenc", "mov", "movenc"]

# the top-level statements of each port module that differ from the
# reference's; every other module is the reference's code
CHANGED = {
    "io/avio.py": set(),
    "io/demux.py": set(),
    "io/mux.py": set(),
    "io/formats/mp3raw.py": set(),
    "codecs/rawvideo.py": {"<imports>", "RawVideoDecoder",
                           "RawVideoEncoder", "WrappedFrameDecoder"},
    "codecs/pcm.py": {"<imports>", "_make_decoder", "_make_encoder",
                      "_make_law_decoder"},
    **{f"io/formats/{m}.py": set() for m in FORMATS},
}


@pytest.mark.parametrize("rel", sorted(CHANGED))
def test_module_is_the_reference_code_but_where_named(rel):
    assert differing(rel) == CHANGED[rel]


# (format, file name, source)
MUXES = [
    ("yuv4mpegpipe", "o.y4m", "rawvideo"), ("rawvideo", "o.yuv", "rawvideo"),
    ("framecrc", "o.crc", "rawvideo"), ("framemd5", "o.md5", "av"),
    ("framemd5", "a.md5", "pcm_s16le"), ("md5", "o.md5", "rawvideo"),
    ("crc", "o.crc", "aac"), ("null", "o.null", "rawvideo"),
    ("hash", "o.hash", "pcm_s16le"), ("mjpeg", "o.mjpeg", "mjpeg"),
    ("adts", "o.aac", "aac"), ("s16le", "o.sw", "pcm_s16le"),
    ("f32le", "o.f32", "pcm_f32le"), ("wav", "o.wav", "pcm_s16le"),
    ("wav", "s.wav", "pcm_s16le_stereo"), ("wav", "f.wav", "pcm_f32le"),
    ("ivf", "o.ivf", "vp9"), ("matroska", "h.mkv", "h264"),
    ("matroska", "v.mkv", "vp9"), ("matroska", "av.mkv", "av"),
    ("matroska", "p.mkv", "pcm_s16le"), ("matroska", "j.mkv", "mjpeg"),
    ("matroska", "a.mka", "aac"), ("mov", "h.mp4", "h264"),
    ("mov", "a.m4a", "aac"), ("mov", "av.mp4", "av"),
    ("mov", "j.mov", "mjpeg"), ("mov", "p.mov", "pcm_s16le"),
    ("mov", "v.mp4", "vp9"), ("image2", "img-%03d.jpg", "mjpeg"),
]


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each case of MUXES written by both packages' muxers."""
    out = {}
    for fmt, name, src in MUXES:
        streams, pkts = SOURCES[src]()
        tmp = tmp_path_factory.mktemp(f"{fmt}_{src}")
        out[(fmt, name, src)] = (tmp, mux_with(tmp, "ref", fmt, name, streams,
                                           pkts),
                                 mux_with(tmp, "port", fmt, name, streams,
                                      pkts))
    return out


@pytest.mark.parametrize("case", MUXES, ids=lambda c: f"{c[0]}-{c[2]}")
def test_muxer_writes_the_reference_bytes(written, case):
    _tmp, ref, port = written[case]
    assert port == ref
    if case[2] != "vp9" or case[0] != "mov":
        assert isinstance(ref, dict) and ref, ref
        assert all(ref.values()) or case[0] == "null"


# the reference's outputs of MUXES that a ported demuxer reads, with the
# options a headerless format needs
DEMUX_WRITTEN = [
    (("yuv4mpegpipe", "o.y4m", "rawvideo"), {}),
    (("rawvideo", "o.yuv", "rawvideo"),
     {"format": "rawvideo", "video_size": (64, 48),
      "pixel_format": "yuv420p"}),
    (("mjpeg", "o.mjpeg", "mjpeg"), {}),
    (("adts", "o.aac", "aac"), {}),
    (("s16le", "o.sw", "pcm_s16le"),
     {"format": "s16le", "sample_rate": 8000, "channels": 1}),
    (("wav", "o.wav", "pcm_s16le"), {}), (("wav", "s.wav",
                                           "pcm_s16le_stereo"), {}),
    (("wav", "f.wav", "pcm_f32le"), {}), (("ivf", "o.ivf", "vp9"), {}),
    (("matroska", "h.mkv", "h264"), {}), (("matroska", "v.mkv", "vp9"), {}),
    (("matroska", "av.mkv", "av"), {}), (("matroska", "p.mkv", "pcm_s16le"),
                                         {}),
    (("matroska", "j.mkv", "mjpeg"), {}), (("matroska", "a.mka", "aac"), {}),
    (("mov", "h.mp4", "h264"), {}), (("mov", "a.m4a", "aac"), {}),
    (("mov", "av.mp4", "av"), {}), (("mov", "j.mov", "mjpeg"), {}),
    (("mov", "p.mov", "pcm_s16le"), {}),
]


@pytest.mark.parametrize("case,opts", DEMUX_WRITTEN,
                         ids=lambda c: f"{c[0]}-{c[2]}"
                         if isinstance(c, tuple) else "")
def test_demuxer_reads_the_reference_muxers_files(written, case, opts):
    tmp = written[case][0]
    assert_same_demux(str(tmp / "ref" / case[1]), **opts)


def test_image2_demuxer_reads_patterns_and_globs(written):
    tmp = written[("image2", "img-%03d.jpg", "mjpeg")][0]
    assert_same_demux(str(tmp / "ref" / "img-%03d.jpg"), n_min=2)
    assert_same_demux(str(tmp / "ref" / "img-*.jpg"), n_min=2)
    assert_same_demux(str(tmp / "ref" / "img-001.jpg"), format="image2")


def _audio_stream_file(tmp_path, name, ext):
    z = np.load(DATA / "port" / "audio_streams.npz")
    p = tmp_path / f"{name}.{ext}"
    p.write_bytes(z[f"{name}_data"].tobytes())
    return p


FIXTURES = ["port/flagship_1080p_8.mjpeg", "port/vp9_crafted_96x72.ivf",
            "port/vp9_1080p_lf.ivf", "bench/vp9_1080p_100.ivf",
            "port/h264_crafted_small.h264", "port/h264_1080p_cabac.h264",
            "port/hevc_crafted_64x64.hevc", "bench/hevc_1080p.hevc",
            "port/hevc_1080p_sao_deblock.hevc", "bench/aac48k.adts"]
RAW_AUDIO = [("eac3_5_1", "eac3"), ("ac3_stereo", "ac3"),
             ("eac3_aht_spx", "ec3"), ("mp3_reservoir", "mp3"),
             ("mp2_stereo", "mp2"), ("mp1_stereo", "mp2")]


@pytest.mark.parametrize("rel", FIXTURES)
def test_demuxer_reads_the_fixtures_as_the_reference(rel):
    assert_same_demux(str(DATA / rel))


@pytest.mark.parametrize("name,ext", RAW_AUDIO)
def test_raw_audio_demuxers_read_the_committed_streams(tmp_path, name, ext):
    assert_same_demux(str(_audio_stream_file(tmp_path, name, ext)), 20)


def test_mpegvideo_and_image_pipe_demuxers(tmp_path):
    """A raw MPEG-2 stream (the port's encoder's packets, three pictures)
    and a single image that only its signature identifies."""
    from ffmpeg_tpu_torch.codecs import CodecContext, EncoderParameters
    from ffmpeg_tpu_torch.testing import mpeg2_clip
    enc = CodecContext.open_encoder(EncoderParameters("mpeg2video", 48, 32),
                                    {"qscale": 6}, device="cpu")
    data = b""
    for f in mpeg2_clip(3, 48, 32):
        enc.send_frame(f)
        data += enc.receive_packet().data
    (tmp_path / "c.m2v").write_bytes(data)
    assert_same_demux(str(tmp_path / "c.m2v"), n_min=3)
    (tmp_path / "i.png").write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(range(40)))
    assert_same_demux(str(tmp_path / "i.png"))


def test_signature_only_png_decodes_as_the_reference(tmp_path):
    """The single image above, once only demuxed here since the port had
    no PNG decoder: both packages' decoders refuse its chunk bytes
    alike (no IHDR: depth 0)."""
    (tmp_path / "i.png").write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(range(40)))
    out = assert_same_decode(tmp_path / "i.png")
    assert out[0] == "NotSupported", out


def test_id3_tagged_mp3_raises_not_supported(tmp_path):
    """Once refused while io/id3v2.py was unported (NotSupported): a file
    with an ID3v2 tag (here an empty frame of padding) opens as the
    reference's, with its packets."""
    z = np.load(DATA / "port" / "audio_streams.npz")
    tag = b"ID3\x04\x00\x00\x00\x00\x00\x0a" + bytes(10)
    p = tmp_path / "t.mp3"
    p.write_bytes(tag + z["mp3_reservoir_data"].tobytes())
    assert ref_open_input(str(p)).name == "mp3"
    assert open_input(str(p)).name == "mp3"
    assert_same_demux(str(p), n_min=4)


@pytest.mark.parametrize("case,stream,pos", [
    (("matroska", "av.mkv", "av"), 0, 6), (("mov", "h.mp4", "h264"), 0, 5),
    (("ivf", "o.ivf", "vp9"), 0, 4), (("yuv4mpegpipe", "o.y4m",
                                        "rawvideo"), 0, 2)],
    ids=lambda c: c[0] if isinstance(c, tuple) else str(c))
def test_seek_lands_on_the_reference_packets(written, case, stream, pos):
    url = str(written[case][0] / "ref" / case[1])
    out = []
    for opener in (ref_open_input, open_input):
        d = opener(url)
        st = d.streams[stream]
        d.seek(stream, pos * st.time_base.den // (25 * st.time_base.num))
        out.append(plain(list(d.packets())))
        d.close()
    assert out[1] == out[0] and out[0]


def _heads(tmp_path, written):
    files = [DATA / r for r in FIXTURES]
    files += [_audio_stream_file(tmp_path, n, e) for n, e in RAW_AUDIO]
    for (_fmt, name, _src), (tmp, ref, _port) in written.items():
        if isinstance(ref, dict):
            files += [tmp / "ref" / f for f in ref]
    return files


def test_probe_picks_the_reference_demuxer_where_ported(tmp_path, written):
    seen = set()
    for f in _heads(tmp_path, written):
        head = f.read_bytes()[:4096]
        ref_cls = ref_probe(head, str(f))
        want = ref_cls.name if ref_cls is not None else None
        if want is not None and want not in demuxer_names():
            with pytest.raises(DemuxerNotFound):
                probe_format(head, str(f))
            continue
        cls = probe_format(head, str(f))
        assert (cls.name if cls is not None else None) == want, f
        seen.add(want)
    assert {"mjpeg", "ivf", "h264", "hevc", "aac", "ac3", "mp3",
            "yuv4mpegpipe", "wav", "matroska", "mov"} <= seen


CLAIM_HEADS = [
    b"\x76\x2f\x31\x01" + bytes(60), b"\xef\xbb\xbfWEBVTT\n\n",
    b"WEBVTT", b"fLaC\0\0\0\x22", bytes([0x47] + [0] * 187) * 5,
    bytes(7) + bytes([0x47] + [0] * 187) * 5, b"RIFF\0\0\0\0AVI LIST",
    b"RIFF\0\0\0\0WEBPVP8 ", b"ffconcat version 1.0\nfile a",
    b"1\n00:00:01,000 --> 00:00:02,500\nhi\n", b"\xff\xfe00:00",
    b"GIF89a" + bytes(8), b"#EXTM3U\n#EXT-X-VERSION:3",
    b"\x12\x00\x0a\x0b\x00\x00\x00\x24\xc4\xff\xdf\x00\x68\x02",
    b"\x12\x00\x32\x02\x10\x00", b"\x12\x00\x7f",
    b"<?xml?><MPD xmlns>", b"v=0\r\no=- 0 0 IN IP4 0\r\nm=audio 0",
    b"  [Script Info]\nTitle: x", b"OggS\0\2" + bytes(20),
    b"FLV\x01\x05\0\0\0\x09", bytes(4) + b"\xf8\x72\x6f\xbb" + bytes(8),
    bytes(6) + b"\xf8\x72\x6f\xba", b"\xf8\x72\x6f\xbb",
    (b"\x7f\xfe\x80\x01\x00\x3c\x3f\xf0\xb4\x00" + bytes(1014)) * 4,
    (b"\x7f\xfe\x80\x01\x00\x3c\x3f\xf0\xb4\x00" + bytes(1014)) * 2,
    b"\x12\x00\x0a\x02\x00\x00",
]


@pytest.mark.parametrize("k", range(len(CLAIM_HEADS)))
def test_unported_claims_score_as_the_reference_probes(k):
    """Every demuxer of the port scores each head that the claims of the
    unported demuxers once held (the port now has them all) as the
    reference's demuxer of that name does, with and without its
    extension and under an rtsp:// name, and probe_format picks the
    reference's choice."""
    from ffmpeg_tpu.io import demux as ref_demux
    from ffmpeg_tpu_torch.io import demux
    assert set(demux._DEMUXERS) == set(ref_demux._DEMUXERS)
    head = CLAIM_HEADS[k]
    for name, cls in demux._DEMUXERS.items():
        ref = ref_demux._DEMUXERS[name]
        assert cls.extensions == ref.extensions
        for fn in ("x.bin", f"x.{(ref.extensions or ('',))[0]}",
                   "rtsp://h/x"):
            assert cls.probe(head, fn) == ref.probe(head, fn), (name, fn)
    for fn in ("x.bin", "rtsp://h/x"):
        want, got = ref_probe(head, fn), probe_format(head, fn)
        assert (got and got.name) == (want and want.name), fn


def test_each_remaining_claim_scores_one_of_the_heads():
    """The last claim, AV1's OBU stream, is the obu demuxer of
    codecs/av1.py now: it scores the OBU heads of CLAIM_HEADS as the
    reference's (75 with a sequence header, 25 without), and the
    registry has no demuxer the reference lacks."""
    from ffmpeg_tpu.io import demux as ref_demux
    from ffmpeg_tpu_torch.io import demux
    from ffmpeg_tpu_torch.codecs.av1 import Av1ObuDemuxer as ObuDemuxer
    assert demux._DEMUXERS["obu"] is ObuDemuxer
    scores = [ObuDemuxer.probe(h, "x.bin") for h in CLAIM_HEADS]
    assert scores == [ref_demux._DEMUXERS["obu"].probe(h, "x.bin")
                      for h in CLAIM_HEADS]
    assert 75 in scores and 25 in scores
    assert set(demux._DEMUXERS) == set(ref_demux._DEMUXERS)


def _obu_stream(path):
    """Two temporal units of a crafted 320x180 AV1 stream (the
    reference's tests/test_av1.py recipe, its own OBU writer)."""
    from ffmpeg_tpu.codecs.av1 import (
        Av1FrameHeader, Av1SequenceHeader, INTER_FRAME, KEY_FRAME,
        OBU_FRAME_HEADER, OBU_SEQUENCE_HEADER, OBU_TEMPORAL_DELIMITER,
        OBU_TILE_GROUP, wrap_obu, write_frame_header,
        write_sequence_header)
    seq = Av1SequenceHeader(max_frame_width=320, max_frame_height=180,
                            frame_width_bits=10, frame_height_bits=10,
                            enable_order_hint=1, order_hint_bits=7)
    heads = [Av1FrameHeader(frame_type=KEY_FRAME, show_frame=1),
             Av1FrameHeader(frame_type=INTER_FRAME, show_frame=1,
                            order_hint=1, refresh_frame_flags=1,
                            ref_frame_idx=[0] * 7)]
    tus = []
    for i, h in enumerate(heads):
        obus = [wrap_obu(OBU_TEMPORAL_DELIMITER, b"")]
        if i == 0:
            obus.append(wrap_obu(OBU_SEQUENCE_HEADER,
                                 write_sequence_header(seq)))
        obus.append(wrap_obu(OBU_FRAME_HEADER, write_frame_header(h, seq)))
        obus.append(wrap_obu(OBU_TILE_GROUP, b"\x00" * 8))
        tus.append(b"".join(obus))
    path.write_bytes(b"".join(tus))
    return path


def test_probe_refuses_files_only_unported_demuxers_claim(tmp_path):
    """A crafted AV1 OBU stream, once refused while codecs/av1.py was
    unported: the port probes it as obu, by content and by name, and its
    demuxer gives the reference's streams and packets."""
    path = _obu_stream(tmp_path / "t.obu")
    head = path.read_bytes()[:4096]
    assert ref_probe(head, str(path)).name == "obu"
    assert probe_format(head, str(path)).name == "obu"
    for fmt in (None, "obu"):
        d = open_input(str(path), format=fmt)
        assert d.name == "obu"
        d.close()
    assert_same_demux(str(path), n_min=2)


def test_gif_and_hls_files_once_refused_open_as_the_reference(tmp_path):
    """A GIF file and an HLS playlist written by the reference's CLI, once
    refused while io/formats/gif.py and hls.py were unported, open
    through the port's demuxers to the reference's packets."""
    from ffmpeg_tpu.cli.ffmpeg import main as ref_main
    from ffmpeg_tpu_torch.testing import mpeg2_clip, write_y4m
    y4m = write_y4m(tmp_path / "c.y4m", mpeg2_clip(2, 32, 24))
    gif, hls = tmp_path / "o.gif", tmp_path / "o.m3u8"
    assert ref_main(["-i", str(y4m), "-pix_fmt", "rgb24", str(gif)]) == 0
    assert ref_main(["-i", str(y4m), "-c:v", "mpeg2video", str(hls)]) == 0
    for path, name in ((gif, "gif"), (hls, "hls")):
        head = path.read_bytes()[:4096]
        assert probe_format(head, str(path)).name == \
            ref_probe(head, str(path)).name == name
        assert open_input(str(path)).name == name
        assert_same_demux(str(path), n_min=2)


def test_ts_and_avi_outputs_and_rtsp_urls_open_as_the_reference(tmp_path):
    """Once refused while their modules were unported: .ts and -f avi
    outputs open the reference's muxers, and an rtsp:// URL opens the
    RTSP demuxer, which fails as the reference's does where no server
    listens."""
    for name, fmt, want in (("x.ts", None, "mpegts"),
                            ("x.avi", "avi", "avi")):
        for opener, side in ((ref_open_output, "ref"), (open_output,
                                                         "port")):
            m = opener(str(tmp_path / f"{side}_{name}"), format=fmt)
            assert m.name == want
            m.close()
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    url = f"rtsp://127.0.0.1:{s.getsockname()[1]}/x"
    errors = []
    for opener in (ref_open_input, open_input):
        with pytest.raises(Exception) as e:
            opener(url, listen_timeout=1.0)
        errors.append((type(e.value).__name__, str(e.value)))
    s.close()
    assert errors[1] == errors[0]
    assert errors[0][0] == "InvalidData" and "RtspListenDemuxer" in \
        errors[0][1]


def test_registries_hold_the_ported_formats():
    # obu is codecs/av1.py's, registered when the codecs package loads
    assert demuxer_names() == [
        "aac", "ac3", "ass", "avi", "concat", "dash", "dts", "eac3",
        "exr_pipe", "flac", "flv", "gif", "h264", "hevc", "hls", "image2",
        "image_pipe", "ivf", "matroska", "mjpeg", "mlp", "mov", "mp3",
        "mpegts", "mpegvideo", "obu", "ogg", "rawvideo", "rtsp", "s16le",
        "sdp",
        "srt", "truehd", "vvc", "wav", "webp_pipe", "webvtt",
        "yuv4mpegpipe"]
    # io/formats/rtpenc.py registers "rtp" and "rtsp" when it is
    # imported, as the reference's does
    assert [n for n in muxer_names() if n not in ("rtp", "rtsp")] == [
        "adts", "ass", "avi", "crc", "dash", "f32le", "fifo", "flv",
        "framecrc", "framemd5", "gif", "hash", "hls", "image2", "ivf",
        "matroska", "md5", "mjpeg", "mov", "mpegts", "null", "rawvideo",
        "s16le", "segment", "srt", "tee", "wav", "webp", "webvtt",
        "yuv4mpegpipe"]
    from ffmpeg_tpu_torch.io.formats import rtpenc  # noqa: F401
    assert {"rtp", "rtsp"} <= set(muxer_names())


@pytest.mark.parametrize("url", ["concat:a.y4m|b.y4m", "subfile,,start,0,"
                                 "end,10,,:a.y4m", "cache:a.y4m",
                                 "async:a.y4m", "http://localhost:1/a.y4m"])
def test_unported_protocols_raise_protocol_not_found(url, tmp_path,
                                                      monkeypatch):
    """Once refused while io/protocols.py was unported (ProtocolNotFound):
    the nested URLs read the reference's bytes, and where no server
    listens both packages raise the same error on read and on write."""
    from ffmpeg_tpu.io import avio as ref_avio
    from ffmpeg_tpu_torch.testing import mpeg2_clip, write_y4m
    monkeypatch.chdir(tmp_path)
    write_y4m(tmp_path / "a.y4m", mpeg2_clip(2, 32, 24))
    write_y4m(tmp_path / "b.y4m", mpeg2_clip(1, 32, 24, seed=1))
    if "://" not in url:
        got = []
        for mod in (ref_avio, avio):
            r = mod.open_read(url)
            got.append((r.size, r.read(1 << 20)))
            r.close()
        assert got[1] == got[0] and got[0][1]
        return
    for call in (lambda m: m.open_read(url).read(10),
                 lambda m: m.open_write(url).write(b"x")):
        errors = []
        for mod in (ref_avio, avio):
            with pytest.raises(Exception) as e:
                call(mod)
            errors.append(type(e.value).__name__)
        assert errors[1] == errors[0]
    with pytest.raises(ProtocolNotFound):
        avio.open_read("nosuch://localhost:1/a.y4m")


def test_avio_reads_bytes_and_file_objects_as_the_reference(tmp_path):
    import io as _io
    from ffmpeg_tpu.io import avio as ref_avio
    data = bytes(range(256)) * 3
    for src in (data, _io.BytesIO(data)):
        out = []
        for mod in (ref_avio, avio):
            r = mod.open_read(copy.copy(src) if isinstance(src, bytes)
                              else _io.BytesIO(data))
            out.append((r.peek(5), r.u8(), r.rl16(), r.rb24(), r.rl32(),
                        r.rb64(), r.tag(), r.tell(), r.read(7),
                        r.seekable, r.size))
        assert out[0] == out[1]
    p = tmp_path / "w.bin"
    w = avio.open_write(str(p))
    w.u8(1), w.wl16(2), w.wb24(3), w.wl32(4), w.wb64(5), w.tag("abcd")
    w.close()
    assert p.read_bytes() == b"\x01\x02\x00\x00\x00\x03\x04\x00\x00\x00" \
        + bytes(7) + b"\x05abcd"


def test_old_readers_give_the_demuxers_packets(written):
    """io/adts.py, io/ivf.py and io/mjpeg.py, beside the registry, read
    the committed fixtures (and the muxers' files) into the packets of
    AdtsDemuxer, IvfDemuxer and MjpegDemuxer."""
    def demuxed(url):
        d = open_input(str(url))
        pk = list(d.packets())
        d.close()
        return d, pk

    def fields(p):
        return plain((p.data, p.pts, p.dts, p.duration, p.flags,
                      p.stream_index, p.time_base))
    for url in (DATA / "bench" / "aac48k.adts",
                written[("adts", "o.aac", "aac")][0] / "ref" / "o.aac"):
        par, pkts = read_adts(url.read_bytes())
        d, want = demuxed(url)
        assert plain(par) == plain(d.streams[0].codecpar)
        assert [fields(p) for p in pkts] == [fields(p) for p in want]
    for url in (DATA / "port" / "vp9_crafted_96x72.ivf",
                DATA / "port" / "vp9_1080p_lf.ivf",
                DATA / "bench" / "vp9_1080p_100.ivf"):
        par, tb, pkts = read_ivf(url.read_bytes())
        d, want = demuxed(url)
        st = d.streams[0]
        assert (par.codec_id, par.width, par.height) == (
            st.codecpar.codec_id, st.codecpar.width, st.codecpar.height)
        assert plain(tb) == plain(st.time_base)
        assert [fields(p) for p in pkts] == [fields(p) for p in want]
    for url in (DATA / "port" / "flagship_1080p_8.mjpeg",
                written[("mjpeg", "o.mjpeg", "mjpeg")][0] / "ref" /
                "o.mjpeg"):
        d, want = demuxed(url)
        assert split_packets(url.read_bytes()) == [p.data for p in want]
