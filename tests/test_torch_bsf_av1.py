"""The port's bitstream tooling (ffmpeg_tpu_torch/codecs/cbs.py, bsf.py,
parsers.py and av1.py) against the reference's, on the CPU:

- each module is the reference's code: its top-level statements equal the
  reference's as syntax trees, but for those named in CHANGED;
- the registries of filters and parsers are the reference's;
- every filter, fed the same packets (the committed H.264, HEVC, VP9 and
  AV1 streams, as Annex B and length-prefixed in MP4), gives the same
  packets (data, timestamps, flags), flush included;
- the CBS read/write of every NAL unit of those streams gives the same
  syntax and bytes;
- every parser splits every stream, fed in small and large chunks, as
  the reference's (or fails alike);
- AV1: leb128, the OBU split, the sequence and frame headers of the
  committed stream, av1C, the parser's units and key flags, the writers'
  bytes (testing.craft_av1), the split and merge filters, the obu
  demuxer, the IVF/MP4/Matroska round trips and the shell decoder's
  NotSupported;
- phase 30's (w) and (x) command lines at small size through both CLIs,
  byte for byte, and refused alike where the reference refuses.
"""

import hashlib
import json

import pytest

from ffmpeg_tpu.cli.ffmpeg import main as ref_main
from ffmpeg_tpu.cli.ffprobe import main as ref_probe
from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.codecs import av1 as ref_av1
from ffmpeg_tpu.codecs import bsf as ref_bsf
from ffmpeg_tpu.codecs import cbs as ref_cbs
from ffmpeg_tpu.codecs import parsers as ref_parsers
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io import open_input as ref_open_input
from ffmpeg_tpu.io.mux import open_output as ref_open_output
from ffmpeg_tpu.io.stream import CodecParameters as RefPar
from ffmpeg_tpu.io.stream import MediaType as RefType
from ffmpeg_tpu.utils.rational import Rational as RefRational
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.cli import ffmpeg as cli
from ffmpeg_tpu_torch.cli.ffmpeg import main
from ffmpeg_tpu_torch.cli.ffprobe import main as probe
from ffmpeg_tpu_torch.codecs import CodecContext, av1, bsf, cbs, parsers
from ffmpeg_tpu_torch.codecs.h264 import nal
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.io import open_input
from ffmpeg_tpu_torch.io.mux import open_output
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType
from ffmpeg_tpu_torch.utils.error import NotSupported
from ffmpeg_tpu_torch.utils.rational import Rational

from torch_io_util import assert_same_demux, differing, plain

# the top-level statements of each port module that differ from the
# reference's; every other statement is the reference's code
CHANGED = {
    "codecs/cbs.py": set(),
    "codecs/bsf.py": set(),
    "codecs/parsers.py": set(),
    "codecs/av1.py": {"<imports>", "Av1Decoder"},
}

PKG = {"ref": (ref_bsf, RefPacket, RefPar, RefRational),
       "port": (bsf, Packet, CodecParameters, Rational)}


@pytest.mark.parametrize("rel", sorted(CHANGED))
def test_module_is_the_reference_code(rel):
    assert differing(rel) == CHANGED[rel]


def test_registries_equal_the_references():
    assert bsf.bsf_names() == ref_bsf.bsf_names()
    assert sorted(parsers.parser_names()) == \
        sorted(ref_parsers.parser_names())
    assert {"av1_frame_split", "av1_frame_merge", "av1_metadata",
            "dts2pts", "noise"} <= set(bsf.bsf_names())


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """name → (codec_id, extradata, [(data, pts, dts, flags)]): the
    committed H.264, HEVC and VP9 streams (the reference CLI's MP4
    remuxes of the first two), and the AV1 stream's units."""
    d = tmp_path_factory.mktemp("bsf")
    out = {}
    for name, src in (("h264", fx.H264_SMALL), ("hevc", fx.HEVC_SMALL),
                      ("vp9", fx.VP9_SMALL)):
        files = [("", src)]
        if name != "vp9":
            assert ref_main(["-i", str(src), "-c", "copy",
                             str(d / f"{name}.mp4")]) == 0
            files.append(("_mp4", d / f"{name}.mp4"))
        for suffix, f in files:
            dm = ref_open_input(str(f))
            par = dm.streams[0].codecpar
            out[name + suffix] = (par.codec_id, par.extradata, [
                (bytes(p.data), p.pts, p.dts, p.flags)
                for p in dm.packets()])
            dm.close()
    out["av1"] = ("av1", None, [(u, i, i, int(i % fx.AV1_GOP == 0))
                                for i, u in enumerate(fx.av1_units())])
    # dts2pts takes packets without their dts
    c, e, pk = out["h264_mp4"]
    out["h264_nodts"] = (c, e, [(a, b, None, f) for a, b, _, f in pk])
    return out


def _filter(side, name, opts, stream, chain=()):
    """The packets of `stream` through filter `name` (after the filters
    of `chain`) of package `side`, flushed; each as plain values, or the
    error's class where a call raises."""
    mod, pkt_cls, par_cls, q = PKG[side]
    codec_id, extradata, pkts = stream
    par = par_cls(codec_id=codec_id, extradata=extradata)
    filters = [mod.get_bsf(n, par, **o) for n, o in chain] + [
        mod.get_bsf(name, par, **opts)]
    out = []
    try:
        for data, pts, dts, flags in pkts:
            kw = {} if dts is None else {"dts": dts}
            todo = [pkt_cls(data=data, pts=pts, flags=flags, duration=1,
                            time_base=q(1, 25), **kw)]
            for f in filters:
                todo = [o for p in todo for o in f.filter(p)]
            out += todo
        for i in range(len(filters)):
            try:
                tail = filters[i].filter(None)
            except (AttributeError, TypeError):
                continue              # a filter that holds no packets
            for f in filters[i + 1:]:
                tail = [o for p in tail for o in f.filter(p)]
            out += tail
    except Exception as e:            # noqa: BLE001 — compared across
        return ("raised", type(e).__name__, plain(out))
    return plain(out)


BSF_CASES = [
    ("null", {}, "h264_mp4", ()), ("chomp", {}, "vp9", ()),
    ("h264_mp4toannexb", {}, "h264_mp4", ()),
    ("h264_mp4toannexb", {}, "h264", ()),
    ("extract_extradata", {}, "h264", ()),
    ("extract_extradata", {}, "hevc", ()),
    ("noise", {"amount": 50, "seed": 7}, "h264", ()),
    ("noise", {"amount": 3, "seed": 1}, "vp9", ()),
    ("setts", {"offset": 7}, "hevc_mp4", ()),
    ("dump_extradata", {}, "h264_mp4", ()),
    ("dump_extradata", {}, "hevc_mp4", ()),
    ("h264_metadata", {"level": 32}, "h264", ()),
    ("h264_metadata", {"max_ref_frames": 2, "profile": 77}, "h264", ()),
    ("hevc_mp4toannexb", {}, "hevc_mp4", ()),
    ("hevc_metadata", {"level": 93, "video_full_range_flag": 1},
     "hevc", ()),
    ("hevc_metadata", {"sample_aspect_ratio": "4:3", "tick_rate": "1:25",
                       "crop_right": 8}, "hevc", ()),
    ("vp9_superframe_split", {}, "vp9", ()),
    ("vp9_superframe", {}, "vp9", (("vp9_superframe_split", {}),)),
    ("av1_metadata", {"color_range": "pc", "color_primaries": 9}, "av1",
     ()),
    ("av1_metadata", {"chroma_sample_position": "colocated",
                      "transfer_characteristics": 16}, "av1", ()),
    ("av1_frame_split", {}, "av1", ()),
    ("av1_frame_merge", {}, "av1", (("av1_frame_split", {}),)),
    ("dts2pts", {}, "h264_nodts", ()),
    ("dts2pts", {"delay": 1}, "h264_nodts", ()),
]


@pytest.mark.parametrize("k", range(len(BSF_CASES)))
def test_bsf_packets_equal_the_references(streams, k):
    name, opts, src, chain = BSF_CASES[k]
    want = _filter("ref", name, opts, streams[src], chain)
    got = _filter("port", name, opts, streams[src], chain)
    assert got == want
    assert want and want[0] != "raised"


def test_h264_metadata_to_high_profile_fails_as_the_reference(streams):
    """profile=100 on the Baseline stream's SPS: the reference's writer
    asks for the High-profile fields its read never filled and raises
    KeyError (codecs/bsf.py H264MetadataBsf, cbs.py); the port does the
    same (ROADMAP.md section 3)."""
    want = _filter("ref", "h264_metadata", {"profile": 100},
                   streams["h264"])
    assert _filter("port", "h264_metadata", {"profile": 100},
                   streams["h264"]) == want
    assert want[:2] == ("raised", "KeyError")


def test_every_filter_has_a_case():
    assert {c[0] for c in BSF_CASES} == set(bsf.bsf_names())


def test_noise_changes_and_setts_shifts(streams):
    """Beside the equality: noise changes bytes from its seed alone, and
    setts moves every timestamp by its offset."""
    _c, _e, pkts = streams["h264"]
    a = _filter("port", "noise", {"amount": 50, "seed": 7}, streams["h264"])
    b = _filter("port", "noise", {"amount": 50, "seed": 7}, streams["h264"])
    assert a == b and any(p[1]["data"] != d
                          for p, (d, *_r) in zip(a, pkts))
    s = _filter("port", "setts", {"offset": 7}, streams["h264_mp4"])
    assert [p[1]["pts"] for p in s] == [
        t + 7 for _d, t, _dt, _f in streams["h264_mp4"][2]]


def _units(name):
    src = {"h264": fx.H264_SMALL, "hevc": fx.HEVC_SMALL,
           "hevc_bench": fx.HEVC_BENCH}[name]
    return list(nal.split_annexb(src.read_bytes()))


@pytest.mark.parametrize("name,cls", [("h264", "CodedBitstream"),
                                      ("hevc", "HevcCodedBitstream"),
                                      ("hevc_bench", "HevcCodedBitstream")])
def test_cbs_round_trips_equal_the_references(name, cls):
    """Every NAL unit read to its syntax and written back: the same
    syntax and bytes as the reference's (and the parameter sets back to
    their own bytes)."""
    port, ref = getattr(cbs, cls), getattr(ref_cbs, cls)
    n_read = 0
    for unit in _units(name):
        want = ref.read_nal(unit)
        got = port.read_nal(unit)
        assert plain(got) == plain(want)
        if want is None:
            continue
        n_read += 1
        assert port.write_nal(got) == ref.write_nal(want)
    assert n_read >= 2


def _chunks(data, n):
    return [data[i:i + n] for i in range(0, len(data), n)]


PARSE_STREAMS = {
    "adts": lambda: fx.AAC_CLIP.read_bytes()[:20000],
    "mp3": lambda: b"".join(fx.audio_stream("mp3_ms")["packets"]),
    "mp2": lambda: b"".join(fx.audio_stream("mp2_stereo")["packets"]),
    "ac3": lambda: b"".join(fx.audio_stream("ac3_stereo")["packets"]),
    "mjpeg": lambda: fx.FIXTURE.read_bytes()[:300000],
    "h264": lambda: fx.H264_SMALL.read_bytes(),
    "hevc": lambda: fx.HEVC_SMALL.read_bytes(),
    "av1": lambda: fx.vvc_av1_stream("av1"),
    "vvc": lambda: fx.vvc_av1_stream("vvc10_416x240"),
}


def _parse(mod, name, data, n):
    p = mod.get_parser(name)
    out = []
    try:
        for c in _chunks(data, n):
            out += p.feed(c)
        out += p.flush()
    except Exception as e:            # noqa: BLE001 — compared across
        return ("raised", type(e).__name__, out)
    return out, plain(getattr(p, "key_flags", None))


@pytest.mark.parametrize("stream", sorted(PARSE_STREAMS))
def test_parsers_split_as_the_references(stream):
    """Every parser on every stream, fed 7 bytes (997 on the MJPEG
    frames, whose parser rescans its buffer) and 4096 bytes at a time:
    the same units as the reference's."""
    data = PARSE_STREAMS[stream]()
    small = 7 if len(data) < 100000 else 997
    own = {"adts": "aac", "mp3": "mp3", "mp2": "mp3", "ac3": "ac3",
           "mjpeg": "mjpeg", "h264": "h264", "hevc": "hevc", "av1": "av1"}
    for name in parsers.parser_names():
        for n in (small, 4096):
            got = _parse(parsers, name, data, n)
            assert got == _parse(ref_parsers, name, data, n), (name, n)
            if own.get(stream) == name and n == 4096:
                assert len(got[0]) >= 2 and b"".join(got[0]) == data


def test_av1_syntax_equals_the_references():
    """The committed stream's OBUs, sequence header and frame headers
    parse as the reference's; leb128 and av1C as well."""
    for v in (0, 1, 127, 128, 300, 1 << 20, (1 << 32) - 1):
        assert av1.leb128_write(v) == ref_av1.leb128_write(v)
        assert av1.leb128_read(av1.leb128_write(v), 0) == (
            v, len(av1.leb128_write(v)))
    seq = rseq = None
    refs, rrefs = [(0, 0, 0, 0)] * 8, [(0, 0, 0, 0)] * 8
    n_frames = 0
    for unit in fx.av1_units():
        obus, robus = av1.split_obus(unit), ref_av1.split_obus(unit)
        assert plain(obus) == plain(robus)
        for o in obus:
            if o.type == av1.OBU_SEQUENCE_HEADER:
                seq = av1.parse_sequence_header(o.payload)
                rseq = ref_av1.parse_sequence_header(o.payload)
                assert plain(seq) == plain(rseq)
                raw = av1.wrap_obu(o.type, o.payload)
                assert av1.build_av1c(raw, seq) == \
                    ref_av1.build_av1c(raw, rseq)
                assert plain(av1.parse_av1c(av1.build_av1c(raw, seq))) == \
                    plain(rseq)
            elif o.type == av1.OBU_FRAME_HEADER:
                h = av1.parse_frame_header(o.payload, seq, refs)
                rh = ref_av1.parse_frame_header(o.payload, rseq, rrefs)
                assert plain(h) == plain(rh) and refs == rrefs
                n_frames += 1
    assert seq.max_frame_width == fx.AV1_W and n_frames == fx.AV1_TUS + \
        fx.AV1_TUS // fx.AV1_PAIR


def test_av1_writers_write_the_references_bytes():
    """testing.craft_av1 through either package's writers: the committed
    stream's units, byte for byte (the JAX package wrote the fixture)."""
    units = fx.av1_units()
    assert fx.craft_av1(av1) == fx.craft_av1(ref_av1) == units
    hd = av1.Av1FrameHeader(show_existing_frame=1, frame_to_show_map_idx=3)
    rhd = ref_av1.Av1FrameHeader(show_existing_frame=1,
                                 frame_to_show_map_idx=3)
    seq = av1.parse_sequence_header(av1.split_obus(units[0])[1].payload)
    rseq = ref_av1.parse_sequence_header(
        ref_av1.split_obus(units[0])[1].payload)
    assert av1.write_frame_header(hd, seq) == \
        ref_av1.write_frame_header(rhd, rseq)


def test_av1_parser_units_and_key_flags():
    data = fx.vvc_av1_stream("av1")
    p, rp = av1.Av1Parser(), ref_av1.Av1Parser()
    got = [u for c in _chunks(data, 7) for u in p.feed(c)] + p.flush()
    want = [u for c in _chunks(data, 7) for u in rp.feed(c)] + rp.flush()
    assert got == want == fx.av1_units()
    assert p.key_flags == rp.key_flags
    assert sum(p.key_flags) == fx.AV1_TUS // fx.AV1_GOP


@pytest.fixture(scope="module")
def obu_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("obu") / "s.obu"
    path.write_bytes(fx.vvc_av1_stream("av1"))
    return path


def test_obu_demuxer_gives_the_references_packets(obu_file):
    assert_same_demux(str(obu_file), n_min=fx.AV1_TUS)
    d = open_input(str(obu_file))
    st = d.streams[0].codecpar
    assert d.name == "obu" and (st.width, st.height) == (fx.AV1_W,
                                                         fx.AV1_H)
    assert [p.data for p in d.packets()] == fx.av1_units()
    d.close()


@pytest.mark.parametrize("fmt,ext", [("ivf", "ivf"), ("mov", "mp4"),
                                     ("matroska", "mkv")])
def test_av1_remux_round_trips_as_the_reference(tmp_path, fmt, ext):
    """The units with av1C extradata through each package's muxer: the
    same file, and its packets read back are the units."""
    units = fx.av1_units()
    seq_raw = av1.split_obus(units[0])[1].raw
    files = {}
    for side, om, pk, par_cls, mt, q, A in (
            ("ref", ref_open_output, RefPacket, RefPar, RefType,
             RefRational, ref_av1),
            ("port", open_output, Packet, CodecParameters, MediaType,
             Rational, av1)):
        seq = A.parse_sequence_header(A.split_obus(units[0])[1].payload)
        par = par_cls(codec_type=mt.VIDEO, codec_id="av1", width=fx.AV1_W,
                      height=fx.AV1_H, extradata=A.build_av1c(seq_raw, seq))
        out = tmp_path / f"{side}.{ext}"
        m = om(str(out), format=fmt)
        m.add_stream(codecpar=par, time_base=q(1, 25))
        m.write_header()
        for i, u in enumerate(units):
            m.write_packet(pk(data=u, pts=i, dts=i, stream_index=0,
                              time_base=q(1, 25),
                              flags=int(i % fx.AV1_GOP == 0)))
        m.write_trailer()
        files[side] = out.read_bytes()
    assert files["port"] == files["ref"]
    d = open_input(str(tmp_path / f"port.{ext}"))
    assert d.streams[0].codecpar.codec_id == "av1"
    assert [bytes(p.data) for p in d.packets()] == units
    d.close()


def test_av1_shell_decoder_raises_not_supported_as_the_reference(
        obu_file):
    """The decoder parses each unit's headers and then raises
    NotSupported with the reference's text; the decode backstop lets it
    through (it is no InvalidData), and both CLIs return 1."""
    msgs = []
    for opener, ctx in ((ref_open_input, RefContext),
                        (open_input, CodecContext)):
        d = opener(str(obu_file))
        kw = {} if ctx is RefContext else {"device": "cpu"}
        dec = ctx.open_decoder(d.streams[0].codecpar, **kw)
        hs = dec.codec.parse_packet(fx.av1_units()[0])
        assert len(hs) == 1 and hs[0].is_key
        with pytest.raises(Exception) as e:
            dec.decode_all(list(d.packets()))
        msgs.append((type(e.value).__name__, str(e.value)))
        d.close()
    assert msgs[0] == msgs[1] and msgs[1][0] == "NotSupported"
    argv = ["-i", str(obu_file), "-f", "framemd5",
            str(obu_file.parent / "o.md5")]
    assert ref_main(argv) == main(argv, device="cpu") == 1
    with pytest.raises(NotSupported, match="out of scope"):
        cli.transcode(cli.parse_args(argv), "cpu")


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    """Phase 30's inputs (testing.write_vvc_av1_sources) with the small
    committed streams in place of the 1080p ones, and the H.264 stream's
    MP4 (phase 26 (c)'s command)."""
    d = tmp_path_factory.mktemp("cli30")
    fx.write_vvc_av1_sources(d)
    assert ref_main(["-i", str(fx.H264_SMALL), "-c", "copy",
                     str(d / "out.mp4")]) == 0
    assert ref_main(_small(fx.bsf_av1_vvc_commands(d)["w_hevc_mp4"])) == 0
    return d


def _small(argv):
    big = {str(fx.HEVC_BENCH): str(fx.HEVC_SMALL),
           str(fx.VP9_BENCH): str(fx.VP9_SMALL)}
    return [big.get(a, a) for a in argv]


W_X = [k for k in fx.bsf_av1_vvc_commands("d") if k[0] in "wx"]


@pytest.mark.parametrize("name", W_X)
def test_phase30_bsf_and_av1_commands_as_the_reference_cli(
        tmp_path, cli_dir, name):
    """Each (w)/(x) command line through both CLIs, on the small streams:
    the same bytes, or the same refusal (return code 1 and the error's
    class from transcode)."""
    outs = {}
    for side, fn in (("ref", ref_main),
                     ("port", lambda a: main(a, device="cpu"))):
        d = tmp_path / side
        d.mkdir()
        for f in cli_dir.iterdir():
            (d / f.name).symlink_to(f)
        argv = _small(fx.bsf_av1_vvc_commands(d)[name])
        rc = fn(argv)
        out = d / fx.BSF_FILES.get(name, "refused.y4m")
        outs[side] = (rc, out.read_bytes() if out.exists() else None)
    assert outs["port"] == outs["ref"]
    if name == "w_unknown":
        assert outs["port"][0] == 1
        gold = json.loads(fx.CLI_GOLDEN.read_text())["w_refused"]
        argv = fx.bsf_av1_vvc_commands(tmp_path / "port")[name]
        with pytest.raises(Exception) as e:
            cli.transcode(cli.parse_args(argv), "cpu")
        assert type(e.value).__name__ == gold[name]
    else:
        assert outs["port"][0] == 0 and outs["port"][1]


def test_phase30_av1_goldens_hold_on_the_cpu(tmp_path, capsys):
    """(x) at full size on the CPU: the port's copies and filters of the
    committed AV1 stream equal the reference CLI's sha256 in
    cli_golden.json, and its probe of the IVF the reference's text."""
    gold = json.loads(fx.CLI_GOLDEN.read_text())
    fx.write_vvc_av1_sources(tmp_path)
    cmds = fx.bsf_av1_vvc_commands(tmp_path)
    for name in ("x_ivf", "x_mp4", "x_mkv", "x_split", "x_meta"):
        assert main(cmds[name], device="cpu") == 0
        sha = hashlib.sha256((tmp_path / fx.BSF_FILES[name]).read_bytes())
        assert sha.hexdigest() == gold["w_sha256"][name], name
    capsys.readouterr()
    assert probe([*fx.AV1_PROBE_ARGS, str(tmp_path / "av1.ivf")],
                 device="cpu") == 0
    text = capsys.readouterr().out
    assert text.replace(str(tmp_path / "av1.ivf"), "{path}") == \
        gold["x_probe"]
    assert ref_probe([*fx.AV1_PROBE_ARGS, str(tmp_path / "av1.ivf")]) == 0
    assert capsys.readouterr().out == text
