"""Helpers of the port's I/O and CLI tests (test_torch_io_formats.py,
test_torch_io_containers.py, test_torch_io_streaming.py,
test_torch_cli.py, test_torch_cli_commands.py): both packages' objects
as plain values, reference objects carried over into the port's
classes, the structural comparison of a port module with its reference
counterpart, the seeded inputs both packages read, the reference's
packets of seeded data and the fixtures (SOURCES), and the two
packages' muxers and demuxers run side by side (mux_with,
assert_same_demux)."""

import ast
import copy
import dataclasses
import struct
from pathlib import Path

import numpy as np
import torch

from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.formats.channel_layout import ChannelLayout as RefLayout
from ffmpeg_tpu.formats.channel_layout import default_layout as ref_layout
from ffmpeg_tpu.io import open_input as ref_open_input
from ffmpeg_tpu.io import open_output as ref_open_output
from ffmpeg_tpu.io.stream import CodecParameters as RefPar
from ffmpeg_tpu.io.stream import MediaType as RefType
from ffmpeg_tpu.io.stream import StreamInfo as RefStream
from ffmpeg_tpu.utils.error import FFTPUError as RefError
from ffmpeg_tpu.utils.rational import Rational as RefRational
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.formats.channel_layout import ChannelLayout
from ffmpeg_tpu_torch.io import open_input, open_output
from ffmpeg_tpu_torch.io.stream import CodecParameters, StreamInfo
from ffmpeg_tpu_torch.utils.error import FFTPUError
from ffmpeg_tpu_torch.utils.rational import Rational

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"


def plain(x):
    """Either package's Rational, ChannelLayout, CodecParameters,
    StreamInfo, Packet or Frame, and containers of them, as plain Python
    values that compare across the packages; tensors and arrays as
    (dtype, shape, bytes)."""
    if isinstance(x, (RefRational, Rational)):
        return ("Q", x.num, x.den)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        return ("A", str(x.dtype), x.shape, x.tobytes())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (bytes, bytearray, memoryview)):
        return bytes(x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return (type(x).__name__, plain(vars(x)))


def to_port(x):
    """A reference Rational, ChannelLayout, CodecParameters, StreamInfo
    or Packet (and containers of them) as the port's."""
    if isinstance(x, RefRational):
        return Rational(x.num, x.den)
    if isinstance(x, RefLayout):
        return ChannelLayout(x.mask, x._nb)
    for ref_cls, cls in ((RefPar, CodecParameters), (RefStream, StreamInfo),
                         (RefPacket, Packet)):
        if isinstance(x, ref_cls):
            return cls(**{f.name: to_port(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: to_port(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_port(v) for v in x]
    return x


def top_level(pkg: str, rel: str) -> dict:
    """The module's top-level statements without its docstring, keyed by
    the name they define (imports together under "<imports>", other
    statements by position), each as its syntax tree's dump."""
    tree = ast.parse((REPO / pkg / rel).read_text())
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant):
        body = body[1:]
    out = {"<imports>": []}
    for i, node in enumerate(body):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out["<imports>"].append(ast.dump(node))
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            tgt = node.targets[0] if isinstance(node, ast.Assign) \
                else node.target
            out[ast.unparse(tgt)] = ast.dump(node)
        else:
            out[f"<stmt {ast.unparse(node)[:40]}>"] = ast.dump(node)
    out["<imports>"] = sorted(out["<imports>"])
    return out


def differing(rel: str) -> set:
    """Names whose top-level statement differs between the reference's
    module and the port's copy at the same path, or that only one has."""
    a, b = top_level("ffmpeg_tpu", rel), top_level("ffmpeg_tpu_torch", rel)
    return {k for k in a.keys() | b.keys() if a.get(k) != b.get(k)}


def seeded_wav(path, rate=8000, n=4000, channels=1, seed=0) -> Path:
    """A 16-bit PCM WAV of seeded tones and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    x = 0.3 * np.sin(2 * np.pi * 440 * t)[None] \
        + 0.05 * rng.standard_normal((channels, n))
    pcm = (np.clip(x, -1, 1) * 32767).astype("<i2").T.tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, 1, channels, rate,
                         rate * 2 * channels, 2 * channels, 16)
           + b"data" + struct.pack("<I", len(pcm)))
    Path(path).write_bytes(hdr + pcm)
    return Path(path)


# --- the reference's packets, from seeded data and the fixtures -----------

def raw_video_source():
    """Three seeded 64x48 yuv420p frames as rawvideo packets at 25/s:
    [(par, time base)], packets (the reference's classes, as every
    source of SOURCES)."""
    rng = np.random.default_rng(1)
    par = RefPar(codec_type=RefType.VIDEO, codec_id="rawvideo", width=64,
                 height=48, pix_fmt="yuv420p", framerate=RefRational(25, 1))
    pkts = [RefPacket(data=rng.integers(0, 256, 64 * 48 * 3 // 2,
                                        np.uint8).tobytes(),
                      pts=i, dts=i, duration=1, flags=1,
                      time_base=RefRational(1, 25)) for i in range(3)]
    return [(par, RefRational(1, 25))], pkts


def pcm_source(codec_id, fmt, dtype, channels=1):
    """Four packets of 1000 seeded samples at 8 kHz."""
    rng = np.random.default_rng(2)
    par = RefPar(codec_type=RefType.AUDIO, codec_id=codec_id,
                 sample_rate=8000, sample_fmt=fmt,
                 ch_layout=ref_layout(channels),
                 block_align=channels * np.dtype(dtype).itemsize,
                 bits_per_coded_sample=8 * np.dtype(dtype).itemsize)
    x = rng.standard_normal((4 * 1000, channels)) * 0.2
    if dtype == "<i2":
        x = x * 32767
    data = x.astype(dtype)
    pkts = [RefPacket(data=data[k * 1000:(k + 1) * 1000].tobytes(),
                      pts=1000 * k, dts=1000 * k, duration=1000, flags=1,
                      time_base=RefRational(1, 8000)) for k in range(4)]
    return [(par, RefRational(1, 8000))], pkts


def demuxed(path, n=None, **kw):
    """The reference demuxer's streams and its first `n` (all) packets."""
    d = ref_open_input(str(path), **kw)
    pkts = []
    for p in d.packets():
        pkts.append(p)
        if n is not None and len(pkts) == n:
            break
    d.close()
    return [(st.codecpar, st.time_base) for st in d.streams], pkts


def mjpeg_source():
    """The flagship fixture's first two 1920x1080 JPEG packets."""
    par = RefPar(codec_type=RefType.VIDEO, codec_id="mjpeg", width=1920,
                 height=1080, pix_fmt="yuvj420p",
                 framerate=RefRational(25, 1))
    data = (DATA / "port" / "flagship_1080p_8.mjpeg").read_bytes()
    a = data.index(b"\xff\xd9") + 2
    b = data.index(b"\xff\xd9", a) + 2
    pkts = [RefPacket(data=d, pts=i, dts=i, duration=1, flags=1,
                      time_base=RefRational(1, 25))
            for i, d in enumerate((data[:a], data[a:b]))]
    return [(par, RefRational(1, 25))], pkts


def av_source():
    """The small H.264 stream and 12 AAC packets, interleaved by time."""
    vs, vp = demuxed(DATA / "port" / "h264_crafted_small.h264")
    as_, ap = demuxed(DATA / "bench" / "aac48k.adts", n=12)
    for p in ap:
        p.stream_index = 1
    return vs + as_, sorted(vp + ap, key=lambda p: (
        p.pts * p.time_base.num / p.time_base.den, p.stream_index))


def mjpeg_pcm_source():
    """The two JPEG packets and the 8 kHz PCM, interleaved by time."""
    vs, vp = mjpeg_source()
    as_, ap = pcm_source("pcm_s16le", "s16", "<i2")
    for p in ap:
        p.stream_index = 1
    return vs + as_, sorted(vp + ap, key=lambda p: (
        p.pts * p.time_base.num / p.time_base.den, p.stream_index))


SOURCES = {
    "rawvideo": raw_video_source,
    "h264": lambda: demuxed(DATA / "port" / "h264_crafted_small.h264"),
    "vp9": lambda: demuxed(DATA / "port" / "vp9_crafted_96x72.ivf"),
    "aac": lambda: demuxed(DATA / "bench" / "aac48k.adts", n=20),
    "pcm_s16le": lambda: pcm_source("pcm_s16le", "s16", "<i2"),
    "pcm_s16le_stereo": lambda: pcm_source("pcm_s16le", "s16", "<i2", 2),
    "pcm_f32le": lambda: pcm_source("pcm_f32le", "flt", "<f4"),
    "mjpeg": mjpeg_source,
    "av": av_source,
    "mjpeg_pcm": mjpeg_pcm_source,
}


def mux_with(tmp_path, side, fmt, name, streams, pkts, **opts):
    """Write the packets through one package's muxer (with the muxer's
    options `opts`); the bytes of each file in its directory (one but for
    image2, segment, dash and tee), or the error's class name."""
    d = tmp_path / side
    d.mkdir(exist_ok=True)
    conv = to_port if side == "port" else copy.deepcopy
    opener = open_output if side == "port" else ref_open_output
    try:
        m = opener(str(d / name), format=fmt, **opts)
        for par, tb in streams:
            m.add_stream(conv(par), time_base=conv(tb))
        for p in pkts:
            m.write_packet(conv(p))
        m.write_trailer()
        m.close()
    except (FFTPUError, RefError) as e:
        return type(e).__name__
    return {f.name: f.read_bytes() for f in sorted(d.iterdir())}


def demux_all(opener, url, **kw):
    d = opener(url, **kw)
    head = {"name": d.name, "streams": d.streams, "metadata": d.metadata,
            "chapters": d.chapters, "duration": d.duration,
            "start_time": d.start_time, "bit_rate": d.bit_rate}
    pkts = list(d.packets())
    d.close()
    return plain(head), plain(pkts)


def assert_same_demux(url, n_min=1, **kw):
    ref_kw = {k: (RefRational(v.num, v.den) if hasattr(v, "den") else v)
              for k, v in kw.items()}
    want = demux_all(ref_open_input, url, **ref_kw)
    got = demux_all(open_input, url, **kw)
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1]) >= n_min
    assert got[1] == want[1]


def decode_outcome(url, port: bool):
    """One package's demux and decode of every packet of `url`'s first
    stream: its frames as plain values, or its error's type and text."""
    if port:
        from ffmpeg_tpu_torch.codecs import CodecContext
        opener = open_input
    else:
        from ffmpeg_tpu.codecs import CodecContext
        opener = ref_open_input
    try:
        d = opener(str(url))
        pkts = list(d.packets())
        kw = {"device": "cpu"} if port else {}
        ctx = CodecContext.open_decoder(d.streams[0].codecpar, **kw)
        return plain(ctx.decode_all(pkts))
    except Exception as e:      # noqa: BLE001 — compared across packages
        return (type(e).__name__, str(e))


def assert_same_decode(url):
    """Both packages decode `url` alike: the same frames, or the same
    error."""
    want = decode_outcome(url, port=False)
    assert decode_outcome(url, port=True) == want
    return want
