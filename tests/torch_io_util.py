"""Helpers of the port's I/O and CLI tests (test_torch_io_formats.py,
test_torch_cli.py): both packages' objects as plain values, reference
objects carried over into the port's classes, the structural comparison
of a port module with its reference counterpart, and the seeded inputs
both packages read."""

import ast
import dataclasses
import struct
from pathlib import Path

import numpy as np
import torch

from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.formats.channel_layout import ChannelLayout as RefLayout
from ffmpeg_tpu.io.stream import CodecParameters as RefPar
from ffmpeg_tpu.io.stream import StreamInfo as RefStream
from ffmpeg_tpu.utils.rational import Rational as RefRational
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.formats.channel_layout import ChannelLayout
from ffmpeg_tpu_torch.io.stream import CodecParameters, StreamInfo
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


def _ogg_crc(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = (crc << 1) ^ 0x04C11DB7 if crc & 0x80000000 else crc << 1
            crc &= 0xFFFFFFFF
    return crc


def ogg_page(packet: bytes, serial: int, seq: int, htype: int,
             granule: int) -> bytes:
    """One Ogg page (RFC 3533) holding one packet of < 255 bytes."""
    assert len(packet) < 255
    hdr = (b"OggS" + bytes([0, htype]) + struct.pack("<qII", granule,
                                                      serial, seq)
           + b"\0\0\0\0" + bytes([1, len(packet)]))
    page = hdr + packet
    crc = _ogg_crc(page)
    return page[:22] + struct.pack("<I", crc) + page[26:]


def opus_ogg() -> bytes:
    """A minimal Ogg Opus file: OpusHead, OpusTags and one silent CELT
    packet (the reference has no Ogg muxer, so the test writes the
    pages)."""
    head = b"OpusHead" + bytes([1, 1]) + struct.pack("<HIhB", 312, 48000,
                                                      0, 0)
    tags = b"OpusTags" + struct.pack("<I", 4) + b"test" + \
        struct.pack("<I", 0)
    return (ogg_page(head, 7, 0, 2, 0) + ogg_page(tags, 7, 1, 0, 0)
            + ogg_page(b"\xf8\xff\xfe", 7, 2, 4, 960))
