"""Codec framework (counterpart of ffmpeg_tpu/codecs/codec.py; analog of
libavcodec's public API and its FFCodec vtable).

The send/receive model matches avcodec.h:2361-2442:
  decode:  send_packet(pkt) / receive_frame() -> Frame, TryAgain, EndOfStream
  encode:  send_frame(frame) / receive_packet() -> Packet, ...
Flush by sending None.  A codec implements `decode(pkt) -> [Frame]` or
`encode(frame) -> [Packet]`; the queueing and drain logic live once in
CodecContext, as decode.c and encode.c have them.

Port codecs run their device stage on the device they are opened on:
`open_decoder` and `open_encoder` hand their `device` (the card unless
the caller names another, such as "cpu") to the codec's constructor.
There is no fallback to another device.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Type

import torch

from .._cuda_build import CudaBuildError
from ..core.frame import Frame
from ..core.packet import Packet
from ..io.stream import CodecParameters, MediaType
from ..native import NativeBuildError
from ..utils.error import (DecoderNotFound, EncoderNotFound, EndOfStream,
                           FFTPUError, InvalidData, TryAgain)
from ..utils.log import LogMixin
from ..utils.rational import Rational

_DECODERS: Dict[str, Type["Codec"]] = {}
_ENCODERS: Dict[str, Type["Codec"]] = {}


@dataclass
class EncoderParameters:
    """What an encoder reads of its stream's parameters.  Any object with
    `width`, `height` and, optionally, `framerate` and `codec_id` serves
    as well (CodecParameters does)."""
    codec_id: str = "none"
    width: int = 0
    height: int = 0
    framerate: Rational = field(default_factory=lambda: Rational(0, 1))


def register_decoder(cls):
    _DECODERS.setdefault(cls.codec_id, cls)
    for alias in getattr(cls, "aliases", ()):
        _DECODERS.setdefault(alias, cls)
    return cls


def register_encoder(cls):
    _ENCODERS.setdefault(cls.codec_id, cls)
    return cls


def decoder_names() -> List[str]:
    return sorted(_DECODERS)


def encoder_names() -> List[str]:
    return sorted(_ENCODERS)


def _passes_backstop(e: BaseException) -> bool:
    """Errors the decode backstop passes through: the framework's own,
    and faults of the card, of a build or of the process, which must not
    read as malformed input: a CUDA error
    (torch raises RuntimeError, or AcceleratorError where torch has it;
    a torch built without CUDA raises AssertionError for a tensor on the
    card),
    running out of device or host memory, a native or CUDA build that
    failed, and the full-float32 precondition of the transforms."""
    if isinstance(e, (FFTPUError, MemoryError, RecursionError,
                      NativeBuildError, CudaBuildError,
                      torch.cuda.OutOfMemoryError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, (RuntimeError, AssertionError)) and any(
        s in str(e) for s in ("CUDA", "cuda", "full float32"))


class Codec(LogMixin):
    """Base for the port's codec implementations; class attributes mirror
    FFCodec."""

    codec_id = "none"
    codec_type = MediaType.VIDEO
    is_encoder = False
    capabilities: tuple = ()       # e.g. ("delay",)

    def __init__(self, par, options: Optional[dict] = None):
        self.par = par
        self.options = options or {}
        self.log_name = self.codec_id
        self.time_base = Rational(0, 1)

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        """pkt=None means drain."""
        raise NotImplementedError

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        """frame=None means drain."""
        raise NotImplementedError

    def flush_state(self) -> None:
        """Reset for seeking (avcodec_flush_buffers)."""


class DeviceCodec(Codec):
    """A codec that keeps the device open_decoder or open_encoder hands
    it, for codecs whose constructor needs nothing else."""

    def __init__(self, par, options: Optional[dict] = None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)


class CodecContext(LogMixin):
    """Public wrapper implementing send/receive queueing (decode.c and
    encode.c analog)."""

    def __init__(self, codec: Codec):
        self.codec = codec
        self.par = codec.par
        self.log_name = f"ctx:{codec.codec_id}"
        self._out: deque = deque()
        self._draining = False

    # --- decoding -----------------------------------------------------------
    @staticmethod
    def open_decoder(par: CodecParameters, options: Optional[dict] = None,
                     codec_id: Optional[str] = None, *,
                     device: torch.device | str = "cuda"
                     ) -> "CodecContext":
        cid = codec_id or par.codec_id
        cls = _DECODERS.get(cid)
        if cls is None:
            raise DecoderNotFound(f"no decoder for {cid!r}")
        try:
            codec = cls(par, options, device=device)
        except Exception as e:      # noqa: BLE001 — contract boundary
            if _passes_backstop(e):
                raise
            # corrupted extradata/params must not crash open
            raise InvalidData(
                f"{cid}: malformed codec parameters "
                f"({type(e).__name__}: {e})") from e
        return CodecContext(codec)

    def decode_frames(self, pkts) -> list:
        """Batched decode when the codec supports it; else decode_all."""
        fn = getattr(self.codec, "decode_frames", None)
        if fn is not None:
            return fn(list(pkts))
        return self.decode_all(pkts)

    def send_packet(self, pkt: Optional[Packet]) -> None:
        if self._draining and pkt is not None:
            raise InvalidData("send_packet after drain started")
        if pkt is None:
            if not self._draining:
                self._draining = True
                self._out.extend(self._decode_guarded(None))
            return
        self._out.extend(self._decode_guarded(pkt))

    def _decode_guarded(self, pkt):
        """Safety net of the generic decode loop (decode.c
        AVERROR_INVALIDDATA contract): malformed input surfaces as
        InvalidData, never as a raw exception from a decoder's internals.
        Narrower than the reference's: a fault of the card or of a build
        (`_passes_backstop`) passes through unchanged, so that it never
        reads as bad input."""
        try:
            return self.codec.decode(pkt)
        except Exception as e:      # noqa: BLE001 — contract boundary
            if _passes_backstop(e):
                raise
            raise InvalidData(
                f"{self.codec.codec_id}: malformed input "
                f"({type(e).__name__}: {e})") from e

    def receive_frame(self) -> Frame:
        if self._out:
            f = self._out.popleft()
            self._fill_frame_props(f)
            return f
        if self._draining:
            raise EndOfStream()
        raise TryAgain()

    def _fill_frame_props(self, f: Frame) -> None:
        """decode.c:574 frame-prop fill analog: propagate container-level
        colour/HDR metadata onto decoded frames when the decoder did not
        set them."""
        par = self.par
        if par.codec_type != MediaType.VIDEO or not getattr(f, "width", 0):
            return
        for attr in ("color_range", "color_space",
                     "color_primaries", "color_trc"):
            if getattr(f, attr, "unspecified") in ("unspecified", "", None) \
                    and getattr(par, attr, "unspecified") != "unspecified":
                setattr(f, attr, getattr(par, attr))
        if par.mastering_display and \
                "mastering_display_metadata" not in f.side_data:
            f.side_data["mastering_display_metadata"] = \
                dict(par.mastering_display)
        if par.content_light and "content_light_level" not in f.side_data:
            f.side_data["content_light_level"] = dict(par.content_light)

    # --- encoding -----------------------------------------------------------
    @staticmethod
    def open_encoder(par, options: Optional[dict] = None,
                     codec_id: Optional[str] = None, *,
                     device: torch.device | str = "cuda"
                     ) -> "CodecContext":
        cid = codec_id or par.codec_id
        cls = _ENCODERS.get(cid)
        if cls is None:
            raise EncoderNotFound(f"no encoder for {cid!r}")
        return CodecContext(cls(par, options, device=device))

    def send_frame(self, frame: Optional[Frame]) -> None:
        if frame is None:
            if not self._draining:
                self._draining = True
                self._out.extend(self.codec.encode(None))
            return
        self._out.extend(self.codec.encode(frame))

    def receive_packet(self) -> Packet:
        if self._out:
            return self._out.popleft()
        if self._draining:
            raise EndOfStream()
        raise TryAgain()

    # --- common -------------------------------------------------------------
    def flush(self) -> None:
        self._out.clear()
        self._draining = False
        self.codec.flush_state()

    def decode_all(self, packets) -> List[Frame]:
        """Convenience: decode an iterable of packets + drain."""
        frames: List[Frame] = []
        for pkt in packets:
            self.send_packet(pkt)
            while True:
                try:
                    frames.append(self.receive_frame())
                except (TryAgain, EndOfStream):
                    break
        self.send_packet(None)
        while True:
            try:
                frames.append(self.receive_frame())
            except EndOfStream:
                break
        return frames
