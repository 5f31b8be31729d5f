"""Encoder half of the codec framework (counterpart of
ffmpeg_tpu/codecs/codec.py; analog of libavcodec's public encode API).

The send/receive model matches avcodec.h: `send_frame(frame)` then
`receive_packet()`, which returns a Packet or raises TryAgain (send more
input) or EndOfStream (drained).  Flush by sending None.  An encoder
implements `encode(frame) -> [Packet]`; the queueing and drain logic
live once in CodecContext.

Port encoders run their device stage on the device they are opened on:
`open_encoder` hands its `device` (the card unless the caller names
another, such as "cpu") to the encoder's constructor.  There is no
fallback to another device.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Type

import torch

from ..core.frame import Frame
from ..core.packet import Packet
from ..utils.error import EncoderNotFound, EndOfStream, TryAgain
from ..utils.rational import Rational

_ENCODERS: Dict[str, Type["Codec"]] = {}


@dataclass
class EncoderParameters:
    """What an encoder reads of its stream's parameters.  Any object with
    `width`, `height` and, optionally, `framerate` and `codec_id` serves
    as well (the reference's CodecParameters does)."""
    codec_id: str = "none"
    width: int = 0
    height: int = 0
    framerate: Rational = field(default_factory=lambda: Rational(0, 1))


def register_encoder(cls):
    _ENCODERS.setdefault(cls.codec_id, cls)
    return cls


def encoder_names() -> List[str]:
    return sorted(_ENCODERS)


class Codec:
    """Base for the port's codec implementations."""

    codec_id = "none"

    def __init__(self, par, options: Optional[dict] = None):
        self.par = par
        self.options = options or {}

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        """frame=None means drain."""
        raise NotImplementedError

    def flush_state(self) -> None:
        """Reset for seeking (avcodec_flush_buffers)."""


class CodecContext:
    """Public wrapper implementing send/receive queueing (encode.c
    analog)."""

    def __init__(self, codec: Codec):
        self.codec = codec
        self.par = codec.par
        self._out: deque = deque()
        self._draining = False

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

    def flush(self) -> None:
        self._out.clear()
        self._draining = False
        self.codec.flush_state()
