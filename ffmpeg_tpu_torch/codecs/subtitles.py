"""Subtitle codecs: SRT/SubRip (srtdec.c/srtenc.c analogs) — text subs
decoded to text+timing side frames.

The port's copy of ffmpeg_tpu/codecs/subtitles.py, held equal to it by
tests/test_torch_image_codecs.py.
Subtitles are host work: the codecs take the device that open_decoder
and open_encoder hand every codec, and keep it unused.
"""

from __future__ import annotations

import re
from typing import List, Optional

from ..core.frame import Frame
from ..core.packet import Packet, PKT_FLAG_KEY
from ..io.stream import MediaType
from .codec import DeviceCodec, register_decoder, register_encoder


@register_decoder
class SrtDecoder(DeviceCodec):
    """Decodes SubRip payloads: text carried in frame.side_data['text']."""

    codec_id = "subrip"
    codec_type = MediaType.SUBTITLE
    aliases = ("srt",)

    _TAG_RE = re.compile(r"<[^>]+>")

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        text = pkt.data.decode("utf-8", "replace")
        plain = self._TAG_RE.sub("", text).strip()
        f = Frame(pts=pkt.pts, duration=pkt.duration,
                  time_base=pkt.time_base)
        f.side_data["text"] = plain
        f.side_data["ass"] = text
        return [f]


@register_encoder
class SrtEncoder(DeviceCodec):
    codec_id = "subrip"
    codec_type = MediaType.SUBTITLE
    is_encoder = True

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        text = frame.side_data.get("text", "")
        return [Packet(data=text.encode("utf-8"), pts=frame.pts,
                       dts=frame.pts, duration=frame.duration,
                       flags=PKT_FLAG_KEY, time_base=frame.time_base)]


# Default script header equivalent to the reference's
# ff_ass_subtitle_header (libavcodec/ass.c) defaults.
ASS_DEFAULT_HEADER = """[Script Info]
ScriptType: v4.00+
PlayResX: 384
PlayResY: 288
ScaledBorderAndShadow: yes
YCbCr Matrix: None

[V4+ Styles]
Format: Name, Fontname, Fontsize, PrimaryColour, SecondaryColour, \
OutlineColour, BackColour, Bold, Italic, Underline, StrikeOut, \
ScaleX, ScaleY, Spacing, Angle, BorderStyle, Outline, Shadow, \
Alignment, MarginL, MarginR, MarginV, Encoding
Style: Default,Arial,16,&Hffffff,&Hffffff,&H0,&H0,0,0,0,0,100,100,\
0,0,1,1,0,2,10,10,10,1

[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, \
Effect, Text
"""

_ASS_OVERRIDE_RE = re.compile(r"\{[^}]*\}")


@register_decoder
class AssDecoder(DeviceCodec):
    """ASS events (reference: libavcodec/assdec.c wire format
    'ReadOrder,Layer,Style,Name,MarginL,MarginR,MarginV,Effect,Text')
    decoded to plain text + the raw event."""

    codec_id = "ass"
    codec_type = MediaType.SUBTITLE
    aliases = ("ssa",)

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        raw = pkt.data.decode("utf-8", "replace")
        fields = raw.split(",", 8)
        text = fields[8] if len(fields) == 9 else raw
        plain = _ASS_OVERRIDE_RE.sub("", text)
        plain = plain.replace("\\N", "\n").replace("\\n", "\n")
        plain = plain.replace("\\h", " ").strip()
        f = Frame(pts=pkt.pts, duration=pkt.duration,
                  time_base=pkt.time_base)
        f.side_data["text"] = plain
        f.side_data["ass"] = raw
        return [f]


@register_encoder
class AssEncoder(DeviceCodec):
    """Builds ASS event payloads; reuses the original event when the
    frame came from an ASS decode, else synthesizes a Default-style
    dialogue from the plain text."""

    codec_id = "ass"
    codec_type = MediaType.SUBTITLE
    is_encoder = True

    def __init__(self, par, options=None, *, device="cuda"):
        super().__init__(par, options, device=device)
        if not par.extradata:
            par.extradata = ASS_DEFAULT_HEADER.encode("utf-8")
        self._readorder = 0

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        raw = frame.side_data.get("ass")
        if raw and raw.count(",") >= 8:
            payload = raw
        else:
            text = frame.side_data.get("text", "")
            text = text.replace("\n", "\\N")
            payload = f"{self._readorder},0,Default,,0,0,0,,{text}"
        self._readorder += 1
        return [Packet(data=payload.encode("utf-8"), pts=frame.pts,
                       dts=frame.pts, duration=frame.duration,
                       flags=PKT_FLAG_KEY, time_base=frame.time_base)]


@register_decoder
class WebVttDecoder(DeviceCodec):
    """WebVTT cue payload → text (libavcodec/webvttdec.c analog):
    strips cue-span tags (<b>, <c.class>, <v Name>, timestamps)."""

    codec_id = "webvtt"
    codec_type = MediaType.SUBTITLE

    _TAG_RE = re.compile(r"<[^>]*>")

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        text = pkt.data.decode("utf-8", "replace")
        plain = self._TAG_RE.sub("", text)
        plain = plain.replace("&amp;", "&").replace("&lt;", "<") \
            .replace("&gt;", ">").replace("&nbsp;", " ").strip()
        f = Frame(pts=pkt.pts, duration=pkt.duration,
                  time_base=pkt.time_base)
        f.side_data["text"] = plain
        f.side_data["ass"] = plain.replace("\n", "\\N")
        return [f]


@register_encoder
class WebVttEncoder(DeviceCodec):
    """text → WebVTT cue payload (libavcodec/webvttenc.c analog)."""

    codec_id = "webvtt"
    codec_type = MediaType.SUBTITLE
    is_encoder = True

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        text = frame.side_data.get("text", "")
        text = text.replace("&", "&amp;").replace("<", "&lt;") \
            .replace(">", "&gt;")
        return [Packet(data=text.encode("utf-8"), pts=frame.pts,
                       dts=frame.pts, duration=frame.duration,
                       flags=PKT_FLAG_KEY, time_base=frame.time_base)]
