"""Subtitle codecs, part 2: MOV timed text (tx3g) and HDMV PGS
bitmap subtitles.

Reference behavior: libavcodec/movtextdec.c / movtextenc.c (uint16
text length + UTF-8 + style boxes) and libavcodec/pgssubdec.c
(presentation/window/palette/object segments, RLE bitmaps, display
sets emitted at the 0x80 END segment). PGS rects are decoded to RGBA
numpy arrays in frame.side_data["rects"].

The port's copy of ffmpeg_tpu/codecs/subtitles2.py, held equal to it by
tests/test_torch_image_codecs.py.
Subtitles are host work: the codecs take the device that open_decoder
and open_encoder hand every codec, and keep it unused.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from ..core.frame import Frame
from ..core.packet import Packet, PKT_FLAG_KEY
from ..io.stream import MediaType
from ..utils.error import InvalidData
from .codec import DeviceCodec, register_decoder, register_encoder


# ------------------------------------------------------------- mov_text
@register_decoder
class MovTextDecoder(DeviceCodec):
    codec_id = "mov_text"
    codec_type = MediaType.SUBTITLE
    aliases = ("tx3g",)

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or len(pkt.data or b"") < 2:
            return []
        d = pkt.data
        tlen = struct.unpack(">H", d[:2])[0]
        tlen = min(tlen, len(d) - 2)
        text = d[2:2 + tlen].decode("utf-8", "replace")
        styles = []
        pos = 2 + tlen
        while pos + 8 <= len(d):
            size, tag = struct.unpack(">I4s", d[pos:pos + 8])
            if size < 8:
                break
            body = d[pos + 8:pos + size]
            if tag == b"styl" and len(body) >= 2:
                n = struct.unpack(">H", body[:2])[0]
                off = 2
                for _ in range(n):
                    if off + 12 > len(body):
                        break
                    (s, e, _fid, flags, _sz, r, g, b, a) = \
                        struct.unpack(">HHHBB4B", body[off:off + 12])
                    styles.append({"start": s, "end": e,
                                   "bold": bool(flags & 1),
                                   "italic": bool(flags & 2),
                                   "underline": bool(flags & 4),
                                   "color": (r, g, b, a)})
                    off += 12
            pos += size
        f = Frame(pts=pkt.pts, duration=pkt.duration,
                  time_base=pkt.time_base)
        f.side_data["text"] = text
        if styles:
            f.side_data["styles"] = styles
        # ass rendering of the basic flags
        ass = text
        for st in reversed(sorted(styles, key=lambda s: s["start"])):
            tags = "".join(t for flag, t in
                           ((st["bold"], r"\b1"),
                            (st["italic"], r"\i1"),
                            (st["underline"], r"\u1")) if flag)
            if tags and st["end"] <= len(ass):
                ass = (ass[:st["start"]] + "{" + tags + "}"
                       + ass[st["start"]:st["end"]] + r"{\r}"
                       + ass[st["end"]:])
        f.side_data["ass"] = ass.replace("\n", "\\N")
        return [f]


@register_encoder
class MovTextEncoder(DeviceCodec):
    codec_id = "mov_text"
    codec_type = MediaType.SUBTITLE
    is_encoder = True

    # default tx3g sample-entry body (movtextenc.c encode_sample_
    # description defaults: centered, 18pt Serif, white on
    # transparent)
    TX3G_EXTRADATA = (
        b"\x00\x00\x00\x00\x00\x00\x00\x00"   # displayFlags+justify
        b"\x00\x00\x00\x00"                   # background rgba
        b"\x00\x00\x00\x00\x00\x00\x00\x00"   # default text box
        b"\x00\x00"                           # start/end char
        b"\x00\x01\x00\x00\x12"               # font id, face, size
        b"\xff\xff\xff\xff"                   # fg rgba
        b"\x00\x0cftab\x00\x01\x00\x01\x05Serif")

    def __init__(self, par, options=None, *, device="cuda"):
        super().__init__(par, options, device=device)
        if not par.extradata:
            par.extradata = self.TX3G_EXTRADATA

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        text = frame.side_data.get("text", "")
        data = text.encode("utf-8")
        payload = struct.pack(">H", len(data)) + data
        return [Packet(data=payload, pts=frame.pts, dts=frame.pts,
                       duration=frame.duration, flags=PKT_FLAG_KEY,
                       time_base=frame.time_base)]


# ------------------------------------------------------------------ PGS
PALETTE_SEGMENT = 0x14
OBJECT_SEGMENT = 0x15
PRESENTATION_SEGMENT = 0x16
WINDOW_SEGMENT = 0x17
DISPLAY_SEGMENT = 0x80


def _yuv_to_rgba(y, cb, cr, alpha, bt709):
    """Limited-range YCbCr -> RGB (pgssubdec.c palette conversion;
    BT.709 for HD, BT.601 otherwise)."""
    y = (np.asarray(y, np.float64) - 16.0) * (255.0 / 219.0)
    cb = np.asarray(cb, np.float64) - 128.0
    cr = np.asarray(cr, np.float64) - 128.0
    if bt709:
        r = y + 1.5748 * (255.0 / 224.0) * cr
        g = y - 0.1873 * (255.0 / 224.0) * cb \
            - 0.4681 * (255.0 / 224.0) * cr
        b = y + 1.8556 * (255.0 / 224.0) * cb
    else:
        r = y + 1.402 * (255.0 / 224.0) * cr
        g = y - 0.344136 * (255.0 / 224.0) * cb \
            - 0.714136 * (255.0 / 224.0) * cr
        b = y + 1.772 * (255.0 / 224.0) * cb
    out = np.stack([r, g, b,
                    np.asarray(alpha, np.float64)], axis=-1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


class _PgsObject:
    __slots__ = ("w", "h", "rle", "remaining")

    def __init__(self):
        self.w = self.h = 0
        self.rle = b""
        self.remaining = 0


def decode_pgs_rle(data: bytes, w: int, h: int) -> np.ndarray:
    """PGS RLE -> (h, w) palette-index bitmap (pgssubdec.c:162)."""
    out = np.zeros(w * h, np.uint8)
    pos = 0
    count = 0
    line = 0
    n = len(data)
    while pos < n and line < h:
        color = data[pos]
        pos += 1
        run = 1
        if color == 0:
            if pos >= n:
                break
            flags = data[pos]
            pos += 1
            run = flags & 0x3F
            if flags & 0x40:
                run = (run << 8) + data[pos]
                pos += 1
            color = data[pos] if flags & 0x80 else 0
            if flags & 0x80:
                pos += 1
        if run > 0 and count + run <= w * h:
            out[count:count + run] = color
            count += run
        elif run == 0:
            line += 1
    if count < w * h:
        raise InvalidData("pgs: insufficient RLE data")
    return out.reshape(h, w)


@register_decoder
class PgsDecoder(DeviceCodec):
    codec_id = "hdmv_pgs_subtitle"
    codec_type = MediaType.SUBTITLE
    aliases = ("pgssub",)

    def __init__(self, par, options=None, *, device="cuda"):
        super().__init__(par, options, device=device)
        self.palettes = {}
        self.objects = {}
        self.presentation = None
        self.width = par.width or 0
        self.height = par.height or 0

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        d = pkt.data
        pos = 0
        frames = []
        while pos + 3 <= len(d):
            stype = d[pos]
            slen = struct.unpack(">H", d[pos + 1:pos + 3])[0]
            seg = d[pos + 3:pos + 3 + slen]
            pos += 3 + slen
            if stype == PALETTE_SEGMENT:
                self._palette(seg)
            elif stype == OBJECT_SEGMENT:
                self._object(seg)
            elif stype == PRESENTATION_SEGMENT:
                self._presentation(seg)
            elif stype == WINDOW_SEGMENT:
                pass
            elif stype == DISPLAY_SEGMENT:
                f = self._display(pkt)
                if f is not None:
                    frames.append(f)
        return frames

    def _palette(self, seg):
        if len(seg) < 2:
            raise InvalidData("pgs: short palette segment")
        pid = seg[0]
        pal = self.palettes.setdefault(
            pid, np.zeros((256, 4), np.uint8))
        body = seg[2:]
        n = len(body) // 5
        e = np.frombuffer(body[:n * 5], np.uint8).reshape(n, 5)
        bt709 = self.height <= 0 or self.height > 576
        rgba = _yuv_to_rgba(e[:, 1], e[:, 3], e[:, 2], e[:, 4],
                            bt709)
        pal[e[:, 0]] = rgba

    def _object(self, seg):
        if len(seg) < 4:
            raise InvalidData("pgs: short object segment")
        oid = struct.unpack(">H", seg[:2])[0]
        seq = seg[3]
        obj = self.objects.setdefault(oid, _PgsObject())
        body = seg[4:]
        if not seq & 0x80:                 # continuation
            if len(body) > obj.remaining:
                raise InvalidData("pgs: RLE overflow")
            obj.rle += body
            obj.remaining -= len(body)
            return
        if len(body) < 7:
            raise InvalidData("pgs: short object header")
        rle_len = int.from_bytes(body[:3], "big") - 4
        obj.w, obj.h = struct.unpack(">HH", body[3:7])
        data = body[7:]
        if len(data) > rle_len:
            raise InvalidData("pgs: RLE length mismatch")
        obj.rle = data
        obj.remaining = rle_len - len(data)

    def _presentation(self, seg):
        if len(seg) < 11:
            raise InvalidData("pgs: short presentation segment")
        w, h = struct.unpack(">HH", seg[:4])
        self.width, self.height = w, h
        state = seg[7] >> 6
        if state != 0:
            self.palettes.clear()
            self.objects.clear()
        palette_id = seg[9]
        count = seg[10]
        objs = []
        pos = 11
        for _ in range(count):
            if pos + 8 > len(seg):
                raise InvalidData("pgs: short object ref")
            oid, _wid, cflag, x, y = struct.unpack(
                ">HBBHH", seg[pos:pos + 8])
            pos += 8
            crop = None
            if cflag & 0x80:
                crop = struct.unpack(">HHHH", seg[pos:pos + 8])
                pos += 8
            objs.append((oid, x, y, crop))
        self.presentation = (palette_id, objs)

    def _display(self, pkt) -> Optional[Frame]:
        if self.presentation is None:
            return None
        palette_id, objs = self.presentation
        pal = self.palettes.get(palette_id)
        rects = []
        for oid, x, y, crop in objs:
            obj = self.objects.get(oid)
            if obj is None or obj.remaining or not obj.w:
                continue
            idx = decode_pgs_rle(obj.rle, obj.w, obj.h)
            if crop:
                cx, cy, cw, chh = crop
                idx = idx[cy:cy + chh, cx:cx + cw]
            rgba = (pal if pal is not None
                    else np.zeros((256, 4), np.uint8))[idx]
            rects.append({"x": x, "y": y, "w": idx.shape[1],
                          "h": idx.shape[0], "rgba": rgba,
                          "indices": idx})
        f = Frame(pts=pkt.pts, duration=pkt.duration,
                  time_base=pkt.time_base)
        f.side_data["rects"] = rects
        f.side_data["canvas"] = (self.width, self.height)
        return f
