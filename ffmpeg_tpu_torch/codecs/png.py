"""PNG decoder/encoder (reference: libavcodec/pngdec.c / pngenc.c).

Host-only codec: DEFLATE via zlib, per-row unfiltering vectorized with
numpy (the serial dependency is only on the Paeth/up/avg recurrences,
handled row-by-row over whole-row vectors). Images are intra tensors —
no TPU stage needed at decode; the data lands as component planes ready
for the device pipeline.

The port's copy of ffmpeg_tpu/codecs/png.py, held equal to it by
tests/test_torch_image_codecs.py.
The decoder puts each picture on the device it is opened on with one
upload (Frame.from_bytes, or device_planes for an expanded palette);
the encoder copies a frame's planes to the host once (Frame.numpy).
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional

import numpy as np

from ..core.frame import Frame, device_planes
from ..core.packet import Packet, PKT_FLAG_KEY
from ..io.stream import MediaType
from ..utils.error import InvalidData, NotSupported
from .codec import DeviceCodec, register_decoder, register_encoder

_SIG = b"\x89PNG\r\n\x1a\n"

# color type → (n components, pix_fmt template per bit depth)
_FMTS = {
    (0, 8): "gray", (0, 16): "gray16be",
    (2, 8): "rgb24", (2, 16): "rgb48be",
    (4, 8): "ya8", (6, 8): "rgba", (6, 16): "rgba64be",
    (3, 8): "pal8", (3, 4): "pal8", (3, 2): "pal8", (3, 1): "pal8",
}


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """raw: (h, 1+stride) filter byte + row data → (h, stride) unfiltered."""
    ftypes = raw[:, 0]
    data = raw[:, 1:].astype(np.int32)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        row = data[y]
        f = ftypes[y]
        if f == 0:
            cur = row
        elif f == 1:      # sub: serial along x with lag bpp → cumulative
            cur = row.copy()
            for x in range(bpp, stride):
                cur[x] = (cur[x] + cur[x - bpp]) & 0xFF
        elif f == 2:      # up
            cur = (row + prev) & 0xFF
        elif f == 3:      # average
            cur = row.copy()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif f == 4:      # paeth
            cur = row.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise InvalidData(f"png: bad filter {f}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


@register_decoder
class PngDecoder(DeviceCodec):
    codec_id = "png"
    codec_type = MediaType.VIDEO
    aliases = ("apng",)

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        data = pkt.data
        if data[:8] != _SIG:
            raise InvalidData("png: bad signature")
        i = 8
        idat = bytearray()
        w = h = bit_depth = color_type = 0
        palette = None
        trns = None
        while i + 8 <= len(data):
            length, ctype = struct.unpack(">I4s", data[i:i + 8])
            chunk = data[i + 8:i + 8 + length]
            i += 12 + length
            if ctype == b"IHDR":
                w, h, bit_depth, color_type, comp, filt, interlace = \
                    struct.unpack(">IIBBBBB", chunk)
                if interlace:
                    raise NotSupported("png: interlaced (Adam7)")
            elif ctype == b"PLTE":
                palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
            elif ctype == b"tRNS":
                trns = np.frombuffer(chunk, np.uint8)
            elif ctype == b"IDAT":
                idat += chunk
            elif ctype == b"IEND":
                break
        fmt = _FMTS.get((color_type, bit_depth))
        if fmt is None:
            raise NotSupported(f"png: color_type={color_type} depth={bit_depth}")
        ncomp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
        bits_pp = ncomp * bit_depth
        stride = (w * bits_pp + 7) // 8
        bpp = max(1, bits_pp // 8)
        raw = np.frombuffer(zlib.decompress(bytes(idat)), np.uint8)
        if raw.size != h * (stride + 1):
            raise InvalidData("png: bad IDAT size")
        rows = _unfilter(raw.reshape(h, stride + 1), h, stride, bpp)

        if color_type == 3:
            # expand palette to rgb24/rgba
            if bit_depth < 8:
                expanded = np.zeros((h, w), np.uint8)
                per = 8 // bit_depth
                mask = (1 << bit_depth) - 1
                for j in range(per):
                    shift = 8 - bit_depth * (j + 1)
                    cols = np.arange(j, w, per)
                    expanded[:, cols] = (rows[:, (cols // per)] >> shift) & mask
                idx = expanded
            else:
                idx = rows[:, :w]
            if palette is None:
                raise InvalidData("png: pal8 without PLTE")
            rgb = palette[idx]          # (h, w, 3)
            if trns is not None:
                alpha = np.full(256, 255, np.uint8)
                alpha[:len(trns)] = trns
                planes = [rgb[:, :, 0], rgb[:, :, 1], rgb[:, :, 2], alpha[idx]]
                fmt = "rgba"
            else:
                planes = [rgb[:, :, 0], rgb[:, :, 1], rgb[:, :, 2]]
                fmt = "rgb24"
            f = Frame.video(w, h, fmt, planes=device_planes(
                [np.ascontiguousarray(p) for p in planes], self.device),
                            pts=pkt.pts, time_base=pkt.time_base)
            return [f]

        f = Frame.from_bytes(rows.tobytes(), fmt, w, h, device=self.device,
                             pts=pkt.pts, time_base=pkt.time_base)
        f.color_range = "pc"
        return [f]


@register_encoder
class PngEncoder(DeviceCodec):
    codec_id = "png"
    codec_type = MediaType.VIDEO
    is_encoder = True

    _CTYPE = {"gray": 0, "gray16be": 0, "rgb24": 2, "rgb48be": 2,
              "ya8": 4, "rgba": 6, "rgba64be": 6}

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        from ..formats import pixfmt as _pf
        fmt = _pf.get(frame.format).name
        if fmt not in self._CTYPE:
            # convert-free encoder: caller should format-filter first
            raise NotSupported(f"png enc: pix_fmt {fmt} (use format filter)")
        desc = _pf.get(fmt)
        depth = desc.comp[0].depth
        color_type = self._CTYPE[fmt]
        w, h = frame.width, frame.height
        raw = frame.numpy().to_bytes()
        stride = len(raw) // h
        rows = np.frombuffer(raw, np.uint8).reshape(h, stride)
        # "up" filter: cheap and effective; filter byte 2 per row
        filtered = np.zeros((h, stride + 1), np.uint8)
        filtered[:, 0] = 2
        filtered[0, 0] = 0
        filtered[0, 1:] = rows[0]
        filtered[1:, 1:] = rows[1:] - rows[:-1]
        comp = zlib.compress(filtered.tobytes(), 6)

        out = bytearray(_SIG)

        def chunk(tag: bytes, payload: bytes):
            out.extend(struct.pack(">I", len(payload)))
            out.extend(tag)
            out.extend(payload)
            out.extend(struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

        chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0))
        chunk(b"IDAT", comp)
        chunk(b"IEND", b"")
        return [Packet(data=bytes(out), pts=frame.pts, dts=frame.pts,
                       duration=frame.duration, flags=PKT_FLAG_KEY,
                       time_base=frame.time_base)]
