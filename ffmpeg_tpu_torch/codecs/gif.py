"""GIF decode/encode (reference: libavcodec/gifdec.c + gif.c, LZW core in
libavcodec/lzw.c / lzwenc.c).

Host/device split: LZW is inherently serial byte work so it stays on the
host; frames are materialised as dense RGB(A) arrays, which is what the
TPU filter/scale pipeline consumes (the reference outputs pal8/bgra and
defers palette expansion — on TPU a palette gather is one fused lookup,
so we expand eagerly and keep the wire format simple).

The port's copy of ffmpeg_tpu/codecs/gif.py, held equal to it by
tests/test_torch_host_codecs.py.  LZW and the canvas stay on the host;
the decoder puts each shown canvas on the device it is opened on with
one upload (upload_rgba), and the encoder copies a frame's RGB to the
host once (host_array).
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np
import torch

from ..core.frame import Frame, host_array
from ..core.packet import Packet, PKT_FLAG_KEY
from ..utils.error import InvalidData
from ..utils.rational import Rational
from .codec import DeviceCodec, register_decoder, register_encoder


# ---------------------------------------------------------------------------
# LZW (GIF variant: variable 3..12 bit codes, LSB-first packing)

def lzw_decode(data: bytes, min_code_size: int, npixels: int) -> np.ndarray:
    clear = 1 << min_code_size
    end = clear + 1
    out = np.empty(npixels, np.uint8)
    nout = 0
    # dictionary as prefix/suffix arrays — avoids building Python lists of
    # strings for every entry
    prefix = np.zeros(4096, np.int32)
    suffix = np.zeros(4096, np.uint8)
    stack = bytearray(4096)

    code_size = min_code_size + 1
    next_code = end + 1
    mask = (1 << code_size) - 1
    bitbuf = 0
    nbits = 0
    pos = 0
    prev = -1
    first = 0
    n = len(data)
    while nout < npixels:
        while nbits < code_size:
            if pos >= n:
                out[nout:] = 0
                return out
            bitbuf |= data[pos] << nbits
            pos += 1
            nbits += 8
        code = bitbuf & mask
        bitbuf >>= code_size
        nbits -= code_size
        if code == clear:
            code_size = min_code_size + 1
            mask = (1 << code_size) - 1
            next_code = end + 1
            prev = -1
            continue
        if code == end:
            break
        sp = 0
        c = code
        if c >= next_code:          # KwKwK case
            if prev < 0 or c > next_code:
                raise InvalidData("gif: corrupt LZW stream")
            stack[sp] = first
            sp += 1
            c = prev
        while c >= clear:
            stack[sp] = suffix[c]
            sp += 1
            c = prefix[c]
        first = c
        stack[sp] = c
        sp += 1
        take = min(sp, npixels - nout)
        out[nout:nout + take] = np.frombuffer(
            bytes(stack[:sp][::-1]), np.uint8)[:take]
        nout += take
        if prev >= 0 and next_code < 4096:
            prefix[next_code] = prev
            suffix[next_code] = first
            next_code += 1
            if next_code == (1 << code_size) and code_size < 12:
                code_size += 1
                mask = (1 << code_size) - 1
        prev = code
    return out


def lzw_encode(indices: np.ndarray, min_code_size: int) -> bytes:
    clear = 1 << min_code_size
    end = clear + 1
    table = {}
    code_size = min_code_size + 1
    next_code = end + 1
    outbits = bytearray()
    bitbuf = 0
    nbits = 0

    def emit(code):
        nonlocal bitbuf, nbits
        bitbuf |= code << nbits
        nbits += code_size
        while nbits >= 8:
            outbits.append(bitbuf & 0xFF)
            bitbuf >>= 8
            nbits -= 8

    emit(clear)
    data = indices.tobytes()
    w = data[:1]
    for i in range(1, len(data)):
        c = data[i:i + 1]
        wc = w + c
        if wc in table:
            w = wc
            continue
        emit(table[w] if len(w) > 1 else w[0])
        if next_code < 4096:
            table[wc] = next_code
            next_code += 1
            if next_code > (1 << code_size) and code_size < 12:
                code_size += 1
        else:
            emit(clear)
            table.clear()
            code_size = min_code_size + 1
            next_code = end + 1
        w = c
    if w:
        emit(table[w] if len(w) > 1 else w[0])
    emit(end)
    if nbits:
        outbits.append(bitbuf & 0xFF)
    return bytes(outbits)


def _subblocks(buf: bytes, pos: int):
    """Collect GIF data sub-blocks starting at pos → (bytes, newpos)."""
    out = bytearray()
    while pos < len(buf):
        sz = buf[pos]
        pos += 1
        if sz == 0:
            break
        out += buf[pos:pos + sz]
        pos += sz
    return bytes(out), pos


_DEINTERLACE_PASSES = ((0, 8), (4, 8), (2, 4), (1, 2))


def upload_rgba(canvas: np.ndarray, device) -> list:
    """An (h, w, 4) RGBA canvas as four contiguous planes on `device`,
    moved there in one copy."""
    t = torch.as_tensor(np.ascontiguousarray(canvas.transpose(2, 0, 1)),
                        device=device)
    return list(t.unbind(0))


# ---------------------------------------------------------------------------

@register_decoder
class GifDecoder(DeviceCodec):
    """Each packet: optional GCE + image descriptor + LZW data (as split by
    the gif demuxer). Maintains the logical-screen canvas across frames to
    honor disposal methods (gifdec.c gif_read_image)."""

    codec_id = "gif"

    def __init__(self, par, options=None, *, device="cuda"):
        super().__init__(par, options, device=device)
        self.w = par.width or 0
        self.h = par.height or 0
        self.gct = None
        ed = par.extradata or b""
        if len(ed) >= 13 and ed[:6] in (b"GIF87a", b"GIF89a"):
            self.w, self.h = struct.unpack("<HH", ed[6:10])
            flags = ed[10]
            self._bg = ed[11]
            if flags & 0x80:
                ngct = 2 << (flags & 7)
                self.gct = np.frombuffer(
                    ed[13:13 + 3 * ngct], np.uint8).reshape(-1, 3).copy()
        self.canvas = None     # (h, w, 4) uint8 RGBA

    def flush_state(self) -> None:
        self.canvas = None

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None:
            return []
        return [self._decode(pkt)]

    def _decode(self, pkt: Packet) -> Frame:
        buf = pkt.data
        pos = 0
        transparent = -1
        disposal = 0
        while pos < len(buf):
            b = buf[pos]
            if b == 0x21:              # extension
                label = buf[pos + 1]
                if label == 0xF9 and buf[pos + 2] >= 4:
                    flags = buf[pos + 3]
                    disposal = (flags >> 2) & 7
                    if flags & 1:
                        transparent = buf[pos + 6]
                _, pos = _subblocks(buf, pos + 2)
            elif b == 0x2C:            # image descriptor
                ix, iy, iw, ih = struct.unpack("<HHHH", buf[pos + 1:pos + 9])
                flags = buf[pos + 9]
                pos += 10
                pal = self.gct
                if flags & 0x80:
                    nlct = 2 << (flags & 7)
                    pal = np.frombuffer(
                        buf[pos:pos + 3 * nlct], np.uint8).reshape(-1, 3)
                    pos += 3 * nlct
                if pal is None:
                    raise InvalidData("gif: no palette")
                min_code = buf[pos]
                pos += 1
                lzw, pos = _subblocks(buf, pos)
                idx = lzw_decode(lzw, min_code, iw * ih).reshape(ih, iw)
                if flags & 0x40:       # interlaced
                    de = np.empty_like(idx)
                    src = 0
                    for start, step in _DEINTERLACE_PASSES:
                        rows = range(start, ih, step)
                        de[list(rows)] = idx[src:src + len(rows)]
                        src += len(rows)
                    idx = de
                return self._compose(idx, pal, ix, iy, transparent,
                                     disposal, pkt)
            elif b == 0x3B:            # trailer
                break
            else:
                pos += 1
        raise InvalidData("gif: no image in packet")

    def _compose(self, idx, pal, ix, iy, transparent, disposal, pkt):
        if self.canvas is None:
            if not self.w:
                self.w, self.h = idx.shape[1], idx.shape[0]
            self.canvas = np.zeros((self.h, self.w, 4), np.uint8)
        prev = self.canvas.copy() if disposal == 3 else None
        rgba = np.empty((idx.shape[0], idx.shape[1], 4), np.uint8)
        safe = np.minimum(idx, len(pal) - 1)
        rgba[..., :3] = pal[safe]
        rgba[..., 3] = 255
        region = self.canvas[iy:iy + idx.shape[0], ix:ix + idx.shape[1]]
        if transparent >= 0:
            opaque = idx != transparent
            region[opaque] = rgba[opaque]
        else:
            region[:] = rgba
        shown = self.canvas.copy()
        if disposal == 2:              # restore to background (transparent)
            self.canvas[iy:iy + idx.shape[0], ix:ix + idx.shape[1]] = 0
        elif disposal == 3 and prev is not None:
            self.canvas = prev
        planes = upload_rgba(shown, self.device)
        f = Frame.video(self.w, self.h, "rgba", planes=planes,
                        pts=pkt.pts, time_base=pkt.time_base
                        or Rational(1, 100))
        f.duration = pkt.duration
        f.key_frame = True
        return f


# ---------------------------------------------------------------------------

_ENC_PALETTE = None


def _web_palette() -> np.ndarray:
    """Fixed 6·7·6 = 252-level RGB palette (+4 grays). The reference's gif
    encoder takes pal8 from paletteuse; a fixed cube keeps the encoder
    stateless and vectorizable."""
    global _ENC_PALETTE
    if _ENC_PALETTE is None:
        r = np.linspace(0, 255, 6).round()
        g = np.linspace(0, 255, 7).round()
        b = np.linspace(0, 255, 6).round()
        rr, gg, bb = np.meshgrid(r, g, b, indexing="ij")
        pal = np.stack([rr.ravel(), gg.ravel(), bb.ravel()], -1)
        grays = np.array([[24, 24, 24], [90, 90, 90],
                          [160, 160, 160], [220, 220, 220]])
        _ENC_PALETTE = np.concatenate([pal, grays]).astype(np.uint8)
    return _ENC_PALETTE


def _quantize(rgb: np.ndarray) -> np.ndarray:
    r = np.clip((rgb[..., 0].astype(np.int32) * 5 + 127) // 255, 0, 5)
    g = np.clip((rgb[..., 1].astype(np.int32) * 6 + 127) // 255, 0, 6)
    b = np.clip((rgb[..., 2].astype(np.int32) * 5 + 127) // 255, 0, 5)
    return (r * 42 + g * 6 + b).astype(np.uint8)


@register_encoder
class GifEncoder(DeviceCodec):
    """rgb24 in → one GIF image packet out (GCE + descriptor + LZW). The
    muxer adds the header/screen descriptor/loop extension."""

    codec_id = "gif"
    is_encoder = True
    pix_fmts = ("rgb24", "rgba")

    @property
    def palette(self) -> np.ndarray:
        return _web_palette()

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        if frame.format not in ("rgb24", "rgba"):
            raise InvalidData(f"gif enc: pix_fmt {frame.format} "
                              "(use format filter)")
        rgb = host_array(torch.stack(
            [torch.as_tensor(p) for p in frame.planes[:3]], -1))
        idx = _quantize(rgb)
        h, w = idx.shape
        out = bytearray()
        # GCE: delay in 1/100s
        delay = 0
        if frame.duration and frame.time_base:
            delay = int(frame.duration * 100 * frame.time_base.num
                        / frame.time_base.den)
        out += struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0x04, delay, 0, 0)
        out += struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0)
        out.append(8)                   # min code size
        lzw = lzw_encode(idx.ravel(), 8)
        for i in range(0, len(lzw), 255):
            chunk = lzw[i:i + 255]
            out.append(len(chunk))
            out += chunk
        out.append(0)
        return [Packet(data=bytes(out), pts=frame.pts, dts=frame.pts,
                       duration=frame.duration or 0, flags=PKT_FLAG_KEY,
                       time_base=frame.time_base)]
