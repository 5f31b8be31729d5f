"""TIFF image decoder + encoder (reference: libavcodec/tiff.c,
tiffenc.c; baseline TIFF 6.0).

Decoder scope mirrors what the reference's own encoder and common
baseline files produce: strip-based images, little/big-endian headers,
raw / PackBits / LZW / Deflate compression, horizontal predictor,
gray (both polarities, 1/8/16 bit), RGB(A) 8/16 bit, palette, and the
reference's interleaved-subsampled YCbCr layout (tiffenc.c pack_yuv).
Tiles and planar configuration 2 are not supported (rare; the
reference encoder never emits them).

The port's copy of ffmpeg_tpu/codecs/tiff.py, held equal to it by
tests/test_torch_image_codecs.py.
The decoder puts each picture on the device it is opened on with one
upload (device_planes); the encoder copies a frame's planes to the
host once (host_array).
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional

import numpy as np

from ..core.frame import Frame, device_planes, host_array
from ..core.packet import Packet, PKT_FLAG_KEY
from ..io.stream import MediaType
from ..utils.error import InvalidData, NotSupported
from .codec import DeviceCodec, register_decoder, register_encoder

TAG_WIDTH = 256
TAG_HEIGHT = 257
TAG_BPS = 258
TAG_COMPR = 259
TAG_PHOTOMETRIC = 262
TAG_STRIP_OFFS = 273
TAG_SPP = 277
TAG_ROWSPERSTRIP = 278
TAG_STRIP_SIZES = 279
TAG_PLANAR = 284
TAG_PREDICTOR = 317
TAG_PALETTE = 320
TAG_TILE_W = 322
TAG_SUBSAMPLING = 530

COMPR_RAW = 1
COMPR_LZW = 5
COMPR_DEFLATE = 8
COMPR_ADOBE_DEFLATE = 32946
COMPR_PACKBITS = 32773

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
              10: 8, 11: 4, 12: 8}


def _unpackbits(src: bytes, want: int) -> bytes:
    """PackBits RLE (TIFF 6.0 §9; reference tiff.c
    tiff_unpack_strip PACKBITS branch)."""
    out = bytearray()
    i = 0
    n = len(src)
    while i < n and len(out) < want:
        code = src[i]
        i += 1
        if code < 128:
            out += src[i:i + code + 1]
            i += code + 1
        elif code > 128:
            if i < n:
                out += bytes([src[i]]) * (257 - code)
                i += 1
        # 128 = nop
    return bytes(out[:want])


def _lzw_decode(src: bytes, want: int) -> bytes:
    """TIFF-variant LZW: MSB-first codes, Clear=256, EOI=257, and the
    'early change' width bump (reference libavcodec/lzw.c, FF_LZW_TIFF
    mode)."""
    out = bytearray()
    acc = 0
    nbits = 0
    pos = 0
    code_size = 9
    prefix: list = []
    dic = {i: bytes([i]) for i in range(256)}
    next_code = 258
    prev = None
    n = len(src)
    while len(out) < want:
        while nbits < code_size:
            if pos >= n:
                return bytes(out[:want])
            acc = (acc << 8) | src[pos]
            pos += 1
            nbits += 8
        code = (acc >> (nbits - code_size)) & ((1 << code_size) - 1)
        nbits -= code_size
        if code == 256:                       # Clear
            dic = {i: bytes([i]) for i in range(256)}
            next_code = 258
            code_size = 9
            prev = None
            continue
        if code == 257:                       # EOI
            break
        if prev is None:
            entry = dic[code]
        elif code in dic:
            entry = dic[code]
            dic[next_code] = prev + entry[:1]
            next_code += 1
        elif code == next_code:
            entry = prev + prev[:1]
            dic[next_code] = entry
            next_code += 1
        else:
            raise InvalidData("tiff: bad LZW code")
        out += entry
        prev = entry
        # TIFF early change: grow one code before the table fills
        if next_code == (1 << code_size) - 1 and code_size < 12:
            code_size += 1
    return bytes(out[:want])


@register_decoder
class TiffDecoder(DeviceCodec):
    codec_id = "tiff"
    codec_type = MediaType.VIDEO

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        d = bytes(pkt.data)
        if d[:2] == b"II":
            le = True
        elif d[:2] == b"MM":
            le = False
        else:
            raise InvalidData("tiff: bad byte order mark")
        e = "<" if le else ">"
        magic, ifd_off = struct.unpack(e + "HI", d[2:8])
        if magic != 42:
            raise InvalidData("tiff: bad magic")
        tags = self._read_ifd(d, e, ifd_off)
        if TAG_TILE_W in tags:
            raise NotSupported("tiff: tiled images")
        w = tags[TAG_WIDTH][0]
        h = tags[TAG_HEIGHT][0]
        # sanity bounds (tiff.c checks the same before allocating):
        # corrupted dimension/count fields must not drive allocations
        if not (0 < w <= 1 << 16 and 0 < h <= 1 << 16
                and w * h <= 1 << 26):
            raise InvalidData(f"tiff: unreasonable dimensions {w}x{h}")
        bps = tags.get(TAG_BPS, [8])
        spp = tags.get(TAG_SPP, [1])[0]
        if not 1 <= spp <= 4:
            raise InvalidData(f"tiff: bad samples per pixel {spp}")
        compr = tags.get(TAG_COMPR, [COMPR_RAW])[0]
        photo = tags.get(TAG_PHOTOMETRIC, [1])[0]
        rps = tags.get(TAG_ROWSPERSTRIP, [h])[0] or h
        offs = tags[TAG_STRIP_OFFS]
        sizes = tags[TAG_STRIP_SIZES]
        predictor = tags.get(TAG_PREDICTOR, [1])[0]
        planar = tags.get(TAG_PLANAR, [1])[0]
        if planar != 1:
            raise NotSupported("tiff: planar configuration")
        bits = bps[0]
        if any(b != bits for b in bps):
            raise NotSupported("tiff: mixed bits per sample")
        if bits not in (1, 4, 8, 16):
            raise InvalidData(f"tiff: bad bits per sample {bits}")
        sub = tags.get(TAG_SUBSAMPLING, [2, 2]) if photo == 6 else None
        if photo == 6:
            row_bytes = self._yuv_group_bytes(w, sub)
            group_rows = sub[1]
        else:
            row_bytes = (w * spp * bits + 7) // 8
            group_rows = 1
        rows = []
        for i, (o, sz) in enumerate(zip(offs, sizes)):
            nrows = min(rps, h - i * rps)
            ngroups = (nrows + group_rows - 1) // group_rows
            want = row_bytes * ngroups
            chunk = d[o:o + sz]
            if compr == COMPR_RAW:
                raw = chunk[:want]
            elif compr == COMPR_PACKBITS:
                raw = _unpackbits(chunk, want)
            elif compr == COMPR_LZW:
                raw = _lzw_decode(chunk, want)
            elif compr in (COMPR_DEFLATE, COMPR_ADOBE_DEFLATE):
                raw = zlib.decompress(chunk)[:want]
            else:
                raise NotSupported(f"tiff: compression {compr}")
            if len(raw) < want:
                raw += b"\x00" * (want - len(raw))
            rows.append(raw)
        data = b"".join(rows)
        if photo == 6:
            return [self._emit_yuv(pkt, data, w, h, sub)]
        arr = np.frombuffer(data, np.uint8,
                            count=row_bytes * h).reshape(h, row_bytes)
        if predictor == 2:
            arr = self._predict(arr, w, spp, bits)
        return [self._emit(pkt, arr, w, h, spp, bits, photo, tags, e)]

    @staticmethod
    def _read_ifd(d, e, off):
        count = struct.unpack_from(e + "H", d, off)[0]
        tags = {}
        for i in range(count):
            tag, typ, n = struct.unpack_from(e + "HHI", d,
                                             off + 2 + 12 * i)
            if n > len(d):             # value count beyond the file
                raise InvalidData("tiff: tag count out of range")
            vsz = _TYPE_SIZE.get(typ, 1) * n
            voff = off + 2 + 12 * i + 8
            if vsz > 4:
                voff = struct.unpack_from(e + "I", d, voff)[0]
            if typ == 3:
                vals = list(struct.unpack_from(e + f"{n}H", d, voff))
            elif typ == 4:
                vals = list(struct.unpack_from(e + f"{n}I", d, voff))
            elif typ in (1, 2, 6, 7):
                vals = list(d[voff:voff + n])
            else:
                vals = [0]
            tags[tag] = vals
        return tags

    @staticmethod
    def _predict(arr, w, spp, bits):
        if bits == 8:
            px = arr[:, :w * spp].reshape(arr.shape[0], w, spp)
            px = np.cumsum(px.astype(np.int64), axis=1).astype(
                np.uint8).reshape(arr.shape[0], -1)
            return np.ascontiguousarray(px)
        if bits == 16:
            px = arr[:, :w * spp * 2].view(np.uint16).reshape(
                arr.shape[0], w, spp)
            px = np.cumsum(px.astype(np.int64), axis=1).astype(
                np.uint16)
            return np.ascontiguousarray(
                px.reshape(arr.shape[0], -1).view(np.uint8))
        raise NotSupported("tiff: predictor bit depth")

    @staticmethod
    def _yuv_group_bytes(w, sub):
        wb = (w + sub[0] - 1) // sub[0]
        return wb * (sub[0] * sub[1] + 2)

    def _emit_yuv(self, pkt, data, w, h, sub):
        """Reference tiffenc.c pack_yuv layout: per row group, per
        horizontal block — sub[0]*sub[1] luma samples then Cb, Cr."""
        s0, s1 = sub
        fmt = {(2, 2): "yuv420p", (2, 1): "yuv422p", (1, 1): "yuv444p",
               (4, 4): "yuv410p", (4, 1): "yuv411p",
               (1, 2): "yuv440p"}.get((s0, s1))
        if fmt is None:
            raise NotSupported("tiff: yuv subsampling")
        wb = (w + s0 - 1) // s0
        hb = (h + s1 - 1) // s1
        gsz = wb * (s0 * s1 + 2)
        arr = np.frombuffer(data, np.uint8, count=gsz * hb).reshape(
            hb, wb, s0 * s1 + 2)
        y = arr[:, :, :s0 * s1].reshape(hb, wb, s1, s0)
        y = y.transpose(0, 2, 1, 3).reshape(hb * s1, wb * s0)[:h, :w]
        u = arr[:, :, s0 * s1]
        v = arr[:, :, s0 * s1 + 1]
        planes = [np.ascontiguousarray(y), np.ascontiguousarray(u),
                  np.ascontiguousarray(v)]
        return Frame.video(w, h, fmt,
                           planes=device_planes(planes, self.device),
                           pts=pkt.pts, time_base=pkt.time_base)

    def _emit(self, pkt, arr, w, h, spp, bits, photo, tags, e):
        if photo in (0, 1):
            if bits == 1:
                # photometric 0 = WhiteIsZero; deliver as gray
                unpacked = np.unpackbits(arr, axis=1)[:, :w]
                g = unpacked if photo == 1 else 1 - unpacked
                planes = [np.ascontiguousarray(
                    (g * 255).astype(np.uint8))]
                return Frame.video(w, h, "gray",
                                   planes=device_planes(planes, self.device),
                                   pts=pkt.pts,
                                   time_base=pkt.time_base)
            if bits == 8 and spp == 1:
                g = arr[:, :w]
                if photo == 0:
                    g = 255 - g
                return Frame.video(w, h, "gray", planes=device_planes(
                                   [np.ascontiguousarray(g)], self.device),
                                   pts=pkt.pts,
                                   time_base=pkt.time_base)
            if bits == 8 and spp == 2:
                px = arr[:, :w * 2].reshape(h, w, 2)
                return Frame.video(
                    w, h, "ya8",
                    planes=device_planes(
                        [np.ascontiguousarray(px[:, :, 0]),
                         np.ascontiguousarray(px[:, :, 1])], self.device),
                    pts=pkt.pts, time_base=pkt.time_base)
            if bits == 16 and spp == 1:
                g = arr[:, :w * 2].view("<u2" if e == "<" else ">u2")
                g = g[:, :w].astype("<u2")
                if photo == 0:
                    g = (65535 - g).astype("<u2")
                return Frame.video(w, h, "gray16le", planes=device_planes(
                                   [np.ascontiguousarray(g)], self.device),
                                   pts=pkt.pts,
                                   time_base=pkt.time_base)
        if photo == 2:
            if bits == 8 and spp in (3, 4):
                px = arr[:, :w * spp].reshape(h, w, spp)
                planes = [np.ascontiguousarray(px[:, :, i])
                          for i in range(spp)]
                fmt = "rgb24" if spp == 3 else "rgba"
                return Frame.video(w, h, fmt,
                                   planes=device_planes(planes, self.device),
                                   pts=pkt.pts,
                                   time_base=pkt.time_base)
            if bits == 16 and spp in (3, 4):
                px = arr[:, :w * spp * 2].view(
                    "<u2" if e == "<" else ">u2")
                px = px[:, :w * spp].astype("<u2").reshape(h, w, spp)
                planes = [np.ascontiguousarray(px[:, :, i])
                          for i in range(spp)]
                fmt = "rgb48le" if spp == 3 else "rgba64le"
                return Frame.video(w, h, fmt,
                                   planes=device_planes(planes, self.device),
                                   pts=pkt.pts,
                                   time_base=pkt.time_base)
        if photo == 3 and bits == 8:
            pal = tags.get(TAG_PALETTE)
            if pal is None:
                raise InvalidData("tiff: missing palette")
            npal = len(pal) // 3
            pal = np.array(pal, np.uint16).reshape(3, npal) >> 8
            idx = arr[:, :w]
            planes = [np.ascontiguousarray(
                pal[i][idx].astype(np.uint8)) for i in range(3)]
            return Frame.video(w, h, "rgb24",
                               planes=device_planes(planes, self.device),
                               pts=pkt.pts, time_base=pkt.time_base)
        raise NotSupported(
            f"tiff: photometric {photo} / {bits}bit / {spp}spp")


def _packbits(row: bytes) -> bytes:
    """PackBits RLE encoder (ff_rle_encode analog: runs >= 3 become
    replicate packets)."""
    out = bytearray()
    i = 0
    n = len(row)
    while i < n:
        run = 1
        while i + run < n and run < 128 and row[i + run] == row[i]:
            run += 1
        if run >= 3:
            out.append(257 - run)
            out.append(row[i])
            i += run
            continue
        lit = i
        cnt = 0
        while i < n and cnt < 128:
            run = 1
            while i + run < n and run < 3 and row[i + run] == row[i]:
                run += 1
            if run >= 3:
                break
            i += 1
            cnt += 1
        out.append(cnt - 1)
        out += row[lit:lit + cnt]
    return bytes(out)


@register_encoder
class TiffEncoder(DeviceCodec):
    """Minimal baseline writer (little-endian, one strip per 8 KB
    like the reference default, PackBits or raw)."""

    codec_id = "tiff"
    codec_type = MediaType.VIDEO
    is_encoder = True

    def __init__(self, par, options=None, *, device="cuda"):
        super().__init__(par, options, device=device)
        self.compr = (options or {}).get("compression_algo",
                                         "packbits")

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        if frame.format == "rgb24":
            spp, photo = 3, 2
            px = np.stack([host_array(p) for p in frame.planes], -1)
        elif frame.format in ("gray", "gray8"):
            spp, photo = 1, 1
            px = host_array(frame.planes[0])[:, :, None]
        elif frame.format == "rgba":
            spp, photo = 4, 2
            px = np.stack([host_array(p) for p in frame.planes], -1)
        else:
            raise NotSupported("tiff enc: rgb24/rgba/gray only")
        w, h = frame.width, frame.height
        rows = px.reshape(h, w * spp).astype(np.uint8)
        rps = max(8192 // (w * spp + 1), 1)
        strips = []
        compr_id = {"raw": COMPR_RAW, "packbits": COMPR_PACKBITS,
                    "deflate": COMPR_DEFLATE}[self.compr]
        for y0 in range(0, h, rps):
            block = rows[y0:y0 + rps]
            if compr_id == COMPR_RAW:
                strips.append(block.tobytes())
            elif compr_id == COMPR_DEFLATE:
                strips.append(zlib.compress(block.tobytes()))
            else:
                # the reference decoder unpacks per row; packets must
                # not cross row boundaries (tiff.c:936)
                strips.append(b"".join(_packbits(r.tobytes())
                                       for r in block))
        nstrips = len(strips)
        # layout: header(8) + data strips + IFD
        body = bytearray(b"II*\x00\x00\x00\x00\x00")
        offsets = []
        for s in strips:
            offsets.append(len(body))
            body += s
        if len(body) & 1:
            body += b"\x00"
        ifd_off = len(body)
        struct.pack_into("<I", body, 4, ifd_off)
        entries = []

        def entry(tag, typ, vals):
            entries.append((tag, typ, vals))

        entry(TAG_WIDTH, 4, [w])
        entry(TAG_HEIGHT, 4, [h])
        entry(TAG_BPS, 3, [8] * spp)
        entry(TAG_COMPR, 3, [compr_id])
        entry(TAG_PHOTOMETRIC, 3, [photo])
        entry(TAG_STRIP_OFFS, 4, offsets)
        entry(TAG_SPP, 3, [spp])
        entry(TAG_ROWSPERSTRIP, 4, [rps])
        entry(TAG_STRIP_SIZES, 4, [len(s) for s in strips])
        entries.sort()
        extra = bytearray()
        extra_base = ifd_off + 2 + 12 * len(entries) + 4
        ifd = bytearray(struct.pack("<H", len(entries)))
        for tag, typ, vals in entries:
            sz = _TYPE_SIZE[typ] * len(vals)
            fmtc = {3: "H", 4: "I"}[typ]
            packed = struct.pack(f"<{len(vals)}{fmtc}", *vals)
            if sz <= 4:
                packed = packed + b"\x00" * (4 - sz)
                ifd += struct.pack("<HHI", tag, typ, len(vals)) + packed
            else:
                ifd += struct.pack("<HHII", tag, typ, len(vals),
                                   extra_base + len(extra))
                extra += packed
        ifd += struct.pack("<I", 0)     # next IFD
        data = bytes(body) + bytes(ifd) + bytes(extra)
        return [Packet(data=data, pts=frame.pts, dts=frame.pts,
                       flags=PKT_FLAG_KEY, time_base=frame.time_base)]
