"""Simple image codecs: PPM/PGM/PAM (pnm.c analogs), BMP (bmp.c), QOI —
host-only intra formats rounding out the image family.

The port's copy of ffmpeg_tpu/codecs/images.py, held equal to it by
tests/test_torch_image_codecs.py.
Each decoder puts its picture on the device it is opened on with one
upload (device_planes); each encoder copies a frame's planes to the
host once (host_array).
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from ..core.frame import Frame, device_planes, host_array
from ..core.packet import Packet, PKT_FLAG_KEY
from ..io.stream import MediaType
from ..utils.error import InvalidData, NotSupported
from .codec import DeviceCodec, register_decoder, register_encoder


def _pnm_header(data: bytes):
    parts = []
    i = 0
    while len(parts) < 4 and i < len(data):
        while i < len(data) and data[i] in b" \t\r\n":
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i] not in b"\r\n":
                i += 1
            continue
        j = i
        while j < len(data) and data[j] not in b" \t\r\n":
            j += 1
        parts.append(data[i:j])
        i = j
        if len(parts) == 1 and parts[0] in (b"P1", b"P4"):
            break
    return parts, i + 1


@register_decoder
class PnmDecoder(DeviceCodec):
    codec_id = "ppm"
    codec_type = MediaType.VIDEO
    aliases = ("pgm", "pnm", "pbm")

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        data = pkt.data
        magic = data[:2]
        parts, off = _pnm_header(data)
        if magic == b"P6":
            w, h, maxv = int(parts[1]), int(parts[2]), int(parts[3])
            if maxv > 255:
                arr = np.frombuffer(data, ">u2", count=w * h * 3, offset=off)
                rgb = arr.reshape(h, w, 3)
                fmt = "rgb48be"
                dt = np.uint16
            else:
                rgb = np.frombuffer(data, np.uint8, count=w * h * 3,
                                    offset=off).reshape(h, w, 3)
                fmt = "rgb24"
                dt = np.uint8
            planes = [np.ascontiguousarray(rgb[:, :, i]).astype(dt)
                      for i in range(3)]
            return [Frame.video(w, h, fmt,
                                planes=device_planes(planes, self.device),
                                pts=pkt.pts, time_base=pkt.time_base)]
        if magic == b"P5":
            w, h, maxv = int(parts[1]), int(parts[2]), int(parts[3])
            fmt = "gray16be" if maxv > 255 else "gray"
            dt = ">u2" if maxv > 255 else np.uint8
            g = np.frombuffer(data, dt, count=w * h, offset=off).reshape(h, w)
            return [Frame.video(w, h, fmt,
                                planes=device_planes([g.astype(
                                    np.uint16 if maxv > 255 else np.uint8)],
                                    self.device),
                                pts=pkt.pts, time_base=pkt.time_base)]
        raise NotSupported(f"pnm: magic {magic!r}")


@register_encoder
class PnmEncoder(DeviceCodec):
    codec_id = "ppm"
    codec_type = MediaType.VIDEO
    is_encoder = True

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        fmt = frame.format
        if fmt == "rgb24":
            hdr = f"P6\n{frame.width} {frame.height}\n255\n".encode()
            rgb = np.stack([host_array(p) for p in frame.planes], -1)
            data = hdr + rgb.tobytes()
        elif fmt == "gray":
            hdr = f"P5\n{frame.width} {frame.height}\n255\n".encode()
            data = hdr + host_array(frame.planes[0]).tobytes()
        else:
            raise NotSupported(f"pnm enc: {fmt}")
        return [Packet(data=data, pts=frame.pts, dts=frame.pts,
                       flags=PKT_FLAG_KEY, time_base=frame.time_base)]


@register_decoder
class BmpDecoder(DeviceCodec):
    codec_id = "bmp"
    codec_type = MediaType.VIDEO

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        d = pkt.data
        if d[:2] != b"BM":
            raise InvalidData("bmp: bad magic")
        data_off = struct.unpack("<I", d[10:14])[0]
        hsize = struct.unpack("<I", d[14:18])[0]
        if hsize >= 40:
            w, h = struct.unpack("<ii", d[18:26])
            bpp = struct.unpack("<H", d[28:30])[0]
            comp = struct.unpack("<I", d[30:34])[0]
        else:
            raise NotSupported("bmp: core header")
        if comp != 0:
            raise NotSupported(f"bmp: compression {comp}")
        flip = h > 0
        h = abs(h)
        stride = (w * bpp // 8 + 3) & ~3
        rows = np.frombuffer(d, np.uint8, count=stride * h,
                             offset=data_off).reshape(h, stride)
        if flip:
            rows = rows[::-1]
        if bpp == 24:
            px = rows[:, :w * 3].reshape(h, w, 3)
            planes = [np.ascontiguousarray(px[:, :, 2]),
                      np.ascontiguousarray(px[:, :, 1]),
                      np.ascontiguousarray(px[:, :, 0])]
            return [Frame.video(w, h, "rgb24",
                                planes=device_planes(planes, self.device),
                                pts=pkt.pts, time_base=pkt.time_base)]
        if bpp == 32:
            px = rows[:, :w * 4].reshape(h, w, 4)
            planes = [np.ascontiguousarray(px[:, :, 2]),
                      np.ascontiguousarray(px[:, :, 1]),
                      np.ascontiguousarray(px[:, :, 0]),
                      np.ascontiguousarray(px[:, :, 3])]
            return [Frame.video(w, h, "rgba",
                                planes=device_planes(planes, self.device),
                                pts=pkt.pts, time_base=pkt.time_base)]
        if bpp == 8:
            pal = np.frombuffer(d, np.uint8, count=1024, offset=14 + hsize)
            pal = pal.reshape(256, 4)
            idx = rows[:, :w]
            planes = [np.ascontiguousarray(pal[idx, 2]),
                      np.ascontiguousarray(pal[idx, 1]),
                      np.ascontiguousarray(pal[idx, 0])]
            return [Frame.video(w, h, "rgb24",
                                planes=device_planes(planes, self.device),
                                pts=pkt.pts, time_base=pkt.time_base)]
        raise NotSupported(f"bmp: {bpp} bpp")


@register_encoder
class BmpEncoder(DeviceCodec):
    codec_id = "bmp"
    codec_type = MediaType.VIDEO
    is_encoder = True

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        if frame.format != "rgb24":
            raise NotSupported("bmp enc: rgb24 only (use format filter)")
        w, h = frame.width, frame.height
        stride = (w * 3 + 3) & ~3
        rows = np.zeros((h, stride), np.uint8)
        px = np.stack([host_array(frame.planes[2]),
                       host_array(frame.planes[1]),
                       host_array(frame.planes[0])], -1)
        rows[:, :w * 3] = px.reshape(h, w * 3)
        body = rows[::-1].tobytes()
        hdr = b"BM" + struct.pack("<IHHI", 54 + len(body), 0, 0, 54)
        info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(body),
                           2835, 2835, 0, 0)
        return [Packet(data=hdr + info + body, pts=frame.pts, dts=frame.pts,
                       flags=PKT_FLAG_KEY, time_base=frame.time_base)]


def _qoi_hash(r, g, b, a):
    return (r * 3 + g * 5 + b * 7 + a * 11) & 63


@register_decoder
class QoiDecoder(DeviceCodec):
    """QOI image (reference: libavcodec/qoidec.c; format spec is
    public domain — qoiformat.org)."""

    codec_id = "qoi"
    codec_type = MediaType.VIDEO

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        d = bytes(pkt.data)
        if len(d) < 20 or d[:4] != b"qoif":
            raise InvalidData("qoi: bad header")
        w, h = struct.unpack(">II", d[4:12])
        channels = d[12]
        if d[13] > 1:
            raise InvalidData("qoi: bad colorspace")
        if channels not in (3, 4):
            raise InvalidData("qoi: bad channel count")
        total = w * h
        # Every payload byte yields at most 62 pixels (QOI_OP_RUN), so a
        # header whose w*h can't be covered by the remaining bytes is
        # corrupt — reject instead of looping over phantom pixels.
        if total > max(0, len(d) - 14) * 62:
            raise InvalidData("qoi: dimensions exceed payload capacity")
        index = [(0, 0, 0, 0)] * 64
        r = g = b = 0
        a = 255
        pos = 14
        n = 0
        # chunk-level loop (cost bounded by input bytes, not w*h); runs
        # are expanded afterwards with np.repeat
        pixels: list = []
        counts: list = []
        while n < total and len(d) - pos > 4:
            chunk = d[pos]
            pos += 1
            cnt = 1
            if chunk == 0xFE:                   # QOI_OP_RGB
                r, g, b = d[pos], d[pos + 1], d[pos + 2]
                pos += 3
            elif chunk == 0xFF:                 # QOI_OP_RGBA
                r, g, b, a = d[pos], d[pos + 1], d[pos + 2], d[pos + 3]
                pos += 4
            elif chunk & 0xC0 == 0x00:          # QOI_OP_INDEX
                r, g, b, a = index[chunk]
            elif chunk & 0xC0 == 0x40:          # QOI_OP_DIFF
                r = (r + ((chunk >> 4) & 3) - 2) & 255
                g = (g + ((chunk >> 2) & 3) - 2) & 255
                b = (b + (chunk & 3) - 2) & 255
            elif chunk & 0xC0 == 0x80:          # QOI_OP_LUMA
                b2 = d[pos]
                pos += 1
                vg = (chunk & 0x3F) - 32
                r = (r + vg - 8 + ((b2 >> 4) & 0x0F)) & 255
                g = (g + vg) & 255
                b = (b + vg - 8 + (b2 & 0x0F)) & 255
            else:                               # QOI_OP_RUN
                cnt = (chunk & 0x3F) + 1
            index[_qoi_hash(r, g, b, a)] = (r, g, b, a)
            cnt = min(cnt, total - n)
            pixels.append((r, g, b, a))
            counts.append(cnt)
            n += cnt
        px4 = np.repeat(np.asarray(pixels, np.uint8).reshape(-1, 4),
                        np.asarray(counts, np.int64), axis=0) \
            if pixels else np.zeros((0, 4), np.uint8)
        out = np.zeros((total, channels), np.uint8)
        out[:len(px4)] = px4[:, :channels]
        px = out.reshape(h, w, channels)
        planes = [np.ascontiguousarray(px[:, :, i])
                  for i in range(channels)]
        fmt = "rgb24" if channels == 3 else "rgba"
        return [Frame.video(w, h, fmt,
                            planes=device_planes(planes, self.device),
                            pts=pkt.pts, time_base=pkt.time_base)]


@register_encoder
class QoiEncoder(DeviceCodec):
    """QOI encoder (reference: libavcodec/qoienc.c op-choice order,
    so output is byte-identical)."""

    codec_id = "qoi"
    codec_type = MediaType.VIDEO
    is_encoder = True

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        if frame.format not in ("rgb24", "rgba"):
            raise NotSupported("qoi enc: rgb24/rgba only")
        channels = 3 if frame.format == "rgb24" else 4
        w, h = frame.width, frame.height
        px = np.stack([host_array(p) for p in frame.planes],
                      -1).reshape(-1, channels)
        if channels == 3:
            px = np.concatenate(
                [px, np.full((px.shape[0], 1), 255, np.uint8)], 1)
        out = bytearray(b"qoif" + struct.pack(">II", w, h) +
                        bytes([channels, 0]))
        index = [(0, 0, 0, 0)] * 64
        prev = (0, 0, 0, 255)
        run = 0
        for row in px:
            cur = (int(row[0]), int(row[1]), int(row[2]), int(row[3]))
            if cur == prev:
                run += 1
                if run == 62:
                    out.append(0xC0 | (run - 1))
                    run = 0
                continue
            if run > 0:
                out.append(0xC0 | (run - 1))
                run = 0
            ipos = _qoi_hash(*cur)
            if index[ipos] == cur:
                out.append(ipos)
            else:
                index[ipos] = cur
                if cur[3] == prev[3]:
                    vr = (cur[0] - prev[0] + 128) % 256 - 128
                    vg = (cur[1] - prev[1] + 128) % 256 - 128
                    vb = (cur[2] - prev[2] + 128) % 256 - 128
                    vg_r = (vr - vg + 128) % 256 - 128
                    vg_b = (vb - vg + 128) % 256 - 128
                    if -3 < vr < 2 and -3 < vg < 2 and -3 < vb < 2:
                        out.append(0x40 | (vr + 2) << 4 |
                                   (vg + 2) << 2 | (vb + 2))
                    elif -9 < vg_r < 8 and -33 < vg < 32 and \
                            -9 < vg_b < 8:
                        out.append(0x80 | (vg + 32))
                        out.append((vg_r + 8) << 4 | (vg_b + 8))
                    else:
                        out += bytes((0xFE, cur[0], cur[1], cur[2]))
                else:
                    out += bytes((0xFF,) + cur)
            prev = cur
        if run:
            out.append(0xC0 | (run - 1))
        out += (1).to_bytes(8, "big")
        return [Packet(data=bytes(out), pts=frame.pts, dts=frame.pts,
                       flags=PKT_FLAG_KEY, time_base=frame.time_base)]
