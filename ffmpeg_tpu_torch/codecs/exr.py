"""OpenEXR decoder (reference: libavcodec/exr.c).

Scanline OpenEXR: header attribute parsing (channel list, data/display
windows, compression, line order), NONE/RLE/ZIPS/ZIP compression with
the EXR delta-predictor + two-half interleave post-transform, half and
float channels, R/G/B/A and luminance images. Output is planar float32
(gbrpf32le / gbrapf32le / grayf32le), matching the reference's default
float path. Tiled images, PIZ/PXR24/B44/DWA compressions and deep data
raise NotSupported (decoded by the reference via the same error paths
when the build lacks them).

The port's copy of ffmpeg_tpu/codecs/exr.py, held equal to it by
tests/test_torch_image_codecs.py.
The float32 planes go to the device the decoder is opened on in one
upload (device_planes), bit for bit.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.frame import Frame, device_planes
from ..core.packet import Packet
from ..io.stream import MediaType
from ..utils.error import InvalidData, NotSupported
from .codec import DeviceCodec, register_decoder

EXR_MAGIC = 0x01312F76

_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP, _COMP_PIZ = 0, 1, 2, 3, 4
_LINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_RLE: 1, _COMP_ZIPS: 1,
                    _COMP_ZIP: 16}
_PXTYPE_UINT, _PXTYPE_HALF, _PXTYPE_FLOAT = 0, 1, 2
_PXSIZE = {_PXTYPE_UINT: 4, _PXTYPE_HALF: 2, _PXTYPE_FLOAT: 4}


def _read_cstr(data: bytes, pos: int) -> Tuple[str, int]:
    end = data.find(b"\x00", pos)
    if end < 0 or end - pos > 255:
        raise InvalidData("exr: unterminated string")
    return data[pos:end].decode("latin-1"), end + 1


def _rle_decompress(src: bytes, out_size: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < out_size:
        c = src[i]
        i += 1
        if c > 127:                         # literal run of (256 - c)
            run = 256 - c
            out += src[i:i + run]
            i += run
        else:                               # repeat next byte c+1 times
            if i >= n:
                raise InvalidData("exr: truncated rle")
            out += bytes([src[i]]) * (c + 1)
            i += 1
    if len(out) != out_size:
        raise InvalidData("exr: rle size mismatch")
    return bytes(out)


def _postprocess(data: bytes) -> bytes:
    """Undo EXR's delta predictor then the two-half interleave."""
    buf = np.frombuffer(data, np.uint8).astype(np.int64)
    if not len(buf):
        return b""
    # predictor: out[i] = out[i-1] + raw[i] - 128 (mod 256)
    dec = (buf[0] + np.concatenate(
        ([0], np.cumsum(buf[1:] - 128)))) % 256
    dec = dec.astype(np.uint8)
    # interleave: out[0::2] = first half, out[1::2] = second half
    n = len(dec)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = dec[:half]
    out[1::2] = dec[half:]
    return out.tobytes()


@register_decoder
class ExrDecoder(DeviceCodec):
    codec_id = "exr"
    codec_type = MediaType.VIDEO

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        data = bytes(pkt.data)
        if len(data) < 12 or struct.unpack("<I", data[:4])[0] != EXR_MAGIC:
            raise InvalidData("exr: bad magic")
        version = data[4]
        flags = data[5]
        if version != 2:
            raise InvalidData(f"exr: unsupported version {version}")
        if flags & 0x02:
            raise NotSupported("exr: tiled images")
        if flags & 0x18:
            raise NotSupported("exr: deep data / multipart")
        pos = 8
        channels: List[Tuple[str, int]] = []     # (name, pixel_type)
        compression = None
        dw = None
        line_order = 0
        while True:
            name, pos = _read_cstr(data, pos)
            if not name:
                break
            atype, pos = _read_cstr(data, pos)
            asize = struct.unpack_from("<i", data, pos)[0]
            pos += 4
            payload = data[pos:pos + asize]
            pos += asize
            if name == "channels" and atype == "chlist":
                p = 0
                while p < len(payload) and payload[p]:
                    cname, p = _read_cstr(payload, p)
                    ptype, = struct.unpack_from("<i", payload, p)
                    xs, ys = struct.unpack_from("<ii", payload, p + 8)
                    p += 16
                    if xs != 1 or ys != 1:
                        raise NotSupported("exr: subsampled channels")
                    channels.append((cname, ptype))
            elif name == "compression" and atype == "compression":
                compression = payload[0]
            elif name == "dataWindow" and atype == "box2i":
                dw = struct.unpack("<iiii", payload)
            elif name == "lineOrder" and atype == "lineOrder":
                line_order = payload[0]
        if compression is None or dw is None or not channels:
            raise InvalidData("exr: missing required attributes")
        if compression not in _LINES_PER_BLOCK:
            raise NotSupported(f"exr: compression {compression}")
        xmin, ymin, xmax, ymax = dw
        w, h = xmax - xmin + 1, ymax - ymin + 1
        if w <= 0 or h <= 0 or w > 1 << 16 or h > 1 << 16:
            raise InvalidData("exr: bad data window")

        lpb = _LINES_PER_BLOCK[compression]
        nblocks = (h + lpb - 1) // lpb
        offsets = struct.unpack_from(f"<{nblocks}Q", data, pos)
        # channels are stored sorted by name within each line
        order = sorted(range(len(channels)), key=lambda i: channels[i][0])
        line_bytes = sum(w * _PXSIZE[t] for _, t in channels)
        out_ch = {name: np.zeros((h, w), np.float32)
                  for name, _ in channels}

        for bi in range(nblocks):
            off = offsets[bi]
            y, size = struct.unpack_from("<ii", data, off)
            raw = data[off + 8:off + 8 + size]
            y0 = y - ymin
            nlines = min(lpb, h - y0)
            want = line_bytes * nlines
            if compression == _COMP_NONE or size == want:
                block = raw[:want]
            elif compression == _COMP_RLE:
                block = _postprocess(_rle_decompress(raw, want))
            else:                            # ZIPS / ZIP
                try:
                    block = _postprocess(zlib.decompress(raw))
                except zlib.error as e:
                    raise InvalidData(f"exr: zip error: {e}") from e
            if len(block) != want:
                raise InvalidData("exr: block size mismatch")
            p = 0
            # lineOrder only affects the order blocks appear in the file;
            # each block header stores its real y, so placement is the same
            # for INCREASING_Y and DECREASING_Y (exr.c decode_block()).
            for li in range(nlines):
                yy = y0 + li
                for ci in order:
                    cname, ptype = channels[ci]
                    nb = w * _PXSIZE[ptype]
                    seg = block[p:p + nb]
                    p += nb
                    if ptype == _PXTYPE_HALF:
                        vals = np.frombuffer(seg, "<f2").astype(np.float32)
                    elif ptype == _PXTYPE_FLOAT:
                        vals = np.frombuffer(seg, "<f4").astype(np.float32)
                    else:                    # uint32 → scaled float
                        vals = np.frombuffer(seg, "<u4").astype(np.float32)
                    out_ch[cname][yy] = vals

        names = {n for n, _ in channels}
        if {"R", "G", "B"} <= names:
            planes = [out_ch["R"], out_ch["G"], out_ch["B"]]
            fmt = "gbrpf32le"
            if "A" in names:
                planes.append(out_ch["A"])
                fmt = "gbrapf32le"
        elif "Y" in names:
            planes = [out_ch["Y"]]
            fmt = "grayf32le"
        else:                                # arbitrary first channel
            planes = [out_ch[channels[0][0]]]
            fmt = "grayf32le"
        f = Frame.video(w, h, fmt, planes=device_planes(planes, self.device))
        f.pts = pkt.pts
        f.time_base = pkt.time_base
        f.side_data["key_frame"] = True
        return [f]
