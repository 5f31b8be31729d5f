"""Apple ProRes decoder (counterpart of ffmpeg_tpu/codecs/prores.py;
reference: libavcodec/proresdec.c).

Split between the host and the decoder's device:
  * host, copied from the reference: the frame and picture headers, the
    slice index walk and the adaptive Rice/Exp-Golomb entropy decode
    (`_Bits`, `_codeword`, `_decode_dc`, `_decode_ac`), producing one
    coefficient buffer per plane for the whole picture and one qscale
    per block;
  * device (the `device` the decoder is opened on), in PyTorch: the
    dequantise (a float32 product, as the reference computes it), the
    float32 `idct8x8` (ops/idct.py, full float32, TF32 refused), the
    scale and offset, round half to even and clip, and the placement of
    the blocks into the planes: one pass per plane per picture.

The reference runs its dequantise + IDCT three times per slice, each a
host → device → host round trip (1 020 slices of a 1080p picture); the
port parses every slice first and copies each plane's coefficients up
once.  Planes above 8 bits are int16 tensors on the device (torch has
no general uint16); `Frame.numpy()` gives uint16.

`stats`, when a list, gets one dict per picture: host parse and queue
ms, the h2d bytes, and the device stages (h2d, transform; CUDA events
on a card).  `last_parsed` keeps the picture's parse (`_Parsed`), so
that `reconstruct` can run the same device stage elsewhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..core.frame import Frame
from ..core.packet import Packet
from ..io.stream import MediaType
from ..ops.idct import idct8x8
from ..utils.error import InvalidData, NotSupported
from ..utils.rational import Rational
from .codec import Codec, register_decoder
from .vp9.recon_tpu import _Timer

# ITU-like interleaved progressive scan (proresdata.c)
PROGRESSIVE_SCAN = np.array([
    0, 1, 8, 9, 2, 3, 10, 11, 16, 17, 24, 25, 18, 19, 26, 27,
    4, 5, 12, 20, 13, 6, 7, 14, 21, 28, 29, 22, 15, 23, 30, 31,
    32, 33, 40, 48, 41, 34, 35, 42, 49, 56, 57, 50, 43, 36, 37, 44,
    51, 58, 59, 52, 45, 38, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

_FIRST_DC_CB = 0xB8
_DC_CB = [0x04, 0x28, 0x28, 0x4D, 0x4D, 0x70, 0x70]
_RUN_CB = [0x06, 0x06, 0x05, 0x05, 0x04, 0x29, 0x29, 0x29, 0x29, 0x28,
           0x28, 0x28, 0x28, 0x28, 0x28, 0x4C]
_LEV_CB = [0x04, 0x0A, 0x05, 0x06, 0x04, 0x28, 0x28, 0x28, 0x28, 0x4C]


class _Bits:
    __slots__ = ("d", "pos", "n")

    def __init__(self, data: bytes):
        self.d = data + b"\x00" * 8
        self.pos = 0
        self.n = len(data) * 8

    def peek32(self) -> int:
        p = self.pos
        first = p >> 3
        v = int.from_bytes(self.d[first:first + 5], "big")
        return (v >> (8 - (p & 7))) & 0xFFFFFFFF

    def get(self, nbits: int) -> int:
        p = self.pos
        self.pos = p + nbits
        if nbits == 0:
            return 0
        first = p >> 3
        end = p + nbits
        last = (end + 7) >> 3
        v = int.from_bytes(self.d[first:last], "big")
        return (v >> ((last << 3) - end)) & ((1 << nbits) - 1)


def _codeword(b: _Bits, codebook: int) -> int:
    """Adaptive Rice / Exp-Golomb hybrid (proresdec.c DECODE_CODEWORD)."""
    buf = b.peek32()
    switch_bits = codebook & 3
    rice_order = codebook >> 5
    exp_order = (codebook >> 2) & 7
    q = 32 - buf.bit_length() if buf else 32   # leading zeros (31-log2)
    if q > switch_bits:       # exp-golomb
        bits = exp_order - switch_bits + (q << 1)
        if bits > 31:
            raise InvalidData("prores: bad codeword")
        val = b.get(bits) - (1 << exp_order) + \
            ((switch_bits + 1) << rice_order)
    elif rice_order:
        b.pos += q + 1
        val = (q << rice_order) + b.get(rice_order)
    else:
        val = q
        b.pos += q + 1
    return val


def _tosigned(x: int) -> int:
    return (x >> 1) ^ -(x & 1)


def _decode_dc(b: _Bits, n_blocks: int, out: np.ndarray):
    code = _codeword(b, _FIRST_DC_CB)
    prev = _tosigned(code)
    out[0, 0] = prev
    code = 5
    sign = 0
    for i in range(1, n_blocks):
        code = _codeword(b, _DC_CB[min(code, 6)])
        if code:
            sign ^= -(code & 1)
        else:
            sign = 0
        prev += (((code + 1) >> 1) ^ sign) - sign
        out[i, 0] = prev


def _decode_ac(b: _Bits, n_blocks: int, out: np.ndarray):
    log2_n = n_blocks.bit_length() - 1
    run, level = 4, 2
    max_coeffs = 64 << log2_n
    block_mask = n_blocks - 1
    pos = block_mask
    while True:
        bits_left = b.n - b.pos
        if bits_left <= 0 or (bits_left < 32 and
                              b.get(bits_left) == 0):
            break
        if bits_left < 32:
            b.pos -= bits_left      # undo the probe read
        run = _codeword(b, _RUN_CB[min(run, 15)])
        pos += run + 1
        if pos >= max_coeffs:
            raise InvalidData("prores: ac overflow")
        level = _codeword(b, _LEV_CB[min(level, 9)]) + 1
        sign = -b.get(1)
        out[pos & block_mask, PROGRESSIVE_SCAN[pos >> log2_n]] = \
            (level ^ sign) - sign


def _entropy(data: bytes, out: np.ndarray) -> None:
    """One slice's blocks of one plane into `out` ((n_blocks, 64), zero
    on entry): ProresDecoder._entropy of the reference, written into the
    picture's buffer."""
    if not data:
        return
    b = _Bits(data)
    _decode_dc(b, out.shape[0], out)
    _decode_ac(b, out.shape[0], out)


@dataclass
class _Parsed:
    """A picture's host parse: per plane, the raster coefficients
    (n, 64) int32, each block's qscale (n,), its place in block units
    (row, col) and the plane's (H, W) in samples before the crop; the
    quantiser matrices and the output crop."""
    coeffs: list
    qscale: list
    place: list
    shapes: list
    qmats: list
    bits12: bool
    width: int
    height: int
    is444: bool

    def nbytes(self) -> int:
        return sum(a.nbytes for arrs in (self.coeffs, self.qscale,
                                         self.place) for a in arrs)


def reconstruct(parsed: _Parsed, device, timer: Optional[_Timer] = None):
    """The device stage on `device`: each plane's coefficients go up
    once, then dequantise (float32 product of the coefficient and the
    block's qmat × qscale), idct8x8, the scale and offset, round, clip
    and placement, in one pass per plane.  Returns the cropped planes
    (int16 tensors)."""
    device = torch.device(device)
    if timer is not None:
        timer.h2d_bytes = parsed.nbytes()
        timer.dev_mark("h2d")
    ups = [[torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrs] for arrs in zip(parsed.coeffs, parsed.qscale,
                                           parsed.place)]
    if timer is not None:
        timer.dev_mark("transform")
    out = []
    for p, (coef, qs, place) in enumerate(ups):
        h, w = parsed.shapes[p]
        qmat = torch.from_numpy(parsed.qmats[p]).to(device)
        # qmat × qscale in int32, then one float32 product, as the
        # reference's `coeffs.astype(f32) * (ql * qscale).astype(f32)`
        q = (qmat[None, :] * qs[:, None]).to(torch.float32)
        deq = (coef.to(torch.float32) * q).reshape(-1, 8, 8)
        if parsed.bits12:
            pix = torch.clamp(torch.round(idct8x8(deq) + 2048.0), 16, 4079)
        else:
            pix = torch.clamp(torch.round(idct8x8(deq) / 4.0 + 512.0),
                              4, 1019)
        grid = torch.zeros((h // 8, w // 8, 8, 8), dtype=torch.int16,
                           device=device)
        grid[place[:, 0], place[:, 1]] = pix.to(torch.int16)
        plane = grid.permute(0, 2, 1, 3).reshape(h, w)
        cw = parsed.width if (p == 0 or parsed.is444) \
            else parsed.width // 2
        out.append(plane[:parsed.height, :cw])
    if timer is not None:
        timer.dev_mark("done")
    return out


@register_decoder
class ProresDecoder(Codec):
    codec_id = "prores"
    codec_type = MediaType.VIDEO
    aliases = ("apcn", "apch", "apcs", "apco", "ap4h", "ap4x")

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        self.stats: Optional[list] = None
        self.last_parsed: Optional[_Parsed] = None

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or len(pkt.data) < 28:
            return []
        timer = _Timer(self.device) if self.stats is not None else None
        tag = self.par.codec_tag
        if isinstance(tag, int):
            tag = tag.to_bytes(4, "big").decode("latin1", "ignore")
        elif isinstance(tag, bytes):
            tag = tag.decode("latin1", "ignore")
        bits12 = self.par.codec_id in ("ap4h", "ap4x") or \
            tag in ("ap4h", "ap4x")
        buf = pkt.data
        if buf[4:8] == b"icpf":          # frame atom wrapper
            buf = buf[8:]
        hdr_size = int.from_bytes(buf[:2], "big")
        version = int.from_bytes(buf[2:4], "big")
        if version > 1:
            raise NotSupported(f"prores: version {version}")
        width = int.from_bytes(buf[8:10], "big")
        height = int.from_bytes(buf[10:12], "big")
        frame_type = (buf[12] >> 2) & 3
        if frame_type != 0:
            raise NotSupported("prores: interlaced")
        is444 = (buf[12] & 0xC0) == 0xC0
        alpha = buf[17] & 0xF
        if alpha:
            raise NotSupported("prores: alpha")
        flags = buf[19]
        ptr = 20
        if flags & 2:
            qmat_luma = np.frombuffer(buf[ptr:ptr + 64],
                                      np.uint8).astype(np.int32)
            ptr += 64
        else:
            qmat_luma = np.full(64, 4, np.int32)
        if flags & 1:
            qmat_chroma = np.frombuffer(buf[ptr:ptr + 64],
                                        np.uint8).astype(np.int32)
            ptr += 64
        else:
            qmat_chroma = qmat_luma
        # file qmats are already raster-ordered (proresdec.c keeps them
        # unpermuted for the C idct)
        pic = buf[hdr_size:]
        parsed = self._parse_picture(pic, width, height, is444, qmat_luma,
                                     qmat_chroma, bits12)
        self.last_parsed = parsed
        if timer is not None:
            timer.host_mark("parse")
        planes = reconstruct(parsed, self.device, timer)
        if timer is not None:
            timer.host_mark("queue")     # the host's launches
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            timer.host_mark("wait")
            self.stats.append({"host": dict(timer.host),
                               "h2d_bytes": timer.h2d_bytes,
                               "device": timer.device_ms()})
        depth = "12le" if bits12 else "10le"
        fmt = ("yuv444p" if is444 else "yuv422p") + depth
        f = Frame.video(width, height, fmt, planes=planes, pts=pkt.pts,
                        time_base=pkt.time_base or Rational(1, 25))
        f.key_frame = True
        f.color_range = "tv"
        return [f]

    def _parse_picture(self, buf, width, height, is444, ql, qc,
                       bits12=False) -> _Parsed:
        """The reference's _decode_picture walk, parsing every slice into
        the picture's per-plane buffers."""
        hdr_size = buf[0] >> 3
        log2_sw = buf[7] >> 4
        if (buf[7] & 0xF) or log2_sw > 3:
            raise InvalidData("prores: bad slice dims")
        slice_mb_w = 1 << log2_sw
        mb_w = (width + 15) >> 4
        mb_h = (height + 15) >> 4
        slice_count = mb_h * ((mb_w >> log2_sw)
                              + bin(mb_w & (slice_mb_w - 1)).count("1"))
        index = buf[hdr_size:hdr_size + slice_count * 2]
        data = buf[hdr_size + slice_count * 2:]

        W, H = mb_w * 16, mb_h * 16
        cw = W if is444 else W // 2
        n_luma = mb_w * mb_h * 4
        n_chroma = mb_w * mb_h * (4 if is444 else 2)
        coeffs = [np.zeros((n, 64), np.int32)
                  for n in (n_luma, n_chroma, n_chroma)]
        qscale = [np.zeros(n, np.int32) for n in (n_luma, n_chroma,
                                                  n_chroma)]
        place = [np.zeros((n, 2), np.int64) for n in (n_luma, n_chroma,
                                                      n_chroma)]
        nxt = [0, 0, 0]
        pos = 0
        mb_x = mb_y = 0
        cur = slice_mb_w
        for i in range(slice_count):
            size = int.from_bytes(index[i * 2:i * 2 + 2], "big")
            sl = data[pos:pos + size]
            pos += size
            while mb_w - mb_x < cur:
                cur >>= 1
            self._parse_slice(sl, mb_x, mb_y, cur, is444, coeffs, qscale,
                              place, nxt)
            mb_x += cur
            if mb_x == mb_w:
                cur = slice_mb_w
                mb_x = 0
                mb_y += 1
        return _Parsed(coeffs, qscale, place, [(H, W), (H, cw), (H, cw)],
                       [ql, qc, qc], bits12, width, height, is444)

    @staticmethod
    def _parse_slice(sl, mb_x, mb_y, mb_count, is444, coeffs, qscale,
                     place, nxt):
        hdr_size = sl[0] >> 3
        qs = min(max(sl[1], 1), 224)
        if qs > 128:
            qs = (qs - 96) << 2
        y_size = int.from_bytes(sl[2:4], "big")
        u_size = int.from_bytes(sl[4:6], "big")
        if hdr_size > 7:
            v_size = int.from_bytes(sl[6:8], "big")
        else:
            v_size = len(sl) - y_size - u_size - hdr_size
        body = sl[hdr_size:]
        parts = (body[:y_size], body[y_size:y_size + u_size],
                 body[y_size + u_size:y_size + u_size + v_size])
        per_mb = (4, 4 if is444 else 2, 4 if is444 else 2)
        m = np.arange(mb_count)
        for p in range(3):
            n = mb_count * per_mb[p]
            s = nxt[p]
            _entropy(parts[p], coeffs[p][s:s + n])
            qscale[p][s:s + n] = qs
            by = mb_y * 2
            if p == 0:
                # luma: 4 blocks per MB at (0,0) (8,0) (0,8) (8,8)
                bx = (mb_x + m) * 2
                rows = [by, by, by + 1, by + 1]
                cols = [bx, bx + 1, bx, bx + 1]
            elif is444:
                # column-major pairs (proresdec decode_slice_chroma)
                bx = (mb_x + m) * 2
                rows = [by, by + 1, by, by + 1]
                cols = [bx, bx, bx + 1, bx + 1]
            else:
                bx = mb_x + m
                rows = [by, by + 1]
                cols = [bx, bx]
            k = len(rows)
            pl = place[p][s:s + n].reshape(mb_count, k, 2)
            for j in range(k):
                pl[:, j, 0] = rows[j]
                pl[:, j, 1] = cols[j]
            nxt[p] = s + n
