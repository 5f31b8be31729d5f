"""DNxHD / DNxHR (SMPTE VC-3) decoder (counterpart of
ffmpeg_tpu/codecs/dnxhd.py; reference: libavcodec/dnxhddec.c).

Split between the host and the decoder's device:
  * host, copied from the reference: the header, the row offsets and
    the per-row VLC walk (`_Bits`, `_tables`, `_decode_row`,
    `_dct_block`), producing the weighted coefficients of every block
    of the picture in one buffer;
  * device (the `device` the decoder is opened on), in PyTorch: the
    float32 `idct8x8` (ops/idct.py, full float32, TF32 refused), round
    half to even, clip, and the placement of the blocks into the three
    planes, in one pass per picture.

The reference runs one IDCT batch per macroblock row (68 at 1080p), each
a host → device → host round trip; the port copies the picture's
coefficients up once.  Planes above 8 bits are int16 tensors on the
device (torch has no general uint16); `Frame.numpy()` gives uint16.

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
from ..ops.idct import ZIGZAG as ZIGZAG_RASTER
from ..ops.idct import idct8x8
from ..utils.error import InvalidData, NotSupported
from ..utils.rational import Rational
from . import dnxhd_tables as T
from .codec import Codec, register_decoder
from .vp9.recon_tpu import _Timer

_HR_PREFIXES = (b"\x00\x00\x02\x80\x01", b"\x00\x00\x03\x8c\x03",
                b"\x00\x00\x02\x80\x03")


def _build_lut(codes, bits, nsym, syms=None):
    maxlen = max(b for b in bits[:nsym] if b) if nsym else 1
    size = 1 << maxlen
    sym_t = np.full(size, -1, np.int32)
    len_t = np.zeros(size, np.int8)
    for i in range(nsym):
        l = bits[i]
        if l == 0:
            continue
        base = codes[i] << (maxlen - l)
        n = 1 << (maxlen - l)
        sym_t[base:base + n] = syms[i] if syms is not None else i
        len_t[base:base + n] = l
    return maxlen, sym_t, len_t


class _Bits:
    __slots__ = ("d", "pos", "n")

    def __init__(self, data: bytes):
        self.d = data + b"\x00" * 8
        self.pos = 0
        self.n = len(data) * 8

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

    def peek(self, nbits: int) -> int:
        p = self.pos
        v = self.get(nbits)
        self.pos = p
        return v

    def vlc(self, lut):
        maxlen, sym_t, len_t = lut
        pf = self.peek(maxlen)
        sym = int(sym_t[pf])
        if sym < 0:
            raise InvalidData("dnxhd: bad vlc")
        self.pos += int(len_t[pf])
        return sym


_LUT_CACHE = {}


def _tables(cid, bit_depth):
    key = (cid, bit_depth)
    if key in _LUT_CACHE:
        return _LUT_CACHE[key]
    e = T.CID_TABLE[cid]
    get = lambda s, part: getattr(T, f"T{s}_{part}", None)
    dc_n = 14 if bit_depth > 8 else 12
    dc = _build_lut(get(e["dc"], "DC_CODES"), get(e["dc"], "DC_BITS"), dc_n)
    ac = _build_lut(get(e["ac"], "AC_CODES"), get(e["ac"], "AC_BITS"), 257)
    runsym = e.get("runsym", e["run"])
    run = _build_lut(get(e["run"], "RUN_CODES"), get(e["run"], "RUN_BITS"),
                     62, syms=get(runsym, "RUN"))
    ac_info = np.asarray(get(e["ac"], "AC_INFO"), np.int32).reshape(257, 2)
    lw = np.asarray(get(e["lw"], "LUMA_WEIGHT"), np.int64)
    cwv = get(e["cw"], "CHROMA_WEIGHT")
    cw = np.asarray(cwv, np.int64) if cwv is not None else lw
    out = dict(dc=dc, ac=ac, run=run, ac_info=ac_info, lw=lw, cw=cw,
               index_bits=e["index_bits"], eob=e["eob_index"],
               is444=e["is444"])
    _LUT_CACHE[key] = out
    return out


@dataclass
class _Parsed:
    """A picture's host parse: the weighted raster coefficients of every
    block, (mb_h, mb_w, nblk, 64) int32 in the bitstream's block order,
    and what places them: bit depth, 4:4:4 and the crop."""
    blocks: np.ndarray
    bit_depth: int
    is444: bool
    width: int
    height: int

    def nbytes(self) -> int:
        return self.blocks.nbytes


# the block order within a macroblock (dnxhddec.c): 4:2:2 Y00 Y01 U0 V0
# Y10 Y11 U1 V1; 4:4:4 Y00 Y01 U00 U01 V00 V01 then the lower row
_ORDER = {False: ([0, 1, 4, 5], [2, 6], [3, 7]),
          True: ([0, 1, 6, 7], [2, 3, 8, 9], [4, 5, 10, 11])}


def reconstruct(parsed: _Parsed, device, timer: Optional[_Timer] = None):
    """The device stage on `device`: the picture's coefficients go up
    once, then idct8x8, round, clip and the placement into the three
    planes.  Returns the cropped planes (uint8 at 8 bits, else int16)."""
    device = torch.device(device)
    if timer is not None:
        timer.h2d_bytes = parsed.nbytes()
        timer.dev_mark("h2d")
    blocks = torch.from_numpy(parsed.blocks).to(device)
    if timer is not None:
        timer.dev_mark("transform")
    mb_h, mb_w, nblk, _ = blocks.shape
    pix = idct8x8(blocks.to(torch.float32).reshape(mb_h, mb_w, nblk, 8, 8))
    maxv = (1 << parsed.bit_depth) - 1
    dt = torch.uint8 if parsed.bit_depth == 8 else torch.int16
    pix = torch.clamp(torch.round(pix), 0, maxv).to(dt)
    out = []
    for p, idx in enumerate(_ORDER[parsed.is444]):
        b = pix[:, :, idx]
        if len(idx) == 4:       # 16x16: (upper, lower) x (left, right)
            b = b.reshape(mb_h, mb_w, 2, 2, 8, 8).permute(0, 2, 4, 1, 3, 5)
            plane = b.reshape(mb_h * 16, mb_w * 16)
            cw = parsed.width if (p == 0 or parsed.is444) \
                else parsed.width // 2
        else:                   # 4:2:2 chroma 8x16: upper, lower
            b = b.permute(0, 2, 3, 1, 4)
            plane = b.reshape(mb_h * 16, mb_w * 8)
            cw = parsed.width // 2
        out.append(plane[:parsed.height, :cw])
    if timer is not None:
        timer.dev_mark("done")
    return out


@register_decoder
class DnxhdDecoder(Codec):
    codec_id = "dnxhd"
    codec_type = MediaType.VIDEO
    aliases = ("AVdn", "AVdh", "dnxhr")

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        self.stats: Optional[list] = None
        self.last_parsed: Optional[_Parsed] = None

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or len(pkt.data) < 0x180:
            return []
        timer = _Timer(self.device) if self.stats is not None else None
        buf = pkt.data
        if buf[:5] not in _HR_PREFIXES and buf[:3] != b"\x00\x00\x02":
            raise InvalidData("dnxhd: bad header prefix")
        if buf[5] & 2:
            raise NotSupported("dnxhd: interlaced")
        height = int.from_bytes(buf[0x18:0x1a], "big")
        width = int.from_bytes(buf[0x1a:0x1c], "big")
        bd_code = buf[0x21] >> 5
        bit_depth = {1: 8, 2: 10, 3: 12}.get(bd_code)
        if bit_depth is None:
            raise InvalidData("dnxhd: bad bit depth")
        cid = int.from_bytes(buf[0x28:0x2c], "big")
        if cid not in T.CID_TABLE:
            raise NotSupported(f"dnxhd: cid {cid} (classic DNxHD "
                               "profiles TBD; DNxHR supported)")
        is444 = bool((buf[0x2c] >> 6) & 1)
        act = buf[0x2c] & 1
        if act:
            raise NotSupported("dnxhd: adaptive color transform")
        tb = _tables(cid, bit_depth)
        mb_w = (width + 15) >> 4
        mb_h = int.from_bytes(buf[0x16c:0x16e], "big")
        if not mb_h:
            mb_h = (height + 15) >> 4
        data_offset = 0x280 if mb_h <= 68 else 0x170 + (mb_h << 2)
        offsets = [int.from_bytes(buf[0x170 + 4 * i:0x174 + 4 * i], "big")
                   for i in range(mb_h)]
        body = buf[data_offset:]

        nblk = 12 if is444 else 8
        blocks = np.zeros((mb_h, mb_w, nblk, 64), np.int32)
        for row in range(mb_h):
            self._decode_row(body[offsets[row]:], mb_w, tb, bit_depth,
                             is444, blocks[row])
        parsed = _Parsed(blocks, bit_depth, is444, width, height)
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
        fmt = {(8, False): "yuv422p", (10, False): "yuv422p10le",
               (12, False): "yuv422p12le", (10, True): "yuv444p10le",
               (12, True): "yuv444p12le"}[(bit_depth, is444)]
        f = Frame.video(width, height, fmt, planes=planes, pts=pkt.pts,
                        time_base=pkt.time_base or Rational(1, 25))
        f.key_frame = True
        f.color_range = "tv"
        return [f]

    def _decode_row(self, data, mb_w, tb, bit_depth, is444, blocks):
        """One macroblock row's blocks into `blocks` ((mb_w, nblk, 64),
        zero on entry)."""
        b = _Bits(data)
        last_dc = [1 << (bit_depth + 2)] * 3
        nblk = 12 if is444 else 8
        index_bits = tb["index_bits"]
        # (index_bits, level_bias, level_shift) per dnxhddec block variants
        if bit_depth == 8:
            bias, shift = 32, 6
        elif bit_depth == 10 and not is444 and index_bits != 6:
            bias, shift = 8, 4
        elif bit_depth == 10 and not is444:
            # HQX 10-bit uses the 444-style block decode
            bias, shift = 32, 6
        else:
            bias, shift = 32, 6
        for x in range(mb_w):
            qscale = b.get(11)
            b.get(1)                  # act flag
            lscale = tb["lw"] * qscale
            cscale = tb["cw"] * qscale
            for n in range(nblk):
                if not is444:
                    comp = 0 if (n & 2) == 0 else 1 + (n & 1)
                else:
                    comp = (n >> 1) % 3
                scale = lscale if comp == 0 else cscale
                weight = tb["lw"] if comp == 0 else tb["cw"]
                self._dct_block(b, blocks[x, n], scale, weight, tb,
                                last_dc, comp, index_bits, bias, shift)

    @staticmethod
    def _dct_block(b, out, scale, weight, tb, last_dc, comp, index_bits,
                   bias, shift):
        length = b.vlc(tb["dc"])
        if length:
            v = b.get(length)
            if not (v >> (length - 1)):     # negative (JPEG-style extend)
                v -= (1 << length) - 1
            last_dc[comp] += v
        out[0] = last_dc[comp]
        ac_info = tb["ac_info"]
        eob = tb["eob"]
        i = 0
        while True:
            idx = b.vlc(tb["ac"])
            if idx == eob:
                break
            level = int(ac_info[idx, 0])
            flags = int(ac_info[idx, 1])
            sign = -b.get(1)
            if flags & 1:
                level += b.get(index_bits) << 7
            if flags & 2:
                i += b.vlc(tb["run"])
            i += 1
            if i > 63:
                raise InvalidData("dnxhd: ac overflow")
            w = int(scale[i])
            val = level * w + (w >> 1)
            # add bias unless (bias == 32 and weight[i] == 32)
            if bias < 32 or int(weight[i]) != bias:
                val += bias
            val >>= shift
            out[ZIGZAG_RASTER[i]] = (val ^ sign) - sign
