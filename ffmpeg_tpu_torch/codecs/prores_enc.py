"""Apple ProRes encoder (counterpart of ffmpeg_tpu/codecs/prores_enc.py;
reference: libavcodec/proresenc_kostya.c).

The encoder's device (the `device` it is opened on) does the analysis:
level shift → FDCT (ops/idct.py fdct8x8, full float32) → the truncating
quantise, over every block of the frame, with one upload of each padded
plane and one download of the frame's integer levels.  The host packs
the adaptive Rice/Exp-Golomb entropy stream per slice, with the bit
writer, the codeword coder, the slice layout and the headers copied
from the reference.

The device's float32 FDCT sums in another order than the reference's,
so a coefficient that lands exactly on a multiple of its quantiser may
truncate one step apart; the packets are byte-identical wherever the
levels are (tests/test_torch_prores.py).

Profiles: 4:2:2 10-bit ("apch" family) and 4:4:4 12-bit ("ap4h").
Fixed qscale (the `qscale` option, 1..128).

`stats`, when a list, gets one dict per frame: the device transform's
ms (upload, transform and download, on the host's clock) and the host
packing's.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..core.frame import Frame, host_array
from ..core.packet import Packet, PKT_FLAG_KEY
from ..io.stream import MediaType
from ..ops.idct import fdct8x8
from ..utils.error import NotSupported
from .codec import Codec, register_encoder
from .prores import (PROGRESSIVE_SCAN, _DC_CB, _FIRST_DC_CB, _LEV_CB,
                     _RUN_CB)

# Same default matrix the reference ships for HQ (proresdata.c
# ff_prores_default_qmat_hq is flat 4s; use flat 4 — carried in the
# frame header either way).
_QMAT_FLAT4 = np.full(64, 4, np.uint8)


class _BitWriter:
    __slots__ = ("buf", "acc", "nacc")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nacc = 0

    def put(self, nbits: int, val: int):
        if nbits == 0:
            return
        self.acc = (self.acc << nbits) | (val & ((1 << nbits) - 1))
        self.nacc += nbits
        while self.nacc >= 8:
            self.nacc -= 8
            self.buf.append((self.acc >> self.nacc) & 0xFF)
        self.acc &= (1 << self.nacc) - 1

    def flush(self) -> bytes:
        if self.nacc:
            self.buf.append((self.acc << (8 - self.nacc)) & 0xFF)
            self.acc = 0
            self.nacc = 0
        return bytes(self.buf)


def _put_codeword(bw: _BitWriter, codebook: int, val: int):
    """proresenc_kostya.c encode_vlc_codeword: note the encode side
    switches at (cb&3)+1 prefix bits while the decode side compares
    q > (cb&3) — consistent because the exp branch always emits at
    least (cb&3)+1 leading zeros."""
    switch_bits = (codebook & 3) + 1
    rice_order = codebook >> 5
    exp_order = (codebook >> 2) & 7
    switch_val = switch_bits << rice_order
    if val >= switch_val:
        val += (1 << exp_order) - switch_val
        exponent = val.bit_length() - 1
        bw.put(exponent - exp_order + switch_bits, 0)
        bw.put(exponent + 1, val)
    else:
        exponent = val >> rice_order
        if exponent:
            bw.put(exponent, 0)
        bw.put(1, 1)
        if rice_order:
            bw.put(rice_order, val)


def _make_code(x: int) -> int:
    return 2 * x if x >= 0 else -2 * x - 1


def _encode_dcs(bw: _BitWriter, dcs: np.ndarray):
    prev = int(dcs[0])
    _put_codeword(bw, _FIRST_DC_CB, _make_code(prev))
    codebook = 5
    sign = 0
    for i in range(1, len(dcs)):
        dc = int(dcs[i])
        delta = dc - prev
        new_sign = -1 if delta < 0 else 0
        delta = (delta ^ sign) - sign
        code = _make_code(delta)
        _put_codeword(bw, _DC_CB[min(codebook, 6)], code)
        codebook = min(code, 6)
        sign = new_sign
        prev = dc


def _encode_acs(bw: _BitWriter, quant: np.ndarray):
    """quant: (n_blocks, 64) raster-indexed quantised coeffs."""
    prev_run, prev_level = 4, 2
    run = 0
    n = quant.shape[0]
    for i in range(1, 64):
        col = quant[:, PROGRESSIVE_SCAN[i]]
        for b in range(n):
            level = int(col[b])
            if level:
                a = abs(level)
                _put_codeword(bw, _RUN_CB[min(prev_run, 15)], run)
                _put_codeword(bw, _LEV_CB[min(prev_level, 9)], a - 1)
                bw.put(1, 1 if level < 0 else 0)
                prev_run = min(run, 15)
                prev_level = min(a, 9)
                run = 0
            else:
                run += 1


def _slice_layout(mb_w: int, slice_mb_w: int):
    """Per-row slice widths with power-of-two tail split (matches the
    decoder's `while mb_w - mb_x < cur: cur >>= 1` walk)."""
    widths = []
    mb_x = 0
    cur = slice_mb_w
    while mb_x < mb_w:
        while mb_w - mb_x < cur:
            cur >>= 1
        widths.append((mb_x, cur))
        mb_x += cur
    return widths


def quantise_plane(plane: torch.Tensor, qmat: np.ndarray, qscale: int,
                   bits12: bool) -> torch.Tensor:
    """A padded plane ((rows*8, cols*8) samples on its device) → its
    levels (rows, cols, 64) int32 in raster order, on that device: the
    level shift, fdct8x8 and the truncating quantise of the reference's
    `_quant_blocks` (float32 division, truncation toward zero)."""
    h, w = plane.shape
    x = plane.to(torch.float32)
    x = x - 2048.0 if bits12 else (x - 512.0) * 4.0
    blocks = x.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)
    coef = fdct8x8(blocks)
    q = (torch.from_numpy(qmat.astype(np.float32)).to(plane.device)
         * qscale).reshape(8, 8)
    return torch.trunc(coef / q).to(torch.int32).reshape(h // 8, w // 8,
                                                         64)


@register_encoder
class ProresEncoder(Codec):
    codec_id = "prores"
    codec_type = MediaType.VIDEO
    is_encoder = True

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        fmt = getattr(par, "pix_fmt", None) or "yuv422p10le"
        if fmt == "yuv422p10le":
            self.is444 = False
            self.bits12 = False
            self.tag = b"apch"
        elif fmt == "yuv444p12le":
            self.is444 = True
            self.bits12 = True
            self.tag = b"ap4h"
        else:
            raise NotSupported(
                f"proresenc: pix_fmt {fmt} (yuv422p10le / yuv444p12le)")
        self.qscale = int(self.options.get("qscale", 4))
        if not 1 <= self.qscale <= 128:
            raise NotSupported("proresenc: qscale out of [1,128]")
        self.width = par.width
        self.height = par.height
        self.log2_sw = 3
        par.codec_tag = self.tag.decode()
        self.stats: Optional[list] = None

    # ---- device pass: FDCT + quantise the whole frame ------------------

    def transform(self, frame: Frame) -> List[np.ndarray]:
        """The frame's levels, per plane (rows, cols, 64) int32 raster,
        computed on the encoder's device: each plane padded to the
        macroblock grid by edge replication (proresenc pads its input)
        and copied up once, the levels copied down once."""
        w, h = self.width, self.height
        mb_w = (w + 15) >> 4
        mb_h = (h + 15) >> 4
        W, H = mb_w * 16, mb_h * 16
        levels = []
        for i, p in enumerate(frame.planes[:3]):
            p = host_array(p).astype(np.uint16)
            tw = W if (self.is444 or i == 0) else W // 2
            padded = np.pad(p, ((0, H - p.shape[0]), (0, tw - p.shape[1])),
                            mode="edge")
            levels.append(quantise_plane(
                torch.from_numpy(padded.astype(np.int16)).to(self.device),
                _QMAT_FLAT4, self.qscale, self.bits12))
        sizes = [t.numel() for t in levels]
        flat = torch.cat([t.reshape(-1) for t in levels]).cpu().numpy()
        return [a.reshape(t.shape) for t, a in zip(
            levels, np.split(flat, np.cumsum(sizes)[:-1]))]

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        t0 = time.perf_counter()
        quants = self.transform(frame)
        t1 = time.perf_counter()
        data = self._pack(quants)
        if self.stats is not None:
            self.stats.append({"transform": (t1 - t0) * 1e3,
                               "pack": (time.perf_counter() - t1) * 1e3})
        return [Packet(data=data, pts=frame.pts, dts=frame.pts,
                       duration=frame.duration, flags=PKT_FLAG_KEY,
                       time_base=frame.time_base)]

    def _pack(self, quants: List[np.ndarray]) -> bytes:
        """The reference's slice packing and headers on per-plane levels
        (rows, cols, 64): the frame atom's bytes."""
        w, h = self.width, self.height
        mb_w = (w + 15) >> 4
        mb_h = (h + 15) >> 4
        slice_mb_w = 1 << self.log2_sw
        layout = _slice_layout(mb_w, slice_mb_w)
        slice_count = mb_h * len(layout)

        slices = []
        for mb_y in range(mb_h):
            for mb_x, cur in layout:
                parts = []
                for pi in range(3):
                    qg = quants[pi]
                    blocks = []
                    for m in range(cur):
                        if pi == 0:
                            bx = (mb_x + m) * 2
                            byr = mb_y * 2
                            blocks += [qg[byr, bx], qg[byr, bx + 1],
                                       qg[byr + 1, bx], qg[byr + 1, bx + 1]]
                        elif self.is444:
                            bx = (mb_x + m) * 2
                            byr = mb_y * 2
                            # column-major pairs (decode_slice_chroma)
                            blocks += [qg[byr, bx], qg[byr + 1, bx],
                                       qg[byr, bx + 1], qg[byr + 1, bx + 1]]
                        else:
                            bx = mb_x + m
                            byr = mb_y * 2
                            blocks += [qg[byr, bx], qg[byr + 1, bx]]
                    qb = np.stack(blocks)
                    bw = _BitWriter()
                    _encode_dcs(bw, qb[:, 0])
                    _encode_acs(bw, qb)
                    parts.append(bw.flush())
                hdr = bytes([6 << 3, self.qscale]) + \
                    len(parts[0]).to_bytes(2, "big") + \
                    len(parts[1]).to_bytes(2, "big")
                slices.append(hdr + parts[0] + parts[1] + parts[2])

        # picture header + slice index
        body = b"".join(slices)
        index = b"".join(len(s).to_bytes(2, "big") for s in slices)
        pic_size = 8 + len(index) + len(body)
        pic = bytes([0x40]) + pic_size.to_bytes(4, "big") + \
            slice_count.to_bytes(2, "big") + \
            bytes([self.log2_sw << 4]) + index + body

        fh = bytearray()
        fh += (148).to_bytes(2, "big")            # frame header size
        fh += (1 if self.is444 else 0).to_bytes(2, "big")   # version
        fh += b"fpta"                              # vendor
        fh += w.to_bytes(2, "big") + h.to_bytes(2, "big")
        fh.append((3 if self.is444 else 2) << 6)   # chroma factor, prog.
        fh.append(0)
        fh += bytes([2, 2, 2])                     # primaries/trc/matrix
        fh.append(0)                               # no alpha
        fh.append(0)
        fh.append(0x03)                            # both qmats present
        fh += _QMAT_FLAT4.tobytes()
        fh += _QMAT_FLAT4.tobytes()

        payload = bytes(fh) + pic
        return (len(payload) + 8).to_bytes(4, "big") + b"icpf" + payload
