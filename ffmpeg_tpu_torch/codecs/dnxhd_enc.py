"""DNxHD / DNxHR (SMPTE VC-3) encoder (counterpart of
ffmpeg_tpu/codecs/dnxhd_enc.py; reference: libavcodec/dnxhdenc.c).

The encoder's device (the `device` it is opened on) runs the FDCT of the
three planes (ops/idct.py fdct8x8, full float32), with one upload of
each padded plane and one download of the frame's coefficients; the
host quantises each block against the decoder's dequantiser (`quant`)
and packs the per-row VLC stream, copied from the reference.

The device's float32 FDCT sums in another order than the reference's,
so a DC on an exact rounding tie (DC is sum/8) may round one step apart;
the packets are byte-identical wherever the levels are
(tests/test_torch_dnxhd.py).

Profiles: DNxHR HQX 10-bit 4:2:2 (CID 1271) and DNxHR HQ 8-bit 4:2:2
(CID 1272), fixed qscale (constant quality).

`stats`, when a list, gets one dict per frame: the device transform's
ms (upload, FDCT and download, on the host's clock) and the host's
quantise and packing ms.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..core.frame import Frame, host_array
from ..core.packet import Packet, PKT_FLAG_KEY
from ..io.stream import MediaType
from ..ops.idct import ZIGZAG as ZIGZAG_RASTER
from ..ops.idct import fdct8x8
from ..utils.error import NotSupported
from . import dnxhd_tables as T
from .codec import Codec, register_encoder
from .prores_enc import _BitWriter


def _enc_tables(cid):
    e = T.CID_TABLE[cid]
    get = lambda s, part: getattr(T, f"T{s}_{part}", None)
    dc_codes = get(e["dc"], "DC_CODES")
    dc_bits = get(e["dc"], "DC_BITS")
    ac_codes = get(e["ac"], "AC_CODES")
    ac_bits = get(e["ac"], "AC_BITS")
    ac_info = np.asarray(get(e["ac"], "AC_INFO"), np.int64).reshape(257, 2)
    runsym = e.get("runsym", e["run"])
    run_codes = get(e["run"], "RUN_CODES")
    run_bits = get(e["run"], "RUN_BITS")
    run_vals = get(runsym, "RUN")
    # reverse maps, preferring the shortest code per symbol
    ac_map = {}
    for idx in range(257):
        key = (int(ac_info[idx, 0]), int(ac_info[idx, 1]))
        if key not in ac_map or ac_bits[idx] < ac_bits[ac_map[key]]:
            ac_map[key] = idx
    run_map = {run_vals[i]: (run_codes[i], run_bits[i])
               for i in range(len(run_vals))}
    lw = np.asarray(get(e["lw"], "LUMA_WEIGHT"), np.int64)
    cwv = get(e["cw"], "CHROMA_WEIGHT")
    cw = np.asarray(cwv, np.int64) if cwv is not None else lw
    return dict(dc_codes=dc_codes, dc_bits=dc_bits, ac_codes=ac_codes,
                ac_bits=ac_bits, ac_map=ac_map, run_map=run_map,
                lw=lw, cw=cw, index_bits=e["index_bits"],
                eob=e["eob_index"])


_FMT_CID = {"yuv422p10le": 1271, "yuv422p": 1272}


@register_encoder
class DnxhdEncoder(Codec):
    codec_id = "dnxhd"
    codec_type = MediaType.VIDEO
    is_encoder = True

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        fmt = getattr(par, "pix_fmt", None) or "yuv422p10le"
        if fmt not in _FMT_CID:
            raise NotSupported(
                f"dnxhdenc: pix_fmt {fmt} (yuv422p10le / yuv422p)")
        self.cid = _FMT_CID[fmt]
        self.bit_depth = 10 if fmt.endswith("10le") else 8
        self.qscale = int(self.options.get("qscale", 4))
        if not 1 <= self.qscale < 2048:
            raise NotSupported("dnxhdenc: qscale out of range")
        self.width = par.width
        self.height = par.height
        self.tb = _enc_tables(self.cid)
        par.codec_tag = "AVdh"
        self.stats: Optional[list] = None

    # ---- block entropy --------------------------------------------------

    def _put_dc(self, bw: _BitWriter, diff: int):
        """dnxhdenc.c dnxhd_encode_dc (JPEG-style size + extend)."""
        if diff < 0:
            nbits = (-2 * diff).bit_length() - 1
            diff -= 1
        elif diff > 0:
            nbits = (2 * diff).bit_length() - 1
        else:
            nbits = 0
        tb = self.tb
        bw.put(tb["dc_bits"][nbits] + nbits,
               (tb["dc_codes"][nbits] << nbits) |
               (diff & ((1 << nbits) - 1)))

    def _put_ac(self, bw: _BitWriter, zz: np.ndarray):
        """zz: (64,) quantised levels in zigzag order (signed)."""
        tb = self.tb
        ac_map = tb["ac_map"]
        run_map = tb["run_map"]
        index_bits = tb["index_bits"]
        max_ext = (1 << index_bits) - 1
        run = 0
        for i in range(1, 64):
            lev = int(zz[i])
            if lev == 0:
                run += 1
                continue
            a = min(abs(lev), 64 + 64 * max_ext)
            ext = (a - 1) >> 6            # base = a - 64*ext in [1, 64]
            base = a - 64 * ext
            flags = (1 if ext else 0) | (2 if run else 0)
            idx = ac_map.get((2 * base + 1, flags))
            if idx is None:
                # degrade to the nearest representable base (quality,
                # not validity — both CID tables are complete in practice)
                while idx is None and base > 1:
                    base -= 1
                    idx = ac_map.get((2 * base + 1, flags))
            bw.put(tb["ac_bits"][idx], tb["ac_codes"][idx])
            bw.put(1, 1 if lev < 0 else 0)
            if flags & 1:
                bw.put(index_bits, ext)
            if flags & 2:
                code, nbits = run_map[run]
                bw.put(nbits, code)
            run = 0
        idx = tb["eob"]
        bw.put(tb["ac_bits"][idx], tb["ac_codes"][idx])

    # ---- frame ----------------------------------------------------------

    def transform(self, frame: Frame) -> dict:
        """The frame's FDCT coefficients on the encoder's device, per
        plane {"y", "u", "v"}: (rows, cols, 8, 8) float32 host arrays.
        Each plane is padded to the macroblock grid by edge replication
        and copied up once; the coefficients come down once."""
        w, h = self.width, self.height
        mb_w = (w + 15) >> 4
        mb_h = (h + 15) >> 4
        W, H = mb_w * 16, mb_h * 16
        planes = [host_array(p) for p in frame.planes[:3]]
        padded = [np.pad(p, ((0, H - p.shape[0]),
                             (0, (W if i == 0 else W // 2) - p.shape[1])),
                         mode="edge") for i, p in enumerate(planes)]
        coefs = []
        for p in padded:
            x = torch.from_numpy(p.astype(np.int16)).to(self.device)
            hh, ww = p.shape
            g = x.to(torch.float32).reshape(hh // 8, 8, ww // 8, 8) \
                .permute(0, 2, 1, 3)
            coefs.append(fdct8x8(g))
        sizes = [c.numel() for c in coefs]
        flat = torch.cat([c.reshape(-1) for c in coefs]).cpu().numpy()
        return {name: a.reshape(c.shape) for name, c, a in zip(
            "yuv", coefs, np.split(flat, np.cumsum(sizes)[:-1]))}

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        t0 = time.perf_counter()
        coefs = self.transform(frame)
        t1 = time.perf_counter()
        data = self._pack(coefs)
        if self.stats is not None:
            self.stats.append({"transform": (t1 - t0) * 1e3,
                               "pack": (time.perf_counter() - t1) * 1e3})
        return [Packet(data=data, pts=frame.pts, dts=frame.pts,
                       duration=frame.duration, flags=PKT_FLAG_KEY,
                       time_base=frame.time_base)]

    def quant(self, block: np.ndarray, scale: np.ndarray) -> np.ndarray:
        """Minimise |recon - c| against the decoder's
        (L*w + (w>>1) [+32 unless weight==32]) >> 6 dequant."""
        qs = self.qscale
        czz = block.reshape(64)[ZIGZAG_RASTER]
        out = np.zeros(64, np.int64)
        out[0] = int(np.round(czz[0]))      # DC is raw
        for i in range(1, 64):
            c = czz[i]
            if c == 0.0:
                continue
            wgt = int(scale[i])
            b = 0 if int(scale[i] // qs) == 32 else 32
            # decoder recon = ((2L+1)*w + (w>>1) + b) >> 6
            L = int(np.round(((abs(c) * 64.0 - (wgt >> 1) - b)
                              / wgt - 1.0) / 2.0))
            if L <= 0:
                continue
            out[i] = -L if c < 0 else L
        return out

    def _pack(self, coefs: dict) -> bytes:
        """The reference's quantise, row packing and header on the
        frame's coefficients: the packet's bytes."""
        w, h = self.width, self.height
        mb_w = (w + 15) >> 4
        mb_h = (h + 15) >> 4
        tb = self.tb
        qs = self.qscale
        lw_s = tb["lw"] * qs
        cw_s = tb["cw"] * qs
        rows = []
        for row in range(mb_h):
            bw = _BitWriter()
            last_dc = [1 << (self.bit_depth + 2)] * 3
            for x in range(mb_w):
                bw.put(11, qs)
                bw.put(1, 0)                     # act flag
                # 422 block order: Y00 Y01 U0 V0 Y10 Y11 U1 V1
                blocks = []
                for half in (0, 1):
                    blocks.append((0, coefs["y"][row * 2 + half, x * 2]))
                    blocks.append((0, coefs["y"][row * 2 + half,
                                                 x * 2 + 1]))
                    blocks.append((1, coefs["u"][row * 2 + half, x]))
                    blocks.append((2, coefs["v"][row * 2 + half, x]))
                for comp, blk in blocks:
                    scale = lw_s if comp == 0 else cw_s
                    q = self.quant(blk, scale)
                    dc = int(q[0])
                    self._put_dc(bw, dc - last_dc[comp])
                    last_dc[comp] = dc
                    self._put_ac(bw, q)
            rows.append(bw.flush())

        data_offset = 0x280 if mb_h <= 68 else 0x170 + (mb_h << 2)
        hdr = bytearray(data_offset)
        hdr[0x02:0x04] = data_offset.to_bytes(2, "big")
        hdr[4] = 0x03                            # DNxHR prefix byte
        hdr[5] = 0x01                            # progressive
        hdr[6] = 0x80
        hdr[7] = 0xA0
        hdr[0x18:0x1a] = h.to_bytes(2, "big")
        hdr[0x1a:0x1c] = w.to_bytes(2, "big")
        hdr[0x1d:0x1f] = h.to_bytes(2, "big")
        hdr[0x21] = (0x58 if self.bit_depth == 10 else 0x38)
        hdr[0x22] = 0x88
        hdr[0x28:0x2c] = self.cid.to_bytes(4, "big")
        hdr[0x2c] = 0x80                         # progressive, 422, no act
        hdr[0x5f] = 0x01
        hdr[0x167] = 0x02
        hdr[0x16a:0x16c] = (mb_h * 4 + 4).to_bytes(2, "big")
        hdr[0x16c:0x16e] = mb_h.to_bytes(2, "big")
        hdr[0x16f] = 0x10
        off = 0
        for i, r in enumerate(rows):
            hdr[0x170 + 4 * i:0x174 + 4 * i] = off.to_bytes(4, "big")
            off += len(r)
        body = b"".join(rows)
        return bytes(hdr) + body + (0x600DC0DE).to_bytes(4, "big")
