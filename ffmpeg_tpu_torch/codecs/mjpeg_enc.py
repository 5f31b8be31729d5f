"""MJPEG / baseline JPEG encoder (counterpart of
ffmpeg_tpu/codecs/mjpeg_enc.py; reference: libavcodec/mjpegenc.c).

The encoder's device (the `device` it is opened on) does the analysis:
level shift → FDCT → quantize → zigzag in one call per component
(ops/idct.py jpeg_forward_transform, full float32), with one upload of
each padded component and one download of its integer coefficients.
The host does the serial Huffman bit-packing with the standard Annex-K
tables or per-frame optimal length-limited ones, copied from the
reference.  Quality maps to the same qscale→table scaling the reference
uses (ff_mjpeg_encode_picture's quality handling).

The device's float32 FDCT sums in another order than the reference's,
so a coefficient on a rounding boundary may land one step apart; the
packets are byte-identical wherever the coefficients are
(tests/test_torch_mjpeg_enc.py).

`stats`, when a list, gets one dict per frame: the device transform's
ms (uploads, transform and downloads, on the host's clock) and the host
packing's.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.frame import Frame, host_array
from ..core.packet import Packet, PKT_FLAG_KEY
from ..formats import pixfmt as _pf
from ..io.stream import MediaType
from ..ops.idct import jpeg_forward_transform
from ..utils.error import NotSupported
from .codec import Codec, register_encoder

# Annex K tables
STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int32)
STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99],
    np.int32)

# standard huffman specs: (counts[16], values)
STD_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
               list(range(12)))
STD_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
                 list(range(12)))
STD_AC_LUMA = (
    [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
    [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
     0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
     0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
     0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
     0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
     0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
     0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
STD_AC_CHROMA = (
    [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
    [0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
     0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
     0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
     0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
     0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
     0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
     0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
     0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def _scale_qtab(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG-style quality (1..100) → table scaling."""
    quality = max(1, min(100, quality))
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    q = (base * scale + 50) // 100
    return np.clip(q, 1, 255).astype(np.int32)


def package_merge(freqs: dict, limit: int) -> dict:
    """Optimal length-limited Huffman code lengths (package-merge).
    freqs: symbol -> count (>0). Returns symbol -> length (<= limit)."""
    syms = sorted(freqs)
    if len(syms) == 1:
        return {syms[0]: 1}
    items = sorted((freqs[s], (s,)) for s in syms)
    level = list(items)
    for _ in range(limit - 1):
        merged = [(level[i][0] + level[i + 1][0],
                   level[i][1] + level[i + 1][1])
                  for i in range(0, len(level) - 1, 2)]
        level = sorted(items + merged)
    lengths = {s: 0 for s in syms}
    for _w, pack in level[:2 * (len(syms) - 1)]:
        for s in pack:
            lengths[s] += 1
    return lengths


def build_optimal_table(freqs: dict, limit: int = 9) -> Tuple[list, list]:
    """(counts[16], values) DHT spec from symbol frequencies, canonical
    code assignment, max code length `limit`. A pseudo-symbol reserves
    the all-ones code per JPEG Annex K.2 convention."""
    f = {s: c for s, c in freqs.items() if c > 0}
    f[256] = 1                        # reserve the all-ones code
    lengths = package_merge(f, limit)
    # force the pseudo-symbol to the longest length so the canonical
    # assignment gives it the trailing (all-ones) code, then drop it
    lengths[256] = max(lengths.values())
    order = sorted(lengths, key=lambda s: (lengths[s], s))
    counts = [0] * 16
    values = []
    for s in order:
        if s == 256:
            continue
        counts[lengths[s] - 1] += 1
        values.append(s)
    # degenerate single-symbol table still needs a 1-bit code
    if sum(counts) == 0:
        counts[0] = 1
    return counts, values


def _huff_codes(spec) -> Tuple[np.ndarray, np.ndarray]:
    counts, values = spec
    codes = np.zeros(256, np.uint32)
    lens = np.zeros(256, np.uint8)
    code = 0
    vi = 0
    for l in range(1, 17):
        for _ in range(counts[l - 1]):
            codes[values[vi]] = code
            lens[values[vi]] = l
            code += 1
            vi += 1
        code <<= 1
    return codes, lens


class _BitWriter:
    """MSB-first with JPEG 0xFF stuffing."""

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 0xFF
            self.buf.append(b)
            if b == 0xFF:
                self.buf.append(0)
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put(0x7F >> (7 - ((8 - self.n) % 8)), (8 - self.n) % 8)


def _encode_blocks(bw: "_BitWriter", coeffs: np.ndarray,
                   dc_codes, dc_lens, ac_codes, ac_lens, pred: int) -> int:
    """coeffs: (nblocks, 64) int32 zigzag. Returns updated DC predictor."""
    for blk in coeffs:
        diff = int(blk[0]) - pred
        pred = int(blk[0])
        mag = diff if diff >= 0 else -diff
        nbits = mag.bit_length()
        bw.put(int(dc_codes[nbits]), int(dc_lens[nbits]))
        if nbits:
            v = diff if diff >= 0 else diff + (1 << nbits) - 1
            bw.put(v & ((1 << nbits) - 1), nbits)
        nz = np.nonzero(blk[1:])[0]
        k_prev = 0
        for idx in nz:
            run = int(idx) - k_prev
            k_prev = int(idx) + 1
            while run >= 16:
                bw.put(int(ac_codes[0xF0]), int(ac_lens[0xF0]))
                run -= 16
            v = int(blk[1 + idx])
            mag = v if v >= 0 else -v
            sz = mag.bit_length()
            rs = (run << 4) | sz
            bw.put(int(ac_codes[rs]), int(ac_lens[rs]))
            vv = v if v >= 0 else v + (1 << sz) - 1
            bw.put(vv & ((1 << sz) - 1), sz)
        if k_prev != 63:
            bw.put(int(ac_codes[0x00]), int(ac_lens[0x00]))  # EOB
    return pred


def _block_stats(coeffs, pred, dc_hist, ac_hist) -> int:
    """Histogram the DC-size and AC (run,size) symbols _encode_blocks
    would emit; returns the updated DC predictor."""
    for blk in coeffs:
        diff = int(blk[0]) - pred
        pred = int(blk[0])
        dc_hist[abs(diff).bit_length()] += 1
        nz = np.nonzero(blk[1:])[0]
        k_prev = 0
        for idx in nz:
            run = int(idx) - k_prev
            k_prev = int(idx) + 1
            while run >= 16:
                ac_hist[0xF0] += 1
                run -= 16
            sz = abs(int(blk[1 + idx])).bit_length()
            ac_hist[(run << 4) | sz] += 1
        if k_prev != 63:
            ac_hist[0x00] += 1
    return pred


_SAMPLING = {"yuv420p": (2, 2), "yuv422p": (2, 1), "yuv444p": (1, 1),
             "gray": (1, 1), "yuv440p": (1, 2)}


@register_encoder
class MjpegEncoder(Codec):
    codec_id = "mjpeg"
    codec_type = MediaType.VIDEO
    is_encoder = True

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        self.stats: Optional[list] = None
        self.quality = int((options or {}).get("quality", 90))
        self.restart_interval = int((options or {}).get("restart_interval", 0))
        # huffman="optimal" builds per-frame length-limited (<= max_code_len
        # bits) optimal tables, like the reference's mjpegenc_huffman.c
        # "huffman=optimal" but with a configurable cap. Short caps keep
        # the decode LUT small enough for one-hot MXU lookup on the TPU.
        self.huffman = (options or {}).get("huffman", "default")
        self.max_code_len = int((options or {}).get("max_code_len", 9))

    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        t = time.perf_counter()
        comps_coeffs, qtabs, samp, mcus_x, mcus_y, ncomp = \
            self.transform(frame)
        t1 = time.perf_counter()
        data = self._pack(frame, comps_coeffs, qtabs, samp, mcus_x,
                          mcus_y, ncomp)
        if self.stats is not None:
            self.stats.append({"transform": (t1 - t) * 1e3,
                               "pack": (time.perf_counter() - t1) * 1e3})
        return [Packet(data=data, pts=frame.pts, dts=frame.pts,
                       duration=frame.duration, flags=PKT_FLAG_KEY,
                       time_base=frame.time_base)]

    def transform(self, frame: Frame):
        """The device analysis of one frame: each component padded to its
        MCU-aligned block grid on the host, uploaded, transformed and
        quantized on the encoder's device, and its (rows, cols, 64) int32
        zigzag coefficients brought back.  Returns (coefficients per
        component, quantiser tables, sampling factors, MCUs across and
        down, component count)."""
        fmt = _pf.get(frame.format).name
        if fmt not in _SAMPLING:
            raise NotSupported(f"mjpeg enc: pix_fmt {fmt}")
        ncomp = 1 if fmt == "gray" else 3
        hs, vs = _SAMPLING[fmt]
        w, h = frame.width, frame.height
        hmax, vmax = (hs, vs) if ncomp == 3 else (1, 1)
        # per-comp sampling factors (luma gets hmax,vmax; chroma 1,1)
        samp = [(hmax, vmax)] + [(1, 1)] * (ncomp - 1)

        qluma = _scale_qtab(STD_LUMA_Q, self.quality)
        qchroma = _scale_qtab(STD_CHROMA_Q, self.quality)
        qtabs = [qluma] + [qchroma] * (ncomp - 1)

        mcus_x = -(-w // (8 * hmax))
        mcus_y = -(-h // (8 * vmax))

        # device analysis per component (pad plane to MCU-aligned grid)
        comps_coeffs = []
        for ci in range(ncomp):
            plane = host_array(frame.planes[ci])
            ch, cw = plane.shape
            rows = mcus_y * samp[ci][1]
            cols = mcus_x * samp[ci][0]
            padded = np.empty((rows * 8, cols * 8), plane.dtype)
            padded[:ch, :cw] = plane
            padded[ch:, :cw] = plane[ch - 1:ch, :]
            padded[:, cw:] = padded[:, cw - 1:cw]
            coeffs = jpeg_forward_transform(
                torch.from_numpy(padded).to(self.device),
                torch.from_numpy(qtabs[ci]).to(self.device), rows, cols)
            comps_coeffs.append(coeffs.cpu().numpy().reshape(rows, cols,
                                                             64))
        return comps_coeffs, qtabs, samp, mcus_x, mcus_y, ncomp

    def _pack(self, frame, comps_coeffs, qtabs, samp, mcus_x, mcus_y, ncomp):
        w, h = frame.width, frame.height
        out = bytearray()

        def marker(m, payload=b""):
            out.extend(b"\xFF" + bytes([m]))
            if payload:
                out.extend((len(payload) + 2).to_bytes(2, "big"))
                out.extend(payload)

        marker(0xD8)  # SOI
        # DQT
        dqt = b""
        tabs = [qtabs[0]] + ([qtabs[1]] if ncomp > 1 else [])
        for ti, q in enumerate(tabs):
            dqt += bytes([ti]) + q.astype(np.uint8).tobytes()
        marker(0xDB, dqt)
        # SOF0
        sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([ncomp])
        for ci in range(ncomp):
            sof += bytes([ci + 1, samp[ci][0] << 4 | samp[ci][1],
                          0 if ci == 0 else 1])
        marker(0xC0, sof)
        # Huffman table specs (standard Annex K or per-frame optimal)
        if self.huffman == "optimal":
            hists = [[0] * 257 for _ in range(4)]  # dcl, acl, dcc, acc
            pred = [0] * ncomp
            ri = self.restart_interval
            for mcu in range(mcus_x * mcus_y):
                my, mx = divmod(mcu, mcus_x)
                for ci in range(ncomp):
                    hcf, vcf = samp[ci]
                    blocks = [comps_coeffs[ci][my * vcf + by, mx * hcf + bx]
                              for by in range(vcf) for bx in range(hcf)]
                    cls = 0 if ci == 0 else 1
                    pred[ci] = _block_stats(
                        blocks, pred[ci],
                        hists[cls * 2], hists[cls * 2 + 1])
                if ri and (mcu + 1) % ri == 0:
                    pred = [0] * ncomp
            lim = self.max_code_len
            spec_dcl = build_optimal_table(
                {s: c for s, c in enumerate(hists[0]) if c}, lim)
            spec_acl = build_optimal_table(
                {s: c for s, c in enumerate(hists[1]) if c}, lim)
            spec_dcc = build_optimal_table(
                {s: c for s, c in enumerate(hists[2]) if c}, lim)
            spec_acc = build_optimal_table(
                {s: c for s, c in enumerate(hists[3]) if c}, lim)
        else:
            spec_dcl, spec_acl = STD_DC_LUMA, STD_AC_LUMA
            spec_dcc, spec_acc = STD_DC_CHROMA, STD_AC_CHROMA
        # DHT
        dht = b""
        specs = [(0x00, spec_dcl), (0x10, spec_acl)]
        if ncomp > 1:
            specs += [(0x01, spec_dcc), (0x11, spec_acc)]
        for tid, (counts, values) in specs:
            dht += bytes([tid]) + bytes(counts) + bytes(values)
        marker(0xC4, dht)
        if self.restart_interval:
            marker(0xDD, self.restart_interval.to_bytes(2, "big"))
        # SOS
        sos = bytes([ncomp])
        for ci in range(ncomp):
            sos += bytes([ci + 1, 0x00 if ci == 0 else 0x11])
        sos += bytes([0, 63, 0])
        marker(0xDA, sos)

        # entropy: interleaved MCUs
        dcl_c, dcl_l = _huff_codes(spec_dcl)
        acl_c, acl_l = _huff_codes(spec_acl)
        dcc_c, dcc_l = _huff_codes(spec_dcc)
        acc_c, acc_l = _huff_codes(spec_acc)
        bw = _BitWriter()
        pred = [0] * ncomp
        ri = self.restart_interval
        rst = 0
        mcu_total = mcus_x * mcus_y
        for mcu in range(mcu_total):
            my, mx = divmod(mcu, mcus_x)
            for ci in range(ncomp):
                hcf, vcf = samp[ci]
                blocks = []
                for by in range(vcf):
                    for bx in range(hcf):
                        blocks.append(
                            comps_coeffs[ci][my * vcf + by, mx * hcf + bx])
                dc_c, dc_l = (dcl_c, dcl_l) if ci == 0 else (dcc_c, dcc_l)
                ac_c, ac_l = (acl_c, acl_l) if ci == 0 else (acc_c, acc_l)
                pred[ci] = _encode_blocks(
                    bw, np.stack(blocks), dc_c, dc_l, ac_c, ac_l, pred[ci])
            if ri and (mcu + 1) % ri == 0 and mcu + 1 < mcu_total:
                bw.flush()
                out.extend(bw.buf)
                out.extend(b"\xFF" + bytes([0xD0 + rst]))
                rst = (rst + 1) % 8
                bw = _BitWriter()
                pred = [0] * ncomp
        bw.flush()
        out.extend(bw.buf)
        marker(0xD9)  # EOI
        return bytes(out)
