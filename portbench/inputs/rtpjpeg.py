"""Seeded camera MJPEG frames as an RTP/JPEG receiver rebuilds them from an
RFC 2435 type 64 payload, vectorised.

Type 64 is type 0 with a Restart Marker header: 4:2:2, an MCU of 16x8
pixels holding Y0 Y1 (2x1), Cb and Cr.  The payload carries no Huffman
tables, so the receiver writes the JPEG standard's Annex K tables (ITU
T.81 K.3, whose luma AC table has codes of up to 16 bits), and for Q
1-99 its quantisation tables are Annex K's scaled by the IJG rule (RFC
2435 Appendix A).  Each frame is what a depacketiser such as
libavformat/rtpdec_jpeg.c hands a decoder: the headers its
jpeg_create_header writes (SOI, APP0 JFIF, DRI, DQT, DHT, SOF0, SOS),
then the scan with a restart marker every `restart_rows` MCU rows, EOI.

The picture is `inputs.mjpeg`'s fractal texture, the chroma planes drawn
at their 4:2:2 size (half the width, the full height), panned one MCU
column (16 pixels) a frame over one canvas, so a cycle of `frames`
distinct frames costs one forward DCT of the canvas.  The DC predictors
reset at each restart marker, so each frame codes its window of MCUs
anew.

The generator also keeps what the plain reference and the K1 roofline
need and the program never sees: the canvas's quantised coefficients,
each frame's destuffed scan bytes, its Huffman symbols, how many of them
have codes longer than 9 bits, and its longest segment.

The random draws are numpy's, so a seed gives the same draws anywhere;
the arithmetic after them runs in PyTorch on the device it is given.
The Annex K tables below are the standard's, the same as the program's
`codecs/mjpeg_enc.py` STD_DC_LUMA ... STD_AC_CHROMA hold (a frozen copy:
the tests hold them equal to the standard-table fixture's DHT); the rest
is `inputs.mjpeg`'s arithmetic (texture, forward DCT, IJG scaling,
packing).

Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .mjpeg import (CHROMA_Q, LUMA_Q, ZIGZAG, _forward, _pack_scan,
                    _value_bits, quality_table, texture)

# ITU T.81 Annex K.3 (Tables K.3-K.6): (code-length counts, values), the
# tables rtpdec_jpeg.c writes into every frame's DHT
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12)))
AC_LUMA = (
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
AC_CHROMA = (
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
# in the order of inputs.mjpeg's entry tables: DC luma, AC luma, DC
# chroma, AC chroma
TABLES = (DC_LUMA, AC_LUMA, DC_CHROMA, AC_CHROMA)
BLOCKS = 4                       # Y0 Y1 Cb Cr


def canonical_codes(counts, values):
    """(code[256], length[256]) of a DHT's table, T.81 Annex C."""
    code = np.zeros(256, np.int64)
    clen = np.zeros(256, np.int64)
    c, vi = 0, 0
    for l in range(1, 17):
        for _ in range(counts[l - 1]):
            code[values[vi]], clen[values[vi]] = c, l
            c += 1
            vi += 1
        c <<= 1
    return code, clen


def _entries(coef: torch.Tensor, mcus_per_seg: int):
    """The symbol stream of every MCU of `coef` (my, mx, 4, 64), the DC
    predictors chained within segments of `mcus_per_seg` MCUs (in scan
    order) and reset at each segment's start.  Returns per entry (table *
    256 + symbol, raw bits, raw length) ordered by MCU, block and
    position, and the entry count of each segment."""
    dev = coef.device
    blk = coef.reshape(-1, 64)                      # (nblk, 64), MCU order
    nblk = blk.shape[0]
    bidx = torch.arange(nblk, device=dev)
    in_mcu = bidx % BLOCKS
    chroma = in_mcu >= 2
    dc = blk[:, 0]
    # the same component's previous block: Y1 after Y0, a Y0 after the last
    # MCU's Y1, a chroma block after the last MCU's
    prev = torch.where(in_mcu == 1, bidx - 1,
                       torch.where(in_mcu == 0, bidx - 3, bidx - BLOCKS))
    first = (bidx // BLOCKS) % mcus_per_seg == 0
    pred = torch.where((in_mcu != 1) & first, 0, dc[prev.clamp(min=0)])
    dsize, dbits = _value_bits(dc - pred)
    ac = blk[:, 1:]
    rows, cols = torch.nonzero(ac, as_tuple=True)
    prev_col = torch.full_like(rows, -1)
    same = torch.zeros_like(rows, dtype=torch.bool)
    same[1:] = rows[1:] == rows[:-1]
    prev_col[1:] = torch.where(same[1:], cols[:-1], -1)
    run = cols - prev_col - 1
    zrl = run // 16
    asize, abits = _value_bits(ac[rows, cols])
    last = torch.full((nblk,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, rows, cols, "amax")
    eb = bidx[last != 62]                            # blocks that end in EOB
    tab_dc = torch.where(chroma, 2, 0)
    tab_ac = torch.where(chroma, 3, 1)
    zrl_blk = torch.repeat_interleave(rows, zrl)
    blk_all = torch.cat([bidx, rows, zrl_blk, eb])
    key = torch.cat([torch.zeros_like(bidx), 2 * (cols + 2),
                     torch.repeat_interleave(2 * (cols + 2) - 1, zrl),
                     torch.full_like(eb, 255)])
    ts = torch.cat([tab_dc * 256 + dsize,
                    tab_ac[rows] * 256 + (run % 16) * 16 + asize,
                    tab_ac[zrl_blk] * 256 + 0xF0, tab_ac[eb] * 256])
    zeros = torch.zeros(zrl_blk.numel() + eb.numel(), dtype=torch.long,
                        device=dev)
    raw = torch.cat([dbits, abits, zeros])
    rlen = torch.cat([dsize, asize, zeros])
    order = torch.sort(blk_all * 256 + key, stable=True).indices
    nseg = -(-nblk // (BLOCKS * mcus_per_seg))
    per_seg = torch.bincount(blk_all // (BLOCKS * mcus_per_seg),
                             minlength=nseg)
    return ts[order], raw[order], rlen[order], per_seg


def _headers(w: int, h: int, restart: int, q_luma_zz, q_chroma_zz) -> bytes:
    """rtpdec_jpeg.c's jpeg_create_header for type 0 with a restart
    interval: SOI, APP0 JFIF, DRI, DQT (two tables), DHT (the four Annex K
    tables), SOF0 (Y 2x1, Cb 1x1, Cr 1x1), SOS."""
    def seg(marker: int, payload: bytes) -> bytes:
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
            + payload
    out = b"\xFF\xD8"
    out += seg(0xE0, b"JFIF\x00\x01\x02\x00\x00\x01\x00\x01\x00\x00")
    out += seg(0xDD, restart.to_bytes(2, "big"))
    out += seg(0xDB, bytes([0]) + bytes(q_luma_zz.astype(np.uint8))
               + bytes([1]) + bytes(q_chroma_zz.astype(np.uint8)))
    dht = b""
    for tid, (counts, values) in zip((0x00, 0x01, 0x10, 0x11),
                                     (DC_LUMA, DC_CHROMA, AC_LUMA,
                                      AC_CHROMA)):
        dht += bytes([tid]) + bytes(counts) + bytes(values)
    out += seg(0xC4, dht)
    out += seg(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
               + bytes([3, 1, 0x21, 0, 2, 0x11, 1, 3, 0x11, 1]))
    out += seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out


@dataclass
class RtpJpegClip:
    packets: list            # bytes, one complete JPEG a frame
    coef: torch.Tensor       # (mcus_y, canvas mcus_x, 4, 64) int64 zigzag
    q_luma: np.ndarray       # (64,) zigzag order, as the DQT writes it
    q_chroma: np.ndarray
    scan_bytes: np.ndarray   # destuffed scan bytes, a frame
    symbols: np.ndarray      # Huffman symbols, a frame
    long_codes: np.ndarray   # symbols with codes longer than 9 bits
    segments: np.ndarray     # the longest destuffed segment, a frame
    width: int
    height: int

    def frame_coef(self, f: int) -> torch.Tensor:
        """Frame f's quantised coefficients, (mcus_y, mcus_x, 4, 64)."""
        return self.coef[:, f:f + self.width // 16]


def make_clip(seed: int, width: int, height: int, frames: int,
              quality: int, restart_rows: int, luma: dict, chroma: dict,
              device="cpu") -> RtpJpegClip:
    """`frames` distinct type-64 frames of width x height, a restart marker
    every `restart_rows` MCU rows, panned one MCU column a frame over a
    canvas drawn from `seed`; `luma` and `chroma` are the planes'
    `inputs.mjpeg.texture` parameters."""
    if width % 16:
        raise ValueError("width must be a multiple of 16")
    rng = np.random.default_rng(seed % 2 ** 64)
    mcus_x, mcus_y = width // 16, -(-height // 8)
    cmx = mcus_x + frames - 1                        # canvas MCUs across
    q_l = quality_table(LUMA_Q, quality)
    q_c = quality_table(CHROMA_Q, quality)
    coefs = []
    for tex, div, q in ((luma, 1, q_l), (chroma, 2, q_c), (chroma, 2, q_c)):
        p = torch.round(texture(rng, height, cmx * 16 // div, tex,
                                device)).clamp_(0, 255)
        rows = mcus_y * 8                            # repeat the last row
        p = torch.cat([p, p[-1:].expand(rows - p.shape[0], -1)])
        coefs.append(_forward(p, q))
    y = coefs[0].reshape(mcus_y, cmx, 2, 64)
    canvas = torch.cat([y, coefs[1][:, :, None], coefs[2][:, :, None]], 2)
    codes = np.zeros((4, 256), np.int64)
    lens = np.zeros((4, 256), np.int64)
    for k, (counts, values) in enumerate(TABLES):
        codes[k], lens[k] = canonical_codes(counts, values)
    codes_t = torch.as_tensor(codes.reshape(-1), device=device)
    lens_t = torch.as_tensor(lens.reshape(-1), device=device)
    restart = restart_rows * mcus_x
    packets, scan_bytes, symbols, long_codes, longest = [], [], [], [], []
    for f in range(frames):
        ts, raw, rl, per_seg = _entries(canvas[:, f:f + mcus_x], restart)
        if bool((lens_t[ts] == 0).any()):
            raise ValueError("a symbol with no Annex K code")
        code = codes_t[ts] << rl | raw
        length = lens_t[ts] + rl
        scan, seg_len = _pack_scan(code, length, per_seg)
        packets.append(_headers(width, height, restart, q_l[ZIGZAG],
                                q_c[ZIGZAG]) + scan + b"\xFF\xD9")
        scan_bytes.append(int(seg_len.sum()))
        longest.append(int(seg_len.max()))
        symbols.append(ts.numel())
        long_codes.append(int((lens_t[ts] > 9).sum()))
    return RtpJpegClip(packets, canvas, q_l[ZIGZAG], q_c[ZIGZAG],
                       np.array(scan_bytes), np.array(symbols),
                       np.array(long_codes), np.array(longest), width,
                       height)
