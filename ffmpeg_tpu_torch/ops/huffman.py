"""Segment-parallel JPEG Huffman decode (counterpart of
ffmpeg_tpu/ops/huffman.py).

A scan with a restart marker after every MCU is thousands of independent,
byte-aligned bit segments per frame, each with its DC predictors reset.
They decode in parallel, one lane per segment:

- `jpeg_scan_decode` decodes any baseline Huffman table (codes up to 16
  bits, as the Annex K tables have) from one destuffed buffer with
  16-bit table lookups, in PyTorch on the inputs' device; its tables
  come from `build_jpeg_luts`.  It is the reference's XLA program, not a
  Pallas kernel, so it has no hand-written kernel.
- `jpeg_scan_decode9` is the plain PyTorch version: a loop that decodes
  one Huffman symbol on every lane per step, with table gathers.  It is
  the oracle for K1 and the path CPU tensors take.
- `jpeg_scan_decode_packed` is K1's entry point: it takes the packed
  per-frame regions of models/mjpeg_tpu_entropy.py directly, in either of
  their formats: the flagship's (one 4:2:0 MCU a segment, codes of at
  most 9 bits) and the camera format (segments of whole MCU rows or one
  MCU, 4:2:0 or 4:2:2, any baseline table).  On a CUDA tensor it launches
  a hand-written kernel of csrc/jpeg_huffman.cu, one a format; on a CPU
  tensor it gathers the lanes and runs `jpeg_scan_decode9`, or runs
  `jpeg_scan_decode` a frame at a time for the camera format.

`build_jpeg_luts9` (numpy) builds the flagship format's per-frame tables;
it and `build_jpeg_luts` are the port's copies of the reference's, held
equal to them by tests.  `build_jpeg_tables16` builds the camera
format's two-level tables, which `luts16_from_tables` expands to
`build_jpeg_luts`'s.

Reference for the sequential semantics: libavcodec/mjpegdec.c
decode_block / ITU T.81 §F.2.2.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import _cuda_build

BLOCKS_PER_SEG = 6              # one 4:2:0 MCU: Y0 Y1 Y2 Y3 Cb Cr
SYMBOLS_PER_BLOCK = 130         # symbol cap per lane, per block of its
                                # segment: a corrupt code (table length
                                # 0) cannot loop forever
MAX_ITER = BLOCKS_PER_SEG * SYMBOLS_PER_BLOCK
_DONE_CHECK = 8                 # steps between "all lanes done?" syncs

# Launches of K1's kernels, either format (counted by
# jpeg_scan_decode_packed where it launches, and nowhere else), and of
# the camera format's kernel alone.
KERNEL_LAUNCHES = 0
ROWS_KERNEL_LAUNCHES = 0


def build_lut(counts: np.ndarray, values: np.ndarray) -> np.ndarray:
    """(16,) code-length counts + values -> (65536,) int32 LUT of
    len<<8 | symbol for a 16-bit MSB-first peek. 0 = invalid code."""
    lut = np.zeros(1 << 16, np.int32)
    code = 0
    vi = 0
    for l in range(1, 17):
        for _ in range(int(counts[l - 1])):
            lo = code << (16 - l)
            hi = lo + (1 << (16 - l))
            lut[lo:hi] = (l << 8) | int(values[vi])
            code += 1
            vi += 1
        code <<= 1
    return lut


def build_jpeg_luts(st) -> np.ndarray:
    """From a parsed _JpegState: (4, 65536) int32 LUTs ordered
    [dc_luma, dc_chroma, ac_luma, ac_chroma]."""
    comps = st.components
    dcl = build_lut(st.dc_counts[comps[0].dc_tab],
                    st.dc_values[comps[0].dc_tab])
    dcc = build_lut(st.dc_counts[comps[1].dc_tab],
                    st.dc_values[comps[1].dc_tab])
    acl = build_lut(st.ac_counts[comps[0].ac_tab],
                    st.ac_values[comps[0].ac_tab])
    acc = build_lut(st.ac_counts[comps[1].ac_tab],
                    st.ac_values[comps[1].ac_tab])
    return np.stack([dcl, dcc, acl, acc])


def build_jpeg_luts9(st) -> np.ndarray:
    """Length-capped (<=9 bit) tables -> (512, 12) int8 LUT: per 9-bit
    peek, columns [len, run, size] x [dc_luma, dc_chroma, ac_luma,
    ac_chroma], each a nibble.  Raises if any code is longer than 9
    bits."""
    comps = st.components
    specs = [(st.dc_counts[comps[0].dc_tab], st.dc_values[comps[0].dc_tab]),
             (st.dc_counts[comps[1].dc_tab], st.dc_values[comps[1].dc_tab]),
             (st.ac_counts[comps[0].ac_tab], st.ac_values[comps[0].ac_tab]),
             (st.ac_counts[comps[1].ac_tab], st.ac_values[comps[1].ac_tab])]
    out = np.zeros((512, 12), np.int8)
    for t, (counts, values) in enumerate(specs):
        if any(counts[l] for l in range(9, 16)):
            raise ValueError("jpeg: code longer than 9 bits")
        code = 0
        vi = 0
        for l in range(1, 10):
            for _ in range(int(counts[l - 1])):
                lo = code << (9 - l)
                hi = lo + (1 << (9 - l))
                v = int(values[vi])
                out[lo:hi, 3 * t] = l
                out[lo:hi, 3 * t + 1] = v >> 4
                out[lo:hi, 3 * t + 2] = v & 15
                code += 1
                vi += 1
            code <<= 1
    return out


# One table of build_jpeg_tables16, little-endian: the first level, one
# entry a 9-bit peek (len | run << 4 | size << 8; len 0: no code of at
# most 9 bits starts there), then ITU T.81 F.2.2.3's MAXCODE and
# VALPTR - MINCODE for code lengths 9 + i (i = 1..7; entry 0 unused, -1
# and 0), then HUFFVAL.
TABLE16 = np.dtype([("l1", "<u2", 512), ("maxcode", "<i4", 8),
                    ("delta", "<i4", 8), ("val", "u1", 256)])
TABLE16_BYTES = 4 * TABLE16.itemsize      # a frame's four tables, 5376 B


def build_jpeg_tables16(st) -> np.ndarray:
    """Any baseline tables (codes of up to 16 bits) of a parsed
    _JpegState -> (TABLE16_BYTES,) uint8: four TABLE16 records ordered
    [dc_luma, dc_chroma, ac_luma, ac_chroma], as build_jpeg_luts9 orders
    its columns.  Codes of at most 9 bits resolve in the first level, the
    longer ones by F.2.2.3's search over lengths 10-16.  Raises on a
    table whose codes overflow their lengths."""
    comps = st.components
    specs = [(st.dc_counts[comps[0].dc_tab], st.dc_values[comps[0].dc_tab]),
             (st.dc_counts[comps[1].dc_tab], st.dc_values[comps[1].dc_tab]),
             (st.ac_counts[comps[0].ac_tab], st.ac_values[comps[0].ac_tab]),
             (st.ac_counts[comps[1].ac_tab], st.ac_values[comps[1].ac_tab])]
    out = np.zeros(4, TABLE16)
    for t, (counts, values) in enumerate(specs):
        rec = out[t]
        rec["maxcode"][:] = -1
        code = 0
        vi = 0
        for l in range(1, 17):
            n = int(counts[l - 1])
            if code + n > (1 << l):
                raise ValueError("jpeg: Huffman table overflows its code "
                                 "lengths")
            if l <= 9:
                for j in range(n):
                    lo = (code + j) << (9 - l)
                    v = int(values[vi + j])
                    rec["l1"][lo:lo + (1 << (9 - l))] = \
                        l | (v >> 4) << 4 | (v & 15) << 8
            elif n:
                rec["maxcode"][l - 9] = code + n - 1
                rec["delta"][l - 9] = vi - code
            code = (code + n) << 1
            vi += n
        rec["val"][:] = values
    return out.view(np.uint8)


def luts16_from_tables(tables: torch.Tensor) -> torch.Tensor:
    """(TABLE16_BYTES,) uint8 of build_jpeg_tables16 -> the (4, 65536)
    int32 tables of build_jpeg_luts (len << 8 | symbol a 16-bit peek, 0
    for no code), on the device of `tables`: what K1's two levels give
    for every peek."""
    dev = tables.device
    rec = tables.to(torch.int64).reshape(4, TABLE16.itemsize)

    def words(lo, n, size):
        b = rec[:, lo:lo + n * size].reshape(4, n, size)
        v = sum(b[..., k] << (8 * k) for k in range(size))
        return v - ((v >> (8 * size - 1)) << (8 * size)) if size == 4 else v
    l1 = words(0, 512, 2)
    maxcode = words(1024, 8, 4)
    delta = words(1056, 8, 4)
    val = rec[:, 1088:]
    peek = torch.arange(1 << 16, device=dev)
    e = l1[:, peek >> 7]
    ln = e & 15
    sym = ((e >> 4) & 15) << 4 | ((e >> 8) & 15)
    for l in range(10, 17):
        code = (peek >> (16 - l))[None, :]
        hit = (ln == 0) & (code <= maxcode[:, l - 9, None])
        idx = ((code + delta[:, l - 9, None]) & 255).expand(4, -1)
        sym = torch.where(hit, val.gather(1, idx), sym)
        ln = torch.where(hit, l, ln)
    return torch.where(ln > 0, ln << 8 | sym, 0).to(torch.int32)


def jpeg_scan_decode9(rows: torch.Tensor, valid: torch.Tensor,
                      lut9: torch.Tensor, cur0: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Plain PyTorch segment-parallel decode for streams whose Huffman
    codes are <= 9 bits.  Contract of the reference's jpeg_scan_decode9:

    rows:  (L, S) uint8, each lane's destuffed segment.
    valid: (L,) bool; invalid lanes decode nothing.
    lut9:  (512, 12) int8 from build_jpeg_luts9, or (F, 512, 12) with L
           divisible by F: lanes [f*L/F, (f+1)*L/F) use table f.
    cur0:  optional (L,) initial bit position per lane.
    Returns (L, 6, 64) int32 zigzag coefficients, accumulated as int16
    (values wrap as the reference's do).

    All arithmetic is int64, so every right shift is of a non-negative
    value and logical shifts need no masking tricks.
    """
    dev = rows.device
    L, S = rows.shape
    NC = BLOCKS_PER_SEG * 64
    lut = lut9.to(device=dev, dtype=torch.int64).reshape(-1, 512, 12)
    nf = lut.shape[0]
    if L % nf:
        raise ValueError("jpeg_scan_decode9: L not divisible by the "
                         "number of tables")
    lut_flat = lut.reshape(-1, 12)
    lut_base = torch.arange(L, device=dev) // (L // nf) * 512
    rp = F.pad(rows, (0, 3))                 # a window may start at S - 1
    win = torch.arange(4, device=dev)
    shifts = torch.tensor([24, 16, 8, 0], device=dev)
    z = torch.zeros(L, dtype=torch.int64, device=dev)
    cur = z.clone() if cur0 is None else cur0.to(device=dev,
                                                 dtype=torch.int64)
    blk = torch.where(valid.to(dev), 0, BLOCKS_PER_SEG).to(torch.int64)
    k = z - 1
    p0, p1, p2 = z, z, z
    out = torch.zeros((L, NC + 1), dtype=torch.int16, device=dev)  # +dump
    one = torch.ones_like(z)

    for it in range(MAX_ITER):
        if it % _DONE_CHECK == 0 and not bool((blk < BLOCKS_PER_SEG).any()):
            break
        done = blk >= BLOCKS_PER_SEG
        cb = (cur >> 3).clamp(0, S - 1)
        # big-endian 32-bit window at byte cb
        w32 = (rp.gather(1, cb[:, None] + win).to(torch.int64)
               << shifts).sum(1)
        sh = cur & 7
        look9 = (w32 >> (23 - sh)) & 0x1FF
        res = lut_flat[lut_base + look9]                     # (L, 12)
        b6 = blk.clamp(0, BLOCKS_PER_SEG - 1)
        comp = (b6 >= 4).to(torch.int64) + (b6 >= 5).to(torch.int64)
        is_dc = k < 0
        sel = torch.where(is_dc, 0, 2) + (comp > 0).to(torch.int64)
        col = (3 * sel)[:, None]
        ln = res.gather(1, col)[:, 0]
        run = res.gather(1, col + 1)[:, 0]
        sz = res.gather(1, col + 2)[:, 0]
        mag = (w32 >> (32 - sh - ln - sz).clamp(min=0)) & ((one << sz) - 1)
        half = (one << sz) >> 1
        val = torch.where((sz > 0) & (mag < half), mag - (one << sz) + 1, mag)
        cur = torch.where(done, cur, cur + ln + sz)
        predc = torch.where(comp == 0, p0, torch.where(comp == 1, p1, p2))
        pred_new = predc + val
        coef = torch.where(is_dc, pred_new, val)
        pos = torch.where(is_dc, 0, k + run)
        eob = (~is_dc) & (sz == 0) & (run == 0)
        zrl = (~is_dc) & (sz == 0) & (run == 15)
        write = (is_dc | (sz > 0)) & (~done) & (pos < 64)
        slot = torch.where(write, b6 * 64 + pos.clamp(0, 63), NC)
        out.scatter_(1, slot[:, None], coef[:, None].to(torch.int16))
        upd = is_dc & (~done)
        p0 = torch.where(upd & (comp == 0), pred_new, p0)
        p1 = torch.where(upd & (comp == 1), pred_new, p1)
        p2 = torch.where(upd & (comp == 2), pred_new, p2)
        k_new = torch.where(is_dc, 1, torch.where(zrl, k + 16, pos + 1))
        bdone = (~is_dc) & (eob | (k_new >= 64))
        blk = torch.where((~done) & bdone, blk + 1, blk)
        k = torch.where(done, k, torch.where(bdone, -1, k_new))
    return out[:, :NC].to(torch.int32).reshape(L, BLOCKS_PER_SEG, 64)


def jpeg_scan_decode(buf: torch.Tensor, bitpos0: torch.Tensor,
                     valid: torch.Tensor, luts: torch.Tensor,
                     blocks_per_seg: int = 6,
                     comp_of_blk=(0, 0, 0, 0, 1, 2), max_iter: int = 0,
                     blk_end: torch.Tensor | None = None, *,
                     stats: dict | None = None) -> torch.Tensor:
    """Segment-parallel scan decode for any baseline Huffman table, on the
    device of its inputs (the reference's jpeg_scan_decode).

    buf:      (NB,) uint8 destuffed scan bytes (all lanes' segments),
              padded by >= 4 bytes.
    bitpos0:  (L,) integer bit offset of each lane's segment start.
    valid:    (L,) bool lane mask (padding lanes decode nothing).
    luts:     (4, 65536) int32 from build_jpeg_luts.
    blk_end:  optional (L,) integer blocks per lane (a short final
              restart interval decodes fewer); defaults to blocks_per_seg.
    stats:    optional dict; gets "steps", the loop steps run.
    Returns (L, blocks_per_seg, 64) int32 zigzag coefficient blocks.

    Every input must be a tensor on one device; mixed devices raise.
    One step decodes one symbol on every lane with 16-bit table lookups;
    it runs at most `max_iter` steps (blocks_per_seg * 130 when <= 0).
    A lane past its last block is left as it is by a step, so the loop
    asks whether any lane is still busy only every 8 steps (one host
    sync each) and gives the result of the reference's loop, which asks
    every step.  Arithmetic is int32 throughout, so the flat coefficient
    index needs L * blocks_per_seg * 64 < 2**31; writes that the
    reference drops go to one spare slot past the end, sliced off.
    """
    tensors = {"buf": buf, "bitpos0": bitpos0, "valid": valid,
               "luts": luts}
    if blk_end is not None:
        tensors["blk_end"] = blk_end
    dev = buf.device
    if any(t.device != dev for t in tensors.values()):
        raise ValueError("jpeg_scan_decode: inputs on several devices: "
                         + ", ".join(f"{k} {t.device}"
                                     for k, t in tensors.items()))
    if luts.numel() != 4 * 65536:
        raise ValueError(f"jpeg_scan_decode: luts of shape "
                         f"{tuple(luts.shape)}, not (4, 65536)")
    i32 = torch.int32
    L = bitpos0.shape[0]
    NBLK = blocks_per_seg
    NC = L * NBLK * 64
    if NC >= 2 ** 31:
        raise ValueError("jpeg_scan_decode: L * blocks_per_seg * 64 must "
                         "be below 2**31")
    if max_iter <= 0:
        max_iter = NBLK * 130
    # 24-bit windows, so that a 16-bit peek at any bit offset is one gather
    b = buf.to(i32)
    buf24 = ((b << 16) | (F.pad(b[1:], (0, 1)) << 8)
             | F.pad(b[2:], (0, 2)))
    nb = buf24.shape[0]
    lflat = luts.to(i32).reshape(-1)
    ncomp = len(comp_of_blk)
    comp_map = torch.tensor(list(comp_of_blk), dtype=i32, device=dev)
    lane_base = torch.arange(L, dtype=i32, device=dev) * (NBLK * 64)
    end = (torch.full((L,), NBLK, dtype=i32, device=dev) if blk_end is None
           else blk_end.to(i32))
    c16 = torch.full((L,), 16, dtype=i32, device=dev)
    one = torch.ones_like(c16)
    spare = torch.full_like(c16, NC)

    def peek16(cur):
        w = buf24.index_select(0, (cur >> 3).clamp(0, nb - 1))
        return (w >> (8 - (cur & 7))) & 0xFFFF

    cur = bitpos0.to(i32)
    blk = torch.where(valid.to(torch.bool), 0, end).to(i32)
    k = torch.full_like(c16, -1)
    p0 = p1 = p2 = torch.zeros_like(c16)
    out = torch.zeros(NC + 1, dtype=i32, device=dev)   # + the spare slot
    steps = 0
    while steps < max_iter:
        if steps % _DONE_CHECK == 0 and not bool((blk < end).any()):
            break
        steps += 1
        busy = blk < end
        bc = blk.clamp(0, NBLK - 1)
        comp = comp_map.index_select(0, bc % ncomp)
        is_dc = k < 0
        is_ac = ~is_dc
        c0, c1 = comp == 0, comp == 1
        sel = (is_ac.to(i32) << 1) + (comp > 0).to(i32)
        e = lflat.index_select(0, (sel << 16) + peek16(cur))
        ln = e >> 8
        sym = e & 255
        cur = torch.where(busy, cur + ln, cur)
        run = sym >> 4            # 0 for DC symbols (sym <= 11)
        sz = sym & 15
        pw = one << sz
        mag = (peek16(cur) >> (c16 - sz)) & (pw - 1)
        val = torch.where((sz > 0) & (mag < (pw >> 1)), mag - pw + 1, mag)
        cur = torch.where(busy, cur + sz, cur)
        predc = torch.where(c0, p0, torch.where(c1, p1, p2))
        pred_new = predc + val
        coef = torch.where(is_dc, pred_new, val)
        pos = torch.where(is_dc, 0, k + run)
        no_sz = sz == 0
        eob = is_ac & no_sz & (run == 0)
        zrl = is_ac & no_sz & (run == 15)
        write = (is_dc | ~no_sz) & busy & (pos < 64)
        idx = torch.where(write, lane_base + bc * 64 + pos.clamp(0, 63),
                          spare)
        out.index_put_((idx,), coef)
        upd = is_dc & busy
        p0 = torch.where(upd & c0, pred_new, p0)
        p1 = torch.where(upd & c1, pred_new, p1)
        p2 = torch.where(upd & (comp == 2), pred_new, p2)
        k_new = torch.where(is_dc, 1, torch.where(zrl, k + 16, pos + 1))
        bdone = is_ac & (eob | (k_new >= 64))
        blk = torch.where(busy & bdone, blk + 1, blk)
        k = torch.where(busy, torch.where(bdone, -1, k_new), k)
    if stats is not None:
        stats["steps"] = steps
    return out[:NC].reshape(L, NBLK, 64)


def segment_starts(lens: torch.Tensor, hdr: int) -> torch.Tensor:
    """Byte offset of each segment in its region: the segments are packed
    tightly after the header, so starts are the exclusive cumsum."""
    return torch.cumsum(lens, 1, dtype=torch.int32) - lens + hdr


def _check_packed(regions, lens, luts, hdr, segment=(1, 6)):
    if regions.dtype != torch.uint8 or regions.dim() != 2:
        raise ValueError("regions must be (B, cap) uint8")
    B, cap = regions.shape
    if lens.dtype != torch.int32 or lens.dim() != 2 or lens.shape[0] != B:
        raise ValueError("lens must be (B, nseg) int32")
    if luts.dtype == torch.int8:
        if tuple(luts.shape) != (B, 512, 12) or segment != (1, 6):
            raise ValueError("luts (B, 512, 12) int8 take segments of one "
                             "4:2:0 MCU")
    elif luts.dtype != torch.uint8 or tuple(luts.shape) != (B,
                                                             TABLE16_BYTES):
        raise ValueError(f"luts must be (B, 512, 12) int8 or (B, "
                         f"{TABLE16_BYTES}) uint8")
    if segment[0] < 1 or segment[1] not in (4, 6):
        raise ValueError("segments of whole 4:2:0 or 4:2:2 MCUs only")
    if not 0 <= hdr <= cap:
        raise ValueError("hdr outside the region")
    if not (lens.device == luts.device == regions.device):
        raise ValueError("regions, lens and luts must share a device")


def _segment_mcus(nseg, mcus_per_seg, nmcu):
    """The MCUs of `nseg` segments of `mcus_per_seg` MCUs, the last one
    shorter where `nmcu` says so."""
    nmcu = nseg * mcus_per_seg if nmcu is None else nmcu
    if not (nseg - 1) * mcus_per_seg < nmcu <= nseg * mcus_per_seg:
        raise ValueError(f"{nseg} segments of {mcus_per_seg} MCUs cannot "
                         f"hold {nmcu} MCUs")
    return nmcu


def _decode_rows_plain(regions, lens, tables, hdr, mcus_per_seg,
                       blocks_per_mcu, nmcu):
    """Segments of several MCUs and any baseline table: `jpeg_scan_decode`
    over the lanes of all frames that share their tables (as a camera's
    frames do), with the 16-bit tables that the two-level ones give.
    Each region is followed by enough zero bytes that no lane reaches the
    next one in max_iter symbols of at most 16 + 15 bits, so bytes past a
    region read as 0, as in the kernel; calls are cut so that bit offsets
    and coefficient indices stay within int32."""
    B, nseg = lens.shape
    cap = regions.shape[1]
    nmcu = _segment_mcus(nseg, mcus_per_seg, nmcu)
    nblk = mcus_per_seg * blocks_per_mcu
    max_iter = SYMBOLS_PER_BLOCK * nblk
    first = torch.arange(nseg, device=lens.device) * mcus_per_seg
    blk_end = (nmcu - first).clamp(max=mcus_per_seg) * blocks_per_mcu
    comp = (0,) * (blocks_per_mcu - 2) + (1, 2)
    row = cap + (max_iter * 31 + 7) // 8 + 8
    per_call = max(1, min((2 ** 31 - 1) // (8 * row),
                          (2 ** 31 - 1) // (nseg * nblk * 64)))
    starts = segment_starts(lens, hdr).clamp(0, cap).to(torch.int64)
    out = torch.empty((B, nseg, nblk, 64), dtype=torch.int16,
                      device=regions.device)
    uniq, group = torch.unique(tables, dim=0, return_inverse=True)
    for g in range(uniq.shape[0]):
        luts = luts16_from_tables(uniq[g])
        frames = (group == g).nonzero().flatten()
        for fr in frames.split(per_call):
            n = fr.numel()
            buf = F.pad(regions[fr], (0, row - cap)).reshape(-1)
            first = torch.arange(n, device=regions.device)[:, None] * row
            coef = jpeg_scan_decode(
                buf, ((starts[fr] + first) * 8).reshape(-1),
                (lens[fr] > 0).reshape(-1), luts, nblk, comp, max_iter,
                blk_end.repeat(n))
            out[fr] = coef.reshape(n, nseg, nblk, 64).to(torch.int16)
    return out.reshape(B, nseg * mcus_per_seg, blocks_per_mcu,
                       64)[:, :nmcu].contiguous()


def decode_packed_plain(regions: torch.Tensor, lens: torch.Tensor,
                        luts: torch.Tensor, hdr: int, *,
                        mcus_per_seg: int = 1, blocks_per_mcu: int = 6,
                        nmcu: int | None = None) -> torch.Tensor:
    """K1's plain PyTorch version, on any device, for both of
    `jpeg_scan_decode_packed`'s layouts.

    One 4:2:0 MCU a segment with (B, 512, 12) tables: gather each
    segment's bytes into a lane row, then `jpeg_scan_decode9` over all
    frames' lanes at once.  A row holds every byte a lane can reach in
    MAX_ITER symbols of at most 9 + 15 bits, and bytes at or past the
    region's end read as 0, as in the kernel; so the two agree on any
    bytes, corrupt ones included.

    Otherwise (tables of build_jpeg_tables16): `jpeg_scan_decode` a frame
    at a time, each lane one segment of `mcus_per_seg` MCUs.
    """
    _check_packed(regions, lens, luts, hdr, (mcus_per_seg, blocks_per_mcu))
    if luts.dtype == torch.uint8:
        return _decode_rows_plain(regions, lens, luts, hdr, mcus_per_seg,
                                  blocks_per_mcu, nmcu)
    B, cap = regions.shape
    nmcu = lens.shape[1]
    width = -(-(MAX_ITER * 24 // 8 + 4) // 32) * 32
    starts = segment_starts(lens, hdr).clamp(0, cap).to(torch.int64)
    lanes = F.pad(regions, (0, width)).unfold(1, width, 1)  # (B, cap+1, W)
    frame = torch.arange(B, device=regions.device)[:, None]
    rows = lanes[frame, starts].reshape(B * nmcu, width)
    out = jpeg_scan_decode9(rows, (lens > 0).reshape(-1), luts)
    return out.to(torch.int16).reshape(B, nmcu, BLOCKS_PER_SEG, 64)


def jpeg_scan_decode_packed(regions: torch.Tensor, lens: torch.Tensor,
                            luts: torch.Tensor, hdr: int, *,
                            mcus_per_seg: int = 1, blocks_per_mcu: int = 6,
                            nmcu: int | None = None) -> torch.Tensor:
    """K1: decode every segment of a batch of packed frame regions.

    regions: (B, cap) uint8, one frame per row, segment bytes packed
             tightly from byte `hdr` on.
    lens:    (B, nseg) int32 segment byte lengths (0 = padding lane).
    luts:    the frames' tables, in one of two layouts:
             - (B, 512, 12) int8 from build_jpeg_luts9 (codes of at most
               9 bits), with segments of one 4:2:0 MCU: the flagship's
               layout;
             - (B, TABLE16_BYTES) uint8 from build_jpeg_tables16 (any
               baseline table), with segments of `mcus_per_seg` MCUs of
               `blocks_per_mcu` blocks (6: 4:2:0, Y0-Y3 Cb Cr; 4: 4:2:2,
               Y0 Y1 Cb Cr), the last segment cut at `nmcu` MCUs
               (default nseg * mcus_per_seg).
    Returns (B, nmcu, blocks_per_mcu, 64) int16 zigzag coefficients.

    A CUDA tensor goes to a kernel of csrc/jpeg_huffman.cu, which is
    built at first use; a CPU tensor to the plain version.  Any other
    device, a failed build and a failed launch raise.
    """
    global KERNEL_LAUNCHES
    if regions.device.type == "cpu":
        return decode_packed_plain(regions, lens, luts, hdr,
                                   mcus_per_seg=mcus_per_seg,
                                   blocks_per_mcu=blocks_per_mcu, nmcu=nmcu)
    if regions.device.type != "cuda":
        raise ValueError(f"jpeg_scan_decode_packed: no kernel for device "
                         f"{regions.device}")
    _check_packed(regions, lens, luts, hdr, (mcus_per_seg, blocks_per_mcu))
    if luts.dtype == torch.uint8:
        return _launch_rows(regions, lens, luts, hdr, mcus_per_seg,
                            blocks_per_mcu, nmcu)
    B, cap = regions.shape
    nmcu = lens.shape[1]
    regions = regions.contiguous()
    lens = lens.contiguous()
    if luts.stride()[1:] != (12, 1):
        luts = luts.contiguous()
    out = torch.empty((B, nmcu, BLOCKS_PER_SEG, 64), dtype=torch.int16,
                      device=regions.device)
    if out.numel() == 0:
        return out
    lib = _cuda_build.get()
    with torch.cuda.device(regions.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.jpeg_scan_decode_packed_launch(
            regions.data_ptr(), cap, lens.data_ptr(), hdr, luts.data_ptr(),
            luts.stride(0), out.data_ptr(), B, nmcu, MAX_ITER, stream)
    _cuda_build.check(lib, code, "jpeg_scan_decode_packed")
    KERNEL_LAUNCHES += 1
    return out


def _launch_rows(regions, lens, tables, hdr, mcus_per_seg, blocks_per_mcu,
                 nmcu):
    """The kernel for segments of several MCUs and two-level tables; it
    reads each region in 16-byte words, so a region row must start on 16
    bytes and `cap` be a multiple of 16."""
    global KERNEL_LAUNCHES, ROWS_KERNEL_LAUNCHES
    B, cap = regions.shape
    nseg = lens.shape[1]
    nmcu = _segment_mcus(nseg, mcus_per_seg, nmcu)
    regions = regions.contiguous()
    if lens.stride(1) != 1:
        lens = lens.contiguous()
    if tables.stride(1) != 1:
        tables = tables.contiguous()
    if cap % 16 or regions.data_ptr() % 16 or tables.data_ptr() % 4 \
            or tables.stride(0) % 4 or lens.data_ptr() % 4:
        raise ValueError("jpeg_scan_decode_packed: region rows must start "
                         "on 16 bytes and tables on 4")
    out = torch.empty((B, nmcu, blocks_per_mcu, 64), dtype=torch.int16,
                      device=regions.device)
    if out.numel() == 0:
        return out
    lib = _cuda_build.get()
    with torch.cuda.device(regions.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.jpeg_scan_decode_packed_rows_launch(
            regions.data_ptr(), cap, lens.data_ptr(), lens.stride(0), nseg,
            hdr,
            tables.data_ptr(), tables.stride(0), out.data_ptr(), B, nmcu,
            mcus_per_seg, blocks_per_mcu,
            SYMBOLS_PER_BLOCK * mcus_per_seg * blocks_per_mcu, stream)
    _cuda_build.check(lib, code, "jpeg_scan_decode_packed")
    KERNEL_LAUNCHES += 1
    ROWS_KERNEL_LAUNCHES += 1
    return out
