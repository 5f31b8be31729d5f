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
  per-frame regions of models/mjpeg_tpu_entropy.py directly.  On a CUDA
  tensor it launches the hand-written kernel csrc/jpeg_huffman.cu; on a
  CPU tensor it gathers the lanes and runs `jpeg_scan_decode9`.

`build_jpeg_luts9` (numpy) builds the per-frame tables K1 reads; it and
`build_jpeg_luts` are the port's copies of the reference's, held equal to
them by tests.

Reference for the sequential semantics: libavcodec/mjpegdec.c
decode_block / ITU T.81 §F.2.2.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import _cuda_build

BLOCKS_PER_SEG = 6              # one 4:2:0 MCU: Y0 Y1 Y2 Y3 Cb Cr
MAX_ITER = BLOCKS_PER_SEG * 130  # symbol cap per lane: a corrupt code
                                 # (table length 0) cannot loop forever
_DONE_CHECK = 8                 # steps between "all lanes done?" syncs

# Launches of the K1 kernel (counted by jpeg_scan_decode_packed where it
# launches, and nowhere else).
KERNEL_LAUNCHES = 0


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


def _check_packed(regions, lens, luts, hdr):
    if regions.dtype != torch.uint8 or regions.dim() != 2:
        raise ValueError("regions must be (B, cap) uint8")
    B, cap = regions.shape
    if lens.dtype != torch.int32 or lens.dim() != 2 or lens.shape[0] != B:
        raise ValueError("lens must be (B, nmcu) int32")
    if luts.dtype != torch.int8 or tuple(luts.shape) != (B, 512, 12):
        raise ValueError("luts must be (B, 512, 12) int8")
    if not 0 <= hdr <= cap:
        raise ValueError("hdr outside the region")
    if not (lens.device == luts.device == regions.device):
        raise ValueError("regions, lens and luts must share a device")


def decode_packed_plain(regions: torch.Tensor, lens: torch.Tensor,
                        luts: torch.Tensor, hdr: int) -> torch.Tensor:
    """K1's plain PyTorch version, on any device: gather each segment's
    bytes into a lane row, then `jpeg_scan_decode9` over all frames'
    lanes at once.

    A row holds every byte a lane can reach in MAX_ITER symbols of at
    most 9 + 15 bits, and bytes at or past the region's end read as 0, as
    in the kernel; so the two agree on any bytes, corrupt ones included.
    """
    _check_packed(regions, lens, luts, hdr)
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
                            luts: torch.Tensor, hdr: int) -> torch.Tensor:
    """K1: decode every segment of a batch of packed frame regions.

    regions: (B, cap) uint8, one frame per row, segment bytes packed
             tightly from byte `hdr` on.
    lens:    (B, nmcu) int32 segment byte lengths (0 = padding lane).
    luts:    (B, 512, 12) int8 per-frame tables from build_jpeg_luts9.
    Returns (B, nmcu, 6, 64) int16 zigzag coefficients.

    A CUDA tensor goes to the kernel csrc/jpeg_huffman.cu, which is built
    at first use; a CPU tensor to the plain version.  Any other device,
    a failed build and a failed launch raise.
    """
    global KERNEL_LAUNCHES
    if regions.device.type == "cpu":
        return decode_packed_plain(regions, lens, luts, hdr)
    if regions.device.type != "cuda":
        raise ValueError(f"jpeg_scan_decode_packed: no kernel for device "
                         f"{regions.device}")
    _check_packed(regions, lens, luts, hdr)
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
