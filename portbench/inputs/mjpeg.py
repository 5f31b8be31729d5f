"""Seeded 4:2:0 baseline MJPEG frames for the benchmark, vectorised.

The frames are windows of one textured canvas, panned one MCU column (16
pixels) a frame, so a cycle of `frames` distinct frames costs one forward
DCT of the canvas.  Each frame is a complete JPEG: SOI, DQT (IJG quality
scaling of the Annex K tables), SOF0, its own optimal Huffman tables with
codes of at most `max_code_len` bits (package-merge over the frame's own
symbol counts, as an encoder with per-frame optimal tables writes them),
DRI with a restart marker after every MCU, SOS, the stuffed scan, EOI.

With a restart after every MCU the DC predictors reset in every MCU, so
each MCU's symbols are fixed by the canvas alone; a frame only re-codes
its window of MCUs with its own tables.

The generator also keeps what the plain reference and the K1 roofline
need and the program never sees: every frame's quantised coefficients
(the canvas's, sliced by the frame's window), each frame's destuffed scan
bytes and its count of non-zero coefficients.

The random draws are numpy's, so a seed gives the same draws anywhere;
the arithmetic after them runs in PyTorch on the device it is given (the
card in a run, the CPU in the tests), a few tens of whole-array
operations a frame.

Nothing here imports the program.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import torch

# ITU T.81 Annex K, natural (row-major) order
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32, np.int64)
# natural index of zigzag position k
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)

# entry tables: Huffman table of an entry (DC luma, AC luma, DC chroma,
# AC chroma), in the order of the DHT written below
DCL, ACL, DCC, ACC = 0, 1, 2, 3


def dct_matrix() -> np.ndarray:
    """A[u, x] = C(u)/2 cos((2x+1)u pi/16): F = A X A^T, X = A^T F A."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    a = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16.0)
    a[0] /= np.sqrt(2.0)
    return a


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG quality scaling (jcparam.c jpeg_quality_scaling), natural order."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def optimal_lengths(freqs: np.ndarray, limit: int) -> np.ndarray:
    """Optimal code lengths of at most `limit` bits for the symbols with a
    non-zero count (package-merge), plus one reserved pseudo-symbol so
    that no code is all ones (T.81 K.2).  Returns (257,) lengths, 0 for
    symbols that do not occur; index 256 is the pseudo-symbol."""
    f = np.append(freqs, 1)
    syms = np.flatnonzero(f)
    items = sorted((int(f[s]), (int(s),)) for s in syms)
    level = list(items)
    for _ in range(limit - 1):
        merged = [(level[i][0] + level[i + 1][0], level[i][1] + level[i + 1][1])
                  for i in range(0, len(level) - 1, 2)]
        level = list(heapq.merge(items, merged))
    lengths = np.zeros(257, np.int64)
    for _, pack in level[:2 * (len(syms) - 1)]:
        for s in pack:
            lengths[s] += 1
    return lengths


def canonical_table(lengths: np.ndarray):
    """(counts[16], values, code[256], length[256]) of the canonical code
    for `lengths` (optimal_lengths), the pseudo-symbol given the last code
    of the longest length and left out of the table."""
    lens = lengths.copy()
    lens[256] = lens.max()
    order = sorted(np.flatnonzero(lens), key=lambda s: (lens[s], s))
    code = np.zeros(256, np.int64)
    clen = np.zeros(256, np.int64)
    counts = [0] * 16
    values = []
    c, prev = 0, 0
    for s in order:
        c <<= lens[s] - prev
        prev = lens[s]
        if s != 256:
            code[s], clen[s] = c, lens[s]
            counts[lens[s] - 1] += 1
            values.append(int(s))
        c += 1
    return counts, values, code, clen


def _value_bits(v: torch.Tensor):
    """(size category, the size's low bits of v as T.81 F.1.2.1 codes
    them) for an int64 tensor."""
    mag = v.abs()
    size = torch.zeros_like(v)
    while True:                                    # at most 11 passes
        more = (mag >> size) > 0
        if not bool(more.any()):
            break
        size += more.long()
    bits = torch.where(v >= 0, v, v + (1 << size) - 1)
    return size, bits


def _grid(rng, shape, device) -> torch.Tensor:
    """A standard normal grid whose values are the same multiset for every
    seed (a fixed sample, permuted by `rng`): the seed moves the texture,
    not its statistics, so every seed gives about the same work."""
    n = shape[0] * shape[1]
    values = np.sort(np.random.default_rng(0).standard_normal(n))
    return torch.as_tensor(values[rng.permutation(n)].reshape(shape),
                           device=device)


def _noise(rng, h: int, w: int, cell: int, device) -> torch.Tensor:
    """Value noise: a normal grid of `cell`-pixel cells, bilinearly
    upsampled to (h, w) float64, one axis at a time."""
    grid = _grid(rng, (h // cell + 2, w // cell + 2), device)
    if cell == 1:
        return grid[:h, :w]
    ys = (torch.arange(h, device=device, dtype=torch.float64) + 0.5) / cell
    xs = (torch.arange(w, device=device, dtype=torch.float64) + 0.5) / cell
    y0, x0 = ys.long(), xs.long()
    fy, fx = (ys - y0)[:, None], xs - x0
    rows = (1 - fy) * grid[y0] + fy * grid[y0 + 1]
    return (1 - fx) * rows[:, x0] + fx * rows[:, x0 + 1]


def texture(rng, h: int, w: int, tex: dict, device) -> torch.Tensor:
    """128 plus fractal value noise, float64 (h, w): the `base` octaves
    ([cell, amplitude] each) everywhere, and the `detail` octaves scaled
    by exp(sigma * a noise of `envelope_cell` pixels), so that flat and
    busy regions alternate as in camera footage."""
    out = torch.full((h, w), 128.0, dtype=torch.float64, device=device)
    for cell, amp in tex["base"]:
        out += amp * _noise(rng, h, w, cell, device)
    env = torch.exp(tex["envelope_sigma"]
                    * _noise(rng, h, w, tex["envelope_cell"], device))
    for cell, amp in tex["detail"]:
        out += amp * env * _noise(rng, h, w, cell, device)
    return out


def _forward(plane: torch.Tensor, q_nat: np.ndarray) -> torch.Tensor:
    """Level shift, forward DCT and quantisation of every 8x8 block of a
    float64 plane: (H/8, W/8, 64) int64 in zigzag order."""
    h, w = plane.shape
    a = torch.as_tensor(dct_matrix(), device=plane.device)
    blocks = (plane - 128.0).reshape(h // 8, 8, w // 8, 8).transpose(1, 2)
    f = (a @ blocks @ a.T).reshape(h // 8, w // 8, 64)[..., ZIGZAG]
    q = torch.as_tensor(q_nat[ZIGZAG], dtype=torch.float64,
                        device=plane.device)
    return torch.round(f / q).long()


@dataclass
class MjpegClip:
    packets: list            # bytes, one complete JPEG a frame
    coef: torch.Tensor       # (mcus_y, canvas mcus_x, 6, 64) int64 zigzag
    q_luma: np.ndarray       # (64,) zigzag order, as the DQT writes it
    q_chroma: np.ndarray
    scan_bytes: np.ndarray   # destuffed scan bytes, a frame
    nonzero: np.ndarray      # non-zero quantised coefficients, a frame
    segments: np.ndarray     # the longest destuffed segment, a frame
    width: int
    height: int

    def frame_coef(self, f: int) -> torch.Tensor:
        """Frame f's quantised coefficients, (mcus_y, mcus_x, 6, 64)."""
        mx = -(-self.width // 16)
        return self.coef[:, f:f + mx]


def _entries(coef: torch.Tensor):
    """The symbol stream of every MCU of `coef` (mcus_y, mcus_x, 6, 64),
    restart after each MCU.  Returns per entry (table * 256 + symbol, raw
    bits, raw length) ordered by MCU, block and position, and the entry
    count of each MCU, (mcus_y, mcus_x)."""
    dev = coef.device
    my, mx = coef.shape[:2]
    blk = coef.reshape(-1, 64)                      # (nblk, 64), MCU order
    nblk = blk.shape[0]
    bidx = torch.arange(nblk, device=dev)
    in_mcu = bidx % 6
    chroma = in_mcu >= 4
    dc = blk[:, 0]
    pred = torch.where((in_mcu == 0) | chroma, 0, torch.roll(dc, 1))
    dsize, dbits = _value_bits(dc - pred)
    # AC: every non-zero coefficient, with the ZRLs before it
    ac = blk[:, 1:]
    rows, cols = torch.nonzero(ac, as_tuple=True)   # row-major order
    prev = torch.full_like(rows, -1)
    same = torch.zeros_like(rows, dtype=torch.bool)
    same[1:] = rows[1:] == rows[:-1]
    prev[1:] = torch.where(same[1:], cols[:-1], -1)
    run = cols - prev - 1
    zrl = run // 16
    asize, abits = _value_bits(ac[rows, cols])
    last = torch.full((nblk,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, rows, cols, "amax")      # last non-zero a block
    eb = bidx[last != 62]                            # blocks that end in EOB
    tab_dc = torch.where(chroma, DCC, DCL)
    tab_ac = torch.where(chroma, ACC, ACL)
    zrl_blk = torch.repeat_interleave(rows, zrl)
    n_zrl = zrl_blk.numel()
    # sort key within a block: DC 0, each AC 2 * (2 + its column) with its
    # ZRLs at one less, EOB last
    blk_all = torch.cat([bidx, rows, zrl_blk, eb])
    key = torch.cat([torch.zeros_like(bidx), 2 * (cols + 2),
                     torch.repeat_interleave(2 * (cols + 2) - 1, zrl),
                     torch.full_like(eb, 255)])
    ts = torch.cat([tab_dc * 256 + dsize,
                    tab_ac[rows] * 256 + (run % 16) * 16 + asize,
                    tab_ac[zrl_blk] * 256 + 0xF0, tab_ac[eb] * 256])
    zeros = torch.zeros(n_zrl + eb.numel(), dtype=torch.long, device=dev)
    raw = torch.cat([dbits, abits, zeros])
    rlen = torch.cat([dsize, asize, zeros])
    order = torch.sort(blk_all * 256 + key, stable=True).indices
    per_mcu = torch.bincount(blk_all // 6, minlength=my * mx)
    return ts[order], raw[order], rlen[order], per_mcu.reshape(my, mx)


def _pack_scan(code: torch.Tensor, length: torch.Tensor,
               per_seg: torch.Tensor):
    """Entropy-coded segments, `per_seg` entries each in order, each
    padded with 1-bits to a byte, 0xFF stuffed and joined by RST0-7.
    Returns (scan bytes, destuffed length of each segment)."""
    dev = code.device
    nseg = per_seg.numel()
    seg_of = torch.repeat_interleave(torch.arange(nseg, device=dev), per_seg)
    first = torch.cumsum(per_seg, 0) - per_seg
    seg_bits = torch.zeros(nseg, dtype=torch.long, device=dev)
    seg_bits.index_add_(0, seg_of, length)
    seg_len = (seg_bits + 7) // 8
    seg_start = torch.cumsum(seg_len, 0) - seg_len
    csum = torch.cumsum(length, 0) - length
    pos = seg_start[seg_of] * 8 + csum - csum[first][seg_of]
    total = int(seg_len.sum())
    byte = pos >> 3
    v = code << (32 - length - (pos & 7))            # a 32-bit window
    buf = torch.zeros(total + 4, dtype=torch.long, device=dev)
    for k in range(4):                               # disjoint bits: + is |
        buf.index_add_(0, byte + k, (v >> (24 - 8 * k)) & 255)
    data = buf[:total]
    pad = seg_len * 8 - seg_bits
    data[seg_start + seg_len - 1] |= (1 << pad) - 1
    ff = (data == 0xFF).long()
    seg_id = torch.repeat_interleave(torch.arange(nseg, device=dev), seg_len)
    extra = torch.cumsum(ff, 0) - ff + 2 * seg_id
    out = torch.zeros(total + int(ff.sum()) + 2 * (nseg - 1),
                      dtype=torch.uint8, device=dev)
    out[torch.arange(total, device=dev) + extra] = data.to(torch.uint8)
    nxt = seg_start[1:] + extra[seg_start[1:]]
    out[nxt - 2] = 0xFF
    out[nxt - 1] = (0xD0 + torch.arange(nseg - 1, device=dev) % 8).to(
        torch.uint8)
    return out.cpu().numpy().tobytes(), seg_len
def _headers(w: int, h: int, q_luma_zz, q_chroma_zz, tables) -> bytes:
    def seg(marker: int, payload: bytes) -> bytes:
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
            + payload
    out = b"\xFF\xD8"
    out += seg(0xDB, bytes([0]) + bytes(q_luma_zz.astype(np.uint8))
               + bytes([1]) + bytes(q_chroma_zz.astype(np.uint8)))
    out += seg(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
               + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    dht = b""
    for tid, (counts, values) in zip((0x00, 0x10, 0x01, 0x11), tables):
        dht += bytes([tid]) + bytes(counts) + bytes(values)
    out += seg(0xC4, dht)
    out += seg(0xDD, (1).to_bytes(2, "big"))
    out += seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out


def make_clip(seed: int, width: int, height: int, frames: int,
              quality: int, max_code_len: int, luma: dict, chroma: dict,
              device="cpu") -> MjpegClip:
    """`frames` distinct frames of width x height, 4:2:0, panned one MCU
    column a frame over a canvas drawn from `seed`; `luma` and `chroma`
    are the planes' `texture` parameters."""
    if width % 16:
        raise ValueError("width must be a multiple of 16")
    rng = np.random.default_rng(seed % 2 ** 64)
    mcus_x, mcus_y = width // 16, -(-height // 16)
    cmx = mcus_x + frames - 1                        # canvas MCUs across
    q_l = quality_table(LUMA_Q, quality)
    q_c = quality_table(CHROMA_Q, quality)
    coefs = []
    for tex, div, q in ((luma, 1, q_l), (chroma, 2, q_c), (chroma, 2, q_c)):
        p = torch.round(texture(rng, -(-height // div), cmx * 16 // div,
                                tex, device)).clamp_(0, 255)
        rows = mcus_y * 16 // div                    # repeat the last row
        p = torch.cat([p, p[-1:].expand(rows - p.shape[0], -1)])
        coefs.append(_forward(p, q_l if div == 1 else q_c))
    y = coefs[0].reshape(mcus_y, 2, cmx, 2, 64).transpose(1, 2)
    canvas = torch.cat([y.reshape(mcus_y, cmx, 4, 64), coefs[1][:, :, None],
                        coefs[2][:, :, None]], dim=2)
    ts, raw, rlen, per_mcu = _entries(canvas)
    flat = per_mcu.reshape(-1)
    mcu_start = (torch.cumsum(flat, 0) - flat).reshape(mcus_y, cmx)
    packets, scan_bytes, nonzero, longest = [], [], [], []
    for f in range(frames):
        # this frame's MCUs, row by row, as index ranges into the entries
        lo = mcu_start[:, f]
        n = mcu_start[:, f + mcus_x - 1] + per_mcu[:, f + mcus_x - 1] - lo
        idx = torch.repeat_interleave(lo - (torch.cumsum(n, 0) - n), n) \
            + torch.arange(int(n.sum()), device=device)
        t, r, rl = ts[idx], raw[idx], rlen[idx]
        hist = torch.bincount(t, minlength=4 * 256).reshape(4, 256).cpu()
        tables = []
        codes = np.zeros((4, 256), np.int64)
        lens = np.zeros((4, 256), np.int64)
        for k in range(4):
            counts, values, codes[k], lens[k] = canonical_table(
                optimal_lengths(hist[k].numpy(), max_code_len))
            tables.append((counts, values))
        code = torch.as_tensor(codes.reshape(-1), device=device)[t] << rl | r
        length = torch.as_tensor(lens.reshape(-1), device=device)[t] + rl
        scan, seg_len = _pack_scan(code, length,
                                   per_mcu[:, f:f + mcus_x].reshape(-1))
        packets.append(_headers(width, height, q_l[ZIGZAG], q_c[ZIGZAG],
                                tables) + scan + b"\xFF\xD9")
        scan_bytes.append(int(seg_len.sum()))
        longest.append(int(seg_len.max()))
        nonzero.append(int(torch.count_nonzero(canvas[:, f:f + mcus_x])))
    return MjpegClip(packets, canvas, q_l[ZIGZAG], q_c[ZIGZAG],
                     np.array(scan_bytes), np.array(nonzero),
                     np.array(longest), width, height)
