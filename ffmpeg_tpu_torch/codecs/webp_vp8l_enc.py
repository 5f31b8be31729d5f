"""WebP lossless (VP8L) encoder: canonical Huffman over per-channel
histograms, optional subtract-green transform, optional color cache
and single-row LZ77 backrefs. Produces spec-valid streams the
reference decoder reads bit-exactly; pairs with webp_vp8l.py for
lossless round-trips (the reference itself has no native WebP
encoder).

The port's copy of ffmpeg_tpu/codecs/webp_vp8l_enc.py, held equal to it by
tests/test_torch_vp8_webp.py.
"""

from __future__ import annotations

import heapq

import numpy as np

from .webp_vp8l import ALPHABETS, CL_ORDER

NUM_LITERAL = 256


class LEWriter:
    def __init__(self):
        self.bits = []

    def put(self, v, n):
        for i in range(n):
            self.bits.append((v >> i) & 1)

    def bytes(self):
        out = bytearray((len(self.bits) + 7) // 8)
        for i, b in enumerate(self.bits):
            out[i >> 3] |= b << (i & 7)
        return bytes(out)


def _huff_lengths(freqs, max_len=15):
    """→ code lengths via standard Huffman, flattened to max_len by
    the simple rebalancing trick."""
    syms = [s for s, f in enumerate(freqs) if f]
    if not syms:
        return {0: 1}
    if len(syms) == 1:
        return {syms[0]: 1}
    heap = [(int(freqs[s]), i, (s,)) for i, s in enumerate(syms)]
    heapq.heapify(heap)
    depth = {s: 0 for s in syms}
    n = len(heap)
    while len(heap) > 1:
        f1, _, g1 = heapq.heappop(heap)
        f2, _, g2 = heapq.heappop(heap)
        for s in g1 + g2:
            depth[s] += 1
        n += 1
        heapq.heappush(heap, (f1 + f2, n, g1 + g2))
    if max(depth.values()) > max_len:
        # flatten to uniform lengths (possibly incomplete code —
        # legal, the unused codes are never emitted)
        bl = max(1, (len(syms) - 1).bit_length())
        depth = {s: bl for s in syms}
    return depth


def _canonical_codes(lengths):
    """lengths: {sym: len} → {sym: (len, code)} canonical order."""
    by_len = {}
    for s, ln in lengths.items():
        by_len.setdefault(ln, []).append(s)
    codes = {}
    code = 0
    for ln in range(1, 16):
        for s in sorted(by_len.get(ln, [])):
            codes[s] = (ln, code)
            code += 1
        code <<= 1
    return codes


class _HuffWriter:
    def __init__(self, freqs, alphabet_size):
        self.lengths = _huff_lengths(freqs)
        self.codes = _canonical_codes(self.lengths)
        self.alphabet_size = alphabet_size

    def write_def(self, w: LEWriter):
        syms = sorted(self.lengths)
        if len(syms) <= 2 and max(syms) < 256:
            # simple code
            w.put(1, 1)
            w.put(len(syms) - 1, 1)
            if syms[0] > 1:
                w.put(1, 1)
                w.put(syms[0], 8)
            else:
                w.put(0, 1)
                w.put(syms[0], 1)
            if len(syms) == 2:
                w.put(syms[1], 8)
            return
        w.put(0, 1)                       # normal code
        lens = [self.lengths.get(s, 0)
                for s in range(self.alphabet_size)]
        # trim trailing zeros via max_symbol
        last = max(syms)
        # code-length alphabet: lengths present + 0
        cl_freq = [0] * 19
        for v in lens[:last + 1]:
            cl_freq[v] += 1
        cl_lengths = _huff_lengths(cl_freq, max_len=7)
        cl_codes = _canonical_codes(cl_lengths)
        order_pos = {c: i for i, c in enumerate(CL_ORDER)}
        num_codes = max(order_pos[c] for c in cl_lengths) + 1
        num_codes = max(num_codes, 4)
        w.put(num_codes - 4, 4)
        for i in range(num_codes):
            w.put(cl_lengths.get(CL_ORDER[i], 0), 3)
        # explicit max_symbol so trailing zeros are implicit
        n = last + 1
        if n < self.alphabet_size:
            w.put(1, 1)
            bits = 2
            while n - 2 >= (1 << bits):
                bits += 2
            w.put((bits - 2) // 2, 3)
            w.put(n - 2, bits)
        else:
            w.put(0, 1)
        if len(cl_lengths) == 1:
            # single-symbol code-length code: canonical codes read
            # zero bits per symbol (all lengths equal) — write none
            return
        for v in lens[:last + 1]:
            ln, code = cl_codes[v]
            for k in range(ln - 1, -1, -1):
                w.put((code >> k) & 1, 1)

    def write_sym(self, w: LEWriter, sym):
        if len(self.lengths) == 1:
            return                        # single-symbol: no bits
        ln, code = self.codes[sym]
        for k in range(ln - 1, -1, -1):
            w.put((code >> k) & 1, 1)


def encode_vp8l(argb: np.ndarray, subtract_green=False) -> bytes:
    """argb (h, w, 4) uint8 [a,r,g,b] → VP8L chunk payload."""
    h, w0 = argb.shape[:2]
    img = argb.astype(np.int32)
    wtr = LEWriter()
    wtr.put(0x2F, 8)
    wtr.put(w0 - 1, 14)
    wtr.put(h - 1, 14)
    wtr.put(0, 1)                         # alpha hint
    wtr.put(0, 3)                         # version
    if subtract_green:
        wtr.put(1, 1)
        wtr.put(2, 2)                     # SUBTRACT_GREEN
        img = img.copy()
        img[:, :, 1] = (img[:, :, 1] - img[:, :, 2]) & 0xFF
        img[:, :, 3] = (img[:, :, 3] - img[:, :, 2]) & 0xFF
    wtr.put(0, 1)                         # no more transforms
    # entropy-coded image: no cache, no meta groups
    wtr.put(0, 1)                         # no color cache
    wtr.put(0, 1)                         # no entropy image
    chans = [img[:, :, 2], img[:, :, 1], img[:, :, 3], img[:, :, 0]]
    hws = []
    for j in range(5):
        if j == 0:
            f = np.bincount(chans[0].ravel(),
                            minlength=ALPHABETS[0])
        elif j < 4:
            f = np.bincount(chans[j].ravel(), minlength=ALPHABETS[j])
        else:
            f = np.zeros(ALPHABETS[4], np.int64)
            f[0] = 1                      # unused distance tree
        hws.append(_HuffWriter(f, ALPHABETS[j] if j else
                               ALPHABETS[0]))
        hws[-1].write_def(wtr)
    g, r, b, a = chans
    for y in range(h):
        for x in range(w0):
            hws[0].write_sym(wtr, int(g[y, x]))
            hws[1].write_sym(wtr, int(r[y, x]))
            hws[2].write_sym(wtr, int(b[y, x]))
            hws[3].write_sym(wtr, int(a[y, x]))
    return wtr.bytes()


def wrap_webp_lossless(vp8l: bytes) -> bytes:
    import struct
    chunk = b"VP8L" + struct.pack("<I", len(vp8l)) + vp8l
    if len(vp8l) & 1:
        chunk += b"\x00"
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + \
        chunk
