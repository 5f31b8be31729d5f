"""WebP lossless (VP8L) decoder, exact integer port (reference:
libavcodec/webp.c vp8_lossless_decode_frame): LSB-first bitstream,
canonical Huffman with meta-groups and color cache, LZ77 with 2-D
short distances, and the four inverse transforms (predictor, color,
subtract-green, color-indexing).

The port's copy of ffmpeg_tpu/codecs/webp_vp8l.py, held equal to it by
tests/test_torch_vp8_webp.py.
"""

from __future__ import annotations

import numpy as np

from ..utils.error import InvalidData

NUM_LITERAL = 256
NUM_LENGTH = 24
NUM_DIST = 40
NUM_SHORT_DIST = 120
ALPHABETS = [NUM_LITERAL + NUM_LENGTH, NUM_LITERAL, NUM_LITERAL,
             NUM_LITERAL, NUM_DIST]
CL_ORDER = [17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
            13, 14, 15]

# (dx, dy) pairs for short distance codes (webp.c lz77_distance_offsets)
SHORT_DIST = [
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7),
]


class LEBits:
    """LSB-first bit reader (BITSTREAM_READER_LE)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def get(self, n: int) -> int:
        v = 0
        for i in range(n):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise InvalidData("vp8l: out of data")
            v |= ((self.data[byte] >> (self.pos & 7)) & 1) << i
            self.pos += 1
        return v

    def bit(self) -> int:
        return self.get(1)


class Huff:
    """Canonical Huffman decoder: codes assigned by increasing length
    then build order, read MSB-first from the LSB-first stream."""

    def __init__(self, code_lengths):
        self.simple = None
        syms_by_len = {}
        for sym, ln in enumerate(code_lengths):
            if ln:
                syms_by_len.setdefault(ln, []).append(sym)
        nb = sum(len(v) for v in syms_by_len.values())
        if nb == 0:
            raise InvalidData("vp8l: empty huffman code")
        if nb == 1:
            self.simple = [next(iter(syms_by_len.values()))[0]]
            return
        self.map = {}
        code = 0
        for ln in range(1, 16):
            for sym in syms_by_len.get(ln, []):
                self.map[(ln, code)] = sym
                code += 1
            code <<= 1

    @classmethod
    def simple2(cls, syms):
        o = object.__new__(cls)
        o.simple = list(syms)
        return o

    def read(self, gb: LEBits) -> int:
        if self.simple is not None:
            if len(self.simple) == 1:
                return self.simple[0]
            return self.simple[gb.bit()]
        code = 0
        ln = 0
        while True:
            code = (code << 1) | gb.bit()
            ln += 1
            if (ln, code) in self.map:
                return self.map[(ln, code)]
            if ln > 15:
                raise InvalidData("vp8l: bad huffman code")


def _read_huffman(gb: LEBits, alphabet_size: int) -> Huff:
    if gb.bit():                          # simple code
        nb = gb.bit() + 1
        first = gb.get(8) if gb.bit() else gb.bit()
        if nb == 2:
            return Huff.simple2([first, gb.get(8)])
        return Huff.simple2([first])
    num_codes = 4 + gb.get(4)
    cl_lens = [0] * 19
    for i in range(num_codes):
        cl_lens[CL_ORDER[i]] = gb.get(3)
    if gb.bit():
        bits = 2 + 2 * gb.get(3)
        max_symbol = 2 + gb.get(bits)
        if max_symbol > alphabet_size:
            raise InvalidData("vp8l: bad max symbol")
    else:
        max_symbol = alphabet_size
    cl_huff = Huff(cl_lens)
    lengths = [0] * alphabet_size
    prev_len = 8
    sym = 0
    while sym < alphabet_size:
        if not max_symbol:
            break
        max_symbol -= 1
        cl = cl_huff.read(gb)
        if cl < 16:
            lengths[sym] = cl
            sym += 1
            if cl:
                prev_len = cl
        elif cl == 16:
            rep = 3 + gb.get(2)
            for _ in range(rep):
                lengths[sym] = prev_len
                sym += 1
        elif cl == 17:
            sym += 3 + gb.get(3)
        elif cl == 18:
            sym += 11 + gb.get(7)
        else:
            raise InvalidData("vp8l: bad code length code")
        if sym > alphabet_size:
            raise InvalidData("vp8l: code lengths overflow")
    return Huff(lengths)


def _block_size(gb, w, h):
    bits = gb.get(3) + 2
    return bits, (w + (1 << bits) - 1) >> bits, \
        (h + (1 << bits) - 1) >> bits


class _Ctx:
    pass


def _decode_image(gb: LEBits, w: int, h: int, s=None, is_argb=False):
    """decode_entropy_coded_image → (h, w, 4) uint8 [a,r,g,b]."""
    img = _Ctx()
    img.frame = np.zeros((h, w, 4), np.uint8)
    img.color_cache_bits = 0
    img.entropy = None
    if gb.bit():
        img.color_cache_bits = gb.get(4)
        if not 1 <= img.color_cache_bits <= 11:
            raise InvalidData("vp8l: bad color cache bits")
        img.cache = np.zeros(1 << img.color_cache_bits, np.uint32)
    nb_groups = 1
    if is_argb and gb.bit():
        ebits, ew, eh = _block_size(gb, s.reduced_width, h)
        eimg = _decode_image(gb, ew, eh)
        img.entropy = (ebits, eimg)
        nb_groups = int((eimg[:, :, 1].astype(np.int32) << 8 |
                         eimg[:, :, 2]).max()) + 1
    groups = []
    for _ in range(nb_groups):
        hg = []
        for j in range(5):
            size = ALPHABETS[j]
            if j == 0 and img.color_cache_bits:
                size += 1 << img.color_cache_bits
            hg.append(_read_huffman(gb, size))
        groups.append(hg)

    width = s.reduced_width if is_argb else w
    frame = img.frame
    ccb = img.color_cache_bits
    x = y = 0
    while y < h:
        if img.entropy is not None:
            ebits, eimg = img.entropy
            g0 = int(eimg[y >> ebits, x >> ebits, 1])
            g1 = int(eimg[y >> ebits, x >> ebits, 2])
            hg = groups[(g0 << 8) | g1]
        else:
            hg = groups[0]
        v = hg[0].read(gb)
        if v < NUM_LITERAL:
            frame[y, x, 2] = v
            frame[y, x, 1] = hg[1].read(gb)
            frame[y, x, 3] = hg[2].read(gb)
            frame[y, x, 0] = hg[3].read(gb)
            if ccb:
                c = int(frame[y, x, 0]) << 24 | int(frame[y, x, 1]) \
                    << 16 | int(frame[y, x, 2]) << 8 | \
                    int(frame[y, x, 3])
                img.cache[(0x1E35A7BD * c & 0xFFFFFFFF) >> (32 - ccb)] = c
            x += 1
            if x == width:
                x = 0
                y += 1
        elif v < NUM_LITERAL + NUM_LENGTH:
            prefix = v - NUM_LITERAL
            if prefix < 4:
                length = prefix + 1
            else:
                eb = (prefix - 2) >> 1
                length = ((2 + (prefix & 1)) << eb) + gb.get(eb) + 1
            prefix = hg[4].read(gb)
            if prefix > 39:
                raise InvalidData("vp8l: bad distance prefix")
            if prefix < 4:
                distance = prefix + 1
            else:
                eb = (prefix - 2) >> 1
                distance = ((2 + (prefix & 1)) << eb) + gb.get(eb) + 1
            if distance <= NUM_SHORT_DIST:
                xi, yi = SHORT_DIST[distance - 1]
                distance = max(1, xi + yi * width)
            else:
                distance -= NUM_SHORT_DIST
            ref_x, ref_y = x, y
            if distance <= x:
                ref_x -= distance
                distance = 0
            else:
                ref_x = 0
                distance -= x
            while distance >= width:
                ref_y -= 1
                distance -= width
            if distance > 0:
                ref_x = width - distance
                ref_y -= 1
            ref_x = max(0, ref_x)
            ref_y = max(0, ref_y)
            if ref_y == y and ref_x >= x:
                raise InvalidData("vp8l: bad backref")
            for _ in range(length):
                frame[y, x] = frame[ref_y, ref_x]
                if ccb:
                    c = int(frame[y, x, 0]) << 24 | \
                        int(frame[y, x, 1]) << 16 | \
                        int(frame[y, x, 2]) << 8 | int(frame[y, x, 3])
                    img.cache[(0x1E35A7BD * c & 0xFFFFFFFF) >>
                              (32 - ccb)] = c
                x += 1
                ref_x += 1
                if x == width:
                    x = 0
                    y += 1
                if ref_x == width:
                    ref_x = 0
                    ref_y += 1
                if y == h or ref_y == h:
                    break
        else:
            if not ccb:
                raise InvalidData("vp8l: color cache not found")
            idx = v - (NUM_LITERAL + NUM_LENGTH)
            if idx >= (1 << ccb):
                raise InvalidData("vp8l: cache index oob")
            c = int(img.cache[idx])
            frame[y, x] = [(c >> 24) & 0xFF, (c >> 16) & 0xFF,
                           (c >> 8) & 0xFF, c & 0xFF]
            x += 1
            if x == width:
                x = 0
                y += 1
    return frame


def _s8(v):
    return ((int(v) + 128) & 0xFF) - 128


def _apply_predictor(s, argb):
    pbits, pimg = s.predictor
    h = argb.shape[0]
    for y in range(h):
        for x in range(s.reduced_width):
            if x == 0:
                m = 0 if y == 0 else 2
            elif y == 0:
                m = 1
            else:
                m = int(pimg[y >> pbits, x >> pbits, 2])
            if m > 13:
                raise InvalidData("vp8l: bad predictor")
            L = argb[y, x - 1].astype(np.int32) if x else None
            T = argb[y - 1, x].astype(np.int32) if y else None
            TL = argb[y - 1, x - 1].astype(np.int32) \
                if (x and y) else None
            if y:
                TR = (argb[y, 0] if x == argb.shape[1] - 1
                      else argb[y - 1, x + 1]).astype(np.int32)
            else:
                TR = None
            if m == 0:
                p = np.array([255, 0, 0, 0], np.int32)
            elif m == 1:
                p = L
            elif m == 2:
                p = T
            elif m == 3:
                p = TR
            elif m == 4:
                p = TL
            elif m == 5:
                p = T + ((L + TR) >> 1) >> 1
            elif m == 6:
                p = (L + TL) >> 1
            elif m == 7:
                p = (L + T) >> 1
            elif m == 8:
                p = (TL + T) >> 1
            elif m == 9:
                p = (T + TR) >> 1
            elif m == 10:
                p = ((L + TL) >> 1) + ((T + TR) >> 1) >> 1
            elif m == 11:
                diff = int((np.abs(L - TL) - np.abs(T - TL)).sum())
                p = T if diff <= 0 else L
            elif m == 12:
                p = np.clip(L + T - TL, 0, 255)
            else:                         # 13 (C division truncates)
                d = (L + T) >> 1
                t = d - TL
                p = np.clip(d + np.sign(t) * (np.abs(t) // 2), 0, 255)
            argb[y, x] = ((argb[y, x].astype(np.int32) + p)
                          & 0xFF).astype(np.uint8)


def _apply_color(s, argb):
    cbits, cimg = s.color
    h = argb.shape[0]
    for y in range(h):
        for x in range(s.reduced_width):
            cp = cimg[y >> cbits, x >> cbits]
            g = _s8(argb[y, x, 2])
            argb[y, x, 1] = (int(argb[y, x, 1]) +
                             ((_s8(cp[3]) * g) >> 5)) & 0xFF
            r = _s8(argb[y, x, 1])
            argb[y, x, 3] = (int(argb[y, x, 3]) +
                             ((_s8(cp[2]) * g) >> 5) +
                             ((_s8(cp[1]) * r) >> 5)) & 0xFF


def _apply_color_indexing(s, argb):
    wbits, pal = s.palette
    h, wfull = argb.shape[:2]
    if wbits > 0:
        pixel_bits = 8 >> wbits
        per = 1 << wbits
        for y in range(h):
            packed = argb[y, :s.reduced_width, 2].copy()
            for x in range(wfull):
                pk = int(packed[x >> wbits])
                sh = (x & (per - 1)) * pixel_bits
                argb[y, x, 2] = (pk >> sh) & ((1 << pixel_bits) - 1)
        s.reduced_width = wfull
    npal = pal.shape[1]
    for y in range(h):
        for x in range(wfull):
            i = int(argb[y, x, 2])
            if i >= npal:
                argb[y, x] = 0
            else:
                argb[y, x] = pal[0, i]


def decode_vp8l(data: bytes, is_alpha=False, width=0, height=0):
    """→ (w, h, argb (h, w, 4) uint8 [a,r,g,b])."""
    gb = LEBits(data)
    s = _Ctx()
    if not is_alpha:
        if gb.get(8) != 0x2F:
            raise InvalidData("vp8l: bad signature")
        w = gb.get(14) + 1
        h = gb.get(14) + 1
        gb.bit()                          # has_alpha hint
        if gb.get(3) != 0:
            raise InvalidData("vp8l: bad version")
    else:
        w, h = width, height
    s.width = w
    s.height = h
    s.reduced_width = w
    s.predictor = s.color = s.palette = None
    transforms = []
    used = 0
    while gb.bit():
        t = gb.get(2)
        if used & (1 << t):
            raise InvalidData("vp8l: duplicate transform")
        used |= 1 << t
        transforms.append(t)
        if t == 0:                        # predictor
            bits, bw, bh = _block_size(gb, s.reduced_width, h)
            s.predictor = (bits, _decode_image(gb, bw, bh))
        elif t == 1:                      # color
            bits, bw, bh = _block_size(gb, s.reduced_width, h)
            s.color = (bits, _decode_image(gb, bw, bh))
        elif t == 3:                      # color indexing
            npal = gb.get(8) + 1
            pal = _decode_image(gb, npal, 1)
            wbits = 3 if npal <= 2 else 2 if npal <= 4 else \
                1 if npal <= 16 else 0
            # palette entries are delta-coded
            p32 = pal.astype(np.int32)
            for i in range(1, npal):
                p32[0, i] += p32[0, i - 1]
            pal = (p32 & 0xFF).astype(np.uint8)
            s.palette = (wbits, pal)
            if wbits > 0:
                s.reduced_width = (w + (1 << wbits) - 1) >> wbits
    argb = _decode_image(gb, w, h, s, is_argb=True)
    for t in reversed(transforms):
        if t == 0:
            _apply_predictor(s, argb)
        elif t == 1:
            _apply_color(s, argb)
        elif t == 2:                      # subtract green
            g = argb[:, :s.reduced_width, 2].astype(np.int32)
            argb[:, :s.reduced_width, 1] = \
                (argb[:, :s.reduced_width, 1] + g) & 0xFF
            argb[:, :s.reduced_width, 3] = \
                (argb[:, :s.reduced_width, 3] + g) & 0xFF
        elif t == 3:
            _apply_color_indexing(s, argb)
    return w, h, argb
