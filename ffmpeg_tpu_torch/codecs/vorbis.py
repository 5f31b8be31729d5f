"""Vorbis I decoder (counterpart of ffmpeg_tpu/codecs/vorbis.py; Xiph
Vorbis I specification; reference: libavcodec/vorbisdec.c). Host entropy
+ floor/residue decode, the IMDCT on the decoder's device (ops/tx.py),
windowed overlap-add with mixed block sizes on the host.

Scope: floor type 1, residue types 0/1/2, mapping type 0 with channel
coupling — the profile every real-world Vorbis stream uses (floor 0 is
ancient and effectively unused).

The host code is the reference's.  Where the reference makes one IMDCT
per channel of a packet, the port makes one per packet over the
channels that have a floor (every channel of a packet has the same
blocksize): one copy to the device and one back (codecs/audio_tx.py).
The window and overlap-add run after it on the host, in the reference's
order.  `stats`, when a list, gets each packet's split."""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..core.frame import Frame
from ..core.packet import Packet
from ..io.stream import MediaType
from ..ops import tx
from ..utils.error import InvalidData, NotSupported
from ..utils.rational import Rational
from . import audio_tx
from .codec import Codec, register_decoder
from .vorbis_tables import INVERSE_DB_TABLE


def ilog(x: int) -> int:
    """Vorbis ilog: position of the highest set bit (spec 9.2.1)."""
    n = 0
    while x > 0:
        n += 1
        x >>= 1
    return n


def float32_unpack(x: int) -> float:
    """Vorbis packed float (spec 9.2.2)."""
    mant = x & 0x1FFFFF
    if x & 0x80000000:
        mant = -mant
    exp = (x & 0x7FE00000) >> 21
    return mant * (2.0 ** (exp - 788))


class LsbBits:
    """LSB-first bit reader over one Vorbis packet (spec 2)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0                      # bit position

    def get(self, n: int) -> int:
        v = 0
        for i in range(n):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise InvalidData("vorbis: packet overread")
            v |= ((self.data[byte] >> (self.pos & 7)) & 1) << i
            self.pos += 1
        return v

    def get1(self) -> int:
        byte = self.pos >> 3
        if byte >= len(self.data):
            raise InvalidData("vorbis: packet overread")
        b = (self.data[byte] >> (self.pos & 7)) & 1
        self.pos += 1
        return b


class Codebook:
    def __init__(self, b: LsbBits):
        if b.get(24) != 0x564342:
            raise InvalidData("vorbis: bad codebook sync")
        self.dim = b.get(16)
        entries = b.get(24)
        lengths = [0] * entries
        if not b.get1():                  # unordered
            sparse = b.get1()
            for i in range(entries):
                if sparse:
                    if b.get1():
                        lengths[i] = b.get(5) + 1
                else:
                    lengths[i] = b.get(5) + 1
        else:                             # ordered
            cur = b.get(5) + 1
            i = 0
            while i < entries:
                num = b.get(ilog(entries - i))
                for _ in range(num):
                    lengths[i] = cur
                    i += 1
                cur += 1
        self._build(lengths)
        self.lookup_type = b.get(4)
        self.vq = None
        if self.lookup_type in (1, 2):
            minv = float32_unpack(b.get(32))
            delta = float32_unpack(b.get(32))
            vbits = b.get(4) + 1
            seq_p = b.get1()
            if self.lookup_type == 1:
                lv = 0
                if self.dim:
                    lv = int(entries ** (1.0 / self.dim))
                    while (lv + 1) ** self.dim <= entries:
                        lv += 1
                    while lv ** self.dim > entries:
                        lv -= 1
                n_vals = lv
            else:
                n_vals = entries * self.dim
            mults = [b.get(vbits) for _ in range(n_vals)]
            vq = np.zeros((entries, self.dim), np.float64)
            if self.lookup_type == 1:
                for e in range(entries):
                    last = 0.0
                    idx_div = 1
                    for d in range(self.dim):
                        off = (e // idx_div) % lv
                        vq[e, d] = mults[off] * delta + minv + last
                        if seq_p:
                            last = vq[e, d]
                        idx_div *= lv
            else:
                for e in range(entries):
                    last = 0.0
                    for d in range(self.dim):
                        vq[e, d] = mults[e * self.dim + d] * delta \
                            + minv + last
                        if seq_p:
                            last = vq[e, d]
            self.vq = vq
        elif self.lookup_type != 0:
            raise InvalidData("vorbis: bad lookup type")

    def _build(self, lengths):
        """Canonical Huffman assignment (spec 3.2.1; first-read bit is
        the MSB of the integer codeword)."""
        self.table = {}
        marker = [0] * 33
        for i, ln in enumerate(lengths):
            if ln <= 0:
                continue
            entry = marker[ln]
            if ln < 32 and (entry >> ln):
                raise InvalidData("vorbis: codebook overspecified")
            self.table[(ln, entry)] = i
            for j in range(ln, 0, -1):
                if marker[j] & 1:
                    if j == 1:
                        marker[1] += 1
                    else:
                        marker[j] = marker[j - 1] << 1
                    break
                marker[j] += 1
            for j in range(ln + 1, 33):
                if (marker[j] >> 1) == entry:
                    entry = marker[j]
                    marker[j] = marker[j - 1] << 1
                else:
                    break
        self.max_len = max((ln for ln, _ in self.table), default=0)

    def decode(self, b: LsbBits) -> int:
        acc = 0
        for ln in range(1, self.max_len + 1):
            acc = (acc << 1) | b.get1()
            e = self.table.get((ln, acc))
            if e is not None:
                return e
        raise InvalidData("vorbis: invalid codeword")


class Floor1:
    def __init__(self, b: LsbBits):
        parts = b.get(5)
        self.part_class = [b.get(4) for _ in range(parts)]
        n_classes = max(self.part_class) + 1 if parts else 0
        self.class_dim = []
        self.class_sub = []
        self.class_master = []
        self.sub_books = []
        for _ in range(n_classes):
            self.class_dim.append(b.get(3) + 1)
            sub = b.get(2)
            self.class_sub.append(sub)
            self.class_master.append(b.get(8) if sub else 0)
            self.sub_books.append(
                [b.get(8) - 1 for _ in range(1 << sub)])
        self.multiplier = b.get(2) + 1
        rangebits = b.get(4)
        xs = [0, 1 << rangebits]
        for p in range(parts):
            for _ in range(self.class_dim[self.part_class[p]]):
                xs.append(b.get(rangebits))
        self.x_list = xs
        # sorted order for curve synthesis
        self.sort_idx = sorted(range(len(xs)), key=lambda i: xs[i])

    def decode(self, b: LsbBits, books) -> Optional[list]:
        if not b.get1():
            return None
        rng = [256, 128, 86, 64][self.multiplier - 1]
        ys = [b.get(ilog(rng - 1)), b.get(ilog(rng - 1))]
        for p, cls in enumerate(self.part_class):
            cdim = self.class_dim[cls]
            cbits = self.class_sub[cls]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits:
                cval = books[self.class_master[cls]].decode(b)
            for _ in range(cdim):
                book = self.sub_books[cls][cval & csub]
                cval >>= cbits
                if book >= 0:
                    ys.append(books[book].decode(b))
                else:
                    ys.append(0)
        return ys

    def synth(self, ys, n):
        """Floor curve (spec 7.2.3/7.2.4), exact integer math."""
        rng = [256, 128, 86, 64][self.multiplier - 1]
        xs = self.x_list
        npts = len(xs)
        step2 = [False] * npts
        final_y = [0] * npts
        step2[0] = step2[1] = True
        final_y[0] = ys[0]
        final_y[1] = ys[1]
        for i in range(2, npts):
            lo = _low_neighbor(xs, i)
            hi = _high_neighbor(xs, i)
            pred = _render_point(xs[lo], final_y[lo], xs[hi],
                                 final_y[hi], xs[i])
            val = ys[i]
            high_room = rng - pred
            low_room = pred
            room = 2 * min(high_room, low_room)
            if val:
                step2[lo] = True
                step2[hi] = True
                step2[i] = True
                if val >= room:
                    if high_room > low_room:
                        final_y[i] = val - low_room + pred
                    else:
                        final_y[i] = pred - val + high_room - 1
                else:
                    if val & 1:
                        final_y[i] = pred - ((val + 1) >> 1)
                    else:
                        final_y[i] = pred + (val >> 1)
            else:
                step2[i] = False
                final_y[i] = pred
        # render in sorted order
        out = np.zeros(n, np.int32)
        sidx = self.sort_idx
        # clamp final_y
        fy = [max(0, min(rng - 1, v)) for v in final_y]
        hx = 0
        hy = 0
        lx = 0
        ly = fy[sidx[0]] * self.multiplier
        for k in sidx:
            if step2[k]:
                hy = fy[k] * self.multiplier
                hx = xs[k]
                if lx < n:
                    _render_line(lx, ly, min(hx, n), hy, out, n)
                lx, ly = hx, hy
        if hx < n:
            _render_line(hx, hy, n, hy, out, n)
        curve = INVERSE_DB_TABLE[np.clip(out, 0, 255)].astype(
            np.float64)
        if hx > n:
            pass
        return curve


def _low_neighbor(v, i):
    best = -1
    for j in range(i):
        if v[j] < v[i] and (best < 0 or v[j] > v[best]):
            best = j
    return best


def _high_neighbor(v, i):
    best = -1
    for j in range(i):
        if v[j] > v[i] and (best < 0 or v[j] < v[best]):
            best = j
    return best


def _render_point(x0, y0, x1, y1, x):
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    err = ady * (x - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def _render_line(x0, y0, x1, y1, v, n):
    dy = y1 - y0
    adx = x1 - x0
    if adx <= 0:
        return
    ady = abs(dy)
    base = abs(dy) // adx * (1 if dy >= 0 else -1)
    sy = base + 1 if dy >= 0 else base - 1
    x = x0
    y = y0
    err = 0
    ady -= abs(base) * adx
    if x0 < n:
        v[x0] = y
    for x in range(x0 + 1, min(x1, n)):
        err += ady
        if err >= adx:
            err -= adx
            y += sy
        else:
            y += base
        v[x] = y


class Residue:
    def __init__(self, b: LsbBits, rtype: int):
        self.type = rtype
        self.begin = b.get(24)
        self.end = b.get(24)
        self.part_size = b.get(24) + 1
        self.n_class = b.get(6) + 1
        self.classbook = b.get(8)
        cascades = []
        for _ in range(self.n_class):
            low = b.get(3)
            high = b.get(5) if b.get1() else 0
            cascades.append((high << 3) | low)
        self.cascades = cascades
        self.books = []
        for c in range(self.n_class):
            row = []
            for p in range(8):
                row.append(b.get(8) if cascades[c] & (1 << p) else -1)
            self.books.append(row)

    def decode(self, b: LsbBits, books, n, do_decode):
        """→ list of per-channel vectors (length n). do_decode: bools
        per channel; type 2 interleaves channels (spec 8.6.2)."""
        ch = len(do_decode)
        if self.type == 2:
            vec_n = n * ch
            n_vec = 1
            actives = [any(do_decode)]
        else:
            vec_n = n
            n_vec = ch
            actives = list(do_decode)
        out = [np.zeros(vec_n, np.float64) for _ in range(n_vec)]
        begin = min(self.begin, vec_n)
        end = min(self.end, vec_n)
        if end <= begin:
            return self._deinterleave(out, ch, n)
        classbook = books[self.classbook]
        cw = classbook.dim                # classwords per codeword
        n_parts = (end - begin) // self.part_size
        cls = [[0] * n_parts for _ in range(n_vec)]
        for p in range(8):
            part = 0
            while part < n_parts:
                if p == 0:
                    for j in range(n_vec):
                        if not actives[j]:
                            continue
                        temp = classbook.decode(b)
                        for i in range(cw - 1, -1, -1):
                            if part + i < n_parts:
                                cls[j][part + i] = \
                                    temp % self.n_class
                            temp //= self.n_class
                for i in range(cw):
                    if part >= n_parts:
                        break
                    for j in range(n_vec):
                        if not actives[j]:
                            continue
                        book_i = self.books[cls[j][part]][p]
                        if book_i < 0:
                            continue
                        book = books[book_i]
                        off = begin + part * self.part_size
                        self._partition(b, book, out[j], off)
                    part += 1
        return self._deinterleave(out, ch, n)

    def _partition(self, b, book, v, off):
        dim = book.dim
        psize = self.part_size
        if self.type == 0:
            step = psize // dim
            for i in range(step):
                e = book.decode(b)
                vq = book.vq[e]
                for d in range(dim):
                    v[off + i + d * step] += vq[d]
        else:                             # types 1 and 2
            k = 0
            while k < psize:
                e = book.decode(b)
                vq = book.vq[e]
                v[off + k:off + k + dim] += vq
                k += dim

    def _deinterleave(self, out, ch, n):
        if self.type != 2:
            return out
        v = out[0]
        return [v[c::ch].copy() for c in range(ch)]


class Mapping:
    def __init__(self, b: LsbBits, ch, n_floors, n_residues):
        self.submaps = (b.get(4) + 1) if b.get1() else 1
        self.coupling = []
        if b.get1():
            steps = b.get(8) + 1
            bits = ilog(ch - 1)
            for _ in range(steps):
                m = b.get(bits)
                a = b.get(bits)
                if m == a or m >= ch or a >= ch:
                    raise InvalidData("vorbis: bad coupling")
                self.coupling.append((m, a))
        if b.get(2):
            raise InvalidData("vorbis: mapping reserved bits")
        if self.submaps > 1:
            self.mux = [b.get(4) for _ in range(ch)]
        else:
            self.mux = [0] * ch
        self.floor = []
        self.residue = []
        for _ in range(self.submaps):
            b.get(8)                      # unused time config
            f = b.get(8)
            r = b.get(8)
            if f >= n_floors or r >= n_residues:
                raise InvalidData("vorbis: bad submap index")
            self.floor.append(f)
            self.residue.append(r)


def _vorbis_slope(ln: int) -> np.ndarray:
    i = np.arange(ln // 2) + 0.5
    return np.sin(0.5 * np.pi
                  * np.sin(i / ln * np.pi) ** 2)


@register_decoder
class VorbisDecoder(Codec):
    codec_id = "vorbis"
    codec_type = MediaType.AUDIO

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = audio_tx.open_device(device)
        self.stats: Optional[list] = None
        self._headers_done = False
        self._saved = None
        self._prev_n = 0
        self._first = True
        ed = par.extradata or b""
        if ed:
            for pktdata in _split_xiph(ed):
                self._header(pktdata)

    # -- setup ----------------------------------------------------------
    def _header(self, data: bytes):
        if len(data) < 7 or data[1:7] != b"vorbis":
            raise InvalidData("vorbis: bad header packet")
        kind = data[0]
        b = LsbBits(data[7:])
        if kind == 1:
            if b.get(32) != 0:
                raise InvalidData("vorbis: bad version")
            self.channels = b.get(8)
            self.sample_rate = b.get(32)
            b.get(32), b.get(32), b.get(32)   # bitrates
            self.blocksize = [1 << b.get(4), 0]
            self.blocksize[1] = 1 << b.get(4)
            if not b.get1():
                raise InvalidData("vorbis: bad framing")
        elif kind == 3:
            pass                          # comments: ignored
        elif kind == 5:
            self._setup(b)
            self._headers_done = True
        else:
            raise InvalidData("vorbis: unknown header type")

    def _setup(self, b: LsbBits):
        self.books = [Codebook(b) for _ in range(b.get(8) + 1)]
        for _ in range(b.get(6) + 1):     # time transforms
            if b.get(16):
                raise InvalidData("vorbis: bad time transform")
        self.floors = []
        for _ in range(b.get(6) + 1):
            ftype = b.get(16)
            if ftype != 1:
                raise NotSupported("vorbis: floor type 0")
            self.floors.append(Floor1(b))
        self.residues = []
        for _ in range(b.get(6) + 1):
            rtype = b.get(16)
            if rtype > 2:
                raise InvalidData("vorbis: bad residue type")
            self.residues.append(Residue(b, rtype))
        self.mappings = []
        for _ in range(b.get(6) + 1):
            if b.get(16):
                raise InvalidData("vorbis: bad mapping type")
            self.mappings.append(Mapping(b, self.channels,
                                         len(self.floors),
                                         len(self.residues)))
        self.modes = []
        for _ in range(b.get(6) + 1):
            blockflag = b.get1()
            if b.get(16) or b.get(16):
                raise InvalidData("vorbis: bad mode transform")
            mapping = b.get(8)
            if mapping >= len(self.mappings):
                raise InvalidData("vorbis: bad mode mapping")
            self.modes.append((blockflag, mapping))
        if not b.get1():
            raise InvalidData("vorbis: bad setup framing")

    # -- audio ----------------------------------------------------------
    def _audio(self, data: bytes):
        timer = audio_tx.start(self.device, self.stats)
        b = LsbBits(data)
        if b.get1():
            return None                   # not an audio packet
        mode_i = b.get(ilog(len(self.modes) - 1)) \
            if len(self.modes) > 1 else 0
        blockflag, map_i = self.modes[mode_i]
        n = self.blocksize[blockflag]
        prev_f = next_f = 1
        if blockflag:
            prev_f = b.get1()
            next_f = b.get1()
        mp = self.mappings[map_i]
        ch = self.channels
        half = n // 2

        floors = []
        no_res = []
        for c in range(ch):
            sub = mp.mux[c]
            fl = self.floors[mp.floor[sub]]
            ys = fl.decode(b, self.books)
            floors.append((fl, ys))
            no_res.append(ys is None)
        for m, a in mp.coupling:
            if not (no_res[m] and no_res[a]):
                no_res[m] = no_res[a] = False
        spec = [np.zeros(half, np.float64) for _ in range(ch)]
        for sub in range(mp.submaps):
            chans = [c for c in range(ch) if mp.mux[c] == sub]
            do_dec = [not no_res[c] for c in chans]
            res = self.residues[mp.residue[sub]]
            vecs = res.decode(b, self.books, half, do_dec)
            for i, c in enumerate(chans):
                spec[c] = vecs[i]
        # inverse coupling (spec 4.3.5)
        for m, a in reversed(mp.coupling):
            mag = spec[m]
            ang = spec[a]
            new_m = mag.copy()
            new_a = ang.copy()
            pos = mag > 0
            apos = ang > 0
            new_a[pos & apos] = (mag - ang)[pos & apos]
            new_m[pos & ~apos] = (mag + ang)[pos & ~apos]
            new_a[pos & ~apos] = mag[pos & ~apos]
            new_a[~pos & apos] = (mag + ang)[~pos & apos]
            new_m[~pos & ~apos] = (mag - ang)[~pos & ~apos]
            new_a[~pos & ~apos] = mag[~pos & ~apos]
            spec[m] = new_m
            spec[a] = new_a
        # floor multiply + IMDCT (one device call over the packet's
        # channels) + window
        pcm = np.zeros((ch, n), np.float64)
        coded = [c for c in range(ch) if floors[c][1] is not None]
        if coded:
            s = np.stack([spec[c] * floors[c][0].synth(floors[c][1], half)
                          for c in coded])
            pcm[coded] = audio_tx.run(
                lambda x: tx.imdct(x, half, scale=1.0), s, self.device,
                timer, self.stats)
        win = self._window(n, prev_f, next_f)
        pcm *= win[None, :]
        # overlap-add
        if self._first:
            self._first = False
            self._saved = pcm[:, half:].copy()
            self._prev_n = n
            return None
        prev_n = self._prev_n
        ret = (prev_n + n) // 4
        out = np.zeros((ch, ret), np.float64)
        sv = self._saved
        m = min(ret, sv.shape[1])
        out[:, :m] += sv[:, :m]
        start = max(0, ret - half)
        out[:, start:] += pcm[:, start + half - ret:half]
        self._saved = pcm[:, half:].copy()
        self._prev_n = n
        return out

    def _window(self, n, prev_f, next_f):
        b0 = self.blocksize[0]
        w = np.zeros(n, np.float64)
        left_n = n if prev_f else b0
        right_n = n if next_f else b0
        ls = n // 4 - left_n // 4
        sl = _vorbis_slope(left_n)
        w[ls:ls + left_n // 2] = sl
        rs = n // 2 + n // 4 - right_n // 4
        w[ls + left_n // 2:rs] = 1.0
        w[rs:rs + right_n // 2] = sl[::-1] if right_n == left_n \
            else _vorbis_slope(right_n)[::-1]
        return w

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        data = pkt.data
        if not self._headers_done:
            if data and data[0] in (1, 3, 5):
                self._header(data)
                return []
            raise InvalidData("vorbis: missing headers")
        out = self._audio(data)
        if out is None or out.shape[1] == 0:
            return []
        f = Frame.audio(out.astype(np.float32), self.sample_rate,
                        "fltp", pts=pkt.pts,
                        time_base=pkt.time_base
                        or Rational(1, self.sample_rate))
        return [f]

    def flush_state(self):
        self._saved = None
        self._prev_n = 0
        self._first = True


def _split_xiph(ed: bytes):
    """Xiph-laced extradata (matroska CodecPrivate): count-1 byte, then
    255-run lengths, then the header packets."""
    if not ed:
        return []
    n = ed[0] + 1
    pos = 1
    sizes = []
    for _ in range(n - 1):
        v = 0
        while True:
            c = ed[pos]
            pos += 1
            v += c
            if c != 255:
                break
        sizes.append(v)
    out = []
    for s in sizes:
        out.append(ed[pos:pos + s])
        pos += s
    out.append(ed[pos:])
    return out
