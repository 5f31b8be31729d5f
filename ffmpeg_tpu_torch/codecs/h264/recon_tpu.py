"""H.264 picture reconstruction on the decoder's device, in PyTorch.

The port of ffmpeg_tpu/codecs/h264/recon_tpu.py (the device path of the
host-entropy / device-transform split).  From the parse arrays of a
SliceDecoder it computes, as the reference's program does:

  1. the residual: every 4x4 (and 8x8) block's exact integer inverse
     transform at once, assembled into full int32 residual planes;
  2. inter: per reference picture the three half-pel planes (b/h/j of
     spec 8.4.2.2.1) over the whole edge-replicated plane, then two
     gathers per luma sample chosen by its quarter-pel phase and four
     per chroma sample (bilinear), combined by the weighted-prediction
     arrays (8.4.2.3);
  3. intra: a wavefront over the macroblock diagonals d = mbx + 2*mby
     (the skew 2 covers the top-right dependency): at each step
     I_16x16 and chroma per macroblock, the four I_8x8 blocks in z-order
     and the ten I_NxN substeps (sx + 2*sy);
  4. deblocking: a second wavefront over the same diagonals: the four
     vertical luma edges in order with the chroma edges at e in {0, 2},
     then the four horizontal edges.  Boundary strengths and the
     alpha/beta/tc0 thresholds come from the parse on the host
     (deblock_params), the device does the sample math.

Byte-exact with the host path (recon_host.py, loopfilter.py).  Exact
integer math on int32 tensors throughout (the transforms are integer
butterflies, no matmul; torch's >> on int32 is arithmetic, as JAX's).

Where the reference's program differs by being one compiled program
(jitted once per geometry, `_get_recon`), the port runs eagerly:
 * the wavefront steps are a loop on the host over only the diagonals
   that hold an intra macroblock (intra) or a filtered edge (deblock),
   with exact lane lists: the reference scans every diagonal with a
   fixed lane count and masks lanes off;
 * which kinds and substeps a step runs, which intra modes a batch
   computes and which deblocking branch (bS 4 or bS < 4) an edge needs
   are read from the host's copy of the parse; an edge whose bS is 0 on
   every lane is skipped (it changes no sample);
 * the blocks of one I_NxN substep (sx + 2*sy = s) are independent of
   each other, so they run as one batch (the reference runs them one
   after another);
 * the reference vectors of intra blocks (their neighbours' flat
   indices, edge-clamped as the reference's gathers, the top-right
   substitution applied) are resolved on the host; an I_NxN block's
   mode and DC variant select one row of a tap table, so every I_NxN
   batch is one gather, one product and one shift;
 * the reference's `mode="drop"` scatters of masked lanes have no
   counterpart: a lane that would not write is not in the batch, and
   every block written lies inside its plane (the picture is a
   multiple of 16); an edge at the picture's left or top border is
   never in a batch (its bS is 0 and the reference drops its writes);
 * the reference stacks the DPB's planes on the host every picture
   (`dpb_y/u/v`); here they are the DPB's own tensors, stacked on the
   device.

`reconstruct` also runs error concealment between reconstruction and
deblocking, as the reference's host path does (the reference's device
program skips it): on a damaged picture (not every macroblock decoded)
the reconstructed planes and the reference picture are copied to the
host, `conceal.conceal_missing` fills the holes, the planes go back,
and the deblocking parameters are computed after it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..vp9.recon_tpu import _Timer, _const
from . import tables as T
from .conceal import conceal_missing

# ---------------------------------------------------------------------------
# intra 4x4 mode tables: value = (w0*r[i0] + w1*r[i1] + w2*r[i2] + rnd) >> sh
# over the reference vector r = [l0..l3, tl, t0..t3, tr0..tr3].


def _gen_i4_tables():
    idx = np.zeros((9, 16, 3), np.int32)
    w = np.zeros((9, 16, 3), np.int32)
    sh = np.zeros((9, 16), np.int32)

    def Tk(k):
        return 4 if k < 0 else 5 + k

    def Lk(k):
        return 4 if k < 0 else k

    for j in range(4):
        for i in range(4):
            p = j * 4 + i
            idx[0, p], w[0, p], sh[0, p] = (5 + i, 0, 0), (1, 0, 0), 0
            idx[1, p], w[1, p], sh[1, p] = (j, 0, 0), (1, 0, 0), 0
            # mode 3: diagonal down-left
            k = i + j
            idx[3, p] = (11, 12, 12) if k == 6 else (5 + k, 6 + k, 7 + k)
            w[3, p], sh[3, p] = (1, 2, 1), 2
            # mode 4: diagonal down-right
            if i > j:
                k = i - j
                idx[4, p] = (Tk(k - 2), Tk(k - 1), Tk(k))
            elif i < j:
                k = j - i
                idx[4, p] = (Lk(k - 2), Lk(k - 1), Lk(k))
            else:
                idx[4, p] = (5, 4, 0)
            w[4, p], sh[4, p] = (1, 2, 1), 2
            # mode 5: vertical-right
            z = 2 * i - j
            if z >= 0 and z % 2 == 0:
                k = i - (j >> 1)
                idx[5, p], w[5, p], sh[5, p] = \
                    (Tk(k - 1), Tk(k), 0), (1, 1, 0), 1
            elif z > 0:
                k = i - (j >> 1)
                idx[5, p], w[5, p], sh[5, p] = \
                    (Tk(k - 2), Tk(k - 1), Tk(k)), (1, 2, 1), 2
            elif z == -1:
                idx[5, p], w[5, p], sh[5, p] = (0, 4, 5), (1, 2, 1), 2
            else:
                k = j - 2 * i
                idx[5, p], w[5, p], sh[5, p] = \
                    (Lk(k - 1), Lk(k - 2), Lk(k - 3)), (1, 2, 1), 2
            # mode 6: horizontal-down
            z = 2 * j - i
            if z >= 0 and z % 2 == 0:
                k = j - (i >> 1)
                idx[6, p], w[6, p], sh[6, p] = \
                    (Lk(k - 1), Lk(k), 0), (1, 1, 0), 1
            elif z > 0:
                k = j - (i >> 1)
                idx[6, p], w[6, p], sh[6, p] = \
                    (Lk(k - 2), Lk(k - 1), Lk(k)), (1, 2, 1), 2
            elif z == -1:
                idx[6, p], w[6, p], sh[6, p] = (5, 4, 0), (1, 2, 1), 2
            else:
                k = i - 2 * j
                idx[6, p], w[6, p], sh[6, p] = \
                    (Tk(k - 1), Tk(k - 2), Tk(k - 3)), (1, 2, 1), 2
            # mode 7: vertical-left
            k = i + (j >> 1)
            if j % 2 == 0:
                idx[7, p], w[7, p], sh[7, p] = \
                    (5 + k, 6 + k, 0), (1, 1, 0), 1
            else:
                idx[7, p], w[7, p], sh[7, p] = \
                    (5 + k, 6 + k, 7 + k), (1, 2, 1), 2
            # mode 8: horizontal-up
            z = i + 2 * j
            if z > 5:
                idx[8, p], w[8, p], sh[8, p] = (3, 0, 0), (1, 0, 0), 0
            elif z == 5:
                idx[8, p], w[8, p], sh[8, p] = (2, 3, 3), (1, 2, 1), 2
            elif z % 2 == 0:
                k = j + (i >> 1)
                idx[8, p], w[8, p], sh[8, p] = (k, k + 1, 0), (1, 1, 0), 1
            else:
                k = j + (i >> 1)
                idx[8, p], w[8, p], sh[8, p] = \
                    (k, k + 1, k + 2), (1, 2, 1), 2
    return idx, w, sh


_I4_IDX, _I4_W, _I4_SH = _gen_i4_tables()


# ---------------------------------------------------------------------------
# Intra_8x8 mode tables over the FILTERED reference vector
# r = [lf0..lf7 (0..7), tlf (8), tf0..tf15 (9..24)] (spec 8.3.2.2.2-10;
# mirrors recon.pred8x8's per-pixel formulas; DC handled separately).


def _gen_i8_tables():
    idx = np.zeros((9, 64, 3), np.int32)
    w = np.zeros((9, 64, 3), np.int32)
    sh = np.zeros((9, 64), np.int32)

    def Tk(k):
        return 8 if k < 0 else 9 + k

    def Lk(k):
        return 8 if k < 0 else k

    for j in range(8):
        for i in range(8):
            p = j * 8 + i
            idx[0, p], w[0, p], sh[0, p] = (Tk(i), 0, 0), (1, 0, 0), 0
            idx[1, p], w[1, p], sh[1, p] = (Lk(j), 0, 0), (1, 0, 0), 0
            # mode 3: diagonal down-left
            k = i + j
            idx[3, p] = (Tk(14), Tk(15), Tk(15)) if k == 14 else \
                (Tk(k), Tk(k + 1), Tk(k + 2))
            w[3, p], sh[3, p] = (1, 2, 1), 2
            # mode 4: diagonal down-right
            if i > j:
                k = i - j
                idx[4, p] = (Tk(k - 2), Tk(k - 1), Tk(k))
            elif i < j:
                k = j - i
                idx[4, p] = (Lk(k - 2), Lk(k - 1), Lk(k))
            else:
                idx[4, p] = (Tk(0), 8, Lk(0))
            w[4, p], sh[4, p] = (1, 2, 1), 2
            # mode 5: vertical-right
            z = 2 * i - j
            k = i - (j >> 1)
            if z >= 0 and z % 2 == 0:
                idx[5, p], w[5, p], sh[5, p] = \
                    (Tk(k - 1), Tk(k), 0), (1, 1, 0), 1
            elif z > 0:
                idx[5, p], w[5, p], sh[5, p] = \
                    (Tk(k - 2), Tk(k - 1), Tk(k)), (1, 2, 1), 2
            elif z == -1:
                idx[5, p], w[5, p], sh[5, p] = \
                    (Lk(0), 8, Tk(0)), (1, 2, 1), 2
            else:
                k = j - 2 * i
                idx[5, p], w[5, p], sh[5, p] = \
                    (Lk(k - 1), Lk(k - 2), Lk(k - 3)), (1, 2, 1), 2
            # mode 6: horizontal-down
            z = 2 * j - i
            k = j - (i >> 1)
            if z >= 0 and z % 2 == 0:
                idx[6, p], w[6, p], sh[6, p] = \
                    (Lk(k - 1), Lk(k), 0), (1, 1, 0), 1
            elif z > 0:
                idx[6, p], w[6, p], sh[6, p] = \
                    (Lk(k - 2), Lk(k - 1), Lk(k)), (1, 2, 1), 2
            elif z == -1:
                idx[6, p], w[6, p], sh[6, p] = \
                    (Tk(0), 8, Lk(0)), (1, 2, 1), 2
            else:
                k = i - 2 * j
                idx[6, p], w[6, p], sh[6, p] = \
                    (Tk(k - 1), Tk(k - 2), Tk(k - 3)), (1, 2, 1), 2
            # mode 7: vertical-left
            k = i + (j >> 1)
            if j % 2 == 0:
                idx[7, p], w[7, p], sh[7, p] = \
                    (Tk(k), Tk(k + 1), 0), (1, 1, 0), 1
            else:
                idx[7, p], w[7, p], sh[7, p] = \
                    (Tk(k), Tk(k + 1), Tk(k + 2)), (1, 2, 1), 2
            # mode 8: horizontal-up
            z = i + 2 * j
            k = j + (i >> 1)
            if z > 13:
                idx[8, p], w[8, p], sh[8, p] = (Lk(7), 0, 0), (1, 0, 0), 0
            elif z == 13:
                idx[8, p], w[8, p], sh[8, p] = \
                    (Lk(6), Lk(7), Lk(7)), (1, 2, 1), 2
            elif z % 2 == 0:
                idx[8, p], w[8, p], sh[8, p] = \
                    (Lk(k), Lk(k + 1), 0), (1, 1, 0), 1
            else:
                idx[8, p], w[8, p], sh[8, p] = \
                    (Lk(k), Lk(k + 1), Lk(k + 2)), (1, 2, 1), 2
    return idx, w, sh


_I8_IDX, _I8_W, _I8_SH = _gen_i8_tables()


def _tap_tables(idx, w, sh, dc_sets, n_ref):
    """One table row per kind: the nine modes' taps (mode 2 unused),
    then the DC variants (both neighbours, left only, top only, none),
    each a mean over `dc_sets[v]` of the reference vector.  Returns
    (idx [13, P, K] int64, w [13, P, K] int32, rnd_sh [13, P, 2] int32)
    with K the widest kind's taps; a tap of weight 0 reads r[0]."""
    P = idx.shape[1]
    K = max(3, max(len(s) for s in dc_sets))
    ti = np.zeros((13, P, K), np.int64)
    tw = np.zeros((13, P, K), np.int32)
    rnd = np.zeros((13, P), np.int32)
    shp = np.zeros((13, P), np.int32)
    tw[:9, :, :3] = w
    ti[:9, :, :3] = np.where(w > 0, idx, 0)
    shp[:9] = sh
    rnd[:9] = (1 << sh) >> 1
    for v, taps in enumerate(dc_sets):
        n = len(taps)
        ti[9 + v, :, :n] = taps
        tw[9 + v, :, :n] = 1
        shp[9 + v] = n.bit_length() - 1 if n else 0
        rnd[9 + v] = n >> 1 if n else 128
    assert ti.max() < n_ref
    return ti, tw, np.stack([rnd, shp], -1)


# I_NxN: r = [l0..l3, tl, t0..t3, tr0..tr3]; DC (8.3.1.2.3) over l and t
_I4_TAB = _tap_tables(_I4_IDX, _I4_W, _I4_SH,
                      [[0, 1, 2, 3, 5, 6, 7, 8], [0, 1, 2, 3],
                       [5, 6, 7, 8], []], 13)
# I_8x8: r = [lf0..lf7, tlf, tf0..tf15]; DC over lf and tf0..tf7
_I8_TAB = _tap_tables(_I8_IDX, _I8_W, _I8_SH,
                      [list(range(8)) + list(range(9, 17)),
                       list(range(8)), list(range(9, 17)), []], 25)

# quarter-pel case table: phase yf*4+xf -> (plane1, dy1, dx1,
# plane2, dy2, dx2); result = (v1 + v2 + 1) >> 1 (duplicated entries make
# the plain cases exact too). Planes: 0=G int-pel, 1=B h-half, 2=H v-half,
# 3=J center (libavcodec/h264qpel_template.c case split).
_QPEL_CASES = np.array([
    # xf = 0..3 for each yf row
    (0, 0, 0, 0, 0, 0), (0, 0, 0, 1, 0, 0),
    (1, 0, 0, 1, 0, 0), (1, 0, 0, 0, 0, 1),      # yf=0
    (0, 0, 0, 2, 0, 0), (1, 0, 0, 2, 0, 0),
    (1, 0, 0, 3, 0, 0), (1, 0, 0, 2, 0, 1),      # yf=1
    (2, 0, 0, 2, 0, 0), (2, 0, 0, 3, 0, 0),
    (3, 0, 0, 3, 0, 0), (2, 0, 1, 3, 0, 0),      # yf=2
    (2, 0, 0, 0, 1, 0), (1, 1, 0, 2, 0, 0),
    (1, 1, 0, 3, 0, 0), (1, 1, 0, 2, 0, 1),      # yf=3
], np.int64)

_PAD = 32        # luma replication pad (covers any mv: beyond it the
_PAD_C = 16      # filters see constant rows/cols == the spec's edge clamp)


# ---------------------------------------------------------------------------
# the host side: a packer for the device arguments


class _Pack:
    """Collects host arrays into one buffer per dtype, so that a
    picture's arguments go to the device in a few copies; `get` returns
    a view of the device buffer by the handle `add` gave."""

    def __init__(self):
        self.parts: Dict[np.dtype, list] = {}
        self.size: Dict[np.dtype, int] = {}
        self.bufs: Dict[np.dtype, torch.Tensor] = {}

    def add(self, a, dtype):
        dt = np.dtype(dtype)
        a = np.ascontiguousarray(a, dt)
        off = self.size.get(dt, 0)
        self.parts.setdefault(dt, []).append(a.reshape(-1))
        self.size[dt] = off + a.size
        return (dt, off, a.shape)

    def nbytes(self) -> int:
        return sum(n * dt.itemsize for dt, n in self.size.items())

    def to(self, device):
        for dt, parts in self.parts.items():
            self.bufs[dt] = torch.from_numpy(np.concatenate(parts)).to(
                device)
        self.parts = {}

    def get(self, h):
        dt, off, shape = h
        n = int(np.prod(shape, dtype=np.int64))
        return self.bufs[dt][off:off + n].view(shape)


def _ranges(key, queries):
    """[(a, b)] of each query's run in the sorted `key`."""
    a = np.searchsorted(key, queries, "left")
    b = np.searchsorted(key, queries, "right")
    return list(zip(a.tolist(), b.tolist()))


def _runs(d_sorted, steps, sub, n_sub):
    """For lanes sorted by (d, sub): the (a, b) of every (step, sub)."""
    key = d_sorted * n_sub + sub
    q = (np.asarray(steps, np.int64)[:, None] * n_sub
         + np.arange(n_sub)[None, :]).reshape(-1)
    r = _ranges(key, q)
    return [r[i * n_sub:(i + 1) * n_sub] for i in range(len(steps))]


class FrameArgs:
    """A picture's device arguments: the geometry, the packed buffers
    (`pack`), the coefficients, the motion and weight arrays and the
    DPB stack, the PCM planes, the intra wavefront's steps and batches
    (host ints and buffer handles)."""

    def __init__(self, nmbx, nmby):
        self.nmbx, self.nmby = nmbx, nmby
        self.H, self.W = nmby * 16, nmbx * 16
        self.Hc, self.Wc = self.H // 2, self.W // 2
        self.pack = _Pack()
        self.h: dict = {}            # name -> handle into pack
        self.dpb = None              # (y, u, v) [R, h, w] on the device
        self.lists_used = (False, False)
        self.has_pcm = False
        self.trans8 = False
        self.steps: List[int] = []
        self.plan: list = []         # per step: runs per kind
        self.modes16: set = set()
        self.modesc: set = set()

    def nbytes(self) -> int:
        return self.pack.nbytes()


def _clip(a, hi):
    return np.clip(a, 0, hi)


def _mb_ref_index(x0, y0, n, h, w):
    """Flat indices of the reference samples [tl, top0..n-1,
    left0..n-1] of the n x n blocks at (x0, y0) in an h x w plane,
    edge-clamped as the reference's gathers: [K, 2n+1]."""
    rt, rc, a = _clip(y0 - 1, h - 1), _clip(x0 - 1, w - 1), np.arange(n)
    return np.concatenate([(rt * w + rc)[:, None],
                           rt[:, None] * w + x0[:, None] + a,
                           (y0[:, None] + a) * w + rc[:, None]], 1)


def _by_diagonal(mask, per_mb, sub=None):
    """The (row, col) of mask's true cells sorted by the diagonal
    d = mbx + 2*mby of their macroblock (per_mb cells a side), then by
    `sub` of (row, col); returns (rows, cols, d)."""
    r, c = np.nonzero(mask)
    d = c // per_mb + 2 * (r // per_mb)
    o = np.lexsort((sub(r, c), d)) if sub else np.argsort(d, kind="stable")
    return r[o], c[o], d[o]


def _dc_kind(mode, av):
    """A block's tap-table row: its mode, or for DC (2) the variant by
    the left (av[:, 0]) and top (av[:, 1]) neighbours' availability."""
    return np.where(mode == 2, 9 + (~av[:, 1]) + 2 * (~av[:, 0]), mode)


def _intra_args(fa: FrameArgs, dec):
    """The intra wavefront's batches: each kind's lanes sorted by
    diagonal (and substep), with their reference-sample indices."""
    H, W, Hc, Wc = fa.H, fa.W, fa.Hc, fa.Wc
    intra_mb = dec.mb_intra & dec.mb_avail & ~dec.is_pcm
    mby, mbx = np.nonzero(intra_mb)
    if mby.size == 0:
        return
    steps = np.unique(mbx + 2 * mby)
    fa.steps = steps.tolist()
    p = fa.pack
    nbr = dec.mb_nbr_avail

    # I_16x16, one lane per macroblock
    y_, x_, d = _by_diagonal(intra_mb & (dec.i16_mode >= 0), 1)
    mode = np.clip(dec.i16_mode[y_, x_], 0, 3)
    fa.modes16 = set(np.unique(mode).tolist())
    fa.h["i16"] = (p.add(y_ * 16 * W + x_ * 16, np.int64),
                   p.add(_mb_ref_index(x_ * 16, y_ * 16, 16, H, W),
                         np.int64),
                   p.add(np.stack([mode, nbr[y_, x_, 0], nbr[y_, x_, 1]]),
                         np.int32))
    r16 = _runs(d, steps, np.zeros_like(d), 1)

    # chroma, one lane per macroblock and plane (u then v)
    y_, x_, d = (np.repeat(a, 2) for a in _by_diagonal(intra_mb, 1))
    po = np.tile([0, Hc * Wc], len(y_) // 2)
    mode = np.clip(dec.chroma_imode[y_, x_], 0, 3)
    fa.modesc = set(np.unique(mode).tolist())
    fa.h["chroma"] = (p.add(po + y_ * 8 * Wc + x_ * 8, np.int64),
                      p.add(_mb_ref_index(x_ * 8, y_ * 8, 8, Hc, Wc)
                            + po[:, None], np.int64),
                      p.add(np.stack([mode, nbr[y_, x_, 0],
                                      nbr[y_, x_, 1]]), np.int32))
    rc = _runs(d, steps, np.zeros_like(d), 1)

    # I_8x8 blocks, sorted by (diagonal, z-order)
    def z8(r, c):
        return (c & 1) + 2 * (r & 1)
    by8, bx8, d = _by_diagonal(np.repeat(np.repeat(intra_mb, 2, 0), 2, 1)
                               & (dec.i8_pred >= 0), 2, z8)
    px, py = bx8 * 8, by8 * 8
    av = dec.blk8_avail[by8, bx8]
    a16 = np.arange(16)
    rt, lc = _clip(py - 1, H - 1), _clip(px - 1, W - 1)
    top = rt[:, None] * W + _clip(px[:, None] + a16, W - 1)
    # without the top-right, t8..t15 repeat t7 (8.3.2.2.1)
    top = np.where(av[:, 2:3] | (a16 < 8), top, top[:, 7:8])
    ridx = np.concatenate([(py[:, None] + np.arange(8)) * W + lc[:, None],
                           (rt * W + lc)[:, None], top], 1)
    kind = _dc_kind(np.clip(dec.i8_pred[by8, bx8], 0, 8), av)
    fa.h["i8"] = (p.add(py * W + px, np.int64), p.add(ridx, np.int64),
                  p.add(np.stack([kind, av[:, 0], av[:, 1], av[:, 3]]),
                        np.int32))
    r8 = _runs(d, steps, z8(by8, bx8), 4)

    # I_NxN blocks, sorted by (diagonal, substep sx + 2*sy)
    def sub4(r, c):
        return (c & 3) + 2 * (r & 3)
    by4, bx4, d = _by_diagonal(np.repeat(np.repeat(intra_mb, 4, 0), 4, 1)
                               & (dec.i4_pred >= 0), 4, sub4)
    px, py = bx4 * 4, by4 * 4
    av = dec.blk_avail[by4, bx4]
    a4 = np.arange(4)
    rt, lc = _clip(py - 1, H - 1), _clip(px - 1, W - 1)
    top = rt[:, None] * W + _clip(px[:, None] + a4, W - 1)
    tr = rt[:, None] * W + _clip(px[:, None] + 4 + a4, W - 1)
    tr = np.where(av[:, 2:3], tr, top[:, 3:4])
    ridx = np.concatenate([(py[:, None] + a4) * W + lc[:, None],
                           (rt * W + lc)[:, None], top, tr], 1)
    kind = _dc_kind(np.clip(dec.i4_pred[by4, bx4], 0, 8), av)
    fa.h["i4"] = (p.add(py * W + px, np.int64), p.add(ridx, np.int64),
                  p.add(kind, np.int64))
    r4 = _runs(d, steps, sub4(by4, bx4), 10)
    fa.plan = [(r16[i][0], rc[i][0], r8[i], r4[i])
               for i in range(len(steps))]


def _slots(dec):
    """The unique reference pictures of the two lists (in first-use
    order) and each list index's slot; sets dec._slot_map, which
    deblock_params reads for the picture ids."""
    list0 = dec.list0
    if not list0 and dec.ref_frame is not None:
        list0 = [{"planes": dec.ref_frame}]
    slots, slot_of = [], {}
    slot_map = ({}, {})
    for lst, lstref in ((0, list0), (1, dec.list1)):
        for r, ent in enumerate(lstref):
            key = id(ent["planes"][0])
            if key not in slot_of:
                slot_of[key] = len(slots)
                slots.append(ent["planes"])
            slot_map[lst][r] = slot_of[key]
    dec._slot_map = slot_map
    return slots, slot_map


def _stack(planes, device):
    """[R, h, w] uint8 on `device` from the DPB's planes (device tensors
    in the decoder, host arrays when fed the reference's decoder)."""
    return torch.stack([p if isinstance(p, torch.Tensor)
                        else torch.from_numpy(np.asarray(p))
                        for p in planes]).to(device, torch.uint8)


def prepare(dec, device="cuda", timer: Optional[_Timer] = None):
    """The host's part of the reconstruction (through the intra
    wavefront; the deblock has its own, `deblock_args`): the picture's
    arguments, built from dec's parse arrays and copied to `device`, with
    the DPB's planes stacked there.  Returns (fn, args): fn(args, marks)
    runs the device stages and returns the int32 planes."""
    device = torch.device(device)
    sps = dec.sps
    fa = FrameArgs(sps.mb_width, sps.mb_height)
    p = fa.pack
    slots, slot_map = _slots(dec)
    slot = np.full((2, fa.nmby * 4, fa.nmbx * 4), -1, np.int32)
    for lst in range(2):
        for r, s in slot_map[lst].items():
            slot[lst][dec.mv_ref[lst] == r] = s
    fa.lists_used = tuple(bool((slot[i] >= 0).any()) for i in range(2))
    if not hasattr(dec, "wp"):
        from .recon_host import build_weight_arrays
        dec.wp = build_weight_arrays(dec, getattr(dec, "last_sh", None))
    if any(fa.lists_used):
        fa.h["mv"] = p.add(dec.mv, np.int32)
        fa.h["slot"] = p.add(slot, np.int32)
        fa.h["wp"] = p.add(np.concatenate(
            [np.asarray(a, np.int32).reshape(-1, *slot.shape[1:])
             for a in dec.wp]), np.int32)
    fa.trans8 = bool(dec.trans8.any())
    fa.h["coeff_y"] = p.add(dec.coeff_y, np.int32)
    if fa.trans8:
        fa.h["coeff8_y"] = p.add(dec.coeff8_y, np.int32)
    fa.h["coeff_c"] = p.add(np.stack([dec.coeff_u, dec.coeff_v]), np.int32)
    if dec.pcm:
        fa.has_pcm = True
        pcm_y = np.zeros((fa.H, fa.W), np.uint8)
        pcm_c = np.zeros((2, fa.Hc, fa.Wc), np.uint8)
        for addr, (py_, pu_, pv_) in dec.pcm.items():
            mby, mbx = addr // fa.nmbx, addr % fa.nmbx
            pcm_y[mby * 16:mby * 16 + 16, mbx * 16:mbx * 16 + 16] = py_
            pcm_c[0, mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = pu_
            pcm_c[1, mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = pv_
        fa.h["pcm_y"] = p.add(pcm_y, np.uint8)
        fa.h["pcm_c"] = p.add(pcm_c, np.uint8)
        fa.h["is_pcm"] = p.add(dec.is_pcm, np.uint8)
    _intra_args(fa, dec)
    if timer is not None:
        timer.host_mark("build")
        timer.h2d_bytes += fa.nbytes()
    p.to(device)
    if any(fa.lists_used):
        fa.dpb = tuple(_stack([s[i] for s in slots], device)
                       for i in range(3))
    if timer is not None:
        timer.host_mark("h2d")
    return _recon_frame, fa


# ---------------------------------------------------------------------------
# device: residual


def _idct_blocks(coeff):
    """coeff: (..., 16) int32 raster-order dequantized blocks ->
    (..., 4, 4) int32 residual (exact h264idct_template.c math)."""
    b = coeff.reshape(coeff.shape[:-1] + (4, 4)).clone()
    b[..., 0, 0] += 32
    z0 = b[..., 0, :] + b[..., 2, :]
    z1 = b[..., 0, :] - b[..., 2, :]
    z2 = (b[..., 1, :] >> 1) - b[..., 3, :]
    z3 = b[..., 1, :] + (b[..., 3, :] >> 1)
    r = torch.stack([z0 + z3, z1 + z2, z1 - z2, z0 - z3], dim=-2)
    z0 = r[..., 0] + r[..., 2]
    z1 = r[..., 0] - r[..., 2]
    z2 = (r[..., 1] >> 1) - r[..., 3]
    z3 = r[..., 1] + (r[..., 3] >> 1)
    return torch.stack([z0 + z3, z1 + z2, z1 - z2, z0 - z3], dim=-1) >> 6


def _residual_plane(coeff):
    """(..., n4y, n4x, 16) -> (..., H, W) int32 residual plane."""
    n4y, n4x = coeff.shape[-3:-1]
    blocks = _idct_blocks(coeff)                 # (..., n4y, n4x, 4, 4)
    return blocks.transpose(-3, -2).reshape(
        coeff.shape[:-3] + (n4y * 4, n4x * 4))


def _idct8_blocks(coeff):
    """coeff: (..., 64) int32 raster dequantized 8x8 blocks ->
    (..., 8, 8) residual (exact spec 8.5.12.3 / recon.idct8_add math:
    horizontal pass, then vertical)."""
    b = coeff.reshape(coeff.shape[:-1] + (8, 8))

    def p(x):
        # 1-D transform along the LAST axis
        x0, x1, x2, x3, x4, x5, x6, x7 = x.unbind(-1)
        a0 = x0 + x4
        a2 = x0 - x4
        a4 = (x2 >> 1) - x6
        a6 = (x6 >> 1) + x2
        b0 = a0 + a6
        b2 = a2 + a4
        b4 = a2 - a4
        b6 = a0 - a6
        a1 = -x3 + x5 - x7 - (x7 >> 1)
        a3 = x1 + x7 - x3 - (x3 >> 1)
        a5 = -x1 + x7 + x5 + (x5 >> 1)
        a7 = x3 + x5 + x1 + (x1 >> 1)
        b1 = a1 + (a7 >> 2)
        b7 = a7 - (a1 >> 2)
        b3 = a3 + (a5 >> 2)
        b5 = (a3 >> 2) - a5
        return torch.stack([b0 + b7, b2 + b5, b4 + b3, b6 + b1,
                            b6 - b1, b4 - b3, b2 - b5, b0 - b7], dim=-1)

    t = p(b)                             # (..., row, hout)
    s = p(t.transpose(-1, -2))           # (..., hout, vout)
    return (s.transpose(-1, -2) + 32) >> 6


def _residual_plane8(coeff8):
    """(n8y, n8x, 64) -> (H, W) int32 residual plane (zero outside
    8x8-transform MBs because their coefficients are zero)."""
    n8y, n8x = coeff8.shape[:2]
    blocks = _idct8_blocks(coeff8)
    return blocks.transpose(1, 2).reshape(n8y * 8, n8x * 8)


# ---------------------------------------------------------------------------
# device: inter


def _pad_replicate(x, pad):
    """(R, h, w) -> (R, h + 2 pad, w + 2 pad), edge-replicated."""
    h, w = x.shape[-2:]
    dev = x.device
    rows = _const(dev, ("h264_pad", h, pad),
                  lambda: np.clip(np.arange(-pad, h + pad), 0, h - 1))
    cols = _const(dev, ("h264_pad", w, pad),
                  lambda: np.clip(np.arange(-pad, w + pad), 0, w - 1))
    return x[:, rows][:, :, cols]


def _tap6(a, dim):
    """The 6-tap half-pel filter (1, -5, 20, 20, -5, 1) along `dim`,
    unnormalized; the two leading and three trailing positions, which
    have no full support, are 0 (the reference's zero pad)."""
    n = a.shape[dim]

    def sl(k):
        return a.narrow(dim, 2 + k, n - 5)
    s = (sl(-2) - 5 * sl(-1) + 20 * sl(0) + 20 * sl(1) - 5 * sl(2)
         + sl(3))
    out = torch.zeros_like(a)
    out.narrow(dim, 2, n - 5).copy_(s)
    return out


def _halfpel_planes(gpad):
    """gpad: (R, Hp, Wp) int32 padded int-pel. Returns (G, B, H, J)
    stacked, values clipped to [0,255]; border margin of 3 px is
    garbage (callers clamp gather indices inside)."""
    b1 = _tap6(gpad, 2)                      # unnormalized horizontal
    B = ((b1 + 16) >> 5).clamp(0, 255)
    Hh = ((_tap6(gpad, 1) + 16) >> 5).clamp(0, 255)
    J = ((_tap6(b1, 1) + 512) >> 10).clamp(0, 255)
    return torch.stack([gpad, B, Hh, J])


def _expand(a, rep):
    """Per-4x4-block values (..., n4y, n4x) -> per sample (rep each)."""
    return a.repeat_interleave(rep, -2).repeat_interleave(rep, -1)


def _grid(dev, h, w):
    yy = _const(dev, ("h264_yy", h, w),
                lambda: np.repeat(np.arange(h)[:, None], w, 1))
    xx = _const(dev, ("h264_xx", h, w),
                lambda: np.repeat(np.arange(w)[None, :], h, 0))
    return yy, xx


def _inter_luma(stacked, mv, slot, lst):
    """stacked: (4, R, Hp, Wp) int32 G/B/H/J planes; mv (2, n4y, n4x, 2),
    slot (2, n4y, n4x) int32.  List `lst`'s prediction (H, W) int32."""
    _, R, Hp, Wp = stacked.shape
    flat = stacked.reshape(-1)
    dev = flat.device
    cases = _const(dev, ("h264_qpel",), lambda: _QPEL_CASES)
    mvx = _expand(mv[lst, :, :, 0], 4).long()
    mvy = _expand(mv[lst, :, :, 1], 4).long()
    s0 = _expand(slot[lst], 4).clamp(min=0).long()
    H, W = mvx.shape
    yy, xx = _grid(dev, H, W)
    Y = yy + (mvy >> 2) + _PAD
    X = xx + (mvx >> 2) + _PAD
    c = cases[(mvy & 3) * 4 + (mvx & 3)]             # (H, W, 6)
    vals = []
    for t in range(2):
        gy = (Y + c[..., 3 * t + 1]).clamp(3, Hp - 4)
        gx = (X + c[..., 3 * t + 2]).clamp(3, Wp - 4)
        vals.append(flat[((c[..., 3 * t] * R + s0) * Hp + gy) * Wp + gx])
    return (vals[0] + vals[1] + 1) >> 1


def _inter_chroma(cpad, mv, slot, lst):
    """cpad: (R, Hp, Wp) int32 padded chroma. Eighth-pel bilinear."""
    R, Hp, Wp = cpad.shape
    flat = cpad.reshape(-1)
    mvx = _expand(mv[lst, :, :, 0], 2).long()
    mvy = _expand(mv[lst, :, :, 1], 2).long()
    s0 = _expand(slot[lst], 2).clamp(min=0).long()
    Hc, Wc = mvx.shape
    yy, xx = _grid(flat.device, Hc, Wc)
    Y = (yy + (mvy >> 3) + _PAD_C).clamp(0, Hp - 2)
    X = (xx + (mvx >> 3) + _PAD_C).clamp(0, Wp - 2)
    fx, fy = mvx & 7, mvy & 7
    base = (s0 * Hp + Y) * Wp + X
    A = flat[base]
    Bv = flat[base + 1]
    C = flat[base + Wp]
    D = flat[base + Wp + 1]
    return ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * Bv
            + (8 - fx) * fy * C + fx * fy * D + 32) >> 6


def _combine_lists(preds, used, w, o, d, rep):
    """Weighted bi/uni prediction combine (8.4.2.3); with the default
    per-block arrays (w=1, o=0, d=0) this is plain averaging / copy.
    preds: per list a prediction or None (a list no block uses); used:
    per list (H, W) bool; w/o: (2, n4y, n4x); d: (n4y, n4x)."""
    w0, w1 = _expand(w[0], rep), _expand(w[1], rep)
    o0, o1 = _expand(o[0], rep), _expand(o[1], rep)
    dd = _expand(d, rep)
    p0, p1 = preds
    if p0 is None:
        uni = ((p1 * w1 + ((1 << dd) >> 1)) >> dd) + o1
        out = uni
    elif p1 is None:
        uni = ((p0 * w0 + ((1 << dd) >> 1)) >> dd) + o0
        out = uni
    else:
        uni_p = torch.where(used[0], p0, p1)
        uni_w = torch.where(used[0], w0, w1)
        uni_o = torch.where(used[0], o0, o1)
        uni = ((uni_p * uni_w + ((1 << dd) >> 1)) >> dd) + uni_o
        bi = ((p0 * w0 + p1 * w1 + (1 << dd)) >> (dd + 1)) \
            + ((o0 + o1 + 1) >> 1)
        out = torch.where(used[0] & used[1], bi, uni)
    any_used = used[0] if p1 is None else (
        used[1] if p0 is None else used[0] | used[1])
    return torch.where(any_used, out.clamp(0, 255), 0)


def _stage_inter(fa: FrameArgs, ry, rc):
    """Inter prediction plus residual, clipped -> Y (H*W) and C
    (2*Hc*Wc) flat int32; an I picture is its residual, clipped (its
    samples are all rewritten by the intra wavefront or PCM)."""
    if not any(fa.lists_used):
        return ry.clamp(0, 255).reshape(-1), rc.clamp(0, 255).reshape(-1)
    p = fa.pack
    mv = p.get(fa.h["mv"])
    slot = p.get(fa.h["slot"])
    wl, ol, dl, wu, ou, wv, ov, dcc = _split_wp(p.get(fa.h["wp"]))
    used_lists = fa.lists_used
    dpb_y, dpb_u, dpb_v = fa.dpb
    stacked = _halfpel_planes(_pad_replicate(dpb_y.to(torch.int32), _PAD))
    preds = [(_inter_luma(stacked, mv, slot, i) if used_lists[i] else None)
             for i in range(2)]
    del stacked
    used = [_expand(slot[i], 4) >= 0 for i in range(2)]
    pred_y = _combine_lists(preds, used, wl, ol, dl, 4)
    used = [_expand(slot[i], 2) >= 0 for i in range(2)]
    pc = []
    for plane, w, o in ((dpb_u, wu, ou), (dpb_v, wv, ov)):
        cpad = _pad_replicate(plane.to(torch.int32), _PAD_C)
        preds = [(_inter_chroma(cpad, mv, slot, i) if used_lists[i]
                  else None) for i in range(2)]
        pc.append(_combine_lists(preds, used, w, o, dcc, 2))
    y = (pred_y + ry).clamp(0, 255).to(torch.int32)
    c = (torch.stack(pc) + rc).clamp(0, 255).to(torch.int32)
    return y.reshape(-1), c.reshape(-1)


def _split_wp(wp):
    """The packed weight arrays -> (wl, ol, dl, wu, ou, wv, ov, dc)."""
    wl, ol = wp[0:2], wp[2:4]
    dl = wp[4]
    wu, ou, wv, ov = wp[5:7], wp[7:9], wp[9:11], wp[11:13]
    return wl, ol, dl, wu, ou, wv, ov, wp[13]


# ---------------------------------------------------------------------------
# device: intra


def _offsets(dev, n, stride):
    """Flat offsets of an n x n block's samples, row-major: [n*n]."""
    return _const(dev, ("h264_blk", n, stride),
                  lambda: (np.arange(n)[:, None] * stride
                           + np.arange(n)[None, :]).reshape(-1))


def _write(P, R, base, pred, n, stride):
    """P[block] = clip(clip(pred) + R[block]) for the n x n blocks at
    the flat `base` indices; pred [K, n*n]."""
    idx = base[:, None] + _offsets(P.device, n, stride)[None, :]
    P[idx] = (pred.clamp(0, 255) + R[idx]).clamp(0, 255).to(P.dtype)


def _select(mode, present, make):
    """The prediction of each lane's mode, computing only the modes
    `present` (host set) and selecting per lane."""
    out = None
    for m in sorted(present):
        v = make(m)
        out = v if out is None else torch.where(
            (mode == m).view((-1,) + (1,) * (v.dim() - 1)), v, out)
    return out


def _dc_select(al, at, s_l, s_t, both, one):
    """DC by availability: (sum_l + sum_t + r) >> s when both, each
    alone with its own rounding, else 128."""
    rb, sb = both
    r1, s1 = one
    return torch.where(al & at, (s_l + s_t + rb) >> sb,
                       torch.where(al, (s_l + r1) >> s1,
                                   torch.where(at, (s_t + r1) >> s1, 128)))


def _pred16(r, mode, al, at, present):
    """I_16x16 prediction from r [K, 33] = [tl, top16, left16]:
    (K, 256) int32."""
    K = r.shape[0]
    tl, top, left = r[:, 0], r[:, 1:17], r[:, 17:33]
    dev = r.device

    def make(m):
        if m == 0:
            return top[:, None, :].expand(K, 16, 16)
        if m == 1:
            return left[:, :, None].expand(K, 16, 16)
        if m == 2:
            dc = _dc_select(al, at, left.sum(-1), top.sum(-1), (16, 5),
                            (8, 4))
            return dc[:, None, None].expand(K, 16, 16)
        t17 = torch.cat([tl[:, None], top], 1)
        l17 = torch.cat([tl[:, None], left], 1)
        iw = _const(dev, ("h264_iw", 8), lambda: np.arange(1, 9))
        hsum = (iw * (t17[:, 9:17] - t17[:, 0:8].flip(1))).sum(-1)
        vsum = (iw * (l17[:, 9:17] - l17[:, 0:8].flip(1))).sum(-1)
        a = 16 * (l17[:, 16] + t17[:, 16])
        bb = (5 * hsum + 32) >> 6
        cc = (5 * vsum + 32) >> 6
        jj, ii = _grid(dev, 16, 16)
        return ((a[:, None, None] + bb[:, None, None] * (ii - 7)
                 + cc[:, None, None] * (jj - 7) + 16) >> 5).clamp(0, 255)

    return _select(mode, present, make).reshape(K, 256)


def _pred_chroma(r, mode, al, at, present):
    """8x8 chroma prediction from r [K, 17] = [tl, top8, left8]:
    (K, 64) int32 (modes: 0 DC, 1 horizontal, 2 vertical, 3 plane)."""
    K = r.shape[0]
    tl, top, left = r[:, 0], r[:, 1:9], r[:, 9:17]
    dev = r.device

    def make(m):
        if m == 1:
            return left[:, :, None].expand(K, 8, 8)
        if m == 2:
            return top[:, None, :].expand(K, 8, 8)
        if m == 3:
            t9 = torch.cat([tl[:, None], top], 1)
            l9 = torch.cat([tl[:, None], left], 1)
            iw = _const(dev, ("h264_iw", 4), lambda: np.arange(1, 5))
            hsum = (iw * (t9[:, 5:9] - t9[:, 0:4].flip(1))).sum(-1)
            vsum = (iw * (l9[:, 5:9] - l9[:, 0:4].flip(1))).sum(-1)
            a = 16 * (l9[:, 8] + t9[:, 8])
            bb = (17 * hsum + 16) >> 5
            cc = (17 * vsum + 16) >> 5
            jj, ii = _grid(dev, 8, 8)
            return ((a[:, None, None] + bb[:, None, None] * (ii - 3)
                     + cc[:, None, None] * (jj - 3) + 16) >> 5
                    ).clamp(0, 255)
        # DC: per-quadrant rules (spec 8.3.4.1)
        ts = top.view(K, 2, 4).sum(-1)          # (K, qx)
        ls = left.view(K, 2, 4).sum(-1)         # (K, qy)
        q = []
        for qy in range(2):
            for qx in range(2):
                t, lf = ts[:, qx], ls[:, qy]
                if qx == qy:
                    v = _dc_select(al, at, lf, t, (4, 3), (2, 2))
                elif qx == 1:
                    v = torch.where(at, (t + 2) >> 2,
                                    torch.where(al, (lf + 2) >> 2, 128))
                else:
                    v = torch.where(al, (lf + 2) >> 2,
                                    torch.where(at, (t + 2) >> 2, 128))
                q.append(v)
        dcq = torch.stack(q, 1).view(K, 2, 2)
        return dcq.repeat_interleave(4, 1).repeat_interleave(4, 2)

    return _select(mode, present, make).reshape(K, 64)


def _tap_predict(r, kind, tab, dev, key):
    """A tap-table prediction: per lane the row of its kind,
    ((sum_t w * r[i]) + rnd) >> sh per sample.  r [K, n_ref] int32."""
    idx_t = _const(dev, (key, "i"), lambda: tab[0])
    w_t = _const(dev, (key, "w"), lambda: tab[1])
    rs_t = _const(dev, (key, "rs"), lambda: tab[2])
    K = r.shape[0]
    P, nt = tab[0].shape[1:]
    vals = r.gather(1, idx_t[kind].view(K, P * nt)).view(K, P, nt)
    rs = rs_t[kind]
    return ((vals * w_t[kind]).sum(-1, dtype=torch.int32) + rs[..., 0]) \
        >> rs[..., 1]


def _i8_refs(raw, al, at, atl):
    """The 8.3.2.2.1 reference filter: raw [K, 25] = [left8, tl, top16]
    -> r [K, 25] = [lf0..lf7, tlf, tf0..tf15]."""
    left, tl, t16 = raw[:, 0:8], raw[:, 8], raw[:, 9:25]
    tf0 = torch.where(atl, (tl + 2 * t16[:, 0] + t16[:, 1] + 2) >> 2,
                      (3 * t16[:, 0] + t16[:, 1] + 2) >> 2)
    tfm = (t16[:, 0:14] + 2 * t16[:, 1:15] + t16[:, 2:16] + 2) >> 2
    tf15 = (t16[:, 14] + 3 * t16[:, 15] + 2) >> 2
    lf0 = torch.where(atl, (tl + 2 * left[:, 0] + left[:, 1] + 2) >> 2,
                      (3 * left[:, 0] + left[:, 1] + 2) >> 2)
    lfm = (left[:, 0:6] + 2 * left[:, 1:7] + left[:, 2:8] + 2) >> 2
    lf7 = (left[:, 6] + 3 * left[:, 7] + 2) >> 2
    tlf = torch.where(
        at & al, (t16[:, 0] + 2 * tl + left[:, 0] + 2) >> 2,
        torch.where(at, (3 * tl + t16[:, 0] + 2) >> 2,
                    torch.where(al, (3 * tl + left[:, 0] + 2) >> 2, tl)))
    return torch.cat([lf0[:, None], lfm, lf7[:, None], tlf[:, None],
                      tf0[:, None], tfm, tf15[:, None]], 1)


def _stage_intra(fa: FrameArgs, Y, C, ry, rc):
    """The intra wavefront: the host loops over the diagonals that hold
    an intra macroblock; Y, C written in place."""
    if not fa.steps:
        return
    p = fa.pack
    dev = Y.device
    W, Wc = fa.W, fa.Wc
    ry, rc = ry.reshape(-1), rc.reshape(-1)
    b16, r16, m16 = (p.get(h) for h in fa.h["i16"])
    bc, rcx, mc = (p.get(h) for h in fa.h["chroma"])
    b8, r8, m8 = (p.get(h) for h in fa.h["i8"])
    b4, r4, k4 = (p.get(h) for h in fa.h["i4"])
    m16b, mcb, m8b = m16.bool(), mc.bool(), m8.bool()
    for i16, ch, i8s, i4s in fa.plan:
        a, b = i16
        if a < b:
            pred = _pred16(Y[r16[a:b]], m16[0, a:b], m16b[1, a:b],
                           m16b[2, a:b], fa.modes16)
            _write(Y, ry, b16[a:b], pred, 16, W)
        a, b = ch
        if a < b:
            pred = _pred_chroma(C[rcx[a:b]], mc[0, a:b], mcb[1, a:b],
                                mcb[2, a:b], fa.modesc)
            _write(C, rc, bc[a:b], pred, 8, Wc)
        for a, b in i8s:
            if a < b:
                r = _i8_refs(Y[r8[a:b]], m8b[1, a:b], m8b[2, a:b],
                             m8b[3, a:b])
                pred = _tap_predict(r, m8[0, a:b].long(), _I8_TAB, dev,
                                    "h264_i8tab")
                _write(Y, ry, b8[a:b], pred, 8, W)
        for a, b in i4s:
            if a < b:
                pred = _tap_predict(Y[r4[a:b]], k4[a:b], _I4_TAB, dev,
                                    "h264_i4tab")
                _write(Y, ry, b4[a:b], pred, 4, W)


def _recon_frame(fa: FrameArgs, marks=None):
    """The reconstruction on fa's device: the residual, inter
    prediction, PCM, the intra wavefront -> (Y [H, W], C [2, Hc, Wc])
    int32.  marks: an optional callable, called with the name of each
    stage as it is queued ("residual", "inter", "intra")."""
    p = fa.pack
    H, W, Hc, Wc = fa.H, fa.W, fa.Hc, fa.Wc
    if marks is not None:
        marks("residual")
    ry = _residual_plane(p.get(fa.h["coeff_y"]))
    if fa.trans8:
        ry = ry + _residual_plane8(p.get(fa.h["coeff8_y"]))
    rc = _residual_plane(p.get(fa.h["coeff_c"]))
    if marks is not None:
        marks("inter")
    Y, C = _stage_inter(fa, ry, rc)
    if fa.has_pcm:
        pcm = p.get(fa.h["is_pcm"]).bool()
        Y = torch.where(_expand(pcm, 16).reshape(-1),
                        p.get(fa.h["pcm_y"]).reshape(-1).to(torch.int32), Y)
        C = torch.where(_expand(pcm, 8).reshape(-1).repeat(2),
                        p.get(fa.h["pcm_c"]).reshape(-1).to(torch.int32), C)
    if marks is not None:
        marks("intra")
    _stage_intra(fa, Y, C, ry, rc)
    return Y.view(H, W), C.view(2, Hc, Wc)


# ---------------------------------------------------------------------------
# host-side deblock metadata (strengths + thresholds from parse tensors)


def _clip3(x, lo, hi):
    return np.clip(x, lo, hi)


def _bs_mv_term(picP, mvP, picQ, mvQ):
    """Vectorized spec 8.7.2.1 motion-based bS (0 or 1). pic*: (2, N)
    slot ids (-9 unused); mv*: (2, N, 2)."""
    usedP = picP >= 0
    usedQ = picQ >= 0
    nP = usedP.sum(0)
    nQ = usedQ.sum(0)

    def far(a, b):
        return (np.abs(a[..., 0] - b[..., 0]) >= 4) | \
               (np.abs(a[..., 1] - b[..., 1]) >= 4)

    picP_ = np.where(usedP, picP, -9)
    picQ_ = np.where(usedQ, picQ, -9)
    sameset = (np.minimum(picP_[0], picP_[1]) ==
               np.minimum(picQ_[0], picQ_[1])) & \
              (np.maximum(picP_[0], picP_[1]) ==
               np.maximum(picQ_[0], picQ_[1]))
    # single-reference case: pick the used entry on each side
    selP = np.where(usedP[0][..., None], mvP[0], mvP[1])
    selQ = np.where(usedQ[0][..., None], mvQ[0], mvQ[1])
    one_far = far(selP, selQ)
    # two-reference case
    same_pic = picP_[0] == picP_[1]
    ok_fwd = (~far(mvP[0], mvQ[0])) & (~far(mvP[1], mvQ[1]))
    ok_rev = (~far(mvP[0], mvQ[1])) & (~far(mvP[1], mvQ[0]))
    two_same = ~(ok_fwd | ok_rev)
    # distinct pictures: match Q entries to P entries by picture id
    q_for_p0 = np.where((picQ_[0] == picP_[0])[..., None], mvQ[0], mvQ[1])
    q_for_p1 = np.where((picQ_[1] == picP_[1])[..., None], mvQ[1], mvQ[0])
    two_diff = far(mvP[0], q_for_p0) | far(mvP[1], q_for_p1)
    bs = np.where(nP != nQ, 1,
                  np.where(~sameset, 1,
                           np.where(nP == 1, one_far.astype(np.int64),
                                    np.where(same_pic, two_same,
                                             two_diff).astype(np.int64))))
    return np.where((nP == 0) & (nQ == 0), 0, bs)


def deblock_params(dec, alpha_off=0, beta_off=0):
    """Precompute per-4x4-edge bS and alpha/beta/tc0 maps (numpy,
    metadata only — mirrors loopfilter.py's scalar logic)."""
    sps, pps = dec.sps, dec.pps
    nmbx, nmby = sps.mb_width, sps.mb_height
    n4y, n4x = nmby * 4, nmbx * 4
    ALPHA = np.asarray(T.ALPHA_TABLE, np.int32)
    BETA = np.asarray(T.BETA_TABLE, np.int32)
    TC0 = np.asarray(T.TC0_TABLE, np.int32)      # (104, 4): bs-1 idx 0..2
    CQP = np.asarray(T.CHROMA_QP_8BIT, np.int32)

    # per-block picture ids (DPB slot of the referenced entry)
    picid = np.full((2, n4y, n4x), -9, np.int64)
    slot_map = getattr(dec, "_slot_map", None)
    for lst in range(2):
        lstref = dec.list0 if lst == 0 else dec.list1
        refs = dec.mv_ref[lst]
        for r in range(len(lstref)):
            if slot_map is not None:
                uid = slot_map[lst].get(r, -1 - lst)
            else:
                uid = id(lstref[r]) % (1 << 31)
            picid[lst][refs == r] = uid
    mv = dec.mv.astype(np.int64)

    mb_intra4 = np.repeat(np.repeat(dec.mb_intra, 4, 0), 4, 1)
    # 8x8-transform MBs: a 4x4 cell is "coded" when its covering 8x8
    # block is (loopfilter.py nnz_eff); their interior e∈{1,3} luma
    # edges are not filtered (8.7: transform-block edges only)
    nnz_src = dec.nnz_y
    trans8 = getattr(dec, "trans8", None)
    t84 = None
    if trans8 is not None and trans8.any():
        g8 = nnz_src.reshape(nmby * 2, 2, nmbx * 2, 2).max((1, 3))
        t8c = np.repeat(np.repeat(trans8, 2, 0), 2, 1)
        g8 = np.where(t8c, g8, 0)
        t84 = np.repeat(np.repeat(trans8, 4, 0), 4, 1)
        nnz_src = np.where(t84, np.repeat(np.repeat(g8, 2, 0), 2, 1),
                           nnz_src)
    nnz = nnz_src > 0
    qp_mb = dec.mb_qp.astype(np.int64)

    out = {}
    for direction in ("v", "h"):
        if direction == "v":
            # P = block to the left
            picP = np.full_like(picid, -9)
            picP[:, :, 1:] = picid[:, :, :-1]
            mvP = np.zeros_like(mv)
            mvP[:, :, 1:] = mv[:, :, :-1]
            intraP = np.zeros_like(mb_intra4)
            intraP[:, 1:] = mb_intra4[:, :-1]
            nnzP = np.zeros_like(nnz)
            nnzP[:, 1:] = nnz[:, :-1]
            mb_edge = (np.arange(n4x) % 4 == 0)[None, :] & \
                np.ones((n4y, 1), bool)
            frame_edge = (np.arange(n4x) == 0)[None, :] & \
                np.ones((n4y, 1), bool)
            qpP = np.zeros((n4y, n4x), np.int64)
            qp_cur = np.repeat(np.repeat(qp_mb, 4, 0), 4, 1)
            qpP[:, 1:] = qp_cur[:, :-1]
        else:
            picP = np.full_like(picid, -9)
            picP[:, 1:, :] = picid[:, :-1, :]
            mvP = np.zeros_like(mv)
            mvP[:, 1:, :] = mv[:, :-1, :]
            intraP = np.zeros_like(mb_intra4)
            intraP[1:, :] = mb_intra4[:-1, :]
            nnzP = np.zeros_like(nnz)
            nnzP[1:, :] = nnz[:-1, :]
            mb_edge = (np.arange(n4y) % 4 == 0)[:, None] & \
                np.ones((1, n4x), bool)
            frame_edge = (np.arange(n4y) == 0)[:, None] & \
                np.ones((1, n4x), bool)
            qpP = np.zeros((n4y, n4x), np.int64)
            qp_cur = np.repeat(np.repeat(qp_mb, 4, 0), 4, 1)
            qpP[1:, :] = qp_cur[:-1, :]

        bs_mv = _bs_mv_term(picP, mvP, picid, mv)
        bs = np.where(
            intraP | mb_intra4,
            np.where(mb_edge, 4, 3),
            np.where(nnzP | nnz, 2, bs_mv))
        # interior edges always have qpP == qp_cur
        qpP_eff = np.where(mb_edge, qpP, qp_cur)
        bs = np.where(frame_edge, 0, bs)
        if t84 is not None:
            if direction == "v":
                inner = (np.arange(n4x) % 2 == 1)[None, :] & \
                    np.ones((n4y, 1), bool)
            else:
                inner = (np.arange(n4y) % 2 == 1)[:, None] & \
                    np.ones((1, n4x), bool)
            bs = np.where(t84 & inner, 0, bs)
        # q-side MB not covered by a slice -> no filtering of its edges
        avail4 = np.repeat(np.repeat(dec.mb_avail, 4, 0), 4, 1)
        bs = np.where(avail4, bs, 0)

        qp_avg = (qpP_eff + qp_cur + 1) >> 1
        ia = _clip3(qp_avg + alpha_off, 0, 51)
        ib = _clip3(qp_avg + beta_off, 0, 51)
        alpha = ALPHA[52 + ia]
        beta = BETA[52 + ib]
        tc0 = TC0[52 + ia, np.clip(bs, 1, 3)] * (bs < 4)
        out[f"bs_{direction}"] = bs.astype(np.int32)
        out[f"al_{direction}"] = alpha.astype(np.int32)
        out[f"be_{direction}"] = beta.astype(np.int32)
        out[f"tc_{direction}"] = tc0.astype(np.int32)

        # chroma thresholds per component (qpc averaging)
        als, bes, tcs = [], [], []
        for coff in (pps.chroma_qp_index_offset,
                     pps.second_chroma_qp_index_offset):
            qpc = (CQP[_clip3(qpP_eff + coff, 0, 51)] +
                   CQP[_clip3(qp_cur + coff, 0, 51)] + 1) >> 1
            cia = _clip3(qpc + alpha_off, 0, 51)
            cib = _clip3(qpc + beta_off, 0, 51)
            als.append(ALPHA[52 + cia].astype(np.int32))
            bes.append(BETA[52 + cib].astype(np.int32))
            tcs.append(((TC0[52 + cia, np.clip(bs, 1, 3)] + 1)
                        * (bs < 4)).astype(np.int32))
        out[f"al_c{direction}"] = als
        out[f"be_c{direction}"] = bes
        out[f"tc_c{direction}"] = tcs
    out["mb_avail"] = dec.mb_avail
    return out


# ---------------------------------------------------------------------------
# deblock wavefront: host arguments


class DeblockArgs:
    """The deblock wavefront's batches: per edge kind (luma v/h e=0..3,
    chroma v/h e=0,2) the filtered lanes sorted by diagonal, each with
    its flat base sample and its [4, n] (bS, alpha, beta, tc) rows, and
    per step and kind the lane range and which branches (bS 4, bS < 4)
    occur."""

    def __init__(self):
        self.pack = _Pack()
        self.kinds: list = []        # (name, luma, vertical, handles)
        self.steps: List[int] = []
        self.plan: list = []         # per step: per kind (a, b, strong, weak)

    def nbytes(self) -> int:
        return self.pack.nbytes()


def _edge_rows(m, e, vertical, n):
    """A (n4y, n4x) map's values along edge e of every macroblock:
    (nmby, nmbx, 4 segments) repeated to n samples per edge."""
    if vertical:
        a = m[:, e::4]                                   # (n4y, nmbx)
        a = a.reshape(-1, 4, a.shape[1]).transpose(0, 2, 1)
    else:
        a = m[e::4, :]                                   # (nmby, n4x)
        a = a.reshape(a.shape[0], -1, 4)
    return np.repeat(a, n // 4, axis=2)


def deblock_args(dec, alpha_off=0, beta_off=0,
                 device="cuda") -> DeblockArgs:
    """The deblock wavefront's arguments for dec's picture (after its
    concealment, if any), copied to `device`."""
    dbp = deblock_params(dec, alpha_off, beta_off)
    sps = dec.sps
    nmbx, nmby = sps.mb_width, sps.mb_height
    W, Wc, Hc = nmbx * 16, nmbx * 8, nmby * 8
    da = DeblockArgs()
    mby, mbx = np.mgrid[0:nmby, 0:nmbx]
    on = dec.mb_avail
    lanes = []
    for vertical in (True, False):
        dn = "v" if vertical else "h"
        for e in range(4):
            pos = (mbx if vertical else mby) * 16 + 4 * e
            prm = np.stack([_edge_rows(dbp[f"{k}_{dn}"], e, vertical, 16)
                            for k in ("bs", "al", "be", "tc")], 2)
            act = on & (pos > 0) & (prm[:, :, 0] > 0).any(-1)
            base = (mby * 16 * W + mbx * 16 + (4 * e if vertical
                                               else 4 * e * W))
            lanes.append((f"{dn}{e}", True, vertical, act, base[..., None],
                          prm[..., None, :, :]))
            if e in (0, 2):
                pos = (mbx if vertical else mby) * 8 + 2 * e
                bsc = _edge_rows(dbp[f"bs_{dn}"], e, vertical, 8)
                prm = np.stack([np.stack(
                    [bsc] + [_edge_rows(dbp[f"{k}_c{dn}"][ci], e,
                                        vertical, 8)
                             for k in ("al", "be", "tc")], 2)
                    for ci in range(2)], 2)            # (y, x, 2, 4, 8)
                act = on & (pos > 0) & (bsc > 0).any(-1)
                base = (mby * 8 * Wc + mbx * 8 + (2 * e if vertical
                                                  else 2 * e * Wc))
                base = base[..., None] + np.arange(2) * (Hc * Wc)
                lanes.append((f"c{dn}{e}", False, vertical, act, base,
                              prm))
    d_all = mbx + 2 * mby
    steps = np.unique(np.concatenate(
        [d_all[act] for *_, act, _b, _p in lanes]))
    da.steps = steps.tolist()
    p = da.pack
    runs = []
    for name, luma, vertical, act, base, prm in lanes:
        y_, x_ = np.nonzero(act)
        d = d_all[y_, x_]
        o = np.argsort(d, kind="stable")
        y_, x_, d = y_[o], x_[o], d[o]
        npl = base.shape[-1]
        b = base[y_, x_].reshape(-1)                     # lane = (mb, pl)
        pr = prm[y_, x_].reshape((-1,) + prm.shape[-2:])
        d = np.repeat(d, npl)
        bs = pr[:, 0]
        strong = (bs == 4).any(-1)
        weak = ((bs > 0) & (bs < 4)).any(-1)
        # bS <= 4, alpha <= 255, beta <= 18, tc <= 26 at 8 bits
        da.kinds.append((name, luma, vertical, p.add(b, np.int64),
                         p.add(pr, np.uint8)))
        r = _ranges(d, steps)
        cs = np.concatenate([[0], np.cumsum(strong)])
        cw = np.concatenate([[0], np.cumsum(weak)])
        runs.append([(a, b_, bool(cs[b_] > cs[a]), bool(cw[b_] > cw[a]))
                     for a, b_ in r])
    da.plan = list(zip(*runs)) if runs else []
    p.to(torch.device(device))
    return da


# ---------------------------------------------------------------------------
# deblock wavefront: device


def _edge_index(dev, luma, vertical, W):
    """Flat offsets of an edge's samples from its base: [n, taps] with
    taps p3..q3 (luma, 8) or p1..q1 (chroma, 4) across the edge."""
    n, taps = (16, 8) if luma else (8, 4)

    def make():
        along = np.arange(n)[:, None]
        across = np.arange(taps)[None, :] - taps // 2
        return along * W + across if vertical else across * W + along
    return _const(dev, ("h264_edge", luma, vertical, W), make)


def _luma_edge(S, prm, strong, weak):
    """The luma filter (exact h264_loopfilter.c math) on samples S
    [K, 16, 8] (p3..q3) with rows prm [K, 4, 16] (bS, alpha, beta,
    tc0): the new p2..q2 [K, 16, 6].  strong / weak: whether the batch
    has bS 4 / bS 1-3 edges (host)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = S.unbind(-1)
    bs, alpha, beta, tc0 = prm.unbind(1)
    filt = (bs > 0) & ((p0 - q0).abs() < alpha) & \
        ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta)
    n = [p2, p1, p0, q0, q1, q2]
    if weak:
        ap = (p2 - p0).abs() < beta
        aq = (q2 - q0).abs() < beta
        tc = tc0 + ap.to(torch.int32) + aq.to(torch.int32)
        delta = torch.maximum(torch.minimum(
            (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, tc), -tc)
        avg = (p0 + q0 + 1) >> 1
        w = [p2,
             torch.where(ap, p1 + torch.maximum(torch.minimum(
                 (p2 + avg - 2 * p1) >> 1, tc0), -tc0), p1),
             (p0 + delta).clamp(0, 255), (q0 - delta).clamp(0, 255),
             torch.where(aq, q1 + torch.maximum(torch.minimum(
                 (q2 + avg - 2 * q1) >> 1, tc0), -tc0), q1),
             q2]
    if strong:
        st = (p0 - q0).abs() < ((alpha >> 2) + 2)
        sp = st & ((p2 - p0).abs() < beta)
        sq = st & ((q2 - q0).abs() < beta)
        s = [torch.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2),
             torch.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1),
             torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                         (2 * p1 + p0 + q1 + 2) >> 2),
             torch.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                         (2 * q1 + q0 + p1 + 2) >> 2),
             torch.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1),
             torch.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)]
    if strong and weak:
        is4 = bs == 4
        new = [torch.where(is4, a, b) for a, b in zip(s, w)]
    else:
        new = s if strong else w
    return torch.stack([torch.where(filt, v, o) for v, o in zip(new, n)],
                       -1)


def _chroma_edge(S, prm, strong, weak):
    """The chroma filter on samples S [K, 8, 4] (p1, p0, q0, q1) with
    rows prm [K, 4, 8]: the new p0, q0 [K, 8, 2]."""
    p1, p0, q0, q1 = S.unbind(-1)
    bs, alpha, beta, tc = prm.unbind(1)
    filt = (bs > 0) & ((p0 - q0).abs() < alpha) & \
        ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta)
    if weak:
        delta = torch.maximum(torch.minimum(
            (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, tc), -tc)
        w = [(p0 + delta).clamp(0, 255), (q0 - delta).clamp(0, 255)]
    if strong:
        s = [(2 * p1 + p0 + q1 + 2) >> 2, (2 * q1 + q0 + p1 + 2) >> 2]
    if strong and weak:
        new = [torch.where(bs == 4, a, b) for a, b in zip(s, w)]
    else:
        new = s if strong else w
    return torch.stack([torch.where(filt, new[0], p0),
                        torch.where(filt, new[1], q0)], -1)


def deblock_wavefront(da: DeblockArgs, Y, C, W, Wc):
    """The deblock wavefront over Y [H*W] and C [2*Hc*Wc] (flat int32,
    written in place): per step the kinds in the reference's order."""
    dev = Y.device
    kinds = []
    for name, luma, vertical, hb, hp in da.kinds:
        base = da.pack.get(hb)
        prm = da.pack.get(hp).to(torch.int32)
        off = _edge_index(dev, luma, vertical, W if luma else Wc)
        kinds.append((luma, base, prm, off))
    for runs in da.plan:
        for (luma, base, prm, off), (a, b, strong, weak) in zip(kinds,
                                                                 runs):
            if a == b:
                continue
            P = Y if luma else C
            idx = base[a:b, None, None] + off[None]
            S = P[idx]
            if luma:
                P[idx[..., 1:7]] = _luma_edge(S, prm[a:b], strong, weak)
            else:
                P[idx[..., 1:3]] = _chroma_edge(S, prm[a:b], strong, weak)


# ---------------------------------------------------------------------------
# the picture


def _conceal(dec, Y, C, stats):
    """conceal_missing on host copies of the reconstructed planes and of
    the reference picture; returns the planes back on their device."""
    from ...core.frame import host_array
    y = Y.to(torch.uint8).cpu().numpy()
    c = C.to(torch.uint8).cpu().numpy()
    # the host path leaves the macroblocks no slice decoded at 0
    hole = ~dec.mb_avail
    y[np.repeat(np.repeat(hole, 16, 0), 16, 1)] = 0
    c[:, np.repeat(np.repeat(hole, 8, 0), 8, 1)] = 0
    dec.y, dec.u, dec.v = y, c[0], c[1]
    d2h = y.nbytes + c.nbytes
    saved = dec.list0, dec.ref_frame
    if dec.list0:
        ref = tuple(host_array(pl) for pl in dec.list0[0]["planes"])
        dec.list0 = [{"planes": ref}]
        d2h += sum(r.nbytes for r in ref)
    elif dec.ref_frame is not None:
        dec.ref_frame = tuple(host_array(pl) for pl in dec.ref_frame)
        d2h += sum(r.nbytes for r in dec.ref_frame)
    try:
        conceal_missing(dec)
    finally:
        dec.list0, dec.ref_frame = saved
    if stats is not None:
        stats["conceal_d2h_bytes"] = d2h
        stats["conceal_h2d_bytes"] = y.nbytes + c.nbytes
    dev = Y.device
    return (torch.from_numpy(dec.y).to(dev, torch.int32),
            torch.from_numpy(np.stack([dec.u, dec.v])).to(dev, torch.int32))


def reconstruct(dec, device="cuda", alpha_off=0, beta_off=0,
                do_deblock=True, stats: Optional[dict] = None):
    """The picture's final planes, computed on `device` from dec's parse
    arrays: the reconstruction, the concealment of a damaged picture
    (on host copies), then the deblock wavefront.  Returns (y, u, v)
    uint8 tensors there; dec's host planes are written only on a
    damaged picture (the concealment works on them).

    stats: an optional dict; after the caller has synchronized with the
    device, finish_stats(stats) turns it into the split: `host` (build,
    h2d, deblock_build, conceal, queue: ms on the host's clock),
    `device` (residual, inter, intra, deblock, out: ms by CUDA events on
    a card, the host's clock elsewhere), `h2d_bytes`, `intra_steps`,
    `deblock_steps`, and `conceal_*_bytes` when a damaged picture went
    to the host."""
    device = torch.device(device)
    timer = _Timer(device) if stats is not None else None
    damaged = not dec.mb_avail.all()
    fn, fa = prepare(dec, device, timer)
    da = None
    if do_deblock and not damaged:
        # the deblock's parameters need no samples: build them before
        # the device stages are queued (after prepare, which sets the
        # picture ids they read)
        da = deblock_args(dec, alpha_off, beta_off, device)
        if timer is not None:
            timer.host_mark("deblock_build")
            timer.h2d_bytes += da.nbytes()
    Y, C = fn(fa, None if timer is None else timer.dev_mark)
    if damaged:
        if timer is not None:
            timer.dev_mark("conceal")
        Y, C = _conceal(dec, Y, C, stats)
        if timer is not None:
            timer.host_mark("conceal")
        if do_deblock:
            da = deblock_args(dec, alpha_off, beta_off, device)
            if timer is not None:
                timer.host_mark("deblock_build")
                timer.h2d_bytes += da.nbytes()
    if da is not None:
        if timer is not None:
            timer.dev_mark("deblock")
        deblock_wavefront(da, Y.view(-1), C.view(-1), fa.W, fa.Wc)
    if timer is not None:
        timer.dev_mark("out")
    y, c = Y.to(torch.uint8), C.to(torch.uint8)
    if timer is not None:
        timer.host_mark("queue")
        timer.dev_mark("done")
        stats["timer"] = timer
        stats["intra_steps"] = len(fa.steps)
        stats["deblock_steps"] = 0 if da is None else len(da.steps)
    return y, c[0], c[1]


def finish_stats(stats: dict) -> None:
    """After the device has finished (the caller synchronized): turn the
    timer `reconstruct` left in `stats` into its host and device
    splits."""
    timer = stats.pop("timer")
    stats["host"] = dict(timer.host)
    stats["h2d_bytes"] = timer.h2d_bytes
    stats["device"] = timer.device_ms()
