"""HEVC frame reconstruction on the decoder's device, in PyTorch.

The port of ffmpeg_tpu/codecs/hevc/recon_tpu.py.  Replays the work the
CABAC parse recorded (recorder.ReconRecorder) in the reference's order:

  1. the residual: every TU inverse-transformed, batched by size class
     (4/8/16/32 luma, 4/8/16 chroma; DCT-II, DST-VII or transform skip),
     scattered into residual planes;
  2. inter: per (DPB slot, x-phase) the horizontally filtered plane is
     computed once over the whole plane (8-tap luma, 4-tap chroma), then
     every pixel gathers its rows and applies its y-phase filter; the
     MV, reference and list-flag grids are the parse's 4x4 grids.  The
     prediction is written where the pf grid is inter and the residual
     added;
  3. intra, level by level of the recorder's dependency levels: every
     block of a level is predicted, residual-added and written at once.

Byte-exact with the host path (ctu.py, recon.py, inter.py).  Exact
integer math throughout:
 * the transforms' two passes are float64 matrix products: every product
   of a coefficient (|c| <= 32768) and a matrix entry (|t| <= 90) is an
   integer below 2^22, and a sum of 32 of them stays below 2^27, so
   every partial sum is an integer that float64 holds exactly (< 2^53),
   whatever the order of summation; the result is cast back to int32
   before the reference's shifts and int16 clips.  (The reference's
   int32 einsum has no CUDA counterpart in torch, and float32 would
   round above 2^24);
 * MC, intra prediction and the adds run on int32 tensors with the
   reference's shifts and clips.

Where the reference's program differs by being one compiled program
(jitted once per geometry and padded counts), the port runs eagerly and
exactly (not ported: the INVALID sentinel and `_pow2` padding of every
work list, the power-of-two bucketing of the level count, every class
always instantiated, the `mode="drop"` scatters of padding records, and
the `lru_cache` program cache `_build_program`):
 * the work lists hold exactly the recorded items; a class with no item
   is skipped;
 * the levels are a loop on the host, each class skipped at a level
   where it has no block;
 * the intra reference-sample substitution (the reference's
   `_ref_cascade`, spec 8.4.4.2.2) is resolved on the host, which knows
   every block's availability: each of a block's 4n+1 reference samples
   is given the flat index of the sample it takes (its own, or the one
   the substitution copies), so the device gathers them in one step; a
   block with no neighbour available reads a sample past the plane that
   holds 1 << (bd - 1);
 * which predictors a batch needs (planar, DC, angular, the mode 10/26
   edge filters) and which smoothing, from the host copy of its modes
   and filter kinds: the reference computes all and selects, and the
   selection gives the same values;
 * a batch with a block that would reach outside its plane (none does
   in a valid stream: the picture is a multiple of the minimum CB) reads
   clamped positions and writes through VP9's `_put`, which drops the
   samples outside as `mode="drop"` does; every other batch writes each
   block at its flat base.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..vp9.recon_tpu import _Timer, _arange, _const, _put
from . import recorder as R
from . import tables as T
from .inter import CHROMA_FILTERS, LUMA_FILTERS

PAD_L, PAD_C = 8, 4         # MV clamp ranges (fully-outside-equivalent)

_CLASSES = [(True, 4), (True, 8), (True, 16), (True, 32),
            (False, 4), (False, 8), (False, 16)]

# avail bit of each reference-sample group in c-order (bl, l, tl, t, tr);
# the recorder packs (l, bl, t, tr, tl) into bits 0..4
_GROUP_BIT = np.array([1, 0, 4, 2, 3], np.int64)


# ---------------------------------------------------------------------------
# angular prediction tables: pred[p] = ((32-f)*c[i0] + f*c[i1] + 16)>>5
# over a block's reference samples in c-order (below)


@functools.lru_cache(maxsize=None)
def _angular_tables(n: int):
    """The reference's tables (index into C = [left[0..2n], top[0..2n]],
    index 0 the corner), with each index mapped onto c-order:
    c = [left[2n], ..., left[1], corner, top[1], ..., top[2n]], so
    left[j] = c[2n - j] and top[j] = c[2n + j]."""
    idx = np.zeros((33, n * n, 2), np.int64)
    wgt = np.zeros((33, n * n, 2), np.int32)
    for mode in range(2, 35):
        angle = int(T.INTRA_PRED_ANGLE[mode - 2])
        vertical = mode >= 18

        def combined(p):
            """ref[OFF + p] -> combined index (derivation mirrors
            recon.pred_intra's ref[] fill)."""
            if p >= 0:
                return (2 * n + 2 + p) if vertical else (1 + p)
            if p == -1:
                return 0
            xk = p + 1                      # filled as ref[OFF+xk-1]
            inv = int(T.INV_ANGLE[mode - 11])
            i2 = -1 + ((xk * inv + 128) >> 8)
            if i2 < 0:
                return 0
            return (1 + i2) if vertical else (2 * n + 2 + i2)

        for a in range(n):                 # row (vertical) / col (horiz)
            off = ((a + 1) * angle) >> 5
            fact = ((a + 1) * angle) & 31
            for b in range(n):
                p = (a * n + b) if vertical else (b * n + a)
                idx[mode - 2, p, 0] = combined(off + b)
                idx[mode - 2, p, 1] = combined(off + b + 1)
                wgt[mode - 2, p, 0] = 32 - fact
                wgt[mode - 2, p, 1] = fact
    # a weight-0 second tap of the 45-degree modes points one past C
    # (4n+2); the reference's gather clamps it implicitly, the port
    # explicitly (its weight makes the value irrelevant)
    idx = np.minimum(idx, 4 * n + 1)
    cidx = np.where(idx <= 2 * n, 2 * n - idx, idx - 1)
    return cidx, wgt


@functools.lru_cache(maxsize=None)
def _sample_layout(n: int):
    """For the 4n+1 reference samples in c-order: the group of each
    (0 bl, 1 l, 2 tl, 3 t, 4 tr) and its (dy, dx) from the block's
    top-left sample."""
    j = np.arange(4 * n + 1)
    grp = np.select([j < n, j < 2 * n, j == 2 * n, j <= 3 * n],
                    [0, 1, 2, 3], 4)
    dy = np.where(j <= 2 * n, 2 * n - 1 - j, -1)
    dx = np.where(j < 2 * n, -1, j - 2 * n - 1)
    return grp, dy, dx


def ref_sample_index(px, py, ab, cpl, n, ph, pw):
    """Host: the flat index, into a plane (or the two chroma planes
    stacked), of the sample each of a block's 4n+1 reference samples
    takes after the substitution of spec 8.4.4.2.2 (the reference's
    build_refs / _ref_cascade): in c-order an unavailable sample takes
    the nearest available one before it, and unavailable ones at the
    start the first available one.  Samples past the picture read the
    edge (build_refs' replication).  A block with no neighbour
    available gets the index one past the planes (the sample that
    holds 1 << (bd - 1)).  px, py, ab, cpl: int arrays [K] ->
    int64 [K, 4n+1]."""
    grp, dy, dx = _sample_layout(n)
    px = np.asarray(px, np.int64)
    py = np.asarray(py, np.int64)
    ab = np.asarray(ab, np.int64)
    avail = ((ab[:, None] >> _GROUP_BIT[grp][None, :]) & 1) > 0
    j = np.arange(4 * n + 1)
    last = np.maximum.accumulate(np.where(avail, j, -1), axis=1)
    first = np.argmax(avail, axis=1)
    src = np.where(last >= 0, last, first[:, None])
    rows = np.clip(py[:, None] + dy[src], 0, ph - 1)
    cols = np.clip(px[:, None] + dx[src], 0, pw - 1)
    flat = rows * pw + cols
    fill = ph * pw                       # one past the luma plane
    if cpl is not None:                  # the chroma planes stacked
        flat = flat + np.asarray(cpl, np.int64)[:, None] * (ph * pw)
        fill = 2 * ph * pw
    none = ~avail.any(axis=1)
    return np.where(none[:, None], fill, flat)


# ---------------------------------------------------------------------------
# device helpers


def _smooth(c, filt, n, bd, kinds):
    """[1 2 1] smoothing + strong bilinear (n == 32) per block, on the
    c-order samples c [K, 4n+1]: filt 0 none / 1 smooth / 2
    strong-candidate (the data test runs here).  kinds: the filter kinds
    present in the batch (host copy)."""
    s = c.clone()
    s[:, 1:4 * n] = (c[:, :-2] + 2 * c[:, 1:-1] + c[:, 2:] + 2) >> 2
    if n == 32 and R.F_STRONG in kinds:
        thr = 1 << (bd - 5)
        corner = c[:, 2 * n]
        ok = ((c[:, 2 * n] + c[:, 4 * n] - 2 * c[:, 3 * n]).abs() < thr) \
            & ((c[:, 2 * n] + c[:, 0] - 2 * c[:, n]).abs() < thr)
        # bilinear from the corner to the far end of each side; the
        # three end samples come out unchanged (weights 0 and 64)
        w = _const(c.device, ("hevc_bil_w", n), lambda: np.abs(
            np.arange(4 * n + 1) - 2 * n).astype(np.int32))
        far = torch.where(_const(c.device, ("hevc_bil_side", n),
                                 lambda: np.arange(4 * n + 1) >= 2 * n),
                          c[:, 4 * n, None], c[:, 0, None])
        b = ((64 - w) * corner[:, None] + w * far + 32) >> 6
        s = torch.where(((filt == R.F_STRONG) & ok)[:, None], b, s)
    if R.F_NONE in kinds:
        s = torch.where((filt != R.F_NONE)[:, None], s, c)
    return s


def _intra_predict(c, mode, n, is_luma, bd, modes):
    """The predictions (pre-clip, like pred_intra) of a batch of blocks
    from their c-order reference samples c [K, 4n+1]; modes: the modes
    present (host copy), so only the predictors they need are
    computed.  -> [K, n, n] int32."""
    K = c.shape[0]
    dev = c.device
    pmax = (1 << bd) - 1
    log2n = int(np.log2(n))
    lv = c[:, :2 * n].flip(1)               # left[1..2n]
    tv = c[:, 2 * n + 1:]                   # top[1..2n]
    corner = c[:, 2 * n]
    edges = is_luma and n < 32
    out = {}
    if any(m >= 2 for m in modes):
        aidx, awgt = _angular_tables(n)
        ai = _const(dev, ("hevc_ang_i", n), lambda: aidx)
        aw = _const(dev, ("hevc_ang_w", n), lambda: awgt)
        m2 = (mode - 2).clamp(0, 32).long()
        ik = ai[m2]                                   # [K, n*n, 2]
        wk = aw[m2]
        g0 = c.gather(1, ik[:, :, 0])
        g1 = c.gather(1, ik[:, :, 1])
        ang = ((wk[:, :, 0] * g0 + wk[:, :, 1] * g1 + 16) >> 5).view(K, n, n)
        if edges and 26 in modes:
            col0 = (tv[:, 0, None] + ((lv[:, :n] - corner[:, None]) >> 1)
                    ).clamp(0, pmax)
            ang = torch.where((mode == 26)[:, None, None],
                              torch.cat([col0[:, :, None], ang[:, :, 1:]], 2),
                              ang)
        if edges and 10 in modes:
            row0 = (lv[:, 0, None] + ((tv[:, :n] - corner[:, None]) >> 1)
                    ).clamp(0, pmax)
            ang = torch.where((mode == 10)[:, None, None],
                              torch.cat([row0[:, None, :], ang[:, 1:, :]], 1),
                              ang)
        out["ang"] = ang
    if 0 in modes:
        xx = _const(dev, ("hevc_ar32", n), lambda: np.arange(
            n, dtype=np.int32))
        rx = (n - 1 - xx)
        out[0] = (rx[None, None, :] * lv[:, :n, None]
                  + (xx + 1)[None, None, :] * tv[:, n, None, None]
                  + rx[None, :, None] * tv[:, None, :n]
                  + (xx + 1)[None, :, None] * lv[:, n, None, None]
                  + n) >> (log2n + 1)
    if 1 in modes:
        dc = (lv[:, :n].sum(1, dtype=torch.int32)
              + tv[:, :n].sum(1, dtype=torch.int32) + n) >> (log2n + 1)
        blk = dc[:, None, None].expand(K, n, n)
        if edges:
            e00 = (lv[:, 0] + 2 * dc + tv[:, 0] + 2) >> 2
            erow = (tv[:, 1:n] + 3 * dc[:, None] + 2) >> 2
            ecol = (lv[:, 1:n] + 3 * dc[:, None] + 2) >> 2
            top = torch.cat([e00[:, None], erow], 1)
            rest = torch.cat([ecol[:, :, None],
                              blk[:, 1:, 1:]], 2)
            blk = torch.cat([top[:, None, :], rest], 1)
        out[1] = blk
    keys = list(out)
    if len(keys) == 1:
        return out[keys[0]]
    pred = out.get("ang")
    for m in (0, 1):
        if m in out:
            pred = out[m] if pred is None else torch.where(
                (mode == m)[:, None, None], out[m], pred)
    return pred


# ---------------------------------------------------------------------------
# inter prediction


def _edge_pad(a, pt, pb, pl_, pr):
    """Edge-replicating pad of the last two dims (jnp.pad mode="edge"),
    by a clamped index gather."""
    H, W = a.shape[-2:]
    dev = a.device
    rows = _const(dev, ("hevc_padr", H, pt, pb), lambda: np.clip(
        np.arange(-pt, H + pb), 0, H - 1))
    cols = _const(dev, ("hevc_padc", W, pl_, pr), lambda: np.clip(
        np.arange(-pl_, W + pr), 0, W - 1))
    return a.index_select(-2, rows).index_select(-1, cols)


def _phase_planes(dpb, filters, pad, bd):
    """(R, H, W) refs -> (R, P, H+2*pad, W+2*pad) int32 stage-1 planes:
    plane 0 = edge-replicated raw samples, plane p>0 = horizontal
    p-phase filter >> (bd-8)."""
    taps = np.asarray(filters, np.int32)
    P, nt = taps.shape
    lo = nt // 2 - 1                    # 3 for 8-tap, 1 for 4-tap
    s1 = bd - 8
    ext = _edge_pad(dpb.to(torch.int32), pad, pad, pad, pad)
    ext2 = _edge_pad(ext, 0, 0, lo, nt - 1 - lo)
    W2 = ext.shape[2]
    planes = [ext]
    for p in range(1, P):
        acc = None
        for i in range(nt):
            t = int(taps[p, i])
            if not t:
                continue
            term = t * ext2[:, :, i:i + W2]
            acc = term if acc is None else acc + term
        planes.append(acc >> s1 if s1 else acc)
    return torch.stack(planes, dim=1)


def _mc_plane(S, vtaps, slot_px, mvx_px, mvy_px, frac_bits, H, W, pad, bd):
    """Motion-compensate one plane for one list.

    S: (R, P, Hp, Wp) stage-1 stack; vtaps (P, nt) int32 tensor;
    per-pixel slot (-1 = unused), mv in (1<<frac_bits)-pel units.
    Returns raw 14-bit-scale prediction (H, W) int32 (garbage where
    slot < 0).  Every index is clipped, as the reference's (torch
    raises on an index out of range on the CPU and reads past the
    buffer on a card); the flat index (slot*P + fx)*Hp*Wp + ... is
    int64, as torch's indexing takes it."""
    nt = vtaps.shape[1]
    lo = nt // 2 - 1
    s1 = bd - 8
    Rn, P, Hp, Wp = S.shape
    dev = S.device
    ox = _arange(dev, 0, W)[None, :]
    oy = _arange(dev, 0, H)[:, None]
    xi = (ox + (mvx_px >> frac_bits)).clamp(-pad, W - 1 + pad) + pad
    yi = (oy + (mvy_px >> frac_bits)).clamp(-pad, H - 1 + pad) + pad
    fx = mvx_px & ((1 << frac_bits) - 1)
    fy = mvy_px & ((1 << frac_bits) - 1)
    slot = slot_px.clamp(min=0).long()
    Sf = S.reshape(-1)
    base = (slot * P + fx) * Hp
    vt = vtaps[fy.long()]                              # (H, W, nt)
    acc = torch.zeros((H, W), dtype=torch.int32, device=dev)
    g_mid = None
    for j in range(nt):
        row = (yi + (j - lo)).clamp(0, Hp - 1)
        g = Sf[(base + row) * Wp + xi]
        if j == lo:
            g_mid = g
        acc = acc + vt[:, :, j] * g
    raw_hv = acc >> 6                                # fx!=0, fy!=0
    raw_v = acc >> s1 if s1 else acc                 # fx==0, fy!=0
    raw_h = g_mid                                    # fx!=0, fy==0
    raw_0 = g_mid << (14 - bd)                       # fx==0, fy==0
    return torch.where(fy == 0,
                       torch.where(fx == 0, raw_0, raw_h),
                       torch.where(fx == 0, raw_v, raw_hv))


def _rep(a, rep, H, W):
    return a.repeat_interleave(rep, 0).repeat_interleave(rep, 1)[:H, :W]


def _inter_pred(dpb, slot4, mvx4, mvy4, pf4, filters, frac_bits, sub, pad,
                bd):
    """Full-plane inter prediction for one picture plane.

    dpb (R, H, W); slot4/mvx4/mvy4 (2, H4, W4) grids at 4x4 LUMA
    granularity; pf4 (H4, W4); sub = luma-to-plane subsampling shift
    (0 luma, 1 chroma).  Returns clipped (H, W) int32 prediction."""
    Rn, H, W = dpb.shape
    rep = 4 >> sub
    S = _phase_planes(dpb, filters, pad, bd)
    key = "luma" if sub == 0 else "chroma"
    vtaps = _const(dpb.device, ("hevc_taps", key),
                   lambda: np.asarray(filters, np.int32))
    pf = _rep(pf4, rep, H, W)
    raws = [_mc_plane(S, vtaps, _rep(slot4[ll], rep, H, W),
                      _rep(mvx4[ll], rep, H, W), _rep(mvy4[ll], rep, H, W),
                      frac_bits, H, W, pad, bd) for ll in range(2)]
    sh_u, sh_b = 14 - bd, 15 - bd
    pmax = (1 << bd) - 1
    uni0 = (raws[0] + (1 << (sh_u - 1))) >> sh_u
    uni1 = (raws[1] + (1 << (sh_u - 1))) >> sh_u
    bi = (raws[0] + raws[1] + (1 << (sh_b - 1))) >> sh_b
    out = torch.where(pf == 3, bi, torch.where(pf == 2, uni1, uni0))
    return out.clamp(0, pmax)


# ---------------------------------------------------------------------------
# residual


def _mats(device, n):
    return (_const(device, ("hevc_T", n), lambda: {
        4: T.T4, 8: T.T8, 16: T.T16, 32: T.T32}[n].astype(np.float64)),
        _const(device, ("hevc_DST4",), lambda: T.DST4.astype(np.float64)))


def _two_pass(coef, t, sh2):
    """clip16((clip16((t.T @ c + 64) >> 7) @ t + rnd) >> sh2) on int32
    coef [K, n, n] by float64 products (exact: see the module's
    docstring)."""
    def c16(x):
        return x.clamp(-32768, 32767)
    tmp = c16((torch.matmul(t.T, coef.to(torch.float64)).to(torch.int32)
               + 64) >> 7)
    return c16((torch.matmul(tmp.to(torch.float64), t).to(torch.int32)
                + (1 << (sh2 - 1))) >> sh2)


def _residual_blocks(coef, kind, n, is_luma, bd, kinds):
    """(K, n, n) int32 dequantized coeffs -> residual (exact
    dsp_template.c IDCT / DST-VII / transform-skip).  kinds: the
    transform kinds present (host copy); only those are computed."""
    sh2 = 20 - bd
    t, dst = _mats(coef.device, n)
    parts = {}
    if R.K_IDCT in kinds:
        parts[R.K_IDCT] = _two_pass(coef, t, sh2)
    if n == 4 and is_luma and R.K_DST in kinds:
        parts[R.K_DST] = _two_pass(coef, dst, sh2)
    if n == 4 and R.K_TSKIP in kinds:
        tshift = 15 - bd - 2
        parts[R.K_TSKIP] = (coef + (1 << (tshift - 1))) >> tshift
    out = None
    for k, v in parts.items():
        out = v if out is None else torch.where(
            (kind == k)[:, None, None], v, out)
    return out


# ---------------------------------------------------------------------------
# the work lists on the host


def _block_offsets(device, n, width):
    """Flat offsets of an n x n block's samples in a plane `width`
    wide, row-major."""
    return _const(device, ("hevc_blk", n, width), lambda: (
        np.arange(n)[:, None] * width + np.arange(n)[None, :]).reshape(-1))


@dataclass
class FrameArgs:
    """One frame's work for the device program: the DPB stacks (None on
    a frame with no inter block), the 4x4 motion grids, one int64 buffer
    (block bases and reference-sample indices), one int32 buffer (per
    record fields), one int16 buffer of coefficients, each class's place
    in them, and the host hints.  `to(device)` copies the buffers; the
    DPB stacks are made on the device by `prepare`."""
    geom: tuple                   # (H, W, Hc, Wc, bd)
    dpb: Optional[tuple]
    motion: Optional[tuple]       # slot4, mvx4, mvy4, pf4
    i64: object
    i32: object
    coef: object
    tu: list = field(default_factory=list)      # (cls, K, o64, o32, coff,
    #                                             kinds, inside)
    intra: list = field(default_factory=list)   # (cls, K, o64, o32, inside,
    #                                             plan)
    nlev: int = 0

    def to(self, device) -> "FrameArgs":
        device = torch.device(device)

        def mv(a):
            return None if a is None else torch.from_numpy(a).to(device)
        motion = None if self.motion is None else tuple(
            mv(a) for a in self.motion)
        return FrameArgs(self.geom, self.dpb, motion, mv(self.i64),
                         mv(self.i32), mv(self.coef), self.tu, self.intra,
                         self.nlev)

    def nbytes(self) -> int:
        """The bytes `to` copies from the host."""
        return sum(a.nbytes for a in [self.i64, self.i32, self.coef]
                   + list(self.motion or ()))


class _Buffers:
    def __init__(self):
        self.parts = {np.int64: [], np.int32: [], np.int16: []}
        self.off = {np.int64: 0, np.int32: 0, np.int16: 0}

    def add(self, a, dt):
        a = np.ascontiguousarray(a, dt).reshape(-1)
        self.parts[dt].append(a)
        self.off[dt] += a.size
        return self.off[dt] - a.size

    def cat(self, dt):
        p = self.parts[dt]
        return np.concatenate(p) if p else np.zeros(1, dt)


def _inside(px, py, n, ph, pw):
    return bool((px >= 0).all() and (py >= 0).all()
                and (px + n <= pw).all() and (py + n <= ph).all())


def _intra_plan(lv, mode, filt, nlev):
    """Per level of one class (records sorted by level): None where it
    has no block, else (a, b, modes, filter kinds)."""
    counts = np.bincount(lv, minlength=nlev)
    offsets = np.zeros(nlev + 1, np.int64)
    offsets[1:] = np.cumsum(counts)
    plan = []
    for k in range(nlev):
        a, b = int(offsets[k]), int(offsets[k + 1])
        if a == b:
            plan.append(None)
            continue
        plan.append((a, b, frozenset(int(m) for m in np.unique(mode[a:b])),
                     frozenset(int(f) for f in np.unique(filt[a:b]))))
    return plan


def _slots(dec):
    """DPB slots, deduplicated by identity of the luma plane (the
    reference's id(planes[0])): a picture in both lists is one slot."""
    slots, slot_of, slot_map = [], {}, ({}, {})
    for ll in range(2):
        for r, planes in enumerate(dec.refs[ll]):
            key = id(planes[0])
            if key not in slot_of:
                slot_of[key] = len(slots)
                slots.append(planes)
            slot_map[ll][r] = slot_of[key]
    return slots, slot_map


def _stack(planes, device):
    """Reference planes (tensors on `device`, or host arrays) stacked
    into one [R, h, w] tensor there."""
    ts = [p if isinstance(p, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(p)) for p in planes]
    return torch.stack([t.to(device=device, dtype=torch.int32) for t in ts])


def build_frame_args(dec, rec: R.ReconRecorder) -> FrameArgs:
    """The frame's work lists, laid out for the device (host numpy; the
    DPB stays where the reference planes are: `prepare` stacks it)."""
    sps = dec.sps
    H, W = sps.height, sps.width
    Hc, Wc = H // 2, W // 2
    bd = dec.bd
    H4, W4 = H // 4, W // 4
    buf = _Buffers()
    fa = FrameArgs((H, W, Hc, Wc, bd), None, None, None, None, None)

    if bool((dec.pf > 0).any()):
        _, slot_map = _slots(dec)
        slot4 = np.full((2, H4, W4), -1, np.int32)
        for ll in range(2):
            use = (dec.pf & (1 << ll)) > 0
            for r, s in slot_map[ll].items():
                slot4[ll][use & (dec.refidx[:, :, ll] == r)] = s
        fa.motion = (slot4,
                     np.ascontiguousarray(dec.mvx.transpose(2, 0, 1),
                                          np.int32),
                     np.ascontiguousarray(dec.mvy.transpose(2, 0, 1),
                                          np.int32),
                     np.ascontiguousarray(dec.pf, np.int32))

    for cls in _CLASSES:
        lst = rec.tus.get(cls)
        if not lst:
            continue
        is_luma, n = cls
        ph, pw = (H, W) if is_luma else (Hc, Wc)
        px = np.fromiter((t[0] for t in lst), np.int64, len(lst))
        py = np.fromiter((t[1] for t in lst), np.int64, len(lst))
        kind = np.fromiter((t[2] for t in lst), np.int32, len(lst))
        cpl = np.fromiter((t[4] for t in lst), np.int64, len(lst))
        coef = np.stack([t[3] for t in lst]).astype(np.int16)
        base = (cpl * ph + py) * pw + px
        fa.tu.append((cls, len(lst), buf.add(base, np.int64),
                      buf.add(np.stack([px, py, cpl, kind]), np.int32),
                      buf.add(coef, np.int16),
                      frozenset(int(k) for k in np.unique(kind)),
                      _inside(px, py, n, ph, pw)))

    nlev = int(rec.max_level)
    for cls in _CLASSES:
        lst = rec.intra.get(cls)
        if not lst:
            continue
        is_luma, n = cls
        ph, pw = (H, W) if is_luma else (Hc, Wc)
        a = np.asarray(lst, np.int64)            # lvl x y mode ab filt cpl
        a = a[np.argsort(a[:, 0], kind="stable")]
        lv, px, py, mode, ab, filt, cpl = a.T
        lv = lv - 1
        plan = _intra_plan(lv, mode, filt, nlev)
        refs = ref_sample_index(px, py, ab, None if is_luma else cpl, n,
                                ph, pw)
        base = (cpl * ph + py) * pw + px
        fa.intra.append((cls, len(lst),
                         buf.add(np.concatenate([base, refs.reshape(-1)]),
                                 np.int64),
                         buf.add(np.stack([px, py, cpl, mode, filt]),
                                 np.int32),
                         _inside(px, py, n, ph, pw), plan))
    fa.nlev = nlev
    fa.i64 = buf.cat(np.int64)
    fa.i32 = buf.cat(np.int32)
    fa.coef = buf.cat(np.int16)
    return fa


# ---------------------------------------------------------------------------
# the program


def _view(P, n_planes, ph, pw):
    """A flat buffer's plane(s) as [ph, pw] (luma) or [2, ph, pw]."""
    v = P[:n_planes * ph * pw]
    return v.view(ph, pw) if n_planes == 1 else v.view(2, ph, pw)


def _block_index(base, n, pw):
    """The flat indices of the n x n blocks at each base, row-major:
    [K * n * n]."""
    return (base[:, None] + _block_offsets(base.device, n, pw)[None, :]
            ).reshape(-1)


def _get_blocks(P, idx, n, ph, pw, pos):
    """The n x n blocks of a flat buffer P at the flat indices `idx`
    (_block_index) -> [K, n*n]; idx None (a batch the host found
    reaching outside its plane) reads the clamped positions of `pos`
    (px, py, cpl), as the reference's clip."""
    if idx is not None:
        return P[idx].view(-1, n * n)
    px, py, cpl = pos
    ar = _arange(P.device, 0, n)
    rr = (py[:, None] + ar[None, :]).clamp(0, ph - 1)[:, :, None]
    cc = (px[:, None] + ar[None, :]).clamp(0, pw - 1)[:, None, :]
    if cpl is None:
        return _view(P, 1, ph, pw)[rr, cc].reshape(len(px), n * n)
    return _view(P, 2, ph, pw)[cpl[:, None, None], rr, cc].reshape(
        len(px), n * n)


def _put_blocks(P, idx, vals, n, ph, pw, pos):
    """Write the blocks vals [K, n*n] into a flat buffer P at the flat
    indices `idx`; idx None (a batch reaching outside its plane) goes
    through VP9's _put at the positions of `pos`, which drops the
    samples outside (the reference's mode="drop"), never clamping them
    onto the plane."""
    if idx is not None:
        P[idx] = vals.reshape(-1)
        return
    px, py, cpl = pos
    ar = _arange(P.device, 0, n)
    _put(_view(P, 1 if cpl is None else 2, ph, pw),
         py[:, None] + ar[None, :], px[:, None] + ar[None, :],
         vals.view(-1, n, n), cpl, False)


def _stage_residual(fa: FrameArgs):
    """Stage 1: every TU's residual, scattered into the flat residual
    buffers (luma [H*W], chroma [2*Hc*Wc])."""
    H, W, Hc, Wc, bd = fa.geom
    dev = fa.i32.device
    res_y = torch.zeros(H * W, dtype=torch.int32, device=dev)
    res_c = torch.zeros(2 * Hc * Wc, dtype=torch.int32, device=dev)
    for (is_luma, n), K, o64, o32, coff, kinds, inside in fa.tu:
        base = fa.i64[o64:o64 + K]
        px, py, cpl, kind = fa.i32[o32:o32 + 4 * K].view(4, K)
        coef = fa.coef[coff:coff + K * n * n].view(K, n, n).to(torch.int32)
        blocks = _residual_blocks(coef, kind, n, is_luma, bd, kinds)
        ph, pw = (H, W) if is_luma else (Hc, Wc)
        _put_blocks(res_y if is_luma else res_c,
                    _block_index(base, n, pw) if inside else None, blocks,
                    n, ph, pw, (px, py, None if is_luma else cpl))
    return res_y, res_c


def _stage_inter(fa: FrameArgs, res_y, res_c):
    """Stage 2: inter prediction over the DPB, the residual added where
    the pf grid is inter -> flat planes with one extra sample past the
    end holding 1 << (bd - 1) (the intra fill sample)."""
    H, W, Hc, Wc, bd = fa.geom
    dev = fa.i32.device
    pmax = (1 << bd) - 1
    Y = torch.zeros(H * W + 1, dtype=torch.int32, device=dev)
    C = torch.zeros(2 * Hc * Wc + 1, dtype=torch.int32, device=dev)
    if fa.motion is not None:
        slot4, mvx4, mvy4, pf4 = fa.motion
        dpb_y, dpb_u, dpb_v = fa.dpb
        py = _inter_pred(dpb_y, slot4, mvx4, mvy4, pf4, LUMA_FILTERS, 2, 0,
                         PAD_L, bd)
        pu = _inter_pred(dpb_u, slot4, mvx4, mvy4, pf4, CHROMA_FILTERS, 3,
                         1, PAD_C, bd)
        pv = _inter_pred(dpb_v, slot4, mvx4, mvy4, pf4, CHROMA_FILTERS, 3,
                         1, PAD_C, bd)
        inter = pf4 > 0
        m_y = _rep(inter, 4, H, W).reshape(-1)
        m_c = _rep(inter, 2, Hc, Wc).reshape(-1).repeat(2)
        pc = torch.cat([pu.reshape(-1), pv.reshape(-1)])
        Y[:H * W] = torch.where(m_y, (py.reshape(-1) + res_y).clamp(0, pmax),
                                0)
        C[:2 * Hc * Wc] = torch.where(m_c, (pc + res_c).clamp(0, pmax), 0)
    Y[H * W] = 1 << (bd - 1)
    C[2 * Hc * Wc] = 1 << (bd - 1)
    return Y, C


def _stage_intra(fa: FrameArgs, Y, C, res_y, res_c):
    """Stage 3: the intra blocks, level by level of their dependency
    order (the reference's lax.scan), on the host's loop; each class
    skipped at a level where it has no block.  Y, C written in place."""
    H, W, Hc, Wc, bd = fa.geom
    pmax = (1 << bd) - 1
    views = []
    for (is_luma, n), K, o64, o32, inside, plan in fa.intra:
        base = fa.i64[o64:o64 + K]
        refs = fa.i64[o64 + K:o64 + K + K * (4 * n + 1)].view(K, 4 * n + 1)
        rows = fa.i32[o32:o32 + 5 * K].view(5, K)   # px py cpl mode filt
        views.append((is_luma, n, base, refs, rows, inside, plan))
    for lv in range(fa.nlev):
        for is_luma, n, base, refs, rows, inside, plan in views:
            p = plan[lv]
            if p is None:
                continue
            a, b, modes, kinds = p
            P, res, ph, pw = ((Y, res_y, H, W) if is_luma
                              else (C, res_c, Hc, Wc))
            r = rows[:, a:b]
            pos = (r[0], r[1], None if is_luma else r[2])
            c = P[refs[a:b]]
            if kinds != {R.F_NONE}:
                c = _smooth(c, r[4], n, bd, kinds)
            pred = _intra_predict(c, r[3], n, is_luma, bd, modes)
            idx = _block_index(base[a:b], n, pw) if inside else None
            blk = (pred.reshape(b - a, n * n)
                   + _get_blocks(res, idx, n, ph, pw, pos))
            _put_blocks(P, idx, blk.clamp(0, pmax), n, ph, pw, pos)


def _recon_frame(fa: FrameArgs, marks=None):
    """The one-frame reconstruction on fa's device: the residual, inter
    prediction, the intra levels -> (y, u, v) int32 planes [H, W],
    [Hc, Wc] x 2.  marks: an optional callable, called with the name of
    each stage as it is queued ("residual", "inter", "intra")."""
    H, W, Hc, Wc, bd = fa.geom
    if marks is not None:
        marks("residual")
    res_y, res_c = _stage_residual(fa)
    if marks is not None:
        marks("inter")
    Y, C = _stage_inter(fa, res_y, res_c)
    if marks is not None:
        marks("intra")
    _stage_intra(fa, Y, C, res_y, res_c)
    c = C[:2 * Hc * Wc].view(2, Hc, Wc)
    return Y[:H * W].view(H, W), c[0], c[1]


def plane_dtype(bd: int) -> torch.dtype:
    """The storage type of a decoded plane on the device: uint8 at 8
    bits, int16 above (torch has no general uint16; `Frame.numpy` gives
    the reference's uint16)."""
    return torch.uint8 if bd == 8 else torch.int16


def prepare(dec, rec: R.ReconRecorder, device="cuda",
            timer: Optional[_Timer] = None):
    """The device program and its arguments, on `device`, for one frame;
    returns (fn, args) so callers (the bench replay) can run the device
    stage again without building the record: fn(args).  The DPB is
    stacked from the reference planes where they are (device tensors in
    the decoder; host arrays when fed the reference's FrameDec)."""
    device = torch.device(device)
    fa = build_frame_args(dec, rec)
    if timer is not None:
        timer.host_mark("build")
        timer.h2d_bytes = fa.nbytes()
    dev = fa.to(device)
    if dev.motion is not None:
        slots, _m = _slots(dec)
        dev.dpb = tuple(_stack([s[i] for s in slots], device)
                        for i in range(3))
    if timer is not None:
        timer.host_mark("h2d")
    return _recon_frame, dev


def reconstruct(dec, rec: R.ReconRecorder, device="cuda",
                timer: Optional[_Timer] = None):
    """The frame's pre-loop-filter planes, computed on `device` from the
    recorded work; returns (y, u, v) there in `plane_dtype(dec.bd)`.
    dec's host planes are not written (the reference copies the planes
    back to the host here; the port's decoder keeps them on the
    device).  timer: optional _Timer that gets the split."""
    if timer is not None:
        timer.host_mark("start")
    fn, args = prepare(dec, rec, device, timer)
    y, u, v = fn(args, None if timer is None else timer.dev_mark)
    dt = plane_dtype(dec.bd)
    return y.to(dt), u.to(dt), v.to(dt)
