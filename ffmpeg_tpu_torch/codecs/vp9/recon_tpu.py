"""VP9 frame reconstruction on the decoder's device, in PyTorch.

The port of ffmpeg_tpu/codecs/vp9/recon_tpu.py.  Replays the work the
parse recorded (a native_parse.NativeRecord from the C++ tile walk, or
a recorder.ReconRecorder from the Python walker): inter MC (every tile
at once: no intra-frame dependency), the inter residual, then the intra
blocks level by level of their dependency order, every block of a level
predicted, residual-added and written at once.

Exact integer math throughout, as the reference's device program:
 * MC mirrors vp9recon.c mc_luma/chroma_unscaled + do_8tap_2d through an
   always-on separable 8-tap pair (phase-0 taps are [..,128,..] and
   (128*p + 64) >> 7 == p), on int32 tensors;
 * the inverse transforms are the SAME 1-D kernels as the host path
   (itxfm.py, called with stack=torch.stack) on int32 tensors, which wrap
   as the reference's int32 program does, with the int16 store (mask16)
   between the two passes;
 * the 15 intra predictors (vp9dsp_template.c) are vectorized over
   blocks; the recorder resolved every edge-availability rule into
   gather counts.

Where the reference's program differs by being one compiled program,
the port runs eagerly:
 * the reference pads every work list to a power of two (to share
   compiled programs) and drops the padding's writes with
   `mode="drop"`; the port builds no padding.  A write that would fall
   outside its plane is still dropped: it goes to a sink element past
   the plane, never onto the plane (see _put);
 * the reference's lax.scan over intra levels runs every class at every
   level; the port loops over the levels on the host, where the
   per-level offsets are, and skips a class with no block at a level;
 * which predictors and which 1-D kernels a batch needs is read from the
   host copy of its records, so a batch computes only those (the
   reference computes all and selects; the selection gives the same
   values);
 * one frame's arguments go to the device in four copies (the DPB, one
   int32 and one int16 buffer), and the decoder's planes come back in
   three.

The reference's slice-gather MC (`_mc_tiles_sliced`, :125, and the
edge-padded DPB of `_recon_frame`'s mc_pad branch, :380-410) is not
ported: it exists because dynamic_slice beats an element gather on a
TPU, and here both are one index gather.  The windowed decoder
(models/vp9_tpu.py) runs `_mc_tiles` on the DPB it keeps on the device,
as the per-frame path runs it on the uploaded one
(tools/vp9_mc_ab_torch.py times the two forms).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

import numpy as np
import torch

from . import intra as IP
from . import itxfm as TX
from .inter import FILTERS

_CLASSES = [(True, 4), (True, 8), (True, 16), (True, 32),
            (False, 4), (False, 8), (False, 16), (False, 32)]
_MC_CLASSES = [(True, 8), (True, 4), (False, 8), (False, 4)]

_consts: Dict[tuple, torch.Tensor] = {}


def _const(device: torch.device, key, make) -> torch.Tensor:
    """A constant tensor on `device`, made once (index tables, aranges,
    the filter table): a fresh host-to-device copy per use would make the
    host wait for the device."""
    k = (str(device),) + key
    t = _consts.get(k)
    if t is None:
        t = _consts[k] = torch.as_tensor(make(), device=device)
    return t


def _arange(device, lo, hi):
    return _const(device, ("arange", lo, hi),
                  lambda: np.arange(lo, hi, dtype=np.int64))


# -- residual ------------------------------------------------------------

def _mask16(a):
    return ((a + 0x8000) & 0xFFFF) - 0x8000


def _pass(x, adst, n):
    """One 1-D pass over the columns of x [n, K*n]: DCT where `adst` is
    False, ADST where True; a bool tensor [K] selects per block."""
    dct = TX._KERNELS[(n, "dct")]
    if n == 32 or adst is False:
        return dct(x, stack=torch.stack)
    ad = TX._KERNELS[(n, "adst")]
    if adst is True:
        return ad(x, stack=torch.stack)
    sel = adst.repeat_interleave(n)[None, :]
    return torch.where(sel, ad(x, stack=torch.stack),
                       dct(x, stack=torch.stack))


def _itx_batch(coef, adst_col, adst_row, n):
    """Batched itxfm (itxfm.py itxfm_add without the add): coef
    [K, n, n] int32; adst_* a bool tensor [K], or False / True for the
    whole batch -> residual [K, n, n] int32."""
    K = coef.shape[0]
    bits = TX._BITS[n]
    # pass 1: transform columns. x[i] spans (k, j) columns.
    x = coef.permute(1, 0, 2).reshape(n, K * n)
    a = _mask16(_pass(x, adst_col, n)).reshape(n, K, n).permute(1, 0, 2)
    # pass 2: transform rows of a (kernel input x[i] = a[:, i])
    x2 = a.permute(2, 0, 1).reshape(n, K * n)
    r = _mask16(_pass(x2, adst_row, n)).reshape(n, K, n).permute(1, 0, 2)
    return (r + (1 << (bits - 1))) >> bits


# -- inter MC -------------------------------------------------------------

def _mc_tiles(dpb, pw, ph, t, shift, args, any_comp=True):
    """dpb [R, H, W] (chroma: [R*2, H, W], cpl folded into the slot by
    the caller); args: dy, dx, mvx0, mvy0, s0, mvx1, mvy1, s1, comp, filt
    int32 [K] -> [K, t, t] int32 predictions.  any_comp=False (no tile
    of the batch is compound) skips the second prediction, which the
    select would discard."""
    dy, dx, mvx0, mvy0, s0, mvx1, mvy1, s1, comp, filt = args
    mask = (1 << shift) - 1
    dev = dpb.device
    win_off = _arange(dev, -3, t + 4)
    ftab = _const(dev, ("vp9_filters",), lambda: FILTERS)   # [4][16][8]

    def one(mvx, mvy, slot):
        x = dx + (mvx >> shift)
        y = dy + (mvy >> shift)
        fx = (mvx & mask) << (4 - shift)
        fy = (mvy & mask) << (4 - shift)
        rows = (y[:, None] + win_off[None, :]).clamp(0, ph - 1)
        cols = (x[:, None] + win_off[None, :]).clamp(0, pw - 1)
        win = dpb[slot[:, None, None], rows[:, :, None],
                  cols[:, None, :]].to(torch.int32)
        Fx = ftab[filt, fx]                       # [K, 8]
        Fy = ftab[filt, fy]
        acc = Fx[:, 0, None, None] * win[:, :, 0:t]
        for j in range(1, 8):
            acc = acc + Fx[:, j, None, None] * win[:, :, j:j + t]
        h = ((acc + 64) >> 7).clamp(0, 255)
        acc = Fy[:, 0, None, None] * h[:, 0:t, :]
        for j in range(1, 8):
            acc = acc + Fy[:, j, None, None] * h[:, j:j + t, :]
        return ((acc + 64) >> 7).clamp(0, 255)

    p0 = one(mvx0, mvy0, s0)
    if not any_comp:
        return p0
    p1 = one(mvx1, mvy1, s1)
    return torch.where(comp[:, None, None] > 0, (p0 + p1 + 1) >> 1, p0)


# -- intra predictors ------------------------------------------------------

def _interleave(a, b):
    """[K, m], [K, m] -> [K, 2m] with a at even, b at odd indices."""
    return torch.stack([a, b], dim=2).reshape(a.shape[0], -1)


def _gather(v, idx, key):
    """v [K, m], idx static [n, n] int (cached on v's device under
    `key`) -> [K, n, n]."""
    return v[:, _const(v.device, key, lambda: np.asarray(idx, np.int64))]


def _predict_all(left, top, tl, n, modes=None):
    """The VP9 predictors, vectorized over K blocks: left [K, n]
    (bottom-up for every mode except HU, whose caller gathered it
    top-down), top [K, 2n], tl [K] -> {mode: [K, n, n]} for each mode of
    `modes` (all 15 when None)."""
    K = left.shape[0]
    dev = left.device
    want = set(range(15)) if modes is None else set(int(m) for m in modes)
    ii = np.arange(n)
    t, lf = top, left
    out = {}
    full = (K, n, n)
    bl = int(n).bit_length()

    def s(x):
        return x.sum(1, dtype=torch.int32)
    if IP.VERT in want:
        out[IP.VERT] = t[:, None, :n].expand(full)
    if IP.HOR in want:
        out[IP.HOR] = lf.flip(1)[:, :, None].expand(full)
    if IP.DC in want:
        dc = (s(lf[:, :n]) + s(t[:, :n]) + n) >> bl
        out[IP.DC] = dc[:, None, None].expand(full)
    if IP.LEFT_DC in want:
        ldc = (s(lf[:, :n]) + (n >> 1)) >> (bl - 1)
        out[IP.LEFT_DC] = ldc[:, None, None].expand(full)
    if IP.TOP_DC in want:
        tdc = (s(t[:, :n]) + (n >> 1)) >> (bl - 1)
        out[IP.TOP_DC] = tdc[:, None, None].expand(full)
    for m, c in ((IP.DC_128, 128), (IP.DC_127, 127), (IP.DC_129, 129)):
        if m in want:
            out[m] = torch.full(full, c, dtype=torch.int32, device=dev)
    if IP.TM in want:
        out[IP.TM] = (t[:, None, :n] + (lf.flip(1) - tl[:, None])[:, :, None]
                      ).clamp(0, 255)

    if IP.DDL in want:
        if n == 4:
            a = t[:, :8]
            vals = (a[:, :6] + 2 * a[:, 1:7] + a[:, 2:8] + 2) >> 2
            v2 = torch.cat([vals, a[:, 7:8]], 1)
            idx = np.minimum(ii[:, None] + ii[None, :], 6)
        else:
            t3 = torch.cat([t[:, 2:n], t[:, n - 1:n]], 1)
            v = (t[:, :n - 1] + 2 * t[:, 1:n] + t3 + 2) >> 2
            v2 = torch.cat([v, t[:, n - 1:n]], 1)
            idx = np.minimum(ii[:, None] + ii[None, :], n - 1)
        out[IP.DDL] = _gather(v2, idx, ("ddl", n))

    if IP.DDR in want:
        # v = [left-smoothed (n-2), 3 corner terms, top-smoothed]
        vl_ = (lf[:, :n - 2] + 2 * lf[:, 1:n - 1] + lf[:, 2:n] + 2) >> 2
        c0 = (lf[:, n - 2] + 2 * lf[:, n - 1] + tl + 2) >> 2
        c1 = (lf[:, n - 1] + 2 * tl + t[:, 0] + 2) >> 2
        c2 = (tl + 2 * t[:, 0] + t[:, 1] + 2) >> 2
        vt_ = (t[:, :n - 2] + 2 * t[:, 1:n - 1] + t[:, 2:n] + 2) >> 2
        v = torch.cat([vl_, c0[:, None], c1[:, None], c2[:, None], vt_], 1)
        idx = (n - 1) - ii[:, None] + ii[None, :]
        out[IP.DDR] = _gather(v, idx, ("ddr", n))

    h = n // 2
    if IP.VR in want:
        vo_h = (lf[:, 3:n - 1:2] + 2 * lf[:, 2:n - 2:2]
                + lf[:, 1:n - 4 + 1:2] + 2) >> 2
        ve_h = (lf[:, 4:n - 1 + 1:2] + 2 * lf[:, 3:n - 1:2]
                + lf[:, 2:n - 2:2] + 2) >> 2
        vo_m = (lf[:, n - 1] + 2 * lf[:, n - 2] + lf[:, n - 3] + 2) >> 2
        ve_m = (tl + 2 * lf[:, n - 1] + lf[:, n - 2] + 2) >> 2
        ve_c = (tl + t[:, 0] + 1) >> 1
        vo_c = (lf[:, n - 1] + 2 * tl + t[:, 0] + 2) >> 2
        ve_t = (t[:, :n - 1] + t[:, 1:n] + 1) >> 1
        pm1 = torch.cat([tl[:, None], t[:, :n - 2]], 1)
        vo_t = (pm1 + 2 * t[:, :n - 1] + t[:, 1:n] + 2) >> 2
        ve = torch.cat([ve_h, ve_m[:, None], ve_c[:, None], ve_t], 1)
        vo = torch.cat([vo_h, vo_m[:, None], vo_c[:, None], vo_t], 1)
        jj = np.arange(h)
        idx = (h - 1) - jj[:, None] + ii[None, :]     # [h, n]
        rows_e = _gather(ve, idx, ("vr", n))
        rows_o = _gather(vo, idx, ("vr", n))
        out[IP.VR] = torch.stack([rows_e, rows_o], 2).reshape(K, n, n)

    if IP.HD in want:
        # v = [interleaved left pairs (2n-4), 4 corners, top (n-2)]
        pm1 = torch.cat([tl[:, None], t[:, :n - 2]], 1)
        e_h = (lf[:, 1:n - 1] + lf[:, :n - 2] + 1) >> 1
        o_h = (lf[:, 2:n] + 2 * lf[:, 1:n - 1] + lf[:, :n - 2] + 2) >> 2
        head = _interleave(e_h, o_h)
        c0 = (lf[:, n - 1] + lf[:, n - 2] + 1) >> 1
        c1 = (tl + 2 * lf[:, n - 1] + lf[:, n - 2] + 2) >> 2
        c2 = (tl + lf[:, n - 1] + 1) >> 1
        c3 = (t[:, 0] + 2 * tl + lf[:, n - 1] + 2) >> 2
        tail = (pm1[:, :n - 2] + 2 * t[:, :n - 2] + t[:, 1:n - 1] + 2) >> 2
        v = torch.cat([head, c0[:, None], c1[:, None], c2[:, None],
                       c3[:, None], tail], 1)
        idx = (2 * n - 2) - 2 * ii[:, None] + ii[None, :]
        out[IP.HD] = _gather(v, idx, ("hd", n))

    if IP.VL in want:
        if n == 4:
            a = t[:, :7]
            E = (a[:, :5] + a[:, 1:6] + 1) >> 1
            O = (a[:, :5] + 2 * a[:, 1:6] + a[:, 2:7] + 2) >> 2
            idx = np.arange(2)[:, None] + np.arange(4)[None, :]
            rows_e = _gather(E, idx, ("vl", n))
            rows_o = _gather(O, idx, ("vl", n))
            out[IP.VL] = torch.stack([rows_e, rows_o], 2).reshape(K, 4, 4)
        else:
            t3 = torch.cat([t[:, 2:n], t[:, n - 1:n]], 1)
            ve = (t[:, :n - 1] + t[:, 1:n] + 1) >> 1
            vo = (t[:, :n - 1] + 2 * t[:, 1:n] + t3 + 2) >> 2
            ve2 = torch.cat([ve, t[:, n - 1:n]], 1)
            vo2 = torch.cat([vo, t[:, n - 1:n]], 1)
            jj = np.arange(n // 2)
            idx = np.minimum(jj[:, None] + ii[None, :], n - 1)
            rows_e = _gather(ve2, idx, ("vl", n))
            rows_o = _gather(vo2, idx, ("vl", n))
            out[IP.VL] = torch.stack([rows_e, rows_o], 2).reshape(K, n, n)

    if IP.HU in want:
        # left gathered top-down by the caller for this mode
        if n == 4:
            l0, l1, l2, l3 = (lf[:, 0], lf[:, 1], lf[:, 2], lf[:, 3])
            q = torch.stack([(l0 + l1 + 1) >> 1, (l0 + 2 * l1 + l2 + 2) >> 2,
                             (l1 + l2 + 1) >> 1, (l1 + 2 * l2 + l3 + 2) >> 2,
                             (l2 + l3 + 1) >> 1, (l2 + 3 * l3 + 2) >> 2,
                             l3], 1)
            idx = np.minimum(2 * ii[:, None] + ii[None, :], 6)
            out[IP.HU] = _gather(q, idx, ("hu", n))
        else:
            lf3 = torch.cat([lf[:, 2:n], lf[:, n - 1:n]], 1)
            e_h = (lf[:, :n - 1] + lf[:, 1:n] + 1) >> 1
            o_h = (lf[:, :n - 1] + 2 * lf[:, 1:n] + lf3 + 2) >> 2
            v = _interleave(e_h, o_h)                # [K, 2n-2]
            v2 = torch.cat([v, lf[:, n - 1:n]], 1)
            idx = np.minimum(2 * ii[:, None] + ii[None, :], 2 * n - 2)
            out[IP.HU] = _gather(v2, idx, ("hu", n))
    return out


def _put(P, rr, cc, vals, cpl=None, inside=True):
    """P[(cpl,) rr, cc] = vals for blocks of rows rr [K, n] and columns
    cc [K, n]: the reference's `.at[...].set(..., mode="drop")`.  When
    the caller has checked on the host that every block lies inside P
    (`inside`), a plain indexed write; otherwise each element outside P
    is written to a sink element past P's end and never onto P (a
    clamped index would land on a real block, and two writes to one
    element of P race on a card)."""
    if inside:
        if cpl is None:
            P[rr[:, :, None], cc[:, None, :]] = vals
        else:
            P[cpl[:, None, None], rr[:, :, None], cc[:, None, :]] = vals
        return
    H, W = P.shape[-2:]
    ok = (((rr >= 0) & (rr < H))[:, :, None]
          & ((cc >= 0) & (cc < W))[:, None, :])
    lin = rr[:, :, None].long() * W + cc[:, None, :]
    if cpl is not None:
        lin = lin + cpl[:, None, None].long() * (H * W)
    sink = P.numel()
    lin = torch.where(ok, lin, sink)
    flat = torch.cat([P.reshape(-1), P.new_zeros(1)])
    flat[lin.reshape(-1)] = vals.reshape(-1)
    P.copy_(flat[:sink].view(P.shape))


def _intra_level(P, pw, ph, n, args, chroma, hint):
    """One level's blocks for one class against plane(s) P (luma: [H, W];
    chroma: [2, H, W] indexed by cpl), written in place.  hint: what the
    host copy of the batch says (_LevelHint).  `res` is the blocks'
    residual, which _stage_intra computes for all levels at once (it
    reads the coefficients alone); the reference computes it here."""
    (px, py, mode, m_top, m_left, tl_sel, cpl, res) = args
    K = px.shape[0]
    dev = P.device
    ii = _arange(dev, 0, n)

    def rd(r, c):
        r = r.clamp(0, ph - 1)
        c = c.clamp(0, pw - 1)
        if chroma:
            return P[cpl[:, None], r, c] if r.ndim == 2 else P[cpl, r, c]
        return P[r, c]

    i2 = _arange(dev, 0, 2 * n)
    t_c = px[:, None] + torch.minimum(i2[None, :], m_top[:, None] - 1)
    top = torch.where(m_top[:, None] > 0, rd((py - 1)[:, None], t_c), 127)
    if hint.has_hu:
        inv = (mode == IP.HU)[:, None]
        l_off = torch.where(
            inv, torch.minimum(ii[None, :], m_left[:, None] - 1),
            torch.minimum(n - 1 - ii[None, :], m_left[:, None] - 1))
    else:
        l_off = torch.minimum(n - 1 - ii[None, :], m_left[:, None] - 1)
    left = torch.where(m_left[:, None] > 0,
                       rd(py[:, None] + l_off, (px - 1)[:, None]), 129)
    tlp = rd(py - 1, px - 1)
    tl = torch.where(tl_sel == 2, tlp,
                     torch.where(tl_sel == 1, 129, 127).to(torch.int32))

    preds = _predict_all(left, top, tl, n, hint.modes)
    if len(hint.modes) == 1:
        pred = preds[hint.modes[0]]
    else:
        stack = torch.stack([preds[m] for m in hint.modes])
        pred = stack.gather(0, hint.sel[None, :, None, None].expand(
            1, K, n, n))[0]
    pred = pred.clamp(0, 255)
    vals = (pred + res).clamp(0, 255)
    rr = py[:, None] + ii[None, :]
    cc = px[:, None] + ii[None, :]
    _put(P, rr, cc, vals, cpl if chroma else None, hint.inside)


# -- the work lists on the host ----------------------------------------------

@dataclass
class _LevelHint:
    """What the host copy says of one class's blocks at one level: the
    predictor modes present (sorted), each block's index into them
    (`sel`, on the device, a slice of the frame's buffer), whether a
    block predicts HU, and whether every block lies inside its plane."""
    modes: list
    sel: Optional[torch.Tensor]
    has_hu: bool
    inside: bool


def _kind(flags: np.ndarray):
    if not flags.any():
        return False
    return True if flags.all() else None


_MC_ROWS = 11      # dy, dx, mx0, my0, s0, mx1, my1, s1, comp, filt, cpl
_TU_ROWS = 3       # px, py, cpl
_IN_ROWS = 10      # px, py, mode, m_top, m_left, tl_sel, cpl, acol, arow, sel


@dataclass
class FrameArgs:
    """One frame's work for the device program: the DPB (None when no MC
    tile reads it), one flat int32 buffer of every per-record field, one
    flat buffer of every coefficient (int16 from the C++ parse, as the
    reference's wire format; int32 from the Python walker), each class's
    place in them, and the host copies the program reads its hints from.
    `to(device)` copies the buffers; the layout stays."""
    geom: tuple                   # (H, W, Hc, Wc, dw, dh)
    dpb_y: object
    dpb_c: object
    i32: object
    coef: object
    mc: list = field(default_factory=list)      # (cls, K, off, any_comp,
    #                                             inside)
    tu: list = field(default_factory=list)      # (cls, K, off, coff,
    #                                             inside)
    intra: list = field(default_factory=list)   # (cls, K, off, coff, plan,
    #                                             column kind, row kind)
    nlev: int = 0

    def to(self, device) -> "FrameArgs":
        device = torch.device(device)

        def mv(a):
            return None if a is None else torch.from_numpy(a).to(device)
        return FrameArgs(self.geom, mv(self.dpb_y), mv(self.dpb_c),
                         mv(self.i32), mv(self.coef), self.mc, self.tu,
                         self.intra, self.nlev)

    def nbytes(self) -> int:
        """The bytes `to` copies."""
        return sum(a.nbytes for a in (self.dpb_y, self.dpb_c, self.i32,
                                      self.coef) if a is not None)


def _level_plan(meta, offsets, n, plane_hw):
    """Host hints per level for one intra class: meta [K, 3] rows (px,
    py, mode) in level order.  Returns (sel [K] int32, [(a, b, modes,
    has_hu, inside) for each level, None where it has no block])."""
    sel = np.zeros(len(meta), np.int32)
    plan = []
    H, W = plane_hw
    for lv in range(len(offsets) - 1):
        a, b = int(offsets[lv]), int(offsets[lv + 1])
        if a == b:
            plan.append(None)
            continue
        m = meta[a:b]
        modes = np.unique(m[:, 2])
        sel[a:b] = np.searchsorted(modes, m[:, 2])
        inside = bool((m[:, 0] + n <= W).all() and (m[:, 1] + n <= H).all()
                      and (m[:, :2] >= 0).all())
        plan.append((a, b, [int(x) for x in modes],
                     bool((m[:, 2] == IP.HU).any()), inside))
    return sel, plan


def build_frame_args(rec, smap, geom, coef_dtype=np.int16) -> FrameArgs:
    """The frame's work lists, from a NativeRecord (or the arrays
    prepare() makes of a ReconRecorder), laid out for the device.

    smap: int32 [3] mapping record ref ids (0..2) to DPB slot indices;
    geom: (H, W, Hc, Wc, dw, dh).  Coefficients are stored as
    `coef_dtype`: int16 is the reference's wire format for the native
    path (build_frame_args), int32 its format for the walker's records
    (prepare)."""
    H, W, Hc, Wc, _dw, _dh = geom
    txtp_adst_col = np.zeros(4, bool)
    txtp_adst_row = np.zeros(4, bool)
    for t in range(4):
        ka, kb = TX._TXTP[t]
        txtp_adst_col[t] = ka == "adst"
        txtp_adst_row[t] = kb == "adst"
    parts32: List[np.ndarray] = []
    parts16: List[np.ndarray] = []
    o32 = o16 = 0
    fa = FrameArgs(geom, None, None, None, None)

    def add32(a):
        nonlocal o32
        a = np.ascontiguousarray(a, np.int32).reshape(-1)
        parts32.append(a)
        o32 += a.size
        return o32 - a.size

    def addc(a):
        nonlocal o16
        a = np.ascontiguousarray(a).astype(coef_dtype, copy=False).reshape(-1)
        parts16.append(a)
        o16 += a.size
        return o16 - a.size

    for cls in _MC_CLASSES:
        raw = rec.mc_arr.get(cls)
        k0 = 0 if raw is None else len(raw)
        if not k0:
            continue
        r = raw.T
        arr = np.stack([r[1], r[2], r[3], r[4], smap[r[5]], r[6], r[7],
                        smap[r[8]], r[9], r[10], np.maximum(r[0] - 1, 0)])
        t = cls[1]
        ph, pw = (H, W) if cls[0] else (Hc, Wc)
        inside = bool((r[1] >= 0).all() and (r[2] >= 0).all()
                      and (r[1] + t <= ph).all() and (r[2] + t <= pw).all())
        fa.mc.append((cls, k0, add32(arr), bool(r[9].any()), inside))

    for cls in _CLASSES:
        meta, coefs = rec.tu_arr.get(cls, (None, None))
        k0 = 0 if meta is None else len(meta)
        if not k0:
            continue
        n = cls[1]
        ph, pw = (H, W) if cls[0] else (Hc, Wc)
        inside = bool((meta[:, :2] >= 0).all() and
                      (meta[:, 0] + n <= pw).all() and
                      (meta[:, 1] + n <= ph).all())
        fa.tu.append((cls, k0, add32(meta[:, :3].T), addc(coefs), inside))

    nlev = int(rec.max_level)
    for cls in _CLASSES:
        meta, coefs = rec.in_arr.get(cls, (None, None))
        k0 = 0 if meta is None else len(meta)
        if not k0:
            continue
        n = cls[1]
        lv = meta[:, 0] - 1
        order = np.argsort(lv, kind="stable")
        counts = np.bincount(lv[order], minlength=nlev)
        offsets = np.zeros(len(counts) + 1, np.int64)
        offsets[1:] = np.cumsum(counts)
        ms = meta[order]
        acol = txtp_adst_col[ms[:, 7]]
        arow = txtp_adst_row[ms[:, 7]]
        # px, py, mode, m_top, m_left, tl_sel, cpl, acol, arow
        rows = np.stack([ms[:, 1], ms[:, 2], ms[:, 3], ms[:, 4], ms[:, 5],
                         ms[:, 6], ms[:, 8], acol, arow]).astype(np.int32)
        ph, pw = (H, W) if cls[0] else (Hc, Wc)
        sel, plan = _level_plan(rows[:3].T, offsets, n, (ph, pw))
        off = add32(np.concatenate([rows, sel[None]], 0))
        fa.intra.append((cls, k0, off, addc(coefs[order]), plan,
                         _kind(acol), _kind(arow)))
    fa.nlev = nlev
    fa.i32 = (np.concatenate(parts32) if parts32
              else np.zeros(1, np.int32))
    fa.coef = (np.concatenate(parts16) if parts16
               else np.zeros(1, coef_dtype))
    return fa


# -- program ---------------------------------------------------------------

def _stage_mc(Y, C, fa: FrameArgs):
    """Stage A: inter MC of every tile, written into Y [H, W] and
    C [2, Hc, Wc] (int32, in place)."""
    H, W, Hc, Wc, dw, dh = fa.geom
    for (is_luma, t), K, off, any_comp, inside in fa.mc:
        a = fa.i32[off:off + _MC_ROWS * K].view(_MC_ROWS, K)
        dy, dx, cpl = a[0], a[1], a[10]
        if is_luma:
            pred = _mc_tiles(fa.dpb_y, dw, dh, t, 3, tuple(a[:10]), any_comp)
        else:
            Rn = fa.dpb_c.shape[0]
            dpbf = fa.dpb_c.reshape(Rn * 2, Hc, Wc)
            aa = list(a[:10])
            # fold cpl into the slot index
            aa[4] = a[4] * 2 + cpl
            aa[7] = a[7] * 2 + cpl
            pred = _mc_tiles(dpbf, (dw + 1) // 2, (dh + 1) // 2, t, 4,
                             tuple(aa), any_comp)
        ar = _arange(Y.device, 0, t)
        rr = dy[:, None] + ar[None, :]
        cc = dx[:, None] + ar[None, :]
        if is_luma:
            _put(Y, rr, cc, pred, None, inside)
        else:
            _put(C, rr, cc, pred, cpl, inside)


def _stage_residual(Y, C, fa: FrameArgs):
    """Stage B: the inter residual (DCT_DCT only), added in place."""
    H, W, Hc, Wc, _dw, _dh = fa.geom
    for (is_luma, n), K, off, coff, inside in fa.tu:
        px, py, cpl = fa.i32[off:off + _TU_ROWS * K].view(_TU_ROWS, K)
        coef = fa.coef[coff:coff + K * n * n].view(K, n, n)
        res = _itx_batch(coef, False, False, n)
        ar = _arange(Y.device, 0, n)
        rr = py[:, None] + ar[None, :]
        cc = px[:, None] + ar[None, :]
        if is_luma:
            cur = Y[rr.clamp(0, H - 1)[:, :, None],
                    cc.clamp(0, W - 1)[:, None, :]]
            _put(Y, rr, cc, (cur + res).clamp(0, 255), None, inside)
        else:
            cur = C[cpl[:, None, None], rr.clamp(0, Hc - 1)[:, :, None],
                    cc.clamp(0, Wc - 1)[:, None, :]]
            _put(C, rr, cc, (cur + res).clamp(0, 255), cpl, inside)


def _stage_intra(Y, C, fa: FrameArgs):
    """Stage C: the intra blocks, level by level of their dependency
    order (the reference's lax.scan at :481), on the host's loop.  Each
    class's residual is computed first, for all its levels in one batch:
    it depends on the coefficients alone."""
    H, W, Hc, Wc, _dw, _dh = fa.geom
    views = []
    for (is_luma, n), K, off, coff, plan, kcol, krow in fa.intra:
        rows = fa.i32[off:off + _IN_ROWS * K].view(_IN_ROWS, K)
        coef = fa.coef[coff:coff + K * n * n].view(K, n, n)
        res = _itx_batch(coef, rows[7] > 0 if kcol is None else kcol,
                         rows[8] > 0 if krow is None else krow, n)
        views.append((is_luma, n, rows, res, plan))
    for lv in range(fa.nlev):
        for is_luma, n, rows, res, plan in views:
            p = plan[lv] if lv < len(plan) else None
            if p is None:
                continue
            a, b, modes, has_hu, inside = p
            r = rows[:, a:b]
            hint = _LevelHint(modes, r[9] if len(modes) > 1 else None,
                              has_hu, inside)
            args = (r[0], r[1], r[2], r[3], r[4], r[5], r[6], res[a:b])
            if is_luma:
                _intra_level(Y, W, H, n, args, False, hint)
            else:
                _intra_level(C, Wc, Hc, n, args, True, hint)


def _recon_frame(fa: FrameArgs, marks=None):
    """The one-frame reconstruction program on fa's device: MC, the inter
    residual, the intra levels -> (y, u, v) uint8 planes [H, W],
    [Hc, Wc] x 2.  marks: an optional callable, called with the name of
    each stage as it is queued ("mc", "residual", "intra"; the phase-13
    timer)."""
    H, W, Hc, Wc, _dw, _dh = fa.geom
    dev = fa.i32.device
    # coefficients widened once (int16 wire format -> the int32 program)
    fa = replace(fa, coef=fa.coef.to(torch.int32))
    Y = torch.zeros((H, W), dtype=torch.int32, device=dev)
    C = torch.zeros((2, Hc, Wc), dtype=torch.int32, device=dev)
    for name, stage in (("mc", _stage_mc), ("residual", _stage_residual),
                        ("intra", _stage_intra)):
        if marks is not None:
            marks(name)
        stage(Y, C, fa)
    return Y.to(torch.uint8), C[0].to(torch.uint8), C[1].to(torch.uint8)


def _dpb_arrays(fs):
    """DPB planes + slot map for the frame's (up to 3) refs."""
    H, W = fs.y.shape
    Hc, Wc = fs.u.shape
    slots, slot_of = [], {}
    for r in fs.refs:
        if r is not None and id(r[0]) not in slot_of:
            slot_of[id(r[0])] = len(slots)
            slots.append(r)
    Rn = max(1, len(slots))
    dpb_y = np.zeros((Rn, H, W), np.uint8)
    dpb_c = np.zeros((Rn, 2, Hc, Wc), np.uint8)
    for i, (ry, ru, rv, _w, _h) in enumerate(slots):
        dpb_y[i, :ry.shape[0], :ry.shape[1]] = ry
        dpb_c[i, 0, :ru.shape[0], :ru.shape[1]] = ru
        dpb_c[i, 1, :rv.shape[0], :rv.shape[1]] = rv
    smap = np.zeros(3, np.int32)
    for i in range(3):
        if fs.refs and i < len(fs.refs) and fs.refs[i] is not None:
            smap[i] = slot_of[id(fs.refs[i][0])]
    return dpb_y, dpb_c, smap


def _geom(fs):
    H, W = fs.y.shape
    Hc, Wc = fs.u.shape
    return (H, W, Hc, Wc, fs.h.width, fs.h.height)


def _with_dpb(fa: FrameArgs, dpb_y, dpb_c) -> FrameArgs:
    if fa.mc:                      # the DPB is read by MC alone
        fa.dpb_y, fa.dpb_c = dpb_y, dpb_c
    return fa


class _Arrays:
    """A ReconRecorder's lists in NativeRecord's array layout."""

    def __init__(self, rec):
        from .native_parse import CLASSES, MC_CLASSES
        self.max_level = rec.max_level
        self.mc_arr = {cls: np.asarray(rec.mc[cls], np.int32).reshape(-1, 11)
                       for cls in MC_CLASSES if rec.mc.get(cls)}
        self.tu_arr, self.in_arr = {}, {}
        for cls in CLASSES:
            n = cls[1]
            lst = rec.tus.get(cls)
            if lst:
                self.tu_arr[cls] = (
                    np.asarray([(x, y, pl) for x, y, _c, pl in lst],
                               np.int32),
                    np.stack([np.asarray(c, np.int32).reshape(n * n)
                              for _x, _y, c, _p in lst]))
            lst = rec.intra.get(cls)
            if lst:
                self.in_arr[cls] = (
                    np.asarray([it[:8] + (it[9],) for it in lst], np.int32),
                    np.stack([np.asarray(it[8], np.int32).reshape(n * n)
                              for it in lst]))


def prepare(fs, rec):
    """The device program and its host arguments for one frame recorded
    by the Python walker (recorder.ReconRecorder); returns (fn, args)
    so a caller can run the device stage again: fn(args.to(device))."""
    dpb_y, dpb_c, smap = _dpb_arrays(fs)
    fa = build_frame_args(_Arrays(rec), smap, _geom(fs), np.int32)
    return _recon_frame, _with_dpb(fa, dpb_y, dpb_c)


def prepare_native(fs, rec):
    """prepare() from a native_parse.NativeRecord (flat arrays,
    numpy-vectorized — no per-record Python)."""
    dpb_y, dpb_c, smap = _dpb_arrays(fs)
    fa = build_frame_args(rec, smap, _geom(fs))
    return _recon_frame, _with_dpb(fa, dpb_y, dpb_c)


class _Timer:
    """Phase 13's per-frame split: host stages on the host's clock, the
    device stages by CUDA events on a card (on the CPU, where each op
    runs as it is called, by the host's clock)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.host: Dict[str, float] = {}
        self.h2d_bytes = 0
        self.events: list = []
        self._t = time.perf_counter()

    def host_mark(self, name):
        now = time.perf_counter()
        self.host[name] = (now - self._t) * 1e3
        self._t = now

    def dev_mark(self, name):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append((name, e))
        else:
            self.events.append((name, time.perf_counter()))

    def device_ms(self) -> Dict[str, float]:
        out = {}
        for (n0, e0), (_n1, e1) in zip(self.events, self.events[1:]):
            out[n0] = (e0.elapsed_time(e1) if self.cuda
                       else (e1 - e0) * 1e3)
        return out


def reconstruct(fs, rec, device="cuda", timer: Optional[_Timer] = None):
    """Fill fs.y/u/v (pre-loop-filter) from the recorded work, computed
    on `device`; returns the planes there (y, u, v, uint8, fs's padded
    shapes).  timer: optional _Timer that gets the split (argument
    build, h2d, the device stages, d2h)."""
    from .native_parse import NativeRecord
    device = torch.device(device)
    if timer is not None:
        timer.host_mark("start")
    if isinstance(rec, NativeRecord):
        fn, args = prepare_native(fs, rec)
    else:
        fn, args = prepare(fs, rec)
    if timer is not None:
        timer.host_mark("build")
        timer.h2d_bytes = args.nbytes()
    dev_args = args.to(device)
    if timer is not None:
        timer.host_mark("h2d")
    y, u, v = fn(dev_args, None if timer is None else timer.dev_mark)
    if timer is not None:
        timer.host_mark("queue")     # the host's launches
        timer.dev_mark("d2h")
    fs.y[:] = y.cpu().numpy()
    fs.u[:] = u.cpu().numpy()
    fs.v[:] = v.cpu().numpy()
    if timer is not None:
        timer.dev_mark("done")
        timer.host_mark("d2h")       # includes waiting for the device
    return y, u, v
