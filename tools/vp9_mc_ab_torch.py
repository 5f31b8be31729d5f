#!/usr/bin/env python3
"""The windowed VP9 decoder's inter MC in two forms, on one card: the
form the decoder runs (recon_tpu._stage_mc: _mc_tiles, one element
gather per tile class straight from the 8-slot DPB kept on the card,
each coordinate clamped to the frame) against the reference's
slice-gather form (ffmpeg_tpu/codecs/vp9/recon_tpu.py _mc_tiles_sliced
:125 and the mc_pad branch of _recon_frame :380-410: the DPB cropped
and edge-padded by P once a frame, then each tile's (t+7)^2 window one
slice of it), kept in this file only, for this comparison.

For each inter frame named (default 3 and 50 of the committed 100-frame
1920x1080 bench stream), a Vp9TpuDecoder decodes the frames before it,
then parses it and builds its work lists; both forms then run the whole
MC stage of that frame into fresh planes, which must be equal.  Timed
in blocks of 10 calls, in the order gather, slice, slice, gather, each
call on its own: the host's wall time from the first launch to the end
of a synchronize, and the CUDA events' time; the medians are printed,
and the slice form's pad alone beside them.

Usage (from the repository root, one card):

    python3 tools/vp9_mc_ab_torch.py [--frames 3,50] [--device cuda]
"""

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent


def pad_for(caps) -> int:
    """The reference's luma pad for a window (models/vp9_tpu.py
    :184-191): the largest |mv| in pixels + 72, rounded up to 64, at
    least 80."""
    maxmv = 0
    for _h, _fs, rec in caps:
        for arr in rec.mc_arr.values():
            if len(arr):
                maxmv = max(maxmv,
                            int(np.abs(arr[:, [3, 4, 6, 7]]).max()) >> 3)
    return max(80, -(-(maxmv + 72) // 64) * 64)


def pad_dpb(RT, dpb_y, dpb_c, P, dw, dh):
    """The DPB cropped to the display dims and edge-padded: luma by P,
    chroma by P // 2 + 8 (the reference's Pc)."""
    dev = dpb_y.device
    Pc = P // 2 + 8

    def clamped(n, p):
        return RT._const(dev, ("edge_pad", n, p),
                         lambda: np.clip(np.arange(-p, n + p), 0, n - 1))
    ry, cy = clamped(dh, P), clamped(dw, P)
    rc, cc = clamped((dh + 1) // 2, Pc), clamped((dw + 1) // 2, Pc)
    return (dpb_y[:, ry[:, None], cy[None, :]],
            dpb_c[:, :, rc[:, None], cc[None, :]])


def mc_sliced(RT, dpb_pad, P, pw, ph, t, shift, args, any_comp):
    """The slice-gather MC of one tile class: each window one slice of
    the padded DPB, gathered for all tiles by one index; the position
    clip is the reference's (:138-139).  Exact while every window stays
    inside the pad."""
    dy, dx, mvx0, mvy0, s0, mvx1, mvy1, s1, comp, filt = args
    Hp, Wp = ph + 2 * P, pw + 2 * P
    flat = dpb_pad.reshape(-1)
    grid = RT._const(flat.device, ("mc_grid", t, Wp), lambda: (
        np.arange(t + 7)[:, None] * Wp + np.arange(t + 7)[None, :]))
    mask = (1 << shift) - 1
    ftab = RT._const(flat.device, ("vp9_filters",), lambda: RT.FILTERS)

    def one(mvx, mvy, slot):
        y = (dy + (mvy >> shift) - 3 + P).clamp(0, Hp - (t + 7))
        x = (dx + (mvx >> shift) - 3 + P).clamp(0, Wp - (t + 7))
        base = slot.long() * (Hp * Wp) + y * Wp + x
        win = flat[base[:, None, None] + grid].to(torch.int32)
        Fx = ftab[filt, (mvx & mask) << (4 - shift)]
        Fy = ftab[filt, (mvy & mask) << (4 - shift)]
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


def stage_sliced(RT, Y, C, fa, dpb_y, dpb_c, P):
    """recon_tpu._stage_mc with the slice form, the pad included."""
    _H, _W, _Hc, _Wc, dw, dh = fa.geom
    yp, cp = pad_dpb(RT, dpb_y, dpb_c, P, dw, dh)
    cpf = cp.reshape(cp.shape[0] * 2, *cp.shape[2:])
    for (is_luma, t), K, off, any_comp, inside in fa.mc:
        a = fa.i32[off:off + RT._MC_ROWS * K].view(RT._MC_ROWS, K)
        dy, dx, cpl = a[0], a[1], a[10]
        if is_luma:
            pred = mc_sliced(RT, yp, P, dw, dh, t, 3, tuple(a[:10]),
                             any_comp)
        else:
            aa = list(a[:10])
            aa[4] = a[4] * 2 + cpl
            aa[7] = a[7] * 2 + cpl
            pred = mc_sliced(RT, cpf, P // 2 + 8, (dw + 1) // 2,
                             (dh + 1) // 2, t, 4, tuple(aa), any_comp)
        ar = RT._arange(Y.device, 0, t)
        rr = dy[:, None] + ar[None, :]
        cc = dx[:, None] + ar[None, :]
        RT._put(Y if is_luma else C, rr, cc, pred,
                None if is_luma else cpl, inside)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", default="3,50")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    opt = ap.parse_args()
    dev = torch.device(opt.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("vp9_mc_ab_torch: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from ffmpeg_tpu_torch.codecs.vp9 import recon_tpu as RT
    from ffmpeg_tpu_torch.io.ivf import read_ivf
    from ffmpeg_tpu_torch.models.vp9_tpu import Vp9TpuDecoder
    from ffmpeg_tpu_torch.testing import VP9_BENCH
    card = "the CPU"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _par, _tb, pkts = read_ivf(VP9_BENCH.read_bytes())
    data = [p.data for p in pkts]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for n in (int(f) for f in opt.frames.split(",")):
        dec = Vp9TpuDecoder(device=dev)
        dec.decode(data[:n])
        caps = dec.parse([data[n]])
        (h, fs, rec), = caps
        _refresh, fa, _lf = dec.frame_args(h, fs, rec)
        fa = fa.to(dev)
        H, W, Hc, Wc, dw, dh = fa.geom
        P = pad_for(caps)
        gfa = RT._with_dpb(fa, dec.dpb_y, dec.dpb_c)

        def fresh():
            return (torch.zeros((H, W), dtype=torch.int32, device=dev),
                    torch.zeros((2, Hc, Wc), dtype=torch.int32, device=dev))

        def gather():
            Y, C = fresh()
            RT._stage_mc(Y, C, gfa)
            return Y, C

        def sliced():
            Y, C = fresh()
            stage_sliced(RT, Y, C, fa, dec.dpb_y, dec.dpb_c, P)
            return Y, C

        def pad():
            return pad_dpb(RT, dec.dpb_y, dec.dpb_c, P, dw, dh)

        got, want = sliced(), gather()
        sync()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            print(f"frame {n}: the two forms differ", file=sys.stderr)
            return 1
        times = {k: ([], []) for k in ("gather", "slice", "pad")}

        def block(name, fn):
            for _ in range(opt.reps):
                sync()
                if dev.type == "cuda":
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                t = time.perf_counter()
                fn()
                if dev.type == "cuda":
                    e1.record()
                sync()
                times[name][0].append((time.perf_counter() - t) * 1e3)
                if dev.type == "cuda":
                    times[name][1].append(e0.elapsed_time(e1))

        fn = {"gather": gather, "slice": sliced, "pad": pad}
        for name in ("gather", "slice", "slice", "gather", "pad"):
            block(name, fn[name])

        def med(name):
            wall, ev = times[name]
            evs = f", events {statistics.median(ev):.3f}" if ev else ""
            return f"wall {statistics.median(wall):.3f} ms{evs}"
        tiles = ", ".join(f"{K} {'luma' if lu else 'chroma'} {t}x{t}"
                          for (lu, t), K, *_ in fa.mc)
        print(f"frame {n} [{card}]: {sum(k for _c, k, *_ in fa.mc)} MC "
              f"tiles ({tiles}), pad {P}, both forms equal; medians of "
              f"{2 * opt.reps} calls ({opt.reps} for the pad): gather (the "
              f"decoder's) {med('gather')}; slice with its pad "
              f"{med('slice')}; the pad alone {med('pad')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
