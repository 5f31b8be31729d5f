"""Error concealment for damaged/missing slices (reference:
libavcodec/error_resilience.c ff_er_frame_end:910 + guess_mv:410).

MBs not covered by any successfully-decoded slice are filled after
reconstruction: inter concealment motion-compensates each missing MB
with a motion vector guessed from its decoded neighbours (iterative
multi-pass like guess_mv), falling back to spatial extrapolation when
no reference picture exists.

The port's copy of ffmpeg_tpu/codecs/h264/conceal.py, held equal to it by
tests/test_torch_h264_host.py."""

from __future__ import annotations

import numpy as np

from .inter import mc_chroma, mc_luma


def conceal_missing(dec) -> int:
    """Fill pixels of uncovered MBs in dec.y/u/v; marks them available
    so the loop filter smooths the patch borders. Returns the number of
    concealed MBs (0 = nothing to do)."""
    missing = ~dec.mb_avail
    n_missing = int(missing.sum())
    if n_missing == 0:
        return 0
    nmby, nmbx = dec.mb_avail.shape
    ref = None
    if dec.list0:
        ref = dec.list0[0]["planes"]
    elif dec.ref_frame is not None:
        ref = dec.ref_frame

    if ref is None:
        _conceal_spatial(dec, missing)
        dec.mb_avail[:] = True
        return n_missing

    # per-MB guessed mv, seeded from decoded MBs' first 4x4 block
    mv = np.zeros((nmby, nmbx, 2), np.float64)
    known = dec.mb_avail.copy()
    mv[known] = dec.mv[0, ::4, ::4][known]
    todo = missing.copy()
    for _ in range(nmby + nmbx):          # multi-pass flood fill
        if not todo.any():
            break
        progressed = False
        for mby, mbx in zip(*np.nonzero(todo)):
            acc = []
            for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                ny, nx = mby + dy, mbx + dx
                if 0 <= ny < nmby and 0 <= nx < nmbx and known[ny, nx]:
                    acc.append(mv[ny, nx])
            if acc:
                mv[mby, mbx] = np.mean(acc, axis=0)
                known[mby, mbx] = True
                todo[mby, mbx] = False
                progressed = True
        if not progressed:
            break
    ry, ru, rv = ref
    for mby, mbx in zip(*np.nonzero(missing)):
        mvx = int(round(mv[mby, mbx, 0]))
        mvy = int(round(mv[mby, mbx, 1]))
        x, y = mbx * 16, mby * 16
        cx, cy = mbx * 8, mby * 8
        dec.y[y:y + 16, x:x + 16] = mc_luma(ry, mvx, mvy, x, y, 16, 16)
        dec.u[cy:cy + 8, cx:cx + 8] = mc_chroma(ru, mvx, mvy, cx, cy,
                                                8, 8)
        dec.v[cy:cy + 8, cx:cx + 8] = mc_chroma(rv, mvx, mvy, cx, cy,
                                                8, 8)
        dec.mv[0, mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = (mvx, mvy)
        dec.mv_ref[0, mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 0
        dec.mb_qp[mby, mbx] = 26
    dec.mb_avail[:] = True
    return n_missing


def _conceal_spatial(dec, missing) -> None:
    """No reference picture: extend the nearest decoded rows/columns
    into the hole (the intra path of ff_er_frame_end)."""
    for plane, step in ((dec.y, 16), (dec.u, 8), (dec.v, 8)):
        h, w = plane.shape
        covered = np.repeat(np.repeat(~missing, step, 0), step, 1)
        covered = covered[:h, :w]
        if covered.any():
            # propagate downward then upward (row replication)
            last = None
            for r in range(h):
                if covered[r].all():
                    last = plane[r].copy()
                elif last is not None:
                    plane[r] = last
            first = None
            for r in range(h - 1, -1, -1):
                if covered[r].all():
                    first = plane[r].copy()
                elif first is not None and not covered[r].any():
                    pass        # already filled downward
        else:
            plane[:] = 1 << (dec.bd - 1)
