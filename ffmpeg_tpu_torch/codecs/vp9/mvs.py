"""VP9 motion-vector prediction and (de)coding (VP9 spec §8.4.2;
reference: libavcodec/vp9mvs.c find_ref_mvs / read_mv_component /
ff_vp9_fill_mv). Runs symmetrically in both walker directions: decode
reads component deltas, encode writes plan-supplied deltas.

The port's copy of ffmpeg_tpu/codecs/vp9/mvs.py, held equal to it by
tests/test_torch_host_copies.py."""

from __future__ import annotations

import numpy as np

from . import tables_gen as T

ZEROMV, NEARESTMV, NEARMV, NEWMV = 12, 10, 11, 13

# candidate scan offsets per block size (vp9mvs.c mv_ref_blk_off),
# (col_off, row_off) pairs in MI units
MV_REF_BLK_OFF = [
    # BS_64x64
    [(3, -1), (-1, 3), (4, -1), (-1, 4), (-1, -1), (0, -1), (-1, 0),
     (6, -1)],
    # BS_64x32
    [(0, -1), (-1, 0), (4, -1), (-1, 2), (-1, -1), (0, -3), (-3, 0),
     (2, -1)],
    # BS_32x64
    [(-1, 0), (0, -1), (-1, 4), (2, -1), (-1, -1), (-3, 0), (0, -3),
     (-1, 2)],
    # BS_32x32
    [(1, -1), (-1, 1), (2, -1), (-1, 2), (-1, -1), (0, -3), (-3, 0),
     (-3, -3)],
    # BS_32x16
    [(0, -1), (-1, 0), (2, -1), (-1, -1), (-1, 1), (0, -3), (-3, 0),
     (-3, -3)],
    # BS_16x32
    [(-1, 0), (0, -1), (-1, 2), (-1, -1), (1, -1), (-3, 0), (0, -3),
     (-3, -3)],
    # BS_16x16
    [(0, -1), (-1, 0), (1, -1), (-1, 1), (-1, -1), (0, -3), (-3, 0),
     (-3, -3)],
    # BS_16x8
    [(0, -1), (-1, 0), (1, -1), (-1, -1), (0, -2), (-2, 0), (-2, -1),
     (-1, -2)],
    # BS_8x16
    [(-1, 0), (0, -1), (-1, 1), (-1, -1), (-2, 0), (0, -2), (-1, -2),
     (-2, -1)],
] + [
    # BS_8x8 .. BS_4x4 share one pattern
    [(0, -1), (-1, 0), (-1, -1), (0, -2), (-2, 0), (-1, -2), (-2, -1),
     (-2, -2)],
] * 4


def _clamp(v, lo, hi):
    return lo if v < lo else (hi if v > hi else v)


def _clamp_mv(mv, w):
    return (_clamp(mv[0], w.min_mv[0], w.max_mv[0]),
            _clamp(mv[1], w.min_mv[1], w.max_mv[1]))


_INVALID = (1 << 20, 1 << 20)


def find_ref_mvs(w, ref, z, idx, sb):
    """→ predicted (x, y). w is the TileWalker with block state in
    w.b; z is the prediction list (0/1), idx selects the first
    (NEARESTMV) or second (NEARMV) candidate, sb the sub-block index
    (-1 = whole block / NEWMV)."""
    fs = w.fs
    b = w.b
    row, col = w.row, w.col
    row7 = row & 7
    p = MV_REF_BLK_OFF[b["bs"]]
    mem = _INVALID
    mem_sub8x8 = _INVALID
    result = [None]

    def ret_direct(mv):
        nonlocal mem
        m = (int(mv[0]), int(mv[1]))
        if not idx:
            result[0] = m
            return True
        if mem == _INVALID:
            mem = m
        elif m != mem:
            result[0] = m
            return True
        return False

    def ret_mv(mv):
        nonlocal mem, mem_sub8x8
        mv = (int(mv[0]), int(mv[1]))
        if sb > 0:
            if mem_sub8x8 == _INVALID:
                m = _clamp_mv(mv, w)
                if m != mem:
                    result[0] = m
                    return True
                mem_sub8x8 = mv
            elif mem_sub8x8 != mv:
                m = _clamp_mv(mv, w)
                if m != mem:
                    result[0] = m
                else:
                    # quirk kept from libvpx (vp9mvs.c "BUG")
                    result[0] = (0, 0)
                return True
            return False
        m = mv
        if not idx:
            result[0] = _clamp_mv(mv, w)
            return True
        if mem == _INVALID:
            mem = m
        elif m != mem:
            result[0] = _clamp_mv(mv, w)
            return True
        return False

    def ret_scale(mv, invert):
        if invert:
            return ret_mv((-int(mv[0]), -int(mv[1])))
        return ret_mv(mv)

    if sb >= 0:
        if sb in (1, 2):
            if ret_direct(b["mv"][0][z]):
                return result[0]
        elif sb == 3:
            for k in (2, 1, 0):
                if ret_direct(b["mv"][k][z]):
                    return result[0]
        if row > 0:
            rr = fs.mv_ref[row - 1, col]
            if rr[0] == ref:
                if ret_mv(fs.above_mv_ctx[2 * col + (sb & 1), 0]):
                    return result[0]
            elif rr[1] == ref:
                if ret_mv(fs.above_mv_ctx[2 * col + (sb & 1), 1]):
                    return result[0]
        if col > w.tile_col_start:
            rr = fs.mv_ref[row, col - 1]
            if rr[0] == ref:
                if ret_mv(fs.left_mv_ctx[2 * row7 + (sb >> 1), 0]):
                    return result[0]
            elif rr[1] == ref:
                if ret_mv(fs.left_mv_ctx[2 * row7 + (sb >> 1), 1]):
                    return result[0]
        i0 = 2
    else:
        i0 = 0

    # neighborhood candidates with the same reference
    for i in range(i0, 8):
        c = p[i][0] + col
        r = p[i][1] + row
        if w.tile_col_start <= c < fs.cols and 0 <= r < fs.rows:
            rr = fs.mv_ref[r, c]
            if rr[0] == ref:
                if ret_mv(fs.mv_xy[r, c, 0]):
                    return result[0]
            elif rr[1] == ref:
                if ret_mv(fs.mv_xy[r, c, 1]):
                    return result[0]

    # co-located MV in the previous frame, same reference
    h = fs.h
    if h.use_last_frame_mvs:
        rr = fs.prev_mv_ref[row, col]
        if rr[0] == ref:
            if ret_mv(fs.prev_mv_xy[row, col, 0]):
                return result[0]
        elif rr[1] == ref:
            if ret_mv(fs.prev_mv_xy[row, col, 1]):
                return result[0]

    # neighborhood candidates with a different reference (sign-flip
    # when the references point across the current frame)
    for i in range(8):
        c = p[i][0] + col
        r = p[i][1] + row
        if w.tile_col_start <= c < fs.cols and 0 <= r < fs.rows:
            rr = fs.mv_ref[r, c]
            if rr[0] != ref and rr[0] >= 0:
                if ret_scale(fs.mv_xy[r, c, 0],
                             h.signbias[rr[0]] != h.signbias[ref]):
                    return result[0]
            if rr[1] != ref and rr[1] >= 0 and \
                    tuple(fs.mv_xy[r, c, 0]) != tuple(fs.mv_xy[r, c, 1]):
                if ret_scale(fs.mv_xy[r, c, 1],
                             h.signbias[rr[1]] != h.signbias[ref]):
                    return result[0]

    if h.use_last_frame_mvs:
        rr = fs.prev_mv_ref[row, col]
        if rr[0] != ref and rr[0] >= 0:
            if ret_scale(fs.prev_mv_xy[row, col, 0],
                         h.signbias[rr[0]] != h.signbias[ref]):
                return result[0]
        if rr[1] != ref and rr[1] >= 0 and \
                tuple(fs.prev_mv_xy[row, col, 0]) != \
                tuple(fs.prev_mv_xy[row, col, 1]):
            if ret_scale(fs.prev_mv_xy[row, col, 1],
                         h.signbias[rr[1]] != h.signbias[ref]):
                return result[0]

    return _clamp_mv((0, 0), w)


def mv_component(w, comp_idx, hp, want=None):
    """Decode (want None) or encode (want = signed nonzero delta) one
    MV component (vp9mvs.c read_mv_component)."""
    io = w.io
    fs = w.fs
    probs = fs.probs
    mc = probs.mv_comp[comp_idx]
    cnt = fs.counts.get("mv_comp") if fs.counts else None
    enc = want is not None
    if enc:
        sign_v = int(want < 0)
        m = abs(int(want)) - 1
        cls = 0 if m < 16 else m.bit_length() - 4
    sign = io.b(int(mc[0]), sign_v if enc else None)
    c = io.tree(T.MV_CLASS_TREE, [int(v) for v in mc[1:11]],
                cls if enc else None)
    if cnt is not None:
        cnt["sign"][comp_idx][sign] += 1
        cnt["classes"][comp_idx][c] += 1
    if c:
        if enc:
            rem = m - (8 << c)
            bits_v = rem >> 3
            fp_v = (rem >> 1) & 3
            hp_v = rem & 1
        n = 0
        for mbit in range(c):
            bit = io.b(int(mc[12 + mbit]),
                       ((bits_v >> mbit) & 1) if enc else None)
            n |= bit << mbit
            if cnt is not None:
                cnt["bits"][comp_idx][mbit][bit] += 1
        n <<= 3
        bit = io.tree(T.MV_FP_TREE, [int(v) for v in mc[28:31]],
                      fp_v if enc else None)
        n |= bit << 1
        if cnt is not None:
            cnt["fp"][comp_idx][bit] += 1
        if hp:
            bit = io.b(int(mc[32]), hp_v if enc else None)
            n |= bit
            if cnt is not None:
                cnt["hp"][comp_idx][bit] += 1
        else:
            n |= 1
            if cnt is not None:
                cnt["hp"][comp_idx][1] += 1
        n += 8 << c
    else:
        if enc:
            c0_v = m >> 3
            fp_v = (m >> 1) & 3
            hp_v = m & 1
        n = io.b(int(mc[11]), c0_v if enc else None)
        if cnt is not None:
            cnt["class0"][comp_idx][n] += 1
        bit = io.tree(T.MV_FP_TREE,
                      [int(v) for v in mc[22 + 3 * n:25 + 3 * n]],
                      fp_v if enc else None)
        if cnt is not None:
            cnt["class0_fp"][comp_idx][n][bit] += 1
        n = (n << 3) | (bit << 1)
        if hp:
            bit = io.b(int(mc[31]), hp_v if enc else None)
            n |= bit
            if cnt is not None:
                cnt["class0_hp"][comp_idx][bit] += 1
        else:
            n |= 1
            if cnt is not None:
                cnt["class0_hp"][comp_idx][1] += 1
    return -(n + 1) if sign else (n + 1)


def _sanitize(d, hp):
    """Make a planned delta representable: nonzero deltas have
    magnitude m with (m-1) carrying an hp bit forced to 1 when !hp."""
    d = int(d)
    if d == 0:
        return 0
    m = abs(d)
    if not hp and (m - 1) & 1 == 0:
        m += 1
    return -m if d < 0 else m


def fill_mv(w, mode, sb, plan_delta=None):
    """→ [mv_ref0, mv_ref1] for one (sub-)block (ff_vp9_fill_mv).
    plan_delta: encode-direction ((dy0,dx0),(dy1,dx1)) intents."""
    fs = w.fs
    b = w.b
    h = fs.h
    if mode == ZEROMV:
        return [(0, 0), (0, 0)]
    mv = [None, None]
    for li in range(2 if b["comp"] else 1):
        pred = find_ref_mvs(w, b["ref"][li], li,
                            1 if mode == NEARMV else 0,
                            -1 if mode == NEWMV else sb)
        px, py = pred
        hp = h.highprecisionmvs and abs(px) < 64 and abs(py) < 64
        if (mode == NEWMV or sb == -1) and not hp:
            if py & 1:
                py += 1 if py < 0 else -1
            if px & 1:
                px += 1 if px < 0 else -1
        if mode == NEWMV:
            io = w.io
            enc = plan_delta is not None
            if enc:
                dy = _sanitize(plan_delta[li][0], hp)
                dx = _sanitize(plan_delta[li][1], hp)
                j = ((dy != 0) << 1) | (dx != 0)
            j = io.tree(T.MV_JOINT_TREE,
                        [int(v) for v in fs.probs.mv_joint],
                        j if enc else None)
            if fs.counts:
                fs.counts["mv_joint"][j] += 1
            if j >= 2:
                py += mv_component(w, 0, hp, dy if enc else None)
            if j & 1:
                px += mv_component(w, 1, hp, dx if enc else None)
        mv[li] = (px, py)
    if not b["comp"]:
        mv[1] = (0, 0)
    return mv
