"""VP8 macroblock walker: modes, DCT token (de)coding and inline
reconstruction (RFC 6386 §10-14; reference: libavcodec/vp8.c
decode_mb_mode / decode_mb_coeffs / intra_predict / idct_mb). One
walker serves decode (BoolDecoder) and encode (BoolEncoder + Plan)
for crafted-stream differential tests — the strategy proven on
H.264/HEVC/VP9.

The port's copy of ffmpeg_tpu/codecs/vp8/block.py, held equal to it by
tests/test_torch_vp8_webp.py.
"""

from __future__ import annotations

import numpy as np

from ..vp9.block import BIO
from . import idct as IDCT
from . import pred as P
from . import tables_gen as T

ZIGZAG = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                   14, 15], np.int32)

MODE_I4x4 = 4
DC_PRED4 = 2                              # 4x4 mode numbering (pred.py)

CAT_PROBS = [
    [p for p in T.DCT_CAT3_PROB if p],
    [p for p in T.DCT_CAT4_PROB if p],
    [p for p in T.DCT_CAT5_PROB if p],
    [p for p in T.DCT_CAT6_PROB if p],
]
CAT12 = ([int(T.DCT_CAT1_PROB[0])],
         [int(v) for v in T.DCT_CAT2_PROB if v])


def _i16(v):
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _border_mb():
    return {"mode": 0, "ref_frame": 0, "mv": (0, 0),
            "partitioning": 4, "bmv": [(0, 0)] * 16, "skip": 0,
            "segment": 0}


class FrameState:
    def __init__(self, h, probs, refs=None):
        self.h = h
        self.probs = probs
        self.refs = refs or {}            # {1: (y,u,v), 2: ..., 3: ...}
        self.mb_w = (h.width + 15) >> 4
        self.mb_h = (h.height + 15) >> 4
        wp, hp = self.mb_w * 16, self.mb_h * 16
        self.y = np.zeros((hp, wp), np.uint8)
        self.u = np.zeros((hp >> 1, wp >> 1), np.uint8)
        self.v = np.zeros((hp >> 1, wp >> 1), np.uint8)
        self.top_nnz = np.zeros((self.mb_w, 9), np.int32)
        self.i4_top = np.full(self.mb_w * 4, DC_PRED4, np.int32)
        self.seg_map = np.zeros(self.mb_w * self.mb_h, np.int32)
        # per-MB info for the loop filter + MV prediction
        self.mb_info = [[None] * self.mb_w for _ in range(self.mb_h)]
        self.new_row()

    def neighbor(self, mb_y, mb_x):
        if mb_x < 0 or mb_y < 0 or mb_x >= self.mb_w:
            return _border_mb()
        mb = self.mb_info[mb_y][mb_x]
        return mb if mb is not None else _border_mb()

    def new_row(self):
        self.left_nnz = np.zeros(9, np.int32)
        self.i4_left = np.full(4, DC_PRED4, np.int32)


class MBWalker:
    def __init__(self, fs, head_core, part_cores, encode=False,
                 plan=None):
        self.fs = fs
        self.io = BIO(head_core, encode)    # mode/header partition
        self.parts = [BIO(c, encode) for c in part_cores]
        self.plan = plan

    # -- one coefficient block (vp8.c decode_block_coeffs) -------------
    def coeff_block(self, cio, probs_tok, i0, nnz, qmul, out,
                    levels=None):
        """→ last decoded index + 1, or 0. out: (16,) int16 flat in
        raster order; levels: encode-side scan-order magnitudes."""
        enc = levels is not None
        i = i0
        tp = probs_tok[i][nnz]
        if enc:
            nz = np.nonzero(levels[i0:])[0]
            last = (int(nz[-1]) + i0) if len(nz) else -1
        need_eob = True
        ret = 0
        while i < 16:
            if need_eob:
                if not cio.b(int(tp[0]),
                             None if not enc else int(i <= last)):
                    break
            nzf = cio.b(int(tp[1]),
                        None if not enc else int(levels[i] != 0))
            if not nzf:
                i += 1
                if i == 16:
                    ret = 16
                    break
                tp = probs_tok[i][0]
                need_eob = False
                continue
            v = abs(int(levels[i])) if enc else None
            if not cio.b(int(tp[2]), None if not enc else int(v > 1)):
                coeff = 1
                nctx = 1
            else:
                if not cio.b(int(tp[3]),
                             None if not enc else int(v > 4)):
                    b4 = cio.b(int(tp[4]),
                               None if not enc else int(v > 2))
                    if b4:
                        coeff = 3 + cio.b(int(tp[5]), None if not enc
                                          else int(v > 3))
                    else:
                        coeff = 2
                elif not cio.b(int(tp[6]),
                               None if not enc else int(v > 10)):
                    if not cio.b(int(tp[7]),
                                 None if not enc else int(v > 6)):
                        coeff = 5 + cio.b(CAT12[0][0], None if not enc
                                          else v - 5)
                    else:
                        coeff = 7
                        coeff += cio.b(CAT12[1][0], None if not enc
                                       else (v - 7) >> 1) << 1
                        coeff += cio.b(CAT12[1][1], None if not enc
                                       else (v - 7) & 1)
                else:
                    if enc:
                        cat = max(0, min(3, (v - 3).bit_length() - 4))
                    a = cio.b(int(tp[8]),
                              None if not enc else cat >> 1)
                    b = cio.b(int(tp[9 + a]),
                              None if not enc else cat & 1)
                    cat = (a << 1) + b
                    coeff = 3 + (8 << cat)
                    cp = CAT_PROBS[cat]
                    nb = len(cp)
                    extra = v - coeff if enc else 0
                    e = 0
                    for k, pr in enumerate(cp):
                        bit = cio.b(int(pr), None if not enc else
                                    (extra >> (nb - 1 - k)) & 1)
                        e = (e << 1) + bit
                    coeff += e
                nctx = 2
            sign = cio.bit(None if not enc else int(levels[i] < 0))
            if not enc:
                q = coeff * qmul[1 if i else 0]
                out[int(ZIGZAG[i])] = _i16(-q if sign else q)
            i += 1
            ret = i
            if i >= 16:
                break
            tp = probs_tok[i][nctx]
            need_eob = True
        return ret

    # -- one macroblock -------------------------------------------------
    def decode_mb(self, mb_x, mb_y):
        fs, io = self.fs, self.io
        h = fs.h
        probs = fs.probs
        plan = self.plan
        enc = io.encode
        cio = self.parts[mb_y & (len(self.parts) - 1)]

        segment = 0
        if h.seg_update_map:
            want = plan.segment(mb_x, mb_y) if enc else None
            bit = io.b(int(probs.segmentid[0]),
                       None if want is None else int(want >= 2))
            bit2 = io.b(int(probs.segmentid[1 + bit]),
                        None if want is None else want & 1)
            segment = 2 * bit + bit2
        elif h.seg_enabled:
            segment = int(fs.seg_map[mb_y * fs.mb_w + mb_x])
        fs.seg_map[mb_y * fs.mb_w + mb_x] = segment

        skip = 0
        if h.mbskip_enabled:
            want = plan.skip(mb_x, mb_y) if enc else None
            skip = io.b(int(probs.mbskip),
                        None if want is None else int(want))

        i4_modes = None
        uvmode = 0
        ref_frame = 0
        mv = (0, 0)
        bmv = [(0, 0)] * 16
        partitioning = 4                  # SPLITMVMODE_NONE
        if h.keyframe:
            want = plan.ymode(mb_x, mb_y) if enc else None
            mode = io.tree(T.PRED16_TREE_INTRA, T.PRED16_PROB_INTRA,
                           want)
            if mode == MODE_I4x4:
                i4_modes = self._intra4x4_modes(mb_x, mb_y)
            else:
                m4 = int(T.PRED4x4_MODE[mode])
                fs.i4_top[mb_x * 4:mb_x * 4 + 4] = m4
                fs.i4_left[:] = m4
            want = plan.uvmode(mb_x, mb_y) if enc else None
            uvmode = io.tree(T.PRED8x8C_TREE, T.PRED8x8C_PROB_INTRA,
                             want)
        else:
            want = plan.is_inter(mb_x, mb_y) if enc else None
            if io.b(h.intra_prob,
                    None if want is None else int(want)):
                # inter MB (16.2)
                wref = plan.ref(mb_x, mb_y) if enc else None
                if io.b(h.last_prob,
                        None if wref is None else int(wref != 1)):
                    ref_frame = 3 if io.b(
                        h.golden_prob,
                        None if wref is None else int(wref == 3)) \
                        else 2
                else:
                    ref_frame = 1
                mode, mv, bmv, partitioning = self._decode_mvs(
                    mb_x, mb_y, ref_frame)
            else:
                want = plan.ymode(mb_x, mb_y) if enc else None
                mode = io.tree(T.PRED16_TREE_INTER,
                               [int(v) for v in probs.pred16x16],
                               want)
                if mode == MODE_I4x4:
                    i4_modes = np.zeros(16, np.int32)
                    for k in range(16):
                        w4 = plan.b4mode(mb_x, mb_y, k) if enc \
                            else None
                        i4_modes[k] = io.tree(T.PRED4x4_TREE,
                                              T.PRED4x4_PROB_INTER,
                                              w4)
                want = plan.uvmode(mb_x, mb_y) if enc else None
                uvmode = io.tree(T.PRED8x8C_TREE,
                                 [int(v) for v in probs.pred8x8c],
                                 want)

        # coefficients
        nnz_cache = np.zeros((6, 4), np.int32)
        blocks = np.zeros((6, 4, 16), np.int16)
        dc_y2 = np.zeros(16, np.int16)
        if not skip:
            skip = self._mb_coeffs(cio, mb_x, mb_y, mode, segment,
                                   nnz_cache, blocks, dc_y2)
        else:
            fs.left_nnz[:8] = 0
            fs.top_nnz[mb_x][:8] = 0
            if mode != MODE_I4x4 and mode != 7:  # no Y2: I4x4/SPLIT
                fs.left_nnz[8] = 0
                fs.top_nnz[mb_x][8] = 0

        fs.mb_info[mb_y][mb_x] = {
            "mode": mode, "skip": skip, "segment": segment,
            "ref_frame": ref_frame, "mv": mv, "bmv": bmv,
            "partitioning": partitioning}
        if not enc:
            if mode <= MODE_I4x4:
                self._recon(mb_x, mb_y, mode, uvmode, i4_modes,
                            nnz_cache, blocks, bool(skip))
            else:
                from .mc import inter_predict
                inter_predict(fs, fs.mb_info[mb_y][mb_x],
                              fs.refs[ref_frame], mb_x, mb_y)
                if not skip:
                    self._idct_mb(mb_x, mb_y, mode, nnz_cache, blocks)

    # -- inter MV decoding (vp8.c vp8_decode_mvs, 16.3/16.4/17) --------
    def _mv_component(self, p, want=None):
        io = self.io
        enc = want is not None
        if enc:
            v = abs(int(want))
        big = io.b(int(p[0]), None if not enc else int(v >= 8))
        x = 0
        if big:
            for i in range(3):
                x += io.b(int(p[9 + i]),
                          None if not enc else (v >> i) & 1) << i
            for i in range(9, 3, -1):
                x += io.b(int(p[9 + i]),
                          None if not enc else (v >> i) & 1) << i
            if not (x & 0xFFF0):
                x += 8
            else:
                x += io.b(int(p[12]),
                          None if not enc else (v >> 3) & 1) << 3
        else:
            # small_mvtree
            b0 = io.b(int(p[2]), None if not enc else (v >> 2) & 1)
            idx = 3 + 3 * b0
            x += 4 * b0
            b1 = io.b(int(p[idx]), None if not enc else (v >> 1) & 1)
            idx += 1 + b1
            x += 2 * b1
            x += io.b(int(p[idx]), None if not enc else v & 1)
        if x:
            sign = io.b(int(p[1]), None if not enc else int(want < 0))
            return -x if sign else x
        return 0

    def _clamp_mv(self, mv, mb_x, mb_y):
        fs = self.fs
        mn_x, mx_x = -64 * (mb_x + 1), 64 * (fs.mb_w - mb_x)
        mn_y, mx_y = -64 * (mb_y + 1), 64 * (fs.mb_h - mb_y)
        return (max(mn_x, min(mx_x, mv[0])),
                max(mn_y, min(mx_y, mv[1])))

    def _decode_mvs(self, mb_x, mb_y, ref_frame):
        fs, io = self.fs, self.io
        h = fs.h
        enc = io.encode
        plan = self.plan
        top = fs.neighbor(mb_y - 1, mb_x)
        left = fs.neighbor(mb_y, mb_x - 1)
        topleft = fs.neighbor(mb_y - 1, mb_x - 1)
        edges = (top, left, topleft)
        cur_bias = h.sign_bias[ref_frame]
        near = [(0, 0), (0, 0), (0, 0), (0, 0)]
        cnt = [0, 0, 0, 0]
        idx = 0
        for n, edge in enumerate(edges):
            if edge["ref_frame"] != 0:
                emv = edge["mv"]
                if emv != (0, 0):
                    if cur_bias != h.sign_bias[edge["ref_frame"]]:
                        emv = (-emv[0], -emv[1])
                    if n == 0 or emv != near[idx]:
                        idx += 1
                        near[idx] = emv
                    cnt[idx] += 1 + (n != 2)
                else:
                    cnt[0] += 1 + (n != 2)

        partitioning = 4
        want = plan.mvmode(mb_x, mb_y) if enc else None
        if io.b(int(T.MODE_CONTEXTS[cnt[0]][0]),
                None if not enc else int(want != "zero")):
            # three distinct MVs: merge top/topleft counts
            if cnt[3] and near[1] == near[3]:
                cnt[1] += 1
            if cnt[2] > cnt[1]:
                cnt[1], cnt[2] = cnt[2], cnt[1]
                near[1], near[2] = near[2], near[1]
            if io.b(int(T.MODE_CONTEXTS[cnt[1]][1]),
                    None if not enc else int(want != "nearest")):
                if io.b(int(T.MODE_CONTEXTS[cnt[2]][2]),
                        None if not enc else int(want != "near")):
                    base = near[0 + int(cnt[1] >= cnt[0])]
                    mv = self._clamp_mv(base, mb_x, mb_y)
                    csp = (int(left["mode"] == 7) +
                           int(top["mode"] == 7)) * 2 + \
                        int(topleft["mode"] == 7)
                    if io.b(int(T.MODE_CONTEXTS[csp][3]),
                            None if not enc else int(want == "split")):
                        bmv, num, partitioning = self._split_mvs(
                            mb_x, mb_y, mv)
                        return 7, bmv[num - 1], bmv, partitioning
                    d = plan.newmv(mb_x, mb_y) if enc else (0, 0)
                    # y component first (vp8.c reads mvc[0] then mvc[1])
                    dy = self._mv_component(fs.probs.mvc[0],
                                            d[0] if enc else None)
                    dx = self._mv_component(fs.probs.mvc[1],
                                            d[1] if enc else None)
                    mv = (mv[0] + dx, mv[1] + dy)
                    return 6, mv, [mv] * 16, 4
                mv = self._clamp_mv(near[2], mb_x, mb_y)
                return 6, mv, [mv] * 16, 4
            mv = self._clamp_mv(near[1], mb_x, mb_y)
            return 6, mv, [mv] * 16, 4
        return 5, (0, 0), [(0, 0)] * 16, 4

    def _split_mvs(self, mb_x, mb_y, base_mv):
        """decode_splitmvs (16.4). → (bmv16, num, partitioning)."""
        fs, io = self.fs, self.io
        enc = io.encode
        plan = self.plan
        top = fs.neighbor(mb_y - 1, mb_x)
        left = fs.neighbor(mb_y, mb_x - 1)
        sp_left = T.MBSPLITS[left["partitioning"]]
        sp_top = T.MBSPLITS[top["partitioning"]]
        want = plan.split_type(mb_x, mb_y) if enc else None
        if io.b(int(T.MBSPLIT_PROB[0]),
                None if not enc else int(want != 3)):
            if io.b(int(T.MBSPLIT_PROB[1]),
                    None if not enc else int(want <= 1)):
                part = 0 + io.b(int(T.MBSPLIT_PROB[2]),
                                None if not enc else int(want == 1))
            else:
                part = 2
        else:
            part = 3
        num = int(T.MBSPLIT_COUNT[part])
        sp_cur = T.MBSPLITS[part]
        firstidx = T.MBFIRSTIDX[part]
        bmv = [(0, 0)] * 16
        for n in range(num):
            k = int(firstidx[n])
            if not (k & 3):
                lmv = left["bmv"][int(sp_left[k + 3])]
            else:
                lmv = bmv[int(sp_cur[k - 1])]
            if k <= 3:
                amv = top["bmv"][int(sp_top[k + 12])]
            else:
                amv = bmv[int(sp_cur[k - 4])]
            if lmv == amv:
                sp = T.SUBMV_PROB[4 - int(lmv != (0, 0))]
            elif amv == (0, 0):
                sp = T.SUBMV_PROB[2]
            else:
                sp = T.SUBMV_PROB[1 - int(lmv != (0, 0))]
            want = plan.submv(mb_x, mb_y, n) if enc else None
            if io.b(int(sp[0]),
                    None if not enc else int(want != "left")):
                if io.b(int(sp[1]),
                        None if not enc else int(want != "above")):
                    if io.b(int(sp[2]),
                            None if not enc else int(want == "new")):
                        d = plan.submv_delta(mb_x, mb_y, n) if enc \
                            else (0, 0)
                        dy = self._mv_component(
                            fs.probs.mvc[0], d[0] if enc else None)
                        dx = self._mv_component(
                            fs.probs.mvc[1], d[1] if enc else None)
                        v = (base_mv[0] + dx, base_mv[1] + dy)
                    else:
                        v = (0, 0)
                else:
                    v = amv
            else:
                v = lmv
            bmv[n] = v
        return bmv, num, part

    def _idct_mb(self, mb_x, mb_y, mode, nnz_cache, blocks):
        fs = self.fs
        y0, x0 = mb_y * 16, mb_x * 16
        yc, xc = mb_y * 8, mb_x * 8
        if mode != MODE_I4x4:
            for y in range(4):
                for x in range(4):
                    nnz = int(nnz_cache[y][x])
                    dst = fs.y[y0 + 4 * y:y0 + 4 * y + 4,
                               x0 + 4 * x:x0 + 4 * x + 4]
                    if nnz == 1:
                        IDCT.idct_dc_add(dst,
                                         blocks[y, x].reshape(4, 4))
                    elif nnz > 1:
                        IDCT.idct_add(dst, blocks[y, x].reshape(4, 4))
        for ch, pl in ((4, fs.u), (5, fs.v)):
            for y in range(2):
                for x in range(2):
                    nnz = int(nnz_cache[ch][(y << 1) + x])
                    dst = pl[yc + 4 * y:yc + 4 * y + 4,
                             xc + 4 * x:xc + 4 * x + 4]
                    if nnz == 1:
                        IDCT.idct_dc_add(
                            dst, blocks[ch, (y << 1) + x].reshape(4, 4))
                    elif nnz > 1:
                        IDCT.idct_add(
                            dst, blocks[ch, (y << 1) + x].reshape(4, 4))

    def _intra4x4_modes(self, mb_x, mb_y):
        fs, io = self.fs, self.io
        enc = io.encode
        modes = np.zeros(16, np.int32)
        top = fs.i4_top[mb_x * 4:mb_x * 4 + 4]
        left = fs.i4_left
        k = 0
        for y in range(4):
            for x in range(4):
                ctx = T.PRED4x4_PROB_INTRA[int(top[x])][int(left[y])]
                want = self.plan.b4mode(mb_x, mb_y, k) if enc else None
                m = io.tree(T.PRED4x4_TREE, ctx, want)
                left[y] = top[x] = modes[k] = m
                k += 1
        return modes

    def _mb_coeffs(self, cio, mb_x, mb_y, mode, segment, nnz_cache,
                   blocks, dc_y2):
        """→ effective skip flag (1 when nothing was coded)."""
        fs = self.fs
        h = fs.h
        probs = fs.probs
        enc = self.io.encode
        plan = self.plan
        qmat = h.qmat[segment]
        t_nnz = fs.top_nnz[mb_x]
        l_nnz = fs.left_nnz
        nnz_total = 0
        block_dc = 0
        luma_start, luma_ctx = 0, 3
        if mode != MODE_I4x4 and mode != 7:   # Y2 absent for SPLIT
            nnz_pred = int(t_nnz[8]) + int(l_nnz[8])
            lv = plan.levels(mb_x, mb_y, "y2", 0) if enc else None
            nnz = self.coeff_block(cio, probs.token[1], 0, nnz_pred,
                                   qmat["luma_dc"], dc_y2, lv)
            l_nnz[8] = t_nnz[8] = int(bool(nnz))
            if nnz:
                nnz_total += nnz
                block_dc = 1
                if nnz == 1:              # dc-only WHT
                    val = (int(dc_y2[0]) + 3) >> 3
                    for yy in range(4):
                        for xx in range(4):
                            blocks[yy, xx, 0] = val
                else:
                    d = IDCT.luma_dc_wht(
                        dc_y2.astype(np.int64).reshape(4, 4))
                    for yy in range(4):
                        for xx in range(4):
                            blocks[yy, xx, 0] = d[yy, xx]
            luma_start, luma_ctx = 1, 0

        for y in range(4):
            for x in range(4):
                nnz_pred = int(l_nnz[y]) + int(t_nnz[x])
                lv = plan.levels(mb_x, mb_y, "y", 4 * y + x) \
                    if enc else None
                nnz = self.coeff_block(
                    cio, probs.token[luma_ctx], luma_start, nnz_pred,
                    qmat["luma"], blocks[y, x], lv)
                nnz_cache[y][x] = nnz + block_dc
                t_nnz[x] = l_nnz[y] = int(bool(nnz))
                nnz_total += nnz

        for i in (4, 5):
            for y in range(2):
                for x in range(2):
                    nnz_pred = int(l_nnz[i + 2 * y]) + \
                        int(t_nnz[i + 2 * x])
                    lv = plan.levels(mb_x, mb_y, "uv",
                                     (i - 4) * 4 + 2 * y + x) \
                        if enc else None
                    nnz = self.coeff_block(
                        cio, probs.token[2], 0, nnz_pred,
                        qmat["chroma"], blocks[i, (y << 1) + x], lv)
                    nnz_cache[i][(y << 1) + x] = nnz
                    t_nnz[i + 2 * x] = l_nnz[i + 2 * y] = \
                        int(bool(nnz))
                    nnz_total += nnz
        return 0 if nnz_total else 1

    # -- reconstruction -------------------------------------------------
    def _recon(self, mb_x, mb_y, mode, uvmode, i4_modes, nnz_cache,
               blocks, skip):
        fs = self.fs
        y0, x0 = mb_y * 16, mb_x * 16
        if mode != MODE_I4x4:
            m = P.convert_mode_nxn(_P16_MAP[mode], mb_x, mb_y)
            fs.y[y0:y0 + 16, x0:x0 + 16] = np.clip(
                P.pred_nxn(m, fs.y, y0, x0, 16), 0, 255)
        else:
            self._recon_i4(mb_x, mb_y, i4_modes, nnz_cache, blocks,
                           skip)
        # chroma pred
        m = P.convert_mode_nxn(_P16_MAP[uvmode], mb_x, mb_y)
        yc, xc = mb_y * 8, mb_x * 8
        for pl in (fs.u, fs.v):
            pl[yc:yc + 8, xc:xc + 8] = np.clip(
                P.pred_nxn(m, pl, yc, xc, 8), 0, 255)
        if skip:
            return
        # idct adds (vp8.c idct_mb)
        if mode != MODE_I4x4:
            for y in range(4):
                for x in range(4):
                    nnz = int(nnz_cache[y][x])
                    dst = fs.y[y0 + 4 * y:y0 + 4 * y + 4,
                               x0 + 4 * x:x0 + 4 * x + 4]
                    if nnz == 1:
                        IDCT.idct_dc_add(dst,
                                         blocks[y, x].reshape(4, 4))
                    elif nnz > 1:
                        IDCT.idct_add(dst, blocks[y, x].reshape(4, 4))
        for ch, pl in ((4, fs.u), (5, fs.v)):
            for y in range(2):
                for x in range(2):
                    nnz = int(nnz_cache[ch][(y << 1) + x])
                    dst = pl[yc + 4 * y:yc + 4 * y + 4,
                             xc + 4 * x:xc + 4 * x + 4]
                    if nnz == 1:
                        IDCT.idct_dc_add(
                            dst, blocks[ch, (y << 1) + x].reshape(4, 4))
                    elif nnz > 1:
                        IDCT.idct_add(
                            dst, blocks[ch, (y << 1) + x].reshape(4, 4))

    def _recon_i4(self, mb_x, mb_y, i4_modes, nnz_cache, blocks, skip):
        fs = self.fs
        plane = fs.y
        y0, x0 = mb_y * 16, mb_x * 16
        mbw = fs.mb_w
        for y in range(4):
            for x in range(4):
                by, bx = mb_y * 4 + y, mb_x * 4 + x
                py, px = y0 + 4 * y, x0 + 4 * x
                # edges (127 above the frame, 129 left of it)
                if by == 0:
                    top = np.full(4, 127, np.int32)
                    lt = 127
                else:
                    top = plane[py - 1, px:px + 4].astype(np.int32)
                    lt = 129 if bx == 0 else int(plane[py - 1, px - 1])
                if bx == 0:
                    left = np.full(4, 129, np.int32)
                else:
                    left = plane[py:py + 4, px - 1].astype(np.int32)
                # top-right (vp8.c intra_predict tr rules)
                if (y == 0 or x == 3) and mb_y == 0:
                    tr = np.full(4, 127, np.int32)
                elif x == 3:
                    if mb_x == mbw - 1:
                        tr = np.full(4, int(plane[y0 - 1, x0 + 15]),
                                     np.int32)
                    else:
                        tr = plane[y0 - 1,
                                   x0 + 16:x0 + 20].astype(np.int32)
                else:
                    tr = plane[py - 1, px + 4:px + 8].astype(np.int32)
                m = _convert4(int(i4_modes[4 * y + x]), bx, by)
                out = P.pred4x4(m, top, tr, left, lt)
                plane[py:py + 4, px:px + 4] = np.clip(out, 0, 255)
                if not skip:
                    nnz = int(nnz_cache[y][x])
                    dst = plane[py:py + 4, px:px + 4]
                    if nnz == 1:
                        IDCT.idct_dc_add(dst,
                                         blocks[y, x].reshape(4, 4))
                    elif nnz > 1:
                        IDCT.idct_add(dst, blocks[y, x].reshape(4, 4))


# 16x16/8x8 mode numbering (DC,HOR,VERT,TM) → pred.py P_* values
_P16_MAP = {0: P.P_DC, 1: P.P_HOR, 2: P.P_VERT, 3: P.P_TM}


def _convert4(mode, bx, by):
    """check_intra_pred4x4_mode_emuedge → pred.py 4x4 mode."""
    if mode == P.VERT:
        if bx == 0 and by > 0:
            return P.VERT
        return P.DC_127 if by == 0 else P.VERT
    if mode in (P.DDL, P.VL):
        return P.DC_127 if by == 0 else mode
    if mode == P.HOR:
        if by == 0:
            return P.HOR
        return P.DC_129 if bx == 0 else P.HOR
    if mode == P.HU:
        return P.DC_129 if bx == 0 else mode
    if mode == P.TM:
        if bx == 0:
            return P.VERT_PLAIN if by else P.DC_129
        return mode if by else P.HOR_PLAIN
    return mode
