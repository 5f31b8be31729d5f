"""Parse-time recording of VP9 reconstruction work for device replay.

The reference interleaves bool-coder parse with pixel reconstruction
(vp9recon.c intra_recon / inter_recon called from decode_b).  The TPU
build splits that: the host walks the tiles with reconstruction
suppressed, recording three kinds of work items

  * inter MC tiles   (plane, dst x/y, refs+MVs+filter, compound flag)
                     — blocks are decomposed into fixed 8x8 / 4x4
                       tiles (sub-pel filtering is position-invariant
                       and edge clamping uses absolute coordinates, so
                       the decomposition is byte-exact)
  * inter residual   (plane, x, y, tx size, dequantized coeffs)
  * intra tx-blocks  (prediction + residual together, since VP9
                       predicts and adds per transform block)

and assigns every intra tx-block a **dependency level** exactly like
the HEVC recorder (hevc/recorder.py): 1 + the max level of any
already-reconstructed pixels its reference samples read.  Inter pixels
are level 0 (no intra-frame dependency), so intra blocks inside inter
frames naturally read them.  recon_tpu.py replays the record as one
jitted program: MC -> inter residual -> lax.scan over intra levels.

All the check_intra_mode edge rules (vp9recon.c:58, mirrored by
block.py _edges) are resolved HERE into gather index arrays: the
effective mode after availability conversion, the count of valid top
samples (folding the tx4 top-right replication fix into the count),
the count of valid left samples, and the top-left selector.  The
device then only gathers - no control flow.

The port's copy of ffmpeg_tpu/codecs/vp9/recorder.py, held equal to it
by tests/test_torch_host_copies.py."""

from __future__ import annotations

import numpy as np

from . import intra as IP
from . import itxfm as TX

# mode-availability conversion + needs tables (block.py _edges keeps
# the authoritative copy used by the host path; these mirror
# vp9recon.c check_intra_mode's mode_conv[] / edge requirements)
MODE_CONV = {
    IP.VERT: (IP.DC_127, IP.VERT, IP.DC_127, IP.VERT),
    IP.HOR: (IP.DC_129, IP.DC_129, IP.HOR, IP.HOR),
    IP.DC: (IP.DC_128, IP.TOP_DC, IP.LEFT_DC, IP.DC),
    IP.DDL: (IP.DC_127, IP.DDL, IP.DC_127, IP.DDL),
    IP.DDR: (IP.DDR, IP.DDR, IP.DDR, IP.DDR),
    IP.VR: (IP.VR, IP.VR, IP.VR, IP.VR),
    IP.HD: (IP.HD, IP.HD, IP.HD, IP.HD),
    IP.VL: (IP.DC_127, IP.VL, IP.DC_127, IP.VL),
    IP.HU: (IP.DC_129, IP.DC_129, IP.HU, IP.HU),
    IP.TM: (IP.DC_129, IP.VERT, IP.HOR, IP.TM),
}
NEEDS = {          # mode -> (left, top, tl, tr, invert_left)
    IP.VERT: (0, 1, 0, 0, 0), IP.HOR: (1, 0, 0, 0, 0),
    IP.DC: (1, 1, 0, 0, 0), IP.DDL: (0, 1, 0, 1, 0),
    IP.DDR: (1, 1, 1, 0, 0), IP.VR: (1, 1, 1, 0, 0),
    IP.HD: (1, 1, 1, 0, 0), IP.VL: (0, 1, 0, 1, 0),
    IP.HU: (1, 0, 0, 0, 1), IP.TM: (1, 1, 1, 0, 0),
    IP.LEFT_DC: (1, 0, 0, 0, 0), IP.TOP_DC: (0, 1, 0, 0, 0),
    IP.DC_128: (0, 0, 0, 0, 0), IP.DC_127: (0, 0, 0, 0, 0),
    IP.DC_129: (0, 0, 0, 0, 0),
}

TX_4X4 = 0
TX_32X32 = 3
BS_8x8 = 9

class ReconRecorder:
    """Collects reconstruction work for one FrameState."""

    def __init__(self, fs):
        hp, wp = fs.y.shape
        # dependency-level grids at 4px granularity per plane kind
        self._lvl = [np.zeros((hp // 4, wp // 4), np.int32),
                     np.zeros((hp // 8, wp // 8), np.int32),
                     np.zeros((hp // 8, wp // 8), np.int32)]
        # intra records per (is_luma, size): lists of
        # (level, x0, y0, eff_mode, m_top, m_left, tl_sel, txtp,
        #  coef (n,n) int32, cpl)
        self.intra = {}
        # inter residual per (is_luma, size): (x0, y0, coef, cpl)
        self.tus = {}
        # MC tiles per (plane_kind 0/1, size): lists of
        # (cpl, dy, dx, mvx0, mvy0, ref0, mvx1, mvy1, ref1, comp, filt)
        self.mc = {}
        self.max_level = 0

    # -- inter ----------------------------------------------------------
    def record_inter(self, w, row, col, bs, tx, uvtx, eobs, blocks,
                     uveobs, uvblocks):
        from .inter import mc_calls
        fs = w.fs
        b = w.b
        filt = b["filter"]
        comp = int(b["comp"])
        ref0, ref1 = b["ref"][0], b["ref"][1]
        # group the enumerated calls by (plane, dy, dx): li=0/1 pairs
        # merge into one compound tile ((p0+p1+1)>>1 == sequential avg
        # of clipped preds, vp9recon.c inter_recon li loop)
        per = {}
        for pl, li, dy, dx, bh, bw, mvx, mvy, shift in \
                mc_calls(w, row, col, bs):
            per.setdefault((pl, dy, dx, bh, bw), [None, None])[li] = \
                (mvx, mvy)
        for (pl, dy, dx, bh, bw), mvs in per.items():
            t = 8 if bh >= 8 and bw >= 8 else 4
            m1 = mvs[1] if comp else (0, 0)
            r1 = ref1 if comp else 0
            for oy in range(0, bh, t):
                for ox in range(0, bw, t):
                    self.mc.setdefault((pl == 0, t), []).append(
                        (pl, dy + oy, dx + ox,
                         mvs[0][0], mvs[0][1], ref0,
                         m1[0], m1[1], r1, comp, filt))
        # residual (inter_recon's tx-block loops; DCT_DCT only)
        if eobs is None:
            return
        from . import tables_gen as T
        w4 = int(T.BWH_TAB[1][bs][0]) * 2
        h4 = int(T.BWH_TAB[1][bs][1]) * 2
        end_x = min(2 * (fs.cols - col), w4)
        end_y = min(2 * (fs.rows - row), h4)
        step = 1 << tx
        px, py = col * 8, row * 8
        n = 0
        for y in range(0, end_y, step):
            for x in range(0, end_x, step):
                if eobs[n]:
                    self.tus.setdefault((True, step * 4), []).append(
                        (px + x * 4, py + y * 4,
                         np.asarray(blocks[n], np.int32), 0))
                n += step * step
        ustep = 1 << uvtx
        for pl in range(2):
            n = 0
            for y in range(0, end_y >> 1, ustep):
                for x in range(0, end_x >> 1, ustep):
                    if uveobs[pl][n]:
                        self.tus.setdefault(
                            (False, ustep * 4), []).append(
                            ((px >> 1) + x * 4, (py >> 1) + y * 4,
                             np.asarray(uvblocks[pl][n], np.int32),
                             pl))
                    n += ustep * ustep

    # -- intra ----------------------------------------------------------
    def _edge_spec(self, c, pw, ph, x0, y0, n, mode, have_top,
                   have_left, have_right, tx4):
        """Resolve block.py _edges' control flow into
        (eff_mode, m_top, m_left, tl_sel) where m_* are counts of
        valid neighbour samples (0 => constant fill) and
        tl_sel: 0=127, 1=129, 2=pixel."""
        m = MODE_CONV[mode][(have_left << 1) | have_top]
        nl, nt, ntl, ntr, _inv = NEEDS[m]
        n_have = pw - x0
        m_top = 0
        if (nt or ntl) and have_top:
            if tx4 and ntr:
                if have_right and n + 4 <= n_have:
                    m_top = min(2 * n, n_have)
                else:
                    m_top = min(n, n_have)
            else:
                m_top = min(n, n_have)
        tl_sel = 1 if have_top else 0
        if ntl and have_left and have_top:
            tl_sel = 2
        m_left = 0
        if nl and have_left:
            m_left = min(n, ph - y0)
        return m, m_top, m_left, tl_sel

    def record_intra(self, w, row, col, bs, tx, uvtx, modes, uvmode,
                     eobs, blocks, uveobs, uvblocks):
        from . import tables_gen as T
        from .block import INTRA_TXFM_TYPE
        fs = w.fs
        w4 = int(T.BWH_TAB[1][bs][0]) * 2
        h4 = int(T.BWH_TAB[1][bs][1]) * 2
        end_x = min(2 * (fs.cols - col), w4)
        end_y = min(2 * (fs.rows - row), h4)
        step = 1 << tx
        px, py = col * 8, row * 8
        pw, ph = fs.cols * 8, fs.rows * 8
        n = 0
        for y in range(0, end_y, step):
            for x in range(0, end_x, step):
                mode = modes[2 * y + x if bs > BS_8x8 and
                             tx == TX_4X4 else 0]
                size = step * 4
                x0, y0 = px + x * 4, py + y * 4
                eff, m_top, m_left, tl_sel = self._edge_spec(
                    0, pw, ph, x0, y0, size, mode,
                    row > 0 or y > 0, col > w.tile_col_start or x > 0,
                    x < w4 - 1, tx == TX_4X4)
                eob = eobs[n] if eobs else 0
                coef = (np.asarray(blocks[n], np.int32) if eob
                        else np.zeros((size, size), np.int32))
                txtp = (INTRA_TXFM_TYPE[mode] if tx != TX_32X32
                        else TX.DCT_DCT)
                self._push(0, x0, y0, size, eff, m_top, m_left,
                           tl_sel, txtp, coef, 0)
                n += step * step
        ustep = 1 << uvtx
        w4c = w4 >> 1
        for pl in range(2):
            n = 0
            for y in range(0, end_y >> 1, ustep):
                for x in range(0, end_x >> 1, ustep):
                    size = ustep * 4
                    x0 = (px >> 1) + x * 4
                    y0 = (py >> 1) + y * 4
                    eff, m_top, m_left, tl_sel = self._edge_spec(
                        1 + pl, pw >> 1, ph >> 1, x0, y0, size,
                        uvmode, row > 0 or y > 0,
                        col > w.tile_col_start or x > 0,
                        x < w4c - 1, uvtx == TX_4X4)
                    eob = uveobs[pl][n] if uveobs else 0
                    coef = (np.asarray(uvblocks[pl][n], np.int32)
                            if eob
                            else np.zeros((size, size), np.int32))
                    self._push(1 + pl, x0, y0, size, eff, m_top,
                               m_left, tl_sel, TX.DCT_DCT, coef, pl)
                    n += ustep * ustep

    def _push(self, c, x0, y0, n, mode, m_top, m_left, tl_sel, txtp,
              coef, cpl):
        g = self._lvl[c]
        gh, gw = g.shape
        lvl = 0
        if m_top or tl_sel == 2:
            r = (y0 - 1) >> 2
            c0 = max(0, x0 - 1) >> 2
            c1 = min(gw - 1, (x0 + max(m_top, 1) - 1) >> 2)
            if r >= 0:
                lvl = int(g[r, c0:c1 + 1].max())
        if m_left or tl_sel == 2:
            cc = (x0 - 1) >> 2
            r0 = max(0, y0 - 1) >> 2
            r1 = min(gh - 1, (y0 + max(m_left, 1) - 1) >> 2)
            if cc >= 0:
                lvl = max(lvl, int(g[r0:r1 + 1, cc].max()))
        lvl += 1
        g[y0 >> 2:(y0 + n) >> 2, x0 >> 2:(x0 + n) >> 2] = lvl
        self.max_level = max(self.max_level, lvl)
        self.intra.setdefault((c == 0, n), []).append(
            (lvl, x0, y0, mode, m_top, m_left, tl_sel, txtp, coef,
             cpl))
