"""HEVC I-slice CTU coding: one syntax walker serving decode (with a
CabacDecoder) and encode (with a CabacEncoder + a Plan supplying CU
intents) — the crafted-stream test strategy proven on H.264.

Reconstruction is interleaved with parsing in TU z-order, as intra
prediction reads reconstructed neighbours (reference:
libavcodec/hevc/hevcdec.c hls_coding_quadtree → hls_transform_unit,
cabac.c ff_hevc_hls_residual_coding).

The port's copy of ffmpeg_tpu/codecs/hevc/ctu.py, held equal to it by
tests/test_torch_hevc_host.py."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...utils.error import InvalidData, NotSupported
from ..h264.cabac import init_contexts
from . import inter as INTER
from . import mvs as MV
from . import recon
from . import tables as T

_O = T.CTX_OFF

SCAN_DIAG, SCAN_HORIZ, SCAN_VERT = 0, 1, 2


def _wrap16(v):
    """MV component arithmetic is modulo 2^16 (spec 8.5.3.1.5)."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


class _IO:
    def __init__(self, core, encode: bool):
        self.core = core
        self.encode = encode

    def dec(self, ctx, v=None):
        if self.encode:
            self.core.decision(ctx, v)
            return v
        return self.core.decision(ctx)

    def byp(self, v=None):
        if self.encode:
            self.core.bypass(v)
            return v
        return self.core.bypass()

    def term(self, v=None):
        if self.encode:
            self.core.terminate(v)
            return v
        return self.core.terminate()


def _morton(x, y, bits):
    z = 0
    for i in range(bits):
        z |= ((x >> i) & 1) << (2 * i)
        z |= ((y >> i) & 1) << (2 * i + 1)
    return z


class FrameDec:
    """Per-picture decode state. For P/B pictures, refs[l][i] are the
    (y, u, v) planes of the reference with POC rpl[l][i]."""

    def __init__(self, sps, pps, sh, poc=0, refs=None, rpl=None):
        self.sps, self.pps, self.sh = sps, pps, sh
        self.poc = poc
        self.refs = refs or [[], []]
        self.rpl = rpl or [[], []]
        W, H = sps.width, sps.height
        self.bd = sps.bit_depth
        self.pmax = (1 << self.bd) - 1
        dt = np.uint8 if self.bd == 8 else np.uint16
        self.y = np.zeros((H, W), dt)
        self.u = np.zeros((H // 2, W // 2), dt)
        self.v = np.zeros((H // 2, W // 2), dt)
        # when set (recorder.ReconRecorder), the parse records recon
        # work items instead of reconstructing inline; recon_tpu.py
        # replays them on the device
        self.recorder = None
        # per-4x4 (min PU/TB) intra mode map, default DC (=1)
        self.ipm = np.ones(((H + 3) // 4, (W + 3) // 4), np.int32)
        ncb = 1 << (sps.log2_ctb - sps.log2_min_cb)
        self.ct_depth = np.zeros((sps.ctb_height * ncb + 1,
                                  sps.ctb_width * ncb + 1), np.int32)
        self.qp = sh.qp
        # tile structure (spec 6.5.1): per-CTB tile id + tile-scan
        # order (raster within tile, tiles in raster order)
        cw, ch = sps.ctb_width, sps.ctb_height
        col_bd, row_bd = pps.tile_bounds(sps)
        self.col_bd, self.row_bd = col_bd, row_bd
        self.tile_id = np.zeros((ch, cw), np.int32)
        self.ts_order = []                # rs addrs in tile-scan order
        tid = 0
        for tr in range(len(row_bd) - 1):
            for tc in range(len(col_bd) - 1):
                for yy in range(row_bd[tr], row_bd[tr + 1]):
                    for xx in range(col_bd[tc], col_bd[tc + 1]):
                        self.tile_id[yy, xx] = tid
                        self.ts_order.append(yy * cw + xx)
                tid += 1
        # per-min-TB z-scan address (tile-scan CTB major, morton
        # minor — spec 6.5.2 MinTbAddrZs)
        d = sps.log2_ctb - 2
        n4x = cw << d
        n4y = ch << d
        xs = np.arange(n4x)
        ys = np.arange(n4y)
        ts_of_rs = np.empty(cw * ch, np.int64)
        ts_of_rs[np.asarray(self.ts_order)] = np.arange(cw * ch)
        ctb = ts_of_rs[(ys[:, None] >> d) * cw + (xs[None, :] >> d)]
        m = np.zeros((1 << d, 1 << d), np.int64)
        for yy in range(1 << d):
            for xx in range(1 << d):
                m[yy, xx] = _morton(xx, yy, d)
        self.zs = (ctb << (2 * d)) + m[ys[:, None] & ((1 << d) - 1),
                                       xs[None, :] & ((1 << d) - 1)]
        self.cbf_luma_map = np.zeros((n4y, n4x), np.uint8)
        # deblocker boundary-strength maps at 4x4 granularity
        # (filter.c vertical_bs/horizontal_bs analogs)
        self.bs_v = np.zeros((H // 4, W // 4), np.int32)
        self.bs_h = np.zeros((H // 4, W // 4), np.int32)
        # motion field at 4x4 granularity (mvs.c tab_mvf): pred flag
        # (0 intra / 1 L0 / 2 L1 / 3 BI), mv per list, ref idx per list
        self.pf = np.zeros((H // 4, W // 4), np.int32)
        self.mvx = np.zeros((H // 4, W // 4, 2), np.int32)
        self.mvy = np.zeros((H // 4, W // 4, 2), np.int32)
        self.refidx = np.zeros((H // 4, W // 4, 2), np.int32)
        self.skip = np.zeros((H // 4, W // 4), np.uint8)
        # per-CTB SAO parameters (type 0 off/1 band/2 edge;
        # offset[c][0..4] = SaoOffsetVal with [0] == 0)
        ch, cw = sps.ctb_height, sps.ctb_width
        self.sao_type = np.zeros((ch, cw, 3), np.int32)
        self.sao_offset = np.zeros((ch, cw, 3, 5), np.int32)
        self.sao_band_pos = np.zeros((ch, cw, 3), np.int32)
        self.sao_eo_class = np.zeros((ch, cw, 3), np.int32)

    def same_tile(self, x0, y0, xn, yn):
        """True iff the pixel coords lie in the same tile (both must
        be inside the picture)."""
        sh = self.sps.log2_ctb
        return self.tile_id[y0 >> sh, x0 >> sh] == \
            self.tile_id[yn >> sh, xn >> sh]


class CtuCoder:
    def __init__(self, dec: FrameDec, core, encode=False, plan=None,
                 payload=None):
        self.dec = dec
        self.io = _IO(core, encode)
        self.plan = plan
        # initType (spec 9.3.2.2): I=0; P=1, B=2 with cabac_init_flag
        # off (cabac_init_present unsupported)
        self._init_type = {2: 0, 1: 1, 0: 2}[dec.sh.slice_type]
        if dec.sh.cabac_init and self._init_type:
            self._init_type = 3 - self._init_type
        self.ctx = self._fresh_ctx()
        self._cu_intra = True
        self._cu_skip = False
        self._cu_depth = 0
        self._inter_split = False
        # substreams (tiles / WPP): decode jumps to entry-point byte
        # offsets in `payload`; encode collects one CabacEncoder per
        # substream in enc_substreams
        self._payload = payload
        self.enc_substreams = [core] if encode else None

    def _fresh_ctx(self):
        return init_contexts(T.init_mn(self._init_type),
                             max(0, min(51, self.dec.qp)))

    # ------------------------------------------------------------------
    def code_slice_data(self):
        """Walk CTUs in tile-scan order, managing CABAC substreams at
        tile starts (fresh contexts) and WPP row starts (contexts
        synced from after the 2nd CTU of the row above — spec 9.3.2.3;
        hevcdec.c:1118,2717)."""
        dec = self.dec
        sps, pps, sh = dec.sps, dec.pps, dec.sh
        cw = sps.ctb_width
        order = dec.ts_order
        n = len(order)
        wpp = pps.entropy_coding_sync

        def new_substream(ts):
            if ts == 0 or ts >= n:
                return False
            a, b = order[ts - 1], order[ts]
            if pps.tiles_enabled:
                return dec.tile_id[b // cw, b % cw] != \
                    dec.tile_id[a // cw, a % cw]
            if wpp:
                return b % cw == 0        # raster row start
            return False

        sub_offs = None
        if not self.io.encode and sh.entry_points:
            sub_offs = [0]
            for sz in sh.entry_points:
                sub_offs.append(sub_offs[-1] + sz)
        sub_idx = 0
        wpp_saved = {}                    # ctb row -> ctx snapshot
        for ts in range(n):
            addr = order[ts]
            rx = addr % cw
            ry = addr // cw
            if new_substream(ts):
                sub_idx += 1
                if self.io.encode:
                    enc = type(self.io.core)()
                    self.enc_substreams.append(enc)
                    self.io.core = enc
                else:
                    if sub_offs is None or sub_idx >= len(sub_offs):
                        raise InvalidData("hevc: missing entry point "
                                          "offsets for substream")
                    off = sub_offs[sub_idx]
                    self.io.core = type(self.io.core)(
                        self._payload[off:])
                if wpp and wpp_saved.get(ry - 1) is not None:
                    self.ctx = [list(c) for c in wpp_saved[ry - 1]]
                else:
                    self.ctx = self._fresh_ctx()
            ctb_x = rx << sps.log2_ctb
            ctb_y = ry << sps.log2_ctb
            if sps.sao_enabled and (sh.sao_luma or sh.sao_chroma):
                self.sao(rx, ry)
            self.coding_quadtree(ctb_x, ctb_y, sps.log2_ctb, 0)
            if wpp and rx == 1:           # sync snapshot (9.3.2.3)
                wpp_saved[ry] = [list(c) for c in self.ctx]
            last = ts == n - 1
            if self.io.term(1 if last else 0) and not last:
                raise InvalidData("hevc: early end_of_slice")
            if not last and new_substream(ts + 1) and self.io.encode:
                # end_of_subset_one_bit + flush; decoders jump to the
                # next entry point instead of reading it
                self.io.term(1)

    # ------------------------------------------------------------------
    def sao(self, rx, ry):
        """sao() syntax (spec 7.3.8.3; hevc/cabac.c sao_* decoders)."""
        dec, io = self.dec, self.io
        sh = dec.sh
        merge_left = merge_up = 0
        tid = dec.tile_id
        if rx > 0 and tid[ry, rx - 1] == tid[ry, rx]:
            v = None
            if io.encode:
                v = 1 if self.plan.sao_merge_left(rx, ry) else 0
            merge_left = io.dec(self.ctx[_O["sao_merge_flag"]], v)
        if not merge_left and ry > 0 and tid[ry - 1, rx] == tid[ry, rx]:
            v = None
            if io.encode:
                v = 1 if self.plan.sao_merge_up(rx, ry) else 0
            merge_up = io.dec(self.ctx[_O["sao_merge_flag"]], v)
        if merge_left or merge_up:
            sy, sx = (ry, rx - 1) if merge_left else (ry - 1, rx)
            for arr in (dec.sao_type, dec.sao_offset,
                        dec.sao_band_pos, dec.sao_eo_class):
                arr[ry, rx] = arr[sy, sx]
            return
        for c in range(3):
            if (c == 0 and not sh.sao_luma) or \
                    (c > 0 and not sh.sao_chroma):
                continue
            if c == 2:                   # Cr shares Cb's type/class
                t = int(dec.sao_type[ry, rx, 1])
                eo = int(dec.sao_eo_class[ry, rx, 1])
            else:
                tv = None
                if io.encode:
                    tv = self.plan.sao_type(c, rx, ry)
                b0 = io.dec(self.ctx[_O["sao_type_idx"]],
                            None if tv is None else int(tv > 0))
                if not b0:
                    t = 0
                else:
                    b1 = io.byp(None if tv is None else int(tv == 2))
                    t = 2 if b1 else 1
                eo = -1
            dec.sao_type[ry, rx, c] = t
            if not t:
                continue
            absv = []
            for i in range(4):
                av = None
                if io.encode:
                    av = abs(self.plan.sao_offset(c, rx, ry, i))
                absv.append(self._sao_offset_abs(av))
            vals = np.zeros(5, np.int32)
            if t == 1:                   # band
                for i in range(4):
                    sgn = 0
                    if absv[i]:
                        sv = None
                        if io.encode:
                            sv = 1 if self.plan.sao_offset(
                                c, rx, ry, i) < 0 else 0
                        sgn = io.byp(sv)
                    vals[i + 1] = -absv[i] if sgn else absv[i]
                bp = 0
                bv = None
                if io.encode:
                    bv = self.plan.sao_band_position(c, rx, ry)
                for k in range(4, -1, -1):
                    bp = (bp << 1) | io.byp(
                        None if bv is None else (bv >> k) & 1)
                dec.sao_band_pos[ry, rx, c] = bp
            else:                        # edge: signs are inferred
                vals[1], vals[2] = absv[0], absv[1]
                vals[3], vals[4] = -absv[2], -absv[3]
                if c < 2:
                    eo = 0
                    ev = None
                    if io.encode:
                        ev = self.plan.sao_eo_class(c, rx, ry)
                    for k in (1, 0):
                        eo = (eo << 1) | io.byp(
                            None if ev is None else (ev >> k) & 1)
                dec.sao_eo_class[ry, rx, c] = eo
            dec.sao_offset[ry, rx, c] = vals

    def _sao_offset_abs(self, v=None):
        """TR binarization, cMax = (1 << (min(bd,10)-5)) - 1, bypass."""
        io = self.io
        cmax = (1 << (min(self.dec.bd, 10) - 5)) - 1
        if io.encode:
            for _ in range(v):
                io.byp(1)
            if v < cmax:
                io.byp(0)
            return v
        i = 0
        while i < cmax and io.byp():
            i += 1
        return i

    # ------------------------------------------------------------------
    def coding_quadtree(self, x0, y0, log2, depth):
        dec = self.dec
        sps = dec.sps
        size = 1 << log2
        inside = x0 + size <= sps.width and y0 + size <= sps.height
        if inside and log2 > sps.log2_min_cb:
            split = self._split_cu_flag(x0, y0, depth)
        else:
            split = log2 > sps.log2_min_cb
        if split:
            h = size >> 1
            x1, y1 = x0 + h, y0 + h
            self.coding_quadtree(x0, y0, log2 - 1, depth + 1)
            if x1 < sps.width:
                self.coding_quadtree(x1, y0, log2 - 1, depth + 1)
            if y1 < sps.height:
                self.coding_quadtree(x0, y1, log2 - 1, depth + 1)
            if x1 < sps.width and y1 < sps.height:
                self.coding_quadtree(x1, y1, log2 - 1, depth + 1)
            return
        self._set_ct_depth(x0, y0, log2, depth)
        self._cu_depth = depth
        self.coding_unit(x0, y0, log2)

    def _split_cu_flag(self, x0, y0, depth):
        dec = self.dec
        sps = dec.sps
        xcb, ycb = x0 >> sps.log2_min_cb, y0 >> sps.log2_min_cb
        inc = 0
        x0b = x0 & ((1 << sps.log2_ctb) - 1)
        y0b = y0 & ((1 << sps.log2_ctb) - 1)
        if x0b or (x0 > 0 and dec.same_tile(x0, y0, x0 - 1, y0)):
            inc += int(dec.ct_depth[ycb, xcb - 1] > depth)
        if y0b or (y0 > 0 and dec.same_tile(x0, y0, x0, y0 - 1)):
            inc += int(dec.ct_depth[ycb - 1, xcb] > depth)
        v = None
        if self.io.encode:
            v = 1 if self.plan.split(x0, y0,
                                     sps.log2_ctb - depth) else 0
        return bool(self.io.dec(self.ctx[_O["split_cu_flag"] + inc], v))

    def _set_ct_depth(self, x0, y0, log2, depth):
        sps = self.dec.sps
        n = 1 << (log2 - sps.log2_min_cb)
        xcb, ycb = x0 >> sps.log2_min_cb, y0 >> sps.log2_min_cb
        self.dec.ct_depth[ycb:ycb + n, xcb:xcb + n] = depth

    # ------------------------------------------------------------------
    def coding_unit(self, x0, y0, log2):
        dec = self.dec
        sps = dec.sps
        io = self.io
        size = 1 << log2
        n4 = size >> 2
        x4, y4 = x0 >> 2, y0 >> 2
        self._cu_skip = False
        self._cu_intra = True
        if dec.sh.slice_type != 2:
            inc = 0
            if x0 > 0 and dec.same_tile(x0, y0, x0 - 1, y0):
                inc += int(dec.skip[y4, x4 - 1])
            if y0 > 0 and dec.same_tile(x0, y0, x0, y0 - 1):
                inc += int(dec.skip[y4 - 1, x4])
            v = None
            if io.encode:
                v = 1 if self.plan.cu_skip(x0, y0, log2) else 0
            skip = io.dec(self.ctx[_O["skip_flag"] + inc], v)
            dec.skip[y4:y4 + n4, x4:x4 + n4] = skip
            if skip:
                self._cu_skip = True
                self._cu_intra = False
                self._prediction_unit(x0, y0, x0, y0, size, size,
                                      "2Nx2N", 0)
                if not io.encode:
                    MV.boundary_strengths(dec, x0, y0, log2)
                return
            v = None
            if io.encode:
                v = 0 if self.plan.cu_is_inter(x0, y0, log2) else 1
            if not io.dec(self.ctx[_O["pred_mode"]], v):
                self._cu_intra = False
                self._inter_cu(x0, y0, log2)
                return
        self.intra_coding_unit(x0, y0, log2)

    # ------------------------------------------------------------------
    def _inter_cu(self, x0, y0, log2):
        """Inter CU: part mode, PUs, rqt_root_cbf, transform tree
        (spec 7.3.8.5; hevcdec.c hls_coding_unit inter path)."""
        dec, io = self.dec, self.io
        sps = dec.sps
        size = 1 << log2
        part = self._part_mode_inter(x0, y0, log2)
        if part == "2Nx2N":
            pus = ((x0, y0, size, size, 0),)
        elif part == "2NxN":
            h = size >> 1
            pus = ((x0, y0, size, h, 0), (x0, y0 + h, size, h, 1))
        else:                             # Nx2N
            w = size >> 1
            pus = ((x0, y0, w, size, 0), (x0 + w, y0, w, size, 1))
        merged = []
        for px, py, pw, ph, pidx in pus:
            merged.append(self._prediction_unit(x0, y0, px, py, pw, ph,
                                                part, pidx))
        rqt_root = True
        if not (part == "2Nx2N" and merged[0]):
            v = None
            if io.encode:
                v = 1 if self.plan.rqt_root_cbf(x0, y0, log2) else 0
            rqt_root = bool(io.dec(self.ctx[_O["no_residual_data"]],
                                   v))
        if rqt_root:
            self._intra_split = False
            self._inter_split = sps.max_trafo_depth_inter == 0 and \
                part != "2Nx2N"
            self._max_td = sps.max_trafo_depth_inter
            self._pu_modes = None
            self._mode_c = None
            self.transform_tree(x0, y0, x0, y0, log2, 0, 0, 1, 1, None)
        elif not io.encode:
            MV.boundary_strengths(dec, x0, y0, log2)

    def _part_mode_inter(self, x0, y0, log2):
        """part_mode binarization for inter CUs (9.3.3.7, no AMP;
        cabac.c ff_hevc_part_mode_decode)."""
        dec, io = self.dec, self.io
        sps = dec.sps
        want = None
        if io.encode:
            want = self.plan.part_mode_inter(x0, y0, log2)
        if io.dec(self.ctx[_O["part_mode"]],
                  None if want is None else int(want == "2Nx2N")):
            return "2Nx2N"
        if log2 == sps.log2_min_cb:
            if io.dec(self.ctx[_O["part_mode"] + 1],
                      None if want is None else int(want == "2NxN")):
                return "2NxN"
            if log2 == 3:
                return "Nx2N"
            if io.dec(self.ctx[_O["part_mode"] + 2],
                      None if want is None else int(want == "Nx2N")):
                return "Nx2N"
            raise NotSupported("hevc: inter NxN partitions")
        if io.dec(self.ctx[_O["part_mode"] + 1],
                  None if want is None else int(want == "2NxN")):
            return "2NxN"
        return "Nx2N"

    # ------------------------------------------------------------------
    def _prediction_unit(self, cu_x, cu_y, x0, y0, w, h, part, pidx):
        """prediction_unit() (spec 7.3.8.6) → True if merged."""
        dec, io = self.dec, self.io
        sh = dec.sh
        if self._cu_skip:
            merge = True
        else:
            v = None
            if io.encode:
                v = 1 if self.plan.pu_merge(x0, y0, pidx) else 0
            merge = bool(io.dec(self.ctx[_O["merge_flag"]], v))
        if merge:
            midx = 0
            if sh.max_num_merge_cand > 1:
                midx = self._merge_idx(x0, y0, pidx)
            f = MV.derive_merge(dec, cu_x, cu_y, x0, y0, w, h, part,
                                pidx, midx)
        else:
            is_b = sh.slice_type == 0
            idc = 0                       # PRED_L0
            if is_b:
                idc = self._inter_pred_idc(x0, y0, w, h)
            pf = 0
            mvs = [(0, 0), (0, 0)]
            refs = [0, 0]
            for ll in (0, 1):
                if is_b:
                    use = idc == 2 or idc == ll
                else:
                    use = ll == 0
                if not use:
                    continue
                pf |= 1 << ll
                nref = sh.num_ref_idx[ll]
                ri = self._ref_idx(x0, y0, pidx, ll, nref) \
                    if nref > 1 else 0
                if ll == 1 and sh.mvd_l1_zero and idc == 2:
                    mvd = (0, 0)
                else:
                    mvd = self._mvd_coding(x0, y0, pidx, ll)
                mvp = self._mvp_flag(x0, y0, pidx, ll)
                refs[ll] = ri
                pred = MV.derive_mvp(dec, x0, y0, w, h, ll, ri, mvp)
                mvs[ll] = (_wrap16(pred[0] + mvd[0]),
                           _wrap16(pred[1] + mvd[1]))
            f = MV.MvField(pf, mvs, refs)
        MV.set_mvf(dec, x0, y0, w, h, f)
        if not io.encode and dec.recorder is None:
            INTER.predict_pu(dec, x0, y0, w, h, f)
        return merge

    def _merge_idx(self, x0, y0, pidx):
        io = self.io
        mx = self.dec.sh.max_num_merge_cand
        m = None
        if io.encode:
            m = self.plan.pu_merge_idx(x0, y0, pidx)
        i = io.dec(self.ctx[_O["merge_idx"]],
                   None if m is None else int(m > 0))
        if i:
            while i < mx - 1:
                bit = io.byp(None if m is None else (1 if m > i else 0))
                if not bit:
                    break
                i += 1
        return i

    def _inter_pred_idc(self, x0, y0, w, h):
        io = self.io
        want = None
        if io.encode:
            want = self.plan.pu_inter_pred_idc(x0, y0, w, h)
            if w + h == 12 and want == 2:
                raise InvalidData("hevc: 8x4/4x8 PUs cannot be BI")
        if w + h != 12:
            if io.dec(self.ctx[_O["inter_pred_idc"] + self._cu_depth],
                      None if want is None else int(want == 2)):
                return 2
        if io.dec(self.ctx[_O["inter_pred_idc"] + 4],
                  None if want is None else int(want == 1)):
            return 1
        return 0

    def _ref_idx(self, x0, y0, pidx, ll, nref):
        """TR; both lists share the ref_idx_l0 contexts
        (cabac.c ff_hevc_ref_idx_lx_decode)."""
        io = self.io
        want = None
        if io.encode:
            want = self.plan.pu_ref_idx(x0, y0, pidx, ll)
        mx = nref - 1
        max_ctx = min(mx, 2)
        i = 0
        while i < max_ctx:
            bit = io.dec(self.ctx[_O["ref_idx_l0"] + i],
                         None if want is None else int(want > i))
            if not bit:
                break
            i += 1
        if i == 2:
            while i < mx:
                bit = io.byp(None if want is None else int(want > i))
                if not bit:
                    break
                i += 1
        return i

    def _mvp_flag(self, x0, y0, pidx, ll):
        io = self.io
        v = None
        if io.encode:
            v = self.plan.pu_mvp_flag(x0, y0, pidx, ll)
        return io.dec(self.ctx[_O["mvp_lx_flag"]], v)

    def _mvd_coding(self, x0, y0, pidx, ll):
        """mvd_coding() (spec 7.3.8.9; cabac.c hls_mvd_coding)."""
        io = self.io
        want = (None, None)
        if io.encode:
            want = self.plan.pu_mvd(x0, y0, pidx, ll)
        gs = []
        for comp in range(2):
            wv = want[comp]
            gs.append(io.dec(
                self.ctx[_O["abs_mvd_greater0"]],
                None if wv is None else int(wv != 0)))
        for comp in range(2):
            if gs[comp]:
                wv = want[comp]
                gs[comp] += io.dec(
                    self.ctx[_O["abs_mvd_greater1"] + 1],
                    None if wv is None else int(abs(wv) > 1))
        out = []
        for comp in range(2):
            wv = want[comp]
            if gs[comp] == 0:
                out.append(0)
            elif gs[comp] == 1:
                bit = io.byp(None if wv is None else int(wv < 0))
                out.append(-1 if bit else 1)
            else:
                out.append(self._mvd_value(wv))
        return tuple(out)

    def _mvd_value(self, wv=None):
        """|mvd| >= 2: EG1-style code + bypass sign (mvd_decode)."""
        io = self.io
        if io.encode:
            v = abs(wv)
            p = v.bit_length() - 2
            for _ in range(p):
                io.byp(1)
            io.byp(0)
            suffix = v - (1 << (p + 1))
            for k in range(p, -1, -1):
                io.byp((suffix >> k) & 1)
            io.byp(1 if wv < 0 else 0)
            return wv
        ret = 2
        k = 1
        while io.byp():
            ret += 1 << k
            k += 1
        for k in range(k - 1, -1, -1):
            ret += io.byp() << k
        return -ret if io.byp() else ret

    # ------------------------------------------------------------------
    def intra_coding_unit(self, x0, y0, log2):
        dec = self.dec
        sps = dec.sps
        size = 1 << log2
        part_nxn = False
        if log2 == sps.log2_min_cb:
            v = None
            if self.io.encode:
                v = 0 if self.plan.part_nxn(x0, y0, log2) else 1
            bit = self.io.dec(self.ctx[_O["part_mode"]], v)
            part_nxn = bit == 0
        side = 2 if part_nxn else 1
        pb = size >> (1 if part_nxn else 0)
        nparts = side * side
        # all prev_intra flags first, then per-part mpm/rem. MPM
        # candidates of parts 1..3 see the earlier parts' modes, so the
        # encoder pre-writes the intended modes into the mode map
        # before deriving them (the decoder derives them in the second
        # loop as it stores each decoded mode).
        want = [None] * nparts
        cands_enc = [None] * nparts
        if self.io.encode:
            for i in range(nparts):
                px = x0 + pb * (i & 1)
                py = y0 + pb * (i >> 1)
                want[i] = self.plan.luma_mode(px, py, log2, i)
                cands_enc[i] = self._mpm_candidates(px, py)
                npu = max(1, pb >> 2)
                dec.ipm[py >> 2:(py >> 2) + npu,
                        px >> 2:(px >> 2) + npu] = want[i]
        prev = []
        for i in range(nparts):
            pv = None
            if self.io.encode:
                pv = 1 if want[i] in cands_enc[i] else 0
            prev.append(self.io.dec(
                self.ctx[_O["prev_intra_luma_pred"]], pv))
        modes = []
        for i in range(nparts):
            if self.io.encode:
                cand = cands_enc[i]
            else:
                cand = self._mpm_candidates(x0 + pb * (i & 1),
                                            y0 + pb * (i >> 1))
            if prev[i]:
                mv = None
                if self.io.encode:
                    mv = cand.index(want[i])
                idx = 0
                while idx < 2 and self.io.byp(
                        None if mv is None else (1 if mv > idx else 0)):
                    idx += 1
                mode = cand[idx]
            else:
                scand = sorted(cand)
                rv = None
                if self.io.encode:
                    rv = want[i]
                    for c in reversed(scand):
                        if rv > c:
                            rv -= 1
                bits = []
                for k in range(4, -1, -1):
                    bits.append(self.io.byp(
                        None if rv is None else (rv >> k) & 1))
                mode = 0
                for bbit in bits:
                    mode = (mode << 1) | bbit
                for c in scand:
                    if mode >= c:
                        mode += 1
            modes.append(mode)
            px = x0 + pb * (i & 1)
            py = y0 + pb * (i >> 1)
            npu = max(1, pb >> 2)
            dec.ipm[py >> 2:(py >> 2) + npu,
                    px >> 2:(px >> 2) + npu] = mode
        # chroma mode (one for 4:2:0)
        table = [0, 26, 10, 1]
        cv = None
        if self.io.encode:
            cv = self.plan.chroma_mode(x0, y0, log2, modes[0])
        first = self.io.dec(self.ctx[_O["intra_chroma_pred_mode"]],
                            None if cv is None else (0 if cv == 4 else 1))
        if not first:
            chroma_idx = 4
        else:
            b1 = self.io.byp(None if cv is None else (cv >> 1) & 1)
            b0 = self.io.byp(None if cv is None else cv & 1)
            chroma_idx = (b1 << 1) | b0
        if chroma_idx == 4:
            mode_c = modes[0]
        elif table[chroma_idx] == modes[0]:
            mode_c = 34
        else:
            mode_c = table[chroma_idx]
        # transform tree
        self._intra_split = part_nxn
        self._inter_split = False
        self._max_td = self.dec.sps.max_trafo_depth_intra + \
            (1 if part_nxn else 0)
        self._pu_modes = modes
        self._mode_c = mode_c
        self.transform_tree(x0, y0, x0, y0, log2, 0, 0, 1, 1,
                            modes[0])

    def _mpm_candidates(self, x0, y0):
        dec = self.dec
        sps = dec.sps
        x0b = x0 & ((1 << sps.log2_ctb) - 1)
        y0b = y0 & ((1 << sps.log2_ctb) - 1)
        cand_up = 1
        if y0b:                      # never crosses the CTB top edge
            cand_up = int(dec.ipm[(y0 - 1) >> 2, x0 >> 2])
        cand_left = 1
        if x0b or (x0 > 0 and dec.same_tile(x0, y0, x0 - 1, y0)):
            cand_left = int(dec.ipm[y0 >> 2, (x0 - 1) >> 2])
        if cand_left == cand_up:
            if cand_left < 2:
                return [0, 1, 26]
            return [cand_left,
                    2 + ((cand_left - 2 - 1 + 32) & 31),
                    2 + ((cand_left - 2 + 1) & 31)]
        c2 = 0 if (cand_left != 0 and cand_up != 0) else \
            (1 if (cand_left != 1 and cand_up != 1) else 26)
        return [cand_left, cand_up, c2]

    # ------------------------------------------------------------------
    def transform_tree(self, x0, y0, xBase, yBase, log2, depth, blk_idx,
                       pcb, pcr, cur_mode):
        dec = self.dec
        sps = dec.sps
        if self._intra_split and depth == 1:
            cur_mode = self._pu_modes[blk_idx]
        if log2 <= sps.log2_max_tb and log2 > sps.log2_min_tb and \
                depth < self._max_td and \
                not (self._intra_split and depth == 0):
            v = None
            if self.io.encode:
                v = 1 if self.plan.split_tt(x0, y0, log2, depth) else 0
            split = bool(self.io.dec(
                self.ctx[_O["split_transform_flag"] + 5 - log2], v))
        else:
            split = log2 > sps.log2_max_tb or \
                (self._intra_split and depth == 0) or \
                (getattr(self, "_inter_split", False) and depth == 0)
        cbf_cb, cbf_cr = pcb, pcr
        if log2 > 2:
            if depth == 0 or pcb:
                v = None
                if self.io.encode:
                    v = 1 if self.plan.cbf_cb(x0, y0, log2, depth,
                                              split) else 0
                cbf_cb = self.io.dec(self.ctx[_O["cbf_cb_cr"] + depth], v)
            if depth == 0 or pcr:
                v = None
                if self.io.encode:
                    v = 1 if self.plan.cbf_cr(x0, y0, log2, depth,
                                              split) else 0
                cbf_cr = self.io.dec(self.ctx[_O["cbf_cb_cr"] + depth], v)
        if split:
            h = 1 << (log2 - 1)
            self.transform_tree(x0, y0, x0, y0, log2 - 1, depth + 1, 0,
                                cbf_cb, cbf_cr, cur_mode)
            self.transform_tree(x0 + h, y0, x0, y0, log2 - 1, depth + 1,
                                1, cbf_cb, cbf_cr, cur_mode)
            self.transform_tree(x0, y0 + h, x0, y0, log2 - 1, depth + 1,
                                2, cbf_cb, cbf_cr, cur_mode)
            self.transform_tree(x0 + h, y0 + h, x0, y0, log2 - 1,
                                depth + 1, 3, cbf_cb, cbf_cr, cur_mode)
            return
        # leaf: cbf_luma — coded for intra / deeper levels / when a
        # chroma cbf is set; inferred 1 for inter depth-0 otherwise
        if self._cu_intra or depth != 0 or cbf_cb or cbf_cr:
            v = None
            if self.io.encode:
                v = 1 if self.plan.cbf_luma(x0, y0, log2, depth) else 0
            cbf_luma = self.io.dec(
                self.ctx[_O["cbf_luma"] + (1 if depth == 0 else 0)], v)
        else:
            cbf_luma = 1
        self.transform_unit(x0, y0, xBase, yBase, log2, blk_idx,
                            cbf_luma, cbf_cb, cbf_cr, cur_mode)

    # ------------------------------------------------------------------
    def _avail(self, x0, y0, size):
        """Neighbour availability for intra refs (mvs.c
        set_neighbour_available + pred_template z-scan conditions).
        Returns (l, bl, t, tr, tl)."""
        dec = self.dec
        sps = dec.sps
        ctb_size = 1 << sps.log2_ctb
        x0b = x0 & (ctb_size - 1)
        y0b = y0 & (ctb_size - 1)
        ctb_x, ctb_y = x0 >> sps.log2_ctb, y0 >> sps.log2_ctb
        tid = dec.tile_id
        cur_t = tid[ctb_y, ctb_x]
        ctb_left = ctb_x > 0 and tid[ctb_y, ctb_x - 1] == cur_t
        ctb_up = ctb_y > 0 and tid[ctb_y - 1, ctb_x] == cur_t
        ctb_up_left = ctb_x > 0 and ctb_y > 0 and \
            tid[ctb_y - 1, ctb_x - 1] == cur_t
        ctb_up_right = ctb_y > 0 and (ctb_x + 1) < sps.ctb_width and \
            tid[ctb_y - 1, ctb_x + 1] == cur_t
        cand_up = bool(ctb_up or y0b)
        cand_left = bool(ctb_left or x0b)
        if x0b or y0b:
            cand_up_left = cand_left and cand_up
        else:
            cand_up_left = ctb_up_left
        if x0b + size == ctb_size:
            sap = ctb_up_right and not y0b
        else:
            sap = cand_up
        cand_tr = sap and (x0 + size) < sps.width
        cand_bl = cand_left and (y0 + size) < sps.height
        cur = int(dec.zs[y0 >> 2, x0 >> 2])
        if cand_tr:
            cand_tr = cur > int(dec.zs[(y0 - 1) >> 2, (x0 + size) >> 2]) \
                and dec.same_tile(x0, y0, x0 + size, y0 - 1)
        if cand_bl:
            cand_bl = cur > int(dec.zs[(y0 + size) >> 2, (x0 - 1) >> 2]) \
                and dec.same_tile(x0, y0, x0 - 1, y0 + size)
        return cand_left, cand_bl, cand_up, cand_tr, cand_up_left

    def _filter_kind(self, mode, size, c_idx):
        """Reference-sample filter kind for a recorded intra pred
        (recorder.F_*): none / [1 2 1] smooth / strong-candidate."""
        from . import recorder as R
        if not recon.smoothing_applies(mode, size, c_idx):
            return R.F_NONE
        if self.dec.sps.strong_intra_smoothing and c_idx == 0 \
                and size == 32:
            return R.F_STRONG
        return R.F_SMOOTH

    def _intra_pred(self, plane, x, y, size, mode, c_idx, avail):
        l, bl, t, tr, tl = avail
        bd = self.dec.bd
        pic_h, pic_w = plane.shape
        left, top = recon.build_refs(plane, x, y, size, l, bl, t, tr,
                                     tl, pic_w, pic_h, bd=bd)
        if recon.smoothing_applies(mode, size, c_idx):
            strong = self.dec.sps.strong_intra_smoothing and \
                c_idx == 0 and size == 32
            left, top = recon.filter_refs(left, top, size, strong,
                                          bd=bd)
        return recon.pred_intra(left, top, size, mode, c_idx, bd=bd)

    def transform_unit(self, x0, y0, xBase, yBase, log2, blk_idx,
                       cbf_luma, cbf_cb, cbf_cr, mode):
        dec = self.dec
        size = 1 << log2
        mode_c = self._mode_c
        # luma: intra prediction (inter PUs were predicted at PU
        # parse), then residual
        if self._cu_intra and not self.io.encode:
            avail = self._avail(x0, y0, size)
            if dec.recorder is not None:
                dec.recorder.record_intra(
                    0, x0, y0, size, mode, avail,
                    self._filter_kind(mode, size, 0))
            else:
                pred = self._intra_pred(dec.y, x0, y0, size, mode, 0,
                                        avail)
                dec.y[y0:y0 + size, x0:x0 + size] = np.clip(pred, 0,
                                                            dec.pmax)
        scan = SCAN_DIAG
        scan_c = SCAN_DIAG
        if self._cu_intra and log2 < 4:   # mode-based scans: intra only
            if 6 <= mode <= 14:
                scan = SCAN_VERT
            elif 22 <= mode <= 30:
                scan = SCAN_HORIZ
            if 6 <= mode_c <= 14:
                scan_c = SCAN_VERT
            elif 22 <= mode_c <= 30:
                scan_c = SCAN_HORIZ
        if cbf_luma:
            yl = min(y0 + size, dec.sps.height) >> 2
            xl = min(x0 + size, dec.sps.width) >> 2
            dec.cbf_luma_map[y0 >> 2:yl, x0 >> 2:xl] = 1
            self.residual(x0, y0, log2, scan, 0)
        if log2 > 2:
            self._chroma_part(x0 >> 1, y0 >> 1, log2 - 1, scan_c,
                              cbf_cb, cbf_cr, mode_c)
        elif blk_idx == 3:
            self._chroma_part(xBase >> 1, yBase >> 1, 2, scan_c,
                              cbf_cb, cbf_cr, mode_c)
        if not self.io.encode:
            MV.boundary_strengths(dec, x0, y0, log2)

    def _chroma_part(self, xc, yc, log2c, scan_c, cbf_cb, cbf_cr,
                     mode_c):
        dec = self.dec
        sizec = 1 << log2c
        for c_idx, (pl, cbf) in enumerate(((dec.u, cbf_cb),
                                           (dec.v, cbf_cr)), start=1):
            if self._cu_intra and not self.io.encode:
                avail = self._avail(xc * 2, yc * 2, sizec * 2)
                if dec.recorder is not None:
                    dec.recorder.record_intra(
                        c_idx, xc, yc, sizec, mode_c, avail,
                        self._filter_kind(mode_c, sizec, c_idx))
                else:
                    pred = self._intra_pred(pl, xc, yc, sizec, mode_c,
                                            c_idx, avail)
                    pl[yc:yc + sizec, xc:xc + sizec] = np.clip(
                        pred, 0, dec.pmax)
            if cbf:
                self.residual(xc, yc, log2c, scan_c, c_idx)

    # ------------------------------------------------------------------
    def residual(self, x0, y0, log2, scan_idx, c_idx):
        """residual_coding() (spec 7.3.8.11 / hevc/cabac.c). In encode
        mode levels come from plan.levels(...) as a raster (n, n)
        array; in decode mode the block is dequantized, inverse
        transformed and added to the plane."""
        io = self.io
        dec = self.dec
        n = 1 << log2
        levels = None
        if io.encode:
            levels = np.asarray(
                self.plan.levels(x0, y0, log2, c_idx), np.int64)
            assert levels.any(), "coded block must have a coefficient"
        tskip = 0
        if dec.pps.transform_skip and log2 == 2:
            # transform_skip_flag, ctx inc = !!c_idx (cabac.c
            # hevc_transform_skip_flag_decode); Main profile caps the
            # skip block size at 4x4
            v = None
            if io.encode:
                v = 1 if self.plan.transform_skip(x0, y0, c_idx) else 0
            tskip = io.dec(
                self.ctx[_O["transform_skip_flag"] + (1 if c_idx
                                                      else 0)], v)

        # scan tables
        if scan_idx == SCAN_DIAG:
            sxo, syo = T.DIAG4_X, T.DIAG4_Y
            cg = {4: (T.DIAG2_X[:1], T.DIAG2_Y[:1]),
                  8: (T.DIAG2_X, T.DIAG2_Y),
                  16: (T.DIAG4_X, T.DIAG4_Y),
                  32: (T.DIAG8_X, T.DIAG8_Y)}[n]
            sxc, syc = cg
        elif scan_idx == SCAN_HORIZ:
            sxo, syo = T.HOR4_X, T.HOR4_Y
            sxc, syc = T.HOR2_X, T.HOR2_Y
        else:
            sxo, syo = T.HOR4_Y, T.HOR4_X
            sxc, syc = T.HOR2_Y, T.HOR2_X

        def scan_pos(k):
            ci, off = k >> 4, k & 15
            return ((sxc[ci] << 2) + sxo[off],
                    (syc[ci] << 2) + syo[off])

        if io.encode:
            # locate the last significant coefficient in scan order
            num_coeff = 0
            for k in range(n * n):
                xx, yy = scan_pos(k)
                if levels[yy, xx]:
                    num_coeff = k + 1
            last_k = num_coeff - 1
            last_x, last_y = scan_pos(last_k)
            ex, ey = (last_y, last_x) if scan_idx == SCAN_VERT \
                else (last_x, last_y)
            self._last_prefix_suffix(ex, ey, log2, c_idx)
        else:
            last_x, last_y = self._last_decode(log2, c_idx)
            if scan_idx == SCAN_VERT:
                last_x, last_y = last_y, last_x
        # (decode recomputes num_coeff from coords)
        x_cg_last, y_cg_last = None, None
        if not io.encode:
            x_cg_last, y_cg_last = last_x >> 2, last_y >> 2
            if scan_idx == SCAN_DIAG:
                inner = int(T.DIAG4_INV[last_y & 3, last_x & 3])
                cg_inv = {4: 0, 8: T.DIAG2_INV, 16: T.DIAG4_INV,
                          32: T.DIAG8_INV}[n]
                outer = 0 if n == 4 else int(cg_inv[y_cg_last,
                                                    x_cg_last])
            else:
                ex, ey = (last_y, last_x) if scan_idx == SCAN_VERT \
                    else (last_x, last_y)
                inner = (ey & 3) * 4 + (ex & 3)
                outer = (ey >> 2) * (n >> 2) + (ex >> 2)
            num_coeff = (outer << 4) + inner + 1
        else:
            x_cg_last, y_cg_last = last_x >> 2, last_y >> 2

        num_last_subset = (num_coeff - 1) >> 4
        ncg = n >> 2
        cg_flags = np.zeros((ncg, ncg), np.int32)
        out = np.zeros((n, n), np.int64)
        greater1_ctx = 1

        for i in range(num_last_subset, -1, -1):
            x_cg, y_cg = sxc[i], syc[i]
            implicit = 0
            if i < num_last_subset and i > 0:
                ctx_cg = 0
                if x_cg < ncg - 1:
                    ctx_cg += int(cg_flags[y_cg, x_cg + 1])
                if y_cg < ncg - 1:
                    ctx_cg += int(cg_flags[y_cg + 1, x_cg])
                inc = min(ctx_cg, 1) + (2 if c_idx else 0)
                v = None
                if io.encode:
                    v = 1 if levels[y_cg * 4:y_cg * 4 + 4,
                                    x_cg * 4:x_cg * 4 + 4].any() else 0
                f = io.dec(self.ctx[_O["sig_cg_flag"] + inc], v)
                cg_flags[y_cg, x_cg] = f
                implicit = 1
            else:
                cg_flags[y_cg, x_cg] = int(
                    (x_cg == x_cg_last and y_cg == y_cg_last) or
                    (x_cg == 0 and y_cg == 0))
            offset = i << 4
            last_scan_pos = num_coeff - offset - 1
            sig_idx = []
            if i == num_last_subset:
                sig_idx.append(last_scan_pos)
                n_end = last_scan_pos - 1
            else:
                n_end = 15
            prev_sig = 0
            if x_cg < ((n - 1) >> 2):
                prev_sig = int(cg_flags[y_cg, x_cg + 1] != 0)
            if y_cg < ((n - 1) >> 2):
                prev_sig += int(cg_flags[y_cg + 1, x_cg] != 0) << 1

            if cg_flags[y_cg, x_cg] and n_end >= 0:
                scf_offset = 27 if c_idx else 0
                if log2 == 2:
                    ctx_map = T.CTX_IDX_MAP[scan_idx][0:16]
                else:
                    ctx_map = T.CTX_IDX_MAP[scan_idx][
                        (prev_sig + 1) * 16:(prev_sig + 2) * 16]
                    if c_idx == 0:
                        if x_cg > 0 or y_cg > 0:
                            scf_offset += 3
                        scf_offset += (9 if scan_idx == SCAN_DIAG
                                       else 15) if log2 == 3 else 21
                    else:
                        scf_offset += 9 if log2 == 3 else 12
                nb0 = len(sig_idx)
                for k in range(n_end, 0, -1):
                    v = None
                    if io.encode:
                        xx, yy = scan_pos(offset + k)
                        v = 1 if levels[yy, xx] else 0
                    sig = io.dec(self.ctx[_O["sig_flag"] + ctx_map[k]
                                          + scf_offset], v)
                    if sig:
                        sig_idx.append(k)
                if len(sig_idx) != nb0:
                    implicit = 0
                if implicit == 0:
                    if i == 0:
                        scf0 = 27 if c_idx else 0
                    else:
                        scf0 = 2 + scf_offset
                    v = None
                    if io.encode:
                        xx, yy = scan_pos(offset)
                        v = 1 if levels[yy, xx] else 0
                    if io.dec(self.ctx[_O["sig_flag"] + scf0], v):
                        sig_idx.append(0)
                else:
                    sig_idx.append(0)

            n_sig = len(sig_idx)
            if not n_sig:
                continue
            # greater1 (first 8 in reverse scan order), greater2, signs,
            # remaining
            ctx_set = 2 if (i > 0 and c_idx == 0) else 0
            if i != num_last_subset and greater1_ctx == 0:
                ctx_set += 1
            greater1_ctx = 1
            g1 = []
            abs_lv = {}
            if io.encode:
                for k in sig_idx:
                    xx, yy = scan_pos(offset + k)
                    abs_lv[k] = int(abs(levels[yy, xx]))
            first_g1_idx = -1
            for m in range(min(8, n_sig)):
                inc = (ctx_set << 2) + greater1_ctx
                if c_idx:
                    inc += 16
                v = None
                if io.encode:
                    v = 1 if abs_lv[sig_idx[m]] > 1 else 0
                flag = io.dec(self.ctx[_O["greater1"] + inc], v)
                g1.append(flag)
                if flag and first_g1_idx == -1:
                    first_g1_idx = m
                if flag:
                    greater1_ctx = 0
                elif 1 <= greater1_ctx < 3:
                    greater1_ctx += 1
            if first_g1_idx != -1:
                inc = ctx_set + (4 if c_idx else 0)
                v = None
                if io.encode:
                    v = 1 if abs_lv[sig_idx[first_g1_idx]] > 2 else 0
                g1[first_g1_idx] += io.dec(
                    self.ctx[_O["greater2"] + inc], v)
            # sign bits precede the remaining levels; with sign data
            # hiding the lowest-scan-position sign is parity-inferred
            # (in encode mode the hidden sign simply follows the
            # parity of the crafted levels — the oracle comparison is
            # against the reference decoding the same bits)
            sign_hidden = dec.pps.sign_data_hiding and \
                (sig_idx[0] - sig_idx[-1] >= 4)
            n_signs = n_sig - 1 if sign_hidden else n_sig
            signs = []
            for m in range(n_signs):
                v = None
                if io.encode:
                    xx, yy = scan_pos(offset + sig_idx[m])
                    v = 1 if levels[yy, xx] < 0 else 0
                signs.append(io.byp(v))
            c_rice = 0
            sum_abs = 0
            for m in range(n_sig):
                k = sig_idx[m]
                xx, yy = scan_pos(offset + k)
                if m < 8:
                    base = 1 + g1[m]
                    needs_rem = base == (3 if m == first_g1_idx else 2)
                else:
                    base = 1
                    needs_rem = True
                lvl = base
                if needs_rem:
                    v = None
                    if io.encode:
                        v = abs_lv[k] - base
                    rem = self._abs_remaining(c_rice, v)
                    lvl = base + rem
                    if lvl > (3 << c_rice):
                        c_rice = min(c_rice + 1, 4)
                sum_abs += lvl
                if m < n_signs:
                    neg = signs[m]
                else:
                    neg = sum_abs & 1      # hidden sign
                out[yy, xx] = -lvl if neg else lvl

        if io.encode:
            return None
        # dequant + inverse transform + add. Dequant runs at
        # Qp' = Qp + QpBdOffset (6*(bd-8), spec 8.6.1); deblock keeps
        # the un-offset QpY.
        qpbd = 6 * (dec.bd - 8)
        if c_idx == 0:
            qp = dec.qp + qpbd
        else:
            off = (dec.pps.cb_qp_offset + dec.sh.cb_qp_offset) \
                if c_idx == 1 else \
                (dec.pps.cr_qp_offset + dec.sh.cr_qp_offset)
            qp = recon.chroma_qp(dec.qp, off, bd=dec.bd) + qpbd
        scale, shift, add = recon.dequant_factors(qp, log2, dec.bd)
        scale_m = 16
        if dec.sps.scaling_list_enabled and \
                not (tskip and log2 > 2):
            # custom dequant matrices (cabac.c: PPS list wins over
            # SPS; matrix by pred mode + component, DC separate)
            sl = dec.pps.scaling_list if dec.pps.scaling_list \
                is not None else dec.sps.scaling_list
            mid = (0 if self._cu_intra else 3) + c_idx
            scale_m = sl.matrix(log2, mid)
        coef = np.clip((out * scale * scale_m + add) >> shift,
                       -32768, 32767)
        if dec.recorder is not None:
            from . import recorder as R
            kind = R.K_TSKIP if tskip else (
                R.K_DST if (c_idx == 0 and log2 == 2 and self._cu_intra)
                else R.K_IDCT)
            dec.recorder.record_tu(c_idx, x0, y0, n, coef, kind)
            return
        if tskip:
            # bypass transform (dsp_template.c dequant): shift
            # 15-bd-log2, always > 0 for 4x4 at Main depths
            tshift = 15 - dec.bd - log2
            res = (coef + (1 << (tshift - 1))) >> tshift
        elif c_idx == 0 and log2 == 2 and self._cu_intra:
            res = recon.idst4(coef, dec.bd)  # DST-VII: intra luma 4x4
        else:
            res = recon.idct(coef, dec.bd)
        pl = (dec.y, dec.u, dec.v)[c_idx]
        blk = pl[y0:y0 + n, x0:x0 + n].astype(np.int64)
        pl[y0:y0 + n, x0:x0 + n] = np.clip(blk + res, 0, dec.pmax)

    # ------------------------------------------------------------------
    def _last_prefix_suffix(self, lx, ly, log2, c_idx):
        # bin order: x prefix, y prefix, THEN x suffix, y suffix
        prefixes = []
        for val in (lx, ly):
            prefix = val
            if val > 3:
                # prefix p >= 4: val in [base(p), base(p+1)) with
                # base(p) = (1 << ((p >> 1) - 1)) * (2 + (p & 1))
                p = 4
                while (1 << ((p + 1 >> 1) - 1)) * (2 + (p + 1 & 1)) \
                        <= val:
                    p += 1
                prefix = p
            prefixes.append(prefix)
        for comp, prefix in enumerate(prefixes):
            self._last_prefix_code(comp, prefix, log2, c_idx)
        for val, prefix in zip((lx, ly), prefixes):
            if prefix > 3:
                length = (prefix >> 1) - 1
                base = (1 << ((prefix >> 1) - 1)) * (2 + (prefix & 1))
                suffix = val - base
                for k in range(length - 1, -1, -1):
                    self.io.byp((suffix >> k) & 1)

    def _last_prefix_code(self, comp, prefix, log2, c_idx):
        mx = (log2 << 1) - 1
        off, sh = self._last_ctx(log2, c_idx)
        base = _O["last_sig_x_prefix" if comp == 0 else
                  "last_sig_y_prefix"]
        i = 0
        while i < mx:
            bit = 1 if i < prefix else 0
            self.io.dec(self.ctx[base + (i >> sh) + off], bit)
            if not bit:
                break
            i += 1

    @staticmethod
    def _last_ctx(log2, c_idx):
        if c_idx == 0:
            return 3 * (log2 - 2) + ((log2 - 1) >> 2), (log2 + 1) >> 2
        return 15, log2 - 2

    def _last_decode(self, log2, c_idx):
        """→ (last_x, last_y): both prefixes, then both suffixes."""
        mx = (log2 << 1) - 1
        off, sh = self._last_ctx(log2, c_idx)
        prefixes = []
        for comp in range(2):
            base = _O["last_sig_x_prefix" if comp == 0 else
                      "last_sig_y_prefix"]
            i = 0
            while i < mx and \
                    self.io.dec(self.ctx[base + (i >> sh) + off]):
                i += 1
            prefixes.append(i)
        vals = []
        for prefix in prefixes:
            if prefix > 3:
                length = (prefix >> 1) - 1
                suffix = 0
                for _ in range(length):
                    suffix = (suffix << 1) | self.io.byp()
                vals.append((1 << ((prefix >> 1) - 1))
                            * (2 + (prefix & 1)) + suffix)
            else:
                vals.append(prefix)
        return vals[0], vals[1]

    def _abs_remaining(self, rice, v=None):
        """coeff_abs_level_remaining: Golomb-Rice with exp-Golomb
        escape (spec 9.3.3.13)."""
        io = self.io
        if io.encode:
            if v < (3 << rice):
                prefix = v >> rice
                for _ in range(prefix):
                    io.byp(1)
                io.byp(0)
                for k in range(rice - 1, -1, -1):
                    io.byp((v >> k) & 1)
                return v
            # escape: prefix = 3 + e where base(e) = ((1<<e)+2) << rice
            e = 0
            while (((1 << (e + 1)) + 2) << rice) <= v:
                e += 1
            base = ((1 << e) + 2) << rice
            for _ in range(3 + e):
                io.byp(1)
            io.byp(0)
            suffix = v - base
            for k in range(e + rice - 1, -1, -1):
                io.byp((suffix >> k) & 1)
            return v
        prefix = 0
        while prefix < 32 and io.byp():
            prefix += 1
        if prefix < 3:
            suffix = 0
            for _ in range(rice):
                suffix = (suffix << 1) | io.byp()
            return (prefix << rice) + suffix
        k = prefix - 3 + rice
        suffix = 0
        for _ in range(k):
            suffix = (suffix << 1) | io.byp()
        return ((((1 << (prefix - 3)) + 3 - 1) << rice)) + suffix
