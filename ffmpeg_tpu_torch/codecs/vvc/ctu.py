"""VVC coding-tree walk + intra reconstruction for the minimal
toolset (ITU-T H.266 7.3.11/8.4/8.7; reference vvc/ctu.c:2930,
vvc/cabac.c residual coding, vvc/intra_template.c).

Quadtree-only partitioning (MTT depth 0), single tree, I slices,
DCT-2 transforms (identical matrices to HEVC for sizes <= 32 —
reuses hevc/tables + hevc/recon clip discipline), 67-mode intra with
PDPC and 4-tap fC/fG interpolation. The walker runs both directions
through the _IO shim: decode with VvcCabacDecoder, encode (crafting
conformant streams) with VvcCabacEncoder + a Plan of intents.

The port's copy of ffmpeg_tpu/codecs/vvc/ctu.py, held equal to it by
tests/test_torch_vvc.py.
"""

from __future__ import annotations

import numpy as np

from ...utils.error import InvalidData, NotSupported
from ..hevc import tables as HT
from . import inter as I
from .cabac import init_contexts
from .tables import CTX

INTRA_PLANAR, INTRA_DC = 0, 1
INTRA_HORZ, INTRA_DIAG, INTRA_VERT, INTRA_VDIAG = 18, 34, 50, 66

# VVCSplitMode order (vvc/ctu.h); mtt_split_modes indexed by
# (vertical_flag << 1) | binary_flag (cabac.c:1226)
(SPLIT_NONE, SPLIT_TT_HOR, SPLIT_BT_HOR, SPLIT_TT_VER, SPLIT_BT_VER,
 SPLIT_QT) = range(6)
_MTT_SPLIT_MODES = (SPLIT_TT_HOR, SPLIT_BT_HOR, SPLIT_TT_VER,
                    SPLIT_BT_VER)
_SPLIT_BY_NAME = {"none": SPLIT_NONE, "qt": SPLIT_QT,
                  "btv": SPLIT_BT_VER, "bth": SPLIT_BT_HOR,
                  "ttv": SPLIT_TT_VER, "tth": SPLIT_TT_HOR}


def wide_angle_map(mode, w, h):
    """ff_vvc_wide_angle_mode_mapping (intra_utils.c:197), no-ISP
    path: remap angular modes of rectangular blocks into the wide
    ranges (-14..-1 / 67..80)."""
    if w == h:
        return mode
    ratio = abs(w.bit_length() - h.bit_length())
    mx = 8 + 2 * ratio if ratio > 1 else 8
    mn = 60 - 2 * ratio if ratio > 1 else 60
    if w > h and 2 <= mode < mx:
        return mode + 65
    if h > w and mn < mode <= 66:
        return mode - 67
    return mode

# Table 25: 4-tap intra interpolation filters; type 0 = fC, 1 = fG
_FC = np.array([
    [0, 64, 0, 0], [-1, 63, 2, 0], [-2, 62, 4, 0], [-2, 60, 7, -1],
    [-2, 58, 10, -2], [-3, 57, 12, -2], [-4, 56, 14, -2],
    [-4, 55, 15, -2], [-4, 54, 16, -2], [-5, 53, 18, -2],
    [-6, 52, 20, -2], [-6, 49, 24, -3], [-6, 46, 28, -4],
    [-5, 44, 29, -4], [-4, 42, 30, -4], [-4, 39, 33, -4],
    [-4, 36, 36, -4], [-4, 33, 39, -4], [-4, 30, 42, -4],
    [-4, 29, 44, -5], [-4, 28, 46, -6], [-3, 24, 49, -6],
    [-2, 20, 52, -6], [-2, 18, 53, -5], [-2, 16, 54, -4],
    [-2, 15, 55, -4], [-2, 14, 56, -4], [-2, 12, 57, -3],
    [-2, 10, 58, -2], [-1, 7, 60, -2], [0, 4, 62, -2],
    [0, 2, 63, -1]], np.int32)
_FG = np.array([[16 - (p >> 1), 32 - (p >> 1), 16 + (p >> 1), p >> 1]
                for p in range(32)], np.int32)
_LUMA_FILTER = (_FC, _FG)

_ANGLES = [0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20, 23, 26, 29,
           32, 35, 39, 45, 51, 57, 64, 73, 86, 102, 128, 171, 256,
           341, 512]
_REF_FILTER_MODES = {-14, -12, -10, -6, INTRA_PLANAR, 2, 34, 66, 72,
                     76, 78, 80}
_LEVEL_SCALE = [40, 45, 51, 57, 64, 72]
_LEVEL_SCALE_RECT = [57, 64, 72, 80, 90, 102]


def pred_angle(mode):
    """ff_vvc_intra_pred_angle_derive (intra_utils.c:165)."""
    if mode > INTRA_DIAG:
        idx = mode - INTRA_VERT
    elif mode > 0:
        idx = INTRA_HORZ - mode
    else:
        idx = INTRA_HORZ - 2 - mode
    sign = 1
    if idx < 0:
        idx, sign = -idx, -1
    return sign * _ANGLES[idx]


def inv_angle(angle):
    a = abs(angle)
    v = (32 * 512 + a // 2) // a
    return v if angle > 0 else -v


def diag_scan(log2w, log2h):
    """Up-right diagonal scan (6.5.2): diagonals ascending, x
    ascending within each."""
    w, h = 1 << log2w, 1 << log2h
    xs, ys = [], []
    for d in range(w + h - 1):
        for x in range(max(0, d - h + 1), min(d, w - 1) + 1):
            xs.append(x)
            ys.append(d - x)
    return xs, ys


_SCANS = {}


def get_scan(log2w, log2h):
    key = (log2w, log2h)
    if key not in _SCANS:
        _SCANS[key] = diag_scan(log2w, log2h)
    return _SCANS[key]


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


class FrameDec:
    """Per-picture state (FrameContext analog). For inter slices,
    `rpl_poc[lx]` lists the reference POCs of list lx and
    `rpl_frames[lx][ref_idx]` the matching (y, u, v) planes (decode
    direction only — crafting needs just the POCs)."""

    def __init__(self, sps, pps, sh, rpl_poc=((), ()),
                 rpl_frames=((), ())):
        self.sps, self.pps, self.sh = sps, pps, sh
        W, H = sps.width, sps.height
        self.bd = sps.bit_depth
        self.pmax = (1 << self.bd) - 1
        dt = np.uint8 if self.bd == 8 else np.uint16
        self.y = np.zeros((H, W), dt)
        self.u = np.zeros((H // 2, W // 2), dt)
        self.v = np.zeros((H // 2, W // 2), dt)
        n4x, n4y = (W + 3) // 4, (H + 3) // 4
        self.ipm = np.zeros((n4y, n4x), np.int32)      # PLANAR default
        self.cbw4 = np.zeros((n4y, n4x), np.int32)     # CB width map
        self.cbh4 = np.zeros((n4y, n4x), np.int32)
        self.qtd4 = np.zeros((n4y, n4x), np.int32)     # cqt depth map
        self.decoded = np.zeros((n4y, n4x), bool)      # luma recon'd
        self.qp = sh.qp
        # per-4x4 motion state (tab.mvf/skip analogs, mvs.c:256)
        self.skip4 = np.zeros((n4y, n4x), np.uint8)
        self.mvf_pf = np.zeros((n4y, n4x), np.uint8)   # PF_INTRA
        self.mvf_mv = np.zeros((n4y, n4x, 2, 2), np.int32)
        self.mvf_ref = np.zeros((n4y, n4x, 2), np.int8)
        self.rpl_poc = rpl_poc
        self.rpl_frames = rpl_frames


class Plan:
    """Encode-direction intents (override in tests)."""

    def __init__(self, rng, split_p=0.5, cbf_p=0.7, maxn=4, amp=5,
                 mode_pool=None):
        self.rng = rng
        self.split_p = split_p
        self.cbf_p = cbf_p
        self.maxn = maxn
        self.amp = amp
        self.mode_pool = mode_pool or list(range(67))

    def split(self, x0, y0, log2):
        return self.rng.random() < self.split_p

    def split_mode(self, x0, y0, log2w, log2h, allowed, forced):
        """Pick one of 'none','qt','btv','bth','ttv','tth' from
        `allowed`. Default keeps the legacy QT-only behaviour via
        split(); MTT plans override. When `forced` (border implicit
        split) 'none' is not in `allowed`."""
        if forced:
            return "qt" if "qt" in allowed else allowed[0]
        if "qt" in allowed and log2w == log2h \
                and self.split(x0, y0, log2w):
            return "qt"
        return "none"

    def luma_mode(self, x0, y0, log2):
        return int(self.rng.choice(self.mode_pool))

    def chroma_mode(self, x0, y0, log2):
        return int(self.rng.integers(0, 5))

    def cbf(self, x0, y0, log2, c_idx):
        return self.rng.random() < self.cbf_p

    def levels(self, x0, y0, log2w, log2h, c_idx):
        n_w, n_h = 1 << log2w, 1 << log2h
        lv = np.zeros((n_h, n_w), np.int64)
        k = int(self.rng.integers(1, self.maxn + 1))
        for _ in range(k):
            yy = int(self.rng.integers(0, n_h))
            xx = int(self.rng.integers(0, n_w))
            lv[yy, xx] = int(self.rng.integers(-self.amp,
                                               self.amp + 1)) or 1
        return lv

    # ---- inter-slice intents (queried ONCE per CU by the walker) ----
    def cu_mode(self, x0, y0, log2w, log2h):
        """'intra' | 'skip' | 'merge' | 'amvp' for CUs of P/B
        slices."""
        return "intra"

    def merge_index(self, x0, y0, max_cand):
        return 0

    def amvp_choice(self, x0, y0, is_b, w, h, nact):
        """→ dict(pred='l0'|'l1'|'bi', ref_idx=[i0,i1],
        mvd=[(x,y),(x,y)], mvp=[f0,f1]); 'bi'/'l1' only for B,
        ref_idx[lx] < nact[lx]."""
        return {"pred": "l0", "ref_idx": [0, 0],
                "mvd": [(0, 0), (0, 0)], "mvp": [0, 0]}

    def cu_coded(self, x0, y0):
        """cu_coded_flag for AMVP CUs."""
        return True


class CtuCoder:
    def __init__(self, dec: FrameDec, core, encode=False, plan=None,
                 defer_recon=False):
        self.dec = dec
        self.io = _IO(core, encode)
        self.plan = plan
        self.defer_recon = defer_recon
        self.recon_q = []            # (ctu, cu-args...) when deferred
        self.cur_ctu = (0, 0)
        self.hmvp = []               # HMVP FIFO (ep->hmvp)
        # init_type = 2 - slice_type; I slices (type 2) -> 0
        self.ctx = init_contexts(2 - dec.sh.slice_type,
                                 max(0, min(63, dec.qp)))

    # ------------------------------------------------------------- walk
    def code_slice_data(self):
        dec = self.dec
        sps = dec.sps
        for ry in range(sps.ctb_height):
            self.hmvp = []           # reset per CTU row (ctu.c:2821)
            for rx in range(sps.ctb_width):
                self.cur_ctu = (rx, ry)
                self.coding_tree(rx << sps.log2_ctu,
                                 ry << sps.log2_ctu,
                                 sps.log2_ctu, sps.log2_ctu)
        if self.io.term(1) != 1:
            raise InvalidData("vvc: missing end_of_slice_one_bit")

    def run_deferred_recon(self, executor):
        """Per-CTU reconstruction on the P4 task-graph executor with
        wavefront dependencies — CTU (rx,ry) runs once (rx-1,ry),
        (rx,ry-1) and (rx+1,ry-1) are done, the same dependency shape
        the reference drives through AVExecutor (vvc/thread.c:528
        task_stage_done / intra refs extend one CTU to the top-right).
        Parse stays sequential; availability was snapshotted there."""
        import threading as _th

        from ...parallel.executor import Task

        by_ctu = {}
        for item in self.recon_q:
            by_ctu.setdefault(item[0], []).append(item[1:])
        ctbw = self.dec.sps.ctb_width
        done = set()
        lock = _th.Lock()

        def _deps_ok(rx, ry):
            for nx, ny in ((rx - 1, ry), (rx, ry - 1),
                           (rx + 1, ry - 1)):
                if 0 <= nx < ctbw and ny >= 0 \
                        and (nx, ny) not in done:
                    return False
            return True

        for (rx, ry) in sorted(by_ctu, key=lambda c: (c[1], c[0])):
            cus = by_ctu[(rx, ry)]

            def _run(rx=rx, ry=ry, cus=cus):
                for rec in cus:
                    if rec[0] == "i":
                        (_, x0, y0, log2w, log2h, lm, cm, cy, cb,
                         cr, sy, sc) = rec
                        self._reconstruct(x0, y0, log2w, log2h, lm,
                                          cm, cy, cb, cr, sy, sc)
                    else:
                        (_, x0, y0, log2w, log2h, mvf, cy, cb,
                         cr) = rec
                        self._recon_inter(x0, y0, log2w, log2h, mvf,
                                          cy, cb, cr)
                with lock:
                    done.add((rx, ry))

            def _ready(rx=rx, ry=ry):
                with lock:
                    return _deps_ok(rx, ry)

            executor.submit(Task(_run, priority=ry * ctbw + rx,
                                 ready=_ready))
        executor.wait()
        self.recon_q = []

    def coding_tree(self, x0, y0, log2w, log2h, cqt_depth=0,
                    mtt_depth=0, depth_offset=0, part_idx=0,
                    last_split=SPLIT_NONE):
        """hls_coding_tree (ctu.c:2443) with the five split
        recursions (coding_tree_qt/btv/bth/ttv/tth, ctu.c:2283)."""
        dec = self.dec
        sps = dec.sps
        W, H = sps.width, sps.height
        w, h = 1 << log2w, 1 << log2h
        a = self._can_split(x0, y0, w, h, mtt_depth, depth_offset,
                            part_idx, last_split)
        split = self._split_syntax(x0, y0, log2w, log2h, cqt_depth,
                                   mtt_depth, a)
        if split == SPLIT_NONE:
            self.coding_unit(x0, y0, log2w, log2h, cqt_depth)
            return
        self._check_mode_type(split, w, h)
        if split == SPLIT_QT:
            half = w >> 1
            for dx, dy in ((0, 0), (half, 0), (0, half), (half, half)):
                if x0 + dx < W and y0 + dy < H:
                    self.coding_tree(x0 + dx, y0 + dy, log2w - 1,
                                     log2h - 1, cqt_depth + 1, 0, 0,
                                     0, SPLIT_QT)
        elif split == SPLIT_BT_VER:
            off = depth_offset + (1 if x0 + w > W else 0)
            x1 = x0 + (w >> 1)
            self.coding_tree(x0, y0, log2w - 1, log2h, cqt_depth,
                             mtt_depth + 1, off, 0, split)
            if x1 < W:
                self.coding_tree(x1, y0, log2w - 1, log2h, cqt_depth,
                                 mtt_depth + 1, off, 1, split)
        elif split == SPLIT_BT_HOR:
            off = depth_offset + (1 if y0 + h > H else 0)
            y1 = y0 + (h >> 1)
            self.coding_tree(x0, y0, log2w, log2h - 1, cqt_depth,
                             mtt_depth + 1, off, 0, split)
            if y1 < H:
                self.coding_tree(x0, y1, log2w, log2h - 1, cqt_depth,
                                 mtt_depth + 1, off, 1, split)
        elif split == SPLIT_TT_VER:
            q = w >> 2
            for i, (dx, lg) in enumerate(((0, log2w - 2),
                                          (q, log2w - 1),
                                          (3 * q, log2w - 2))):
                self.coding_tree(x0 + dx, y0, lg, log2h, cqt_depth,
                                 mtt_depth + 1, depth_offset, i,
                                 split)
        else:                                  # SPLIT_TT_HOR
            q = h >> 2
            for i, (dy, lg) in enumerate(((0, log2h - 2),
                                          (q, log2h - 1),
                                          (3 * q, log2h - 2))):
                self.coding_tree(x0, y0 + dy, log2w, lg, cqt_depth,
                                 mtt_depth + 1, depth_offset, i,
                                 split)

    def _check_mode_type(self, split, w, h):
        """derive_mode_type_condition (ctu.c:2239). In 4:2:0
        single-tree slices, splits that would create sub-4-wide
        chroma trigger a LOCAL DUAL TREE (MODE_TYPE_INTRA + a chroma
        re-walk) that this decoder does not implement; crafted
        streams avoid these splits by construction (min CB 8)."""
        area = w * h
        cond = (area == 64 and split in (SPLIT_QT, SPLIT_TT_HOR,
                                         SPLIT_TT_VER)) or \
               (area == 32 and split in (SPLIT_BT_HOR,
                                         SPLIT_BT_VER)) or \
               (area == 64 and split in (SPLIT_BT_HOR,
                                         SPLIT_BT_VER)) or \
               (area == 128 and split in (SPLIT_TT_HOR,
                                          SPLIT_TT_VER)) or \
               (w == 8 and split == SPLIT_BT_VER) or \
               (w == 16 and split == SPLIT_TT_VER)
        if cond:
            raise NotSupported(
                "vvc: local dual tree (small-chroma split)")

    def _can_split(self, x0, y0, w, h, mtt_depth, depth_offset,
                   part_idx, last_split):
        """6.4.1-6.4.3 allowed split processes (ctu.c:526 can_split),
        single tree, MODE_TYPE_ALL."""
        dec = self.dec
        sps = dec.sps
        W, H = sps.width, sps.height
        intra = dec.sh.slice_type == 2
        min_cb = 1 << sps.log2_min_cb
        min_qt = 1 << (sps.log2_min_qt_intra if intra
                       else sps.log2_min_qt_inter)
        max_bt = 1 << (sps.log2_max_bt_intra if intra
                       else sps.log2_max_bt_inter)
        max_tt = 1 << (sps.log2_max_tt_intra if intra
                       else sps.log2_max_tt_inter)
        max_mtt = (sps.max_mtt_depth_intra if intra
                   else sps.max_mtt_depth_inter) + depth_offset
        qt = 0 if mtt_depth else 1
        btv = bth = ttv = tth = 1
        if w <= min_qt:
            qt = 0
        if w <= 2 * min_cb:
            ttv = 0
            if w <= min_cb:
                btv = 0
        if h <= 2 * min_cb:
            tth = 0
            if h <= min_cb:
                bth = 0
        if w > max_bt or h > max_bt:
            btv = bth = 0
        max_tt = min(64, max_tt)
        if w > max_tt or h > max_tt:
            ttv = tth = 0
        if mtt_depth >= max_mtt:
            btv = bth = ttv = tth = 0
        if x0 + w > W:
            ttv = tth = 0
            if h > 64:
                btv = 0
            if y0 + h <= H:
                bth = 0
            elif w > min_qt:
                btv = bth = 0
        if y0 + h > H:
            btv = ttv = tth = 0
            if w > 64:
                bth = 0
        if mtt_depth > 0 and part_idx == 1:
            if last_split == SPLIT_TT_VER:
                btv = 0
            elif last_split == SPLIT_TT_HOR:
                bth = 0
        if w <= 64 and h > 64:
            btv = 0
        if w > 64 and h <= 64:
            bth = 0
        return {"qt": qt, "btv": btv, "bth": bth, "ttv": ttv,
                "tth": tth}

    def _split_syntax(self, x0, y0, log2w, log2h, cqt_depth,
                      mtt_depth, a):
        """split_cu_flag + split_qt_flag + mtt vertical/binary flags
        with their context derivations and inference rules
        (cabac.c:1118-1240 ff_vvc_split_cu_flag/ff_vvc_split_mode)."""
        dec, io = self.dec, self.io
        sps = dec.sps
        w, h = 1 << log2w, 1 << log2h
        inside = (x0 + w <= sps.width) and (y0 + h <= sps.height)
        any_mtt = a["btv"] or a["bth"] or a["ttv"] or a["tth"]
        any_split = any_mtt or a["qt"]
        want = None
        if io.encode:
            allowed = [k for k in ("qt", "btv", "bth", "ttv", "tth")
                       if a[k]]
            if not inside:
                want = self.plan.split_mode(x0, y0, log2w, log2h,
                                            allowed, True)
            elif any_split:
                want = self.plan.split_mode(x0, y0, log2w, log2h,
                                            ["none"] + allowed, False)
            else:
                want = "none"
            if want != "none" and not a[want]:
                raise ValueError(f"vvc craft: split {want} not "
                                 f"allowed at {x0},{y0} {w}x{h}")
        x4, y4 = x0 >> 2, y0 >> 2
        if any_split and inside:
            inc = 0
            if x0 > 0:
                inc += int(dec.cbh4[y4, x4 - 1] < h)
            if y0 > 0:
                inc += int(dec.cbw4[y4 - 1, x4] < w)
            inc += (a["btv"] + a["bth"] + a["ttv"] + a["tth"]
                    + 2 * a["qt"] - 1) // 2 * 3
            v = None if want is None else int(want != "none")
            if not io.dec(self.ctx[CTX["SPLIT_CU_FLAG"] + inc], v):
                return SPLIT_NONE
        elif inside:
            return SPLIT_NONE       # no split possible
        # split mode (ff_vvc_split_mode)
        if any_mtt and a["qt"]:
            inc = 0
            if x0 > 0:
                inc += int(dec.qtd4[y4, x4 - 1] > cqt_depth)
            if y0 > 0:
                inc += int(dec.qtd4[y4 - 1, x4] > cqt_depth)
            inc += 3 if cqt_depth >= 2 else 0
            v = None if want is None else int(want == "qt")
            split_qt = io.dec(self.ctx[CTX["SPLIT_QT_FLAG"] + inc], v)
        else:
            split_qt = (not any_mtt) or a["qt"]
        if split_qt:
            return SPLIT_QT
        # mtt_split_cu_vertical_flag (cabac.c:1155)
        if (a["bth"] or a["tth"]) and (a["btv"] or a["ttv"]):
            nv = a["btv"] + a["ttv"]
            nh = a["bth"] + a["tth"]
            if nv > nh:
                inc = 4
            elif nv < nh:
                inc = 3
            else:
                avail_a, avail_l = y0 > 0, x0 > 0
                da = w // (dec.cbw4[y4 - 1, x4] if avail_a else 1)
                dl = h // (dec.cbh4[y4, x4 - 1] if avail_l else 1)
                if da == dl or not avail_a or not avail_l:
                    inc = 0
                elif da < dl:
                    inc = 1
                else:
                    inc = 2
            v = None if want is None else int(want in ("btv", "ttv"))
            vert = io.dec(
                self.ctx[CTX["MTT_SPLIT_CU_VERTICAL_FLAG"] + inc], v)
        else:
            vert = int(not (a["bth"] or a["tth"]))
        # mtt_split_cu_binary_flag (cabac.c:1189)
        if (a["btv"] and a["ttv"] and vert) or \
                (a["bth"] and a["tth"] and not vert):
            inc = 2 * vert + (1 if mtt_depth <= 1 else 0)
            v = None if want is None else int(want in ("btv", "bth"))
            binary = io.dec(
                self.ctx[CTX["MTT_SPLIT_CU_BINARY_FLAG"] + inc], v)
        else:
            if not a["btv"] and not a["bth"]:
                binary = 0
            elif not a["ttv"] and not a["tth"]:
                binary = 1
            elif a["bth"] and a["ttv"]:
                binary = 1 - vert
            else:
                binary = vert
        return _MTT_SPLIT_MODES[(vert << 1) | binary]

    # -------------------------------------------------------------- CU
    def coding_unit(self, x0, y0, log2w, log2h, cqt_depth=0):
        """hls_coding_unit (ctu.c:2179): pred mode, intra or inter
        data, cu_coded_flag, one transform unit."""
        dec, io = self.dec, self.io
        w, h = 1 << log2w, 1 << log2h
        n4w, n4h = w >> 2, h >> 2
        x4, y4 = x0 >> 2, y0 >> 2
        inter_slice = dec.sh.slice_type != 2
        want = None
        if io.encode and inter_slice:
            want = self.plan.cu_mode(x0, y0, log2w, log2h)
        skip = 0
        mode_intra = True
        if inter_slice:
            # cu_skip_flag (cabac.c:1276); 4x4 CUs can't be inter
            if w != 4 or h != 4:
                inc = 0
                if x0 > 0:
                    inc += int(dec.skip4[y4, x4 - 1])
                if y0 > 0:
                    inc += int(dec.skip4[y4 - 1, x4])
                v = None if want is None else int(want == "skip")
                skip = io.dec(self.ctx[CTX["CU_SKIP_FLAG"] + inc], v)
            if skip:
                mode_intra = False
            elif w != 4 or h != 4:
                # pred_mode_flag (cabac.c:1240)
                inc = int(
                    (x0 > 0 and dec.mvf_pf[y4, x4 - 1] == I.PF_INTRA)
                    or (y0 > 0
                        and dec.mvf_pf[y4 - 1, x4] == I.PF_INTRA))
                v = None if want is None else int(want == "intra")
                mode_intra = bool(io.dec(
                    self.ctx[CTX["PRED_MODE_FLAG"] + inc], v))
        dec.cbw4[y4:y4 + n4h, x4:x4 + n4w] = w
        dec.cbh4[y4:y4 + n4h, x4:x4 + n4w] = h
        dec.qtd4[y4:y4 + n4h, x4:x4 + n4w] = cqt_depth

        mvf = merge = None
        if mode_intra:
            luma_mode = self._luma_intra_mode(x0, y0, w, h)
            dec.ipm[y4:y4 + n4h, x4:x4 + n4w] = luma_mode
            chroma_mode = self._chroma_intra_mode(x0, y0, luma_mode)
            I.set_intra_mvf(dec, x0, y0, w, h)
        else:
            luma_mode = chroma_mode = None
            mvf, merge = self._inter_data(x0, y0, w, h, skip, want)
        dec.skip4[y4:y4 + n4h, x4:x4 + n4w] = skip

        # cu_coded_flag (ctu.c:2210): explicit for non-merge inter
        if mode_intra:
            coded = True
        elif not merge:
            v = None if want is None else int(self.plan.cu_coded(x0,
                                                                 y0))
            coded = bool(io.dec(self.ctx[CTX["CU_CODED_FLAG"]], v))
        else:
            coded = not skip

        coeff_y = coeff_cb = coeff_cr = None
        if coded:
            # transform_unit: chroma cbfs, then Y (present for intra
            # or when chroma is coded, else inferred 1 — ctu.c:273)
            pv = None
            if io.encode:
                pv = 1 if self.plan.cbf(x0, y0, log2w, 1) else 0
            cbf_cb = io.dec(self.ctx[CTX["TU_CB_CODED_FLAG"]], pv)
            if io.encode:
                pv = 1 if self.plan.cbf(x0, y0, log2w, 2) else 0
            cbf_cr = io.dec(self.ctx[CTX["TU_CR_CODED_FLAG"]
                                     + cbf_cb], pv)
            if mode_intra or cbf_cb or cbf_cr:
                if io.encode:
                    pv = 1 if self.plan.cbf(x0, y0, log2w, 0) else 0
                cbf_y = io.dec(self.ctx[CTX["TU_Y_CODED_FLAG"]], pv)
            else:
                cbf_y = 1
            coeff_y = self.residual(x0, y0, log2w, log2h, 0) \
                if cbf_y else None
            coeff_cb = self.residual(x0, y0, log2w - 1, log2h - 1, 1) \
                if cbf_cb else None
            coeff_cr = self.residual(x0, y0, log2w - 1, log2h - 1, 2) \
                if cbf_cr else None

        if not io.encode:
            if mode_intra:
                if self.defer_recon:
                    # snapshot neighbour availability at parse time so
                    # reconstruction can run out of raster order on
                    # the executor (the reference records the same
                    # per-CU state before handing CTUs to AVExecutor);
                    # sizes use the wide-angle-mapped mode (edge
                    # extents depend on it, intra_template.c:492)
                    snap_y = self._avail_snap(
                        x0, y0, w, h,
                        wide_angle_map(luma_mode, w, h), 0)
                    snap_c = self._avail_snap(
                        x0 >> 1, y0 >> 1, w >> 1, h >> 1,
                        wide_angle_map(chroma_mode, w >> 1, h >> 1),
                        1)
                    self.recon_q.append(
                        (self.cur_ctu, "i", x0, y0, log2w, log2h,
                         luma_mode, chroma_mode, coeff_y, coeff_cb,
                         coeff_cr, snap_y, snap_c))
                else:
                    self._reconstruct(x0, y0, log2w, log2h,
                                      luma_mode, chroma_mode,
                                      coeff_y, coeff_cb, coeff_cr)
            else:
                if self.defer_recon:
                    self.recon_q.append(
                        (self.cur_ctu, "p", x0, y0, log2w, log2h,
                         mvf, coeff_y, coeff_cb, coeff_cr))
                else:
                    self._recon_inter(x0, y0, log2w, log2h, mvf,
                                      coeff_y, coeff_cb, coeff_cr)
        dec.decoded[y4:y4 + n4h, x4:x4 + n4w] = True

    # ------------------------------------------------- inter CU syntax
    def _inter_data(self, x0, y0, w, h, skip, want):
        """inter_data (ctu.c:1795): merge flag, merge or AMVP data,
        mvf storage + HMVP update. Returns (mvf, general_merge)."""
        dec, io = self.dec, self.io
        sps = dec.sps
        is_b = dec.sh.slice_type == 0
        merge = 1
        if not skip:
            v = None if want is None else int(want == "merge")
            merge = io.dec(self.ctx[CTX["GENERAL_MERGE_FLAG"]], v)
        if merge:
            midx = 0
            if sps.max_num_merge_cand > 1:
                tv = self.plan.merge_index(
                    x0, y0, sps.max_num_merge_cand) if io.encode \
                    else None
                midx = self._tr_ctx_bypass(
                    CTX["MERGE_IDX"], sps.max_num_merge_cand - 1, tv)
            mvf = I.merge_mode(dec, self.hmvp, x0, y0, w, h, midx,
                               is_b, dec.sh.num_ref_idx_active)
            if mvf.pred_flag == I.PF_BI and w + h == 12:
                mvf.pred_flag = I.PF_L0       # ctu.c:1340
        else:
            mvf = self._mvp_data(x0, y0, w, h, is_b)
        I.set_mvf(dec, x0, y0, w, h, mvf)
        I.update_hmvp(self.hmvp, dec, x0, y0, w, h,
                      sps.log2_parallel_merge_level)
        return mvf, merge

    def _mvp_data(self, x0, y0, w, h, is_b):
        """mvp_data (ctu.c:1654) for the translation-only toolset."""
        dec, io = self.dec, self.io
        ch = self.plan.amvp_choice(x0, y0, is_b, w, h,
                                   dec.sh.num_ref_idx_active) \
            if io.encode else None
        if is_b:
            bi = 0
            if w + h > 12:
                log2 = (w.bit_length() - 1) + (h.bit_length() - 1)
                inc = 7 - ((1 + log2) >> 1)
                v = None if ch is None else int(ch["pred"] == "bi")
                bi = io.dec(self.ctx[CTX["INTER_PRED_IDC"] + inc], v)
            if bi:
                pred_flag = I.PF_BI
            else:
                v = None if ch is None else int(ch["pred"] == "l1")
                pred_flag = I.PF_L0 + io.dec(
                    self.ctx[CTX["INTER_PRED_IDC"] + 5], v)
        else:
            pred_flag = I.PF_L0
        ref_idx = [0, 0]
        mvd = [[0, 0], [0, 0]]
        mvp_flag = [0, 0]
        nact = dec.sh.num_ref_idx_active
        for lx in range(2):
            if pred_flag == I.PF_L0 + (1 - lx):   # list unused
                continue
            if nact[lx] > 1:
                tv = None if ch is None else int(ch["ref_idx"][lx])
                ref_idx[lx] = self._ref_idx_lx(nact[lx], tv)
            if lx == 1 and dec.sh.mvd_l1_zero and \
                    pred_flag == I.PF_BI:
                mvd[1] = [0, 0]
            else:
                tv = None if ch is None else ch["mvd"][lx]
                mvd[lx] = self._mvd_coding(tv)
            tv = None if ch is None else int(ch["mvp"][lx])
            mvp_flag[lx] = io.dec(self.ctx[CTX["MVP_LX_FLAG"]], tv)
        mvf = I.Mvf(pred_flag)
        mvf.ref_idx = ref_idx
        for lx in range(2):
            if not (pred_flag & (lx + 1)):
                continue
            pred = I.amvp(dec, self.hmvp, x0, y0, w, h, lx, ref_idx,
                          mvp_flag[lx], 2, dec.rpl_poc)
            # amvr_shift = 2 (AMVR off): mvd in quarter-pel -> 1/16
            mvf.mv[lx] = I.clip_mv([pred[0] + mvd[lx][0] * 4,
                                    pred[1] + mvd[lx][1] * 4])
        return mvf

    def _mvd_coding(self, tv):
        """hls_mvd_coding (ctu.c:1520)."""
        io = self.io
        mv = [0, 0]
        for i in range(2):
            v = None if tv is None else int(abs(tv[i]) > 0)
            mv[i] = io.dec(self.ctx[CTX["ABS_MVD_GREATER0_FLAG"]], v)
        for i in range(2):
            if mv[i]:
                v = None if tv is None else int(abs(tv[i]) > 1)
                mv[i] += io.dec(self.ctx[CTX["ABS_MVD_GREATER1_FLAG"]],
                                v)
        for i in range(2):
            if mv[i] > 0:
                if mv[i] == 2:
                    v = None if tv is None else abs(tv[i]) - 2
                    mv[i] += self._egk(v, 1, 15, 17)
                v = None if tv is None else int(tv[i] < 0)
                sign = io.byp(v)
                mv[i] = (1 - 2 * sign) * mv[i]
        return mv

    def _egk(self, val, k, max_pre, trunc_len):
        """limited_kth_order_egk (cabac.c:961), both directions."""
        io = self.io
        if io.encode:
            pre = 0
            while pre < max_pre and \
                    val >= ((1 << (pre + 1)) - 1) << k:
                io.byp(1)
                pre += 1
            esc = trunc_len if pre == max_pre else pre + k
            if pre < max_pre:
                io.byp(0)
            rem = val - (((1 << pre) - 1) << k)
            for i in range(esc - 1, -1, -1):
                io.byp((rem >> i) & 1)
            return val
        pre = 0
        while pre < max_pre and io.byp():
            pre += 1
        esc = trunc_len if pre == max_pre else pre + k
        v = 0
        for _ in range(esc):
            v = (v << 1) | io.byp()
        return v + (((1 << pre) - 1) << k)

    def _tr_ctx_bypass(self, ctx_idx, c_max, tv):
        """TR binarization with a single context bin then bypass
        (merge_idx, cabac.c:1533)."""
        io = self.io
        if c_max == 0:
            return 0
        if io.encode:
            io.dec(self.ctx[ctx_idx], int(tv > 0))
            if tv > 0:
                for _ in range(tv - 1):
                    io.byp(1)
                if tv < c_max:
                    io.byp(0)
            return tv
        if not io.dec(self.ctx[ctx_idx]):
            return 0
        i = 1
        while i < c_max and io.byp():
            i += 1
        return i

    def _ref_idx_lx(self, nb_refs, tv):
        """ff_vvc_ref_idx_lx (cabac.c:1601): TR with up to 2 context
        bins, bypass beyond."""
        io = self.io
        c_max = nb_refs - 1
        max_ctx = min(c_max, 2)
        if io.encode:
            i = 0
            while i < max_ctx and i < tv:
                io.dec(self.ctx[CTX["REF_IDX_LX"] + i], 1)
                i += 1
            if i < max_ctx:                   # i == tv
                io.dec(self.ctx[CTX["REF_IDX_LX"] + i], 0)
            elif i == 2:
                while i < tv:
                    io.byp(1)
                    i += 1
                if i < c_max:
                    io.byp(0)
            return tv
        i = 0
        while i < max_ctx and io.dec(self.ctx[CTX["REF_IDX_LX"] + i]):
            i += 1
        if i == 2:
            while i < c_max and io.byp():
                i += 1
        return i

    # ------------------------------------------------- intra mode syntax
    def _luma_intra_mode(self, x0, y0, w, h):
        dec, io = self.dec, self.io
        cand = self._mpm_list(x0, y0, w, h)
        if io.encode:
            target = self.plan.luma_mode(x0, y0, w.bit_length() - 1)
            if target == INTRA_PLANAR:
                io.dec(self.ctx[CTX["INTRA_LUMA_MPM_FLAG"]], 1)
                io.dec(self.ctx[CTX["INTRA_LUMA_NOT_PLANAR_FLAG"] + 1],
                       0)
                return INTRA_PLANAR
            if target in cand:
                idx = cand.index(target)
                io.dec(self.ctx[CTX["INTRA_LUMA_MPM_FLAG"]], 1)
                io.dec(self.ctx[CTX["INTRA_LUMA_NOT_PLANAR_FLAG"] + 1],
                       1)
                for i in range(min(idx, 4) if idx < 4 else 4):
                    io.byp(1)
                if idx < 4:
                    io.byp(0)
                return target
            io.dec(self.ctx[CTX["INTRA_LUMA_MPM_FLAG"]], 0)
            # invert the decoder mapping exactly (ctu.c:786: pred =
            # rem+1, then +1 per sorted cand <= pred; planar is NOT
            # in the loop — its slot is the fixed +1)
            srt = sorted(cand)

            def _map(v):
                p = v + 1
                for c in srt:
                    if p >= c:
                        p += 1
                return p

            v = next(v for v in range(61) if _map(v) == target)
            self._tb_encode(v, 60)
            return target
        mpm = io.dec(self.ctx[CTX["INTRA_LUMA_MPM_FLAG"]])
        if mpm:
            not_planar = io.dec(
                self.ctx[CTX["INTRA_LUMA_NOT_PLANAR_FLAG"] + 1])
            if not not_planar:
                return INTRA_PLANAR
            idx = 0
            while idx < 4 and io.byp():
                idx += 1
            return cand[idx]
        rem = self._tb_decode(60)
        pred = rem + 1
        for c in sorted(cand):
            if pred >= c:
                pred += 1
        return pred

    def _mpm_list(self, x0, y0, w, h):
        """luma_intra_pred_mode candidate list (ctu.c:685), entries
        1..5 of the 6-entry MPM (planar is entry 0); left candidate
        at (x0-1, y0+h-1), above at (x0+w-1, y0-1)."""
        dec = self.dec
        xa, ya = (x0 - 1) >> 2, (y0 + h - 1) >> 2
        xb, yb = (x0 + w - 1) >> 2, (y0 - 1) >> 2
        a = INTRA_PLANAR
        if x0 > 0 and dec.decoded[ya, xa] \
                and dec.mvf_pf[ya, xa] == I.PF_INTRA:
            a = int(dec.ipm[ya, xa])
        b = INTRA_PLANAR
        y0b = y0 & ((1 << dec.sps.log2_ctu) - 1)
        if y0 > 0 and y0b and dec.decoded[yb, xb] \
                and dec.mvf_pf[yb, xb] == I.PF_INTRA:
            b = int(dec.ipm[yb, xb])
        if a == b and a > INTRA_DC:
            return [a, 2 + ((a + 61) % 64), 2 + ((a - 1) % 64),
                    2 + ((a + 60) % 64), 2 + (a % 64)]
        mn, mx = min(a, b), max(a, b)
        if a > INTRA_DC and b > INTRA_DC:
            diff = mx - mn
            c01 = [a, b]
            if diff == 1:
                rest = [2 + ((mn + 61) % 64), 2 + ((mx - 1) % 64),
                        2 + ((mn + 60) % 64)]
            elif diff >= 62:
                rest = [2 + ((mn - 1) % 64), 2 + ((mx + 61) % 64),
                        2 + (mn % 64)]
            elif diff == 2:
                rest = [2 + ((mn - 1) % 64), 2 + ((mn + 61) % 64),
                        2 + ((mx - 1) % 64)]
            else:
                rest = [2 + ((mn + 61) % 64), 2 + ((mn - 1) % 64),
                        2 + ((mx + 61) % 64)]
            return c01 + rest
        if a > INTRA_DC or b > INTRA_DC:
            return [mx, 2 + ((mx + 61) % 64), 2 + ((mx - 1) % 64),
                    2 + ((mx + 60) % 64), 2 + (mx % 64)]
        return [INTRA_DC, INTRA_VERT, INTRA_HORZ, INTRA_VERT - 4,
                INTRA_VERT + 4]

    def _tb_decode(self, c_max):
        """9.3.3.4 truncated binary, bypass bins."""
        io = self.io
        n = c_max + 1
        k = n.bit_length() - 1
        u = (1 << (k + 1)) - n
        v = 0
        for _ in range(k):
            v = (v << 1) | io.byp()
        if v >= u:
            v = (v << 1) | io.byp()
            v -= u
        return v

    def _tb_encode(self, val, c_max):
        io = self.io
        n = c_max + 1
        k = n.bit_length() - 1
        u = (1 << (k + 1)) - n
        if val < u:
            for i in range(k - 1, -1, -1):
                io.byp((val >> i) & 1)
        else:
            t = val + u
            for i in range(k, -1, -1):
                io.byp((t >> i) & 1)

    def _chroma_intra_mode(self, x0, y0, luma_mode):
        io = self.io
        if io.encode:
            m = self.plan.chroma_mode(x0, y0, 0)      # 0..4 (4 = DM)
            if m == 4:
                io.dec(self.ctx[CTX["INTRA_CHROMA_PRED_MODE"]], 0)
            else:
                io.dec(self.ctx[CTX["INTRA_CHROMA_PRED_MODE"]], 1)
                io.byp((m >> 1) & 1)
                io.byp(m & 1)
            icpm = m
        else:
            if not io.dec(self.ctx[CTX["INTRA_CHROMA_PRED_MODE"]]):
                icpm = 4
            else:
                icpm = (io.byp() << 1) | io.byp()
        # derive_chroma_intra_pred_mode (ctu.c:887), center luma mode
        # == luma_mode here (single CU covers the chroma block)
        if icpm == 4:
            return luma_mode
        table = [[INTRA_VDIAG, INTRA_PLANAR, INTRA_PLANAR,
                  INTRA_PLANAR, INTRA_PLANAR],
                 [INTRA_VERT, INTRA_VDIAG, INTRA_VERT, INTRA_VERT,
                  INTRA_VERT],
                 [INTRA_HORZ, INTRA_HORZ, INTRA_VDIAG, INTRA_HORZ,
                  INTRA_HORZ],
                 [INTRA_DC, INTRA_DC, INTRA_DC, INTRA_VDIAG,
                  INTRA_DC]]
        modes = [INTRA_PLANAR, INTRA_VERT, INTRA_HORZ, INTRA_DC]
        idx = modes.index(luma_mode) if luma_mode in modes else 4
        return table[icpm][idx]

    # -------------------------------------------------- residual coding
    def residual(self, x0, y0, log2w, log2h, c_idx):
        """hls_residual_coding (cabac.c:2453) for the RRC path with
        dep-quant/SDH/TS/persistent-rice all off."""
        dec, io = self.dec, self.io
        w, h = 1 << log2w, 1 << log2h
        target = None
        if io.encode:
            target = self.plan.levels(x0, y0, log2w, log2h, c_idx)
            if not target.any():
                target[0, 0] = 1          # cbf said coded
        # subblock geometry
        log2_sb = 1 if min(log2w, log2h) < 2 else 2
        sb_w = sb_h = log2_sb
        if log2w + log2h > 3:
            if log2w < 2:
                sb_w, sb_h = log2w, 4 - log2w
            elif log2h < 2:
                sb_h, sb_w = log2h, 4 - log2h
        num_sb_coeff = 1 << (sb_w + sb_h)
        sb_xs, sb_ys = get_scan(log2w - sb_w, log2h - sb_h)
        xs_in, ys_in = get_scan(sb_w, sb_h)
        width_in_sbs = 1 << (log2w - sb_w)
        height_in_sbs = 1 << (log2h - sb_h)
        rem_bins = ((1 << (log2w + log2h)) * 7) >> 2

        if io.encode:
            nz = np.argwhere(target != 0)
            # last position in scan order
            order = {}
            idx = 0
            for i in range(len(sb_xs)):
                for n in range(num_sb_coeff):
                    xx = (sb_xs[i] << sb_w) + xs_in[n]
                    yy = (sb_ys[i] << sb_h) + ys_in[n]
                    order[(xx, yy)] = idx
                    idx += 1
            last_idx = max(order[(int(x), int(y))]
                           for y, x in nz)
            last_x, last_y = next(k for k, v in order.items()
                                  if v == last_idx)
        else:
            last_x = last_y = 0

        # last_sig_coeff_x/y: both TR prefixes first, then both
        # bypass suffixes (cabac.c:2424 last_significant_coeff_x_y)
        def last_prefix(pos, log2_size, ctx_base):
            if not c_idx:
                offset = [0, 0, 3, 6, 10, 15][log2_size - 1]
                shift = (log2_size + 1) >> 2
            else:
                offset = 20
                shift = [0, 0, 0, 1, 2, 2, 2][log2_size]
            mx = (log2_size << 1) - 1
            if io.encode:
                # group (prefix) for pos: 0..3 direct, then ranges
                # [base, base + 2^((p>>1)-1)) with
                # base = 2^((p>>1)-1) * (2 + (p&1))
                if pos <= 3:
                    pref = pos
                else:
                    pref = 4
                    while True:
                        base = (1 << ((pref >> 1) - 1)) * \
                            (2 + (pref & 1))
                        span = 1 << ((pref >> 1) - 1)
                        if base <= pos < base + span:
                            break
                        pref += 1
                i = 0
                while i < mx and i < pref:
                    io.dec(self.ctx[ctx_base + (i >> shift) + offset],
                           1)
                    i += 1
                if pref < mx:
                    io.dec(self.ctx[ctx_base + (pref >> shift)
                                    + offset], 0)
                return pref
            i = 0
            while i < mx and io.dec(
                    self.ctx[ctx_base + (i >> shift) + offset]):
                i += 1
            return i

        def last_suffix(pref, pos):
            if pref <= 3:
                return pref
            length = (pref >> 1) - 1
            base = (1 << length) * (2 + (pref & 1))
            if io.encode:
                sfx = pos - base
                for k in range(length - 1, -1, -1):
                    io.byp((sfx >> k) & 1)
                return pos
            sfx = 0
            for _ in range(length):
                sfx = (sfx << 1) | io.byp()
            return base + sfx

        px = last_prefix(last_x, log2w,
                         CTX["LAST_SIG_COEFF_X_PREFIX"])
        py = last_prefix(last_y, log2h,
                         CTX["LAST_SIG_COEFF_Y_PREFIX"])
        last_x = last_suffix(px, last_x)
        last_y = last_suffix(py, last_y)

        # derive last subblock / scan pos
        last_scan_pos = num_sb_coeff
        last_sub = (1 << (log2w + log2h - sb_w - sb_h)) - 1
        while True:
            if last_scan_pos == 0:
                last_scan_pos = num_sb_coeff
                last_sub -= 1
            last_scan_pos -= 1
            xc = (sb_xs[last_sub] << sb_w) + xs_in[last_scan_pos]
            yc = (sb_ys[last_sub] << sb_h) + ys_in[last_scan_pos]
            if xc == last_x and yc == last_y:
                break

        coeffs = np.zeros((h, w), np.int64)
        sb_coded = np.zeros((height_in_sbs, width_in_sbs), np.uint8)
        sig = np.zeros((h, w), np.int32)
        abs1 = np.zeros((h, w), np.int32)
        abs_lvl = np.zeros((h, w), np.int32)

        def local_sum(arr, xc, yc, hist=0):
            s = 3 * hist
            if xc < w - 1:
                s += arr[yc, xc + 1]
                if xc < w - 2:
                    s += arr[yc, xc + 2] - hist
                if yc < h - 1:
                    s += arr[yc + 1, xc + 1] - hist
            if yc < h - 1:
                s += arr[yc + 1, xc]
                if yc < h - 2:
                    s += arr[yc + 2, xc] - hist
            return s

        def sig_inc(xc, yc):
            d = xc + yc
            ls = local_sum(abs1, xc, yc)
            if not c_idx:
                return min((ls + 1) >> 1, 3) + (8 if d < 2 else
                                                (4 if d < 5 else 0))
            return 36 + min((ls + 1) >> 1, 3) + (4 if d < 2 else 0)

        def gtx_inc(xc, yc, last):
            if last:
                return [0, 21, 21][c_idx]
            d = xc + yc
            lss = local_sum(sig, xc, yc)
            ls1 = local_sum(abs1, xc, yc)
            off = min(ls1 - lss, 4)
            if not c_idx:
                return 1 + off + (15 if not d else
                                  (10 if d < 3 else
                                   (5 if d < 10 else 0)))
            return 22 + off + (5 if not d else 0)

        def rice_param(xc, yc, base):
            tab = [0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2,
                   2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3]
            ls = local_sum(abs_lvl, xc, yc)
            ls = max(0, min(31, ls - base * 5))
            return tab[ls]

        def abs_rem_code(rem, rice):
            # bypass EG-Rice (cabac.c abs_decode)
            if io.encode:
                pref = rem >> rice
                if pref < 6:
                    for _ in range(pref):
                        io.byp(1)
                    io.byp(0)
                    for k in range(rice - 1, -1, -1):
                        io.byp((rem >> k) & 1)
                else:
                    for _ in range(6):
                        io.byp(1)
                    # EGk with k = rice + 1
                    val = rem - (6 << rice)
                    k = rice + 1
                    pre = 0
                    v = val
                    while v >= (1 << k):
                        v -= 1 << k
                        k += 1
                        pre += 1
                    for _ in range(pre):
                        io.byp(1)
                    io.byp(0)
                    for i in range(k - 1, -1, -1):
                        io.byp((v >> i) & 1)
                return rem
            pref = 0
            while pref < 6 and io.byp():
                pref += 1
            if pref < 6:
                sfx = 0
                for _ in range(rice):
                    sfx = (sfx << 1) | io.byp()
                return (pref << rice) + sfx
            # limited EGk, k = rice+1 (log2_transform_range 15,
            # max prefix 26-15 = 11)
            k = rice + 1
            pre = 0
            while pre < 11 and io.byp():
                pre += 1
            val = 0
            total = 6 << rice
            for _ in range(pre):
                total += 1 << k
                k += 1
            for _ in range(k):
                val = (val << 1) | io.byp()
            return total + val

        # subblock loop, reverse scan
        qlast_sub = last_sub
        for i in range(qlast_sub, -1, -1):
            xs_, ys_ = sb_xs[i], sb_ys[i]
            infer_dc = 0
            if 0 < i < qlast_sub:
                if io.encode:
                    sbv = 1 if target[
                        ys_ << sb_h:(ys_ + 1) << sb_h,
                        xs_ << sb_w:(xs_ + 1) << sb_w].any() else 0
                else:
                    sbv = None
                right = sb_coded[ys_, xs_ + 1] \
                    if xs_ < width_in_sbs - 1 else 0
                bottom = sb_coded[ys_ + 1, xs_] \
                    if ys_ < height_in_sbs - 1 else 0
                inc = (right | bottom) + (2 if c_idx else 0)
                sb_coded[ys_, xs_] = io.dec(
                    self.ctx[CTX["SB_CODED_FLAG"] + inc], sbv)
                infer_dc = 1
            else:
                sb_coded[ys_, xs_] = 1
            if not sb_coded[ys_, xs_]:
                continue

            first_pos = last_scan_pos if i == qlast_sub \
                else num_sb_coeff - 1
            gt2 = {}
            first_mode1 = first_pos
            n = first_pos
            while n >= 0 and rem_bins >= 4:
                xc = (xs_ << sb_w) + xs_in[n]
                yc = (ys_ << sb_h) + ys_in[n]
                last = (xc == last_x and yc == last_y)
                tval = int(abs(target[yc, xc])) if io.encode else None
                if (n > 0 or not infer_dc) and not last:
                    sv = None if tval is None else int(tval > 0)
                    s = io.dec(self.ctx[CTX["SIG_COEFF_FLAG"]
                                        + sig_inc(xc, yc)], sv)
                    rem_bins -= 1
                    if s:
                        infer_dc = 0
                else:
                    s = 1 if last else (
                        1 if (xs_in[n] == 0 and ys_in[n] == 0
                              and infer_dc) else 0)
                    if io.encode and s and not tval:
                        # inferred-significant DC must be nonzero
                        target[yc, xc] = 1
                        tval = 1
                sig[yc, xc] = s
                a1 = 0
                if s:
                    inc = gtx_inc(xc, yc, last)
                    if io.encode:
                        g1 = int(tval > 1)
                        io.dec(self.ctx[CTX["ABS_LEVEL_GTX_FLAG"]
                                        + inc], g1)
                        rem_bins -= 1
                        if g1:
                            par = (tval - 2) & 1
                            io.dec(self.ctx[CTX["PAR_LEVEL_FLAG"]
                                            + inc], par)
                            g2 = int(tval >= 4 + par)
                            io.dec(self.ctx[CTX["ABS_LEVEL_GTX_FLAG"]
                                            + inc + 32], g2)
                            rem_bins -= 2
                            gt2[n] = g2
                            a1 = 1 + 1 + par + (g2 << 1)
                        else:
                            gt2[n] = 0
                            a1 = 1
                    else:
                        g1 = io.dec(self.ctx[CTX["ABS_LEVEL_GTX_FLAG"]
                                             + inc])
                        rem_bins -= 1
                        par = 0
                        if g1:
                            par = io.dec(self.ctx[CTX["PAR_LEVEL_FLAG"]
                                                  + inc])
                            gt2[n] = io.dec(
                                self.ctx[CTX["ABS_LEVEL_GTX_FLAG"]
                                         + inc + 32])
                            rem_bins -= 2
                        else:
                            gt2[n] = 0
                        a1 = 1 + par + g1 + (gt2[n] << 1)
                else:
                    gt2[n] = 0
                abs1[yc, xc] = a1
                first_mode1 = n - 1
                n -= 1

            # pass 2: remainders for gt2 positions
            for n in range(first_pos, first_mode1, -1):
                xc = (xs_ << sb_w) + xs_in[n]
                yc = (ys_ << sb_h) + ys_in[n]
                lvl = abs1[yc, xc]
                if gt2.get(n):
                    rice = rice_param(xc, yc, 4)
                    if io.encode:
                        rem = (int(abs(target[yc, xc]))
                               - abs1[yc, xc]) >> 1
                        abs_rem_code(rem, rice)
                    else:
                        rem = abs_rem_code(None, rice)
                    lvl += 2 * rem
                abs_lvl[yc, xc] = lvl

            # pass 3: fully bypass levels
            for n in range(first_mode1, -1, -1):
                xc = (xs_ << sb_w) + xs_in[n]
                yc = (ys_ << sb_h) + ys_in[n]
                rice = rice_param(xc, yc, 0)
                zero_pos = 1 << rice      # qstate < 2 -> 1 << rice
                if io.encode:
                    lvl = int(abs(target[yc, xc]))
                    if lvl == 0:
                        dec_abs = zero_pos
                    elif lvl <= zero_pos:
                        dec_abs = lvl - 1
                    else:
                        dec_abs = lvl
                    abs_rem_code(dec_abs, rice)
                else:
                    dec_abs = abs_rem_code(None, rice)
                    lvl = 0
                    if dec_abs != zero_pos:
                        lvl = dec_abs + (1 if dec_abs < zero_pos
                                         else 0)
                abs_lvl[yc, xc] = lvl

            # signs
            start = last_scan_pos if i == qlast_sub \
                else num_sb_coeff - 1
            for n in range(start, -1, -1):
                xc = (xs_ << sb_w) + xs_in[n]
                yc = (ys_ << sb_h) + ys_in[n]
                if abs_lvl[yc, xc] > 0:
                    if io.encode:
                        sgn = 1 if target[yc, xc] < 0 else 0
                        io.byp(sgn)
                    else:
                        sgn = io.byp()
                    coeffs[yc, xc] = -abs_lvl[yc, xc] if sgn \
                        else abs_lvl[yc, xc]
        if io.encode:
            return None
        return coeffs

    # ------------------------------------------------- reconstruction
    def _reconstruct(self, x0, y0, log2w, log2h, luma_mode,
                     chroma_mode, cy, cb, cr, snap_y=None,
                     snap_c=None):
        dec = self.dec
        w, h = 1 << log2w, 1 << log2h
        mode_y = wide_angle_map(luma_mode, w, h)
        pred = self._intra_pred(dec.y, x0, y0, w, h, mode_y,
                                0, avail=snap_y)
        blk = pred.astype(np.int64)
        if cy is not None:
            blk = blk + self._itx(cy, dec.qp + 6 * (dec.bd - 8), 0)
        dec.y[y0:y0 + h, x0:x0 + w] = np.clip(
            blk, 0, dec.pmax).astype(dec.y.dtype)
        wc, hc = w >> 1, h >> 1
        xc, yc = x0 >> 1, y0 >> 1
        mode_c = wide_angle_map(chroma_mode, wc, hc)
        for plane, coef, off in ((dec.u, cb, dec.pps.cb_qp_offset),
                                 (dec.v, cr, dec.pps.cr_qp_offset)):
            predc = self._intra_pred(plane, xc, yc, wc, hc,
                                     mode_c, 1, avail=snap_c)
            blk = predc.astype(np.int64)
            if coef is not None:
                qp = self._chroma_qp(off) + 6 * (dec.bd - 8)
                blk = blk + self._itx(coef, qp, 1)
            plane[yc:yc + hc, xc:xc + wc] = np.clip(
                blk, 0, dec.pmax).astype(plane.dtype)

    def _recon_inter(self, x0, y0, log2w, log2h, mvf, cy, cb, cr):
        """Inter CU reconstruction: whole-CU translation MC
        (vvc/inter.c put_luma/put_chroma) + residual add."""
        dec = self.dec
        w, h = 1 << log2w, 1 << log2h
        py, pu_, pv_ = I.predict_inter(dec, dec.rpl_frames, x0, y0,
                                       w, h, mvf)
        blk = py.astype(np.int64)
        if cy is not None:
            blk = blk + self._itx(cy, dec.qp + 6 * (dec.bd - 8), 0)
        dec.y[y0:y0 + h, x0:x0 + w] = np.clip(
            blk, 0, dec.pmax).astype(dec.y.dtype)
        wc, hc = w >> 1, h >> 1
        xc, yc = x0 >> 1, y0 >> 1
        for plane, predc, coef, off in (
                (dec.u, pu_, cb, dec.pps.cb_qp_offset),
                (dec.v, pv_, cr, dec.pps.cr_qp_offset)):
            blk = predc.astype(np.int64)
            if coef is not None:
                qp = self._chroma_qp(off) + 6 * (dec.bd - 8)
                blk = blk + self._itx(coef, qp, 1)
            plane[yc:yc + hc, xc:xc + wc] = np.clip(
                blk, 0, dec.pmax).astype(plane.dtype)

    def _chroma_qp(self, offset=0):
        """Qp_C from the SPS chroma QP mapping table (7.4.3.4)."""
        dec = self.dec
        qp_bd = 6 * (dec.bd - 8)
        qp = max(-qp_bd, min(63, dec.qp))
        mapped = dec.sps.qp_table[qp + qp_bd]
        return max(-qp_bd, min(63, mapped + offset))

    def _itx(self, coeffs, qp, c_idx):
        """Dequant (8.7.3, flat lists; rect TBs use the sqrt(2)
        level-scale row + one extra shift bit, vvc/intra.c:310) +
        inverse DCT-2 (matrices shared with HEVC for N<=32)."""
        dec = self.dec
        h, w = coeffs.shape
        log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
        rect = (log2w + log2h) & 1
        bd_shift = dec.bd + rect + ((log2w + log2h) >> 1) - 5
        add = 1 << (bd_shift - 1)
        ls = _LEVEL_SCALE_RECT if rect else _LEVEL_SCALE
        scale = ls[qp % 6] << (qp // 6)
        d = np.clip((coeffs * scale * 16 + add) >> bd_shift,
                    -(1 << 15), (1 << 15) - 1)
        mats = {4: HT.T4, 8: HT.T8, 16: HT.T16, 32: HT.T32}
        th = mats[h].astype(np.int64)
        tw = mats[w].astype(np.int64)
        tmp = np.clip((th.T @ d + 64) >> 7, -(1 << 15), (1 << 15) - 1)
        sh2 = 20 - dec.bd
        return (tmp @ tw + (1 << (sh2 - 1))) >> sh2

    # --------------------------------------------------- intra predict
    def _avail_top(self, plane, x, y, want, c_idx):
        """ff_vvc_get_top_available analog via the decoded mask."""
        dec = self.dec
        if y == 0:
            return 0
        sh = 1 if c_idx else 0
        W = dec.sps.width >> sh
        want = min(want, W - x)
        n = 0
        m = dec.decoded
        while n < want:
            if not m[((y - 1) << sh) >> 2, ((x + n) << sh) >> 2]:
                break
            n += 1
        return n

    def _avail_left(self, plane, x, y, want, c_idx):
        dec = self.dec
        if x == 0:
            return 0
        sh = 1 if c_idx else 0
        H = dec.sps.height >> sh
        want = min(want, H - y)
        n = 0
        m = dec.decoded
        while n < want:
            if not m[((y + n) << sh) >> 2, ((x - 1) << sh) >> 2]:
                break
            n += 1
        return n

    def _edge_sizes(self, w, h, mode, c_idx):
        """(left_size, top_size, un_l, un_t) per
        prepare_intra_edge_params (intra_template.c:466)."""
        ref_filter_flag = mode in _REF_FILTER_MODES
        filter_flag = w * h > 32 and not c_idx and ref_filter_flag
        need_pdpc = self._need_pdpc(w, h, mode)
        if mode == INTRA_PLANAR:
            left_size, top_size = h + 1, w + 1
            return (left_size, top_size, left_size + filter_flag,
                    top_size + filter_flag)
        if mode == INTRA_DC:
            return h, w, h, w
        if mode == INTRA_VERT:
            ls = h if need_pdpc else 1
            return ls, w, ls, w
        if mode == INTRA_HORZ:
            ts = w if need_pdpc else 1
            return h, ts, h, ts
        return 2 * h, 2 * w, 2 * h, 2 * w

    def _avail_snap(self, x, y, w, h, mode, c_idx):
        """Parse-time availability snapshot for deferred recon."""
        un_l, un_t = self._edge_sizes(w, h, mode, c_idx)[2:]
        plane = self.dec.y if not c_idx else self.dec.u
        la = self._avail_left(plane, x, y, un_l, c_idx)
        ta = self._avail_top(plane, x, y, un_t, c_idx)
        cul = bool(x > 0 and y > 0 and self.dec.decoded[
            ((y - 1) << (1 if c_idx else 0)) >> 2,
            ((x - 1) << (1 if c_idx else 0)) >> 2])
        return la, ta, cul

    def _intra_pred(self, plane, x, y, w, h, mode, c_idx,
                    avail=None):
        """intra_template.c intra_pred for the no-MIP/MRL/ISP path.
        Square blocks only (QT) so no wide-angle remap."""
        dec = self.dec
        bd = dec.bd
        pmax = dec.pmax
        ref_filter_flag = mode in _REF_FILTER_MODES
        filter_flag = w * h > 32 and not c_idx and ref_filter_flag
        need_pdpc = self._need_pdpc(w, h, mode)

        left_size, top_size, un_l, un_t = self._edge_sizes(
            w, h, mode, c_idx)

        PAD = 34 + 3
        left = np.zeros(128 + PAD, np.int64)
        top = np.zeros(128 + PAD, np.int64)
        pl = plane

        if avail is None:
            la = self._avail_left(plane, x, y, un_l, c_idx)
            ta = self._avail_top(plane, x, y, un_t, c_idx)
            cand_up_left = x > 0 and y > 0 and \
                dec.decoded[((y - 1) << (1 if c_idx else 0)) >> 2,
                            ((x - 1) << (1 if c_idx else 0)) >> 2]
        else:
            la, ta, cand_up_left = avail
        for i in range(la):
            left[PAD + i] = pl[y + i, x - 1]
        if ta:
            top[PAD:PAD + ta] = pl[y - 1, x:x + ta]
        if cand_up_left:
            left[PAD - 1] = top[PAD - 1] = pl[y - 1, x - 1]
        elif la:
            left[PAD - 1] = top[PAD - 1] = left[PAD]
        elif ta:
            left[PAD - 1] = top[PAD - 1] = top[PAD]
        else:
            left[PAD - 1] = top[PAD - 1] = 1 << (bd - 1)
        if ta == 0:
            top[PAD:PAD + un_t] = top[PAD - 1]
        elif ta < un_t:
            top[PAD + ta:PAD + un_t] = top[PAD + ta - 1]
        if la == 0:
            left[PAD:PAD + un_l] = left[PAD - 1]
        elif la < un_l:
            left[PAD + la:PAD + un_l] = left[PAD + la - 1]

        if ref_filter_flag and w * h > 32 and not c_idx:
            fl = left.copy()
            ft = top.copy()
            unfilter_last = 1 if left_size == un_l else 0
            fl[PAD - 1] = ft[PAD - 1] = (left[PAD] + 2 * left[PAD - 1]
                                         + top[PAD] + 2) >> 2
            for i in range(un_l - unfilter_last):
                fl[PAD + i] = (left[PAD + i - 1] + 2 * left[PAD + i]
                               + left[PAD + i + 1] + 2) >> 2
            for i in range(un_t - unfilter_last):
                ft[PAD + i] = (top[PAD + i - 1] + 2 * top[PAD + i]
                               + top[PAD + i + 1] + 2) >> 2
            if unfilter_last:
                ft[PAD + un_t - 1] = top[PAD + un_t - 1]
                fl[PAD + un_l - 1] = left[PAD + un_l - 1]
            left, top = fl, ft

        # angular edge extension / filter decision
        edge_filter_flag = 0
        if mode not in (INTRA_PLANAR, INTRA_DC):
            if ref_filter_flag:
                edge_filter_flag = 0
            else:
                mdvh = min(abs(mode - 50), abs(mode - 18))
                thres = [24, 14, 2, 0, 0]
                lw = w.bit_length() - 1
                lh = h.bit_length() - 1
                ntbs = (lw + lh) >> 1
                edge_filter_flag = int(mdvh > thres[ntbs - 2])
            if mode not in (INTRA_VERT, INTRA_HORZ):
                ang = pred_angle(mode)
                if mode >= INTRA_DIAG:
                    if ang < 0:
                        ia = inv_angle(ang)
                        for xx in range(-h, 0):
                            idx = -1 + min((xx * ia + 256) >> 9, h)
                            top[PAD - 1 + xx] = left[PAD + idx]
                    else:
                        top[PAD + 2 * w] = top[PAD + 2 * w - 1]
                        top[PAD + 2 * w + 1] = top[PAD + 2 * w - 1]
                else:
                    if ang < 0:
                        ia = inv_angle(ang)
                        for xx in range(-w, 0):
                            idx = -1 + min((xx * ia + 256) >> 9, w)
                            left[PAD - 1 + xx] = top[PAD + idx]
                    else:
                        left[PAD + 2 * h] = left[PAD + 2 * h - 1]
                        left[PAD + 2 * h + 1] = left[PAD + 2 * h - 1]

        out = np.zeros((h, w), np.int64)
        if mode == INTRA_PLANAR:
            logw = w.bit_length() - 1
            logh = h.bit_length() - 1
            shift = logw + logh + 1
            tt = top[PAD:PAD + w + 1]
            ll = left[PAD:PAD + h + 1]
            yy = np.arange(h)[:, None]
            xx = np.arange(w)[None, :]
            pv = ((h - 1 - yy) * tt[None, :w] + (yy + 1) * ll[h]) \
                << logw
            ph = ((w - 1 - xx) * ll[:h, None] + (xx + 1) * tt[w]) \
                << logh
            out = (pv + ph + w * h) >> shift
        elif mode == INTRA_DC:
            ssum = 0
            if w >= h:
                ssum += int(top[PAD:PAD + w].sum())
            if w <= h:
                ssum += int(left[PAD:PAD + h].sum())
            off = (w << 1) if w == h else max(w, h)
            dc = (ssum + (off >> 1)) >> (off.bit_length() - 1)
            out[:] = dc
        elif mode == INTRA_VERT:
            out[:] = top[PAD:PAD + w][None, :]
        elif mode == INTRA_HORZ:
            out[:] = left[PAD:PAD + h][:, None]
        else:
            ang = pred_angle(mode)
            if mode >= INTRA_DIAG:
                pos = ang
                base = top
                for yy in range(h):
                    idx = pos >> 5
                    fact = pos & 31
                    if not fact and (c_idx or not edge_filter_flag):
                        for xx in range(w):
                            out[yy, xx] = base[PAD + xx + idx]
                    else:
                        if not c_idx:
                            f = _LUMA_FILTER[edge_filter_flag][fact]
                            for xx in range(w):
                                p = PAD + xx + idx - 1
                                v = (base[p] * f[0] + base[p + 1]
                                     * f[1] + base[p + 2] * f[2]
                                     + base[p + 3] * f[3] + 32) >> 6
                                out[yy, xx] = min(max(v, 0), pmax)
                        else:
                            for xx in range(w):
                                p = PAD + xx + idx - 1
                                out[yy, xx] = ((32 - fact)
                                               * base[p + 1]
                                               + fact * base[p + 2]
                                               + 16) >> 5
                    if need_pdpc:
                        ia = inv_angle(ang)
                        nscale = self._nscale(w, h, mode)
                        inv_sum = 256 + ia
                        for xx in range(min(w, 3 << nscale)):
                            lv = left[PAD + yy + (inv_sum >> 9)]
                            val = out[yy, xx]
                            wl = 32 >> min(31, (xx << 1) >> nscale)
                            out[yy, xx] = min(max(
                                val + ((lv - val) * wl + 32 >> 6),
                                0), pmax)
                            inv_sum += ia
                    pos += ang
            else:
                base = left
                ia = inv_angle(ang) if need_pdpc else 0
                nscale = self._nscale(w, h, mode) if need_pdpc else 0
                inv_sum = 256 + ia
                for yy in range(h):
                    pos = ang
                    wt = 32 >> min(31, (yy * 2) >> nscale) \
                        if need_pdpc else 0
                    for xx in range(w):
                        idx = pos >> 5
                        fact = pos & 31
                        p = PAD + yy + idx - 1
                        if not fact and (c_idx
                                         or not edge_filter_flag):
                            v = base[PAD + yy + idx]
                        else:
                            if not c_idx:
                                f = _LUMA_FILTER[edge_filter_flag][
                                    fact]
                                v = (base[p] * f[0] + base[p + 1]
                                     * f[1] + base[p + 2] * f[2]
                                     + base[p + 3] * f[3] + 32) >> 6
                                v = min(max(v, 0), pmax)
                            else:
                                v = ((32 - fact) * base[p + 1]
                                     + fact * base[p + 2] + 16) >> 5
                        if need_pdpc and yy < (3 << nscale):
                            t = top[PAD + xx + (inv_sum >> 9)]
                            v = min(max(
                                v + ((t - v) * wt + 32 >> 6), 0),
                                pmax)
                        out[yy, xx] = v
                        pos += ang
                    if need_pdpc:
                        inv_sum += ia

        # PDPC for planar/dc/hor/vert (8.4.5.2.15)
        if need_pdpc and mode in (INTRA_PLANAR, INTRA_DC, INTRA_VERT,
                                  INTRA_HORZ):
            lw = w.bit_length() - 1
            lh = h.bit_length() - 1
            scale = (lw + lh - 2) >> 2
            yy = np.arange(h)[:, None]
            xx = np.arange(w)[None, :]
            wl = 32 >> np.minimum((xx << 1) >> scale, 31)
            wt = 32 >> np.minimum((yy << 1) >> scale, 31)
            ll = left[PAD:PAD + h][:, None]
            tt = top[PAD:PAD + w][None, :]
            if mode in (INTRA_PLANAR, INTRA_DC):
                lq, tq = ll + 0 * xx, tt + 0 * yy
            else:
                corner_l = left[PAD - 1]
                corner_t = top[PAD - 1]
                lq = ll - corner_l + out
                tq = tt - corner_t + out
                if mode == INTRA_VERT:
                    wt = np.zeros_like(wt)
                else:
                    wl = np.zeros_like(wl)
            out = out + ((wl * (lq - out) + wt * (tq - out) + 32)
                         >> 6)
            out = np.clip(out, 0, pmax)
        return out

    def _nscale(self, w, h, mode):
        lw = w.bit_length() - 1
        lh = h.bit_length() - 1
        if mode in (INTRA_PLANAR, INTRA_DC, INTRA_HORZ, INTRA_VERT):
            return (lw + lh - 2) >> 2
        ang = pred_angle(mode)
        ia = abs(inv_angle(ang))
        side = h if mode >= INTRA_VERT else w
        sl = side.bit_length() - 1
        return min(2, sl - ((3 * ia - 2).bit_length() - 1) + 8)

    def _need_pdpc(self, w, h, mode):
        if w < 4 or h < 4:
            return 0
        if mode in (INTRA_PLANAR, INTRA_DC, INTRA_HORZ, INTRA_VERT):
            return 1
        if INTRA_HORZ < mode < INTRA_VERT:
            return 0
        return int(self._nscale(w, h, mode) >= 0)
