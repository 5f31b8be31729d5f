"""Native (C++) VP9 frame parse glue.

Drives csrc/host/vp9_parse.cpp — the C++ port of the tile walker,
built by the port's native.py, which raises if the build fails — and
exposes its outputs as a NativeRecord whose arrays slot directly into
recon_tpu's device replay (prepare_native). The Python walker
(block.py) stays the authoritative reference implementation; the
port's tests diff-check the two (tests/test_torch_vp9.py).

All tables come from tables_gen.py (single authoritative copy); the
probability arrays come from the frame's FrameProbs. Counts are
accumulated directly into fs.counts so backward adaptation
(prob.adapt_probs) is unchanged.

The port's copy of ffmpeg_tpu/codecs/vp9/native_parse.py, held equal to
it by tests/test_torch_host_copies.py."""

from __future__ import annotations

import ctypes

import numpy as np

from ... import native
from ...utils.error import InvalidData
from . import tables_gen as T

_NSLOTS = 116

# mc / tu / intra class orders (must match recon_tpu + vp9_parse.cpp)
MC_CLASSES = [(True, 8), (True, 4), (False, 8), (False, 4)]
CLASSES = [(True, 4), (True, 8), (True, 16), (True, 32),
           (False, 4), (False, 8), (False, 16), (False, 32)]

_ERRS = {
    -1: "vp9: bad tile marker bit",
    -2: "vp9: truncated tile",
    -3: "vp9: bad band",
    -4: "vp9: bad I mb_type",
    -5: "vp9 native: mc record overflow",
    -6: "vp9 native: tu record overflow",
    -7: "vp9 native: intra record overflow",
}


def _i32(a):
    return np.ascontiguousarray(np.asarray(a), np.int32)


def _build_tables():
    """Module-level int32 copies of every table the walker needs."""
    from .block import (INTER_MODE_CTX_LUT, INTRA_TXFM_TYPE, _SCANS)
    from .mvs import MV_REF_BLK_OFF
    from .recorder import MODE_CONV, NEEDS

    scans = np.zeros((4, 4, 1024), np.int32)
    nbs = np.zeros((4, 4, 1024, 2), np.int32)
    for (tx, tp), (sc, nb) in _SCANS.items():
        n = len(sc)
        scans[tx, tp, :n] = sc
        nbs[tx, tp, :n] = nb
    mode_conv = np.zeros((10, 4), np.int32)
    for m, row in MODE_CONV.items():
        mode_conv[m] = row
    needs = np.zeros((15, 5), np.int32)
    for m, row in NEEDS.items():
        needs[m] = row
    return {
        "t_part": _i32(T.PARTITION_TREE),
        "t_imode": _i32(T.INTRAMODE_TREE),
        "t_inter": _i32(T.INTER_MODE_TREE),
        "t_filter": _i32(T.FILTER_TREE),
        "t_mvj": _i32(T.MV_JOINT_TREE),
        "t_mvc": _i32(T.MV_CLASS_TREE),
        "t_mvfp": _i32(T.MV_FP_TREE),
        "kf_part": _i32(T.KF_PARTITION_PROBS),
        "kf_ym": _i32(T.KF_YMODE_PROBS),
        "kf_uv": _i32(T.KF_UVMODE_PROBS),
        "bwh": _i32(T.BWH_TAB),
        "mvoff": _i32(MV_REF_BLK_OFF),
        "imctx": _i32(INTER_MODE_CTX_LUT),
        "scans": scans,
        "nbs": np.ascontiguousarray(nbs),
        "mode_conv": mode_conv,
        "needs": needs,
        "itxtp": _i32(INTRA_TXFM_TYPE),
    }


_TABLES = None


class NativeRecord:
    """Array-form ReconRecorder: same information, flat layout."""

    def __init__(self, bufs, n, max_level):
        self.max_level = int(max_level)
        # mc[cls] = int32 [K, 11] raw (pl, dy, dx, mx0, my0, r0,
        #                              mx1, my1, r1, comp, filt).
        # Copies: the parse buffers are reused by the next frame, and
        # windowed replay holds records for a whole window.
        self.mc_arr = {}
        for i, cls in enumerate(MC_CLASSES):
            self.mc_arr[cls] = bufs["mc"][i][: n[i]].copy()
        self.tu_arr = {}
        self.in_arr = {}
        for i, cls in enumerate(CLASSES):
            k = n[4 + i]
            self.tu_arr[cls] = (bufs["tu_meta"][i][:k].copy(),
                                bufs["tu_coef"][i][:k].copy())
            k = n[12 + i]
            self.in_arr[cls] = (bufs["in_meta"][i][:k].copy(),
                                bufs["in_coef"][i][:k].copy())


class _Buffers:
    """Worst-case per-geometry output buffers, reused across frames."""

    def __init__(self, sb_cols, sb_rows):
        wp, hp = sb_cols * 64, sb_rows * 64
        self.mc_caps = []
        self.mc = []
        for is_luma, t in MC_CLASSES:
            w = wp if is_luma else wp // 2
            h = hp if is_luma else hp // 2
            cap = (w // t) * (h // t) * (1 if is_luma else 2)
            self.mc_caps.append(cap)
            self.mc.append(np.zeros((cap, 11), np.int32))
        self.tu_caps, self.tu_meta, self.tu_coef = [], [], []
        self.in_caps, self.in_meta, self.in_coef = [], [], []
        for is_luma, nn in CLASSES:
            w = wp if is_luma else wp // 2
            h = hp if is_luma else hp // 2
            cap = max(1, (w // nn) * (h // nn)) * (1 if is_luma else 2)
            self.tu_caps.append(cap)
            self.tu_meta.append(np.zeros((cap, 3), np.int32))
            self.tu_coef.append(np.zeros((cap, nn * nn), np.int32))
            self.in_caps.append(cap)
            self.in_meta.append(np.zeros((cap, 9), np.int32))
            self.in_coef.append(np.zeros((cap, nn * nn), np.int32))
        self.caps = np.asarray(self.mc_caps + self.tu_caps
                               + self.in_caps, np.int64)
        self.out_n = np.zeros(21, np.int64)


_buffers_cache = {}


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def parse_frame_native(fs, data: bytes, pos: int) -> NativeRecord:
    """Parse all tiles of one frame with the C++ walker.

    fs: FrameState (grids + counts are filled in place, exactly like
    the Python walker); data/pos: packet bytes and the tile-region
    offset. Returns the NativeRecord for device replay.
    """
    global _TABLES
    lib = native.get()       # bound in native._bind
    if _TABLES is None:
        _TABLES = _build_tables()
    h = fs.h
    key = (fs.sb_cols, fs.sb_rows)
    bufs = _buffers_cache.get(key)
    if bufs is None:
        bufs = _buffers_cache[key] = _Buffers(*key)
        if len(_buffers_cache) > 4:
            for k in list(_buffers_cache):
                if k != key:
                    del _buffers_cache[k]

    hdr = np.zeros(40, np.int32)
    hdr[0] = h.keyframe
    hdr[1] = h.intraonly
    hdr[3] = h.width
    hdr[4] = h.height
    hdr[5] = fs.cols
    hdr[6] = fs.rows
    hdr[7] = fs.sb_cols
    hdr[8] = fs.sb_rows
    hdr[9] = h.txfmmode
    hdr[10] = h.filtermode
    hdr[11] = h.comppredmode
    hdr[12] = h.fixcompref
    hdr[13:15] = h.varcompref
    hdr[15:18] = h.signbias
    hdr[18] = h.highprecisionmvs
    hdr[19] = h.use_last_frame_mvs
    hdr[20] = h.qmul[0][0]
    hdr[21] = h.qmul[0][1]
    hdr[22] = h.qmul[1][0]
    hdr[23] = h.qmul[1][1]
    hdr[24] = h.log2_tile_cols
    hdr[25] = h.log2_tile_rows
    hdr[26:34] = _i32(h.lflvl_mat).reshape(-1)

    p = fs.probs
    probs = {name: _i32(getattr(p, name))
             for name, _ in type(p).FIELDS}
    probs["coef"] = _i32(p.coef)

    cnt = fs.counts
    mvc = cnt["mv_comp"]
    for a in list(cnt.values()) + list(mvc.values()):
        if isinstance(a, np.ndarray):
            assert a.flags.c_contiguous

    slots = [None] * _NSLOTS
    tb = _TABLES
    order = ["t_part", "t_imode", "t_inter", "t_filter", "t_mvj",
             "t_mvc", "t_mvfp", "kf_part", "kf_ym", "kf_uv", "bwh",
             "mvoff", "imctx", "scans", "nbs", "mode_conv", "needs",
             "itxtp"]
    for i, nm in enumerate(order):
        slots[i] = tb[nm]
    porder = ["y_mode", "uv_mode", "filter", "mv_mode", "intra",
              "comp", "single_ref", "comp_ref", "tx32p", "tx16p",
              "tx8p", "skip", "mv_joint", "mv_comp", "partition",
              "coef"]
    for i, nm in enumerate(porder):
        slots[20 + i] = probs[nm]
    slots[36] = np.ascontiguousarray(fs.prev_mv_ref, np.int32)
    slots[37] = np.ascontiguousarray(fs.prev_mv_xy, np.int32)
    for i, nm in enumerate(["mv_ref", "mv_xy", "lf_lvl", "wd_v",
                            "wd_h", "wd_v_uv", "wd_h_uv"]):
        a = getattr(fs, nm)
        assert a.dtype == np.int32 and a.flags.c_contiguous, nm
        slots[40 + i] = a
    corder = ["eob", "coef", "skip", "intra", "comp", "comp_ref",
              "single_ref", "partition", "tx32p", "tx16p", "tx8p",
              "filter", "mv_mode", "mv_joint", "y_mode", "uv_mode"]
    for i, nm in enumerate(corder):
        slots[50 + i] = cnt[nm]
    mvorder = ["sign", "classes", "class0", "bits", "class0_fp", "fp",
               "class0_hp", "hp"]
    for i, nm in enumerate(mvorder):
        slots[66 + i] = mvc[nm]
    slots[78] = bufs.caps
    slots[79] = bufs.out_n
    for i in range(4):
        slots[80 + i] = bufs.mc[i]
    for i in range(8):
        slots[84 + i] = bufs.tu_meta[i]
        slots[92 + i] = bufs.tu_coef[i]
        slots[100 + i] = bufs.in_meta[i]
        slots[108 + i] = bufs.in_coef[i]

    arr = (ctypes.c_void_p * _NSLOTS)()
    for i, s in enumerate(slots):
        arr[i] = None if s is None else s.ctypes.data
    region = data[pos:]
    rc = lib.vp9_parse_frame(
        region, len(region),
        hdr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), arr)
    if rc != 0:
        raise InvalidData(_ERRS.get(rc, f"vp9 native: error {rc}"))
    # mv grids come back as int32; FrameState keeps them int32 too
    return NativeRecord({"mc": bufs.mc, "tu_meta": bufs.tu_meta,
                         "tu_coef": bufs.tu_coef,
                         "in_meta": bufs.in_meta,
                         "in_coef": bufs.in_coef},
                        bufs.out_n[:20], bufs.out_n[20])
