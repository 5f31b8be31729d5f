"""HEVC constant tables (ITU-T H.265; reference: libavcodec/hevc/
cabac.c context inits + data.c scans, dsp_template.c transforms).

Only the standard's numeric constants live here; everything is either
transcribed from the spec or generated from its defining rule.

The port's copy of ffmpeg_tpu/codecs/hevc/tables.py, held equal to it by
tests/test_torch_hevc_host.py."""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# CABAC context layout: (name, count) in init-table order
# (hevc/cabac.c CABAC_ELEMS). Offsets are cumulative.

_ELEMS = [
    ("sao_merge_flag", 1), ("sao_type_idx", 1), ("split_cu_flag", 3),
    ("cu_transquant_bypass", 1), ("skip_flag", 3), ("cu_qp_delta", 3),
    ("pred_mode", 1), ("part_mode", 4), ("prev_intra_luma_pred", 1),
    ("intra_chroma_pred_mode", 2), ("merge_flag", 1), ("merge_idx", 1),
    ("inter_pred_idc", 5), ("ref_idx_l0", 2), ("ref_idx_l1", 2),
    ("abs_mvd_greater0", 2), ("abs_mvd_greater1", 2), ("mvp_lx_flag", 1),
    ("no_residual_data", 1), ("split_transform_flag", 3),
    ("cbf_luma", 2), ("cbf_cb_cr", 5), ("transform_skip_flag", 2),
    ("explicit_rdpcm_flag", 2), ("explicit_rdpcm_dir", 2),
    ("last_sig_x_prefix", 18), ("last_sig_y_prefix", 18),
    ("sig_cg_flag", 4), ("sig_flag", 44),
    ("greater1", 24), ("greater2", 6),
    ("log2_res_scale_abs", 8), ("res_scale_sign", 2),
    ("cu_chroma_qp_offset_flag", 1), ("cu_chroma_qp_offset_idx", 1),
]

CTX_OFF = {}
_off = 0
for _name, _n in _ELEMS:
    CTX_OFF[_name] = _off
    _off += _n
N_CTX = _off

_CNU = 154

# init values per init_type (0 = I slices); hevc/cabac.c init_values
INIT_VALUES = [None, None, None]
INIT_VALUES[0] = (
    [153] + [200] + [139, 141, 157] + [154] + [_CNU] * 3 +
    [154, 154, 154] + [_CNU] + [184, _CNU, _CNU, _CNU] + [184] +
    [63, 139] + [_CNU] + [_CNU] + [_CNU] * 5 + [_CNU] * 2 + [_CNU] * 2 +
    [_CNU] * 2 + [_CNU] * 2 + [_CNU] + [_CNU] +
    [153, 138, 138] + [111, 141] + [94, 138, 182, 154, 154] +
    [139, 139] + [139, 139] + [139, 139] +
    [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127,
     111, 79, 108, 123, 63] +
    [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127,
     111, 79, 108, 123, 63] +
    [91, 171, 134, 141] +
    [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179,
     153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153,
     125, 140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111,
     136, 139, 111, 141, 111] +
    [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107,
     122, 152, 140, 179, 166, 182, 140, 227, 122, 197] +
    [138, 153, 136, 167, 152, 152] +
    [154] * 8 + [154, 154] + [154] + [154])
assert len(INIT_VALUES[0]) == N_CTX, len(INIT_VALUES[0])

from .cabac_tables import INIT_TYPE_1, INIT_TYPE_2  # noqa: E402

INIT_VALUES[1] = INIT_TYPE_1
INIT_VALUES[2] = INIT_TYPE_2
assert len(INIT_VALUES[1]) == N_CTX and len(INIT_VALUES[2]) == N_CTX


def init_mn(init_type: int):
    """HEVC init-value -> (m, n) pairs compatible with the shared
    H.264-style context initializer (spec 9.3.2.2)."""
    out = []
    for iv in INIT_VALUES[init_type]:
        m = (iv >> 4) * 5 - 45
        n = ((iv & 15) << 3) - 16
        out.append((m, n))
    return out


# ---------------------------------------------------------------------------
# scan orders (spec 6.5.3): x/y coordinate lists per scan position


def _diag(n):
    xs, ys = [], []
    for d in range(2 * n - 1):
        for y in range(min(d, n - 1), -1, -1):
            x = d - y
            if x < n:
                xs.append(x)
                ys.append(y)
    return xs, ys


def _horiz(n):
    xs, ys = [], []
    for y in range(n):
        for x in range(n):
            xs.append(x)
            ys.append(y)
    return xs, ys


DIAG4_X, DIAG4_Y = _diag(4)
DIAG2_X, DIAG2_Y = _diag(2)
DIAG8_X, DIAG8_Y = _diag(8)
HOR4_X, HOR4_Y = _horiz(4)
HOR2_X, HOR2_Y = _horiz(2)


def _inv(xs, ys, n):
    inv = np.zeros((n, n), np.int32)
    for i, (x, y) in enumerate(zip(xs, ys)):
        inv[y, x] = i
    return inv


DIAG4_INV = _inv(DIAG4_X, DIAG4_Y, 4)
DIAG2_INV = _inv(DIAG2_X, DIAG2_Y, 2)
DIAG8_INV = _inv(DIAG8_X, DIAG8_Y, 8)

# the sig_coeff_flag context map (spec 9.3.4.2.5 composed with the
# in-CG scan; hevc/cabac.c ctx_idx_map): [scan][5*16]
CTX_IDX_MAP = [
    [  # SCAN_DIAG
        0, 2, 1, 6, 3, 4, 7, 6, 4, 5, 7, 8, 5, 8, 8, 8,
        1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        2, 1, 2, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 0, 0, 0,
        2, 2, 1, 2, 1, 0, 2, 1, 0, 0, 1, 0, 0, 0, 0, 0,
        2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    ],
    [  # SCAN_HORIZ
        0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8,
        1, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0,
        2, 2, 2, 2, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0,
        2, 1, 0, 0, 2, 1, 0, 0, 2, 1, 0, 0, 2, 1, 0, 0,
        2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    ],
    [  # SCAN_VERT
        0, 2, 6, 7, 1, 3, 6, 7, 4, 4, 8, 8, 5, 5, 8, 8,
        1, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0,
        2, 1, 0, 0, 2, 1, 0, 0, 2, 1, 0, 0, 2, 1, 0, 0,
        2, 2, 2, 2, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0,
        2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    ],
]

# ---------------------------------------------------------------------------
# inverse transform matrices (spec 8.6.4; the integer DCT-II family is
# defined by the published coefficient sets, folded by cosine symmetry)

_ODD32 = [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4]
_ODD16 = [90, 87, 80, 70, 57, 43, 25, 9]
_ODD8 = [89, 75, 50, 18]
_ODD4 = [83, 36]


def _cos_val(p):
    """Integer value standing for cos(p*pi/64), p in [0, 64]."""
    if p == 0:
        return 64                      # DC row normalization
    if p == 32:
        return 0
    if p > 32:
        return -_cos_val(64 - p)
    if p % 2 == 1:
        return _ODD32[(p - 1) // 2]
    if p % 4 == 2:
        return _ODD16[(p // 2 - 1) // 2]
    if p % 8 == 4:
        return _ODD8[(p // 4 - 1) // 2]
    if p % 16 == 8:
        return _ODD4[(p // 8 - 1) // 2]
    return 64                          # p == 16 (cos(pi/4) slot)


def _dct_matrix(n):
    t = np.zeros((n, n), np.int32)
    step = 32 // n
    for k in range(n):
        for j in range(n):
            m = (k * (2 * j + 1) * step) % 128
            if m > 64:
                m = 128 - m            # cos(x) == cos(2*pi - x)
            t[k, j] = _cos_val(m)
    return t


T4 = _dct_matrix(4)
T8 = _dct_matrix(8)
T16 = _dct_matrix(16)
T32 = _dct_matrix(32)
# 4x4 DST-VII for intra luma (spec 8.6.4.1)
DST4 = np.array([[29, 55, 74, 84],
                 [74, 74, 0, -74],
                 [84, -29, -74, 55],
                 [55, -84, 74, -29]], np.int32)

LEVEL_SCALE = [40, 45, 51, 57, 64, 72]

# chroma QP mapping for 4:2:0 (spec Table 8-10)
QP_C = [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37]

# intra angular parameters (spec 8.4.4.2.6)
INTRA_PRED_ANGLE = [
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
    -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32]
INV_ANGLE = [-4096, -1638, -910, -630, -482, -390, -315, -256, -315,
             -390, -482, -630, -910, -1638, -4096]

# deblocking thresholds (spec Table 8-12)
BETA_TABLE = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11,
    12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38,
    40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64]
TC_TABLE = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9,
    10, 11, 13, 14, 16, 18, 20, 22, 24]
