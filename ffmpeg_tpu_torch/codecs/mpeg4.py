"""MPEG-4 part 2 (ASP) and H.263 video decoders (counterpart of
ffmpeg_tpu/codecs/mpeg4.py; ISO 14496-2; reference:
libavcodec/mpeg4videodec.c, h263dec.c, h263.c, mpegvideo_motion.c).

The reference's split, kept: the host walks the bitstream (VLCs,
predictors, MV decode, dequantisation) and gathers every coded block of
the picture; `_Recon.run` stacks them and runs one batched `idct8x8`
(ops/idct.py, full float32, TF32 refused) on the decoder's device (the
`device` it is opened on), whose samples come back to the host once;
the rounding, the half-pel motion compensation (`_hpel`, `_pred16`,
`_pred8x8` with its clip semantics), B-direct mode and the reference
pictures stay the reference's host code, copied.  Decoded frames carry
tensor planes on the decoder's device.

`stats`, when a list, gets one dict per picture: host parse ms, the
IDCT's h2d bytes, its device ms (upload, transform and download; CUDA
events on a card), and the host's motion compensation and
reconstruction ms.

Scope: rectangular VOPs, I/P/B frames, H.263 and MPEG quant types,
AC/DC prediction, 1MV/4MV, unrestricted MVs (edge emulation via
coordinate clamping), B-frame direct mode.  Not implemented: GMC
sprites, quarter-pel, interlaced tools, data partitioning/RVLC,
short headers, studio profile."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.frame import Frame
from ..core.packet import Packet
from ..io.stream import MediaType
from ..utils.error import InvalidData, NotSupported
from .codec import Codec, register_decoder
from .bitstream import BitReader
from .vp9.recon_tpu import _Timer
from ..ops.idct import idct8x8
from . import mpeg4_tables as T

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)
ALT_HORIZONTAL = np.array([
    0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63],
    np.int32)
ALT_VERTICAL = np.array([
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63],
    np.int32)

DC_THRESHOLD = [99, 13, 15, 17, 19, 21, 23, 0]
CHROMA_ROUNDTAB = [0, 0, 0, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1]
QUANT_TAB = [-1, -2, 1, 2]

RL_INTRA_LAST = 67
RL_INTER_LAST = 58


def _mk_lut(codes, bits):
    """(code, nbits) arrays → dict mapping (nbits, code) → symbol."""
    lut = {}
    for i, (c, b) in enumerate(zip(codes, bits)):
        lut[(int(b), int(c))] = i
    return lut


def _vlc(br: BitReader, lut, maxbits=16):
    code = 0
    for n in range(1, maxbits + 1):
        code = (code << 1) | br.get(1)
        if (n, code) in lut:
            return lut[(n, code)]
    raise InvalidData("mpeg4: bad vlc")


_INTRA_MCBPC = _mk_lut(T.INTRA_MCBPC_CODE, T.INTRA_MCBPC_BITS)
_INTER_MCBPC = _mk_lut(T.INTER_MCBPC_CODE, T.INTER_MCBPC_BITS)
_CBPY = _mk_lut(T.CBPY_TAB[:, 0], T.CBPY_TAB[:, 1])
_MV = _mk_lut(T.MVTAB[:, 0], T.MVTAB[:, 1])
_DC_LUM = _mk_lut(T.DCTAB_LUM[:, 0], T.DCTAB_LUM[:, 1])
_DC_CHROM = _mk_lut(T.DCTAB_CHROM[:, 0], T.DCTAB_CHROM[:, 1])
_RL_INTRA = _mk_lut(T.INTRA_VLC[:, 0], T.INTRA_VLC[:, 1])
_RL_INTER = _mk_lut(T.INTER_VLC[:, 0], T.INTER_VLC[:, 1])


def _rl_limits(run_tab, level_tab, last_n):
    """→ (max_level[2][64], max_run[2][64]) like ff_rl_init."""
    max_level = np.zeros((2, 64), np.int32)
    max_run = np.zeros((2, 64), np.int32)
    for i in range(len(run_tab)):
        last = 1 if i >= last_n else 0
        run = int(run_tab[i])
        level = int(level_tab[i])
        if level > max_level[last][run]:
            max_level[last][run] = level
        if run > max_run[last][level]:
            max_run[last][level] = run
    return max_level, max_run


_INTRA_MAXLEV, _INTRA_MAXRUN = _rl_limits(T.INTRA_RUN, T.INTRA_LEVEL,
                                          RL_INTRA_LAST)
_INTER_MAXLEV, _INTER_MAXRUN = _rl_limits(T.INTER_RUN, T.INTER_LEVEL,
                                          RL_INTER_LAST)


def _get_xbits(br: BitReader, n: int) -> int:
    """ffmpeg get_xbits: n-bit value; MSB 0 means negative
    (one's-complement style)."""
    if n == 0:
        return 0
    v = br.get(n)
    if v >> (n - 1):
        return v
    return -((~v) & ((1 << n) - 1))


def _mid_pred(a, b, c):
    if a > b:
        if c > b:
            c = min(a, c)
        else:
            c = b
    else:
        if b > c:
            c = max(a, c)
        else:
            c = b
    return c


def _cdiv(a, b):
    """C integer division (truncate toward zero)."""
    q = abs(a) // b
    return -q if a < 0 else q


@dataclass
class _Vol:
    width: int = 0
    height: int = 0
    time_base_den: int = 1          # time increment resolution
    time_increment_bits: int = 1
    quant_precision: int = 5
    mpeg_quant: int = 0
    quarter_sample: int = 0
    resync_marker: int = 0
    data_partitioning: int = 0
    low_delay: int = 1
    intra_matrix: np.ndarray = None
    inter_matrix: np.ndarray = None
    vol_control: int = 0
    vo_type: int = 0


@dataclass
class _Vop:
    pict_type: str = "I"            # I/P/B/S
    qscale: int = 1
    f_code: int = 1
    b_code: int = 1
    no_rounding: int = 0
    intra_dc_threshold: int = 99
    time: int = 0


class _FrameState:
    """per-frame prediction state (dc/ac/motion grids with the
    reference's border geometry)."""

    def __init__(self, mb_w, mb_h):
        self.mb_w = mb_w
        self.mb_h = mb_h
        self.mb_stride = mb_w + 1
        self.b8_stride = 2 * mb_w + 1
        y_size = self.b8_stride * (2 * mb_h + 1)
        c_size = self.mb_stride * (mb_h + 1)
        yc_size = y_size + 2 * c_size
        self.dc_base = np.full(yc_size + self.b8_stride + 1, 1024,
                               np.int32)
        self.dc_off = self.b8_stride + 1
        self.ac_base = np.zeros((yc_size + self.b8_stride + 1, 16),
                                np.int32)
        self.motion = np.zeros((y_size + self.b8_stride + 1, 2),
                               np.int32)
        self.mot_off = self.b8_stride + 1
        self.qscale_table = np.zeros(self.mb_stride * (mb_h + 1),
                                     np.int32)
        self.mbintra = np.zeros(self.mb_stride * (mb_h + 1), np.int32)
        self.mbskip = np.zeros(self.mb_stride * (mb_h + 1), np.int32)
        self.mb_type8 = np.zeros(self.mb_stride * (mb_h + 1),
                                 np.int32)   # 1 if colocated 8x8

    def block_index(self, mb_x, mb_y):
        b8 = self.b8_stride
        ms = self.mb_stride
        mh = self.mb_h
        return [
            b8 * (mb_y * 2) - 2 + mb_x * 2,
            b8 * (mb_y * 2) - 1 + mb_x * 2,
            b8 * (mb_y * 2 + 1) - 2 + mb_x * 2,
            b8 * (mb_y * 2 + 1) - 1 + mb_x * 2,
            ms * (mb_y + 1) + b8 * mh * 2 + mb_x - 1,
            ms * (mb_y + mh + 2) + b8 * mh * 2 + mb_x - 1,
        ]

    # fixed +2 offset used by ff_update_block_index before each MB
    def bidx(self, mb_x, mb_y):
        bi = self.block_index(mb_x, mb_y)
        return [bi[0] + 2, bi[1] + 2, bi[2] + 2, bi[3] + 2,
                bi[4] + 1, bi[5] + 1]

    def dc(self, idx):
        return self.dc_base[self.dc_off + idx]

    def set_dc(self, idx, v):
        self.dc_base[self.dc_off + idx] = v

    def ac(self, idx):
        return self.ac_base[self.dc_off + idx]

    def mot(self, idx):
        return self.motion[self.mot_off + idx]


BLOCK_WRAP = None  # per-instance


class _Pic:
    def __init__(self, planes, vop, fs):
        self.planes = planes            # list of 3 uint8 arrays
        self.vop = vop
        self.fs = fs                    # _FrameState (for B direct)


def _hpel(ref, sx, sy, dxy, h, w, rnd):
    """half-pel sample of an hxw block at integer pos (sx, sy) with
    subpel flags dxy (bit0 x half, bit1 y half); coordinates clamp to
    the picture (emulated_edge_mc semantics).  rnd=0 → +1 rounding
    (put_pixels), rnd=1 → no rounding (put_no_rnd)."""
    H, W = ref.shape
    ys = np.clip(np.arange(sy, sy + h + 1), 0, H - 1)
    xs = np.clip(np.arange(sx, sx + w + 1), 0, W - 1)
    a = ref[np.ix_(ys[:h], xs[:w])].astype(np.int32)
    if dxy == 0:
        return a
    if dxy == 1:
        b = ref[np.ix_(ys[:h], xs[1:w + 1])].astype(np.int32)
        return (a + b + 1 - rnd) >> 1
    if dxy == 2:
        b = ref[np.ix_(ys[1:h + 1], xs[:w])].astype(np.int32)
        return (a + b + 1 - rnd) >> 1
    b = ref[np.ix_(ys[:h], xs[1:w + 1])].astype(np.int32)
    c = ref[np.ix_(ys[1:h + 1], xs[:w])].astype(np.int32)
    d = ref[np.ix_(ys[1:h + 1], xs[1:w + 1])].astype(np.int32)
    return (a + b + c + d + 2 - 2 * rnd) >> 2


@register_decoder
class Mpeg4Decoder(Codec):
    codec_id = "mpeg4"
    codec_type = MediaType.VIDEO

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        self.stats: Optional[list] = None
        self.vol = _Vol()
        self.last_pic: Optional[_Pic] = None   # forward ref
        self.next_pic: Optional[_Pic] = None   # backward ref (next P)
        self.time = 0
        self.time_base = 0
        self.last_time_base = 0
        self.last_non_b_time = 0
        self.pp_time = 0
        self.pb_time = 0
        self.picture_number = 0
        self._pending: List[Frame] = []
        self._reorder: List[Tuple[int, Frame]] = []
        if par.extradata:
            try:
                self._parse_headers(BitReader(par.extradata),
                                    par.extradata)
            except Exception:
                pass

    # ---- headers --------------------------------------------------------

    def _parse_vol(self, br: BitReader):
        v = self.vol
        br.get(1)                       # random accessible
        v.vo_type = br.get(8)
        if br.get(1):                   # is_object_layer_identifier
            vo_ver_id = br.get(4)
            br.get(3)
        else:
            vo_ver_id = 1
        ar = br.get(4)
        if ar == 15:
            br.get(8)
            br.get(8)
        v.vol_control = br.get(1)
        if v.vol_control:
            br.get(2)                   # chroma format
            v.low_delay = br.get(1)
            if br.get(1):               # vbv
                br.get(15); br.get(1)
                br.get(15); br.get(1)
                br.get(15); br.get(1)
                br.get(3); br.get(11); br.get(1)
                br.get(15); br.get(1)
        else:
            if self.picture_number == 0:
                v.low_delay = 1 if v.vo_type in (1, 17) else 0
        shape = br.get(2)
        if shape != 0:
            raise NotSupported("mpeg4: non-rectangular shape")
        br.get(1)                       # marker
        v.time_base_den = br.get(16)
        if not v.time_base_den:
            raise InvalidData("mpeg4: framerate 0")
        v.time_increment_bits = max(
            1, (v.time_base_den - 1).bit_length())
        br.get(1)
        if br.get(1):                   # fixed_vop_rate
            br.get(v.time_increment_bits)
        br.get(1)
        v.width = br.get(13)
        br.get(1)
        v.height = br.get(13)
        br.get(1)
        progressive = br.get(1) ^ 1
        if not progressive:
            raise NotSupported("mpeg4: interlaced")
        br.get(1)                       # obmc disable
        sprite = br.get(1) if vo_ver_id == 1 else br.get(2)
        if sprite:
            raise NotSupported("mpeg4: sprites/GMC")
        if br.get(1):                   # not_8_bit
            v.quant_precision = br.get(4)
            br.get(4)
            if not (3 <= v.quant_precision <= 9):
                v.quant_precision = 5
        else:
            v.quant_precision = 5
        v.mpeg_quant = br.get(1)
        if v.mpeg_quant:
            v.intra_matrix = T.DEFAULT_INTRA_MATRIX.astype(
                np.int32).copy()
            v.inter_matrix = T.DEFAULT_NON_INTRA_MATRIX.astype(
                np.int32).copy()
            for which in (0, 1):
                if br.get(1):
                    mat = np.zeros(64, np.int32)
                    last = 0
                    i = 0
                    while i < 64:
                        val = br.get(8)
                        if val == 0:
                            break
                        last = val
                        mat[ZIGZAG[i]] = val
                        i += 1
                    for j in range(i, 64):
                        mat[ZIGZAG[j]] = last
                    if which == 0:
                        v.intra_matrix = mat
                    else:
                        v.inter_matrix = mat
        if vo_ver_id != 1:
            v.quarter_sample = br.get(1)
            if v.quarter_sample:
                raise NotSupported("mpeg4: quarter-pel")
        if not br.get(1):               # complexity estimation
            raise NotSupported("mpeg4: complexity estimation header")
        v.resync_marker = not br.get(1)
        v.data_partitioning = br.get(1)
        if v.data_partitioning:
            raise NotSupported("mpeg4: data partitioning")
        if vo_ver_id != 1:
            if br.get(1):
                raise NotSupported("mpeg4: newpred")
            if br.get(1):
                raise NotSupported("mpeg4: reduced res")
        if br.get(1):
            raise NotSupported("mpeg4: scalability")

    def _parse_vop(self, br: BitReader) -> Optional[_Vop]:
        v = self.vol
        vop = _Vop()
        vop.pict_type = "IPBS"[br.get(2)]
        time_incr = 0
        while br.get(1):
            time_incr += 1
        br.get(1)
        time_increment = br.get(v.time_increment_bits)
        if vop.pict_type != "B":
            self.last_time_base = self.time_base
            self.time_base += time_incr
            self.time = self.time_base * v.time_base_den + \
                time_increment
            self.pp_time = self.time - self.last_non_b_time
            self.last_non_b_time = self.time
        else:
            self.time = (self.last_time_base + time_incr) * \
                v.time_base_den + time_increment
            self.pb_time = self.pp_time - \
                (self.last_non_b_time - self.time)
            if self.pp_time <= self.pb_time or \
                    self.pp_time <= self.pp_time - self.pb_time or \
                    self.pp_time <= 0:
                return None
        vop.time = self.time
        br.get(1)
        if not br.get(1):               # vop_coded
            return None
        if vop.pict_type in ("P", "S"):
            vop.no_rounding = br.get(1)
        vop.intra_dc_threshold = DC_THRESHOLD[br.get(3)]
        vop.qscale = br.get(v.quant_precision)
        if vop.qscale == 0:
            raise InvalidData("mpeg4: qscale 0")
        if vop.pict_type != "I":
            vop.f_code = br.get(3)
            if vop.f_code == 0:
                raise InvalidData("mpeg4: f_code 0")
        if vop.pict_type == "B":
            vop.b_code = br.get(3)
            if vop.b_code == 0:
                raise InvalidData("mpeg4: b_code 0")
        return vop

    def _parse_headers(self, br: BitReader, data: bytes):
        """walk start codes up to (and excluding) the first VOP."""
        pos = 0
        while pos + 4 <= len(data):
            if data[pos:pos + 3] == b"\x00\x00\x01":
                sc = data[pos + 3]
                if 0x20 <= sc <= 0x2F:      # VOL
                    sub = BitReader(data[pos + 4:])
                    self._parse_vol(sub)
                elif sc == 0xB6:            # VOP
                    return pos
                pos += 4
            else:
                pos += 1
        return None

    # ---- MB layer -------------------------------------------------------

    def _decode_motion(self, br: BitReader, pred: int,
                       f_code: int) -> int:
        code = _vlc(br, _MV)
        if code == 0:
            return pred
        sign = br.get(1)
        shift = f_code - 1
        val = code
        if shift:
            val = ((val - 1) << shift) | br.get(shift)
            val += 1
        if sign:
            val = -val
        val += pred
        # modulo decoding: sign_extend(val, 5 + f_code)
        bits = 5 + f_code
        mask = (1 << bits) - 1
        val &= mask
        if val >> (bits - 1):
            val -= 1 << bits
        return val

    def _pred_motion(self, fs: _FrameState, mb_x, mb_y, block):
        """ff_h263_pred_motion → (pred_x, pred_y, mot index)."""
        wrap = fs.b8_stride
        off = [2, 1, 1, -1]
        bi = fs.bidx(mb_x, mb_y)
        xy = bi[block]
        A = fs.mot(xy - 1)
        first_line = mb_y == 0
        if first_line and block < 3:
            if block == 0:
                if mb_x == 0:
                    return 0, 0, xy
                px, py = int(A[0]), int(A[1])
            elif block == 1:
                px, py = int(A[0]), int(A[1])
            else:   # block 2
                B = fs.mot(xy - wrap)
                C = fs.mot(xy + off[block] - wrap)
                if mb_x == 0:
                    A[0] = A[1] = 0
                px = _mid_pred(int(A[0]), int(B[0]), int(C[0]))
                py = _mid_pred(int(A[1]), int(B[1]), int(C[1]))
        else:
            B = fs.mot(xy - wrap)
            C = fs.mot(xy + off[block] - wrap)
            px = _mid_pred(int(A[0]), int(B[0]), int(C[0]))
            py = _mid_pred(int(A[1]), int(B[1]), int(C[1]))
        return px, py, xy

    def _pred_dc(self, fs: _FrameState, mb_x, mb_y, n, bi):
        wrap = fs.b8_stride if n < 4 else fs.mb_stride
        idx = bi[n]
        a = int(fs.dc(idx - 1))
        b = int(fs.dc(idx - 1 - wrap))
        c = int(fs.dc(idx - wrap))
        if mb_y == 0 and n != 3:
            if n != 2:
                b = c = 1024
            if n != 1 and mb_x == 0:
                b = a = 1024
        if mb_x == 0 and mb_y == 1:
            if n in (0, 4, 5):
                b = 1024
        if abs(a - b) < abs(b - c):
            return c, 1
        return a, 0

    def _decode_dc(self, br: BitReader, n: int) -> Tuple[int, int]:
        lut = _DC_LUM if n < 4 else _DC_CHROM
        code = _vlc(br, lut)
        if code == 0:
            level = 0
        else:
            level = _get_xbits(br, code)
            if code > 8:
                br.get(1)               # marker
        return level, code

    def _get_level_dc(self, fs, bi, n, pred, level, y_scale, c_scale):
        scale = y_scale if n < 4 else c_scale
        pred = (pred + (scale >> 1)) // scale
        level += pred
        ret = level
        level *= scale
        if level & ~2047:
            level = 0 if level < 0 else 2047
        fs.set_dc(bi[n], level)
        return ret

    def _decode_block(self, br: BitReader, vol, vop, fs, bi, mb_x,
                      mb_y, n, coded, intra, use_dc_vlc, scan,
                      ac_pred, dir_, qscale, blocks64):
        """→ last index; fills blocks64 (64,) int32 in RASTER order
        for intra pre-dequant, or dequantized for inter h263."""
        block = blocks64
        if intra:
            if use_dc_vlc:
                level, _sz = self._decode_dc(br, n)
                pred, dpd = self._pred_dc(fs, mb_x, mb_y, n, bi)
                y_scale = int(T.Y_DC_SCALE[qscale])
                c_scale = int(T.C_DC_SCALE[qscale])
                level = self._get_level_dc(fs, bi, n, pred, level,
                                           y_scale, c_scale)
                block[0] = level
                i = 0
                dc_dir = dpd
            else:
                i = -1
                pred, dc_dir = self._pred_dc(fs, mb_x, mb_y, n, bi)
            lut = _RL_INTRA
            run_tab, lev_tab = T.INTRA_RUN, T.INTRA_LEVEL
            maxlev, maxrun = _INTRA_MAXLEV, _INTRA_MAXRUN
            last_n = RL_INTRA_LAST
            qmul, qadd = 1, 0
        else:
            i = -1
            dc_dir = 0
            if not coded:
                return -1, 0
            lut = _RL_INTER
            run_tab, lev_tab = T.INTER_RUN, T.INTER_LEVEL
            maxlev, maxrun = _INTER_MAXLEV, _INTER_MAXRUN
            last_n = RL_INTER_LAST
            if vol.mpeg_quant:
                qmul, qadd = 1, 0
            else:
                qmul = qscale << 1
                qadd = (qscale - 1) | 1

        if intra and not coded:
            # prediction still applies below
            pass
        else:
            while True:
                idx = _vlc(br, lut)
                if idx == 102:
                    # escapes
                    if br.peek(1) == 0:
                        # first escape
                        br.get(1)
                        idx2 = _vlc(br, lut)
                        if idx2 == 102:
                            raise InvalidData("mpeg4: esc in esc")
                        last = 1 if idx2 >= last_n else 0
                        run = int(run_tab[idx2])
                        lev = int(lev_tab[idx2])
                        lev = lev + int(maxlev[last][run])
                        lev = lev * qmul + qadd
                        sign = br.get(1)
                        level = -lev if sign else lev
                        i += run + 1
                        if last:
                            i += 192
                    elif br.peek(2) == 2:
                        # second escape
                        br.get(2)
                        idx2 = _vlc(br, lut)
                        if idx2 == 102:
                            raise InvalidData("mpeg4: esc in esc")
                        last = 1 if idx2 >= last_n else 0
                        run = int(run_tab[idx2])
                        lev = int(lev_tab[idx2]) * qmul + qadd
                        run_ext = run + 1 + \
                            int(maxrun[last][int(lev_tab[idx2])]) + 1
                        sign = br.get(1)
                        level = -lev if sign else lev
                        i += run_ext
                        if last:
                            i += 192
                    else:
                        # third escape
                        br.get(2)
                        last = br.get(1)
                        run = br.get(6)
                        br.get(1)       # marker
                        lev = br.get(12)
                        if lev >> 11:
                            lev -= 4096
                        br.get(1)       # marker
                        if lev > 0:
                            level = lev * qmul + qadd
                        elif lev < 0:
                            level = lev * qmul - qadd
                        else:
                            level = 0
                        if (level + 2048) & ~4095:
                            level = -2048 if level < 0 else 2047
                        i += run + 1
                        if last:
                            i += 192
                else:
                    last = 1 if idx >= last_n else 0
                    run = int(run_tab[idx])
                    lev = int(lev_tab[idx]) * qmul + qadd
                    sign = br.get(1)
                    level = -lev if sign else lev
                    i += run + 1
                    if last:
                        i += 192
                if i > 62:
                    i -= 192
                    if i & ~63:
                        raise InvalidData("mpeg4: ac overflow")
                    block[scan[i]] = level
                    break
                if i & ~63:
                    raise InvalidData("mpeg4: run overflow")
                block[scan[i]] = level

        if intra:
            if not use_dc_vlc:
                y_scale = int(T.Y_DC_SCALE[qscale])
                c_scale = int(T.C_DC_SCALE[qscale])
                block[0] = self._get_level_dc(fs, bi, n, pred,
                                              int(block[0]),
                                              y_scale, c_scale)
                if i == -1:
                    i = 0
            # AC prediction (ff_mpeg4_pred_ac)
            ac = fs.ac(bi[n])
            wrap16 = (fs.b8_stride if n < 4 else fs.mb_stride)
            if ac_pred:
                qtab = fs.qscale_table
                if dir_ == 0:
                    src = fs.ac(bi[n] - 1)
                    xy = mb_x - 1 + mb_y * fs.mb_stride
                    if mb_x == 0 or qscale == qtab[xy] or n in (1, 3):
                        for k in range(1, 8):
                            block[k * 8] += src[k]
                    else:
                        for k in range(1, 8):
                            p = int(src[k]) * int(qtab[xy])
                            block[k * 8] += _rounded_div(p, qscale)
                else:
                    src = fs.ac(bi[n] - wrap16)
                    xy = mb_x + (mb_y - 1) * fs.mb_stride
                    if mb_y == 0 or qscale == qtab[xy] or n in (2, 3):
                        for k in range(1, 8):
                            block[k] += src[k + 8]
                    else:
                        for k in range(1, 8):
                            p = int(src[k + 8]) * int(qtab[xy])
                            block[k] += _rounded_div(p, qscale)
            for k in range(1, 8):
                ac[k] = block[k * 8]
                ac[8 + k] = block[k]
            if ac_pred:
                i = 63
        return i, dc_dir


def _rounded_div(a, b):
    """ROUNDED_DIV: (a >= 0 ? a + b/2 : a - b/2) / b (trunc)."""
    if a >= 0:
        return _cdiv(a + (b >> 1), b)
    return _cdiv(a - (b >> 1), b)


def _clean_intra(fs: _FrameState, bi):
    wrap = fs.b8_stride
    xy = bi[0]
    fs.set_dc(xy, 1024)
    fs.set_dc(xy + 1, 1024)
    fs.set_dc(xy + wrap, 1024)
    fs.set_dc(xy + wrap + 1, 1024)
    fs.set_dc(bi[4], 1024)
    fs.set_dc(bi[5], 1024)
    fs.ac(xy + 1)[:] = 0
    fs.ac(xy + wrap)[:] = 0
    fs.ac(xy + wrap + 1)[:] = 0
    fs.ac(bi[4])[:] = 0
    fs.ac(bi[5])[:] = 0


@dataclass
class _MB:
    intra: int = 0
    skip: int = 0
    mv_type: str = "16x16"         # 16x16 | 8x8
    mv_dir: int = 1                # bit0 fwd, bit1 bwd
    mvs_f: list = field(default_factory=lambda: [(0, 0)] * 4)
    mvs_b: list = field(default_factory=lambda: [(0, 0)] * 4)
    qscale: int = 1
    ac_pred: int = 0
    coeffs: np.ndarray = None      # (6, 64) int32 raster or None
    cbp: int = 0


def _unquant_intra_h263(block, qscale, dc_scale):
    out = block.astype(np.int64)
    qmul = qscale << 1
    qadd = (qscale - 1) | 1
    ac = out.copy()
    ac[0] = 0
    res = np.where(ac > 0, ac * qmul + qadd,
                   np.where(ac < 0, ac * qmul - qadd, 0))
    res[0] = out[0] * dc_scale
    return res


def _unquant_intra_mpeg(block, qscale, dc_scale, matrix):
    out = block.astype(np.int64)
    q2 = qscale << 1
    mag = np.abs(out) * q2 * matrix.astype(np.int64) >> 4
    res = np.where(out < 0, -mag, mag)
    res[0] = out[0] * dc_scale
    return res


def _unquant_inter_mpeg(block, qscale, matrix):
    out = block.astype(np.int64)
    q2 = qscale << 1
    mag = ((np.abs(out) * 2 + 1) * q2 * matrix.astype(np.int64)) >> 5
    res = np.where(out < 0, -mag, np.where(out > 0, mag, 0))
    ssum = int(res.sum()) - 1
    res[63] ^= ssum & 1
    return res


class _Recon:
    """per-frame reconstruction accumulator: the IDCT on `device`, the
    rest on the host.  `stats`, when a list, gets the picture's split
    (the parse timed from `t0`)."""

    def __init__(self, vol, mb_w, mb_h, device, stats=None):
        self.vol = vol
        self.mb_w = mb_w
        self.mb_h = mb_h
        self.mbs: List[_MB] = []
        self.device = device
        self.stats = stats
        self.t0 = time.perf_counter()

    def run(self, vop, fwd: Optional[_Pic], bwd: Optional[_Pic]):
        timer = None
        if self.stats is not None:
            timer = _Timer(self.device)
            timer._t = self.t0
            timer.host_mark("parse")
        mb_w, mb_h = self.mb_w, self.mb_h
        W, H = mb_w * 16, mb_h * 16
        planes = [np.zeros((H, W), np.uint8),
                  np.zeros((H // 2, W // 2), np.uint8),
                  np.zeros((H // 2, W // 2), np.uint8)]
        # batch IDCT of all coded blocks
        all_blocks = []
        for mb in self.mbs:
            if mb.coeffs is not None:
                all_blocks.append(mb.coeffs)
        h2d = 0
        if all_blocks:
            stacked = np.stack(all_blocks).reshape(-1, 8, 8) \
                .astype(np.float32)
            h2d = stacked.nbytes
            if timer is not None:
                timer.dev_mark("idct")
            pix = idct8x8(torch.from_numpy(stacked).to(self.device))
            pix = pix.cpu().numpy().reshape(len(all_blocks), 6, 8, 8)
            if timer is not None:
                timer.dev_mark("done")
                timer.host_mark("idct")
        bidx = 0
        fw = fwd.planes if fwd is not None else planes
        bw = bwd.planes if bwd is not None else planes
        rnd = vop.no_rounding
        for k, mb in enumerate(self.mbs):
            my_, mx_ = divmod(k, mb_w)
            res = None
            if mb.coeffs is not None:
                res = pix[bidx]
                bidx += 1
            self._recon_mb(planes, fw, bw, mb, mx_, my_, res, rnd,
                           vop)
        if timer is not None:
            timer.host_mark("mc")
            self.stats.append({"type": vop.pict_type,
                               "host": dict(timer.host), "h2d_bytes": h2d,
                               "device": timer.device_ms()})
        return planes

    def _pred16(self, ref, mx_, my_, mv, rnd):
        """16x16 luma + 8x8 chroma prediction → (y16, u8, v8)."""
        mx, my = mv
        sx = mx_ * 16 + (mx >> 1)
        sy = my_ * 16 + (my >> 1)
        dxy = (mx & 1) | ((my & 1) << 1)
        y = _hpel(ref[0], sx, sy, dxy, 16, 16, rnd)
        uvdxy = dxy | (my & 2) | ((mx & 2) >> 1)
        u = _hpel(ref[1], sx >> 1, sy >> 1, uvdxy, 8, 8, rnd)
        v = _hpel(ref[2], sx >> 1, sy >> 1, uvdxy, 8, 8, rnd)
        return y, u, v

    def _pred8x8(self, ref, mx_, my_, mvs, rnd, width, height):
        y = np.zeros((16, 16), np.int32)
        sumx = sumy = 0
        for i in range(4):
            mx, my = mvs[i]
            sumx += mx
            sumy += my
            src_x = mx_ * 16 + (i & 1) * 8
            src_y = my_ * 16 + (i >> 1) * 8
            sx = src_x + (mx >> 1)
            sy = src_y + (my >> 1)
            # hpel_motion clip semantics
            sx = max(-16, min(width, sx))
            dxy = 0
            if sx != width:
                dxy |= mx & 1
            sy = max(-16, min(height, sy))
            if sy != height:
                dxy |= (my & 1) << 1
            blk = _hpel(ref[0], sx, sy, dxy, 8, 8, rnd)
            y[(i >> 1) * 8:(i >> 1) * 8 + 8,
              (i & 1) * 8:(i & 1) * 8 + 8] = blk
        # chroma from rounded average (chroma_4mv_motion)
        cmx = CHROMA_ROUNDTAB[sumx & 0xF] + (sumx >> 3)
        cmy = CHROMA_ROUNDTAB[sumy & 0xF] + (sumy >> 3)
        dxy = ((cmy & 1) << 1) | (cmx & 1)
        csx = mx_ * 8 + (cmx >> 1)
        csy = my_ * 8 + (cmy >> 1)
        csx = max(-8, min(width >> 1, csx))
        if csx == width >> 1:
            dxy &= ~1
        csy = max(-8, min(height >> 1, csy))
        if csy == height >> 1:
            dxy &= ~2
        u = _hpel(ref[1], csx, csy, dxy, 8, 8, rnd)
        v = _hpel(ref[2], csx, csy, dxy, 8, 8, rnd)
        return y, u, v

    def _recon_mb(self, planes, fw, bw, mb, mx_, my_, res, rnd, vop):
        vol = self.vol
        W = self.mb_w * 16
        H = self.mb_h * 16
        ys = slice(my_ * 16, my_ * 16 + 16)
        xs = slice(mx_ * 16, mx_ * 16 + 16)
        cys = slice(my_ * 8, my_ * 8 + 8)
        cxs = slice(mx_ * 8, mx_ * 8 + 8)
        if mb.intra:
            dc_scale_y = int(T.Y_DC_SCALE[mb.qscale])
            dc_scale_c = int(T.C_DC_SCALE[mb.qscale])
            # res already IDCT'd from dequantized coeffs
            y = np.clip(np.round(
                np.block([[res[0], res[1]], [res[2], res[3]]])),
                0, 255).astype(np.uint8)
            planes[0][ys, xs] = y
            planes[1][cys, cxs] = np.clip(np.round(res[4]), 0, 255) \
                .astype(np.uint8)
            planes[2][cys, cxs] = np.clip(np.round(res[5]), 0, 255) \
                .astype(np.uint8)
            return
        # prediction
        preds = []
        p_rnd = rnd if (mb.mv_dir == 1 and vop.pict_type != "B") \
            else 0
        if mb.mv_dir & 1:
            if mb.mv_type == "8x8":
                preds.append(self._pred8x8(fw, mx_, my_, mb.mvs_f,
                                           p_rnd, W, H))
            else:
                preds.append(self._pred16(fw, mx_, my_, mb.mvs_f[0],
                                          p_rnd))
        if mb.mv_dir & 2:
            if mb.mv_type == "8x8":
                preds.append(self._pred8x8(bw, mx_, my_, mb.mvs_b,
                                           0, W, H))
            else:
                preds.append(self._pred16(bw, mx_, my_, mb.mvs_b[0],
                                          0))
        if len(preds) == 2:
            y = (preds[0][0] + preds[1][0] + 1) >> 1
            u = (preds[0][1] + preds[1][1] + 1) >> 1
            v = (preds[0][2] + preds[1][2] + 1) >> 1
        else:
            y, u, v = preds[0]
        if res is not None:
            y = y + np.round(
                np.block([[res[0], res[1]],
                          [res[2], res[3]]])).astype(np.int32)
            u = u + np.round(res[4]).astype(np.int32)
            v = v + np.round(res[5]).astype(np.int32)
        planes[0][ys, xs] = np.clip(y, 0, 255).astype(np.uint8)
        planes[1][cys, cxs] = np.clip(u, 0, 255).astype(np.uint8)
        planes[2][cys, cxs] = np.clip(v, 0, 255).astype(np.uint8)


def _mpeg4_decode_frame(dec: "Mpeg4Decoder", br: BitReader,
                        vop: _Vop) -> Tuple[List[np.ndarray],
                                            _FrameState]:
    vol = dec.vol
    mb_w = (vol.width + 15) // 16
    mb_h = (vol.height + 15) // 16
    fs = _FrameState(mb_w, mb_h)
    recon = _Recon(vol, mb_w, mb_h, dec.device, dec.stats)
    qscale = vop.qscale
    last_mvs = [[[0, 0], [0, 0]], [[0, 0], [0, 0]]]  # [dir][i][xy]
    pb, pp = dec.pb_time, dec.pp_time

    nxt_fs = dec.next_pic.fs if dec.next_pic is not None else None

    def set_qscale(q):
        nonlocal qscale
        qscale = max(1, min(31, q))

    for mb_y in range(mb_h):
        if vop.pict_type == "B":
            for d in range(2):
                for i in range(2):
                    last_mvs[d][i][0] = last_mvs[d][i][1] = 0
        for mb_x in range(mb_w):
            bi = fs.bidx(mb_x, mb_y)
            xy = mb_x + mb_y * fs.mb_stride
            mb = _MB()
            mb.qscale = qscale
            blocks = np.zeros((6, 64), np.int32)
            coded_any = False
            if vop.pict_type in ("P", "S"):
                skip = br.get(1)
                if skip:
                    mb.skip = 1
                    mb.mv_dir = 1
                    mb.mvs_f = [(0, 0)] * 4
                    fs.mbskip[xy] = 1
                    recon.mbs.append(mb)
                    _post_mb(fs, bi, xy, mb, qscale)
                    continue
                while True:
                    cbpc = _vlc(br, _INTER_MCBPC)
                    if cbpc != 20:
                        break
                dquant = cbpc & 8
                mb.intra = 1 if (cbpc & 4) else 0
                if not mb.intra:
                    cbpy = _vlc(br, _CBPY) ^ 0x0F
                    cbp = (cbpc & 3) | (cbpy << 2)
                    if dquant:
                        set_qscale(qscale +
                                   QUANT_TAB[br.get(2)])
                    mb.qscale = qscale
                    if (cbpc & 16) == 0:
                        mb.mv_type = "16x16"
                        px, py, mot = self_pred = \
                            dec._pred_motion(fs, mb_x, mb_y, 0)
                        mx = dec._decode_motion(br, px, vop.f_code)
                        my = dec._decode_motion(br, py, vop.f_code)
                        mb.mvs_f = [(mx, my)] * 4
                    else:
                        mb.mv_type = "8x8"
                        mvs = []
                        for i in range(4):
                            px, py, mot = dec._pred_motion(
                                fs, mb_x, mb_y, i)
                            mx = dec._decode_motion(br, px,
                                                    vop.f_code)
                            my = dec._decode_motion(br, py,
                                                    vop.f_code)
                            mvs.append((mx, my))
                            m = fs.mot(mot)
                            m[0] = mx
                            m[1] = my
                        mb.mvs_f = mvs
                        fs.mb_type8[xy] = 1
                    # inter blocks
                    scan = ZIGZAG
                    for i in range(6):
                        if cbp & (32 >> i):
                            dec._decode_block(
                                br, vol, vop, fs, bi, mb_x, mb_y, i,
                                1, 0, 0, scan, 0, 0, qscale,
                                blocks[i])
                            coded_any = True
                    mb.cbp = cbp
                    if vol.mpeg_quant and coded_any:
                        for i in range(6):
                            if cbp & (32 >> i):
                                blocks[i] = _unquant_inter_mpeg(
                                    blocks[i], qscale,
                                    vol.inter_matrix)
                    mb.coeffs = blocks if coded_any else None
                    recon.mbs.append(mb)
                    _post_mb(fs, bi, xy, mb, qscale)
                    continue
                # intra in P: fall through to intra path
                cbpc_intra_cbp = cbpc & 3
                mb = _mb_intra(dec, br, vol, vop, fs, bi, mb_x, mb_y,
                               xy, mb, cbpc_intra_cbp, dquant,
                               set_qscale, lambda: qscale)
                recon.mbs.append(mb)
                _post_mb(fs, bi, xy, mb, mb.qscale)
                continue
            elif vop.pict_type == "B":
                if mb_x == 0 and mb_y == 0:
                    pass
                skip_colocated = nxt_fs.mbskip[xy] \
                    if nxt_fs is not None else 0
                if skip_colocated:
                    mb.skip = 1
                    mb.mv_dir = 1
                    mb.mvs_f = [(0, 0)] * 4
                    recon.mbs.append(mb)
                    fs.qscale_table[xy] = qscale
                    continue
                modb1 = br.get(1)
                if modb1:
                    mb_type = "direct"
                    cbp = 0
                else:
                    modb2 = br.get(1)
                    ti = _vlc(br, _mk_mbtypeb())
                    # mb_type_b_map: 0=direct 1=bidir 2=backward
                    # 3=forward
                    mb_type = ("direct", "bidir", "backward",
                               "forward")[ti]
                    cbp = 0 if modb2 else br.get(6)
                    if mb_type != "direct" and cbp:
                        if br.get(1):
                            set_qscale(qscale + br.get(1) * 4 - 2)
                    mb.qscale = qscale
                    mb.mv_dir = 0
                    if mb_type in ("forward", "bidir"):
                        mb.mv_dir |= 1
                        mx = dec._decode_motion(
                            br, last_mvs[0][0][0], vop.f_code)
                        my = dec._decode_motion(
                            br, last_mvs[0][0][1], vop.f_code)
                        last_mvs[0][0][0] = last_mvs[0][1][0] = mx
                        last_mvs[0][0][1] = last_mvs[0][1][1] = my
                        mb.mvs_f = [(mx, my)] * 4
                    if mb_type in ("backward", "bidir"):
                        mb.mv_dir |= 2
                        mx = dec._decode_motion(
                            br, last_mvs[1][0][0], vop.b_code)
                        my = dec._decode_motion(
                            br, last_mvs[1][0][1], vop.b_code)
                        last_mvs[1][0][0] = last_mvs[1][1][0] = mx
                        last_mvs[1][0][1] = last_mvs[1][1][1] = my
                        mb.mvs_b = [(mx, my)] * 4
                if mb_type == "direct":
                    if modb1:
                        dmx = dmy = 0
                    else:
                        dmx = dec._decode_motion(br, 0, 1)
                        dmy = dec._decode_motion(br, 0, 1)
                    mb.mv_dir = 3
                    _set_direct(dec, fs, nxt_fs, mb, mb_x, mb_y,
                                dmx, dmy, pb, pp)
                # blocks
                scan = ZIGZAG
                for i in range(6):
                    if cbp & (32 >> i):
                        dec._decode_block(
                            br, vol, vop, fs, bi, mb_x, mb_y, i, 1,
                            0, 0, scan, 0, 0, qscale, blocks[i])
                        coded_any = True
                if vol.mpeg_quant and coded_any:
                    for i in range(6):
                        if cbp & (32 >> i):
                            blocks[i] = _unquant_inter_mpeg(
                                blocks[i], qscale, vol.inter_matrix)
                mb.coeffs = blocks if coded_any else None
                mb.cbp = cbp
                recon.mbs.append(mb)
                fs.qscale_table[xy] = qscale
                continue
            else:   # I frame
                while True:
                    cbpc = _vlc(br, _INTRA_MCBPC)
                    if cbpc != 8:
                        break
                dquant = cbpc & 4
                mb = _mb_intra(dec, br, vol, vop, fs, bi, mb_x, mb_y,
                               xy, mb, cbpc & 3, dquant, set_qscale,
                               lambda: qscale)
                recon.mbs.append(mb)
                _post_mb(fs, bi, xy, mb, mb.qscale)

    if vop.pict_type == "B":
        planes = recon.run(vop, dec.last_pic, dec.next_pic)
    else:
        planes = recon.run(vop, dec.next_pic, None)
    return planes, fs


_MBTYPEB_LUT = None


def _mk_mbtypeb():
    global _MBTYPEB_LUT
    if _MBTYPEB_LUT is None:
        _MBTYPEB_LUT = _mk_lut(T.MB_TYPE_B_TAB[:, 0],
                               T.MB_TYPE_B_TAB[:, 1])
    return _MBTYPEB_LUT


def _post_mb(fs: _FrameState, bi, xy, mb: _MB, qscale):
    fs.qscale_table[xy] = qscale
    if not mb.intra:
        if fs.mbintra[xy]:
            fs.mbintra[xy] = 0
            _clean_intra(fs, bi)
    else:
        fs.mbintra[xy] = 1
    # ff_h263_update_motion_val (non-B callers only)
    wrap = fs.b8_stride
    idx = bi[0]
    if mb.mv_type != "8x8":
        if mb.intra:
            mvx = mvy = 0
        else:
            mvx, mvy = mb.mvs_f[0]
        for off in (0, 1, wrap, wrap + 1):
            m = fs.mot(idx + off)
            m[0] = mvx
            m[1] = mvy


def _set_direct(dec, fs, nxt_fs, mb: _MB, mb_x, mb_y, dmx, dmy,
                pb, pp):
    """ff_mpeg4_set_direct_mv (progressive colocated only)."""
    if nxt_fs is None:
        mb.mv_type = "16x16"
        mb.mvs_f = [(dmx, dmy)] * 4
        mb.mvs_b = [(0, 0)] * 4
        return
    xy = mb_x + mb_y * nxt_fs.mb_stride
    co8 = nxt_fs.mb_type8[xy]
    bi = nxt_fs.bidx(mb_x, mb_y)

    def scale_one(i):
        m = nxt_fs.mot(bi[i])
        pmx, pmy = int(m[0]), int(m[1])
        fx = _cdiv(pmx * pb, pp) + dmx
        fy = _cdiv(pmy * pb, pp) + dmy
        bx = fx - pmx if dmx else _cdiv(pmx * (pb - pp), pp)
        by = fy - pmy if dmy else _cdiv(pmy * (pb - pp), pp)
        return (fx, fy), (bx, by)

    if co8:
        mb.mv_type = "8x8"
        mvf, mvb = [], []
        for i in range(4):
            f, b = scale_one(i)
            mvf.append(f)
            mvb.append(b)
        mb.mvs_f = mvf
        mb.mvs_b = mvb
    else:
        mb.mv_type = "16x16"
        f, b = scale_one(0)
        mb.mvs_f = [f] * 4
        mb.mvs_b = [b] * 4


def _mb_intra(dec, br, vol, vop, fs, bi, mb_x, mb_y, xy, mb: _MB,
              cbp_c, dquant, set_qscale, get_qscale):
    mb.intra = 1
    mb.ac_pred = br.get(1)
    cbpy = _vlc(br, _CBPY)
    cbp = cbp_c | (cbpy << 2)
    use_dc_vlc = get_qscale() < vop.intra_dc_threshold
    if dquant:
        set_qscale(get_qscale() + QUANT_TAB[br.get(2)])
    qscale = get_qscale()
    mb.qscale = qscale
    fs.qscale_table[xy] = qscale
    blocks = np.zeros((6, 64), np.int32)
    for i in range(6):
        coded = 1 if (cbp & (32 >> i)) else 0
        pred, dc_dir0 = dec._pred_dc(fs, mb_x, mb_y, i, bi)
        scan = (ALT_VERTICAL if dc_dir0 == 0 else ALT_HORIZONTAL) \
            if mb.ac_pred else ZIGZAG
        dec._decode_block(br, vol, vop, fs, bi, mb_x, mb_y, i,
                          coded, 1, use_dc_vlc, scan, mb.ac_pred,
                          dc_dir0, qscale, blocks[i])
    # dequant
    dc_y = int(T.Y_DC_SCALE[qscale])
    dc_c = int(T.C_DC_SCALE[qscale])
    out = np.zeros((6, 64), np.int64)
    for i in range(6):
        dscale = dc_y if i < 4 else dc_c
        if vol.mpeg_quant:
            out[i] = _unquant_intra_mpeg(blocks[i], qscale, dscale,
                                         vol.intra_matrix)
        else:
            out[i] = _unquant_intra_h263(blocks[i], qscale, dscale)
    mb.coeffs = out.astype(np.int32)
    mb.cbp = cbp
    return mb


def _decoder_decode(self, pkt: Optional[Packet]) -> List[Frame]:
    if pkt is None:
        out = []
        if self._next_frame is not None:
            out.append(self._next_frame)
            self._next_frame = None
        return out
    data = bytes(pkt.data)
    frames: List[Frame] = []
    pos = 0
    n = len(data)
    while pos + 4 <= n:
        if data[pos:pos + 3] != b"\x00\x00\x01":
            pos += 1
            continue
        sc = data[pos + 3]
        end = data.find(b"\x00\x00\x01", pos + 4)
        if end < 0:
            end = n
        payload = data[pos + 4:end]
        if 0x20 <= sc <= 0x2F:
            self._parse_vol(BitReader(payload))
        elif sc == 0xB6:
            br = BitReader(payload)
            vop = self._parse_vop(br)
            if vop is not None:
                frames.extend(self._decode_vop(br, vop, pkt))
        pos = end
    return frames


def _decoder_decode_vop(self, br, vop, pkt) -> List[Frame]:
    vol = self.vol
    if not vol.width:
        raise InvalidData("mpeg4: no VOL header")
    planes, fs = _mpeg4_decode_frame(self, br, vop)
    w, h = vol.width, vol.height
    out_planes = _device_planes(planes, w, h, self.device)
    f = Frame.video(w, h, "yuv420p", planes=out_planes, pts=pkt.pts,
                    time_base=pkt.time_base)
    f.pict_type = vop.pict_type
    f.key_frame = vop.pict_type == "I"
    out: List[Frame] = []
    if vop.pict_type in ("I", "P", "S"):
        pic = _Pic(planes, vop, fs)
        self.last_pic = self.next_pic
        self.next_pic = pic
        if vol.low_delay:
            out.append(f)
        else:
            if self._next_frame is not None:
                out.append(self._next_frame)
            self._next_frame = f
    else:
        out.append(f)
    self.picture_number += 1
    return out


def _decoder_flush(self) -> None:
    self.last_pic = self.next_pic = None
    self._next_frame = None
    self.time = self.time_base = 0
    self.last_time_base = self.last_non_b_time = 0


def _device_planes(planes, w, h, device) -> List[torch.Tensor]:
    """The picture's host planes, cropped, as tensors on `device` (the
    host planes stay the reference pictures of the host's MC)."""
    return [torch.from_numpy(np.ascontiguousarray(p)).to(device)
            for p in (planes[0][:h, :w], planes[1][:h // 2, :w // 2],
                      planes[2][:h // 2, :w // 2])]


Mpeg4Decoder.decode = _decoder_decode
Mpeg4Decoder._decode_vop = _decoder_decode_vop
Mpeg4Decoder.flush_state = _decoder_flush
Mpeg4Decoder._next_frame = None


# ---------------------------------------------------------------------------
# H.263 (baseline v1) decoder — reuses the MPEG-4 MB machinery
# (reference: ituh263dec.c; no AC/DC prediction, fixed-size formats,
# inter RL table for intra AC, unquantize applied after parsing)
# ---------------------------------------------------------------------------

# ITU-T H.263 table 6.2 picture formats
H263_FORMATS = [(0, 0), (128, 96), (176, 144), (352, 288),
                (704, 576), (1408, 1152)]


def _h263_decode_block(dec, br, blocks64, n, coded, intra, qscale,
                       scan):
    """h263_decode_block: stores QUANTIZED levels (dequantized
    later)."""
    block = blocks64
    if intra:
        level = br.get(8)
        if level == 255:
            level = 128
        block[0] = level
        i = 1
    else:
        i = 0
    if not coded:
        return i - 1
    i -= 1
    while True:
        idx = _vlc(br, _RL_INTER)
        if idx == 102:
            lastrun = br.get(7)
            last = lastrun >> 6
            run = lastrun & 63
            level = br.get(8)
            if level >= 128:
                level -= 256
            if level == -128:
                low = br.get(5)
                high = br.get(6)
                if high >= 32:
                    high -= 64
                level = (high << 5) | low
            if level == 0:
                raise InvalidData("h263: zero escape level")
            i += run + 1
        else:
            last = 1 if idx >= RL_INTER_LAST else 0
            run = int(T.INTER_RUN[idx])
            level = int(T.INTER_LEVEL[idx])
            if br.get(1):
                level = -level
            i += run + 1
        if i > 63:
            raise InvalidData("h263: ac overflow")
        block[scan[i]] = level
        if last:
            break
    return i


def _h263_unquant(block, qscale, intra):
    out = block.astype(np.int64)
    qmul = qscale << 1
    qadd = (qscale - 1) | 1
    ac = out.copy()
    if intra:
        ac[0] = 0
    res = np.where(ac > 0, ac * qmul + qadd,
                   np.where(ac < 0, ac * qmul - qadd, 0))
    if intra:
        res[0] = out[0] * 8          # fixed DC scale
    return res


@register_decoder
class H263Decoder(Codec):
    codec_id = "h263"
    codec_type = MediaType.VIDEO

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        self.stats: Optional[list] = None
        self.width = 0
        self.height = 0
        self.last_planes = None

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        br = BitReader(bytes(pkt.data))
        # picture start code: 22 bits 0000 0000 0000 0000 1 00000
        if br.get(17) != 1 or br.get(5) != 0:
            raise InvalidData("h263: bad start code")
        br.get(8)                       # temporal reference
        if br.get(1) != 1:
            raise InvalidData("h263: PTYPE marker")
        if br.get(1):
            raise InvalidData("h263: bad id bit")
        br.get(3)                       # split/camera/freeze
        fmt = br.get(3)
        if fmt in (6, 7):
            raise NotSupported("h263: H.263+ headers")
        w, h = H263_FORMATS[fmt]
        if not w:
            raise InvalidData("h263: forbidden format")
        self.width, self.height = w, h
        pict_type = "I" if br.get(1) == 0 else "P"
        if br.get(1):
            raise NotSupported("h263: long vectors")
        if br.get(1):
            raise NotSupported("h263: SAC")
        if br.get(1):
            raise NotSupported("h263: OBMC")
        if br.get(1):
            raise NotSupported("h263: PB frames")
        qscale = br.get(5)
        br.get(1)                       # CPM
        while br.get(1):                # PEI/PSPARE
            br.get(8)
        planes = self._decode_picture(br, pict_type, qscale)
        f = Frame.video(w, h, "yuv420p",
                        planes=_device_planes(planes, w, h, self.device),
                        pts=pkt.pts, time_base=pkt.time_base)
        f.pict_type = pict_type
        f.key_frame = pict_type == "I"
        self.last_planes = planes
        return [f]

    def _decode_picture(self, br, pict_type, qscale):
        mb_w = (self.width + 15) // 16
        mb_h = (self.height + 15) // 16
        fs = _FrameState(mb_w, mb_h)
        vol = _Vol(width=self.width, height=self.height)
        vop = _Vop(pict_type=pict_type, qscale=qscale)
        recon = _Recon(vol, mb_w, mb_h, self.device, self.stats)
        dec4 = Mpeg4Decoder.__new__(Mpeg4Decoder)  # reuse helpers
        dec4.vol = vol
        for mb_y in range(mb_h):
            for mb_x in range(mb_w):
                bi = fs.bidx(mb_x, mb_y)
                xy = mb_x + mb_y * fs.mb_stride
                mb = _MB()
                mb.qscale = qscale
                blocks = np.zeros((6, 64), np.int32)
                if pict_type == "P":
                    if br.get(1):
                        mb.skip = 1
                        mb.mvs_f = [(0, 0)] * 4
                        recon.mbs.append(mb)
                        _post_mb(fs, bi, xy, mb, qscale)
                        continue
                    while True:
                        cbpc = _vlc(br, _INTER_MCBPC)
                        if cbpc != 20:
                            break
                    dquant = cbpc & 8
                    mb.intra = 1 if (cbpc & 4) else 0
                    if not mb.intra:
                        cbpy = _vlc(br, _CBPY) ^ 0x0F
                        cbp = (cbpc & 3) | (cbpy << 2)
                        if dquant:
                            qscale = max(1, min(31, qscale +
                                                QUANT_TAB[br.get(2)]))
                        mb.qscale = qscale
                        if (cbpc & 16) == 0:
                            px, py, _m = dec4._pred_motion(
                                fs, mb_x, mb_y, 0)
                            mx = dec4._decode_motion(br, px, 1)
                            my = dec4._decode_motion(br, py, 1)
                            mb.mvs_f = [(mx, my)] * 4
                        else:
                            mb.mv_type = "8x8"
                            mvs = []
                            for i in range(4):
                                px, py, mot = dec4._pred_motion(
                                    fs, mb_x, mb_y, i)
                                mx = dec4._decode_motion(br, px, 1)
                                my = dec4._decode_motion(br, py, 1)
                                mvs.append((mx, my))
                                m = fs.mot(mot)
                                m[0] = mx
                                m[1] = my
                            mb.mvs_f = mvs
                        coded_any = False
                        for i in range(6):
                            if cbp & (32 >> i):
                                _h263_decode_block(
                                    dec4, br, blocks[i], i, 1, 0,
                                    qscale, ZIGZAG)
                                coded_any = True
                        if coded_any:
                            out = np.zeros((6, 64), np.int64)
                            for i in range(6):
                                out[i] = _h263_unquant(
                                    blocks[i], qscale, False)
                            mb.coeffs = out.astype(np.int32)
                        recon.mbs.append(mb)
                        _post_mb(fs, bi, xy, mb, qscale)
                        continue
                else:
                    while True:
                        cbpc = _vlc(br, _INTRA_MCBPC)
                        if cbpc != 8:
                            break
                    dquant = cbpc & 4
                    mb.intra = 1
                # intra path (I frame, or intra in P)
                mb.intra = 1
                cbpy = _vlc(br, _CBPY)
                cbp = (cbpc & 3) | (cbpy << 2)
                if dquant:
                    qscale = max(1, min(31, qscale +
                                        QUANT_TAB[br.get(2)]))
                mb.qscale = qscale
                for i in range(6):
                    coded = 1 if (cbp & (32 >> i)) else 0
                    _h263_decode_block(dec4, br, blocks[i], i,
                                       coded, 1, qscale, ZIGZAG)
                out = np.zeros((6, 64), np.int64)
                for i in range(6):
                    out[i] = _h263_unquant(blocks[i], qscale, True)
                mb.coeffs = out.astype(np.int32)
                recon.mbs.append(mb)
                _post_mb(fs, bi, xy, mb, qscale)
        last = _Pic(self.last_planes, vop, None) \
            if self.last_planes is not None else None
        return recon.run(vop, last, None)

    def flush_state(self):
        self.last_planes = None
