"""CABAC slice data coding (ITU-T H.264 §9.3; reference:
libavcodec/h264_cabac.c).

One syntax walker serves both directions: with a CabacDecoder it parses
a slice into MB descriptors; with a CabacEncoder plus per-MB intents it
produces a conformant bitstream (used by the test harness — the
reference decoder cross-validates both directions). Reconstruction
reuses the exact-integer recon/inter helpers of the CAVLC path.

The port's copy of ffmpeg_tpu/codecs/h264/cabac_slice.py, held equal to it by
tests/test_torch_h264_host.py."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ...utils.error import InvalidData, NotSupported
from . import recon
from . import tables as T
from .cabac import CabacDecoder, CabacEncoder, init_contexts
from .cabac_tables import CONTEXT_INIT_I, CONTEXT_INIT_PB
from .slice_dec import _BLK_XY, SliceDecoder

# residual categories: 0 luma DC, 1 luma AC, 2 luma 4x4, 3 chroma DC,
# 4 chroma AC, 5 luma 8x8 — context base offsets (frame coding).
# Cat 5 has no coded_block_flag (inferred from cbp, spec 9.3.3.1.1.9)
# and its sig/last contexts are position-class maps (Table 9-43).
_CBF_BASE = [85, 89, 93, 97, 101]
_SIG_BASE = [105, 105 + 15, 105 + 29, 105 + 44, 105 + 47, 402]
_LAST_BASE = [166, 166 + 15, 166 + 29, 166 + 44, 166 + 47, 417]
_ABS_BASE = [227, 227 + 10, 227 + 20, 227 + 30, 227 + 39, 426]
# scan position -> ctx increment for the 8x8 significance map
# (frame-coded; spec Table 9-43 / h264_cabac.c sig/last offset tables)
_SIG8 = [0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
         4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
         7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
         12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12]
_LAST8 = [0] + [1] * 15 + [2] * 16 + [3] * 8 + [4] * 8 + [5] * 4 + \
    [6] * 4 + [7] * 4 + [8] * 3


def _sig_ctx(cat, pos):
    return _SIG_BASE[cat] + (_SIG8[pos] if cat == 5 else pos)


def _last_ctx(cat, pos):
    return _LAST_BASE[cat] + (_LAST8[pos] if cat == 5 else pos)
_LEVEL1_CTX = [1, 2, 3, 4, 0, 0, 0, 0]
_LEVELGT1_CTX = [5, 5, 5, 5, 6, 7, 8, 9]
_LEVEL_TRANS = [[1, 2, 3, 3, 4, 5, 6, 7], [4, 4, 4, 4, 5, 6, 7, 7]]


class _IO:
    """Unified decode/encode front-end over the arithmetic core."""

    def __init__(self, core, encode: bool):
        self.core = core
        self.encode = encode

    def dec(self, ctx, v: Optional[int] = None) -> int:
        if self.encode:
            self.core.decision(ctx, v)
            return v
        return self.core.decision(ctx)

    def byp(self, v: Optional[int] = None) -> int:
        if self.encode:
            self.core.bypass(v)
            return v
        return self.core.bypass()

    def term(self, v: Optional[int] = None) -> int:
        if self.encode:
            self.core.terminate(v)
            return v
        return self.core.terminate()


class CabacSliceCoder:
    """Walks CABAC slice data over a SliceDecoder's state."""

    def __init__(self, dec: SliceDecoder, core, slice_type: int,
                 qp: int, cabac_init_idc: int = 0, encode: bool = False):
        self.dec = dec
        self.io = _IO(core, encode)
        self.slice_type = slice_type
        table = CONTEXT_INIT_I if slice_type == 2 \
            else CONTEXT_INIT_PB[cabac_init_idc]
        self.ctx = init_contexts(table, qp)
        self.qp = qp
        self.last_dqp = 0
        nmbx, nmby = dec.sps.mb_width, dec.sps.mb_height
        # per-MB caches mirroring the reference's cbp_table etc.
        self.cbp_tab = np.zeros((nmby, nmbx), np.int32)
        self.chroma_mode_tab = np.zeros((nmby, nmbx), np.int32)
        self.skip_tab = np.zeros((nmby, nmbx), bool)
        self.i16_tab = np.zeros((nmby, nmbx), bool)
        self.i4x4_tab = np.zeros((nmby, nmbx), bool)
        self.direct_tab = np.zeros((nmby, nmbx), bool)
        self.mvd_cache = np.zeros((2, nmby * 4, nmbx * 4, 2),
                                  np.int32)
        # 4x4 blocks of the current MB whose ref_idx is already parsed
        # (the ref context must see earlier same-MB partitions)
        self._ref_set = set()

    # --- neighbor helpers --------------------------------------------------------
    def _mb_ok(self, mbx, mby):
        if mbx < 0 or mby < 0 or mbx >= self.dec.sps.mb_width:
            return False
        return bool(self.dec.mb_avail[mby, mbx])

    def _nbr_cbp(self, mbx, mby, intra_cur):
        """left_cbp/top_cbp analog: 0xF low nibble when unavailable."""
        if not self._mb_ok(mbx, mby):
            return 0x7CF if intra_cur else 0x00F
        return int(self.cbp_tab[mby, mbx])

    # --- syntax elements ----------------------------------------------------------
    def mb_skip_flag(self, mbx, mby, v=None):
        ctx = 0
        if self._mb_ok(mbx - 1, mby) and not self.skip_tab[mby, mbx - 1]:
            ctx += 1
        if self._mb_ok(mbx, mby - 1) and not self.skip_tab[mby - 1, mbx]:
            ctx += 1
        base = 24 if self.slice_type == 1 else 11
        return self.io.dec(self.ctx[base + ctx], v)

    def intra_mb_type(self, mbx, mby, base, intra_slice, v=None):
        """v = (is16, cbp_luma15, cbp_chroma, pred_mode) when encoding;
        returns same tuple. I_PCM unsupported in CABAC path."""
        if intra_slice:
            ctx = 0
            for dx, dy in ((-1, 0), (0, -1)):
                if self._mb_ok(mbx + dx, mby + dy) and \
                        self.i16_tab[mby + dy, mbx + dx]:
                    ctx += 1
            first = self.ctx[base + ctx]
            off = 2
        else:
            first = self.ctx[base]
            off = 0
        is16 = 1 if (v and v[0]) else 0 if v else None
        bit = self.io.dec(first, is16)
        if bit == 0:
            return (0, 0, 0, 0)
        if self.io.term(0 if self.io.encode else None):
            raise NotSupported("h264 cabac: I_PCM")
        st = base + off
        cl = self.io.dec(self.ctx[st + 1], 1 if (v and v[1]) else
                         0 if v else None)
        cc0 = self.io.dec(self.ctx[st + 2],
                          (1 if v[2] else 0) if v else None)
        cc = 0
        if cc0:
            cc = 1 + self.io.dec(self.ctx[st + 2 + intra_slice],
                                 (v[2] - 1) if v else None)
        pm_hi = self.io.dec(self.ctx[st + 3 + intra_slice],
                            ((v[3] >> 1) & 1) if v else None)
        pm_lo = self.io.dec(self.ctx[st + 3 + 2 * intra_slice],
                            (v[3] & 1) if v else None)
        return (1, 15 if cl else 0, cc, pm_hi * 2 + pm_lo)

    def p_mb_type(self, v=None):
        """P types: returns 0=16x16, 1=16x8, 2=8x16, 3=P_8x8, 'I' tuple
        for intra. v: int 0..3 or ('I', intra-tuple)."""
        is_intra = (v is not None and isinstance(v, tuple))
        b0 = self.io.dec(self.ctx[14], 1 if is_intra else
                         0 if v is not None else None)
        if b0:
            return ("I", self.intra_mb_type(0, 0, 17, 0,
                                            v[1] if v else None))
        b1 = self.io.dec(self.ctx[15],
                         (0 if v in (0, 3) else 1) if v is not None
                         else None)
        if b1 == 0:
            b2 = self.io.dec(self.ctx[16],
                             (1 if v == 3 else 0) if v is not None
                             else None)
            return 3 if b2 else 0
        b2 = self.io.dec(self.ctx[17],
                         (1 if v == 1 else 0) if v is not None else None)
        return 2 - b2

    def b_mb_type(self, mbx, mby, v=None):
        """B mb_type tree (h264_cabac.c); v int 0..21 or ('I', tuple)."""
        ctx = 0
        if self._mb_ok(mbx - 1, mby) and not self.direct_tab[mby, mbx - 1]:
            ctx += 1
        if self._mb_ok(mbx, mby - 1) and not self.direct_tab[mby - 1, mbx]:
            ctx += 1
        is_intra = v is not None and isinstance(v, tuple)
        b0v = None
        if v is not None:
            b0v = 0 if (not is_intra and v == 0) else 1
        if not self.io.dec(self.ctx[27 + ctx], b0v):
            return 0
        nb = None
        if v is not None:
            nb = 0 if (not is_intra and v in (1, 2)) else 1
        if not self.io.dec(self.ctx[27 + 3], nb):
            bit = None if v is None else (v - 1)
            return 1 + self.io.dec(self.ctx[27 + 5], bit)
        # 4-bit suffix
        if v is not None:
            if is_intra:
                bits_v = 13
            elif v == 11:
                bits_v = 14
            elif v == 22:      # B_8x8
                bits_v = 15
            elif 3 <= v <= 10:
                bits_v = v - 3
            else:              # 12..21 -> 5-bit codes (bits = v+4 over 5)
                bits_v = (v + 4) >> 1
        else:
            bits_v = None
        bits = self.io.dec(self.ctx[27 + 4],
                           ((bits_v >> 3) & 1) if v is not None
                           else None) << 3
        bits += self.io.dec(self.ctx[27 + 5],
                            ((bits_v >> 2) & 1) if v is not None
                            else None) << 2
        bits += self.io.dec(self.ctx[27 + 5],
                            ((bits_v >> 1) & 1) if v is not None
                            else None) << 1
        bits += self.io.dec(self.ctx[27 + 5],
                            (bits_v & 1) if v is not None else None)
        if bits < 8:
            return bits + 3
        if bits == 13:
            return ("I", self.intra_mb_type(0, 0, 32, 0,
                                            v[1] if v is not None
                                            else None))
        if bits == 14:
            return 11
        if bits == 15:
            return 22
        last = self.io.dec(self.ctx[27 + 5],
                           ((v + 4) & 1) if v is not None else None)
        return ((bits << 1) + last) - 4

    def sub_mb_type(self, v=None):
        b0 = self.io.dec(self.ctx[21],
                         (1 if v == 0 else 0) if v is not None else None)
        if b0:
            return 0
        b1 = self.io.dec(self.ctx[22],
                         (0 if v == 1 else 1) if v is not None else None)
        if not b1:
            return 1
        b2 = self.io.dec(self.ctx[23],
                         (1 if v == 2 else 0) if v is not None else None)
        return 2 if b2 else 3

    def sub_mb_type_b(self, v=None):
        """B-slice sub_mb_type (Table 9-38; ctx 36..39)."""
        io = self.io
        b0 = io.dec(self.ctx[36],
                    (0 if v == 0 else 1) if v is not None else None)
        if not b0:
            return 0
        b1 = io.dec(self.ctx[37],
                    (0 if v in (1, 2) else 1) if v is not None
                    else None)
        if not b1:
            b2 = io.dec(self.ctx[39],
                        (v - 1) if v is not None else None)
            return 1 + b2
        b2 = io.dec(self.ctx[38],
                    (0 if v in (3, 4, 5, 6) else 1)
                    if v is not None else None)
        if not b2:
            b3 = io.dec(self.ctx[39],
                        (((v - 3) >> 1) & 1) if v is not None
                        else None)
            b4 = io.dec(self.ctx[39],
                        ((v - 3) & 1) if v is not None else None)
            return 3 + (b3 << 1) + b4
        b3 = io.dec(self.ctx[39],
                    (0 if v in (7, 8, 9, 10) else 1)
                    if v is not None else None)
        if not b3:
            b4 = io.dec(self.ctx[39],
                        (((v - 7) >> 1) & 1) if v is not None
                        else None)
            b5 = io.dec(self.ctx[39],
                        ((v - 7) & 1) if v is not None else None)
            return 7 + (b4 << 1) + b5
        b4 = io.dec(self.ctx[39],
                    ((v - 11) & 1) if v is not None else None)
        return 11 + b4

    def intra4x4_mode(self, pred, v=None):
        use_pred = None if v is None else (1 if v == pred else 0)
        if self.io.dec(self.ctx[68], use_pred):
            return pred
        rem = None
        if v is not None:
            rem = v if v < pred else v - 1
        b0 = self.io.dec(self.ctx[69], (rem & 1) if v is not None else None)
        b1 = self.io.dec(self.ctx[69],
                         ((rem >> 1) & 1) if v is not None else None)
        b2 = self.io.dec(self.ctx[69],
                         ((rem >> 2) & 1) if v is not None else None)
        mode = b0 + 2 * b1 + 4 * b2
        return mode + (mode >= pred)

    def chroma_pred_mode(self, mbx, mby, v=None):
        ctx = 0
        if self._mb_ok(mbx - 1, mby) and \
                self.chroma_mode_tab[mby, mbx - 1] != 0:
            ctx += 1
        if self._mb_ok(mbx, mby - 1) and \
                self.chroma_mode_tab[mby - 1, mbx] != 0:
            ctx += 1
        if self.io.dec(self.ctx[64 + ctx],
                       (0 if v == 0 else 1) if v is not None else None) == 0:
            return 0
        if self.io.dec(self.ctx[64 + 3],
                       (0 if v == 1 else 1) if v is not None else None) == 0:
            return 1
        if self.io.dec(self.ctx[64 + 3],
                       (0 if v == 2 else 1) if v is not None else None) == 0:
            return 2
        return 3

    def transform_size_8x8_flag(self, mbx, mby, v=None):
        """ctx 399 + left/top MB 8x8-transform flags (spec 9.3.3.1.1.10;
        h264_cabac.c decode_cabac_mb_transform_size)."""
        ctx = 399
        if self._mb_ok(mbx - 1, mby) and self.dec.trans8[mby, mbx - 1]:
            ctx += 1
        if self._mb_ok(mbx, mby - 1) and self.dec.trans8[mby - 1, mbx]:
            ctx += 1
        return self.io.dec(self.ctx[ctx], v)

    def cbp(self, mbx, mby, intra, v=None):
        cbp_a = self._nbr_cbp(mbx - 1, mby, intra)
        cbp_b = self._nbr_cbp(mbx, mby - 1, intra)
        cbp = 0
        specs = [(lambda c: (0 if cbp_a & 0x02 else 1)
                  + (0 if cbp_b & 0x04 else 2), 0),
                 (lambda c: (0 if c & 0x01 else 1)
                  + (0 if cbp_b & 0x08 else 2), 1),
                 (lambda c: (0 if cbp_a & 0x08 else 1)
                  + (0 if c & 0x01 else 2), 2),
                 (lambda c: (0 if c & 0x04 else 1)
                  + (0 if c & 0x02 else 2), 3)]
        for f, bitpos in specs:
            ctx = f(cbp)
            bit = self.io.dec(self.ctx[73 + ctx],
                              ((v >> bitpos) & 1) if v is not None else None)
            cbp |= bit << bitpos
        # chroma
        ca = (cbp_a >> 4) & 3
        cb = (cbp_b >> 4) & 3
        ctx = (1 if ca > 0 else 0) + (2 if cb > 0 else 0)
        want = None if v is None else (v >> 4)
        b0 = self.io.dec(self.ctx[77 + ctx],
                         (1 if want else 0) if v is not None else None)
        cc = 0
        if b0:
            ctx = 4 + (1 if ca == 2 else 0) + (2 if cb == 2 else 0)
            b1 = self.io.dec(self.ctx[77 + ctx],
                             (1 if want == 2 else 0) if v is not None
                             else None)
            cc = 1 + b1
        return cbp | (cc << 4)

    def mb_qp_delta(self, v=None):
        b0 = self.io.dec(self.ctx[60 + (1 if self.last_dqp else 0)],
                         (0 if v == 0 else 1) if v is not None else None)
        if not b0:
            self.last_dqp = 0
            return 0
        # unary: val counts; mapping: odd -> +, even -> -
        mapped = None
        if v is not None:
            mapped = 2 * v - 1 if v > 0 else -2 * v
        val = 1
        ctx = 2
        while self.io.dec(self.ctx[60 + ctx],
                          (1 if (mapped is not None and val < mapped)
                           else 0) if mapped is not None else None):
            ctx = 3
            val += 1
            if val > 104:
                raise InvalidData("h264 cabac: dqp overflow")
        dqp = (val + 1) >> 1 if val & 1 else -((val + 1) >> 1)
        self.last_dqp = dqp
        return dqp

    def ref_idx(self, bx, by, lst, w4, h4, v=None):
        """ref_idx_lX unary coding (ctx base 54; h264_cabac.c
        decode_cabac_mb_ref): neighbour refs >0 raise the first
        context, unless the neighbour was coded as direct. Fills the
        partition's ref grid immediately so later same-MB partitions
        see it."""
        ctx = 0
        for nbx, nby, inc in ((bx - 1, by, 1), (bx, by - 1, 2)):
            if nbx < 0 or nby < 0 or \
                    nbx >= self.dec.sps.mb_width * 4:
                continue
            if not self.dec.blk_done[nby, nbx] and \
                    (lst, nbx, nby) not in self._ref_set:
                continue
            if int(self.dec.mv_ref[lst, nby, nbx]) > 0 and \
                    not self.direct_tab[nby // 4, nbx // 4]:
                ctx += inc
        ref = 0
        while self.io.dec(self.ctx[54 + ctx],
                          (1 if v > ref else 0) if v is not None
                          else None):
            ref += 1
            if ref >= 32:
                raise InvalidData("h264 cabac: ref_idx overflow")
            ctx = (ctx >> 2) + 4
        if not self.io.encode:
            lstref = self.dec.list0 if lst == 0 else self.dec.list1
            if ref >= self.dec.num_ref[lst] or ref >= len(lstref):
                raise InvalidData("h264 cabac: ref_idx out of range")
        self.dec.mv_ref[lst, by:by + h4, bx:bx + w4] = ref
        for yy in range(by, by + h4):
            for xx in range(bx, bx + w4):
                self._ref_set.add((lst, xx, yy))
        return ref

    def mvd(self, base, amvd, v=None):
        ctx_inc = (1 if amvd > 2 else 0) + (1 if amvd > 32 else 0)
        av = None if v is None else abs(v)
        b0 = self.io.dec(self.ctx[base + ctx_inc],
                         (0 if av == 0 else 1) if v is not None else None)
        if not b0:
            return 0
        mvd = 1
        cb = base + 3
        while mvd < 9:
            bit = self.io.dec(self.ctx[cb],
                              (1 if (av is not None and av > mvd) else 0)
                              if av is not None else None)
            if not bit:
                break
            if mvd < 4:
                cb += 1
            mvd += 1
        if mvd >= 9:
            # UEG3 suffix
            if av is not None:
                rest = av - 9
                k = 3
                while rest >= (1 << k):
                    self.io.byp(1)
                    rest -= 1 << k
                    k += 1
                self.io.byp(0)
                for i in range(k - 1, -1, -1):
                    self.io.byp((rest >> i) & 1)
                mvd = av
            else:
                k = 3
                while self.io.byp():
                    mvd += 1 << k
                    k += 1
                    if k > 24:
                        raise InvalidData("h264 cabac: mvd overflow")
                while k:
                    k -= 1
                    mvd += self.io.byp() << k
        sign = self.io.byp((1 if v < 0 else 0) if v is not None else None)
        return -mvd if sign else mvd

    # --- residuals ---------------------------------------------------------------
    def _cbf_ctx(self, cat, mbx, mby, bx, by, intra):
        if cat == 0:          # luma DC: neighbour MB's bit 0x100
            nza = self._nbr_cbp(mbx - 1, mby, intra) & 0x100
            nzb = self._nbr_cbp(mbx, mby - 1, intra) & 0x100
        elif cat == 3:        # chroma DC: bits 0x40 << comp
            comp = bx        # bx carries the component here
            nza = self._nbr_cbp(mbx - 1, mby, intra) & (0x40 << comp)
            nzb = self._nbr_cbp(mbx, mby - 1, intra) & (0x40 << comp)
        else:
            nza = self._nnz_at(cat, bx - 1, by, mbx, mby, intra, True)
            nzb = self._nnz_at(cat, bx, by - 1, mbx, mby, intra, False)
        return _CBF_BASE[cat] + (1 if nza > 0 else 0) + \
            (2 if nzb > 0 else 0)

    def _nnz_at(self, cat, bx, by, mbx, mby, intra, horiz):
        nnz = self.dec.nnz_y if cat in (1, 2) else None
        if cat == 4:
            nnz = self.dec.nnz_u if self._cur_comp == 0 else self.dec.nnz_v
        scale = 4 if cat in (1, 2) else 2
        if bx < 0 or by < 0 or bx >= self.dec.sps.mb_width * scale:
            return 64 if intra else 0
        nmbx, nmby = bx // scale, by // scale
        if (nmbx, nmby) != (mbx, mby) and not self._mb_ok(nmbx, nmby):
            return 64 if intra else 0
        val = int(nnz[by, bx])
        return val if val >= 0 else (64 if intra else 0)

    def residual(self, cat, mbx, mby, bx, by, n_coeffs, intra,
                 levels=None):
        """Decode (levels None) or encode one residual block. Returns
        (levels list in scan order, total)."""
        io = self.io
        cbf_ctx = None if cat == 5 else \
            self.ctx[self._cbf_ctx(cat, mbx, mby, bx, by, intra)]
        if levels is not None:
            nz = [(i, lv) for i, lv in enumerate(levels) if lv]
            if cat != 5:
                io.dec(cbf_ctx, 1 if nz else 0)
                if not nz:
                    return levels, 0
            # significance map
            for pos in range(n_coeffs - 1):
                sig = any(i == pos for i, _ in nz)
                io.dec(self.ctx[_sig_ctx(cat, pos)], 1 if sig else 0)
                if sig:
                    last = nz[-1][0] == pos
                    io.dec(self.ctx[_last_ctx(cat, pos)],
                           1 if last else 0)
                    if last:
                        break
            node = 0
            for i, lv in reversed(nz):
                a = abs(lv)
                ctx1 = self.ctx[_ABS_BASE[cat] + _LEVEL1_CTX[node]]
                if a == 1:
                    io.dec(ctx1, 0)
                    node = _LEVEL_TRANS[0][node]
                else:
                    io.dec(ctx1, 1)
                    gctx = self.ctx[_ABS_BASE[cat] + _LEVELGT1_CTX[node]]
                    node = _LEVEL_TRANS[1][node]
                    for step in range(2, min(a, 15)):
                        io.dec(gctx, 1)
                    if a < 15:
                        io.dec(gctx, 0)
                    else:
                        # UEG0 suffix
                        rest = a - 15
                        k = 0
                        while rest >= (1 << k):
                            io.byp(1)
                            rest -= 1 << k
                            k += 1
                        io.byp(0)
                        for j in range(k - 1, -1, -1):
                            io.byp((rest >> j) & 1)
                io.byp(1 if lv < 0 else 0)
            return levels, len(nz)

        # ---- decode ----
        out = [0] * n_coeffs
        if cat != 5 and not io.dec(cbf_ctx):
            return out, 0
        index = []
        last = 0
        while last < n_coeffs - 1:
            if io.dec(self.ctx[_sig_ctx(cat, last)]):
                index.append(last)
                if io.dec(self.ctx[_last_ctx(cat, last)]):
                    last = n_coeffs
                    break
            last += 1
        if last == n_coeffs - 1:
            index.append(last)
        node = 0
        for i in range(len(index) - 1, -1, -1):
            pos = index[i]
            ctx1 = self.ctx[_ABS_BASE[cat] + _LEVEL1_CTX[node]]
            if io.dec(ctx1) == 0:
                a = 1
                node = _LEVEL_TRANS[0][node]
            else:
                gctx = self.ctx[_ABS_BASE[cat] + _LEVELGT1_CTX[node]]
                node = _LEVEL_TRANS[1][node]
                a = 2
                while a < 15 and io.dec(gctx):
                    a += 1
                if a >= 15:
                    j = 0
                    while io.byp() and j < 23:
                        j += 1
                    a = 1
                    while j:
                        j -= 1
                        a += a + io.byp()
                    a += 14
            if io.byp():
                a = -a
            out[pos] = a
        return out, len(index)


# ---------------------------------------------------------------------------
# MB-level walker: decode path (encode path lives in the test harness,
# reusing the same element coders above).

def decode_slice_cabac(dec: SliceDecoder, rbsp: bytes, bit_pos: int, sh):
    """Decode CABAC slice data starting after the (byte-aligned) header."""
    # cabac_alignment_one_bits to the byte boundary
    pos = (bit_pos + 7) & ~7
    core = CabacDecoder(rbsp[pos // 8:])
    sc = CabacSliceCoder(dec, core, sh.slice_type, sh.qp,
                         getattr(sh, "cabac_init_idc", 0))
    sps = dec.sps
    nmbx = sps.mb_width
    qp = sh.qp
    dec.num_ref = sh.num_ref
    dec.direct_spatial = getattr(sh, "direct_spatial", True)
    mb_addr = sh.first_mb
    is_p = sh.slice_type == 0
    is_b = sh.slice_type == 1
    while True:
        mbx, mby = mb_addr % nmbx, mb_addr // nmbx
        if mby >= sps.mb_height:
            break
        if (is_p or is_b) and sc.mb_skip_flag(mbx, mby):
            if is_b:
                dec._decode_mb_b_direct(mbx, mby, qp)
                sc.direct_tab[mby, mbx] = True
            else:
                dec._decode_mb_skip(mbx, mby, qp)
            sc.skip_tab[mby, mbx] = True
            sc.cbp_tab[mby, mbx] = 0
            sc.last_dqp = 0
            dec.mb_avail[mby, mbx] = True
        else:
            qp = _decode_mb_cabac(dec, sc, mbx, mby, qp, is_p, is_b)
            dec.mb_avail[mby, mbx] = True
        mb_addr += 1
        if core.terminate():
            break


def _decode_mb_cabac(dec, sc, mbx, mby, qp, is_p, is_b=False):
    sc._ref_set.clear()
    if is_b:
        t = sc.b_mb_type(mbx, mby)
        if isinstance(t, tuple):
            return _decode_mb_cabac_intra(dec, sc, mbx, mby, qp, t[1],
                                          intra_slice=False)
        return _decode_mb_cabac_b(dec, sc, mbx, mby, qp, t)
    if is_p:
        t = sc.p_mb_type()
        if isinstance(t, tuple):
            return _decode_mb_cabac_intra(dec, sc, mbx, mby, qp, t[1],
                                          intra_slice=False)
        return _decode_mb_cabac_p(dec, sc, mbx, mby, qp, t)
    t = sc.intra_mb_type(mbx, mby, 3, 1)
    return _decode_mb_cabac_intra(dec, sc, mbx, mby, qp, t,
                                  intra_slice=True)


def _luma_residual_cabac(dec, sc, mbx, mby, qp, cbp_luma, trans8, intra):
    """Luma residual blocks of one MB: a single cat-5 block per coded
    8x8 when trans8, else sixteen cat-1/2 4x4 blocks. The 4x4 nnz cells
    of a coded 8x8 are set to 1 so later cbf contexts and deblocking see
    the covering block as coded (spec 9.3.3.1.1.9 neighbour inference;
    h264.h nnz cache fill for CABAC 8x8 MBs)."""
    bx, by = mbx * 4, mby * 4
    if trans8:
        dec.trans8[mby, mbx] = True
        w8 = dec.pps.scaling8[0 if intra else 1]
        for blk8 in range(4):
            dx8, dy8 = dec._BLK8_XY[blk8]
            x4, y4 = bx + dx8 * 2, by + dy8 * 2
            if cbp_luma & (1 << blk8):
                lv, _total = sc.residual(5, mbx, mby, x4, y4, 64, intra)
                lv64 = np.zeros(64, np.int64)
                lv64[dec.scan8] = lv
                dec.coeff8_y[mby * 2 + dy8, mbx * 2 + dx8] = \
                    recon.dequant8(lv64, qp + dec.qp_bd_offset, w8)
                dec.nnz_y[y4:y4 + 2, x4:x4 + 2] = 1
            else:
                dec.nnz_y[y4:y4 + 2, x4:x4 + 2] = 0
        return
    w4 = dec.pps.scaling4[0 if intra else 3]
    for blk in range(16):
        dxb, dyb = _BLK_XY[blk]
        bx4, by4 = bx + dxb, by + dyb
        if not (cbp_luma & (1 << (blk >> 2))):
            dec.nnz_y[by4, bx4] = 0
            continue
        lv, total = sc.residual(2, mbx, mby, bx4, by4, 16, intra)
        dec.nnz_y[by4, bx4] = total
        raster = np.zeros(16, np.int64)
        raster[dec.scan4] = lv
        dec.coeff_y[by4, bx4] = recon.dequant4(
            raster, qp + dec.qp_bd_offset, w4)


def _decode_mb_cabac_b8x8(dec, sc, mbx, mby):
    """B_8x8 sub-macroblock prediction, CABAC side (shares the
    per-list in-MB availability state with the CAVLC path)."""
    bx, by = mbx * 4, mby * 4
    subs = [sc.sub_mb_type_b() for _ in range(4)]
    dec._cur_mb = (mbx, mby)
    dec._curmask = np.zeros((2, 4, 4), bool)
    direct_q = {q for q, st in enumerate(subs) if st == 0}
    if direct_q:
        dec._decode_mb_b_direct(mbx, mby, 0, residual_cb=True,
                                quads=direct_q)
        for q in direct_q:
            x8, y8 = q & 1, q >> 1
            dec._curmask[:, y8 * 2:y8 * 2 + 2,
                         x8 * 2:x8 * 2 + 2] = True
        dec._curmask[:, 0, 2] = False
        dec._curmask[:, 2, 2] = False
    refs8 = {0: [0] * 4, 1: [0] * 4}
    for lst in range(2):
        if dec.num_ref[lst] <= 1:
            continue
        for q, st in enumerate(subs):
            if st and (dec._B_SUB[st][3] & (1 << lst)):
                x8, y8 = q & 1, q >> 1
                refs8[lst][q] = sc.ref_idx(bx + x8 * 2,
                                           by + y8 * 2, lst, 2, 2)
    for lst in range(2):
        for q, st in enumerate(subs):
            x8, y8 = q & 1, q >> 1
            if st == 0:
                continue
            npart, w4, h4, mask = dec._B_SUB[st]
            if not (mask & (1 << lst)):
                ys = slice(by + y8 * 2, by + y8 * 2 + 2)
                xs = slice(bx + x8 * 2, bx + x8 * 2 + 2)
                dec.mv[lst, ys, xs] = 0
                dec.mv_ref[lst, ys, xs] = -1
                dec._curmask[lst, y8 * 2:y8 * 2 + 2,
                             x8 * 2:x8 * 2 + 2] = True
                continue
            for ox, oy in dec._B_SUB_OFFS[(npart, w4, h4)]:
                px = bx + x8 * 2 + ox
                py = by + y8 * 2 + oy
                mvdx = sc.mvd(40, _amvd(sc, px, py, 0, lst))
                mvdy = sc.mvd(47, _amvd(sc, px, py, 1, lst))
                sc.mvd_cache[lst, py:py + h4, px:px + w4, 0] = \
                    min(abs(mvdx), 70)
                sc.mvd_cache[lst, py:py + h4, px:px + w4, 1] = \
                    min(abs(mvdy), 70)
                pred = dec._pred_mv(px, py, w4, h4, lst,
                                    refs8[lst][q])
                mv = (pred[0] + mvdx, pred[1] + mvdy)
                dec._store_mv(px, py, w4, h4, mv, lst,
                              refs8[lst][q])
                dec._curmask[lst, py - by:py - by + h4,
                             px - bx:px - bx + w4] = True
    dec._cur_mb = (-1, -1)
    dec.blk_done[by:by + 4, bx:bx + 4] = True
    dec.intra4x4_modes[by:by + 4, bx:bx + 4] = 2
    return subs


def _decode_mb_cabac_b(dec, sc, mbx, mby, qp, mb_type):
    bx, by = mbx * 4, mby * 4
    sc._cur_comp = 0
    subs = None
    if mb_type == 22:
        subs = _decode_mb_cabac_b8x8(dec, sc, mbx, mby)
        parts, masks = [], []
    elif mb_type == 0:
        dec._decode_mb_b_direct(mbx, mby, qp, residual_cb=True)
        sc.direct_tab[mby, mbx] = True
        parts, masks = [], []
    elif mb_type <= 3:
        parts = [(0, 0, 4, 4)]
        masks = [mb_type]
    else:
        v8x16, m0, m1 = dec._B_TWO[mb_type]
        parts = [(0, 0, 2, 4), (2, 0, 2, 4)] if v8x16 else \
            [(0, 0, 4, 2), (0, 2, 4, 2)]
        masks = [m0, m1]
    for lst in range(2):
        for i, (px, py, w4, h4) in enumerate(parts):
            if not (masks[i] & (1 << lst)):
                dec.mv_ref[lst, by + py:by + py + h4,
                           bx + px:bx + px + w4] = -1
    # ref_idx fields first (list-major), then mvds (list-major)
    prefs = [[0, 0] for _ in parts]
    for lst in range(2):
        nref = dec.num_ref[lst]
        for i, (px, py, w4, h4) in enumerate(parts):
            if masks[i] & (1 << lst) and nref > 1:
                prefs[i][lst] = sc.ref_idx(bx + px, by + py, lst,
                                           w4, h4)
    part_mvs = [[None, None] for _ in parts]
    for lst in range(2):
        for i, (px, py, w4, h4) in enumerate(parts):
            if not (masks[i] & (1 << lst)):
                continue
            pbx, pby = bx + px, by + py
            mvdx = sc.mvd(40, _amvd(sc, pbx, pby, 0, lst))
            mvdy = sc.mvd(47, _amvd(sc, pbx, pby, 1, lst))
            sc.mvd_cache[lst, pby:pby + h4, pbx:pbx + w4, 0] = \
                min(abs(mvdx), 70)
            sc.mvd_cache[lst, pby:pby + h4, pbx:pbx + w4, 1] = \
                min(abs(mvdy), 70)
            pred = dec._pred_mv(pbx, pby, w4, h4, lst, prefs[i][lst])
            mv = (pred[0] + mvdx, pred[1] + mvdy)
            dec._store_mv(pbx, pby, w4, h4, mv, lst, prefs[i][lst])
            part_mvs[i][lst] = mv
    for i, (px, py, w4, h4) in enumerate(parts):
        dec.blk_done[by + py:by + py + h4, bx + px:bx + px + w4] = True
        dec.intra4x4_modes[by + py:by + py + h4,
                           bx + px:bx + px + w4] = 2
    cbp = sc.cbp(mbx, mby, False)
    cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
    trans8 = False
    ok8 = mb_type != 0 or dec.sps.direct_8x8_inference
    if subs is not None:
        ok8 = all((st == 0 and dec.sps.direct_8x8_inference)
                  or st in (1, 2, 3) for st in subs)
    if dec.pps.transform_8x8_mode and cbp_luma and ok8:
        trans8 = bool(sc.transform_size_8x8_flag(mbx, mby))
    if cbp:
        qp = dec._qp_add(qp, sc.mb_qp_delta())
    else:
        sc.last_dqp = 0
    dec.mb_qp[mby, mbx] = qp
    _luma_residual_cabac(dec, sc, mbx, mby, qp, cbp_luma, trans8, False)
    cbp_entry = _decode_chroma_cabac(dec, sc, mbx, mby, qp, 0, cbp_chroma,
                                     False, False, cbp, intra=False)
    sc.cbp_tab[mby, mbx] = cbp_entry
    return qp


def _decode_mb_cabac_intra(dec, sc, mbx, mby, qp, t, intra_slice):
    is16, cbp_luma, cbp_chroma, pred16 = t
    dec.mb_intra[mby, mbx] = True
    bx, by = mbx * 4, mby * 4
    x0, y0 = mbx * 16, mby * 16
    avail_l = dec._avail(mbx, mby, -1, 0)
    avail_t = dec._avail(mbx, mby, 0, -1)
    sc.i16_tab[mby, mbx] = bool(is16)
    sc.i4x4_tab[mby, mbx] = not is16
    sc._cur_comp = 0

    trans8 = False
    if not is16:
        if dec.pps.transform_8x8_mode:
            trans8 = bool(sc.transform_size_8x8_flag(mbx, mby))
        modes = []
        if trans8:
            # Intra_8x8: four modes, prev/rem shares the intra4x4
            # contexts; context cells are the covering 4x4 modes
            dec.trans8[mby, mbx] = True
            dec.mb_16x16[mby, mbx] = True
            for dx8, dy8 in dec._BLK8_XY:
                bxx, byy = bx + dx8 * 2, by + dy8 * 2
                la = dec._nbr_avail(bxx - 1, byy, mbx, mby)
                ta = dec._nbr_avail(bxx, byy - 1, mbx, mby)
                if not la or not ta:
                    pred = 2
                else:
                    lm = int(dec.intra4x4_modes[byy, bxx - 1])
                    tm = int(dec.intra4x4_modes[byy - 1, bxx])
                    pred = min(lm if lm >= 0 else 2,
                               tm if tm >= 0 else 2)
                mode = sc.intra4x4_mode(pred)
                modes.append(mode)
                dec.intra4x4_modes[byy:byy + 2, bxx:bxx + 2] = mode
        else:
            for blk in range(16):
                dxb, dyb = _BLK_XY[blk]
                bxx, byy = bx + dxb, by + dyb
                la = dec._nbr_avail(bxx - 1, byy, mbx, mby)
                ta = dec._nbr_avail(bxx, byy - 1, mbx, mby)
                if not la or not ta:
                    pred = 2
                else:
                    lm = int(dec.intra4x4_modes[byy, bxx - 1])
                    tm = int(dec.intra4x4_modes[byy - 1, bxx])
                    pred = min(lm if lm >= 0 else 2,
                               tm if tm >= 0 else 2)
                mode = sc.intra4x4_mode(pred)
                modes.append(mode)
                dec.intra4x4_modes[byy, bxx] = mode
        chroma_mode = sc.chroma_pred_mode(mbx, mby)
        cbp = sc.cbp(mbx, mby, True)
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
    else:
        chroma_mode = sc.chroma_pred_mode(mbx, mby)
        dec.intra4x4_modes[by:by + 4, bx:bx + 4] = 2
    sc.chroma_mode_tab[mby, mbx] = chroma_mode

    if cbp_luma or cbp_chroma or is16:
        qp = dec._qp_add(qp, sc.mb_qp_delta())
    else:
        sc.last_dqp = 0
    dec.mb_qp[mby, mbx] = qp
    cbp_entry = cbp_luma | (cbp_chroma << 4)

    s4 = dec.pps.scaling4
    if is16:
        dec.i16_mode[mby, mbx] = pred16
        dc_lv, dc_total = sc.residual(0, mbx, mby, 0, 0, 16, True)
        if dc_total:
            cbp_entry |= 0x100
        dc_raster = np.zeros(16, np.int64)
        dc_raster[dec.scan4] = dc_lv
        dcs = recon.luma_dc_transform(
            dc_raster, qp + dec.qp_bd_offset, s4[0][0])
        for blk in range(16):
            dxb, dyb = _BLK_XY[blk]
            bx4, by4 = bx + dxb, by + dyb
            raster = np.zeros(16, np.int64)
            if cbp_luma:
                lv, total = sc.residual(1, mbx, mby, bx4, by4, 15, True)
                dec.nnz_y[by4, bx4] = total
                raster[dec.scan4[1:]] = lv
            else:
                dec.nnz_y[by4, bx4] = 0
            block = recon.dequant4(raster, qp + dec.qp_bd_offset, s4[0])
            block[0] = dcs[dyb, dxb]
            dec.coeff_y[by4, bx4] = block
        dec.blk_done[by:by + 4, bx:bx + 4] = True
    elif trans8:
        for blk8 in range(4):
            dec._record_blk8(mbx, mby, blk8, modes[blk8])
        _luma_residual_cabac(dec, sc, mbx, mby, qp, cbp_luma, True, True)
    else:
        for blk in range(16):
            dxb, dyb = _BLK_XY[blk]
            bx4, by4 = bx + dxb, by + dyb
            dec.blk_avail[by4, bx4] = (
                dec._blk_done_at(bx4 - 1, by4),
                dec._blk_done_at(bx4, by4 - 1),
                dec._blk_done_at(bx4 + 1, by4 - 1),
                dec._blk_done_at(bx4 - 1, by4 - 1))
            dec.i4_pred[by4, bx4] = modes[blk]
            if cbp_luma & (1 << (blk >> 2)):
                lv, total = sc.residual(2, mbx, mby, bx4, by4, 16, True)
                dec.nnz_y[by4, bx4] = total
                raster = np.zeros(16, np.int64)
                raster[dec.scan4] = lv
                dec.coeff_y[by4, bx4] = recon.dequant4(
                    raster, qp + dec.qp_bd_offset, s4[0])
            else:
                dec.nnz_y[by4, bx4] = 0
            dec.blk_done[by4, bx4] = True

    cbp_entry = _decode_chroma_cabac(dec, sc, mbx, mby, qp, chroma_mode,
                                     cbp_chroma, avail_l, avail_t,
                                     cbp_entry, intra=True)
    sc.cbp_tab[mby, mbx] = cbp_entry
    return qp


def _decode_mb_cabac_p(dec, sc, mbx, mby, qp, mb_type):
    bx, by = mbx * 4, mby * 4
    sc._cur_comp = 0
    nref = dec.num_ref[0]
    if mb_type == 3:
        subs = [sc.sub_mb_type() for _ in range(4)]
        # per-8x8 ref_idx fields precede all mvds
        refs8 = [sc.ref_idx(bx + (s & 1) * 2, by + (s >> 1) * 2,
                            0, 2, 2) if nref > 1 else 0
                 for s in range(4)]
        plist = []
        for sub in range(4):
            ox, oy = (sub & 1) * 2, (sub >> 1) * 2
            for (px, py, w4, h4) in dec._SUB_PARTS[subs[sub]]:
                plist.append((ox + px, oy + py, w4, h4, refs8[sub]))
    else:
        shapes = {0: [(0, 0, 4, 4)],
                  1: [(0, 0, 4, 2), (0, 2, 4, 2)],
                  2: [(0, 0, 2, 4), (2, 0, 2, 4)]}[mb_type]
        plist = [(px, py, w4, h4,
                  sc.ref_idx(bx + px, by + py, 0, w4, h4)
                  if nref > 1 else 0)
                 for (px, py, w4, h4) in shapes]
    for (px, py, w4, h4, ref) in plist:
        pbx, pby = bx + px, by + py
        amvd0 = _amvd(sc, pbx, pby, 0)
        amvd1 = _amvd(sc, pbx, pby, 1)
        mvdx = sc.mvd(40, amvd0)
        mvdy = sc.mvd(47, amvd1)
        sc.mvd_cache[0, pby:pby + h4, pbx:pbx + w4, 0] = min(abs(mvdx), 70)
        sc.mvd_cache[0, pby:pby + h4, pbx:pbx + w4, 1] = min(abs(mvdy), 70)
        pred = dec._pred_mv(pbx, pby, w4, h4, ref=ref)
        mv = (pred[0] + mvdx, pred[1] + mvdy)
        dec._store_mv(pbx, pby, w4, h4, mv, 0, ref)
    cbp = sc.cbp(mbx, mby, False)
    cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
    trans8 = False
    if dec.pps.transform_8x8_mode and cbp_luma and \
            (mb_type in (0, 1, 2) or all(st == 0 for st in subs)):
        trans8 = bool(sc.transform_size_8x8_flag(mbx, mby))
    if cbp:
        qp = dec._qp_add(qp, sc.mb_qp_delta())
    else:
        sc.last_dqp = 0
    dec.mb_qp[mby, mbx] = qp
    _luma_residual_cabac(dec, sc, mbx, mby, qp, cbp_luma, trans8, False)
    cbp_entry = _decode_chroma_cabac(dec, sc, mbx, mby, qp, 0, cbp_chroma,
                                     False, False, cbp, intra=False)
    sc.cbp_tab[mby, mbx] = cbp_entry
    return qp


def _amvd(sc, bx, by, comp, lst=0):
    l = int(sc.mvd_cache[lst, by, bx - 1, comp]) if bx > 0 else 0
    t = int(sc.mvd_cache[lst, by - 1, bx, comp]) if by > 0 else 0
    return l + t


def _decode_chroma_cabac(dec, sc, mbx, mby, qp, chroma_mode, cbp_chroma,
                         avail_l, avail_t, cbp_entry, intra):
    qpc = dec._chroma_qp(qp, dec.pps.chroma_qp_index_offset)
    qpc2 = dec._chroma_qp(qp, dec.pps.second_chroma_qp_index_offset)
    if intra:
        dec.chroma_imode[mby, mbx] = chroma_mode
        dec.mb_nbr_avail[mby, mbx] = (avail_l, avail_t)
    s4 = dec.pps.scaling4
    wu, wv = (s4[1], s4[2]) if intra else (s4[4], s4[5])
    comps = ((dec.coeff_u, dec.nnz_u, qpc, wu),
             (dec.coeff_v, dec.nnz_v, qpc2, wv))
    dcs = []
    for ci, (_co, _nnz, qpc_used, w) in enumerate(comps):
        sc._cur_comp = ci
        dc = np.zeros((2, 2), np.int64)
        if cbp_chroma:
            lv, total = sc.residual(3, mbx, mby, ci, 0, 4, intra)
            if total:
                cbp_entry |= 0x40 << ci
            dc = recon.chroma_dc_transform(np.array(lv[:4], np.int64),
                                           qpc_used, w[0])
        dcs.append(dc)
    acs_all = []
    for ci, (_co, nnz, _q, _w) in enumerate(comps):
        sc._cur_comp = ci
        acs = []
        for blk in range(4):
            dxb, dyb = blk & 1, blk >> 1
            raster = np.zeros(16, np.int64)
            if cbp_chroma == 2:
                bx2, by2 = mbx * 2 + dxb, mby * 2 + dyb
                lv, total = sc.residual(4, mbx, mby, bx2, by2, 15, intra)
                nnz[by2, bx2] = total
                raster[dec.scan4[1:]] = lv
            else:
                nnz[mby * 2 + dyb, mbx * 2 + dxb] = 0
            acs.append(raster)
        acs_all.append(acs)
    for ci, (coeff, _nnz, qpc_used, w) in enumerate(comps):
        for blk in range(4):
            dxb, dyb = blk & 1, blk >> 1
            block = recon.dequant4(acs_all[ci][blk], qpc_used, w)
            block[0] = dcs[ci][dyb, dxb]
            coeff[mby * 2 + dyb, mbx * 2 + dxb] = block
    return cbp_entry
