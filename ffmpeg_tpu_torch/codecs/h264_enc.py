"""H.264 encoder: Baseline-profile I/P GOP with CAVLC entropy coding
(counterpart of ffmpeg_tpu/codecs/h264_enc.py).

The reference's encoder, statement for statement, over the port's host
copies of the decoder's building blocks (codecs/h264/ recon, tables,
inter, params, slice_dec), so its reconstruction is decoder-exact by
construction:

  * I frames: all-MB Intra_16x16 (V/H/DC mode by SAD) with the
    4x4 integer transform, Hadamard luma DC, chroma DC/AC.
  * P frames: whole-frame full-search motion estimation on the
    encoder's device (`_motion_search`: the padded luma and the
    reconstructed reference go up once as uint8, ops/me.py
    motion_search runs K2, csrc/sad_cost_volume.cu, on a CUDA device,
    and the (by, bx, 2) MVs come back), P_Skip / P_16x16 decisions,
    median MV prediction and the decoder's own skip-MV rule via a
    mirrored SliceDecoder state, quarter-pel refinement and MC via the
    decoder's mc_luma/mc_chroma on the host.
  * Forward quant per JM: level = (|W|*MF[qp%6][pos] + f) >> qbits;
    reconstruction replays recon.dequant4/idct4_add.

Every step but the motion search is integer host code, so the port's
packets are byte-identical to the reference's (tests/
test_torch_h264_enc.py).  The encoder pads each frame to a multiple of
16 before the search, and its samples are integers, so K2's contract
and the reference's XLA form give the same costs on its inputs; ties go
to the first minimum in raster order (ops/me.py best_mvs).

The reference turns any exception of its motion search into zero MVs;
the port has no such fallback, and a failed search raises.

`stats`, when a list, gets one dict per frame: its type, the wall ms,
the motion search's h2d, search (K2 and the argmin) and d2h ms (each
ended by a synchronize, on the host's clock), the subpel refinement's
ms and the rest of the macroblock loop's.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..core.frame import Frame, host_array
from ..core.packet import Packet, PKT_FLAG_KEY
from ..io.stream import MediaType
from ..ops.me import motion_search
from .codec import Codec, register_encoder
from .h264 import recon
from .h264 import tables as HT
from .h264.inter import mc_chroma, mc_luma
from .h264.params import PPS, SPS
from .h264.slice_dec import SliceDecoder, _BLK_XY

# forward quant multipliers MF[qp%6] for coefficient classes
# (even,even) / (odd,odd) / mixed — the forward duals of
# recon.DEQUANT_INIT
_MF = [(13107, 5243, 8066), (11916, 4660, 7490),
       (10082, 4194, 6554), (9362, 3647, 5825),
       (8192, 3355, 5243), (7282, 2893, 4559)]
_POS_CLASS = np.zeros(16, np.int64)
for _i in range(16):
    _y, _x = _i >> 2, _i & 3
    _POS_CLASS[_i] = 0 if (_x % 2 == 0 and _y % 2 == 0) else \
    (1 if (_x % 2 and _y % 2) else 2)

_CF = np.array([[1, 1, 1, 1], [2, 1, -1, -2],
                [1, -1, -1, 1], [1, -2, 2, -1]], np.int64)
_H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1],
                [1, -1, -1, 1], [1, -1, 1, -1]], np.int64)

_CT_INDEX = [0, 0, 1, 1, 2, 2, 2, 2] + [3] * 9


class _BW:
    __slots__ = ("bits",)

    def __init__(self):
        self.bits = []

    def u(self, v, n):
        for k in range(n - 1, -1, -1):
            self.bits.append((v >> k) & 1)

    def ue(self, v):
        v += 1
        n = v.bit_length()
        for _ in range(n - 1):
            self.bits.append(0)
        self.u(v, n)

    def se(self, v):
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def rbsp(self) -> bytes:
        bits = self.bits + [1]
        while len(bits) % 8:
            bits.append(0)
        out = bytearray(len(bits) // 8)
        for i, b in enumerate(bits):
            out[i >> 3] |= b << (7 - (i & 7))
        return bytes(out)


def _escape(rbsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _nal(ref_idc: int, ntype: int, rbsp: bytes) -> bytes:
    return b"\x00\x00\x00\x01" + bytes([(ref_idc << 5) | ntype]) \
        + _escape(rbsp)


def write_residual(w: _BW, levels, n_coeffs: int, nc: int) -> int:
    """CAVLC residual_block encoder (7.3.5.3.2 inverse of
    cavlc.decode_residual); levels in scan order."""
    nz = [(i, v) for i, v in enumerate(levels) if v]
    total = len(nz)
    trailing = 0
    for i in range(total - 1, -1, -1):
        if abs(nz[i][1]) == 1 and trailing < 3:
            trailing += 1
        else:
            break
    if nc == -1:
        sym = total * 4 + trailing
        w.u(HT.CHROMA_DC_COEFF_TOKEN_BITS[sym],
            HT.CHROMA_DC_COEFF_TOKEN_LEN[sym])
    else:
        t = _CT_INDEX[nc] if nc < 8 else 3
        sym = total * 4 + trailing
        w.u(HT.COEFF_TOKEN_BITS[t][sym], HT.COEFF_TOKEN_LEN[t][sym])
    if total == 0:
        return 0
    for i in range(total - 1, total - 1 - trailing, -1):
        w.u(1 if nz[i][1] < 0 else 0, 1)
    suffix_length = 1 if (total > 10 and trailing < 3) else 0
    first = True
    for i in range(total - 1 - trailing, -1, -1):
        level = nz[i][1]
        lc = 2 * abs(level) - 2 if level > 0 else -2 * level - 1
        if first and trailing < 3:
            lc -= 2
        first = False
        if suffix_length == 0:
            if lc < 14:
                w.u(1, lc + 1)
            elif lc < 30:
                w.u(1, 15)
                w.u(lc - 14, 4)
            else:
                w.u(1, 16)
                w.u(lc - 30, 12)
        else:
            if (lc >> suffix_length) < 15:
                w.u(1, (lc >> suffix_length) + 1)
                w.u(lc & ((1 << suffix_length) - 1), suffix_length)
            else:
                w.u(1, 16)
                w.u(lc - (15 << suffix_length), 12)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) \
                and suffix_length < 6:
            suffix_length += 1
    tz = nz[-1][0] + 1 - total
    if total < n_coeffs:
        if nc == -1:
            w.u(HT.CHROMA_DC_TOTAL_ZEROS_BITS[total - 1][tz],
                HT.CHROMA_DC_TOTAL_ZEROS_LEN[total - 1][tz])
        else:
            w.u(HT.TOTAL_ZEROS_BITS[total - 1][tz],
                HT.TOTAL_ZEROS_LEN[total - 1][tz])
    else:
        tz = 0
    zeros_left = tz
    for i in range(total - 1, 0, -1):
        if zeros_left <= 0:
            break
        run = nz[i][0] - nz[i - 1][0] - 1
        tbl = min(zeros_left - 1, 6)
        w.u(HT.RUN_BITS[tbl][run], HT.RUN_LEN[tbl][run])
        zeros_left -= run
    return total


def _fdct4(block: np.ndarray) -> np.ndarray:
    return _CF @ block.astype(np.int64) @ _CF.T


def _quant4(coeffs: np.ndarray, qp: int, intra: bool,
            skip_dc: bool = False) -> np.ndarray:
    """levels in raster order (16,)."""
    qbits = 15 + qp // 6
    mf = np.array(_MF[qp % 6], np.int64)[_POS_CLASS]
    f = (1 << qbits) // (3 if intra else 6)
    c = coeffs.reshape(16)
    lv = np.sign(c) * ((np.abs(c) * mf + f) >> qbits)
    if skip_dc:
        lv[0] = 0
    return lv


def _nc_pred(nnz, bx, by):
    """coeff_token context (mirrors SliceDecoder._pred_nnz)."""
    a = nnz[by, bx - 1] if bx > 0 else -1
    b = nnz[by - 1, bx] if by > 0 else -1
    if a >= 0 and b >= 0:
        return (a + b + 1) >> 1
    if a >= 0:
        return a
    if b >= 0:
        return b
    return 0


@register_encoder
class H264Encoder(Codec):
    codec_id = "h264"
    codec_type = MediaType.VIDEO
    is_encoder = True

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        o = options or {}
        self.qp = int(o.get("qp", o.get("qscale", 26)))
        self.gop = int(o.get("g", o.get("gop_size", 25)))
        self.search = int(o.get("me_range", 8))
        # sub-pel refinement: 0 = full-pel, 1 = +half, 2 = +quarter
        self.subpel = int(o.get("subpel", 2))
        self.frame_idx = 0
        self._recon = None           # (y, u, v) reference planes
        self.stats: Optional[list] = None
        self._st = None              # this frame's split (stats on)

    # ------------------------------------------------- headers
    def _make_sps(self, mb_w, mb_h, crop_r, crop_b) -> bytes:
        w = _BW()
        w.u(66, 8)
        w.u(0, 8)
        w.u(30, 8)
        w.ue(0)                # sps_id
        w.ue(4)                # log2_max_frame_num = 8
        w.ue(0)                # poc_type 0
        w.ue(12)               # log2_max_poc_lsb = 16
        w.ue(1)                # num_ref_frames
        w.u(0, 1)
        w.ue(mb_w - 1)
        w.ue(mb_h - 1)
        w.u(1, 1)              # frame_mbs_only
        w.u(1, 1)              # direct_8x8_inference
        if crop_r or crop_b:
            w.u(1, 1)
            w.ue(0)
            w.ue(crop_r // 2)
            w.ue(0)
            w.ue(crop_b // 2)
        else:
            w.u(0, 1)
        w.u(0, 1)              # no vui
        return _nal(3, 7, w.rbsp())

    def _make_pps(self) -> bytes:
        w = _BW()
        w.ue(0)
        w.ue(0)
        w.u(0, 1)              # cavlc
        w.u(0, 1)
        w.ue(0)
        w.ue(0)
        w.ue(0)
        w.u(0, 1)
        w.u(0, 2)
        w.se(self.qp - 26)     # init_qp
        w.se(0)
        w.se(0)
        w.u(1, 1)              # deblocking control present
        w.u(0, 1)
        w.u(0, 1)
        return _nal(3, 8, w.rbsp())

    def _slice_head(self, w: _BW, is_idr: bool, is_p: bool,
                    frame_num: int, poc: int):
        w.ue(0)                          # first_mb
        w.ue(5 if is_p else 7)
        w.ue(0)                          # pps
        w.u(frame_num & 0xFF, 8)
        if is_idr:
            w.ue(0)                      # idr_pic_id
        w.u(poc & 0xFFFF, 16)            # poc lsb
        if is_p:
            w.u(0, 1)                    # no num_ref override
            w.u(0, 1)                    # no list modification
        if is_idr:
            w.u(0, 1)
            w.u(0, 1)
        else:
            w.u(0, 1)                    # sliding-window marking
        w.se(0)                          # qp_delta
        w.ue(1)                          # disable deblocking

    # ------------------------------------------------- encode
    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            return []
        t_frame = time.perf_counter()
        self._st = {"subpel": 0.0} if self.stats is not None else None
        y = np.asarray(host_array(frame.planes[0]), np.uint8)
        u = np.asarray(host_array(frame.planes[1]), np.uint8)
        v = np.asarray(host_array(frame.planes[2]), np.uint8)
        H, W = y.shape
        mb_w, mb_h = -(-W // 16), -(-H // 16)
        pw, ph = mb_w * 16, mb_h * 16
        if (pw, ph) != (W, H):
            y = np.pad(y, ((0, ph - H), (0, pw - W)), mode="edge")
            u = np.pad(u, ((0, (ph - H) // 2), (0, (pw - W) // 2)),
                       mode="edge")
            v = np.pad(v, ((0, (ph - H) // 2), (0, (pw - W) // 2)),
                       mode="edge")

        is_idr = self.frame_idx % self.gop == 0 \
            or self._recon is None
        frame_num = 0 if is_idr else (self.frame_idx % self.gop)
        poc = 2 * (self.frame_idx % self.gop)

        sps = SPS()
        sps.mb_width, sps.mb_height = mb_w, mb_h
        sps.log2_max_frame_num = 8
        sps.log2_max_poc_lsb = 16
        pps = PPS()
        pps.init_qp = self.qp
        pps.deblocking_filter_control_present = True
        dec = SliceDecoder(sps, pps)      # state mirror (mv/nnz)
        ry = np.zeros_like(y)
        ru = np.zeros_like(u)
        rv = np.zeros_like(v)

        w = _BW()
        self._slice_head(w, is_idr, not is_idr, frame_num, poc)

        if is_idr:
            for mby in range(mb_h):
                for mbx in range(mb_w):
                    self._encode_mb_i(w, dec, y, u, v, ry, ru, rv,
                                      mbx, mby)
        else:
            mvs = self._motion_search(y)
            skip_run = 0
            for mby in range(mb_h):
                for mbx in range(mb_w):
                    skip_run = self._encode_mb_p(
                        w, dec, y, u, v, ry, ru, rv, mbx, mby,
                        mvs, skip_run)
            if skip_run:
                w.ue(skip_run)

        payload = _nal(3, 5 if is_idr else 1, w.rbsp())
        data = b""
        if is_idr:
            crop_r, crop_b = pw - W, ph - H
            data += self._make_sps(mb_w, mb_h, crop_r, crop_b)
            data += self._make_pps()
        data += payload

        self._recon = (ry, ru, rv)
        if self._st is not None:
            st = self._st
            st["type"] = "I" if is_idr else "P"
            st["wall"] = (time.perf_counter() - t_frame) * 1e3
            st["mb_loop"] = st["wall"] - st["subpel"] - sum(
                st.get(k, 0.0) for k in ("h2d", "search", "d2h"))
            self.stats.append(st)
            self._st = None
        pts = frame.pts if frame.pts is not None else self.frame_idx
        self.frame_idx += 1
        return [Packet(data=data, pts=pts, dts=pts,
                       flags=PKT_FLAG_KEY if is_idr else 0,
                       time_base=frame.time_base)]

    # ---------------------------------------------- ME (on the device)
    def _motion_search(self, y):
        """Integer MVs (by, bx, 2) int32 (dy, dx) of the padded luma `y`
        against the reconstructed reference: both planes go up once as
        uint8, K2 and the argmin run on the encoder's device, the MVs
        come back.  A failure raises (the reference's catch-all, which
        returned zero MVs, is not ported)."""
        st = self._st
        t = time.perf_counter()
        cur = torch.from_numpy(y).to(self.device)
        ref = torch.from_numpy(self._recon[0]).to(self.device)
        t = self._mark(st, "h2d", t)
        mvs, _cost = motion_search(cur, ref, block=16, search=self.search)
        t = self._mark(st, "search", t)
        out = mvs.cpu().numpy()
        self._mark(st, "d2h", t)
        return out

    def _mark(self, st, name, t):
        """With stats on: wait for the device, book the ms since t under
        `name`; returns the time now."""
        if st is None:
            return t
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        st[name] = (now - t) * 1e3
        return now

    def _refine_subpel(self, refy, y, x, yy, mv, pmv):
        """Iterative half- then quarter-pel refinement around the
        integer ME result: SAD of the interpolated prediction plus a
        small rate term on the MV delta (keeps static content on the
        predicted/skip MV)."""
        src = y[yy:yy + 16, x:x + 16].astype(np.int64)
        lam = 4

        def cost(cand):
            sad = int(np.abs(src - mc_luma(
                refy, cand[0], cand[1], x, yy, 16, 16)
                .astype(np.int64)).sum())
            return sad + lam * (abs(cand[0] - pmv[0])
                                + abs(cand[1] - pmv[1]))

        best = mv
        best_cost = cost(mv)
        for step in (2, 1)[:self.subpel]:
            improved = True
            while improved:
                improved = False
                for dx, dy in ((-step, 0), (step, 0), (0, -step),
                               (0, step), (-step, -step),
                               (step, step), (-step, step),
                               (step, -step)):
                    cand = (best[0] + dx, best[1] + dy)
                    c = cost(cand)
                    if c < best_cost:
                        best, best_cost = cand, c
                        improved = True
        return best

    # ---------------------------------------------- intra MB
    def _encode_mb_i(self, w, dec, y, u, v, ry, ru, rv, mbx, mby):
        qp = self.qp
        x, yy = mbx * 16, mby * 16
        avail_l = mbx > 0
        avail_t = mby > 0
        # choose I16 mode by SAD of prediction vs source
        cand = [2]                          # DC always valid
        if avail_t:
            cand.append(0)                  # vertical
        if avail_l:
            cand.append(1)                  # horizontal
        src = y[yy:yy + 16, x:x + 16].astype(np.int64)
        best, best_cost = 2, None
        for m in cand:
            p = recon.pred16x16(ry, x, yy, m, avail_l, avail_t) \
                .astype(np.int64)
            c = int(np.abs(src - p).sum())
            if best_cost is None or c < best_cost:
                best, best_cost = m, c
        mode = best
        pred = recon.pred16x16(ry, x, yy, mode, avail_l,
                               avail_t).astype(np.int64)
        diff = src - pred

        # transform: 16 4x4 blocks; DC goes through Hadamard
        coeffs = np.zeros((4, 4, 16), np.int64)
        dcs = np.zeros((4, 4), np.int64)
        for by in range(4):
            for bx in range(4):
                blk = _fdct4(diff[by * 4:by * 4 + 4,
                                  bx * 4:bx * 4 + 4])
                dcs[by, bx] = blk[0, 0]
                coeffs[by, bx] = blk.reshape(16)
        qbits = 15 + qp // 6
        mf0 = _MF[qp % 6][0]
        f2 = 2 * ((1 << qbits) // 3)
        hdc = (_H4 @ dcs @ _H4.T) // 2
        dc_lv = np.sign(hdc) * ((np.abs(hdc) * mf0 + f2)
                                >> (qbits + 1))
        ac_lv = np.zeros((4, 4, 16), np.int64)
        for by in range(4):
            for bx in range(4):
                ac_lv[by, bx] = _quant4(coeffs[by, bx], qp, True,
                                        skip_dc=True)
        cbp_luma = 15 if ac_lv.any() else 0

        # chroma
        cpredu = recon.pred_chroma8x8(ru, x // 2, yy // 2, 0,
                                      avail_l, avail_t)
        cpredv = recon.pred_chroma8x8(rv, x // 2, yy // 2, 0,
                                      avail_l, avail_t)
        (cdc, cac, cbp_chroma) = self._chroma_transform(
            u, v, cpredu, cpredv, x // 2, yy // 2, qp)

        mb_type = 1 + mode + 4 * cbp_chroma + 12 * (cbp_luma == 15)
        w.ue(mb_type)
        w.ue(0)                             # chroma DC pred
        w.se(0)                             # mb_qp_delta
        # luma DC in (field-free) zigzag scan order
        nc = _nc_pred(dec.nnz_y, mbx * 4, mby * 4)
        dc_scan = dc_lv.reshape(16)[recon.ZIGZAG4]
        write_residual(w, list(dc_scan), 16, nc)
        ac_tot = np.zeros((4, 4), np.int64)
        if cbp_luma:
            for blk in range(16):
                dx, dy = _BLK_XY[blk]
                lv = ac_lv[dy, dx][recon.ZIGZAG4[1:]]
                nc = _nc_pred(dec.nnz_y, mbx * 4 + dx, mby * 4 + dy)
                t = write_residual(w, list(lv), 15, nc)
                dec.nnz_y[mby * 4 + dy, mbx * 4 + dx] = t
                ac_tot[dy, dx] = t
        else:
            dec.nnz_y[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 0
        self._write_chroma(w, dec, mbx, mby, cdc, cac, cbp_chroma)

        # reconstruction (decoder-exact): dequant + idct
        dc = recon.luma_dc_transform(dc_lv.reshape(16), qp)
        out = ry[yy:yy + 16, x:x + 16]
        for by in range(4):
            for bx in range(4):
                raster = ac_lv[by, bx].copy()
                block = recon.dequant4(raster, qp)
                block[0] = dc[by, bx]
                tgt = np.clip(pred[by * 4:by * 4 + 4,
                                   bx * 4:bx * 4 + 4], 0,
                              255).astype(np.uint8).copy()
                recon.idct4_add(tgt, block)
                out[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = tgt
        self._recon_chroma(ru, rv, cpredu, cpredv, cdc, cac,
                           x // 2, yy // 2, qp)
        dec.mb_intra[mby, mbx] = True
        dec.mb_16x16[mby, mbx] = True
        dec.mb_avail[mby, mbx] = True
        dec.blk_done[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = True
        dec.mv_ref[0, mby * 4:mby * 4 + 4,
                   mbx * 4:mbx * 4 + 4] = -1
        dec.intra4x4_modes[mby * 4:mby * 4 + 4,
                           mbx * 4:mbx * 4 + 4] = 2

    # ---------------------------------------------- inter MB
    def _encode_mb_p(self, w, dec, y, u, v, ry, ru, rv, mbx, mby,
                     mvs, skip_run):
        qp = self.qp
        x, yy = mbx * 16, mby * 16
        refy, refu, refv = self._recon
        mv_int = mvs[mby, mbx]
        mv = (int(mv_int[1]) * 4, int(mv_int[0]) * 4)   # (x, y) qpel
        if self.subpel:
            bx4p, by4p = mbx * 4, mby * 4
            pmv0 = tuple(dec._pred_mv(bx4p, by4p, 4, 4))
            t = time.perf_counter()
            mv = self._refine_subpel(refy, y, x, yy, mv, pmv0)
            if self._st is not None:
                self._st["subpel"] += (time.perf_counter() - t) * 1e3

        pred = mc_luma(refy, mv[0], mv[1], x, yy, 16, 16) \
            .astype(np.int64)
        src = y[yy:yy + 16, x:x + 16].astype(np.int64)
        diff = src - pred
        lv = np.zeros((4, 4, 16), np.int64)
        for by in range(4):
            for bx in range(4):
                lv[by, bx] = _quant4(
                    _fdct4(diff[by * 4:by * 4 + 4,
                                bx * 4:bx * 4 + 4]), qp, False)
        cbp_luma = 0
        for blk8 in range(4):
            bx8, by8 = blk8 & 1, blk8 >> 1
            if lv[by8 * 2:by8 * 2 + 2, bx8 * 2:bx8 * 2 + 2].any():
                cbp_luma |= 1 << blk8

        cpu = mc_chroma(refu, mv[0], mv[1], x // 2, yy // 2, 8, 8)
        cpv = mc_chroma(refv, mv[0], mv[1], x // 2, yy // 2, 8, 8)
        cdc, cac, cbp_chroma = self._chroma_transform(
            u, v, cpu, cpv, x // 2, yy // 2, qp, intra=False)

        # skip decision: decoder's skip MV rule
        bx4, by4 = mbx * 4, mby * 4
        a, ra, av_a = dec._mv_nbr(bx4 - 1, by4)
        bv, rb, av_b = dec._mv_nbr(bx4, by4 - 1)
        if not av_a or not av_b or (ra == 0 and a == (0, 0)) \
                or (rb == 0 and bv == (0, 0)):
            skip_mv = (0, 0)
        else:
            skip_mv = dec._pred_mv(bx4, by4, 4, 4)
        skip_mv = tuple(skip_mv)
        if mv != skip_mv and (cbp_luma or cbp_chroma):
            # explicit skip candidate: if the skip MV also quantizes
            # to an all-zero residual, prefer the free macroblock
            sp = mc_luma(refy, skip_mv[0], skip_mv[1], x, yy,
                         16, 16).astype(np.int64)
            sdiff = src - sp
            s_zero = True
            for by in range(4):
                if not s_zero:
                    break
                for bx in range(4):
                    if _quant4(_fdct4(
                            sdiff[by * 4:by * 4 + 4,
                                  bx * 4:bx * 4 + 4]), qp,
                            False).any():
                        s_zero = False
                        break
            if s_zero:
                scpu = mc_chroma(refu, skip_mv[0], skip_mv[1],
                                 x // 2, yy // 2, 8, 8)
                scpv = mc_chroma(refv, skip_mv[0], skip_mv[1],
                                 x // 2, yy // 2, 8, 8)
                _, _, scbp = self._chroma_transform(
                    u, v, scpu, scpv, x // 2, yy // 2, qp,
                    intra=False)
                if scbp == 0:
                    mv = skip_mv
                    pred = sp
                    cpu, cpv = scpu, scpv
                    cbp_luma = cbp_chroma = 0
                    lv[:] = 0
        if cbp_luma == 0 and cbp_chroma == 0 and mv == skip_mv:
            dec._decode_mb_skip(mbx, mby, qp)
            dec.mb_avail[mby, mbx] = True
            # reconstruct = pure MC
            ry[yy:yy + 16, x:x + 16] = pred.astype(np.uint8)
            ru[yy // 2:yy // 2 + 8, x // 2:x // 2 + 8] = cpu
            rv[yy // 2:yy // 2 + 8, x // 2:x // 2 + 8] = cpv
            return skip_run + 1

        w.ue(skip_run)
        pmv = dec._pred_mv(bx4, by4, 4, 4)
        w.ue(0)                              # P_16x16
        w.se(mv[0] - pmv[0])
        w.se(mv[1] - pmv[1])
        cbp = cbp_luma + 16 * cbp_chroma
        w.ue(HT.GOLOMB_TO_INTER_CBP.index(cbp))
        if cbp:
            w.se(0)                          # mb_qp_delta
        if cbp_luma:
            for blk in range(16):
                dx, dy = _BLK_XY[blk]
                if not (cbp_luma & (1 << (blk >> 2))):
                    dec.nnz_y[by4 + dy, bx4 + dx] = 0
                    continue
                sl = lv[dy, dx][recon.ZIGZAG4]
                nc = _nc_pred(dec.nnz_y, bx4 + dx, by4 + dy)
                t = write_residual(w, list(sl), 16, nc)
                dec.nnz_y[by4 + dy, bx4 + dx] = t
        else:
            dec.nnz_y[by4:by4 + 4, bx4:bx4 + 4] = 0
        self._write_chroma(w, dec, mbx, mby, cdc, cac, cbp_chroma)

        dec._store_mv(bx4, by4, 4, 4, mv)
        dec.mb_16x16[mby, mbx] = True
        dec.mb_avail[mby, mbx] = True

        # reconstruction
        out = ry[yy:yy + 16, x:x + 16]
        for by in range(4):
            for bx in range(4):
                block = recon.dequant4(lv[by, bx], qp)
                tgt = np.clip(pred[by * 4:by * 4 + 4,
                                   bx * 4:bx * 4 + 4], 0,
                              255).astype(np.uint8).copy()
                recon.idct4_add(tgt, block)
                out[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = tgt
        self._recon_chroma(ru, rv, cpu, cpv, cdc, cac, x // 2,
                           yy // 2, qp)
        return 0

    # ---------------------------------------------- chroma helpers
    def _chroma_qp(self, qp):
        return HT.CHROMA_QP_8BIT[min(max(qp, 0), 51)]

    def _chroma_transform(self, u, v, cpu, cpv, cx, cy, qp,
                          intra=True):
        qpc = self._chroma_qp(qp)
        qbits = 15 + qpc // 6
        mf0 = _MF[qpc % 6][0]
        f2 = 2 * ((1 << qbits) // (3 if intra else 6))
        cdc = np.zeros((2, 4), np.int64)
        cac = np.zeros((2, 4, 16), np.int64)
        for ci, (plane, cpred) in enumerate(((u, cpu), (v, cpv))):
            srcc = plane[cy:cy + 8, cx:cx + 8].astype(np.int64)
            diff = srcc - cpred.astype(np.int64)
            dcs = np.zeros(4, np.int64)
            for blk in range(4):
                dx, dy = blk & 1, blk >> 1
                c = _fdct4(diff[dy * 4:dy * 4 + 4, dx * 4:dx * 4 + 4])
                dcs[blk] = c[0, 0]
                cac[ci, blk] = _quant4(c.reshape(16), qpc, intra,
                                       skip_dc=True)
            d = dcs.reshape(2, 2)
            t = np.array([[d[0, 0] + d[0, 1] + d[1, 0] + d[1, 1],
                           d[0, 0] - d[0, 1] + d[1, 0] - d[1, 1]],
                          [d[0, 0] + d[0, 1] - d[1, 0] - d[1, 1],
                           d[0, 0] - d[0, 1] - d[1, 0] + d[1, 1]]],
                         np.int64)
            cdc[ci] = (np.sign(t) * ((np.abs(t) * mf0 + f2)
                                     >> (qbits + 1))).reshape(4)
        if cac.any():
            cbp_chroma = 2
        elif cdc.any():
            cbp_chroma = 1
        else:
            cbp_chroma = 0
        return cdc, cac, cbp_chroma

    def _write_chroma(self, w, dec, mbx, mby, cdc, cac, cbp_chroma):
        if cbp_chroma:
            for ci in range(2):
                write_residual(w, list(cdc[ci]), 4, -1)
        for ci, nnz in enumerate((dec.nnz_u, dec.nnz_v)):
            for blk in range(4):
                dx, dy = blk & 1, blk >> 1
                bx2, by2 = mbx * 2 + dx, mby * 2 + dy
                if cbp_chroma == 2:
                    lv = cac[ci, blk][recon.ZIGZAG4[1:]]
                    nc = _nc_pred(nnz, bx2, by2)
                    t = write_residual(w, list(lv), 15, nc)
                    nnz[by2, bx2] = t
                else:
                    nnz[by2, bx2] = 0

    def _recon_chroma(self, ru, rv, cpu, cpv, cdc, cac, cx, cy, qp):
        qpc = self._chroma_qp(qp)
        for ci, (plane, cpred) in enumerate(((ru, cpu), (rv, cpv))):
            dc = recon.chroma_dc_transform(cdc[ci], qpc)
            out = plane[cy:cy + 8, cx:cx + 8]
            for blk in range(4):
                dx, dy = blk & 1, blk >> 1
                block = recon.dequant4(cac[ci, blk], qpc)
                block[0] = dc[dy, dx]
                tgt = np.asarray(cpred[dy * 4:dy * 4 + 4,
                                       dx * 4:dx * 4 + 4],
                                 np.uint8).copy()
                recon.idct4_add(tgt, block)
                out[dy * 4:dy * 4 + 4, dx * 4:dx * 4 + 4] = tgt

    def load_state(self, state: dict) -> None:
        """Take over an encoder state (from state_from_reference)."""
        unknown = set(state) - set(_STATE_KEYS)
        if unknown:
            raise ValueError(f"not encoder state: {sorted(unknown)}")
        for k, val in state.items():
            setattr(self, k, val)


# ------------------------------------------------------ carrying state

_STATE_KEYS = ("_recon", "frame_idx", "qp", "gop", "search", "subpel")


def state_from_reference(ref_encoder) -> dict:
    """The state of a reference (ffmpeg_tpu) H264Encoder as the port's
    encoder holds it, for `H264Encoder.load_state`: the reconstructed
    reference picture (host uint8 planes, copied), the frame index and
    the options that steer the next frame.  The encoder has no weights;
    this is what lets one P frame be encoded from the same reference
    picture in both packages."""
    st = {k: getattr(ref_encoder, k) for k in _STATE_KEYS}
    if st["_recon"] is not None:
        st["_recon"] = tuple(np.array(p, np.uint8) for p in st["_recon"])
    for k in _STATE_KEYS[1:]:
        st[k] = int(st[k])
    return st
