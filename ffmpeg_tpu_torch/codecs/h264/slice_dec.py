"""H.264 slice parsing: header + CAVLC macroblock layer
(reference: libavcodec/h264_slice.c + h264_cavlc.c + h264_mb.c).

PARSE ONLY — this stage never touches pixels. It fills the per-frame
tensors (dequantized coefficient blocks, intra modes, motion vectors,
reference indices, qp/nnz maps) that reconstruction consumes:
recon_host.py is the exact-integer numpy path, recon_tpu.py the batched
device path (SURVEY §7 step 7: host entropy → TPU transform split at the
decode_mb_cabac / hl_decode_mb boundary of h264_slice.c:2571).

The port's copy of ffmpeg_tpu/codecs/h264/slice_dec.py, held equal to it by
tests/test_torch_h264_host.py."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ...utils.error import InvalidData, NotSupported
from . import tables as T
from .bits import Bits
from .cavlc import decode_residual
from .params import PPS, SPS, ZZ8
from . import recon

I_PCM = 25


@dataclass
class SliceHeader:
    first_mb: int = 0
    slice_type: int = 2           # 0 P, 1 B, 2 I (mod 5)
    pps_id: int = 0
    frame_num: int = 0
    idr: bool = False
    qp: int = 26
    disable_deblocking: int = 0
    alpha_c0_offset: int = 0
    beta_offset: int = 0
    cabac_init_idc: int = 0
    direct_spatial: bool = True
    poc_lsb: int = 0
    num_ref: tuple = (1, 1)      # active ref counts (list0, list1)
    # ref_pic_list_modification ops per list: [(idc, value), ...]
    reorder: tuple = ((), ())
    # memory management control ops: [(op, value), ...]; None = sliding
    mmco: Optional[tuple] = None
    # explicit weighted prediction (pred_weight_table, 7.3.3.2):
    # weights[lst][ref] = (wy, oy, wcb, ocb, wcr, ocr); None = default
    luma_log2_denom: int = 0
    chroma_log2_denom: int = 0
    weights: Optional[tuple] = None
    field_pic: bool = False       # PAFF field picture
    bottom_field: bool = False
    long_term_ref: bool = False   # IDR long_term_reference_flag


def parse_slice_header(b: Bits, nal_type: int, sps: SPS,
                       pps: PPS, ref_idc: int = 1) -> SliceHeader:
    sh = SliceHeader()
    sh.first_mb = b.ue()
    sh.slice_type = b.ue() % 5
    sh.pps_id = b.ue()
    sh.idr = nal_type == 5
    sh.frame_num = b.get(sps.log2_max_frame_num)
    if not sps.frame_mbs_only:
        sh.field_pic = bool(b.get1())
        if sh.field_pic:
            sh.bottom_field = bool(b.get1())
    if sh.idr:
        b.ue()                    # idr_pic_id
    if sps.poc_type == 0:
        sh.poc_lsb = b.get(sps.log2_max_poc_lsb)
        if pps.pic_order_present and not sh.field_pic:
            b.se()                # delta_pic_order_cnt_bottom
    elif sps.poc_type == 1 and not sps.delta_pic_order_always_zero:
        b.se()
        if pps.pic_order_present:
            b.se()
    if pps.redundant_pic_cnt_present:
        b.ue()
    if sh.slice_type == 1:        # B
        sh.direct_spatial = bool(b.get1())
    if sh.slice_type in (0, 1):
        n0, n1 = pps.num_ref_idx
        if b.get1():              # num_ref_idx_active_override
            n0 = b.ue() + 1
            if sh.slice_type == 1:
                n1 = b.ue() + 1
        sh.num_ref = (n0, n1 if sh.slice_type == 1 else 1)
        reorder = [[], []]
        nlists = 2 if sh.slice_type == 1 else 1
        for lst in range(nlists):
            if not b.get1():      # ref_pic_list_modification_flag
                continue
            while True:
                idc = b.ue()
                if idc == 3:
                    break
                if idc > 3:
                    raise InvalidData("h264: bad modification idc")
                reorder[lst].append((idc, b.ue()))
        sh.reorder = (tuple(reorder[0]), tuple(reorder[1]))
    # pred_weight_table (7.3.3.2)
    if (pps.weighted_pred and sh.slice_type == 0) or \
            (pps.weighted_bipred_idc == 1 and sh.slice_type == 1):
        sh.luma_log2_denom = b.ue()
        sh.chroma_log2_denom = b.ue()
        dl, dc = 1 << sh.luma_log2_denom, 1 << sh.chroma_log2_denom
        weights = []
        nlists = 2 if sh.slice_type == 1 else 1
        for lst in range(nlists):
            lw = []
            for _r in range(sh.num_ref[lst]):
                wy, oy = dl, 0
                wcb = wcr = dc
                ocb = ocr = 0
                if b.get1():      # luma_weight_flag
                    wy, oy = b.se(), b.se()
                if b.get1():      # chroma_weight_flag
                    wcb, ocb = b.se(), b.se()
                    wcr, ocr = b.se(), b.se()
                lw.append((wy, oy, wcb, ocb, wcr, ocr))
            weights.append(tuple(lw))
        while len(weights) < 2:
            weights.append(())
        sh.weights = tuple(weights)
    # dec_ref_pic_marking (only for reference pictures)
    if ref_idc != 0:
        if sh.idr:
            b.get1()              # no_output_of_prior_pics
            sh.long_term_ref = bool(b.get1())
        elif b.get1():            # adaptive_ref_pic_marking (8.2.5.4)
            ops = []
            while True:
                op = b.ue()
                if op == 0:
                    break
                if op in (1, 2, 4, 6):
                    ops.append((op, b.ue()))
                elif op == 3:     # short -> long: two operands
                    ops.append((3, (b.ue(), b.ue())))
                elif op == 5:
                    ops.append((5, 0))
                else:
                    raise InvalidData(f"h264: mmco {op}")
            sh.mmco = tuple(ops)
    if pps.cabac and sh.slice_type != 2:
        sh.cabac_init_idc = b.ue()
    sh.qp = pps.init_qp + b.se()
    if pps.deblocking_filter_control_present:
        sh.disable_deblocking = b.ue()
        if sh.disable_deblocking != 1:
            sh.alpha_c0_offset = b.se() * 2
            sh.beta_offset = b.se() * 2
    return sh


# block index (0..15) → (x4, y4) position inside the MB, zscan order
_BLK_XY = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (3, 0), (2, 1), (3, 1),
           (0, 2), (1, 2), (0, 3), (1, 3), (2, 2), (3, 2), (2, 3), (3, 3)]


class SliceDecoder:
    """Decodes one frame's I-slice NALs into planes."""

    def __init__(self, sps: SPS, pps: PPS):
        self.sps = sps
        self.pps = pps
        w, h = sps.mb_width * 16, sps.mb_height * 16
        self.bd = sps.bit_depth_luma
        self.qp_bd_offset = 6 * (self.bd - 8)
        pix = np.uint8 if self.bd == 8 else np.uint16
        self.y = np.full((h, w), 0, pix)
        self.u = np.full((h // 2, w // 2), 0, pix)
        self.v = np.full((h // 2, w // 2), 0, pix)
        nmbx, nmby = sps.mb_width, sps.mb_height
        # ---- parse outputs consumed by recon_host / recon_tpu ----
        # dequantized residual blocks, raster coefficient order (DC of
        # I16/chroma already substituted by the parse stage)
        self.coeff_y = np.zeros((nmby * 4, nmbx * 4, 16), np.int32)
        self.coeff_u = np.zeros((nmby * 2, nmbx * 2, 16), np.int32)
        self.coeff_v = np.zeros((nmby * 2, nmbx * 2, 16), np.int32)
        self.i4_pred = np.full((nmby * 4, nmbx * 4), -1, np.int32)
        self.i16_mode = np.full((nmby, nmbx), -1, np.int32)
        # 8x8 transform state (High profile)
        self.coeff8_y = np.zeros((nmby * 2, nmbx * 2, 64), np.int32)
        self.trans8 = np.zeros((nmby, nmbx), bool)
        self.i8_pred = np.full((nmby * 2, nmbx * 2), -1, np.int32)
        self.blk8_avail = np.zeros((nmby * 2, nmbx * 2, 4), bool)
        self.chroma_imode = np.zeros((nmby, nmbx), np.int32)
        self.is_pcm = np.zeros((nmby, nmbx), bool)
        self.pcm = {}                 # mb addr -> (y16x16, u8x8, v8x8)
        # pixel-availability flags recorded at parse time (decode order):
        # per-4x4 [l, t, tr, tl] for I_NxN, per-MB [l, t] for I16/chroma
        self.blk_avail = np.zeros((nmby * 4, nmbx * 4, 4), bool)
        self.mb_nbr_avail = np.zeros((nmby, nmbx, 2), bool)
        self.mb_avail = np.zeros((nmby, nmbx), bool)
        # per-4x4-block nonzero counts for CAVLC contexts (luma + 2 chroma)
        self.nnz_y = np.full((nmby * 4, nmbx * 4), -1, np.int32)
        self.nnz_u = np.full((nmby * 2, nmbx * 2), -1, np.int32)
        self.nnz_v = np.full((nmby * 2, nmbx * 2), -1, np.int32)
        self.intra4x4_modes = np.full((nmby * 4, nmbx * 4), -1, np.int32)
        self.blk_done = np.zeros((nmby * 4, nmbx * 4), bool)
        self.mb_qp = np.zeros((nmby, nmbx), np.int32)
        self.mb_intra = np.zeros((nmby, nmbx), bool)
        self.mb_16x16 = np.zeros((nmby, nmbx), bool)   # 16x16-or-intra
        # inter state: per-4x4 motion vectors (quarter pel) per list
        self.mv = np.zeros((2, nmby * 4, nmbx * 4, 2), np.int32)
        self.mv_ref = np.full((2, nmby * 4, nmbx * 4), -1, np.int32)
        self.ref_frame = None       # legacy single ref (P path): planes
        self.list0 = []             # DPB entries for list 0 (planes, ...)
        self.list1 = []
        self.num_ref = (1, 1)       # active ref counts per list
        self.poc = 0
        # coefficient scan tables; swapped to the field scans
        # (Table 8-12/8-13) for field pictures by the caller
        self.scan4 = recon.ZIGZAG4
        self.scan8 = np.asarray(ZZ8)
        # per-list 4x4 done mask for the MB currently being decoded
        # (B_8x8: in-MB neighbour availability is per list, the
        # reference's per-list ref_cache PART_NOT_AVAILABLE state)
        self._cur_mb = (-1, -1)
        self._curmask = np.zeros((2, 4, 4), bool)

    def _qp_add(self, qp: int, delta: int) -> int:
        """mb_qp_delta update (spec 7.4.5: QPY wraps in
        [-QpBdOffsetY, 51])."""
        off = self.qp_bd_offset
        return ((qp + delta + 52 + 2 * off) % (52 + off)) - off

    def _chroma_qp(self, qp: int, coff: int) -> int:
        """QP'c for dequant (spec 8.5.8 + Table 8-15, incl.
        QpBdOffsetC)."""
        off = self.qp_bd_offset
        qpi = max(-off, min(51, qp + coff))
        qpc = qpi if qpi < 0 else T.CHROMA_QP_8BIT[qpi]
        return qpc + off

    def _te_ref(self, b: Bits, lst: int) -> int:
        """ref_idx_lX as te(v) (spec 7.3.5.2 / 9.1.1): 1-bit inverted
        flag when two refs are active, ue(v) otherwise."""
        n = self.num_ref[lst]
        if n <= 1:
            return 0
        ref = (1 - b.get1()) if n == 2 else b.ue()
        lstref = self.list0 if lst == 0 else self.list1
        if ref >= n or ref >= len(lstref):
            raise InvalidData("h264: ref_idx out of range")
        return ref

    # --- CAVLC context ---------------------------------------------------------
    def _pred_nnz(self, nnz, bx, by):
        left = int(nnz[by, bx - 1]) if bx > 0 else -1
        top = int(nnz[by - 1, bx]) if by > 0 else -1
        if left >= 0 and top >= 0:
            return (left + top + 1) >> 1
        if left >= 0:
            return left
        if top >= 0:
            return top
        return 0

    # --- macroblock decode --------------------------------------------------------
    def decode_slice(self, b: Bits, sh: SliceHeader):
        sps = self.sps
        qp = sh.qp
        mb_addr = sh.first_mb
        nmbx = sps.mb_width
        is_p = sh.slice_type == 0
        is_b = sh.slice_type == 1
        self.num_ref = sh.num_ref
        self.direct_spatial = sh.direct_spatial
        if is_p and self.ref_frame is None and not self.list0:
            raise InvalidData("h264: P slice without reference")
        if is_b and (not self.list0 or not self.list1):
            raise InvalidData("h264: B slice without both references")
        while True:
            mbx, mby = mb_addr % nmbx, mb_addr // nmbx
            if mby >= sps.mb_height:
                break
            if is_p or is_b:
                skip_run = b.ue()
                for _ in range(skip_run):
                    mbx, mby = mb_addr % nmbx, mb_addr // nmbx
                    if mby >= sps.mb_height:
                        raise InvalidData("h264: skip run overflow")
                    if is_b:
                        self._decode_mb_b_direct(mbx, mby, qp)
                    else:
                        self._decode_mb_skip(mbx, mby, qp)
                    self.mb_avail[mby, mbx] = True
                    mb_addr += 1
                if not b.more_rbsp():
                    break
                mbx, mby = mb_addr % nmbx, mb_addr // nmbx
                if mby >= sps.mb_height:
                    break
                mb_type = b.ue()
                if is_b:
                    if mb_type >= 23:
                        qp = self._decode_mb_i(b, mbx, mby, qp,
                                               mb_type=mb_type - 23)
                    else:
                        qp = self._decode_mb_b(b, mbx, mby, qp, mb_type)
                elif mb_type >= 5:
                    qp = self._decode_mb_i(b, mbx, mby, qp,
                                           mb_type=mb_type - 5)
                else:
                    qp = self._decode_mb_p(b, mbx, mby, qp, mb_type)
            else:
                qp = self._decode_mb_i(b, mbx, mby, qp)
            self.mb_avail[mby, mbx] = True
            mb_addr += 1
            if not b.more_rbsp():
                break

    # --- B slices (spatial direct only) ---------------------------------------------
    # mb_type 4..21: (is_8x16, mask_part0, mask_part1) with 1=L0 2=L1 3=Bi
    _B_TWO = {4: (0, 1, 1), 5: (1, 1, 1), 6: (0, 2, 2), 7: (1, 2, 2),
              8: (0, 1, 2), 9: (1, 1, 2), 10: (0, 2, 1), 11: (1, 2, 1),
              12: (0, 1, 3), 13: (1, 1, 3), 14: (0, 2, 3), 15: (1, 2, 3),
              16: (0, 3, 1), 17: (1, 3, 1), 18: (0, 3, 2), 19: (1, 3, 2),
              20: (0, 3, 3), 21: (1, 3, 3)}

    def _direct_pred(self, bx, by):
        """Spatial-direct ref/mv derivation (h264_direct.c
        pred_spatial_direct_motion top): unsigned-min ref + match rule."""
        from .inter import median_mv
        out = []
        for lst in range(2):
            nbrs = []
            for nb in ((bx - 1, by), (bx, by - 1), (bx + 4, by - 1)):
                mv, r, av = self._mv_nbr(*nb, lst)
                if not av and nb == (bx + 4, by - 1):
                    mv, r, av = self._mv_nbr(bx - 1, by - 1, lst)
                nbrs.append((mv, r if av else -2))
            refs_u = [r & 0xFFFFFFFF for _mv, r in nbrs]
            ref = min(refs_u)
            ref = ref if ref < 0x80000000 else (ref - (1 << 32))
            if ref >= 0:
                matches = [i for i, (_mv, r) in enumerate(nbrs) if r == ref]
                if len(matches) > 1:
                    mv = median_mv(nbrs[0][0], nbrs[1][0], nbrs[2][0])
                else:
                    mv = nbrs[matches[0]][0]
            else:
                mv = (0, 0)
            out.append((ref, mv))
        return out

    def _decode_mb_b_direct(self, mbx, mby, qp, residual_cb=None,
                            quads=None):
        """B_Direct_16x16 / B_Skip (spatial, 8.4.1.2.2 +
        direct_8x8_inference; mirrors pred_spatial_direct_motion).
        `quads` restricts the fill to those 8x8 quadrants
        (B_Direct_8x8 sub-macroblocks)."""
        if not getattr(self, "direct_spatial", True):
            return self._decode_mb_b_direct_temporal(
                mbx, mby, qp, residual_cb, quads)
        bx, by = mbx * 4, mby * 4
        (r0, mvd0), (r1, mvd1) = self._direct_pred(bx, by)
        if r0 < 0 and r1 < 0:
            r0 = r1 = 0
            mvd0 = mvd1 = (0, 0)
        mv = [mvd0 if r0 >= 0 else (0, 0), mvd1 if r1 >= 0 else (0, 0)]
        refs = [r0, r1]
        col = self.list1[0]
        col_intra = bool(col["intra"][mby, mbx])
        col16 = bool(col["mb16"][mby, mbx])
        short = col.get("short_term", True)

        def col_zero_at(cbx4, cby4):
            if col_intra or not short:
                return False
            if int(col["ref"][cby4 & ~1 if False else cby4,
                              cbx4]) != 0:
                return False
            cmv = col["mv"][cby4, cbx4]
            return abs(int(cmv[0])) <= 1 and abs(int(cmv[1])) <= 1

        # per-4x4 final mvs
        final = np.zeros((2, 4, 4, 2), np.int64)
        for lst in range(2):
            final[lst, :, :, 0] = mv[lst][0]
            final[lst, :, :, 1] = mv[lst][1]
        if not (mv[0] == (0, 0) and mv[1] == (0, 0)):
            if col16:
                # single decision from the col MB's first block
                if col_zero_at(bx, by):
                    if refs[0] == 0:
                        final[0] = 0
                    if refs[1] == 0:
                        final[1] = 0
            else:
                for q in range(4):
                    x8, y8 = q & 1, q >> 1
                    # quadrant col ref from its top-left block; corner
                    # 4x4 mv per direct_8x8_inference
                    qref = int(col["ref"][by + y8 * 2, bx + x8 * 2])
                    if col_intra or not short or qref != 0:
                        continue
                    cmv = col["mv"][by + y8 * 3, bx + x8 * 3]
                    if abs(int(cmv[0])) <= 1 and abs(int(cmv[1])) <= 1:
                        if refs[0] == 0:
                            final[0, y8 * 2:y8 * 2 + 2,
                                  x8 * 2:x8 * 2 + 2] = 0
                        if refs[1] == 0:
                            final[1, y8 * 2:y8 * 2 + 2,
                                  x8 * 2:x8 * 2 + 2] = 0
        for sy in range(4):
            for sx in range(4):
                if quads is not None and \
                        ((sy >> 1) * 2 + (sx >> 1)) not in quads:
                    continue
                cbx, cby = bx + sx, by + sy
                mvs = [None, None]
                for lst in range(2):
                    if refs[lst] >= 0:
                        mvs[lst] = (int(final[lst, sy, sx, 0]),
                                    int(final[lst, sy, sx, 1]))
                        self.mv[lst, cby, cbx] = mvs[lst]
                        self.mv_ref[lst, cby, cbx] = refs[lst]
                    else:
                        self.mv[lst, cby, cbx] = 0
                        self.mv_ref[lst, cby, cbx] = -1
                self.blk_done[cby, cbx] = True
                self.intra4x4_modes[cby, cbx] = 2
        if quads is not None:
            return
        self.blk_done[by:by + 4, bx:bx + 4] = True
        self.intra4x4_modes[by:by + 4, bx:bx + 4] = 2
        self.mb_16x16[mby, mbx] = True
        if residual_cb is None:
            self.nnz_y[by:by + 4, bx:bx + 4] = 0
            self.nnz_u[mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0
            self.nnz_v[mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0
        self.mb_qp[mby, mbx] = qp

    def _decode_mb_b_direct_temporal(self, mbx, mby, qp,
                                     residual_cb=None, quads=None):
        """Temporal direct (8.4.1.2.3 / h264_direct.c
        pred_temp_direct_motion): co-located list1 MVs scaled by POC
        distances; refIdxL0 maps the col block's reference POC into
        the current list0."""
        bx, by = mbx * 4, mby * 4
        col = self.list1[0]
        poc1 = col["poc"]
        cur = self.poc
        pocs0 = [e["poc"] for e in self.list0]
        col_intra_mb = bool(col["intra"][mby, mbx])
        short = col.get("short_term", True)
        infer8 = self.sps.direct_8x8_inference
        ref_poc = col.get("ref_poc")

        def trunc_div(a, b):
            q = abs(a) // abs(b)
            return q if (a >= 0) == (b >= 0) else -q

        for sy in range(4):
            for sx in range(4):
                if quads is not None and \
                        ((sy >> 1) * 2 + (sx >> 1)) not in quads:
                    continue
                if infer8:
                    csx = (sx & 2) + ((sx & 2) >> 1)   # 0 or 3
                    csy = (sy & 2) + ((sy & 2) >> 1)
                    rsx, rsy = (sx & 2), (sy & 2)      # quadrant TL
                else:
                    csx, csy = sx, sy
                    rsx, rsy = sx, sy
                cref = int(col["ref"][by + rsy, bx + rsx])
                if col_intra_mb or cref < 0:
                    mvcol = (0, 0)
                    r0 = 0
                    poc0 = pocs0[0] if pocs0 else cur
                else:
                    cmv = col["mv"][by + csy, bx + csx]
                    mvcol = (int(cmv[0]), int(cmv[1]))
                    cpoc = int(ref_poc[by + rsy, bx + rsx]) \
                        if ref_poc is not None else None
                    r0 = 0
                    poc0 = pocs0[0] if pocs0 else cur
                    if cpoc is not None:
                        for i, pv in enumerate(pocs0):
                            if pv == cpoc:
                                r0, poc0 = i, pv
                                break
                if not short or poc0 == poc1:
                    mv0 = mvcol
                    mv1 = (0, 0)
                else:
                    tb = min(max(cur - poc0, -128), 127)
                    td = min(max(poc1 - poc0, -128), 127)
                    tx = trunc_div(16384 + (abs(td) >> 1), td)
                    dsf = min(max((tb * tx + 32) >> 6, -1024), 1023)
                    mv0 = ((dsf * mvcol[0] + 128) >> 8,
                           (dsf * mvcol[1] + 128) >> 8)
                    mv1 = (mv0[0] - mvcol[0], mv0[1] - mvcol[1])
                cbx, cby = bx + sx, by + sy
                self.mv[0, cby, cbx] = mv0
                self.mv_ref[0, cby, cbx] = r0
                self.mv[1, cby, cbx] = mv1
                self.mv_ref[1, cby, cbx] = 0
                self.blk_done[cby, cbx] = True
                self.intra4x4_modes[cby, cbx] = 2
        if quads is not None:
            return
        self.blk_done[by:by + 4, bx:bx + 4] = True
        self.intra4x4_modes[by:by + 4, bx:bx + 4] = 2
        self.mb_16x16[mby, mbx] = True
        if residual_cb is None:
            self.nnz_y[by:by + 4, bx:bx + 4] = 0
            self.nnz_u[mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0
            self.nnz_v[mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0
        self.mb_qp[mby, mbx] = qp

    # B sub_mb_type (Table 7-18): st -> (npart, w4, h4, list mask)
    _B_SUB = {1: (1, 2, 2, 1), 2: (1, 2, 2, 2), 3: (1, 2, 2, 3),
              4: (2, 2, 1, 1), 5: (2, 1, 2, 1), 6: (2, 2, 1, 2),
              7: (2, 1, 2, 2), 8: (2, 2, 1, 3), 9: (2, 1, 2, 3),
              10: (4, 1, 1, 1), 11: (4, 1, 1, 2), 12: (4, 1, 1, 3)}
    _B_SUB_OFFS = {(1, 2, 2): [(0, 0)],
                   (2, 2, 1): [(0, 0), (0, 1)],
                   (2, 1, 2): [(0, 0), (1, 0)],
                   (4, 1, 1): [(0, 0), (1, 0), (0, 1), (1, 1)]}

    def _decode_mb_b8x8(self, b, mbx, mby, qp):
        """B_8x8 sub-macroblock prediction (7.3.5.2 sub_mb_pred,
        B sub types incl. B_Direct_8x8)."""
        bx, by = mbx * 4, mby * 4
        subs = [b.ue() for _ in range(4)]
        if any(st > 12 for st in subs):
            raise InvalidData("h264: bad B sub_mb_type")
        self._cur_mb = (mbx, mby)
        self._curmask = np.zeros((2, 4, 4), bool)
        direct_q = {q for q, st in enumerate(subs) if st == 0}
        if direct_q:
            self._decode_mb_b_direct(mbx, mby, qp, residual_cb=True,
                                     quads=direct_q)
            for q in direct_q:
                x8, y8 = q & 1, q >> 1
                self._curmask[:, y8 * 2:y8 * 2 + 2,
                              x8 * 2:x8 * 2 + 2] = True
            # the interior top-right cells (blocks (2,0)/(2,2)) are
            # re-marked unavailable after the direct fill
            # (h264_cavlc.c: ref_cache[scan8[4]]=ref_cache[scan8[12]]
            # = PART_NOT_AVAILABLE) until explicitly re-stored
            self._curmask[:, 0, 2] = False
            self._curmask[:, 2, 2] = False
        refs8 = {0: [0] * 4, 1: [0] * 4}
        for lst in range(2):
            for q, st in enumerate(subs):
                if st and (self._B_SUB[st][3] & (1 << lst)):
                    refs8[lst][q] = self._te_ref(b, lst)
        for lst in range(2):
            for q, st in enumerate(subs):
                x8, y8 = q & 1, q >> 1
                if st == 0:
                    continue
                npart, w4, h4, mask = self._B_SUB[st]
                if not (mask & (1 << lst)):
                    # list not used: the quadrant still counts as an
                    # available neighbour with refIdx -1 / zero MV
                    # (the reference's LIST_NOT_USED cache fill)
                    ys = slice(by + y8 * 2, by + y8 * 2 + 2)
                    xs = slice(bx + x8 * 2, bx + x8 * 2 + 2)
                    self.mv[lst, ys, xs] = 0
                    self.mv_ref[lst, ys, xs] = -1
                    self._curmask[lst, y8 * 2:y8 * 2 + 2,
                                  x8 * 2:x8 * 2 + 2] = True
                    continue
                for ox, oy in self._B_SUB_OFFS[(npart, w4, h4)]:
                    mvd = (b.se(), b.se())
                    px = bx + x8 * 2 + ox
                    py = by + y8 * 2 + oy
                    pred = self._pred_mv(px, py, w4, h4, lst,
                                         refs8[lst][q])
                    mv = (pred[0] + mvd[0], pred[1] + mvd[1])
                    self._store_mv(px, py, w4, h4, mv, lst,
                                   refs8[lst][q])
                    self._curmask[lst,
                                  py - by:py - by + h4,
                                  px - bx:px - bx + w4] = True
        self._cur_mb = (-1, -1)
        self.blk_done[by:by + 4, bx:bx + 4] = True
        self.intra4x4_modes[by:by + 4, bx:bx + 4] = 2
        return subs

    def _decode_mb_b(self, b, mbx, mby, qp, mb_type):
        bx, by = mbx * 4, mby * 4
        self.mb_16x16[mby, mbx] = mb_type <= 3
        subs = None
        if mb_type == 22:
            subs = self._decode_mb_b8x8(b, mbx, mby, qp)
            parts, masks = [], []
        elif mb_type == 0:
            self._decode_mb_b_direct(mbx, mby, qp, residual_cb=True)
            parts, masks = [], []
        elif mb_type <= 3:
            parts = [(0, 0, 4, 4)]
            masks = [mb_type]      # 1=L0 2=L1 3=Bi
        else:
            v8x16, m0, m1 = self._B_TWO[mb_type]
            parts = [(0, 0, 2, 4), (2, 0, 2, 4)] if v8x16 else \
                [(0, 0, 4, 2), (0, 2, 4, 2)]
            masks = [m0, m1]
        # ref_idx fields first (list-major), then mvds (list-major)
        prefs = {0: [0] * len(parts), 1: [0] * len(parts)}
        for lst in range(2):
            for i, m in enumerate(masks):
                if m & (1 << lst):
                    prefs[lst][i] = self._te_ref(b, lst)
        mvds = {0: [None] * len(parts), 1: [None] * len(parts)}
        for lst in range(2):
            for i, m in enumerate(masks):
                if m & (1 << lst):
                    mvds[lst][i] = (b.se(), b.se())
        for lst in range(2):
            for i, (px, py, w4, h4) in enumerate(parts):
                if mvds[lst][i] is None:
                    self.mv_ref[lst, by + py:by + py + h4,
                                bx + px:bx + px + w4] = -1
        for i, (px, py, w4, h4) in enumerate(parts):
            mvs = [None, None]
            refs = [prefs[0][i], prefs[1][i]]
            for lst in range(2):
                if mvds[lst][i] is None:
                    continue
                pred = self._pred_mv(bx + px, by + py, w4, h4, lst,
                                     refs[lst])
                mv = (pred[0] + mvds[lst][i][0], pred[1] + mvds[lst][i][1])
                self._store_mv(bx + px, by + py, w4, h4, mv, lst,
                               refs[lst])
                mvs[lst] = mv
            self.blk_done[by + py:by + py + h4, bx + px:bx + px + w4] = True
            self.intra4x4_modes[by + py:by + py + h4,
                                bx + px:bx + px + w4] = 2
        # residual identical to P
        cbp_code = b.ue()
        if cbp_code > 47:
            raise InvalidData("h264: bad cbp")
        cbp = T.GOLOMB_TO_INTER_CBP[cbp_code]
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        trans8 = False
        ok8 = mb_type != 0 or self.sps.direct_8x8_inference
        if subs is not None:
            ok8 = all(
                (st == 0 and self.sps.direct_8x8_inference)
                or st in (1, 2, 3) for st in subs)
        if self.pps.transform_8x8_mode and cbp_luma and ok8:
            trans8 = bool(b.get1())
        if cbp:
            qp = self._qp_add(qp, b.se())
        self.mb_qp[mby, mbx] = qp
        self._inter_luma_residual(b, mbx, mby, qp, cbp_luma, trans8)
        self._decode_chroma_inter(b, mbx, mby, qp, cbp_chroma)
        return qp

    # --- motion vector prediction (spec 8.4.1.3) -----------------------------------
    def _mv_nbr(self, bx, by, lst=0):
        """→ (mv, ref) for the 4x4 block, ((0,0), -1) if unavailable or
        intra."""
        if bx < 0 or by < 0 or bx >= self.sps.mb_width * 4:
            return (0, 0), -1, False
        if (bx >> 2, by >> 2) == self._cur_mb:
            if not self._curmask[lst, by & 3, bx & 3]:
                return (0, 0), -1, False
        elif not self.blk_done[by, bx]:
            return (0, 0), -1, False
        return (int(self.mv[lst, by, bx, 0]), int(self.mv[lst, by, bx, 1])), \
            int(self.mv_ref[lst, by, bx]), True

    def _pred_mv(self, bx, by, w4, h4, lst=0, ref=0):
        """Median predictor for a partition at 4x4 coords (bx,by) of size
        (w4,h4) in 4x4 units, matching the partition's refIdx."""
        from .inter import median_mv
        a, ra, avail_a = self._mv_nbr(bx - 1, by, lst)
        bvec, rb, avail_b = self._mv_nbr(bx, by - 1, lst)
        c, rc, avail_c = self._mv_nbr(bx + w4, by - 1, lst)
        if not avail_c:
            c, rc, avail_c = self._mv_nbr(bx - 1, by - 1, lst)
        # directional rules for 16x8 / 8x16 partitions
        if w4 == 4 and h4 == 2:          # 16x8
            if by % 4 == 0 and rb == ref:
                return bvec
            if by % 4 == 2 and ra == ref:
                return a
        elif w4 == 2 and h4 == 4:        # 8x16
            if bx % 4 == 0 and ra == ref:
                return a
            if bx % 4 == 2 and rc == ref:
                return c
        if avail_a and not avail_b and not avail_c:
            return a
        matches = [(m, r) for m, r in ((a, ra), (bvec, rb), (c, rc))
                   if r == ref]
        if len(matches) == 1:
            return matches[0][0]
        return median_mv(a, bvec, c)

    def _store_mv(self, bx, by, w4, h4, mv, lst=0, ref=0):
        self.mv[lst, by:by + h4, bx:bx + w4] = mv
        self.mv_ref[lst, by:by + h4, bx:bx + w4] = ref
        self.blk_done[by:by + h4, bx:bx + w4] = True
        self.intra4x4_modes[by:by + h4, bx:bx + w4] = 2

    def _decode_mb_skip(self, mbx, mby, qp):
        bx, by = mbx * 4, mby * 4
        a, ra, avail_a = self._mv_nbr(bx - 1, by)
        bvec, rb, avail_b = self._mv_nbr(bx, by - 1)
        if not avail_a or not avail_b or \
                (ra == 0 and a == (0, 0)) or (rb == 0 and bvec == (0, 0)):
            mv = (0, 0)
        else:
            mv = self._pred_mv(bx, by, 4, 4)
        self._store_mv(bx, by, 4, 4, mv)
        self.mb_16x16[mby, mbx] = True
        self.nnz_y[by:by + 4, bx:bx + 4] = 0
        self.nnz_u[mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0
        self.nnz_v[mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0
        self.mb_qp[mby, mbx] = qp

    # sub_mb_type → partition shapes within an 8x8 (in 4x4 units)
    _SUB_PARTS = {0: [(0, 0, 2, 2)],
                  1: [(0, 0, 2, 1), (0, 1, 2, 1)],
                  2: [(0, 0, 1, 2), (1, 0, 1, 2)],
                  3: [(0, 0, 1, 1), (1, 0, 1, 1),
                      (0, 1, 1, 1), (1, 1, 1, 1)]}

    def _decode_mb_p(self, b, mbx, mby, qp, mb_type):
        if mb_type > 4:
            raise InvalidData(f"h264: bad P mb_type {mb_type}")
        bx, by = mbx * 4, mby * 4
        self.mb_16x16[mby, mbx] = mb_type == 0
        if mb_type in (3, 4):         # P_8x8 / P_8x8ref0
            subs = [b.ue() for _ in range(4)]
            if any(st > 3 for st in subs):
                raise InvalidData("h264: bad sub_mb_type")
            # per-8x8 ref_idx fields (P_8x8ref0 forces all zero)
            refs8 = [self._te_ref(b, 0) for _ in range(4)] \
                if mb_type == 3 else [0] * 4
            for sub in range(4):
                ox, oy = (sub & 1) * 2, (sub >> 1) * 2
                for (px, py, w4, h4) in self._SUB_PARTS[subs[sub]]:
                    mvd = (b.se(), b.se())
                    pbx, pby = bx + ox + px, by + oy + py
                    pred = self._pred_mv(pbx, pby, w4, h4,
                                         ref=refs8[sub])
                    mv = (pred[0] + mvd[0], pred[1] + mvd[1])
                    self._store_mv(pbx, pby, w4, h4, mv, 0, refs8[sub])
        else:
            parts = {0: [(0, 0, 4, 4)],
                     1: [(0, 0, 4, 2), (0, 2, 4, 2)],
                     2: [(0, 0, 2, 4), (2, 0, 2, 4)]}[mb_type]
            # all partitions' ref_idx fields precede the mvds
            refs = [self._te_ref(b, 0) for _ in parts]
            for i, (px, py, w4, h4) in enumerate(parts):
                mvd = (b.se(), b.se())
                pred = self._pred_mv(bx + px, by + py, w4, h4,
                                     ref=refs[i])
                mv = (pred[0] + mvd[0], pred[1] + mvd[1])
                self._store_mv(bx + px, by + py, w4, h4, mv, 0, refs[i])
        cbp_code = b.ue()
        if cbp_code > 47:
            raise InvalidData("h264: bad cbp")
        cbp = T.GOLOMB_TO_INTER_CBP[cbp_code]
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        trans8 = False
        if self.pps.transform_8x8_mode and cbp_luma and \
                (mb_type in (0, 1, 2)
                 or all(st == 0 for st in subs)):
            trans8 = bool(b.get1())
        if cbp:
            qp = self._qp_add(qp, b.se())
        self.mb_qp[mby, mbx] = qp
        self._inter_luma_residual(b, mbx, mby, qp, cbp_luma, trans8)
        self._decode_chroma_inter(b, mbx, mby, qp, cbp_chroma)
        return qp

    def _inter_luma_residual(self, b, mbx, mby, qp, cbp_luma, trans8):
        bx, by = mbx * 4, mby * 4
        if trans8:
            self.trans8[mby, mbx] = True
            for blk8 in range(4):
                dx8, dy8 = self._BLK8_XY[blk8]
                if cbp_luma & (1 << blk8):
                    self._read_luma8_residual(b, mbx, mby, blk8, qp,
                                              False)
                else:
                    self.nnz_y[by + dy8 * 2:by + dy8 * 2 + 2,
                               bx + dx8 * 2:bx + dx8 * 2 + 2] = 0
            return
        w4 = self.pps.scaling4[3]
        for blk in range(16):
            dx, dy = _BLK_XY[blk]
            bx4, by4 = bx + dx, by + dy
            if not (cbp_luma & (1 << (blk >> 2))):
                self.nnz_y[by4, bx4] = 0
                continue
            nc = self._pred_nnz(self.nnz_y, bx4, by4)
            lv, total = decode_residual(b, 16, nc)
            self.nnz_y[by4, bx4] = total
            raster = np.zeros(16, np.int64)
            raster[self.scan4] = lv
            self.coeff_y[by4, bx4] = recon.dequant4(
                raster, qp + self.qp_bd_offset, w4)

    def _decode_chroma_inter(self, b, mbx, mby, qp, cbp_chroma):
        qpc = self._chroma_qp(qp, self.pps.chroma_qp_index_offset)
        qpc2 = self._chroma_qp(qp,
                               self.pps.second_chroma_qp_index_offset)
        s4 = self.pps.scaling4
        comps = ((self.coeff_u, self.nnz_u, qpc, s4[4]),
                 (self.coeff_v, self.nnz_v, qpc2, s4[5]))
        dcs = []
        for _co, _nnz, qpc_used, w in comps:
            dc = np.zeros((2, 2), np.int64)
            if cbp_chroma:
                lv, _ = decode_residual(b, 4, -1)
                dc = recon.chroma_dc_transform(
                    np.array(lv[:4], np.int64), qpc_used, w[0])
            dcs.append(dc)
        acs_all = []
        for _co, nnz, _q, _w in comps:
            acs = []
            for blk in range(4):
                dx, dy = blk & 1, blk >> 1
                raster = np.zeros(16, np.int64)
                if cbp_chroma == 2:
                    bx2, by2 = mbx * 2 + dx, mby * 2 + dy
                    nc = self._pred_nnz(nnz, bx2, by2)
                    lv, total = decode_residual(b, 15, nc)
                    nnz[by2, bx2] = total
                    raster[self.scan4[1:]] = lv
                else:
                    nnz[mby * 2 + dy, mbx * 2 + dx] = 0
                acs.append(raster)
            acs_all.append(acs)
        if not cbp_chroma:
            return
        for ci, (coeff, _nnz, qpc_used, w) in enumerate(comps):
            for blk in range(4):
                dx, dy = blk & 1, blk >> 1
                block = recon.dequant4(acs_all[ci][blk], qpc_used, w)
                block[0] = dcs[ci][dy, dx]
                coeff[mby * 2 + dy, mbx * 2 + dx] = block

    def _avail(self, mbx, mby, dx, dy):
        x, y = mbx + dx, mby + dy
        if x < 0 or y < 0 or x >= self.sps.mb_width:
            return False
        if not self.mb_avail[y, x]:
            return False
        # constrained_intra_pred: inter neighbours are unavailable
        # for intra prediction (8.3.1 / PPS flag)
        if self.pps.constrained_intra_pred and \
                not self.mb_intra[y, x]:
            return False
        return True

    def _decode_mb_i(self, b: Bits, mbx: int, mby: int, qp: int,
                     mb_type: Optional[int] = None) -> int:
        if mb_type is None:
            mb_type = b.ue()
        if mb_type > 25:
            raise InvalidData(f"h264: bad I mb_type {mb_type}")
        self.mb_intra[mby, mbx] = True
        self.mb_16x16[mby, mbx] = True
        avail_l = self._avail(mbx, mby, -1, 0)
        avail_t = self._avail(mbx, mby, 0, -1)
        avail_tl = self._avail(mbx, mby, -1, -1)
        avail_tr = self._avail(mbx, mby, 1, -1)
        x0, y0 = mbx * 16, mby * 16
        cx0, cy0 = mbx * 8, mby * 8

        if mb_type == I_PCM:
            # byte-align then raw samples
            if b.pos & 7:
                b.pos += 8 - (b.pos & 7)
            pix = self.y.dtype
            py_ = np.empty((16, 16), pix)
            pu_ = np.empty((8, 8), pix)
            pv_ = np.empty((8, 8), pix)
            for j in range(16):
                for i in range(16):
                    py_[j, i] = b.get(self.bd)
            for pl in (pu_, pv_):
                for j in range(8):
                    for i in range(8):
                        pl[j, i] = b.get(self.bd)
            self.is_pcm[mby, mbx] = True
            self.pcm[mby * self.sps.mb_width + mbx] = (py_, pu_, pv_)
            self.nnz_y[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 16
            self.nnz_u[mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 16
            self.nnz_v[mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 16
            self.intra4x4_modes[mby * 4:mby * 4 + 4,
                                mbx * 4:mbx * 4 + 4] = 2
            self.blk_done[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = True
            self.mb_qp[mby, mbx] = 0
            return qp

        if mb_type == 0 and self.pps.transform_8x8_mode and b.get1():
            # I_NxN with transform_size_8x8_flag == 1: Intra_8x8
            return self._decode_i8x8(b, mbx, mby, qp)

        if mb_type == 0:
            # I_NxN: 16 prediction modes (spec 8.3.1.1: unavailable
            # neighbour -> DC; non-I4x4 neighbours stored as mode 2)
            modes = []
            for blk in range(16):
                bx = mbx * 4 + _BLK_XY[blk][0]
                by = mby * 4 + _BLK_XY[blk][1]
                la = self._nbr_avail(bx - 1, by, mbx, mby)
                ta = self._nbr_avail(bx, by - 1, mbx, mby)
                if not la or not ta:
                    pred = 2
                else:
                    lm = int(self.intra4x4_modes[by, bx - 1])
                    tm = int(self.intra4x4_modes[by - 1, bx])
                    pred = min(lm if lm >= 0 else 2, tm if tm >= 0 else 2)
                if b.get1():
                    mode = pred
                else:
                    rem = b.get(3)
                    mode = rem if rem < pred else rem + 1
                modes.append(mode)
                self.intra4x4_modes[by, bx] = mode
            chroma_mode = b.ue()
            cbp_code = b.ue()
            if cbp_code > 47:
                raise InvalidData("h264: bad cbp")
            cbp = T.GOLOMB_TO_INTRA4X4_CBP[cbp_code]
            cbp_luma = cbp & 15
            cbp_chroma = cbp >> 4
            if cbp:
                qp = self._qp_add(qp, b.se())
            self.mb_qp[mby, mbx] = qp

            for blk in range(16):
                dx, dy = _BLK_XY[blk]
                bx4, by4 = mbx * 4 + dx, mby * 4 + dy
                self.blk_avail[by4, bx4] = (
                    self._blk_done_at(bx4 - 1, by4),
                    self._blk_done_at(bx4, by4 - 1),
                    self._blk_done_at(bx4 + 1, by4 - 1),
                    self._blk_done_at(bx4 - 1, by4 - 1))
                self.i4_pred[by4, bx4] = modes[blk]
                if cbp_luma & (1 << (blk >> 2)):
                    nc = self._pred_nnz(self.nnz_y, bx4, by4)
                    lv, total = decode_residual(b, 16, nc)
                    self.nnz_y[by4, bx4] = total
                    raster = np.zeros(16, np.int64)
                    raster[self.scan4] = lv
                    self.coeff_y[by4, bx4] = recon.dequant4(
                        raster, qp + self.qp_bd_offset,
                        self.pps.scaling4[0])
                else:
                    self.nnz_y[by4, bx4] = 0
                self.blk_done[by4, bx4] = True
            self._decode_chroma(b, mbx, mby, qp, chroma_mode, cbp_chroma,
                                avail_l, avail_t)
            return qp

        # I_16x16
        it = mb_type - 1
        pred_mode = it % 4
        cbp_chroma = (it // 4) % 3
        cbp_luma = 15 if it >= 12 else 0
        chroma_mode = b.ue()
        qp = self._qp_add(qp, b.se())
        self.mb_qp[mby, mbx] = qp
        self.intra4x4_modes[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 2
        self.i16_mode[mby, mbx] = pred_mode

        # luma DC: context from whole-MB luma nnz of block 0 neighbours
        nc = self._pred_nnz(self.nnz_y, mbx * 4, mby * 4)
        dc_lv, _dc_total = decode_residual(b, 16, nc)
        dc_raster = np.zeros(16, np.int64)
        dc_raster[self.scan4] = dc_lv
        dc = recon.luma_dc_transform(dc_raster, qp + self.qp_bd_offset,
                                     self.pps.scaling4[0][0])

        for blk in range(16):
            dx, dy = _BLK_XY[blk]
            bx4, by4 = mbx * 4 + dx, mby * 4 + dy
            raster = np.zeros(16, np.int64)
            if cbp_luma:
                nc = self._pred_nnz(self.nnz_y, bx4, by4)
                lv, total = decode_residual(b, 15, nc)
                self.nnz_y[by4, bx4] = total
                raster[self.scan4[1:]] = lv
            else:
                self.nnz_y[by4, bx4] = 0
            block = recon.dequant4(raster, qp + self.qp_bd_offset,
                                   self.pps.scaling4[0])
            block[0] = dc[dy, dx]
            self.coeff_y[by4, bx4] = block
        self.blk_done[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = True
        self._decode_chroma(b, mbx, mby, qp, chroma_mode, cbp_chroma,
                            avail_l, avail_t)
        return qp

    # zscan order of 8x8 blocks inside an MB
    _BLK8_XY = ((0, 0), (1, 0), (0, 1), (1, 1))

    def _read_i8_modes(self, b, mbx, mby):
        """The four Intra_8x8 prediction modes (prev/rem scheme; the
        context comes from the covering 4x4 mode cells)."""
        modes = []
        for dx8, dy8 in self._BLK8_XY:
            bx4, by4 = mbx * 4 + dx8 * 2, mby * 4 + dy8 * 2
            la = self._nbr_avail(bx4 - 1, by4, mbx, mby)
            ta = self._nbr_avail(bx4, by4 - 1, mbx, mby)
            if not la or not ta:
                pred = 2
            else:
                lm = int(self.intra4x4_modes[by4, bx4 - 1])
                tm = int(self.intra4x4_modes[by4 - 1, bx4])
                pred = min(lm if lm >= 0 else 2, tm if tm >= 0 else 2)
            if b.get1():
                mode = pred
            else:
                rem = b.get(3)
                mode = rem if rem < pred else rem + 1
            modes.append(mode)
            self.intra4x4_modes[by4:by4 + 2, bx4:bx4 + 2] = mode
        return modes

    def _record_blk8(self, mbx, mby, blk8, mode):
        """Availability flags + bookkeeping for one intra 8x8 block."""
        dx8, dy8 = self._BLK8_XY[blk8]
        bx8, by8 = mbx * 2 + dx8, mby * 2 + dy8
        bx4, by4 = bx8 * 2, by8 * 2
        self.blk8_avail[by8, bx8] = (
            self._blk_done_at(bx4 - 1, by4),
            self._blk_done_at(bx4, by4 - 1),
            self._blk_done_at(bx4 + 2, by4 - 1),
            self._blk_done_at(bx4 - 1, by4 - 1))
        self.i8_pred[by8, bx8] = mode
        self.blk_done[by4:by4 + 2, bx4:bx4 + 2] = True
        return bx8, by8

    def _read_luma8_residual(self, b, mbx, mby, blk8, qp, intra):
        """CAVLC 8x8 luma residual: four interleaved 4x4 scans
        (coefficient 4*i+n of the 8x8 zigzag lives in sub-block n at
        scan position i — spec 7.4.5.3.3 / h264_cavlc.c)."""
        dx8, dy8 = self._BLK8_XY[blk8]
        bx8, by8 = mbx * 2 + dx8, mby * 2 + dy8
        lv64 = np.zeros(64, np.int64)
        for n in range(4):
            bx4 = mbx * 4 + dx8 * 2 + (n & 1)
            by4 = mby * 4 + dy8 * 2 + (n >> 1)
            nc = self._pred_nnz(self.nnz_y, bx4, by4)
            lv, total = decode_residual(b, 16, nc)
            self.nnz_y[by4, bx4] = total
            for i in range(16):
                lv64[self.scan8[4 * i + n]] = lv[i]
        w8 = self.pps.scaling8[0 if intra else 1]
        self.coeff8_y[by8, bx8] = recon.dequant8(
            lv64, qp + self.qp_bd_offset, w8)

    def _decode_i8x8(self, b: Bits, mbx: int, mby: int, qp: int) -> int:
        """Intra_8x8 macroblock (CAVLC)."""
        self.trans8[mby, mbx] = True
        self.mb_intra[mby, mbx] = True
        self.mb_16x16[mby, mbx] = True
        modes = self._read_i8_modes(b, mbx, mby)
        chroma_mode = b.ue()
        cbp_code = b.ue()
        if cbp_code > 47:
            raise InvalidData("h264: bad cbp")
        cbp = T.GOLOMB_TO_INTRA4X4_CBP[cbp_code]
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        if cbp:
            qp = self._qp_add(qp, b.se())
        self.mb_qp[mby, mbx] = qp
        for blk8 in range(4):
            self._record_blk8(mbx, mby, blk8, modes[blk8])
            dx8, dy8 = self._BLK8_XY[blk8]
            if cbp_luma & (1 << blk8):
                self._read_luma8_residual(b, mbx, mby, blk8, qp, True)
            else:
                self.nnz_y[mby * 4 + dy8 * 2:mby * 4 + dy8 * 2 + 2,
                           mbx * 4 + dx8 * 2:mbx * 4 + dx8 * 2 + 2] = 0
        avail_l = self._avail(mbx, mby, -1, 0)
        avail_t = self._avail(mbx, mby, 0, -1)
        self._decode_chroma(b, mbx, mby, qp, chroma_mode, cbp_chroma,
                            avail_l, avail_t)
        return qp

    def _decode_chroma(self, b, mbx, mby, qp, chroma_mode, cbp_chroma,
                       avail_l, avail_t):
        qpc = self._chroma_qp(qp, self.pps.chroma_qp_index_offset)
        qpc2 = self._chroma_qp(qp,
                               self.pps.second_chroma_qp_index_offset)
        self.chroma_imode[mby, mbx] = chroma_mode
        self.mb_nbr_avail[mby, mbx] = (avail_l, avail_t)
        s4 = self.pps.scaling4
        comps = ((self.coeff_u, self.nnz_u, qpc, s4[1]),
                 (self.coeff_v, self.nnz_v, qpc2, s4[2]))
        # bitstream order: both components' DC blocks, then all AC blocks
        dcs = []
        for _co, _nnz, qpc_used, w in comps:
            dc = np.zeros((2, 2), np.int64)
            if cbp_chroma:
                lv, _ = decode_residual(b, 4, -1)
                dc = recon.chroma_dc_transform(
                    np.array([lv[0], lv[1], lv[2], lv[3]], np.int64),
                    qpc_used, w[0])
            dcs.append(dc)
        acs_all = []
        for _co, nnz, _qpc_used, _w in comps:
            acs = []
            for blk in range(4):
                dx, dy = blk & 1, blk >> 1
                raster = np.zeros(16, np.int64)
                if cbp_chroma == 2:
                    bx2, by2 = mbx * 2 + dx, mby * 2 + dy
                    nc = self._pred_nnz(nnz, bx2, by2)
                    lv, total = decode_residual(b, 15, nc)
                    nnz[by2, bx2] = total
                    raster[self.scan4[1:]] = lv
                else:
                    nnz[mby * 2 + dy, mbx * 2 + dx] = 0
                acs.append(raster)
            acs_all.append(acs)
        for ci, (coeff, _nnz, qpc_used, w) in enumerate(comps):
            for blk in range(4):
                dx, dy = blk & 1, blk >> 1
                block = recon.dequant4(acs_all[ci][blk], qpc_used, w)
                block[0] = dcs[ci][dy, dx]
                coeff[mby * 2 + dy, mbx * 2 + dx] = block

    # --- 4x4 block availability (frame coords in 4x4 units) ------------------------
    def _blk_done_at(self, bx, by) -> bool:
        """Pixel availability: the block has been reconstructed (decode
        order makes the H.264 top-right corner cases fall out exactly)."""
        if bx < 0 or by < 0 or bx >= self.sps.mb_width * 4:
            return False
        return bool(self.blk_done[by, bx])

    def _nbr_avail(self, bx, by, mbx, mby) -> bool:
        """Mode-prediction availability during side-info parsing: the
        neighbour is in a decoded MB, or is an earlier block (zscan) of
        the current MB (its mode is already recorded)."""
        if bx < 0 or by < 0 or bx >= self.sps.mb_width * 4:
            return False
        nmbx, nmby = bx // 4, by // 4
        if (nmbx, nmby) == (mbx, mby):
            return self.intra4x4_modes[by, bx] >= 0
        if not self.mb_avail[nmby, nmbx]:
            return False
        if self.pps.constrained_intra_pred and \
                not self.mb_intra[nmby, nmbx]:
            return False
        return True
