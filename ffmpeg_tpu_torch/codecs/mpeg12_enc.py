"""MPEG-2 video encoder (counterpart of ffmpeg_tpu/codecs/mpeg12_enc.py;
reference: libavcodec/mpegvideo_enc.c ff_mpv_encode_picture:1903 +
motion_est.c + ratecontrol.c).

Split between the encoder's device and the host:
  * device (the `device` the encoder is opened on): full-frame motion
    search (ops/me.py motion_search, which launches K2 on a CUDA
    device), the forward DCT of every block of a frame in one call, and
    the IDCT of the drift-free reconstruction loop (the decoder's own
    exact dequant + IDCT + MC, so encode-side references equal what any
    conformant decoder reconstructs);
  * host numpy, as in the reference: quantization decisions, VLC
    bit-packing, rate control, prediction and reconstruction.

The device's float32 DCT sums in another order than the reference's, so
rare levels land on the other side of a rounding step and the streams of
the two packages differ in a few levels; the MVs of one reference
picture are the same (integer work).

Scope: MPEG-2 MP@ML frame pictures, I/P GOPs, frame prediction +
frame DCT, full-pel motion (coded in half-pel units), TM5-style
single-pass rate control plus 2-pass stats in/out (the ratecontrol.c
pass-1/pass-2 analog).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..core.frame import Frame, host_array
from ..core.packet import Packet, PKT_FLAG_KEY
from ..formats import pixfmt as _pf
from ..io.stream import MediaType
from ..ops.idct import ZIGZAG, fdct8x8, idct8x8
from ..ops.me import motion_search
from ..utils.error import NotSupported
from ..utils.rational import Rational
from . import mpeg12_tables as T
from .codec import Codec, register_encoder

I_TYPE, P_TYPE = 1, 2

# run/level -> table index for the MPEG-1 coefficient VLC (table B.14);
# indices beyond the table use the escape code
_RL_INDEX = {}
for _i, (_r, _l) in enumerate(zip(T.RL_RUN, T.RL_LEVEL)):
    _RL_INDEX[(_r, _l)] = _i
_ESCAPE = T.MPEG1_VLC[111]
_EOB = T.MPEG1_VLC[112]

_FRAME_RATE_CODES = {tuple(fr): i for i, fr in enumerate(T.FRAME_RATES)}


class _BW:
    """MSB-first bit writer with start-code alignment."""

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, v: int, n: int):
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.buf.append((self.acc >> (self.n - 8)) & 0xFF)
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def align(self):
        if self.n:
            self.put(0, 8 - self.n)

    def start_code(self, code: int):
        self.align()
        self.buf += bytes([0, 0, 1, code])

    def nbits(self) -> int:
        return len(self.buf) * 8 + self.n


def _dc_size(v: int) -> int:
    return abs(v).bit_length()


def _write_rl(bw: _BW, run: int, level: int):
    idx = _RL_INDEX.get((run, abs(level)))
    if idx is not None:
        code, bits = T.MPEG1_VLC[idx]
        bw.put(code, bits)
        bw.put(1 if level < 0 else 0, 1)
    else:
        code, bits = _ESCAPE
        bw.put(code, bits)
        bw.put(run, 6)
        bw.put(level & 0xFFF, 12)      # MPEG-2 escape: 12-bit signed


def _write_mv_delta(bw: _BW, delta: int, f_code: int):
    r_size = f_code - 1
    rng = 1 << (f_code + 3)
    delta = ((delta + rng) % (2 * rng)) - rng
    if delta == 0:
        code, bits = T.MB_MV[0]
        bw.put(code, bits)
        return
    a = abs(delta)
    mcode = ((a - 1) >> r_size) + 1
    residual = (a - 1) & ((1 << r_size) - 1)
    code, bits = T.MB_MV[mcode]
    bw.put(code, bits)
    bw.put(1 if delta < 0 else 0, 1)
    if r_size:
        bw.put(residual, r_size)


@register_encoder
class Mpeg2Encoder(Codec):
    codec_id = "mpeg2video"
    codec_type = MediaType.VIDEO
    is_encoder = True

    F_CODE = 2                   # half-pel deltas in [-32, 31]
    SEARCH = 8                   # full-pel search radius

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        o = options or {}
        self.gop_size = int(o.get("gop_size", 12))
        self.bit_rate = int(o.get("bit_rate", o.get("b", 4_000_000)))
        self.fixed_q = int(o.get("qscale", 0))       # 0 = rate control
        self.rc_pass = int(o.get("pass", 0))         # 0/1/2
        self.stats_file = o.get("stats_file", "")
        self._stats_out = []
        self._stats_in = []
        if self.rc_pass == 2 and self.stats_file:
            for line in Path(self.stats_file).read_text().splitlines():
                t, q, b = line.split()
                self._stats_in.append((int(t), int(q), int(b)))
        self.frame_idx = 0
        self._recon = None           # previous reconstructed planes
        self.last_mv_grid = None     # motion_search's MVs of the last P
        self.intra_matrix = np.array(T.DEFAULT_INTRA_MATRIX, np.int32)
        self.inter_matrix = np.array(T.DEFAULT_NON_INTRA_MATRIX, np.int32)
        # As the reference does, the default matrices are scattered
        # through ZIGZAG as if they were in zigzag order.  They are in
        # raster order (13818-2 6.3.11), so the encoder's reconstruction
        # is not what a decoder makes of its stream; the port keeps the
        # reference's arithmetic and the fault stays recorded with it.
        self.intra_m_raster = np.zeros(64, np.int32)
        self.intra_m_raster[ZIGZAG] = self.intra_matrix
        self.inter_m_raster = np.zeros(64, np.int32)
        self.inter_m_raster[ZIGZAG] = self.inter_matrix
        # TM5-ish rate control state
        self._Xi = 160.0 * self.bit_rate / 115.0
        self._Xp = 60.0 * self.bit_rate / 115.0
        self._di = self._dp = 0.0
        self._gop_left = 0
        self._R = 0.0

    # --------------------------------------------------------------- RC
    def _frame_rate(self) -> Rational:
        tb = getattr(self.par, "framerate", None)
        if tb and getattr(tb, "num", 0):
            return tb
        return Rational(25, 1)

    def _pick_qscale(self, ftype: int) -> int:
        if self.fixed_q:
            return self.fixed_q
        if self.rc_pass == 2 and self.frame_idx < len(self._stats_in):
            # scale pass-1 quantizers so the total lands on target
            t1, q1, b1 = self._stats_in[self.frame_idx]
            total1 = sum(b for _, _, b in self._stats_in)
            fr = self._frame_rate()
            target = self.bit_rate * len(self._stats_in) * fr.den / fr.num
            ratio = total1 / max(1.0, target)
            return int(np.clip(round(q1 * ratio), 2, 62)) & ~1
        # single-pass TM5-lite
        fr = self._frame_rate()
        pics_per_sec = fr.num / fr.den
        if self._gop_left <= 0:
            self._gop_left = self.gop_size
            self._R += self.bit_rate * self.gop_size / pics_per_sec
        n_p = self._gop_left - 1
        if ftype == I_TYPE:
            T_t = self._R / (1 + n_p * self._Xp / (self._Xi * 1.0))
            d = self._di
        else:
            T_t = self._R / max(1, self._gop_left)
            d = self._dp
        T_t = max(T_t, self.bit_rate / pics_per_sec / 8)
        self._T_target = T_t
        r = 2.0 * self.bit_rate / pics_per_sec
        q = 31.0 * (d + self.bit_rate / pics_per_sec * 0.5) / r
        q = int(np.clip(round(q), 1, 31))
        return max(2, min(62, q * 2) & ~1)

    def _rc_update(self, ftype: int, qscale: int, bits: int):
        self._stats_out.append((ftype, qscale, bits))
        if self.fixed_q or self.rc_pass == 2:
            return
        fr = self._frame_rate()
        pics_per_sec = fr.num / fr.den
        if ftype == I_TYPE:
            self._Xi = 0.6 * self._Xi + 0.4 * bits * qscale
            self._di += bits - self._T_target
        else:
            self._Xp = 0.6 * self._Xp + 0.4 * bits * qscale
            self._dp += bits - self._T_target
        self._R -= bits
        self._gop_left -= 1

    # ------------------------------------------------------------ encode
    def encode(self, frame: Optional[Frame]) -> List[Packet]:
        if frame is None:
            if self.rc_pass == 1 and self.stats_file:
                Path(self.stats_file).write_text("\n".join(
                    f"{t} {q} {b}" for t, q, b in self._stats_out))
            return []
        fmt = _pf.get(frame.format).name
        if fmt not in ("yuv420p", "yuvj420p"):
            raise NotSupported(f"mpeg2 enc: pix_fmt {fmt}")
        w, h = frame.width, frame.height
        mb_w, mb_h = -(-w // 16), -(-h // 16)
        ftype = I_TYPE if (self.frame_idx % self.gop_size == 0
                           or self._recon is None) else P_TYPE
        qscale = self._pick_qscale(ftype)

        planes = [host_array(p) for p in frame.planes[:3]]
        y = _pad(planes[0], mb_h * 16, mb_w * 16)
        u = _pad(planes[1], mb_h * 8, mb_w * 8)
        v = _pad(planes[2], mb_h * 8, mb_w * 8)

        # ---- device analysis: motion search + FDCT of prediction error
        mvs = np.zeros((mb_h, mb_w, 2), np.int32)     # full-pel (y, x)
        self.last_mv_grid = None
        if ftype == P_TYPE:
            ry = self._recon[0]
            mv_grid, _cost = motion_search(self._to_device(y),
                                           self._to_device(ry), block=16,
                                           search=self.SEARCH)
            self.last_mv_grid = mv_grid.cpu().numpy()
            # even full-pel motion keeps chroma prediction at integer
            # positions (luma mv/2) — no half-pel interpolation needed;
            # // floors negative MVs, as the reference does
            mvs = (self.last_mv_grid // 2) * 2
        pred_y, pred_u, pred_v = self._predict(mvs, mb_w, mb_h) \
            if ftype == P_TYPE else (None, None, None)

        if ftype == I_TYPE:
            ey, eu, ev = y.astype(np.int32), u.astype(np.int32), \
                v.astype(np.int32)
            fy, fu, fv = self._fdct_planes([ey, eu, ev])
            sy, su, sv = fy, fu, fv
        else:
            ey = y.astype(np.int32) - pred_y
            eu = u.astype(np.int32) - pred_u
            ev = v.astype(np.int32) - pred_v
            # intra path also needs luma/chroma of the SOURCE for intra
            # MBs inside P frames
            fy, fu, fv, sy, su, sv = self._fdct_planes(
                [ey, eu, ev, y.astype(np.int32), u.astype(np.int32),
                 v.astype(np.int32)])

        bw = _BW()
        if ftype == I_TYPE:
            self._write_seq_header(bw, w, h)
        self._write_pic_header(bw, ftype)

        # quantized coefficients for recon: (mb_h, mb_w, 6, 64) raster
        recon_coeff = np.zeros((mb_h, mb_w, 6, 64), np.float32)
        intra_mask = np.zeros((mb_h, mb_w), bool)
        used_mvs = np.zeros((mb_h, mb_w, 2), np.int32)

        zz = ZIGZAG
        for mby in range(mb_h):
            bw.start_code(1 + mby)
            bw.put(qscale >> 1, 5)     # quantiser_scale_code (linear x2)
            bw.put(0, 1)
            pred_dc = [128, 128, 128]
            pred_mv = np.zeros(2, np.int32)
            last_mb = -1
            for mbx in range(mb_w):
                blocks_f = _mb_blocks(fy, fu, fv, mby, mbx, mb_w)
                if ftype == P_TYPE:
                    mv = mvs[mby, mbx]
                    sad = np.abs(ey[mby * 16:mby * 16 + 16,
                                    mbx * 16:mbx * 16 + 16]).sum()
                    src = y[mby * 16:mby * 16 + 16,
                            mbx * 16:mbx * 16 + 16].astype(np.int32)
                    intra_cost = np.abs(src - src.mean()).sum()
                    use_intra = intra_cost + 3000 < sad
                else:
                    use_intra = True
                    mv = np.zeros(2, np.int32)

                if use_intra:
                    q = [_quant_intra(b, qscale, self.intra_m_raster, zz)
                         for b in (_mb_blocks(sy, su, sv, mby, mbx, mb_w)
                                   if ftype == P_TYPE else blocks_f)]
                else:
                    q = [_quant_inter(b, qscale, self.inter_m_raster, zz)
                         for b in blocks_f]
                    cbp = 0
                    for bi, ql in enumerate(q):
                        if np.any(ql):
                            cbp |= 1 << (5 - bi)
                    # skip: zero mv delta vs implied reset & no residual
                    can_skip = (cbp == 0 and mv[0] == 0 and mv[1] == 0
                                and mbx != 0 and mbx != mb_w - 1)
                    if can_skip:
                        intra_mask[mby, mbx] = False
                        used_mvs[mby, mbx] = 0
                        pred_dc = [128, 128, 128]
                        pred_mv[:] = 0
                        continue

                # macroblock_address_increment
                inc = mbx - last_mb
                while inc > 33:
                    bw.put(0x8, 11)
                    inc -= 33
                code, bits = T.MB_ADDR_INC[inc - 1]
                bw.put(code, bits)
                last_mb = mbx

                if use_intra:
                    intra_mask[mby, mbx] = True
                    if ftype == I_TYPE:
                        bw.put(1, 1)             # I: intra
                    else:
                        bw.put(0b00011, 5)       # P: intra
                        pred_mv[:] = 0
                    self._write_intra_mb(bw, q, pred_dc)
                    used_mvs[mby, mbx] = 0
                    for bi in range(6):
                        recon_coeff[mby, mbx, bi] = _dequant_intra(
                            q[bi], qscale, self.intra_m_raster, zz)
                else:
                    pred_dc = [128, 128, 128]
                    hp = mv * 2                 # half-pel units
                    if cbp == 0:
                        bw.put(0b001, 3)        # MC, not coded
                    elif mv[0] == 0 and mv[1] == 0 and False:
                        pass
                    else:
                        bw.put(0b1, 1)          # MC + coded
                    # motion vector: horizontal then vertical
                    _write_mv_delta(bw, int(hp[1] - pred_mv[1]),
                                    self.F_CODE)
                    _write_mv_delta(bw, int(hp[0] - pred_mv[0]),
                                    self.F_CODE)
                    pred_mv[:] = hp
                    used_mvs[mby, mbx] = hp
                    if cbp:
                        code, bits = T.MB_PAT[cbp]
                        bw.put(code, bits)
                        for bi in range(6):
                            if cbp & (1 << (5 - bi)):
                                self._write_inter_block(bw, q[bi])
                    for bi in range(6):
                        if cbp & (1 << (5 - bi)):
                            recon_coeff[mby, mbx, bi] = _dequant_inter(
                                q[bi], qscale, self.inter_m_raster, zz)
            bw.align()

        data = bytes(bw.buf)
        self._reconstruct(recon_coeff, intra_mask, used_mvs, mb_w, mb_h,
                          ftype)
        self._rc_update(ftype, qscale, len(data) * 8)
        self.frame_idx += 1
        pkt = Packet(data=data, pts=frame.pts, dts=frame.pts,
                     duration=frame.duration,
                     flags=PKT_FLAG_KEY if ftype == I_TYPE else 0,
                     time_base=frame.time_base)
        return [pkt]

    # ----------------------------------------------------- device stage
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _fdct_planes(self, planes: List[np.ndarray]) -> List[np.ndarray]:
        """FDCT of every 8x8 block of each (H, W) int32 plane, in one
        device call.  Returns one (blocks, 64) float32 array per plane,
        blocks in raster order."""
        blocks = [_blocks(p, 8).astype(np.float32) for p in planes]
        f = fdct8x8(self._to_device(np.concatenate(blocks))
                    .reshape(-1, 8, 8))
        f = f.reshape(-1, 64).cpu().numpy()
        return np.split(f, np.cumsum([len(b) for b in blocks])[:-1])

    def load_state(self, state: dict) -> None:
        """Take over an encoder state (from state_from_reference)."""
        unknown = set(state) - set(_STATE_KEYS)
        if unknown:
            raise ValueError(f"not encoder state: {sorted(unknown)}")
        for k, v in state.items():
            setattr(self, k, v)

    # ------------------------------------------------------- bit writers
    def _write_seq_header(self, bw: _BW, w: int, h: int):
        fr = self._frame_rate()
        frc = _FRAME_RATE_CODES.get((fr.num, fr.den), 3)
        bw.start_code(0xB3)
        bw.put(w, 12)
        bw.put(h, 12)
        bw.put(1, 4)                     # square pixels
        bw.put(frc, 4)
        bw.put(min((self.bit_rate + 399) // 400, (1 << 18) - 1), 18)
        bw.put(1, 1)
        bw.put(112, 10)                  # vbv buffer size
        bw.put(0, 1)
        bw.put(0, 1)                     # no custom intra matrix
        bw.put(0, 1)                     # no custom inter matrix
        # sequence extension (MPEG-2)
        bw.start_code(0xB5)
        bw.put(1, 4)                     # sequence extension id
        bw.put(0x48, 8)                  # Main@Main
        bw.put(1, 1)                     # progressive
        bw.put(1, 2)                     # 4:2:0
        bw.put(0, 2)
        bw.put(0, 2)
        bw.put(0, 12)
        bw.put(1, 1)
        bw.put(0, 8)
        bw.put(0, 1)
        bw.put(0, 2)
        bw.put(0, 5)
        # GOP header
        bw.start_code(0xB8)
        bw.put(0, 25)
        bw.put(1, 1)                     # closed gop
        bw.put(0, 1)

    def _write_pic_header(self, bw: _BW, ftype: int):
        bw.start_code(0x00)
        bw.put(self.frame_idx % self.gop_size, 10)
        bw.put(ftype, 3)
        bw.put(0xFFFF, 16)               # vbv_delay: unspecified
        if ftype == P_TYPE:
            bw.put(0, 1)                 # full_pel (must be 0 in MPEG-2)
            bw.put(7, 3)                 # f_code: unused in MPEG-2
        bw.put(0, 1)                     # no extra info
        # picture coding extension
        bw.start_code(0xB5)
        bw.put(8, 4)                     # picture coding extension id
        if ftype == P_TYPE:
            bw.put(self.F_CODE, 4)
            bw.put(self.F_CODE, 4)
        else:
            bw.put(15, 4)
            bw.put(15, 4)
        bw.put(15, 4)
        bw.put(15, 4)
        bw.put(0, 2)                     # intra_dc_precision: 8-bit
        bw.put(3, 2)                     # frame picture
        bw.put(0, 1)                     # top_field_first
        bw.put(1, 1)                     # frame_pred_frame_dct
        bw.put(0, 1)
        bw.put(0, 1)                     # q_scale_type: linear
        bw.put(0, 1)                     # intra_vlc_format: B.14
        bw.put(0, 1)                     # alternate_scan
        bw.put(0, 1)
        bw.put(1, 1)                     # chroma_420_type
        bw.put(1, 1)                     # progressive_frame
        bw.put(0, 1)

    def _write_intra_mb(self, bw: _BW, q: List[np.ndarray],
                        pred_dc: List[int]):
        for bi in range(6):
            comp = 0 if bi < 4 else bi - 3
            dc = int(q[bi][0])
            diff = dc - pred_dc[comp]
            pred_dc[comp] = dc
            size = _dc_size(diff)
            codes = (T.DC_LUM_CODE, T.DC_LUM_BITS) if bi < 4 else \
                (T.DC_CHROMA_CODE, T.DC_CHROMA_BITS)
            bw.put(codes[0][size], codes[1][size])
            if size:
                raw = diff if diff > 0 else diff + (1 << size) - 1
                bw.put(raw, size)
            # AC run/level (zigzag order, positions 1..63)
            run = 0
            for i in range(1, 64):
                lv = int(q[bi][i])
                if lv == 0:
                    run += 1
                else:
                    _write_rl(bw, run, lv)
                    run = 0
            bw.put(_EOB[0], _EOB[1])

    def _write_inter_block(self, bw: _BW, q: np.ndarray):
        first = True
        run = 0
        for i in range(64):
            lv = int(q[i])
            if lv == 0:
                run += 1
                continue
            if first and run == 0 and abs(lv) == 1:
                bw.put(1, 1)
                bw.put(1 if lv < 0 else 0, 1)
            else:
                _write_rl(bw, run, lv)
            run = 0
            first = False
        bw.put(_EOB[0], _EOB[1])

    # -------------------------------------------------------- prediction
    def _predict(self, mvs, mb_w, mb_h):
        ry, ru, rv = self._recon
        pred_y = np.zeros_like(ry, np.int32)
        pred_u = np.zeros_like(ru, np.int32)
        pred_v = np.zeros_like(rv, np.int32)
        for mby in range(mb_h):
            for mbx in range(mb_w):
                dy, dx = int(mvs[mby, mbx, 0]), int(mvs[mby, mbx, 1])
                sy0 = np.clip(mby * 16 + dy, 0, ry.shape[0] - 16)
                sx0 = np.clip(mbx * 16 + dx, 0, ry.shape[1] - 16)
                mvs[mby, mbx] = (sy0 - mby * 16, sx0 - mbx * 16)
                pred_y[mby * 16:mby * 16 + 16, mbx * 16:mbx * 16 + 16] = \
                    ry[sy0:sy0 + 16, sx0:sx0 + 16]
                cy0, cx0 = mby * 8 + (sy0 - mby * 16) // 2, \
                    mbx * 8 + (sx0 - mbx * 16) // 2
                pred_u[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = \
                    ru[cy0:cy0 + 8, cx0:cx0 + 8]
                pred_v[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = \
                    rv[cy0:cy0 + 8, cx0:cx0 + 8]
        return pred_y, pred_u, pred_v

    def _reconstruct(self, coeff, intra_mask, used_mvs, mb_w, mb_h,
                     ftype):
        """Drift-free reference: exact decoder-side IDCT + prediction."""
        res = idct8x8(self._to_device(coeff.reshape(-1, 8, 8)
                                      .astype(np.float32))
                      ).cpu().numpy().reshape(mb_h, mb_w, 6, 8, 8)
        H, W = mb_h * 16, mb_w * 16
        ry = np.zeros((H, W), np.int32)
        ru = np.zeros((H // 2, W // 2), np.int32)
        rv = np.zeros((H // 2, W // 2), np.int32)
        if ftype == P_TYPE:
            mv_fp = used_mvs // 2
            pred_y, pred_u, pred_v = self._predict(mv_fp.copy(), mb_w,
                                                   mb_h)
            inter_pix = np.repeat(np.repeat(~intra_mask, 16, 0), 16, 1)
            inter_cpix = np.repeat(np.repeat(~intra_mask, 8, 0), 8, 1)
            ry = np.where(inter_pix, pred_y, 0)
            ru = np.where(inter_cpix, pred_u, 0)
            rv = np.where(inter_cpix, pred_v, 0)
        for mby in range(mb_h):
            for mbx in range(mb_w):
                for bi in range(6):
                    r = np.rint(res[mby, mbx, bi]).astype(np.int32)
                    if bi < 4:
                        py0 = mby * 16 + (bi // 2) * 8
                        px0 = mbx * 16 + (bi % 2) * 8
                        ry[py0:py0 + 8, px0:px0 + 8] += r
                    elif bi == 4:
                        ru[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] += r
                    else:
                        rv[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] += r
        self._recon = (np.clip(ry, 0, 255).astype(np.uint8),
                       np.clip(ru, 0, 255).astype(np.uint8),
                       np.clip(rv, 0, 255).astype(np.uint8))


# --------------------------------------------------------------- helpers

def _pad(p: np.ndarray, h: int, w: int) -> np.ndarray:
    if p.shape == (h, w):
        return p
    out = np.empty((h, w), p.dtype)
    ph, pw = p.shape
    out[:ph, :pw] = p
    out[ph:, :pw] = p[ph - 1:ph, :]
    out[:, pw:] = out[:, pw - 1:pw]
    return out


def _blocks(plane: np.ndarray, b: int) -> np.ndarray:
    h, w = plane.shape
    return plane.reshape(h // b, b, w // b, b).transpose(0, 2, 1, 3) \
        .reshape(-1, b * b)


def _mb_blocks(fy, fu, fv, mby, mbx, mb_w):
    """The 6 FDCT blocks of a macroblock from blockified planes."""
    bw = mb_w * 2
    out = []
    for by in range(2):
        for bx in range(2):
            out.append(fy[(mby * 2 + by) * bw + mbx * 2 + bx])
    cw = mb_w
    out.append(fu[mby * cw + mbx])
    out.append(fv[mby * cw + mbx])
    return out


def _quant_intra(f, qscale, m_raster, zz):
    """FDCT block (64, raster) -> quantized levels in zigzag order,
    inverting the decoder's (mag*qscale*w)>>4 dequant."""
    out = np.zeros(64, np.int32)
    out[0] = int(np.clip(np.rint(f[0] / 8.0), 1, 255))   # DC, 8-bit
    ac = f[zz[1:]]
    w = m_raster[zz[1:]].astype(np.float64)
    lv = np.rint(16.0 * ac / (w * qscale)).astype(np.int32)
    out[1:] = np.clip(lv, -2047, 2047)
    return out


def _quant_inter(f, qscale, m_raster, zz):
    ac = f[zz]
    w = m_raster[zz].astype(np.float64)
    lv = (16.0 * np.abs(ac) / (w * qscale)).astype(np.int32)
    lv = np.where(ac < 0, -lv, lv)
    return np.clip(lv, -2047, 2047)


def _dequant_intra(q, qscale, m_raster, zz):
    """Exact decoder-side dequant (13818-2 7.4.2) -> raster block."""
    out = np.zeros(64, np.float32)
    out[0] = q[0] * 8
    mism = (int(out[0]) & 1) ^ 1
    for i in range(1, 64):
        lv = int(q[i])
        if not lv:
            continue
        pos = int(zz[i])
        v = (abs(lv) * qscale * int(m_raster[pos])) >> 4
        v = min(2047, v)
        out[pos] = -v if lv < 0 else v
        mism ^= v & 1
    if mism & 1:
        v63 = int(out[63])
        out[63] = float(v63 ^ 1) if v63 >= 0 else -float((-v63) ^ 1)
    return out


def _dequant_inter(q, qscale, m_raster, zz):
    out = np.zeros(64, np.float32)
    mism = 1
    for i in range(64):
        lv = int(q[i])
        if not lv:
            continue
        pos = int(zz[i])
        v = ((2 * abs(lv) + 1) * qscale * int(m_raster[pos])) >> 5
        v = min(2047, v)
        out[pos] = -v if lv < 0 else v
        mism ^= v & 1
    if mism & 1:
        v63 = int(out[63])
        out[63] = float(v63 ^ 1) if v63 >= 0 else -float((-v63) ^ 1)
    return out


# ------------------------------------------------------ carrying state

_STATE_KEYS = ("frame_idx", "_recon", "_Xi", "_Xp", "_di", "_dp",
               "_gop_left", "_R", "_T_target", "_stats_out",
               "intra_matrix", "inter_matrix", "intra_m_raster",
               "inter_m_raster")


def state_from_reference(ref_encoder) -> dict:
    """The state of a reference (ffmpeg_tpu) Mpeg2Encoder as the port's
    encoder holds it, for `Mpeg2Encoder.load_state`: the reconstructed
    reference picture (host uint8 planes), the rate-control state, the
    frame index and the quantiser matrices, all as numpy or Python
    values.  The encoder has no weights; this is what lets one P frame
    be encoded from the same reference picture in both packages."""
    st = {k: getattr(ref_encoder, k) for k in _STATE_KEYS
          if hasattr(ref_encoder, k)}
    if st.get("_recon") is not None:
        st["_recon"] = tuple(np.array(p, np.uint8) for p in st["_recon"])
    st["_stats_out"] = list(st.get("_stats_out", ()))
    for k in ("intra_matrix", "inter_matrix", "intra_m_raster",
              "inter_m_raster"):
        st[k] = np.array(st[k], np.int32)
    for k in ("_Xi", "_Xp", "_di", "_dp", "_R", "_T_target"):
        if k in st:
            st[k] = float(st[k])
    for k in ("frame_idx", "_gop_left"):
        st[k] = int(st[k])
    return st
