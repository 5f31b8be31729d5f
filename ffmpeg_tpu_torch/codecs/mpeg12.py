"""MPEG-1/2 video decoder (counterpart of ffmpeg_tpu/codecs/mpeg12.py;
reference: libavcodec/mpeg12dec.c + the shared MpegEncContext engine).

Split between the host and the decoder's device:
  * host, copied from the reference: start-code scan, headers, slice
    entropy decode (VLC run/level) and dequant, producing dense
    per-picture arrays: residual DCT coefficients (mb grid, 6 blocks,
    64) and per-MB motion vectors/flags; the concealment of damaged
    slices (err_detect=explode raises instead);
  * device (the `device` the decoder is opened on), in PyTorch: the
    float32 IDCT over the macroblock grid with frame and field DCT
    layouts (ops/idct.py idct8x8, full float32, TF32 refused), exact
    integer half-pel motion compensation (frame and field prediction,
    bi-prediction) from the reference pictures, prediction add, round
    half to even and clamp.

The reference copies every picture to the host and, for the next one,
pads it and copies it up again; the port keeps its reference pictures
(`_last`, `_next`) on the device, edge-padded to the macroblock grid as
the reference pads them, and its frames carry device planes.

Supports: MPEG-1 and MPEG-2 main profile frame pictures, progressive
and interlaced coding tools (field motion in frame pictures +
interlaced DCT, the tools broadcast streams use), I/P/B. Field
pictures and dual prime raise NotSupported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.frame import Frame
from ..core.packet import Packet
from ..io.stream import MediaType
from ..ops.idct import idct8x8, ZIGZAG
from ..utils.error import InvalidData, NotSupported
from ..utils.rational import Rational
from . import mpeg12_tables as T
from .bitstream import BitReader
from .codec import Codec, register_decoder
from .vp9.recon_tpu import _Timer

# picture types
I_TYPE, P_TYPE, B_TYPE = 1, 2, 3

# alternate (MPEG-2) scan
ALT_SCAN = np.array([
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63],
    np.int32)

# mb_type flag bits
MB_INTRA, MB_FWD, MB_BWD, MB_CODED, MB_QUANT = 1, 2, 4, 8, 16

# P-picture macroblock_type VLC (ISO 11172-2 Table B.2a): code → flags
_P_MBTYPE = {
    (0b1, 1): MB_FWD | MB_CODED,
    (0b01, 2): MB_CODED,
    (0b001, 3): MB_FWD,
    (0b00011, 5): MB_INTRA,
    (0b00010, 5): MB_FWD | MB_CODED | MB_QUANT,
    (0b00001, 5): MB_CODED | MB_QUANT,
    (0b000001, 6): MB_INTRA | MB_QUANT,
}
# B-picture macroblock_type VLC (Table B.2b)
_B_MBTYPE = {
    (0b10, 2): MB_FWD | MB_BWD,
    (0b11, 2): MB_FWD | MB_BWD | MB_CODED,
    (0b010, 3): MB_BWD,
    (0b011, 3): MB_BWD | MB_CODED,
    (0b0010, 4): MB_FWD,
    (0b0011, 4): MB_FWD | MB_CODED,
    (0b00011, 5): MB_INTRA,
    (0b00010, 5): MB_FWD | MB_BWD | MB_CODED | MB_QUANT,
    (0b000011, 6): MB_FWD | MB_CODED | MB_QUANT,
    (0b000010, 6): MB_BWD | MB_CODED | MB_QUANT,
    (0b000001, 6): MB_INTRA | MB_QUANT,
}

_QSCALE_NONLINEAR = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 18, 20, 22,
     24, 28, 32, 36, 40, 44, 48, 52, 56, 64, 72, 80, 88, 96, 104, 112],
    np.int32)


def _mk_lut(pairs, maxlen=None):
    """[(code,len)...] or dict → (sym_lut, len_lut, maxlen)."""
    if isinstance(pairs, dict):
        items = [(c, l, v) for (c, l), v in pairs.items()]
    else:
        items = [(c, l, i) for i, (c, l) in enumerate(pairs) if l > 0]
    maxlen = maxlen or max(l for _, l, _ in items)
    sym = np.full(1 << maxlen, -1, np.int32)
    ln = np.zeros(1 << maxlen, np.uint8)
    for c, l, v in items:
        lo = c << (maxlen - l)
        hi = lo + (1 << (maxlen - l))
        sym[lo:hi] = v
        ln[lo:hi] = l
    return sym, ln, maxlen


_ADDR_LUT = _mk_lut(T.MB_ADDR_INC)
_PAT_LUT = _mk_lut(T.MB_PAT)
_MV_LUT = _mk_lut(T.MB_MV)
_P_LUT = _mk_lut(_P_MBTYPE)
_B_LUT = _mk_lut(_B_MBTYPE)
_DC_LUM_LUT = _mk_lut(list(zip(T.DC_LUM_CODE, T.DC_LUM_BITS)))
_DC_CHR_LUT = _mk_lut(list(zip(T.DC_CHROMA_CODE, T.DC_CHROMA_BITS)))
# run/level VLCs: entries 0..110 map to (run, level); entry 111 is the
# escape code, entry 112 is end-of-block
_RL_N = len(T.RL_LEVEL)
_MPEG1_RL_LUT = _mk_lut(T.MPEG1_VLC)
_MPEG2_RL_LUT = _mk_lut(T.MPEG2_VLC)


def _vlc(br: BitReader, lut) -> int:
    sym, ln, maxlen = lut
    look = br.peek(maxlen)
    l = ln[look]
    if l == 0:
        raise InvalidData("mpeg12: bad vlc")
    br.skip(int(l))
    return int(sym[look])


@dataclass
class _Seq:
    width: int = 0
    height: int = 0
    mpeg2: bool = False
    intra_matrix: np.ndarray = None
    inter_matrix: np.ndarray = None
    frame_rate: Rational = None
    progressive: bool = True


@dataclass
class _SliceState:
    coeffs: np.ndarray
    flags: np.ndarray
    mvs_f: np.ndarray
    mvs_b: np.ndarray
    fsel_f: np.ndarray
    fsel_b: np.ndarray
    field_mv: np.ndarray
    dct_type: np.ndarray


@dataclass
class _Pic:
    type: int = I_TYPE
    f_code: np.ndarray = None        # (2,2): [fwd/bwd][x/y]
    full_pel: Tuple[int, int] = (0, 0)
    intra_dc_precision: int = 0
    q_scale_type: int = 0
    intra_vlc_format: int = 0
    alternate_scan: int = 0
    frame_pred_frame_dct: int = 1
    concealment_mv: int = 0
    top_field_first: int = 0
    temporal_ref: int = 0
    picture_structure: int = 3


@register_decoder
class Mpeg12Decoder(Codec):
    codec_id = "mpeg2video"
    codec_type = MediaType.VIDEO
    aliases = ("mpeg1video",)

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        self.seq = _Seq()
        # reference pictures: device planes, edge-padded to the MB grid
        self._last: Optional[List[torch.Tensor]] = None   # forward ref
        self._next: Optional[List[torch.Tensor]] = None   # backward ref
        self.stats: Optional[list] = None
        self._reorder: List[Frame] = []
        self._frame_no = 0

    # ------------------------------------------------------------------ decode
    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None:
            out = []
            if self._next_frame is not None:
                out.append(self._next_frame)
                self._next_frame = None
            return out
        data = pkt.data
        frames: List[Frame] = []
        # split into start-code units
        units = self._split_units(data)
        pic: Optional[_Pic] = None
        slices: List[bytes] = []
        for code, payload in units:
            if code == 0xB3:
                self._parse_seq_header(payload)
            elif code == 0xB5:
                self._parse_extension(payload, pic)
            elif code == 0x00:
                if pic is not None and slices:
                    frames.extend(self._decode_picture(pic, slices, pkt))
                    slices = []
                pic = self._parse_pic_header(payload)
            elif 0x01 <= code <= 0xAF:
                slices.append(bytes([code]) + payload)
            elif code in (0xB7, 0xB8):   # sequence end / GOP
                pass
        if pic is not None and slices:
            frames.extend(self._decode_picture(pic, slices, pkt))
        return frames

    _next_frame: Optional[Frame] = None

    @staticmethod
    def _split_units(data: bytes) -> List[Tuple[int, bytes]]:
        units = []
        i = 0
        n = len(data)
        while True:
            j = data.find(b"\x00\x00\x01", i)
            if j < 0:
                break
            code = data[j + 3]
            k = data.find(b"\x00\x00\x01", j + 4)
            end = k if k >= 0 else n
            units.append((code, data[j + 4:end]))
            if k < 0:
                break
            i = k
        return units

    # ------------------------------------------------------------------ headers
    def _parse_seq_header(self, payload: bytes) -> None:
        br = BitReader(payload)
        self.seq.width = br.get(12)
        self.seq.height = br.get(12)
        br.get(4)   # aspect
        fr_idx = br.get(4)
        if fr_idx < len(T.FRAME_RATES):
            n, d = T.FRAME_RATES[fr_idx]
            self.seq.frame_rate = Rational(n or 25, d)
        br.get(18)  # bitrate
        br.get(1)
        br.get(10)  # vbv
        br.get(1)   # constrained
        # stream matrices arrive in zigzag order; store raster-ordered
        # (the defaults in the tables are already raster-ordered)
        if br.get(1):
            m = np.array([br.get(8) for _ in range(64)], np.int32)
            ras = np.zeros(64, np.int32)
            ras[ZIGZAG] = m
            self.seq.intra_matrix = ras
        else:
            self.seq.intra_matrix = np.array(T.DEFAULT_INTRA_MATRIX, np.int32)
        if br.get(1):
            m = np.array([br.get(8) for _ in range(64)], np.int32)
            ras = np.zeros(64, np.int32)
            ras[ZIGZAG] = m
            self.seq.inter_matrix = ras
        else:
            self.seq.inter_matrix = np.array(T.DEFAULT_NON_INTRA_MATRIX, np.int32)
        self.seq.mpeg2 = False   # until a sequence extension appears

    def _parse_extension(self, payload: bytes, pic: Optional[_Pic]) -> None:
        if not payload:
            return
        br = BitReader(payload)
        ext_id = br.get(4)
        if ext_id == 1:        # sequence extension
            self.seq.mpeg2 = True
            br.get(8)          # profile/level
            self.seq.progressive = bool(br.get(1))
            br.get(2)          # chroma format (assume 420)
            w_ext = br.get(2)
            h_ext = br.get(2)
            self.seq.width |= w_ext << 12
            self.seq.height |= h_ext << 12
        elif ext_id == 8 and pic is not None:   # picture coding extension
            pic.f_code = np.array([[br.get(4), br.get(4)],
                                   [br.get(4), br.get(4)]], np.int32)
            pic.intra_dc_precision = br.get(2)
            picture_structure = br.get(2)
            if picture_structure != 3:
                raise NotSupported("mpeg2: field pictures")
            pic.picture_structure = picture_structure
            pic.top_field_first = br.get(1)
            pic.frame_pred_frame_dct = br.get(1)
            pic.concealment_mv = br.get(1)
            pic.q_scale_type = br.get(1)
            pic.intra_vlc_format = br.get(1)
            pic.alternate_scan = br.get(1)

    def _parse_pic_header(self, payload: bytes) -> _Pic:
        br = BitReader(payload)
        pic = _Pic()
        pic.temporal_ref = br.get(10)
        pic.type = br.get(3)
        br.get(16)  # vbv delay
        f = np.ones((2, 2), np.int32)
        full = [0, 0]
        if pic.type in (P_TYPE, B_TYPE):
            full[0] = br.get(1)
            f[0, :] = br.get(3)
        if pic.type == B_TYPE:
            full[1] = br.get(1)
            f[1, :] = br.get(3)
        pic.f_code = f
        pic.full_pel = tuple(full)
        return pic

    # ------------------------------------------------------------------ picture
    def _decode_picture(self, pic: _Pic, slices: List[bytes],
                        pkt: Packet) -> List[Frame]:
        seq = self.seq
        if not seq.width:
            raise InvalidData("mpeg12: no sequence header")
        mb_w = (seq.width + 15) // 16
        mb_h = (seq.height + 15) // 16

        coeffs = np.zeros((mb_h, mb_w, 6, 64), np.float32)  # dequantized, raster
        flags = np.zeros((mb_h, mb_w), np.int32)
        # per-MB MVs: [.., field (0 also = frame MV), (y, x)] half-pel
        mvs_f = np.zeros((mb_h, mb_w, 2, 2), np.int32)
        mvs_b = np.zeros((mb_h, mb_w, 2, 2), np.int32)
        fsel_f = np.zeros((mb_h, mb_w, 2), np.int32)
        fsel_b = np.zeros((mb_h, mb_w, 2), np.int32)
        field_mv = np.zeros((mb_h, mb_w), np.int32)   # 1 = field motion
        dct_type = np.zeros((mb_h, mb_w), np.int32)   # 1 = interlaced DCT

        st = _SliceState(coeffs, flags, mvs_f, mvs_b, fsel_f, fsel_b,
                         field_mv, dct_type)
        timer = _Timer(self.device) if self.stats is not None else None
        for sl in slices:
            try:
                self._decode_slice(sl, pic, st, mb_w, mb_h)
            except (InvalidData, IndexError) as e:
                # damaged slice: keep what decoded, conceal the rest
                # (error_resilience.c semantics; AV_EF_EXPLODE disables)
                if self.options.get("err_detect") == "explode":
                    raise InvalidData(f"mpeg12: slice error: {e}") \
                        from e
                self.warning(f"slice error, concealing: {e}")

        # handle skipped MBs in P: copy (MV 0), flags stay 0 → copy from last
        if timer is not None:
            timer.host_mark("parse")
        out_planes = self._reconstruct(pic, st, mb_w, mb_h, timer)
        if timer is not None:
            self._finish_stats(timer, pic)

        f = Frame.video(seq.width, seq.height, "yuv420p",
                        planes=out_planes, pts=pkt.pts,
                        time_base=pkt.time_base)
        f.pict_type = {I_TYPE: "I", P_TYPE: "P", B_TYPE: "B"}[pic.type]
        f.key_frame = pic.type == I_TYPE

        # reference management + B reordering (output order)
        out: List[Frame] = []
        if pic.type in (I_TYPE, P_TYPE):
            self._last = self._next
            self._next = [_pad_plane(p, mb_h * 16 if i == 0 else mb_h * 8,
                                     mb_w * 16 if i == 0 else mb_w * 8)
                          for i, p in enumerate(out_planes)]
            if self._next_frame is not None:
                out.append(self._next_frame)
            self._next_frame = f
        else:
            out.append(f)
        return out

    # ------------------------------------------------------------------ slice
    def _decode_slice(self, sl: bytes, pic: _Pic, st: "_SliceState",
                      mb_w, mb_h) -> None:
        seq = self.seq
        coeffs, flags = st.coeffs, st.flags
        mvs_f, mvs_b = st.mvs_f, st.mvs_b
        slice_row = sl[0] - 1
        br = BitReader(sl[1:])
        qscale = self._qscale(br.get(5), pic)
        while br.get(1):     # extra slice info
            br.get(8)
        mb_x = -1
        mb_y = slice_row
        dc_prec = pic.intra_dc_precision if seq.mpeg2 else 0
        dc_pred_reset = 1 << (7 + dc_prec)
        pred_dc = [dc_pred_reset] * 3
        # PMV state (13818-2 7.6.3.1): [dir][field][y/x] in code units
        pred_mv = np.zeros((2, 2, 2), np.int32)

        first = True
        n_mbs = mb_w * mb_h
        while br.bits_left() > 0:
            # macroblock address increment (may include escapes)
            inc = 0
            while True:
                if br.bits_left() <= 0:
                    return
                look = br.peek(11)
                if look == 0x8:      # escape 0000 0001 000
                    br.skip(11)
                    inc += 33
                    continue
                if look == 0xF:      # macroblock_stuffing (MPEG-1)
                    br.skip(11)
                    continue
                try:
                    v = _vlc(br, _ADDR_LUT)
                except InvalidData:
                    # legit end = only zero padding remains until the
                    # next start code; anything else is corruption
                    if self._rest_is_padding(br):
                        return
                    raise InvalidData("mpeg12: corrupt macroblock "
                                      "address increment mid-slice")
                inc += v + 1
                break
            if first:
                mb_x = inc - 1
                first = False
            else:
                addr = mb_y * mb_w + mb_x
                if inc > 1:
                    # skipped MBs: reset predictors
                    pred_dc = [dc_pred_reset] * 3
                    if pic.type == P_TYPE:
                        pred_mv[:] = 0
                    for sk in range(1, inc):
                        sa = addr + sk
                        if sa >= n_mbs:
                            break
                        sy, sx = divmod(sa, mb_w)
                        if seq.mpeg2 and sy != mb_y:
                            break    # 13818-2: slices never cross rows
                        if pic.type == B_TYPE:
                            # skipped B: frame prediction from the PMVs
                            # with the previous MB's directions
                            flags[sy, sx] = flags[mb_y, mb_x] & \
                                (MB_FWD | MB_BWD)
                            mvs_f[sy, sx, 0] = pred_mv[0, 0]
                            mvs_b[sy, sx, 0] = pred_mv[1, 0]
                        else:
                            flags[sy, sx] = MB_FWD   # zero-MV copy
                addr += inc
                if seq.mpeg2:
                    # 13818-2: a slice is confined to one MB row
                    mb_x = mb_x + inc
                    if mb_x >= mb_w:
                        return
                else:
                    # 11172-2: slices may span rows; the address simply
                    # continues in raster order (mpeg12dec.c wraps
                    # mb_x/mb_y the same way for MPEG-1 slices)
                    if addr >= n_mbs:
                        return
                    mb_y, mb_x = divmod(addr, mb_w)
            if mb_x >= mb_w or mb_y >= mb_h:
                return

            if pic.type == I_TYPE:
                mb_flags = self._i_mbtype(br)
            else:
                mb_flags = _vlc(br, _P_LUT if pic.type == P_TYPE else _B_LUT)
            if mb_flags & MB_QUANT:
                qscale = self._qscale(br.get(5), pic)

            motion_type = 2   # frame MC
            if seq.mpeg2 and not pic.frame_pred_frame_dct and \
                    (mb_flags & (MB_FWD | MB_BWD)):
                motion_type = br.get(2)
                if motion_type == 3:
                    raise NotSupported("mpeg2: dual prime")
                if motion_type == 0:
                    raise InvalidData("mpeg2: bad motion type")
            if seq.mpeg2 and not pic.frame_pred_frame_dct and \
                    (mb_flags & (MB_CODED | MB_INTRA)):
                st.dct_type[mb_y, mb_x] = br.get(1)

            if mb_flags & MB_INTRA:
                pred_mv[:] = 0
                if pic.concealment_mv:
                    raise NotSupported("mpeg2: concealment MVs")
                flags[mb_y, mb_x] = MB_INTRA
                self._decode_intra_mb(br, pic, coeffs[mb_y, mb_x], pred_dc,
                                      qscale)
                continue

            pred_dc = [dc_pred_reset] * 3
            # motion vectors
            if mb_flags & MB_FWD:
                self._decode_mb_motion(br, pic, 0, pred_mv, motion_type,
                                       st, mb_y, mb_x)
            elif pic.type == P_TYPE:
                pred_mv[0] = 0
                mvs_f[mb_y, mb_x] = 0
                st.field_mv[mb_y, mb_x] = 0
                mb_flags |= MB_FWD
            if mb_flags & MB_BWD:
                self._decode_mb_motion(br, pic, 1, pred_mv, motion_type,
                                       st, mb_y, mb_x)
            flags[mb_y, mb_x] = mb_flags & (MB_FWD | MB_BWD)

            if mb_flags & MB_CODED:
                cbp = _vlc(br, _PAT_LUT)
                if cbp == 0 and not seq.mpeg2:
                    raise InvalidData("mpeg1: cbp 0")
                for blk in range(6):
                    if cbp & (1 << (5 - blk)):
                        self._decode_inter_block(br, pic, coeffs[mb_y, mb_x, blk],
                                                 qscale)

    @staticmethod
    def _rest_is_padding(br: BitReader) -> bool:
        """True if only zero bits remain (legal slice padding)."""
        n = br.bits_left()
        while n > 0:
            k = min(n, 24)
            if br.get(k):
                return False
            n -= k
        return True

    def _decode_mb_motion(self, br: BitReader, pic: _Pic, which: int,
                          pred_mv: np.ndarray, motion_type: int,
                          st: "_SliceState", mb_y: int, mb_x: int) -> None:
        """Frame (motion_type 2) or field (1) motion for one direction
        in a frame picture (mpeg12dec.c mpeg_decode_mb MT_FRAME/
        MT_FIELD)."""
        mvs = st.mvs_f if which == 0 else st.mvs_b
        fsel = st.fsel_f if which == 0 else st.fsel_b
        if motion_type == 2:              # frame motion
            self._decode_mv(br, pic, which, pred_mv, 0, field_y=False)
            pred_mv[which, 1] = pred_mv[which, 0]
            mvs[mb_y, mb_x, 0] = pred_mv[which, 0]
            mvs[mb_y, mb_x, 1] = pred_mv[which, 0]
        else:                             # field motion, two MVs
            st.field_mv[mb_y, mb_x] = 1
            for t in range(2):
                fsel[mb_y, mb_x, t] = br.get(1)
                self._decode_mv(br, pic, which, pred_mv, t, field_y=True)
                mvs[mb_y, mb_x, t] = pred_mv[which, t]

    def _i_mbtype(self, br: BitReader) -> int:
        if br.get(1):
            return MB_INTRA
        if br.get(1):
            return MB_INTRA | MB_QUANT
        raise InvalidData("mpeg12: bad I mb_type")

    def _qscale(self, code: int, pic: _Pic) -> int:
        if not self.seq.mpeg2:
            return code
        if pic.q_scale_type:
            return int(_QSCALE_NONLINEAR[code])
        return code << 1

    # --- motion vectors --------------------------------------------------------
    def _decode_mv(self, br: BitReader, pic: _Pic, which: int,
                   pred_mv: np.ndarray, fld: int,
                   field_y: bool = False) -> None:
        # stream order: horizontal then vertical; we store (y, x).
        # Field motion in frame pictures halves the vertical predictor
        # before decoding and doubles the result (13818-2 7.6.3.1).
        for store_idx, fcode_idx in ((1, 0), (0, 1)):
            f_code = int(pic.f_code[which, fcode_idx])
            code = _vlc(br, _MV_LUT)
            if code:
                sign = -1 if br.get(1) else 1
            else:
                sign = 1
            r_size = f_code - 1
            if code and r_size:
                residual = br.get(r_size)
                delta = ((code - 1) << r_size) + residual + 1
            else:
                delta = code
            delta *= sign
            rng = 1 << (f_code + 3)      # [-16*2^(f-1), 16*2^(f-1)) (13818-2)
            pred = int(pred_mv[which, fld, store_idx])
            halve = field_y and store_idx == 0
            if halve:
                pred >>= 1
            val = pred + delta
            val = ((val + rng) % (2 * rng)) - rng
            if halve:
                val *= 2
            pred_mv[which, fld, store_idx] = val

    # --- block coefficients -----------------------------------------------------
    def _scan(self, pic: _Pic) -> np.ndarray:
        return ALT_SCAN if (self.seq.mpeg2 and pic.alternate_scan) else ZIGZAG

    def _decode_intra_mb(self, br: BitReader, pic: _Pic, blocks: np.ndarray,
                         pred_dc: List[int], qscale: int) -> None:
        seq = self.seq
        scan = self._scan(pic)
        dc_prec = pic.intra_dc_precision if seq.mpeg2 else 0
        dc_mult = 8 >> dc_prec
        for blk in range(6):
            comp = 0 if blk < 4 else blk - 3
            lut = _DC_LUM_LUT if blk < 4 else _DC_CHR_LUT
            size = _vlc(br, lut)
            if size:
                diff = br.get(size)
                if diff < (1 << (size - 1)):
                    diff -= (1 << size) - 1
            else:
                diff = 0
            pred_dc[comp] += diff
            out = np.zeros(64, np.float32)
            out[0] = pred_dc[comp] * dc_mult
            # AC coefficients (intra: start at scan index 1)
            self._rl_decode(br, pic, out, scan, qscale, intra=True,
                            mism0=(int(out[0]) & 1) ^ 1)
            blocks[blk][:] = out

    def _rl_decode(self, br: BitReader, pic: _Pic, out: np.ndarray,
                   scan: np.ndarray, qscale: int, intra: bool,
                   start: int = 1, mism0: int = 1) -> None:
        """Run/level decode + dequant into raster `out` (float32 x64)."""
        seq = self.seq
        mpeg2 = seq.mpeg2
        lut = _MPEG2_RL_LUT if (mpeg2 and intra and pic.intra_vlc_format) \
            else _MPEG1_RL_LUT
        matrix = seq.intra_matrix if intra else seq.inter_matrix
        i = start          # index of the next coefficient slot
        mism = mism0
        while True:
            sym = _vlc(br, lut)
            if sym == _RL_N + 1:      # end of block
                break
            if sym == _RL_N:          # escape
                run = br.get(6)
                if mpeg2:
                    level = br.get(12)
                    if level >= 2048:
                        level -= 4096
                else:
                    level = br.get(8)
                    if level == 0:
                        level = br.get(8)
                    elif level == 128:
                        level = br.get(8) - 256
                    elif level > 128:
                        level -= 256
            else:
                run = T.RL_RUN[sym]
                level = T.RL_LEVEL[sym]
                if br.get(1):
                    level = -level
            i += run
            if i > 63:
                raise InvalidData("mpeg12: run overflow")
            pos = int(scan[i])
            w = int(matrix[pos])   # raster-ordered matrix
            mag = abs(level)
            # reference-exact dequant: magnitude scaled with truncation,
            # then sign (13818-2 7.4.2 / 11172-2 2.4.4)
            if intra:
                v = (mag * qscale * w) >> (4 if mpeg2 else 3)
            else:
                v = ((2 * mag + 1) * qscale * w) >> (5 if mpeg2 else 4)
            if not mpeg2 and v and not (v & 1):
                v -= 1             # MPEG-1 oddification
            v = min(2047, v)
            val = -v if level < 0 else v
            out[pos] = val
            mism ^= int(val) & 1
            i += 1
        if mpeg2 and (mism & 1):
            # mismatch control (13818-2 7.4.4): mism tracks the parity of the
            # coefficient sum (init 1, xor of each LSB); when the sum is even
            # toggle the LSB of coefficient (7,7)
            v63 = int(out[63])
            out[63] = float(v63 ^ 1) if v63 >= 0 else -float((-v63) ^ 1)

    def _decode_inter_block(self, br: BitReader, pic: _Pic, out: np.ndarray,
                            qscale: int) -> None:
        scan = self._scan(pic)
        # first-coefficient special case: leading '1' means (run 0, ±1)
        look = br.peek(2)
        if look >> 1 == 1:
            br.skip(2)
            neg = (look & 1) == 1
            w = int(self.seq.inter_matrix[0])
            v = (3 * qscale * w) >> (5 if self.seq.mpeg2 else 4)
            if not self.seq.mpeg2:
                v = v - 1 if (v and not (v & 1)) else v
            v = min(2047, v)
            out[int(scan[0])] = -v if neg else v
            mi = (int(out[int(scan[0])]) & 1) ^ 1
            self._rl_decode(br, pic, out, scan, qscale, intra=False,
                            start=1, mism0=mi)
        else:
            self._rl_decode(br, pic, out, scan, qscale, intra=False, start=0)

    # ------------------------------------------------------------------ recon
    def _reconstruct(self, pic: _Pic, st: "_SliceState", mb_w, mb_h,
                     timer=None) -> List[torch.Tensor]:
        """The picture's planes on the decoder's device, cropped to the
        sequence's size: the per-picture arrays go up once, then the
        IDCT, MC and prediction add run there.  The reference pictures
        are the device planes kept in `_last`/`_next`."""
        seq = self.seq
        w, h = seq.width, seq.height
        dev = self.device
        if timer is not None:
            arrays = [st.coeffs, st.dct_type]
            if pic.type != I_TYPE:
                arrays += [st.flags, st.mvs_f, st.mvs_b, st.fsel_f,
                           st.fsel_b, st.field_mv]
            timer.h2d_bytes = sum(a.nbytes for a in arrays)
            timer.dev_mark("h2d")
        coeffs = _up(st.coeffs, dev)
        dct_type = _up(st.dct_type, dev)
        if timer is not None:
            timer.dev_mark("residual")
        residual = _residual_planes(coeffs, dct_type, mb_w, mb_h)
        if pic.type == I_TYPE:
            planes = [torch.clamp(torch.round(r), 0, 255).to(torch.uint8)
                      for r in residual]
        else:
            # B: both references; P: the most recent one
            fwd = self._last if pic.type == B_TYPE else self._next
            bwd = self._next if pic.type == B_TYPE else None
            if fwd is None:
                fwd = [torch.zeros((mb_h * 16, mb_w * 16), dtype=torch.uint8,
                                   device=dev),
                       torch.zeros((mb_h * 8, mb_w * 8), dtype=torch.uint8,
                                   device=dev),
                       torch.zeros((mb_h * 8, mb_w * 8), dtype=torch.uint8,
                                   device=dev)]
            full_pel = pic.full_pel
            if timer is not None:
                timer.dev_mark("h2d_mc")
            args = [_up(a, dev) for a in (
                st.flags, st.mvs_f << full_pel[0],
                st.mvs_b << (full_pel[1] if len(full_pel) > 1 else 0),
                st.fsel_f, st.fsel_b, st.field_mv)]
            if timer is not None:
                timer.dev_mark("mc")
            planes = _recon_inter(fwd, bwd, residual, *args, mb_w, mb_h,
                                  bool(st.field_mv.any()))
        if timer is not None:
            timer.dev_mark("done")
            timer.host_mark("queue")     # the host's launches
        return [planes[0][:h, :w], planes[1][:h // 2, :w // 2],
                planes[2][:h // 2, :w // 2]]

    def _finish_stats(self, timer, pic: _Pic) -> None:
        """Wait for the device and append the picture's split: host
        parse and queue ms, h2d bytes, device ms by stage (h2d, residual,
        mc; CUDA events on a card)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timer.host_mark("wait")
        dev = timer.device_ms()
        dev["h2d"] = dev["h2d"] + dev.pop("h2d_mc", 0.0)
        self.stats.append({"type": "IPB"[pic.type - 1],
                           "host": dict(timer.host),
                           "h2d_bytes": timer.h2d_bytes, "device": dev})

    def flush_state(self) -> None:
        self._last = self._next = None
        self._next_frame = None


_ZZ_OF_RASTER = {int(ZIGZAG[i]): i for i in range(64)}


def i_zz(pos):
    return _ZZ_OF_RASTER[pos]


def _up(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array copied to `device`."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _pad_plane(p: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """A cropped picture plane edge-padded to (h, w), on its device (the
    reference pads its host copy the same way before each use)."""
    if tuple(p.shape) == (h, w):
        return p
    rows = torch.arange(h, device=p.device).clamp(max=p.shape[0] - 1)
    cols = torch.arange(w, device=p.device).clamp(max=p.shape[1] - 1)
    return p[rows][:, cols]


def _residual_planes(coeffs, dct_type, mb_w: int, mb_h: int):
    """(mb_h, mb_w, 6, 64) dequantized raster coeffs → [Y, U, V]
    float32 planes. dct_type selects frame (quadrant) vs interlaced
    (field-split) luma block layout per MB (13818-2 figure 6-13)."""
    blocks = coeffs.reshape(mb_h, mb_w, 6, 8, 8)
    pix = idct8x8(blocks)
    yb = pix[:, :, :4].reshape(mb_h, mb_w, 2, 2, 8, 8)
    y_frame = yb.permute(0, 2, 4, 1, 3, 5).reshape(mb_h * 16, mb_w * 16)
    # interlaced: blocks (0,1) = top field L/R, (2,3) = bottom field;
    # MB row index = 2*r + field
    y_field = yb.permute(0, 4, 2, 1, 3, 5).reshape(mb_h * 16, mb_w * 16)
    fm = _expand(dct_type, 16).to(torch.bool)
    y = torch.where(fm, y_field, y_frame)
    u = pix[:, :, 4].permute(0, 2, 1, 3).reshape(mb_h * 8, mb_w * 8)
    v = pix[:, :, 5].permute(0, 2, 1, 3).reshape(mb_h * 8, mb_w * 8)
    return [y, u, v]


def _mc_halfpel(ref, mvs, block_h: int, block_w: int = None):
    """Exact MPEG half-pel MC: ref (H, W) uint8, mvs (by, bx, 2) int32
    in half-pel (y, x). Returns int32 (by*block_h, bx*block_w).  `>>`
    and `& 1` on int32 are arithmetic, as in the reference; every index
    is clipped into the plane explicitly."""
    if block_w is None:
        block_w = block_h
    h, w = ref.shape
    by, bx = mvs.shape[:2]
    dev = ref.device
    r = ref.to(torch.int32)
    iy = mvs[..., 0] >> 1
    ix = mvs[..., 1] >> 1
    hy = mvs[..., 0] & 1
    hx = mvs[..., 1] & 1
    y0 = torch.arange(by, device=dev)[:, None] * block_h + iy
    x0 = torch.arange(bx, device=dev)[None, :] * block_w + ix
    oy = torch.arange(block_h, device=dev)
    ox = torch.arange(block_w, device=dev)

    def g(dy, dx):
        yy = torch.clamp(y0[..., None, None] + oy[None, None, :, None] + dy,
                         0, h - 1)
        xx = torch.clamp(x0[..., None, None] + ox[None, None, None, :] + dx,
                         0, w - 1)
        return r[yy, xx]

    p00 = g(0, 0)
    p01 = g(0, 1)
    p10 = g(1, 0)
    p11 = g(1, 1)
    hx_ = hx[..., None, None].to(torch.bool)
    hy_ = hy[..., None, None].to(torch.bool)
    # exact integer rounding per 13818-2: (a+b+1)//2 ; (a+b+c+d+2)//4
    both = (p00 + p01 + p10 + p11 + 2) >> 2
    horiz = (p00 + p01 + 1) >> 1
    vert = (p00 + p10 + 1) >> 1
    pred = torch.where(hx_ & hy_, both,
                       torch.where(hx_, horiz, torch.where(hy_, vert, p00)))
    return pred.permute(0, 2, 1, 3).reshape(by * block_h, bx * block_w)


def _mc_field(ref, mvs, fsel, block_h: int, block_w: int):
    """Field MC in a frame picture: for each output field t (rows
    t::2), predict a (block_h, block_w) block per MB from the selected
    source field. mvs: (by, bx, 2, 2) with y in field half-pel.
    Returns the interleaved (by*2*block_h, bx*block_w) prediction."""
    by, bx = mvs.shape[:2]
    preds = []
    for t in range(2):
        mv_t = mvs[:, :, t, :]
        # source field s: compute from both fields, select per MB
        p0 = _mc_halfpel(ref[0::2], mv_t, block_h, block_w)
        p1 = _mc_halfpel(ref[1::2], mv_t, block_h, block_w)
        sel = _expand_rect(fsel[:, :, t], block_h, block_w)
        preds.append(torch.where(sel.to(torch.bool), p1, p0))
    out = torch.empty((by * 2 * block_h, bx * block_w),
                      dtype=preds[0].dtype, device=ref.device)
    out[0::2] = preds[0]
    out[1::2] = preds[1]
    return out


def _recon_inter(fwd, bwd, residual, flags, mvs_f, mvs_b, fsel_f,
                 fsel_b, field_mv, mb_w: int, mb_h: int,
                 any_field: bool = True):
    """Prediction + residual for a P or B picture.  any_field: whether
    some MB has field motion; without any, the reference's field
    prediction is computed and then never selected, so it is skipped."""
    out = []
    for ci in range(3):
        block = 16 if ci == 0 else 8
        mvf = mvs_f if ci == 0 else _chroma_mv(mvs_f)
        mvb = mvs_b if ci == 0 else _chroma_mv(mvs_b)

        # field MVs: vertical stored in frame units (doubled); MC wants
        # field half-pel units. Chroma values can be odd — C division
        # truncates toward zero (mpeg_motion_field mx/my).
        def fieldize(m):
            y = m[..., 0]
            yt = torch.sign(y) * (torch.abs(y) >> 1)
            return torch.stack([yt, m[..., 1]], dim=-1)
        fm = _expand(field_mv, block).to(torch.bool)

        def pred_one(ref, mv, fsel):
            p_frame = _mc_halfpel(ref, mv[:, :, 0, :], block, block)
            if not any_field:
                return p_frame
            p_field = _mc_field(ref, fieldize(mv), fsel, block // 2,
                                block)
            return torch.where(fm, p_field, p_frame)

        pf = pred_one(fwd[ci], mvf, fsel_f)
        has_f = _expand(flags & MB_FWD, block).to(torch.bool)
        has_b = _expand(flags & MB_BWD, block).to(torch.bool)
        if bwd is not None:
            pb = pred_one(bwd[ci], mvb, fsel_b)
            avg = (pf + pb + 1) >> 1
            pred = torch.where(has_f & has_b, avg,
                               torch.where(has_b, pb, pf))
        else:
            pred = pf
        intra = _expand(flags & MB_INTRA, block).to(torch.bool)
        zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
        pred = torch.where(intra, zero,
                           torch.where(has_f | has_b, pred, zero))
        rec = pred.to(torch.float32) + residual[ci]
        out.append(torch.clamp(torch.round(rec), 0, 255).to(torch.uint8))
    return out


def _chroma_mv(mvs):
    """Luma half-pel MV → chroma half-pel MV: /2 truncating toward zero
    (C division semantics, matching mpegvideo_motion)."""
    return torch.sign(mvs) * (torch.abs(mvs) >> 1)


def _expand(grid, block: int):
    """(mb_h, mb_w) → (mb_h*block, mb_w*block) via repeat."""
    return grid.repeat_interleave(block, 0).repeat_interleave(block, 1)


def _expand_rect(grid, bh: int, bw: int):
    return grid.repeat_interleave(bh, 0).repeat_interleave(bw, 1)
