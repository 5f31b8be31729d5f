"""The host-entropy flagship: batched MJPEG decode-transform + scale→RGB
from coefficients the host has already entropy-decoded (counterpart of
ffmpeg_tpu/models/mjpeg_pipeline.py, the function
`__graft_entry__.entry()` drives).

The host's C++ Huffman decoder (`mjpeg_decode_scan`) produces per-frame
coefficient arrays; this module is everything after: one function that
takes a batch of coefficient planes and returns a batch of scaled RGB
frames.  dequant → (DCT-domain downscale) → IDCT as a matmul → tile
reassembly → chroma upsample → BT.601 matrix → resize matmuls → pack, in
full float32, run eagerly on the device of its inputs (the reference
jits it into one XLA program).

For large downscales (1080p→224) the pipeline uses a DCT-domain scaled
decode (like the reference's `lowres`, but exact block-average math, see
ops/idct._recon_matrix): only the first `ncoeff` zigzag coefficients per
block are transferred, cutting the host→device traffic by up to 8×.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

from ..ops.idct import jpeg_plane_reconstruct
from ..scale.ops import compile_ops
from ..scale.swscale import ScaleSpec, build_ops


@dataclass(frozen=True)
class DecodeScaleSpec:
    width: int = 1920
    height: int = 1080
    sub_w: int = 2               # chroma subsampling factors (420 → 2,2)
    sub_h: int = 2
    out_w: int = 224
    out_h: int = 224
    out_fmt: str = "rgb24"
    filter: str = "bicubic"
    lowres: int = 1              # DCT-domain downscale: 1, 2, 4, 8
    ncoeff: int = 64             # zigzag coefficients transferred per block

    @staticmethod
    def auto(width: int, height: int, out_w: int, out_h: int,
             sub_w: int = 2, sub_h: int = 2, **kw) -> "DecodeScaleSpec":
        """Pick the largest DCT-domain downscale that still supersamples
        the output by >=2x in both axes (visually transparent), and a
        matching coefficient budget."""
        lr = 1
        for cand in (2, 4, 8):
            if width // cand >= 2 * out_w and height // cand >= 2 * out_h:
                lr = cand
        ncoeff = {1: 64, 2: 12, 4: 8, 8: 4}[lr]
        return DecodeScaleSpec(width=width, height=height, sub_w=sub_w,
                               sub_h=sub_h, out_w=out_w, out_h=out_h,
                               lowres=lr, ncoeff=ncoeff, **kw)

    @property
    def luma_blocks(self) -> Tuple[int, int]:
        mcu_w, mcu_h = 8 * self.sub_w, 8 * self.sub_h
        mx = -(-self.width // mcu_w)
        my = -(-self.height // mcu_h)
        return my * self.sub_h, mx * self.sub_w

    @property
    def chroma_blocks(self) -> Tuple[int, int]:
        mcu_w, mcu_h = 8 * self.sub_w, 8 * self.sub_h
        return -(-self.height // mcu_h), -(-self.width // mcu_w)

    @property
    def chroma_dims(self) -> Tuple[int, int]:
        return (-(-self.width // self.sub_w), -(-self.height // self.sub_h))


def pack_coeffs(a: np.ndarray) -> np.ndarray:
    """int16 coefficient array → its uint8 wire view (zero-copy).  The
    uint8 wire format is the function's interface, as in the reference:
    coefficients travel as raw bytes and are bitcast back on the device."""
    return a.view(np.uint8)


def _unpack_coeffs(x: torch.Tensor) -> torch.Tensor:
    """(..., L*2) uint8 → (..., L) int16 on the same device: the
    little-endian byte pairs bitcast as the reference's
    lax.bitcast_convert_type does (the view needs a contiguous last dim
    of even length)."""
    if x.dtype != torch.uint8 or x.shape[-1] % 2:
        raise ValueError("coefficients must be (..., 2*L) uint8")
    if x.stride(-1) != 1:
        x = x.contiguous()
    return x.view(torch.int16)


def plane_dims(spec: DecodeScaleSpec) -> Tuple[Tuple[int, int],
                                               Tuple[int, int]]:
    """((h, w) luma, (h, w) chroma) of the reconstructed planes, in the
    DCT-downscaled grid."""
    lr = spec.lowres
    cw, ch = spec.chroma_dims
    return ((-(-spec.height // lr), -(-spec.width // lr)),
            (-(-ch // lr), -(-cw // lr)))


def scale_ops(spec: DecodeScaleSpec) -> list:
    """The op list that scales the reconstructed planes to the output."""
    (h_l, w_l), _ = plane_dims(spec)
    src_fmt = {(2, 2): "yuv420p", (2, 1): "yuv422p",
               (1, 1): "yuv444p"}[(spec.sub_w, spec.sub_h)]
    return build_ops(ScaleSpec(
        src_w=w_l, src_h=h_l, src_fmt=src_fmt,
        dst_w=spec.out_w, dst_h=spec.out_h, dst_fmt=spec.out_fmt,
        filter=spec.filter, src_range=True,      # JPEG = full range
        src_chroma_loc="center"))


def reconstruct_planes(spec: DecodeScaleSpec, coeff_y, coeff_u, coeff_v,
                       q_luma, q_chroma, rows: Tuple[int, int] = None):
    """[y, u, v] planes from wire coefficients; rows = (luma, chroma)
    heights to crop to (default: the whole planes')."""
    (h_l, w_l), (ch_l, cw_l) = plane_dims(spec)
    hy, hc = rows or (h_l, ch_l)
    return [jpeg_plane_reconstruct(_unpack_coeffs(c), q, h, w,
                                   scale=spec.lowres)
            for c, q, h, w in ((coeff_y, q_luma, hy, w_l),
                               (coeff_u, q_chroma, hc, cw_l),
                               (coeff_v, q_chroma, hc, cw_l))]


def build_decode_scale(spec: DecodeScaleSpec) -> Callable:
    """Returns fn(coeff_y, coeff_u, coeff_v, q_luma, q_chroma) → list of
    output component planes (batched over the leading dim), on the device
    of coeff_y.  coeff_* are uint8 wire tensors (..., rows, cols,
    ncoeff*2): int16 zigzag coefficients as raw bytes (see pack_coeffs).
    Raises unless float32 matmuls run in full float32."""
    scale_fn = compile_ops(scale_ops(spec))

    def fn(coeff_y, coeff_u, coeff_v, q_luma, q_chroma):
        return scale_fn(reconstruct_planes(spec, coeff_y, coeff_u, coeff_v,
                                           q_luma, q_chroma))

    return fn


def example_args(spec: DecodeScaleSpec, batch: int, seed: int = 0):
    """The reference's example inputs, byte for byte, as host numpy
    arrays (wire-format coefficients and two int32 quantiser tables)."""
    rng = np.random.default_rng(seed)
    ly, lx = spec.luma_blocks
    cy, cx = spec.chroma_blocks
    mk = lambda r, c: pack_coeffs(
        rng.integers(-64, 64, (batch, r, c, spec.ncoeff)).astype(np.int16))
    qt = lambda: rng.integers(1, 32, (64,)).astype(np.int32)
    return (mk(ly, lx), mk(cy, cx), mk(cy, cx), qt(), qt())


@functools.lru_cache(maxsize=8)
def cached_decode_scale(spec: DecodeScaleSpec) -> Callable:
    """build_decode_scale, built once per spec (the reference's
    `jitted_decode_scale`, less the jit)."""
    return build_decode_scale(spec)
