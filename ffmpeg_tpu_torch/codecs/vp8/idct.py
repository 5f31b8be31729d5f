"""VP8 inverse transforms, exact integer math (RFC 6386 §14.3/§14.4;
reference: libavcodec/vp8dsp.c vp8_idct_add_c / vp8_luma_dc_wht_c).
Coefficient blocks are int16 arrays in raster order (dequantized
values wrap at int16 like the reference's int16_t block[16]).

The port's copy of ffmpeg_tpu/codecs/vp8/idct.py, held equal to it by
tests/test_torch_vp8_webp.py.
"""

from __future__ import annotations

import numpy as np


def _mul_20091(a):
    return ((a * 20091) >> 16) + a


def _mul_35468(a):
    return (a * 35468) >> 16


def _w16(v):
    """int16 wrap: the reference's intermediate is int16_t tmp[16]."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def idct_add(dst, block):
    """4x4 IDCT + add into dst (4,4) uint8 view; block (4,4) int."""
    b = block.astype(np.int64)
    t0 = b[0] + b[2]
    t1 = b[0] - b[2]
    t2 = _mul_35468(b[1]) - _mul_20091(b[3])
    t3 = _mul_20091(b[1]) + _mul_35468(b[3])
    tmp = _w16(np.stack([t0 + t3, t1 + t2, t1 - t2, t0 - t3], 1))
    t0 = tmp[0] + tmp[2]
    t1 = tmp[0] - tmp[2]
    t2 = _mul_35468(tmp[1]) - _mul_20091(tmp[3])
    t3 = _mul_20091(tmp[1]) + _mul_35468(tmp[3])
    out = np.stack([(t0 + t3 + 4) >> 3, (t1 + t2 + 4) >> 3,
                    (t1 - t2 + 4) >> 3, (t0 - t3 + 4) >> 3], 1)
    dst[:] = np.clip(dst.astype(np.int32) + out.astype(np.int32),
                     0, 255).astype(np.uint8)


def idct_dc_add(dst, block):
    dc = (int(block[0, 0]) + 4) >> 3
    dst[:] = np.clip(dst.astype(np.int32) + dc, 0, 255).astype(np.uint8)


def luma_dc_wht(dc):
    """Inverse WHT of the Y2 block → (4,4) of per-subblock DC values
    (vp8_luma_dc_wht_c)."""
    d = dc.astype(np.int64)
    t0 = d[0] + d[3]
    t1 = d[1] + d[2]
    t2 = d[1] - d[2]
    t3 = d[0] - d[3]
    # first pass writes back into the int16_t dc[] array
    m = _w16(np.stack([t0 + t1, t3 + t2, t0 - t1, t3 - t2], 0))
    t0 = m[:, 0] + m[:, 3] + 3
    t1 = m[:, 1] + m[:, 2]
    t2 = m[:, 1] - m[:, 2]
    t3 = m[:, 0] - m[:, 3] + 3
    return _w16(np.stack([(t0 + t1) >> 3, (t3 + t2) >> 3,
                          (t0 - t1) >> 3, (t3 - t2) >> 3],
                         1)).astype(np.int16)
