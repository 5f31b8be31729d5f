"""VP9 inverse transforms (DCT/ADST 4..32), exact integer math
(VP9 spec §8.7; reference: libavcodec/vp9dsp_template.c itxfm_wrapper
and the *_1d kernels). Each 1-D kernel is vectorized over columns:
`x` is an (n, m) int64 array and the kernel transforms axis 0.

The port's copy of ffmpeg_tpu/codecs/vp9/itxfm.py, held equal to it by
tests/test_torch_host_copies.py."""

from __future__ import annotations

import numpy as np

DCT_DCT, DCT_ADST, ADST_DCT, ADST_ADST = 0, 1, 2, 3


def _r(v):
    return (v + 8192) >> 14


def idct4_1d(x, stack=np.stack):
    t0 = _r((x[0] + x[2]) * 11585)
    t1 = _r((x[0] - x[2]) * 11585)
    t2 = _r(x[1] * 6270 - x[3] * 15137)
    t3 = _r(x[1] * 15137 + x[3] * 6270)
    return stack([t0 + t3, t1 + t2, t1 - t2, t0 - t3])


def iadst4_1d(x, stack=np.stack):
    t0 = 5283 * x[0] + 15212 * x[2] + 9929 * x[3]
    t1 = 9929 * x[0] - 5283 * x[2] - 15212 * x[3]
    t2 = 13377 * (x[0] - x[2] + x[3])
    t3 = 13377 * x[1]
    return stack([_r(t0 + t3), _r(t1 + t3), _r(t2),
                     _r(t0 + t1 - t3)])


def idct8_1d(x, stack=np.stack):
    t0a = _r((x[0] + x[4]) * 11585)
    t1a = _r((x[0] - x[4]) * 11585)
    t2a = _r(x[2] * 6270 - x[6] * 15137)
    t3a = _r(x[2] * 15137 + x[6] * 6270)
    t4a = _r(x[1] * 3196 - x[7] * 16069)
    t5a = _r(x[5] * 13623 - x[3] * 9102)
    t6a = _r(x[5] * 9102 + x[3] * 13623)
    t7a = _r(x[1] * 16069 + x[7] * 3196)
    t0 = t0a + t3a
    t1 = t1a + t2a
    t2 = t1a - t2a
    t3 = t0a - t3a
    t4 = t4a + t5a
    t5a_ = t4a - t5a
    t7 = t7a + t6a
    t6a_ = t7a - t6a
    t5 = _r((t6a_ - t5a_) * 11585)
    t6 = _r((t6a_ + t5a_) * 11585)
    return stack([t0 + t7, t1 + t6, t2 + t5, t3 + t4,
                     t3 - t4, t2 - t5, t1 - t6, t0 - t7])


def iadst8_1d(x, stack=np.stack):
    t0a = 16305 * x[7] + 1606 * x[0]
    t1a = 1606 * x[7] - 16305 * x[0]
    t2a = 14449 * x[5] + 7723 * x[2]
    t3a = 7723 * x[5] - 14449 * x[2]
    t4a = 10394 * x[3] + 12665 * x[4]
    t5a = 12665 * x[3] - 10394 * x[4]
    t6a = 4756 * x[1] + 15679 * x[6]
    t7a = 15679 * x[1] - 4756 * x[6]
    t0 = _r(t0a + t4a)
    t1 = _r(t1a + t5a)
    t2 = _r(t2a + t6a)
    t3 = _r(t3a + t7a)
    t4 = _r(t0a - t4a)
    t5 = _r(t1a - t5a)
    t6 = _r(t2a - t6a)
    t7 = _r(t3a - t7a)
    t4a = 15137 * t4 + 6270 * t5
    t5a = 6270 * t4 - 15137 * t5
    t6a = 15137 * t7 - 6270 * t6
    t7a = 6270 * t7 + 15137 * t6
    o0 = t0 + t2
    o7 = -(t1 + t3)
    t2_ = t0 - t2
    t3_ = t1 - t3
    o1 = -_r(t4a + t6a)
    o6 = _r(t5a + t7a)
    t6_ = _r(t4a - t6a)
    t7_ = _r(t5a - t7a)
    o3 = -_r((t2_ + t3_) * 11585)
    o4 = _r((t2_ - t3_) * 11585)
    o2 = _r((t6_ + t7_) * 11585)
    o5 = -_r((t6_ - t7_) * 11585)
    return stack([o0, o1, o2, o3, o4, o5, o6, o7])


def idct16_1d(x, stack=np.stack):
    t0a = _r((x[0] + x[8]) * 11585)
    t1a = _r((x[0] - x[8]) * 11585)
    t2a = _r(x[4] * 6270 - x[12] * 15137)
    t3a = _r(x[4] * 15137 + x[12] * 6270)
    t4a = _r(x[2] * 3196 - x[14] * 16069)
    t7a = _r(x[2] * 16069 + x[14] * 3196)
    t5a = _r(x[10] * 13623 - x[6] * 9102)
    t6a = _r(x[10] * 9102 + x[6] * 13623)
    t8a = _r(x[1] * 1606 - x[15] * 16305)
    t15a = _r(x[1] * 16305 + x[15] * 1606)
    t9a = _r(x[9] * 12665 - x[7] * 10394)
    t14a = _r(x[9] * 10394 + x[7] * 12665)
    t10a = _r(x[5] * 7723 - x[11] * 14449)
    t13a = _r(x[5] * 14449 + x[11] * 7723)
    t11a = _r(x[13] * 15679 - x[3] * 4756)
    t12a = _r(x[13] * 4756 + x[3] * 15679)

    t0 = t0a + t3a
    t1 = t1a + t2a
    t2 = t1a - t2a
    t3 = t0a - t3a
    t4 = t4a + t5a
    t5 = t4a - t5a
    t6 = t7a - t6a
    t7 = t7a + t6a
    t8 = t8a + t9a
    t9 = t8a - t9a
    t10 = t11a - t10a
    t11 = t11a + t10a
    t12 = t12a + t13a
    t13 = t12a - t13a
    t14 = t15a - t14a
    t15 = t15a + t14a

    t5a = _r((t6 - t5) * 11585)
    t6a = _r((t6 + t5) * 11585)
    t9a = _r(t14 * 6270 - t9 * 15137)
    t14a = _r(t14 * 15137 + t9 * 6270)
    t10a = _r(-(t13 * 15137 + t10 * 6270))
    t13a = _r(t13 * 6270 - t10 * 15137)

    t0a = t0 + t7
    t1a = t1 + t6a
    t2a = t2 + t5a
    t3a = t3 + t4
    t4 = t3 - t4
    t5 = t2 - t5a
    t6 = t1 - t6a
    t7 = t0 - t7
    t8a = t8 + t11
    t9 = t9a + t10a
    t10 = t9a - t10a
    t11a = t8 - t11
    t12a = t15 - t12
    t13 = t14a - t13a
    t14 = t14a + t13a
    t15a = t15 + t12

    t10a = _r((t13 - t10) * 11585)
    t13a = _r((t13 + t10) * 11585)
    t11 = _r((t12a - t11a) * 11585)
    t12 = _r((t12a + t11a) * 11585)

    return stack([
        t0a + t15a, t1a + t14, t2a + t13a, t3a + t12,
        t4 + t11, t5 + t10a, t6 + t9, t7 + t8a,
        t7 - t8a, t6 - t9, t5 - t10a, t4 - t11,
        t3a - t12, t2a - t13a, t1a - t14, t0a - t15a])


def iadst16_1d(x, stack=np.stack):
    t0 = x[15] * 16364 + x[0] * 804
    t1 = x[15] * 804 - x[0] * 16364
    t2 = x[13] * 15893 + x[2] * 3981
    t3 = x[13] * 3981 - x[2] * 15893
    t4 = x[11] * 14811 + x[4] * 7005
    t5 = x[11] * 7005 - x[4] * 14811
    t6 = x[9] * 13160 + x[6] * 9760
    t7 = x[9] * 9760 - x[6] * 13160
    t8 = x[7] * 11003 + x[8] * 12140
    t9 = x[7] * 12140 - x[8] * 11003
    t10 = x[5] * 8423 + x[10] * 14053
    t11 = x[5] * 14053 - x[10] * 8423
    t12 = x[3] * 5520 + x[12] * 15426
    t13 = x[3] * 15426 - x[12] * 5520
    t14 = x[1] * 2404 + x[14] * 16207
    t15 = x[1] * 16207 - x[14] * 2404

    t0a = _r(t0 + t8)
    t1a = _r(t1 + t9)
    t2a = _r(t2 + t10)
    t3a = _r(t3 + t11)
    t4a = _r(t4 + t12)
    t5a = _r(t5 + t13)
    t6a = _r(t6 + t14)
    t7a = _r(t7 + t15)
    t8a = _r(t0 - t8)
    t9a = _r(t1 - t9)
    t10a = _r(t2 - t10)
    t11a = _r(t3 - t11)
    t12a = _r(t4 - t12)
    t13a = _r(t5 - t13)
    t14a = _r(t6 - t14)
    t15a = _r(t7 - t15)

    t8 = t8a * 16069 + t9a * 3196
    t9 = t8a * 3196 - t9a * 16069
    t10 = t10a * 9102 + t11a * 13623
    t11 = t10a * 13623 - t11a * 9102
    t12 = t13a * 16069 - t12a * 3196
    t13 = t13a * 3196 + t12a * 16069
    t14 = t15a * 9102 - t14a * 13623
    t15 = t15a * 13623 + t14a * 9102

    t0 = t0a + t4a
    t1 = t1a + t5a
    t2 = t2a + t6a
    t3 = t3a + t7a
    t4 = t0a - t4a
    t5 = t1a - t5a
    t6 = t2a - t6a
    t7 = t3a - t7a
    t8a = _r(t8 + t12)
    t9a = _r(t9 + t13)
    t10a = _r(t10 + t14)
    t11a = _r(t11 + t15)
    t12a = _r(t8 - t12)
    t13a = _r(t9 - t13)
    t14a = _r(t10 - t14)
    t15a = _r(t11 - t15)

    t4a = t4 * 15137 + t5 * 6270
    t5a = t4 * 6270 - t5 * 15137
    t6a = t7 * 15137 - t6 * 6270
    t7a = t7 * 6270 + t6 * 15137
    t12 = t12a * 15137 + t13a * 6270
    t13 = t12a * 6270 - t13a * 15137
    t14 = t15a * 15137 - t14a * 6270
    t15 = t15a * 6270 + t14a * 15137

    o = [None] * 16
    o[0] = t0 + t2
    o[15] = -(t1 + t3)
    t2a = t0 - t2
    t3a = t1 - t3
    o[3] = -_r(t4a + t6a)
    o[12] = _r(t5a + t7a)
    t6 = _r(t4a - t6a)
    t7 = _r(t5a - t7a)
    o[1] = -(t8a + t10a)
    o[14] = t9a + t11a
    t10 = t8a - t10a
    t11 = t9a - t11a
    o[2] = _r(t12 + t14)
    o[13] = -_r(t13 + t15)
    t14a = _r(t12 - t14)
    t15a = _r(t13 - t15)

    o[7] = _r(-(t2a + t3a) * 11585)
    o[8] = _r((t2a - t3a) * 11585)
    o[4] = _r((t7 + t6) * 11585)
    o[11] = _r((t7 - t6) * 11585)
    o[6] = _r((t11 + t10) * 11585)
    o[9] = _r((t11 - t10) * 11585)
    o[5] = _r(-(t14a + t15a) * 11585)
    o[10] = _r((t14a - t15a) * 11585)
    return stack(o)


def idct32_1d(x, stack=np.stack):
    t0a = _r((x[0] + x[16]) * 11585)
    t1a = _r((x[0] - x[16]) * 11585)
    t2a = _r(x[8] * 6270 - x[24] * 15137)
    t3a = _r(x[8] * 15137 + x[24] * 6270)
    t4a = _r(x[4] * 3196 - x[28] * 16069)
    t7a = _r(x[4] * 16069 + x[28] * 3196)
    t5a = _r(x[20] * 13623 - x[12] * 9102)
    t6a = _r(x[20] * 9102 + x[12] * 13623)
    t8a = _r(x[2] * 1606 - x[30] * 16305)
    t15a = _r(x[2] * 16305 + x[30] * 1606)
    t9a = _r(x[18] * 12665 - x[14] * 10394)
    t14a = _r(x[18] * 10394 + x[14] * 12665)
    t10a = _r(x[10] * 7723 - x[22] * 14449)
    t13a = _r(x[10] * 14449 + x[22] * 7723)
    t11a = _r(x[26] * 15679 - x[6] * 4756)
    t12a = _r(x[26] * 4756 + x[6] * 15679)
    t16a = _r(x[1] * 804 - x[31] * 16364)
    t31a = _r(x[1] * 16364 + x[31] * 804)
    t17a = _r(x[17] * 12140 - x[15] * 11003)
    t30a = _r(x[17] * 11003 + x[15] * 12140)
    t18a = _r(x[9] * 7005 - x[23] * 14811)
    t29a = _r(x[9] * 14811 + x[23] * 7005)
    t19a = _r(x[25] * 15426 - x[7] * 5520)
    t28a = _r(x[25] * 5520 + x[7] * 15426)
    t20a = _r(x[5] * 3981 - x[27] * 15893)
    t27a = _r(x[5] * 15893 + x[27] * 3981)
    t21a = _r(x[21] * 14053 - x[11] * 8423)
    t26a = _r(x[21] * 8423 + x[11] * 14053)
    t22a = _r(x[13] * 9760 - x[19] * 13160)
    t25a = _r(x[13] * 13160 + x[19] * 9760)
    t23a = _r(x[29] * 16207 - x[3] * 2404)
    t24a = _r(x[29] * 2404 + x[3] * 16207)

    t0 = t0a + t3a
    t1 = t1a + t2a
    t2 = t1a - t2a
    t3 = t0a - t3a
    t4 = t4a + t5a
    t5 = t4a - t5a
    t6 = t7a - t6a
    t7 = t7a + t6a
    t8 = t8a + t9a
    t9 = t8a - t9a
    t10 = t11a - t10a
    t11 = t11a + t10a
    t12 = t12a + t13a
    t13 = t12a - t13a
    t14 = t15a - t14a
    t15 = t15a + t14a
    t16 = t16a + t17a
    t17 = t16a - t17a
    t18 = t19a - t18a
    t19 = t19a + t18a
    t20 = t20a + t21a
    t21 = t20a - t21a
    t22 = t23a - t22a
    t23 = t23a + t22a
    t24 = t24a + t25a
    t25 = t24a - t25a
    t26 = t27a - t26a
    t27 = t27a + t26a
    t28 = t28a + t29a
    t29 = t28a - t29a
    t30 = t31a - t30a
    t31 = t31a + t30a

    t5a = _r((t6 - t5) * 11585)
    t6a = _r((t6 + t5) * 11585)
    t9a = _r(t14 * 6270 - t9 * 15137)
    t14a = _r(t14 * 15137 + t9 * 6270)
    t10a = _r(-(t13 * 15137 + t10 * 6270))
    t13a = _r(t13 * 6270 - t10 * 15137)
    t17a = _r(t30 * 3196 - t17 * 16069)
    t30a = _r(t30 * 16069 + t17 * 3196)
    t18a = _r(-(t29 * 16069 + t18 * 3196))
    t29a = _r(t29 * 3196 - t18 * 16069)
    t21a = _r(t26 * 13623 - t21 * 9102)
    t26a = _r(t26 * 9102 + t21 * 13623)
    t22a = _r(-(t25 * 9102 + t22 * 13623))
    t25a = _r(t25 * 13623 - t22 * 9102)

    t0a = t0 + t7
    t1a = t1 + t6a
    t2a = t2 + t5a
    t3a = t3 + t4
    t4a = t3 - t4
    t5 = t2 - t5a
    t6 = t1 - t6a
    t7a = t0 - t7
    t8a = t8 + t11
    t9 = t9a + t10a
    t10 = t9a - t10a
    t11a = t8 - t11
    t12a = t15 - t12
    t13 = t14a - t13a
    t14 = t14a + t13a
    t15a = t15 + t12
    t16a = t16 + t19
    t17 = t17a + t18a
    t18 = t17a - t18a
    t19a = t16 - t19
    t20a = t23 - t20
    t21 = t22a - t21a
    t22 = t22a + t21a
    t23a = t23 + t20
    t24a = t24 + t27
    t25 = t25a + t26a
    t26 = t25a - t26a
    t27a = t24 - t27
    t28a = t31 - t28
    t29 = t30a - t29a
    t30 = t30a + t29a
    t31a = t31 + t28

    t10a = _r((t13 - t10) * 11585)
    t13a = _r((t13 + t10) * 11585)
    t11 = _r((t12a - t11a) * 11585)
    t12 = _r((t12a + t11a) * 11585)
    t18a = _r(t29 * 6270 - t18 * 15137)
    t29a = _r(t29 * 15137 + t18 * 6270)
    t19 = _r(t28a * 6270 - t19a * 15137)
    t28 = _r(t28a * 15137 + t19a * 6270)
    t20 = _r(-(t27a * 15137 + t20a * 6270))
    t27 = _r(t27a * 6270 - t20a * 15137)
    t21a = _r(-(t26 * 15137 + t21 * 6270))
    t26a = _r(t26 * 6270 - t21 * 15137)

    t0 = t0a + t15a
    t1 = t1a + t14
    t2 = t2a + t13a
    t3 = t3a + t12
    t4 = t4a + t11
    t5a = t5 + t10a
    t6a = t6 + t9
    t7 = t7a + t8a
    t8 = t7a - t8a
    t9a = t6 - t9
    t10 = t5 - t10a
    t11a = t4a - t11
    t12a = t3a - t12
    t13 = t2a - t13a
    t14a = t1a - t14
    t15 = t0a - t15a
    t16 = t16a + t23a
    t17a = t17 + t22
    t18 = t18a + t21a
    t19a = t19 + t20
    t20a = t19 - t20
    t21 = t18a - t21a
    t22a = t17 - t22
    t23 = t16a - t23a
    t24 = t31a - t24a
    t25a = t30 - t25
    t26 = t29a - t26a
    t27a = t28 - t27
    t28a = t28 + t27
    t29 = t29a + t26a
    t30a = t30 + t25
    t31 = t31a + t24a

    t20 = _r((t27a - t20a) * 11585)
    t27 = _r((t27a + t20a) * 11585)
    t21a = _r((t26 - t21) * 11585)
    t26a = _r((t26 + t21) * 11585)
    t22 = _r((t25a - t22a) * 11585)
    t25 = _r((t25a + t22a) * 11585)
    t23a = _r((t24 - t23) * 11585)
    t24a = _r((t24 + t23) * 11585)

    return stack([
        t0 + t31, t1 + t30a, t2 + t29, t3 + t28a,
        t4 + t27, t5a + t26a, t6a + t25, t7 + t24a,
        t8 + t23a, t9a + t22, t10 + t21a, t11a + t20,
        t12a + t19a, t13 + t18, t14a + t17a, t15 + t16,
        t15 - t16, t14a - t17a, t13 - t18, t12a - t19a,
        t11a - t20, t10 - t21a, t9a - t22, t8 - t23a,
        t7 - t24a, t6a - t25, t5a - t26a, t4 - t27,
        t3 - t28a, t2 - t29, t1 - t30a, t0 - t31])


_KERNELS = {
    (4, "dct"): idct4_1d, (4, "adst"): iadst4_1d,
    (8, "dct"): idct8_1d, (8, "adst"): iadst8_1d,
    (16, "dct"): idct16_1d, (16, "adst"): iadst16_1d,
    (32, "dct"): idct32_1d,
}
_BITS = {4: 4, 8: 5, 16: 6, 32: 6}
# TxfmType -> (pass1/vertical kernel, pass2/horizontal kernel)
_TXTP = {DCT_DCT: ("dct", "dct"), DCT_ADST: ("adst", "dct"),
         ADST_DCT: ("dct", "adst"), ADST_ADST: ("adst", "adst")}


def itxfm_add(dst, block, txtp, eob):
    """Add the inverse transform of `block` ((n, n) int, raster) into
    dst ((n, n) uint8 view), mirroring itxfm_wrapper exactly."""
    n = block.shape[0]
    bits = _BITS[n]
    if txtp == DCT_DCT and eob == 1:
        t = (((int(block[0, 0]) * 11585 + 8192) >> 14) * 11585
             + 8192) >> 14
        t = (t + (1 << (bits - 1))) >> bits
        np.clip(dst.astype(np.int32) + t, 0, 255, out=dst,
                casting="unsafe")
        return
    ka, kb = _TXTP[txtp]
    a = _KERNELS[(n, ka)](block.astype(np.int64))   # columns
    a = ((a + 0x8000) & 0xFFFF) - 0x8000            # int16 tmp[] store
    res = _KERNELS[(n, kb)](a.T)                    # rows of a
    res = ((res + 0x8000) & 0xFFFF) - 0x8000        # int16 out[] store
    res = (res + (1 << (bits - 1))) >> bits
    np.clip(dst.astype(np.int64) + res, 0, 255, out=dst,
            casting="unsafe")
