"""CAVLC residual decoding (ITU-T H.264 §9.2; reference:
libavcodec/h264_cavlc.c decode_residual). LUT-based VLCs built from the
machine-extracted code tables.

The port's copy of ffmpeg_tpu/codecs/h264/cavlc.py, held equal to it by
tests/test_torch_h264_host.py."""

from __future__ import annotations

import numpy as np

from ...utils.error import InvalidData
from . import tables as T


def _build_lut(lens, codes, nsym):
    maxlen = max(l for l in lens if l) if any(lens) else 1
    size = 1 << maxlen
    sym_t = np.full(size, -1, np.int32)
    len_t = np.zeros(size, np.int8)
    for sym in range(nsym):
        l = lens[sym]
        if l == 0:
            continue
        base = codes[sym] << (maxlen - l)
        n = 1 << (maxlen - l)
        sym_t[base:base + n] = sym
        len_t[base:base + n] = l
    return maxlen, sym_t, len_t


_COEFF_TOKEN = [_build_lut(T.COEFF_TOKEN_LEN[i], T.COEFF_TOKEN_BITS[i],
                           68) for i in range(4)]
_CHROMA_DC_COEFF_TOKEN = _build_lut(T.CHROMA_DC_COEFF_TOKEN_LEN,
                                    T.CHROMA_DC_COEFF_TOKEN_BITS, 20)
_TOTAL_ZEROS = [_build_lut(T.TOTAL_ZEROS_LEN[i], T.TOTAL_ZEROS_BITS[i],
                           len(T.TOTAL_ZEROS_LEN[i])) for i in range(15)]
_CHROMA_DC_TZ = [_build_lut(T.CHROMA_DC_TOTAL_ZEROS_LEN[i],
                            T.CHROMA_DC_TOTAL_ZEROS_BITS[i], 4)
                 for i in range(3)]
_RUN = [_build_lut(T.RUN_LEN[i], T.RUN_BITS[i], len(T.RUN_LEN[i]))
        for i in range(7)]

# nC → which of the 4 coeff_token tables (h264_cavlc.c table index)
_CT_INDEX = [0, 0, 1, 1, 2, 2, 2, 2] + [3] * 9


def _read_vlc(bits, lut):
    maxlen, sym_t, len_t = lut
    pf = bits.peek(maxlen)
    sym = int(sym_t[pf])
    if sym < 0:
        raise InvalidData("h264: bad vlc code")
    bits.pos += int(len_t[pf])
    return sym


def decode_residual(bits, n_coeffs: int, nc: int):
    """→ int array of n_coeffs coefficient levels in scan order
    (lowest-frequency first), plus total_coeff."""
    out = [0] * n_coeffs
    if nc == -1:
        sym = _read_vlc(bits, _CHROMA_DC_COEFF_TOKEN)
    else:
        sym = _read_vlc(bits, _COEFF_TOKEN[_CT_INDEX[min(nc, 16)]])
    total = sym >> 2
    trailing = sym & 3
    if total == 0:
        return out, 0
    if total > n_coeffs:
        raise InvalidData("h264: total_coeff too large")

    levels = []
    for _ in range(trailing):
        levels.append(-1 if bits.get1() else 1)

    suffix_length = 1 if (total > 10 and trailing < 3) else 0
    for i in range(trailing, total):
        prefix = 0
        while bits.get1() == 0:
            prefix += 1
            if prefix > 32:
                raise InvalidData("h264: bad level prefix")
        if prefix >= 15:
            # escape: 12-bit (or longer) suffix (spec 9.2.2.1)
            sz = prefix - 3
            level_code = (15 << suffix_length) + bits.get(sz)
            if suffix_length == 0:
                level_code += 15
            if prefix >= 16:
                level_code += (1 << sz) - 4096
        else:
            sz = suffix_length
            if prefix == 14 and suffix_length == 0:
                sz = 4
            level_code = (prefix << suffix_length) + \
                (bits.get(sz) if sz else 0)
        if i == trailing and trailing < 3:
            level_code += 2
        level = (level_code + 2) >> 1 if (level_code & 1) == 0 \
            else -((level_code + 1) >> 1)
        levels.append(level)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    if total < n_coeffs:
        if nc == -1:
            tz = _read_vlc(bits, _CHROMA_DC_TZ[total - 1])
        else:
            tz = _read_vlc(bits, _TOTAL_ZEROS[total - 1])
    else:
        tz = 0

    # place coefficients from the highest frequency down
    pos = total + tz - 1
    zeros_left = tz
    for i in range(total):
        if pos >= n_coeffs:
            raise InvalidData("h264: coeff position overflow")
        out[pos] = levels[i]
        if i < total - 1:
            if zeros_left > 0:
                # the zerosLeft>6 table (index 6) covers runs 0..14 directly
                run = _read_vlc(bits, _RUN[min(zeros_left - 1, 6)])
                zeros_left -= run
                pos -= run + 1
            else:
                pos -= 1
    return out, total
