"""The flagship fixture and the host oracle that the port's checks share.

`chip_smoke.py` (on the card) and `tests/test_torch_*.py` (on the CPU)
both check the port on the committed 8-frame 1920x1080 MJPEG clip
against the JAX reference's committed output on it; the constants, the
packed cap and the C++ host decoder's coefficients live here so that
each check reads them from the package and not from the other.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ffmpeg_tpu import native

from .codecs.mjpeg import _JpegState, _parse_until_scan

DATA = Path(__file__).resolve().parent.parent / "tests" / "data" / "port"
FIXTURE = DATA / "flagship_1080p_8.mjpeg"
GOLDEN = DATA / "flagship_1080p_8_golden.npz"
W, H, OUT, BATCH, STRIDE = 1920, 1080, 224, 8, 192


def packed_cap(pkts) -> int:
    """The tight cap bench.py uses: largest scan in the clip + header."""
    max_scan = max(len(p) - _parse_until_scan(p, _JpegState())[0]
                   for p in pkts)
    return 2 * (-(-W // 16)) * (-(-H // 16)) + 512 * 12 + max_scan \
        + STRIDE + 128


def host_decode(pkt: bytes) -> np.ndarray:
    """Coefficients of one 4:2:0 frame with one MCU per restart interval
    from the C++ host decoder, in K1's (nmcu, 6, 64) int16 lane layout."""
    st = _JpegState()
    off, _ = _parse_until_scan(pkt, st)
    mcus_x, mcus_y = -(-st.width // 16), -(-st.height // 16)
    lx, ly = 2 * mcus_x, 2 * mcus_y
    planes = [np.zeros((ly, lx, 64), np.int16),
              np.zeros((mcus_y, mcus_x, 64), np.int16),
              np.zeros((mcus_y, mcus_x, 64), np.int16)]
    specs = [v for c in st.components
             for v in (c.dc_tab, c.ac_tab, c.h, c.v, lx if c.h == 2 else
                       mcus_x)]
    ptrs = (ctypes.POINTER(ctypes.c_int16) * 3)(
        *[p.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)) for p in planes])
    scan = pkt[off:]
    r = native.get().mjpeg_decode_scan(
        scan, len(scan), st.dc_counts.tobytes(), st.dc_values.tobytes(),
        st.ac_counts.tobytes(), st.ac_values.tobytes(),
        (ctypes.c_int * len(specs))(*specs), len(st.components),
        mcus_x, mcus_y, st.restart_interval, 64, ptrs)
    if r != 0:
        raise RuntimeError(f"host decoder failed: {r}")
    y = planes[0].reshape(mcus_y, 2, mcus_x, 2, 64).transpose(0, 2, 1, 3, 4)
    return np.concatenate([y.reshape(-1, 4, 64),
                           planes[1].reshape(-1, 1, 64),
                           planes[2].reshape(-1, 1, 64)], axis=1)
