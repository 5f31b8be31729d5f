"""Baseline JPEG header parse (reference: libavcodec/mjpegdec.c).

Counterpart of the header half of ffmpeg_tpu/codecs/mjpeg.py (`_Component`,
`_JpegState`, `_parse_until_scan`).  The host scan decode is the port's
own C++ copy (`ffmpeg_tpu_torch/native.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..utils.error import InvalidData

# markers
SOI, EOI, SOS, DQT, DHT, DRI = 0xD8, 0xD9, 0xDA, 0xDB, 0xC4, 0xDD
SOF0, SOF1, SOF2 = 0xC0, 0xC1, 0xC2


@dataclass
class _Component:
    cid: int
    h: int
    v: int
    q_idx: int
    dc_tab: int = 0
    ac_tab: int = 0


class _JpegState:
    def __init__(self):
        self.qtabs: Dict[int, np.ndarray] = {}
        self.dc_counts = np.zeros((4, 16), np.uint8)
        self.dc_values = np.zeros((4, 256), np.uint8)
        self.ac_counts = np.zeros((4, 16), np.uint8)
        self.ac_values = np.zeros((4, 256), np.uint8)
        self.width = 0
        self.height = 0
        self.bits = 8
        self.components: List[_Component] = []
        self.restart_interval = 0
        self.progressive = False


def _parse_until_scan(data: bytes, st: _JpegState) -> Tuple[int, bytes]:
    """Parse markers up to and including SOS; return (scan_data_offset, sos)."""
    n = len(data)
    if n < 2 or data[0] != 0xFF or data[1] != SOI:
        raise InvalidData("mjpeg: no SOI")
    i = 2
    while i + 4 <= n:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        i += 2
        if marker in (SOI, EOI) or 0xD0 <= marker <= 0xD7:
            continue
        if i + 2 > n:
            break
        seglen = data[i] << 8 | data[i + 1]
        seg = data[i + 2:i + seglen]
        if marker == DQT:
            j = 0
            while j < len(seg):
                pq = seg[j] >> 4
                tq = seg[j] & 15
                j += 1
                if pq:
                    q = np.frombuffer(seg[j:j + 128], ">u2").astype(np.int32)
                    j += 128
                else:
                    q = np.frombuffer(seg[j:j + 64], np.uint8).astype(np.int32)
                    j += 64
                st.qtabs[tq] = q
        elif marker == DHT:
            j = 0
            while j < len(seg):
                tc = seg[j] >> 4   # 0=DC 1=AC
                th = seg[j] & 15
                j += 1
                counts = np.frombuffer(seg[j:j + 16], np.uint8)
                j += 16
                total = int(counts.sum())
                values = np.frombuffer(seg[j:j + total], np.uint8)
                j += total
                if tc == 0:
                    st.dc_counts[th] = counts
                    st.dc_values[th, :total] = values
                else:
                    st.ac_counts[th] = counts
                    st.ac_values[th, :total] = values
        elif marker in (SOF0, SOF1, SOF2):
            st.progressive = marker == SOF2
            st.bits = seg[0]
            st.height = seg[1] << 8 | seg[2]
            st.width = seg[3] << 8 | seg[4]
            nc = seg[5]
            st.components = []
            for c in range(nc):
                cid = seg[6 + c * 3]
                hv = seg[7 + c * 3]
                st.components.append(_Component(
                    cid=cid, h=hv >> 4, v=hv & 15, q_idx=seg[8 + c * 3]))
        elif marker == DRI:
            st.restart_interval = seg[0] << 8 | seg[1]
        elif marker == SOS:
            ns = seg[0]
            for c in range(ns):
                cid = seg[1 + c * 2]
                tabs = seg[2 + c * 2]
                for comp in st.components:
                    if comp.cid == cid:
                        comp.dc_tab = tabs >> 4
                        comp.ac_tab = tabs & 15
            return i + seglen, seg
        i += seglen
    raise InvalidData("mjpeg: no SOS marker")
