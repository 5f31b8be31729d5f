"""MJPEG / baseline JPEG decoder (reference: libavcodec/mjpegdec.c).

Counterpart of ffmpeg_tpu/codecs/mjpeg.py: the header parse
(`_parse_until_scan`) and `MjpegDecoder`.  The host parses the markers
and entropy-decodes the scan into dense coefficient arrays with the
port's own C++ (`mjpeg_decode_scan`, built by `native.py`); the device
runs one fused dequant → dezigzag → 8x8 IDCT → level shift → clamp →
tile reassembly per plane (`ops/idct.py:jpeg_block_transform`).  Output
is full-range YUV (yuvj semantics), planes as tensors on the decoder's
device.

Left out: the reference's pure-Python scan decoder, which it falls back
to when its native library is missing (:341-346).  The port's
`native.get()` builds the library or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..core.frame import Frame
from ..core.packet import Packet
from ..io.stream import MediaType
from ..ops.idct import jpeg_block_transform
from ..utils.error import InvalidData, NotSupported
from .codec import Codec, register_decoder

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


def _pix_fmt_for(st: _JpegState) -> str:
    nc = len(st.components)
    if nc == 1:
        return "gray"
    if nc not in (3, 4):
        raise NotSupported(f"mjpeg: {nc} components")
    hmax = max(c.h for c in st.components)
    vmax = max(c.v for c in st.components)
    c1 = st.components[1]
    key = (hmax // max(1, c1.h), vmax // max(1, c1.v))
    fmt = {(2, 2): "yuv420p", (2, 1): "yuv422p", (1, 1): "yuv444p",
           (4, 1): "yuv411p", (1, 2): "yuv440p"}.get(key)
    if fmt is None:
        raise NotSupported(f"mjpeg: sampling {key}")
    return fmt


@dataclass
class ScanCoefficients:
    """What the host stage hands the device stage for one picture: the
    parsed headers and each component's (blocks_h, blocks_w, ncoeff)
    int16 zigzag coefficients, the first `ncoeff` of every block."""
    st: _JpegState
    coeffs: List[np.ndarray]


def scan_decode(data: bytes, ncoeff: int = 64) -> ScanCoefficients:
    """The decoder's host stage: parse the headers and entropy-decode the
    scan with the port's C++ (`mjpeg_decode_scan`, built by `native.py`),
    keeping the first `ncoeff` zigzag coefficients of every block."""
    st = _JpegState()
    scan_off, _ = _parse_until_scan(data, st)
    if st.progressive:
        raise NotSupported("mjpeg: progressive JPEG not yet supported")
    if st.bits != 8:
        raise NotSupported(f"mjpeg: {st.bits}-bit")
    if not st.components or not st.width:
        raise InvalidData("mjpeg: no SOF before SOS")
    hmax = max(c.h for c in st.components)
    vmax = max(c.v for c in st.components)
    mcus_x = -(-st.width // (8 * hmax))
    mcus_y = -(-st.height // (8 * vmax))
    specs, outs = [], []
    for comp in st.components:
        bw = mcus_x * comp.h
        specs.append((comp.dc_tab, comp.ac_tab, comp.h, comp.v, bw))
        outs.append(np.zeros((mcus_y * comp.v, bw, ncoeff), np.int16))
    scan = data[scan_off:]
    spec_arr = (ctypes.c_int * (5 * len(specs)))(
        *[v for s in specs for v in s])
    out_ptrs = (ctypes.POINTER(ctypes.c_int16) * len(outs))(
        *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)) for o in outs])
    ret = native.get().mjpeg_decode_scan(
        scan, len(scan),
        st.dc_counts.tobytes(), st.dc_values.tobytes(),
        st.ac_counts.tobytes(), st.ac_values.tobytes(),
        spec_arr, len(specs), mcus_x, mcus_y, st.restart_interval,
        ncoeff, out_ptrs)
    if ret != 0:
        raise InvalidData(f"mjpeg: scan decode failed ({ret})")
    return ScanCoefficients(st, outs)


@register_decoder
class MjpegDecoder(Codec):
    codec_id = "mjpeg"
    codec_type = MediaType.VIDEO
    aliases = ("jpeg", "jpegls_off")

    def __init__(self, par, options: Optional[dict] = None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        self._qtabs: Dict[bytes, torch.Tensor] = {}

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        sc = scan_decode(pkt.data)
        st = sc.st
        f = Frame.video(st.width, st.height, _pix_fmt_for(st),
                        planes=self.reconstruct(sc), pts=pkt.pts,
                        duration=pkt.duration, time_base=pkt.time_base)
        f.color_range = "pc"
        f.color_space = "bt470bg"
        f.chroma_location = "center"
        return [f]

    def reconstruct(self, sc: ScanCoefficients) -> List[torch.Tensor]:
        """Device stage: each component's coefficients copied to the
        device and transformed there into its plane."""
        st = sc.st
        if any(c.q_idx not in st.qtabs for c in st.components):
            raise InvalidData("mjpeg: missing quantisation table")
        hmax = max(c.h for c in st.components)
        vmax = max(c.v for c in st.components)
        planes = []
        for comp, coeffs in zip(st.components, sc.coeffs):
            cw = -(-st.width * comp.h // hmax)
            ch = -(-st.height * comp.v // vmax)
            planes.append(jpeg_block_transform(
                torch.from_numpy(coeffs).to(self.device),
                self._qtab(st.qtabs[comp.q_idx]), ch, cw))
        return planes

    def _qtab(self, q: np.ndarray) -> torch.Tensor:
        """A quantisation table on the device, copied there once per
        distinct table."""
        key = q.astype(np.int32).tobytes()
        t = self._qtabs.get(key)
        if t is None:
            if len(self._qtabs) > 64:
                self._qtabs.clear()
            t = self._qtabs[key] = torch.as_tensor(
                q.astype(np.int32), device=self.device)
        return t
