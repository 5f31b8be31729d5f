"""1080p-class MJPEG decode with the entropy stage on the GPU.

Counterpart of ffmpeg_tpu/models/mjpeg_tpu_entropy.py.  The host's only
per-frame work is the header parse and destuffing the scan and splitting
it at restart markers (mjpeg_split_segments of the port's host C++,
csrc/host/, loaded by native.py), which reads the scan in place inside
the frame's bytes: the scan is not copied on the way in.  The packed
segment bytes go to the card, where K1
(ops/huffman.py jpeg_scan_decode_packed, csrc/jpeg_huffman.cu) decodes
all segments in parallel and two full-float32 contractions per plane do
dequant + IDCT + chroma upsample + resize, followed by the colour matrix
and the pack.

Two wire formats.  The flagship's (v2, byte-identical to the
reference's, so one region feeds both packages), for 4:2:0 streams with a
restart marker after every MCU and Huffman codes of at most 9 bits, which
the reference's encoder emits with huffman=optimal + restart_interval=1:

    region[0 : 2*nmcu]              u16le per-segment byte lengths
    region[2*nmcu : 2*nmcu+6144]    (512,12) int8 Huffman LUT
                                    (build_jpeg_luts9 — DHTs may vary
                                    per frame with huffman=optimal)
    region[hdr : ]                  destuffed segments, tightly packed

and the camera format, for every other stream the port takes: 4:2:0 or
4:2:2 (Y 2x1, as RFC 2435 types 0/64 and UVC cameras send it), a restart
interval of one MCU or of whole MCU rows, any baseline Huffman table
(the Annex K tables that RTP/JPEG receivers write have codes of up to 16
bits):

    region[0 : 4*nseg]              u32le per-segment byte lengths
    region[tab : tab+5376]          build_jpeg_tables16's two-level tables
                                    (tab = 4*nseg rounded up to 16)
    region[hdr : ]                  destuffed segments, tightly packed

The pipeline takes the format, the sampling and the restart interval
from the first packet's SOF, DRI and tables (a private `_Stream` record;
the spec stays the reference's).  A stream with no restart markers
(nothing to decode in parallel), with a restart interval that is neither
1 nor whole MCU rows, or with another sampling raises ValueError; the
host decoder (codecs/mjpeg.py) and ops/huffman.jpeg_scan_decode take
those.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import native, trace
from ..codecs.mjpeg import _JpegState, _parse_until_scan
from ..ops.huffman import (TABLE16_BYTES, build_jpeg_luts9,
                           build_jpeg_tables16, jpeg_scan_decode_packed)
from ..ops.idct import ZIGZAG, _dct8_matrix
from ..scale import ops as sops
from ..scale import swscale

_LUT_BYTES = 512 * 12


@dataclass(frozen=True)
class TpuEntropySpec:
    """The reference's spec, field for field.  Two fields are read by
    nothing here: `long_frac`, which the reference never reads either,
    and `lut_bits`, which picks the TPU kernel's 256-row half table (a
    VMEM saving); K1 always reads the 512-row table, which decodes
    <= 8-bit streams too, and the first packet's tables pick the region
    format (`_Stream`)."""
    width: int
    height: int
    out_w: int
    out_h: int
    batch: int = 8
    stride: int = 192            # max segment bytes + 5 that prep accepts
    long_frac: int = 16          # unread (see above)
    out_fmt: str = "rgb24"
    filter: str = "bicubic"
    packed_cap: int = 0          # bytes per frame region; 0 = auto from
                                 # the first packet (x1.3 + slack)
    lut_bits: int = 9            # max Huffman code length; unread

    @property
    def mcus(self):
        return -(-self.width // 16), -(-self.height // 16)


_SAMPLING = {((2, 2), (1, 1), (1, 1)): "yuv420p",
             ((2, 1), (1, 1), (1, 1)): "yuv422p"}


@dataclass(frozen=True)
class _Stream:
    """What a stream's first packet fixes of the program beside the spec:
    its sampling, its restart interval (MCUs a segment) and its longest
    Huffman code.  The flagship's stream is the default."""
    width: int
    height: int
    sampling: str = "yuv420p"
    restart_interval: int = 1
    longest: int = 9

    @classmethod
    def of(cls, spec: TpuEntropySpec, st) -> "_Stream":
        """The stream of a parsed first frame `st`; ValueError for one
        that the device path does not decode or that `spec` does not
        describe."""
        key = tuple((c.h, c.v) for c in st.components)
        sampling = _SAMPLING.get(key)
        if st.progressive or st.bits != 8 or sampling is None:
            kind = "progressive" if st.progressive else f"{st.bits}-bit"
            raise ValueError(f"mjpeg_tpu_entropy: {kind}, sampling {key}: "
                             f"only baseline 8-bit 4:2:0 (Y 2x2) and 4:2:2 "
                             f"(Y 2x1)")
        c1, c2 = st.components[1:]
        if (c1.q_idx, c1.dc_tab, c1.ac_tab) != (c2.q_idx, c2.dc_tab,
                                                c2.ac_tab):
            raise ValueError("mjpeg_tpu_entropy: Cb and Cr with different "
                             "tables")
        if (spec.width, spec.height) != (st.width, st.height):
            raise ValueError(f"mjpeg_tpu_entropy: stream {st.width}x"
                             f"{st.height}, spec {spec.width}x{spec.height}")
        ri = st.restart_interval
        if ri == 0:
            raise ValueError("mjpeg_tpu_entropy: no restart markers, so no "
                             "segments to decode in parallel (decode on the "
                             "host, or with ops/huffman.jpeg_scan_decode)")
        stream = cls(st.width, st.height, sampling, ri, _longest_code(st))
        if ri != 1 and ri % stream.mcus[0]:
            raise ValueError(f"mjpeg_tpu_entropy: restart interval {ri} is "
                             f"neither 1 nor whole rows of "
                             f"{stream.mcus[0]} MCUs")
        return stream

    @property
    def mcus(self):
        mcu_h = 8 if self.sampling == "yuv422p" else 16
        return -(-self.width // 16), -(-self.height // mcu_h)

    @property
    def bpm(self) -> int:
        """Blocks an MCU: Y0 Y1 Cb Cr (4:2:2) or Y0-Y3 Cb Cr (4:2:0)."""
        return 4 if self.sampling == "yuv422p" else 6

    @property
    def two_level(self) -> bool:
        """The camera format: anything but 4:2:0 with one MCU a segment
        and codes of at most 9 bits."""
        return self.bpm != 6 or self.longest > 9 or self.restart_interval != 1

    def region_header(self):
        """(segments, table offset, hdr) of a frame's region."""
        mx, my = self.mcus
        nseg = -(-mx * my // self.restart_interval)
        if not self.two_level:
            return nseg, 2 * nseg, 2 * nseg + _LUT_BYTES
        tab = -(-4 * nseg // 16) * 16
        return nseg, tab, tab + TABLE16_BYTES


def _luts9(st) -> np.ndarray:
    """The flagship format's table, as the region's bytes."""
    return build_jpeg_luts9(st).view(np.uint8).reshape(-1)


def _stream_key(st) -> tuple:
    """What a frame's headers fix of the program: size, restart interval
    and sampling factors."""
    return (st.width, st.height, st.restart_interval,
            tuple((c.h, c.v) for c in st.components))


def _longest_code(st) -> int:
    """The longest Huffman code of the tables a parsed frame's scan uses."""
    c0, c1 = st.components[:2]
    counts = [st.dc_counts[c0.dc_tab], st.dc_counts[c1.dc_tab],
              st.ac_counts[c0.ac_tab], st.ac_counts[c1.ac_tab]]
    return max((int(np.flatnonzero(c)[-1]) + 1 for c in counts if c.any()),
               default=0)


def _fused_operators(spec: TpuEntropySpec, qy: np.ndarray,
                     qc: np.ndarray, stream: _Stream | None = None):
    """Compose dequant + 8x8 IDCT + chroma upsample + resize into two
    per-axis operator tensors per plane, in numpy float64, as the
    reference does (see its docstring).

    Returns (Ky, Ly, Kc, Lc, tail_ops, (b_offsets, a_scales)) where the
    224-line luma operators fold the MCU's luma block layout (2x2 for
    4:2:0, 1x2 for 4:2:2) so the entropy output (B, my, mx, 4*64 or
    2*64) contracts with no transpose:

        plane224[o, p] = sum_{m,n,z} C[m,n,z] * K[o,m,z] * L[p,n,z]

    The operators pad the last MCU row and column, so a frame height
    that is not a multiple of 16 (1080) needs no special case.  `stream`
    (default: the flagship's) gives the sampling.
    """
    stream = stream or _Stream(spec.width, spec.height)
    OUTW, OUTH = spec.out_w, spec.out_h
    mcus_x, mcus_y = stream.mcus
    oplist = swscale.build_ops(swscale.ScaleSpec(
        src_w=spec.width, src_h=spec.height,
        src_fmt=stream.sampling,
        dst_w=OUTW, dst_h=OUTH, dst_fmt=spec.out_fmt,
        filter=spec.filter, src_range=True, src_chroma_loc="center"))
    if not (isinstance(oplist[0], sops.ToFloat)
            and isinstance(oplist[1], sops.ResizeAxis)
            and oplist[1].axis == -2
            and isinstance(oplist[2], sops.ResizeAxis)
            and oplist[2].axis == -1):
        raise NotImplementedError("fused path needs the standard "
                                  "ToFloat/ResizeV/ResizeH op prefix")
    tofloat, res_v, res_h = oplist[0], oplist[1], oplist[2]
    tail = oplist[3:]
    A = _dct8_matrix()                     # A[u, x]
    uidx, vidx = ZIGZAG // 8, ZIGZAG % 8

    def build_kl(mv, mh, q, rv, rh, outh, outw):
        mvp = np.zeros((outh, rv, 8))
        mvp.reshape(outh, -1)[:, :mv.shape[1]] = mv
        mhp = np.zeros((outw, rh, 8))
        mhp.reshape(outw, -1)[:, :mh.shape[1]] = mh
        av = np.einsum("orx,ux->oru", mvp, A)
        ah = np.einsum("ocx,vx->ocv", mhp, A)
        return av[:, :, uidx] * q[None, None, :], ah[:, :, vidx]

    rows = 2 if stream.bpm == 6 else 1     # luma blocks down an MCU
    avy, ahy = build_kl(res_v.matrices[0], res_h.matrices[0],
                        qy.astype(np.float64), mcus_y * rows, mcus_x * 2,
                        OUTH, OUTW)
    ky = np.zeros((OUTH, mcus_y, 2 * rows, 64))
    ly = np.zeros((OUTW, mcus_x, 2 * rows, 64))
    for k in range(2 * rows):              # fold the MCU's luma blocks
        ky[:, :, k, :] = avy[:, k // 2::rows, :]
        ly[:, :, k, :] = ahy[:, k % 2::2, :]
    kc, lc = build_kl(res_v.matrices[1], res_h.matrices[1],
                      qc.astype(np.float64), mcus_y, mcus_x, OUTH, OUTW)
    return (ky.reshape(OUTH, mcus_y, 128 * rows).astype(np.float32),
            ly.reshape(OUTW, mcus_x, 128 * rows).astype(np.float32),
            kc.astype(np.float32), lc.astype(np.float32),
            tail, (tofloat.offsets, tofloat.scales))


def operators_from_reference(ky, ly, kc, lc, tail, ofs_scl):
    """Carry the reference's `_fused_operators` output (numpy arrays and
    ffmpeg_tpu.scale.ops dataclasses) over to the port: the same arrays,
    and each tail op as the port's op of the same name and fields.
    Reads the reference's objects and imports nothing of its package."""
    def port_op(op):
        name = type(op).__name__
        if name == "_FloatOut":
            return swscale._FloatOut()
        cls = getattr(sops, name, None)
        if cls is None or not dataclasses.is_dataclass(op):
            raise TypeError(f"no port of scale op {name}")
        return cls(**{f.name: getattr(op, f.name)
                      for f in dataclasses.fields(op)})

    b_ofs, a_scl = ofs_scl
    return (np.asarray(ky), np.asarray(ly), np.asarray(kc), np.asarray(lc),
            [port_op(op) for op in tail], (tuple(b_ofs), tuple(a_scl)))


def _p224(coef: torch.Tensor, k: torch.Tensor, l: torch.Tensor):
    # n-first: the (b,m,p,z) intermediate is 3.6x smaller than the
    # (b,o,n,z) one and step 2 contracts the large (m,z)
    t = torch.einsum("bmnz,pnz->bmpz", coef, l)
    return torch.einsum("bmpz,omz->bop", t, k) + 128.0


class MjpegEntropyProgram(nn.Module):
    """The device stage: (B, cap) uint8 packed regions → the out_fmt
    components, each (B, out_h, out_w).  Counterpart of the reference's
    `_build_program(...).run`; the fused operators are buffers.

    Not ported, because they exist only for the TPU or its link:
    - the 64-byte window row gather (reference :153-171), a workaround for
      slow element gathers on the TPU: K1 reads each segment straight
      from its region at the segment's start;
    - the `on_tpu` branch (:143, :174): the device of `regions` picks the
      path inside K1's entry point, kernel on CUDA, plain on the CPU;
    - the `lut_bits=8` half table (:181), see TpuEntropySpec.
    """

    def __init__(self, spec: TpuEntropySpec, cap: int, operators,
                 device: torch.device | str = "cuda",
                 stream: _Stream | None = None):
        super().__init__()
        stream = stream or _Stream(spec.width, spec.height)
        ky, ly, kc, lc, tail, (b_ofs, a_scl) = operators
        self.mcus_x, self.mcus_y = stream.mcus
        self.nmcu = self.mcus_x * self.mcus_y
        self.two_level = stream.two_level
        self.mcus_per_seg = stream.restart_interval
        self.bpm = stream.bpm
        self.nseg, self.tab, self.hdr = stream.region_header()
        self.cap = cap
        for name, arr in (("ky", ky), ("ly", ly), ("kc", kc), ("lc", lc)):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(arr, np.float32), device=device))
        self.tail = tuple(tail)
        self.b_ofs = tuple(float(b) for b in b_ofs)
        self.a_scl = tuple(float(a) for a in a_scl)

    def split_regions(self, regions: torch.Tensor):
        """(lens (B, nseg) int32, luts): the headers of the packed
        regions, K1's inputs beside the regions themselves; luts are
        (B, 512, 12) int8 in the flagship's format, (B, 5376) uint8 views
        of the regions in the camera format."""
        if regions.dtype != torch.uint8 or regions.dim() != 2 \
                or regions.shape[1] != self.cap:
            raise ValueError(f"regions must be (B, {self.cap}) uint8")
        if self.two_level:     # u32le lengths: a view (cap is on 128 B)
            return (regions[:, :4 * self.nseg].view(torch.int32),
                    regions[:, self.tab:self.hdr])
        B, nmcu = regions.shape[0], self.nmcu
        lw = regions[:, :2 * nmcu].reshape(B, nmcu, 2).to(torch.int32)
        lens = lw[..., 0] | (lw[..., 1] << 8)
        luts = regions[:, 2 * nmcu:self.hdr].view(torch.int8).reshape(
            B, 512, 12)
        return lens, luts

    def forward(self, regions: torch.Tensor) -> list[torch.Tensor]:
        sops.require_full_fp32()      # the reference's Precision.HIGHEST
        lens, luts = self.split_regions(regions)
        B, ny = regions.shape[0], self.bpm - 2
        if self.two_level:
            coef = jpeg_scan_decode_packed(
                regions, lens, luts, self.hdr,
                mcus_per_seg=self.mcus_per_seg, blocks_per_mcu=self.bpm,
                nmcu=self.nmcu)
        else:
            coef = jpeg_scan_decode_packed(regions, lens, luts, self.hdr)
        out = coef.reshape(B, self.mcus_y, self.mcus_x, self.bpm, 64).to(
            torch.float32)
        yc = out[:, :, :, :ny].reshape(B, self.mcus_y, self.mcus_x, 64 * ny)
        comps = [_p224(yc, self.ky, self.ly),
                 _p224(out[:, :, :, ny], self.kc, self.lc),
                 _p224(out[:, :, :, ny + 1], self.kc, self.lc)]
        comps = [(c - b) * (1.0 / a)
                 for c, b, a in zip(comps, self.b_ofs, self.a_scl)]
        for op in self.tail:
            comps = op.apply(comps)
        return comps


class MjpegTpuEntropyPipeline:
    """Stateful batch decoder: feed scan packets, get scaled RGB batches.

    `prep_frame` stages one frame into `self.regions[slot]` (a numpy view
    of a pinned host buffer when the device is CUDA); `run_batch` copies
    the staged batch to the device and decodes it there.  The reference's
    `fn_window` (one dispatch of lax.map over a window of batches, which
    amortised the TPU link's per-call latency) is not ported.
    """

    def __init__(self, spec: TpuEntropySpec, first_packet: bytes,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        st = _JpegState()
        off, _ = _parse_until_scan(first_packet, st)
        self.spec = spec
        self._stream = stream = _Stream.of(spec, st)
        self._key = _stream_key(st)
        self._qy = st.qtabs[st.components[0].q_idx].astype(np.int32)
        self._qc = st.qtabs[st.components[1].q_idx].astype(np.int32)
        mcus_x, mcus_y = stream.mcus
        self.nmcu = mcus_x * mcus_y
        self.nseg, self.tab, self.hdr = stream.region_header()
        self._table = build_jpeg_tables16 if stream.two_level else _luts9
        scan_len = len(first_packet) - off
        cap = spec.packed_cap or (
            self.hdr + int(scan_len * 1.3) + 4096)
        self.cap = -(-cap // 128) * 128
        self.program = MjpegEntropyProgram(
            spec, self.cap, _fused_operators(spec, self._qy, self._qc, stream),
            self.device, stream)
        self.lib = native.get()
        self._host = torch.zeros((spec.batch, self.cap), dtype=torch.uint8,
                                 pin_memory=self.device.type == "cuda")
        self.regions = self._host.numpy()
        self._copied = None        # CUDA event: last h2d copy of _host done
        self._offs = np.zeros(self.nseg + 2, np.int32)
        self._lut_cache = {}

    def prep_frame(self, data: bytes, slot: int) -> None:
        """Host work for one frame: headers + destuff/split packed into
        region `slot` of self.regions.  The reference's `regions=`
        argument, a caller's buffer for its `fn_window` staging, goes
        with that staging (see the class docstring)."""
        with trace.span("mjpeg.prep"):
            with trace.span("mjpeg.prep.wait"):
                if self._copied is not None:
                    self._copied.synchronize()   # last batch has left _host
            with trace.span("mjpeg.prep.parse"):
                st = _JpegState()
                off, _ = _parse_until_scan(data, st)
                if _stream_key(st) != self._key:
                    raise ValueError("mjpeg_tpu_entropy: frame size, "
                                     "sampling or restart interval changed "
                                     "mid-stream (rebuild the pipeline)")
                qy = st.qtabs[st.components[0].q_idx].astype(np.int32)
                if not np.array_equal(qy, self._qy):
                    raise ValueError("mjpeg_tpu_entropy: quant tables "
                                     "changed mid-stream (rebuild the "
                                     "pipeline)")
            with trace.span("mjpeg.prep.table"):
                region = self.regions[slot]
                # frames usually repeat DHTs, so cache the LUT on the raw
                # table bytes (bounded — JPEG DHTs are tiny)
                key = (st.dc_counts.tobytes() + st.dc_values.tobytes()
                       + st.ac_counts.tobytes() + st.ac_values.tobytes())
                lut = self._lut_cache.get(key)
                if lut is None:
                    trace.count("mjpeg.tables_built")
                    lut = self._table(st)
                    if len(self._lut_cache) > 64:
                        self._lut_cache.clear()
                    self._lut_cache[key] = lut
                region[self.tab:self.hdr] = lut
            with trace.span("mjpeg.prep.split"):
                self._split(data, off, region)

    def _split(self, data: bytes, off: int, region: np.ndarray) -> None:
        """Destuff the scan `data[off:]` and split it at its restart
        markers into `region`: the segment lengths, then the packed
        segments.  The C++ reads the scan in place, through a view of
        `data`."""
        scan = np.frombuffer(data, np.uint8)
        dst = region[self.hdr:]
        n = self.lib.mjpeg_split_segments(
            scan.ctypes.data + off, len(scan) - off,
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(dst),
            self._offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.nseg)
        if n != self.nseg:
            raise ValueError(
                f"segment split failed: {n} (packed_cap too small for "
                f"this frame?)" if n < 0 else f"segment count {n} != "
                f"{self.nseg}")
        lens = np.diff(self._offs[:self.nseg + 1])
        if lens.max(initial=0) > self.spec.stride - 5:
            raise ValueError("segment longer than stride - 5 "
                             "(increase TpuEntropySpec.stride)")
        if self.hdr + self._offs[self.nseg] > self.cap - 64 - \
                self.spec.stride:
            raise ValueError("packed frame too close to region end "
                             "(increase TpuEntropySpec.packed_cap)")
        head = lens.astype("<u4" if self._stream.two_level else np.uint16)
        region[:head.nbytes] = head.view(np.uint8)

    def run_batch(self) -> list[torch.Tensor]:
        """Copy the prepared batch to the device (from pinned memory on
        CUDA) and decode it; returns the output components on the
        device, each (batch, out_h, out_w)."""
        with trace.span("mjpeg.run_batch"):
            regions = self._host.to(self.device, non_blocking=True)
            if self.device.type == "cuda":
                self._copied = torch.cuda.Event()
                self._copied.record(torch.cuda.current_stream(self.device))
            return self.program(regions)
