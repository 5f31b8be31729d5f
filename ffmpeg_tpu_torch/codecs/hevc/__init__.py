"""HEVC decoder (ITU-T H.265; reference: libavcodec/hevc/hevcdec.c); the
port of ffmpeg_tpu/codecs/hevc/__init__.py.

Main profile 4:2:0 at 8, 10 and 12 bits: I, P and B slices (one slice
per picture), tiles and WPP substreams, deblocking and SAO.  The host
runs the CABAC parse (ctu.py), which records the reconstruction work
(recorder.py); the decoder's device runs the reconstruction
(recon_tpu.py) and the in-loop filters (filter_tpu.py).  The DPB holds
the filtered planes as tensors on the device, so a P or B frame's MC
reads its references there: nothing goes back to the host between
frames.  Frames carry the cropped planes as tensors on the device
(uint8 at 8 bits, int16 above; `Frame.numpy()` gives uint16 there, as
the reference's planes).

A deliberate divergence from the reference: there `HevcDecoder` with no
options reconstructs inline on the host; the port's entry points run on
their device, so its default is the device path.  `device_recon=False`
keeps the reference's inline host reconstruction and host filters on
numpy planes (the oracle the tests hold against); its frames' planes
are copied to the device at output.  Nothing falls back: the device
stage runs where it was asked to, or raises.

`stats`, when a list, gets one dict per picture on the device path: the
host parse, the argument build and h2d on the host's clock, and the
device stages (residual, inter, intra, deblock, sao) by CUDA events on
a card.  `capture`, when a list, gets each picture's (FrameDec,
ReconRecorder), for a replay of the device stage (recon_tpu.prepare).
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch

from ...core.frame import Frame
from ...core.packet import Packet
from ...io.stream import MediaType
from ...utils.error import InvalidData
from ...utils.rational import Rational
from ..codec import Codec, register_decoder
from ..h264 import nal as _nal
from ..h264.bits import Bits
from ..h264.cabac import CabacDecoder
from . import params as P
from . import recon_tpu
from .ctu import CtuCoder, FrameDec
from .filter import deblock_frame, sao_frame
from .filter_tpu import filters_tpu
from .recorder import ReconRecorder


def _copy(p):
    return p.clone() if isinstance(p, torch.Tensor) else p.copy()


@register_decoder
class HevcDecoder(Codec):
    codec_id = "hevc"
    codec_type = MediaType.VIDEO

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        # device_recon: the reconstruction and the in-loop filters on
        # the device (recon_tpu.py, filter_tpu.py); the host runs only
        # the CABAC parse.  Byte-exact with the host path.
        self.device_recon = not not self.options.get("device_recon", True)
        self.stats: Optional[list] = None
        self.capture: Optional[list] = None     # (FrameDec, recorder)
        self.sps = {}
        self.pps = {}
        self.nal_size = 0
        self.dpb = []                    # {poc, y, u, v} filtered pics
        self._reorder = []               # (poc, Frame) awaiting output
        self._prev_poc = 0               # prevTid0Pic for POC MSB
        ed = par.extradata or b""
        if len(ed) > 22 and ed[0] == 1:      # hvcC
            self.nal_size = (ed[21] & 3) + 1
            n_arrays = ed[22]
            pos = 23
            for _ in range(n_arrays):
                pos += 1                     # array header
                n = int.from_bytes(ed[pos:pos + 2], "big")
                pos += 2
                for _ in range(n):
                    ln = int.from_bytes(ed[pos:pos + 2], "big")
                    self._handle_nal(ed[pos + 2:pos + 2 + ln])
                    pos += 2 + ln
        elif ed:
            for u in _nal.split_annexb(ed):
                self._handle_nal(u)

    def _handle_nal(self, unit: bytes, pkt: Optional[Packet] = None):
        if len(unit) < 3:
            return None
        ntype = (unit[0] >> 1) & 0x3F
        rbsp = _nal.unescape(unit[2:])
        if ntype == P.NAL_SPS:
            s = P.parse_sps(rbsp)
            self.sps[s.sps_id] = s
        elif ntype == P.NAL_PPS:
            p = P.parse_pps(rbsp)
            self.pps[p.pps_id] = p
        elif P.is_slice(ntype):
            return self._decode_slice(rbsp, ntype, pkt)
        return None

    def _poc(self, sps, ntype, poc_lsb):
        """PicOrderCntVal (spec 8.3.1)."""
        if ntype in (P.NAL_IDR_W_RADL, P.NAL_IDR_N_LP):
            return 0
        max_lsb = 1 << sps.log2_max_poc_lsb
        prev_lsb = self._prev_poc & (max_lsb - 1)
        prev_msb = self._prev_poc - prev_lsb
        if poc_lsb < prev_lsb and prev_lsb - poc_lsb >= max_lsb // 2:
            msb = prev_msb + max_lsb
        elif poc_lsb > prev_lsb and poc_lsb - prev_lsb > max_lsb // 2:
            msb = prev_msb - max_lsb
        else:
            msb = prev_msb
        return msb + poc_lsb

    def _ref_lists(self, sps, sh, poc):
        """RPS application + RefPicList construction (8.3.2/8.3.4).
        Also evicts DPB pictures outside the RPS."""
        keep = {poc + d for d, _ in sh.rps_neg} | \
               {poc + d for d, _ in sh.rps_pos}
        self.dpb = [e for e in self.dpb if e["poc"] in keep]
        by_poc = {e["poc"]: e for e in self.dpb}
        before, after = [], []
        for d, used in sh.rps_neg:
            if used:
                e = by_poc.get(poc + d)
                if e is None:
                    raise InvalidData(f"hevc: ref poc {poc + d} "
                                      "missing from DPB")
                before.append(e)
        for d, used in sh.rps_pos:
            if used:
                e = by_poc.get(poc + d)
                if e is None:
                    raise InvalidData(f"hevc: ref poc {poc + d} "
                                      "missing from DPB")
                after.append(e)
        refs = [[], []]
        rpl = [[], []]
        for ll, order in ((0, before + after), (1, after + before)):
            n = sh.num_ref_idx[ll]
            if n and not order:
                raise InvalidData("hevc: empty reference list")
            mod = sh.list_entry[ll]
            for i in range(n):
                if mod is not None:
                    if mod[i] >= len(order):
                        raise InvalidData("hevc: list_entry out of "
                                          "range")
                    e = order[mod[i]]
                else:
                    e = order[i % len(order)]
                refs[ll].append((e["y"], e["u"], e["v"]))
                rpl[ll].append(e["poc"])
        return refs, rpl

    def _decode_slice(self, rbsp: bytes, ntype: int, pkt):
        # slice_pic_parameter_set_id follows first_slice(+irap flag)
        probe = Bits(rbsp)
        probe.get1()
        if P.is_irap(ntype):
            probe.get1()
        pps = self.pps.get(probe.ue())
        if pps is None:
            raise InvalidData("hevc: unknown PPS")
        sps = self.sps.get(pps.sps_id)
        if sps is None:
            raise InvalidData("hevc: unknown SPS")
        t0 = time.perf_counter()
        sh = P.parse_slice_header(rbsp, ntype, sps, self.pps)
        is_idr = ntype in (P.NAL_IDR_W_RADL, P.NAL_IDR_N_LP)
        flushed = []
        if is_idr:
            flushed = self._flush_reorder()
            self.dpb = []
        poc = self._poc(sps, ntype, sh.poc_lsb)
        if ntype != P.NAL_TRAIL_N:       # prevTid0Pic: reference pics
            self._prev_poc = poc
        refs, rpl = ([[], []], [[], []])
        if sh.slice_type != 2:
            refs, rpl = self._ref_lists(sps, sh, poc)
        dec = FrameDec(sps, pps, sh, poc=poc, refs=refs, rpl=rpl)
        if self.device_recon:
            dec.recorder = ReconRecorder(dec)
        payload = rbsp[sh.data_bit_pos // 8:]
        core = CabacDecoder(payload)
        CtuCoder(dec, core, payload=payload).code_slice_data()
        if self.device_recon:
            if self.capture is not None:
                self.capture.append((dec, dec.recorder))
            timer = None
            if self.stats is not None:
                timer = recon_tpu._Timer(self.device)
                timer.host["parse"] = (time.perf_counter() - t0) * 1e3
            planes = recon_tpu.reconstruct(dec, dec.recorder, self.device,
                                           timer)
            y, u, v = filters_tpu(dec, *planes,
                                  None if timer is None else timer.dev_mark)
            if timer is not None:
                timer.host_mark("queue")     # the host's launches
                timer.dev_mark("done")
                if timer.cuda:
                    torch.cuda.synchronize()
                timer.host_mark("wait")
                self.stats.append({"poc": poc, "slice_type": sh.slice_type,
                                   "host": dict(timer.host),
                                   "h2d_bytes": timer.h2d_bytes,
                                   "device": timer.device_ms(),
                                   "levels": dec.recorder.max_level})
            # the DPB holds these tensors; no later frame writes them
        else:
            if not sh.deblocking_disabled:
                deblock_frame(dec)
            if sps.sao_enabled and (sh.sao_luma or sh.sao_chroma):
                sao_frame(dec)
            y, u, v = dec.y.copy(), dec.u.copy(), dec.v.copy()
        self.dpb.append({"poc": poc, "y": y, "u": u, "v": v})
        fmt = {8: "yuv420p", 10: "yuv420p10le",
               12: "yuv420p12le"}[sps.bit_depth]
        ow = sps.width - sps.crop_left - sps.crop_right
        oh = sps.height - sps.crop_top - sps.crop_bottom
        oy, ou, ov = y, u, v
        if (ow, oh) != (sps.width, sps.height):
            l, t = sps.crop_left, sps.crop_top
            oy = _copy(y[t:t + oh, l:l + ow])
            ou = _copy(u[t // 2:(t + oh) // 2, l // 2:(l + ow) // 2])
            ov = _copy(v[t // 2:(t + oh) // 2, l // 2:(l + ow) // 2])
        if not self.device_recon:
            # the host path's planes, copied to the device at output
            oy, ou, ov = (torch.from_numpy(p).to(
                self.device, recon_tpu.plane_dtype(sps.bit_depth))
                for p in (oy, ou, ov))
        f = Frame.video(ow, oh, fmt,
                        planes=[oy, ou, ov],
                        pts=pkt.pts if pkt else 0,
                        time_base=(pkt.time_base if pkt else None)
                        or Rational(1, 25))
        f.key_frame = is_idr
        self._reorder.append((poc, f))
        out = flushed
        while len(self._reorder) > sps.num_reorder:
            self._reorder.sort(key=lambda t: t[0])
            out.append(self._reorder.pop(0)[1])
        return out

    def _flush_reorder(self):
        out = []
        while self._reorder:
            self._reorder.sort(key=lambda t: t[0])
            out.append(self._reorder.pop(0)[1])
        return out

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return self._flush_reorder()
        frames = []
        if self.nal_size:
            data = pkt.data
            pos = 0
            units = []
            while pos + self.nal_size <= len(data):
                ln = int.from_bytes(data[pos:pos + self.nal_size], "big")
                pos += self.nal_size
                units.append(data[pos:pos + ln])
                pos += ln
        else:
            units = _nal.split_annexb(pkt.data)
        for u in units:
            f = self._handle_nal(u, pkt)
            if f:
                frames.extend(f)
        return frames
