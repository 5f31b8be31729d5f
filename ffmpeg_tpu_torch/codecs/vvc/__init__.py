"""VVC decoder, minimal-toolset I-slice core (ITU-T H.266; reference
libavcodec/vvc/dec.c:1297). Per-CTU reconstruction can optionally run
through the P4 task-graph executor (parallel/executor.py, the
AVExecutor analog vvc/thread.h:28).

The port's copy of ffmpeg_tpu/codecs/vvc/__init__.py, held equal to it by
tests/test_torch_vvc.py.
Parsing and reconstruction stay on the host (numpy, with a numpy DPB);
the decoder puts each picture on the device it is opened on with one
upload (device_planes).  As in the reference, a frame's planes are the
DPB's own arrays: on the CPU the tensors wrap them without a copy, and
the decoder never writes to a picture once it is in the DPB.
"""

from __future__ import annotations

from typing import List, Optional

from ...core.frame import Frame, device_planes
from ...core.packet import Packet
from ...io.stream import MediaType
from ...utils.error import InvalidData
from ...utils.rational import Rational
from ..codec import DeviceCodec, register_decoder
from ..h264 import nal as _nal
from . import params as P
from .cabac import VvcCabacDecoder
from .ctu import CtuCoder, FrameDec


@register_decoder
class VvcDecoder(DeviceCodec):
    codec_id = "vvc"
    aliases = ("h266",)
    codec_type = MediaType.VIDEO

    def __init__(self, par, options=None, *, device="cuda"):
        super().__init__(par, options, device=device)
        self.sps = {}
        self.pps = {}
        self.dpb = {}                # poc -> (y, u, v) numpy planes
        self.prev_poc = 0
        ed = par.extradata or b""
        if ed:
            for u in _nal.split_annexb(ed):
                self._handle_nal(u)

    def _handle_nal(self, unit: bytes, pkt: Optional[Packet] = None):
        if len(unit) < 3:
            return None
        ntype = P.nal_type(unit)
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

    def _poc(self, sh, ntype, sps):
        """PicOrderCntVal (8.3.1, no msb-cycle signalling)."""
        if P.is_idr(ntype):
            poc = sh.poc_lsb
        else:
            mx = 1 << sps.log2_max_poc_lsb
            prev_lsb = self.prev_poc & (mx - 1)
            prev_msb = self.prev_poc - prev_lsb
            if sh.poc_lsb < prev_lsb and prev_lsb - sh.poc_lsb >= \
                    mx // 2:
                msb = prev_msb + mx
            elif sh.poc_lsb > prev_lsb and sh.poc_lsb - prev_lsb > \
                    mx // 2:
                msb = prev_msb - mx
            else:
                msb = prev_msb
            poc = msb + sh.poc_lsb
        self.prev_poc = poc
        return poc

    def _decode_slice(self, rbsp: bytes, ntype: int, pkt):
        if not self.sps:
            raise InvalidData("vvc: no SPS")
        sps = next(iter(self.sps.values()))
        sh = P.parse_slice_header(rbsp, ntype, sps, self.pps)
        pps = next(iter(self.pps.values()))
        if P.is_idr(ntype):
            self.dpb.clear()
        poc = self._poc(sh, ntype, sps)
        # resolve the slice RPLs against the DPB (refs.c:542
        # ff_vvc_slice_rpl, cumulative poc_base chain)
        rpl_poc = [[], []]
        rpl_frames = [[], []]
        for lx in range(2):
            base = poc
            for delta in sh.rpl_deltas[lx]:
                base += delta
                rpl_poc[lx].append(base)
                used = sh.slice_type == 0 or \
                    (sh.slice_type == 1 and lx == 0)
                if used and base not in self.dpb:
                    raise InvalidData(
                        f"vvc: reference POC {base} not in DPB")
                rpl_frames[lx].append(self.dpb.get(base))
        dec = FrameDec(sps, pps, sh, rpl_poc=rpl_poc,
                       rpl_frames=rpl_frames)
        core = VvcCabacDecoder(rbsp[sh.data_bit_pos // 8:])
        threads = int(self.options.get("threads", 1) or 1)
        coder = CtuCoder(dec, core, defer_recon=threads > 1)
        coder.code_slice_data()
        if threads > 1:
            # P4: sequential parse, per-CTU wavefront recon tasks on
            # the AVExecutor analog (reference vvc/thread.c:770)
            from ...parallel.executor import Executor
            with Executor(workers=threads) as ex:
                coder.run_deferred_recon(ex)
        self.dpb[poc] = (dec.y.copy(), dec.u.copy(), dec.v.copy())
        fmt = "yuv420p" if sps.bit_depth == 8 else "yuv420p10le"
        f = Frame.video(sps.width, sps.height, fmt,
                        planes=device_planes(list(self.dpb[poc]),
                                             self.device),
                        pts=pkt.pts if pkt else 0,
                        time_base=(pkt.time_base if pkt else None)
                        or Rational(1, 25))
        f.key_frame = P.is_idr(ntype)
        return [f]

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        frames = []
        for u in _nal.split_annexb(pkt.data):
            f = self._handle_nal(u, pkt)
            if f:
                frames.extend(f)
        return frames
