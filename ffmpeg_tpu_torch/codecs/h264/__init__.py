"""H.264/AVC decoder (reference: libavcodec/h264dec.c); the port of
ffmpeg_tpu/codecs/h264/__init__.py.

Scope as the reference's: I/P/B frame pictures and PAFF field pictures,
CAVLC + CABAC, multiple reference frames with list modification, MMCO
and long-term references, weighted prediction (explicit and implicit),
in-loop deblocking, error concealment; 4:2:0 at 8 bits on the device,
above 8 bits on the host.

The host parses each slice (slice_dec.py, cabac_slice.py) into
per-picture arrays (coefficients, modes, motion); the decoder's device
reconstructs the picture from them (recon_tpu.py: the residual, quarter-
pel MC, the intra and the deblocking wavefronts).  The DPB holds the
pictures' planes as tensors on the device, so a P or B picture's MC
reads its references there; the motion and reference arrays that B
temporal direct and concealment read stay on the host.  Frames carry
the cropped planes as tensors on the device (uint8; int16 above 8 bits,
where `Frame.numpy()` gives the reference's uint16).

A deliberate divergence from the reference: there the decoder with no
options reconstructs on the host and `recon="tpu"` selects the device
program; the port's entry points run on their device, so its default is
the device path (`recon` absent or "tpu").  `recon="host"` keeps the
reference's host path (recon_host.py, conceal.py, loopfilter.py on numpy
planes), the oracle the tests hold against; its frames' planes are
copied to the device at output.  Above 8 bits the host path runs, as in
the reference.  The device path conceals a damaged picture as the
reference's host path does (the reference's device path does not).
Nothing falls back: the device stage runs where it was asked to, or
raises.

`stats`, when a list, gets one dict per picture of the device path: the
host parse and recon_tpu.reconstruct's split (argument build, h2d, the
device stages by CUDA events on a card).
"""

from __future__ import annotations

import time
from dataclasses import replace as _replace
from typing import List, Optional

import numpy as np
import torch

from ...core.frame import Frame
from ...core.packet import Packet
from ...io.stream import MediaType
from ...utils.error import InvalidData, NotSupported
from ...utils.rational import Rational
from ..codec import Codec, register_decoder
from . import nal as _nal
from .bits import Bits
from .params import parse_pps, parse_sps
from .slice_dec import SliceDecoder, parse_slice_header


def _apply_reorder(default, dpb, ops, cur_fn, max_fn, num_ref):
    """ref_pic_list_modification (spec 8.2.4.3.1) incl. long-term
    picture numbers (idc 2). Reference: libavcodec/h264_refs.c
    ff_h264_build_ref_list."""
    out = list(default)
    if not ops:
        return out

    def fnw(e):
        fn = e["frame_num"]
        return fn - max_fn if fn > cur_fn else fn

    pred = cur_fn
    idx = 0
    for idc, val in ops:
        if idc == 2:              # long_term_pic_num
            match = next(
                (e for e in dpb if not e.get("short_term", True)
                 and e.get("lt_idx") == val), None)
            if match is None:
                raise InvalidData("h264: long-term pic not in DPB")
            if idx < len(out):
                out.insert(idx, match)
            else:
                out.append(match)
            idx += 1
            for j in range(idx, len(out)):
                if out[j] is match:
                    out.pop(j)
                    break
            continue
        if idc == 0:
            pred -= val + 1
            if pred < 0:
                pred += max_fn
        else:
            pred += val + 1
            if pred >= max_fn:
                pred -= max_fn
        pic_num = pred - (max_fn if pred > cur_fn else 0)
        match = next((e for e in dpb
                      if e.get("short_term", True)
                      and fnw(e) == pic_num), None)
        if match is None:
            raise InvalidData("h264: reordered pic_num not in DPB")
        if idx < len(out):
            out.insert(idx, match)
        else:
            out.append(match)
        idx += 1
        for j in range(idx, len(out)):
            if out[j] is match:
                out.pop(j)
                break
    return out[:num_ref] if num_ref else out


def _copy(p):
    return p.clone() if isinstance(p, torch.Tensor) else p.copy()


def _empty_like_rows(p, rows):
    """An empty plane of `rows` rows shaped like p otherwise."""
    if isinstance(p, torch.Tensor):
        return p.new_empty((rows, p.shape[1]))
    return np.empty((rows, p.shape[1]), p.dtype)


@register_decoder
class H264Decoder(Codec):
    codec_id = "h264"
    codec_type = MediaType.VIDEO

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        recon = self.options.get("recon", "tpu")
        if recon not in ("tpu", "host"):
            raise NotSupported(f"h264: recon={recon!r}")
        self.device_recon = recon == "tpu"
        self.stats: Optional[list] = None
        self.sps = {}
        self.pps = {}
        self.nal_size = 0          # 0 = Annex B
        ed = par.extradata or b""
        if ed[:1] == b"\x01":      # AVCC
            self.nal_size = (ed[4] & 3) + 1
            n_sps = ed[5] & 0x1F
            pos = 6
            for _ in range(n_sps):
                ln = int.from_bytes(ed[pos:pos + 2], "big")
                self._handle_nal(ed[pos + 2:pos + 2 + ln])
                pos += 2 + ln
            n_pps = ed[pos]
            pos += 1
            for _ in range(n_pps):
                ln = int.from_bytes(ed[pos:pos + 2], "big")
                self._handle_nal(ed[pos + 2:pos + 2 + ln])
                pos += 2 + ln
        elif ed:
            for u in _nal.split_annexb(ed):
                self._handle_nal(u)
        self._ref = None           # last decoded picture planes (P path)
        self._pending_field = None  # first field awaiting its pair
        self._dpb = []             # reference pictures: dicts with poc/mv
        self._reorder = []         # (poc, frame) awaiting output
        self._delay = 1            # POC reorder depth (B over 1 ref pair)

    def _handle_nal(self, unit: bytes):
        if not unit:
            return None
        ref_idc, ntype = _nal.parse_nal_header(unit)
        self._last_ref_idc = ref_idc
        rbsp = _nal.unescape(unit[1:])
        if ntype == _nal.NAL_SPS:
            s = parse_sps(rbsp)
            self.sps[s.sps_id] = s
        elif ntype == _nal.NAL_PPS:
            p = parse_pps(rbsp, self.sps)
            self.pps[p.pps_id] = p
        return ntype, rbsp

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None:
            frames = []
            while self._reorder:
                self._reorder.sort(key=lambda t: t[0])
                frames.append(self._reorder.pop(0)[1])
            return frames
        units = _nal.split_avcc(pkt.data, self.nal_size) if self.nal_size \
            else _nal.split_annexb(pkt.data)
        frames: List[Frame] = []
        dec: Optional[SliceDecoder] = None
        for unit in units:
            r = self._handle_nal(unit)
            if r is None:
                continue
            ntype, rbsp = r
            if ntype in (_nal.NAL_SLICE, _nal.NAL_IDR):
                t0 = time.perf_counter()
                b = Bits(rbsp)
                # peek header to find pps/sps
                probe = Bits(rbsp)
                probe.ue()
                probe.ue()
                pps_id = probe.ue()
                pps = self.pps.get(pps_id)
                if pps is None:
                    raise InvalidData("h264: unknown PPS")
                sps = self.sps.get(pps.sps_id)
                if sps is None:
                    raise InvalidData("h264: unknown SPS")
                sh = parse_slice_header(b, ntype, sps, pps,
                                        self._last_ref_idc)
                if dec is None or sh.first_mb == 0:
                    if dec is not None:
                        frames.extend(self._emit(dec, pkt))
                    pic_sps = sps
                    if not sps.frame_mbs_only and not sh.field_pic:
                        # frame picture in a PAFF stream spans both
                        # fields' MB rows
                        pic_sps = _replace(sps,
                                           mb_height=sps.mb_height * 2,
                                           frame_mbs_only=True)
                    dec = SliceDecoder(pic_sps, pps)
                    dec.parse_ms = 0.0
                    dec.field_pic = sh.field_pic
                    dec.bottom_field = sh.bottom_field
                    if sh.field_pic:
                        from .recon import FIELD4, FIELD8
                        dec.scan4 = FIELD4
                        dec.scan8 = FIELD8
                    dec.ref_idc = self._last_ref_idc
                    dec.ref_frame = self._ref
                    if sh.idr:
                        self._dpb.clear()
                        self._pending_field = None
                        # an IDR closes the previous sequence: flush any
                        # frames still waiting on POC reordering
                        while self._reorder:
                            self._reorder.sort(key=lambda t: t[0])
                            frames.append(self._reorder.pop(0)[1])
                    dec.poc = sh.poc_lsb
                    dec.frame_num = sh.frame_num
                    max_fn = 1 << sps.log2_max_frame_num
                    # reference lists: default order then the slice
                    # header's explicit modification (8.2.4.3.1)
                    if sh.field_pic and sh.slice_type != 2:
                        if sh.slice_type == 1:
                            raise NotSupported(
                                "h264: B field pictures")
                        if sh.reorder[0]:
                            raise NotSupported(
                                "h264: field ref list modification")
                        dec.list0 = self._field_list0(sh, max_fn)
                    elif sh.slice_type == 1:
                        before = sorted(
                            (e for e in self._dpb if e["poc"] < dec.poc),
                            key=lambda e: -e["poc"])
                        after = sorted(
                            (e for e in self._dpb if e["poc"] > dec.poc),
                            key=lambda e: e["poc"])
                        dec.list0 = _apply_reorder(
                            before + after, self._dpb, sh.reorder[0],
                            sh.frame_num, max_fn, sh.num_ref[0])
                        dec.list1 = _apply_reorder(
                            after + before, self._dpb, sh.reorder[1],
                            sh.frame_num, max_fn, sh.num_ref[1])
                    elif sh.slice_type == 0:
                        shorts = [e for e in self._dpb
                                  if e.get("short_term", True)]
                        longs = sorted(
                            (e for e in self._dpb
                             if not e.get("short_term", True)),
                            key=lambda e: e.get("lt_idx", 0))
                        dec.list0 = _apply_reorder(
                            list(reversed(shorts)) + longs,
                            self._dpb, sh.reorder[0],
                            sh.frame_num, max_fn, sh.num_ref[0])
                try:
                    if pps.cabac:
                        from .cabac_slice import decode_slice_cabac
                        decode_slice_cabac(dec, rbsp, b.pos, sh)
                    else:
                        dec.decode_slice(b, sh)
                except (InvalidData, IndexError) as e:
                    # damaged slice: keep the MBs decoded so far and
                    # conceal the rest at output (error_resilience.c
                    # semantics; AV_EF_EXPLODE disables this)
                    if self.options.get("err_detect") == "explode":
                        raise
                    self.warning(f"slice error, concealing: {e}")
                    dec.damaged = True
                dec.last_sh = sh
                dec.parse_ms += (time.perf_counter() - t0) * 1e3
        if dec is not None:
            frames.extend(self._emit(dec, pkt))
        if pkt is None or not units:
            while self._reorder:
                self._reorder.sort(key=lambda t: t[0])
                frames.append(self._reorder.pop(0)[1])
        return frames

    def _field_list0(self, sh, max_fn):
        """Default P-field reference list (8.2.4.2.5): short-term
        fields by descending FrameNumWrap, same parity first,
        alternating parities."""
        fields = [e for e in self._dpb if e.get("field")]

        def fnw(e):
            fn = e["frame_num"]
            return fn - max_fn if fn > sh.frame_num else fn

        ordered = sorted(fields, key=lambda e: -fnw(e))
        cur_par = int(sh.bottom_field)
        same = [e for e in ordered if e["parity"] == cur_par]
        opp = [e for e in ordered if e["parity"] != cur_par]
        lst = []
        i = j = 0
        while i < len(same) or j < len(opp):
            if i < len(same):
                lst.append(same[i])
                i += 1
            if j < len(opp):
                lst.append(opp[j])
                j += 1
        return lst[:sh.num_ref[0]]

    def _out_planes(self, planes, bd):
        """A frame's planes on the decoder's device: the device path's
        tensors as they are; the host path's arrays copied there."""
        if isinstance(planes[0], torch.Tensor):
            return list(planes)
        dt = torch.uint8 if bd == 8 else torch.int16
        return [torch.from_numpy(np.ascontiguousarray(p)).to(self.device,
                                                              dt)
                for p in planes]

    def _emit_field(self, dec: SliceDecoder, pkt: Packet, sh,
                    planes) -> List[Frame]:
        """Store one reconstructed field picture as a reference field,
        and emit a woven frame once both parities of the same
        frame_num are decoded."""
        is_ref = getattr(dec, "ref_idc", 1) != 0
        parity = int(dec.bottom_field)
        if is_ref:
            self._dpb.append({"poc": dec.poc,
                              "frame_num": dec.frame_num,
                              "planes": planes,
                              "parity": parity,
                              "field": True,
                              "mv": dec.mv[0].copy(),
                              "ref": dec.mv_ref[0].copy(),
                              "intra": dec.mb_intra.copy(),
                              "mb16": dec.mb_16x16.copy(),
                              "short_term": True})
            max_refs = max(1, dec.sps.num_ref_frames) * 2
            while len(self._dpb) > max_refs:
                self._dpb.pop(0)
        pend = self._pending_field
        if pend is not None and pend["frame_num"] == dec.frame_num \
                and pend["parity"] != parity:
            top = planes if parity == 0 else pend["planes"]
            bot = planes if parity == 1 else pend["planes"]
            woven = []
            for t, b in zip(top, bot):
                p = _empty_like_rows(t, t.shape[0] * 2)
                p[0::2], p[1::2] = t, b
                woven.append(p)
            self._pending_field = None
            sps = dec.sps
            w, h = sps.width, sps.mb_height * 32
            fmt = "yuv420p" if sps.bit_depth_luma == 8 else \
                f"yuv420p{sps.bit_depth_luma}le"
            y, u, v = self._out_planes(woven, sps.bit_depth_luma)
            f = Frame.video(w, h, fmt,
                            planes=[_copy(y[:h]), _copy(u[:h // 2]),
                                    _copy(v[:h // 2])],
                            pts=pkt.pts,
                            time_base=pkt.time_base
                            or Rational(1, 25))
            f.interlaced = True
            f.top_field_first = pend["parity"] == 0
            f.key_frame = bool(sh and sh.idr)
            poc = min(dec.poc, pend["poc"])
            self._reorder.append((poc, f))
            out = []
            while len(self._reorder) > self._delay:
                self._reorder.sort(key=lambda t: t[0])
                out.append(self._reorder.pop(0)[1])
            return out
        self._pending_field = {"frame_num": dec.frame_num,
                               "parity": parity,
                               "planes": planes, "poc": dec.poc}
        return []

    def _reconstruct(self, dec: SliceDecoder, sh, do_deblock):
        """The picture's final planes: device tensors (the device path,
        8 bits) or fresh host arrays (the host path)."""
        if self.device_recon and dec.bd == 8:
            from . import recon_tpu
            st = {} if self.stats is not None else None
            damaged = not dec.mb_avail.all()
            planes = recon_tpu.reconstruct(
                dec, self.device,
                sh.alpha_c0_offset if sh else 0,
                sh.beta_offset if sh else 0,
                do_deblock=do_deblock, stats=st)
            if st is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                st["timer"].host_mark("wait")
                recon_tpu.finish_stats(st)
                st["host"]["parse"] = dec.parse_ms
                st.update(poc=dec.poc, slice_type=sh.slice_type if sh
                          else None, damaged=damaged)
                self.stats.append(st)
            # fresh tensors: no later picture writes them
            return planes
        from . import recon_host
        recon_host.reconstruct(dec)
        if not dec.mb_avail.all():
            from .conceal import conceal_missing
            conceal_missing(dec)
        if do_deblock:
            from .loopfilter import deblock_frame
            deblock_frame(dec, sh.alpha_c0_offset, sh.beta_offset)
        return (dec.y.copy(), dec.u.copy(), dec.v.copy())

    def _emit(self, dec: SliceDecoder, pkt: Packet) -> List[Frame]:
        sh = getattr(dec, "last_sh", None)
        do_deblock = sh is not None and sh.disable_deblocking != 1
        planes = self._reconstruct(dec, sh, do_deblock)
        if getattr(dec, "field_pic", False):
            return self._emit_field(dec, pkt, sh, planes)
        is_ref = getattr(dec, "ref_idc", 1) != 0
        if is_ref:
            self._ref = planes
            mmco = getattr(sh, "mmco", None) if sh else None
            mark_long_idx = None       # mark CURRENT picture long
            if sh is not None and sh.idr and \
                    getattr(sh, "long_term_ref", False):
                mark_long_idx = 0
            if mmco:
                max_fn = 1 << dec.sps.log2_max_frame_num
                for op, val in mmco:
                    if op == 5:
                        self._dpb.clear()
                        dec.poc = 0
                    elif op == 1:      # unmark short-term
                        pic_num = (dec.frame_num - (val + 1)) % max_fn
                        self._dpb = [
                            e for e in self._dpb
                            if not (e.get("short_term", True)
                                    and e["frame_num"] == pic_num)]
                    elif op == 2:      # unmark long-term
                        self._dpb = [
                            e for e in self._dpb
                            if e.get("short_term", True)
                            or e.get("lt_idx") != val]
                    elif op == 3:      # short -> long
                        diff, idx = val
                        pic_num = (dec.frame_num - (diff + 1)) \
                            % max_fn
                        self._dpb = [
                            e for e in self._dpb
                            if e.get("short_term", True)
                            or e.get("lt_idx") != idx]
                        for e in self._dpb:
                            if e.get("short_term", True) and \
                                    e["frame_num"] == pic_num:
                                e["short_term"] = False
                                e["lt_idx"] = idx
                                break
                    elif op == 4:      # max long-term idx + 1
                        self._dpb = [
                            e for e in self._dpb
                            if e.get("short_term", True)
                            or e.get("lt_idx", 0) < val]
                    elif op == 6:      # mark current long-term
                        self._dpb = [
                            e for e in self._dpb
                            if e.get("short_term", True)
                            or e.get("lt_idx") != val]
                        mark_long_idx = val
            # map each block's list0 ref index to its reference's
            # POC (consumed by B temporal direct, 8.4.1.2.3)
            ref_poc = np.full(dec.mv_ref[0].shape, -(1 << 30),
                              np.int64)
            for i, e in enumerate(getattr(dec, "list0", []) or []):
                ref_poc[dec.mv_ref[0] == i] = e["poc"]
            self._dpb.append({"poc": dec.poc,
                              "frame_num": getattr(dec, "frame_num", 0),
                              "planes": planes,
                              "mv": dec.mv[0].copy(),
                              "ref": dec.mv_ref[0].copy(),
                              "ref_poc": ref_poc,
                              "intra": dec.mb_intra.copy(),
                              "mb16": dec.mb_16x16.copy(),
                              "short_term": mark_long_idx is None,
                              "lt_idx": mark_long_idx})
            max_refs = max(1, dec.sps.num_ref_frames)
            while len(self._dpb) > max_refs:
                # sliding window evicts the oldest SHORT-term only
                # (8.2.5.3); explicit mmco already did its removals
                for i, e in enumerate(self._dpb):
                    if e.get("short_term", True):
                        self._dpb.pop(i)
                        break
                else:
                    break
        sps = dec.sps
        t, b = sps.crop_top * 2, sps.crop_bottom * 2
        l, r = sps.crop_left * 2, sps.crop_right * 2
        h, w = sps.mb_height * 16 - t - b, sps.mb_width * 16 - l - r
        y, u, v = self._out_planes(planes, sps.bit_depth_luma)
        y = y[t:t + h, l:l + w]
        u = u[t // 2:(t + h) // 2, l // 2:(l + w) // 2]
        v = v[t // 2:(t + h) // 2, l // 2:(l + w) // 2]
        fmt = "yuv420p" if sps.bit_depth_luma == 8 else \
            f"yuv420p{sps.bit_depth_luma}le"
        f = Frame.video(w, h, fmt, planes=[_copy(y), _copy(u), _copy(v)],
                        pts=pkt.pts,
                        time_base=pkt.time_base or Rational(1, 25))
        f.key_frame = bool(getattr(dec, "last_sh", None)
                           and dec.last_sh.idr)
        # POC output reordering (delay grows to 1 when B frames appear)
        self._reorder.append((dec.poc, f))
        out = []
        while len(self._reorder) > self._delay:
            self._reorder.sort(key=lambda t: t[0])
            out.append(self._reorder.pop(0)[1])
        return out
