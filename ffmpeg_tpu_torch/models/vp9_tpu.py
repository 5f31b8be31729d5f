"""VP9 full decode with windowed device replay, in PyTorch: the port of
ffmpeg_tpu/models/vp9_tpu.py (reference scope: the whole
libavcodec/vp9.c decode loop — parse, inter/intra reconstruction, loop
filter — re-split for a device).

  host:   the C++ tile parse (csrc/host/vp9_parse.cpp) of a whole WINDOW
          of frames, then each frame's work lists (recon_tpu's exact
          lists, FrameArgs);
  device: per frame, the reconstruction against the 8-slot DPB, which
          stays on the device for the decoder's life, the wavefront
          loop filter (lf_wave), the cast to uint8, and the refresh of
          the flagged slots.  A frame never goes back to the host.

Where the reference is one compiled step program, the port runs each
step eagerly (`_step`):
 * the reference pads every frame's work lists to the window's
   per-class maxima (`window_shapes`, :102), in two shape groups
   (keyframes and intra-only frames against inter frames, :180), so that
   one compiled program serves every frame, and bounds the frames in
   flight (`DEPTH`, :211) so that the padded arguments' memory stays
   bounded.  Eager launches need no fixed shapes: the port builds exact
   lists (recon_tpu.build_frame_args) and has none of the three;
 * the reference donates the DPB to the step and updates it with
   `where` (:73-75); here the reconstruction writes fresh planes, its
   MC reading the DPB in place (recon_tpu._mc_tiles, not the reference's
   slice-gather form on an edge-padded copy, which has no use here: see
   recon_tpu), and only after the loop filter are the flagged slots
   overwritten, in stream order, so a frame that refreshes the slot its
   own MC reads (LAST, often) reads the old picture;
 * as the reference's, each decode() call starts from a zero DPB while
   the parse state (probability contexts, the previous frame's MVs)
   carries on: a window should open with a keyframe.

The output is one entry per parsed frame, shown or not, and none for a
show-existing frame, as the reference's.  Vp9TpuDecoder is not an
open_decoder codec, as in the reference.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..codecs.vp9 import VP9Core, split_superframe
from ..codecs.vp9 import recon_tpu as RT
from ..codecs.vp9.lf_tpu import _luts
from ..codecs.vp9.lf_wave import loopfilter_wavefront
from ..utils.error import NotSupported


def checksum(y, u):
    """The reference's per-frame checksum of the emitted planes (:76-80):
    a sum over a sparse lattice of the (SB-padded) luma and u planes."""
    return (y[::97, ::101].to(torch.int32).sum()
            + u[::53, ::59].to(torch.int32).sum())


class Vp9TpuDecoder:
    """Windowed full decoder on `device`; the geometry is fixed by the
    first frame the instance decodes."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.core = VP9Core(native=True, device=self.device)
        self.core.capture = []
        self.geom = None              # (H, W, Hc, Wc, dw, dh)
        self.dpb_y = self.dpb_c = None

    def parse(self, packets: List[bytes]):
        """Host pass: headers + C++ entropy parse; returns captures."""
        self.core.capture = caps = []
        for p in packets:
            for sub in split_superframe(bytes(p)):
                self.core.decode_frame(sub)
        return caps

    @staticmethod
    def frame_args(h, fs, rec):
        """Host-side arguments for one frame: (refreshed slots, the work
        lists as FrameArgs, the loop filter's host arguments or None
        when the frame's filter level is 0)."""
        smap = np.asarray(h.refidx, np.int32)
        fa = RT.build_frame_args(rec, smap, RT._geom(fs))
        refresh = [i for i in range(8) if (h.refreshrefmask >> i) & 1]
        if not h.filter_level:
            return refresh, fa, None
        sbr, sbc = fs.sb_rows, fs.sb_cols
        lvl8 = np.zeros((sbr * 8, sbc * 8), np.int8)
        lvl8[:fs.rows, :fs.cols] = fs.lf_lvl
        lim, mblim = _luts(h.sharpness)
        pw, ph = sbc * 64, sbr * 64
        # int8 wire format for the LF grids (wd values <= 16, levels
        # <= 63); the filter widens them on the device
        lf = (fs.wd_v.astype(np.int8), fs.wd_h.astype(np.int8),
              fs.wd_v_uv.astype(np.int8), fs.wd_h_uv.astype(np.int8),
              lvl8, lim, mblim, sbr, sbc,
              (pw >> 2, ph >> 2, pw >> 3, ph >> 3))
        return refresh, fa, lf

    def _check_geometry(self, caps):
        for h, fs, _rec in caps:
            geom = RT._geom(fs)
            if self.geom is None:
                self.geom = geom
            elif geom != self.geom:
                raise NotSupported(
                    f"vp9 windowed decoder: a {h.width}x{h.height} frame "
                    f"after {self.geom[4]}x{self.geom[5]} (the geometry "
                    f"is fixed per instance)")

    def _step(self, refresh, fa, lf):
        """One frame on the device: reconstruct against the DPB, loop
        filter, refresh the flagged slots -> (y, u, v) uint8 planes of
        their own (SB-padded)."""
        fa = RT._with_dpb(fa.to(self.device), self.dpb_y, self.dpb_c)
        y, u, v = RT._recon_frame(fa)
        if lf is not None:
            y, u, v = (p.to(torch.uint8)
                       for p in loopfilter_wavefront(y, u, v, *lf))
        for i in refresh:
            self.dpb_y[i].copy_(y)
            self.dpb_c[i, 0].copy_(u)
            self.dpb_c[i, 1].copy_(v)
        return y, u, v

    def decode(self, packets: List[bytes], emit_planes=False,
               stats: Optional[dict] = None):
        """Full decode; returns a list of (y, u, v) planes on the device,
        cropped, when emit_planes, else the per-frame checksums (0-d
        tensors on the device).  stats, when a dict, gets the window's
        parse_s, build_s, device_s and frames."""
        t0 = time.monotonic()
        caps = self.parse(packets)
        t_parse = time.monotonic() - t0
        if not caps:
            return []
        self._check_geometry(caps)
        # a zero 8-slot DPB for each call, as the reference's (:208-209)
        H, W, Hc, Wc, _dw, _dh = self.geom
        self.dpb_y = torch.zeros((8, H, W), dtype=torch.uint8,
                                 device=self.device)
        self.dpb_c = torch.zeros((8, 2, Hc, Wc), dtype=torch.uint8,
                                 device=self.device)

        # exact lists per frame: no window_shapes (:102) and no shape
        # groups (:180), which exist so that one compiled program serves
        # every frame
        t0 = time.monotonic()
        args = [self.frame_args(h, fs, rec) for h, fs, rec in caps]
        t_build = time.monotonic() - t0

        # no DEPTH (:211): it bounds the reference's padded arguments in
        # flight; here each frame's upload waits for the copy
        t0 = time.monotonic()
        outs = []
        for refresh, fa, lf in args:
            y, u, v = self._step(refresh, fa, lf)
            outs.append((y, u, v) if emit_planes else checksum(y, u))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_device = time.monotonic() - t0
        if stats is not None:
            stats.update(parse_s=t_parse, build_s=t_build,
                         device_s=t_device, frames=len(caps))
        if emit_planes:
            return [(y[:h.height, :h.width],
                     u[:(h.height + 1) // 2, :(h.width + 1) // 2],
                     v[:(h.height + 1) // 2, :(h.width + 1) // 2])
                    for (h, _fs, _r), (y, u, v) in zip(caps, outs)]
        return outs
