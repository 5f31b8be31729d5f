"""VP9 decoder (reference: libavcodec/vp9.c); the port of
ffmpeg_tpu/codecs/vp9/__init__.py.

Profile-0 8-bit 4:2:0: keyframes, intra-only and inter frames (single +
compound prediction, all sub-pel filters, MV prediction, frame-context
adaptation, superframes, show-existing), tiles, and the full in-loop
deblocking filter.  Segmentation, lossless and scaled refs are rejected.

One frame runs in three stages, as the reference's native path: the C++
tile walk (csrc/host/vp9_parse.cpp, `native_parse.parse_frame_native`),
the reconstruction on the decoder's device (`recon_tpu.reconstruct`),
then the host loop filter (`lf.loopfilter_frame`), backward adaptation
and the reference refresh.

A deliberate divergence from the reference: there `VP9Decoder` with no
options runs the all-host Python walker; the port's entry points run on
their device, so its `VP9Decoder` takes the native path unless the
options say `native=False`.  `native=False` keeps the Python walker with
inline host reconstruction (the oracle the tests hold against);
`native=False, device_recon=True` replays the walker's records on the
device.  Nothing falls back: a failed C++ build raises, and the device
stage runs where it was asked to.
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
from .block import FrameState, TileWalker
from .bool import BoolDecoder
from .header import ProbContext, parse_compressed, parse_uncompressed
from .lf import loopfilter_frame
from .prob import adapt_probs


def tile_bounds(idx: int, log2_n: int, sbs: int) -> tuple:
    """→ (start, end) in MI units (vp9.c set_tile_offset)."""
    s = min((idx * sbs) >> log2_n, sbs) << 3
    e = min(((idx + 1) * sbs) >> log2_n, sbs) << 3
    return s, e


def split_superframe(data: bytes) -> List[bytes]:
    """VP9 superframe index → coded frames (vp9_superframe_split)."""
    if not data:
        return []
    marker = data[-1]
    if (marker & 0xE0) == 0xC0:
        n = (marker & 7) + 1
        mag = ((marker >> 3) & 3) + 1
        idx_sz = 2 + mag * n
        if len(data) >= idx_sz and data[-idx_sz] == marker:
            pos = len(data) - idx_sz + 1
            sizes = []
            for _ in range(n):
                sizes.append(int.from_bytes(
                    data[pos:pos + mag], "little"))
                pos += mag
            out = []
            off = 0
            for sz in sizes:
                if off + sz > len(data) - idx_sz:
                    raise InvalidData("vp9: bad superframe index")
                out.append(data[off:off + sz])
                off += sz
            return out
    return [data]


class VP9Core:
    """Stateful frame decoder: reference slots, the 4 probability
    contexts, and the previous frame's MV grid.  `device` is where the
    reconstruction runs (native path, or the walker's records with
    device_recon).  `stats`, when a list, gets one dict per decoded
    frame of the native path: the split of its time (phase 13 of
    chip_smoke.py)."""

    def __init__(self, device_recon=False, native=False, device="cuda"):
        self.device_recon = device_recon
        self.native = native              # C++ parse + device replay
        self.device = torch.device(device)
        self.capture = None               # list -> parse-only capture:
                                          # (h, fs, rec) appended, recon
                                          # + LF skipped
        self.stats = None
        self.refs: List[Optional[tuple]] = [None] * 8
        self.ctx = [ProbContext() for _ in range(4)]
        self.last_keyframe = False
        self.last_invisible = False
        self.lf_deltas = ([1, 0, -1, -1], [0, 0])
        self.prev = None                  # (w, h, mv_ref, mv_xy)

    def decode_frame(self, data: bytes):
        """→ (header, planes (y,u,v,w,h) padded, or None if invisible)."""
        ref_dims = [(r[3], r[4]) if r else None for r in self.refs]
        h = parse_uncompressed(data, self.last_invisible,
                               self.lf_deltas, ref_dims)
        if h.show_existing >= 0:
            r = self.refs[h.show_existing]
            if r is None:
                raise InvalidData("vp9: show_existing of empty slot")
            return h, (r[0], r[1], r[2], r[3], r[4])
        pos = (h.uncompressed_bits + 7) // 8
        if pos + h.compressed_size > len(data):
            raise InvalidData("vp9: truncated compressed header")

        # frame-context resets (vp9.c:887)
        if h.keyframe or h.errorres or (h.intraonly and
                                        h.resetctx == 3):
            self.ctx = [ProbContext() for _ in range(4)]
        elif h.intraonly and h.resetctx == 2:
            self.ctx[h.framectxid] = ProbContext()

        probs = parse_compressed(h, data[pos:pos + h.compressed_size],
                                 self.ctx[h.framectxid])
        pos += h.compressed_size

        inter = not (h.keyframe or h.intraonly)
        if inter:
            h.use_last_frame_mvs &= (
                self.prev is not None and
                self.prev[0] == h.width and self.prev[1] == h.height)
        else:
            h.use_last_frame_mvs = False

        refs = []
        if inter:
            refs = [(r[0], r[1], r[2], r[3], r[4])
                    for r in (self.refs[h.refidx[i]]
                              for i in range(3))]
        prev_mv = None
        if h.use_last_frame_mvs:
            prev_mv = (self.prev[2], self.prev[3])
        fs = FrameState(h, probs, refs=refs, prev_mv=prev_mv)
        if self.device_recon and not self.native:
            from .recorder import ReconRecorder
            fs.recorder = ReconRecorder(fs)

        if h.refreshctx and h.parallelmode:
            self._store_ctx(h, probs)

        if self.native:
            # C++ tile walk (csrc/host/vp9_parse.cpp) + device replay
            from . import recon_tpu
            from .native_parse import parse_frame_native
            t0 = time.perf_counter()
            rec = parse_frame_native(fs, data, pos)
            t_parse = time.perf_counter()
            if self.capture is not None:
                self.capture.append((h, fs, rec))
            else:
                timer = (recon_tpu._Timer(self.device)
                         if self.stats is not None else None)
                recon_tpu.reconstruct(fs, rec, self.device, timer)
                t_lf = time.perf_counter()
                loopfilter_frame(fs)
                if timer is not None:
                    self.stats.append({
                        "keyframe": h.keyframe, "levels": rec.max_level,
                        "parse": (t_parse - t0) * 1e3,
                        **{k: v for k, v in timer.host.items()
                           if k != "start"},
                        "lf": (time.perf_counter() - t_lf) * 1e3,
                        "device": timer.device_ms(),
                        "h2d_bytes": timer.h2d_bytes,
                        "total": (time.perf_counter() - t0) * 1e3})
            if h.refreshctx and not h.parallelmode:
                adapt_probs(self.ctx[h.framectxid], h, fs.counts,
                            probs, self.last_keyframe)
            return self._finish(h, fs)

        n_tc = 1 << h.log2_tile_cols
        n_tr = 1 << h.log2_tile_rows
        for tr in range(n_tr):
            r0, r1 = tile_bounds(tr, h.log2_tile_rows, fs.sb_rows)
            walkers = []
            for tc in range(n_tc):
                if tr == n_tr - 1 and tc == n_tc - 1:
                    size = len(data) - pos
                else:
                    if pos + 4 > len(data):
                        raise InvalidData("vp9: truncated tile sizes")
                    size = int.from_bytes(data[pos:pos + 4], "big")
                    pos += 4
                if pos + size > len(data):
                    raise InvalidData("vp9: truncated tile")
                core = BoolDecoder(data[pos:pos + size])
                if core.get(128):
                    raise InvalidData("vp9: bad tile marker bit")
                pos += size
                c0, c1 = tile_bounds(tc, h.log2_tile_cols, fs.sb_cols)
                walkers.append(TileWalker(fs, core, tile_col_start=c0,
                                          tile_col_end=c1))
            for row in range(r0, min(r1, fs.rows), 8):
                for w in walkers:
                    fs.new_tile_left()
                    for col in range(w.tile_col_start,
                                     min(w.tile_col_end, fs.cols), 8):
                        w.decode_sb(row, col, 0)
        if fs.recorder is not None:
            from . import recon_tpu
            recon_tpu.reconstruct(fs, fs.recorder, self.device)
        loopfilter_frame(fs)

        if h.refreshctx and not h.parallelmode:
            adapt_probs(self.ctx[h.framectxid], h, fs.counts, probs,
                        self.last_keyframe)
        return self._finish(h, fs)

    def _finish(self, h, fs):
        """Reference refresh + decoder state."""
        entry = (fs.y, fs.u, fs.v, h.width, h.height)
        for i in range(8):
            if h.refreshrefmask & (1 << i):
                self.refs[i] = entry
        self.prev = (h.width, h.height, fs.mv_ref, fs.mv_xy)
        self.last_keyframe = h.keyframe
        self.last_invisible = not h.show_frame
        self.lf_deltas = (list(h.lf_ref_delta), list(h.lf_mode_delta))
        return h, (entry if h.show_frame else None)

    def _store_ctx(self, h, probs):
        """Parallel-mode context refresh: store the forward-updated
        working probs back into the frame context (vp9.c:1737)."""
        ctx = self.ctx[h.framectxid]
        for name, _ in ProbContext.FIELDS:
            getattr(ctx, name)[:] = getattr(probs, name)
        ctx.coef3[:min(h.txfmmode, 3) + 1] = \
            probs.coef3[:min(h.txfmmode, 3) + 1]


def decode_frame(data: bytes):
    """One-shot keyframe decode → (header, FrameState); kept for the
    crafted-stream tests that inspect decoder internals."""
    h = parse_uncompressed(data)
    pos = (h.uncompressed_bits + 7) // 8
    if pos + h.compressed_size > len(data):
        raise InvalidData("vp9: truncated compressed header")
    probs = parse_compressed(h, data[pos:pos + h.compressed_size])
    pos += h.compressed_size
    fs = FrameState(h, probs)
    n_tc = 1 << h.log2_tile_cols
    n_tr = 1 << h.log2_tile_rows
    for tr in range(n_tr):
        r0, r1 = tile_bounds(tr, h.log2_tile_rows, fs.sb_rows)
        walkers = []
        for tc in range(n_tc):
            if tr == n_tr - 1 and tc == n_tc - 1:
                size = len(data) - pos
            else:
                if pos + 4 > len(data):
                    raise InvalidData("vp9: truncated tile sizes")
                size = int.from_bytes(data[pos:pos + 4], "big")
                pos += 4
            if pos + size > len(data):
                raise InvalidData("vp9: truncated tile")
            core = BoolDecoder(data[pos:pos + size])
            if core.get(128):
                raise InvalidData("vp9: bad tile marker bit")
            pos += size
            c0, c1 = tile_bounds(tc, h.log2_tile_cols, fs.sb_cols)
            walkers.append(TileWalker(fs, core, tile_col_start=c0,
                                      tile_col_end=c1))
        for row in range(r0, min(r1, fs.rows), 8):
            for w in walkers:
                fs.new_tile_left()
                for col in range(w.tile_col_start,
                                 min(w.tile_col_end, fs.cols), 8):
                    w.decode_sb(row, col, 0)
    loopfilter_frame(fs)
    return h, fs


@register_decoder
class VP9Decoder(Codec):
    """VP9 decoder on `device`: frames carry the cropped y/u/v planes as
    uint8 tensors there.  Options: `native` (default on: the C++ parse
    and the device reconstruction), `device_recon` (with native off:
    the walker's records replayed on the device)."""
    codec_id = "vp9"
    codec_type = MediaType.VIDEO

    def __init__(self, par, options: Optional[dict] = None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = torch.device(device)
        # NB: `bool` here is the vp9.bool submodule (package-namespace
        # shadowing), so use truthiness directly
        self.core = VP9Core(
            device_recon=not not self.options.get("device_recon"),
            native=not not self.options.get("native", True),
            device=self.device)

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        out = []
        for sub in split_superframe(bytes(pkt.data)):
            h, planes = self.core.decode_frame(sub)
            if planes is None:
                continue
            y, u, v, W, H = planes
            Wc, Hc = (W + 1) >> 1, (H + 1) >> 1
            # the host's filtered planes, cropped, copied to the device
            planes = [torch.from_numpy(p.copy()).to(self.device)
                      for p in (y[:H, :W], u[:Hc, :Wc], v[:Hc, :Wc])]
            f = Frame.video(W, H, "yuv420p", planes=planes,
                            pts=pkt.pts if pkt else 0,
                            time_base=(pkt.time_base if pkt else None)
                            or Rational(1, 25))
            f.key_frame = h.keyframe
            out.append(f)
        return out
