"""VP8 decoder (RFC 6386; reference: libavcodec/vp8.c).

Keyframes and inter frames: all intra modes, MV prediction with
split-MV, 6/4-tap sub-pel MC, golden/altref management, token
partitions, segmentation, normal + simple loop filters; validated
byte-exact against the reference decoder on crafted streams (block.py
walks in both directions).

The port's copy of ffmpeg_tpu/codecs/vp8/__init__.py, held equal to it by
tests/test_torch_vp8_webp.py.
The bool decoder, the macroblock walk, prediction, MC and the loop
filter stay on the host; the decoder puts each shown picture, copied
out of the reference buffers, on the device it is opened on with one
upload (device_planes).
"""

from __future__ import annotations

from typing import List, Optional

from ...core.frame import Frame, device_planes
from ...core.packet import Packet
from ...io.stream import MediaType
from ...utils.error import InvalidData
from ...utils.rational import Rational
from ..codec import DeviceCodec, register_decoder
from .block import FrameState, MBWalker
from .header import Probs, VP8Header, parse_header
from .lf import filter_level_for_mb, filter_mb, filter_mb_simple


class VP8Core:
    def __init__(self):
        self.probs_saved: Optional[Probs] = None
        self.header: Optional[VP8Header] = None
        self.refs = {}                    # 1/2/3 → (y, u, v)
        self.seg_map = None

    def decode_frame(self, data: bytes):
        h, probs, snapshot, c, parts = parse_header(
            bytes(data), self.probs_saved, self.header)
        if not h.keyframe and not self.refs:
            raise InvalidData("vp8: inter frame without references")
        fs = FrameState(h, probs, refs=self.refs)
        if self.seg_map is not None and \
                len(self.seg_map) == len(fs.seg_map):
            fs.seg_map[:] = self.seg_map
        w = MBWalker(fs, c, parts)
        for mb_y in range(fs.mb_h):
            fs.new_row()
            for mb_x in range(fs.mb_w):
                w.decode_mb(mb_x, mb_y)
        # loop filter (whole frame, MB raster)
        if h.filter_level:
            s = {"seg_enabled": h.seg_enabled,
                 "seg_absolute": h.seg_absolute,
                 "seg_filter_level": h.seg_filter_level,
                 "filter_level": h.filter_level,
                 "lf_delta_enabled": h.lf_delta_enabled,
                 "lf_ref_delta": h.lf_ref_delta,
                 "lf_mode_delta": h.lf_mode_delta,
                 "sharpness": h.sharpness}
            for mb_y in range(fs.mb_h):
                for mb_x in range(fs.mb_w):
                    mb = fs.mb_info[mb_y][mb_x]
                    lvl, il, inner = filter_level_for_mb(s, mb)
                    if h.filter_simple:
                        filter_mb_simple(fs.y, mb_x, mb_y, lvl, il,
                                         inner)
                    else:
                        filter_mb(fs.y, fs.u, fs.v, mb_x, mb_y, lvl,
                                  il, inner, h.keyframe)
        # reference updates (vp8.c ref_to_update semantics)
        entry = (fs.y, fs.u, fs.v)
        if h.keyframe:
            self.refs = {1: entry, 2: entry, 3: entry}
        else:
            old = dict(self.refs)
            ug, ua = h.update_golden, h.update_altref
            self.refs = dict(old)
            self.refs[2] = {4: entry, 1: old.get(1),
                            3: old.get(3)}.get(ug, old.get(2))
            self.refs[3] = {4: entry, 1: old.get(1),
                            2: old.get(2)}.get(ua, old.get(3))
            if h.update_last:
                self.refs[1] = entry
        self.probs_saved = probs if h.update_probabilities else \
            (snapshot or probs)
        self.header = h
        self.seg_map = fs.seg_map.copy()
        return h, fs


def decode_frame(data: bytes):
    return VP8Core().decode_frame(data)


@register_decoder
class VP8Decoder(DeviceCodec):
    codec_id = "vp8"
    codec_type = MediaType.VIDEO

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.core = VP8Core()

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            return []
        h, fs = self.core.decode_frame(bytes(pkt.data))
        if h.invisible:
            return []
        W, H = h.width, h.height
        f = Frame.video(W, H, "yuv420p",
                        planes=device_planes([
                            fs.y[:H, :W].copy(),
                            fs.u[:(H + 1) >> 1, :(W + 1) >> 1].copy(),
                            fs.v[:(H + 1) >> 1, :(W + 1) >> 1].copy()],
                            self.device),
                        pts=pkt.pts if pkt else 0,
                        time_base=(pkt.time_base if pkt else None)
                        or Rational(1, 25))
        f.key_frame = h.keyframe
        return [f]
