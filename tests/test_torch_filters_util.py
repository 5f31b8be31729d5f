"""Shared helpers for the filter tests of the port
(test_torch_filters_video2.py, _video34.py, _video8.py, _host.py): the
same seeded frames (ffmpeg_tpu_torch.testing.filter_clip) through both
packages' parse_graph, the port on the CPU, and the comparisons under
the bars the test files state.  It holds no test of its own."""

from __future__ import annotations

import numpy as np
import torch

from ffmpeg_tpu.core.frame import Frame as RefFrame
from ffmpeg_tpu.filters import parse_graph as ref_parse_graph
from ffmpeg_tpu.utils.rational import Rational as RefRational
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.filters import parse_graph
from ffmpeg_tpu_torch.testing import filter_clip, run_graph
from ffmpeg_tpu_torch.utils.rational import Rational

SIZES = [(64, 48), (37, 23)]
SIZE_IDS = ["64x48", "37x23"]


def frames_both(fmt: str, n: int, w: int, h: int, seed: int = 0,
                interlaced: bool = False, lead: int = 0):
    """(reference frames, port frames) of the same seeded planes, pts k
    in 1/25, duration 1; with `lead` each frame's planes stack `lead`
    consecutive clip frames (a leading batch dim)."""
    clip = filter_clip(seed, n * max(1, lead), w, h, fmt, interlaced)
    if lead:
        clip = [[np.stack([clip[k * lead + j][i] for j in range(lead)])
                 for i in range(len(clip[0]))] for k in range(n)]
    ref, port = [], []
    for k, planes in enumerate(clip):
        kw = dict(pts=k, duration=1, interlaced=interlaced,
                  top_field_first=interlaced)
        ref.append(RefFrame.video(w, h, fmt, planes=planes,
                                  time_base=RefRational(1, 25), **kw))
        port.append(Frame.video(w, h, fmt, planes=planes,
                                time_base=Rational(1, 25), **kw))
    return ref, port


def run_both(text: str, feeds: dict, outs=("out",), eof_early=()):
    """Both packages' graphs of `text` over feeds {label: (ref frames,
    port frames)}; returns ({out: ref frames}, {out: port frames}, ref
    graph, port graph)."""
    ref_g, port_g = ref_parse_graph(text), parse_graph(text, device="cpu")
    assert [nd.filter.name for nd in port_g.nodes] == \
        [nd.filter.name for nd in ref_g.nodes]
    want = run_graph(ref_g, {k: v[0] for k, v in feeds.items()}, list(outs),
                     eof_early)
    got = run_graph(port_g, {k: v[1] for k, v in feeds.items()}, list(outs),
                    eof_early)
    return want, got, ref_g, port_g


def same_props(r, p) -> None:
    assert (p.width, p.height, p.format, p.pts, p.duration, p.interlaced,
            p.top_field_first, p.color_range, p.color_space,
            p.side_data.get("plane")) == \
        (r.width, r.height, r.format, r.pts, r.duration, r.interlaced,
         r.top_field_first, r.color_range, r.color_space,
         r.side_data.get("plane"))
    assert (p.time_base.num, p.time_base.den) == (r.time_base.num,
                                                  r.time_base.den)
    assert (p.sample_aspect_ratio.num, p.sample_aspect_ratio.den) == \
        (r.sample_aspect_ratio.num, r.sample_aspect_ratio.den)


def port_planes(frame, device="cpu") -> list:
    """The port frame's planes as host arrays of the reference's types,
    after checking that they lie on `device`."""
    for p in frame.planes:
        assert isinstance(p, torch.Tensor) and p.device.type == device, p
    return frame.numpy().planes


def plane_diff(got: np.ndarray, want: np.ndarray):
    """(max |diff|, share of samples that differ) of two planes of one
    type and shape."""
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, want.dtype, got.shape, want.shape)
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return float(d.max()) if d.size else 0.0, float((d > 0).mean()) \
        if d.size else 0.0


def check_frames(want: list, got: list, bar: str) -> dict:
    """Each port frame against the reference's: props exact, planes
    under `bar`: "exact", "lsb" (integer samples within 1 on <= 1% of
    each plane) or "rel" (float samples within 1e-6 relative to the
    plane's largest magnitude).  Returns the worst (max, share) seen."""
    assert len(got) == len(want) > 0, (len(got), len(want))
    worst = [0.0, 0.0]
    for r, p in zip(want, got):
        same_props(r, p)
        rp = [np.asarray(x) for x in r.planes]
        pp = port_planes(p)
        assert len(pp) == len(rp)
        for a, b in zip(pp, rp):
            m, share = plane_diff(a, b)
            worst = [max(worst[0], m), max(worst[1], share)]
            if bar == "exact":
                assert m == 0, (m, share)
            elif bar == "lsb":
                assert m <= 1 and share <= 0.01, (m, share)
            else:
                scale = max(1.0, float(np.abs(b).max()))
                assert m <= 1e-6 * scale, (m, scale)
    return {"max": worst[0], "share": worst[1]}
