"""The port's scaler (scale/ops.py, scale/swscale.py) against the
reference's: the same op lists from build_ops, and outputs within 1 LSB
on seeded planes (float32 sums in another order before floor(x + 0.5))."""

import dataclasses

import numpy as np
import pytest
import torch

from ffmpeg_tpu.scale import swscale as ref_sws
from ffmpeg_tpu_torch.scale import ops as port_ops
from ffmpeg_tpu_torch.scale import swscale as port_sws

SPECS = [
    dict(src_w=128, src_h=96, src_fmt="yuv420p", dst_w=64, dst_h=64,
         dst_fmt="rgb24", src_range=True),
    dict(src_w=96, src_h=64, src_fmt="yuv420p", dst_w=48, dst_h=32,
         dst_fmt="yuv420p", filter="bilinear"),
    dict(src_w=256, src_h=192, src_fmt="yuv420p", dst_w=64, dst_h=64,
         dst_fmt="rgb24", filter="lanczos", src_chroma_loc="left"),
    dict(src_w=128, src_h=96, src_fmt="rgb24", dst_w=64, dst_h=48,
         dst_fmt="yuv420p", dst_colorspace="bt709"),
    dict(src_w=96, src_h=64, src_fmt="yuv420p", dst_w=80, dst_h=48,
         dst_fmt="gray"),
    dict(src_w=128, src_h=96, src_fmt="yuv420p", dst_w=64, dst_h=64,
         dst_fmt="rgb24", dither="bayer"),
    dict(src_w=64, src_h=48, src_fmt="gray", dst_w=96, dst_h=64,
         dst_fmt="yuv420p", filter="area"),
]
IDS = [f"{s['src_fmt']}{s['src_w']}x{s['src_h']}-{s['dst_fmt']}"
       f"{s['dst_w']}x{s['dst_h']}-{s.get('filter', 'bicubic')}"
       f"{'-' + s['dither'] if 'dither' in s else ''}" for s in SPECS]


def _fields_equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_fields_equal, a, b))
    return a == b


@pytest.mark.parametrize("kw", SPECS, ids=IDS)
def test_build_ops_matches_reference(kw):
    ref = ref_sws.build_ops(ref_sws.ScaleSpec(**kw))
    port = port_sws.build_ops(port_sws.ScaleSpec(**kw))
    assert [type(o).__name__ for o in port] == [type(o).__name__ for o in ref]
    for r, p in zip(ref, port):
        if dataclasses.is_dataclass(r):
            for f in dataclasses.fields(r):
                assert _fields_equal(getattr(p, f.name), getattr(r, f.name)), \
                    (type(r).__name__, f.name)


def _planes(kw, n=2, seed=0):
    from ffmpeg_tpu.formats import pixfmt
    desc = pixfmt.get(kw["src_fmt"])
    rng = np.random.default_rng(seed)
    w, h = kw["src_w"], kw["src_h"]
    out = []
    for i in range(desc.nb_components):
        cw, ch = (desc.chroma_dims(w, h) if i in (1, 2) and not desc.is_rgb
                  else (w, h))
        # smooth content plus noise: resize filters see real edges
        yy, xx = np.mgrid[0:ch, 0:cw]
        base = 128 + 100 * np.sin(xx / (3 + i) + yy / 5.0)
        out.append(np.clip(base + rng.normal(0, 20, (n, ch, cw)), 0, 255)
                   .astype(np.uint8))
    return out


@pytest.mark.parametrize("kw", SPECS, ids=IDS)
def test_scaler_matches_reference(kw):
    planes = _planes(kw)
    want = [np.asarray(c) for c in ref_sws.Scaler(**kw).run(planes)]
    got = [c.numpy() for c in port_sws.Scaler("cpu", **kw).run(planes)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        d = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(),
                                                          (d > 0).mean())


def test_scale_frame_and_cached_scaler():
    from ffmpeg_tpu.core.frame import Frame
    kw = SPECS[0]
    planes = [p[0] for p in _planes(kw, n=1)]
    fr = Frame.video(kw["src_w"], kw["src_h"], "yuv420p", planes=planes)
    sc = port_sws.get_scaler("cpu", **kw)
    assert sc is port_sws.get_scaler(torch.device("cpu"), **kw)
    out = sc.scale_frame(fr)
    assert (out.width, out.height, out.format) == (64, 64, "rgb24")
    assert out.color_range == "pc" and out.color_space == "rgb"
    want = ref_sws.Scaler(**kw).scale_frame(fr)
    for g, w in zip(out.planes, want.planes):
        # the planes stay where the scaler ran, as the reference's do
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert np.abs(g.numpy().astype(int)
                      - np.asarray(w).astype(int)).max() <= 1


def test_resize_refuses_reduced_float32_precision():
    op = port_ops.ResizeAxis(-1, (np.eye(4)[:2],))
    x = torch.ones(3, 4)
    assert torch.equal(op.apply([x])[0], torch.ones(3, 2))
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full float32"):
            op.apply([x])
    finally:
        torch.set_float32_matmul_precision(prev)
