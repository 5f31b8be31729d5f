"""The port's wavefront loop filter (ffmpeg_tpu_torch/codecs/vp9/lf_wave.py)
against the reference's host filter (ffmpeg_tpu/codecs/vp9/lf.py), on the
CPU, bit-exact.

loopfilter_wavefront runs on the pre-filter states of crafted frames with
real reconstruction state, taken from the port's own decoder as
tests/test_torch_vp9_lf.py takes them: the four cases of
tests/test_vp9_lf_wave.py (a keyframe at level 32; 192x128 at level 24,
sharpness 2; 152x88 with partial superblocks at level 40; inter frames at
levels 20/36), a sharpness-3 frame, and a level-0 frame, which comes back
unchanged.  `_schedule` equals the reference's on several superblock
grids, 1080p's 17x30 among them (62 steps, d = 0 .. 2*16 + 29; the
reference's docstring says 61).  The reference's jitted
loopfilter_wavefront runs on one case only, a single 64x64 superblock:
XLA compiles its unrolled step body for every new shape (45.8 s at
152x88 on the CPU)."""

import copy

import numpy as np
import pytest
import torch

import test_vp9 as K
import test_vp9_inter as I
from ffmpeg_tpu.codecs.vp9 import lf as ref_lf
from ffmpeg_tpu.codecs.vp9 import lf_wave as ref_wave
from ffmpeg_tpu_torch.codecs.vp9.lf_tpu import _luts
from ffmpeg_tpu_torch.codecs.vp9.lf_wave import _schedule, loopfilter_wavefront
from ffmpeg_tpu_torch.utils.error import InvalidData
from test_torch_vp9_lf import _pre_lf_states


def _args(fs):
    """loopfilter_wavefront's arguments after the planes, as
    tests/test_vp9_lf_wave.py builds them."""
    h = fs.h
    lim, mblim = _luts(h.sharpness)
    lvl8 = np.zeros((fs.sb_rows * 8, fs.sb_cols * 8), np.int32)
    if h.filter_level:
        lvl8[:fs.rows, :fs.cols] = fs.lf_lvl
    pw, ph = fs.cols * 8, fs.rows * 8
    return (fs.wd_v, fs.wd_h, fs.wd_v_uv, fs.wd_h_uv, lvl8, lim, mblim,
            fs.sb_rows, fs.sb_cols, (pw >> 2, ph >> 2, pw >> 3, ph >> 3))


def _wave(y0, u0, v0, fs):
    out = loopfilter_wavefront(*(torch.from_numpy(p) for p in (y0, u0, v0)),
                               *_args(fs))
    assert all(p.dtype == torch.int32 for p in out)
    return [p.numpy() for p in out]


def _frames(case):
    if case == "inter":
        rng = np.random.default_rng(3)
        s = I.CraftSession(width=192, height=128)
        s.key(K.Plan(rng), filter_level=20)
        for _ in range(2):
            s.inter(I.InterPlan(rng), filter_level=36)
        return s.frames
    seed, kw = {
        "kf": (0, dict(filter_level=32)),
        "kf_multi_sb": (1, dict(width=192, height=128, filter_level=24,
                                sharpness=2)),
        "partial_sb": (2, dict(width=152, height=88, filter_level=40)),
        "sharpness3": (4, dict(width=192, height=128, filter_level=48,
                               sharpness=3)),
    }[case]
    return [K.craft_frame(K.Plan(np.random.default_rng(seed)), **kw)]


@pytest.mark.parametrize("case", ["kf", "kf_multi_sb", "partial_sb",
                                  "inter", "sharpness3"])
def test_wavefront_matches_host_filter(case):
    n = 0
    for y0, u0, v0, fs in _pre_lf_states(_frames(case)):
        if not fs.h.filter_level:
            continue
        ref = copy.copy(fs)
        ref.y, ref.u, ref.v = y0.copy(), u0.copy(), v0.copy()
        ref_lf.loopfilter_frame(ref)
        assert any(not np.array_equal(a, b) for a, b in
                   zip((y0, u0, v0), (ref.y, ref.u, ref.v))), \
            "the filter changed nothing"
        for name, a, b in zip("yuv", (ref.y, ref.u, ref.v),
                              _wave(y0, u0, v0, fs)):
            np.testing.assert_array_equal(b, a, err_msg=name)
        n += 1
    assert n


def test_level_zero_leaves_planes():
    rng = np.random.default_rng(6)
    (y0, u0, v0, fs), = _pre_lf_states([K.craft_frame(
        K.Plan(rng), width=192, height=128)])
    assert fs.h.filter_level == 0 and (fs.wd_v > 0).any()
    for a, b in zip((y0, u0, v0), _wave(y0, u0, v0, fs)):
        np.testing.assert_array_equal(b, a)


def test_planes_must_be_tensors():
    """Numpy planes, alone or beside a tensor, raise InvalidData: the
    filter never picks a device for the caller."""
    rng = np.random.default_rng(3)
    (y0, u0, v0, fs), = _pre_lf_states([K.craft_frame(K.Plan(rng),
                                                      filter_level=32)])
    for planes in ((y0, u0, v0), (torch.from_numpy(y0), u0, v0)):
        with pytest.raises(InvalidData, match="must be tensors"):
            loopfilter_wavefront(*planes, *_args(fs))


@pytest.mark.parametrize("rows,cols", [(1, 1), (1, 5), (2, 3), (4, 2),
                                       (17, 30), (5, 1)])
def test_schedule_matches_reference(rows, cols):
    got, want = _schedule(rows, cols), ref_wave._schedule(rows, cols)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    if (rows, cols) == (17, 30):
        assert got[0].shape[0] == 62


def test_matches_reference_wavefront_one_sb():
    """The reference's own jitted loopfilter_wavefront, on one 64x64
    superblock (keyframe, level 32)."""
    rng = np.random.default_rng(0)
    (y0, u0, v0, fs), = _pre_lf_states([K.craft_frame(K.Plan(rng),
                                                      filter_level=32)])
    args = _args(fs)
    want = ref_wave.loopfilter_wavefront(y0, u0, v0, *args[:5],
                                         np.asarray(args[5]),
                                         np.asarray(args[6]), *args[7:])
    for a, b in zip(want, _wave(y0, u0, v0, fs)):
        np.testing.assert_array_equal(b, np.asarray(a))
