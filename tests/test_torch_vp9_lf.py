"""The port's device loop filter (ffmpeg_tpu_torch/codecs/vp9/lf_tpu.py)
against the reference's host filter (ffmpeg_tpu/codecs/vp9/lf.py), on
the CPU, bit-exact.

loopfilter_frame_tpu runs on the pre-filter states of crafted frames
with real reconstruction state, taken as tests/test_vp9_lf_wave.py
takes them (here from the port's own decoder, whose reconstruction the
other test files hold to the reference), at several filter levels and
sharpness 0 and 3, with partial superblocks.  edge_filter runs alone on
random slabs against the host filter's per-line code, with the flat
conditions made likely, at every width."""

import copy

import numpy as np
import pytest
import torch

import test_vp9 as K
import test_vp9_inter as I
from ffmpeg_tpu.codecs.vp9 import lf as ref_lf
from ffmpeg_tpu_torch.codecs.vp9 import VP9Core, split_superframe
from ffmpeg_tpu_torch.codecs.vp9.lf_tpu import (_luts, edge_filter,
                                                loopfilter_frame_tpu)


def _pre_lf_states(frames):
    """Decode with the port on the CPU, capturing each frame's
    pre-loop-filter planes and state."""
    import ffmpeg_tpu_torch.codecs.vp9 as V
    states = []
    real = V.loopfilter_frame

    def capture(fs):
        states.append((fs.y.copy(), fs.u.copy(), fs.v.copy(), fs))
        real(fs)
    V.loopfilter_frame = capture
    try:
        core = VP9Core(native=True, device="cpu")
        for f in frames:
            for sub in split_superframe(f):
                core.decode_frame(sub)
    finally:
        V.loopfilter_frame = real
    return states


def _check(frames):
    n = 0
    for y0, u0, v0, fs in _pre_lf_states(frames):
        if not fs.h.filter_level:
            continue
        ref = copy.copy(fs)
        ref.y, ref.u, ref.v = y0.copy(), u0.copy(), v0.copy()
        ref_lf.loopfilter_frame(ref)
        dev = copy.copy(fs)
        dev.y, dev.u, dev.v = y0.copy(), u0.copy(), v0.copy()
        out = loopfilter_frame_tpu(dev, "cpu")
        assert any(not np.array_equal(a, b) for a, b in
                   zip((y0, u0, v0), (ref.y, ref.u, ref.v))), \
            "the filter changed nothing"
        for name, a, b, t in zip("yuv", (ref.y, ref.u, ref.v),
                                 (dev.y, dev.u, dev.v), out):
            np.testing.assert_array_equal(b, a, err_msg=name)
            np.testing.assert_array_equal(t.numpy(), a, err_msg=name)
        n += 1
    assert n


def test_keyframe_level32():
    rng = np.random.default_rng(0)
    _check([K.craft_frame(K.Plan(rng), filter_level=32)])


def test_keyframe_multi_sb_sharpness3():
    rng = np.random.default_rng(1)
    _check([K.craft_frame(K.Plan(rng), width=192, height=128,
                          filter_level=24, sharpness=3)])


@pytest.mark.parametrize("level,sharp", [(40, 0), (63, 3), (8, 0)])
def test_partial_sb(level, sharp):
    rng = np.random.default_rng(2)
    _check([K.craft_frame(K.Plan(rng), width=152, height=88,
                          filter_level=level, sharpness=sharp)])


def test_inter_frames():
    rng = np.random.default_rng(3)
    s = I.CraftSession(width=192, height=128)
    s.key(K.Plan(rng), filter_level=20)
    for level, sharp in ((36, 3), (52, 0)):
        s.inter(I.InterPlan(rng), filter_level=level, sharpness=sharp)
    _check(s.frames)


def test_level_zero_leaves_planes():
    rng = np.random.default_rng(6)
    frames = [K.craft_frame(K.Plan(rng))]
    (y0, u0, v0, fs), = _pre_lf_states(frames)
    assert loopfilter_frame_tpu(fs, "cpu") is None
    assert np.array_equal(fs.y, y0)


@pytest.mark.parametrize("wd", [4, 8, 16])
@pytest.mark.parametrize("sharp", [0, 3])
def test_edge_filter_matches_host(wd, sharp):
    rng = np.random.default_rng(wd * 10 + sharp)
    N = 512
    base = rng.integers(0, 256, (N, 1))
    # small steps so that the flat conditions hold on many lines
    slab = np.clip(base + rng.integers(-2, 3, (N, 16)) * rng.integers(
        0, 3, (N, 1)) + (rng.integers(-40, 41, (N, 1))
                         * (np.arange(16) >= 8)), 0, 255)
    # the host filter takes one level per 4-line segment
    lvl = np.repeat(rng.integers(0, 64, N // 4), 4)
    lim, mblim = _luts(sharp)
    gate = np.repeat(rng.random(N // 4) < 0.9, 4) & (lvl > 0)
    want = slab.copy()
    for g in range(N // 4):
        i = 4 * g
        if not gate[i]:
            continue
        seg = want[i:i + 4]
        ref_lf._filter_edge(
            None, lambda j, k: int(seg[j, 8 + k]),
            lambda j, k, v: seg.__setitem__((j, 8 + k), v),
            int(mblim[lvl[i]]), int(lim[lvl[i]]), int(lvl[i]) >> 4, wd)
    t = torch.from_numpy
    got = edge_filter(t(slab.astype(np.int32)), t(mblim[lvl]), t(lim[lvl]),
                      t((lvl >> 4).astype(np.int32)),
                      torch.full((N,), wd, dtype=torch.int32), t(gate))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != slab).any(axis=1).mean() > 0.3
