"""The port's device reconstruction program alone (recon_tpu.py), fed the
reference's own parse, on the CPU.

The reference's VP9Core(native=True) in capture mode parses each frame
with its C++ tile walk and hands back its FrameState and NativeRecord;
the port's prepare_native turns them into the port's argument buffers
(the one conversion function, where a model port would convert
weights), and the port's _recon_frame reconstructs the frame.  The
result is held byte-exact against the reference's pre-loop-filter
planes, taken from its host decode of the same stream; the host's
filtered planes then go into the captured frame's planes, so that the
next frame's DPB holds what the reference's decoder holds."""

import numpy as np
import pytest

import test_vp9 as K
import test_vp9_inter as I
from ffmpeg_tpu.codecs.vp9 import VP9Core as RefCore
from ffmpeg_tpu.codecs.vp9 import split_superframe
from ffmpeg_tpu_torch.codecs.vp9 import recon_tpu


def _host_states(frames):
    """(pre-filter planes, filtered planes) of every frame of the
    reference's host decode."""
    import ffmpeg_tpu.codecs.vp9 as V
    states = []
    real = V.loopfilter_frame

    def capture(fs):
        pre = (fs.y.copy(), fs.u.copy(), fs.v.copy())
        real(fs)
        states.append((pre, (fs.y.copy(), fs.u.copy(), fs.v.copy())))
    V.loopfilter_frame = capture
    try:
        core = RefCore()
        for f in frames:
            for sub in split_superframe(f):
                core.decode_frame(sub)
    finally:
        V.loopfilter_frame = real
    return states


def _check(frames):
    states = _host_states(frames)
    core = RefCore(native=True)
    core.capture = []
    n = 0
    for f in frames:
        for sub in split_superframe(f):
            core.decode_frame(sub)
            _h, fs, rec = core.capture[-1]
            (pre, post) = states[n]
            fn, args = recon_tpu.prepare_native(fs, rec)
            y, u, v = fn(args.to("cpu"))
            for pl, (a, b) in enumerate(zip(pre, (y, u, v))):
                np.testing.assert_array_equal(b.numpy(), a,
                                              err_msg=f"frame {n} plane {pl}")
            fs.y[:], fs.u[:], fs.v[:] = post
            n += 1
    assert n == len(states)


def test_keyframe_partial_sb_filtered():
    rng = np.random.default_rng(2)
    _check([K.craft_frame(K.Plan(rng), width=152, height=88,
                          filter_level=40)])


@pytest.mark.parametrize("seed", [3, 7])
def test_key_and_inter_frames_filtered(seed):
    rng = np.random.default_rng(seed)
    s = I.CraftSession(width=192, height=128)
    s.key(K.Plan(rng), filter_level=20)
    s.inter(I.InterPlan(rng, comp_p=0.5), signbias=(0, 0, 1),
            filter_level=36, sharpness=3)
    s.inter(I.InterPlan(rng, mv_amp=30), hp=True, filter_level=28)
    _check(s.frames)


def test_frame_args_have_no_padding():
    """The port builds no power-of-two padding: each class holds exactly
    its records, and the level plan covers every intra record once."""
    rng = np.random.default_rng(4)
    s = I.CraftSession()
    s.key(K.Plan(rng))
    s.inter(I.InterPlan(rng))
    core = RefCore(native=True)
    core.capture = []
    for f in s.frames:
        core.decode_frame(f)
    for _h, fs, rec in core.capture:
        _fn, fa = recon_tpu.prepare_native(fs, rec)
        assert [(c, k) for c, k, *_ in fa.mc] == \
            [(c, len(a)) for c, a in rec.mc_arr.items() if len(a)]
        assert [(c, k) for c, k, *_ in fa.tu] == \
            [(c, len(m)) for c, (m, _) in rec.tu_arr.items() if len(m)]
        for cls, k, _off, _coff, plan, _kc, _kr in fa.intra:
            spans = [(p[0], p[1]) for p in plan if p is not None]
            assert spans[0][0] == 0 and spans[-1][1] == k
            assert all(b0 == a1 for (_a0, b0), (a1, _b1)
                       in zip(spans, spans[1:]))
            assert len(plan) == rec.max_level
        assert (fa.dpb_y is None) == (not fa.mc)


@pytest.mark.parametrize("chroma", [False, True])
def test_put_drops_writes_outside_the_plane(chroma):
    """_put, the port of `.at[...].set(..., mode="drop")`: the elements
    of a block that fall outside the plane are dropped, and nothing else
    of the plane changes, whether or not the caller vouched that every
    block lies inside."""
    import torch
    P = torch.full((2, 8, 8) if chroma else (8, 8), 7, dtype=torch.int32)
    want = P.clone()
    py = torch.tensor([0, 6, 5], dtype=torch.int32)
    px = torch.tensor([6, 1, 4], dtype=torch.int32)
    cpl = torch.tensor([1, 0, 1], dtype=torch.int32) if chroma else None
    ii = torch.arange(4)
    vals = torch.arange(3 * 16, dtype=torch.int32).view(3, 4, 4)
    for k in range(3):
        for i in range(4):
            for j in range(4):
                r, c = int(py[k]) + i, int(px[k]) + j
                if r < 8 and c < 8:
                    idx = (int(cpl[k]), r, c) if chroma else (r, c)
                    want[idx] = vals[k, i, j]
    recon_tpu._put(P, py[:, None] + ii, px[:, None] + ii, vals, cpl,
                   inside=False)
    assert torch.equal(P, want)
    Q = torch.zeros_like(P)
    recon_tpu._put(Q, py[2:][:, None] + ii - 4, px[2:][:, None] + ii - 4,
                   vals[2:], None if cpl is None else cpl[2:], inside=True)
    assert int(Q.sum()) == int(vals[2].sum())
