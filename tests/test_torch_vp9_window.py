"""The port's windowed VP9 decoder (ffmpeg_tpu_torch/models/vp9_tpu.py)
against the reference's host decoder, byte-exact, on the CPU.

Vp9TpuDecoder(device="cpu").decode(frames, emit_planes=True) runs the C++
parse of the whole window, then per frame the reconstruction against the
8-slot DPB on the device (zero at the start of each call, as the
reference's; MC reads it in place), the wavefront loop filter and the
refresh of the flagged slots.  Every frame is checked only after the
whole window has decoded, as tests/test_vp9_tpu.py checks the
reference's: a plane emitted as a view of a DPB slot that a later frame
overwrites would fail here.  The streams are tests/test_vp9_tpu.py's
three windows, one whose inter frames refresh the slots they read, one
cut into two windows that each open with a keyframe, and the committed
96x72 crafted stream against the
reference's hashes; the reference's jitted windowed decoder is not run
(XLA compiles a program per window shape).  `_mc_tiles` on a DPB laid
out as the decoder keeps it is held equal to the reference's, with
windows far past the frame's edges."""

import numpy as np
import pytest
import torch

import test_vp9 as K
import test_vp9_inter as I
from ffmpeg_tpu_torch.codecs.vp9.recon_tpu import _mc_tiles
from ffmpeg_tpu_torch.io.ivf import read_ivf
from ffmpeg_tpu_torch.models.vp9_tpu import Vp9TpuDecoder, checksum
from ffmpeg_tpu_torch.testing import (VP9_BENCH, VP9_GOLDEN, VP9_LF_GOLDEN,
                                      VP9_SMALL, plane_sha256)
from ffmpeg_tpu_torch.utils.error import NotSupported
from test_torch_vp9 import _reference


def _check(frames, windows=(None,)):
    """Decode `frames` in the given windows (slices) on one decoder and
    compare every frame with the reference's host decode."""
    want = _reference(frames)
    dec = Vp9TpuDecoder(device="cpu")
    got = []
    for w in windows:
        got += dec.decode(frames[w] if w else frames, emit_planes=True)
    assert len(got) == len(want)
    for i, (fw, g) in enumerate(zip(want, got)):
        for pl, (a, b) in enumerate(zip(fw.planes, g)):
            assert isinstance(b, torch.Tensor) and b.dtype == torch.uint8
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"frame {i} plane {pl}")


def _window(name):
    if name == "kf_lf":
        rng = np.random.default_rng(0)
        return [K.craft_frame(K.Plan(rng), filter_level=24)]
    s = I.CraftSession()
    if name == "inter_lf":
        rng = np.random.default_rng(3)
        s.key(K.Plan(rng), filter_level=20)
        for _ in range(3):
            s.inter(I.InterPlan(rng), filter_level=28)
    elif name == "mixed":
        rng = np.random.default_rng(5)
        s.key(K.Plan(rng, skip_p=0.8), filter_level=12)
        s.inter(I.InterPlan(rng, skip_p=0.9, inter_p=1.0))
        s.inter(I.InterPlan(rng, skip_p=0.2, newmv_p=0.6), filter_level=40)
    return s.frames


@pytest.mark.parametrize("name", ["kf_lf", "inter_lf", "mixed"])
def test_reference_windows(name):
    _check(_window(name))


def _refreshing_stream():
    """Inter frames that refresh a slot their own MC reads, with partial
    masks, so that the slots diverge and later frames read older ones."""
    rng = np.random.default_rng(7)
    s = I.CraftSession(width=128, height=64)
    s.key(K.Plan(rng), filter_level=16)
    s.inter(I.InterPlan(rng, comp_p=0.0), refresh=0x01, refidx=(0, 1, 2),
            filter_level=30)
    s.inter(I.InterPlan(rng), refresh=0x02, refidx=(0, 0, 2))
    s.inter(I.InterPlan(rng), refresh=0x01, refidx=(1, 0, 2),
            filter_level=22)
    s.inter(I.InterPlan(rng), refresh=0x05, refidx=(2, 1, 0))
    return s.frames


def test_refresh_of_a_read_slot():
    _check(_refreshing_stream())


def _keyframe_windows():
    """Two windows, each opening with a keyframe, the second's inter
    frames refreshing and reading partial slots."""
    rng = np.random.default_rng(9)
    s = I.CraftSession(width=128, height=64)
    s.key(K.Plan(rng), filter_level=16)
    s.inter(I.InterPlan(rng), refresh=0x01, refidx=(0, 1, 2),
            filter_level=30)
    s.key(K.Plan(rng), filter_level=8)
    s.inter(I.InterPlan(rng), refresh=0x02, refidx=(0, 0, 2))
    s.inter(I.InterPlan(rng), refresh=0x01, refidx=(1, 0, 2),
            filter_level=22)
    return s.frames


def test_windows_share_the_dpb():
    """Each decode() call starts from a zero DPB, as the reference's
    (ffmpeg_tpu/models/vp9_tpu.py:208-209), while the parse state
    carries on: a stream cut into windows that each open with a keyframe
    decodes as the reference's host decoder decodes it whole."""
    _check(_keyframe_windows(), windows=(slice(0, 2), slice(2, None)))


def test_each_decode_starts_from_a_zero_dpb():
    """The DPB seen by the first frame of a second decode() call on the
    same instance is all zero, though the first call filled slots."""
    frames = _keyframe_windows()
    dec = Vp9TpuDecoder(device="cpu")
    dec.decode(frames[:2], emit_planes=True)
    assert int(dec.dpb_y.count_nonzero()) > 0
    seen = []
    step = dec._step

    def first_step(*a):
        if not seen:
            seen.append((int(dec.dpb_y.count_nonzero()),
                         int(dec.dpb_c.count_nonzero())))
        return step(*a)
    dec._step = first_step
    dec.decode(frames[2:], emit_planes=True)
    assert seen == [(0, 0)]


def test_checksum_path():
    """emit_planes=False gives the reference's checksum of each frame
    (a 192x128 stream, so the checksum's lattice lies inside the crop)."""
    rng = np.random.default_rng(3)
    s = I.CraftSession(width=192, height=128)
    s.key(K.Plan(rng), filter_level=20)
    s.inter(I.InterPlan(rng), filter_level=36)
    planes = Vp9TpuDecoder(device="cpu").decode(s.frames, emit_planes=True)
    sums = Vp9TpuDecoder(device="cpu").decode(s.frames)
    assert len(sums) == len(planes) == 2
    for (y, u, _v), c in zip(planes, sums):
        assert c.dim() == 0 and int(c) == int(checksum(y, u))
        assert int(c) == int(y.numpy()[::97, ::101].astype(np.int64).sum()
                             + u.numpy()[::53, ::59].astype(np.int64).sum())


def test_committed_small_stream_matches_golden():
    _par, _tb, pkts = read_ivf(VP9_SMALL.read_bytes())
    gold = np.load(VP9_LF_GOLDEN)["small"]
    stats = {}
    got = Vp9TpuDecoder(device="cpu").decode([p.data for p in pkts],
                                             emit_planes=True, stats=stats)
    assert [[plane_sha256(p) for p in f] for f in got] == gold.tolist()
    assert stats["frames"] == len(gold)
    assert {"parse_s", "build_s", "device_s"} <= set(stats)


def test_bench_first_frames_match_golden():
    """Frames 0-1 of the committed 1920x1080 stream (the keyframe and an
    inter frame with the real MVs) against the reference's hashes."""
    _par, _tb, pkts = read_ivf(VP9_BENCH.read_bytes())
    gold = np.load(VP9_GOLDEN)["hashes"]
    got = Vp9TpuDecoder(device="cpu").decode([p.data for p in pkts[:2]],
                                             emit_planes=True)
    assert [[plane_sha256(p) for p in f] for f in got] == gold[:2].tolist()


def test_geometry_is_fixed_per_instance():
    dec = Vp9TpuDecoder(device="cpu")
    dec.decode([K.craft_frame(K.Plan(np.random.default_rng(0)))])
    with pytest.raises(NotSupported):
        dec.decode([K.craft_frame(K.Plan(np.random.default_rng(0)),
                                  width=128, height=64)])


@pytest.mark.parametrize("luma", [True, False])
def test_mc_reads_the_resident_dpb_past_its_edges(luma):
    """The window's MC reads the 8-slot DPB it keeps on the device in
    place (SB-padded planes, chroma slots folded with the plane): the
    port's _mc_tiles equals the reference's on it, with windows far past
    every edge of the frame, where each coordinate clamps to the display
    dims and never reads the SB padding."""
    import jax.numpy as jnp
    from ffmpeg_tpu.codecs.vp9 import recon_tpu as ref_rt
    rng = np.random.default_rng(11)
    H, W, dh, dw = 128, 128, 70, 90
    if luma:
        dpb = rng.integers(0, 256, (8, H, W), np.uint8)
        shift, ph, pw = 3, dh, dw
    else:
        dpb = rng.integers(0, 256, (8, 2, H // 2, W // 2),
                           np.uint8).reshape(16, H // 2, W // 2)
        shift, ph, pw = 4, (dh + 1) // 2, (dw + 1) // 2
    unit, K = 1 << shift, 64
    for t in (8, 4):
        dy = rng.integers(0, -(-ph // t), K) * t
        dx = rng.integers(0, -(-pw // t), K) * t
        mv = rng.integers(-300 * unit, 300 * unit, (4, K))
        for k, (sy, sx) in enumerate(((-1, -1), (-1, 1), (1, -1), (1, 1))):
            mv[0:2, k] = (sx * 300 * unit + k, sy * 300 * unit + k)
        args = np.stack([dy, dx, mv[0], mv[1], rng.integers(0, len(dpb), K),
                         mv[2], mv[3], rng.integers(0, len(dpb), K),
                         rng.integers(0, 2, K), rng.integers(0, 4, K)]
                        ).astype(np.int32)
        got = _mc_tiles(torch.from_numpy(dpb), pw, ph, t, shift,
                        tuple(torch.from_numpy(r) for r in args))
        want = ref_rt._mc_tiles(jnp, jnp.asarray(dpb), pw, ph, t, shift,
                                tuple(jnp.asarray(r) for r in args))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
