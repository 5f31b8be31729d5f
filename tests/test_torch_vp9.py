"""The port's VP9 decoder (ffmpeg_tpu_torch/codecs/vp9/) against the
reference's host decoder, byte-exact, on the CPU.

The reference's VP9Decoder with no options (the Python walker with
inline host reconstruction and the host loop filter) runs in the same
process as the oracle.  The port runs through
CodecContext.open_decoder(..., device="cpu"): on its default path (the
C++ tile parse, then recon_tpu on the device), and on the walker path
with its records replayed on the device (native=False,
device_recon=True).  The streams are the crafted ones of
tests/test_vp9_recon_tpu.py, built the same way, and, with the loop
filter on, the three sequences of tests/test_vp9_tpu.py.  Frames 0-2 of
the committed 1080p stream are held against the reference's golden
(tools/gen_torch_vp9_fixture.py)."""

import numpy as np
import pytest
import torch

import test_vp9 as K
import test_vp9_inter as I
from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io.stream import CodecParameters as RefParameters
from ffmpeg_tpu.io.stream import MediaType as RefMediaType
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.io.ivf import read_ivf
from ffmpeg_tpu_torch.testing import (VP9_BENCH, VP9_GOLDEN, plane_sha256,
                                      vp9_decode, vp9_golden_planes)

PATHS = {"native": None, "walker_device": {"native": False,
                                           "device_recon": True}}


def _reference(frames):
    d = RefContext.open_decoder(RefParameters(
        codec_type=RefMediaType.VIDEO, codec_id="vp9"))
    return d.decode_all([RefPacket(data=f, pts=i)
                         for i, f in enumerate(frames)])


def _check(frames, paths=("native", "walker_device")):
    want = _reference(frames)
    assert want
    for path in paths:
        got = vp9_decode([Packet(data=f, pts=i) for i, f in enumerate(frames)],
                         "cpu", PATHS[path])
        assert len(got) == len(want), path
        for i, (fw, fg) in enumerate(zip(want, got)):
            assert (fg.width, fg.height, fg.key_frame) == \
                (fw.width, fw.height, fw.key_frame)
            for pl, (a, b) in enumerate(zip(fw.planes, fg.planes)):
                assert isinstance(b, torch.Tensor) and b.dtype == torch.uint8
                assert b.device.type == "cpu"
                np.testing.assert_array_equal(
                    b.numpy(), np.asarray(a),
                    err_msg=f"{path} frame {i} plane {pl}")


@pytest.mark.parametrize("seed", [0, 3])
def test_keyframe(seed):
    rng = np.random.default_rng(seed)
    _check([K.craft_frame(K.Plan(rng))])


def test_keyframe_tx_sizes():
    rng = np.random.default_rng(1)
    _check([K.craft_frame(K.Plan(rng), txmode=1)])


def test_keyframe_partial_sb():
    rng = np.random.default_rng(2)
    _check([K.craft_frame(K.Plan(rng), width=152, height=88)])


def test_keyframe_tiles():
    rng = np.random.default_rng(4)
    _check([K.craft_frame(K.Plan(rng), width=512, height=128,
                          tile_cols_log2=1)])


@pytest.mark.parametrize("seed", [0, 9])
def test_inter(seed):
    rng = np.random.default_rng(seed)
    s = I.CraftSession()
    s.key(K.Plan(rng))
    for _ in range(3):
        s.inter(I.InterPlan(rng), errorres=True)
    _check(s.frames)


def test_inter_compound():
    rng = np.random.default_rng(7)
    s = I.CraftSession()
    s.key(K.Plan(rng))
    for _ in range(2):
        s.inter(I.InterPlan(rng, comp_p=0.5), signbias=(0, 0, 1),
                errorres=True)
    _check(s.frames)


def test_inter_high_precision_mvs():
    rng = np.random.default_rng(5)
    s = I.CraftSession()
    s.key(K.Plan(rng))
    s.inter(I.InterPlan(rng, mv_amp=30), hp=True, errorres=True)
    _check(s.frames)


@pytest.mark.parametrize("fm", [0, 1, 2, 3])
def test_inter_filter_modes(fm):
    rng = np.random.default_rng(20 + fm)
    s = I.CraftSession()
    s.key(K.Plan(rng))
    s.inter(I.InterPlan(rng), filtermode=fm, errorres=True)
    _check(s.frames)


def test_loop_filter_keyframe():
    rng = np.random.default_rng(0)
    _check([K.craft_frame(K.Plan(rng), filter_level=24)])


def test_loop_filter_inter():
    rng = np.random.default_rng(3)
    s = I.CraftSession()
    s.key(K.Plan(rng), filter_level=20)
    for _ in range(3):
        s.inter(I.InterPlan(rng), filter_level=28)
    _check(s.frames)


def test_loop_filter_mixed_density():
    rng = np.random.default_rng(5)
    s = I.CraftSession()
    s.key(K.Plan(rng, skip_p=0.8), filter_level=12)
    s.inter(I.InterPlan(rng, skip_p=0.9, inter_p=1.0))
    s.inter(I.InterPlan(rng, skip_p=0.2, newmv_p=0.6), filter_level=40)
    _check(s.frames)


def test_adaptation_chain_without_error_resilience():
    """Backward adaptation across 4 frames: the C++ parse's counts feed
    the port's adapt_probs."""
    rng = np.random.default_rng(9)
    s = I.CraftSession()
    s.key(K.Plan(rng))
    for _ in range(3):
        s.inter(I.InterPlan(rng))
    _check(s.frames, paths=("native",))


def test_host_walker_option_is_the_oracle():
    """native=False: the port's copy of the Python walker, reconstructing
    inline on the host, as the reference's default decoder does."""
    rng = np.random.default_rng(11)
    s = I.CraftSession()
    s.key(K.Plan(rng), filter_level=16)
    s.inter(I.InterPlan(rng, comp_p=0.5), signbias=(0, 0, 1),
            filter_level=30)
    want = _reference(s.frames)
    got = vp9_decode([Packet(data=f) for f in s.frames], "cpu",
                     {"native": False})
    for fw, fg in zip(want, got):
        for a, b in zip(fw.planes, fg.planes):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_bench_1080p_first_frames_match_golden():
    """Frames 0-2 of the committed 1920x1080 stream (a keyframe with 579
    intra dependency levels, two inter frames) on the port's default
    path against the reference's golden: full planes and hashes."""
    gold = np.load(VP9_GOLDEN)
    par, _tb, pkts = read_ivf(VP9_BENCH.read_bytes())
    assert (par.codec_id, par.width, par.height, len(pkts)) == \
        ("vp9", 1920, 1080, 100)
    frames = vp9_decode(pkts[:3], "cpu")
    assert [f.key_frame for f in frames] == [True, False, False]
    for i, f in enumerate(frames):
        assert [tuple(p.shape) for p in f.planes] == \
            [(1080, 1920), (540, 960), (540, 960)]
        for name, p, w in zip("yuv", f.planes, vp9_golden_planes(gold, i)):
            np.testing.assert_array_equal(p.numpy(), w,
                                          err_msg=f"frame {i} {name}")
        assert [plane_sha256(p) for p in f.planes] == \
            list(gold["hashes"][i])
