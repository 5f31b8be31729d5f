"""The port's multi-device layer (ffmpeg_tpu_torch/parallel/mesh.py,
parallel/halo.py, codecs/vp9/lf_sharded.py, codecs/hevc/filter_tpu.py
`sharded_filters`, entry.py `dryrun_multichip`) against the reference,
bit-exact, on the CPU.

The port's meshes are eight `cpu` positions; the reference runs on
conftest's virtual 8-device CPU mesh.  The reference's sharded functions
run once a case, the reference's host filters hold the other mesh sizes:
  * the mesh: shape, the spatial ValueError, shard_batch and gather, and
    a ppermute on one device that aliases nothing;
  * sharded_deblock: tests/test_halo.py's two cases (8-way; a (2, 4)
    mesh) and the (2, 4) mesh on blocky content, against the reference's
    sharded_deblock and the port's deblock_plane, the filter shown to act
    where the content lets it;
  * VP9 on tests/test_vp9_multichip.py's 4-tile-column 1024x64 crafted
    frames: loopfilter_sharded at n = 2, 4, 8 against the reference's
    host lf.loopfilter_frame, at n = 4 against the reference's
    loopfilter_sharded; the tile-parallel decode; the ValueError;
  * HEVC on tests/test_hevc_tpu.py's three sharded pictures (8 tile
    columns with filtering across tiles, independent tiles, untiled) and
    the first at 12 bits: sharded_filters against the reference's
    sharded_filters and the port's filters_tpu;
  * dryrun_multichip(8, device="cpu"): its legs' own checks, the
    decode→scale leg against the reference's sharded jitted step within
    1 LSB, and the audio leg against the reference's audio_step on the
    same input within float32 rounding."""

import copy

import numpy as np
import pytest
import torch

import test_hevc as H
from test_hevc_tpu import _decode_to_prefilter
from test_vp9 import Plan, craft_frame

import ffmpeg_tpu.codecs.vp9 as RV
from ffmpeg_tpu.codecs.hevc.filter_tpu import (
    sharded_filters as ref_sharded_filters)
from ffmpeg_tpu.codecs.vp9.lf_sharded import (
    loopfilter_sharded as ref_loopfilter_sharded)
from ffmpeg_tpu.parallel import halo as ref_halo
from ffmpeg_tpu.parallel import mesh as ref_mesh

from ffmpeg_tpu_torch import entry
from ffmpeg_tpu_torch.codecs.hevc import filter_tpu
from ffmpeg_tpu_torch.codecs.vp9 import tile_bounds
from ffmpeg_tpu_torch.codecs.vp9.block import FrameState, TileWalker
from ffmpeg_tpu_torch.codecs.vp9.bool import BoolDecoder
from ffmpeg_tpu_torch.codecs.vp9.header import (parse_compressed,
                                                parse_uncompressed)
from ffmpeg_tpu_torch.codecs.vp9.lf_sharded import loopfilter_sharded
from ffmpeg_tpu_torch.ops.deblock import deblock_plane
from ffmpeg_tpu_torch.parallel.halo import sharded_deblock
from ffmpeg_tpu_torch.parallel.mesh import (Mesh, make_mesh, ppermute,
                                            shard_batch)

CPU8 = ["cpu"] * 8


def _ref_mesh(n, spatial):
    import jax
    if len(jax.devices()) < n:
        pytest.skip("needs the virtual 8-device mesh")
    return ref_mesh.make_mesh(n, spatial=spatial)


# ---------------------------------------------------------------------------
# the mesh


def test_mesh_sharding():
    mesh = make_mesh(8, spatial=2, devices=CPU8)
    assert mesh.shape == {"data": 4, "spatial": 2}
    assert mesh.shape == dict(_ref_mesh(8, 2).shape)
    x = np.arange(8 * 16 * 16, dtype=np.float32).reshape(8, 16, 16)
    (xs,) = shard_batch(mesh, [x], spatial_dim=1)
    assert xs.shape == x.shape
    assert xs.shards[(3, 1)].shape == (2, 8, 16)
    np.testing.assert_array_equal(xs.shards[(3, 1)].numpy(), x[6:8, 8:16])
    np.testing.assert_array_equal(xs.gather().numpy(), x)
    with pytest.raises(ValueError):
        make_mesh(8, spatial=3, devices=CPU8)


def test_ppermute_on_one_device_aliases_nothing():
    a, b = torch.arange(4.0), torch.arange(4.0) + 10
    out = ppermute([a, b], [(0, 1), (1, 0)])
    assert torch.equal(out[0], b) and torch.equal(out[1], a)
    same = ppermute([a], [(0, 0)])[0]
    assert same.data_ptr() != a.data_ptr()
    same += 100                     # an edit of the copy leaves its sender
    out[1] += 100
    assert torch.equal(a, torch.arange(4.0))
    # a position that receives nothing gets zeros
    assert torch.equal(ppermute([a, b], [(0, 1)])[0], torch.zeros(4))


# ---------------------------------------------------------------------------
# sharded_deblock


def _blocky(rng, h, w):
    """Per-8x8 constant + noise, so that edges actually filter."""
    base = rng.integers(0, 255, (h // 8, w // 8)).repeat(8, 0).repeat(8, 1)
    return np.clip(base + rng.integers(-3, 4, (h, w)), 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("case", ["8way", "2x4", "2x4_blocky"])
def test_sharded_deblock_matches_reference_and_unsharded(case):
    """tests/test_halo.py's two cases (its (2, 4) case is noise that
    the filter leaves as it is), and the (2, 4) mesh on blocky content
    that it filters."""
    import jax.numpy as jnp
    if case == "8way":
        n, spatial, qp = 8, 8, 40
        plane = _blocky(np.random.default_rng(0), 128, 128)
    elif case == "2x4":
        n, spatial, qp = 8, 4, 30
        rng = np.random.default_rng(3)
        plane = rng.integers(0, 255, (96, 64)).astype(np.uint8)
    else:
        n, spatial, qp = 8, 4, 30
        plane = _blocky(np.random.default_rng(4), 96, 64)
    want = np.asarray(ref_halo.sharded_deblock(
        jnp.asarray(plane), _ref_mesh(n, spatial), qp=qp))
    pt = torch.from_numpy(plane)
    got = sharded_deblock(pt, make_mesh(n, spatial=spatial, devices=CPU8),
                          qp=qp)
    assert got.dtype == torch.uint8 and got.shape == pt.shape
    # the filter actually acted
    assert case == "2x4" or not np.array_equal(plane, want)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, deblock_plane(pt, qp=qp))


def test_sharded_deblock_refuses_misaligned_shards():
    with pytest.raises(ValueError):
        sharded_deblock(torch.zeros(100, 64, dtype=torch.uint8),
                        make_mesh(8, spatial=8, devices=CPU8))


# ---------------------------------------------------------------------------
# VP9: the column-sharded loop filter

W4, H4 = 1024, 64                         # 4 tile columns


def _craft_tiled(seed, lvl=36, sharp=1):
    rng = np.random.default_rng(seed)
    return craft_frame(Plan(rng, split_p=0.25, maxn=6, amp=80),
                       width=W4, height=H4, tile_cols_log2=2,
                       filter_level=lvl, sharpness=sharp)


def _ref_decode(stream, lf=None):
    """The reference's decode of a crafted frame, its loop filter
    swapped for `lf` (fs → None) when given."""
    if lf is None:
        return RV.decode_frame(stream)[1]
    orig = RV.loopfilter_frame
    RV.loopfilter_frame = lf
    try:
        return RV.decode_frame(stream)[1]
    finally:
        RV.loopfilter_frame = orig


def _planes(fs):
    return fs.y, fs.u, fs.v


@pytest.fixture(scope="module")
def vp9_frame():
    """The crafted frame, its pre-filter state and the host filter's
    planes, from the reference's decoder."""
    stream = _craft_tiled(37)
    pre = []
    host = _ref_decode(stream, lambda fs: (
        pre.append(copy.deepcopy(fs)), RV.lf.loopfilter_frame(fs)))
    return stream, pre[0], host


@pytest.mark.parametrize("n", [2, 4, 8])
def test_vp9_loopfilter_sharded_matches_host(vp9_frame, n):
    _, pre, host = vp9_frame
    fs = copy.deepcopy(pre)
    out = loopfilter_sharded(fs, make_mesh(n, spatial=n, devices=CPU8))
    assert any(not np.array_equal(a, b)
               for a, b in zip(_planes(pre), _planes(host)))
    for name, a, b, t in zip("yuv", _planes(fs), _planes(host), out):
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(t.numpy(), b, err_msg=name)


def test_vp9_loopfilter_sharded_matches_reference_sharded(vp9_frame):
    import jax
    from jax.sharding import Mesh as JMesh
    stream, pre, _ = vp9_frame
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual 8-device mesh")
    jmesh = JMesh(np.array(jax.devices()[:4]), ("spatial",))
    want = _ref_decode(stream, lambda fs: ref_loopfilter_sharded(fs, jmesh))
    fs = copy.deepcopy(pre)
    loopfilter_sharded(fs, Mesh(np.array(["cpu"] * 4, dtype=object),
                                ("spatial",)))
    for a, b in zip(_planes(fs), _planes(want)):
        np.testing.assert_array_equal(a, b)


def test_vp9_tile_parallel_decode():
    """The 4 tile columns entropy-decoded and reconstructed one by one
    in any order with the port's own walker (each owns a disjoint
    bitstream slice, column range and left context), then the loop
    filter column-sharded over 4 positions: equal to the reference's
    decode."""
    stream = _craft_tiled(61)
    want = _ref_decode(stream)
    h = parse_uncompressed(stream)
    pos = (h.uncompressed_bits + 7) // 8
    probs = parse_compressed(h, stream[pos:pos + h.compressed_size])
    pos += h.compressed_size
    fs = FrameState(h, probs)
    tiles = []
    for tc in range(4):
        if tc != 3:
            size = int.from_bytes(stream[pos:pos + 4], "big")
            pos += 4
        else:
            size = len(stream) - pos
        tiles.append(stream[pos:pos + size])
        pos += size
    for tc in (2, 0, 3, 1):
        c0, c1 = tile_bounds(tc, 2, fs.sb_cols)
        core = BoolDecoder(tiles[tc])
        assert not core.get(128)
        wk = TileWalker(fs, core, tile_col_start=c0, tile_col_end=c1)
        for row in range(0, fs.rows, 8):
            fs.new_tile_left()
            for col in range(c0, min(c1, fs.cols), 8):
                wk.decode_sb(row, col, 0)
    loopfilter_sharded(fs, make_mesh(4, spatial=4, devices=CPU8))
    for a, b in zip(_planes(fs), _planes(want)):
        np.testing.assert_array_equal(a, b)


def test_vp9_loopfilter_sharded_refuses_uneven_columns(vp9_frame):
    _, pre, _ = vp9_frame                 # 16 SB columns
    with pytest.raises(ValueError):
        loopfilter_sharded(copy.deepcopy(pre),
                           make_mesh(3, spatial=3, devices=CPU8))


# ---------------------------------------------------------------------------
# HEVC: deblock + SAO in tile columns


def _hevc_stream(case):
    if case == "untiled":
        rng = np.random.default_rng(45)
        return H.craft_frame(H.Plan(rng, maxn=10, amp=50), width=256,
                             height=64, sao=True, pps_kw=dict(deblock=True))
    rng = np.random.default_rng({"tiles_8col": 41, "tiles_independent": 43,
                                 "tiles_8col_12bit": 47}[case])
    kw = dict(bit_depth=12) if case.endswith("12bit") else {}
    return H.craft_frame(
        H.Plan(rng, maxn=8, amp=120 if kw else 40), width=256, height=64,
        log2_ctb=4, log2_max_tb=4, sao=True,
        pps_kw=dict(tiles=(8, 1), deblock=True,
                    lf_across_tiles=case != "tiles_independent"), **kw)


@pytest.mark.parametrize("case", ["tiles_8col", "tiles_independent",
                                  "untiled", "tiles_8col_12bit"])
def test_hevc_sharded_filters_match_reference(case):
    dec = _decode_to_prefilter(_hevc_stream(case))
    want = ref_sharded_filters(dec, _ref_mesh(8, 8))
    planes = [torch.from_numpy(p) for p in (dec.y, dec.u, dec.v)]
    whole = filter_tpu.filters_tpu(dec, *planes)
    assert any(not torch.equal(a, b) for a, b in zip(whole, planes))
    sizes = [n for n in (2, 4, 8) if dec.sps.ctb_width % n == 0]
    assert 8 in sizes
    for n in sizes:
        got = filter_tpu.sharded_filters(
            dec, make_mesh(n, spatial=n, devices=CPU8))
        for pl, (g, w, t) in enumerate(zip(got, want, whole)):
            assert g.dtype == t.dtype
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"n={n} plane {pl}")
            assert torch.equal(g, t), f"n={n} plane {pl}"


def test_hevc_sharded_filters_refuse_uneven_columns():
    dec = _decode_to_prefilter(_hevc_stream("untiled"))
    with pytest.raises(ValueError):
        filter_tpu.sharded_filters(dec, make_mesh(3, spatial=3,
                                                  devices=CPU8))


# ---------------------------------------------------------------------------
# dryrun_multichip


def _ref_audio_step(x):
    """__graft_entry__.dryrun_multichip's audio_step (48k→16k FIR, the
    windows by jnp.take, one einsum) on the reference's filter bank."""
    import jax
    import jax.numpy as jnp
    from ffmpeg_tpu.resample.fir import build_filter_bank as ref_bank
    bank = jnp.asarray(ref_bank(16, 3, 0.3), jnp.float32)

    def audio_step(x, bank):
        idx = jnp.arange(0, 1024 - 16, 3)[:, None] + jnp.arange(16)[None, :]
        win = jnp.take(x, idx, axis=1)
        ph = jnp.tile(jnp.arange(3), win.shape[1] // 3 + 1)[: win.shape[1]]
        w = jnp.take(bank, ph, axis=0)
        return jnp.einsum("bmt,mt->bm", win, w)
    return np.asarray(jax.jit(audio_step)(jnp.asarray(x), bank))


def test_dryrun_multichip_on_cpu_matches_reference_sharded_step():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ffmpeg_tpu.models.mjpeg_pipeline import (
        DecodeScaleSpec as RSpec, build_decode_scale as ref_build,
        example_args as ref_args)

    legs = entry.dryrun_multichip(8, device="cpu")
    assert set(legs) == {"decode_scale", "decode_scale_diff", "audio",
                         "deblock", "vp9", "hevc"}
    # the reference's decode→scale step jitted over its (4, 2) mesh
    mesh = _ref_mesh(8, 2)
    spec = RSpec(width=128, height=96, out_w=64, out_h=64)
    cy, cu, cv, ql, qc = ref_args(spec, batch=8)
    coeff_sh = NamedSharding(mesh, P("data", "spatial", None, None))
    repl = NamedSharding(mesh, P())
    args = [jax.device_put(a, coeff_sh) for a in (cy, cu, cv)] + [
        jax.device_put(a, repl) for a in (ql, qc)]
    out_sh = NamedSharding(mesh, P("data", "spatial", None))
    want = jax.jit(ref_build(spec), out_shardings=[out_sh] * 3)(*args)
    for g, w in zip(legs["decode_scale"], want):
        d = np.abs(g.numpy().astype(np.int32)
                   - np.asarray(w).astype(np.int32))
        assert d.max() <= 1, d.max()
        assert (d > 0).mean() <= entry.DRYRUN_LSB_SHARE
    diff = legs["decode_scale_diff"]
    assert diff["samples"] == 3 * 8 * 64 * 64 and diff["max"] <= 1
    assert diff["differ"] <= entry.DRYRUN_LSB_SHARE * diff["samples"]
    # the audio leg against __graft_entry__'s audio_step on the same input
    assert legs["audio"].shape == (8, 336)
    np.testing.assert_allclose(legs["audio"].numpy(),
                               _ref_audio_step(entry.audio_input(8)),
                               rtol=1e-6, atol=1e-6)
    assert legs["deblock"].shape == (128, 64)
    assert [tuple(p.shape) for p in legs["hevc"]] == [(32, 128), (16, 64),
                                                      (16, 64)]
