"""The port's filters/video2.py, ops/deblock.py and scale/lut3d.py against
the reference's, on the CPU: every filter of video2 (split, overlay,
psnr, ssim, yadif, drawbox, fade, deblock, lut3d) through both packages'
parse_graph on the same seeded frames (ffmpeg_tpu_torch.testing.
filter_clip) at 64x48 and 37x23, temporal filters over 5 frames,
overlay/psnr/ssim with two inputs and an EOF on one, the traceable
filters with a leading batch dim too; deblock_plane and apply_lut3d
(both methods) directly on random inputs.

Tolerances (measured on these inputs):
- exact for split, drawbox (data movement and selects), deblock and
  deblock_plane (float32 sums of integers and halves, exact in any
  order), overlay, yadif and fade (the reference runs these eagerly, op
  by op, as the port does: the same IEEE operations in the same order),
  and for every frame count, pts and prop;
- lut3d and apply_lut3d exact: the reference's jitted float32 blend runs
  as fused multiply-adds on XLA's CPU backend, and the port computes
  the same fmas (without them 1 LSB on 1.1% of the samples of the .cube
  case, and one float32 ulp on a fifth to a third of apply_lut3d's
  outputs);
- psnr and ssim scores within 1e-9 relative (float64 sums in another
  order; measured below 1e-14).
"""

import numpy as np
import pytest
import torch

from ffmpeg_tpu.core.frame import Frame as RefFrame
from ffmpeg_tpu.filters import parse_graph as ref_parse_graph
from ffmpeg_tpu.ops import deblock as ref_deblock
from ffmpeg_tpu.scale import lut3d as ref_lut3d
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.filters import parse_graph
from ffmpeg_tpu_torch.ops import deblock
from ffmpeg_tpu_torch.scale import lut3d

from test_torch_filters_util import (SIZE_IDS, SIZES, check_frames,
                                     frames_both, port_planes, run_both)

CASES = [
    # (graph, format, frames, interlaced, bar)
    ("split[a][b]", "yuv420p", 3, False, "exact"),
    ("yadif", "yuv420p", 5, True, "exact"),
    ("yadif=parity=1", "yuv420p10le", 5, True, "exact"),
    ("drawbox=x=5:y=4:w=20:h=15:thickness=2", "yuv420p", 1, False, "exact"),
    ("drawbox=x=5:y=4:w=20:h=15", "rgb24", 1, False, "exact"),
    ("drawbox=x=-3:y=9:w=30:h=40", "yuv420p10le", 1, False, "exact"),
    ("fade=type=in:start_frame=1:nb_frames=3", "yuv420p", 5, False, "exact"),
    ("fade=type=out:nb_frames=4", "gbrp", 5, False, "exact"),
    ("deblock", "yuv420p", 1, False, "exact"),
    ("deblock=strength=45:block=4", "yuv420p10le", 1, False, "exact"),
    ("lut3d", "rgb24", 1, False, "exact"),
    ("lut3d=interp=trilinear", "gbrp", 1, False, "exact"),
]


@pytest.mark.parametrize("w,h", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("text,fmt,n,il,bar", CASES,
                         ids=[c[0] for c in CASES])
def test_filters_match_reference(text, fmt, n, il, bar, w, h):
    outs = ("a", "b") if text.startswith("split") else ("out",)
    want, got, _, _ = run_both(text, {"in": frames_both(fmt, n, w, h,
                                                        interlaced=il)},
                               outs)
    for o in outs:
        check_frames(want[o], got[o], bar)


TRACEABLE = [c for c in CASES if c[0].split("=")[0] in
             ("drawbox", "deblock", "lut3d")]


@pytest.mark.parametrize("text,fmt,n,il,bar", TRACEABLE,
                         ids=[c[0] for c in TRACEABLE])
def test_traceable_filters_keep_the_batch(text, fmt, n, il, bar):
    """(3, h, w) planes give the port's per-frame results, stacked."""
    w, h = SIZES[0]
    _, single = frames_both(fmt, 3, w, h)
    _, batch = frames_both(fmt, 1, w, h, lead=3)
    one = [parse_graph(text, device="cpu").run([f])[0] for f in single]
    out = parse_graph(text, device="cpu").run(batch)[0]
    for i, p in enumerate(port_planes(out)):
        assert p.shape[0] == 3
        for k in range(3):
            np.testing.assert_array_equal(p[k], port_planes(one[k])[i])


OVERLAY = [
    # (graph, format, overlay size, main frames, overlay frames)
    ("[in][ov]overlay=x=10:y=8", "yuv420p", (24, 16), 4, 4),
    ("[in][ov]overlay=x=main_w-10:y=main_h-6", "yuv420p", (24, 16), 4, 4),
    ("[in][ov]overlay=x=5:y=3", "yuva420p", (30, 20), 4, 4),
    ("[in][ov]overlay=x=W-w/2:y=H-h/2", "yuva420p", (30, 20), 4, 4),
    ("[in][ov]overlay=x=4:y=2", "gbrp", (16, 12), 5, 2),
]


@pytest.mark.parametrize("w,h", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("text,fmt,osz,nm,no", OVERLAY,
                         ids=[f"{c[0]}-{c[1]}-{c[4]}" for c in OVERLAY])
def test_overlay_matches_reference(text, fmt, osz, nm, no, w, h):
    """Regions past the right and bottom edges clip; an alpha overlay
    blends; an overlay input that ends first (EOF) lets main through."""
    feeds = {"in": frames_both(fmt, nm, w, h),
             "ov": frames_both(fmt, no, *osz, seed=3)}
    want, got, _, _ = run_both(text, feeds,
                               eof_early=("ov",) if no < nm else ())
    assert len(got["out"]) == nm
    check_frames(want["out"], got["out"], "exact")


@pytest.mark.parametrize("w,h", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("name,fmt", [("psnr", "yuv420p"),
                                      ("psnr", "yuv420p10le"),
                                      ("ssim", "yuv420p"),
                                      ("ssim", "gray")])
def test_metrics_match_reference(name, fmt, w, h):
    """Scores within 1e-9 relative; main passes through; the second
    input's EOF after 3 of 5 frames leaves main's last 2 unpaired."""
    feeds = {"a": frames_both(fmt, 5, w, h),
             "b": frames_both(fmt, 3, w, h, seed=1)}
    want, got, ref_g, port_g = run_both(f"[a][b]{name}", feeds,
                                        eof_early=("b",))
    check_frames(want["out"], got["out"], "exact")
    rs, ps = ref_g.nodes[0].filter.scores, port_g.nodes[0].filter.scores
    assert len(ps) == len(rs) == 3
    for p, r in zip(ps, rs):
        assert isinstance(p, float) and abs(p - r) <= 1e-9 * abs(r), (p, r)


def test_psnr_of_equal_frames_is_inf():
    feeds = {"a": frames_both("yuv420p", 2, 16, 8),
             "b": frames_both("yuv420p", 2, 16, 8)}
    _, _, ref_g, port_g = run_both("[a][b]psnr", feeds)
    assert port_g.nodes[0].filter.scores == ref_g.nodes[0].filter.scores \
        == [float("inf")] * 2


CUBE = """TITLE "port test"
# a nonlinear 5-point LUT, red fastest
LUT_3D_SIZE 5
DOMAIN_MIN 0.0 0.0 0.0
DOMAIN_MAX 1.0 1.0 1.0
""" + "\n".join(f"{(r / 4) ** 2:.6f} {g / 4 * 0.8 + 0.1:.6f} "
                f"{(b / 4) ** 0.5:.6f}"
                for b in range(5) for g in range(5) for r in range(5))


@pytest.mark.parametrize("interp", ["tetrahedral", "trilinear"])
@pytest.mark.parametrize("w,h", SIZES, ids=SIZE_IDS)
def test_lut3d_cube_file_matches_reference(tmp_path, interp, w, h):
    path = tmp_path / "t.cube"
    path.write_text(CUBE)
    text = f"lut3d=file={path}:interp={interp}"
    want, got, _, _ = run_both(text, {"in": frames_both("rgb24", 2, w, h)})
    check_frames(want["out"], got["out"], "exact")
    assert lut3d.parse_cube(CUBE)[0].shape == (5, 5, 5, 3)


@pytest.mark.parametrize("shape,qp,block", [
    ((48, 64), 30, 8), ((48, 64), 45, 4), ((23, 37), 51, 8),
    ((2, 40, 56), 40, 8), ((16, 16), 10, 8)])
def test_deblock_plane_matches_reference(shape, qp, block):
    import jax.numpy as jnp
    rng = np.random.default_rng(qp + block)
    x = np.clip(rng.integers(0, 40, shape) + np.arange(shape[-1]) * 3, 0,
                255).astype(np.uint8)
    want = np.asarray(ref_deblock.deblock_plane(jnp.asarray(x), qp=qp,
                                                block=block))
    got = deblock.deblock_plane(torch.from_numpy(x), qp=qp, block=block)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(deblock._ALPHA, ref_deblock._ALPHA)
    np.testing.assert_array_equal(deblock._BETA, ref_deblock._BETA)


def test_deblock_filter_clips_at_the_container_not_the_depth():
    """deblock's clip is the container's maximum (65535 for 10-bit in
    uint16), as the reference's iinfo: a 10-bit edge p1 p0 | q0 q1 =
    1023 1023 | 1023 1007 at strength 51 filters p0 to 1025 in both."""
    x = np.full((8, 16), 1023, np.uint16)
    x[:, 9] = 1007
    text = "deblock=strength=51:block=8"
    want = np.asarray(ref_parse_graph(text).run(
        [RefFrame.video(16, 8, "gray10le", planes=[x])])[0].planes[0])
    got = port_planes(parse_graph(text, device="cpu").run(
        [Frame.video(16, 8, "gray10le", planes=[x])])[0])[0]
    np.testing.assert_array_equal(got, want)
    assert int(want.max()) == 1025


def _lut_inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    lut = rng.random((n, n, n, 3)).astype(np.float32)
    rgb = rng.random((40, 50, 3)).astype(np.float32)
    rgb[0, :, 1] = rgb[0, :, 0]                     # fr == fg
    rgb[1, :, 2] = rgb[1, :, 1]                     # fg == fb
    rgb[2, :, :] = rgb[2, :, :1]                    # all three equal
    rgb[3] = np.round(rgb[3] * (n - 1)) / (n - 1)   # on grid points
    rgb[4] = rgb[4] * 1.4 - 0.2                     # clipped to [0, 1]
    return lut, rgb


@pytest.mark.parametrize("method", ["tetrahedral", "trilinear"])
@pytest.mark.parametrize("n,seed", [(9, 0), (17, 1), (2, 2)])
def test_apply_lut3d_matches_reference(method, n, seed):
    """Random tables and colours, with rows on exact grid points and on
    fr == fg, fg == fb and fr == fg == fb ties."""
    import jax.numpy as jnp
    lut, rgb = _lut_inputs(n, seed)
    want = np.asarray(ref_lut3d.apply_lut3d(jnp.asarray(rgb),
                                            jnp.asarray(lut), method=method))
    got = lut3d.apply_lut3d(torch.from_numpy(rgb), torch.from_numpy(lut),
                            method=method).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # on grid points both interpolations return the table's entries
    i = np.round(rgb[3] * (n - 1)).astype(int)
    np.testing.assert_allclose(got[3], lut[i[:, 0], i[:, 1], i[:, 2]],
                               atol=2.4e-7)


def test_identity_lut_and_parse_cube_equal_reference():
    for n in (2, 17, 33):
        np.testing.assert_array_equal(lut3d.identity_lut(n),
                                      ref_lut3d.identity_lut(n))
    a, b = lut3d.parse_cube(CUBE), ref_lut3d.parse_cube(CUBE)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]
    with pytest.raises(ValueError):
        lut3d.parse_cube("LUT_3D_SIZE 3\n0 0 0\n")
