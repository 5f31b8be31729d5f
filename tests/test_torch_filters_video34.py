"""The port's filters/video3.py and filters/video4.py against the
reference's, on the CPU: every filter (negate, eq, boxblur, unsharp, hue;
gblur, avgblur, edgedetect, swapuv, monochrome, vignette, drawgrid,
framestep, select, tmix, vnoise, blend) through both packages'
parse_graph on the same seeded frames (ffmpeg_tpu_torch.testing.
filter_clip) at 64x48 and 37x23, the temporal and selecting filters over
5 frames, blend with two inputs and an EOF on one, the traceable
filters with a leading batch dim too.

Tolerances (measured on these inputs):
- exact for negate, swapuv, monochrome, drawgrid (integer and data
  movement), framestep and select (selects), tmix (float32 sums of at
  most 3 integers, exact), vnoise (numpy's own draw, uploaded), and for
  every frame count, pts and prop;
- the float32 filters (eq, boxblur, unsharp, hue, gblur, avgblur,
  edgedetect, vignette) within 1 LSB on <= 1% of samples: the reference
  jits them, and XLA's CPU backend contracts products into fused
  multiply-adds and runs its cumulative sums in another order (measured:
  unsharp at a negative amount 1 LSB on 0.55% of samples, the others
  exact; divisions by constants are the reference's reciprocal
  multiplications in both);
- blend (float64, as the reference's numpy) within 1 LSB on <= 1%
  (measured exact).
"""

import numpy as np
import pytest

from ffmpeg_tpu_torch.filters import parse_graph

from test_torch_filters_util import (SIZE_IDS, SIZES, check_frames,
                                     frames_both, port_planes, run_both,
                                     run_graph)

CASES = [
    # (graph, format, frames, bar)
    ("negate", "yuva420p", 1, "exact"),
    ("negate=negate_alpha=1", "yuva420p", 1, "exact"),
    ("negate", "yuv420p10le", 1, "exact"),
    ("eq=contrast=1.3:brightness=0.05:saturation=1.4:gamma=1.2", "yuv420p",
     1, "lsb"),
    ("eq=contrast=0.8:brightness=-0.1", "yuv420p", 1, "lsb"),
    ("boxblur", "yuv420p", 1, "lsb"),
    ("boxblur=luma_radius=3:luma_power=2:chroma_radius=1", "yuv420p", 1,
     "lsb"),
    ("unsharp", "yuv420p", 1, "lsb"),
    ("unsharp=luma_amount=-0.5:chroma_amount=0.8", "yuv420p", 1, "lsb"),
    ("hue=h=30:s=1.2", "yuv420p", 1, "lsb"),
    ("gblur=sigma=1.5:steps=2", "yuv420p", 1, "lsb"),
    ("gblur", "gbrp", 1, "lsb"),
    ("avgblur=sizeX=2:sizeY=1", "yuv420p", 1, "lsb"),
    ("edgedetect", "yuv420p", 1, "lsb"),
    ("edgedetect=low=0.02:high=0.1", "yuv420p", 1, "lsb"),
    ("swapuv", "yuv420p", 1, "exact"),
    ("monochrome", "yuv420p", 1, "exact"),
    ("vignette", "yuv420p", 1, "lsb"),
    ("vignette=angle=1.2", "gray", 1, "lsb"),
    ("drawgrid=width=16:height=12:thickness=2:luma=200", "yuv420p", 1,
     "exact"),
    ("framestep=step=2", "yuv420p", 5, "exact"),
    ("select=expr=gte(n\\,2)", "yuv420p", 5, "exact"),
    ("tmix=frames=3", "yuv420p", 5, "exact"),
    ("tmix=frames=2", "gbrp", 5, "exact"),
    ("vnoise=strength=20:seed=7", "yuv420p", 3, "exact"),
    ("vnoise", "yuv420p10le", 2, "exact"),
]


@pytest.mark.parametrize("w,h", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("text,fmt,n,bar", CASES, ids=[c[0] for c in CASES])
def test_filters_match_reference(text, fmt, n, bar, w, h):
    want, got, _, _ = run_both(text, {"in": frames_both(fmt, n, w, h)})
    check_frames(want["out"], got["out"], bar)


TRACEABLE = [c for c in CASES if c[0].split("=")[0] in (
    "negate", "eq", "boxblur", "unsharp", "hue", "gblur", "avgblur",
    "edgedetect", "swapuv", "monochrome", "vignette", "drawgrid")]


@pytest.mark.parametrize("text,fmt,n,bar", TRACEABLE,
                         ids=[c[0] for c in TRACEABLE])
def test_traceable_filters_keep_the_batch(text, fmt, n, bar):
    """(3, h, w) planes give the port's per-frame results, stacked."""
    w, h = SIZES[1]
    _, single = frames_both(fmt, 3, w, h)
    _, batch = frames_both(fmt, 1, w, h, lead=3)
    one = [parse_graph(text, device="cpu").run([f])[0] for f in single]
    out = parse_graph(text, device="cpu").run(batch)[0]
    for i, p in enumerate(port_planes(out)):
        assert p.shape[0] == 3
        for k in range(3):
            np.testing.assert_array_equal(p[k], port_planes(one[k])[i])


@pytest.mark.parametrize("w,h", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("mode,nb", [
    ("average", 5), ("addition", 5), ("subtract", 5), ("lighten", 5),
    ("darken", 3), ("multiply", 2), ("normal", 5)])
def test_blend_matches_reference(mode, nb, w, h):
    """Framesync pairing by pts; with fewer bottom frames, the bottom
    input's EOF repeats its last frame for the rest of the top's."""
    feeds = {"a": frames_both("yuv420p", 5, w, h),
             "b": frames_both("yuv420p", nb, w, h, seed=2)}
    text = f"[a][b]blend=all_mode={mode}:all_opacity=0.7"
    want, got, _, _ = run_both(text, feeds,
                               eof_early=("b",) if nb < 5 else ())
    check_frames(want["out"], got["out"], "lsb")


def test_unknown_blend_mode_raises_as_the_reference():
    from ffmpeg_tpu.filters import parse_graph as ref_parse_graph
    from ffmpeg_tpu.utils.error import InvalidData as RefInvalid
    from ffmpeg_tpu_torch.utils.error import InvalidData as PortInvalid
    (ra, pa), (rb, pb) = (frames_both("gray", 2, 8, 8, seed=s)
                          for s in (0, 1))
    text = "[a][b]blend=all_mode=screen"
    with pytest.raises(RefInvalid):
        run_graph(ref_parse_graph(text), {"a": ra, "b": rb}, ["out"])
    with pytest.raises(PortInvalid):
        run_graph(parse_graph(text, device="cpu"), {"a": pa, "b": pb},
                  ["out"])


@pytest.mark.parametrize("nb,want_n", [(5, 4), (3, 2)])
def test_blend_holds_back_frames_at_eof_as_the_reference(nb, want_n):
    """The graph delivers every input's EOF on pad 0 (filters/graph.py
    `_push_eof`), so blend's frame aligner never sees the bottom input
    end: the top's last frame, and every top frame after the bottom's
    last, are never emitted, in both packages (5 top frames give 4 with
    5 bottom frames and 2 with 3)."""
    feeds = {"a": frames_both("gray", 5, 8, 8),
             "b": frames_both("gray", nb, 8, 8, seed=1)}
    want, got, _, _ = run_both("[a][b]blend", feeds,
                               eof_early=("b",) if nb < 5 else ())
    assert len(got["out"]) == len(want["out"]) == want_n
