"""The port's filters/video8.py against the reference's, on the CPU:
every filter (bwdif, hqdn3d, atadenoise, exposure, colortemperature,
huesaturation, cas, deflicker, separatefields, weave) through both
packages' parse_graph on the same seeded frames (ffmpeg_tpu_torch.
testing.filter_clip) at 64x48 and 37x23, the temporal filters over 5 to
7 frames (interlaced ones for the deinterlacer and the field filters),
the traceable filters with a leading batch dim too; and the temporal
filters' state on the planes' device.

Tolerances (measured on these inputs):
- exact for bwdif (int32 with arithmetic shifts, as the reference's),
  separatefields and weave (data movement), and for every frame count,
  pts and prop;
- the float32 filters within 1 LSB on <= 1% of samples: hqdn3d,
  atadenoise and deflicker run eagerly in both packages, op by op, but
  their exp and mean are other implementations; exposure,
  colortemperature, huesaturation and cas are jitted by the reference,
  whose XLA CPU backend contracts products into fused multiply-adds
  (measured exact on all of them).
"""

import numpy as np
import pytest
import torch

from ffmpeg_tpu.filters import parse_graph as ref_parse_graph
from ffmpeg_tpu_torch.filters import parse_graph

from test_torch_filters_util import (SIZE_IDS, SIZES, check_frames,
                                     frames_both, port_planes, run_both)

CASES = [
    # (graph, format, frames, interlaced, bar)
    ("bwdif", "yuv420p", 5, True, "exact"),
    ("bwdif=parity=1", "yuv420p", 4, True, "exact"),
    ("hqdn3d", "yuv420p", 5, False, "lsb"),
    ("hqdn3d=luma_spatial=6:chroma_spatial=2:luma_tmp=3", "yuv420p", 4,
     False, "lsb"),
    ("atadenoise=s=5", "yuv420p", 7, False, "lsb"),
    ("atadenoise=0a=0.1:0b=0.2:1a=0.05", "yuv420p", 5, False, "lsb"),
    ("exposure=exposure=0.5:black=0.01", "yuv420p", 1, False, "lsb"),
    ("exposure=exposure=-1", "gbrp", 1, False, "lsb"),
    ("colortemperature=temperature=4000:pl=0.5", "gbrp", 1, False, "lsb"),
    ("colortemperature=temperature=9000:mix=0.6", "gbrp", 1, False, "lsb"),
    ("huesaturation=hue=20:saturation=0.3:intensity=0.1", "gbrp", 1, False,
     "lsb"),
    ("cas=strength=0.6", "yuv420p", 1, False, "lsb"),
    ("deflicker=size=3", "yuv420p", 5, False, "lsb"),
    ("separatefields", "yuv420p", 3, True, "exact"),
    ("separatefields", "yuv420p10le", 2, False, "exact"),
    ("weave", "yuv420p", 4, False, "exact"),
    ("weave=first_field=bottom", "gbrp", 3, False, "exact"),
]


@pytest.mark.parametrize("w,h", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("text,fmt,n,il,bar", CASES,
                         ids=[c[0] for c in CASES])
def test_filters_match_reference(text, fmt, n, il, bar, w, h):
    want, got, _, _ = run_both(text, {"in": frames_both(fmt, n, w, h,
                                                        interlaced=il)})
    check_frames(want["out"], got["out"], bar)


def test_separatefields_then_weave_round_trips():
    """At an even height the fields weave back into the frame; at an odd
    one the fields differ in height and both packages refuse them."""
    text = "separatefields,weave"
    feeds = {"in": frames_both("yuv420p", 3, 64, 48, interlaced=True)}
    want, got, _, _ = run_both(text, feeds)
    check_frames(want["out"], got["out"], "exact")
    for f, src in zip(got["out"], feeds["in"][1]):
        for a, b in zip(port_planes(f), src.planes):
            np.testing.assert_array_equal(a, b)
    ref_in, port_in = frames_both("yuv420p", 1, 37, 23, interlaced=True)
    with pytest.raises(ValueError):
        ref_parse_graph(text).run(ref_in)
    with pytest.raises(ValueError):
        parse_graph(text, device="cpu").run(port_in)


TRACEABLE = [c for c in CASES if c[0].split("=")[0] in (
    "exposure", "colortemperature", "huesaturation", "cas")]


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


def test_temporal_state_stays_on_the_planes_device():
    """The windows and carried planes are tensors on the planes' device
    (the reference round-trips each plane through numpy per frame)."""
    _, frames = frames_both("yuv420p", 3, 32, 16, interlaced=True)
    for text, state in [("hqdn3d", lambda f: f._prev),
                        ("bwdif", lambda f: [p for fr in f._win
                                             for p in fr.planes]),
                        ("atadenoise=s=5", lambda f: [p for fr in f._buf
                                                      for p in fr.planes])]:
        g = parse_graph(text, device="cpu")
        filt = g.nodes[0].filter
        for fr in frames:
            g.feed(fr.clone_props())
        held = state(filt)
        assert held and all(isinstance(t, torch.Tensor)
                            and t.device.type == "cpu" for t in held), text
