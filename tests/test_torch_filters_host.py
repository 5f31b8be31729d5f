"""The port's filters/video5.py, video6.py, video7.py and sources.py
against the reference's, on the CPU.  The reference computes these in
numpy on the host; the port computes the same functions in PyTorch on
the planes' device.  Every filter (tonemap; extractplanes,
shuffleplanes, hstack, vstack, tile, fillborders, limiter, dilation,
erosion, median, inflate, deflate, sobel, prewitt, lutyuv, lutrgb,
colorbalance, colorchannelmixer, colorkey, chromakey, maskedmerge,
setsar, setdar, loop, reverse, tpad, rotate, testsrc2, mandelbrot;
colorspace; color, testsrc, sine, anullsrc, nullsink) runs through both
packages on the same seeded frames (ffmpeg_tpu_torch.testing.
filter_clip) at 64x48 and 37x23: the filters through parse_graph, the
temporal ones over 4-5 frames, the stacking and merging ones with two
or three inputs and an EOF on one; the sources through generate().

Tolerances (measured on these inputs):
- exact for the data movement, integer and table filters
  (extractplanes, shuffleplanes, hstack, vstack, tile, fillborders,
  limiter, dilation, erosion, median at radius 1 and 2, inflate,
  deflate, lutyuv, lutrgb, setsar, setdar, loop, reverse, tpad), for
  sobel and prewitt (float32 sums of integer products, exact in any
  order, then a correctly rounded sqrt), for the integer sources
  (color, testsrc, testsrc2) and the host audio sources, and for every
  frame count, pts and prop;
- the float64 filters (colorbalance, colorchannelmixer, colorkey,
  chromakey, maskedmerge, rotate, colorspace) and mandelbrot within 1 LSB
  on <= 1% of samples: their pow, sqrt and mean are other
  implementations than numpy's (measured exact on all of them);
- tonemap's float32 planes within 1e-6 of the plane's largest
  magnitude (measured: a few float32 ulps, from pow and the division's
  other implementation).
"""

import numpy as np
import pytest
import torch

from ffmpeg_tpu.core.frame import Frame as RefFrame
from ffmpeg_tpu.filters import get_filter as ref_get_filter
from ffmpeg_tpu.filters import parse_graph as ref_parse_graph
from ffmpeg_tpu.utils.rational import Rational as RefRational
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.filters import get_filter, parse_graph
from ffmpeg_tpu_torch.utils.rational import Rational

from test_torch_filters_util import (SIZE_IDS, SIZES, check_frames,
                                     frames_both, run_both, same_props)

CASES = [
    # (graph, format, frames, bar)
    ("extractplanes=planes=y+u+v", "yuv420p", 2, "exact"),
    ("extractplanes=planes=a+g", "gbrap", 1, "exact"),
    ("shuffleplanes=map0=2:map1=0:map2=1", "gbrp", 1, "exact"),
    ("tile=layout=2x2", "yuv420p", 5, "exact"),
    ("tile=layout=3x1", "yuv420p10le", 2, "exact"),
    ("fillborders=left=4:right=3:top=2:bottom=5:mode=fixed:color=30",
     "yuv420p", 1, "exact"),
    ("fillborders=left=4:right=3:top=2:bottom=5:mode=mirror", "yuv420p", 1,
     "exact"),
    ("fillborders=left=4:right=3:top=2:bottom=5", "yuv420p10le", 1,
     "exact"),
    ("limiter=min=20:max=200", "yuv420p", 1, "exact"),
    ("limiter=min=64:max=900:planes=1", "yuv420p10le", 1, "exact"),
    ("limiter", "yuv420p10le", 1, "exact"),
    ("dilation", "yuv420p", 1, "exact"),
    ("erosion=planes=1", "yuv420p", 1, "exact"),
    ("median", "yuv420p", 1, "exact"),
    ("median=radius=2", "yuv420p10le", 1, "exact"),
    ("inflate", "yuv420p", 1, "exact"),
    ("deflate", "gbrp", 1, "exact"),
    ("sobel", "yuv420p", 1, "exact"),
    ("prewitt=scale=0.5:delta=10", "yuv420p", 1, "exact"),
    ("sobel=planes=1", "yuv420p10le", 1, "exact"),
    ("lutyuv=y=negval:u=val/2", "yuv420p", 1, "exact"),
    ("lutyuv=y=clipval*2:v=maxval-val", "yuv420p10le", 1, "exact"),
    ("lutrgb=r=maxval-val:g=val*2", "gbrp", 1, "exact"),
    ("colorbalance=rs=0.2:gm=-0.1:bh=0.3", "gbrp", 1, "lsb"),
    ("colorchannelmixer=rr=0.5:rg=0.3:rb=0.2:ga=0.1:aa=0.7", "gbrap", 1,
     "lsb"),
    ("colorchannelmixer=rr=0.3:gg=0.6:bb=1.2", "gbrp", 1, "lsb"),
    ("colorkey=color=0x808080:similarity=0.3:blend=0.1", "gbrp", 1, "lsb"),
    ("colorkey=color=white:similarity=0.5", "gbrp", 1, "lsb"),
    ("chromakey=color=lime:similarity=0.2", "yuv420p", 1, "lsb"),
    ("chromakey=color=0x7080a0:similarity=0.05:blend=0.1", "yuv444p", 1,
     "lsb"),
    ("setsar=sar=16/15", "yuv420p", 1, "exact"),
    ("setsar=sar=2", "yuv420p", 1, "exact"),
    ("setdar=dar=16/9", "yuv420p", 1, "exact"),
    ("loop=loop=2:size=2:start=1", "yuv420p", 4, "exact"),
    ("reverse", "yuv420p", 4, "exact"),
    ("tpad=start=2:stop=1:stop_mode=add", "yuv420p", 3, "exact"),
    ("tpad=start=1:start_mode=clone:stop=2", "gbrp", 2, "exact"),
    ("rotate=angle=PI/6", "yuv420p", 1, "lsb"),
    ("rotate=a=0.3:fillcolor=16", "gbrp", 1, "lsb"),
    ("colorspace=all=bt709:iall=bt601-6-625", "yuv420p", 1, "lsb"),
    ("colorspace=all=bt2020:iall=bt709:range=pc", "yuv420p10le", 1, "lsb"),
    ("colorspace=space=bt470bg:trc=bt709:primaries=bt709:ispace=bt709:"
     "irange=pc", "yuv444p", 1, "lsb"),
]


@pytest.mark.parametrize("w,h", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("text,fmt,n,bar", CASES, ids=[c[0] for c in CASES])
def test_filters_match_reference(text, fmt, n, bar, w, h):
    want, got, _, _ = run_both(text, {"in": frames_both(fmt, n, w, h)})
    check_frames(want["out"], got["out"], bar)


MULTI = [
    # (graph, inputs with their frame counts, format)
    ("[a][b]hstack", {"a": 4, "b": 4}, "yuv420p"),
    ("[a][b]vstack", {"a": 4, "b": 2}, "gbrp"),
    ("[a][b][c]hstack=inputs=3", {"a": 3, "b": 3, "c": 3}, "yuv420p10le"),
    ("[a][b][c]maskedmerge", {"a": 4, "b": 4, "c": 4}, "yuv420p"),
    ("[a][b][c]maskedmerge", {"a": 4, "b": 4, "c": 2}, "gbrp"),
]


@pytest.mark.parametrize("w,h", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("text,ins,fmt", MULTI,
                         ids=[f"{m[0]}-{m[2]}" for m in MULTI])
def test_multi_input_filters_match_reference(text, ins, fmt, w, h):
    """FIFO pairing; an input that ends first (EOF) leaves the others'
    later frames unpaired, in both packages."""
    feeds = {k: frames_both(fmt, n, w, h, seed=i)
             for i, (k, n) in enumerate(ins.items())}
    short = tuple(k for k, n in ins.items() if n < max(ins.values()))
    want, got, _, _ = run_both(text, feeds, eof_early=short)
    assert len(got["out"]) == min(ins.values())
    check_frames(want["out"], got["out"],
                 "lsb" if "maskedmerge" in text else "exact")


def test_limiter_bounds_outside_the_type_raise_as_the_reference():
    """numpy refuses np.clip(uint8 plane, 0, 65535): the default max
    raises OverflowError on 8-bit planes in both packages."""
    ref_in, port_in = frames_both("yuv420p", 1, 16, 8)
    with pytest.raises(OverflowError):
        ref_parse_graph("limiter").run(ref_in)
    with pytest.raises(OverflowError):
        parse_graph("limiter", device="cpu").run(port_in)


def _float_frames(n, w, h, trc="unspecified", side=None):
    """Linear-light gbrpf32le frames (0..6) from the seeded clip."""
    clip = frames_both("gbrp", n, w, h)
    ref, port = [], []
    for r, p in zip(*clip):
        planes = [np.asarray(x).astype(np.float32) / 255 * 6
                  for x in r.planes]
        for mod, rat, out in ((RefFrame, RefRational, ref),
                              (Frame, Rational, port)):
            f = mod.video(w, h, "gbrpf32le", planes=planes, pts=r.pts,
                          time_base=rat(1, 25), color_trc=trc)
            f.side_data.update(side or {})
            out.append(f)
    return ref, port


@pytest.mark.parametrize("w,h", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("text,trc,side", [
    ("tonemap=tonemap=hable", "smpte2084", None),
    ("tonemap=tonemap=reinhard:param=0.5", "unspecified",
     {"content_light_level": {"max_cll": 400}}),
    ("tonemap=tonemap=mobius:desat=0", "arib-std-b67", None),
    ("tonemap=tonemap=gamma:peak=8", "unspecified", None),
    ("tonemap=tonemap=linear:param=0.8", "unspecified",
     {"mastering_display_metadata": {"max_luminance": 1000}}),
    ("tonemap=tonemap=clip", "unspecified", None),
    ("tonemap", "smpte2084", None)])
def test_tonemap_matches_reference(text, trc, side, w, h):
    want, got, _, _ = run_both(text, {"in": _float_frames(2, w, h, trc,
                                                          side)})
    check_frames(want["out"], got["out"], "rel")


def test_colorspace_without_output_primaries_raises_as_the_reference():
    """`space` alone leaves the output primaries and transfer empty; they
    differ from the input's defaults, and the table lookup of '' raises
    KeyError in both packages."""
    ref_in, port_in = frames_both("yuv420p", 1, 16, 8)
    text = "colorspace=space=bt470bg:ispace=bt709"
    with pytest.raises(KeyError):
        ref_parse_graph(text).run(ref_in)
    with pytest.raises(KeyError):
        parse_graph(text, device="cpu").run(port_in)


def test_tonemap_refuses_integer_input_as_the_reference():
    from ffmpeg_tpu.utils.error import InvalidData as RefInvalid
    from ffmpeg_tpu_torch.utils.error import InvalidData as PortInvalid
    ref_in, port_in = frames_both("gbrp", 1, 16, 8)
    with pytest.raises(RefInvalid):
        ref_parse_graph("tonemap").run(ref_in)
    with pytest.raises(PortInvalid):
        parse_graph("tonemap", device="cpu").run(port_in)


SOURCES = [
    # (name, args, frames, bar)
    ("color", "color=red:size={w}x{h}", 2, "exact"),
    ("color", "color=0x336699:size={w}x{h}:rate=30", 1, "exact"),
    ("testsrc", "size={w}x{h}", 3, "exact"),
    ("testsrc2", "size={w}x{h}:rate=50", 3, "exact"),
    ("mandelbrot", "size={w}x{h}:maxiter=64", 2, "lsb"),
]


@pytest.mark.parametrize("w,h", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("name,args,n,bar", SOURCES,
                         ids=[f"{s[0]}-{s[1]}" for s in SOURCES])
def test_video_sources_match_reference(name, args, n, bar, w, h):
    """The sources generate on their `device` (set here to the CPU, as
    the graph sets its own)."""
    a = args.format(w=w, h=h)
    want = list(ref_get_filter(name)(a).generate(n))
    src = get_filter(name)(a)
    src.device = torch.device("cpu")
    got = list(src.generate(n))
    check_frames(want, got, bar)


@pytest.mark.parametrize("name,args", [
    ("sine", "frequency=1000:sample_rate=48000:samples_per_frame=480"),
    ("sine", ""), ("anullsrc", "channels=6:samples_per_frame=256")])
def test_audio_sources_match_reference(name, args):
    want = list(ref_get_filter(name)(args).generate(3))
    got = list(get_filter(name)(args).generate(3))
    assert len(got) == len(want) == 3
    for g, r in zip(got, want):
        assert (g.pts, g.sample_rate, g.nb_samples, g.format) == \
            (r.pts, r.sample_rate, r.nb_samples, r.format)
        assert all(isinstance(p, np.ndarray) for p in g.planes)
        np.testing.assert_array_equal(g.audio_data, r.audio_data)


def test_nullsink_swallows_frames():
    ref_in, port_in = frames_both("yuv420p", 3, 16, 8)
    assert ref_parse_graph("nullsink").run(ref_in) == []
    assert parse_graph("nullsink", device="cpu").run(port_in) == []


def test_extractplanes_side_data_and_formats():
    want, got, _, _ = run_both("extractplanes=planes=y+v",
                               {"in": frames_both("yuv420p10le", 1, 37,
                                                  23)})
    assert [f.side_data["plane"] for f in got["out"]] == ["y", "v"]
    assert [f.format for f in got["out"]] == ["gray16le"] * 2
    for r, p in zip(want["out"], got["out"]):
        same_props(r, p)


def _chain_names(text: str) -> set:
    import re
    return set(re.findall(r"(?:^|[,;\]])([a-z0-9]+)(?==|,|;|\[|$)", text))


def test_chip_chains_cover_every_new_filter():
    """chip_smoke.py's phase-24 chains, its sources and its audio sources
    run each of the 72 filters of video2-video8 and sources.py."""
    from ffmpeg_tpu.filters import (sources, video2, video3, video4, video5,
                                    video6, video7, video8)
    from ffmpeg_tpu_torch import testing as fx
    mods = {m.__name__ for m in (sources, video2, video3, video4, video5,
                                 video6, video7, video8)}
    new = {n for n in ref_get_filter.__globals__["_FILTERS"]
           if ref_get_filter(n).__module__ in mods}
    assert len(new) == 72
    used = set().union(*(_chain_names(c.text) for c in fx.FILTER_CHAINS))
    used |= {s[0] for s in fx.FILTER_SOURCES} | {"sine", "anullsrc"}
    assert new <= used, sorted(new - used)


@pytest.mark.parametrize("name", [
    c.name for c in __import__("ffmpeg_tpu_torch.testing",
                               fromlist=["x"]).FILTER_CHAINS
    if len(c.inputs) > 1 or len(c.outs) > 1 or ";" in c.text])
def test_chip_chains_match_reference_at_a_small_size(name):
    """Each phase-24 graph of several inputs, outputs or chains at 96x56
    (its inputs at their divisors) through both packages, wired by its
    labels as on the card, under the chain's bar; the metric chain's
    scores within 1e-9 relative.  (Every filter of the single-input
    chains is held against the reference by the tests of its module,
    and every chain at 1080p by the committed golden.)"""
    from ffmpeg_tpu_torch import testing as fx
    chain = next(c for c in fx.FILTER_CHAINS if c.name == name)
    ref_in = fx.filter_chain_inputs(chain, 96, 56, (RefFrame, RefRational))
    port_in = fx.filter_chain_inputs(chain, 96, 56)
    feeds = {k: (ref_in[k], port_in[k]) for k in ref_in}
    text = chain.text.format(cube=fx.FILTER_CUBE)
    want, got, ref_g, port_g = run_both(text, feeds, chain.outs,
                                        chain.eof_early)
    for o in chain.outs:
        check_frames(want[o], got[o], chain.bar)
    for k, v in fx.chain_scores(ref_g, chain).items():
        p = fx.chain_scores(port_g, chain)[k]
        assert len(p) == len(v) > 0
        assert all(abs(a - b) <= 1e-9 * abs(b) for a, b in zip(p, v))
