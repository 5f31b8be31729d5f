"""The port's filter layer (ffmpeg_tpu_torch/filters/) against the
reference's (ffmpeg_tpu/filters/), on the CPU: every filter of
filters/video.py through parse_graph on both packages, on the same
seeded 64x48 planes, alone and with a leading batch dim; and every filter
of filters/audio.py on the same seeded 48 kHz stereo frames.

Tolerances:
- exact for crop, pad, hflip, vflip, transpose, copy, null and lut (data
  movement and table lookups), and for the frame counts and pts of fps,
  trim and setpts;
- scale and format within 1 LSB on <= 1% of samples: float32 sums in
  another order before floor(x + 0.5);
- tensornorm within 1e-6 on the same uint8 input: (x/scale - mean)/std
  in float32 in the reference's order, outputs of magnitude < 3 where a
  float32 ulp is 2.4e-7;
- the audio filters exact (host numpy, the reference's code), except
  where they resample: within 1e-6 on float samples (float32 FIR sums in
  another order) and 1 LSB on integer samples; frame counts, pts, rates,
  formats and layouts exact.
"""

import numpy as np
import pytest
import torch

from ffmpeg_tpu.core.frame import Frame as RefFrame
from ffmpeg_tpu.filters import filter_names as ref_filter_names
from ffmpeg_tpu.filters import parse_graph as ref_parse_graph
from ffmpeg_tpu.filters import audio as ref_audio
from ffmpeg_tpu.filters import video as ref_video
from ffmpeg_tpu.filters.base import Filter as RefFilter
from ffmpeg_tpu.utils.rational import Rational as RefRational
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.filters import (FilterGraph, filter_names, get_filter,
                                      parse_graph)
from ffmpeg_tpu_torch.filters.base import VideoProps
from ffmpeg_tpu_torch.scale.swscale import Scaler
from ffmpeg_tpu_torch.utils.error import FilterNotFound, InvalidData
from ffmpeg_tpu_torch.utils.rational import Rational

W, H = 64, 48


def _planes(fmt, lead=(), seed=0, w=W, h=H):
    """Seeded planes of `fmt` at w x h: smooth content plus noise."""
    from ffmpeg_tpu_torch.formats import pixfmt
    desc = pixfmt.get(fmt)
    rng = np.random.default_rng(seed)
    maxv = (1 << desc.depth) - 1
    out = []
    for i in range(desc.nb_components):
        cw, ch = (desc.chroma_dims(w, h)
                  if i in (1, 2) and not desc.is_rgb else (w, h))
        yy, xx = np.mgrid[0:ch, 0:cw]
        base = maxv / 2 * (1 + 0.8 * np.sin(xx / (3 + i) + yy / 5.0))
        noise = rng.normal(0, maxv / 12, lead + (ch, cw))
        out.append(np.clip(base + noise, 0, maxv)
                   .astype(desc.component_dtype()))
    return out


def _frames(fmt, lead=(), n=1, color_range="unspecified", w=W, h=H):
    ref, port = [], []
    for k in range(n):
        planes = _planes(fmt, lead, seed=k, w=w, h=h)
        kw = dict(pts=k, time_base=(1, 25), color_range=color_range)
        ref.append(RefFrame.video(w, h, fmt, planes=planes,
                                  **_kw(kw, RefRational)))
        port.append(Frame.video(w, h, fmt, planes=planes,
                                **_kw(kw, Rational)))
    return ref, port


def _kw(kw, rational):
    return {**kw, "time_base": rational(*kw["time_base"])}


def _run(text, fmt, lead=(), n=1, color_range="unspecified", w=W, h=H):
    ref_in, port_in = _frames(fmt, lead, n, color_range, w, h)
    ref_g, port_g = ref_parse_graph(text), parse_graph(text, device="cpu")
    assert [nd.filter.name for nd in port_g.nodes] == \
        [nd.filter.name for nd in ref_g.nodes]
    return ref_g.run(ref_in), port_g.run(port_in)


def _same_props(r, p):
    assert (p.width, p.height, p.format, p.pts, p.color_range,
            p.color_space) == (r.width, r.height, r.format, r.pts,
                               r.color_range, r.color_space)
    assert (p.time_base.num, p.time_base.den) == (r.time_base.num,
                                                  r.time_base.den)


EXACT = [
    ("crop=32:24:8:4", "yuv420p"),
    ("crop=iw/2:ih/2", "yuv420p"),
    ("crop=w=40:h=30:x=3:y=5", "rgb24"),
    ("pad=80:64:8:8", "yuv420p"),
    ("pad=w=iw+16:h=ih+8", "yuv420p"),
    ("pad=96:64", "yuv420p10le"),
    ("pad=72:56:4:4", "rgb24"),
    ("hflip", "yuv420p"),
    ("vflip", "yuv420p10le"),
    ("hflip,vflip", "yuv444p"),
    ("transpose", "yuv420p"),
    ("transpose=1", "yuv420p"),
    ("transpose=2", "gray"),
    ("transpose=3", "yuv420p10le"),
    ("copy", "yuv420p"),
    ("null", "yuv420p"),
    ("lut=c0=maxval-val:c1=val/2:c2=clip(val*2\\,0\\,255)", "yuv420p"),
    ("lut=c0=val*3/4", "yuv420p10le"),
    ("crop=48:40:0:2,hflip,pad=64:48:8:4", "yuv420p"),
]


@pytest.mark.parametrize("lead", [(), (3,)], ids=["frame", "batch3"])
@pytest.mark.parametrize("text,fmt", EXACT, ids=[e[0] for e in EXACT])
def test_exact_filters_match_reference(text, fmt, lead):
    ref, port = _run(text, fmt, lead)
    assert len(port) == len(ref) == 1
    _same_props(ref[0], port[0])
    for r, p in zip(ref[0].planes, port[0].planes):
        assert isinstance(p, torch.Tensor) and p.device.type == "cpu"
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


SCALED = [
    ("scale=32:24", "yuv420p", "unspecified"),
    ("scale=40:-2:flags=bilinear", "yuv420p", "pc"),
    ("scale=w=iw*2:h=ih*2:flags=lanczos", "yuv420p", "unspecified"),
    ("scale=32:32:format=rgb24", "yuv420p", "pc"),
    ("scale=56:42:format=yuv420p:out_range=pc", "yuv420p", "unspecified"),
    ("format=pix_fmts=rgb24", "yuv420p", "unspecified"),
    ("format=pix_fmts=yuv444p", "yuv420p", "unspecified"),
    ("format=pix_fmts=gray", "rgb24", "pc"),
    ("scale=48:36,crop=40:30,transpose=1", "yuv420p", "unspecified"),
]


@pytest.mark.parametrize("lead", [(), (2,)], ids=["frame", "batch2"])
@pytest.mark.parametrize("text,fmt,rng", SCALED, ids=[s[0] for s in SCALED])
def test_scale_and_format_within_one_lsb(text, fmt, rng, lead):
    ref, port = _run(text, fmt, lead, color_range=rng)
    assert len(port) == len(ref) == 1
    _same_props(ref[0], port[0])
    for r, p in zip(ref[0].planes, port[0].planes):
        r = np.asarray(r)
        assert p.numpy().dtype == r.dtype and p.shape == r.shape
        d = np.abs(p.numpy().astype(np.int64) - r.astype(np.int64))
        assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(),
                                                          (d > 0).mean())


ODD = [
    # every filter of filters/video.py at odd sizes, under its bar above
    ("crop=iw/2:ih/2", "yuv420p", "exact"),
    ("crop=w=20:h=12:x=3:y=5", "rgb24", "exact"),
    ("pad=w=iw+16:h=ih+8", "yuv420p", "exact"),
    ("pad=w=iw+9:h=ih+5:x=3:y=1", "yuv420p10le", "exact"),
    ("hflip", "yuv420p", "exact"),
    ("vflip", "yuv420p10le", "exact"),
    ("transpose=1", "yuv420p", "exact"),
    ("transpose=3", "yuv444p", "exact"),
    ("copy", "yuv420p", "exact"),
    ("null", "yuv420p", "exact"),
    ("lut=c0=maxval-val:c1=val/2", "yuv420p", "exact"),
    ("scale=32:24", "yuv420p", "lsb"),
    ("scale=w=iw*2:h=ih*2:flags=bilinear:format=rgb24", "yuv420p", "lsb"),
    ("format=pix_fmts=rgb24", "yuv420p", "lsb"),
    ("format=pix_fmts=yuv444p", "yuv420p", "lsb"),
    ("tensornorm", "rgb24", "1e-6"),
    ("fps=10", "gray", "exact"),
    ("trim=start_frame=2:end_frame=5", "gray", "exact"),
    ("setpts=2*PTS", "gray", "exact"),
]


@pytest.mark.parametrize("w,h", [(37, 23), (33, 19)],
                         ids=["37x23", "33x19"])
@pytest.mark.parametrize("text,fmt,bar", ODD, ids=[o[0] for o in ODD])
def test_video_filters_at_odd_sizes(text, fmt, bar, w, h):
    """Odd widths and heights give odd chroma sizes (ceil of half) and
    crop/pad origins that snap to the chroma grid."""
    n = 10 if text.split("=")[0] in ("fps", "trim", "setpts") else 1
    ref, port = _run(text, fmt, n=n, w=w, h=h)
    assert len(port) == len(ref) > 0
    for r, f in zip(ref, port):
        _same_props(r, f)
        for a, p in zip(r.planes, f.planes):
            a, p = np.asarray(a), p.numpy()
            assert p.dtype == a.dtype and p.shape == a.shape
            if bar == "exact":
                np.testing.assert_array_equal(p, a)
            elif bar == "1e-6":
                np.testing.assert_allclose(p, a, rtol=0, atol=1e-6)
            else:
                d = np.abs(p.astype(np.int64) - a.astype(np.int64))
                assert d.max() <= 1 and (d > 0).mean() <= 0.01, \
                    (d.max(), (d > 0).mean())


@pytest.mark.parametrize("text", [
    "tensornorm", "tensornorm=mean=0.45:std=0.225",
    "tensornorm=mean=0.5\\,0.4\\,0.3:std=0.2\\,0.3\\,0.25:scale=256"])
@pytest.mark.parametrize("lead", [(), (4,)], ids=["frame", "batch4"])
def test_tensornorm_within_1e6(text, lead):
    ref, port = _run(text, "rgb24", lead)
    for r, p in zip(ref[0].planes, port[0].planes):
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)


def test_dataloader_graph_fuses_and_keeps_the_batch():
    """benchrows.dataloader_row's graph at a small size: (4, 64, 64)
    yuv420p → one fused node, three (4, 50, 50) float32 planes."""
    text = "scale=56:56:format=rgb24,crop=50:50:3:3," \
        "tensornorm=mean=0.45:std=0.225"
    ref, port = _run(text, "yuv420p", (4,))
    g = parse_graph(text, device="cpu")
    assert [n.name for n in g.nodes] == ["scale"]
    assert [n.filter.name for n in g.nodes] == ["scale+crop+tensornorm"]
    for r, p in zip(ref[0].planes, port[0].planes):
        assert tuple(p.shape) == (4, 50, 50) and p.dtype == torch.float32
        # within 1 LSB of rgb24, after normalisation
        assert np.abs(p.numpy() - np.asarray(r)).max() <= \
            1 / (255 * 0.225) + 1e-5


@pytest.mark.parametrize("text", [
    "scale=224:224:format=rgb24,tensornorm", "crop=32:32,hflip;",
    "[in]scale=32:24[a];[a]vflip[out]", "fps=30,scale=32:24",
    "scale=32:24,setpts=2*PTS,crop=16:16"])
def test_parse_graph_fuses_as_the_reference(text):
    ref, port = ref_parse_graph(text), parse_graph(text, device="cpu")
    assert [(n.name, n.filter.name) for n in port.nodes] == \
        [(n.name, n.filter.name) for n in ref.nodes]
    assert sorted(port.inputs) == sorted(ref.inputs)
    assert sorted(port.outputs) == sorted(ref.outputs)


@pytest.mark.parametrize("text", [
    "fps=10", "fps=50", "fps=30000/1001", "trim=start=0.1:end=0.3",
    "trim=start_frame=2:end_frame=5", "setpts=2*PTS", "setpts=N*10+3",
    "fps=10,setpts=PTS-1"])
def test_rate_and_timestamp_filters_match_reference(text):
    ref, port = _run(text, "gray", n=10)
    assert len(port) == len(ref)
    for r, p in zip(ref, port):
        _same_props(r, p)
        np.testing.assert_array_equal(p.planes[0].numpy(),
                                      np.asarray(r.planes[0]))


def test_registry_holds_video_py_only():
    """The registry holds the filters of video.py, of audio.py (since the
    audio slice), of video2-video8 and sources.py (since the video
    filters' slice) and of the host audio modules audio2-audio6 (since
    the rest of the audio): all of the reference's, each of those 29
    from the port's copy of its module."""
    from ffmpeg_tpu.filters import audio2, audio3, audio4, audio5, audio6

    def names(mod):
        return sorted(c.name for c in vars(mod).values()
                      if isinstance(c, type) and issubclass(c, RefFilter)
                      and c.__module__ == mod.__name__
                      and not c.__name__.startswith("_"))
    assert len(names(ref_video)) == 14 and len(names(ref_audio)) == 10
    from ffmpeg_tpu.filters import get_filter as ref_get_filter
    mods = {m.__name__ for m in (audio2, audio3, audio4, audio5, audio6)}
    host_audio = sorted(n for n in ref_filter_names()
                        if ref_get_filter(n).__module__ in mods)
    assert len(host_audio) == 29
    assert filter_names() == ref_filter_names()
    assert len(filter_names()) == 125
    for name in host_audio:
        assert get_filter(name).__module__ == "ffmpeg_tpu_torch" + \
            ref_get_filter(name).__module__[len("ffmpeg_tpu"):]
    with pytest.raises(FilterNotFound):
        get_filter("no_such_filter")


def test_props_cache_hits_across_frames():
    """Props hold Rationals: equal props from two frames must hit the
    same cache entry, so a filter is built once per stream."""
    g = parse_graph("scale=32:24,crop=16:16", device="cpu")
    _, frames = _frames("yuv420p", n=3)
    g.run(frames)
    chain = g.nodes[0].filter
    assert len(chain._tracer_cache) == 1 and len(chain._cache) == 1
    a = VideoProps(W, H, "yuv420p", Rational(1, 25))
    assert hash(a) == hash(VideoProps(W, H, "yuv420p", Rational(1, 25)))


def test_graph_moves_numpy_planes_and_refuses_other_devices():
    _, frames = _frames("yuv420p")
    np_frame = frames[0]
    out = parse_graph("hflip", device="cpu").run([np_frame])
    assert all(isinstance(p, torch.Tensor) for p in out[0].planes)
    assert all(isinstance(p, np.ndarray) for p in np_frame.planes)
    t_frame = np_frame.clone_props()
    t_frame.planes = [torch.from_numpy(p) for p in np_frame.planes]
    with pytest.raises(InvalidData):
        FilterGraph(device="meta").feed(t_frame)
    with pytest.raises(InvalidData):
        parse_graph("hflip", device="meta").feed(t_frame)
    sc = Scaler("meta", src_w=W, src_h=H, src_fmt="yuv420p", dst_w=32,
                dst_h=24, dst_fmt="rgb24")
    with pytest.raises(InvalidData):
        sc.run(t_frame.planes)


# --- the audio filters -----------------------------------------------------

def _audio_frames(fmt="fltp", layout="stereo", n=4, size=480, rate=48000):
    """Seeded audio frames for both packages: a sine per channel plus
    noise, in `fmt`, pts counting samples in 1/rate."""
    from ffmpeg_tpu.formats import samplefmt as ref_sf
    from ffmpeg_tpu.formats.channel_layout import ChannelLayout as RefLayout
    from ffmpeg_tpu_torch.formats.channel_layout import ChannelLayout
    rng = np.random.default_rng(11)
    nch = ChannelLayout.from_string(layout).nb_channels
    t = np.arange(n * size) / rate
    x = np.stack([0.4 * np.sin(2 * np.pi * (300 + 200 * c) * t)
                  for c in range(nch)]) + rng.normal(0, 0.05, (nch, n * size))
    data = ref_sf.from_float(x.astype(np.float32), fmt)
    ref, port = [], []
    for k in range(n):
        chunk = data[:, k * size:(k + 1) * size]
        kw = dict(pts=k * size)
        ref.append(RefFrame.audio(chunk, rate, fmt,
                                  RefLayout.from_string(layout),
                                  time_base=RefRational(1, rate), **kw))
        port.append(Frame.audio(chunk, rate, fmt,
                                ChannelLayout.from_string(layout),
                                time_base=Rational(1, rate), **kw))
    return ref, port


def _audio_run(g, frames, ins, outs):
    """Feed `frames` to every input label in turn, then EOF; collect every
    output label."""
    got = {o: [] for o in outs}
    for f in frames:
        for i in ins:
            g.feed(f.clone_props(), i)
        for o in outs:
            got[o].extend(g.pull(o))
    for i in ins:
        g.feed_eof(i)
    for o in outs:
        got[o].extend(g.pull(o))
    return got


AUDIO = [
    # (graph, input format, input labels, output labels, resamples)
    ("anull", "fltp", ["in"], ["out"], False),
    ("volume=0.5", "fltp", ["in"], ["out"], False),
    ("volume=6dB", "s16", ["in"], ["out"], False),
    ("aresample=16000", "fltp", ["in"], ["out"], True),
    ("aresample=44100", "s16", ["in"], ["out"], True),
    ("aformat=channel_layouts=mono", "fltp", ["in"], ["out"], False),
    ("aformat=sample_fmts=s16:sample_rates=8000", "fltp", ["in"], ["out"],
     True),
    ("aresample=16000,aformat=channel_layouts=mono", "fltp", ["in"],
     ["out"], True),
    ("atrim=start=0.005:end=0.025", "fltp", ["in"], ["out"], False),
    ("atrim=end=0.02", "s16", ["in"], ["out"], False),
    ("apad=pad_len=100", "s16", ["in"], ["out"], False),
    ("asplit[a][b]", "fltp", ["in"], ["a", "b"], False),
    ("[a][b]amix[out]", "s16", ["a", "b"], ["out"], False),
    ("channelsplit", "fltp", ["in"], ["out"], False),
    ("pan=1:0.5:0.5", "fltp", ["in"], ["out"], False),
]


@pytest.mark.parametrize("text,fmt,ins,outs,resamples", AUDIO,
                         ids=[a[0] for a in AUDIO])
def test_audio_filters_match_reference(text, fmt, ins, outs, resamples):
    ref_in, port_in = _audio_frames(fmt)
    ref_g, port_g = ref_parse_graph(text), parse_graph(text, device="cpu")
    assert [nd.filter.name for nd in port_g.nodes] == \
        [nd.filter.name for nd in ref_g.nodes]
    want = _audio_run(ref_g, ref_in, ins, outs)
    got = _audio_run(port_g, port_in, ins, outs)
    for o in outs:
        assert len(got[o]) == len(want[o]) > 0, o
        for g, w in zip(got[o], want[o]):
            assert (g.pts, g.sample_rate, g.nb_samples, g.format,
                    g.side_data) == (w.pts, w.sample_rate, w.nb_samples,
                                     w.format, w.side_data)
            assert (g.ch_layout.mask, g.ch_layout.nb_channels) == \
                (w.ch_layout.mask, w.ch_layout.nb_channels)
            assert all(isinstance(p, np.ndarray) for p in g.planes)
            a, b = g.audio_data, np.asarray(w.audio_data)
            assert a.dtype == b.dtype and a.shape == b.shape
            if not resamples:
                np.testing.assert_array_equal(a, b)
            elif a.dtype.kind == "f":
                assert float(np.abs(a - b).max()) <= 1e-6
            else:
                assert int(np.abs(a.astype(np.int64) - b).max()) <= 1


def test_resampling_filters_run_on_the_graphs_device():
    """aresample's SwrContext takes the graph's device; the audio planes
    stay on the host through the graph."""
    _, frames = _audio_frames()
    g = parse_graph("aresample=16000", device="meta")
    assert g.nodes[0].filter.device == torch.device("meta")
    with pytest.raises(NotImplementedError):    # no kernels on "meta"
        g.run(frames)
    out = parse_graph("aresample=16000", device="cpu").run(frames)
    assert all(isinstance(p, np.ndarray) for f in out for p in f.planes)
