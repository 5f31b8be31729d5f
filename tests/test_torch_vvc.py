"""The port's VVC decoder (ffmpeg_tpu_torch/codecs/vvc/) and host thread
pools (parallel/executor.py, pipeline.py) against the reference's, on
the CPU:

- each module is the reference's code: its top-level statements equal the
  reference's as syntax trees, but for those named in CHANGED;
- every picture of the crafted streams of the reference's tests
  (tests/test_vvc.py, test_vvc_mtt.py, test_vvc_inter.py: intra modes,
  chroma modes, QT and MTT trees, I P B B, P only, low-delay B, four
  references, large MVDs, merge lists, 10-bit), crafted by the
  reference's writer at 32x32 to 96x64, decodes byte for byte to the
  reference VvcDecoder's planes; with threads=4 (per-CTU wavefront tasks
  on the executor) to the serial path's;
- the port's writer (craft.py) writes the reference's bytes for the same
  seeded plans, and the committed GOPs of phase 30 decode to the
  reference's sha256;
- a frame's planes are the DPB's arrays, as in the reference: each frame
  held while the decoder goes on keeps its picture;
- Pipeline, batched, Scheduler (the DTS choke, errors) and Executor
  behave as the reference's tests (tests/test_pipeline.py) hold them.
"""

import hashlib
import threading
import time

import numpy as np
import pytest
import torch

from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.codecs.vvc import craft as ref_craft
from ffmpeg_tpu.codecs.vvc.ctu import Plan as RefPlan
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io.stream import CodecParameters as RefPar
from ffmpeg_tpu.io.stream import MediaType as RefType
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import CodecContext
from ffmpeg_tpu_torch.codecs.vvc import craft
from ffmpeg_tpu_torch.codecs.vvc.ctu import Plan
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.io import open_input
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType
from ffmpeg_tpu_torch.parallel.executor import Executor, Task
from ffmpeg_tpu_torch.parallel.pipeline import Pipeline, Scheduler, batched
from ffmpeg_tpu_torch.utils.error import TryAgain

from test_vvc import FP, TexturePlan
from test_vvc_inter import _gop
from test_vvc_mtt import MttPlan, _mtt_stream
from torch_io_util import differing

CHANGED = {
    "codecs/vvc/__init__.py": {"<imports>", "VvcDecoder"},
    "codecs/vvc/cabac.py": set(), "codecs/vvc/craft.py": set(),
    "codecs/vvc/ctu.py": set(), "codecs/vvc/inter.py": set(),
    "codecs/vvc/params.py": set(), "codecs/vvc/tables.py": set(),
    "parallel/__init__.py": set(), "parallel/executor.py": set(),
    "parallel/pipeline.py": set(),
}


@pytest.mark.parametrize("rel", sorted(CHANGED))
def test_module_is_the_reference_code(rel):
    assert differing(rel) == CHANGED[rel]


def _rng(seed):
    return np.random.default_rng(seed)


# name → the stream, crafted by the reference's writer with the plans of
# the reference's own tests
STREAMS = {
    "intra_mode18": lambda: ref_craft.craft_frame(
        TexturePlan(_rng(42), 18, maxn=60, amp=40), 32, 32),
    "intra_mode61": lambda: ref_craft.craft_frame(
        TexturePlan(_rng(42), 61, maxn=60, amp=40), 32, 32),
    "chroma_mode2": lambda: ref_craft.craft_frame(
        FP(_rng(1), mode=30, chroma=2, docbf=True, maxn=8, amp=12), 32, 32),
    "multi_ctu": lambda: ref_craft.craft_frame(
        FP(_rng(100), rand_split=True, rand_cbf=True, maxn=12, amp=20),
        64, 64),
    "nonsquare": lambda: ref_craft.craft_frame(
        FP(_rng(7), rand_split=True, rand_cbf=True, maxn=8, amp=15),
        96, 64),
    "mtt_random": lambda: _mtt_stream(MttPlan(_rng(3)), 64, 64),
    "mtt_rect50": lambda: _mtt_stream(
        MttPlan(_rng(50), stop_p=0.25, mode=50, chroma=4, cbf_p=0.5),
        64, 32),
    "mtt_border": lambda: _mtt_stream(MttPlan(_rng(7), stop_p=0.4), 48, 40),
    "mtt_10bit": lambda: _mtt_stream(MttPlan(_rng(11), amp=40), 64, 64,
                                     bit_depth=10),
    "ipbb": lambda: _gop(1, "IPBB", 64, 64, nrefs=(2, 1)),
    "p_only": lambda: _gop(10, "IPPPP", 96, 64, nrefs=(2, 1)),
    "b_lowdelay": lambda: _gop(11, "IBBBB", 64, 64, nrefs=(2, 2)),
    "multi_ref": lambda: _gop(12, "IPPPPPPP", 64, 64, nrefs=(4, 1)),
    "big_mvd": lambda: _gop(13, "IPPP", 64, 64, plan_kw={
        "mvd_amp": 700, "modes": ("amvp",)}, nrefs=(2, 1)),
    "inter_mtt": lambda: _gop(14, "IPBPBB", 64, 64, plan_kw={"stop_p": 0.4},
                              mtt_depth_inter=2, mtt_depth_intra=2,
                              nrefs=(2, 2)),
    "merge2": lambda: _gop(16, "IBBB", 64, 64, plan_kw={"max_merge": 2},
                           max_num_merge_cand=2, nrefs=(2, 2)),
    "inter_10bit": lambda: _gop(18, "IPBB", 64, 64, plan_kw={"amp": 40},
                                bit_depth=10, nrefs=(2, 2)),
    "deep_mix": lambda: _gop(19, "IPBPBBPB", 96, 64, plan_kw={
        "stop_p": 0.35}, mtt_depth_inter=3, mtt_depth_intra=3,
        nrefs=(2, 2), max_num_merge_cand=5),
}
THREADED = ("multi_ctu", "mtt_random", "inter_mtt", "deep_mix",
            "inter_10bit")


def _ref_planes(data, threads=1):
    par = RefPar(codec_type=RefType.VIDEO, codec_id="vvc")
    frames = RefContext.open_decoder(par, options={"threads": threads}) \
        .decode_all([RefPacket(data=data, pts=0)])
    return [[np.asarray(p) for p in f.planes] for f in frames]


def _port_frames(data, threads=1):
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="vvc")
    return CodecContext.open_decoder(par, options={"threads": threads},
                                     device="cpu").decode_all(
        [Packet(data=data, pts=0)])


def _planes(frames):
    return [[p.numpy() for p in f.planes] for f in frames]


def _equal(got, want):
    assert len(got) == len(want) >= 1
    for i, (g, w) in enumerate(zip(got, want)):
        for pl, (a, b) in enumerate(zip(g, w)):
            assert a.dtype == b.dtype and a.shape == b.shape, (i, pl)
            assert np.array_equal(a, b), f"picture {i} plane {pl}"


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_vvc_pictures_equal_the_references(name):
    data = STREAMS[name]()
    frames = _port_frames(data)
    want = _ref_planes(data)
    _equal(_planes(frames), want)
    ten = "10bit" in name
    for f in frames:
        assert f.format == ("yuv420p10le" if ten else "yuv420p")
        assert all(isinstance(p, torch.Tensor) and p.device.type == "cpu"
                   and p.dtype == (torch.uint16 if ten else torch.uint8)
                   for p in f.planes)
    if name in THREADED:
        _equal(_planes(_port_frames(data, threads=4)), want)


@pytest.mark.parametrize("name", sorted(fx.VVC_GOPS))
def test_committed_gops_decode_to_the_references_sha256(name):
    """Phase 30 (y)'s GOPs: the reference's writer made them
    (tools/gen_torch_vvc_av1_fixture.py), and the port decodes them to
    the reference decoder's sha256, serial and with threads=4 (the
    832x480 GOP serial only: ~7 s a decode here; the card runs both)."""
    data = fx.vvc_av1_stream(name)
    got = [hashlib.sha256(p.numpy().tobytes()).hexdigest()
           for f in _port_frames(data) for p in f.planes]
    assert got == fx.vvc_golden(name)
    if name.startswith("vvc10"):
        got4 = [hashlib.sha256(p.numpy().tobytes()).hexdigest()
                for f in _port_frames(data, threads=4) for p in f.planes]
        assert got4 == got


def test_committed_gops_are_the_writers_bytes():
    """testing.craft_vvc with the port's writer and Plan writes the
    committed 416x240 10-bit GOP byte for byte, and with the reference's
    the reference tests' _gop bytes (the recipe)."""
    seed, kinds, w, h, plan_kw, kw = fx.VVC_GOPS["vvc10_416x240"]
    got = fx.craft_vvc(craft, Plan, seed, kinds, w, h, plan_kw, **kw)
    assert got == fx.vvc_av1_stream("vvc10_416x240")
    assert fx.craft_vvc(ref_craft, RefPlan, 19, "IPBB", 64, 64,
                        {"stop_p": 0.4}, nrefs=(2, 2)) == \
        _gop(19, "IPBB", 64, 64, plan_kw={"stop_p": 0.4}, nrefs=(2, 2))


@pytest.mark.parametrize("case", ["gop", "mtt", "plan", "qp"])
def test_port_writer_writes_the_references_bytes(case):
    """craft_gop and craft_frame of the port, driven by the same seeded
    plan as the reference's, write the same stream."""
    if case == "gop":
        a, b = (fx.craft_vvc(c, p, 20, "IPBB", 96, 64, {"stop_p": 0.5},
                             mtt_depth_inter=2, mtt_depth_intra=2,
                             nrefs=(2, 2))
                for c, p in ((craft, Plan), (ref_craft, RefPlan)))
    elif case == "mtt":
        a, b = (c.craft_frame(MttPlan(_rng(13), stop_p=0.2), 64, 64,
                              log2_min_cb=3, log2_min_qt=3,
                              mtt_depth_intra=4, log2_max_bt=4,
                              log2_max_tt=4)
                for c in (craft, ref_craft))
    elif case == "plan":
        a, b = (c.craft_frame(p(_rng(5)), 64, 64)
                for c, p in ((craft, Plan), (ref_craft, RefPlan)))
    else:
        a, b = (c.craft_frame(FP(_rng(9), rand_split=True, rand_cbf=True,
                                 maxn=10, amp=20), 32, 32, qp_delta=11,
                              cb_qp_offset=3, cr_qp_offset=-2)
                for c in (craft, ref_craft))
    assert a == b and len(a) > 30


def test_frames_alias_the_dpb_and_stay_intact(tmp_path):
    """Packet by packet (the raw vvc demuxer's access units), each frame
    is held while the decoder goes on: its planes are the DPB's own
    arrays (no copy on the CPU, as the reference hands out its numpy
    planes), the decoder never writes to them again, and every held
    frame ends equal to the reference's picture."""
    data = STREAMS["inter_mtt"]()
    path = tmp_path / "s.266"
    path.write_bytes(data)
    dm = open_input(str(path))
    dec = CodecContext.open_decoder(dm.streams[0].codecpar, device="cpu")
    held, snaps = [], []
    for pkt in dm.packets():
        dec.send_packet(pkt)
        for f in _drain(dec):
            poc = len(held)
            assert all(np.shares_memory(p.numpy(), d)
                       for p, d in zip(f.planes, dec.codec.dpb[poc]))
            held.append(f)
            snaps.append([p.numpy().copy() for p in f.planes])
    dm.close()
    assert len(held) == 6
    _equal(_planes(held), snaps)
    _equal(_planes(held), _ref_planes(data))


def _drain(ctx):
    out = []
    while True:
        try:
            out.append(ctx.receive_frame())
        except TryAgain:
            return out


# --- the host thread pools (tests/test_pipeline.py's checks) --------------

def test_pipeline_scheduler_order_and_flow():
    out = list(Pipeline(range(100), [lambda x: x * 2,
                                     lambda x: x + 1]).run())
    assert out == [i * 2 + 1 for i in range(100)]


def test_pipeline_error_propagates():
    def boom(x):
        if x == 5:
            raise ValueError("boom")
        return x

    with pytest.raises(ValueError):
        list(Pipeline(range(10), [boom]).run())


def test_pipeline_stats_drop_and_fan_out():
    """A stage's None drops its item and a list fans out; each stage
    counts its items and busy time."""
    p = Pipeline(range(10), [lambda x: None if x % 2 else [x, x],
                             lambda x: x + 100], names=["a", "b"])
    assert list(p.run()) == [100 + x for x in range(0, 10, 2)
                             for _ in range(2)]
    assert [s.name for s in p.stats] == ["source", "a", "b"]
    assert [s.items for s in p.stats] == [10, 10, 10]
    assert all(s.busy_s >= 0 for s in p.stats)


def test_batched():
    assert list(batched(range(7), 3)) == [[0, 1, 2], [3, 4, 5], [6]]


def test_scheduler_dts_choke():
    class P:
        def __init__(self, dts):
            self.dts = dts

    got_fast, got_slow, skew = [], [], []

    def fast(p):
        got_fast.append(p.dts)
        skew.append(p.dts - (got_slow[-1] if got_slow else -1))

    def slow(p):
        time.sleep(0.002)
        got_slow.append(p.dts)

    sch = Scheduler(tolerance=16, queue_size=4)
    sch.add_output("fast", fast)
    sch.add_output("slow", slow)
    sch.run((P(i) for i in range(300)), dts_of=lambda p: p.dts)
    assert got_fast == got_slow == list(range(300))
    assert max(skew) <= 16 + 2 * 4 + 1
    assert sch.max_queued <= 4


def test_scheduler_error_propagates():
    class P:
        def __init__(self, dts):
            self.dts = dts

    def bad(p):
        if p.dts == 5:
            raise RuntimeError("sink exploded")

    sch = Scheduler(tolerance=4, queue_size=2)
    sch.add_output("bad", bad)
    with pytest.raises(RuntimeError, match="sink exploded"):
        sch.run((P(i) for i in range(50)), dts_of=lambda p: p.dts)


def test_executor_runs_a_wavefront_in_dependency_order():
    """CTU-like tasks on a 5x4 grid, each ready once its left, top and
    top-right neighbours are done (the VVC decoder's shape), on 4
    workers: every task runs once, after its dependencies."""
    done, order, lock = set(), [], threading.Lock()
    W, H = 5, 4

    def ready(x, y):
        return all((nx, ny) in done for nx, ny in
                   ((x - 1, y), (x, y - 1), (x + 1, y - 1))
                   if 0 <= nx < W and ny >= 0)

    with Executor(workers=4) as ex:
        for y in range(H):
            for x in range(W):
                def run(x=x, y=y):
                    with lock:
                        assert ready(x, y)
                        done.add((x, y))
                        order.append((x, y))
                ex.submit(Task(run, priority=-(y * W + x),
                               ready=lambda x=x, y=y: ready(x, y)))
        ex.wait()
    assert sorted(order) == [(x, y) for x in range(W) for y in range(H)]


def test_executor_passes_a_task_error_to_wait():
    def boom():
        raise ValueError("task failed")

    with Executor(workers=2) as ex:
        ex.submit(Task(boom))
        with pytest.raises(ValueError, match="task failed"):
            ex.wait()
