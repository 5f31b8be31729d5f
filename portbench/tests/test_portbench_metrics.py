"""Each per-layer metric's arithmetic on a canned trace."""

import pytest

from portbench import run as bench
from portbench.core import trace as tr
from portbench.core.peaks import HBM_BYTES_PER_S, INT32_INSTR_PER_S

K1 = "(anonymous namespace)::jpeg_scan_decode_packed_kernel(unsigned char)"
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n"
H2D = "Memcpy HtoD (Pinned -> Device)"


def canned():
    """A 10 ms window: H2D 0-1 ms, K1 1-2 ms, a GEMM 2-4 ms, a GEMM 3-5 ms
    (overlapping), a memset 8-8.5 ms; the host in prep 0-6 ms, in
    run_batch 6-9 ms."""
    t = tr.Trace()
    t.window = (100.0, 100.010)
    ms = lambda a, b: (100.0 + a / 1e3, 100.0 + b / 1e3)
    t.device_ops = [(H2D, *ms(0, 1)), (K1, *ms(1, 2)), (GEMM, *ms(2, 4)),
                    (GEMM, *ms(3, 5)), ("Memset (Device)", *ms(8, 8.5))]
    t.host_spans = [("prep_frame", *ms(0, 6)), ("run_batch", *ms(6, 9))]
    return t


def ctx(counts, config=None):
    return bench.Context({"name": "c"}, config or {}, {}, counts, canned())


def read(name, c):
    return bench.metric_reader(name)(c)


@pytest.mark.parametrize("name", ["device_idle_pct", "device_idle_pct.clip"])
def test_idle_share(name):
    assert read(name, ctx({"frames": 8})) == pytest.approx(45.0)


def test_busy_and_breakdown():
    t = canned()
    assert t.busy_s() == pytest.approx(5.5e-3)
    b = tr.breakdown(t)
    assert b["device_ops"][0] == [GEMM, pytest.approx(4e-3)]
    gaps = dict(b["idle_gaps"])
    # idle 5-6 ms in prep, 6-8 and 8.5-9 in run_batch, 9-10 the harness
    assert gaps["prep_frame"] == pytest.approx(1e-3)
    assert gaps["run_batch"] == pytest.approx(2.5e-3)
    assert gaps["harness"] == pytest.approx(1e-3)


@pytest.mark.parametrize("suffix", ["", ".clip"])
def test_launches_and_copies(suffix):
    c = ctx({"frames": 8})
    assert read("launches_per_frame" + suffix, c) == pytest.approx(3 / 8)
    assert read("h2d_ms_per_frame" + suffix, c) == pytest.approx(1.0 / 8)


def test_k1_roofline_and_recon():
    nbytes, instr = HBM_BYTES_PER_S * 0.5e-3, 0   # half of K1's 1 ms
    c = ctx({"frames": 8, "k1_bytes": nbytes, "k1_instr": instr})
    assert read("k1_roofline", c) == pytest.approx(50.0)
    c.counts["k1_instr"] = INT32_INSTR_PER_S * 0.8e-3   # instructions bind
    assert read("k1_roofline", c) == pytest.approx(80.0)
    # recon: the GEMMs and the memset, 4.5 ms over 8 frames
    assert read("recon_ms_per_frame", c) == pytest.approx(4.5 / 8)
    assert nbytes / HBM_BYTES_PER_S == pytest.approx(0.5e-3)


def test_graph_roofline():
    cfg = {"src_w": 640, "src_h": 360, "crop": [224, 224, 116, 16]}
    c = ctx({"frames": 64}, cfg)
    per_frame = 640 * 360 * 3 // 2 + 224 * 224 * 3 * 4
    want = 100 * 64 * per_frame / HBM_BYTES_PER_S / 5.5e-3
    assert read("graph_roofline", c) == pytest.approx(want)


def test_prep_mean_and_silence():
    c = ctx({"frames": 8, "prep_s": [0.001, 0.003]})
    assert read("prep_ms_per_frame", c) == pytest.approx(2.0)
    # a reader with nothing to read returns nothing, never 0
    empty = ctx({"frames": 8})
    assert read("prep_ms_per_frame", empty) is None
    assert read("k1_roofline", empty) is None
    assert read("graph_roofline", empty) is None
