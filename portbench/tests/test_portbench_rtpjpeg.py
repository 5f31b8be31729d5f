"""The camera MJPEG cell, `rtpjpeg224.b64`: its RFC 2435 generator, its
4:2:2 plain reference, the cell cut to a small size on the CPU (the
program passes the check, the TF32 control fails it), the lane-skew
count and reader, and its entries in BENCHMARK.json."""

import importlib
import json
import time

import numpy as np
import pytest
import torch

from portbench import run as bench
from portbench.core.window import run_window
from portbench.inputs.mjpeg import _forward
from portbench.inputs.rtpjpeg import (AC_CHROMA, AC_LUMA, DC_CHROMA, DC_LUMA,
                                      make_clip)
from portbench.reference.mjpeg import MjpegReference
from portbench.reference.mjpeg422 import Mjpeg422Reference
from portbench.tests.test_portbench_metrics import canned

CELL = "rtpjpeg224.b64"
B = bench.load_json(bench.ROOT / "BENCHMARK.json")


def small_cell():
    """(cell, config, traffic, end-to-end, per-layer) of the cell, cut to
    256x72 (9 segments a frame), 5 distinct frames, batches of 2."""
    cell = {w["name"]: w for w in B["workloads"]}[CELL]
    entry = {c["name"]: c for c in B["configs"]}[cell["config"]]
    cfg = bench.load_json(bench.ROOT / entry["file"])
    traffic = bench.load_json(bench.HERE / "traffic"
                              / f"{cell['traffic']}.json")
    cfg.update({"width": 256, "height": 72, "frames": 5, "stride": 2048})
    traffic.update({"batch": 2, "warm_batches": 2, "check_batches": 6})
    return (cell, cfg, traffic) + bench.cell_metrics(B, CELL)


def clip(seed, frames=3):
    _, cfg, _, _, _ = small_cell()
    return make_clip(seed, cfg["width"], cfg["height"], frames,
                     cfg["quality"], cfg["restart_rows"],
                     cfg["luma_texture"], cfg["chroma_texture"], "cpu")


def test_same_seed_same_frames_other_seed_others():
    a, b, c = clip(2 ** 31 + 7), clip(2 ** 31 + 7), clip(2 ** 31 + 8)
    assert a.packets == b.packets and torch.equal(a.coef, b.coef)
    assert a.packets[0] != c.packets[0]
    assert (a.long_codes > 0).all() and (a.symbols > a.long_codes).all()


@pytest.mark.parametrize("frame", [0, 2])
def test_frames_decode_to_the_encoded_coefficients(frame):
    """The port's C++ host decoder (mjpeg_decode_scan) reads each frame as
    the generator encoded it, restart markers and DC predictors included."""
    from ffmpeg_tpu_torch.codecs.mjpeg import scan_decode
    c = clip(5)
    sc = scan_decode(c.packets[frame])
    assert sc.st.restart_interval == c.width // 16
    y, u, v = sc.coeffs
    got = np.concatenate([y.reshape(-1, 2, 64), u.reshape(-1, 1, 64),
                          v.reshape(-1, 1, 64)], axis=1)
    assert np.array_equal(got, c.frame_coef(frame).reshape(-1, 4, 64))


def test_huffman_tables_are_annex_k():
    """The DHT the generator writes equals the standard-table fixture's
    (tests/data/port/huffman_annexk_1080p_2.mjpeg), table for table."""
    from ffmpeg_tpu_torch.codecs.mjpeg import _JpegState, _parse_until_scan
    from ffmpeg_tpu_torch.io.mjpeg import split_packets
    from ffmpeg_tpu_torch.testing import HUFFMAN_ANNEXK
    got, want = _JpegState(), _JpegState()
    _parse_until_scan(clip(3, 1).packets[0], got)
    _parse_until_scan(split_packets(HUFFMAN_ANNEXK.read_bytes())[0], want)
    for name in ("dc_counts", "dc_values", "ac_counts", "ac_values"):
        assert np.array_equal(getattr(got, name)[:2], getattr(want, name)[:2])
    for counts, values in (DC_LUMA, DC_CHROMA, AC_LUMA, AC_CHROMA):
        assert sum(counts) == len(values)


def test_422_reference_agrees_with_420_on_chroma_rows_repeated_in_pairs():
    """One picture in both layouts: the same luma, and chroma whose rows
    repeat in pairs down the 4:2:2 plane, i.e. the 4:2:0 plane's rows.
    The two references filter chroma on different vertical grids (4:2:0
    sites it between row pairs at half the rows), so they agree exactly
    where that cannot matter: chroma constant down each column, the case
    taken here, where the horizontal taps (the same, centred between
    luma pairs) alone decide."""
    w, h, ow, oh = 64, 32, 24, 20
    rng = np.random.default_rng(11)
    luma = torch.as_tensor(rng.uniform(0, 255, (h, w)))
    ones = np.ones(64, np.int64)
    ycoef = _forward(luma, ones)                        # (h/8, w/8, 64)
    chroma = [torch.as_tensor(rng.uniform(0, 255, (1, w // 2)))
              for _ in range(2)]
    c420 = [_forward(c.expand(h // 2, -1), ones) for c in chroma]
    c422 = [_forward(c.expand(h, -1), ones) for c in chroma]
    y420 = ycoef.reshape(h // 16, 2, w // 16, 2, 64).transpose(1, 2)
    coef420 = torch.cat([y420.reshape(h // 16, w // 16, 4, 64)]
                        + [c[:, :, None] for c in c420], 2)
    coef422 = torch.cat([ycoef.reshape(h // 8, w // 16, 2, 64)]
                        + [c[:, :, None] for c in c422], 2)
    a = MjpegReference(w, h, ow, oh, ones, ones, "cpu").rgb(coef420)
    b = Mjpeg422Reference(w, h, ow, oh, ones, ones, "cpu").rgb(coef422)
    assert torch.allclose(a, b, rtol=0, atol=1e-9)
    # and the layouts do differ: the 4:2:2 chroma rows left as they are
    coef422[1::2, :, 2:] = 0
    b = Mjpeg422Reference(w, h, ow, oh, ones, ones, "cpu").rgb(coef422)
    assert (a - b).abs().max() > 1.0


def test_program_passes_the_check_and_tf32_control_fails():
    cell, cfg, traffic, e2e, layer = small_cell()
    res, checks = bench.run(cell, cfg, traffic, e2e, layer, 2 ** 31 + 99,
                            1.0, False, torch.device("cpu"),
                            time.perf_counter())
    assert res["correct"] and res["failed"] == 0
    assert checks["excess_lsb"]["value"] < 1e-3
    assert set(res["metrics"]) == {"frames_per_s", "batch_p95_ms",
                                   "setup_s"}
    mod = importlib.import_module(f"portbench.paths.{cfg['path']}")
    path = mod.Path(cfg, traffic, 4242, torch.device("cpu"), False)
    w = run_window(path, 0.2, traffic["check_batches"], 4242,
                   torch.device("cpu"))
    path.close()
    ref = path.reference("float64")
    got = {p: max(path.excess([(i, path.control(ids, path.reference(p)),
                                ids) for i, _, ids in w.kept], ref))
           for p in ("tf32", "float32")}
    assert got["tf32"] > cfg["check"]["excess_lsb"] > got["float32"]


def test_k1_count_is_of_the_generator():
    cell, cfg, traffic, _, _ = small_cell()
    mod = importlib.import_module(f"portbench.paths.{cfg['path']}")
    path = mod.Path(cfg, traffic, 77, torch.device("cpu"), False)
    path.batch()
    c, ids = path.counts, [0, 1]
    nmcu = 16 * 9
    assert c["k1_instr"] == 20 * int(path.clip.symbols[ids].sum())
    assert c["k1_bytes"] == int(path.clip.scan_bytes[ids].sum()) + 2 * (
        4 * 9 + 4 * 1344 + nmcu * 4 * 128)


def test_lane_skew_count_is_the_split_lengths():
    """The path's `k1_skew` a batch, from the generator, equals the
    longest over the mean of the segment lengths the program's split
    wrote into the batch's regions."""
    cell, cfg, traffic, _, _ = small_cell()
    mod = importlib.import_module(f"portbench.paths.{cfg['path']}")
    path = mod.Path(cfg, traffic, 2 ** 32 + 77, torch.device("cpu"), False)
    for _ in range(2):
        path.batch()
        lens = path.pipe.regions[:, :4 * path.nseg].view("<u4")
        assert path.counts["k1_skew"][-1] == pytest.approx(
            lens.max() / lens.mean(), rel=1e-12)
    assert len(path.counts["k1_skew"]) == 2
    path.reset_counts()
    assert path.counts["k1_skew"] == []


def read(counts):
    ctx = bench.Context({"name": CELL}, {}, {}, counts, canned())
    return bench.metric_reader("k1_lane_skew")(ctx)


def test_lane_skew_reads_the_count():
    # batch 1: longest 300 of a mean 200 B: 1.5; batch 2: 500 of 400: 1.25
    assert read({"frames": 4, "k1_skew": [1.5, 1.25]}) == pytest.approx(
        (1.5 + 1.25) / 2)


def test_lane_skew_reads_none_without_the_count():
    assert read({"frames": 4, "k1_skew": []}) is None
    assert read({"frames": 4, "k1_bytes": 1, "k1_instr": 1}) is None


def test_contract_holds_the_config_cell_and_metric():
    configs = {c["name"]: c for c in B["configs"]}
    entry = configs["rtpjpeg1080_422_rgb224"]
    assert entry["reduced"] == [] and entry["source"].startswith("https://")
    cfg = json.loads((bench.ROOT / entry["file"]).read_text())
    assert (cfg["width"], cfg["height"], cfg["rtp_type"], cfg["sampling"],
            cfg["restart_rows"]) == (1920, 1080, 64, "yuv422p", 1)
    assert set(cfg["assumed"]) >= {"quality", "restart_rows", "content"}
    assert (bench.HERE / "paths" / f"{cfg['path']}.py").is_file()
    cell = {w["name"]: w for w in B["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "rtpjpeg1080_422_rgb224", "mjpeg_b64", 1)
    e2e, layer = bench.cell_metrics(B, CELL)
    assert {m["name"] for m in e2e} == {"frames_per_s", "batch_p95_ms",
                                        "setup_s"}
    assert {m["name"] for m in layer} == {
        "prep_ms_per_frame", "launches_per_frame", "h2d_ms_per_frame",
        "k1_roofline", "recon_ms_per_frame", "device_idle_pct",
        "prep_parse_ms_per_frame", "prep_table_ms_per_frame",
        "prep_split_ms_per_frame", "upload_wait_ms_per_frame",
        "enqueue_ms_per_frame", "idle_in_prep_pct", "k1_lane_skew"}
    skew = {m["name"]: m for m in B["per_layer"]}["k1_lane_skew"]
    assert (skew["unit"], skew["better"], skew["source"], skew["layer"],
            skew["moves"], skew["workloads"]) == (
        "x", "lower", "program_counter", "entropy decode kernel",
        "frames_per_s", [CELL])
