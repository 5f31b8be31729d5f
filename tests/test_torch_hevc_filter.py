"""The port's HEVC in-loop filters (ffmpeg_tpu_torch/codecs/hevc/
filter_tpu.py `filters_tpu`) against the reference's host filter.py,
bit-exact, on the CPU.

Each case parses a crafted frame with the reference's CtuCoder (inline
host reconstruction, no filter), then runs the port's device filters on
its planes (tensors on the CPU) and the reference's host deblock and SAO
on the same FrameDec.  The cases are tests/test_hevc_tpu.py's: deblock
(seeds 0 and 5, and offsets), SAO, SAO + deblock, 96x64, tiles with
filtering across on and off, 10 and 12 bits.  One case runs the
reference's jitted filters_tpu; one shows where the reference's device
filter drops an edge that its host filter filters."""

import numpy as np
import pytest
import torch

import test_hevc as T
from ffmpeg_tpu.codecs.hevc.filter import deblock_frame, sao_frame
from ffmpeg_tpu.codecs.hevc.filter_tpu import filters_tpu as ref_filters_tpu
from ffmpeg_tpu_torch.codecs.hevc import filter_tpu
from test_hevc_tpu import _decode_to_prefilter


def _host(dec):
    """The reference's host filters on a copy of dec's planes."""
    y, u, v = dec.y.copy(), dec.u.copy(), dec.v.copy()
    if not dec.sh.deblocking_disabled:
        deblock_frame(dec)
    if dec.sps.sao_enabled and (dec.sh.sao_luma or dec.sh.sao_chroma):
        sao_frame(dec)
    out = dec.y.copy(), dec.u.copy(), dec.v.copy()
    dec.y[:], dec.u[:], dec.v[:] = y, u, v
    return out


def _port(dec):
    planes = [torch.from_numpy(p.astype(np.int16 if dec.bd > 8
                                        else np.uint8))
              for p in (dec.y, dec.u, dec.v)]
    out = filter_tpu.filters_tpu(dec, *planes)
    assert all(o.dtype == p.dtype for o, p in zip(out, planes))
    return [o.numpy().astype(dec.y.dtype) for o in out]


def _check(stream):
    dec = _decode_to_prefilter(stream)
    got = _port(dec)
    want = _host(dec)
    for pl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"plane {pl}")
    return dec, got


def _stream(case):
    if case.startswith("deblock"):
        rng = np.random.default_rng(int(case[-1]))
        return T.craft_frame(T.Plan(rng, maxn=10, amp=40),
                             pps_kw=dict(deblock=True))
    if case == "offsets":
        rng = np.random.default_rng(7)
        return T.craft_frame(T.Plan(rng, maxn=12, amp=60), qp_delta=10,
                             pps_kw=dict(deblock=True, beta_offset=4,
                                         tc_offset=-4))
    if case.startswith("sao") and case[-1].isdigit():
        rng = np.random.default_rng(int(case[-1]))
        return T.craft_frame(T.Plan(rng, maxn=8, amp=40), sao=True)
    if case == "sao_deblock":
        rng = np.random.default_rng(3)
        return T.craft_frame(T.Plan(rng, maxn=8, amp=40), sao=True,
                             pps_kw=dict(deblock=True))
    if case == "96x64":
        rng = np.random.default_rng(12)
        return T.craft_frame(T.Plan(rng, maxn=8, amp=40), width=96,
                             height=64, sao=True, pps_kw=dict(deblock=True))
    if case.startswith("tiles"):
        rng = np.random.default_rng(21)
        return T.craft_frame(T.Plan(rng, maxn=8, amp=40), sao=True,
                             pps_kw=dict(tiles=(2, 2), deblock=True,
                                         lf_across_tiles=case == "tiles_on"))
    if case == "bit10":
        rng = np.random.default_rng(31)
        return T.craft_frame(T.Plan(rng, maxn=8, amp=80), bit_depth=10,
                             sao=True, pps_kw=dict(deblock=True))
    rng = np.random.default_rng(33)
    return T.craft_frame(T.Plan(rng, maxn=6, amp=120), bit_depth=12,
                         sao=True, pps_kw=dict(deblock=True))


@pytest.mark.parametrize("case", ["deblock0", "deblock5", "offsets", "sao1",
                                  "sao9", "sao_deblock", "96x64", "tiles_on",
                                  "tiles_off", "bit10", "bit12"])
def test_filters_match_host(case):
    _check(_stream(case))


def test_crossing_edges():
    """Vertical and horizontal edges meet: on smooth planes with a small
    step at every 8x8 block, both passes filter the samples around each
    crossing, and the horizontal pass reads what the vertical pass
    wrote; the result equals the host filter's, and the input planes
    are not written."""
    dec = _decode_to_prefilter(_stream("offsets"))
    rng = np.random.default_rng(0)
    for p in (dec.y, dec.u, dec.v):
        yy, xx = np.indices(p.shape)
        p[:] = 100 + (yy + xx) // 4 + 3 * (((yy >> 3) + (xx >> 3)) & 1) \
            + rng.integers(0, 2, p.shape)
    before = dec.y.copy()
    got = _port(dec)
    want = _host(dec)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    prm = filter_tpu.build_deblock_params(dec)
    y = torch.from_numpy(dec.y.astype(np.int32))
    f = {k: torch.from_numpy(prm[k]) for k in ("tc_v", "beta_v", "tc_h",
                                              "beta_h")}
    v_only = filter_tpu._luma_pass_v(y, f["tc_v"], f["beta_v"], 8)
    h_only = filter_tpu._luma_pass_h(y, f["tc_h"], f["beta_h"], 8)
    both = filter_tpu._luma_pass_h(v_only, f["tc_h"], f["beta_h"], 8)
    assert ((v_only != y) & (h_only != y)).any()
    changed_by_v = (both != h_only) & (v_only == y)
    assert changed_by_v.any()        # the h pass saw the v pass's writes
    np.testing.assert_array_equal(both.numpy(), got[0])
    np.testing.assert_array_equal(dec.y, before)


def test_matches_reference_device_filters():
    """The reference's jitted filters_tpu on a 64x64 SAO + deblock
    frame, against the port's."""
    dec = _decode_to_prefilter(_stream("sao_deblock"))
    want = ref_filters_tpu(dec)
    for g, w in zip(_port(dec), want):
        np.testing.assert_array_equal(g, w)


def test_last_chroma_edge_of_an_odd_chroma_height():
    """A 64x40 picture: its chroma planes are 20 rows, not a multiple of
    8, and the chroma edge at row 16 (luma 32) is filtered by the host
    filter.  The port's filters match the host; the reference's device
    filter (`W // 8 - 1` edges, filter_tpu.py:143, :201, :204) drops that
    edge, and differs from its own host filter there (a fault of the
    reference, ROADMAP.md section 3; 1080p chroma is 540 rows)."""
    rng = np.random.default_rng(5)
    stream = T.craft_frame(T.Plan(rng, maxn=10, amp=40), width=64,
                           height=40, pps_kw=dict(deblock=True))
    dec, _got = _check(stream)
    want = _host(dec)
    ref = ref_filters_tpu(dec)
    assert np.array_equal(ref[0], want[0])
    bad = [np.argwhere(r != w) for r, w in zip(ref[1:], want[1:])]
    assert any(len(b) for b in bad)
    assert all(set(b[:, 0]) <= {15, 16} for b in bad if len(b))


def test_no_filter_returns_the_planes():
    dec = _decode_to_prefilter(T.craft_frame(T.Plan(
        np.random.default_rng(0))))
    assert dec.sh.deblocking_disabled and not dec.sps.sao_enabled
    y = torch.from_numpy(dec.y.copy())
    out = filter_tpu.filters_tpu(dec, y, y[:32, :32], y[:32, :32])
    assert torch.equal(out[0], y)
