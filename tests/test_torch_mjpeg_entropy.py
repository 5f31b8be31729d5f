"""The port's flagship pipeline (models/mjpeg_tpu_entropy.py) against the
reference's on the CPU: fused operators, packed regions, the host-side
errors, and the device stage end to end.

Tolerances: coefficients are exact (integer path).  The planes may differ
by 1 LSB in at most 1% of samples, because the two contractions sum in
float32 in another order before floor(x + 0.5)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ffmpeg_tpu.models import mjpeg_tpu_entropy as ref_model
from ffmpeg_tpu_torch.models import mjpeg_tpu_entropy as port_model
from ffmpeg_tpu_torch.ops import huffman
from ffmpeg_tpu_torch.scale import ops as port_ops
from ffmpeg_tpu_torch import testing as fx

from torch_port_util import (encode_jpeg, fixture_packets,
                             reference_coefficients)

W, H, OUT_W, OUT_H, STRIDE = 256, 192, 64, 48, 512


def _pair():
    """Two frames of one stream: same quant tables, different DHTs."""
    return [encode_jpeg(W, H, 88, frame=0), encode_jpeg(W, H, 88, frame=4)]


def _pipes(pkts, w=W, h=H, out_w=OUT_W, out_h=OUT_H, stride=STRIDE, cap=0):
    kw = dict(batch=len(pkts), stride=stride, packed_cap=cap)
    ref = ref_model.MjpegTpuEntropyPipeline(
        ref_model.TpuEntropySpec(w, h, out_w, out_h, **kw), pkts[0])
    port = port_model.MjpegTpuEntropyPipeline(
        port_model.TpuEntropySpec(w, h, out_w, out_h, **kw), pkts[0],
        device="cpu")
    return ref, port


def _assert_ops_equal(port_tail, ref_tail):
    assert [type(o).__name__ for o in port_tail] == \
        [type(o).__name__ for o in ref_tail]
    for p, r in zip(port_tail, ref_tail):
        assert type(p).__module__.startswith("ffmpeg_tpu_torch.")
        for f in dataclasses.fields(r):
            a, b = getattr(p, f.name), getattr(r, f.name)
            assert np.array_equal(a, b) if isinstance(b, np.ndarray) \
                else a == b, f.name


@pytest.mark.parametrize("size", [(W, H, OUT_W, OUT_H),
                                  (fx.W, fx.H, fx.OUT, fx.OUT)],
                         ids=["256x192", "1080p"])
def test_fused_operators_identical(size):
    from ffmpeg_tpu.codecs.mjpeg import _JpegState, _parse_until_scan
    pkt = fixture_packets()[0] if size[0] == fx.W else _pair()[0]
    st = _JpegState()
    _parse_until_scan(pkt, st)
    qy = st.qtabs[st.components[0].q_idx].astype(np.int32)
    qc = st.qtabs[st.components[1].q_idx].astype(np.int32)
    ref = ref_model._fused_operators(ref_model.TpuEntropySpec(*size), qy, qc)
    port = port_model._fused_operators(port_model.TpuEntropySpec(*size),
                                       qy, qc)
    carried = port_model.operators_from_reference(*ref)
    for got in (port, carried):
        for a, b in zip(got[:4], ref[:4]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        _assert_ops_equal(got[4], ref[4])
        assert tuple(got[5][0]) == tuple(ref[5][0])
        assert tuple(got[5][1]) == tuple(ref[5][1])


def test_prep_frame_regions_byte_identical():
    pkts = _pair()
    ref, port = _pipes(pkts)
    assert (port.cap, port.hdr, port.nmcu) == (ref.cap, ref.hdr, ref.nmcu)
    for i, p in enumerate(pkts):
        ref.prep_frame(p, i)
        port.prep_frame(p, i)
    np.testing.assert_array_equal(port.regions, ref.regions)
    # restaging a slot overwrites it with the same bytes
    port.prep_frame(pkts[1], 0)
    np.testing.assert_array_equal(port.regions[0], ref.regions[1])


def test_prep_frame_regions_byte_identical_fixture():
    pkts = fixture_packets()[:2]
    ref, port = _pipes(pkts, fx.W, fx.H, fx.OUT, fx.OUT, fx.STRIDE,
                       fx.packed_cap(fixture_packets()))
    for i, p in enumerate(pkts):
        ref.prep_frame(p, i)
        port.prep_frame(p, i)
    np.testing.assert_array_equal(port.regions, ref.regions)


def test_prep_frame_regions_equal_reference_split_fixture():
    """All 8 fixture frames staged in turn into two slots: each slot holds
    the reference's lengths, table and split of its frame, and past the
    packed segments what the slot held before, byte for byte (the scan is
    read in place, and nothing past the output changes)."""
    import ctypes
    from ffmpeg_tpu import native as ref_native
    from ffmpeg_tpu.codecs.mjpeg import _JpegState, _parse_until_scan
    from ffmpeg_tpu.ops.huffman import build_jpeg_luts9
    pkts = fixture_packets()
    _, port = _pipes(pkts[:2], fx.W, fx.H, fx.OUT, fx.OUT, fx.STRIDE,
                     fx.packed_cap(pkts))
    nmcu, hdr = port.nmcu, port.hdr
    want = port.regions.copy()
    for j, pkt in enumerate(pkts):
        slot = j % 2
        st = _JpegState()
        off, _ = _parse_until_scan(pkt, st)
        region = want[slot]
        offs = np.zeros(nmcu + 2, np.int32)
        n = ref_native.get().mjpeg_split_segments(
            pkt[off:], len(pkt) - off,
            region[hdr:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            port.cap - hdr,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), nmcu)
        assert n == nmcu
        region[:2 * nmcu] = np.diff(offs[:nmcu + 1]).astype(
            np.uint16).view(np.uint8)
        region[2 * nmcu:hdr] = build_jpeg_luts9(st).view(np.uint8).reshape(-1)
        port.prep_frame(pkt, slot)
        np.testing.assert_array_equal(port.regions[slot], want[slot])


@pytest.mark.parametrize("case", ["stride", "cap", "qtables"])
def test_prep_frame_errors_match_reference(case):
    pkts = _pair()
    stride, cap, pkt = STRIDE, 0, pkts[1]
    if case == "stride":
        stride = 16
    elif case == "cap":
        cap = 2 * (W // 16) * (H // 16) + 512 * 12 + 1024
    else:
        pkt = encode_jpeg(W, H, 40)
    ref, port = _pipes(pkts, stride=stride, cap=cap)
    with pytest.raises(ValueError) as want:
        ref.prep_frame(pkt, 0)
    with pytest.raises(ValueError) as got:
        port.prep_frame(pkt, 0)
    assert str(got.value) == str(want.value)


def test_end_to_end_matches_reference_program():
    pkts = _pair()
    ref, port = _pipes(pkts)
    for i, p in enumerate(pkts):
        ref.prep_frame(p, i)
        port.prep_frame(p, i)
    regions = torch.from_numpy(port.regions.copy())
    lens, luts = port.program.split_regions(regions)
    coef = huffman.jpeg_scan_decode_packed(regions, lens, luts, port.hdr)
    np.testing.assert_array_equal(
        coef.numpy().astype(np.int32),
        reference_coefficients(ref.regions, ref.nmcu, STRIDE))

    want = [np.asarray(c) for c in ref.fn(jax.device_put(ref.regions))]
    got = port.run_batch()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and tuple(g.shape) == (2, OUT_H, OUT_W)
        d = np.abs(g.numpy().astype(np.int32) - w.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 0.01


def test_program_from_reference_operators_equals_port_program():
    pkts = _pair()
    ref, port = _pipes(pkts)
    for i, p in enumerate(pkts):
        port.prep_frame(p, i)
    ops = port_model.operators_from_reference(*ref_model._fused_operators(
        ref.spec, ref._qy, ref._qc))
    prog = port_model.MjpegEntropyProgram(port.spec, port.cap, ops, "cpu")
    regions = torch.from_numpy(port.regions)
    for a, b in zip(prog(regions), port.program(regions)):
        assert torch.equal(a, b)
    assert [n for n, _ in prog.named_buffers()] == ["ky", "ly", "kc", "lc"]


def test_program_refuses_reduced_float32_precision():
    pkts = _pair()
    port = _pipes(pkts)[1]
    port.prep_frame(pkts[0], 0)
    port.prep_frame(pkts[1], 1)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full float32"):
            port.run_batch()
    finally:
        torch.set_float32_matmul_precision(prev)
    port_ops.require_full_fp32()
    with pytest.raises(ValueError):
        port.program(torch.zeros((2, port.cap - 1), dtype=torch.uint8))
