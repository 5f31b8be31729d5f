"""K1 (ffmpeg_tpu_torch/csrc/jpeg_huffman.cu) against its plain PyTorch
version on the card, bit-exact.  Marked `gpu`: they need a CUDA device
and nvcc, and skip without them.  They use no jax, so on a machine with a
card and without jax they run without tests/conftest.py (which imports
jax):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
    MjpegTpuEntropyPipeline, TpuEntropySpec)
from ffmpeg_tpu_torch.ops import huffman
from ffmpeg_tpu_torch import testing as fx

from torch_port_util import fixture_packets

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    return torch.device("cuda", 0)


def _packed(pkts, w, h, out, stride, cap, device):
    spec = TpuEntropySpec(w, h, out, out, batch=len(pkts), stride=stride,
                          packed_cap=cap)
    pipe = MjpegTpuEntropyPipeline(spec, max(pkts, key=len), device=device)
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    regions = torch.from_numpy(pipe.regions).to(device)
    return (pipe, regions) + pipe.program.split_regions(regions)


def _check_k1(pipe, regions, lens, luts):
    before = huffman.KERNEL_LAUNCHES
    got = huffman.jpeg_scan_decode_packed(regions, lens, luts, pipe.hdr)
    torch.cuda.synchronize()
    assert huffman.KERNEL_LAUNCHES == before + 1
    want = huffman.decode_packed_plain(regions, lens, luts, pipe.hdr)
    assert got.is_cuda and got.dtype == torch.int16
    assert torch.equal(got, want)
    return got


def test_k1_matches_plain_fixture(cuda):
    pkts = fixture_packets()
    _check_k1(*_packed(pkts, fx.W, fx.H, fx.OUT, fx.STRIDE,
                       fx.packed_cap(pkts), cuda))


def test_k1_matches_plain_on_corrupt_bytes_and_padding_lanes(cuda):
    pkts = fixture_packets()[:2]
    pipe, regions, lens, luts = _packed(pkts, fx.W, fx.H, fx.OUT,
                                        fx.STRIDE, fx.packed_cap(pkts), cuda)
    assert not torch.equal(luts[0], luts[1])
    rng = np.random.default_rng(5)
    junk = regions.clone()
    junk[:, pipe.hdr:] = torch.from_numpy(rng.integers(
        0, 256, tuple(junk[:, pipe.hdr:].shape), dtype=np.uint8)).to(cuda)
    lens0 = lens.clone()
    lens0[:, ::5] = 0                         # padding lanes
    _check_k1(pipe, junk, lens0, luts)


def test_pipeline_on_card_matches_golden(cuda):
    pkts = fixture_packets()
    spec = TpuEntropySpec(fx.W, fx.H, fx.OUT, fx.OUT, batch=8,
                          stride=fx.STRIDE, packed_cap=fx.packed_cap(pkts))
    pipe = MjpegTpuEntropyPipeline(spec, max(pkts, key=len), device=cuda)
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    got = np.stack([c.cpu().numpy() for c in pipe.run_batch()])
    d = np.abs(got.astype(np.int32)
               - np.load(fx.GOLDEN)["planes"].astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
