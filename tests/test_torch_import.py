"""The PyTorch port imports and runs with jax absent.

The check runs in a subprocess, because this test process has imported
jax already (tests/conftest.py): a meta-path finder refuses every `jax`
module, then the port is imported, its pipeline built on a packet of the
1080p fixture, and its plain path run on the CPU."""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import sys

class _BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, _BlockJax())
sys.path.insert(0, sys.argv[1])

import numpy as np
import torch
from ffmpeg_tpu_torch.io.mjpeg import split_packets
from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
    MjpegTpuEntropyPipeline, TpuEntropySpec)
from ffmpeg_tpu_torch.ops import huffman
from ffmpeg_tpu_torch.scale.swscale import Scaler
from ffmpeg_tpu_torch.testing import host_decode, packed_cap

pkts = split_packets(open(sys.argv[2], "rb").read())
spec = TpuEntropySpec(1920, 1080, 224, 224, batch=1, stride=192,
                      packed_cap=packed_cap(pkts))
pipe = MjpegTpuEntropyPipeline(spec, pkts[0], device="cpu")
pipe.prep_frame(pkts[0], 0)
out = pipe.run_batch()
assert [tuple(c.shape) for c in out] == [(1, 224, 224)] * 3
assert all(c.dtype == torch.uint8 for c in out)
assert huffman.KERNEL_LAUNCHES == 0
regions = torch.from_numpy(pipe.regions)
coef = huffman.jpeg_scan_decode_packed(
    regions, *pipe.program.split_regions(regions), pipe.hdr)
assert np.array_equal(coef[0].numpy(), host_decode(pkts[0]))
sc = Scaler("cpu", src_w=32, src_h=16, src_fmt="yuv420p", dst_w=16,
            dst_h=8, dst_fmt="rgb24")
sc.run([np.zeros((16, 32), np.uint8), np.zeros((8, 16), np.uint8),
        np.zeros((8, 16), np.uint8)])
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not bad, bad
print("PORT_OK", sorted(m for m in sys.modules
                        if m.startswith("ffmpeg_tpu.")))
"""


def test_port_runs_with_jax_blocked():
    fixture = REPO / "tests" / "data" / "port" / "flagship_1080p_8.mjpeg"
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(REPO),
                        str(fixture)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "PORT_OK" in r.stdout


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax)|^\s*(import|from) "
                     r"ffmpeg_tpu\.(codecs|io|scale\.ops|scale\.swscale|"
                     r"ops\.idct|models)\b", re.M)
    hits = [str(p.relative_to(REPO))
            for p in (REPO / "ffmpeg_tpu_torch").rglob("*.py")
            if pat.search(p.read_text())]
    assert not hits, hits
