"""ffmpeg_tpu_torch — the PyTorch/CUDA port of ffmpeg_tpu.

A second package beside `ffmpeg_tpu`, which stays the reference.  Module
paths mirror the reference's (`ffmpeg_tpu_torch/models/mjpeg_tpu_entropy.py`
is the counterpart of `ffmpeg_tpu/models/mjpeg_tpu_entropy.py`), and so
do the public names of each module: tests/test_torch_parity.py holds every
module of the reference to its counterpart here, but for the few names
that exist only for the TPU (ROADMAP.md, "Not ported, by design").  Dense
math is PyTorch; each Pallas kernel of the reference is a kernel written
by hand for Hopper under `csrc/`, built at first use by `_cuda_build`:
K1, the segment-parallel JPEG Huffman decode (`ops.huffman`), and K2,
the full-search SAD cost volume (`ops.me`).

The port is complete: every module of the reference has its counterpart
(codecs, containers, protocols, filters, the CLI, the multi-device
layer); ROADMAP.md says where each part stands and what comes next.

The port imports torch and never jax, and nothing of `ffmpeg_tpu`: it
keeps its own copies of the host modules it shares with the reference,
and its own host C++ under `csrc/host/`, built by `native`.  Its entry
points run on the card (`device="cuda"`) unless the caller asks for
another device.
"""

__version__ = "0.1.0"

from .core.frame import Frame
from .core.packet import Packet
from .utils.rational import Rational
from .utils import log

__all__ = ["Frame", "Packet", "Rational", "log", "__version__"]
