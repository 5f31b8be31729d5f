"""ffmpeg_tpu_torch — the PyTorch/CUDA port of ffmpeg_tpu.

A second package beside `ffmpeg_tpu`, which stays the reference.  Module
paths mirror the reference's (`ffmpeg_tpu_torch/models/mjpeg_tpu_entropy.py`
is the counterpart of `ffmpeg_tpu/models/mjpeg_tpu_entropy.py`).  Dense
math is PyTorch; each Pallas kernel of the reference is a kernel written
by hand for Hopper under `csrc/`, built at first use by `_cuda_build`.

The port imports torch and never jax.  From `ffmpeg_tpu` it imports only
modules that are free of jax (`native`, `ops.huffman`'s numpy table
builders, `scale.filters`, `scale.colorspace`, `formats.pixfmt`,
`core.frame`, `core.packet`, `utils.error`) and carries its own
counterpart of the rest.

Ported so far: the flagship path, batched 1080p MJPEG with restart
markers decoded and scaled to 224x224 rgb24
(`models.mjpeg_tpu_entropy.MjpegTpuEntropyPipeline`).
"""

__version__ = "0.1.0"
