"""ffmpeg_tpu_torch — the PyTorch/CUDA port of ffmpeg_tpu.

A second package beside `ffmpeg_tpu`, which stays the reference.  Module
paths mirror the reference's (`ffmpeg_tpu_torch/models/mjpeg_tpu_entropy.py`
is the counterpart of `ffmpeg_tpu/models/mjpeg_tpu_entropy.py`).  Dense
math is PyTorch; each Pallas kernel of the reference is a kernel written
by hand for Hopper under `csrc/`, built at first use by `_cuda_build`.

The port imports torch and never jax, and nothing of `ffmpeg_tpu`: it
keeps its own copies of what it needs (`utils/`, `core/`,
`formats/pixfmt.py`, `scale/colorspace.py`, `scale/filters.py`, the
Huffman table builders in `ops/huffman.py`, and the host C++ under
`csrc/host/`, built by `native`).  Its entry points run on the card
(`device="cuda"`) unless the caller asks for another device.

Ported so far:
- the flagship path, batched 1080p MJPEG with restart markers decoded
  and scaled to 224x224 rgb24
  (`models.mjpeg_tpu_entropy.MjpegTpuEntropyPipeline`), with K1;
- the MPEG-2 encoder's I/P path (`codecs.CodecContext.open_encoder`,
  `codecs.mpeg12_enc.Mpeg2Encoder`) with motion search by K2
  (`ops.me`), the 8x8 transforms (`ops.idct`) and motion compensation
  (`ops.mc`);
- the MJPEG decoder, the filter graph and the decode→scale twin
  (`entry.entry`); the audio frontend (`codecs.aac`, `ops.tx`,
  `resample`);
- the VP9 decoder's per-frame path (`codecs.vp9.VP9Decoder`: the C++
  tile parse, `codecs.vp9.recon_tpu` on the device, the host loop
  filter), with `codecs.vp9.lf_tpu` as the device loop filter.
"""

__version__ = "0.1.0"
