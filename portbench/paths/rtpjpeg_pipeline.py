"""Path of the camera MJPEG cell: 1080p RFC 2435 type-64 frames (4:2:2,
the Annex K Huffman tables, a restart marker every MCU row) to 224x224
rgb24 batches through the program's flagship pipeline,
`MjpegTpuEntropyPipeline`, which takes the stream's sampling and restart
interval from its first frame's SOF and DRI.

A batch runs as in `mjpeg_pipeline`: `prep_frame` for each of its frames,
then `run_batch`, one batch in flight.  Inputs: `inputs.rtpjpeg.make_clip`
from the seed, the config's `frames` distinct frames cycled; the check
against `reference.mjpeg422`.
"""

from __future__ import annotations

import time

from ..inputs.rtpjpeg import BLOCKS, make_clip
from ..reference.mjpeg422 import Mjpeg422Reference
from . import mjpeg_pipeline

TABLE_BYTES = 4 * 1344           # K1's per-frame tables, both levels


class Path(mjpeg_pipeline.Path):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 tracing: bool):
        from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
            MjpegTpuEntropyPipeline, TpuEntropySpec)
        self.cfg, self.device, self.tracing = cfg, device, tracing
        self.batch_size = traffic["batch"]
        t = time.perf_counter()
        self.clip = make_clip(seed, cfg["width"], cfg["height"],
                              cfg["frames"], cfg["quality"],
                              cfg["restart_rows"], cfg["luma_texture"],
                              cfg["chroma_texture"], device)
        if int(self.clip.segments.max()) > cfg["stride"] - 5:
            raise ValueError(f"a segment of {self.clip.segments.max()} B "
                             f"does not fit the stride {cfg['stride']}")
        mcus_x, mcus_y = cfg["width"] // 16, -(-cfg["height"] // 8)
        self.nmcu = mcus_x * mcus_y
        self.nseg = -(-mcus_y // cfg["restart_rows"])
        cap = (4 * self.nseg + 16 + TABLE_BYTES
               + int(self.clip.scan_bytes.max()) + cfg["stride"] + 128)
        spec = TpuEntropySpec(cfg["width"], cfg["height"], cfg["out_w"],
                              cfg["out_h"], batch=self.batch_size,
                              stride=cfg["stride"], out_fmt=cfg["out_fmt"],
                              filter=cfg["filter"], packed_cap=cap)
        t_prog = time.perf_counter()
        self.pipe = MjpegTpuEntropyPipeline(spec, self.clip.packets[0],
                                            device=device)
        self.build_s = (f"{t_prog - t:.3f} + "
                        f"{time.perf_counter() - t_prog:.3f}")
        self.next = 0
        self.reset_counts()

    def describe(self) -> str:
        c = self.clip
        return (super().describe() + f", {c.symbols.mean():.0f} symbols a "
                f"frame, {c.long_codes.mean():.0f} of them with codes "
                f"longer than 9 bits")

    def reset_counts(self) -> None:
        super().reset_counts()
        self.counts["k1_skew"] = []

    def _count(self, ids) -> None:
        """K1's least work for these frames, by the flagship's arithmetic:
        each frame's scan bytes, the int32 lengths and both table levels
        read once, the int16 coefficients written once; ~20 integer
        instructions a symbol, counted by the generator.  And the batch's
        longest segment over its mean segment, from the generator's
        segment lengths (those the split hands K1): with one lane a
        segment, K1 waits on its longest lane."""
        c = self.counts
        n = len(ids)
        c["frames"] += n
        c["batches"] += 1
        c["k1_skew"].append(int(self.clip.segments[ids].max()) * self.nseg
                            * n / int(self.clip.scan_bytes[ids].sum()))
        c["k1_bytes"] += (int(self.clip.scan_bytes[ids].sum())
                          + n * (4 * self.nseg + TABLE_BYTES
                                 + self.nmcu * BLOCKS * 64 * 2))
        c["k1_instr"] += 20 * int(self.clip.symbols[ids].sum())

    def reference(self, precision: str = "float64") -> Mjpeg422Reference:
        c, cfg = self.clip, self.cfg
        return Mjpeg422Reference(cfg["width"], cfg["height"], cfg["out_w"],
                                 cfg["out_h"], c.q_luma, c.q_chroma,
                                 self.device, precision)
