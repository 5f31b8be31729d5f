"""Path of the MJPEG cells: 1080p MJPEG to 224x224 rgb24 batches through
the program's flagship, `MjpegTpuEntropyPipeline`.

A batch is `prep_frame` for each of its frames (host: headers, Huffman
table, destuff and split into the pinned staging buffer) and then
`run_batch` (the upload and the device program: K1, the fused operator
contractions, the colour tail).  `prep_frame` waits for the previous
batch's upload to leave the staging buffer, so one batch is in flight
while the host prepares the next.

Inputs: `inputs.mjpeg.make_clip` from the seed, the config's `frames`
distinct frames cycled.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import trace
from ..inputs.mjpeg import make_clip
from ..reference.mjpeg import MjpegReference

LUT_BYTES = 512 * 12             # K1's per-frame table, (512, 12) int8


class Path:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 tracing: bool):
        from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
            MjpegTpuEntropyPipeline, TpuEntropySpec)
        self.cfg, self.device, self.tracing = cfg, device, tracing
        self.batch_size = traffic["batch"]
        t = time.perf_counter()
        self.clip = make_clip(seed, cfg["width"], cfg["height"],
                              cfg["frames"], cfg["quality"],
                              cfg["max_code_len"], cfg["luma_texture"],
                              cfg["chroma_texture"], device)
        if int(self.clip.segments.max()) > cfg["stride"] - 5:
            raise ValueError(f"a segment of {self.clip.segments.max()} B "
                             f"does not fit the stride {cfg['stride']}")
        self.nmcu = -(-cfg["width"] // 16) * -(-cfg["height"] // 16)
        cap = (2 * self.nmcu + LUT_BYTES + int(self.clip.scan_bytes.max())
               + cfg["stride"] + 128)
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
        return (f"{len(c.packets)} distinct frames, scan {c.scan_bytes.min()}"
                f"-{c.scan_bytes.max()} B destuffed (mean "
                f"{c.scan_bytes.mean():.0f}), longest segment "
                f"{c.segments.max()} B, packets "
                f"{min(map(len, c.packets))}-{max(map(len, c.packets))} B")

    def reset_counts(self) -> None:
        from ffmpeg_tpu_torch.ops import huffman
        self._k1_base = huffman.KERNEL_LAUNCHES
        self.counts = {"frames": 0, "batches": 0, "prep_s": [],
                       "k1_bytes": 0, "k1_instr": 0}

    def batch(self):
        """One batch: prep each frame, then run it; (outputs, frame ids)."""
        ids = [(self.next + j) % len(self.clip.packets)
               for j in range(self.batch_size)]
        self.next += self.batch_size
        for j, f in enumerate(ids):
            t = time.perf_counter()
            with trace.span(self.tracing, "prep_frame"):
                self.pipe.prep_frame(self.clip.packets[f], j)
            if j:        # the first call also waits for the last upload
                self.counts["prep_s"].append(time.perf_counter() - t)
        with trace.span(self.tracing, "run_batch"):
            outs = self.pipe.run_batch()
        self._count(ids)
        return outs, ids

    def _count(self, ids) -> None:
        """K1's least work for these frames, by `k1_bound`'s arithmetic:
        each frame's scan bytes, the int32 lengths and the table read
        once, the int16 coefficients written once; ~20 integer
        instructions a symbol, the symbols at most the non-zero
        coefficients plus a DC and an end of block a block."""
        c = self.counts
        n = len(ids)
        c["frames"] += n
        c["batches"] += 1
        c["k1_bytes"] += (int(self.clip.scan_bytes[ids].sum())
                          + n * (4 * self.nmcu + LUT_BYTES
                                 + self.nmcu * 6 * 64 * 2))
        c["k1_instr"] += 20 * (int(self.clip.nonzero[ids].sum())
                               + 12 * self.nmcu * n)

    def close(self) -> None:
        """Free the program's state before the reference runs."""
        self.pipe = None

    # --- the check ------------------------------------------------------
    def reference(self, precision: str = "float64") -> MjpegReference:
        c, cfg = self.clip, self.cfg
        return MjpegReference(cfg["width"], cfg["height"], cfg["out_w"],
                              cfg["out_h"], c.q_luma, c.q_chroma,
                              self.device, precision)

    def excess(self, kept, ref: MjpegReference) -> list:
        """For each frame of the kept batches, the widest gap by which an
        output sample lies outside the rounding of the reference's value
        (clamped to 0..255), in 8-bit steps; 0 for a correct rounding."""
        out = []
        for _, outs, ids in kept:
            got = torch.stack(list(outs), 1)          # (B, 3, h, w) uint8
            for j, f in enumerate(ids):
                r = ref.rgb(self.clip.frame_coef(f)).double().clamp(0, 255)
                gap = float((got[j].double() - r).abs().max())
                out.append(max(0.0, gap - 0.5))
        return out

    def exact_checks(self) -> dict:
        """K1 launched once a batch of the window (counted where it
        launches; on the card only)."""
        if self.device.type != "cuda":
            return {}
        from ffmpeg_tpu_torch.ops import huffman
        return {"k1_launches_off": abs(huffman.KERNEL_LAUNCHES - self._k1_base
                                       - self.counts["batches"])}

    def control(self, ids, ref: MjpegReference) -> list:
        """The reference in `ref`'s precision put in the program's place:
        rgb24 outputs of frames `ids`, rounded and clamped as the
        program's tail does."""
        rgb = torch.stack([ref.rgb(self.clip.frame_coef(f)) for f in ids])
        rgb = torch.floor(rgb + 0.5).clamp(0, 255).to(torch.uint8)
        return [rgb[:, k] for k in range(3)]
