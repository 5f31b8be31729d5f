"""Path of the clip-graph cell: decoded yuv420p clips to normalised
float32 crops through the program's filter graph, as a training data
loader feeds a video model.

A batch is the upload of `clips` x `frames_per_clip` frames from pinned
host memory and one `parse_graph(...).run` over them as one frame with
batched planes; the graph fuses scale, crop and tensornorm into one
`FusedChain` node.  The next batch's upload waits until the previous
one has left its staging buffer, so one batch is in flight while the
host queues the next, as in the MJPEG cells.

Inputs: random planes drawn on the device from the seed and copied to
pinned host memory, `distinct_batches` of them cycled (the scaler's work
does not depend on the content).
"""

from __future__ import annotations

import time

import torch

from ..core import trace
from ..reference.graph import ClipGraphReference


def graph_text(cfg: dict) -> str:
    cw, ch, cx, cy = cfg["crop"]
    return (f"scale={cfg['scale_w']}:{cfg['scale_h']}:format=rgb24,"
            f"crop={cw}:{ch}:{cx}:{cy},"
            f"tensornorm=mean={cfg['mean']}:std={cfg['std']}")


class Path:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 tracing: bool):
        from ffmpeg_tpu_torch.core.frame import Frame
        from ffmpeg_tpu_torch.filters import parse_graph
        self.cfg, self.device, self.tracing = cfg, device, tracing
        self.frame = Frame
        t = time.perf_counter()
        w, h = cfg["src_w"], cfg["src_h"]
        self.n = traffic["clips"] * cfg["frames_per_clip"]
        gen = torch.Generator(device=device)
        gen.manual_seed(seed % 2 ** 63)
        self.host = []
        for _ in range(traffic["distinct_batches"]):
            planes = []
            for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
                p = torch.randint(0, 256, (self.n, ph, pw), generator=gen,
                                  dtype=torch.uint8, device=device).cpu()
                planes.append(p.pin_memory() if device.type == "cuda"
                              else p)
            self.host.append(planes)
        t_prog = time.perf_counter()
        self.text = graph_text(cfg)
        self.graph = parse_graph(self.text, device=device)
        self.build_s = (f"{t_prog - t:.3f} + "
                        f"{time.perf_counter() - t_prog:.3f}")
        names = [n.filter.name for n in self.graph.nodes]
        if names != ["scale+crop+tensornorm"]:
            raise RuntimeError(f"the graph did not fuse into one node: "
                               f"{names}")
        self.uploaded = None           # event: last upload left the host
        self.next = 0
        self.reset_counts()

    def describe(self) -> str:
        return (f"'{self.text}' as one node, {len(self.host)} distinct "
                f"batches of {self.n} frames")

    def reset_counts(self) -> None:
        self.counts = {"frames": 0, "batches": 0}

    def batch(self):
        """One batch: upload, then the graph; (output planes, frame ids)."""
        d = self.next % len(self.host)
        self.next += 1
        if self.uploaded is not None:
            with trace.span(self.tracing, "wait_upload"):
                self.uploaded.synchronize()
        with trace.span(self.tracing, "upload"):
            planes = [p.to(self.device, non_blocking=True)
                      for p in self.host[d]]
        if self.device.type == "cuda":
            self.uploaded = torch.cuda.Event()
            self.uploaded.record()
        cfg = self.cfg
        with trace.span(self.tracing, "graph"):
            out = self.graph.run([self.frame.video(
                cfg["src_w"], cfg["src_h"], "yuv420p", planes=planes)])
        self.counts["frames"] += self.n
        self.counts["batches"] += 1
        return out[0].planes, [(d, k) for k in range(self.n)]

    def close(self) -> None:
        self.graph = None

    # --- the check ------------------------------------------------------
    def reference(self, precision: str = "float64") -> ClipGraphReference:
        c = self.cfg
        return ClipGraphReference(c["src_w"], c["src_h"], c["scale_w"],
                                  c["scale_h"], c["crop"], self.device,
                                  precision)

    def _rgb(self, d: int, ref: ClipGraphReference) -> torch.Tensor:
        """(n, 3, crop h, crop w) RGB code values before rounding."""
        return ref.rgb(*[p.to(self.device) for p in self.host[d]])

    def excess(self, kept, ref: ClipGraphReference) -> list:
        """For each frame of the kept batches, the widest gap by which an
        output sample, mapped back from tensornorm to an 8-bit code, lies
        outside the rounding of the reference's value (clamped to
        0..255), in 8-bit steps; 0 for a correct rounding."""
        m, s = self.cfg["mean"], self.cfg["std"]
        out = []
        for _, outs, ids in kept:
            got = (torch.stack(list(outs), 1).double() * s + m) * 255.0
            r = self._rgb(ids[0][0], ref).double().clamp(0, 255)
            gap = (got - r).abs().amax(dim=(1, 2, 3))
            out += (gap - 0.5).clamp(min=0).tolist()
        return out

    def exact_checks(self) -> dict:
        return {}

    def control(self, ids, ref: ClipGraphReference) -> list:
        """The reference in `ref`'s precision put in the program's place:
        rounded, clamped and normalised in float32 as the graph does."""
        rgb = torch.floor(self._rgb(ids[0][0], ref) + 0.5).clamp(0, 255)
        norm = (rgb.float() / 255.0 - self.cfg["mean"]) / self.cfg["std"]
        return [norm[:, k] for k in range(3)]
