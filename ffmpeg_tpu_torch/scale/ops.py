"""Typed op-list IR for pixel pipelines (analog of libswscale/ops.h:36-70).

Counterpart of ffmpeg_tpu/scale/ops.py with PyTorch as the backend: the
same ops with the same fields (numpy float64 matrices built on the host),
whose `apply` runs on tensors on whatever device the components lie on.
Every float32 product runs at full float32: the resize matmuls raise if
TF32 (or a lower float32 matmul precision) is allowed.

State flowing through ops: a list of component tensors, each (..., h, w)
float32 (normalized: Y/R/G/B in [0,1], chroma in [-0.5,0.5], alpha [0,1]).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.uint16): torch.uint16,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.float32): torch.float32}


def require_full_fp32() -> None:
    """Raise unless float32 matmuls run at full float32 (no TF32): the
    reference computes these products at Precision.HIGHEST."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "float32 matmuls must run in full float32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


class Op:
    def apply(self, comps: List[torch.Tensor]) -> List[torch.Tensor]:  # pragma: no cover
        raise NotImplementedError


@dataclass
class ToFloat(Op):
    """Cast native ints to float32 and apply per-comp affine y=(x-b)/a."""
    offsets: Tuple[float, ...]
    scales: Tuple[float, ...]

    def apply(self, comps):
        return [(x.to(torch.float32) - b) * (1.0 / a)
                for x, b, a in zip(comps, self.offsets, self.scales)]


@dataclass
class FromFloat(Op):
    """Denormalize + round + clamp to integer code values, y=x*a+b."""
    offsets: Tuple[float, ...]
    scales: Tuple[float, ...]
    maxval: Tuple[int, ...]
    dtype: np.dtype = np.uint8
    dither: Optional[str] = None   # None | "bayer"

    _BAYER8 = (np.array([
        [0, 48, 12, 60, 3, 51, 15, 63],
        [32, 16, 44, 28, 35, 19, 47, 31],
        [8, 56, 4, 52, 11, 59, 7, 55],
        [40, 24, 36, 20, 43, 27, 39, 23],
        [2, 50, 14, 62, 1, 49, 13, 61],
        [34, 18, 46, 30, 33, 17, 45, 29],
        [10, 58, 6, 54, 9, 57, 5, 53],
        [42, 26, 38, 22, 41, 25, 37, 21]], np.float32) + 0.5) / 64.0

    def apply(self, comps):
        out = []
        dt = _TORCH_DTYPES[np.dtype(self.dtype)]
        for x, b, a, mx in zip(comps, self.offsets, self.scales, self.maxval):
            y = x * a + b
            if self.dither == "bayer":
                h, w = y.shape[-2], y.shape[-1]
                d = torch.as_tensor(
                    np.tile(self._BAYER8, ((h + 7) // 8, (w + 7) // 8))[:h, :w],
                    device=y.device)
                y = torch.floor(y + d)
            else:
                y = torch.floor(y + 0.5)
            out.append(torch.clamp(y, 0, mx).to(dt))
        return out


@dataclass
class Linear(Op):
    """Cross-component affine: comps' = M @ comps + off.

    M is (n_out, n_in) over the first n_in comps; trailing comps (alpha)
    pass through untouched.  The terms are summed in the reference's
    order, one scaled component at a time.
    """
    matrix: np.ndarray            # (n_out, n_in) float64
    offset: np.ndarray            # (n_out,) float64

    def apply(self, comps):
        n_out, n_in = self.matrix.shape
        ins = comps[:n_in]
        out = []
        for i in range(n_out):
            acc = None
            for j in range(n_in):
                c = float(self.matrix[i, j])
                if c == 0.0:
                    continue
                t = ins[j] if c == 1.0 else ins[j] * c
                acc = t if acc is None else acc + t
            if acc is None:
                acc = torch.zeros_like(ins[0])
            o = float(self.offset[i])
            if o != 0.0:
                acc = acc + o
            out.append(acc)
        return out + list(comps[n_in:])

    def compose(self, other: "Linear") -> "Linear":
        """self ∘ other (other runs first)."""
        return Linear(self.matrix @ other.matrix,
                      self.matrix @ other.offset + self.offset)


@dataclass
class ResizeAxis(Op):
    """Per-component resize along one axis via tap-matrix matmul."""
    axis: int                     # -2 = vertical (h), -1 = horizontal (w)
    matrices: Tuple[Optional[np.ndarray], ...]  # one per comp; None = skip

    def _on(self, i: int, m: np.ndarray, device) -> torch.Tensor:
        """Matrix i as float32 on `device`, copied there once: a copy from
        pageable host memory per call would wait for the device."""
        cache = self.__dict__.setdefault("_device_mats", {})
        t = cache.get((i, device))
        if t is None:
            t = cache[(i, device)] = torch.as_tensor(
                m, dtype=torch.float32, device=device)
        return t

    def apply(self, comps):
        out = []
        for i, (x, m) in enumerate(zip(comps, self.matrices)):
            if m is None:
                out.append(x)
                continue
            require_full_fp32()
            mm = self._on(i, m, x.device)
            if self.axis == -1:
                out.append(torch.matmul(x, mm.T))      # (..., h, w_out)
            else:
                out.append(torch.matmul(mm, x))        # (..., h_out, w)
        return out


@dataclass
class SelectComps(Op):
    """Reorder/drop/add components. spec[i] = source index, or a float
    constant to synthesize (e.g. opaque alpha = 1.0, gray chroma = 0.0)."""
    spec: Tuple[object, ...]

    def apply(self, comps):
        return [comps[s] if isinstance(s, int)
                else torch.full_like(comps[0], float(s)) for s in self.spec]


def compile_ops(ops: Sequence[Op]):
    """Fold an op list into one function comps→comps."""
    ops = tuple(ops)

    def fn(comps: List[torch.Tensor]) -> List[torch.Tensor]:
        for op in ops:
            comps = op.apply(comps)
        return comps

    return fn


def optimize(ops: Sequence[Op]) -> List[Op]:
    """Algebraic op fusion (analog of ops_optimizer.c):
    - merge adjacent Linear ops into one matrix
    - drop identity Linear / identity SelectComps
    """
    out: List[Op] = []
    for op in ops:
        if isinstance(op, Linear) and out and isinstance(out[-1], Linear):
            prev = out.pop()
            if op.matrix.shape[1] == prev.matrix.shape[0]:
                out.append(op.compose(prev))
                continue
            out.append(prev)
        if isinstance(op, Linear):
            n = op.matrix.shape[0]
            if (op.matrix.shape == (n, n)
                    and np.allclose(op.matrix, np.eye(n))
                    and np.allclose(op.offset, 0.0)):
                continue
        if isinstance(op, SelectComps) and all(
                isinstance(s, int) and s == i for i, s in enumerate(op.spec)):
            continue
        out.append(op)
    return out
