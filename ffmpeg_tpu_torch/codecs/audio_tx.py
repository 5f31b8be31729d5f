"""The device step of the port's MDCT audio codecs that the JAX package
runs through ops/tx.py one transform at a time: the AAC encoder's MDCT,
the Vorbis and the CELT IMDCT.

Each codec gathers the transforms of one unit of work (an `encode()`
call, a packet, a frame) into one batch, whose inputs depend on no
earlier transform's output, and hands it to `run`: one copy to the
device, one transform, one copy back.  The host work before and after
stays in numpy, in the reference's order.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .vp9.recon_tpu import _Timer


def open_device(device: torch.device | str) -> torch.device:
    """The codec's device; "cuda" without a card raises here, at open,
    and never falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device}: CUDA is not available")
    return device


def start(device: torch.device, stats: Optional[list]) -> Optional[_Timer]:
    """A timer for one unit of work when `stats` is a list, else None."""
    return _Timer(device) if stats is not None else None


def run(fn: Callable[[torch.Tensor], torch.Tensor], x: np.ndarray,
        device: torch.device, timer: Optional[_Timer] = None,
        stats: Optional[list] = None) -> np.ndarray:
    """fn over the host array `x` cast to float32, on `device`: one h2d,
    one call, one d2h; the result as a float64 host array, as the
    reference reads its transforms back.  With a timer, appends the
    split to `stats`: the host's ms before the copy ("parse") and in the
    stage ("device"), the bytes each way, and the device's h2d,
    transform and d2h ms (CUDA events on a card, the host's clock on the
    CPU)."""
    x = np.ascontiguousarray(x, np.float32)
    tm = timer
    if tm is not None:
        tm.host_mark("parse")
        tm.dev_mark("h2d")
    xd = torch.from_numpy(x).to(device)
    if tm is not None:
        tm.dev_mark("transform")
    yd = fn(xd)
    if tm is not None:
        tm.dev_mark("d2h")
    y = yd.cpu().numpy()
    if tm is not None:
        tm.dev_mark("end")
        tm.host_mark("device")
        stats.append({"host": dict(tm.host), "h2d_bytes": x.nbytes,
                      "d2h_bytes": y.nbytes, "device": tm.device_ms()})
        tm.events = []
        tm.host = {}
    return np.asarray(y, np.float64)
