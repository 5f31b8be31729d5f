"""Windowed-sinc polyphase filter bank builder (the port's copy of
ffmpeg_tpu/resample/fir.py).

Analog of libswresample/resample.c build_filter (:41-126): Kaiser /
Blackman-Nuttall windowed sinc, one row of taps per phase, built in
float64 on the host. The resample itself is a gather of input windows and
a weighted reduction against the per-output phase rows on the device
(resample/swresample.py).
"""

from __future__ import annotations

import numpy as np


def _window(x: np.ndarray, kind: str, beta: float) -> np.ndarray:
    """Window on normalized positions x ∈ [-1, 1]."""
    x = np.clip(x, -1.0, 1.0)
    if kind == "kaiser":
        from numpy import i0
        return i0(beta * np.sqrt(np.maximum(0.0, 1.0 - x * x))) / i0(beta)
    if kind == "blackman_nuttall":
        t = np.pi * (x + 1.0)
        return (0.3635819 - 0.4891775 * np.cos(t) + 0.1365995 * np.cos(2 * t)
                - 0.0106411 * np.cos(3 * t))
    if kind == "rect":
        return np.ones_like(x)
    raise ValueError(f"unknown window {kind!r}")


def build_filter_bank(taps: int, phases: int, cutoff: float,
                      window: str = "kaiser", beta: float = 9.0) -> np.ndarray:
    """(phases, taps) float64 bank; phase p reconstructs the signal at
    fractional position center + p/phases, center = taps//2 - 1 (matching
    swresample's indexing so the group delay is identical)."""
    center = taps // 2 - 1
    p = np.arange(phases, dtype=np.float64)[:, None] / phases
    rel = np.arange(taps, dtype=np.float64)[None, :] - center - p  # (P, T)
    h = cutoff * np.sinc(cutoff * rel)
    h *= _window(rel / (taps / 2), window, beta)
    h /= h.sum(axis=1, keepdims=True)
    return h
