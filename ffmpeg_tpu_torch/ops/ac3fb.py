"""AC-3 synthesis filterbank (ATSC A/52 §7.9): 512/256-point TDAC
inverse MDCT + KBD window overlap-add (reference: libavcodec/ac3dec.c
do_imdct + libavutil/tx_template.c mdct_naive_inv + kbd window init).

Counterpart of ffmpeg_tpu/ops/ac3fb.py in PyTorch, on the device of its
inputs.  The window and the half-IMDCT matrices are the reference's,
built in float64 and cast to float32; the IMDCT is a full-float32
matmul (the reference asks for Precision.HIGHEST: every entry point
raises if TF32 or a lower float32 matmul precision is allowed).

`imdct_half` and `overlap_window` keep the reference's per-block
contracts (`overlap_window` vectorised over leading axes); `frame` runs
every block and channel of one frame in one call, which is what the
decoder runs: one matmul over every block's 256 coefficients, one over
the block-switched halves when a block switches, and the windowing of
every block at once (block b's delay is block b-1's second half, known
once the transforms are done).  The (channels, 128) delay is a tensor
that the caller keeps on the device between frames; `frame` returns a
new one and writes nothing it was given.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..scale.ops import require_full_fp32


def kbd_window(n: int = 256, alpha: float = 5.0) -> np.ndarray:
    """Kaiser-Bessel-derived window (A/52 Table 7.33 construction)."""
    alpha2 = (alpha * np.pi / n) ** 2
    local = np.zeros(n)
    acc = 0.0
    for i in range(n):
        tmp = i * (n - i) * alpha2
        bessel = 1.0
        for j in range(25, 0, -1):          # I0 series
            bessel = bessel * tmp / (j * j) + 1.0
        acc += bessel
        local[i] = acc
    return np.sqrt(local / (acc + 1.0)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _imdct_matrix(n_coeffs: int) -> np.ndarray:
    """(n_coeffs, n_coeffs) half-IMDCT matrix M with out = X @ M, out
    length = n_coeffs (the reference's tx 'imdct half')."""
    n = n_coeffs            # input coefficients
    half = n // 2
    phase = np.pi / (4.0 * n)
    k = np.arange(n, dtype=np.float64)      # coeff index
    i = np.arange(half, dtype=np.float64)   # output index within halves
    # first half: cos((2k+1) * phase*(4*half - 2i - 1))
    a_d = np.cos(np.outer(2 * k + 1, phase * (4 * half - 2 * i - 1)))
    # second half, per tx_template: -cos((2k+1) * phase*(3n + 2i + 1))
    a_u = -np.cos(np.outer(2 * k + 1, phase * (3 * n + 2 * i + 1)))
    return np.concatenate([a_d, a_u], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def window() -> np.ndarray:
    return kbd_window()


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    """The IMDCT matrices and the window halves on `device`, made once:
    lo = w[0:128], hi_rev = w[255-k] for k = 0..127."""
    w = window()
    return {256: torch.from_numpy(_imdct_matrix(256)).to(device),
            128: torch.from_numpy(_imdct_matrix(128)).to(device),
            "lo": torch.from_numpy(w[:128].copy()).to(device),
            "hi_rev": torch.from_numpy(w[128:][::-1].copy()).to(device)}


def imdct_half(coeffs: torch.Tensor) -> torch.Tensor:
    """Batched half-IMDCT: (..., n) coeffs → (..., n) time samples, n 256
    or 128, in full float32."""
    require_full_fp32()
    return torch.matmul(coeffs.to(torch.float32),
                        _consts(coeffs.device)[coeffs.shape[-1]])


def overlap_window(delay: torch.Tensor,
                   first_half: torch.Tensor) -> torch.Tensor:
    """vector_fmul_window analog (len=128): (..., 256) output samples from
    the (..., 128) saved delay and the half-transform's first 128
    samples, for any leading axes."""
    c = _consts(delay.device)
    tmp_rev = first_half.flip(-1)
    # out[k] = delay[k] w[255-k] - tmp_rev[k] w[k]
    lo = delay * c["hi_rev"] - tmp_rev * c["lo"]
    # out[255-k] = delay[k] w[k] + tmp_rev[k] w[255-k]
    hi = (delay * c["lo"] + tmp_rev * c["hi_rev"]).flip(-1)
    return torch.cat([lo, hi], dim=-1)


def frame(xf: torch.Tensor, switched, delay: torch.Tensor):
    """The filterbank of one frame.

    xf:       (blocks, channels, 256) scaled coefficients, any number of
              blocks (6 for AC-3, 1, 2, 3 or 6 for E-AC-3)
    switched: host (blocks, channels) bools, the blocks that use the two
              128-point transforms (even and odd coefficients)
    delay:    (channels, 128) from the previous frame
    → (pcm (channels, blocks*256), new delay (channels, 128))
    """
    h = imdct_half(xf)                                 # (B, C, 256)
    switched = np.asarray(switched, bool)
    if switched.any():
        short = torch.cat([imdct_half(xf[..., 0::2]),
                           imdct_half(xf[..., 1::2])], dim=-1)
        mask = torch.from_numpy(switched).to(xf.device)
        h = torch.where(mask[..., None], short, h)
    # block b's delay is block b-1's second half; block 0's the carry
    d = torch.cat([delay[None], h[:-1, :, 128:]], dim=0)
    out = overlap_window(d, h[..., :128])              # (B, C, 256)
    nblk, nch = out.shape[:2]
    return (out.permute(1, 0, 2).reshape(nch, nblk * 256),
            h[-1, :, 128:])
