"""Transform engine — FFT / MDCT / DCT / RDFT (counterpart of
ffmpeg_tpu/ops/tx.py; analog of libavutil/tx.{c,h}).

Two codelet classes, both real float32 matmuls, as the reference has them:

  * direct DFT/DCT/MDCT matmul codelets for N <= MATMUL_MAX (AAC 1024/128,
    AC-3 256, MP3 576/192, Opus 960...);
  * the 4-step (Bailey) decomposition for FFTs above DFT_DIRECT_MAX:
    N = A*B computed as DFT_A → twiddle → DFT_B with batched matmuls and
    one transpose.

Complex data is interleaved float pairs (..., 2) = (re, im), the wire
format of the reference's AVComplexFloat (tx.h). Every function takes
tensors, runs on their device and is batched over leading axes; `scale`
multiplies the output like av_tx's scale argument. Each matrix is built
once per (kind, n, inverse, scale, device): in float64 with numpy as the
reference builds it, scaled, transposed, cast to float32, then copied to
the device once. The products run in full float32 (the reference pins
Precision.HIGHEST) and raise if TF32 is allowed.

MDCT convention matches tx.h:39-111: forward takes 2N samples → N coeffs;
inverse takes N → 2N time samples for windowed overlap-add.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..core.frame import on_device
from ..scale.ops import require_full_fp32
from ..utils.error import InvalidData

MATMUL_MAX = 4096
DFT_DIRECT_MAX = 1024


# ---------------------------------------------------------------------------
# matrix builders (float64 on host, cast to float32 constants)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=64)
def _mdct_matrix(n: int) -> np.ndarray:
    """(N, 2N): X[k] = sum_n x[n] cos(π/2N (2n+1+N)(2k+1)/2)."""
    k = np.arange(n)[:, None]
    j = np.arange(2 * n)[None, :]
    return np.cos(np.pi / (2 * n) * (2 * j + 1 + n) * (2 * k + 1) / 2.0)


@lru_cache(maxsize=64)
def _dct2_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    return 2.0 * np.cos(np.pi * k * (2 * j + 1) / (2 * n))


@lru_cache(maxsize=64)
def _dct3_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    m = 2.0 * np.cos(np.pi * j * (2 * k + 1) / (2 * n))
    m[:, 0] = 1.0
    return m


@lru_cache(maxsize=64)
def _dct4_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    return 2.0 * np.cos(np.pi * (2 * j + 1) * (2 * k + 1) / (4 * n))


@lru_cache(maxsize=64)
def _dct1_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    m = 2.0 * np.cos(np.pi * k * j / (n - 1))
    m[:, 0] *= 0.5
    m[:, -1] *= 0.5
    return m


@lru_cache(maxsize=64)
def _dst1_matrix(n: int) -> np.ndarray:
    k = np.arange(1, n + 1)[:, None]
    j = np.arange(1, n + 1)[None, :]
    return 2.0 * np.sin(np.pi * k * j / (n + 1))


@lru_cache(maxsize=64)
def _dft_matrices(n: int, inverse: bool):
    """(Wr, Wi) real/imag parts of the DFT matrix."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    sign = 2.0 if inverse else -2.0
    ang = sign * np.pi * k * j / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@lru_cache(maxsize=64)
def _rdft_matrices(n: int):
    """Real-input DFT: (n//2+1, n) cos and sin matrices."""
    k = np.arange(n // 2 + 1)[:, None]
    j = np.arange(n)[None, :]
    ang = -2.0 * np.pi * k * j / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


# ---------------------------------------------------------------------------
# device constants and products
# ---------------------------------------------------------------------------

def _const(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host float32 matrix copied to `device` once."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _mm(x: torch.Tensor, m_t: torch.Tensor) -> torch.Tensor:
    """x (..., n) @ m_t (n, m) in full float32 on m_t's device; a tensor on
    another device raises InvalidData."""
    if not on_device(x, m_t.device):
        raise InvalidData(f"tx: input on {x.device}, matrices on "
                          f"{m_t.device}")
    return torch.matmul(x.to(torch.float32), m_t)


def _matmul_codelet(mat: np.ndarray, scale: float, device: torch.device):
    m_t = _const((mat * scale).T, device)
    return lambda x: _mm(x, m_t)


# ---------------------------------------------------------------------------
# complex helpers on interleaved (..., 2) float pairs
# ---------------------------------------------------------------------------

def _split(x):
    return x[..., 0], x[..., 1]


def _join(re, im):
    return torch.stack([re, im], dim=-1)


def _cmatmul(wr_t, wi_t, xr, xi):
    """(W @ x) for complex W (given as its transposed real parts) and
    complex x, contracting x's last axis: x (..., n), W (m, n) → (..., m)."""
    yr = _mm(xr, wr_t) - _mm(xi, wi_t)
    yi = _mm(xr, wi_t) + _mm(xi, wr_t)
    return yr, yi


def _factor(n: int):
    a = 1 << int(math.floor(math.log2(math.sqrt(n))))
    while n % a:
        a >>= 1
    return a, n // a


def _dft_t(n: int, inverse: bool, device: torch.device):
    return tuple(_const(w.T, device) for w in _dft_matrices(n, inverse))


def _fft_pairs(n: int, inverse: bool, device: torch.device):
    """fn on (..., n, 2): DFT via direct matmul or 4-step decomposition."""
    if n <= DFT_DIRECT_MAX:
        wr_t, wi_t = _dft_t(n, inverse, device)

        def direct(x):
            xr, xi = _split(x)
            return _join(*_cmatmul(wr_t, wi_t, xr, xi))
        return direct

    a, b = _factor(n)
    if a == 1:
        raise NotImplementedError(f"fft size {n} has no power-of-2 factor")
    wra_t, wia_t = _dft_t(a, inverse, device)
    wrb_t, wib_t = _dft_t(b, inverse, device)
    ka = np.arange(a)[:, None]
    kb = np.arange(b)[None, :]
    sign = 2.0 if inverse else -2.0
    tw = sign * np.pi * ka * kb / n
    twr = _const(np.cos(tw), device)
    twi = _const(np.sin(tw), device)

    def four_step(x):
        xr, xi = _split(x)
        lead = xr.shape[:-1]
        xr = xr.reshape(lead + (a, b))
        xi = xi.reshape(lead + (a, b))
        # DFT over the a axis: treat b as batch → move a last
        yr, yi = _cmatmul(wra_t, wia_t, xr.transpose(-1, -2),
                          xi.transpose(-1, -2))          # (..., b, a)
        yr = yr.transpose(-1, -2)                         # (..., a, b)
        yi = yi.transpose(-1, -2)
        # twiddle
        tr = yr * twr - yi * twi
        ti = yr * twi + yi * twr
        # DFT over the b axis
        zr, zi = _cmatmul(wrb_t, wib_t, tr, ti)           # (..., a, b)
        # output index k = k_b * a + k_a → transpose (a,b) → (b,a), flatten
        zr = zr.transpose(-1, -2).reshape(lead + (n,))
        zi = zi.transpose(-1, -2).reshape(lead + (n,))
        return _join(zr, zi)
    return four_step


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@lru_cache(maxsize=256)
def _tx_cached(kind: str, n: int, inverse: bool, scale: float,
               device: torch.device):
    fn = _tx_build(kind, n, inverse, scale, device)

    def checked(x):
        require_full_fp32()
        return fn(x)
    return checked


def tx_init(kind: str, n: int, inverse: bool = False, scale: float = 1.0,
            device: torch.device | str = "cuda"):
    """Cached transform on `device`: fn(x)->y operating on the last axes of
    a tensor on that device (a tensor on another raises InvalidData).

    kinds:
      "fft":  (..., n, 2) → (..., n, 2)       interleaved complex
      "rdft": fwd real (..., n) → (..., n//2+1, 2); inv the reverse
      "mdct": fwd (..., 2n) → (..., n); inv (..., n) → (..., 2n)
      "dct1"/"dct2"/"dct3"/"dct4"/"dst1": real (..., n) → (..., n)
    """
    return _tx_cached(kind, n, inverse, scale, torch.device(device))


def _tx_build(kind: str, n: int, inverse: bool, scale: float,
              device: torch.device):
    if kind == "fft":
        f = _fft_pairs(n, inverse, device)
        if scale == 1.0:
            return f
        return lambda x: f(x) * scale
    if kind == "rdft":
        cr, ci = _rdft_matrices(n)
        if not inverse:
            crj_t = _const((cr * scale).T, device)
            cij_t = _const((ci * scale).T, device)

            def fwd(x):
                return _join(_mm(x, crj_t), _mm(x, cij_t))
            return fwd
        # inverse: x[j] = 1/n * sum_k (weighted) — (n, n//2+1) matrices
        # with hermitian symmetry folded in: weight 1 for k=0 and k=n/2, 2 else
        w = np.full(n // 2 + 1, 2.0)
        w[0] = 1.0
        if n % 2 == 0:
            w[-1] = 1.0
        ir = (cr.T * w) / n * scale          # (n, n//2+1)
        ii = (-ci.T * w) / n * scale
        irj_t = _const(ir.astype(np.float32).T, device)
        iij_t = _const(ii.astype(np.float32).T, device)

        def inv(x):
            xr, xi = _split(x)
            return _mm(xr, irj_t) - _mm(xi, iij_t)
        return inv
    if kind == "mdct":
        if n > MATMUL_MAX:
            raise NotImplementedError(f"mdct size {n} > {MATMUL_MAX}")
        mat = _mdct_matrix(n).T if inverse else _mdct_matrix(n)
        return _matmul_codelet(mat, scale, device)
    if kind == "dct2":
        return _matmul_codelet(_dct2_matrix(n), scale, device)
    if kind == "dct3":
        return _matmul_codelet(_dct3_matrix(n), scale, device)
    if kind == "dct4":
        return _matmul_codelet(_dct4_matrix(n), scale, device)
    if kind == "dct1":
        return _matmul_codelet(_dct1_matrix(n), scale, device)
    if kind == "dst1":
        return _matmul_codelet(_dst1_matrix(n), scale, device)
    raise ValueError(f"unknown transform {kind!r}")


def fft(x: torch.Tensor, inverse: bool = False, scale: float = 1.0):
    return tx_init("fft", int(x.shape[-2]), inverse, scale, x.device)(x)


def rdft(x: torch.Tensor, n: int, inverse: bool = False, scale: float = 1.0):
    return tx_init("rdft", n, inverse, scale, x.device)(x)


def mdct(x: torch.Tensor, n: int, scale: float = 1.0):
    return tx_init("mdct", n, False, scale, x.device)(x)


def imdct(x: torch.Tensor, n: int, scale: float = 1.0):
    """N coeffs → 2N time samples (caller overlap-adds windowed halves)."""
    return tx_init("mdct", n, True, scale, x.device)(x)


# ---------------------------------------------------------------------------
# windows (used by MDCT codecs; aacdec, ac3, opus), host float64
# ---------------------------------------------------------------------------

@lru_cache(maxsize=32)
def sine_window(n: int) -> np.ndarray:
    return np.sin(np.pi / n * (np.arange(n) + 0.5))


@lru_cache(maxsize=32)
def kbd_window(n: int, alpha: float = 4.0) -> np.ndarray:
    """Kaiser-Bessel derived window of length n (AAC/AC-3): symmetric,
    satisfies the Princen-Bradley condition w[i]^2 + w[i+n/2]^2 = 1."""
    from numpy import i0
    h = n // 2
    # Kaiser kernel on h+1 points
    x = 2.0 * np.arange(h + 1) / h - 1.0
    k = i0(np.pi * alpha * np.sqrt(np.maximum(0.0, 1.0 - x * x)))
    c = np.cumsum(k)
    first = np.sqrt(c[:h] / c[h])
    return np.concatenate([first, first[::-1]])
