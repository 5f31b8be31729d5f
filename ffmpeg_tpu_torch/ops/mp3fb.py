"""MP3 hybrid filterbank (reference: libavcodec/mpegaudiodec_template.c
compute_imdct + mpegaudiodsp dct32/apply_window).

Counterpart of ffmpeg_tpu/ops/mp3fb.py in PyTorch, on the device of its
inputs.  The 36/12-point IMDCTs and the 32-band polyphase matrixing are
small dense matmuls at full float32 (each entry point raises if TF32 or
a lower float32 matmul precision is allowed); the constant matrices are
the reference's, built in numpy and cached once per device.

Two forms of each stage:

- `imdct_granule(xr, block_types, overlap)` and
  `synth_granule(sb_samples, fifo)` keep the reference's per-granule
  contracts and shapes;
- `imdct_packet` and `synth_packet` take a whole packet in one call,
  which is what the decoder runs: the IMDCT of all its granules at once
  (granule g's first half adds granule g-1's second half, a shift
  across the granule axis), and the synthesis of all its time slots at
  once (V for every slot in one matmul, then the windowed sum over the
  16-slot history for every slot through one strided view of the old
  FIFO followed by the new V's), where the reference scans slot by
  slot.

The overlap and the FIFO are tensors that the caller keeps on the
device between packets; each call returns new ones and writes nothing it
was given.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..codecs.mp3_tables import ENWINDOW
from ..scale.ops import require_full_fp32

SBLIMIT = 32


# ---------------------------------------------------------------------------
# constant matrices (the reference's, built in numpy)

@lru_cache()
def _imdct36_matrix() -> np.ndarray:
    # x[n] = sum_k X[k] cos(pi/72 (2n+1+18)(2k+1)), 18 coeffs -> 36 samples
    n = np.arange(36)[:, None]
    k = np.arange(18)[None, :]
    return np.cos(np.pi / 72 * (2 * n + 1 + 18) * (2 * k + 1)).astype(np.float32)


@lru_cache()
def _imdct12_matrix() -> np.ndarray:
    n = np.arange(12)[:, None]
    k = np.arange(6)[None, :]
    return np.cos(np.pi / 24 * (2 * n + 1 + 6) * (2 * k + 1)).astype(np.float32)


@lru_cache()
def _windows() -> np.ndarray:
    """IMDCT windows for block types 0..3 (type 2 = short handled apart)."""
    w = np.zeros((4, 36), np.float32)
    n = np.arange(36)
    w[0] = np.sin(np.pi / 36 * (n + 0.5))
    w[1][:18] = np.sin(np.pi / 36 * (n[:18] + 0.5))
    w[1][18:24] = 1.0
    w[1][24:30] = np.sin(np.pi / 12 * (n[24:30] - 24 + 0.5))
    w[1][30:] = 0.0
    w[3][:6] = 0.0
    w[3][6:12] = np.sin(np.pi / 12 * (n[6:12] - 6 + 0.5))
    w[3][12:18] = 1.0
    w[3][18:] = np.sin(np.pi / 36 * (n[18:] + 0.5))
    w[2] = 0.0   # unused (short)
    return w


@lru_cache()
def _short_window() -> np.ndarray:
    return np.sin(np.pi / 12 * (np.arange(12) + 0.5)).astype(np.float32)


@lru_cache()
def _synth_matrix() -> np.ndarray:
    # ISO 11172-3 matrixing: V[i] = sum_k cos((16+i)(2k+1) pi/64) S[k]
    i = np.arange(64)[:, None]
    k = np.arange(32)[None, :]
    return np.cos((16 + i) * (2 * k + 1) * np.pi / 64).astype(np.float32)


@lru_cache()
def _synth_window() -> np.ndarray:
    """Full 512-tap ISO D window reconstructed from the half table
    (mpegaudiodsp_template.c mpa_synth_init sign rule)."""
    # 2^-16: 2^-15 table scale x the 1/2 folded into the ISO matrixing
    # (calibrated exactly against the reference decoder's output level)
    half = np.asarray(ENWINDOW, np.float64) / (1 << 16)
    d = np.zeros(512, np.float64)
    d[:257] = half
    for i in range(1, 256):
        v = half[i]
        d[512 - i] = v if (i & 63) == 0 else -v
    return d.astype(np.float32)


def _freq_inversion() -> np.ndarray:
    """Odd time samples of odd subbands are sign-flipped."""
    inv = np.ones((SBLIMIT, 18), np.float32)
    inv[1::2, 1::2] = -1.0
    return inv


@lru_cache()
def _history_window() -> np.ndarray:
    """The synthesis window laid over one slot's 16-entry V history as
    `synth_packet` reads it, (64, 16): entry [h*32 + k, e] weighs half h
    of the V that is 15 - e slots older than the slot's own.  History
    entry i (0 = newest) contributes its first half when i is even and
    its second when odd (the reference's U), times d[i, k]; the other
    half's weight is 0."""
    d = _synth_window().reshape(16, 32)
    w = np.zeros((2, 32, 16), np.float32)
    for i in range(16):
        w[i % 2, :, 15 - i] = d[i]
    return w.reshape(64, 16)


@lru_cache()
def _consts(device: torch.device) -> dict:
    """The constant matrices as float32 tensors on `device`, made once."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)
    return {"m36t": t(_imdct36_matrix().T), "m12t": t(_imdct12_matrix().T),
            "wins": t(_windows()), "ws": t(_short_window()),
            "inv": t(_freq_inversion()), "nt": t(_synth_matrix().T),
            "hist": t(_history_window())}


# ---------------------------------------------------------------------------
# IMDCT

def _hybrid(xr: torch.Tensor, block_types: torch.Tensor, c: dict):
    """The windowed 36-sample output of every band: (..., 32, 18) spectra
    and (..., 32) block types → (..., 32, 36), long or short per band."""
    long_out = torch.matmul(xr, c["m36t"])                 # (..., 32, 36)
    # block types clipped to the window table, as the reference does
    w = c["wins"][block_types.clamp(0, 3).long()]          # (..., 32, 36)
    long_out = long_out * w
    # short: 3 x 12-point IMDCTs on interleaved coeffs X[w + 3k]
    xs = xr.unflatten(-1, (6, 3)).transpose(-1, -2)        # (..., 32, 3, 6)
    short = torch.matmul(xs, c["m12t"]) * c["ws"]          # (..., 32, 3, 12)
    # window w occupies samples 6 + 6w .. 6 + 6w + 11; the three overlap
    # and are summed in the reference's order
    pad = torch.nn.functional.pad
    short_full = (pad(short[..., 0, :], (6, 18))
                  + pad(short[..., 1, :], (12, 12))
                  + pad(short[..., 2, :], (18, 6)))
    return torch.where((block_types == 2)[..., None], short_full, long_out)


def imdct_packet(xr: torch.Tensor, block_types: torch.Tensor,
                 overlap: torch.Tensor):
    """Hybrid synthesis for all granules of one packet.

    xr:          (ngr, ch, 32, 18) dequantized spectra (band-major)
    block_types: (ngr, ch, 32) integer effective block type per subband
                 (mixed blocks already resolved by the host)
    overlap:     (ch, 32, 18) carry from the previous packet
    → (sb_samples (ch, 18*ngr, 32) in time-slot order, new overlap)
    """
    require_full_fp32()
    c = _consts(xr.device)
    out36 = _hybrid(xr, block_types, c)                    # (g, ch, 32, 36)
    # granule g adds granule g-1's second half; the first adds the carry
    prev = torch.cat([overlap[None], out36[:-1, ..., 18:]], dim=0)
    sb = (out36[..., :18] + prev) * c["inv"]               # (g, ch, 32, 18)
    ngr, ch = sb.shape[:2]
    sb = sb.permute(1, 0, 3, 2).reshape(ch, ngr * 18, SBLIMIT)
    return sb, out36[-1, ..., 18:]


def imdct_granule(xr: torch.Tensor, block_types: torch.Tensor,
                  overlap: torch.Tensor):
    """Hybrid synthesis for one granule, the reference's contract.

    xr (ch, 32, 18), block_types (ch, 32), overlap (ch, 32, 18)
    → (sb_samples (ch, 18, 32), new overlap (ch, 32, 18))
    """
    return imdct_packet(xr[None], block_types[None], overlap)


# ---------------------------------------------------------------------------
# polyphase synthesis

def synth_packet(sb_samples: torch.Tensor, fifo: torch.Tensor):
    """Polyphase synthesis for any number T of time slots at once.

    sb_samples: (ch, T, 32); fifo: (ch, 16, 64) newest-first V history.
    → (pcm (ch, T*32), new fifo)

    The history of slot t is V[t], V[t-1], ..., V[t-15], reaching back
    into the FIFO; laid out oldest first, the 16 entries of slot t are
    one window of a strided view (`unfold`) of the FIFO reversed and
    followed by the T new V's, so no loop over slots is needed.
    """
    require_full_fp32()
    c = _consts(sb_samples.device)
    ch, T = sb_samples.shape[:2]
    v = torch.matmul(sb_samples, c["nt"])                  # (ch, T, 64)
    hist = torch.cat([fifo.flip(1), v], dim=1)             # (ch, 16+T, 64)
    win = hist.unfold(1, 16, 1)[:, 1:]                     # (ch, T, 64, 16)
    out = (win * c["hist"]).sum(-1)                        # (ch, T, 64)
    pcm = out[..., :32] + out[..., 32:]                    # (ch, T, 32)
    return pcm.reshape(ch, T * SBLIMIT), hist[:, -16:].flip(1)


def synth_granule(sb_samples: torch.Tensor, fifo: torch.Tensor):
    """Polyphase synthesis for one granule's 18 time slots, the
    reference's contract: (ch, 18, 32), fifo (ch, 16, 64)
    → (pcm (ch, 576), new fifo)."""
    return synth_packet(sb_samples, fifo)
