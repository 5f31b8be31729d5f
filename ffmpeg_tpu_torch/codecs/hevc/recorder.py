"""Parse-time recording of HEVC reconstruction work for device replay.

The reference decodes a CTU by interleaving CABAC parse with pixel
reconstruction (hevcdec.c hls_coding_unit -> intra pred / MC / residual
add inline).  The TPU build splits that: the host parses the slice with
reconstruction suppressed, recording three kinds of work items

  * intra prediction units  (plane, x, y, size, mode, avail, filter)
  * transform units          (plane, x, y, size, dequantized coeffs, kind)
  * inter prediction         (driven by the dec.pf/mvx/mvy/refidx grids
                              that the parse fills anyway - nothing to
                              record)

and assigns every intra prediction a **dependency level**: 1 + the
maximum level of any already-recorded block whose pixels its reference
samples can read.  Blocks of equal level are independent, so the device
program (recon_tpu.py) reconstructs the frame as a lax.scan over levels
with every block of a level computed in parallel - the same skewed-
iteration strategy as the H.264 wavefront (recon_tpu.py there), but
driven by measured dependencies instead of a fixed MB diagonal, which
HEVC's variable TU sizes require.

The port's copy of ffmpeg_tpu/codecs/hevc/recorder.py, held equal to it by
tests/test_torch_hevc_host.py."""

from __future__ import annotations

import numpy as np

# TU transform kinds
K_IDCT = 0
K_DST = 1
K_TSKIP = 2

# intra reference-filter kinds
F_NONE = 0
F_SMOOTH = 1
F_STRONG = 2       # strong-candidate: device tests the flatness thresholds


class ReconRecorder:
    """Collects reconstruction work for one frame (FrameDec)."""

    def __init__(self, dec):
        H, W = dec.sps.height, dec.sps.width
        # dependency-level grids at 4px granularity, one per plane
        self._lvl = [
            np.zeros(((H + 3) // 4, (W + 3) // 4), np.int32),
            np.zeros(((H // 2 + 3) // 4, (W // 2 + 3) // 4), np.int32),
            np.zeros(((H // 2 + 3) // 4, (W // 2 + 3) // 4), np.int32),
        ]
        # intra records per (is_luma, size): lists of
        # (level, x, y, mode, avail_bits, filt, chroma_plane)
        self.intra = {}
        # TU records per (is_luma, size): lists of
        # (x, y, kind, coef int16 (n, n), chroma_plane)
        self.tus = {}
        self.max_level = 0

    # -- intra ---------------------------------------------------------
    def record_intra(self, c_idx, x, y, size, mode, avail, filt):
        g = self._lvl[c_idx]
        gh, gw = g.shape
        lvl = 0
        # reference samples: top row y-1 spanning x-1 .. x+2n-1 and
        # left column x-1 spanning y-1 .. y+2n-1 (clamped to picture).
        if y > 0:
            r = (y - 1) >> 2
            c0 = max(0, x - 1) >> 2
            c1 = min(gw - 1, (x + 2 * size - 1) >> 2)
            lvl = max(lvl, int(g[r, c0:c1 + 1].max()))
        if x > 0:
            c = (x - 1) >> 2
            r0 = max(0, y - 1) >> 2
            r1 = min(gh - 1, (y + 2 * size - 1) >> 2)
            lvl = max(lvl, int(g[r0:r1 + 1, c].max()))
        lvl += 1
        g[y >> 2:(y + size + 3) >> 2, x >> 2:(x + size + 3) >> 2] = lvl
        self.max_level = max(self.max_level, lvl)
        ab = (avail[0] | (avail[1] << 1) | (avail[2] << 2)
              | (avail[3] << 3) | (avail[4] << 4))
        key = (c_idx == 0, size)
        self.intra.setdefault(key, []).append(
            (lvl, x, y, mode, ab, filt, max(0, c_idx - 1)))

    # -- residual ------------------------------------------------------
    def record_tu(self, c_idx, x, y, size, coef, kind):
        key = (c_idx == 0, size)
        self.tus.setdefault(key, []).append(
            (x, y, kind, np.asarray(coef, np.int32),
             max(0, c_idx - 1)))
