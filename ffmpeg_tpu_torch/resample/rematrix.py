"""Channel mixing matrix builder (the port's copy of
ffmpeg_tpu/resample/rematrix.py; analog of libswresample/rematrix.c).

Builds an (out_ch, in_ch) matrix from channel layouts using the standard
downmix/upmix rules; the resampler applies it in float64 on the host.
"""

from __future__ import annotations

import math

import numpy as np

from ..formats.channel_layout import ChannelLayout

M_SQRT1_2 = 1.0 / math.sqrt(2.0)


def build_matrix(in_layout: ChannelLayout, out_layout: ChannelLayout,
                 center_mix: float = M_SQRT1_2,
                 surround_mix: float = M_SQRT1_2,
                 lfe_mix: float = 0.0,
                 normalize: bool = True) -> np.ndarray:
    """Mixing coefficients following rematrix.c's rule set (:70-240)."""
    inn = in_layout.channel_names() if in_layout.mask else None
    out = out_layout.channel_names() if out_layout.mask else None
    n_in = in_layout.nb_channels
    n_out = out_layout.nb_channels
    if inn is None or out is None:
        # unknown layouts: identity-ish passthrough
        m = np.zeros((n_out, n_in))
        for i in range(min(n_in, n_out)):
            m[i, i] = 1.0
        return m

    idx_in = {c: i for i, c in enumerate(inn)}
    m = np.zeros((n_out, n_in), np.float64)

    def has_out(c):
        return c in out

    def add(dst, src, coef):
        if dst in out and src in idx_in:
            m[out.index(dst), idx_in[src]] += coef

    # direct copies
    for c in inn:
        add(c, c, 1.0)

    # mono/center relationships
    if "FC" in idx_in and not has_out("FC"):
        add("FL", "FC", center_mix)
        add("FR", "FC", center_mix)
    if not any(c in idx_in for c in ("FL",)) and "FC" in idx_in and has_out("FL"):
        pass
    if "FL" in idx_in and not has_out("FL") and has_out("FC"):
        add("FC", "FL", M_SQRT1_2)
        add("FC", "FR", M_SQRT1_2)

    # back/side folding
    for bl, br in (("BL", "BR"), ("SL", "SR")):
        if bl in idx_in and not has_out(bl):
            if has_out("FL"):
                add("FL", bl, surround_mix)
                add("FR", br, surround_mix)
            elif has_out("FC"):
                add("FC", bl, surround_mix * M_SQRT1_2)
                add("FC", br, surround_mix * M_SQRT1_2)
    if "BC" in idx_in and not has_out("BC"):
        for t in ("BL", "SL"):
            if has_out(t):
                add(t, "BC", M_SQRT1_2)
                add({"BL": "BR", "SL": "SR"}[t], "BC", M_SQRT1_2)
                break
        else:
            if has_out("FL"):
                add("FL", "BC", surround_mix * M_SQRT1_2)
                add("FR", "BC", surround_mix * M_SQRT1_2)
    # side<->back substitution on output
    if has_out("BL") and "BL" not in idx_in and "SL" in idx_in:
        add("BL", "SL", 1.0)
        add("BR", "SR", 1.0)
    if has_out("SL") and "SL" not in idx_in and "BL" in idx_in:
        add("SL", "BL", 1.0)
        add("SR", "BR", 1.0)

    # LFE
    if "LFE" in idx_in and not has_out("LFE") and lfe_mix != 0.0:
        add("FL", "LFE", lfe_mix)
        add("FR", "LFE", lfe_mix)
    # upmix mono → stereo/others
    if "FC" in idx_in and len(inn) == 1:
        for c in out:
            if c in ("FL", "FR"):
                m[out.index(c), idx_in["FC"]] = 1.0
    # stereo → mono
    if has_out("FC") and len(out) == 1 and "FL" in idx_in:
        m[out.index("FC"), idx_in["FL"]] = 0.5
        m[out.index("FC"), idx_in["FR"]] = 0.5

    if normalize:
        peak = np.abs(m).sum(axis=1).max()
        if peak > 1.0:
            m /= peak
    return m
