"""HDR tone mapping (counterpart of ffmpeg_tpu/filters/video5.py;
vf_tonemap.c behaviour) on linear-light float RGB frames, vectorized over
the full plane on the planes' device, in float32 as the reference's
numpy.

Algorithms: none/linear/gamma/clip/hable/reinhard/mobius with the
reference's parameter defaults (vf_tonemap.c:71-85), the luma-based
desaturation step (:127), and signal-peak determination from frame
side data or the transfer characteristic's nominal peak
(ff_determine_signal_peak: content light MaxCLL, mastering display
max_luminance / 100, else PQ=100 / HLG=12)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.frame import Frame
from ..formats import pixfmt as _pf
from ..utils.error import InvalidData
from ..utils.options import opt_float, opt_str
from .base import Filter, _tensor_planes, register_filter, tdiv

_NAN = float("nan")

# luma coefficients per colorspace (csp.c luma_coefficients; "rgb"
# is the identity sum, which is what RGB-tagged frames carry)
_LUMA = {
    "bt709": (0.2126, 0.7152, 0.0722),
    "bt2020nc": (0.2627, 0.6780, 0.0593),
    "bt2020c": (0.2627, 0.6780, 0.0593),
    "smpte170m": (0.299, 0.587, 0.114),
    "bt470bg": (0.299, 0.587, 0.114),
    "rgb": (1.0, 1.0, 1.0),
    "gbr": (1.0, 1.0, 1.0),
}


def _hable(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return (x * (x * a + b * c) + d * e) / (x * (x * a + b) + d * f) \
        - e / f


def _mobius(x, j, peak):
    a = -j * j * (peak - 1.0) / (j * j - 2.0 * j + peak)
    b = (j * j - 2.0 * j * peak + peak) / max(peak - 1.0, 1e-6)
    mapped = (b * b + 2.0 * b * j + j * j) / (b - a) * (x + a) \
        / (x + b)
    return torch.where(x <= j, x, mapped)


def determine_signal_peak(frame: Frame) -> float:
    """ff_determine_signal_peak analog: side data first, then the
    transfer function's nominal peak (in units of reference white =
    100 cd/m2)."""
    cll = frame.side_data.get("content_light_level")
    if cll and cll.get("max_cll"):
        return cll["max_cll"] / 100.0
    mdm = frame.side_data.get("mastering_display_metadata")
    if mdm and mdm.get("max_luminance"):
        return float(mdm["max_luminance"]) / 100.0
    trc = getattr(frame, "color_trc", "") or ""
    if trc in ("smpte2084", "pq"):
        return 100.0
    if trc in ("arib-std-b67", "hlg"):
        return 12.0
    return 1.0


@register_filter
class TonemapFilter(Filter):
    name = "tonemap"
    description = "conversion to/from different dynamic ranges"
    media_type = "video"
    OPTIONS = (
        opt_str("tonemap", default="none"),
        opt_float("param", default=_NAN),
        opt_float("desat", default=2.0),
        opt_float("peak", default=0.0),
    )

    def __init__(self, args: str = "", **opts):
        super().__init__(args, **opts)
        mode = str(self.tonemap)
        if mode not in ("none", "linear", "gamma", "clip", "hable",
                        "reinhard", "mobius"):
            raise InvalidData(f"tonemap: unknown mode {mode!r}")
        p = float(self.param)
        if mode == "gamma" and np.isnan(p):
            p = 1.8
        elif mode == "reinhard" and not np.isnan(p):
            p = (1.0 - p) / p
        elif mode == "mobius" and np.isnan(p):
            p = 0.3
        elif np.isnan(p):
            p = 1.0
        self._param = p
        self._mode = mode

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        if "f32" not in (frame.format or ""):
            raise InvalidData(
                "tonemap: requires linear float RGB input "
                "(gbrpf32); insert format/zscale first")
        peak = float(self.peak) or determine_signal_peak(frame)
        # gbrp plane order is G,B,R
        g, b, r = (p.to(torch.float32)
                   for p in _tensor_planes(frame.planes)[:3])

        desat = float(self.desat)
        cs = getattr(frame, "color_space", "") or "unspecified"
        if cs in ("unspecified", ""):
            # RGB-format frames carry identity luma (the rawvideo
            # path tags them AVCOL_SPC_RGB); otherwise the reference
            # disables desaturation with a warning (vf_tonemap.c:244)
            cs = "rgb" if _pf.get(frame.format).is_rgb else ""
        if cs not in _LUMA:
            desat = 0.0
        if desat > 0:
            cr, cg, cb = _LUMA[cs]
            luma = cr * r + cg * g + cb * b
            over = torch.clamp(luma - desat, min=1e-6) \
                / torch.clamp(luma, min=1e-6)
            r = r * (1 - over) + luma * over
            g = g * (1 - over) + luma * over
            b = b * (1 - over) + luma * over

        sig = torch.clamp(torch.maximum(r, torch.maximum(g, b)), min=1e-6)
        sig_orig = sig
        m = self._mode
        p = self._param
        if m == "linear":
            sig = tdiv(sig * p, peak)
        elif m == "gamma":
            lo = tdiv(sig * (0.05 / peak) ** (1.0 / p), 0.05)
            hi = torch.pow(tdiv(torch.clamp(sig, min=1e-9), peak), 1.0 / p)
            sig = torch.where(sig > 0.05, hi, lo)
        elif m == "clip":
            sig = torch.clamp(sig * p, 0.0, 1.0)
        elif m == "hable":
            sig = tdiv(_hable(sig), _hable(peak))
        elif m == "reinhard":
            sig = tdiv(sig / (sig + p) * (peak + p), peak)
        elif m == "mobius":
            sig = _mobius(sig, p, peak)

        scale = sig / sig_orig
        f = frame.clone_props()
        f.planes = [g * scale, b * scale, r * scale]
        return [f]
