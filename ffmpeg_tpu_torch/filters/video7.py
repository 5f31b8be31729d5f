"""colorspace filter (counterpart of ffmpeg_tpu/filters/video7.py): YUV
colorspace conversion (vf_colorspace.c behavior in float: YUV -> RGB (input matrix/range) -> linearize
(input transfer) -> gamut matrix through XYZ when primaries differ
-> delinearize (output transfer) -> RGB -> YUV (output matrix/range).
The reference runs the same chain in 15-bit fixed point; outputs
agree to within a couple of LSBs.  The tables and matrices are the
port's own copies, built on the host in float64; the planes are
converted in float64 on their device, as the reference in numpy."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.frame import Frame
from ..formats import pixfmt as _pf
from ..utils.error import InvalidData
from ..utils.options import opt_str
from .base import (Filter, _tensor_planes, as_f64, register_filter, tdiv,
                   to_dtype)

# luma coefficients per colorspace (csp.c)
_CSP_COEFFS = {
    "bt709": (0.2126, 0.7152, 0.0722),
    "bt470bg": (0.299, 0.587, 0.114),
    "smpte170m": (0.299, 0.587, 0.114),
    "bt601-6-525": (0.299, 0.587, 0.114),
    "bt601-6-625": (0.299, 0.587, 0.114),
    "smpte240m": (0.212, 0.701, 0.087),
    "bt2020nc": (0.2627, 0.6780, 0.0593),
    "bt2020ncl": (0.2627, 0.6780, 0.0593),
}

# transfer characteristics: (alpha, beta, gamma, delta)
# (vf_colorspace.c:178)
_TRC = {
    "bt709": (1.099, 0.018, 0.45, 4.5),
    "smpte170m": (1.099, 0.018, 0.45, 4.5),
    "bt601-6-525": (1.099, 0.018, 0.45, 4.5),
    "bt601-6-625": (1.099, 0.018, 0.45, 4.5),
    "srgb": (1.055, 0.0031308, 1.0 / 2.4, 12.92),
    "iec61966-2-1": (1.055, 0.0031308, 1.0 / 2.4, 12.92),
    "iec61966-2-4": (1.099, 0.018, 0.45, 4.5),
    "bt2020-10": (1.099, 0.018, 0.45, 4.5),
    "bt2020-12": (1.0993, 0.0181, 0.45, 4.5),
    "smpte240m": (1.1115, 0.0228, 0.45, 4.0),
    "linear": (1.0, 0.0, 1.0, 0.0),
}

# primaries: (xr, yr, xg, yg, xb, yb); white point D65
_PRIMARIES = {
    "bt709": (0.640, 0.330, 0.300, 0.600, 0.150, 0.060),
    "bt470bg": (0.640, 0.330, 0.290, 0.600, 0.150, 0.060),
    "smpte170m": (0.630, 0.340, 0.310, 0.595, 0.155, 0.070),
    "bt601-6-525": (0.630, 0.340, 0.310, 0.595, 0.155, 0.070),
    "bt601-6-625": (0.640, 0.330, 0.290, 0.600, 0.150, 0.060),
    "smpte240m": (0.630, 0.340, 0.310, 0.595, 0.155, 0.070),
    "bt2020": (0.708, 0.292, 0.170, 0.797, 0.131, 0.046),
}
_WP_D65 = (0.3127, 0.3290)

_SPACE_ALIASES = {
    "bt601-6-525": "smpte170m",
}


def _rgb2xyz(prim):
    xr, yr, xg, yg, xb, yb = prim
    wx, wy = _WP_D65
    xyz = np.array([[xr / yr, xg / yg, xb / yb],
                    [1.0, 1.0, 1.0],
                    [(1 - xr - yr) / yr, (1 - xg - yg) / yg,
                     (1 - xb - yb) / yb]])
    w = np.array([wx / wy, 1.0, (1 - wx - wy) / wy])
    s = np.linalg.solve(xyz, w)
    return xyz * s[None, :]


def _yuv2rgb_matrix(coeffs):
    kr, kg, kb = coeffs
    return np.array([
        [1.0, 0.0, 2 * (1 - kr)],
        [1.0, -2 * (1 - kb) * kb / kg, -2 * (1 - kr) * kr / kg],
        [1.0, 2 * (1 - kb), 0.0]])


# the reference's 15-bit LUT covers v in [-2048, 30719]/28672 and
# clamps results to int16/28672 (fill_gamma_table, vf_colorspace.c)
_LUT_LO = -2048.0 / 28672.0
_LUT_HI = 30719.0 / 28672.0
_I16_HI = 32767.0 / 28672.0


def _linearize(v, trc):
    """fill_gamma_table's linearize branch structure, including its
    negative-tail formula."""
    a, b, g, d = trc
    v = torch.clamp(v, _LUT_LO, _LUT_HI)
    neg = v <= -b * d
    mid = v.abs() < b * d
    out = torch.pow(torch.clamp(tdiv(v + a - 1.0, a), min=1e-12), 1.0 / g)
    out = torch.where(mid, tdiv(v, d) if d else v, out)
    out = torch.where(neg, -torch.pow(
        torch.clamp(tdiv(1.0 - a - v, a), min=1e-12), 1.0 / g), out)
    return torch.clamp(out, -_I16_HI, _I16_HI)


def _delinearize(v, trc):
    a, b, g, d = trc
    v = torch.clamp(v, _LUT_LO, _LUT_HI)
    neg = v <= -b
    mid = v.abs() < b
    out = a * torch.pow(torch.clamp(v, min=1e-12), g) - (a - 1.0)
    out = torch.where(mid, v * d, out)
    out = torch.where(neg, -a * torch.pow(torch.clamp(-v, min=1e-12), g)
                      + (a - 1.0), out)
    return torch.clamp(out, -_I16_HI, _I16_HI)


def _mix(m: np.ndarray, x: List[torch.Tensor]) -> List[torch.Tensor]:
    """np.einsum("ij,jhw->ihw", m, x): each output the sum over j of
    m[i, j] * x[j], in j's order."""
    out = []
    for i in range(3):
        acc = None
        for j in range(3):
            t = float(m[i, j]) * x[j]
            acc = t if acc is None else acc + t
        out.append(acc)
    return out


@register_filter
class ColorspaceFilter(Filter):
    name = "colorspace"
    description = "convert between colorspaces"
    media_type = "video"
    OPTIONS = (
        opt_str("all", default=""),
        opt_str("space", default=""),
        opt_str("trc", default=""),
        opt_str("primaries", default=""),
        opt_str("range", default="tv"),
        opt_str("iall", default=""),
        opt_str("ispace", default=""),
        opt_str("itrc", default=""),
        opt_str("iprimaries", default=""),
        opt_str("irange", default="tv"),
        opt_str("fast", default="0"),
    )

    _ALL = {
        "bt709": ("bt709", "bt709", "bt709"),
        "bt601-6-525": ("smpte170m", "smpte170m", "smpte170m"),
        "bt601-6-625": ("bt470bg", "bt709", "bt470bg"),
        "smpte170m": ("smpte170m", "smpte170m", "smpte170m"),
        "bt470bg": ("bt470bg", "bt709", "bt470bg"),
        "bt2020": ("bt2020nc", "bt2020-10", "bt2020"),
    }

    def _resolve(self, allv, space, trc, prim):
        if allv:
            s, t, p = self._ALL.get(allv, (allv, allv, allv))
            return space or s, trc or t, prim or p
        return space, trc, prim

    def process(self, frame: Optional[Frame],
                pad: int = 0) -> List[Frame]:
        if frame is None:
            return []
        ispace, itrc, iprim = self._resolve(
            str(self.iall), str(self.ispace), str(self.itrc),
            str(self.iprimaries))
        ospace, otrc, oprim = self._resolve(
            str(self.all), str(self.space), str(self.trc),
            str(self.primaries))
        ispace = ispace or getattr(frame, "color_space", "") \
            or "bt709"
        itrc = itrc or "bt709"
        iprim = iprim or "bt709"
        if not ospace:
            raise InvalidData("colorspace: no output space")
        if ispace not in _CSP_COEFFS or ospace not in _CSP_COEFFS:
            raise InvalidData("colorspace: unsupported space")

        desc = _pf.get(frame.format)
        depth = desc.comp[0].depth
        full_in = str(self.irange) in ("pc", "jpeg", "full")
        full_out = str(self.range) in ("pc", "jpeg", "full")
        maxv = (1 << depth) - 1

        ps = _tensor_planes(frame.planes)
        y, u, v = (as_f64(p) for p in ps[:3])
        # upsample chroma to luma grid (nearest, like the
        # reference's unscaled path requires 4:4:4 — we accept 4:2:0
        # by nearest up/down sampling)
        cw = 1 << desc.log2_chroma_w
        ch = 1 << desc.log2_chroma_h
        if cw > 1 or ch > 1:
            u = u.repeat_interleave(ch, 0).repeat_interleave(cw, 1)[
                :y.shape[0], :y.shape[1]]
            v = v.repeat_interleave(ch, 0).repeat_interleave(cw, 1)[
                :y.shape[0], :y.shape[1]]

        if full_in:
            yn = tdiv(y, maxv)
            un = tdiv(u - (1 << (depth - 1)), maxv)
            vn = tdiv(v - (1 << (depth - 1)), maxv)
        else:
            yn = tdiv(y - (16 << (depth - 8)), 219 << (depth - 8))
            un = tdiv(u - (1 << (depth - 1)), 224 << (depth - 8))
            vn = tdiv(v - (1 << (depth - 1)), 224 << (depth - 8))

        m_in = _yuv2rgb_matrix(_CSP_COEFFS[ispace])
        rgb = _mix(m_in, [yn, un, vn])

        if iprim != oprim or itrc != otrc:
            lin = [_linearize(c, _TRC[itrc]) for c in rgb]
            if iprim != oprim:
                gamut = np.linalg.inv(_rgb2xyz(_PRIMARIES[oprim])) \
                    @ _rgb2xyz(_PRIMARIES[iprim])
                lin = _mix(gamut, lin)
            rgb = [_delinearize(c, _TRC[otrc]) for c in lin]

        m_out = np.linalg.inv(_yuv2rgb_matrix(_CSP_COEFFS[ospace]))
        yuv = _mix(m_out, rgb)
        if full_out:
            yo = yuv[0] * maxv
            uo = yuv[1] * maxv + (1 << (depth - 1))
            vo = yuv[2] * maxv + (1 << (depth - 1))
        else:
            yo = yuv[0] * (219 << (depth - 8)) + (16 << (depth - 8))
            uo = yuv[1] * (224 << (depth - 8)) + (1 << (depth - 1))
            vo = yuv[2] * (224 << (depth - 8)) + (1 << (depth - 1))

        dt = ps[0].dtype if depth > 8 and ps[0].dtype == torch.int16 \
            else torch.uint8 if depth <= 8 else torch.uint16

        def q(p):
            return to_dtype(torch.clamp(torch.round(p), 0, maxv), dt)

        if cw > 1 or ch > 1:
            # subsample chroma by box-averaging the full-res chroma
            # (the reference's rgb2yuv computes block chroma from the
            # averaged RGB quad — identical since the matrix is
            # linear); partial blocks at odd sizes are dropped, as in
            # the reference
            hh = uo.shape[0] // ch * ch
            ww = uo.shape[1] // cw * cw
            uo = uo[:hh, :ww].reshape(hh // ch, ch, ww // cw, cw) \
                .mean(dim=(1, 3))
            vo = vo[:hh, :ww].reshape(hh // ch, ch, ww // cw, cw) \
                .mean(dim=(1, 3))
        f = frame.clone_props()
        f.planes = [q(yo), q(uo), q(vo)]
        f.color_space = _SPACE_ALIASES.get(ospace, ospace)
        f.color_trc = otrc
        f.color_primaries = oprim
        return [f]
