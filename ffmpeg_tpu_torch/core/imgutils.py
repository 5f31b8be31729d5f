"""Image plane geometry + generic (un)packing, driven by pixfmt descriptors
(the port's copy of ffmpeg_tpu/core/imgutils.py).

Analog of libavutil/imgutils.{c,h} (plane size math) plus the generic
read/write paths of pixdesc.c (av_read_image_line / av_write_image_line),
vectorized with numpy instead of per-pixel loops. This is the host-side I/O
boundary: every on-disk/in-container image converts to a list of per-
component numpy arrays shaped (h_c, w_c), which Frame.from_bytes then moves
to the device (batched to (N, h_c, w_c) there).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..formats import pixfmt as _pf
from ..formats.pixfmt import FLAG_BITSTREAM, PixFmtDescriptor
from ..utils.error import InvalidData


def component_dims(desc: PixFmtDescriptor, comp_idx: int, width: int, height: int):
    """Sample-grid dims of component comp_idx."""
    if comp_idx in (1, 2) and not desc.is_rgb and desc.nb_components >= 3:
        return desc.chroma_dims(width, height)
    return width, height


def plane_linesize(desc: PixFmtDescriptor, plane: int, width: int) -> int:
    """Bytes per row of `plane` (av_image_fill_linesizes semantics)."""
    best = 0
    for i, c in enumerate(desc.comp):
        if c.plane != plane:
            continue
        w_c, _ = component_dims(desc, i, width, 1)
        if desc.flags & FLAG_BITSTREAM:
            best = max(best, (w_c * c.step + 7) // 8)
        else:
            best = max(best, w_c * c.step)
    if best == 0:
        raise InvalidData(f"format {desc.name} has no components on plane {plane}")
    return best


def plane_height(desc: PixFmtDescriptor, plane: int, height: int) -> int:
    for i, c in enumerate(desc.comp):
        if c.plane == plane:
            _, h_c = component_dims(desc, i, 1, height)
            return h_c
    raise InvalidData(f"no component on plane {plane}")


def image_buffer_size(fmt, width: int, height: int) -> int:
    desc = _pf.get(fmt)
    return sum(
        plane_linesize(desc, p, width) * plane_height(desc, p, height)
        for p in range(desc.nb_planes)
    )


def _itemsize(depth: int) -> int:
    return 1 if depth <= 8 else (2 if depth <= 16 else 4)


def unpack(buf, fmt, width: int, height: int,
           linesizes: Optional[Sequence[int]] = None) -> List[np.ndarray]:
    """Raw picture bytes → list of per-component arrays (h_c, w_c).

    Components come back in canonical order (Y,U,V[,A] / R,G,B[,A]) in their
    native integer dtype with values already shifted+masked to [0, 2^depth).
    """
    desc = _pf.get(fmt)
    data = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else buf.reshape(-1).view(np.uint8)

    # slice the flat buffer into per-plane row-major views
    planes_raw: List[np.ndarray] = []
    off = 0
    for p in range(desc.nb_planes):
        ls = linesizes[p] if linesizes else plane_linesize(desc, p, width)
        h_p = plane_height(desc, p, height)
        planes_raw.append(data[off:off + ls * h_p].reshape(h_p, ls))
        off += ls * h_p

    out: List[np.ndarray] = []
    for i, c in enumerate(desc.comp):
        w_c, h_c = component_dims(desc, i, width, height)
        raw = planes_raw[c.plane]
        if desc.flags & FLAG_BITSTREAM:
            bits = np.unpackbits(raw, axis=1)[:, :w_c]
            if desc.name == "monow":  # 1 = white already; monob inverts sense
                out.append(bits.astype(np.uint8))
            else:
                out.append(bits.astype(np.uint8))
            continue
        itemsize = _itemsize(c.depth + c.shift)
        # gather itemsize bytes at (offset + k*step) for k in [0, w_c)
        grp = raw[:h_c, : w_c * c.step].reshape(h_c, w_c, c.step)
        unit = grp[:, :, c.offset:c.offset + itemsize]
        if itemsize == 1:
            vals = unit[:, :, 0].astype(np.uint8)
        else:
            dt = np.dtype(f"{'>' if desc.is_be else '<'}u{itemsize}")
            vals = np.ascontiguousarray(unit).view(dt)[:, :, 0]
            vals = vals.astype(np.uint16 if itemsize == 2 else np.uint32)
        if c.shift:
            vals = (vals >> c.shift).astype(vals.dtype)
        if c.depth < itemsize * 8:
            vals = vals & ((1 << c.depth) - 1)
        if desc.is_float:
            fdt = np.float32 if c.depth == 32 else np.float16
            vals = np.ascontiguousarray(vals).view(fdt).astype(np.float32)
        out.append(vals)
    return out


def pack(components: Sequence[np.ndarray], fmt, width: int, height: int) -> bytes:
    """Inverse of unpack: per-component arrays → raw picture bytes."""
    desc = _pf.get(fmt)
    bufs: List[np.ndarray] = []
    for p in range(desc.nb_planes):
        ls = plane_linesize(desc, p, width)
        h_p = plane_height(desc, p, height)
        bufs.append(np.zeros((h_p, ls), np.uint8))

    # planes where components share a storage unit (rgb565, p010...) must be
    # OR-combined rather than byte-assigned
    shared_unit_planes = {c.plane for c in desc.comp if c.shift}

    for i, c in enumerate(desc.comp):
        w_c, h_c = component_dims(desc, i, width, height)
        vals = np.asarray(components[i])
        if vals.shape != (h_c, w_c):
            raise InvalidData(
                f"component {i} of {desc.name}: expected {(h_c, w_c)}, got {vals.shape}")
        raw = bufs[c.plane]
        if desc.flags & FLAG_BITSTREAM:
            padded = np.zeros((h_c, raw.shape[1] * 8), np.uint8)
            padded[:, :w_c] = vals & 1
            raw[:] = np.packbits(padded, axis=1)
            continue
        if desc.is_float:
            src_f = vals.astype(np.float32 if c.depth == 32 else np.float16)
            vals = src_f.view(np.uint32 if c.depth == 32 else np.uint16)
        itemsize = _itemsize(c.depth + c.shift)
        v = vals.astype(np.uint32) & ((1 << c.depth) - 1)
        if c.shift:
            v = v << c.shift
        dt = np.dtype(f"{'>' if desc.is_be else '<'}u{itemsize}")
        unit_bytes = v.astype(dt).view(np.uint8).reshape(h_c, w_c, itemsize)
        grp = raw[:h_c, : w_c * c.step].reshape(h_c, w_c, c.step)
        tgt = grp[:, :, c.offset:c.offset + itemsize]
        if c.plane in shared_unit_planes:
            np.bitwise_or(tgt, unit_bytes, out=tgt)
        else:
            tgt[:] = unit_bytes
    return b"".join(b.tobytes() for b in bufs)


def fill_black(fmt, width: int, height: int, limited_range: bool = True) -> List[np.ndarray]:
    """Per-component black frame (av_image_fill_black analog)."""
    desc = _pf.get(fmt)
    out = []
    for i, c in enumerate(desc.comp):
        w_c, h_c = component_dims(desc, i, width, height)
        dt = desc.component_dtype()
        if desc.is_rgb or desc.nb_components < 3:
            v = 0 if not limited_range or desc.is_rgb else 16 << (c.depth - 8) if c.depth >= 8 else 0
        else:
            if i == 0:
                v = (16 << (c.depth - 8)) if limited_range and c.depth >= 8 else 0
            elif i in (1, 2):
                v = 1 << (c.depth - 1)
            else:
                v = (1 << c.depth) - 1  # alpha opaque
        out.append(np.full((h_c, w_c), v, dt))
    return out
