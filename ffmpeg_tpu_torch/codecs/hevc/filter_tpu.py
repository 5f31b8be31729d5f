"""HEVC in-loop filters (deblock + SAO) on the decoder's device, in
PyTorch, bit-exact with the host filter.py (spec 8.7.2/8.7.3; reference
libavcodec/hevc/filter.c hevc_loop_filter_luma/chroma + sao_filter_CTB).

The port of ffmpeg_tpu/codecs/hevc/filter_tpu.py.  The whole picture
filters as a handful of dense int32 tensor ops, no per-edge Python
loop: vertical luma edges sit at x = 8k, so
`plane[:, 4 : 4 + 8*nE].reshape(H, nE, 8)` is the (p3..q3) slab of
every edge at once; decisions (d < beta, strong/weak, dSam) are
per-segment masks over an (H/4, nE) grid.  Horizontal edges run on a
transposed copy, after the vertical pass has finished: each pass
returns a fresh tensor and writes nothing it reads.  The parameter maps
are built on the host (`build_deblock_params`, `build_sao_params`,
numpy, as the reference's).

SAO reads its per-CTB tables by each pixel's CTB index (the band table
by CTB and band, the edge offsets by CTB and category) instead of
upsampling them to per-pixel maps as the reference's `_px_map` does
(a per-pixel band table is (H, W, 32) int32, 265 MB for 1080p luma);
the values are the same.  torch.roll wraps as jnp.roll does, and the
same masks exclude the wrapped samples.

`sharded_filters` splits both filters over a device mesh in equal tile
columns, with column halos between neighbours (parallel/mesh.ppermute);
`_sao_local` is the SAO of one column strip with its 1-px halos, which
the whole picture's SAO runs too, its halos the wrapped columns.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tables as T
from .recon import chroma_qp
from .recon_tpu import _const

# ---------------------------------------------------------------------------
# deblock


def _luma_edge_filter(slab, tc, beta, bd):
    """slab (S, 4, E, 8) int32: S 4-row segments x E edges, cols are
    p3..p0 q0..q3. tc/beta (S, E) int32 (already bit-depth scaled,
    0 = edge off). Returns the filtered slab."""
    pmax = (1 << bd) - 1
    p = slab[..., :4].flip(-1)                # p0..p3 at [...,0..3]
    q = slab[..., 4:]

    dp_r = (p[..., 2] - 2 * p[..., 1] + p[..., 0]).abs()
    dq_r = (q[..., 2] - 2 * q[..., 1] + q[..., 0]).abs()
    dp0, dp3 = dp_r[:, 0], dp_r[:, 3]         # (S, E)
    dq0, dq3 = dq_r[:, 0], dq_r[:, 3]
    d0 = dp0 + dq0
    d3 = dp3 + dq3
    on = (tc > 0) & (d0 + d3 < beta)          # (S, E)

    def dsam(i, d):
        return ((2 * d < (beta >> 2))
                & ((p[:, i, :, 3] - p[:, i, :, 0]).abs()
                   + (q[:, i, :, 0] - q[:, i, :, 3]).abs()
                   < (beta >> 3))
                & ((p[:, i, :, 0] - q[:, i, :, 0]).abs()
                   < ((5 * tc + 1) >> 1)))

    strong = on & dsam(0, d0) & dsam(3, d3)   # (S, E)

    # strong filter (8.7.2.5.7), per row
    tc2 = (2 * tc)[:, None, :]
    P0, P1, P2, P3 = (p[..., 0], p[..., 1], p[..., 2], p[..., 3])
    Q0, Q1, Q2, Q3 = (q[..., 0], q[..., 1], q[..., 2], q[..., 3])

    def cl(ref, v):
        return torch.minimum(torch.maximum(v, ref - tc2), ref + tc2)
    sp0 = cl(P0, (P2 + 2 * P1 + 2 * P0 + 2 * Q0 + Q1 + 4) >> 3)
    sp1 = cl(P1, (P2 + P1 + P0 + Q0 + 2) >> 2)
    sp2 = cl(P2, (2 * P3 + 3 * P2 + P1 + P0 + Q0 + 4) >> 3)
    sq0 = cl(Q0, (P1 + 2 * P0 + 2 * Q0 + 2 * Q1 + Q2 + 4) >> 3)
    sq1 = cl(Q1, (P0 + Q0 + Q1 + Q2 + 2) >> 2)
    sq2 = cl(Q2, (P0 + Q0 + Q1 + 3 * Q2 + 2 * Q3 + 4) >> 3)

    # weak filter (8.7.2.5.3), per row with per-segment side flags
    side = ((beta + (beta >> 1)) >> 3)
    filt_p = (dp0 + dp3 < side)[:, None, :]
    filt_q = (dq0 + dq3 < side)[:, None, :]
    delta = (9 * (Q0 - P0) - 3 * (Q1 - P1) + 8) >> 4
    wk_on = delta.abs() < (tc * 10)[:, None, :]
    tcb = tc[:, None, :]
    delta = torch.minimum(torch.maximum(delta, -tcb), tcb)
    wp0 = (P0 + delta).clamp(0, pmax)
    hb = tcb >> 1
    dp = torch.minimum(torch.maximum(
        (((P2 + P0 + 1) >> 1) - P1 + delta) >> 1, -hb), hb)
    wp1 = (P1 + dp).clamp(0, pmax)
    wq0 = (Q0 - delta).clamp(0, pmax)
    dq = torch.minimum(torch.maximum(
        (((Q2 + Q0 + 1) >> 1) - Q1 - delta) >> 1, -hb), hb)
    wq1 = (Q1 + dq).clamp(0, pmax)

    sb = strong[:, None, :]
    wb = (on & ~strong)[:, None, :] & wk_on
    np0 = torch.where(sb, sp0, torch.where(wb, wp0, P0))
    np1 = torch.where(sb, sp1, torch.where(wb & filt_p, wp1, P1))
    np2 = torch.where(sb, sp2, P2)
    nq0 = torch.where(sb, sq0, torch.where(wb, wq0, Q0))
    nq1 = torch.where(sb, sq1, torch.where(wb & filt_q, wq1, Q1))
    nq2 = torch.where(sb, sq2, Q2)
    return torch.stack([P3, np2, np1, np0, nq0, nq1, nq2, Q3], dim=-1)


def _luma_pass_v(plane, tcm, betam, bd):
    """All vertical luma edges. plane (H, W) int32; tcm/betam
    (H//4, W//8 - 1) for edges at x = 8, 16, ...  Returns a fresh
    plane."""
    H, W = plane.shape
    nE = W // 8 - 1
    if nE <= 0:
        return plane
    slab = plane[:, 4:4 + 8 * nE].reshape(H // 4, 4, nE, 8)
    out = _luma_edge_filter(slab, tcm, betam, bd)
    plane = plane.clone()
    plane[:, 4:4 + 8 * nE] = out.reshape(H, nE * 8)
    return plane


def _luma_pass_h(plane, tcm, betam, bd):
    """All horizontal luma edges, on a transposed copy."""
    return _luma_pass_v(plane.T.contiguous(), tcm, betam, bd).T.contiguous()


def _n_edges(W):
    """The edges at x = 8, 16, ... whose 8-sample slab lies inside a
    plane W wide.  A chroma plane is a multiple of 4 wide, not always of
    8 (540 rows at 1080p): the reference's `W // 8 - 1` drops the last
    edge there (x = 536), which its host filter filters."""
    return (W - 4) // 8


def _chroma_edge_filter(slab, tc, bd):
    """slab (S, 4, E, 4): p1 p0 q0 q1. tc (S, E) (0 = off)."""
    pmax = (1 << bd) - 1
    p1, p0 = slab[..., 0], slab[..., 1]
    q0, q1 = slab[..., 2], slab[..., 3]
    tcb = tc[:, None, :]
    delta = torch.minimum(torch.maximum(
        (((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tcb), tcb)
    on = (tc > 0)[:, None, :]
    np0 = torch.where(on, (p0 + delta).clamp(0, pmax), p0)
    nq0 = torch.where(on, (q0 - delta).clamp(0, pmax), q0)
    return torch.stack([p1, np0, nq0, q1], dim=-1)


def _chroma_pass_v(plane, tcm, bd):
    """Vertical chroma edges at x = 8k (chroma coords, 4:2:0 means
    16-luma grid). plane (Hc, Wc); tcm (Hc//4, Wc//8 - 1).  Returns a
    fresh plane."""
    H, W = plane.shape
    nE = _n_edges(W)
    if nE <= 0:
        return plane
    slab = plane[:, 4:4 + 8 * nE].reshape(H // 4, 4, nE, 8)
    out = _chroma_edge_filter(slab[..., 2:6], tcm, bd)
    slab = torch.cat([slab[..., :2], out, slab[..., 6:]], dim=-1)
    plane = plane.clone()
    plane[:, 4:4 + 8 * nE] = slab.reshape(H, nE * 8)
    return plane


def _chroma_pass_h(plane, tcm, bd):
    return _chroma_pass_v(plane.T.contiguous(), tcm, bd).T.contiguous()


def build_deblock_params(dec):
    """Host-side: per-edge tc/beta maps from the bs maps + slice
    params (everything data-independent of the pixels)."""
    sps, sh = dec.sps, dec.sh
    bd = sps.bit_depth
    bdsh = bd - 8
    W, H = sps.width, sps.height
    qp = dec.qp
    beta_t = np.asarray(T.BETA_TABLE, np.int32)
    tc_t = np.asarray(T.TC_TABLE, np.int32)

    bs_v = np.asarray(dec.bs_v)
    bs_h = np.asarray(dec.bs_h)
    if dec.pps.tiles_enabled and not dec.pps.loop_filter_across_tiles:
        bs_v = bs_v.copy()
        bs_h = bs_h.copy()
        for cb in dec.col_bd[1:-1]:
            bs_v[:, (cb << sps.log2_ctb) >> 2] = 0
        for rb in dec.row_bd[1:-1]:
            bs_h[(rb << sps.log2_ctb) >> 2, :] = 0

    def luma_maps(bs, nseg, nedge, col):
        # bs sampled at the edge, 4-sample granularity
        m = bs[:nseg * 1, col]                  # (nseg, nedge)
        beta = beta_t[np.clip(qp + sh.beta_offset, 0, 51)] << bdsh
        idxt = np.clip(qp + 2 * (m - 1) + sh.tc_offset, 0, 53)
        tc = np.where(m > 0, tc_t[idxt] << bdsh, 0).astype(np.int32)
        betam = np.where(tc > 0, beta, 0).astype(np.int32)
        return tc, betam

    # vertical luma: edges at x = 8(k+1), segments of 4 rows
    nEv = W // 8 - 1
    colv = (np.arange(nEv) * 8 + 8) >> 2
    tc_v, beta_v = luma_maps(bs_v, H // 4, nEv, colv)
    # horizontal luma (transposed plane): edges at y = 8(k+1)
    nEh = H // 8 - 1
    colh = (np.arange(nEh) * 8 + 8) >> 2
    tc_h, beta_h = luma_maps(bs_h.T, W // 4, nEh, colh)

    # chroma: edges on the 16-luma grid, bS == 2 only
    out_c = {}
    for c_idx in (1, 2):
        off = (dec.pps.cb_qp_offset + dec.sh.cb_qp_offset) if c_idx == 1 \
            else (dec.pps.cr_qp_offset + dec.sh.cr_qp_offset)
        qpc = chroma_qp(qp, off)
        tcc = int(tc_t[np.clip(qpc + 2 + sh.tc_offset, 0, 53)]) << bdsh
        nEcv = _n_edges(W // 2)
        colc = (np.arange(nEcv) * 16 + 16) >> 2        # luma cols
        m = bs_v[::2, :][:(H // 2) // 4, colc]          # luma rows 8k
        tc_cv = np.where(m == 2, tcc, 0).astype(np.int32)
        nEch = _n_edges(H // 2)
        rowc = (np.arange(nEch) * 16 + 16) >> 2
        m = bs_h.T[::2, :][:(W // 2) // 4, rowc]
        tc_ch = np.where(m == 2, tcc, 0).astype(np.int32)
        out_c[c_idx] = (tc_cv, tc_ch)
    return dict(tc_v=tc_v, beta_v=beta_v, tc_h=tc_h, beta_h=beta_h,
                chroma=out_c, bd=bd)


def _dev(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def deblock_frame_tpu(y, u, v, prm):
    """Device deblock: y/u/v int32 tensors on one device, prm from
    build_deblock_params (host maps, copied there). Returns filtered
    (y, u, v), fresh tensors."""
    bd = prm["bd"]
    dev = y.device
    y = _luma_pass_v(y, _dev(prm["tc_v"], dev), _dev(prm["beta_v"], dev), bd)
    y = _luma_pass_h(y, _dev(prm["tc_h"], dev), _dev(prm["beta_h"], dev), bd)
    tc_cv1, tc_ch1 = prm["chroma"][1]
    tc_cv2, tc_ch2 = prm["chroma"][2]
    u = _chroma_pass_v(u, _dev(tc_cv1, dev), bd)
    u = _chroma_pass_h(u, _dev(tc_ch1, dev), bd)
    v = _chroma_pass_v(v, _dev(tc_cv2, dev), bd)
    v = _chroma_pass_h(v, _dev(tc_ch2, dev), bd)
    return y, u, v


# ---------------------------------------------------------------------------
# SAO

_EO_NEIGH = ((0, -1, 0, 1), (-1, 0, 1, 0),
             (-1, -1, 1, 1), (-1, 1, 1, -1))


def build_sao_params(dec):
    """Host-side per-plane SAO parameter maps at CTB granularity."""
    sps, sh = dec.sps, dec.sh
    bd = sps.bit_depth
    osc = bd - min(bd, 10)
    out = []
    restrict = (dec.pps.tiles_enabled
                and not dec.pps.loop_filter_across_tiles)
    for c_idx in range(3):
        use = sh.sao_luma if c_idx == 0 else sh.sao_chroma
        ch, cw = sps.ctb_height, sps.ctb_width
        typ = np.asarray(dec.sao_type[:, :, c_idx], np.int32)
        if not use:
            typ = np.zeros_like(typ)
        eo = np.asarray(dec.sao_eo_class[:, :, c_idx], np.int32)
        offs = np.asarray(dec.sao_offset[:, :, c_idx], np.int32) << osc
        # band LUT per CTB: 32 entries
        lut = np.zeros((ch, cw, 32), np.int32)
        pos = np.asarray(dec.sao_band_pos[:, :, c_idx], np.int32)
        for i in range(4):
            np.put_along_axis(lut, ((pos + i) & 31)[..., None],
                              offs[:, :, i + 1:i + 2], axis=2)
        # tile bounds per CTB (component coords) for EO restriction
        shift = 0 if c_idx == 0 else 1
        Hc = sps.height >> shift
        Wc = sps.width >> shift
        lo_x = np.zeros((ch, cw), np.int32)
        hi_x = np.full((ch, cw), Wc - 1, np.int32)
        lo_y = np.zeros((ch, cw), np.int32)
        hi_y = np.full((ch, cw), Hc - 1, np.int32)
        if restrict:
            col_bd, row_bd = dec.col_bd, dec.row_bd
            for tc_i in range(len(col_bd) - 1):
                a, b = col_bd[tc_i], col_bd[tc_i + 1]
                lo_x[:, a:b] = (a << sps.log2_ctb) >> shift
                hi_x[:, a:b] = np.minimum(
                    ((b << sps.log2_ctb) >> shift) - 1, Wc - 1)
            for tr in range(len(row_bd) - 1):
                a, b = row_bd[tr], row_bd[tr + 1]
                lo_y[a:b, :] = (a << sps.log2_ctb) >> shift
                hi_y[a:b, :] = np.minimum(
                    ((b << sps.log2_ctb) >> shift) - 1, Hc - 1)
        out.append(dict(typ=typ, eo=eo, offs=offs, lut=lut,
                        lo_x=lo_x, hi_x=hi_x, lo_y=lo_y, hi_y=hi_y))
    return dict(planes=out, bd=bd, log2_ctb=sps.log2_ctb)


def _ctb_index(device, log2, shift, Hc, Wc, cw, x0=0):
    """Each pixel's CTB (raster index into maps cw CTBs wide), (Hc, Wc)
    int64 (component coords; x0 = the first column's offset into its
    CTB): what the reference's `_px_map` repeats the per-CTB maps by."""
    s = log2 - shift
    return _const(device, ("hevc_sao_ctb", s, Hc, Wc, cw, x0), lambda: (
        (np.arange(Hc)[:, None] >> s) * cw
        + ((np.arange(Wc)[None, :] + x0) >> s)))


def sao_plane_tpu(plane, p, log2_ctb, bd, shift):
    """One plane of SAO on device. plane int32 (Hc, Wc); p one entry of
    build_sao_params' planes (host maps).  Returns a fresh plane (the
    input itself where no CTB has SAO on)."""
    if not np.any(p["typ"]):
        return plane
    # torch.roll's wrap, as jnp.roll's: the masks exclude those samples
    return _sao_local(plane, plane[:, -1:], plane[:, :1], p, 0, log2_ctb,
                      bd, shift)


def sao_frame_tpu(y, u, v, prm):
    pl = prm["planes"]
    lc = prm["log2_ctb"]
    bd = prm["bd"]
    y = sao_plane_tpu(y, pl[0], lc, bd, 0)
    u = sao_plane_tpu(u, pl[1], lc, bd, 1)
    v = sao_plane_tpu(v, pl[2], lc, bd, 1)
    return y, u, v


def filters_tpu(dec, y, u, v, marks=None):
    """Deblock + SAO of one decoded picture on the device of its planes:
    y/u/v tensors (any integer type) on one device -> the filtered
    planes there, in the type they came in.  The host builds the
    parameter maps from dec (its bs, qp and SAO grids); no plane goes
    to the host.  marks: an optional callable, called with "deblock"
    and "sao" as each stage is queued."""
    dt = y.dtype
    y, u, v = (t.to(torch.int32) for t in (y, u, v))
    if marks is not None:
        marks("deblock")
    if not dec.sh.deblocking_disabled:
        y, u, v = deblock_frame_tpu(y, u, v, build_deblock_params(dec))
    if marks is not None:
        marks("sao")
    if dec.sps.sao_enabled and (dec.sh.sao_luma or dec.sh.sao_chroma):
        y, u, v = sao_frame_tpu(y, u, v, build_sao_params(dec))
    return y.to(dt), u.to(dt), v.to(dt)


# ---------------------------------------------------------------------------
# tile-column sharding across the mesh


def sharded_filters(dec, mesh, axis="spatial"):
    """Deblock + SAO with the picture sharded in equal tile columns over
    `mesh[axis]` (one tile column per device).  dec's planes (host
    arrays or tensors) go to the devices in column strips; returns the
    filtered (y, u, v) on the first strip's device, in the planes' type,
    bit-exact with filters_tpu.  Cross-shard traffic: the vertical-edge
    pass fetches the left neighbour's 8 (luma) / 4 (chroma) boundary
    columns and returns the 3 / 1 filtered p-side columns; edge SAO
    exchanges 1-px column halos.  With loop_filter_across_tiles=0 the
    boundary tc is zero and the halo contents are never used.

    Reference analog: tiles decoded by execute2 jobs + cross-tile
    deblock (hevcdec.c:1118); here the tiles live on different devices
    and the halos ride copies between them."""
    from ...parallel.mesh import axis_devices, ppermute, to_device

    sps = dec.sps
    devices = axis_devices(mesh, axis)
    ndev = len(devices)
    W = sps.width
    if W % (ndev * 16) or sps.ctb_width % ndev:
        raise ValueError("sharded_filters: width must split into "
                         "16px-aligned, whole-CTB equal columns")
    Ws = W // ndev
    bd = sps.bit_depth
    planes = [torch.as_tensor(p) for p in (dec.y, dec.u, dec.v)]
    dt = planes[0].dtype
    fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
    bwd = [((i + 1) % ndev, i) for i in range(ndev)]

    def split(a, axis=1):
        """a's ndev equal strips along `axis`, strip k on device k."""
        n = a.shape[axis] // ndev
        a = torch.as_tensor(a)
        return [to_device(a.narrow(axis, k * n, n), d)
                for k, d in enumerate(devices)]

    shards = [[s.to(torch.int32) for s in split(p)] for p in planes]

    def v_pass(pls, tcm, betam, halo, back):
        """One plane's vertical edges, strip by strip, each with its left
        neighbour's `halo` columns (zero-padded to 8, which keeps the
        passes' 8px edge grid); the boundary edge's `back` filtered
        p-side columns go home.  betam None: chroma."""
        left = ppermute([p[:, -halo:] for p in pls], fwd)
        out = []
        for k, (pl, lh) in enumerate(zip(pls, left)):
            ext = torch.cat([lh.new_zeros(lh.shape[0], 8 - halo), lh, pl],
                            dim=1)
            if betam is None:
                ext = _chroma_pass_v(ext, tcm[k], bd)
            else:
                ext = _luma_pass_v(ext, tcm[k], betam[k], bd)
            out.append(ext)
        # the boundary edge edits only p0..p2 (chroma: p0) of the halo;
        # merging more would clobber the strip's own q-side edits near
        # its right edge with stale halo copies
        home = ppermute([e[:, 8 - back:8] for e in out], bwd)
        return [torch.cat([e[:, 8:-back], h], dim=1) if k < ndev - 1
                else e[:, 8:] for k, (e, h) in enumerate(zip(out, home))]

    if not dec.sh.deblocking_disabled:
        dprm = build_deblock_params(dec)

        def edge_map(m, nedge):
            """(nseg, nedge - 1) map of the edges at x = 8(j+1) → one
            edge per 8px block (edge j at x = 8j, j = 0 zeroed), in
            strips on the devices."""
            out = np.zeros((m.shape[0], nedge), np.int32)
            out[:, 1:] = m
            return split(out)

        y, u, v = shards
        y = v_pass(y, edge_map(dprm["tc_v"], W // 8),
                   edge_map(dprm["beta_v"], W // 8), 8, 3)
        y = [_luma_pass_h(p, t, b, bd) for p, t, b in
             zip(y, split(dprm["tc_h"], 0), split(dprm["beta_h"], 0))]
        uv = []
        for pls, (tcv, tch) in zip((u, v), (dprm["chroma"][1],
                                            dprm["chroma"][2])):
            pls = v_pass(pls, edge_map(tcv, W // 16), None, 4, 1)
            uv.append([_chroma_pass_h(p, t, bd)
                       for p, t in zip(pls, split(tch, 0))])
        shards = [y] + uv
    if dec.sps.sao_enabled and (dec.sh.sao_luma or dec.sh.sao_chroma):
        sprm = build_sao_params(dec)
        lc = sprm["log2_ctb"]
        for c_idx, pls in enumerate(shards):
            shift = 0 if c_idx == 0 else 1
            p = sprm["planes"][c_idx]
            l1 = ppermute([q[:, -1:] for q in pls], fwd)
            r1 = ppermute([q[:, :1] for q in pls], bwd)
            out = []
            for k, pl in enumerate(pls):
                # the strip's CTB columns, from the one of its first pixel
                c0 = (k * Ws) >> lc
                c1 = (((k + 1) * Ws - 1) >> lc) + 1
                pk = {name: a[:, c0:c1] for name, a in p.items()}
                out.append(pl if not np.any(pk["typ"]) else _sao_local(
                    pl, l1[k], r1[k], pk, (k * Ws) >> shift, lc, bd, shift,
                    c0))
            shards[c_idx] = out
    return tuple(torch.cat([to_device(s, devices[0]) for s in pls],
                           dim=1).to(dt) for pls in shards)


def _sao_local(pl, l1, r1, p, xs0, log2_ctb, bd, shift, c0=0):
    """SAO for one column strip pl int32 (Hc, Wc) with its 1-px halos
    l1, r1 (Hc, 1): p holds the per-CTB maps of the strip's CTB columns,
    the first being CTB column c0; xs0 is the strip's first column in
    the picture (component coords), for the tile-bound masks.  Each
    pixel reads its CTB's values by its CTB index, as sao_plane_tpu
    does (no per-pixel copy of the maps)."""
    Hc, Wc = pl.shape
    dev = pl.device
    cw = p["typ"].shape[1]
    pmax = (1 << bd) - 1
    ctb = _ctb_index(dev, log2_ctb, shift, Hc, Wc, cw,
                     xs0 - (c0 << (log2_ctb - shift)))

    def px(name):
        return _dev(p[name], dev).reshape(-1)[ctb]
    typ = px("typ")
    # band offset: the CTB's band table at the sample's band
    band = pl >> (bd - 5)
    lut = _dev(p["lut"], dev).reshape(-1)
    band_out = (pl + lut[ctb * 32 + band]).clamp(0, pmax)
    # edge offset
    eo = px("eo")
    offs = _dev(p["offs"], dev).reshape(-1)
    ys = _const(dev, ("hevc_sao_ys", Hc), lambda: np.arange(
        Hc, dtype=np.int32)[:, None])
    xs = _const(dev, ("hevc_sao_xs", Wc, xs0), lambda: np.arange(
        xs0, xs0 + Wc, dtype=np.int32)[None, :])
    lo_x, hi_x, lo_y, hi_y = px("lo_x"), px("hi_x"), px("lo_y"), px("hi_y")
    ext = torch.cat([l1, pl, r1], dim=1)
    ok_any = torch.zeros_like(pl, dtype=torch.bool)
    cat_val = torch.zeros_like(pl)
    for cls, (ady, adx, bdy, bdx) in enumerate(_EO_NEIGH):
        a = torch.roll(ext, (-ady, -adx), (0, 1))[:, 1:-1]
        b = torch.roll(ext, (-bdy, -bdx), (0, 1))[:, 1:-1]
        okc = ((ys + min(ady, bdy) >= lo_y)
               & (ys + max(ady, bdy) <= hi_y)
               & (xs + min(adx, bdx) >= lo_x)
               & (xs + max(adx, bdx) <= hi_x))
        edge = 2 + torch.sign(pl - a) + torch.sign(pl - b)
        cat = torch.where(edge == 2, 0,
                          torch.where(edge < 2, edge + 1, edge))
        val = offs[ctb * 5 + cat]
        sel = (eo == cls) & okc
        ok_any = ok_any | sel
        cat_val = torch.where(sel, val, cat_val)
    edge_out = torch.where(ok_any, (pl + cat_val).clamp(0, pmax), pl)
    return torch.where(typ == 1, band_out,
                       torch.where(typ == 2, edge_out, pl))
