"""The port's twins of `__graft_entry__.entry()` and
`__graft_entry__.dryrun_multichip()`.

entry(): the forward step of the host-entropy flagship (batched MJPEG
decode-transform + scale→RGB) at the reference's small spec, 256x192 →
128x128, batch 2, inputs from `example_args` with seed 0.

    fn, args = entry()            # args on the card
    planes = fn(*args)            # three (2, 128, 128) uint8 tensors

dryrun_multichip(n): the same pipeline step and the multi-device legs
over an n-position mesh (parallel/mesh.py), each on tiny shapes and each
checked against its unsharded counterpart in the port:
  (i)   decode→scale over ('data', 'spatial'): frames data-parallel,
        block rows spatially, rows all-gathered before the vertical
        resize, each position computing its own output rows;
  (ii)  the audio FIR, batch-sharded over 'data';
  (iii) parallel/halo.sharded_deblock, rows over n positions;
  (iv)  codecs/vp9/lf_sharded, two superblocks per shard;
  (v)   codecs/hevc/filter_tpu.sharded_filters, one tile column each.
Every position is `device` (n × cuda:0 on a one-card machine).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.mjpeg_pipeline import (DecodeScaleSpec, build_decode_scale,
                                    example_args, plane_dims,
                                    reconstruct_planes, scale_ops)

SPEC = DecodeScaleSpec(width=256, height=192, out_w=128, out_h=128)
BATCH = 2
# the decode→scale leg: within 1 LSB of the unsharded step on at most
# this share of its samples (the row-sliced matmuls may sum in another
# order)
DRYRUN_LSB_SHARE = 1e-3
# the seed of the audio leg's input (audio_input)
AUDIO_SEED = 20


def entry(device: torch.device | str = "cuda"):
    """(fn, args): the step function and its example arguments as tensors
    on `device`."""
    fn = build_decode_scale(SPEC)
    args = tuple(torch.as_tensor(a, device=device)
                 for a in example_args(SPEC, batch=BATCH))
    return fn, args


def _split_at_vertical_resize(ops):
    """(before, resize, after): the op list around its first vertical
    resize, the only op that mixes rows; raises unless every other op
    works row by row."""
    from .scale.ops import FromFloat, ResizeAxis
    i = next(k for k, op in enumerate(ops)
             if isinstance(op, ResizeAxis) and op.axis == -2)
    rest = ops[:i] + ops[i + 1:]
    if any((isinstance(op, ResizeAxis) and op.axis == -2)
           or (isinstance(op, FromFloat) and op.dither) for op in rest):
        raise ValueError("the scale ops do not split into row strips")
    return ops[:i], ops[i], ops[i + 1:]


def decode_scale_sharded(spec: DecodeScaleSpec, mesh, args):
    """build_decode_scale's step over a ('data', 'spatial') mesh: frames
    over 'data', block rows over 'spatial'.  Each position reconstructs
    its block rows; the rows are all-gathered over 'spatial' before the
    vertical resize, and each position computes its own output rows by
    its rows of the resize matrices.  args as example_args; returns the
    output planes, gathered."""
    from .parallel.mesh import (ShardedTensor, Sharding, put, replicated,
                                to_device)
    from .scale.ops import ResizeAxis, compile_ops

    S = mesh.shape["spatial"]
    coeff_sh = Sharding(mesh, ("data", "spatial", None, None))
    cy, cu, cv = (put(a, coeff_sh) for a in args[:3])
    ql, qc = (put(a, replicated(mesh)) for a in args[3:])
    before, vresize, after = _split_at_vertical_resize(scale_ops(spec))
    before, after = compile_ops(before), compile_ops(after)
    (h_l, _), (ch_l, _) = plane_dims(spec)
    s8 = 8 // spec.lowres
    ly, lc = cy.shape[1] // S * s8, cu.shape[1] // S * s8
    oh = spec.out_h // S

    local = {}
    for pos in cy.shards:
        s = pos[1]
        rows = (min(ly, h_l - s * ly), min(lc, ch_l - s * lc))
        local[pos] = before(reconstruct_planes(
            spec, cy.shards[pos], cu.shards[pos], cv.shards[pos],
            ql.shards[pos], qc.shards[pos], rows))
    out = {}
    for pos, comps in local.items():
        dev = comps[0].device
        whole = [torch.cat([to_device(local[(pos[0], j)][c], dev)
                            for j in range(S)], dim=-2)
                 for c in range(len(comps))]
        mine = ResizeAxis(-2, tuple(
            None if m is None else m[pos[1] * oh:(pos[1] + 1) * oh]
            for m in vresize.matrices))
        out[pos] = after(mine.apply(whole))
    sharding = Sharding(mesh, ("data", "spatial", None))
    return [ShardedTensor({p: o[c] for p, o in out.items()}, sharding,
                          (cy.shape[0], spec.out_h, o0.shape[-1])).gather()
            for c, o0 in enumerate(next(iter(out.values())))]


def audio_input(batch: int) -> np.ndarray:
    """The audio leg's (batch, 1024) float32 input, made from AUDIO_SEED."""
    rng = np.random.default_rng(AUDIO_SEED)
    return rng.standard_normal((batch, 1024)).astype(np.float32)


def _audio_step(x: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """48k→16k polyphase FIR as a windowed product: (B, 1024) → (B, m);
    the taps summed in a fixed order, so a shard's rows equal the whole
    batch's."""
    idx = (torch.arange(0, 1024 - 16, 3)[:, None]
           + torch.arange(16)[None, :]).to(x.device)
    win = x[:, idx]                                   # (B, m, taps)
    m = win.shape[1]
    w = bank[torch.arange(m, device=x.device) % 3]   # (m, taps)
    acc = win[..., 0] * w[:, 0]
    for t in range(1, 16):
        acc = acc + win[..., t] * w[:, t]
    return acc


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda"):
    """The five multi-device legs over n_devices positions of `device`,
    each checked against its unsharded counterpart; raises on a
    mismatch.  Returns each leg's sharded output, gathered: {"decode_scale":
    [y, u, v] or [r, g, b] planes, "audio" (on audio_input(2 × data)),
    "deblock", "vp9": (y, u, v), "hevc": (y, u, v)}, and
    "decode_scale_diff": the decode→scale leg's {"differ", "samples",
    "max"} against the unsharded step, over its three planes."""
    # The reference's _provision_devices (a virtual CPU platform for XLA)
    # has no counterpart: the mesh is n positions of `device`.
    from .parallel.mesh import Mesh, ShardedTensor, Sharding, make_mesh, put
    from .parallel.halo import sharded_deblock
    from .ops.deblock import deblock_plane
    from .codecs.vp9.lf_sharded import make_sharded_lf
    from .codecs.vp9.lf_tpu import _luts, loopfilter_planes
    from .codecs.hevc import params as HP
    from .codecs.hevc.ctu import FrameDec
    from .codecs.hevc.filter_tpu import filters_tpu, sharded_filters
    from .resample.fir import build_filter_bank

    device = torch.device(device)
    devices = [device] * n_devices
    spatial = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(n_devices, spatial=spatial, devices=devices)
    data = mesh.shape["data"]
    legs = {}

    # (i) decode→scale
    spec = DecodeScaleSpec(width=128, height=96, out_w=64, out_h=64)
    batch = data * 2
    args = example_args(spec, batch=batch)
    outs = decode_scale_sharded(spec, mesh, args)
    want = build_decode_scale(spec)(
        *(torch.as_tensor(a, device=device) for a in args))
    for o in outs:
        _require(o.shape == (batch, spec.out_h, spec.out_w),
                 f"decode_scale shape {tuple(o.shape)}")
    d = torch.cat([(o.to(torch.int32) - w.to(torch.int32)).abs().flatten()
                   for o, w in zip(outs, want)])
    diff = {"differ": int((d > 0).sum()), "samples": d.numel(),
            "max": int(d.max())}
    _require(diff["max"] <= 1
             and diff["differ"] <= DRYRUN_LSB_SHARE * diff["samples"],
             f"decode_scale: {diff['differ']} of {diff['samples']} samples "
             f"differ, by up to {diff['max']}")
    legs["decode_scale"] = outs
    legs["decode_scale_diff"] = diff

    # (ii) audio: the polyphase FIR, batch-sharded over 'data'
    bank = torch.as_tensor(build_filter_bank(16, 3, 0.3), dtype=torch.float32,
                           device=device)
    x = audio_input(batch)
    xs = put(x, Sharding(mesh, ("data", None)))
    ys = {p: _audio_step(s, bank) for p, s in xs.shards.items()}
    y = ShardedTensor(ys, xs.sharding, (batch, ys[(0, 0)].shape[1])).gather()
    _require(torch.equal(y, _audio_step(torch.as_tensor(x, device=device),
                                        bank)), "audio FIR")
    legs["audio"] = y

    # (iii) row-sharded deblock with halo exchange
    smesh = make_mesh(n_devices, spatial=n_devices, devices=devices)
    plane = torch.as_tensor(np.arange(n_devices * 16 * 64, dtype=np.uint8)
                            .reshape(n_devices * 16, 64), device=device)
    out = sharded_deblock(plane, smesh, qp=36)
    _require(torch.equal(out, deblock_plane(plane, qp=36)), "sharded_deblock")
    legs["deblock"] = out

    # (iv) VP9: the column-sharded pipelined loop filter, 2 SBs a shard
    rng = np.random.default_rng(0)
    vmesh = Mesh(devices, ("spatial",))
    sb_rows, sb_cols = 1, 2 * n_devices
    wp, hp = sb_cols * 64, sb_rows * 64
    dims = (wp >> 2, hp >> 2, wp >> 3, hp >> 3)
    lf = make_sharded_lf(vmesh, sb_rows, sb_cols // n_devices, dims)
    yp = rng.integers(0, 256, (hp, wp)).astype(np.int32)
    up = rng.integers(0, 256, (hp // 2, wp // 2)).astype(np.int32)
    wd_y = np.full((sb_rows * 16, sb_cols * 16), 4, np.int32)
    wd_c = np.full((sb_rows * 8, sb_cols * 8), 4, np.int32)
    lvl8 = np.full((sb_rows * 8, sb_cols * 8), 24, np.int32)
    lim, mblim = _luts(0)

    def padr(a):
        return torch.as_tensor(np.pad(a, ((8, 8), (0, 0))), device=device)
    got = lf(padr(yp), padr(up), padr(up), wd_y, wd_y, wd_c, wd_c, lvl8,
             lim, mblim)
    want = loopfilter_planes((yp, up, up), (wd_y, wd_y, wd_c, wd_c), lvl8,
                             lim, mblim, dims, device)
    _require(all(torch.equal(g[8:-8].to(torch.uint8), w)
                 for g, w in zip(got, want)), "VP9 loopfilter_sharded")
    legs["vp9"] = got

    # (v) HEVC: deblock + SAO in tile columns, one a position
    hsps = HP.HevcSPS(width=n_devices * 16, height=32, log2_ctb=4,
                      sao_enabled=True)
    hpps = HP.HevcPPS(tiles_enabled=True, num_tile_cols=n_devices,
                      num_tile_rows=1)
    hsh = HP.HevcSliceHeader(sao_luma=True, sao_chroma=True)
    hdec = FrameDec(hsps, hpps, hsh)
    hdec.y[:] = rng.integers(0, 256, hdec.y.shape)
    hdec.u[:] = rng.integers(0, 256, hdec.u.shape)
    hdec.v[:] = rng.integers(0, 256, hdec.v.shape)
    hdec.bs_v[:] = 2
    hdec.bs_h[:] = 2
    hdec.sao_type[:, :, :] = 2            # edge offset everywhere
    hdec.sao_offset[:, :, :, 1:3] = 3
    hdec.sao_offset[:, :, :, 3:] = -3
    got = sharded_filters(hdec, smesh)
    want = filters_tpu(hdec, *(torch.as_tensor(p, device=device)
                               for p in (hdec.y, hdec.u, hdec.v)))
    _require(all(torch.equal(g, w) for g, w in zip(got, want)),
             "HEVC sharded_filters")
    legs["hevc"] = got
    return legs
