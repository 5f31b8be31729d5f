"""The port's twin of `__graft_entry__.entry()`: the forward step of the
host-entropy flagship (batched MJPEG decode-transform + scale→RGB) at the
reference's small spec, 256x192 → 128x128, batch 2, inputs from
`example_args` with seed 0.

    fn, args = entry()            # args on the card
    planes = fn(*args)            # three (2, 128, 128) uint8 tensors

The reference's `dryrun_multichip` waits for the multi-device slice.
"""

from __future__ import annotations

import torch

from .models.mjpeg_pipeline import (DecodeScaleSpec, build_decode_scale,
                                    example_args)

SPEC = DecodeScaleSpec(width=256, height=192, out_w=128, out_h=128)
BATCH = 2


def entry(device: torch.device | str = "cuda"):
    """(fn, args): the step function and its example arguments as tensors
    on `device`."""
    fn = build_decode_scale(SPEC)
    args = tuple(torch.as_tensor(a, device=device)
                 for a in example_args(SPEC, batch=BATCH))
    return fn, args
