"""The MJPEG generator: the same seed gives the same frames, another seed
other frames, and the frames decode to the coefficients it encoded."""

import numpy as np
import pytest
import torch

from portbench.tests.cells import small_cell
from portbench.inputs.mjpeg import make_clip, optimal_lengths


def clip(seed, frames=3, full=False):
    _, cfg, _, _, _ = small_cell("mjpeg224.b8")
    w, h = (1920, 1080) if full else (cfg["width"], cfg["height"])
    return make_clip(seed, w, h, frames,
                     cfg["quality"], cfg["max_code_len"], cfg["luma_texture"],
                     cfg["chroma_texture"], "cpu")


def test_same_seed_same_frames():
    a, b = clip(2 ** 31 + 12345), clip(2 ** 31 + 12345)
    assert a.packets == b.packets
    assert torch.equal(a.coef, b.coef)


def test_other_seed_other_frames_same_work():
    """At 1920x1080: the seed moves the texture, not its statistics, and
    each frame has tables of its own."""
    a, b = clip(7, frames=2, full=True), clip(8, frames=1, full=True)
    assert a.packets[0] != b.packets[0]
    # one frame each: within a few per cent (the 72-frame means within ~2%)
    assert abs(a.scan_bytes[0] / b.scan_bytes[0] - 1) < 0.08
    heads = {p[:p.index(b"\xff\xda")] for p in a.packets}
    assert len(heads) == 2


@pytest.mark.parametrize("frame", [0, 2])
def test_frames_decode_to_the_encoded_coefficients(frame):
    from ffmpeg_tpu_torch.testing import host_decode
    c = clip(5)
    want = c.frame_coef(frame).reshape(-1, 6, 64).numpy()
    assert np.array_equal(host_decode(c.packets[frame]), want)


@pytest.mark.parametrize("limit", [8, 9, 16])
def test_code_lengths_respect_the_limit_and_kraft(limit):
    freqs = np.random.default_rng(3).integers(0, 5000, 256) ** 2
    freqs[::7] = 0
    lens = optimal_lengths(freqs, limit)
    used = lens[np.flatnonzero(np.append(freqs, 1))]
    assert used.max() <= limit and used.min() >= 1
    assert (2.0 ** -used).sum() <= 1.0
