"""The port's H.264 decoder against the committed golden
(tests/data/port/h264_1080p_golden.npz, the sha256 of every plane of the
reference's default decode; tools/gen_torch_h264_fixture.py), on the
CPU, byte-exact: the crafted 1920x1088 I P B CABAC stream's I picture
(deblocking on, the device path: about 7 s here), the small crafted
stream and the truncated-slice stream (both paths).  The
golden is tied to the reference: the small and truncated streams'
hashes are recomputed from the reference's decoder, and the committed
streams are re-crafted from the test suite's writers."""

import numpy as np
import pytest
import torch

from ffmpeg_tpu_torch.testing import (H264_CABAC, H264_GOLDEN, H264_SMALL,
                                      h264_decode, h264_pictures,
                                      plane_sha256)

from torch_h264_util import ref_decode, truncated_p

import gen_torch_h264_fixture as G  # on sys.path by torch_h264_util

GOLD = np.load(H264_GOLDEN)


def _hashes(frames):
    return [[plane_sha256(p) for p in f.planes] for f in frames]


def test_cabac_1080p_first_picture_matches_golden():
    """The 1080p stream's I picture on the device path (both wavefronts
    at their 254 steps; one torch thread: these are small eager ops,
    which intra-op threads only slow, and the suite runs its files in
    parallel).  All three pictures run in tests/test_torch_gpu.py and
    chip_smoke.py phase 16."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        stats = []
        frames = h264_decode(h264_pictures(H264_CABAC.read_bytes())[0],
                             "cpu", None, stats)
    finally:
        torch.set_num_threads(threads)
    assert [(f.width, f.height) for f in frames] == [(1920, 1088)]
    assert _hashes(frames) == GOLD["cabac_1080p"][:1].tolist()
    assert stats[0]["slice_type"] == 2
    assert stats[0]["intra_steps"] == stats[0]["deblock_steps"] == \
        119 + 2 * 67 + 1


@pytest.mark.parametrize("opts", [None, {"recon": "host"}])
@pytest.mark.parametrize("key", ["small", "truncated"])
def test_small_streams_match_golden(key, opts):
    data = H264_SMALL.read_bytes() if key == "small" else \
        GOLD["truncated_stream"].tobytes()
    assert _hashes(h264_decode(data, "cpu", opts)) == GOLD[key].tolist()


def test_golden_ties_to_reference():
    assert GOLD["truncated_stream"].tobytes() == truncated_p()
    for key, data in (("small", H264_SMALL.read_bytes()),
                      ("truncated", truncated_p())):
        want = [[plane_sha256(p) for p in f] for f in ref_decode(data)]
        assert want == GOLD[key].tolist(), key


def test_committed_streams_are_the_writers_output():
    assert G.craft_small() == H264_SMALL.read_bytes()
    assert G.craft_cabac_1080p() == H264_CABAC.read_bytes()
