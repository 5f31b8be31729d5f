"""The port's HEVC decoder on the committed 1920x1080 streams, on the
CPU, against the reference's golden hashes (tools/
gen_torch_hevc_fixture.py): frames 0-1 of the bench stream
(benchrows.recon_row_hevc's, deblock and SAO off: the keyframe and a P
frame with the stream's own MVs; chip_smoke.py phase 15 holds all 3 on
the card), and the crafted IDR + P stream with SAO and deblocking on.
The file took over 60 s in the 6-worker tier-1 run with all 3 bench
frames, hence the cut.  test_torch_hevc_golden.py ties the hashes to
the reference's host decoder."""

import numpy as np
import pytest

from ffmpeg_tpu_torch.testing import (HEVC_BENCH, HEVC_GOLDEN, HEVC_SAO,
                                      hevc_decode, hevc_pictures,
                                      plane_sha256)


@pytest.mark.parametrize("key,path,frames", [("bench", HEVC_BENCH, 2),
                                             ("sao_deblock", HEVC_SAO, 2)])
def test_1080p_streams_match_golden(key, path, frames):
    gold = np.load(HEVC_GOLDEN)[key][:frames]
    stats = []
    data = b"".join(hevc_pictures(path.read_bytes())[:frames])
    got = hevc_decode(data, "cpu", None, stats)
    assert [(f.width, f.height) for f in got] == [(1920, 1080)] * frames
    assert [[plane_sha256(p) for p in f.planes] for f in got] == \
        gold.tolist()
    if key == "bench":
        assert [s["levels"] for s in stats] == [1623, 24]
