"""The HEVC goldens of the port (tests/data/port/hevc_1080p_golden.npz)
tied to the reference: its host decoder (HevcDecoder with no options)
run again here on the committed streams gives the stored hashes."""

import numpy as np
import pytest

from ffmpeg_tpu_torch.testing import (HEVC_BENCH, HEVC_GOLDEN, HEVC_SAO,
                                      HEVC_SMALL, plane_sha256)
from test_torch_hevc import reference


@pytest.mark.parametrize("key,path", [("bench", HEVC_BENCH),
                                      ("sao_deblock", HEVC_SAO),
                                      ("small", HEVC_SMALL)])
def test_golden_is_the_reference_host_decode(key, path):
    frames = reference(path.read_bytes())
    assert [[plane_sha256(np.asarray(p)) for p in f.planes]
            for f in frames] == np.load(HEVC_GOLDEN)[key].tolist()
