"""Host side of the port's MJPEG path against the reference: the raw
MJPEG demuxer, the JPEG header parse, and the IDCT tables and transform."""

import numpy as np
import pytest
import torch

from ffmpeg_tpu.codecs import mjpeg as ref_mjpeg
from ffmpeg_tpu.ops import idct as ref_idct
from ffmpeg_tpu.utils.error import InvalidData as RefInvalidData
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import mjpeg as port_mjpeg
from ffmpeg_tpu_torch.io.mjpeg import split_packets
from ffmpeg_tpu_torch.ops import idct as port_idct
from ffmpeg_tpu_torch.utils.error import InvalidData

from torch_port_util import encode_jpeg, fixture_packets


def _state_dict(st):
    return {
        "qtabs": {k: v.tolist() for k, v in st.qtabs.items()},
        "tabs": [a.tolist() for a in (st.dc_counts, st.dc_values,
                                      st.ac_counts, st.ac_values)],
        "frame": (st.width, st.height, st.bits, st.restart_interval,
                  st.progressive),
        "comps": [(c.cid, c.h, c.v, c.q_idx, c.dc_tab, c.ac_tab)
                  for c in st.components],
    }


@pytest.mark.parametrize("w,h,quality,opts", [
    (128, 96, 85, {}),
    (96, 64, 35, {}),
    (144, 112, 92, {"restart_interval": 4, "huffman": "default"}),
    (256, 192, 88, {"max_code_len": 8}),
])
def test_parse_until_scan_matches_reference(w, h, quality, opts):
    data = encode_jpeg(w, h, quality, **opts)
    ref_st, port_st = ref_mjpeg._JpegState(), port_mjpeg._JpegState()
    ref_off, ref_sos = ref_mjpeg._parse_until_scan(data, ref_st)
    port_off, port_sos = port_mjpeg._parse_until_scan(data, port_st)
    assert (port_off, port_sos) == (ref_off, ref_sos)
    assert _state_dict(port_st) == _state_dict(ref_st)


def test_parse_until_scan_fixture_frames():
    for data in fixture_packets()[:2]:
        ref_st, port_st = ref_mjpeg._JpegState(), port_mjpeg._JpegState()
        assert port_mjpeg._parse_until_scan(data, port_st) == \
            ref_mjpeg._parse_until_scan(data, ref_st)
        assert _state_dict(port_st) == _state_dict(ref_st)
        assert (port_st.width, port_st.height) == (1920, 1080)


@pytest.mark.parametrize("data", [b"", b"\x00\x01", b"\xFF\xD8\xFF\xD9"])
def test_parse_until_scan_rejects_what_the_reference_rejects(data):
    with pytest.raises(RefInvalidData):
        ref_mjpeg._parse_until_scan(data, ref_mjpeg._JpegState())
    with pytest.raises(InvalidData):
        port_mjpeg._parse_until_scan(data, port_mjpeg._JpegState())


def test_demuxer_matches_reference():
    from ffmpeg_tpu.io import open_input
    ref = [p.data for p in
           open_input(str(fx.FIXTURE), format="mjpeg").packets()]
    port = split_packets(fx.FIXTURE.read_bytes())
    assert len(port) == 8
    assert port == ref


def test_split_packets_drops_short_spans_and_rejects_garbage():
    a, b = encode_jpeg(32, 16), encode_jpeg(32, 16, quality=40)
    assert split_packets(a + b"\xFF\xD9" + b + b"\0\0") == [a, b]
    with pytest.raises(InvalidData):
        split_packets(a + b"junk")


def test_idct_tables_identical():
    np.testing.assert_array_equal(port_idct.ZIGZAG, ref_idct.ZIGZAG)
    np.testing.assert_array_equal(port_idct.UNZIGZAG, ref_idct.UNZIGZAG)
    np.testing.assert_array_equal(port_idct._dct8_matrix(),
                                  ref_idct._dct8_matrix())


def test_idct8x8_matches_reference():
    """float32 on both sides, sums taken in another order: 64 products of
    magnitude <= 1024 each round at float32's 2**-24 relative step, which
    bounds the difference by 64 * 1024 * 2**-24 * 2 < 1e-2 (seen: 2.4e-4)."""
    x = np.random.default_rng(3).integers(
        -1024, 1024, (5, 7, 8, 8)).astype(np.float32)
    want = np.asarray(ref_idct.idct8x8(x))
    got = port_idct.idct8x8(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


def test_idct8x8_refuses_reduced_float32_precision():
    x = torch.zeros(2, 8, 8)
    assert torch.equal(port_idct.idct8x8(x), x)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full float32"):
            port_idct.idct8x8(x)
    finally:
        torch.set_float32_matmul_precision(prev)
