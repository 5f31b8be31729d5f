"""The port's H.264 decoder against the reference's default decoder (its
host path: recon_host, conceal, loopfilter), on the CPU, byte-exact
(tolerance 0): both of the port's paths, the device path (the default)
and the host path (recon="host"), over the crafted matrix of the
reference's tests/test_h264*.py: I_PCM, I_16x16, I_4x4, I_8x8, P and B
(spatial and temporal direct, B_8x8), CAVLC and CABAC, the 8x8
transform and scaling matrices, explicit and implicit weighted
prediction, multiple references, list modification, MMCO and long-term
references, PAFF field pictures, 10 and 12 bits (the host path on both)
and concealment of truncated slices; AVCC extradata; the registration
and the DPB's device tensors; and the reference's fault on a damaged
picture (its device path skips concealment)."""

import numpy as np
import pytest
import torch

from ffmpeg_tpu_torch.codecs import CodecContext, decoder_names
from ffmpeg_tpu_torch.codecs.h264 import H264Decoder
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType
from ffmpeg_tpu_torch.utils.rational import Rational

from torch_h264_util import (STREAMS, assert_frames_equal, port_frames,
                             ref_decode, truncated_p)


@pytest.mark.parametrize("path", ["device", "host"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decoder_matches_reference(name, path):
    stream = STREAMS[name]()
    want = ref_decode(stream)
    got = port_frames(stream, None if path == "device"
                      else {"recon": "host"})
    assert_frames_equal(got, want, f"{name} ({path})")


def test_registered_and_dpb_on_device():
    assert "h264" in decoder_names()
    ctx = CodecContext.open_decoder(
        CodecParameters(codec_type=MediaType.VIDEO, codec_id="h264"),
        device="cpu")
    assert isinstance(ctx.codec, H264Decoder) and ctx.codec.device_recon
    frames = ctx.decode_all([Packet(data=STREAMS["p_multiref"](), pts=0,
                                    time_base=Rational(1, 25))])
    assert len(frames) == 4
    for f in frames:
        assert all(isinstance(p, torch.Tensor) and p.dtype == torch.uint8
                   for p in f.planes)
    dpb = ctx.codec._dpb
    assert dpb
    for e in dpb:
        assert all(isinstance(p, torch.Tensor) for p in e["planes"])
        assert isinstance(e["mv"], np.ndarray)
    # each picture's planes are tensors of their own: no later picture
    # writes a stored reference
    ptrs = [e["planes"][0].data_ptr() for e in dpb]
    assert len(set(ptrs)) == len(ptrs)


def test_host_path_keeps_host_dpb():
    ctx = CodecContext.open_decoder(
        CodecParameters(codec_type=MediaType.VIDEO, codec_id="h264"),
        {"recon": "host"}, device="cpu")
    frames = ctx.decode_all([Packet(data=STREAMS["p_gop5"](), pts=0,
                                    time_base=Rational(1, 25))])
    assert all(isinstance(p, torch.Tensor) for p in frames[0].planes)
    assert all(isinstance(p, np.ndarray)
               for e in ctx.codec._dpb for p in e["planes"])


def test_avcc_extradata():
    """An AVCC-packaged stream (extradata + length-prefixed NAL units)
    decodes as the reference decodes it, on both paths."""
    from ffmpeg_tpu_torch.codecs.h264 import nal as N
    stream = STREAMS["i4_residual"]()
    units = N.split_annexb(stream)
    sps = [u for u in units if (u[0] & 0x1F) == 7][0]
    pps = [u for u in units if (u[0] & 0x1F) == 8][0]
    idr = [u for u in units if (u[0] & 0x1F) == 5][0]
    avcc = (b"\x01" + sps[1:4] + b"\xff\xe1"
            + len(sps).to_bytes(2, "big") + sps
            + b"\x01" + len(pps).to_bytes(2, "big") + pps)
    payload = len(idr).to_bytes(4, "big") + idr
    want = ref_decode(payload, extradata=avcc)
    assert len(want) == 1
    for opts in (None, {"recon": "host"}):
        ctx = CodecContext.open_decoder(
            CodecParameters(codec_type=MediaType.VIDEO, codec_id="h264",
                            extradata=avcc), opts, device="cpu")
        frames = ctx.decode_all([Packet(data=payload, pts=0,
                                        time_base=Rational(1, 25))])
        assert_frames_equal([f.numpy().planes for f in frames], want,
                            f"avcc {opts}")


def test_unknown_recon_option_raises():
    with pytest.raises(Exception):
        CodecContext.open_decoder(
            CodecParameters(codec_type=MediaType.VIDEO, codec_id="h264"),
            {"recon": "gpu"}, device="cpu")


def test_reference_device_path_skips_concealment():
    """The reference's fault (ffmpeg_tpu/codecs/h264/__init__.py
    H264Decoder._emit): with recon="tpu" a damaged picture is not
    concealed.  On the truncated P picture its two paths differ; the
    port's device path equals the reference's default decoder."""
    stream = truncated_p()
    host = ref_decode(stream)
    tpu = ref_decode(stream, {"recon": "tpu"})
    assert len(host) == len(tpu) == 2
    assert_frames_equal(tpu[:1], host[:1], "the intact I picture")
    diff = [int((a != b).sum()) for a, b in zip(tpu[1], host[1])]
    assert diff[0] > 0 and diff[1] > 0 and diff[2] > 0, diff
    assert_frames_equal(port_frames(stream), host, "port device path")
