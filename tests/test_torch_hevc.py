"""The port's HEVC decoder (ffmpeg_tpu_torch/codecs/hevc/) against the
reference's host decoder, byte-exact, on the CPU.

The reference's HevcDecoder with no options (inline host reconstruction,
host deblock and SAO) runs in the same process as the oracle.  The port
runs through CodecContext.open_decoder(..., device="cpu"): on its
default path (the CABAC parse on the host, recon_tpu and filter_tpu on
the device) and with device_recon=False (the host path).  The streams
are the crafted matrix of tests/test_hevc_recon_tpu.py, built the same
way: intra with mixed modes, partial CTBs, dense transform skip, SAO and
deblocking, 10 and 12 bits, a P GOP, a B GOP with reordering, SAO and
deblocking, tiles and WPP substreams."""

import numpy as np
import pytest
import torch

import test_hevc as T
from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io.stream import CodecParameters as RefParameters
from ffmpeg_tpu.io.stream import MediaType as RefMediaType
from ffmpeg_tpu_torch.codecs import CodecContext, decoder_names
from ffmpeg_tpu_torch.codecs.hevc import HevcDecoder
from ffmpeg_tpu_torch.codecs.hevc import recon_tpu
from ffmpeg_tpu_torch.core.packet import Packet
from ffmpeg_tpu_torch.io.stream import CodecParameters
from ffmpeg_tpu_torch.testing import hevc_decode


def reference(stream):
    d = RefContext.open_decoder(RefParameters(codec_type=RefMediaType.VIDEO,
                                              codec_id="hevc"))
    return d.decode_all([RefPacket(data=stream, pts=0)]) + \
        d.decode_all([None])


def _stream(case):
    """The crafted matrix of tests/test_hevc_recon_tpu.py (seeds and
    plans as there), and a 12-bit frame."""
    rng = np.random.default_rng(
        {"i_mixed": 1, "partial": 2, "tskip": 3, "sao_deblock": 4,
         "bit10": 5, "p_gop": 6, "b_gop": 7, "tiles": 8, "wpp": 8,
         "bit12": 33}[case])
    if case == "i_mixed":
        return T.craft_frame(T.Plan(rng))
    if case == "partial":
        return T.craft_frame(T.Plan(rng), width=72, height=56)
    if case == "tskip":
        return T.craft_frame(T.Plan(rng, maxn=24, amp=60),
                             pps_kw={"transform_skip": True})
    if case == "sao_deblock":
        return T.craft_frame(T.Plan(rng, maxn=20, amp=70), sao=True,
                             pps_kw={"deblock": True})
    if case == "bit10":
        return T.craft_frame(T.Plan(rng), bit_depth=10)
    if case == "bit12":
        return T.craft_frame(T.Plan(rng, maxn=6, amp=120), bit_depth=12,
                             sao=True, pps_kw=dict(deblock=True))
    if case == "p_gop":
        return T.craft_gop(lambda: T.InterPlan(rng), n_frames=4)[0]
    if case == "b_gop":
        return T.craft_gop(lambda: T.InterPlan(rng, maxn=10, amp=40),
                           n_frames=5, gop_kind="B", sao=True,
                           pps_kw={"deblock": True})[0]
    if case == "tiles":
        return T.craft_frame(T.Plan(rng), pps_kw={"tiles": (2, 2)})
    return T.craft_frame(T.Plan(rng), pps_kw={"wpp": True})


CASES = ["i_mixed", "partial", "tskip", "sao_deblock", "bit10", "bit12",
         "p_gop", "b_gop", "tiles", "wpp"]


def check(stream, options):
    want = reference(stream)
    got = hevc_decode(stream, "cpu", options)
    assert want and len(got) == len(want)
    for i, (fw, fg) in enumerate(zip(want, got)):
        assert (fg.width, fg.height, fg.key_frame, fg.format) == \
            (fw.width, fw.height, fw.key_frame, fw.format)
        host = fg.numpy()
        for pl, (a, b, t) in enumerate(zip(fw.planes, host.planes,
                                           fg.planes)):
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            assert b.dtype == np.asarray(a).dtype
            np.testing.assert_array_equal(b, np.asarray(a),
                                          err_msg=f"frame {i} plane {pl}")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("path", ["device", "host"])
def test_decoder_matches_reference(case, path):
    check(_stream(case), None if path == "device"
          else {"device_recon": False})


def test_registered_and_device_by_default():
    assert "hevc" in decoder_names()
    ctx = CodecContext.open_decoder(CodecParameters(codec_id="hevc"),
                                    device="cpu")
    assert isinstance(ctx.codec, HevcDecoder) and ctx.codec.device_recon
    assert HevcDecoder(CodecParameters(codec_id="hevc")).device == \
        torch.device("cuda")


def test_dpb_holds_device_tensors():
    """On the device path the DPB holds the filtered planes as tensors,
    the frames carry them (uint8 at 8 bits), and a later frame's
    references are those same tensors."""
    stream = _stream("p_gop")
    ctx = CodecContext.open_decoder(CodecParameters(codec_id="hevc"),
                                    device="cpu")
    dec = ctx.codec
    refs_seen = []
    real = recon_tpu.reconstruct

    def spy(fd, rec, device, timer=None):
        refs_seen.append([r[0] for r in fd.refs[0]])
        return real(fd, rec, device, timer)
    recon_tpu.reconstruct = spy
    try:
        frames = ctx.decode_all([Packet(data=stream, pts=0)])
    finally:
        recon_tpu.reconstruct = real
    assert len(frames) == 4
    assert all(isinstance(e["y"], torch.Tensor) and e["y"].dtype ==
               torch.uint8 for e in dec.dpb)
    # frame k predicts from frame k-1's filtered luma tensor itself
    for k in range(1, 4):
        assert refs_seen[k][0] is frames[k - 1].planes[0]


def test_stats_split():
    stats = []
    hevc_decode(_stream("p_gop"), "cpu", None, stats)
    assert len(stats) == 4 and stats[0]["slice_type"] == 2
    for s in stats:
        assert {"parse", "build", "h2d", "queue"} <= set(s["host"])
        assert {"residual", "inter", "intra", "deblock", "sao"} == \
            set(s["device"])
