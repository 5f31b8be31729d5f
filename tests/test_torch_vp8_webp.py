"""The port's VP8 decoder and WebP codecs (codecs/vp8/, webp_vp8l.py,
webp_vp8l_enc.py, webp.py) against the reference's, on the CPU.

- Each module is the reference's code: its top-level statements equal
  the reference's as syntax trees, but for those named in CHANGED: the
  decoders take the device that open_decoder hands them (DeviceCodec)
  and put each shown picture there with one upload (device_planes).
- The VP8 decoder gives the reference decoder's frames on the streams
  that the reference's tests/test_vp8.py and test_vp8_inter.py craft
  (segments, the simple and normal loop filters, several partitions,
  split MVs, golden and altref), committed in
  tests/data/port/image_codecs_streams.npz, and the reference binary's
  decode of each; a returned frame does not change as the decoder goes
  on.
- Lossless WebP both ways (encode_vp8l, the WebP encoder through
  open_encoder, decode_vp8l and the decoder) and lossy WebP give the
  reference's bytes and frames.
- The fixture's 640x352 clip's first frame has the md5 of the reference
  CLI's framemd5 (tests/data/port/cli_golden.json).
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.codecs import webp as ref_webp
from ffmpeg_tpu.codecs import webp_vp8l as ref_vp8l
from ffmpeg_tpu.codecs import webp_vp8l_enc as ref_vp8l_enc
from ffmpeg_tpu.core.frame import Frame as RefFrame
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io import open_input as ref_open_input
from ffmpeg_tpu.io.stream import CodecParameters as RefPar
from ffmpeg_tpu.io.stream import MediaType as RefType
from ffmpeg_tpu.utils.rational import Rational as RefRational
from ffmpeg_tpu_torch import testing as fx
from ffmpeg_tpu_torch.codecs import CodecContext, webp, webp_vp8l
from ffmpeg_tpu_torch.codecs import webp_vp8l_enc
from ffmpeg_tpu_torch.core.frame import Frame
from ffmpeg_tpu_torch.io import open_input
from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType
from ffmpeg_tpu_torch.utils.rational import Rational

from torch_io_util import differing, plain

CHANGED = {
    **{f"codecs/vp8/{m}.py": set() for m in (
        "tables_gen", "idct", "pred", "mc", "lf", "header", "block")},
    "codecs/vp8/__init__.py": {"<imports>", "VP8Decoder"},
    "codecs/webp_vp8l.py": set(),
    "codecs/webp_vp8l_enc.py": set(),
    "codecs/webp.py": {"<imports>", "WebPDecoder", "WebPEncoder"},
}
Z = np.load(fx.IMAGE_CODECS)
VP8 = [k for k in Z.files if k.startswith("vp8_")
       and not k.endswith("_ref_sha256") and k != "vp8_clip"]


@pytest.mark.parametrize("rel", list(CHANGED))
def test_module_is_the_reference_code(rel):
    assert differing(rel) == CHANGED[rel]


def _decode_both(path, n=None):
    d = ref_open_input(str(path))
    pk = list(d.packets())[:n]
    ref = RefContext.open_decoder(d.streams[0].codecpar).decode_all(pk)
    dp = open_input(str(path))
    pk = list(dp.packets())[:n]
    ctx = CodecContext.open_decoder(dp.streams[0].codecpar, device="cpu")
    return ref, ctx.decode_all(pk), ctx


@pytest.mark.parametrize("name", VP8)
def test_vp8_decoder_gives_the_reference_frames(tmp_path, name):
    p = tmp_path / "s.ivf"
    p.write_bytes(fx.image_stream(name))
    ref, got, ctx = _decode_both(p)
    assert len(got) == len(ref) >= 1
    assert plain(got) == plain(ref)
    assert ctx.codec.device == torch.device("cpu")
    assert all(isinstance(pl, torch.Tensor) and pl.device.type == "cpu"
               for f in got for pl in f.planes)
    data = b"".join(f.to_bytes() for f in got)
    assert hashlib.sha256(data).hexdigest() == fx.image_golden(name)


@pytest.mark.parametrize("name", ["vp8_inter_golden_altref",
                                  "vp8_inter_loopfilter"])
def test_returned_vp8_frames_do_not_change(tmp_path, name):
    """The decoder keeps its last, golden and altref pictures; a frame
    it has returned stays as it was while it decodes the next."""
    p = tmp_path / "s.ivf"
    p.write_bytes(fx.image_stream(name))
    d = open_input(str(p))
    pkts = list(d.packets())
    dec = CodecContext.open_decoder(d.streams[0].codecpar, device="cpu")
    first = dec.codec.decode(pkts[0])[0]
    snap = [pl.clone() for pl in first.planes]
    for pkt in pkts[1:]:
        for f in dec.codec.decode(pkt):
            for pl in f.planes:
                pl.add_(1)
    assert all(torch.equal(a, b) for a, b in zip(first.planes, snap))


def test_vp8_clip_first_frame_equals_the_golden(tmp_path):
    """The first picture of phase 29's 640x352 clip against the md5 of
    the reference CLI's framemd5."""
    p = tmp_path / "vp8.ivf"
    p.write_bytes(fx.image_stream("vp8_clip"))
    d = open_input(str(p))
    assert (d.streams[0].codecpar.width,
            d.streams[0].codecpar.height) == (fx.VP8_W, fx.VP8_H)
    dec = CodecContext.open_decoder(d.streams[0].codecpar, device="cpu")
    f = dec.decode_all(list(d.packets())[:1])[0]
    gold = json.loads(fx.CLI_GOLDEN.read_text())["t_framemd5"]
    first = [ln for ln in gold.splitlines() if ln and ln[0] != "#"][0]
    assert hashlib.md5(f.to_bytes()).hexdigest() == \
        first.rsplit(",", 1)[1].strip()


# --- WebP ------------------------------------------------------------------

def _argb(seed, h=40, w=56):
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, 8, (h, w, 4)) * 32).astype(np.uint8)
    img[: h // 2, :, 0] = 255
    img[h // 3:, : w // 2] = rng.integers(0, 256, 4, np.uint8)
    return img


@pytest.mark.parametrize("seed,green", [(0, False), (3, True), (5, True)])
def test_vp8l_both_ways_equal_the_reference(seed, green):
    img = _argb(seed)
    got = webp_vp8l_enc.encode_vp8l(img, subtract_green=green)
    assert got == ref_vp8l_enc.encode_vp8l(img, subtract_green=green)
    assert webp_vp8l_enc.wrap_webp_lossless(got) == \
        ref_vp8l_enc.wrap_webp_lossless(got)
    w, h, argb = webp_vp8l.decode_vp8l(got)
    rw, rh, rargb = ref_vp8l.decode_vp8l(got)
    assert (w, h) == (rw, rh) and np.array_equal(argb, rargb)
    assert np.array_equal(argb, img)


@pytest.mark.parametrize("fmt", ["argb", "rgba", "rgb24"])
def test_webp_encoder_and_decoder_equal_the_references(fmt):
    rng = np.random.default_rng(len(fmt))
    n = {"argb": 4, "rgba": 4, "rgb24": 3}[fmt]
    w, h = 48, 32
    planes = [(rng.integers(0, 6, (h, w)) * 40).astype(np.uint8)
              for _ in range(n)]
    ref = RefContext.open_encoder(RefPar(
        codec_type=RefType.VIDEO, codec_id="webp", width=w, height=h,
        pix_fmt=fmt))
    port = CodecContext.open_encoder(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="webp", width=w, height=h,
        pix_fmt=fmt), device="cpu")
    want = ref.codec.encode(RefFrame.video(w, h, fmt, planes=planes, pts=0,
                                           time_base=RefRational(1, 25)))
    got = port.codec.encode(Frame.video(w, h, fmt, planes=[
        torch.from_numpy(p) for p in planes], pts=0,
        time_base=Rational(1, 25)))
    assert plain(got) == plain(want)
    ref_f = RefContext.open_decoder(RefPar(codec_id="webp")).decode_all(
        [RefPacket(data=want[0].data, pts=0)])
    dec = CodecContext.open_decoder(CodecParameters(codec_id="webp"),
                                    device="cpu")
    got_f = dec.decode_all([got[0]])
    assert plain(got_f) == plain(ref_f)
    # the decoder's one packed argb plane holds the source's pixels
    px = got_f[0].planes[0].numpy().reshape(h, w, 4)
    raw = np.frombuffer(Frame.video(w, h, fmt, planes=planes).to_bytes(),
                        np.uint8).reshape(h, w, -1)
    if fmt == "rgba":
        raw = raw[..., [3, 0, 1, 2]]
    elif fmt == "rgb24":
        raw = np.concatenate([np.full((h, w, 1), 255, np.uint8), raw], -1)
    want_px = raw
    assert np.array_equal(px, want_px)


@pytest.mark.parametrize("name", ["vp8_kf_0", "vp8_kf_lf40", "vp8_kf_odd",
                                  "vp8_kf_segments"])
def test_lossy_webp_decodes_as_the_reference(tmp_path, name):
    """Keyframes of the crafted streams wrapped as .webp (wrap_webp)."""
    ivf = fx.image_stream(name)
    kf = ivf[32 + 12:]
    data = webp.wrap_webp(kf)
    assert data == ref_webp.wrap_webp(kf)
    p = tmp_path / "i.webp"
    p.write_bytes(data)
    ref, got, _ = _decode_both(p)
    assert plain(got) == plain(ref) and got[0].format == "yuv420p"
    assert hashlib.sha256(got[0].to_bytes()).hexdigest() == \
        fx.image_golden(name)


def test_fixture_lossy_webp_decodes_as_the_reference(tmp_path):
    """Phase 29 (u)'s .webp: the 640x352 clip's keyframe."""
    p = tmp_path / "vp8_kf.webp"
    p.write_bytes(fx.image_stream("webp_lossy"))
    ref, got, _ = _decode_both(p)
    assert plain(got) == plain(ref)
    assert (got[0].width, got[0].height) == (fx.VP8_W, fx.VP8_H)


def test_riff_parse_equals_the_reference():
    data = fx.image_stream("webp_lossy")
    assert plain(webp.parse_riff(data)) == plain(ref_webp.parse_riff(data))
    errors = []
    for fn in (ref_webp.parse_riff, webp.parse_riff):
        with pytest.raises(Exception) as e:
            fn(b"RIFX" + data[4:])
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[1] == errors[0]


def test_cli_refuses_the_vp8l_decode_as_the_reference(tmp_path):
    """A fault of the reference that the port keeps: the lossless WebP
    decoder's frame holds one packed (h, 4w) argb plane, which the
    rawvideo encoder refuses to pack, so neither CLI writes the
    decode."""
    from ffmpeg_tpu.cli.ffmpeg import main as ref_main
    from ffmpeg_tpu_torch.cli.ffmpeg import main
    src = tmp_path / "l.webp"
    src.write_bytes(webp_vp8l_enc.wrap_webp_lossless(
        webp_vp8l_enc.encode_vp8l(_argb(1, 16, 24))))
    rcs = [ref_main(["-i", str(src), "-f", "rawvideo",
                     str(tmp_path / "r.raw")]),
           main(["-i", str(src), "-f", "rawvideo", str(tmp_path / "p.raw")],
                device="cpu")]
    assert rcs == [1, 1]
