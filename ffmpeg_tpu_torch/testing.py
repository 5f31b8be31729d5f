"""The fixtures and host oracles that the port's checks share.

`chip_smoke.py` (on the card) and `tests/test_torch_*.py` (on the CPU)
both check the port against the JAX reference's committed answers:

- the flagship: the committed 8-frame 1920x1080 MJPEG clip and the
  reference's output on it; its constants, the packed cap and the C++
  host decoder's coefficients;
- the MPEG-2 encoder: a clip made from a seed (`mpeg2_clip`, not
  committed) and the reference's motion search and I P P P encode of it
  at 1080p (`ENCODE_GOLDEN`, written by tools/gen_torch_encode_fixture.py);
- the host-entropy decode→scale path and the decoder → graph path on the
  same clip: the reference's `build_decode_scale` at
  `DecodeScaleSpec.auto(1920, 1080, 224, 224)` on all 8 frames and its
  MjpegDecoder + `scale=224:224:format=rgb24` graph on frames 0-1
  (`DECODE_SCALE_GOLDEN`, written by
  tools/gen_torch_decode_scale_fixture.py), and the host's coefficients
  for that path (`scan_coeffs`).
- the audio frontend: the committed 20.03 s ADTS clip (48 kHz stereo
  AAC-LC) and the reference's decode and resample of it to 16 kHz mono
  (`AUDIO_GOLDEN`, written by tools/gen_torch_audio_fixture.py), and the
  path itself (`audio_frontend`);
- the VP9 decoder: the committed 100-frame 1920x1080 stream and the
  reference's per-frame sha256 of its planes and full planes of frames
  0-2 (`VP9_GOLDEN`), a committed 1920x1080 stream with the loop filter
  on and a small crafted one, with the reference's hashes
  (`VP9_LF_GOLDEN`; all written by tools/gen_torch_vp9_fixture.py), and
  the decode itself (`vp9_decode`);
- the HEVC decoder: the committed 3-frame 1920x1080 bench stream, a
  committed 1920x1080 stream with SAO and deblocking on and a small
  crafted one, with the sha256 of every plane of the reference's host
  decode (`HEVC_GOLDEN`, written by tools/gen_torch_hevc_fixture.py),
  and the decode itself (`hevc_decode`, `hevc_pictures`);
- the H.264 decoder: a committed crafted 1920x1088 I P B CABAC stream
  with deblocking, a small crafted stream and the truncated-slice
  stream, with the sha256 of every plane of the reference's default
  decode (`H264_GOLDEN`, written by tools/gen_torch_h264_fixture.py),
  the decode itself (`h264_decode`, `h264_pictures`), and the
  reference's parse as the port's input (`h264_slice_from_reference`);
- the encoders' round trip on `mpeg2_clip` at 1920x1080
  (`ROUNDTRIP_GOLDEN`, written by tools/gen_torch_roundtrip_fixture.py):
  the reference H.264 encoder's I and P packets of the first 2 frames
  and its decoder's planes of them, the reference MPEG-2 decoder's PSNR
  on the reference's I P P P encode, and the reference MJPEG encoder's
  packet sizes and its flagship pipeline's PSNR on 8 frames
  (`MJPEG_ENC_OPTIONS`, `mjpeg_pipeline_rgb`, `mjpeg_target_rgb`,
  `rgb_psnr`).

They live here so that each check reads them from the package and not
from the other.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

from .codecs.mjpeg import _JpegState, _parse_until_scan, scan_decode
from .core.frame import Frame
from .utils.rational import Rational

DATA = Path(__file__).resolve().parent.parent / "tests" / "data" / "port"
FIXTURE = DATA / "flagship_1080p_8.mjpeg"
GOLDEN = DATA / "flagship_1080p_8_golden.npz"
W, H, OUT, BATCH, STRIDE = 1920, 1080, 224, 8, 192
DECODE_SCALE_GOLDEN = DATA / "flagship_1080p_8_decode_scale_golden.npz"
GRAPH_TEXT = f"scale={OUT}:{OUT}:format=rgb24"
GRAPH_FRAMES = 2             # frames of the graph golden

# The MPEG-2 encode golden: I P P P of mpeg2_clip at 1920x1080, fixed
# qscale (so that rate control cannot amplify rounding differences).
ENCODE_GOLDEN = DATA / "mpeg2_1080p_ippp_golden.npz"
ENC_FRAMES, ENC_QSCALE, ENC_GOP = 4, 8, 12
ENC_OPTIONS = {"qscale": ENC_QSCALE, "gop_size": ENC_GOP}

# The audio frontend: 48 kHz stereo AAC-LC → 16 kHz mono fltp
# (benchrows.audio_frontend_row, `ffmpeg -ar 16000 -ac 1`).
AAC_CLIP = DATA.parent / "bench" / "aac48k.adts"
AUDIO_GOLDEN = DATA / "aac48k_frontend_golden.npz"
AUDIO_GOLDEN_FRAMES = 32       # decoded frames of the golden
AUDIO_GRAPH_TEXT = "aresample=16000,aformat=channel_layouts=mono"
AUDIO_GRAPH_PACKETS = 200      # benchrows.audio_frontend_row's cut

# The VP9 decoder (benchrows.recon_row_vp9's stream, and two with the
# loop filter on).
VP9_BENCH = DATA.parent / "bench" / "vp9_1080p_100.ivf"
VP9_GOLDEN = DATA / "vp9_1080p_100_golden.npz"
VP9_LF = DATA / "vp9_1080p_lf.ivf"
VP9_SMALL = DATA / "vp9_crafted_96x72.ivf"
VP9_LF_GOLDEN = DATA / "vp9_lf_golden.npz"

# The HEVC decoder (benchrows.recon_row_hevc's stream, deblock and SAO
# off; a crafted 1080p IDR + P with both on; a small crafted I P B GOP).
HEVC_BENCH = DATA.parent / "bench" / "hevc_1080p.hevc"
HEVC_SAO = DATA / "hevc_1080p_sao_deblock.hevc"
HEVC_SMALL = DATA / "hevc_crafted_64x64.hevc"
HEVC_GOLDEN = DATA / "hevc_1080p_golden.npz"

# The H.264 decoder (an I P B CABAC GOP crafted at 1920x1088 with the
# deblocking filter on; a small crafted stream; the golden also holds
# the truncated-slice stream's bytes and hashes).
H264_CABAC = DATA / "h264_1080p_cabac.h264"
H264_SMALL = DATA / "h264_crafted_small.h264"
H264_GOLDEN = DATA / "h264_1080p_golden.npz"

# The encoders' round trip on mpeg2_clip at 1920x1080: the H.264
# encoder's defaults on the first 2 frames (I, P); the MPEG-2 decoder on
# the I P P P encode at ENC_OPTIONS; the MJPEG encoder with the
# flagship's options (bench.py's) on the first 8 frames, its packets
# decoded by the flagship pipeline to 224x224 rgb24 and held against the
# source frames through the same scale (bicubic, full-range source,
# centred chroma, as the pipeline's operators build it).
ROUNDTRIP_GOLDEN = DATA / "roundtrip_1080p_golden.npz"
RT_FRAMES = 8                 # clip frames the golden's checksum covers
H264_ENC_FRAMES = 2
MJPEG_ENC_OPTIONS = {"quality": 88, "restart_interval": 1,
                     "huffman": "optimal", "max_code_len": 8}
# TpuEntropySpec.stride for the clip: its textured MCUs take up to 237
# bytes a restart segment at these options, past the flagship's 192
MJPEG_SEGMENT_STRIDE = 512
MJPEG_TARGET_SPEC = dict(src_fmt="yuv420p", dst_w=OUT, dst_h=OUT,
                         dst_fmt="rgb24", filter="bicubic", src_range=True,
                         src_chroma_loc="center")


def packed_cap(pkts) -> int:
    """The tight cap bench.py uses: largest scan in the clip + header."""
    max_scan = max(len(p) - _parse_until_scan(p, _JpegState())[0]
                   for p in pkts)
    return 2 * (-(-W // 16)) * (-(-H // 16)) + 512 * 12 + max_scan \
        + STRIDE + 128


def host_decode(pkt: bytes) -> np.ndarray:
    """Coefficients of one 4:2:0 frame with one MCU per restart interval
    from the C++ host decoder, in K1's (nmcu, 6, 64) int16 lane layout."""
    y, u, v = scan_decode(pkt).coeffs
    my, mx = u.shape[:2]
    y = y.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4)
    return np.concatenate([y.reshape(-1, 4, 64), u.reshape(-1, 1, 64),
                           v.reshape(-1, 1, 64)], axis=1)


def scan_coeffs(pkt: bytes, L: int):
    """The first L zigzag coefficients of every block of one 4:2:0 frame
    from the C++ host decoder, as build_decode_scale takes them (before
    pack_coeffs): (ly, lx, L), (cy, cx, L), (cy, cx, L) int16, and the
    luma and chroma quantiser tables as int32 (the reference's
    tests/test_pipeline.py makes them so)."""
    sc = scan_decode(pkt, L)
    q = [sc.st.qtabs[sc.st.components[i].q_idx].astype(np.int32)
         for i in (0, 1)]
    return (*sc.coeffs, *q)


def audio_frontend(par, pkts, device):
    """The audio frontend through the port's entry points on `device`:
    decode_frames over every packet, the planes concatenated, then
    SwrContext(48000 stereo fltp → 16000 mono fltp) convert and flush.
    Returns (decoded frames, (1, m) float32 output)."""
    from .codecs import CodecContext
    from .resample.swresample import SwrContext
    frames = CodecContext.open_decoder(par, device=device) \
        .decode_frames(pkts)
    pcm = np.concatenate([f.audio_data for f in frames], axis=1)
    swr = SwrContext(par.sample_rate, "stereo", "fltp", 16000, "mono",
                     "fltp", device=device)
    return frames, np.concatenate([swr.convert(pcm), swr.flush()], axis=1)


def graph_prefix(n_packets: int) -> int:
    """Outputs at 16 kHz of the first `n_packets` 48 kHz frames that no
    later input reaches: output k reads inputs 3k-47 .. 3k+48 (96 taps,
    center 47), so it is final once input 3k+48 exists."""
    return (n_packets * 1024 - 49) // 3 + 1


def snr_db(got, want) -> float:
    """10 log10 of want's power over the power of got - want."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(((got - want) ** 2).mean())
    return float(10 * np.log10(float((want ** 2).mean()) / max(err, 1e-30)))


def mpeg2_clip(n: int, w: int, h: int, seed: int = 0) -> list:
    """Moving-gradient clip with texture (the clip of
    tests/test_mpeg2_enc.py at any size): smooth areas plus a random
    texture, moving by (2, 3) samples a frame, for motion search to find.
    yuv420p Frames with numpy planes, pts i in 1/25."""
    rng = np.random.default_rng(seed)
    base = (np.add.outer(np.arange(h * 2), np.arange(w * 2)) % 256
            ).astype(np.uint8)
    tex = rng.integers(0, 24, (h * 2, w * 2)).astype(np.uint8)
    frames = []
    for i in range(n):
        dy, dx = (i * 2) % h, (i * 3) % w
        y = (base[dy:dy + h, dx:dx + w] + tex[dy:dy + h, dx:dx + w])
        u = np.full((h // 2, w // 2), 100 + i, np.uint8)
        v = np.full((h // 2, w // 2), 140, np.uint8)
        frames.append(Frame.video(w, h, "yuv420p",
                                  planes=[y.astype(np.uint8), u, v],
                                  pts=i, time_base=Rational(1, 25)))
    return frames


def clip_checksum(frames) -> str:
    """sha256 over every plane's bytes, frame by frame."""
    h = hashlib.sha256()
    for f in frames:
        for p in f.planes[:3]:
            h.update(np.ascontiguousarray(p).tobytes())
    return h.hexdigest()


def recon_psnr(recon, frame) -> float:
    """PSNR (dB) of an encoder's reconstructed planes, cropped to the
    frame's size, against the frame's Y, U and V samples together."""
    d = np.concatenate([
        (np.asarray(r)[:p.shape[0], :p.shape[1]].astype(np.float64)
         - np.asarray(p).astype(np.float64)).ravel()
        for r, p in zip(recon, frame.planes[:3])])
    mse = float((d * d).mean())
    return float(10 * np.log10(255 * 255 / max(mse, 1e-12)))


def mjpeg_pipeline_rgb(pkts, device, w: int = W, h: int = H):
    """4:2:0 MJPEG packets with one MCU per restart interval through the
    flagship pipeline (MjpegTpuEntropyPipeline, K1 on a card) as one
    batch: (3, n, OUT, OUT) uint8 rgb24 on the host."""
    from .models.mjpeg_tpu_entropy import (MjpegTpuEntropyPipeline,
                                           TpuEntropySpec)
    max_scan = max(len(p) - _parse_until_scan(p, _JpegState())[0]
                   for p in pkts)
    cap = 2 * (-(-w // 16)) * (-(-h // 16)) + 512 * 12 + max_scan \
        + MJPEG_SEGMENT_STRIDE + 128
    spec = TpuEntropySpec(w, h, OUT, OUT, batch=len(pkts),
                          stride=MJPEG_SEGMENT_STRIDE, packed_cap=cap)
    pipe = MjpegTpuEntropyPipeline(spec, max(pkts, key=len), device=device)
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    return np.stack([c.cpu().numpy() for c in pipe.run_batch()])


def mjpeg_target_rgb(frames, device) -> np.ndarray:
    """The source frames through the scale the flagship pipeline folds
    into its operators (MJPEG_TARGET_SPEC): (3, n, OUT, OUT) uint8."""
    from .scale.swscale import Scaler
    f0 = frames[0]
    sc = Scaler(device, src_w=f0.width, src_h=f0.height,
                **MJPEG_TARGET_SPEC)
    return np.stack([np.stack([c.cpu().numpy() for c in sc.run(
        [np.asarray(p) for p in f.planes[:3]])]) for f in frames], axis=1)


def rgb_psnr(got: np.ndarray, want: np.ndarray) -> list:
    """Per-frame PSNR (dB) of (3, n, h, w) uint8 planes against `want`,
    over the three components together."""
    d = got.astype(np.float64) - want.astype(np.float64)
    mse = (d * d).mean(axis=(0, 2, 3))
    return [float(10 * np.log10(255 * 255 / max(m, 1e-12))) for m in mse]


def plane_sha256(plane) -> str:
    """sha256 of a plane's bytes (a tensor is copied to the host)."""
    from .core.frame import host_array
    return hashlib.sha256(np.ascontiguousarray(host_array(plane))
                          .tobytes()).hexdigest()


def vp9_decode(packets, device, options=None):
    """Decode IVF packets through CodecContext.open_decoder("vp9") on
    `device`, one packet at a time; returns the frames."""
    from .codecs import CodecContext
    from .io.stream import CodecParameters, MediaType
    from .utils.error import TryAgain
    dec = CodecContext.open_decoder(
        CodecParameters(codec_type=MediaType.VIDEO, codec_id="vp9"),
        options, device=device)
    out = []
    for p in packets:
        dec.send_packet(p)
        while True:
            try:
                out.append(dec.receive_frame())
            except TryAgain:
                break
    return out


def vp9_golden_planes(gold, i: int) -> list:
    """The reference's full y/u/v planes of bench frame i from
    VP9_GOLDEN, whose frames after the first are stored as differences
    from the frame before (modulo 256)."""
    planes = [gold[f"{n}0"] for n in "yuv"]
    for k in range(1, i + 1):
        planes = [p + gold[f"{n}{k}"] for n, p in zip("yuv", planes)]
    return planes


def hevc_decode(data: bytes, device, options=None, stats=None):
    """Decode an Annex B HEVC stream through
    CodecContext.open_decoder("hevc") on `device`, drained; returns the
    frames in output order.  stats: a list that gets the decoder's
    per-picture split (device path)."""
    from .codecs import CodecContext
    from .core.packet import Packet
    from .io.stream import CodecParameters, MediaType
    dec = CodecContext.open_decoder(
        CodecParameters(codec_type=MediaType.VIDEO, codec_id="hevc"),
        options, device=device)
    dec.codec.stats = stats
    return dec.decode_all([Packet(data=data, pts=0)])


def hevc_pictures(data: bytes) -> list:
    """An Annex B HEVC stream as one packet per picture (one slice per
    picture, as the decoder takes them): the parameter sets and other
    non-slice NAL units go with the next slice."""
    from .codecs.h264.nal import split_annexb
    pkts, head = [], b""
    for u in split_annexb(data):
        nal = b"\x00\x00\x00\x01" + u
        if (u[0] >> 1) & 0x3F < 32:          # VCL NAL unit types
            pkts.append(head + nal)
            head = b""
        else:
            head += nal
    return pkts


def h264_decode(data: bytes, device, options=None, stats=None):
    """Decode an Annex B H.264 stream through
    CodecContext.open_decoder("h264") on `device` as one packet,
    drained; returns the frames in output order.  stats: a list that
    gets the decoder's per-picture split (device path)."""
    from .codecs import CodecContext
    from .core.packet import Packet
    from .io.stream import CodecParameters, MediaType
    dec = CodecContext.open_decoder(
        CodecParameters(codec_type=MediaType.VIDEO, codec_id="h264"),
        options, device=device)
    dec.codec.stats = stats
    return dec.decode_all([Packet(data=data, pts=0,
                                  time_base=Rational(1, 25))])


def h264_slice_from_reference(ref):
    """The port's SliceDecoder holding a copy of a parsed picture of the
    reference's (ffmpeg_tpu's SliceDecoder, duck-typed: no import of
    the reference): its SPS and PPS rebuilt as the port's, every array
    copied, the reference lists' entries copied with their planes as
    host arrays.  Both reconstructions then compute from one parse."""
    import dataclasses
    from .codecs.h264.params import PPS, SPS
    from .codecs.h264.slice_dec import SliceDecoder

    memo: dict = {}

    def conv(v):
        # one copy per object: two list entries naming one DPB picture
        # stay one picture (the deblock compares picture identities)
        if id(v) in memo:
            return memo[id(v)]
        if isinstance(v, np.ndarray):
            out = v.copy()
        elif isinstance(v, dict):
            out = {k: conv(x) for k, x in v.items()}
        elif isinstance(v, (list, tuple)):
            out = type(v)(conv(x) for x in v)
        else:
            return v
        memo[id(v)] = out
        return out

    sps = SPS(**{f.name: conv(getattr(ref.sps, f.name))
                 for f in dataclasses.fields(SPS)})
    pps = PPS(**{f.name: conv(getattr(ref.pps, f.name))
                 for f in dataclasses.fields(PPS)})
    dec = SliceDecoder(sps, pps)
    for k, v in vars(ref).items():
        if k in ("sps", "pps"):
            continue
        setattr(dec, k, conv(v))
    return dec


def h264_pictures(data: bytes) -> list:
    """An Annex B H.264 stream as one packet per slice NAL unit (one
    slice per picture in the committed streams): the parameter sets and
    other non-slice units go with the next slice."""
    from .codecs.h264.nal import split_annexb
    pkts, head = [], b""
    for u in split_annexb(data):
        nal = b"\x00\x00\x00\x01" + u
        if u[0] & 0x1F in (1, 5):            # coded slices
            pkts.append(head + nal)
            head = b""
        else:
            head += nal
    return pkts
