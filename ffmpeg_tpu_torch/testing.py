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
  `rgb_psnr`);
- the intra codecs' round trip on the clip's first frame lifted to
  10-bit 4:2:2 (`intra_clip_frame`) at 1920x1080 (`INTRA_GOLDEN`,
  written by tools/gen_torch_intra_fixture.py): the reference ProRes and
  DNxHD encoders' packet sha256 and sizes and the per-plane sha256 and
  PSNR (`plane_psnr`) of the reference decoders' output on them; and
  three of tests/test_mpeg4.py's MPEG-4 and H.263 streams with the
  sha256 of the reference decoder's planes (`MPEG4_STREAMS`, read by
  `mpeg4_stream`);
- the tie-aware bar of the encoders whose levels come from a float32
  FDCT (`fdct_exact`, `undecided_levels`);
- the audio decoders: ten short streams (E-AC-3 5.1 and AC-3 stereo
  from the reference binary's encoder, crafted E-AC-3 AHT + SPX frames,
  crafted MP3, MP2 and MP1 frames, and crafted SBR and PS payloads on
  an AAC-LC core) with the reference decoder's PCM of their first
  packets (`AUDIO_STREAMS`, written by tools/gen_torch_audio_fixture.py
  and read by `audio_stream`), the decode through the port's entry
  points (`audio_decode`), the bar (`audio_bar`), and the reference
  decoders' carried state moved into the port's (`transplant_audio_state`);
- the CLI (`CLI_GOLDEN`, written by tools/gen_torch_cli_fixture.py):
  the command lines of chip_smoke.py's phases 26 and 27 (`cli_commands`,
  `cli_container_commands`) and the reference CLI's framemd5 text,
  remuxes' sha256, sample counts and probe text of them, with the y4m of
  the MPEG-2 command (`write_y4m`) and the Ogg files of the Vorbis and
  Opus command (`write_cli_ogg`: `ogg_stream`, the page writer, on the
  committed packets of `AUDIO_CODECS`, since the reference has no Ogg
  muxer);
- the rest of the audio (`AUDIO_CODECS`, written by
  tools/gen_torch_audio_codecs_fixture.py): the Vorbis and Opus streams
  of the reference's tests (`codec_stream`, `codec_decode`) with the
  reference decoder's PCM of their first packets; the AAC encoder's
  cases on the seeded `aac_signal` with the reference encoder's packet
  sha256, sizes, decisions and decode SNR (`aac_encode`, `aac_check`,
  whose tie-aware bar is `aac_decision_check`); and the audio filter
  chains (`AUDIO_CHAINS`, `audio_chain_inputs`, `run_audio_chain`) with
  the reference's outputs (`audio_chain_host_check`);
- the protocols and host codecs of chip_smoke.py's phase 28: its command
  lines (`cli_protocol_commands`), a loopback HTTP server
  (`serve_http`), an RTMP relay (`rtmp_relay`), the AES-128 copy of an
  HLS playlist (`write_hls_aes`, `hls_aes_files`), the GIF clip and its
  writer (`gif_clip`, `write_cli_gif`), an ID3v2-tagged MP3
  (`tagged_mp3` and the tag writers), FLAC's STREAMINFO
  (`flac_streaminfo`), and the reference binary's DTS, TrueHD, MLP,
  ADPCM, FLAC and GIF streams with the reference CLI's decodes of them
  (`HOST_CODECS`, written by tools/gen_torch_host_codecs_fixture.py:
  `HOST_CODEC_STREAMS`, `host_codec_command`, `host_codec_golden`).

They live here so that each check reads them from the package and not
from the other.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

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
# The general scan decode's fixture: 2 testsrc frames at 1920x1080 with
# the MJPEG encoder's default (Annex K) Huffman tables, codes of up to 16
# bits (tools/gen_torch_huffman_fixture.py)
HUFFMAN_ANNEXK = DATA / "huffman_annexk_1080p_2.mjpeg"

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


# The intra codecs (ProRes 4:2:2 10-bit and DNxHR HQX, CID 1271, both
# at qscale 4) on intra_clip_frame at 1920x1080, and three MPEG-4/H.263
# streams (test_mpeg4_bframes, test_mpeg4_4mv, test_h263_cif_rc).
INTRA_GOLDEN = DATA / "intra_1080p_golden.npz"
INTRA_QSCALE = 4
MPEG4_STREAMS = DATA / "mpeg4_streams.npz"
MPEG4_STREAM_NAMES = ("mpeg4_bframes", "mpeg4_4mv", "h263_cif_rc")
# The audio decoders' streams (tools/gen_torch_audio_fixture.py), and the
# reference decoder's PCM of each one's first AUDIO_PREFIX_PACKETS packets.
AUDIO_STREAMS = DATA / "audio_streams.npz"
AUDIO_STREAM_NAMES = ("eac3_5_1", "ac3_stereo", "eac3_aht_spx",
                      "mp3_reservoir", "mp3_short", "mp3_ms", "mp2_stereo",
                      "mp1_stereo", "aac_sbr", "aac_ps")
AUDIO_PREFIX_PACKETS = 4
# max |diff| on PCM whose full scale is 1, and SNR, of a decode against
# the reference's decode of the same packets, and of the card's decode
# against the CPU's
AUDIO_DECODE_TOL, AUDIO_DECODE_MIN_SNR = 1e-5, 100.0
# float32's error bound on an FDCT coefficient, as a share of the sum of
# its terms' magnitudes: 16 units in the last place of float32 (2^-24
# each), the bound of two 8-term float32 sums in any order
F32_TOL = 2.0 ** -20


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


def scan_segments(pkt: bytes):
    """One baseline frame's scan destuffed and split at its restart
    markers by the port's C++ (mjpeg_split_segments), as
    ops/huffman.jpeg_scan_decode takes it: (header state, buffer, bit
    offset of each segment, blocks in each segment, MCU grid (mx, my));
    numpy arrays."""
    import ctypes
    from . import native
    st = _JpegState()
    off, _ = _parse_until_scan(pkt, st)
    scan = pkt[off:]
    hmax = max(c.h for c in st.components)
    vmax = max(c.v for c in st.components)
    mx, my = -(-st.width // (8 * hmax)), -(-st.height // (8 * vmax))
    nmcu, ri = mx * my, st.restart_interval
    buf = np.zeros(len(scan) + 16, np.uint8)
    offs = np.zeros(nmcu + 3, np.int32)
    n = native.get().mjpeg_split_segments(
        scan, len(scan), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(buf), offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nmcu + 2)
    if ri < 1 or n != -(-nmcu // ri):
        raise ValueError(f"scan_segments: {n} segments for {nmcu} MCUs "
                         f"with restart interval {ri}")
    nb = sum(c.h * c.v for c in st.components)
    blk_end = (np.minimum(ri, nmcu - np.arange(n) * ri) * nb) \
        .astype(np.int32)
    return st, buf, offs[:n] * 8, blk_end, (mx, my)


def general_scan_inputs(pkt: bytes, device):
    """The inputs of ops/huffman.jpeg_scan_decode for one 4:2:0 frame with
    one MCU per restart interval (scan_segments): the buffer, the bit
    offsets, all lanes valid and the frame's tables from build_jpeg_luts;
    tensors on `device`."""
    import torch
    from .ops.huffman import build_jpeg_luts
    st, buf, bitpos, blk_end, _ = scan_segments(pkt)
    if (blk_end != 6).any():
        raise ValueError("general_scan_inputs: not one 4:2:0 MCU a segment")

    def t(a):
        return torch.from_numpy(a).to(device)
    return (t(buf), t(bitpos), t(np.ones(len(bitpos), bool)),
            t(build_jpeg_luts(st)))


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


def cli_encoder_input(path, codec_id: str, device) -> tuple:
    """What the CLI's video encoder of `codec_id` is opened with and fed
    for a one-stream file: the input stream's parameters with the size,
    format, codec and frame rate (from the time base) of the first frame
    the port decodes on `device`, and those frames."""
    from .codecs import CodecContext
    from .io import open_input
    d = open_input(str(path))
    st = d.streams[0]
    frames = CodecContext.open_decoder(st.codecpar, device=device
                                       ).decode_all(list(d.packets()))
    d.close()
    par = st.codecpar.copy()
    f = frames[0]
    par.width, par.height, par.pix_fmt = f.width, f.height, f.format
    par.codec_id = codec_id
    par.framerate = f.time_base.inv()
    return par, frames


def encode_all(ctx, frames: list) -> list:
    """Every packet an open encoder makes of `frames`, drained."""
    from .utils.error import EndOfStream, TryAgain
    out = []
    for f in [*frames, None]:
        ctx.send_frame(f)
        while True:
            try:
                out.append(ctx.receive_packet())
            except (TryAgain, EndOfStream):
                break
    return out


def write_y4m(path, frames: list, rate: int = 25) -> Path:
    """Frames of one size and format (host or device planes) as a y4m
    file at `rate` frames/s, through the port's muxer."""
    from .core.packet import Packet
    from .io import open_output
    from .io.stream import CodecParameters, MediaType
    f0 = frames[0]
    m = open_output(str(path), format="yuv4mpegpipe")
    m.add_stream(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="rawvideo", width=f0.width,
        height=f0.height, pix_fmt=f0.format, framerate=Rational(rate, 1)),
        time_base=Rational(1, rate))
    for i, f in enumerate(frames):
        m.write_packet(Packet(data=f.to_bytes(), pts=i, dts=i, duration=1))
    m.write_trailer()
    m.close()
    return Path(path)


# --- the CLI: chip_smoke.py's phase 26 and its goldens ----------------------

CLI_GOLDEN = DATA / "cli_golden.json"
# frames of mpeg2_clip at 1920x1080 in command (d)
CLI_MPEG2_FRAMES = 2
CLI_PROBE_ARGS = ["-show_streams", "-show_packets", "-of", "json"]


def cli_commands(d) -> dict:
    """Phase 26's command lines, writing into directory `d`: (a) the
    flagship's MJPEG to 224x224 rgb24, (b) three VP9 frames to framemd5,
    (c) the H.264 stream remuxed to Matroska and MP4 and its first frame
    from the Matroska file to framemd5, (d) the MPEG-2 encode of
    d/mpeg2_clip.y4m (CLI_MPEG2_FRAMES frames of mpeg2_clip) into
    Matroska (the reference has no raw MPEG video muxer), (e) the audio
    frontend's 16 kHz mono float."""
    d = str(d)
    return {
        "a": ["-i", str(FIXTURE), "-vf", "scale=224:224", "-pix_fmt",
              "rgb24", "-f", "rawvideo", f"{d}/out.rgb"],
        "b": ["-i", str(VP9_BENCH), "-frames:v", "3", "-f", "framemd5",
              f"{d}/out_vp9.md5"],
        "c_mkv": ["-i", str(H264_CABAC), "-c", "copy", f"{d}/out.mkv"],
        "c_mp4": ["-i", str(H264_CABAC), "-c", "copy", f"{d}/out.mp4"],
        "c_md5": ["-i", f"{d}/out.mkv", "-frames:v", "1", "-f", "framemd5",
                  f"{d}/out_h264.md5"],
        "d": ["-i", f"{d}/mpeg2_clip.y4m", "-c:v", "mpeg2video",
              f"{d}/out_mpeg2.mkv"],
        "e": ["-i", str(AAC_CLIP), "-ar", "16000", "-ac", "1", "-f", "f32le",
              f"{d}/out.f32"],
    }


def probe_without_sizes(text: str) -> dict:
    """A -show_packets JSON probe with each packet's size and pos left
    out: what two encoders' streams of one clip share."""
    import json
    doc = json.loads(text)
    for p in doc.get("packets", []):
        p.pop("size", None)
        p.pop("pos", None)
    return doc


def filter_clip(seed: int, n: int = 8, w: int = 1920, h: int = 1080,
                fmt: str = "yuv420p", interlaced: bool = False) -> list:
    """n frames of host planes of `fmt` at w x h for the filter checks:
    per component a textured gradient moving a few samples a frame, with
    seeded uniform noise on every component (chroma and alpha too).  With
    `interlaced` the odd rows move on by half a frame's motion more, so
    the two fields of a frame differ as a moving interlaced picture's
    do.  Float formats hold linear light in [0, 6].  Returns
    [[plane, ...], ...], each plane of the format's component type."""
    from .formats import pixfmt
    desc = pixfmt.get(fmt)
    rng = np.random.default_rng(seed)
    maxv = 255 if desc.is_float else (1 << desc.comp[0].depth) - 1
    dims = [desc.chroma_dims(w, h) if i in (1, 2) and not desc.is_rgb
            and desc.nb_components >= 3 else (w, h)
            for i in range(desc.nb_components)]
    tex = [rng.integers(0, 2, (ch + 8 * n, cw + 8 * n)).astype(np.float32)
           * np.float32(maxv / 10) for cw, ch in dims]
    frames = []
    for k in range(n):
        planes = []
        for i, (cw, ch) in enumerate(dims):
            x = np.arange(cw, dtype=np.int32)[None, :]
            y = np.arange(ch, dtype=np.int32)[:, None]
            odd = (y % 2) if interlaced else np.zeros_like(y)
            t = k + 0.5 * odd                          # (ch, 1)
            sx = np.sin((x + 4 * (k + 0.5 * np.array([[0], [1]])))
                        / (40 + 9 * i)).astype(np.float32)
            sx = sx[odd[:, 0]]                         # (ch, cw)
            cy = np.cos((y - 3 * t) / (31 + 7 * i)).astype(np.float32)
            # (x + y + 2t) % 64 / 64, with 2t an integer
            ramp = ((x + y + (2 * k + odd)) & 63).astype(np.float32) / 64
            base = 0.5 + np.float32(0.35) * sx * cy + np.float32(0.1) * ramp
            dy, dx = (3 * k) % (8 * n), (4 * k) % (8 * n)
            v = base * np.float32(maxv) + \
                tex[i][dy:dy + ch, dx:dx + cw] + \
                (rng.random((ch, cw), np.float32) - np.float32(0.5)) * \
                np.float32(maxv / 12)
            v = np.clip(np.round(v), 0, maxv)
            # float formats: linear light in [0, 6], as HDR content
            planes.append((v / np.float32(255 / 6) if desc.is_float else v)
                          .astype(desc.component_dtype()))
        frames.append(planes)
    return frames


FILTER_CUBE = DATA / "filters_5.cube"
FILTERS_GOLDEN = DATA / "filters_1080p_golden.npz"
FILTER_FRAMES = 8
# the golden's corners of a float chain's frame 0, in luma samples (a
# subsampled plane's corner covers the same picture area): 64 and not
# 128, which made the golden 1.5 MB
CORNER = 64


def corner_size(fmt: str, plane: int) -> Tuple[int, int]:
    """(rows, columns) of plane `plane`'s corner in a frame of `fmt`."""
    from .formats import pixfmt
    desc = pixfmt.get(fmt)
    if plane in (1, 2) and not desc.is_rgb and desc.nb_components >= 3:
        return CORNER >> desc.log2_chroma_h, CORNER >> desc.log2_chroma_w
    return CORNER, CORNER


@dataclass(frozen=True)
class FilterChain:
    """One graph of the video filters' checks (chip_smoke.py phase 24,
    tests/test_torch_gpu.py, tools/gen_torch_filters_fixture.py).
    `inputs` maps each input label to (pixel format, frames, clip seed,
    size divisor, interlaced); `bar` is "exact" (the reference's sha256
    of every output plane), "lsb" (integer samples within 1 on <= 1% of
    each plane, the reference's frame-0 corners) or "rel" (float samples
    within 1e-6 of the plane's largest magnitude, the same corners);
    `scores` names the filters whose scores are compared."""
    name: str
    text: str
    inputs: Tuple[Tuple[str, Tuple], ...]
    outs: Tuple[str, ...] = ("out",)
    eof_early: Tuple[str, ...] = ()
    bar: str = "exact"
    scores: Tuple[str, ...] = ()

    def graph_text(self) -> str:
        return self.text.format(cube=FILTER_CUBE)


def _ins(*items):
    return tuple((label, spec) for label, spec in items)


_N = FILTER_FRAMES
FILTER_CHAINS = (
    FilterChain("video2_deint",
                "yadif,deblock=strength=40,drawbox=x=100:y=80:w=400:h=300:"
                "thickness=4,fade=type=in:start_frame=1:nb_frames=4",
                _ins(("in", ("yuv420p", _N, 0, 1, True)))),
    FilterChain("video2_overlay",
                "[in][ov]overlay=x=W-w/2:y=H-h/2,split[a][b];[b]nullsink",
                _ins(("in", ("yuva420p", _N, 0, 1, False)),
                     ("ov", ("yuva420p", _N - 3, 5, 3, False))),
                outs=("a",), eof_early=("ov",)),
    FilterChain("video2_metrics", "[a][b]psnr[m];[m][c]ssim",
                _ins(("a", ("yuv420p", _N, 0, 1, False)),
                     ("b", ("yuv420p", _N, 1, 1, False)),
                     ("c", ("yuv420p", _N, 2, 1, False))),
                scores=("psnr", "ssim")),
    FilterChain("video2_lut3d",
                "lut3d=file={cube}:interp=trilinear,lut3d=file={cube}",
                _ins(("in", ("rgb24", 4, 0, 1, False)))),
    # a float chain starts from exact input at its one filter that may
    # differ from the reference by an LSB, and amplifies nothing after it
    FilterChain("video3_point",
                "negate,eq=contrast=1.2:brightness=0.03:gamma=1.1,"
                "hue=h=25:s=1.1",
                _ins(("in", ("yuv420p", _N, 0, 1, False))), bar="lsb"),
    FilterChain("video3_blur",
                "unsharp=luma_amount=0.6:chroma_amount=0.3,"
                "boxblur=luma_radius=3:chroma_radius=1",
                _ins(("in", ("yuv420p", _N, 0, 1, False))), bar="lsb"),
    FilterChain("video4_spatial", "gblur=sigma=1.2,avgblur=sizeX=2,"
                "vignette,swapuv",
                _ins(("in", ("yuv420p", _N, 0, 1, False))), bar="lsb"),
    FilterChain("video4_edges", "edgedetect=low=0.02:high=0.1,"
                "drawgrid=width=120:height=90:thickness=2,monochrome",
                _ins(("in", ("yuv420p", _N, 0, 1, False))), bar="lsb"),
    FilterChain("video4_temporal",
                "select=expr=lt(n\\,7),tmix=frames=3,framestep=step=2,"
                "vnoise=strength=10:seed=3",
                _ins(("in", ("yuv420p", _N, 0, 1, False)))),
    FilterChain("video4_blend",
                "[a][b]blend=all_mode=multiply:all_opacity=0.8",
                _ins(("a", ("yuv420p", _N, 0, 1, False)),
                     ("b", ("yuv420p", _N - 2, 3, 1, False))),
                eof_early=("b",), bar="lsb"),
    FilterChain("video8_deint", "bwdif,separatefields,weave",
                _ins(("in", ("yuv420p", _N, 0, 1, True)))),
    FilterChain("video8_denoise", "hqdn3d",
                _ins(("in", ("yuv420p", _N, 0, 1, False))), bar="lsb"),
    FilterChain("video8_sharpen", "cas=strength=0.5",
                _ins(("in", ("yuv420p", _N, 0, 1, False))), bar="lsb"),
    FilterChain("video8_average", "atadenoise=s=5,deflicker=size=3",
                _ins(("in", ("yuv420p", _N, 0, 1, False))), bar="lsb"),
    FilterChain("video8_color", "colortemperature=temperature=5000:pl=0.3,"
                "exposure=exposure=-0.3",
                _ins(("in", ("gbrp", _N, 0, 1, False))), bar="lsb"),
    FilterChain("video8_hue", "huesaturation=hue=15:saturation=0.2",
                _ins(("in", ("gbrp", _N, 0, 1, False))), bar="lsb"),
    FilterChain("video6_neighbours",
                "fillborders=left=16:right=16:top=8:bottom=8:mode=mirror,"
                "limiter=min=16:max=235,dilation,erosion,median=radius=2,"
                "inflate,deflate,sobel,prewitt=scale=0.5,"
                "lutyuv=y=negval:u=val/2,extractplanes=planes=y+u",
                _ins(("in", ("yuv420p", 4, 0, 1, False)))),
    FilterChain("video6_color",
                "lutrgb=g=val*0.9,colorkey=color=0x808080:similarity=0.2:"
                "blend=0.1,shuffleplanes=map0=1:map1=0,colorchannelmixer="
                "rr=0.8:rg=0.2:gg=0.9:bb=1.1",
                _ins(("in", ("gbrp", _N, 0, 1, False))), bar="lsb"),
    FilterChain("video6_geometry",
                "colorbalance=rs=0.1:gm=-0.05:bh=0.2,rotate=a=0.1:"
                "fillcolor=16",
                _ins(("in", ("gbrp", _N, 0, 1, False))), bar="lsb"),
    FilterChain("video6_merge",
                "[a][b][m]maskedmerge[o];[c]chromakey=color=0x7080a0:"
                "similarity=0.1:blend=0.05[k]",
                _ins(("a", ("yuv420p", _N, 0, 1, False)),
                     ("b", ("yuv420p", _N, 1, 1, False)),
                     ("m", ("yuv420p", _N, 2, 1, False)),
                     ("c", ("yuv420p", _N, 3, 1, False))),
                outs=("o", "k"), bar="lsb"),
    FilterChain("video6_stack",
                "[a][b]hstack[h];[c][d]hstack[v];[h][v]vstack",
                _ins(("a", ("yuv420p", 4, 0, 2, False)),
                     ("b", ("yuv420p", 4, 1, 2, False)),
                     ("c", ("yuv420p", 4, 2, 2, False)),
                     ("d", ("yuv420p", 4, 3, 2, False)))),
    FilterChain("video6_time",
                "setsar=sar=1/1,setdar=dar=16/9,loop=loop=1:size=2:start=1,"
                "reverse,tpad=start=1:stop=1:stop_mode=add,tile=layout=2x1",
                _ins(("in", ("yuv420p", _N, 0, 1, False)))),
    FilterChain("video5_tonemap",
                "tonemap=tonemap=hable,tonemap=tonemap=mobius",
                _ins(("in", ("gbrpf32le", 4, 0, 1, False))), bar="rel"),
    FilterChain("video7_colorspace",
                "colorspace=all=bt2020:iall=bt709",
                _ins(("in", ("yuv420p", 4, 0, 1, False))), bar="lsb"),
)
# the sources, each generated at the full size: (name, args, frames, bar)
FILTER_SOURCES = (("color", "color=0x336699", 2, "exact"),
                  ("testsrc", "", 2, "exact"),
                  ("testsrc2", "rate=50", 2, "exact"),
                  ("mandelbrot", "maxiter=64", 1, "lsb"))


def filter_chain_inputs(chain: FilterChain, w: int, h: int,
                        frame=None) -> dict:
    """{label: [Frame, ...]} of host planes for `chain` at w x h (an
    input's size divided by its divisor, kept even), pts k in 1/25,
    duration 1.  `frame` builds the frames (the port's Frame by
    default; the fixture tool passes the reference's Frame and
    Rational)."""
    frame, rational = frame or (Frame, Rational)
    out = {}
    for label, (fmt, n, seed, div, il) in chain.inputs:
        iw, ih = (w // div) & ~1, (h // div) & ~1
        out[label] = [frame.video(iw, ih, fmt, planes=p, pts=k, duration=1,
                                  time_base=rational(1, 25), interlaced=il,
                                  top_field_first=il)
                      for k, p in enumerate(filter_clip(seed, n, iw, ih, fmt,
                                                        il))]
    return out


def run_graph(g, feeds: dict, outs, eof_early=()) -> dict:
    """Feed each label's frames in turn (frame k of every label before
    frame k+1), pulling every output after each; a label in `eof_early`
    gets its EOF right after its last frame, the others at the end.
    Works on either package's FilterGraph."""
    got = {o: [] for o in outs}
    n = max(len(v) for v in feeds.values())
    done = set()
    for k in range(n):
        for lbl, frames in feeds.items():
            if k < len(frames):
                g.feed(frames[k].clone_props(), lbl)
            if lbl in eof_early and k == len(frames) - 1:
                g.feed_eof(lbl)
                done.add(lbl)
            for o in outs:
                got[o].extend(g.pull(o))
    for lbl in feeds:
        if lbl not in done:
            g.feed_eof(lbl)
        for o in outs:
            got[o].extend(g.pull(o))
    return got


def chain_scores(g, chain: FilterChain) -> dict:
    """{filter name: its scores} of the metric filters of a run graph."""
    return {n.filter.name: list(n.filter.scores) for n in g.nodes
            if n.filter.name in chain.scores}


def cube_text() -> str:
    """The chains' 5-point LUT: a nonlinear curve per channel, red
    fastest (written to FILTER_CUBE by tools/gen_torch_filters_fixture.py)."""
    return "TITLE \"filters\"\nLUT_3D_SIZE 5\n" + "\n".join(
        f"{(r / 4) ** 2:.6f} {g / 4 * 0.8 + 0.1:.6f} {(b / 4) ** 0.5:.6f}"
        for b in range(5) for g in range(5) for r in range(5)) + "\n"


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


def intra_clip_frame(w: int, h: int) -> Frame:
    """mpeg2_clip's first frame lifted to 10-bit 4:2:2 (yuv422p10le): the
    4:2:0 chroma rows repeated (the last one again where h is odd) and
    every sample times 4.  Numpy uint16 planes, pts 0."""
    f = mpeg2_clip(1, w, h)[0]
    planes = [f.planes[0].astype(np.uint16) * 4]
    for c in f.planes[1:3]:
        c = np.repeat(c, 2, axis=0)
        c = np.concatenate([c, c[-1:]])[:h] if c.shape[0] < h else c
        planes.append(c.astype(np.uint16) * 4)
    return Frame.video(w, h, "yuv422p10le", planes=planes, pts=0,
                       time_base=Rational(1, 25))


def plane_psnr(got, src, bits: int) -> list:
    """Per-plane PSNR (dB) of decoded planes (tensors or arrays) against
    the source planes, at the peak of `bits`."""
    from .core.frame import host_array
    peak = float((1 << bits) - 1)
    out = []
    for a, b in zip(got, src):
        d = host_array(a).astype(np.float64) - np.asarray(b, np.float64)
        mse = float((d * d).mean())
        out.append(float(10 * np.log10(peak * peak / max(mse, 1e-12))))
    return out


def fdct_exact(blocks: np.ndarray):
    """The FDCT of (..., 8, 8) blocks in float64 (ops/idct.py's basis),
    and for each coefficient the sum of its 64 terms' magnitudes, the
    scale of float32's rounding error on it."""
    from .ops.idct import _dct8_matrix
    a = _dct8_matrix()
    x = np.asarray(blocks, np.float64)
    coef = np.einsum("ux,...xy,vy->...uv", a, x, a)
    mag = np.einsum("ux,...xy,vy->...uv", np.abs(a), np.abs(x), np.abs(a))
    return coef, mag


def undecided_levels(got, want, x, tol, mode: str) -> dict:
    """Where two integer level arrays of one quantiser differ, how far
    the exact value `x` (float64, the quantity that was rounded or
    truncated) lies from the decision point: a half-integer for `mode`
    "round", an integer for "trunc".  `tol` (same shape as x, or a
    scalar) is float32's error bound on x.  Returns the count of
    differing levels, the largest step between them, the count of those
    farther than `tol` from a decision point (0 when every difference is
    one that float32 arithmetic cannot decide), and the largest
    distance over its bound."""
    got = np.asarray(got, np.int64)
    want = np.asarray(want, np.int64)
    d = np.abs(got - want)
    sel = d > 0
    xs = np.asarray(x, np.float64)[sel]
    tols = np.broadcast_to(np.asarray(tol, np.float64), d.shape)[sel]
    if mode == "round":
        dist = np.abs(np.abs(xs) - np.floor(np.abs(xs)) - 0.5)
    elif mode == "trunc":
        dist = np.abs(xs - np.round(xs))
    else:
        raise ValueError(mode)
    ratio = dist / np.maximum(tols, 1e-300)
    return {"diff": int(sel.sum()), "step": int(d.max(initial=0)),
            "off": int((ratio > 1).sum()),
            "worst": float(ratio.max(initial=0.0))}


def prores_decisions(blocks, qmat, qscale: int, bits12: bool):
    """The exact values that the ProRes quantiser truncates
    (prores_enc.quantise_plane: the level-shifted FDCT over qmat ×
    qscale) for (..., 8, 8) sample blocks, and float32's bound on each:
    (x, tol), each (..., 64) raster."""
    b = np.asarray(blocks, np.float64)
    coef, mag = fdct_exact(b - 2048.0 if bits12 else (b - 512.0) * 4.0)
    q = np.asarray(qmat, np.float64).reshape(8, 8) * qscale
    x = coef / q
    tol = F32_TOL * (mag / q + np.abs(x))
    return x.reshape(*x.shape[:-2], 64), tol.reshape(*x.shape[:-2], 64)


def dnxhd_levels(coefs, scale, qscale: int) -> np.ndarray:
    """DnxhdEncoder.quant over whole arrays: (..., 8, 8) float32 FDCT
    coefficients → (..., 64) levels in zigzag order, the same float32
    arithmetic that NumPy gives quant's scalar expressions."""
    from .ops.idct import ZIGZAG
    c = np.asarray(coefs, np.float32)
    czz = c.reshape(*c.shape[:-2], 64)[..., ZIGZAG]
    out = np.zeros(czz.shape, np.int64)
    out[..., 0] = np.round(czz[..., 0]).astype(np.int64)
    w = np.asarray(scale[1:], np.int64)
    b = np.where(w // qscale == 32, 0, 32).astype(np.float32)
    a = np.abs(czz[..., 1:])
    lev = np.round(((a * np.float32(64.0) - (w >> 1).astype(np.float32)
                     - b) / w.astype(np.float32) - np.float32(1.0))
                   / np.float32(2.0)).astype(np.int64)
    lev = np.where((czz[..., 1:] == 0) | (lev <= 0), 0, lev)
    out[..., 1:] = np.where(czz[..., 1:] < 0, -lev, lev)
    return out


def dnxhd_decisions(blocks, scale, qscale: int):
    """The exact values that DnxhdEncoder.quant rounds for (..., 8, 8)
    sample blocks (the DC coefficient; each AC level's
    ((|c|·64 − w/2 − b)/w − 1)/2), and float32's bound on each: (x,
    tol), each (..., 64) in zigzag order."""
    from .ops.idct import ZIGZAG
    coef, mag = fdct_exact(blocks)
    czz = coef.reshape(*coef.shape[:-2], 64)[..., ZIGZAG]
    mzz = mag.reshape(*mag.shape[:-2], 64)[..., ZIGZAG]
    w = np.asarray(scale, np.int64)
    b = np.where(w // qscale == 32, 0, 32)
    x = np.empty_like(czz)
    tol = np.empty_like(czz)
    x[..., 0] = czz[..., 0]
    tol[..., 0] = F32_TOL * (mzz[..., 0] + np.abs(czz[..., 0]))
    x[..., 1:] = ((np.abs(czz[..., 1:]) * 64.0 - (w[1:] >> 1) - b[1:])
                  / w[1:] - 1.0) / 2.0
    tol[..., 1:] = F32_TOL * (mzz[..., 1:] * 32.0 / w[1:]
                              + np.abs(x[..., 1:]) + 1.0)
    return x, tol


def jpeg_decisions(blocks, qtab):
    """The exact values that the MJPEG encoder rounds
    (ops/idct.jpeg_forward_transform: the FDCT of samples − 128, in
    zigzag order, over the zigzag table `qtab`) for (..., 8, 8) sample
    blocks, and float32's bound on each: (x, tol), each (..., 64)."""
    from .ops.idct import ZIGZAG
    coef, mag = fdct_exact(np.asarray(blocks, np.float64) - 128.0)
    q = np.asarray(qtab, np.float64)
    x = coef.reshape(*coef.shape[:-2], 64)[..., ZIGZAG] / q
    tol = F32_TOL * (mag.reshape(*mag.shape[:-2], 64)[..., ZIGZAG] / q
                     + np.abs(x))
    return x, tol


def plane_blocks(plane) -> np.ndarray:
    """A (rows*8, cols*8) plane as (rows, cols, 8, 8) blocks."""
    p = np.asarray(plane)
    h, w = p.shape
    return p.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def intra_levels_check(enc_a, enc_b, frame) -> dict:
    """Two ProRes or two DNxHD encoders of the same options (on two
    devices) on one frame: their levels compared plane by plane by
    `undecided_levels` against the exact values of the padded planes'
    blocks, summed ("step" and "worst" the largest)."""
    from .codecs.dnxhd_enc import DnxhdEncoder
    from .codecs.prores_enc import _QMAT_FLAT4
    from .core.frame import host_array
    W, H = -(-enc_a.width // 16) * 16, -(-enc_a.height // 16) * 16
    pads = []
    for i, p in enumerate(frame.planes[:3]):
        p = host_array(p)
        tw = W if i == 0 or getattr(enc_a, "is444", False) else W // 2
        pads.append(np.pad(p, ((0, H - p.shape[0]), (0, tw - p.shape[1])),
                           mode="edge"))
    out = {"diff": 0, "step": 0, "off": 0, "worst": 0.0}
    if isinstance(enc_a, DnxhdEncoder):
        qs, tb = enc_a.qscale, enc_a.tb
        ca, cb = enc_a.transform(frame), enc_b.transform(frame)
        parts = []
        for name, pad in zip("yuv", pads):
            scale = (tb["lw"] if name == "y" else tb["cw"]) * qs
            x, tol = dnxhd_decisions(plane_blocks(pad), scale, qs)
            parts.append((dnxhd_levels(ca[name], scale, qs),
                          dnxhd_levels(cb[name], scale, qs), x, tol,
                          "round"))
    else:
        la, lb = enc_a.transform(frame), enc_b.transform(frame)
        parts = [(a, b) + prores_decisions(plane_blocks(pad), _QMAT_FLAT4,
                                           enc_a.qscale, enc_a.bits12)
                 + ("trunc",) for a, b, pad in zip(la, lb, pads)]
    for part in parts:
        r = undecided_levels(*part)
        out["diff"] += r["diff"]
        out["off"] += r["off"]
        out["step"] = max(out["step"], r["step"])
        out["worst"] = max(out["worst"], r["worst"])
    out["levels"] = sum(int(np.asarray(p[0]).size) for p in parts)
    return out


def mpeg4_stream(name: str) -> dict:
    """One stream of MPEG4_STREAMS: codec_id, width, height, extradata,
    packets (bytes) and their pts, and the reference decoder's picture
    types and per-plane sha256."""
    z = np.load(MPEG4_STREAMS)
    codec_id, w, h = z[f"{name}_params"].tolist()
    data = z[f"{name}_data"].tobytes()
    offs = np.concatenate([[0], np.cumsum(z[f"{name}_sizes"])])
    return {"codec_id": codec_id, "width": int(w), "height": int(h),
            "extradata": z[f"{name}_extradata"].tobytes(),
            "packets": [data[a:b] for a, b in zip(offs[:-1], offs[1:])],
            "pts": [int(t) for t in z[f"{name}_pts"]],
            "types": z[f"{name}_types"].tolist(),
            "sha256": z[f"{name}_sha256"].tolist()}


def audio_bar(name: str) -> tuple:
    """(max |diff| or None, min SNR dB) for one of AUDIO_STREAM_NAMES.
    SBR and PS carry the core's float32 rounding through their LPC and
    envelope gains: on the CPU against the reference they measure max
    |diff| up to 2.3e-5, at 117.7 dB or more, on noise cores
    (tests/test_torch_aac_sbr.py), so their bar is the SNR alone (the
    reference's own bar against the binary is 80 dB for SBR and 60 dB
    for PS)."""
    if name.startswith("aac_"):
        return None, AUDIO_DECODE_MIN_SNR
    return AUDIO_DECODE_TOL, AUDIO_DECODE_MIN_SNR


def audio_stream(name: str) -> dict:
    """One stream of AUDIO_STREAMS: codec_id, sample_rate (the core's, for
    AAC), packets (bytes) and their pts, and the reference decoder's PCM
    of the first AUDIO_PREFIX_PACKETS packets, (channels, n) float32."""
    z = np.load(AUDIO_STREAMS)
    codec_id, rate = z[f"{name}_params"].tolist()
    data = z[f"{name}_data"].tobytes()
    offs = np.concatenate([[0], np.cumsum(z[f"{name}_sizes"])])
    return {"codec_id": codec_id, "sample_rate": int(rate),
            "packets": [data[a:b] for a, b in zip(offs[:-1], offs[1:])],
            "pts": [int(t) for t in z[f"{name}_pts"]],
            "prefix": z[f"{name}_prefix"]}


def audio_decoder(st: dict, device):
    """CodecContext.open_decoder on `device` for an audio_stream."""
    from .codecs import CodecContext
    from .io.stream import CodecParameters, MediaType
    return CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.AUDIO, codec_id=st["codec_id"],
        sample_rate=st["sample_rate"]), device=device)


def audio_packets(st: dict, n=None) -> list:
    """The first `n` (all) packets of an audio_stream as Packets."""
    from .core.packet import Packet
    rate = Rational(1, st["sample_rate"])
    return [Packet(data=p, pts=t, time_base=rate)
            for p, t in zip(st["packets"][:n], st["pts"])]


def audio_decode(st: dict, device, stats=None, n=None) -> list:
    """The first `n` (all) packets of an audio_stream through its decoder
    on `device`: decode_frames (AAC's batched path; the others decode
    packet by packet).  `stats`, when a list, gets the MP3 and AC-3
    decoders' split."""
    dec = audio_decoder(st, device)
    dec.codec.stats = stats
    return dec.decode_frames(audio_packets(st, n))


def audio_pcm(frames) -> np.ndarray:
    """Every sample of the frames, frame by frame and plane by plane, as
    one float32 vector (a stream may change its channel count)."""
    return np.concatenate([np.asarray(f.audio_data, np.float32).ravel()
                           for f in frames])


def transplant_audio_state(ref, port) -> None:
    """Carry a reference audio decoder's state into a port decoder of the
    same codec (`.codec` of each CodecContext), its filterbank state onto
    the port decoder's device: the MP3 decoder's overlap, synthesis FIFO
    and bit reservoir; the AC-3 decoder's delay and dither generator.
    The AAC decoder's is not needed: its overlap is host arrays, which
    the tests hold equal through the decode."""
    import torch
    from .codecs.ac3 import Ac3Decoder
    from .codecs.mp3 import Mp3Decoder

    def dev(a):
        return None if a is None else torch.tensor(
            np.array(a, np.float32), device=port.device)
    if isinstance(port, Mp3Decoder):
        port._overlap, port._fifo = dev(ref._overlap), dev(ref._fifo)
        port._resv, port._resv_valid = ref._resv, ref._resv_valid
    elif isinstance(port, Ac3Decoder):
        port._delay = dev(ref._delay)
        port._dith.state = list(ref._dith.state)
        port._dith.index = ref._dith.index
    else:
        raise TypeError(f"no audio state to carry into {type(port)}")


# The rest of the audio (tools/gen_torch_audio_codecs_fixture.py writes
# AUDIO_CODECS from the JAX package): the Vorbis and Opus streams of the
# reference's tests/test_vorbis.py, test_opus.py and test_opus_silk.py
# with the reference decoder's PCM of their first CODEC_PREFIX_PACKETS
# packets; the AAC encoder's cases of tests/test_aac_enc.py with the
# reference encoder's packets' sha256 and sizes, its band decisions and
# the SNR of the reference decoder's decode of its packets; and the audio
# filter chains' outputs.
AUDIO_CODECS = DATA / "audio_codecs_streams.npz"
VORBIS_STREAM_NAMES = ("vorbis_sine", "vorbis_stereo", "vorbis_noise")
CELT_STREAM_NAMES = ("celt_sine", "celt_mono", "celt_noise", "celt_256k",
                     "celt_16k")
SILK_STREAM_NAMES = ("silk_cfg1_20ms", "silk_cfg5_20ms", "silk_cfg9_20ms",
                     "silk_10ms", "silk_60ms", "silk_nb_40ms", "silk_stereo",
                     "hybrid_cfg13", "hybrid_cfg15", "hybrid_stereo_10ms",
                     "mode_switch")
CODEC_STREAM_NAMES = VORBIS_STREAM_NAMES + CELT_STREAM_NAMES + \
    SILK_STREAM_NAMES
CODEC_PREFIX_PACKETS = 4
# name → (sample rate, channels, samples, quality): the cases of
# tests/test_aac_enc.py (mono at 44.1 and 48 kHz, stereo, and the
# quality ladder 1/3/5 on half a second), all on aac_signal.
AAC_ENC_CASES = {
    "aac_mono_44k": (44100, 1, 44100, 2),
    "aac_mono_48k": (48000, 1, 48000, 2),
    "aac_stereo_48k": (48000, 2, 48000, 2),
    "aac_ladder_q1": (44100, 1, 22050, 1),
    "aac_ladder_q3": (44100, 1, 22050, 3),
    "aac_ladder_q5": (44100, 1, 22050, 5),
}
AAC_CHIP_CASES = ("aac_stereo_48k", "aac_mono_44k")
# the encoder's decode SNR against the reference's, dB
AAC_SNR_TOL_DB = 0.05


def aac_signal(n: int, rate: int, ch: int, seed: int = 0) -> np.ndarray:
    """tests/test_aac_enc.py `_signal`: two tones and noise, (ch, n)
    float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    base = (0.3 * np.sin(2 * np.pi * 440 * t) +
            0.15 * np.sin(2 * np.pi * 1870 * t) +
            0.04 * rng.normal(size=n))
    if ch == 1:
        return base[None, :].astype(np.float32)
    second = (0.25 * np.sin(2 * np.pi * 660 * t) +
              0.04 * rng.normal(size=n))
    return np.stack([base, second]).astype(np.float32)


def aac_encode(sig: np.ndarray, rate: int, quality, device, stats=None):
    """The port's AAC encoder on `device` over one frame of `sig` (fltp,
    pts 0) and the drain, as tests/test_aac_enc.py `_encode` does:
    (packets, the encoder, its band decisions as it made them:
    ((frames, ch, 1024) levels, (frames, ch, bands) scalefactors))."""
    from .codecs import CodecContext
    from .formats.channel_layout import default_layout
    from .io.stream import CodecParameters, MediaType
    from .utils.error import EndOfStream, TryAgain
    ch = sig.shape[0]
    enc = CodecContext.open_encoder(CodecParameters(
        codec_type=MediaType.AUDIO, codec_id="aac", sample_rate=rate,
        ch_layout=default_layout(ch)), {"quality": quality}, device=device)
    codec = enc.codec
    codec.stats = stats
    made = []

    def record(spec):
        out = type(codec).decide(codec, spec)
        made.append(out)
        return out
    codec.decide = record
    pkts = []
    for fr in (Frame.audio(sig, rate, "fltp", default_layout(ch), pts=0,
                           time_base=Rational(1, rate)), None):
        enc.send_frame(fr)
        while True:
            try:
                pkts.append(enc.receive_packet())
            except (TryAgain, EndOfStream):
                break
    del codec.decide
    levels = np.array([np.concatenate(q + [np.zeros(
        1024 - sum(map(len, q)), np.int64)]) for q, _sf, _cb in made],
        np.int64)
    sfs = np.array([sf for _q, sf, _cb in made], np.int64)
    return pkts, codec, (levels.reshape(-1, ch, 1024),
                         sfs.reshape(-1, ch, codec.max_sfb))


def aac_decode(pkts, rate: int, device) -> np.ndarray:
    """The port's AAC decoder on `device` over `pkts` → (ch, n)."""
    from .codecs import CodecContext
    from .io.stream import CodecParameters, MediaType
    frames = CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.AUDIO, codec_id="aac", sample_rate=rate),
        device=device).decode_all(pkts)
    return np.concatenate([f.audio_data for f in frames], axis=1)


def aac_snr(decoded: np.ndarray, sig: np.ndarray) -> float:
    """tests/test_aac_enc.py's measure: the decode past the encoder's
    1024-sample delay against the source, the last 4096 samples left
    out."""
    n = sig.shape[1]
    return snr_db(decoded[:, 1024:1024 + n - 4096], sig[:, :n - 4096])


def aac_exact(enc, sig: np.ndarray):
    """The encoder's windows of `sig` as the encoder forms them (one
    per packet, the flush frame included), and each window's MDCT in
    float64 times the encoder's scale, with the sum of its terms'
    magnitudes: ((frames, ch, 1024) exact, (frames, ch, 1024) mag)."""
    from .ops.tx import _mdct_matrix
    ch, n = sig.shape
    nb = -(-n // 1024)
    x = np.zeros((ch, (nb + 2) * 1024))
    x[:, 1024:1024 + n] = np.asarray(sig, np.float64)
    frames = nb + int(bool(np.any(x[:, nb * 1024:(nb + 1) * 1024])))
    win = np.stack([x[:, i * 1024:i * 1024 + 2048] for i in range(frames)])
    win = (win * enc._window).astype(np.float32).astype(np.float64)
    m = _mdct_matrix(1024)
    exact = np.einsum("kj,bcj->bck", m, win) * enc._spec_scale
    mag = np.einsum("kj,bcj->bck", np.abs(m), np.abs(win)) * enc._spec_scale
    return exact, mag


def aac_decision_check(enc, got, want, exact, mag,
                       scale_rel: float) -> dict:
    """The AAC encoder's bar: where two runs' decisions (as aac_encode
    gives them) differ, each differing scalefactor is one step from the
    other and its exact value 4·log2(target/0.35) lies within float32's
    error of a rounding tie, and each differing level (in a band whose
    scalefactors agree) is one step from the other and its exact value
    |x·2^(-sf/4)|^(3/4) + 0.4054 lies within float32's error of the
    integer it truncates at.  float32's error on each coefficient is
    F32_TOL times the sum of its terms' magnitudes (the MDCT at 1024
    measured up to 5.1e-7 of it between the two packages), plus
    `scale_rel` (the two runs' scale factors' relative difference) of
    its value.  Returns the counts (testing.undecided_levels's keys for
    levels, and `sf_*` for the scalefactors)."""
    (gq, gsf), (wq, wsf) = got, want
    offs = list(enc.swb_offset)
    dx = F32_TOL * mag + scale_rel * np.abs(exact)
    sf_x, sf_tol, sf_got, sf_want = [], [], [], []
    lv_sel = np.zeros(gq.shape, bool)
    for f, c in zip(*np.nonzero((gsf != wsf).any(-1) | (gq != wq).any(-1))):
        spec, err = exact[f, c], dx[f, c]
        e_all = float(np.mean(spec * spec))
        gref = math.sqrt(e_all + 1e-12)
        rel_g = float(np.sum(np.abs(spec) * err)) / max(e_all * 1024, 1e-300)
        for b in range(enc.max_sfb):
            lo, hi = offs[b], offs[b + 1]
            if gsf[f, c, b] != wsf[f, c, b]:
                x = spec[lo:hi]
                energy = float(np.sum(x * x))
                r = 10.0 ** (-(3.6 - 0.35 * enc.quality - 0.03 * b))
                band = math.sqrt(energy / len(x)) * r
                floor = gref * 10.0 ** (-(4.4 - 0.3 * enc.quality))
                rel = (float(np.sum(np.abs(x) * err[lo:hi])) /
                       max(energy, 1e-300) if band >= floor else rel_g)
                sf_x.append(4 * math.log2(max(band, floor, 1e-9) / 0.35))
                sf_tol.append(4 / math.log(2) * rel)
                sf_got.append(gsf[f, c, b])
                sf_want.append(wsf[f, c, b])
            else:
                lv_sel[f, c, lo:hi] = gq[f, c, lo:hi] != wq[f, c, lo:hi]
    sfs = np.repeat(wsf, np.diff(offs[:enc.max_sfb + 1]), axis=-1)
    sfs = np.concatenate([sfs, np.zeros(gq.shape[:2] + (
        1024 - sfs.shape[-1],), np.int64)], axis=-1)
    a = (np.abs(exact) * 2.0 ** (-sfs / 4.0)) ** 0.75
    u = a + 0.4054
    u_tol = 0.75 * a * dx / np.maximum(np.abs(exact), 1e-300)
    lv = undecided_levels(np.where(lv_sel, gq, 0), np.where(lv_sel, wq, 0),
                          u, u_tol, "trunc")
    sf = undecided_levels(np.array(sf_got), np.array(sf_want),
                          np.array(sf_x), np.array(sf_tol), "round")
    return {**lv, **{f"sf_{k}": v for k, v in sf.items()}}


def aac_check(name: str, device, stats=None) -> dict:
    """One case of AAC_ENC_CASES through the port's encoder on `device`,
    held to the reference's committed answers (AUDIO_CODECS): each packet
    byte-equal to the reference's (sha256) or, where not, every decision
    in it within float32's error of its tie (aac_decision_check against
    the reference's decisions; only the cases of AAC_CHIP_CASES carry
    them); the total size within 0.1%; the port's AacDecoder on `device`
    decoding the packets within AAC_SNR_TOL_DB of the reference's decode
    SNR.  Raises AssertionError outside; returns the counts and numbers:
    packets, equal, bytes, ref_bytes, snr, ref_snr and the decision
    check's keys."""
    rate, ch, n, q = AAC_ENC_CASES[name]
    z = np.load(AUDIO_CODECS)
    sig = aac_signal(n, rate, ch)
    pkts, enc, made = aac_encode(sig, rate, q, device, stats)
    sha = [hashlib.sha256(bytes(p.data)).hexdigest() for p in pkts]
    want_sha = z[f"{name}_sha256"].tolist()
    assert len(sha) == len(want_sha), (len(sha), len(want_sha))
    equal = [a == b for a, b in zip(sha, want_sha)]
    out = {"packets": len(pkts), "equal": sum(equal)}
    if not all(equal):
        want = (z[f"{name}_levels"].astype(np.int64),
                z[f"{name}_sf"].astype(np.int64))
        exact, mag = aac_exact(enc, sig)
        r = aac_decision_check(enc, made, want, exact, mag, abs(
            enc._spec_scale / float(z[f"{name}_scale"]) - 1))
        assert r["step"] <= 1 and r["off"] == 0, r
        assert r["sf_step"] <= 1 and r["sf_off"] == 0, r
        differ = set(np.nonzero((made[0] != want[0]).any((1, 2)) |
                                (made[1] != want[1]).any((1, 2)))[0])
        assert {i for i, e in enumerate(equal) if not e} <= differ
        out.update(r)
    out["bytes"] = sum(len(p.data) for p in pkts)
    out["ref_bytes"] = int(z[f"{name}_sizes"].sum())
    assert abs(out["bytes"] - out["ref_bytes"]) <= 1e-3 * out["ref_bytes"]
    out["snr"] = aac_snr(aac_decode(pkts, rate, device), sig)
    out["ref_snr"] = float(z[f"{name}_snr"])
    assert abs(out["snr"] - out["ref_snr"]) <= AAC_SNR_TOL_DB, out
    return out


def codec_stream(name: str) -> dict:
    """One stream of AUDIO_CODECS: codec_id, sample_rate, channels,
    extradata, packets (bytes) with their pts and time base, and the
    reference decoder's PCM of the first CODEC_PREFIX_PACKETS packets,
    (channels, n) float32."""
    z = np.load(AUDIO_CODECS)
    codec_id, rate, ch, tb_num, tb_den = z[f"{name}_params"].tolist()
    data = z[f"{name}_data"].tobytes()
    offs = np.concatenate([[0], np.cumsum(z[f"{name}_sizes"])])
    return {"codec_id": codec_id, "sample_rate": int(rate),
            "channels": int(ch), "extradata": z[f"{name}_extradata"]
            .tobytes(),
            "packets": [data[a:b] for a, b in zip(offs[:-1], offs[1:])],
            "pts": [int(t) for t in z[f"{name}_pts"]],
            "time_base": Rational(int(tb_num), int(tb_den)),
            "prefix": z[f"{name}_prefix"]}


def codec_decoder(st: dict, device):
    """CodecContext.open_decoder on `device` for a codec_stream."""
    from .codecs import CodecContext
    from .formats.channel_layout import default_layout
    from .io.stream import CodecParameters, MediaType
    return CodecContext.open_decoder(CodecParameters(
        codec_type=MediaType.AUDIO, codec_id=st["codec_id"],
        sample_rate=st["sample_rate"],
        ch_layout=default_layout(st["channels"]),
        extradata=st["extradata"]), device=device)


def codec_packets(st: dict, n=None) -> list:
    """The first `n` (all) packets of a codec_stream as Packets."""
    from .core.packet import Packet
    return [Packet(data=p, pts=t, time_base=st["time_base"])
            for p, t in zip(st["packets"][:n], st["pts"])]


def codec_decode(st: dict, device, stats=None, n=None) -> list:
    """The first `n` (all) packets of a codec_stream through its decoder
    on `device`, drained; `stats`, when a list, gets each device call's
    split."""
    dec = codec_decoder(st, device)
    dec.codec.stats = stats
    return dec.decode_all(codec_packets(st, n))


# --- Ogg pages: the reference has no Ogg muxer ------------------------------

def _ogg_crc_table() -> list:
    table = []
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7 if c & 0x80000000 else c << 1) \
                & 0xFFFFFFFF
        table.append(c)
    return table


_OGG_CRC = _ogg_crc_table()


def ogg_page(data: bytes, lacing, serial: int, seq: int, htype: int,
             granule: int) -> bytes:
    """One Ogg page (RFC 3533): `data`, the concatenated segments whose
    sizes are `lacing` (at most 255 of them, each at most 255 bytes; a
    segment below 255 ends a packet), with its CRC."""
    lacing = bytes(lacing)
    assert len(lacing) <= 255 and sum(lacing) == len(data)
    page = bytearray(b"OggS" + bytes([0, htype])
                     + granule.to_bytes(8, "little", signed=True)
                     + serial.to_bytes(4, "little")
                     + seq.to_bytes(4, "little") + bytes(4)
                     + bytes([len(lacing)]) + lacing + data)
    crc = 0
    for b in page:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _OGG_CRC[(crc >> 24) ^ b]
    page[22:26] = crc.to_bytes(4, "little")
    return bytes(page)


def ogg_stream(headers, packets, granules, serial: int = 1,
               page_bytes: int = 4096, eos_granule=None) -> bytes:
    """A logical Ogg bitstream (RFC 3533; RFC 7845 for Opus, the Vorbis I
    spec's section A for Vorbis): the first header packet alone on the
    BOS page, each other header packet on a page of its own, then
    `packets` laced into pages of at most `page_bytes` bytes and 255
    segments.  A packet that does not fit continues on the next page
    (its header_type flags the continuation); a packet of a multiple of
    255 bytes ends with a 0-byte segment.  Each page's granule position
    is `granules[i]` of the last packet `i` it completes, -1 where it
    completes none.  The last page is flagged EOS, with `eos_granule` in
    place of the last packet's where given (an end trim)."""
    pages = []

    def emit(data, lacing, htype, granule):
        pages.append([data, lacing, htype, granule])

    for i, h in enumerate(headers):
        lacing = [255] * (len(h) // 255) + [len(h) % 255]
        assert len(lacing) <= 255
        emit(h, lacing, 2 if i == 0 else 0, 0)
    data, lacing, cont, granule = b"", [], 0, -1
    for i, pkt in enumerate(packets):
        segs = [255] * (len(pkt) // 255) + [len(pkt) % 255]
        pos = 0
        for k, n in enumerate(segs):
            if len(lacing) == 255 or len(data) + n > page_bytes and lacing:
                emit(data, lacing, cont, granule)
                data, lacing, granule = b"", [], -1
                cont = 1 if k else 0
            data += pkt[pos:pos + n]
            lacing.append(n)
            pos += n
        granule = granules[i]
    if lacing:
        emit(data, lacing, cont, granule)
    pages[-1][2] |= 4
    if eos_granule is not None:
        pages[-1][3] = eos_granule
    return b"".join(ogg_page(d, la, serial, seq, ht, g)
                    for seq, (d, la, ht, g) in enumerate(pages))


OPUS_TAGS = b"OpusTags" + (7).to_bytes(4, "little") + b"fftpu-t" \
    + bytes(4)


def codec_stream_ogg(st: dict, page_bytes: int = 4096,
                     eos_granule=None) -> bytes:
    """A codec_stream as an Ogg Vorbis or Ogg Opus file (ogg_stream).
    Opus: OpusHead (the extradata) and OpusTags, granule positions in
    48 kHz samples, the pre-skip's included (RFC 7845 section 4).
    Vorbis: the three header packets of the xiph-laced extradata, each
    packet's granule position the next packet's start in samples (its
    pts, in ms, at the stream's rate; the last packet one packet's step
    further)."""
    from .codecs.vorbis import _split_xiph
    from .io.formats.ogg import _opus_packet_duration
    pkts = st["packets"]
    if st["codec_id"] == "opus":
        headers = [st["extradata"], OPUS_TAGS]
        pos, granules = 0, []
        for p in pkts:
            pos += _opus_packet_duration(p)
            granules.append(pos)
    else:
        headers = _split_xiph(st["extradata"])
        tb, rate = st["time_base"], st["sample_rate"]
        ends = st["pts"][1:] + [2 * st["pts"][-1] - st["pts"][-2]]
        granules = [t * tb.num * rate // tb.den for t in ends]
    return ogg_stream(headers, pkts, granules, page_bytes=page_bytes,
                      eos_granule=eos_granule)


# --- the CLI's containers: chip_smoke.py's phase 27 --------------------------

# the Ogg files of phase 27's command (j): every Vorbis and CELT stream of
# AUDIO_CODECS, one SILK and one hybrid
CLI_OGG_STREAMS = VORBIS_STREAM_NAMES + CELT_STREAM_NAMES + (
    "silk_cfg1_20ms", "hybrid_cfg13")
# the files phase 27's command (k) probes, in its directory
CLI_PROBE_FILES = ("out.avi", "out_aac.ts", "out_mpeg2.ts",
                   "vorbis_sine.ogg")


def cli_container_commands(d) -> dict:
    """Phase 27's command lines, in phase 26's directory `d` and on its
    outputs: (g) the flagship's MJPEG copied into AVI, and the AVI to
    224x224 rgb24 as command (a); (h) command (d)'s MPEG-2 Matroska file
    copied into MPEG-TS, and the TS to framemd5; (i) the ADTS clip copied
    into MPEG-TS, and the TS to 16 kHz mono float as command (e); (j)
    each Ogg file of CLI_OGG_STREAMS (write_cli_ogg) to float."""
    d = str(d)
    return {
        "g_avi": ["-i", str(FIXTURE), "-c", "copy", f"{d}/out.avi"],
        "g_rgb": ["-i", f"{d}/out.avi", "-vf", "scale=224:224",
                  "-pix_fmt", "rgb24", "-f", "rawvideo",
                  f"{d}/out_avi.rgb"],
        "h_ts": ["-i", f"{d}/out_mpeg2.mkv", "-c", "copy",
                 f"{d}/out_mpeg2.ts"],
        "h_md5": ["-i", f"{d}/out_mpeg2.ts", "-f", "framemd5",
                  f"{d}/out_ts.md5"],
        "i_ts": ["-i", str(AAC_CLIP), "-c", "copy", f"{d}/out_aac.ts"],
        "i_f32": ["-i", f"{d}/out_aac.ts", "-ar", "16000", "-ac", "1",
                  "-f", "f32le", f"{d}/out_ts.f32"],
        **{f"j_{n}": ["-i", f"{d}/{n}.ogg", "-f", "f32le",
                      f"{d}/{n}.f32"] for n in CLI_OGG_STREAMS},
    }


def write_cli_ogg(d) -> None:
    """The Ogg files of command (j) in directory `d`, `<name>.ogg`."""
    for name in CLI_OGG_STREAMS:
        Path(d, f"{name}.ogg").write_bytes(codec_stream_ogg(
            codec_stream(name)))


# The audio filter chains that chip_smoke.py runs on the card through
# parse_graph: one per module of filters/audio2.py-audio6.py, each on
# AUDIO_CHAIN_SECONDS of a seeded 48 kHz stereo clip (audio_chain_inputs)
# and each ending in aresample=16000, whose FIR runs on the graph's
# device.  4 s is the length of the reference's tests/test_loudness.py
# `_noise`: long enough for ebur128's 400 ms momentary and 3 s
# short-term blocks, its loudness range and loudnorm's dynamic gain, and
# for dynaudnorm's window of five 100 ms frames to fill.  name → (graph
# text, its inputs: {label: "clip", "left", "right" or "ir"}).  The
# golden holds each chain's output (`chain_<name>`) and the sha256 and
# shape of the output of the chain without its final aresample
# (`chain_<name>_host`, `chain_<name>_host_shape`: audio_chain_digest).
AUDIO_CHAIN_SECONDS = 4.0
AUDIO_CHAIN_FRAME = 1024
AUDIO_CHAINS = {
    "audio2": ("lowpass=frequency=6000,highpass=frequency=120,"
               "bandpass=frequency=1000:width=0.5,"
               "equalizer=frequency=2000:width=1:gain=4,bass=gain=3,"
               "treble=gain=-2,adelay=delays=5|12,aecho=0.8:0.6:30|70:0.4|0.2",
               {"in": "clip"}),
    "audio3": ("ebur128,loudnorm=I=-18:TP=-3", {"in": "clip"}),
    "audio4": ("[in]atempo=1.25[t];[t][ir]afir=dry=0.5:wet=0.8",
               {"in": "clip", "ir": "ir"}),
    "audio5": ("[l][r]amerge=inputs=2,asetpts=PTS,"
               "afade=type=in:duration=0.1,channelmap=map=1|0,"
               "extrastereo=m=2,stereowiden,crystalizer=i=1.5,"
               "tremolo=f=7:d=0.6,vibrato=f=6:d=0.3,"
               "join=inputs=1:channel_layout=stereo",
               {"l": "left", "r": "right"}),
    "audio6": ("dynaudnorm=f=100:g=5,compand,acompressor=threshold=0.1:"
               "ratio=4,agate=threshold=0.05:ratio=3,alimiter=limit=0.7,"
               "silenceremove=start_threshold=0.01:start_duration=0.01",
               {"in": "clip"}),
}


def audio_chain_inputs(seed: int = 0) -> dict:
    """The chains' seeded inputs as fltp frames of AUDIO_CHAIN_FRAME
    samples at 48 kHz: "clip" (stereo: tones and noise with a quiet
    head), "left" and "right" (its channels, mono) and "ir" (a decaying
    noise impulse response of 257 taps, stereo, one frame)."""
    from .formats.channel_layout import default_layout
    rate = 48000
    n = int(AUDIO_CHAIN_SECONDS * rate)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    x = np.stack([0.4 * np.sin(2 * np.pi * 330 * t) +
                  0.1 * rng.standard_normal(n),
                  0.3 * np.sin(2 * np.pi * 523 * t + 0.5) +
                  0.1 * rng.standard_normal(n)])
    x[:, :n // 10] *= 0.001
    x = x.astype(np.float32)
    ir = (rng.standard_normal((2, 257)) *
          np.exp(-np.arange(257) / 40.0)).astype(np.float32)
    tb = Rational(1, rate)

    def frames(a):
        step = AUDIO_CHAIN_FRAME
        return [Frame.audio(np.ascontiguousarray(a[:, i:i + step]), rate,
                            "fltp", default_layout(a.shape[0]), pts=i,
                            time_base=tb)
                for i in range(0, a.shape[1], step)]
    return {"clip": frames(x), "left": frames(x[:1]), "right": frames(x[1:]),
            "ir": frames(ir)}


def audio_chain_text(name: str, resample: bool = True) -> str:
    """A chain's graph text, with or without its final aresample."""
    text = AUDIO_CHAINS[name][0]
    return text + ",aresample=16000" if resample else text


def audio_chain_digest(x: np.ndarray) -> str:
    """sha256 of a chain's output as C-ordered float32 bytes."""
    return hashlib.sha256(np.ascontiguousarray(x, np.float32)
                          .tobytes()).hexdigest()


def audio_chain_host_check(host: np.ndarray, golden, name: str) -> None:
    """Raise AssertionError unless `host` (a chain's output without its
    final aresample) is bit-equal to the golden's: the filters before
    aresample are the same numpy and scipy code in both packages."""
    shape = tuple(int(v) for v in golden[f"chain_{name}_host_shape"])
    if host.shape != shape:
        raise AssertionError(f"chain {name}: host filters give "
                             f"{host.shape}, the golden {shape}")
    if audio_chain_digest(host) != str(golden[f"chain_{name}_host"]):
        raise AssertionError(f"chain {name}: host filters' output is not "
                             f"bit-equal to the golden's (sha256)")


def run_audio_chain(parse, name: str, inputs: dict,
                    resample: bool = True) -> np.ndarray:
    """Chain `name` through `parse` (either package's parse_graph, bound
    to its device): every input's frames fed in label order, frame by
    frame, then each input's EOF; the output frames' samples
    concatenated → (channels, n) float32."""
    g = parse(audio_chain_text(name, resample))
    feeds = AUDIO_CHAINS[name][1]
    out = []
    for label, src in feeds.items():
        for f in inputs[src]:
            g.feed(f, label)
            out.extend(g.pull("out"))
    for label in feeds:
        g.feed_eof(label)
        out.extend(g.pull("out"))
    return np.concatenate([np.asarray(f.audio_data, np.float32)
                           for f in out], axis=1)


# --- protocols and host codecs: chip_smoke.py's phase 28 ---------------------

# the reference binary's streams of the reference's tests/test_dca.py,
# test_mlp.py, test_adpcm.py, test_flac_png.py and test_ogg.py, and the
# reference CLI's decode of each (tools/gen_torch_host_codecs_fixture.py)
HOST_CODECS = DATA / "host_codecs_streams.npz"
# name → (file suffix, the demuxer the reference test names or None, the
# output options of its decode, the output's suffix): the raw format its
# test compares in; TrueHD's s32 samples go into a pcm_s32le WAV, since
# the reference CLI has no s32le muxer
HOST_CODEC_STREAMS = {
    "dts_5_1": ("dts", None, ["-f", "f32le"], "f32"),
    "truehd_stereo": ("thd", "truehd", ["-c:a", "pcm_s32le", "-f", "wav"],
                      "wav"),
    "mlp_stereo": ("mlp", "mlp", ["-f", "s16le"], "s16"),
    "adpcm_ima_wav": ("wav", None, ["-f", "s16le"], "s16"),
    "adpcm_ms": ("wav", None, ["-f", "s16le"], "s16"),
    "flac_stereo": ("flac", None, ["-f", "s16le"], "s16"),
    "flac_ogg": ("ogg", None, ["-f", "s16le"], "s16"),
}
# the GIF the reference binary wrote in tests/test_gif.py
# test_decode_reference_gif (testsrc2, 96x64, 4 frames), in the same file
HOST_GIF = "gif_ref"
# the key of phase 28's AES-128 HLS playlist
HLS_KEY = bytes(range(0x10, 0x20))
# command (p)'s GIF: GIF_FRAMES frames of gif_clip at GIF_W x GIF_H
GIF_FRAMES, GIF_W, GIF_H = 8, 320, 240


def host_codec_file(name: str) -> bytes:
    """A stream of HOST_CODECS (or HOST_GIF) as its file's bytes."""
    return np.load(HOST_CODECS)[name].tobytes()


def host_codec_golden(name: str) -> str:
    """The sha256 of the reference CLI's decode of stream `name` with its
    HOST_CODEC_STREAMS output options."""
    return str(np.load(HOST_CODECS)[f"{name}_ref_sha256"])


def write_host_codec_streams(d) -> None:
    """Each stream of HOST_CODEC_STREAMS as `<name>.<suffix>` in `d`."""
    z = np.load(HOST_CODECS)
    for name, (ext, *_) in HOST_CODEC_STREAMS.items():
        Path(d, f"{name}.{ext}").write_bytes(z[name].tobytes())


def _id3_size(v: int) -> bytes:
    return bytes([(v >> 21) & 0x7F, (v >> 14) & 0x7F, (v >> 7) & 0x7F,
                  v & 0x7F])


def id3_frame(fid: str, payload: bytes, ver: int = 4) -> bytes:
    """One ID3v2 frame (syncsafe size in v2.4, plain in v2.3)."""
    size = _id3_size(len(payload)) if ver == 4 else \
        len(payload).to_bytes(4, "big")
    return fid.encode() + size + b"\x00\x00" + payload


def id3_text(s: str, enc: int = 3) -> bytes:
    """A text frame's payload: latin-1 (enc 0) or UTF-8 (enc 3)."""
    return bytes([enc]) + s.encode("latin-1" if enc == 0 else "utf-8")


def id3_chapter(elem: str, start: int, end: int, title: str,
                ver: int = 4) -> bytes:
    """A CHAP frame's payload with a TIT2 sub-frame."""
    return (elem.encode() + b"\x00" + start.to_bytes(4, "big")
            + end.to_bytes(4, "big") + b"\xff" * 8
            + id3_frame("TIT2", id3_text(title), ver))


def id3_tag(frames, ver: int = 4) -> bytes:
    """An ID3v2.`ver` tag of the given frames."""
    body = b"".join(frames)
    return b"ID3" + bytes([ver, 0, 0]) + _id3_size(len(body)) + body


def tagged_mp3() -> bytes:
    """Command (q)'s MP3: an ID3v2.4 tag (text frames, TXXX, COMM, two
    chapters and an APIC) before AUDIO_STREAMS' crafted MP3 frames."""
    tag = id3_tag([
        id3_frame("TIT2", id3_text("Port Song")),
        id3_frame("TPE1", id3_text("Artist", enc=0)),
        id3_frame("TALB", id3_text("Album")),
        id3_frame("TRCK", id3_text("3/12")),
        id3_frame("TXXX", bytes([3]) + b"mykey\x00myval"),
        id3_frame("COMM", bytes([3]) + b"eng\x00hello comment"),
        id3_frame("CHAP", id3_chapter("c0", 0, 500, "Intro")),
        id3_frame("CHAP", id3_chapter("c1", 500, 1200, "Main part")),
        id3_frame("APIC", b"\x00image/png\x00\x03cover\x00\x89PNG data"),
    ])
    return tag + b"".join(audio_stream("mp3_reservoir")["packets"])


def gif_clip(n: int = GIF_FRAMES, w: int = GIF_W, h: int = GIF_H,
             seed: int = 0) -> np.ndarray:
    """(n, h, w, 3) uint8 RGB frames for the GIF encoder: moving colour
    gradients with a seeded texture and a flat box."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    tex = rng.integers(0, 40, (h, w))
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        out[i, ..., 0] = (xx * 255 // max(w - 1, 1) + 9 * i) % 256
        out[i, ..., 1] = (yy * 255 // max(h - 1, 1) + tex) % 256
        out[i, ..., 2] = ((xx + yy + 13 * i) // 2) % 256
        y0, x0 = (7 * i) % (h // 2), (11 * i) % (w // 2)
        out[i, y0:y0 + h // 4, x0:x0 + w // 4] = (250, 250, 40)
    return out


def write_cli_gif(path, frames=None) -> Path:
    """Command (p)'s clip.gif: gif_clip's frames through the port's GIF
    encoder and muxer on the CPU, at 10 frames/s."""
    from .codecs import CodecContext
    from .io import open_output
    from .io.stream import CodecParameters, MediaType
    rgb = gif_clip() if frames is None else frames
    n, h, w, _ = rgb.shape
    tb = Rational(1, 10)
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="gif",
                          width=w, height=h, pix_fmt="rgb24",
                          framerate=Rational(10, 1))
    enc = CodecContext.open_encoder(par, device="cpu")
    m = open_output(str(path), format="gif")
    m.add_stream(par, time_base=tb)
    frames = [Frame.video(w, h, "rgb24", planes=[rgb[i, ..., c]
                                                 for c in range(3)],
                          pts=i, duration=1, time_base=tb)
              for i in range(n)]
    for p in encode_all(enc, frames):
        m.write_packet(p)
    m.write_trailer()
    m.close()
    return Path(path)


def write_hls_aes(d, name: str = "aac", key: bytes = HLS_KEY) -> Path:
    """Command (m)'s encrypted playlist: each segment of `d/<name>.m3u8`
    (the HLS muxer's) encrypted with AES-128-CBC under `key`, the IV its
    media sequence number (the HLS default), as `<name>_enc<i>.ts`, the
    key as `<name>.key`, and the playlist with an #EXT-X-KEY line as
    `<name>_enc.m3u8`."""
    from .utils.aes import cbc_encrypt
    d = Path(d)
    (d / f"{name}.key").write_bytes(key)
    out, seq = [], 0
    for line in (d / f"{name}.m3u8").read_text().splitlines():
        if line.startswith("#EXT-X-MEDIA-SEQUENCE:"):
            seq = int(line.split(":")[1])
        if line and not line.startswith("#"):
            enc = line.replace(name, f"{name}_enc", 1)
            (d / enc).write_bytes(cbc_encrypt(
                key, seq.to_bytes(16, "big"), (d / line).read_bytes()))
            seq += 1
            line = enc
        out.append(line)
        if line.startswith("#EXT-X-MEDIA-SEQUENCE:"):
            out.append(f'#EXT-X-KEY:METHOD=AES-128,URI="{name}.key"')
    p = d / f"{name}_enc.m3u8"
    p.write_text("\n".join(out) + "\n")
    return p


def hls_aes_files(d) -> None:
    """Command (m)'s encrypted input made on the CPU in directory `d`, as
    phases 27 (i) and 28 (m) make its plain files on the card: the ADTS
    clip copied into MPEG-TS and from it into HLS by the port's CLI, then
    the AES-128 copy of the HLS files (write_hls_aes: CBC encryption is
    one block after another, about 100 s for the clip's 2.1 MB on one
    CPU core)."""
    from .cli.ffmpeg import main
    d = str(d)
    for argv in (cli_container_commands(d)["i_ts"],
                 cli_protocol_commands(d, "", "")["m_hls"]):
        if main(argv, device="cpu") != 0:
            raise RuntimeError(f"fftpu-torch {' '.join(argv)} failed")
    write_hls_aes(d)


def serve_http(*dirs):
    """A loopback ThreadingHTTPServer on a free port, in a thread, that
    serves each path from the first of `dirs` that holds it: (server,
    thread, base URL).  End it with server.shutdown(),
    server.server_close() and thread.join()."""
    import http.server
    import threading
    import urllib.parse
    roots = [Path(x) for x in dirs]

    class Handler(http.server.SimpleHTTPRequestHandler):
        def translate_path(self, path):
            rel = urllib.parse.unquote(path.split("?")[0]).lstrip("/")
            for r in roots:
                if (r / rel).exists():
                    return str(r / rel)
            return str(roots[0] / rel)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t, f"http://127.0.0.1:{srv.server_address[1]}"


def rtmp_relay(server, out: dict, timeout: float = 30.0) -> None:
    """Thread body of command (n): `server` (either package's
    RtmpServer) takes one publishing client and keeps its media
    messages, then one playing client and sends them back; out["media"]
    holds the messages, out["error"] what failed.

    The relay acknowledges no bytes of the publisher: both packages'
    RtmpClient never read from the socket while they publish, so an
    acknowledgement (which RtmpServer sends each half window, 1.25 MB)
    lies unread when the client closes, the client's kernel resets the
    connection, and the server loses the messages it had not read yet.
    With the window at its largest the relay sends none."""
    import socket
    try:
        if server.accept(timeout) != "publish":
            raise AssertionError("rtmp: first client did not publish")
        server.io.window = 1 << 62
        media = []
        while True:
            m = server.recv_media()
            if m is None:
                break
            media.append(m)
        out["media"] = media
        if server.accept(timeout) != "play":
            raise AssertionError("rtmp: second client did not play")
        for mtype, ts, payload in media:
            server.send_media(mtype, ts, payload)
        # end the session as a server that has sent all: no more writes,
        # and read what the client still sends until it closes, so that
        # the close resets nothing the client has not read
        sock = server.io.sock
        sock.shutdown(socket.SHUT_WR)
        while sock.recv(65536):
            pass
        sock.close()
    except Exception as e:      # noqa: BLE001 — reported to the caller
        out["error"] = e


# the file command (q) probes, and its probe's options
PROBE_MP3 = "tagged.mp3"
PROBE_MP3_ARGS = ["-show_format", "-show_chapters"]


def cli_protocol_commands(d, base: str, rtmp_url: str) -> dict:
    """Phase 28's command lines, in phase 26's directory `d` and on the
    outputs of phases 26-27, with `base` the URL of a server of `d` and
    tests/data (serve_http) and `rtmp_url` an RTMP relay's stream:
    (l) the flagship over HTTP to 224x224 rgb24, as command (a); (m)
    phase 27's MPEG-TS AAC copied into HLS, and the AES-128 playlist of
    its segments (write_hls_aes) over HTTP to 16 kHz mono float, as
    command (i); (n) the TS published as FLV to the RTMP relay, and
    played from it to float; (o) the TS to 16 kHz mono FLAC (the raw
    s16le muxer writes the encoder's fLaC header and frames as they
    come: the reference has no FLAC muxer), the FLAC to s16le, and the
    TS to s16le directly; (p) clip.gif (write_cli_gif) to framemd5 and
    to 224x224 rgb24; (q) each stream of HOST_CODEC_STREAMS
    (write_host_codec_streams) to its raw format
    (host_codec_command)."""
    d = str(d)
    cmds = {
        "l": ["-i", f"{base}/port/flagship_1080p_8.mjpeg", "-vf",
              "scale=224:224", "-pix_fmt", "rgb24", "-f", "rawvideo",
              f"{d}/out_http.rgb"],
        "m_hls": ["-i", f"{d}/out_aac.ts", "-c", "copy", "-f", "hls",
                  f"{d}/aac.m3u8"],
        "m_f32": ["-i", f"{base}/aac_enc.m3u8", "-ar", "16000", "-ac", "1",
                  "-f", "f32le", f"{d}/out_hls.f32"],
        "n_pub": ["-i", f"{d}/out_aac.ts", "-c", "copy", "-f", "flv",
                  rtmp_url],
        "n_f32": ["-i", rtmp_url, "-ar", "16000", "-ac", "1", "-f", "f32le",
                  f"{d}/out_rtmp.f32"],
        "o_flac": ["-i", f"{d}/out_aac.ts", "-ar", "16000", "-ac", "1",
                   "-c:a", "flac", "-f", "s16le", f"{d}/out.flac"],
        "o_s16": ["-i", f"{d}/out.flac", "-f", "s16le",
                  f"{d}/out_flac.s16"],
        "o_direct": ["-i", f"{d}/out_aac.ts", "-ar", "16000", "-ac", "1",
                     "-f", "s16le", f"{d}/out_direct.s16"],
        "p_md5": ["-i", f"{d}/clip.gif", "-f", "framemd5",
                  f"{d}/out_gif.md5"],
        "p_rgb": ["-i", f"{d}/clip.gif", "-vf", "scale=224:224", "-pix_fmt",
                  "rgb24", "-f", "rawvideo", f"{d}/out_gif.rgb"],
    }
    for name in HOST_CODEC_STREAMS:
        cmds[f"q_{name}"] = host_codec_command(d, name)
    return cmds


def host_codec_command(d, name: str) -> list:
    """The decode of stream `name` of HOST_CODEC_STREAMS in directory `d`
    to `d/out_<name>.<suffix>`."""
    ext, fmt, opts, out = HOST_CODEC_STREAMS[name]
    return ([] if fmt is None else ["-f", fmt]) + [
        "-i", f"{d}/{name}.{ext}", *opts, f"{d}/out_{name}.{out}"]


def flac_streaminfo(data: bytes) -> dict:
    """A FLAC file's STREAMINFO fields: rate, channels, bits, total
    samples and MD5 (hex)."""
    if data[:4] != b"fLaC" or data[4] & 0x7F != 0:
        raise AssertionError("not a FLAC file with STREAMINFO first")
    si = data[8:8 + 34]
    v = int.from_bytes(si[10:18], "big")
    return {"rate": v >> 44, "channels": ((v >> 41) & 7) + 1,
            "bits": ((v >> 36) & 31) + 1, "samples": v & ((1 << 36) - 1),
            "md5": si[18:34].hex()}


# --- image codecs, FFV1, VP8 and WebP: chip_smoke.py's phase 29 --------------

# the reference binary's FFV1, TIFF, QOI and PNG files of the reference's
# tests/test_ffv1.py, test_qoi_tiff.py and test_flac_png.py with the
# binary's decodes' sha256, EXR files of test_exr.py's writer, the VP8
# streams crafted by test_vp8.py's and test_vp8_inter.py's helpers, and
# PGS and mov_text packets (tools/gen_torch_image_codecs_fixture.py)
IMAGE_CODECS = DATA / "image_codecs_streams.npz"
# test_ffv1.py test_ffv1_matrix's cases, and three of its high-depth
# and alpha cases: name → (the file name its test writes, the
# binary's encoder options)
IMAGE_FFV1_STREAMS = {
    "v3-range": ("f.avi", []),
    "v3-rice": ("f.avi", ["-coder", "-2"]),
    "v3-custom": ("f.avi", ["-coder", "1"]),
    "v1-rice": ("f.avi", ["-level", "1"]),
    "v1-custom": ("f.avi", ["-level", "1", "-coder", "1"]),
    "context1": ("f.avi", ["-context", "1", "-coder", "1"]),
    "gop6": ("f.avi", ["-g", "6", "-coder", "1"]),
    "slices4": ("f.avi", ["-slices", "4", "-coder", "1"]),
    "444p16-slices": ("hd.avi", ["-pix_fmt", "yuv444p16le", "-coder", "1",
                                 "-slices", "4"]),
    "420p10-v1-range": ("hd.avi", ["-pix_fmt", "yuv420p10le", "-level",
                                   "1", "-coder", "1"]),
    "yuva444p10le": ("ya.avi", ["-pix_fmt", "yuva444p10le", "-coder", "1",
                                "-slices", "4"]),
}
# phase 29 (s)'s streams of IMAGE_FFV1_STREAMS
CLI_FFV1_STREAMS = ("v3-range", "v1-rice", "gop6", "slices4")
# test_qoi_tiff.py's TIFF (pix_fmt, compression) and QOI cases, and
# test_flac_png.py's PNG pixel formats
IMAGE_TIFF_CASES = (("rgb24", "raw"), ("rgb24", "packbits"),
                    ("rgb24", "lzw"), ("rgb24", "deflate"),
                    ("gray8", "packbits"), ("pal8", "lzw"),
                    ("yuv420p", "lzw"), ("yuv422p", "packbits"),
                    ("yuv444p", "raw"), ("rgb48le", "raw"),
                    ("rgba", "packbits"), ("monob", "raw"))
IMAGE_QOI_PIX = ("rgb24", "rgba")
IMAGE_PNG_PIX = ("rgb24", "rgba", "gray", "rgb48be", "gray16be")
# the EXR picture of command (r_exr), and the VP8 clip of (t) and (u)
EXR_W, EXR_H = 480, 270
VP8_W, VP8_H, VP8_CLIP_SEED = 640, 352, 61
# the cues of the mov_text packets
MOVTEXT_TEXTS = ("Hello world", "Héllo wörld\nsecond", "")


def image_stream(name: str) -> bytes:
    """A file of IMAGE_CODECS as its bytes."""
    return np.load(IMAGE_CODECS)[name].tobytes()


def image_golden(name: str) -> str:
    """The sha256 of the reference binary's decode of IMAGE_CODECS'
    file `name`."""
    return str(np.load(IMAGE_CODECS)[f"{name}_ref_sha256"])


def movtext_packets() -> list:
    """The fixture's mov_text packets as bytes."""
    z = np.load(IMAGE_CODECS)
    data, out, off = z["movtext_packets"].tobytes(), [], 0
    for n in z["movtext_lengths"].tolist():
        out.append(data[off:off + n])
        off += n
    return out


# command (r)'s pictures: IMAGE_W x IMAGE_H rgb24 for PNG, TIFF, BMP and
# PPM, QOI_W x QOI_H rgba for QOI; (s)'s FFV1_FRAMES frames of
# mpeg2_clip; (u)'s WEBP_LL_W x WEBP_LL_H rgba for lossless WebP
IMAGE_W, IMAGE_H = 1920, 1080
QOI_W, QOI_H = 480, 270
FFV1_W, FFV1_H, FFV1_FRAMES = 352, 288, 3
WEBP_LL_W, WEBP_LL_H = 320, 180
# (r)'s encoders: output suffix → codec
IMAGE_ENCODES = {"png": "png", "tif": "tiff", "bmp": "bmp", "ppm": "ppm"}
# (v)'s probe: its options and files
IMAGE_PROBE_ARGS = ["-show_format", "-show_streams"]
IMAGE_PROBE_FILES = ("out.png", "out_ffv1.mkv", "vp8.ivf", "out_ll.webp")


def image_picture(w: int, h: int, channels: int, seed: int = 0
                  ) -> np.ndarray:
    """(h, w, channels) uint8: colour gradients, a seeded texture and a
    flat box (alpha, where there is one, a gradient with the box
    opaque)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    tex = rng.integers(0, 24, (h, w))
    out = np.empty((h, w, channels), np.uint8)
    out[..., 0] = (xx * 255 // max(w - 1, 1) + tex) % 256
    out[..., 1] = (yy * 255 // max(h - 1, 1)) % 256
    out[..., 2] = ((xx + yy) // 3 + tex // 2) % 256
    if channels == 4:
        out[..., 3] = (xx * 200 // max(w - 1, 1) + 40) % 256
    out[h // 3:h // 2, w // 4:w // 2] = 255 if channels == 4 else 250
    return out


def write_image_sources(d) -> None:
    """Phase 29's inputs in directory `d`: (r) src.rgb and src.rgba
    (image_picture), (r_exr) clip.exr, (s) ffv1_src.yuv (mpeg2_clip) and
    ffv1_<case>.avi for each of CLI_FFV1_STREAMS, (t) vp8.ivf, (u)
    vp8_kf.webp and src_ll.rgba."""
    d = Path(d)
    (d / "src.rgb").write_bytes(image_picture(IMAGE_W, IMAGE_H, 3).tobytes())
    (d / "src.rgba").write_bytes(image_picture(QOI_W, QOI_H, 4,
                                               seed=1).tobytes())
    (d / "src_ll.rgba").write_bytes(image_picture(WEBP_LL_W, WEBP_LL_H, 4,
                                                  seed=2).tobytes())
    (d / "ffv1_src.yuv").write_bytes(b"".join(
        f.to_bytes() for f in mpeg2_clip(FFV1_FRAMES, FFV1_W, FFV1_H)))
    z = np.load(IMAGE_CODECS)
    (d / "clip.exr").write_bytes(z["exr_clip"].tobytes())
    for name in CLI_FFV1_STREAMS:
        (d / f"ffv1_{name}.avi").write_bytes(z[f"ffv1_{name}"].tobytes())
    (d / "vp8.ivf").write_bytes(z["vp8_clip"].tobytes())
    (d / "vp8_kf.webp").write_bytes(z["webp_lossy"].tobytes())


def image_commands(d) -> dict:
    """Phase 29's command lines in directory `d` (write_image_sources):
    (r) src.rgb to each of IMAGE_ENCODES and each file back to rgb24,
    src.rgba to QOI and back to rgba, (r_exr) clip.exr to rawvideo
    (gbrpf32le); (s) ffv1_src.yuv to FFV1 in Matroska, that file to
    framemd5, and each of CLI_FFV1_STREAMS to rawvideo; (t) vp8.ivf to
    framemd5 and to MPEG-2 in Matroska; (u) vp8_kf.webp to rawvideo and
    src_ll.rgba to lossless WebP.  The raw inputs take the rawvideo
    demuxer's -pixel_format and -s (the CLI's -pix_fmt is an output
    option), and their outputs name their muxer: the CLI keeps an input's
    -f for the output that follows."""
    d = str(d)

    def raw_in(name, fmt, w, h):
        return ["-f", "rawvideo", "-pixel_format", fmt, "-s", f"{w}x{h}",
                "-i", f"{d}/{name}"]
    cmds = {}
    for ext, codec in IMAGE_ENCODES.items():
        cmds[f"r_{ext}"] = raw_in("src.rgb", "rgb24", IMAGE_W, IMAGE_H) + [
            "-c:v", codec, "-f", "image2", f"{d}/out.{ext}"]
        cmds[f"r_{ext}_rgb"] = ["-i", f"{d}/out.{ext}", "-f", "rawvideo",
                                "-pix_fmt", "rgb24", f"{d}/out_{ext}.rgb"]
    cmds["r_qoi"] = raw_in("src.rgba", "rgba", QOI_W, QOI_H) + [
        "-c:v", "qoi", "-f", "image2", f"{d}/out.qoi"]
    cmds["r_qoi_rgba"] = ["-i", f"{d}/out.qoi", "-f", "rawvideo",
                          "-pix_fmt", "rgba", f"{d}/out_qoi.rgba"]
    cmds["r_exr"] = ["-i", f"{d}/clip.exr", "-f", "rawvideo",
                     f"{d}/out_exr.raw"]
    cmds["s_enc"] = raw_in("ffv1_src.yuv", "yuv420p", FFV1_W, FFV1_H) + [
        "-c:v", "ffv1", "-f", "matroska", f"{d}/out_ffv1.mkv"]
    cmds["s_md5"] = ["-i", f"{d}/out_ffv1.mkv", "-f", "framemd5",
                     f"{d}/out_ffv1.md5"]
    for name in CLI_FFV1_STREAMS:
        cmds[f"s_{name}"] = ["-i", f"{d}/ffv1_{name}.avi", "-f", "rawvideo",
                             f"{d}/out_ffv1_{name}.yuv"]
    cmds["t_md5"] = ["-i", f"{d}/vp8.ivf", "-f", "framemd5",
                     f"{d}/out_vp8.md5"]
    cmds["t_m2v"] = ["-i", f"{d}/vp8.ivf", "-c:v", "mpeg2video",
                     f"{d}/out_vp8_m2v.mkv"]
    cmds["u_webp"] = ["-i", f"{d}/vp8_kf.webp", "-f", "rawvideo",
                      f"{d}/out_webp.yuv"]
    cmds["u_ll"] = raw_in("src_ll.rgba", "rgba", WEBP_LL_W, WEBP_LL_H) + [
        "-c:v", "webp", "-f", "webp", f"{d}/out_ll.webp"]
    return cmds


def image_source_md5s() -> list:
    """The md5 of each frame of ffv1_src.yuv, as framemd5 writes them."""
    return [hashlib.md5(f.to_bytes()).hexdigest()
            for f in mpeg2_clip(FFV1_FRAMES, FFV1_W, FFV1_H)]


# --- bitstream filters, AV1 and VVC: chip_smoke.py's phase 30 --------------

# the crafted VVC GOPs and their reference decodes' sha256, and the
# crafted AV1 OBU stream (tools/gen_torch_vvc_av1_fixture.py)
VVC_AV1 = DATA / "vvc_av1_streams.npz"
# name → (seed, slice kinds, width, height, plan options, craft_gop
# options): low-delay I P B B with MTT and two references in each list,
# and a 10-bit GOP (tests/test_vvc_inter.py's recipes at full size)
VVC_GOPS = {
    "vvc_832x480": (30, "IPBB", 832, 480, {"stop_p": 0.4},
                    {"mtt_depth_inter": 2, "mtt_depth_intra": 2,
                     "nrefs": (2, 2)}),
    "vvc10_416x240": (31, "IPBB", 416, 240, {"amp": 40},
                      {"bit_depth": 10, "nrefs": (2, 2)}),
}
# the AV1 stream: AV1_TUS temporal units of AV1_W x AV1_H, a key frame
# every AV1_GOP units, two frames in every AV1_PAIR-th unit
AV1_W, AV1_H, AV1_TUS, AV1_GOP, AV1_PAIR = 1920, 1080, 30, 15, 5
# command (w)'s noise input: BSF_CLIP frames of mpeg2_clip
BSF_W, BSF_H, BSF_FRAMES = 352, 288, 3
# the AV1 probe: its options
AV1_PROBE_ARGS = ["-show_streams", "-show_packets", "-of", "json"]


def vvc_plan_class(base):
    """tests/test_vvc_inter.py's InterPlan (random inter intents over the
    full toolset) over the Plan class `base` of either package's
    codecs/vvc/ctu.py."""

    class InterPlan(base):
        def __init__(self, rng, modes=("skip", "merge", "amvp", "intra"),
                     stop_p=1.0, mvd_amp=8, max_merge=6, **kw):
            super().__init__(rng, **kw)
            self.modes = modes
            self.stop_p = stop_p
            self.mvd_amp = mvd_amp
            self.max_merge = max_merge

        def split_mode(self, x0, y0, log2w, log2h, allowed, forced):
            opts = [o for o in allowed if o != "none"]
            if forced:
                return "qt" if "qt" in allowed else opts[0]
            if not opts or self.rng.random() < self.stop_p:
                return "none"
            return str(self.rng.choice(opts))

        def cu_mode(self, x0, y0, log2w, log2h):
            return str(self.rng.choice(self.modes))

        def merge_index(self, x0, y0, max_cand):
            return int(self.rng.integers(0, min(max_cand,
                                                self.max_merge)))

        def amvp_choice(self, x0, y0, is_b, w, h, nact):
            pred = str(self.rng.choice(["l0", "l1", "bi"] if is_b
                                       else ["l0"]))
            a = self.mvd_amp
            return {"pred": pred,
                    "ref_idx": [int(self.rng.integers(0, max(1, nact[i])))
                                for i in range(2)],
                    "mvd": [(int(self.rng.integers(-a, a + 1)),
                             int(self.rng.integers(-a, a + 1)))
                            for _ in range(2)],
                    "mvp": [int(self.rng.integers(0, 2))
                            for _ in range(2)]}

        def cu_coded(self, x0, y0):
            return bool(self.rng.integers(0, 2))

        def cbf(self, x0, y0, log2, c):
            return bool(self.rng.integers(0, 2))

    return InterPlan


def craft_vvc(craft, base, seed: int, kinds: str, w: int, h: int,
              plan_kw=None, **kw) -> bytes:
    """A low-delay GOP crafted by `craft` (either package's
    codecs/vvc/craft.py) with InterPlan over `base` from `seed`
    (tests/test_vvc_inter.py's _gop)."""
    rng = np.random.default_rng(seed)
    cls = vvc_plan_class(base)
    frames = [(k, cls(rng, **(plan_kw or {}))) for k in kinds]
    return craft.craft_gop(frames, w, h, log2_min_cb=3, log2_min_qt=3, **kw)


def craft_av1(A, w: int = AV1_W, h: int = AV1_H, n: int = AV1_TUS,
              seed: int = 0) -> list:
    """Temporal units by `A` (either package's codecs/av1.py) with its
    own writers (tests/test_av1.py's recipe): a temporal delimiter, the
    sequence header in the first unit, then a frame header and a tile
    group of seeded bytes per frame; a key frame every AV1_GOP units,
    inter frames refreshing one slot each, and two frames in every
    AV1_PAIR-th unit (for av1_frame_split)."""
    rng = np.random.default_rng(seed)
    seq = A.Av1SequenceHeader(
        max_frame_width=w, max_frame_height=h, frame_width_bits=11,
        frame_height_bits=11, enable_order_hint=1, order_hint_bits=7)
    tus, hint = [], 0
    for i in range(n):
        obus = [A.wrap_obu(A.OBU_TEMPORAL_DELIMITER, b"")]
        if i == 0:
            obus.append(A.wrap_obu(A.OBU_SEQUENCE_HEADER,
                                   A.write_sequence_header(seq)))
        for k in range(2 if i % AV1_PAIR == AV1_PAIR - 1 else 1):
            if i % AV1_GOP == 0 and k == 0:
                hd = A.Av1FrameHeader(frame_type=A.KEY_FRAME, show_frame=1)
                size = 6000
            else:
                hd = A.Av1FrameHeader(
                    frame_type=A.INTER_FRAME, show_frame=1,
                    order_hint=hint % 128, refresh_frame_flags=1 << (hint % 8),
                    ref_frame_idx=[0] * 7)
                size = 1200
            hint += 1
            obus.append(A.wrap_obu(A.OBU_FRAME_HEADER,
                                   A.write_frame_header(hd, seq)))
            obus.append(A.wrap_obu(A.OBU_TILE_GROUP, rng.integers(
                0, 256, size, np.uint8).tobytes()))
        tus.append(b"".join(obus))
    return tus


def vvc_av1_stream(name: str) -> bytes:
    """A stream of VVC_AV1 as its bytes: a name of VVC_GOPS, or "av1"
    (the OBU stream's temporal units joined)."""
    return np.load(VVC_AV1)[name].tobytes()


def av1_units() -> list:
    """The AV1 stream's temporal units."""
    z = np.load(VVC_AV1)
    data, out, off = z["av1"].tobytes(), [], 0
    for n in z["av1_lengths"].tolist():
        out.append(data[off:off + n])
        off += n
    return out


def vvc_golden(name: str) -> list:
    """The sha256 of each plane of each picture of the reference's
    decode of VVC_GOPS' stream `name` (y, u, v of picture 0, then 1...)."""
    return [str(s) for s in np.load(VVC_AV1)[f"{name}_sha256"]]


def write_vvc_av1_sources(d) -> None:
    """Phase 30's inputs in directory `d`: vvc.266 and vvc10.266 (the
    VVC GOPs), av1.obu, and bsf_clip.y4m (mpeg2_clip)."""
    d = Path(d)
    (d / "vvc.266").write_bytes(vvc_av1_stream("vvc_832x480"))
    (d / "vvc10.266").write_bytes(vvc_av1_stream("vvc10_416x240"))
    (d / "av1.obu").write_bytes(vvc_av1_stream("av1"))
    write_y4m(d / "bsf_clip.y4m", mpeg2_clip(BSF_FRAMES, BSF_W, BSF_H))


def bsf_av1_vvc_commands(d) -> dict:
    """Phase 30's command lines in directory `d` (write_vvc_av1_sources,
    and phase 26 (c)'s out.mp4 of the 1920x1088 H.264 stream): (w) the
    bitstream filters (w_unknown names a filter neither package has), (x)
    the AV1 stream copied and filtered, (y) the VVC GOPs to framemd5 and
    to MPEG-2 in Matroska."""
    d = str(d)
    return {
        "w_h264": ["-i", f"{d}/out.mp4", "-c", "copy", "-bsf:v",
                   "h264_mp4toannexb", f"{d}/out_annexb.ts"],
        "w_hevc_mp4": ["-i", str(HEVC_BENCH), "-c", "copy",
                       f"{d}/hevc.mp4"],
        "w_hevc": ["-i", f"{d}/hevc.mp4", "-c", "copy", "-bsf:v",
                   "hevc_mp4toannexb", f"{d}/hevc_annexb.ts"],
        "w_vp9": ["-i", str(VP9_BENCH), "-c", "copy", "-bsf:v",
                  "vp9_superframe_split", f"{d}/vp9_split.ivf"],
        "w_noise": ["-i", f"{d}/bsf_clip.y4m", "-c", "copy", "-bsf:v",
                    "noise=amount=50:seed=7", f"{d}/noise.y4m"],
        "w_setts": ["-i", f"{d}/out.mp4", "-c", "copy", "-bsf:v",
                    "setts=offset=7", "-f", "framemd5", f"{d}/setts.md5"],
        "w_dts2pts": ["-i", f"{d}/out.mp4", "-c", "copy", "-bsf:v",
                      "dts2pts", "-f", "framemd5", f"{d}/dts2pts.md5"],
        "w_unknown": ["-i", f"{d}/bsf_clip.y4m", "-c", "copy", "-bsf:v",
                      "nosuch_bsf", f"{d}/refused.y4m"],
        "x_ivf": ["-i", f"{d}/av1.obu", "-c", "copy", f"{d}/av1.ivf"],
        "x_mp4": ["-i", f"{d}/av1.obu", "-c", "copy", f"{d}/av1.mp4"],
        "x_mkv": ["-i", f"{d}/av1.obu", "-c", "copy", f"{d}/av1.mkv"],
        "x_split": ["-i", f"{d}/av1.obu", "-c", "copy", "-bsf:v",
                    "av1_frame_split", f"{d}/av1_split.ivf"],
        "x_meta": ["-i", f"{d}/av1.obu", "-c", "copy", "-bsf:v",
                   "av1_metadata=color_range=pc:color_primaries=9",
                   f"{d}/av1_meta.ivf"],
        "y_md5": ["-i", f"{d}/vvc.266", "-f", "framemd5",
                  f"{d}/out_vvc.md5"],
        "y_10": ["-i", f"{d}/vvc10.266", "-f", "framemd5",
                 f"{d}/out_vvc10.md5"],
        "y_m2v": ["-i", f"{d}/vvc.266", "-c:v", "mpeg2video",
                  f"{d}/out_vvc_m2v.mkv"],
    }


# the outputs of (w) and (x) whose sha256 the goldens hold, by command
BSF_FILES = {"w_h264": "out_annexb.ts", "w_hevc_mp4": "hevc.mp4",
             "w_hevc": "hevc_annexb.ts", "w_vp9": "vp9_split.ivf",
             "w_noise": "noise.y4m", "w_setts": "setts.md5",
             "w_dts2pts": "dts2pts.md5", "x_ivf": "av1.ivf",
             "x_mp4": "av1.mp4", "x_mkv": "av1.mkv",
             "x_split": "av1_split.ivf", "x_meta": "av1_meta.ivf"}
