#!/usr/bin/env python
"""Write the intra codecs' golden and the MPEG-4/H.263 streams that the
PyTorch port is checked against.

Runs the JAX package on the CPU and writes two files:

- tests/data/port/intra_1080p_golden.npz, which holds hashes, sizes and
  PSNRs only, for one frame of ffmpeg_tpu_torch.testing.intra_clip_frame
  at 1920x1080 (testing.mpeg2_clip's first frame lifted to 10-bit 4:2:2:
  samples times 4, chroma rows repeated; made from a seed on every
  machine, not committed):
  - `clip_sha256`: a checksum of that frame's planes;
  - for `prores` (ProresEncoder, yuv422p10le, qscale 4) and `dnxhd`
    (DnxhdEncoder, yuv422p10le, CID 1271, qscale 4): `<codec>_packet_
    sha256` and `<codec>_packet_bytes`, and of the reference decoder's
    planes of that packet `<codec>_plane_sha256` (3,) and
    `<codec>_psnr` (3,), the PSNR in dB of each plane against the
    source at the 10-bit peak;
- tests/data/port/mpeg4_streams.npz: three of tests/test_mpeg4.py's
  streams (`mpeg4_bframes`, `mpeg4_4mv`, `h263_cif_rc`), made by the
  same recorded invocations of the reference binary, replayed byte for
  byte through tests/golden.py (the invocation is the key), and demuxed
  by the reference's demuxer: for each, `<name>_data` (the packets'
  bytes, concatenated), `<name>_sizes`, `<name>_pts`, `<name>_params`
  (codec id, width, height), `<name>_extradata`, and of the reference
  decoder's frames `<name>_types` and `<name>_sha256` (frames, 3).

The card's machine has no JAX, so the reference's answers are committed.
Usage (about a minute and a half here: the reference's 1080p DNxHD
quantise loop and the ProRes entropy decode run in Python):

    JAX_PLATFORMS=cpu python tools/gen_torch_intra_fixture.py
"""

from __future__ import annotations

import hashlib
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import conftest  # noqa: E402,F401  (installs tests/golden.py's replay)
from ffmpeg_tpu_torch import testing as fx  # noqa: E402

W, H = 1920, 1080
FMT = "yuv422p10le"


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def intra(codec_id: str, src) -> dict:
    """The reference encoder's packet of `src` and its decoder's planes."""
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.core.frame import Frame
    from ffmpeg_tpu.io.stream import CodecParameters, MediaType
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id=codec_id,
                          width=W, height=H, pix_fmt=FMT)
    enc = CodecContext.open_encoder(par, options={"qscale": fx.INTRA_QSCALE})
    t = time.perf_counter()
    pkt = enc.codec.encode(Frame.video(W, H, FMT, planes=src.planes,
                                       pts=0))[0]
    print(f"{codec_id} encode: {len(pkt.data)} bytes in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    dpar = CodecParameters(codec_type=MediaType.VIDEO, codec_id=codec_id,
                           width=W, height=H, codec_tag=par.codec_tag)
    t = time.perf_counter()
    out = CodecContext.open_decoder(dpar).codec.decode(pkt)[0]
    print(f"{codec_id} decode in {time.perf_counter() - t:.1f} s",
          flush=True)
    assert out.format == FMT
    planes = [np.asarray(p) for p in out.planes]
    psnr = fx.plane_psnr(planes, src.planes, 10)
    print(f"{codec_id} psnr: {psnr}", flush=True)
    return {f"{codec_id}_packet_sha256": np.array(_sha(np.frombuffer(
                pkt.data, np.uint8))),
            f"{codec_id}_packet_bytes": np.array(len(pkt.data), np.int64),
            f"{codec_id}_plane_sha256": np.array([_sha(p) for p in planes]),
            f"{codec_id}_psnr": np.array(psnr, np.float64)}


def _h263_cif_rc(tmp: Path) -> Path:
    """tests/test_mpeg4.py::test_h263_cif_rc's invocation, as it is."""
    import subprocess
    import refutil
    p = tmp / "h263cif.avi"
    subprocess.run(
        [str(refutil.REF), "-v", "error", "-f", "lavfi", "-i",
         "testsrc2=size=352x288:rate=25", "-frames:v", "8",
         "-c:v", "h263", "-b:v", "400k", "-y", str(p)], check=True)
    return p


def mpeg4_streams() -> dict:
    import test_mpeg4 as tm
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.io.demux import open_input
    from ffmpeg_tpu.utils.error import EndOfStream
    makers = {
        "mpeg4_bframes": lambda d: tm._make(d, "b.avi",
                                            ["-q:v", "4", "-bf", "2"],
                                            frames=15),
        "mpeg4_4mv": lambda d: tm._make(d, "mv4.avi",
                                        ["-q:v", "4", "-flags", "+mv4"]),
        "h263_cif_rc": _h263_cif_rc,
    }
    assert tuple(makers) == fx.MPEG4_STREAM_NAMES
    out = {}
    for name, make in makers.items():
        with tempfile.TemporaryDirectory() as d:
            inp = open_input(str(make(Path(d))))
            par = inp.streams[0].codecpar
            pkts = []
            while True:
                try:
                    pkts.append(inp.read_packet())
                except EndOfStream:
                    break
        t = time.perf_counter()
        frames = CodecContext.open_decoder(par).decode_all(pkts)
        print(f"{name}: {par.codec_id} {par.width}x{par.height}, "
              f"{len(pkts)} packets, {len(frames)} frames decoded in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        out[f"{name}_data"] = np.frombuffer(
            b"".join(bytes(p.data) for p in pkts), np.uint8)
        out[f"{name}_sizes"] = np.array([len(p.data) for p in pkts],
                                        np.int64)
        out[f"{name}_pts"] = np.array([p.pts for p in pkts], np.int64)
        out[f"{name}_params"] = np.array([par.codec_id, str(par.width),
                                          str(par.height)])
        out[f"{name}_extradata"] = np.frombuffer(par.extradata or b"",
                                                 np.uint8)
        out[f"{name}_types"] = np.array([f.pict_type for f in frames])
        out[f"{name}_sha256"] = np.array([[_sha(np.asarray(p))
                                           for p in f.planes]
                                          for f in frames])
    return out


def main() -> None:
    src = fx.intra_clip_frame(W, H)
    out = {"clip_sha256": np.array(fx.clip_checksum([src]))}
    out.update(intra("prores", src))
    out.update(intra("dnxhd", src))
    fx.INTRA_GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(fx.INTRA_GOLDEN, **out)
    print(f"{fx.INTRA_GOLDEN}: {fx.INTRA_GOLDEN.stat().st_size} bytes")
    np.savez_compressed(fx.MPEG4_STREAMS, **mpeg4_streams())
    print(f"{fx.MPEG4_STREAMS}: {fx.MPEG4_STREAMS.stat().st_size} bytes")


if __name__ == "__main__":
    main()
