#!/usr/bin/env python
"""Write tests/data/port/image_codecs_streams.npz, the streams that the
port's image, FFV1, VP8, WebP and subtitle codecs are held to, from the
JAX package's tests on the CPU:

- `ffv1_<case>`: the eight AVI files of tests/test_ffv1.py
  test_ffv1_matrix (112x80, 8 frames of testsrc2) and three of its
  high-depth and alpha cases (testing.IMAGE_FFV1_STREAMS), with
  `ffv1_<case>_ref_sha256` / `_ref_bytes`, the sha256 and length of the
  reference binary's rawvideo decode that the test compares with;
- `tiff_<pix>_<comp>` and `qoi_<pix>`: the files of
  tests/test_qoi_tiff.py test_tiff_decode and test_qoi_decode (150x110),
  `png_<pix>`: the files of tests/test_flac_png.py
  test_png_decode_bit_exact (96x60), each with the binary's decode's
  sha256 (`_ref_sha256`);
- `exr_<name>`: files of tests/test_exr.py _write_exr: a 480x270 half
  float ZIP RGB picture (smooth, so that ZIP keeps it small) for the
  CLI, and one 40x24 RGB float file of each compression, an RGBA half
  ZIP and a luminance RLE one;
- `vp8_<case>`: the crafted streams of tests/test_vp8.py and
  test_vp8_inter.py (craft_kf, craft_inter, Session), each a list of
  frames joined as an IVF (wrap_ivf), with the binary's decode's sha256;
  `vp8_clip`: a 640x352 IVF of a keyframe and three inter frames with
  the loop filter on, crafted the same way, and `webp_lossy`: that
  keyframe wrapped as a lossy .webp (webp.wrap_webp);
- `pgs_<case>`: PGS display sets of tests/test_subtitles2.py
  (_craft_display_set, and an object split over two segments as
  test_pgs_fragmented_object makes it), and `movtext_packets`: mov_text
  packets of the reference's encoder with a crafted styl box.

The reference binary's streams and decodes replay through tests/golden.py
from the very invocations of the reference's tests, each in a fresh
directory; a replay miss stops the tool.  The card's machine has no JAX
and no reference binary, so these answers are committed.  Usage (about
a minute):

    JAX_PLATFORMS=cpu python tools/gen_torch_image_codecs_fixture.py
"""

from __future__ import annotations

import hashlib
import struct
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import conftest  # noqa: E402,F401  (installs tests/golden.py's replay)
import refutil  # noqa: E402
import test_exr  # noqa: E402
import test_ffv1  # noqa: E402
import test_qoi_tiff  # noqa: E402
import test_subtitles2  # noqa: E402
import test_vp8  # noqa: E402
import test_vp8_inter  # noqa: E402
from ffmpeg_tpu.codecs import CodecContext  # noqa: E402
from ffmpeg_tpu.codecs.webp import wrap_webp  # noqa: E402
from ffmpeg_tpu.core.frame import Frame  # noqa: E402
from ffmpeg_tpu.io import open_input  # noqa: E402
from ffmpeg_tpu.io.stream import CodecParameters, MediaType  # noqa: E402
from ffmpeg_tpu_torch import testing as fx  # noqa: E402


def _sha(data: bytes) -> np.ndarray:
    return np.array(hashlib.sha256(data).hexdigest())


def _replayed(fn, what: str):
    try:
        return fn()
    except pytest.skip.Exception as e:      # a replay miss
        raise SystemExit(f"{what}: the reference binary's answer is not "
                         f"in tests/data/golden ({e})") from e


def _decoded_format(path: Path) -> str:
    d = open_input(str(path))
    dec = CodecContext.open_decoder(d.streams[0].codecpar)
    return dec.decode_all(list(d.packets()))[0].format


def _ref_raw(path: Path, fmt: str) -> bytes:
    """The binary's decode as the reference tests run it."""
    return subprocess.run(
        [str(refutil.REF), "-v", "error", "-i", str(path), "-f",
         "rawvideo", "-pix_fmt", fmt, "-"],
        check=True, capture_output=True).stdout


def ffv1(out: dict) -> None:
    for name, (fname, extra) in fx.IMAGE_FFV1_STREAMS.items():
        with tempfile.TemporaryDirectory() as t:
            p = _replayed(lambda: test_ffv1._make(Path(t), fname, extra),
                          name)
            raw = _replayed(lambda: _ref_raw(p, _decoded_format(p)), name)
            out[f"ffv1_{name}"] = np.frombuffer(p.read_bytes(), np.uint8)
            out[f"ffv1_{name}_ref_sha256"] = _sha(raw)
            out[f"ffv1_{name}_ref_bytes"] = np.array(len(raw))


def images(out: dict) -> None:
    for pix, comp in fx.IMAGE_TIFF_CASES:
        with tempfile.TemporaryDirectory() as t:
            p = _replayed(lambda: test_qoi_tiff._make(
                Path(t), "tif", ["-pix_fmt", pix, "-compression_algo",
                                 comp]), pix)
            raw = _replayed(lambda: _ref_raw(p, _decoded_format(p)), pix)
            out[f"tiff_{pix}_{comp}"] = np.frombuffer(p.read_bytes(),
                                                      np.uint8)
            out[f"tiff_{pix}_{comp}_ref_sha256"] = _sha(raw)
    for pix in fx.IMAGE_QOI_PIX:
        with tempfile.TemporaryDirectory() as t:
            p = _replayed(lambda: test_qoi_tiff._make(
                Path(t), "qoi", ["-pix_fmt", pix]), pix)
            raw = _replayed(lambda: _ref_raw(p, pix), pix)
            out[f"qoi_{pix}"] = np.frombuffer(p.read_bytes(), np.uint8)
            out[f"qoi_{pix}_ref_sha256"] = _sha(raw)
    for pix in fx.IMAGE_PNG_PIX:
        png = _replayed(lambda: refutil.run([
            "-f", "lavfi", "-i", "testsrc2=size=96x60:rate=25",
            "-frames:v", "1", "-pix_fmt", pix, "-f", "image2pipe",
            "-c:v", "png", "-"]), pix)
        raw = _replayed(lambda: subprocess.run(
            [str(refutil.REF), "-v", "error", "-f", "png_pipe", "-i", "-",
             "-pix_fmt", pix, "-f", "rawvideo", "-"],
            input=png, check=True, capture_output=True).stdout, pix)
        out[f"png_{pix}"] = np.frombuffer(png, np.uint8)
        out[f"png_{pix}_ref_sha256"] = _sha(raw)


def exr(out: dict) -> None:
    w, h = fx.EXR_W, fx.EXR_H
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    smooth = {"R": 0.5 + 0.5 * np.sin(xx / 37.0) * np.cos(yy / 23.0),
              "G": (xx + yy) / float(w + h),
              "B": 2.0 * np.exp(-((xx - w / 3) ** 2 + (yy - h / 2) ** 2)
                                / 4000.0)}
    # steps of 1/64: short half mantissas, which ZIP packs small
    smooth = {k: np.round(v * 64) / 64 for k, v in smooth.items()}
    out["exr_clip"] = np.frombuffer(test_exr._write_exr(
        smooth, ptype=1, compression=3), np.uint8)
    pl = test_exr._rng_planes("RGB", 24, 40)
    for comp in (0, 1, 2, 3):
        out[f"exr_rgb_c{comp}"] = np.frombuffer(test_exr._write_exr(
            pl, ptype=2, compression=comp), np.uint8)
    out["exr_rgba_half_zip"] = np.frombuffer(test_exr._write_exr(
        test_exr._rng_planes("ABGR", 33, 9), ptype=1, compression=3),
        np.uint8)
    out["exr_y_rle"] = np.frombuffer(test_exr._write_exr(
        test_exr._rng_planes("Y", 13, 31), ptype=2, compression=1),
        np.uint8)
    out["exr_rgb_decreasing"] = np.frombuffer(test_exr._write_exr(
        test_exr._rng_planes("RGB", 8, 8), compression=0, line_order=1),
        np.uint8)


def _vp8_cases() -> dict:
    """name → (frames, width, height): the reference tests' crafts."""
    Plan, craft_kf = test_vp8.Plan, test_vp8.craft_kf
    InterPlan, Session = test_vp8_inter.InterPlan, test_vp8_inter.Session
    rng = np.random.default_rng
    cases = {}
    for seed in (0, 3, 7):
        cases[f"kf_{seed}"] = [craft_kf(Plan(rng(seed)))]
    cases["kf_pred_only"] = [craft_kf(Plan(rng(1), skip_p=1.0))]
    cases["kf_dense"] = [craft_kf(Plan(rng(17), maxn=14, amp=600), qi=100)]
    cases["kf_qdeltas"] = [craft_kf(Plan(rng(23)), qi=90,
                                    q_deltas=(4, -3, 7, -2, 5))]
    for lvl, sharp in ((20, 0), (40, 2), (63, 7)):
        cases[f"kf_lf{lvl}"] = [craft_kf(Plan(rng(29 + lvl), maxn=8, amp=60),
                                         filter_level=lvl,
                                         sharpness=sharp)]
    cases["kf_simple"] = [craft_kf(Plan(rng(31), maxn=8, amp=60),
                                   filter_level=32, simple=1)]
    cases["kf_partitions"] = [craft_kf(Plan(rng(37)), n_parts_log2=2)]
    cases["kf_segments"] = [craft_kf(Plan(rng(41), seg=True), seg=True)]
    out = {k: (v, test_vp8.W, test_vp8.H) for k, v in cases.items()}
    out["kf_odd"] = ([craft_kf(Plan(rng(47)), width=70, height=50)], 70, 50)
    for seed in (0, 5, 9):
        r = rng(seed)
        s = Session()
        s.key(Plan(r))
        for _ in range(3):
            s.inter(InterPlan(r))
        out[f"inter_{seed}"] = (s.frames, s.width, s.height)
    r = rng(11)
    s = Session()
    s.key(Plan(r))
    for _ in range(2):
        s.inter(InterPlan(r, split_p=0.6, mv_amp=24))
    out["inter_splitmv"] = (s.frames, s.width, s.height)
    r = rng(21)
    s = Session()
    s.key(Plan(r))
    s.inter(InterPlan(r), update_golden=4, sign_bias=(1, 0))
    s.inter(InterPlan(r), update_altref=4, sign_bias=(1, 1))
    s.inter(InterPlan(r, golden_p=0.4), update_golden=3)
    s.inter(InterPlan(r, golden_p=0.4), update_last=False)
    out["inter_golden_altref"] = (s.frames, s.width, s.height)
    r = rng(31)
    s = Session()
    s.key(Plan(r, maxn=8, amp=60), filter_level=28)
    s.inter(InterPlan(r, maxn=8, amp=60), filter_level=40, sharpness=2)
    s.inter(InterPlan(r, maxn=8, amp=60), filter_level=24, simple=1)
    out["inter_loopfilter"] = (s.frames, s.width, s.height)
    return out


def vp8(out: dict) -> None:
    for name, (frames, w, h) in _vp8_cases().items():
        ivf = test_vp8.wrap_ivf(frames, w, h)
        with tempfile.TemporaryDirectory() as t:
            p = Path(t) / "s.ivf"
            p.write_bytes(ivf)
            raw = _replayed(lambda: subprocess.run(
                [str(refutil.REF), "-v", "error", "-i", str(p),
                 "-f", "rawvideo", "-"], check=True,
                capture_output=True).stdout, name)
        out[f"vp8_{name}"] = np.frombuffer(ivf, np.uint8)
        out[f"vp8_{name}_ref_sha256"] = _sha(raw)
    # the CLI's clip: a keyframe and three inter frames, loop filter on
    r = np.random.default_rng(fx.VP8_CLIP_SEED)
    s = test_vp8_inter.Session(fx.VP8_W, fx.VP8_H)
    s.key(test_vp8.Plan(r, skip_p=0.3, maxn=2, amp=40), filter_level=28)
    for lvl, sharp in ((36, 2), (24, 0), (44, 3)):
        s.inter(test_vp8_inter.InterPlan(r, skip_p=0.5, maxn=1, amp=20,
                                         mv_amp=24),
                filter_level=lvl, sharpness=sharp)
    out["vp8_clip"] = np.frombuffer(test_vp8.wrap_ivf(
        s.frames, fx.VP8_W, fx.VP8_H), np.uint8)
    out["webp_lossy"] = np.frombuffer(wrap_webp(s.frames[0]), np.uint8)
    print(f"vp8_clip: {len(s.frames)} frames, "
          f"{[len(f) for f in s.frames]} bytes", flush=True)


def subtitles(out: dict) -> None:
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 3, (4, 8)).astype(np.uint8)
    out["pgs_display_set"] = np.frombuffer(
        test_subtitles2._craft_display_set(idx), np.uint8)
    idx = np.random.default_rng(5).integers(0, 3, (120, 300)).astype(
        np.uint8)
    out["pgs_sd_canvas"] = np.frombuffer(test_subtitles2._craft_display_set(
        idx, x=40, y=300, canvas=(720, 576)), np.uint8)
    # an object whose RLE spans two OBJECT segments, as
    # test_pgs_fragmented_object makes it
    seg, rle_encode = test_subtitles2._seg, test_subtitles2._rle_encode
    idx = np.random.default_rng(2).integers(0, 3, (8, 32)).astype(np.uint8)
    rle = rle_encode(idx)
    half = len(rle) // 2
    pres = struct.pack(">HHBHBBBB", 1920, 1080, 0x10, 1, 0x80, 0, 0, 1) \
        + struct.pack(">HBBHH", 1, 0, 0, 0, 0)
    pal = bytes([0, 0]) + bytes([1, 235, 128, 128, 255])
    obj1 = struct.pack(">HBB", 1, 0, 0x80) \
        + (len(rle) + 4).to_bytes(3, "big") \
        + struct.pack(">HH", 32, 8) + rle[:half]
    obj2 = struct.pack(">HBB", 1, 0, 0x00) + rle[half:]
    out["pgs_fragmented"] = np.frombuffer(
        seg(0x16, pres) + seg(0x14, pal) + seg(0x15, obj1)
        + seg(0x15, obj2) + seg(0x80, b""), np.uint8)
    enc = CodecContext.open_encoder(CodecParameters(
        codec_type=MediaType.SUBTITLE, codec_id="mov_text"))
    pkts = []
    for i, text in enumerate(fx.MOVTEXT_TEXTS):
        f = Frame(pts=i * 1000, duration=900)
        f.side_data["text"] = text
        pkts.append(bytes(enc.codec.encode(f)[0].data))
    text = "bold text".encode()
    # test_movtext_styl_box's styl box, on two cues
    styl = struct.pack(">H", 1) + struct.pack(
        ">HHHBB4B", 0, 4, 1, 1, 18, 255, 255, 255, 255)
    box = struct.pack(">I4s", 8 + len(styl), b"styl") + styl
    pkts.append(struct.pack(">H", len(text)) + text + box)
    styl = struct.pack(">H", 2) + struct.pack(
        ">HHHBB4B", 0, 3, 1, 2, 18, 255, 0, 0, 255) + struct.pack(
        ">HHHBB4B", 4, 9, 1, 5, 18, 0, 255, 0, 128)
    box = struct.pack(">I4s", 8 + len(styl), b"styl") + styl
    pkts.append(struct.pack(">H", len(text)) + text + box)
    lens = np.array([len(p) for p in pkts], np.int64)
    out["movtext_packets"] = np.frombuffer(b"".join(pkts), np.uint8)
    out["movtext_lengths"] = lens


def main() -> int:
    out: dict = {}
    for step in (ffv1, images, exr, vp8, subtitles):
        step(out)
        print(f"{step.__name__} done", flush=True)
    np.savez_compressed(fx.IMAGE_CODECS, **out)
    print(f"wrote {fx.IMAGE_CODECS} ({fx.IMAGE_CODECS.stat().st_size} "
          f"bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
