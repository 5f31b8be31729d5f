"""Shared inputs for the PyTorch port's equality tests (test_torch_*.py):
JPEG frames made by the reference encoder, the committed 1080p fixture,
the reference's own coefficients for a batch of packed regions, and the
tie-aware bar of the encoders that quantise a float32 FDCT.
The fixture's constants, its packed cap and the C++ host decode are in
ffmpeg_tpu_torch.testing, which chip_smoke.py reads too."""

from __future__ import annotations

import numpy as np

from ffmpeg_tpu_torch.testing import FIXTURE, undecided_levels


def encode_jpeg(w: int, h: int, quality: int = 85, frame: int = 0,
                pix_fmt: str = "yuv420p", **opts) -> bytes:
    """One testsrc frame in `pix_fmt` (full range) through the reference
    MJPEG encoder, with one MCU per restart interval and optimal (<= 9-bit)
    Huffman tables unless `opts` say otherwise."""
    from ffmpeg_tpu.codecs import CodecContext
    from ffmpeg_tpu.filters import get_filter
    from ffmpeg_tpu.io.stream import CodecParameters, MediaType
    from ffmpeg_tpu.scale.swscale import scale_frame
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="mjpeg",
                          width=w, height=h)
    enc = CodecContext.open_encoder(par, options={
        "quality": quality, "restart_interval": 1, "huffman": "optimal",
        **opts})
    src = get_filter("testsrc")(f"size={w}x{h}")
    fr = list(src.generate(frame + 1))[frame]
    enc.send_frame(scale_frame(fr, w, h, pix_fmt, dst_range=True))
    return enc.receive_packet().data


def fixture_packets() -> list:
    from ffmpeg_tpu_torch.io.mjpeg import split_packets
    return split_packets(FIXTURE.read_bytes())


def reference_coefficients(regions: np.ndarray, nmcu: int,
                           stride: int) -> np.ndarray:
    """What the reference's device stage (mjpeg_tpu_entropy `run`, its
    CPU branch) decodes from a batch of packed regions: the 64-byte
    window gather, then the JAX jpeg_scan_decode9 per frame.
    Returns (B, nmcu, 6, 64) int32."""
    import jax.numpy as jnp
    from ffmpeg_tpu.ops.huffman import jpeg_scan_decode9
    B, cap = regions.shape
    hdr = 2 * nmcu + 512 * 12
    G = 64
    S2 = G + stride
    lw = regions[:, :2 * nmcu].reshape(B, nmcu, 2).astype(np.int32)
    lens = lw[..., 0] | (lw[..., 1] << 8)
    luts = regions[:, 2 * nmcu:hdr].view(np.int8).reshape(B, 512, 12)
    starts = np.cumsum(lens, axis=1) - lens + hdr
    f64 = regions.reshape(B, cap // G, G)
    nwin = cap // G - (S2 // G - 1)
    win = np.concatenate([f64[:, c:c + nwin] for c in range(S2 // G)],
                         axis=2)
    win_idx = np.clip(starts >> 6, 0, nwin - 1)
    rows = np.take_along_axis(win, win_idx[:, :, None], axis=1)
    cur0 = (starts & (G - 1)) * 8
    return np.stack([np.asarray(jpeg_scan_decode9(
        jnp.asarray(rows[b]), jnp.ones(nmcu, bool), jnp.asarray(luts[b]),
        cur0=jnp.asarray(cur0[b]))) for b in range(B)])


def assert_levels_at_ties(got, want, x, tol, mode: str) -> dict:
    """The encoders' coefficient bar: every level within one step of the
    reference's, and each differing level one that float32 cannot
    decide: its exact value `x` (float64) lies on a rounding tie
    (`mode` "round") or a truncation boundary ("trunc") within `tol`,
    float32's error bound on x (testing.undecided_levels).  Both FDCTs
    are float32, summed in their own orders, so neither side rounds such
    a value reliably.  Returns the counts."""
    r = undecided_levels(got, want, x, tol, mode)
    assert r["step"] <= 1 and r["off"] == 0, r
    return r
