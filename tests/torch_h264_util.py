"""Helpers of the port's H.264 tests: the reference's decoder run with
its parsed pictures captured, and frame comparisons."""

import sys
from pathlib import Path

import numpy as np

from ffmpeg_tpu.codecs import CodecContext as RefContext
from ffmpeg_tpu.codecs.h264 import H264Decoder as RefH264
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io.stream import CodecParameters as RefPar
from ffmpeg_tpu.io.stream import MediaType as RefMT
from ffmpeg_tpu.utils.rational import Rational as RefRational
from ffmpeg_tpu_torch.testing import h264_decode, h264_slice_from_reference

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from gen_torch_h264_fixture import truncated_stream as truncated_p  # noqa
from gen_torch_h264_fixture import with_refs as _refs  # noqa: E402


def ref_decode(stream, options=None, extradata=None):
    """The reference's decoder (its default: the host path) on one
    packet, drained: frames' planes as numpy arrays."""
    par = RefPar(codec_type=RefMT.VIDEO, codec_id="h264")
    if extradata is not None:
        par.extradata = extradata
    dec = RefContext.open_decoder(par, options=options)
    frames = dec.decode_all([RefPacket(data=stream, pts=0,
                                       time_base=RefRational(1, 25))])
    return [[np.asarray(p) for p in f.planes] for f in frames]


def ref_pictures(stream, monkeypatch, options=None):
    """Decode with the reference and capture every picture: (the port's
    copy of its parse taken before the reconstruction, the
    reconstruction's arguments (alpha, beta, deblock), and the
    reference's final planes of that picture)."""
    caps = []
    orig = RefH264._emit

    def emit(self, dec, pkt):
        snap = h264_slice_from_reference(dec)
        sh = getattr(dec, "last_sh", None)
        args = (sh.alpha_c0_offset if sh else 0,
                sh.beta_offset if sh else 0,
                sh is not None and sh.disable_deblocking != 1)
        out = orig(self, dec, pkt)
        caps.append((snap, args, (dec.y.copy(), dec.u.copy(),
                                  dec.v.copy())))
        return out
    monkeypatch.setattr(RefH264, "_emit", emit)
    ref_decode(stream, options)
    monkeypatch.setattr(RefH264, "_emit", orig)
    return caps


def port_frames(stream, options=None, stats=None, device="cpu"):
    """The port's decode on `device`: frames' planes as numpy arrays
    (Frame.numpy: uint16 above 8 bits, as the reference's)."""
    frames = h264_decode(stream, device, options, stats)
    return [f.numpy().planes for f in frames]


def assert_frames_equal(got, want, what=""):
    """Byte-exact, tolerance 0: every plane of every frame."""
    assert len(got) == len(want) and want, (len(got), len(want), what)
    for i, (gf, wf) in enumerate(zip(got, want)):
        for n, g, w in zip("yuv", gf, wf):
            assert g.shape == w.shape and g.dtype == w.dtype, \
                (what, i, n, g.shape, w.shape, g.dtype, w.dtype)
            np.testing.assert_array_equal(
                g, w, err_msg=f"{what} frame {i} plane {n}")


# ---------------------------------------------------------------------------
# the crafted matrix: the compositions of the reference's H.264 tests
# (tests/test_h264*.py), each a function returning an Annex B stream


def _patched(mod, name, value, build):
    orig = getattr(mod, name)
    setattr(mod, name, value)
    try:
        return build()
    finally:
        setattr(mod, name, orig)


def _p_gop(seed, deblock=False):
    import test_h264 as H
    s = H.craft_i16x16_residual(seed=4 + seed)
    for i in range(3):
        s += H.craft_p_frame(frame_num=i + 1, seed=30 + seed + i,
                             deblock=deblock)
    return s


def _b_gop(seed, b_build):
    import test_h264 as H
    s = _refs(2, lambda: H.craft_i16x16_residual(seed=seed % 10))
    s += H.craft_p_frame_poc(1, 4, 50 + seed)
    return s + b_build()


def _p_multiref(seed):
    import test_h264 as H
    s = _refs(2, lambda: H.craft_i16x16_residual(seed=seed))
    s += H.craft_p_frame(frame_num=1, seed=80 + seed)
    s += H.craft_p_frame(frame_num=2, seed=90 + seed, num_ref=2)
    s += H.craft_p_frame(frame_num=3, seed=96 + seed, num_ref=2,
                         deblock=True)
    return s


def _constrained(seed):
    import test_h264 as H
    s = _patched(H, "make_pps", H.make_pps_constrained,
                 lambda: H.craft_i16x16_residual(seed=3))
    return s + H.craft_p_with_intra_mbs(seed)


def _cabac_gop(seed):
    import test_h264_cabac as C
    return (C.craft_cabac_i(seed=seed, deblock=True)
            + C.craft_cabac_p(frame_num=1, seed=seed + 1, deblock=True))


def _cabac_i_deblocked():
    import test_h264_cabac as C
    return C.craft_cabac_i(deblock=True)


def _cabac_b(seed, deblock=True, spatial=True, b8x8=False):
    import test_h264_cabac as C
    s = C.craft_cabac_i(seed=40 + seed, deblock=deblock)
    s += C.craft_cabac_p(frame_num=1, seed=50 + seed, deblock=deblock,
                         poc_lsb=4)
    if b8x8:
        return s + C.craft_cabac_b8x8(frame_num=2, poc_lsb=2,
                                      seed=60 + seed, spatial=spatial)
    return s + C.craft_cabac_b(frame_num=2, poc_lsb=2, seed=60 + seed,
                               deblock=deblock, spatial=spatial)


def _cabac_p_multiref(seed):
    import test_h264_cabac as C
    s = C.craft_cabac_i(seed=70 + seed, deblock=True, num_ref=2)
    s += C.craft_cabac_p(frame_num=1, seed=80 + seed, deblock=True)
    s += C.craft_cabac_p(frame_num=2, seed=90 + seed, deblock=True,
                         num_ref=2)
    return s + C.craft_cabac_p(frame_num=3, seed=95 + seed, deblock=True,
                               num_ref=2)


def _cabac_b_multiref(seed):
    import test_h264_cabac as C
    s = C.craft_cabac_i(seed=100 + seed, deblock=True, num_ref=2)
    s += C.craft_cabac_p(frame_num=1, seed=110 + seed, deblock=True,
                         poc_lsb=8)
    return s + C.craft_cabac_b(frame_num=2, poc_lsb=4, seed=120 + seed,
                               deblock=True, num_ref=2)


def _i8x8(seed, deblock=False, cabac=False):
    import test_h264_8x8 as E
    head = E.make_sps_high() + E.make_pps_8x8(cabac=cabac)
    if cabac:
        return head + E.craft_cabac_i8x8(seed=seed, deblock=deblock)
    return head + E.craft_i8x8_frame(seed=seed, deblock=deblock)


def _p_trans8(cabac):
    import test_h264_8x8 as E
    if cabac:
        return (E.make_sps_high() + E.make_pps_8x8(cabac=True)
                + E.craft_cabac_i8x8(seed=1)
                + E.craft_cabac_p_trans8(frame_num=1, seed=31)
                + E.craft_cabac_p_trans8(frame_num=2, seed=32,
                                         deblock=True))
    return (E.make_sps_high() + E.make_pps_8x8()
            + E.craft_i8x8_frame(seed=1)
            + E._craft_p_trans8(frame_num=1, seed=21)
            + E._craft_p_trans8(frame_num=2, seed=22, deblock=True))


def _scaling():
    import test_h264 as H
    import test_h264_8x8 as E
    rng = np.random.default_rng(11)
    s4 = [[int(v) for v in rng.integers(8, 40, 16)] for _ in range(6)]
    s8 = [[int(v) for v in rng.integers(8, 40, 64)] for _ in range(2)]
    s = E.make_sps_high(s4=s4, s8=s8) + E.make_pps_8x8() \
        + E.craft_i8x8_frame(seed=2)
    return s + H.craft_i16x16_residual(seed=4)[len(H.make_sps())
                                               + len(H.make_pps()):]


def _weighted(ld, cd, wy, oy, wc, oc):
    import test_h264_highfeat as F
    pps = F.make_pps_weighted(weighted_pred=True)
    p1 = F._craft_p(1, seed=31, weights=(ld, cd, [(wy, oy, wc, oc)]))
    p2 = F._craft_p(2, seed=32, weights=(ld, cd, [(wy, oy, wc, oc)]),
                    deblock=True)
    return F._stream_with_pps(pps, p1, p2)


def _implicit(seed):
    import test_h264 as H
    import test_h264_highfeat as F
    s = _refs(2, lambda: F._i_frame(seed))
    s += F.make_pps_weighted(bipred_idc=2)
    s += H.craft_p_frame_poc(1, 6, seed=70 + seed)
    return s + H.craft_b_frame(frame_num=2, poc_lsb=2, seed=80 + seed)


def _reorder():
    import test_h264_highfeat as F
    s = _refs(2, lambda: F._i_frame(3))
    s += F._craft_p(1, seed=41)
    s += F._craft_p(2, seed=42)
    return s + F._craft_p(3, seed=43, num_ref=2, reorder=[(0, 1)])


def _mmco():
    import test_h264_highfeat as F
    s = _refs(2, lambda: F._i_frame(9))
    s += F._craft_p(1, seed=51)
    s += F._craft_p(2, seed=52, mmco=[(1, 0)])
    return s + F._craft_p(3, seed=53)


def _long_term(seed):
    import test_h264 as H
    s = _refs(3, lambda: H.craft_i16x16_residual(seed=3 + seed))
    s += H.craft_p_longterm(1, 2, 50 + seed, mmco6=0)
    s += H.craft_p_longterm(2, 4, 51 + seed)
    s += H.craft_p_longterm(3, 6, 52 + seed, num_ref=2, reorder_lt=0)
    return s + H.craft_p_longterm(4, 8, 54 + seed, num_ref=2)


def _paff(kind):
    import test_h264_paff as P
    s = P.make_sps_paff() + P.make_pps_plain()
    if kind == "i16":
        return s + P.i16_field(0, True, 0, 0, 3) + P.i16_field(1, False, 0,
                                                               1, 4)
    if kind == "bottom_first":
        return s + P.ipcm_field(1, True, 0, 0, 5) + P.ipcm_field(
            0, False, 0, 1, 6)
    s += P.ipcm_field(0, True, 0, 0, 1) + P.ipcm_field(1, False, 0, 1, 2)
    seed = 10
    for fn in (1, 2):
        s += P.p_field(0, fn, 2 * fn, seed)
        s += P.p_field(1, fn, 2 * fn + 1, seed + 1)
        seed += 2
    return s


def _hbd(kind, bd):
    import test_h264 as H
    import test_h264_hbd as B
    if kind == "pcm":
        return B.craft_pcm_hbd(bd=bd)
    if kind == "deblock":
        s = B.craft_i16_res_hbd(bd=bd, seed=6, deblock=True)
        return s + H.craft_p_frame(frame_num=1, seed=77, deblock=True)
    s = B.craft_i16_res_hbd(bd=bd, seed=4)
    for i in range(3):
        s += H.craft_p_frame(frame_num=i + 1, seed=30 + i)
    return s


def truncated_idr():
    """test_error_concealment_intra_spatial: an IDR cut inside its
    slice (no reference: spatial concealment)."""
    import test_h264_highfeat as F
    full = F._i_frame(6)
    idx = full.rfind(b"\x00\x00\x00\x01\x65")
    return full[:idx + (len(full) - idx) * 2 // 3]


def _h():
    import test_h264 as H
    return H


STREAMS = {
    "ipcm": lambda: _h().craft_ipcm(),
    **{f"i16_mode{m}": (lambda m=m: _h().craft_i16x16(pred_mode=m))
       for m in range(4)},
    "i16_residual": lambda: _h().craft_i16x16_residual(),
    "i16_qp_delta": lambda: _h().craft_i16x16_residual(seed=5,
                                                       qp_delta=-6),
    "i4": lambda: _h().craft_i4x4(),
    "i4_residual": lambda: _h().craft_i4x4(with_residual=True, seed=13),
    "p_gop0": lambda: _p_gop(0),
    "p_gop5": lambda: _p_gop(5),
    "p_gop_deblocked": lambda: _p_gop(4, deblock=True),
    "b_frames1": lambda: _b_gop(1, lambda: _h().craft_b_frame(
        frame_num=2, poc_lsb=2, seed=41)),
    "b_frames9": lambda: _b_gop(9, lambda: _h().craft_b_frame(
        frame_num=2, poc_lsb=2, seed=49)),
    "b_temporal4": lambda: _b_gop(4, lambda: _h().craft_b_temporal(
        frame_num=2, poc_lsb=2, seed=64)),
    "b8x8_spatial": lambda: _b_gop(3, lambda: _h().craft_b8x8_frame(
        seed=21, spatial=True)),
    "b8x8_temporal": lambda: _b_gop(3, lambda: _h().craft_b8x8_frame(
        seed=33, spatial=False)),
    "p_multiref": lambda: _p_multiref(3),
    "constrained_intra": lambda: _constrained(5),
    "cabac_i_deblocked": lambda: _cabac_i_deblocked(),
    "cabac_gop0": lambda: _cabac_gop(0),
    "cabac_gop3": lambda: _cabac_gop(3),
    "cabac_b": lambda: _cabac_b(1),
    "cabac_b_temporal": lambda: _cabac_b(5, deblock=False,
                                         spatial=False),
    "cabac_b8x8": lambda: _cabac_b(9, deblock=False, spatial=False,
                                   b8x8=True),
    "cabac_p_multiref": lambda: _cabac_p_multiref(2),
    "cabac_b_multiref": lambda: _cabac_b_multiref(3),
    "i8x8_cavlc": lambda: _i8x8(5),
    "i8x8_cavlc_deblocked": lambda: _i8x8(3, deblock=True),
    "i8x8_cabac": lambda: _i8x8(7, cabac=True),
    "i8x8_cabac_deblocked": lambda: _i8x8(4, deblock=True, cabac=True),
    "p_trans8_cavlc": lambda: _p_trans8(False),
    "p_trans8_cabac": lambda: _p_trans8(True),
    "scaling_matrices": _scaling,
    "weighted_explicit": lambda: _weighted(2, 1, 3, 10, 1, -5),
    "weighted_denom0": lambda: _weighted(0, 0, 2, -20, 1, 8),
    "weighted_large": lambda: _weighted(7, 6, 120, 30, -60, 12),
    "implicit_bipred0": lambda: _implicit(0),
    "implicit_bipred4": lambda: _implicit(4),
    "ref_list_modification": _reorder,
    "mmco_forget_short_term": _mmco,
    "long_term0": lambda: _long_term(0),
    "long_term6": lambda: _long_term(6),
    "paff_i16": lambda: _paff("i16"),
    "paff_bottom_first": lambda: _paff("bottom_first"),
    "paff_field_gop": lambda: _paff("gop"),
    "hbd10_pcm": lambda: _hbd("pcm", 10),
    "hbd10_p": lambda: _hbd("p", 10),
    "hbd12_p": lambda: _hbd("p", 12),
    "hbd10_deblock": lambda: _hbd("deblock", 10),
    "truncated_p": truncated_p,
    "truncated_idr": truncated_idr,
}
