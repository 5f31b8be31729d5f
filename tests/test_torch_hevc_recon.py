"""The port's HEVC reconstruction (ffmpeg_tpu_torch/codecs/hevc/
recon_tpu.py) fed the reference's own ReconRecorder and FrameDec,
against the reference's host planes, byte-exact, on the CPU.

`_Capture` is the reference's host decoder, which parses each slice two
more times with the reference's modules: once with its ReconRecorder
attached (the records the port replays) and once inline (the host
reconstruction before the in-loop filters, the truth).  The streams
are the crafted matrix of test_torch_hevc.py.  One small case runs the
reference's jitted `recon_tpu.prepare` + program; the transform and the
reference-sample substitution are held to the reference's device
helpers at every size, extreme coefficients included."""

import numpy as np
import pytest
import torch

import test_hevc as T
from ffmpeg_tpu.codecs.h264.cabac import CabacDecoder as RefCabac
from ffmpeg_tpu.codecs.hevc import HevcDecoder as RefHevcDecoder
from ffmpeg_tpu.codecs.hevc import params as RP
from ffmpeg_tpu.codecs.hevc import recon_tpu as RRT
from ffmpeg_tpu.codecs.hevc.ctu import CtuCoder as RefCtu
from ffmpeg_tpu.codecs.hevc.ctu import FrameDec as RefFrameDec
from ffmpeg_tpu.codecs.hevc.recorder import ReconRecorder as RefRecorder
from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io.stream import CodecParameters as RefParameters
from ffmpeg_tpu.io.stream import MediaType as RefMediaType
from ffmpeg_tpu_torch.codecs.hevc import recon_tpu
from test_torch_hevc import CASES, _stream


class _Capture(RefHevcDecoder):
    """The reference's host decoder; before each slice it parses the
    slice with a ReconRecorder attached and again inline, and keeps
    (FrameDec, recorder, inline planes before the filters)."""

    def __init__(self):
        super().__init__(RefParameters(codec_type=RefMediaType.VIDEO,
                                       codec_id="hevc"))
        self.records = []

    def _decode_slice(self, rbsp, ntype, pkt):
        from ffmpeg_tpu.codecs.h264.bits import Bits
        probe = Bits(rbsp)
        probe.get1()
        if RP.is_irap(ntype):
            probe.get1()
        pps = self.pps[probe.ue()]
        sps = self.sps[pps.sps_id]
        sh = RP.parse_slice_header(rbsp, ntype, sps, self.pps)
        idr = ntype in (RP.NAL_IDR_W_RADL, RP.NAL_IDR_N_LP)
        poc = 0 if idr else self._poc(sps, ntype, sh.poc_lsb)
        refs, rpl = ([[], []], [[], []])
        if sh.slice_type != 2:
            refs, rpl = self._ref_lists(sps, sh, poc)
        payload = rbsp[sh.data_bit_pos // 8:]
        decs = []
        for record in (True, False):
            d = RefFrameDec(sps, pps, sh, poc=poc, refs=refs, rpl=rpl)
            if record:
                d.recorder = RefRecorder(d)
            RefCtu(d, RefCabac(payload), payload=payload).code_slice_data()
            decs.append(d)
        rec, host = decs
        self.records.append((rec, rec.recorder, (host.y, host.u, host.v)))
        return super()._decode_slice(rbsp, ntype, pkt)


def captured(stream):
    d = _Capture()
    d.decode(RefPacket(data=stream, pts=0))
    d.decode(None)
    return d.records


def _check(stream):
    recs = captured(stream)
    assert recs
    for i, (dec, rec, want) in enumerate(recs):
        got = recon_tpu.reconstruct(dec, rec, "cpu")
        for pl, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == recon_tpu.plane_dtype(dec.bd)
            np.testing.assert_array_equal(g.numpy().astype(w.dtype), w,
                                          err_msg=f"frame {i} plane {pl}")
    return recs


@pytest.mark.parametrize("case", CASES)
def test_reconstruct_matches_host(case):
    _check(_stream(case))


def test_writes_on_the_last_row_and_column():
    """A 72x56 picture (partial CTBs): TUs and intra blocks of both
    planes end on the picture's last row and column, and are written
    there and nowhere past it."""
    rng = np.random.default_rng(2)
    recs = _check(T.craft_frame(T.Plan(rng), width=72, height=56))
    dec, rec, _w = recs[0]
    for is_luma, (ph, pw) in ((True, (56, 72)), (False, (28, 36))):
        tus = [(x + n, y + n) for (lu, n), lst in rec.tus.items()
               if lu == is_luma for x, y, *_ in lst]
        intra = [(it[1] + n, it[2] + n) for (lu, n), lst in
                 rec.intra.items() if lu == is_luma for it in lst]
        for items in (tus, intra):
            assert max(x for x, _y in items) == pw
            assert max(y for _x, y in items) == ph


def test_prepare_replays():
    """prepare() builds one frame's arguments on the device; running
    its program again (the bench replay) gives the same planes."""
    recs = captured(_stream("p_gop"))
    dec, rec, want = recs[1]
    fn, args = recon_tpu.prepare(dec, rec, "cpu")
    for _ in range(2):
        y, u, v = fn(args)
        for g, w in zip((y, u, v), want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_matches_reference_program():
    """The reference's own jitted program (recon_tpu.prepare + its
    compiled frame program) on a small inter frame, against the port's
    reconstruct on the same records."""
    recs = captured(_stream("p_gop"))
    dec, rec, _w = recs[1]
    fn, args = RRT.prepare(dec, rec)
    want = [np.asarray(p) for p in fn(*args)]
    got = recon_tpu.reconstruct(dec, rec, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_residual_blocks_equal_reference(bd):
    """Every class and transform kind, against the reference's int32
    einsum program, on random and extreme (+-32768) coefficients: the
    float64 products are exact."""
    import jax.numpy as jnp
    from ffmpeg_tpu.codecs.hevc import recorder as RR
    rng = np.random.default_rng(bd)
    for is_luma, n in recon_tpu._CLASSES + [(True, 4)]:
        K = 24
        coef = rng.integers(-32768, 32768, (K, n, n)).astype(np.int32)
        coef[0] = 32767
        coef[1] = -32768
        coef[2] = np.where(rng.random((n, n)) < 0.5, 32767, -32768)
        kinds = [RR.K_IDCT] + ([RR.K_DST] if is_luma and n == 4 else []) \
            + ([RR.K_TSKIP] if n == 4 else [])
        kind = rng.choice(kinds, K).astype(np.int32)
        want = np.asarray(RRT._residual_blocks(
            jnp, jnp.asarray(coef), jnp.asarray(kind), n, is_luma, bd))
        got = recon_tpu._residual_blocks(
            torch.from_numpy(coef), torch.from_numpy(kind), n, is_luma, bd,
            frozenset(kinds))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_reference_samples_equal_cascade(n):
    """The host-resolved substitution indices (ref_sample_index),
    gathered from a plane, give the reference's _ref_cascade output on
    all 32 availability patterns, at the picture's edges too; a block
    with none available reads the fill sample."""
    import jax.numpy as jnp
    rng = np.random.default_rng(n)
    ph, pw, bd = 96, 80, 10
    plane = rng.integers(0, 1 << bd, (ph, pw)).astype(np.int32)
    ab = np.arange(32)
    px = rng.integers(0, (pw - n) // 4 + 1, 32) * 4
    py = rng.integers(0, (ph - n) // 4 + 1, 32) * 4
    px[:4] = pw - n                      # right and bottom edges
    py[4:8] = ph - n
    flat = np.concatenate([plane.reshape(-1), [1 << (bd - 1)]])
    idx = recon_tpu.ref_sample_index(px, py, ab, None, n, ph, pw)
    c = flat[idx]
    k2 = np.arange(2 * n)[None, :]
    Lr = plane[np.clip(py[:, None] + k2, 0, ph - 1),
               np.clip(px - 1, 0, pw - 1)[:, None]]
    Tr = plane[np.clip(py - 1, 0, ph - 1)[:, None],
               np.clip(px[:, None] + k2, 0, pw - 1)]
    corner = plane[np.clip(py - 1, 0, ph - 1), np.clip(px - 1, 0, pw - 1)]
    avail = np.stack([(ab >> i) & 1 for i in range(5)], 1).astype(bool)
    L, Tt = (np.asarray(a) for a in RRT._ref_cascade(
        jnp, jnp.asarray(Lr), jnp.asarray(Tr), jnp.asarray(corner),
        jnp.asarray(avail), bd))
    np.testing.assert_array_equal(c[:, :2 * n + 1][:, ::-1], L)
    np.testing.assert_array_equal(c[:, 2 * n:], Tt)


def test_blocks_past_the_plane_are_dropped():
    """Records moved half past the picture's right and bottom edges (no
    valid stream has them) are reconstructed as the reference's program
    does, which drops the writes outside (mode="drop"): the port's
    batches with such a block write through _put and never clamp onto
    the plane."""
    recs = captured(_stream("i_mixed"))
    dec, rec, _w = recs[0]
    H, W = dec.sps.height, dec.sps.width
    for key, i, (dx, dy) in (((True, 8), 0, (W - 4, None)),
                             ((False, 4), 1, (None, H // 2 - 2))):
        lst = rec.tus[key]
        x, y, *rest = lst[i]
        lst[i] = (dx if dx is not None else x, dy if dy is not None else y,
                  *rest)
        lst = rec.intra[key]
        it = list(lst[i])
        it[1] = dx if dx is not None else it[1]
        it[2] = dy if dy is not None else it[2]
        lst[i] = tuple(it)
    fn, args = RRT.prepare(dec, rec)
    want = [np.asarray(p) for p in fn(*args)]
    got = recon_tpu.reconstruct(dec, rec, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
