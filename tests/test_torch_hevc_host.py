"""The port's copies of the reference's HEVC host modules, held equal to
the reference's, on the CPU: codecs/h264/cabac_tables.py, cabac.py,
nal.py and codecs/hevc/cabac_tables.py, tables.py, params.py, mvs.py,
inter.py, recon.py, recorder.py, ctu.py (its encode branch too) and
filter.py.

Constants are compared name by name; the CABAC engine and the NAL
helpers on the same inputs; the parameter sets and slice headers field
by field; the CTU walker with its recorder by the recorded work lists
and FrameDec's grids (pf, mvx, mvy, refidx, bs_v, bs_h, qp, the SAO
parameters, the intra modes) on the crafted matrix and on the 1080p
bench keyframe; the encode walker by the bits it writes; the inline
host reconstruction and the host filters by their planes."""

import types

import numpy as np
import pytest

import test_hevc as T
from ffmpeg_tpu.codecs.h264 import cabac as R_cabac
from ffmpeg_tpu.codecs.h264 import cabac_tables as R_h264_tables
from ffmpeg_tpu.codecs.h264 import nal as R_nal
from ffmpeg_tpu.codecs.hevc import cabac_tables as R_cabac_tables
from ffmpeg_tpu.codecs.hevc import ctu as R_ctu
from ffmpeg_tpu.codecs.hevc import filter as R_filter
from ffmpeg_tpu.codecs.hevc import inter as R_inter
from ffmpeg_tpu.codecs.hevc import mvs as R_mvs
from ffmpeg_tpu.codecs.hevc import params as R_params
from ffmpeg_tpu.codecs.hevc import recon as R_recon
from ffmpeg_tpu.codecs.hevc import recorder as R_recorder
from ffmpeg_tpu.codecs.hevc import tables as R_tables
from ffmpeg_tpu_torch.codecs.h264 import cabac as P_cabac
from ffmpeg_tpu_torch.codecs.h264 import cabac_tables as P_h264_tables
from ffmpeg_tpu_torch.codecs.h264 import nal as P_nal
from ffmpeg_tpu_torch.codecs.hevc import cabac_tables as P_cabac_tables
from ffmpeg_tpu_torch.codecs.hevc import ctu as P_ctu
from ffmpeg_tpu_torch.codecs.hevc import filter as P_filter
from ffmpeg_tpu_torch.codecs.hevc import inter as P_inter
from ffmpeg_tpu_torch.codecs.hevc import mvs as P_mvs
from ffmpeg_tpu_torch.codecs.hevc import params as P_params
from ffmpeg_tpu_torch.codecs.hevc import recon as P_recon
from ffmpeg_tpu_torch.codecs.hevc import recorder as P_recorder
from ffmpeg_tpu_torch.codecs.hevc import tables as P_tables
from ffmpeg_tpu_torch.testing import HEVC_BENCH
from test_torch_hevc import _stream

SIDES = {
    "ref": dict(params=R_params, ctu=R_ctu, recorder=R_recorder,
                cabac=R_cabac, nal=R_nal, filter=R_filter),
    "port": dict(params=P_params, ctu=P_ctu, recorder=P_recorder,
                 cabac=P_cabac, nal=P_nal, filter=P_filter),
}


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and not all(
            isinstance(x, (int, float, np.generic)) for x in a):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if hasattr(a, "__dict__") and not isinstance(a, type):
        return _same(vars(a), vars(b))
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("ref,port", [
    (R_tables, P_tables), (R_cabac_tables, P_cabac_tables),
    (R_h264_tables, P_h264_tables), (R_inter, P_inter), (R_mvs, P_mvs),
    (R_recorder, P_recorder), (R_params, P_params)],
    ids=["tables", "cabac_tables", "h264_cabac_tables", "inter", "mvs",
         "recorder", "params"])
def test_constants_equal_reference(ref, port):
    names = [n for n, v in vars(ref).items() if n.isupper()
             and not callable(v) and not isinstance(v, types.ModuleType)]
    assert names
    for n in names:
        assert _same(getattr(ref, n), getattr(port, n)), n


def test_cabac_engine_and_nal_equal_reference():
    rng = np.random.default_rng(0)
    for qp in (0, 26, 51):
        for it in (0, 1, 2):
            assert P_cabac.init_contexts(P_tables.init_mn(it), qp) == \
                R_cabac.init_contexts(R_tables.init_mn(it), qp)
    bits = []
    for mod in (R_cabac, P_cabac):
        rng = np.random.default_rng(1)
        enc = mod.CabacEncoder()
        ctxs = mod.init_contexts(R_tables.init_mn(2), 30)
        for _ in range(4000):
            r = rng.random()
            if r < 0.7:
                enc.decision(ctxs[int(rng.integers(0, len(ctxs)))],
                             int(rng.random() < 0.3))
            else:
                enc.bypass(int(rng.integers(0, 2)))
        enc.terminate(1)
        bits.append(enc.bitstring())
    assert bits[0] == bits[1]
    data = bytes(np.packbits(np.asarray(bits[0] + [0] * 7, np.uint8)
                             [:len(bits[0]) // 8 * 8 + 8]))
    outs = []
    for mod in (R_cabac, P_cabac):
        rng = np.random.default_rng(1)
        dec = mod.CabacDecoder(data)
        ctxs = mod.init_contexts(R_tables.init_mn(2), 30)
        got = []
        for _ in range(4000):
            if rng.random() < 0.7:
                got.append(dec.decision(ctxs[int(rng.integers(0, len(ctxs)))]))
                rng.random()
            else:
                got.append(dec.bypass())
                rng.integers(0, 2)
        outs.append(got)
    assert outs[0] == outs[1]
    stream = HEVC_BENCH.read_bytes()
    units = R_nal.split_annexb(stream)
    assert units == P_nal.split_annexb(stream)
    for u in units[:4]:
        assert R_nal.unescape(u) == P_nal.unescape(u)
    assert P_nal.unescape(b"\x00\x00\x03\x01\x00\x00\x03") == \
        R_nal.unescape(b"\x00\x00\x03\x01\x00\x00\x03")


def _slices(side, stream, limit=None):
    """(sps, pps, slice header, payload, nal type) of each slice, parsed
    by one side's nal and params."""
    m = SIDES[side]
    P, N = m["params"], m["nal"]
    sps, pps, out = {}, {}, []
    for u in N.split_annexb(stream):
        nt = (u[0] >> 1) & 0x3F
        rb = N.unescape(u[2:])
        if nt == P.NAL_SPS:
            s = P.parse_sps(rb)
            sps[s.sps_id] = s
        elif nt == P.NAL_PPS:
            p = P.parse_pps(rb)
            pps[p.pps_id] = p
        elif P.is_slice(nt):
            p = list(pps.values())[-1]
            sh = P.parse_slice_header(rb, nt, sps[p.sps_id], pps)
            out.append((sps[p.sps_id], p, sh, rb[sh.data_bit_pos // 8:],
                        nt))
            if limit and len(out) == limit:
                break
    return out


_GRIDS = ("pf", "mvx", "mvy", "refidx", "bs_v", "bs_h", "qp", "ipm",
          "sao_type", "sao_offset", "sao_band_pos", "sao_eo_class",
          "cbf_luma_map", "ct_depth")


def _parse(side, sps, pps, sh, payload, poc=0, refs=None, rpl=None,
           record=True):
    m = SIDES[side]
    dec = m["ctu"].FrameDec(sps, pps, sh, poc=poc, refs=refs, rpl=rpl)
    if record:
        dec.recorder = m["recorder"].ReconRecorder(dec)
    m["ctu"].CtuCoder(dec, m["cabac"].CabacDecoder(payload),
                      payload=payload).code_slice_data()
    return dec


def _check_frame(a, b):
    for g in _GRIDS:
        assert _same(getattr(a, g), getattr(b, g)), g
    if a.recorder is not None:
        assert a.recorder.max_level == b.recorder.max_level
        assert _same(a.recorder.intra, b.recorder.intra)
        assert _same(a.recorder.tus, b.recorder.tus)
    for p in ("y", "u", "v"):
        np.testing.assert_array_equal(getattr(a, p), getattr(b, p))


def _intra_cases():
    return ["i_mixed", "partial", "tskip", "sao_deblock", "bit10", "bit12",
            "tiles", "wpp"]


@pytest.mark.parametrize("case", _intra_cases())
def test_params_ctu_recorder_and_filters_equal_reference(case):
    """Headers field by field; the recorded parse (lists and grids); the
    inline parse (planes); then the host deblock + SAO on both."""
    stream = _stream(case)
    for (a, b) in zip(_slices("ref", stream), _slices("port", stream)):
        for x, y in zip(a[:3], b[:3]):
            assert _same(x, y)
        _check_frame(_parse("ref", *a[:4]), _parse("port", *b[:4]))
        ra = _parse("ref", *a[:4], record=False)
        pa = _parse("port", *b[:4], record=False)
        _check_frame(ra, pa)
        for side, d in (("ref", ra), ("port", pa)):
            f = SIDES[side]["filter"]
            if not d.sh.deblocking_disabled:
                f.deblock_frame(d)
            if d.sps.sao_enabled and (d.sh.sao_luma or d.sh.sao_chroma):
                f.sao_frame(d)
        _check_frame(ra, pa)


@pytest.mark.parametrize("case", ["p_gop", "b_gop"])
def test_inter_parse_equal_reference(case):
    """P and B frames: each side parses with the reference's decoded
    pictures as its references (host MC inline, and the recorder), and
    the grids, lists and planes agree."""
    from test_torch_hevc import reference
    stream = _stream(case)
    frames = reference(stream)
    by_poc = {}
    ref_sl = _slices("ref", stream)
    port_sl = _slices("port", stream)
    pocs = []
    max_lsb = 1 << ref_sl[0][0].log2_max_poc_lsb
    for sps, pps, sh, _p, nt in ref_sl:
        pocs.append(0 if nt in (R_params.NAL_IDR_W_RADL,
                                R_params.NAL_IDR_N_LP)
                    else sh.poc_lsb % max_lsb)
    for i, f in enumerate(sorted(pocs)):
        by_poc[f] = tuple(np.asarray(p) for p in frames[i].planes)
    for i, (a, b) in enumerate(zip(ref_sl, port_sl)):
        poc = pocs[i]
        refs, rpl = [[], []], [[], []]
        for ll in range(2):
            before = [poc + d for d, u in a[2].rps_neg if u]
            after = [poc + d for d, u in a[2].rps_pos if u]
            lst = before + after if ll == 0 else after + before
            for k in range(a[2].num_ref_idx[ll]):
                rpl[ll].append(lst[k % len(lst)])
                refs[ll].append(by_poc[lst[k % len(lst)]])
        for record in (True, False):
            _check_frame(_parse("ref", *a[:4], poc, refs, rpl, record),
                         _parse("port", *b[:4], poc, refs, rpl, record))


def test_bench_keyframe_parse_equal_reference():
    """The 1920x1080 bench keyframe (1623 intra levels): the recorded
    parse of both sides agrees list by list and grid by grid."""
    stream = HEVC_BENCH.read_bytes()
    a = _slices("ref", stream, 1)[0]
    b = _slices("port", stream, 1)[0]
    ra, pa = _parse("ref", *a[:4]), _parse("port", *b[:4])
    assert ra.recorder.max_level == 1623
    _check_frame(ra, pa)


def test_encode_walker_equal_reference():
    """The CTU walker's encode branch writes the same bits for the same
    plan on both sides (SAO, deblock, tiles)."""
    sps_b = T.make_sps(sao=True)
    pps_b = T.make_pps(tiles=(2, 2), deblock=True)
    bits = []
    for side in ("ref", "port"):
        m = SIDES[side]
        sps = m["params"].parse_sps(m["nal"].unescape(sps_b[6:]))
        pps = m["params"].parse_pps(m["nal"].unescape(pps_b[6:]))
        sh = m["params"].HevcSliceHeader(qp=30, sao_luma=True,
                                         sao_chroma=True)
        dec = m["ctu"].FrameDec(sps, pps, sh)
        cc = m["ctu"].CtuCoder(dec, m["cabac"].CabacEncoder(), encode=True,
                               plan=T.Plan(np.random.default_rng(4)))
        cc.code_slice_data()
        bits.append([e.bitstring() for e in cc.enc_substreams])
    assert len(bits[0]) == 4 and bits[0] == bits[1]


def test_host_transforms_and_predictors_equal_reference():
    rng = np.random.default_rng(2)
    for n in (4, 8, 16, 32):
        c = rng.integers(-32768, 32768, (n, n))
        for bd in (8, 10):
            assert np.array_equal(P_recon.idct(c, bd), R_recon.idct(c, bd))
        left = rng.integers(0, 256, 2 * n + 1)
        top = rng.integers(0, 256, 2 * n + 1)
        top[0] = left[0]
        for mode in range(35):
            for c_idx in (0, 1):
                assert np.array_equal(
                    P_recon.pred_intra(left, top, n, mode, c_idx),
                    R_recon.pred_intra(left, top, n, mode, c_idx))
                assert P_recon.smoothing_applies(mode, n, c_idx) == \
                    R_recon.smoothing_applies(mode, n, c_idx)
        for strong in (False, True):
            assert _same(P_recon.filter_refs(left, top, n, strong),
                         R_recon.filter_refs(left, top, n, strong))
    c4 = rng.integers(-32768, 32768, (4, 4))
    assert np.array_equal(P_recon.idst4(c4), R_recon.idst4(c4))
    for qp in range(-6, 58):
        assert P_recon.chroma_qp(26, qp - 26) == R_recon.chroma_qp(26, qp - 26)
    ref = rng.integers(0, 256, (40, 48)).astype(np.uint8)
    for mv in ((5, -7), (-60, 33), (3, 2)):
        assert np.array_equal(P_inter.mc_luma(ref, 8, 8, 16, 8, mv),
                              R_inter.mc_luma(ref, 8, 8, 16, 8, mv))
        assert np.array_equal(P_inter.mc_chroma(ref, 4, 4, 8, 4, mv),
                              R_inter.mc_chroma(ref, 4, 4, 8, 4, mv))
