"""The port's copies of the reference's H.264 host modules
(codecs/h264/tables.py, params.py, cavlc.py, recon.py, inter.py,
slice_dec.py, cabac_slice.py, recon_host.py, loopfilter.py, conceal.py)
against the reference, on the CPU: their code, statement for statement
(the module docstrings aside); the tables; the SPS/PPS headers; the
CAVLC and CABAC parse arrays of every picture of the crafted matrix;
the host reconstruction, concealment and deblocking on the reference's
own parse; the encode direction of the CABAC slice coder; and the
inter and intra predictors."""

import ast
import dataclasses
import inspect

import numpy as np
import pytest

from ffmpeg_tpu.codecs.h264 import cabac as R_cabac
from ffmpeg_tpu.codecs.h264 import cabac_slice as R_cs
from ffmpeg_tpu.codecs.h264 import conceal as R_conceal
from ffmpeg_tpu.codecs.h264 import inter as R_inter
from ffmpeg_tpu.codecs.h264 import loopfilter as R_lf
from ffmpeg_tpu.codecs.h264 import nal as R_nal
from ffmpeg_tpu.codecs.h264 import params as R_params
from ffmpeg_tpu.codecs.h264 import recon as R_recon
from ffmpeg_tpu.codecs.h264 import recon_host as R_rh
from ffmpeg_tpu.codecs.h264 import tables as R_tables
from ffmpeg_tpu_torch.codecs.h264 import cabac as P_cabac
from ffmpeg_tpu_torch.codecs.h264 import cabac_slice as P_cs
from ffmpeg_tpu_torch.codecs.h264 import conceal as P_conceal
from ffmpeg_tpu_torch.codecs.h264 import inter as P_inter
from ffmpeg_tpu_torch.codecs.h264 import loopfilter as P_lf
from ffmpeg_tpu_torch.codecs.h264 import params as P_params
from ffmpeg_tpu_torch.codecs.h264 import recon as P_recon
from ffmpeg_tpu_torch.codecs.h264 import recon_host as P_rh
from ffmpeg_tpu_torch.codecs.h264 import tables as P_tables
from ffmpeg_tpu_torch.testing import h264_slice_from_reference

from torch_h264_util import STREAMS, ref_pictures

COPIES = ["tables", "params", "cavlc", "recon", "inter", "slice_dec",
          "cabac_slice", "recon_host", "loopfilter", "conceal"]

# the parse arrays the reconstruction reads (slice_dec.py SliceDecoder)
PARSE = ["coeff_y", "coeff_u", "coeff_v", "coeff8_y", "trans8", "i4_pred",
         "i8_pred", "i16_mode", "blk_avail", "blk8_avail", "chroma_imode",
         "is_pcm", "mb_nbr_avail", "mb_avail", "nnz_y", "nnz_u", "nnz_v",
         "mb_qp", "mb_intra", "mb_16x16", "mv", "mv_ref"]


def _code(mod):
    tree = ast.parse(inspect.getsource(mod))
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(
            getattr(body[0], "value", None), ast.Constant):
        body = body[1:]
    return [ast.dump(n) for n in body]


@pytest.mark.parametrize("name", COPIES)
def test_copy_is_the_reference_code(name):
    import importlib
    ref = importlib.import_module(f"ffmpeg_tpu.codecs.h264.{name}")
    port = importlib.import_module(f"ffmpeg_tpu_torch.codecs.h264.{name}")
    assert _code(port) == _code(ref)


def test_tables_equal_reference():
    names = [n for n in dir(R_tables) if n.isupper()]
    assert names
    for n in names:
        assert getattr(P_tables, n) == getattr(R_tables, n), n
    np.testing.assert_array_equal(P_params.ZZ8, R_params.ZZ8)
    for n in ("ZIGZAG4", "FIELD4", "FIELD8"):
        np.testing.assert_array_equal(getattr(P_recon, n),
                                      getattr(R_recon, n))


@pytest.mark.parametrize("name", ["i4", "i8x8_cabac", "scaling_matrices",
                                  "paff_i16", "hbd12_p", "long_term0"])
def test_headers_equal_reference(name):
    units = R_nal.split_annexb(STREAMS[name]())
    r_sps, p_sps = {}, {}
    n = 0
    for u in units:
        t = u[0] & 0x1F
        rbsp = R_nal.unescape(u[1:])
        if t == 7:
            a, b = R_params.parse_sps(rbsp), P_params.parse_sps(rbsp)
            r_sps[a.sps_id], p_sps[b.sps_id] = a, b
        elif t == 8:
            a = R_params.parse_pps(rbsp, r_sps)
            b = P_params.parse_pps(rbsp, p_sps)
        else:
            continue
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.keys() == db.keys()
        for k in da:
            np.testing.assert_equal(db[k], da[k], err_msg=k)
        n += 1
    assert n >= 2


def _port_pictures(stream, monkeypatch):
    """The port's parse of every picture (host path), before its
    reconstruction."""
    from ffmpeg_tpu_torch.codecs.h264 import H264Decoder
    from torch_h264_util import port_frames
    caps = []
    orig = H264Decoder._emit

    def emit(self, dec, pkt):
        caps.append({k: np.copy(getattr(dec, k)) for k in PARSE})
        return orig(self, dec, pkt)
    monkeypatch.setattr(H264Decoder, "_emit", emit)
    port_frames(stream, {"recon": "host"})
    monkeypatch.setattr(H264Decoder, "_emit", orig)
    return caps


@pytest.mark.parametrize("name", ["i4_residual", "ipcm", "p_gop_deblocked",
                                  "b8x8_temporal", "cabac_b",
                                  "cabac_b_multiref", "i8x8_cabac",
                                  "p_trans8_cavlc", "weighted_large",
                                  "paff_field_gop", "truncated_p"])
def test_parse_arrays_equal_reference(name, monkeypatch):
    stream = STREAMS[name]()
    ref = ref_pictures(stream, monkeypatch)
    port = _port_pictures(stream, monkeypatch)
    assert len(ref) == len(port) and ref
    for i, ((rdec, _a, _w), p) in enumerate(zip(ref, port)):
        for k in PARSE:
            np.testing.assert_array_equal(p[k], getattr(rdec, k),
                                          err_msg=f"picture {i} {k}")


@pytest.mark.parametrize("name", ["p_gop_deblocked", "cabac_b",
                                  "p_trans8_cabac", "implicit_bipred0",
                                  "truncated_p", "truncated_idr"])
def test_host_reconstruction_equal_reference(name, monkeypatch):
    """recon_host.reconstruct, conceal_missing and deblock_frame of both
    packages on one parse (the reference's, copied for each)."""
    for dec, (alpha, beta, deblock), want in ref_pictures(
            STREAMS[name](), monkeypatch):
        r = h264_slice_from_reference(dec)      # the same parse twice
        outs = []
        for d, rh, cc, lf in ((r, R_rh, R_conceal, R_lf),
                              (dec, P_rh, P_conceal, P_lf)):
            rh.reconstruct(d)
            if not d.mb_avail.all():
                cc.conceal_missing(d)
            if deblock:
                lf.deblock_frame(d, alpha, beta)
            outs.append((d.y, d.u, d.v))
        for a, b, w in zip(*outs, want):
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(b, w)


def test_cabac_slice_encoder_equal_reference():
    """The encode direction (CabacSliceCoder(..., encode=True)) writes
    the same bits in both packages for one macroblock sequence."""
    streams = []
    for cs, cab, par in ((R_cs, R_cabac, R_params), (P_cs, P_cabac,
                                                      P_params)):
        units = R_nal.split_annexb(STREAMS["cabac_i_deblocked"]())
        sps = par.parse_sps(R_nal.unescape(units[0][1:]))
        pps = par.parse_pps(R_nal.unescape(units[1][1:]), {0: sps})
        from importlib import import_module
        sd = import_module(cs.__name__.rsplit(".", 1)[0] + ".slice_dec")
        dec = sd.SliceDecoder(sps, pps)
        enc = cab.CabacEncoder()
        sc = cs.CabacSliceCoder(dec, enc, 2, 26, encode=True)
        r = np.random.default_rng(3)
        for idx in range(6):
            mbx, mby = idx % 4, idx // 4
            sc.intra_mb_type(mbx, mby, 3, 1, v=(1, 15 * int(r.integers(
                0, 2)), int(r.integers(0, 3)), int(r.integers(0, 4))))
            sc.chroma_pred_mode(mbx, mby, v=int(r.integers(0, 4)))
            sc.mb_qp_delta(v=int(r.integers(-3, 4)))
            lv = [int(v) for v in r.integers(-4, 5, 16)]
            sc.residual(2, mbx, mby, mbx * 4, mby * 4, 16, True,
                        levels=lv)
            dec.mb_avail[mby, mbx] = True
            enc.terminate(1 if idx == 5 else 0)
        streams.append(enc.bitstring())
    assert streams[0] == streams[1] and len(streams[0]) > 16


def test_inter_and_intra_predictors_equal_reference():
    rng = np.random.default_rng(9)
    ref = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    for _ in range(40):
        mvx, mvy = (int(v) for v in rng.integers(-90, 90, 2))
        x, y = (int(v) for v in rng.integers(0, 60, 2))
        np.testing.assert_array_equal(
            P_inter.mc_luma(ref, mvx, mvy, x, y, 4, 4),
            R_inter.mc_luma(ref, mvx, mvy, x, y, 4, 4))
        np.testing.assert_array_equal(
            P_inter.mc_chroma(ref[:24, :32], mvx, mvy, x // 2, y // 2,
                              2, 2),
            R_inter.mc_chroma(ref[:24, :32], mvx, mvy, x // 2, y // 2,
                              2, 2))
    for m in range(9):
        for av in ((True, True, True, True), (False, True, False, True),
                   (True, False, False, False)):
            np.testing.assert_array_equal(
                P_recon.pred4x4(ref, 20, 16, m, *av),
                R_recon.pred4x4(ref, 20, 16, m, *av))
            np.testing.assert_array_equal(
                P_recon.pred8x8(ref, 24, 16, m, *av),
                R_recon.pred8x8(ref, 24, 16, m, *av))
    for m in range(4):
        np.testing.assert_array_equal(
            P_recon.pred16x16(ref, 16, 16, m, True, True),
            R_recon.pred16x16(ref, 16, 16, m, True, True))
    assert P_inter.median_mv((1, 5), (3, -2), (2, 9)) == \
        R_inter.median_mv((1, 5), (3, -2), (2, 9))
