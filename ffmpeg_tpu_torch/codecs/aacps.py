"""AAC Parametric Stereo decoder (HE-AAC v2; ISO/IEC 14496-3 8.6.4;
reference: libavcodec/aacps.c:742, aacps_common.c, aacps_tablegen.h).

PS reconstructs a stereo image from a mono SBR downmix plus a small
parameter stream (IID/ICC/IPD/OPD per band per envelope) carried in
the SBR extension. The synthesis runs in the QMF domain on the 38-slot
X matrix the SBR stage already produces:

  hybrid analysis  — QMF bands 0-2 (20-band mode) split into 10
                     sub-subbands with 13-tap complex filterbanks
  decorrelation    — transient-scaled 3-link allpass chain (low
                     bands) / plain delays (high bands) makes the
                     "right difference" signal
  stereo mixing    — per-(envelope, band) 2x2 matrices H from the
                     IID/ICC LUTs, linearly interpolated per slot,
                     with optional IPD/OPD phase rotation
  hybrid synthesis — sub-subbands summed back into QMF bands

All tables are computed here from the spec constants (prototype
filters g0/g1/g2, dequant curves); the huffman codebooks and k→i band
maps come from ps_tables.py (gen tool). Float path only; gated vs the
reference by SNR like the SBR tests.

The port's copy of ffmpeg_tpu/codecs/aacps.py, on the host in numpy."""

from __future__ import annotations

import numpy as np

from .ps_tables import HUFF_OFFSET, HUFF_TABS, K_TO_I_20, K_TO_I_34

# ---------------------------------------------------------------------------
# constants (aacps.c:189-198)

NR_PAR_BANDS = (20, 34)
NR_IPDOPD_BANDS = (11, 17)
NR_BANDS = (71, 91)
DECAY_CUTOFF = (10, 32)
NR_ALLPASS_BANDS = (30, 50)
SHORT_DELAY_BAND = (42, 62)
DECAY_SLOPE = 0.05
MAX_DELAY = 14
AP_LINKS = 3
AP_DELAYS = (3, 4, 5)          # per-link z^-delay (spec 8.6.4.6.5)
NUM_ENV_TAB = ((0, 1, 2, 4), (1, 2, 3, 4))
NR_IIDICC_PAR_TAB = (10, 20, 34, 10, 20, 34)
NR_IPDOPD_PAR_TAB = (5, 11, 17, 5, 11, 17)
K_TO_I = (np.asarray(K_TO_I_20), np.asarray(K_TO_I_34))


# ---------------------------------------------------------------------------
# derived tables (aacps_tablegen.h ps_tableinit)


def _make_filter(proto, bands):
    f = np.zeros((bands, 8, 2))
    for q in range(bands):
        for n in range(7):
            theta = 2 * np.pi * (q + 0.5) * (n - 6) / bands
            f[q, n, 0] = proto[n] * np.cos(theta)
            f[q, n, 1] = proto[n] * -np.sin(theta)
    return f


_g0_Q8 = [0.00746082949812, 0.02270420949825, 0.04546865930473,
          0.07266113929591, 0.09885108575264, 0.11793710567217, 0.125]
_g0_Q12 = [0.04081179924692, 0.03812810994926, 0.05144908135699,
           0.06399831151592, 0.07428313801106, 0.08100347892914,
           0.08333333333333]
_g1_Q8 = [0.01565675600122, 0.03752716391991, 0.05417891378782,
          0.08417044116767, 0.10307344158036, 0.12222452249753, 0.125]
_g2_Q4 = [-0.05908211155639, -0.04871498374946, 0.0, 0.07778723915851,
          0.16486303567403, 0.23279856662996, 0.25]
_g1_Q2 = [0.0, 0.01899487526049, 0.0, -0.07293139167538, 0.0,
          0.30596630545168, 0.5]

F20_0_8 = _make_filter(_g0_Q8, 8)
F34_0_12 = _make_filter(_g0_Q12, 12)
F34_1_8 = _make_filter(_g1_Q8, 8)
F34_2_4 = _make_filter(_g2_Q4, 4)

_iid_par_dequant = np.array([
    0.05623413251903, 0.12589254117942, 0.19952623149689,
    0.31622776601684, 0.44668359215096, 0.63095734448019,
    0.79432823472428, 1, 1.25892541179417, 1.58489319246111,
    2.23872113856834, 3.16227766016838, 5.01187233627272,
    7.94328234724282, 17.7827941003892,
    0.00316227766017, 0.00562341325190, 0.01, 0.01778279410039,
    0.03162277660168, 0.05623413251903, 0.07943282347243,
    0.11220184543020, 0.15848931924611, 0.22387211385683,
    0.31622776601684, 0.39810717055350, 0.50118723362727,
    0.63095734448019, 0.79432823472428, 1, 1.25892541179417,
    1.58489319246111, 1.99526231496888, 2.51188643150958,
    3.16227766016838, 4.46683592150963, 6.30957344480193,
    8.91250938133745, 12.5892541179417, 17.7827941003892,
    31.6227766016838, 56.2341325190349, 100, 177.827941003892,
    316.227766016837])
_icc_invq = np.array([1, 0.937, 0.84118, 0.60092, 0.36764, 0,
                      -0.589, -1])
_acos_icc_invq = np.arccos(_icc_invq)

HA = np.zeros((46, 8, 4))
HB = np.zeros((46, 8, 4))
for _iid in range(46):
    _c = _iid_par_dequant[_iid]
    _c1 = np.sqrt(2.0) / np.sqrt(1.0 + _c * _c)
    _c2 = _c * _c1
    for _icc in range(8):
        _alpha = 0.5 * _acos_icc_invq[_icc]
        _beta = _alpha * (_c1 - _c2) * np.sqrt(0.5)
        HA[_iid, _icc, 0] = _c2 * np.cos(_beta + _alpha)
        HA[_iid, _icc, 1] = _c1 * np.cos(_beta - _alpha)
        HA[_iid, _icc, 2] = _c2 * np.sin(_beta + _alpha)
        HA[_iid, _icc, 3] = _c1 * np.sin(_beta - _alpha)
        # mixing procedure B (icc_mode >= 3)
        _rho = max(_icc_invq[_icc], 0.05)
        _a = 0.5 * np.arctan2(2.0 * _c * _rho, _c * _c - 1.0)
        _mu = _c + 1.0 / _c
        _mu = np.sqrt(1 + (4 * _rho * _rho - 4) / (_mu * _mu))
        _gamma = np.arctan(np.sqrt((1.0 - _mu) / (1.0 + _mu)))
        if _a < 0:
            _a += np.pi / 2
        HB[_iid, _icc, 0] = np.sqrt(2) * np.cos(_a) * np.cos(_gamma)
        HB[_iid, _icc, 1] = np.sqrt(2) * np.sin(_a) * np.cos(_gamma)
        HB[_iid, _icc, 2] = -np.sqrt(2) * np.sin(_a) * np.sin(_gamma)
        HB[_iid, _icc, 3] = np.sqrt(2) * np.cos(_a) * np.sin(_gamma)

_f_center_20 = np.array([-3, -1, 1, 3, 5, 7, 10, 14, 18, 22]) * 0.125
_f_center_34 = np.array([
    2, 6, 10, 14, 18, 22, 26, 30, 34, -10, -6, -2, 51, 57, 15, 21,
    27, 33, 39, 45, 54, 66, 78, 42, 102, 66, 78, 90, 102, 114, 126,
    90]) / 24.0
_frac_links = (0.43, 0.75, 0.347)
_frac_gain = 0.39

Q_FRACT = np.zeros((2, 50, AP_LINKS), np.complex128)
PHI_FRACT = np.zeros((2, 50), np.complex128)
for _k in range(30):
    _fc = _f_center_20[_k] if _k < 10 else _k - 6.5
    for _m in range(AP_LINKS):
        _th = -np.pi * _frac_links[_m] * _fc
        Q_FRACT[0, _k, _m] = np.cos(_th) + 1j * np.sin(_th)
    _th = -np.pi * _frac_gain * _fc
    PHI_FRACT[0, _k] = np.cos(_th) + 1j * np.sin(_th)
for _k in range(50):
    _fc = _f_center_34[_k] if _k < 32 else _k - 26.5
    for _m in range(AP_LINKS):
        _th = -np.pi * _frac_links[_m] * _fc
        Q_FRACT[1, _k, _m] = np.cos(_th) + 1j * np.sin(_th)
    _th = -np.pi * _frac_gain * _fc
    PHI_FRACT[1, _k] = np.cos(_th) + 1j * np.sin(_th)

_ipdopd_sin = np.array([0, np.sqrt(0.5), 1, np.sqrt(0.5), 0,
                        -np.sqrt(0.5), -1, -np.sqrt(0.5)])
_ipdopd_cos = np.array([1, np.sqrt(0.5), 0, -np.sqrt(0.5), -1,
                        -np.sqrt(0.5), 0, np.sqrt(0.5)])
PD_RE = np.zeros(8 * 8 * 8)
PD_IM = np.zeros(8 * 8 * 8)
for _p0 in range(8):
    for _p1 in range(8):
        for _p2 in range(8):
            _re = 0.25 * _ipdopd_cos[_p0] + 0.5 * _ipdopd_cos[_p1] \
                + _ipdopd_cos[_p2]
            _im = 0.25 * _ipdopd_sin[_p0] + 0.5 * _ipdopd_sin[_p1] \
                + _ipdopd_sin[_p2]
            _mag = 1.0 / np.hypot(_im, _re)
            PD_RE[_p0 * 64 + _p1 * 8 + _p2] = _re * _mag
            PD_IM[_p0 * 64 + _p1 * 8 + _p2] = _im * _mag


# ---------------------------------------------------------------------------
# huffman (canonical codes from (symbol, length) pairs in table order,
# ff_vlc_init_tables_from_lengths semantics)


def _build_huff(tab, offset):
    codes = {}
    code = 0
    for sym, ln in tab:
        codes[(ln, code >> (32 - ln))] = sym + offset
        code += 1 << (32 - ln)
    return codes


HUFF = [_build_huff(t, o) for t, o in zip(HUFF_TABS, HUFF_OFFSET)]
# encode-direction maps for crafted-stream tests
HUFF_ENC = []
for _t, _o in zip(HUFF_TABS, HUFF_OFFSET):
    _m = {}
    _code = 0
    for _sym, _ln in _t:
        _m[_sym + _o] = (_ln, _code >> (32 - _ln))
        _code += 1 << (32 - _ln)
    HUFF_ENC.append(_m)

(IID_DF1, IID_DT1, IID_DF0, IID_DT0, ICC_DF, ICC_DT,
 IPD_DF, IPD_DT, OPD_DF, OPD_DT) = range(10)


def _huff_read(br, table):
    ln = 0
    code = 0
    while ln < 20:
        code = (code << 1) | br.get(1)
        ln += 1
        v = table.get((ln, code))
        if v is not None:
            return v
    from ..utils.error import InvalidData
    raise InvalidData("aacps: bad huffman code")


# ---------------------------------------------------------------------------
# parameter band remapping (aacps.c:201-398)


def _map_idx_10_to_20(par, full):
    n = 10 if full else 5
    out = np.zeros(20 if full else 11, par.dtype)
    for b in range(n):
        out[2 * b] = out[2 * b + 1] = par[b]
    return out


def _map_idx_34_to_20(par, full):
    out = np.zeros(20 if full else 11, par.dtype)
    p = par.astype(np.int32)
    out[0] = (2 * p[0] + p[1]) // 3
    out[1] = (p[1] + 2 * p[2]) // 3
    out[2] = (2 * p[3] + p[4]) // 3
    out[3] = (p[4] + 2 * p[5]) // 3
    out[4] = (p[6] + p[7]) // 2
    out[5] = (p[8] + p[9]) // 2
    out[6] = p[10]
    out[7] = p[11]
    out[8] = (p[12] + p[13]) // 2
    out[9] = (p[14] + p[15]) // 2
    out[10] = p[16]
    if full:
        out[11] = p[17]
        out[12] = p[18]
        out[13] = p[19]
        out[14] = (p[20] + p[21]) // 2
        out[15] = (p[22] + p[23]) // 2
        out[16] = (p[24] + p[25]) // 2
        out[17] = (p[26] + p[27]) // 2
        out[18] = (p[28] + p[29] + p[30] + p[31]) // 4
        out[19] = (p[32] + p[33]) // 2
    return out


def _map_idx_10_to_34(par, full):
    out = np.zeros(34 if full else 17, par.dtype)
    if full:
        out[28:34] = par[9]
        out[24:28] = par[8]
        out[20:24] = par[7]
        out[18:20] = par[6]
        out[16:18] = par[5]
    else:
        out[16] = 0
    out[12:16] = par[4]
    out[10:12] = par[3]
    out[6:10] = par[2]
    out[3:6] = par[1]
    out[0:3] = par[0]
    return out


def _map_idx_20_to_34(par, full):
    out = np.zeros(34 if full else 17, par.dtype)
    p = par.astype(np.int32)
    if full:
        out[32:34] = p[19]
        out[28:32] = p[18]
        out[26:28] = p[17]
        out[24:26] = p[16]
        out[22:24] = p[15]
        out[20:22] = p[14]
        out[19] = p[13]
        out[18] = p[12]
        out[17] = p[11]
    out[16] = p[10]
    out[14:16] = p[9]
    out[12:14] = p[8]
    out[11] = p[7]
    out[10] = p[6]
    out[8:10] = p[5]
    out[6:8] = p[4]
    out[5] = p[3]
    out[4] = (p[2] + p[3]) // 2
    out[3] = p[2]
    out[2] = p[1]
    out[1] = (p[0] + p[1]) // 2
    out[0] = p[0]
    return out


def _map_val_20_to_34(par):
    p = par.copy()
    out = np.zeros(34)
    out[32:34] = p[19]
    out[28:32] = p[18]
    out[26:28] = p[17]
    out[24:26] = p[16]
    out[22:24] = p[15]
    out[20:22] = p[14]
    out[19] = p[13]
    out[18] = p[12]
    out[17] = p[11]
    out[16] = p[10]
    out[14:16] = p[9]
    out[12:14] = p[8]
    out[11] = p[7]
    out[10] = p[6]
    out[8:10] = p[5]
    out[6:8] = p[4]
    out[5] = p[3]
    out[4] = 0.5 * (p[2] + p[3])
    out[3] = p[2]
    out[2] = p[1]
    out[1] = 0.5 * (p[0] + p[1])
    out[0] = p[0]
    return out


def _map_val_34_to_20(par):
    p = par.copy()
    out = np.zeros(34)
    out[0] = (2 * p[0] + p[1]) / 3
    out[1] = (p[1] + 2 * p[2]) / 3
    out[2] = (2 * p[3] + p[4]) / 3
    out[3] = (p[4] + 2 * p[5]) / 3
    out[4] = (p[6] + p[7]) / 2
    out[5] = (p[8] + p[9]) / 2
    out[6] = p[10]
    out[7] = p[11]
    out[8] = (p[12] + p[13]) / 2
    out[9] = (p[14] + p[15]) / 2
    out[10] = p[16]
    out[11] = p[17]
    out[12] = p[18]
    out[13] = p[19]
    out[14] = (p[20] + p[21]) / 2
    out[15] = (p[22] + p[23]) / 2
    out[16] = (p[24] + p[25]) / 2
    out[17] = (p[26] + p[27]) / 2
    out[18] = (p[28] + p[29] + p[30] + p[31]) / 4
    out[19] = (p[32] + p[33]) / 2
    return out


# ---------------------------------------------------------------------------


class PSContext:
    """Parse + apply state (PSContext/PSCommonContext analog)."""

    def __init__(self):
        self.start = 0
        self.enable_iid = 0
        self.iid_quant = 0
        self.nr_iid_par = 0
        self.enable_icc = 0
        self.icc_mode = 0
        self.nr_icc_par = 0
        self.enable_ext = 0
        self.enable_ipdopd = 0
        self.nr_ipdopd_par = 0
        self.frame_class = 0
        self.num_env = 0
        self.num_env_old = 0
        self.border_position = np.zeros(6, np.int32)
        self.iid_par = np.zeros((5, 34), np.int8)
        self.icc_par = np.zeros((5, 34), np.int8)
        self.ipd_par = np.zeros((5, 17), np.int8)
        self.opd_par = np.zeros((5, 17), np.int8)
        self.is34 = 0
        self.is34_old = 0
        # synthesis state
        self.in_hist = np.zeros((6, 64), np.complex128)  # hybrid taps
        self.delay = np.zeros((91, MAX_DELAY), np.complex128)
        # linear 37-slot line per band+link (32 slots + 5 history),
        # reads at n+2-m (delay 3+m), writes at n+5 (aacpsdsp decorrelate)
        self.ap_delay = np.zeros((50, AP_LINKS, 37), np.complex128)
        self.peak_decay_nrg = np.zeros(34)
        self.power_smooth = np.zeros(34)
        self.peak_decay_diff_smooth = np.zeros(34)
        self.H = np.zeros((4, 2, 6, 34))     # [h11..h22][re/im][env+1][b]
        self.ipd_hist = np.zeros(17, np.int32)
        self.opd_hist = np.zeros(17, np.int32)

    # ------------------------------------------------------------ parse
    def _read_par(self, br, par, nr, table_dt, table_df, e,
                  mask=None, limit=None):
        """READ_PAR_DATA analog (aacps_common.c:63)."""
        from ..utils.error import InvalidData
        dt = br.get(1)
        table = HUFF[table_dt if dt else table_df]
        if dt:
            e_prev = max(e - 1 if e else self.num_env_old - 1, 0)
            for b in range(nr):
                val = int(par[e_prev, b]) + _huff_read(br, table)
                if mask is not None:
                    val &= mask
                par[e, b] = val
                if limit is not None and abs(val) > limit:
                    raise InvalidData("aacps: parameter out of range")
        else:
            val = 0
            for b in range(nr):
                val += _huff_read(br, table)
                if mask is not None:
                    val &= mask
                par[e, b] = val
                if limit is not None and abs(val) > limit:
                    raise InvalidData("aacps: parameter out of range")

    def read_data(self, br, bits_left):
        """ff_ps_read_data (aacps_common.c:133)."""
        from ..utils.error import InvalidData
        start_bits = br.pos if hasattr(br, "pos") else None
        if br.get(1):                 # enable_ps_header
            self.enable_iid = br.get(1)
            if self.enable_iid:
                iid_mode = br.get(3)
                if iid_mode > 5:
                    raise InvalidData("aacps: reserved iid_mode")
                self.nr_iid_par = NR_IIDICC_PAR_TAB[iid_mode]
                self.iid_quant = int(iid_mode > 2)
                self.nr_ipdopd_par = NR_IPDOPD_PAR_TAB[iid_mode]
            self.enable_icc = br.get(1)
            if self.enable_icc:
                self.icc_mode = br.get(3)
                if self.icc_mode > 5:
                    raise InvalidData("aacps: reserved icc_mode")
                self.nr_icc_par = NR_IIDICC_PAR_TAB[self.icc_mode]
            self.enable_ext = br.get(1)
            self.start = 1

        self.frame_class = br.get(1)
        self.num_env_old = self.num_env
        self.num_env = NUM_ENV_TAB[self.frame_class][br.get(2)]
        self.border_position[0] = -1
        if self.frame_class:
            for e in range(1, self.num_env + 1):
                self.border_position[e] = br.get(5)
                if self.border_position[e] < self.border_position[e - 1]:
                    raise InvalidData("aacps: non-monotone borders")
        else:
            lg = max(self.num_env.bit_length() - 1, 0)
            for e in range(1, self.num_env + 1):
                self.border_position[e] = (e * 32 >> lg) - 1

        if self.enable_iid:
            for e in range(self.num_env):
                self._read_par(
                    br, self.iid_par, self.nr_iid_par,
                    IID_DT1 if self.iid_quant else IID_DT0,
                    IID_DF1 if self.iid_quant else IID_DF0, e,
                    limit=7 + 8 * self.iid_quant)
        else:
            self.iid_par[:] = 0
        if self.enable_icc:
            for e in range(self.num_env):
                self._read_par(br, self.icc_par, self.nr_icc_par,
                               ICC_DT, ICC_DF, e)
                if (self.icc_par[e, :self.nr_icc_par] > 7).any():
                    raise InvalidData("aacps: icc out of range")
        else:
            self.icc_par[:] = 0
        if self.enable_ext:
            cnt = br.get(4)
            if cnt == 15:
                cnt += br.get(8)
            cnt *= 8
            while cnt > 7:
                before = br.pos
                ext_id = br.get(2)
                if ext_id == 0:
                    self.enable_ipdopd = br.get(1)
                    if self.enable_ipdopd:
                        for e in range(self.num_env):
                            self._read_par(br, self.ipd_par,
                                           self.nr_ipdopd_par,
                                           IPD_DT, IPD_DF, e,
                                           mask=0x07)
                            self._read_par(br, self.opd_par,
                                           self.nr_ipdopd_par,
                                           OPD_DT, OPD_DF, e,
                                           mask=0x07)
                    br.get(1)         # reserved_ps
                cnt -= br.pos - before
            if cnt < 0:
                raise InvalidData("aacps: extension overflow")
            br.skip(cnt)

        # fake envelope covering the frame tail
        if self.num_env == 0 or \
                self.border_position[self.num_env] < 31:
            source = self.num_env - 1 if self.num_env else \
                self.num_env_old - 1
            if source >= 0 and source != self.num_env:
                self.iid_par[self.num_env] = self.iid_par[source]
                self.icc_par[self.num_env] = self.icc_par[source]
                self.ipd_par[self.num_env] = self.ipd_par[source]
                self.opd_par[self.num_env] = self.opd_par[source]
            self.num_env += 1
            self.border_position[self.num_env] = 31

        self.is34_old = self.is34
        if self.enable_iid or self.enable_icc:
            self.is34 = int(
                (self.enable_iid and self.nr_iid_par == 34)
                or (self.enable_icc and self.nr_icc_par == 34))
        if not self.enable_ipdopd:
            self.ipd_par[:] = 0
            self.opd_par[:] = 0

    # -------------------------------------------------------- synthesis
    def _hybrid_analysis(self, X):
        """X (38, 64) complex → (NR_BANDS, 32) complex sub-subbands.
        Consumes 6 history slots kept in in_hist."""
        is34 = self.is34
        nb = NR_BANDS[is34]
        full = np.concatenate([self.in_hist, X], axis=0)  # (44, 64)
        self.in_hist = full[32:38].copy()
        out = np.zeros((nb, 32), np.complex128)

        def filt(band, filters, n):
            """13-tap complex filterbank on QMF band → n outputs x 32
            slots (ps_hybrid_analysis_c)."""
            sig = full[:, band]               # (44,)
            # windows: slot i uses sig[i .. i+12]
            win = np.lib.stride_tricks.sliding_window_view(sig, 13)
            win = win[:32]                    # (32, 13)
            f = filters[:n]                   # (n, 8, 2)
            fc = f[:, :7, 0] + 1j * f[:, :7, 1]       # (n, 7)
            # sum over j of filter[j] * in[j] + conj-sym second half:
            # reference folds in[j] and in[12-j]; equivalent full form:
            # out = sum_{t=0..12} h[t] * win[t] with h[t] defined by
            # the symmetric extension h[t] = f[t] (t<=6),
            # h[12-j] = conj-ish… — do it exactly as the reference:
            re0 = win[:, :6].real + win[:, 12:6:-1].real   # (32, 6)
            re1 = win[:, :6].imag - win[:, 12:6:-1].imag
            im0 = win[:, :6].imag + win[:, 12:6:-1].imag
            im1 = win[:, :6].real - win[:, 12:6:-1].real
            sum_re = (f[:, 6, 0][:, None] * win[:, 6].real[None, :]
                      + fc[:, :6].real @ re0.T - fc[:, :6].imag @ re1.T)
            sum_im = (f[:, 6, 0][:, None] * win[:, 6].imag[None, :]
                      + fc[:, :6].real @ im0.T + fc[:, :6].imag @ im1.T)
            return sum_re + 1j * sum_im       # (n, 32)

        if is34:
            out[0:12] = filt(0, F34_0_12, 12)
            out[12:20] = filt(1, F34_1_8, 8)
            out[20:24] = filt(2, F34_2_4, 4)
            out[24:28] = filt(3, F34_2_4, 4)
            out[28:32] = filt(4, F34_2_4, 4)
            out[32:] = full[6:6 + 32, 5:64].T
        else:
            t8 = filt(0, F20_0_8, 8)
            # hybrid6: reorder + pair sums (aacps.c hybrid6_cx)
            out[0] = t8[6]
            out[1] = t8[7]
            out[2] = t8[0]
            out[3] = t8[1]
            out[4] = t8[2] + t8[5]
            out[5] = t8[3] + t8[4]
            # hybrid2_re on bands 1 and 2 (aacps.c hybrid2_re)
            g = np.asarray(_g1_Q2)
            for band, pos, reverse in ((1, 6, 1), (2, 8, 0)):
                sig = full[:, band]
                win = np.lib.stride_tricks.sliding_window_view(sig, 13)
                win = win[:32]
                inphase = g[6] * win[:, 6]
                op = (g[1] * (win[:, 1] + win[:, 11])
                      + g[3] * (win[:, 3] + win[:, 9])
                      + g[5] * (win[:, 5] + win[:, 7]))
                out[pos + reverse] = inphase + op
                out[pos + 1 - reverse] = inphase - op
            out[10:] = full[6:6 + 32, 3:64].T[:nb - 10]
        return out

    def _hybrid_synthesis(self, sub):
        """(NR_BANDS, 32) complex → (32, 64) complex QMF."""
        is34 = self.is34
        out = np.zeros((32, 64), np.complex128)
        if is34:
            out[:, 0] = sub[0:12].sum(0)
            out[:, 1] = sub[12:20].sum(0)
            out[:, 2] = sub[20:24].sum(0)
            out[:, 3] = sub[24:28].sum(0)
            out[:, 4] = sub[28:32].sum(0)
            out[:, 5:] = sub[32:].T
        else:
            out[:, 0] = sub[0:6].sum(0)
            out[:, 1] = sub[6:8].sum(0)
            out[:, 2] = sub[8:10].sum(0)
            out[:, 3:] = sub[10:].T
        return out

    def _decorrelate(self, s):
        """aacps.c decorrelation: (nb, 32) → (nb, 32)."""
        is34 = self.is34
        nb = NR_BANDS[is34]
        k_to_i = K_TO_I[is34]
        npar = NR_PAR_BANDS[is34]
        if is34 != self.is34_old:
            self.peak_decay_nrg[:] = 0
            self.power_smooth[:] = 0
            self.peak_decay_diff_smooth[:] = 0
            self.delay[:] = 0
            self.ap_delay[:] = 0

        power = np.zeros((34, 32))
        mag2 = (s.real * s.real + s.imag * s.imag)
        for k in range(nb):
            power[k_to_i[k]] += mag2[k]

        transient_gain = np.ones((34, 32))
        peak_decay_factor = 0.76592833836465
        a_smooth = 0.25
        transient_impact = 1.5
        for i in range(npar):
            pd = self.peak_decay_nrg[i]
            psm = self.power_smooth[i]
            pdd = self.peak_decay_diff_smooth[i]
            for n in range(32):
                pd = max(pd * peak_decay_factor, power[i, n])
                psm += a_smooth * (power[i, n] - psm)
                pdd += a_smooth * (pd - power[i, n] - pdd)
                denom = transient_impact * pdd
                if denom > psm:
                    transient_gain[i, n] = psm / denom
            self.peak_decay_nrg[i] = pd
            self.power_smooth[i] = psm
            self.peak_decay_diff_smooth[i] = pdd

        out = np.zeros_like(s)
        a = (0.65143905753106, 0.56471812200776, 0.48954165955695)
        for k in range(NR_ALLPASS_BANDS[is34]):
            b = k_to_i[k]
            g = np.clip(1.0 - DECAY_SLOPE * (k - DECAY_CUTOFF[is34]),
                        0.0, 1.0)
            # delay line: per-slot z^-2 input
            dl = np.concatenate([self.delay[k], s[k]])
            self.delay[k] = dl[-MAX_DELAY:]
            ap = self.ap_delay[k]
            ap[:, :5] = ap[:, 32:37]      # carry 5-slot history
            for n in range(32):
                x = dl[MAX_DELAY - 2 + n] * PHI_FRACT[is34, k]
                for m in range(AP_LINKS):
                    ag = a[m] * g
                    link = ap[m, n + 2 - m]
                    y = link * Q_FRACT[is34, k, m] - ag * x
                    ap[m, n + 5] = x + ag * y
                    x = y
                out[k, n] = transient_gain[b, n] * x
        for k in range(NR_ALLPASS_BANDS[is34], SHORT_DELAY_BAND[is34]):
            b = k_to_i[k]
            dl = np.concatenate([self.delay[k], s[k]])
            self.delay[k] = dl[-MAX_DELAY:]
            out[k] = transient_gain[b] * dl[MAX_DELAY - 14:
                                            MAX_DELAY - 14 + 32]
        for k in range(SHORT_DELAY_BAND[is34], nb):
            b = k_to_i[k]
            dl = np.concatenate([self.delay[k], s[k]])
            self.delay[k] = dl[-MAX_DELAY:]
            out[k] = transient_gain[b] * dl[MAX_DELAY - 1:
                                            MAX_DELAY - 1 + 32]
        return out

    def _remap_pars(self, par, nr, full):
        is34 = self.is34
        out = []
        for e in range(self.num_env):
            p = par[e]
            if is34:
                if nr in (20, 11):
                    out.append(_map_idx_20_to_34(p, full))
                elif nr in (10, 5):
                    out.append(_map_idx_10_to_34(p, full))
                else:
                    out.append(p)
            else:
                if nr in (34, 17):
                    out.append(_map_idx_34_to_20(p, full))
                elif nr in (10, 5):
                    out.append(_map_idx_10_to_20(p, full))
                else:
                    out.append(p)
        return out

    def _stereo_processing(self, lbuf, rbuf):
        is34 = self.is34
        npar = NR_PAR_BANDS[is34]
        k_to_i = K_TO_I[is34]
        H = self.H
        # carry last frame's final H into slot 0
        if self.num_env_old:
            H[:, :, 0] = H[:, :, self.num_env_old]
        iid_m = self._remap_pars(self.iid_par, self.nr_iid_par, 1)
        icc_m = self._remap_pars(self.icc_par, self.nr_icc_par, 1)
        if self.enable_ipdopd:
            ipd_m = self._remap_pars(self.ipd_par,
                                     self.nr_ipdopd_par, 0)
            opd_m = self._remap_pars(self.opd_par,
                                     self.nr_ipdopd_par, 0)
        if is34 and not self.is34_old:
            for hi in range(4):
                for c in range(2):
                    H[hi, c, 0, :34] = _map_val_20_to_34(H[hi, c, 0])
            self.ipd_hist[:] = 0
            self.opd_hist[:] = 0
        elif not is34 and self.is34_old:
            for hi in range(4):
                for c in range(2):
                    H[hi, c, 0, :34] = _map_val_34_to_20(H[hi, c, 0])
            self.ipd_hist[:] = 0
            self.opd_hist[:] = 0

        H_LUT = HA if self.icc_mode < 3 else HB
        for e in range(self.num_env):
            for b in range(npar):
                iid_idx = int(iid_m[e][b]) + 7 + 23 * self.iid_quant
                icc_idx = int(icc_m[e][b])
                h11, h12, h21, h22 = H_LUT[iid_idx, icc_idx]
                if self.enable_ipdopd and b < NR_IPDOPD_BANDS[is34]:
                    opd_idx = self.opd_hist[b] * 8 + int(opd_m[e][b])
                    ipd_idx = self.ipd_hist[b] * 8 + int(ipd_m[e][b])
                    opd_re = PD_RE[opd_idx]
                    opd_im = PD_IM[opd_idx]
                    ipd_re = PD_RE[ipd_idx]
                    ipd_im = PD_IM[ipd_idx]
                    self.opd_hist[b] = opd_idx & 0x3F
                    self.ipd_hist[b] = ipd_idx & 0x3F
                    ipd_adj_re = opd_re * ipd_re + opd_im * ipd_im
                    ipd_adj_im = opd_im * ipd_re - opd_re * ipd_im
                    H[0, 1, e + 1, b] = h11 * opd_im
                    H[1, 1, e + 1, b] = h12 * ipd_adj_im
                    H[2, 1, e + 1, b] = h21 * opd_im
                    H[3, 1, e + 1, b] = h22 * ipd_adj_im
                    h11 = h11 * opd_re
                    h12 = h12 * ipd_adj_re
                    h21 = h21 * opd_re
                    h22 = h22 * ipd_adj_re
                H[0, 0, e + 1, b] = h11
                H[1, 0, e + 1, b] = h12
                H[2, 0, e + 1, b] = h21
                H[3, 0, e + 1, b] = h22
            start = int(self.border_position[e])
            stop = int(self.border_position[e + 1])
            width = 1.0 / max(stop - start, 1)
            for k in range(NR_BANDS[is34]):
                b = k_to_i[k]
                h = H[:, 0, e, b].copy()
                hi = H[:, 1, e, b].copy()
                if self.enable_ipdopd and (
                        (is34 and 9 <= k <= 13)
                        or (not is34 and k <= 1)):
                    hi = -hi
                hs = (H[:, 0, e + 1, b] - h) * width
                hsi = (H[:, 1, e + 1, b] - hi) * width
                if stop - start <= 0:
                    continue
                ns = np.arange(1, stop - start + 1)
                t = start + ns               # slots start+1 .. stop
                hh = h[:, None] + ns[None, :] * hs[:, None]
                hhi = hi[:, None] + ns[None, :] * hsi[:, None]
                l = lbuf[k, t]
                r = rbuf[k, t]
                if self.enable_ipdopd:
                    Hc11 = hh[0] + 1j * hhi[0]
                    Hc12 = hh[1] + 1j * hhi[1]
                    Hc21 = hh[2] + 1j * hhi[2]
                    Hc22 = hh[3] + 1j * hhi[3]
                    lbuf[k, t] = Hc11 * l + Hc21 * r
                    rbuf[k, t] = Hc12 * l + Hc22 * r
                else:
                    lbuf[k, t] = hh[0] * l + hh[2] * r
                    rbuf[k, t] = hh[1] * l + hh[3] * r

    def apply(self, X, top):
        """X (38, 64) complex mono QMF → (L32, R32) (32, 64) complex.
        top = kx + m (bands in use; delays above are cleared)."""
        is34 = self.is34
        topb = top + NR_BANDS[is34] - 64
        if topb < NR_BANDS[is34]:
            self.delay[max(topb, 0):] = 0
        if topb < NR_ALLPASS_BANDS[is34]:
            self.ap_delay[max(topb, 0):] = 0
        lbuf = self._hybrid_analysis(X)
        rbuf = self._decorrelate(lbuf)
        self._stereo_processing(lbuf, rbuf)
        return (self._hybrid_synthesis(lbuf),
                self._hybrid_synthesis(rbuf))
