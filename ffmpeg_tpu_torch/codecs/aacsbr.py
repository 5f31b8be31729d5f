"""Spectral Band Replication (HE-AAC) decoder, float port of the
reference pipeline (ISO 14496-3 §4.6.18; reference:
libavcodec/aacsbr_template.c + aacsbr.c + sbrdsp.c). The QMF
modulations run as dense matrix products equivalent to the reference's
MDCT fast path; everything else is a faithful float port validated by
SNR gates against the reference decoder.

The port's copy of ffmpeg_tpu/codecs/aacsbr.py: all of it runs on the
host in numpy, the QMF banks included, as in the JAX package; the port's
AAC decoder (aac.py) feeds it the core's PCM after its device IMDCT."""

from __future__ import annotations

import numpy as np

from ..utils.error import InvalidData
from . import aacsbr_tables as T

NOISE_FLOOR_OFFSET = 6
EAO = 2                                   # ENVELOPE_ADJUSTMENT_OFFSET
VOFF_SIZE = (1280 - 128) * 2              # SBR_SYNTHESIS_BUF_SIZE
FIXFIX, FIXVAR, VARFIX, VARVAR = range(4)

(T_HUFFMAN_ENV_1_5DB, F_HUFFMAN_ENV_1_5DB, T_HUFFMAN_ENV_BAL_1_5DB,
 F_HUFFMAN_ENV_BAL_1_5DB, T_HUFFMAN_ENV_3_0DB, F_HUFFMAN_ENV_3_0DB,
 T_HUFFMAN_ENV_BAL_3_0DB, F_HUFFMAN_ENV_BAL_3_0DB,
 T_HUFFMAN_NOISE_3_0DB, T_HUFFMAN_NOISE_BAL_3_0DB) = range(10)


def _build_huffman():
    tabs = []
    pos = 0
    for i, nb in enumerate(T.HUFFMAN_NB):
        pairs = T.HUFFMAN_PAIRS[pos:pos + nb]
        pos += nb
        code = 0
        last_len = 0
        m = {}
        enc = {}
        for sym, ln in pairs:
            code <<= (int(ln) - last_len)
            last_len = int(ln)
            m[(int(ln), code)] = int(sym) + T.HUFFMAN_OFFSETS[i]
            enc[int(sym) + T.HUFFMAN_OFFSETS[i]] = (int(ln), code)
            code += 1
        tabs.append((m, enc))
    return tabs


HUFF = _build_huffman()


def huff_dec(br, idx):
    m = HUFF[idx][0]
    code = 0
    ln = 0
    while ln < 24:
        code = (code << 1) | br.get(1)
        ln += 1
        if (ln, code) in m:
            return m[(ln, code)]
    raise InvalidData("sbr: bad huffman code")


# ---- QMF modulation matrices (built once) ---------------------------

def _imdct64_matrix():
    """av_tx naive inverse MDCT, len=64 (tx_template.c
    ff_tx_mdct_naive_inv): 64 coeffs → 64 samples."""
    L, L2 = 32, 64
    phase = np.pi / (4.0 * L2)
    j = np.arange(L2)
    M = np.zeros((64, 64))
    for i in range(L):
        M[i] = np.cos((2 * j + 1) * (phase * (4 * L - 2 * i - 1)))
        M[i + L] = -np.cos((2 * j + 1) * (phase * (3 * L2 + 2 * i + 1)))
    return M


_IMDCT64 = _imdct64_matrix()
_ANA_SCALE = -2.0 * 32768.0
_SYN_SCALE = 1.0 / (64 * 32768.0)


def qmf_analysis(x_state, samples):
    """32-band analysis (aacsbr_template.c sbr_qmf_analysis):
    x_state (288,) persistent; samples (1024,) → W (32, 32) complex."""
    buf = np.concatenate([x_state, samples])   # 288 + 1024 = 1312
    W = np.zeros((32, 32), np.complex128)
    wds = T.QMF_WINDOW_DS
    k = np.arange(1, 32)
    kk = np.arange(32)
    for i in range(32):
        seg = buf[i * 32:i * 32 + 320]
        z = wds * seg[::-1]
        u = z[:64] + z[64:128] + z[128:192] + z[192:256] + z[256:320]
        z64 = np.empty(64)
        z64[0] = u[0]
        z64[1] = u[1]
        z64[2 * k] = -u[64 - k]
        z64[2 * k + 1] = u[k + 1]
        out = _ANA_SCALE * (_IMDCT64 @ z64)
        W[i] = -out[63 - kk] + 1j * out[kk]
    x_state[:] = buf[1024:]
    return W


def qmf_synthesis(state, X):
    """64-band synthesis (sbr_qmf_synthesis, full rate): X (32, 64)
    complex → (2048,) samples. state: dict with v (VOFF_SIZE,) and
    v_off."""
    out = np.zeros(2048)
    v0 = state["v"]
    wus = T.QMF_WINDOW_US
    for i in range(32):
        if state["v_off"] < 128:
            saved = 1280 - 128
            v0[VOFF_SIZE - saved:] = v0[:saved]
            state["v_off"] = VOFF_SIZE - saved - 128
        else:
            state["v_off"] -= 128
        v = v0[state["v_off"]:]
        xre = X[i].real.copy()
        xim = X[i].imag.copy()
        xim[1::2] = -xim[1::2]            # neg_odd_64
        b0 = _SYN_SCALE * (_IMDCT64 @ xre)
        b1 = _SYN_SCALE * (_IMDCT64 @ xim)
        k = np.arange(64)
        v[k] = b1 - b0[63 - k]
        v[127 - k] = b1 + b0[63 - k]
        acc = v[0:64] * wus[0:64]
        for t, wo in ((192, 64), (256, 128), (448, 192), (512, 256),
                      (704, 320), (768, 384), (960, 448), (1024, 512),
                      (1216, 576)):
            acc = acc + v[t:t + 64] * wus[wo:wo + 64]
        out[i * 64:(i + 1) * 64] = acc
    return out


def make_bands(start, stop, num_bands):
    base = np.power(np.float32(stop) / start,
                    np.float32(1.0) / num_bands, dtype=np.float32)
    prod = np.float32(start)
    previous = start
    bands = []
    for k in range(num_bands - 1):
        prod = np.float32(prod * base)
        present = int(np.rint(prod))
        bands.append(present - previous)
        previous = present
    bands.append(stop - previous)
    return bands


class SBRData:
    def __init__(self):
        self.bs_freq_res = [0] * 7
        self.bs_num_env = 0
        self.bs_amp_res = 0
        self.bs_num_noise = 0
        self.bs_frame_class = 0
        self.t_env = [0] * 8
        self.t_env_num_env_old = 0
        self.t_q = [0] * 3
        self.e_a = [-1, -1]
        self.bs_df_env = [0] * 5
        self.bs_df_noise = [0] * 2
        self.bs_invf_mode = [[0] * 5, [0] * 5]
        self.env_facs_q = np.zeros((6, 48), np.int32)
        self.env_facs = np.zeros((6, 48))
        self.noise_facs_q = np.zeros((3, 5), np.int32)
        self.noise_facs = np.zeros((3, 5))
        self.bs_add_harmonic_flag = 0
        self.bs_add_harmonic = np.zeros(48, np.int32)
        self.s_indexmapped = np.zeros((8, 48), np.int32)
        self.bw_array = np.zeros(5)
        self.x = np.zeros(288)
        self.W = np.zeros((2, 32, 32), np.complex128)
        self.Ypos = 0
        self.Y = np.zeros((2, 38, 64), np.complex128)
        self.g_temp = np.zeros((42, 48))
        self.q_temp = np.zeros((42, 48))
        self.f_indexnoise = 0
        self.f_indexsine = 0
        self.synth = {"v": np.zeros(VOFF_SIZE),
                      "v_off": VOFF_SIZE - (1280 - 128)}


class SBRContext:
    def __init__(self, sample_rate):
        self.ps = None                    # PSContext when HE-AACv2
        self.synth_r = None               # right-channel QMF synthesis
        self.sample_rate = 2 * sample_rate
        self.start = 0
        self.reset = 0
        self.id_aac = None
        self.ready_for_dequant = 0
        self.kx = [32, 32]
        self.m = [0, 0]
        self.kx_and_m_pushed = 0
        self.bs_coupling = 0
        self.bs_amp_res_header = 1
        self.spectrum = None              # dict of header freq params
        self.bs_limiter_bands = 2
        self.bs_limiter_gains = 2
        self.bs_interpol_freq = 1
        self.bs_smoothing_mode = 1
        self.data = [SBRData(), SBRData()]
        self.n = [0, 0]
        self.n_q = 0
        self.n_lim = 0
        self.n_master = 0
        self.k = [0, 0, 0]
        self.f_master = np.zeros(49, np.int32)
        self.f_tablehigh = np.zeros(49, np.int32)
        self.f_tablelow = np.zeros(25, np.int32)
        self.f_tablenoise = np.zeros(6, np.int32)
        self.f_tablelim = np.zeros(30, np.int32)
        self.num_patches = 0
        self.patch_num_subbands = [0] * 6
        self.patch_start_subband = [0] * 6
        self.X_low = np.zeros((32, 40), np.complex128)
        self.X_high = np.zeros((64, 40), np.complex128)
        self.alpha0 = np.zeros(32, np.complex128)
        self.alpha1 = np.zeros(32, np.complex128)
        self.e_origmapped = np.zeros((5, 48))
        self.q_mapped = np.zeros((5, 48))
        self.s_mapped = np.zeros((5, 48), np.int32)
        self.e_curr = np.zeros((5, 48))
        self.q_m = np.zeros((5, 48))
        self.s_m = np.zeros((5, 48))
        self.gain = np.zeros((5, 48))

    # -- header / frequency tables -------------------------------------
    def turnoff(self):
        self.start = 0
        self.ready_for_dequant = 0
        self.kx[1] = 32
        self.m[1] = 0
        self.data[0].e_a[1] = self.data[1].e_a[1] = -1
        self.spectrum = None

    def read_header(self, br):
        old = dict(self.spectrum) if self.spectrum else None
        old_lim = self.bs_limiter_bands
        self.start = 1
        self.ready_for_dequant = 0
        s = {}
        self.bs_amp_res_header = br.get(1)
        s["start_freq"] = br.get(4)
        s["stop_freq"] = br.get(4)
        s["xover_band"] = br.get(3)
        br.skip(2)
        extra1 = br.get(1)
        extra2 = br.get(1)
        if extra1:
            s["freq_scale"] = br.get(2)
            s["alter_scale"] = br.get(1)
            s["noise_bands"] = br.get(2)
        else:
            s["freq_scale"] = 2
            s["alter_scale"] = 1
            s["noise_bands"] = 2
        if old != s:
            self.reset = 1
        self.spectrum = s
        if extra2:
            self.bs_limiter_bands = br.get(2)
            self.bs_limiter_gains = br.get(2)
            self.bs_interpol_freq = br.get(1)
            self.bs_smoothing_mode = br.get(1)
        else:
            self.bs_limiter_bands = 2
            self.bs_limiter_gains = 2
            self.bs_interpol_freq = 1
            self.bs_smoothing_mode = 1
        if self.bs_limiter_bands != old_lim and not self.reset:
            self.make_f_tablelim()

    def make_f_master(self):
        s = self.spectrum
        sr = self.sample_rate
        idx = {16000: 0, 22050: 1, 24000: 2, 32000: 3}.get(sr)
        if idx is None:
            if sr in (44100, 48000, 64000):
                idx = 4
            elif sr in (88200, 96000, 128000, 176400, 192000):
                idx = 5
            else:
                raise InvalidData(f"sbr: unsupported rate {sr}")
        offs = T.SBR_OFFSET[idx]
        temp = 3000 if sr < 32000 else (4000 if sr < 64000 else 5000)
        start_min = ((temp << 7) + (sr >> 1)) // sr
        stop_min = ((temp << 8) + (sr >> 1)) // sr
        self.k[0] = start_min + int(offs[s["start_freq"]])
        if s["stop_freq"] < 14:
            k2 = stop_min
            dk = sorted(make_bands(stop_min, 64, 13))
            k2 += sum(dk[:s["stop_freq"]])
            self.k[2] = k2
        elif s["stop_freq"] == 14:
            self.k[2] = 2 * self.k[0]
        else:
            self.k[2] = 3 * self.k[0]
        self.k[2] = min(64, self.k[2])
        max_sb = 48 if sr <= 32000 else (35 if sr == 44100 else 32)
        if self.k[2] - self.k[0] > max_sb or self.k[2] <= self.k[0]:
            raise InvalidData("sbr: invalid qmf band range")
        fm = np.zeros(49, np.int32)
        if not s["freq_scale"]:
            dk = s["alter_scale"] + 1
            n_master = ((self.k[2] - self.k[0] + (dk & 2)) >> dk) << 1
            if n_master <= 0 or s["xover_band"] >= n_master:
                raise InvalidData("sbr: bad n_master")
            vals = np.full(n_master, dk, np.int32)
            k2diff = self.k[2] - self.k[0] - n_master * dk
            if k2diff < 0:
                vals[0] -= 1
                if k2diff < -1:
                    vals[1] -= 1
            elif k2diff:
                vals[-1] += 1
            fm[0] = self.k[0]
            fm[1:n_master + 1] = self.k[0] + np.cumsum(vals)
            self.n_master = n_master
        else:
            half_bands = 7 - s["freq_scale"]
            if 49 * self.k[2] > 110 * self.k[0]:
                two_regions = 1
                self.k[1] = 2 * self.k[0]
            else:
                two_regions = 0
                self.k[1] = self.k[2]
            num_bands_0 = int(np.rint(
                half_bands * np.log2(self.k[1] /
                                     np.float32(self.k[0])))) * 2
            if num_bands_0 <= 0:
                raise InvalidData("sbr: bad num_bands_0")
            vk0 = sorted(make_bands(self.k[0], self.k[1], num_bands_0))
            if any(v <= 0 for v in vk0):
                raise InvalidData("sbr: bad vDk0")
            vdk0_max = vk0[-1]
            acc = [self.k[0]]
            for v in vk0:
                acc.append(acc[-1] + v)
            if two_regions:
                invwarp = 0.76923076923076923077 \
                    if s["alter_scale"] else 1.0
                num_bands_1 = int(np.rint(
                    half_bands * invwarp *
                    np.log2(self.k[2] / np.float32(self.k[1])))) * 2
                vk1 = make_bands(self.k[1], self.k[2], num_bands_1)
                if min(vk1) < vdk0_max:
                    vk1 = sorted(vk1)
                    change = min(vdk0_max - vk1[0],
                                 (vk1[-1] - vk1[0]) >> 1)
                    vk1[0] += change
                    vk1[-1] -= change
                vk1 = sorted(vk1)
                if any(v <= 0 for v in vk1):
                    raise InvalidData("sbr: bad vDk1")
                for v in vk1:
                    acc.append(acc[-1] + v)
                self.n_master = num_bands_0 + num_bands_1
            else:
                self.n_master = num_bands_0
            if s["xover_band"] >= self.n_master:
                raise InvalidData("sbr: bad xover band")
            fm[:self.n_master + 1] = acc
        self.f_master = fm

    def make_f_derived(self):
        s = self.spectrum
        self.n[1] = self.n_master - s["xover_band"]
        self.n[0] = (self.n[1] + 1) >> 1
        self.f_tablehigh = self.f_master[
            s["xover_band"]:s["xover_band"] + self.n[1] + 1].copy()
        self.m[1] = int(self.f_tablehigh[self.n[1]] -
                        self.f_tablehigh[0])
        self.kx[1] = int(self.f_tablehigh[0])
        if self.kx[1] + self.m[1] > 64 or self.kx[1] > 32:
            raise InvalidData("sbr: bad frequency borders")
        tmp = self.n[1] & 1
        self.f_tablelow = np.zeros(self.n[0] + 1, np.int32)
        self.f_tablelow[0] = self.f_tablehigh[0]
        for k in range(1, self.n[0] + 1):
            self.f_tablelow[k] = self.f_tablehigh[2 * k - tmp]
        self.n_q = max(1, int(np.rint(
            s["noise_bands"] *
            np.log2(self.k[2] / np.float32(self.kx[1])))))
        if self.n_q > 5:
            raise InvalidData("sbr: too many noise bands")
        self.f_tablenoise = np.zeros(self.n_q + 1, np.int32)
        self.f_tablenoise[0] = self.f_tablelow[0]
        temp = 0
        for k in range(1, self.n_q + 1):
            temp += (self.n[0] - temp) // (self.n_q + 1 - k)
            self.f_tablenoise[k] = self.f_tablelow[temp]
        self.calc_patches()
        self.make_f_tablelim()
        self.data[0].f_indexnoise = 0
        self.data[1].f_indexnoise = 0

    def calc_patches(self):
        sr = self.sample_rate
        goal_sb = ((1000 << 11) + (sr >> 1)) // sr
        msb = self.k[0]
        usb = self.kx[1]
        self.num_patches = 0
        if goal_sb < self.kx[1] + self.m[1]:
            k = 0
            while self.f_master[k] < goal_sb:
                k += 1
        else:
            k = self.n_master
        last_k = last_msb = -1
        sb = 0
        while True:
            if k == last_k and msb == last_msb:
                raise InvalidData("sbr: patch construction failed")
            last_k, last_msb = k, msb
            odd = 0
            i = k
            while i == k or sb > (self.k[0] - 1 + msb - odd):
                sb = int(self.f_master[i])
                odd = (sb + self.k[0]) & 1
                i -= 1
            if self.num_patches > 5:
                raise InvalidData("sbr: too many patches")
            self.patch_num_subbands[self.num_patches] = max(sb - usb, 0)
            self.patch_start_subband[self.num_patches] = \
                self.k[0] - odd - self.patch_num_subbands[
                    self.num_patches]
            if self.patch_num_subbands[self.num_patches] > 0:
                usb = sb
                msb = sb
                self.num_patches += 1
            else:
                msb = self.kx[1]
            if self.f_master[k] - sb < 3:
                k = self.n_master
            if sb == self.kx[1] + self.m[1]:
                break
        if self.num_patches > 1 and \
                self.patch_num_subbands[self.num_patches - 1] < 3:
            self.num_patches -= 1

    def make_f_tablelim(self):
        if self.bs_limiter_bands > 0:
            warped = [1.32715174233856803909, 1.18509277094158210129,
                      1.11987160404675912501][self.bs_limiter_bands - 1]
            borders = [self.kx[1]]
            for k in range(self.num_patches):
                borders.append(borders[-1] + self.patch_num_subbands[k])
            tbl = list(self.f_tablelow[:self.n[0] + 1])
            if self.num_patches > 1:
                tbl += borders[1:self.num_patches]
            tbl.sort()
            n_lim = self.n[0] + self.num_patches - 1
            out = 0
            inp = 1
            while out < n_lim:
                if tbl[inp] >= tbl[out] * warped:
                    out += 1
                    tbl[out] = tbl[inp]
                    inp += 1
                elif tbl[inp] == tbl[out] or \
                        tbl[inp] not in borders:
                    inp += 1
                    n_lim -= 1
                elif tbl[out] not in borders:
                    tbl[out] = tbl[inp]
                    inp += 1
                    n_lim -= 1
                else:
                    out += 1
                    tbl[out] = tbl[inp]
                    inp += 1
            self.n_lim = n_lim
            self.f_tablelim = np.asarray(tbl[:n_lim + 1], np.int32)
        else:
            self.n_lim = 1
            self.f_tablelim = np.asarray(
                [self.f_tablelow[0], self.f_tablelow[self.n[0]]],
                np.int32)

    # -- bitstream: per-channel data -----------------------------------
    def read_grid(self, br, ch):
        cd = self.data[ch]
        abs_bord_trail = 16
        bs_num_env_old = cd.bs_num_env
        cd.bs_freq_res[0] = cd.bs_freq_res[cd.bs_num_env]
        cd.bs_amp_res = self.bs_amp_res_header
        cd.t_env_num_env_old = cd.t_env[bs_num_env_old]
        bs_pointer = 0
        cls = br.get(2)
        ceil_log2 = [0, 1, 2, 2, 3, 3]
        if cls == FIXFIX:
            bs_num_env = 1 << br.get(2)
            if bs_num_env > 5:
                raise InvalidData("sbr: too many envelopes")
            cd.bs_num_env = bs_num_env
            if bs_num_env == 1:
                cd.bs_amp_res = 0
            cd.t_env[0] = 0
            cd.t_env[bs_num_env] = abs_bord_trail
            step = (abs_bord_trail + (bs_num_env >> 1)) // bs_num_env
            for i in range(bs_num_env - 1):
                cd.t_env[i + 1] = cd.t_env[i] + step
            cd.bs_freq_res[1] = br.get(1)
            for i in range(1, bs_num_env):
                cd.bs_freq_res[i + 1] = cd.bs_freq_res[1]
        elif cls == FIXVAR:
            abs_bord_trail += br.get(2)
            num_rel_trail = br.get(2)
            cd.bs_num_env = num_rel_trail + 1
            cd.t_env[0] = 0
            cd.t_env[cd.bs_num_env] = abs_bord_trail
            for i in range(num_rel_trail):
                cd.t_env[cd.bs_num_env - 1 - i] = \
                    cd.t_env[cd.bs_num_env - i] - 2 * br.get(2) - 2
            bs_pointer = br.get(ceil_log2[cd.bs_num_env])
            for i in range(cd.bs_num_env):
                cd.bs_freq_res[cd.bs_num_env - i] = br.get(1)
        elif cls == VARFIX:
            cd.t_env[0] = br.get(2)
            num_rel_lead = br.get(2)
            cd.bs_num_env = num_rel_lead + 1
            cd.t_env[cd.bs_num_env] = abs_bord_trail
            for i in range(num_rel_lead):
                cd.t_env[i + 1] = cd.t_env[i] + 2 * br.get(2) + 2
            bs_pointer = br.get(ceil_log2[cd.bs_num_env])
            for i in range(cd.bs_num_env):
                cd.bs_freq_res[i + 1] = br.get(1)
        else:                             # VARVAR
            cd.t_env[0] = br.get(2)
            abs_bord_trail += br.get(2)
            num_rel_lead = br.get(2)
            num_rel_trail = br.get(2)
            bs_num_env = num_rel_lead + num_rel_trail + 1
            if bs_num_env > 5:
                raise InvalidData("sbr: too many envelopes")
            cd.bs_num_env = bs_num_env
            cd.t_env[bs_num_env] = abs_bord_trail
            for i in range(num_rel_lead):
                cd.t_env[i + 1] = cd.t_env[i] + 2 * br.get(2) + 2
            for i in range(num_rel_trail):
                cd.t_env[bs_num_env - 1 - i] = \
                    cd.t_env[bs_num_env - i] - 2 * br.get(2) - 2
            bs_pointer = br.get(ceil_log2[bs_num_env])
            for i in range(bs_num_env):
                cd.bs_freq_res[i + 1] = br.get(1)
        cd.bs_frame_class = cls
        if bs_pointer > cd.bs_num_env + 1:
            raise InvalidData("sbr: bad bs_pointer")
        for i in range(1, cd.bs_num_env + 1):
            if cd.t_env[i - 1] >= cd.t_env[i]:
                raise InvalidData("sbr: non-monotone time borders")
        cd.bs_num_noise = (1 if cd.bs_num_env > 1 else 0) + 1
        cd.t_q[0] = cd.t_env[0]
        cd.t_q[cd.bs_num_noise] = cd.t_env[cd.bs_num_env]
        if cd.bs_num_noise > 1:
            if cls == FIXFIX:
                idx = cd.bs_num_env >> 1
            elif cls & 1:                 # FIXVAR / VARVAR
                idx = cd.bs_num_env - max(bs_pointer - 1, 1)
            else:                         # VARFIX
                if not bs_pointer:
                    idx = 1
                elif bs_pointer == 1:
                    idx = cd.bs_num_env - 1
                else:
                    idx = bs_pointer - 1
            cd.t_q[1] = cd.t_env[idx]
        cd.e_a[0] = -(cd.e_a[1] != bs_num_env_old)
        cd.e_a[1] = -1
        if (cls & 1) and bs_pointer:
            cd.e_a[1] = cd.bs_num_env + 1 - bs_pointer
        elif cls == 2 and bs_pointer > 1:
            cd.e_a[1] = bs_pointer - 1

    def copy_grid(self, dst, src):
        dst.bs_freq_res[0] = dst.bs_freq_res[dst.bs_num_env]
        dst.t_env_num_env_old = dst.t_env[dst.bs_num_env]
        dst.e_a[0] = -(dst.e_a[1] != dst.bs_num_env)
        dst.bs_freq_res[1:] = list(src.bs_freq_res[1:])
        dst.t_env = list(src.t_env)
        dst.t_q = list(src.t_q)
        dst.bs_num_env = src.bs_num_env
        dst.bs_amp_res = src.bs_amp_res
        dst.bs_num_noise = src.bs_num_noise
        dst.bs_frame_class = src.bs_frame_class
        dst.e_a[1] = src.e_a[1]

    def read_dtdf(self, br, ch):
        cd = self.data[ch]
        cd.bs_df_env = [br.get(1) for _ in range(cd.bs_num_env)]
        cd.bs_df_noise = [br.get(1) for _ in range(cd.bs_num_noise)]

    def read_invf(self, br, ch):
        cd = self.data[ch]
        cd.bs_invf_mode[1] = list(cd.bs_invf_mode[0])
        for i in range(self.n_q):
            cd.bs_invf_mode[0][i] = br.get(2)

    def read_envelope(self, br, ch):
        cd = self.data[ch]
        delta = 2 if (ch == 1 and self.bs_coupling) else 1
        odd = self.n[1] & 1
        if self.bs_coupling and ch:
            if cd.bs_amp_res:
                bits, th, fh = 5, T_HUFFMAN_ENV_BAL_3_0DB, \
                    F_HUFFMAN_ENV_BAL_3_0DB
            else:
                bits, th, fh = 6, T_HUFFMAN_ENV_BAL_1_5DB, \
                    F_HUFFMAN_ENV_BAL_1_5DB
        else:
            if cd.bs_amp_res:
                bits, th, fh = 6, T_HUFFMAN_ENV_3_0DB, \
                    F_HUFFMAN_ENV_3_0DB
            else:
                bits, th, fh = 7, T_HUFFMAN_ENV_1_5DB, \
                    F_HUFFMAN_ENV_1_5DB
        for i in range(cd.bs_num_env):
            fr1 = cd.bs_freq_res[i + 1]
            fr0 = cd.bs_freq_res[i]
            if cd.bs_df_env[i]:
                if fr1 == fr0:
                    for j in range(self.n[fr1]):
                        cd.env_facs_q[i + 1][j] = \
                            cd.env_facs_q[i][j] + \
                            delta * huff_dec(br, th)
                elif fr1:
                    for j in range(self.n[fr1]):
                        k = (j + odd) >> 1
                        cd.env_facs_q[i + 1][j] = \
                            cd.env_facs_q[i][k] + \
                            delta * huff_dec(br, th)
                else:
                    for j in range(self.n[fr1]):
                        k = 2 * j - odd if j else 0
                        cd.env_facs_q[i + 1][j] = \
                            cd.env_facs_q[i][k] + \
                            delta * huff_dec(br, th)
            else:
                cd.env_facs_q[i + 1][0] = delta * br.get(bits)
                for j in range(1, self.n[fr1]):
                    cd.env_facs_q[i + 1][j] = \
                        cd.env_facs_q[i + 1][j - 1] + \
                        delta * huff_dec(br, fh)
            if np.any(cd.env_facs_q[i + 1][:self.n[fr1]] > 127) or \
                    np.any(cd.env_facs_q[i + 1][:self.n[fr1]] < 0):
                raise InvalidData("sbr: env_facs_q out of range")
        cd.env_facs_q[0] = cd.env_facs_q[cd.bs_num_env]

    def read_noise(self, br, ch):
        cd = self.data[ch]
        delta = 2 if (ch == 1 and self.bs_coupling) else 1
        if self.bs_coupling and ch:
            th, fh = T_HUFFMAN_NOISE_BAL_3_0DB, F_HUFFMAN_ENV_BAL_3_0DB
        else:
            th, fh = T_HUFFMAN_NOISE_3_0DB, F_HUFFMAN_ENV_3_0DB
        for i in range(cd.bs_num_noise):
            if cd.bs_df_noise[i]:
                for j in range(self.n_q):
                    cd.noise_facs_q[i + 1][j] = \
                        cd.noise_facs_q[i][j] + delta * huff_dec(br, th)
            else:
                cd.noise_facs_q[i + 1][0] = delta * br.get(5)
                for j in range(1, self.n_q):
                    cd.noise_facs_q[i + 1][j] = \
                        cd.noise_facs_q[i + 1][j - 1] + \
                        delta * huff_dec(br, fh)
            if np.any(cd.noise_facs_q[i + 1][:self.n_q] > 30) or \
                    np.any(cd.noise_facs_q[i + 1][:self.n_q] < 0):
                raise InvalidData("sbr: noise_facs_q out of range")
        cd.noise_facs_q[0] = cd.noise_facs_q[cd.bs_num_noise]

    def read_data(self, br, id_aac):
        self.id_aac = id_aac
        self.ready_for_dequant = 1
        if id_aac == "sce":
            if br.get(1):                 # bs_data_extra
                br.skip(4)
            self.read_grid(br, 0)
            self.read_dtdf(br, 0)
            self.read_invf(br, 0)
            self.read_envelope(br, 0)
            self.read_noise(br, 0)
            self.data[0].bs_add_harmonic_flag = br.get(1)
            if self.data[0].bs_add_harmonic_flag:
                for i in range(self.n[1]):
                    self.data[0].bs_add_harmonic[i] = br.get(1)
        else:                             # cpe
            if br.get(1):
                br.skip(8)
            self.bs_coupling = br.get(1)
            if self.bs_coupling:
                self.read_grid(br, 0)
                self.copy_grid(self.data[1], self.data[0])
                self.read_dtdf(br, 0)
                self.read_dtdf(br, 1)
                self.read_invf(br, 0)
                self.data[1].bs_invf_mode[1] = \
                    list(self.data[1].bs_invf_mode[0])
                self.data[1].bs_invf_mode[0] = \
                    list(self.data[0].bs_invf_mode[0])
                self.read_envelope(br, 0)
                self.read_noise(br, 0)
                self.read_envelope(br, 1)
                self.read_noise(br, 1)
            else:
                self.read_grid(br, 0)
                self.read_grid(br, 1)
                self.read_dtdf(br, 0)
                self.read_dtdf(br, 1)
                self.read_invf(br, 0)
                self.read_invf(br, 1)
                self.read_envelope(br, 0)
                self.read_envelope(br, 1)
                self.read_noise(br, 0)
                self.read_noise(br, 1)
            for ch in range(2):
                self.data[ch].bs_add_harmonic_flag = br.get(1)
                if self.data[ch].bs_add_harmonic_flag:
                    for i in range(self.n[1]):
                        self.data[ch].bs_add_harmonic[i] = br.get(1)
        if br.get(1):                     # bs_extended_data
            nbits = br.get(4)
            if nbits == 15:
                nbits += br.get(8)
            nbits <<= 3
            while nbits > 7:
                before = br.pos
                ext_id = br.get(2)
                if ext_id == 2:           # EXTENSION_ID_PS
                    from .aacps import PSContext
                    if self.ps is None:
                        self.ps = PSContext()
                    self.ps.read_data(br, nbits - 2)
                else:
                    # reserved extension: skip the fill bits
                    br.skip(nbits - 2)
                nbits -= br.pos - before
            if nbits > 0:
                br.skip(nbits)

    def decode_extension(self, br, crc, id_aac):
        """FIL-element SBR payload (ff_aac_sbr_decode_extension)."""
        self.reset = 0
        if crc:
            br.skip(10)
        if br.get(1):                     # bs_header_flag
            self.read_header(br)
        self.kx[0] = self.kx[1]
        self.m[0] = self.m[1]
        self.kx_and_m_pushed = 1
        if self.reset:
            try:
                self.make_f_master()
                self.make_f_derived()
            except InvalidData:
                self.turnoff()
        if self.start:
            try:
                self.read_data(br, id_aac)
            except InvalidData:
                self.turnoff()

    # -- dequant + DSP --------------------------------------------------
    def dequant(self):
        sqrt2 = np.sqrt(2.0)
        if self.id_aac == "cpe" and self.bs_coupling:
            pan = 12 if self.data[0].bs_amp_res else 24
            d0, d1 = self.data
            for e in range(1, d0.bs_num_env + 1):
                for k in range(self.n[d0.bs_freq_res[e]]):
                    q0 = int(d0.env_facs_q[e][k])
                    q1 = int(d1.env_facs_q[e][k])
                    if d0.bs_amp_res:
                        t1 = float(np.float32(2.0) ** (q0 + 7))
                        t2 = float(np.float32(2.0) ** (pan - q1))
                    else:
                        t1 = 2.0 ** ((q0 >> 1) + 7) * \
                            (sqrt2 if q0 & 1 else 1.0)
                        t2 = 2.0 ** ((pan - q1) >> 1) * \
                            (sqrt2 if (pan - q1) & 1 else 1.0)
                    if t1 > 1e20:
                        t1 = 1.0
                    fac = t1 / (1.0 + t2)
                    d0.env_facs[e][k] = fac
                    d1.env_facs[e][k] = fac * t2
            for e in range(1, d0.bs_num_noise + 1):
                for k in range(self.n_q):
                    t1 = 2.0 ** (NOISE_FLOOR_OFFSET -
                                 int(d0.noise_facs_q[e][k]) + 1)
                    t2 = 2.0 ** (12 - int(d1.noise_facs_q[e][k]))
                    fac = t1 / (1.0 + t2)
                    d0.noise_facs[e][k] = fac
                    d1.noise_facs[e][k] = fac * t2
        else:
            nch = 2 if self.id_aac == "cpe" else 1
            for ch in range(nch):
                cd = self.data[ch]
                for e in range(1, cd.bs_num_env + 1):
                    for k in range(self.n[cd.bs_freq_res[e]]):
                        q = int(cd.env_facs_q[e][k])
                        if cd.bs_amp_res:
                            v = 2.0 ** (q + 6)
                        else:
                            v = 2.0 ** ((q >> 1) + 6) * \
                                (sqrt2 if q & 1 else 1.0)
                        cd.env_facs[e][k] = 1.0 if v > 1e20 else v
                for e in range(1, cd.bs_num_noise + 1):
                    for k in range(self.n_q):
                        cd.noise_facs[e][k] = 2.0 ** (
                            NOISE_FLOOR_OFFSET -
                            int(cd.noise_facs_q[e][k]))

    def lf_gen(self, W, Wold):
        X_low = np.zeros((32, 40), np.complex128)
        for k in range(self.kx[1]):
            X_low[k, 8:40] = W[:, k]
        for k in range(self.kx[0]):
            X_low[k, :8] = Wold[24:32, k]
        self.X_low = X_low

    def hf_inverse_filter(self):
        """sbr_hf_inverse_filter + sbrdsp.c sbr_autocorrelate_c:
        second-order covariance LPC per low subband.  The reference
        itself notes the routine "does not seem numerically stable";
        the covariance determinant suffers catastrophic cancellation,
        so we replicate the reference's float32 arithmetic in its
        exact summation order to track its alphas as closely as
        possible."""
        f32 = np.float32
        X = self.X_low
        for k in range(self.k[0]):
            x = X[k]
            xr = x.real.astype(np.float32)
            xi = x.imag.astype(np.float32)
            rs2 = f32(xr[0] * xr[2] + xi[0] * xi[2])
            is2 = f32(xr[0] * xi[2] - xi[0] * xr[2])
            rs1 = f32(0.0)
            is1 = f32(0.0)
            rs0 = f32(0.0)
            for i in range(1, 38):
                rs0 = f32(rs0 + f32(xr[i] * xr[i] + xi[i] * xi[i]))
                rs1 = f32(rs1 + f32(xr[i] * xr[i + 1] +
                                    xi[i] * xi[i + 1]))
                is1 = f32(is1 + f32(xr[i] * xi[i + 1] -
                                    xi[i] * xr[i + 1]))
                rs2 = f32(rs2 + f32(xr[i] * xr[i + 2] +
                                    xi[i] * xi[i + 2]))
                is2 = f32(is2 + f32(xr[i] * xi[i + 2] -
                                    xi[i] * xr[i + 2]))
            p01r, p01i = rs2, is2
            p2_10 = f32(rs0 + f32(xr[0] * xr[0] + xi[0] * xi[0]))
            p1_00 = f32(rs0 + f32(xr[38] * xr[38] + xi[38] * xi[38]))
            p11r = f32(rs1 + f32(xr[0] * xr[1] + xi[0] * xi[1]))
            p11i = f32(is1 + f32(xr[0] * xi[1] - xi[0] * xr[1]))
            p00r = f32(rs1 + f32(xr[38] * xr[39] + xi[38] * xi[39]))
            p00i = f32(is1 + f32(xr[38] * xi[39] - xi[38] * xr[39]))
            dk = f32(f32(p2_10 * p1_00) -
                     f32(f32(p11r * p11r + p11i * p11i) /
                         f32(1.000001)))
            if dk == 0:
                a1r = a1i = f32(0.0)
            else:
                tr = f32(f32(p00r * p11r) - f32(p00i * p11i) -
                         f32(p01r * p1_00))
                ti = f32(f32(p00r * p11i) + f32(p00i * p11r) -
                         f32(p01i * p1_00))
                a1r, a1i = f32(tr / dk), f32(ti / dk)
            if p1_00 == 0:
                a0r = a0i = f32(0.0)
            else:
                tr = f32(p00r + f32(a1r * p11r) + f32(a1i * p11i))
                ti = f32(p00i + f32(a1i * p11r) - f32(a1r * p11i))
                a0r, a0i = f32(-tr / p1_00), f32(-ti / p1_00)
            if (f32(a1r * a1r + a1i * a1i) >= 16.0 or
                    f32(a0r * a0r + a0i * a0i) >= 16.0):
                a0r = a0i = a1r = a1i = f32(0.0)
            self.alpha0[k] = complex(a0r, a0i)
            self.alpha1[k] = complex(a1r, a1i)

    def chirp(self, ch):
        cd = self.data[ch]
        bw_tab = [0.0, 0.75, 0.9, 0.98]
        for i in range(self.n_q):
            if cd.bs_invf_mode[0][i] + cd.bs_invf_mode[1][i] == 1:
                new_bw = 0.6
            else:
                new_bw = bw_tab[cd.bs_invf_mode[0][i]]
            if new_bw < cd.bw_array[i]:
                new_bw = 0.75 * new_bw + 0.25 * cd.bw_array[i]
            else:
                new_bw = 0.90625 * new_bw + 0.09375 * cd.bw_array[i]
            cd.bw_array[i] = 0.0 if new_bw < 0.015625 else new_bw

    def hf_gen(self, ch):
        cd = self.data[ch]
        X_high = np.zeros((64, 40), np.complex128)
        k = self.kx[1]
        g = 0
        t0 = 2 * cd.t_env[0]
        t1 = 2 * cd.t_env[cd.bs_num_env]
        for j in range(self.num_patches):
            for x in range(self.patch_num_subbands[j]):
                p = self.patch_start_subband[j] + x
                while g <= self.n_q and k >= self.f_tablenoise[g]:
                    g += 1
                g -= 1
                if g < 0:
                    raise InvalidData("sbr: no noise band")
                bw = cd.bw_array[g]
                a0 = self.alpha0[p] * bw
                a1 = self.alpha1[p] * (bw * bw)
                xl = self.X_low[p]
                for i in range(EAO + t0, EAO + t1):
                    X_high[k][i] = (xl[i - 2] * a1 + xl[i - 1] * a0 +
                                    xl[i])
                k += 1
        self.X_high = X_high

    def mapping(self, ch):
        cd = self.data[ch]
        e_a = cd.e_a
        cd.s_indexmapped[1:8] = 0
        for e in range(cd.bs_num_env):
            fr = cd.bs_freq_res[e + 1]
            ilim = self.n[fr]
            table = self.f_tablehigh if fr else self.f_tablelow
            if self.kx[1] != table[0]:
                raise InvalidData("sbr: stale frequency tables")
            for i in range(ilim):
                self.e_origmapped[e, int(table[i]) - self.kx[1]:
                                  int(table[i + 1]) - self.kx[1]] = \
                    cd.env_facs[e + 1][i]
            kq = 1 if (cd.bs_num_noise > 1 and
                       cd.t_env[e] >= cd.t_q[1]) else 0
            for i in range(self.n_q):
                self.q_mapped[e, int(self.f_tablenoise[i]) - self.kx[1]:
                              int(self.f_tablenoise[i + 1]) -
                              self.kx[1]] = cd.noise_facs[kq + 1][i]
            for i in range(self.n[1]):
                if cd.bs_add_harmonic_flag:
                    mid = (int(self.f_tablehigh[i]) +
                           int(self.f_tablehigh[i + 1])) >> 1
                    cd.s_indexmapped[e + 1][mid - self.kx[1]] = \
                        cd.bs_add_harmonic[i] * \
                        (1 if (e >= e_a[1] or
                               cd.s_indexmapped[0][mid - self.kx[1]]
                               == 1) else 0)
            for i in range(ilim):
                lo = int(table[i]) - self.kx[1]
                hi = int(table[i + 1]) - self.kx[1]
                present = int(np.any(
                    cd.s_indexmapped[e + 1][lo:hi]))
                self.s_mapped[e, lo:hi] = present
        cd.s_indexmapped[0] = cd.s_indexmapped[cd.bs_num_env]

    def env_estimate(self, ch):
        cd = self.data[ch]
        kx1 = self.kx[1]
        Xh = self.X_high
        if self.bs_interpol_freq:
            for e in range(cd.bs_num_env):
                recip = 0.5 / (cd.t_env[e + 1] - cd.t_env[e])
                ilb = cd.t_env[e] * 2 + EAO
                iub = cd.t_env[e + 1] * 2 + EAO
                if ilb >= 40:
                    return
                for m in range(self.m[1]):
                    s = float(np.sum(np.abs(
                        Xh[m + kx1][ilb:iub]) ** 2))
                    self.e_curr[e][m] = s * recip
        else:
            for e in range(cd.bs_num_env):
                env_size = 2 * (cd.t_env[e + 1] - cd.t_env[e])
                ilb = cd.t_env[e] * 2 + EAO
                iub = cd.t_env[e + 1] * 2 + EAO
                fr = cd.bs_freq_res[e + 1]
                table = self.f_tablehigh if fr else self.f_tablelow
                if ilb >= 40:
                    return
                for p in range(self.n[fr]):
                    den = env_size * (int(table[p + 1]) -
                                      int(table[p]))
                    s = 0.0
                    for k in range(int(table[p]), int(table[p + 1])):
                        s += float(np.sum(np.abs(Xh[k][ilb:iub]) ** 2))
                    s /= den
                    self.e_curr[e, int(table[p]) - kx1:
                                int(table[p + 1]) - kx1] = s

    def gain_calc(self, ch):
        cd = self.data[ch]
        e_a = cd.e_a
        limgain = [0.70795, 1.0, 1.41254, 1e10]
        FLT_MIN = np.finfo(np.float32).tiny
        FLT_EPS = np.finfo(np.float32).eps
        for e in range(cd.bs_num_env):
            delta = 0 if (e == e_a[1] or e == e_a[0]) else 1
            for k in range(self.n_lim):
                lo = int(self.f_tablelim[k]) - self.kx[1]
                hi = int(self.f_tablelim[k + 1]) - self.kx[1]
                for m in range(lo, hi):
                    temp = self.e_origmapped[e][m] / \
                        (1.0 + self.q_mapped[e][m])
                    self.q_m[e][m] = np.sqrt(
                        temp * self.q_mapped[e][m])
                    self.s_m[e][m] = np.sqrt(
                        temp * cd.s_indexmapped[e + 1][m])
                    if not self.s_mapped[e][m]:
                        self.gain[e][m] = np.sqrt(
                            self.e_origmapped[e][m] /
                            ((1.0 + self.e_curr[e][m]) *
                             (1.0 + self.q_mapped[e][m] * delta)))
                    else:
                        self.gain[e][m] = np.sqrt(
                            self.e_origmapped[e][m] *
                            self.q_mapped[e][m] /
                            ((1.0 + self.e_curr[e][m]) *
                             (1.0 + self.q_mapped[e][m])))
                    self.gain[e][m] += FLT_MIN
                s0 = float(np.sum(self.e_origmapped[e][lo:hi]))
                s1 = float(np.sum(self.e_curr[e][lo:hi]))
                gain_max = limgain[self.bs_limiter_gains] * \
                    np.sqrt((FLT_EPS + s0) / (FLT_EPS + s1))
                gain_max = min(100000.0, gain_max)
                for m in range(lo, hi):
                    q_m_max = self.q_m[e][m] * gain_max / \
                        self.gain[e][m]
                    self.q_m[e][m] = min(self.q_m[e][m], q_m_max)
                    self.gain[e][m] = min(self.gain[e][m], gain_max)
                s0 = float(np.sum(self.e_origmapped[e][lo:hi]))
                s1 = 0.0
                for m in range(lo, hi):
                    s1 += self.e_curr[e][m] * self.gain[e][m] ** 2 + \
                        self.s_m[e][m] ** 2 + \
                        (delta and not self.s_m[e][m]) * \
                        self.q_m[e][m] ** 2
                boost = min(1.584893192,
                            np.sqrt((FLT_EPS + s0) / (FLT_EPS + s1)))
                for m in range(lo, hi):
                    self.gain[e][m] *= boost
                    self.q_m[e][m] *= boost
                    self.s_m[e][m] *= boost

    def hf_assemble(self, ch):
        cd = self.data[ch]
        e_a = cd.e_a
        h_SL = 4 * (not self.bs_smoothing_mode)
        kx = self.kx[1]
        m_max = self.m[1]
        h_smooth = [0.33333333333333, 0.30150283239582,
                    0.21816949906249, 0.11516383427084,
                    0.03183050093751]
        Y1 = cd.Y[cd.Ypos]
        Y1[:] = 0
        g_temp, q_temp = cd.g_temp, cd.q_temp
        indexnoise = cd.f_indexnoise
        indexsine = cd.f_indexsine
        if self.reset:
            for i in range(h_SL):
                g_temp[i + 2 * cd.t_env[0]][:m_max] = \
                    self.gain[0][:m_max]
                q_temp[i + 2 * cd.t_env[0]][:m_max] = \
                    self.q_m[0][:m_max]
        elif h_SL:
            for i in range(4):
                g_temp[i + 2 * cd.t_env[0]] = \
                    g_temp[i + 2 * cd.t_env_num_env_old].copy()
                q_temp[i + 2 * cd.t_env[0]] = \
                    q_temp[i + 2 * cd.t_env_num_env_old].copy()
        for e in range(cd.bs_num_env):
            for i in range(2 * cd.t_env[e], 2 * cd.t_env[e + 1]):
                g_temp[h_SL + i][:m_max] = self.gain[e][:m_max]
                q_temp[h_SL + i][:m_max] = self.q_m[e][:m_max]
        for e in range(cd.bs_num_env):
            for i in range(2 * cd.t_env[e], 2 * cd.t_env[e + 1]):
                if h_SL and e != e_a[0] and e != e_a[1]:
                    g_filt = np.zeros(m_max)
                    q_filt = np.zeros(m_max)
                    idx1 = i + h_SL
                    for j in range(h_SL + 1):
                        g_filt += g_temp[idx1 - j][:m_max] * \
                            h_smooth[j]
                        q_filt += q_temp[idx1 - j][:m_max] * \
                            h_smooth[j]
                else:
                    g_filt = g_temp[i + h_SL][:m_max]
                    q_filt = q_temp[i][:m_max]
                # hf_g_filt
                Y1[i, kx:kx + m_max] = \
                    self.X_high[kx:kx + m_max, i + EAO] * g_filt
                if e != e_a[0] and e != e_a[1]:
                    # apply noise variant indexsine
                    phi0, phi1 = [(1.0, 0.0),
                                  (0.0, 1 - 2 * (kx & 1)),
                                  (-1.0, 0.0),
                                  (0.0, -(1 - 2 * (kx & 1)))][indexsine]
                    noise = indexnoise
                    ph1 = phi1
                    for m in range(m_max):
                        noise = (noise + 1) & 0x1FF
                        if self.s_m[e][m]:
                            Y1[i, kx + m] += complex(
                                self.s_m[e][m] * phi0,
                                self.s_m[e][m] * ph1)
                        else:
                            Y1[i, kx + m] += q_filt[m] * complex(
                                T.NOISE_TABLE[noise][0],
                                T.NOISE_TABLE[noise][1])
                        ph1 = -ph1
                else:
                    idx = indexsine & 1
                    A = 1 - ((indexsine + (kx & 1)) & 2)
                    B = (A ^ (-idx)) + idx
                    sm = self.s_m[e]
                    for m in range(m_max):
                        f = A if (m & 1) == 0 else B
                        if idx:
                            Y1[i, kx + m] += 1j * (sm[m] * f)
                        else:
                            Y1[i, kx + m] += sm[m] * f
                indexnoise = (indexnoise + m_max) & 0x1FF
                indexsine = (indexsine + 1) & 3
        cd.f_indexnoise = indexnoise
        cd.f_indexsine = indexsine

    def x_gen(self, ch):
        cd = self.data[ch]
        X = np.zeros((38, 64), np.complex128)
        i_temp = max(2 * cd.t_env_num_env_old - 32, 0)
        Y0 = cd.Y[1 - cd.Ypos]
        Y1 = cd.Y[cd.Ypos]
        for k in range(self.kx[0]):
            X[:i_temp, k] = self.X_low[k, EAO:EAO + i_temp]
        for k in range(self.kx[0], self.kx[0] + self.m[0]):
            X[:i_temp, k] = Y0[32:32 + i_temp, k]
        for k in range(self.kx[1]):
            X[i_temp:38, k] = self.X_low[k, EAO + i_temp:40]
        for k in range(self.kx[1], self.kx[1] + self.m[1]):
            X[i_temp:32, k] = Y1[i_temp:32, k]
        return X

    # -- main entry -----------------------------------------------------
    def apply(self, id_aac, channels):
        """channels: list of (1024,) float arrays → list of (2048,)."""
        if id_aac != self.id_aac and self.id_aac is not None:
            self.turnoff()
        if self.start and not self.ready_for_dequant:
            self.turnoff()
        if not self.kx_and_m_pushed:
            self.kx[0] = self.kx[1]
            self.m[0] = self.m[1]
        else:
            self.kx_and_m_pushed = 0
        if self.start:
            self.dequant()
            self.ready_for_dequant = 0
        outs = []
        use_ps = (id_aac == "sce" and self.ps is not None
                  and self.ps.start and len(channels) == 1)
        for ch, samples in enumerate(channels):
            cd = self.data[ch]
            W = qmf_analysis(cd.x, np.asarray(samples, np.float64))
            cd.W[cd.Ypos] = W
            self.lf_gen(cd.W[cd.Ypos], cd.W[1 - cd.Ypos])
            cd.Ypos ^= 1
            if self.start:
                self.hf_inverse_filter()
                self.chirp(ch)
                self.hf_gen(ch)
                self.mapping(ch)
                self.env_estimate(ch)
                self.gain_calc(ch)
                self.hf_assemble(ch)
            X = self.x_gen(ch)
            if use_ps:
                # HE-AACv2: mono downmix + PS → stereo in QMF domain
                # (aacsbr_template.c sbr_apply PS hook)
                L32, R32 = self.ps.apply(X, self.kx[1] + self.m[1])
                if self.synth_r is None:
                    import copy as _copy
                    self.synth_r = {"v": np.zeros_like(cd.synth["v"]),
                                    "v_off": cd.synth["v_off"]}
                outs.append(qmf_synthesis(cd.synth, L32))
                outs.append(qmf_synthesis(self.synth_r, R32))
            else:
                outs.append(qmf_synthesis(cd.synth, X[:32]))
        self.reset = 0
        return outs
