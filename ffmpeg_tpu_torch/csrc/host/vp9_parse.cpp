// VP9 frame parse (entropy stage) in native code (the port's copy of
// csrc/vp9_parse.cpp, built by ffmpeg_tpu_torch/native.py).
//
// Port of the Python tile walker (ffmpeg_tpu/codecs/vp9/block.py,
// mvs.py, recorder.py) whose behavior is byte-exact vs the reference
// decoder (libavcodec/vp9.c / vp9block.c / vp9mvs.c). The Python
// walker costs ~30-60 s/frame at 1080p; this walker does the same
// work in ~10 ms and emits the SAME record layout the device replay
// (recon_tpu.py) consumes: MC tiles, inter residual TUs, intra
// tx-blocks with resolved edge specs + dependency levels, the loop
// filter level/width grids, the MV grid for next-frame prediction,
// and all adaptation counters.
//
// No tables are duplicated here: trees, scans, neighbour tables and
// default probabilities arrive as pointers from the Python side
// (tables_gen.py), so there is exactly one authoritative copy.
//
// ABI: one call per frame,
//   vp9_parse_frame(data, size, hdr32, bufs)
// where bufs is a void* slot table (see enum Slots below; mirrored in
// ffmpeg_tpu_torch/codecs/vp9/native_parse.py).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

// ---------------------------------------------------------------- slots
enum Slots {
  S_PARTITION_TREE = 0, S_INTRAMODE_TREE, S_INTER_MODE_TREE,
  S_FILTER_TREE, S_MV_JOINT_TREE, S_MV_CLASS_TREE, S_MV_FP_TREE,
  S_KF_PARTITION, S_KF_YMODE, S_KF_UVMODE, S_BWH, S_MV_REF_BLK_OFF,
  S_INTER_MODE_CTX_LUT, S_SCANS, S_NBS, S_MODE_CONV, S_NEEDS,
  S_INTRA_TXFM_TYPE,
  // probs
  S_P_YMODE = 20, S_P_UVMODE, S_P_FILTER, S_P_MVMODE, S_P_INTRA,
  S_P_COMP, S_P_SINGLE_REF, S_P_COMP_REF, S_P_TX32, S_P_TX16,
  S_P_TX8, S_P_SKIP, S_P_MVJOINT, S_P_MVCOMP, S_P_PARTITION, S_P_COEF,
  // prev frame grids
  S_PREV_MV_REF = 36, S_PREV_MV_XY,
  // fs grids (outputs)
  S_MV_REF = 40, S_MV_XY, S_LF_LVL, S_WD_V, S_WD_H, S_WD_V_UV,
  S_WD_H_UV,
  // counts (int64)
  S_C_EOB = 50, S_C_COEF, S_C_SKIP, S_C_INTRA, S_C_COMP, S_C_COMP_REF,
  S_C_SINGLE_REF, S_C_PARTITION, S_C_TX32, S_C_TX16, S_C_TX8,
  S_C_FILTER, S_C_MVMODE, S_C_MVJOINT, S_C_YMODE, S_C_UVMODE,
  S_C_MVC_SIGN, S_C_MVC_CLASSES, S_C_MVC_CLASS0, S_C_MVC_BITS,
  S_C_MVC_C0FP, S_C_MVC_FP, S_C_MVC_C0HP, S_C_MVC_HP,
  // record outputs
  S_CAPS = 78,     // int64[20]: mc[4], tu[8], intra[8]
  S_OUT_N,         // int64[21]: mc_n[4], tu_n[8], in_n[8], max_level
  S_MC0 = 80,      // 4 classes: (luma,8),(luma,4),(chroma,8),(chroma,4)
  S_TU_META0 = 84, // 8 classes: (l,4)(l,8)(l,16)(l,32)(c,4)(c,8)(c,16)(c,32)
  S_TU_COEF0 = 92,
  S_IN_META0 = 100,
  S_IN_COEF0 = 108,
  N_SLOTS = 116,
};

// error codes
enum {
  E_OK = 0, E_TILE_MARKER = -1, E_TRUNC_TILE = -2, E_BAD_BAND = -3,
  E_BAD_I_MBTYPE = -4, E_OVERFLOW_MC = -5, E_OVERFLOW_TU = -6,
  E_OVERFLOW_IN = -7,
};

// block sizes, partitions, tx (mirrors block.py)
enum { BS_64x64 = 0, BS_8x8 = 9, BS_8x4 = 10, BS_4x8 = 11, BS_4x4 = 12 };
enum { P_NONE = 0, P_H = 1, P_V = 2, P_SPLIT = 3 };
enum { TX_4X4 = 0, TX_8X8 = 1, TX_16X16 = 2, TX_32X32 = 3 };
enum { NEARESTMV = 10, NEARMV = 11, ZEROMV = 12, NEWMV = 13 };
enum { DCT_DCT = 0, DCT_ADST = 1, ADST_DCT = 2, ADST_ADST = 3 };
// intra mode ids (intra.py)
enum { M_VERT = 0, M_HOR, M_DC, M_DDL, M_DDR, M_VR, M_HD, M_VL, M_HU,
       M_TM, M_LEFT_DC, M_TOP_DC, M_DC_128, M_DC_127, M_DC_129 };

const int MAX_TX_FOR_BS[13] = {3, 3, 3, 3, 2, 2, 2, 1, 1, 1, 0, 0, 0};
const int LEFT_CTX_TAB[13] = {0x0, 0x8, 0x0, 0x8, 0xC, 0x8, 0xC, 0xE,
                              0xC, 0xE, 0xF, 0xE, 0xF};
const int ABOVE_CTX_TAB[13] = {0x0, 0x0, 0x8, 0x8, 0x8, 0xC, 0xC, 0xC,
                               0xE, 0xE, 0xE, 0xF, 0xF};
const int BAND_COUNTS[4][6] = {
    {1, 2, 3, 4, 3, 16 - 13},
    {1, 2, 3, 4, 11, 64 - 21},
    {1, 2, 3, 4, 11, 256 - 21},
    {1, 2, 3, 4, 11, 1024 - 21},
};
const int INTER_MODE_CTX_OFF[10] = {3, 0, 0, 1, 0, 0, 0, 0, 0, 0};
const int SIZE_GROUP[10] = {3, 3, 3, 3, 2, 2, 2, 1, 1, 1};
const int FILTER_LUT[3] = {1, 0, 2};

struct BoolDec {
  const uint8_t *data;
  long size, pos;
  uint32_t value, range;
  int bit_count;
  void init(const uint8_t *d, long n) {
    data = d; size = n; pos = 2;
    uint32_t b0 = n > 0 ? d[0] : 0, b1 = n > 1 ? d[1] : 0;
    value = (b0 << 8) | b1;
    range = 255;
    bit_count = 0;
  }
  int get(int prob) {
    uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    uint32_t big = split << 8;
    int ret;
    if (value >= big) { ret = 1; range -= split; value -= big; }
    else { ret = 0; range = split; }
    while (range < 128) {
      value = (value << 1) & 0xFFFF;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        if (pos < size) value |= data[pos++];
      }
    }
    return ret;
  }
  int bit() { return get(128); }
  // tree: int32 [n][2] nodes; node>0 => next index, <=0 => -terminal
  int tree(const int32_t *t, const int32_t *probs) {
    int i = 0;
    for (;;) {
      i = t[2 * i + get((int)probs[i])];
      if (i <= 0) return -i;
    }
  }
};

struct Hdr {
  int keyframe, intraonly, width, height, cols, rows, sb_cols, sb_rows;
  int txfmmode, filtermode, comppredmode, fixcompref;
  int varcompref[2], signbias[3], highprec, use_last_mvs;
  int qmul[2][2], log2_tile_cols, log2_tile_rows;
  int lflvl_mat[4][2];
  int mi_stride;  // allocated row stride of the MV grids (sb_cols*8)
};

struct FS {
  Hdr h;
  // tables
  const int32_t *t_part, *t_imode, *t_inter, *t_filter, *t_mvj,
      *t_mvc, *t_mvfp;
  const int32_t *kf_part, *kf_ym, *kf_uv, *bwh, *mvoff, *imctx,
      *scans, *nbs, *mode_conv, *needs, *itxtp;
  // probs
  const int32_t *p_ym, *p_uv, *p_filt, *p_mvmode, *p_intra, *p_comp,
      *p_sref, *p_cref, *p_tx32, *p_tx16, *p_tx8, *p_skip, *p_mvj,
      *p_mvc, *p_part, *p_coef;
  // grids
  const int32_t *prev_mv_ref, *prev_mv_xy;
  int32_t *mv_ref, *mv_xy, *lf_lvl, *wd_v, *wd_h, *wd_v_uv, *wd_h_uv;
  // counts
  int64_t *c_eob, *c_coef, *c_skip, *c_intra, *c_comp, *c_cref,
      *c_sref, *c_part, *c_tx32, *c_tx16, *c_tx8, *c_filt, *c_mvmode,
      *c_mvj, *c_ym, *c_uv, *c_sign, *c_cls, *c_c0, *c_bits, *c_c0fp,
      *c_fp, *c_c0hp, *c_hp;
  // record outputs
  const int64_t *caps;
  int64_t *out_n;
  int32_t *mc[4];
  int32_t *tu_meta[8], *tu_coef[8];
  int32_t *in_meta[8], *in_coef[8];
  long mc_n[4] = {0, 0, 0, 0};
  long tu_n[8] = {0};
  long in_n[8] = {0};
  int max_level = 0;
  // above ctx
  std::vector<int32_t> a_part, a_skip, a_txfm, a_mode, a_ynnz,
      a_uvnnz0, a_uvnnz1, a_intra, a_comp, a_ref, a_filter, a_mode8,
      a_mvctx;  // a_mvctx: [2c][2][2]
  // left ctx
  int32_t l_part[8], l_skip[8], l_txfm[8], l_mode[16], l_ynnz[16],
      l_uvnnz0[8], l_uvnnz1[8], l_intra[8], l_comp[8], l_ref[8],
      l_filter[8], l_mode8[16], l_mvctx[16][2][2];
  // dependency level grids (luma 4px, u 4px-of-chroma, v)
  std::vector<int32_t> lvl[3];
  int lvlw[3], lvlh[3];
  int mode0;  // DC_PRED or NEARESTMV seed
  int wp, hp; // padded luma dims
  int c4;     // wd grid width (luma 4px cells)
  // per-block state
  int row = 0, col = 0, tile_col_start = 0;
  int bs = 0, comp = 0, refs[2] = {0, 0}, intra_ = 0, skip_ = 0;
  int tx = 0, uvtx = 0, filt = 0, modes[4] = {0, 0, 0, 0}, uvmode = 0;
  int mv[4][2][2];  // [k][li][x,y]
  int min_mv[2], max_mv[2];
  BoolDec *bd = nullptr;
  int err = 0;
};

static inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// --------------------------------------------------------------- coeffs
// One tx block (block.py _coeff_block). Returns eob; <0 on error.
static int coeff_block(FS &fs, int n_coeffs, int is32, const int32_t *p,
                       int nnz, const int32_t *scan, const int32_t *nb,
                       const int *band_counts, const int *qmul,
                       int32_t *out, int64_t *cnt3, int64_t *eob2) {
  BoolDec &io = *fs.bd;
  int i = 0, band = 0;
  int band_left = band_counts[0];
  const int32_t *tp = p + nnz * 11;  // p[0][nnz]
  static thread_local int32_t cache[1024];
  memset(cache, 0, sizeof(int32_t) * (size_t)n_coeffs);
  for (;;) {
    int val = io.get((int)tp[0]);
    eob2[(band * 6 + nnz) * 2 + val]++;
    if (!val) break;
    for (;;) {  // zero run (skip_eob)
      if (io.get((int)tp[1])) break;
      cnt3[(band * 6 + nnz) * 3 + 0]++;
      if (!band_left) return E_BAD_BAND;
      if (!--band_left && band < 5) band_left = band_counts[++band];
      cache[scan[i]] = 0;
      nnz = (1 + cache[nb[2 * i]] + cache[nb[2 * i + 1]]) >> 1;
      tp = p + (band * 6 + nnz) * 11;
      if (++i == n_coeffs) return i;
    }
    int rc = scan[i];
    if (!io.get((int)tp[2])) {
      cnt3[(band * 6 + nnz) * 3 + 1]++;
      val = 1;
      cache[rc] = 1;
    } else {
      cnt3[(band * 6 + nnz) * 3 + 2]++;
      if (!io.get((int)tp[3])) {
        if (!io.get((int)tp[4])) { cache[rc] = val = 2; }
        else { val = 3 + io.get((int)tp[5]); cache[rc] = 3; }
      } else if (!io.get((int)tp[6])) {
        cache[rc] = 4;
        if (!io.get((int)tp[7])) val = 5 + io.get(159);
        else { val = 7 + 2 * io.get(165); val += io.get(145); }
      } else {  // cat 3-6
        cache[rc] = 5;
        if (!io.get((int)tp[8])) {
          if (!io.get((int)tp[9])) {
            val = 11 + 4 * io.get(173);
            val += 2 * io.get(148);
            val += io.get(140);
          } else {
            val = 19 + 8 * io.get(176);
            val += 4 * io.get(155);
            val += 2 * io.get(140);
            val += io.get(135);
          }
        } else if (!io.get((int)tp[10])) {
          val = 35;
          const int pr5[5] = {180, 157, 141, 134, 130};
          for (int k = 0; k < 5; k++)
            val += io.get(pr5[k]) << (4 - k);
        } else {
          val = 67;
          const int cat6[14] = {254, 254, 254, 252, 249, 243, 230,
                                196, 177, 153, 140, 133, 130, 129};
          for (int k = 0; k < 14; k++)
            val += io.get(cat6[k]) << (13 - k);
        }
      }
    }
    if (!band_left) return E_BAD_BAND;
    if (!--band_left && band < 5) band_left = band_counts[++band];
    int neg = io.bit();
    {
      long q = (long)val * qmul[i ? 1 : 0];
      if (neg) q = -q;
      if (is32) { long a = q < 0 ? -q : q; q = (a / 2) * (q < 0 ? -1 : 1); }
      out[rc] = (int32_t)(int16_t)q;  // int16 wrap (reference storage)
    }
    nnz = (1 + cache[nb[2 * i]] + cache[nb[2 * i + 1]]) >> 1;
    if (++i >= n_coeffs) break;
    tp = p + (band * 6 + nnz) * 11;
  }
  return i;
}

// ------------------------------------------------------------------ MVs
struct MV { int x, y; };
static const MV MV_INVALID = {1 << 20, 1 << 20};
static inline bool mv_eq(const MV &a, const MV &b) {
  return a.x == b.x && a.y == b.y;
}

static inline MV clamp_mv(FS &fs, MV m) {
  return {clampi(m.x, fs.min_mv[0], fs.max_mv[0]),
          clampi(m.y, fs.min_mv[1], fs.max_mv[1])};
}

// mvs.py find_ref_mvs. ref: slot-relative (0..2); z: prediction list
// index; idx: 0 = NEARESTMV cand, 1 = NEARMV cand; sb: sub-block
// index or -1 (whole block / NEWMV).
static MV find_ref_mvs(FS &fs, int ref, int z, int idx, int sb) {
  const Hdr &h = fs.h;
  int row = fs.row, col = fs.col, row7 = row & 7;
  const int32_t *p = fs.mvoff + fs.bs * 16;  // [8][2] (col_off,row_off)
  MV mem = MV_INVALID, mem_sub8x8 = MV_INVALID;
  MV result;
  bool done = false;

  auto ret_direct = [&](MV mvv) {
    if (!idx) { result = mvv; return true; }
    if (mv_eq(mem, MV_INVALID)) mem = mvv;
    else if (!mv_eq(mvv, mem)) { result = mvv; return true; }
    return false;
  };
  auto ret_mv = [&](MV mvv) {
    if (sb > 0) {
      if (mv_eq(mem_sub8x8, MV_INVALID)) {
        MV m = clamp_mv(fs, mvv);
        if (!mv_eq(m, mem)) { result = m; return true; }
        mem_sub8x8 = mvv;
      } else if (!mv_eq(mem_sub8x8, mvv)) {
        MV m = clamp_mv(fs, mvv);
        if (!mv_eq(m, mem)) result = m;
        else result = {0, 0};  // libvpx quirk (vp9mvs.c "BUG")
        return true;
      }
      return false;
    }
    if (!idx) { result = clamp_mv(fs, mvv); return true; }
    if (mv_eq(mem, MV_INVALID)) mem = mvv;
    else if (!mv_eq(mvv, mem)) { result = clamp_mv(fs, mvv); return true; }
    return false;
  };
  auto ret_scale = [&](MV mvv, bool invert) {
    if (invert) return ret_mv({-mvv.x, -mvv.y});
    return ret_mv(mvv);
  };
  const long ms = fs.h.mi_stride;
  auto grid_ref = [&](int r, int c, int li) {
    return fs.mv_ref[(r * ms + c) * 2 + li];
  };
  auto grid_mv = [&](int r, int c, int li) {
    const int32_t *q = fs.mv_xy + ((r * ms + c) * 2 + li) * 2;
    return MV{q[0], q[1]};
  };
  auto pgrid_ref = [&](int r, int c, int li) {
    return fs.prev_mv_ref[(r * ms + c) * 2 + li];
  };
  auto pgrid_mv = [&](int r, int c, int li) {
    const int32_t *q = fs.prev_mv_xy + ((r * ms + c) * 2 + li) * 2;
    return MV{q[0], q[1]};
  };

  int i0 = 0;
  if (sb >= 0) {
    if (sb == 1 || sb == 2) {
      if (ret_direct({fs.mv[0][z][0], fs.mv[0][z][1]})) return result;
    } else if (sb == 3) {
      for (int k = 2; k >= 0; k--)
        if (ret_direct({fs.mv[k][z][0], fs.mv[k][z][1]})) return result;
    }
    if (row > 0) {
      int rr0 = grid_ref(row - 1, col, 0), rr1 = grid_ref(row - 1, col, 1);
      const int32_t *am = &fs.a_mvctx[((2 * col + (sb & 1)) * 2) * 2];
      if (rr0 == ref) {
        if (ret_mv({am[0], am[1]})) return result;
      } else if (rr1 == ref) {
        if (ret_mv({am[2], am[3]})) return result;
      }
    }
    if (col > fs.tile_col_start) {
      int rr0 = grid_ref(row, col - 1, 0), rr1 = grid_ref(row, col - 1, 1);
      const int32_t *lm = &fs.l_mvctx[2 * row7 + (sb >> 1)][0][0];
      if (rr0 == ref) {
        if (ret_mv({lm[0], lm[1]})) return result;
      } else if (rr1 == ref) {
        if (ret_mv({lm[2], lm[3]})) return result;
      }
    }
    i0 = 2;
  }

  for (int i = i0; i < 8; i++) {
    int c = p[2 * i] + col, r = p[2 * i + 1] + row;
    if (fs.tile_col_start <= c && c < h.cols && 0 <= r && r < h.rows) {
      int rr0 = grid_ref(r, c, 0), rr1 = grid_ref(r, c, 1);
      if (rr0 == ref) {
        if (ret_mv(grid_mv(r, c, 0))) return result;
      } else if (rr1 == ref) {
        if (ret_mv(grid_mv(r, c, 1))) return result;
      }
    }
  }

  if (h.use_last_mvs) {
    int rr0 = pgrid_ref(row, col, 0), rr1 = pgrid_ref(row, col, 1);
    if (rr0 == ref) {
      if (ret_mv(pgrid_mv(row, col, 0))) return result;
    } else if (rr1 == ref) {
      if (ret_mv(pgrid_mv(row, col, 1))) return result;
    }
  }

  for (int i = 0; i < 8; i++) {
    int c = p[2 * i] + col, r = p[2 * i + 1] + row;
    if (fs.tile_col_start <= c && c < h.cols && 0 <= r && r < h.rows) {
      int rr0 = grid_ref(r, c, 0), rr1 = grid_ref(r, c, 1);
      if (rr0 != ref && rr0 >= 0) {
        if (ret_scale(grid_mv(r, c, 0),
                      h.signbias[rr0] != h.signbias[ref]))
          return result;
      }
      if (rr1 != ref && rr1 >= 0 &&
          !mv_eq(grid_mv(r, c, 0), grid_mv(r, c, 1))) {
        if (ret_scale(grid_mv(r, c, 1),
                      h.signbias[rr1] != h.signbias[ref]))
          return result;
      }
    }
  }

  if (h.use_last_mvs) {
    int rr0 = pgrid_ref(row, col, 0), rr1 = pgrid_ref(row, col, 1);
    if (rr0 != ref && rr0 >= 0) {
      if (ret_scale(pgrid_mv(row, col, 0),
                    h.signbias[rr0] != h.signbias[ref]))
        return result;
    }
    if (rr1 != ref && rr1 >= 0 &&
        !mv_eq(pgrid_mv(row, col, 0), pgrid_mv(row, col, 1))) {
      if (ret_scale(pgrid_mv(row, col, 1),
                    h.signbias[rr1] != h.signbias[ref]))
        return result;
    }
  }
  (void)done;
  return clamp_mv(fs, {0, 0});
}

// mvs.py mv_component (decode direction only)
static int mv_component(FS &fs, int comp_idx, int hp) {
  BoolDec &io = *fs.bd;
  const int32_t *mc = fs.p_mvc + comp_idx * 33;
  int sign = io.get((int)mc[0]);
  int c = io.tree(fs.t_mvc, mc + 1);
  fs.c_sign[comp_idx * 2 + sign]++;
  fs.c_cls[comp_idx * 11 + c]++;
  int n;
  if (c) {
    n = 0;
    for (int mbit = 0; mbit < c; mbit++) {
      int bit = io.get((int)mc[12 + mbit]);
      n |= bit << mbit;
      fs.c_bits[(comp_idx * 10 + mbit) * 2 + bit]++;
    }
    n <<= 3;
    int bit = io.tree(fs.t_mvfp, mc + 28);
    n |= bit << 1;
    fs.c_fp[comp_idx * 4 + bit]++;
    if (hp) {
      bit = io.get((int)mc[32]);
      n |= bit;
      fs.c_hp[comp_idx * 2 + bit]++;
    } else {
      n |= 1;
      fs.c_hp[comp_idx * 2 + 1]++;
    }
    n += 8 << c;
  } else {
    n = io.get((int)mc[11]);
    fs.c_c0[comp_idx * 2 + n]++;
    int bit = io.tree(fs.t_mvfp, mc + 22 + 3 * n);
    fs.c_c0fp[(comp_idx * 2 + n) * 4 + bit]++;
    n = (n << 3) | (bit << 1);
    if (hp) {
      bit = io.get((int)mc[31]);
      n |= bit;
      fs.c_c0hp[comp_idx * 2 + bit]++;
    } else {
      n |= 1;
      fs.c_c0hp[comp_idx * 2 + 1]++;
    }
  }
  return sign ? -(n + 1) : (n + 1);
}

// mvs.py fill_mv -> fills fs.mv[dst_k][li]
static void fill_mv(FS &fs, int mode, int sb, int dst_k) {
  BoolDec &io = *fs.bd;
  const Hdr &h = fs.h;
  if (mode == ZEROMV) {
    for (int li = 0; li < 2; li++)
      fs.mv[dst_k][li][0] = fs.mv[dst_k][li][1] = 0;
    return;
  }
  for (int li = 0; li < (fs.comp ? 2 : 1); li++) {
    MV pred = find_ref_mvs(fs, fs.refs[li], li,
                           mode == NEARMV ? 1 : 0,
                           mode == NEWMV ? -1 : sb);
    int px = pred.x, py = pred.y;
    int hp = h.highprec && (px < 64 && px > -64) && (py < 64 && py > -64);
    if ((mode == NEWMV || sb == -1) && !hp) {
      if (py & 1) py += (py < 0) ? 1 : -1;
      if (px & 1) px += (px < 0) ? 1 : -1;
    }
    if (mode == NEWMV) {
      int j = io.tree(fs.t_mvj, fs.p_mvj);
      fs.c_mvj[j]++;
      if (j >= 2) py += mv_component(fs, 0, hp);
      if (j & 1) px += mv_component(fs, 1, hp);
    }
    fs.mv[dst_k][li][0] = px;
    fs.mv[dst_k][li][1] = py;
  }
  if (!fs.comp) {
    fs.mv[dst_k][1][0] = fs.mv[dst_k][1][1] = 0;
  }
}

// ------------------------------------------------------- recorder logic
// recorder.py _edge_spec: resolve edge availability into
// (eff_mode, m_top, m_left, tl_sel)
static void edge_spec(FS &fs, int pw, int ph, int x0, int y0, int n,
                      int mode, int have_top, int have_left,
                      int have_right, int tx4, int *out) {
  int m = fs.mode_conv[mode * 4 + ((have_left << 1) | have_top)];
  const int32_t *nd = fs.needs + m * 5;
  int nl = nd[0], nt = nd[1], ntl = nd[2], ntr = nd[3];
  int n_have = pw - x0;
  int m_top = 0;
  if ((nt || ntl) && have_top) {
    if (tx4 && ntr) {
      if (have_right && n + 4 <= n_have) m_top = std::min(2 * n, n_have);
      else m_top = std::min(n, n_have);
    } else {
      m_top = std::min(n, n_have);
    }
  }
  int tl_sel = have_top ? 1 : 0;
  if (ntl && have_left && have_top) tl_sel = 2;
  int m_left = 0;
  if (nl && have_left) m_left = std::min(n, ph - y0);
  out[0] = m; out[1] = m_top; out[2] = m_left; out[3] = tl_sel;
}

// recorder.py _push: dependency level assignment + intra record emit.
// cls_idx: 0 luma / 1 u / 2 v for the level grid; class order for
// in_meta follows recon_tpu._CLASSES.
static int class_of(int is_luma, int n) {
  int si = n == 4 ? 0 : n == 8 ? 1 : n == 16 ? 2 : 3;
  return (is_luma ? 0 : 4) + si;
}

static int push_intra(FS &fs, int c, int x0, int y0, int n, int mode,
                      int m_top, int m_left, int tl_sel, int txtp,
                      const int32_t *coef, int cpl) {
  int32_t *g = fs.lvl[c].data();
  int gw = fs.lvlw[c], gh = fs.lvlh[c];
  int lvl = 0;
  if (m_top || tl_sel == 2) {
    int r = (y0 - 1) >> 2;
    int c0 = std::max(0, x0 - 1) >> 2;
    int c1 = std::min(gw - 1, (x0 + std::max(m_top, 1) - 1) >> 2);
    if (r >= 0)
      for (int cc = c0; cc <= c1; cc++)
        lvl = std::max(lvl, (int)g[r * gw + cc]);
  }
  if (m_left || tl_sel == 2) {
    int cc = (x0 - 1) >> 2;
    int r0 = std::max(0, y0 - 1) >> 2;
    int r1 = std::min(gh - 1, (y0 + std::max(m_left, 1) - 1) >> 2);
    if (cc >= 0)
      for (int r = r0; r <= r1; r++)
        lvl = std::max(lvl, (int)g[r * gw + cc]);
  }
  lvl += 1;
  for (int r = y0 >> 2; r < (y0 + n) >> 2; r++)
    for (int cc = x0 >> 2; cc < (x0 + n) >> 2; cc++)
      g[r * gw + cc] = lvl;
  fs.max_level = std::max(fs.max_level, lvl);
  int cls = class_of(c == 0, n);
  long k = fs.in_n[cls];
  if (k >= fs.caps[4 + 8 + cls]) return E_OVERFLOW_IN;
  int32_t *meta = fs.in_meta[cls] + k * 9;
  meta[0] = lvl; meta[1] = x0; meta[2] = y0; meta[3] = mode;
  meta[4] = m_top; meta[5] = m_left; meta[6] = tl_sel; meta[7] = txtp;
  meta[8] = cpl;
  int32_t *dst = fs.in_coef[cls] + k * (long)(n * n);
  if (coef) memcpy(dst, coef, sizeof(int32_t) * (size_t)(n * n));
  else memset(dst, 0, sizeof(int32_t) * (size_t)(n * n));
  fs.in_n[cls] = k + 1;
  return E_OK;
}

static int push_tu(FS &fs, int is_luma, int n, int x0, int y0,
                   const int32_t *coef, int cpl) {
  int cls = class_of(is_luma, n);
  long k = fs.tu_n[cls];
  if (k >= fs.caps[4 + cls]) return E_OVERFLOW_TU;
  int32_t *meta = fs.tu_meta[cls] + k * 3;
  meta[0] = x0; meta[1] = y0; meta[2] = cpl;
  memcpy(fs.tu_coef[cls] + k * (long)(n * n), coef,
         sizeof(int32_t) * (size_t)(n * n));
  fs.tu_n[cls] = k + 1;
  return E_OK;
}

// mc class order: (luma,8),(luma,4),(chroma,8),(chroma,4)
static int push_mc(FS &fs, int pl, int t, int dy, int dx, int mx0,
                   int my0, int r0, int mx1, int my1, int r1, int comp,
                   int filt) {
  int cls = (pl == 0 ? 0 : 2) + (t == 8 ? 0 : 1);
  long k = fs.mc_n[cls];
  if (k >= fs.caps[cls]) return E_OVERFLOW_MC;
  int32_t *rec = fs.mc[cls] + k * 11;
  rec[0] = pl; rec[1] = dy; rec[2] = dx; rec[3] = mx0; rec[4] = my0;
  rec[5] = r0; rec[6] = mx1; rec[7] = my1; rec[8] = r1; rec[9] = comp;
  rec[10] = filt;
  fs.mc_n[cls] = k + 1;
  return E_OK;
}

static inline int rdiv2(int s) {
  return s >= 0 ? (s + 1) / 2 : -((-s + 1) / 2);
}
static inline int rdiv4(int s) {
  return s >= 0 ? (s + 2) / 4 : -((-s + 2) / 4);
}

// inter.py mc_calls + recorder.py record_inter MC part: enumerate the
// block's MC geometry, merging compound (li 0/1 share geometry), and
// decompose into 8x8/4x4 tiles.
static int record_inter_mc(FS &fs) {
  int row = fs.row, col = fs.col, bs = fs.bs;
  int py0 = row * 8, px0 = col * 8;
  int filt = fs.filt, comp = fs.comp;
  int r0 = fs.refs[0], r1c = comp ? fs.refs[1] : 0;
  // geometry list: (pl, dy, dx, bh, bw, k or -1 for uvmv, shift)
  struct Geo { int pl, dy, dx, bh, bw, k; };
  Geo geos[7];
  int ng = 0;
  int uv_mv[2][2];  // [li][x,y] averaged chroma MV for sub-8x8
  bool sub8 = false;
  if (bs == BS_8x4) {
    geos[ng++] = {0, py0, px0, 4, 8, 0};
    geos[ng++] = {0, py0 + 4, px0, 4, 8, 2};
    for (int li = 0; li < 2; li++) {
      uv_mv[li][0] = rdiv2(fs.mv[0][li][0] + fs.mv[2][li][0]);
      uv_mv[li][1] = rdiv2(fs.mv[0][li][1] + fs.mv[2][li][1]);
    }
    sub8 = true;
  } else if (bs == BS_4x8) {
    geos[ng++] = {0, py0, px0, 8, 4, 0};
    geos[ng++] = {0, py0, px0 + 4, 8, 4, 1};
    for (int li = 0; li < 2; li++) {
      uv_mv[li][0] = rdiv2(fs.mv[0][li][0] + fs.mv[1][li][0]);
      uv_mv[li][1] = rdiv2(fs.mv[0][li][1] + fs.mv[1][li][1]);
    }
    sub8 = true;
  } else if (bs > BS_8x8) {  // BS_4x4
    geos[ng++] = {0, py0, px0, 4, 4, 0};
    geos[ng++] = {0, py0, px0 + 4, 4, 4, 1};
    geos[ng++] = {0, py0 + 4, px0, 4, 4, 2};
    geos[ng++] = {0, py0 + 4, px0 + 4, 4, 4, 3};
    for (int li = 0; li < 2; li++) {
      uv_mv[li][0] = rdiv4(fs.mv[0][li][0] + fs.mv[1][li][0] +
                           fs.mv[2][li][0] + fs.mv[3][li][0]);
      uv_mv[li][1] = rdiv4(fs.mv[0][li][1] + fs.mv[1][li][1] +
                           fs.mv[2][li][1] + fs.mv[3][li][1]);
    }
    sub8 = true;
  } else {
    int bw = fs.bwh[(0 * 13 + bs) * 2 + 0] * 4;
    int bh = fs.bwh[(0 * 13 + bs) * 2 + 1] * 4;
    geos[ng++] = {0, py0, px0, bh, bw, 0};
    int uvbw = fs.bwh[(1 * 13 + bs) * 2 + 0] * 4;
    int uvbh = fs.bwh[(1 * 13 + bs) * 2 + 1] * 4;
    geos[ng++] = {1, py0 >> 1, px0 >> 1, uvbh, uvbw, 0};
    geos[ng++] = {2, py0 >> 1, px0 >> 1, uvbh, uvbw, 0};
  }
  if (sub8) {
    geos[ng++] = {1, py0 >> 1, px0 >> 1, 4, 4, -1};
    geos[ng++] = {2, py0 >> 1, px0 >> 1, 4, 4, -1};
  }
  for (int gi = 0; gi < ng; gi++) {
    const Geo &g = geos[gi];
    int m0x, m0y, m1x = 0, m1y = 0;
    if (g.k >= 0) {
      m0x = fs.mv[g.k][0][0]; m0y = fs.mv[g.k][0][1];
      if (comp) { m1x = fs.mv[g.k][1][0]; m1y = fs.mv[g.k][1][1]; }
    } else {
      m0x = uv_mv[0][0]; m0y = uv_mv[0][1];
      if (comp) { m1x = uv_mv[1][0]; m1y = uv_mv[1][1]; }
    }
    int t = (g.bh >= 8 && g.bw >= 8) ? 8 : 4;
    for (int oy = 0; oy < g.bh; oy += t)
      for (int ox = 0; ox < g.bw; ox += t) {
        int e = push_mc(fs, g.pl, t, g.dy + oy, g.dx + ox, m0x, m0y,
                        r0, m1x, m1y, r1c, comp, filt);
        if (e) return e;
      }
  }
  return E_OK;
}

// -------------------------------------------------------------- lf masks
static inline void max_at(int32_t *a, long i, int v) {
  if (a[i] < v) a[i] = v;
}

// block.py _mask_plane_skip / _mask_plane / _mask_plane_uv
static void mask_edges(FS &fs, int row, int col, int w4, int h4,
                       int tx, int uvtx, int bs, bool skip_inter) {
  const Hdr &h = fs.h;
  int w = std::min(w4, h.cols - col);
  int hh = std::min(h4, h.rows - row);
  int c4 = fs.c4, c4uv = c4 >> 1;
  if (skip_inter) {
    int r2 = row * 2, c2 = col * 2;
    if (tx != TX_4X4) {
      int wd = tx == TX_8X8 ? 8 : 16;
      for (int x = 0; x < w * 2; x++) max_at(fs.wd_h, (long)r2 * c4 + c2 + x, wd);
      for (int y = 0; y < hh * 2; y++) max_at(fs.wd_v, (long)(r2 + y) * c4 + c2, wd);
    } else {
      int wv = (col & 3) == 0 ? 8 : 4;
      for (int y = 0; y < hh * 2; y++) max_at(fs.wd_v, (long)(r2 + y) * c4 + c2, wv);
      int wh = (row & 3) == 0 ? 8 : 4;
      for (int x = 0; x < w * 2; x++) max_at(fs.wd_h, (long)r2 * c4 + c2 + x, wh);
    }
    // chroma
    if (uvtx == TX_4X4) {
      if (hh == 1) {
        if (row & 1) return;
        if (row + 1 < h.rows) hh += 1;
      }
      if (w == 1) {
        if (col & 1) return;
        if (col + 1 < h.cols) w += 1;
      }
    }
    if (uvtx != TX_4X4) {
      int wdt = (uvtx == TX_8X8 || hh == 1) ? 8 : 16;
      for (int x = 0; x < w; x++) max_at(fs.wd_h_uv, (long)row * c4uv + col + x, wdt);
      int wdl = (uvtx == TX_8X8 || w == 1) ? 8 : 16;
      for (int y = 0; y < hh; y++) max_at(fs.wd_v_uv, (long)(row + y) * c4uv + col, wdl);
    } else {
      int wv = (col & 7) == 0 ? 8 : 4;
      for (int y = 0; y < hh; y++) max_at(fs.wd_v_uv, (long)(row + y) * c4uv + col, wv);
      int wh = (row & 7) == 0 ? 8 : 4;
      for (int x = 0; x < w; x++) max_at(fs.wd_h_uv, (long)row * c4uv + col + x, wh);
    }
    return;
  }
  // luma (_mask_plane)
  if (tx == TX_4X4) {
    for (int yy = 0; yy < hh; yy++) {
      int y8 = row + yy;
      for (int xx = 0; xx < w; xx++) {
        int x8 = col + xx;
        int wv = (x8 & 3) == 0 ? 8 : 4;
        max_at(fs.wd_v, (long)(y8 * 2) * c4 + x8 * 2, wv);
        max_at(fs.wd_v, (long)(y8 * 2 + 1) * c4 + x8 * 2, wv);
        max_at(fs.wd_v, (long)(y8 * 2) * c4 + x8 * 2 + 1, 4);
        max_at(fs.wd_v, (long)(y8 * 2 + 1) * c4 + x8 * 2 + 1, 4);
        int wh = (y8 & 3) == 0 ? 8 : 4;
        max_at(fs.wd_h, (long)(y8 * 2) * c4 + x8 * 2, wh);
        max_at(fs.wd_h, (long)(y8 * 2) * c4 + x8 * 2 + 1, wh);
        max_at(fs.wd_h, (long)(y8 * 2 + 1) * c4 + x8 * 2, 4);
        max_at(fs.wd_h, (long)(y8 * 2 + 1) * c4 + x8 * 2 + 1, 4);
      }
    }
  } else {
    int step = 1 << (tx - 1);
    int wd = tx == TX_8X8 ? 8 : 16;
    for (int yy = 0; yy < hh; yy++) {
      int y8 = row + yy;
      for (int xx = 0; xx < w; xx += step)
        if (((col + xx) & (step - 1)) == 0) {
          int x8 = col + xx;
          max_at(fs.wd_v, (long)(y8 * 2) * c4 + x8 * 2, wd);
          max_at(fs.wd_v, (long)(y8 * 2 + 1) * c4 + x8 * 2, wd);
        }
    }
    for (int yy = 0; yy < hh; yy += step)
      if (((row + yy) & (step - 1)) == 0) {
        int y8 = row + yy;
        for (int xx = 0; xx < w; xx++) {
          int x8 = col + xx;
          max_at(fs.wd_h, (long)(y8 * 2) * c4 + x8 * 2, wd);
          max_at(fs.wd_h, (long)(y8 * 2) * c4 + x8 * 2 + 1, wd);
        }
      }
  }
  // chroma (_mask_plane_uv)
  if (uvtx == TX_4X4) {
    if (hh == 1) {
      if (row & 1) return;
      if (row + 1 < h.rows) hh += 1;
    }
    if (w == 1) {
      if (col & 1) return;
      if (col + 1 < h.cols) w += 1;
    }
    for (int yy = row; yy < row + hh; yy++)
      for (int xx = col; xx < col + w; xx++) {
        int wv = (xx & 7) == 0 ? 8 : 4;
        max_at(fs.wd_v_uv, (long)yy * c4uv + xx, wv);
        int wh = (yy & 7) == 0 ? 8 : 4;
        max_at(fs.wd_h_uv, (long)yy * c4uv + xx, wh);
      }
    return;
  }
  int step = 1 << uvtx;
  int wd = uvtx == TX_8X8 ? 8 : 16;
  bool odd_w = uvtx > TX_8X8 && (w & 1);
  bool odd_h = uvtx > TX_8X8 && (hh & 1);
  for (int yy = row; yy < row + hh; yy++)
    for (int xx = col; xx < col + w; xx++) {
      if ((xx & (step - 1)) == 0) {
        int wv = (odd_w && xx - col == w - 1) ? 8 : wd;
        max_at(fs.wd_v_uv, (long)yy * c4uv + xx, wv);
      }
      if ((yy & (step - 1)) == 0) {
        int wh = (odd_h && yy - row == hh - 1) ? 8 : wd;
        max_at(fs.wd_h_uv, (long)yy * c4uv + xx, wh);
      }
    }
}

// ----------------------------------------------------- inter mode ctx
// block.py _comp_ctx / _comp_ref_ctx / _single_ref_ctx1/2
static int comp_ctx(FS &fs, int have_a, int have_l) {
  const Hdr &h = fs.h;
  int row7 = fs.row & 7, col = fs.col;
  int a_c = fs.a_comp[col], l_c = fs.l_comp[row7];
  int a_i = fs.a_intra[col], l_i = fs.l_intra[row7];
  int a_r = fs.a_ref[col], l_r = fs.l_ref[row7];
  int fix = h.fixcompref;
  if (have_a) {
    if (have_l) {
      if (a_c && l_c) return 4;
      if (a_c) return 2 + (l_i || l_r == fix);
      if (l_c) return 2 + (a_i || a_r == fix);
      return ((!a_i && a_r == fix) ^ (!l_i && l_r == fix)) ? 1 : 0;
    }
    return a_c ? 3 : (!a_i && a_r == fix ? 1 : 0);
  }
  if (have_l) return l_c ? 3 : (!l_i && l_r == fix ? 1 : 0);
  return 1;
}

static int comp_ref_ctx(FS &fs, int have_a, int have_l) {
  const Hdr &h = fs.h;
  int row7 = fs.row & 7, col = fs.col;
  int a_c = fs.a_comp[col], l_c = fs.l_comp[row7];
  int a_i = fs.a_intra[col], l_i = fs.l_intra[row7];
  int a_r = fs.a_ref[col], l_r = fs.l_ref[row7];
  int var1 = h.varcompref[1];
  if (have_a) {
    if (have_l) {
      if (a_i) {
        if (l_i) return 2;
        return 1 + 2 * (l_r != var1);
      }
      if (l_i) return 1 + 2 * (a_r != var1);
      if (l_r == a_r && a_r == var1) return 0;
      if (!l_c && !a_c) {
        if ((a_r == h.fixcompref && l_r == h.varcompref[0]) ||
            (l_r == h.fixcompref && a_r == h.varcompref[0]))
          return 4;
        return a_r == l_r ? 3 : 1;
      }
      if (!l_c) {
        if (a_r == var1 && l_r != var1) return 1;
        return (l_r == var1 && a_r != var1) ? 2 : 4;
      }
      if (!a_c) {
        if (l_r == var1 && a_r != var1) return 1;
        return (a_r == var1 && l_r != var1) ? 2 : 4;
      }
      return l_r == a_r ? 4 : 2;
    }
    if (a_i) return 2;
    if (a_c) return 4 * (a_r != var1);
    return 3 * (a_r != var1);
  }
  if (have_l) {
    if (l_i) return 2;
    if (l_c) return 4 * (l_r != var1);
    return 3 * (l_r != var1);
  }
  return 2;
}

static int single_ref_ctx1(FS &fs, int have_a, int have_l) {
  const Hdr &h = fs.h;
  int row7 = fs.row & 7, col = fs.col;
  int a_c = fs.a_comp[col], l_c = fs.l_comp[row7];
  int a_i = fs.a_intra[col], l_i = fs.l_intra[row7];
  int a_r = fs.a_ref[col], l_r = fs.l_ref[row7];
  if (have_a && !a_i) {
    if (have_l && !l_i) {
      if (l_c) {
        if (a_c) return 1 + (!h.fixcompref || !l_r || !a_r);
        return 3 * (!a_r) + (!h.fixcompref || !l_r);
      }
      if (a_c) return 3 * (!l_r) + (!h.fixcompref || !a_r);
      return 2 * (!l_r) + 2 * (!a_r);
    }
    if (a_i) return 2;
    if (a_c) return 1 + (!h.fixcompref || !a_r);
    return 4 * (!a_r);
  }
  if (have_l && !l_i) {
    if (l_i) return 2;
    if (l_c) return 1 + (!h.fixcompref || !l_r);
    return 4 * (!l_r);
  }
  return 2;
}

static int single_ref_ctx2(FS &fs, int have_a, int have_l) {
  const Hdr &h = fs.h;
  int row7 = fs.row & 7, col = fs.col;
  int a_c = fs.a_comp[col], l_c = fs.l_comp[row7];
  int a_i = fs.a_intra[col], l_i = fs.l_intra[row7];
  int a_r = fs.a_ref[col], l_r = fs.l_ref[row7];
  bool fix1 = h.fixcompref == 1;
  if (have_a) {
    if (have_l) {
      if (l_i) {
        if (a_i) return 2;
        if (a_c) return 1 + 2 * (fix1 || a_r == 1);
        if (!a_r) return 3;
        return 4 * (a_r == 1);
      }
      if (a_i) {
        if (l_i) return 2;
        if (l_c) return 1 + 2 * (fix1 || l_r == 1);
        if (!l_r) return 3;
        return 4 * (l_r == 1);
      }
      if (a_c) {
        if (l_c) {
          if (l_r == a_r) return 3 * (fix1 || l_r == 1);
          return 2;
        }
        if (!l_r) return 1 + 2 * (fix1 || a_r == 1);
        return 3 * (l_r == 1) + (fix1 || a_r == 1);
      }
      if (l_c) {
        if (!a_r) return 1 + 2 * (fix1 || l_r == 1);
        return 3 * (a_r == 1) + (fix1 || l_r == 1);
      }
      if (!a_r) {
        if (!l_r) return 3;
        return 4 * (l_r == 1);
      }
      if (!l_r) return 4 * (a_r == 1);
      return 2 * (l_r == 1) + 2 * (a_r == 1);
    }
    if (a_i || (!a_c && !a_r)) return 2;
    if (a_c) return 3 * (fix1 || a_r == 1);
    return 4 * (a_r == 1);
  }
  if (have_l) {
    if (l_i || (!l_c && !l_r)) return 2;
    if (l_c) return 3 * (fix1 || l_r == 1);
    return 4 * (l_r == 1);
  }
  return 2;
}

// block.py _tx_size
static int tx_size(FS &fs, int max_tx, int c) {
  BoolDec &io = *fs.bd;
  int tx;
  if (max_tx == TX_32X32) {
    const int32_t *p = fs.p_tx32 + c * 3;
    tx = io.get((int)p[0]);
    if (tx) {
      tx += io.get((int)p[1]);
      if (tx == 2) tx += io.get((int)p[2]);
    }
    fs.c_tx32[c * 4 + tx]++;
  } else if (max_tx == TX_16X16) {
    const int32_t *p = fs.p_tx16 + c * 2;
    tx = io.get((int)p[0]);
    if (tx) tx += io.get((int)p[1]);
    fs.c_tx16[c * 3 + tx]++;
  } else if (max_tx == TX_8X8) {
    tx = io.get((int)fs.p_tx8[c]);
    fs.c_tx8[c * 2 + tx]++;
  } else {
    tx = TX_4X4;
  }
  return tx;
}

// --------------------------------------------------------- decode block
// Fused block.py decode_block + _coeffs + recorder record_* : coeffs
// are decoded and immediately emitted as TU / intra records (the
// iteration order is identical to the Python pair, which matters for
// the intra dependency-level grid).
static int decode_block(FS &fs, int row, int col, int bl, int bp,
                        bool is_key) {
  BoolDec &io = *fs.bd;
  const Hdr &h = fs.h;
  int bs = bl * 3 + bp;
  fs.bs = bs;
  int w4 = fs.bwh[(1 * 13 + bs) * 2 + 0];  // MI units
  int h4 = fs.bwh[(1 * 13 + bs) * 2 + 1];
  int w4c = std::min(h.cols - col, w4);
  int h4c = std::min(h.rows - row, h4);
  int row7 = row & 7;
  int have_a = row > 0;
  int have_l = col > fs.tile_col_start;
  int max_tx = MAX_TX_FOR_BS[bs];
  fs.row = row; fs.col = col;
  fs.min_mv[0] = -(128 + col * 64);
  fs.min_mv[1] = -(128 + row * 64);
  fs.max_mv[0] = 128 + (h.cols - col - w4) * 64;
  fs.max_mv[1] = 128 + (h.rows - row - h4) * 64;
  fs.comp = 0; fs.refs[0] = fs.refs[1] = 0;
  for (int k = 0; k < 4; k++)
    fs.mv[k][0][0] = fs.mv[k][0][1] = fs.mv[k][1][0] = fs.mv[k][1][1] = 0;

  // skip flag
  int c = fs.l_skip[row7] + fs.a_skip[col];
  int skip = io.get((int)fs.p_skip[c]);
  fs.c_skip[c * 2 + skip]++;

  // intra/inter flag
  int intra;
  if (is_key) {
    intra = 1;
  } else {
    if (have_a) {
      if (have_l) {
        c = fs.a_intra[col] + fs.l_intra[row7];
        c += (c == 2);
      } else {
        c = 2 * fs.a_intra[col];
      }
    } else if (have_l) {
      c = 2 * fs.l_intra[row7];
    } else {
      c = 0;
    }
    int bit = io.get((int)fs.p_intra[c]);
    fs.c_intra[c * 2 + bit]++;
    intra = 1 - bit;
  }
  fs.intra_ = intra;

  // tx size
  int tx;
  if ((intra || !skip) && h.txfmmode == 4) {
    if (have_a) {
      int a_tx = fs.a_skip[col] ? max_tx : fs.a_txfm[col];
      if (have_l) {
        int l_tx = fs.l_skip[row7] ? max_tx : fs.l_txfm[row7];
        c = (a_tx + l_tx > max_tx);
      } else {
        c = fs.a_skip[col] ? 1 : (fs.a_txfm[col] * 2 > max_tx);
      }
    } else if (have_l) {
      c = fs.l_skip[row7] ? 1 : (fs.l_txfm[row7] * 2 > max_tx);
    } else {
      c = 1;
    }
    tx = tx_size(fs, max_tx, c);
  } else {
    tx = std::min(max_tx, h.txfmmode);
  }
  fs.tx = tx;

  int *modes = fs.modes;
  modes[0] = modes[1] = modes[2] = modes[3] = 0;
  int uvmode = 0, filter_id = 0;
  fs.filt = 0;
  if (is_key) {
    int32_t *a = &fs.a_mode[col * 2];
    int32_t *l = &fs.l_mode[row7 * 2];
    auto ym = [&](int av, int lv) {
      return io.tree(fs.t_imode, fs.kf_ym + (av * 10 + lv) * 9);
    };
    if (bs > BS_8x8) {
      modes[0] = a[0] = ym(a[0], l[0]);
      if (bs != BS_8x4) {
        modes[1] = ym(a[1], modes[0]);
        l[0] = a[1] = modes[1];
      } else {
        l[0] = a[1] = modes[1] = modes[0];
      }
      if (bs != BS_4x8) {
        modes[2] = a[0] = ym(a[0], l[1]);
        if (bs != BS_8x4) {
          modes[3] = ym(a[1], modes[2]);
          l[1] = a[1] = modes[3];
        } else {
          l[1] = a[1] = modes[3] = modes[2];
        }
      } else {
        modes[2] = modes[0];
        l[1] = a[1] = modes[3] = modes[1];
      }
    } else {
      int m = ym(a[0], l[0]);
      modes[0] = modes[1] = modes[2] = modes[3] = m;
      for (int i = 0; i < w4 * 2; i++) a[i] = m;
      for (int i = 0; i < h4 * 2; i++) l[i] = m;
    }
    uvmode = io.tree(fs.t_imode, fs.kf_uv + modes[3] * 9);
  } else if (intra) {
    // _intra_in_inter_modes
    auto ym = [&](int grp) {
      int m = io.tree(fs.t_imode, fs.p_ym + grp * 9);
      fs.c_ym[grp * 10 + m]++;
      return m;
    };
    if (bs > BS_8x8) {
      modes[0] = ym(0);
      modes[1] = (bs != BS_8x4) ? ym(0) : modes[0];
      if (bs != BS_4x8) {
        modes[2] = ym(0);
        modes[3] = (bs != BS_8x4) ? ym(0) : modes[2];
      } else {
        modes[2] = modes[0];
        modes[3] = modes[1];
      }
    } else {
      int m = ym(SIZE_GROUP[bs]);
      modes[0] = modes[1] = modes[2] = modes[3] = m;
    }
    uvmode = io.tree(fs.t_imode, fs.p_uv + modes[3] * 9);
    fs.c_uv[modes[3] * 10 + uvmode]++;
  } else {
    // _inter_modes
    if (h.comppredmode != 2) {
      fs.comp = (h.comppredmode == 1);
    } else {
      c = comp_ctx(fs, have_a, have_l);
      fs.comp = io.get((int)fs.p_comp[c]);
      fs.c_comp[c * 2 + fs.comp]++;
    }
    if (fs.comp) {
      int fix_idx = h.signbias[h.fixcompref];
      int var_idx = 1 - fix_idx;
      fs.refs[fix_idx] = h.fixcompref;
      c = comp_ref_ctx(fs, have_a, have_l);
      int bit = io.get((int)fs.p_cref[c]);
      fs.c_cref[c * 2 + bit]++;
      fs.refs[var_idx] = h.varcompref[bit];
    } else {
      c = single_ref_ctx1(fs, have_a, have_l);
      int bit = io.get((int)fs.p_sref[c * 2 + 0]);
      fs.c_sref[(c * 2 + 0) * 2 + bit]++;
      if (!bit) {
        fs.refs[0] = 0;
      } else {
        c = single_ref_ctx2(fs, have_a, have_l);
        bit = io.get((int)fs.p_sref[c * 2 + 1]);
        fs.c_sref[(c * 2 + 1) * 2 + bit]++;
        fs.refs[0] = 1 + bit;
      }
    }
    if (bs <= BS_8x8) {
      int off = INTER_MODE_CTX_OFF[bs];
      c = fs.imctx[fs.a_mode8[col + off] * 14 + fs.l_mode8[row7 + off]];
      int m = io.tree(fs.t_inter, fs.p_mvmode + c * 3);
      fs.c_mvmode[c * 4 + (m - 10)]++;
      modes[0] = modes[1] = modes[2] = modes[3] = m;
    }
    if (h.filtermode == 4) {
      if (have_a && fs.a_mode8[col] >= 10) {
        if (have_l && fs.l_mode8[row7] >= 10)
          c = (fs.a_filter[col] == fs.l_filter[row7])
                  ? fs.l_filter[row7] : 3;
        else
          c = fs.a_filter[col];
      } else if (have_l && fs.l_mode8[row7] >= 10) {
        c = fs.l_filter[row7];
      } else {
        c = 3;
      }
      filter_id = io.tree(fs.t_filter, fs.p_filt + c * 2);
      fs.c_filt[c * 3 + filter_id]++;
      fs.filt = FILTER_LUT[filter_id];
    } else {
      filter_id = 0;
      fs.filt = h.filtermode;
    }
    if (bs > BS_8x8) {
      c = fs.imctx[fs.a_mode8[col] * 14 + fs.l_mode8[row7]];
      auto sub_mode = [&]() {
        int m = io.tree(fs.t_inter, fs.p_mvmode + c * 3);
        fs.c_mvmode[c * 4 + (m - 10)]++;
        return m;
      };
      modes[0] = sub_mode();
      fill_mv(fs, modes[0], 0, 0);
      if (bs != BS_8x4) {
        modes[1] = sub_mode();
        fill_mv(fs, modes[1], 1, 1);
      } else {
        modes[1] = modes[0];
        memcpy(fs.mv[1], fs.mv[0], sizeof(fs.mv[0]));
      }
      if (bs != BS_4x8) {
        modes[2] = sub_mode();
        fill_mv(fs, modes[2], 2, 2);
        if (bs != BS_8x4) {
          modes[3] = sub_mode();
          fill_mv(fs, modes[3], 3, 3);
        } else {
          modes[3] = modes[2];
          memcpy(fs.mv[3], fs.mv[2], sizeof(fs.mv[2]));
        }
      } else {
        modes[2] = modes[0];
        memcpy(fs.mv[2], fs.mv[0], sizeof(fs.mv[0]));
        modes[3] = modes[1];
        memcpy(fs.mv[3], fs.mv[1], sizeof(fs.mv[1]));
      }
    } else {
      fill_mv(fs, modes[0], -1, 0);
      memcpy(fs.mv[1], fs.mv[0], sizeof(fs.mv[0]));
      memcpy(fs.mv[2], fs.mv[0], sizeof(fs.mv[0]));
      memcpy(fs.mv[3], fs.mv[0], sizeof(fs.mv[0]));
    }
  }
  int uvtx = tx - ((w4 * 2 == (1 << tx)) || (h4 * 2 == (1 << tx)));
  fs.uvtx = uvtx;
  fs.uvmode = uvmode;

  // context write-back (SET_CTXS)
  for (int i = 0; i < w4; i++) {
    fs.a_skip[col + i] = skip;
    fs.a_txfm[col + i] = tx;
    fs.a_part[col + i] = ABOVE_CTX_TAB[bs];
  }
  for (int i = 0; i < h4; i++) {
    fs.l_skip[row7 + i] = skip;
    fs.l_txfm[row7 + i] = tx;
    fs.l_part[row7 + i] = LEFT_CTX_TAB[bs];
  }
  if (!is_key) {
    int vref = fs.comp ? fs.refs[h.signbias[h.varcompref[0]]]
                       : fs.refs[0];
    for (int i = 0; i < w4; i++) {
      fs.a_intra[col + i] = intra;
      fs.a_comp[col + i] = fs.comp;
      fs.a_mode8[col + i] = modes[3];
    }
    for (int i = 0; i < h4; i++) {
      fs.l_intra[row7 + i] = intra;
      fs.l_comp[row7 + i] = fs.comp;
      fs.l_mode8[row7 + i] = modes[3];
    }
    if (!intra) {
      for (int i = 0; i < w4; i++) fs.a_ref[col + i] = vref;
      for (int i = 0; i < h4; i++) fs.l_ref[row7 + i] = vref;
      if (h.filtermode == 4) {
        for (int i = 0; i < w4; i++) fs.a_filter[col + i] = filter_id;
        for (int i = 0; i < h4; i++) fs.l_filter[row7 + i] = filter_id;
      }
    }
    // MV context write-back (4px granularity)
    auto set_amv = [&](int idx, int k) {
      int32_t *d = &fs.a_mvctx[idx * 4];
      d[0] = fs.mv[k][0][0]; d[1] = fs.mv[k][0][1];
      d[2] = fs.mv[k][1][0]; d[3] = fs.mv[k][1][1];
    };
    auto set_lmv = [&](int idx, int k) {
      fs.l_mvctx[idx][0][0] = fs.mv[k][0][0];
      fs.l_mvctx[idx][0][1] = fs.mv[k][0][1];
      fs.l_mvctx[idx][1][0] = fs.mv[k][1][0];
      fs.l_mvctx[idx][1][1] = fs.mv[k][1][1];
    };
    if (bs > BS_8x8) {
      set_lmv(row7 * 2 + 0, 1);
      set_lmv(row7 * 2 + 1, 3);
      set_amv(col * 2 + 0, 2);
      set_amv(col * 2 + 1, 3);
    } else {
      for (int i = 0; i < w4c * 2; i++) set_amv(col * 2 + i, 3);
      for (int i = 0; i < h4c * 2; i++) set_lmv(row7 * 2 + i, 3);
    }
    // whole-frame MV grid
    for (int r = row; r < row + h4c; r++)
      for (int cc = col; cc < col + w4c; cc++) {
        long gi = ((long)r * h.mi_stride + cc) * 2;
        if (intra) {
          fs.mv_ref[gi] = fs.mv_ref[gi + 1] = -1;
        } else {
          fs.mv_ref[gi] = fs.refs[0];
          fs.mv_ref[gi + 1] = fs.comp ? fs.refs[1] : -1;
          fs.mv_xy[gi * 2 + 0] = fs.mv[3][0][0];
          fs.mv_xy[gi * 2 + 1] = fs.mv[3][0][1];
          if (fs.comp) {
            fs.mv_xy[gi * 2 + 2] = fs.mv[3][1][0];
            fs.mv_xy[gi * 2 + 3] = fs.mv[3][1][1];
          }
        }
      }
  }

  // coefficients + fused record emission
  int w44 = w4 * 2, h44 = h4 * 2;  // 4px units
  int end_x = std::min(2 * (h.cols - col), w44);
  int end_y = std::min(2 * (h.rows - row), h44);
  int px = col * 8, py = row * 8;
  int pw = h.cols * 8, ph = h.rows * 8;
  long total_eob = 0;
  static thread_local int32_t coefbuf[32 * 32];
  int inter = intra ? 0 : 1;

  // intra record helper: push one luma/chroma tx block
  auto push_intra_blk = [&](int pl, int x, int y, int n, int mode,
                            int txtp, const int32_t *coef,
                            int blk_w4) -> int {
    int es[4];
    int cw = pl == 0 ? pw : pw >> 1, ch = pl == 0 ? ph : ph >> 1;
    int bx = pl == 0 ? px + x * 4 : (px >> 1) + x * 4;
    int by = pl == 0 ? py + y * 4 : (py >> 1) + y * 4;
    edge_spec(fs, cw, ch, bx, by, n, mode,
              (row > 0 || y > 0) ? 1 : 0,
              (col > fs.tile_col_start || x > 0) ? 1 : 0,
              (x < blk_w4 - 1) ? 1 : 0,
              (pl == 0 ? tx : uvtx) == TX_4X4 ? 1 : 0, es);
    return push_intra(fs, pl, bx, by, n, es[0], es[1], es[2], es[3],
                      txtp, coef, pl ? pl - 1 : 0);
  };

  if (skip) {
    for (int i = 0; i < w44; i++) fs.a_ynnz[col * 2 + i] = 0;
    for (int i = 0; i < h44; i++) fs.l_ynnz[row7 * 2 + i] = 0;
    for (int i = 0; i < w4; i++) {
      fs.a_uvnnz0[col + i] = 0;
      fs.a_uvnnz1[col + i] = 0;
    }
    for (int i = 0; i < h4; i++) {
      fs.l_uvnnz0[row7 + i] = 0;
      fs.l_uvnnz1[row7 + i] = 0;
    }
    if (intra) {
      int step = 1 << tx;
      for (int y = 0; y < end_y; y += step)
        for (int x = 0; x < end_x; x += step) {
          int mode = modes[(bs > BS_8x8 && tx == TX_4X4) ? 2 * y + x : 0];
          int txtp = tx != TX_32X32 ? fs.itxtp[mode] : DCT_DCT;
          int e = push_intra_blk(0, x, y, step * 4, mode, txtp,
                                 nullptr, w44);
          if (e) return e;
        }
      int ustep = 1 << uvtx;
      for (int pl = 0; pl < 2; pl++)
        for (int y = 0; y < end_y >> 1; y += ustep)
          for (int x = 0; x < end_x >> 1; x += ustep) {
            int e = push_intra_blk(1 + pl, x, y, ustep * 4, uvmode,
                                   DCT_DCT, nullptr, w44 >> 1);
            if (e) return e;
          }
    }
  } else {
    // luma
    int32_t *a = &fs.a_ynnz[col * 2];
    int32_t *l = &fs.l_ynnz[row7 * 2];
    int step1d = 1 << tx;
    const int *ybc = BAND_COUNTS[tx];
    const int32_t *p = fs.p_coef + (((tx * 2 + 0) * 2 + inter) * 36) * 11;
    int64_t *cnt3 = fs.c_coef + (((tx * 2 + 0) * 2 + inter) * 36) * 3;
    int64_t *eob2 = fs.c_eob + (((tx * 2 + 0) * 2 + inter) * 36) * 2;
    if (tx > 0) {
      for (int n = 0; n < end_y; n += step1d) {
        int any = 0;
        for (int k = n; k < n + step1d; k++) any |= l[k] != 0;
        l[n] = any;
      }
      for (int n = 0; n < end_x; n += step1d) {
        int any = 0;
        for (int k = n; k < n + step1d; k++) any |= a[k] != 0;
        a[n] = any;
      }
    }
    for (int y = 0; y < end_y; y += step1d)
      for (int x = 0; x < end_x; x += step1d) {
        int mode = modes[(bs > BS_8x8 && tx == TX_4X4) ? 2 * y + x : 0];
        int txtp = intra ? (tx != TX_32X32 ? fs.itxtp[mode] : DCT_DCT)
                         : DCT_DCT;
        const int32_t *scan = fs.scans + ((long)tx * 4 + txtp) * 1024;
        const int32_t *nb = fs.nbs + (((long)tx * 4 + txtp) * 1024) * 2;
        int n1 = step1d * 4;
        memset(coefbuf, 0, sizeof(int32_t) * (size_t)(n1 * n1));
        int eob = coeff_block(fs, 16 * step1d * step1d,
                              tx == TX_32X32 ? 1 : 0, p,
                              a[x] + l[y], scan, nb, ybc,
                              h.qmul[0], coefbuf, cnt3, eob2);
        if (eob < 0) return eob;
        a[x] = l[y] = eob ? 1 : 0;
        total_eob += eob;
        if (intra) {
          int e = push_intra_blk(0, x, y, n1, mode, txtp,
                                 eob ? coefbuf : nullptr, w44);
          if (e) return e;
        } else if (eob) {
          int e = push_tu(fs, 1, n1, px + x * 4, py + y * 4, coefbuf, 0);
          if (e) return e;
        }
      }
    if (tx > 0) {
      for (int base = 0; base < end_y; base += step1d)
        for (int k = base; k < std::min(base + step1d, end_y); k++)
          l[k] = l[base];
      for (int base = 0; base < end_x; base += step1d)
        for (int k = base; k < std::min(base + step1d, end_x); k++)
          a[k] = a[base];
      for (int k = end_x; k < w44; k++) a[k] = 0;
      for (int k = end_y; k < h44; k++) l[k] = 0;
    }
    // chroma
    int uvstep = 1 << uvtx;
    int w4h = w44 >> 1, h4h = h44 >> 1;
    int end_xc = end_x >> 1, end_yc = end_y >> 1;
    const int32_t *scan = fs.scans + ((long)uvtx * 4 + DCT_DCT) * 1024;
    const int32_t *nbuv = fs.nbs + (((long)uvtx * 4 + DCT_DCT) * 1024) * 2;
    const int *uvbc = BAND_COUNTS[uvtx];
    p = fs.p_coef + (((uvtx * 2 + 1) * 2 + inter) * 36) * 11;
    cnt3 = fs.c_coef + (((uvtx * 2 + 1) * 2 + inter) * 36) * 3;
    eob2 = fs.c_eob + (((uvtx * 2 + 1) * 2 + inter) * 36) * 2;
    for (int pl = 0; pl < 2; pl++) {
      int32_t *au = pl == 0 ? &fs.a_uvnnz0[col] : &fs.a_uvnnz1[col];
      int32_t *lu = pl == 0 ? &fs.l_uvnnz0[row7] : &fs.l_uvnnz1[row7];
      if (uvtx > 0) {
        for (int n = 0; n < end_yc; n += uvstep) {
          int any = 0;
          for (int k = n; k < n + uvstep; k++) any |= lu[k] != 0;
          lu[n] = any;
        }
        for (int n = 0; n < end_xc; n += uvstep) {
          int any = 0;
          for (int k = n; k < n + uvstep; k++) any |= au[k] != 0;
          au[n] = any;
        }
      }
      for (int y = 0; y < end_yc; y += uvstep)
        for (int x = 0; x < end_xc; x += uvstep) {
          int n1 = uvstep * 4;
          memset(coefbuf, 0, sizeof(int32_t) * (size_t)(n1 * n1));
          int eob = coeff_block(fs, 16 * uvstep * uvstep,
                                uvtx == TX_32X32 ? 1 : 0, p,
                                au[x] + lu[y], scan, nbuv, uvbc,
                                h.qmul[1], coefbuf, cnt3, eob2);
          if (eob < 0) return eob;
          au[x] = lu[y] = eob ? 1 : 0;
          total_eob += eob;
          if (intra) {
            int e = push_intra_blk(1 + pl, x, y, n1, uvmode, DCT_DCT,
                                   eob ? coefbuf : nullptr, w4h);
            if (e) return e;
          } else if (eob) {
            int e = push_tu(fs, 0, n1, (px >> 1) + x * 4,
                            (py >> 1) + y * 4, coefbuf, pl);
            if (e) return e;
          }
        }
      if (uvtx > 0) {
        for (int base = 0; base < end_yc; base += uvstep)
          for (int k = base; k < std::min(base + uvstep, end_yc); k++)
            lu[k] = lu[base];
        for (int base = 0; base < end_xc; base += uvstep)
          for (int k = base; k < std::min(base + uvstep, end_xc); k++)
            au[k] = au[base];
        for (int k = end_xc; k < w4h; k++) au[k] = 0;
        for (int k = end_yc; k < h4h; k++) lu[k] = 0;
      }
    }
    if (total_eob == 0 && bs <= BS_8x8 && !intra) {
      // all-zero inter small block counts as skipped (vp9block.c:1311)
      skip = 1;
      for (int i = 0; i < w4; i++) fs.a_skip[col + i] = 1;
      for (int i = 0; i < h4; i++) fs.l_skip[row7 + i] = 1;
    }
  }

  // loop filter level + edge masks
  {
    int lvl = h.lflvl_mat[intra ? 0 : fs.refs[0] + 1]
                         [(modes[3] != ZEROMV && !intra && !is_key) ? 1
                                                                    : 0];
    for (int r = row; r < row + h4c; r++)
      for (int cc = col; cc < col + w4c; cc++)
        fs.lf_lvl[(long)r * h.cols + cc] = lvl;
    mask_edges(fs, row, col, w4, h4, tx, uvtx, bs,
               !intra && skip);
  }

  // inter MC records
  if (!intra) {
    int e = record_inter_mc(fs);
    if (e) return e;
  }
  return E_OK;
}

// ------------------------------------------------------------ decode_sb
static int decode_sb(FS &fs, int row, int col, int bl, bool is_key) {
  BoolDec &io = *fs.bd;
  const Hdr &h = fs.h;
  int ctx = ((fs.a_part[col] >> (3 - bl)) & 1) |
            (((fs.l_part[row & 7] >> (3 - bl)) & 1) << 1);
  const int32_t *p;
  if (is_key) p = fs.kf_part + (bl * 4 + ctx) * 3;
  else p = fs.p_part + (bl * 4 + ctx) * 3;
  int hbs = 4 >> bl;
  int bp, e = E_OK;
  if (bl == 3) {
    bp = io.tree(fs.t_part, p);
    e = decode_block(fs, row, col, bl, bp, is_key);
  } else if (col + hbs < h.cols) {
    if (row + hbs < h.rows) {
      bp = io.tree(fs.t_part, p);
      if (bp == P_NONE) {
        e = decode_block(fs, row, col, bl, bp, is_key);
      } else if (bp == P_H) {
        e = decode_block(fs, row, col, bl, bp, is_key);
        if (!e) e = decode_block(fs, row + hbs, col, bl, bp, is_key);
      } else if (bp == P_V) {
        e = decode_block(fs, row, col, bl, bp, is_key);
        if (!e) e = decode_block(fs, row, col + hbs, bl, bp, is_key);
      } else {
        e = decode_sb(fs, row, col, bl + 1, is_key);
        if (!e) e = decode_sb(fs, row, col + hbs, bl + 1, is_key);
        if (!e) e = decode_sb(fs, row + hbs, col, bl + 1, is_key);
        if (!e) e = decode_sb(fs, row + hbs, col + hbs, bl + 1, is_key);
      }
    } else {
      if (io.get((int)p[1])) {
        bp = P_SPLIT;
        e = decode_sb(fs, row, col, bl + 1, is_key);
        if (!e) e = decode_sb(fs, row, col + hbs, bl + 1, is_key);
      } else {
        bp = P_H;
        e = decode_block(fs, row, col, bl, P_H, is_key);
      }
    }
  } else if (row + hbs < h.rows) {
    if (io.get((int)p[2])) {
      bp = P_SPLIT;
      e = decode_sb(fs, row, col, bl + 1, is_key);
      if (!e) e = decode_sb(fs, row + hbs, col, bl + 1, is_key);
    } else {
      bp = P_V;
      e = decode_block(fs, row, col, bl, P_V, is_key);
    }
  } else {
    bp = P_SPLIT;
    e = decode_sb(fs, row, col, bl + 1, is_key);
  }
  fs.c_part[(bl * 4 + ctx) * 4 + bp]++;
  return e;
}

static void new_tile_left(FS &fs) {
  for (int i = 0; i < 8; i++) {
    fs.l_part[i] = fs.l_skip[i] = fs.l_txfm[i] = 0;
    fs.l_uvnnz0[i] = fs.l_uvnnz1[i] = 0;
    fs.l_intra[i] = fs.l_comp[i] = fs.l_ref[i] = fs.l_filter[i] = 0;
  }
  for (int i = 0; i < 16; i++) {
    fs.l_mode[i] = M_DC;
    fs.l_ynnz[i] = 0;
    fs.l_mode8[i] = fs.mode0;
    memset(fs.l_mvctx[i], 0, sizeof(fs.l_mvctx[i]));
  }
}

}  // namespace

// ------------------------------------------------------------- C ABI
extern "C" {

long vp9_parse_abi() { return 1; }

// Returns E_OK (0) or a negative error; on success the out_n slot
// holds the record counts. `data`/`size` cover the tile region (after
// the uncompressed + compressed headers).
long vp9_parse_frame(const uint8_t *data, long size,
                     const int32_t *hdr32, void **bufs) {
  FS fs;
  Hdr &h = fs.h;
  h.keyframe = hdr32[0]; h.intraonly = hdr32[1];
  h.width = hdr32[3]; h.height = hdr32[4];
  h.cols = hdr32[5]; h.rows = hdr32[6];
  h.sb_cols = hdr32[7]; h.sb_rows = hdr32[8];
  h.txfmmode = hdr32[9]; h.filtermode = hdr32[10];
  h.comppredmode = hdr32[11]; h.fixcompref = hdr32[12];
  h.varcompref[0] = hdr32[13]; h.varcompref[1] = hdr32[14];
  h.signbias[0] = hdr32[15]; h.signbias[1] = hdr32[16];
  h.signbias[2] = hdr32[17];
  h.highprec = hdr32[18]; h.use_last_mvs = hdr32[19];
  h.qmul[0][0] = hdr32[20]; h.qmul[0][1] = hdr32[21];
  h.qmul[1][0] = hdr32[22]; h.qmul[1][1] = hdr32[23];
  h.log2_tile_cols = hdr32[24]; h.log2_tile_rows = hdr32[25];
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 2; j++)
      h.lflvl_mat[i][j] = hdr32[26 + i * 2 + j];

  auto I32 = [&](int s) { return (const int32_t *)bufs[s]; };
  auto W32 = [&](int s) { return (int32_t *)bufs[s]; };
  auto W64 = [&](int s) { return (int64_t *)bufs[s]; };
  fs.t_part = I32(S_PARTITION_TREE); fs.t_imode = I32(S_INTRAMODE_TREE);
  fs.t_inter = I32(S_INTER_MODE_TREE); fs.t_filter = I32(S_FILTER_TREE);
  fs.t_mvj = I32(S_MV_JOINT_TREE); fs.t_mvc = I32(S_MV_CLASS_TREE);
  fs.t_mvfp = I32(S_MV_FP_TREE);
  fs.kf_part = I32(S_KF_PARTITION); fs.kf_ym = I32(S_KF_YMODE);
  fs.kf_uv = I32(S_KF_UVMODE); fs.bwh = I32(S_BWH);
  fs.mvoff = I32(S_MV_REF_BLK_OFF); fs.imctx = I32(S_INTER_MODE_CTX_LUT);
  fs.scans = I32(S_SCANS); fs.nbs = I32(S_NBS);
  fs.mode_conv = I32(S_MODE_CONV); fs.needs = I32(S_NEEDS);
  fs.itxtp = I32(S_INTRA_TXFM_TYPE);
  fs.p_ym = I32(S_P_YMODE); fs.p_uv = I32(S_P_UVMODE);
  fs.p_filt = I32(S_P_FILTER); fs.p_mvmode = I32(S_P_MVMODE);
  fs.p_intra = I32(S_P_INTRA); fs.p_comp = I32(S_P_COMP);
  fs.p_sref = I32(S_P_SINGLE_REF); fs.p_cref = I32(S_P_COMP_REF);
  fs.p_tx32 = I32(S_P_TX32); fs.p_tx16 = I32(S_P_TX16);
  fs.p_tx8 = I32(S_P_TX8); fs.p_skip = I32(S_P_SKIP);
  fs.p_mvj = I32(S_P_MVJOINT); fs.p_mvc = I32(S_P_MVCOMP);
  fs.p_part = I32(S_P_PARTITION); fs.p_coef = I32(S_P_COEF);
  fs.prev_mv_ref = I32(S_PREV_MV_REF); fs.prev_mv_xy = I32(S_PREV_MV_XY);
  fs.mv_ref = W32(S_MV_REF); fs.mv_xy = W32(S_MV_XY);
  fs.lf_lvl = W32(S_LF_LVL);
  fs.wd_v = W32(S_WD_V); fs.wd_h = W32(S_WD_H);
  fs.wd_v_uv = W32(S_WD_V_UV); fs.wd_h_uv = W32(S_WD_H_UV);
  fs.c_eob = W64(S_C_EOB); fs.c_coef = W64(S_C_COEF);
  fs.c_skip = W64(S_C_SKIP); fs.c_intra = W64(S_C_INTRA);
  fs.c_comp = W64(S_C_COMP); fs.c_cref = W64(S_C_COMP_REF);
  fs.c_sref = W64(S_C_SINGLE_REF); fs.c_part = W64(S_C_PARTITION);
  fs.c_tx32 = W64(S_C_TX32); fs.c_tx16 = W64(S_C_TX16);
  fs.c_tx8 = W64(S_C_TX8); fs.c_filt = W64(S_C_FILTER);
  fs.c_mvmode = W64(S_C_MVMODE); fs.c_mvj = W64(S_C_MVJOINT);
  fs.c_ym = W64(S_C_YMODE); fs.c_uv = W64(S_C_UVMODE);
  fs.c_sign = W64(S_C_MVC_SIGN); fs.c_cls = W64(S_C_MVC_CLASSES);
  fs.c_c0 = W64(S_C_MVC_CLASS0); fs.c_bits = W64(S_C_MVC_BITS);
  fs.c_c0fp = W64(S_C_MVC_C0FP); fs.c_fp = W64(S_C_MVC_FP);
  fs.c_c0hp = W64(S_C_MVC_C0HP); fs.c_hp = W64(S_C_MVC_HP);
  fs.caps = (const int64_t *)bufs[S_CAPS];
  fs.out_n = W64(S_OUT_N);
  for (int i = 0; i < 4; i++) fs.mc[i] = W32(S_MC0 + i);
  for (int i = 0; i < 8; i++) {
    fs.tu_meta[i] = W32(S_TU_META0 + i);
    fs.tu_coef[i] = W32(S_TU_COEF0 + i);
    fs.in_meta[i] = W32(S_IN_META0 + i);
    fs.in_coef[i] = W32(S_IN_COEF0 + i);
  }

  h.mi_stride = h.sb_cols * 8;
  bool is_key = h.keyframe || h.intraonly;
  fs.mode0 = is_key ? (int)M_DC : (int)NEARESTMV;
  fs.wp = h.sb_cols * 64;
  fs.hp = h.sb_rows * 64;
  fs.c4 = h.sb_cols * 16;
  int cc = h.sb_cols * 8;
  fs.a_part.assign(cc, 0); fs.a_skip.assign(cc, 0);
  fs.a_txfm.assign(cc, 0); fs.a_mode.assign(2 * cc, M_DC);
  fs.a_ynnz.assign(2 * cc, 0);
  fs.a_uvnnz0.assign(cc, 0); fs.a_uvnnz1.assign(cc, 0);
  fs.a_intra.assign(cc, 0); fs.a_comp.assign(cc, 0);
  fs.a_ref.assign(cc, 0); fs.a_filter.assign(cc, 0);
  fs.a_mode8.assign(cc, fs.mode0);
  fs.a_mvctx.assign(2 * cc * 4, 0);
  fs.lvlw[0] = fs.wp / 4; fs.lvlh[0] = fs.hp / 4;
  fs.lvlw[1] = fs.lvlw[2] = fs.wp / 8;
  fs.lvlh[1] = fs.lvlh[2] = fs.hp / 8;
  for (int i = 0; i < 3; i++)
    fs.lvl[i].assign((size_t)fs.lvlw[i] * fs.lvlh[i], 0);

  // tile loop (vp9/__init__.py decode path)
  int n_tc = 1 << h.log2_tile_cols;
  int n_tr = 1 << h.log2_tile_rows;
  long pos = 0;
  std::vector<BoolDec> decs(n_tc);
  std::vector<int> tcs0(n_tc), tcs1(n_tc);
  auto tile_b = [&](int idx, int l2n, int sbs) {
    int s = std::min((idx * sbs) >> l2n, sbs) << 3;
    return s;
  };
  for (int tr = 0; tr < n_tr; tr++) {
    int r0 = tile_b(tr, h.log2_tile_rows, h.sb_rows);
    int r1 = tile_b(tr + 1, h.log2_tile_rows, h.sb_rows);
    for (int tc = 0; tc < n_tc; tc++) {
      long tsize;
      if (tr == n_tr - 1 && tc == n_tc - 1) {
        tsize = size - pos;
      } else {
        if (pos + 4 > size) return E_TRUNC_TILE;
        tsize = ((long)data[pos] << 24) | ((long)data[pos + 1] << 16) |
                ((long)data[pos + 2] << 8) | data[pos + 3];
        pos += 4;
      }
      if (tsize < 0 || pos + tsize > size) return E_TRUNC_TILE;
      decs[tc].init(data + pos, tsize);
      if (decs[tc].get(128)) return E_TILE_MARKER;
      pos += tsize;
      tcs0[tc] = tile_b(tc, h.log2_tile_cols, h.sb_cols);
      tcs1[tc] = tile_b(tc + 1, h.log2_tile_cols, h.sb_cols);
    }
    for (int row = r0; row < std::min(r1, h.rows); row += 8) {
      for (int tc = 0; tc < n_tc; tc++) {
        new_tile_left(fs);
        fs.bd = &decs[tc];
        fs.tile_col_start = tcs0[tc];
        for (int col = tcs0[tc]; col < std::min(tcs1[tc], h.cols);
             col += 8) {
          int e = decode_sb(fs, row, col, 0, is_key);
          if (e) return e;
        }
      }
    }
  }
  for (int i = 0; i < 4; i++) fs.out_n[i] = fs.mc_n[i];
  for (int i = 0; i < 8; i++) fs.out_n[4 + i] = fs.tu_n[i];
  for (int i = 0; i < 8; i++) fs.out_n[12 + i] = fs.in_n[i];
  fs.out_n[20] = fs.max_level;
  return E_OK;
}

}  // extern "C"
