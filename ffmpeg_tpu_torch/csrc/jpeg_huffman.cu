// K1: segment-parallel baseline JPEG Huffman decode, written by hand for
// Hopper (sm_90a).
//
// Replaces: ffmpeg_tpu/ops/huffman.py jpeg_scan_decode9_pl (the Pallas
// kernel body _make_pl_kernel.kernel), as called from
// ffmpeg_tpu/models/mjpeg_tpu_entropy.py run().  Same contract as the plain
// version ffmpeg_tpu_torch/ops/huffman.py decode_packed_plain: one lane per
// restart segment, each segment one 4:2:0 MCU of 6 blocks (Y0-Y3 Cb Cr),
// DC predictors reset at the segment start, run/size/EOB/ZRL as in
// ITU T.81 F.2.2, zigzag coefficients out as int16 (values wrap); a
// segment starts at its byte offset clamped to [0, cap], bytes at or past
// `cap` read as 0, and a lane stops after max_iter symbols.
//
// What bounds it on this card: a batch of 8 1080p frames writes 8 x 8160
// lanes x 768 bytes = 50.1 MB of coefficients (~0.015 ms at 3.35 TB/s)
// and reads ~1 MB of entropy-coded bytes.  So its bound is bytes, and
// almost all of them are stores.  Inside that, each lane's bit walk is a
// serial chain of up to a few hundred symbols; with one lane per segment
// the batch is a single wave of ~15 warps per SM, so the chain's latency
// per symbol sets the walk's time.
//
// The design, step by step against what bounds it:
// - the lanes' start offsets are an in-CTA scan of the lengths, so the
//   entry point launches this kernel and nothing else;
// - each CTA ranks its 128 lanes by segment length and thread r decodes
//   the lane of rank r: a warp is as slow as its longest lane, and
//   lanes of like length in one warp waste fewer steps;
// - stages each CTA's input in shared memory: the CTA's 128 consecutive
//   segments are packed tightly, so their bytes are one contiguous span
//   from the first lane's start; the CTA copies kStageBytes from there
//   (16-byte loads when the rows allow, zeros past `cap`) as big-endian
//   32-bit words; each lane's 64-bit bit buffer takes a whole word when
//   it falls to 32 bits, with that word loaded one refill ahead, so no
//   load sits on the symbol chain.  A lane that reads past the staged
//   span (a corrupt or oversized segment) takes its words from device
//   memory, so any bytes decode exactly as the plain version decodes
//   them;
// - keeps each lane's non-zero coefficients as a list in shared memory
//   (position | value << 16, up to kListCap of them; a typical segment
//   has ~20), and writes the output only when the warp's 32 lanes have
//   all finished: row by row, the warp scatters the row's list into a
//   768-byte shared row and streams it out with consecutive 16-byte
//   stores, so every output byte is written once, whole and coalesced.
//   Rows cleared early and filled by 2-byte stores later would leave the
//   L2 cache in between, and each late store would become a partial
//   write to memory.  A lane whose list overflows clears its own row and
//   stores its coefficients directly, and the warp skips that row;
// - keeps the frame's Huffman tables in shared memory as 4 x 512 packed
//   uint16 entries (len | run << 4 | size << 8), one 9-bit peek and one
//   shared load per symbol.
// What the TPU kernel needed and this one drops: the one-hot MXU table
// lookup, the 12-word bit refill, the 1024-lane blocks and the sort of
// all of a batch's lanes by length outside the kernel (here each CTA
// ranks its own 128).
//
// The device code is in plain __device__ functions, one per phase, so that
// the phases can be driven one thread at a time elsewhere.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlocksPerSeg = 6;
constexpr int kCoefs = kBlocksPerSeg * 64;
constexpr int kLutRows = 512;        // 9-bit peek
constexpr int kLutCols = 12;         // [len, run, size] x 4 tables
constexpr int kLutBytes = kLutRows * kLutCols;
constexpr int kThreads = 128;        // segments per CTA
constexpr int kStageBytes = 8192;    // staged span (typ. ~2 KB is used)
constexpr int kStageWords = kStageBytes / 4;
constexpr int kListCap = 48;         // listed coefficients per lane
constexpr int kRow16 = kCoefs * 2 / 16;   // 16-byte chunks per output row

struct Shared {
    union {
        uint32_t stage[kStageWords];      // big-endian words of the span,
        uint32_t scan[2][2][kThreads];    // after the offset scan
    };
    int start[kThreads];             // each lane's first byte in the region
    alignas(16) int key[kThreads];   // each lane's length; -1 past nmcu
    int16_t slot_lane[kThreads];     // the lane each thread decodes
    union {
        int4 lut_raw[kLutBytes / 16];     // the frame's (512, 12) table,
        int4 row[kThreads / 32][kRow16];  // then one output row per warp
    };
    uint16_t lut[4][kLutRows];       // packed len | run << 4 | size << 8
    uint32_t list[kListCap][kThreads];    // position | value << 16
    int16_t count[kThreads];         // listed coefficients; -1: direct
};

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
    return __byte_perm(x, 0, 0x0123);
}

// Byte `pos` of a region, 0 outside [0, cap).
__device__ __forceinline__ uint32_t region_byte(const uint8_t* region,
                                                int cap, long long pos) {
    return (pos >= 0 && pos < cap) ? region[pos] : 0u;
}

// Phase 1, thread t of the CTA: copy the span's bytes [base, base +
// kStageBytes) into sh.stage as big-endian words, and the frame's table
// into sh.lut_raw.  `base` is a multiple of 16; `vec` says the region's
// rows allow 16-byte loads.
__device__ __forceinline__ void stage_inputs(Shared& sh, int t, int nthreads,
                                             const uint8_t* region, int cap,
                                             int base, bool vec,
                                             const int8_t* flut) {
    for (int i = t; i < kStageBytes / 16; i += nthreads) {
        const int pos = base + 16 * i;
        uint32_t w[4];
        if (vec && pos + 16 <= cap) {
            const int4 v = *reinterpret_cast<const int4*>(region + pos);
            w[0] = bswap32((uint32_t)v.x);
            w[1] = bswap32((uint32_t)v.y);
            w[2] = bswap32((uint32_t)v.z);
            w[3] = bswap32((uint32_t)v.w);
        } else {
            for (int k = 0; k < 4; ++k) {
                uint32_t x = 0;
                for (int j = 0; j < 4; ++j)
                    x = (x << 8) | region_byte(region, cap,
                                               (long long)pos + 4 * k + j);
                w[k] = x;
            }
        }
        for (int k = 0; k < 4; ++k)
            sh.stage[4 * i + k] = w[k];
    }
    const bool lut_vec = (reinterpret_cast<uintptr_t>(flut) & 15) == 0;
    for (int i = t; i < kLutBytes / 16; i += nthreads) {
        if (lut_vec) {
            sh.lut_raw[i] = reinterpret_cast<const int4*>(flut)[i];
        } else {
            int8_t* d = reinterpret_cast<int8_t*>(&sh.lut_raw[i]);
            for (int j = 0; j < 16; ++j)
                d[j] = flut[16 * i + j];
        }
    }
}

// Phase 2, thread t: pack the raw table into sh.lut.
__device__ __forceinline__ void pack_lut(Shared& sh, int t, int nthreads) {
    const int8_t* raw = reinterpret_cast<const int8_t*>(sh.lut_raw);
    for (int i = t; i < kLutRows * 4; i += nthreads) {
        const int row = i >> 2;
        const int tab = i & 3;
        const int8_t* e = raw + row * kLutCols + 3 * tab;
        sh.lut[tab][row] = (uint16_t)((e[0] & 15) | ((e[1] & 15) << 4)
                                      | ((e[2] & 15) << 8));
    }
}

// MSB-first bit reader over the span (bit 0 = byte `base`): a 64-bit
// buffer that takes a whole 32-bit word when it falls to 32 bits, the
// next word loaded one refill ahead, so no load sits on the symbol
// chain.  Words of the staged span come from shared memory, any other
// word from device memory (bytes outside [0, cap) read as 0).
struct SpanReader {
    const uint32_t* stage;
    const uint8_t* region;
    int cap;
    int base;
    uint64_t buf;       // left-aligned
    int nbits;          // valid bits in buf
    int wnext;          // index of the word in `ahead`
    uint32_t ahead;

    __device__ __forceinline__ uint32_t word(int i) const {
        if (i >= 0 && i < kStageWords)
            return stage[i];
        const long long pos = (long long)base + 4ll * i;
        uint32_t x = 0;
        for (int j = 0; j < 4; ++j)
            x = (x << 8) | region_byte(region, cap, pos + j);
        return x;
    }

    __device__ __forceinline__ void init(int bit) {
        const int w = bit >> 5;             // floor, also for bit < 0
        const int sh = bit & 31;
        buf = (((uint64_t)word(w) << 32) | word(w + 1)) << sh;
        nbits = 64 - sh;
        wnext = w + 2;
        ahead = word(wnext);
    }

    // At least 33 valid bits after: a symbol takes at most 15 + 15.
    // Without a branch: the lanes of a warp refill at different symbols.
    __device__ __forceinline__ void refill() {
        const bool need = nbits <= 32;
        buf |= need ? (uint64_t)ahead << ((32 - nbits) & 63) : 0ull;
        nbits += need ? 32 : 0;
        wnext += need;
        ahead = word(wnext);
    }

    __device__ __forceinline__ uint32_t peek32() const {
        return (uint32_t)(buf >> 32);
    }

    __device__ __forceinline__ void skip(int n) {
        buf <<= n;
        nbits -= n;
    }
};

// A lane's coefficient store: into its list while the list has room;
// on overflow the lane clears its own row of `out`, moves the list there
// and stores the rest directly.
struct Emitter {
    uint32_t* list;     // &sh.list[0][t], stride kThreads
    int16_t* row;       // the lane's row of `out`
    int n = 0;

    // Lists coefficient `coef` at `pos` when `keep`; no branch unless the
    // list is full.
    __device__ __forceinline__ void put(bool keep, int pos, int coef) {
        if (keep && n < kListCap)
            list[n * kThreads] =
                (uint32_t)pos | ((uint32_t)(uint16_t)coef << 16);
        if (keep && n >= kListCap) {
            if (n == kListCap) {
                int4* r4 = reinterpret_cast<int4*>(row);
                for (int i = 0; i < kRow16; ++i)
                    r4[i] = make_int4(0, 0, 0, 0);
                for (int i = 0; i < kListCap; ++i) {
                    const uint32_t e = list[i * kThreads];
                    row[e & 0xFFFF] = (int16_t)(e >> 16);
                }
            }
            row[pos] = (int16_t)coef;                 // wraps as int16
        }
        n += keep;
    }
};

// Phase 3, one lane: decode the segment that starts at bit `bit` of the
// span, 6 blocks of 64 zigzag coefficients, into `em`.
__device__ __forceinline__ void decode_lane(const Shared& sh,
                                            const uint8_t* region, int cap,
                                            int base, int bit, int nblk,
                                            Emitter& em, int max_iter) {
    SpanReader br{sh.stage, region, cap, base};
    br.init(bit);
    int blk = 0;        // block within the MCU
    int k = -1;         // next zigzag position; -1 = DC next
    int p0 = 0, p1 = 0, p2 = 0;
    for (int it = 0; it < max_iter && blk < nblk; ++it) {
        br.refill();
        const uint32_t win = br.peek32();
        const int comp = (blk >= 4) + (blk >= 5);
        const bool is_dc = k < 0;
        const int sel = (is_dc ? 0 : 2) + (comp > 0);
        const uint32_t e = sh.lut[sel][win >> 23];
        const int ln = e & 15;
        const int run = (e >> 4) & 15;
        const int sz = (e >> 8) & 15;
        // the sz magnitude bits after the code; ln + sz <= 30, all inside
        // the 33 valid bits; sz = 0 shifts all 32 bits out
        const uint32_t mag =
            (uint32_t)((uint64_t)(win << ln) >> (32 - sz));
        const uint32_t half = (1u << sz) >> 1;
        const int val = (int)mag - (mag < half ? (int)(2 * half - 1) : 0);
        br.skip(ln + sz);
        const int predc = comp == 0 ? p0 : (comp == 1 ? p1 : p2);
        const int coef = is_dc ? predc + val : val;
        const int pos = is_dc ? 0 : k + run;
        p0 = is_dc && comp == 0 ? coef : p0;
        p1 = is_dc && comp == 1 ? coef : p1;
        p2 = is_dc && comp == 2 ? coef : p2;
        // positions only grow within a segment, so no position repeats
        em.put((is_dc || sz > 0) && pos < 64 && coef != 0, blk * 64 + pos,
               coef);
        const bool eob = !is_dc && sz == 0 && run == 0;
        const bool zrl = !is_dc && sz == 0 && run == 15;
        const int k_new = is_dc ? 1 : (zrl ? k + 16 : pos + 1);
        const bool done = !is_dc && (eob || k_new >= 64);
        blk += done;
        k = done ? -1 : k_new;
    }
}

// Phase 4, lane `l` of warp `w`, row `r` of the warp (the row of the
// lane that thread 32w + r decoded), in three steps with __syncwarp()
// between them: 0 clears the warp's shared row, 1 scatters the row's list
// into it, 2 stores it to `out_row` with consecutive 16-byte stores.  A
// row whose lane stored directly (count -1) is skipped.
__device__ __forceinline__ void write_row(Shared& sh, int w, int l, int r,
                                          int step, int16_t* out_row) {
    const int t = 32 * w + r;
    const int n = sh.count[t];
    if (n < 0)
        return;
    if (step == 0) {
        for (int c = l; c < kRow16; c += 32)
            sh.row[w][c] = make_int4(0, 0, 0, 0);
    } else if (step == 1) {
        int16_t* row = reinterpret_cast<int16_t*>(sh.row[w]);
        for (int i = l; i < n; i += 32) {
            const uint32_t e = sh.list[i][t];
            row[e & 0xFFFF] = (int16_t)(e >> 16);
        }
    } else {
        int4* o = reinterpret_cast<int4*>(out_row);
        for (int c = l; c < kRow16; c += 32)
            o[c] = sh.row[w][c];
    }
}

// Phase 0a, thread t: the sum of the frame's segment lengths before the
// CTA's first lane, in kThreads parts, and lane t's own length (0 past
// nmcu), into sh.scan[0].  Unsigned: the sums wrap as int32 sums do.
__device__ __forceinline__ void offset_parts(Shared& sh, int t,
                                             const int32_t* flens,
                                             int lane0, int nmcu) {
    uint32_t part = 0;
#pragma unroll 8
    for (int i = t; i < lane0; i += kThreads)
        part += (uint32_t)flens[i];
    sh.scan[0][0][t] = part;
    sh.scan[0][1][t] = lane0 + t < nmcu ? (uint32_t)flens[lane0 + t] : 0u;
}

// Phase 0b, step `d` (1, 2, 4, ..., kThreads/2) of an inclusive scan of
// both rows of sh.scan, from buffer `src` into the other (Hillis-Steele).
__device__ __forceinline__ void offset_scan_step(Shared& sh, int t, int d,
                                                 int src) {
    for (int row = 0; row < 2; ++row) {
        const uint32_t* x = sh.scan[src][row];
        sh.scan[1 - src][row][t] = x[t] + (t >= d ? x[t - d] : 0u);
    }
}

// Phase 0c, thread t: lane t's first byte, clamped to [0, cap] as the
// plain version clamps it, and its length as its sort key (-1 past nmcu).
__device__ __forceinline__ void start_and_key(Shared& sh, int t, int src,
                                              int hdr, int cap, int lane0,
                                              int nmcu) {
    const uint32_t before = sh.scan[src][0][kThreads - 1];
    const uint32_t* incl = sh.scan[src][1];
    const uint32_t own = incl[t] - (t ? incl[t - 1] : 0u);
    const int s = (int)(before + incl[t] - own) + hdr;
    sh.start[t] = min(max(s, 0), cap);
    sh.key[t] = lane0 + t < nmcu ? (int)own : -1;
}

// Phase 0d, thread t: lane t's rank by length among the CTA's lanes, ties
// in lane order; thread `rank` will decode lane t, so each warp decodes
// segments of like length.
__device__ __forceinline__ void rank_lane(Shared& sh, int t) {
    const int key = sh.key[t];
    int rank = 0;
    const int4* k4 = reinterpret_cast<const int4*>(sh.key);
#pragma unroll 8
    for (int j = 0; j < kThreads / 4; ++j) {
        const int4 v = k4[j];
        rank += (v.x < key || (v.x == key && 4 * j < t))
              + (v.y < key || (v.y == key && 4 * j + 1 < t))
              + (v.z < key || (v.z == key && 4 * j + 2 < t))
              + (v.w < key || (v.w == key && 4 * j + 3 < t));
    }
    sh.slot_lane[rank] = (int16_t)t;
}

__global__ void __launch_bounds__(kThreads)
jpeg_scan_decode_packed_kernel(const uint8_t* __restrict__ regions, int cap,
                               const int32_t* __restrict__ lens, int hdr,
                               const int8_t* __restrict__ luts,
                               long long lut_stride,
                               int16_t* __restrict__ out, int nmcu,
                               int max_iter) {
    __shared__ Shared sh;
    const int b = blockIdx.y;
    const int t = threadIdx.x;
    const int lane0 = blockIdx.x * kThreads;
    const size_t fr = (size_t)b * nmcu;
    const uint8_t* region = regions + (size_t)b * cap;
    offset_parts(sh, t, lens + fr, lane0, nmcu);
    __syncthreads();
    int src = 0;
    for (int d = 1; d < kThreads; d *= 2, src = 1 - src) {
        offset_scan_step(sh, t, d, src);
        __syncthreads();
    }
    start_and_key(sh, t, src, hdr, cap, lane0, nmcu);
    __syncthreads();
    rank_lane(sh, t);
    __syncthreads();
    const int base = sh.start[0] & ~15;
    const bool vec = (cap & 15) == 0
        && (reinterpret_cast<uintptr_t>(regions) & 15) == 0;
    stage_inputs(sh, t, kThreads, region, cap, base, vec,
                 luts + b * lut_stride);
    __syncthreads();
    pack_lut(sh, t, kThreads);
    __syncthreads();
    const int q = sh.slot_lane[t];          // the CTA's lane this decodes
    const int lane = lane0 + q;
    const size_t li = fr + min(lane, nmcu - 1);
    Emitter em{&sh.list[0][t], out + li * kCoefs};
    if (lane < nmcu)
        decode_lane(sh, region, cap, base, (sh.start[q] - base) * 8,
                    lens[li] > 0 ? kBlocksPerSeg : 0, em, max_iter);
    sh.count[t] = lane < nmcu && em.n <= kListCap ? em.n : -1;
    __syncwarp();
    const int w = t >> 5;
    for (int r = 0; r < 32; ++r) {
        const size_t row = fr + lane0 + sh.slot_lane[32 * w + r];
        for (int step = 0; step < 3; ++step) {
            write_row(sh, w, t & 31, r, step, out + row * kCoefs);
            __syncwarp();
        }
    }
}

// ---- the camera format: segments of several MCUs, any baseline table ----
//
// Streams as IP cameras send them (RFC 2435 type 64: 4:2:2, the Annex K
// tables, a restart marker every MCU row) put a few hundred segments in a
// 1080p frame, each a row of 120 MCUs and ~3 KB of scan, where the
// flagship's format has 8160 of under 200 B.  Same contract as the plain
// version ffmpeg_tpu_torch/ops/huffman.py decode_packed_plain on such
// regions: one lane per segment of `mcus_per_seg` MCUs of `bpm` blocks
// (Y0 Y1 Cb Cr or Y0-Y3 Cb Cr), the last segment cut at `nmcu` MCUs, DC
// predictors reset at each segment's start, a segment of length 0
// decoding nothing, bytes at or past `cap` reading as 0, a lane stopping
// after max_iter symbols, zigzag int16 coefficients out.  It replaces no
// TPU kernel: the reference decodes such streams with its general-length
// XLA loop (ffmpeg_tpu/ops/huffman.py jpeg_scan_decode) or on the host.
//
// What bounds it on this card: a batch of 64 such frames writes 64 x
// 64800 blocks x 128 B = 531 MB of coefficients (~0.16 ms at 3.35 TB/s)
// and reads ~23 MB of scan.  But with one thread a segment the batch has
// ~8 640 lanes, ~2 warps an SM, and each lane walks ~4 500 symbols (the
// longest ~6 000) in a serial chain that no other warp hides: the
// instructions of a symbol, each waiting on the last, times the longest
// segment's symbols, set the time, ~12x the bytes' bound (PERF.md).
//
// The design, the simplest mapping that keeps a frame's segments in
// parallel, one thread a segment, with as few instructions a symbol as
// it could keep:
// - each thread sums the lengths before its segment itself (a few hundred
//   loads, against thousands of symbols);
// - the frame's tables are staged in shared memory: a 9-bit first level
//   (len | run << 4 | size << 8, one load a symbol) and, for the longer
//   codes (10-16 bits, ~1% of an Annex K stream's symbols), ITU T.81
//   F.2.2.3's MAXCODE/VALPTR over lengths 10-16, all seven compared at
//   once rather than searched in turn;
// - each thread reads its segment from device memory in 16-byte words,
//   the next one loaded as the current one is taken, ~20 symbols ahead of
//   use, through the read-only cache; the refill takes no branch;
// - the warp first clears its 32 segments' output together, 512
//   coalesced bytes a store, and each thread then stores each non-zero
//   coefficient as it decodes it, with nothing more on the chain.
//   Building each block in shared memory and storing it whole took ~1.5x
//   as long, and clearing each block as its thread starts it ~1.25x (a
//   load and stores more a block, or eight stores, on the chain).

constexpr int kSegThreads = 32;      // segments per CTA
constexpr int kTab16Bytes = 1344;    // one table of build_jpeg_tables16
constexpr int kLongLens = 8;         // MAXCODE, VALPTR - MINCODE: 9 + i

struct SegShared {
    uint16_t l1[4][kLutRows];        // len | run << 4 | size << 8
    int maxcode[4][kLongLens];
    int delta[4][kLongLens];
    uint8_t val[4][256];
};

// MSB-first bit reader over one region row, read as 16-byte words from
// device memory (words at or past the row's end read as 0): a 64-bit
// buffer that takes a 32-bit word when it falls to 32 bits, from the
// current 16-byte word, with the next one loaded as soon as the current
// one is used up.
struct RowReader {
    const uint4* row;
    int nvec;           // 16-byte words in the row
    uint4 cur, nxt;
    int vi;             // index of `cur`
    int wi;             // next 32-bit word of `cur`
    uint64_t buf;       // left-aligned
    int nbits;

    __device__ __forceinline__ uint4 load(int v) const {
        return v < nvec ? __ldg(row + v) : make_uint4(0, 0, 0, 0);
    }

    __device__ __forceinline__ uint32_t take() {
        const uint32_t w = wi == 0 ? cur.x : wi == 1 ? cur.y
                         : wi == 2 ? cur.z : cur.w;
        if (++wi == 4) {
            cur = nxt;
            nxt = load(++vi + 1);
            wi = 0;
        }
        return bswap32(w);
    }

    __device__ __forceinline__ void init(int byte) {
        vi = byte >> 4;
        cur = load(vi);
        nxt = load(vi + 1);
        wi = (byte >> 2) & 3;
        const int sh = (byte & 3) * 8;
        const uint64_t hi = take();
        buf = ((hi << 32) | take()) << sh;
        nbits = 64 - sh;
    }

    // At least 33 valid bits after: a symbol takes at most 16 + 15.
    // Without a branch but to load the next 16 bytes.
    __device__ __forceinline__ void refill() {
        const bool need = nbits <= 32;
        const uint32_t w = wi == 0 ? cur.x : wi == 1 ? cur.y
                         : wi == 2 ? cur.z : cur.w;
        buf |= need ? (uint64_t)bswap32(w) << ((32 - nbits) & 63) : 0ull;
        nbits += need ? 32 : 0;
        wi += need;
        if (wi == 4) {
            cur = nxt;
            nxt = load(++vi + 1);
            wi = 0;
        }
    }

    __device__ __forceinline__ uint32_t peek32() const {
        return (uint32_t)(buf >> 32);
    }

    __device__ __forceinline__ void skip(int n) {
        buf <<= n;
        nbits -= n;
    }
};

// Thread t: the frame's four tables (build_jpeg_tables16) into shared
// memory; `tab` starts on 4 bytes.
__device__ __forceinline__ void stage_tables16(SegShared& sh, int t,
                                               const uint8_t* tab) {
    for (int i = t; i < 4 * kLutRows; i += kSegThreads) {
        const int k = i / kLutRows, r = i % kLutRows;
        sh.l1[k][r] = *reinterpret_cast<const uint16_t*>(
            tab + k * kTab16Bytes + 2 * r);
    }
    for (int i = t; i < 4 * kLongLens; i += kSegThreads) {
        const int k = i / kLongLens, r = i % kLongLens;
        const int* w = reinterpret_cast<const int*>(
            tab + k * kTab16Bytes + 2 * kLutRows);
        sh.maxcode[k][r] = w[r];
        sh.delta[k][r] = w[kLongLens + r];
    }
    for (int i = t; i < 4 * 256; i += kSegThreads)
        sh.val[i / 256][i % 256] =
            tab[(i / 256) * kTab16Bytes + 2 * kLutRows + 64 + i % 256];
}

// Lane l of the CTA's warp: with the others, clear the output of the
// CTA's segments [s0, s0 + kSegThreads), 16 bytes a lane a store.
__device__ __forceinline__ void clear_segments(int l, int16_t* out, int nseg,
                                               int s0, int nmcu,
                                               int mcus_per_seg, int bpm) {
    const int n = min(kSegThreads, nseg - s0);
    for (int r = 0; r < n; ++r) {
        const int m0 = (s0 + r) * mcus_per_seg;
        int4* d = reinterpret_cast<int4*>(out + (size_t)m0 * bpm * 64);
        const int n16 = min(mcus_per_seg, nmcu - m0) * bpm * 8;
        for (int c = l; c < n16; c += kSegThreads)
            d[c] = make_int4(0, 0, 0, 0);
    }
}

// One lane: decode `dec` blocks of the segment at byte `start` of the
// row into `dst`, cleared before, storing the non-zero coefficients.
__device__ __forceinline__ void decode_segment(const SegShared& sh,
                                               RowReader& br, int start,
                                               int dec, int bpm,
                                               int16_t* dst, int max_iter) {
    br.init(start);
    int blk = 0;        // block within the segment
    int bm = 0;         // block within its MCU
    int k = -1;         // next zigzag position; -1 = DC next
    int p0 = 0, p1 = 0, p2 = 0;
    for (int it = 0; it < max_iter && blk < dec; ++it) {
        br.refill();
        const uint32_t win = br.peek32();
        const int comp = (bm >= bpm - 2) + (bm >= bpm - 1);
        const bool is_dc = k < 0;
        const int sel = (is_dc ? 0 : 2) + (comp > 0);
        const uint32_t e = sh.l1[sel][win >> 23];
        int ln = e & 15;
        int run = (e >> 4) & 15;
        int sz = (e >> 8) & 15;
        if (ln == 0) {  // longer than 9 bits, or no code: the shortest
            int fl = 0, fi = 0;           // length whose MAXCODE holds it
#pragma unroll
            for (int l = 16; l >= 10; --l) {
                const int code = (int)(win >> (32 - l));
                const bool hit = code <= sh.maxcode[sel][l - 9];
                fl = hit ? l : fl;
                fi = hit ? code + sh.delta[sel][l - 9] : fi;
            }
            if (fl) {
                const int v = sh.val[sel][fi & 255];
                ln = fl;
                run = v >> 4;
                sz = v & 15;
            }
        }
        // ln + sz <= 31, all inside the 33 valid bits; sz = 0 shifts all
        // 32 bits out
        const uint32_t mag =
            (uint32_t)((uint64_t)(win << ln) >> (32 - sz));
        const uint32_t half = (1u << sz) >> 1;
        const int val = (int)mag - (mag < half ? (int)(2 * half - 1) : 0);
        br.skip(ln + sz);
        const int predc = comp == 0 ? p0 : (comp == 1 ? p1 : p2);
        const int coef = is_dc ? predc + val : val;
        const int pos = is_dc ? 0 : k + run;
        p0 = is_dc && comp == 0 ? coef : p0;
        p1 = is_dc && comp == 1 ? coef : p1;
        p2 = is_dc && comp == 2 ? coef : p2;
        // positions only grow within a block: each is stored once
        if ((is_dc || sz > 0) && pos < 64 && coef != 0)
            dst[(size_t)blk * 64 + pos] = (int16_t)coef; // wraps as int16
        const bool eob = !is_dc && sz == 0 && run == 0;
        const bool zrl = !is_dc && sz == 0 && run == 15;
        const int k_new = is_dc ? 1 : (zrl ? k + 16 : pos + 1);
        const bool done = !is_dc && (eob || k_new >= 64);
        if (done) {
            ++blk;
            bm = bm + 1 == bpm ? 0 : bm + 1;
        }
        k = done ? -1 : k_new;
    }
}

__global__ void __launch_bounds__(kSegThreads)
jpeg_scan_decode_packed_rows_kernel(const uint8_t* __restrict__ regions,
                                    int cap,
                                    const int32_t* __restrict__ lens,
                                    long long lens_stride, int nseg,
                                    int hdr,
                                    const uint8_t* __restrict__ tables,
                                    long long table_stride,
                                    int16_t* __restrict__ out, int nmcu,
                                    int mcus_per_seg, int bpm,
                                    int max_iter) {
    __shared__ SegShared sh;
    const int b = blockIdx.y;
    const int t = threadIdx.x;
    const int s = blockIdx.x * kSegThreads + t;
    stage_tables16(sh, t, tables + b * table_stride);
    int16_t* fout = out + (size_t)b * nmcu * bpm * 64;
    clear_segments(t, fout, nseg, blockIdx.x * kSegThreads, nmcu,
                   mcus_per_seg, bpm);
    __syncthreads();       // the tables staged, the lanes' zeros ordered
    if (s >= nseg)
        return;
    const int32_t* flens = lens + b * lens_stride;
    unsigned before = 0;                // wraps as the int32 cumsum does
    for (int i = 0; i < s; ++i)
        before += (unsigned)flens[i];
    const int start = min(max((int)before + hdr, 0), cap);
    const int m0 = s * mcus_per_seg;
    const int nblk = min(mcus_per_seg, nmcu - m0) * bpm;
    RowReader br{reinterpret_cast<const uint4*>(regions + (size_t)b * cap),
                 cap / 16};
    decode_segment(sh, br, start, flens[s] > 0 ? nblk : 0, bpm,
                   fout + (size_t)m0 * bpm * 64, max_iter);
}

}  // namespace

extern "C" {

// regions (B, cap) u8; lens (B, nmcu) i32, contiguous; the segments are
// packed tightly from byte hdr of each region; luts: B tables of (512, 12)
// i8 with entries in [0, 15], each contiguous, table b at luts + b *
// lut_stride; out (B, nmcu, 6, 64) i16, 16-byte aligned.  Launches on
// `stream`, does not synchronise; returns cudaGetLastError().
int jpeg_scan_decode_packed_launch(const void* regions, int cap,
                                   const void* lens, int hdr,
                                   const void* luts, long long lut_stride,
                                   void* out, int B, int nmcu, int max_iter,
                                   void* stream) {
    const dim3 grid((nmcu + kThreads - 1) / kThreads, B);
    jpeg_scan_decode_packed_kernel<<<grid, kThreads, 0,
                                     (cudaStream_t)stream>>>(
        (const uint8_t*)regions, cap, (const int32_t*)lens, hdr,
        (const int8_t*)luts, lut_stride, (int16_t*)out, nmcu, max_iter);
    return (int)cudaGetLastError();
}

// The camera format: regions (B, cap) u8, rows on 16 bytes, cap a
// multiple of 16; lens (B, nseg) i32, row b at lens + b * lens_stride
// (int32s: the lengths at the head of each region, read in place); the
// segments packed tightly from byte hdr of each region; tables: B of
// build_jpeg_tables16 (5376 B each, on 4 bytes), table b at tables + b *
// table_stride; out (B, nmcu, bpm, 64) i16, 16-byte aligned.  Launches
// on `stream`, does not synchronise; returns cudaGetLastError().
int jpeg_scan_decode_packed_rows_launch(const void* regions, int cap,
                                        const void* lens,
                                        long long lens_stride, int nseg,
                                        int hdr,
                                        const void* tables,
                                        long long table_stride, void* out,
                                        int B, int nmcu, int mcus_per_seg,
                                        int bpm, int max_iter,
                                        void* stream) {
    const dim3 grid((nseg + kSegThreads - 1) / kSegThreads, B);
    jpeg_scan_decode_packed_rows_kernel<<<grid, kSegThreads, 0,
                                          (cudaStream_t)stream>>>(
        (const uint8_t*)regions, cap, (const int32_t*)lens, lens_stride,
        nseg, hdr,
        (const uint8_t*)tables, table_stride, (int16_t*)out, nmcu,
        mcus_per_seg, bpm, max_iter);
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
