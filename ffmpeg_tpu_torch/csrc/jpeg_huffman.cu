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

const char* cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
