// K2: full-search SAD cost volume, written by hand for Hopper (sm_90a).
//
// Replaces: ffmpeg_tpu/ops/me.py sad_cost_volume_pl (the Pallas kernel
// body `kernel`), as reached through motion_search from the MPEG-2 and
// H.264 encoders.  Same contract as the plain version
// ffmpeg_tpu_torch/ops/me.py sad_cost_volume_strip_plain, which is the
// Pallas kernel's contract:
// - samples truncated to int32 (uint8 exactly, float32 toward zero);
// - cur cropped to by*B x bx*B;
// - ref cropped to bx*B columns, then edge-padded by R: a window row
//   y is clamped to [0, h-1] and a column x to [0, bx*B-1];
// - out[by][bx][dy+R][dx+R] = sum over the block of |cur - ref(dy, dx)|,
//   an exact int32 sum, written as float32.
// Exact whenever every |sample| < 2^20 (no int32 overflow in a sum).
//
// What bounds it on this card: at 1088x1920 with B=16, R=8 the volume is
// 8160 blocks x 289 candidates x 256 = 604 M absolute differences on
// 4.2 MB of input and 9.4 MB of output (~0.004 ms of device memory), so
// it is bound by operations.  On uint8 samples one instruction
// (VABSDIFF4 with its accumulator) takes 4 differences and adds them, so
// the bound is 151 M instructions over the SMs' 32-bit integer rate (the
// CUDA C++ Programming Guide's 64 results per clock per SM for
// compute capability 9.0: 132 SMs x 64 x 1.98 GHz): 0.0090 ms.
//
// Widening each uint8 sample to int32 in shared memory would cost two
// shared loads per difference and bind the kernel to shared-memory issue;
// one CTA per block would pay a prologue and a barrier per block.  This
// design:
// - a CTA takes a strip of up to 8 horizontally adjacent blocks of one
//   block row (4 at R=8) and stages, per block, its cur tile and its
//   (B+2R)-row window once in shared memory: on uint8, whole 32-bit words
//   where no column needs the edge clamp, up to 8 loads in flight per
//   thread before any is stored;
// - uint8 samples stay packed 4 to a 32-bit word; each block's window
//   rows start on a word boundary, so a thread that owns 4 adjacent dx
//   at one dy reads, per row, ceil(B/4)+1 window words and the block's
//   ceil(B/4) cur words, forms the 3 other byte alignments with
//   __byte_perm, and accumulates each word's 4 differences with one
//   VABSDIFF4 (PTX vabsdiff4 with .add): 64 differences per row in ~36
//   instructions at B=16, exact in int32; a last partial word (B not a
//   multiple of 4) takes __dp4a(__vabsdiffu4(c, w), weights, acc) with
//   weight 0 for the bytes past the block;
// - the float32 path uses the same tiling on int32 samples, with a
//   sliding window of 4 samples in registers (one shared load per 4
//   differences);
// - the kernel is a template on the sample type, B and R: uint8 at B=16,
//   R=8 (what the encoders use) is an instance with every size known to
//   the compiler; every other (B, R) of the contract, and float32, runs
//   through the instance with both known at run time.
// What the TPU kernel needed and this one drops: the lane padding to
// 128, the (ncand, W) row-sum scratch and the pooling matmul on the MXU.
//
// The device code is in plain __device__ functions so that it can be
// driven one thread at a time elsewhere.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxB = 32;                    // largest block
constexpr int kMaxR = 16;                    // largest search radius
constexpr int kMaxBW = kMaxB / 4;            // cur words per row
constexpr int kMaxStrip = 8;                 // blocks per CTA
constexpr int kTargetThreads = 384;
constexpr int kSmemLimit = 48 * 1024;        // no opt-in needed

struct Geometry {
    int B, R, D;        // block, radius, 2R+1 candidates per axis
    int G;              // dx groups of 4: ceil(D/4)
    int WR;             // window rows: B + 2R
    int BW;             // cur words per row: ceil(B/4)
    int SW;             // window row stride: words (u8) or samples (i32)
    int NB;             // blocks per CTA
    int per_block;      // threads per block: D * G
};

__host__ __device__ inline Geometry geometry(int B, int R, bool is_float,
                                             int nb) {
    Geometry g;
    g.B = B;
    g.R = R;
    g.D = 2 * R + 1;
    g.G = (g.D + 3) / 4;
    g.WR = B + 2 * R;
    g.BW = (B + 3) / 4;
    // a thread reads window columns [4g, 4g + B + 3): G + BW words (u8)
    // or 4G + B - 1 samples (i32) per row.  A u8 row's stride is G + 32
    // words, so the 32 lanes of a warp, which hold consecutive (dy, g)
    // of one block, read 32 consecutive words: no bank conflicts.
    g.SW = is_float ? 4 * g.G + B - 1 : g.G + 32;
    g.NB = nb;
    g.per_block = g.D * g.G;
    return g;
}

// Shared bytes of one block's staged tiles: window, then cur.
__host__ __device__ inline int block_smem(const Geometry& g, bool is_float) {
    return is_float ? 4 * (g.WR * g.SW + g.B * g.B)
                    : 4 * (g.WR * g.SW + g.B * g.BW);
}

__device__ __forceinline__ int to_i32(uint8_t v) { return (int)v; }
__device__ __forceinline__ int to_i32(float v) { return (int)v; }  // rz

// Stage block j of the strip, float32 samples: window rows (clamped as
// in the contract) and cur rows, as int32.
template <typename T>
__device__ __forceinline__ void stage_block_i32(uint32_t* smem,
                                                const Geometry& g, int t,
                                                int nthreads, const T* cur,
                                                const T* ref, int h, int w,
                                                int wc, int y0, int x0) {
    uint32_t* win = smem;
    uint32_t* cs = smem + g.WR * g.SW;
    for (int i = t; i < g.WR * g.SW; i += nthreads) {
        const int r = i / g.SW;
        const int c = i - r * g.SW;
        const int y = min(max(y0 - g.R + r, 0), h - 1);
        const int x = min(max(x0 - g.R + c, 0), wc - 1);
        win[i] = (uint32_t)to_i32(ref[(size_t)y * w + x]);
    }
    for (int i = t; i < g.B * g.B; i += nthreads) {
        const int r = i / g.B;
        const int c = i - r * g.B;
        cs[i] = (uint32_t)to_i32(cur[(size_t)(y0 + r) * w + x0 + c]);
    }
}

// Word i of the strip's staged uint8 tiles: the window rows of every
// block, then the cur rows of every block, as packed little-endian bytes
// (a cur word past the block's width holds zeros).  Sets *dst to its
// place in shared memory.  Whole aligned 32-bit loads where no column is
// clamped (every block but those at the frame's left and right edges,
// when w and B are multiples of 4), else byte by byte with the clamps.
__device__ __forceinline__ uint32_t strip_word_u8(
        const Geometry& g, int i, int nblk, int words, const uint8_t* cur,
        const uint8_t* ref, int h, int w, int wc, int y0, int bx0,
        int* dst) {
    const int used = g.G + g.BW;               // window words of each row
    const int nwin = nblk * g.WR * used;
    const bool aligned = (w & 3) == 0
        && ((reinterpret_cast<uintptr_t>(ref)
             | reinterpret_cast<uintptr_t>(cur)) & 3) == 0;
    if (i < nwin) {
        const int j = i / (g.WR * used);
        const int rem = i - j * g.WR * used;
        const int r = rem / used;
        const int c = 4 * (rem - r * used);
        *dst = j * words + r * g.SW + c / 4;
        const int xw = (bx0 + j) * g.B - g.R + c;
        const uint8_t* row = ref + (size_t)min(max(y0 - g.R + r, 0), h - 1)
                                       * w;
        if (aligned && (xw & 3) == 0 && xw >= 0 && xw + 4 <= wc)
            return *reinterpret_cast<const uint32_t*>(row + xw);
        uint32_t v = 0;
        for (int k = 3; k >= 0; --k)
            v = (v << 8) | row[min(max(xw + k, 0), wc - 1)];
        return v;
    }
    i -= nwin;
    const int j = i / (g.B * g.BW);
    const int rem = i - j * g.B * g.BW;
    const int r = rem / g.BW;
    const int c = 4 * (rem - r * g.BW);
    *dst = j * words + g.WR * g.SW + rem;
    const uint8_t* row = cur + (size_t)(y0 + r) * w + (bx0 + j) * g.B;
    if (aligned && (g.B & 3) == 0)
        return *reinterpret_cast<const uint32_t*>(row + c);
    uint32_t v = 0;
    for (int k = 3; k >= 0; --k)
        v = (v << 8) | (c + k < g.B ? row[c + k] : 0u);
    return v;
}

// Stage the whole strip's uint8 tiles, thread t of nthreads: up to 8
// loads in flight per thread before any of them is stored, so the CTA
// waits about one memory latency, not one per block.
__device__ __forceinline__ void stage_strip_u8(
        uint32_t* smem, const Geometry& g, int t, int nthreads, int nblk,
        int words, const uint8_t* cur, const uint8_t* ref, int h, int w,
        int wc, int y0, int bx0) {
    const int total = nblk * (g.WR * (g.G + g.BW) + g.B * g.BW);
    for (int i0 = t; i0 < total; i0 += 8 * nthreads) {
        uint32_t v[8];
        int dst[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int i = i0 + u * nthreads;
            if (i < total)
                v[u] = strip_word_u8(g, i, nblk, words, cur, ref, h, w, wc,
                                     y0, bx0, &dst[u]);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
            if (i0 + u * nthreads < total)
                smem[dst[u]] = v[u];
    }
}

// acc + the sum over 4 byte lanes of wt * |c - w|, exact in 32 bits.
__device__ __forceinline__ int sad_bytes(uint32_t c, uint32_t w,
                                         uint32_t wt, int acc) {
    return (int)__dp4a(__vabsdiffu4(c, w), wt, (uint32_t)acc);
}

// acc + the sum over all 4 byte lanes of |c - w|: on the card one
// instruction (VABSDIFF4 with its accumulator), elsewhere sad_bytes.
__device__ __forceinline__ int sad_word(uint32_t c, uint32_t w, int acc) {
#ifdef __CUDA_ARCH__
    int d;
    asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
        : "=r"(d) : "r"(c), "r"(w), "r"(acc));
    return d;
#else
    return sad_bytes(c, w, 0x01010101u, acc);
#endif
}

// Sums of 4 candidates (dy, 4*gx + s), s = 0..3, of one block, uint8.
// BT > 0: B known at compile time (loops unrolled); BT == 0: B = g.B.
template <int BT>
__device__ __forceinline__ void sad4_u8(const uint32_t* smem,
                                        const Geometry& g, int dy, int gx,
                                        int acc[4]) {
    constexpr int kBW = BT > 0 ? (BT + 3) / 4 : kMaxBW;
    const int B = BT > 0 ? BT : g.B;
    const int BW = BT > 0 ? kBW : g.BW;
    const uint32_t* win = smem + dy * g.SW + gx;
    const uint32_t* cs = smem + g.WR * g.SW;
    // byte weights: 1 for the bytes of the block, 0 past its width
    const int tail = B - 4 * (BW - 1);          // bytes in the last word
    const uint32_t last_wt = 0x01010101u >> (8 * (4 - tail));
    acc[0] = acc[1] = acc[2] = acc[3] = 0;
#pragma unroll 2
    for (int r = 0; r < B; ++r) {
        uint32_t c[kBW], wv[kBW + 1];
#pragma unroll
        for (int k = 0; k < kBW; ++k)
            if (k < BW)
                c[k] = cs[r * BW + k];
#pragma unroll
        for (int k = 0; k <= kBW; ++k)
            if (k <= BW)
                wv[k] = win[r * g.SW + k];
#pragma unroll
        for (int k = 0; k < kBW; ++k) {
            if (k >= BW)
                continue;
            const uint32_t w1 = __byte_perm(wv[k], wv[k + 1], 0x4321);
            const uint32_t w2 = __byte_perm(wv[k], wv[k + 1], 0x5432);
            const uint32_t w3 = __byte_perm(wv[k], wv[k + 1], 0x6543);
            if (k < BW - 1 || tail == 4) {
                acc[0] = sad_word(c[k], wv[k], acc[0]);
                acc[1] = sad_word(c[k], w1, acc[1]);
                acc[2] = sad_word(c[k], w2, acc[2]);
                acc[3] = sad_word(c[k], w3, acc[3]);
            } else {
                acc[0] = sad_bytes(c[k], wv[k], last_wt, acc[0]);
                acc[1] = sad_bytes(c[k], w1, last_wt, acc[1]);
                acc[2] = sad_bytes(c[k], w2, last_wt, acc[2]);
                acc[3] = sad_bytes(c[k], w3, last_wt, acc[3]);
            }
        }
    }
}

// The same for int32 samples (the float32 path).
template <int BT>
__device__ __forceinline__ void sad4_i32(const uint32_t* smem,
                                         const Geometry& g, int dy, int gx,
                                         int acc[4]) {
    const int B = BT > 0 ? BT : g.B;
    const int* win = reinterpret_cast<const int*>(smem) + dy * g.SW + 4 * gx;
    const int* cs = reinterpret_cast<const int*>(smem) + g.WR * g.SW;
    acc[0] = acc[1] = acc[2] = acc[3] = 0;
#pragma unroll 1
    for (int r = 0; r < B; ++r) {
        const int* wr = win + r * g.SW;
        const int* cr = cs + r * B;
        int w0 = wr[0], w1 = wr[1], w2 = wr[2];
#pragma unroll 4
        for (int c = 0; c < B; ++c) {
            const int w3 = wr[c + 3];
            const int cv = cr[c];
            acc[0] += abs(cv - w0);
            acc[1] += abs(cv - w1);
            acc[2] += abs(cv - w2);
            acc[3] += abs(cv - w3);
            w0 = w1;
            w1 = w2;
            w2 = w3;
        }
    }
}

// One thread's work: candidates (dy, 4*gx .. 4*gx+3) of block (byi, bxi).
template <typename T, int BT>
__device__ __forceinline__ void thread_candidates(const uint32_t* smem,
                                                  const Geometry& g, int dy,
                                                  int gx, float* o) {
    int acc[4];
    if (sizeof(T) == 4)
        sad4_i32<BT>(smem, g, dy, gx, acc);
    else
        sad4_u8<BT>(smem, g, dy, gx, acc);
    for (int s = 0; s < 4; ++s) {
        const int dx = 4 * gx + s;
        if (dx < g.D)
            o[dy * g.D + dx] = (float)acc[s];
    }
}

template <typename T, int BT, int RT>
__global__ void __launch_bounds__(1024)
sad_cost_volume_kernel(const T* __restrict__ cur, const T* __restrict__ ref,
                       int h, int w, int B, int R, int nb, int nbx,
                       float* __restrict__ out) {
    extern __shared__ uint32_t smem[];
    const Geometry g = geometry(BT > 0 ? BT : B, RT > 0 ? RT : R,
                                sizeof(T) == 4, nb);
    const int words = block_smem(g, sizeof(T) == 4) / 4;
    const int bx0 = blockIdx.x * g.NB;
    const int byi = blockIdx.y;
    const int nblk = min(g.NB, nbx - bx0);
    const int t = threadIdx.x;
    if (sizeof(T) == 4) {
        for (int j = 0; j < nblk; ++j)
            stage_block_i32<T>(smem + j * words, g, t, blockDim.x, cur, ref,
                               h, w, nbx * g.B, byi * g.B, (bx0 + j) * g.B);
    } else {
        stage_strip_u8(smem, g, t, blockDim.x, nblk, words,
                       reinterpret_cast<const uint8_t*>(cur),
                       reinterpret_cast<const uint8_t*>(ref), h, w,
                       nbx * g.B, byi * g.B, bx0);
    }
    __syncthreads();
    const int j = t / g.per_block;
    if (j >= nblk)
        return;
    const int k = t - j * g.per_block;
    const int dy = k / g.G;
    const int gx = k - dy * g.G;
    thread_candidates<T, BT>(smem + j * words, g, dy, gx,
                             out + ((size_t)byi * nbx + bx0 + j) * g.D * g.D);
}

// Blocks per CTA: up to kMaxStrip, about kTargetThreads threads, and the
// staged tiles within kSmemLimit.
int strip_blocks(const Geometry& g1, bool is_float) {
    int nb = kTargetThreads / g1.per_block;
    nb = nb < 1 ? 1 : (nb > kMaxStrip ? kMaxStrip : nb);
    while (nb > 1 && nb * block_smem(g1, is_float) > kSmemLimit)
        --nb;
    return nb;
}

template <typename T, int BT, int RT>
int launch(const void* cur, const void* ref, int h, int w, int B, int R,
           void* out, cudaStream_t s) {
    const bool is_float = sizeof(T) == 4;
    const Geometry g = geometry(B, R, is_float, 1);
    const int nb = strip_blocks(g, is_float);
    const int nbx = w / B;
    const dim3 grid((nbx + nb - 1) / nb, h / B);
    const int threads = (nb * g.per_block + 31) / 32 * 32;
    sad_cost_volume_kernel<T, BT, RT><<<grid, threads,
                                    nb * block_smem(g, is_float), s>>>(
        (const T*)cur, (const T*)ref, h, w, B, R, nb, nbx, (float*)out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cur, ref (h, w) contiguous, uint8 (is_float 0) or float32 (is_float 1);
// out (h/B, w/B, 2R+1, 2R+1) float32.  1 <= B <= 32, 0 <= R <= 16,
// h >= B, w >= B, h/B <= 65535.  Launches on `stream`, does not
// synchronise; returns cudaGetLastError(), or cudaErrorInvalidValue
// without launching for arguments outside that range.
int sad_cost_volume_launch(const void* cur, const void* ref, int is_float,
                           int h, int w, int B, int R, void* out,
                           void* stream) {
    if (B < 1 || B > kMaxB || R < 0 || R > kMaxR || h < B || w < B
        || h / B > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (is_float)
        return launch<float, 0, 0>(cur, ref, h, w, B, R, out, s);
    if (B == 16 && R == 8)
        return launch<uint8_t, 16, 8>(cur, ref, h, w, B, R, out, s);
    return launch<uint8_t, 0, 0>(cur, ref, h, w, B, R, out, s);
}

}  // extern "C"
