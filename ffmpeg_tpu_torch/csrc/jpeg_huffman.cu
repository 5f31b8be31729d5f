// K1: segment-parallel baseline JPEG Huffman decode, written by hand for
// Hopper (sm_90a).
//
// Replaces: ffmpeg_tpu/ops/huffman.py jpeg_scan_decode9_pl (the Pallas
// kernel body _make_pl_kernel.kernel), as called from
// ffmpeg_tpu/models/mjpeg_tpu_entropy.py run().  Same contract as the plain
// version ffmpeg_tpu_torch/ops/huffman.py jpeg_scan_decode9: one lane per
// restart segment, each segment one 4:2:0 MCU of 6 blocks (Y0-Y3 Cb Cr),
// DC predictors reset at the segment start, run/size/EOB/ZRL as in
// ITU T.81 F.2.2, zigzag coefficients out as int16.
//
// What bounds it on this card: per 1080p frame the kernel writes 8160
// lanes x 384 int16 = 6.3 MB of coefficients, about 2 us of the card's
// device-memory bandwidth, while it reads only ~150 KB of entropy-coded
// bytes.  The reads are a serial bit walk: each lane decodes up to ~390
// symbols one after another, every symbol a dependent chain of shift,
// shared-memory table load and compare.  So a lane's time is latency,
// not bandwidth, and the kernel is as fast as its longest lanes and as
// its number of lanes in flight to hide that latency.
//
// What the design does about that:
// - one thread per segment, 128 segments per block, grid (ceil(nmcu/128),
//   B): 510 blocks for a batch of 8 frames, so every SM holds several
//   blocks and switches warps while one waits;
// - the frame's Huffman table lives in shared memory as 4 x 512 packed
//   uint16 entries (len | run << 4 | size << 8), one 9-bit peek and one
//   shared load per symbol; the 512-row table decodes <= 8-bit streams
//   too;
// - a 64-bit bit buffer in registers, refilled bytewise to >= 57 bits
//   before each symbol, so one symbol (<= 9 code bits + <= 15 magnitude
//   bits) never needs a second refill; bytes at or past `cap` read as 0;
// - each thread first clears its lane's 768 output bytes with 16-byte
//   stores, then stores each non-zero coefficient directly: no output
//   staging, no atomics, no synchronisation after the table load.
// What the TPU kernel needed and this one drops: the one-hot MXU table
// lookup, the 12-word bit refill, the 1024-lane blocks and the sort of
// lanes by length that made those blocks uniform.
//
// A corrupt code (table length 0) cannot hang a thread: the loop stops
// after max_iter symbols, as the plain version's does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlocksPerSeg = 6;
constexpr int kCoefs = kBlocksPerSeg * 64;
constexpr int kLutRows = 512;       // 9-bit peek
constexpr int kLutCols = 12;        // [len, run, size] x 4 tables
constexpr int kThreads = 128;       // segments per block

// MSB-first bit reader over one frame region.  `buf` holds `nbits` valid
// bits, left-aligned; logical shifts only (unsigned 64-bit).
struct BitReader {
    const uint8_t* region;
    int pos;        // next byte to load
    int cap;
    uint64_t buf;
    int nbits;

    __device__ __forceinline__ void init(const uint8_t* r, int start,
                                         int c) {
        region = r;
        pos = start;
        cap = c;
        buf = 0;
        nbits = 0;
    }

    __device__ __forceinline__ void refill() {
        while (nbits <= 56) {
            const uint64_t byte =
                (pos >= 0 && pos < cap) ? (uint64_t)region[pos] : 0ull;
            buf |= byte << (56 - nbits);
            ++pos;
            nbits += 8;
        }
    }

    __device__ __forceinline__ void skip(int n) {
        buf <<= n;          // n <= 9 + 15 < 64
        nbits -= n;
    }
};

// Decode one segment into out[0:384] (zigzag order, 6 blocks of 64).
__device__ __forceinline__ void decode_lane(
        const uint8_t* region, int cap, int start, int end,
        const uint16_t (*lut)[kLutRows], int16_t* out, int max_iter) {
    int4* out4 = reinterpret_cast<int4*>(out);
    for (int i = 0; i < kCoefs * 2 / 16; ++i)
        out4[i] = make_int4(0, 0, 0, 0);

    BitReader br;
    br.init(region, start, cap);
    int blk = 0;        // block within the MCU
    int k = -1;         // next zigzag position; -1 = DC next
    int p0 = 0, p1 = 0, p2 = 0;
    for (int it = 0; it < max_iter && blk < end; ++it) {
        br.refill();
        const int comp = (blk >= 4) + (blk >= 5);
        const bool is_dc = k < 0;
        const int sel = (is_dc ? 0 : 2) + (comp > 0);
        const uint32_t e = lut[sel][(uint32_t)(br.buf >> 55)];
        const int ln = e & 15;
        const int run = (e >> 4) & 15;
        const int sz = (e >> 8) & 15;
        int val = 0;
        if (sz > 0) {
            const uint32_t mag = (uint32_t)((br.buf << ln) >> (64 - sz));
            val = mag < (1u << (sz - 1)) ? (int)mag - (1 << sz) + 1
                                         : (int)mag;
        }
        br.skip(ln + sz);
        int coef, pos;
        if (is_dc) {
            const int predc = comp == 0 ? p0 : (comp == 1 ? p1 : p2);
            coef = predc + val;
            if (comp == 0) p0 = coef;
            else if (comp == 1) p1 = coef;
            else p2 = coef;
            pos = 0;
        } else {
            coef = val;
            pos = k + run;
        }
        if ((is_dc || sz > 0) && pos < 64)
            out[blk * 64 + pos] = (int16_t)coef;       // wraps as int16
        const bool eob = !is_dc && sz == 0 && run == 0;
        const bool zrl = !is_dc && sz == 0 && run == 15;
        const int k_new = is_dc ? 1 : (zrl ? k + 16 : pos + 1);
        if (!is_dc && (eob || k_new >= 64)) {
            ++blk;
            k = -1;
        } else {
            k = k_new;
        }
    }
}

__global__ void __launch_bounds__(kThreads)
jpeg_scan_decode_packed_kernel(const uint8_t* __restrict__ regions, int cap,
                               const int32_t* __restrict__ starts,
                               const int32_t* __restrict__ lens,
                               const int8_t* __restrict__ luts,
                               int16_t* __restrict__ out, int nmcu,
                               int max_iter) {
    __shared__ uint16_t lut[4][kLutRows];
    const int b = blockIdx.y;
    const int8_t* flut = luts + (size_t)b * kLutRows * kLutCols;
    for (int i = threadIdx.x; i < kLutRows * 4; i += blockDim.x) {
        const int row = i >> 2;
        const int t = i & 3;
        const int8_t* e = flut + row * kLutCols + 3 * t;
        lut[t][row] = (uint16_t)((e[0] & 15) | ((e[1] & 15) << 4)
                                 | ((e[2] & 15) << 8));
    }
    __syncthreads();
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= nmcu)
        return;
    const size_t li = (size_t)b * nmcu + lane;
    decode_lane(regions + (size_t)b * cap, cap, starts[li],
                lens[li] > 0 ? kBlocksPerSeg : 0, lut,
                out + li * kCoefs, max_iter);
}

}  // namespace

extern "C" {

// regions (B, cap) u8; starts, lens (B, nmcu) i32; luts (B, 512, 12) i8
// with entries in [0, 15]; out (B, nmcu, 6, 64) i16, 16-byte aligned.
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
int jpeg_scan_decode_packed_launch(const void* regions, int cap,
                                   const void* starts, const void* lens,
                                   const void* luts, void* out, int B,
                                   int nmcu, int max_iter, void* stream) {
    const dim3 grid((nmcu + kThreads - 1) / kThreads, B);
    jpeg_scan_decode_packed_kernel<<<grid, kThreads, 0,
                                     (cudaStream_t)stream>>>(
        (const uint8_t*)regions, cap, (const int32_t*)starts,
        (const int32_t*)lens, (const int8_t*)luts, (int16_t*)out, nmcu,
        max_iter);
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
