// Baseline JPEG/MJPEG host entropy stage: the port's own copy of the two
// functions of csrc/mjpeg_huff.cpp that ffmpeg_tpu_torch calls (built by
// ffmpeg_tpu_torch/native.py).
//
// mjpeg_split_segments destuffs a scan and splits it at restart markers
// into the byte-aligned segments that K1 (csrc/jpeg_huffman.cu) decodes
// in parallel on the card.  mjpeg_decode_scan decodes a whole scan on the
// host, sequentially; the port uses it as the oracle K1 is held against.
// Re-derived from the JPEG spec; plays the role of the scan loop in
// libavcodec/mjpegdec.c.  Coefficients are emitted in zigzag order.
//
// The split reads its scan 64 bytes at a time and takes every 0xFF in
// them as an event, in order: the plain bytes before it are copied as one
// run, and the marker is handled as the byte loop handles it (FF 00 keeps
// the 0xFF, FF D0-D7 starts a segment, anything else ends the scan).  A
// restart scan has a marker every few tens of bytes, so the events, not
// the bytes, set its speed; the 64-byte bit mask of a chunk is found with
// no dependence on the events before it.  A run is copied as one 64-byte
// store at the write position, which may run past the output; the next
// run covers that, and the output blocks a chunk may touch are saved
// before it runs and put back past the output when the pass ends.  So
// nothing past the destuffed output changes: the buffer is left byte for
// byte as the byte loop leaves it.  Chunks run while 128 bytes of input
// and 192 of output room remain; the byte loop finishes the rest, so
// every error comes back where the byte loop gives it.
//
// The mask of a chunk is two 32-byte compares (AVX2) or eight uint64_t
// words (portable), chosen once when the library loads, from what the CPU
// reports (mjpeg_split_isa): AVX2 where the CPU has it, else the portable
// path, on x86-64 without AVX2 as on any other architecture.  The AVX2
// code is compiled for that ISA by a target attribute alone: the library
// is built without -march, so that it loads on any host of its
// architecture, the VP9 and AAC parsers included.
//
// Exported C ABI (ctypes); negative return values are errors.

#include "bitreader.h"
#include <cstring>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

// FNV-1a over the DHT specs for the per-stream table cache
static uint64_t fnv1a(const uint8_t* p, size_t n, uint64_t h) {
    for (size_t i = 0; i < n; ++i) { h ^= p[i]; h *= 1099511628211ull; }
    return h;
}

struct HuffTable {
    // Two-level LUT decode: a 9-bit first level (1 KB, L1-resident — the
    // 16-bit flat table thrashed L2 at ~1 MB) resolving nearly all JPEG
    // codes, with a 16-bit second level for the rare long codes.
    static constexpr int L1_BITS = 9;
    uint8_t sym1[1 << L1_BITS];
    uint8_t len1[1 << L1_BITS];      // 0 -> long code, use level 2
    uint8_t sym2[1 << 16];
    uint8_t len2[1 << 16];
    bool built = false;
    bool has_long = false;

    int build(const uint8_t* counts, const uint8_t* values) {
        uint32_t code = 0;
        int vi = 0;
        std::memset(len1, 0, sizeof(len1));
        std::memset(len2, 0, sizeof(len2));
        has_long = false;
        for (int l = 1; l <= 16; ++l) {
            for (int i = 0; i < counts[l - 1]; ++i) {
                if (code >= (1u << l)) return -1;
                if (l <= L1_BITS) {
                    uint32_t lo = code << (L1_BITS - l);
                    uint32_t hi = lo + (1u << (L1_BITS - l));
                    for (uint32_t c = lo; c < hi; ++c) {
                        sym1[c] = values[vi];
                        len1[c] = (uint8_t)l;
                    }
                } else {
                    has_long = true;
                    uint32_t lo = code << (16 - l);
                    uint32_t hi = lo + (1u << (16 - l));
                    for (uint32_t c = lo; c < hi; ++c) {
                        sym2[c] = values[vi];
                        len2[c] = (uint8_t)l;
                    }
                }
                ++code;
                ++vi;
            }
            code <<= 1;
        }
        built = true;
        return 0;
    }

    // decode one symbol from a 16-bit peek; returns length (0 = error)
    inline int decode(uint32_t look16, int* sym) const {
        uint32_t l1 = look16 >> (16 - L1_BITS);
        int l = len1[l1];
        if (l) { *sym = sym1[l1]; return l; }
        *sym = sym2[look16];
        return len2[look16];
    }
};

// JPEG "extend": map raw magnitude bits to signed value.
static inline int jpeg_extend(int v, int n) {
    if (n == 0) return 0;
    return v < (1 << (n - 1)) ? v - (1 << n) + 1 : v;
}

struct CompSpec {
    int dc_table;
    int ac_table;
    int h, v;            // sampling factors
    int blocks_w;        // row-stride of this component's block grid
};

// ---- the destuff-and-split pass (mjpeg_split_segments) ----------------

// The byte loop: the whole pass for short inputs and the tail of every
// other.  Resumes at input i, output *w, nseg; leaves *w where it stopped.
static long split_bytes(const uint8_t* data, long size, uint8_t* out,
                        long out_cap, int32_t* seg_offsets, long max_segs,
                        long i, long* w_io, long nseg) {
    long w = *w_io;
    long r = -1;
    while (i < size) {
        uint8_t b = data[i];
        if (b == 0xFF) {
            if (i + 1 < size && data[i + 1] == 0x00) {
                if (w >= out_cap) { r = -2; goto done; }
                out[w++] = 0xFF;
                i += 2;
                continue;
            }
            if (i + 1 < size && (data[i + 1] & 0xF8) == 0xD0) {
                if (nseg > max_segs) { r = -3; goto done; }
                seg_offsets[nseg++] = (int32_t)w;
                i += 2;
                continue;
            }
            break;  // EOI or other marker: end of scan
        }
        if (w >= out_cap) { r = -2; goto done; }
        out[w++] = b;
        ++i;
    }
    seg_offsets[nseg] = (int32_t)w;
    r = nseg;
done:
    *w_io = w;
    return r;
}

// Bit j set iff byte j of the 64 at p is 0xFF, one function per ISA.

// portable: the zero-byte test on ~x, exact in every byte, then the
// 0x80 bits gathered into 8 by one multiply
static inline uint64_t ff_bits_word(const uint8_t* p) {
    const uint64_t lo7 = 0x7F7F7F7F7F7F7F7Full;
    uint64_t bits = 0;
    for (int k = 0; k < 8; ++k) {
        uint64_t x;
        std::memcpy(&x, p + 8 * k, 8);
#if __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
        x = __builtin_bswap64(x);
#endif
        uint64_t y = ~x;
        uint64_t t = ~(((y & lo7) + lo7) | y | lo7);  // 0x80 where y == 0
        bits |= (((t >> 7) * 0x0102040810204080ull) >> 56) << (8 * k);
    }
    return bits;
}

#if defined(__x86_64__)
#define SPLIT_AVX2 __attribute__((target("avx2")))
SPLIT_AVX2 static inline uint64_t ff_bits_avx2(const uint8_t* p) {
    const __m256i ff = _mm256_set1_epi8(-1);
    __m256i a = _mm256_loadu_si256((const __m256i*)p);
    __m256i b = _mm256_loadu_si256((const __m256i*)(p + 32));
    return (uint64_t)(uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(a, ff))
        | (uint64_t)(uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(b, ff))
        << 32;
}
#endif

// Originals of the output past the write position: 64-byte blocks of
// out, saved before anything is stored into them, at ring[pos & 255].
struct Saved {
    uint8_t ring[256];
    long end = 0;        // out[0, end) saved; nothing at or past it stored

    void cover(const uint8_t* out, long upto) {
        for (; end < upto; end += 64)
            std::memcpy(ring + (end & 255), out + end, 64);
    }
    // put back out[w, end), where stores may have run past the output
    void restore(uint8_t* out, long w) const {
        for (long p = w; p < end; ++p) out[p] = ring[p & 255];
    }
};

// The chunked pass (see the top of the file), FfBits giving a chunk's
// 0xFF bytes.  A run within a chunk is shorter than 64 bytes, so each is
// one 64-byte copy, and every store of a chunk ends before w + 128 for
// the w the chunk starts with: those blocks are saved before it runs.
template <uint64_t (*FfBits)(const uint8_t*)>
static inline long split_chunks(const uint8_t* __restrict data, long size,
                                uint8_t* __restrict out, long out_cap,
                                int32_t* seg_offsets, long max_segs) {
    long src = 0, w = 0, nseg = 0, r;
    if (max_segs < 1) return -1;
    seg_offsets[nseg++] = 0;
    Saved saved;
    // i0 + 128: every copy reads src + 64 <= i0 + 128; w + 192: the saved
    // blocks end by then
    long i0 = 0;
    for (; i0 + 128 <= size && w + 192 <= out_cap; i0 += 64) {
        saved.cover(out, w + 128);
        // the scan is read once and the output written once, both mostly
        // missing the caches (a batch of frames is tens of MB): ask for
        // each one's line 32 chunks ahead, the output's for writing
        __builtin_prefetch(data + i0 + 2048);
        __builtin_prefetch(out + w + 2048, 1);
        // src is i0, or i0 + 1 after a marker across the chunk edge, whose
        // second byte is not 0xFF: every bit is at or past src
        for (uint64_t m = FfBits(data + i0); m; m &= m - 1) {
            long pos = i0 + __builtin_ctzll(m);
            std::memcpy(out + w, data + src, 64);
            w += pos - src;
            uint8_t b = data[pos + 1];
            src = pos + 2;
            if (b == 0x00) {
                out[w++] = 0xFF;
            } else if ((b & 0xF8) == 0xD0) {
                if (nseg > max_segs) { r = -3; goto done; }
                seg_offsets[nseg++] = (int32_t)w;
            } else {                    // EOI or other marker: end of scan
                seg_offsets[nseg] = (int32_t)w;
                r = nseg;
                goto done;
            }
        }
        if (src < i0 + 64) {
            std::memcpy(out + w, data + src, 64);
            w += i0 + 64 - src;
            src = i0 + 64;
        }
    }
    r = split_bytes(data, size, out, out_cap, seg_offsets, max_segs, src,
                    &w, nseg);
done:
    saved.restore(out, w);
    return r;
}

typedef long (*split_fn)(const uint8_t*, long, uint8_t*, long, int32_t*,
                         long);

static long split_word(const uint8_t* data, long size, uint8_t* out,
                       long out_cap, int32_t* seg_offsets, long max_segs) {
    return split_chunks<ff_bits_word>(data, size, out, out_cap, seg_offsets,
                                      max_segs);
}

#if defined(__x86_64__)
// flatten: the pass and ff_bits_avx2 inlined into this AVX2 function,
// its 64-byte copies as 32-byte moves
SPLIT_AVX2 __attribute__((flatten))
static long split_avx2(const uint8_t* data, long size, uint8_t* out,
                       long out_cap, int32_t* seg_offsets, long max_segs) {
    return split_chunks<ff_bits_avx2>(data, size, out, out_cap, seg_offsets,
                                      max_segs);
}
#endif

struct SplitIsa {
    int isa;           // 2 AVX2, 0 the portable word
    split_fn fn;
};

static SplitIsa pick_split() {
#if defined(__x86_64__)
    __builtin_cpu_init();
    if (__builtin_cpu_supports("avx2")) return {2, split_avx2};
#endif
    return {0, split_word};
}

static const SplitIsa kSplit = pick_split();

}  // namespace

extern "C" {

// Destuff a scan and split it at RSTn markers into byte-aligned
// segments (restart intervals), the unit of parallelism for the
// device-side Huffman decoder (ops/huffman.py): each segment starts
// byte-aligned with DC predictors reset, so thousands decode in
// parallel, one lane each.
//   out:          destuffed bytes of all segments, concatenated; nothing
//                 past them changes.  It may not overlap data.
//   seg_offsets:  byte offset of segment i in out; [nseg] = total size
//                 (max_segs + 2 entries)
// Returns nseg (>= 1) or a negative error: -1 max_segs < 1, -2 out_cap
// too small, -3 more than max_segs + 1 segments.
long mjpeg_split_segments(const uint8_t* data, long size,
                          uint8_t* out, long out_cap,
                          int32_t* seg_offsets, long max_segs) {
    return kSplit.fn(data, size, out, out_cap, seg_offsets, max_segs);
}

// The same pass on the portable 8-byte path, whatever the CPU: the
// dispatched function is held to it in the tests.
long mjpeg_split_segments_portable(const uint8_t* data, long size,
                                   uint8_t* out, long out_cap,
                                   int32_t* seg_offsets, long max_segs) {
    return split_word(data, size, out, out_cap, seg_offsets, max_segs);
}

// The path mjpeg_split_segments runs: 2 AVX2, 0 portable.
int mjpeg_split_isa(void) { return kSplit.isa; }

// counts: 4 tables x 2 classes x 16 ; values: 4x2x256
// comp_spec: per component: dc_tab, ac_tab, h, v, blocks_w  (5 ints)
// out: per component pointer to int16[blocks_total*64] (zigzag order)
// mcus_x/mcus_y: MCU grid; restart_interval: MCUs between RST markers (0=none)
// coeff_limit: store only the first coeff_limit zigzag coefficients per
// block (still parses all). Output stride per block is coeff_limit.
int mjpeg_decode_scan(
    const uint8_t* data, long size,
    const uint8_t* dc_counts, const uint8_t* dc_values,
    const uint8_t* ac_counts, const uint8_t* ac_values,
    const int* comp_spec, int ncomp,
    int mcus_x, int mcus_y, int restart_interval,
    int coeff_limit, int16_t** out) {

    // successive frames of a stream share DHT specs: cache built LUTs
    static thread_local HuffTable dc_tabs[4], ac_tabs[4];
    static thread_local uint64_t cached_hash = 0;
    CompSpec comps[4];
    if (ncomp < 1 || ncomp > 4) return -1;
    for (int c = 0; c < ncomp; ++c) {
        comps[c].dc_table = comp_spec[c * 5 + 0];
        comps[c].ac_table = comp_spec[c * 5 + 1];
        comps[c].h = comp_spec[c * 5 + 2];
        comps[c].v = comp_spec[c * 5 + 3];
        comps[c].blocks_w = comp_spec[c * 5 + 4];
        if (comps[c].dc_table < 0 || comps[c].dc_table > 3) return -2;
        if (comps[c].ac_table < 0 || comps[c].ac_table > 3) return -2;
    }
    uint64_t h = 1469598103934665603ull;
    h = fnv1a(dc_counts, 4 * 16, h);
    h = fnv1a(dc_values, 4 * 256, h);
    h = fnv1a(ac_counts, 4 * 16, h);
    h = fnv1a(ac_values, 4 * 256, h);
    if (h != cached_hash) {
        for (int t = 0; t < 4; ++t) {
            dc_tabs[t].build(dc_counts + t * 16, dc_values + t * 256);
            ac_tabs[t].build(ac_counts + t * 16, ac_values + t * 256);
        }
        cached_hash = h;
    }

    // destuff: strip 0xFF00 -> 0xFF and locate RST markers.
    // We destuff into a scratch buffer once (cheap, single pass).
    uint8_t* buf = new uint8_t[size];
    // segment boundaries at RST markers for restart handling
    // We decode sequentially; on RST we realign the bit reader.
    BitReader br;

    auto destuff_until_marker = [&](long start, long* seg_len) -> long {
        // copies from data[start..] into buf, stopping at any marker except
        // stuffed FF00; returns position after the marker (or size).
        long i = start;
        long w = 0;
        while (i < size) {
            uint8_t b = data[i];
            if (b == 0xFF) {
                if (i + 1 < size && data[i + 1] == 0x00) {
                    buf[w++] = 0xFF;
                    i += 2;
                    continue;
                }
                break;  // real marker
            }
            buf[w++] = b;
            ++i;
        }
        *seg_len = w;
        return i;
    };

    int pred[4] = {0, 0, 0, 0};
    long mcu_count = (long)mcus_x * mcus_y;
    long mcu_done = 0;
    long read_pos = 0;

    long seg_len = 0;
    read_pos = destuff_until_marker(0, &seg_len);
    br.init(buf, seg_len);

    while (mcu_done < mcu_count) {
        long my = mcu_done / mcus_x;
        long mx = mcu_done % mcus_x;
        for (int c = 0; c < ncomp; ++c) {
            const CompSpec& cs = comps[c];
            HuffTable& dt = dc_tabs[cs.dc_table];
            HuffTable& at = ac_tabs[cs.ac_table];
            for (int by = 0; by < cs.v; ++by) {
                for (int bx = 0; bx < cs.h; ++bx) {
                    long row = my * cs.v + by;
                    long col = mx * cs.h + bx;
                    int16_t* blk = out[c] + (row * cs.blocks_w + col) * coeff_limit;
                    std::memset(blk, 0, (size_t)coeff_limit * 2);
                    // DC. peek(16) refills to >=57 cached bits, so the
                    // magnitude bits (<=16) never need another refill.
                    int s;
                    int l = dt.decode(br.peek(16), &s);
                    if (!l) { delete[] buf; return -3; }
                    br.skip(l);
                    int diff = jpeg_extend((int)br.get_cached(s), s);
                    pred[c] += diff;
                    blk[0] = (int16_t)pred[c];
                    // AC (run/size)
                    int k = 1;
                    while (k < 64) {
                        int rs;
                        l = at.decode(br.peek(16), &rs);
                        if (!l) { delete[] buf; return -4; }
                        br.skip(l);
                        int run = rs >> 4;
                        int sz = rs & 15;
                        if (sz == 0) {
                            if (run == 15) { k += 16; continue; }  // ZRL
                            break;  // EOB
                        }
                        k += run;
                        if (k > 63) { delete[] buf; return -5; }
                        int v = jpeg_extend((int)br.get_cached(sz), sz);
                        if (k < coeff_limit) blk[k] = (int16_t)v;
                        ++k;
                    }
                    if (br.overread()) { delete[] buf; return -6; }
                }
            }
        }
        ++mcu_done;
        if (restart_interval && mcu_done < mcu_count &&
            mcu_done % restart_interval == 0) {
            // expect RSTn marker at read_pos
            if (read_pos + 1 < size && data[read_pos] == 0xFF &&
                (data[read_pos + 1] & 0xF8) == 0xD0) {
                read_pos += 2;
                read_pos = destuff_until_marker(read_pos, &seg_len);
                br.init(buf, seg_len);
                pred[0] = pred[1] = pred[2] = pred[3] = 0;
            } else {
                delete[] buf;
                return -7;
            }
        }
    }
    delete[] buf;
    return 0;
}

}  // extern "C"
