// MSB-first bit reader for host-side entropy decoding (the port's copy of
// csrc/bitreader.h).
// Analog of the reference's GetBitContext (libavcodec/get_bits.h) but
// re-designed: 64-bit cache refilled with single 8-byte loads (bswap64),
// which is the main host-side throughput lever for Huffman decode.
#pragma once
#include <cstddef>
#include <cstdint>
#include <cstring>

static inline uint64_t br_load_be64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
#if defined(__GNUC__)
    return __builtin_bswap64(v);
#else
    return ((v & 0xFFull) << 56) | ((v & 0xFF00ull) << 40) |
           ((v & 0xFF0000ull) << 24) | ((v & 0xFF000000ull) << 8) |
           ((v >> 8) & 0xFF000000ull) | ((v >> 24) & 0xFF0000ull) |
           ((v >> 40) & 0xFF00ull) | (v >> 56);
#endif
}

struct BitReader {
    const uint8_t* data;
    size_t size;        // bytes
    size_t pos;         // next byte to load
    uint64_t cache;     // MSB-aligned
    int bits;           // valid bits in cache

    void init(const uint8_t* d, size_t n) {
        data = d; size = n; pos = 0; cache = 0; bits = 0;
    }
    inline void refill() {
        if (bits > 32) return;
        if (pos + 8 <= size) {
            // fast path: one 8-byte load; accept only whole bytes so the
            // remainder is re-read by the next refill
            uint64_t v = br_load_be64(data + pos);
            int add = (64 - bits) & ~7;   // whole bytes we can accept
            int extra = 64 - bits - add;  // bits of v we must NOT commit
            cache |= (v >> bits) & (~0ull << extra);
            pos += add >> 3;
            bits += add;
        } else {
            while (bits <= 56) {
                uint64_t b = pos < size ? data[pos] : 0;
                ++pos;
                cache |= b << (56 - bits);
                bits += 8;
            }
        }
    }
    inline uint32_t peek(int n) {
        refill();
        return (uint32_t)(cache >> (64 - n));
    }
    inline void skip(int n) {
        cache <<= n;
        bits -= n;
    }
    inline uint32_t get(int n) {
        if (n == 0) return 0;
        uint32_t v = peek(n);
        skip(n);
        return v;
    }
    // read without refilling — caller guarantees a prior peek left
    // enough cached bits (peek(16) leaves >= 41 spare)
    inline uint32_t get_cached(int n) {
        if (n == 0) return 0;
        uint32_t v = (uint32_t)(cache >> (64 - n));
        skip(n);
        return v;
    }
    // bits consumed from the start of the buffer
    inline size_t consumed() const { return pos * 8 - (size_t)bits; }
    inline bool overread() const { return consumed() > size * 8 + 64; }
};
