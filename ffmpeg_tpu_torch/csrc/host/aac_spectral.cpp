// AAC spectral (quantized coefficient) Huffman decode: the port's own
// copy of csrc/aac_spectral.cpp (built by ffmpeg_tpu_torch/native.py).
// Exact port of the Python walker kept beside it as its plain version
// (codecs/aac.py decode_spectral_plain); the LUT banks arrive from the
// Python side (aac.py _SPECTRAL_LUTS), so there is one table source.
//
// ABI:
//   aac_decode_spectral(data, nbits, pos, band_cb, swb_offset,
//                       group_len, ng, max_sfb, eight_short,
//                       lut_sym, lut_len, lut_off, lut_maxlen, out)
// Returns the new bit position, or -1 on a bad code / overread.

#include <cstdint>
#include <cstring>

namespace {

struct Bits {
  const uint8_t *data;
  long nbits, pos;
  bool bad = false;

  // MSB-first peek with zero padding past EOF (mirrors
  // codecs/bitstream.py BitReader.peek; nbits is byte-aligned there,
  // so missing bytes read as zero)
  uint32_t peek(int n) {
    long start = pos >> 3;
    int head = (int)(pos & 7);
    int need = (head + n + 7) >> 3;
    long nbytes = (nbits + 7) >> 3;
    uint64_t acc = 0;
    for (int i = 0; i < need; i++) {
      uint8_t byte = (start + i) < nbytes ? data[start + i] : 0;
      acc = (acc << 8) | byte;
    }
    int total = need * 8;
    return (uint32_t)((acc >> (total - head - n)) &
                      ((n >= 32) ? 0xFFFFFFFFu : ((1u << n) - 1)));
  }

  int get(int n) {
    if (pos + n > nbits) { bad = true; return 0; }
    uint32_t v = peek(n);
    pos += n;
    return (int)v;
  }

  int get1() { return get(1); }
};

}  // namespace

extern "C" {

long aac_decode_spectral(const uint8_t *data, long nbits, long pos,
                         const int32_t *band_cb,
                         const int32_t *swb_offset,
                         const int32_t *group_len, int ng,
                         int max_sfb, int eight_short,
                         const int32_t *lut_sym,
                         const uint8_t *lut_len,
                         const int32_t *lut_off,
                         const int32_t *lut_maxlen, int32_t *out) {
  Bits b{data, nbits, pos};
  // codebook properties (aac.py _CB_INFO): dim, signed, lav
  static const int DIM[12] = {0, 4, 4, 4, 4, 2, 2, 2, 2, 2, 2, 2};
  static const int SGN[12] = {0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0};
  static const int LAV[12] = {0, 1, 1, 2, 2, 4, 4, 7, 7, 12, 12, 16};
  long base = 0;
  for (int g = 0; g < ng; g++) {
    int glen = group_len[g];
    for (int sfb = 0; sfb < max_sfb; sfb++) {
      int cb = band_cb[g * max_sfb + sfb];
      int lo = swb_offset[sfb], hi = swb_offset[sfb + 1];
      if (cb == 0 || cb == 13 || cb == 14 || cb == 15) continue;
      if (cb < 1 || cb > 11) return -1;
      int dim = DIM[cb], sgn = SGN[cb], lav = LAV[cb];
      const int32_t *sym = lut_sym + lut_off[cb - 1];
      const uint8_t *len = lut_len + lut_off[cb - 1];
      int maxlen = lut_maxlen[cb - 1];
      for (int w = 0; w < glen; w++) {
        long off = base + (long)w * 128 + lo;
        int n = hi - lo;
        for (int k = 0; k < n; k += dim) {
          uint32_t look = b.peek(maxlen);
          int l = len[look];
          if (l == 0 || b.pos + l > b.nbits) return -1;
          b.pos += l;
          int idx = sym[look];
          int vals[4];
          if (dim == 4) {
            if (sgn) {
              vals[0] = idx / 27 % 3 - 1;
              vals[1] = idx / 9 % 3 - 1;
              vals[2] = idx / 3 % 3 - 1;
              vals[3] = idx % 3 - 1;
            } else {
              vals[0] = idx / 27 % 3;
              vals[1] = idx / 9 % 3;
              vals[2] = idx / 3 % 3;
              vals[3] = idx % 3;
            }
          } else {
            int m = (cb == 11) ? lav + 1
                               : (sgn ? 2 * lav + 1 : lav + 1);
            if (sgn) {
              vals[0] = idx / m - lav;
              vals[1] = idx % m - lav;
            } else {
              vals[0] = idx / m;
              vals[1] = idx % m;
            }
          }
          if (!sgn) {
            for (int i = 0; i < dim; i++)
              if (vals[i] && b.get1()) vals[i] = -vals[i];
          }
          if (cb == 11) {
            for (int i = 0; i < dim; i++) {
              int v = vals[i];
              if (v == 16 || v == -16) {
                int nb = 4;
                while (b.get1()) nb++;
                if (nb > 30 || b.bad) return -1;
                long esc = (long)b.get(nb) | (1L << nb);
                vals[i] = (int)(v > 0 ? esc : -esc);
              }
            }
          }
          if (b.bad) return -1;
          for (int i = 0; i < dim; i++)
            if (k + i < n) out[off + k + i] = vals[i];
        }
      }
    }
    base += eight_short ? 128L * glen : 1024L;
  }
  return b.pos;
}

}  // extern "C"
