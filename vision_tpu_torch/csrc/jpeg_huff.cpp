// Huffman entropy decoding of a sequential (baseline or extended) JPEG scan,
// for `vision_tpu_torch/scene/imageio.py` `read_jpeg`, which parses the
// markers and does the rest (dequantisation, the integer IDCT, upsampling
// and the colour conversion) in numpy. Decoding is bit serial, so it lives
// here: in Python it costs about a microsecond a bit.
//
// As libjpeg decodes: 0xFF 0x00 is a stuffed 0xFF; a marker met inside the
// data ends it and zeros are read in its place; at each restart interval
// the bit buffer is dropped, the DC predictions reset, and the RSTn marker
// skipped.
//
// C ABI, bound with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries: a corrupt run past 63 lands on 63, as in libjpeg
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Bits {
  const uint8_t *p, *end;
  uint64_t acc = 0;
  int n = 0;
  bool at_marker = false;

  void fill() {
    while (n <= 56) {
      uint32_t c = 0;
      if (!at_marker && p < end) {
        c = *p;
        if (c == 0xFF) {
          uint32_t next = p + 1 < end ? p[1] : 0xD9;
          if (next == 0x00) {
            p += 2;
          } else {
            at_marker = true;  // leave p on the marker; feed zeros
            c = 0;
          }
        } else {
          ++p;
        }
      }
      acc |= (uint64_t)c << (56 - n);
      n += 8;
    }
  }
  uint32_t peek16() {
    if (n < 16) fill();
    return (uint32_t)(acc >> 48);
  }
  void skip(int k) {
    acc <<= k;
    n -= k;
  }
  int32_t get(int k) {
    if (k == 0) return 0;
    if (n < k) fill();
    int32_t v = (int32_t)(acc >> (64 - k));
    skip(k);
    return v;
  }
};

// A 16-bit lookup: entry = length << 8 | value, 0 for no code.
struct Table {
  std::vector<uint16_t> lut;
  bool build(const uint8_t *bits, const uint8_t *vals) {
    lut.assign(1 << 16, 0);
    uint32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i) {
        if (code >= (1u << len)) return false;
        uint32_t lo = code << (16 - len), hi = (code + 1) << (16 - len);
        for (uint32_t c = lo; c < hi; ++c)
          lut[c] = (uint16_t)(len << 8 | vals[k]);
        ++code;
        ++k;
      }
      code <<= 1;
    }
    return true;
  }
};

inline int decode(Bits &b, const Table &t) {
  uint16_t e = t.lut[b.peek16()];
  if (e == 0) return -1;
  b.skip(e >> 8);
  return e & 0xFF;
}

inline int32_t extend(int32_t v, int s) {
  return v < (1 << (s - 1)) ? v + (int32_t)((~0u) << s) + 1 : v;
}

}  // namespace

extern "C" {

// Decode one scan of `ncomp` components into their coefficient planes.
//   data, len: the bytes from just after the SOS header to the end of file
//   comp: 7 int32 a component: DC table, AC table (0-3), h, v (its blocks
//     in an MCU), the blocks a row of its plane, and for a one-component
//     scan the blocks wide and high it codes
//   coef: a component's plane, int16 [rows][blocks a row][64], natural order
//   bits: 8 tables x 16 code counts (DC 0-3, then AC 0-3); vals: 8 x 256
//   mcux, mcuy: MCUs of an interleaved scan; restart: MCUs an interval (0 none)
// Returns the offset of the marker that ends the scan, or -1 for a bad
// Huffman code, -2 for a bad table, -3 for a missing restart marker.
int64_t vt_jpeg_decode_scan(const uint8_t *data, int64_t len, int32_t ncomp,
                            const int32_t *comp, int16_t **coef,
                            const uint8_t *bits, const uint8_t *vals,
                            int32_t mcux, int32_t mcuy, int32_t restart) {
  Table tables[8];
  bool used[8] = {false};
  for (int c = 0; c < ncomp; ++c) {
    used[comp[c * 7]] = true;
    used[4 + comp[c * 7 + 1]] = true;
  }
  for (int t = 0; t < 8; ++t)
    if (used[t] && !tables[t].build(bits + 16 * t, vals + 256 * t)) return -2;

  Bits b{data, data + len};
  int32_t pred[4] = {0, 0, 0, 0};
  int64_t n_mcu, per_row;
  if (ncomp == 1) {
    per_row = comp[5];
    n_mcu = (int64_t)comp[5] * comp[6];
  } else {
    per_row = mcux;
    n_mcu = (int64_t)mcux * mcuy;
  }

  for (int64_t m = 0; m < n_mcu; ++m) {
    if (restart > 0 && m > 0 && m % restart == 0) {
      b.acc = 0;
      b.n = 0;
      b.at_marker = false;
      while (b.p < b.end && *b.p == 0xFF && b.p + 1 < b.end && b.p[1] == 0xFF)
        ++b.p;  // fill bytes
      if (b.p + 1 < b.end && b.p[0] == 0xFF && b.p[1] >= 0xD0 && b.p[1] <= 0xD7)
        b.p += 2;
      else
        return -3;
      memset(pred, 0, sizeof(pred));
    }
    int64_t my = m / per_row, mx = m % per_row;
    for (int c = 0; c < ncomp; ++c) {
      const int32_t *ci = comp + c * 7;
      const Table &dc = tables[ci[0]], &ac = tables[4 + ci[1]];
      int h = ncomp == 1 ? 1 : ci[2], v = ncomp == 1 ? 1 : ci[3];
      for (int by = 0; by < v; ++by) {
        for (int bx = 0; bx < h; ++bx) {
          int64_t row = my * v + by, col = mx * h + bx;
          int16_t *blk = coef[c] + (row * ci[4] + col) * 64;
          int s = decode(b, dc);
          if (s < 0) return -1;
          pred[c] += s ? extend(b.get(s), s) : 0;
          blk[0] = (int16_t)pred[c];
          for (int k = 1; k < 64; ++k) {
            int rs = decode(b, ac);
            if (rs < 0) return -1;
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
              k += r;
              blk[kNatural[k]] = (int16_t)extend(b.get(s), s);
            } else if (r == 15) {
              k += 15;
            } else {
              break;
            }
          }
        }
      }
    }
  }
  // the scan ends at the next marker (the reader never passes one)
  const uint8_t *q = b.p;
  while (q + 1 < b.end && !(q[0] == 0xFF && q[1] != 0x00 &&
                            !(q[1] >= 0xD0 && q[1] <= 0xD7) && q[1] != 0xFF))
    ++q;
  return (int64_t)(q - data);
}

}  // extern "C"
