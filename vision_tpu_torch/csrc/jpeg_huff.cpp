// Entropy decoding of a JPEG scan: Huffman-coded sequential (baseline or
// extended), progressive (spectral selection and successive approximation)
// or lossless (differences undifferenced here, serial as they are), and
// arithmetic-coded sequential or progressive (libjpeg's QM decoder), for
// `vision_tpu_torch/scene/imageio.py` `read_jpeg`, which parses the
// markers and does the rest (dequantisation, the integer IDCT, upsampling
// and the colour conversion) in numpy. Decoding is bit serial, so it lives
// here: in Python it costs about a microsecond a bit.
//
// As libjpeg decodes: 0xFF 0x00 is a stuffed 0xFF; a marker met inside the
// data ends it and zeros are read in its place; at each restart interval
// the bit buffer is dropped, the DC predictions and the end-of-band run
// reset, and the RSTn marker skipped.
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

// Decode one block of a scan into `blk` (natural order). Returns false on a
// bad Huffman code. Sequential scans (prog false) decode a whole block;
// progressive ones (prog true) one band of it as libjpeg's jdphuff.c does:
// DC first (Ah = 0) or refinement, AC first or refinement with end-of-band
// runs carried in `eobrun` across blocks.
struct Scan {
  bool prog;
  int ss, se, ah, al;
};

bool decode_block(Bits &b, const Table &dc, const Table &ac, const Scan &sc,
                  int32_t &pred, int32_t &eobrun, int16_t *blk) {
  if (!sc.prog || sc.ss == 0) {  // the DC coefficient
    if (sc.prog && sc.ah != 0) {
      if (b.get(1)) blk[0] |= (int16_t)(1 << sc.al);
    } else {
      int s = decode(b, dc);
      if (s < 0) return false;
      pred += s ? extend(b.get(s), s) : 0;
      blk[0] = (int16_t)(pred * (1 << sc.al));
    }
    if (sc.prog) return true;
  }
  if (!sc.prog) {
    for (int k = 1; k < 64; ++k) {
      int rs = decode(b, ac);
      if (rs < 0) return false;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(b.get(s), s);
      } else if (r == 15) {
        k += 15;
      } else {
        break;
      }
    }
    return true;
  }
  if (sc.ah == 0) {  // AC first
    if (eobrun > 0) {
      --eobrun;
      return true;
    }
    for (int k = sc.ss; k <= sc.se; ++k) {
      int rs = decode(b, ac);
      if (rs < 0) return false;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)(extend(b.get(s), s) * (1 << sc.al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += b.get(r);
        --eobrun;
        break;
      }
    }
    return true;
  }
  // AC refinement: one correction bit for each coefficient already nonzero
  // that the band passes, new coefficients of magnitude 1 << Al
  const int p1 = 1 << sc.al, m1 = -p1;
  int k = sc.ss;
  auto correct = [&](int16_t *c) {
    if (b.get(1) && (*c & p1) == 0) *c += (int16_t)(*c >= 0 ? p1 : m1);
  };
  if (eobrun == 0) {
    for (; k <= sc.se; ++k) {
      int rs = decode(b, ac);
      if (rs < 0) return false;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = b.get(1) ? p1 : m1;  // a new coefficient's size is always 1
      } else if (r != 15) {
        eobrun = 1 << r;
        if (r) eobrun += b.get(r);
        break;  // the rest of the block is the end-of-band run's
      }
      do {
        int16_t *c = blk + kNatural[k];
        if (*c != 0) {
          correct(c);
        } else if (--r < 0) {
          break;  // the zero coefficient that takes the new value
        }
        ++k;
      } while (k <= sc.se);
      if (s) blk[kNatural[k]] = (int16_t)s;
    }
  }
  if (eobrun > 0) {
    for (; k <= sc.se; ++k) {
      int16_t *c = blk + kNatural[k];
      if (*c != 0) correct(c);
    }
    --eobrun;
  }
  return true;
}

// Skip to the RSTn marker that ends a restart interval: from `p`, past
// fill bytes (and, for the arithmetic decoder, which reads ahead, any data
// before the marker, as libjpeg's next_marker does). Null if it is not
// there.
const uint8_t *skip_restart(const uint8_t *p, const uint8_t *end,
                            bool search) {
  while (search && p + 1 < end &&
         !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF))
    ++p;
  while (p < end && *p == 0xFF && p + 1 < end && p[1] == 0xFF) ++p;
  if (p + 1 < end && p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7)
    return p + 2;
  return nullptr;
}

// Walk the MCUs of a scan. `cd` decodes: cd.restart() at the end of each
// restart interval (false: the marker is missing), cd.block(c, blk) one
// block of the scan's component c (false: corrupt data), and cd.pos() is
// where it reads. Returns the offset of the marker that ends the scan, or
// -1 / -3 as vt_jpeg_decode_scan.
template <class Coder>
int64_t walk_scan(Coder &cd, const uint8_t *data, int32_t ncomp,
                  const int32_t *comp, int16_t **coef, int32_t mcux,
                  int32_t mcuy, int32_t restart) {
  int64_t n_mcu, per_row;
  if (ncomp == 1) {
    per_row = comp[5];
    n_mcu = (int64_t)comp[5] * comp[6];
  } else {
    per_row = mcux;
    n_mcu = (int64_t)mcux * mcuy;
  }
  for (int64_t m = 0; m < n_mcu; ++m) {
    if (restart > 0 && m > 0 && m % restart == 0 && !cd.restart()) return -3;
    int64_t my = m / per_row, mx = m % per_row;
    for (int c = 0; c < ncomp; ++c) {
      const int32_t *ci = comp + c * 7;
      int h = ncomp == 1 ? 1 : ci[2], v = ncomp == 1 ? 1 : ci[3];
      for (int by = 0; by < v; ++by) {
        for (int bx = 0; bx < h; ++bx) {
          int64_t row = my * v + by, col = mx * h + bx;
          if (!cd.block(c, coef[c] + (row * ci[4] + col) * 64)) return -1;
        }
      }
    }
  }
  // the scan ends at the next marker that is not a restart marker
  const uint8_t *q = cd.pos(), *end = cd.end();
  while (q + 1 < end && !(q[0] == 0xFF && q[1] != 0x00 &&
                          !(q[1] >= 0xD0 && q[1] <= 0xD7) && q[1] != 0xFF))
    ++q;
  return (int64_t)(q - data);
}

struct HuffCoder {
  Bits b;
  Table tables[8];
  const int32_t *comp;
  Scan sc;
  int32_t pred[4] = {0, 0, 0, 0};
  int32_t eobrun = 0;

  bool restart() {
    b.acc = 0;
    b.n = 0;
    b.at_marker = false;
    b.p = skip_restart(b.p, b.end, false);
    if (b.p == nullptr) return false;
    memset(pred, 0, sizeof(pred));
    eobrun = 0;
    return true;
  }
  bool block(int c, int16_t *blk) {
    const int32_t *ci = comp + c * 7;
    return decode_block(b, tables[ci[0]], tables[4 + ci[1]], sc, pred[c],
                        eobrun, blk);
  }
  const uint8_t *pos() const { return b.p; }
  const uint8_t *end() const { return b.end; }
};

int64_t decode_scan(const uint8_t *data, int64_t len, int32_t ncomp,
                    const int32_t *comp, int16_t **coef, const uint8_t *bits,
                    const uint8_t *vals, int32_t mcux, int32_t mcuy,
                    int32_t restart, const Scan &sc) {
  HuffCoder cd{Bits{data, data + len}, {}, comp, sc};
  bool used[8] = {false};
  bool need_dc = !sc.prog || (sc.ss == 0 && sc.ah == 0);
  bool need_ac = !sc.prog || sc.ss > 0;
  for (int c = 0; c < ncomp; ++c) {
    if (need_dc) used[comp[c * 7]] = true;
    if (need_ac) used[4 + comp[c * 7 + 1]] = true;
  }
  for (int t = 0; t < 8; ++t)
    if (used[t] && !cd.tables[t].build(bits + 16 * t, vals + 256 * t))
      return -2;
  return walk_scan(cd, data, ncomp, comp, coef, mcux, mcuy, restart);
}

// The QM coder's probability estimation (ITU-T T.81 Table D.2, libjpeg's
// jaricom.c): Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 |
// Next_Index_LPS; entry 113 is libjpeg's fixed estimate of 0.5.
#define V(i, a, b, c, d) (((int64_t)a << 16) | ((int64_t)c << 8) | ((int64_t)d << 7) | b)
const int64_t kAritab[114] = {
    V(0, 0x5a1d, 1, 1, 1),      V(1, 0x2586, 14, 2, 0),
    V(2, 0x1114, 16, 3, 0),     V(3, 0x080b, 18, 4, 0),
    V(4, 0x03d8, 20, 5, 0),     V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),     V(7, 0x006f, 28, 8, 0),
    V(8, 0x0036, 30, 9, 0),     V(9, 0x001a, 33, 10, 0),
    V(10, 0x000d, 35, 11, 0),   V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),   V(13, 0x0001, 12, 13, 0),
    V(14, 0x5a7f, 15, 15, 1),   V(15, 0x3f25, 36, 16, 0),
    V(16, 0x2cf2, 38, 17, 0),   V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),   V(19, 0x1182, 42, 20, 0),
    V(20, 0x0cef, 43, 21, 0),   V(21, 0x09a1, 45, 22, 0),
    V(22, 0x072f, 46, 23, 0),   V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),   V(25, 0x0303, 51, 26, 0),
    V(26, 0x0240, 52, 27, 0),   V(27, 0x01b1, 54, 28, 0),
    V(28, 0x0144, 56, 29, 0),   V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),   V(31, 0x008a, 60, 32, 0),
    V(32, 0x0068, 62, 33, 0),   V(33, 0x004e, 63, 34, 0),
    V(34, 0x003b, 32, 35, 0),   V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),   V(37, 0x484c, 64, 38, 0),
    V(38, 0x3a0d, 65, 39, 0),   V(39, 0x2ef1, 67, 40, 0),
    V(40, 0x261f, 68, 41, 0),   V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),   V(43, 0x1518, 72, 44, 0),
    V(44, 0x1177, 73, 45, 0),   V(45, 0x0e74, 74, 46, 0),
    V(46, 0x0bfb, 75, 47, 0),   V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),   V(49, 0x0706, 79, 50, 0),
    V(50, 0x05cd, 48, 51, 0),   V(51, 0x04de, 50, 52, 0),
    V(52, 0x040f, 50, 53, 0),   V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),   V(55, 0x025c, 53, 56, 0),
    V(56, 0x01f8, 54, 57, 0),   V(57, 0x01a4, 55, 58, 0),
    V(58, 0x0160, 56, 59, 0),   V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),   V(61, 0x00cb, 59, 62, 0),
    V(62, 0x00ab, 61, 63, 0),   V(63, 0x008f, 61, 32, 0),
    V(64, 0x5b12, 65, 65, 1),   V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),   V(67, 0x37d8, 82, 68, 0),
    V(68, 0x2fe8, 83, 69, 0),   V(69, 0x293c, 84, 70, 0),
    V(70, 0x2379, 86, 71, 0),   V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),   V(73, 0x174e, 72, 74, 0),
    V(74, 0x1424, 72, 75, 0),   V(75, 0x119c, 74, 76, 0),
    V(76, 0x0f6b, 74, 77, 0),   V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),   V(79, 0x0a40, 77, 48, 0),
    V(80, 0x5832, 80, 81, 1),   V(81, 0x4d1c, 88, 82, 0),
    V(82, 0x438e, 89, 83, 0),   V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),   V(85, 0x2eae, 92, 86, 0),
    V(86, 0x299a, 93, 87, 0),   V(87, 0x2516, 86, 71, 0),
    V(88, 0x5570, 88, 89, 1),   V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),   V(91, 0x3e22, 97, 92, 0),
    V(92, 0x3824, 99, 93, 0),   V(93, 0x32b4, 99, 94, 0),
    V(94, 0x2e17, 93, 86, 0),   V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),  V(97, 0x47e5, 102, 98, 0),
    V(98, 0x41cf, 103, 99, 0),  V(99, 0x3c3d, 104, 100, 0),
    V(100, 0x375e, 99, 93, 0),  V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0),
    V(104, 0x415e, 103, 99, 0), V(105, 0x5627, 105, 106, 1),
    V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0),
    V(110, 0x5a10, 110, 111, 1), V(111, 0x5522, 112, 109, 0),
    V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

// Arithmetic-coded scans (SOF9 sequential, SOF10 progressive), decoded as
// libjpeg's jdarith.c decodes them: statistics bins per table, reset at
// the scan's start and at each restart; a marker met in the data is
// legal and zeros are read in its place.
struct ArithCoder {
  const uint8_t *p, *end_;
  const int32_t *comp;
  Scan sc;
  const int32_t *cond;  // DC L[4], DC U[4], AC K[4] (the DAC segment's)
  int32_t ncomp;
  bool marker = false, dead = false;
  int64_t c = 0, a = 0;
  int ct = -16;  // two bytes to read before the first decision
  uint8_t dc_stats[4][64], ac_stats[4][256], fixed_bin = 113;
  int32_t last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};

  void reset() {
    c = a = 0;
    ct = -16;
    dead = false;
    memset(last_dc, 0, sizeof(last_dc));
    memset(dc_context, 0, sizeof(dc_context));
    for (int k = 0; k < ncomp; ++k) {
      memset(dc_stats[comp[k * 7]], 0, 64);
      memset(ac_stats[comp[k * 7 + 1]], 0, 256);
    }
  }
  int next_byte() {
    if (marker || p >= end_) {
      marker = true;
      return 0;
    }
    int d = *p;
    if (d != 0xFF) {
      ++p;
      return d;
    }
    const uint8_t *q = p + 1;
    while (q < end_ && *q == 0xFF) ++q;
    if (q < end_ && *q == 0) {  // a stuffed 0xFF
      p = q + 1;
      return 0xFF;
    }
    p = q - 1;  // on the marker's 0xFF: zeros from here
    marker = true;
    return 0;
  }
  int decode(uint8_t *st) {
    while (a < 0x8000) {  // renormalisation and data input (D.2.6)
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the 2 initial bytes
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    int nl = (int)(qe & 0xFF), nm = (int)((qe >> 8) & 0xFF);
    qe >>= 16;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  // F.23 and F.24: the magnitude of a nonzero value from its bin st (SP /
  // SN for DC, S0 + 2 for AC) on; x1, the first bin of the longer
  // categories; cat, the category's 2^(n-1) (the DC context reads it).
  // False on a magnitude past 2^15.
  bool magnitude(uint8_t *st, uint8_t *x1, bool ac, int32_t &cat,
                 int32_t &v) {
    int32_t m = decode(st);
    if (m != 0 && (!ac || decode(st))) {
      if (ac) m <<= 1;
      st = x1;
      while (decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    cat = v = m;
    st += 14;
    while (m >>= 1)
      if (decode(st)) v |= m;
    v += 1;
    return true;
  }
  bool restart() {
    p = skip_restart(p, end_, !marker);
    if (p == nullptr) return false;
    marker = false;
    reset();
    return true;
  }
  bool block(int ci, int16_t *blk);
  const uint8_t *pos() const { return p; }
  const uint8_t *end() const { return end_; }
};

// One block of component ci: a sequential block, or the band of a
// progressive scan. After a magnitude or spectral overflow nothing more is
// decoded until the next restart, as libjpeg does.
bool ArithCoder::block(int ci, int16_t *blk) {
  if (dead) return true;
  const int dtbl = comp[ci * 7], atbl = comp[ci * 7 + 1];
  if (!sc.prog || (sc.ss == 0 && sc.ah == 0)) {  // DC (a first scan)
    uint8_t *st = dc_stats[dtbl] + dc_context[ci];
    if (decode(st) == 0) {
      dc_context[ci] = 0;
    } else {
      int sign = decode(st + 1);
      int32_t m, v;
      if (!magnitude(st + 2 + sign, dc_stats[dtbl] + 20, false, m, v)) {
        dead = true;
        return true;
      }
      if (m < ((1 << cond[dtbl]) >> 1))
        dc_context[ci] = 0;
      else if (m > ((1 << cond[4 + dtbl]) >> 1))
        dc_context[ci] = 12 + sign * 4;
      else
        dc_context[ci] = 4 + sign * 4;
      v = sign ? -v : v;
      last_dc[ci] = sc.prog ? last_dc[ci] + v : (last_dc[ci] + v) & 0xFFFF;
    }
    blk[0] = (int16_t)(sc.prog ? last_dc[ci] * (1 << sc.al) : last_dc[ci]);
    if (sc.prog) return true;
  } else if (sc.ss == 0) {  // DC refinement: the next bit, at 0.5
    if (decode(&fixed_bin)) blk[0] |= (int16_t)(1 << sc.al);
    return true;
  }
  const int ss = sc.prog ? sc.ss : 1, se = sc.prog ? sc.se : 63;
  uint8_t *ac = ac_stats[atbl];
  if (sc.prog && sc.ah != 0) {  // AC refinement
    const int p1 = 1 << sc.al, m1 = -p1;
    int kex = se;  // the previous stage's end of block
    while (kex > 0 && blk[kNatural[kex]] == 0) --kex;
    for (int k = ss; k <= se; ++k) {
      uint8_t *st = ac + 3 * (k - 1);
      if (k > kex && decode(st)) break;  // end of block
      for (;;) {
        int16_t *coef = blk + kNatural[k];
        if (*coef != 0) {  // a correction bit
          if (decode(st + 2)) *coef += (int16_t)(*coef < 0 ? m1 : p1);
          break;
        }
        if (decode(st + 1)) {  // newly nonzero, its sign at 0.5
          *coef = (int16_t)(decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          dead = true;
          return true;
        }
      }
    }
    return true;
  }
  for (int k = ss; k <= se; ++k) {  // AC: sequential, or a first scan
    uint8_t *st = ac + 3 * (k - 1);
    if (decode(st)) break;  // end of block
    while (decode(st + 1) == 0) {
      st += 3;
      if (++k > se) {
        dead = true;
        return true;
      }
    }
    int sign = decode(&fixed_bin);
    int32_t m, v;
    if (!magnitude(st + 2, ac + (k <= cond[8 + atbl] ? 189 : 217), true, m,
                   v)) {
      dead = true;
      return true;
    }
    v = sign ? -v : v;
    blk[kNatural[k]] = (int16_t)(sc.prog ? v * (1 << sc.al) : v);
  }
  return true;
}

// A lossless (SOF3) scan, every component sampled 1x1 (an interleaved MCU
// is one sample of each): Huffman-coded differences undifferenced as
// libjpeg's jdlossls.c does, 16-bit modular, into each component's plane.
int64_t decode_lossless(const uint8_t *data, int64_t len, int32_t ncomp,
                        const int32_t *dc_table, uint16_t **out,
                        const uint8_t *bits, const uint8_t *vals, int32_t w,
                        int32_t h, int32_t restart, int32_t psv, int32_t pt) {
  Table tables[4];
  bool used[4] = {false};
  for (int c = 0; c < ncomp; ++c) used[dc_table[c]] = true;
  for (int t = 0; t < 4; ++t)
    if (used[t] && !tables[t].build(bits + 16 * t, vals + 256 * t)) return -2;
  if (restart > 0 && restart % w != 0) return -4;  // not whole rows
  const int64_t rows = restart > 0 ? restart / w : 0;
  const int32_t initial = 1 << (8 - pt - 1);
  Bits b{data, data + len};
  for (int64_t y = 0; y < h; ++y) {
    if (rows > 0 && y > 0 && y % rows == 0) {
      b.acc = 0;
      b.n = 0;
      b.at_marker = false;
      while (b.p < b.end && *b.p == 0xFF && b.p + 1 < b.end && b.p[1] == 0xFF)
        ++b.p;
      if (b.p + 1 < b.end && b.p[0] == 0xFF && b.p[1] >= 0xD0 && b.p[1] <= 0xD7)
        b.p += 2;
      else
        return -3;
    }
    // the first row of the image or of a restart interval: from the left
    const bool first = y == 0 || (rows > 0 && y % rows == 0);
    for (int64_t x = 0; x < w; ++x) {
      for (int c = 0; c < ncomp; ++c) {
        int s = decode(b, tables[dc_table[c]]);
        if (s < 0) return -1;
        int32_t diff = s == 0 ? 0 : s == 16 ? 32768 : extend(b.get(s), s);
        uint16_t *row = out[c] + y * w;
        const uint16_t *up = y > 0 ? row - w : row;
        int32_t pred;
        if (first) {
          pred = x == 0 ? initial : row[x - 1];
        } else if (x == 0) {
          pred = up[0];
        } else {
          int32_t ra = row[x - 1], rb = up[x], rc = up[x - 1];
          switch (psv) {
            case 1: pred = ra; break;
            case 2: pred = rb; break;
            case 3: pred = rc; break;
            case 4: pred = ra + rb - rc; break;
            case 5: pred = ra + ((rb - rc) >> 1); break;
            case 6: pred = rb + ((ra - rc) >> 1); break;
            default: pred = (ra + rb) >> 1; break;
          }
        }
        row[x] = (uint16_t)((diff + pred) & 0xFFFF);
      }
    }
  }
  const uint8_t *q = b.p;
  while (q + 1 < b.end && !(q[0] == 0xFF && q[1] != 0x00 &&
                            !(q[1] >= 0xD0 && q[1] <= 0xD7) && q[1] != 0xFF))
    ++q;
  return (int64_t)(q - data);
}

// A scan's component rows as the coders index them: 1-4 components (the
// size of their per-component state), each table 0-3. `stride`: int32 a row.
bool valid_scan(int32_t ncomp, const int32_t *comp, int stride, int tables) {
  if (ncomp < 1 || ncomp > 4) return false;
  for (int c = 0; c < ncomp; ++c)
    for (int t = 0; t < tables; ++t)
      if (comp[c * stride + t] < 0 || comp[c * stride + t] > 3) return false;
  return true;
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
//   prog: 0 for a sequential scan (the whole of each block), 1 for one scan
//     of a progressive file: the band ss..se at successive approximation
//     ah (0 on a first scan), al; its coefficients add to the planes'
// Returns the offset of the marker that ends the scan, or -1 for a bad
// Huffman code, -2 for a bad table, -3 for a missing restart marker, -5
// for a scan of no or more than 4 components or a table outside 0-3.
int64_t vt_jpeg_decode_scan(const uint8_t *data, int64_t len, int32_t ncomp,
                            const int32_t *comp, int16_t **coef,
                            const uint8_t *bits, const uint8_t *vals,
                            int32_t mcux, int32_t mcuy, int32_t restart,
                            int32_t prog, int32_t ss, int32_t se, int32_t ah,
                            int32_t al) {
  if (!valid_scan(ncomp, comp, 7, 2)) return -5;
  return decode_scan(data, len, ncomp, comp, coef, bits, vals, mcux, mcuy,
                     restart, Scan{prog != 0, ss, se, ah, al});
}

// Decode one lossless scan (1x1 sampling) into uint16 planes [h][w] of its
// `ncomp` components (their DC tables in `dc_table`): predictor psv (1-7),
// point transform pt, restart every `restart` MCUs (whole rows). Returns as
// vt_jpeg_decode_scan, or -4 for a restart interval that is not whole rows.
int64_t vt_jpeg_decode_lossless(const uint8_t *data, int64_t len,
                                int32_t ncomp, const int32_t *dc_table,
                                uint16_t **out, const uint8_t *bits,
                                const uint8_t *vals, int32_t w, int32_t h,
                                int32_t restart, int32_t psv, int32_t pt) {
  if (!valid_scan(ncomp, dc_table, 1, 1)) return -5;
  return decode_lossless(data, len, ncomp, dc_table, out, bits, vals, w, h,
                         restart, psv, pt);
}

// Decode one arithmetic-coded scan (SOF9, or SOF10 with prog = 1), with
// the arguments of vt_jpeg_decode_scan less the Huffman tables, plus cond:
// 12 int32, the DAC segment's DC conditioning L and U of tables 0-3, then
// AC K of tables 0-3 (T.81's defaults 0, 1, 5).
int64_t vt_jpeg_decode_arith_scan(const uint8_t *data, int64_t len,
                                  int32_t ncomp, const int32_t *comp,
                                  int16_t **coef, const int32_t *cond,
                                  int32_t mcux, int32_t mcuy,
                                  int32_t restart, int32_t prog, int32_t ss,
                                  int32_t se, int32_t ah, int32_t al) {
  if (!valid_scan(ncomp, comp, 7, 2)) return -5;
  ArithCoder cd{data, data + len, comp, Scan{prog != 0, ss, se, ah, al}, cond,
                ncomp};
  cd.reset();
  return walk_scan(cd, data, ncomp, comp, coef, mcux, mcuy, restart);
}

}  // extern "C"
