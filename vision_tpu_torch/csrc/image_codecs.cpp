// The serial stages of the image codecs of
// `vision_tpu_torch/scene/imageio.py`: OpenEXR's Huffman coder (PIZ and
// DWA's AC coefficients), OpenEXR's byte run-length coding (RLE and DWA's
// RLE channels), DWA's run-length coding of AC coefficients, LZW (TIFF's,
// most significant bit first, and GIF's and TIFF's old style, least
// significant bit first), TIFF's PackBits, and the BC7 and BC6H blocks of
// DDS files (`scene/pilread.py`). Each walks its input a bit
// or a byte at a time, so it lives here: in Python it costs about a
// microsecond a step. The vectorisable stages (PIZ's wavelet and lookup
// table, PXR24's byte planes, B44's blocks, DWA's inverse DCT, the
// predictors) stay in numpy.
//
// Each function decodes as the reference library does (libOpenEXR 3.1's
// ImfHuf.cpp, ImfRle.cpp and ImfDwaCompressor.cpp; libtiff's tif_lzw.c
// and tif_packbits.c; PIL's GifDecode.c and BcnDecode.c) and returns a
// negative code where it throws or stops.
//
// C ABI, bound with ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// OpenEXR Huffman (ImfHuf.cpp)
// ---------------------------------------------------------------------------

const int kEncBits = 16;                   // HUF_ENCBITS
const int kDecBits = 14;                   // HUF_DECBITS
const int kEncSize = (1 << kEncBits) + 1;  // HUF_ENCSIZE
const int kDecSize = 1 << kDecBits;
const int kDecMask = kDecSize - 1;
const int kShortZeroRun = 59;
const int kLongZeroRun = 63;
const int kShortestLongRun = 2 + kLongZeroRun - kShortZeroRun;

struct HufDec {
  int len = 0;            // a short code's length, 0 for a long code's slot
  int lit = 0;            // a short code's symbol, or the long codes' count
  std::vector<int> p;     // the symbols of the long codes through this slot
};

inline uint64_t get_bits(int n, uint64_t &c, int &lc, const uint8_t *&in) {
  while (lc < n) {
    c = (c << 8) | *in++;
    lc += 8;
  }
  lc -= n;
  return (c >> lc) & ((uint64_t(1) << n) - 1);
}

// the code-length table -> (code << 6 | length) of each symbol
void canonical_codes(std::vector<uint64_t> &hcode) {
  uint64_t n[59] = {0};
  for (int i = 0; i < kEncSize; ++i) n[hcode[i]] += 1;
  uint64_t c = 0;
  for (int i = 58; i > 0; --i) {
    uint64_t nc = (c + n[i]) >> 1;
    n[i] = c;
    c = nc;
  }
  for (int i = 0; i < kEncSize; ++i) {
    int l = int(hcode[i]);
    if (l > 0) hcode[i] = l | (n[l]++ << 6);
  }
}

bool unpack_enc_table(const uint8_t *&p, int64_t ni, int im, int iM,
                      std::vector<uint64_t> &hcode) {
  const uint8_t *start = p;
  uint64_t c = 0;
  int lc = 0;
  for (; im <= iM; im++) {
    if (p - start >= ni) return false;
    uint64_t l = hcode[im] = get_bits(6, c, lc, p);
    if (l == kLongZeroRun) {
      if (p - start > ni) return false;
      int zerun = int(get_bits(8, c, lc, p)) + kShortestLongRun;
      if (im + zerun > iM + 1) return false;
      while (zerun--) hcode[im++] = 0;
      im--;
    } else if (l >= (uint64_t)kShortZeroRun) {
      int zerun = int(l) - kShortZeroRun + 2;
      if (im + zerun > iM + 1) return false;
      while (zerun--) hcode[im++] = 0;
      im--;
    }
  }
  canonical_codes(hcode);
  return true;
}

bool build_dec_table(const std::vector<uint64_t> &hcode, int im, int iM,
                     std::vector<HufDec> &hdec) {
  for (; im <= iM; im++) {
    uint64_t c = hcode[im] >> 6;
    int l = int(hcode[im] & 63);
    if (c >> l) return false;  // a code longer than its length
    if (l > kDecBits) {
      HufDec &pl = hdec[c >> (l - kDecBits)];
      if (pl.len) return false;
      pl.lit++;
      pl.p.push_back(im);
    } else if (l) {
      size_t base = size_t(c) << (kDecBits - l);
      for (size_t i = 0; i < (size_t(1) << (kDecBits - l)); ++i) {
        HufDec &pl = hdec[base + i];
        if (pl.len || !pl.p.empty()) return false;
        pl.len = l;
        pl.lit = im;
      }
    }
  }
  return true;
}

// getCode: a symbol, or the run-length symbol's repeat of the last value
inline bool put_code(int po, int rlc, uint64_t &c, int &lc, const uint8_t *&in,
                     uint16_t *&out, uint16_t *ob, uint16_t *oe) {
  if (po == rlc) {
    if (lc < 8) {
      c = (c << 8) | *in++;
      lc += 8;
    }
    lc -= 8;
    int cs = uint8_t(c >> lc);
    if (out + cs > oe || out - 1 < ob) return false;
    uint16_t s = out[-1];
    while (cs-- > 0) *out++ = s;
  } else if (out < oe) {
    *out++ = uint16_t(po);
  } else {
    return false;
  }
  return true;
}

int64_t huf_decode(const std::vector<uint64_t> &hcode,
                   const std::vector<HufDec> &hdec, const uint8_t *in,
                   int64_t ni, int rlc, int64_t no, uint16_t *out) {
  uint64_t c = 0;
  int lc = 0;
  uint16_t *outb = out, *oe = out + no;
  const uint8_t *ie = in + (ni + 7) / 8;
  while (in < ie) {
    c = (c << 8) | *in++;
    lc += 8;
    while (lc >= kDecBits) {
      const HufDec &pl = hdec[(c >> (lc - kDecBits)) & kDecMask];
      if (pl.len) {
        lc -= pl.len;
        if (lc < 0) return -1;
        if (!put_code(pl.lit, rlc, c, lc, in, out, outb, oe)) return -1;
      } else {
        if (pl.p.empty()) return -1;
        int j = 0;
        for (; j < pl.lit; j++) {
          int l = int(hcode[pl.p[j]] & 63);
          while (lc < l && in < ie) {
            c = (c << 8) | *in++;
            lc += 8;
          }
          if (lc >= l) {
            if ((hcode[pl.p[j]] >> 6) ==
                ((c >> (lc - l)) & ((uint64_t(1) << l) - 1))) {
              lc -= l;
              if (!put_code(pl.p[j], rlc, c, lc, in, out, outb, oe)) return -1;
              break;
            }
          }
        }
        if (j == pl.lit) return -1;
      }
    }
  }
  int i = (8 - int(ni)) & 7;
  c >>= i;
  lc -= i;
  while (lc > 0) {
    const HufDec &pl = hdec[(c << (kDecBits - lc)) & kDecMask];
    if (!pl.len) return -1;
    lc -= pl.len;
    if (lc < 0) return -1;
    if (!put_code(pl.lit, rlc, c, lc, in, out, outb, oe)) return -1;
  }
  return out - outb == no ? 0 : -1;
}

inline uint32_t read_u32(const uint8_t *p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

// ---------------------------------------------------------------------------
// LZW
// ---------------------------------------------------------------------------

// Reads codes of a growing width from a byte stream, either bit order.
struct CodeReader {
  const uint8_t *p, *end;
  bool msb;
  uint64_t acc = 0;
  int n = 0;
  // -1 once the data runs out
  int64_t get(int bits) {
    while (n < bits) {
      if (p >= end) return -1;
      if (msb) acc = (acc << 8) | *p++;
      else acc |= uint64_t(*p++) << n;
      n += 8;
    }
    int64_t v;
    if (msb) {
      v = (acc >> (n - bits)) & ((uint64_t(1) << bits) - 1);
    } else {
      v = acc & ((uint64_t(1) << bits) - 1);
      acc >>= bits;
    }
    n -= bits;
    return v;
  }
};

// ---------------------------------------------------------------------------
// BC7 and BC6H blocks, as PIL's BcnDecode.c decodes them (the BPTC formats
// of D3D11 and Khronos). The partition and anchor tables were read from
// PIL's decodes of blocks built to show them.
// ---------------------------------------------------------------------------

// the subset of each pixel (bit n: pixel n) of the 64 two-subset
// partitions; two bits a pixel for the three-subset ones
const uint16_t kPart2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t kPart3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};
// the pixel whose index has one bit less: subset 1 of the two-subset
// partitions, subsets 1 and 2 of the three-subset ones (subset 0: pixel 0)
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
    6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15};
const uint8_t kAnchor3a[64] = {
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
    3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
    8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
    3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3};
const uint8_t kAnchor3b[64] = {
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
    15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
    15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
    15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8};

const int kWeights2[4] = {0, 21, 43, 64};
const int kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51,
                           55, 60, 64};

const int *bptc_weights(int bits) {
  return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

// n bits of a 128-bit block from bit `at`, least significant first
inline int block_bits(const uint8_t *b, int at, int n) {
  int v = 0;
  for (int i = 0; i < n; ++i, ++at) v |= (b[at >> 3] >> (at & 7) & 1) << i;
  return v;
}

int subset_of(int ns, int part, int n) {
  if (ns == 2) return kPart2[part] >> n & 1;
  if (ns == 3) return kPart3[part] >> (2 * n) & 3;
  return 0;
}

bool is_anchor(int ns, int part, int subset, int n) {
  if (n == 0) return true;
  if (ns == 2) return subset == 1 && n == kAnchor2[part];
  if (ns == 3)
    return (subset == 1 && n == kAnchor3a[part]) ||
           (subset == 2 && n == kAnchor3b[part]);
  return false;
}

// BC7's modes: subsets, partition, rotation and index-selection bits,
// colour and alpha bits, p-bits per endpoint or per subset, index bits
struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

// one BC7 block -> 16 RGBA pixels
void bc7_block(const uint8_t *b, uint8_t *out) {
  int mode = 0;
  while (mode < 8 && !(b[0] >> mode & 1)) ++mode;
  if (mode == 8) {                      // no mode bit
    for (int n = 0; n < 16; ++n) {
      out[4 * n] = out[4 * n + 1] = out[4 * n + 2] = 0;
      out[4 * n + 3] = 255;
    }
    return;
  }
  const Bc7Mode &m = kBc7Modes[mode];
  int at = mode + 1;
  int part = block_bits(b, at, m.pb);
  at += m.pb;
  int rot = block_bits(b, at, m.rb);
  at += m.rb;
  int isel = block_bits(b, at, m.isb);
  at += m.isb;
  int nep = 2 * m.ns;
  int ep[6][4];
  for (int c = 0; c < 3; ++c)
    for (int i = 0; i < nep; ++i, at += m.cb) ep[i][c] = block_bits(b, at, m.cb);
  for (int i = 0; i < nep; ++i, at += m.ab)
    ep[i][3] = m.ab ? block_bits(b, at, m.ab) : 255;
  int cb = m.cb, ab = m.ab;
  if (m.epb || m.spb) {
    cb += 1;
    if (ab) ab += 1;
    for (int i = 0; i < nep; ++i) {
      int p = block_bits(b, at + (m.epb ? i : i / 2), 1);
      for (int c = 0; c < 3; ++c) ep[i][c] = ep[i][c] << 1 | p;
      if (m.ab) ep[i][3] = ep[i][3] << 1 | p;
    }
    at += m.epb ? nep : m.ns;
  }
  for (int i = 0; i < nep; ++i) {
    for (int c = 0; c < 3; ++c) {
      int v = (ep[i][c] << (8 - cb)) & 255;
      ep[i][c] = v | v >> cb;
    }
    if (m.ab) {
      int v = (ep[i][3] << (8 - ab)) & 255;
      ep[i][3] = v | v >> ab;
    }
  }
  int ci = at;                          // the first indices
  int ai = at + 16 * m.ib - m.ns;       // the second (modes 4 and 5)
  const int *w1 = bptc_weights(m.ib);
  const int *w2 = bptc_weights(m.ib2 ? m.ib2 : m.ib);
  for (int n = 0; n < 16; ++n) {
    int s = subset_of(m.ns, part, n);
    int nb = m.ib - is_anchor(m.ns, part, s, n);
    int wc = w1[block_bits(b, ci, nb)], wa = wc;
    ci += nb;
    if (m.ib2) {
      int nb2 = m.ib2 - (n == 0);
      int w = w2[block_bits(b, ai, nb2)];
      ai += nb2;
      if (isel) {
        wc = w;
      } else {
        wa = w;
      }
    }
    const int *e0 = ep[2 * s], *e1 = ep[2 * s + 1];
    uint8_t *px = out + 4 * n;
    for (int c = 0; c < 3; ++c)
      px[c] = uint8_t(((64 - wc) * e0[c] + wc * e1[c] + 32) >> 6);
    px[3] = uint8_t(((64 - wa) * e0[3] + wa * e1[3] + 32) >> 6);
    if (rot) std::swap(px[rot - 1], px[3]);
  }
}

// BC6H's 14 modes: the mode bits' value, subsets, transformed endpoints,
// endpoint bits, the deltas' bits of R, G, B, and where each field's bits
// lie after the mode bits: an entry is field << 4 | bit, the fields 0-11
// the endpoints' R, G, B (w, x, y, z), field 12 the partition
struct Bc6Mode {
  int value, ns, tr, epb, db[3];
  const char *layout;
};
const Bc6Mode kBc6Modes[14] = {
    {0, 2, 1, 10, {5, 5, 5},
     "\x74\x84\xb4\x00\x01\x02\x03\x04\x05\x06\x07\x08\x09\x10\x11\x12"
     "\x13\x14\x15\x16\x17\x18\x19\x20\x21\x22\x23\x24\x25\x26\x27\x28"
     "\x29\x30\x31\x32\x33\x34\xa4\x70\x71\x72\x73\x40\x41\x42\x43\x44"
     "\xb0\xa0\xa1\xa2\xa3\x50\x51\x52\x53\x54\xb1\x80\x81\x82\x83\x60"
     "\x61\x62\x63\x64\xb2\x90\x91\x92\x93\x94\xb3\xc0\xc1\xc2\xc3\xc4"},
    {1, 2, 1, 7, {6, 6, 6},
     "\x75\xa4\xa5\x00\x01\x02\x03\x04\x05\x06\xb0\xb1\x84\x10\x11\x12"
     "\x13\x14\x15\x16\x85\xb2\x74\x20\x21\x22\x23\x24\x25\x26\xb3\xb5"
     "\xb4\x30\x31\x32\x33\x34\x35\x70\x71\x72\x73\x40\x41\x42\x43\x44"
     "\x45\xa0\xa1\xa2\xa3\x50\x51\x52\x53\x54\x55\x80\x81\x82\x83\x60"
     "\x61\x62\x63\x64\x65\x90\x91\x92\x93\x94\x95\xc0\xc1\xc2\xc3\xc4"},
    {2, 2, 1, 11, {5, 4, 4},
     "\x00\x01\x02\x03\x04\x05\x06\x07\x08\x09\x10\x11\x12\x13\x14\x15"
     "\x16\x17\x18\x19\x20\x21\x22\x23\x24\x25\x26\x27\x28\x29\x30\x31"
     "\x32\x33\x34\x0a\x70\x71\x72\x73\x40\x41\x42\x43\x1a\xb0\xa0\xa1"
     "\xa2\xa3\x50\x51\x52\x53\x2a\xb1\x80\x81\x82\x83\x60\x61\x62\x63"
     "\x64\xb2\x90\x91\x92\x93\x94\xb3\xc0\xc1\xc2\xc3\xc4"},
    {6, 2, 1, 11, {4, 5, 4},
     "\x00\x01\x02\x03\x04\x05\x06\x07\x08\x09\x10\x11\x12\x13\x14\x15"
     "\x16\x17\x18\x19\x20\x21\x22\x23\x24\x25\x26\x27\x28\x29\x30\x31"
     "\x32\x33\x0a\xa4\x70\x71\x72\x73\x40\x41\x42\x43\x44\x1a\xa0\xa1"
     "\xa2\xa3\x50\x51\x52\x53\x2a\xb1\x80\x81\x82\x83\x60\x61\x62\x63"
     "\xb0\xb2\x90\x91\x92\x93\x74\xb3\xc0\xc1\xc2\xc3\xc4"},
    {10, 2, 1, 11, {4, 4, 5},
     "\x00\x01\x02\x03\x04\x05\x06\x07\x08\x09\x10\x11\x12\x13\x14\x15"
     "\x16\x17\x18\x19\x20\x21\x22\x23\x24\x25\x26\x27\x28\x29\x30\x31"
     "\x32\x33\x0a\x84\x70\x71\x72\x73\x40\x41\x42\x43\x1a\xb0\xa0\xa1"
     "\xa2\xa3\x50\x51\x52\x53\x54\x2a\x80\x81\x82\x83\x60\x61\x62\x63"
     "\xb1\xb2\x90\x91\x92\x93\xb4\xb3\xc0\xc1\xc2\xc3\xc4"},
    {14, 2, 1, 9, {5, 5, 5},
     "\x00\x01\x02\x03\x04\x05\x06\x07\x08\x84\x10\x11\x12\x13\x14\x15"
     "\x16\x17\x18\x74\x20\x21\x22\x23\x24\x25\x26\x27\x28\xb4\x30\x31"
     "\x32\x33\x34\xa4\x70\x71\x72\x73\x40\x41\x42\x43\x44\xb0\xa0\xa1"
     "\xa2\xa3\x50\x51\x52\x53\x54\xb1\x80\x81\x82\x83\x60\x61\x62\x63"
     "\x64\xb2\x90\x91\x92\x93\x94\xb3\xc0\xc1\xc2\xc3\xc4"},
    {18, 2, 1, 8, {6, 5, 5},
     "\x00\x01\x02\x03\x04\x05\x06\x07\xa4\x84\x10\x11\x12\x13\x14\x15"
     "\x16\x17\xb2\x74\x20\x21\x22\x23\x24\x25\x26\x27\xb3\xb4\x30\x31"
     "\x32\x33\x34\x35\x70\x71\x72\x73\x40\x41\x42\x43\x44\xb0\xa0\xa1"
     "\xa2\xa3\x50\x51\x52\x53\x54\xb1\x80\x81\x82\x83\x60\x61\x62\x63"
     "\x64\x65\x90\x91\x92\x93\x94\x95\xc0\xc1\xc2\xc3\xc4"},
    {22, 2, 1, 8, {5, 6, 5},
     "\x00\x01\x02\x03\x04\x05\x06\x07\xb0\x84\x10\x11\x12\x13\x14\x15"
     "\x16\x17\x75\x74\x20\x21\x22\x23\x24\x25\x26\x27\xa5\xb4\x30\x31"
     "\x32\x33\x34\xa4\x70\x71\x72\x73\x40\x41\x42\x43\x44\x45\xa0\xa1"
     "\xa2\xa3\x50\x51\x52\x53\x54\xb1\x80\x81\x82\x83\x60\x61\x62\x63"
     "\x64\xb2\x90\x91\x92\x93\x94\xb3\xc0\xc1\xc2\xc3\xc4"},
    {26, 2, 1, 8, {5, 5, 6},
     "\x00\x01\x02\x03\x04\x05\x06\x07\xb1\x84\x10\x11\x12\x13\x14\x15"
     "\x16\x17\x85\x74\x20\x21\x22\x23\x24\x25\x26\x27\xb5\xb4\x30\x31"
     "\x32\x33\x34\xa4\x70\x71\x72\x73\x40\x41\x42\x43\x44\xb0\xa0\xa1"
     "\xa2\xa3\x50\x51\x52\x53\x54\x55\x80\x81\x82\x83\x60\x61\x62\x63"
     "\x64\xb2\x90\x91\x92\x93\x94\xb3\xc0\xc1\xc2\xc3\xc4"},
    {30, 2, 0, 6, {6, 6, 6},
     "\x00\x01\x02\x03\x04\x05\xa4\xb0\xb1\x84\x10\x11\x12\x13\x14\x15"
     "\x75\x85\xb2\x74\x20\x21\x22\x23\x24\x25\xa5\xb3\xb5\xb4\x30\x31"
     "\x32\x33\x34\x35\x70\x71\x72\x73\x40\x41\x42\x43\x44\x45\xa0\xa1"
     "\xa2\xa3\x50\x51\x52\x53\x54\x55\x80\x81\x82\x83\x60\x61\x62\x63"
     "\x64\x65\x90\x91\x92\x93\x94\x95\xc0\xc1\xc2\xc3\xc4"},
    {3, 1, 0, 10, {10, 10, 10},
     "\x00\x01\x02\x03\x04\x05\x06\x07\x08\x09\x10\x11\x12\x13\x14\x15"
     "\x16\x17\x18\x19\x20\x21\x22\x23\x24\x25\x26\x27\x28\x29\x30\x31"
     "\x32\x33\x34\x35\x36\x37\x38\x39\x40\x41\x42\x43\x44\x45\x46\x47"
     "\x48\x49\x50\x51\x52\x53\x54\x55\x56\x57\x58\x59"},
    {7, 1, 1, 11, {9, 9, 9},
     "\x00\x01\x02\x03\x04\x05\x06\x07\x08\x09\x10\x11\x12\x13\x14\x15"
     "\x16\x17\x18\x19\x20\x21\x22\x23\x24\x25\x26\x27\x28\x29\x30\x31"
     "\x32\x33\x34\x35\x36\x37\x38\x0a\x40\x41\x42\x43\x44\x45\x46\x47"
     "\x48\x1a\x50\x51\x52\x53\x54\x55\x56\x57\x58\x2a"},
    {11, 1, 1, 12, {8, 8, 8},
     "\x00\x01\x02\x03\x04\x05\x06\x07\x08\x09\x10\x11\x12\x13\x14\x15"
     "\x16\x17\x18\x19\x20\x21\x22\x23\x24\x25\x26\x27\x28\x29\x30\x31"
     "\x32\x33\x34\x35\x36\x37\x0b\x0a\x40\x41\x42\x43\x44\x45\x46\x47"
     "\x1b\x1a\x50\x51\x52\x53\x54\x55\x56\x57\x2b\x2a"},
    {15, 1, 1, 16, {4, 4, 4},
     "\x00\x01\x02\x03\x04\x05\x06\x07\x08\x09\x10\x11\x12\x13\x14\x15"
     "\x16\x17\x18\x19\x20\x21\x22\x23\x24\x25\x26\x27\x28\x29\x30\x31"
     "\x32\x33\x0f\x0e\x0d\x0c\x0b\x0a\x40\x41\x42\x43\x1f\x1e\x1d\x1c"
     "\x1b\x1a\x50\x51\x52\x53\x2f\x2e\x2d\x2c\x2b\x2a"},
};

int sign_extend(int v, int bits) {
  return (v & (1 << (bits - 1))) ? v - (1 << bits) : v;
}

int bc6_unquantize(int v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << bits) - 1) return 0xFFFF;
    return ((v << 16) + 0x8000) >> bits;
  }
  if (bits >= 16) return v;
  int s = v < 0, x = s ? -v : v;
  if (x != 0) {
    if (x >= (1 << (bits - 1)) - 1)
      x = 0x7FFF;
    else
      x = ((x << 15) + 0x4000) >> (bits - 1);
  }
  return s ? -x : x;
}

float half_to_float(uint16_t h) {
  int e = h >> 10 & 31, m = h & 1023;
  float f = e == 0 ? std::ldexp(float(m), -24)
            : e == 31 ? (m ? NAN : INFINITY)
                      : std::ldexp(float(m | 1024), e - 25);
  return h & 0x8000 ? -f : f;
}

// one BC6H block -> 16 RGB pixels, each half clamped to [0, 1] and
// scaled to 8 bits
void bc6_block(const uint8_t *b, bool sign, uint8_t *out) {
  int mv = b[0] & 3;
  if (mv >= 2) mv = b[0] & 31;
  const Bc6Mode *m = nullptr;
  for (const Bc6Mode &x : kBc6Modes)
    if (x.value == mv) m = &x;
  if (!m) {                              // a reserved mode
    std::memset(out, 0, 48);
    return;
  }
  int at = mv < 2 ? 2 : 5;
  int n_layout = m->ns == 2 ? 82 - at : 65 - at;
  int f[13] = {0};
  for (int i = 0; i < n_layout; ++i, ++at) {
    int e = uint8_t(m->layout[i]);
    f[e >> 4] |= block_bits(b, at, 1) << (e & 15);
  }
  int nep = 2 * m->ns;
  int ep[4][3];
  for (int i = 0; i < nep; ++i)
    for (int c = 0; c < 3; ++c) ep[i][c] = f[3 * i + c];
  // PIL sign-extends the first endpoint (signed blocks) and the others by
  // their own bits (signed blocks, or deltas), adds the deltas and keeps
  // the sum's low bits, as 16-bit words: a transformed endpoint of a
  // signed block stays positive unless its bits are 16
  int mask = (1 << m->epb) - 1;
  for (int c = 0; c < 3; ++c) {
    if (sign) ep[0][c] = sign_extend(ep[0][c], m->epb);
    for (int i = 1; i < nep; ++i) {
      if (sign || m->tr) ep[i][c] = sign_extend(ep[i][c], m->db[c]);
      if (m->tr) {
        int v = (ep[0][c] + ep[i][c]) & mask;
        ep[i][c] = sign ? int16_t(uint16_t(v)) : v;
      }
    }
  }
  for (int i = 0; i < nep; ++i)
    for (int c = 0; c < 3; ++c) ep[i][c] = bc6_unquantize(ep[i][c], m->epb, sign);
  int part = f[12];
  int ib = m->ns == 2 ? 3 : 4;
  const int *w = bptc_weights(ib);
  int ci = at;
  for (int n = 0; n < 16; ++n) {
    int s = m->ns == 2 ? kPart2[part] >> n & 1 : 0;
    int nb = ib - (n == 0 || (s == 1 && n == kAnchor2[part]));
    int wt = w[block_bits(b, ci, nb)];
    ci += nb;
    for (int c = 0; c < 3; ++c) {
      int v = (ep[2 * s][c] * (64 - wt) + ep[2 * s + 1][c] * wt) >> 6;
      uint16_t h;
      if (!sign) {
        h = uint16_t((v * 31) >> 6);
      } else {
        h = v < 0 ? uint16_t(0x8000 | ((-v * 31) >> 5)) : uint16_t((v * 31) >> 5);
      }
      float x = half_to_float(h);
      out[3 * n + c] = x > 1.0f ? 255 : x > 0.0f ? uint8_t(x * 255.0f) : 0;
    }
  }
}


// ---------------------------------------------------------------------------
// OpenEXR's fast Huffman decoder (ImfFastHuf.cpp), which hufUncompress
// takes for a stream of more than 128 bits: it builds its codes from the
// code lengths itself, reads whole 64-bit words (zeros past the data's
// last byte) and stops when the output is full, so a corrupt stream can
// decode without an error where the classic decoder throws.
// ---------------------------------------------------------------------------

const int kTableBits = 12;                 // TABLE_LOOKUP_BITS
const int kMaxCodeLen = 58;                // MAX_CODE_LEN

struct FastHuf {
  int rle = 0, num_symbols = 0, min_len = 255, max_len = 0;
  std::vector<int> id_to_symbol;
  uint64_t lj_base[kMaxCodeLen + 1], lj_offset[kMaxCodeLen + 1];
  uint64_t table_min = 0;
  int table_symbol[1 << kTableBits], table_len[1 << kTableBits];
};

inline uint64_t read64(const uint8_t *c) {
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) v = v << 8 | c[i];
  return v;
}

// the constructor: false where it throws; `table` moves past the lengths
bool fast_huf_init(FastHuf &f, const uint8_t *&table, int64_t num_bytes,
                   int min_sym, int max_sym, int rle) {
  f.rle = rle;
  std::vector<uint64_t> symbols;
  uint64_t base[kMaxCodeLen + 1], offset[kMaxCodeLen + 1];
  uint64_t count[kMaxCodeLen + 1];
  for (int i = 0; i <= kMaxCodeLen; ++i) {
    count[i] = 0;
    base[i] = ~uint64_t(0);
    offset[i] = 0;
  }
  const uint8_t *cur = table;
  uint64_t bits = 0;
  int nbits = 0;
  auto read_bits = [&](int n) {
    while (nbits < n) {
      bits = bits << 8 | *cur++;
      nbits += 8;
    }
    nbits -= n;
    return (bits >> nbits) & ((uint64_t(1) << n) - 1);
  };
  for (uint64_t sym = uint64_t(min_sym); sym <= uint64_t(max_sym); ++sym) {
    if (cur - table >= num_bytes) return false;
    uint64_t len = read_bits(6);
    if (len < uint64_t(kShortZeroRun)) {
      if (len == 0) continue;
      if (int(len) < f.min_len) f.min_len = int(len);
      if (int(len) > f.max_len) f.max_len = int(len);
      count[len]++;
      symbols.push_back(sym << 6 | len);
    } else if (len == uint64_t(kLongZeroRun)) {
      if (cur - table >= num_bytes) return false;
      sym += read_bits(8) + kShortestLongRun - 1;
    } else {
      sym += len - kShortZeroRun + 1;
    }
    if (sym > uint64_t(max_sym)) return false;
  }
  for (int i = 0; i < kMaxCodeLen; ++i) f.num_symbols += int(count[i]);
  table = cur;
  if (f.max_len > 0) {
    std::vector<double> tmp_count(f.max_len + 1, 0.0);
    for (int l = f.min_len; l <= f.max_len; ++l)
      tmp_count[l] = double(count[l]) * double(2ll << (f.max_len - l));
    for (int l = f.min_len; l <= f.max_len; ++l) {
      double tmp = 0;
      for (int k = l + 1; k <= f.max_len; ++k) tmp += tmp_count[k];
      tmp /= double(2ll << (f.max_len - l));
      base[l] = uint64_t(std::ceil(tmp));
    }
    offset[f.max_len] = 0;
    for (int i = f.max_len - 1; i >= f.min_len; --i)
      offset[i] = offset[i + 1] + count[i + 1];
  }
  f.id_to_symbol.assign(f.num_symbols, 0);
  uint64_t mapping[kMaxCodeLen + 1];
  for (int i = 0; i <= kMaxCodeLen; ++i) mapping[i] = ~uint64_t(0);
  for (int i = f.min_len; i <= f.max_len; ++i) mapping[i] = offset[i];
  for (uint64_t s : symbols) {
    int len = int(s & 63);
    if (mapping[len] >= uint64_t(f.num_symbols)) return false;
    f.id_to_symbol[mapping[len]++] = int(s >> 6);
  }
  for (int i = 0; i <= kMaxCodeLen; ++i)
    f.lj_base[i] = base[i] != ~uint64_t(0) && i > 0 ? base[i] << (64 - i)
                                                    : ~uint64_t(0);
  for (int i = 0; i <= kMaxCodeLen; ++i)
    f.lj_offset[i] = offset[i] - (i > 0 ? f.lj_base[i] >> (64 - i) : 0);
  for (uint64_t i = 0; i < (uint64_t(1) << kTableBits); ++i) {
    uint64_t value = i << (64 - kTableBits);
    f.table_symbol[i] = 0xFFFF;
    f.table_len[i] = 0;
    for (int len = f.min_len; len <= f.max_len; ++len) {
      if (f.lj_base[len] <= value) {
        f.table_len[i] = len;
        uint64_t id = f.lj_offset[len] + (value >> (64 - len));
        if (id >= uint64_t(f.num_symbols)) return false;
        f.table_symbol[i] = f.id_to_symbol[id];
        break;
      }
    }
  }
  int min_idx = kTableBits;
  while (min_idx > 0 && f.lj_base[min_idx] == ~uint64_t(0)) --min_idx;
  f.table_min = f.lj_base[min_idx];
  return true;
}

void fast_refill(uint64_t &buffer, int num, uint64_t &back, int &back_bits,
                 const uint8_t *&cur, int64_t &left) {
  buffer |= back >> (64 - num);
  if (back_bits < num) {
    num -= back_bits;
    if (left >= 64) {
      back = read64(cur);
      back_bits = 64;
      cur += 8;
      left -= 64;
    } else {
      back = 0;
      back_bits = 64;
      int shift = 56;
      while (left > 0) {
        back |= uint64_t(*cur++) << shift;
        shift -= 8;
        left -= 8;
      }
      if (left < 0) left = 0;
    }
    buffer |= back >> (64 - num);
  }
  back = back_bits <= num ? 0 : back << num;
  back_bits -= num;
}

// FastHufDecoder::decode: 0, or -1 where it throws
int fast_huf_decode(const FastHuf &f, const uint8_t *src, int64_t nbits,
                    uint16_t *dst, int64_t n_dst) {
  const uint8_t *cur = src + 16;
  int64_t left = nbits - 128;
  uint64_t buffer = read64(src), back = read64(src + 8);
  int buffer_bits = 64, back_bits = 64;
  int64_t k = 0;
  while (k < n_dst) {
    int len, sym;
    if (buffer >= f.table_min) {
      int idx = int(buffer >> (64 - kTableBits));
      len = f.table_len[idx];
      sym = f.table_symbol[idx];
    } else {
      if (buffer_bits < 64) {
        fast_refill(buffer, 64 - buffer_bits, back, back_bits, cur, left);
        buffer_bits = 64;
      }
      len = kTableBits + 1;
      while (len <= f.max_len && f.lj_base[len] > buffer) ++len;
      if (len > f.max_len) return -1;
      uint64_t id = f.lj_offset[len] + (buffer >> (64 - len));
      if (id >= uint64_t(f.num_symbols)) return -1;
      sym = f.id_to_symbol[id];
    }
    buffer = len >= 64 ? 0 : buffer << len;
    buffer_bits -= len;
    if (sym == f.rle) {
      if (buffer_bits < 8) {
        fast_refill(buffer, 64 - buffer_bits, back, back_bits, cur, left);
        buffer_bits = 64;
      }
      int run = int(buffer >> 56);
      if (k < 1 || k + run > n_dst || run <= 0) return -1;
      for (int i = 0; i < run; ++i) dst[k + i] = dst[k - 1];
      k += run;
      buffer <<= 8;
      buffer_bits -= 8;
    } else {
      dst[k++] = uint16_t(sym);
    }
    if (buffer_bits < kTableBits) {
      fast_refill(buffer, 64 - buffer_bits, back, back_bits, cur, left);
      buffer_bits = 64;
    }
  }
  return left != 0 ? -1 : 0;
}

}  // namespace

extern "C" {

// OpenEXR's hufUncompress: `in` (n_in bytes: the 20-byte header, the
// packed code lengths, the codes) -> n_out 16-bit values. 0, or -1 where
// the library throws.
int64_t vt_exr_huf_decode(const uint8_t *in, int64_t n_in, uint16_t *out,
                          int64_t n_out) {
  if (n_in < 20) return n_out ? -1 : 0;
  // the table and code readers may look a byte or two past the data: give
  // them zeros there, as the library's buffer holds the next bytes
  std::vector<uint8_t> buf(in, in + n_in);
  buf.resize(buf.size() + 16, 0);
  uint32_t im = read_u32(buf.data()), iM = read_u32(buf.data() + 4);
  uint32_t nbits = read_u32(buf.data() + 12);
  if (im >= uint32_t(kEncSize) || iM >= uint32_t(kEncSize)) return -1;
  const uint8_t *ptr = buf.data() + 20;
  // nBits is an int there: past 2^31 it reads as negative
  uint64_t nbytes = (uint64_t(int64_t(int32_t(nbits))) + 7) / 8;
  if (int32_t(nbits) < 0 || 20 + nbytes > uint64_t(n_in)) return -1;
  if (int32_t(nbits) > 128) {             // FastHufDecoder
    FastHuf f;
    if (!fast_huf_init(f, ptr, n_in - 20, int(im), int(iM), int(iM)))
      return -1;
    if (uint64_t(ptr - buf.data()) + nbytes > uint64_t(n_in)) return -1;
    return fast_huf_decode(f, ptr, int32_t(nbits), out, n_out);
  }
  std::vector<uint64_t> hcode(kEncSize, 0);
  if (!unpack_enc_table(ptr, n_in - 20, int(im), int(iM), hcode)) return -1;
  int64_t left = n_in - (ptr - buf.data());
  if (left < 0 || int64_t(nbits) > 8 * left) return -1;
  std::vector<HufDec> hdec(kDecSize);
  if (!build_dec_table(hcode, int(im), int(iM), hdec)) return -1;
  return huf_decode(hcode, hdec, ptr, nbits, int(iM), n_out, out);
}

// OpenEXR's rleUncompress: a count byte c < 0 copies -c bytes, c >= 0
// repeats the next byte c + 1 times. The bytes written, or -1 past n_out.
int64_t vt_exr_rle_decode(const uint8_t *in, int64_t n_in, uint8_t *out,
                          int64_t n_out) {
  const int8_t *p = reinterpret_cast<const int8_t *>(in);
  const int8_t *end = p + n_in;
  int64_t k = 0;
  while (p < end) {
    if (*p < 0) {
      int count = -int(*p++);
      if (k + count > n_out || p + count > end) return -1;
      std::memcpy(out + k, p, count);
      k += count;
      p += count;
    } else {
      int count = int(*p++) + 1;
      if (k + count > n_out || p >= end) return -1;
      std::memset(out + k, uint8_t(*p++), count);
      k += count;
    }
  }
  return k;
}

// DWA's AC run-length coding of n_blocks blocks (ImfDwaCompressor.cpp
// unRleAc): 0xff00 ends a block, 0xffNN skips NN zeros, anything else is
// the next coefficient (a half in zig-zag order from index 1). Writes
// each block's 64 halves (index 0 untouched) and the zig-zag index of its
// last value written (0 for none); returns the values read, or -1 where
// the data runs out.
int64_t vt_dwa_unrle_ac(const uint16_t *ac, int64_t n_ac, int64_t n_blocks,
                        uint16_t *blocks, int32_t *last) {
  int64_t k = 0;
  for (int64_t b = 0; b < n_blocks; ++b) {
    uint16_t *blk = blocks + 64 * b;
    int comp = 1, last_nz = 0;
    while (comp < 64) {
      if (k >= n_ac) return -1;
      uint16_t v = ac[k++];
      if (v == 0xff00) {
        comp = 64;
      } else if ((v >> 8) == 0xff) {
        comp += v & 0xff;
      } else {
        last_nz = comp;
        blk[comp++] = v;
      }
    }
    last[b] = last_nz;
  }
  return k;
}

// LZW (TIFF, GIF) -> at most n_out bytes. msb: TIFF's bit order with its
// early width change (codes 256 clear, 257 end, 9 to 12 bits); else GIF's
// and old-style TIFF's (least significant bit first, clear 2^min_bits,
// widths from min_bits + 1 to 12, changed when the table fills a width).
// Returns the bytes written; -2 - k for a code not yet in the table after
// k bytes (both libraries stop with an error there; the k bytes stay in
// `out`). A stream that ends without its end code returns the bytes it
// gave.
int64_t vt_lzw_decode(const uint8_t *in, int64_t n_in, uint8_t *out,
                      int64_t n_out, int32_t min_bits, int32_t msb) {
  const int clear = 1 << min_bits, eoi = clear + 1;
  const int early = msb ? 1 : 0;
  std::vector<int32_t> prefix(4096), length(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  for (int i = 0; i < clear; ++i) {
    prefix[i] = -1;
    suffix[i] = first[i] = uint8_t(i);
    length[i] = 1;
  }
  CodeReader rd{in, in + n_in, msb != 0};
  int bits = min_bits + 1, next = eoi + 1, prev = -1;
  int64_t k = 0;
  std::vector<uint8_t> stack(4096);
  while (k < n_out) {
    int64_t code = rd.get(bits);
    if (code < 0 || code == eoi) break;
    if (code == clear) {
      bits = min_bits + 1;
      next = eoi + 1;
      prev = -1;
      continue;
    }
    int cur;
    if (prev < 0) {
      if (code >= next) return -2 - k;
      cur = int(code);
    } else if (code < next) {
      cur = int(code);
      if (next < 4096) {
        prefix[next] = prev;
        suffix[next] = first[cur];
        first[next] = first[prev];
        length[next] = length[prev] + 1;
        next++;
      }
    } else if (code == next && next < 4096) {
      prefix[next] = prev;
      suffix[next] = first[prev];
      first[next] = first[prev];
      length[next] = length[prev] + 1;
      cur = next++;
    } else {
      return -2 - k;
    }
    int n = length[cur];
    int c = cur;
    for (int i = n - 1; i >= 0; --i) {
      stack[i] = suffix[c];
      c = prefix[c];
    }
    int64_t take = n < n_out - k ? n : n_out - k;
    std::memcpy(out + k, stack.data(), take);
    k += take;
    prev = cur;
    if (next + early >= (1 << bits) && bits < 12) bits++;
  }
  return k;
}

// TIFF PackBits -> at most n_out bytes: a count byte n in 0..127 copies n
// + 1 bytes, -127..-1 repeats the next byte 1 - n times, -128 is skipped.
// Returns the bytes written (fewer where the data ends early).
int64_t vt_packbits_decode(const uint8_t *in, int64_t n_in, uint8_t *out,
                           int64_t n_out) {
  int64_t i = 0, k = 0;
  while (i < n_in && k < n_out) {
    int n = int8_t(in[i++]);
    if (n >= 0) {
      int64_t c = n + 1;
      if (c > n_in - i) c = n_in - i;
      if (c > n_out - k) c = n_out - k;
      std::memcpy(out + k, in + i, c);
      i += n + 1;
      k += c;
    } else if (n != -128) {
      if (i >= n_in) break;
      int64_t c = 1 - n;
      if (c > n_out - k) c = n_out - k;
      std::memset(out + k, in[i++], c);
      k += c;
    }
  }
  return k;
}

// n BC7 blocks -> n x 16 RGBA pixels
void vt_bc7_decode(const uint8_t *in, int64_t n, uint8_t *out) {
  for (int64_t i = 0; i < n; ++i) bc7_block(in + 16 * i, out + 64 * i);
}

// n BC6H blocks (signed or not) -> n x 16 RGB pixels
void vt_bc6h_decode(const uint8_t *in, int64_t n, int32_t sign,
                    uint8_t *out) {
  for (int64_t i = 0; i < n; ++i) bc6_block(in + 16 * i, sign != 0, out + 48 * i);
}

}  // extern "C"
