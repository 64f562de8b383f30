// The serial stages of the image codecs of
// `vision_tpu_torch/scene/imageio.py`: OpenEXR's Huffman coder (PIZ and
// DWA's AC coefficients), OpenEXR's byte run-length coding (RLE and DWA's
// RLE channels), DWA's run-length coding of AC coefficients, LZW (TIFF's,
// most significant bit first, and GIF's and TIFF's old style, least
// significant bit first), TIFF's PackBits and SGILog rows, and the BC7
// and BC6H blocks of DDS files (`scene/pilread.py`). Each walks its input
// a bit or a byte at a time, so it lives here: in Python it costs about a
// microsecond a step. The vectorisable stages (PIZ's wavelet and lookup
// table, PXR24's byte planes, B44's blocks, DWA's inverse DCT, the
// predictors) stay in numpy.
//
// Each function decodes as the reference library does (libOpenEXR 3.1's
// ImfHuf.cpp, ImfRle.cpp and ImfDwaCompressor.cpp; libtiff's tif_lzw.c,
// tif_packbits.c and tif_luv.c; PIL's GifDecode.c and BcnDecode.c) and
// returns a negative code where it throws or stops.
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

// ---------------------------------------------------------------------------
// CCITT RLE, RLEW, Group 3 and Group 4 (libtiff's tif_fax3.c / tif_fax3.h)
// ---------------------------------------------------------------------------
//
// The decoder keeps libtiff's state as libtiff keeps it: a bit accumulator
// filled a byte at a time with the first bit of the stream lowest (bytes
// bit-reversed), lookup tables of 7 (modes), 12 (white) and 13 (black) bits
// indexed by that accumulator, the run arrays of the current and reference
// rows side by side in one buffer that lives as long as the directory, and
// its macros' control flow: a bad code word ends the row (libtiff logs
// it and goes on), a row of the wrong length is cut or padded with white,
// the data's end pads with zero bits while any are left.

namespace {

enum FaxState { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW,
                S_TermB, S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL };

struct FaxEnt {
  uint8_t state = S_Null, width = 0;
  uint32_t param = 0;
};

struct FaxCode {
  const char *bits;
  uint32_t run;
};

const FaxCode kWhiteTerm[] = {
    {"00110101", 0}, {"000111", 1}, {"0111", 2}, {"1000", 3}, {"1011", 4},
    {"1100", 5}, {"1110", 6}, {"1111", 7}, {"10011", 8}, {"10100", 9},
    {"00111", 10}, {"01000", 11}, {"001000", 12}, {"000011", 13},
    {"110100", 14}, {"110101", 15}, {"101010", 16}, {"101011", 17},
    {"0100111", 18}, {"0001100", 19}, {"0001000", 20}, {"0010111", 21},
    {"0000011", 22}, {"0000100", 23}, {"0101000", 24}, {"0101011", 25},
    {"0010011", 26}, {"0100100", 27}, {"0011000", 28}, {"00000010", 29},
    {"00000011", 30}, {"00011010", 31}, {"00011011", 32}, {"00010010", 33},
    {"00010011", 34}, {"00010100", 35}, {"00010101", 36}, {"00010110", 37},
    {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41},
    {"00101011", 42}, {"00101100", 43}, {"00101101", 44}, {"00000100", 45},
    {"00000101", 46}, {"00001010", 47}, {"00001011", 48}, {"01010010", 49},
    {"01010011", 50}, {"01010100", 51}, {"01010101", 52}, {"00100100", 53},
    {"00100101", 54}, {"01011000", 55}, {"01011001", 56}, {"01011010", 57},
    {"01011011", 58}, {"01001010", 59}, {"01001011", 60}, {"00110010", 61},
    {"00110011", 62}, {"00110100", 63}};
const FaxCode kWhiteMakeUp[] = {
    {"11011", 64}, {"10010", 128}, {"010111", 192}, {"0110111", 256},
    {"00110110", 320}, {"00110111", 384}, {"01100100", 448},
    {"01100101", 512}, {"01101000", 576}, {"01100111", 640},
    {"011001100", 704}, {"011001101", 768}, {"011010010", 832},
    {"011010011", 896}, {"011010100", 960}, {"011010101", 1024},
    {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216},
    {"011011001", 1280}, {"011011010", 1344}, {"011011011", 1408},
    {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600},
    {"011000", 1664}, {"010011011", 1728}};
const FaxCode kBlackTerm[] = {
    {"0000110111", 0}, {"010", 1}, {"11", 2}, {"10", 3}, {"011", 4},
    {"0011", 5}, {"0010", 6}, {"00011", 7}, {"000101", 8}, {"000100", 9},
    {"0000100", 10}, {"0000101", 11}, {"0000111", 12}, {"00000100", 13},
    {"00000111", 14}, {"000011000", 15}, {"0000010111", 16},
    {"0000011000", 17}, {"0000001000", 18}, {"00001100111", 19},
    {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22},
    {"00000101000", 23}, {"00000010111", 24}, {"00000011000", 25},
    {"000011001010", 26}, {"000011001011", 27}, {"000011001100", 28},
    {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31},
    {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34},
    {"000011010011", 35}, {"000011010100", 36}, {"000011010101", 37},
    {"000011010110", 38}, {"000011010111", 39}, {"000001101100", 40},
    {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43},
    {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46},
    {"000001010111", 47}, {"000001100100", 48}, {"000001100101", 49},
    {"000001010010", 50}, {"000001010011", 51}, {"000000100100", 52},
    {"000000110111", 53}, {"000000111000", 54}, {"000000100111", 55},
    {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58},
    {"000000101011", 59}, {"000000101100", 60}, {"000001011010", 61},
    {"000001100110", 62}, {"000001100111", 63}};
const FaxCode kBlackMakeUp[] = {
    {"0000001111", 64}, {"000011001000", 128}, {"000011001001", 192},
    {"000001011011", 256}, {"000000110011", 320}, {"000000110100", 384},
    {"000000110101", 448}, {"0000001101100", 512}, {"0000001101101", 576},
    {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960},
    {"0000001110100", 1024}, {"0000001110101", 1088},
    {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344},
    {"0000001010100", 1408}, {"0000001010101", 1472},
    {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728}};
// the extended make-up codes, shared by both colours
const FaxCode kMakeUp[] = {
    {"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};

FaxEnt kMainTab[128], kWhiteTab[4096], kBlackTab[8192];
uint8_t kRev[256];

// every index of a `wid`-bit table whose low bits are `code` (its first
// bit lowest)
void fax_put(FaxEnt *tab, int wid, const char *code, int state,
             uint32_t param) {
  int n = int(std::strlen(code));
  uint32_t r = 0;
  for (int i = 0; i < n; ++i)
    if (code[i] == '1') r |= 1u << i;
  for (uint32_t h = 0; h < (1u << (wid - n)); ++h)
    tab[r | h << n] = FaxEnt{uint8_t(state), uint8_t(n), param};
}

bool fax_tables() {
  for (int i = 0; i < 256; ++i) {
    int r = 0;
    for (int b = 0; b < 8; ++b)
      if (i & (1 << b)) r |= 0x80 >> b;
    kRev[i] = uint8_t(r);
  }
  // libtiff's mkg3states: the mode codes, then EOL as 7 zero bits
  fax_put(kMainTab, 7, "0001", S_Pass, 0);
  fax_put(kMainTab, 7, "001", S_Horiz, 0);
  fax_put(kMainTab, 7, "1", S_V0, 0);
  fax_put(kMainTab, 7, "011", S_VR, 1);
  fax_put(kMainTab, 7, "000011", S_VR, 2);
  fax_put(kMainTab, 7, "0000011", S_VR, 3);
  fax_put(kMainTab, 7, "010", S_VL, 1);
  fax_put(kMainTab, 7, "000010", S_VL, 2);
  fax_put(kMainTab, 7, "0000010", S_VL, 3);
  fax_put(kMainTab, 7, "0000001", S_Ext, 0);
  fax_put(kMainTab, 7, "0000000", S_EOL, 0);
  for (const FaxCode &c : kWhiteMakeUp)
    fax_put(kWhiteTab, 12, c.bits, S_MakeUpW, c.run);
  for (const FaxCode &c : kMakeUp) {
    fax_put(kWhiteTab, 12, c.bits, S_MakeUp, c.run);
    fax_put(kBlackTab, 13, c.bits, S_MakeUp, c.run);
  }
  for (const FaxCode &c : kWhiteTerm)
    fax_put(kWhiteTab, 12, c.bits, S_TermW, c.run);
  fax_put(kWhiteTab, 12, "00000000000", S_EOL, 0);
  for (const FaxCode &c : kBlackMakeUp)
    fax_put(kBlackTab, 13, c.bits, S_MakeUpB, c.run);
  for (const FaxCode &c : kBlackTerm)
    fax_put(kBlackTab, 13, c.bits, S_TermB, c.run);
  fax_put(kBlackTab, 13, "00000000000", S_EOL, 0);
  return true;
}

// _TIFFFax3fillruns: white runs clear bits, black runs set them; a run
// past the row's end is cut there (in the run array too)
void fax_fillruns(uint8_t *buf, uint32_t *runs, uint32_t *erun,
                  uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int k = 0; k < 2; ++k) {
      uint32_t run = runs[k];
      if (x + run > lastx || run > lastx) run = runs[k] = lastx - x;
      for (uint32_t i = x; i < x + run; ++i) {
        if (k) buf[i >> 3] |= uint8_t(0x80 >> (i & 7));
        else buf[i >> 3] &= uint8_t(~(0x80 >> (i & 7)));
      }
      x += run;
    }
  }
}

struct Fax {
  const uint8_t *cp, *ep, *bp;
  int64_t parity;         // the strip's first byte's address, mod 2
  uint32_t BitAcc = 0;
  int BitsAvail = 0, EOLcnt = 0;
  uint32_t *runs;
  uint32_t nruns;
  uint32_t *curruns, *refruns = nullptr;
  uint32_t *noeol;        // libtiff's FAXMODE_NOEOL, kept by the directory
  int lastx;
};

#define GETBITS(n) (BitAcc & ((1u << (n)) - 1))
#define CLRBITS(n) do { BitsAvail -= (n); BitAcc >>= (n); } while (0)
#define EOD() (cp >= ep)
#define NEEDBITS8(n, L)                                                      \
  do {                                                                       \
    if (BitsAvail < (n)) {                                                   \
      if (EOD()) {                                                           \
        if (BitsAvail == 0) goto L;                                          \
        BitsAvail = (n);                                                     \
      } else {                                                               \
        BitAcc |= uint32_t(kRev[*cp++]) << BitsAvail;                        \
        BitsAvail += 8;                                                      \
      }                                                                      \
    }                                                                        \
  } while (0)
#define NEEDBITS16(n, L)                                                     \
  do {                                                                       \
    if (BitsAvail < (n)) {                                                   \
      if (EOD()) {                                                           \
        if (BitsAvail == 0) goto L;                                          \
        BitsAvail = (n);                                                     \
      } else {                                                               \
        BitAcc |= uint32_t(kRev[*cp++]) << BitsAvail;                        \
        if ((BitsAvail += 8) < (n)) {                                        \
          if (EOD()) {                                                       \
            BitsAvail = (n);                                                 \
          } else {                                                           \
            BitAcc |= uint32_t(kRev[*cp++]) << BitsAvail;                    \
            BitsAvail += 8;                                                  \
          }                                                                  \
        }                                                                    \
      }                                                                      \
    }                                                                        \
  } while (0)
#define LOOKUP8(wid, tab, L)                                                 \
  do {                                                                       \
    NEEDBITS8(wid, L);                                                       \
    te = &tab[GETBITS(wid)];                                                 \
    CLRBITS(te->width);                                                      \
  } while (0)
#define LOOKUP16(wid, tab, L)                                                \
  do {                                                                       \
    NEEDBITS16(wid, L);                                                      \
    te = &tab[GETBITS(wid)];                                                 \
    CLRBITS(te->width);                                                      \
  } while (0)
#define SETVALUE(x)                                                          \
  do {                                                                       \
    if (pa >= thisrun + s.nruns) return -1;                                  \
    *pa++ = uint32_t(RunLength + (x));                                       \
    a0 += (x);                                                               \
    RunLength = 0;                                                           \
  } while (0)
// the run array after a row: cut at, or padded with white to, lastx
#define CLEANUP_RUNS()                                                       \
  do {                                                                       \
    if (RunLength) SETVALUE(0);                                              \
    if (a0 != lastx) {                                                       \
      while (a0 > lastx && pa > thisrun) a0 -= int(*--pa);                   \
      if (a0 < lastx) {                                                      \
        if (a0 < 0) a0 = 0;                                                  \
        if ((pa - thisrun) & 1) SETVALUE(0);                                 \
        SETVALUE(lastx - a0);                                                \
      } else if (a0 > lastx) {                                               \
        SETVALUE(lastx);                                                     \
        SETVALUE(0);                                                         \
      }                                                                      \
    }                                                                        \
  } while (0)
// one row of white and black runs (T.4 1-D)
#define EXPAND1D(eoflab)                                                     \
  do {                                                                       \
    for (;;) {                                                               \
      for (;;) {                                                             \
        LOOKUP16(12, kWhiteTab, eof1d);                                      \
        switch (te->state) {                                                 \
          case S_EOL: EOLcnt = 1; goto done1d;                               \
          case S_TermW: SETVALUE(int(te->param)); goto doneWhite1d;          \
          case S_MakeUpW: case S_MakeUp:                                     \
            a0 += int(te->param); RunLength += int(te->param); break;        \
          default: goto done1d;                                              \
        }                                                                    \
      }                                                                      \
    doneWhite1d:                                                             \
      if (a0 >= lastx) goto done1d;                                          \
      for (;;) {                                                             \
        LOOKUP16(13, kBlackTab, eof1d);                                      \
        switch (te->state) {                                                 \
          case S_EOL: EOLcnt = 1; goto done1d;                               \
          case S_TermB: SETVALUE(int(te->param)); goto doneBlack1d;          \
          case S_MakeUpB: case S_MakeUp:                                     \
            a0 += int(te->param); RunLength += int(te->param); break;        \
          default: goto done1d;                                              \
        }                                                                    \
      }                                                                      \
    doneBlack1d:                                                             \
      if (a0 >= lastx) goto done1d;                                          \
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;                         \
    }                                                                        \
  eof1d:                                                                     \
    CLEANUP_RUNS();                                                          \
    goto eoflab;                                                             \
  done1d:                                                                    \
    CLEANUP_RUNS();                                                          \
  } while (0)
#define CHECK_B1                                                             \
  do {                                                                       \
    if (pa != thisrun)                                                       \
      while (b1 <= a0 && b1 < lastx) {                                       \
        if (pb + 1 >= s.refruns + s.nruns) return -1;                        \
        b1 += int(pb[0] + pb[1]);                                            \
        pb += 2;                                                             \
      }                                                                      \
  } while (0)
// one row of modes against the reference row (T.4 2-D, T.6)
#define EXPAND2D(eoflab)                                                     \
  do {                                                                       \
    while (a0 < lastx) {                                                     \
      if (pa >= thisrun + s.nruns) return -1;                                \
      LOOKUP8(7, kMainTab, eof2d);                                           \
      switch (te->state) {                                                   \
        case S_Pass:                                                         \
          CHECK_B1;                                                          \
          if (pb >= s.refruns + s.nruns) return -1;                          \
          b1 += int(*pb++);                                                  \
          RunLength += b1 - a0;                                              \
          a0 = b1;                                                           \
          b1 += int(*pb++);                                                  \
          break;                                                             \
        case S_Horiz:                                                        \
          if ((pa - thisrun) & 1) {                                          \
            for (;;) {                                                       \
              LOOKUP16(13, kBlackTab, eof2d);                                \
              switch (te->state) {                                           \
                case S_TermB: SETVALUE(int(te->param)); goto doneWhite2da;   \
                case S_MakeUpB: case S_MakeUp:                               \
                  a0 += int(te->param); RunLength += int(te->param); break;  \
                default: goto eol2d;                                         \
              }                                                              \
            }                                                                \
          doneWhite2da:;                                                     \
            for (;;) {                                                       \
              LOOKUP16(12, kWhiteTab, eof2d);                                \
              switch (te->state) {                                           \
                case S_TermW: SETVALUE(int(te->param)); goto doneBlack2da;   \
                case S_MakeUpW: case S_MakeUp:                               \
                  a0 += int(te->param); RunLength += int(te->param); break;  \
                default: goto eol2d;                                         \
              }                                                              \
            }                                                                \
          doneBlack2da:;                                                     \
          } else {                                                           \
            for (;;) {                                                       \
              LOOKUP16(12, kWhiteTab, eof2d);                                \
              switch (te->state) {                                           \
                case S_TermW: SETVALUE(int(te->param)); goto doneWhite2db;   \
                case S_MakeUpW: case S_MakeUp:                               \
                  a0 += int(te->param); RunLength += int(te->param); break;  \
                default: goto eol2d;                                         \
              }                                                              \
            }                                                                \
          doneWhite2db:;                                                     \
            for (;;) {                                                       \
              LOOKUP16(13, kBlackTab, eof2d);                                \
              switch (te->state) {                                           \
                case S_TermB: SETVALUE(int(te->param)); goto doneBlack2db;   \
                case S_MakeUpB: case S_MakeUp:                               \
                  a0 += int(te->param); RunLength += int(te->param); break;  \
                default: goto eol2d;                                         \
              }                                                              \
            }                                                                \
          doneBlack2db:;                                                     \
          }                                                                  \
          CHECK_B1;                                                          \
          break;                                                             \
        case S_V0:                                                           \
          CHECK_B1;                                                          \
          SETVALUE(b1 - a0);                                                 \
          if (pb >= s.refruns + s.nruns) return -1;                          \
          b1 += int(*pb++);                                                  \
          break;                                                             \
        case S_VR:                                                           \
          CHECK_B1;                                                          \
          SETVALUE(b1 - a0 + int(te->param));                                \
          if (pb >= s.refruns + s.nruns) return -1;                          \
          b1 += int(*pb++);                                                  \
          break;                                                             \
        case S_VL:                                                           \
          CHECK_B1;                                                          \
          if (b1 < int(a0 + te->param)) goto eol2d;                          \
          SETVALUE(b1 - a0 - int(te->param));                                \
          b1 -= int(*--pb);                                                  \
          break;                                                             \
        case S_Ext:                                                          \
          *pa++ = uint32_t(lastx - a0);                                      \
          goto eol2d;                                                        \
        case S_EOL:                                                          \
          *pa++ = uint32_t(lastx - a0);                                      \
          NEEDBITS8(4, eof2d);                                               \
          CLRBITS(4);                                                        \
          EOLcnt = 1;                                                        \
          goto eol2d;                                                        \
        default:                                                             \
          goto eol2d;                                                        \
      }                                                                      \
    }                                                                        \
    if (RunLength) {                                                         \
      if (RunLength + a0 < lastx) {                                          \
        NEEDBITS8(1, eof2d);                                                 \
        if (!GETBITS(1)) goto eol2d;                                         \
        CLRBITS(1);                                                          \
      }                                                                      \
      SETVALUE(0);                                                           \
    }                                                                        \
    goto eol2d;                                                              \
  eof2d:                                                                     \
    CLEANUP_RUNS();                                                          \
    goto eoflab;                                                             \
  eol2d:                                                                     \
    CLEANUP_RUNS();                                                          \
  } while (0)
// the search for an EOL before a G3 row (and its fill bits). Where the
// data ends after an EOL's zeros, libtiff takes the file for one without
// EOLs and skips the search in every later row of the directory
#define SYNC_EOL(eoflab)                                                     \
  do {                                                                       \
    if (!*s.noeol) {                                                         \
      if (EOLcnt == 0) {                                                     \
        for (;;) {                                                           \
          NEEDBITS16(11, eoflab);                                            \
          if (GETBITS(11) == 0) break;                                       \
          CLRBITS(1);                                                        \
        }                                                                    \
      }                                                                      \
      for (;;) {                                                             \
        NEEDBITS8(8, eoflab##NoEOL);                                         \
        if (GETBITS(8)) break;                                               \
        CLRBITS(8);                                                          \
      }                                                                      \
      while (GETBITS(1) == 0) CLRBITS(1);                                    \
      CLRBITS(1);                                                            \
      EOLcnt = 0;                                                            \
      break;                                                                 \
    }                                                                        \
  eoflab##NoEOL:                                                             \
    *s.noeol = 1;                                                            \
  } while (0)

#define FAX_LOCALS                                                           \
  const uint8_t *cp = s.cp, *ep = s.ep;                                      \
  uint32_t BitAcc = s.BitAcc;                                                \
  int BitsAvail = s.BitsAvail, EOLcnt = s.EOLcnt;                            \
  const int lastx = s.lastx;                                                 \
  int a0, RunLength, b1 = 0;                                                 \
  uint32_t *pa, *thisrun, *pb = nullptr;                                     \
  const FaxEnt *te;                                                          \
  (void)b1; (void)pb; (void)EOLcnt

// CCITT RLE (byte-aligned rows) and RLEW (word-aligned): Fax3DecodeRLE
int fax_rle(Fax &s, uint8_t *buf, int64_t occ, int64_t rowbytes, bool word) {
  FAX_LOCALS;
  thisrun = s.curruns;
  while (occ > 0) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun;
    EXPAND1D(EOFRLE);
    fax_fillruns(buf, thisrun, pa, uint32_t(lastx));
    if (!word) {
      int n = BitsAvail - (BitsAvail & ~7);
      CLRBITS(n);
    } else {
      int n = BitsAvail - (BitsAvail & ~15);
      CLRBITS(n);
      if (BitsAvail == 0 && ((cp - s.bp) + s.parity) & 1) cp++;
    }
    buf += rowbytes;
    occ -= rowbytes;
    continue;
  EOFRLE:
    fax_fillruns(buf, thisrun, pa, uint32_t(lastx));
    return -1;
  }
  return 1;
}

// Group 3, 1-D: Fax3Decode1D. The data's end ends the strip with success
// (PIL and the pip cv2 show it; their rows after it are not written)
int fax_g3_1d(Fax &s, uint8_t *buf, int64_t occ, int64_t rowbytes,
              int64_t *rows_done) {
  FAX_LOCALS;
  int64_t line = 0;
  thisrun = s.curruns;
  while (occ > 0) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun;
    SYNC_EOL(EOF1D);
    EXPAND1D(EOF1Da);
    fax_fillruns(buf, thisrun, pa, uint32_t(lastx));
    buf += rowbytes;
    occ -= rowbytes;
    line++;
    continue;
  EOF1D:
    CLEANUP_RUNS();
  EOF1Da:
    fax_fillruns(buf, thisrun, pa, uint32_t(lastx));
    *rows_done = line + 1;
    return 2;
  }
  return 1;
}

// Group 3, 2-D (a tag bit before each row picks 1-D or 2-D): Fax3Decode2D.
// The data's end while looking for a row's EOL ends the strip with success
// (rows after it not written), inside a row with failure, as PIL and the
// pip cv2 show it
int fax_g3_2d(Fax &s, uint8_t *buf, int64_t occ, int64_t rowbytes,
              int64_t *rows_done) {
  FAX_LOCALS;
  int64_t line = 0;
  while (occ > 0) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun = s.curruns;
    SYNC_EOL(EOF2D);
    NEEDBITS8(1, EOF2D);
    {
      int is1d = GETBITS(1);
      CLRBITS(1);
      pb = s.refruns;
      b1 = int(*pb++);
      if (is1d) goto row1d;
    }
    EXPAND2D(EOF2Da);
    goto rowdone;
  row1d:
    EXPAND1D(EOF2Da);
  rowdone:
    fax_fillruns(buf, thisrun, pa, uint32_t(lastx));
    if (pa < thisrun + s.nruns) SETVALUE(0);   // the reference's last change
    std::swap(s.curruns, s.refruns);
    buf += rowbytes;
    occ -= rowbytes;
    line++;
    continue;
  EOF2D:
    CLEANUP_RUNS();
    fax_fillruns(buf, thisrun, pa, uint32_t(lastx));
    *rows_done = line + 1;
    return 2;
  EOF2Da:
    fax_fillruns(buf, thisrun, pa, uint32_t(lastx));
    return -1;
  }
  return 1;
}

// Group 4: Fax4Decode. An EOFB, or the data's end, ends the strip with
// success once a row is done (its rows after are not written)
int fax_g4(Fax &s, uint8_t *buf, int64_t occ, int64_t rowbytes,
           int64_t *rows_done) {
  FAX_LOCALS;
  int64_t line = 0;
  while (occ > 0) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun = s.curruns;
    pb = s.refruns;
    b1 = int(*pb++);
    EXPAND2D(EOFG4);
    if (EOLcnt) goto EOFG4;
    fax_fillruns(buf, thisrun, pa, uint32_t(lastx));
    SETVALUE(0);
    std::swap(s.curruns, s.refruns);
    buf += rowbytes;
    occ -= rowbytes;
    *rows_done = ++line;
    continue;
  EOFG4:
    fax_fillruns(buf, thisrun, pa, uint32_t(lastx));
    *rows_done = line + 1;
    return line ? 2 : -1;
  }
  return 1;
}

#undef GETBITS
#undef CLRBITS
#undef EOD
#undef NEEDBITS8
#undef NEEDBITS16
#undef LOOKUP8
#undef LOOKUP16
#undef SETVALUE
#undef CLEANUP_RUNS
#undef EXPAND1D
#undef CHECK_B1
#undef EXPAND2D
#undef SYNC_EOL
#undef FAX_LOCALS

}  // namespace

extern "C" {

// One strip or tile of CCITT data -> its rows in `out` (n_out bytes,
// rows of `rowbytes`, `rowpixels` pixels each; black 1). `kind`: 2 (RLE),
// 32771 (RLEW), 3 (Group 3; `opts` its T4Options) or 4 (Group 4).
// `runs` (2 * nruns words and a flag word) is the directory's run buffer
// and its no-EOL mode, kept from one strip to the next as libtiff keeps
// them. `parity`: the strip's first
// byte's file offset mod 2 (RLEW aligns rows to the address of a word).
// Returns 1 where libtiff's codec succeeds, -1 where it fails (the rows
// written so far stay in `out`), 2 where a Group 4 strip ends early with
// success (Group 4 and Group 3: rows past *rows_done left as they were),
// -2 for a fraction of a row.
int32_t vt_fax_decode(const uint8_t *in, int64_t n_in, int64_t parity,
                      uint8_t *out, int64_t n_out, int32_t rowpixels,
                      int64_t rowbytes, int32_t kind, int32_t opts,
                      uint32_t *runs, int32_t nruns, int64_t *rows_done) {
  static const bool ready = fax_tables();
  (void)ready;
  if (rowbytes <= 0 || n_out % rowbytes) return -2;
  Fax s;
  s.cp = s.bp = in;
  s.ep = in + n_in;
  s.parity = parity & 1;
  s.runs = runs;
  s.nruns = uint32_t(nruns);
  s.curruns = runs;
  s.noeol = runs + 2 * int64_t(nruns);
  s.lastx = rowpixels;
  *rows_done = n_out / rowbytes;
  if (kind == 4 || (kind == 3 && (opts & 1))) {
    s.refruns = runs + nruns;
    s.refruns[0] = uint32_t(rowpixels);
    s.refruns[1] = 0;
  }
  if (kind == 2 || kind == 32771)
    return fax_rle(s, out, n_out, rowbytes, kind == 32771);
  if (kind == 4) return fax_g4(s, out, n_out, rowbytes, rows_done);
  if (opts & 1) return fax_g3_2d(s, out, n_out, rowbytes, rows_done);
  return fax_g3_1d(s, out, n_out, rowbytes, rows_done);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Zstandard frames (RFC 8878), as libtiff's tif_zstd.c meets them through
// libzstd's ZSTD_decompressStream: blocks until the strip is full or the
// frame ends, each block checked whole
// ---------------------------------------------------------------------------

namespace {

struct ZErr {};   // libzstd returns an error code

// a backward bit stream (BIT_DStream_t): the last byte's highest set bit
// marks its end; bits past its start read as zeros, or, for the Huffman
// streams libzstd's fast decoder reads, as the `below` bytes before it
// (a zero last byte is then data too: the stream holds all its bits)
struct BackBits {
  const uint8_t *p;
  int64_t total, used = 0, below = 0;   // bits in the stream, consumed
  BackBits(const uint8_t *src, int64_t n, bool fast = false,
           int64_t below_ = 0)
      : p(src), below(below_) {
    if (n <= 0 || (src[n - 1] == 0 && !fast)) throw ZErr();
    int last = src[n - 1], hb = 7;
    while (last && !(last >> hb)) --hb;
    total = last ? (n - 1) * 8 + hb : n * 8;
  }
  uint32_t peek(int k) const {   // the next k bits (k <= 24)
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      int64_t pos = total - 1 - used - i;   // bit index from the start
      int b = pos >= -below * 8 ? (p[pos >> 3] >> (pos & 7)) & 1 : 0;
      v = v << 1 | uint32_t(b);
    }
    return v;
  }
  uint32_t read(int k) {
    uint32_t v = peek(k);
    used += k;
    return v;
  }
  bool overflow() const { return used > total; }
  bool done() const { return used == total; }
};

struct FseEnt {
  uint16_t symbol;
  uint8_t bits;
  uint32_t base;
};

struct Fse {
  int log = 0;
  std::vector<FseEnt> t;
};

int highbit(uint32_t v) {
  int r = 0;
  while (v >>= 1) ++r;
  return r;
}

// the decoding table of normalised counts (-1: "less than one")
Fse fse_build(const std::vector<int> &norm, int log) {
  Fse f;
  f.log = log;
  uint32_t size = 1u << log, high = size - 1;
  f.t.assign(size, FseEnt{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      f.t[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (size_t s = 0; s < norm.size(); ++s)
    for (int i = 0; i < norm[s]; ++i) {
      f.t[pos].symbol = uint16_t(s);
      do pos = (pos + step) & mask; while (pos > high);
    }
  if (pos != 0) throw ZErr();
  for (uint32_t u = 0; u < size; ++u) {
    uint32_t ns = next[f.t[u].symbol]++;
    int nb = log - highbit(ns);
    f.t[u].bits = uint8_t(nb);
    f.t[u].base = (ns << nb) - size;
  }
  return f;
}

// FSE_readNCount: a table description from src -> (counts, log); *used
// the bytes it takes
std::vector<int> fse_read_counts(const uint8_t *src, int64_t n, int max_log,
                                 int max_symbol, int *log, int64_t *used) {
  int64_t bitpos = 0;
  auto bits = [&](int k) -> uint32_t {   // little-endian, k <= 24
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      int64_t q = bitpos + i;
      int b = (q >> 3) < n ? (src[q >> 3] >> (q & 7)) & 1 : 0;
      v |= uint32_t(b) << i;
    }
    return v;
  };
  int al = int(bits(4)) + 5;
  bitpos += 4;
  if (al > max_log) throw ZErr();
  *log = al;
  int remaining = (1 << al) + 1, threshold = 1 << al, nb = al + 1;
  std::vector<int> norm;
  bool prev0 = false;
  while (remaining > 1 && int(norm.size()) <= max_symbol) {
    if (prev0) {
      int rep;
      do {
        rep = int(bits(2));
        bitpos += 2;
        for (int i = 0; i < rep; ++i) norm.push_back(0);
      } while (rep == 3);
      if (int(norm.size()) > max_symbol) throw ZErr();
    }
    int mx = (2 * threshold - 1) - remaining;
    int v = int(bits(nb));
    int count;
    if ((v & (threshold - 1)) < mx) {
      count = v & (threshold - 1);
      bitpos += nb - 1;
    } else {
      count = v & (2 * threshold - 1);
      if (count >= threshold) count -= mx;
      bitpos += nb;
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm.push_back(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      nb--;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || int(norm.size()) > max_symbol + 1) throw ZErr();
  *used = (bitpos + 7) >> 3;
  if (*used > n) throw ZErr();
  return norm;
}

struct Huf {
  int max_bits = 0;
  std::vector<uint8_t> sym, len;   // by the next max_bits bits
};

// a Huffman tree description -> the table; returns the bytes it takes
int64_t huf_read(const uint8_t *src, int64_t n, Huf *h) {
  if (n < 1) throw ZErr();
  int hb = src[0];
  std::vector<int> w;
  int64_t used;
  if (hb >= 128) {
    int nw = hb - 127;
    used = 1 + (nw + 1) / 2;
    if (used > n) throw ZErr();
    for (int i = 0; i < nw; ++i)
      w.push_back(i & 1 ? src[1 + i / 2] & 15 : src[1 + i / 2] >> 4);
  } else {
    used = 1 + hb;
    if (used > n) throw ZErr();
    int log;
    int64_t hdr;
    std::vector<int> norm = fse_read_counts(src + 1, hb, 6, 12, &log, &hdr);
    Fse f = fse_build(norm, log);
    BackBits br(src + 1 + hdr, hb - hdr);
    uint32_t s1 = br.read(log), s2 = br.read(log);
    auto emit = [&](uint32_t &st, bool update) {
      // FSE_decompress's room check (255 weights), not before the last
      if (update && int(w.size()) > 255 - 2) throw ZErr();
      const FseEnt &e = f.t[st];
      w.push_back(e.symbol);
      if (update) st = e.base + br.read(e.bits);
    };
    for (;;) {
      emit(s1, true);
      if (br.overflow()) { emit(s2, false); break; }
      emit(s2, true);
      if (br.overflow()) { emit(s1, false); break; }
    }
  }
  uint32_t total = 0;
  std::vector<int> rank(16, 0);
  for (int x : w) {
    if (x > 12) throw ZErr();
    rank[x]++;
    if (x) total += 1u << (x - 1);
  }
  if (total == 0) throw ZErr();
  int max_bits = highbit(total) + 1;
  if (max_bits > 12) throw ZErr();
  uint32_t rest = (1u << max_bits) - total;
  if (rest != (1u << highbit(rest))) throw ZErr();
  int last = highbit(rest) + 1;
  w.push_back(last);
  rank[last]++;
  if (rank[1] < 2 || (rank[1] & 1)) throw ZErr();
  h->max_bits = max_bits;
  h->sym.assign(size_t(1) << max_bits, 0);
  h->len.assign(size_t(1) << max_bits, 0);
  // codes of each length in symbol order, longest codes first (lowest)
  uint32_t code = 0;
  for (int nbits = max_bits; nbits >= 1; --nbits) {
    int wt = max_bits + 1 - nbits;
    for (size_t s = 0; s < w.size(); ++s) {
      if (w[s] != wt) continue;
      uint32_t span = 1u << (max_bits - nbits);
      for (uint32_t i = 0; i < span; ++i) {
        h->sym[code + i] = uint8_t(s);
        h->len[code + i] = uint8_t(nbits);
      }
      code += span;
    }
  }
  return used;
}

// one Huffman literal stream. libzstd's fast 4-stream decoder (each
// stream of 8 bytes or more, codes of 11 bits or fewer) reads past a
// stream's start into the streams before it and checks no stream's end;
// its other decoders check each stream ends exactly
void huf_stream(const uint8_t *src, int64_t n, const Huf &h, uint8_t *out,
                int64_t count, bool fast = false, int64_t below = 0) {
  BackBits br(src, n, fast, below);
  for (int64_t i = 0; i < count; ++i) {
    uint32_t v = br.peek(h.max_bits);
    out[i] = h.sym[v];
    br.used += h.len[v];
  }
  if (!fast && !br.done()) throw ZErr();
}

const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,   14,   15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
    8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387,
    32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                            2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                            2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct ZFrame {
  Huf huf;
  bool have_huf = false;
  Fse ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
};

// one table of the sequences section (mode 0-3) -> bytes taken
int64_t seq_table(const uint8_t *src, int64_t n, int mode, int max_log,
                  int max_symbol, const int *def, int def_n, int def_log,
                  Fse *t, bool *have) {
  if (mode == 0) {
    *t = fse_build(std::vector<int>(def, def + def_n), def_log);
  } else if (mode == 1) {
    if (n < 1 || src[0] > max_symbol) throw ZErr();
    t->log = 0;
    t->t.assign(1, FseEnt{src[0], 0, 0});
    *have = true;
    return 1;
  } else if (mode == 2) {
    int log;
    int64_t used;
    std::vector<int> norm = fse_read_counts(src, n, max_log, max_symbol, &log,
                                            &used);
    *t = fse_build(norm, log);
    *have = true;
    return used;
  } else if (!*have) {
    throw ZErr();
  }
  *have = true;
  return 0;
}

// one compressed block -> appended to out (the frame's output so far)
void zstd_block(const uint8_t *src, int64_t n, ZFrame &z,
                std::vector<uint8_t> &out, int64_t block_max) {
  if (n < 1) throw ZErr();
  // literals
  int ltype = src[0] & 3, sf = (src[0] >> 2) & 3;
  int64_t lh, regen, csize = 0;
  int streams = 1;
  if (ltype < 2) {
    if (sf == 0 || sf == 2) { lh = 1; regen = src[0] >> 3; }
    else if (sf == 1) {
      lh = 2;
      if (n < 2) throw ZErr();
      regen = (src[0] | src[1] << 8) >> 4;
    } else {
      lh = 3;
      if (n < 3) throw ZErr();
      regen = (src[0] | src[1] << 8 | int64_t(src[2]) << 16) >> 4;
    }
  } else {
    lh = sf < 2 ? 3 : sf == 2 ? 4 : 5;
    if (n < lh) throw ZErr();
    uint64_t v = 0;
    for (int i = 0; i < lh; ++i) v |= uint64_t(src[i]) << (8 * i);
    int b = sf < 2 ? 10 : sf == 2 ? 14 : 18;
    regen = int64_t((v >> 4) & ((1u << b) - 1));
    csize = int64_t((v >> (4 + b)) & ((1u << b) - 1));
    streams = sf == 0 ? 1 : 4;
    if (streams == 4 && regen < 6) throw ZErr();
  }
  if (regen > block_max) throw ZErr();
  std::vector<uint8_t> lit(size_t(regen) + 1);
  int64_t pos = lh;
  if (ltype == 0) {
    if (pos + regen > n) throw ZErr();
    std::memcpy(lit.data(), src + pos, size_t(regen));
    pos += regen;
  } else if (ltype == 1) {
    if (pos + 1 > n) throw ZErr();
    std::memset(lit.data(), src[pos], size_t(regen));
    pos += 1;
  } else {
    if (pos + csize > n) throw ZErr();
    const uint8_t *c = src + pos;
    int64_t cn = csize;
    if (ltype == 2) {
      int64_t used = huf_read(c, cn, &z.huf);
      z.have_huf = true;
      c += used;
      cn -= used;
    } else if (!z.have_huf) {
      throw ZErr();
    }
    if (streams == 1) {
      huf_stream(c, cn, z.huf, lit.data(), regen);
    } else {
      if (cn < 6) throw ZErr();
      int64_t s1 = c[0] | c[1] << 8, s2 = c[2] | c[3] << 8,
              s3 = c[4] | c[5] << 8;
      int64_t s4 = cn - 6 - s1 - s2 - s3;
      if (s4 < 0) throw ZErr();
      int64_t seg = (regen + 3) / 4;
      const uint8_t *q = c + 6;
      bool fast = z.huf.max_bits <= 11 && s1 >= 8 && s2 >= 8 && s3 >= 8 &&
                  s4 >= 8 && 3 * seg < regen;
      huf_stream(q, s1, z.huf, lit.data(), seg, fast, 0);
      huf_stream(q + s1, s2, z.huf, lit.data() + seg, seg, fast, s1);
      huf_stream(q + s1 + s2, s3, z.huf, lit.data() + 2 * seg, seg, fast,
                 s1 + s2);
      huf_stream(q + s1 + s2 + s3, s4, z.huf, lit.data() + 3 * seg,
                 regen - 3 * seg, fast, s1 + s2 + s3);
    }
    pos += csize;
  }
  // sequences
  if (pos >= n) throw ZErr();
  int64_t nseq = src[pos++];
  if (nseq >= 128) {
    if (nseq < 255) {
      if (pos >= n) throw ZErr();
      nseq = ((nseq - 128) << 8) + src[pos++];
    } else {
      if (pos + 2 > n) throw ZErr();
      nseq = src[pos] + (src[pos + 1] << 8) + 0x7F00;
      pos += 2;
    }
  }
  int64_t litpos = 0, start = int64_t(out.size());
  if (nseq > 0) {
    if (pos >= n) throw ZErr();
    int modes = src[pos++];
    if (modes & 3) throw ZErr();
    pos += seq_table(src + pos, n - pos, modes >> 6, 9, 35, kLLDefault, 36, 6,
                     &z.ll, &z.have_ll);
    pos += seq_table(src + pos, n - pos, (modes >> 4) & 3, 8, 31, kOFDefault,
                     29, 5, &z.of, &z.have_of);
    pos += seq_table(src + pos, n - pos, (modes >> 2) & 3, 9, 52, kMLDefault,
                     53, 6, &z.ml, &z.have_ml);
    if (pos > n) throw ZErr();
    BackBits br(src + pos, n - pos);
    uint32_t sll = br.read(z.ll.log), sof = br.read(z.of.log),
             sml = br.read(z.ml.log);
    for (int64_t i = 0; i < nseq; ++i) {
      const FseEnt &eo = z.of.t[sof], &em = z.ml.t[sml], &el = z.ll.t[sll];
      int ocode = eo.symbol;
      uint64_t ov = (uint64_t(1) << ocode) + br.read(ocode > 24 ? 0 : ocode);
      if (ocode > 24)   // read in two parts, as libzstd's long offsets
        ov = (uint64_t(1) << ocode) + (uint64_t(br.read(ocode - 24)) << 24) +
             br.read(24);
      if (em.symbol > 52 || el.symbol > 35) throw ZErr();
      uint64_t ml = kMLBase[em.symbol] + br.read(kMLBits[em.symbol]);
      uint64_t ll = kLLBase[el.symbol] + br.read(kLLBits[el.symbol]);
      uint64_t off;
      if (ov > 3) {
        off = ov - 3;
        z.rep[2] = z.rep[1];
        z.rep[1] = z.rep[0];
        z.rep[0] = off;
      } else {
        int idx = int(ov) - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          off = z.rep[0];
        } else {
          off = idx == 3 ? z.rep[0] - 1 : z.rep[idx];
          if (off == 0) off = ~uint64_t(0);   // libzstd: corruption
          if (idx != 1) z.rep[2] = z.rep[1];
          z.rep[1] = z.rep[0];
          z.rep[0] = off;
        }
      }
      if (i + 1 < nseq) {
        sll = el.base + br.read(el.bits);
        sml = em.base + br.read(em.bits);
        sof = eo.base + br.read(eo.bits);
      }
      if (br.overflow()) throw ZErr();
      if (ll > uint64_t(regen - litpos)) throw ZErr();
      out.insert(out.end(), lit.begin() + litpos, lit.begin() + litpos +
                 int64_t(ll));
      litpos += int64_t(ll);
      if (off > out.size()) throw ZErr();
      if (int64_t(out.size()) - start + int64_t(ml) > block_max) throw ZErr();
      size_t from = out.size() - size_t(off);
      for (uint64_t k = 0; k < ml; ++k) out.push_back(out[from + k]);
    }
    if (!br.done()) throw ZErr();
  } else if (pos != n) {
    throw ZErr();
  }
  out.insert(out.end(), lit.begin() + litpos, lit.begin() + regen);
  if (int64_t(out.size()) - start > block_max) throw ZErr();
}

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

uint64_t xxh64(const uint8_t *p, size_t n) {
  const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                 P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                 P5 = 2870177450012600261ULL;
  auto rd64 = [](const uint8_t *q) { uint64_t v; std::memcpy(&v, q, 8); return v; };
  auto rd32 = [](const uint8_t *q) { uint32_t v; std::memcpy(&v, q, 4); return v; };
  auto round = [&](uint64_t acc, uint64_t in) {
    return rotl(acc + in * P2, 31) * P1;
  };
  const uint8_t *end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (p + 32 <= end) {
      v1 = round(v1, rd64(p)); v2 = round(v2, rd64(p + 8));
      v3 = round(v3, rd64(p + 16)); v4 = round(v4, rd64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ round(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += uint64_t(n);
  while (p + 8 <= end) {
    h = rotl(h ^ round(0, rd64(p)), 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h = rotl(h ^ (uint64_t(*p) * P5), 11) * P1;
    ++p;
  }
  h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
  return h;
}

// the first frame of src until `want` bytes are out: 0, or -1 where
// libzstd errs (the caller then refuses the strip)
int zstd_frame(const uint8_t *src, int64_t n, int64_t want,
               std::vector<uint8_t> &out) {
  if (n < 4) return -1;
  uint32_t magic = uint32_t(src[0]) | src[1] << 8 | src[2] << 16 |
                   uint32_t(src[3]) << 24;
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) return 0;   // skippable: ends
  if (magic != 0xFD2FB528u) return -1;
  int64_t pos = 4;
  if (pos >= n) return -1;
  int fhd = src[pos++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, check = (fhd >> 2) & 1,
      did = fhd & 3;
  if (fhd & 8) return -1;
  uint64_t window = 0;
  if (!single) {
    if (pos >= n) return -1;
    int wd = src[pos++];
    int wlog = 10 + (wd >> 3);
    if (wlog > 31) return -1;
    uint64_t base = uint64_t(1) << wlog;
    window = base + (base / 8) * uint64_t(wd & 7);
  }
  static const int kDid[4] = {0, 1, 2, 4};
  pos += kDid[did];
  int fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : 1 << fcs_flag;
  if (pos + fcs_bytes > n) return -1;
  bool has_fcs = fcs_bytes > 0;
  uint64_t fcs = 0;
  for (int i = 0; i < fcs_bytes; ++i) fcs |= uint64_t(src[pos + i]) << (8 * i);
  if (fcs_bytes == 2) fcs += 256;
  pos += fcs_bytes;
  if (single) window = fcs;
  if (window < 1024) window = 1024;
  if (window > (uint64_t(1) << 27)) return -1;   // ZSTD_d_windowLogMax 27
  int64_t block_max = int64_t(window < 131072 ? window : 131072);
  // libzstd decodes a frame whose every block is in the input and whose
  // size fits the output at once; otherwise block by block until full
  bool whole = false;
  if (has_fcs && fcs <= uint64_t(want)) {
    int64_t q = pos;
    for (;;) {
      if (q + 3 > n) break;
      uint32_t bh = src[q] | src[q + 1] << 8 | src[q + 2] << 16;
      int64_t sz = (bh >> 1 & 3) == 1 ? 1 : int64_t(bh >> 3);
      q += 3 + sz;
      if (q > n) break;
      if (bh & 1) {
        whole = q + (check ? 4 : 0) <= n;
        break;
      }
    }
  }
  ZFrame z;
  try {
    for (;;) {
      if (!whole && int64_t(out.size()) >= want) return 0;
      if (pos + 3 > n) return -1;
      uint32_t bh = src[pos] | src[pos + 1] << 8 | src[pos + 2] << 16;
      pos += 3;
      int last = bh & 1, type = (bh >> 1) & 3;
      int64_t sz = int64_t(bh >> 3);
      if (type == 3) return -1;
      if (type == 1) {
        if (pos + 1 > n || sz > block_max) return -1;
        out.insert(out.end(), size_t(sz), src[pos]);
        pos += 1;
      } else {
        if (sz > block_max || pos + sz > n) return -1;
        if (type == 0) out.insert(out.end(), src + pos, src + pos + sz);
        else zstd_block(src + pos, sz, z, out, block_max);
        pos += sz;
      }
      if (has_fcs && out.size() > fcs) return -1;
      if (last) break;
    }
  } catch (const ZErr &) {
    return -1;
  }
  if (has_fcs && out.size() != fcs) return -1;
  if (check && pos + 4 <= n) {
    uint32_t want_sum = uint32_t(src[pos]) | src[pos + 1] << 8 |
                        src[pos + 2] << 16 | uint32_t(src[pos + 3]) << 24;
    if (uint32_t(xxh64(out.data(), out.size())) != want_sum) return -1;
  }
  return 0;
}

}  // namespace

extern "C" {

// libtiff's ZSTDDecode of one strip or tile: at most n_out bytes of the
// frame at the start of `in`. Returns the bytes written, or -1 where
// libzstd errs.
int64_t vt_zstd_decode(const uint8_t *in, int64_t n_in, uint8_t *out,
                       int64_t n_out) {
  std::vector<uint8_t> buf;
  if (zstd_frame(in, n_in, n_out, buf) < 0) return -1;
  int64_t k = int64_t(buf.size()) < n_out ? int64_t(buf.size()) : n_out;
  std::memcpy(out, buf.data(), size_t(k));
  return k;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// ThunderScan 4-bit (libtiff's tif_thunder.c)
// ---------------------------------------------------------------------------

extern "C" {

// One strip of ThunderScan codes -> rows of `width` 4-bit pixels (high
// nibble first) in `out` (n_out bytes, rows of `rowbytes`). Each row reads
// codes until it has `width` pixels: runs of the last pixel, three 2-bit
// or two 3-bit deltas, a raw pixel. A run that would pass the row's end is
// counted and not written. Returns 1, or 0 where
// libtiff's decoder fails (a row of too few or too many pixels; the rows
// before it are written).
int32_t vt_thunder_decode(const uint8_t *in, int64_t n_in, uint8_t *out,
                          int64_t n_out, int64_t width, int64_t rowbytes) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  if (rowbytes <= 0 || n_out % rowbytes) return 0;
  const uint8_t *bp = in;
  int64_t cc = n_in;
  for (int64_t r = 0; r < n_out / rowbytes; ++r) {
    uint8_t *op = out + r * rowbytes;
    unsigned lastpixel = 0;
    int64_t npixels = 0;
    auto setpixel = [&](unsigned v) {
      lastpixel = v & 0xf;
      if (npixels < width) {
        if (npixels++ & 1) *op++ |= uint8_t(lastpixel);
        else op[0] = uint8_t(lastpixel << 4);
      }
    };
    while (cc > 0 && npixels < width) {
      int n = *bp++, delta;
      cc--;
      switch (n & 0xc0) {
        case 0x00:              // run
          if (npixels & 1) {
            op[0] |= uint8_t(lastpixel);
            lastpixel = *op++;
            npixels++;
            n--;
          } else {
            lastpixel |= lastpixel << 4;
          }
          npixels += n;
          if (npixels <= width)
            for (; n > 0; n -= 2) *op++ = uint8_t(lastpixel);
          if (n == -1) *--op &= 0xf0;
          lastpixel &= 0xf;
          break;
        case 0x40:              // 2-bit deltas
          if ((delta = (n >> 4) & 3) != 2)
            setpixel(unsigned(int(lastpixel) + two[delta]));
          if ((delta = (n >> 2) & 3) != 2)
            setpixel(unsigned(int(lastpixel) + two[delta]));
          if ((delta = n & 3) != 2)
            setpixel(unsigned(int(lastpixel) + two[delta]));
          break;
        case 0x80:              // 3-bit deltas
          if ((delta = (n >> 3) & 7) != 4)
            setpixel(unsigned(int(lastpixel) + three[delta]));
          if ((delta = n & 7) != 4)
            setpixel(unsigned(int(lastpixel) + three[delta]));
          break;
        default:                // raw
          setpixel(unsigned(n));
          break;
      }
    }
    if (npixels != width) return 0;
  }
  return 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// FLI / FLC frames (PIL's libImaging FliDecode.c)
// ---------------------------------------------------------------------------

extern "C" {

// One call of PIL's FLI decoder on `buf` (the `n` bytes PIL's loader has
// read of the frame so far) into the 8-bit image `img` (h rows of w bytes,
// kept between calls). Returns the bytes consumed (>= 0) where the decoder
// asks for more data, -1 at the frame's end, -2 where it fails (a
// truncated or malformed chunk, an unknown chunk type, a zero advance).
// The chunks: colour (4, 11) and postage stamp (18) skipped, SS2 (7), LC
// (12), BLACK (13), BRUN (15) and COPY (16), each with FliDecode.c's bounds
// checks against the bytes left in `buf`.
int64_t vt_fli_decode(const uint8_t *buf, int64_t n, uint8_t *img,
                      int64_t w, int64_t h) {
  auto i16 = [](const uint8_t *p) { return int(p[0]) | int(p[1]) << 8; };
  auto i32 = [](const uint8_t *p) {
    return int32_t(uint32_t(p[0]) | uint32_t(p[1]) << 8 |
                   uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24);
  };
  if (n < 4) return 0;
  const uint8_t *ptr = buf;
  int64_t bytes = n;
  int64_t framesize = uint32_t(i32(ptr));   // unsigned: a size past 2^31
  if (bytes + bytes % 2 < framesize) return 0;   // waits for more data
  if (bytes < 8) return -2;
  if (i16(ptr + 4) != 0xF1FA) return -2;
  int chunks = i16(ptr + 6);
  ptr += 16;
  bytes -= 16;
  const int64_t xs = w, ys = h;
  for (int c = 0; c < chunks; ++c) {
    if (bytes < 10) return -2;
    const uint8_t *data = ptr + 6;
    auto oob = [&](int64_t k) { return data + k > ptr + bytes; };
    int64_t i = 0, x = 0, y = 0;
    switch (i16(ptr + 4)) {
      case 4:
      case 11:
      case 18:
        break;
      case 7: {                 // SS2, word delta
        int lines = i16(data);
        data += 2;
        int l = 0;
        for (l = 0, y = 0; l < lines && y < ys; ++l, ++y) {
          uint8_t *out = img + y * xs;
          if (oob(2)) return -2;
          int packets = i16(data);
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;
              if (y >= ys) return -2;
              out = img + y * xs;
            } else {
              out[xs - 1] = uint8_t(packets);
            }
            if (oob(2)) return -2;
            packets = i16(data);
            data += 2;
          }
          int p = 0;
          for (p = 0, x = 0; p < packets; ++p) {
            if (oob(2)) return -2;
            x += data[0];
            if (data[1] >= 128) {
              if (oob(4)) return -2;
              i = 256 - data[1];
              if (x + i + i > xs) break;
              for (int64_t j = 0; j < i; ++j) {
                out[x++] = data[2];
                out[x++] = data[3];
              }
              data += 4;
            } else {
              i = 2 * int64_t(data[1]);
              if (x + i > xs) break;
              if (oob(2 + i)) return -2;
              std::memcpy(out + x, data + 2, size_t(i));
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) return -2;
        break;
      }
      case 12: {                // LC, byte delta
        y = i16(data);
        int64_t ymax = y + i16(data + 2);
        data += 4;
        for (; y < ymax && y < ys; ++y) {
          uint8_t *out = img + y * xs;
          if (oob(1)) return -2;
          int packets = *data++;
          int p = 0;
          for (p = 0, x = 0; p < packets; ++p, x += i) {
            if (oob(2)) return -2;
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > xs) break;
              if (oob(3)) return -2;
              std::memset(out + x, data[2], size_t(i));
              data += 3;
            } else {
              i = data[1];
              if (x + i > xs) break;
              if (oob(2 + i)) return -2;
              std::memcpy(out + x, data + 2, size_t(i));
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) return -2;
        break;
      }
      case 13:                  // BLACK
        std::memset(img, 0, size_t(xs * ys));
        break;
      case 15:                  // BRUN
        for (y = 0; y < ys; ++y) {
          uint8_t *out = img + y * xs;
          data += 1;            // the packet count, ignored
          for (x = 0; x < xs; x += i) {
            if (oob(2)) return -2;
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > xs) break;
              if (oob(i + 1)) return -2;
              std::memcpy(out + x, data + 1, size_t(i));
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > xs) break;
              std::memset(out + x, data[1], size_t(i));
              data += 2;
            }
          }
          if (x != xs) return -2;
        }
        break;
      case 16:                  // COPY
        if (INT32_MAX / xs < ys) return -2;
        if (data + xs * ys > ptr + bytes) return ptr - buf;
        std::memcpy(img, data, size_t(xs * ys));
        break;
      default:
        return -2;
    }
    int32_t advance = i32(ptr);
    if (advance == 0) return -2;
    if (advance < 0 || advance > bytes) return -2;
    ptr += advance;
    bytes -= advance;
  }
  return -1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// SGILog (libtiff's tif_luv.c): LogL16, LogLuv32 and LogLuv24 rows
// ---------------------------------------------------------------------------

namespace {

// One row of `nplanes` byte planes (most significant first), each coded
// on its own: a byte >= 128 is a run of (byte - 126) copies of the next
// byte, a byte below 128 a count of literal bytes after it. A run or a
// literal that passes the row's end is cut there (the rest of a literal
// is read as the next plane's code). False where the data ends before the
// row does ("Not enough data").
bool sgilog_rle_row(const uint8_t *&bp, int64_t &cc, uint32_t *tp,
                    int64_t npixels, int nplanes) {
  std::memset(tp, 0, size_t(npixels) * sizeof(uint32_t));
  for (int shft = 8 * (nplanes - 1); shft >= 0; shft -= 8) {
    int64_t i = 0;
    while (i < npixels && cc > 0) {
      if (*bp >= 128) {         // run
        if (cc < 2) break;
        int rc = *bp++ + (2 - 128);
        uint32_t b = uint32_t(*bp++) << shft;
        cc -= 2;
        while (rc-- && i < npixels) tp[i++] |= b;
      } else {                  // literal (a zero count is a no-op)
        int rc = *bp++;
        while (--cc && rc-- && i < npixels) tp[i++] |= uint32_t(*bp++) << shft;
      }
    }
    if (i != npixels) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// One strip or tile of SGILog data -> nrows rows of npixels codes in `out`
// (uint32 each): kind 16, LogL16Decode (two byte planes: the 16-bit code,
// its sign in bit 15); 32, LogLuvDecode32 (four planes: L in bits 31-16,
// u in 15-8, v in 7-0); 24, LogLuvDecode24 (three bytes a pixel,
// big-endian, no run-length coding). Rows are decoded one after another
// from where the last one ended, as LogLuvDecodeStrip / Tile call the row
// decoder; a row that fails stops the strip and is not written. Returns
// the rows decoded whole.
int64_t vt_sgilog_decode(const uint8_t *in, int64_t n_in, uint32_t *out,
                         int64_t npixels, int64_t nrows, int32_t kind) {
  const uint8_t *bp = in;
  int64_t cc = n_in;
  std::vector<uint32_t> tp(size_t(npixels > 0 ? npixels : 1));
  for (int64_t r = 0; r < nrows; ++r) {
    if (kind == 24) {
      int64_t i = 0;
      for (; i < npixels && cc >= 3; ++i, bp += 3, cc -= 3)
        tp[size_t(i)] = uint32_t(bp[0]) << 16 | uint32_t(bp[1]) << 8 | bp[2];
      if (i != npixels) return r;
    } else if (!sgilog_rle_row(bp, cc, tp.data(), npixels,
                               kind == 16 ? 2 : 4)) {
      return r;
    }
    std::memcpy(out + r * npixels, tp.data(),
                size_t(npixels) * sizeof(uint32_t));
  }
  return nrows;
}

}  // extern "C"
