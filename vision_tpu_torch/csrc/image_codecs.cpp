// The serial stages of the image codecs of
// `vision_tpu_torch/scene/imageio.py`: OpenEXR's Huffman coder (PIZ and
// DWA's AC coefficients), OpenEXR's byte run-length coding (RLE and DWA's
// RLE channels), DWA's run-length coding of AC coefficients, LZW (TIFF's,
// most significant bit first, and GIF's and TIFF's old style, least
// significant bit first) and TIFF's PackBits. Each walks its input a bit
// or a byte at a time, so it lives here: in Python it costs about a
// microsecond a step. The vectorisable stages (PIZ's wavelet and lookup
// table, PXR24's byte planes, B44's blocks, DWA's inverse DCT, the
// predictors) stay in numpy.
//
// Each function decodes as the reference library does (libOpenEXR 3.1's
// ImfHuf.cpp, ImfRle.cpp and ImfDwaCompressor.cpp; libtiff's tif_lzw.c
// and tif_packbits.c; PIL's GifDecode.c) and returns a negative code where
// it throws or stops.
//
// C ABI, bound with ctypes.

#include <cstdint>
#include <cstring>
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
// Returns the bytes written; -2 for a code not yet in the table (both
// libraries stop with an error there). A stream that ends without its end
// code returns the bytes it gave.
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
      if (code >= next) return -2;
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
      return -2;
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

}  // extern "C"
