// The serial stages of JPEG 2000 Part 1 decoding (`scene/j2k.py`), as
// OpenJPEG 2.5 runs them: the MQ arithmetic decoder and its raw (bypass)
// reader, EBCOT tier-1 (significance propagation, magnitude refinement and
// cleanup passes, with every code-block style: BYPASS, RESET, TERMALL, VSC,
// PTERM and SEGSYM), ROI maxshift, and the coefficients as OpenJPEG keeps
// them: sign and magnitude with mid-point reconstruction at one bit more than
// the standard's, halved for the reversible path, scaled by half the band's
// step size in float32 for the irreversible one.
//
// Each code-block's segments are decoded as opj_t1_decode_cblk decodes
// them: a segment's bytes are followed by an artificial 0xFF 0xFF, so the
// readers stop on it as on a marker; the bypass decision is taken at each
// segment's start. The wavelets, the colour transforms and the level shift
// are vectorisable and stay in numpy.
//
// C ABI, bound with ctypes.

#include <cstdint>
#include <utility>
#include <cstring>
#include <vector>

namespace {

// ISO 15444-1 Table C.2: Qe, NMPS, NLPS, SWITCH
const uint32_t kQe[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801,
    0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801,
    0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601,
    0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005,
    0x0001, 0x5601};
const uint8_t kNmps[47] = {
    1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t kNlps[47] = {
    1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
    15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
    30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

// contexts (OpenJPEG's numbering)
const int kCtxZc = 0, kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18;
const int kNumCtx = 19;

// code-block styles (COD / COC SPcod's fifth byte)
const int kLazy = 0x01, kReset = 0x02, kVsc = 0x08, kSegSym = 0x20;

struct Mq {
  const uint8_t *bp;
  uint32_t a, c, ct;
  uint8_t state[kNumCtx], mps[kNumCtx];

  void reset_states() {
    std::memset(state, 0, sizeof state);
    std::memset(mps, 0, sizeof mps);
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[kCtxZc] = 4;
  }
  // opj_mqc_bytein: the segment ends in an artificial 0xFF 0xFF
  inline void bytein() {
    uint32_t next = bp[1];
    if (bp[0] == 0xFF) {
      if (next > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += next << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += next << 8;
      ct = 8;
    }
  }
  void init(const uint8_t *data, uint32_t len) {
    bp = data;
    c = len == 0 ? 0xFFu << 16 : uint32_t(bp[0]) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  inline void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while ((a & 0x8000) == 0);
  }
  inline uint32_t decode(int cx) {
    uint32_t s = state[cx];
    uint32_t qe = kQe[s];
    uint32_t d;
    a -= qe;
    if ((c >> 16) < qe) {  // LPS exchange
      if (a < qe) {
        a = qe;
        d = mps[cx];
        state[cx] = kNmps[s];
      } else {
        a = qe;
        d = 1 - mps[cx];
        if (kSwitch[s]) mps[cx] = uint8_t(1 - mps[cx]);
        state[cx] = kNlps[s];
      }
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {  // MPS exchange
        if (a < qe) {
          d = 1 - mps[cx];
          if (kSwitch[s]) mps[cx] = uint8_t(1 - mps[cx]);
          state[cx] = kNlps[s];
        } else {
          d = mps[cx];
          state[cx] = kNmps[s];
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  // opj_mqc_raw_init_dec / opj_mqc_raw_decode
  void raw_init(const uint8_t *data) {
    bp = data;
    c = 0;
    ct = 0;
  }
  inline uint32_t raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (bp[0] > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = bp[0];
          ++bp;
          ct = 7;
        }
      } else {
        c = bp[0];
        ++bp;
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
};

// flags of a sample: its 8 neighbours' significance, the signs of its four
// direct neighbours, its own state
enum : uint32_t {
  kN = 1 << 0, kS = 1 << 1, kW = 1 << 2, kE = 1 << 3,
  kNW = 1 << 4, kNE = 1 << 5, kSW = 1 << 6, kSE = 1 << 7,
  kNegN = 1 << 8, kNegS = 1 << 9, kNegW = 1 << 10, kNegE = 1 << 11,
  kSig = 1 << 12, kVisit = 1 << 13, kRefined = 1 << 14, kNeg = 1 << 15,
  kNeighbours = 0xFF,
};

uint8_t g_zc[4][256];
uint8_t g_sc[256];   // context - kCtxSc | xor bit << 7, by the sign bits
bool g_luts = false;

void make_luts() {
  for (int orient = 0; orient < 4; ++orient) {
    for (int f = 0; f < 256; ++f) {
      int h = !!(f & kW) + !!(f & kE);
      int v = !!(f & kN) + !!(f & kS);
      int d = !!(f & kNW) + !!(f & kNE) + !!(f & kSW) + !!(f & kSE);
      int n = 0;
      if (orient == 1) std::swap(h, v);
      if (orient == 3) {
        int hv = h + v;
        if (d == 0) n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
        else if (d == 1) n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
        else if (d == 2) n = hv == 0 ? 6 : 7;
        else n = 8;
      } else if (h == 0) {
        if (v == 0) n = d == 0 ? 0 : d == 1 ? 1 : 2;
        else n = v == 1 ? 3 : 4;
      } else if (h == 1) {
        n = v == 0 ? (d == 0 ? 5 : 6) : 7;
      } else {
        n = 8;
      }
      g_zc[orient][f] = uint8_t(kCtxZc + n);
    }
  }
  // index: N sig, S sig, W sig, E sig, N neg, S neg, W neg, E neg;
  // ISO 15444-1 Table D.3
  for (int i = 0; i < 256; ++i) {
    auto contrib = [&](int sig, int neg) { return sig ? (neg ? -1 : 1) : 0; };
    int hc = contrib(i & 4, i & 64) + contrib(i & 8, i & 128);
    int vc = contrib(i & 1, i & 16) + contrib(i & 2, i & 32);
    hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
    vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
    if (hc < 0 || (hc == 0 && vc < 0)) {  // the mirror case: flip both
      hc = -hc;
      vc = -vc;
      g_sc[i] = 0x80;
    } else {
      g_sc[i] = 0;
    }
    int ctx = hc == 1 ? (vc == 1 ? 13 : vc == 0 ? 12 : 11) : (vc == 0 ? 9 : 10);
    g_sc[i] = uint8_t(g_sc[i] | (ctx - kCtxSc));
  }
  g_luts = true;
}

inline int sc_index(uint32_t f) {
  return int((f & 0xF) | ((f >> 4) & 0xF0));
}

struct Block {
  int w, h, stride;
  bool vsc;
  std::vector<uint32_t> flags;   // (h + 2) x (w + 2), a border around
  std::vector<int32_t> data;     // h x w
  uint32_t *fl(int x, int y) { return &flags[size_t(y + 1) * stride + x + 1]; }

  Block(int w_, int h_, bool vsc_) : w(w_), h(h_), stride(w_ + 2), vsc(vsc_),
      flags(size_t(h_ + 2) * (w_ + 2), 0), data(size_t(w_) * h_, 0) {}

  // a sample turns significant: its neighbours learn it (with VSC, a
  // stripe's last row does not see the next stripe's first)
  void set_sig(int x, int y, bool neg) {
    uint32_t *f = fl(x, y);
    *f |= kSig | (neg ? kNeg : 0);
    bool up = !(vsc && (y & 3) == 0);
    if (up) {
      uint32_t *n = f - stride;
      n[-1] |= kSE;
      n[0] |= kS | (neg ? kNegS : 0);
      n[1] |= kSW;
    }
    f[-1] |= kE | (neg ? kNegE : 0);
    f[1] |= kW | (neg ? kNegW : 0);
    uint32_t *s = f + stride;
    s[-1] |= kNE;
    s[0] |= kN | (neg ? kNegN : 0);
    s[1] |= kNW;
  }
};

void sig_pass(Block &b, Mq &mq, int orient, int one, bool raw) {
  int32_t oph = one | (one >> 1);
  const uint8_t *zc = g_zc[orient];
  for (int y0 = 0; y0 < b.h; y0 += 4) {
    int y1 = y0 + 4 < b.h ? y0 + 4 : b.h;
    for (int x = 0; x < b.w; ++x) {
      for (int y = y0; y < y1; ++y) {
        uint32_t *f = b.fl(x, y);
        if ((*f & (kSig | kVisit)) || !(*f & kNeighbours)) continue;
        uint32_t v = raw ? mq.raw() : mq.decode(zc[*f & kNeighbours]);
        if (v) {
          uint32_t neg;
          if (raw) {
            neg = mq.raw();
          } else {
            uint8_t s = g_sc[sc_index(*f)];
            neg = mq.decode(kCtxSc + (s & 0x7F)) ^ (s >> 7);
          }
          b.data[size_t(y) * b.w + x] = neg ? -oph : oph;
          b.set_sig(x, y, neg != 0);
        }
        *f |= kVisit;
      }
    }
  }
}

void ref_pass(Block &b, Mq &mq, int one, bool raw) {
  int32_t half = one >> 1;
  for (int y0 = 0; y0 < b.h; y0 += 4) {
    int y1 = y0 + 4 < b.h ? y0 + 4 : b.h;
    for (int x = 0; x < b.w; ++x) {
      for (int y = y0; y < y1; ++y) {
        uint32_t *f = b.fl(x, y);
        if ((*f & (kSig | kVisit)) != kSig) continue;
        uint32_t v;
        if (raw) {
          v = mq.raw();
        } else {
          int cx = (*f & kRefined) ? kCtxMag + 2
                   : (*f & kNeighbours) ? kCtxMag + 1 : kCtxMag;
          v = mq.decode(cx);
        }
        int32_t &d = b.data[size_t(y) * b.w + x];
        d += (v ^ (d < 0)) ? half : -half;
        *f |= kRefined;
      }
    }
  }
}

void cln_pass(Block &b, Mq &mq, int orient, int one, bool segsym) {
  int32_t oph = one | (one >> 1);
  const uint8_t *zc = g_zc[orient];
  for (int y0 = 0; y0 < b.h; y0 += 4) {
    int y1 = y0 + 4 < b.h ? y0 + 4 : b.h;
    for (int x = 0; x < b.w; ++x) {
      int start = y0;
      if (y1 - y0 == 4) {
        bool quiet = true;
        for (int y = y0; y < y1 && quiet; ++y)
          quiet = (*b.fl(x, y) & (kSig | kVisit | kNeighbours)) == 0;
        if (quiet) {
          if (!mq.decode(kCtxAgg)) continue;
          int r = int(mq.decode(kCtxUni)) << 1;
          r |= int(mq.decode(kCtxUni));
          int y = y0 + r;
          uint32_t *f = b.fl(x, y);
          uint8_t s = g_sc[sc_index(*f)];
          uint32_t neg = mq.decode(kCtxSc + (s & 0x7F)) ^ (s >> 7);
          b.data[size_t(y) * b.w + x] = neg ? -oph : oph;
          b.set_sig(x, y, neg != 0);
          start = y + 1;
        }
      }
      for (int y = start; y < y1; ++y) {
        uint32_t *f = b.fl(x, y);
        if (*f & (kSig | kVisit)) continue;
        if (mq.decode(zc[*f & kNeighbours])) {
          uint8_t s = g_sc[sc_index(*f)];
          uint32_t neg = mq.decode(kCtxSc + (s & 0x7F)) ^ (s >> 7);
          b.data[size_t(y) * b.w + x] = neg ? -oph : oph;
          b.set_sig(x, y, neg != 0);
        }
      }
      for (int y = y0; y < y1; ++y) *b.fl(x, y) &= ~uint32_t(kVisit);
    }
  }
  if (segsym) {
    for (int i = 0; i < 4; ++i) mq.decode(kCtxUni);
  }
}

}  // namespace

extern "C" {

// Decode `ncblk` code-blocks into one buffer of 4-byte samples (int32 for
// the reversible path, float32 for the irreversible one).
//
// info, 12 int64 per code-block: data offset, first segment, segments,
// width, height, orientation (0 LL, 1 HL, 2 LH, 3 HH), bit-planes
// (OpenJPEG's numbps, as int32), ROI shift, code-block style, output
// offset (samples), output stride (samples), irreversible (0 / 1).
// segs, 2 int64 per segment: length, passes. steps: each code-block's band
// step size (float32). Returns ncblk, or the index of the first code-block
// OpenJPEG refuses (31 bit-planes or more).
int64_t vt_j2k_t1_decode(const uint8_t *data, int64_t ncblk,
                         const int64_t *info, const int64_t *segs,
                         const float *steps, void *out) {
  if (!g_luts) make_luts();
  std::vector<uint8_t> buf;
  Mq mq;
  for (int64_t k = 0; k < ncblk; ++k) {
    const int64_t *in = info + 12 * k;
    int64_t off = in[0], seg0 = in[1], nseg = in[2];
    int w = int(in[3]), h = int(in[4]), orient = int(in[5]);
    int32_t numbps = int32_t(in[6]);
    int roishift = int(in[7]), sty = int(in[8]);
    int64_t out_off = in[9], out_stride = in[10];
    bool irrev = in[11] != 0;
    int32_t bpno = int32_t(uint32_t(roishift) + uint32_t(numbps));
    if (bpno >= 31) return k;
    if (w <= 0 || h <= 0) continue;
    Block b(w, h, (sty & kVsc) != 0);
    int passtype = 2;
    mq.reset_states();
    for (int64_t s = 0; s < nseg; ++s) {
      int64_t len = segs[2 * (seg0 + s)], passes = segs[2 * (seg0 + s) + 1];
      bool raw = (sty & kLazy) && passtype < 2 && bpno <= numbps - 4;
      buf.assign(data + off, data + off + len);
      buf.push_back(0xFF);
      buf.push_back(0xFF);
      off += len;
      if (raw) mq.raw_init(buf.data());
      else mq.init(buf.data(), uint32_t(len));
      for (int64_t p = 0; p < passes && bpno >= 1; ++p) {
        int one = 1 << bpno;
        if (passtype == 0) sig_pass(b, mq, orient, one, raw);
        else if (passtype == 1) ref_pass(b, mq, one, raw);
        else cln_pass(b, mq, orient, one, (sty & kSegSym) != 0);
        if ((sty & kReset) && !raw) mq.reset_states();
        if (++passtype == 3) {
          passtype = 0;
          --bpno;
        }
      }
    }
    if (roishift) {
      for (auto &v : b.data) {
        if (roishift >= 31) {
          v = 0;
          continue;
        }
        int32_t mag = v < 0 ? -v : v;
        if (mag >= (int32_t(1) << roishift)) {
          mag >>= roishift;
          v = v < 0 ? -mag : mag;
        }
      }
    }
    if (irrev) {
      float step = 0.5f * steps[k];
      float *o = static_cast<float *>(out) + out_off;
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
          o[y * out_stride + x] = float(b.data[size_t(y) * w + x]) * step;
    } else {
      int32_t *o = static_cast<int32_t *>(out) + out_off;
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
          o[y * out_stride + x] = b.data[size_t(y) * w + x] / 2;
    }
  }
  return ncblk;
}

}  // extern "C"
