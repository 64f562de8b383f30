"""JPEG 2000 files for slice 7e.7a (PIL's route), in `tests/assets_torch/`,
with `j2k_decodes.npz`: what `PIL.Image.open(p).convert("RGB")` gives for
each (PIL 12.1.0 over OpenJPEG 2.5.4), uint8 [H, W, 3].

    python tools/gen_torch_j2k.py [out_dir]

(`tools/gen_torch_assets.py` calls it after writing the scenes' images,
which it reads.) Two writers:

  * PIL's encoder (OpenJPEG's): every mode it writes (L, LA, RGB, RGBA,
    I;16), lossless and lossy, MCT on and off, the five progressions,
    tiles and offsets, code-block and precinct sizes, quality layers,
    signed samples, PLT and comments; J2K and JP2. JP2 files with their
    boxes edited give CMYK, sYCC, P and PA (a pclr box of 3 or 4
    columns), ICC profiles and enumerated spaces PIL does not know.
    Some settings crash PIL's encoder, so it runs in a child process.
  * `J2kWriter`, this file's own tier-1 / tier-2 encoder, for what PIL's
    encoder does not write: every Part-1 code-block style (BYPASS, RESET,
    TERMALL, VSC, PTERM, SEGSYM and their mixes), ROI (RGN), SOP / EPH,
    COC / QCC, POC (one that leaves out the last resolution too), PPM /
    PPT, several tile-parts, precisions other than 8 and 16, quantisation
    styles (none, derived, expounded), sub-sampled components, and RCT
    over a 9/7 component. Its
    code-blocks hold seeded random coefficients (the inverse wavelet of
    which is the image): the MQ coder (ISO 15444-1 C.2) with a flush at
    each termination, the raw (bypass) passes bit-stuffed after 0xFF, the
    packets in the order of the port's packet iterator
    (`vision_tpu_torch/scene/j2k.py` `_packets`, which PIL's decode of
    every file holds).

Then `j2k_bad_*`: files PIL refuses (cut, a bad marker, an empty image);
an ICNS file with a JPEG 2000 icon; the twins' files: `checker_j2k.jp2`
(the checker, 9/7, ICT, two quality layers) and `projector_j2k.j2k` (the
projector, 5/3, RCT, four tiles with a tile offset, PCRL, precincts),
each with PIL's decode as a PNG (`checker_j2k_pil.png`,
`projector_j2k_pil.png`); and the timing file `j2k_2048.jp2` (2048^2
RGB, 9/7, six resolutions, 64 x 64 code-blocks, about 0.5 bits a pixel),
committed, as the card's machine has no encoder: the .npz keeps its
decode's sha256 and 128 x 128 corner. Slice 7e.7d's files (Part 2's
markers, tiles of fewer resolutions, `checker_j2kp2.jp2` and its
`checker_j2kp2_pil.png`) come from `tools/gen_torch_j2k_p2.py`, which
lists them; slice 7e.7c's HTJ2K files (`htj2k_*`, `checker_htj2k.jp2`
and the timing file `htj2k_2048.jp2`) from `tools/gen_torch_j2k_ht.py`.

Needs PIL and numpy. The output is deterministic: running it again
writes the same bytes.
"""
import hashlib
import importlib.util
import io
import os
import struct
import subprocess
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "assets_torch")
CORNER = 128
SEED = 24

sys.path.insert(0, ROOT)
from vision_tpu_torch.scene import j2k as J  # noqa: E402


# ---------------------------------------------------------------------------
# the MQ coder and the raw (bypass) coder
# ---------------------------------------------------------------------------

QE = [0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
      0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
      0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
      0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
      0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
      0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601]
NMPS = [1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19,
        20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
        37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46]
NLPS = [1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16,
        17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
        33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46]
SWITCH = {0, 6, 14}
CTX_ZC, CTX_SC, CTX_MAG, CTX_AGG, CTX_UNI = 0, 9, 14, 17, 18
LAZY, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32


class Contexts:
    def __init__(self):
        self.reset()

    def reset(self):
        self.state = [0] * 19
        self.mps = [0] * 19
        self.state[CTX_UNI], self.state[CTX_AGG], self.state[CTX_ZC] = 46, 3, 4


class MqEncoder:
    """ISO 15444-1 C.2's encoder, its bytes in `out`."""

    def __init__(self):
        self.out = bytearray()
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.b = 0         # the byte at BP (at first the one before the data)

    def _byteout(self):
        if self.b == 0xFF:
            self._emit(self.c >> 20)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            self._emit(self.c >> 19)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self._carry()
            if self.b == 0xFF:
                self.c &= 0x7FFFFFF
                self._emit(self.c >> 20)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self._emit(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct = 8

    def _carry(self):
        self.b += 1
        if self.out:
            self.out[-1] = self.b

    def _emit(self, v):
        self.out.append(v & 0xFF)
        self.b = v & 0xFF

    def _renorm(self):
        while True:
            self.a = (self.a << 1) & 0xFFFF
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def encode(self, ctx, cx, d):
        s = ctx.state[cx]
        qe = QE[s]
        if d == ctx.mps[cx]:
            self.a -= qe
            if self.a & 0x8000 == 0:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                ctx.state[cx] = NMPS[s]
                self._renorm()
            else:
                self.c += qe
        else:
            self.a -= qe
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if s in SWITCH:
                ctx.mps[cx] = 1 - ctx.mps[cx]
            ctx.state[cx] = NLPS[s]
            self._renorm()

    def flush(self):
        """FLUSH: SETBITS, two byte-outs, a final 0xFF dropped."""
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        if self.out and self.out[-1] == 0xFF:
            self.out.pop()
        return bytes(self.out)


class RawEncoder:
    """The bypass passes' raw bits: a byte after 0xFF holds 7."""

    def __init__(self):
        self.out = bytearray()
        self.cur, self.n, self.cap = 0, 0, 8

    def bit(self, b):
        self.cur = (self.cur << 1) | b
        self.n += 1
        if self.n == self.cap:
            self.out.append(self.cur)
            self.cap = 7 if self.cur == 0xFF else 8
            self.cur, self.n = 0, 0

    def flush(self):
        if self.n:
            self.out.append(self.cur << (self.cap - self.n))
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)
        return bytes(self.out)


# ---------------------------------------------------------------------------
# tier-1 (the decoder's context rules, `csrc/j2k_codec.cpp`, run forward)
# ---------------------------------------------------------------------------

def _zc(f, orient):
    h = ((f >> 2) & 1) + ((f >> 3) & 1)
    v = (f & 1) + ((f >> 1) & 1)
    d = sum((f >> k) & 1 for k in (4, 5, 6, 7))
    if orient == 1:
        h, v = v, h
    if orient == 3:
        hv = h + v
        if d == 0:
            return min(hv, 2)
        if d == 1:
            return 3 + min(hv, 2)
        if d == 2:
            return 6 if hv == 0 else 7
        return 8
    if h == 0:
        if v == 0:
            return min(d, 2)
        return 3 if v == 1 else 4
    if h == 1:
        return (5 if d == 0 else 6) if v == 0 else 7
    return 8


def _sc(f):
    """(context, xor bit) from the direct neighbours' significance and
    signs (flags bits 0-3 and 8-11)."""
    def c(sig, neg):
        return 0 if not sig else (-1 if neg else 1)
    hc = c(f & 4, f & 1024) + c(f & 8, f & 2048)
    vc = c(f & 1, f & 256) + c(f & 2, f & 512)
    hc, vc = max(-1, min(1, hc)), max(-1, min(1, vc))
    table = {(1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0),
             (0, 1): (10, 0), (0, 0): (9, 0), (0, -1): (10, 1),
             (-1, 1): (11, 1), (-1, 0): (12, 1), (-1, -1): (13, 1)}
    return table[(hc, vc)]


SIG, VISIT, REFINED = 1 << 12, 1 << 13, 1 << 14


class _Flags:
    def __init__(self, w, h, vsc):
        self.w, self.h, self.vsc = w, h, vsc
        self.f = [[0] * (w + 2) for _ in range(h + 2)]

    def set_sig(self, x, y, neg):
        f = self.f
        X, Y = x + 1, y + 1
        f[Y][X] |= SIG
        if not (self.vsc and y % 4 == 0):
            f[Y - 1][X - 1] |= 1 << 7
            f[Y - 1][X] |= 2 | (512 if neg else 0)
            f[Y - 1][X + 1] |= 1 << 6
        f[Y][X - 1] |= 8 | (2048 if neg else 0)
        f[Y][X + 1] |= 4 | (1024 if neg else 0)
        f[Y + 1][X - 1] |= 1 << 5
        f[Y + 1][X] |= 1 | (256 if neg else 0)
        f[Y + 1][X + 1] |= 1 << 4


def t1_encode(coef, orient, sty):
    """One code-block's coefficients (int [h, w], signed) -> (bit-planes K,
    segments [(bytes, passes)]) as the decoder's passes read them."""
    h, w = coef.shape
    mag = np.abs(coef).astype(np.int64)
    neg = coef < 0
    K = int(mag.max()).bit_length() if mag.size else 0
    if K == 0:
        return 0, []
    fl = _Flags(w, h, bool(sty & VSC))
    F = fl.f
    ctx = Contexts()
    passes = []           # (kind, plane)
    passes.append(("cln", K - 1))
    for p in range(K - 2, -1, -1):
        passes += [("sig", p), ("ref", p), ("cln", p)]
    # segment boundaries (the maxpasses of opj_t2_init_seg)
    segs, cur, maxp, first = [], [], None, True
    for i, ps in enumerate(passes):
        if maxp is None:
            if sty & TERMALL:
                maxp = 1
            elif sty & LAZY:
                maxp = 10 if first else (2 if prev_max in (1, 10) else 1)
            else:
                maxp = 109
            first = False
        cur.append(ps)
        if len(cur) == maxp or i == len(passes) - 1:
            segs.append(cur)
            prev_max = maxp
            cur, maxp = [], None
    out = []
    bpno_seen = 0
    for seg in segs:
        # bypass: raw for sig / ref passes after the first 10 passes
        raw = bool(sty & LAZY) and seg[0][0] != "cln" and bpno_seen >= 10
        enc = RawEncoder() if raw else MqEncoder()
        for kind, p in seg:
            bpno_seen += 1
            bit = lambda y, x: (mag[y, x] >> p) & 1  # noqa: E731
            for y0 in range(0, h, 4):
                y1 = min(y0 + 4, h)
                for x in range(w):
                    if kind == "sig":
                        for y in range(y0, y1):
                            f = F[y + 1][x + 1]
                            if f & (SIG | VISIT) or not f & 0xFF:
                                continue
                            b = bit(y, x)
                            if raw:
                                enc.bit(b)
                            else:
                                enc.encode(ctx, CTX_ZC + _zc(f & 0xFF, orient), b)
                            if b:
                                if raw:
                                    enc.bit(int(neg[y, x]))
                                else:
                                    c, xr = _sc(f)
                                    enc.encode(ctx, c, int(neg[y, x]) ^ xr)
                                fl.set_sig(x, y, neg[y, x])
                            F[y + 1][x + 1] |= VISIT
                    elif kind == "ref":
                        for y in range(y0, y1):
                            f = F[y + 1][x + 1]
                            if f & (SIG | VISIT) != SIG:
                                continue
                            b = bit(y, x)
                            if raw:
                                enc.bit(b)
                            else:
                                cx = CTX_MAG + (2 if f & REFINED else
                                                1 if f & 0xFF else 0)
                                enc.encode(ctx, cx, b)
                            F[y + 1][x + 1] |= REFINED
                    else:
                        start = y0
                        if y1 - y0 == 4 and all(
                                F[y + 1][x + 1] & (SIG | VISIT | 0xFF) == 0
                                for y in range(y0, y1)):
                            rows = [y for y in range(y0, y1) if bit(y, x)]
                            enc.encode(ctx, CTX_AGG, int(bool(rows)))
                            if not rows:
                                continue
                            r = rows[0] - y0
                            enc.encode(ctx, CTX_UNI, r >> 1)
                            enc.encode(ctx, CTX_UNI, r & 1)
                            y = rows[0]
                            c, xr = _sc(F[y + 1][x + 1])
                            enc.encode(ctx, c, int(neg[y, x]) ^ xr)
                            fl.set_sig(x, y, neg[y, x])
                            start = y + 1
                        for y in range(start, y1):
                            f = F[y + 1][x + 1]
                            if f & (SIG | VISIT):
                                continue
                            b = bit(y, x)
                            enc.encode(ctx, CTX_ZC + _zc(f & 0xFF, orient), b)
                            if b:
                                c, xr = _sc(F[y + 1][x + 1])
                                enc.encode(ctx, c, int(neg[y, x]) ^ xr)
                                fl.set_sig(x, y, neg[y, x])
                        for y in range(y0, y1):
                            F[y + 1][x + 1] &= ~VISIT
            if kind == "cln" and sty & SEGSYM:
                for b in (1, 0, 1, 0):
                    enc.encode(ctx, CTX_UNI, b)
            if sty & RESET and not raw:
                ctx.reset()
        out.append((enc.flush(), len(seg)))
    return K, out


# ---------------------------------------------------------------------------
# tier-2 and the codestream
# ---------------------------------------------------------------------------

class BitWriter:
    """opj_bio_t writing: a byte after 0xFF holds 7 bits."""

    def __init__(self):
        self.out = bytearray()
        self.buf, self.ct = 0, 8

    def _byteout(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def bit(self, b):
        if self.ct == 0:
            self._byteout()
        self.ct -= 1
        self.buf |= b << self.ct

    def bits(self, v, n):
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def flush(self):
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


class TagTreeEnc:
    def __init__(self, w, h, values):
        self.tree = J._TagTree(w, h)
        n = len(self.tree.parent)
        self.value = [1 << 30] * n
        for i, v in enumerate(values):
            node = i
            while node >= 0 and self.value[node] > v:
                self.value[node] = v
                node = self.tree.parent[node]
        self.low = [0] * n
        self.known = [False] * n

    def encode(self, bw, leaf, threshold):
        stk, node = [], leaf
        while self.tree.parent[node] >= 0:
            stk.append(node)
            node = self.tree.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bw.bit(1)
                        self.known[node] = True
                    break
                bw.bit(0)
                low += 1
            self.low[node] = low
            if not stk:
                break
            node = stk.pop()


def _numpasses(bw, n):
    if n == 1:
        bw.bit(0)
    elif n == 2:
        bw.bits(0b10, 2)
    elif n <= 5:
        bw.bits(0b11, 2)
        bw.bits(n - 3, 2)
    elif n <= 36:
        bw.bits(0b1111, 4)
        bw.bits(n - 6, 5)
    else:
        bw.bits(0b111111111, 9)
        bw.bits(n - 37, 7)


def marker(code, body):
    return struct.pack(">HH", code, len(body) + 2) + body


def siz(w, h, comps, x0=0, y0=0, tile=None, tile_off=(0, 0), rsiz=0):
    """comps: (prec, signed, dx, dy) each."""
    tw, th = tile or (w + x0, h + y0)
    body = struct.pack(">HIIIIIIIIH", rsiz, w + x0, h + y0, x0, y0, tw, th,
                       tile_off[0], tile_off[1], len(comps))
    for prec, sgnd, dx, dy in comps:
        body += bytes([(prec - 1) | (0x80 if sgnd else 0), dx, dy])
    return marker(0xFF51, body)


def spcod(numres, cblk=(5, 5), sty=0, qmf=1, precincts=None):
    b = bytes([numres - 1, cblk[0] - 2, cblk[1] - 2, sty, qmf])
    if precincts:
        b += bytes(precincts[:numres])
    return b


def cod(numres, layers=1, prg=0, mct=0, csty=0, **kw):
    if kw.get("precincts"):
        csty |= 1
    return marker(0xFF52, bytes([csty, prg]) + struct.pack(">H", layers) +
                  bytes([mct]) + spcod(numres, **kw))


def coc(comp, numres, **kw):
    csty = 1 if kw.get("precincts") else 0
    return marker(0xFF53, bytes([comp, csty]) + spcod(numres, **kw))


def sqcd(style, guard, steps):
    """style 0: steps are exponents; 1 (derived) / 2: (expn, mant)."""
    b = bytes([(guard << 5) | style])
    if style == 0:
        b += bytes(e << 3 for e in steps)
    else:
        b += b"".join(struct.pack(">H", (e << 11) | m) for e, m in steps)
    return b


def qcd(style, guard, steps):
    return marker(0xFF5C, sqcd(style, guard, steps))


def qcc(comp, style, guard, steps):
    return marker(0xFF5D, bytes([comp]) + sqcd(style, guard, steps))


def rgn(comp, shift):
    return marker(0xFF5E, bytes([comp, 0, shift]))


def poc(entries):
    return marker(0xFF5F, b"".join(struct.pack(">BBHBBB", *e)
                                   for e in entries))


def rev_steps(numres, prec):
    """Reversible 'no quantisation' exponents: the precision plus each
    band's gain (LL 0, HL / LH 1, HH 2)."""
    out = [prec]
    for _ in range(numres - 1):
        out += [prec + 1, prec + 1, prec + 2]
    return out


class J2kWriter:
    """A codestream of seeded random coefficients. `header` is the main
    header's markers after SIZ (COD, QCD and the rest, bytes); `bits`
    bounds each component's magnitudes; `roi` (comp -> shift) lifts a
    rectangle of each band's coefficients by the shift. `coefs`, where
    given, takes the place of the random ones: (comp, resno, band,
    code-block) -> the code-block's coefficients
    (`tools/gen_torch_j2k_cv.py` `lossless_coefs`). `tile_headers`
    (tile index -> marker segments, bytes) go into that tile's first
    tile-part header, and its coding parameters follow them."""

    def __init__(self, w, h, comps, header, seed, x0=0, y0=0, tile=None,
                 tile_off=(0, 0), bits=5, roi=None, layers_split=False,
                 sop=False, eph=False, ppm=False, ppt=False, parts=1,
                 coefs=None, tile_headers=None):
        self.coefs = coefs
        self.tile_headers = tile_headers or {}
        self.rng = np.random.default_rng(seed)
        self.main = (b"\xffO" + siz(w, h, comps, x0, y0, tile, tile_off) +
                     header)
        self.bits, self.roi = bits, roi or {}
        self.layers_split = layers_split
        self.sop, self.eph, self.ppm, self.ppt, self.parts = \
            sop, eph, ppm, ppt, parts
        self.tnsot = parts

    def _coefs(self, comp, b, w, h):
        lim = (1 << self.bits) - 1
        if b.bandno == 0:
            v = self.rng.integers(-lim, lim + 1, (h, w))
        else:
            v = self.rng.integers(-lim, lim + 1, (h, w)) >> (
                1 + int(self.rng.integers(0, 3)))
            v[self.rng.random((h, w)) < 0.3] = 0
        s = self.roi.get(comp)
        if s:
            v = np.clip(v, -(1 << (s - 1)) + 1, (1 << (s - 1)) - 1)
            v[: h // 2, : w // 2] <<= s
        return v

    def build(self):
        cs = J._Codestream(self.main + b"\xff\x90", 0)
        cs.tcps = [cs.default.copy() for _ in range(cs.tw * cs.th)]
        for tileno, segs in self.tile_headers.items():
            pos = 0
            while pos < len(segs):
                code, n = struct.unpack_from(">HH", segs, pos)
                cs._handler(code, segs[pos + 4:pos + 2 + n], cs.tcps[tileno])
                pos += 2 + n
        tiles = []
        ppm_parts = []
        for tileno in range(cs.tw * cs.th):
            tcp = cs.tcps[tileno]
            box, comps = J._tile_geometry(cs, tileno, tcp)
            # code each code-block
            coded = {}
            for c, cp in enumerate(comps):
                sty = cp["tccp"].cblksty
                s = cp["tccp"].roishift
                for resno, r in enumerate(cp["res"]):
                    for bi, b in enumerate(r.bands):
                        for pi_, pr in enumerate(b.prcs):
                            for k, cb in enumerate(pr.cblks):
                                cw, ch = cb.x1 - cb.x0, cb.y1 - cb.y0
                                if cw <= 0 or ch <= 0:
                                    coded[(c, resno, bi, pi_, k)] = (0, [], s)
                                    continue
                                coef = self._coefs(c, b, cw, ch) if \
                                    self.coefs is None else \
                                    self.coefs(c, resno, b, cb)
                                K, segs = self.code_block(coef, b, sty)
                                coded[(c, resno, bi, pi_, k)] = (K, segs, s)
            state = {}
            heads, bodies = [], []
            self.nsop = 0
            for lay, resno, c, prec in J._packets(tcp, comps, box):
                sop, hd, bd = self._packet(comps, coded, state, tcp, lay,
                                           resno, c, prec)
                heads.append(hd)
                bodies.append(sop + bd)
            tiles.append((tileno, heads, bodies))
        out = bytearray(self.main)
        if self.ppm:
            # one Nppm and its headers per tile-part
            body = b""
            for _, heads, _ in tiles:
                n = len(heads)
                cuts = [round(i * n / self.parts)
                        for i in range(self.parts + 1)]
                for part in range(self.parts):
                    h = b"".join(heads[cuts[part]:cuts[part + 1]])
                    body += struct.pack(">I", len(h)) + h
            out += marker(0xFF60, b"\0" + body)
        for tileno, heads, bodies in tiles:
            n = len(heads)
            cuts = [round(i * n / self.parts) for i in range(self.parts + 1)]
            for part in range(self.parts):
                seg = range(cuts[part], cuts[part + 1])
                hdr = self.tile_headers.get(tileno, b"") if part == 0 \
                    else b""
                if self.ppt:
                    hdr += marker(0xFF61, bytes([part]) +
                                  b"".join(heads[i] for i in seg))
                if self.ppm or self.ppt:
                    data = b"".join(bodies[i] for i in seg)
                else:
                    data = b"".join(bodies[i][:6 if self.sop else 0] +
                                    heads[i] + bodies[i][6 if self.sop else 0:]
                                    for i in seg)
                psot = 12 + len(hdr) + 2 + len(data)
                out += struct.pack(">HHHIBB", 0xFF90, 10, tileno, psot, part,
                                   self.tnsot)
                out += hdr + b"\xff\x93" + data
        return bytes(out + b"\xff\xd9")

    def code_block(self, coef, band, sty):
        """One code-block -> (its bit-planes K, [(bytes, passes)]
        codeword segments)."""
        return t1_encode(coef, band.bandno, sty)

    def _plan(self, total, k, nlay):
        """Cumulative passes of one code-block after each layer."""
        if not total:
            return [0] * nlay
        if not self.layers_split or nlay == 1:
            return [total] * nlay
        # odd code-blocks start a layer late; the others send about half
        # their passes first
        plan = []
        for lay in range(nlay):
            if k % 2 and lay == 0:
                plan.append(0)
            elif lay == nlay - 1:
                plan.append(total)
            else:
                plan.append(max(1, (total * (lay + 1)) // nlay))
        return plan

    def _packet(self, comps, coded, state, tcp, lay, resno, c, prec):
        """One packet -> (its SOP marker, its header (EPH included), its
        body)."""
        cp = comps[c]
        r = cp["res"][resno]
        nlay = tcp.numlayers
        bw = BitWriter()
        body = bytearray()
        entries = []
        for bi, b in enumerate(r.bands):
            if b.x1 - b.x0 == 0 or b.y1 - b.y0 == 0:
                continue
            pr = b.prcs[prec]
            key = (c, resno, bi, prec)
            if key not in state:
                plans, first, zb = [], [], []
                for k in range(len(pr.cblks)):
                    K, segs, s = coded[key + (k,)]
                    plan = self._plan(sum(n for _, n in segs), k, nlay)
                    plans.append(plan)
                    first.append(next((i for i, v in enumerate(plan) if v),
                                      nlay + 1))
                    # P = Mb - numbps, numbps = K - roishift
                    zb.append(b.numbps - (K - s) if segs else 0)
                if min(zb, default=0) < 0:
                    raise ValueError("band bit-planes (Mb) too few")
                n = len(pr.cblks)
                state[key] = dict(
                    incl=TagTreeEnc(pr.cw, pr.ch, first) if n else None,
                    imsb=TagTreeEnc(pr.cw, pr.ch, zb) if n else None,
                    plans=plans, first=first, sent=[0] * n, lblock=[3] * n)
            entries.append((pr, key))
        present = any(st["plans"][k][lay] > st["sent"][k]
                      for st in (state[key] for _, key in entries)
                      for k in range(len(st["plans"])))
        bw.bit(int(present))
        if present:
            for pr, key in entries:
                st = state[key]
                for k in range(len(pr.cblks)):
                    K, segs, _ = coded[key + (k,)]
                    upto, sent = st["plans"][k][lay], st["sent"][k]
                    if sent == 0:
                        st["incl"].encode(bw, k, lay + 1)
                        if st["first"][k] > lay:
                            continue
                        st["imsb"].encode(bw, k, st["imsb"].value[k] + 1)
                    else:
                        bw.bit(int(upto > sent))
                        if upto == sent:
                            continue
                    pieces = _split(segs, sent, upto)
                    _numpasses(bw, upto - sent)
                    inc = 0
                    while any(len(d) >= 1 << (st["lblock"][k] + inc +
                                              n.bit_length() - 1)
                              for d, n in pieces):
                        inc += 1
                    bw.bits((1 << (inc + 1)) - 2, inc + 1)
                    st["lblock"][k] += inc
                    for d, n in pieces:
                        bw.bits(len(d), st["lblock"][k] + n.bit_length() - 1)
                        body += d
                    st["sent"][k] = upto
        head = bw.flush()
        if self.eph:
            head += b"\xff\x92"
        sop = struct.pack(">HHH", 0xFF91, 4, self.nsop & 0xFFFF) \
            if self.sop else b""
        self.nsop += 1
        return sop, head, bytes(body)


def _split(segs, start, end):
    """The pieces of a code-block's codeword segments that hold its passes
    [start, end): (bytes, passes) each, in segment order; a segment cut by
    a layer gives each layer a share of its bytes."""
    out, i = [], 0
    for data, n in segs:
        lo, hi = max(start, i), min(end, i + n)
        if lo < hi:
            b0 = len(data) * (lo - i) // n
            b1 = len(data) if hi == i + n else len(data) * (hi - i) // n
            out.append((data[b0:b1], hi - lo))
        i += n
    return out


# ---------------------------------------------------------------------------
# JP2 boxes
# ---------------------------------------------------------------------------

def box(typ, payload):
    return struct.pack(">I4s", len(payload) + 8, typ) + payload


def boxes(data):
    """The boxes of a JP2 file (or a superbox's payload): [(type, payload)]."""
    out, pos = [], 0
    while pos < len(data):
        n, t = struct.unpack_from(">I4s", data, pos)
        out.append((t, data[pos + 8:pos + n]))
        pos += n
    return out


def jp2(codestream, w, h, nc, bpc=7, colr=(1, 17), extra=(), ihdr_c=7):
    """A JP2 file around a codestream: signature, ftyp, jp2h (ihdr, colr of
    (meth, enumcs) or (2, icc bytes), then `extra` sub-boxes), jp2c."""
    meth, v = colr
    cbody = bytes([meth, 0, 0]) + (struct.pack(">I", v) if meth == 1 else v)
    head = box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, ihdr_c, 0, 0))
    head += box(b"colr", cbody) + b"".join(box(t, p) for t, p in extra)
    return (b"\0\0\0\x0cjP  \r\n\x87\n" +
            box(b"ftyp", b"jp2 \0\0\0\0jp2 ") + box(b"jp2h", head) +
            box(b"jp2c", codestream))


def pclr(entries, depths=None):
    """A pclr box's payload: entries [(v0, v1, ...)], 8-bit columns unless
    `depths` (Bi bytes) says otherwise."""
    npc = len(entries[0])
    depths = depths or [7] * npc
    body = struct.pack(">HB", len(entries), npc) + bytes(depths)
    for e in entries:
        for v, d in zip(e, depths):
            n = min(((d & 0x7F) + 8) >> 3, 4)
            body += v.to_bytes(n, "big")
    return body


def cmap(npc):
    return b"".join(struct.pack(">HBB", 0, 1, i) for i in range(npc))


def codestream_of(jp2_bytes):
    return dict(boxes(jp2_bytes))[b"jp2c"]


# ---------------------------------------------------------------------------
# the files
# ---------------------------------------------------------------------------

_ENCODE = (
    "import ast, io, sys\n"
    "import numpy as np\n"
    "from PIL import Image\n"
    "a = np.load(io.BytesIO(sys.stdin.buffer.read()))\n"
    "b = io.BytesIO()\n"
    "Image.fromarray(a).save(b, 'JPEG2000', **ast.literal_eval(sys.argv[1]))\n"
    "sys.stdout.buffer.write(b.getvalue())\n")


def pil_encode(arr, **kw):
    """PIL's JPEG 2000 encoder (OpenJPEG's) in a child process, as some
    settings crash it -> bytes."""
    buf = io.BytesIO()
    np.save(buf, arr)
    proc = subprocess.run([sys.executable, "-c", _ENCODE, repr(kw)],
                          input=buf.getvalue(), capture_output=True)
    if proc.returncode or not proc.stdout:
        raise RuntimeError(f"PIL's encoder failed on {kw}")
    return proc.stdout


def _smooth(g, h, w, bands):
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    ph = g.random(bands) * 6
    v = np.stack([np.sin(7 * x + 3 * y + ph[i]) * np.cos(5 * y - 2 * x + i)
                  for i in range(bands)], -1)
    a = 128 + 100 * v + g.normal(0, 12, (h, w, bands))
    return np.clip(np.round(a), 0, 255).astype(np.uint8)


def _ht(cs):
    """A codestream with the HT bit set in its COD's code-block style."""
    i = cs.index(b"\xff\x52")
    return cs[:i + 12] + bytes([cs[i + 12] | 0x40]) + cs[i + 13:]


def pil_files():
    """Files of PIL's encoder, and JP2 files around its codestreams with
    their boxes edited."""
    g = np.random.default_rng(SEED)
    f = {}
    grey = _smooth(g, 40, 37, 1)[..., 0]
    rgb = _smooth(g, 33, 45, 3)
    rgba = np.dstack([_smooth(g, 29, 31, 3), g.integers(0, 256, (29, 31))
                      .astype(np.uint8)])
    la = np.dstack([grey, grey[::-1]])
    i16 = (g.integers(0, 400, (21, 26)) + np.arange(26) * 9).astype(
        np.uint16)
    f["j2k_l_rev.j2k"] = pil_encode(grey, no_jp2=True)
    f["j2k_l_irr.jp2"] = pil_encode(grey, irreversible=True)
    f["j2k_la_rev.jp2"] = pil_encode(la)
    f["j2k_la_irr.j2k"] = pil_encode(la, irreversible=True, no_jp2=True)
    f["j2k_rgb_rev.j2k"] = pil_encode(rgb, no_jp2=True)
    f["j2k_rgb_rev_mct.jp2"] = pil_encode(rgb, mct=1)
    f["j2k_rgb_irr.j2k"] = pil_encode(rgb, irreversible=True, no_jp2=True)
    f["j2k_rgb_irr_mct.jp2"] = pil_encode(rgb, irreversible=True, mct=1)
    f["j2k_rgba_rev.jp2"] = pil_encode(rgba)
    f["j2k_rgba_irr_mct.j2k"] = pil_encode(rgba, irreversible=True, mct=1,
                                           no_jp2=True)
    f["j2k_i16_rev.jp2"] = pil_encode(i16)
    f["j2k_i16_irr.j2k"] = pil_encode(i16, irreversible=True, no_jp2=True)
    for prg in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        f[f"j2k_prg_{prg.lower()}.jp2"] = pil_encode(
            rgb, progression=prg, precinct_size=(16, 16),
            codeblock_size=(8, 8), tile_size=(20, 20),
            quality_layers=[20, 10, 5], quality_mode="rates",
            offset=(3, 5), tile_offset=(1, 2), mct=int(prg in ("RPCL",
                                                             "CPRL")))
    f["j2k_tiles_offset.j2k"] = pil_encode(rgb, tile_size=(16, 16),
                                           offset=(3, 5), tile_offset=(1, 2),
                                           no_jp2=True)
    f["j2k_tiles_irr.jp2"] = pil_encode(grey, tile_size=(12, 17),
                                        irreversible=True, mct=1)
    f["j2k_offset_irr.jp2"] = pil_encode(rgb, offset=(7, 2), tile_size=(60, 40),
                                         irreversible=True, mct=1)
    f["j2k_cblk_4x64.jp2"] = pil_encode(rgb, codeblock_size=(4, 64))
    f["j2k_cblk_64x4.j2k"] = pil_encode(grey, codeblock_size=(64, 4),
                                        irreversible=True, no_jp2=True)
    f["j2k_prec_16.jp2"] = pil_encode(rgb, precinct_size=(16, 16),
                                      codeblock_size=(8, 8),
                                      num_resolutions=3)
    # PIL writes precincts of exponent 0 past the lowest resolution here,
    # which OpenJPEG refuses
    f["j2k_bad_prec_16.jp2"] = pil_encode(rgb, precinct_size=(16, 16),
                                          codeblock_size=(8, 8))
    f["j2k_layers_irr.jp2"] = pil_encode(rgb, quality_layers=[40, 20, 10],
                                         quality_mode="rates",
                                         irreversible=True, mct=1)
    f["j2k_layers_db.j2k"] = pil_encode(grey, quality_layers=[30, 40, 50],
                                        quality_mode="dB", no_jp2=True)
    f["j2k_res1.jp2"] = pil_encode(rgb, num_resolutions=1)
    f["j2k_res7_irr.jp2"] = pil_encode(_smooth(g, 70, 66, 3),
                                       num_resolutions=7, irreversible=True)
    f["j2k_signed_l.j2k"] = pil_encode(grey, signed=True, no_jp2=True)
    f["j2k_signed_rgb_irr.jp2"] = pil_encode(rgb, signed=True,
                                             irreversible=True)
    f["j2k_plt.jp2"] = pil_encode(rgb, plt=True, tile_size=(16, 16))
    f["j2k_comment.j2k"] = pil_encode(grey, comment="a comment",
                                      no_jp2=True)
    # JP2 boxes PIL's encoder does not write
    c3 = codestream_of(pil_encode(rgb, mct=1))
    c4 = codestream_of(pil_encode(rgba))
    idx = (np.add.outer(np.arange(12), np.arange(16)) % 7).astype(np.uint8)
    c1 = codestream_of(pil_encode(idx))
    c2 = codestream_of(pil_encode(np.dstack([idx, idx * 30])))
    pal3 = [(10, 20, 30), (40, 50, 60), (10, 20, 30), (200, 0, 0),
            (0, 200, 0)]
    pal4 = [(10, 20, 30, 40), (40, 50, 60, 255), (10, 20, 30, 40),
            (200, 0, 0, 0)]
    pal1 = [(v,) for v in (5, 100, 5, 200, 250, 3, 9)]
    f["j2k_cmyk.jp2"] = jp2(c4, 31, 29, 4, colr=(1, 12))
    f["j2k_sycc.jp2"] = jp2(c3, 45, 33, 3, colr=(1, 18))
    f["j2k_sycca.jp2"] = jp2(c4, 31, 29, 4, colr=(1, 18))
    f["j2k_grey4.jp2"] = jp2(c4, 31, 29, 4, colr=(1, 17))
    f["j2k_icc.jp2"] = jp2(c3, 45, 33, 3, colr=(2, bytes(24)))
    f["j2k_enum99.jp2"] = jp2(c3, 45, 33, 3, colr=(1, 99))
    f["j2k_ihdr3_cs4.jp2"] = jp2(c4, 31, 29, 3, colr=(1, 16))
    f["j2k_ihdr4_cs3.jp2"] = jp2(c3, 45, 33, 4, colr=(1, 16))
    f["j2k_p3.jp2"] = jp2(c1, 16, 12, 1, colr=(1, 16),
                          extra=[(b"pclr", pclr(pal3)), (b"cmap", cmap(3))])
    f["j2k_p4.jp2"] = jp2(c1, 16, 12, 1, colr=(1, 16),
                          extra=[(b"pclr", pclr(pal4))])
    f["j2k_p1.jp2"] = jp2(c1, 16, 12, 1, colr=(1, 16),
                          extra=[(b"pclr", pclr(pal1))])
    f["j2k_pa.jp2"] = jp2(c2, 16, 12, 2, colr=(1, 16),
                          extra=[(b"pclr", pclr(pal3))])
    f["j2k_bad_pclr_grey.jp2"] = jp2(c1, 16, 12, 1, colr=(1, 17),
                                     extra=[(b"pclr", pclr(pal3))])
    f["j2k_bad_pclr_12bit.jp2"] = jp2(c1, 16, 12, 1, colr=(1, 16),
                                      extra=[(b"pclr", pclr(
                                          [(1, 2, 3)] * 7, [11, 7, 7]))])
    f["j2k_bad_eycc.jp2"] = jp2(c4, 31, 29, 4, colr=(1, 24))
    f["j2k_bad_ihdr_size.jp2"] = jp2(c4, 30, 29, 4, colr=(1, 16))
    cut = f["j2k_rgb_irr_mct.jp2"]
    f["j2k_bad_cut.jp2"] = cut[:len(cut) * 2 // 3]
    f["j2k_bad_noeoc.j2k"] = f["j2k_rgb_rev.j2k"][:-2]
    return f


def _rev(numres, prec=8, **kw):
    return cod(numres, **kw) + qcd(0, 2, rev_steps(numres, prec))


def writer_files():
    """Files of this file's writer: code-block styles, ROI, SOP / EPH,
    COC / QCC, POC, PPM / PPT, tile-parts, precisions, quantisation
    styles and sub-sampled components."""
    f = {}
    one = [(8, 0, 1, 1)]
    rgb = [(8, 0, 1, 1)] * 3
    for name, sty in (("bypass", LAZY), ("reset", RESET),
                      ("termall", TERMALL), ("vsc", VSC), ("pterm", PTERM),
                      ("segsym", SEGSYM), ("bypass_termall", LAZY | TERMALL),
                      ("bypass_reset_vsc", LAZY | RESET | VSC),
                      ("all", 0x3F)):
        f[f"j2k_sty_{name}.j2k"] = J2kWriter(
            30, 21, one, _rev(3, sty=sty, cblk=(4, 4)), 100 + sty,
            bits=8).build()
    steps = [(9, 100)] + [(9, 50), (9, 60), (10, 10)] * 2
    f["j2k_sty_all_irr.j2k"] = J2kWriter(
        24, 20, rgb, cod(3, sty=0x3F, cblk=(4, 3), qmf=0, mct=1) +
        qcd(2, 2, steps), 130, bits=7).build()
    f["j2k_roi.j2k"] = J2kWriter(24, 20, one, _rev(3, cblk=(4, 4)) +
                                 rgn(0, 6), 5, roi={0: 6}).build()
    f["j2k_roi_rgb_irr.j2k"] = J2kWriter(
        24, 20, rgb, cod(3, cblk=(4, 4), qmf=0, mct=1) + qcd(2, 2, steps) +
        rgn(1, 7), 6, roi={1: 7}).build()
    f["j2k_sop_eph.j2k"] = J2kWriter(
        30, 21, one, _rev(3, csty=6, layers=2), 7, sop=True, eph=True,
        layers_split=True).build()
    f["j2k_sop.j2k"] = J2kWriter(30, 21, rgb, _rev(2, csty=2, prg=2), 8,
                                 sop=True, tile=(16, 16)).build()
    f["j2k_eph.j2k"] = J2kWriter(30, 21, one, _rev(3, csty=4, layers=3), 9,
                                 eph=True, layers_split=True).build()
    f["j2k_coc_qcc.j2k"] = J2kWriter(
        24, 20, rgb, _rev(3, cblk=(4, 4)) + coc(1, 2, cblk=(3, 5),
                                                sty=LAZY | TERMALL) +
        qcc(1, 0, 3, rev_steps(2, 8)) +
        coc(2, 4, cblk=(5, 3), sty=VSC | SEGSYM,
            precincts=[0x33, 0x44, 0x55, 0x55]) +
        qcc(2, 0, 1, rev_steps(4, 8)), 4).build()
    f["j2k_bad_mct_coc.j2k"] = J2kWriter(
        24, 20, rgb, _rev(3, cblk=(4, 4), mct=1) + coc(1, 2) +
        qcc(1, 0, 2, rev_steps(2, 8)), 4).build()
    f["j2k_poc_reduced.j2k"] = J2kWriter(
        23, 19, rgb, _rev(3, cblk=(4, 4), mct=1) +
        poc([(0, 0, 1, 2, 3, 0)]), 44, tile=(12, 10)).build()
    f["j2k_mct_mixed.j2k"] = J2kWriter(
        24, 20, rgb, _rev(3, mct=1) + coc(2, 3, qmf=0) + qcc(2, 2, 2, steps),
        45).build()
    f["j2k_poc.j2k"] = J2kWriter(
        24, 20, rgb, _rev(3, cblk=(4, 4), layers=2) +
        poc([(0, 0, 1, 2, 2, 1), (0, 2, 2, 3, 3, 4), (0, 0, 2, 3, 3, 2)]),
        10, layers_split=True).build()
    hdr = _rev(3, cblk=(4, 4), layers=2)
    f["j2k_ppm.j2k"] = J2kWriter(24, 20, one, hdr, 11, layers_split=True,
                                 ppm=True, tile=(16, 16), parts=2).build()
    f["j2k_ppt.j2k"] = J2kWriter(24, 20, one, hdr, 12, layers_split=True,
                                 ppt=True, tile=(16, 16), parts=2).build()
    f["j2k_parts.j2k"] = J2kWriter(24, 20, rgb, hdr, 13, layers_split=True,
                                   tile=(16, 16), parts=3, sop=True).build()
    w = J2kWriter(24, 20, one, hdr, 14, tile=(16, 16), parts=2)
    w.tnsot = 0
    f["j2k_tnsot0.j2k"] = w.build()
    for prec, sgnd in ((1, 0), (4, 1), (5, 0), (12, 0), (12, 1), (23, 0)):
        f[f"j2k_prec{prec}{'s' if sgnd else ''}.j2k"] = J2kWriter(
            24, 20, [(prec, sgnd, 1, 1)], _rev(3, prec, cblk=(4, 4)),
            15 + prec, bits=min(prec, 6)).build()
    f["j2k_prec_mixed.j2k"] = J2kWriter(
        24, 20, [(12, 0, 1, 1), (5, 0, 1, 1), (8, 1, 1, 1)],
        _rev(3, 12, cblk=(4, 4)), 8).build()
    f["j2k_q_none_irr.j2k"] = J2kWriter(
        24, 20, one, cod(3, qmf=0) + qcd(0, 2, rev_steps(3, 8)), 30).build()
    f["j2k_q_derived.j2k"] = J2kWriter(
        24, 20, rgb, cod(3, qmf=0, mct=1) + qcd(1, 1, [(10, 300)]),
        31).build()
    f["j2k_q_expounded.j2k"] = J2kWriter(
        24, 20, rgb, cod(3, qmf=0) + qcd(2, 2, steps), 32).build()
    for name, comps, off in (
            ("420", [(8, 0, 1, 1), (8, 0, 2, 2), (8, 0, 2, 2)], (0, 0)),
            ("422_odd", [(8, 0, 1, 1), (8, 0, 2, 1), (8, 0, 2, 1)], (3, 1)),
            ("dx3", [(8, 0, 1, 1), (12, 1, 3, 2), (4, 0, 1, 3)], (1, 4)),
            ("first", [(8, 0, 2, 1), (8, 0, 1, 1), (8, 0, 1, 1)], (0, 0)),
            ("rgba", [(8, 0, 1, 1), (8, 0, 2, 2), (8, 0, 2, 2),
                      (8, 0, 1, 2)], (2, 2))):
        f[f"j2k_sub_{name}.j2k"] = J2kWriter(
            23, 19, comps, _rev(3, cblk=(4, 4)), 40, x0=off[0],
            y0=off[1]).build()
    cs = J2kWriter(22, 18, [(8, 0, 1, 1), (8, 0, 2, 2), (8, 0, 2, 2)],
                   _rev(3, cblk=(4, 4)), 41).build()
    f["j2k_sub_srgb.jp2"] = jp2(cs, 22, 18, 3, colr=(1, 16))
    f["j2k_sub_tiles.j2k"] = J2kWriter(
        30, 26, [(8, 0, 1, 1), (8, 0, 2, 2), (8, 0, 2, 2)],
        _rev(3, cblk=(4, 4)), 42, tile=(16, 12), x0=2, y0=3,
        tile_off=(1, 1)).build()
    f["j2k_bad_sub_grey.j2k"] = J2kWriter(
        23, 19, [(8, 0, 2, 1)], _rev(3, cblk=(4, 4)), 43).build()
    return f


def icns_file(resources):
    """An ICNS file of (type, payload) resources."""
    body = b"".join(struct.pack(">4sI", t, len(p) + 8) + p
                    for t, p in resources)
    return b"icns" + struct.pack(">I", len(body) + 8) + body


def icns_files():
    g = np.random.default_rng(SEED + 1)
    a = _smooth(g, 32, 32, 3)
    return {"j2k_icns.icns": icns_file([(b"icp5", pil_encode(
                a, irreversible=True))]),
            "j2k_icns_j2k.icns": icns_file([(b"icp4", pil_encode(
                np.dstack([a[:16, :16], a[:16, :16, 0]]), no_jp2=True))]),
            "j2k_icns_i16.icns": icns_file([(b"icp4", pil_encode(
                (a[:16, :16, 0] * 3).astype(np.uint16)))])}


def twin_files(checker_rgb, projector_rgb):
    """`checker_j2k.jp2`: the checker, 9/7, ICT, two quality layers;
    `projector_j2k.j2k`: the projector's RGB, 5/3, RCT, four tiles with a
    tile offset, PCRL, precincts."""
    return {"checker_j2k.jp2": pil_encode(
                checker_rgb, irreversible=True, mct=1,
                quality_layers=[8, 3], quality_mode="rates"),
            "projector_j2k.j2k": pil_encode(
                projector_rgb, mct=1, offset=(5, 3), tile_offset=(2, 1),
                tile_size=(70, 36), progression="PCRL",
                precinct_size=(32, 32), codeblock_size=(16, 16),
                no_jp2=True)}


def timing_image(n=2048):
    """The timing files' image: n^2 RGB, smooth waves and noise."""
    g = np.random.default_rng(SEED + 2)
    y, x = np.mgrid[0:n, 0:n] / n
    ph = g.random(3) * 6
    v = np.stack([np.sin(23 * x + 7 * y + ph[0]) * np.cos(11 * y + ph[1]),
                  np.cos(17 * y - 5 * x + ph[1]),
                  np.sin(31 * x * y + ph[2])], -1)
    return np.clip(np.round(128 + 90 * v + g.normal(0, 6, (n, n, 3))), 0,
                   255).astype(np.uint8)


def j2k_timing(n=2048):
    """2048^2 RGB, 9/7, six resolutions, 64 x 64 code-blocks, about 0.5
    bits a pixel."""
    return pil_encode(timing_image(n), irreversible=True, mct=1,
                      num_resolutions=6,
                      codeblock_size=(64, 64), quality_layers=[48],
                      quality_mode="rates")


def _p2_module():
    """`tools/gen_torch_j2k_p2.py`: Part 2's files (slice 7e.7d)."""
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_j2k_p2", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_j2k_p2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ht_module():
    """`tools/gen_torch_j2k_ht.py`: the HTJ2K files (slice 7e.7c)."""
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_j2k_ht", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_j2k_ht.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def j2k_files(checker_rgb, projector_rgb):
    f = {}
    f.update(pil_files())
    f.update(writer_files())
    f.update(icns_files())
    f.update(twin_files(checker_rgb, projector_rgb))
    p2 = _p2_module()
    f.update(p2.p2_files(f))
    f["checker_j2kp2.jp2"] = p2.checker_twin(checker_rgb)
    ht = _ht_module()
    f.update(ht.ht_files())
    f["checker_htj2k.jp2"] = ht.checker_twin(checker_rgb)
    return f


def write_j2k_files(out, checker_rgb, projector_rgb):
    """The files (`j2k_files`), the twins' PIL decodes as PNGs, the timing
    file `j2k_2048.jp2`, and `j2k_decodes.npz`: PIL's decode of each file
    it decodes (by path), the sha256 and 128 x 128 corner of its decode
    of `j2k_2048.jp2` under "j2k_2048.jp2:sha256" / ":corner", and Part
    2's edit outcomes and tile-resolution runs ("p2edits:sha256",
    "<name>:runs", `tools/gen_torch_j2k_p2.py`); slice 7e.7c's HT files,
    their edits' outcomes ("htedits:sha256") and the HT timing file
    `htj2k_2048.jp2` as `j2k_2048.jp2`'s (`tools/gen_torch_j2k_ht.py`,
    which checks its tables and its writer first)."""
    from PIL import Image
    dec = {}
    files = j2k_files(checker_rgb, projector_rgb)
    for fn, data in files.items():
        p = os.path.join(out, fn)
        with open(p, "wb") as fh:
            fh.write(data)
        try:
            dec[fn] = np.asarray(Image.open(p).convert("RGB"))
        except (OSError, SyntaxError, ValueError):
            assert fn.startswith(("j2k_bad_", "htj2k_bad_")), fn
            continue
        assert not fn.startswith(("j2k_bad_", "htj2k_bad_")), fn
    for fn in ("checker_j2k.jp2", "projector_j2k.j2k", "checker_j2kp2.jp2"):
        Image.fromarray(dec[fn]).save(os.path.join(
            out, fn.rsplit(".", 1)[0] + "_pil.png"))
    p2 = _p2_module()
    dec["p2edits:sha256"] = p2.edit_digests(files, "pil")
    for fn, runs in p2.res_runs(files, "pil").items():
        dec[fn + ":runs"] = runs
    timing = j2k_timing()
    with open(os.path.join(out, "j2k_2048.jp2"), "wb") as fh:
        fh.write(timing)
    full = np.asarray(Image.open(io.BytesIO(timing)).convert("RGB"))
    dec["j2k_2048.jp2:sha256"] = np.frombuffer(
        hashlib.sha256(full.tobytes()).digest(), np.uint8)
    dec["j2k_2048.jp2:corner"] = full[:CORNER, :CORNER]
    ht = _ht_module()
    ht.check_tables()
    ht.check_writer()
    ht.once_per_process(files, "pil")
    dec["htedits:sha256"] = ht.edit_digests(files, "pil")
    timing = ht.ht_timing()
    with open(os.path.join(out, "htj2k_2048.jp2"), "wb") as fh:
        fh.write(timing)
    full = np.asarray(Image.open(io.BytesIO(timing)).convert("RGB"))
    dec["htj2k_2048.jp2:sha256"] = np.frombuffer(
        hashlib.sha256(full.tobytes()).digest(), np.uint8)
    dec["htj2k_2048.jp2:corner"] = full[:CORNER, :CORNER]
    np.savez_compressed(os.path.join(out, "j2k_decodes.npz"), **dec)


def _assets_module():
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_assets_j2k", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_assets.py"))
    ga = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ga)
    return ga


def main():
    ga = _assets_module()
    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    write_j2k_files(out, ga.checker(), ga.projector()[..., :3])


if __name__ == "__main__":
    main()
