"""HTJ2K (JPEG 2000 Part 15, ITU-T T.814) files for `tests/assets_torch/`:
code-blocks written by this file's own HT block writer, as no encoder at
hand writes them.

    python tools/gen_torch_j2k_ht.py [out_dir]

(`tools/gen_torch_j2k.py` and `tools/gen_torch_j2k_cv.py` call it through
`ht_files`, so `j2k_decodes.npz` holds PIL's decode of each file and
`j2k_cv_decodes.npz` the pip cv2's; run alone it checks the tables and
writes the files.)

  * The block writer (`ht_block`): the cleanup pass as three streams, the
    MagSgn bits forwards (a 0 stuffed after each 0xFF), the MEL events
    (MSB first, a 0 stuffed after 0xFF) and the VLC stream backwards from
    the Scup suffix (a 0 stuffed where a byte above 0x8F is followed by
    seven 1s): the CxtVLC codewords of each quad, U-VLC for a quad pair
    (the first line pair's MEL-coded pairs above 2 included), E_max /
    kappa on the later line pairs; then SigProp (forwards) and MagRef
    (backwards) in one refinement segment, their scan read off OpenJPEG's
    decoder. The codewords come from the CxtVLC tables in
    `vision_tpu_torch/csrc/j2k_ht.cpp`, inverted (`codewords`).
  * `check_tables`: the tables, expanded into OpenJPEG's two 1024-entry
    decoding tables, are found entry for entry in Pillow's libopenjp2; the
    generator stops where they are not. `check_writer`: a reversible file
    of an 8-bit image decodes in PIL to that image.
  * `HtWriter`: `J2kWriter` of `tools/gen_torch_j2k.py` with HT blocks,
    Rsiz's Part 15 bit and a CAP marker (CPF on some files).

The files (`ht_files`): `htj2k_*` that the libraries decode, `htj2k_bad_*`
that PIL refuses (one per malformed-block check of OpenJPEG's HT decoder,
more than three passes, ROI, HTMIXED, a CAP in a tile-part header); the
twins' `checker_htj2k.jp2` (`checker_twin`) and `projector_htj2kcv.exr`
(`projector_twin`); the timing file `htj2k_2048.jp2` (`ht_timing`; the
.npz files keep each library's decode's sha256 and 128 x 128 corner);
and `edit_cases`, seeded edits of the HT files whose outcomes both .npz
files keep under "htedits:sha256". The generator also checks that
OpenJPEG's once-a-process warning changes no decode
(`once_per_process`).

Needs PIL and numpy. The output is deterministic: running it again
writes the same bytes.
"""
import glob
import importlib.util
import os
import re
import struct
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "assets_torch")
SOURCE = os.path.join(ROOT, "vision_tpu_torch", "csrc", "j2k_ht.cpp")
SEED = 27
HT = 0x40


def _j2k_module():
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_j2k_ht_base", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_j2k.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the CxtVLC tables
# ---------------------------------------------------------------------------

def tables():
    """The two CxtVLC tables of `csrc/j2k_ht.cpp`: [(c_q, rho, u_off, e_k,
    e_1, codeword, length)] for the first line pair and for the others."""
    src = open(SOURCE).read()
    out = []
    for name in ("kVlcInitial", "kVlcOther"):
        body = re.search(name + r"\[\d+\]\[7\] = \{(.*?)\};", src, re.S)[1]
        out.append([tuple(int(v) for v in m.split(","))
                    for m in re.findall(r"\{([^{}]*)\}", body)])
    return out


def expand(rows):
    """OpenJPEG's decoding table: entry (c_q << 7) | next 7 bits."""
    lut = np.zeros(1024, np.uint16)
    for i in range(1024):
        cq, cwd = i >> 7, i & 0x7F
        for c, rho, uoff, ek, e1, cw, n in rows:
            if c == cq and cw == cwd & ((1 << n) - 1):
                lut[i] = (ek << 12) | (e1 << 8) | (rho << 4) | (uoff << 3) | n
    return lut


def pillow_openjp2():
    """Pillow's libopenjp2, or None where it is not installed."""
    import PIL
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    found = sorted(glob.glob(os.path.join(libs, "libopenjp2*.so*")))
    return found[0] if found else None


def check_tables(lib=None):
    """Each expanded table found whole in `lib` (Pillow's libopenjp2 by
    default) -> their file offsets; raises naming the first entry that
    differs from the nearest copy in the library."""
    lib = lib or pillow_openjp2()
    data = open(lib, "rb").read()
    offsets = []
    for name, rows in zip(("initial", "other"), tables()):
        lut = expand(rows).astype("<u2").tobytes()
        pos = data.find(lut)
        if pos < 0:
            near = data.find(lut[:16])
            if near < 0:
                raise RuntimeError(f"the {name} table is not in {lib}")
            have = np.frombuffer(data[near:near + 2048], "<u2")
            want = np.frombuffer(lut, "<u2")
            i = int(np.flatnonzero(have != want)[0])
            raise RuntimeError(f"the {name} table's entry {i} is "
                               f"{want[i]:#06x}, {lib}'s {have[i]:#06x}")
        offsets.append(pos)
    return offsets


def codewords():
    """The inverted tables: {(line pair kind 0 / 1, c_q, rho, u_off):
    [(e_k, e_1, codeword, length)]}, shortest first."""
    out = {}
    for kind, rows in enumerate(tables()):
        for c, rho, uoff, ek, e1, cw, n in rows:
            out.setdefault((kind, c, rho, uoff), []).append((ek, e1, cw, n))
    for v in out.values():
        v.sort(key=lambda e: (e[3], e))
    return out


# ---------------------------------------------------------------------------
# bit writers
# ---------------------------------------------------------------------------

class Forward:
    """MagSgn / SigProp: bits LSB first, a 0 stuffed after each 0xFF; the
    last byte padded with `pad` bits."""

    def __init__(self, pad):
        self.out, self.cur, self.n, self.pad = bytearray(), 0, 0, pad
        self.room = 8

    def bits(self, v, n):
        for i in range(n):
            self.cur |= ((v >> i) & 1) << self.n
            self.n += 1
            if self.n == self.room:
                self._flush()

    def _flush(self):
        self.out.append(self.cur)
        self.room = 7 if self.cur == 0xFF else 8
        self.cur, self.n = 0, 0

    def finish(self):
        if self.n:
            if self.pad:
                self.cur |= ((1 << self.room) - 1) & ~((1 << self.n) - 1)
            self._flush()
        return bytes(self.out)


class Backward:
    """VLC / MagRef: bits LSB first into bytes that are read from the end
    backwards; a byte after one above 0x8F (in reading order) holds 7 bits
    where they are seven 1s. The VLC stream starts in the upper half of
    the byte before the last (`nibble`); MagRef starts as if a byte above
    0x8F came before its first."""

    def __init__(self, nibble):
        self.bitq = []
        self.nibble = nibble

    def bits(self, v, n):
        self.bitq += [(v >> i) & 1 for i in range(n)]

    def finish(self):
        """-> (the upper half of the byte before the last or None, the
        other bytes in reading order)."""
        q, i = self.bitq, 0

        def take(n):
            nonlocal i
            v = 0
            for k in range(n):
                v |= (q[i + k] if i + k < len(q) else 0) << k
            i += n
            return v
        half = None
        prev = True
        if self.nibble:
            v = take(3)
            if v == 7:
                half = 7
            else:
                v |= take(1) << 3
                half = v
            prev = (half << 4 | 0xF) > 0x8F
        out = bytearray()
        while i < len(q):
            v = take(7)
            if prev and v == 0x7F:
                b = 0x7F
            else:
                b = v | (take(1) << 7)
            out.append(b)
            prev = b > 0x8F
        return half, bytes(out)


class Mel:
    """The MEL coder: events into runs, MSB first, a 0 stuffed after
    0xFF."""

    EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)

    def __init__(self):
        self.k, self.run = 0, 0
        self.out, self.cur, self.n, self.room = bytearray(), 0, 0, 8

    def _bit(self, b):
        self.cur = (self.cur << 1) | b
        self.n += 1
        if self.n == self.room:
            self.out.append(self.cur)
            self.room = 7 if self.cur == 0xFF else 8
            self.cur, self.n = 0, 0

    def event(self, e):
        if not e:
            self.run += 1
            if self.run == 1 << self.EXP[self.k]:
                self._bit(1)
                self.run = 0
                self.k = min(self.k + 1, 12)
        else:
            self._bit(0)
            for i in range(self.EXP[self.k] - 1, -1, -1):
                self._bit((self.run >> i) & 1)
            self.run = 0
            self.k = max(self.k - 1, 0)

    def finish(self):
        if self.run:
            self._bit(1)
        if self.n:
            self.cur <<= self.room - self.n
            self.out.append(self.cur)
        if self.out and self.out[-1] == 0xFF:
            # a byte past the MEL bytes: OpenJPEG's MEL reader refuses a
            # byte above 0x8F after 0xFF where it reads byte by byte
            self.out.append(0)
        return bytes(self.out)


# ---------------------------------------------------------------------------
# the block writer
# ---------------------------------------------------------------------------

def _uvlc(u):
    """U-VLC prefix (value, length) and suffix (value, length) of u >= 1."""
    if u == 1:
        return (1, 1), (0, 0)
    if u == 2:
        return (2, 2), (0, 0)
    if u <= 4:
        return (4, 3), (u - 3, 1)
    return (0, 3), (u - 5, 5)


def _emax(mu):
    """The exponent E of a magnitude (0 where insignificant)."""
    return 0 if mu == 0 else int(mu - 1).bit_length() + 1


def cleanup(mu, neg, cw=None):
    """The cleanup pass of magnitudes `mu` (int [h, w]) and signs `neg` ->
    its bytes (MagSgn, MEL, VLC, the Scup suffix)."""
    cw = cw or codewords()
    h, w = mu.shape
    E = np.vectorize(_emax)(mu) if mu.size else mu
    ms, mel, vlc = Forward(True), Mel(), Backward(True)
    nq = (w + 1) // 2
    for ry in range(0, h, 2):
        first = ry == 0
        ls_sig = [False] * (nq + 2)
        ls_e = [0] * (nq + 2)
        if not first:
            for q in range(nq + 1):
                for x in (2 * q - 1, 2 * q):
                    if 0 <= x < w and mu[ry - 1, x]:
                        ls_sig[q] = True
                        ls_e[q] = max(ls_e[q], int(E[ry - 1, x]))
        prev_rho = 0
        for x0 in range(0, w, 4):
            quads = []
            for q in (x0 // 2, x0 // 2 + 1):
                if 2 * q >= w:
                    break
                pos = [(ry, 2 * q), (ry + 1, 2 * q), (ry, 2 * q + 1),
                       (ry + 1, 2 * q + 1)]
                rho = sum(1 << n for n, (y, x) in enumerate(pos)
                          if y < h and x < w and mu[y, x])
                if first:
                    cq = ((prev_rho & 1) | ((prev_rho >> 1) & 1) |
                          ((prev_rho >> 2) & 1) << 1 |
                          ((prev_rho >> 3) & 1) << 2) if q else 0
                    kappa = 1
                else:
                    cq = (int(ls_sig[q]) | (int(bool(prev_rho & 0xC)) << 1) |
                          int(ls_sig[q + 1]) << 2)
                    emax = max(ls_e[q], ls_e[q + 1])
                    kappa = max(emax - 1, 1) if bin(rho).count("1") > 1 \
                        else 1
                es = [int(E[y, x]) if rho >> n & 1 else 0
                      for n, (y, x) in enumerate(pos)]
                uq = max(max(es), kappa)
                quads.append(dict(pos=pos, rho=rho, cq=cq, U=uq,
                                  u=uq - kappa, es=es))
                prev_rho = rho
            for qd in quads:
                uoff = int(qd["u"] > 0)
                if qd["cq"] == 0:
                    mel.event(int(qd["rho"] != 0))
                    if qd["rho"] == 0:
                        qd["ek"] = 0
                        continue
                for ek, e1, code, n in cw[(0 if first else 1, qd["cq"],
                                           qd["rho"], uoff)]:
                    if all((e1 >> k & 1) == (qd["es"][k] == qd["U"])
                           for k in range(4) if ek >> k & 1):
                        break
                else:
                    raise AssertionError("no CxtVLC codeword fits")
                qd["ek"] = ek
                vlc.bits(code, n)
            us = [qd["u"] for qd in quads]
            if len(us) == 2 and us[0] > 0 and us[1] > 0:
                if first:
                    big = us[0] > 2 and us[1] > 2
                    mel.event(int(big))
                    if big:
                        (p0, s0), (p1, s1) = _uvlc(us[0] - 2), _uvlc(us[1] - 2)
                        vlc.bits(*p0)
                        vlc.bits(*p1)
                        vlc.bits(*s0)
                        vlc.bits(*s1)
                    elif us[0] > 2:
                        p0, s0 = _uvlc(us[0])
                        vlc.bits(*p0)
                        vlc.bits(us[1] - 1, 1)
                        vlc.bits(*s0)
                    else:
                        (p0, s0), (p1, s1) = _uvlc(us[0]), _uvlc(us[1])
                        vlc.bits(*p0)
                        vlc.bits(*p1)
                        vlc.bits(*s0)
                        vlc.bits(*s1)
                else:
                    (p0, s0), (p1, s1) = _uvlc(us[0]), _uvlc(us[1])
                    vlc.bits(*p0)
                    vlc.bits(*p1)
                    vlc.bits(*s0)
                    vlc.bits(*s1)
            else:
                for u in us:
                    if u > 0:
                        p0, s0 = _uvlc(u)
                        vlc.bits(*p0)
                        vlc.bits(*s0)
            for qd in quads:
                for n, (y, x) in enumerate(qd["pos"]):
                    if qd["rho"] >> n & 1:
                        m = qd["U"] - (qd["ek"] >> n & 1)
                        v = 2 * (int(mu[y, x]) - 1) + int(neg[y, x])
                        ms.bits(v, m)
    magsgn = ms.finish()
    melb = mel.finish()
    half, vb = vlc.finish()
    scup = len(melb) + len(vb) + 2
    if scup > 4079:
        raise ValueError("Scup past 4079")
    return (magsgn + melb + vb[::-1] +
            bytes([(half << 4) | (scup & 0xF), scup >> 4]))


def refinement(mu, neg, low, causal, passes):
    """SigProp (and MagRef where `passes` is 2) over the cleanup's
    magnitudes `mu`, refining one bit-plane with the bits `low` (0 / 1)
    -> the refinement segment's bytes. The scan is OpenJPEG's: stripes of
    four rows, columns in halves of a group of eight, a sample in
    SigProp's membership where a neighbour is significant when it is
    scanned (the stripe below by its cleanup only, not at all in the
    stripe-causal mode), the signs of a half after it."""
    h, w = mu.shape
    sig = mu > 0
    final = sig.copy()
    spw, mrw = Forward(False), Backward(False)
    for y0 in range(0, h, 4):
        rows = range(y0, min(y0 + 4, h))
        for g in range(0, w, 8):
            for x in range(g, min(g + 8, w)):
                for y in rows:
                    if sig[y, x]:
                        mrw.bits(int(low[y, x]), 1)
        for g in range(0, w, 8):
            for half in (0, 4):
                cols = [x for x in range(g + half, g + half + 4) if x < w]
                new = []
                for x in cols:
                    for y in rows:
                        if sig[y, x]:
                            continue
                        member = False
                        for yy in (y - 1, y, y + 1):
                            for xx in (x - 1, x, x + 1):
                                if (yy, xx) == (y, x) or not (
                                        0 <= yy < h and 0 <= xx < w):
                                    continue
                                if yy >= y0 + 4:
                                    member |= (not causal) and sig[yy, xx]
                                else:
                                    member |= final[yy, xx]
                        if member:
                            b = int(low[y, x])
                            spw.bits(b, 1)
                            if b:
                                final[y, x] = True
                                new.append((y, x))
                for y, x in sorted(new, key=lambda t: (t[1], t[0])):
                    spw.bits(int(neg[y, x]), 1)
    sp = spw.finish()
    if passes < 2:
        return sp or b"\0"
    _, mr = mrw.finish()
    return (sp + mr[::-1]) or b"\0"


def ht_block(coef, p, passes=1, causal=False, cw=None):
    """One HT code-block of coefficients `coef` (int [h, w]): the cleanup
    at bit-plane p (OpenJPEG's numbps: the magnitudes |c| >> (p - 1)),
    then SigProp and MagRef (`passes` 2 or 3) on the plane below ->
    [(bytes, passes)] segments."""
    c = np.asarray(coef, np.int64)
    mag, neg = np.abs(c), c < 0
    mu = mag >> (p - 1)
    segs = [(cleanup(mu, neg, cw), 1)]
    if passes > 1:
        low = (mag >> (p - 2)) & 1
        segs.append((refinement(mu, neg, low, causal, passes - 1),
                     passes - 1))
    return segs


# ---------------------------------------------------------------------------
# codestreams
# ---------------------------------------------------------------------------

G = _j2k_module()
CV = None


def _cv_module():
    global CV
    if CV is None:
        spec = importlib.util.spec_from_file_location(
            "vt_gen_torch_j2k_ht_cv", os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "gen_torch_j2k_cv.py"))
        CV = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(CV)
    return CV


def cap(pcap=1 << 17, ccap=(0,)):
    """A CAP marker segment: Pcap, then one Ccap word for each bit set
    (Part 15's is bit 15 from the most significant, 1 << 17)."""
    return G.marker(0xFF50, struct.pack(">I", pcap) +
                    b"".join(struct.pack(">H", c) for c in ccap))


def cpf(words=(0,)):
    """A CPF marker segment of `words`."""
    return G.marker(0xFF59, b"".join(struct.pack(">H", w) for w in words))


class HtWriter(G.J2kWriter):
    """`J2kWriter` with HT code-blocks: `plane(coef)` picks each
    block's cleanup bit-plane p (OpenJPEG's numbps; 1 by default, where
    the cleanup holds every bit), `passes` (1-3) how many of its passes it
    codes; SIZ's Rsiz gets `rsiz`, and `after_siz` (a CAP by default)
    follows SIZ. For the malformed files: `edit(n, coef, segs)` replaces
    the n-th coded block's segments, `kfix(p)` the bit-planes its packet
    header announces."""

    def __init__(self, w, h, comps, header, seed, plane=None, passes=1,
                 rsiz=0x4000, after_siz=None, edit=None, kfix=None, **kw):
        super().__init__(w, h, comps, header, seed, **kw)
        x0, y0 = kw.get("x0", 0), kw.get("y0", 0)
        head = G.siz(w, h, comps, x0, y0, kw.get("tile"),
                     kw.get("tile_off", (0, 0)), rsiz)
        self.main = b"\xffO" + head + (cap() if after_siz is None
                                       else after_siz) + header
        self.plane = plane or (lambda coef: 1)
        self.passes = passes
        self.cw = codewords()
        self.edit, self.kfix = edit, kfix
        self.nblock = 0

    def code_block(self, coef, band, sty):
        if not sty & HT:                 # a COC's Part 1 component
            return super().code_block(coef, band, sty)
        coef = np.asarray(coef, np.int64)
        if not np.any(coef):
            return 0, []
        p = self.plane(coef)
        passes = self.passes if p >= 2 else 1
        segs = ht_block(coef, p, passes, bool(sty & 0x08), self.cw)
        if self.edit is not None:
            segs = self.edit(self.nblock, coef, segs)
        self.nblock += 1
        return (p if self.kfix is None else self.kfix(p)), segs


def lossless(img, prec=8, numres=3, cblk=(5, 5), mct=0, sty=HT, **kw):
    """A reversible HT codestream of `img` (uint [H, W, C]) at the origin,
    one tile, the cleanup holding every bit."""
    h, w, nc = img.shape
    hdr = G.cod(numres, cblk=cblk, mct=mct, sty=sty) + \
        G.qcd(0, 2, G.rev_steps(numres, prec))
    return HtWriter(w, h, [(prec, 0, 1, 1)] * nc, hdr, 0,
                    coefs=_cv_module().lossless_coefs(img, prec, numres, mct),
                    **kw).build()


def _fdwt97(w):
    """The forward 9/7 lifting along axis 0 in float64 (the signal's first
    sample at an even coordinate) -> [lows | highs]: the inverse of the
    port's `j2k._idwt97` up to its float32 rounding."""
    J = G.J
    w = np.array(w, np.float64)
    if len(w) == 1:
        return w
    for par, c in ((1, J._ALPHA), (0, J._BETA), (1, J._GAMMA),
                   (0, J._DELTA)):
        t, side = J._neighbours(w, par)
        t += side * np.float64(c)
    w[0::2] /= np.float64(J._K)
    w[1::2] /= np.float64(J._TWO_INVK)
    return np.concatenate([w[0::2], w[1::2]])


def irreversible_coefs(img, numres, mct):
    """An image (uint8 [H, W, C]) -> the `coefs` source of `J2kWriter` for a
    one-tile 9/7 codestream at the origin: the DC level shift, ICT where
    `mct`, `numres` - 1 levels of the forward 9/7, each band's values
    divided by its step size (the band's `step` as the port computes it)
    and truncated, as the decoder puts each index at its bin's centre."""
    a = img.astype(np.float64) - 128
    if mct:
        r, g, b = a[..., 0], a[..., 1], a[..., 2]
        a = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                      -0.16875 * r - 0.331260 * g + 0.5 * b,
                      0.5 * r - 0.41869 * g - 0.08131 * b], -1)
    h, w = a.shape[:2]
    planes = []
    for c in range(a.shape[2]):
        m = a[..., c].copy()
        for lev in range(numres - 1):
            rh, rw = -(-h // (1 << lev)), -(-w // (1 << lev))
            m[:rh, :rw] = _fdwt97(m[:rh, :rw])
            m[:rh, :rw] = _fdwt97(m[:rh, :rw].T).T
        planes.append(m)

    def coefs(comp, resno, band, cb):
        x, y = cb.x0 - band.x0, cb.y0 - band.y0
        lev = numres - resno
        if band.bandno & 1:
            x += -(-w // (1 << lev))
        if band.bandno & 2:
            y += -(-h // (1 << lev))
        v = planes[comp][y:y + cb.y1 - cb.y0, x:x + cb.x1 - cb.x0]
        q = np.floor(np.abs(v) / np.float64(band.step)).astype(np.int64)
        return np.where(v < 0, -q, q)
    return coefs


def irr_steps(numres, expn=13, mant=0):
    """Scalar expounded (expn, mant) for each band: the step size of a band
    is (1 + mant / 2048) * 2^(8 - expn) of an 8-bit sample."""
    return [(expn, mant)] * (3 * numres - 2)


def irreversible(img, numres=3, cblk=(5, 5), mct=0, sty=HT, layers=1,
                 passes=3, expn=13, **kw):
    """A 9/7 HT codestream of `img` (uint8 [H, W, C]): each block's cleanup
    at bit-plane 2 where it has magnitudes of 2 or more (1 where not),
    then `passes` passes; `layers` quality layers (a layer a pass)."""
    h, w, nc = img.shape
    hdr = G.cod(numres, cblk=cblk, mct=mct, sty=sty, qmf=0,
                 layers=layers) + G.qcd(2, 2, irr_steps(numres, expn))
    return HtWriter(w, h, [(8, 0, 1, 1)] * nc, hdr, 0, passes=passes,
                    plane=lambda coef: 2 if np.abs(coef).max() >= 2 else 1,
                    layers_split=layers > 1,
                    coefs=irreversible_coefs(img, numres, mct), **kw).build()


# ---------------------------------------------------------------------------
# the files
# ---------------------------------------------------------------------------

def random_ht(w, h, nc=1, numres=3, cblk=(5, 5), sty=HT, passes=3, plane=2,
              bits=6, prec=8, sgnd=0, layers=1, mct=0, seed=0, extra=b"",
              prg=0, precincts=None, guard=2, **kw):
    """A reversible HT codestream of seeded random coefficients of at most
    `bits` bits (`J2kWriter._coefs`), each block's cleanup at bit-plane
    `plane` (1 where its magnitudes are all 1), then `passes` passes."""
    csty = (2 if kw.get("sop") else 0) | (4 if kw.get("eph") else 0)
    hdr = G.cod(numres, cblk=cblk, sty=sty, layers=layers, mct=mct,
                 prg=prg, precincts=precincts, csty=csty) + \
        G.qcd(0, guard, G.rev_steps(numres, prec)) + extra
    return HtWriter(w, h, [(prec, sgnd, 1, 1)] * nc, hdr, SEED + seed,
                    bits=bits, passes=passes, layers_split=layers > 1,
                    plane=lambda coef: plane if np.abs(coef).max() >=
                    1 << (plane - 1) else 1, **kw).build()


def _cleanup_edit(fn, only=0):
    """`edit` for HtWriter: `fn(bytearray cleanup, lcup, scup)` on block
    `only`'s cleanup segment."""
    def edit(n, coef, segs):
        if n != only:
            return segs
        cup = bytearray(segs[0][0])
        lcup = len(cup)
        fn(cup, lcup, (cup[-1] << 4) + (cup[-2] & 0xF))
        return [(bytes(cup), 1)] + segs[1:]
    return edit


def _segs_edit(fn, only=0):
    def edit(n, coef, segs):
        return fn(coef, segs) if n == only else segs
    return edit


def _mel_bad(cup, lcup, scup):
    cup[lcup - scup] = 0xFF
    cup[lcup - scup + 1] = 0x90


def _mel_unchecked():
    """0xFF 0x90 at the start of the MEL bytes where OpenJPEG's MEL reader
    reads them a word at a time (the block's MEL bytes start at an
    address of 3 modulo 4): it does not check them, and the block
    decodes. The first seed and width whose block decodes."""
    for seed in range(31, 40):
        for w in range(20, 40):
            cs = random_ht(w, 9, numres=1, plane=1, passes=1, bits=8,
                           seed=seed, edit=_cleanup_edit(_mel_bad))
            try:
                G.J.read(cs)
            except ValueError:
                continue
            return cs
    raise RuntimeError("no width leaves the MEL bytes unchecked")


def _scup_bad(cup, lcup, scup):
    cup[-1] = 0xFF


def _outside(coef, segs):
    """A block one row high re-coded as two rows: its second row's samples
    are significant outside the block."""
    c = np.vstack([coef, np.ones_like(coef)])
    return ht_block(c, 1, 1)


def ht_files():
    """{name: bytes}: the `htj2k_*` and `htj2k_bad_*` files (the module
    docstring)."""
    g = np.random.default_rng(SEED)
    grey = G._smooth(g, 40, 37, 1)
    rgb = G._smooth(g, 33, 45, 3)
    f = {}
    f["htj2k_grey.j2k"] = lossless(grey)
    f["htj2k_rgb.jp2"] = G.jp2(lossless(rgb, cblk=(6, 6)), 45, 33, 3,
                               colr=(1, 16))
    f["htj2k_rgb_mct.j2k"] = lossless(rgb, numres=4, mct=1)
    f["htj2k_prec12.j2k"] = lossless(
        (grey.astype(np.uint16) * 16 + g.integers(0, 16, grey.shape)),
        prec=12)
    f["htj2k_prec16.jp2"] = G.jp2(lossless(
        (grey.astype(np.uint16) * 257) ^ g.integers(0, 64, grey.shape)
        .astype(np.uint16), prec=16), 37, 40, 1, bpc=15)
    f["htj2k_signed.j2k"] = random_ht(30, 21, sgnd=1, seed=1)
    f["htj2k_signed12.j2k"] = random_ht(30, 21, prec=12, sgnd=1, bits=10,
                                        plane=3, seed=2)
    f["htj2k_irr.j2k"] = irreversible(grey)
    f["htj2k_irr_ict.jp2"] = G.jp2(irreversible(rgb, mct=1, cblk=(4, 4),
                                                expn=11), 45, 33, 3,
                                   colr=(1, 16))
    f["htj2k_irr_cleanup.j2k"] = irreversible(rgb, mct=1, passes=1,
                                              expn=10)
    f["htj2k_cblk32.j2k"] = random_ht(70, 45, seed=3)
    f["htj2k_cblk64.j2k"] = random_ht(100, 70, cblk=(6, 6), bits=7, seed=4)
    f["htj2k_cblk16x256.j2k"] = random_ht(40, 300, numres=2, cblk=(4, 8),
                                          seed=5)
    f["htj2k_cblk4.j2k"] = random_ht(13, 11, cblk=(2, 2), seed=6)
    f["htj2k_cblk8x4_edges.j2k"] = random_ht(29, 23, cblk=(3, 2), seed=7)
    f["htj2k_precincts.j2k"] = random_ht(
        60, 50, nc=3, prg=2, precincts=[0x33, 0x44, 0x55], cblk=(4, 4),
        seed=8)
    f["htj2k_tiles.j2k"] = random_ht(50, 45, nc=3, mct=1, tile=(24, 20),
                                     tile_off=(3, 2), x0=5, y0=4, seed=9)
    f["htj2k_tiles_origin.j2k"] = random_ht(50, 45, nc=3, tile=(16, 16),
                                            seed=32)
    f["htj2k_layers3.j2k"] = random_ht(40, 30, sty=HT | 0x04, layers=3,
                                       seed=10)
    f["htj2k_layers2.j2k"] = random_ht(40, 30, sty=HT | 0x04, layers=2,
                                       seed=11)
    f["htj2k_vsc.j2k"] = random_ht(40, 30, sty=HT | 0x08, seed=12)
    f["htj2k_sty_all.j2k"] = random_ht(40, 30, sty=0x7F, seed=13)
    for sty in (0x01, 0x02, 0x10, 0x20):
        f[f"htj2k_sty{sty:02x}.j2k"] = random_ht(24, 20, sty=HT | sty,
                                                 seed=14 + sty)
    f["htj2k_sp_only.j2k"] = random_ht(40, 30, passes=2, seed=15)
    f["htj2k_plane3.j2k"] = random_ht(40, 30, plane=3, bits=7, seed=16)
    f["htj2k_empty_blocks.j2k"] = random_ht(
        60, 40, cblk=(3, 3), seed=17,
        coefs=lambda comp, resno, band, cb: np.zeros(
            (cb.y1 - cb.y0, cb.x1 - cb.x0), np.int64) if (cb.x0 // 8 +
            cb.y0 // 8) % 3 == 0 else np.random.default_rng(
            cb.x0 * 131 + cb.y0).integers(-20, 21, (cb.y1 - cb.y0,
                                                     cb.x1 - cb.x0)))
    f["htj2k_sop_eph_ppt.j2k"] = random_ht(40, 30, nc=3, sop=True, eph=True,
                                           ppt=True, parts=2, seed=18)
    f["htj2k_ppm.j2k"] = random_ht(40, 30, ppm=True, seed=19)
    f["htj2k_coc_part1.j2k"] = random_ht(
        40, 30, nc=3, extra=G.coc(1, 3, sty=0), seed=20)
    f["htj2k_coc_ht.j2k"] = random_ht(
        40, 30, nc=3, sty=0, extra=G.coc(2, 3, sty=HT), seed=21)
    f["htj2k_cpf.j2k"] = random_ht(24, 20, after_siz=cap() + cpf((3, 0x8000)),
                                   seed=22)
    f["htj2k_nocap.j2k"] = random_ht(24, 20, after_siz=b"", rsiz=0, seed=23)
    f["htj2k_cap_twice.j2k"] = random_ht(24, 20, after_siz=cap() + cap(),
                                         seed=24)
    f["htj2k_cap_wide.j2k"] = random_ht(
        24, 20, after_siz=cap(0xFFFFFFFF, (0x0021,)), seed=25)
    f["htj2k_cap_empty.j2k"] = random_ht(
        24, 20, after_siz=G.marker(0xFF50, b""), seed=26)
    f["htj2k_cap_pcap0.j2k"] = random_ht(24, 20, after_siz=cap(0, ()),
                                         seed=27)
    f["htj2k_rsiz_profile.j2k"] = random_ht(24, 20, rsiz=0x4000 | 0x0003,
                                            seed=28)
    f["htj2k_only_cleanup.j2k"] = random_ht(
        24, 20, plane=1, passes=1, seed=29, edit=_segs_edit(
            lambda coef, segs: segs + [(b"\x5a\xa5\x3c", 2)]))
    f["htj2k_ref_empty.j2k"] = random_ht(
        24, 20, seed=30, edit=_segs_edit(
            lambda coef, segs: segs[:1] + [(b"", 2)]))
    f["htj2k_mel_unchecked.j2k"] = _mel_unchecked()
    # what OpenJPEG refuses
    f["htj2k_bad_roi.j2k"] = random_ht(24, 20, extra=G.rgn(0, 3), seed=40)
    f["htj2k_bad_passes4.j2k"] = random_ht(
        24, 20, seed=41, edit=_segs_edit(
            lambda coef, segs: segs[:1] + [(segs[1][0], 3)]))
    f["htj2k_bad_mb.j2k"] = HtWriter(
        24, 20, [(8, 0, 1, 1)], G.cod(1, sty=HT) + G.qcd(2, 7, [(25, 0)]),
        SEED + 42).build()
    f["htj2k_bad_zero_planes.j2k"] = random_ht(24, 20, seed=43,
                                               kfix=lambda p: 0)
    f["htj2k_bad_lengths.j2k"] = random_ht(
        24, 20, seed=44, edit=_segs_edit(lambda coef, segs: [(b"\x10", 1)]))
    f["htj2k_bad_zero_length.j2k"] = random_ht(
        24, 20, seed=45, edit=_segs_edit(lambda coef, segs: [(b"", 1)]))
    f["htj2k_bad_scup.j2k"] = random_ht(24, 20, seed=46,
                                        edit=_cleanup_edit(_scup_bad))
    f["htj2k_bad_mel.j2k"] = random_ht(24, 9, numres=1, plane=1, passes=1,
                                       bits=8, seed=47,
                                       edit=_cleanup_edit(_mel_bad))
    f["htj2k_bad_uq.j2k"] = random_ht(24, 20, plane=1, passes=1, bits=8,
                                      seed=48, kfix=lambda p: p + 6)
    f["htj2k_bad_outside.j2k"] = random_ht(23, 1, numres=1, plane=1,
                                           passes=1, seed=49,
                                           edit=_segs_edit(_outside))
    f["htj2k_bad_htmixed.j2k"] = _restyle(random_ht(24, 20, seed=50), 0xC0)
    f["htj2k_bad_layers3.j2k"] = random_ht(40, 30, layers=3, seed=51)
    f["htj2k_bad_cap_tile.j2k"] = random_ht(24, 20, tile_headers={0: cap()},
                                            seed=52)
    return f


def _restyle(cs, sty):
    """A codestream with its COD's code-block style replaced."""
    i = cs.index(b"\xff\x52")
    return cs[:i + 12] + bytes([sty]) + cs[i + 13:]


def checker_twin(checker_rgb):
    """`checker_htj2k.jp2`: the checker, reversible with RCT, the cleanup
    holding every bit (it decodes to the checker)."""
    h, w, _ = checker_rgb.shape
    return G.jp2(lossless(checker_rgb, numres=4, mct=1), w, h, 3,
                 colr=(1, 16))


def projector_twin(projector_rgb):
    """`projector_htj2kcv.exr`: the projector's RGB, 9/7 with ICT, the
    cleanup in a first layer and SigProp and MagRef in a second (TERMALL:
    OpenJPEG reads a first layer of the cleanup alone only so)."""
    return irreversible(projector_rgb, numres=4, mct=1, sty=HT | 0x04,
                        layers=2, cblk=(6, 6), expn=11)


# ---------------------------------------------------------------------------
# seeded edits
# ---------------------------------------------------------------------------

EDIT_SOURCES = ("htj2k_grey.j2k", "htj2k_rgb.jp2", "htj2k_rgb_mct.j2k",
                "htj2k_irr_ict.jp2", "htj2k_cblk4.j2k", "htj2k_cblk32.j2k",
                "htj2k_layers2.j2k", "htj2k_vsc.j2k", "htj2k_sp_only.j2k",
                "htj2k_plane3.j2k", "htj2k_precincts.j2k",
                "htj2k_prec16.jp2")
EDITS_EACH = 25


def edit_cases(files):
    """EDITS_EACH seeded edits of each file of EDIT_SOURCES (`files`: name
    -> bytes): a cut, or one to three bytes replaced or with a bit
    flipped, two edits in three among the code-blocks' bytes (after the
    first SOD) -> [(source, bytes)], in order."""
    out = []
    for si, fn in enumerate(EDIT_SOURCES):
        src = files[fn]
        head = src.index(b"\xff\x93") + 2
        g = np.random.default_rng(SEED * 1000 + si)
        for _ in range(EDITS_EACH):
            d = bytearray(src)
            kind = int(g.integers(3))
            lo = head if g.random() < 2 / 3 else 1
            hi = len(d) if lo == head else head
            if kind == 0:
                d = d[:int(g.integers(lo, hi))]
            else:
                for _ in range(int(g.integers(1, 4))):
                    i = int(g.integers(lo, hi))
                    d[i] = int(g.integers(0, 256)) if kind == 1 else \
                        d[i] ^ (1 << int(g.integers(8)))
            out.append((fn, bytes(d)))
    return out


# ---------------------------------------------------------------------------
# checks, the timing file, the libraries' outcomes
# ---------------------------------------------------------------------------

def check_writer():
    """A reversible HT file of an 8-bit image decodes in PIL to that image
    (grey and RGB, cleanup only and with MCT); raises where not."""
    import io
    from PIL import Image
    g = np.random.default_rng(SEED + 1)
    for img, kw in ((G._smooth(g, 37, 41, 1), {}),
                    (G._smooth(g, 70, 66, 3), dict(mct=1, numres=5)),
                    (g.integers(0, 256, (19, 23, 3)).astype(np.uint8),
                     dict(cblk=(2, 3)))):
        cs = lossless(img, **kw)
        with Image.open(io.BytesIO(cs)) as im:
            got = np.asarray(im)
        if not np.array_equal(got.reshape(img.shape), img):
            raise RuntimeError(f"PIL does not decode the HT writer's {kw} "
                               "file to its image")


def ht_timing(n=2048):
    """`htj2k_2048.jp2`: the timing image of `tools/gen_torch_j2k.py` (2048^2
    RGB), 9/7 with ICT, six resolutions, 64 x 64 code-blocks, cleanup,
    SigProp and MagRef."""
    return G.jp2(irreversible(G.timing_image(n), numres=6, cblk=(6, 6),
                              mct=1, expn=6), n, n, 3, colr=(1, 16))


def _p2():
    return G._p2_module()


def once_per_process(files, lib):
    """OpenJPEG warns once a process that it decodes only the cleanup pass
    of a block with as many zero bit-planes as bit-planes: the library
    decodes `htj2k_only_cleanup.j2k` twice in one child process (the
    second time without the warning) to the same image; raises where
    not."""
    data = files["htj2k_only_cleanup.j2k"]
    dec = _p2().library_decodes({"a": data, "b": data}, lib)
    if dec["a"] is None or not np.array_equal(dec["a"], dec["b"]):
        raise RuntimeError(f"{lib} decodes htj2k_only_cleanup.j2k otherwise "
                           "the second time")


def edit_digests(files, lib):
    """The library's outcome of each of `edit_cases(files)`: uint8 [n, 32]
    (`gen_torch_j2k_p2.digest` of its decode, zeros for a refusal)."""
    p2 = _p2()
    edits = edit_cases(files)
    dec = p2.library_decodes({f"{i:04d}": d for i, (_, d) in
                              enumerate(edits)}, lib)
    return np.array([np.frombuffer(p2.digest(dec[f"{i:04d}"]), np.uint8)
                     for i in range(len(edits))])


def main():
    """Check the tables and the writer, then write the HT files and the
    timing file (the .npz files come from `tools/gen_torch_j2k.py` and
    `tools/gen_torch_j2k_cv.py`)."""
    print("tables at", check_tables())
    check_writer()
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_assets_ht", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_assets.py"))
    ga = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ga)
    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    files = ht_files()
    files["checker_htj2k.jp2"] = checker_twin(ga.checker())
    files["projector_htj2kcv.exr"] = projector_twin(ga.projector()[..., :3])
    files["htj2k_2048.jp2"] = ht_timing()
    for fn, data in files.items():
        with open(os.path.join(out, fn), "wb") as fh:
            fh.write(data)


if __name__ == "__main__":
    main()
