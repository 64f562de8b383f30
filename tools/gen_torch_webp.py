"""The WebP files of the port's tests (`tests/assets_torch/`) and the small
WebP writers the tests share: what PIL's encoder cannot write is built
here, and PIL's decode of the result is the reference all the same.

    python tools/gen_torch_webp.py [out_dir]

(`tools/gen_torch_assets.py` calls `write_webp_files` too.) The files:

  * the scenes' twins (`tests/torch_scenes.py` `cbox_tex_webp`,
    `env_sphere_webp`): `checker.webp` and `bumps.webp` (lossless),
    `checker_lossy.webp` (lossy, quality 80) with `checker_lossy_pil.png`,
    PIL's decode of it; `projector.webp` (lossless with alpha, written with
    exact=True and moved into a VP8X file);
  * `tiny.webp`, an 8 x 8 lossless corner of the checker;
  * `anim.webp` (lossless) and `anim_lossy.webp`: two frames, frame 0 a
    sub-rectangle off the canvas's corner; `lossy_alpha.webp`, PIL's lossy
    file with alpha (a VP8L-coded ALPH chunk);
  * hand-built: `alph_raw_h.webp`, `alph_raw_grad.webp` (raw ALPH chunks,
    horizontal and gradient filters), `alph_vp8l_v.webp` (a VP8L-coded ALPH
    chunk with the vertical filter) on a PIL-written VP8 frame;
    `vp8_simple.webp` (the simple loop filter, sharpness 3) and
    `vp8_parts.webp` (four token partitions, a skip probability,
    loop-filter deltas, delta-coded segments), PIL-written frames written
    again by the boolean encoder here; `vp8l_predictors.webp` (every
    predictor mode, 0-15) and `vp8l_transforms.webp` (cross-colour,
    subtract-green and colour-indexing transforms, 4 colours bundled);
  * the timing files `grain_2048.webp` (lossy, quality 80) and
    `smooth_2048.webp` (lossless);

and `webp_decodes.npz`: PIL's `Image.open(p).convert("RGB")` of each,
keyed by file name; of the timing files, the sha256 of the decode and its
128 x 128 corner (keys "<file>:sha256", "<file>:corner").

The output is deterministic for a given libwebp (PIL 12.1 with libwebp
1.6.0 wrote the committed files).
"""
import io
import os
import re
import struct
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "assets_torch")
CODEC = os.path.join(ROOT, "vision_tpu_torch", "csrc", "webp_codec.cpp")


def _codec_table(name):
    """A uint8 table of `csrc/webp_codec.cpp` (the RFC 6386 probabilities),
    read from its source: one copy of the numbers."""
    src = open(CODEC).read()
    m = re.search(r"const uint8_t " + name + r"((?:\[\d+\])+) = \{([^}]*)\};",
                  src)
    shape = [int(v) for v in re.findall(r"\d+", m.group(1))]
    return np.array([int(v) for v in re.findall(r"\d+", m.group(2))],
                    np.int64).reshape(shape)


# ---------------------------------------------------------------------------
# The container
# ---------------------------------------------------------------------------

def chunk(tag, body):
    """A RIFF chunk, padded to an even size."""
    return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def riff(chunks):
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(flags, width, height):
    """A VP8X chunk (flags: 16 alpha, 2 animation, 32 ICC, 8 EXIF, 4 XMP)."""
    return chunk(b"VP8X", struct.pack("<I", flags)
                 + struct.pack("<I", width - 1)[:3]
                 + struct.pack("<I", height - 1)[:3])


def anmf(x, y, width, height, payload, duration=100, flags=2):
    """An ANMF chunk: a frame at (x, y) (even) of the frame's chunks."""
    return chunk(b"ANMF", struct.pack("<I", x // 2)[:3]
                 + struct.pack("<I", y // 2)[:3]
                 + struct.pack("<I", width - 1)[:3]
                 + struct.pack("<I", height - 1)[:3]
                 + struct.pack("<I", duration)[:3] + bytes([flags]) + payload)


def chunks_of(data):
    """A RIFF file's top-level chunks: [(tag, payload)]."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        n = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def pil_webp(img, **opts):
    """PIL's WebP file of an RGB / RGBA uint8 image."""
    from PIL import Image
    b = io.BytesIO()
    Image.fromarray(img).save(b, "WEBP", **opts)
    return b.getvalue()


def pil_payload(img, tag=b"VP8 ", **opts):
    """The payload of the `tag` chunk of PIL's file."""
    return dict(chunks_of(pil_webp(img, **opts)))[tag]


# ---------------------------------------------------------------------------
# VP8L written by hand: fixed 8-bit prefix codes, any content
# ---------------------------------------------------------------------------

class LsbWriter:
    """Bits least significant first, as VP8L reads them."""

    def __init__(self):
        self.value = 0
        self.n = 0

    def put(self, v, bits):
        self.value |= (int(v) & ((1 << bits) - 1)) << self.n
        self.n += bits

    def bytes(self):
        return self.value.to_bytes((self.n + 7) // 8, "little")


_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.int64)
_CL_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8)


def _code_all8(bw, alphabet):
    """A normal prefix code: symbols 0-255 of 8 bits, the rest unused; the
    code-length code has lengths 0 ('0') and 8 ('1')."""
    bw.put(0, 1)
    bw.put(len(_CL_ORDER) - 4, 4)
    for s in _CL_ORDER:
        bw.put(1 if s in (0, 8) else 0, 3)
    bw.put(0, 1)
    for s in range(alphabet):
        bw.put(1 if s < 256 else 0, 1)


def _code_single(bw, symbol):
    """A simple prefix code of one symbol: a code of no bits."""
    bw.put(1, 1)
    bw.put(0, 1)
    bw.put(int(symbol >= 2), 1)
    bw.put(symbol, 8 if symbol >= 2 else 1)


def _entropy_image(bw, argb, level0, green_only=False):
    """An image's colour-cache bit, (at level 0) meta-code bit, its five
    prefix codes and its pixels as literals; green_only: red, blue and
    alpha single-symbol 0 (libwebp's 8-bit ALPH path)."""
    bw.put(0, 1)
    if level0:
        bw.put(0, 1)
    _code_all8(bw, 280)
    for _ in range(3):
        if green_only:
            _code_single(bw, 0)
        else:
            _code_all8(bw, 256)
    _code_single(bw, 0)
    px = np.asarray(argb, np.int64).reshape(-1)
    comps = [(px >> 8) & 0xFF] if green_only else [
        (px >> 8) & 0xFF, (px >> 16) & 0xFF, px & 0xFF, (px >> 24) & 0xFF]
    codes = np.stack([_REV8[c] for c in comps], -1).reshape(-1)
    for v in codes.tolist():
        bw.put(v, 8)


def sub_sample(size, bits):
    return (size + (1 << bits) - 1) >> bits


def vp8l_bitstream(width, height, coded, transforms=(), header=True,
                   alpha_hint=0, green_only=False):
    """A VP8L bitstream: transforms [("predictor" | "cross", bits, argb
    [ys, xs]), ("green",), ("palette", argb deltas [n])] in the order
    written (undone in reverse), then the coded image `coded` (uint32 of
    the width the transforms leave); header=False leaves out the 5-byte
    header (an ALPH chunk's data)."""
    bw = LsbWriter()
    if header:
        bw.put(0x2F, 8)
        bw.put(width - 1, 14)
        bw.put(height - 1, 14)
        bw.put(alpha_hint, 1)
        bw.put(0, 3)
    for t in transforms:
        bw.put(1, 1)
        if t[0] in ("predictor", "cross"):
            bw.put(0 if t[0] == "predictor" else 1, 2)
            bw.put(t[1] - 2, 3)
            _entropy_image(bw, t[2], False)
        elif t[0] == "green":
            bw.put(2, 2)
        else:
            bw.put(3, 2)
            bw.put(len(t[1]) - 1, 8)
            _entropy_image(bw, t[1], False)
    bw.put(0, 1)
    _entropy_image(bw, coded, True, green_only)
    return bw.bytes()


def palette_bits(n):
    return 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3


def bundle(index, n_colours):
    """Colour indices [h, w] packed as the colour-indexing transform codes
    them: argb [h, ceil(w / per)] with the indices in green."""
    bits = palette_bits(n_colours)
    h, w = index.shape
    per, bpp = 1 << bits, 8 >> bits
    out = np.zeros((h, sub_sample(w, bits)), np.int64)
    for x in range(w):
        out[:, x >> bits] |= index[:, x].astype(np.int64) << (bpp * (x & (per - 1)))
    return (out << 8) | 0xFF000000


def vp8l_predictors(seed=3, width=37, height=29, bits=2):
    """Every predictor mode (0-15, 14 and 15 padding) on random residuals."""
    g = np.random.RandomState(seed)
    ts = (sub_sample(height, bits), sub_sample(width, bits))
    modes = (np.arange(ts[0] * ts[1]) % 16).reshape(ts)
    g.shuffle(modes.reshape(-1))
    residual = g.randint(0, 1 << 32, (height, width), dtype=np.uint64)
    return vp8l_bitstream(width, height, residual.astype(np.int64),
                          [("predictor", bits, (modes << 8) | 0xFF000000)])


def vp8l_transforms(seed=4, width=35, height=19):
    """Colour indexing (4 colours, 4 indices a byte), subtract-green and
    cross-colour transforms over a random coded image."""
    g = np.random.RandomState(seed)
    pal = g.randint(0, 1 << 32, 4, dtype=np.uint64).astype(np.int64)
    index = g.randint(0, 4, (height, width))
    packed = bundle(index, 4)
    cw = packed.shape[1]
    codes = g.randint(0, 1 << 24, (sub_sample(height, 3), sub_sample(cw, 3)))
    return vp8l_bitstream(width, height, packed, [
        ("palette", pal), ("green",), ("cross", 3, codes)])


# ---------------------------------------------------------------------------
# ALPH chunks written by hand
# ---------------------------------------------------------------------------

def alph_raw(deltas, filt):
    """A raw ALPH chunk's payload: filter 0-3 (none, horizontal, vertical,
    gradient) over the given deltas [h, w]."""
    return bytes([filt << 2]) + np.asarray(deltas, np.uint8).tobytes()


def alph_vp8l(values, filt, palette=None):
    """A VP8L-coded ALPH chunk's payload of the values [h, w] in green;
    with `palette` (uint8 levels), through the colour-indexing transform
    alone and single-symbol red, blue and alpha (libwebp's 8-bit path)."""
    h, w = values.shape
    if palette is None:
        coded = (np.asarray(values, np.int64) << 8) | 0xFF000000
        data = vp8l_bitstream(w, h, coded, [("green",)], header=False)
    else:
        pal = np.asarray(palette, np.int64)
        deltas = np.diff(np.concatenate([[0], pal])) & 0xFF
        data = vp8l_bitstream(w, h, bundle(values, len(pal)),
                              [("palette", deltas << 8)], header=False,
                              green_only=True)
    return bytes([1 | filt << 2]) + data


# ---------------------------------------------------------------------------
# VP8 frames written again (RFC 6386 boolean coder)
# ---------------------------------------------------------------------------

class BoolDecoder:
    def __init__(self, data):
        self.data = data
        self.pos = 2
        self.value = (data[0] << 8 | data[1]) if len(data) > 1 else 0
        self.range = 255
        self.count = 0

    def bit(self, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            b = 1
            self.range -= split
            self.value -= big
        else:
            b = 0
            self.range = split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                if self.pos < len(self.data):
                    self.value |= self.data[self.pos]
                self.pos += 1
        return b

    def lit(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n):
        v = self.lit(n)
        return -v if self.bit(128) else v


class BoolEncoder:
    def __init__(self):
        self.out = bytearray()
        self.range = 255
        self.bottom = 0
        self.count = 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def bit(self, prob, b):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if b:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if self.count == 0:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def lit(self, n, v):
        for i in range(n - 1, -1, -1):
            self.bit(128, (v >> i) & 1)

    def signed(self, n, v):
        self.lit(n, abs(v))
        self.bit(128, int(v < 0))

    def flush(self):
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


class _Recorder:
    """A boolean decoder that keeps each (probability, bit) it reads."""

    def __init__(self, dec):
        self.dec = dec
        self.log = []

    def bit(self, prob):
        b = self.dec.bit(prob)
        self.log.append((prob, b))
        return b


_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))


def _coeffs(r, proba, t, ctx, n):
    """One block's tokens (GetCoeffs) from coefficient n: the index past
    the last non-zero one."""
    p = proba[t][_BANDS[n]][ctx]
    while n < 16:
        if not r.bit(p[0]):
            return n
        while not r.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = proba[t][_BANDS[n]][0]
        nxt = proba[t][_BANDS[n + 1]]
        if not r.bit(p[2]):
            p = nxt[1]
        else:
            if not r.bit(p[3]):
                if r.bit(p[4]):
                    r.bit(p[5])
            elif not r.bit(p[6]):
                if not r.bit(p[7]):
                    r.bit(159)
                else:
                    r.bit(165)
                    r.bit(145)
            else:
                b1 = r.bit(p[8])
                b0 = r.bit(p[9 + b1])
                for q in _CAT[2 * b1 + b0]:
                    r.bit(q)
            p = nxt[2]
        r.bit(128)   # the sign
        n += 1
    return 16


def parse_vp8(data):
    """A VP8 key frame -> its header's fields, each macroblock's mode
    decisions and token decisions ((probability, bit) lists) and whether
    all its coefficients are zero."""
    update = _codec_table("kCoeffsUpdateProba")
    proba0 = _codec_table("kCoeffsProba0")
    bmodes = _codec_table("kBModesProba")
    tag = data[0] | data[1] << 8 | data[2] << 16
    first_len = tag >> 5
    w = (data[6] | data[7] << 8) & 0x3FFF
    h = (data[8] | data[9] << 8) & 0x3FFF
    br = BoolDecoder(data[10:10 + first_len])
    f = dict(tag=tag, dims=data[3:10], mb_w=(w + 15) >> 4, mb_h=(h + 15) >> 4)
    f["colorspace"], f["clamp"] = br.lit(1), br.lit(1)
    f["use_segment"] = br.lit(1)
    f.update(update_map=0, update_data=0, absolute_delta=1, quantizer=[0] * 4,
             filter_strength=[0] * 4, seg_proba=[255] * 3)
    if f["use_segment"]:
        f["update_map"] = br.lit(1)
        f["update_data"] = br.lit(1)
        if f["update_data"]:
            f["absolute_delta"] = br.lit(1)
            f["quantizer"] = [br.signed(7) if br.lit(1) else 0 for _ in range(4)]
            f["filter_strength"] = [br.signed(6) if br.lit(1) else 0
                                    for _ in range(4)]
        if f["update_map"]:
            f["seg_proba"] = [br.lit(8) if br.lit(1) else 255 for _ in range(3)]
    f["simple"], f["level"], f["sharpness"] = br.lit(1), br.lit(6), br.lit(3)
    f["use_lf_delta"] = br.lit(1)
    f["ref_lf_delta"], f["mode_lf_delta"] = [None] * 4, [None] * 4
    if f["use_lf_delta"] and br.lit(1):
        for k in ("ref_lf_delta", "mode_lf_delta"):
            f[k] = [br.signed(6) if br.lit(1) else None for _ in range(4)]
    f["log2_parts"] = br.lit(2)
    f["base_q"] = br.lit(7)
    f["dq"] = [br.signed(4) if br.lit(1) else 0 for _ in range(5)]
    f["refresh"] = br.lit(1)
    proba = np.zeros((4, 8, 3, 11), np.int64)
    f["proba_updates"] = []
    for i in np.ndindex(4, 8, 3, 11):
        if br.bit(update[i]):
            proba[i] = br.lit(8)
            f["proba_updates"].append((i, int(proba[i])))
        else:
            proba[i] = proba0[i]
    f["use_skip"] = br.lit(1)
    f["skip_p"] = br.lit(8) if f["use_skip"] else 0
    # the token partitions
    n_parts = 1 << f["log2_parts"]
    pos = 10 + first_len
    sizes = [struct.unpack("<I", data[pos + 3 * i:pos + 3 * i + 3] + b"\0")[0]
             for i in range(n_parts - 1)]
    pos += 3 * (n_parts - 1)
    parts = []
    for s in sizes + [len(data) - pos - sum(sizes)]:
        parts.append(BoolDecoder(data[pos:pos + s]))
        pos += s
    mbs = []
    intra_t = [0] * (4 * f["mb_w"])
    nz_t = [(0, 0)] * f["mb_w"]
    for mb_y in range(f["mb_h"]):
        intra_l = [0] * 4
        row = []
        for mb_x in range(f["mb_w"]):
            mb = dict(seg=[], skip=0)
            if f["update_map"]:
                r = _Recorder(br)
                sp = f["seg_proba"]
                _ = r.bit(sp[2]) if r.bit(sp[0]) else r.bit(sp[1])
                mb["seg"] = r.log
            if f["use_skip"]:
                mb["skip"] = br.bit(f["skip_p"])
            r = _Recorder(br)
            mb["i4x4"] = not r.bit(145)
            if not mb["i4x4"]:
                ymode = (1 if r.bit(128) else 3) if r.bit(156) else \
                    (2 if r.bit(163) else 0)
                intra_t[4 * mb_x:4 * mb_x + 4] = [ymode] * 4
                intra_l[:] = [ymode] * 4
            else:
                for y in range(4):
                    ym = intra_l[y]
                    for x in range(4):
                        p = bmodes[intra_t[4 * mb_x + x]][ym]
                        ym = _bmode(r, p)
                        intra_t[4 * mb_x + x] = ym
                    intra_l[y] = ym
            if not r.bit(142):
                pass
            elif r.bit(114):
                r.bit(183)
            mb["modes"] = r.log
            row.append(mb)
        # the row's tokens
        tr = _Recorder(parts[mb_y & (n_parts - 1)])
        left = (0, 0)
        for mb_x, mb in enumerate(row):
            start = len(tr.log)
            if mb["skip"]:
                nz_t[mb_x] = (0, nz_t[mb_x][1] if mb["i4x4"] else 0)
                left = (0, left[1] if mb["i4x4"] else 0)
                mb["tokens"], mb["zero"] = [], True
                continue
            (t_nz, t_dc), (l_nz, l_dc) = nz_t[mb_x], left
            any_nz = False
            first = 0
            if not mb["i4x4"]:
                nz = _coeffs(tr, proba, 1, t_dc + l_dc, 0)
                t_dc = l_dc = int(nz > 0)
                any_nz |= nz > 0
                first = 1
            t_bits, l_bits = t_nz & 0xF, l_nz & 0xF
            ac_type = 0 if not mb["i4x4"] else 3
            new_t = [0] * 4
            for y in range(4):
                lb = (l_bits >> y) & 1
                for x in range(4):
                    nz = _coeffs(tr, proba, ac_type, lb + ((t_bits >> x) & 1), first)
                    lb = int(nz > first)
                    new_t[x] = lb
                    t_bits = (t_bits & ~(1 << x)) | (lb << x)
                    any_nz |= nz > first
                l_bits = (l_bits & ~(1 << y)) | (lb << y)
            out_t, out_l = t_bits, l_bits
            for ch in (0, 2):
                tb, lb_all = (t_nz >> (4 + ch)) & 3, (l_nz >> (4 + ch)) & 3
                for y in range(2):
                    lb = (lb_all >> y) & 1
                    for x in range(2):
                        nz = _coeffs(tr, proba, 2, lb + ((tb >> x) & 1), 0)
                        lb = int(nz > 0)
                        tb = (tb & ~(1 << x)) | (lb << x)
                        any_nz |= nz > 0
                    lb_all = (lb_all & ~(1 << y)) | (lb << y)
                out_t |= tb << (4 + ch)
                out_l |= lb_all << (4 + ch)
            nz_t[mb_x] = (out_t, t_dc)
            left = (out_l, l_dc)
            mb["tokens"] = tr.log[start:]
            mb["zero"] = not any_nz
        mbs.append(row)
    f["mbs"] = mbs
    return f


def _bmode(r, p):
    if not r.bit(p[0]):
        return 0
    if not r.bit(p[1]):
        return 1
    if not r.bit(p[2]):
        return 2
    if not r.bit(p[3]):
        if not r.bit(p[4]):
            return 3
        return 5 if r.bit(p[5]) else 4
    if not r.bit(p[6]):
        return 6
    if not r.bit(p[7]):
        return 7
    return 9 if r.bit(p[8]) else 8


def write_vp8(f, simple=None, sharpness=None, log2_parts=None, lf_delta=None,
              skip_p=None, delta_segments=False):
    """`parse_vp8`'s frame written again, with the simple filter, another
    sharpness, 2^log2_parts token partitions (rows dealt out in turn),
    loop-filter deltas (ref_lf_delta[0], mode_lf_delta[0]), a skip
    probability (the macroblocks without a non-zero coefficient skipped)
    or the segments' values coded as deltas."""
    update = _codec_table("kCoeffsUpdateProba")
    e = BoolEncoder()
    e.lit(1, f["colorspace"])
    e.lit(1, f["clamp"])
    e.lit(1, f["use_segment"])
    if f["use_segment"]:
        e.lit(1, f["update_map"])
        upd = f["update_data"] or delta_segments
        e.lit(1, upd)
        if upd:
            absolute = f["absolute_delta"] and not delta_segments
            e.lit(1, absolute)
            q, fs = list(f["quantizer"]), list(f["filter_strength"])
            if delta_segments and f["absolute_delta"]:
                q = [v - f["base_q"] for v in q]
                fs = [v - f["level"] for v in fs]
            for vals, bits in ((q, 7), (fs, 6)):
                for v in vals:
                    e.lit(1, int(v != 0))
                    if v:
                        e.signed(bits, v)
        if f["update_map"]:
            for v in f["seg_proba"]:
                e.lit(1, int(v != 255))
                if v != 255:
                    e.lit(8, v)
    e.lit(1, f["simple"] if simple is None else simple)
    e.lit(6, f["level"])
    e.lit(3, f["sharpness"] if sharpness is None else sharpness)
    deltas = (f["ref_lf_delta"], f["mode_lf_delta"])
    if lf_delta is not None:
        deltas = ([lf_delta[0], None, None, None], [lf_delta[1], None, None, None])
    use = f["use_lf_delta"] or lf_delta is not None
    e.lit(1, use)
    if use:
        e.lit(1, 1)
        for vals in deltas:
            for v in vals:
                e.lit(1, int(v is not None))
                if v is not None:
                    e.signed(6, v)
    lp = f["log2_parts"] if log2_parts is None else log2_parts
    e.lit(2, lp)
    base_q = f["base_q"]
    e.lit(7, base_q)
    for v in f["dq"]:
        e.lit(1, int(v != 0))
        if v:
            e.signed(4, v)
    e.lit(1, f["refresh"])
    updates = dict(f["proba_updates"])
    for i in np.ndindex(4, 8, 3, 11):
        e.bit(int(update[i]), int(i in updates))
        if i in updates:
            e.lit(8, updates[i])
    use_skip = f["use_skip"] or skip_p is not None
    sp = skip_p if skip_p is not None else f["skip_p"]
    e.lit(1, use_skip)
    if use_skip:
        e.lit(8, sp)
    parts = [BoolEncoder() for _ in range(1 << lp)]
    for mb_y, row in enumerate(f["mbs"]):
        pe = parts[mb_y % len(parts)]
        for mb in row:
            for p, b in mb["seg"]:
                e.bit(p, b)
            skip = mb["skip"] or (skip_p is not None and mb["zero"])
            if use_skip:
                e.bit(sp, int(skip))
            for p, b in mb["modes"]:
                e.bit(p, b)
            if not skip:
                for p, b in mb["tokens"]:
                    pe.bit(p, b)
    first = e.flush()
    toks = [p.flush() for p in parts]
    tag = (f["tag"] & 0x1F) | (len(first) << 5)
    return (struct.pack("<I", tag)[:3] + f["dims"] + first
            + b"".join(struct.pack("<I", len(t))[:3] for t in toks[:-1])
            + b"".join(toks))


# ---------------------------------------------------------------------------
# The files
# ---------------------------------------------------------------------------

def smooth(h, w, phase=0.0):
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    return np.stack([128 + 100 * np.sin(x / 7.0 + k + phase) * np.cos(y / 5.0 - k)
                     for k in range(3)], -1).astype(np.uint8)


def anim_file(f0, f1, offset, **opts):
    """Two frames written by PIL (frame 0 `f0` at `offset` on the canvas of
    frame 1's size): the frames' chunks moved into an ANMF each."""
    h, w = f1.shape[:2]
    out = [vp8x(2 | 16, w, h), chunk(b"ANIM", b"\0" * 6)]
    for img, (x, y) in ((f0, offset), (f1, (0, 0))):
        cs = chunks_of(pil_webp(img, **opts))
        body = b"".join(chunk(t, p) for t, p in cs if t in (b"ALPH", b"VP8 ",
                                                           b"VP8L"))
        out.append(anmf(x, y, img.shape[1], img.shape[0], body))
    return riff(out)


def timing_smooth(n=2048):
    """`tools/gen_torch_assets.py` `timing_tiff`'s pixels."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    return np.stack([128 + 100 * np.sin(x / 150.0 + k) * np.cos(y / 97.0 - k)
                     for k in range(3)], -1).astype(np.uint8)


def webp_files(checker, bumps, projector, grain):
    """name -> bytes of the WebP files (the images of
    `tools/gen_torch_assets.py`)."""
    g = np.random.RandomState(14)
    files = {
        "checker.webp": pil_webp(checker, lossless=True),
        "checker_lossy.webp": pil_webp(checker, quality=80),
        "bumps.webp": pil_webp(bumps, lossless=True),
        "tiny.webp": pil_webp(checker[:8, :8], lossless=True),
    }
    ph, pw = projector.shape[:2]
    files["projector.webp"] = riff([
        vp8x(16, pw, ph),
        chunk(b"VP8L", pil_payload(projector, b"VP8L", lossless=True,
                                   exact=True))])
    a, b = smooth(40, 46), smooth(40, 46, 1.3)
    files["anim.webp"] = anim_file(a[3:21, 5:33], b, (12, 10), lossless=True)
    files["anim_lossy.webp"] = anim_file(a[:17, :30], b, (6, 16), quality=70)
    rgba = np.concatenate([a, ((np.arange(46)[None, :] * 5
                                + np.arange(40)[:, None] * 3) % 256)[
        ..., None].astype(np.uint8)], -1)
    files["lossy_alpha.webp"] = pil_webp(rgba, quality=75, alpha_quality=40)
    # ALPH chunks by hand on a PIL-written VP8 frame
    frame = pil_payload(a, quality=75)
    alpha = ((np.arange(46)[None, :] * 7 + np.arange(40)[:, None] * 2) % 256)
    for name, payload in (
            ("alph_raw_h.webp", alph_raw(g.randint(0, 256, (40, 46)), 1)),
            ("alph_raw_grad.webp", alph_raw(g.randint(0, 256, (40, 46)), 3)),
            ("alph_vp8l_v.webp", alph_vp8l(alpha, 2))):
        files[name] = riff([vp8x(16, 46, 40), chunk(b"ALPH", payload),
                            chunk(b"VP8 ", frame)])
    # VP8 frames written again: the paths PIL's encoder does not take
    seg = parse_vp8(pil_payload(smooth(52, 70), quality=60))
    files["vp8_simple.webp"] = riff([chunk(b"VP8 ", write_vp8(
        seg, simple=1, sharpness=3))])
    flat = np.repeat(np.repeat(g.randint(0, 256, (4, 5, 3)), 16, 0), 16, 1)
    flat = (flat + smooth(64, 80) // 16).astype(np.uint8)
    parsed = parse_vp8(pil_payload(flat, quality=40))
    files["vp8_parts.webp"] = riff([chunk(b"VP8 ", write_vp8(
        parsed, log2_parts=2, lf_delta=(5, -7), skip_p=100,
        delta_segments=True))])
    files["vp8l_predictors.webp"] = riff([chunk(b"VP8L", vp8l_predictors())])
    files["vp8l_transforms.webp"] = riff([chunk(b"VP8L", vp8l_transforms())])
    files["grain_2048.webp"] = pil_webp(grain, quality=80)
    files["smooth_2048.webp"] = pil_webp(timing_smooth(), lossless=True)
    return files


TIMING = ("grain_2048.webp", "smooth_2048.webp")
CORNER = 128


def write_webp_files(out, checker, bumps, projector, grain):
    """The WebP files, `checker_lossy_pil.png` and `webp_decodes.npz`."""
    import hashlib
    from PIL import Image
    dec = {}
    for fn, data in webp_files(checker, bumps, projector, grain).items():
        p = os.path.join(out, fn)
        with open(p, "wb") as fh:
            fh.write(data)
        full = np.asarray(Image.open(p).convert("RGB"))
        if fn in TIMING:
            dec[fn + ":sha256"] = np.frombuffer(
                hashlib.sha256(full.tobytes()).digest(), np.uint8)
            dec[fn + ":corner"] = full[:CORNER, :CORNER]
        else:
            dec[fn] = full
    Image.fromarray(dec["checker_lossy.webp"]).save(
        os.path.join(out, "checker_lossy_pil.png"))
    np.savez_compressed(os.path.join(out, "webp_decodes.npz"), **dec)


def main():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_assets", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_assets.py"))
    ga = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ga)
    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    os.makedirs(out, exist_ok=True)
    write_webp_files(out, ga.checker(), ga.bumps(), ga.projector(), ga.grain())


if __name__ == "__main__":
    main()
