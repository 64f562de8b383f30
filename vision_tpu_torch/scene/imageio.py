"""Image files without PIL, OpenCV or OpenEXR: the standard library's zlib
and struct, numpy, and the port's host library (`native.py`) for JPEG's
entropy decoding.

The JAX package reads PNG and JPEG through PIL and Radiance .hdr and
OpenEXR through OpenCV (`vision_tpu/scene/texture.py` `load_image`). This
module decodes what those libraries give for the files a scene names:

  * PNG (`read_png`): non-interlaced; bit depth 8 for colour types 0
    (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA), bit depth
    16 for types 2 and 6; every filter type; any number of IDAT chunks.
    The result is `PIL.Image.open(p).convert("RGB")`: alpha dropped (not
    composited), a palette expanded, grey replicated to three channels,
    16-bit samples cut to their high byte. Any other kind of PNG raises
    NotImplementedError.
  * Radiance .hdr (`read_hdr`): the `#?RADIANCE` / `#?RGBE` header, the
    `-Y H +X W` orientation, new-style run-length and flat scanlines,
    decoded as OpenCV decodes them: m * 2^(e - 136), no +0.5, e = 0 is 0;
    RGB order.
  * OpenEXR (`read_exr`): single-part scanline files, compression NONE,
    ZIPS and ZIP, HALF and FLOAT channels; R, G, B (A dropped) or Y
    (replicated). PIZ and the other compressions, tiled, deep and
    multi-part files raise NotImplementedError.
  * JPEG (`read_jpeg`): baseline and extended sequential Huffman files
    of 8-bit samples, 1 (grey) or 3 (YCbCr) components, any sampling
    factors, restart intervals, any size; decoded as PIL (libjpeg-turbo)
    decodes them, in libjpeg's integer arithmetic: the ISLOW IDCT
    (`jidctint.c`), "fancy" triangle-filter upsampling of h2v1, h1v2 and
    h2v2 chroma (`jdsample.c`), the YCbCr -> RGB tables (`jdcolor.c`).
    Progressive, arithmetic-coded, lossless, 12-bit, CMYK and Adobe
    (APP14) files raise NotImplementedError naming ROADMAP queue A, 7c.
  * `write_exr`: a single-part scanline OpenEXR of uncompressed FLOAT B, G,
    R channels.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from .. import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
EXR_MAGIC = 20000630


def _not_ported(what, slice_):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP queue A, slice {slice_}")


def read_image(path):
    """Decode `path` by its content: (array, kind) where kind is "ldr" (a
    uint8 [H, W, 3] RGB array) or "hdr" (float32 [H, W, 3] RGB). Raises
    FileNotFoundError for a missing file, NotImplementedError for a format
    or a variant this module does not decode, ValueError for a corrupt
    file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        return read_png(data), "ldr"
    if data[:2] == b"#?":
        return read_hdr(data), "hdr"
    if len(data) >= 4 and struct.unpack("<i", data[:4])[0] == EXR_MAGIC:
        return read_exr(data), "hdr"
    if data[:3] == b"\xff\xd8\xff":
        return read_jpeg(data), "ldr"
    raise NotImplementedError(
        f"'{os.path.basename(path)}': not a PNG, JPEG, Radiance .hdr or "
        "OpenEXR file: other formats (BMP, TGA, TIFF, ...) are ROADMAP "
        "queue A, 7c")


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

# colour type -> samples per pixel
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (8,), 2: (8, 16), 3: (8,), 4: (8,), 6: (8, 16)}


def _png_chunks(data):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n


def _unfilter(raw, h, stride, bpp):
    """Undo the per-row PNG filters of `raw` (h rows of 1 + stride bytes).
    A byte depends on the bytes of its left, upper and upper-left
    neighbour pixels, so every pixel of one anti-diagonal (x + y = d)
    reconstructs at once: h + w - 1 vectorised steps, whatever each row's
    filter (None, Sub, Up, Average or Paeth)."""
    rows = raw.reshape(h, 1 + stride)
    ft = rows[:, 0].astype(np.int64)
    if (ft > 4).any():
        raise ValueError(f"PNG filter type {int(ft.max())}")
    w = stride // bpp
    F = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    X = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row above, column left
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, c = X[y + 1, x], X[y, x + 1], X[y, x]  # left, up, up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        preds = np.stack([np.zeros_like(a), a, b, (a + b) >> 1, paeth])
        X[y + 1, x + 1] = (F[y, x] + preds[ft[y], np.arange(len(y))]) & 0xFF
    return X[1:, 1:].reshape(h, stride).astype(np.uint8)


def read_png(data):
    """PNG bytes -> uint8 [H, W, 3], as PIL's convert("RGB") gives them."""
    ihdr, plte, idat = None, None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if interlace != 0:
        raise NotImplementedError("interlaced (Adam7) PNG files are not decoded")
    if ctype not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[ctype]:
        raise NotImplementedError(
            f"PNG colour type {ctype} at bit depth {depth} is not decoded")
    if comp != 0 or filt != 0:
        raise ValueError("PNG compression or filter method")
    nch = _PNG_CHANNELS[ctype]
    bpp = nch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (1 + w * bpp):
        raise ValueError("truncated PNG image data")
    px = _unfilter(raw[:h * (1 + w * bpp)], h, w * bpp, bpp)
    if depth == 16:
        px = px.reshape(h, w, nch, 2)[..., 0]  # the high byte of each sample
    px = px.reshape(h, w, nch)
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte[:256]
        return pal[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


# ---------------------------------------------------------------------------
# JPEG (baseline and extended sequential Huffman, 8-bit samples)
# ---------------------------------------------------------------------------

def _jpeg_7c(what):
    return _not_ported(f"decoding {what} JPEG files", "7c")


# libjpeg's ISLOW IDCT constants (jidctint.c): FIX(x) = round(x * 2^13)
_CONST_BITS, _PASS1_BITS = 13, 2
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961,
 _F2053, _F2562, _F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137,
                            16069, 16819, 20995, 25172)


def _idct_1d(x, n):
    """One pass of the ISLOW IDCT over x[0..7] (int64 arrays), descaled by
    n bits with rounding: the eight outputs."""
    z1 = (x[2] + x[6]) * _F0541
    tmp2 = z1 - x[6] * _F1847
    tmp3 = z1 + x[2] * _F0765
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    r = 1 << (n - 1)
    return [(tmp10 + t3 + r) >> n, (tmp11 + t2 + r) >> n,
            (tmp12 + t1 + r) >> n, (tmp13 + t0 + r) >> n,
            (tmp13 - t0 + r) >> n, (tmp12 - t1 + r) >> n,
            (tmp11 - t2 + r) >> n, (tmp10 - t3 + r) >> n]


def _idct_islow(coef, q):
    """libjpeg's jpeg_idct_islow on every block at once: coef int16
    [..., 64] in natural order, q the quantisation table [64] -> uint8
    [..., 8, 8] samples. Columns first, then rows, in int64 (libjpeg's
    JLONG); libjpeg's zero-AC shortcuts give the same numbers. The output
    wraps as libjpeg's range-limit table does (mod 1024 around the
    centre, then clamped)."""
    c = coef.reshape(-1, 8, 8).astype(np.int64) * q.reshape(8, 8).astype(np.int64)
    ws = np.stack(_idct_1d([c[:, k, :] for k in range(8)],
                           _CONST_BITS - _PASS1_BITS), 1)        # [B, row, col]
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)],
                            _CONST_BITS + _PASS1_BITS + 3), 2)
    out = np.clip(((out + 512) & 1023) - 384, 0, 255).astype(np.uint8)
    return out.reshape(coef.shape[:-1] + (8, 8))


def _edge(plane, h, w):
    """plane[:h, :w] with its last row and column repeated once more on
    each side (libjpeg's context rows and edge columns)."""
    p = plane[:h, :w].astype(np.int32)
    return np.pad(p, 1, mode="edge")


def _fancy_h(p):
    """libjpeg's h2v1 fancy upsampling of the padded rows p [h, w + 2]:
    3/4 of the nearer sample and 1/4 of the further, biased 1 and 2."""
    c = 3 * p[:, 1:-1]
    out = np.empty((p.shape[0], 2 * (p.shape[1] - 2)), np.int32)
    out[:, 0::2] = (c + p[:, :-2] + 1) >> 2
    out[:, 1::2] = (c + p[:, 2:] + 2) >> 2
    return out


def _upsample(plane, h, w, fy, fx):
    """A component's samples plane[:h, :w] upsampled by (fy, fx) as
    libjpeg-turbo's jdsample.c does with fancy upsampling on: h2v1 and
    h2v2 by triangle filters when the component is more than 2 samples
    wide, h1v2 always, any other integral factor (and h2v1 / h2v2 of a
    component at most 2 wide) by replication."""
    if (fy, fx) == (1, 1):
        return plane[:h, :w]
    if (fy, fx) == (1, 2) and w > 2:
        return _fancy_h(_edge(plane, h, w)[1:-1])
    if (fy, fx) in ((2, 1), (2, 2)) and (fx == 1 or w > 2):
        p = _edge(plane, h, w)
        c = 3 * p[1:-1]
        up, down = c + p[:-2], c + p[2:]   # column sums for rows 2y, 2y + 1
        if fx == 1:
            out = np.empty((2 * h, p.shape[1]), np.int32)
            out[0::2], out[1::2] = (up + 1) >> 2, (down + 2) >> 2
            return out[:, 1:-1]
        out = np.empty((2 * h, 2 * w), np.int32)
        for rows, s in ((slice(0, None, 2), up), (slice(1, None, 2), down)):
            cs = 3 * s[:, 1:-1]
            out[rows, 0::2] = (cs + s[:, :-2] + 8) >> 4
            out[rows, 1::2] = (cs + s[:, 2:] + 7) >> 4
        return out
    return np.repeat(np.repeat(plane[:h, :w], fy, 0), fx, 1)


def _ycc_to_rgb(y, cb, cr):
    """libjpeg's ycc_rgb_convert: its fixed-point tables (16 bits)."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)

    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    y = y.astype(np.int64)
    cb, cr = cb.astype(np.intp), cr.astype(np.intp)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def read_jpeg(data):
    """JPEG bytes -> uint8 [H, W, 3], as PIL's convert("RGB") gives them
    (grey replicated to three channels). Raises NotImplementedError (7c)
    for progressive, arithmetic-coded, lossless or hierarchical files, for
    12-bit samples, and for CMYK or Adobe (APP14) files; ValueError for a
    corrupt file."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    qt = {}
    huff_bits = np.zeros((8, 16), np.uint8)
    huff_vals = np.zeros((8, 256), np.uint8)
    frame, comps, planes, latched = None, None, None, {}
    restart, jfif = 0, False
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and pos + 1 < len(data) \
                and data[pos + 1] == 0xFF:
            pos += 1  # fill bytes before a marker
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise ValueError("corrupt JPEG: expected a marker")
        marker = data[pos + 1]
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            pos += 2
            continue
        n, = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + n]
        if len(body) != n - 2:
            raise ValueError("truncated JPEG segment")
        pos += 2 + n
        if marker == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe":
            raise _jpeg_7c("Adobe (APP14: CMYK, YCCK or RGB)")
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                zz = np.frombuffer(body, ">u2" if pq else "u1", 64, i + 1)
                q = np.empty(64, np.int64)
                q[_ZIGZAG] = zz
                qt[tq] = q
                i += 1 + size
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                if tc > 1 or th > 3:
                    raise ValueError("corrupt JPEG Huffman table id")
                bits = np.frombuffer(body, np.uint8, 16, i + 1)
                nv = int(bits.sum())
                if nv > 256:
                    raise ValueError("corrupt JPEG Huffman table")
                huff_bits[4 * tc + th] = bits
                huff_vals[4 * tc + th] = 0
                huff_vals[4 * tc + th, :nv] = np.frombuffer(body, np.uint8, nv,
                                                             i + 17)
                i += 17 + nv
        elif marker == 0xDD:  # DRI
            restart, = struct.unpack(">H", body[:2])
        elif marker in (0xC0, 0xC1):  # SOF0 / SOF1: sequential Huffman
            prec, H, W, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise _jpeg_7c(f"{prec}-bit")
            if nc not in (1, 3):
                raise _jpeg_7c(f"{nc}-component (CMYK)" if nc == 4
                               else f"{nc}-component")
            if H == 0 or W == 0:
                raise ValueError("JPEG without a height or width (DNL)")
            comps = [dict(id=body[6 + 3 * k], h=body[7 + 3 * k] >> 4,
                          v=body[7 + 3 * k] & 15, tq=body[8 + 3 * k])
                     for k in range(nc)]
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
            for c in comps:
                c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
                c["w"] = -(-W * c["h"] // hmax)
                c["h_px"] = -(-H * c["v"] // vmax)
            planes = [np.zeros((c["bh"], c["bw"], 64), np.int16) for c in comps]
            frame = (H, W, hmax, vmax, mcux, mcuy)
        elif 0xC2 <= marker <= 0xCF and marker != 0xC4:
            raise _jpeg_7c({0xC2: "progressive", 0xC3: "lossless",
                            0xC8: "JPEG-extension"}.get(
                marker, "arithmetic-coded" if marker >= 0xC9
                else "hierarchical"))
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns = body[0]
            rows, sel = [], []
            for k in range(ns):
                cid, tables = body[1 + 2 * k], body[2 + 2 * k]
                ci = next((j for j, c in enumerate(comps) if c["id"] == cid),
                          None)
                if ci is None or tables >> 4 > 3 or tables & 15 > 3:
                    raise ValueError("corrupt JPEG scan header")
                c = comps[ci]
                if ci not in latched:  # libjpeg latches a table at its scan
                    if c["tq"] not in qt:
                        raise ValueError("JPEG quantisation table missing")
                    latched[ci] = qt[c["tq"]].copy()
                sel.append(ci)
                rows.append([tables >> 4, tables & 15, c["h"], c["v"], c["bw"],
                             -(-c["w"] // 8), -(-c["h_px"] // 8)])
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, a) != (0, 63, 0):
                raise _jpeg_7c("progressive")
            pos = native.jpeg_decode_scan(
                data, pos, np.asarray(rows, np.int32), [planes[i] for i in sel],
                huff_bits, huff_vals, frame[4], frame[5], restart)
    if frame is None:
        raise ValueError("JPEG without a frame header")
    H, W, hmax, vmax = frame[:4]
    out = []
    for ci, c in enumerate(comps):
        if ci not in latched:
            raise ValueError("JPEG component without a scan")
        blocks = _idct_islow(planes[ci], latched[ci])       # [bh, bw, 8, 8]
        px = blocks.transpose(0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        if vmax % c["v"] or hmax % c["h"]:
            raise _jpeg_7c("fractionally sampled")
        up = _upsample(px, c["h_px"], c["w"], vmax // c["v"], hmax // c["h"])
        out.append(up[:H, :W])
    if len(comps) == 1:
        return np.repeat(out[0][..., None].astype(np.uint8), 3, axis=-1)
    ids = [c["id"] for c in comps]
    if not jfif and ids == [82, 71, 66]:
        raise _jpeg_7c("RGB (unconverted)")
    return _ycc_to_rgb(*out)


# zig-zag position k -> natural (row-major) index
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


# ---------------------------------------------------------------------------
# Radiance .hdr (RGBE)
# ---------------------------------------------------------------------------

def _rgbe_scanline(data, pos, w):
    """One scanline at `pos` -> (uint8 [w, 4], next pos): new-style
    run-length (2, 2, w >> 8, w & 255, then four runs of channels) or flat."""
    head = data[pos:pos + 4]
    if (8 <= w < 0x8000 and len(head) == 4 and head[0] == 2 and head[1] == 2
            and not head[2] & 0x80):
        if (head[2] << 8 | head[3]) != w:
            raise ValueError("RGBE scanline width mismatch")
        pos += 4
        line = np.empty((4, w), np.uint8)
        for c in range(4):
            x = 0
            while x < w:
                n = data[pos]
                pos += 1
                if n > 128:  # a run
                    n -= 128
                    if x + n > w:
                        raise ValueError("bad RGBE run")
                    line[c, x:x + n] = data[pos]
                    pos += 1
                else:        # a dump
                    if n == 0 or x + n > w:
                        raise ValueError("bad RGBE dump")
                    line[c, x:x + n] = np.frombuffer(data, np.uint8, n, pos)
                    pos += n
                x += n
        return line.T, pos
    if pos + 4 * w > len(data):
        raise ValueError("truncated RGBE data")
    return np.frombuffer(data, np.uint8, 4 * w, pos).reshape(w, 4), pos + 4 * w


def read_hdr(data):
    """Radiance .hdr bytes -> float32 [H, W, 3] RGB, decoded as OpenCV
    decodes RGBE: m * 2^(e - 136), 0 where e == 0."""
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance .hdr file")
    pos = 0
    while True:  # header lines up to the empty line
        end = data.index(b"\n", pos)
        line = data[pos:end].strip()
        pos = end + 1
        if line.startswith(b"FORMAT=") and line != b"FORMAT=32-bit_rle_rgbe":
            raise NotImplementedError(f"Radiance {line.decode()} is not decoded")
        if not line and end > 0:
            break
    end = data.index(b"\n", pos)
    dims = data[pos:end].split()
    pos = end + 1
    if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
        raise NotImplementedError(
            f"Radiance orientation {b' '.join(dims).decode()!r}: only "
            "'-Y H +X W' is decoded")
    h, w = int(dims[1]), int(dims[3])
    rgbe = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        rgbe[y], pos = _rgbe_scanline(data, pos, w)
    e = rgbe[..., 3].astype(np.int32)
    f = np.ldexp(1.0, e - 136).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * f[..., None]
    return np.where((e > 0)[..., None], out, np.float32(0.0)).astype(np.float32)


# ---------------------------------------------------------------------------
# OpenEXR
# ---------------------------------------------------------------------------

_EXR_NONE, _EXR_ZIPS, _EXR_ZIP = 0, 2, 3
_EXR_HALF, _EXR_FLOAT = 1, 2
_EXR_DTYPE = {_EXR_HALF: np.dtype("<f2"), _EXR_FLOAT: np.dtype("<f4")}
_EXR_LINES = {_EXR_NONE: 1, _EXR_ZIPS: 1, _EXR_ZIP: 16}


def _cstr(data, pos):
    end = data.index(b"\0", pos)
    return data[pos:end].decode("latin-1"), end + 1


def _exr_header(data):
    magic, version = struct.unpack("<ii", data[:8])
    if magic != EXR_MAGIC:
        raise ValueError("not an OpenEXR file")
    if version & 0x200:
        raise NotImplementedError("tiled OpenEXR files are not decoded")
    if version & 0x1800:
        raise NotImplementedError("deep or multi-part OpenEXR files are "
                                  "not decoded")
    pos, attrs = 8, {}
    while data[pos] != 0:
        name, pos = _cstr(data, pos)
        typ, pos = _cstr(data, pos)
        size, = struct.unpack("<i", data[pos:pos + 4])
        attrs[name] = (typ, data[pos + 4:pos + 4 + size])
        pos += 4 + size
    return attrs, pos + 1


def _exr_channels(body):
    chans, pos = [], 0
    while body[pos] != 0:
        name, pos = _cstr(body, pos)
        ptype, _, xs, ys = struct.unpack("<iB3xii", body[pos:pos + 16])
        pos += 16
        if ptype not in _EXR_DTYPE:
            raise NotImplementedError(f"OpenEXR channel '{name}' of pixel "
                                      f"type {ptype}: only HALF and FLOAT")
        if (xs, ys) != (1, 1):
            raise NotImplementedError("sub-sampled OpenEXR channels are not "
                                      "decoded")
        chans.append((name, _EXR_DTYPE[ptype]))
    return chans


def _exr_unzip(block, n_bytes):
    """A ZIP / ZIPS block -> its raw bytes: inflate, undo the predictor,
    then the interleave of the two halves."""
    if len(block) >= n_bytes:  # stored raw: it did not compress
        return block
    d = np.frombuffer(zlib.decompress(block), np.uint8).astype(np.int64)
    if d.size != n_bytes:
        raise ValueError("OpenEXR ZIP block size")
    # the predictor: t[0] = d[0], t[i] = t[i-1] + d[i] - 128 (mod 256)
    d[1:] -= 128
    t = (np.cumsum(d) & 0xFF).astype(np.uint8)
    half = (n_bytes + 1) // 2
    out = np.empty(n_bytes, np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def read_exr(data):
    """OpenEXR bytes (single part, scanlines, NONE / ZIPS / ZIP) -> float32
    [H, W, 3] RGB; A is dropped, Y alone is replicated."""
    attrs, pos = _exr_header(data)
    comp = attrs["compression"][1][0]
    if comp not in _EXR_LINES:
        raise NotImplementedError(
            f"OpenEXR compression {comp}: only NONE, ZIPS and ZIP are decoded")
    chans = _exr_channels(attrs["channels"][1])
    names = [c for c, _ in chans]
    if set(names) - {"A"} == {"R", "G", "B"}:
        pick = ("R", "G", "B")
    elif set(names) - {"A"} == {"Y"}:
        pick = ("Y", "Y", "Y")
    else:
        raise NotImplementedError(
            f"OpenEXR channels {names}: only R, G, B or Y (and A) are decoded")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    lines = _EXR_LINES[comp]
    n_chunks = (h + lines - 1) // lines
    offsets = struct.unpack(f"<{n_chunks}Q", data[pos:pos + 8 * n_chunks])
    planes = {c: np.zeros((h, w), np.float32) for c, _ in chans}
    for off in offsets:
        y, size = struct.unpack("<ii", data[off:off + 8])
        block = data[off + 8:off + 8 + size]
        ny = min(lines, y1 - y + 1)
        row_bytes = sum(w * dt.itemsize for _, dt in chans)
        raw = block if comp == _EXR_NONE else _exr_unzip(block, ny * row_bytes)
        if len(raw) != ny * row_bytes:
            raise ValueError("OpenEXR block size")
        p = 0
        for r in range(ny):
            for c, dt in chans:
                planes[c][y - y0 + r] = np.frombuffer(raw, dt, w, p)
                p += w * dt.itemsize
    return np.ascontiguousarray(np.stack([planes[c] for c in pick], -1))


def _attr(name, typ, body):
    return name.encode() + b"\0" + typ.encode() + b"\0" + \
        struct.pack("<i", len(body)) + body


def write_exr(img, path):
    """Write float32 img [H, W, 3] (RGB) as a single-part scanline OpenEXR:
    uncompressed FLOAT channels B, G, R (a channel list is sorted by name),
    INCREASING_Y, one scanline per chunk behind its offset table."""
    arr = np.ascontiguousarray(np.asarray(img, np.float32)[..., :3])
    h, w = arr.shape[:2]
    chlist = b"".join(c.encode() + b"\0" + struct.pack("<iB3xii", _EXR_FLOAT,
                                                       0, 1, 1)
                      for c in ("B", "G", "R")) + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (struct.pack("<ii", EXR_MAGIC, 2)
              + _attr("channels", "chlist", chlist)
              + _attr("compression", "compression", bytes([_EXR_NONE]))
              + _attr("dataWindow", "box2i", box)
              + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder", bytes([0]))
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    # per scanline: y, byte count, then B, G, R planes of w floats each
    bgr = arr[..., ::-1].transpose(0, 2, 1).astype("<f4")  # [H, 3, W]
    size = 3 * w * 4
    first = len(header) + 8 * h
    offsets = struct.pack(f"<{h}Q", *(first + y * (8 + size) for y in range(h)))
    with open(path, "wb") as f:
        f.write(header + offsets)
        for y in range(h):
            f.write(struct.pack("<ii", y, size) + bgr[y].tobytes())
