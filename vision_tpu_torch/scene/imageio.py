"""Image files without PIL, OpenCV or OpenEXR: the standard library's zlib
and struct, numpy, and the port's host library (`native.py`) for JPEG's
entropy decoding.

The JAX package reads PNG, JPEG, BMP, TGA and the other LDR files through
PIL and Radiance .hdr and OpenEXR through OpenCV
(`vision_tpu/scene/texture.py` `load_image`). This module decodes what
those libraries give for the files a scene names, and refuses, with
ValueError, what they refuse:

  * PNG (`read_png`): every colour type at every bit depth PNG defines,
    Adam7-interlaced or not, every filter type, any number of IDAT chunks.
    The result is `PIL.Image.open(p).convert("RGB")`: alpha dropped (not
    composited), a palette expanded, 1/2/4-bit grey scaled up, 16-bit grey
    clipped at 255 and other 16-bit samples cut to their high byte.
  * JPEG (`read_jpeg`): sequential and progressive files of 8-bit
    samples, Huffman- or arithmetic-coded, and lossless Huffman files (1x1
    sampling); any sampling factors, restart intervals, any size; grey,
    YCbCr, RGB, CMYK and YCCK chosen as libjpeg chooses (JFIF, the Adobe
    APP14 transform, the component ids); decoded as PIL (libjpeg-turbo)
    decodes them, in libjpeg's integer arithmetic: the ISLOW IDCT
    (`jidctint.c`), "fancy" triangle-filter upsampling of h2v1, h1v2 and
    h2v2 chroma (`jdsample.c`), the YCbCr -> RGB tables (`jdcolor.c`),
    PIL's inverted CMYK and its CMYK -> RGB. Arithmetic-coded lossless and
    subsampled lossless files raise NotImplementedError naming ROADMAP
    queue A, 7d; 12-bit, hierarchical and fractionally sampled ones are
    refused.
  * BMP (`read_bmp`) and TGA (`read_tga`): as PIL's plugins read them
    (their docstrings list the variants), quirks included.
  * Radiance .hdr (`read_hdr`): the `#?RADIANCE` / `#?RGBE` header, the
    `-Y H +X W` orientation (OpenCV refuses the others, and so does this
    module), new-style run-length and flat scanlines, decoded as OpenCV
    decodes them: m * 2^(e - 136), no +0.5, e = 0 is 0; RGB order.
  * OpenEXR (`read_exr`): single-part scanline files, compression NONE,
    ZIPS and ZIP, HALF and FLOAT channels; R, G, B (A dropped) or Y
    (replicated). PIZ and the other compressions, tiled, deep and
    multi-part files raise NotImplementedError (7d).
  * `write_exr`: a single-part scanline OpenEXR of uncompressed FLOAT B, G,
    R channels.

TIFF, GIF, WebP and the other formats PIL opens raise NotImplementedError
naming ROADMAP queue A, 7d.
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


# magic numbers of the formats PIL opens that this module does not decode
# (checked before TGA, which has none: an icon's header would pass for one,
# and a TGA's header can read as an icon directory of 0 entries)
_OTHER_FORMATS = ((b"II*\0", "TIFF"), (b"MM\0*", "TIFF"), (b"II+\0", "TIFF"),
                  (b"MM\0+", "TIFF"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
                  (b"\0\0\1\0", "ICO"), (b"\0\0\2\0", "CUR"),
                  (b"8BPS", "PSD"), (b"DDS ", "DDS"), (b"qoif", "QOI"),
                  (b"icns", "ICNS"), (b"\0\0\0\x0cjP  ", "JPEG 2000"),
                  (b"\xffO\xffQ", "JPEG 2000"))


def _other_format(data):
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    name = next((name for magic, name in _OTHER_FORMATS
                 if data.startswith(magic)), None)
    if name in ("ICO", "CUR") and data[4:6] == b"\0\0":
        return None  # no icons: PIL's plugins pass it on (a TGA's header)
    return name


def read_image(path):
    """Decode `path` by its content: (array, kind) where kind is "ldr" (a
    uint8 [H, W, 3] RGB array) or "hdr" (float32 [H, W, 3] RGB). TGA, which
    has no magic number, is tried last, with PIL's header checks. Raises
    FileNotFoundError for a missing file, NotImplementedError for a format
    or a variant this module does not decode, ValueError for a corrupt
    file or one the reference's library refuses too."""
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
    if data[:2] == b"BM":
        return read_bmp(data), "ldr"
    name = os.path.basename(path)
    other = _other_format(data)
    if other is not None:
        raise _not_ported(f"'{name}': decoding {other} files", "7d")
    if _tga_header(data) is not None:
        return read_tga(data), "ldr"
    raise NotImplementedError(
        f"'{name}': not a PNG, JPEG, BMP, TGA, Radiance .hdr or OpenEXR "
        "file: other formats (TIFF, GIF, WebP, ...) are ROADMAP queue A, 7d")


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

# colour type -> samples per pixel, and the bit depths PNG defines for it
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
               6: (8, 16)}
# Adam7: each pass's first column and row and its steps
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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
    """Undo the per-row PNG filters of `raw` (h rows of 1 + stride bytes;
    bpp: the bytes of a pixel, at least 1). A byte depends on the bytes of
    its left, upper and upper-left neighbour pixels, so every pixel of one
    anti-diagonal (x + y = d) reconstructs at once: h + w - 1 vectorised
    steps, whatever each row's filter (None, Sub, Up, Average or Paeth)."""
    rows = raw.reshape(h, 1 + stride)
    ft = rows[:, 0].astype(np.int64)
    if (ft > 4).any():
        raise ValueError(f"PNG filter type {int(ft.max())}")
    w = -(-stride // bpp)
    F = np.zeros((h, w * bpp), np.int32)   # a sub-byte row may end mid-pixel
    F[:, :stride] = rows[:, 1:]
    F = F.reshape(h, w, bpp)
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
    return X[1:, 1:].reshape(h, w * bpp)[:, :stride].astype(np.uint8)


def _png_samples(raw, h, w, depth, nch):
    """One (sub-)image of h rows of w pixels from the front of `raw`:
    (its samples int32 [h, w, nch], the bytes it took)."""
    stride = -(-w * nch * depth // 8)
    n = h * (1 + stride)
    if raw.size < n:
        raise ValueError("truncated PNG image data")
    px = _unfilter(raw[:n], h, stride, max(1, nch * depth // 8))
    if depth == 16:
        v = px.reshape(h, w * nch, 2).astype(np.int32)
        v = v[..., 0] << 8 | v[..., 1]
    elif depth == 8:
        v = px.astype(np.int32)
    else:  # 1, 2 or 4 bits, the first sample in the high bits
        bits = np.unpackbits(px, axis=1)[:, :w * nch * depth]
        v = bits.reshape(h, w * nch, depth).astype(np.int32)
        v = (v << np.arange(depth - 1, -1, -1)).sum(-1)
    return v.reshape(h, w, nch), n


def read_png(data):
    """PNG bytes -> uint8 [H, W, 3], as PIL's convert("RGB") gives them:
    alpha dropped (not composited), a palette expanded (missing entries
    black), 1/2/4-bit grey scaled to 0..255, 16-bit grey clipped at 255
    (PIL's I;16 -> RGB), other 16-bit samples cut to their high byte.
    Adam7 files are de-interlaced. A colour type and bit depth that PNG
    does not define is refused, as PIL refuses it (ValueError)."""
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
    if ctype not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[ctype]:
        raise ValueError(f"PNG colour type {ctype} at bit depth {depth} is "
                         "not defined (PIL refuses it too)")
    if comp != 0 or filt != 0 or interlace > 1:
        raise ValueError("PNG compression, filter or interlace method")
    nch = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace == 0:
        v = _png_samples(raw, h, w, depth, nch)[0]
    else:
        v = np.zeros((h, w, nch), np.int32)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:  # an empty pass has no bytes at all
                sub, n = _png_samples(raw[pos:], ph, pw, depth, nch)
                v[y0::dy, x0::dx] = sub
                pos += n
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte[:256]
        return pal[v[..., 0]]
    if ctype == 0 and depth == 16:
        g = np.minimum(v[..., 0], 255)                 # PIL's I;16 -> RGB
    elif depth == 16:
        v = v >> 8
        g = v[..., 0]
    else:
        g = v[..., 0] * (255 // ((1 << depth) - 1))    # 1/2/4 bits: x255/85/17
    if ctype in (0, 4):
        return np.repeat(g[..., None], 3, axis=-1).astype(np.uint8)
    return np.ascontiguousarray(v[..., :3]).astype(np.uint8)


# ---------------------------------------------------------------------------
# TGA (as PIL's TgaImagePlugin reads it)
# ---------------------------------------------------------------------------

_TGA_TYPES = (1, 2, 3, 9, 10, 11)   # colour-mapped, true colour, grey; + 8: RLE


def _tga_header(data):
    """(id length, colour-map type, image type, width, height, depth, flags)
    when `data` passes the checks PIL makes before it calls a file a TGA
    (PIL has no magic number for TGA), else None."""
    if len(data) < 18:
        return None
    id_len, cmtype, itype = data[0], data[1], data[2]
    w, h = struct.unpack("<HH", data[12:16])
    depth, flags = data[16], data[17]
    if (cmtype not in (0, 1) or w <= 0 or h <= 0
            or depth not in (1, 8, 16, 24, 32) or itype not in _TGA_TYPES):
        return None
    return id_len, cmtype, itype, w, h, depth, flags


def _tga_refused(what):
    return ValueError(f"TGA {what} (PIL refuses it too)")


def _rgb15(v):
    """16-bit x1R5G5B5 words -> uint8 RGB, each 5-bit channel * 255 // 31
    (PIL's BGR;15 and BGRA;15Z unpackers)."""
    v = v.astype(np.int32)
    return (np.stack([(v >> 10) & 31, (v >> 5) & 31, v & 31], -1)
            * 255 // 31).astype(np.uint8)


def _tga_rle(data, pos, row_bytes, h, nb):
    """The run-length packets from `pos` -> h * row_bytes bytes, as PIL's
    decoder takes them: a raw packet may run on into the next row, and past
    the last one; a repeat packet that crosses a row's end is refused."""
    out = bytearray()
    total = row_bytes * h
    while len(out) < total:
        if pos >= len(data):
            raise ValueError("truncated TGA run-length data")
        head = data[pos]
        n = ((head & 0x7F) + 1) * nb
        if head & 0x80:
            if len(out) % row_bytes + n > row_bytes:
                raise _tga_refused("run-length packet across a row's end")
            px = data[pos + 1:pos + 1 + nb]
            pos += 1 + nb
            out += px * (n // nb)
        else:
            out += data[pos + 1:pos + 1 + n]
            pos += 1 + n
        if len(data) < pos:
            raise ValueError("truncated TGA run-length data")
    return bytes(out[:total])


def read_tga(data):
    """TGA bytes -> uint8 [H, W, 3], as PIL's convert("RGB") gives them:
    colour-mapped 8-bit (16- or 24-bit maps), true colour 16 (x1R5G5B5), 24
    and 32 bits (alpha dropped), grey 8 bits, grey + alpha 16 bits and (not
    run-length coded) 1 bit; run-length coding, the origin bits. What PIL
    refuses (a 15-bit depth or map, a 32-bit map, a map on a true-colour or
    grey image, other depths) raises ValueError."""
    hd = _tga_header(data)
    if hd is None:
        raise ValueError("not a TGA file")
    id_len, cmtype, itype, w, h, depth, flags = hd
    base = itype & 7
    pos = 18 + id_len
    pal = None
    if cmtype:
        start, size, mdepth = struct.unpack("<HHB", data[3:8])
        nb = {16: 2, 24: 3, 32: 4}.get(mdepth)
        if nb is None:
            raise _tga_refused(f"colour map of {mdepth} bits")
        entries = np.frombuffer(data, np.uint8, nb * size, pos).reshape(size, nb)
        pos += nb * size
        if base == 2 or mdepth == 32:
            raise _tga_refused("colour map on a true-colour image"
                               if base == 2 else "32-bit colour map")
        rgb = (_rgb15(entries.view("<u2")[:, 0]) if nb == 2
               else entries[:, 2::-1])
        pal = np.zeros((max(256, start + size), 3), np.uint8)
        pal[start:start + size] = rgb
    if (base, depth) not in ((1, 8), (3, 1), (3, 8), (3, 16), (2, 16),
                             (2, 24), (2, 32)) or (base == 1 and pal is None):
        raise _tga_refused(f"image type {itype} at {depth} bits")
    if depth == 1 and (itype & 8 or pal is not None):
        raise _tga_refused("1-bit run-length or colour-mapped image")
    nb = max(1, depth // 8)
    row_bytes = -(-w * depth // 8)
    if itype & 8:
        raw = _tga_rle(data, pos, row_bytes, h, nb)
    else:
        raw = data[pos:pos + row_bytes * h]
        if len(raw) < row_bytes * h:
            raise ValueError("truncated TGA image data")
    px = np.frombuffer(raw, np.uint8).reshape(h, row_bytes)
    if depth == 1:
        g = np.unpackbits(px, axis=1)[:, :w] * np.uint8(255)
    else:
        px = px.reshape(h, w, nb)
        if base == 1:
            out = pal[px[..., 0]]
        elif base == 3:
            g = px[..., 0]                       # grey, or grey then alpha
            if pal is not None:                  # PIL converts through a map
                out, base = pal[g], 0
        elif depth == 16:
            out = _rgb15(px.view("<u2")[..., 0])
        else:
            out = px[..., 2::-1]                 # BGR(A) -> RGB
    if base == 3:
        out = np.repeat(g[..., None], 3, axis=-1)
    if not flags & 0x20:                         # stored bottom-up
        out = out[::-1]
    if flags & 0x10:                             # stored right to left
        out = out[:, ::-1]
    return np.ascontiguousarray(out)


# ---------------------------------------------------------------------------
# BMP (as PIL's BmpImagePlugin reads it)
# ---------------------------------------------------------------------------

# 32-bit bitfield masks (R, G, B, A) PIL accepts -> the bytes of R, G, B in a
# little-endian pixel; (0, 0, 0, 0) reads as BGRA
_BMP_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0),
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1),
    (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0),
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0),
    (0x0, 0x0, 0x0, 0x0): (2, 1, 0),
}


def _bmp_refused(what):
    return ValueError(f"BMP {what} (PIL refuses it too)")


def _bmp_rle(data, pos, w, h, rle4):
    """An RLE8 / RLE4 stream from file offset `pos` -> indices uint8
    [h * w] in file row order, decoded as PIL's BmpRleDecoder decodes it:
    an encoded run is cut at its row's end; an absolute stretch is not,
    reads count // 2 bytes in RLE4 and is followed by a pad to an even
    file offset; an end of line pads with zeros to the next whole row; a
    delta skips the two bytes after its escape and takes the next two as
    (right, up)."""
    out = bytearray()
    x, n_px = 0, w * h
    while len(out) < n_px:
        if pos + 2 > len(data):
            break
        n, b = data[pos], data[pos + 1]
        pos += 2
        if n:                                    # encoded
            n = max(0, w - x) if x + n > w else n
            if rle4:
                out += bytes((b >> 4, b & 15)) * (n // 2) + \
                    (bytes((b >> 4,)) if n % 2 else b"")
            else:
                out += bytes((b,)) * n
            x += n
        elif b == 0:                             # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif b == 1:                             # end of bitmap
            break
        elif b == 2:                             # delta
            if pos + 2 > len(data):
                break
            pos += 2
            if pos + 2 > len(data):
                raise _bmp_refused("delta cut short")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:                                    # absolute
            k = b // 2 if rle4 else b
            raw = data[pos:pos + k]
            pos += len(raw)
            if rle4:
                r = np.frombuffer(raw, np.uint8)
                out += np.stack([r >> 4, r & 15], -1).tobytes()
            else:
                out += raw
            if len(raw) < k:
                break
            x += b
            pos += pos % 2
    if len(out) < n_px:
        raise _bmp_refused("run-length data that ends before its image")
    return np.frombuffer(bytes(out[:n_px]), np.uint8)


def read_bmp(data):
    """BMP bytes -> uint8 [H, W, 3], as PIL's convert("RGB") gives them:
    the 12-byte core header and the 40- to 124-byte info headers; 1, 4 and
    8 bits through a palette (missing entries black), 16 bits (x1R5G5B5 or
    bitfields 565 / 555), 24 and 32 bits (BGRX, the bitfield layouts PIL
    knows; alpha dropped); BI_RGB, BI_BITFIELDS, BI_RLE8 and BI_RLE4; rows
    bottom-up or top-down. What PIL refuses (other depths, compressions or
    bitfields, a grey-ramp palette below 8 bits, RLE with a black-and-white
    palette, data that ends early) raises ValueError."""
    if data[:2] != b"BM" or len(data) < 18:
        raise ValueError("not a BMP file")
    offset, hsize = struct.unpack("<II", data[10:18])
    hd = data[18:14 + hsize]
    if len(hd) != hsize - 4:
        raise ValueError("truncated BMP header")
    pos = 14 + hsize
    masks = None
    if hsize == 12:
        w, h, _, bits = struct.unpack("<HHHH", hd[:8])
        comp, colors, pad, flip = 0, 0, 3, False
    elif hsize in (40, 52, 56, 64, 108, 124):
        flip = hd[7] == 0xFF
        w, h, _, bits, comp = struct.unpack("<iIHHI", hd[:16])
        h = 2 ** 32 - h if flip else h
        colors, = struct.unpack("<I", hd[28:32])
        pad = 4
        if comp == 3:
            if len(hd) >= 48:
                n = 4 if len(hd) >= 52 else 3
                masks = struct.unpack(f"<{n}I", hd[36:36 + 4 * n])
            else:
                masks = struct.unpack("<3I", data[pos:pos + 12])
                pos += 12
            masks = tuple(masks) + (0,) * (4 - len(masks))
    else:
        raise _bmp_refused(f"header of {hsize} bytes")
    if w <= 0 or not 0 < h < 2 ** 31:
        raise _bmp_refused(f"size {w} x {h}")
    colors = colors or 1 << bits
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise _bmp_refused(f"depth of {bits} bits")
    rle = comp in (1, 2)
    if comp == 3:
        if bits == 32 and masks in _BMP_MASKS32:
            order = _BMP_MASKS32[masks]
        elif (bits, masks[:3]) in ((24, (0xFF0000, 0xFF00, 0xFF)),):
            order = (2, 1, 0)
        elif bits == 16 and masks[:3] in ((0xF800, 0x7E0, 0x1F),
                                          (0x7C00, 0x3E0, 0x1F)):
            order = masks[0]
        else:
            raise _bmp_refused("bitfields layout")
    elif comp not in (0, 1, 2):
        raise _bmp_refused(f"compression {comp}")
    elif bits in (24, 32):
        order = (2, 1, 0)
    pal, grey = None, None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise _bmp_refused(f"palette of {colors} colours")
        p = np.frombuffer(data[pos:pos + pad * colors], np.uint8)
        pos += pad * colors
        p = p[:len(p) // pad * pad].reshape(-1, pad)
        # PIL drops a palette that is the grey ramp 0, 1, 2, ... (or black
        # and white) and reads the samples as grey ("L") or bits ("1")
        ramp = (0, 255) if colors == 2 else range(colors)
        if len(p) >= len(ramp) and all((p[i, :3] == v).all()
                                       for i, v in enumerate(ramp)):
            grey = "1" if colors == 2 else "L"
        pal = np.zeros((max(256, len(p)), 3), np.uint8)
        pal[:len(p)] = p[:, 2::-1]
    elif rle:
        raise _bmp_refused(f"RLE at {bits} bits")
    start = offset or pos
    if rle:
        if grey == "1":
            raise _bmp_refused("RLE with a black-and-white palette")
        idx = _bmp_rle(data, start, w, h, comp == 2).reshape(h, w)
        out = np.repeat(idx[..., None], 3, -1) if grey else pal[idx]
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        if grey == "L" and stride < w:
            # a grey ramp below 8 bits read as 8-bit grey: PIL memory-maps
            # the file, w bytes a row every `stride` bytes (zeros past its
            # end)
            if len(data) < start + stride * h:
                raise _bmp_refused("grey-ramp palette below 8 bits")
            at = start + stride * np.arange(h)[:, None] + np.arange(w)
            rows = np.frombuffer(data + bytes(w), np.uint8)[at]
        else:
            raw = data[start:start + stride * h]
            # the last row's padding may be missing, as PIL reads it
            line = -(-w // 8) if grey == "1" else w if grey == "L" else \
                -(-w * bits // 8)
            if len(raw) < stride * (h - 1) + line:
                raise ValueError("truncated BMP image data")
            rows = np.frombuffer(raw.ljust(stride * h, b"\0"),
                                 np.uint8).reshape(h, stride)
        if grey == "1":
            out = np.repeat(np.unpackbits(rows, axis=1)[:, :w, None], 3, -1) * \
                np.uint8(255)
        elif grey == "L":
            out = np.repeat(rows[:, :w, None], 3, -1)
        elif bits <= 8:
            v = np.unpackbits(rows, axis=1).reshape(h, -1, bits)[:, :w]
            v = (v.astype(np.int32) << np.arange(bits - 1, -1, -1)).sum(-1)
            out = pal[v]
        elif bits == 16:
            v = rows[:, :2 * w].view("<u2").astype(np.int32)
            if comp == 3 and order == 0xF800:    # 565: PIL's BGR;16
                out = (np.stack([(v >> 11) & 31, (v >> 5) & 63, v & 31], -1)
                       * 255 // np.array([31, 63, 31])).astype(np.uint8)
            else:                                # 555: PIL's BGR;15
                out = _rgb15(v)
        else:
            out = rows[:, :w * bits // 8].reshape(h, w, bits // 8)[..., order]
    if not flip:                                 # stored bottom-up
        out = out[::-1]
    return np.ascontiguousarray(out)


# ---------------------------------------------------------------------------
# JPEG (baseline and extended sequential Huffman, 8-bit samples)
# ---------------------------------------------------------------------------

def _jpeg_refused(what):
    return ValueError(f"{what} JPEG files: PIL (libjpeg-turbo) refuses them "
                      "too")


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


# T.81's default arithmetic conditioning: DC L and U, AC K of tables 0-3
_ARITH_CONDITIONING = (0,) * 4 + (1,) * 4 + (5,) * 4


def _cmyk_to_rgb(x, k):
    """PIL's CMYK -> RGB of one channel (Convert.c cmyk2rgb), written on the
    decoded samples: PIL reads a 4-component JPEG inverted ("CMYK;I"), so
    its ink is 255 - x and its black 255 - k; out = k - k * (255 - ink) /
    255 in PIL's integer rounding."""
    k = k.astype(np.int64)
    t = x.astype(np.int64) * k + 128
    return np.clip(k - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _lossless_rgb(planes, pt, jfif, adobe):
    """A lossless file's samples -> RGB as PIL gets them: each sample
    shifted back by its point transform into 8 bits; grey, RGB or CMYK
    (libjpeg converts no colour in lossless mode and refuses to: a YCbCr or
    YCCK file is refused)."""
    out = [((p.astype(np.int64) << pt[ci]) & 0xFF).astype(np.uint8)
           for ci, p in enumerate(planes)]
    if len(out) == 1:
        return np.repeat(out[0][..., None], 3, axis=-1)
    if (jfif and len(out) == 3) or (adobe is not None and adobe != 0):
        raise _jpeg_refused("lossless YCbCr or YCCK")
    if len(out) == 3:   # libjpeg takes lossless 3-component files as RGB
        return np.stack(out, -1)
    return _cmyk_to_rgb(255 - np.stack(out[:3], -1).astype(np.int64),
                        out[3][..., None])


def read_jpeg(data):
    """JPEG bytes -> uint8 [H, W, 3], as PIL's convert("RGB") gives them:
    sequential and progressive files of 8-bit samples, Huffman- or
    arithmetic-coded (DAC conditioning), and lossless Huffman files (1x1
    sampling); grey, YCbCr, RGB, CMYK and YCCK, the colour space chosen as
    libjpeg chooses it (JFIF, the Adobe APP14 transform, the component
    ids); PIL's CMYK -> RGB. Raises NotImplementedError (7d) for
    arithmetic-coded lossless and subsampled lossless files; ValueError
    for what PIL
    refuses too (12- and 16-bit samples, 2 or more than 4 components,
    hierarchical coding, fractional sampling, lossless YCbCr) and for a
    corrupt file."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    qt = {}
    huff_bits = np.zeros((8, 16), np.uint8)
    huff_vals = np.zeros((8, 256), np.uint8)
    frame, comps, planes, latched = None, None, None, {}
    restart, jfif, adobe, progressive, lossless = 0, False, None, False, False
    scanned = single_scan = False
    arith = None  # the conditioning of an arithmetic-coded file (DAC)
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
        if marker == 0xE0 and len(body) >= 14 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and len(body) >= 12 and body[:5] == b"Adobe":
            adobe = body[11]  # the colour transform
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
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if frame is not None:
                raise _jpeg_refused("a second frame header in")
            prec, H, W, nc = struct.unpack(">BHHB", body[:6])
            if len(body) != 6 + 3 * nc:
                raise _jpeg_refused("a frame header of the wrong length in")
            if prec != 8:
                raise _jpeg_refused(f"{prec}-bit")
            if nc not in (1, 3, 4):
                raise _jpeg_refused(f"{nc}-component")
            if marker in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
                raise _jpeg_refused("hierarchical")
            if marker == 0xCB:
                raise _not_ported("decoding arithmetic-coded lossless JPEG "
                                  "files", "7d")
            if H == 0 or W == 0:
                raise ValueError("JPEG without a height or width (DNL)")
            progressive = marker in (0xC2, 0xCA)
            lossless = marker == 0xC3
            if marker in (0xC9, 0xCA) and arith is None:
                arith = np.array(_ARITH_CONDITIONING, np.int32)
            comps = [dict(id=body[6 + 3 * k], h=body[7 + 3 * k] >> 4,
                          v=body[7 + 3 * k] & 15, tq=body[8 + 3 * k])
                     for k in range(nc)]
            if lossless and any((c["h"], c["v"]) != (1, 1) for c in comps):
                raise _not_ported("decoding subsampled lossless JPEG files",
                                  "7d")
            if not all(1 <= c["h"] <= 4 and 1 <= c["v"] <= 4 for c in comps):
                raise ValueError("corrupt JPEG sampling factors")
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            if any(hmax % c["h"] or vmax % c["v"] for c in comps):
                raise _jpeg_refused("fractionally sampled")
            mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
            for c in comps:
                c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
                c["w"] = -(-W * c["h"] // hmax)
                c["h_px"] = -(-H * c["v"] // vmax)
            planes = [np.zeros((H, W), np.uint16) if lossless else
                      np.zeros((c["bh"], c["bw"], 64), np.int16) for c in comps]
            frame = (H, W, hmax, vmax, mcux, mcuy)
        elif marker == 0xC8:  # the JPEG extension
            raise _jpeg_refused("JPEG-extension")
        elif marker == 0xCC:  # DAC: arithmetic-coding conditioning
            if arith is None:
                arith = np.array(_ARITH_CONDITIONING, np.int32)
            for i in range(0, len(body) - 1, 2):  # as libjpeg's get_dac
                tc, tb, val = body[i] >> 4, body[i] & 15, body[i + 1]
                if tc > 1 or (tc == 0 and val & 15 > val >> 4):
                    raise _jpeg_refused("bad arithmetic conditioning")
                if tb < 4 and tc == 0:
                    arith[tb], arith[4 + tb] = val & 15, val >> 4
                elif tb < 4:
                    arith[8 + tb] = val
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            if single_scan:  # libjpeg's JERR_EOI_EXPECTED
                raise _jpeg_refused("a scan after a whole sequential scan in")
            ns = body[0]
            if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
                raise _jpeg_refused("a scan header of the wrong length or of "
                                    f"{ns} components in")
            rows, sel = [], []
            for k in range(ns):
                cid, tables = body[1 + 2 * k], body[2 + 2 * k]
                # as libjpeg-turbo's get_sos: the first frame component of
                # that id at or after this slot, and none listed twice
                ci = next((j for j, c in enumerate(comps)
                           if c["id"] == cid and j >= k and j not in sel), None)
                if ci is None:
                    raise _jpeg_refused("a scan of a bad component id in")
                if tables >> 4 > 3 or tables & 15 > 3:
                    raise ValueError("corrupt JPEG scan header")
                c = comps[ci]
                if lossless:
                    latched.setdefault(ci, body[3 + 2 * ns] & 15)  # its Pt
                elif ci not in latched:  # libjpeg latches a table at its scan
                    if c["tq"] not in qt:
                        raise ValueError("JPEG quantisation table missing")
                    latched[ci] = qt[c["tq"]].copy()
                sel.append(ci)
                rows.append([tables >> 4, tables & 15, c["h"], c["v"], c["bw"],
                             -(-c["w"] // 8), -(-c["h_px"] // 8)])
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            ah, al = a >> 4, a & 15
            # a first scan of every component makes a single-scan image
            # (libjpeg's has_multiple_scans): no scan may follow it
            single_scan = not scanned and not progressive and ns == len(comps)
            scanned = True
            if lossless:  # Ss is the predictor, Al the point transform
                if not 1 <= ss <= 7 or se != 0 or ah != 0 or al >= 8:
                    raise _jpeg_refused("bad lossless parameters")
                pos = native.jpeg_decode_lossless(
                    data, pos, [r[0] for r in rows], [planes[i] for i in sel],
                    huff_bits, huff_vals, restart, ss, al)
                continue
            prog = None
            if progressive:  # libjpeg's checks of the scan's band
                if (se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1)) \
                        or (ah != 0 and al != ah - 1) or al > 13:
                    raise _jpeg_refused("bad progression")
                prog = (ss, se, ah, al)
            if arith is not None:
                pos = native.jpeg_decode_arith_scan(
                    data, pos, np.asarray(rows, np.int32),
                    [planes[i] for i in sel], arith, frame[4], frame[5],
                    restart, prog)
                continue
            pos = native.jpeg_decode_scan(
                data, pos, np.asarray(rows, np.int32), [planes[i] for i in sel],
                huff_bits, huff_vals, frame[4], frame[5], restart, prog)
    if frame is None:
        raise ValueError("JPEG without a frame header")
    H, W, hmax, vmax = frame[:4]
    if lossless:
        if any(ci not in latched for ci in range(len(comps))):
            raise ValueError("a lossless JPEG component without a scan: PIL "
                             "(libjpeg-turbo) refuses it too")
        return _lossless_rgb(planes, latched, jfif, adobe)
    out = []
    for ci, c in enumerate(comps):
        # a component no scan named latched no table: libjpeg's zeroed
        # multipliers make it flat mid-grey
        q = latched.get(ci, np.zeros(64, np.int64))
        blocks = _idct_islow(planes[ci], q)                 # [bh, bw, 8, 8]
        px = blocks.transpose(0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        up = _upsample(px, c["h_px"], c["w"], vmax // c["v"], hmax // c["h"])
        out.append(up[:H, :W])
    if len(comps) == 1:
        return np.repeat(out[0][..., None].astype(np.uint8), 3, axis=-1)
    ids = [c["id"] for c in comps]
    # libjpeg's colour space (jdapimin.c default_decompress_parms)
    if len(comps) == 3:
        rgb = (not jfif and adobe == 0) or (not jfif and adobe is None
                                              and ids == [82, 71, 66])
        if rgb:
            return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)
        return _ycc_to_rgb(*out)
    if adobe is not None and adobe != 0:  # YCCK: ink = the YCbCr colour
        ink = _ycc_to_rgb(*out[:3])
    else:                                 # CMYK
        ink = 255 - np.stack(out[:3], -1).astype(np.int64)
    return _cmyk_to_rgb(ink, out[3][..., None])


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
            raise ValueError(f"Radiance {line.decode()}: OpenCV (the JAX "
                             "package's reader) refuses it too")
        if not line and end > 0:
            break
    end = data.index(b"\n", pos)
    dims = data[pos:end].split()
    pos = end + 1
    if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(
            f"Radiance orientation {b' '.join(dims).decode()!r}: OpenCV "
            "(the JAX package's reader) refuses it too; only '-Y H +X W' "
            "is decoded")
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
        raise _not_ported("decoding tiled OpenEXR files", "7d")
    if version & 0x1800:
        raise _not_ported("decoding deep or multi-part OpenEXR files", "7d")
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
            raise _not_ported(f"decoding OpenEXR channel '{name}' of pixel "
                              f"type {ptype} (only HALF and FLOAT are)", "7d")
        if (xs, ys) != (1, 1):
            raise _not_ported("decoding sub-sampled OpenEXR channels", "7d")
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
        raise _not_ported(f"decoding OpenEXR compression {comp} (only NONE, "
                          "ZIPS and ZIP are)", "7d")
    chans = _exr_channels(attrs["channels"][1])
    names = [c for c, _ in chans]
    if set(names) - {"A"} == {"R", "G", "B"}:
        pick = ("R", "G", "B")
    elif set(names) - {"A"} == {"Y"}:
        pick = ("Y", "Y", "Y")
    else:
        raise _not_ported(f"decoding OpenEXR channels {names} (only R, G, B "
                          "or Y, and A, are)", "7d")
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
