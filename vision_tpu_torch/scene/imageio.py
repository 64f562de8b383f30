"""Image files without PIL, OpenCV or OpenEXR: the standard library's zlib
and struct, numpy, and the port's host library (`native.py`) for the
serial stages: JPEG's entropy decoding (`csrc/jpeg_huff.cpp`), OpenEXR's
Huffman and run-length coding, LZW and PackBits
(`csrc/image_codecs.cpp`), WebP's bitstreams (`csrc/webp_codec.cpp`, its
container in `webp.py`).

The JAX package (`vision_tpu/scene/texture.py` `load_image`) picks its
reader by the file's extension: ".hdr" and ".exr" through OpenCV
(`cv2.imread`, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH), every other name
through PIL (`Image.open(p).convert("RGB")`). `read_image` picks the same
way (ROADMAP C20) and, by the file's content, decodes what that library
gives for the files a scene names, and refuses, with ValueError, what it
refuses:

  * PNG (`read_png`): every colour type at every bit depth PNG defines,
    Adam7-interlaced or not, every filter type, any number of IDAT chunks.
    The result is `PIL.Image.open(p).convert("RGB")`: alpha dropped (not
    composited), a palette expanded, 1/2/4-bit grey scaled up, 16-bit grey
    clipped at 255 and other 16-bit samples cut to their high byte
    (OpenCV, under a .hdr / .exr name, keeps 16-bit samples whole).
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
    queue A, 7e; 12-bit, hierarchical and fractionally sampled ones are
    refused.
  * BMP (`read_bmp`) and TGA (`read_tga`): as PIL's plugins read them
    (their docstrings list the variants), quirks included.
  * TIFF (`read_tiff`) and GIF (`read_gif`): as PIL (libtiff for
    compressed TIFF) reads page / frame 0; their docstrings list the
    variants and the quirks copied.
  * WebP (`webp.decode`): lossless (VP8L) and lossy (VP8) images, alpha
    (VP8L's own or an ALPH chunk, dropped), extended (VP8X) files and frame
    0 of an animation on its canvas, as PIL decodes them through libwebp's
    WebPAnimDecoder; what its demuxer or decoder refuses raises ValueError.
  * Radiance .hdr (`read_hdr`): the `#?RADIANCE` / `#?RGBE` header, the
    `-Y H +X W` orientation (OpenCV refuses the others, and so does this
    module), new-style run-length and flat scanlines, decoded as OpenCV
    decodes them: m * 2^(e - 136), no +0.5, e = 0 is 0; RGB order.
  * OpenEXR (`read_exr`): as OpenCV 4.6.0's EXR decoder gives them
    (ROADMAP C22): read as Imf::InputFile reads them (scanline and tiled
    files, level (0, 0); part 0 of a multi-part file; deep scanlines with Z
    and A, composited; every compression, DWA blocks of version 1 and 2,
    perceptually linear channels; HALF, FLOAT and UINT channels,
    sub-sampled ones included), then converted by OpenCV's rules: R, G, B
    (missing ones 0), or luminance-chroma converted, or Y replicated.
  * Under a .hdr / .exr name, OpenCV's own BMP, Sun raster, PNM, PFM and
    PAM readers and its CMYK / YCCK JPEG conversion (`cvread.py`).
  * `write_exr`: a single-part scanline OpenEXR of uncompressed FLOAT B, G,
    R channels.

The rarer TIFF codecs, OpenCV's TIFF, GIF, JPEG 2000 and AVIF readers
under a .hdr / .exr name, and the other formats PIL opens (AVIF among
them) raise NotImplementedError naming ROADMAP queue A, 7e.
"""
from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np

from .. import native
from . import cvread, webp

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
EXR_MAGIC = 20000630


def _not_ported(what, slice_):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP queue A, slice {slice_}")


# magic numbers of the formats PIL opens that this module does not decode
# (checked before TGA, which has none: an icon's header would pass for one,
# and a TGA's header can read as an icon directory of 0 entries)
_OTHER_FORMATS = ((b"II+\0", "BigTIFF"), (b"MM\0+", "BigTIFF"),
                  (b"\0\0\1\0", "ICO"), (b"\0\0\2\0", "CUR"),
                  (b"8BPS", "PSD"), (b"DDS ", "DDS"), (b"qoif", "QOI"),
                  (b"icns", "ICNS"), (b"\0\0\0\x0cjP  ", "JPEG 2000"),
                  (b"\xffO\xffQ", "JPEG 2000"))


def _other_format(data):
    name = next((name for magic, name in _OTHER_FORMATS
                 if data.startswith(magic)), None)
    if name in ("ICO", "CUR") and data[4:6] == b"\0\0":
        return None  # no icons: PIL's plugins pass it on (a TGA's header)
    return name


def read_image(path):
    """Decode `path` as the JAX package's `load_image` does, picking the
    library by the lowercased extension: (array, kind). ".hdr" and ".exr"
    follow OpenCV (`_read_opencv`): kind "hdr", float32 [H, W, 3] RGB
    taken as the samples are (no /255). Every other name follows PIL
    (`_read_pil`): kind "ldr", uint8 [H, W, 3] RGB. Raises
    FileNotFoundError for a missing file, NotImplementedError for a
    format or a variant this module does not decode, ValueError for a
    corrupt file or one the reference's library refuses too."""
    with open(path, "rb") as f:
        data = f.read()
    name = os.path.basename(path)
    if os.path.splitext(path)[1].lower() in (".hdr", ".exr"):
        return _read_opencv(data, name), "hdr"
    return _read_pil(data, name), "ldr"


def _is_exr(data):
    return len(data) >= 4 and struct.unpack("<i", data[:4])[0] == EXR_MAGIC


def _read_pil(data, name):
    """What `PIL.Image.open(p).convert("RGB")` gives, by the file's
    content. TGA, which has no magic number, is tried last, with PIL's
    header checks. Radiance and OpenEXR files, which PIL cannot identify,
    raise ValueError."""
    if data[:8] == PNG_SIGNATURE:
        return read_png(data)
    if data[:3] == b"\xff\xd8\xff":
        return read_jpeg(data)
    if data[:2] == b"BM":
        return read_bmp(data)
    if data[:4] in (b"II*\0", b"MM\0*"):
        return read_tiff(data)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return read_gif(data)
    if webp.is_webp(data):
        return webp.decode(data, name)[0]
    if data[:2] == b"#?" or _is_exr(data):
        raise ValueError(f"'{name}': a Radiance or OpenEXR file under "
                         "another name: PIL (the JAX package's reader for "
                         "it) cannot identify it either")
    other = "AVIF" if _is_avif(data) else _other_format(data)
    if other is not None:
        raise _not_ported(f"'{name}': decoding {other} files", "7e")
    if _tga_header(data) is not None:
        return read_tga(data)
    raise NotImplementedError(
        f"'{name}': not a PNG, JPEG, BMP, TGA, TIFF or GIF file: other "
        "formats (ICO, PSD, ...) are ROADMAP queue A, 7e")


# magic numbers of the formats OpenCV's own readers take that this module
# does not decode under a .hdr / .exr name (ROADMAP 7e.3b)
_OPENCV_OTHER = ((b"II*\0", "TIFF"), (b"MM\0*", "TIFF"),
                 (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
                 (b"\0\0\0\x0cjP  ", "JPEG 2000"), (b"\xffO\xffQ", "JPEG 2000"))


def _is_avif(data):
    """An ISO-BMFF file whose `ftyp` box names AVIF (`avif` / `avis`)."""
    return data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis")


def _from_cv(img):
    """An OpenCV image ([H, W] or [H, W, 3] B, G, R) -> what the JAX
    package's loader makes of it: float32 [H, W, 3] R, G, B."""
    img = img.astype(np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return np.ascontiguousarray(img[..., ::-1])


def _read_opencv(data, name):
    """What the JAX package's `cv2.imread(p, IMREAD_ANYCOLOR |
    IMREAD_ANYDEPTH)` path gives for a .hdr / .exr name, by the file's
    content: float32 [H, W, 3] RGB with no /255. Radiance and OpenEXR as
    `read_hdr` / `read_exr`; a PNG as PIL decodes it, but 16-bit samples
    whole; a grey, YCbCr or RGB JPEG as PIL decodes it (OpenCV's
    libjpeg-turbo gives the same samples), a CMYK or YCCK one through
    OpenCV's own conversion; a WebP file as OpenCV's libwebp decodes it
    (`webp.decode_opencv`); BMP, Sun raster, PNM, PFM and PAM files by
    OpenCV's own readers (`cvread`). OpenCV's TIFF, GIF, JPEG 2000 and
    AVIF readers raise NotImplementedError (7e); content OpenCV cannot
    read raises ValueError."""
    if data[:2] == b"#?":
        return read_hdr(data)
    if _is_exr(data):
        return read_exr(data)
    if data[:8] == PNG_SIGNATURE:
        return read_png(data, full_depth=True).astype(np.float32)
    if data[:3] == b"\xff\xd8\xff":
        if len(_jpeg_sampling(data)) == 4:
            return _from_cv(cvread.cmyk_to_bgr(read_jpeg(data, cmyk=True)))
        return read_jpeg(data).astype(np.float32)
    if webp.is_webp(data):
        return webp.decode_opencv(data, name)[0].astype(np.float32)
    if data[:2] == b"BM":
        return _from_cv(cvread.read_bmp_cv(data))
    if data[:4] == cvread.SUNRAS_MAGIC:
        return _from_cv(cvread.read_sunras(data))
    if len(data) > 2 and data[0] == ord("P") and data[2] in b" \t\n\v\f\r":
        if data[1] in b"123456":
            return _from_cv(cvread.read_pnm(data))
        if data[1] in b"fF":
            return _from_cv(cvread.read_pfm(data))
        if data[1] == ord("7"):
            return _from_cv(cvread.read_pam(data))
    other = next((n for magic, n in _OPENCV_OTHER if data.startswith(magic)),
                 "AVIF" if _is_avif(data) else None)
    if other is not None:
        raise _not_ported(f"'{name}': decoding {other} files as OpenCV does",
                          "7e")
    raise ValueError(f"'{name}': not a format OpenCV (the JAX package's "
                     "reader for .hdr / .exr names) reads")


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


def read_png(data, full_depth=False):
    """PNG bytes -> uint8 [H, W, 3], as PIL's convert("RGB") gives them:
    alpha dropped (not composited), a palette expanded (missing entries
    black), 1/2/4-bit grey scaled to 0..255, 16-bit grey clipped at 255
    (PIL's I;16 -> RGB), other 16-bit samples cut to their high byte.
    Adam7 files are de-interlaced. A colour type and bit depth that PNG
    does not define is refused, as PIL refuses it (ValueError).
    full_depth: a 16-bit file's samples whole (uint16, grey replicated),
    as OpenCV's IMREAD_ANYDEPTH gives them."""
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
    if depth == 16 and full_depth:
        rgb = np.repeat(v[..., :1], 3, -1) if ctype in (0, 4) else v[..., :3]
        return np.ascontiguousarray(rgb).astype(np.uint16)
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


def _lossless_rgb(planes, pt, jfif, adobe, cmyk=False):
    """A lossless file's samples -> RGB as PIL gets them: each sample
    shifted back by its point transform into 8 bits; grey, RGB or CMYK
    (libjpeg converts no colour in lossless mode and refuses to: a YCbCr or
    YCCK file is refused). `cmyk`: a CMYK file's 4 samples as they are."""
    out = [((p.astype(np.int64) << pt[ci]) & 0xFF).astype(np.uint8)
           for ci, p in enumerate(planes)]
    if cmyk and len(out) == 4 and not (adobe is not None and adobe != 0):
        return np.stack(out, -1)
    if len(out) == 1:
        return np.repeat(out[0][..., None], 3, axis=-1)
    if (jfif and len(out) == 3) or (adobe is not None and adobe != 0):
        raise _jpeg_refused("lossless YCbCr or YCCK")
    if len(out) == 3:   # libjpeg takes lossless 3-component files as RGB
        return np.stack(out, -1)
    return _cmyk_to_rgb(255 - np.stack(out[:3], -1).astype(np.int64),
                        out[3][..., None])


def _jpeg_sampling(data):
    """The (h, v) sampling factors of each component of a JPEG's frame
    header ([] if none is found)."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return []
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if 0xD0 <= marker <= 0xD9 or marker == 0x01:
            pos += 2
            continue
        n, = struct.unpack(">H", data[pos + 2:pos + 4])
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            nc = data[pos + 9] if pos + 9 < len(data) else 0
            f = data[pos + 10:pos + 10 + 3 * nc]
            return [(f[3 * k + 1] >> 4, f[3 * k + 1] & 15)
                    for k in range(len(f) // 3)]
        pos += 2 + n
    return []


def read_jpeg(data, force_ycc=False, cmyk=False):
    """JPEG bytes -> uint8 [H, W, 3], as PIL's convert("RGB") gives them:
    sequential and progressive files of 8-bit samples, Huffman- or
    arithmetic-coded (DAC conditioning), and lossless Huffman files (1x1
    sampling); grey, YCbCr, RGB, CMYK and YCCK, the colour space chosen as
    libjpeg chooses it (JFIF, the Adobe APP14 transform, the component
    ids); PIL's CMYK -> RGB. Raises NotImplementedError (7e) for
    arithmetic-coded lossless and subsampled lossless files; ValueError
    for what PIL
    refuses too (12- and 16-bit samples, 2 or more than 4 components,
    hierarchical coding, fractional sampling, lossless YCbCr) and for a
    corrupt file. `cmyk`: a 4-component file's samples as libjpeg gives
    them for JCS_CMYK (uint8 [H, W, 4]; a YCCK file converted to CMYK)."""
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
                                  "files", "7e")
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
                                  "7e")
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
        return _lossless_rgb(planes, latched, jfif, adobe, cmyk)
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
        rgb = not force_ycc and ((not jfif and adobe == 0) or (
            not jfif and adobe is None and ids == [82, 71, 66]))
        if rgb:
            return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)
        return _ycc_to_rgb(*out)
    if adobe is not None and adobe != 0:  # YCCK: ink = the YCbCr colour
        ink = _ycc_to_rgb(*out[:3])
    else:                                 # CMYK
        ink = 255 - np.stack(out[:3], -1).astype(np.int64)
    if cmyk:    # the samples libjpeg gives for JCS_CMYK (ycck_cmyk_convert)
        return np.concatenate([255 - ink, out[3][..., None]], -1).astype(
            np.uint8)
    return _cmyk_to_rgb(ink, out[3][..., None])


# zig-zag position k -> natural (row-major) index
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


# ---------------------------------------------------------------------------
# TIFF (as PIL's TiffImagePlugin and libtiff read it)
# ---------------------------------------------------------------------------

# the compressions decoded here (none, LZW, JPEG, Deflate twice, PackBits),
# and those left for 7e
_TIFF_CODECS = (1, 5, 7, 8, 32946, 32773)
_TIFF_LATER = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
               6: "old-style JPEG", 32771: "raw 16", 32809: "ThunderScan",
               34676: "SGILog", 34677: "SGILog24", 34925: "LZMA",
               50000: "ZSTD", 50001: "WebP"}
_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B",
               8: "h", 9: "i", 10: "ii", 11: "f", 12: "d", 16: "Q", 17: "q"}


def _pil_bomb_check(w, h):
    """PIL refuses an image of more than twice its MAX_IMAGE_PIXELS
    (89,478,485) pixels as a decompression bomb."""
    if w * h > 2 * 89478485:
        raise ValueError(f"an image of {w} x {h} pixels: PIL refuses it as "
                         "a decompression bomb")


def _tiff_refused(what):
    return ValueError(f"TIFF {what} (PIL refuses it too)")


def _tiff_ifd(data, bo):
    """IFD 0 -> {tag: tuple of values}."""
    try:
        pos, = struct.unpack(bo + "I", data[4:8])
        n, = struct.unpack(bo + "H", data[pos:pos + 2])
        tags = {}
        for k in range(n):
            e = pos + 2 + 12 * k
            tag, typ, count = struct.unpack(bo + "HHI", data[e:e + 8])
            fmt = _TIFF_TYPES.get(typ)
            if fmt is None or count == 0:
                continue
            size = struct.calcsize(bo + fmt) * count
            at = e + 8 if size <= 4 else struct.unpack(bo + "I",
                                                       data[e + 8:e + 12])[0]
            if at + size > len(data):
                raise _tiff_refused("with a tag past the end of the file")
            v = struct.unpack(bo + fmt * count, data[at:at + size])
            if typ in (5, 10):
                v = tuple(v[i] / v[i + 1] if v[i + 1] else 0.0
                          for i in range(0, len(v), 2))
            tags[tag] = v if typ != 7 else data[at:at + size]
        return tags
    except struct.error:
        raise ValueError("truncated TIFF directory") from None


def _tiff_layout(tags):
    """PIL's choice of mode from the tags (TiffImagePlugin._setup): the
    photometric, sample format, fill order, bits and extra samples ->
    (photometric, bits tuple, sample format, extra samples). Raises where
    PIL finds no mode."""
    photo = tags.get(262, (0,))[0]
    comp = tags.get(259, (1,))[0]
    spp = tags.get(277, (3 if comp == 6 and photo in (2, 6) else 1,))[0]
    sf = tags.get(339, (1,))
    if len(sf) > 1 and max(sf) == min(sf) == 1:
        sf = (1,)
    bps = tags.get(258, (1,))
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise _tiff_refused("of an unknown data organization")
    return photo, tuple(bps), tuple(sf), tuple(tags.get(338, ()))


def _tiff_mode(bo, photo, sf, fill, bps, extra):
    """The subset of PIL's OPEN_INFO decoded here: (kind, bits) or None
    where PIL has no mode. kind: "grey" (inverted for photometric 0),
    "u16" (clipped at 255), "s16" / "s32" / "u32" (clipped to 0..255, the
    last read as signed), "float" (truncated, clipped), "la", "rgb",
    "rgba" (extra samples dropped), "rgba_assoc" (alpha undone), "rgb16"
    (high bytes), "pal", "cmyk", "cmyk16", "ycbcr"."""
    n = len(bps)
    b0 = bps[0]
    if any(b != b0 for b in bps):
        return None
    if fill == 2 and not ((photo in (0, 1, 3) and n == 1 and b0 <= 8
                           and sf == (1,))
                          or (photo == 2 and bps == (8, 8, 8) and not extra
                              and sf == (1,))
                          or (bo == "<" and photo == 1 and bps == (16,)
                              and sf == (1,))):
        return None
    if n == 1 and not extra:
        if photo in (0, 1) and sf == (1,) and b0 in (1, 2, 4, 8):
            return "grey", b0
        if photo == 1 and sf == (2,) and b0 == 8:
            return "grey", 8
        if b0 == 16 and sf == (1,) and (photo == 1 or (photo == 0
                                                      and bo == "<")):
            return "u16", 16
        if b0 == 16 and sf == (2,) and photo == 1:
            return "s16", 16
        if b0 == 32 and sf == (3,) and photo in (0, 1):
            return "float", 32
        if b0 == 32 and sf == (1,) and photo == 1 and bo == "<":
            return "u32", 32
        if b0 == 32 and sf == (2,) and photo == 1:
            return "s32", 32
        if photo == 3 and sf == (1,) and b0 in (1, 2, 4, 8):
            return "pal", b0
        if photo == 6 and sf == (1,) and b0 == 8:
            return "grey", 8
        return None
    if sf != (1,):
        return None
    if photo == 1 and bps == (8, 8) and extra == (2,):
        return "la", 8
    if photo == 3 and bps == (8, 8) and extra in ((0,), (2,)):
        return "pal", 8
    if photo == 2 and b0 in (8, 16):
        if n == 3 and not extra:
            return ("rgb" if b0 == 8 else "rgb16"), b0
        if n == 4 and not extra:
            return ("rgba" if b0 == 8 else "rgb16"), b0
        if b0 == 8 and n in (4, 5, 6) and len(extra) == n - 3 and \
                extra[1:] == (0,) * (n - 4) and extra[0] in (0, 1, 2):
            return ("rgba_assoc" if extra[0] == 1 else "rgba"), 8
        if b0 == 8 and n == 4 and extra == (999,):
            return "rgba", 8
        if b0 == 16 and n == 4 and extra in ((0,), (2,)):
            return "rgb16", 16
        if b0 == 16 and n == 4 and extra == (1,):
            return "rgba_assoc16", 16
        return None
    if photo == 5 and b0 == 8 and (n, extra) in ((4, ()), (5, (0,)),
                                                 (6, (0, 0))):
        return "cmyk", 8
    if photo == 5 and bps == (16,) * 4 and not extra:
        return "cmyk16", 16
    if photo == 6 and bps == (8, 8, 8) and not extra:
        return "ycbcr", 8
    return None


_BIT_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                        np.uint8)


def _tiff_chunk(data, comp, off, count, n_bytes, fill):
    """One strip or tile -> its decoded bytes (at most n_bytes), as
    libtiff gives them. A chunk that decodes short raises ValueError, as
    libtiff stops there."""
    # PIL reads an uncompressed chunk itself, from its offset, whatever
    # its byte count says; libtiff reads a compressed one's count
    raw = data[off:off + (n_bytes if comp == 1 else count)]
    if fill == 2:
        raw = _BIT_REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
    if comp == 1:
        out = raw
    elif comp == 5:
        msb = not (len(raw) >= 2 and raw[0] == 0 and raw[1] & 1)
        out = native.lzw_decode(raw, n_bytes, 8, msb).tobytes()
    elif comp in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, n_bytes)
        except zlib.error:
            raise _tiff_refused("Deflate data that is corrupt") from None
    elif comp == 32773:
        out = native.packbits_decode(raw, n_bytes).tobytes()
    else:
        raise AssertionError(comp)
    if len(out) < n_bytes:
        raise _tiff_refused("chunk that ends before its pixels")
    return out[:n_bytes]


def _tiff_samples(buf, rows, width, spp, bits, bo):
    """Decoded bytes of `rows` rows -> samples [rows, width, spp] (numbers
    in their type; sub-byte samples unpacked, each row padded to a
    byte)."""
    if bits < 8:
        stride = -(-width * spp * bits // 8)
        b = np.unpackbits(np.frombuffer(buf, np.uint8)[:rows * stride]
                          .reshape(rows, stride), axis=1)[:, :width * spp * bits]
        v = b.reshape(rows, width * spp, bits).astype(np.int64)
        v = (v << np.arange(bits - 1, -1, -1)).sum(-1)
        return v.reshape(rows, width, spp)
    dt = {8: "u1", 16: "u2", 32: "u4"}[bits]
    v = np.frombuffer(buf, bo + dt, rows * width * spp)
    return v.reshape(rows, width, spp).astype(np.int64)


def _undo_predictor(v, bits):
    """libtiff's horizontal predictor on one chunk's samples [rows, width,
    spp]: each sample the sum of the differences before it in its row
    (mod 2^bits)."""
    if bits < 8:
        raise _tiff_refused(f"horizontal predictor at {bits} bits")
    return np.cumsum(v, axis=1) & ((1 << bits) - 1)


def _tiff_fp_predictor(buf, rows, width, spp, nb):
    """libtiff's floating-point predictor on one chunk's bytes: each row's
    bytes summed with a stride of spp (mod 256), then read as nb byte
    planes, most significant first -> big-endian sample bytes."""
    b = np.frombuffer(buf, np.uint8)[:rows * width * spp * nb].reshape(
        rows, width * nb, spp).astype(np.int64)
    b = (np.cumsum(b, axis=1) & 0xFF).astype(np.uint8).reshape(rows, -1)
    planes = b.reshape(rows, nb, width * spp)
    return np.ascontiguousarray(planes.transpose(0, 2, 1)).tobytes()


def read_tiff(data):
    """TIFF bytes -> uint8 [H, W, 3], as PIL's convert("RGB") gives them
    (PIL reads compressed files through libtiff): page 0, orientation not
    applied; classic TIFF in either byte order, strips or tiles, chunky or
    planar; no compression, PackBits, LZW (old-style too), Deflate and
    JPEG (with JPEGTables; YCbCr decoded to RGB as libtiff's JPEG colour
    mode asks); predictors 1, 2 and 3; 1-, 2-, 4-, 8- and 16-bit integer
    and 32-bit integer and float samples; min-is-white / min-is-black,
    RGB(A) with extra samples (associated alpha undone as PIL does),
    palette, CMYK; fill order 2. 16-bit samples reach 8 bits as PIL's
    modes take them (grey clipped at 255, colour cut to the high byte),
    floats truncated and clipped. What PIL has no mode for raises
    ValueError; other compressions and BigTIFF raise NotImplementedError
    naming ROADMAP queue A, 7e."""
    bo = {b"II*\0": "<", b"MM\0*": ">"}.get(data[:4])
    if bo is None:
        raise ValueError("not a TIFF file")
    tags = _tiff_ifd(data, bo)
    comp = tags.get(259, (1,))[0]
    if comp in _TIFF_LATER:
        raise _not_ported(f"decoding {_TIFF_LATER[comp]} TIFF files", "7e")
    if comp not in _TIFF_CODECS:
        raise _tiff_refused(f"compression {comp}")
    try:
        w, h = tags[256][0], tags[257][0]
    except KeyError:
        raise _tiff_refused("without its dimensions") from None
    _pil_bomb_check(w, h)
    photo, bps, sf, extra = _tiff_layout(tags)
    fill = tags.get(266, (1,))[0]
    mode = _tiff_mode(bo, photo, sf, fill, bps, extra)
    if mode is None:
        raise _tiff_refused(f"of photometric {photo}, bits {bps}, sample "
                            f"format {sf}, extra samples {extra}")
    kind, bits = mode
    spp = len(bps)
    planar = tags.get(284, (1,))[0] == 2
    # libtiff runs the predictor in its LZW and Deflate codecs only
    pred = tags.get(317, (1,))[0] if comp in (5, 8, 32946) else 1
    if comp == 7 and kind not in ("ycbcr", "rgb", "grey"):
        raise _not_ported("decoding JPEG TIFF files other than grey, RGB "
                          "and YCbCr", "7e")
    if kind == "ycbcr" and comp != 7:
        raise _not_ported("decoding YCbCr TIFF files that are not JPEG",
                          "7e")
    if planar and (comp == 7 or (comp == 1 and bits > 8)):
        raise _not_ported("decoding planar JPEG TIFF files, and planar "
                          "uncompressed ones of more than 8 bits", "7e")
    # PIL's planar unpackers: one band's raw mode each, none for padding
    # (X) and, reading without libtiff, none for associated alpha or LA's
    if planar and (extra == (0,) or (comp == 1 and (
            extra == (1,) or kind == "la"))):
        raise _tiff_refused("planar file of this band layout")
    if comp == 1 and fill == 2 and kind == "pal" and bits == 4:
        raise _tiff_refused("4-bit palette file of fill order 2")
    if pred == 3 and not (kind == "float" and comp != 7):
        raise _tiff_refused("floating-point predictor on integer samples")
    if 322 in tags:
        tw, th = tags[322][0], tags.get(323, (0,))[0]
        offsets, counts = tags.get(324, ()), tags.get(325, ())
    else:
        tw, th = w, tags.get(278, (h,))[0]
        th = min(th, h) if th else h
        offsets, counts = tags.get(273, ()), tags.get(279, ())
    if not offsets or len(counts) != len(offsets) or tw <= 0 or th <= 0:
        raise _tiff_refused("of an unknown data organization")
    ntx, nty = -(-w // tw), -(-h // th)
    nplanes = spp if planar else 1
    cs = 1 if planar else spp                 # samples in a chunk's pixel
    if len(offsets) < ntx * nty * nplanes:
        raise _tiff_refused("with fewer chunks than its size needs")
    tables = tags.get(347, b"")
    dt = {"float": "f4", "s32": "i4", "u32": "i4"}.get(kind)
    out = np.zeros((h, w, spp), np.float64 if kind == "float" else np.int64)
    k = 0
    for plane in range(nplanes):
        for ty in range(nty):
            for tx in range(ntx):
                y0, x0 = ty * th, tx * tw
                rows = th if 322 in tags else min(th, h - y0)
                n_bytes = rows * (-(-tw * cs * bits // 8))
                off, count = offsets[k], counts[k]
                k += 1
                if comp == 7:
                    v = _tiff_jpeg(data[off:off + count], tables, kind, tags)
                    v = v[:rows, :tw, :cs].astype(np.int64)
                else:
                    buf = _tiff_chunk(data, comp, off, count, n_bytes, fill)
                    if pred == 3:
                        buf = _tiff_fp_predictor(buf, rows, tw, cs, bits // 8)
                        bo_chunk = ">"
                    else:
                        bo_chunk = bo
                    if kind == "float" or bits == 32:
                        v = np.frombuffer(buf, bo_chunk + dt,
                                          rows * tw * cs).reshape(rows, tw, cs)
                        if pred == 2:
                            v = _undo_predictor(v.view(bo_chunk + "u4").astype(
                                np.int64), 32).astype("u4").view(dt)
                        if bo == ">" and comp != 1:
                            # libtiff hands PIL native (little-endian)
                            # words, which PIL's big-endian raw mode reads
                            # swapped
                            v = v.astype(dt).byteswap()
                        with np.errstate(invalid="ignore"):
                            v = v.astype(np.float64 if kind == "float"
                                         else np.int64)
                    else:
                        v = _tiff_samples(buf, rows, tw, cs, bits, bo_chunk)
                        if pred == 2:
                            v = _undo_predictor(v, bits)
                        if kind == "s16" and bo == ">" and comp != 1:
                            # PIL's big-endian signed raw mode reads
                            # libtiff's native words swapped, as above
                            v = (v & 0xFF) << 8 | v >> 8
                ye, xe = min(h, y0 + rows), min(w, x0 + tw)
                sl = slice(plane, plane + 1) if planar else slice(None)
                out[y0:ye, x0:xe, sl] = v[:ye - y0, :xe - x0]
    return _tiff_to_rgb(out, kind, bits, photo, tags)


def _tiff_jpeg(strip, tables, kind, tags):
    """A JPEG-compressed strip or tile -> int samples [rows, cols, 3]: the
    JPEGTables' segments before the strip's own; a YCbCr file's colour
    converted to RGB (libtiff's JPEGCOLORMODE_RGB, as PIL asks)."""
    if tables[:2] == b"\xff\xd8" and strip[:2] == b"\xff\xd8":
        end = tables.rfind(b"\xff\xd9")
        strip = tables[:end if end > 0 else len(tables)] + strip[2:]
    if kind == "ycbcr":
        sub = tuple(tags.get(530, (2, 2))[:2])
        got = _jpeg_sampling(strip)[:1]
        if got != [sub]:
            raise _tiff_refused(f"JPEG data sampled {got} under "
                                f"YCbCrSubsampling {sub} (libtiff)")
    try:
        return read_jpeg(strip, force_ycc=kind == "ycbcr")
    except (struct.error, IndexError):
        raise _tiff_refused("JPEG data that is corrupt") from None


def _tiff_to_rgb(v, kind, bits, photo, tags):
    """Samples [H, W, spp] -> uint8 RGB, as PIL's mode and convert("RGB")
    take them."""
    if kind == "grey":
        g = v[..., 0]
        if photo == 0:
            g = (1 << bits) - 1 - g
        g = g * (255 // ((1 << bits) - 1)) if bits < 8 else g
        return np.repeat(g[..., None], 3, -1).astype(np.uint8)
    if kind == "u16":
        return np.repeat(np.minimum(v[..., :1], 255), 3, -1).astype(np.uint8)
    if kind in ("s16", "s32", "u32"):
        x = v[..., :1]
        if kind == "s16":
            x = (x ^ 0x8000) - 0x8000
        return np.repeat(np.clip(x, 0, 255), 3, -1).astype(np.uint8)
    if kind == "float":
        f = v[..., :1]
        with np.errstate(invalid="ignore"):
            g = np.where(f >= 255, 255, np.where(f > 0, np.trunc(
                np.nan_to_num(f)), 0))
        return np.repeat(g, 3, -1).astype(np.uint8)
    if kind == "la":
        return np.repeat(v[..., :1], 3, -1).astype(np.uint8)
    if kind in ("rgb", "rgba", "ycbcr"):
        return v[..., :3].astype(np.uint8)
    if kind == "rgb16":
        return (v[..., :3] >> 8).astype(np.uint8)
    if kind in ("rgba_assoc", "rgba_assoc16"):
        if kind == "rgba_assoc16":
            v = v >> 8
        a = v[..., 3:4]
        rgb = np.where(a == 0, 0, np.minimum(
            v[..., :3] * 255 // np.maximum(a, 1), 255))
        return np.where(a == 255, v[..., :3], rgb).astype(np.uint8)
    if kind == "pal":
        cmap = np.asarray(tags.get(320, ()), np.int64)
        pal = np.zeros((256, 3), np.uint8)
        if len(cmap):
            n = len(cmap) // 3
            pal[:min(n, 256)] = (cmap.reshape(3, n).T // 256)[:256]
        return pal[v[..., 0]]
    if kind in ("cmyk", "cmyk16"):
        if kind == "cmyk16":
            v = v >> 8
        return _cmyk_to_rgb(v[..., :3], 255 - v[..., 3:4])
    raise AssertionError(kind)


# ---------------------------------------------------------------------------
# GIF (as PIL's GifImagePlugin reads frame 0)
# ---------------------------------------------------------------------------

def _gif_blocks(data, pos):
    """Data sub-blocks from `pos` -> (their bytes, the offset after the
    terminator, whether the terminator was found)."""
    out = bytearray()
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            return bytes(out), pos, True
        out += data[pos:pos + n]
        pos += n
    return bytes(out), pos, False


def read_gif(data):
    """GIF bytes -> uint8 [H, W, 3], frame 0 as PIL's convert("RGB") gives
    it: the local colour table, else the global one (indices past it
    black; no table: the index as grey), interlaced rows, LZW minimum code
    sizes 2-8 (least significant bit first, `csrc/image_codecs.cpp`); a
    transparent index keeps its palette colour, and is the colour of the
    screen outside the frame (else index 0). Data that ends before the
    frame's pixels is refused, as PIL refuses it (ValueError)."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("not a GIF file")
    sw, sh, flags = struct.unpack("<HHB", data[6:11])
    pos = 13
    pal = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        pal = np.frombuffer(data[pos:pos + n], np.uint8)
        pos += n
    trans = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("GIF without an image: PIL refuses it too")
        c = data[pos]
        pos += 1
        if c == 0x21:                            # an extension
            label = data[pos] if pos < len(data) else 0
            body, pos, _ = _gif_blocks(data, pos + 1)
            if label == 0xF9 and len(body) >= 4 and body[0] & 1:
                trans = body[3]
        elif c == 0x2C:                          # the image descriptor
            if pos + 9 > len(data):
                raise ValueError("truncated GIF image descriptor")
            x0, y0, fw, fh, fl = struct.unpack("<HHHHB", data[pos:pos + 9])
            pos += 9
            if fl & 0x80:
                n = 3 << ((fl & 7) + 1)
                pal = np.frombuffer(data[pos:pos + n], np.uint8)
                pos += n
            break
        else:
            raise ValueError("corrupt GIF block")
    if pos >= len(data):
        raise ValueError("truncated GIF image: PIL refuses it too")
    bits = data[pos]
    if not 2 <= bits <= 8:
        raise _not_ported(f"decoding GIF LZW minimum code size {bits}", "7e")
    lzw, _, _ = _gif_blocks(data, pos + 1)
    n_px = fw * fh
    idx = native.lzw_decode(lzw, n_px, bits, msb=False)
    if len(idx) < n_px:
        raise ValueError("truncated GIF image data: PIL refuses it too")
    frame = idx.reshape(fh, fw)
    if fl & 0x40:                                # interlaced rows
        order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                np.arange(2, fh, 4), np.arange(1, fh, 2)])
        inter = np.empty_like(frame)
        inter[order] = frame
        frame = inter
    W, H = max(sw, x0 + fw), max(sh, y0 + fh)
    _pil_bomb_check(W, H)
    screen = np.full((H, W), trans if trans is not None else 0, np.uint8)
    screen[y0:y0 + fh, x0:x0 + fw] = frame
    if pal is None or all(pal[3 * i] == pal[3 * i + 1] == pal[3 * i + 2] == i
                          for i in range(len(pal) // 3)):
        return np.repeat(screen[..., None], 3, -1)   # PIL's mode L
    table = np.zeros((256, 3), np.uint8)
    table[:len(pal) // 3] = pal[:len(pal) // 3 * 3].reshape(-1, 3)[:256]
    return table[screen]


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

(_EXR_NONE, _EXR_RLE, _EXR_ZIPS, _EXR_ZIP, _EXR_PIZ, _EXR_PXR24, _EXR_B44,
 _EXR_B44A, _EXR_DWAA, _EXR_DWAB) = range(10)
_EXR_UINT, _EXR_HALF, _EXR_FLOAT = 0, 1, 2  # pixel types
_EXR_DTYPE = {_EXR_UINT: np.dtype("<u4"), _EXR_HALF: np.dtype("<f2"),
              _EXR_FLOAT: np.dtype("<f4")}
_EXR_PTYPE = {dt: t for t, dt in _EXR_DTYPE.items()}
# the scanlines of a block of each compression
_EXR_LINES = {_EXR_NONE: 1, _EXR_RLE: 1, _EXR_ZIPS: 1, _EXR_ZIP: 16,
              _EXR_PIZ: 32, _EXR_PXR24: 16, _EXR_B44: 32, _EXR_B44A: 32,
              _EXR_DWAA: 32, _EXR_DWAB: 256}


def _cstr(data, pos):
    end = data.index(b"\0", pos)
    return data[pos:end].decode("latin-1"), end + 1


def _exr_attrs(data, pos):
    """One header's attributes from `pos` -> (dict name -> (type, body),
    the offset after the header's terminating null byte)."""
    attrs = {}
    while data[pos] != 0:
        name, pos = _cstr(data, pos)
        typ, pos = _cstr(data, pos)
        size, = struct.unpack("<i", data[pos:pos + 4])
        attrs[name] = (typ, data[pos + 4:pos + 4 + size])
        pos += 4 + size
    return attrs, pos + 1


def _exr_header(data):
    """A single-part file's header -> (attributes, the offset of its chunk
    offset table)."""
    attrs, pos, _ = _exr_part0(data)
    return attrs, pos


def _exr_part0(data):
    """The header that Imf::InputFile reads -> (attributes, the offset of
    its chunk offset table, whether chunks carry a part number). A
    multi-part file gives its part 0 (its headers come one after another,
    an empty one ends them, then each part's offset table). A deep part
    that InputFile refuses (tiled, or without Z and A) raises ValueError;
    InputFile composites the others (`_exr_read_deep`)."""
    if len(data) < 8:
        raise ValueError("truncated OpenEXR file")
    magic, version = struct.unpack("<ii", data[:8])
    if magic != EXR_MAGIC:
        raise ValueError("not an OpenEXR file")
    multipart = bool(version & 0x1000)
    try:
        attrs, pos = _exr_attrs(data, 8)
        if multipart:                    # skip the other parts' headers
            while data[pos] != 0:
                pos = _exr_attrs(data, pos)[1]
            pos += 1
    except (IndexError, ValueError, struct.error):
        raise ValueError("corrupt OpenEXR header") from None
    if _exr_deep(attrs, version, multipart):
        names = set(re.findall(rb"([^\0]+)\0.{16}",
                               attrs.get("channels", ("", b""))[1], re.S))
        if attrs.get("type", ("", b""))[1].rstrip(b"\0") != b"deepscanline" \
                or not {b"A", b"Z"} <= names:
            raise ValueError("deep OpenEXR data without Z and A channels, or "
                             "tiled: Imf::InputFile (OpenCV's reader) refuses "
                             "it too")
    return attrs, pos, multipart


def _exr_deep(attrs, version, multipart):
    """Whether the part holds deep data."""
    part_type = attrs.get("type", ("", b"scanlineimage"))[1].rstrip(b"\0")
    return bool(version & 0x800 and not multipart) or \
        part_type.startswith(b"deep")


def _exr_channels(body, linear=None, sampling=None):
    """A chlist attribute -> [(name, dtype)], sorted by name as the file
    stores them; the names of the channels marked perceptually linear
    are added to the set `linear`, each channel's (x, y) sampling to the
    dict `sampling`."""
    chans, pos = [], 0
    while body[pos] != 0:
        name, pos = _cstr(body, pos)
        ptype, plinear, xs, ys = struct.unpack("<iB3xii", body[pos:pos + 16])
        pos += 16
        if ptype not in _EXR_DTYPE or xs < 1 or ys < 1:
            raise ValueError(f"OpenEXR channel '{name}': pixel type {ptype} "
                             f"or sampling ({xs}, {ys}) unknown to "
                             "libOpenEXR")
        chans.append((name, _EXR_DTYPE[ptype]))
        if plinear and linear is not None:
            linear.add(name)
        if sampling is not None:
            sampling[name] = (xs, ys)
    return chans


def _exr_geometry(chans, sampling, x, w, y, ny):
    """The layout of a block of w pixels from x and ny lines from y ->
    [(name, dtype, samples a line, the block's lines holding it)]: a
    channel sampled every xs pixels and ys lines holds the pixels and
    lines whose coordinate its sampling divides."""
    geo = []
    for c, dt in chans:
        xs, ys = sampling.get(c, (1, 1))
        nx = (x + w - 1) // xs - -(-x // xs) + 1
        rows = np.flatnonzero(np.arange(y, y + ny) % ys == 0)
        geo.append((c, dt, nx, rows))
    return geo


def _exr_size(geo, size=None):
    """The bytes of a block (`size`: bytes a sample where not its dtype's)."""
    size = size or {}
    return sum(len(rows) * nx * size.get(c, dt.itemsize)
               for c, dt, nx, rows in geo)


def _exr_split(buf, geo, ny, size=None):
    """A block's bytes, each line's channels one after another (a
    sub-sampled channel on its own lines only) -> {name: uint8 [lines,
    samples * bytes]} (`size`: bytes a sample where not its dtype's)."""
    size = size or {}
    d = np.frombuffer(buf, np.uint8)
    span = [(c, nx * size.get(c, dt.itemsize), rows) for c, dt, nx, rows in geo]
    if all(len(rows) == ny for _, _, rows in span):
        cols = np.cumsum([0] + [n for _, n, _ in span])
        d = d.reshape(ny, -1)
        return {c: d[:, a:b] for (c, _, _), a, b in zip(span, cols, cols[1:])}
    out = {c: np.empty((len(rows), n), np.uint8) for c, n, rows in span}
    at = dict.fromkeys(out, 0)
    pos = 0
    for i in range(ny):
        for c, n, rows in span:
            if i in rows:
                out[c][at[c]] = d[pos:pos + n]
                at[c] += 1
                pos += n
    return out


def _exr_unpredict(d):
    """The ZIP / RLE / DWA-DC reordering undone: the running sum
    t[i] = t[i-1] + d[i] - 128 (mod 256), then the two halves interleaved
    (the first half holds the even bytes)."""
    d = np.asarray(d, np.uint8).astype(np.int64)
    d[1:] -= 128
    t = (np.cumsum(d) & 0xFF).astype(np.uint8)
    half = (len(t) + 1) // 2
    out = np.empty(len(t), np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def _inflate(block, n_bytes, what):
    try:
        d = zlib.decompress(block)
    except zlib.error:
        raise ValueError(f"corrupt OpenEXR {what} data") from None
    if len(d) != n_bytes:
        raise ValueError(f"OpenEXR {what} block size")
    return d


def _exr_unzip(block, n_bytes):
    """A ZIP / ZIPS block -> its raw bytes."""
    return _exr_unpredict(np.frombuffer(_inflate(block, n_bytes, "ZIP"),
                                        np.uint8))


def _exr_unrle(block, n_bytes):
    """An RLE block -> its raw bytes: run-length decoded, then reordered
    as a ZIP block."""
    return _exr_unpredict(native.exr_rle_decode(block, n_bytes))


def _exr_pxr24(block, geo, ny):
    """A PXR24 block: zlib, then per scanline and channel the samples'
    byte planes (most significant first; FLOAT keeps its top 24 bits,
    UINT all 32) holding differences along the row."""
    nb = {"f2": 2, "f4": 3, "u4": 4}
    size = {c: nb[dt.str[1:]] for c, dt, _, _ in geo}
    split = _exr_split(_inflate(block, _exr_size(geo, size), "PXR24"), geo,
                       ny, size)
    planes = {}
    for c, dt, _, _ in geo:
        k = size[c]
        b = split[c].reshape(len(split[c]), k, -1).astype(np.uint32)
        diff = sum(b[:, i] << (8 * (dt.itemsize - 1 - i)) for i in range(k))
        v = np.cumsum(diff, axis=1, dtype=np.uint64) & (
            (1 << (8 * dt.itemsize)) - 1)
        planes[c] = v.astype(f"<u{dt.itemsize}").view(np.uint8).reshape(
            len(b), -1)
    return planes


def _wdec(l, h, w14):
    """PIZ's inverse wavelet step of low / high values (int64 arrays of
    16-bit values) -> (a, b): 14-bit (signed) or 16-bit (modular)."""
    if w14:
        ls = (l ^ 0x8000) - 0x8000
        hs = (h ^ 0x8000) - 0x8000
        ai = ls + (hs & 1) + (hs >> 1)
        return ai & 0xFFFF, (ai - hs) & 0xFFFF
    b = (l - (h >> 1)) & 0xFFFF
    return (h + b - 0x8000) & 0xFFFF, b


def _wav2_decode(a, w14):
    """PIZ's 2D inverse wavelet (ImfWav.cpp wav2Decode) of a [ny, nx]
    int64 array, in place: from the coarsest level, every 2 x 2 group of a
    level at once, then the odd column and the odd row."""
    ny, nx = a.shape
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2, p = p, p >> 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        Y, X = np.ix_(ys, xs)
        i00, i10 = _wdec(a[Y, X], a[Y + p, X], w14)
        i01, i11 = _wdec(a[Y, X + p], a[Y + p, X + p], w14)
        a[Y, X], a[Y, X + p] = _wdec(i00, i01, w14)
        a[Y + p, X], a[Y + p, X + p] = _wdec(i10, i11, w14)
        if nx & p:                       # the odd column
            px = len(xs) * p2
            a[ys, px], a[ys + p, px] = _wdec(a[ys, px], a[ys + p, px], w14)
        if ny & p:                       # the odd row
            py = len(ys) * p2
            a[py, xs], a[py, xs + p] = _wdec(a[py, xs], a[py, xs + p], w14)
        p2, p = p, p >> 1


def _exr_piz(block, geo):
    """A PIZ block: the bitmap of the 16-bit values used, the Huffman-coded
    values (`csrc/image_codecs.cpp`), the wavelet of each channel's 16-bit
    words undone, the values mapped back through the bitmap's table."""
    n_words = _exr_size(geo) // 2
    if len(block) < 4:
        raise ValueError("truncated OpenEXR PIZ block")
    lo, hi = struct.unpack("<HH", block[:4])
    if hi >= 8192:
        raise ValueError("corrupt OpenEXR PIZ bitmap")
    bitmap = np.zeros(8192, np.uint8)
    pos = 4
    if lo <= hi:
        bitmap[lo:hi + 1] = np.frombuffer(block, np.uint8, hi - lo + 1, pos)
        pos += hi - lo + 1
    used = np.unpackbits(bitmap, bitorder="little").astype(bool)
    used[0] = True
    lut = np.zeros(65536, np.int64)
    values = np.flatnonzero(used)
    lut[:len(values)] = values
    length, = struct.unpack("<i", block[pos:pos + 4])
    pos += 4
    if length > len(block) - pos:
        raise ValueError("truncated OpenEXR PIZ block")
    words = native.exr_huf_decode(block[pos:pos + length],
                                  n_words).astype(np.int64)
    planes, off = {}, 0
    for c, dt, nx, rows in geo:
        size, ly = dt.itemsize // 2, len(rows)
        a = words[off:off + ly * nx * size].reshape(ly, nx, size)
        off += ly * nx * size
        for j in range(size):
            comp = np.ascontiguousarray(a[:, :, j])
            _wav2_decode(comp, len(values) - 1 < (1 << 14))
            a[:, :, j] = comp
        planes[c] = lut[a].astype("<u2").view(np.uint8).reshape(ly, -1)
    return planes


def _b44_unpack14(b):
    """B44's 14-byte blocks uint8 [n, 14] -> their 16 values [n, 16] (row
    by row), as ImfB44Compressor.cpp unpack14."""
    b = b.astype(np.int64)
    s = np.zeros((len(b), 16), np.int64)
    shift = b[:, 2] >> 2
    bias = 0x20 << shift

    def step(prev, bits):
        return (prev + ((bits & 0x3F) << shift) - bias) & 0xFFFF

    s[:, 0] = b[:, 0] << 8 | b[:, 1]
    s[:, 4] = step(s[:, 0], b[:, 2] << 4 | b[:, 3] >> 4)
    s[:, 8] = step(s[:, 4], b[:, 3] << 2 | b[:, 4] >> 6)
    s[:, 12] = step(s[:, 8], b[:, 4])
    for row, k in ((1, 5), (2, 8), (3, 11)):
        s[:, row] = step(s[:, row - 1], b[:, k] >> 2)
        s[:, row + 4] = step(s[:, row + 3], b[:, k] << 4 | b[:, k + 1] >> 4)
        s[:, row + 8] = step(s[:, row + 7], b[:, k + 1] << 2 | b[:, k + 2] >> 6)
        s[:, row + 12] = step(s[:, row + 11], b[:, k + 2])
    return s


def _b44_ordered_to_half(s):
    return np.where(s & 0x8000, s & 0x7FFF, ~s & 0xFFFF)


def _b44_log_table():
    """B44's table from a perceptually linear channel's stored half values
    back to linear ones (b44ExpLogTable.cpp logTable): 8 ln(x) rounded to
    half; 0 for inf, NaN and negative x (-0 included: ln gives -inf)."""
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    h = bits.view(np.float16).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        y = (np.float32(8) * np.log(h.astype(np.float64)).astype(np.float32))
    out = y.astype(np.float16).view(np.uint16)
    return np.where(~np.isfinite(h) | (bits > 0x8000), 0, out).astype(
        np.uint16)


_B44_TO_LINEAR = _b44_log_table()


def _exr_b44(block, geo, linear):
    """A B44 / B44A block: per channel, HALF samples in 4 x 4 blocks of 14
    bytes (3 for a flat block, B44A), row by row of blocks, through B44's
    log table where the channel is marked perceptually linear; other
    channels stored as they are."""
    planes, pos = {}, 0
    for c, dt, w, rows in geo:
        ny = len(rows)
        if dt.itemsize != 2:
            n = ny * w * dt.itemsize
            if pos + n > len(block):
                raise ValueError("truncated OpenEXR B44 block")
            planes[c] = np.frombuffer(block, np.uint8, n, pos).reshape(ny, -1)
            pos += n
            continue
        nbx, nby = -(-w // 4), -(-ny // 4)
        starts = np.empty(nbx * nby, np.int64)
        for i in range(nbx * nby):        # a flat block is 3 bytes long
            if pos + 3 > len(block):
                raise ValueError("truncated OpenEXR B44 block")
            starts[i] = pos
            pos += 3 if block[pos + 2] >= 13 << 2 else 14
        if pos > len(block):
            raise ValueError("truncated OpenEXR B44 block")
        buf = np.frombuffer(block + bytes(14), np.uint8)
        flat = buf[starts + 2] >= 13 << 2
        s = np.empty((len(starts), 16), np.int64)
        s[~flat] = _b44_unpack14(buf[starts[~flat, None] + np.arange(14)])
        first = buf[starts[flat]].astype(np.int64) << 8 | buf[starts[flat] + 1]
        s[flat] = first[:, None]
        s = _b44_ordered_to_half(s)
        if c in linear:
            s = _B44_TO_LINEAR[s]
        img = s.reshape(nby, nbx, 4, 4).transpose(0, 2, 1, 3).reshape(
            nby * 4, nbx * 4)[:ny, :w]
        planes[c] = img.astype("<u2").view(np.uint8).reshape(ny, -1)
    return planes



# DWA's channel schemes (ImfDwaCompressor.cpp CompressorScheme)
_DWA_UNKNOWN, _DWA_LOSSY_DCT, _DWA_RLE = 0, 1, 2


# the inverse DCT's constants as ImfDwaCompressorSimd.h writes them:
# .5 cos(k pi / 16), k = 4, 1, 2, 3, 5, 6, 7
_DWA_A, _DWA_B, _DWA_C, _DWA_D, _DWA_E, _DWA_F, _DWA_G = np.float32(
    [3.535536e-01, 4.903927e-01, 4.619398e-01, 4.157349e-01, 2.777855e-01,
     1.913422e-01, 9.754573e-02])


def _dwa_matrix():
    """The even inputs' (x0, x2, x4, x6) and the odd inputs' (x1, x3, x5,
    x7) coefficients [4, 4] of the first four outputs of an 8-point
    inverse DCT."""
    a, b, c, d, e, f, g = (_DWA_A, _DWA_B, _DWA_C, _DWA_D, _DWA_E, _DWA_F,
                           _DWA_G)
    even = np.array([[a, a, a, a], [c, f, -f, -c], [a, -a, -a, a],
                     [f, -c, c, -f]], np.float32)
    odd = np.array([[b, d, e, g], [d, -g, -b, -e], [e, -b, g, d],
                    [g, -e, d, -b]], np.float32)
    return even, odd


_DWA_EVEN, _DWA_ODD = _dwa_matrix()


def _dwa_idct_pass(x, order):
    """The row pass of the 8-point inverse DCT over the last axis of
    float32 x [..., 8], as libOpenEXR's AVX code (dctInverse8x8_avx)
    computes it: four products each of the even and of the odd inputs,
    summed in pairs in `order`; outputs 0-3 are even + odd, 7-4 even -
    odd."""
    i, j, k, m = order
    ev = [x[..., 2 * n, None] * _DWA_EVEN[n] for n in range(4)]
    od = [x[..., 2 * n + 1, None] * _DWA_ODD[n] for n in range(4)]
    even = (ev[i] + ev[j]) + (ev[k] + ev[m])
    odd = (od[i] + od[j]) + (od[k] + od[m])
    return np.concatenate([even + odd, (even - odd)[..., ::-1]], -1)


def _dwa_idct_cols(x):
    """The column pass of libOpenEXR's AVX inverse DCT (dctInverse8x8_avx,
    read from its machine code) over float32 x [n, 8 rows, 8 columns]:
    each output's products paired in the library's own order."""
    r = [x[:, i] for i in range(8)]
    a, b, c, d, e, f, g = (_DWA_A, _DWA_B, _DWA_C, _DWA_D, _DWA_E, _DWA_F,
                           _DWA_G)
    odd = ((r[1] * b + r[3] * d) + (r[5] * e + r[7] * g),
           (r[1] * d - (r[5] * b + r[3] * g)) - r[7] * e,
           ((r[1] * e - r[3] * b) + r[5] * g) + r[7] * d,
           (r[1] * g + r[5] * d) - (r[3] * e + r[7] * b))
    plus, minus = r[0] * a + r[4] * a, r[0] * a - r[4] * a
    s, t = r[2] * c + r[6] * f, r[2] * f - r[6] * c
    even = (plus + s, minus + t, minus - t, plus - s)
    return np.stack([even[k] + odd[k] for k in range(4)]
                    + [even[k] - odd[k] for k in (3, 2, 1, 0)], 1)


def _dwa_idct(blk, last):
    """DWA's inverse DCT of float32 blocks [n, 8, 8] as libOpenEXR runs it
    on a CPU with AVX: the rows (products summed (0 + 1) + (2 + 3)), then
    the columns (`_dwa_idct_cols`); a block whose only coefficient is its
    DC (`last` == 0) takes the DC-only shortcut, dc * 3.535536e-01f *
    3.535536e-01f."""
    out = _dwa_idct_cols(_dwa_idct_pass(blk, (0, 1, 2, 3)))
    dc = (blk[:, 0, 0] * _DWA_A) * _DWA_A
    return np.where((last == 0)[:, None, None], dc[:, None, None], out)


def _dwa_to_linear_table():
    """DWA's 16-bit table from its perceptual half values back to linear
    ones (dwaLookups.cpp): x^2.2 up to 1, (e^2.2)^(x - 1) above, sign kept;
    inf, NaN and -0 map to 0."""
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    ax = np.abs(bits.view(np.float16).astype(np.float64))
    sign = np.where(bits & 0x8000, np.float32(-1), np.float32(1))
    log_base = np.float64(np.float32(2.7182818 ** 2.2))
    with np.errstate(over="ignore", invalid="ignore"):
        y = np.where(ax <= 1, ax ** np.float64(np.float32(2.2)),
                     log_base ** (ax - 1))
        out = (sign * y.astype(np.float32)).astype(np.float16).view(np.uint16)
    out = np.where((bits & 0x7C00) == 0x7C00, 0, out).astype(np.uint16)
    out[[0, 0x8000]] = 0
    return out


_DWA_TO_LINEAR = _dwa_to_linear_table()


def _dwa_rules(block, pos):
    """A version-2 DWA block's channel rules from `pos` -> ([(suffix,
    scheme, csc index, case-insensitive, pixel type)], next pos)."""
    size, = struct.unpack("<H", block[pos:pos + 2])
    end, pos = pos + size, pos + 2
    rules = []
    while pos < end:
        suffix, pos = _cstr(block, pos)
        flags, ptype = block[pos], block[pos + 1]
        pos += 2
        rules.append((suffix, (flags >> 2) & 3, (flags >> 4) - 1, flags & 1,
                      ptype))
    return rules, end


def _dwa_decode_set(ac, dc, n_comp, w, ny, to_linear=True):
    """One LossyDctDecoder(Csc) of n_comp (1 or 3) channels: ac the AC
    values from this decoder's first (uint16), dc its DC halves
    [n_comp, blocks] -> (half planes uint16 [n_comp, ny, w], AC values
    read). to_linear: through the table back to linear values (a channel
    not marked perceptually linear)."""
    nbx, nby = -(-w // 8), -(-ny // 8)
    nb = nbx * nby
    zig, last, used = native.dwa_unrle_ac(ac, nb * n_comp)
    zig = zig.reshape(nb, n_comp, 64).transpose(1, 0, 2).copy()
    last = last.reshape(nb, n_comp).T
    zig[:, :, 0] = dc
    coef = np.empty_like(zig)
    coef[:, :, _ZIGZAG] = zig
    f = coef.view(np.float16).astype(np.float32).reshape(n_comp * nb, 8, 8)
    px = _dwa_idct(f, last.reshape(-1)).reshape(n_comp, nb, 64)
    if n_comp == 3:                      # csc709Inverse
        y, cb, cr = px
        f32 = np.float32
        px = np.stack([y + f32(1.5747) * cr,
                       y - f32(0.1873) * cb - f32(0.4682) * cr,
                       y + f32(1.8556) * cb])
    hb = px.astype(np.float16).view(np.uint16)
    if to_linear:
        hb = _DWA_TO_LINEAR[hb]
    img = hb.reshape(n_comp, nby, nbx, 8, 8).transpose(0, 1, 3, 2, 4).reshape(
        n_comp, nby * 8, nbx * 8)[:, :ny, :w]
    return img, used


# DWA's rules for version-1 blocks, which carry none (ImfDwaCompressor.cpp
# sLegacyChannelRules): (suffix, scheme, csc index, case-insensitive, type)
_DWA_LEGACY_RULES = [
    (sfx, _DWA_LOSSY_DCT, idx, 1, t)
    for sfx, idx in (("r", 0), ("red", 0), ("g", 1), ("grn", 1), ("green", 1),
                     ("b", 2), ("blu", 2), ("blue", 2), ("y", -1), ("by", -1),
                     ("ry", -1))
    for t in (_EXR_HALF, _EXR_FLOAT)] + [
    ("a", _DWA_RLE, -1, 1, t) for t in (_EXR_UINT, _EXR_HALF, _EXR_FLOAT)]


def _exr_dwa(block, geo, linear):
    """A DWAA / DWAB block: a header of 11 sizes, the channel rules (the
    legacy set in a version-1 block), then zlib'd channels the rules do
    not name, Huffman-coded AC coefficients, zlib'd DC coefficients and
    zlib'd run-length channels. R, G, B of one prefix (lossy whether HALF
    or FLOAT: DWA decodes halves and widens a FLOAT channel's) are decoded
    through the inverse DCT and the colour transform together, then
    through the table back to linear values; other lossy channels alone,
    through the table unless marked perceptually linear."""
    if len(block) < 88:
        raise ValueError("truncated OpenEXR DWA block")
    (version, unk_raw, unk_size, ac_size, dc_size, rle_size, rle_raw,
     rle_len, ac_count, dc_count, ac_method) = struct.unpack("<11Q",
                                                             block[:88])
    if version > 2:
        raise ValueError(f"OpenEXR DWA block of version {version}: "
                         "libOpenEXR refuses it too")
    n_raw = _exr_size(geo)
    most = sum(64 * -(-nx // 8) * -(-len(rows) // 8)
               for _, _, nx, rows in geo)
    if max(unk_raw, rle_raw, rle_len) > n_raw or max(ac_count,
                                                     dc_count) > most:
        raise ValueError("corrupt OpenEXR DWA block sizes")
    rules, pos = (_DWA_LEGACY_RULES, 88) if version < 2 else \
        _dwa_rules(block, 88)
    scheme, csc, dims = {}, {}, {}
    for c, dt, nx, rows in geo:
        prefix, _, suffix = c.rpartition(".")
        scheme[c] = _DWA_UNKNOWN
        dims[c] = (dt, nx, len(rows))
        for sfx, sch, idx, nocase, rtype in rules:
            same = suffix.lower() == sfx if nocase else suffix == sfx
            if same and rtype == _EXR_PTYPE[dt]:
                scheme[c] = sch
                if idx >= 0:
                    csc.setdefault(prefix, [None] * 3)[idx] = c
    sets = [csc[p] for p in sorted(csc) if None not in csc[p]]
    in_set = {c for v in sets for c in v}
    sizes = (unk_size, ac_size, dc_size, rle_size)
    if pos + sum(sizes) > len(block):
        raise ValueError("truncated OpenEXR DWA block")
    parts = []
    for n in sizes:
        parts.append(block[pos:pos + n])
        pos += n
    unknown = _inflate(parts[0], unk_raw, "DWA") if unk_size else b""
    if ac_method == 0:
        ac = native.exr_huf_decode(parts[1], ac_count) if ac_size else \
            np.zeros(0, np.uint16)
    else:
        ac = np.frombuffer(_inflate(parts[1], 2 * ac_count, "DWA"), "<u2")
    dc = np.frombuffer(_exr_unzip(parts[2], 2 * dc_count), "<u2") \
        if dc_size else np.zeros(0, np.uint16)
    rle = native.exr_rle_decode(_inflate(parts[3], rle_raw, "DWA"), rle_len) \
        if rle_size else np.zeros(0, np.uint8)
    planes = {}
    at_ac = at_dc = 0
    groups = sets + [[c] for c, _, _, _ in geo
                     if scheme[c] == _DWA_LOSSY_DCT and c not in in_set]
    for grp in groups:
        n = len(grp)
        _, w, ny = dims[grp[0]]
        nb = -(-w // 8) * -(-ny // 8)
        if at_dc + n * nb > len(dc):
            raise ValueError("truncated OpenEXR DWA DC data")
        img, used = _dwa_decode_set(ac[at_ac:], dc[at_dc:at_dc + n * nb]
                                    .reshape(n, nb), n, w, ny,
                                    n == 3 or grp[0] not in linear)
        at_ac += used
        at_dc += n * nb
        for c, v in zip(grp, img):
            if dims[c][0].itemsize == 4:  # FLOAT: the decoded half, widened
                v = v.astype(np.uint16).view(np.float16).astype("<f4")
            else:
                v = v.astype("<u2")
            planes[c] = np.ascontiguousarray(v).view(np.uint8).reshape(ny, -1)
    at_rle = at_unk = 0
    for c, dt, w, rows in geo:
        ny = len(rows)
        n = ny * w * dt.itemsize
        if scheme[c] == _DWA_RLE:
            if at_rle + n > len(rle):
                raise ValueError("truncated OpenEXR DWA RLE data")
            b = rle[at_rle:at_rle + n].reshape(dt.itemsize, ny, w)
            at_rle += n
            planes[c] = b.transpose(1, 2, 0).reshape(ny, -1)
        elif scheme[c] == _DWA_UNKNOWN:
            if at_unk + n > len(unknown):
                raise ValueError("truncated OpenEXR DWA data")
            planes[c] = np.frombuffer(unknown, np.uint8, n,
                                      at_unk).reshape(ny, -1)
            at_unk += n
    return planes


# compression -> fn(block, geometry, lines, raw size, perceptually linear
# channels) -> {channel: uint8 [lines, samples * bytes]}
_EXR_CODECS = {
    _EXR_ZIPS: lambda b, g, ny, n, lin: _exr_split(_exr_unzip(b, n), g, ny),
    _EXR_ZIP: lambda b, g, ny, n, lin: _exr_split(_exr_unzip(b, n), g, ny),
    _EXR_RLE: lambda b, g, ny, n, lin: _exr_split(_exr_unrle(b, n), g, ny),
    _EXR_PIZ: lambda b, g, ny, n, lin: _exr_piz(b, g),
    _EXR_PXR24: lambda b, g, ny, n, lin: _exr_pxr24(b, g, ny),
    _EXR_B44: lambda b, g, ny, n, lin: _exr_b44(b, g, lin),
    _EXR_B44A: lambda b, g, ny, n, lin: _exr_b44(b, g, lin),
    _EXR_DWAA: lambda b, g, ny, n, lin: _exr_dwa(b, g, lin),
    _EXR_DWAB: lambda b, g, ny, n, lin: _exr_dwa(b, g, lin)}


def _exr_block(comp, block, geo, ny, linear=frozenset()):
    """One chunk's bytes -> {channel: uint8 [lines, samples * bytes]} (the
    block's ny lines laid out by `_exr_geometry`). A chunk no smaller than
    its raw size is stored raw, as the library writes it."""
    n = _exr_size(geo)
    if comp == _EXR_NONE or len(block) >= n:
        if len(block) != n:
            raise ValueError("OpenEXR block size")
        return _exr_split(block, geo, ny)
    try:
        return _EXR_CODECS[comp](block, geo, ny, n, linear)
    except (struct.error, IndexError):
        raise ValueError("corrupt OpenEXR block") from None


def _exr_chunks(data, pos, n):
    """The chunk offset table at `pos`: n offsets."""
    try:
        offsets = struct.unpack(f"<{n}Q", data[pos:pos + 8 * n])
    except struct.error:
        raise ValueError("truncated OpenEXR offset table") from None
    return offsets


def read_exr(data):
    """OpenEXR bytes -> float32 [H, W, 3] RGB, as the JAX package's loader
    gets them from `cv2.imread` through OpenCV 4.6.0's EXR decoder, which
    reads the file with Imf::InputFile and converts its channels with its
    own code (ROADMAP C22). Scanline and tiled files (level (0, 0) of a
    mip- or ripmap), part 0 of a multi-part file, deep scanlines with Z
    and A (composited as InputFile composites them); every compression
    (NONE, RLE, ZIPS, ZIP, PIZ, PXR24, B44, B44A, DWAA, DWAB; DWA blocks
    of version 1 and 2; perceptually linear channels); HALF, FLOAT and
    UINT channels, sub-sampled ones included. What InputFile refuses, and
    what OpenCV returns no image for, raises ValueError."""
    attrs, pos, multipart = _exr_part0(data)
    linear, sampling = set(), {}
    try:
        comp = attrs["compression"][1][0]
        chans = _exr_channels(attrs["channels"][1], linear, sampling)
        x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    except (KeyError, IndexError, struct.error):
        raise ValueError("OpenEXR header without its required "
                         "attributes") from None
    if comp not in _EXR_LINES:
        raise ValueError(f"OpenEXR compression {comp}: unknown to "
                         "libOpenEXR")
    w, h = x1 - x0 + 1, y1 - y0 + 1
    if w <= 0 or h <= 0 or w * h > 1 << 30:
        raise ValueError("OpenEXR data window empty or past OpenCV's limit "
                         "of 2^30 pixels")
    tiles = attrs.get("tiles")
    deep = _exr_deep(attrs, struct.unpack("<i", data[4:8])[0], multipart)
    for c, (xs, ys) in sampling.items():
        if (xs, ys) != (1, 1) and (tiles is not None or deep or x0 % xs
                                   or y0 % ys or w % xs or h % ys):
            raise ValueError(f"OpenEXR channel '{c}' sampled ({xs}, {ys}) "
                             "in a tiled or deep part, or off its data "
                             "window's grid: InputFile refuses it")
    skip = 4 if multipart else 0       # a chunk's part number
    if deep:
        planes = _exr_read_deep(data, pos, skip, comp, chans, x0, y0, w, h)
    elif tiles is None:
        planes = _exr_read_lines(data, pos, skip, comp, chans, sampling,
                                 linear, x0, y0, w, h)
    else:
        planes = _exr_read_tiles(data, pos, skip, comp, chans, sampling,
                                 linear, tiles[1], w, h)
    return _exr_opencv(planes, sampling, attrs, (x0, y0), h, w)


def _exr_planes(chans, sampling, w, h):
    """Zeroed float32 planes, each channel at its own sampling."""
    return {c: np.zeros((h // sampling[c][1], w // sampling[c][0]),
                        np.float32) for c, _ in chans}


def _exr_read_lines(data, pos, skip, comp, chans, sampling, linear, x0, y0,
                    w, h):
    """A scanline part's chunks -> its float32 channel planes."""
    planes = _exr_planes(chans, sampling, w, h)
    lines = _EXR_LINES[comp]
    for off in _exr_chunks(data, pos, -(-h // lines)):
        try:
            y, size = struct.unpack("<ii", data[off + skip:off + skip + 8])
        except struct.error:
            raise ValueError("truncated OpenEXR chunk") from None
        if (y - y0) % lines or not y0 <= y <= y0 + h - 1:
            raise ValueError("corrupt OpenEXR chunk header")
        ny = min(lines, y0 + h - y)
        block = data[off + skip + 8:off + skip + 8 + size]
        geo = _exr_geometry(chans, sampling, x0, w, y, ny)
        _exr_put(planes, _exr_block(comp, block, geo, ny, linear), geo,
                 y - y0, 0, sampling)
    return planes


def _exr_read_tiles(data, pos, skip, comp, chans, sampling, linear, desc, w,
                    h):
    """A tiled part's level (0, 0) -> its float32 channel planes."""
    if len(desc) < 9:
        raise ValueError("corrupt OpenEXR tile description")
    tx, ty, mode = struct.unpack("<IIB", desc[:9])
    if mode & 0xF > 2 or tx == 0 or ty == 0:
        raise ValueError("corrupt OpenEXR tile description")
    planes = _exr_planes(chans, sampling, w, h)
    ntx, nty = -(-w // tx), -(-h // ty)
    for off in _exr_chunks(data, pos, ntx * nty):
        try:
            dx, dy, lx, ly, size = struct.unpack(
                "<iiiii", data[off + skip:off + skip + 20])
        except struct.error:
            raise ValueError("truncated OpenEXR chunk") from None
        if (lx, ly) != (0, 0) or not (0 <= dx < ntx and 0 <= dy < nty):
            raise ValueError("corrupt OpenEXR tile header")
        tw, th = min(tx, w - dx * tx), min(ty, h - dy * ty)
        block = data[off + skip + 20:off + skip + 20 + size]
        geo = _exr_geometry(chans, sampling, 0, tw, 0, th)
        _exr_put(planes, _exr_block(comp, block, geo, th, linear), geo,
                 dy * ty, dx * tx, sampling)
    return planes


def _exr_put(planes, block, geo, row, col, sampling):
    """A block's channels ({name: uint8 [lines, samples * bytes]}) into
    the float32 channel planes (each at its own sampling) at pixel (row,
    col); UINT samples rounded to float32 as InputFile converts them."""
    for c, dt, nx, rows in geo:
        xs, ys = sampling[c]
        v = np.ascontiguousarray(block[c]).view(dt)
        planes[c][(row + rows) // ys, col // xs:col // xs + nx] = v


def _exr_read_deep(data, pos, skip, comp, chans, x0, y0, w, h):
    """A deep scanline part -> its float32 channel planes [h, w],
    composited as Imf::InputFile composites a single deep part for OpenCV
    (ImfCompositeDeepScanLine.cpp, DeepCompositing::composite_pixel):
    each pixel's samples in the file's order (one source is not sorted),
    front to back, out += (1 - alpha) * sample for every channel, alpha
    being A's sum so far; a pixel stops at the first sample met with
    alpha >= 1; a pixel without samples is 0."""
    if comp not in (_EXR_NONE, _EXR_RLE, _EXR_ZIPS):
        raise ValueError(f"deep OpenEXR data of compression {comp}: "
                         "libOpenEXR takes only NONE, RLE and ZIPS")
    lines = 1
    unpack = {_EXR_NONE: lambda b, n: b, _EXR_RLE: _exr_unrle,
              _EXR_ZIPS: _exr_unzip}[comp]

    def raw(b, n):
        return b if len(b) >= n else unpack(b, n)

    counts = np.zeros((h, w), np.int64)
    found = [None] * h                   # each line's samples, per channel
    line_bytes = sum(dt.itemsize for _, dt in chans)
    for off in _exr_chunks(data, pos, -(-h // lines)):
        try:
            y, n_table, n_packed, n_raw = struct.unpack(
                "<iQQQ", data[off + skip:off + skip + 28])
        except struct.error:
            raise ValueError("truncated OpenEXR chunk") from None
        if (y - y0) % lines or not y0 <= y <= y0 + h - 1:
            raise ValueError("corrupt OpenEXR chunk header")
        ny = min(lines, y0 + h - y)
        at = off + skip + 28
        table = data[at:at + n_table]
        body = data[at + n_table:at + n_table + n_packed]
        if len(table) != n_table or len(body) != n_packed:
            raise ValueError("truncated OpenEXR deep chunk")
        cum = np.frombuffer(raw(table, 4 * ny * w), "<i4")
        if len(cum) != ny * w:
            raise ValueError("OpenEXR deep sample count table size")
        cum = cum.reshape(ny, w).astype(np.int64)
        n = np.diff(cum, axis=1, prepend=0)
        if (n < 0).any():
            raise ValueError("corrupt OpenEXR deep sample counts: "
                             "InputFile refuses them too")
        total = int(cum[:, -1].sum())
        if n_raw != total * line_bytes:
            raise ValueError("OpenEXR deep data size does not match its "
                             "sample counts")
        body = np.frombuffer(raw(body, n_raw), np.uint8)
        if len(body) != n_raw:
            raise ValueError("OpenEXR deep data size")
        p = 0
        for i in range(ny):
            k = int(cum[i, -1])
            line = {}
            for c, dt in chans:
                line[c] = body[p:p + k * dt.itemsize].view(dt).astype(
                    np.float32)
                p += k * dt.itemsize
            counts[y - y0 + i] = n[i]
            found[y - y0 + i] = line
    if any(f is None for f in found):
        raise ValueError("OpenEXR deep lines missing")
    samples = {c: np.concatenate([f[c] for f in found]) for c, _ in chans}
    flat = counts.ravel()
    start = np.cumsum(flat) - flat
    out = {c: np.zeros(h * w, np.float32) for c, _ in chans}
    done = np.zeros(h * w, bool)
    with np.errstate(over="ignore", invalid="ignore"):
        for k in range(int(flat.max(initial=0))):
            live = (flat > k) & ~done
            done |= live & (out["A"] >= 1)
            live &= ~done
            idx = start[live] + k
            f = np.float32(1) - out["A"][live]
            for c in out:
                out[c][live] += f * samples[c][idx]
    return {c: v.reshape(h, w) for c, v in out.items()}


# Imf::Chromaticities' defaults (Rec. ITU-R BT.709): red, green, blue, white
_EXR_REC709 = np.float32([0.64, 0.33, 0.3, 0.6, 0.15, 0.06, 0.3127, 0.329])


def _exr_opencv(planes, sampling, attrs, origin, h, w):
    """Decoded channel planes -> the JAX package's [H, W, 3] RGB, by
    OpenCV 4.6.0's rules (grfmt_exr.cpp; ROADMAP C22), taken from its
    decodes: R, G and B where any is present, the others 0; else Y with
    RY / BY converted by OpenCV's own chroma code (RY and BY up-sampled by
    repetition; a missing one 0) in float64: r = (RY + 1) Y, b = (BY + 1)
    Y, g = (Y - b y_blue - r y_red) / y_green with the file's
    chromaticities (Rec. 709's by default); Y with A (OpenCV reads Y into
    its third slot only) is zeros; Y alone is replicated; Z without any of
    these is zeros; other files give no image (ValueError). A and the
    channels OpenCV does not name are ignored."""
    names = set(planes)
    if names & {"R", "G", "B"}:
        slots = ("R", "G", "B")
    elif "Y" in names and names & {"RY", "BY"}:
        slots = ("RY", "Y", "BY")
    elif "Y" in names and "A" not in names:
        slots = ("Y", "Y", "Y")
    elif "Y" in names or "Z" in names:
        return np.zeros((h, w, 3), np.float32)
    else:
        raise ValueError("OpenEXR file without R, G, B, Y or Z channels: "
                         "OpenCV (the JAX package's reader) returns no "
                         "image for it")
    full = {}
    for c in set(slots) & names:
        xs, ys = sampling[c]
        if (xs, ys) != (1, 1) and origin != (0, 0):
            raise ValueError(f"OpenEXR channel '{c}' sub-sampled in a data "
                             "window not at (0, 0): OpenCV 4.6.0 writes "
                             "outside its image there (ROADMAP C22)")
        full[c] = np.repeat(np.repeat(planes[c], ys, 0), xs, 1)
    if slots[0] != "RY":
        zero = np.zeros((h, w), np.float32)
        return np.stack([full.get(c, zero) for c in slots], -1)
    chroma = attrs.get("chromaticities")
    cy = np.frombuffer(chroma[1], "<f4") if chroma and len(chroma[1]) >= 32 \
        else _EXR_REC709
    y_red, y_green, y_blue = (np.float64(v) for v in cy[[1, 3, 5]])
    y = full["Y"].astype(np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        r = (full["RY"].astype(np.float64) + 1 if "RY" in full else 1) * y
        b = (full["BY"].astype(np.float64) + 1 if "BY" in full else 1) * y
        g = (y - b * y_blue - r * y_red) / y_green
        return np.stack([r, g, b], -1).astype(np.float32)


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
