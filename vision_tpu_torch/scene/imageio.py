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
    samples, Huffman- or arithmetic-coded, and lossless Huffman files;
    any integral sampling factors (lossless components replicated up to
    full size), restart intervals, any size; grey, YCbCr, RGB, CMYK and
    YCCK chosen as libjpeg chooses (JFIF, the Adobe APP14 transform, the
    component ids); decoded as PIL (libjpeg-turbo) decodes them, in its
    integer arithmetic: the ISLOW IDCT as its SIMD code computes it
    (16-bit lanes: ROADMAP C19), "fancy" triangle-filter upsampling of
    h2v1, h1v2 and h2v2 chroma (`jdsample.c`), the YCbCr -> RGB tables
    (`jdcolor.c`), PIL's inverted CMYK and its CMYK -> RGB; a progressive
    file cut between or inside its scans through libjpeg-turbo's block
    smoothing (`jdcoefct.c`); corrupt files as PIL and libjpeg-turbo read
    them (PIL's marker walk, libjpeg's segment rules, its standard Huffman
    tables, a bad code as symbol 0, data that meets a marker early:
    ROADMAP C26). Arithmetic-coded lossless (SOF11), 12-bit, hierarchical
    and fractionally sampled files, and interleaved MCUs of more than 10
    blocks, are refused as libjpeg-turbo refuses them.
  * BMP (`read_bmp`) and TGA (`read_tga`): as PIL's plugins read them
    (their docstrings list the variants), quirks included.
  * TIFF (`read_tiff`) and GIF (`read_gif`): as PIL (libtiff for
    compressed TIFF) reads page / frame 0; their docstrings list the
    variants and the quirks copied. Old-style JPEG TIFF through libtiff's
    OJPEG codec (`ojpeg.py`).
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
    sub-sampled ones included; a corrupt file as libOpenEXR 3.1 reads it:
    ROADMAP C25), then converted by OpenCV's rules: R, G, B (missing ones
    0), or luminance-chroma converted, or Y replicated.
  * Under a .hdr / .exr name, OpenCV's own BMP, Sun raster, PNM, PFM,
    PAM and GIF readers and its CMYK / YCCK JPEG conversion
    (`cvread.py`), its TIFF reader over libtiff (`cvtiff.py`), and its
    JPEG 2000 reader over OpenJPEG's whole-image API (`cvj2k.py`).
  * Under any other name, the plugins of PIL tried in PIL's order, and
    the small formats of PIL's own plugins (`pilread.py`).
  * `write_exr`: a single-part scanline OpenEXR of uncompressed FLOAT B, G,
    R channels.

OpenCV's AVIF reader under a .hdr / .exr name and the formats PIL opens
that `pilread.py` does not decode yet raise NotImplementedError naming
their item of ROADMAP queue A (JPEG 2000, HTJ2K code-blocks included,
under any other name is decoded by `j2k.py`).
"""
from __future__ import annotations

import lzma
import os
import re
import struct
import zlib

import numpy as np

from .. import native
from . import cvj2k, cvread, cvtiff, ojpeg, pilread, tiffdir, webp

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
EXR_MAGIC = 20000630


def _not_ported(what, slice_):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP queue A, slice {slice_}")


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
    content: PIL's plugins tried in PIL's order (`pilread.read`)."""
    return pilread.read(data, name)


# the signatures OpenCV's JPEG 2000 readers take: a JP2 signature box
# (OPJ_CODEC_JP2) and a bare codestream's SOC SIZ (OPJ_CODEC_J2K), both
# decoded by `cvj2k`
_J2K_SIGNATURES = (b"\0\0\0\x0cjP  \r\n\x87\n", b"\xffO\xffQ")


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
    (`webp.decode_opencv`); BMP, Sun raster, PNM, PFM, PAM and GIF files
    by OpenCV's own readers (`cvread`), TIFF by its libtiff reader
    (`cvtiff`), JPEG 2000 (HTJ2K code-blocks too) by its OpenJPEG reader
    (`cvj2k`). OpenCV's AVIF reader raises NotImplementedError (7e.8);
    content OpenCV cannot read raises ValueError."""
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
    if data[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        return _from_cv(cvtiff.read_tiff_cv(data))
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return _from_cv(cvread.read_gif_cv(data))
    if data[:4] == cvread.SUNRAS_MAGIC:
        return _from_cv(cvread.read_sunras(data))
    if len(data) > 2 and data[0] == ord("P") and data[2] in b" \t\n\v\f\r":
        if data[1] in b"123456":
            return _from_cv(cvread.read_pnm(data))
        if data[1] in b"fF":
            return _from_cv(cvread.read_pfm(data))
        if data[1] == ord("7"):
            return _from_cv(cvread.read_pam(data))
    if data.startswith(_J2K_SIGNATURES):
        return _from_cv(cvj2k.read_cv(data))
    if _is_avif(data):
        raise _not_ported(f"'{name}': decoding AVIF files as OpenCV does",
                          "7e.8")
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


def _png_chunks(data, cut_idat=False):
    """(type, body) of each chunk to IEND. `cut_idat`: an IDAT cut by the
    file's end is taken as far as it goes (PIL reads image data until its
    decoder has every row)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n and cut_idat and kind == b"IDAT":
            yield kind, body
            return
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


def _png_pil_checks(data):
    """PngImageFile._open's checks of the chunks before the first IDAT:
    each type four word characters, each CRC right (else PIL's
    SyntaxError: no plugin identifies the file)."""
    pos = 8
    while pos + 8 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if not re.match(rb"\w\w\w\w", kind):
            raise ValueError(f"broken PNG file (chunk {kind!r})")
        if kind == b"IDAT":
            return
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(crc) < 4 or zlib.crc32(data[pos + 4:pos + 8 + n]) != \
                struct.unpack(">I", crc)[0]:
            raise ValueError(f"broken PNG file (bad checksum in {kind!r})")
        pos += 12 + n


def read_png(data, full_depth=False):
    """PNG bytes -> uint8 [H, W, 3], as PIL's convert("RGB") gives them:
    alpha dropped (not composited), a palette expanded (missing entries
    black), 1/2/4-bit grey scaled to 0..255, 16-bit grey clipped at 255
    (PIL's I;16 -> RGB), other 16-bit samples cut to their high byte.
    Adam7 files are de-interlaced. A colour type and bit depth that PNG
    does not define is refused, as PIL refuses it (ValueError).
    full_depth: a 16-bit file's samples whole (uint16, grey replicated),
    as OpenCV's IMREAD_ANYDEPTH gives them; otherwise the chunks before
    the first IDAT are checked as PIL checks them (a type of four letters
    or digits, the CRC)."""
    if not full_depth:
        _png_pil_checks(data)
    ihdr, plte, idat = None, None, []
    for kind, body in _png_chunks(data, cut_idat=not full_depth):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if w == 0 or h == 0:
        raise ValueError("PNG of no pixels")
    if ctype not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[ctype]:
        raise ValueError(f"PNG colour type {ctype} at bit depth {depth} is "
                         "not defined (PIL refuses it too)")
    if comp != 0 or filt != 0 or interlace > 1:
        raise ValueError("PNG compression, filter or interlace method")
    nch = _PNG_CHANNELS[ctype]
    if full_depth:
        raw = zlib.decompress(b"".join(idat))
    else:   # PIL stops at the last row, whether or not the stream ends
        try:
            raw = zlib.decompressobj().decompress(b"".join(idat))
        except zlib.error as e:
            raise ValueError(f"corrupt PNG image data ({e})") from None
    raw = np.frombuffer(raw, np.uint8)
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
    return bmp_bitmap(data, 14, struct.unpack("<I", data[10:14])[0])[0]


def bmp_bitmap(data, hpos, offset, halve=False, by_path=True):
    """The bitmap whose info header starts at `hpos`, as BmpImagePlugin's
    `_bitmap` reads it (`offset`: the file header's pixel offset, 0 for a
    DIB, a cursor or an icon, whose pixels follow the palette). `halve`:
    only the upper half of the stated height (CUR and ICO: the colour
    image above the AND mask); `by_path`: PIL
    memory-maps the file (an icon's bitmap is read from its stream
    instead). Returns (the image, (its pixels' offset, width, height)).
    Where `_bitmap` fails as PIL takes for "not this format" (a short read
    of the header's size or of its bitfield masks, struct.error; an image
    of no pixels) it raises `pilread._PassOn`: the next plugin is tried."""
    if len(data) < hpos + 4:
        raise pilread._PassOn                      # i32(read(4))
    hsize, = struct.unpack("<I", data[hpos:hpos + 4])
    hd = data[hpos + 4:hpos + hsize]
    if hsize < 4 or len(hd) != hsize - 4:
        raise ValueError("truncated BMP header")
    pos = hpos + hsize
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
                if len(data) < pos + 12:
                    raise pilread._PassOn              # i32(read(4))
                masks = struct.unpack("<3I", data[pos:pos + 12])
                pos += 12
            masks = tuple(masks) + (0,) * (4 - len(masks))
    else:
        raise _bmp_refused(f"header of {hsize} bytes")
    if w == 0 or h == 0:
        raise pilread._PassOn                      # no pixels
    if w < 0 or not 0 < h < 2 ** 31:
        raise _bmp_refused(f"size {w} x {h}")
    if halve:
        h //= 2
        if h <= 0:
            raise pilread._PassOn                  # no pixels
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
        elif len(p) > 256:
            raise _bmp_refused(f"palette of {len(p)} entries")
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
        if grey == "L" and stride < w and not by_path:
            raise _bmp_refused("grey-ramp palette below 8 bits in an icon")
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
    return np.ascontiguousarray(out), (start, w, h)


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


def _w16(x):
    """x wrapped to a signed 16-bit lane."""
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(x, n):
    """One pass of libjpeg-turbo's SIMD ISLOW IDCT (jidctint-sse2.asm /
    -avx2.asm) over x[0..7] (int64 arrays of 16-bit values), descaled by n
    bits with rounding: the eight outputs, before they are packed to 16
    bits. Its products are 16 x 16 -> 32-bit multiply-adds of the ISLOW
    constants folded pairwise (the same integers as jidctint.c's), and its
    sums of two inputs are 16-bit adds that wrap."""
    tmp2 = x[2] * _F0541 + x[6] * (_F0541 - _F1847)
    tmp3 = x[2] * (_F0541 + _F0765) + x[6] * _F0541
    tmp0 = _w16(x[0] + x[4]) << _CONST_BITS
    tmp1 = _w16(x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z3, z4 = _w16(x[7] + x[3]), _w16(x[5] + x[1])
    z3, z4 = (z3 * (_F1175 - _F1961) + z4 * _F1175,
              z3 * _F1175 + z4 * (_F1175 - _F0390))
    t0 = x[7] * (_F0298 - _F0899) - x[1] * _F0899 + z3
    t3 = -x[7] * _F0899 + x[1] * (_F1501 - _F0899) + z4
    t1 = x[5] * (_F2053 - _F2562) - x[3] * _F2562 + z4
    t2 = -x[5] * _F2562 + x[3] * (_F3072 - _F2562) + z3
    r = 1 << (n - 1)
    return [(tmp10 + t3 + r) >> n, (tmp11 + t2 + r) >> n,
            (tmp12 + t1 + r) >> n, (tmp13 + t0 + r) >> n,
            (tmp13 - t0 + r) >> n, (tmp12 - t1 + r) >> n,
            (tmp11 - t2 + r) >> n, (tmp10 - t3 + r) >> n]


def _idct_islow(coef, q):
    """libjpeg-turbo's ISLOW IDCT as its SIMD code (which PIL's and the pip
    cv2's builds run) computes it, on every block at once: coef int16
    [..., 64] in natural order, q the quantisation table [64] -> uint8
    [..., 8, 8] samples. Dequantised in 16 bits (wrapping); columns first:
    a block whose AC rows 1-7 are all zero gives DC << 2 (16-bit) in every
    column, any other the pass above; each pass's outputs saturate to 16
    bits, the last to 8 around 128. Where nothing wraps or saturates this
    is jidctint.c's C IDCT exactly (ROADMAP C19)."""
    c = _w16(coef.reshape(-1, 8, 8).astype(np.int64) *
             q.reshape(8, 8).astype(np.int64))
    ws = np.stack(_idct_1d([c[:, k, :] for k in range(8)],
                           _CONST_BITS - _PASS1_BITS), 1)        # [B, row, col]
    ws = np.clip(ws, -32768, 32767)
    dc_only = ~c[:, 1:, :].any((1, 2))
    ws[dc_only] = _w16(c[dc_only, :1, :] << _PASS1_BITS)
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)],
                            _CONST_BITS + _PASS1_BITS + 3), 2)
    out = np.clip(out, -128, 127) + 128
    return out.astype(np.uint8).reshape(coef.shape[:-1] + (8, 8))


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


def _lossless_rgb(planes, pt, jfif, adobe, cmyk=False, raw=False):
    """A lossless file's samples -> RGB as PIL gets them: each sample
    shifted back by its point transform into 8 bits; grey, RGB or CMYK
    (libjpeg converts no colour in lossless mode and refuses to: a YCbCr or
    YCCK file is refused). `cmyk`: a CMYK file's 4 samples as they are;
    `raw`: every file's samples as they are."""
    out = [((p.astype(np.int64) << pt[ci]) & 0xFF).astype(np.uint8)
           for ci, p in enumerate(planes)]
    if raw:
        return np.stack(out, -1)
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


def _std_huff(hexes):
    b = bytes.fromhex(hexes)
    bits = np.frombuffer(b, np.uint8, 16)
    vals = np.zeros(256, np.uint8)
    vals[:len(b) - 16] = np.frombuffer(b, np.uint8, offset=16)
    return bits, vals


# JPEG's standard tables (T.81 K.3), as libjpeg-turbo's jstdhuff.c: the
# DC tables 0, 1 and the AC tables 0, 1 (rows 4, 5 of huff_bits)
_JPEG_STD_HUFF = {
    0: _std_huff("00010501010101010100000000000000000102030405060708090a0b"),
    1: _std_huff("00030101010101010101010000000000000102030405060708090a0b"),
    4: _std_huff(
        "0002010303020403050504040000017d01020300041105122131410613516107"
        "227114328191a1082342b1c11552d1f02433627282090a161718191a25262728"
        "292a3435363738393a434445464748494a535455565758595a63646566676869"
        "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
        "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
        "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    5: _std_huff(
        "0002010204040304070504040001027700010203110405213106124151076171"
        "1322328108144291a1b1c109233352f0156272d10a162434e125f11718191a26"
        "2728292a35363738393a434445464748494a535455565758595a636465666768"
        "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5"
        "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
        "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")}


def _jpeg_next_marker(data, pos):
    """libjpeg's next_marker from `pos`: bytes up to an 0xFF skipped, fill
    0xFFs swallowed, a stuffed 0xFF 0x00 skipped -> (the marker's code,
    the offset after it). Running off the file's end is PIL's refusal
    ("image file is truncated")."""
    n = len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError("JPEG data ends before its EOI marker: PIL "
                             "refuses it as truncated")
        c = data[pos]
        pos += 1
        if c != 0:
            return c, pos


def _jpeg_whole(data, pos, single_scan):
    """Whether PIL has every line once a scan ends at `pos`: a sequential
    scan of every component that ended at a marker. libjpeg then reads the
    markers after it in jpeg_finish_decompress, where PIL takes running
    out of data (a segment or the search for EOI past the file's end) as
    the end; an error there still refuses the file."""
    return single_scan and pos + 1 < len(data) and data[pos] == 0xFF


def _scan_component(comps, cid, k, sel):
    """The frame component a scan's k-th entry names, as libjpeg-turbo's
    get_sos finds it: the first of id `cid` at or after slot k, none
    listed twice (`sel`: those of the entries before)."""
    ci = next((j for j, c in enumerate(comps)
               if c["id"] == cid and j >= k and j not in sel), None)
    if ci is None:
        raise _jpeg_refused("a scan of a bad component id in")
    return ci


def _jpeg_tail_segment(data, pos, marker, comps):
    """A segment libjpeg parses (DQT, DHT, DRI, DAC, SOS, a frame header)
    after a whole single scan, read byte by byte as jpeg_finish_decompress
    reads it from `pos` (its length field): the file's bytes, whatever the
    length says (a short quantisation table reads on past it) -> the
    offset after what was read, or None where the file ends first (libjpeg
    suspends there and PIL keeps its image). Raises where libjpeg stops
    with an error on the bytes it has read."""
    n = len(data)
    if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xCC):
        raise _jpeg_refused("a frame header after a whole scan in")
    if pos + 2 > n:
        return None
    length, = struct.unpack(">H", data[pos:pos + 2])
    p = pos + 2
    if marker == 0xDD:
        if length != 4:
            raise _jpeg_refused("a restart interval of the wrong length in")
        return p + 2 if p + 2 <= n else None
    if marker == 0xDA:
        if p >= n:
            return None
        ns = data[p]
        p += 1
        if length != 2 * ns + 6 or not 1 <= ns <= 4:
            raise _jpeg_refused("a scan header of the wrong length in")
        sel = []
        for k in range(ns):
            if p + 2 > n:
                return None
            sel.append(_scan_component(comps, data[p], k, sel))
            p += 2
        if p + 3 > n:
            return None
        raise _jpeg_refused("a scan after a whole sequential scan in")
    length -= 2
    if marker == 0xDB:
        while length > 0:
            if p >= n:
                return None
            pq, tq = data[p] >> 4, data[p] & 15
            size = 128 if pq else 64
            if tq > 3:
                raise _jpeg_refused("a bad quantisation table in")
            if p + 1 + size > n:
                return None
            p += 1 + size
            length -= 1 + size
    elif marker == 0xC4:
        while length > 16:
            if p + 17 > n:
                return None
            idx, nv = data[p], sum(data[p + 1:p + 17])
            p += 17
            length -= 17
            if nv > 256 or nv > length:
                raise _jpeg_refused("a bad Huffman table in")
            if p + nv > n:
                return None
            p += nv
            length -= nv
            if not (0 <= idx < 4 or 0x10 <= idx < 0x14):
                raise _jpeg_refused("a Huffman table id past 3 in")
    else:   # DAC
        while length > 0:
            if p + 2 > n:
                return None
            index, val = data[p], data[p + 1]
            p += 2
            length -= 2
            if index >= 32 or (index < 16 and val & 15 > val >> 4):
                raise _jpeg_refused("bad arithmetic conditioning")
    if length != 0:
        raise _jpeg_refused("a segment of the wrong length in")
    return p


def _pil_jpeg_open(data):
    """PIL's JpegImageFile._open, which walks the markers to the first SOS
    before libjpeg reads the file: ValueError where it raises (a short
    read, a marker not in its table, a frame of other than 8 bits or of
    other than 1, 3 or 4 components, a short JFIF, Adobe or quantisation
    table segment, no frame before the scan)."""
    def refuse(what):
        return ValueError(f"JPEG {what}: PIL refuses it")
    n = len(data)
    s, pos, mode = 0xFF, 3, None
    while True:
        if s != 0xFF:                      # junk before a marker: skipped
            if s is None or pos >= n:
                raise refuse("that ends before its scan")
            s, pos = data[pos], pos + 1
            continue
        if pos >= n:
            raise refuse("that ends in a marker")
        m = data[pos]
        pos += 1
        if m == 0xFF:                      # fill byte
            continue
        if m == 0x00:                      # a stuffed 0xFF
            s, pos = (data[pos], pos + 1) if pos < n else (None, pos)
            continue
        if m < 0xC0:
            raise refuse(f"marker 0x{m:02X} (not in PIL's table)")
        if m != 0xC8 and not 0xD0 <= m <= 0xD9:  # a handler reads a length
            if pos + 2 > n:
                raise refuse("segment length cut short")
            ln = struct.unpack(">H", data[pos:pos + 2])[0] - 2
            body = data[pos + 2:pos + 2 + max(ln, 0)]
            if len(body) < ln:
                raise refuse("segment cut short")
            pos += 2 + max(ln, 0)
            if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):  # SOF
                if len(body) < 6 or body[0] != 8 or body[5] not in (1, 3, 4) \
                        or (len(body) - 6) % 3:
                    raise refuse("frame header")
                mode = body[5]
                size = struct.unpack(">HH", body[1:5])
            elif m == 0xDB:
                i = 0
                while i < len(body):
                    i += 1 + 64 * (1 if body[i] < 16 else 2)
                    if i > len(body):
                        raise refuse("quantisation table segment")
            elif m in (0xE0, 0xEE) and body.startswith(
                    b"JFIF" if m == 0xE0 else b"Adobe") and len(body) < 7:
                raise refuse("JFIF or Adobe segment")
            elif m == 0xE2 and body.startswith(b"ICC_PROFILE\0") and \
                    len(body) < 14:
                raise refuse("ICC profile segment")
        if m == 0xDA:
            if mode is None or 0 in size:
                raise refuse("scan before a frame with pixels")
            return
        s, pos = (data[pos], pos + 1) if pos < n else (None, pos)


def _jpeg_scans(data, ojpeg=False):
    """JPEG bytes -> (frame, components, their coefficient planes, the
    quantisation table latched for each, JFIF, Adobe transform, lossless,
    block smoothing's state): the markers walked and every scan
    entropy-decoded as libjpeg-turbo does (`read_jpeg`'s refusals).
    `ojpeg`: the stream libtiff's old-style JPEG codec hands libjpeg
    (`ojpeg._stream`), which PIL's JPEG plugin never walks, whose restart
    markers out of order and whose end stop libjpeg with an error ->
    (frame, components, planes, latched tables, the MCU libjpeg stopped
    at or None)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    if not ojpeg:
        _pil_jpeg_open(data)
    qt = {}
    huff_bits = np.zeros((8, 16), np.uint8)
    huff_vals = np.zeros((8, 256), np.uint8)
    defined = set()         # the Huffman tables a DHT has defined
    frame, comps, planes, latched = None, None, None, {}
    restart, jfif, adobe, progressive, lossless = 0, False, None, False, False
    scanned = single_scan = False
    # DAC's conditioning, read whatever the coding; the frame header says
    # whether the file is arithmetic-coded (`arith`: the conditioning)
    cond = np.array(_ARITH_CONDITIONING, np.int32)
    arith = None
    # libjpeg's coef_bits of coefficients 0-9 (-1: not yet sent; else the
    # Al of the last scan that sent it) and their values before each
    # component's last scan (the second half of its table)
    coef_bits = np.full((4, 10), -1)
    prev_bits = np.zeros((4, 10), np.int64)
    n_scans, last_good = 0, 0
    pos = 2
    whole = False   # PIL has every line: see _jpeg_whole
    while True:
        try:
            marker, pos = _jpeg_next_marker(data, pos)
        except ValueError:
            if whole:
                break
            raise
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if marker == 0xD8:
            raise _jpeg_refused("a second SOI marker in")
        if marker < 0xC0 or marker in (0xDE, 0xDF) or 0xF0 <= marker <= 0xFD:
            raise _jpeg_refused(f"a reserved marker 0x{marker:02X} in")
        if whole and not (0xE0 <= marker <= 0xEF or marker in (0xFE, 0xDC)):
            # jpeg_finish_decompress: no table is used any more, only
            # whether libjpeg errs, suspends or reads on matters (C26)
            pos = _jpeg_tail_segment(data, pos, marker, comps)
            if pos is None:
                break
            continue
        if pos + 2 > len(data):
            if whole:
                break
            raise ValueError("truncated JPEG segment")
        n, = struct.unpack(">H", data[pos:pos + 2])
        if 0xE0 <= marker <= 0xEF or marker in (0xFE, 0xDC):
            # libjpeg's skip_variable: a length under 2 skips nothing
            body = data[pos + 2:pos + max(n, 2)]
            if len(body) != max(n, 2) - 2:
                if whole:
                    break
                raise ValueError("truncated JPEG segment")
            pos += max(n, 2)
            if marker == 0xE0 and len(body) >= 14 and body[:5] == b"JFIF\0":
                jfif = True
            elif marker == 0xEE and len(body) >= 12 and body[:5] == b"Adobe":
                adobe = body[11]  # the colour transform
            continue
        body = data[pos + 2:pos + n]
        if len(body) != n - 2:
            raise _jpeg_refused("a segment longer than the file, or shorter "
                                "than 2 bytes, in")
        pos += n
        if marker == 0xDB:  # DQT, as libjpeg's get_dqt
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                if tq > 3 or i + 1 + size > len(body):
                    raise _jpeg_refused("a bad quantisation table in")
                zz = np.frombuffer(body, ">u2" if pq else "u1", 64, i + 1)
                q = np.empty(64, np.int64)
                q[_ZIGZAG] = zz
                qt[tq] = q
                i += 1 + size
        elif marker == 0xC4:  # DHT, as libjpeg's get_dht
            i = 0
            while len(body) - i > 16:
                idx = body[i]
                bits = np.frombuffer(body, np.uint8, 16, i + 1)
                nv = int(bits.sum())
                i += 17
                if nv > 256 or nv > len(body) - i:
                    raise _jpeg_refused("a bad Huffman table in")
                t = (4 + idx - 0x10) if idx & 0x10 else idx
                if not (0 <= idx < 4 or 0x10 <= idx < 0x14):
                    raise _jpeg_refused("a Huffman table id past 3 in")
                huff_bits[t] = bits
                huff_vals[t] = 0
                huff_vals[t, :nv] = np.frombuffer(body, np.uint8, nv, i)
                defined.add(t)
                i += nv
            if i != len(body):
                raise _jpeg_refused("a Huffman table segment of the wrong "
                                    "length in")
        elif marker == 0xDD:  # DRI
            if len(body) != 2:
                raise _jpeg_refused("a restart interval of the wrong length "
                                    "in")
            restart, = struct.unpack(">H", body)
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
                # libjpeg-turbo's lossless decoder takes Huffman coding
                # only (JERR_ARITH_NOTIMPL), whatever the data
                raise _jpeg_refused("arithmetic-coded lossless")
            if H == 0 or W == 0:
                raise ValueError("JPEG without a height or width (DNL)")
            progressive = marker in (0xC2, 0xCA)
            lossless = marker == 0xC3
            if marker in (0xC9, 0xCA):
                arith = cond
            comps = [dict(id=body[6 + 3 * k], h=body[7 + 3 * k] >> 4,
                          v=body[7 + 3 * k] & 15, tq=body[8 + 3 * k])
                     for k in range(nc)]
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
            if lossless:   # an MCU of hmax x vmax samples, planes unpadded
                mcux, mcuy = -(-W // hmax), -(-H // vmax)
            planes = [np.zeros((c["h_px"], c["w"]), np.uint16) if lossless
                      else np.zeros((c["bh"], c["bw"], 64), np.int16)
                      for c in comps]
            frame = (H, W, hmax, vmax, mcux, mcuy)
        elif marker == 0xC8:  # the JPEG extension
            raise _jpeg_refused("JPEG-extension")
        elif marker == 0xCC:  # DAC: arithmetic-coding conditioning
            if len(body) % 2:  # get_dac reads a pair on past it, then errs
                raise _jpeg_refused("a conditioning segment of odd length in")
            for i in range(0, len(body) - 1, 2):  # as libjpeg's get_dac
                tc, tb, val = body[i] >> 4, body[i] & 15, body[i + 1]
                if tc > 1 or (tc == 0 and val & 15 > val >> 4):
                    raise _jpeg_refused("bad arithmetic conditioning")
                if tb < 4 and tc == 0:
                    cond[tb], cond[4 + tb] = val & 15, val >> 4
                elif tb < 4:
                    cond[8 + tb] = val
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            if single_scan:  # libjpeg's JERR_EOI_EXPECTED
                raise _jpeg_refused("a scan after a whole sequential scan in")
            ns = body[0]
            if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
                raise _jpeg_refused("a scan header of the wrong length or of "
                                    f"{ns} components in")
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            if not scanned and arith is None and not progressive:
                # libjpeg-turbo's std_huff_tables, when its sequential or
                # lossless decoder starts (not the progressive one): tables
                # 0 and 1 that no DHT has defined are the standard ones
                # (Motion-JPEG leaves them out)
                for t in (0, 1, 4, 5):
                    if t not in defined:
                        huff_bits[t], huff_vals[t] = _JPEG_STD_HUFF[t]
                        defined.add(t)
            # the Huffman tables the scan decodes with (libjpeg builds only
            # these, and refuses a missing one)
            use_dc = not (progressive and (ss != 0 or a >> 4))
            use_ac = not lossless and (not progressive or ss != 0)
            rows, sel = [], []
            for k in range(ns):
                tables = body[2 + 2 * k]
                ci = _scan_component(comps, body[1 + 2 * k], k, sel)
                if arith is not None:
                    if tables >> 4 > 3 or tables & 15 > 3:
                        raise ValueError("corrupt JPEG scan header")
                else:
                    tdc = tables >> 4 if use_dc else 0
                    tac = tables & 15 if use_ac else 0
                    if (use_dc and tdc not in defined) or \
                            (use_ac and 4 + tac not in defined):
                        raise _jpeg_refused("a scan of a missing Huffman "
                                            "table in")
                    tables = tdc << 4 | tac
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
            ah, al = a >> 4, a & 15
            if ns > 1 and sum(comps[i]["h"] * comps[i]["v"] for i in sel) > 10:
                # jdinput.c per_scan_setup: D_MAX_BLOCKS_IN_MCU
                raise _jpeg_refused("an interleaved MCU of more than 10 "
                                    "blocks (or samples) in")
            # a first scan of every component makes a single-scan image
            # (libjpeg's has_multiple_scans): no scan may follow it
            single_scan = not scanned and not progressive and ns == len(comps)
            scanned = True
            if lossless:  # Ss is the predictor, Al the point transform
                if not 1 <= ss <= 7 or se != 0 or ah != 0 or al >= 8:
                    raise _jpeg_refused("bad lossless parameters")
                pos = native.jpeg_decode_lossless(
                    data, pos, [r[0] for r in rows], [planes[i] for i in sel],
                    huff_bits, huff_vals, restart, ss, al,
                    [(r[2], r[3]) for r in rows], frame[4:6])
                whole = _jpeg_whole(data, pos, single_scan)
                continue
            prog = None
            if progressive:  # libjpeg's checks of the scan's band
                if (se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1)) \
                        or (ah != 0 and al != ah - 1) or al > 13:
                    raise _jpeg_refused("bad progression")
                prog = (ss, se, ah, al)
                n_scans += 1
                for ci in sel:   # jdphuff.c / jdarith.c start_pass
                    lo = min(ss, 1)
                    prev_bits[ci][lo:] = coef_bits[ci][lo:] if n_scans > 1 \
                        else 0
                    coef_bits[ci][ss:min(se, 9) + 1] = al
            if arith is not None:
                pos, last_good = native.jpeg_decode_arith_scan(
                    data, pos, np.asarray(rows, np.int32),
                    [planes[i] for i in sel], arith, frame[4], frame[5],
                    restart, prog)
                whole = _jpeg_whole(data, pos, single_scan)
                continue
            if ojpeg:   # libtiff's one sequential scan: the rest unread
                pos, failed = native.ojpeg_decode_scan(
                    data, pos, np.asarray(rows, np.int32),
                    [planes[i] for i in sel], huff_bits, huff_vals,
                    frame[4], frame[5], restart)
                return frame, comps, planes, latched, failed
            pos, last_good = native.jpeg_decode_scan(
                data, pos, np.asarray(rows, np.int32), [planes[i] for i in sel],
                huff_bits, huff_vals, frame[4], frame[5], restart, prog)
            whole = _jpeg_whole(data, pos, single_scan)
    if frame is None:
        raise ValueError("JPEG without a frame header")
    smoothing = None
    if progressive and len(latched) == len(comps) and \
            (coef_bits[:len(comps), 0] >= 0).all() and \
            (coef_bits[:len(comps), 1:] != 0).any() and \
            all(latched[ci][_ZIGZAG[:10]].all() for ci in latched):
        # libjpeg's smoothing_ok: coefficients 1-9 left unfinished are
        # estimated from the neighbouring blocks' DC (block smoothing),
        # with the coef_bits latched now and, for the iMCU rows past the
        # last one the last scan decoded from data, those before it
        prev = prev_bits[:len(comps)].copy() if n_scans > 1 else \
            np.full((len(comps), 10), -1)
        smoothing = (coef_bits[:len(comps)].copy(), prev, last_good)
    return frame, comps, planes, latched, jfif, adobe, lossless, smoothing


# natural positions of zig-zag coefficients 1-9, libjpeg's Q01_POS ...
# Q30_POS: AC01, AC10, AC20, AC11, AC02, AC03, AC12, AC21, AC30
_SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)
# jdcoefct.c decompress_smooth_data's estimates: the weights of the 5 x 5
# window of DC values around a block (two block rows above to two below,
# two columns left to two right) for AC01, AC02, AC03, AC12, AC11 and DC
# (natural positions 1, 2, 3, 10, 9, 0) with DC interpolation on (no AC
# coefficient of 1-9 sent yet); AC10, AC20, AC30 and AC21 take the
# transposed weights of AC01, AC02, AC03 and AC12. With it off only
# AC01-AC02 are estimated, from fewer neighbours.
_SMOOTH_ON = {
    1: [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3],
        [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]],
    2: [[0, 0, 0, 0, 0], [0, 2, -5, 2, 0], [1, 7, -14, 7, 1],
        [0, 2, -5, 2, 0], [0, 0, 0, 0, 0]],
    3: [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, 2, 0, -2, 0],
        [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]],
    10: [[0, 0, 0, 0, 0], [0, 1, -3, 1, 0], [0, 0, 0, 0, 0],
         [0, -1, 3, -1, 0], [0, 0, 0, 0, 0]],
    9: [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0, 0, 0, 0, 0],
        [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]],
    0: [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8],
        [-6, 6, 42, 6, -6], [-2, -6, -8, -6, -2]]}
_SMOOTH_OFF = {
    1: [[0] * 5, [0] * 5, [-7, 50, 0, -50, 7], [0] * 5, [0] * 5],
    2: [[0] * 5, [0] * 5, [-1, 13, -24, 13, -1], [0] * 5, [0] * 5],
    9: [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0] * 5, [1, -10, 0, 10, -1],
        [0, 1, 0, -1, 0]]}
for _t in (_SMOOTH_ON, _SMOOTH_OFF):
    for _k, _v in list(_t.items()):
        _t[_k] = np.array(_v, np.int64)
        if _k in (1, 2, 3, 10):       # AC10, AC20, AC30, AC21
            _t[{1: 8, 2: 16, 3: 24, 10: 17}[_k]] = _t[_k].T
del _t, _k, _v


def _smooth_rows(v, n_imcu, n_blocks):
    """decompress_smooth_data's block rows of one component, in the order
    it outputs them: for each, (its iMCU row, the rows it reads two above,
    one above, itself, one below, two below), libjpeg's arithmetic kept
    (the last iMCU row's block count stands in for v in image_block_row)."""
    out = []
    for r in range(n_imcu):
        if r < n_imcu - 1:
            rows = v
        else:
            rows = n_blocks % v or v
        total = rows * n_imcu            # image_block_rows
        for b in range(rows):
            i, cur = r * rows + b, r * v + b
            up = cur - 1 if i > 0 else cur
            up2 = cur - 2 if i > 1 else up
            dn = cur + 1 if i < total - 1 else cur
            dn2 = cur + 2 if i < total - 2 else dn
            out.append((r, up2, up, cur, dn, dn2))
    return np.array(out, np.int64).reshape(-1, 6)


def _smooth_cols(n_blocks):
    """The columns of the 5-wide DC window of each block column: two to
    each side, the first and last columns repeated past the edges."""
    c = np.arange(n_blocks)
    return np.stack([np.clip(c + k, 0, n_blocks - 1) for k in range(-2, 3)],
                    1)


def _smooth_pred(num, q, al=None):
    """An estimate num / (q * 256) as decompress_smooth_data rounds it (to
    the nearest, halves away from zero), capped at (1 << Al) - 1 where the
    coefficient's last scan had Al > 0 (al [rows], or None: no cap)."""
    pred = ((q << 7) + np.abs(num)) // (q << 8)
    if al is not None:
        cap = (1 << np.maximum(al, 0)) - 1
        pred = np.where((al > 0)[:, None], np.minimum(pred, cap[:, None]),
                        pred)
    return np.where(num >= 0, pred, -pred)


def _block_smoothing(frame, comps, planes, latched, smoothing):
    """libjpeg-turbo's decompress_smooth_data (jdcoefct.c) on the DCT
    planes of a progressive file: in each block, each of coefficients 1-9
    that is still zero and not known to be final (its coefficient bits
    not 0) becomes an estimate from the DC values of the 5 x 5 blocks
    around it; where no AC coefficient of 1-9 has been sent, DC is
    re-estimated too (interpolation). Integer arithmetic on the quantised
    values, each block reading its neighbours' unsmoothed DC; the iMCU
    rows past the last good one take the bits from before each
    component's last scan. `smoothing`: `_jpeg_scans`' (bits, bits before,
    last good iMCU row), or None. Returns the planes to take the IDCT."""
    if smoothing is None:
        return planes
    cur_bits, prev_bits, last_good = smoothing
    out = []
    for ci, c in enumerate(comps):
        plane = planes[ci]
        bw = -(-c["w"] // 8)
        rows = _smooth_rows(c["v"], frame[5], -(-c["h_px"] // 8))
        cols = _smooth_cols(bw)
        dc = plane[..., 0].astype(np.int64)
        # the DC values around each block: [rows, cols, 5, 5]
        win = dc[rows[:, 1:, None, None], cols.T[None, None]].transpose(
            0, 3, 1, 2)
        bits = np.where((rows[:, 0] > last_good)[:, None], prev_bits[ci],
                        cur_bits[ci])                         # [rows, 10]
        interp = (bits[:, 1:] == -1).all(1)
        q = latched[ci].astype(np.int64)
        blk = plane[rows[:, 3], :bw].copy()                   # [rows, cols, 64]
        for k, pos in enumerate(_SMOOTH_POS, 1):
            w = np.where(interp[:, None, None], _SMOOTH_ON[pos],
                         _SMOOTH_OFF.get(pos, 0))             # [rows, 5, 5]
            est = _smooth_pred(q[0] * np.einsum("rcij,rij->rc", win, w),
                               q[pos], bits[:, k])
            use = ((bits[:, k] != 0) & (interp | (k <= 5)))[:, None] & \
                (blk[..., pos] == 0)
            blk[..., pos] = np.where(use, est, blk[..., pos]).astype(np.int16)
        if interp.any():
            est = _smooth_pred(q[0] * np.einsum("rcij,ij->rc", win,
                                                _SMOOTH_ON[0]), q[0])
            blk[..., 0] = np.where(interp[:, None], est,
                                   blk[..., 0]).astype(np.int16)
        p = plane.copy()
        p[rows[:, 3], :bw] = blk
        out.append(p)
    return out


def read_jpeg(data, force_ycc=False, cmyk=False, raw4=False, raw=False):
    """JPEG bytes -> uint8 [H, W, 3], as PIL's convert("RGB") gives them:
    sequential and progressive files of 8-bit samples, Huffman- or
    arithmetic-coded (DAC conditioning), and lossless Huffman files at any
    integral sampling; grey, YCbCr, RGB, CMYK and YCCK, the colour space
    chosen as libjpeg chooses it (JFIF, the Adobe APP14 transform, the
    component ids); PIL's CMYK -> RGB. A progressive file whose scans
    leave any of coefficients 1-9 unfinished goes through libjpeg-turbo's
    block smoothing (`_block_smoothing`). Raises ValueError for what PIL
    refuses too (12- and 16-bit samples, 2 or more than 4 components,
    hierarchical and arithmetic-coded lossless coding, fractional
    sampling, lossless YCbCr) and for a corrupt file. `force_ycc`: the
    file read as YCbCr whatever its markers (libtiff asks for it);
    `cmyk`: a 4-component file's samples as libjpeg gives them for
    JCS_CMYK (uint8 [H, W, 4]; a YCCK file converted to CMYK). `raw4`: a
    4-component file's samples with libjpeg told that the file is CMYK (no
    YCCK conversion, whatever its Adobe transform). `raw`: every
    component's samples with no colour conversion (libtiff's
    JCS_UNKNOWN), uint8 [H, W, components]."""
    frame, comps, planes, latched, jfif, adobe, lossless, smoothing = \
        _jpeg_scans(data)
    planes = _block_smoothing(frame, comps, planes, latched, smoothing)
    H, W, hmax, vmax = frame[:4]
    if lossless:
        if any(ci not in latched for ci in range(len(comps))):
            raise ValueError("a lossless JPEG component without a scan: PIL "
                             "(libjpeg-turbo) refuses it too")
        # each component replicated up to full size (libjpeg does no fancy
        # upsampling of lossless samples, one to a "block")
        planes = [np.repeat(np.repeat(p, vmax // c["v"], 0), hmax // c["h"],
                            1)[:H, :W] for p, c in zip(planes, comps)]
        if force_ycc:   # libjpeg converts no colour in lossless mode
            raise _jpeg_refused("lossless YCbCr")
        if raw or (raw4 and len(comps) == 4):
            return _lossless_rgb(planes, latched, jfif, None, True, raw)
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
    if raw:
        return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)
    if len(comps) == 1:
        return np.repeat(out[0][..., None].astype(np.uint8), 3, axis=-1)
    if raw4 and len(comps) == 4:
        return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)
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


def jpeg_coefficients(data):
    """A DCT JPEG's components as ((h, v) its sampling factors, int64
    [rows, cols, 64] its dequantised coefficients in natural order): the
    input of the IDCT (ROADMAP C19)."""
    frame, comps, planes, latched, *_, smoothing = _jpeg_scans(data)
    planes = _block_smoothing(frame, comps, planes, latched, smoothing)
    return [((c["h"], c["v"]), planes[ci].astype(np.int64) *
             latched.get(ci, np.zeros(64, np.int64)))
            for ci, c in enumerate(comps)]


# zig-zag position k -> natural (row-major) index
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


# ---------------------------------------------------------------------------
# TIFF (as PIL's TiffImagePlugin and libtiff read it)
# ---------------------------------------------------------------------------

# libtiff's CCITT codecs: RLE, Group 3, Group 4 and RLEW (PIL's
# "tiff_raw_16")
TIFF_FAX = (2, 3, 4, 32771)


def _pil_bomb_check(w, h):
    """PIL refuses an image of more than twice its MAX_IMAGE_PIXELS
    (89,478,485) pixels as a decompression bomb."""
    if w * h > 2 * 89478485:
        raise ValueError(f"an image of {w} x {h} pixels: PIL refuses it as "
                         "a decompression bomb")


def _tiff_refused(what):
    return ValueError(f"TIFF {what} (PIL refuses it too)")


def _tiff_mode(bo, photo, sf, fill, bps, extra):
    """The subset of PIL's OPEN_INFO decoded here: (kind, bits) or None
    where PIL has no mode. kind: "grey" (inverted for photometric 0),
    "u16" (clipped at 255), "s16" / "s32" / "u32" (clipped to 0..255, the
    last read as signed), "float" (truncated, clipped), "la", "rgb",
    "rgba" (extra samples dropped), "rgba_assoc" (alpha undone), "rgb16"
    (high bytes), "pal", "cmyk", "cmyk16", "ycbcr", "lab" (CIELab, a* and
    b* signed)."""
    n = len(bps)
    if n == 0:
        return None
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
        if b0 == 12 and sf == (1,) and photo == 1 and bo == "<":
            return "u16", 12                  # raw mode I;12 -> I;16
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
    if photo == 8 and bps == (8, 8, 8) and not extra:
        return "lab", 8
    return None


_BIT_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                        np.uint8)


def _tiff_codec_setup(d):
    """libtiff's setup of the decoder of directory d (its codec's
    SetupDecode): ValueError where it fails, as the library then refuses
    every strip."""
    comp = d.compression
    if comp in TIFF_FAX and d.bps != 1:
        raise tiffdir._refused(f"CCITT of {d.bps}-bit samples")
    if comp == 32766 and d.bps != 2:
        raise tiffdir._refused(f"NeXT of {d.bps}-bit samples")
    if comp == 32809 and d.bps != 4:
        raise tiffdir._refused(f"ThunderScan of {d.bps}-bit samples")
    if comp in (34676, 34677) and d.photometric not in (32844, 32845):
        raise tiffdir._refused(f"SGILog of photometric {d.photometric}")
    if comp == 50001:
        # PIL 12.1.0's libtiff (and the pip cv2's) has no WebP codec
        raise ValueError("TIFF of WebP compression: PIL's libtiff has no "
                         "WebP codec, so PIL refuses it too")


def _tiff_decode(d, k, n, keep=False):
    """Strip or tile k of directory d, its stored bytes -> (its n decoded
    bytes, whether libtiff's codec gave all n without an error), the fill
    order undone first. Where it did not: with `keep` the bytes the codec
    gave before its error and zeros after, else n zeros. The caller
    refuses the file where its library does."""
    raw, comp = d.chunk(k), d.compression
    if d.fill == 2:
        raw = _BIT_REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
    good = True
    if comp == 1:
        out = raw[:n] if len(raw) >= n else b""
    elif comp == 5:
        out, good = _tiff_lzw(raw, n)
    elif comp in (8, 32946):
        out, good = _tiff_inflate(raw, n)
    elif comp == 32773:
        out = native.packbits_decode(raw, n).tobytes()
    elif comp in TIFF_FAX:
        out, good = _tiff_fax(d, k, raw, n)
    elif comp == 34925:
        out, good = _tiff_lzma(raw, n)
    elif comp == 50000:
        out, good = native.zstd_decode(raw, n)
        out = out.tobytes()
    elif comp == 32809:
        out, good = native.thunder_decode(raw, n, d.width, d.chunk_size(1))
        out = out.tobytes()
    elif comp in (34676, 34677):
        out, good = _tiff_sgilog(d, raw, n)
    else:
        out = b""
    ok = good and len(out) == n
    return (out[:n] if ok or keep else b"").ljust(n, b"\0"), ok


def _tiff_fax(d, k, raw, n):
    """libtiff's CCITT decoders (tif_fax3.c) of one strip or tile: (every
    row as far as the codec wrote it, whether it succeeded). A Group 4 or
    Group 3 strip whose data ends before its last row (Group 3 2-D: while
    looking for a row's EOL) succeeds in libtiff with its later rows never
    written: the library's image there is whatever its buffer held, so
    such a strip is refused (ROADMAP C28)."""
    cols = d.tile[0] if d.tile else d.width
    rowbytes = d.chunk_size(1)
    opts = d.t4options if d.compression == 3 else 0
    if d.fax_runs is None:
        d.fax_runs = native.fax_runs(cols, d.compression == 4 or opts & 1)
    out, rc, done = native.fax_decode(raw, n, cols, rowbytes, d.compression,
                                      opts, d.fax_runs, d.offsets[k] & 1)
    if rc == 2 and done * rowbytes < n:
        raise tiffdir._refused("CCITT strip whose data ends before its last "
                               "row (libtiff succeeds, its rows after are "
                               "undefined: ROADMAP C28)")
    return out.tobytes(), rc in (1, 2)


def _tiff_sgilog(d, raw, n):
    """libtiff's SGILog row decoders (tif_luv.c) of one strip or tile ->
    (its codes as native uint32 bytes, n // 4 of them in rows of the
    chunk's width, as far as whole rows decoded; whether every row did):
    LogL16 for LogL, LogLuv32 for SGILog, LogLuv24 for SGILog24. A row
    whose data runs out fails the strip ("Not enough data")."""
    cols = d.tile[0] if d.tile else d.width
    rows = n // (4 * cols)
    kind = 16 if d.photometric == tiffdir.LOGL else \
        32 if d.compression == 34676 else 24
    codes, done = native.sgilog_decode(raw, cols, rows, kind)
    return codes[:done].tobytes(), done == rows


def _tiff_lzma(raw, n):
    """libtiff's LZMADecode: an .xz stream -> (at most n bytes, whether
    liblzma gave all n before any error). After an error the stream is
    decoded again a byte of output at a time, which keeps every byte
    liblzma gave before it."""
    z = lzma.LZMADecompressor(lzma.FORMAT_XZ)
    try:
        out = z.decompress(raw, n)
        return out, len(out) == n
    except lzma.LZMAError:
        pass
    z, out, data = lzma.LZMADecompressor(lzma.FORMAT_XZ), bytearray(), raw
    try:
        while len(out) < n:
            b = z.decompress(data, 1)
            data = b""
            if not b:
                break
            out += b
    except lzma.LZMAError:
        pass
    return bytes(out), len(out) == n


def _tiff_lzw(raw, n):
    """libtiff's LZW (new style, or old style where the data starts 0x00
    and an odd byte) -> (at most n bytes, whether it decoded without an
    error). libtiff's decoder fails on a first code other than the clear
    code (its table has no entry before it), before any output."""
    msb = not (len(raw) >= 2 and raw[0] == 0 and raw[1] & 1)
    if len(raw) < 2:
        return b"", False
    first = (raw[0] << 1 | raw[1] >> 7) if msb else (raw[0] | (raw[1] & 1) << 8)
    if first != 256:
        return b"", False
    out, ok = native.lzw_decode(raw, n, 8, msb)
    return out.tobytes(), ok


def _tiff_inflate(raw, n):
    """libtiff's ZIPDecode -> (at most n bytes, whether inflate gave them
    without an error). inflate goes on past the last byte that fills the
    strip to the stream's end and its checksum, where those come next; on
    an error the bytes it gave before it (fed a byte at a time)."""
    z = zlib.decompressobj()
    try:
        out = z.decompress(raw, n)
        if len(out) == n:
            z.decompress(z.unconsumed_tail, 1)
        return out, True
    except zlib.error:
        pass
    z, out = zlib.decompressobj(), b""
    for i in range(len(raw)):
        if len(out) >= n:
            break
        try:
            out += z.decompress(raw[i:i + 1], n - len(out))
        except zlib.error:
            break
    return out[:n], False


def _tiff_samples(buf, rows, width, spp, bits, bo):
    """Decoded bytes of `rows` rows -> samples [rows, width, spp] (numbers
    in their type; sub-byte samples unpacked, each row padded to a
    byte)."""
    if bits not in (8, 16, 32):
        # packed most significant bit first (PIL's I;12 too)
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
    applied; classic TIFF and BigTIFF in either byte order under PIL's six
    headers, strips or tiles, chunky or planar; no compression, PackBits,
    LZW (old-style too), Deflate, LZMA, ZSTD, CCITT RLE / RLEW / Group 3 /
    Group 4, ThunderScan, JPEG (with JPEGTables; YCbCr decoded to RGB as
    libtiff's JPEG colour mode asks; CMYK; planar) and old-style JPEG (its
    JPEGInterchangeFormat stream or its tables, strips, tiles, planes, a
    YCbCr file through libtiff's RGBA reader, a grey one strip by strip:
    `ojpeg.read`); predictors 1, 2 and 3;
    1-, 2-, 4-, 8-, 12- and 16-bit integer and 32-bit integer and float
    samples; min-is-white / min-is-black, RGB(A) with extra samples
    (associated alpha undone as PIL does), palette, CMYK, CIELab (PIL's
    LAB through LittleCMS), YCbCr (uncompressed as PIL's raw mode RGBX
    reads it, compressed through libtiff's RGBA reader); fill order 2.
    16-bit samples reach 8 bits as PIL's modes take them (grey clipped at
    255, colour cut to the high byte), floats truncated and clipped. The
    directory is read as PIL reads it, and for a compressed file as
    libtiff reads it too (`tiffdir`; edited files: ROADMAP C26, C28). What
    PIL has no mode for raises ValueError (or passes the file on to PIL's
    next plugin), as does what PIL's libtiff refuses (SGILog outside LogL /
    LogLuv, which PIL has no mode for, WebP, which it lacks, and what its
    OJPEG codec refuses)."""
    if data[:4] not in pilread.TIFF_PREFIXES:
        raise ValueError("not a TIFF file")
    # PIL takes the byte order from bytes 0-1 and BigTIFF from byte 2
    bo = "<" if data[:2] == b"II" else ">"
    big = data[2] == 43
    if len(data) < (16 if big else 8):
        raise pilread._PassOn                 # the header's struct.error
    ptags = tiffdir.pil_ifd(data, bo, big)
    st = tiffdir.PilSetup(ptags)
    comp = st.compression
    w, h = st.xsize, st.ysize
    photo, bps, sf, extra, fill = st.photo, st.bps, st.sample_format, \
        st.extra, st.fill
    mode = _tiff_mode(bo, photo, sf, fill, bps, extra)
    if mode is None:                          # OPEN_INFO has no key for it
        raise pilread._PassOn
    kind, bits = mode
    if kind in ("pal",) and 320 not in ptags:
        raise pilread._PassOn                 # tag_v2[COLORMAP]: KeyError
    if w <= 0 or h <= 0:
        raise pilread._PassOn                 # no pixels
    _pil_bomb_check(w, h)
    spp = len(bps)
    planar = st.planar == 2
    tags = {320: tuple(ptags.get(320, ()))}
    if comp == 1:
        chunks = [(x0, y0, x1 - x0, y1 - y0, plane, off, stride)
                  for x0, y0, x1, y1, plane, off, stride
                  in tiffdir.pil_strips(ptags, st)]
        pred, tables = 1, b""
    else:
        d = tiffdir.LibtiffDir(data, bo)
        _tiff_codec_setup(d)
        # libtiff's OJPEG hack makes one planar strip contiguous; PIL
        # reads such a file through libtiff whatever its planarity
        if (d.width, d.length) != (w, h) or (d.planar != st.planar and
                                             comp != 6) or \
                d.spp != spp or d.bps != bits or d.fill != fill:
            raise _tiff_refused("whose directory libtiff reads otherwise "
                                "than PIL")
        if kind == "ycbcr" and comp != 7 and d.photometric != 6:
            # PIL unpacks RGBX rows from libtiff's RGBA interface, which
            # libtiff takes only for its own YCbCr: shorter rows refused
            raise _tiff_refused("YCbCr to PIL and not to libtiff")
        # libtiff runs the predictor in its LZW and Deflate codecs only
        pred = d.predictor
        if pred not in (1, 2, 3) or (pred == 2 and bits not in (8, 16, 32)) \
                or (pred == 3 and (d.sample_format != 3 or bits not in
                                   (16, 24, 32, 64))):
            raise _tiff_refused(f"predictor {pred} (libtiff refuses it)")
        tables = d.jpegtables or b""
        tags[530] = tuple(d.subsampling)
        chunks = [c + (0,) for c in d.chunks()]
    if comp == 6:
        return ojpeg.read(d, kind)
    if comp == 7 and kind not in ("ycbcr", "rgb", "grey", "cmyk"):
        raise _tiff_refused(f"JPEG of PIL's mode for {kind} samples")
    if kind == "ycbcr" and (comp not in (1, 7) or (comp == 7 and planar)):
        # PIL reads it through libtiff's RGBA reader, which converts it
        return _tiff_rgba_ycbcr(d)
    # PIL's planar unpackers: one band's raw mode each, none for padding
    # (X) and, reading without libtiff, none for associated alpha or LA's
    if planar and (extra == (0,) or (comp == 1 and (
            extra == (1,) or kind == "la"))):
        raise _tiff_refused("planar file of this band layout")
    read = None
    if planar and comp == 1 and bits > 8:
        # PIL's raw decoder reads each plane with the unpacker of its raw
        # mode's letter: R, G, B, A, C, M, Y, K copy bytes; I and F read
        # native (little-endian) 32-bit words; no other mode has one
        read = {"rgb16": "u1", "cmyk16": "u1", "s16": "<i4", "u32": "<i4",
                "s32": "<i4", "float": "<f4"}.get(kind)
        if read is None:
            raise _tiff_refused(f"planar file of {bits}-bit {kind} samples")
        kind = {"rgb16": "rgb", "cmyk16": "cmyk"}.get(kind, kind)
        if read == "<i4" and kind == "s16":
            kind = "s32"
    if kind == "ycbcr" and comp == 1 and not planar:
        # PIL's raw mode RGBX: four bytes a pixel, the YCbCr bytes taken
        # as R, G and B
        read = "rgbx"
    # reading without libtiff, PIL has no unpacker for the raw modes
    # P;1R, P;2R, P;4R and L;IR (fill order 2)
    if comp == 1 and fill == 2 and ((kind == "pal" and bits < 8) or (
            kind == "grey" and photo == 0 and bits == 8)):
        raise _tiff_refused(f"{bits}-bit {kind} file of fill order 2")
    if pred == 3 and not (kind == "float" and comp != 7):
        raise _tiff_refused("floating-point predictor on integer samples")
    cs = 1 if planar else spp                 # samples in a chunk's pixel
    dt = {"float": "f4", "s32": "i4", "u32": "i4"}.get(kind)
    out = np.zeros((h, w, spp), np.float64 if kind == "float" else np.int64)
    for x0, y0, tw, rows, plane, where, stride in chunks:
        line = -(-tw * cs * bits // 8)
        if read is not None:
            line = tw * (4 if read == "rgbx" else np.dtype(read).itemsize)
            buf = _tiff_raw(data, where, rows, line, stride or line, fill)
            if read == "rgbx":
                v = np.frombuffer(buf, np.uint8).reshape(rows, tw, 4)[
                    ..., :3].astype(np.int64)
            else:
                v = np.frombuffer(buf, read).reshape(rows, tw, 1)
                v = v.astype(np.float64 if read == "<f4" else np.int64)
        elif comp == 1:
            # PIL's raw decoder: `rows` lines of `line` bytes, one every
            # `stride` (or `line`) bytes from the offset
            buf = _tiff_raw(data, where, rows, line, stride or line, fill)
        elif comp == 7:
            # a plane's JPEG data is one grey component
            v = _tiff_jpeg(d.chunk(where), tables,
                           "grey" if planar else kind, tags)
            v = v[:rows, :tw, :cs].astype(np.int64)
        else:
            buf, ok = _tiff_decode(d, where, rows * line)
            if not ok:
                raise _tiff_refused("strip or tile that libtiff fails to "
                                    "decode")
        if comp != 7 and read is None:
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
                    # libtiff hands PIL native (little-endian) words,
                    # which PIL's big-endian raw mode reads swapped
                    v = v.astype(dt).byteswap()
                with np.errstate(invalid="ignore"):
                    v = v.astype(np.float64 if kind == "float" else np.int64)
            else:
                v = _tiff_samples(buf, rows, tw, cs, bits, bo_chunk)
                if pred == 2:
                    v = _undo_predictor(v, bits)
                if kind == "s16" and bo == ">" and comp != 1:
                    # PIL's big-endian signed raw mode reads libtiff's
                    # native words swapped, as above
                    v = (v & 0xFF) << 8 | v >> 8
        ye, xe = min(h, y0 + rows), min(w, x0 + tw)
        sl = slice(plane, plane + 1) if planar else slice(None)
        out[y0:ye, x0:xe, sl] = v[:ye - y0, :xe - x0]
    if kind == "lab" and not planar:
        # PIL's raw mode LAB flips a* and b*'s sign bits into its LAB
        # mode's offset bytes (LittleCMS's); its planar bands A and B copy
        # the bytes as they are
        out ^= np.array([0, 128, 128])
    return _tiff_to_rgb(out, kind, bits, photo, tags)


def _tiff_rgba_ycbcr(d):
    """A YCbCr file that is neither uncompressed nor chunky JPEG, as PIL
    reads it through libtiff's RGBA reader (TIFFReadRGBAStrip / Tile,
    which goes on past a codec's error): its YCbCr conversion, uint8 [H,
    W, 3]."""
    if not cvtiff.ycbcr_has_routine(d):
        raise _tiff_refused("YCbCr of a layout libtiff's RGBA reader has "
                            "no routine for")
    return cvtiff.ycbcr_to_rgb(d, cvtiff.ycbcr_units(d)).astype(np.uint8)


def _tiff_raw(data, off, rows, line, pitch, fill):
    """An uncompressed strip or tile as PIL's raw decoder reads it:
    `rows` lines of `line` bytes, one every `pitch` bytes from `off`; a
    file that ends before the last line is refused (PIL: "image file is
    truncated")."""
    if type(off) is not int or off < 0 or \
            len(data) < off + (rows - 1) * pitch + line:
        raise _tiff_refused("strip or tile cut by the file's end")
    raw = np.lib.stride_tricks.as_strided(
        np.frombuffer(data, np.uint8, offset=off), (rows, line), (pitch, 1),
        writeable=False)
    if fill == 2:
        raw = _BIT_REVERSE[raw]
    return raw.tobytes()


def _tiff_jpeg(strip, tables, kind, tags):
    """A JPEG-compressed strip or tile -> int samples [rows, cols, n]: the
    JPEGTables' segments before the strip's own, read as libtiff's JPEG
    codec reads them: its data source feeds an EOI marker wherever the
    strip runs out; component 0 sampled as YCbCrSubsampling says (1x1
    unless YCbCr) and the others 1x1; a YCbCr file's colour converted to
    RGB (JPEGCOLORMODE_RGB, as PIL asks), any other's samples as they are
    (JCS_UNKNOWN: no JFIF or Adobe colour conversion)."""
    if tables[:2] == b"\xff\xd8" and strip[:2] == b"\xff\xd8":
        end = tables.rfind(b"\xff\xd9")
        strip = tables[:end if end > 0 else len(tables)] + strip[2:]
    sub = tuple(tags.get(530, (2, 2))[:2]) if kind == "ycbcr" else (1, 1)
    got = _jpeg_sampling(strip)
    if got[:1] != [sub] or any(hv != (1, 1) for hv in got[1:]):
        raise _tiff_refused(f"JPEG data sampled {got} where libtiff wants "
                            f"{sub} and 1x1")
    try:
        try:
            return read_jpeg(strip + b"\xff\xd9", force_ycc=kind == "ycbcr",
                             raw=kind != "ycbcr")
        except ValueError:
            # cut inside a marker segment, which reads on into the EOIs;
            # a decode that did not read past the first EOI is the same
            return read_jpeg(strip + b"\xff\xd9" * 32769,
                             force_ycc=kind == "ycbcr", raw=kind != "ycbcr")
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
    if kind == "lab":
        return pilread.lab_to_rgb(v[..., :3])
    raise AssertionError(kind)


# ---------------------------------------------------------------------------
# GIF (as PIL's GifImagePlugin reads frame 0)
# ---------------------------------------------------------------------------

def _gif_blocks(data, pos, whole=False):
    """Data sub-blocks from `pos` -> (their bytes, the offset after the
    terminator, whether the terminator was found). `whole`: a sub-block
    the file's end cuts is left out."""
    out = bytearray()
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            return bytes(out), pos, True
        if whole and pos + n > len(data):
            break
        out += data[pos:pos + n]
        pos += n
    return bytes(out), pos, False


def _gif_narrow_codes(lzw, n_px, bits):
    """PIL's GIF decoder (GifDecode.c) for LZW minimum code sizes 0 and 1:
    its table's first free entry starts past the code mask, so the codes
    never widen from bits + 1, and every code is a literal (an index), the
    clear code or, for 1, the end code -> the indices up to the end code
    (at most n_px)."""
    width = bits + 1
    b = np.unpackbits(np.frombuffer(lzw, np.uint8), bitorder="little")
    b = b[:len(b) // width * width].reshape(-1, width)
    codes = (b.astype(np.int64) << np.arange(width)).sum(-1)
    end = np.nonzero(codes == (1 << bits) + 1)[0]
    if len(end):
        codes = codes[:end[0]]
    return codes[codes < 1 << bits][:n_px].astype(np.uint8)


def read_gif(data):
    """GIF bytes -> uint8 [H, W, 3], frame 0 as PIL's convert("RGB") gives
    it: the local colour table, else the global one (indices past it
    black; no table: the index as grey), interlaced rows, LZW minimum code
    sizes 0-12 (least significant bit first, `csrc/image_codecs.cpp`; 0
    and 1 as PIL's decoder reads them, `_gif_narrow_codes`); a
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
            if pos >= len(data):
                raise ValueError("GIF cut in an extension: PIL refuses it")
            label = data[pos]
            # PIL reads the graphic control from the first sub-block only
            n = data[pos + 1] if pos + 1 < len(data) else 0
            first = data[pos + 2:pos + 2 + n]
            if label == 0xF9 and n:
                if len(first) < 3 or (first[0] & 1 and len(first) < 4):
                    raise ValueError("GIF graphic control block too short: "
                                     "PIL refuses it")
                if first[0] & 1:
                    trans = first[3]
            _, pos, _ = _gif_blocks(data, pos + 1)
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
        # any other byte is skipped, as PIL skips it
    if pos >= len(data):
        raise ValueError("truncated GIF image: PIL refuses it too")
    bits = data[pos]
    if bits > 12:
        raise ValueError(f"GIF LZW minimum code size {bits}: PIL refuses "
                         "it")
    # PIL's decoder takes a sub-block only once the whole of it is there
    lzw, _, _ = _gif_blocks(data, pos + 1, whole=True)
    W, H = max(sw, x0 + fw), max(sh, y0 + fh)
    _pil_bomb_check(W, H)
    if fw == 0 and x0 == 0:
        # PIL's setimage reads extents with x0 == x1 == 0 as the whole image
        x0, y0, fw, fh = 0, 0, W, H
    elif fw == 0 or fh == 0:
        raise ValueError("GIF frame of no pixels: PIL refuses it (tile "
                         "cannot extend outside image)")
    n_px = fw * fh
    if bits < 2:
        idx = _gif_narrow_codes(lzw, n_px, bits)
    else:
        idx, ok = native.lzw_decode(lzw, n_px, bits, msb=False)
        if not ok:
            raise ValueError("corrupt GIF LZW data: a code not yet in the "
                             "table")
    if len(idx) < n_px:
        raise ValueError("truncated GIF image data: PIL refuses it too")
    frame = idx.reshape(fh, fw)
    if fl & 0x40:                                # interlaced rows
        order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                np.arange(2, fh, 4), np.arange(1, fh, 2)])
        inter = np.empty_like(frame)
        inter[order] = frame
        frame = inter
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


# attribute types libOpenEXR reads with their own size: the size a file
# states is not used to find the next attribute (TypedAttribute's
# readValueFrom)
_EXR_FIXED = {"box2i": 16, "box2f": 16, "chromaticities": 32,
              "compression": 1, "double": 8, "envmap": 1, "float": 4,
              "int": 4, "keycode": 28, "lineOrder": 1, "m33f": 36,
              "m33d": 72, "m44f": 64, "m44d": 128, "rational": 8,
              "tiledesc": 9, "timecode": 8, "v2i": 8, "v2f": 8, "v2d": 16,
              "v3i": 12, "v3f": 12, "v3d": 24, "deepImageState": 1}
# the attributes every Header starts with (Imf::Header's constructor),
# with their types and default values
_EXR_PREDEFINED = {
    "displayWindow": ("box2i", struct.pack("<4i", 0, 0, 63, 63)),
    "dataWindow": ("box2i", struct.pack("<4i", 0, 0, 63, 63)),
    "pixelAspectRatio": ("float", struct.pack("<f", 1.0)),
    "screenWindowCenter": ("v2f", struct.pack("<2f", 0.0, 0.0)),
    "screenWindowWidth": ("float", struct.pack("<f", 1.0)),
    "lineOrder": ("lineOrder", b"\0"),
    "compression": ("compression", b"\3"),
    "channels": ("chlist", b"\0")}


def _exr_name(data, pos):
    """Xdr::read of a name: at most 255 bytes, then its null byte."""
    end = data.find(b"\0", pos, pos + 256)
    if end < 0:
        raise ValueError("OpenEXR attribute name without its null byte")
    return data[pos:end].decode("latin-1"), end + 1


def _exr_attrs(data, pos):
    """One header's attributes from `pos`, as Imf::Header::readFrom reads
    them -> (dict name -> (type, body), the offset after the header's
    terminating null byte). A predefined attribute (Imf::Header's own)
    keeps its default unless the file gives it, and must keep its type;
    a value of a fixed-size type takes that size whatever size the file
    states; a channel list runs to its empty name."""
    attrs = dict(_EXR_PREDEFINED)
    while True:
        if pos >= len(data):
            raise ValueError("truncated OpenEXR header")
        name, pos = _exr_name(data, pos)
        if not name:
            return attrs, pos
        typ, pos = _exr_name(data, pos)
        if len(data) < pos + 4:
            raise ValueError("truncated OpenEXR header")
        size, = struct.unpack("<i", data[pos:pos + 4])
        pos += 4
        if size < 0:
            raise ValueError("OpenEXR attribute of a negative size")
        if name in _EXR_PREDEFINED and typ != _EXR_PREDEFINED[name][0]:
            raise ValueError(f"OpenEXR attribute '{name}' of type '{typ}'")
        if typ in _EXR_FIXED:
            size = _EXR_FIXED[typ]
        elif typ == "chlist":
            end = pos
            while True:
                cname, end = _exr_name(data, end)
                if not cname:
                    break
                end += 16
            size = end - pos
        body = data[pos:pos + size]
        if len(body) < size:
            raise ValueError("truncated OpenEXR header")
        attrs[name] = (typ, body)
        pos += size


def _exr_sanity(attrs, tiled):
    """Imf::Header::sanityCheck as libOpenEXR 3.1 makes it."""
    half = (1 << 31) // 2 - 1                      # INT_MAX / 2
    for win in ("displayWindow", "dataWindow"):
        x0, y0, x1, y1 = struct.unpack("<4i", attrs[win][1])
        if x0 > x1 or y0 > y1 or min(x0, y0) <= -half or max(x1, y1) >= half:
            raise ValueError(f"OpenEXR {win} invalid")
    par, = struct.unpack("<f", attrs["pixelAspectRatio"][1])
    if not 1e-6 <= par <= 1e6:
        raise ValueError("OpenEXR pixel aspect ratio invalid")
    if struct.unpack("<f", attrs["screenWindowWidth"][1])[0] < 0:
        raise ValueError("OpenEXR screen window width invalid")
    if attrs["lineOrder"][1][0] > 2:
        raise ValueError("OpenEXR line order invalid")
    if attrs["compression"][1][0] > 9:
        raise ValueError("OpenEXR compression invalid")
    if tiled:
        tiles = attrs.get("tiles")
        if tiles is None or tiles[0] != "tiledesc":
            raise ValueError("tiled OpenEXR file without its tile size")
        tx, ty, mode = struct.unpack("<iiB", tiles[1])
        if not (0 < tx <= half // 2 and 0 < ty <= half // 2) or \
                mode & 15 > 2 or mode >> 4 > 1:
            raise ValueError("OpenEXR tile description invalid")


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
    if version & 0xFF != 2 or version & ~0x1EFF:
        raise ValueError("OpenEXR file of another version or flags")
    multipart = bool(version & 0x1000)
    try:
        attrs, pos = _exr_attrs(data, 8)
        if multipart:                    # skip the other parts' headers
            while data[pos] != 0:
                pos = _exr_attrs(data, pos)[1]
            pos += 1
        part_type = attrs.get("type", ("", b""))[1].rstrip(b"\0")
        _exr_sanity(attrs, bool(version & 0x200 and not multipart)
                    or part_type == b"tiledimage")
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
    entries, pos = {}, 0
    while body[pos] != 0:      # a map by name: the last entry of a name kept
        name, pos = _cstr(body, pos)
        entries[name] = struct.unpack("<iB3xii", body[pos:pos + 16])
        pos += 16
    chans = []
    for name in sorted(entries, key=lambda n: n.encode("latin-1")):
        ptype, plinear, xs, ys = entries[name]
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
    channels stored as they are. Bytes left over are refused, as
    libOpenEXR refuses them."""
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
    if pos < len(block):       # B44Compressor::uncompress's tooMuchData
        raise ValueError("OpenEXR B44 data longer than its block")
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
    version = struct.unpack("<i", data[4:8])[0]
    tiled = bool(version & 0x200 and not multipart) or \
        attrs.get("type", ("", b""))[1].rstrip(b"\0") == b"tiledimage"
    tiles = attrs.get("tiles") if tiled else None
    deep = _exr_deep(attrs, version, multipart)
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
                                 linear, x0, y0, w, h,
                                 attrs["lineOrder"][1][0])
    else:
        planes = _exr_read_tiles(data, pos, skip, comp, chans, sampling,
                                 linear, tiles[1], w, h)
    return _exr_opencv(planes, sampling, attrs, (x0, y0), h, w)


def _exr_planes(chans, sampling, w, h):
    """Zeroed float32 planes, each channel at its own sampling."""
    return {c: np.zeros((h // sampling[c][1], w // sampling[c][0]),
                        np.float32) for c, _ in chans}


def _exr_line_offsets(data, pos, n, skip, order):
    """The chunk offset table at `pos` as ScanLineInputFile reads it: a
    table with a zero entry is rebuilt from a walk over the chunks that
    follow it (readLineOffsets, reconstructLineOffsets)."""
    offsets = list(_exr_chunks(data, pos, n))
    if min(offsets) > 0:
        return offsets
    at = pos + 8 * n
    for i in range(n):
        if len(data) < at + skip + 8:
            break
        size, = struct.unpack("<i", data[at + skip + 4:at + skip + 8])
        offsets[i if order == 0 else n - 1 - i] = at
        at += skip + 8 + size
    return offsets


def _exr_read_lines(data, pos, skip, comp, chans, sampling, linear, x0, y0,
                    w, h, order=0):
    """A scanline part's chunks -> its float32 channel planes, read as
    ScanLineInputFile reads them from the top: each chunk from its table
    offset, but a file of increasing y from the first one on chunk after
    chunk (it seeks only when the next chunk is not the one that follows);
    a chunk must hold its own y and at most a full buffer's bytes."""
    planes = _exr_planes(chans, sampling, w, h)
    lines = _EXR_LINES[comp]
    n = -(-h // lines)
    offsets = _exr_line_offsets(data, pos, n, skip, order)
    # lineBufferSize: the most bytes a line holds, times the lines a chunk
    limit = lines * sum(nx * dt.itemsize for _, dt, nx, _ in
                        _exr_geometry(chans, sampling, x0, w, 0, 1))
    at = None
    for k in range(n):
        if at is None or order != 0:
            at = offsets[k]
            if at == 0:
                raise ValueError("OpenEXR scan line missing")
        try:
            y, size = struct.unpack("<ii", data[at + skip:at + skip + 8])
        except struct.error:
            raise ValueError("truncated OpenEXR chunk") from None
        ny = min(lines, h - k * lines)
        geo = _exr_geometry(chans, sampling, x0, w, y0 + k * lines, ny)
        if y != y0 + k * lines or not 0 <= size <= limit:
            raise ValueError("corrupt OpenEXR chunk header")
        block = data[at + skip + 8:at + skip + 8 + size]
        if len(block) < size:
            raise ValueError("truncated OpenEXR chunk")
        _exr_put(planes, _exr_block(comp, block, geo, ny, linear), geo,
                 k * lines, 0, sampling)
        at += skip + 8 + size
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
