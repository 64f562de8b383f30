"""The files the JAX package reads through PIL, identified as PIL 12.1.0
identifies them, and the small formats of its plugins decoded as
`PIL.Image.open(p).convert("RGB")` decodes them: the counterpart of
`cvread.py` for PIL's rules.

`Image.open` walks its plugins in the order of `Image.ID` (the six that
`Image.preinit` registers, BMP, DIB, GIF, JPEG, PPM and PNG, then the rest
in the order `Image.init` imports them). Each plugin with an `_accept`
function is tried only on the files its test takes (the first 16 bytes);
the others (IM, IMT, IPTC, PCD, SPIDER, TGA) read their header. A plugin
whose header reading raises IndexError, TypeError, KeyError, EOFError,
struct.error or SyntaxError, or gives an image of no mode or of no pixels,
passes the file on to the next one (`PIL/Image.py` `_open_core`,
`PIL/ImageFile.py` `ImageFile.__init__`); any other error is PIL's
refusal. `read` walks the same order (`_PLUGINS`) and returns uint8
[H, W, 3], or raises

  * ValueError where PIL raises: no plugin takes the file; a plugin takes
    it and refuses it (its header, its data, or a handler PIL has not here:
    EPS without Ghostscript, the BUFR, GRIB and HDF5 stubs, MPEG, WMF);
  * NotImplementedError naming ROADMAP queue A's item where PIL decodes
    a variant this package does not yet: AVIF's CDEF, loop restoration,
    delta q / lf and quantiser matrices (7e.8a.2b), superres and film
    grain (7e.8a.2c.2), grid items, 10/12-bit samples and image sequences
    (7e.8a.3).

Decoded here, each as its plugin and its decoder in libImaging read it,
then through `convert("RGB")` of the mode it gives (`_rgb`): PNM and PFM
(`PpmImagePlugin`), Sun raster, DIB, ICO and CUR (BMP or PNG inside),
ICNS, QOI, PCX (and DCX's first page), SGI, IM (its N-bit types through
PIL's bit decoder, YCC through PIL's YCbCr -> RGB tables), MSP, XBM, XPM,
SPIDER, DDS (bit masks, L, LA, P, BC1-BC7; BC6H and BC7 blocks in
`csrc/image_codecs.cpp`) and PSD (the merged image; Lab through
LittleCMS's transform, `lab_to_rgb`); and the rarer ones: BLP (BLP1 JPEG
and palettes, BLP2 palettes and PIL's own Python DXT1 / 3 / 5 decoders),
FLI / FLC (the first frame, FliDecode.c in `csrc/image_codecs.cpp`),
FITS (raw and gzip tiles), FTEX, GBR, IMT, IPTC, McIdas, PhotoCD (PIL's
PhotoYCC tables), PIXAR and XV thumbnails. PNG, JPEG, BMP, TIFF, GIF,
WebP and TGA go to their readers in `imageio.py` and `webp.py`, JPEG
2000 (and ICNS's JPEG 2000 icons) to `j2k.py`, AVIF (lossless AV1 key
frames, through libavif's YUV to RGB) to `avif.py`. Opened by
path, PIL maps raw pixels of modes L, P, I;16 and the like from the file
(`_mapped`): the whole image must lie in it.
"""
from __future__ import annotations

import math
import re
import struct

import numpy as np

from .. import native

# PIL's Image.MAX_IMAGE_PIXELS: an image of more than twice as many pixels
# is refused as a decompression bomb
_MAX_PIXELS = 89478485


class _PassOn(Exception):
    """A plugin's header reading failed the way PIL takes as "not this
    format": the next plugin is tried."""


def _refused(fmt, what):
    return ValueError(f"{fmt} file {what}: PIL (the JAX package's reader) "
                      "refuses it too")


def _opened(fmt, w, h):
    """PIL's checks after a plugin's header: no pixels passes the file on,
    more than twice MAX_IMAGE_PIXELS is refused."""
    if w <= 0 or h <= 0:
        raise _PassOn
    if max(1, w) * max(1, h) > 2 * _MAX_PIXELS:
        raise _refused(fmt, f"of {w} x {h} pixels (a decompression bomb)")


def _u16(d, i, e="<"):
    if i < 0 or len(d) < i + 2:
        raise _PassOn
    return struct.unpack_from(e + "H", d, i)[0]


def _u32(d, i, e="<"):
    if i < 0 or len(d) < i + 4:
        raise _PassOn
    return struct.unpack_from(e + "I", d, i)[0]


# ---------------------------------------------------------------------------
# PIL's raw decoder, its unpackers and convert("RGB")
# ---------------------------------------------------------------------------

def _raw(data, off, h, line, stride=0, fmt="image"):
    """PIL's raw decoder: h lines of `line` bytes, one every `stride` (or
    `line`) bytes from `off` -> uint8 [h, line], in file order. The last
    line's padding may be missing; less data is refused ("image file is
    truncated")."""
    stride = stride or line
    if stride < line:
        raise _refused(fmt, "with a line longer than its stride")
    if off < 0 or len(data) < off + (h - 1) * stride + line:
        raise _refused(fmt, "cut short")
    buf = data[off:off + h * stride].ljust(h * stride, b"\0")
    return np.frombuffer(buf, np.uint8).reshape(h, stride)[:, :line]


def _bits(rows, w, depth, lsb=False):
    """Packed samples of `depth` bits (most significant first, or least
    with `lsb`) of each row -> int32 [h, w]."""
    b = np.unpackbits(rows, axis=1, bitorder="little" if lsb else "big")
    b = b[:, :w * depth].reshape(len(rows), w, depth).astype(np.int32)
    return (b << np.arange(depth - 1, -1, -1)).sum(-1)


def _palette(entries):
    """A palette of RGB rows -> 256 entries, the missing ones black (PIL's
    P -> RGB)."""
    p = np.zeros((max(256, len(entries)), 3), np.uint8)
    p[:len(entries)] = entries
    return p


def _cmyk(c, m, y, k):
    """PIL's CMYK -> RGB (Convert.c cmyk2rgb): each channel
    255 - CLIP(ink + k - ink * k / 255), in its integer rounding."""
    k = k.astype(np.int64)
    out = []
    for x in (c, m, y):
        x = x.astype(np.int64)
        t = x * k + 128
        out.append(np.clip(255 - (x + k - (((t >> 8) + t) >> 8)), 0, 255))
    return np.stack(out, -1).astype(np.uint8)


def _grey(g):
    return np.repeat(np.asarray(g, np.uint8)[..., None], 3, -1)


def _rgb(mode, x, pal=None):
    """An image of PIL mode `mode` (x: [H, W] or [H, W, bands]) -> what
    its convert("RGB") gives: "1" (x 0 / 255), "L", "LA", "P" / "PA"
    through `pal` (missing entries black), RGB / RGBA / RGBX, "I" and
    "I;16" (clipped to 0..255), "F" (truncated, clipped, NaN 0), CMYK."""
    if mode in ("RGB", "RGBA", "RGBX"):
        return np.ascontiguousarray(x[..., :3], np.uint8)
    if mode == "CMYK":
        return _cmyk(x[..., 0], x[..., 1], x[..., 2], x[..., 3])
    if x.ndim == 3:
        x = x[..., 0]
    if mode in ("1", "L", "LA"):
        return _grey(x)
    if mode in ("P", "PA"):
        return _palette(np.zeros((0, 3)) if pal is None else pal)[x]
    if mode in ("I", "I;16"):
        return _grey(np.clip(x, 0, 255))
    if mode == "F":
        f = x.astype(np.float32)
        with np.errstate(invalid="ignore"):
            g = np.where(f >= 255, 255, np.where(f > 0, np.trunc(
                np.nan_to_num(f, nan=0.0, posinf=255.0)), 0))
        return _grey(g)
    raise AssertionError(mode)


# ---------------------------------------------------------------------------
# PNM and PFM (PpmImagePlugin)
# ---------------------------------------------------------------------------

_PPM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
              b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
              b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "P": 1, "I": 1, "F": 1, "RGB": 3, "RGBA": 4,
          "CMYK": 4}


def _ppm_token(data, pos):
    """PpmImageFile._read_token: skip whitespace, a `#` comment to its CR
    or LF, up to 11 bytes -> (token, pos after its ending byte)."""
    tok = b""
    while len(tok) <= 10:
        if pos >= len(data):
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in (b" ", b"\t", b"\n", b"\v", b"\f", b"\r"):
            if not tok:
                continue
            break
        if c == b"#":
            while pos < len(data) and data[pos] not in b"\r\n":
                pos += 1
            pos += 1
            continue
        tok += c
    if not tok:
        raise _refused("PNM", "with a header that ends early")
    if len(tok) > 10:
        raise _refused("PNM", "with a header token of more than 10 bytes")
    return tok, pos


def _int(tok, fmt):
    try:
        return int(tok)
    except ValueError:
        raise _refused(fmt, f"with a header value {tok!r}") from None


def _ppm_comments(body):
    """PpmPlainDecoder._ignore_comments on the whole body: each `#` up to
    its CR or LF (both bytes gone) is cut out."""
    out = bytearray()
    pos = 0
    while True:
        i = body.find(b"#", pos)
        if i < 0:
            return bytes(out + body[pos:])
        out += body[pos:i]
        ends = [j for j in (body.find(b"\n", i), body.find(b"\r", i))
                if j >= 0]
        if not ends:
            return bytes(out)
        pos = min(ends) + 1


def read_ppm(data):
    """PBM, PGM, PPM (P1-P6 at any maxval), PFM (`Pf`) and PIL's own `P0CMYK`
    / `PyP` / `PyRGBA` / `PyCMYK`, as PpmImagePlugin reads them."""
    magic = b""
    pos = 0
    while pos < min(len(data), 6):
        c = data[pos:pos + 1]
        pos += 1
        if c in (b" ", b"\t", b"\n", b"\v", b"\f", b"\r"):
            break
        magic += c
    mode = _PPM_MODES.get(magic)
    if mode is None:
        raise _PassOn
    tok, pos = _ppm_token(data, pos)
    w = _int(tok, "PNM")
    tok, pos = _ppm_token(data, pos)
    h = _int(tok, "PNM")
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "1":
        maxval = 1
    elif mode == "F":
        tok, pos = _ppm_token(data, pos)
        try:
            scale = float(tok)
        except ValueError:
            raise _refused("PFM", f"with a scale {tok!r}") from None
        if scale == 0.0 or not math.isfinite(scale):
            raise _refused("PFM", "with a zero or infinite scale")
    else:
        tok, pos = _ppm_token(data, pos)
        maxval = _int(tok, "PNM")
        if not 0 < maxval < 65536:
            raise _refused("PNM", f"of maxval {maxval}")
        if maxval > 255 and mode == "L":
            mode = "I"
    _opened("PNM", w, h)
    bands = _BANDS[mode]
    if mode == "F":                                 # raw, bottom-up
        rows = _raw(data, pos, h, 4 * w, fmt="PFM")[::-1]
        f = rows.view("<f4" if scale < 0 else ">f4").reshape(h, w)
        return _rgb("F", f)
    if plain:
        body = _ppm_comments(data[pos:])
        if mode == "1":                             # _decode_bitonal
            toks = b"".join(body.split())
            if toks.strip(b"01"):
                raise _refused("PBM", "with a sample other than 0 or 1")
            if len(toks) < w * h:
                raise _refused("PBM", "cut short")
            v = np.frombuffer(toks[:w * h], np.uint8).reshape(h, w)
            return _grey(np.where(v == ord("0"), 255, 0))
        out_max = 65535 if mode == "I" else 255
        need = w * h * bands
        vals = []
        for t in body.split():
            if len(t) > 10:
                raise _refused("PNM", "with a sample of more than 10 bytes")
            v = _int(t, "PNM")
            if v < 0 or v > maxval:
                raise _refused("PNM", f"with a sample {v} past its maxval")
            vals.append(round(v / maxval * out_max))
            if len(vals) == need:
                break
        if len(vals) < need:
            raise _refused("PNM", "cut short")
        return _rgb(mode, np.array(vals, np.int64).reshape(h, w, bands))
    if mode == "1":
        rows = _raw(data, pos, h, (w + 7) // 8, fmt="PBM")
        return _grey(255 - 255 * _bits(rows, w, 1))
    if maxval == 255 or (maxval == 65535 and mode == "I"):
        nb = 2 if mode == "I" else 1
        rows = _raw(data, pos, h, w * bands * nb, fmt="PNM")
        v = rows.view(">u2") if nb == 2 else rows
        return _rgb(mode, v.reshape(h, w, bands).astype(np.int64))
    # PpmDecoder: each sample scaled by round(v / maxval * out_max)
    nb = 1 if maxval < 256 else 2
    n = min(w * h, (len(data) - pos) // (nb * bands))
    if n < w * h:
        raise _refused("PNM", "cut short")
    v = np.frombuffer(data, ">u2" if nb == 2 else np.uint8,
                      n * bands, pos).astype(np.float64)
    out_max = 65535 if mode == "I" else 255
    v = np.minimum(out_max, np.round(v / maxval * out_max))
    return _rgb(mode, v.astype(np.int64).reshape(h, w, bands))


# ---------------------------------------------------------------------------
# Sun raster (SunImagePlugin, SunRleDecode.c)
# ---------------------------------------------------------------------------

def read_sun(data):
    """Sun raster files as SunImagePlugin reads them: 1, 4, 8 (grey, or
    through an RGB colour map), 24 and 32 bits (BGR, or RGB for type 3);
    raw rows padded to 16 bits, or run-length coded (type 2) rows that are
    not padded."""
    if len(data) < 32:
        raise _PassOn
    w, h, depth = struct.unpack_from(">III", data, 4)
    ftype, ptype, plen = struct.unpack_from(">III", data, 20)
    if depth not in (1, 4, 8, 24, 32):
        raise _PassOn
    off = 32
    pal = None
    if plen:
        if plen > 1024 or ptype != 1:
            raise _PassOn
        if depth not in (4, 8):     # a palette on mode 1 or RGB: PIL fails
            raise _refused("Sun raster", f"of {depth} bits with a colour map")
        p = np.frombuffer(data[32:32 + plen], np.uint8)
        n = len(p) // 3
        pal = p[:3 * n].reshape(3, n).T
        off += plen
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise _PassOn
    _opened("Sun raster", w, h)
    line = (w * depth + 7) // 8
    if ftype == 2:
        rows = _sun_rle(data, off, h * line).reshape(h, line)
    else:
        rows = _raw(data, off, h, line, ((w * depth + 15) // 16) * 2,
                    "Sun raster")
    if depth == 1:
        return _grey(255 - 255 * _bits(rows, w, 1))
    if depth in (4, 8):
        v = _bits(rows, w, depth) if depth == 4 else rows[:, :w]
        if pal is not None:
            return _rgb("P", v, pal)
        return _grey(v * 17 if depth == 4 else v)
    px = rows.reshape(h, w, depth // 8)
    return np.ascontiguousarray(px[..., :3] if ftype == 3 else px[..., 2::-1])


def _sun_rle(data, pos, n_out):
    """SunRleDecode.c as one stream: 0x80 0 is a literal 0x80, 0x80 n v a
    run of n + 1 bytes v (across lines), any other byte itself."""
    out = bytearray()
    while len(out) < n_out:
        if pos >= len(data):
            raise _refused("Sun raster", "cut short")
        b = data[pos]
        if b != 0x80:
            out.append(b)
            pos += 1
            continue
        if pos + 2 > len(data):
            raise _refused("Sun raster", "cut short")
        n = data[pos + 1]
        if n == 0:
            out.append(0x80)
            pos += 2
            continue
        if pos + 3 > len(data):
            raise _refused("Sun raster", "cut short")
        out += bytes((data[pos + 2],)) * (n + 1)
        pos += 3
    return np.frombuffer(bytes(out[:n_out]), np.uint8)


# ---------------------------------------------------------------------------
# DIB, CUR, ICO (BmpImagePlugin, CurImagePlugin, IcoImagePlugin)
# ---------------------------------------------------------------------------

def read_dib(data):
    """A BMP without its file header (BmpImagePlugin's DibImageFile)."""
    from . import imageio
    return imageio.bmp_bitmap(data, 0, 0)[0]


def read_cur(data):
    """A Windows cursor as CurImagePlugin reads it: of the directory's
    entries the first, unless a later one is wider and taller; its bitmap's
    upper half (the colour image), read as a BMP would be."""
    from . import imageio
    if len(data) < 6:
        raise _PassOn
    n = _u16(data, 4)
    m = b""
    pos = 6
    for _ in range(n):
        s = data[pos:pos + 16]
        pos += len(s)
        if not m:
            m = s
        elif len(s) < 2:
            raise _PassOn                          # s[0] of a short read
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise _PassOn                              # "No cursors were found"
    hpos = _u32(m, 12)
    return imageio.bmp_bitmap(data, hpos or pos, 0, halve=True)[0]


def _ico_entries(data):
    if len(data) < 6:
        raise _PassOn
    n = _u16(data, 4)
    entries = []
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise _PassOn
        w, h, ncol = s[0] or 256, s[1] or 256, s[2]
        bpp, size, off = struct.unpack_from("<HII", s, 6)
        depth = bpp or (ncol != 0 and math.ceil(math.log(ncol, 2))) or 256
        entries.append((w, h, bpp, size, off, depth))
    entries.sort(key=lambda e: e[5])
    entries.sort(key=lambda e: e[0] * e[1], reverse=True)
    if not entries:
        raise _PassOn                              # entry[0] of none
    return entries


def read_ico(data):
    """A Windows icon as IcoImagePlugin reads it: the largest entry (the
    lowest colour depth among equals); a PNG inside as PNG, else a BMP
    without its file header whose upper half is the colour image (the AND
    mask and 32-bit alpha, checked as PIL reads them, become alpha, which
    convert("RGB") drops)."""
    from . import imageio
    w, h, bpp, size, off, _ = _ico_entries(data)[0]
    if data[off:off + 8] == imageio.PNG_SIGNATURE:
        return imageio.read_png(data[off:])
    img, (stride_start, iw, ih) = imageio.bmp_bitmap(
        data, off, 0, halve=True, by_path=False)
    if bpp == 32:
        alpha = data[stride_start:stride_start + iw * ih * 4][3::4]
        if len(alpha) < iw * ih:
            raise _refused("ICO", "with its alpha cut short")
    else:
        mw = iw + (32 - iw % 32) % 32
        total = int(mw * ih / 8)
        at = off + size - total
        if at < 0 or len(data[at:at + total]) < (mw // 8) * ih:
            raise _refused("ICO", "with its AND mask cut short")
    return img


# ---------------------------------------------------------------------------
# ICNS (IcnsImagePlugin)
# ---------------------------------------------------------------------------

# (width, height, scale) -> its resources, in the order PIL reads them
_ICNS_SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",),
    (256, 256, 2): (b"ic14",), (256, 256, 1): (b"ic08",),
    (128, 128, 2): (b"ic13",), (128, 128, 1): (b"ic07", b"it32", b"t8mk"),
    (64, 64, 1): (b"icp6",), (32, 32, 2): (b"ic12",),
    (48, 48, 1): (b"ih32", b"h8mk"),
    (32, 32, 1): (b"icp5", b"il32", b"l8mk"),
    (16, 16, 2): (b"ic11",), (16, 16, 1): (b"icp4", b"is32", b"s8mk")}


def _icns_rgb(data, start, length, n):
    """IcnsImagePlugin.read_32: n pixels of R, G, B planes, raw (3n bytes)
    or each plane run-length coded."""
    if length == 3 * n:
        raw = data[start:start + length]
        if len(raw) < 3 * n:
            raise _refused("ICNS", "with an RGB resource cut short")
        return np.frombuffer(raw, np.uint8).reshape(n, 3)
    pos = start
    planes = []
    for _ in range(3):
        out = bytearray()
        left = n
        while left > 0:
            if pos >= len(data):
                break
            b = data[pos]
            pos += 1
            if b & 0x80:
                k = b - 125
                out += data[pos:pos + 1] * k
                pos += 1
            else:
                k = b + 1
                out += data[pos:pos + k]
                pos += k
            left -= k
        if left != 0:
            raise _refused("ICNS", "with a run-length plane of another size")
        if len(out) < n:
            raise _refused("ICNS", "with a plane cut short")
        planes.append(np.frombuffer(bytes(out[:n]), np.uint8))
    return np.stack(planes, -1)


def read_icns(data):
    """An Apple icon as IcnsImagePlugin reads it: the largest size with a
    resource PIL knows; a PNG resource as PNG (its own size, if one the
    file lists), else the packed RGB planes (the mask, checked, becomes
    alpha, which convert("RGB") drops); a JPEG 2000 resource through
    `j2k.read_icns_resource`."""
    from . import imageio, j2k
    if len(data) < 8:
        raise _PassOn
    filesize = _u32(data, 4, ">")
    dct = {}
    i = 8
    while i < filesize:
        if len(data) < i + 8:
            raise _PassOn
        sig, bsize = struct.unpack_from(">4sI", data, i)
        if bsize <= 0:
            raise _PassOn
        i += 8
        dct[sig] = (i, bsize - 8)
        i += bsize - 8
    sizes = [s for s, codes in _ICNS_SIZES.items()
             if any(c in dct for c in codes)]
    if not sizes:
        raise _PassOn
    best = max(sizes)
    _opened("ICNS", best[0] * best[2], best[1] * best[2])
    w, h = best[0] * best[2], best[1] * best[2]
    out = {}
    for code in _ICNS_SIZES[best]:
        if code not in dct:
            continue
        start, length = dct[code]
        if code.endswith(b"mk"):
            if len(data[start:start + w * h]) < w * h:
                raise _refused("ICNS", "with a mask cut short")
        elif code in (b"it32", b"ih32", b"il32", b"is32"):
            if code == b"it32":
                if data[start:start + 4] != b"\0\0\0\0":
                    raise _refused("ICNS", "with an it32 of another signature")
                start, length = start + 4, length - 4
            out.setdefault("RGB", _icns_rgb(data, start, length, w * h))
        else:
            sig = data[start:start + 12]
            if sig.startswith(imageio.PNG_SIGNATURE):
                out["RGBA"] = imageio.read_png(data[start:])
            elif sig.startswith((b"\xffO\xffQ", b"\r\n\x87\n")) or \
                    sig == b"\0\0\0\x0cjP  \r\n\x87\n":
                out["RGBA"] = j2k.read_icns_resource(
                    data[start:start + length])
            else:
                raise _refused("ICNS", "with an icon resource of another "
                               "format")
    if "RGBA" in out:
        img = out["RGBA"]
        ph, pw = img.shape[:2]
        if not any(s[0] * s[2] // pw == s[1] * s[2] / ph for s in sizes):
            raise _refused("ICNS", "whose PNG has a size it does not list")
        return img
    if "RGB" not in out:
        raise _refused("ICNS", "with a mask and no image")
    return np.ascontiguousarray(out["RGB"].reshape(h, w, 3))


# ---------------------------------------------------------------------------
# QOI (QoiImagePlugin's QoiDecoder)
# ---------------------------------------------------------------------------

def read_qoi(data):
    """QOI as QoiDecoder reads it: the index of 64 seen pixels, the diff,
    luma, run, RGB and RGBA operations; the end marker is not read, and a
    missing index entry reads as (0, 0, 0, 0)."""
    if len(data) < 14:
        raise _PassOn
    w, h = struct.unpack_from(">II", data, 4)
    _opened("QOI", w, h)
    need = w * h
    out = bytearray()
    seen = {}
    prev = (0, 0, 0, 255)
    pos = 14
    n = len(data)
    while len(out) < 4 * need:
        if pos >= n:
            raise _refused("QOI", "cut short")
        b = data[pos]
        pos += 1
        if b == 0xFE:
            px = tuple(data[pos:pos + 3]) + prev[3:]
            pos += 3
        elif b == 0xFF:
            px = tuple(data[pos:pos + 4])
            pos += 4
        elif b >> 6 == 0:
            px = seen.get(b & 63, (0, 0, 0, 0))
        elif b >> 6 == 1:
            px = ((prev[0] + ((b >> 4) & 3) - 2) % 256,
                  (prev[1] + ((b >> 2) & 3) - 2) % 256,
                  (prev[2] + (b & 3) - 2) % 256, prev[3])
        elif b >> 6 == 2:
            if pos >= n:
                raise _refused("QOI", "cut short")
            b2 = data[pos]
            pos += 1
            dg = (b & 63) - 32
            px = ((prev[0] + dg + (b2 >> 4) - 8) % 256, (prev[1] + dg) % 256,
                  (prev[2] + dg + (b2 & 15) - 8) % 256, prev[3])
        else:
            out += bytes(prev) * ((b & 63) + 1)
            continue
        if len(px) != 4:
            raise _refused("QOI", "cut short")
        prev = px
        seen[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64] = px
        out += bytes(px)
    v = np.frombuffer(bytes(out[:4 * need]), np.uint8).reshape(h, w, 4)
    return np.ascontiguousarray(v[..., :3])


# ---------------------------------------------------------------------------
# PCX (PcxImagePlugin, PcxDecode.c)
# ---------------------------------------------------------------------------

def read_pcx(data):
    """PCX as PcxImagePlugin reads it: 1 bit (1 or 2 / 4 planes through
    the header's 16 colours), 8 bits (grey, or through the 256-colour
    palette at the file's end) and 24 bits in 3 planes; each line
    run-length coded, with PcxDecode.c's plane moves and its refusal of a
    run across a line's end."""
    if len(data) < 68:
        raise _PassOn
    x0, y0, x1, y1 = struct.unpack_from("<4H", data, 4)
    x1, y1 = x1 + 1, y1 + 1
    if x1 <= x0 or y1 <= y0:
        raise _PassOn
    version, bits, planes = data[1], data[3], data[65]
    given = struct.unpack_from("<H", data, 66)[0]
    pal = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        hp = np.frombuffer(data[16:64], np.uint8)
        pal = hp.reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        if len(data) < 769:
            raise _refused("PCX", "of 8 bits shorter than its palette")
        s = data[-769:]
        if s[0] == 12:
            p = np.frombuffer(s[1:], np.uint8).reshape(256, 3)
            if not (p == np.arange(256)[:, None]).all():
                mode, pal = "P", p
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise _refused("PCX", f"of {bits} bits in {planes} planes")
    w, h = x1 - x0, y1 - y0
    _opened("PCX", w, h)
    stride = (w * bits + 7) // 8
    if given != stride:
        stride += stride % 2
    nbytes = planes * stride
    lines = _pcx_lines(data, 128, nbytes, h)
    if bits == 8 and nbytes % w and nbytes > w:     # PcxDecode.c's moves
        bands = nbytes // w
        step = nbytes // bands
        for i in range(1, bands):
            moved = lines[:, i * step:i * step + w].copy()
            lines[:, i * w:(i + 1) * w] = moved
    if mode == "1":
        return _grey(255 * _bits(lines, w, 1))
    if mode == "P" and bits == 1:                   # P;2L / P;4L bit planes
        s = stride
        v = np.zeros((h, w), np.int32)
        for k in range(planes):
            v |= _bits(lines[:, k * s:k * s + s], w, 1) << k
        return _rgb("P", v, pal)
    if mode in ("L", "P") and bits == 8:
        return _rgb(mode, lines[:, :w], pal)
    return np.stack([lines[:, k * w:(k + 1) * w] for k in range(3)], -1)


def _pcx_lines(data, pos, nbytes, h):
    """PcxDecode.c: h lines of `nbytes` from `pos`, each byte 0xC0 | n
    followed by a value a run of n (one that crosses its line's end is an
    error, so refused), any other a literal."""
    out = np.zeros((h, nbytes), np.uint8)
    buf = bytearray()
    n = len(data)
    y = 0
    while y < h:
        if pos >= n:
            raise _refused("PCX", "cut short")
        b = data[pos]
        if b & 0xC0 == 0xC0:
            if pos + 1 >= n:
                raise _refused("PCX", "cut short")
            k = b & 0x3F
            if len(buf) + k > nbytes:
                raise _refused("PCX", "with a run across a line's end")
            buf += bytes((data[pos + 1],)) * k
            pos += 2
        else:
            buf.append(b)
            pos += 1
        if len(buf) >= nbytes:
            out[y] = np.frombuffer(bytes(buf), np.uint8)
            buf = bytearray()
            y += 1
    return out


# ---------------------------------------------------------------------------
# SGI (SgiImagePlugin, SgiRleDecode.c)
# ---------------------------------------------------------------------------

_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L",
              (1, 3, 3): "RGB", (2, 3, 3): "RGB", (1, 3, 4): "RGBA",
              (2, 3, 4): "RGBA"}


def read_sgi(data):
    """SGI images as SgiImagePlugin reads them: 8 or 16 bits (the high
    byte kept), 1, 3 or 4 channels, planar, bottom-up; raw or run-length
    coded through the row tables (SgiRleDecode.c, its checks and its
    early stop included)."""
    if len(data) < 12:
        raise _PassOn
    comp, bpc = data[2], data[3]
    dim, w, h, z = struct.unpack_from(">4H", data, 4)
    mode = _SGI_MODES.get((bpc, dim, z))
    if mode is None:
        raise _refused("SGI", f"of mode {(bpc, dim, z)}")
    _opened("SGI", w, h)
    bands = len(mode)
    if comp == 0:
        if bpc == 2:
            page = 2 * w * h
            planes = []
            for b in range(bands):
                rows = _raw(data, 512 + b * page, h, 2 * w, fmt="SGI")
                planes.append(rows[:, 0::2])
        else:
            planes = [_raw(data, 512 + b * w * h, h, w, fmt="SGI")
                      for b in range(bands)]
        img = np.stack(planes, -1)[::-1]
    elif comp == 1:
        img = _sgi_rle(data, w, h, bands, bpc)
    else:
        raise _refused("SGI", f"of compression {comp}")
    return _rgb(mode, img if bands > 1 else img[..., 0])


def _sgi_rle(data, w, h, bands, bpc):
    """SgiRleDecode.c: the start and length tables after the 512-byte
    header, then each row of each channel expanded into the one row buffer
    (left as it was past a short row); a row that runs past its width or
    the file is refused, a count of 1 left with a non-zero atom ends the
    image there (the rows after it stay 0)."""
    buf = data[512:]
    tab = bands * h
    if len(buf) < 8 * tab:
        raise _refused("SGI", "with its row tables cut short")
    start = np.frombuffer(buf, ">u4", tab, 0).astype(np.int64)
    length = np.frombuffer(buf, ">u4", tab, 4 * tab).astype(np.int64)
    end = len(buf) - 1                   # the last byte's index
    img = np.zeros((h, w, bands), np.uint16 if bpc == 2 else np.uint8)
    row = np.zeros((w, bands), img.dtype)
    for y in range(h):
        for c in range(bands):
            off = int(start[y + c * h]) - 512
            if off < 0:
                raise _refused("SGI", "with a row before its tables")
            st = _sgi_row(buf, off, int(length[y + c * h]), row[:, c], w,
                          end, bpc)
            if st < 0:
                raise _refused("SGI", "with a run past its row or file")
            if st == 1:
                return img[::-1].astype(np.uint8) if bpc == 1 else \
                    (img[::-1] >> 8).astype(np.uint8)
        img[y] = row
    return img[::-1] if bpc == 1 else (img[::-1] >> 8).astype(np.uint8)


def _sgi_row(buf, src, n, dest, w, end, bpc):
    """expandrow / expandrow2: -1 for an error, 1 to stop, else 0."""
    x = 0
    while n > 0:
        if bpc == 1:
            if src > end:
                return -1
            pixel = buf[src]
            src += 1
        else:
            if src + 1 > end:
                return -1
            pixel = buf[src + 1]
            src += 2
        if n == 1 and pixel != 0:
            return 1
        count = pixel & 0x7F
        if not count:
            return 0
        if x + count > w:
            return -1
        if pixel & 0x80:
            if src + bpc * count > end + (1 if bpc == 1 else 0):
                return -1
            v = np.frombuffer(buf, np.uint8 if bpc == 1 else ">u2", count, src)
            src += bpc * count
        else:
            if src + (0 if bpc == 1 else 2) > end:
                return -1
            v = buf[src] if bpc == 1 else buf[src] << 8 | buf[src + 1]
            src += bpc
        dest[x:x + count] = v
        x += count
        n -= 1
    return 0


# ---------------------------------------------------------------------------
# the formats no plugin of this module decodes yet, and the ones PIL
# identifies but cannot decode here
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# IM (ImImagePlugin)
# ---------------------------------------------------------------------------

_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = ("Comment", "Date", "Digitalization equipment",
            "File size (no of images)", "Lut", "Name", "Scale (x,y)",
            "Image size (x*y)", "Image type")
# the image types this module decodes: (mode, rawmode)
_IM_OPEN = {"0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
            "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
            "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
            "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
            "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
            "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
            "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
            "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
            "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
            "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
            "YCC image": ("YCbCr", "YCbCr;L")}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = (f"I;{_i}",
                                                             f"I;{_i}")
_IM_OPEN["L 32S image"] = _IM_OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    _IM_OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
# rawmode -> (bytes a sample, numpy dtype) of the one-band numeric types
_IM_NUMERIC = {"F;8": np.uint8, "F;8S": np.int8, "F;16": "<u2",
               "F;16S": "<i2", "F;32": "<u4", "F;32F": "<f4", "I;32": "<i4",
               "I;32S": "<i4", "I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2"}
# planar rawmodes: bands in a line, one after the other
_IM_PLANAR = {"RGB;L": 3, "LA;L": 2, "PA;L": 2, "RGBA;L": 4, "RGBX;L": 4,
              "CMYK;L": 4}


def _im_bits(rows, w, n):
    """PIL's "bit" decoder as ImImagePlugin sets it up for its N-bit types
    (bits n, pad 8, fill 3, unsigned): each row's samples from its own
    bytes, least significant bit first; at a row's end the bit count is
    reset but the unused high bits of its last byte stay in the buffer and
    are ORed into the next row's first byte. -> float32 [h, w] in file
    order."""
    out = np.empty((len(rows), w), np.float32)
    carry = 0
    for y, row in enumerate(rows):
        row = row.copy()
        row[0] |= carry
        bits = np.unpackbits(row, bitorder="little")
        v = bits[:w * n].reshape(w, n).astype(np.int64) << np.arange(n)
        out[y] = v.sum(-1)
        left = bits[w * n:]
        carry = int((left.astype(np.int64) << np.arange(len(left))).sum())
    return out


# PIL's YCbCr -> RGB (libImaging's ConvertYCbCr.c, read from PIL's
# conversion of every YCbCr triple): each offset table
# trunc((i - 128) * coefficient * 64 + 0.5), summed, shifted right by 6
_YCC_I = np.arange(256) - 128
_YCC_R_CR, _YCC_G_CB, _YCC_G_CR, _YCC_B_CB = (
    np.trunc(_YCC_I * c * 64 + 0.5).astype(np.int64)
    for c in (1.40200, -0.34414, -0.71414, 1.77200))


def _ycbcr_to_rgb(x):
    """PIL's convert("RGB") of a YCbCr image, uint8 [..., 3]."""
    y, cb, cr = (x[..., i].astype(np.int64) for i in range(3))
    rgb = np.stack([y + (_YCC_R_CR[cr] >> 6),
                    y + ((_YCC_G_CB[cb] + _YCC_G_CR[cr]) >> 6),
                    y + (_YCC_B_CB[cb] >> 6)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


_LAB_NODES = None


def lab_to_rgb(x):
    """PIL's LAB -> RGB (LittleCMS 2.17's optimised 8-bit transform from
    the Lab v2 identity profile to sRGB) of x uint8 [..., 3], Lab as
    LittleCMS reads PIL's bytes (L, then a and b offset by 128) -> uint8
    [..., 3]. Each byte v becomes the v4 16-bit value min(v * 257 * 257 >>
    8, 65535) (FomLabV2ToLabV4); the 33^3 table of 16-bit RGB nodes
    (`data/lab_srgb.npz`, read from LittleCMS by
    `tools/gen_torch_lab.py`) is interpolated as its Eval3Inputs does,
    tetrahedrally in 16.16 fixed point; 16 -> 8 bits as FROM_16_TO_8."""
    global _LAB_NODES
    if _LAB_NODES is None:
        import os
        path = os.path.join(os.path.dirname(__file__), "..", "data",
                            "lab_srgb.npz")
        _LAB_NODES = np.load(path)["nodes"].astype(np.int64).reshape(-1)
    t = _LAB_NODES
    shape = x.shape
    x = x.reshape(-1, 3).astype(np.int64) * 257
    v = np.minimum(((x << 8) | x) >> 8, 0xFFFF)
    f = v * 32
    f = f + (f + 0x7FFF) // 0xFFFF                 # _cmsToFixedDomain
    i0, r = f >> 16, f & 0xFFFF
    step = np.array([3 * 33 * 33, 3 * 33, 3])
    base = (i0 * step).sum(-1)
    one = np.where(v == 0xFFFF, 0, step)           # the next node, or none
    rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]
    dx, dy, dz = one[:, 0], one[:, 1], one[:, 2]
    # the tetrahedron's corners: after the base, the axis of the largest
    # rest, then of the two largest, then all three
    xy, yz, xz = rx >= ry, ry >= rz, rx >= rz
    first = np.where(xy & xz, dx, np.where(~xy & yz, dy, dz))
    last = np.where(xy & yz, dz, np.where(~xy & xz, dz, np.where(
        xy & ~xz, dy, np.where(~xy & ~yz & ~xz, dx, np.where(xy, dy, dx)))))
    second = first + (dx + dy + dz - first - last)
    r_first = np.where(xy & xz, rx, np.where(~xy & yz, ry, rz))
    r_last = np.where(xy & yz, rz, np.where(~xy & xz, rz, np.where(
        xy & ~xz, ry, np.where(~xy & ~yz & ~xz, rx, np.where(xy, ry, rx)))))
    r_mid = rx + ry + rz - r_first - r_last
    out = np.empty((len(x), 3), np.int64)
    for c in range(3):
        c0 = t[base + c]
        c1 = t[base + first + c]
        c2 = t[base + second + c]
        c3 = t[base + dx + dy + dz + c]
        rest = (c1 - c0) * r_first + (c2 - c1) * r_mid + (c3 - c2) * r_last \
            + 0x8001
        out[:, c] = (c0 + ((rest + (rest >> 16)) >> 16)) & 0xFFFF
    out = ((out * 65281 + 8388608) >> 24) & 0xFF
    return out.astype(np.uint8).reshape(shape)


def _im_number(s):
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError:
            raise _refused("IM", f"with a header number {s!r}") from None


def read_im(data):
    """IFUNC Image Memory files as ImImagePlugin reads them: the text
    header to its 0x1A, the optional 768-byte Lut (a palette unless it is
    grey), then the pixels bottom-up in the image type's layout."""
    if b"\n" not in data[:100]:
        raise _PassOn
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode = "L"
    n = 0
    pos = 0
    s = b""
    while True:
        s = data[pos:pos + 1]
        pos += 1
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        j = data.find(b"\n", pos)
        end = len(data) if j < 0 else j + 1
        s += data[pos:end]
        pos = end
        if len(s) > 100:
            raise _PassOn
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _IM_SPLIT.match(s)
        if not m:
            raise _PassOn
        k, v = (g.decode("latin-1") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)",
                 "Image size (x*y)"):
            v = tuple(_im_number(x) for x in v.replace("*", ",").split(","))
            if len(v) == 1:
                v = v[0]
        elif k == "Image type" and v in _IM_OPEN:
            v, rawmode = _IM_OPEN[v]
        info[k] = v
        n += k in _IM_TAGS
    if not n:
        raise _PassOn
    size, mode = info["Image size (x*y)"], info["Image type"]
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += 1
    if not s:
        raise _PassOn                              # "File truncated"
    pal = None
    if "Lut" in info:
        lut = data[pos:pos + 768]
        pos += len(lut)
        if len(lut) < 768:
            raise _PassOn                          # palette[i + 512]
        p = np.frombuffer(lut, np.uint8).reshape(3, 256)
        grey = bool((p[0] == p[1]).all() and (p[1] == p[2]).all())
        if mode in ("L", "LA", "P", "PA") and not grey:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
            pal = p.T
    if not mode or not isinstance(size, tuple) or size[0] <= 0 or \
            size[1] <= 0:
        raise _PassOn             # no mode, size[0] of a number, no pixels
    if len(size) != 2 or not all(isinstance(x, int) for x in size):
        raise _refused("IM", f"of size {size}")
    w, h = size
    _opened("IM", w, h)
    if rawmode.startswith("F;") and rawmode[2:].isdigit() and \
            int(rawmode[2:]) not in (8, 16, 32):     # PIL's bit decoder
        n = int(rawmode[2:])
        rows = _raw(data, pos, h, (w * n + 7) // 8, fmt="IM")
        return _rgb("F", _im_bits(rows, w, n)[::-1])
    if mode == "YCbCr":      # the planes, then PIL's conversion
        rows = _raw(data, pos, h, 3 * w, fmt="IM")[::-1]
        return _ycbcr_to_rgb(rows.reshape(h, 3, w).transpose(0, 2, 1))
    if rawmode == "RLB":
        raise _refused("IM", "of type 'RLB image' or 'RYB image' (no raw "
                       "mode RLB in PIL's unpackers)")
    if rawmode in ("RGB;T", "RYB;T"):
        # three whole planes, bottom-up: G, then R, then B
        planes = _raw(data, pos, 3 * h, w, fmt="IM").reshape(3, h, w)
        return np.ascontiguousarray(planes[[1, 0, 2], ::-1].transpose(1, 2, 0))
    if mode not in ("1", "L", "P", "PA", "LA", "RGB", "RGBA", "CMYK", "I",
                    "F", "I;16", "I;16L", "I;16B"):
        raise _refused("IM", f"of mode {mode!r}")
    if rawmode == "1":
        rows = _raw(data, pos, h, (w + 7) // 8, fmt="IM")[::-1]
        return _grey(255 * _bits(rows, w, 1))
    if rawmode in ("P;2", "P;4"):
        d = int(rawmode[2])
        rows = _raw(data, pos, h, (w * d + 7) // 8, fmt="IM")[::-1]
        return _rgb("P", _bits(rows, w, d), pal)
    if rawmode in ("L", "P"):
        return _rgb(mode, _raw(data, pos, h, w, fmt="IM")[::-1], pal)
    if rawmode == "RGB":
        return _rgb("RGB", _raw(data, pos, h, 3 * w, fmt="IM")[::-1]
                    .reshape(h, w, 3))
    if rawmode in _IM_PLANAR:
        k = _IM_PLANAR[rawmode]
        rows = _raw(data, pos, h, k * w, fmt="IM")[::-1]
        x = rows.reshape(h, k, w).transpose(0, 2, 1)
        return _rgb("PA" if mode == "PA" else mode, x, pal)
    dt = np.dtype(_IM_NUMERIC[rawmode])
    rows = _raw(data, pos, h, dt.itemsize * w, fmt="IM")[::-1]
    x = np.ascontiguousarray(rows).view(dt).reshape(h, w)
    if mode == "F":
        return _rgb("F", x.astype(np.float32))
    return _rgb("I", x.astype(np.int64))


# ---------------------------------------------------------------------------
# MSP (MspImagePlugin)
# ---------------------------------------------------------------------------

def read_msp(data):
    """Windows Paint files as MspImagePlugin reads them: version 1 (DanM)
    raw bits, version 2 (LinS) run-length rows through the row map."""
    if len(data) < 32:
        raise _PassOn
    words = struct.unpack_from("<16H", data)
    if np.bitwise_xor.reduce(np.array(words, np.uint16)):
        raise _PassOn                              # "bad MSP checksum"
    w, h = words[2], words[3]
    _opened("MSP", w, h)
    line = (w + 7) // 8
    if data.startswith(b"DanM"):
        return _grey(255 * _bits(_raw(data, 32, h, line, fmt="MSP"), w, 1))
    if len(data) < 32 + 2 * h:
        raise _refused("MSP", "with its row map cut short")
    rowmap = struct.unpack_from(f"<{h}H", data, 32)
    pos = 32 + 2 * h
    out = bytearray()
    for rowlen in rowmap:
        if rowlen == 0:
            out += b"\xff" * line
            continue
        row = data[pos:pos + rowlen]
        pos += rowlen
        if len(row) != rowlen:
            raise _refused("MSP", "with a row cut short")
        i = 0
        while i < rowlen:
            t = row[i]
            i += 1
            if t == 0:
                if i + 2 > rowlen:
                    raise _refused("MSP", "with a run cut short")
                out += row[i + 1:i + 2] * row[i]
                i += 2
            else:
                out += row[i:i + t]
                i += t
    if len(out) < h * line:
        raise _refused("MSP", "with rows shorter than its image")
    rows = np.frombuffer(bytes(out[:h * line]), np.uint8).reshape(h, line)
    return _grey(255 * _bits(rows, w, 1))


# ---------------------------------------------------------------------------
# XBM and XPM (XbmImagePlugin, XbmDecode.c, XpmImagePlugin)
# ---------------------------------------------------------------------------

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]")
_HEX = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"0123456789abcdef"):
    _HEX[_c] = _i
for _i, _c in enumerate(b"ABCDEF"):
    _HEX[_c] = 10 + _i


def read_xbm(data):
    """X11 bitmaps as XbmImagePlugin reads them: the header within the
    first 512 bytes, then each byte the two characters after an `x`
    (XbmDecode.c; other characters read as 0), least significant bit
    first."""
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise _PassOn
    w, h = int(m.group("width")), int(m.group("height"))
    _opened("XBM", w, h)
    line = (w + 7) // 8
    body = np.frombuffer(data, np.uint8)[m.end():]
    xs = np.flatnonzero(body == ord("x"))
    # each value takes its `x` and two characters; the next `x` is looked
    # for after them
    vals = []
    last = -1
    for i in xs:
        if i <= last:
            continue
        if i + 2 >= len(body):
            break
        vals.append((int(_HEX[body[i + 1]]) << 4) | int(_HEX[body[i + 2]]))
        last = i + 2
        if len(vals) == h * line:
            break
    if len(vals) < h * line:
        raise _refused("XBM", "cut short")
    rows = np.array(vals, np.uint8).reshape(h, line)
    return _grey(255 * _bits(rows, w, 1, lsb=True))


_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _lines(data, pos):
    """readline() from `pos` on: (line with its LF, next pos)."""
    j = data.find(b"\n", pos)
    end = len(data) if j < 0 else j + 1
    return data[pos:end], end


def read_xpm(data):
    """X11 pixmaps as XpmImagePlugin reads them: the values line, the
    colour lines (`c #rrggbb` or `c None`), then each pixel line's text
    between its first and last quote, bpp characters a pixel."""
    pos = 9
    while True:
        line, pos = _lines(data, pos)
        if not line:
            raise _PassOn
        m = _XPM_HEAD.match(line)
        if m:
            break
    w, h, ncol, bpp = (_int(g, "XPM") for g in m.groups())
    palette = {}
    for _ in range(ncol):
        line, pos = _lines(data, pos)
        line = line.rstrip()
        c = line[1:bpp + 1]
        s = line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                if i + 1 >= len(s):
                    raise _PassOn                  # s[i + 1]: IndexError
                rgb = s[i + 1]
                if rgb == b"None":
                    pass
                elif rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError:
                        raise _refused("XPM", f"with a colour {rgb!r}") \
                            from None
                    palette[c] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise _refused("XPM", f"with a colour {rgb!r}")
                break
        else:
            raise _refused("XPM", "with a colour line without `c`")
    _opened("XPM", w, h)
    keys = list(palette)
    need = w * h
    idx = []
    header = False
    while len(idx) < need:
        line, pos = _lines(data, pos)
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(line), bpp):
            key = line[i:i + bpp]
            if key not in palette:
                raise _refused("XPM", f"with a pixel {key!r} of no colour")
            idx.append(keys.index(key))
    if len(idx) < need:
        raise _refused("XPM", "cut short")
    v = np.array(idx[:need], np.int64).reshape(h, w)
    pal = np.array([palette[k] for k in keys], np.uint8).reshape(-1, 3)
    if ncol > 256:
        return pal[v]
    return _rgb("P", v, pal)


# ---------------------------------------------------------------------------
# SPIDER (SpiderImagePlugin)
# ---------------------------------------------------------------------------

def _is_int(f):
    try:
        return int(f) == f
    except (ValueError, OverflowError):
        return False


def _spider_header(t):
    h = (99,) + t
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    if int(h[22]) != int(h[13]) * int(h[23]):
        return 0
    return int(h[22])


def read_spider(data):
    """SPIDER 2-D images as SpiderImagePlugin reads them: a header of 27
    floats (big-endian tried first), then float32 pixels, through
    convert's F -> L -> RGB."""
    if len(data) < 108:
        raise _PassOn
    for e in (">", "<"):
        t = struct.unpack_from(e + "27f", data)
        hdrlen = _spider_header(t)
        if hdrlen:
            break
    else:
        raise _PassOn
    h = (99,) + t
    if int(h[5]) != 1:
        raise _PassOn
    try:
        istack, imgnumber = int(h[24]), int(h[27])
        w, ht = int(h[12]), int(h[2])
        if istack > 0 and imgnumber == 0:
            int(h[26])
    except (ValueError, OverflowError):
        raise _refused("SPIDER", "with a header value that is not a "
                       "number") from None
    if istack == 0 and imgnumber == 0:
        off = hdrlen
    elif istack > 0 and imgnumber == 0:
        off = 2 * hdrlen
    elif istack == 0 and imgnumber > 0:
        raise _refused("SPIDER", "of one image of a stack")
    else:
        raise _PassOn
    _opened("SPIDER", w, ht)
    rows = _raw(data, off, ht, 4 * w, fmt="SPIDER")
    return _rgb("F", np.ascontiguousarray(rows).view(e + "f4").reshape(ht, w))


# ---------------------------------------------------------------------------
# DDS (DdsImagePlugin, BcnDecode.c)
# ---------------------------------------------------------------------------

_FOURCC = {b"DXT1": (1, "BC1"), b"DXT3": (2, "BC2"), b"DXT5": (3, "BC3"),
           b"BC4U": (4, "BC4"), b"ATI1": (4, "BC4"), b"BC5S": (5, "BC5S"),
           b"BC5U": (5, "BC5"), b"ATI2": (5, "BC5")}
_DXGI = {70: (1, "BC1"), 71: (1, "BC1"), 73: (2, "BC2"), 74: (2, "BC2"),
         76: (3, "BC3"), 77: (3, "BC3"), 79: (4, "BC4"), 80: (4, "BC4"),
         82: (5, "BC5"), 83: (5, "BC5"), 84: (5, "BC5S"), 95: (6, "BC6H"),
         96: (6, "BC6HS"), 97: (7, "BC7"), 98: (7, "BC7"), 99: (7, "BC7"),
         27: (0, "RGBA"), 28: (0, "RGBA"), 29: (0, "RGBA")}


def _expand565(c):
    r, g, b = (c >> 11) & 31, (c >> 5) & 63, c & 31
    return np.stack([(r << 3) | (r >> 2), (g << 2) | (g >> 4),
                     (b << 3) | (b >> 2)], -1)


def _bc1(blk, separate):
    """BC1 colour blocks (uint8 [n, 8]) -> RGB [n, 16, 3]: the four-colour
    mode when c0 > c1 (always for BC2 / BC3), else three colours and
    black."""
    c0 = blk[:, 0].astype(np.int32) | blk[:, 1].astype(np.int32) << 8
    c1 = blk[:, 2].astype(np.int32) | blk[:, 3].astype(np.int32) << 8
    p0, p1 = _expand565(c0), _expand565(c1)
    four = (c0 > c1)[:, None] | separate
    p2 = np.where(four, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(four, (p0 + 2 * p1) // 3, 0)
    pal = np.stack([p0, p1, p2, p3], 1)                      # [n, 4, 3]
    lut = blk[:, 4:8].copy().view("<u4")[:, 0].astype(np.int64)
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(pal, idx[..., None], 1)


def _bc3_alpha(blk, signed=False):
    """BC3 alpha / BC4 / BC5 channel blocks (uint8 [n, 8]) -> [n, 16]: two
    endpoints (signed ones + 128), six interpolants, or four with 0 and
    255."""
    a = blk[:, :2].astype(np.int32)
    if signed:
        a = blk[:, :2].view(np.int8).astype(np.int32) + 128
    a0, a1 = a[:, :1], a[:, 1:]
    i = np.arange(1, 7)
    six = ((7 - i) * a0 + i * a1) // 7
    j = np.arange(1, 5)
    four = np.concatenate([((5 - j) * a0 + j * a1) // 5,
                           np.zeros_like(a0), np.full_like(a0, 255)], 1)
    pal = np.concatenate([a0, a1, np.where(a0 > a1, six, four)], 1)
    bits = blk[:, 2:8].astype(np.int64)
    lut = (bits[:, 0] | bits[:, 1] << 8 | bits[:, 2] << 16 | bits[:, 3] << 24
           | bits[:, 4] << 32 | bits[:, 5] << 40)
    idx = (lut[:, None] >> (3 * np.arange(16))) & 7
    return np.take_along_axis(pal, idx, 1)


def _bcn(data, off, w, h, n, fmt, name="DDS"):
    """The `bcn` decoder: 4 x 4 blocks, row by row, cut at the image's
    edge -> RGB [h, w, 3] (or grey for BC4)."""
    size = 8 if n in (1, 4) else 16
    bw, bh = (w + 3) // 4, (h + 3) // 4
    raw = data[off:off + size * bw * bh]
    if off < 0 or len(raw) < size * bw * bh:
        raise _refused(name, "cut short")
    blk = np.frombuffer(raw, np.uint8).reshape(-1, size)
    if n == 1:
        px = _bc1(blk, False)
    elif n in (2, 3):
        px = _bc1(blk[:, 8:], True)
    elif n == 4:
        px = np.repeat(_bc3_alpha(blk)[..., None], 3, -1)
    elif n == 5:
        s = fmt == "BC5S"
        px = np.stack([_bc3_alpha(blk[:, :8], s), _bc3_alpha(blk[:, 8:], s),
                       np.full((len(blk), 16), 128 if s else 0)], -1)
    elif n == 6:
        px = native.bc6h_decode(blk, fmt == "BC6HS")
    else:
        px = native.bc7_decode(blk)[..., :3]
    img = np.asarray(px, np.uint8).reshape(bh, bw, 4, 4, 3)
    img = img.transpose(0, 2, 1, 3, 4).reshape(4 * bh, 4 * bw, 3)
    return np.ascontiguousarray(img[:h, :w])


def _dds_rgb(data, off, w, h, bitcount, masks):
    """DdsRgbDecoder: each pixel's bytes as a little-endian number (past
    the file's end, the bytes that are there, then zeros), each mask's
    bits scaled to 8 bits as int(v / max * 255). The masks are 32-bit, so
    a pixel's first four bytes decide."""
    nb = bitcount // 8
    n = w * h
    raw = np.frombuffer(data[off:off + nb * n], np.uint8)
    full = len(raw) // nb if nb else n
    low = np.zeros((n, 4), np.int64)
    k = min(nb, 4)
    if nb:
        low[:full, :k] = raw[:full * nb].reshape(full, nb)[:, :k]
        rest = raw[full * nb:]
        if full < n and len(rest):
            low[full, :min(k, len(rest))] = rest[:k]
    v = (low << (8 * np.arange(4))).sum(1)
    out = []
    for mask in masks[:3]:
        if not mask:
            out.append(np.zeros(n, np.uint8))
            continue
        shift = (mask & -mask).bit_length() - 1
        out.append(np.floor(((v & mask) >> shift) / (mask >> shift) * 255)
                   .astype(np.uint8))
    return np.stack(out, -1).reshape(h, w, 3)


def read_dds(data):
    """DirectDraw surfaces as DdsImagePlugin reads them: uncompressed with
    bit masks, L, LA and P (a 256-entry RGBA palette), R8G8B8A8 (DX10) and
    BC1-BC7 (DXT1 / 3 / 5, BC4, BC5 unsigned and signed, BC6H unsigned and
    signed, BC7) through BcnDecode.c's block decoders; the top mip level."""
    if len(data) < 8:
        raise _PassOn
    if _u32(data, 4) != 124:
        raise _refused("DDS", "with a header of another size")
    if len(data) < 128:
        raise _refused("DDS", "with its header cut short")
    _, h, w = struct.unpack_from("<3I", data, 8)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", data, 80)
    pos = 128
    mode = None
    n = 0
    if pfflags & 0x40:                               # DDPF_RGB
        k = 4 if pfflags & 1 else 3
        masks = struct.unpack_from(f"<{k}I", data, 92)
        _opened("DDS", w, h)
        return _dds_rgb(data, pos, w, h, bitcount, masks)
    if pfflags & 0x20000:                            # DDPF_LUMINANCE
        if bitcount == 8:
            mode = "L"
        elif bitcount == 16 and pfflags & 1:
            mode = "LA"
        else:
            raise _refused("DDS", f"of luminance in {bitcount} bits")
    elif pfflags & 0x20:                             # DDPF_PALETTEINDEXED8
        mode = "P"
        pal = np.frombuffer(data[pos:pos + 1024], np.uint8)
        pal = pal[:len(pal) // 4 * 4].reshape(-1, 4)[:, :3]
        pos += 1024
    elif pfflags & 4:                                # DDPF_FOURCC
        if fourcc == b"DX10":
            if len(data) < 132:
                raise _PassOn                          # struct.error
            dxgi = _u32(data, 128)
            pos = 148
            if dxgi not in _DXGI:
                raise _refused("DDS", f"of DXGI format {dxgi}")
            n, fmt = _DXGI[dxgi]
            mode = "RGBA"
        elif fourcc in _FOURCC:
            n, fmt = _FOURCC[fourcc]
            mode = "RGB"
        else:
            raise _refused("DDS", f"of pixel format {fourcc!r}")
    else:
        raise _refused("DDS", f"of pixel format flags {pfflags}")
    _opened("DDS", w, h)
    if n:
        return _bcn(data, pos, w, h, n, fmt)
    bands = {"L": 1, "LA": 2, "P": 1, "RGBA": 4}[mode]
    rows = _raw(data, pos, h, w * bands, fmt="DDS").reshape(h, w, bands)
    return _rgb(mode, rows, pal if mode == "P" else None)


# ---------------------------------------------------------------------------
# PSD (PsdImagePlugin, PackBitsDecode.c)
# ---------------------------------------------------------------------------

_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
              (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
              (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def _packbits_lines(data, pos, line, h):
    """PIL's PackBitsDecode.c from `pos`: h lines of `line` bytes; 0x80 is
    skipped, n > 0x80 repeats the next byte 257 - n times, n < 0x80 copies
    n + 1 bytes, each cut at its line's end."""
    out = np.zeros((h, line), np.uint8)
    buf = bytearray()
    y = 0
    n = len(data)
    while y < h:
        if pos >= n:
            raise _refused("PSD", "cut short")
        b = data[pos]
        if b == 0x80:
            pos += 1
            continue
        if b & 0x80:
            if pos + 1 >= n:
                raise _refused("PSD", "cut short")
            buf += bytes((data[pos + 1],)) * min(257 - b, line - len(buf))
            pos += 2
        else:
            if pos + b + 2 > n:
                raise _refused("PSD", "cut short")
            buf += data[pos + 1:pos + 1 + min(b + 1, line - len(buf))]
            pos += b + 2
        if len(buf) >= line:
            out[y] = np.frombuffer(bytes(buf), np.uint8)
            buf = bytearray()
            y += 1
    return out


def read_psd(data):
    """Photoshop files as PsdImagePlugin reads them: the merged image
    after the colour mode data, the resources and the layers; raw or
    PackBits channels in bitmap, grey, indexed, RGB(A), CMYK (through
    PIL's CMYK -> RGB), Lab (through LittleCMS: `lab_to_rgb`),
    multichannel and duotone modes."""
    if len(data) < 26:
        raise _PassOn
    if _u16(data, 4, ">") != 1:
        raise _PassOn
    bits, chans, pmode = (_u16(data, 22, ">"), _u16(data, 12, ">"),
                          _u16(data, 24, ">"))
    if (pmode, bits) not in _PSD_MODES:
        raise _PassOn                                # KeyError
    mode, channels = _PSD_MODES[(pmode, bits)]
    if channels > chans:
        raise _refused("PSD", "with too few channels")
    if mode == "RGB" and chans == 4:
        mode, channels = "RGBA", 4
    h, w = struct.unpack_from(">II", data, 14)
    pos = 26
    size = _u32(data, pos, ">")
    pos += 4
    pal = None
    if size:
        cmd = data[pos:pos + size]
        pos += len(cmd)
        if mode == "P" and size == 768:
            pal = np.frombuffer(cmd, np.uint8).reshape(3, 256).T
    size = _u32(data, pos, ">")
    pos += 4
    if size:
        end = pos + size
        while pos < end:
            pos = min(pos + 4, len(data))           # signature
            _u16(data, pos, ">")
            pos += 2
            if pos >= len(data):
                raise _PassOn                        # i8(read(1)) of b""
            nlen = data[pos]
            pos += 1
            name_len = len(data[pos:pos + nlen])
            pos += name_len
            if not name_len & 1:
                pos = min(pos + 1, len(data))
            dlen = _u32(data, pos, ">")
            pos += 4
            got = len(data[pos:pos + dlen])
            pos += got
            if got & 1:
                pos = min(pos + 1, len(data))
    size = _u32(data, pos, ">")
    pos += 4
    if size:
        pos += size                                 # seek(end)
    comp = _u16(data, pos, ">")
    pos += 2
    _opened("PSD", w, h)
    line = (w + 7) // 8 if mode == "1" else w
    if comp == 0:
        planes = [_raw(data, pos + c * w * h, h, line, fmt="PSD")
                  for c in range(channels)]
    elif comp == 1:
        counts = data[pos:pos + 2 * channels * h]
        if len(counts) < 2 * channels * h:
            raise _PassOn                            # i16 of a short read
        counts = np.frombuffer(counts, ">u2").astype(np.int64)
        pos += 2 * channels * h
        planes = []
        for c in range(channels):
            planes.append(_packbits_lines(data, pos, line, h))
            pos += int(counts[c * h:(c + 1) * h].sum())
    else:
        raise _refused("PSD", f"of compression {comp}")
    if mode == "LAB":        # through LittleCMS, as PIL's convert("RGB")
        return lab_to_rgb(np.stack(planes, -1))
    if mode == "1":
        return _grey(255 * _bits(planes[0], w, 1))
    x = np.stack(planes, -1)
    if mode == "CMYK":
        return _cmyk(255 - x[..., 0], 255 - x[..., 1], 255 - x[..., 2],
                     255 - x[..., 3])
    return _rgb(mode, x, pal)


# ---------------------------------------------------------------------------
# DCX (DcxImagePlugin)
# ---------------------------------------------------------------------------

def read_dcx(data):
    """A DCX file's first page: the PCX file its first offset points to,
    as DcxImagePlugin reads it (the palette search still at the file's
    end)."""
    offsets = []
    for pos in range(4, 4 + 4 * 1024, 4):
        off = _u32(data, pos)
        if not off:
            break
        offsets.append(off)
    if not offsets:
        raise _PassOn                                # seek(0): no frame
    page = data[offsets[0]:]
    if len(page) < 2 or page[0] != 10 or page[1] not in (0, 2, 3, 5):
        raise _PassOn
    return read_pcx(page)


# ---------------------------------------------------------------------------
# BLP (BlpImagePlugin: its own Python DXT decoders)
# ---------------------------------------------------------------------------

def _blp_565(c):
    """BlpImagePlugin.unpack_565: each channel's bits shifted to the top
    of a byte, the low bits left 0."""
    return np.stack([((c >> 11) & 31) << 3, ((c >> 5) & 63) << 2,
                     (c & 31) << 3], -1)


def _blp_colours(blk, three):
    """The colour half of BLP's DXT blocks (uint8 [n, 8]) -> RGBA int
    [n, 16, 4]: `three` allows DXT1's three-colour mode (c0 <= c1: the
    mean, then transparent black); otherwise always four colours, each
    interpolant (2 a + b) // 3 of the unreplicated 5- and 6-bit values."""
    c0 = blk[:, 0].astype(np.int64) | blk[:, 1].astype(np.int64) << 8
    c1 = blk[:, 2].astype(np.int64) | blk[:, 3].astype(np.int64) << 8
    p0, p1 = _blp_565(c0), _blp_565(c1)
    four = (c0 > c1)[:, None] | (not three)
    p2 = np.where(four, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(four, (2 * p1 + p0) // 3, 0)
    a3 = np.where(four[:, 0], 255, 0)
    pal = np.stack([p0, p1, p2, p3], 1)
    pal = np.concatenate([pal, np.full(pal.shape[:2] + (1,), 255)], -1)
    pal[:, 3, 3] = a3
    bits = blk[:, 4:8].copy().view("<u4")[:, 0].astype(np.int64)
    idx = (bits[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(pal, idx[..., None], 1)


def _blp_dxt5_alpha(blk):
    """decode_dxt5's alpha of blocks (uint8 [n, 8]) -> [n, 16]: a0, a1,
    then six interpolants ((8 - c) a0 + (c - 1) a1) // 7 where a0 > a1,
    else four ((6 - c) a0 + (c - 1) a1) // 5, 0 and 255."""
    a0 = blk[:, :1].astype(np.int64)
    a1 = blk[:, 1:2].astype(np.int64)
    c = np.arange(2, 8)
    six = ((8 - c) * a0 + (c - 1) * a1) // 7
    four = ((6 - c) * a0 + (c - 1) * a1) // 5
    four[:, 4], four[:, 5] = 0, 255
    pal = np.concatenate([a0, a1, np.where(a0 > a1, six, four)], 1)
    b = blk[:, 2:8].astype(np.int64)
    bits = b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24 | \
        b[:, 4] << 32 | b[:, 5] << 40
    return np.take_along_axis(pal, (bits[:, None] >> (3 * np.arange(16))) & 7,
                              1)


def blp_dxt(blocks, kind, alpha):
    """BlpImagePlugin's `decode_dxt1` / `decode_dxt3` / `decode_dxt5` of
    blocks (uint8 [n, 8 or 16]) -> the pixels of each block, uint8
    [n, 16, bands]: R, G, B (and A where `alpha`, or always for DXT3 and
    DXT5)."""
    if kind == 1:
        px = _blp_colours(blocks, True)
        return px[..., :4 if alpha else 3].astype(np.uint8)
    px = _blp_colours(blocks[:, 8:], False)
    if kind == 3:
        a = np.unpackbits(blocks[:, :8, None], axis=-1, bitorder="little")
        a = a.reshape(len(blocks), 16, 4) << np.arange(4)
        px[..., 3] = a.sum(-1) * 17
    else:
        px[..., 3] = _blp_dxt5_alpha(blocks[:, :8])
    return px.astype(np.uint8)


def _blp_palette(data, pos):
    """BLP's 256 BGRA palette entries at `pos` -> RGB uint8 [256, 3] (a
    short palette fails PIL's safe read)."""
    raw = data[pos:pos + 1024]
    if len(raw) < 1024:
        raise _refused("BLP", "with its palette cut short")
    return np.frombuffer(raw, np.uint8).reshape(256, 4)[:, 2::-1]


def _blp_need(data, pos, n):
    """ImageFile._safe_read of n bytes at pos (n <= 0 reads nothing)."""
    if n <= 0:
        return b""
    if len(data) < pos + n:
        raise _refused("BLP", "cut short")
    return data[pos:pos + n]


def _set_as_raw(stream, w, h, bands, fmt):
    """ImageFile.set_as_raw: the raw decoder's first h lines of w pixels of
    `bands` bytes from `stream` (uint8, flat), or PIL's "not enough image
    data" -> uint8 [h, w, bands]."""
    if len(stream) < w * h * bands:
        raise _refused(fmt, "with not enough image data")
    return stream[:w * h * bands].reshape(h, w, bands)


def read_blp(data, name):
    """Blizzard mipmaps as BlpImagePlugin reads them (the first mip
    level): BLP1 JPEG (the header's bytes before the level's, through
    PIL's JPEG plugin, a 4-component file as CMYK whatever its Adobe
    transform, then its RGB bytes read as BGR at the BLP's width), BLP1 palette encodings 4
    and 5 (the pixels right after the palette, wherever the offset table
    points), BLP2 palette pixels and BLP2 DXT1 / 3 / 5 through PIL's own
    Python decoders (its rows of blocks read as raw pixels at the image's
    width, RGBA blocks as RGB where the header sets no alpha)."""
    blp1 = data[:4] == b"BLP1"
    if len(data) < (28 if blp1 else 20):
        raise _PassOn
    comp = struct.unpack_from("<i", data, 4)[0]
    if blp1:
        alpha = struct.unpack_from("<I", data, 8)[0] != 0
        enc = struct.unpack_from("<i", data, 20)[0]
        pos = 28
    else:
        enc, alpha, alpha_enc = struct.unpack_from("<bbb", data, 8)
        alpha = alpha != 0
        pos = 20
    w, h = struct.unpack_from("<II", data, 12)
    _opened("BLP", w, h)
    bands = 4 if alpha else 3
    offsets = struct.unpack("<16I", _blp_need(data, pos, 64))
    lengths = struct.unpack("<16I", _blp_need(data, pos + 64, 64))
    pos += 128
    if blp1 and comp == 0:
        return _blp_jpeg(data, pos, offsets[0], lengths[0], w, h)
    if blp1 and not (comp == 1 and enc in (4, 5)):
        raise _refused("BLP", f"of compression {comp}, encoding {enc}")
    pal = _blp_palette(data, pos)
    pos = pos + 1024 if blp1 else offsets[0]
    if blp1 or (comp == 1 and enc == 1):
        idx = np.frombuffer(_blp_need(data, pos, lengths[0]), np.uint8)
        if len(idx) < w * h:
            raise _refused("BLP", "with not enough image data")
        return np.ascontiguousarray(pal[idx[:w * h]].reshape(h, w, 3))
    if comp != 1 or enc != 2 or alpha_enc not in (0, 1, 7):
        raise _refused("BLP", f"of compression {comp}, encoding {enc}")
    size = 8 if alpha_enc == 0 else 16
    bw, bh = (w + 3) // 4, (h + 3) // 4
    blocks = np.frombuffer(_blp_need(data, pos, bw * bh * size), np.uint8)
    px = blp_dxt(blocks.reshape(-1, size), {0: 1, 1: 3, 7: 5}[alpha_enc],
                 alpha)
    # each row of blocks gives 4 rows of 4 * bw pixels, in that order
    rows = px.reshape(bh, bw, 4, 4, -1).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(
        _set_as_raw(rows.reshape(-1), w, h, bands, "BLP")[..., :3])


def _blp_jpeg(data, pos, offset, length, w, h):
    """BLP1Decoder._decode_jpeg_stream: the JPEG header (its size in the
    4 bytes at `pos`), the bytes up to the level's offset skipped, the
    level appended; PIL's JPEG plugin opens the whole (a 4-component file
    read as CMYK whatever its Adobe transform, its samples inverted); its
    RGB bytes are read as BGR into the BLP's size."""
    from . import imageio
    size = struct.unpack("<I", _blp_need(data, pos, 4))[0]
    pos += 4
    head = _blp_need(data, pos, size)
    pos += len(head)
    pos += len(_blp_need(data, pos, offset - pos))
    jpeg = head + _blp_need(data, pos, length)
    if not jpeg.startswith(b"\xff\xd8\xff"):
        raise _refused("BLP", "whose JPEG level is not a JPEG file")
    x = imageio.read_jpeg(jpeg, raw4=True)
    if x.shape[-1] == 4:             # "CMYK;I": each sample inverted
        x = _cmyk(*(255 - x[..., i].astype(np.int64) for i in range(4)))
    bgr = _set_as_raw(x.reshape(-1), w, h, 3, "BLP")
    return np.ascontiguousarray(bgr[..., ::-1])


# ---------------------------------------------------------------------------
# FLI / FLC (FliImagePlugin, FliDecode.c in `csrc/image_codecs.cpp`)
# ---------------------------------------------------------------------------

def _fli_palette(data, pos, pal, shift):
    """FliImageFile._palette: packets of (skip, count) and count RGB
    triples (0 is 256), each value shifted left by `shift` (6-bit chunk
    11) and kept to 8 bits; a packet past the 256 entries or a triple cut
    short passes the file on (IndexError)."""
    if len(data) < pos + 2:
        raise _PassOn
    n = _u16(data, pos)
    pos += 2
    i = 0
    for _ in range(n):
        s = data[pos:pos + 2]
        pos += len(s)
        if len(s) < 2:
            raise _PassOn
        i += s[0]
        k = s[1] or 256
        t = data[pos:pos + 3 * k]
        pos += len(t)
        if len(t) % 3 or i + len(t) // 3 > 256:
            raise _PassOn
        v = np.frombuffer(t, np.uint8).reshape(-1, 3).astype(np.int64)
        pal[i:i + len(v)] = (v << shift) & 255
        i += len(v)


def read_fli(data, name):
    """Autodesk FLI / FLC animations as FliImagePlugin reads them: the
    first frame (the one the JAX package's convert("RGB") loads), decoded
    into mode P by FliDecode.c from offset 128 (a prefix chunk there is
    the decoder's to refuse), its loader reading the frame's size at a
    time; the palette is the first colour chunk of the first frame (after
    a 0xF100 prefix chunk, 8-bit chunk 4 or 6-bit chunk 11), else grey."""
    s = data[:128]
    if len(s) < 128 or s[20:22] != bytes(2) or s[42:80] != bytes(38) or \
            s[88:] != bytes(40):
        raise _PassOn
    w, h = struct.unpack_from("<HH", s, 8)
    pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    s = data[128:144]
    pos = 128 + len(s)
    if _u16(s, 4) == 0xF100:
        at = 128 + _u32(s, 0)
        s = data[at:at + 16]
        pos = at + len(s)
    if _u16(s, 4) == 0xF1FA:
        size = None
        for _ in range(_u16(s, 6)):
            if size is not None:
                pos += size - 6
            c = data[pos:pos + 6]
            pos += len(c)
            kind = _u16(c, 4)
            if kind in (4, 11):
                _fli_palette(data, pos, pal, 2 if kind == 11 else 0)
                break
            size = _u32(c, 0)
            if not size:
                break
    framesize = _u32(data, 128)
    _opened("FLI", w, h)
    img = np.zeros((h, w), np.uint8)
    pos, buf = 128, b""
    while True:                                      # ImageFile.load
        s = data[pos:pos + framesize]
        pos += len(s)
        if not s:
            raise _refused("FLI", "cut short")
        buf += s
        n = native.fli_decode(buf, img)
        if n < 0:
            break
        buf = buf[n:]
    if n != -1:
        raise _refused("FLI", "with a truncated or malformed frame chunk")
    return pal[img]


# ---------------------------------------------------------------------------
# FTEX, GBR, IMT, McIdas, PIXAR, XV thumbnails: raw pixels behind a header
# ---------------------------------------------------------------------------

def read_ftex(data, name):
    """Texture File Format files as FtexImagePlugin reads them: the one
    format's first mip level (its size a signed number: -1 reads the rest
    of the file, less is refused), DXT1 through the `bcn` decoder (as DDS's BC1) or
    raw RGB."""
    if len(data) < 24:
        raise _PassOn
    w, h, _, count = struct.unpack_from("<4i", data, 8)
    if count != 1:
        raise _refused("FTEX", "of more than one format")
    if len(data) < 32:
        raise _PassOn
    fmt, where = struct.unpack_from("<2i", data, 24)
    if where < 0:
        raise _refused("FTEX", "with a negative mip level offset")
    if len(data) < where + 4:
        raise _PassOn
    size = struct.unpack_from("<i", data, where)[0]
    if size < -1:
        raise _refused("FTEX", "of a negative mip level size")
    mip = data[where + 4:] if size < 0 else data[where + 4:where + 4 + size]
    if fmt not in (0, 1):
        raise _refused("FTEX", f"of format {fmt}")
    _opened("FTEX", w, h)
    if fmt == 0:
        return _bcn(mip, 0, w, h, 1, "BC1", "FTEX")
    return np.ascontiguousarray(_raw(mip, 0, h, 3 * w, fmt="FTEX")
                                .reshape(h, w, 3))


def read_gbr(data, name):
    """GIMP brushes as GbrImagePlugin reads them: version 1 and 2 headers
    (the comment skipped; a version 2 header shorter than 28 bytes reads
    the rest of the file as its comment), then the pixels, grey (depth 1)
    or RGBA (depth 4, whose alpha convert("RGB") drops)."""
    if len(data) < 20:
        raise _PassOn
    hsize, version, w, h, depth = struct.unpack_from(">5I", data)
    if hsize < 20 or version not in (1, 2) or w == 0 or h == 0 or \
            depth not in (1, 4):
        raise _PassOn
    pos = 20
    if version == 2:
        if data[20:24] != b"GIMP" or len(data) < 28:
            raise _PassOn
        pos = 28
    skip = hsize - pos
    pos = len(data) if skip < 0 else min(pos + skip, len(data))
    _opened("GBR", w, h)
    px = data[pos:pos + w * h * depth]
    if len(px) < w * h * depth:
        raise _refused("GBR", "with not enough image data")
    v = np.frombuffer(px, np.uint8).reshape(h, w, depth)
    return _rgb("RGBA" if depth == 4 else "L", v)


def _mapped(data, off, h, line, fmt):
    """A raw image PIL maps from the file (opened by path, its rows
    `line` bytes apart): the whole of it must lie in the file."""
    if off < 0 or len(data) < off + h * line:
        raise _refused(fmt, "cut short")
    return np.frombuffer(data, np.uint8, h * line, off).reshape(h, line)


def read_mcidas(data, name):
    """McIdas area files as McIdasImagePlugin reads them: 8-bit (L),
    16-bit (I;16B) or 32-bit (I;32B to I) samples at the header's line
    stride. Opened by path, PIL maps the L and I;16B ones from the file
    (a stride of 0 or less taken as the line's width, overlapping lines
    where it is shorter) unless the lines run past its end, where its raw
    decoder reads them (the last line's padding may be missing; a stride
    shorter than the line is refused)."""
    if len(data) < 256 or not data.startswith(b"\0\0\0\0\0\0\0\4"):
        raise _PassOn
    v = (0,) + struct.unpack_from(">64i", data)
    if v[11] not in (1, 2, 4):
        raise _PassOn
    w, h, nb = v[10], v[9], v[11]
    off = v[34] + v[15]
    stride = v[15] + w * nb * v[14]
    _opened("MCIDAS", w, h)
    line = w * nb
    if not -2 ** 31 <= stride < 2 ** 31:
        raise _refused("MCIDAS", "with a line stride past 32 bits")
    if off < 0:
        raise _refused("MCIDAS", "with a negative data offset")
    if nb < 4 and off + h * stride <= len(data):     # the memory map
        step = stride if stride > 0 else line
        if off + h * step > len(data):
            raise _refused("MCIDAS", "cut short")
        if off + (h - 1) * step + line > len(data):
            raise _refused("MCIDAS", "whose overlapping lines run past "
                           "its end (PIL reads past the mapped file: "
                           "ROADMAP C29)")
        at = off + step * np.arange(h)[:, None] + np.arange(line)
        rows = np.frombuffer(data, np.uint8)[at]
    else:
        if stride < 0 or 0 < stride < line:
            raise _refused("MCIDAS", "with a line longer than its stride")
        rows = _raw(data, off, h, line, stride, "MCIDAS")
    x = np.ascontiguousarray(rows).view({1: np.uint8, 2: ">u2",
                                        4: ">i4"}[nb]).reshape(h, w)
    return _rgb("I", x.astype(np.int64))


def read_pixar(data, name):
    """PIXAR raster images as PixarImagePlugin reads them: raw RGB at
    offset 1024 (channel / depth (14, 2) only)."""
    if len(data) < 428:
        raise _PassOn
    if struct.unpack_from("<HH", data, 424) != (14, 2):
        raise _PassOn                                # no mode
    w, h = _u16(data, 418), _u16(data, 416)
    _opened("PIXAR", w, h)
    return np.ascontiguousarray(_raw(data, 1024, h, 3 * w, fmt="PIXAR")
                                .reshape(h, w, 3))


# XVThumbImagePlugin.PALETTE: 3 bits of red and green, 2 of blue
_XV_PALETTE = np.array([(r * 255 // 7, g * 255 // 7, b * 255 // 3)
                        for r in range(8) for g in range(8) for b in range(4)],
                       np.uint8)


def read_xvthumb(data, name):
    """XV thumbnails as XVThumbImagePlugin reads them: mode P through the
    fixed 3-3-2 palette, the pixels (mapped from the file) after the size
    line."""
    pos = _lines(data, 6)[1]
    while True:
        s, pos = _lines(data, pos)
        if not s:
            raise _PassOn
        if s[0] != 35:
            break
    f = s.strip().split(maxsplit=2)[:2]
    if len(f) < 2:
        raise _refused("XVTHUMB", "without its size")
    w, h = _int(f[0], "XVTHUMB"), _int(f[1], "XVTHUMB")
    _opened("XVTHUMB", w, h)
    return _XV_PALETTE[_mapped(data, pos, h, w, "XVTHUMB")]


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def read_imt(data, name):
    """IM Tools files as ImtImagePlugin reads them: the header's fields up
    to its form feed; an "n8" pixel type and a size give grey pixels,
    mapped from the file, right after the form feed."""
    buffer = data[:100]
    pos = len(buffer)
    if b"\n" not in buffer:
        raise _PassOn
    w = h = 0
    mode = tile = None
    start = 0
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = data[pos:pos + 1]
            pos += len(s)
        if not s:
            break
        if s == b"\x0c":
            tile = True
            start = pos - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += data[pos:pos + 100]
            pos += len(data[pos:pos + 100])
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            w = _int(v, "IMT")
        elif k == b"height":
            h = _int(v, "IMT")
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode:
        raise _PassOn
    _opened("IMT", w, h)
    if not tile:
        raise _refused("IMT", "without image data")
    return _grey(_mapped(data, start, h, w, "IMT"))


# ---------------------------------------------------------------------------
# FITS (FitsImagePlugin, its FitsGzipDecoder)
# ---------------------------------------------------------------------------

def _fits_size(headers, prefix):
    naxis = _int(headers[prefix + b"NAXIS"], "FITS")
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, _int(headers[prefix + b"NAXIS1"], "FITS")
    return (_int(headers[prefix + b"NAXIS1"], "FITS"),
            _int(headers[prefix + b"NAXIS2"], "FITS"))


# BITPIX -> (PIL's mode, the bytes a sample it reads, numpy's type of its
# raw mode: little-endian, whatever FITS stores)
_FITS_MODES = {8: ("L", 1, np.uint8), 16: ("I;16", 2, "<u2"),
               32: ("I", 4, "<i4"), -32: ("F", 4, "<f4"),
               -64: ("F", 4, "<f4")}


def _fits_parse(headers):
    """FitsImageFile._parse_headers -> None (no image yet), or (size,
    BITPIX, the tile's offset from the data, whether gzip tiles)."""
    gz = headers.get(b"XTENSION") == b"'BINTABLE'" and \
        headers.get(b"ZIMAGE") == b"T" and \
        headers[b"ZCMPTYPE"] == b"'GZIP_1  '"
    offset = 0
    if gz:
        plain = _fits_size(headers, b"") or (0, 0)
        offset = plain[0] * plain[1] * (_int(headers[b"BITPIX"], "FITS") // 8)
    prefix = b"Z" if gz else b""
    size = _fits_size(headers, prefix)
    if not size:
        return None
    return size, _int(headers[prefix + b"BITPIX"], "FITS"), offset, gz


def read_fits(data, name):
    """FITS images as FitsImagePlugin reads them: 80-byte cards, each
    header to its END and the next 2880-byte boundary; BITPIX 8, 16, 32,
    -32 and -64 read as the raw modes L, I;16, I and F (little-endian,
    whatever the file's order; -64 four bytes a sample), bottom-up, from
    the card after the header (fewer than 80 bytes there move the start
    back); BZERO and BSCALE ignored. ZIMAGE GZIP_1 tiles: the rest of the
    file from the table's end through gzip, each sample the low bytes of
    its 4-byte value."""
    headers, in_header, parsed = {}, False, None
    pos = 0
    try:
        while True:
            card = data[pos:pos + 80]
            pos += len(card)
            if not card:
                raise _refused("FITS", "cut short")
            key = card[:8].strip()
            if key in (b"SIMPLE", b"XTENSION"):
                in_header = True
            elif headers and not in_header:
                break
            elif key == b"END":
                pos = -(-pos // 2880) * 2880
                if not parsed:
                    parsed = _fits_parse(headers)
                in_header = False
                continue
            if parsed:
                continue
            value = card[8:].split(b"/")[0].strip()
            if value.startswith(b"="):
                value = value[1:].strip()
            if not headers and (not key.startswith(b"SIMPLE")
                                or value != b"T"):
                raise _PassOn
            headers[key] = value
    except KeyError:
        raise _PassOn from None
    if not parsed:
        raise _refused("FITS", "without image data")
    (w, h), bits, offset, gz = parsed
    if bits not in _FITS_MODES:
        raise _PassOn                                # no mode
    _opened("FITS", w, h)
    mode, nb, dt = _FITS_MODES[bits]
    start = offset + pos - 80
    if not gz:
        if start < 0 or len(data) < start + h * w * nb:
            raise _refused("FITS", "cut short")
        x = np.frombuffer(data, dt, h * w, start).reshape(h, w)[::-1]
    else:
        import gzip
        import zlib
        if start < 0:
            raise _refused("FITS", "with a negative tile offset")
        try:
            value = gzip.decompress(data[start:])
        except (OSError, EOFError, zlib.error) as e:
            raise _refused("FITS", f"with bad gzip tiles ({e})") from None
        take = min(bits // 8, 4)
        if take <= 0 or len(value) < 4 * w * h:
            raise _refused("FITS", "with not enough image data")
        v = np.frombuffer(value, np.uint8, 4 * w * h).reshape(h, w, 4)
        x = np.ascontiguousarray(v[::-1, :, 4 - take:]).view(dt)[..., 0]
    if mode == "F":
        return _rgb("F", x)
    return _rgb("I" if mode != "L" else "L", x.astype(np.int64))


# ---------------------------------------------------------------------------
# IPTC (IptcImagePlugin)
# ---------------------------------------------------------------------------

def _iptc_field(data, pos, loading=False):
    """IptcImageFile.field -> (tag or None, data size, next pos). A field
    PIL cannot read passes the file on while it opens it, refuses it while
    it loads the image."""
    def fail():
        return _refused("IPTC", "with a bad image field") if loading \
            else _PassOn
    s = data[pos:pos + 5]
    pos += len(s)
    if not s.strip(b"\0"):
        return None, 0, pos
    if len(s) < 3 or s[0] != 0x1C or s[1] not in (1, 2, 3, 4, 5, 6, 7, 8, 9,
                                                    240) or len(s) < 4:
        raise fail()
    size = s[3]
    if size > 132:
        raise _refused("IPTC", "with a field of an illegal length")
    if size == 128:
        size = 0
    elif size > 128:
        ext = data[pos:pos + size - 128]
        pos += len(ext)
        size = int.from_bytes((b"\0" * 4 + ext)[-4:], "big")
    elif len(s) < 5:
        raise fail()
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return (s[1], s[2]), size, pos


def _iptc_grey(inner):
    """The one band an RGB or CMYK IPTC file's image gives: it must be of
    mode L (`Image.merge`); the port reads it from an 8-bit grey JPEG or
    PGM (ROADMAP C29)."""
    from . import imageio
    if inner.startswith(b"\xff\xd8\xff"):
        if len(imageio._jpeg_scans(inner)[1]) == 1:
            return imageio.read_jpeg(inner)[..., 0]
    elif inner[:2] in (b"P5", b"P2") and inner[2:3] in b" \t\n\v\f\r" \
            and len(inner) > 2:
        img = read_ppm(inner)
        pos = 3                              # width, height, maxval
        for _ in range(3):
            tok, pos = _ppm_token(inner, pos)
        if int(tok) < 256:
            return img[..., 0]
    raise _refused("IPTC", "whose colour image is not an 8-bit grey JPEG "
                   "or PGM (ROADMAP C29)")


def read_iptc(data, name):
    """IPTC/NAA files as IptcImagePlugin reads them: the fields up to the
    first (8, 10) record; the image is the (8, 10) records' data joined
    (behind a P5 header of the header's size for compression 1, "raw";
    as it is for compression 5, "jpeg", read by whichever plugin takes
    it, so through `read` itself). Grey files (layers 1, component 0)
    give that image; RGB and CMYK ones `Image.merge` it into the band
    that (3, 65) names (the first by default), the others 0."""
    info = {}
    pos = 0
    while True:
        start = pos
        tag, size, pos = _iptc_field(data, pos)
        if not tag or tag == (8, 10):
            break
        body = data[pos:pos + size] if size else None
        pos += len(body or b"")
        if tag not in info:
            info[tag] = body
        elif isinstance(info[tag], list):
            info[tag].append(body)
        else:
            info[tag] = [info[tag], body]

    def getint(key):
        v = info[key]
        if not isinstance(v, bytes):
            raise _PassOn                            # TypeError
        return int.from_bytes((b"\0" * 4 + v)[-4:], "big")

    def item(v, i):
        if v is None or len(v) <= i:
            raise _PassOn                            # TypeError / IndexError
        return v[i]

    try:
        layers_v = info[(3, 60)]
        layers, component = item(layers_v, 0), item(layers_v, 1)
        band = None
        mode = ""
        if layers == 1 and not component:
            mode = "L"
        else:
            if layers == 3 and component:
                mode = "RGB"
            elif layers == 4 and component:
                mode = "CMYK"
            band = 0
            if (3, 65) in info:
                b = item(info[(3, 65)], 0)
                if not isinstance(b, int):
                    raise _PassOn                    # bytes - 1
                band = b - 1
        w, h = getint((3, 20)), getint((3, 30))
    except KeyError:
        raise _PassOn from None
    if (3, 120) not in info:
        raise _refused("IPTC", "without a compression")
    comp = getint((3, 120))
    if comp not in (1, 5):
        raise _refused("IPTC", f"of compression {comp}")
    if not mode:
        raise _PassOn
    _opened("IPTC", w, h)
    if tag != (8, 10):
        raise _refused("IPTC", "without image data")
    inner = b"P5\n%d %d\n255\n" % (w, h) if comp == 1 else b""
    pos = start
    while True:
        tag, size, pos = _iptc_field(data, pos, loading=True)
        if tag != (8, 10):
            break
        chunk = data[pos:pos + size]
        pos += len(chunk)
        inner += chunk
    if band is None:
        return read(inner, name)
    n = len(mode)
    if not -n <= band < n:
        raise _refused("IPTC", f"naming band {band + 1} of {n}")
    grey = _iptc_grey(inner)
    x = np.zeros(grey.shape + (n,), np.uint8)
    x[..., band] = grey
    return _rgb(mode, x)


# ---------------------------------------------------------------------------
# PhotoCD (PcdImagePlugin, PcdDecode.c)
# ---------------------------------------------------------------------------

_PCD_YCC = None


def pcd_ycc_to_rgb(y, c1, c2):
    """PIL's "YCC;P" unpacker (PhotoYCC -> RGB, UnpackYCC.c): each channel
    the sum of its tables' entries (`data/pcd_ycc.npz`: L[y]; R + CR[c2],
    G + GB[c1] + GR[c2], B + CB[c1]), clipped to 0..255."""
    global _PCD_YCC
    if _PCD_YCC is None:
        import os
        path = os.path.join(os.path.dirname(__file__), "..", "data",
                            "pcd_ycc.npz")
        with np.load(path) as t:
            _PCD_YCC = {k: t[k].astype(np.int64) for k in t.files}
    t = _PCD_YCC
    lum = t["L"][y]
    rgb = np.stack([lum + t["CR"][c2], lum + t["GB"][c1] + t["GR"][c2],
                    lum + t["CB"][c1]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def read_pcd(data, name):
    """Kodak PhotoCD files as PcdImagePlugin reads them: the 768 x 512 base
    image at 96 x 2048 bytes, PcdDecode.c's pairs of luma rows sharing one
    row of half-width C1 and C2, PhotoYCC through PIL's tables
    (`pcd_ycc_to_rgb`); turned 90 or 270 degrees (anticlockwise) by the
    orientation's low bits."""
    if data[2048:2052] != b"PCD_" or len(data) < 2048 + 1539:
        raise _PassOn
    turn = data[2048 + 1538] & 3
    _opened("PCD", 768, 512)
    off, chunk = 96 * 2048, 3 * 768
    if len(data) < off + 256 * chunk:
        raise _refused("PCD", "cut short")
    b = np.frombuffer(data, np.uint8, 256 * chunk, off).reshape(256, chunk)
    y = b[:, :1536].reshape(512, 768)
    half = np.arange(768) // 2
    c1 = np.repeat(b[:, 1536 + half], 2, 0)
    c2 = np.repeat(b[:, 1920 + half], 2, 0)
    img = pcd_ycc_to_rgb(y, c1, c2)
    if turn in (1, 3):
        img = np.rot90(img, 1 if turn == 1 else -1)
    return np.ascontiguousarray(img)


def _mpeg(data, name):
    if len(data) < 7:
        raise _PassOn
    v = int.from_bytes(data[4:7], "big")
    _opened("MPEG", v >> 12, v & 0xFFF)
    raise _refused("MPEG", "(PIL has no MPEG decoder)")


def _stub(fmt):
    def reader(data, name):
        raise _refused(fmt, "(PIL identifies it, but has no handler for it "
                       "installed)")
    return reader


def _from(module_reader):
    """One of `imageio`'s readers (their ValueError is PIL's refusal)."""
    def reader(data, name):
        from . import imageio
        return getattr(imageio, module_reader)(data)
    return reader


def _tiff(data, name):
    from . import imageio
    return imageio.read_tiff(data)


# TiffImagePlugin.PREFIXES: the byte order from bytes 0-1, BigTIFF where
# byte 2 is 43 (so "MM\0+" is read as classic TIFF)
TIFF_PREFIXES = (b"MM\0*", b"II*\0", b"MM*\0", b"II\0*", b"MM\0+", b"II+\0")


def _webp(data, name):
    from . import webp
    return webp.decode(data, name)[0]


def _jpeg2000(data, name):
    from . import j2k
    return j2k.read(data)


def _avif(data, name):
    from . import avif
    try:
        return avif.read(data)
    except avif.PassOn:
        raise _PassOn from None


def _tga(data, name):
    from . import imageio
    if imageio._tga_header(data) is None:
        raise _PassOn
    return imageio.read_tga(data)


def _avif_accept(p):
    return p[4:8] == b"ftyp" and p[8:12] in (
        b"avif", b"avis", b"mif1", b"msf1")


def _dib_accept(p):
    return len(p) >= 4 and struct.unpack_from("<I", p)[0] in (
        12, 40, 52, 56, 64, 108, 124)


def _i32(p, e="<"):
    return struct.unpack_from(e + "I", p)[0] if len(p) >= 4 else None


def _plain(fn):
    return lambda data, name: fn(data)


# PIL 12.1.0's Image.ID, in order: (format, _accept or None, reader)
_PLUGINS = (
    ("BMP", lambda p: p.startswith(b"BM"), _from("read_bmp")),
    ("DIB", _dib_accept, _plain(read_dib)),
    ("GIF", lambda p: p.startswith((b"GIF87a", b"GIF89a")),
     _from("read_gif")),
    ("JPEG", lambda p: p.startswith(b"\xff\xd8\xff"), _from("read_jpeg")),
    ("PPM", lambda p: len(p) >= 2 and p[:1] == b"P" and p[1] in b"0123456fy",
     _plain(read_ppm)),
    ("PNG", lambda p: p.startswith(b"\x89PNG\r\n\x1a\n"), _from("read_png")),
    ("AVIF", _avif_accept, _avif),
    ("BLP", lambda p: p.startswith((b"BLP1", b"BLP2")), read_blp),
    ("BUFR", lambda p: p.startswith((b"BUFR", b"ZCZC")), _stub("BUFR")),
    ("CUR", lambda p: p.startswith(b"\0\0\2\0"), _plain(read_cur)),
    ("PCX", lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5),
     _plain(read_pcx)),
    ("DCX", lambda p: _i32(p) == 987654321, _plain(read_dcx)),
    ("DDS", lambda p: p.startswith(b"DDS "), _plain(read_dds)),
    ("EPS", lambda p: p.startswith(b"%!PS") or _i32(p) == 0xC6D3D0C5,
     _stub("EPS")),
    ("FITS", lambda p: p.startswith(b"SIMPLE"), read_fits),
    ("FLI", lambda p: len(p) >= 16 and struct.unpack_from("<H", p, 4)[0] in
     (0xAF11, 0xAF12) and struct.unpack_from("<H", p, 14)[0] in (0, 3), read_fli),
    ("FTEX", lambda p: p.startswith(b"FTEX"), read_ftex),
    ("GBR", lambda p: len(p) >= 8 and _i32(p, ">") >= 20 and
     struct.unpack_from(">I", p, 4)[0] in (1, 2), read_gbr),
    ("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
     _stub("GRIB")),
    ("HDF5", lambda p: p.startswith(b"\x89HDF\r\n\x1a\n"), _stub("HDF5")),
    ("JPEG2000", lambda p: p.startswith(
        (b"\xffO\xffQ", b"\0\0\0\x0cjP  \r\n\x87\n")), _jpeg2000),
    ("ICNS", lambda p: p.startswith(b"icns"), _plain(read_icns)),
    ("ICO", lambda p: p.startswith(b"\0\0\1\0"), _plain(read_ico)),
    ("IM", None, _plain(read_im)),
    ("IMT", None, read_imt),
    ("IPTC", None, read_iptc),
    ("MCIDAS", lambda p: p.startswith(b"\0\0\0\0\0\0\0\4"), read_mcidas),
    ("MPEG", lambda p: p.startswith(b"\0\0\1\xb3"), _mpeg),
    ("TIFF", lambda p: p.startswith(TIFF_PREFIXES), _tiff),
    ("MSP", lambda p: p.startswith((b"DanM", b"LinS")), _plain(read_msp)),
    ("PCD", None, read_pcd),
    ("PIXAR", lambda p: p.startswith(b"\x80\xe8\0\0"), read_pixar),
    ("PSD", lambda p: p.startswith(b"8BPS"), _plain(read_psd)),
    ("QOI", lambda p: p.startswith(b"qoif"), _plain(read_qoi)),
    ("SGI", lambda p: len(p) >= 2 and p[:2] == b"\x01\xda", _plain(read_sgi)),
    ("SPIDER", None, _plain(read_spider)),
    ("SUN", lambda p: p.startswith(b"\x59\xa6\x6a\x95"), _plain(read_sun)),
    ("TGA", None, _tga),
    ("WEBP", lambda p: p.startswith(b"RIFF") and p[8:12] == b"WEBP" and
     p[12:16] in (b"VP8 ", b"VP8X", b"VP8L"), _webp),
    ("WMF", lambda p: p.startswith((b"\xd7\xcd\xc6\x9a\0\0", b"\1\0\0\0")),
     _stub("WMF")),
    ("XBM", lambda p: p.lstrip().startswith(b"#define"), _plain(read_xbm)),
    ("XPM", lambda p: p.startswith(b"/* XPM */"), _plain(read_xpm)),
    ("XVTHUMB", lambda p: p.startswith(b"P7 332"), read_xvthumb),
)


def read(data, name):
    """What `PIL.Image.open(p).convert("RGB")` gives for the bytes `data`
    of the file `name`: uint8 [H, W, 3]. Raises ValueError where PIL
    raises, NotImplementedError naming ROADMAP queue A's item for a format
    PIL decodes and this package does not yet."""
    prefix = data[:16]
    for fmt, accept, reader in _PLUGINS:
        if accept is not None and not accept(prefix):
            continue
        try:
            return reader(data, name)
        except _PassOn:
            continue
    raise ValueError(f"'{name}': no PIL plugin identifies it: PIL (the JAX "
                     "package's reader for it) cannot open it either")
