"""OpenCV's own image readers, as the JAX package meets them: a file named
.hdr or .exr goes to `cv2.imread(p, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`
(`vision_tpu/scene/texture.py` `load_image`), and OpenCV picks its reader
by the file's first bytes. This module decodes, with numpy only, what
those readers of OpenCV 5.0 (the JAX package's `cv2`) give for

  * PNM (`read_pnm`, grfmt_pxm.cpp): P1-P6, ASCII and binary, maxval
    1-65535; binary 8-bit samples taken as they are (not scaled by
    maxval), ASCII ones scaled to 255 (integer division) and clipped at
    maxval, 16-bit samples kept whole;
  * PAM (`read_pam`, grfmt_pam.cpp): P7 with its DEPTH, MAXVAL and
    TUPLTYPE;
  * PFM (`read_pfm`, grfmt_pfm.cpp): `PF` / `Pf`, the scale's sign as the
    byte order, bottom-up rows, samples multiplied by 1 / |scale|;
  * Sun raster (`read_sunras`, grfmt_sunras.cpp);
  * BMP (`read_bmp_cv`, grfmt_bmp.cpp), OpenCV's rules, not PIL's;
  * CMYK and YCCK JPEG (`read_jpeg_cmyk`): libjpeg-turbo's CMYK samples
    converted by OpenCV's icvCvt_CMYK2BGR_8u_C4C3R.

Each returns OpenCV's image as the loader takes it: [H, W] for one
channel, [H, W, 3] in OpenCV's B, G, R order, uint8 / uint16 / float32.
What OpenCV refuses (an empty image or an error) raises ValueError.
"""
from __future__ import annotations

import re
import struct

import numpy as np

# OpenCV's limits on a decoded image (loadsave.cpp validateInputImageSize)
_MAX_SIDE, _MAX_PIXELS = 1 << 20, 1 << 30
_SPACE = b" \t\n\v\f\r"


def _refused(fmt, what):
    return ValueError(f"{fmt} file {what}: OpenCV (the JAX package's reader "
                      "for .hdr / .exr names) refuses it too")


def _check_size(fmt, w, h):
    if not (0 < w <= _MAX_SIDE and 0 < h <= _MAX_SIDE
            and w * h <= _MAX_PIXELS):
        raise _refused(fmt, f"of size {w} x {h}")


def _grey(b, g, r):
    """OpenCV's BGR -> grey of 8-bit samples (utils.cpp icvCvt_BGR2Gray:
    fixed point, 14 bits)."""
    return ((b.astype(np.int64) * 1868 + g.astype(np.int64) * 9617
             + r.astype(np.int64) * 4899 + (1 << 13)) >> 14).astype(np.uint8)


# ---------------------------------------------------------------------------
# PFM
# ---------------------------------------------------------------------------

def _token(data, pos, fmt):
    """grfmt_pfm.cpp read_number's text: up to 2048 bytes before a
    whitespace byte (consumed) -> (token, next pos)."""
    end = pos
    while end - pos < 2048:
        if end >= len(data):
            raise _refused(fmt, "cut in its header")
        if data[end] >= 128:
            raise _refused(fmt, "with a byte past ASCII in its header")
        if data[end] in _SPACE:
            return data[pos:end], end + 1
        end += 1
    return data[pos:end], end


def _atoi(tok):
    """C's atoi of a token without leading space."""
    m = re.match(rb"[+-]?\d+", tok)
    return int(m.group()) if m else 0


def _strtod(tok):
    """C's strtod of a token without leading space (decimal, hex, inf and
    nan forms); 0 where no number starts it."""
    m = re.match(rb"[+-]?(?:0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)"
                 rb"(?:[pP][+-]?\d+)?)", tok)
    if m:
        text = m.group().decode()
        sign = -1.0 if text.startswith("-") else 1.0
        body = text.lstrip("+-")
        if "p" not in body.lower():
            body += "p0"
        return sign * float.fromhex(body)
    m = re.match(rb"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?", tok)
    if m:
        return float(m.group())
    m = re.match(rb"([+-]?)(inf(?:inity)?|nan(?:\([0-9A-Za-z_]*\))?)", tok,
                 re.I)
    if m:
        return float(m.group(1).decode() + m.group(2)[:3].decode())
    return 0.0


def read_pfm(data):
    """A PFM file (`PF` colour, `Pf` grey) -> float32 [H, W, 3] (B, G, R)
    or [H, W], as grfmt_pfm.cpp decodes it: the header's third byte a
    newline; width, height and scale each the text up to a whitespace
    byte, read by atoi / strtod; rows bottom-up, little-endian when the
    scale is negative; every sample times float(1 / |scale|) unless that
    is 1."""
    if len(data) < 3 or data[0] != ord("P") or data[1] not in b"fF" \
            or data[2] != ord("\n"):
        raise _refused("PFM", "without its 'PF' / 'Pf' line")
    nch = 3 if data[1] == ord("F") else 1
    tok, pos = _token(data, 3, "PFM")
    w = _atoi(tok)
    tok, pos = _token(data, pos, "PFM")
    h = _atoi(tok)
    tok, pos = _token(data, pos, "PFM")
    scale = _strtod(tok)
    _check_size("PFM", w, h)
    if not abs(scale) > 0:
        raise _refused("PFM", f"of scale {scale}")
    n = w * h * nch
    if len(data) - pos < 4 * n:
        raise _refused("PFM", "cut short")
    a = np.frombuffer(data, ">f4" if scale > 0 else "<f4", n, pos)
    a = a.astype(np.float32).reshape(h, w, nch)[::-1]
    alpha = 1.0 / abs(scale)
    if alpha != 1.0:            # convertTo's x * alpha + 0: -0 becomes 0
        with np.errstate(invalid="ignore", over="ignore"):
            a = a * np.float32(alpha) + np.float32(0)
    a = np.ascontiguousarray(a[..., ::-1] if nch == 3 else a[..., 0])
    return a


# ---------------------------------------------------------------------------
# PNM (P1-P6)
# ---------------------------------------------------------------------------

def _pxm_number(data, pos, maxdigits=0):
    """grfmt_pxm.cpp ReadNumber: skip whitespace and '#' comments (to a CR
    or LF), then digits (at most `maxdigits` if given); the byte after the
    digits is consumed -> (value, next pos). A stray byte or the end of
    the file refuses it."""
    def byte(p):
        if p >= len(data):
            raise _refused("PNM", "cut short")
        return data[p]
    code = byte(pos)
    pos += 1
    while not 48 <= code <= 57:
        if code == ord("#"):
            while code not in (10, 13):
                code = byte(pos)
                pos += 1
            code = byte(pos)
            pos += 1
        elif code in _SPACE:
            while code in _SPACE:
                code = byte(pos)
                pos += 1
        else:
            raise _refused("PNM", f"with a byte {code:#x} among its numbers")
    val = digits = 0
    while True:
        val = val * 10 + code - 48
        if val > 0x7FFFFFFF:
            raise _refused("PNM", "with a number past 2^31")
        digits += 1
        if maxdigits and digits >= maxdigits:
            return val, pos
        code = byte(pos)
        pos += 1
        if not 48 <= code <= 57:
            return val, pos


def read_pnm(data):
    """A PNM file -> uint8 / uint16 [H, W] (P1, P2, P4, P5) or [H, W, 3]
    B, G, R (P3, P6), as grfmt_pxm.cpp decodes it (see the module's
    docstring); PBM's 1 is black (0), 0 white (255)."""
    kind = data[1] - 48
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[kind]
    binary = kind >= 4
    w, pos = _pxm_number(data, 2)
    h, pos = _pxm_number(data, pos)
    maxval = 1
    if bpp > 1:
        maxval, pos = _pxm_number(data, pos)
    if maxval > 65535 or w <= 0 or h <= 0 or maxval <= 0:
        raise _refused("PNM", f"of size {w} x {h}, maxval {maxval}")
    _check_size("PNM", w, h)
    nch = 3 if bpp == 24 else 1
    wide = maxval > 255
    if bpp == 1:
        palette = np.array([255, 0], np.uint8)
        if binary:
            pitch = -(-w // 8)
            if len(data) - pos < pitch * h:
                raise _refused("PNM", "cut short")
            bits = np.unpackbits(np.frombuffer(data, np.uint8, pitch * h, pos)
                                 .reshape(h, pitch), axis=1)[:, :w]
            return palette[bits]
        out = np.empty(h * w, np.uint8)
        for i in range(h * w):
            v, pos = _pxm_number(data, pos, 1)
            out[i] = v != 0
        return palette[out.reshape(h, w)]
    n = w * h * nch
    if binary:
        size = 2 if wide else 1
        if len(data) - pos < n * size:
            raise _refused("PNM", "cut short")
        a = np.frombuffer(data, ">u2" if wide else np.uint8, n, pos)
        a = a.astype(np.uint16 if wide else np.uint8)
    else:
        vals = np.empty(n, np.int64)
        for i in range(n):
            vals[i], pos = _pxm_number(data, pos)
        vals = np.minimum(vals, maxval)
        if wide:
            a = vals.astype(np.uint16)
        else:
            a = (vals * 255 // maxval).astype(np.uint8)
    a = a.reshape(h, w, nch)
    return np.ascontiguousarray(a[..., ::-1] if nch == 3 else a[..., 0])


# ---------------------------------------------------------------------------
# Sun raster
# ---------------------------------------------------------------------------

SUNRAS_MAGIC = b"\x59\xa6\x6a\x95"


def _palette_grey(pal):
    """Whether a palette [n, 3] (B, G, R) is grey (IsColorPalette false)."""
    return bool((pal[:, 0] == pal[:, 1]).all() and (pal[:, 0] == pal[:, 2]).all())


def _index_rows(data, pos, w, h, bpp, pitch, fmt):
    """h rows of `pitch` bytes from pos -> palette indices [h, w]."""
    if len(data) - pos < pitch * h:
        raise _refused(fmt, "cut short")
    rows = np.frombuffer(data, np.uint8, pitch * h, pos).reshape(h, pitch)
    if bpp == 8:
        return rows[:, :w]
    bits = np.unpackbits(rows, axis=1)
    if bpp == 1:
        return bits[:, :w]
    return (bits.reshape(h, -1, 4) @ np.array([8, 4, 2, 1]))[:, :w]


def read_sunras(data):
    """A Sun raster file -> uint8 [H, W] or [H, W, 3] (B, G, R), as OpenCV
    5.0's grfmt_sunras.cpp decodes it: 1, 8, 24 and 32 bits a pixel in
    the old and standard types (0, 1; OpenCV refuses the run-length type
    2 and the RGB type 3), rows padded to 16 bits; a colour map (type 1,
    at most 2^depth entries, R then G then B planes of maplength / 3
    bytes each) for 1 and 8 bits. A grey map gives grey (OpenCV's fixed-
    point luma of its entries); without a map, 1- and 8-bit files give 0
    (OpenCV's grey table is left empty); 32 bits are X, B, G, R."""
    if len(data) < 32:
        raise _refused("Sun raster", "cut in its header")
    _, w, h, bpp, _, typ, maptype, maplen = struct.unpack(">8i", data[:32])
    pal_max = (1 << bpp) * 3 if 0 < bpp <= 8 else 0
    if not (w > 0 and h > 0 and bpp in (1, 8, 24, 32) and typ in (0, 1)
            and ((maptype == 0 and maplen == 0)
                 or (maptype == 1 and 0 < maplen <= pal_max))):
        raise _refused("Sun raster", f"of depth {bpp}, type {typ}, map type "
                       f"{maptype} and map length {maplen}")
    if len(data) < 32 + maplen:
        raise _refused("Sun raster", "cut in its colour map")
    _check_size("Sun raster", w, h)
    pos = 32 + maplen
    pitch = ((w * bpp + 7) // 8 + 1) & -2
    if bpp > 8:
        if len(data) - pos < pitch * h:
            raise _refused("Sun raster", "cut short")
        rows = np.frombuffer(data, np.uint8, pitch * h, pos).reshape(h, pitch)
        if bpp == 24:
            return np.ascontiguousarray(rows[:, :3 * w].reshape(h, w, 3))
        return np.ascontiguousarray(rows[:, :4 * w].reshape(h, w, 4)[..., 1:])
    pal = np.zeros((1 << bpp, 3), np.uint8)          # B, G, R
    n = maplen // 3
    if n:
        m = np.frombuffer(data, np.uint8, maplen, 32)
        pal[:n] = np.stack([m[2 * n:3 * n], m[n:2 * n], m[:n]], -1)
    idx = _index_rows(data, pos, w, h, bpp, pitch, "Sun raster")
    if maplen and not _palette_grey(pal):
        return pal[idx]
    grey = _grey(pal[:, 0], pal[:, 1], pal[:, 2]) if maplen else \
        np.zeros(1 << bpp, np.uint8)
    return grey[idx]


# ---------------------------------------------------------------------------
# PAM (P7)
# ---------------------------------------------------------------------------

_PAM_FIELDS = (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL", b"TUPLTYPE", b"ENDHDR")
# TUPLTYPE -> its channels (BLACKANDWHITE_ALPHA, which OpenCV never
# decodes, has none here)
_PAM_TUPLES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2,
               b"RGB": 3, b"RGB_ALPHA": 4}


def _pam_line(data, pos):
    """grfmt_pam.cpp ReadPAMHeaderLine -> (identifier or None for a
    comment, value, next pos)."""
    def byte(p):
        if p >= len(data):
            raise _refused("PAM", "cut in its header")
        return data[p]
    code = byte(pos)
    pos += 1
    while code in _SPACE:
        code = byte(pos)
        pos += 1
    if code == ord("#"):
        while code not in (10, 13):
            code = byte(pos)
            pos += 1
        return None, b"", pos
    ident = bytearray()
    for _ in range(8):
        if code in _SPACE:
            break
        ident.append(code)
        code = byte(pos)
        pos += 1
    if code not in _SPACE or bytes(ident) not in _PAM_FIELDS:
        raise _refused("PAM", f"with a header line {bytes(ident)!r}")
    if code in (10, 13):
        return bytes(ident), b"", pos
    code = byte(pos)
    pos += 1
    while code in _SPACE:
        code = byte(pos)
        pos += 1
    value = bytearray()
    for _ in range(255):
        value.append(code)
        code = byte(pos)
        pos += 1
        if code in (10, 13):
            break
    return bytes(ident), bytes(value).rstrip(_SPACE), pos


def read_pam(data):
    """A PAM file -> uint8 / uint16 [H, W] (DEPTH 1) or [H, W, 3] (DEPTH
    3), as grfmt_pam.cpp decodes it: the header's fields each once (WIDTH,
    HEIGHT, DEPTH, MAXVAL, ENDHDR; TUPLTYPE optional, its channels equal
    to DEPTH), numbers of digits only; without a TUPLTYPE, 1 channel of
    MAXVAL 1 is BLACKANDWHITE, of MAXVAL < 256 GRAYSCALE, 3 channels of
    MAXVAL < 256 RGB. Samples are copied as they are (RGB lands in
    OpenCV's B, G, R slots unswapped: ROADMAP C23), 16-bit ones big-endian;
    MAXVAL 1 reads each row's first bytes as bits (1 is 255). DEPTH 2 and
    4, which OpenCV 5.0 converts reading past its row buffer, raise
    ValueError (C23)."""
    if len(data) < 3 or data[2] not in (10, 13):
        raise _refused("PAM", "without its 'P7' line")
    pos, fields, tuple_ = 3, {}, None
    while True:
        ident, value, pos = _pam_line(data, pos)
        if ident is None:
            continue
        if ident == b"ENDHDR":
            break
        if ident in fields or (ident == b"TUPLTYPE" and tuple_ is not None):
            raise _refused("PAM", f"with {ident.decode()} twice")
        if ident == b"TUPLTYPE":
            if value not in _PAM_TUPLES:
                raise _refused("PAM", f"of TUPLTYPE {value!r}")
            tuple_ = value
            continue
        if not value.isdigit():
            raise _refused("PAM", f"with {ident.decode()} {value!r}")
        fields[ident] = int(value)
    if len(fields) != 4:
        raise _refused("PAM", "without its WIDTH, HEIGHT, DEPTH and MAXVAL")
    w, h, depth, maxval = (fields[k] for k in _PAM_FIELDS[:4])
    if maxval > 65535 or not 1 <= depth <= 4 or max(w, h, depth) > 0x7FFFFFFF:
        raise _refused("PAM", f"of DEPTH {depth}, MAXVAL {maxval}")
    if tuple_ is None:
        if depth == 1:
            tuple_ = b"BLACKANDWHITE" if maxval == 1 else b"GRAYSCALE"
        elif depth == 3:
            tuple_ = b"RGB"
        if tuple_ is None or maxval > 255:
            raise _refused("PAM", f"of DEPTH {depth}, MAXVAL {maxval} and no "
                           "TUPLTYPE")
    if _PAM_TUPLES[tuple_] != depth:
        raise _refused("PAM", f"of DEPTH {depth} and TUPLTYPE {tuple_!r}")
    _check_size("PAM", w, h)
    if depth in (2, 4):
        raise ValueError(f"PAM file of DEPTH {depth}: OpenCV 5.0 (the JAX "
                         "package's reader) converts it reading past its row "
                         "buffer; the port refuses it (ROADMAP C23)")
    wide = maxval > 255
    n = w * h * depth * (2 if wide else 1)
    if len(data) - pos < n:
        raise _refused("PAM", "cut short")
    if maxval == 1:
        rows = np.frombuffer(data, np.uint8, n, pos).reshape(h, w * depth)
        bits = np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
        return bits if depth == 1 else np.repeat(bits[..., None], 3, -1)
    a = np.frombuffer(data, ">u2" if wide else np.uint8, w * h * depth, pos)
    a = a.astype(np.uint16 if wide else np.uint8).reshape(h, w, depth)
    return np.ascontiguousarray(a[..., 0] if depth == 1 else a)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

def _bmp_rle(data, pos, w, h, rle4, pal, grey, nch):
    """grfmt_bmp.cpp's RLE8 / RLE4 decoder into rows top-down in file row
    order (rows[0] is the file's first row) -> [h, w * nch] uint8, or
    None where OpenCV gives up (readData false: no image). Skipped pixels
    (a delta, an end of line or of the bitmap) take palette entry 0."""
    width3 = w * nch
    out = np.zeros((h, width3), np.uint8)
    colour = pal if nch == 3 else grey[:, None]
    fill0 = colour[0]
    y, x = 0, 0                                   # x counts samples

    def need(n):
        if pos + n > len(data):
            raise _refused("BMP", "with a run-length stream cut short")

    def uni(count3, clr):
        """FillUniColor / FillUniGray: count3 samples of one colour,
        wrapping onto the next rows; -> whether y reached h."""
        nonlocal x, y
        while True:
            end = min(x + count3, width3)
            count3 -= end - x
            if end > x:
                out[y, x:end] = np.tile(clr, (end - x) // nch)
            x = end
            if x >= width3:
                x = 0
                y += 1
                if y >= h:
                    return True
            if count3 <= 0:
                return False

    line_end_flag = 0
    while True:
        need(2)
        ln, code = data[pos], data[pos + 1]
        pos += 2
        if ln:                                        # encoded mode
            if rle4:
                if x + ln * nch > width3:
                    return None
                cl = (colour[code >> 4], colour[code & 15])
                for t in range(ln):
                    out[y, x:x + nch] = cl[t & 1]
                    x += nch
            else:
                prev = y
                if x + ln * nch > width3:
                    return None
                if uni(ln * nch, colour[code]):
                    break
                line_end_flag = y - prev
        elif code > 2:                                # absolute mode
            if x + code * nch > width3:
                return None
            if rle4:
                sz = (((code + 1) >> 1) + 1) & ~1
                need(sz)
                b = np.frombuffer(data, np.uint8, sz, pos)
                idx = np.stack([b >> 4, b & 15], -1).reshape(-1)[:code]
            else:
                sz = (code + 1) & ~1
                need(sz)
                idx = np.frombuffer(data, np.uint8, code, pos)
            pos += sz
            prev = y
            out[y, x:x + code * nch] = colour[idx].reshape(-1)
            x += code * nch
            line_end_flag = y - prev
        elif rle4:
            shift = width3 - x
            if code == 2:
                need(2)
                shift = data[pos] * nch
                pos += 2
            if uni(shift, fill0):
                break
        else:
            shift, y_shift = width3 - x, h - y
            if code or not line_end_flag or shift < width3:
                if code == 2:
                    need(2)
                    shift, y_shift = data[pos] * nch, data[pos + 1]
                    pos += 2
                if code:                          # a delta or the end
                    shift += y_shift * width3
                if y >= h or uni(shift, fill0):
                    break
            line_end_flag = 0
            if y >= h:
                break
    return out


def read_bmp_cv(data):
    """A BMP file -> uint8 [H, W] or [H, W, 3] (B, G, R), as OpenCV 5.0's
    grfmt_bmp.cpp decodes it: BITMAPCOREHEADER (12 bytes) and info headers
    of 36 bytes or more; 1, 4, 8 bits through the palette (grey when every
    entry of 2^bits is, by OpenCV's fixed-point luma), RLE4 / RLE8, 16
    bits (555, or 565 under those bitfields), 24 and 32 bits (B, G, R,
    A dropped); bottom-up or top-down (a negative height)."""
    if len(data) < 18:
        raise _refused("BMP", "cut in its header")
    offset, size = struct.unpack("<Ii", data[10:18])
    if size <= 0:
        raise _refused("BMP", f"of header size {size}")
    pal = np.zeros((256, 3), np.uint8)
    colour = True
    if size >= 36:
        if len(data) < 50:
            raise _refused("BMP", "cut in its header")
        w, h, planes_bpp, comp = struct.unpack("<iiIi", data[18:34])
        bpp = planes_bpp >> 16
        clrused, = struct.unpack("<i", data[46:50])
        if not 0 <= comp <= 3:
            raise _refused("BMP", f"of compression {comp}")
        ok = w > 0 and h != 0 and (
            (bpp in (1, 4, 8, 16, 24, 32) and comp == 0)
            or (bpp in (16, 32) and comp == 3)
            or (bpp == 4 and comp == 2) or (bpp == 8 and comp == 1))
        pos = 14 + size
        if ok and bpp <= 8:
            if not 0 <= clrused <= 256:
                raise _refused("BMP", f"of {clrused} colours")
            n = clrused or 1 << bpp
            if pos + 4 * n > len(data):
                raise _refused("BMP", "cut in its palette")
            p = np.frombuffer(data, np.uint8, 4 * n, pos).reshape(n, 4)
            pal[:n] = p[:, :3]
            colour = not _palette_grey(pal[:1 << bpp])
        elif ok and bpp == 16 and comp == 3:
            if pos + 12 > len(data):
                raise _refused("BMP", "cut in its bitfields")
            masks = struct.unpack("<3i", data[pos:pos + 12])
            if masks == (0x7C00, 0x3E0, 0x1F):
                bpp = 15
            elif masks != (0xF800, 0x7E0, 0x1F):
                ok = False
        elif ok and bpp == 16:
            bpp = 15
    elif size == 12:
        if len(data) < 26:
            raise _refused("BMP", "cut in its header")
        w, h, planes_bpp = struct.unpack("<HHI", data[18:26])
        h = h - 65536 if h >= 32768 else h
        bpp, comp = planes_bpp >> 16, 0
        ok = w > 0 and h != 0 and bpp in (1, 4, 8, 24, 32)
        pos = 26
        if ok and bpp <= 8:
            n = 1 << bpp
            if pos + 3 * n > len(data):
                raise _refused("BMP", "cut in its palette")
            pal[:n] = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3)
        colour = False          # OpenCV reads a core-header file as grey
    else:
        ok = False
    if not ok:
        raise _refused("BMP", "of a layout OpenCV does not read")
    bottom_up = h > 0
    h = abs(h)
    _check_size("BMP", w, h)
    nch = 3 if colour else 1
    grey = _grey(pal[:, 0], pal[:, 1], pal[:, 2])
    if comp in (1, 2):
        rows = _bmp_rle(data, offset, w, h, comp == 2, pal, grey, nch)
        if rows is None:
            raise _refused("BMP", "with a run past its row")
        img = rows.reshape(h, w, nch)
    else:
        pitch = ((w * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
        if bpp <= 8:
            idx = _index_rows(data, offset, w, h, bpp, pitch, "BMP")
            img = pal[idx] if colour else grey[idx][..., None]
        elif offset + pitch * h > len(data):
            raise _refused("BMP", "cut short")
        else:
            rows = np.frombuffer(data, np.uint8, pitch * h,
                                 offset).reshape(h, pitch)
        if bpp in (15, 16):
            v = rows[:, :2 * w].copy().view("<u2").astype(np.int64)
            if bpp == 15:
                b, g, r = v << 3 & 0xF8, v >> 2 & 0xF8, v >> 7 & 0xF8
            else:
                b, g, r = v << 3 & 0xF8, v >> 3 & 0xFC, v >> 8 & 0xF8
            img = np.stack([b, g, r], -1).astype(np.uint8)
        elif bpp > 16:
            k = bpp // 8
            img = rows[:, :k * w].reshape(h, w, k)[..., :3]
        if bpp > 8 and not colour:
            img = _grey(img[..., 0], img[..., 1], img[..., 2])[..., None]
    if bottom_up:
        img = img[::-1]
    img = np.ascontiguousarray(img)
    return img[..., 0] if nch == 1 else img


# ---------------------------------------------------------------------------
# CMYK and YCCK JPEG
# ---------------------------------------------------------------------------

def cmyk_to_bgr(cmyk):
    """libjpeg's CMYK samples uint8 [H, W, 4] -> B, G, R as OpenCV's JPEG
    reader converts them (utils.cpp icvCvt_CMYK2BGR_8u_C4C3R): each ink
    x becomes k - ((255 - x) k >> 8), no inversion for Adobe's files."""
    k = cmyk[..., 3].astype(np.int64)
    c, m, y = (k - (((255 - cmyk[..., i].astype(np.int64)) * k) >> 8)
               for i in range(3))
    return np.stack([y, m, c], -1).astype(np.uint8)
