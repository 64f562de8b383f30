"""OpenCV 5.0's TIFF reader (grfmt_tiff.cpp over libtiff 4.7.1), as the
JAX package meets it under a .hdr / .exr name: `cv2.imread(p,
IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`. The rules below were read from the
pip cv2's decodes of generated files (its source is not at hand):

  * The directory is libtiff's (`tiffdir.LibtiffDir`), page 0, classic
    TIFF or BigTIFF. No Photometric tag, more than 4 samples, bits other
    than 1, 4 (palette only), 8, 10, 12, 14, 16, 32 and 64, or a sample
    format the depth does not take (8 to 16 bits: unsigned or signed; 32:
    unsigned, signed or float; 64: the same) are refused. Past 8 bits a
    photometric past RGB or a sample count other than 1, 3 or 4 is read
    as 8 bits.
  * 10, 12 and 14 bits: read as 16-bit samples are, each widened to 16
    bits (shifted left), signed ones saturated from that value.
  * 16, 32 and 64 bits: the samples as they are (uint16 / int16, uint32 /
    int32 / float32, uint64 / int64 / float64; min-is-white not
    inverted), read strip by strip or tile by tile (TIFFReadEncoded*):
    one sample as grey, three as B, G, R, four as B, G, R (the fourth
    dropped; refused at 32 and 64 bits); a grey photometric of more
    samples at 16 bits as OpenCV's grey of the first three (icvCvt_
    BGRA2Gray, fixed point), at 32 and 64 bits as colour. A planar file
    here reads its first plane as chunky samples and the rest of the
    buffer uninitialised: refused (ROADMAP C27).
  * 8 bits and fewer: through libtiff's RGBA interface
    (TIFFReadRGBAStrip / Tile), or, for one contiguous strip of 8-bit
    grey or RGB (and RGBA of associated alpha), scanline by scanline;
    both give: grey (min-is-white inverted; 1-bit 0 / 255; the first
    sample of several), palette (the colour map's high bytes, or the map
    itself where every entry is below 256; 1-bit palettes as OpenCV's
    grey of the colours), RGB (unassociated alpha premultiplied,
    (v * a + 127) / 255), CMYK ((255 - k)(255 - c) / 255), YCbCr JPEG
    (libtiff's JPEG colour mode: RGB), other YCbCr and CIELab through
    libtiff's own conversions (`ycbcr_to_rgb`, `cielab_to_rgb`), chunky or
    planar. Grey photometrics give one channel, the rest B, G, R.
  * The codecs are libtiff's (`imageio._tiff_decode`): CCITT, ThunderScan
    and the rest; LZMA, ZSTD, WebP and old-style JPEG are refused, as the
    pip cv2's libtiff lacks them (old-style JPEG is decoded on PIL's route
    only: `ojpeg.py`).
  * SGILog (tif_luv.c; `sgilog.py`, `native.sgilog_decode`). LogLuv
    (photometric 32845) of three samples (or no SamplesPerPixel tag) is
    read as float whatever its bits and sample format: OpenCV sets
    libtiff's SGILog data format to float, which SGILog (34676) and
    SGILog24 (34677) take and any other compression refuses; each strip or
    tile, contiguous only, goes through TIFFReadEncodedStrip / Tile (a row
    whose data runs out fails it, and the file) into X, Y, Z
    (LogLuv32toXYZ / LogLuv24toXYZ in float64, stored as float32; 0 where
    L <= 0, so the sign bit gives black); the orientation is applied, then
    cvtColor's XYZ2BGR in float32 (`_xyz2bgr`: the summation order of its
    vector loop and of its scalar tail). With no SamplesPerPixel tag
    libtiff reads one sample and rows of a third of the pixels, the rest of
    OpenCV's buffer uninitialised: refused (ROADMAP C34). LogL (32844) of
    one sample and SGILog compression goes through the RGBA reader, which
    asks the codec for 8-bit grey (L16toGry) and keeps a failed strip's
    rows before the error (zeros after); LogLuv of other than three
    samples, LogL of SGILog24 or more samples, and SGILog of any other
    photometric are refused.
  * The Orientation tag is applied as imread applies it (2-4 flips; 5-8
    transpose, which OpenCV 5.0 refuses for an image that is not square).

Returns OpenCV's image: [H, W] or [H, W, 3] (B, G, R) in its dtype.
ValueError for what OpenCV refuses.
"""
from __future__ import annotations

import numpy as np

from . import cvread, imageio, sgilog, tiffdir

# codecs the pip cv2's libtiff lacks (it refuses them: "not configured")
_NOT_CONFIGURED = (6, 32909, 34661, 34887, 34925, 50000, 50001, 50002)
_DTYPES = {(8, 1): "u1", (8, 2): "i1", (16, 1): "u2", (16, 2): "i2",
           (32, 1): "u4", (32, 2): "i4", (32, 3): "f4", (64, 1): "u8",
           (64, 2): "i8", (64, 3): "f8"}


def _refused(what):
    return cvread._refused("TIFF", what)


def read_tiff_cv(data):
    """TIFF bytes -> OpenCV's image of it (module docstring)."""
    if data[:4] not in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        raise ValueError("not a TIFF file")
    d = tiffdir.LibtiffDir(data, "<" if data[:2] == b"II" else ">")
    photo = d.photometric
    if photo is None:
        raise _refused("without a Photometric tag")
    grey = photo in (0, 1)
    bpp = d.bps
    ncn = d.spp if 277 in d.entries else (1 if grey else 3)
    if photo == tiffdir.LOGLUV and ncn == 3:
        cvread._check_size("TIFF", d.width, d.length)
        # OpenCV turns the XYZ image, then converts it
        return _xyz2bgr(_orient(_logluv_xyz(d), d.orientation))
    sf = d.sample_format
    if bpp > 8 and (photo > 2 or ncn not in (1, 3, 4)):
        bpp = 8
    if not 1 <= ncn <= 4:
        raise _refused(f"of {ncn} samples a pixel")
    ok = {1: (1, 2), 4: (1, 2), 8: (1, 2), 10: (1, 2), 12: (1, 2),
          14: (1, 2), 16: (1, 2), 32: (1, 2, 3), 64: (1, 2, 3)}.get(bpp)
    if ok is None or (bpp == 4 and photo != 3):
        raise _refused(f"of {bpp}-bit samples")
    if sf not in ok:
        raise _refused(f"of sample format {sf} at {bpp} bits")
    if bpp <= 8:
        colour = not grey and not (photo == 3 and bpp == 1)
        dtype = np.dtype(_DTYPES[8, sf])
    else:
        colour = not grey if bpp <= 16 else ncn > 1
        dtype = np.dtype(_DTYPES[max(bpp, 16), sf])
    w, h = d.width, d.length
    cvread._check_size("TIFF", w, h)
    if d.compression in _NOT_CONFIGURED:
        raise _refused(f"of compression {d.compression} (not configured in "
                       "OpenCV's libtiff)")
    # a codec whose setup fails leaves OpenCV's buffer as it was (C27)
    imageio._tiff_codec_setup(d)
    if bpp <= 8:
        img = _rgba_route(d, ncn, grey, colour)
    else:
        img = _direct_route(d, ncn, colour, dtype)
    return _orient(img.astype(dtype, copy=False), d.orientation)


def _samples(d, k, cols, rows, cs, kind="raw", on_error="refuse"):
    """Strip or tile k decoded as libtiff decodes it (TIFFReadEncoded*:
    the codec, fill order, predictor, byte order) -> samples [rows, cols,
    cs] as numbers (uint8 for 8 bits and fewer: packed rows unpacked). A
    strip libtiff cannot fetch is refused. A codec's error (read from the
    pip cv2's decodes of edited files, ROADMAP C27): `on_error` "refuse"
    (TIFFReadEncoded*, and OpenCV's scanline reads of uncompressed data)
    refuses the file; "keep" (TIFFReadRGBA*, which goes on past a strip's
    error, and the scanline reads of compressed data) keeps the bytes the
    codec gave before the error, zeros after (no predictor); "zero"
    (uncompressed data cut short there) gives zeros."""
    bits = d.bps
    if d.compression == 7:
        v = imageio._tiff_jpeg(d.chunk(k), d.jpegtables or b"", kind,
                               {530: tuple(d.subsampling)})
        return v[:rows, :cols, :cs].astype(np.uint8)
    line = -(-cols * cs * bits // 8)
    buf, ok = imageio._tiff_decode(d, k, rows * line, keep=on_error == "keep")
    if not ok and on_error == "refuse":
        raise _refused(f"strip or tile {k} that libtiff fails to decode")
    pred = d.predictor
    if pred not in (1, 2, 3) or (pred == 2 and bits not in (8, 16, 32, 64)) \
            or (pred == 3 and (d.sample_format != 3 or bits not in (32, 64))):
        raise _refused(f"predictor {pred} at {bits} bits")
    if not ok:
        pred = 1         # libtiff runs the predictor on what decoded whole
    if bits % 8:     # packed, most significant bit first
        rows_u = np.frombuffer(buf, np.uint8).reshape(rows, line)
        b = np.unpackbits(rows_u, axis=1)[:, :cols * cs * bits]
        v = b.reshape(rows, cols * cs, bits).astype(np.int64)
        v = (v << np.arange(bits - 1, -1, -1)).sum(-1).reshape(rows, cols, cs)
        return v.astype(np.uint8) if bits < 8 else v
    dt = np.dtype(_DTYPES[bits, d.sample_format if d.sample_format in (1, 2, 3)
                          else 1])
    if pred == 3:
        buf = imageio._tiff_fp_predictor(buf, rows, cols, cs, bits // 8)
        return np.frombuffer(buf, dt.newbyteorder(">"), rows * cols * cs) \
            .astype(dt).reshape(rows, cols, cs)
    v = np.frombuffer(buf, dt.newbyteorder(d.bo), rows * cols * cs).astype(dt)
    v = v.reshape(rows, cols, cs)
    if pred == 2:   # horizontal differencing, modulo the sample's width
        u = np.dtype(f"u{dt.itemsize}")
        v = np.cumsum(v.view(u), axis=1, dtype=u).view(dt)
    return v


def _direct_route(d, ncn, colour, dtype):
    """16, 32 and 64 bits: TIFFReadEncodedStrip / Tile into the image."""
    if d.planar == 2:
        raise _refused("planar at more than 8 bits: OpenCV reads its first "
                       "plane as chunky samples (ROADMAP C27)")
    if ncn != d.spp:
        raise _refused(f"of {d.spp} samples read as {ncn}: OpenCV reads past "
                       "them into an uninitialised buffer (ROADMAP C27)")
    if d.bps > 16 and ncn == 4:
        raise _refused("of four samples at more than 16 bits")
    if d.compression == 7:
        raise _refused("JPEG at more than 8 bits")
    w, h = d.width, d.length
    out = np.zeros((h, w, 3 if colour else 1), dtype)
    for x0, y0, cols, rows, _, k in d.chunks():
        v = _samples(d, k, cols, rows, d.spp)
        v = v[:min(rows, h - y0), :min(cols, w - x0)]
        if d.bps in (10, 12, 14):
            # widened to 16 bits; signed samples saturate from the widened
            # unsigned value
            v = v << (16 - d.bps)
            if d.sample_format == 2:
                v = np.minimum(v, 32767)
        if colour:
            v = v[..., [0, 0, 0]] if d.spp == 1 else v[..., 2::-1]
        elif d.spp > 1:     # OpenCV's grey of the first three samples
            s = v[..., :3].astype(np.int64)
            v = (s[..., :1] * 4899 + s[..., 1:2] * 9617 + s[..., 2:3] * 1868
                 + (1 << 13)) >> 14
        out[y0:y0 + v.shape[0], x0:x0 + v.shape[1]] = v
    return out if colour else out[..., 0]


def _rgba_ok(d):
    """TIFFRGBAImageOK, and TIFFRGBAImageBegin's own refusals."""
    photo, bps, spp = d.photometric, d.bps, d.spp
    if bps not in (1, 2, 4, 8, 16) or d.sample_format == 3:
        raise _refused(f"of {bps}-bit samples for libtiff's RGBA reader")
    colours = spp - len(d.extra)
    if photo in (0, 1, 3):
        if d.planar == 1 and spp != 1 and bps < 8:
            raise _refused("of packed samples below 8 bits")
        if photo == 3 and bps == 16:
            raise _refused("16-bit palette")
    elif photo == 2:
        if colours < 3 or bps != 8:
            raise _refused(f"RGB of {colours} colours at {bps} bits")
    elif photo == 5:
        if d.inkset != 1 or spp < 4 or bps != 8:
            raise _refused("separated, not 8-bit CMYK")
    elif photo == 6:
        if (d.compression != 7 or d.planar == 2) and \
                not ycbcr_has_routine(d):
            raise _refused("YCbCr of a layout libtiff's RGBA reader has no "
                           "routine for")
    elif photo == 8:
        if spp != 3 or colours != 3 or bps not in (8, 16) or d.planar == 2:
            raise _refused("CIELab of a layout libtiff's RGBA reader "
                           "refuses")
    elif photo == tiffdir.LOGL:
        if d.compression != 34676:
            raise _refused(f"LogL of compression {d.compression}")
    else:
        raise _refused(f"of photometric {photo}")


def _rgba_route(d, ncn, grey, colour):
    """8 bits and fewer: libtiff's RGBA interface, or OpenCV's scanline
    reads, which give the same samples (module docstring)."""
    _rgba_ok(d)
    photo, bps, spp = d.photometric, d.bps, d.spp
    w, h = d.width, d.length
    planar = d.planar == 2
    if photo == tiffdir.LOGL:
        return _logl_route(d)
    if photo == 6 and (d.compression != 7 or planar):
        # libtiff's JPEG codec converts chunky YCbCr itself
        return ycbcr_to_rgb(d, ycbcr_units(d))[..., ::-1]
    kind = "ycbcr" if photo == 6 else "grey" if grey else "rgb"
    # OpenCV reads one contiguous strip of 8-bit grey or RGB (RGBA of
    # associated alpha) by scanlines
    scanlines = not d.tile and bps == 8 and ncn in (1, 3, 4) and \
        photo in (0, 1, 2) and not planar and \
        (h if d.rows == 0xFFFFFFFF else d.rows) == h and \
        (ncn != 4 or d.extra == (1,))
    on_error = "keep" if d.compression != 1 else \
        "refuse" if scanlines else "zero"
    px = np.zeros((h, w, spp), np.uint16)
    for x0, y0, cols, rows, plane, k in d.chunks():
        if d.compression == 1 and d.tile and d.counts[k] != d.chunk_size(rows):
            # libtiff's sanity check before it allocates a tile's buffer
            raise _refused(f"tile {k} of {d.counts[k]} bytes, not "
                           f"{d.chunk_size(rows)}")
        cs = 1 if planar else spp
        v = _samples(d, k, cols, rows, 3 if photo == 6 else cs, kind,
                     on_error)
        v = v[:min(rows, h - y0), :min(cols, w - x0)]
        sl = slice(plane, plane + 1) if planar else slice(0, v.shape[-1])
        px[y0:y0 + v.shape[0], x0:x0 + v.shape[1], sl] = v
    s = px.astype(np.int64)
    if photo in (0, 1):
        g = s[..., 0] >> 8 if bps == 16 else s[..., 0] * 255 if bps == 1 \
            else s[..., 0]
        g = 255 - g if photo == 0 else g
        return g
    if photo == 3:
        cmap = np.asarray(d.colormap, np.int64).reshape(3, -1)
        if (cmap >= 256).any():
            cmap = cmap >> 8
        rgb = cmap.T[s[..., 0]]
        if not colour:
            return cvread._grey(rgb[..., 2], rgb[..., 1], rgb[..., 0])
        return rgb[..., ::-1]
    if photo == 5:
        k = 255 - s[..., 3:4]
        rgb = k * (255 - s[..., :3]) // 255
        return rgb[..., ::-1]
    if photo == 8:
        return cielab_to_rgb(d, s[..., :3])[..., ::-1]
    rgb = s[..., :3]
    alpha = d.extra[0] if d.extra else None
    if alpha == 2:                       # unassociated: premultiplied
        rgb = (rgb * s[..., 3:4] + 127) // 255
    return rgb[..., ::-1]


def _sgilog_codes(d, k, cols, rows):
    """Strip or tile k of SGILog data as libtiff's row decoders give it
    (`imageio._tiff_decode`): (uint32 codes [rows, cols], the rows after a
    failed one 0; whether every row decoded)."""
    buf, ok = imageio._tiff_decode(d, k, rows * cols * 4, keep=True)
    return np.frombuffer(buf, np.uint32).reshape(rows, cols), ok


def _logl_route(d):
    """LogL through libtiff's RGBA reader, which asks the codec for 8-bit
    grey (L16toGry) and goes on past a strip's error: the rows before it
    decoded, the rest 0. Returns grey [h, w]."""
    tiffdir.sgilog_setup(d)
    w, h = d.width, d.length
    out = np.zeros((h, w), np.int64)
    for x0, y0, cols, rows, _, k in d.chunks():
        codes, _ = _sgilog_codes(d, k, cols, rows)
        g = sgilog.l16_to_gry(codes)[:min(rows, h - y0), :min(cols, w - x0)]
        out[y0:y0 + g.shape[0], x0:x0 + g.shape[1]] = g
    return out


def _logluv_xyz(d):
    """LogLuv of three samples: OpenCV sets libtiff's SGILog data format to
    float and reads each strip or tile with TIFFReadEncodedStrip / Tile (a
    codec error refuses the file) -> float32 [h, w, 3] X, Y, Z
    (LogLuv32toXYZ / LogLuv24toXYZ)."""
    if d.compression not in (34676, 34677):
        raise _refused(f"LogLuv of compression {d.compression} (OpenCV's "
                       "TIFFSetField of the SGILog data format fails)")
    tiffdir.sgilog_setup(d)
    if d.spp != 3:
        raise _refused(f"LogLuv of {d.spp} samples read as 3: OpenCV reads "
                       "past them into an uninitialised buffer (ROADMAP "
                       "C34)")
    to_xyz = sgilog.logluv32_to_xyz if d.compression == 34676 else \
        sgilog.logluv24_to_xyz
    w, h = d.width, d.length
    out = np.zeros((h, w, 3), np.float32)
    for x0, y0, cols, rows, _, k in d.chunks():
        codes, ok = _sgilog_codes(d, k, cols, rows)
        if not ok:
            raise _refused(f"SGILog strip or tile {k} whose data ends before "
                           "its last row (libtiff's Not enough data)")
        v = to_xyz(codes[:min(rows, h - y0), :min(cols, w - x0)])
        out[y0:y0 + v.shape[0], x0:x0 + v.shape[1]] = v
    return out


# OpenCV 5.0's XYZ -> RGB coefficients (color_lab.cpp's XYZ2sRGB_D65), as
# float32
_XYZ2RGB = np.array([[3.240479, -1.53715, -0.498535],
                     [-0.969256, 1.875991, 0.041556],
                     [0.055648, -0.204043, 1.057311]], np.float32)


def _xyz2bgr(xyz):
    """cvtColor(COLOR_XYZ2BGR) of float32 [h, w, 3] as the pip cv2 computes
    it: each product and sum rounded to float32, no fused multiply-add; in
    each row its vector loop takes the first 4 floor(w / 4) pixels as c0 X
    + (c1 Y + c2 Z), its scalar tail the rest as (c0 X + c1 Y) + c2 Z."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    simd = np.arange(xyz.shape[1]) < 4 * (xyz.shape[1] // 4)
    out = np.empty_like(xyz)
    for ch, (c0, c1, c2) in enumerate(_XYZ2RGB[::-1]):
        a, b, c = c0 * x, c1 * y, c2 * z
        out[..., ch] = np.where(simd, a + (b + c), (a + b) + c)
    return out


def _orient(img, o):
    """imread's ApplyExifOrientation of the Orientation tag."""
    if o >= 5:
        if img.shape[0] != img.shape[1]:
            raise _refused(f"of orientation {o} and not square (OpenCV 5.0 "
                           "fails to turn it)")
        img = np.swapaxes(img, 0, 1)
        o = {5: 1, 6: 2, 7: 3, 8: 4}[o]
    if o == 2:
        img = img[:, ::-1]
    elif o == 3:
        img = img[::-1, ::-1]
    elif o == 4:
        img = img[::-1]
    return np.ascontiguousarray(img)


# ---------------------------------------------------------------------------
# libtiff's colour conversions of its RGBA reader (tif_getimage.c,
# tif_color.c), in float32 as libtiff computes them
# ---------------------------------------------------------------------------

# the YCbCrSubsampling values libtiff's RGBA reader has a routine for
_YCBCR_PUT = {(4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)}


def ycbcr_has_routine(d):
    """Whether libtiff's RGBA reader converts d's YCbCr itself: 8-bit, 3
    samples, a subsampling it has a routine for (only 1 x 1 planar)."""
    sub = tuple(d.subsampling)
    return d.bps == 8 and d.spp == 3 and sub in _YCBCR_PUT and (
        d.planar == 1 or sub == (1, 1))


def ycbcr_units(d, chunk=None):
    """A chunky or planar 8-bit YCbCr image's samples as libtiff's RGBA
    reader reads them: int64 [h, w, 3] (Y, Cb, Cr), each pixel with its
    data unit's Cb and Cr (units of hs x vs luma samples in row order,
    then Cb and Cr; partial units at the right and bottom edges). A strip
    is read to its rows rounded up to vs, in scanlines of the unit row's
    bytes / vs (libtiff's TIFFScanlineSize); a codec's error keeps what it
    gave, as the RGBA reader goes on. `chunk(k, n)`: chunky strip or tile
    k's n bytes as the reader gets them (default: its codec's)."""
    w, h = d.width, d.length
    hs, vs = d.subsampling[:2]
    out = np.zeros((h, w, 3), np.int64)
    for x0, y0, cols, rows, plane, k in d.chunks():
        if d.planar == 2:
            if d.compression == 7:      # each plane's JPEG data, as grey
                v = imageio._tiff_jpeg(d.chunk(k), d.jpegtables or b"",
                                       "grey", {})[:rows, :cols, 0]
            else:
                buf, _ = imageio._tiff_decode(d, k, rows * cols, keep=True)
                v = np.frombuffer(buf, np.uint8).reshape(rows, cols)
            v = v[:min(rows, h - y0), :min(cols, w - x0)]
            out[y0:y0 + v.shape[0], x0:x0 + v.shape[1], plane] = v
            continue
        uh, unit = -(-cols // hs), hs * vs + 2
        uv = -(-rows // vs)
        n = uv * vs * (uh * unit // vs) if not d.tile else uv * uh * unit
        buf = imageio._tiff_decode(d, k, n, keep=True)[0] if chunk is None \
            else chunk(k, n)
        u = np.zeros(uv * uh * unit, np.uint8)
        u[:n] = np.frombuffer(buf, np.uint8)
        u = u.reshape(uv, uh, unit).astype(np.int64)
        ys = u[..., :hs * vs].reshape(uv, uh, vs, hs).transpose(0, 2, 1, 3)
        ys = ys.reshape(uv * vs, uh * hs)
        cb = np.repeat(np.repeat(u[..., -2], vs, 0), hs, 1)
        cr = np.repeat(np.repeat(u[..., -1], vs, 0), hs, 1)
        v = np.stack([ys, cb, cr], -1)[:min(rows, h - y0), :min(cols, w - x0)]
        out[y0:y0 + v.shape[0], x0:x0 + v.shape[1]] = v
    return out


def _fix(x):
    """tif_color.c's FIX: a float32 times 2^16, then + 0.5 in double,
    truncated."""
    return int(float(np.float32(x) * np.float32(65536)) + 0.5)


def _code2v(c, rb, rw, cr):
    """tif_color.c's Code2V in float32: (c - (int) RB) * CR / (RW - RB)."""
    f32 = np.float32
    span = f32(rw) - f32(rb)
    num = f32(c - int(rb)) * f32(cr)
    return num / (span if span != 0 else f32(1))


def _clampw(f):
    """CLAMPw(f, -128 * 32, 128 * 32), then (int32_t)."""
    f = np.float32(f)
    return int(-4096.0 if f < -4096 else 4096.0 if f > 4096 else f)


def ycbcr_to_rgb(d, ycc):
    """libtiff's TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB of int [..., 3] (Y,
    Cb, Cr) under d's YCbCrCoefficients and ReferenceBlackWhite (given or
    defaulted) -> int64 [..., 3] R, G, B."""
    f32 = np.float32
    lr, lg, lb = d.floats(529, 3, [f32(0.299), f32(0.587), f32(0.114)])
    rbw = d.floats(532, 6, [f32(0), f32(255), f32(128), f32(255), f32(128),
                            f32(255)])
    if np.isnan([lr, lg, lb]).any() or lg == 0:
        raise _refused("of invalid YCbCrCoefficients")
    if not all(f32(-0x7FFFFFFF + 128) < x < f32(0x7FFFFFFF) for x in rbw):
        raise _refused("of invalid ReferenceBlackWhite")

    def clamp2(x):
        return min(max(x, f32(0)), f32(2))

    f1 = f32(2) - f32(2) * lr
    d1 = _fix(clamp2(f1))
    d2 = -_fix(clamp2(lr * f1 / lg))
    f3 = f32(2) - f32(2) * lb
    d3 = _fix(clamp2(f3))
    d4 = -_fix(clamp2(lb * f3 / lg))
    half = 1 << 15
    tab = np.zeros((5, 256), np.int64)
    for i in range(256):
        x = i - 128
        cr = _clampw(_code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127))
        cb = _clampw(_code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127))
        tab[:, i] = ((d1 * cr + half) >> 16, (d3 * cb + half) >> 16, d2 * cr,
                     d4 * cb + half,
                     _clampw(_code2v(x + 128, rbw[0], rbw[1], 255)))
    cr_r, cb_b, cr_g, cb_g, y_tab = tab
    y = y_tab[np.minimum(ycc[..., 0], 255)]
    cb, cr = np.clip(ycc[..., 1], 0, 255), np.clip(ycc[..., 2], 0, 255)
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16),
                    y + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255)


# tif_color.c's display_sRGB: the XYZ -> RGB matrix, then the guns' light
# output for black and white, pixel values for white and gamma
_SRGB_MAT = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                      [0.0556, -0.2040, 1.0570]], np.float32)
_CIELAB_RANGE = 1500


def cielab_to_rgb(d, lab):
    """libtiff's putcontig8bitCIELab8 / 16 of int [..., 3] (L, a, b as
    stored: a and b signed) under d's WhitePoint (or D50):
    TIFFCIELab16ToXYZ, TIFFXYZToRGB -> int64 [..., 3] R, G, B."""
    f32 = np.float32
    wp = d.floats(318, 2, [f32(96.4250) / (f32(96.4250) + f32(100.0) +
                                            f32(82.4680)),
                           f32(100.0) / (f32(96.4250) + f32(100.0) +
                                         f32(82.4680))])
    if wp[1] == 0:
        raise _refused("of an invalid WhitePoint")
    y0 = f32(100)
    x0 = wp[0] / wp[1] * y0
    z0 = (f32(1) - wp[0] - wp[1]) / wp[1] * y0
    lab = lab.astype(np.int64)
    if d.bps == 8:
        l16 = lab[..., 0] * 257
        a16 = ((lab[..., 1] ^ 0x80) - 0x80) * 256
        b16 = ((lab[..., 2] ^ 0x80) - 0x80) * 256
    else:
        l16 = lab[..., 0]
        a16 = (lab[..., 1] ^ 0x8000) - 0x8000
        b16 = (lab[..., 2] ^ 0x8000) - 0x8000
    with np.errstate(all="ignore"):
        L = l16.astype(f32) * f32(100) / f32(65535)
        low = L < f32(8.856)
        Y = np.where(low, (L * y0) / f32(903.292), f32(0))
        cby = np.where(low, f32(7.787) * (Y / y0) + f32(16) / f32(116),
                       (L + f32(16)) / f32(116))
        Y = np.where(low, Y, y0 * cby * cby * cby).astype(f32)
        t = a16.astype(f32) / f32(256) / f32(500) + cby
        X = np.where(t < f32(0.2069), x0 * (t - f32(0.13793)) / f32(7.787),
                     x0 * t * t * t).astype(f32)
        t = cby - b16.astype(f32) / f32(256) / f32(200)
        Z = np.where(t < f32(0.2069), z0 * (t - f32(0.13793)) / f32(7.787),
                     z0 * t * t * t).astype(f32)
        out = []
        for row in _SRGB_MAT:
            v = row[0] * X + row[1] * Y + row[2] * Z
            v = np.minimum(np.maximum(v, f32(1)), f32(100))
            step = (f32(100) - f32(1)) / f32(_CIELAB_RANGE)
            i = np.minimum(((v - f32(1)) / step).astype(np.int64),
                           _CIELAB_RANGE)
            table = f32(255) * np.power(
                np.arange(_CIELAB_RANGE + 1) / _CIELAB_RANGE,
                1.0 / float(f32(2.4))).astype(f32)
            t = table[i].astype(np.float64)
            out.append(np.minimum(np.where(t > 0, t + 0.5, t - 0.5)
                                  .astype(np.int64), 255))
    return np.stack(out, -1)
