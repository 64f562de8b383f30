"""OpenCV 5.0's TIFF reader (grfmt_tiff.cpp over libtiff 4.7.1), as the
JAX package meets it under a .hdr / .exr name: `cv2.imread(p,
IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`. The rules below were read from the
pip cv2's decodes of generated files (its source is not at hand):

  * The directory is libtiff's (`tiffdir.LibtiffDir`), page 0. No
    Photometric tag, more than 4 samples, bits other than 1, 4 (palette
    only), 8, 16, 32 and 64, or a sample format the depth does not take
    (8 and 16 bits: unsigned or signed; 32: unsigned, signed or float; 64:
    the same) are refused. Past 8 bits a photometric past RGB or a sample
    count other than 1, 3 or 4 is read as 8 bits.
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
    (libtiff's JPEG colour mode: RGB), chunky or planar. Grey
    photometrics give one channel, the rest B, G, R.
  * The Orientation tag is applied as imread applies it (2-4 flips; 5-8
    transpose, which OpenCV 5.0 refuses for an image that is not square).

Returns OpenCV's image: [H, W] or [H, W, 3] (B, G, R) in its dtype.
ValueError for what OpenCV refuses; NotImplementedError naming ROADMAP
7e.4 for the rarer codecs and layouts (CCITT, ThunderScan, NeXT,
SGILog, CIELab, YCbCr without JPEG, 10-, 12- and 14-bit samples,
BigTIFF).
"""
from __future__ import annotations

import numpy as np

from . import cvread, imageio, tiffdir

# codecs the pip cv2's libtiff has that this module does not decode, and
# codecs it lacks (its libtiff refuses them: "not configured")
_LATER = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
          32771: "CCITT RLE", 32766: "NeXT", 32809: "ThunderScan",
          34676: "SGILog", 34677: "SGILog24"}
_NOT_CONFIGURED = (6, 32909, 34661, 34887, 34925, 50000, 50001, 50002)
_DTYPES = {(8, 1): "u1", (8, 2): "i1", (16, 1): "u2", (16, 2): "i2",
           (32, 1): "u4", (32, 2): "i4", (32, 3): "f4", (64, 1): "u8",
           (64, 2): "i8", (64, 3): "f8"}


def _refused(what):
    return cvread._refused("TIFF", what)


def _later(what):
    return imageio._not_ported(f"decoding {what} TIFF files as OpenCV does",
                               "7e.4")


def read_tiff_cv(data):
    """TIFF bytes -> OpenCV's image of it (module docstring)."""
    bo = {b"II*\0": "<", b"MM\0*": ">"}.get(data[:4])
    if bo is None:
        if data[:4] in (b"II+\0", b"MM\0+"):
            raise _later("BigTIFF")
        raise ValueError("not a TIFF file")
    d = tiffdir.LibtiffDir(data, bo)
    photo = d.photometric
    if photo is None:
        raise _refused("without a Photometric tag")
    if photo in (32844, 32845) or d.compression in (34676, 34677):
        raise _later("SGILog")
    grey = photo in (0, 1)
    bpp = d.bps
    ncn = d.spp if 277 in d.entries else (1 if grey else 3)
    sf = d.sample_format
    if bpp > 8 and (photo > 2 or ncn not in (1, 3, 4)):
        bpp = 8
    if not 1 <= ncn <= 4:
        raise _refused(f"of {ncn} samples a pixel")
    if bpp in (10, 12, 14):
        raise _later(f"{bpp}-bit")
    ok = {1: (1, 2), 4: (1, 2), 8: (1, 2), 16: (1, 2), 32: (1, 2, 3),
          64: (1, 2, 3)}.get(bpp)
    if ok is None or (bpp == 4 and photo != 3):
        raise _refused(f"of {bpp}-bit samples")
    if sf not in ok:
        raise _refused(f"of sample format {sf} at {bpp} bits")
    if bpp <= 8:
        colour = not grey and not (photo == 3 and bpp == 1)
        dtype = np.dtype(_DTYPES[8, sf])
    else:
        colour = not grey if bpp == 16 else ncn > 1
        dtype = np.dtype(_DTYPES[bpp, sf])
    w, h = d.width, d.length
    cvread._check_size("TIFF", w, h)
    if d.compression in _LATER:
        raise _later(_LATER[d.compression])
    if d.compression in _NOT_CONFIGURED:
        raise _refused(f"of compression {d.compression} (not configured in "
                       "OpenCV's libtiff)")
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
    buf, ok = imageio._tiff_decode(d.chunk(k), d.compression, rows * line,
                                   d.fill, keep=on_error == "keep")
    if not ok and on_error == "refuse":
        raise _refused(f"strip or tile {k} that libtiff fails to decode")
    pred = d.predictor
    if pred not in (1, 2, 3) or (pred == 2 and bits not in (8, 16, 32, 64)) \
            or (pred == 3 and (d.sample_format != 3 or bits not in (32, 64))):
        raise _refused(f"predictor {pred} at {bits} bits")
    if not ok:
        pred = 1         # libtiff runs the predictor on what decoded whole
    if bits < 8:
        rows_u = np.frombuffer(buf, np.uint8).reshape(rows, line)
        b = np.unpackbits(rows_u, axis=1)[:, :cols * cs * bits]
        v = b.reshape(rows, cols * cs, bits).astype(np.int64)
        v = (v << np.arange(bits - 1, -1, -1)).sum(-1)
        return v.reshape(rows, cols, cs).astype(np.uint8)
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
        if d.compression != 7:
            raise _later("YCbCr without JPEG")
    elif photo == 8:
        raise _later("CIELab")
    else:
        raise _refused(f"of photometric {photo}")


def _rgba_route(d, ncn, grey, colour):
    """8 bits and fewer: libtiff's RGBA interface, or OpenCV's scanline
    reads, which give the same samples (module docstring)."""
    _rgba_ok(d)
    photo, bps, spp = d.photometric, d.bps, d.spp
    w, h = d.width, d.length
    planar = d.planar == 2
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
    rgb = s[..., :3]
    alpha = d.extra[0] if d.extra else None
    if alpha == 2:                       # unassociated: premultiplied
        rgb = (rgb * s[..., 3:4] + 127) // 255
    return rgb[..., ::-1]


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
