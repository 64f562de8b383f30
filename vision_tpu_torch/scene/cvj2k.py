"""JPEG 2000 under a .hdr / .exr name, as the JAX package's loader gets it:
`cv2.imread(p, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`, the pip cv2 5.0.0's
Jpeg2KOpjDecoder (modules/imgcodecs/src/grfmt_jpeg2000_openjpeg.cpp) over
OpenJPEG 2.5.3's whole-image API (`j2k.WholeImage`: opj_read_header,
opj_decode, JP2's pclr / cmap / cdef applied by the library).

OpenCV's rules, read from the pip cv2's decodes and its messages:

  * readHeader: a JP2 signature box or SOC SIZ picks the codec; one to
    four components, none signed, the highest precision at least 8; the
    Mat is CV_8U for 8 bits, CV_16U for 9-16 (the samples kept as they
    are, no shift), a float type past 16 that readData refuses.
    IMREAD_ANYCOLOR asks for one channel where the codestream has one
    component, else three.
  * readData: opj_decode; the colour space from JP2's colr box: sRGB,
    and unknown or unspecified (no colr box, an ICC profile, a bare
    codestream) taken as sRGB; grey; sYCC; CMYK and e-YCC refused. Every
    component after the colour boxes must be whole (dx = dy = 1) and at
    x0 = y0 = 0.
  * The conversions: each sample cast to the Mat's depth (its low 8 or
    16 bits); sRGB as B, G, R from components 2, 1, 0 (a fourth dropped),
    or, for one channel, component 0 or those three reduced to grey by
    cvtColor's BGR2GRAY; grey as component 0 (repeated for three
    channels); sYCC's components 0, 1, 2 through cvtColor's YUV2BGR, or
    component 0 for one channel. A conversion OpenCV has no rule for (two
    sRGB components, one for three channels, fewer than three sYCC ones
    for three) is refused.

What OpenCV refuses raises ValueError (the JAX package's slot takes its
default). HTJ2K code-blocks (7e.7c) and Part 2's markers (7e.7d) raise
NotImplementedError from `j2k`.
"""
from __future__ import annotations

import numpy as np

from . import j2k
from .cvread import _check_size


def _refused(what):
    return ValueError(f"JPEG 2000 file {what}: OpenCV (the JAX package's "
                      "reader for .hdr / .exr names) refuses it too")


def bgr_to_grey(b, g, r):
    """cvtColor(COLOR_BGR2GRAY) of 8- or 16-bit samples: fixed point, 15
    bits (color_rgb.simd.hpp RGB2Gray)."""
    return (b.astype(np.int64) * 3735 + g.astype(np.int64) * 19235 +
            r.astype(np.int64) * 9798 + (1 << 14)) >> 15


def yuv_to_bgr(y, u, v, bits):
    """cvtColor(COLOR_YUV2BGR) of 8- or 16-bit samples (color_yuv.simd.hpp
    YCrCb2RGB_i, the YUV coefficients, fixed point, 14 bits, saturated)
    -> [..., 3] B, G, R."""
    def descale(x):
        return (x + (1 << 13)) >> 14
    half = 1 << (bits - 1)
    y = y.astype(np.int64)
    u, v = u.astype(np.int64) - half, v.astype(np.int64) - half
    bgr = np.stack([y + descale(u * 33292),
                    y + descale(u * -6472 + v * -9519),
                    y + descale(v * 18678)], -1)
    return np.clip(bgr, 0, (1 << bits) - 1)


def _header(data):
    """opj_read_header, then readHeader's checks -> (the image, its Mat's
    bits, its channels under IMREAD_ANYCOLOR)."""
    try:
        im = j2k.WholeImage(data)
    except (j2k._Fail, IndexError) as e:
        raise _refused(f"whose header OpenJPEG cannot read ({e})") from None
    if not 1 <= len(im.comps) <= 4:
        raise _refused(f"of {len(im.comps)} components")
    if any(sgnd for _, sgnd, _, _ in im.comps):
        raise _refused("of a signed component")
    prec = max(p for p, _, _, _ in im.comps)
    if prec < 8:
        raise _refused("of a precision below 8 bits")
    bits = 8 if prec == 8 else 16 if prec <= 16 else None
    _check_size("JPEG 2000", *im.size)
    return im, bits, 1 if len(im.comps) == 1 else 3


def read_cv(data):
    """JPEG 2000 bytes (a JP2 file or a bare codestream) -> OpenCV's image:
    uint8 / uint16 [H, W] or [H, W, 3] B, G, R."""
    im, bits, cn = _header(data)
    try:
        comps, space = im.decode()
    except (j2k._Fail, IndexError) as e:
        raise _refused(f"that OpenJPEG fails on ({e})") from None
    if space in (j2k._CMYK, j2k._EYCC):
        raise _refused("of a CMYK or e-YCC colour space")
    if bits is None:
        raise _refused("of a precision past 16 bits")
    w, h = im.size
    if any((c.dx, c.dy, c.x0, c.y0) != (1, 1, 0, 0) or
           c.data.shape != (h, w) for c in comps):
        raise _refused("of a sub-sampled component or an image offset "
                       "(\"tiles are not supported\")")
    mask = (1 << bits) - 1
    x = [c.data & mask for c in comps]
    n = len(x)
    if space == j2k._GRAY:
        out = x[0] if cn == 1 else np.stack([x[0]] * 3, -1)
    elif space == j2k._SYCC:
        if cn == 1:
            out = x[0]
        elif n >= 3:
            out = yuv_to_bgr(x[0], x[1], x[2], bits)
        else:
            raise _refused(f"of {n} sYCC components")
    elif n == 2 or (n == 1 and cn == 3):
        raise _refused(f"of {n} sRGB components for {cn} channels")
    elif cn == 1:
        out = x[0] if n == 1 else bgr_to_grey(x[2], x[1], x[0])
    else:
        out = np.stack([x[2], x[1], x[0]], -1)
    return out.astype(np.uint8 if bits == 8 else np.uint16)
