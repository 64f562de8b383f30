"""Write the image and IES files of the port's textured test scenes into
`tests/assets_torch/`, with PIL and OpenCV (the port reads them with its
own decoders, `vision_tpu_torch/scene/imageio.py`, and needs neither).

    python tools/gen_torch_assets.py [out_dir]

  * `checker.png`: 64x64 RGB, 8x8 squares of a warm white and a blue.
  * `bumps.png`: 64x64 RGB tangent-space normal map of a 4x4 grid of
    domes, n * 0.5 + 0.5.
  * `projector.png`: 128x64 RGBA, three colour bands under a diagonal
    stripe pattern, alpha falling from left to right (the loader drops it).
  * `sky_a.hdr`, `sky_b.hdr`: 64x32 lat-long skies (a blue sky with a sun
    and a dark ground; a warm dusk gradient), Radiance RGBE with run-length
    scanlines as OpenCV writes them.
  * `spot.ies`: an LM-63-2002 profile with TILT=NONE, one horizontal angle
    and a soft cone of 10 vertical angles from 0 to 90 degrees (the narrow
    profile of tests/test_lights.py widened and smoothed).
  * JPEG files, written by PIL (libjpeg-turbo), and `jpeg_decodes.npz`,
    what PIL decodes from each (`Image.open(p).convert("RGB")`):
    `tiles.jpg` (128x128 terracotta tiles, 4:2:0, quality 90; the
    floor texture of `tests/torch_scenes.py` `gltf_cbox`), `strip.jpg`
    (33x65, 4:2:2, quality 50, optimized Huffman tables, a restart
    interval of 2 MCUs), `grey.jpg` (17x9 greyscale, quality 95) and
    `grain_2048.jpg` (2048x2048, 4:2:0, quality 85: smooth waves under a
    fine grain, the decoder's timing case; the .npz holds the sha256 of
    its decode and the decode of its 128x128 corner).
  * The files of slice 7c (`image_files`) and `image_decodes.npz`, what
    PIL decodes from each: progressive, CMYK, YCCK (a CMYK file's Adobe
    transform set to 2), RGB, lossless and arithmetic-coded JPEG (the last
    two by encoders here); Adam7, 2-, 4- and 16-bit
    PNG; TGA (run-length, colour-mapped, grey, 16-bit) and BMP (RLE8,
    RLE4, 1-bit, 565 bitfields, top-down, 32-bit with alpha) written by
    the small encoders here (PIL writes none of these PNG, TGA and BMP
    variants); `tiny.tif` (PIL's TIFF writer).
  * The TIFF and GIF files of slice 7d (`tiff_gif_files`): LZW with
    predictor 2 (old-style LZW too), Deflate tiles, planar PackBits,
    big-endian float with predictor 3 and 16-bit grey, 4-bit
    min-is-white in fill order 2, bilevel, palette, CMYK, associated
    alpha, 16-bit RGB, JPEG strips (YCbCr with JPEGTables, and PIL's RGB);
    GIFs interlaced, with a local table, a transparent index and a frame
    inside a larger screen, and of LZW code size 2; the twins
    `checker_lzw.tif`, `projector.gif` and `bumps.gif` of the scenes'
    PNGs (the same pixels); `lzw_2048.tif`, the TIFF timing case.
  * The WebP files of slice 7e.1 and `webp_decodes.npz`, written by
    `tools/gen_torch_webp.py` (its docstring lists them), `tiny.webp`
    among them.
  * The files of slice 7e.3a (`opencv_reader_files`: PPM, PGM, PAM, PFM,
    Sun raster, BMP and YCCK JPEG under .hdr / .exr names) and
    `cv_decodes.npz`, what the JAX package's loader gets for each through
    the pip cv2.
  * The files of slices 7e.6a and 7e.6b, `pil_decodes.npz` and
    `pil_rare_decodes.npz`, written by `tools/gen_torch_pil.py` (its
    docstring lists them).
  * The files of slice 7e.3b (TIFF and GIF under .hdr / .exr names) and
    `cvtiff_decodes.npz`, written by `tools/gen_torch_cvtiff.py` (its
    docstring lists them).
  * The SGILog TIFF files of slice 7e.4b on OpenCV's route,
    `sgilog_decodes.npz` and `vision_tpu_torch/data/sgilog_uv.npz`,
    written by `tools/gen_torch_sgilog.py` (its docstring lists them).
  * The JPEG 2000 files of slice 7e.7a (PIL's route), `j2k_decodes.npz`
    and the timing file `j2k_2048.jp2`, written by `tools/gen_torch_j2k.py`
    (its docstring lists them).
  * The JPEG 2000 files of slice 7e.7b (OpenCV's route) and
    `j2k_cv_decodes.npz`, written by `tools/gen_torch_j2k_cv.py` (its
    docstring lists them).
  * The AVIF files of slice 7e.8a.1 (PIL's route, lossless AV1),
    `avif_decodes.npz`, the twins' `checker_avif.avif` /
    `projector_avif.avif` with PIL's decodes as PNGs and the timing file
    `avif_2048.avif`, written by `tools/gen_torch_avif.py` (its docstring
    lists them).

The output is deterministic: running it again writes the same bytes.
"""
import os
import struct
import sys
import zlib

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "assets_torch")

IES = """IESNA:LM-63-2002
[TEST] port scene spot
[MANUFAC] generated by tools/gen_torch_assets.py
TILT=NONE
1 1000 1 10 1 1 2 0 0 0
1 1 0
0 10 20 30 40 50 60 70 80 90
0
1000 980 900 750 520 300 140 50 10 0
"""


def checker():
    y, x = np.mgrid[0:64, 0:64]
    on = ((x // 8 + y // 8) % 2).astype(bool)
    img = np.where(on[..., None], [235, 225, 205], [40, 70, 160])
    return img.astype(np.uint8)


def bumps():
    y, x = np.mgrid[0:64, 0:64].astype(np.float64)
    cx, cy = (x % 16) - 7.5, (y % 16) - 7.5
    r2 = (cx * cx + cy * cy) / 49.0
    dome = np.where(r2 < 1.0, np.sqrt(np.clip(1.0 - r2, 0.0, 1.0)), 0.0)
    gy, gx = np.gradient(dome * 3.0)
    n = np.stack([-gx, gy, np.ones_like(gx)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.round((n * 0.5 + 0.5) * 255.0).astype(np.uint8)


def projector():
    y, x = np.mgrid[0:64, 0:128]
    bands = np.array([[230, 60, 50], [60, 200, 80], [60, 90, 230]])
    rgb = bands[np.minimum(x * 3 // 128, 2)]
    stripe = ((x + y) // 6) % 2 == 0
    rgb = np.where(stripe[..., None], rgb, rgb // 3 + 40)
    alpha = (255 - x * 2)[..., None]
    return np.concatenate([rgb, alpha], -1).astype(np.uint8)


def sky(kind):
    h, w = 32, 64
    theta = (np.arange(h) + 0.5) / h * np.pi          # 0 at the +z pole
    phi = (np.arange(w) + 0.5) / w * 2.0 * np.pi
    t = np.cos(theta)[:, None] * np.ones((1, w))
    if kind == "a":
        up = np.clip(t, 0.0, 1.0)[..., None]
        img = (1.0 - up) * [1.1, 1.15, 1.2] + up * [0.25, 0.45, 1.0]
        img = np.where((t < 0.0)[..., None], [0.12, 0.1, 0.08], img)
        # a sun 40 degrees above the horizon at phi = 1.0
        ts, ps = np.deg2rad(50.0), 1.0
        d = (np.sin(theta)[:, None] * np.sin(ts) * np.cos(phi[None] - ps)
             + np.cos(theta)[:, None] * np.cos(ts))
        img = img + (d > np.cos(np.deg2rad(8.0)))[..., None] * [40.0, 36.0, 30.0]
    else:
        up = np.clip(t, 0.0, 1.0)[..., None]
        img = (1.0 - up) * [1.4, 0.6, 0.3] + up * [0.15, 0.12, 0.35]
        img = img * (0.8 + 0.2 * np.cos(phi))[None, :, None]
        img = np.where((t < 0.0)[..., None], [0.05, 0.04, 0.04], img)
    return img.astype(np.float32)


def tiles():
    y, x = np.mgrid[0:128, 0:128].astype(np.float64)
    grout = ((x % 32) < 2) | ((y % 32) < 2)
    tone = 0.85 + 0.15 * np.sin(0.9 * (x // 32) + 1.7 * (y // 32))[..., None]
    base = np.array([176.0, 92.0, 60.0]) * tone
    mottle = 12.0 * np.sin(x * 0.37 + np.cos(y * 0.21) * 3.0)[..., None]
    img = np.where(grout[..., None], [200.0, 196.0, 186.0], base + mottle)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def strip():
    y, x = np.mgrid[0:65, 0:33].astype(np.float64)
    r = 128 + 120 * np.sin(x * 0.4) * np.cos(y * 0.13)
    g = 255 * y / 64.0
    b = 255 - 7.7 * x
    return np.clip(np.round(np.stack([r, g, b], -1)), 0, 255).astype(np.uint8)


def grey():
    y, x = np.mgrid[0:9, 0:17]
    return ((x * 15 + y * 28) % 256).astype(np.uint8)


def grain(n=2048):
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / n
    waves = np.stack([np.sin(7.0 * x + 3.0 * y), np.cos(5.0 * y - 2.0 * x),
                      np.sin(11.0 * x * y + 1.0)], -1)
    noise = np.random.RandomState(1).randint(-9, 10, (n, n, 3))
    return np.clip(np.round(128 + 90 * waves + noise), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Small encoders for what PIL cannot write (Adam7 PNG, low bit depths, TGA
# variants, RLE and bitfield BMP); the reference decode is PIL's all the same
# ---------------------------------------------------------------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunk(kind, body):
    import struct
    import zlib
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_rows(v, depth):
    """Samples int [h, w, nch] -> filtered scanlines (each row's filter
    type cycling 0..4 from its index), bytes."""
    h, w, nch = v.shape
    if depth == 16:
        raw = np.stack([v >> 8, v & 255], -1).reshape(h, -1).astype(np.uint8)
    elif depth == 8:
        raw = v.reshape(h, -1).astype(np.uint8)
    else:
        bits = ((v.reshape(h, -1)[..., None] >> np.arange(depth - 1, -1, -1))
                & 1).reshape(h, -1).astype(np.uint8)
        raw = np.packbits(bits, axis=1)
    bpp = max(1, nch * depth // 8)
    out, prev = [], np.zeros(raw.shape[1], np.int32)
    for y in range(h):
        r = raw[y].astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        ft = y % 5
        pred = [0, a, prev, (a + prev) >> 1, _paeth(a, prev, c)][ft]
        out.append(bytes([ft]) + ((r - pred) & 255).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def png_bytes(v, depth, ctype, interlace=False, palette=None):
    """A PNG of samples v int [h, w, nch] at `depth` and colour type
    `ctype`, Adam7-interlaced if asked, with a PLTE of `palette` [n, 3]."""
    import struct
    import zlib
    h, w = v.shape[:2]
    if interlace:
        data = b"".join(_png_rows(v[y0::dy, x0::dx], depth)
                        for x0, y0, dx, dy in ADAM7
                        if x0 < w and y0 < h)
    else:
        data = _png_rows(v, depth)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    plte = b"" if palette is None else _png_chunk(
        b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr) + plte
            + _png_chunk(b"IDAT", zlib.compress(data, 9))
            + _png_chunk(b"IEND", b""))


def _rle_packets(px):
    """TGA run-length packets of pixels px uint8 [n, bytes a pixel]: runs
    of equal pixels (up to 128) and raw stretches (up to 128)."""
    out, i, n = [], 0, len(px)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and (px[j] == px[i]).all():
            j += 1
        if j - i > 1:
            out.append(bytes([0x80 | (j - i - 1)]) + px[i].tobytes())
            i = j
            continue
        j = i + 1
        while (j < n and j - i < 128
               and not (j + 1 < n and (px[j + 1] == px[j]).all())):
            j += 1
        out.append(bytes([j - i - 1]) + px[i:j].tobytes())
        i = j
    return b"".join(out)


def tga_bytes(px, image_type, depth, cmap=None, cmap_depth=24, cmap_start=0,
              top_down=False, right_to_left=False, id_field=b"",
              rle_rows=False):
    """A TGA of pixels px uint8 [h, w, bytes a pixel], in file byte order
    (BGR(A), an index or grey) and image order (row 0 at the top, column 0
    on the left): stored bottom-up unless top_down, mirrored if
    right_to_left, run-length coded for types 9-11 (packets across rows,
    or within rows with rle_rows)."""
    import struct
    h, w = px.shape[:2]
    rows = px if top_down else px[::-1]
    if right_to_left:
        rows = rows[:, ::-1]
    flags = (0x20 if top_down else 0) | (0x10 if right_to_left else 0)
    nmap = 0 if cmap is None else len(cmap)
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), int(cmap is not None),
                       image_type, cmap_start, nmap,
                       cmap_depth if cmap is not None else 0, 0, 0, w, h,
                       depth, flags)
    body = b"" if cmap is None else np.asarray(cmap, np.uint8).tobytes()
    if image_type & 8:
        flat = rows.reshape(h, w, -1)
        data = (b"".join(_rle_packets(r) for r in flat) if rle_rows
                else _rle_packets(flat.reshape(h * w, -1)))
    else:
        data = np.ascontiguousarray(rows).tobytes()
    return head + id_field + body + data


def bmp_bytes(w, h, bits, rows, palette=None, compression=0, masks=None,
              header=40, top_down=False, data=None):
    """A BMP of `rows` (bytes of each pixel row in file order, top row
    first; padded to 4 bytes here) or of ready `data` (RLE streams), with a
    BGRX palette [n, 4], bitfield masks after a 40-byte header or inside a
    larger one, stored bottom-up unless top_down."""
    import struct
    if data is None:
        stride = ((w * bits + 31) >> 3) & ~3
        order = rows if top_down else rows[::-1]
        data = b"".join(r + bytes(stride - len(r)) for r in order)
    pal = b"" if palette is None else np.asarray(palette, np.uint8).tobytes()
    extra = b""
    info = struct.pack("<iiHHIIiiII", w, -h if top_down else h, 1, bits,
                       compression, len(data), 2835, 2835,
                       0 if palette is None else len(palette), 0)
    if masks is not None:
        m = struct.pack("<4I", *(list(masks) + [0] * (4 - len(masks))))
        if header == 40:
            extra = m[:12]
        else:
            info += m
    info = info.ljust(header - 4, b"\0")
    off = 14 + header + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off)
            + struct.pack("<I", header) + info + extra + pal + data)


def bmp_rle(idx, rle4=False, delta=None):
    """An RLE8 / RLE4 stream of indices idx [h, w] (image order): each
    bottom-up row as encoded runs and absolute stretches, an end of line
    after each and an end of bitmap; `delta` = (row, col, right, up)
    inserts a delta escape at that place of the stream."""
    h, w = idx.shape
    out = []
    for y, row in enumerate(idx[::-1]):
        x = 0
        while x < w:
            if delta is not None and (y, x) == delta[:2]:
                out.append(bytes([0, 2, delta[2], delta[3]]))
            j = x + 1
            while j < w and j - x < 255 and row[j] == row[x]:
                j += 1
            if j - x >= 3 or w - x < 3:
                b = row[x] << 4 | row[x] if rle4 else row[x]
                out.append(bytes([j - x, b]))
                x = j
                continue
            n = min(w - x, 255 if not rle4 else 254, 10)
            seg = row[x:x + n]
            if rle4:
                seg2 = np.append(seg, 0) if n % 2 else seg
                body = bytes((seg2[0::2] << 4 | seg2[1::2]).astype(np.uint8))
            else:
                body = bytes(seg.astype(np.uint8))
            if len(body) % 2:
                body += b"\0"
            out.append(bytes([0, n]) + body)
            x += n
        out.append(b"\0\0")
    out.append(b"\0\1")
    return b"".join(out)


JPEGS = {  # name: (image, PIL save options)
    "tiles.jpg": (tiles, dict(quality=90, subsampling=2)),
    "strip.jpg": (strip, dict(quality=50, subsampling=1, optimize=True,
                              restart_marker_blocks=2)),
    "grey.jpg": (grey, dict(quality=95)),
    "grain_2048.jpg": (grain, dict(quality=85, subsampling=2)),
}
CORNER = 128  # the decode kept of the large file: its CORNER^2 top left


def write_jpegs(out):
    """The JPEG files and their PIL decodes (`jpeg_decodes.npz`)."""
    import hashlib
    from PIL import Image
    dec = {}
    for fn, (make, opts) in JPEGS.items():
        p = os.path.join(out, fn)
        Image.fromarray(make()).save(p, **opts)
        rgb = np.asarray(Image.open(p).convert("RGB"))
        key = fn.rsplit(".", 1)[0]
        if rgb.shape[0] > CORNER:
            dec[key + ".sha256"] = np.frombuffer(
                hashlib.sha256(rgb.tobytes()).digest(), np.uint8)
            dec[key + ".shape"] = np.asarray(rgb.shape)
            rgb = rgb[:CORNER, :CORNER]
        dec[key] = rgb
    np.savez_compressed(os.path.join(out, "jpeg_decodes.npz"), **dec)


def _lossless_diffs(x, psv, pt, first):
    """The differences (mod 2^16, in -32767..32768) of one component's
    samples x int [h, w] >> pt under predictor `psv`; the rows where
    `first` (bool [h], row 0 among them) is true are predicted from their
    left alone, their first sample from 2^(7 - pt)."""
    x = x.astype(np.int64) >> pt
    up = np.concatenate([x[:1], x[:-1]])
    ra, rb, rc = x[:, :-1], up[:, 1:], up[:, :-1]
    pred = np.empty_like(x)
    pred[:, 0] = up[:, 0]
    pred[:, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                   5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                   7: (ra + rb) >> 1}[psv]
    pred[first, 0] = 1 << (8 - pt - 1)
    pred[first, 1:] = x[first, :-1]
    d = (x - pred) & 0xFFFF
    return np.where(d > 32768, d - 65536, d)


def _lossless_segment(diffs):
    """The entropy-coded bytes of the differences `diffs` (int, in coding
    order) under `lossless_jpeg_bytes`' table: each its category in 5 bits,
    then its extra bits; padded with 1 bits to a byte, 0xFF stuffed."""
    d = np.asarray(diffs, np.int64).reshape(-1)
    cat = np.where(d == 32768, 16, np.frexp(np.abs(d))[1]).astype(np.int64)
    n = np.where(cat < 16, cat, 0)
    extra = np.where(d > 0, d, d - 1) & ((1 << n) - 1)
    length = 5 + n
    word = ((cat << n) | extra) << (32 - length)    # left-aligned in 32 bits
    bits = []
    for k in range(0, len(d), 1 << 20):
        w = word[k:k + (1 << 20)].astype(">u4")
        m = np.unpackbits(w.view(np.uint8)).reshape(-1, 32)
        bits.append(m[np.arange(32) < length[k:k + (1 << 20), None]])
    bits = np.concatenate(bits + [np.ones((-sum(map(len, bits))) % 8,
                                          np.uint8)])
    out = np.packbits(bits)
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def lossless_jpeg_bytes(img, psv=1, pt=0, restart_rows=0, app=b"",
                        sampling=None, per_component=False):
    """A lossless (SOF3) Huffman JPEG of img uint8 [h, w, nc] (nc 1, 3 or
    4): predictor `psv` (1-7), point transform `pt`, the segments `app`
    after SOI. sampling: each component's (h, v) factors (1x1 when None),
    its samples img[::vmax // v, ::hmax // h]; one interleaved scan (an MCU
    of h x v samples of each component, the right and bottom edges padded
    with zero differences), or with `per_component` one scan a component
    (an MCU one sample). A restart marker every `restart_rows` MCU rows of
    the first scan (the DRI segment's MCUs serve every scan); each restart
    interval's first row, in each component, predicted from its left. One
    DC table codes the 17 difference categories in 5 bits each."""
    import struct
    h, w, nc = img.shape
    sampling = list(sampling or [(1, 1)] * nc)
    hmax = max(f[0] for f in sampling)
    vmax = max(f[1] for f in sampling)
    planes = [img[::vmax // v, ::hmax // hh, c]
              for c, (hh, v) in enumerate(sampling)]
    mcux, mcuy = -(-w // hmax), -(-h // vmax)
    scans = [[c] for c in range(nc)] if per_component else [list(range(nc))]
    per_row = mcux if len(scans[0]) > 1 else planes[scans[0][0]].shape[1]
    interval = restart_rows * per_row

    def seg(m, body):
        return bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + body

    out = b""
    for comps in scans:
        if len(comps) > 1:            # MCU rows of every component's v rows
            units, rows_a_mcu, rst_rows = mcux * mcuy, 1, \
                interval // mcux if interval else 0
        else:
            units = planes[comps[0]].size
            rst_rows = interval // planes[comps[0]].shape[1] if interval \
                else 0
        coded = []
        for c in comps:
            p = planes[c]
            hh, v = sampling[c] if len(comps) > 1 else (1, 1)
            rows = np.arange(p.shape[0]) // v
            first = rows % rst_rows == 0 if rst_rows else rows == 0
            d = _lossless_diffs(p, psv, pt, first & (np.arange(len(rows)) % v
                                                     == 0))
            if len(comps) > 1:        # padded, in MCU order
                d = np.pad(d, ((0, mcuy * v - d.shape[0]),
                               (0, mcux * hh - d.shape[1])))
                d = d.reshape(mcuy, v, mcux, hh).transpose(0, 2, 1, 3)
                d = d.reshape(mcuy * mcux, v * hh)
            coded.append(d.reshape(units, -1))
        coded = np.concatenate(coded, 1)
        step = interval or units
        body = b"".join(
            (bytes([0xFF, 0xD0 + (k // step - 1) % 8]) if k else b"")
            + _lossless_segment(coded[k:k + step])
            for k in range(0, units, step))
        head = bytes([len(comps)]) + b"".join(bytes([c + 1, 0])
                                              for c in comps)
        out += seg(0xDA, head + bytes([psv, 0, pt])) + body
    frame = struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([c + 1, hh << 4 | v, 0]) for c, (hh, v) in enumerate(sampling))
    dht = bytes([0x00]) + bytes([0, 0, 0, 0, 17] + [0] * 11) + bytes(range(17))
    dri = seg(0xDD, struct.pack(">H", interval)) if interval else b""
    return (b"\xff\xd8" + app + seg(0xC3, frame) + seg(0xC4, dht) + dri
            + out + b"\xff\xd9")


# ITU-T T.81 Table D.2 as libjpeg packs it (jaricom.c): (Qe, Next_Index_LPS,
# Next_Index_MPS, Switch_MPS); entry 113 is libjpeg's fixed 0.5 estimate
_QE = [(0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
       (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
       (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
       (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
       (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
       (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
       (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
       (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
       (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
       (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
       (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
       (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
       (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
       (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
       (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
       (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
       (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
       (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
       (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
       (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
       (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
       (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
       (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
       (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
       (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
       (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
       (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
       (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
       (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
       (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
       (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
       (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
       (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
       (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
       (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
       (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
       (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
       (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
_NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
            26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42,
            49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59,
            52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


class _QMEncoder:
    """libjpeg's arithmetic encoder (jcarith.c): the QM coder's interval
    arithmetic, carry propagation through stacked 0xFF bytes and byte
    stuffing, its termination; statistics bins are bytearrays."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buf = \
            0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _zeros(self):
        self.out.extend(bytes(self.zc))
        self.zc = 0

    def _flush_byte(self, carry):
        if carry:  # a carry into the buffered byte: stacked 0xFF -> 0x00
            if self.buf >= 0:
                self._zeros()
                self._emit(self.buf + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buf == 0:
                self.zc += 1
            elif self.buf >= 0:
                self._zeros()
                self._emit(self.buf)
            if self.sc:
                self._zeros()
                self.out.extend(b"\xff\x00" * self.sc)
                self.sc = 0

    def encode(self, st, i, val):
        sv = st[i]
        qe, nl, nm, switch = _QE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:               # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (nl | switch << 7)
        else:                            # the more probable symbol
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:                      # renormalisation, output (D.1.6)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._flush_byte(True)
                    self.buf = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_byte(False)
                    self.buf = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        self._flush_byte(bool(self.c & 0xF8000000))
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        self.reset()


def _qm_magnitude(e, st, i, v, x2):
    """Figures F.8 and F.9: the category and bits of |v| - 1 from bin i
    (x2: the bin of the longer categories, None for DC, whose chain starts
    at bin 20 of the same table)."""
    m, v = 0, v - 1
    if v:
        e.encode(st, i, 1)
        m, v2 = 1, v
        if x2 is None:
            i = 20
            while v2 >> 1:
                v2 >>= 1
                e.encode(st, i, 1)
                m <<= 1
                i += 1
        elif v2 >> 1:
            v2 >>= 1
            e.encode(st, i, 1)
            m <<= 1
            i = x2
            while v2 >> 1:
                v2 >>= 1
                e.encode(st, i, 1)
                m <<= 1
                i += 1
    e.encode(st, i, 0)
    i += 14
    while m >> 1:
        m >>= 1
        e.encode(st, i, 1 if m & v else 0)


def _qm_dc(e, dc, ctx, last, ci, value, lo=0, up=1):
    """One DC value (F.1.4.1), its context updated (conditioning L, U)."""
    i = ctx[ci]
    v = value - last[ci]
    if v == 0:
        e.encode(dc, i, 0)
        ctx[ci] = 0
        return
    last[ci] = value
    e.encode(dc, i, 1)
    sign = int(v < 0)
    e.encode(dc, i + 1, sign)
    v = abs(v)
    ctx[ci] = 8 if sign else 4
    m = (v - 1).bit_length()
    cat = (1 << m) >> 1
    if cat < (1 << lo) >> 1:
        ctx[ci] = 0
    elif cat > (1 << up) >> 1:
        ctx[ci] += 8
    _qm_magnitude(e, dc, i + 2 + sign, v, None)


def _qm_ac(e, ac, fixed, blk, ss, se, al, kx=5):
    """An AC band (F.1.4.2, G.1.3.2 with its point transform al;
    conditioning K = kx)."""
    vals = [(-((-int(blk[_NATURAL[k]])) >> al) if blk[_NATURAL[k]] < 0
             else int(blk[_NATURAL[k]]) >> al) for k in range(64)]
    ke = se
    while ke >= ss and vals[ke] == 0:
        ke -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        e.encode(ac, i, 0)                   # not the end of block
        while vals[k] == 0:
            e.encode(ac, i + 1, 0)
            i += 3
            k += 1
        e.encode(ac, i + 1, 1)
        e.encode(fixed, 0, int(vals[k] < 0))
        _qm_magnitude(e, ac, i + 2, abs(vals[k]), 189 if k <= kx else 217)
        k += 1
    if k <= se:
        e.encode(ac, 3 * (k - 1), 1)         # the end of block


def _qm_ac_refine(e, ac, fixed, blk, ss, se, ah, al):
    """An AC refinement band (G.1.3.3)."""
    mag = [abs(int(blk[_NATURAL[k]])) for k in range(64)]
    neg = [int(blk[_NATURAL[k]]) < 0 for k in range(64)]
    ke = se
    while ke > 0 and not mag[ke] >> al:
        ke -= 1
    kex = ke
    while kex > 0 and not mag[kex] >> ah:
        kex -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            e.encode(ac, i, 0)
        while True:
            v = mag[k] >> al
            if v:
                if v >> 1:
                    e.encode(ac, i + 2, v & 1)
                else:
                    e.encode(ac, i + 1, 1)
                    e.encode(fixed, 0, int(neg[k]))
                break
            e.encode(ac, i + 1, 0)
            i += 3
            k += 1
        k += 1
    if k <= se:
        e.encode(ac, 3 * (k - 1), 1)


def _coefficients(sampling, mcus, q, seed):
    """Quantised coefficients int32 [rows, cols, 64] of each component for
    `mcus` (rows, columns) of MCUs: DC and a falling share of AC values
    within 8-bit JPEG's range (|value * q| <= 1000)."""
    g = np.random.RandomState(seed)
    lim = 1000 // q
    out = []
    for h, v in sampling:
        shape = (mcus[0] * v, mcus[1] * h)
        c = np.zeros(shape + (64,), np.int32)
        c[..., 0] = g.randint(-lim, lim + 1, shape)
        for k in range(1, 64):
            amp = max(1, int(lim / (1 + k / 4)))
            keep = g.random_sample(shape) < 0.5 / (1 + k / 8)
            c[..., _NATURAL[k]] = np.where(keep, g.randint(-amp, amp + 1,
                                                           shape), 0)
        out.append(c)
    return out


def arith_jpeg_bytes(coef, sampling, q=4, progressive=False, restart=0,
                     cond=(0, 1, 5), scans=None):
    """An arithmetic-coded JPEG (SOF9, or SOF10 with `progressive`) of the
    quantised coefficients coef[c] int [rows, cols, 64] (natural order,
    padded to whole MCUs) of components sampled (h, v) = sampling[c]; every
    quantiser q; a restart every `restart` MCUs of each scan. The
    progressive scans: DC first at Al 1 (all components), AC 1-5 and 6-63
    first at Al 1 (each), the DC and AC refinements to Al 0. cond: the
    conditioning (DC L, DC U, AC K) of every table, in a DAC segment when
    it is not T.81's default (0, 1, 5). scans: a sequential file's scans,
    each a list of component indices in scan order (repeats allowed, to
    write files a decoder must refuse); one scan of every component when
    None."""
    import struct
    nc = len(coef)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcuy, mcux = coef[0].shape[0] // sampling[0][1], \
        coef[0].shape[1] // sampling[0][0]
    H, W = 8 * vmax * mcuy, 8 * hmax * mcux

    def seg(m, body):
        return bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + body

    def scan(comps, ss, se, ah, al):
        e = _QMEncoder()
        dc = [bytearray(64) for _ in comps]
        ac = [bytearray(256) for _ in comps]
        fixed = bytearray([113])
        ctx, last = [0] * nc, [0] * nc
        if len(comps) == 1:
            c = comps[0]
            h, v = sampling[c]
            rows = -(-H * v // vmax // 8)
            cols = -(-W * h // hmax // 8)
            units = [[(c, r, k, 0)] for r in range(rows) for k in range(cols)]
        else:
            units = [[(c, my * sampling[c][1] + by,
                       mx * sampling[c][0] + bx, s)
                      for s, c in enumerate(comps)
                      for by in range(sampling[c][1])
                      for bx in range(sampling[c][0])]
                     for my in range(mcuy) for mx in range(mcux)]
        for n, unit in enumerate(units):
            if restart and n and n % restart == 0:
                e.finish()
                e.out.extend(bytes([0xFF, 0xD0 + (n // restart - 1) % 8]))
                for b in dc + ac:
                    b[:] = bytes(len(b))
                ctx, last = [0] * nc, [0] * nc
            for c, r, k, s_ in unit:  # s_: the component's scan slot
                blk = coef[c][r, k]
                lo, up, kx = cond
                if not progressive:
                    _qm_dc(e, dc[s_], ctx, last, s_, int(blk[0]), lo, up)
                    _qm_ac(e, ac[s_], fixed, blk, 1, 63, 0, kx)
                elif ss == 0 and ah == 0:
                    _qm_dc(e, dc[s_], ctx, last, s_, int(blk[0]) >> al, lo,
                           up)
                elif ss == 0:
                    e.encode(fixed, 0, (int(blk[0]) >> al) & 1)
                elif ah == 0:
                    _qm_ac(e, ac[s_], fixed, blk, ss, se, al, kx)
                else:
                    _qm_ac_refine(e, ac[s_], fixed, blk, ss, se, ah, al)
        e.finish()
        head = bytes([len(comps)]) + b"".join(
            bytes([c + 1, (s << 4) | s]) for s, c in enumerate(comps))
        return seg(0xDA, head + bytes([ss, se, ah << 4 | al])) + bytes(e.out)

    frame = struct.pack(">BHHB", 8, H, W, nc) + b"".join(
        bytes([c + 1, sampling[c][0] << 4 | sampling[c][1], 0])
        for c in range(nc))
    out = (b"\xff\xd8" + seg(0xDB, bytes([0]) + bytes([q] * 64))
           + seg(0xCA if progressive else 0xC9, frame))
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    if tuple(cond) != (0, 1, 5):
        out += seg(0xCC, b"".join(bytes([t, cond[1] << 4 | cond[0],
                                         0x10 | t, cond[2]])
                                  for t in range(nc)))
    everyone = list(range(nc))
    if not progressive:
        for comps in scans or [everyone]:
            out += scan(comps, 0, 63, 0, 0)
    else:
        out += scan(everyone, 0, 0, 0, 1)
        for c in everyone:
            out += scan([c], 1, 5, 0, 1) + scan([c], 6, 63, 0, 1)
        out += scan(everyone, 0, 0, 1, 0)
        for c in everyone:
            out += scan([c], 1, 63, 1, 0)
    return out + b"\xff\xd9"


def lzw_encode(data, min_bits=8, msb=True):
    """LZW of `data` as TIFF writes it (msb: codes most significant bit
    first, 9 to 12 bits, the width raised one code early) or as GIF and
    old-style TIFF write it (least significant bit first, codes from
    min_bits + 1 bits): a clear code first, a clear whenever the table
    fills, the end code last."""
    clear, eoi = 1 << min_bits, (1 << min_bits) + 1
    early = 1 if msb else 0
    out = bytearray()
    acc = n = 0

    def emit(code, width):
        nonlocal acc, n
        if msb:
            acc = (acc << width) | code
            n += width
            while n >= 8:
                out.append((acc >> (n - 8)) & 0xFF)
                n -= 8
        else:
            acc |= code << n
            n += width
            while n >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                n -= 8

    def reset():
        return {bytes([i]): i for i in range(clear)}, eoi + 1, min_bits + 1

    table, nxt, width = reset()
    emit(clear, width)
    w = b""
    for byte in bytes(data):
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        emit(table[w], width)
        table[wc] = nxt
        nxt += 1
        # the decoder adds its entry one code later: it reads the next
        # code at the width its table then asks for
        if nxt - 1 + early >= 1 << width and width < 12:
            width += 1
        if nxt >= 4093:
            emit(clear, width)
            table, nxt, width = reset()
        w = bytes([byte])
    if w:
        emit(table[w], width)
    emit(eoi, width)
    if n:
        out.append(((acc << (8 - n)) & 0xFF) if msb else acc & 0xFF)
    return bytes(out)


def packbits_encode(data):
    """TIFF PackBits: runs of 3 or more repeats, literals between."""
    data = bytes(data)
    out = bytearray()
    i = 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < len(data) and j - i < 128 and not (
                j + 2 < len(data) and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


_BITREV = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _tiff_pack(v, bits, bo, predictor):
    """Samples [rows, cols, spp] -> the chunk's bytes, differenced by the
    predictor (2: horizontal; 3: floating point byte planes)."""
    rows, cols, spp = v.shape
    if predictor == 3:
        nb = bits // 8
        b = np.ascontiguousarray(v.astype(f">f{nb}")).view(np.uint8)
        b = b.reshape(rows, cols * spp, nb).transpose(0, 2, 1).reshape(
            rows, -1, spp).astype(np.int64)
        d = b.copy()
        d[:, 1:] = (b[:, 1:] - b[:, :-1]) & 0xFF
        return d.astype(np.uint8).tobytes()
    if predictor == 2:
        v = v.view(f"u{bits // 8}") if v.dtype.kind == "f" else v
        v = v.astype(np.int64)
        d = v.copy()
        d[:, 1:] = (v[:, 1:] - v[:, :-1]) & ((1 << bits) - 1)
        v = d
    if bits < 8:
        flat = v.reshape(rows, cols * spp).astype(np.uint8)
        bitsarr = ((flat[..., None] >> np.arange(bits - 1, -1, -1)) & 1)
        return np.packbits(bitsarr.reshape(rows, -1).astype(np.uint8),
                           axis=1).tobytes()
    if v.dtype.kind == "f":
        return np.ascontiguousarray(v.astype(bo + f"f{bits // 8}")).tobytes()
    if bits % 8:
        # 10-, 12- and 14-bit samples: packed most significant bit first,
        # each row padded to a byte, as TIFF stores them
        flat = v.reshape(rows, cols * spp).astype(np.int64)
        b = (flat[..., None] >> np.arange(bits - 1, -1, -1)) & 1
        return np.packbits(b.reshape(rows, -1).astype(np.uint8),
                           axis=1).tobytes()
    return np.ascontiguousarray(v.astype(bo + f"u{bits // 8}")).tobytes()


# entry type -> struct code of one value (rationals: two)
_TIFF_CODES = {3: "H", 4: "I", 5: "I", 6: "b", 8: "h", 9: "i", 10: "i",
               11: "f", 12: "d", 16: "Q"}


def bigtiff(data, long8=True):
    """A classic TIFF of `tiff_bytes` (or any one-directory classic file)
    laid out again as BigTIFF: the 16-byte header, the body after it moved
    by 8 bytes, directory 0 rewritten at the end with 20-byte entries
    (values of up to 8 bytes inside them); the strip or tile offsets and
    byte counts as LONG8 (`long8`) or LONG."""
    bo = "<" if data[:2] == b"II" else ">"
    off, = struct.unpack(bo + "I", data[4:8])
    n, = struct.unpack(bo + "H", data[off:off + 2])
    body = bytearray(struct.pack(bo + "2sHHHQ", data[:2], 43, 8, 0, 0))
    body += data[8:]
    body += bytes(len(body) % 2)
    units = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
             11: 4, 12: 8, 16: 8}
    entries = []
    for k in range(n):
        e = off + 2 + 12 * k
        tag, typ, count = struct.unpack(bo + "HHI", data[e:e + 8])
        size = units[typ] * count
        at = e + 8 if size <= 4 else struct.unpack(bo + "I",
                                                   data[e + 8:e + 12])[0]
        raw = data[at:at + size]
        if tag in (273, 279, 324, 325):
            vals = struct.unpack(bo + {3: "H", 4: "I"}[typ] * count, raw)
            if tag in (273, 324):
                vals = [v + 8 for v in vals]
            typ = 16 if long8 else 4
            raw = struct.pack(bo + ("Q" if long8 else "I") * count, *vals)
        entries.append((tag, typ, count, raw))
    ifd = len(body)
    blob_at = ifd + 8 + 20 * n + 8
    out, blobs = bytearray(), bytearray()
    for tag, typ, count, raw in entries:
        if len(raw) <= 8:
            field = raw.ljust(8, b"\0")
        else:
            field = struct.pack(bo + "Q", blob_at + len(blobs))
            blobs += raw + bytes(len(raw) % 2)
        out += struct.pack(bo + "HHQ", tag, typ, count) + field
    body[8:16] = struct.pack(bo + "Q", ifd)
    return bytes(body + struct.pack(bo + "Q", n) + out + bytes(8) + blobs)


def tiff_bytes(samples, bits, photometric, compression=1, predictor=1,
               rows_per_strip=None, tile=None, planar=False, fill=1, bo="<",
               extra=(), sampleformat=None, colormap=None, jpeg_chunks=None,
               jpeg_tables=None, ycbcr_sub=None, lzw_old=False, chunks=None,
               tags=None):
    """A classic TIFF of samples [h, w, spp] (ints, or floats for
    sampleformat 3): strips of rows_per_strip rows or (tw, th) tiles
    (edge tiles padded), chunky or planar, compression 1 (none), 5 (LZW;
    lzw_old: old-style, least significant bit first), 8 / 32946
    (Deflate), 32773 (PackBits), 50000 (ZSTD, needs the `zstandard`
    module) or any other with its `chunks` (or
    `jpeg_chunks`: 7, JPEG, with `jpeg_tables`) given coded, predictors
    1-3, fill order 2 (each chunk's bytes bit-reversed), either byte
    order; `tags` {tag: (type, values)} added or replacing the writer's."""
    samples = np.asarray(samples)
    h, w, spp = samples.shape
    if tile:
        tw, th = tile
    else:
        tw, th = w, rows_per_strip or h
    given = chunks if chunks is not None else jpeg_chunks
    chunks = []
    planes = range(spp) if planar else [None]
    for pl in planes:
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                if given is not None:
                    chunks.append(given[len(chunks)])
                    continue
                v = samples[y0:y0 + th, x0:x0 + tw]
                if pl is not None:
                    v = v[..., pl:pl + 1]
                if tile:
                    pad = np.zeros((th, tw, v.shape[2]), v.dtype)
                    pad[:v.shape[0], :v.shape[1]] = v
                    v = pad
                raw = _tiff_pack(v, bits, bo, predictor)
                if compression == 5:
                    raw = lzw_encode(raw, 8, msb=not lzw_old)
                elif compression in (8, 32946):
                    raw = zlib.compress(raw, 9)
                elif compression == 32773:
                    raw = packbits_encode(raw)
                elif compression == 50000:
                    import zstandard
                    raw = zstandard.ZstdCompressor(level=9).compress(raw)
                if fill == 2:
                    raw = raw.translate(_BITREV)
                chunks.append(raw)
    body = bytearray(b"II*\0" if bo == "<" else b"MM\0*")
    body += b"\0\0\0\0"
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c
        if len(body) % 2:
            body += b"\0"
    tags, more = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
                  259: (3, [compression]), 262: (3, [photometric]),
                  277: (3, [spp]), 284: (3, [2 if planar else 1])}, tags
    if fill != 1:
        tags[266] = (3, [fill])
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra:
        tags[338] = (3, list(extra))
    if sampleformat is not None:
        tags[339] = (3, [sampleformat] * spp)
    if colormap is not None:
        tags[320] = (3, list(np.asarray(colormap).T.ravel()))
    if jpeg_tables is not None:
        tags[347] = (7, jpeg_tables)
    if ycbcr_sub is not None:
        tags[530] = (3, list(ycbcr_sub))
    if tile:
        tags[322], tags[323] = (3, [tw]), (3, [th])
        tags[324] = (4, offsets)
        tags[325] = (4, [len(c) for c in chunks])
    else:
        tags[273] = (4, offsets)
        tags[278] = (3, [th])
        tags[279] = (4, [len(c) for c in chunks])
    tags.update(more or {})
    entries, blobs = [], bytearray()
    ifd_at = len(body)
    end = ifd_at + 2 + 12 * len(tags) + 4
    for tag in sorted(tags):
        typ, vals = tags[tag]
        if typ in (1, 2, 7):
            data = bytes(vals)
            count = len(data)
        else:
            data = struct.pack(bo + _TIFF_CODES[typ] * len(vals), *vals)
            count = len(vals) // (2 if typ in (5, 10) else 1)
        if len(data) <= 4:
            field = data.ljust(4, b"\0")
        else:
            field = struct.pack(bo + "I", end + len(blobs))
            blobs += data
            if len(blobs) % 2:
                blobs += b"\0"
        entries.append(struct.pack(bo + "HHI", tag, typ, count) + field)
    body[4:8] = struct.pack(bo + "I", ifd_at)
    body += struct.pack(bo + "H", len(tags)) + b"".join(entries) + bytes(4)
    body += blobs
    return bytes(body)


def gif_bytes(idx, palette=None, min_bits=None, interlace=False,
              transparency=None, local=False, screen=None, offset=(0, 0),
              lzw=None):
    """A GIF of one frame: indices [h, w] through `palette` [n, 3] (the
    global table, or the frame's local one), LZW of min_bits (default:
    the palette's bits, at least 2), rows interlaced if asked, a graphic
    control extension with a transparent index, the frame at `offset` on
    a screen of `screen` (w, h); `lzw` replaces the coded data."""
    idx = np.asarray(idx, np.uint8)
    fh, fw = idx.shape
    sw, sh = screen or (fw, fh)
    table = b""
    tbits = 0
    if palette is not None:
        pal = np.asarray(palette, np.uint8)
        tbits = max(1, (len(pal) - 1).bit_length())
        table = pal.tobytes() + bytes(3 * ((1 << tbits) - len(pal)))
    gflags = 0x80 | (tbits - 1) if table and not local else 0
    out = b"GIF89a" + struct.pack("<HHBBB", sw, sh, gflags, 0, 0)
    if table and not local:
        out += table
    if transparency is not None:
        out += b"!\xf9\x04\x01\x00\x00" + bytes([transparency]) + b"\0"
    rows = idx
    if interlace:
        order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                np.arange(2, fh, 4), np.arange(1, fh, 2)])
        rows = idx[order]
    lflags = (0x40 if interlace else 0) | (
        (0x80 | (tbits - 1)) if table and local else 0)
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], fw, fh, lflags)
    if table and local:
        out += table
    mb = min_bits or max(2, tbits)
    data = lzw if lzw is not None else lzw_encode(rows.tobytes(), mb,
                                                  msb=False)
    out += bytes([mb])
    for i in range(0, len(data), 255):
        out += bytes([len(data[i:i + 255])]) + data[i:i + 255]
    return out + b"\0;"


def _pil_jpeg(img, mode=None, **opts):
    import io
    from PIL import Image
    b = io.BytesIO()
    im = Image.fromarray(img)
    (im.convert(mode) if mode else im).save(b, "JPEG", **opts)
    return b.getvalue()


def _adobe_transform(data, t):
    """`data` with its Adobe APP14 colour transform set to t."""
    i = data.index(b"Adobe") + 11
    return data[:i] + bytes([t]) + data[i + 1:]


def _indices(img, levels=4):
    """A palette index per pixel of an RGB image: its R and G quantised."""
    q = img.astype(np.int32) * levels // 256
    return (q[..., 0] * levels + q[..., 1]).astype(np.uint8)


def image_files():
    """The files of slice 7c (name -> bytes): JPEG variants PIL writes or
    that differ from one only in a marker byte, lossless and
    arithmetic-coded JPEG, and PNG, TGA and BMP files written by the
    encoders above; `tiny.tif`, a TIFF,
    stays undecoded (ROADMAP 7d)."""
    import io
    from PIL import Image
    rgb = strip()                                   # 33 x 65
    g = np.random.RandomState(7)
    pal16 = g.randint(0, 256, (16, 3))
    idx = _indices(rgb)                             # 0..15
    bgrx = np.concatenate([pal16[:, ::-1], np.zeros((16, 1), int)], 1)
    cmyk = _pil_jpeg(rgb, "CMYK", quality=85)
    grey16 = (np.add.outer(np.arange(40), np.arange(24)) * 97 % 65536)
    files = {
        "progressive.jpg": _pil_jpeg(rgb, quality=80, progressive=True),
        "progressive_tiles.jpg": _pil_jpeg(tiles(), quality=90, subsampling=2,
                                           progressive=True, optimize=True,
                                           restart_marker_blocks=3),
        "cmyk.jpg": cmyk,
        "ycck.jpg": _adobe_transform(cmyk, 2),
        "rgb_adobe.jpg": _pil_jpeg(rgb, quality=90, keep_rgb=True),
        "lossless.jpg": lossless_jpeg_bytes(rgb, psv=4, pt=1, restart_rows=8),
        "arith.jpg": arith_jpeg_bytes(_coefficients(((1, 1),), (3, 4), 4, 1),
                                      ((1, 1),), q=4, restart=5),
        "arith_progressive.jpg": arith_jpeg_bytes(
            _coefficients(((2, 2), (1, 1), (1, 1)), (2, 3), 8, 2),
            ((2, 2), (1, 1), (1, 1)), q=8, progressive=True, restart=2,
            cond=(1, 3, 2)),
        "adam7.png": png_bytes(rgb, 8, 2, interlace=True),
        "pal4_adam7.png": png_bytes(idx[..., None], 4, 3, interlace=True,
                                    palette=pal16),
        "grey2.png": png_bytes((grey()[..., None] >> 6), 2, 0),
        "grey16.png": png_bytes(grey16[..., None], 16, 0),
        "la16.png": png_bytes(np.stack([grey16, 65535 - grey16], -1), 16, 4),
        "rle24.tga": tga_bytes(rgb[..., ::-1], 10, 24, rle_rows=True),
        "cmap16_topright.tga": tga_bytes(
            idx[..., None], 1, 8, cmap=((pal16 >> 3) @ [1024, 32, 1]).astype(
                "<u2")[:, None].view(np.uint8),
            cmap_depth=16, cmap_start=0, top_down=True, right_to_left=True),
        "grey_rle.tga": tga_bytes((rgb[..., 1:2] >> 3) << 3, 11, 8,
                                  rle_rows=True),
        "rgb16.tga": tga_bytes(((rgb >> 3) @ [1024, 32, 1]).astype(
            "<u2")[..., None].view(np.uint8), 2, 16),
        "rle8.bmp": bmp_bytes(33, 65, 8, None, palette=bgrx, compression=1,
                              data=bmp_rle(idx, delta=(3, 0, 2, 1))),
        "rle4.bmp": bmp_bytes(33, 65, 4, None, palette=bgrx, compression=2,
                              data=bmp_rle(idx, rle4=True)),
        "pal1.bmp": bmp_bytes(33, 65, 1, [np.packbits(r & 1).tobytes()
                                          for r in idx], palette=bgrx[:2]),
        "bf565_v5.bmp": bmp_bytes(33, 65, 16, [r.tobytes() for r in (
            (rgb >> [3, 2, 3]) @ [2048, 32, 1]).astype("<u2")],
            compression=3, masks=(0xF800, 0x7E0, 0x1F), header=124),
        "topdown24.bmp": bmp_bytes(33, 65, 24, [r[:, ::-1].tobytes()
                                                for r in rgb], top_down=True),
        "bgra32_v4.bmp": bmp_bytes(33, 65, 32, [np.concatenate(
            [r, r[:, :1]], 1).astype(np.uint8).tobytes() for r in rgb],
            compression=3, masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000),
            header=108),
    }
    b = io.BytesIO()
    Image.fromarray(rgb[:8, :8]).save(b, "TIFF")
    files["tiny.tif"] = b.getvalue()
    files.update(tiff_gif_files(rgb, idx, pal16))
    return files


def _jpeg_split(data):
    """A JPEG -> (its tables as an abbreviated stream: SOI, DQT, DHT, EOI;
    the rest, as TIFF's JPEG strips store it)."""
    pos, seg = 2, []
    while pos < len(data):
        m = data[pos + 1]
        if m == 0xDA:
            seg.append((m, data[pos:]))
            break
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg.append((m, data[pos:pos + 2 + n]))
        pos += 2 + n
    tables = b"\xff\xd8" + b"".join(b for m, b in seg if m in (0xDB, 0xC4))
    return tables + b"\xff\xd9", b"\xff\xd8" + b"".join(
        b for m, b in seg if m not in (0xDB, 0xC4))


def _palette_of(img):
    """An RGB image of at most 256 colours -> (indices, palette)."""
    cols, inv = np.unique(img.reshape(-1, 3), axis=0, return_inverse=True)
    assert len(cols) <= 256
    return inv.reshape(img.shape[:2]).astype(np.uint8), cols


def tiff_gif_files(rgb, idx, pal16):
    """The TIFF and GIF files of slice 7d (name -> bytes), written by the
    encoders above (tiles, planar, predictor 3, fill order, old-style LZW
    and JPEG strips are hand-built: PIL writes none of them) and by PIL;
    and the twins of the scenes' PNGs (`tests/torch_scenes.py`
    `env_sphere_files`, `cbox_tex_files`), which hold the same pixels."""
    import io
    from PIL import Image
    g = np.random.RandomState(13)
    h, w = rgb.shape[:2]
    grey16 = (np.add.outer(np.arange(h), np.arange(w)) * 811 % 65536)
    fl = (rgb[..., :1].astype(np.float32) - 40) * np.float32(1.37)
    fl[0, :4, 0] = [np.nan, np.inf, -np.inf, 300.0]
    alpha = (np.arange(w)[None, :, None] * 255 // (w - 1)).repeat(h, 0)
    assoc = np.concatenate([rgb * alpha // 255, alpha], -1)
    cmap = np.zeros((256, 3), np.int64)
    cmap[:16] = pal16 * 257
    ycc_chunks, ycc_tables = [], None
    for y0 in range(0, h, 16):
        b = io.BytesIO()
        Image.fromarray(rgb[y0:y0 + 16]).save(b, "JPEG", quality=85,
                                              subsampling=2)
        ycc_tables, strip = _jpeg_split(b.getvalue())
        ycc_chunks.append(strip)
    files = {
        "lzw_pred2.tif": tiff_bytes(rgb, 8, 2, 5, predictor=2,
                                    rows_per_strip=10),
        "deflate_tiles.tif": tiff_bytes(rgb, 8, 2, 32946, predictor=2,
                                        tile=(16, 16)),
        "planar_packbits.tif": tiff_bytes(rgb, 8, 2, 32773, planar=True,
                                          rows_per_strip=7),
        "float_pred3_mm.tif": tiff_bytes(fl, 32, 1, 8, predictor=3,
                                         sampleformat=3, bo=">",
                                         rows_per_strip=16),
        "grey16_lzw_mm.tif": tiff_bytes(grey16[..., None], 16, 1, 5,
                                        predictor=2, bo=">"),
        "minwhite4_fill2.tif": tiff_bytes(rgb[..., 1:2] >> 4, 4, 0, 5,
                                          fill=2, rows_per_strip=9),
        "bilevel.tif": tiff_bytes(idx[..., None] & 1, 1, 1, 1),
        "pal4_lzw.tif": tiff_bytes(idx[..., None], 4, 3, 5, colormap=cmap[:16],
                                   tile=(16, 16)),
        "cmyk_deflate.tif": tiff_bytes(np.concatenate(
            [255 - rgb, rgb[..., :1] // 3], -1), 8, 5, 8),
        "rgba_assoc.tif": tiff_bytes(assoc, 8, 2, 8, extra=(1,)),
        "rgb16_packbits.tif": tiff_bytes(rgb.astype(np.int64) * 257 + g.randint(
            0, 256, rgb.shape), 16, 2, 32773),
        "lzw_old.tif": tiff_bytes(rgb, 8, 2, 5, lzw_old=True,
                                  rows_per_strip=20),
        "jpeg_ycbcr.tif": tiff_bytes(rgb, 8, 6, 7, rows_per_strip=16,
                                     jpeg_chunks=ycc_chunks,
                                     jpeg_tables=ycc_tables,
                                     ycbcr_sub=(2, 2)),
        "interlaced.gif": gif_bytes(idx, pal16, interlace=True),
        "local_trans.gif": gif_bytes(idx, pal16, local=True, transparency=3,
                                     screen=(w + 6, h + 4), offset=(2, 1)),
        "code2.gif": gif_bytes(idx & 3, pal16[:4], min_bits=2),
    }
    b = io.BytesIO()
    Image.fromarray(rgb).save(b, "TIFF", compression="jpeg", quality=90)
    files["jpeg_rgb.tif"] = b.getvalue()
    # the scenes' twins
    files["checker_lzw.tif"] = tiff_bytes(checker(), 8, 2, 5, predictor=2,
                                          rows_per_strip=16)
    for name, img in (("projector.gif", projector()[..., :3]),
                      ("bumps.gif", bumps())):
        i, p = _palette_of(img)
        files[name] = gif_bytes(i, p)
    return files


def timing_tiff(n=2048):
    """A 2048 x 2048 RGB LZW TIFF (predictor 2) of smooth procedural
    content, written by PIL (libtiff): the TIFF decoder's timing case."""
    import io
    from PIL import Image
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(x / 150.0 + k) * np.cos(y / 97.0 - k)
                    for k in range(3)], -1).astype(np.uint8)
    b = io.BytesIO()
    Image.fromarray(img).save(b, "TIFF", compression="tiff_lzw",
                              tiffinfo={317: 2})
    return b.getvalue()


def write_image_files(out):
    """The files of `image_files` and `image_decodes.npz`, what PIL decodes
    from each (`Image.open(p).convert("RGB")`), keyed by file name; and
    `lzw_2048.tif` (`timing_tiff`), whose decode's sha256 and 128 x 128
    corner the .npz keeps under "lzw_2048.tif:sha256" / ":corner"."""
    import hashlib
    from PIL import Image
    dec = {}
    for fn, data in image_files().items():
        p = os.path.join(out, fn)
        with open(p, "wb") as f:
            f.write(data)
        dec[fn] = np.asarray(Image.open(p).convert("RGB"))
    p = os.path.join(out, "lzw_2048.tif")
    with open(p, "wb") as f:
        f.write(timing_tiff())
    full = np.asarray(Image.open(p).convert("RGB"))
    dec["lzw_2048.tif:sha256"] = np.frombuffer(
        hashlib.sha256(full.tobytes()).digest(), np.uint8)
    dec["lzw_2048.tif:corner"] = full[:128, :128]
    np.savez_compressed(os.path.join(out, "image_decodes.npz"), **dec)


# ---------------------------------------------------------------------------
# Slice 7e.5: unfinished progressive JPEG (libjpeg's block smoothing),
# subsampled lossless JPEG, arithmetic-coded lossless JPEG (refused)
# ---------------------------------------------------------------------------

LOSSLESS_TIMING_SEED = 75   # `lossless_timing`'s grain


def cut_jpeg(data, scan, at=None):
    """`data` cut where its scan number `scan` (from 0) starts, an EOI in
    place of that SOS; or, with `at`, `at` bytes into that scan's
    entropy-coded data, an EOI appended."""
    import struct
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    if at is None:
        return data[:sos[scan]] + b"\xff\xd9"
    start = sos[scan] + 2 + struct.unpack(">H", data[sos[scan] + 2:
                                                    sos[scan] + 4])[0]
    end = next(i for i in range(start, len(data) - 1) if data[i] == 0xFF
               and data[i + 1] != 0 and not 0xD0 <= data[i + 1] <= 0xD7)
    assert 0 < at < end - start, "the cut must fall inside the scan's data"
    return data[:start + at] + b"\xff\xd9"


def _waves(h, w, seed):
    """Smooth colour waves with a little noise, uint8 [h, w, 3]."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    g = np.random.RandomState(seed)
    base = np.stack([128 + 100 * np.sin(x * 0.19 + c) * np.cos(y * 0.13 - c)
                     for c in range(3)], -1)
    return np.clip(np.round(base + g.randint(-12, 13, base.shape)), 0,
                   255).astype(np.uint8)


def _cv_jpeg(img, factor, restart=0):
    """The pip cv2's progressive JPEG of img (RGB) at quality 85, its
    chroma sampled as `factor` (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_*), a
    restart interval of `restart` MCU rows."""
    import cv2
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 85,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    return cv2.imencode(".jpg", img[..., ::-1], params)[1].tobytes()


def smooth_2048():
    """The 2048 x 2048 progressive JPEG of smooth waves (PIL, 4:2:0,
    quality 90) that `chip_smoke.py` cuts after its DC scan and after its
    first AC scan."""
    from PIL import Image
    n = 2048
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / n
    waves = np.stack([np.sin(7.0 * x + 3.0 * y), np.cos(5.0 * y - 2.0 * x),
                      np.sin(11.0 * x * y + 1.0)], -1)
    img = np.clip(np.round(128 + 90 * waves), 0, 255).astype(np.uint8)
    return _pil_jpeg(img, progressive=True, quality=90)


def smooth_cuts(data):
    """name -> `smooth_2048.jpg` cut after its DC scan and after its first
    AC scan (an EOI in place of the next SOS)."""
    return {"smooth_2048_dc.jpg": cut_jpeg(data, 1),
            "smooth_2048_ac.jpg": cut_jpeg(data, 2)}


def lossless_timing(n=2048, seed=LOSSLESS_TIMING_SEED):
    """A 2048 x 2048 lossless JPEG, 4:2:0 (the first component 2x2),
    predictor 6, of smooth waves under a grain, built from a seed (7 MB:
    not committed)."""
    img = grain(n)
    img = np.clip(img.astype(np.int64) + np.random.RandomState(seed).randint(
        -3, 4, img.shape), 0, 255).astype(np.uint8)
    return lossless_jpeg_bytes(img, 6, sampling=((2, 2), (1, 1), (1, 1)))


def jpeg_7e5_files(checker_rgb, projector_rgb):
    """name -> bytes: slice 7e.5's files. Progressive files cut after a scan
    or inside one (PIL's, the pip cv2's for 4:4:0 and 4:1:1 and restart
    intervals, and arithmetic-coded ones), from 1 to 8+ block rows and
    columns; subsampled lossless files (interleaved and one scan a
    component, restarts, predictors, point transforms, 1, 3 and 4
    components); `ll_arith.jpg`, a lossless file relabelled SOF11 (which
    PIL refuses); the twins `checker_smooth.jpg` (the checker as a
    progressive JPEG cut inside its first AC scan) and
    `projector_lossless.jpg` (the projector's RGB, lossless 4:2:0)."""
    f = {}
    f["cut_grey_dc.jpg"] = cut_jpeg(_pil_jpeg(_waves(9, 13, 1)[..., 0],
                                              progressive=True, quality=80), 1)
    f["cut_grey_tall.jpg"] = cut_jpeg(_pil_jpeg(
        _waves(70, 8, 2)[..., 0], progressive=True, quality=95), 2, 9)
    f["cut_444_ac.jpg"] = cut_jpeg(_pil_jpeg(
        _waves(33, 47, 3), progressive=True, quality=75, subsampling=0), 2)
    f["cut_420_mid.jpg"] = cut_jpeg(_pil_jpeg(
        _waves(20, 28, 4), progressive=True, quality=90), 1, 20)
    f["cut_420_refine.jpg"] = cut_jpeg(_pil_jpeg(
        _waves(40, 70, 5), progressive=True, quality=60), 5, 30)
    f["cut_422_wide.jpg"] = cut_jpeg(_pil_jpeg(
        _waves(17, 150, 6), progressive=True, quality=50, subsampling=1), 3)
    import cv2
    f["cut_440_dc.jpg"] = cut_jpeg(_cv_jpeg(
        _waves(45, 31, 7), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440), 1)
    f["cut_411_mid.jpg"] = cut_jpeg(_cv_jpeg(
        _waves(26, 61, 8), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411), 2, 25)
    f["cut_rst_mid.jpg"] = cut_jpeg(_cv_jpeg(
        _waves(50, 44, 9), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, 2), 1, 60)
    sampling = ((2, 2), (1, 1), (1, 1))
    arith = arith_jpeg_bytes(_coefficients(sampling, (3, 4), 6, 10),
                             sampling, q=6, progressive=True, restart=2)
    f["cut_arith_dc.jpg"] = cut_jpeg(arith, 1)
    f["cut_arith_mid.jpg"] = cut_jpeg(arith, 4, 40)
    # subsampled lossless
    w = _waves(23, 37, 11)
    f["ll_420.jpg"] = lossless_jpeg_bytes(w, 1, sampling=sampling)
    f["ll_422_rst.jpg"] = lossless_jpeg_bytes(
        w, 5, restart_rows=2, sampling=((2, 1), (1, 1), (1, 1)))
    f["ll_planes.jpg"] = lossless_jpeg_bytes(w, 7, 1, sampling=sampling,
                                             per_component=True)
    f["ll_grey22.jpg"] = lossless_jpeg_bytes(w[..., :1], 4, restart_rows=3,
                                             sampling=((2, 2),))
    cmyk = np.concatenate([w, w[..., :1] // 2 + 60], -1)
    f["ll_cmyk.jpg"] = lossless_jpeg_bytes(
        cmyk, 2, sampling=((2, 2), (1, 1), (1, 1), (2, 2)),
        per_component=True)
    f["ll_441.jpg"] = lossless_jpeg_bytes(
        _waves(19, 30, 12), 3, 2, sampling=((4, 1), (1, 1), (2, 1)))
    d = bytearray(f["ll_420.jpg"])
    d[d.index(b"\xff\xc3") + 1] = 0xCB
    f["ll_arith.jpg"] = bytes(d)
    # the twins
    f["checker_smooth.jpg"] = cut_jpeg(_pil_jpeg(
        checker_rgb, progressive=True, quality=90), 2, 15)
    f["projector_lossless.jpg"] = lossless_jpeg_bytes(
        np.ascontiguousarray(projector_rgb), 1, sampling=sampling)
    return f


def write_jpeg_7e5_files(out, checker_rgb, projector_rgb):
    """Slice 7e.5's files (`jpeg_7e5_files`), `smooth_2048.jpg`, the
    twins' PIL decodes `checker_smooth_pil.png` and
    `projector_lossless_pil.png`, and `jpeg_7e5_decodes.npz`: what PIL
    decodes from each file it decodes (`Image.open(p).convert("RGB")`, by
    path), and the sha256 and 128 x 128 corner of its decodes of
    `smooth_2048.jpg`, of its two cuts (`smooth_cuts`) and of
    `lossless_timing`'s file, under "<name>:sha256" / ":corner"."""
    import hashlib
    import io
    from PIL import Image
    dec = {}
    for fn, data in jpeg_7e5_files(checker_rgb, projector_rgb).items():
        p = os.path.join(out, fn)
        with open(p, "wb") as fh:
            fh.write(data)
        try:
            dec[fn] = np.asarray(Image.open(p).convert("RGB"))
        except OSError:
            continue          # ll_arith.jpg: PIL refuses it
    for fn in ("checker_smooth", "projector_lossless"):
        Image.fromarray(dec[fn + ".jpg"]).save(os.path.join(
            out, fn + "_pil.png"))
    big = smooth_2048()
    with open(os.path.join(out, "smooth_2048.jpg"), "wb") as fh:
        fh.write(big)
    built = dict(smooth_cuts(big), **{"smooth_2048.jpg": big,
                                      "lossless_2048.jpg": lossless_timing()})
    for fn, data in built.items():
        full = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        dec[fn + ":sha256"] = np.frombuffer(
            hashlib.sha256(full.tobytes()).digest(), np.uint8)
        dec[fn + ":corner"] = full[:CORNER, :CORNER]
    np.savez_compressed(os.path.join(out, "jpeg_7e5_decodes.npz"), **dec)


def _webp_module():
    """`tools/gen_torch_webp.py`, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_webp", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_webp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cvtiff_module():
    """`tools/gen_torch_cvtiff.py`, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_cvtiff", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_cvtiff.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiff_module():
    """`tools/gen_torch_tiff.py` (slice 7e.4's files), by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_tiff", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_tiff.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ojpeg_module():
    """`tools/gen_torch_ojpeg.py`, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_ojpeg", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_ojpeg.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sgilog_module():
    """`tools/gen_torch_sgilog.py`, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_sgilog", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_sgilog.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _j2k_module(name="gen_torch_j2k"):
    """`tools/gen_torch_j2k.py` (or `name`.py), loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "vt_" + name, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pil_module():
    """`tools/gen_torch_pil.py`, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_pil", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_pil.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def opencv_reader_files():
    """The files of slice 7e.3a (name -> bytes), each under a .hdr / .exr
    name, so the JAX package reads it through OpenCV's own reader: a
    16-bit binary PPM, an ASCII PGM with a comment, an RGB PAM, a grey PFM
    of scale -2.5, an 8-bit Sun raster with a colour map, an RLE4 BMP and
    a YCCK JPEG (PIL's CMYK file with the Adobe transform set to 2)."""
    g = np.random.default_rng(7300)
    f = {}
    v = g.integers(0, 1001, (9, 13, 3))
    f["cv_p6_16.hdr"] = b"P6\n13 9\n1000\n" + v.astype(">u2").tobytes()
    v = g.integers(0, 101, (7, 11))
    f["cv_p2.hdr"] = b"P2\n# a comment\n11 7\n100\n" + b"\n".join(
        b" ".join(b"%d" % x for x in row) for row in v) + b"\n"
    v = g.integers(0, 256, (6, 10, 3), dtype=np.uint8)
    f["cv_pam_rgb.exr"] = (b"P7\nWIDTH 10\nHEIGHT 6\nDEPTH 3\nMAXVAL 255\n"
                           b"TUPLTYPE RGB\nENDHDR\n" + v.tobytes())
    v = (g.standard_normal((8, 12)) * 10).astype("<f4")
    f["cv_pfm_grey.hdr"] = b"Pf\n12 8\n-2.5\n" + v[::-1].tobytes()
    cmap = g.integers(0, 256, 3 * 256, dtype=np.uint8).tobytes()
    body = g.integers(0, 256, (5, 10), dtype=np.uint8).tobytes()
    f["cv_sun_map.hdr"] = struct.pack(">8I", 0x59A66A95, 9, 5, 8, len(body),
                                      1, 1, len(cmap)) + cmap + body
    idx = (np.add.outer(np.arange(7), np.arange(15)) // 3 % 16).astype(
        np.uint8)
    pal = np.concatenate([g.integers(0, 256, (16, 3), dtype=np.uint8),
                          np.zeros((16, 1), np.uint8)], 1)
    f["cv_bmp_rle4.hdr"] = bmp_bytes(15, 7, 4, None, pal, 2,
                                     data=bmp_rle(idx, rle4=True))
    img4 = g.integers(0, 256, (12, 20, 4), dtype=np.uint8)
    img4[2:9, 3:15] = g.integers(0, 256, 4, dtype=np.uint8)
    import io
    from PIL import Image
    b = io.BytesIO()
    Image.fromarray(img4, "CMYK").save(b, "JPEG", quality=85, subsampling=2)
    f["cv_ycck.exr"] = _adobe_transform(b.getvalue(), 2)
    return f


def write_opencv_reader_files(out):
    """The files of slice 7e.3a and `cv_decodes.npz`: what the JAX
    package's loader gives for each through the pip cv2 (float32 [H, W,
    3] RGB, no /255)."""
    import cv2
    dec = {}
    for fn, data in opencv_reader_files().items():
        p = os.path.join(out, fn)
        with open(p, "wb") as f:
            f.write(data)
        a = cv2.imread(p, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        a = a.astype(np.float32)
        if a.ndim == 2:
            a = np.stack([a] * 3, -1)
        dec[fn] = np.ascontiguousarray(a[..., :3][..., ::-1])
    np.savez_compressed(os.path.join(out, "cv_decodes.npz"), **dec)


def main():
    from PIL import Image
    import cv2
    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    os.makedirs(out, exist_ok=True)
    Image.fromarray(checker(), "RGB").save(os.path.join(out, "checker.png"))
    Image.fromarray(bumps(), "RGB").save(os.path.join(out, "bumps.png"))
    Image.fromarray(projector(), "RGBA").save(
        os.path.join(out, "projector.png"))
    for k in ("a", "b"):
        cv2.imwrite(os.path.join(out, f"sky_{k}.hdr"), sky(k)[..., ::-1])
    with open(os.path.join(out, "spot.ies"), "w") as f:
        f.write(IES)
    write_jpegs(out)
    write_image_files(out)
    _webp_module().write_webp_files(out, checker(), bumps(), projector(),
                                    grain())
    write_opencv_reader_files(out)
    _pil_module().write_pil_files(out, checker(), bumps(), projector())
    _pil_module().write_pil_rare_files(out, checker(), bumps(), projector())
    _cvtiff_module().write_cv_files(out)
    _tiff_module().write_tiff_files(out)
    write_jpeg_7e5_files(out, checker(), projector()[..., :3])
    _ojpeg_module().write_ojpeg_files(out, checker(), projector()[..., :3])
    _sgilog_module().write_sgilog_files(out)
    _j2k_module().write_j2k_files(out, checker(), projector()[..., :3])
    _j2k_module("gen_torch_j2k_cv").write_j2k_cv_files(
        out, sky("a"), projector()[..., :3])
    _j2k_module("gen_torch_avif").write_avif_files(out, checker(),
                                                   projector())
    for fn in sorted(os.listdir(out)):
        print(fn, os.path.getsize(os.path.join(out, fn)))


if __name__ == "__main__":
    main()
