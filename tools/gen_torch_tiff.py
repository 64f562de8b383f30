"""The files of slice 7e.4 (the rarer TIFF codecs and layouts) in
`tests/assets_torch/`, with `tiff_decodes.npz`: what the JAX package's
loader gets for each, through PIL (`Image.open(p).convert("RGB")`, uint8
[H, W, 3]) under a `.tif` name and through the pip cv2
(`cv2.imread(p, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`, float32 [H, W, 3]
RGB, no /255) under a `.exr` / `.hdr` name.

    python tools/gen_torch_tiff.py [out_dir]

(`tools/gen_torch_assets.py` calls it after writing the scenes' images,
which it reads.) PIL 12.1 writes the CCITT (RLE, RLEW, Group 3 with its
T4Options and fill order 2, Group 4), LZMA, ZSTD and CMYK JPEG files; the
encoders here write the rest, and are the tests' too (`tests/torch_scenes.py`
`gen_tiff`):

  * `ycbcr_chunks`: YCbCr data units of any YCbCrSubsampling, a strip at
    a time;
  * `thunder_codes`: ThunderScan 4-bit code streams (runs, 2- and 3-bit
    deltas, raw pixels) of exactly a row's pixels each, from a seed;
  * `tools/gen_torch_assets.py` `tiff_bytes` and `bigtiff` lay the files
    out (classic TIFF, or BigTIFF with LONG8 offsets).

The files: `tf_*.tif` (PIL's route: C28's CIELab, 12-bit grey and odd
headers, BigTIFF, CCITT, LZMA, ZSTD, ThunderScan, YCbCr, CMYK and planar
JPEG, planar 16-bit), `tf_cv_*.exr` / `.hdr` (OpenCV's route: BigTIFF,
CCITT, CIELab, YCbCr, 10- to 14-bit samples, ThunderScan); the twins
`sky_a_big.exr` (sky_a's floats as a BigTIFF, Deflate with the
floating-point predictor: `tests/torch_scenes.py` `cbox_sky_bigtiff`) and
`projector_zstd.tif` (the projector image's RGB as a ZSTD TIFF with the
horizontal predictor: `env_sphere_zstd`); the timing file `g4_2048.tif`
(a 2048 x 2048 Group 4 page of marks from a seed, written by PIL), whose
decode's sha256 and 128 x 128 corner the .npz keeps.

Needs PIL, the pip cv2, the `zstandard` module and numpy. The output is
deterministic: running it again writes the same bytes.
"""
import hashlib
import importlib.util
import io
import os
import sys
import zlib

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "assets_torch")
TIMING_SEED = 4
CORNER = 128


def _assets_module():
    """`tools/gen_torch_assets.py` (its TIFF writers), by path."""
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_assets_tiff", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_assets.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

def ycbcr_chunks(ycc, hs, vs, rows_per_strip, code=lambda b: b):
    """Strips of YCbCr samples int [h, w, 3] as data units: hs x vs luma
    samples in row order, then the unit's top-left Cb and Cr; partial
    units at the right and bottom edges padded with zeros; each strip's
    bytes passed through `code` (a compressor)."""
    h, w, _ = ycc.shape
    out = []
    for y0 in range(0, h, rows_per_strip):
        rows = ycc[y0:y0 + rows_per_strip]
        uv, uh = -(-rows.shape[0] // vs), -(-w // hs)
        pad = np.zeros((uv * vs, uh * hs, 3), np.int64)
        pad[:rows.shape[0], :w] = rows
        u = pad.reshape(uv, vs, uh, hs, 3).transpose(0, 2, 1, 3, 4)
        units = np.concatenate([u[..., 0].reshape(uv, uh, vs * hs),
                                u[:, :, :1, 0, 1], u[:, :, :1, 0, 2]], -1)
        out.append(code(units.astype(np.uint8).tobytes()))
    return out


def thunder_codes(g, width, rows):
    """ThunderScan codes of `rows` rows of exactly `width` pixels each,
    drawn from the generator g: runs of 1-63, three 2-bit or two 3-bit
    deltas (a skip code among them), raw pixels."""
    out = bytearray()
    for _ in range(rows):
        n = 0
        while n < width:
            left = width - n
            k = int(g.integers(0, 4))
            if k == 0:
                c = int(g.integers(1, min(63, left) + 1))
                out.append(c)
                n += c
            elif k == 1:
                ds = [int(g.integers(0, 4)) for _ in range(3)]
                c = sum(d != 2 for d in ds)
                if 0 < c <= left:
                    out.append(0x40 | ds[0] << 4 | ds[1] << 2 | ds[2])
                    n += c
            elif k == 2:
                ds = [int(g.integers(0, 8)) for _ in range(2)]
                c = sum(d != 4 for d in ds)
                if 0 < c <= left:
                    out.append(0x80 | ds[0] << 3 | ds[1])
                    n += c
            else:
                out.append(0xC0 | int(g.integers(0, 16)))
                n += 1
    return bytes(out)


def pil_tiff(img, mode=None, **opts):
    """PIL's TIFF of an array (as `mode`), with its writer's options
    (compression, tiffinfo)."""
    from PIL import Image
    im = Image.fromarray(img)
    if mode is not None:
        im = im.convert(mode)
    b = io.BytesIO()
    im.save(b, "TIFF", **opts)
    return b.getvalue()


def page(n, seed=TIMING_SEED):
    """A bilevel n x n page from a seed: lines of words whose letters are
    glyphs of a 26-letter font of 8 x 12 random strokes, a few ruled
    boxes; bool [n, n], True for white."""
    g = np.random.default_rng(seed)
    font = np.ones((26, 12, 8), bool)
    for glyph in font:
        for _ in range(3):              # two or three strokes a letter
            if g.random() < 0.5:
                x = int(g.integers(0, 7))
                glyph[int(g.integers(0, 4)):int(g.integers(8, 12)),
                      x:x + 2] = False
            else:
                y = int(g.integers(0, 11))
                glyph[y:y + 2, int(g.integers(0, 3)):int(g.integers(5, 8))] \
                    = False
    img = np.ones((n, n), bool)
    for y in range(96, n - 96, 24):
        x = 128
        while True:
            word = g.integers(0, 26, int(g.integers(2, 10)))
            if x + 9 * len(word) > n - 128:
                break
            for k, c in enumerate(word):
                img[y:y + 12, x + 9 * k:x + 9 * k + 8] = font[c]
            x += 9 * len(word) + int(g.integers(6, 14))
    for _ in range(12):
        y, x = g.integers(0, n - 400, 2)
        h, w = g.integers(40, 400, 2)
        img[y:y + h, x:x + 2] = img[y:y + h, x + w:x + w + 2] = False
        img[y:y + 2, x:x + w] = img[y + h:y + h + 2, x:x + w] = False
    return img


def timing_g4(n=2048):
    """`g4_2048.tif`: `page(n)` as a Group 4 TIFF, one strip (PIL)."""
    return pil_tiff(page(n), compression="group4")


def _jpeg(a):
    from PIL import Image
    b = io.BytesIO()
    Image.fromarray(np.asarray(a, np.uint8)).save(b, "JPEG", quality=90)
    return b.getvalue()


# ---------------------------------------------------------------------------
# the files
# ---------------------------------------------------------------------------

def tiff_files(ga):
    """name -> bytes of slice 7e.4's files and twins."""
    g = np.random.default_rng(74)
    h, w = 21, 30
    rgb = g.integers(0, 256, (h, w, 3))
    rgb[:, :9] = rgb[:, :1]
    bw = np.asarray(g.random((37, 53)) > 0.5)
    bw[:, :12] = bw[:, :1]
    bw[6:10] = True
    t = ga.tiff_bytes
    f = {}
    # C28: CIELab, 12-bit grey, PIL's two odd headers
    lab = g.integers(0, 256, (h, w, 3))
    f["tf_lab_lzw.tif"] = t(lab, 8, 8, 5, rows_per_strip=8)
    f["tf_lab_planar_mm.tif"] = t(lab, 8, 8, 1, planar=True, bo=">")
    grey12 = g.integers(0, 4096, (h, w, 1))
    grey12[0, :4, 0] = (0, 255, 256, 4095)
    f["tf_grey12.tif"] = t(grey12, 12, 1, rows_per_strip=5)
    f["tf_mm_star.tif"] = b"MM*\0" + t(rgb, 8, 2, bo=">")[4:]
    f["tf_ii_star.tif"] = b"II\0*" + t(rgb, 8, 2)[4:]
    # BigTIFF
    f["tf_big_lzw.tif"] = ga.bigtiff(t(rgb, 8, 2, 5, rows_per_strip=8))
    f["tf_big_tiles.tif"] = ga.bigtiff(t(rgb, 8, 2, 8, tile=(16, 16)),
                                       long8=False)
    # CCITT
    f["tf_g3_1d.tif"] = pil_tiff(bw, compression="group3")
    f["tf_g3_2d_fill2.tif"] = pil_tiff(bw, compression="group3",
                                       tiffinfo={292: 5, 266: 2, 278: 16})
    f["tf_g4.tif"] = pil_tiff(bw, compression="group4")
    f["tf_rle.tif"] = pil_tiff(bw, compression="tiff_ccitt")
    f["tf_rlew.tif"] = pil_tiff(bw, compression="tiff_raw_16")
    # LZMA, ZSTD
    f["tf_lzma_rgb.tif"] = pil_tiff(rgb.astype(np.uint8), compression="lzma")
    f["tf_zstd_grey.tif"] = pil_tiff(rgb.astype(np.uint8), "L",
                                     compression="zstd")
    f["tf_zstd_pred2.tif"] = t(rgb, 8, 2, 50000, predictor=2,
                               rows_per_strip=8)
    # ThunderScan, grey and palette
    cmap = g.integers(0, 65536, (16, 3))
    f["tf_thunder_grey.tif"] = t(np.zeros((h, w, 1), np.int64), 4, 1, 32809,
                                 chunks=[thunder_codes(g, w, h)])
    f["tf_thunder_pal.tif"] = t(np.zeros((h, w, 1), np.int64), 4, 3, 32809,
                                chunks=[thunder_codes(g, w, h)],
                                colormap=cmap)
    # YCbCr without JPEG, CMYK and planar JPEG, planar 16-bit
    ycc = g.integers(0, 256, (h, w, 3))
    f["tf_ycbcr22_lzw.tif"] = t(ycc, 8, 6, 5, rows_per_strip=4, ycbcr_sub=(
        2, 2), chunks=ycbcr_chunks(ycc, 2, 2, 4, ga.lzw_encode))
    f["tf_ycbcr_raw.tif"] = t(ycc, 8, 6, rows_per_strip=4, ycbcr_sub=(1, 1))
    f["tf_cmyk_jpeg.tif"] = pil_tiff(rgb.astype(np.uint8), "CMYK",
                                     compression="jpeg")
    f["tf_planar_jpeg.tif"] = t(rgb, 8, 2, 7, planar=True,
                                chunks=[_jpeg(rgb[..., k]) for k in range(3)])
    f["tf_planar16.tif"] = t(rgb * 257, 16, 2, planar=True)
    # OpenCV's route
    f["tf_cv_big_mm.exr"] = ga.bigtiff(t(rgb * 250, 16, 2, 5, bo=">",
                                         rows_per_strip=8))
    f["tf_cv_g3_2d.exr"] = pil_tiff(bw, compression="group3",
                                    tiffinfo={292: 1})
    f["tf_cv_g4_white.hdr"] = pil_tiff(bw, compression="group4",
                                       tiffinfo={262: 0})
    f["tf_cv_rlew.exr"] = pil_tiff(bw, compression="tiff_raw_16")
    f["tf_cv_lab.hdr"] = t(lab, 8, 8, 8, rows_per_strip=8)
    f["tf_cv_lab16_wp.exr"] = t(g.integers(0, 65536, (h, w, 3)), 16, 8,
                                tags={318: (5, [3127, 10000, 3290, 10000])})
    f["tf_cv_ycbcr42.hdr"] = t(ycc, 8, 6, 8, rows_per_strip=4, ycbcr_sub=(
        4, 2), chunks=ycbcr_chunks(ycc, 4, 2, 4, zlib.compress))
    f["tf_cv_ycbcr_rbw.exr"] = t(
        ycc, 8, 6, rows_per_strip=6, ycbcr_sub=(2, 1),
        chunks=ycbcr_chunks(ycc, 2, 1, 6),
        tags={529: (5, [2126, 10000, 7152, 10000, 722, 10000]),
              532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])})
    f["tf_cv_grey12.exr"] = t(grey12, 12, 1, 5, rows_per_strip=5)
    f["tf_cv_rgb10.hdr"] = t(g.integers(0, 1024, (h, w, 3)), 10, 2,
                             tile=(16, 16))
    f["tf_cv_i14.exr"] = t(g.integers(0, 16384, (h, w, 1)), 14, 1,
                           sampleformat=2)
    f["tf_cv_thunder_pal.hdr"] = t(np.zeros((h, w, 1), np.int64), 4, 3,
                                   32809, chunks=[thunder_codes(g, w, h)],
                                   colormap=cmap)
    # the twins
    f["sky_a_big.exr"] = ga.bigtiff(t(ga.sky("a").astype(np.float32), 32, 2,
                                      8, predictor=3, sampleformat=3,
                                      rows_per_strip=8))
    f["projector_zstd.tif"] = t(ga.projector()[..., :3], 8, 2, 50000,
                                predictor=2, rows_per_strip=16)
    return f


def _decode(p):
    """What the JAX package's loader gets: through PIL for a .tif name,
    the pip cv2 for .exr / .hdr (float32 RGB, no /255)."""
    if p.endswith(".tif"):
        from PIL import Image
        return np.asarray(Image.open(p).convert("RGB"))
    import cv2
    a = cv2.imread(p, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    assert a is not None, p
    a = a.astype(np.float32)
    if a.ndim == 2:
        a = np.stack([a] * 3, -1)
    return np.ascontiguousarray(a[..., :3][..., ::-1])


def write_tiff_files(out):
    """Every file of the module docstring and `tiff_decodes.npz`."""
    ga = _assets_module()
    dec = {}
    for fn, data in tiff_files(ga).items():
        p = os.path.join(out, fn)
        with open(p, "wb") as fh:
            fh.write(data)
        dec[fn] = _decode(p)
    assert np.array_equal(dec["sky_a_big.exr"], ga.sky("a").astype(
        np.float32)), "the BigTIFF holds sky_a's floats"
    assert np.array_equal(dec["projector_zstd.tif"], ga.projector()[..., :3])
    p = os.path.join(out, "g4_2048.tif")
    with open(p, "wb") as fh:
        fh.write(timing_g4())
    full = _decode(p)
    dec["g4_2048.tif:sha256"] = np.frombuffer(
        hashlib.sha256(full.tobytes()).digest(), np.uint8)
    dec["g4_2048.tif:corner"] = full[:CORNER, :CORNER]
    np.savez_compressed(os.path.join(out, "tiff_decodes.npz"), **dec)


if __name__ == "__main__":
    write_tiff_files(sys.argv[1] if len(sys.argv) > 1 else OUT)
