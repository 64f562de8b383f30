"""AVIF files for `tests/assets_torch/` (slice 7e.8a.1): lossless AV1 key
frames in the HEIF container, written by PIL 12.1.0's encoder (libavif
1.3.0 over aom 3.12.1) at quality 100, and PIL's decode of each.

    python tools/gen_torch_avif.py [out_dir]

(`tools/gen_torch_assets.py` calls `write_avif_files`.)

  * `check_tables`: every default-CDF table of
    `vision_tpu_torch/csrc/av1_codec.cpp` (the coefficient CDFs of all
    four quantiser contexts and five sizes, tx depth, the intra and inter
    tx types, intra block copy's flag and MV CDFs and txfm_split among
    them) is found in the libavif shared library PIL ships (which
    carries dav1d and aom): whole, in libaom's inverted layout (32768 -
    each value, then 0 and the count 0, rows padded to the table's
    widest), or else in dav1d's (32768 - each value, then the count);
    the filter-intra taps, the directional derivatives, the smooth
    weights, the edge kernels, the quantiser lookups, the cosine and
    sine constants, Mode_To_Txfm, Max_Tx_Size_Rect, the intra and inter
    tx-type maps, the default scans and the coefficient context offsets
    (libaom keeps the last two transposed) in libaom's layout (the palette
    colour contexts, which neither library keeps as such a table, are held
    by the palette files' decodes). The generator stops where one is
    missing.
  * The files (`avif_files`): `avif_*` that PIL decodes, at 4:4:4, 4:2:2,
    4:2:0 and 4:0:0, odd sizes, speeds 0-10, tiles, each intra tool
    switched off through `advanced=`, palettes (screen content), 128x128
    superblocks, CDF updates off, alpha, limited range, Exif with an
    orientation (libavif writes `irot`), an ICC profile, and copies whose
    `nclx` names other matrices, ranges and primaries (libyuv's and
    libavif's own YUV to RGB); `avif_bad_*` that PIL refuses;
    `avif_later_*` that PIL decodes and the port sent to a later
    sub-item when it was written (a lossy frame, screen content with
    intra block copy, which slices 7e.8a.2a and 7e.8a.2c.1 now decode; a
    10-bit file of the pip cv2, premultiplied alpha, an `ispe` other than
    the frame's size); the twins' `checker_avif.avif` and
    `projector_avif.avif` with PIL's decodes as PNGs; the timing file
    `avif_2048.avif` (2048^2, autotiled, under 1 MB).
  * `avif_decodes.npz`: PIL's `convert("RGB")` of each file (decoded in a
    child process), the names it refuses under ":refused", the timing
    file's sha256 and 128 x 128 corner, and under "edits:sha256" the
    digest of PIL's outcome on each of `edit_cases` (seeded edits of the
    files: a third in the container, a third in the AV1 headers, a third
    in the tile data).

`write_avif_files` then calls `tools/gen_torch_avif_lossy.py` for slice
7e.8a.2a's lossy files. Needs PIL, numpy and the pip cv2. The output is
deterministic: running it again writes the same bytes.
"""
import glob
import hashlib
import importlib.util
import io
import os
import re
import struct
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "assets_torch")
SOURCE = os.path.join(ROOT, "vision_tpu_torch", "csrc", "av1_codec.cpp")
SEED = 29


# ---------------------------------------------------------------------------
# the tables against the library
# ---------------------------------------------------------------------------

def library_path():
    import PIL
    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                  "pillow.libs", "libavif-*.so*"))
    if not libs:
        raise RuntimeError("no libavif shared library next to PIL")
    return libs[0]


def source_tables():
    """{name: (element type, rows)} of the tables in av1_codec.cpp."""
    src = open(SOURCE).read()
    out = {}
    for m in re.finditer(r"static const (u?int\d+_t) (\w+)((?:\[\d+\])+) = "
                         r"\{(.*?)\};", src, re.S):
        typ, name, body = m.group(1), m.group(2), m.group(4)
        rows = [[int(v) for v in re.findall(r"-?\d+", r)]
                for r in re.findall(r"\{([^{}]*)\}", body)]
        if not rows:
            rows = [[int(v) for v in re.findall(r"-?\d+", body)]]
        out[name] = (typ, rows)
    return out


# CDF tables: (symbols per row, or None when the row's length + 1 says it)
_CDF_TABLES = {
    "KF_Y_MODE": 13, "UV_MODE_NOCFL": 13, "UV_MODE_CFL": 14,
    "ANGLE_DELTA": 7, "PARTITION_W8": 4, "PARTITION_W16_64": 10,
    "PARTITION_W128": 8, "SKIP": 2, "SEGMENT_ID": 8, "CFL_SIGN": 8,
    "CFL_ALPHA": 16, "FILTER_INTRA": 2, "FILTER_INTRA_MODE": 5,
    "PALETTE_Y_MODE": 2, "PALETTE_UV_MODE": 2, "PALETTE_Y_SIZE": 7,
    "PALETTE_UV_SIZE": 7, "PALETTE_Y_COLOR": None, "PALETTE_UV_COLOR": None,
    "TXB_SKIP": 2, "EOB_PT_16": 5, "EOB_PT_32": 6, "EOB_PT_64": 7,
    "EOB_PT_128": 8, "EOB_PT_256": 9, "EOB_PT_512": 10, "EOB_PT_1024": 11,
    "EOB_EXTRA": 2, "DC_SIGN": 2, "COEFF_BASE_EOB": 3, "COEFF_BASE": 4,
    "COEFF_BR": 4, "TX_DEPTH_8X8": 2, "TX_DEPTH": 3, "INTRA_TX_SET1": 7,
    "INTRA_TX_SET2": 5, "INTRABC": 2, "MV_JOINT": 4, "MV_CLASS": 11,
    "MV_CLASS0_BIT": 2, "MV_SIGN": 2, "MV_BITS": 2, "TXFM_SPLIT": 2,
    "INTER_TX_SET1": 16, "INTER_TX_SET2": 12, "INTER_TX_SET3": 2}
# libaom's row width where its table pads rows to a wider alphabet
_AOM_STRIDE = {"UV_MODE_NOCFL": 15, "PARTITION_W8": 11,
               "PARTITION_W16_64": 11, "PARTITION_W128": 11,
               "PALETTE_Y_COLOR": 9, "PALETTE_UV_COLOR": 9,
               "TX_DEPTH_8X8": 4, "TX_DEPTH": 4, "INTRA_TX_SET1": 17,
               "INTRA_TX_SET2": 17, "INTER_TX_SET1": 17, "INTER_TX_SET2": 17,
               "INTER_TX_SET3": 17}
# the default scans' (width, height); libaom keeps each transposed
_SCANS = {f"DEFAULT_SCAN_{w}X{h}": (w, h) for w, h in (
    (4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16), (16, 8),
    (16, 32), (32, 16), (4, 16), (16, 4), (8, 32), (32, 8))}


def _find(hay, needle):
    return hay.find(needle.tobytes()) >= 0


def _cdf_rows(name, rows):
    """(symbols, values) of each row: the palette colour tables hold
    seven rows of five contexts, of 2 .. 8 colours."""
    n = _CDF_TABLES[name]
    if n is None:
        return [(2 + i // 5, r[:1 + i // 5]) for i, r in enumerate(rows)]
    return [(n, r) for r in rows]


def check_tables(lib=None):
    """Find every table of av1_codec.cpp in the libavif library; returns
    {name: layout}, raises RuntimeError for one that is missing."""
    lib = lib or library_path()
    data = open(lib, "rb").read()
    tables = source_tables()
    found = {}
    for name in _CDF_TABLES:
        rows = _cdf_rows(name, tables[name][1])
        stride = _AOM_STRIDE.get(name)
        aom = []
        for n, r in rows:
            e = [32768 - v for v in r] + [0, 0]
            aom += e + [0] * ((stride or n + 1) - len(e))
        dav = []
        for n, r in rows:
            dav += [32768 - v for v in r] + [0]
        if _find(data, np.array(aom, "<u2")):
            found[name] = "libaom"
        elif _find(data, np.array(dav, "<u2")):
            found[name] = "dav1d"
        else:
            raise RuntimeError(f"{name} of av1_codec.cpp is not in {lib}")
    taps = np.array([r + [0] for r in tables["INTRA_FILTER_TAPS"][1]], "i1")
    flat = {k: [v for r in t[1] for v in r] for k, t in tables.items()}
    checks = {
        "INTRA_FILTER_TAPS": taps,
        "DR_INTRA_DERIVATIVE": np.array(flat["DR_INTRA_DERIVATIVE"], "<u2"),
        "SM_WEIGHTS": np.array(flat["SM_WEIGHTS"], "u1"),
        "INTRA_EDGE_KERNEL": np.array(tables["INTRA_EDGE_KERNEL"][1], "<i4"),
        "DC_QLOOKUP": np.array(flat["DC_QLOOKUP"], "<i2"),
        "AC_QLOOKUP": np.array(flat["AC_QLOOKUP"], "<i2"),
        "COSPI": np.array(flat["COSPI"], "<i4"),
        "SINPI": np.array(flat["SINPI"], "<i4"),
        "MODE_TO_TXFM": np.array(flat["MODE_TO_TXFM"], "u1"),
        "MAX_TX_SIZE_RECT": np.array(flat["MAX_TX_SIZE_RECT"], "u1"),
        "TX_TYPE_INTRA_INV_SET1": np.array(flat["TX_TYPE_INTRA_INV_SET1"],
                                           "u1"),
        "TX_TYPE_INTRA_INV_SET2": np.array(flat["TX_TYPE_INTRA_INV_SET2"],
                                           "u1"),
        "TX_TYPE_INTER_INV_SET1": np.array(flat["TX_TYPE_INTER_INV_SET1"],
                                           "u1"),
        "TX_TYPE_INTER_INV_SET2": np.array(flat["TX_TYPE_INTER_INV_SET2"],
                                           "u1")}
    for name, (w, h) in _SCANS.items():
        checks[name] = np.array([(p % w) * h + p // w for p in flat[name]],
                                "<i2")
    # the context offsets as libaom's per-size arrays (transposed)
    off = np.array(flat["COEFF_BASE_CTX_OFFSET"]).reshape(3, 5, 5)
    for w, h in set(_SCANS.values()):
        t = off[0 if w == h else 1 if w > h else 2]
        checks[f"COEFF_BASE_CTX_OFFSET {w}x{h}"] = np.array(
            [t[min(r, 4), min(c, 4)] for c in range(w) for r in range(h)],
            "i1")
    for name, arr in checks.items():
        if not _find(data, arr):
            raise RuntimeError(f"{name} of av1_codec.cpp is not in {lib}")
        found[name] = "libaom"
    return found


# ---------------------------------------------------------------------------
# libavif's YUV to RGB, called through ctypes (the tests hold the port's to
# it on random planes)
# ---------------------------------------------------------------------------

# the fields of libavif 1.3.0's avifImage and avifRGBImage this touches
# (x86-64 offsets; `_avif_lib` checks them against avifImageCreate's and
# avifRGBImageSetDefaults' values)
_IMG_W, _IMG_RANGE, _IMG_PLANES, _IMG_ROWBYTES = 0, 16, 24, 48
_IMG_CP, _IMG_MC = 104, 108
_RGB_FORMAT, _RGB_PIXELS, _RGB_ROWBYTES = 12, 48, 56
_LIB = None


def _avif_lib():
    global _LIB
    if _LIB is None:
        import ctypes
        lib = ctypes.CDLL(library_path())
        P, U = ctypes.c_void_p, ctypes.c_uint32
        lib.avifImageCreate.restype = P
        lib.avifImageCreate.argtypes = [U, U, U, U]
        lib.avifImageAllocatePlanes.argtypes = [P, ctypes.c_int]
        lib.avifImageDestroy.argtypes = [P]
        lib.avifRGBImageSetDefaults.argtypes = [P, P]
        lib.avifRGBImageAllocatePixels.argtypes = [P]
        lib.avifRGBImageFreePixels.argtypes = [P]
        lib.avifImageYUVToRGB.argtypes = [P, P]
        img = lib.avifImageCreate(5, 7, 8, 3)
        got = [U.from_address(img + o).value for o in (0, 4, 8, 12)]
        rgb = ctypes.create_string_buffer(128)
        lib.avifRGBImageSetDefaults(ctypes.addressof(rgb), img)
        head = np.frombuffer(rgb.raw[:16], "<u4").tolist()
        lib.avifImageDestroy(img)
        if got != [5, 7, 8, 3] or head != [5, 7, 8, 1]:
            raise RuntimeError("libavif's avifImage / avifRGBImage layouts "
                               "are not those this helper knows")
        _LIB = lib
    return _LIB


def libavif_yuv_to_rgb(y, u, v, ssx, ssy, full, mc, cp, rgba):
    """libavif's avifImageYUVToRGB of 8-bit planes (u, v None for 4:0:0)
    to 8-bit RGB (rgba False) or RGBA, chroma upsampling automatic: uint8
    [H, W, 3], or None where libavif's reformat fails."""
    import ctypes
    lib = _avif_lib()
    h, w = y.shape
    fmt = 4 if u is None else 1 if not ssx else 2 if not ssy else 3
    img = lib.avifImageCreate(w, h, 8, fmt)
    rgb = ctypes.create_string_buffer(128)
    ra = ctypes.addressof(rgb)
    try:
        ctypes.c_uint32.from_address(img + _IMG_RANGE).value = int(full)
        ctypes.c_uint16.from_address(img + _IMG_CP).value = cp
        ctypes.c_uint16.from_address(img + _IMG_MC).value = mc
        lib.avifImageAllocatePlanes(img, 1)
        for i, p in enumerate((y, u, v)):
            if p is None:
                continue
            base = ctypes.c_void_p.from_address(img + _IMG_PLANES +
                                                8 * i).value
            rb = ctypes.c_uint32.from_address(img + _IMG_ROWBYTES +
                                              4 * i).value
            for r in range(p.shape[0]):
                ctypes.memmove(base + r * rb, np.ascontiguousarray(
                    p[r], np.uint8).tobytes(), p.shape[1])
        lib.avifRGBImageSetDefaults(ra, img)
        ctypes.c_uint32.from_address(ra + _RGB_FORMAT).value = int(rgba)
        lib.avifRGBImageAllocatePixels(ra)
        if lib.avifImageYUVToRGB(img, ra) != 0:
            return None
        pix = ctypes.c_void_p.from_address(ra + _RGB_PIXELS).value
        rb = ctypes.c_uint32.from_address(ra + _RGB_ROWBYTES).value
        ch = 4 if rgba else 3
        a = np.ctypeslib.as_array((ctypes.c_uint8 * (rb * h)).from_address(
            pix)).reshape(h, rb)[:, :w * ch].reshape(h, w, ch)
        return a[..., :3].copy()
    finally:
        lib.avifRGBImageFreePixels(ra)
        lib.avifImageDestroy(img)


# ---------------------------------------------------------------------------
# the images and the files
# ---------------------------------------------------------------------------

def _save(img, **kw):
    from PIL import Image
    b = io.BytesIO()
    Image.fromarray(img, "RGBA" if img.ndim == 3 and img.shape[2] == 4
                    else "RGB").save(b, "AVIF", **kw)
    return b.getvalue()


def images():
    """The source images, from SEED."""
    g = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:61, 0:83]
    grad = np.stack([(xx * 3 + yy) % 256, (yy * 4) % 256,
                     ((xx + yy) * 2) % 256], -1)
    grad = np.clip(grad + g.integers(-20, 21, grad.shape), 0,
                   255).astype(np.uint8)
    noise = g.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    cols = g.integers(0, 256, (5, 3)).astype(np.uint8)
    pal = cols[g.integers(0, 5, (17, 25)).repeat(4, 0).repeat(4, 1)[:66, :97]]
    glyphs = g.integers(0, 2, (6, 8, 8)) * 255
    text = glyphs[g.integers(0, 6, (12, 16))].transpose(0, 2, 1, 3).reshape(
        96, 128).astype(np.uint8)
    text = np.stack([text, text // 2 + 64, 255 - text], -1)
    blocky = g.integers(0, 256, (25, 50, 3)).astype(np.uint8).repeat(
        8, 0).repeat(8, 1)
    g8 = np.random.default_rng(SEED + 2)
    pal8 = g8.integers(0, 256, (8, 3)).astype(np.uint8)[g8.integers(
        0, 8, (24, 24)).repeat(4, 0).repeat(4, 1)]
    flat = np.zeros((64, 96, 3), np.uint8)
    flat[:, 48:] = (200, 120, 40)
    return {"grad": grad, "noise": noise, "pal": pal, "pal8": pal8,
            "text": text,
            "blocky": blocky, "flat": flat, "g": g}


_SS = {"444": "4:4:4", "420": "4:2:0", "422": "4:2:2", "400": "4:0:0"}
_TOOLS = {"nofilterintra": {"enable-filter-intra": "0"},
          "nosmooth": {"enable-smooth-intra": "0"},
          "nopaeth": {"enable-paeth-intra": "0"},
          "nocfl": {"enable-cfl-intra": "0"},
          "noedge": {"enable-intra-edge-filter": "0"},
          "noangle": {"enable-angle-delta": "0"},
          "palette": {"enable-palette": "1"},
          "screen": {"tune-content": "screen"},
          "cdfoff": {"cdf-update-mode": "0"},
          "sb128": {"sb-size": "128"}}


def _boxes(d, pos, end):
    while pos + 8 <= end:
        size, typ = struct.unpack_from(">I4s", d, pos)
        yield typ, pos, size
        if size < 8:
            return
        pos += size


def box_offset(d, path):
    """Offset of the box at `path` (types, from the top) in d."""
    containers = {b"meta": 12, b"iprp": 8, b"ipco": 8}
    pos, end = 0, len(d)
    for i, t in enumerate(path):
        for typ, p, size in _boxes(d, pos, end):
            if typ == t:
                if i == len(path) - 1:
                    return p
                pos, end = p + containers[t], p + size
                break
        else:
            raise KeyError(path)


def _patch(d, off, b):
    return d[:off] + b + d[off + len(b):]


def _nclx(d, cp=None, mc=None, full=None):
    o = box_offset(d, (b"meta", b"iprp", b"ipco", b"colr")) + 12
    if cp is not None:
        d = _patch(d, o, struct.pack(">H", cp))
    if mc is not None:
        d = _patch(d, o + 4, struct.pack(">H", mc))
    if full is not None:
        d = _patch(d, o + 6, bytes([full << 7]))
    return d


def _rename(d, path, new):
    return _patch(d, box_offset(d, path) + 4, new)


def avif_files(im=None):
    """name -> bytes of every AVIF file of the slice but the timing file
    and the twins."""
    im = im or images()
    g = im["g"]
    out = {}
    for ss, sub in _SS.items():
        out[f"avif_noise_{ss}.avif"] = _save(im["noise"], quality=100,
                                             subsampling=sub)
        out[f"avif_pal_{ss}.avif"] = _save(im["pal"], quality=100,
                                           subsampling=sub,
                                           advanced=_TOOLS["screen"])
        out[f"avif_limited_{ss}.avif"] = _save(im["grad"], quality=100,
                                               subsampling=sub,
                                               range="limited")
        for speed in (0, 6, 10):
            out[f"avif_grad_{ss}_s{speed}.avif"] = _save(
                im["grad"], quality=100, subsampling=sub, speed=speed)
    for tool, adv in _TOOLS.items():
        for ss in ("420", "444"):
            out[f"avif_grad_{ss}_{tool}.avif"] = _save(
                im["grad"], quality=100, subsampling=_SS[ss], advanced=adv)
    out["avif_text_420.avif"] = _save(im["text"], quality=100,
                                      advanced=_TOOLS["screen"])
    for ss in ("420", "444"):
        out[f"avif_pal8_{ss}_s0.avif"] = _save(
            im["pal8"], quality=100, subsampling=_SS[ss], speed=0,
            advanced={"tune-content": "screen", "enable-intrabc": "0"})
    for r, c in ((0, 1), (1, 0), (1, 1), (0, 2)):
        out[f"avif_tiles_{r}{c}.avif"] = _save(
            im["blocky"], quality=100, tile_rows=r, tile_cols=c,
            advanced={"enable-intrabc": "0"})
    for h, w in ((1, 1), (2, 3), (1, 65), (65, 1), (7, 130)):
        a = g.integers(0, 256, (h, w, 3)).astype(np.uint8)
        for ss in ("420", "422", "444", "400"):
            out[f"avif_size_{h}x{w}_{ss}.avif"] = _save(
                a, quality=100, subsampling=_SS[ss])
    rgba = np.dstack([im["grad"], g.integers(0, 256, im["grad"].shape[:2])
                      .astype(np.uint8)])
    out["avif_alpha_420.avif"] = _save(rgba, quality=100)
    out["avif_alpha_444.avif"] = _save(rgba, quality=100, subsampling="4:4:4")
    out["avif_alpha_odd.avif"] = _save(rgba[:7, :30], quality=100,
                                       subsampling="4:2:2")
    out["avif_flat.avif"] = _save(im["flat"], quality=100)
    from PIL import Image
    ex = Image.Exif()
    ex[0x0112] = 6
    out["avif_exif_orient6.avif"] = _save(im["noise"], quality=100,
                                          exif=ex.tobytes())
    out["avif_icc.avif"] = _save(im["noise"], quality=100,
                                 icc_profile=bytes(range(256)) * 2)
    n420, n444 = out["avif_noise_420.avif"], out["avif_noise_444.avif"]
    for mc, cp in ((1, 1), (2, 2), (4, 1), (5, 1), (7, 1), (9, 9), (12, 1),
                   (12, 2), (12, 9), (8, 1)):
        out[f"avif_nclx_mc{mc}_cp{cp}_420.avif"] = _nclx(n420, cp, mc)
        out[f"avif_nclx_mc{mc}_cp{cp}_444.avif"] = _nclx(n444, cp, mc)
        out[f"avif_nclx_mc{mc}_cp{cp}_limited_422.avif"] = _nclx(
            out["avif_noise_422.avif"], cp, mc, 0)
    out["avif_nclx_identity_444.avif"] = _nclx(n444, 1, 0)
    out["avif_nclx_identity_limited_444.avif"] = _nclx(n444, 1, 0, 0)
    out["avif_nclx_limited_400.avif"] = _nclx(out["avif_noise_400.avif"],
                                              full=0)
    out["avif_nocolr_420.avif"] = _rename(n420, (b"meta", b"iprp", b"ipco",
                                                 b"colr"), b"free")
    # refused
    out["avif_bad_brand.avif"] = _patch(_patch(n420, 8, b"mif1"), 16,
                                        b"mif1")
    out["avif_bad_hdlr.avif"] = _patch(n420, n420.find(b"pict"), b"pica")
    out["avif_bad_noispe.avif"] = _rename(n420, (b"meta", b"iprp", b"ipco",
                                                 b"ispe"), b"free")
    out["avif_bad_noav1c.avif"] = _rename(n420, (b"meta", b"iprp", b"ipco",
                                                 b"av1C"), b"free")
    px = box_offset(n420, (b"meta", b"iprp", b"ipco", b"pixi"))
    out["avif_bad_pixi_mixed.avif"] = _patch(n420, px + 13, b"\x0a")
    out["avif_bad_pixi_av1c.avif"] = _patch(n420, px + 13, b"\x0a\x0a\x0a")
    out["avif_bad_pixi_planes.avif"] = _patch(n420, px + 12, b"\x09")
    out["avif_bad_nclx_reserved.avif"] = _patch(
        n420, box_offset(n420, (b"meta", b"iprp", b"ipco", b"colr")) + 18,
        b"\x81")
    out["avif_bad_cut_meta.avif"] = n420[:120]
    out["avif_bad_cut_item.avif"] = n420[:len(n420) - 40]
    out["avif_bad_matrix10.avif"] = _nclx(n420, 9, 10)
    out["avif_bad_matrix3.avif"] = _nclx(n420, 1, 3)
    out["avif_bad_ycgco_limited.avif"] = _nclx(n444, 1, 8, 0)
    out["avif_bad_identity_420.avif"] = _nclx(n420, 1, 0)
    # later sub-items
    out["avif_later_lossy.avif"] = _save(im["grad"])
    # aom codes the blocky image with intra block copy, lossless or not
    out["avif_later_intrabc.avif"] = _save(im["blocky"], quality=100,
                                           tile_rows=1)
    out["avif_later_prem.avif"] = _save(rgba, quality=100,
                                        alpha_premultiplied=True)
    ispe = box_offset(n420, (b"meta", b"iprp", b"ipco", b"ispe"))
    out["avif_later_scaled.avif"] = _patch(n420, ispe + 12,
                                           struct.pack(">I", 54))
    out["avif_later_10bit.avif"] = _cv2_10bit(g)
    return out


def _cv2_10bit(g):
    import cv2
    img = g.integers(0, 1024, (24, 20, 3)).astype(np.uint16)
    ok, enc = cv2.imencode(".avif", img, [cv2.IMWRITE_AVIF_DEPTH, 10,
                                          cv2.IMWRITE_AVIF_QUALITY, 100])
    if not ok:
        raise RuntimeError("the pip cv2 wrote no 10-bit AVIF")
    return enc.tobytes()


def timing_image(n=2048):
    """The 2048^2 timing image: flat blocks with a few edges, so that the
    lossless file stays small."""
    g = np.random.default_rng(SEED + 1)
    cells = g.integers(0, 256, (n // 32, n // 32, 3)).astype(np.uint8)
    img = cells.repeat(32, 0).repeat(32, 1)
    yy, xx = np.mgrid[0:n, 0:n]
    img[(xx + yy) % 97 == 0] = 255
    return img


def timing_file():
    # aom takes the blocks for screen content and would code them with
    # intra block copy (7e.8a.2) unless told not to
    return _save(timing_image(), quality=100, autotiling=True,
                 advanced={"enable-intrabc": "0"})


def twin_files(checker, projector):
    """The twins' files: the checker and the projector's RGBA, lossless
    at 4:2:0."""
    return {"checker_avif.avif": _save(checker, quality=100),
            "projector_avif.avif": _save(projector, quality=100)}


# ---------------------------------------------------------------------------
# seeded edits and PIL's outcomes
# ---------------------------------------------------------------------------

EDIT_SOURCES = ("avif_noise_420.avif", "avif_noise_444.avif",
                "avif_noise_422.avif", "avif_noise_400.avif",
                "avif_pal_420.avif", "avif_alpha_420.avif",
                "avif_tiles_11.avif", "avif_grad_444_s0.avif",
                "avif_size_7x130_420.avif", "avif_limited_420.avif")
EDITS_EACH = 30


def _regions(d):
    """(container end, AV1 header end) of a file: the primary item's data
    starts after the container; its first 12 bytes hold the OBU headers,
    the sequence header and the start of the frame header."""
    start = d.find(b"mdat") + 4
    return start, min(start + 24, len(d))


def edit_cases(files, sources=EDIT_SOURCES, each=EDITS_EACH, seed=SEED):
    """`each` seeded edits of each file of `sources`: a cut, or one to
    three bytes replaced or with a bit flipped, a third in the container's
    boxes, a third in the first bytes of the item's data (the OBU and
    frame headers), a third in the tile data -> [(source, bytes)], in
    order."""
    out = []
    for si, fn in enumerate(sources):
        src = files[fn]
        c_end, h_end = _regions(src)
        g = np.random.default_rng(seed * 1000 + si)
        for k in range(each):
            d = bytearray(src)
            lo, hi = ((0, c_end), (c_end, h_end), (h_end, len(d)))[k % 3]
            kind = int(g.integers(3))
            if kind == 0:
                d = d[:int(g.integers(max(lo, 1), hi))]
            else:
                for _ in range(int(g.integers(1, 4))):
                    i = int(g.integers(lo, hi))
                    d[i] = int(g.integers(0, 256)) if kind == 1 else \
                        d[i] ^ (1 << int(g.integers(8)))
            out.append((fn, bytes(d)))
    return out


def digest(img):
    """The sha256 of a decode (its shape, then its bytes), or 32 zero
    bytes for a refusal."""
    if img is None:
        return bytes(32)
    img = np.ascontiguousarray(img, np.uint8)
    return hashlib.sha256(str(img.shape).encode() + img.tobytes()).digest()


_PIL = (
    "import os, sys, warnings\n"
    "import numpy as np\n"
    "from PIL import Image\n"
    "warnings.filterwarnings('ignore')\n"
    "d = sys.argv[1]\n"
    "for fn in sorted(os.listdir(d)):\n"
    "    try:\n"
    "        with Image.open(os.path.join(d, fn)) as im:\n"
    "            a = np.asarray(im.convert('RGB'))\n"
    "    except Exception:\n"
    "        continue\n"
    "    np.save(os.path.join(d, fn + '.npy'), a)\n")


def pil_decodes(named):
    """{name: bytes} -> {name: PIL's convert("RGB"), None where PIL
    refuses}, decoded in one child process."""
    tmp = tempfile.mkdtemp()
    try:
        keys = sorted(named)
        for i, k in enumerate(keys):
            with open(os.path.join(tmp, f"{i:05d}.avif"), "wb") as fh:
                fh.write(named[k])
        subprocess.run([sys.executable, "-c", _PIL, tmp], check=True,
                       capture_output=True)
        out = {}
        for i, k in enumerate(keys):
            p = os.path.join(tmp, f"{i:05d}.avif.npy")
            out[k] = np.load(p) if os.path.exists(p) else None
        return out
    finally:
        for fn in os.listdir(tmp):
            os.remove(os.path.join(tmp, fn))
        os.rmdir(tmp)


def write_avif_files(out, checker, projector):
    """Check the tables, write the files, the twins, the timing file and
    `avif_decodes.npz` into `out`."""
    check_tables()
    files = avif_files()
    twins = twin_files(checker, projector)
    timing = timing_file()
    if len(timing) >= 1 << 20:
        raise RuntimeError("the timing file is not under 1 MB")
    every = dict(files, **twins)
    every["avif_2048.avif"] = timing
    for fn, data in every.items():
        with open(os.path.join(out, fn), "wb") as fh:
            fh.write(data)
    dec = pil_decodes(every)
    from PIL import Image
    for fn in twins:
        Image.fromarray(dec[fn]).save(os.path.join(
            out, fn.replace(".avif", "_pil.png")))
    t = dec.pop("avif_2048.avif")
    arrays = {fn: a for fn, a in dec.items() if a is not None}
    arrays[":refused"] = np.array(sorted(fn for fn, a in dec.items()
                                         if a is None))
    arrays["avif_2048.avif:sha256"] = np.frombuffer(
        hashlib.sha256(t.tobytes()).digest(), np.uint8)
    arrays["avif_2048.avif:corner"] = t[:128, :128]
    edits = edit_cases(files)
    ed = pil_decodes({f"{i:04d}": d for i, (_, d) in enumerate(edits)})
    arrays["edits:sha256"] = np.array([np.frombuffer(
        digest(ed[f"{i:04d}"]), np.uint8) for i in range(len(edits))])
    np.savez_compressed(os.path.join(out, "avif_decodes.npz"), **arrays)
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_avif_lossy", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_avif_lossy.py"))
    lossy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lossy)
    lossy.write_lossy_files(out, projector)


def main():
    print(check_tables())
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_assets_avif", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_assets.py"))
    ga = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ga)
    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    write_avif_files(out, ga.checker(), ga.projector())


if __name__ == "__main__":
    main()
