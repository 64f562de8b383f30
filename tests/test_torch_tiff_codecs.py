"""Slice 7e.4: the rarer TIFF codecs and layouts, decoded by the port
(`vision_tpu_torch/scene/imageio.py` `read_tiff` on PIL's route,
`cvtiff.py` on OpenCV's, the bitstreams in `csrc/image_codecs.cpp`) bit
for bit as the JAX package's loader gets them: `PIL.Image.open(p)
.convert("RGB")` under a .tif name, the pip cv2's `imread` under .exr /
.hdr names (`jtex.load_image`). Refusals are held against each library's
own: PIL 12.1.0's libtiff has CCITT, LZMA, ZSTD, ThunderScan and old-style
JPEG and no WebP; the pip cv2's has CCITT and ThunderScan and none of
LZMA, ZSTD, WebP and old-style JPEG. The committed files of
`tools/gen_torch_tiff.py` against their stored decodes and the libraries
on the spot; CCITT RLE, RLEW, Group 3 (1-D, 2-D, fill bits, fill order
2) and Group 4, LZMA and ZSTD in PIL's modes, ThunderScan streams,
BigTIFF, YCbCr of every subsampling, CIELab, 10- to 14-bit samples, CMYK
and planar JPEG and planar 16-bit samples; seeded single-byte edits of
each codec's data (ROADMAP C28 counts the edits whose outcome is not
copied); the twins against the JAX Scene and their references. The
tolerance is exact everywhere (float data compared as its bits)."""
import hashlib
import io
import os
import warnings

import numpy as np
import pytest
from PIL import Image

from tests.torch_scenes import ASSETS, gen_assets as ga, gen_tiff as gt
from vision_tpu.scene import texture as jtex
from vision_tpu_torch.scene import imageio as tio
from vision_tpu_torch.scene import texture as ttex

warnings.filterwarnings("ignore", category=UserWarning, module="PIL")

DECODES = np.load(os.path.join(ASSETS, "tiff_decodes.npz"))
FILES = sorted(k for k in DECODES.files if ":" not in k)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _library(path):
    """What the JAX package's loader gets (PIL for .tif, cv2 for .exr /
    .hdr), or None where it raises."""
    try:
        if path.endswith(".tif"):
            with Image.open(path) as im:
                return np.asarray(im.convert("RGB"))
        return jtex.load_image(path)
    except Exception:     # the JAX package's loader catches every error
        return None


def _outcome(tmp_path, data, name):
    """(the library's decode or None, the port's decode, or None where it
    raises ValueError) of `data` under `name`."""
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    want = _library(p)
    try:
        got = tio.read_image(p)[0]
    except ValueError:
        got = None
    return want, got


def _same(want, got):
    if want is None or got is None:
        return want is None and got is None
    if want.dtype == np.uint8:
        return got.shape == want.shape and np.array_equal(got, want)
    return got.shape == want.shape and np.array_equal(_bits(got),
                                                      _bits(want))


def _assert_same(tmp_path, data, name="t.tif", decodes=None):
    """The port gives the library's decode of `data` under `name`, or
    refuses (ValueError) where the library refuses; `decodes`: whether the
    library must decode."""
    want, got = _outcome(tmp_path, data, name)
    if decodes is not None:
        assert (want is not None) == decodes, "the library's outcome"
    assert _same(want, got), (want is None, got is None)


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", FILES)
def test_committed_files_match_their_decodes(fn):
    """Each file decodes to its library's stored decode, and the JAX
    package's loader gives that decode on the spot."""
    p = os.path.join(ASSETS, fn)
    got, kind = tio.read_image(p)
    assert kind == ("ldr" if fn.endswith(".tif") else "hdr")
    assert _same(DECODES[fn], got)
    assert _same(_library(p), got)


@pytest.mark.parametrize("fn", ["sky_a_big.exr", "projector_zstd.tif",
                                "tf_cv_lab.hdr", "tf_g4.tif"])
def test_load_image_matches_jax(fn):
    """`texture.load_image` of a file of each route, as the JAX package's."""
    p = os.path.join(ASSETS, fn)
    np.testing.assert_array_equal(_bits(ttex.load_image(p, "srgb")),
                                  _bits(jtex.load_image(p, "srgb")))


def test_timing_file():
    """The 2048 x 2048 Group 4 page (committed, written by PIL from
    `gen_torch_tiff.page`'s seed) decodes to PIL's decode: its sha256 and
    corner."""
    got = tio.read_image(os.path.join(ASSETS, "g4_2048.tif"))[0]
    np.testing.assert_array_equal(got[:128, :128],
                                  DECODES["g4_2048.tif:corner"])
    assert hashlib.sha256(got.tobytes()).digest() == \
        DECODES["g4_2048.tif:sha256"].tobytes()
    assert (got[..., 0] > 0).tolist() == gt.page(2048).tolist()


# ---------------------------------------------------------------------------
# each codec and layout, on both routes
# ---------------------------------------------------------------------------

G = np.random.default_rng(744)
BW = np.asarray(G.random((37, 53)) > 0.5)
BW[:, :12] = BW[:, :1]
BW[6:10] = True
RGB = G.integers(0, 256, (21, 30, 3))
RGB[:, :9] = RGB[:, :1]
# PIL's CCITT writers: compression and libtiff tags (T4Options, FillOrder,
# RowsPerStrip, Photometric)
FAX = {"g3_1d": ("group3", {}), "g3_2d": ("group3", {292: 1}),
       "g3_2d_fillbits": ("group3", {292: 5}),
       "g3_fillbits_order2": ("group3", {292: 4, 266: 2}),
       "g3_2d_strips": ("group3", {292: 1, 278: 5}),
       "g4": ("group4", {}), "g4_order2_white": ("group4", {266: 2, 262: 0}),
       "g4_strips": ("group4", {278: 7}), "rle": ("tiff_ccitt", {}),
       "rle_order2": ("tiff_ccitt", {266: 2}), "rlew": ("tiff_raw_16", {}),
       "rlew_strips": ("tiff_raw_16", {278: 6})}


def _fax(name):
    comp, info = FAX[name]
    return gt.pil_tiff(BW, compression=comp, tiffinfo=info)


@pytest.mark.parametrize("name", sorted(FAX))
@pytest.mark.parametrize("route", ["t.tif", "t.exr"])
def test_ccitt_matches_libraries(tmp_path, name, route):
    """CCITT RLE, RLEW, Group 3 1-D and 2-D (T4Options: 2-D, fill bits),
    Group 4, fill order 2, min-is-white, several strips: PIL's grey and
    the pip cv2's 0 / 255."""
    _assert_same(tmp_path, _fax(name), route, decodes=True)


@pytest.mark.parametrize("codec", ["lzma", "zstd"])
@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA", "CMYK",
                                  "I;16"])
def test_lzma_zstd_match_pil(tmp_path, codec, mode):
    """LZMA (an .xz stream) and ZSTD (RFC 8878 frames) in every mode PIL
    writes them; OpenCV's libtiff has neither codec, so both are refused
    under a .exr name."""
    img = RGB.astype(np.uint8)
    data = gt.pil_tiff(img[..., 0].astype(np.uint16) * 257, compression=codec) \
        if mode == "I;16" else gt.pil_tiff(img, mode, compression=codec)
    _assert_same(tmp_path, data, decodes=True)
    _assert_same(tmp_path, data, "t.exr", decodes=False)


@pytest.mark.parametrize("level", [-5, 1, 9, 19])
@pytest.mark.parametrize("checksum", [False, True])
def test_zstd_frames_match_pil(tmp_path, level, checksum):
    """ZSTD strips written by libzstd at other levels, with the content
    checksum (XXH64) and the content size, the predictor on a smooth
    image (sequences, repeat offsets, Huffman literals in 1 or 4
    streams)."""
    import zstandard
    y, x = np.mgrid[0:64, 0:96]
    img = np.stack([x * 2 + y, x ^ y, (x * y) % 251], -1).astype(np.int64)
    chunks = [zstandard.ZstdCompressor(
        level=level, write_checksum=checksum, write_content_size=checksum
    ).compress(ga._tiff_pack(img[y0:y0 + 16], 8, "<", 2))
        for y0 in range(0, 64, 16)]
    _assert_same(tmp_path, ga.tiff_bytes(img, 8, 2, 50000, predictor=2,
                                         rows_per_strip=16, chunks=chunks),
                 decodes=True)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("route", ["t.tif", "t.exr"])
def test_thunderscan_matches_libraries(tmp_path, seed, route):
    """ThunderScan 4-bit streams from a seed (runs, 2- and 3-bit deltas,
    raw pixels), grey on PIL's route (the pip cv2 refuses 4-bit grey) and
    with a palette on both."""
    g = np.random.default_rng(seed)
    h, w = int(g.integers(1, 12)), int(g.integers(1, 45))
    photo = 3 if seed % 2 else 1
    cmap = g.integers(0, 65536, (16, 3))
    data = ga.tiff_bytes(np.zeros((h, w, 1), np.int64), 4, photo, 32809,
                         chunks=[gt.thunder_codes(g, w, h)],
                         colormap=cmap if photo == 3 else None)
    _assert_same(tmp_path, data, route,
                 decodes=route == "t.tif" or photo == 3)


@pytest.mark.parametrize("bo", ["<", ">"])
@pytest.mark.parametrize("kind", ["f32_pred3", "u16_lzw", "rgb8_tiles",
                                  "long_offsets"])
def test_bigtiff_matches_cv2(tmp_path, bo, kind):
    """BigTIFF under a .exr name, both byte orders: libtiff's reading of
    20-byte entries and 8-byte offsets (LONG8 or LONG)."""
    f32 = (RGB * 0.37 - 3).astype(np.float32)
    data = {"f32_pred3": lambda: ga.tiff_bytes(
        f32, 32, 2, 8, predictor=3, sampleformat=3, bo=bo, rows_per_strip=8),
        "u16_lzw": lambda: ga.tiff_bytes(RGB * 250, 16, 2, 5, bo=bo),
        "rgb8_tiles": lambda: ga.tiff_bytes(RGB, 8, 2, 8, tile=(16, 16),
                                            bo=bo),
        "long_offsets": lambda: ga.tiff_bytes(RGB, 8, 1, bo=bo,
                                              rows_per_strip=4)}[kind]()
    _assert_same(tmp_path, ga.bigtiff(data, long8=kind != "long_offsets"),
                 "t.exr", decodes=True)


YCC = G.integers(0, 256, (13, 21, 3))


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2), (4, 2), (4, 4),
                                 (1, 2), (4, 1), (2, 4)])
@pytest.mark.parametrize("comp, route", [(1, "t.tif"), (5, "t.tif"),
                                         (1, "t.exr"), (8, "t.exr")])
def test_ycbcr_matches_libraries(tmp_path, sub, comp, route):
    """YCbCr without JPEG, every subsampling at an odd size: libtiff's
    RGBA reader (TIFFYCbCrToRGB) on OpenCV's route and for compressed
    files on PIL's; PIL reads an uncompressed file itself as raw RGBX.
    (2, 4) has no routine in libtiff's RGBA reader: refused."""
    code = {1: lambda b: b, 5: ga.lzw_encode, 8: __import__("zlib").compress}
    data = ga.tiff_bytes(YCC, 8, 6, comp, rows_per_strip=4, ycbcr_sub=sub,
                         chunks=gt.ycbcr_chunks(YCC, *sub, 4, code[comp]))
    _assert_same(tmp_path, data, route)


@pytest.mark.parametrize("tags", ["coefficients", "reference", "planar"])
@pytest.mark.parametrize("route", ["t.tif", "t.exr"])
def test_ycbcr_tags_match_libraries(tmp_path, tags, route):
    """YCbCrCoefficients (BT.709) and ReferenceBlackWhite (studio range)
    given, and planar 1 x 1 YCbCr."""
    extra = {"coefficients": {529: (5, [2126, 10000, 7152, 10000, 722,
                                        10000])},
             "reference": {532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1,
                                     240, 1])}}.get(tags)
    data = ga.tiff_bytes(YCC, 8, 6, 8, rows_per_strip=4, planar=tags ==
                         "planar", ycbcr_sub=(1, 1), tags=extra)
    _assert_same(tmp_path, data, route, decodes=True)


@pytest.mark.parametrize("kind", ["lzw", "planar", "16bit", "white_point",
                                  "extra_sample"])
def test_cielab_matches_cv2(tmp_path, kind):
    """CIELab under a .exr name: libtiff's TIFFCIELabToRGBInit /
    TIFFCIELab16ToXYZ / TIFFXYZToRGB (sRGB display, D50 or the file's
    WhitePoint); planar files and a fourth sample refused."""
    g = np.random.default_rng(8)
    data = {"lzw": lambda: ga.tiff_bytes(g.integers(0, 256, (21, 30, 3)), 8,
                                         8, 5, rows_per_strip=8),
            "planar": lambda: ga.tiff_bytes(g.integers(0, 256, (9, 9, 3)), 8,
                                            8, planar=True),
            "16bit": lambda: ga.tiff_bytes(g.integers(0, 65536, (9, 9, 3)),
                                           16, 8),
            "white_point": lambda: ga.tiff_bytes(
                g.integers(0, 256, (9, 9, 3)), 8, 8,
                tags={318: (5, [3127, 10000, 3290, 10000])}),
            "extra_sample": lambda: ga.tiff_bytes(
                g.integers(0, 256, (9, 9, 4)), 8, 8, extra=(2,))}[kind]()
    _assert_same(tmp_path, data, "t.exr",
                 decodes=kind not in ("planar", "extra_sample"))


def test_cielab_triples_match_cv2(tmp_path):
    """Every L step of 5 by every a by every third b (1.1M triples)
    through libtiff's float32 CIELab conversion and the port's."""
    L, A, B = np.arange(0, 256, 5), np.arange(256), np.arange(0, 256, 3)
    t = np.stack(np.meshgrid(L, A, B, indexing="ij"), -1).reshape(-1, 3)
    img = np.zeros((-(-len(t) // 1024) * 1024, 3), np.int64)
    img[:len(t)] = t
    _assert_same(tmp_path, ga.tiff_bytes(img.reshape(-1, 1024, 3), 8, 8, 8),
                 "t.exr", decodes=True)


@pytest.mark.parametrize("bits", [10, 12, 14])
@pytest.mark.parametrize("kind", ["grey", "rgb", "rgba", "signed", "tiles",
                                  "planar", "palette", "predictor"])
def test_10_to_14_bits_match_cv2(tmp_path, bits, kind):
    """10-, 12- and 14-bit samples under a .exr name: uint16, each sample
    shifted left to 16 bits; signed ones int16, saturated from that value;
    planar files refused (ROADMAP C27), palettes and the horizontal
    predictor refused as cv2 refuses them."""
    g = np.random.default_rng(bits)
    v = g.integers(0, 1 << bits, (9, 13, 4))
    data = {"grey": lambda: ga.tiff_bytes(v[..., :1], bits, 0, 5),
            "rgb": lambda: ga.tiff_bytes(v[..., :3], bits, 2, bo=">"),
            "rgba": lambda: ga.tiff_bytes(v, bits, 2, extra=(2,)),
            "signed": lambda: ga.tiff_bytes(v[..., :1], bits, 1,
                                            sampleformat=2),
            "tiles": lambda: ga.tiff_bytes(v[..., :3], bits, 2, 8,
                                           tile=(16, 16)),
            "planar": lambda: ga.tiff_bytes(v[..., :3], bits, 2,
                                            planar=True),
            "palette": lambda: ga.tiff_bytes(
                v[..., :1], bits, 3, colormap=g.integers(0, 65536, (
                    1 << bits, 3))),
            "predictor": lambda: ga.tiff_bytes(v[..., :1], bits, 1, 5,
                                               predictor=2)}[kind]()
    if kind == "planar":
        # cv2 reads the first plane as chunky samples and the rest of its
        # buffer uninitialised (C27): the port refuses the file
        want, got = _outcome(tmp_path, data, "t.exr")
        assert want is not None and got is None
        return
    _assert_same(tmp_path, data, "t.exr", decodes=kind in (
        "grey", "rgb", "rgba", "signed", "tiles"))


def _jpeg(a):
    b = io.BytesIO()
    Image.fromarray(np.asarray(a, np.uint8)).save(b, "JPEG", quality=85)
    return b.getvalue()


@pytest.mark.parametrize("kind", ["cmyk", "planar_rgb", "planar_ycbcr",
                                  "planar_cmyk", "planar16_rgb",
                                  "planar16_cmyk_mm", "planar16_tiles",
                                  "planar16_grey"])
def test_jpeg_and_planar_layouts_match_pil(tmp_path, kind):
    """CMYK JPEG-in-TIFF (libjpeg's CMYK samples, PIL's CMYK -> RGB),
    planar JPEG (each plane grey; planar YCbCr through libtiff's RGBA
    reader), and planar uncompressed samples above 8 bits (PIL reads each
    plane with its raw mode letter's 8-bit band unpacker; I;16 has none)."""
    c4 = np.random.default_rng(4).integers(0, 256, (16, 24, 4))
    v16 = c4 * 257 + 3
    data = {"cmyk": lambda: gt.pil_tiff(RGB.astype(np.uint8), "CMYK",
                                        compression="jpeg"),
            "planar_rgb": lambda: ga.tiff_bytes(c4[..., :3], 8, 2, 7,
                                                planar=True, chunks=[
                                                    _jpeg(c4[..., k])
                                                    for k in range(3)]),
            "planar_ycbcr": lambda: ga.tiff_bytes(
                c4[..., :3], 8, 6, 7, planar=True, ycbcr_sub=(1, 1),
                chunks=[_jpeg(c4[..., k]) for k in range(3)]),
            "planar_cmyk": lambda: ga.tiff_bytes(c4, 8, 5, 7, planar=True,
                                                 chunks=[_jpeg(c4[..., k])
                                                         for k in range(4)]),
            "planar16_rgb": lambda: ga.tiff_bytes(v16[..., :3], 16, 2,
                                                  planar=True),
            "planar16_cmyk_mm": lambda: ga.tiff_bytes(v16, 16, 5, planar=True,
                                                      bo=">"),
            "planar16_tiles": lambda: ga.tiff_bytes(v16[..., :3], 16, 2,
                                                    planar=True,
                                                    tile=(16, 16)),
            "planar16_grey": lambda: ga.tiff_bytes(v16[..., :1], 16, 1,
                                                   planar=True)}[kind]()
    _assert_same(tmp_path, data, decodes=kind != "planar16_grey")


@pytest.mark.parametrize("comp, photo, bits", [
    (50001, 2, 8), (34676, 32844, 16), (34676, 1, 8), (34677, 32845, 8),
    (32766, 1, 2), (32766, 3, 2), (32766, 1, 8), (6, 6, 8)])
def test_other_codecs_as_the_libraries_take_them(tmp_path, comp, photo,
                                                 bits):
    """What the libraries make of the rarer codecs: WebP-in-TIFF (neither
    libtiff has the codec), SGILog (PIL has no mode for LogL / LogLuv and
    its libtiff refuses SGILog of any other photometric; OpenCV reads LogL
    through libtiff's RGBA reader as 8-bit grey, which decodes these
    bytes, and LogLuv as float, whose 24-bit strip here is too short),
    NeXT (PIL names no such compression; OpenCV refuses 2-bit samples and
    libtiff NeXT of other bits) and old-style JPEG of one YCbCr sample
    (libtiff's RGBA reader, which PIL reads libtiff's YCbCr through, has
    no routine for it; cv2's libtiff lacks the codec)."""
    v = np.random.default_rng(1).integers(0, 1 << min(bits, 8), (6, 8, 1))
    spp = {2: 3, 32845: 3}.get(photo, 1)
    data = ga.tiff_bytes(np.repeat(v, spp, -1), bits, photo, comp,
                         chunks=[bytes(range(60))], colormap=np.zeros(
                             (1 << bits, 3), np.int64) if photo == 3 else None)
    for route in ("t.tif", "t.exr"):
        _assert_same(tmp_path, data, route, decodes=(
            comp, photo, route) == (34676, 32844, "t.exr"))


# ---------------------------------------------------------------------------
# seeded single-byte edits of each codec's data
# ---------------------------------------------------------------------------

def _edits(g, data, n, lo, hi):
    """n seeded single-byte edits of data[lo:hi] (tests/test_torch_pilread
    .py's rule)."""
    out = []
    for _ in range(n):
        d = bytearray(data)
        i = int(g.integers(lo, min(hi, len(data))))
        d[i] = (0, 1, 255, d[i] ^ 1 << int(g.integers(8)))[int(g.integers(4))]
        out.append(bytes(d))
    return out


def _strips(data):
    """The byte range of a one-directory classic TIFF's strips (they
    precede the directory in every file here)."""
    import struct
    bo = "<" if data[:2] == b"II" else ">"
    return 8, struct.unpack(bo + "I", data[4:8])[0]


EDITS = {
    "g3_1d": lambda: _fax("g3_1d"), "g3_2d_strips": lambda: _fax(
        "g3_2d_strips"), "g4": lambda: _fax("g4"),
    "g4_order2_white": lambda: _fax("g4_order2_white"),
    "rle": lambda: _fax("rle"), "rlew": lambda: _fax("rlew"),
    "lzma": lambda: gt.pil_tiff(RGB.astype(np.uint8), compression="lzma"),
    "zstd": lambda: gt.pil_tiff(RGB.astype(np.uint8), "L",
                                compression="zstd"),
    "zstd_rgb": lambda: gt.pil_tiff(RGB.astype(np.uint8),
                                    compression="zstd"),
    "thunder": lambda: ga.tiff_bytes(
        np.zeros((9, 31, 1), np.int64), 4, 3, 32809, colormap=np.arange(
            48).reshape(16, 3) * 1000,
        chunks=[gt.thunder_codes(np.random.default_rng(5), 31, 9)])}
# ROADMAP C28: the edits whose outcome the port does not copy. A CCITT
# strip that ends early succeeds in libtiff with its later rows never
# written (the library's image there is its buffer's old content): the
# port refuses it. A Group 3 2-D strip whose data ends in its last row's
# EOL search: libtiff gives that row otherwise (one row differs). PIL's
# liblzma (5.8) gives a strip's bytes before an error where an older one
# under the standard library's `lzma` (5.4) stops short of them.
UNDEFINED_ROWS = {("g4", "t.tif"): 12, ("g4", "t.exr"): 10,
                  ("g4_order2_white", "t.tif"): 14,
                  ("g4_order2_white", "t.exr"): 14}
LAST_ROW = {("g3_2d_strips", "t.tif"): 1, ("g3_2d_strips", "t.exr"): 1}
LZMA_VERSION = {("lzma", "t.tif"): 5}


@pytest.mark.parametrize("route", ["t.tif", "t.exr"])
@pytest.mark.parametrize("name", sorted(EDITS))
def test_edits_match_the_libraries(tmp_path, name, route):
    """36 seeded edits of each file's coded data, on both routes (LZMA and
    ZSTD are refused by cv2 whole): the port decodes each as the library
    does, or refuses it; the edits ROADMAP C28 lists are counted."""
    data = EDITS[name]()
    g = np.random.default_rng(sum(map(ord, name + route)))
    undefined = lzma_version = last_row = 0
    for d in _edits(g, data, 36, *_strips(data)):
        want, got = _outcome(tmp_path, d, route)
        if _same(want, got):
            continue
        if want is not None and got is not None and name.startswith("g3") \
                and np.count_nonzero((want != got).any(axis=(1, 2))) == 1:
            last_row += 1
            continue
        if want is not None and got is None:
            try:
                tio.read_image(str(tmp_path / route))
            except ValueError as e:
                if "undefined" in str(e):
                    undefined += 1
                    continue
                if name == "lzma":
                    lzma_version += 1
                    continue
        raise AssertionError(f"an edit of {name} differs")
    assert (undefined, last_row, lzma_version) == (
        UNDEFINED_ROWS.get((name, route), 0), LAST_ROW.get((name, route), 0),
        LZMA_VERSION.get((name, route), 0))


# ---------------------------------------------------------------------------
# the twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cbox_sky_bigtiff", "env_sphere_zstd"])
def test_twin_scenes_load_as_jax(name):
    """`cbox_sky_bigtiff` (sky_a as a float32 BigTIFF named .exr) and
    `env_sphere_zstd` (an RGB ZSTD TIFF projector) load in the port as the
    JAX Scene loads them: the same arrays."""
    from tests import torch_scenes as ts
    from tests.test_torch_scene import _assert_same_scene
    from tests.torch_parity import jax_scene_arrays
    from vision_tpu.scene.scene import Scene as JScene
    import vision_tpu_torch as vt
    kw = dict(sub_div=8) if name.startswith("env") else {}
    s = getattr(ts, name)(16, **kw)
    ps = vt.load_scene(s, device="cpu")
    _assert_same_scene(ps.data, ps.camera, ps.filter, jax_scene_arrays(
        JScene(s)))


@pytest.mark.parametrize("name, ref", [("cbox_sky_bigtiff",
                                        "cbox_sky_cvtiff_ref"),
                                       ("env_sphere_zstd", "env_sphere")])
def test_twin_scenes_render_as_their_references(name, ref):
    """Each twin renders as its reference: the same atlas, the same
    render, bit for bit (32^2, 1 spp on the CPU)."""
    import torch
    import vision_tpu_torch as vt
    from tests import torch_scenes as ts
    kw = dict(sub_div=8) if name.startswith("env") else {}
    a = vt.load_scene(getattr(ts, name)(32, **kw), device="cpu")
    b = vt.load_scene(getattr(ts, ref)(32, **kw), device="cpu")
    assert torch.equal(a.data.atlas.data, b.data.atlas.data)
    assert torch.equal(vt.render(a, spp=1), vt.render(b, spp=1))
