"""Slice 7e.6b: the rarer formats PIL opens (BLP, FLI / FLC, FITS, FTEX,
GBR, IMT, IPTC, McIdas, PhotoCD, PIXAR, XV thumbnails), decoded by the
port (`vision_tpu_torch/scene/pilread.py`, FliDecode.c in
`csrc/image_codecs.cpp`) bit for bit as `PIL.Image.open(p).convert("RGB")`
decodes them, and refused (ValueError) where PIL raises. The reference is
PIL 12.1.0 itself, by path, as the JAX package opens files
(`vision_tpu.scene.texture.load_image`); the files come from numpy seeds
at odd sizes through `tools/gen_torch_pil.py`'s encoders (PIL writes only
BLP palette files) and from the committed
`tests/assets_torch/pil_rare_decodes.npz`. The tolerance is exact
everywhere; the deviations found (ROADMAP C29) are asserted as such."""
import hashlib
import os
import struct
import warnings

import numpy as np
import pytest
from PIL import BlpImagePlugin, Image

from tests.test_torch_pilread import _assert_same, _edits, _pil, _save
from tests.torch_scenes import ASSETS, gen_pil as gp
from vision_tpu.scene import texture as jtex
from vision_tpu_torch.scene import imageio as tio
from vision_tpu_torch.scene import pilread
from vision_tpu_torch.scene import texture as ttex

warnings.filterwarnings("ignore", category=UserWarning, module="PIL")

SIZES = ((1, 1), (5, 7), (13, 9))


def _jpeg(img, mode, **kw):
    data = _save(Image.fromarray(img).convert(mode), "JPEG", **kw)
    k = data.index(b"\xff\xda")
    return data[:k], data[k:]


# ---------------------------------------------------------------------------
# BLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0, 1, 4, 8])
def test_blp2_palette(tmp_path, alpha):
    """BLP2 palette pixels at each alpha depth (any depth but 0 is RGBA),
    the palette's BGRA entries; PIL's own writer's files; a level cut
    short (not enough image data) refused."""
    g = np.random.default_rng(alpha)
    pal = g.integers(0, 256, 1024, np.uint8).tobytes()
    for h, w in SIZES:
        idx = g.integers(0, 256, w * h, np.uint8).tobytes()
        data = gp.blp_bytes(w, h, idx, alpha=alpha, palette=pal)
        _assert_same(tmp_path, data, decodes=True)
        _assert_same(tmp_path, gp.blp_bytes(w, h, idx, alpha=alpha,
                                            palette=pal, length=w * h - 1),
                     decodes=False)
    im = Image.fromarray(g.integers(0, 256, (9, 13, 3), np.uint8)).convert(
        "P")
    for version in ("BLP1", "BLP2"):
        _assert_same(tmp_path, _save(im, "BLP", blp_version=version),
                     decodes=True)


@pytest.mark.parametrize("enc", [4, 5])
@pytest.mark.parametrize("alpha", [0, 1])
def test_blp1_palette(tmp_path, enc, alpha):
    """BLP1 palette encodings 4 and 5: the pixels right after the palette,
    wherever the level's offset points; its length decides how many."""
    g = np.random.default_rng(enc * 2 + alpha)
    pal = g.integers(0, 256, 1024, np.uint8).tobytes()
    for h, w in SIZES:
        idx = g.integers(0, 256, w * h + 5, np.uint8).tobytes()
        for off in (None, 0, 99999):
            _assert_same(tmp_path, gp.blp_bytes(w, h, idx, 1, enc=enc,
                                                alpha=alpha, palette=pal,
                                                offset=off), decodes=True)
        _assert_same(tmp_path, gp.blp_bytes(w, h, idx, 1, enc=enc,
                                            palette=pal, length=w * h - 1),
                     decodes=False)


@pytest.mark.parametrize("alpha_enc", [0, 1, 7], ids=["dxt1", "dxt3", "dxt5"])
@pytest.mark.parametrize("alpha", [0, 1, 8])
def test_blp2_dxt(tmp_path, alpha_enc, alpha):
    """BLP2 DXT1 / 3 / 5 through PIL's Python decoders (unreplicated
    565 colours, // 3 interpolants): random blocks at sizes that are and
    are not multiples of 4 (PIL reads its rows of blocks as raw pixels at
    the image's width), RGBA blocks read as RGB where the header sets no
    alpha; cut short refused."""
    g = np.random.default_rng(alpha_enc * 10 + alpha)
    size = 8 if alpha_enc == 0 else 16
    for h, w in SIZES + ((8, 8), (4, 12), (6, 3)):
        n = ((w + 3) // 4) * ((h + 3) // 4) * size
        data = gp.blp_bytes(w, h, g.integers(0, 256, n, np.uint8).tobytes(),
                            enc=2, alpha=alpha, alpha_enc=alpha_enc)
        _assert_same(tmp_path, data, decodes=True)
        _assert_same(tmp_path, data[:-1], decodes=False)


@pytest.mark.parametrize("kind", [1, 3, 5])
def test_blp_dxt_decoders_match_pils(kind):
    """`pilread.blp_dxt` against BlpImagePlugin's decode_dxt1 / 3 / 5 on
    random blocks (one row of 256 blocks), DXT1 with and without alpha."""
    g = np.random.default_rng(kind)
    size = 8 if kind == 1 else 16
    blocks = g.integers(0, 256, (256, size), np.uint8)
    blocks[:64, :4] = blocks[:64, [2, 3, 0, 1]]     # c0 <= c1 and c0 > c1
    for alpha in ((False, True) if kind == 1 else (True,)):
        fn = {1: lambda d: BlpImagePlugin.decode_dxt1(d, alpha),
              3: BlpImagePlugin.decode_dxt3,
              5: BlpImagePlugin.decode_dxt5}[kind]
        rows = fn(blocks.tobytes())
        bands = 4 if alpha else 3
        want = np.stack([np.frombuffer(bytes(r), np.uint8).reshape(256, 4,
                                                                   bands)
                         for r in rows], 1)             # [n, j, i, bands]
        got = pilread.blp_dxt(blocks, kind, alpha).reshape(256, 4, 4, bands)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["L", "RGB", "CMYK"])
def test_blp1_jpeg(tmp_path, mode):
    """BLP1 JPEG: the header's bytes, then the level's, through PIL's JPEG
    plugin (a CMYK file read as CMYK, its samples inverted), its RGB bytes
    read as BGR into the BLP's size (a narrower BLP re-wraps the rows, an
    RGBA one reads them as BGR too); a BLP larger than its JPEG, a level
    that is no JPEG, an offset past the file refused."""
    g = np.random.default_rng(len(mode))
    img = g.integers(0, 256, (16, 24, 3), np.uint8)
    img[:, :10] = img[:, :1]
    head, level = _jpeg(img, mode, quality=85)
    for w, h, alpha in ((24, 16, 0), (20, 15, 1), (7, 5, 0)):
        _assert_same(tmp_path, gp.blp_bytes(w, h, level, 1, comp=0,
                                            alpha=alpha, jpeg_header=head),
                     decodes=True)
    gap = gp.blp_bytes(24, 16, b"\0" * 7 + level, 1, comp=0,
                       jpeg_header=head, offset=160 + len(head) + 7,
                       length=len(level))
    _assert_same(tmp_path, gap, decodes=True)      # the gap skipped
    for data in (gp.blp_bytes(25, 16, level, 1, comp=0, jpeg_header=head),
                 gp.blp_bytes(24, 16, level[:-1], 1, comp=0,
                              jpeg_header=head[1:]),
                 gp.blp_bytes(24, 16, level, 1, comp=0, jpeg_header=head,
                              length=len(level) + 1)):
        _assert_same(tmp_path, data, decodes=False)


def test_blp1_ycck_read_as_cmyk(tmp_path):
    """A YCCK JPEG in BLP1 (Adobe transform 2): PIL tells libjpeg the file
    is CMYK, so its Y, Cb, Cr and K samples are taken as inks (inverted),
    not converted: the port reads them the same way."""
    g = np.random.default_rng(22)
    img = g.integers(0, 256, (16, 16, 4), np.uint8)
    img[4:12, 2:14] = g.integers(0, 256, 4)
    data = _save(Image.fromarray(img, "CMYK"), "JPEG", quality=90)
    k = data.index(b"Adobe")
    data = data[:k + 11] + b"\2" + data[k + 12:]   # the transform: YCCK
    k = data.index(b"\xff\xda")
    _assert_same(tmp_path, gp.blp_bytes(16, 16, data[k:], 1, comp=0,
                                        jpeg_header=data[:k]), decodes=True)


@pytest.mark.parametrize("case", ["blp1_comp2", "blp1_enc3", "blp2_comp0",
                                  "blp2_enc3", "blp2_alpha_enc2",
                                  "palette_cut", "table_cut", "size_0"])
def test_blp_refusals(tmp_path, case):
    """What BlpImagePlugin refuses (compressions and encodings it has no
    decoder for, a palette or offset table cut short) or passes on (no
    pixels)."""
    idx = bytes(range(35))
    data = {"blp1_comp2": gp.blp_bytes(7, 5, idx, 1, comp=2, enc=4),
            "blp1_enc3": gp.blp_bytes(7, 5, idx, 1, enc=3),
            "blp2_comp0": gp.blp_bytes(7, 5, idx, comp=0),
            "blp2_enc3": gp.blp_bytes(7, 5, idx, enc=3),
            "blp2_alpha_enc2": gp.blp_bytes(7, 5, idx, enc=2, alpha_enc=2),
            "palette_cut": gp.blp_bytes(7, 5, b"", offset=0)[:600],
            "table_cut": gp.blp_bytes(7, 5, idx)[:100],
            "size_0": gp.blp_bytes(0, 5, idx)}[case]
    _assert_same(tmp_path, data, decodes=False)


# ---------------------------------------------------------------------------
# FLI / FLC
# ---------------------------------------------------------------------------

def _fli_frames(g, h=9, w=14):
    a = g.integers(0, 256, (h, w), np.uint8)
    a[:, 2:11] = a[:, 2:3]
    b = a.copy()
    b[1:5, 3:11] = g.integers(0, 256, b[1:5, 3:11].shape)
    return a, b, g.integers(0, 256, (256, 3), np.uint8)


FLI_CASES = ["brun", "brun_6bit", "copy", "lc", "ss2", "black", "pstamp",
             "palette_late", "palette_skip", "two_frames", "no_palette",
             "fli_magic"]


@pytest.mark.parametrize("case", FLI_CASES)
def test_fli_chunks(tmp_path, case):
    """The first frame through FliDecode.c: BRUN, COPY, LC and SS2 deltas
    over it, BLACK, postage stamps skipped; the palette from the first
    colour chunk (8-bit chunk 4, 6-bit chunk 11 shifted by 2, packets
    skipping entries; none: grey), a later frame not read; each cut
    short refused."""
    g = np.random.default_rng(FLI_CASES.index(case))
    for h, w in ((9, 14), (4, 6), (1, 2)):
        a, b, pal = _fli_frames(g, h, w)
        c = {"brun": [gp.fli_colour(pal), gp.fli_brun(a)],
             "brun_6bit": [gp.fli_colour(pal // 4, six_bit=True),
                           gp.fli_brun(a)],
             "copy": [gp.fli_chunk(16, a.tobytes()), gp.fli_colour(pal)],
             "lc": [gp.fli_colour(pal), gp.fli_brun(a),
                    gp.fli_lc(b, min(1, h - 1), a)],
             "ss2": [gp.fli_colour(pal), gp.fli_chunk(16, a.tobytes()),
                     gp.fli_ss2(b, a)],
             "black": [gp.fli_colour(pal), gp.fli_brun(a),
                       gp.fli_chunk(13, b""), gp.fli_chunk(18, bytes(4))],
             "pstamp": [gp.fli_chunk(18, bytes(30)), gp.fli_colour(pal),
                        gp.fli_brun(a)],
             "palette_late": [gp.fli_brun(a), gp.fli_chunk(18, bytes(4)),
                              gp.fli_colour(pal[:200], six_bit=True)],
             "palette_skip": [gp.fli_colour(pal[:50], skip=100),
                              gp.fli_brun(a)],
             "two_frames": [gp.fli_colour(pal), gp.fli_brun(a)],
             "no_palette": [gp.fli_brun(a)],
             "fli_magic": [gp.fli_colour(pal), gp.fli_brun(a)]}[case]
        frames = [[gp.fli_lc(b, 0, a)]] if case == "two_frames" else ()
        data = gp.fli_bytes(w, h, c, 0xAF11 if case == "fli_magic" else
                            0xAF12, frames=frames)
        _assert_same(tmp_path, data, decodes=True)
        _assert_same(tmp_path, data[:-1 - 20 * (case == "two_frames")])


def _fli_one(body, kind=15, w=6, h=3, size=None):
    chunk = struct.pack("<IH", 6 + len(body) if size is None else size,
                        kind) + body
    return gp.fli_bytes(w, h, [chunk])


FLI_CRAFTED = {
    "unknown_chunk": _fli_one(bytes(10), kind=9),
    "zero_advance": _fli_one(bytes(10), kind=18, size=0),
    "advance_past": _fli_one(bytes(10), kind=18, size=900),
    "brun_run_past_line": _fli_one(b"\0\x07\x01" + b"\0\x06\x02" * 2),
    "brun_zero_run": _fli_one(b"\0\x00\x05\x06\x01" + b"\0\x06\x01" * 2),
    "brun_literal": _fli_one(b"\0\xfa" + bytes(range(6)) + b"\0\x06\x01" * 2),
    "brun_short": _fli_one(b"\0\x06\x01\0\x06"),
    "lc_past_height": _fli_one(struct.pack("<HH", 1, 3) + b"\0" * 3, 12),
    "lc_run_past_line": _fli_one(struct.pack("<HH", 0, 1) + b"\1\0\xf9\x05",
                                 12),
    "lc_skip_and_run": _fli_one(struct.pack("<HH", 1, 2) + b"\1\2\xfe\x09"
                                + b"\2\0\1\x07\1\2\x08", 12),
    "ss2_skip_lines": _fli_one(struct.pack("<HHHBBBB", 2, 0xFFFF, 1, 0, 1,
                                           5, 6) + struct.pack("<H", 0), 7),
    "ss2_skip_past": _fli_one(struct.pack("<HHH", 1, 0xFFFC, 0), 7),
    "ss2_last_byte": _fli_one(struct.pack("<HHHBBBB", 1, 0x8033, 1, 0, 0xFF,
                                          7, 8), 7, w=5),
    "ss2_run_past_line": _fli_one(struct.pack("<HHBBBB", 1, 1, 0, 0xFC, 1, 2),
                                  7),
    "copy_short": _fli_one(bytes(10), kind=16),
    "copy_odd_pad": _fli_one(bytes(range(18)) + b"\1", kind=16),
    "no_chunks": gp.fli_bytes(4, 2, []),
    "black_last": gp.fli_bytes(6, 3, [gp.fli_chunk(16, bytes(18)),
                                      gp.fli_chunk(13, b"")]),
}


@pytest.mark.parametrize("case", sorted(FLI_CRAFTED))
def test_fli_crafted_chunks(tmp_path, case):
    """FliDecode.c's checks: an unknown chunk type, a zero or too large
    advance, runs past a line (BRUN's and LC's refusals, SS2's early stop),
    LC lines past the image, SS2's line skips and last-byte words, a COPY
    chunk cut short, a frame of no chunks, a last chunk of fewer than 10
    bytes (refused): decoded or refused as PIL."""
    _assert_same(tmp_path, FLI_CRAFTED[case])


def test_fli_prefix_chunk(tmp_path):
    """A 0xF100 prefix chunk: PIL finds the palette behind it, but its
    decoder starts at offset 128 and refuses the prefix as an unknown frame
    (the port too)."""
    g = np.random.default_rng(3)
    a, _, pal = _fli_frames(g)
    data = gp.fli_bytes(14, 9, [gp.fli_colour(pal), gp.fli_brun(a)],
                        prefix=bytes(20))
    _assert_same(tmp_path, data, decodes=False)


@pytest.mark.parametrize("size", [0, 1, 3, 16, 0x80000010, 0xFFFFFFFF])
def test_fli_frame_size(tmp_path, size):
    """The frame size PIL's loader reads at a time and FliDecode.c compares
    (unsigned): 0 and sizes past the file refused, a size one byte short of
    an odd frame taken (its pad byte)."""
    g = np.random.default_rng(size % 1000)
    a, _, pal = _fli_frames(g)
    data = bytearray(gp.fli_bytes(14, 9, [gp.fli_colour(pal),
                                          gp.fli_brun(a)]))
    real = struct.unpack_from("<I", data, 128)[0]
    struct.pack_into("<I", data, 128, size if size != 16 else real + 1)
    _assert_same(tmp_path, bytes(data))
    struct.pack_into("<I", data, 128, real)
    _assert_same(tmp_path, bytes(data) + b"\0")


# ---------------------------------------------------------------------------
# FITS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 16, 32, -32, -64])
def test_fits_raw(tmp_path, bits):
    """Each BITPIX read as PIL reads it: L, I;16, I and F raw modes in
    little-endian order whatever FITS stores, bottom-up, -64 four bytes a
    sample; BZERO / BSCALE ignored; NAXIS 1; cut short refused; a data
    unit shorter than a card moves the start back into the header."""
    g = np.random.default_rng(abs(bits))
    dt = {8: np.uint8, 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bits]
    for h, w in SIZES:
        x = g.normal(100, 150, (h, w)) if bits < 0 else \
            g.integers(-400, 400, (h, w)) if bits > 8 else \
            g.integers(0, 256, (h, w))
        x = x.astype(dt)
        if bits < 0:
            x.flat[0] = np.nan
        data = gp.fits_bytes(bits, x, [("BZERO", "32768"), ("BSCALE", "2")])
        _assert_same(tmp_path, data, decodes=True)
        _assert_same(tmp_path, gp.fits_bytes(bits, x[:1], naxis=1))
        body = data[:2880] + x.tobytes()[:5]
        _assert_same(tmp_path, body)
        _assert_same(tmp_path, data[:2880 + w * h * abs(bits) // 8 - 1])


@pytest.mark.parametrize("zbits", [8, 16, 32, -32])
def test_fits_gzip(tmp_path, zbits):
    """ZIMAGE GZIP_1 tiles (FitsGzipDecoder): the rest of the file from the
    table's end through gzip, each sample the low bytes of its 4-byte
    value, the rows bottom-up; float tiles give no data (refused), as do
    short or bad gzip data."""
    g = np.random.default_rng(abs(zbits) + 1)
    for h, w in SIZES:
        data = gp.fits_gzip_bytes(zbits, g.integers(-70000, 70000, (h, w)),
                                  table_rows=g.integers(1, 20))
        _assert_same(tmp_path, data, decodes=zbits > 0)
        _assert_same(tmp_path, data[:-5], decodes=False)
        _assert_same(tmp_path, data[:-12] + bytes(12))


@pytest.mark.parametrize("case", ["no_end", "naxis0", "bitpix_bad",
                                  "bitpix_64", "not_simple", "text_naxis",
                                  "gz_no_cmptype", "gz_negative_offset"])
def test_fits_headers(tmp_path, case):
    """Header walks PIL passes on or refuses: no END, no image (NAXIS 0), a
    BITPIX that is no number or not a mode, SIMPLE = F, a NAXIS1 that is
    text, a compressed image without ZCMPTYPE, a table offset of negative
    bytes (BITPIX -32)."""
    x = np.arange(6, dtype=np.uint8).reshape(2, 3)
    data = {"no_end": gp.fits_bytes(8, x)[:80 * 5],
            "naxis0": gp.fits_bytes(8, x, naxis=0),
            "bitpix_bad": gp.fits_bytes(8, x).replace(b"                   8",
                                                      b"                 8.5"),
            "bitpix_64": gp.fits_bytes(8, x).replace(b"                   8",
                                                     b"                  64"),
            "not_simple": gp.fits_bytes(8, x).replace(b"= " + b" " * 19 + b"T",
                                                      b"= " + b" " * 19 + b"F",
                                                      1),
            "text_naxis": gp.fits_bytes(8, x).replace(b"                   3",
                                                      b"                 'a'"),
            "gz_no_cmptype": gp.fits_gzip_bytes(16, x.astype(int)).replace(
                b"ZCMPTYPE", b"ZCMPTYPX"),
            "gz_negative_offset": _second_card(
                gp.fits_gzip_bytes(16, x.astype(int)), "BITPIX", "-32")}[case]
    _assert_same(tmp_path, data)


def _second_card(data, key, value):
    """`data` with the second card of `key` (the extension's) set to
    `value`."""
    card = f"{key:8s}= ".encode()
    i = data.index(card, data.index(card) + 1)
    return data[:i] + f"{key:8s}= {value:>20s}".ljust(80).encode() + \
        data[i + 80:]


# ---------------------------------------------------------------------------
# FTEX, GBR, IMT, McIdas, PIXAR, XV thumbnails
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", [0, 1], ids=["dxt1", "rgb"])
def test_ftex(tmp_path, fmt):
    """FTEX DXT1 (the `bcn` decoder) and raw RGB; a mip size of -1 reads
    the rest, less than -1 is refused; cut short refused."""
    g = np.random.default_rng(fmt)
    for h, w in SIZES + ((8, 12),):
        n = ((w + 3) // 4) * ((h + 3) // 4) * 8 if fmt == 0 else 3 * w * h
        body = g.integers(0, 256, n, np.uint8).tobytes()
        _assert_same(tmp_path, gp.ftex_bytes(fmt, w, h, body), decodes=True)
        _assert_same(tmp_path, gp.ftex_bytes(fmt, w, h, body, -1),
                     decodes=True)
        _assert_same(tmp_path, gp.ftex_bytes(fmt, w, h, body, -2),
                     decodes=False)
        _assert_same(tmp_path, gp.ftex_bytes(fmt, w, h, body[:-1]),
                     decodes=False)


def test_ftex_header(tmp_path):
    """Two formats (PIL's assert), a negative mip offset (seek) refused; a
    format PIL does not know refused; a mip offset past the file passed
    on."""
    base = gp.ftex_bytes(1, 2, 2, bytes(12))
    for at, value in ((20, 2), (28, -4), (24, 3), (28, 5000)):
        d = bytearray(base)
        struct.pack_into("<i", d, at, value)
        _assert_same(tmp_path, bytes(d), decodes=False)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("depth", [1, 4])
def test_gbr(tmp_path, version, depth):
    """GIMP brushes, grey (depth 1) and RGBA (4, alpha dropped), with and
    without comments; a version 2 header size below 28 reads the rest as
    its comment (refused); cut short refused."""
    g = np.random.default_rng(version * 10 + depth)
    for h, w in SIZES:
        img = g.integers(0, 256, (h, w) if depth == 1 else (h, w, 4),
                         np.uint8)
        for comment in (b"", b"a brush\0"):
            data = gp.gbr_bytes(img, version, comment)
            _assert_same(tmp_path, data, decodes=True)
            _assert_same(tmp_path, data[:-1], decodes=False)
        d = bytearray(gp.gbr_bytes(img, version, b""))
        struct.pack_into(">I", d, 0, 22)
        _assert_same(tmp_path, bytes(d), decodes=False)


@pytest.mark.parametrize("case", ["plain", "comments", "no_formfeed",
                                  "no_pixel_type", "cut", "crlf",
                                  "long_header"])
def test_imt(tmp_path, case):
    """IM Tools files: the header's fields to the form feed, grey pixels
    mapped from the file after it; a header without a form feed or pixel
    type, or cut pixels, refused or passed on as PIL does."""
    g = np.random.default_rng(len(case))
    v = g.integers(0, 256, (5, 7), np.uint8)
    data = {"plain": gp.imt_bytes(v),
            "comments": gp.imt_bytes(v, b"* a\n* b\nwidth 7\n* c\nheight 5"
                                        b"\npixel n8\n"),
            "no_formfeed": gp.imt_bytes(v).replace(b"\x0c", b"\n"),
            "no_pixel_type": gp.imt_bytes(v, b"width 7\nheight 5\n"),
            "cut": gp.imt_bytes(v)[:-1],
            "crlf": gp.imt_bytes(v, b"width 7\nheight 5\npixel n8\n"),
            "long_header": gp.imt_bytes(v, b"* " + b"x" * 150 +
                                        b"\nwidth 7\nheight 5\npixel n8\n")
            }[case]
    _assert_same(tmp_path, data)


@pytest.mark.parametrize("nb", [1, 2, 4])
def test_mcidas(tmp_path, nb):
    """McIdas area files of 8-, 16- and 32-bit samples (L, I;16B, I;32B,
    each clipped to 0..255), lines behind a prefix at the header's
    stride; cut short refused."""
    g = np.random.default_rng(nb)
    dt = {1: np.uint8, 2: ">u2", 4: ">i4"}[nb]
    for h, w in SIZES:
        x = g.integers(-300 if nb == 4 else 0, 300, (h, w)).astype(dt)
        for prefix in (0, 5):
            data = gp.mcidas_bytes(x, prefix)
            _assert_same(tmp_path, data, decodes=True)
            _assert_same(tmp_path, data[:-1], decodes=False)


@pytest.mark.parametrize("nb", [1, 2, 4])
@pytest.mark.parametrize("case", ["stride_0", "stride_short",
                                  "stride_negative", "last_pad_missing",
                                  "offset_negative", "offset_past"])
def test_mcidas_strides(tmp_path, nb, case):
    """PIL maps L and I;16B files from the file when their lines fit it (a
    stride of 0 or less is the line's width, a shorter one overlaps lines)
    and otherwise uses its raw decoder (a stride shorter than a line
    refused, the last line's padding may be missing); I;32B always through
    the raw decoder. Negative offsets refused."""
    h, w = 4, 5
    x = np.arange(h * w, dtype=np.int64).reshape(h, w).astype(
        {1: np.uint8, 2: ">u2", 4: ">i4"}[nb])
    d = bytearray(gp.mcidas_bytes(x, 3))
    v = list(struct.unpack_from(">64i", d))
    if case == "stride_0":
        v[13], v[14] = 0, 0                          # w[14] = 0, prefix 0
    elif case == "stride_short":
        v[13] = 0                                    # stride = the prefix
    elif case == "stride_negative":
        v[13], v[14] = -1, -2
    elif case == "last_pad_missing":
        d = d[:-1] if nb == 1 else d
        v[14] = 40
    elif case == "offset_negative":
        v[33] = -20
    else:
        v[33] = len(d) + 10
    struct.pack_into(">64i", d, 0, *v)
    _assert_same(tmp_path, bytes(d))


@pytest.mark.parametrize("case", ["rgb", "cut", "other_mode", "short_head"])
def test_pixar(tmp_path, case):
    """PIXAR rasters: raw RGB at 1024 for channel / depth (14, 2), other
    descriptions passed on (no mode); cut short refused."""
    g = np.random.default_rng(len(case))
    for h, w in SIZES:
        data = gp.pixar_bytes(g.integers(0, 256, (h, w, 3), np.uint8))
        if case == "cut":
            data = data[:-1]
        elif case == "other_mode":
            data = data[:424] + struct.pack("<H", 15) + data[426:]
        elif case == "short_head":
            data = data[:427]
        _assert_same(tmp_path, data, decodes=case == "rgb")


@pytest.mark.parametrize("case", ["plain", "no_comments", "cut", "no_size",
                                  "bad_size"])
def test_xvthumb(tmp_path, case):
    """XV thumbnails: the 3-3-2 palette, pixels mapped after the size line;
    cut pixels, a missing or bad size refused."""
    g = np.random.default_rng(len(case))
    for h, w in SIZES:
        v = g.integers(0, 256, (h, w), np.uint8)
        data = {"plain": gp.xvthumb_bytes(v),
                "no_comments": gp.xvthumb_bytes(v, ()),
                "cut": gp.xvthumb_bytes(v)[:-1],
                "no_size": b"P7 332\n#c\n\n" + v.tobytes(),
                "bad_size": b"P7 332\nx 3 255\n" + v.tobytes()}[case]
        _assert_same(tmp_path, data)


def test_xv_palette_is_pils():
    from PIL import XVThumbImagePlugin
    np.testing.assert_array_equal(
        pilread._XV_PALETTE.reshape(-1),
        np.frombuffer(XVThumbImagePlugin.PALETTE, np.uint8))


# ---------------------------------------------------------------------------
# IPTC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers, component, band", [
    (1, 0, None), (3, 1, None), (3, 1, 1), (3, 1, 3), (4, 1, 4), (4, 1, 0),
    (3, 1, 4), (3, 1, 250), (1, 1, None), (2, 1, None)])
def test_iptc_raw(tmp_path, layers, component, band):
    """Compression 1: the (8, 10) records joined behind a P5 header of the
    header's size; a grey file gives it, an RGB or CMYK one merges it into
    the band (3, 65) names (the others 0; band 0 names the last, a band
    past the mode's is refused); other layer counts pass the file on."""
    g = np.random.default_rng(layers * 100 + component * 10 + (band or 0))
    for h, w in SIZES:
        v = g.integers(0, 256, (h, w), np.uint8).tobytes()
        data = gp.iptc_bytes(w, h, v, layers, component, band=band, split=11)
        _assert_same(tmp_path, data)
        _assert_same(tmp_path, data[:-1])


@pytest.mark.parametrize("mode", ["L", "RGB", "CMYK"])
def test_iptc_jpeg(tmp_path, mode):
    """Compression 5: the joined records opened by whichever plugin takes
    them (a JPEG, a PNG); into an RGB or CMYK file's band only an 8-bit
    grey image (a colour one refused)."""
    g = np.random.default_rng(len(mode))
    img = g.integers(0, 256, (8, 9, 3), np.uint8)
    img[:, :4] = img[:, :1]
    jpeg = _save(Image.fromarray(img).convert(mode), "JPEG", quality=90)
    png = _save(Image.fromarray(img).convert(mode if mode != "CMYK"
                                             else "RGB"), "PNG")
    for inner in (jpeg, png):
        _assert_same(tmp_path, gp.iptc_bytes(9, 8, inner, comp=5, split=50),
                     decodes=True)
    _assert_same(tmp_path, gp.iptc_bytes(9, 8, jpeg, 3, 1, comp=5, band=2),
                 decodes=mode == "L")
    pgm = _save(Image.fromarray(img).convert("L"), "PPM")
    _assert_same(tmp_path, gp.iptc_bytes(9, 8, pgm, 4, 1, comp=5),
                 decodes=True)


@pytest.mark.parametrize("case", ["no_compression", "compression_3",
                                  "no_image", "no_layers", "layers_empty",
                                  "size_text", "trailing_garbage",
                                  "trailing_field", "extended_size",
                                  "field_133", "repeated_layers"])
def test_iptc_fields(tmp_path, case):
    """IptcImagePlugin's field walk: no or an unknown compression refused,
    no image records refused, missing or short fields passed on, a record
    after the image that is no field refused, another field ending it,
    extended sizes, an illegal length refused, a repeated layers field."""
    v = bytes(range(35))
    f = gp.iptc_field
    base = gp.iptc_bytes(7, 5, v)
    k = base.index(bytes((0x1C, 8, 10)))
    data = {"no_compression": base.replace(f(3, 120, b"\1"), b""),
            "compression_3": base.replace(f(3, 120, b"\1"), f(3, 120, b"\3")),
            "no_image": base[:k],
            "no_layers": base.replace(f(3, 60, b"\1\0"), b""),
            "layers_empty": base.replace(f(3, 60, b"\1\0"), f(3, 60, b"\1")),
            "size_text": base.replace(f(3, 30, struct.pack(">H", 5)),
                                      f(3, 30, b"")),
            "trailing_garbage": base + b"garbage",
            "trailing_field": base + f(2, 5, b"title"),
            "extended_size": base[:k] + f(8, 10, v, ext=4),
            "field_133": base[:k] + bytes((0x1C, 8, 10, 133)) + bytes(40),
            "repeated_layers": f(3, 60, b"\1\0") + base}[case]
    _assert_same(tmp_path, data)


def test_iptc_c29_deviations(tmp_path):
    """ROADMAP C29's IPTC part, asserted as documented deviations: into an
    RGB / CMYK file's band PIL also merges grey images of other formats
    (here a grey PNG) and, into the first band, palette images; the port
    takes only 8-bit grey JPEG and PGM there and refuses the rest. A grey
    file whose image is of mode F (a PFM) PIL refuses (its convert has no
    F -> RGB for the image it holds under mode L); the port decodes it."""
    g = np.random.default_rng(29)
    img = g.integers(0, 256, (5, 7), np.uint8)
    p = tmp_path / "c29.iim"
    for im in (Image.fromarray(img), Image.fromarray(img).convert("P")):
        p.write_bytes(gp.iptc_bytes(7, 5, _save(im, "PNG"), 3, 1, comp=5))
        assert _pil(str(p)) is not None
        with pytest.raises(ValueError, match="C29"):
            tio.read_image(str(p))
    pfm = b"Pf\n3 2\n-1.0\n" + np.float32([1, 2, 300, 4, 5, 6]).tobytes()
    p.write_bytes(gp.iptc_bytes(3, 2, pfm, comp=5))
    assert _pil(str(p)) is None
    np.testing.assert_array_equal(tio.read_image(str(p))[0],
                                  pilread.read(pfm, "x.pfm"))


def test_mcidas_overlap_past_the_file_c29(tmp_path):
    """C29: a McIdas file PIL maps whose line stride is shorter than a
    line and whose last line then runs past the file: PIL reads past the
    mapped file (undefined), the port refuses it."""
    x = np.arange(20, dtype=np.uint8).reshape(4, 5)
    d = bytearray(gp.mcidas_bytes(x, 0)[:256 + 16])
    v = list(struct.unpack_from(">64i", d))          # v[k] is word k + 1
    v[13], v[14] = 0, 3                 # the stride: the 3-byte prefix
    struct.pack_into(">64i", d, 0, *v)  # lines at 259, 262, 265, 268
    with pytest.raises(ValueError, match="C29"):
        pilread.read(bytes(d), "x.area")


def test_jpeg_cut_in_its_eoi_c29(tmp_path):
    """C29's JPEG part, found through BLP1's and IPTC's JPEG routes and
    the port's JPEG reader's own: a JPEG whose last byte (the EOI's D9)
    is cut off decodes in PIL where libjpeg-turbo had output every line
    before it met the end (about 1 in 40 seeded files), and the port
    refuses every such file (`imageio._jpeg_whole` wants a marker after
    the scan). Asserted on one seeded file."""
    g = np.random.default_rng(8)
    h, w = int(g.integers(4, 20)), int(g.integers(4, 20))
    data = _save(Image.fromarray(g.integers(0, 256, (h, w, 3), np.uint8)),
                 "JPEG", quality=int(g.integers(50, 96)))[:-1]
    p = tmp_path / "cut.jpg"
    p.write_bytes(data)
    assert _pil(str(p)) is not None
    with pytest.raises(ValueError, match="EOI"):
        tio.read_image(str(p))


# ---------------------------------------------------------------------------
# PhotoCD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("orientation", [0, 1, 2, 3, 7, 0xFD])
def test_pcd(tmp_path, orientation):
    """PhotoCD base images: PcdDecode.c's luma pairs and half-width chroma
    through PIL's PhotoYCC tables, turned by the orientation's low bits
    (1: 90 degrees, 3: 270); cut short refused, a header cut before the
    orientation passed on."""
    data = gp.pcd_bytes(orientation, orientation)
    _assert_same(tmp_path, data, decodes=True)
    _assert_same(tmp_path, data[:-1], decodes=False)
    _assert_same(tmp_path, data[:2048 + 1538], decodes=False)


def test_pcd_ycc_matches_pil():
    """The port's PhotoYCC tables (`data/pcd_ycc.npz`) against PIL's
    "YCC;P" unpacker on a seeded share of the 2^24 triples and every
    corner of the cube."""
    g = np.random.default_rng(76)
    x = g.integers(0, 256, (1 << 16, 3), np.uint8)
    corners = np.array(np.meshgrid(*[[0, 1, 127, 128, 137, 156, 254, 255]]
                                   * 3)).reshape(3, -1).T.astype(np.uint8)
    x = np.concatenate([x, corners])
    want = np.asarray(Image.frombytes("RGB", (len(x), 1), x.tobytes(), "raw",
                                      "YCC;P"))[0]
    np.testing.assert_array_equal(
        pilread.pcd_ycc_to_rgb(x[:, 0], x[:, 1], x[:, 2]), want)


# ---------------------------------------------------------------------------
# seeded edits: decoded or refused exactly as PIL
# ---------------------------------------------------------------------------

def _edit_files(g):
    """name -> (bytes, the range edited) of one file a format: its header
    and its data."""
    a, b, pal = _fli_frames(g)
    img = g.integers(0, 256, (16, 24, 3), np.uint8)
    head, level = _jpeg(img, "RGB", quality=90)
    v = g.integers(0, 256, (6, 9), np.uint8)
    nbk = 3 * 2
    fits = gp.fits_bytes(16, g.integers(-500, 500, (6, 9)).astype(">i2"))
    return {
        "blp_pal": (gp.blp_bytes(9, 6, v.tobytes(), alpha=8, palette=g.integers(
            0, 256, 1024, np.uint8).tobytes()), (0, None)),
        "blp_dxt5": (gp.blp_bytes(9, 6, g.integers(0, 256, 16 * nbk, np.uint8)
                                  .tobytes(), enc=2, alpha=0, alpha_enc=7),
                     (0, None)),
        "blp_jpeg": (gp.blp_bytes(24, 16, level, 1, comp=0,
                                  jpeg_header=head), (0, 160)),
        "fli": (gp.fli_bytes(14, 9, [gp.fli_colour(pal[:20]), gp.fli_brun(a),
                                     gp.fli_lc(b, 1, a)]), (0, None)),
        "fits": (fits, (0, None)),
        "fits_gz": (gp.fits_gzip_bytes(16, g.integers(-900, 900, (6, 9))),
                    (2880, None)),
        "ftex": (gp.ftex_bytes(0, 9, 6, g.integers(0, 256, 8 * nbk, np.uint8)
                               .tobytes()), (0, None)),
        "gbr": (gp.gbr_bytes(g.integers(0, 256, (6, 9, 4), np.uint8)),
                (0, None)),
        "imt": (gp.imt_bytes(v), (0, None)),
        "iptc": (gp.iptc_bytes(9, 6, v.tobytes(), 3, 1, band=2, split=20),
                 (0, None)),
        "mcidas": (gp.mcidas_bytes(v.astype(">u2"), 4), (0, None)),
        "pcd": (gp.pcd_bytes(5, 1), (2048, 2048 + 1539)),
        "pixar": (gp.pixar_bytes(g.integers(0, 256, (6, 9, 3), np.uint8)),
                  (400, 1100)),
        "xvthumb": (gp.xvthumb_bytes(v), (0, None))}


EDIT_FORMATS = sorted(_edit_files(np.random.default_rng(0)))


@pytest.mark.parametrize("fmt", EDIT_FORMATS)
def test_seeded_edits_match_pil(tmp_path, fmt):
    """24 single bytes of each format's file (header and data) set to 0,
    1 or 255, or flipped, from a seed: the port decodes each edited file
    as PIL does, or refuses it (ValueError) where PIL raises; never
    NotImplementedError."""
    g = np.random.default_rng(sum(map(ord, fmt)))
    data, (lo, hi) = _edit_files(np.random.default_rng(0))[fmt]
    for d in _edits(g, data, 24, lo, hi):
        _assert_same(tmp_path, d)


# ---------------------------------------------------------------------------
# the committed files, load_image, the plugins, the twins
# ---------------------------------------------------------------------------

DECODES = np.load(os.path.join(ASSETS, "pil_rare_decodes.npz"))
FILES = sorted(k for k in DECODES.files if ":" not in k)


@pytest.mark.parametrize("fn", FILES)
def test_committed_files_match_their_pil_decodes(fn):
    """Each file of `tools/gen_torch_pil.py`'s slice 7e.6b decodes to
    PIL's stored decode (the same files `chip_smoke.py` holds on the card's
    host)."""
    got, kind = tio.read_image(os.path.join(ASSETS, fn))
    assert kind == "ldr"
    np.testing.assert_array_equal(got, DECODES[fn])


@pytest.mark.parametrize("fn, make", [("blp_2048.blp", gp.blp_dxt_timing),
                                      ("photocd.pcd", gp.pcd_file)])
def test_built_files(fn, make):
    """The 2048 x 2048 BLP2 DXT5 file and the PhotoCD file built from their
    seeds decode to PIL's decodes (their sha256 and corners)."""
    got = pilread.read(make(), fn)
    np.testing.assert_array_equal(got[:128, :128], DECODES[fn + ":corner"])
    assert hashlib.sha256(got.tobytes()).digest() == \
        DECODES[fn + ":sha256"].tobytes()


# one committed file of each format
ONE_A_FORMAT = ["blp1_jpeg_rgb.blp", "blp2_dxt5_a0.blp", "flc_lc.flc",
                "fits_16.fits", "ftex_dxt1.ftc", "gbr_v2_rgba.gbr",
                "imt_grey.imt", "iptc_jpeg_rgb.iim", "mcidas_16.area",
                "pixar_rgb.pxr", "xvthumb.xvt"]


@pytest.mark.parametrize("fn", ONE_A_FORMAT)
@pytest.mark.parametrize("color_space", ["srgb", "linear"])
def test_load_image_matches_jax(fn, color_space):
    """`texture.load_image` of one committed file a format: the JAX
    package's (PIL's decode, linearised the same way), bit for bit."""
    p = os.path.join(ASSETS, fn)
    np.testing.assert_array_equal(ttex.load_image(p, color_space),
                                  jtex.load_image(p, color_space))


def test_load_image_photocd_matches_jax(tmp_path):
    p = tmp_path / "photocd.pcd"
    p.write_bytes(gp.pcd_file())
    np.testing.assert_array_equal(ttex.load_image(str(p), "srgb"),
                                  jtex.load_image(str(p), "srgb"))


def test_twins_hold_their_pixels():
    """The twins hold the PNGs' pixels (the projector's RGB)."""
    for a, b in (("checker.blp", "checker.png"), ("bumps.gbr", "bumps.png"),
                 ("checker.flc", "checker.png"),
                 ("projector.pxr", "projector.png")):
        np.testing.assert_array_equal(
            tio.read_image(os.path.join(ASSETS, a))[0],
            tio.read_image(os.path.join(ASSETS, b))[0])


@pytest.mark.parametrize("name", ["cbox_tex_rare", "env_sphere_rare"])
def test_twin_scenes_render_as_their_references(name):
    """`cbox_tex_rare` (BLP2 checker, GBR normal map) renders as
    `cbox_tex`, `env_sphere_rare` (FLC checker, PIXAR projector) as
    `env_sphere`: the same atlas, the same render, bit for bit (64^2, 1
    spp on the CPU)."""
    import torch
    import vision_tpu_torch as vt
    from tests import torch_scenes as ts
    ref, kw = {"cbox_tex_rare": (ts.cbox_tex, {}),
               "env_sphere_rare": (ts.env_sphere, dict(sub_div=8))}[name]
    a = vt.load_scene(ref(64, **kw), device="cpu")
    b = vt.load_scene(getattr(ts, name)(64, **kw), device="cpu")
    assert torch.equal(a.data.atlas.data, b.data.atlas.data)
    assert torch.equal(vt.render(a, spp=1), vt.render(b, spp=1))


def test_no_plugin_names_7e6b():
    """No reader of the port raises for slice 7e.6b any more."""
    import pathlib
    root = pathlib.Path(pilread.__file__).parent.parent
    assert not [p for p in root.rglob("*") if p.suffix in (
        ".py", ".cpp", ".cu", ".cuh", ".h") and "7e.6b" in p.read_text()]
