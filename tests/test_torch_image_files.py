"""Slice 7c: the image files the JAX package reads through PIL, decoded by
the port (`vision_tpu_torch/scene/imageio.py`) bit for bit as
`PIL.Image.open(p).convert("RGB")` decodes them, and refused (ValueError)
where PIL refuses them: PNG at every colour type, bit depth and interlace,
TGA and BMP variants (written by `tools/gen_torch_assets.py`'s encoders:
PIL cannot write most of them), progressive, CMYK, YCCK and RGB JPEG
files, the committed assets against their stored PIL decodes, and the
Radiance files OpenCV refuses; lossless and arithmetic-coded JPEG from
the generator's own encoders. Slice 7d: TIFF and GIF files (the
generator's hand-built encoders and PIL's writers) against PIL, and the
reader picked by the file's extension as the JAX package picks it (ROADMAP
C20): ".hdr" / ".exr" through OpenCV's rules, every other name through
PIL's. The tolerance is exact everywhere. PIL reads files here by path,
as the JAX package does."""
import hashlib
import io
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.torch_scenes import ASSETS, gen_assets as ga
from vision_tpu.scene import texture as jtex
from vision_tpu_torch.scene import imageio as tio
from vision_tpu_torch.scene import texture as ttex


def _pil(path):
    """PIL's decode, or None where PIL refuses the file."""
    try:
        return np.asarray(Image.open(path).convert("RGB"))
    except (OSError, ValueError, SyntaxError):
        return None


def _both(tmp_path, data, name="f.bin"):
    """(PIL's decode or None, the port's decode or None) of `data`."""
    p = tmp_path / name
    p.write_bytes(data)
    try:
        got = tio.read_image(str(p))[0]
    except ValueError:
        got = None
    return _pil(str(p)), got


def _assert_same(tmp_path, data, decodes=True, name="f.bin"):
    want, got = _both(tmp_path, data, name)
    if not decodes:
        assert want is None, "PIL decodes it"
        assert got is None, "the port decodes it"
        return
    assert want is not None, "PIL refuses it"
    assert got is not None, "the port refuses it"
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

PNG_KINDS = [(ct, d) for ct, ds in {0: (1, 2, 4, 8, 16), 2: (8, 16),
                                    3: (1, 2, 4, 8), 4: (8, 16),
                                    6: (8, 16)}.items() for d in ds]
NCH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.mark.parametrize("interlace", [False, True], ids=["flat", "adam7"])
@pytest.mark.parametrize("kind", PNG_KINDS, ids=lambda k: f"c{k[0]}d{k[1]}")
def test_png_matches_pil(tmp_path, kind, interlace):
    """Every colour type at every bit depth PNG defines, flat and Adam7,
    at 1x1 (Adam7's first pass alone), 3x5 and 9x17: 16-bit grey clipped
    at 255 (PIL's I;16 -> RGB), 1/2/4-bit grey scaled, palettes shorter
    than the indices (black)."""
    ct, depth = kind
    g = np.random.default_rng(ct * 100 + depth)
    for h, w in ((1, 1), (3, 5), (9, 17)):
        v = g.integers(0, 1 << depth, (h, w, NCH[ct]))
        pal = g.integers(0, 256, (max(1, (1 << depth) - 3), 3)) \
            if ct == 3 else None
        _assert_same(tmp_path, ga.png_bytes(v, depth, ct, interlace, pal))


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------

def _tga_px(g, h, w, depth, levels=256):
    nb = max(1, depth // 8)
    px = g.integers(0, levels, (h, w, nb)).astype(np.uint8)
    px[:, :w // 2] = px[:, :1]  # runs for the run-length coder
    return px


# (image type, depth, colour-map depth or None, PIL decodes it)
TGA_CASES = [
    (1, 8, 24, True), (9, 8, 24, True), (1, 8, 16, True), (9, 8, 16, True),
    (2, 16, None, True), (10, 16, None, True), (2, 24, None, True),
    (10, 24, None, True), (2, 32, None, True), (10, 32, None, True),
    (3, 8, None, True), (11, 8, None, True), (3, 16, None, True),
    (11, 16, None, True), (3, 8, 24, True), (11, 16, 16, True),
    (1, 8, 32, False), (1, 8, None, False), (2, 8, None, False),
    (2, 24, 24, False), (3, 24, None, False), (1, 16, 24, False),
    (3, 1, 16, False)]


@pytest.mark.parametrize("case", TGA_CASES,
                         ids=lambda c: f"t{c[0]}d{c[1]}m{c[2]}")
def test_tga_matches_pil(tmp_path, case):
    """Each image type and depth, with and without a colour map, stored
    bottom-up and top-down, left to right and mirrored, run-length packets
    within rows: PIL's decode, or PIL's refusal (a 32-bit map, a map on a
    true-colour image, a type without its map, depths PIL has no mode
    for)."""
    itype, depth, mdepth, decodes = case
    g = np.random.default_rng(itype * 100 + depth)
    cmap = None if mdepth is None else g.integers(
        0, 256, (20, mdepth // 8)).astype(np.uint8)
    for top_down in (False, True):
        for rtl in (False, True):
            px = _tga_px(g, 4, 9, depth, 24 if itype & 7 == 1 else 256)
            data = ga.tga_bytes(px, itype, depth, cmap=cmap,
                                cmap_depth=mdepth or 24, cmap_start=2,
                                top_down=top_down, right_to_left=rtl,
                                id_field=b"id", rle_rows=True)
            _assert_same(tmp_path, data, decodes, "f.tga")


def test_tga_one_bit(tmp_path):
    """1-bit grey rows (PIL's mode "1") decode; run-length coded they are
    refused, as PIL refuses them."""
    px = np.packbits(np.random.default_rng(1).integers(0, 2, (3, 16)),
                     axis=1)[..., None]
    data = ga.tga_bytes(px, 3, 1)
    _assert_same(tmp_path, data[:12] + struct.pack("<H", 13) + data[14:])
    rle = ga.tga_bytes(px, 11, 1)
    _assert_same(tmp_path, rle[:12] + struct.pack("<H", 16) + rle[14:],
                 decodes=False)


@pytest.mark.parametrize("packets, decodes", [
    ("raw_across_rows", True), ("run_across_rows", False),
    ("raw_past_end", True), ("truncated", False)])
def test_tga_run_length_packets(tmp_path, packets, decodes):
    """PIL's run-length decoder lets a raw packet run on into the next row
    (and past the image's end) but refuses a repeat packet that crosses a
    row's end, and a file that ends early."""
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 11, 0, 0, 0, 0, 0, 5, 3, 8, 0x20)
    body = {"raw_across_rows": bytes([6]) + bytes(range(7)) + bytes([7])
            + bytes(range(10, 18)),
            "run_across_rows": bytes([0x86, 9, 0x87, 3]),
            "raw_past_end": bytes([0x84, 1, 0x84, 2, 5]) + bytes(range(6)),
            "truncated": bytes([0x84, 1, 0x84, 2])}[packets]
    _assert_same(tmp_path, head + body, decodes, "f.tga")


@pytest.mark.parametrize("seed", range(4))
def test_tga_random_variants(tmp_path, seed):
    """Random types, depths, maps, origins and cuts: whatever PIL decodes
    the port decodes to the same bytes, whatever PIL refuses the port
    refuses."""
    g = np.random.default_rng(seed)
    decoded = 0
    for _ in range(40):
        itype = int(g.choice([1, 2, 3, 9, 10, 11]))
        depth = int(g.choice([8, 16, 24, 32]))
        mdepth = int(g.choice([16, 24, 32])) if itype & 7 == 1 or \
            g.random() < 0.1 else None
        cmap = None if mdepth is None else g.integers(
            0, 256, (int(g.integers(1, 20)), mdepth // 8)).astype(np.uint8)
        h, w = int(g.integers(1, 7)), int(g.integers(1, 10))
        px = _tga_px(g, h, w, depth, 24 if itype & 7 == 1 else 256)
        data = ga.tga_bytes(px, itype, depth, cmap=cmap,
                            cmap_depth=mdepth or 24,
                            cmap_start=int(g.integers(0, 3)),
                            top_down=bool(g.integers(2)),
                            right_to_left=bool(g.integers(2)),
                            rle_rows=bool(g.integers(2)))
        if g.random() < 0.1:
            data = data[:-int(g.integers(1, 5))]
        want, got = _both(tmp_path, data, "f.tga")
        assert (want is None) == (got is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
            decoded += 1
    assert decoded >= 5


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

def _pal(g, n):
    return np.concatenate([g.integers(0, 256, (n, 3)),
                           np.zeros((n, 1), int)], 1).astype(np.uint8)


def _packed_rows(idx, bits):
    return [np.packbits(((r[:, None] >> np.arange(bits - 1, -1, -1)) & 1)
                       .reshape(-1).astype(np.uint8)).tobytes() for r in idx]


@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("header", [12, 40, 108, 124])
def test_bmp_palette_matches_pil(tmp_path, bits, header):
    """1, 4 and 8 bits through a palette (BGR triples after the 12-byte
    core header, BGRX quads after the others), a palette shorter than the
    indices (black), bottom-up and top-down."""
    g = np.random.default_rng(bits * 1000 + header)
    n = 1 << bits
    for h, w in ((1, 1), (5, 13)):
        idx = g.integers(0, n, (h, w)).astype(np.uint8)
        if header == 12:
            stride = ((w * bits + 31) >> 3) & ~3
            rows = [r + bytes(stride - len(r)) for r in _packed_rows(idx, bits)]
            off = 14 + 12 + 3 * n
            data = (b"BM" + struct.pack("<IHHI", 0, 0, 0, off)
                    + struct.pack("<IHHHH", 12, w, h, 1, bits)
                    + _pal(g, n)[:, :3].tobytes() + b"".join(rows[::-1]))
            _assert_same(tmp_path, data)
            continue
        for top_down in (False, True):
            pal = _pal(g, max(2, n - 3))
            _assert_same(tmp_path, ga.bmp_bytes(
                w, h, bits, _packed_rows(idx, bits), palette=pal,
                header=header, top_down=top_down))


@pytest.mark.parametrize("case", [
    (16, 0, None, 40), (16, 3, (0xF800, 0x7E0, 0x1F), 40),
    (16, 3, (0x7C00, 0x3E0, 0x1F), 124), (24, 0, None, 40),
    (24, 3, (0xFF0000, 0xFF00, 0xFF), 40), (32, 0, None, 40),
    (32, 3, (0xFF000000, 0xFF0000, 0xFF00, 0), 40),
    (32, 3, (0xFF, 0xFF00, 0xFF0000, 0xFF000000), 108),
    (32, 3, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), 124),
    (32, 3, (0, 0, 0, 0), 56)],
    ids=lambda c: f"b{c[0]}c{c[1]}h{c[3]}{'m' if c[2] else ''}")
def test_bmp_true_colour_matches_pil(tmp_path, case):
    """16 bits (x1R5G5B5; bitfields 565 and 555: each channel * 255 //
    its maximum, as PIL's BGR;15 / BGR;16), 24 and 32 bits, bitfield
    layouts PIL knows (masks after a 40-byte header or inside a larger
    one), alpha dropped."""
    bits, comp, masks, header = case
    g = np.random.default_rng(bits + comp)
    for top_down in (False, True):
        px = g.integers(0, 256, (6, 11, bits // 8)).astype(np.uint8)
        _assert_same(tmp_path, ga.bmp_bytes(
            11, 6, bits, [r.tobytes() for r in px], compression=comp,
            masks=masks, header=header, top_down=top_down))


@pytest.mark.parametrize("rle4", [False, True], ids=["rle8", "rle4"])
def test_bmp_run_length_matches_pil(tmp_path, rle4):
    """RLE8 and RLE4 streams: encoded runs cut at a row's end, absolute
    stretches (RLE4's odd ones read as PIL reads them: count // 2 bytes)
    with their pad to an even file offset, ends of line and of bitmap, and
    a delta escape (PIL takes the two bytes after the next two as its
    step)."""
    g = np.random.default_rng(int(rle4))
    bits = 4 if rle4 else 8
    pal = _pal(g, 16)
    for h, w, delta in ((7, 13, None), (5, 9, (1, 0, 1, 0)), (6, 30, None)):
        idx = g.integers(0, 16, (h, w)).astype(np.uint8)
        idx[:, :w // 3] = idx[:, :1]
        stream = ga.bmp_rle(idx, rle4=rle4, delta=delta)
        _assert_same(tmp_path, ga.bmp_bytes(
            w, h, bits, None, palette=pal, compression=2 if rle4 else 1,
            data=stream))
    # a hand-made RLE8 stream: an odd absolute stretch and its pad, a run
    # past the row's end (cut to nothing), ends of line on a row's end, a
    # delta (1 right), an end of line that fills the last row with zeros
    stream = bytes([2, 11, 0, 5, 1, 2, 3, 4, 5, 0, 3, 44, 0, 0, 9, 7, 0, 0,
                    7, 8, 0, 2, 5, 9, 1, 0, 4, 6, 0, 0, 0, 1])
    _assert_same(tmp_path, ga.bmp_bytes(7, 4, 8, None, palette=pal,
                                        compression=1, data=stream))


@pytest.mark.parametrize("case", [
    "depth2", "jpeg_compression", "bitfields_444", "bitfields_rgb0",
    "rle_black_white", "rle_short", "truncated", "header_20"])
def test_bmp_refusals_match_pil(tmp_path, case):
    """What PIL refuses the port refuses: a 2-bit depth, JPEG inside a BMP,
    bitfield layouts PIL does not know, RLE with a black-and-white
    palette, a stream that ends before its image, cut pixel data, an
    unknown header size."""
    g = np.random.default_rng(0)
    px = g.integers(0, 256, (3, 5, 4)).astype(np.uint8)
    idx = g.integers(0, 2, (3, 5)).astype(np.uint8)
    bw = np.array([[0, 0, 0, 0], [255, 255, 255, 0]], np.uint8)
    data = {
        "depth2": lambda: ga.bmp_bytes(5, 3, 2, [bytes(2)] * 3,
                                       palette=_pal(g, 4)),
        "jpeg_compression": lambda: ga.bmp_bytes(
            5, 3, 24, [r[:, :3].tobytes() for r in px], compression=4),
        "bitfields_444": lambda: ga.bmp_bytes(
            5, 3, 16, [r[:, :2].tobytes() for r in px], compression=3,
            masks=(0xF00, 0xF0, 0xF)),
        "bitfields_rgb0": lambda: ga.bmp_bytes(
            5, 3, 32, [r.tobytes() for r in px], compression=3,
            masks=(0xFF, 0xFF00, 0xFF0000, 0)),
        "rle_black_white": lambda: ga.bmp_bytes(
            5, 3, 8, None, palette=bw, compression=1, data=ga.bmp_rle(idx)),
        "rle_short": lambda: ga.bmp_bytes(
            5, 3, 8, None, palette=_pal(g, 4), compression=1,
            data=bytes([5, 1, 0, 0, 0, 1])),
        "truncated": lambda: ga.bmp_bytes(
            5, 3, 24, [r[:, :3].tobytes() for r in px])[:-6],
        "header_20": lambda: b"BM" + struct.pack("<IHHI", 0, 0, 0, 34)
        + struct.pack("<I", 20) + bytes(16) + bytes(60),
    }[case]()
    _assert_same(tmp_path, data, decodes=False)


def test_bmp_grey_ramp_palettes(tmp_path):
    """PIL drops a palette that is the grey ramp 0, 1, 2, ... (or black
    and white) and reads the samples as grey: at 8 bits the same picture,
    below 8 bits through its memory map of the file (w bytes a row every
    stride bytes) when the rows fit, refused when they do not; a
    black-and-white palette at 8 bits reads the rows as bits."""
    g = np.random.default_rng(2)
    ramp = lambda n: np.stack([np.arange(n)] * 3 + [np.zeros(n)], 1).astype(
        np.uint8)
    for bits, w, pal in ((8, 6, ramp(256)), (4, 3, ramp(16)),
                         (4, 5, ramp(16)), (8, 5, ramp(2) * 255)):
        idx = g.integers(0, 1 << bits, (3, w)).astype(np.uint8)
        for top_down in (False, True):
            data = ga.bmp_bytes(w, 3, bits, _packed_rows(idx, bits),
                                palette=pal, top_down=top_down)
            want, got = _both(tmp_path, data)
            assert (want is None) == (got is None), (bits, w)
            if want is not None:
                np.testing.assert_array_equal(got, want)
    data = ga.bmp_bytes(11, 3, 4, _packed_rows(np.zeros((3, 11), int), 4),
                        palette=ramp(16))
    _assert_same(tmp_path, data[:-8], decodes=False)


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

def _image(h, w, ch, seed):
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x * 0.31 + c) * np.cos(y * 0.23 - c)
                     for c in range(ch)], -1)
    img = np.clip(base + g.integers(-40, 41, base.shape), 0, 255)
    return img.astype(np.uint8)


def _jpeg(img, mode=None, **opts):
    return ga._pil_jpeg(img if img.shape[-1] > 1 else img[..., 0], mode,
                        **opts)


def _cmyk_jpeg(img4, **opts):
    b = io.BytesIO()
    Image.fromarray(img4, "CMYK").save(b, "JPEG", **opts)
    return b.getvalue()


def _component_ids(data, ids):
    """`data` (one scan) with its components' ids replaced, in the frame
    and in the scan header."""
    d = bytearray(data)
    i, j = d.index(b"\xff\xc0"), d.index(b"\xff\xda")
    for k, c in enumerate(ids):
        d[i + 10 + 3 * k] = d[j + 5 + 2 * k] = c
    return bytes(d)


def _segment_out(data, marker):
    i = data.index(marker)
    n, = struct.unpack(">H", data[i + 2:i + 4])
    return data[:i] + data[i + 2 + n:]


ADOBE = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"


@pytest.mark.parametrize("size", [(1, 1), (9, 17), (65, 33), (100, 75)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("sampling", [0, 1, 2, "grey"])
@pytest.mark.parametrize("variant", ["plain", "restart", "optimize"])
def test_progressive_jpeg_matches_pil(tmp_path, size, sampling, variant):
    """Progressive files as PIL (libjpeg-turbo) writes them: spectral
    selection, successive approximation (DC and AC refinement, end-of-band
    runs), restart intervals inside the scans, optimised tables; every
    scan's coefficients added up before the IDCT."""
    h, w = size
    opts = dict(progressive=True, quality=75)
    if sampling != "grey":
        opts["subsampling"] = sampling
    if variant == "restart":
        opts["restart_marker_blocks"] = 1
    elif variant == "optimize":
        opts["optimize"] = True
    data = _jpeg(_image(h, w, 1 if sampling == "grey" else 3, h * w), **opts)
    assert b"\xff\xc2" in data
    _assert_same(tmp_path, data)


@pytest.mark.parametrize("kind", [
    "cmyk", "cmyk_progressive", "cmyk_no_adobe", "ycck", "cmyk_transform1",
    "rgb_adobe", "rgb_ids_no_marker", "ycc_no_jfif", "ycc_adobe0_420",
    "ycc_adobe1", "ycc_adobe2", "jfif_and_adobe0", "odd_ids"])
def test_jpeg_colour_spaces_match_pil(tmp_path, kind):
    """The colour space as libjpeg picks it (JFIF: YCbCr; else the Adobe
    transform: 0 RGB / CMYK, 1 YCbCr, 2 YCCK, others YCbCr / YCCK; else
    the component ids 'R', 'G', 'B' for RGB), 4:2:0 RGB upsampled as
    libjpeg upsamples it, and PIL's inverted CMYK and CMYK -> RGB."""
    for h, w in ((9, 17), (48, 64)):
        img3, img4 = _image(h, w, 3, h), _image(h, w, 4, w)
        cmyk = _cmyk_jpeg(img4, quality=85)
        ycc = _jpeg(img3, quality=85, subsampling=2)
        no_jfif = _segment_out(ycc, b"\xff\xe0")
        data = {
            "cmyk": lambda: cmyk,
            "cmyk_progressive": lambda: _cmyk_jpeg(img4, progressive=True),
            "cmyk_no_adobe": lambda: _segment_out(cmyk, b"\xff\xee"),
            "ycck": lambda: ga._adobe_transform(cmyk, 2),
            "cmyk_transform1": lambda: ga._adobe_transform(cmyk, 1),
            "rgb_adobe": lambda: _jpeg(img3, quality=90, keep_rgb=True),
            "rgb_ids_no_marker": lambda: _segment_out(
                _jpeg(img3, quality=90, keep_rgb=True), b"\xff\xee"),
            "ycc_no_jfif": lambda: no_jfif,
            "ycc_adobe0_420": lambda: no_jfif[:2] + ADOBE + b"\0"
            + no_jfif[2:],
            "ycc_adobe1": lambda: no_jfif[:2] + ADOBE + b"\1" + no_jfif[2:],
            "ycc_adobe2": lambda: no_jfif[:2] + ADOBE + b"\2" + no_jfif[2:],
            "jfif_and_adobe0": lambda: ycc[:2] + ADOBE + b"\0" + ycc[2:],
            "odd_ids": lambda: _component_ids(no_jfif, (7, 8, 9)),
        }[kind]()
        _assert_same(tmp_path, data)


def _sof(data):
    return data.index(b"\xff\xc0")


@pytest.mark.parametrize("case", ["12bit", "hierarchical", "fractional",
                                  "two_components", "bad_progression"])
def test_jpeg_refusals_match_pil(tmp_path, case):
    """Files PIL (libjpeg-turbo) refuses the port refuses (ValueError): 12-
    bit samples, hierarchical coding, fractional sampling factors (3:2), 2
    components, a progressive scan with an impossible band."""
    d = bytearray(_jpeg(_image(16, 24, 3, 1), quality=80, subsampling=0))
    i = _sof(d)
    if case == "12bit":
        d[i + 4] = 12
    elif case == "hierarchical":
        d[i + 1] = 0xC5
    elif case == "fractional":
        d[i + 11], d[i + 14], d[i + 17] = 0x31, 0x21, 0x21
    elif case == "two_components":
        d[i + 9] = 2
    else:
        d = bytearray(_jpeg(_image(16, 24, 3, 1), progressive=True))
        s = d.index(b"\xff\xda", d.index(b"\xff\xda") + 2)  # an AC scan
        ns = d[s + 4]
        d[s + 5 + 2 * ns + 1] = 70                          # Se > 63
    _assert_same(tmp_path, bytes(d), decodes=False)



def _scan_header(data, ids, tables, extra=b""):
    """`data` with its first scan header replaced: the component ids and
    their tables listed, then that scan's own Ss, Se, AhAl and `extra`."""
    j = data.index(b"\xff\xda")
    n, = struct.unpack(">H", data[j + 2:j + 4])
    tail = data[j + 2 + n - 3:j + 2 + n]
    body = bytes([len(ids)]) + b"".join(bytes([c, t])
                                        for c, t in zip(ids, tables))
    body += tail + extra
    return (data[:j] + b"\xff\xda" + struct.pack(">H", len(body) + 2) + body
            + data[j + 2 + n:])


@pytest.mark.parametrize("case, decodes", [
    ("five_components", False), ("no_component", False),
    ("four_of_three", False), ("repeated_id", False),
    ("long_scan_header", False), ("repeated_frame_ids", True),
    ("long_frame_header", False), ("second_frame", False)])
def test_jpeg_scan_headers_match_pil(tmp_path, case, decodes):
    """A scan header names 1-4 components, each a frame component at or
    after its slot, none twice, in a header of its own length; the frame
    header has its length and comes once (libjpeg-turbo's get_sos and
    get_sof). A crafted header is refused where PIL refuses it, never
    passed on to the entropy decoder: five rows would overrun its state of
    four components."""
    d = _jpeg(_image(16, 24, 3, 1), quality=80, subsampling=0)
    t = (0x00, 0x11, 0x11)
    i = _sof(d)
    if case == "five_components":
        d = _scan_header(d, (1, 2, 3, 1, 1), t + (0, 0))
    elif case == "no_component":
        d = _scan_header(d, (), ())
    elif case == "four_of_three":
        d = _scan_header(d, (1, 2, 3, 3), t + (0x11,))
    elif case == "repeated_id":
        d = _scan_header(d, (1, 1, 3), t)
    elif case == "long_scan_header":
        d = _scan_header(d, (1, 2, 3), t, b"\0")
    elif case == "repeated_frame_ids":   # frame 5, 5, 9: slot 1 is the second
        d = _component_ids(d, (5, 5, 9))
    elif case == "long_frame_header":
        n, = struct.unpack(">H", d[i + 2:i + 4])
        d = (d[:i + 2] + struct.pack(">H", n + 1) + d[i + 4:i + 2 + n]
             + b"\0" + d[i + 2 + n:])
    else:
        n, = struct.unpack(">H", d[i + 2:i + 4])
        d = d[:i + 2 + n] + d[i:i + 2 + n] + d[i + 2 + n:]
    _assert_same(tmp_path, d, decodes=decodes)


@pytest.mark.parametrize("scans, decodes", [
    ([[2, 1], [0]], True), ([[0, 2], [1]], True), ([[2], [1], [0]], True),
    ([[0], [0], [1], [2]], True), ([[0, 1]], True), ([[1], [2]], True),
    ([[1, 0], [2]], False), ([[2, 2], [0], [1]], False),
    ([[0, 0], [1], [2]], False), ([[0, 1, 2], [2]], False)],
    ids=lambda v: str(v).replace(" ", ""))
def test_jpeg_scan_orders_match_pil(tmp_path, scans, decodes):
    """Sequential files of several scans (`arith_jpeg_bytes`, whose data
    follows each scan's order): a scan may list its components out of the
    frame's order only as far as libjpeg-turbo finds each at or after its
    slot; a component listed twice in a scan is refused; a component no
    scan names is flat mid-grey; a scan after a first scan of every
    component is refused (libjpeg's single-scan image)."""
    sampling = ((1, 1),) * 3
    coef = ga._coefficients(sampling, (2, 3), 4, 7)
    _assert_same(tmp_path, ga.arith_jpeg_bytes(coef, sampling, scans=scans),
                 decodes=decodes)


def test_lossless_jpeg_component_without_scan_is_refused(tmp_path):
    """A lossless file whose scan leaves a frame component out: PIL
    refuses it, and so does the port."""
    img = _image(6, 5, 2, 3)
    d = ga.lossless_jpeg_bytes(img)
    i = d.index(b"\xff\xc3")
    frame = struct.pack(">BHHB", 8, 6, 5, 3) + b"".join(
        bytes([c + 1, 0x11, 0]) for c in range(3))
    d = (d[:i + 2] + struct.pack(">H", len(frame) + 2) + frame
         + d[i + 2 + 3 * 2 + 8:])
    _assert_same(tmp_path, d, decodes=False)


def test_jpeg_scan_decoders_refuse_more_than_four_components():
    """The entropy decoders keep state for four components: their wrappers
    and the C entry points refuse a scan of more (or of none)."""
    from vision_tpu_torch import native
    planes = [np.zeros((1, 1, 64), np.int16) for _ in range(5)]
    rows = np.tile(np.array([0, 0, 1, 1, 1, 1, 1], np.int32), (5, 1))
    bits = np.zeros((8, 16), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    data = b"\0" * 16 + b"\xff\xd9"
    with pytest.raises(ValueError, match="1 to 4"):
        native.jpeg_decode_scan(data, 0, rows, planes, bits, vals, 1, 1, 0)
    with pytest.raises(ValueError, match="1 to 4"):
        native.jpeg_decode_arith_scan(data, 0, rows, planes,
                                      np.zeros(12, np.int32), 1, 1, 0)
    with pytest.raises(ValueError, match="1 to 4"):
        native.jpeg_decode_lossless(
            data, 0, [0] * 5, [np.zeros((1, 1), np.uint16)] * 5, bits, vals,
            0, 1, 0)
    import ctypes
    ptrs = (ctypes.c_void_p * 5)(*(p.ctypes.data for p in planes))
    buf = np.frombuffer(data, np.uint8)
    for n in (0, 5):
        assert native._library().vt_jpeg_decode_scan(
            buf.ctypes.data, len(buf), n, rows.ctypes.data, ptrs,
            bits.ctypes.data, vals.ctypes.data, 1, 1, 0, 0, 0, 63, 0, 0) == -5
        assert native._library().vt_jpeg_decode_arith_scan(
            buf.ctypes.data, len(buf), n, rows.ctypes.data, ptrs,
            np.zeros(12, np.int32).ctypes.data, 1, 1, 0, 0, 0, 63, 0,
            0) == -5

JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("nc, marker", [(1, "none"), (3, "none"),
                                        (3, "adobe0"), (3, "jfif"),
                                        (4, "none"), (4, "adobe2")])
def test_lossless_jpeg_matches_pil(tmp_path, psv, nc, marker):
    """Lossless (SOF3) files, written by `tools/gen_torch_assets.py`
    `lossless_jpeg_bytes`: each predictor, point transforms 0, 1 and 3,
    restart intervals; grey, RGB and CMYK as PIL decodes them; YCbCr (a
    JFIF marker) and YCCK refused, as libjpeg converts no colour in
    lossless mode."""
    app = {"none": b"", "jfif": JFIF,
           "adobe0": ADOBE + b"\0", "adobe2": ADOBE + b"\2"}[marker]
    g = np.random.default_rng(psv * 10 + nc)
    for pt, rst, (h, w) in ((0, 0, (1, 1)), (1, 2, (7, 9)), (3, 1, (12, 5))):
        img = g.integers(0, 256, (h, w, nc)).astype(np.uint8)
        img[:h // 2] = img[:1]
        _assert_same(tmp_path, ga.lossless_jpeg_bytes(img, psv, pt, rst, app),
                     decodes=marker not in ("jfif", "adobe2"))


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sequential", "progressive"])
@pytest.mark.parametrize("sampling", [((1, 1),), ((2, 2), (1, 1), (1, 1)),
                                      ((2, 1), (1, 1), (1, 1)),
                                      ((1, 2), (1, 1), (1, 1))],
                         ids=["grey", "420", "422", "440"])
@pytest.mark.parametrize("cond", [(0, 1, 5), (1, 3, 2), (2, 5, 63)],
                         ids=["default", "dac132", "dac2563"])
def test_arithmetic_jpeg_matches_pil(tmp_path, progressive, sampling, cond):
    """Arithmetic-coded files (SOF9 sequential, SOF10 progressive: DC and
    AC first scans, spectral selection, DC and AC refinement), written by
    `tools/gen_torch_assets.py` `arith_jpeg_bytes` (libjpeg's QM coder),
    with restart intervals and DAC conditioning, as PIL (libjpeg-turbo)
    decodes them."""
    for q, mcus, restart in ((4, (2, 3), 0), (16, (1, 2), 1), (1, (3, 1), 2)):
        coef = ga._coefficients(sampling, mcus, q, q + len(sampling))
        _assert_same(tmp_path, ga.arith_jpeg_bytes(
            coef, sampling, q=q, progressive=progressive, restart=restart,
            cond=cond))


def test_jpeg_cases_left_name_7d():
    """Arithmetic-coded lossless (SOF11) and subsampled lossless files are
    not decoded yet: they named slice 7d until it was done, and now raise
    NotImplementedError naming the slice after it, ROADMAP queue A, 7e;
    never a wrong image."""
    d = bytearray(ga.lossless_jpeg_bytes(_image(8, 8, 3, 2)))
    i = d.index(b"\xff\xc3")
    d[i + 11] = 0x22
    with pytest.raises(NotImplementedError, match="lossless.*7e"):
        tio.read_jpeg(bytes(d))
    d[i + 1], d[i + 11] = 0xCB, 0x11
    with pytest.raises(NotImplementedError, match="arithmetic.*7e"):
        tio.read_jpeg(bytes(d))


# ---------------------------------------------------------------------------
# the committed files, the dispatch, Radiance, load_image
# ---------------------------------------------------------------------------

def test_committed_files_match_their_pil_decodes():
    """Every file of tests/assets_torch/image_decodes.npz
    (`tools/gen_torch_assets.py` `image_files`: slice 7c's files, and
    slice 7d's TIFF and GIF files and the scenes' twins) decodes to its
    stored PIL decode; `tiny.tif`, which raised naming 7d before, among
    them; the timing TIFF `lzw_2048.tif` to the decode whose sha256 and
    corner are stored."""
    dec = np.load(os.path.join(ASSETS, "image_decodes.npz"))
    files = [k for k in dec.files if ":" not in k]
    assert len(files) == 44 and "tiny.tif" in files
    for fn in files:
        got, kind = tio.read_image(os.path.join(ASSETS, fn))
        assert kind == "ldr"
        np.testing.assert_array_equal(got, dec[fn], err_msg=fn)
    got, _ = tio.read_image(os.path.join(ASSETS, "lzw_2048.tif"))
    np.testing.assert_array_equal(got[:128, :128], dec["lzw_2048.tif:corner"])
    assert hashlib.sha256(got.tobytes()).digest() == \
        dec["lzw_2048.tif:sha256"].tobytes()


@pytest.mark.parametrize("fn", ["rle24.tga", "cmap16_topright.tga",
                                "rle8.bmp", "bf565_v5.bmp", "grey16.png",
                                "pal4_adam7.png", "ycck.jpg",
                                "progressive_tiles.jpg", "lossless.jpg",
                                "arith_progressive.jpg"])
@pytest.mark.parametrize("color_space", ["srgb", "linear"])
def test_load_image_matches_jax(fn, color_space):
    """`load_image` of the new files: the JAX package's PIL decode,
    linearised the same way, bit for bit."""
    p = os.path.join(ASSETS, fn)
    np.testing.assert_array_equal(ttex.load_image(p, color_space),
                                  jtex.load_image(p, color_space))


@pytest.mark.parametrize("head, what", [
    (b"GIF89a" + bytes(30), "GIF"), (b"RIFF\0\0\0\0WEBPVP8 " + bytes(20),
                                     "WebP"),
    (b"II*\0" + bytes(30), "TIFF"), (b"\0\0\1\0\1\0" + bytes(30), "ICO"),
    (b"\x0a\x05\x01\x08" + bytes(40), "PNG, JPEG, BMP, TGA")])
def test_other_formats_name_7d(tmp_path, head, what):
    """An icon (a directory of one entry: PIL's ICO plugin takes it) and a
    file of no known format raise NotImplementedError naming the slice
    after 7d, 7e: TGA, which has no magic number, is tried last. GIF and
    TIFF, which named 7d before it was done, and WebP, which named 7e
    before slice 7e.1, are decoded now: these empty bodies are refused
    (ValueError) as PIL refuses them."""
    p = tmp_path / "x.img"
    p.write_bytes(head)
    if what in ("GIF", "TIFF", "WebP"):
        _assert_same(tmp_path, head, decodes=False, name="x.img")
        return
    with pytest.raises(NotImplementedError, match=f"{what}.*7e"):
        tio.read_image(str(p))


def test_tga_header_without_data_is_refused(tmp_path):
    """A file that passes PIL's TGA header checks but has no pixel data
    for them raises ValueError, as PIL refuses it; never an image. A TGA
    whose header reads as an empty icon directory (0 entries) decodes."""
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, 4, 4, 24, 0)
    _assert_same(tmp_path, head + bytes(20), decodes=False)
    assert head.startswith(b"\0\0\2\0")  # CUR's magic number
    _assert_same(tmp_path, head + bytes(range(48)))


@pytest.mark.parametrize("edit", ["orientation", "format"])
def test_radiance_refusals_match_opencv(tmp_path, edit):
    """A Radiance file with another orientation (+Y H +X W) or another
    FORMAT (XYZE): OpenCV, the JAX package's reader, refuses it, and so does
    the port (ValueError)."""
    a = (np.random.default_rng(0).random((4, 9, 3)) * 5).astype(np.float32)
    p = str(tmp_path / "o.hdr")
    cv2.imwrite(p, a)
    d = open(p, "rb").read()
    d = d.replace(b"-Y 4 +X 9", b"+Y 4 +X 9") if edit == "orientation" \
        else d.replace(b"32-bit_rle_rgbe", b"32-bit_rle_xyze")
    with open(p, "wb") as f:
        f.write(d)
    assert cv2.imread(p, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH) is None
    with pytest.raises(ValueError, match="OpenCV"):
        tio.read_image(p)


# ---------------------------------------------------------------------------
# slice 7d: TIFF
# ---------------------------------------------------------------------------

# (photometric, bits, samples, extra samples, sample format)
TIFF_LAYOUTS = [(1, 8, 1, (), 1), (0, 8, 1, (), 1), (2, 8, 3, (), 1),
                (2, 8, 4, (2,), 1), (2, 8, 4, (1,), 1), (2, 8, 4, (0,), 1),
                (1, 8, 2, (2,), 1), (2, 16, 3, (), 1), (1, 16, 1, (), 1),
                (0, 16, 1, (), 1), (1, 16, 1, (), 2), (5, 8, 4, (), 1),
                (3, 8, 1, (), 1), (3, 4, 1, (), 1), (1, 4, 1, (), 1),
                (0, 2, 1, (), 1), (1, 1, 1, (), 1), (0, 1, 1, (), 1),
                (1, 32, 1, (), 1), (1, 32, 1, (), 2), (1, 32, 1, (), 3)]


def _tiff_samples(g, h, w, bits, spp, sf):
    if sf == 3:
        v = (g.standard_normal((h, w, spp)) * 200).astype(np.float32)
        v[0, :3, 0] = [np.nan, np.inf, -np.inf]
        return v
    if sf == 2:
        return g.integers(-300, 300, (h, w, spp)) & ((1 << bits) - 1)
    return g.integers(0, 1 << bits, (h, w, spp))


@pytest.mark.parametrize("bo", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("layout", ["strips", "tiles", "planar"])
@pytest.mark.parametrize("comp, pred", [(1, 1), (5, 2), (8, 1), (32946, 2),
                                        (32773, 2)],
                         ids=["raw", "lzw_pred2", "deflate", "deflate_pred2",
                              "packbits_pred2"])
def test_tiff_matches_pil(tmp_path, comp, pred, layout, bo):
    """Every photometric, bit depth, sample format and extra-sample layout
    of the slice, 13 x 21 in strips of 5 rows, 16 x 16 tiles (partial at
    the edges) or planar strips, in both byte orders, uncompressed, LZW,
    Deflate (8, 32946) and PackBits, predictor 2 where asked (libtiff
    applies it in LZW and Deflate only): PIL's decode, or its refusal.
    PIL's quirks come along: 16-bit grey clipped at 255 (photometric 0 not
    inverted), colour cut to its high byte, floats truncated, associated
    alpha undone, a big-endian 32-bit sample that libtiff decoded read
    byte-swapped, planar layouts PIL has no raw mode for refused."""
    g = np.random.default_rng(comp + pred + len(layout) + (bo == ">"))
    kw = dict(rows_per_strip=5) if layout == "strips" else \
        dict(tile=(16, 16)) if layout == "tiles" else \
        dict(planar=True, rows_per_strip=4)
    for photo, bits, spp, extra, sf in TIFF_LAYOUTS:
        if layout == "planar" and (spp == 1 or (comp == 1 and bits > 8)):
            continue  # one plane; PIL's raw planar 16-bit bands are garbage
        v = _tiff_samples(g, 13, 21, bits, spp, sf)
        cm = g.integers(0, 65536, (1 << bits, 3)) if photo == 3 else None
        data = ga.tiff_bytes(v, bits, photo, comp, predictor=pred, bo=bo,
                             extra=extra, colormap=cm,
                             sampleformat=sf if sf != 1 else None, **kw)
        want, got = _both(tmp_path, data, "t.tif")
        assert (want is None) == (got is None), (photo, bits, spp, extra, sf)
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=str(
                (photo, bits, spp, extra, sf)))


@pytest.mark.parametrize("comp", [1, 5, 8, 32773])
def test_tiff_fill_order_2_matches_pil(tmp_path, comp):
    """Fill order 2 (each byte's bits reversed before decoding): every
    layout PIL has a mode for, decoded or refused as PIL does (a 4-bit
    palette read without libtiff is refused)."""
    g = np.random.default_rng(comp)
    for photo, bits, spp in [(1, 1, 1), (0, 1, 1), (1, 2, 1), (0, 4, 1),
                             (1, 8, 1), (2, 8, 3), (3, 4, 1), (3, 8, 1),
                             (1, 16, 1), (2, 16, 3)]:
        v = g.integers(0, 1 << bits, (13, 21, spp))
        cm = g.integers(0, 65536, (1 << bits, 3)) if photo == 3 else None
        want, got = _both(tmp_path, ga.tiff_bytes(
            v, bits, photo, comp, fill=2, colormap=cm, rows_per_strip=6),
            "t.tif")
        assert (want is None) == (got is None), (photo, bits)
        if want is not None:
            np.testing.assert_array_equal(got, want)


def test_tiff_lzw_matches_pil(tmp_path):
    """LZW streams that fill the 12-bit table and clear it (a 200 x 300
    image, predictor 2), and old-style LZW (least significant bit first),
    which PIL's libtiff decodes too."""
    g = np.random.default_rng(3)
    v = (np.add.outer(np.arange(200), np.arange(300)) // 3)[..., None] \
        .repeat(3, -1)
    v = (v + g.integers(0, 3, v.shape)) % 256
    _assert_same(tmp_path, ga.tiff_bytes(v, 8, 2, 5, predictor=2,
                                         rows_per_strip=64), name="t.tif")
    for photo, spp in ((1, 1), (2, 3)):
        v = g.integers(0, 256, (13, 21, spp))
        _assert_same(tmp_path, ga.tiff_bytes(v, 8, photo, 5, lzw_old=True,
                                             rows_per_strip=5), name="t.tif")


def _jpeg_tiff(img, sub, factors, rps):
    chunks = []
    for y0 in range(0, img.shape[0], rps):
        b = io.BytesIO()
        Image.fromarray(img[y0:y0 + rps]).save(b, "JPEG", quality=85,
                                               subsampling=sub)
        tables, strip = ga._jpeg_split(b.getvalue())
        chunks.append(strip)
    return ga.tiff_bytes(img, 8, 6, 7, rows_per_strip=rps, jpeg_chunks=chunks,
                         jpeg_tables=tables, ycbcr_sub=factors)


@pytest.mark.parametrize("sub, factors, decodes", [
    (2, (2, 2), True), (1, (2, 1), True), (0, (1, 1), True),
    (2, (1, 1), False)], ids=["420", "422", "444", "420_tagged_444"])
def test_tiff_jpeg_ycbcr_matches_pil(tmp_path, sub, factors, decodes):
    """YCbCr JPEG strips (JPEGTables, abbreviated strips) decoded to RGB
    as libtiff's JPEG colour mode has libjpeg do it (fancy upsampling, as
    the port's JPEG decoder), in one strip and in strips of 16 rows; data
    sampled otherwise than its YCbCrSubsampling tag is refused, as
    libtiff refuses it."""
    g = np.random.default_rng(sub)
    y, x = np.mgrid[0:48, 0:72]
    img = np.stack([(x * 3) % 256, (y * 5) % 256, ((x + y) * 2) % 256], -1)
    img = np.clip(img + g.integers(0, 40, img.shape), 0, 255).astype(np.uint8)
    for rps in (48, 16):
        _assert_same(tmp_path, _jpeg_tiff(img, sub, factors, rps), decodes,
                     name="t.tif")


PIL_TIFFS = [(c, m) for c in ("tiff_lzw", "tiff_deflate", "tiff_adobe_deflate",
                               "packbits", "raw")
             for m in ("RGB", "RGBA", "L", "LA", "P", "1", "I;16", "CMYK", "F",
                       "I")] + [("jpeg", "RGB"), ("jpeg", "L")]


@pytest.mark.parametrize("compression, mode", PIL_TIFFS,
                         ids=[f"{c}-{m}" for c, m in PIL_TIFFS])
def test_pil_written_tiff_matches_pil(tmp_path, mode, compression):
    """What PIL's own TIFF writer makes of each mode and compression (JPEG
    for RGB and grey: libtiff's JPEG writer refuses or mangles the other
    modes)."""
    g = np.random.default_rng(len(mode))
    img = g.integers(0, 256, (40, 56, 3)).astype(np.uint8)
    if mode == "F":
        im = Image.fromarray(img[..., 0].astype(np.float32) * 3.3 - 20)
    elif mode == "I":
        im = Image.fromarray(img[..., 0].astype(np.int32) * 200)
    elif mode == "I;16":
        im = Image.fromarray(img[..., 0].astype(np.uint16) * 300)
    else:
        im = Image.fromarray(img).convert(mode)
    b = io.BytesIO()
    im.save(b, "TIFF", compression=compression)
    _assert_same(tmp_path, b.getvalue(), name="t.tif")


@pytest.mark.parametrize("comp, what", [
    (4, "CCITT Group 4"), (34925, "LZMA"), (50000, "ZSTD"), (50001, "WebP"),
    (32809, "ThunderScan"), (34676, "SGILog"), (6, "old-style JPEG")])
def test_tiff_codecs_for_7e_name_it(comp, what):
    """The rarer codecs raise NotImplementedError naming ROADMAP 7e; so
    does BigTIFF."""
    data = bytearray(ga.tiff_bytes(np.zeros((4, 4, 1), np.int64), 8, 1, 1))
    i = data.index(struct.pack("<HHI", 259, 3, 1))
    data[i + 8:i + 10] = struct.pack("<H", comp)
    with pytest.raises(NotImplementedError, match=f"{what}.*7e"):
        tio.read_tiff(bytes(data))
    with pytest.raises(NotImplementedError, match="BigTIFF.*7e"):
        tio._read_pil(b"II+\0" + bytes(30), "x.tif")
    b = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).convert("CMYK").save(
        b, "TIFF", compression="jpeg")
    with pytest.raises(NotImplementedError, match="JPEG TIFF.*7e"):
        tio.read_tiff(b.getvalue())


def test_truncated_tiff_is_refused(tmp_path):
    """A compressed strip whose byte count stops halfway is refused, as
    PIL (libtiff) refuses it; an uncompressed one decodes, as PIL reads it
    from its offset whatever the count says, and a file cut inside its
    pixels is refused."""
    v = np.random.default_rng(5).integers(0, 256, (13, 21, 3))
    for comp in (1, 5, 8, 32773):
        data = bytearray(ga.tiff_bytes(v, 8, 2, comp))
        i = data.index(struct.pack("<HHI", 279, 4, 1)) + 8
        count, = struct.unpack("<I", data[i:i + 4])
        data[i:i + 4] = struct.pack("<I", count // 2)
        _assert_same(tmp_path, bytes(data), comp == 1, name="t.tif")
    # pixels that run past the end of the file
    data = bytearray(ga.tiff_bytes(v, 8, 2, 1))
    i = data.index(struct.pack("<HHI", 273, 4, 1)) + 8
    data[i:i + 4] = struct.pack("<I", len(data) - 100)
    _assert_same(tmp_path, bytes(data), decodes=False, name="t.tif")


# ---------------------------------------------------------------------------
# slice 7d: GIF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_bits", range(2, 9))
def test_gif_matches_pil(tmp_path, min_bits):
    """Each LZW minimum code size 2-8 at palettes of 2 to 256 colours,
    progressive and interlaced rows, a local colour table with a
    transparent index, and a frame inside a larger screen (filled with the
    transparent index, else 0) or reaching past a smaller one."""
    g = np.random.default_rng(min_bits)
    for ncol in (2, 3, 4, 16, 200, 256):
        if ncol > 1 << min_bits:
            continue
        idx = g.integers(0, ncol, (37, 53))
        idx[:10, :20] = idx[0, 0]
        pal = g.integers(0, 256, (ncol, 3))
        for interlace in (False, True):
            _assert_same(tmp_path, ga.gif_bytes(idx, pal, min_bits,
                                                interlace), name="t.gif")
        _assert_same(tmp_path, ga.gif_bytes(idx, pal, min_bits, local=True,
                                            transparency=1), name="t.gif")
        _assert_same(tmp_path, ga.gif_bytes(
            idx, pal, min_bits, screen=(60, 45), offset=(3, 5),
            transparency=ncol - 1), name="t.gif")
        _assert_same(tmp_path, ga.gif_bytes(idx, pal, min_bits,
                                            screen=(40, 30), offset=(3, 5)),
                     name="t.gif")


def test_gif_tables_and_refusals_match_pil(tmp_path):
    """A grey-ramp palette and no palette (PIL's mode L: the index as
    grey), a 300 x 400 frame whose codes fill the 12-bit table, PIL's own
    writer, a file without its terminators (decoded), and data cut short
    (refused, as PIL refuses it)."""
    g = np.random.default_rng(9)
    idx = g.integers(0, 256, (20, 30))
    _assert_same(tmp_path, ga.gif_bytes(idx, np.repeat(
        np.arange(256)[:, None], 3, 1), 8), name="t.gif")
    _assert_same(tmp_path, ga.gif_bytes(idx, None, 8), name="t.gif")
    y, x = np.mgrid[0:300, 0:400]
    big = ((x // 7 + y // 5) % 200 + g.integers(0, 2, x.shape)) % 256
    _assert_same(tmp_path, ga.gif_bytes(big, g.integers(0, 256, (256, 3)), 8),
                 name="t.gif")
    d = ga.gif_bytes(big[:40, :50], g.integers(0, 256, (256, 3)), 8)
    _assert_same(tmp_path, d[:-2], name="t.gif")  # no terminator: decodes
    for cut in (len(d) - 40, 800):
        _assert_same(tmp_path, d[:cut], decodes=False, name="t.gif")
    for mode in ("P", "L", "RGB"):
        img = g.integers(0, 256, (33, 47, 3)).astype(np.uint8)
        im = Image.fromarray(img) if mode == "RGB" else \
            Image.fromarray(img // 64 * 64).convert(mode)
        for interlace in (0, 1):
            b = io.BytesIO()
            im.save(b, "GIF", interlace=interlace)
            _assert_same(tmp_path, b.getvalue(), name="t.gif")


@pytest.mark.parametrize("fn", ["lzw_pred2.tif", "deflate_tiles.tif",
                                "float_pred3_mm.tif", "jpeg_ycbcr.tif",
                                "rgba_assoc.tif", "pal4_lzw.tif",
                                "local_trans.gif", "bumps.gif",
                                "checker_lzw.tif", "projector.gif"])
@pytest.mark.parametrize("color_space", ["srgb", "linear"])
def test_tiff_gif_load_image_matches_jax(fn, color_space):
    """`load_image` of the committed TIFF and GIF files: the JAX package's
    PIL decode, linearised the same way, bit for bit."""
    p = os.path.join(ASSETS, fn)
    np.testing.assert_array_equal(ttex.load_image(p, color_space),
                                  jtex.load_image(p, color_space))


# ---------------------------------------------------------------------------
# C20: the reader picked by the file's extension
# ---------------------------------------------------------------------------

def _cv2_load(path):
    """The JAX package's .hdr / .exr reader, or None where OpenCV refuses."""
    a = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    if a is None:
        return None
    a = a.astype(np.float32)
    if a.ndim == 2:
        a = np.stack([a] * 3, -1)
    return np.ascontiguousarray(a[..., :3][..., ::-1])


@pytest.mark.parametrize("ext", [".hdr", ".exr", ".HDR"])
@pytest.mark.parametrize("kind", PNG_KINDS, ids=lambda k: f"c{k[0]}d{k[1]}")
def test_png_under_opencv_names_matches_jax(tmp_path, kind, ext):
    """A PNG named .hdr / .exr (any case) goes to OpenCV in the JAX
    package: its samples as float32, no /255, no linearisation; 16-bit
    samples whole (PIL would clip or cut them), grey replicated, alpha
    dropped. The port gives the same, in both colour spaces."""
    ct, depth = kind
    g = np.random.default_rng(ct * 100 + depth)
    v = g.integers(0, 1 << depth, (9, 17, NCH[ct]))
    pal = g.integers(0, 256, (max(1, (1 << depth) - 3), 3)) if ct == 3 \
        else None
    p = str(tmp_path / f"x{ext}")
    with open(p, "wb") as f:
        f.write(ga.png_bytes(v, depth, ct, False, pal))
    want = _cv2_load(p)
    for cs in ("srgb", "linear"):
        got = ttex.load_image(p, cs)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jtex.load_image(p, cs))


@pytest.mark.parametrize("fn", ["grey.jpg", "strip.jpg", "tiles.jpg",
                                "progressive.jpg", "rgb_adobe.jpg",
                                "lossless.jpg", "arith_progressive.jpg"])
def test_jpeg_under_opencv_names_matches_jax(tmp_path, fn):
    """A grey, YCbCr or RGB JPEG named .exr: OpenCV's libjpeg-turbo gives
    PIL's samples, taken as float32 without /255."""
    p = str(tmp_path / "x.exr")
    with open(os.path.join(ASSETS, fn), "rb") as f, open(p, "wb") as o:
        o.write(f.read())
    np.testing.assert_array_equal(ttex.load_image(p), _cv2_load(p))
    np.testing.assert_array_equal(ttex.load_image(p, "linear"),
                                  jtex.load_image(p, "linear"))


@pytest.mark.parametrize("fn, what", [
    ("cmyk.jpg", "CMYK"), ("ycck.jpg", "CMYK"), ("topdown24.bmp", "BMP"),
    ("tiny.tif", "TIFF"), ("code2.gif", "GIF")])
def test_opencv_readers_under_hdr_names_name_7e(tmp_path, fn, what):
    """Under a .hdr name OpenCV's own readers decode: its CMYK JPEG path
    (one off from PIL's) and its BMP reader (slice 7e.3a) as the JAX
    package's loader gives them, bit for bit; its TIFF and GIF readers are
    not ported (7e.3b) and raise NotImplementedError naming 7e."""
    p = str(tmp_path / "x.hdr")
    with open(os.path.join(ASSETS, fn), "rb") as f, open(p, "wb") as o:
        o.write(f.read())
    want = _cv2_load(p)
    assert want is not None
    if what in ("TIFF", "GIF"):
        with pytest.raises(NotImplementedError, match=f"{what}.*7e"):
            ttex.load_image(p)
        return
    got = ttex.load_image(p)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jtex.load_image(p))


@pytest.mark.parametrize("fn, name", [
    ("rle24.tga", "x.hdr"), ("sky_a.hdr", "sky.png"), ("sky_a.hdr", "sky"),
    ("piz_half.exr", "x.tif"), ("sky_b.exr", "x.jpg")])
def test_files_under_names_the_reference_refuses(tmp_path, fn, name):
    """Content the extension's library cannot read: a TGA named .hdr
    (OpenCV returns None, the JAX package raises), a Radiance or OpenEXR
    file under any other name (PIL cannot identify it). The port raises
    ValueError, so a scene's slot takes its default as in the JAX
    package."""
    p = str(tmp_path / name)
    with open(os.path.join(ASSETS, fn), "rb") as f, open(p, "wb") as o:
        o.write(f.read())
    with pytest.raises(Exception):
        jtex.load_image(p)
    with pytest.raises(ValueError):
        ttex.load_image(p)


# ---------------------------------------------------------------------------
# the twin scenes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cbox_tex", "env_sphere"])
def test_twin_scenes_render_as_their_originals(name):
    """`cbox_tex_files` / `env_sphere_files` read their images from TIFF,
    GIF and OpenEXR files of the same pixels: the same atlas and lights,
    the same render, bit for bit (16^2, 1 spp on the CPU)."""
    import torch
    import vision_tpu_torch as vt
    from tests import torch_scenes as ts
    make = {"cbox_tex": (ts.cbox_tex, ts.cbox_tex_files, {}),
            "env_sphere": (ts.env_sphere, ts.env_sphere_files,
                           dict(sub_div=8))}[name]
    a = vt.load_scene(make[0](16, **make[2]), device="cpu")
    b = vt.load_scene(make[1](16, **make[2]), device="cpu")
    assert torch.equal(a.data.atlas.data, b.data.atlas.data)
    assert torch.equal(vt.render(a, spp=1), vt.render(b, spp=1))
