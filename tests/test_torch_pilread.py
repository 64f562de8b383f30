"""Slice 7e.6a: the small formats PIL opens, decoded by the port
(`vision_tpu_torch/scene/pilread.py`) bit for bit as
`PIL.Image.open(p).convert("RGB")` decodes them, and refused (ValueError)
where PIL raises; PIL's identification order (ROADMAP C24): every plugin
of PIL 12.1.0's `Image.ID` with a file it identifies, and content no
plugin identifies refused, never NotImplementedError. The reference is
PIL itself, by path, as the JAX package opens files
(`vision_tpu.scene.texture.load_image`); files come from numpy seeds at
odd sizes, written by PIL where it can write them and by
`tools/gen_torch_pil.py`'s encoders where it cannot, and from the
committed `tests/assets_torch/pil_decodes.npz`. The tolerance is exact
everywhere."""
import hashlib
import io
import os
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

from tests.torch_scenes import ASSETS, gen_pil as gp
from vision_tpu.scene import texture as jtex
from vision_tpu_torch import native
from vision_tpu_torch.scene import imageio as tio
from vision_tpu_torch.scene import pilread
from vision_tpu_torch.scene import texture as ttex

warnings.filterwarnings("ignore", category=UserWarning, module="PIL")


def _pil(path):
    """PIL's decode, or None where PIL raises."""
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except Exception:     # the JAX package's loader catches every error
        return None


def _assert_same(tmp_path, data, decodes=None, name="f.img"):
    """The port's decode of `data` equals PIL's, or both refuse it (the
    port with ValueError). `decodes`: what PIL must do, when given."""
    p = tmp_path / name
    p.write_bytes(data)
    want = _pil(str(p))
    if decodes is not None:
        assert (want is not None) == decodes, "PIL's outcome"
    if want is None:
        with pytest.raises(ValueError):
            tio.read_image(str(p))
        return
    got, kind = tio.read_image(str(p))
    assert kind == "ldr" and got.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _save(img, fmt, **kw):
    b = io.BytesIO()
    img.save(b, fmt, **kw)
    return b.getvalue()


def _edits(g, data, n, lo=0, hi=None):
    """n seeded single-byte edits of data[lo:hi]: a byte set to 0, 1 or
    255, or one of its bits flipped."""
    hi = min(hi or len(data), len(data))
    out = []
    for _ in range(n):
        d = bytearray(data)
        i = int(g.integers(lo, hi))
        d[i] = (0, 1, 255, d[i] ^ 1 << int(g.integers(8)))[int(g.integers(4))]
        out.append(bytes(d))
    return out


SIZES = ((1, 1), (5, 7), (13, 9))


def _image(g, h, w, bands=3):
    a = g.integers(0, 256, (h, w, bands), np.uint8)
    a[:, :w // 2] = a[:, :1]                   # runs for the run-length coders
    return a


# ---------------------------------------------------------------------------
# PIL's identification: every plugin of Image.ID
# ---------------------------------------------------------------------------

def _minimal(fmt):
    """A small file PIL's plugin `fmt` identifies (by its format name)."""
    g = np.random.default_rng(sum(map(ord, fmt)))
    rgb = Image.fromarray(_image(g, 5, 7))
    if fmt in ("BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "PCX", "DDS", "IM",
               "TIFF", "QOI", "SGI", "TGA", "WEBP", "JPEG2000", "AVIF",
               "ICNS"):
        return _save(rgb, fmt)
    if fmt == "ICO":
        return _save(rgb, "ICO", sizes=[(7, 5)])
    if fmt == "BLP":
        return _save(rgb.convert("P"), "BLP")
    if fmt in ("MSP", "XBM"):
        return _save(rgb.convert("1"), fmt)
    if fmt == "SPIDER":
        return _save(rgb.convert("F"), fmt)
    if fmt == "CUR":
        return gp.cur_bytes(np.asarray(rgb), "RGB")
    if fmt == "PSD":
        a = np.asarray(rgb)
        return gp.psd_bytes(3, 8, [a[..., c].copy() for c in range(3)], 7, 5)
    if fmt == "SUN":
        return gp.sun_bytes(7, 5, 24, bytes(range(5 * 22)))
    if fmt == "XPM":
        return gp.xpm_bytes(np.array([[0, 1], [1, 0]]), [0xFF0000, 0x00FF00])
    if fmt == "DCX":
        return struct.pack("<II", 987654321, 4 + 4 * 1024) + bytes(4092) + \
            _save(rgb, "PCX")
    if fmt == "FITS":
        cards = [f"{k:8s}= {v:>20s}" for k, v in (
            ("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "2"), ("NAXIS1", "3"),
            ("NAXIS2", "2"))] + ["END"]
        return b"".join(c.ljust(80).encode() for c in cards).ljust(2880) + \
            bytes(range(6)).ljust(2880, b"\0")
    if fmt == "FLI":
        frame = struct.pack("<IHH8x", 26, 0xF1FA, 1) + \
            struct.pack("<IH", 10, 13) + bytes(4)
        head = bytearray(128)
        struct.pack_into("<IHHHHHH", head, 0, 128 + len(frame), 0xAF12, 1, 4,
                         3, 8, 0)
        return bytes(head) + frame
    if fmt == "FTEX":
        return b"FTEX" + struct.pack("<7i", 1, 4, 4, 1, 1, 1, 32) + \
            struct.pack("<i", 48) + bytes(range(48))
    if fmt == "GBR":
        return struct.pack(">5I", 30, 2, 3, 2, 1) + b"GIMP" + \
            struct.pack(">I", 10) + b"x\0" + bytes(range(6))
    if fmt == "IMT":
        return b"width 3\nheight 2\npixel n8\n\x0c" + bytes(range(6))
    if fmt == "IPTC":
        def field(rec, tag, data):
            return bytes((0x1C, rec, tag)) + struct.pack(">H", len(data)) \
                + data
        return field(3, 60, b"\1\0") + field(3, 20, struct.pack(">H", 3)) + \
            field(3, 30, struct.pack(">H", 2)) + field(3, 120, b"\1") + \
            field(8, 10, bytes(range(6)))
    if fmt == "MCIDAS":
        v = [0] * 65
        v[9], v[10], v[11], v[14], v[34] = 2, 3, 1, 1, 256
        return b"\0" * 7 + b"\4" + struct.pack("!62i", *v[3:]) + \
            bytes(range(6))
    if fmt == "PIXAR":
        head = bytearray(1024)
        head[:4] = b"\x80\xe8\0\0"
        struct.pack_into("<HH", head, 416, 2, 3)
        struct.pack_into("<HH", head, 424, 14, 2)
        return bytes(head) + bytes(range(18))
    if fmt == "XVTHUMB":
        return b"P7 332\n#x\n3 2 255\n" + bytes(range(6))
    if fmt == "PCD":
        return bytes(2048) + b"PCD_IPI".ljust(1539, b"\0") + \
            bytes(96 * 2048 - 3587 + 768 * 512 * 3 // 2 + 4096)
    if fmt == "BUFR":
        return b"BUFR" + bytes(60)
    if fmt == "GRIB":
        return b"GRIB\0\0\0\1" + bytes(60)
    if fmt == "HDF5":
        return b"\x89HDF\r\n\x1a\n" + bytes(60)
    if fmt == "EPS":
        return b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 4 4\nshowpage\n"
    if fmt == "MPEG":
        return b"\0\0\1\xb3\0\x80\4" + bytes(60)
    if fmt == "WMF":
        return b"\xd7\xcd\xc6\x9a\0\0" + struct.pack("<4hH", 0, 0, 100, 100,
                                                     1440) + bytes(6) + \
            b"\1\0\t\0" + bytes(60)
    raise AssertionError(fmt)


# PIL 12.1.0's Image.ID, in order, and the outcome class of each plugin's
# minimal file: decoded; refused (PIL identifies it, then has no handler
# or decoder here); or the ROADMAP item that ports it
PLUGINS = {
    "BMP": "decoded", "DIB": "decoded", "GIF": "decoded", "JPEG": "decoded",
    "PPM": "decoded", "PNG": "decoded", "AVIF": "7e.8", "BLP": "decoded",
    "BUFR": "refused", "CUR": "decoded", "PCX": "decoded", "DCX": "decoded",
    "DDS": "decoded", "EPS": "refused", "FITS": "decoded", "FLI": "decoded",
    "FTEX": "decoded", "GBR": "decoded", "GRIB": "refused", "HDF5": "refused",
    "JPEG2000": "decoded", "ICNS": "decoded", "ICO": "decoded", "IM": "decoded",
    "IMT": "decoded", "IPTC": "decoded", "MCIDAS": "decoded",
    "MPEG": "refused", "TIFF": "decoded", "MSP": "decoded", "PCD": "decoded",
    "PIXAR": "decoded", "PSD": "decoded", "QOI": "decoded", "SGI": "decoded",
    "SPIDER": "decoded", "SUN": "decoded", "TGA": "decoded",
    "WEBP": "decoded", "WMF": "refused", "XBM": "decoded", "XPM": "decoded",
    "XVTHUMB": "decoded"}


def test_plugin_order_is_pils():
    """The port walks PIL's plugins in the order of PIL 12.1.0's Image.ID
    (the six of preinit first)."""
    Image.init()
    assert list(Image.ID) == list(PLUGINS)
    assert [f for f, _, _ in pilread._PLUGINS] == list(Image.ID)


@pytest.mark.parametrize("fmt", list(PLUGINS))
def test_every_plugin_has_its_outcome(tmp_path, fmt):
    """A small file each plugin of Image.ID identifies: decoded bit for bit
    where the port decodes the format, refused (ValueError) where PIL
    raises at open or convert, NotImplementedError naming the ROADMAP item
    where PIL decodes a format still to port."""
    data = _minimal(fmt)
    with Image.open(io.BytesIO(data)) as im:
        assert im.format.upper() == fmt
    p = tmp_path / "x.img"
    p.write_bytes(data)
    want = PLUGINS[fmt]
    if want == "decoded":
        _assert_same(tmp_path, data, decodes=True, name="x.img")
    elif want == "refused":
        _assert_same(tmp_path, data, decodes=False, name="x.img")
    else:
        assert _pil(str(p)) is not None
        with pytest.raises(NotImplementedError,
                           match=want.replace(".", r"\.")):
            tio.read_image(str(p))


@pytest.mark.parametrize("data", [
    b"", bytes(300), b"hello, world\n" * 20, b"%PDF-1.4\n" + bytes(200),
    bytes(range(256)) * 3, b"\n" * 80, b"#?RADIANCE\n" + bytes(40),
    struct.pack("<ii", 20000630, 2) + bytes(40), b"P7 4 4\n", b"qoif",
    b"\0\0\1\0\0\0" + bytes(40), b"icns" + bytes(4), b"8BPS\0\1" + bytes(40),
    b"DDS " + struct.pack("<I", 124) + bytes(200)],
    ids=["empty", "zeros", "text", "pdf", "ramp", "newlines", "radiance",
         "openexr", "pam", "qoi_magic", "ico_no_entries", "icns_empty",
         "psd_cut", "dds_cut"])
def test_unidentified_content_is_refused(tmp_path, data):
    """Content no plugin identifies, or identifies and refuses: ValueError
    (the scene's slot takes its default, as in the JAX package), never
    NotImplementedError (ROADMAP C24)."""
    _assert_same(tmp_path, data, decodes=False, name="x.png")


@pytest.mark.parametrize("kind", ["empty_png", "text_jpg"])
def test_unreadable_image_in_a_scene_loads_as_jax(tmp_path, kind):
    """C24: `tex_wall_cbox` with an empty .png, or a text file named .jpg,
    on its back wall loads in the port as the JAX Scene loads it (the
    slot's default, with a warning): the same arrays."""
    from tests.test_torch_scene import _assert_same_scene
    from tests.torch_parity import jax_scene_arrays
    from tests.torch_scenes import tex_wall_cbox
    from vision_tpu.scene.scene import Scene as JScene
    import vision_tpu_torch as vt
    p = tmp_path / ("wall.png" if kind == "empty_png" else "wall.jpg")
    p.write_bytes(b"" if kind == "empty_png" else b"not an image\n" * 9)
    s = tex_wall_cbox(16, str(p))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ps = vt.load_scene(s, device="cpu")
        ref = jax_scene_arrays(JScene(s))
    _assert_same_scene(ps.data, ps.camera, ps.filter, ref)


# ---------------------------------------------------------------------------
# the formats, from seeds at odd sizes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["RGB", "L", "1", "I;16", "I", "F"])
def test_pnm_written_by_pil(tmp_path, mode):
    """PIL's own PBM / PGM / PPM (16-bit PGM for I;16 and I) and PFM."""
    g = np.random.default_rng(len(mode))
    for h, w in SIZES:
        a = _image(g, h, w)
        im = Image.fromarray(g.integers(0, 65536, (h, w)).astype(np.uint16)) \
            if mode == "I;16" else Image.fromarray(a).convert(mode)
        _assert_same(tmp_path, _save(im, "PPM"), decodes=True)


def _pnm(g, magic, w, h, maxval, sep=b"\n"):
    bands = 3 if magic in (b"P3", b"P6") else 1
    if magic in (b"P1", b"P4"):
        v = g.integers(0, 2, (h, w))
        body = b" ".join(b"%d" % x for x in v.ravel()) if magic == b"P1" \
            else np.packbits(v, axis=1).tobytes()
        return magic + sep + b"# c\n%d %d\n" % (w, h) + body
    v = g.integers(0, maxval + 1, (h, w, bands))
    if magic in (b"P2", b"P3"):
        body = b"\n".join(b" ".join(b"%d" % x for x in r.ravel()) for r in v)
    else:
        body = v.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
    return magic + sep + b"%d %d#x\n %d\n" % (w, h, maxval) + body


@pytest.mark.parametrize("magic", [b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"],
                         ids=lambda m: m.decode())
@pytest.mark.parametrize("maxval", [1, 7, 255, 256, 1000, 65535])
def test_pnm_any_maxval(tmp_path, magic, maxval):
    """Plain and binary PNM at any maxval, comments inside tokens: PIL's
    rules (samples scaled by round(v / maxval * 255), 16-bit grey to I)."""
    g = np.random.default_rng(maxval)
    for h, w in ((3, 5), (4, 9)):
        _assert_same(tmp_path, _pnm(g, magic, w, h, maxval))


@pytest.mark.parametrize("data, decodes", [
    (b"P2 2 2 3\n1 2 3#c\n4\n", False), (b"P2 2 2 3\n1 2 3 5\n", False),
    (b"P1 3 1\n012", False), (b"P1 3 1\n0 1 0 1", True),
    (b"P1 3 1\n01", False), (b"P5 3 2 70000\n" + bytes(6), False),
    (b"P5\n3 2\n255\n" + bytes(5), False),
    (b"P5 12345678901 2 255\n", False), (b"P6 0 2 255\n", False),
    (b"P512345 3 2 255\n", False),
    (b"P0CMYK 3 2 255\n" + bytes(range(24)), True),
    (b"PyRGBA 2 2 255\n" + bytes(range(16)), True),
    (b"PyCMYK 2 2 255\n" + bytes(range(16)), True),
    (b"PyP 3 2 255\n" + bytes(6), True),
    (b"Pf 2 2 -1.0\n" + np.float32([1, 300, -4, np.nan]).tobytes(), True),
    (b"Pf 2 2 0\n" + bytes(16), False), (b"Pf 2 2 inf\n" + bytes(16), False),
    (b"PF 2 2 -1.0\n" + bytes(48), False)])
def test_pnm_crafted(tmp_path, data, decodes):
    """PIL's PPM plugin's rules where OpenCV's (cvread) differ: a comment
    joining two samples, a sample past maxval, plain PBM without spaces,
    PIL's own P0CMYK / Py* types, PFM grey only, scale 0 or infinite."""
    _assert_same(tmp_path, data, decodes=decodes)


SUN_CASES = [(d, t, c) for d in (1, 4, 8, 24, 32) for t in (0, 1, 2, 3, 5, 6)
             for c in (False, True)]


@pytest.mark.parametrize("depth, typ, cmap", SUN_CASES,
                         ids=lambda v: str(v))
def test_sun_raster(tmp_path, depth, typ, cmap):
    """Sun raster by PIL's rules: raw rows padded to 16 bits, run-length
    (type 2) rows not padded, runs across rows; BGR, or RGB for type 3; a
    colour map on 4 or 8 bits (refused on others); type 6 passed on."""
    g = np.random.default_rng(depth * 10 + typ)
    h, w = 5, 7
    line = (w * depth + 7) // 8
    if typ == 2:
        raw = bytes(_image(g, h, line, 1).ravel())
        body = b"\x80\x00" + b"".join(
            bytes((0x80, 5, b)) if i % 3 == 0 else bytes((b,))
            for i, b in enumerate(raw))
    else:
        body = g.integers(0, 256, h * ((w * depth + 15) // 16) * 2,
                          np.uint8).tobytes()
    pal = g.integers(0, 256, 3 * 16, np.uint8).tobytes() if cmap else b""
    data = gp.sun_bytes(w, h, depth, body, typ, pal)
    _assert_same(tmp_path, data)
    _assert_same(tmp_path, data[:-3])


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "L", "1"])
def test_dib(tmp_path, mode):
    """DIB (a BMP without its file header), as PIL writes it."""
    g = np.random.default_rng(len(mode))
    for h, w in SIZES:
        im = Image.fromarray(_image(g, h, w, 4)).convert(mode)
        _assert_same(tmp_path, _save(im, "DIB"), decodes=True)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "L", "1"])
@pytest.mark.parametrize("inner", ["png", "bmp"])
def test_ico(tmp_path, mode, inner):
    """Icons as PIL writes them (PNG or BMP inside, AND masks), one entry
    and several: the largest entry decoded."""
    g = np.random.default_rng(len(mode) + len(inner))
    kw = {} if inner == "png" else {"bitmap_format": "bmp"}
    for h, w in ((5, 7), (16, 16), (33, 20)):
        im = Image.fromarray(_image(g, h, w, 4)).convert(mode)
        _assert_same(tmp_path, _save(im, "ICO", sizes=[(w, h)], **kw),
                     decodes=True)
    im = Image.fromarray(_image(g, 48, 48, 4)).convert(mode)
    _assert_same(tmp_path, _save(im, "ICO", sizes=[(16, 16), (32, 32),
                                                   (48, 48)], **kw))


@pytest.mark.parametrize("mode", ["RGB", "P", "1", "RGBA"])
def test_cur(tmp_path, mode):
    """Cursors (an icon of type 2, a BMP inside): its entry, its upper
    half."""
    g = np.random.default_rng(len(mode))
    for h, w in ((6, 10), (20, 12)):
        _assert_same(tmp_path, gp.cur_bytes(_image(g, h, w, 4), mode),
                     decodes=True)


@pytest.mark.parametrize("size", [16, 32, 64, 128, 256, 512])
def test_icns_written_by_pil(tmp_path, size):
    """ICNS as PIL writes it (PNG resources): the largest size."""
    g = np.random.default_rng(size)
    im = Image.fromarray(_image(g, size, size, 4))
    _assert_same(tmp_path, _save(im, "ICNS"), decodes=True)


@pytest.mark.parametrize("case", ["is32", "is32_mask", "is32_rle", "il32",
                                  "it32", "it32_bad_sig", "mask_only",
                                  "rle_short", "mask_short"])
def test_icns_packed(tmp_path, case):
    """Packed RGB resources (raw or run-length coded planes), masks, and
    what PIL refuses (a bad it32 signature, a mask alone, short data)."""
    g = np.random.default_rng(len(case))
    px = g.integers(0, 256, (16 * 16, 3), np.uint8)
    px[:40] = px[0]
    rle = b"".join(gp.icns_rle(px[:, c].tobytes()) for c in range(3))
    res = {"is32": [(b"is32", px.tobytes())],
           "is32_mask": [(b"is32", px.tobytes()), (b"s8mk", bytes(256))],
           "is32_rle": [(b"is32", rle), (b"s8mk", bytes(256))],
           "il32": [(b"il32", g.integers(0, 256, 32 * 32 * 3,
                                         np.uint8).tobytes())],
           "it32": [(b"it32", bytes(4) + g.integers(
               0, 256, 128 * 128 * 3, np.uint8).tobytes())],
           "it32_bad_sig": [(b"it32", b"\0\0\0\1" + bytes(10))],
           "mask_only": [(b"s8mk", bytes(256))],
           "rle_short": [(b"is32", rle[:-5])],
           "mask_short": [(b"is32", px.tobytes()), (b"s8mk", bytes(100))]}
    _assert_same(tmp_path, gp.icns_bytes(res[case]))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_qoi(tmp_path, mode):
    """QOI as PIL writes it: every operation (index, diff, luma, run, RGB,
    RGBA); cut files refused."""
    g = np.random.default_rng(len(mode))
    for h, w in SIZES + ((40, 33),):
        a = _image(g, h, w, 4)
        a[h // 2:, :, 3] = 255
        a[1::3] = a[0]
        if w > 2:                              # QOI_OP_DIFF / LUMA steps
            a[:, 2] = np.clip(a[:, 1].astype(int) + 1, 0, 255)
        data = _save(Image.fromarray(a).convert(mode), "QOI")
        _assert_same(tmp_path, data, decodes=True)
        _assert_same(tmp_path, data[:-12])


@pytest.mark.parametrize("mode", ["RGB", "L", "P", "1"])
def test_pcx_written_by_pil(tmp_path, mode):
    """PCX as PIL writes it (24-bit planes, 8-bit grey and palette, 1
    bit); PIL refuses some of its own (an 8-bit file shorter than the
    palette it looks for at the end): the port refuses the same ones."""
    g = np.random.default_rng(len(mode))
    for h, w in SIZES + ((8, 3),):
        data = _save(Image.fromarray(_image(g, h, w)).convert(mode), "PCX")
        _assert_same(tmp_path, data)


@pytest.mark.parametrize("bits, planes", [(1, 1), (1, 2), (1, 4), (8, 1),
                                          (8, 3)])
@pytest.mark.parametrize("stride", ["even", "exact"])
def test_pcx_planes(tmp_path, bits, planes, stride):
    """PCX at every depth and plane count PIL reads, at widths 1-19, with
    an even or an exact line stride: PcxDecode.c's plane moves and line
    strides included."""
    g = np.random.default_rng(bits * 10 + planes + len(stride))
    for w in range(1, 20):
        v = g.integers(0, 256, (3, w, 3), np.uint8) if planes == 3 else \
            g.integers(0, 1 << (bits * planes), (3, w), np.uint8)
        line = (w * bits + 7) // 8
        data = gp.pcx_bytes(v, bits, planes, g.integers(
            0, 256, 48, np.uint8).tobytes(), stride=line if stride == "exact"
            else None, palette256=g.integers(0, 256, 768, np.uint8).tobytes()
            if bits == 8 and planes == 1 else None)
        _assert_same(tmp_path, data + (bytes(800) if bits == 8 else b""))


def test_pcx_refusals(tmp_path):
    """What PIL refuses: 8 bits in version 3, an 8-bit file shorter than
    its palette, a run across a line's end, 2 or 4 bits a plane."""
    v = np.arange(21, dtype=np.uint8).reshape(3, 7)
    _assert_same(tmp_path, gp.pcx_bytes(v, 8, 1, version=3) + bytes(800),
                 decodes=False)
    _assert_same(tmp_path, gp.pcx_bytes(v, 8, 1), decodes=False)
    d = bytearray(gp.pcx_bytes(np.zeros((2, 8), np.uint8), 8, 1) + bytes(800))
    d[128] = 0xC0 | 12                         # a run of 12 in a line of 8
    _assert_same(tmp_path, bytes(d), decodes=False)
    for bits in (2, 4):
        d = bytearray(gp.pcx_bytes(v, 8, 1) + bytes(800))
        d[3] = bits
        _assert_same(tmp_path, bytes(d), decodes=False)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
@pytest.mark.parametrize("bpc", [1, 2])
def test_sgi_written_by_pil(tmp_path, mode, bpc):
    """SGI as PIL writes it (raw, 8 or 16 bits a sample)."""
    g = np.random.default_rng(len(mode) * bpc)
    for h, w in SIZES:
        data = _save(Image.fromarray(_image(g, h, w, 4)).convert(mode), "SGI",
                     bpc=bpc)
        _assert_same(tmp_path, data, decodes=True)


@pytest.mark.parametrize("z", [1, 2, 3, 4])
@pytest.mark.parametrize("bpc", [1, 2])
def test_sgi_rle(tmp_path, z, bpc):
    """Run-length SGI (PIL writes none), 8 and 16 bits, 1-4 channels (PIL
    has no 2-channel mode: refused); cut tables and rows refused."""
    g = np.random.default_rng(z * 10 + bpc)
    for h, w in SIZES:
        img = g.integers(0, 256 if bpc == 1 else 65536, (h, w, z))
        img[:, :w // 2] = img[:, :1]
        data = gp.sgi_bytes(img.astype(np.uint8 if bpc == 1 else np.uint16),
                            bpc)
        _assert_same(tmp_path, data, decodes=z != 2)
        _assert_same(tmp_path, data[:-2])


def test_sgi_rle_quirks(tmp_path):
    """SgiRleDecode.c's rules: a row shorter than the image keeps the row
    buffer's earlier samples; a row table pointing before the tables or a
    run past the row is refused; a count-1 row with a non-zero atom ends
    the image there."""
    img = np.arange(5 * 7, dtype=np.uint8).reshape(5, 7, 1)
    data = bytearray(gp.sgi_bytes(img))
    tab = 512
    start = struct.unpack_from(">I", data, tab)[0]
    short = bytearray(data)
    short[start] = 0x82                         # copy 2, then its data ...
    short[start + 3] = 0                        # ... and end the row there
    _assert_same(tmp_path, bytes(short))
    for off, value in ((tab, 0), (tab + 3, 1), (start, 0x7F)):
        d = bytearray(data)
        d[off] = value
        _assert_same(tmp_path, bytes(d))
    d = bytearray(data)
    struct.pack_into(">I", d, tab + 4 * 5, 1)   # row 0's length 1
    _assert_same(tmp_path, bytes(d))


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "PA", "RGB", "RGBA",
                                  "RGBX", "CMYK", "I", "F", "I;16", "I;16B",
                                  "YCbCr"])
def test_im_written_by_pil(tmp_path, mode):
    """IM as PIL writes it, every mode it writes (YCbCr through PIL's
    YCbCr -> RGB): planar layouts, the Lut as a palette, bottom-up rows."""
    g = np.random.default_rng(len(mode))
    for h, w in SIZES:
        a = _image(g, h, w, 4)
        if mode == "PA":
            im = Image.fromarray(a).convert("P").convert("PA")
        elif mode in ("I;16", "I;16B"):
            im = Image.fromarray(g.integers(0, 65536, (h, w)).astype(
                np.uint16)).convert(mode) if mode == "I;16" else \
                Image.frombytes("I;16B", (w, h), g.integers(
                    0, 256, 2 * w * h, np.uint8).tobytes())
        elif mode == "F":
            f = g.normal(100, 150, (h, w)).astype(np.float32)
            f.flat[0] = np.nan
            im = Image.fromarray(f, "F")
        else:
            im = Image.fromarray(a).convert(mode)
        data = _save(im, "IM")
        _assert_same(tmp_path, data, decodes=True)
        _assert_same(tmp_path, data[:-1])


IM_HEADERS = [b"L 8 image", b"L 8S image", b"L 16S image", b"L 32 image",
              b"L 16B image", b"X 24 image", b"L 32 S image", b"B2 image",
              b"B4 image", b"Foo image", b"RGB image"]


@pytest.mark.parametrize("itype", IM_HEADERS, ids=lambda t: t.decode())
@pytest.mark.parametrize("lut", [None, "grey", "ramp", "colour"])
def test_im_headers(tmp_path, itype, lut):
    """Hand-made IM headers: the numeric types, 2- and 4-bit palettes,
    unknown types (refused); a Lut that is grey but not the ramp (kept as
    L), the ramp, or colours (P)."""
    g = np.random.default_rng(len(itype) + len(str(lut)))
    head = b"Image type: " + itype + b"\r\nImage size (x*y): 7*3\r\n"
    if lut:
        head += b"Lut: 1\r\n"
    data = head.ljust(511, b"\0") + b"\x1a"
    if lut:
        p = {"grey": np.repeat(g.integers(0, 256, (1, 256), np.uint8), 3, 0),
             "ramp": np.repeat(np.arange(256, dtype=np.uint8)[None], 3, 0),
             "colour": g.integers(0, 256, (3, 256), np.uint8)}[lut]
        data += p.tobytes()
    _assert_same(tmp_path, data + g.integers(0, 256, 200, np.uint8).tobytes())


@pytest.mark.parametrize("head", [b"Name: x\r\n", b"Image size (x*y): 3\r\n",
                                  b"Image size (x*y): 3.5*2\r\n",
                                  b"Image size (x*y): 3*2*1\r\n",
                                  b"Image size (x*y): x*2\r\n",
                                  b"Image type: \r\n", b"Bad line\r\n",
                                  b"Image type: L*12 image\r\n"])
def test_im_header_refusals(tmp_path, head):
    """IM headers PIL passes on or refuses: no size or a scalar size,
    non-integer sizes, a number that is none, no type, a line without a
    key, a 12-bit type (PIL's bit decoder, here without its pixels, so
    refused)."""
    data = (b"Image type: L 8 image\r\n" + head).ljust(511, b"\0") + b"\x1a"
    _assert_same(tmp_path, data + bytes(40), decodes=False)


IM_LEFTOVERS = [f"L*{n} image" for n in (2, 3, 4, 5, 7, 9, 12, 15, 17, 24,
                                          25, 31)] + \
    ["RLB image", "RYB image", "RGB3 image", "RYB3 image", "YCC image"]


@pytest.mark.parametrize("itype", IM_LEFTOVERS)
def test_im_rare_types(tmp_path, itype):
    """The IM types PIL reads through its bit decoder (N-bit samples, the
    unused bits of a row's last byte ORed into the next row's first),
    the old three-plane RGB3 / RYB3 files (G, R, B planes), YCC (PIL's
    YCbCr -> RGB), and RLB / RYB (no raw mode in PIL: refused); random
    data at odd sizes, and cut one byte short."""
    g = np.random.default_rng(len(itype))
    head = f"Image type: {itype}\r\n".encode()
    for h, w in SIZES + ((4, 11),):
        data = (head + f"Image size (x*y): {w}*{h}\r\n".encode()).ljust(
            511, b"\0") + b"\x1a"
        n = int(itype[2:-6]) if itype.startswith("L*") else 8
        need = h * ((w * n + 7) // 8) if itype.startswith("L*") else 3 * w * h
        body = g.integers(0, 256, need, np.uint8).tobytes()
        decodes = not itype.startswith(("RLB", "RYB "))
        _assert_same(tmp_path, data + body, decodes=decodes)
        _assert_same(tmp_path, data + body[:-1], decodes=False)


def test_ycbcr_to_rgb_matches_pil():
    """PIL's YCbCr -> RGB (its integer tables, ConvertYCbCr.c) on a
    seeded share of the 2^24 triples and every corner of the cube."""
    g = np.random.default_rng(24)
    x = g.integers(0, 256, (1 << 16, 3), np.uint8)
    corners = np.array(np.meshgrid(*[[0, 1, 127, 128, 129, 254, 255]] * 3)
                       ).reshape(3, -1).T.astype(np.uint8)
    x = np.concatenate([x, corners])
    want = np.asarray(Image.frombytes("YCbCr", (len(x), 1), x.tobytes())
                      .convert("RGB"))[0]
    np.testing.assert_array_equal(pilread._ycbcr_to_rgb(x), want)


@pytest.mark.parametrize("version", [1, 2])
def test_msp(tmp_path, version):
    """Windows Paint: version 1 raw (PIL writes it), version 2 run-length
    rows with empty rows (white); cut files refused."""
    g = np.random.default_rng(version)
    for h, w in SIZES + ((9, 24),):
        bits = g.random((h, w)) > 0.5
        bits[:, :w // 2] = True
        bits[0] = True
        data = _save(Image.fromarray(bits), "MSP") if version == 1 else \
            gp.msp_bytes(bits)
        _assert_same(tmp_path, data, decodes=True)
        _assert_same(tmp_path, data[:-1])


def test_xbm(tmp_path):
    """X11 bitmaps as PIL writes them, with a hot spot, upper-case hex,
    odd separators, cut short."""
    g = np.random.default_rng(7)
    for h, w in SIZES + ((9, 24),):
        bits = Image.fromarray(g.random((h, w)) > 0.5)
        data = _save(bits, "XBM")
        _assert_same(tmp_path, data, decodes=True)
        _assert_same(tmp_path, _save(bits, "XBM", hotspot=(1, 2)))
        _assert_same(tmp_path, data.replace(b"0x", b"0X"))
        _assert_same(tmp_path, data.replace(b",", b"x"))
        _assert_same(tmp_path, data[:-8])


@pytest.mark.parametrize("ncol, bpp", [(2, 1), (16, 1), (256, 2), (300, 2)])
def test_xpm(tmp_path, ncol, bpp):
    """X11 pixmaps (PIL writes none): palettes up to 256 colours (P) and
    beyond (RGB), 1 and 2 characters a pixel; cut short."""
    g = np.random.default_rng(ncol)
    cols = [int(c) for c in g.integers(0, 1 << 24, ncol)]
    for h, w in SIZES:
        data = gp.xpm_bytes(g.integers(0, ncol, (h, w)), cols, bpp)
        _assert_same(tmp_path, data, decodes=True)
        _assert_same(tmp_path, data[:-(w * bpp + 4)])


def test_xpm_transparent(tmp_path):
    """A `c None` colour is no palette entry: unused it shifts nothing
    PIL reads; used it is refused."""
    cols = [0x102030, None, 0xFFFFFF]
    _assert_same(tmp_path, gp.xpm_bytes(np.array([[0, 2], [2, 0]]), cols),
                 decodes=True)
    _assert_same(tmp_path, gp.xpm_bytes(np.array([[0, 1], [2, 0]]), cols),
                 decodes=False)


def test_spider(tmp_path):
    """SPIDER as PIL writes it (float32 through F -> L -> RGB: truncated,
    clipped, NaN 0), big-endian headers read first."""
    g = np.random.default_rng(8)
    for h, w in SIZES:
        f = g.normal(120, 120, (h, w)).astype(np.float32)
        f.flat[0] = np.nan
        data = _save(Image.fromarray(f, "F"), "SPIDER")
        _assert_same(tmp_path, data, decodes=True)
        _assert_same(tmp_path, data[:-1])


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_dds_uncompressed_written_by_pil(tmp_path, mode):
    g = np.random.default_rng(len(mode))
    for h, w in SIZES:
        _assert_same(tmp_path, _save(Image.fromarray(_image(g, h, w, 4))
                                     .convert(mode), "DDS"), decodes=True)


@pytest.mark.parametrize("fmt", ["DXT1", "DXT3", "DXT5", "BC2", "BC3", "BC5"])
def test_dds_bcn_written_by_pil(tmp_path, fmt):
    g = np.random.default_rng(len(fmt))
    for h, w in SIZES + ((16, 16),):
        im = Image.fromarray(_image(g, h, w, 4)).convert(
            "RGB" if fmt == "BC5" else "RGBA")
        data = _save(im, "DDS", pixel_format=fmt)
        _assert_same(tmp_path, data, decodes=True)
        _assert_same(tmp_path, data[:-1])


@pytest.mark.parametrize("fourcc", [b"DXT1", b"DXT3", b"DXT5", b"BC4U",
                                    b"ATI1", b"BC5U", b"ATI2", b"BC5S",
                                    b"DXT2", b"BC4S"],
                         ids=lambda f: f.decode())
def test_dds_random_blocks_fourcc(tmp_path, fourcc):
    """Random blocks under each four-character code PIL reads (BC1-BC5,
    signed BC5), and two it does not (refused)."""
    g = np.random.default_rng(sum(fourcc))
    size = 8 if fourcc in (b"DXT1", b"BC4U", b"ATI1", b"BC4S") else 16
    for h, w in SIZES:
        n = ((w + 3) // 4) * ((h + 3) // 4)
        _assert_same(tmp_path, gp.dds_bytes(
            w, h, 4, g.integers(0, 256, n * size, np.uint8).tobytes(), fourcc))


@pytest.mark.parametrize("dxgi", [70, 71, 72, 73, 74, 76, 77, 79, 80, 82, 83,
                                  84, 95, 96, 97, 98, 99, 28, 29, 87])
def test_dds_random_blocks_dx10(tmp_path, dxgi):
    """Random blocks under each DXGI format of a DX10 header PIL reads (and
    the sRGB BC1 / BC2 / BC3 and B8G8R8A8 it refuses)."""
    g = np.random.default_rng(dxgi)
    for h, w in SIZES:
        n = ((w + 3) // 4) * ((h + 3) // 4)
        size = 8 if dxgi in (70, 71, 72, 79, 80) else 16
        body = g.integers(0, 256, w * h * 4 if dxgi in (28, 29, 87)
                          else n * size, np.uint8).tobytes()
        data = gp.dds_dx10(w, h, dxgi, body)
        _assert_same(tmp_path, data)
        _assert_same(tmp_path, data[:-1])


@pytest.mark.parametrize("bitcount, masks", [
    (16, (0xF800, 0x7E0, 0x1F, 0)), (16, (0x7C00, 0x3E0, 0x1F, 0x8000)),
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    (24, (0xFF, 0xFF00, 0xFF0000, 0)),
    (32, (0x3FF, 0xFFC00, 0x3FF00000, 0)), (8, (0xE0, 0x1C, 0x3, 0)),
    (16, (0xF00, 0xF0, 0xF, 0xF000)), (32, (0, 0xFF00, 0xFF, 0)),
    (0, (0xFF, 0xFF00, 0xFF0000, 0))])
def test_dds_bit_masks(tmp_path, bitcount, masks):
    """Uncompressed pixels through bit masks (DdsRgbDecoder: each mask
    scaled to 8 bits as int(v / max * 255)); a file cut short reads zeros
    past its end, as PIL reads it."""
    g = np.random.default_rng(bitcount + masks[0])
    for flags in (0x40, 0x41):
        h, w = 5, 7
        data = gp.dds_bytes(w, h, flags, g.integers(
            0, 256, w * h * max(bitcount, 8) // 8, np.uint8).tobytes(),
            bitcount=bitcount, masks=masks)
        _assert_same(tmp_path, data, decodes=True)
        _assert_same(tmp_path, data[:-3])


def test_dds_palette_and_luminance(tmp_path):
    g = np.random.default_rng(9)
    h, w = 5, 7
    for flags, bc, body in ((0x20, 8, g.integers(0, 256, 1024 + w * h,
                                                 np.uint8).tobytes()),
                            (0x20, 8, bytes(100)), (0x20000, 8, bytes(35)),
                            (0x20001, 16, bytes(range(70))),
                            (0x20000, 16, bytes(70)), (0, 16, bytes(70))):
        _assert_same(tmp_path, gp.dds_bytes(w, h, flags, body, bitcount=bc))


MODES_BC7 = list(range(9))                  # mode 8: no mode bit


@pytest.mark.parametrize("mode", MODES_BC7)
def test_bc7_blocks_match_pil(mode):
    """Random BC7 blocks of each mode (and of none), decoded by
    `csrc/image_codecs.cpp` as PIL decodes them (through a DX10 DDS)."""
    g = np.random.default_rng(70 + mode)
    blocks = g.integers(0, 256, (512, 16), np.uint8)
    blocks[:, 0] = 0 if mode == 8 else \
        (blocks[:, 0] & (0xFF ^ ((2 << mode) - 1))) | 1 << mode
    with Image.open(io.BytesIO(gp.dds_dx10(4 * 512, 4, 98,
                                           blocks.tobytes()))) as im:
        want = np.asarray(im.convert("RGBA"))
    want = want.reshape(4, 512, 4, 4).transpose(1, 0, 2, 3).reshape(512, 16, 4)
    np.testing.assert_array_equal(native.bc7_decode(blocks), want)


BC6_MODES = [0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23, 27, 31]


@pytest.mark.parametrize("signed", [False, True], ids=["uf16", "sf16"])
@pytest.mark.parametrize("mode", BC6_MODES)
def test_bc6h_blocks_match_pil(mode, signed):
    """Random BC6H blocks of each mode (the four reserved ones included),
    unsigned and signed, as PIL decodes them: each half clamped to
    [0, 1], times 255, truncated."""
    g = np.random.default_rng(mode + 100 * signed)
    blocks = g.integers(0, 256, (256, 16), np.uint8)
    keep = 0xFC if mode < 2 else 0xE0
    blocks[:, 0] = (blocks[:, 0] & keep) | mode
    with Image.open(io.BytesIO(gp.dds_dx10(4 * 256, 4, 96 if signed else 95,
                                           blocks.tobytes()))) as im:
        want = np.asarray(im.convert("RGB"))
    want = want.reshape(4, 256, 4, 3).transpose(1, 0, 2, 3).reshape(256, 16, 3)
    np.testing.assert_array_equal(native.bc6h_decode(blocks, signed), want)


PSD_MODES = [(0, 1, 1), (1, 8, 1), (2, 8, 1), (3, 8, 3), (3, 8, 4), (3, 8, 5),
             (4, 8, 4), (4, 8, 5), (7, 8, 2), (8, 8, 1), (1, 16, 1), (3, 8, 2)]


@pytest.mark.parametrize("pmode, bits, channels", PSD_MODES,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("comp", [0, 1], ids=["raw", "packbits"])
def test_psd(tmp_path, pmode, bits, channels, comp):
    """Photoshop's merged image in each mode PIL maps (bitmap, grey,
    indexed, RGB, RGBA, CMYK through PIL's CMYK -> RGB, multichannel,
    duotone), raw or PackBits, with resources; 16 bits and too few
    channels refused; cut short."""
    g = np.random.default_rng(pmode * 100 + channels * 10 + comp)
    h, w = 5, 9
    line = (w + 7) // 8 if bits == 1 else w
    planes = [g.integers(0, 256, (h, line), np.uint8) for _ in range(channels)]
    for p in planes:
        p[:, :4] = p[:, :1]
    cmd = g.integers(0, 256, 768, np.uint8).tobytes() if pmode == 2 else b""
    res = b"8BIM" + struct.pack(">HHI", 1005, 0, 3) + b"abc\0"
    data = gp.psd_bytes(pmode, bits, planes, w, h, comp, cmd, res)
    _assert_same(tmp_path, data)
    _assert_same(tmp_path, data[:-1])


def test_psd_lab_names_7e6a(tmp_path):
    """A Lab PSD, which PIL converts through LittleCMS (ImageCms, the Lab
    v2 identity profile to sRGB; slice 7e.6a's last item): decoded bit for
    bit, raw and PackBits (random planes at odd sizes); a cut file
    refused, as PIL refuses it."""
    g = np.random.default_rng(9)
    for comp in (0, 1):
        for h, w in SIZES + ((6, 17),):
            planes = [g.integers(0, 256, (h, w), np.uint8) for _ in range(3)]
            data = gp.psd_bytes(9, 8, planes, w, h, comp)
            _assert_same(tmp_path, data, decodes=True)
            _assert_same(tmp_path, data[:-1], decodes=False)


def test_lab_to_rgb_matches_littlecms():
    """PIL's LAB -> RGB (LittleCMS 2.17's optimised 8-bit transform) on a
    seeded share of the 2^24 triples and the cube's corners and middle
    values (PIL keeps a and b signed: LittleCMS reads them offset by
    128). `tools/gen_torch_lab.py --check` holds all 2^24."""
    g = np.random.default_rng(17)
    x = g.integers(0, 256, (1 << 16, 3), np.uint8)
    corners = np.array(np.meshgrid(*[[0, 1, 127, 128, 129, 254, 255]] * 3)
                       ).reshape(3, -1).T.astype(np.uint8)
    x = np.concatenate([x, corners])
    want = np.asarray(Image.frombytes("LAB", (len(x), 1), x.tobytes())
                      .convert("RGB"))[0]
    got = pilread.lab_to_rgb(x ^ np.array([0, 128, 128], np.uint8))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# header edits: refused exactly where PIL raises
# ---------------------------------------------------------------------------

def _seed_files(g):
    """name -> (bytes, the header's length) of one file a format."""
    rgb = Image.fromarray(_image(g, 6, 9, 4))
    a = np.asarray(rgb)
    return {
        "ppm": (_save(rgb.convert("RGB"), "PPM"), 12),
        "pgm16": (_save(Image.fromarray(g.integers(0, 65536, (6, 9)).astype(
            np.uint16)), "PPM"), 14),
        "sun": (gp.sun_bytes(9, 6, 8, bytes(range(6 * 10)), cmap=bytes(
            range(48))), 80),
        "dib": (_save(rgb.convert("P"), "DIB"), 40),
        "ico_png": (_save(rgb, "ICO", sizes=[(9, 6)]), 22),
        "ico_bmp": (_save(rgb, "ICO", sizes=[(9, 6)],
                          bitmap_format="bmp"), 62),
        "cur": (gp.cur_bytes(a, "RGB"), 62),
        "icns": (gp.icns_bytes([(b"is32", bytes(range(256)) * 3),
                                (b"s8mk", bytes(256))]), 24),
        "qoi": (_save(rgb, "QOI"), 14),
        "pcx": (_save(rgb.convert("RGB"), "PCX"), 128),
        "pcx_p": (_save(rgb.convert("P"), "PCX"), 128),
        "dcx": (struct.pack("<III", 987654321, 16, 0) + bytes(4) + _save(
            rgb.convert("P"), "PCX"), 144),
        "sgi": (_save(rgb.convert("RGB"), "SGI"), 16),
        "sgi_rle": (gp.sgi_bytes(a[..., :3]), 512 + 8 * 18),
        "im": (_save(rgb.convert("P"), "IM"), 512),
        "msp": (gp.msp_bytes(a[..., 0] > 128), 44),
        "xbm": (_save(rgb.convert("1"), "XBM"), 60),
        "xpm": (gp.xpm_bytes(np.arange(54).reshape(6, 9) % 5,
                             [1, 2, 3, 4, 5]), 120),
        "spider": (_save(rgb.convert("F"), "SPIDER"), 108),
        "dds": (_save(rgb, "DDS"), 128),
        "dds_dxt5": (_save(rgb, "DDS", pixel_format="DXT5"), 128),
        "dds_bc7": (gp.dds_dx10(8, 8, 98, bytes(range(64))), 148),
        "psd": (gp.psd_bytes(3, 8, [a[..., c].copy() for c in range(3)], 9, 6,
                             1), 50)}


@pytest.mark.parametrize("fmt", sorted(_seed_files(np.random.default_rng(0))))
def test_header_edits_match_pil(tmp_path, fmt):
    """Single bytes of each format's header set to 0, 1 or 255, or
    flipped, from a seed: the port decodes each edited file as PIL does,
    or refuses it (ValueError) where PIL raises; never NotImplementedError."""
    g = np.random.default_rng(sum(map(ord, fmt)))
    data, head = _seed_files(np.random.default_rng(0))[fmt]
    for d in _edits(g, data, 24, 0, head):
        _assert_same(tmp_path, d)


# ---------------------------------------------------------------------------
# the committed files, load_image, the twins
# ---------------------------------------------------------------------------

DECODES = np.load(os.path.join(ASSETS, "pil_decodes.npz"))
FILES = sorted(k for k in DECODES.files if ":" not in k)


@pytest.mark.parametrize("fn", FILES)
def test_committed_files_match_their_pil_decodes(fn):
    """Each file of `tools/gen_torch_pil.py` decodes to PIL's stored
    decode."""
    got, kind = tio.read_image(os.path.join(ASSETS, fn))
    assert kind == "ldr"
    np.testing.assert_array_equal(got, DECODES[fn])


def test_bc7_timing_file():
    """The 2048 x 2048 BC7 file built from its seed decodes to PIL's
    decode (its sha256 and corner)."""
    got = pilread.read(gp.bc7_timing(), "bc7_2048.dds")
    assert got.shape == (2048, 2048, 3)
    np.testing.assert_array_equal(got[:128, :128],
                                  DECODES["bc7_2048.dds:corner"])
    assert hashlib.sha256(got.tobytes()).digest() == \
        DECODES["bc7_2048.dds:sha256"].tobytes()


@pytest.mark.parametrize("fn", FILES[::3] + ["checker.qoi", "bumps.ppm",
                                             "checker_rle.sgi",
                                             "projector_bmp.ico",
                                             "checker_bc7.dds"])
@pytest.mark.parametrize("color_space", ["srgb", "linear"])
def test_load_image_matches_jax(fn, color_space):
    """`texture.load_image` of the committed files: the JAX package's
    (PIL's decode, linearised the same way), bit for bit."""
    p = os.path.join(ASSETS, fn)
    np.testing.assert_array_equal(ttex.load_image(p, color_space),
                                  jtex.load_image(p, color_space))


def test_twins_hold_their_pixels():
    """The twins hold the PNGs' pixels; checker_bc7_pil.png holds PIL's
    decode of checker_bc7.dds."""
    for a, b in (("checker.qoi", "checker.png"), ("bumps.ppm", "bumps.png"),
                 ("checker_rle.sgi", "checker.png"),
                 ("projector_bmp.ico", "projector.png"),
                 ("checker_bc7.dds", "checker_bc7_pil.png")):
        np.testing.assert_array_equal(
            tio.read_image(os.path.join(ASSETS, a))[0],
            tio.read_image(os.path.join(ASSETS, b))[0])


@pytest.mark.parametrize("name", ["cbox_tex_pil", "env_sphere_pil",
                                  "cbox_tex_dds"])
def test_twin_scenes_render_as_their_references(name):
    """`cbox_tex_pil` (QOI checker, PPM normal map) renders as `cbox_tex`,
    `env_sphere_pil` (run-length SGI checker, icon projector) as
    `env_sphere`, `cbox_tex_dds` (BC7 checker) as `cbox_tex_dds_ref`: the
    same atlas, the same render, bit for bit (64^2, 1 spp on the CPU)."""
    import torch
    import vision_tpu_torch as vt
    from tests import torch_scenes as ts
    ref, kw = {"cbox_tex_pil": (ts.cbox_tex, {}),
               "env_sphere_pil": (ts.env_sphere, dict(sub_div=8)),
               "cbox_tex_dds": (ts.cbox_tex_dds_ref, {})}[name]
    a = vt.load_scene(ref(64, **kw), device="cpu")
    b = vt.load_scene(getattr(ts, name)(64, **kw), device="cpu")
    assert torch.equal(a.data.atlas.data, b.data.atlas.data)
    assert torch.equal(vt.render(a, spp=1), vt.render(b, spp=1))
