"""The port's image files (`vision_tpu_torch/scene/imageio.py`,
`scene/texture.py`): the PNG decoder against PIL on files PIL writes (every
colour type and depth it decodes, each filter type, several IDAT chunks),
the Radiance .hdr decoder against OpenCV (run-length and flat scanlines),
`load_image` against the JAX package's (PIL / OpenCV) bit for bit, srgb and
linear, the atlas built from files, EXR (a round trip through
`film.to_exr`, and ZIP / ZIPS / HALF files built here against the arrays
they were written from: OpenCV here has no EXR codec) and a JPEG in a
scene (the decoder's own tests are in `tests/test_torch_jpeg.py`)."""
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_scenes import ASSETS, gen_assets
from vision_tpu.scene import texture as jtex
from vision_tpu_torch.scene import imageio as tio
from vision_tpu_torch.scene import texture as ttex
from vision_tpu_torch.sensor import film as tfilm


def _pil_rgb(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _rand(shape, seed):
    g = np.random.default_rng(seed)
    a = g.integers(0, 256, shape, dtype=np.uint8)
    a[: shape[0] // 2] = np.arange(shape[1], dtype=np.uint8).reshape(
        (1, -1) + (1,) * (len(shape) - 2))  # smooth rows: other filters
    return a


PIL_MODES = {"L": (13, 17), "RGB": (13, 17, 3), "LA": (13, 17, 2),
             "RGBA": (13, 17, 4)}


@pytest.mark.parametrize("mode", sorted(PIL_MODES))
@pytest.mark.parametrize("opts", ["default", "optimize", "level0"])
def test_png_matches_pil(tmp_path, mode, opts):
    """Grey, RGB, grey + alpha and RGBA at bit depth 8 as PIL writes them
    under its filter heuristics and compression levels."""
    p = tmp_path / "t.png"
    kw = {"default": {}, "optimize": {"optimize": True},
          "level0": {"compress_level": 0}}[opts]
    Image.fromarray(_rand(PIL_MODES[mode], 1), mode).save(p, **kw)
    got, kind = tio.read_image(str(p))
    assert kind == "ldr" and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pil_rgb(p))


def test_png_palette_matches_pil(tmp_path):
    p = tmp_path / "p.png"
    Image.fromarray(_rand((20, 30, 3), 2)).quantize(37).save(p)
    assert Image.open(p).mode == "P"
    np.testing.assert_array_equal(tio.read_image(str(p))[0], _pil_rgb(p))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_16_bit_matches_pil(tmp_path, channels):
    """16-bit RGB and RGBA (OpenCV writes them): PIL keeps each sample's
    high byte."""
    p = str(tmp_path / "t16.png")
    g = np.random.default_rng(channels)
    cv2.imwrite(p, g.integers(0, 65536, (11, 9, channels), dtype=np.uint16))
    assert struct.unpack(">B", open(p, "rb").read()[24:25])[0] == 16
    np.testing.assert_array_equal(tio.read_image(p)[0], _pil_rgb(p))


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_png(px, ctype, depth, filters, n_idat=3):
    """A PNG of px [H, W*bytes] whose row y takes filter
    filters[y % len(filters)], its IDAT data split into n_idat chunks."""
    h, stride = px.shape
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] * depth // 8
    rows, prev = [], np.zeros(stride, np.int64)
    for y in range(h):
        ft, r = filters[y % len(filters)], px[y].astype(np.int64)
        f = np.zeros(stride, np.int64)
        for x in range(stride):
            a = r[x - bpp] if x >= bpp else 0
            c = prev[x - bpp] if x >= bpp else 0
            f[x] = (r[x] - [0, a, prev[x], (a + prev[x]) // 2,
                            _paeth(a, prev[x], c)][ft]) % 256
        rows.append(bytes([ft]) + f.astype(np.uint8).tobytes())
        prev = r
    z = zlib.compress(b"".join(rows))
    cut = np.linspace(0, len(z), n_idat + 1).astype(int)
    w = stride // bpp
    return (tio.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                          0, 0, 0))
            + b"".join(_chunk(b"IDAT", z[a:b]) for a, b in zip(cut, cut[1:]))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_png_each_filter_matches_pil(tmp_path, filt):
    """Every row under one filter type (None, Sub, Up, Average, Paeth),
    RGB 8 and RGBA 16, the image data over three IDAT chunks."""
    g = np.random.default_rng(filt)
    for ctype, depth, ch in ((2, 8, 3), (6, 16, 8)):
        px = g.integers(0, 256, (10, 7 * ch), dtype=np.uint8)
        p = tmp_path / f"f{ctype}.png"
        p.write_bytes(_encode_png(px, ctype, depth, [filt]))
        np.testing.assert_array_equal(tio.read_image(str(p))[0], _pil_rgb(p))


def test_png_out_of_scope_raises(tmp_path):
    """A colour type at a bit depth PNG does not define raises ValueError,
    never a wrong image, as PIL refuses it. Interlaced (Adam7) files and
    bit depths below 8, out of scope before slice 7c, now decode as PIL
    decodes them (every variant: tests/test_torch_image_files.py)."""
    px = np.zeros((4, 12), np.uint8)
    data = _encode_png(px, 2, 8, [0])
    for depth, ctype in ((4, 2), (16, 3), (2, 4), (4, 6)):
        blob = data[:8] + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 4, 4, depth, ctype, 0, 0, 0)) + data[33:]
        p = tmp_path / f"{depth}_{ctype}.png"
        p.write_bytes(blob)
        with pytest.raises(ValueError, match="PIL refuses it too"):
            tio.read_png(blob)
        with pytest.raises(OSError):
            Image.open(p).convert("RGB")
    g = np.random.default_rng(3)
    for depth, ctype, interlace in ((8, 2, 1), (4, 0, 0), (4, 0, 1)):
        w = 4 if ctype == 2 else 7
        v = g.integers(0, 1 << depth, (5, w, 3 if ctype == 2 else 1))
        p = tmp_path / f"ok{depth}_{interlace}.png"
        p.write_bytes(gen_assets.png_bytes(v, depth, ctype, bool(interlace)))
        np.testing.assert_array_equal(tio.read_image(str(p))[0], _pil_rgb(p))


@pytest.mark.parametrize("width", [40, 5])
def test_hdr_matches_opencv(tmp_path, width):
    """OpenCV's .hdr: run-length scanlines at width 40, flat at width 5
    (below 8 the format has no run-length coding); zero and tiny values
    included. The port decodes m * 2^(e - 136) with no +0.5, as OpenCV."""
    g = np.random.default_rng(width)
    a = (g.random((7, width, 3)) * 10.0).astype(np.float32)
    a[0, 0] = 0.0
    a[1, 1] = 1e-30
    a[2, 2] = [0.3, 1.7, 5.0]
    p = str(tmp_path / "t.hdr")
    cv2.imwrite(p, a[..., ::-1])
    want = cv2.imread(p, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)[..., ::-1]
    got, kind = tio.read_image(p)
    assert kind == "hdr" and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2, 2], [0.28125, 1.6875, 5.0])


@pytest.mark.parametrize("color_space", ["srgb", "linear"])
def test_load_image_matches_jax(tmp_path, color_space):
    """`load_image` equals the JAX package's (PIL / OpenCV) bit for bit on
    PNG (grey, RGB, RGBA, palette), .hdr and the committed assets."""
    files = []
    for mode in ("L", "RGB", "RGBA"):
        p = tmp_path / f"{mode}.png"
        Image.fromarray(_rand(PIL_MODES[mode], 5), mode).save(p)
        files.append(str(p))
    p = tmp_path / "p.png"
    Image.fromarray(_rand((9, 11, 3), 6)).quantize(20).save(p)
    files.append(str(p))
    p = str(tmp_path / "t.hdr")
    cv2.imwrite(p, (np.random.default_rng(7).random((6, 12, 3)) * 3).astype(
        np.float32))
    files.append(p)
    files += [os.path.join(ASSETS, f) for f in sorted(os.listdir(ASSETS))
              if f.endswith((".png", ".hdr"))]
    for f in files:
        a = jtex.load_image(f, color_space)
        b = ttex.load_image(f, color_space)
        assert b.dtype == a.dtype == np.float32, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_atlas_from_files_matches_jax(tmp_path):
    """The atlas built from the same files (dedup by path and colour
    space) holds the JAX package's texels, offsets and sizes."""
    ja, ta = jtex.AtlasBuilder(), ttex.AtlasBuilder()
    for f, cs in (("checker.png", "srgb"), ("bumps.png", "linear"),
                  ("checker.png", "srgb"), ("sky_a.hdr", "linear"),
                  ("checker.png", "linear"), ("projector.png", "srgb")):
        p = os.path.join(ASSETS, f)
        assert ja.add_image(p, cs) == ta.add_image(p, cs)
    a, b = ja.build(), ta.build("cpu")
    for k in ("data", "offset", "width", "height"):
        np.testing.assert_array_equal(getattr(b, k).numpy(),
                                      np.asarray(getattr(a, k)))
    assert b.n_real == a.n_real == 5


def test_exr_round_trip(tmp_path):
    """`film.to_exr` writes FLOAT B, G, R, uncompressed, INCREASING_Y, with
    a valid offset table; the reader gives back the same floats."""
    img = np.random.default_rng(8).random((9, 13, 3)).astype(np.float32) * 5
    img[0, 0] = [0.0, 1e-8, 65504.5]
    p = str(tmp_path / "t.exr")
    tfilm.to_exr(img, p)
    np.testing.assert_array_equal(tio.read_image(p)[0], img)
    data = open(p, "rb").read()
    attrs, pos = tio._exr_header(data)
    assert [c for c, _ in tio._exr_channels(attrs["channels"][1])] == [
        "B", "G", "R"]
    assert attrs["compression"][1] == b"\0" and attrs["lineOrder"][1] == b"\0"
    offs = struct.unpack("<9Q", data[pos:pos + 72])
    assert [struct.unpack("<i", data[o:o + 4])[0] for o in offs] == list(
        range(9))


def _exr_zip_bytes(planes, names, ptype, comp, lines):
    """An OpenEXR file of the given planes compressed with ZIPS (1 line a
    block) or ZIP (16): the interleave, the predictor and zlib, as the
    OpenEXR library writes them."""
    h, w = planes[0].shape
    dt = {1: "<f2", 2: "<f4"}[ptype]
    chl = b"".join(n.encode() + b"\0" + struct.pack("<iB3xii", ptype, 0, 1, 1)
                   for n in names) + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    head = (struct.pack("<ii", tio.EXR_MAGIC, 2)
            + tio._attr("channels", "chlist", chl)
            + tio._attr("compression", "compression", bytes([comp]))
            + tio._attr("dataWindow", "box2i", box)
            + tio._attr("displayWindow", "box2i", box)
            + tio._attr("lineOrder", "lineOrder", b"\0") + b"\0")
    blocks = []
    for y0 in range(0, h, lines):
        raw = b"".join(p[y].astype(dt).tobytes() for y in range(
            y0, min(h, y0 + lines)) for p in planes)
        r = np.frombuffer(raw, np.uint8)
        t = np.concatenate([r[0::2], r[1::2]]).astype(np.int64)
        d = t.copy()
        d[1:] = (t[1:] - t[:-1] + 128) & 0xFF
        z = zlib.compress(d.astype(np.uint8).tobytes())
        if len(z) >= len(raw):  # stored raw where it does not compress
            z = raw
        blocks.append(struct.pack("<ii", y0, len(z)) + z)
    first = len(head) + 8 * len(blocks)
    offs, o = [], first
    for b in blocks:
        offs.append(o)
        o += len(b)
    return head + struct.pack(f"<{len(offs)}Q", *offs) + b"".join(blocks)


@pytest.mark.parametrize("comp, ptype, names", [
    (2, 2, ("B", "G", "R")), (3, 2, ("A", "B", "G", "R")),
    (3, 1, ("B", "G", "R")), (2, 1, ("Y",))])
def test_exr_zip_file(tmp_path, comp, ptype, names):
    """ZIPS and ZIP files, FLOAT and HALF, with A dropped and Y replicated,
    read back as the arrays they were written from."""
    g = np.random.default_rng(comp * 10 + ptype)
    h, w = 37, 11
    ramp = np.add.outer(np.arange(h), np.arange(w)) / 8.0
    planes = {n: (ramp * (i + 1) + (g.random((h, w)) < 0.1)).astype(
        np.float32) for i, n in enumerate(names)}
    if ptype == 1:
        planes = {n: v.astype(np.float16).astype(np.float32)
                  for n, v in planes.items()}
    p = tmp_path / "z.exr"
    p.write_bytes(_exr_zip_bytes([planes[n] for n in names], names, ptype,
                                 comp, {2: 1, 3: 16}[comp]))
    got = tio.read_image(str(p))[0]
    want = np.stack([planes["Y"]] * 3 if names == ("Y",) else
                    [planes[c] for c in "RGB"], -1)
    np.testing.assert_array_equal(got, want)


def test_jpeg_raises_naming_7b(tmp_path):
    """A JPEG image raised NotImplementedError naming slice 7b before the
    port had a decoder. A baseline JPEG now loads as the JAX package loads
    it through PIL, from `load_image` and from a scene's image slot; so
    does a progressive one (slice 7c) and a TIFF, which raised naming 7d
    before slice 7d."""
    p = tmp_path / "t.jpg"
    Image.fromarray(_rand((8, 8, 3), 9)).save(p)
    np.testing.assert_array_equal(ttex.load_image(str(p)),
                                  jtex.load_image(str(p)))
    import vision_tpu_torch as vt
    from tests.torch_parity import cbox
    s = cbox(8)
    s["materials"][0]["param"]["color"] = {"fn": str(p)}
    atlas = vt.load_scene(s, device="cpu").data.atlas
    np.testing.assert_array_equal(atlas.data.numpy()[:64, :3],
                                  jtex.load_image(str(p)).reshape(64, 3))
    Image.fromarray(_rand((8, 8, 3), 9)).save(p, progressive=True)
    np.testing.assert_array_equal(ttex.load_image(str(p)),
                                  jtex.load_image(str(p)))
    atlas = vt.load_scene(s, device="cpu").data.atlas
    np.testing.assert_array_equal(atlas.data.numpy()[:64, :3],
                                  jtex.load_image(str(p)).reshape(64, 3))
    t = tmp_path / "t.tif"
    Image.fromarray(_rand((8, 8, 3), 9)).save(t)
    s["materials"][0]["param"]["color"] = {"fn": str(t)}
    np.testing.assert_array_equal(ttex.load_image(str(t)),
                                  jtex.load_image(str(t)))
    atlas = vt.load_scene(s, device="cpu").data.atlas
    np.testing.assert_array_equal(atlas.data.numpy()[:64, :3],
                                  jtex.load_image(str(t)).reshape(64, 3))


def test_missing_file_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        ttex.load_image(str(tmp_path / "none.png"))


def test_imageio_imports_no_image_library():
    """The port decodes and writes images with zlib, struct and numpy."""
    import ast
    for mod in (tio, ttex, tfilm):
        tree = ast.parse(open(mod.__file__).read())
        names = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names} | {
            n.module.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert not names & {"PIL", "cv2", "OpenEXR", "imageio", "jax"}, mod


def test_atlas_from_file_is_float32_tensor():
    """load_image returns numpy; the atlas moves it to the device once."""
    a = ttex.AtlasBuilder()
    a.add_image(os.path.join(ASSETS, "checker.png"))
    at = a.build("cpu")
    assert isinstance(at.data, torch.Tensor) and at.data.dtype == torch.float32
