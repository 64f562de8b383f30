"""Slice 7e.4b on OpenCV's route: SGILog TIFF (LogL 32844 / LogLuv 32845,
compressions 34676 / 34677) under .hdr / .exr names, as the JAX package's
loader gets it through the pip cv2 5.0.0 (libtiff 4.7.1):
`cvtiff._logluv_xyz` (LogLuv as float X, Y, Z), `cvtiff._xyz2bgr`
(OpenCV's XYZ2BGR), `cvtiff._logl_route` (LogL as libtiff's 8-bit grey),
`sgilog.py` (tif_luv.c's conversions, uvcode.h's table) and
`native.sgilog_decode` (tif_luv.c's row decoders, `csrc/image_codecs.cpp`).

  * The committed files of `tools/gen_torch_sgilog.py` against
    `sgilog_decodes.npz` and `jtex.load_image` on the spot; the `sl_bad_*`
    files refused by both.
  * LogLuv32 and LogL16 with the sign bit, L = 0, runs and literals across
    127 / 128 / 129 bytes, 1 to H rows a strip, widths 1-9, 61 and 130;
    LogLuv24 on all 16,384 uv codes; hand-built streams (literals running
    past the row, zero counts, a run cut by the data's end).
  * The directory rules (bits, sample format, samples, planar, tiles,
    missing tags, photometric and compression) with cv2's outcome; ROADMAP
    C34 (LogLuv without SamplesPerPixel) refused.
  * 200 seeded single-byte edits of run-length data, each with cv2's
    outcome; PIL's route still refusing SGILog; the 2048^2 timing file;
    the twins `cbox_sky_logluv` (K1) / `env_sphere_luv24` (K2).

Every decode is held against the pip cv2's, bit for bit (floats as their
bits)."""
import hashlib
import importlib.util
import os
import struct
import warnings

import numpy as np
import pytest

from tests.torch_scenes import ASSETS
from vision_tpu.scene import texture as jtex
from vision_tpu_torch import native
from vision_tpu_torch.scene import cvtiff, sgilog
from vision_tpu_torch.scene import imageio as tio
from vision_tpu_torch.scene import texture as ttex

warnings.filterwarnings("ignore", category=UserWarning, module="PIL")

_spec = importlib.util.spec_from_file_location(
    "vt_gen_torch_sgilog_tests", os.path.join(os.path.dirname(ASSETS), "..",
                                              "tools", "gen_torch_sgilog.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)
GA = gen._assets_module()

DECODES = np.load(os.path.join(ASSETS, "sgilog_decodes.npz"))
FILES = sorted(k for k in DECODES.files if ":" not in k)
BAD = sorted(fn for fn in os.listdir(ASSETS) if fn.startswith("sl_bad_"))


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _library(path):
    """What the JAX package's loader gets through the pip cv2, or None
    where it raises."""
    try:
        return jtex.load_image(path)
    except Exception:     # the JAX package's loader catches every error
        return None


def _port(path):
    try:
        return tio.read_image(path)[0]
    except ValueError:
        return None


def _same(want, got):
    if want is None or got is None:
        return want is None and got is None
    return want.shape == got.shape and np.array_equal(_bits(want), _bits(got))


def _outcomes(tmp_path, data, name="t.exr"):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    return _library(p), _port(p)


def _assert_same(tmp_path, data, name="t.exr", decodes=None):
    want, got = _outcomes(tmp_path, data, name)
    if decodes is not None:
        assert (want is not None) == decodes, "the library's outcome"
    assert _same(want, got), (want is None, got is None)


def _tiff(p, kind, **kw):
    return gen.sgilog_tiff(p, kind, ga=GA, **kw)


def _luv32(seed, h, w):
    return gen._random_luv32(np.random.default_rng(seed), h, w)


def _l16(seed, h, w):
    g = np.random.default_rng(seed)
    p = g.integers(0, 1 << 16, (h, w)).astype(np.uint16)
    p[:, w // 4:w // 2] = p[:, w // 4:w // 4 + 1]
    return p


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", FILES)
def test_committed_files_match_their_decodes(fn):
    """Each file decodes to the pip cv2's stored decode, and the JAX
    package's loader gives that decode on the spot."""
    p = os.path.join(ASSETS, fn)
    got, kind = tio.read_image(p)
    assert kind == "hdr"
    assert _same(DECODES[fn], got)
    assert _same(_library(p), got)


@pytest.mark.parametrize("fn", BAD)
def test_refused_files(fn):
    """The files the pip cv2 refuses (a LogLuv strip cut short, planar
    LogLuv, LogL of SGILog24 or of three samples, LogLuv of LZW) are
    refused."""
    p = os.path.join(ASSETS, fn)
    assert _library(p) is None
    with pytest.raises(ValueError):
        tio.read_image(p)


@pytest.mark.parametrize("fn", ["sky_a_logluv.exr", "projector_luv24.hdr",
                                "sl_logl_strips.exr"])
def test_load_image_matches_jax(fn):
    """`texture.load_image` of a LogLuv32, LogLuv24 and LogL file, as the
    JAX package's."""
    p = os.path.join(ASSETS, fn)
    np.testing.assert_array_equal(_bits(ttex.load_image(p, "srgb")),
                                  _bits(jtex.load_image(p, "srgb")))


def test_timing_file():
    """The 2048^2 LogLuv32 file of 128 strips built from its seed decodes to
    the pip cv2's decode: its sha256 and corner."""
    data = gen.logluv_timing()
    d = tio.tiffdir.LibtiffDir(data, "<")
    assert (d.width, d.length, d.n_chunks) == (2048, 2048, 128)
    got = cvtiff._xyz2bgr(cvtiff._logluv_xyz(d))[..., ::-1]
    np.testing.assert_array_equal(_bits(got[:128, :128]),
                                  _bits(DECODES["luv_2048.exr:corner"]))
    assert hashlib.sha256(np.ascontiguousarray(got).tobytes()).digest() == \
        DECODES["luv_2048.exr:sha256"].tobytes()


# ---------------------------------------------------------------------------
# the conversions
# ---------------------------------------------------------------------------

def test_uv_table():
    """uvcode.h's table as recovered: 163 rows of v, 16,289 codes, each
    row's first code the count before it, the first rows as uvcode.h
    lists them."""
    ustart, nus, ncum = sgilog.uv_table()
    assert len(ustart) == 163 and int(nus.sum()) == sgilog.UV_NDIVS
    np.testing.assert_array_equal(ncum, np.cumsum(nus) - nus)
    assert ustart.dtype == np.float32
    np.testing.assert_array_equal(ustart[:2], np.float32([0.247663,
                                                          0.243779]))
    np.testing.assert_array_equal(nus[:4], [4, 6, 7, 9])


@pytest.mark.parametrize("l10", [1, 301, 768, 1023])
def test_luv24_every_uv_code(tmp_path, l10):
    """Every 14-bit uv code (the 95 past the table as the neutral point)
    at LogL10 code l10, against the pip cv2."""
    _assert_same(tmp_path, _tiff(gen.uv_sweep(l10), "luv24",
                                 rows_per_strip=16), decodes=True)


def test_logl_every_code(tmp_path):
    """L16toGry of all 65,536 LogL16 codes (sign bit, Y <= 0, Y >= 1)
    against the pip cv2's 8-bit grey, and `sgilog.l16_to_gry` directly."""
    codes = np.arange(1 << 16, dtype=np.uint16).reshape(256, 256)
    want, got = _outcomes(tmp_path, _tiff(codes, "l16", rows_per_strip=7))
    assert _same(want, got)
    np.testing.assert_array_equal(sgilog.l16_to_gry(codes),
                                  want[..., 0].astype(np.uint8))


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 6, 7, 8, 9, 61, 130])
def test_xyz2bgr_order(w):
    """`_xyz2bgr` against cv2.cvtColor(COLOR_XYZ2BGR) on random floats of
    width w: the vector loop's c0 X + (c1 Y + c2 Z) on the first 4 floor(w
    / 4) pixels of each row, the tail's (c0 X + c1 Y) + c2 Z after."""
    import cv2
    g = np.random.default_rng(w)
    xyz = (g.standard_normal((5, w, 3)) * 10).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(cvtiff._xyz2bgr(xyz)),
        _bits(cv2.cvtColor(xyz, cv2.COLOR_XYZ2BGR)))


# ---------------------------------------------------------------------------
# generated files: widths, strips, runs and literals, hand-built streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 6, 7, 8, 9, 61, 130])
def test_luv32_widths(tmp_path, w):
    """LogLuv32 of width w (the sign bit, L = 0, runs), three strips."""
    _assert_same(tmp_path, _tiff(_luv32(w, 8, w), "luv32",
                                 rows_per_strip=3), decodes=True)


@pytest.mark.parametrize("kind", ["luv32", "l16", "luv24"])
@pytest.mark.parametrize("rps", [1, 2, 3, 4, 5, 6, 7])
def test_rows_per_strip(tmp_path, kind, rps):
    """1 to H rows a strip, on each codec."""
    p = {"luv32": lambda: _luv32(rps, 7, 13), "l16": lambda: _l16(rps, 7, 13),
         "luv24": lambda: np.random.default_rng(rps).integers(
             0, 1 << 24, (7, 13))}[kind]()
    _assert_same(tmp_path, _tiff(p, kind, rows_per_strip=rps), decodes=True)


@pytest.mark.parametrize("max_run, max_lit", [(129, 127), (128, 127),
                                              (129, 126), (127, 128),
                                              (4, 1), (5, 3)])
@pytest.mark.parametrize("kind", ["luv32", "l16"])
def test_runs_and_literals(tmp_path, kind, max_run, max_lit):
    """Rows holding runs of 127-130 equal bytes, coded with runs of at
    most max_run and literals of at most max_lit bytes (a literal count of
    128 reads as a run of 2)."""
    p = _luv32(7, 6, 131) if kind == "luv32" else _l16(7, 6, 131)
    for r, n in enumerate((127, 128, 129, 130)):
        p[r, :n] = p[r, 0]
    _assert_same(tmp_path, _tiff(p, kind, rows_per_strip=2, max_run=max_run,
                                 max_lit=max_lit), decodes=True)


# hand-built LogL16 strips of one row of 3 pixels: (name, strip bytes)
HAND = [
    ("literals", bytes([3, 1, 2, 3, 3, 4, 5, 6])),
    ("runs", bytes([129, 7, 129, 9])),
    ("literal_past_the_row", bytes([5, 1, 2, 3, 4, 5, 1, 9])),
    ("zero_count", bytes([0, 3, 1, 2, 3, 0, 129, 4])),
    ("run_past_the_row", bytes([255, 1, 129, 2])),
    ("run_cut_by_the_end", bytes([3, 1, 2, 3, 129])),
    ("literal_cut_by_the_end", bytes([3, 1, 2, 3, 3, 4])),
    ("empty_plane", bytes([3, 1, 2, 3])),
    ("rows_run_on", bytes([3, 1, 2, 3, 3, 4, 5, 6, 129, 1, 129, 2])),
]


@pytest.mark.parametrize("name, strip", HAND, ids=[h[0] for h in HAND])
def test_hand_built_streams(tmp_path, name, strip):
    """LogL16 strips built by hand (a literal running past the row is read
    on as the next plane's code; a zero count is a no-op; a run cut by the
    data's end fails the row, whose grey stays 0), and the same bytes twice
    as a LogLuv32 strip, against the pip cv2."""
    rows = 2 if name == "rows_run_on" else 1
    p = np.zeros((rows, 3), np.uint16)
    _assert_same(tmp_path, _tiff(p, "l16", chunks=[strip]), decodes=True)
    _assert_same(tmp_path, _tiff(p.astype(np.uint32), "luv32",
                                 chunks=[strip * 2]))


def test_native_decoder_rows():
    """`native.sgilog_decode` gives the rows decoded whole and zeros after
    a failed row, on each kind."""
    p = _luv32(3, 4, 6)
    data = gen.rle_rows(gen.luv32_planes(p))
    codes, done = native.sgilog_decode(data, 6, 4, 32)
    assert done == 4 and np.array_equal(codes, p)
    codes, done = native.sgilog_decode(data[:-5], 6, 4, 32)
    assert done == 3 and np.array_equal(codes[:3], p[:3]) and \
        not codes[3].any()
    p24 = np.arange(24, dtype=np.uint32).reshape(4, 6) * 0x10101
    codes, done = native.sgilog_decode(gen.luv24_bytes(p24)[:-1], 6, 4, 24)
    assert done == 3 and np.array_equal(codes[:3], p24[:3])
    p16 = _l16(4, 4, 6)
    codes, done = native.sgilog_decode(gen.rle_rows(gen.l16_planes(p16)), 6,
                                       4, 16)
    assert done == 4 and np.array_equal(codes, p16)


# ---------------------------------------------------------------------------
# the directory rules
# ---------------------------------------------------------------------------

def _rule_cases():
    out = []
    for kind in ("luv32", "luv24", "l16"):
        for bits, sf in ((8, None), (16, 2), (32, 3), (12, None), (1, None),
                         (4, None), (16, 4)):
            out.append((kind, f"bits{bits}_sf{sf}", dict(
                bits=bits, tags={} if sf is None else {
                    339: (3, [sf] * (1 if kind == "l16" else 3))})))
        for spp in (1, 2, 4):
            out.append((kind, f"spp{spp}", dict(spp=spp)))
        out += [(kind, "planar", dict(tags={284: (3, [2])})),
                (kind, "tiles", dict(tile=(16, 16))),
                (kind, "no_rows_per_strip", dict(drop=(278,))),
                (kind, "no_bits", dict(drop=(258,))),
                (kind, "fill_order_2", dict(tags={266: (3, [2])})),
                (kind, "grey", dict(photometric=1)),
                (kind, "rgb", dict(photometric=2)),
                (kind, "logl", dict(photometric=32844)),
                (kind, "logluv", dict(photometric=32845)),
                (kind, "sgilog", dict(compression=34676)),
                (kind, "sgilog24", dict(compression=34677)),
                (kind, "uncompressed", dict(compression=1))]
    return out


RULES = _rule_cases()


@pytest.mark.parametrize("kind, case, kw", RULES,
                         ids=[f"{k}-{c}" for k, c, _ in RULES])
def test_directory_rules(tmp_path, kind, case, kw):
    """LogLuvSetupDecode's, TIFFRGBAImageOK's and OpenCV's own rules: the
    float route takes any bits and sample format (OpenCV sets its data
    format), LogL's RGBA route libtiff's bits and sample formats; planar
    LogLuv, LogL of more samples or of SGILog24, SGILog of another
    photometric and LogLuv of no SGILog compression refused; tiles, fill
    order 2 and a missing RowsPerStrip decoded."""
    p = {"luv32": lambda: _luv32(11, 9, 19), "l16": lambda: _l16(11, 9, 19),
         "luv24": lambda: np.random.default_rng(11).integers(
             0, 1 << 24, (9, 19))}[kind]()
    if "tile" not in kw and "drop" not in kw:
        kw = dict(kw, rows_per_strip=4)
    _assert_same(tmp_path, _tiff(p, kind, **kw))


@pytest.mark.parametrize("kind", ["luv32", "luv24"])
def test_logluv_without_samples_per_pixel_c34(tmp_path, kind):
    """ROADMAP C34: LogLuv without a SamplesPerPixel tag. OpenCV takes 3
    samples and reads float XYZ, libtiff's default of one sample gives
    rows of a third of the pixels, and the rest of OpenCV's buffer is
    uninitialised memory (cv2 decodes it, its values not defined): the
    port refuses it (ValueError)."""
    p = _luv32(5, 6, 9) if kind == "luv32" else np.random.default_rng(
        5).integers(0, 1 << 24, (6, 9))
    want, got = _outcomes(tmp_path, _tiff(p, kind, drop=(277,)))
    assert want is not None and got is None


# ---------------------------------------------------------------------------
# seeded edits
# ---------------------------------------------------------------------------

EDITED = {
    "luv32_strips": lambda: _tiff(_luv32(21, 9, 23), "luv32",
                                  rows_per_strip=4),
    "luv32_tiles": lambda: _tiff(_luv32(22, 20, 21), "luv32", tile=(16, 16)),
    "l16_strips": lambda: _tiff(_l16(23, 9, 23), "l16", rows_per_strip=2),
    "luv24_strips": lambda: _tiff(np.random.default_rng(24).integers(
        0, 1 << 24, (9, 23)), "luv24", rows_per_strip=4)}


@pytest.fixture(scope="module")
def edited():
    """Each base file's 50 seeded single-byte edits of its strip data
    (tests/test_torch_tiff_codecs.py `_edits`'s rule)."""
    out = {}
    for k, (name, make) in enumerate(sorted(EDITED.items())):
        data = make()
        g = np.random.default_rng(2300 + k)
        end, = struct.unpack("<I", data[4:8])
        edits = []
        for _ in range(50):
            d = bytearray(data)
            i = int(g.integers(8, end))
            d[i] = (0, 1, 255, d[i] ^ 1 << int(g.integers(8)))[
                int(g.integers(4))]
            edits.append(bytes(d))
        out[name] = edits
    return out


@pytest.mark.parametrize("name", sorted(EDITED))
def test_edits_match_opencv(tmp_path, edited, name):
    """Each edit of the run-length (or raw LogLuv24) data has cv2's outcome:
    a LogLuv strip that fails refused, a LogL strip that fails decoded to
    the failed row and zeros after it, as libtiff's RGBA reader gives."""
    off = [i for i, d in enumerate(edited[name])
           if not _same(*_outcomes(tmp_path, d))]
    assert off == []


# ---------------------------------------------------------------------------
# PIL's route, the twins
# ---------------------------------------------------------------------------

def test_pil_route_still_refuses_sgilog(tmp_path):
    """Under a .tif name (PIL's route) LogLuv and LogL are refused as PIL
    refuses them (it has no mode for either)."""
    from PIL import Image
    for data in (_tiff(_luv32(1, 4, 5), "luv32"), _tiff(_l16(1, 4, 5),
                                                        "l16")):
        p = str(tmp_path / "t.tif")
        with open(p, "wb") as f:
            f.write(data)
        with pytest.raises(Exception):
            with Image.open(p) as im:
                im.convert("RGB")
        with pytest.raises(ValueError):
            tio.read_image(p)


def test_twins_files():
    """The twins' references hold the pip cv2's decodes of their SGILog
    files: sky_a as LogLuv32 in strips of 5 rows, the projector as
    LogLuv24."""
    for a, b in (("sky_a_logluv.exr", "sky_a_logluv_ref.exr"),
                 ("projector_luv24.hdr", "projector_luv24_pfm.hdr")):
        np.testing.assert_array_equal(
            _bits(tio.read_image(os.path.join(ASSETS, a))[0]),
            _bits(tio.read_image(os.path.join(ASSETS, b))[0]))
    d = tio.tiffdir.LibtiffDir(open(os.path.join(
        ASSETS, "sky_a_logluv.exr"), "rb").read(), "<")
    assert (d.compression, d.photometric, d.n_chunks) == (34676, 32845, 7)


@pytest.mark.parametrize("name", ["cbox_sky_logluv", "env_sphere_luv24"])
def test_twin_scenes_render_as_their_references(name):
    """`cbox_sky_logluv` (K1) renders as `cbox_sky_logluv_ref`,
    `env_sphere_luv24` (K2) as `env_sphere_luv24_ref`: the same atlas, the
    same render, bit for bit (64^2, 1 spp on the CPU); and the twin's
    tables equal the JAX Scene's."""
    import torch
    import vision_tpu_torch as vt
    from tests import torch_scenes as ts
    from tests.test_torch_scene import _assert_same_scene
    from tests.torch_parity import jax_scene_arrays
    from vision_tpu.scene.scene import Scene as JScene
    kw = dict(sub_div=8) if name.startswith("env") else {}
    a = vt.load_scene(getattr(ts, name + "_ref")(64, **kw), device="cpu")
    desc = getattr(ts, name)(64, **kw)
    b = vt.load_scene(desc, device="cpu")
    assert torch.equal(a.data.atlas.data, b.data.atlas.data)
    assert torch.equal(vt.render(a, spp=1), vt.render(b, spp=1))
    _assert_same_scene(b.data, b.camera, b.filter,
                       jax_scene_arrays(JScene(desc)))
