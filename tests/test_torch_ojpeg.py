"""Slice 7e.4b on PIL's route: old-style JPEG TIFF (compression 6), as
PIL 12.1.0 decodes it through libtiff 4.7.1's OJPEG codec and RGBA reader
(`vision_tpu_torch/scene/ojpeg.py`).

  * The committed files of `tools/gen_torch_ojpeg.py` (both layouts:
    JPEGInterchangeFormat streams and tables-only files; 4:4:4, 4:2:2,
    4:2:0, 4:1:1 and 4:4:0 at odd sizes; several strips with restart
    intervals; tiles; planar files; grey; the tags left out; the files
    PIL refuses, named `oj_bad_*`) against PIL by path and against
    `ojpeg_decodes.npz`, and through the JAX package's `load_image`.
  * Files generated here at more sizes and samplings in both layouts.
  * The SamplesPerPixel default PIL's `_setup` gives compression 6 (and
    not 7), a scene naming a refused file, seeded single-byte edits of
    the files against PIL's outcome, the 2048^2 timing file and the twins
    `cbox_tex_ojpeg` (K1) / `env_sphere_ojpeg` (K2).

Every decode is held against PIL's, bit for bit."""
import hashlib
import importlib.util
import os
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

from tests.torch_scenes import ASSETS
from vision_tpu.scene import texture as jtex
from vision_tpu_torch.scene import imageio as tio
from vision_tpu_torch.scene import texture as ttex

warnings.filterwarnings("ignore", category=UserWarning, module="PIL")

_spec = importlib.util.spec_from_file_location(
    "vt_gen_torch_ojpeg_tests", os.path.join(os.path.dirname(ASSETS), "..",
                                             "tools", "gen_torch_ojpeg.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

DECODES = np.load(os.path.join(ASSETS, "ojpeg_decodes.npz"))
FILES = sorted(fn for fn in os.listdir(ASSETS) if fn.endswith(".tif") and (
    fn.startswith("oj_") or fn.endswith("_ojpeg.tif")))


def _pil(path):
    """PIL's decode by path, or None where PIL raises."""
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except Exception:     # the JAX package's loader catches every error
        return None


def _port(path):
    try:
        return tio.read_image(path)[0]
    except ValueError:
        return None


def _outcomes(tmp_path, data, name="f.tif"):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    return _pil(p), _port(p)


def _same(tmp_path, data, decodes=True):
    """The port's decode of `data` equals PIL's, or (decodes False) both
    refuse it."""
    want, got = _outcomes(tmp_path, data)
    if not decodes:
        assert want is None and got is None, (want is None, got is None)
        return
    assert want is not None, "PIL refuses it"
    assert got is not None, "the port refuses it"
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

def test_the_committed_files_are_there():
    """Every layout the generator writes, the refusals among them, and the
    decodes of all but the refusals."""
    assert len(FILES) >= 60
    bad = [fn for fn in FILES if fn.startswith("oj_bad_")]
    assert len(bad) >= 12
    assert sorted(set(FILES) - set(bad)) == sorted(
        k for k in DECODES.files if ":" not in k)


@pytest.mark.parametrize("fn", FILES)
def test_committed_files_match_pil(fn):
    """Each file decodes to PIL's decode of it by path and to the stored
    one (the files `chip_smoke.py` holds on the card's host), or is
    refused (ValueError) where PIL refuses it."""
    p = os.path.join(ASSETS, fn)
    want = _pil(p)
    if fn.startswith("oj_bad_"):
        assert want is None
        with pytest.raises(ValueError):
            tio.read_image(p)
        return
    got, kind = tio.read_image(p)
    assert kind == "ldr"
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, DECODES[fn])


@pytest.mark.parametrize("fn", [f for f in FILES if not f.startswith(
    "oj_bad_")][::4] + ["oj_bad_sof3.tif", "oj_bad_mid_fail.tif"])
def test_committed_files_load_as_in_the_jax_package(fn):
    """`texture.load_image` gives what the JAX package's gives (PIL's
    decode, /255, sRGB decoded), or raises where it raises."""
    p = os.path.join(ASSETS, fn)
    try:
        want = jtex.load_image(p)
    except Exception:
        want = None
    if want is None:
        with pytest.raises(ValueError):
            ttex.load_image(p)
        return
    np.testing.assert_array_equal(ttex.load_image(p), want)


def test_timing_file_matches_pil():
    """The 2048^2 tables-only file `chip_smoke.py` builds from its seed
    (written without PIL, a strip and a restart interval each MCU row)
    decodes to PIL's decode: its sha256 and corner."""
    data = gen.ojpeg_timing()
    d = tio.tiffdir.LibtiffDir(data, "<")
    assert (d.width, d.length, d.rows, d.n_chunks) == (2048, 2048, 16, 128)
    got = tio.read_tiff(data)
    np.testing.assert_array_equal(got[:128, :128],
                                  DECODES["ojpeg_2048.tif:corner"])
    assert hashlib.sha256(got.tobytes()).digest() == \
        DECODES["ojpeg_2048.tif:sha256"].tobytes()


# ---------------------------------------------------------------------------
# files generated here
# ---------------------------------------------------------------------------

SAMPLINGS = ("444", "422", "420", "411", "440")
SIZES = ((1, 1), (7, 9), (16, 16), (17, 33), (40, 23))


def _jpeg(img, sampling, **kw):
    import cv2
    if sampling in ("411", "440"):
        f = {"411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}[sampling]
        return gen.cv_jpeg(img, f, **kw)
    return gen.pil_jpeg(img, 80, {"444": 0, "422": 1, "420": 2}[sampling],
                        **kw)


@pytest.mark.parametrize("layout", ["interchange", "tables"])
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_layouts_and_samplings_match_pil(tmp_path, layout, sampling):
    """Each sampling at sizes of one pixel to several MCUs with partial
    units at the right and bottom edges, in both layouts, and the same
    with the YCbCrSubsampling tag left out (the JPEG's sampling wins over
    the tag's, or its 2 x 2 default where no SOF is read)."""
    for k, (h, w) in enumerate(SIZES):
        data = _jpeg(gen.waves(h, w, k), sampling)
        _same(tmp_path, gen.ojpeg_tiff(data, layout))
        want, got = _outcomes(tmp_path, gen.ojpeg_tiff(data, layout,
                                                      drop=(530,)))
        assert (want is None) == (got is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows", [8, 16, 32])
def test_strips_with_restart_intervals_match_pil(tmp_path, rows):
    """Several strips, each a restart interval (libtiff puts an RSTn
    between strips and gives the frame one interval a strip), in both
    layouts; strips that keep their RSTn, strips of part of an MCU row
    (libtiff refuses), and an interchange stream without a DRI, as PIL
    reads them."""
    for sampling, mcu in (("420", 16), ("422", 8), ("444", 8)):
        if rows % mcu:
            continue
        img = gen.waves(45, 37, rows)
        data = gen.pil_jpeg(img, 85, {"420": 2, "422": 1, "444": 0}[
            sampling], restart_marker_rows=rows // mcu)
        iv = gen.restart_split(gen.jpeg_parts(data)["scan"])
        _same(tmp_path, gen.ojpeg_tiff(data, "tables", rows_per_strip=rows))
        _same(tmp_path, gen.ojpeg_tiff(data, rows_per_strip=rows, chunks=iv))
        kept = [c + bytes([0xFF, 0xD0 + k % 8]) for k, c in enumerate(iv)]
        for d in (gen.ojpeg_tiff(data, "tables", rows_per_strip=rows,
                                 chunks=kept[:-1] + iv[-1:]),
                  gen.ojpeg_tiff(gen.pil_jpeg(img, 85), rows_per_strip=rows,
                                 chunks=[b"\0"] * len(iv))):
            want, got = _outcomes(tmp_path, d)
            assert (want is None) == (got is None)
            if want is not None:
                np.testing.assert_array_equal(got, want)
        _same(tmp_path, gen.ojpeg_tiff(data, "tables", rows_per_strip=rows
                                       + 1, chunks=iv), decodes=False)


def test_strips_cut_or_broken_match_pil(tmp_path):
    """A strip cut short (libjpeg reads zeros to the next RSTn), one whose
    RSTn is out of order (libtiff's resync_to_restart fails: that strip
    reads as zeros and the next one's setup fails, which PIL refuses),
    one skipped (offset 0) or read to the file's end (byte count 0)."""
    img = gen.waves(64, 37, 3)
    data = gen.pil_jpeg(img, 85, 2, restart_marker_rows=1)
    iv = gen.restart_split(gen.jpeg_parts(data)["scan"])
    for k in range(4):
        for cut in (0.5, 0.1):
            ch = list(iv)
            ch[k] = ch[k][:max(1, int(len(ch[k]) * cut))]
            _same(tmp_path, gen.ojpeg_tiff(data, "tables", rows_per_strip=16,
                                           chunks=ch))
        ch = list(iv)
        ch[k] += b"\xff\xd3"
        _same(tmp_path, gen.ojpeg_tiff(data, "tables", rows_per_strip=16,
                                       chunks=ch), decodes=k >= 2)
        d = gen.ojpeg_tiff(data, "tables", rows_per_strip=16)
        for tag in (273, 279):
            e = bytearray(d)
            ifd, = struct.unpack("<I", d[4:8])
            n, = struct.unpack("<H", d[ifd:ifd + 2])
            entry = next(ifd + 2 + 12 * i for i in range(n) if struct.unpack(
                "<H", d[ifd + 2 + 12 * i:ifd + 4 + 12 * i])[0] == tag)
            at, = struct.unpack("<I", d[entry + 8:entry + 12])
            e[at + 4 * k:at + 4 * k + 4] = bytes(4)
            _same(tmp_path, bytes(e))


def test_tags_left_out_match_pil(tmp_path):
    """libtiff's OJPEG directory hacks, probed against PIL: a missing
    Photometric or SamplesPerPixel (or both), StripByteCounts,
    StripOffsets (one strip: the stream alone), JPEGProc, or the planar
    tag decode; a missing BitsPerSample is refused by PIL (its default
    (1,) gives no mode, where libtiff reads 8), and so is a tables-only
    file without a table or its byte counts."""
    j = gen.pil_jpeg(gen.waves(30, 27, 4), 85, 2)
    for drop in ((277,), (262,), (262, 277), (279,), (273,), (273, 279),
                 (512,), (514,), (519,), (284,)):
        _same(tmp_path, gen.ojpeg_tiff(j, drop=drop))
    for drop in ((277,), (262,), (513,), (514,), (512,)):
        _same(tmp_path, gen.ojpeg_tiff(j, "tables", drop=drop))
    for layout, drop in (("interchange", (258,)), ("interchange", (513,)),
                         ("tables", (258,)), ("tables", (279,)),
                         ("tables", (519,)), ("tables", (520,)),
                         ("tables", (521,))):
        _same(tmp_path, gen.ojpeg_tiff(j, layout, drop=drop), decodes=False)


def test_samples_per_pixel_default_as_pils():
    """PIL's `_setup` gives SamplesPerPixel a default of 3 for compression
    6 (PIL's "tiff_jpeg") with photometric 2 or 6, and 1 for compression 7:
    an old-style JPEG file without the tag decodes as PIL decodes it, and a
    compression-7 RGB file without it is refused as PIL refuses it (PIL:
    UnidentifiedImageError; the port: no plugin takes it, ValueError)."""
    j = gen.pil_jpeg(gen.waves(16, 24, 5), 85, 2)
    data = gen.ojpeg_tiff(j, drop=(277,))
    st = tio.tiffdir.PilSetup(tio.tiffdir.pil_ifd(data, "<"))
    assert st.spp == 3 and st.bps == (8, 8, 8)
    np.testing.assert_array_equal(tio.read_tiff(data), tio.read_tiff(
        gen.ojpeg_tiff(j)))
    new = bytearray(gen.ojpeg_tiff(j, photometric=2, drop=(277,)))
    new[new.index(struct.pack("<HHII", 259, 3, 1, 6)) + 8] = 7
    tags = tio.tiffdir.pil_ifd(bytes(new), "<")
    assert tio.tiffdir.PilSetup(tags).spp == 1
    with pytest.raises(tio.pilread._PassOn):
        tio.read_tiff(bytes(new))
    p = os.path.join(ASSETS, "oj_no277.tif")
    np.testing.assert_array_equal(tio.read_image(p)[0], _pil(p))


def test_tiles_and_planes_match_pil(tmp_path):
    """Tiles (one stream a tile wide, a restart interval a tile; libtiff's
    frame is one column of tiles high, and the tiles past it read its
    last rows again), planar files (one scan a plane; the RGBA reader
    converts 1 x 1 planes only) as PIL reads them."""
    for sampling in (0, 2):
        img = gen.waves(40, 90, sampling)
        for tw, th in ((32, 16), (96, 16), (32, 48)):
            jt = gen.pil_jpeg(gen._tiles(img, tw, th), 85, sampling,
                              restart_marker_rows=th // 16 or 1)
            size = {256: (4, [90]), 257: (4, [40])}
            want, got = _outcomes(tmp_path, gen.ojpeg_tiff(
                jt, "tables", tile=(tw, th), tags=size))
            assert (want is None) == (got is None)
            if want is not None:
                np.testing.assert_array_equal(got, want)
    img = gen.waves(24, 19, 9)
    for restart, rows in ((0, None), (3, 8)):
        j = gen.baseline_jpeg(img, 85, (0x11,) * 3, restart=restart,
                              interleaved=False)
        chunks = [c for a, b in gen._scans(j) for c in (
            gen.restart_split(j[a:b]) if restart else [j[a:b]])]
        _same(tmp_path, gen.ojpeg_tiff(j, rows_per_strip=rows, chunks=chunks,
                                       tags={284: (3, [2])}))
        # tables-only: no SOS for the later planes, whose failed search
        # moves the source plane 0 reads on from (several strips: refused)
        _same(tmp_path, gen.ojpeg_tiff(j, "tables", rows_per_strip=rows,
                                       chunks=chunks, tags={284: (3, [2])}),
              decodes=rows is None)
    j = gen.baseline_jpeg(img, 85, (0x22, 0x11, 0x11), interleaved=False)
    _same(tmp_path, gen.ojpeg_tiff(j, chunks=[j[a:b] for a, b in gen._scans(
        j)], tags={284: (3, [2])}), decodes=False)


@pytest.mark.parametrize("name", ["cbox_tex", "env_sphere"])
def test_scene_naming_a_refused_file_loads_as_jax(name):
    """A scene whose texture (`cbox_tex`'s checker, K1) or projector image
    (`env_sphere`'s, K2) is an old-style JPEG TIFF PIL refuses loads in
    both packages: the slot takes its default with a warning, and the
    port's tables equal the JAX Scene's."""
    from tests import torch_scenes as ts
    from tests.test_torch_scene import _assert_same_scene
    from tests.torch_parity import jax_scene_arrays
    from vision_tpu.scene.scene import Scene as JScene
    import vision_tpu_torch as vt
    fn = {"cbox_tex": "checker.png", "env_sphere": "projector.png"}[name]
    s = ts._swap_files(getattr(ts, name)(16), {fn: "oj_bad_mid_fail.tif"})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ps = vt.load_scene(s, device="cpu")
    assert any("old-style JPEG" in str(w.message) for w in caught)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_scene_arrays(JScene(s))
    _assert_same_scene(ps.data, ps.camera, ps.filter, ref)


# ---------------------------------------------------------------------------
# seeded single-byte edits
# ---------------------------------------------------------------------------

def _edit_bases():
    img = gen.waves(30, 27, 4)
    jr = gen.pil_jpeg(gen.waves(48, 27, 4), 85, 2, restart_marker_rows=1)
    j = gen.baseline_jpeg(gen.waves(16, 16, 8), 85, (0x11,) * 3,
                          interleaved=False)
    return {"interchange": gen.ojpeg_tiff(gen.pil_jpeg(img, 85, 2)),
            "tables_strips": gen.ojpeg_tiff(jr, "tables", rows_per_strip=16),
            "tables_444": gen.ojpeg_tiff(gen.pil_jpeg(gen.waves(
                13, 21, 6), 85, 0), "tables"),
            "grey": gen.ojpeg_tiff(gen.pil_jpeg(gen.waves(20, 17, 7)[..., 0],
                                                85), photometric=1),
            "planar": gen.ojpeg_tiff(j, chunks=[j[a:b] for a, b in
                                                gen._scans(j)],
                                     tags={284: (3, [2])})}


# edits whose outcome the port does not match, by base (ROADMAP C33)
EDITS_OFF = {"interchange": 0, "tables_strips": 0, "tables_444": 0,
             "grey": 0, "planar": 0}


@pytest.mark.parametrize("base", sorted(EDITS_OFF))
def test_seeded_edits_match_pil(tmp_path, base):
    """80 seeded single-byte edits of each base file (its directory
    entries and tables most often, its data too) against PIL's outcome:
    decoded bit for bit, or refused by both; the edits whose outcome
    differs are counted exactly (ROADMAP C33)."""
    data = _edit_bases()[base]
    g = np.random.default_rng(sorted(EDITS_OFF).index(base) + 33)
    ifd, = struct.unpack("<I", data[4:8])
    off = 0
    for _ in range(80):
        r = g.random()
        pos = int(g.integers(ifd, len(data))) if r < 0.4 else int(
            g.integers(8, min(len(data), 240))) if r < 0.7 else int(
            g.integers(0, len(data)))
        e = bytearray(data)
        e[pos] = int(g.integers(0, 256))
        if e[pos] == data[pos]:
            e[pos] ^= 0x55
        want, got = _outcomes(tmp_path, bytes(e))
        same = (want is None and got is None) or (
            want is not None and got is not None and want.shape ==
            got.shape and np.array_equal(want, got))
        off += not same
    assert off == EDITS_OFF[base]


# ---------------------------------------------------------------------------
# the twins, and what is left
# ---------------------------------------------------------------------------

def test_twins_files():
    """The twins' PNGs hold PIL's decodes of their old-style JPEG TIFFs."""
    for a, b in (("checker_ojpeg.tif", "checker_ojpeg_pil.png"),
                 ("projector_ojpeg.tif", "projector_ojpeg_pil.png")):
        np.testing.assert_array_equal(
            tio.read_image(os.path.join(ASSETS, a))[0],
            tio.read_image(os.path.join(ASSETS, b))[0])
    d = tio.tiffdir.LibtiffDir(open(os.path.join(
        ASSETS, "projector_ojpeg.tif"), "rb").read(), "<")
    assert d.n_chunks == 4 and 519 in d.entries and 513 not in d.entries


@pytest.mark.parametrize("name", ["cbox_tex_ojpeg", "env_sphere_ojpeg"])
def test_twin_scenes_render_as_their_references(name):
    """`cbox_tex_ojpeg` (K1) renders as `cbox_tex_ojpeg_ref`,
    `env_sphere_ojpeg` (K2) as `env_sphere_ojpeg_ref`: the same atlas, the
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


def test_7e4b_is_left_for_sglog_on_opencvs_route_only(tmp_path):
    """No module of the port names 7e.4b any more: SGILog under a .exr name
    (OpenCV's route) decodes as the pip cv2 decodes it, and an old-style
    JPEG file there is refused as the pip cv2 refuses it (its libtiff
    lacks the codec)."""
    import pathlib
    import vision_tpu_torch
    root = pathlib.Path(vision_tpu_torch.__file__).parent
    for path in sorted(root.rglob("*")):
        if path.suffix in (".py", ".cpp", ".cu", ".cuh") and \
                "_build" not in path.parts:
            assert "7e.4b" not in path.read_text(), path
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_sgilog_ojpeg", os.path.join(os.path.dirname(ASSETS),
                                                  "..", "tools",
                                                  "gen_torch_sgilog.py"))
    sgi = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sgi)
    p = str(tmp_path / "luv.exr")
    with open(p, "wb") as f:
        f.write(sgi.sgilog_tiff(sgi._random_luv32(np.random.default_rng(8),
                                                  8, 8), "luv32",
                                rows_per_strip=3))
    want = jtex.load_image(p)
    got = tio.read_image(p)[0]
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    p = str(tmp_path / "oj.exr")
    with open(p, "wb") as f:
        f.write(gen.ojpeg_tiff(gen.pil_jpeg(gen.waves(8, 8, 1))))
    with pytest.raises(ValueError):
        tio.read_image(p)
    with pytest.raises(Exception):
        jtex.load_image(p)
