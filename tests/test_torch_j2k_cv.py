"""Slice 7e.7b: JPEG 2000 under .hdr / .exr names, as the JAX package's
loader gets it: `cv2.imread(p, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`, the
pip cv2 5.0.0's Jpeg2KOpjDecoder over OpenJPEG 2.5.3's whole-image API
(`scene/cvj2k.py`, `scene/j2k.py` `WholeImage`).

  * Every file of `j2k_cv_decodes.npz` (slice 7e.7a's files and the
    `j2kcv_*` files of `tools/gen_torch_j2k_cv.py`) under a .exr and a
    .hdr name against its stored decode, and against the JAX package's
    `load_image` on the spot; the files the pip cv2 refuses refused.
  * 300 seeded byte edits and cuts of 12 files, each with the pip cv2's
    stored outcome.
  * OpenCV's BGR2GRAY and YUV2BGR against `cv2.cvtColor`; OpenJPEG's
    tile-part count rule on PIL's route too; the signatures, the size
    limit, HTJ2K and AVIF; the 2048^2 timing file; the twins
    `cbox_sky_j2kcv` (K1) / `env_sphere_j2kcv` (K2)."""
import hashlib
import importlib.util
import os
import pathlib
import re
import struct

import numpy as np
import pytest

from tests.torch_scenes import ASSETS
from vision_tpu.scene import texture as jtex
from vision_tpu_torch.scene import cvj2k, j2k
from vision_tpu_torch.scene import imageio as tio

_spec = importlib.util.spec_from_file_location(
    "vt_gen_torch_j2k_cv_tests", os.path.join(
        os.path.dirname(ASSETS), "..", "tools", "gen_torch_j2k_cv.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

DECODES = np.load(os.path.join(ASSETS, "j2k_cv_decodes.npz"))
REFUSED = sorted(DECODES[":refused"].tolist())
FILES = sorted([k for k in DECODES.files if ":" not in k] + REFUSED)


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


def _named(tmp_path, data, name):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    return p


def _read(fn):
    with open(os.path.join(ASSETS, fn), "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", FILES)
def test_committed_files_match_cv2(tmp_path, fn):
    """Each file, under a .exr and a .hdr name, decodes to the pip cv2's
    stored decode (or is refused where it refused), and the JAX package's
    loader gives that on the spot."""
    data = _read(fn)
    want = None if fn in REFUSED else DECODES[fn]
    for name in ("x.exr", "x.hdr"):
        p = _named(tmp_path, data, name)
        got = _port(p)
        assert _same(want, got), name
    assert _same(_library(p), got)


def test_the_matrix_is_whole():
    """The files cover what the slice claims, and the pip cv2 refuses the
    cases OpenCV's rules refuse."""
    claimed = {"j2kcv_grey16.j2k", "j2kcv_rgb10.jp2", "j2kcv_rgb16_irr.j2k",
               "j2kcv_prec_mixed.j2k", "j2kcv_pal_cdef.jp2",
               "j2kcv_pal4_cmap.jp2", "j2kcv_pal16.jp2",
               "j2kcv_pal_corrected.jp2", "j2kcv_pal_on2.jp2",
               "j2kcv_pal_mixed.jp2", "j2kcv_cdef_swap.jp2",
               "j2kcv_sycc12.jp2", "j2kcv_sycca16.jp2", "j2kcv_sycc1.jp2",
               "j2kcv_grey2_16.jp2", "j2kcv_grey3.jp2", "j2k_grey4.jp2",
               "j2kcv_tiles_rgb.j2k", "j2kcv_tiles16.j2k",
               "j2kcv_poc_stop.j2k", "j2kcv_poc_stop_c1.j2k",
               "j2k_poc_reduced.j2k", "j2k_sycc.jp2", "j2k_sycca.jp2",
               "j2k_p3.jp2", "j2k_2048.jp2:sha256", "sky_a_j2kcv.exr",
               "projector_j2kcv.hdr"}
    assert claimed <= set(DECODES.files)
    refused = {"j2k_signed_l.j2k", "j2k_prec5.j2k", "j2k_prec23.j2k",
               "j2k_cmyk.jp2", "j2k_bad_eycc.jp2", "j2k_la_irr.j2k",
               "j2k_pa.jp2", "j2k_sub_420.j2k", "j2k_offset_irr.jp2",
               "projector_j2k.j2k", "j2k_bad_noeoc.j2k"}
    assert refused <= set(REFUSED)
    assert {fn for fn in os.listdir(ASSETS)
            if fn.startswith("j2kcv_bad_")} <= set(REFUSED)
    assert len(DECODES["edits:sha256"]) == \
        len(gen.EDIT_SOURCES) * gen.EDITS_EACH


# ---------------------------------------------------------------------------
# seeded edits
# ---------------------------------------------------------------------------

EDITS = gen.edit_cases(ASSETS)


@pytest.mark.parametrize("case", range(30))
def test_seeded_edits_match_cv2(case):
    """Ten of the 300 seeded cuts, byte replacements or bit flips of
    `gen.EDIT_SOURCES`: the port's outcome (its decode's sha256, or a
    refusal) is the pip cv2's stored one; an edit that sets the HT
    code-block bit raises naming 7e.7c instead."""
    want = DECODES["edits:sha256"]
    for i in range(case * 10, case * 10 + 10):
        fn, data = EDITS[i]
        if j2k.uses_ht(data):
            with pytest.raises(NotImplementedError, match=r"7e\.7c"):
                tio._read_opencv(data, "x.exr")
            continue
        try:
            got = tio._read_opencv(data, "x.exr")
        except ValueError:
            got = None
        assert gen._digest(got) == want[i].tobytes(), (fn, i)


# ---------------------------------------------------------------------------
# OpenCV's conversions, the library's rules, the routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 12, 16])
def test_conversions_match_cvtcolor(bits):
    """`cvj2k.bgr_to_grey` and `yuv_to_bgr` are cv2.cvtColor's BGR2GRAY and
    YUV2BGR on random samples (12-bit ones in a 16-bit Mat), bit for bit."""
    cv2 = pytest.importorskip("cv2")
    g = np.random.default_rng(bits)
    dt = np.uint8 if bits == 8 else np.uint16
    a = g.integers(0, 1 << bits, (256, 256, 3)).astype(dt)
    a[0, :4] = [[0, 0, 0], [(1 << bits) - 1] * 3, [0, (1 << bits) - 1, 0],
                [1 << (bits - 1)] * 3]
    np.testing.assert_array_equal(
        cvj2k.bgr_to_grey(a[..., 0], a[..., 1], a[..., 2]),
        cv2.cvtColor(a, cv2.COLOR_BGR2GRAY))
    np.testing.assert_array_equal(
        cvj2k.yuv_to_bgr(a[..., 0], a[..., 1], a[..., 2],
                         8 if bits == 8 else 16),
        cv2.cvtColor(a, cv2.COLOR_YUV2BGR))


@pytest.mark.parametrize("fn", ["j2kcv_bad_tnsot1.j2k",
                                "j2kcv_one_tile_tnsot1.j2k"])
def test_one_declared_tile_part_on_pils_route(tmp_path, fn):
    """A tile that declares one tile-part is not checked for a miscounted
    TNsot (OpenJPEG 2.5.3 and 2.5.4): its second tile-part fails on PIL's
    route, where PIL reads on to EOC; OpenCV's single-tile decode stops
    after the tile (j2kcv_one_tile_tnsot1 decodes there)."""
    from PIL import Image
    p = _named(tmp_path, _read(fn), "x.j2k")
    with pytest.raises(Exception):
        with Image.open(p) as im:
            im.convert("RGB")
    with pytest.raises(ValueError):
        tio.read_image(p)
    assert (fn in REFUSED) == fn.startswith("j2kcv_bad_")


def test_signatures(tmp_path):
    """OpenCV takes a JP2 file by its whole 12-byte signature box: the
    first 8 bytes alone are no format it reads (ValueError in the port,
    None from cv2)."""
    data = _read("j2k_rgb_rev_mct.jp2")
    p = _named(tmp_path, data[:8] + b"\0\0\0\0" + data[12:], "x.exr")
    assert _library(p) is None
    with pytest.raises(ValueError, match="not a format"):
        tio.read_image(p)


def test_size_limit(tmp_path):
    """An image wider than OpenCV's limit (2^20) is refused: cv2.imread
    raises, the port raises ValueError."""
    cs = bytearray(_read("j2k_l_rev.j2k"))
    struct.pack_into(">I", cs, 8, (1 << 20) + 1)      # SIZ's Xsiz
    p = _named(tmp_path, bytes(cs), "x.exr")
    assert _library(p) is None
    with pytest.raises(ValueError, match="size"):
        tio.read_image(p)


@pytest.mark.parametrize("name", ["x.exr", "x.hdr"])
def test_htj2k_and_avif_still_name_their_items(tmp_path, name):
    """HTJ2K code-blocks raise naming 7e.7c on OpenCV's route, AVIF 7e.8."""
    j2k_gen = gen.G
    p = _named(tmp_path, j2k_gen._ht(_read("j2k_rgb_rev.j2k")), name)
    with pytest.raises(NotImplementedError, match=r"7e\.7c"):
        tio.read_image(p)
    p = _named(tmp_path, struct.pack(">I", 28) + b"ftypavif" + bytes(4) +
               b"avifmif1miaf", name)
    with pytest.raises(NotImplementedError, match=r"7e\.8"):
        tio.read_image(p)


def test_lossless_writer():
    """`gen.lossless_jp2` is lossless: random 16-bit RGB at odd sizes
    decodes to itself (B, G, R from OpenCV's route)."""
    g = np.random.default_rng(5)
    for h, w, numres in ((9, 7, 2), (20, 33, 3)):
        img = g.integers(0, 1 << 16, (h, w, 3)).astype(np.uint16)
        out = cvj2k.read_cv(gen.lossless_jp2(img, 16, numres=numres))
        np.testing.assert_array_equal(out[..., ::-1], img)


def test_timing_file(tmp_path):
    """The committed 2048^2 file under a .exr name decodes to the pip
    cv2's decode: its sha256 and corner."""
    p = _named(tmp_path, _read("j2k_2048.jp2"), "x.exr")
    got = tio.read_image(p)[0]
    np.testing.assert_array_equal(_bits(got[:128, :128]),
                                  _bits(DECODES["j2k_2048.jp2:corner"]))
    assert hashlib.sha256(got.tobytes()).digest() == \
        DECODES["j2k_2048.jp2:sha256"].tobytes()


# ---------------------------------------------------------------------------
# the twins
# ---------------------------------------------------------------------------

def test_twins_files():
    """The twins' reference files hold the pip cv2's decodes of their
    JPEG 2000 files; the sky's is sky_a times 1600, rounded (lossless)."""
    for a, b in (("sky_a_j2kcv.exr", "sky_a_j2kcv_ref.exr"),
                 ("projector_j2kcv.hdr", "projector_j2kcv_pfm.hdr")):
        got = tio.read_image(os.path.join(ASSETS, a))[0]
        np.testing.assert_array_equal(_bits(got), _bits(DECODES[a]))
        np.testing.assert_array_equal(
            _bits(got), _bits(tio.read_image(os.path.join(ASSETS, b))[0]))
    ga = gen._assets_module()
    np.testing.assert_array_equal(
        DECODES["sky_a_j2kcv.exr"],
        np.round(ga.sky("a").astype(np.float64) * gen.SKY_SCALE))


@pytest.mark.parametrize("name", ["cbox_sky_j2kcv", "env_sphere_j2kcv"])
def test_twin_scenes_render_as_their_references(name):
    """`cbox_sky_j2kcv` (K1) renders as `cbox_sky_j2kcv_ref`,
    `env_sphere_j2kcv` (K2) as `env_sphere_j2kcv_ref`: the same atlas, the
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


def test_no_module_names_7e7b():
    """No module of the port names slice 7e.7b any more: OpenCV's route
    decodes JPEG 2000."""
    import vision_tpu_torch
    root = pathlib.Path(vision_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        assert not re.search(r"7e\.7b", path.read_text()), path
