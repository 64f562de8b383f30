"""Slice 7e.7d: JPEG 2000 Part 2's markers (CBD, MCT, MCC, MCO) and tiles
with fewer resolutions than an earlier tile, on PIL's route (PIL 12.1.0
over OpenJPEG 2.5.4, any name) and OpenCV's (the pip cv2 5.0.0 over
OpenJPEG 2.5.3, .hdr / .exr names): `scene/j2k.py` `_Codestream` (`_cbd`,
`_mct`, `_mcc`, `_mco`, each tile's DC level shifts in `_Tcp.shifts`),
`_tier2`'s resno_decoded taken afresh in each tile.

  * Every file of `tools/gen_torch_j2k_p2.py` against its stored decodes
    (`j2k_decodes.npz`, `j2k_cv_decodes.npz`) and against PIL and the JAX
    package's cv2 loader on the spot; the refused ones refused.
  * 200 seeded edits on each route, each with the library's stored
    outcome; the tile-resolution files' five runs in child processes.
  * The rules the files show, `texture.load_image` against the JAX
    package's, the twins `cbox_tex_j2kp2` (K1) / `env_sphere_j2kp2cv`
    (K2), and no module naming 7e.7d."""
import importlib.util
import os
import pathlib
import re
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
    "vt_gen_torch_j2k_p2_tests", os.path.join(
        os.path.dirname(ASSETS), "..", "tools", "gen_torch_j2k_p2.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

PIL_DEC = np.load(os.path.join(ASSETS, "j2k_decodes.npz"))
CV_DEC = np.load(os.path.join(ASSETS, "j2k_cv_decodes.npz"))
CV_REFUSED = set(CV_DEC[":refused"].tolist())
FILES = sorted(fn for fn in os.listdir(ASSETS)
               if fn.startswith(("j2k_p2_", "j2k_bad_p2_")))
RES = [fn for fn in FILES if "_p2_res_" in fn]


def _read(fn):
    with open(os.path.join(ASSETS, fn), "rb") as f:
        return f.read()


def _pil(path):
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except Exception:       # the JAX package's loader catches every error
        return None


def _cv2(path):
    """What the JAX package's loader gets through the pip cv2 (a .exr or
    .hdr name), or None where it raises."""
    try:
        return jtex.load_image(path)
    except Exception:       # the JAX package's loader catches every error
        return None


def _port(path):
    try:
        return tio.read_image(path)[0]
    except ValueError:
        return None


def _same(want, got):
    if want is None or got is None:
        return want is None and got is None
    return want.shape == got.shape and np.array_equal(
        np.asarray(want, np.float32), np.asarray(got, np.float32))


def _named(tmp_path, fn, name):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(_read(fn))
    return p


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", FILES)
def test_files_match_the_libraries(tmp_path, fn):
    """Each file on PIL's route (by its own name) gives PIL's stored decode
    and PIL's decode here, or both refuse it (the `j2k_bad_p2_*` files);
    under a .exr and a .hdr name it gives the pip cv2's stored decode and
    what the JAX package's loader gets here, or both refuse it."""
    p = os.path.join(ASSETS, fn)
    want = None if fn.startswith("j2k_bad_") else PIL_DEC[fn]
    got = _port(p)
    assert _same(want, got)
    assert _same(_pil(p), got)
    want = None if fn in CV_REFUSED else CV_DEC[fn]
    for name in ("x.exr", "x.hdr"):
        got = _port(_named(tmp_path, fn, name))
        assert _same(want, got), name
    assert _same(_cv2(_named(tmp_path, fn, "y.exr")), got)


def test_the_matrix_is_whole():
    """The files cover what the slice claims on each route: CBD of lower,
    higher, signed and mixed precisions (bare, in JP2 with ihdr / bpcc,
    I;16, 9/7), every MCT element type as offsets, MCC's forms, MCO's
    places and the orders OpenJPEG does not take, tile-part MCOs, and
    tiles of fewer resolutions; the refusals of both libraries."""
    claimed = {
        "j2k_p2_cbd_same.j2k", "j2k_p2_cbd7.j2k", "j2k_p2_cbd_signed.j2k",
        "j2k_p2_cbd12.j2k", "j2k_p2_cbd_mixed.j2k", "j2k_p2_cbd5_grey.j2k",
        "j2k_p2_cbd20.jp2", "j2k_p2_cbd_bpcc.jp2", "j2k_p2_cbd_i16.jp2",
        "j2k_p2_cbd_irr.jp2", "j2k_p2_mct_inert.j2k", "j2k_p2_mco_alone.j2k",
        "j2k_p2_mco_offsets.j2k", "j2k_p2_mco_int16.j2k",
        "j2k_p2_mco_int32.j2k", "j2k_p2_mco_f32.j2k", "j2k_p2_mco_f64.jp2",
        "j2k_p2_mco_end.j2k", "j2k_p2_mco_tile.j2k",
        "j2k_p2_mco_second.j2k", "j2k_p2_mco_before_mcc.j2k",
        "j2k_p2_mco_before_cod.j2k", "j2k_p2_mco_stages2.j2k",
        "j2k_p2_mcc_ncomp.j2k", "j2k_p2_mcc_xmcc0.j2k",
        "j2k_p2_mcc_wide.j2k", "j2k_p2_mcc_qmcc2.j2k",
        "j2k_p2_mct_replaced.j2k", "j2k_p2_matrix_mct1.j2k",
        "j2k_p2_zmct.j2k", "j2k_p2_tiles_mco.j2k", "j2k_p2_grey12_mco.j2k",
        "j2k_p2_res_3_2.j2k", "j2k_p2_res_4123.j2k", "j2k_p2_res_coc.j2k",
        "j2k_p2_res_poc.j2k", "j2k_p2_res_irr.j2k"}
    refused = {"j2k_bad_p2_cbd_ncbd.j2k", "j2k_bad_p2_cbd_two.j2k",
               "j2k_bad_p2_cbd_prec.j2k", "j2k_bad_p2_mcc_missing.j2k",
               "j2k_bad_p2_mct_size.j2k", "j2k_bad_p2_mct_ymct.j2k",
               "j2k_bad_p2_mcc_size.j2k", "j2k_bad_p2_mco_size.j2k",
               "j2k_bad_p2_res_mct.j2k"}
    assert claimed | refused == set(FILES)
    assert claimed <= set(PIL_DEC.files) and not refused & set(PIL_DEC.files)
    # OpenCV refuses what PIL refuses, and precisions it has no Mat for
    assert CV_REFUSED & set(FILES) == refused | {
        "j2k_p2_cbd7.j2k", "j2k_p2_cbd_signed.j2k", "j2k_p2_cbd_mixed.j2k",
        "j2k_p2_cbd5_grey.j2k", "j2k_p2_cbd20.jp2"}


# ---------------------------------------------------------------------------
# the rules the files show
# ---------------------------------------------------------------------------

def _pil_of(fn):
    return tio.read_image(os.path.join(ASSETS, fn))[0].astype(np.int64)


def test_cbd_keeps_sizs_level_shift():
    """A 12-bit CBD over an 8-bit codestream: OpenCV gets the 8-bit
    samples in a 16-bit Mat (SIZ's shift of 128, the clamp at 4095), and
    PIL shifts them from 12 bits to 8."""
    base = CV_DEC["j2k_rgb_rev_mct.jp2"]
    np.testing.assert_array_equal(CV_DEC["j2k_p2_cbd12.j2k"], base)
    np.testing.assert_array_equal(
        _pil_of("j2k_p2_cbd12.j2k"),
        (_pil_of("j2k_rgb_rev_mct.jp2") + 8) >> 4)


def _shifted(base, offsets):
    """A decode of 8-bit samples whose DC level shift was 128, with each
    channel's shift made `offsets[c]` instead (None: not checked), where
    nothing clamped it -> (expected, mask)."""
    plain = (base > 0) & (base < 255)
    want = base.copy()
    mask = np.zeros(base.shape, bool)
    for c, off in enumerate(offsets):
        if off is not None:
            want[..., c] = np.clip(base[..., c] - 128 + off, 0, 255)
            mask[..., c] = plain[..., c]
    return want, mask


@pytest.mark.parametrize("fn,offsets", [
    ("j2k_p2_mco_alone.j2k", (0, 0, 0)),
    ("j2k_p2_mco_second.j2k", (0, 0, 0)),
    ("j2k_p2_mco_before_mcc.j2k", (0, 0, 0)),
    ("j2k_p2_mcc_ncomp.j2k", (0, 0, 0)),
    ("j2k_p2_mcc_xmcc0.j2k", (0, 0, 0)),
    ("j2k_p2_mcc_qmcc2.j2k", (0, 0, 0)),
    ("j2k_p2_zmct.j2k", (0, 0, 0)),
    ("j2k_p2_mco_end.j2k", (100, 100, 100)),
    ("j2k_p2_mco_tile.j2k", (100, 100, 100)),
    ("j2k_p2_mco_before_cod.j2k", (100, 100, 100)),
    ("j2k_p2_mcc_wide.j2k", (100, 100, 100)),
    ("j2k_p2_mct_replaced.j2k", (20, 40, 60)),
    ("j2k_p2_mco_int16.j2k", (65535, 200, 60)),
    ("j2k_p2_mco_f32.j2k", (99, 0, None)),
    ("j2k_p2_mct_inert.j2k", (128, 128, 128)),
    ("j2k_p2_mco_stages2.j2k", (128, 128, 128))])
def test_an_mco_sets_the_level_shift(fn, offsets):
    """Over `j2k_rgb_rev.j2k` (5/3, no MCT): an MCO resets each component's
    DC level shift to 0, and the offset array of the first MCC, where it
    names that one and the MCC covers every component, sets it (an int16
    as its unsigned 16 bits, a float truncated); an MCO of two stages is
    not taken, and MCT / MCC without an MCO change nothing."""
    want, mask = _shifted(_pil_of("j2k_rgb_rev.j2k"), offsets)
    got = _pil_of(fn)
    assert mask.any()
    np.testing.assert_array_equal(got[mask], want[mask])


def test_tile_mcos_shift_their_tiles():
    """`j2k_p2_tiles_mco.j2k` is PIL's tiled codestream with MCT / MCC /
    MCO in the tile-part headers of tiles 1-3: each tile keeps its own
    shift (SIZ's 128, int16 offsets, none, float32 offsets truncated),
    against the same codestream without them."""
    G = gen._j2k_module()
    img = G._smooth(np.random.default_rng(gen.SEED), 40, 44, 3)
    plain = tio._read_pil(G.pil_encode(img, tile_size=(24, 20), mct=1,
                                       no_jp2=True), "x.j2k").astype(np.int64)
    got = _pil_of("j2k_p2_tiles_mco.j2k")
    top, bottom, left, right = (slice(0, 20), slice(20, 40), slice(0, 24),
                                slice(24, 44))
    for (ys, xs), offsets in (((top, left), (128,) * 3),
                              ((top, right), (100, 128, 160)),
                              ((bottom, left), (0, 0, 0)),
                              ((bottom, right), (140, 90, 200))):
        want, mask = _shifted(plain[ys, xs], offsets)
        assert mask.any()
        np.testing.assert_array_equal(got[ys, xs][mask], want[mask])


# ---------------------------------------------------------------------------
# seeded edits and the tile-resolution runs
# ---------------------------------------------------------------------------

EDITS = gen.edit_cases({fn: _read(fn) for fn in gen.EDIT_SOURCES})


@pytest.mark.parametrize("route", ["pil", "cv"])
@pytest.mark.parametrize("case", range(10))
def test_seeded_edits_match_the_libraries(route, case):
    """Twenty of the 200 seeded edits (cuts, byte replacements, bit flips,
    two in three inside the headers): the port's outcome on the route
    (its decode's digest, or a refusal) is the library's stored one."""
    want = (PIL_DEC if route == "pil" else CV_DEC)["p2edits:sha256"]
    assert len(want) == len(EDITS) == 200
    for i in range(case * 20, case * 20 + 20):
        fn, data = EDITS[i]
        try:
            got = tio._read_pil(data, "x.j2k") if route == "pil" else \
                tio._read_opencv(data, "x.exr")
        except ValueError:
            got = None
        assert gen.digest(got) == want[i].tobytes(), (fn, i)


@pytest.mark.parametrize("fn", RES)
def test_tile_resolution_runs(fn):
    """Each library decoded each tile-resolution file five times, each in a
    child process of its own, to the same outcome (the stored digests);
    that outcome is the stored decode, and the port's."""
    for dec, route in ((PIL_DEC, "pil"), (CV_DEC, "cv")):
        runs = dec[fn + ":runs"]
        assert runs.shape == (gen.RES_RUNS, 32)
        assert (runs == runs[0]).all()
        refused = fn.startswith("j2k_bad_") if route == "pil" else \
            fn in CV_REFUSED
        assert gen.digest(None if refused else dec[fn]) == runs[0].tobytes()
        data = _read(fn)
        try:
            got = tio._read_pil(data, fn) if route == "pil" else \
                tio._read_opencv(data, "x.exr")
        except ValueError:
            got = None
        assert gen.digest(got) == runs[0].tobytes(), route


# ---------------------------------------------------------------------------
# the JAX package's loader, the twins, the roadmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", [f for f in FILES if not f.startswith(
    "j2k_bad_")][::3] + ["checker_j2kp2.jp2"])
def test_load_image_matches_jax(fn):
    """`texture.load_image` of the files: the JAX package's (PIL's decode,
    linearised the same way), bit for bit."""
    p = os.path.join(ASSETS, fn)
    np.testing.assert_array_equal(ttex.load_image(p, "srgb"),
                                  jtex.load_image(p, "srgb"))


def test_twins_files():
    """The twins' reference files hold the libraries' decodes of their
    files: PIL's of checker_j2kp2.jp2 as a PNG, the pip cv2's of
    projector_j2kp2cv.exr as a PFM named .hdr."""
    for a, b in (("checker_j2kp2.jp2", "checker_j2kp2_pil.png"),
                 ("projector_j2kp2cv.exr", "projector_j2kp2cv_pfm.hdr")):
        got = tio.read_image(os.path.join(ASSETS, a))[0]
        np.testing.assert_array_equal(
            got, tio.read_image(os.path.join(ASSETS, b))[0])
    np.testing.assert_array_equal(
        tio.read_image(os.path.join(ASSETS, "projector_j2kp2cv.exr"))[0],
        CV_DEC["projector_j2kp2cv.exr"])
    np.testing.assert_array_equal(
        tio.read_image(os.path.join(ASSETS, "checker_j2kp2.jp2"))[0],
        PIL_DEC["checker_j2kp2.jp2"])


@pytest.mark.parametrize("name", ["cbox_tex_j2kp2", "env_sphere_j2kp2cv"])
def test_twin_scenes_render_as_their_references(name):
    """`cbox_tex_j2kp2` (K1) renders as `cbox_tex_j2kp2_ref`,
    `env_sphere_j2kp2cv` (K2) as `env_sphere_j2kp2cv_ref`: the same atlas,
    the same render, bit for bit (64^2, 1 spp on the CPU); and the twin's
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


def test_no_module_names_7e7d():
    """No module of the port names slice 7e.7d any more: Part 2's markers
    and tiles of fewer resolutions decode, or are refused as the libraries
    refuse them."""
    import vision_tpu_torch
    root = pathlib.Path(vision_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        assert not re.search(r"7e\.7d", path.read_text()), path

