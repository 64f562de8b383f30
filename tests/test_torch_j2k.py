"""Slice 7e.7a: JPEG 2000 (Part 1) on PIL's route, as the JAX package's
loader gets it under any name but .hdr / .exr: `PIL.Image.open(p)
.convert("RGB")`, PIL 12.1.0 over OpenJPEG 2.5.4 (`scene/j2k.py`,
`csrc/j2k_codec.cpp`).

  * The committed files of `tools/gen_torch_j2k.py` against
    `j2k_decodes.npz` and against PIL on the spot: PIL's encoder (every
    mode, 5/3 and 9/7, MCT, the five progressions, tiles and offsets,
    code-block and precinct sizes, layers, signed samples, PLT, comments)
    and the generator's own writer (every code-block style, ROI, SOP /
    EPH, COC / QCC, POC, PPM / PPT, tile-parts, precisions, quantisation
    styles, sub-sampled components); JP2 boxes for CMYK, sYCC, P and PA,
    ICC and unknown colour spaces; the `j2k_bad_*` files refused by both.
  * 300 seeded byte edits and cuts, each with PIL's outcome (an edit that
    sets the HT code-block bit too: slice 7e.7c decodes HT blocks, and
    refuses what PIL refuses).
  * ICNS's JPEG 2000 icons; a Part 1 codestream with the HT bit refused
    as both libraries refuse it, OpenCV's route giving
    the pip cv2's decode (slice 7e.7b, `tests/test_torch_j2k_cv.py`);
    `texture.load_image` against the JAX package's; the 2048^2 timing
    file; the twins `cbox_tex_j2k` (K1) / `env_sphere_j2k` (K2)."""
import hashlib
import importlib.util
import io
import os
import warnings

import numpy as np
import pytest
from PIL import Image

from tests.torch_scenes import ASSETS
from vision_tpu.scene import texture as jtex
from vision_tpu_torch.scene import imageio as tio
from vision_tpu_torch.scene import j2k
from vision_tpu_torch.scene import texture as ttex

warnings.filterwarnings("ignore", category=UserWarning, module="PIL")

_spec = importlib.util.spec_from_file_location(
    "vt_gen_torch_j2k_tests", os.path.join(os.path.dirname(ASSETS), "..",
                                           "tools", "gen_torch_j2k.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

DECODES = np.load(os.path.join(ASSETS, "j2k_decodes.npz"))
FILES = sorted(k for k in DECODES.files if ":" not in k)
BAD = sorted(fn for fn in os.listdir(ASSETS) if fn.startswith("j2k_bad_"))


def _pil(path_or_bytes):
    """PIL's convert("RGB"), or None where it raises."""
    src = path_or_bytes if isinstance(path_or_bytes, str) else \
        io.BytesIO(path_or_bytes)
    try:
        with Image.open(src) as im:
            return np.asarray(im.convert("RGB"))
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
    return want.shape == got.shape and np.array_equal(want, got)


@pytest.mark.parametrize("fn", FILES)
def test_committed_files_match_their_decodes(fn):
    """Each committed file decodes to its committed PIL decode, bit for
    bit, and PIL here still decodes it so."""
    p = os.path.join(ASSETS, fn)
    got = tio.read_image(p)
    assert got[1] == "ldr"
    np.testing.assert_array_equal(got[0], DECODES[fn])
    np.testing.assert_array_equal(_pil(p), DECODES[fn])


@pytest.mark.parametrize("fn", BAD)
def test_refused_files(fn):
    """The files PIL refuses (a cut stream, a missing EOC, EPH-less
    packets, precincts of exponent 0, a palette of 12-bit columns, EYCC,
    sizes that disagree, MCT over components of other sizes, a grey
    sub-sampled component) are refused: ValueError."""
    p = os.path.join(ASSETS, fn)
    assert _pil(p) is None
    with pytest.raises(ValueError):
        tio.read_image(p)


def test_the_matrix_is_whole():
    """The generated files cover what the slice claims."""
    want = {"j2k_l_rev.j2k", "j2k_la_irr.j2k", "j2k_i16_irr.j2k",
            "j2k_rgba_irr_mct.j2k", "j2k_cmyk.jp2", "j2k_sycc.jp2",
            "j2k_p3.jp2", "j2k_pa.jp2", "j2k_prg_cprl.jp2",
            "j2k_tiles_offset.j2k", "j2k_layers_irr.jp2", "j2k_prec_16.jp2",
            "j2k_sty_all.j2k", "j2k_roi.j2k", "j2k_sop_eph.j2k",
            "j2k_coc_qcc.j2k", "j2k_poc.j2k", "j2k_ppm.j2k", "j2k_ppt.j2k",
            "j2k_sub_420.j2k", "j2k_prec12.j2k", "j2k_q_derived.j2k",
            "j2k_icns.icns", "checker_j2k.jp2", "projector_j2k.j2k"}
    assert want <= set(FILES)
    for style in ("bypass", "reset", "termall", "vsc", "pterm", "segsym"):
        assert f"j2k_sty_{style}.j2k" in FILES


# ---------------------------------------------------------------------------
# seeded edits
# ---------------------------------------------------------------------------

EDIT_SOURCES = ("j2k_rgb_irr_mct.jp2", "j2k_prg_pcrl.jp2", "j2k_sty_all.j2k",
                "j2k_sop_eph.j2k", "j2k_p3.jp2", "j2k_sub_420.j2k",
                "j2k_ppm.j2k", "j2k_roi.j2k", "j2k_la_irr.j2k",
                "j2k_tiles_offset.j2k", "j2k_ppt.j2k", "j2k_poc.j2k",
                "j2k_sty_bypass_termall.j2k", "j2k_cmyk.jp2",
                "j2k_parts.j2k")


@pytest.mark.parametrize("case", range(30))
def test_seeded_edits_match_pil(tmp_path, case):
    """Ten seeded cuts, byte replacements or bit flips of one committed
    file each: the port gives PIL's outcome (the same pixels, or
    ValueError where PIL raises), an edit that sets the HT code-block bit
    included (its Part 1 blocks read as HT blocks)."""
    g = np.random.default_rng(7700 + case)
    fn = EDIT_SOURCES[case % len(EDIT_SOURCES)]
    with open(os.path.join(ASSETS, fn), "rb") as f:
        src = f.read()
    ext = os.path.splitext(fn)[1]
    for k in range(10):
        d = bytearray(src)
        kind = int(g.integers(3))
        if kind == 0:
            d = d[:int(g.integers(1, len(d)))]
        else:
            for _ in range(int(g.integers(1, 3))):
                i = int(g.integers(0, len(d)))
                d[i] = int(g.integers(0, 256)) if kind == 1 else \
                    d[i] ^ (1 << int(g.integers(8)))
        p = str(tmp_path / f"e{k}{ext}")
        with open(p, "wb") as f:
            f.write(bytes(d))
        assert _same(_pil(p), _port(p)), (fn, k, kind)


# ---------------------------------------------------------------------------
# ICNS, HTJ2K, OpenCV's route, the JAX package's loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["j2k_icns.icns", "j2k_icns_j2k.icns",
                                "j2k_icns_i16.icns"])
def test_icns_jpeg2000_icons(fn):
    """An ICNS file whose icon is a JP2 file or a bare codestream decodes
    as PIL decodes it (Jpeg2KImageFile, then RGBA, then RGB)."""
    p = os.path.join(ASSETS, fn)
    np.testing.assert_array_equal(tio.read_image(p)[0], _pil(p))


def test_icns_icon_of_another_size_is_refused(tmp_path):
    """A JPEG 2000 icon of a size the file does not list: PIL's size
    setter refuses it, and so does the port."""
    b = io.BytesIO()
    Image.fromarray(np.zeros((9, 9, 3), np.uint8)).save(b, "JPEG2000")
    data = gen.icns_file([(b"icp4", b.getvalue())])
    p = tmp_path / "x.icns"
    p.write_bytes(data)
    assert _pil(str(p)) is None
    with pytest.raises(ValueError):
        tio.read_image(str(p))


@pytest.mark.parametrize("name", ["x.j2k", "x.exr", "x.hdr"])
def test_htj2k_names_7e7c(tmp_path, name):
    """A Part 1 codestream whose COD asks for HT code-blocks (Part 15):
    its MQ-coded blocks read as HT blocks are malformed, PIL (x.j2k) and
    the pip cv2 (x.exr, x.hdr) refuse it, and so does the port on each
    route (slice 7e.7c decodes HT code-blocks: `tests/test_torch_j2k_ht.py`
    holds the files that decode)."""
    with open(os.path.join(ASSETS, "j2k_rgb_rev.j2k"), "rb") as f:
        data = gen._ht(f.read())
    p = tmp_path / name
    p.write_bytes(data)
    if name == "x.j2k":
        assert _pil(str(p)) is None
    else:
        try:
            assert jtex.load_image(str(p)) is None
        except Exception:     # the JAX package's loader catches every error
            pass
    with pytest.raises(ValueError, match="HT code-block"):
        tio.read_image(str(p))


@pytest.mark.parametrize("fn", ["j2k_rgb_rev.j2k", "checker_j2k.jp2"])
def test_opencvs_route_names_7e7b(tmp_path, fn):
    """A JPEG 2000 file under a .exr name goes to OpenCV's reader by the
    JAX package's rule (slice 7e.7b, `cvj2k`): the pip cv2's decode as
    `j2k_cv_decodes.npz` holds it, not PIL's."""
    p = tmp_path / "x.exr"
    with open(os.path.join(ASSETS, fn), "rb") as f:
        p.write_bytes(f.read())
    got, kind = tio.read_image(str(p))
    assert kind == "hdr"
    want = np.load(os.path.join(ASSETS, "j2k_cv_decodes.npz"))[fn]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", FILES[::4] + ["checker_j2k.jp2",
                                             "projector_j2k.j2k",
                                             "j2k_icns.icns"])
def test_load_image_matches_jax(fn):
    """`texture.load_image` of the committed files: the JAX package's
    (PIL's decode, linearised the same way), bit for bit."""
    p = os.path.join(ASSETS, fn)
    np.testing.assert_array_equal(ttex.load_image(p, "srgb"),
                                  jtex.load_image(p, "srgb"))


def test_timing_file_matches_pil():
    """The committed 2048^2 file (9/7, six resolutions, 64 x 64
    code-blocks, one layer of about 0.5 bits a pixel) decodes to PIL's
    decode: its sha256 and corner."""
    with open(os.path.join(ASSETS, "j2k_2048.jp2"), "rb") as f:
        data = f.read()
    assert 200_000 < len(data) < 300_000
    got = j2k.read(data)
    np.testing.assert_array_equal(got[:128, :128],
                                  DECODES["j2k_2048.jp2:corner"])
    assert hashlib.sha256(got.tobytes()).digest() == \
        DECODES["j2k_2048.jp2:sha256"].tobytes()


# ---------------------------------------------------------------------------
# the twins
# ---------------------------------------------------------------------------

def test_twins_files():
    """The twins' PNGs hold PIL's decodes of their JPEG 2000 files."""
    for a, b in (("checker_j2k.jp2", "checker_j2k_pil.png"),
                 ("projector_j2k.j2k", "projector_j2k_pil.png")):
        np.testing.assert_array_equal(
            tio.read_image(os.path.join(ASSETS, a))[0],
            tio.read_image(os.path.join(ASSETS, b))[0])


@pytest.mark.parametrize("name", ["cbox_tex_j2k", "env_sphere_j2k"])
def test_twin_scenes_render_as_their_references(name):
    """`cbox_tex_j2k` (K1) renders as `cbox_tex_j2k_ref`, `env_sphere_j2k`
    (K2) as `env_sphere_j2k_ref`: the same atlas, the same render, bit for
    bit (64^2, 1 spp on the CPU); and the twin's tables equal the JAX
    Scene's."""
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


def test_7e7_is_left_for_opencvs_route_only():
    """No module of the port names the whole of 7e.7 any more: PIL's route
    decodes (7e.7a), and so does OpenCV's (7e.7b), HTJ2K too (7e.7c)."""
    import pathlib
    import re
    import vision_tpu_torch
    root = pathlib.Path(vision_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        assert not re.search(r"7e\.7(?![a-d])", path.read_text()), path
