"""Slice 7e.8a.1: lossless AVIF on PIL's route, decoded as PIL 12.1.0 over
libavif 1.3.0 and dav1d 1.5.1 decodes it: `scene/avif.py` (the HEIF
container, the OBUs and headers, libavif's YUV to RGB) over
`csrc/av1_codec.cpp` (`native.av1_decode_frame`: the tiles of a lossless
AV1 key frame).

  * The tables of `csrc/av1_codec.cpp` against the libavif library PIL
    ships (`tools/gen_torch_avif.py` `check_tables`).
  * Every file of `tools/gen_torch_avif.py` against PIL's stored decode
    (`avif_decodes.npz`), and a sample against PIL on the spot; the
    `avif_bad_*` files refused as PIL refuses them (a container libavif
    cannot parse passes the file on, as PIL's SyntaxError does); the
    `avif_later_*` files, which PIL decodes, raising NotImplementedError
    naming their ROADMAP sub-item; the committed files reach every coding
    tool the decoder counts.
  * 300 seeded edits, each with PIL's stored outcome (those the port sends
    to a later sub-item counted exactly: `LATER_EDITS`); the 2048^2
    timing file.
  * libavif's YUV to RGB on random planes for each subsampling, range,
    matrix and output (RGB / RGBA), against the library through ctypes.
  * `texture.load_image` against the JAX package's; the twins
    `cbox_tex_avif` (K1) / `env_sphere_avif` (K2); no module naming
    7e.8a.1."""
import hashlib
import importlib.util
import io
import os
import pathlib
import re

import numpy as np
import pytest
from PIL import Image

from tests.torch_scenes import ASSETS
from vision_tpu.scene import texture as jtex
from vision_tpu_torch import native
from vision_tpu_torch.scene import avif
from vision_tpu_torch.scene import imageio as tio
from vision_tpu_torch.scene import pilread
from vision_tpu_torch.scene import texture as ttex

_spec = importlib.util.spec_from_file_location(
    "vt_gen_torch_avif_tests", os.path.join(
        os.path.dirname(ASSETS), "..", "tools", "gen_torch_avif.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

DEC = np.load(os.path.join(ASSETS, "avif_decodes.npz"))
REFUSED = set(DEC[":refused"].tolist())
# the files of `tools/gen_torch_avif.py` (the lossy slice's have their own
# test, tests/test_torch_avif_lossy.py)
FILES = sorted(fn for fn in os.listdir(ASSETS) if fn.endswith(".avif") and
               fn != "avif_2048.avif" and (fn in DEC.files or fn in REFUSED))
# what PIL decodes and the port sends to a later sub-item
# (avif_later_intrabc.avif, intra block copy, decodes since slice 7e.8a.2c.1)
LATER = {"avif_later_10bit.avif": "7e.8a.3",
         "avif_later_prem.avif": "7e.8a.3",
         "avif_later_scaled.avif": "7e.8a.3"}
# the bad files libavif cannot parse (PIL's SyntaxError: the file passes on
# to the next plugin); the others it refuses later (RuntimeError)
PASS_ON = {"avif_bad_brand.avif", "avif_bad_cut_meta.avif",
           "avif_bad_hdlr.avif", "avif_bad_nclx_reserved.avif",
           "avif_bad_noispe.avif", "avif_bad_pixi_av1c.avif"}
# the seeded edits the port sends to a later sub-item: a header edit that
# makes the frame use a lossy tool of 7e.8a.2b or 10-bit samples, or its
# size unlike ispe's. PIL decodes the first; the second it refuses once its
# decoder meets the corruption that sub-item's tools would meet (ROADMAP
# 7e.8a.2a). Edits 1 and 196, which make the frame lossy, are decoded (1)
# and refused (196) as PIL does; edit 190, which switches on intra block
# copy, is refused as PIL refuses it (slice 7e.8a.2c.1).
LATER_EDITS = {22, 109, 118, 172, 220, 223, 244, 298}
LATER_EDITS_PIL_REFUSES = {145, 184, 205}


def _read(fn):
    with open(os.path.join(ASSETS, fn), "rb") as f:
        return f.read()


def _port(data):
    try:
        return pilread.read(data, "x.avif")
    except ValueError:
        return None


def test_tables_are_the_librarys():
    """Every table of csrc/av1_codec.cpp is found in the libavif library
    PIL ships: the default CDFs whole (in libaom's layout, or dav1d's for
    the four libaom keeps otherwise), the prediction, quantiser, scan and
    transform tables in libaom's (intra block copy's, slice 7e.8a.2c.1,
    among them)."""
    found = gen.check_tables()
    assert len(found) == 88
    assert sorted(k for k, v in found.items() if v == "dav1d") == [
        "CFL_SIGN", "PALETTE_UV_MODE", "SEGMENT_ID", "SKIP"]


@pytest.mark.parametrize("fn", FILES)
def test_files_match_pil(fn):
    """Each committed file: the port's `read_image` is PIL's stored decode
    bit for bit, ValueError where PIL refuses it, NotImplementedError
    naming AVIF and the sub-item for a later one."""
    p = os.path.join(ASSETS, fn)
    if fn in LATER:
        assert fn in DEC.files
        with pytest.raises(NotImplementedError,
                           match=f"AVIF.*{re.escape(LATER[fn])}"):
            tio.read_image(p)
    elif fn in REFUSED:
        with pytest.raises(ValueError):
            tio.read_image(p)
    else:
        got = tio.read_image(p)[0]
        np.testing.assert_array_equal(got, DEC[fn])


@pytest.mark.parametrize("fn", FILES[::6])
def test_files_match_pil_on_the_spot(fn):
    """A sixth of the files against PIL here and now (not only the stored
    decodes)."""
    p = os.path.join(ASSETS, fn)
    try:
        with Image.open(p) as im:
            want = np.asarray(im.convert("RGB"))
    except Exception:
        want = None
    if fn in LATER:
        assert want is not None
        return
    np.testing.assert_array_equal(_port(_read(fn)), want)


@pytest.mark.parametrize("fn", sorted(f for f in FILES
                                      if f.startswith("avif_bad_")))
def test_bad_files_refused_as_pil_refuses(fn):
    """The refused files: PIL's SyntaxError at open (libavif's parse
    failed) is the module's PassOn, which `pilread` turns into "no plugin
    identifies it"; PIL's RuntimeError (at open or at load) its
    ValueError."""
    data = _read(fn)
    with pytest.raises(Exception) as e:
        Image.open(io.BytesIO(data)).load()
    opened = e.type.__name__ == "UnidentifiedImageError"
    assert opened == (fn in PASS_ON)
    with pytest.raises(avif.PassOn if fn in PASS_ON else ValueError):
        avif.read(data)
    with pytest.raises(ValueError):
        pilread.read(data, "x.avif")


def test_files_reach_every_tool():
    """The committed files reach every coding tool the decoder counts:
    each Y and UV mode, each angle delta, each filter-intra mode, palettes
    of 2-8 colours in Y and UV, the colour cache, V's delta coding, each
    partition, both edge-filter strengths of a 4x4 block, edge upsampling
    and the Golomb tail (aom's lossless frames have no skip blocks and no
    segments: seeded edits reach those)."""
    native.av1_coverage(reset=True)
    for fn in FILES:
        if fn not in REFUSED and fn not in LATER:
            pilread.read(_read(fn), "x.avif")
    c = native.av1_coverage()
    assert (c[0:65] > 0).all(), np.nonzero(c[0:65] == 0)
    assert (c[65:67] > 0).all() and c[68] > 0 and c[69] > 0


def test_orientation_is_metadata():
    """Exif orientation 6 (libavif's `irot`) leaves the pixels as coded:
    PIL gives the frame unrotated, and so does the port."""
    data = _read("avif_exif_orient6.avif")
    assert b"irot" in data
    got = _port(data)
    assert got.shape == DEC["avif_noise_420.avif"].shape
    np.testing.assert_array_equal(got, DEC["avif_exif_orient6.avif"])


# ---------------------------------------------------------------------------
# seeded edits, the timing file
# ---------------------------------------------------------------------------

EDITS = gen.edit_cases({fn: _read(fn) for fn in gen.EDIT_SOURCES})


@pytest.mark.parametrize("case", range(15))
def test_seeded_edits_match_pil(case):
    """Twenty of the 300 seeded edits (cuts, byte replacements, bit flips: a
    third in the container, a third in the AV1 headers, a third in the tile
    data): the port's outcome (its decode's digest, or a refusal) is PIL's
    stored one; the edits in LATER_EDITS (which PIL decodes) and
    LATER_EDITS_PIL_REFUSES raise NotImplementedError naming a later
    sub-item."""
    want = DEC["edits:sha256"]
    assert len(want) == len(EDITS) == 300
    for i in range(case * 20, case * 20 + 20):
        fn, data = EDITS[i]
        if i in LATER_EDITS | LATER_EDITS_PIL_REFUSES:
            assert want[i].any() == (i in LATER_EDITS), (fn, i)
            with pytest.raises(NotImplementedError, match=r"AVIF.*7e\.8a\."):
                pilread.read(data, "x.avif")
            continue
        assert gen.digest(_port(data)) == want[i].tobytes(), (fn, i)


def test_timing_file():
    """The committed 2048^2 lossless file (autotiled) decodes to PIL's
    decode: its sha256 and 128 x 128 corner."""
    got = tio.read_image(os.path.join(ASSETS, "avif_2048.avif"))[0]
    assert got.shape == (2048, 2048, 3)
    np.testing.assert_array_equal(got[:128, :128],
                                  DEC["avif_2048.avif:corner"])
    assert hashlib.sha256(got.tobytes()).digest() == \
        DEC["avif_2048.avif:sha256"].tobytes()


def _leb128(n):
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out)


def test_symbol_overread_is_refused():
    """A tile whose symbols run past its data is refused, as dav1d
    refuses it: the frame OBU of a one-tile item with its last 600 bytes
    cut off (and its size rewritten)."""
    data = _read("avif_noise_444.avif")
    item = data[data.find(b"mdat") + 4:]
    planes, _ = avif.decode_av1(item)
    assert planes[0].shape == (37, 53)
    cut = b""
    for typ, _, _, start, end in avif._obus(item):
        if typ == avif.OBU_FRAME:
            end -= 600
        cut += bytes([typ << 3 | 2]) + _leb128(end - start) + item[start:end]
    with pytest.raises(ValueError, match="past its data"):
        avif.decode_av1(cut)


# ---------------------------------------------------------------------------
# libavif's YUV to RGB on random planes
# ---------------------------------------------------------------------------

_FORMATS = {"444": (0, 0), "422": (1, 0), "420": (1, 1), "400": None}


@pytest.mark.parametrize("fmt", list(_FORMATS))
@pytest.mark.parametrize("full", [0, 1])
@pytest.mark.parametrize("mc,cp", [(0, 1), (1, 1), (2, 2), (4, 1), (5, 5),
                                   (6, 6), (7, 7), (8, 1), (9, 9), (12, 1),
                                   (12, 2), (12, 5), (12, 9), (3, 1),
                                   (10, 9), (255, 1)])
def test_yuv_to_rgb_is_libavifs(fmt, full, mc, cp):
    """`avif.yuv_to_rgb` of random planes at odd and even sizes, to RGB
    and to RGBA, is libavif's avifImageYUVToRGB (called through ctypes)
    bit for bit: libyuv's integer route where libavif finds its matrix,
    libavif's float route elsewhere; ValueError where libavif's reformat
    fails."""
    g = np.random.default_rng(hash((fmt, full, mc, cp)) % 2**32)
    for h, w in ((1, 1), (2, 3), (9, 11), (8, 16), (17, 6)):
        y = g.integers(0, 256, (h, w), dtype=np.uint8)
        ss = _FORMATS[fmt]
        u = v = None
        ssx = ssy = 1
        if ss is not None:
            ssx, ssy = ss
            u = g.integers(0, 256, ((h + ssy) >> ssy, (w + ssx) >> ssx),
                           dtype=np.uint8)
            v = g.integers(0, 256, u.shape, dtype=np.uint8)
        for rgba in (False, True):
            want = gen.libavif_yuv_to_rgb(y, u, v, ssx, ssy, full, mc, cp,
                                          rgba)
            if want is None:
                with pytest.raises(ValueError):
                    avif.yuv_to_rgb(y, u, v, ssx, ssy, full, mc, cp, rgba)
                continue
            got = avif.yuv_to_rgb(y, u, v, ssx, ssy, full, mc, cp, rgba)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{h}x{w} rgba={rgba}")


# ---------------------------------------------------------------------------
# the JAX package's loader, the twins, the roadmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", [f for f in FILES if f not in REFUSED and
                                f not in LATER][::10])
def test_load_image_matches_jax(fn):
    """`texture.load_image` of the files: the JAX package's (PIL's decode,
    linearised the same way), bit for bit."""
    p = os.path.join(ASSETS, fn)
    np.testing.assert_array_equal(ttex.load_image(p, "srgb"),
                                  jtex.load_image(p, "srgb"))


def test_twins_files():
    """The twins' PNGs hold PIL's decodes of their AVIF files, which the
    port gives."""
    for fn in ("checker_avif.avif", "projector_avif.avif"):
        got = tio.read_image(os.path.join(ASSETS, fn))[0]
        np.testing.assert_array_equal(got, DEC[fn])
        np.testing.assert_array_equal(got, tio.read_image(os.path.join(
            ASSETS, fn.replace(".avif", "_pil.png")))[0])


@pytest.mark.parametrize("name,ref", [("cbox_tex_avif", "cbox_tex_avif_ref"),
                                      ("env_sphere_avif",
                                       "env_sphere_avif_ref")])
def test_twin_scenes_render_as_their_references(name, ref):
    """`cbox_tex_avif` (K1) renders as `cbox_tex_avif_ref`, and
    `env_sphere_avif` (K2) as `env_sphere_avif_ref`: the same atlas, the
    same render, bit for bit (16^2, 1 spp on the CPU); and the twin's
    tables equal the JAX Scene's."""
    import torch
    import vision_tpu_torch as vt
    from tests import torch_scenes as ts
    from tests.test_torch_scene import _assert_same_scene
    from tests.torch_parity import jax_scene_arrays
    from vision_tpu.scene.scene import Scene as JScene
    kw = dict(sub_div=8) if name.startswith("env") else {}
    a = vt.load_scene(getattr(ts, ref)(16, **kw), device="cpu")
    desc = getattr(ts, name)(16, **kw)
    b = vt.load_scene(desc, device="cpu")
    assert torch.equal(a.data.atlas.data, b.data.atlas.data)
    assert torch.equal(vt.render(a, spp=1), vt.render(b, spp=1))
    _assert_same_scene(b.data, b.camera, b.filter,
                       jax_scene_arrays(JScene(desc)))


def test_no_module_names_7e8a1():
    """No module of the port names slice 7e.8a.1 as still to come: lossless
    AVIF decodes, and what it does not raises naming 7e.8a.2 or 7e.8a.3."""
    import vision_tpu_torch
    root = pathlib.Path(vision_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        assert not re.search(r"7e\.8a\.1", path.read_text()), path
