"""Slice 7e.8a.2c.1: AVIF key frames with intra block copy on PIL's route,
as PIL 12.1.0's default save writes them for flat and screen-like images,
decoded as PIL over libavif 1.3.0 and dav1d 1.5.1 decodes them:
`scene/avif.py` (`allow_intrabc` and what it leaves unread) over
`csrc/av1_codec.cpp` (the displacement vector's reference stack, its MV
coding and dav1d's clip, the copy with chroma's half samples, the var-tx
tree, the inter transform sets with flipped ADST and identity 32).

  * The new tables of `csrc/av1_codec.cpp` against the libavif library PIL
    ships (`tools/gen_torch_avif.py` `check_tables`).
  * Every file of `tools/gen_torch_avif_ibc.py` against PIL's stored
    decode (`avifibc_decodes.npz`), a sample against PIL on the spot; the
    header fields each carries; the committed files reach every path of
    intra block copy the decoder counts.
  * 300 seeded edits, each with PIL's stored outcome (those the port sends
    to a later sub-item counted exactly: `LATER_EDITS`); dav1d's clip of a
    vector outside the decoded area and its refusal of one into the
    current superblock, held to PIL's outcome by the edits; superres and
    film grain naming 7e.8a.2c.2; the 2048^2 timing file.
  * `texture.load_image` against the JAX package's; the twins
    `cbox_tex_avifibc` (K1) / `env_sphere_avifibc` (K2); no module naming
    7e.8a.2c without its part."""
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
    "vt_gen_torch_avif_ibc_tests", os.path.join(
        os.path.dirname(ASSETS), "..", "tools", "gen_torch_avif_ibc.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

DEC = np.load(os.path.join(ASSETS, "avifibc_decodes.npz"))
FILES = sorted(k for k in DEC.files if ":" not in k)
# the seeded edits the port sends to a later sub-item (header edits that
# switch on a tool of 7e.8a.2b, a 10-bit depth or a frame size unlike
# ispe's): PIL decodes the first set and refuses the second once dav1d's
# decode with that tool meets the corruption
LATER_EDITS = {10: "7e.8a.3", 49: "7e.8a.2b", 70: "7e.8a.3", 73: "7e.8a.3",
               121: "7e.8a.2b", 160: "7e.8a.2b", 184: "7e.8a.2b",
               271: "7e.8a.2b"}
LATER_EDITS_PIL_REFUSES = {7: "7e.8a.2b", 97: "7e.8a.2b", 175: "7e.8a.2b",
                           190: "7e.8a.2b", 220: "7e.8a.2b",
                           223: "7e.8a.2b", 226: "7e.8a.2b",
                           235: "7e.8a.2b", 277: "7e.8a.2b"}
# csrc/av1_codec.cpp's path counters of the slice
COV_TX_TYPE, COV_INTRABC, COV_DEFAULT_DV, COV_MV_STACK = 91, 131, 132, 133
COV_HALF_SAMPLE, COV_TXFM_SPLIT, COV_INTER_TX, COV_DV_MOVED = 136, 138, 141, 189
# the types of the inter sets 1 (all 16), 2 (12: no 1-D ADST or flipped
# ADST beside identity) and 3 (IDTX, DCT_DCT)
INTER_SETS = {1: range(16), 2: range(12), 3: (0, 9)}


def _read(fn):
    with open(os.path.join(ASSETS, fn), "rb") as f:
        return f.read()


def _port(data):
    try:
        return pilread.read(data, "x.avif")
    except ValueError:
        return None


def _pil(data):
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    except Exception:
        return None


_FOUND = []


@pytest.mark.parametrize("name", [
    "INTRABC", "MV_JOINT", "MV_CLASS", "MV_CLASS0_BIT", "MV_SIGN", "MV_BITS",
    "TXFM_SPLIT", "INTER_TX_SET1", "INTER_TX_SET2", "INTER_TX_SET3",
    "TX_TYPE_INTER_INV_SET1", "TX_TYPE_INTER_INV_SET2"])
def test_new_tables_are_the_librarys(name):
    """The slice's tables of csrc/av1_codec.cpp are found whole in the
    libavif library PIL ships, in libaom's layout: use_intrabc's CDF, the
    MV CDFs (joint, sign, class, class 0's bit, the class bits), txfm_split,
    the inter tx-type sets 1-3 and their symbol-to-type maps."""
    if not _FOUND:
        _FOUND.append(gen.G.check_tables())
    assert _FOUND[0][name] == "libaom"


@pytest.mark.parametrize("fn", FILES)
def test_files_match_pil(fn):
    """Each committed file: the port's `read_image` is PIL's stored decode
    bit for bit."""
    got = tio.read_image(os.path.join(ASSETS, fn))[0]
    np.testing.assert_array_equal(got, DEC[fn])


@pytest.mark.parametrize("fn", FILES[::6])
def test_files_match_pil_on_the_spot(fn):
    """A sixth of the files against PIL here and now (not only the stored
    decodes)."""
    data = _read(fn)
    want = _pil(data)
    assert want is not None
    np.testing.assert_array_equal(_port(data), want)


def test_fields_of_named_files():
    """Every file's colour frame has allow_intrabc 1 (and the alpha item's
    of the RGBA file); the files named for a setting carry it: the
    qualities' base_q_idx, PIL's defaults (quality 75, reduced_tx_set 0),
    lossless, 4:0:0, tiles, 128x128 superblocks, reduced_tx_set 1, limited
    range."""
    f = {fn: gen.frame_fields(_read(fn)) for fn in FILES}
    assert all(v["allow_intrabc"] == 1 for v in f.values())
    for q, qidx in gen.QUALITIES:
        assert f[f"avifibc_q{q}.avif"]["base_q"] == qidx
    for name in ("timing", "timing_wide", "checker", "page", "bumps"):
        assert (f[f"avifibc_{name}.avif"]["base_q"],
                f[f"avifibc_{name}.avif"]["reduced_tx_set"]) == (64, 0)
    assert f["avifibc_lossless_420.avif"]["lossless"] == 1
    assert f["avifibc_lossless_444.avif"]["lossless"] == 1
    assert f["avifibc_400.avif"]["mono"] == 1
    assert f["avifibc_tiles_11.avif"]["tiles"] == (2, 2)
    assert f["avifibc_tiles_02.avif"]["tiles"] == (3, 1)
    assert f["avifibc_tiles_20.avif"]["tiles"] == (1, 4)
    assert f["avifibc_sb128.avif"]["sb128"] == 1
    assert f["avifibc_rts.avif"]["reduced_tx_set"] == 1
    assert f["avifibc_limited.avif"]["full_range"] == 0
    assert f["avifibc_rgba.avif"]["alpha_intrabc"] == 1
    assert {v["tx_mode"] for v in f.values()} == {0, 1, 2}


def test_files_reach_every_ibc_path():
    """The committed files reach every path of intra block copy the decoder
    counts: intra block copy blocks (every file holds some), the default
    vector, reference stacks of 0, 1 and 2+ vectors, chroma copies at half
    samples in x and in y, var-tx transform blocks at depths 0, 1 and 2,
    and each type of the inter sets 1-3 (flipped ADST, the 1-D types and
    identity 32 among them). No vector of a committed file leaves the
    decoded area (aom writes none)."""
    moved = 0
    total = np.zeros(190, np.int64)
    for fn in FILES:
        native.av1_coverage(reset=True)
        pilread.read(_read(fn), "x.avif")
        c = native.av1_coverage()
        assert c[COV_INTRABC] > 0, fn
        total += c
        moved += c[COV_DV_MOVED]
    assert total[COV_DEFAULT_DV] > 0
    assert (total[COV_MV_STACK:COV_MV_STACK + 3] > 0).all()
    assert (total[COV_HALF_SAMPLE:COV_HALF_SAMPLE + 2] > 0).all()
    assert (total[COV_TXFM_SPLIT:COV_TXFM_SPLIT + 3] > 0).all()
    for s, types in INTER_SETS.items():
        got = total[COV_INTER_TX + 16 * (s - 1) + np.array(types)]
        assert (got > 0).all(), (s, got)
    assert (total[COV_TX_TYPE:COV_TX_TYPE + 16] > 0).all()
    assert moved == 0


# ---------------------------------------------------------------------------
# seeded edits, dav1d's clip, later sub-items, the timing file
# ---------------------------------------------------------------------------

EDITS = gen.edit_cases({fn: _read(fn) for fn in gen.EDIT_SOURCES})


@pytest.mark.parametrize("case", range(15))
def test_seeded_edits_match_pil(case):
    """Twenty of the 300 seeded edits (cuts, byte replacements, bit flips:
    a third in the container, a third in the AV1 headers, a third in the
    tile data): the port's outcome (its decode's digest, or a refusal) is
    PIL's stored one; the edits in LATER_EDITS (which PIL decodes) and
    LATER_EDITS_PIL_REFUSES raise NotImplementedError naming their
    sub-item."""
    want = DEC["edits:sha256"]
    assert len(want) == len(EDITS) == 300
    later = {**LATER_EDITS, **LATER_EDITS_PIL_REFUSES}
    for i in range(case * 20, case * 20 + 20):
        fn, data = EDITS[i]
        if i in later:
            assert want[i].any() == (i in LATER_EDITS), (fn, i)
            with pytest.raises(NotImplementedError,
                               match=rf"AVIF.*{re.escape(later[i])}\)"):
                pilread.read(data, "x.avif")
            continue
        assert gen.G.digest(_port(data)) == want[i].tobytes(), (fn, i)


def test_vector_clip_and_refusal_are_dav1ds():
    """dav1d moves a vector whose source leaves the tile's decoded area
    back inside it, and refuses a frame whose vector still meets the
    current superblock: among the seeded edits, those whose vectors the
    port moves give PIL's decode (or its refusal, where the corruption
    goes on), and those it refuses for a vector into the superblock PIL
    refuses too."""
    want = DEC["edits:sha256"]
    moved = refused = 0
    for i, (fn, data) in enumerate(EDITS):
        if i in LATER_EDITS or i in LATER_EDITS_PIL_REFUSES:
            continue
        native.av1_coverage(reset=True)
        try:
            got = gen.G.digest(pilread.read(data, "x.avif"))
        except ValueError as e:
            got = gen.G.digest(None)
            if "own superblock" in str(e):
                refused += 1
                assert not want[i].any(), (fn, i)
        if native.av1_coverage()[COV_DV_MOVED]:
            moved += 1
            assert got == want[i].tobytes(), (fn, i)
    assert moved >= 10 and refused >= 10, (moved, refused)


def _bits(fields):
    """Bytes holding (value, width) fields MSB first, zero padded."""
    v, n = 0, 0
    for val, w in fields:
        v, n = (v << w) | val, n + w
    n8 = -(-n // 8) * 8
    return (v << (n8 - n)).to_bytes(n8 // 8, "big")


_SEQ = dict(reduced=1, force_sct=2, force_imv=2, frame_id=0,
            order_hint_bits=0, decoder_model=0, max_w=64, max_h=64,
            superres=0, sb128=0, mono=0, separate_uv_dq=0, enable_cdef=0,
            enable_restoration=0, film_grain=0)


@pytest.mark.parametrize("ibc", [0, 1])
def test_superres_and_film_grain_name_7e8a2c2(ibc):
    """A key frame header with use_superres 1, and one with apply_grain 1
    (with intra block copy off and on): NotImplementedError naming
    7e.8a.2c.2."""
    s = dict(_SEQ, superres=1)
    # disable_cdf_update, allow_screen_content_tools, force_integer_mv,
    # use_superres
    hdr = _bits([(0, 1), (1, 1), (0, 1), (1, 1)])
    with pytest.raises(NotImplementedError, match=r"superres.*7e\.8a\.2c\.2"):
        avif._frame_header(avif._Bits(hdr), s, 0, 0)
    s = dict(_SEQ, film_grain=1)
    fields = [(0, 1), (1, 1), (0, 1), (0, 1), (ibc, 1),  # ... allow_intrabc
              (1, 1),                                    # uniform tiles
              (64, 8), (0, 1), (0, 1), (0, 1), (0, 1),   # quantiser, qm
              (0, 1), (0, 1)]                            # seg, delta q
    if not ibc:
        fields += [(0, 6), (0, 6), (0, 3), (0, 1)]       # loop filter
    fields += [(1, 1), (0, 1), (1, 1)]  # TX_MODE_SELECT, reduced_tx_set,
    # apply_grain
    with pytest.raises(NotImplementedError,
                       match=r"film grain.*7e\.8a\.2c\.2"):
        avif._frame_header(avif._Bits(_bits(fields)), s, 0, 0)
    h = avif._frame_header(avif._Bits(_bits(fields[:-1] + [(0, 1)])), s, 0,
                           0)
    assert (h["allow_intrabc"], h["tx_mode"], h["lf"][:2]) == (ibc, 2, [0, 0])


def test_timing_file():
    """The committed 2048^2 file (`timing_image(2048)`, PIL's defaults,
    autotiled, intra block copy) decodes to PIL's decode: its sha256 and
    128 x 128 corner."""
    data = _read("avifibc_2048.avif")
    assert gen.frame_fields(data)["allow_intrabc"] == 1
    got = tio.read_image(os.path.join(ASSETS, "avifibc_2048.avif"))[0]
    assert got.shape == (2048, 2048, 3)
    np.testing.assert_array_equal(got[:128, :128],
                                  DEC["avifibc_2048.avif:corner"])
    assert hashlib.sha256(got.tobytes()).digest() == \
        DEC["avifibc_2048.avif:sha256"].tobytes()


# ---------------------------------------------------------------------------
# the JAX package's loader, the twins, the roadmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", FILES[::8])
def test_load_image_matches_jax(fn):
    """`texture.load_image` of files with intra block copy: the JAX
    package's (PIL's decode, linearised the same way), bit for bit."""
    p = os.path.join(ASSETS, fn)
    np.testing.assert_array_equal(ttex.load_image(p, "srgb"),
                                  jtex.load_image(p, "srgb"))


def test_twins_files():
    """The twins' PNGs hold PIL's decodes of their AVIF files, which the
    port gives; both frames copy blocks of themselves."""
    for fn in ("checker_avifibc.avif", "projector_avifibc.avif"):
        got = tio.read_image(os.path.join(ASSETS, fn))[0]
        np.testing.assert_array_equal(got, DEC[fn])
        np.testing.assert_array_equal(got, tio.read_image(os.path.join(
            ASSETS, fn.replace(".avif", "_pil.png")))[0])
        assert gen.ibc_blocks(_read(fn)) > 0


@pytest.mark.parametrize("name,ref", [
    ("cbox_tex_avifibc", "cbox_tex_avifibc_ref"),
    ("env_sphere_avifibc", "env_sphere_avifibc_ref")])
def test_twin_scenes_render_as_their_references(name, ref):
    """`cbox_tex_avifibc` (K1) renders as `cbox_tex_avifibc_ref`, and
    `env_sphere_avifibc` (K2) as `env_sphere_avifibc_ref`: the same atlas,
    the same render, bit for bit (16^2, 1 spp on the CPU); and the twin's
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


def test_no_module_names_7e8a2c1():
    """No module of the port names 7e.8a.2c without its part: intra block
    copy decodes, and superres and film grain raise naming 7e.8a.2c.2."""
    import vision_tpu_torch
    root = pathlib.Path(vision_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        assert not re.search(r"7e\.8a\.2c(?!\.2)", path.read_text()), path
