"""Slice 7e.8a.2a: lossy AVIF key frames on PIL's route, as PIL 12.1.0's
default save writes them, decoded as PIL over libavif 1.3.0 and dav1d
1.5.1 decodes them: `scene/avif.py` (the rest of a lossy frame's header)
over `csrc/av1_codec.cpp` (the quantiser, every intra transform size and
type, the deblocking filter).

  * The new tables of `csrc/av1_codec.cpp` against the libavif library PIL
    ships (`tools/gen_torch_avif.py` `check_tables`).
  * Every file of `tools/gen_torch_avif_lossy.py` against PIL's stored
    decode (`avifq_decodes.npz`) and against PIL on the spot; the header
    fields each carries; the `avif_later_*` files, which PIL decodes,
    raising NotImplementedError naming 7e.8a.2b; the
    committed files reach every transform size aom picks, every intra
    transform type and every deblocking filter.
  * 300 seeded edits, each with PIL's stored outcome (those the port sends
    to a later sub-item counted exactly: `LATER_EDITS`); refusals of
    truncated tiles; the 2048^2 timing file.
  * `texture.load_image` against the JAX package's; the twins
    `cbox_tex_avifq` (K1) / `env_sphere_avifq` (K2); no module naming
    7e.8a.2a, or 7e.8a.2 without its part."""
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
    "vt_gen_torch_avif_lossy_tests", os.path.join(
        os.path.dirname(ASSETS), "..", "tools", "gen_torch_avif_lossy.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

DEC = np.load(os.path.join(ASSETS, "avifq_decodes.npz"))
FILES = sorted(k for k in DEC.files if ":" not in k)
# what PIL decodes and the port sends to a later sub-item
LATER = dict(gen.LATER)
# the seeded edits the port sends to a later sub-item: header edits that
# switch on a tool of 7e.8a.2b, a 10-bit depth or a frame size unlike
# ispe's (7e.8a.3). PIL decodes the first set; the second it refuses once
# dav1d's decode with that tool meets the corruption (ROADMAP 7e.8a.2a).
# Edits 19, 265 and 289 switch on intra block copy: since slice 7e.8a.2c.1
# 265 and 289 are refused as PIL refuses them, and 19, read on past
# allow_intrabc, names the segments' alt-q of 7e.8a.2b
LATER_EDITS = {4: "7e.8a.2b", 19: "7e.8a.2b", 31: "7e.8a.2b", 52: "7e.8a.3",
               70: "7e.8a.3", 79: "7e.8a.2b", 94: "7e.8a.3", 115: "7e.8a.2b",
               142: "7e.8a.2b", 151: "7e.8a.2b", 178: "7e.8a.2b",
               202: "7e.8a.3", 223: "7e.8a.2b", 232: "7e.8a.3"}
LATER_EDITS_PIL_REFUSES = {25: "7e.8a.2b", 121: "7e.8a.2b", 145: "7e.8a.2b",
                           199: "7e.8a.2b", 298: "7e.8a.3"}
# the transform sizes aom 3.12.1 picks in the files: every size but
# TX_16X64 (no speed or content tried makes it pick a 16x64 block)
TX_SIZES = [s for s in range(19) if s != 17]
UV_TX_SIZES = [0, 1, 2, 3, 5, 6, 7, 8, 9, 10, 13, 14, 15, 16]


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
    "TXB_SKIP", "EOB_PT_16", "EOB_PT_32", "EOB_PT_64", "EOB_PT_128",
    "EOB_PT_256", "EOB_PT_512", "EOB_PT_1024", "EOB_EXTRA", "DC_SIGN",
    "COEFF_BASE_EOB", "COEFF_BASE", "COEFF_BR", "TX_DEPTH_8X8", "TX_DEPTH",
    "INTRA_TX_SET1", "INTRA_TX_SET2", "DC_QLOOKUP", "AC_QLOOKUP", "COSPI",
    "SINPI", "SM_WEIGHTS", "MODE_TO_TXFM", "MAX_TX_SIZE_RECT",
    "TX_TYPE_INTRA_INV_SET1", "TX_TYPE_INTRA_INV_SET2",
    "DEFAULT_SCAN_32X32", "DEFAULT_SCAN_8X32",
    "COEFF_BASE_CTX_OFFSET 32x8", "COEFF_BASE_CTX_OFFSET 8x32"])
def test_new_tables_are_the_librarys(name):
    """The slice's tables of csrc/av1_codec.cpp are found whole in the
    libavif library PIL ships: the coefficient CDFs of all four quantiser
    contexts and five sizes, the tx-depth and intra tx-type CDFs in
    libaom's layout, the quantiser lookups, the cosine and sine constants,
    the smooth weights, the scans and context offsets (libaom's arrays,
    transposed)."""
    if not _FOUND:
        _FOUND.append(gen.G.check_tables())
    assert _FOUND[0][name] == "libaom"


@pytest.mark.parametrize("fn", FILES)
def test_files_match_pil(fn):
    """Each committed file: the port's `read_image` is PIL's stored decode
    bit for bit, or NotImplementedError naming AVIF and the sub-item for a
    later one."""
    p = os.path.join(ASSETS, fn)
    if fn in LATER:
        with pytest.raises(NotImplementedError,
                           match=f"AVIF.*{re.escape(LATER[fn])}"):
            tio.read_image(p)
        return
    got = tio.read_image(p)[0]
    np.testing.assert_array_equal(got, DEC[fn])


@pytest.mark.parametrize("fn", FILES)
def test_files_match_pil_on_the_spot(fn):
    """Each file against PIL here and now; lossy and free of CDEF, loop
    restoration and intra block copy unless it is a later one."""
    data = _read(fn)
    want = _pil(data)
    assert want is not None
    if fn in LATER:
        return
    np.testing.assert_array_equal(_port(data), want)
    f = gen.frame_fields(data)
    assert (f["lossless"], f["cdef"], f["lr"]) == (0, 0, 0)


def test_fields_of_named_files():
    """The files named for a setting carry it: the qualities' base_q_idx,
    speeds 9-10's TX_MODE_LARGEST, 128x128 superblocks, reduced_tx_set,
    sharpness, 4:0:0, limited range, tiles, a lossy alpha item."""
    f = {fn: gen.frame_fields(_read(fn)) for fn in FILES
         if fn not in LATER and fn.startswith("avifq_")}
    for q, qidx in gen.QUALITIES:
        assert f[f"avifq_q{q}.avif"]["base_q"] == qidx
    assert [f[f"avifq_s{s}.avif"]["tx_mode"] for s in range(5, 11)] == \
        [2, 2, 2, 2, 1, 1]
    assert f["avifq_sb128.avif"]["sb128"] == 1
    assert f["avifq_rts.avif"]["reduced_tx_set"] == 1
    assert f["avifq_sharp7.avif"]["sharpness"] == 7
    assert f["avifq_400_s6.avif"]["mono"] == 1
    assert f["avifq_limited.avif"]["full_range"] == 0
    assert f["avifq_tiles_11.avif"]["tiles"] == (2, 2)
    assert f["avifq_alpha.avif"]["alpha_base_q"] == 64
    assert sum(v["base_q"] <= 20 for v in f.values()) and \
        all(v["base_q"] > 0 for v in f.values())


def test_files_reach_every_tool():
    """The committed files reach every luma transform size aom picks, the
    chroma sizes, every intra transform type (DCT and ADST in both
    directions, IDTX, V_DCT, H_DCT) and the five deblocking filters (luma
    4, 8, 14 taps, chroma 4, 6)."""
    native.av1_coverage(reset=True)
    for fn in FILES:
        if fn not in LATER:
            pilread.read(_read(fn), "x.avif")
    c = native.av1_coverage()
    assert (c[72 + np.array(TX_SIZES)] > 0).all(), c[72:91]
    assert (c[107 + np.array(UV_TX_SIZES)] > 0).all(), c[107:126]
    assert (c[91 + np.array([0, 1, 2, 3, 9, 10, 11])] > 0).all(), c[91:107]
    assert (c[126:131] > 0).all(), c[126:131]


# ---------------------------------------------------------------------------
# seeded edits, refusals, the timing file
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


def _leb128(n):
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out)


@pytest.mark.parametrize("cut", [1, 40, 200])
def test_truncated_tile_is_refused(cut):
    """A lossy frame OBU with the end of its tile data cut off (and its
    size rewritten): dav1d refuses the tile, and so does the port."""
    item = _read("avifq_q75.avif")
    item = item[item.find(b"mdat") + 4:]
    cutter = b""
    for typ, _, _, start, end in avif._obus(item):
        if typ == avif.OBU_FRAME:
            end -= cut
        cutter += bytes([typ << 3 | 2]) + _leb128(end - start) + \
            item[start:end]
    with pytest.raises(ValueError, match="past its data"):
        avif.decode_av1(cutter)


def test_timing_file():
    """The committed 2048^2 lossy file (autotiled, PIL's defaults) decodes
    to PIL's decode: its sha256 and 128 x 128 corner."""
    got = tio.read_image(os.path.join(ASSETS, "avif_lossy_2048.avif"))[0]
    assert got.shape == (2048, 2048, 3)
    np.testing.assert_array_equal(got[:128, :128],
                                  DEC["avif_lossy_2048.avif:corner"])
    assert hashlib.sha256(got.tobytes()).digest() == \
        DEC["avif_lossy_2048.avif:sha256"].tobytes()


# ---------------------------------------------------------------------------
# the JAX package's loader, the twins, the roadmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", [f for f in FILES if f not in LATER][::8])
def test_load_image_matches_jax(fn):
    """`texture.load_image` of the lossy files: the JAX package's (PIL's
    decode, linearised the same way), bit for bit."""
    p = os.path.join(ASSETS, fn)
    np.testing.assert_array_equal(ttex.load_image(p, "srgb"),
                                  jtex.load_image(p, "srgb"))


def test_twins_files():
    """The twins' PNGs hold PIL's decodes of their AVIF files, which the
    port gives; the projector's alpha item is lossy too."""
    for fn in ("texture_avifq.avif", "projector_avifq.avif"):
        got = tio.read_image(os.path.join(ASSETS, fn))[0]
        np.testing.assert_array_equal(got, DEC[fn])
        np.testing.assert_array_equal(got, tio.read_image(os.path.join(
            ASSETS, fn.replace(".avif", "_pil.png")))[0])
    f = gen.frame_fields(_read("projector_avifq.avif"))
    assert f["base_q"] == f["alpha_base_q"] == 64


@pytest.mark.parametrize("name,ref", [("cbox_tex_avifq", "cbox_tex_avifq_ref"),
                                      ("env_sphere_avifq",
                                       "env_sphere_avifq_ref")])
def test_twin_scenes_render_as_their_references(name, ref):
    """`cbox_tex_avifq` (K1) renders as `cbox_tex_avifq_ref`, and
    `env_sphere_avifq` (K2) as `env_sphere_avifq_ref`: the same atlas, the
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


def test_no_module_names_7e8a2a():
    """No module of the port names slice 7e.8a.2a as still to come, or
    7e.8a.2 without its part: lossy key frames decode, and what they do not
    raises naming 7e.8a.2b, 7e.8a.2c.2 or 7e.8a.3."""
    import vision_tpu_torch
    root = pathlib.Path(vision_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        assert not re.search(r"7e\.8a\.2(?![bc])", path.read_text()), path
