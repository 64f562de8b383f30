"""Slice 7e.7c: JPEG 2000 Part 15 (HTJ2K) code-blocks, decoded as OpenJPEG
2.5's HT block decoder decodes them, on PIL's route (PIL 12.1.0 over
OpenJPEG 2.5.4, any name) and OpenCV's (the pip cv2 5.0.0 over OpenJPEG
2.5.3, .hdr / .exr names): `csrc/j2k_ht.cpp` (`native.j2k_ht_decode`),
`scene/j2k.py`'s HT segments in tier-2 and its CAP / CPF markers.

  * The CxtVLC tables of `csrc/j2k_ht.cpp` against the two decoding
    tables in Pillow's libopenjp2; the generator's HT block writer
    lossless through PIL.
  * Every file of `tools/gen_torch_j2k_ht.py` against its stored decodes
    (`j2k_decodes.npz`, `j2k_cv_decodes.npz`), and against PIL and the JAX
    package's cv2 loader on the spot; the `htj2k_bad_*` files refused, each
    by the check it names.
  * 300 seeded edits on each route, each with the library's stored
    outcome; the 2048^2 timing file; `texture.load_image` against the JAX
    package's; the twins `cbox_tex_htj2k` (K1) / `env_sphere_htj2kcv`
    (K2); no module naming 7e.7c."""
import hashlib
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
from vision_tpu_torch import native
from vision_tpu_torch.scene import imageio as tio
from vision_tpu_torch.scene import j2k
from vision_tpu_torch.scene import texture as ttex

warnings.filterwarnings("ignore", category=UserWarning, module="PIL")

_spec = importlib.util.spec_from_file_location(
    "vt_gen_torch_j2k_ht_tests", os.path.join(
        os.path.dirname(ASSETS), "..", "tools", "gen_torch_j2k_ht.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)
P2 = gen._p2()

PIL_DEC = np.load(os.path.join(ASSETS, "j2k_decodes.npz"))
CV_DEC = np.load(os.path.join(ASSETS, "j2k_cv_decodes.npz"))
CV_REFUSED = set(CV_DEC[":refused"].tolist())
FILES = sorted(fn for fn in os.listdir(ASSETS)
               if fn.startswith("htj2k_") and fn != "htj2k_2048.jp2") + \
    ["checker_htj2k.jp2", "projector_htj2kcv.exr"]
BAD = [fn for fn in FILES if fn.startswith("htj2k_bad_")]


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
# the tables and the writer
# ---------------------------------------------------------------------------

def test_tables_are_pillows_openjpegs():
    """The CxtVLC tables in `csrc/j2k_ht.cpp`, expanded as OpenJPEG expands
    them, are the two 1024-entry tables found in Pillow's libopenjp2
    (2.5.4), entry for entry (searched by content); each entry's length
    is 1-7 bits and none is 0."""
    lib = gen.pillow_openjp2()
    if lib is None:
        pytest.skip("Pillow's libopenjp2 is not installed here")
    first, other = gen.check_tables(lib)
    assert first != other
    for rows in gen.tables():
        lut = gen.expand(rows)
        assert (lut != 0).all() and 1 <= (lut & 7).min() and \
            (lut & 7).max() <= 7


def test_writer_is_lossless_through_pil():
    """The generator's HT block writer: a reversible file of an 8-bit image
    (grey, RGB with RCT, 4 x 8 code-blocks) decodes in PIL to that
    image."""
    gen.check_writer()


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", FILES)
def test_files_match_the_libraries(tmp_path, fn):
    """Each file on PIL's route (by its own name, a .exr one under a .j2k
    name) gives PIL's stored decode and PIL's decode here, or both refuse
    it (the `htj2k_bad_*` files); under a .exr and a .hdr name it gives
    the pip cv2's stored decode and what the JAX package's loader gets
    here, or both refuse it."""
    p = os.path.join(ASSETS, fn) if not fn.endswith(".exr") else \
        _named(tmp_path, fn, "x.j2k")
    got = _port(p)
    if fn != "projector_htj2kcv.exr":       # written for OpenCV's route
        want = None if fn.startswith("htj2k_bad_") else PIL_DEC[fn]
        assert _same(want, got)
    assert _same(_pil(p), got)
    want = None if fn in CV_REFUSED else CV_DEC[fn]
    for name in ("x.exr", "x.hdr"):
        got = _port(_named(tmp_path, fn, name))
        assert _same(want, got), name
    assert _same(_cv2(_named(tmp_path, fn, "y.exr")), got)


REASONS = {
    "htj2k_bad_roi.j2k": "ROI",
    "htj2k_bad_passes4.j2k": "more than 3 coding passes",
    "htj2k_bad_mb.j2k": "more than 30 bit-planes",
    "htj2k_bad_zero_planes.j2k": "more zero bit-planes",
    "htj2k_bad_lengths.j2k": "invalid code-block length",
    "htj2k_bad_zero_length.j2k": "invalid code-block length",
    "htj2k_bad_layers3.j2k": "invalid code-block length",
    "htj2k_bad_scup.j2k": "Scup",
    "htj2k_bad_mel.j2k": "MEL segment",
    "htj2k_bad_uq.j2k": "U_q",
    "htj2k_bad_outside.j2k": "outside the code-block",
    "htj2k_bad_htmixed.j2k": "mixed HT",
    "htj2k_bad_cap_tile.j2k": "marker out of place"}


@pytest.mark.parametrize("fn", BAD)
def test_bad_files_stop_where_they_claim(fn):
    """Each `htj2k_bad_*` file is refused on both routes by the check its
    name stands for (OpenJPEG's message for a malformed HT block, its
    refusals of HTMIXED and of CAP in a tile-part header)."""
    assert set(BAD) == set(REASONS)
    for read in (lambda d: tio._read_pil(d, fn),
                 lambda d: tio._read_opencv(d, "x.exr")):
        with pytest.raises(ValueError, match=REASONS[fn]):
            read(_read(fn))


def test_the_matrix_is_whole():
    """The files cover what the slice claims: grey and RGB at 8 bits, RGB
    with RCT and with ICT, 12 and 16 bits, signed; 5/3 and 9/7; code-blocks
    64 x 64, 32 x 32, 16 x 256, 4 x 4 and 8 x 4 with edge blocks;
    precincts, tiles, PPM / PPT, SOP / EPH, three layers (TERMALL) and two;
    SigProp alone and with MagRef, the stripe-causal mode, every other
    code-block style bit; empty blocks; CAP / CPF and Rsiz variants; JP2
    and bare codestreams; COC mixing HT and Part 1 components; the
    warnings OpenJPEG decodes through; and the refusals of both
    libraries."""
    need = {"htj2k_grey.j2k", "htj2k_rgb.jp2", "htj2k_rgb_mct.j2k",
            "htj2k_irr_ict.jp2", "htj2k_prec12.j2k", "htj2k_prec16.jp2",
            "htj2k_signed.j2k", "htj2k_signed12.j2k", "htj2k_irr.j2k",
            "htj2k_irr_cleanup.j2k", "htj2k_cblk64.j2k",
            "htj2k_cblk32.j2k", "htj2k_cblk16x256.j2k", "htj2k_cblk4.j2k",
            "htj2k_cblk8x4_edges.j2k", "htj2k_precincts.j2k",
            "htj2k_tiles.j2k", "htj2k_tiles_origin.j2k", "htj2k_ppm.j2k",
            "htj2k_sop_eph_ppt.j2k", "htj2k_layers3.j2k",
            "htj2k_layers2.j2k", "htj2k_sp_only.j2k", "htj2k_plane3.j2k",
            "htj2k_vsc.j2k", "htj2k_sty_all.j2k", "htj2k_sty01.j2k",
            "htj2k_sty02.j2k", "htj2k_sty10.j2k", "htj2k_sty20.j2k",
            "htj2k_empty_blocks.j2k", "htj2k_cpf.j2k", "htj2k_nocap.j2k",
            "htj2k_cap_twice.j2k", "htj2k_cap_wide.j2k",
            "htj2k_cap_empty.j2k", "htj2k_cap_pcap0.j2k",
            "htj2k_rsiz_profile.j2k", "htj2k_coc_part1.j2k",
            "htj2k_coc_ht.j2k", "htj2k_only_cleanup.j2k",
            "htj2k_ref_empty.j2k", "htj2k_mel_unchecked.j2k",
            "checker_htj2k.jp2", "projector_htj2kcv.exr"}
    assert need | set(REASONS) == set(FILES)
    assert need - {"projector_htj2kcv.exr"} <= set(PIL_DEC.files)
    # the pip cv2 refuses what PIL refuses, signed samples (no Mat for
    # them) and an image whose origin is not (0, 0)
    assert CV_REFUSED & set(FILES) == set(REASONS) | {
        "htj2k_signed.j2k", "htj2k_signed12.j2k", "htj2k_tiles.j2k"}


def test_checker_decodes_to_the_checker():
    """`checker_htj2k.jp2` (reversible, the cleanup holding every bit)
    decodes to the checker PNG it was written from, on both routes."""
    want = tio.read_image(os.path.join(ASSETS, "checker.png"))[0]
    np.testing.assert_array_equal(PIL_DEC["checker_htj2k.jp2"], want)
    np.testing.assert_array_equal(
        tio._read_opencv(_read("checker_htj2k.jp2"), "x.exr"), want)


# ---------------------------------------------------------------------------
# what the files show
# ---------------------------------------------------------------------------

def _pil_of(fn):
    return tio._read_pil(_read(fn), fn)


def test_only_the_cleanup_where_planes_run_out():
    """A block whose zero bit-planes are as many as its bit-planes decodes
    its cleanup pass alone (OpenJPEG warns, once a process), and so does a
    block whose refinement segment is empty: each file's first block was
    given such passes, and the file decodes as the same blocks with that
    one's cleanup alone."""
    cleanup = gen._segs_edit(lambda coef, segs: segs[:1])
    for fn, kw in (("htj2k_only_cleanup.j2k", dict(plane=1, seed=29)),
                   ("htj2k_ref_empty.j2k", dict(seed=30))):
        plain = gen.random_ht(24, 20, edit=cleanup, **kw)
        np.testing.assert_array_equal(_pil_of(fn),
                                      tio._read_pil(plain, "x.j2k"))


def _blocks(fn):
    """Tile 0's code-blocks of a bare codestream after the port's tier-2:
    [(code-block, the tile's data)]."""
    cs = j2k._Codestream(_read(fn), 0)
    tileno = next(cs.tiles())
    tcp = cs.tcps[tileno]
    box, comps = j2k._tile_geometry(cs, tileno, tcp)
    j2k._tier2(tcp, comps, box, cs)
    return [(cb, tcp.data) for cp in comps for r in cp["res"]
            for b in r.bands for pr in b.prcs for cb in pr.cblks]


def test_mel_check_reads_to_a_word_boundary():
    """OpenJPEG checks the byte after a 0xFF in the MEL bytes only where it
    reads them one at a time, up to a 4-byte boundary of the block's
    address (a block of one chunk is read where it lies in the tile's
    data): `htj2k_mel_unchecked.j2k` has 0xFF 0x90 at an address of 3
    modulo 4, where it reads a word, and decodes; `htj2k_bad_mel.j2k` at
    another, where it reads bytes, and is refused."""
    for fn, unchecked in (("htj2k_mel_unchecked.j2k", True),
                          ("htj2k_bad_mel.j2k", False)):
        cb, data = _blocks(fn)[0]
        (pos, n), = cb.chunks
        cup = data[pos:pos + n]
        mel = pos + n - ((cup[-1] << 4) + (cup[-2] & 0xF))
        assert data[mel:mel + 2] == b"\xff\x90"
        assert (mel % 4 == 3) == unchecked
    assert PIL_DEC["htj2k_mel_unchecked.j2k"].shape[0] == 9


@pytest.mark.parametrize("fn,passes", [("htj2k_cblk32.j2k", [1, 2]),
                                       ("htj2k_layers2.j2k", [1, 2]),
                                       ("htj2k_layers3.j2k", [1, 1, 1]),
                                       ("htj2k_sp_only.j2k", [1, 1])])
def test_ht_segments(fn, passes):
    """OpenJPEG's tier-2 puts an HT block's first pass in a segment of its
    own and every later pass of the packet in the next; a later layer goes
    on in the last segment unless that one is full (TERMALL: a segment a
    pass). So with TERMALL a block of three layers has three segments (the
    HT decoder reads the first two: MagRef is left out), and a cleanup-only
    first layer decodes; without TERMALL it lands in the cleanup's segment
    and is refused (`htj2k_bad_layers3.j2k`)."""
    seen = {tuple(s[1] for s in cb.segs[:cb.numsegs])
            for cb, _ in _blocks(fn) if cb.numsegs}
    assert seen == {tuple(passes)}


def test_refusal_names_the_block():
    """`native.j2k_ht_decode` returns the first block it refuses and why,
    and leaves the blocks before it decoded."""
    seg = gen.ht_block(np.arange(-8, 8).reshape(4, 4), 1)
    data = seg[0][0] + b"\x01"
    info = np.array([[0, 0, 1, 4, 4, 9, 1, 0, gen.HT, 0, 8, 0, 1, 0],
                     [len(seg[0][0]), 1, 1, 4, 4, 9, 1, 2, gen.HT, 4, 8, 0,
                      1, 0]], np.int64)
    segs = np.array([len(seg[0][0]), 1, 1, 1], np.int64)
    out = np.zeros((4, 8), np.int32)
    assert native.j2k_ht_decode(data, info, segs, np.ones(2, np.float32),
                                out) == (1, native.HT_REFUSALS[1])
    np.testing.assert_array_equal(out[:, :4],
                                  np.arange(-8, 8).reshape(4, 4))


# ---------------------------------------------------------------------------
# seeded edits, the timing file
# ---------------------------------------------------------------------------

EDITS = gen.edit_cases({fn: _read(fn) for fn in gen.EDIT_SOURCES})


@pytest.mark.parametrize("route", ["pil", "cv"])
@pytest.mark.parametrize("case", range(15))
def test_seeded_edits_match_the_libraries(route, case):
    """Twenty of the 300 seeded edits (cuts, byte replacements, bit flips,
    two in three among the code-blocks' bytes): the port's outcome on the
    route (its decode's digest, or a refusal) is the library's stored
    one."""
    want = (PIL_DEC if route == "pil" else CV_DEC)["htedits:sha256"]
    assert len(want) == len(EDITS) == 300
    for i in range(case * 20, case * 20 + 20):
        fn, data = EDITS[i]
        try:
            got = tio._read_pil(data, "x.j2k") if route == "pil" else \
                tio._read_opencv(data, "x.exr")
        except ValueError:
            got = None
        assert P2.digest(got) == want[i].tobytes(), (fn, i)


@pytest.mark.parametrize("route", ["pil", "cv"])
def test_timing_file(tmp_path, route):
    """The committed 2048^2 9/7 HT file decodes to each library's decode:
    its sha256 and 128 x 128 corner."""
    dec = PIL_DEC if route == "pil" else CV_DEC
    name = "x.jp2" if route == "pil" else "x.exr"
    got = tio.read_image(_named(tmp_path, "htj2k_2048.jp2", name))[0]
    assert got.shape == (2048, 2048, 3)
    np.testing.assert_array_equal(got[:128, :128],
                                  dec["htj2k_2048.jp2:corner"])
    assert hashlib.sha256(got.tobytes()).digest() == \
        dec["htj2k_2048.jp2:sha256"].tobytes()


# ---------------------------------------------------------------------------
# the JAX package's loader, the twins, the roadmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", [f for f in FILES if f.startswith("htj2k_")
                                and not f.startswith("htj2k_bad_")][::4] +
                         ["checker_htj2k.jp2", "projector_htj2kcv.exr"])
def test_load_image_matches_jax(fn):
    """`texture.load_image` of the files: the JAX package's (PIL's decode,
    or the pip cv2's for the .exr one, linearised the same way), bit for
    bit."""
    p = os.path.join(ASSETS, fn)
    np.testing.assert_array_equal(ttex.load_image(p, "srgb"),
                                  jtex.load_image(p, "srgb"))


def test_twins_files():
    """`projector_htj2kcv_pfm.hdr` holds the pip cv2's decode of
    `projector_htj2kcv.exr`, which the port gives."""
    got = tio.read_image(os.path.join(ASSETS, "projector_htj2kcv.exr"))[0]
    np.testing.assert_array_equal(got, CV_DEC["projector_htj2kcv.exr"])
    np.testing.assert_array_equal(got, tio.read_image(
        os.path.join(ASSETS, "projector_htj2kcv_pfm.hdr"))[0])


@pytest.mark.parametrize("name,ref", [("cbox_tex_htj2k", "cbox_tex"),
                                      ("env_sphere_htj2kcv",
                                       "env_sphere_htj2kcv_ref")])
def test_twin_scenes_render_as_their_references(name, ref):
    """`cbox_tex_htj2k` (K1) renders as `cbox_tex` (the checker's HT file is
    lossless), `env_sphere_htj2kcv` (K2) as `env_sphere_htj2kcv_ref`: the
    same atlas, the same render, bit for bit (64^2, 1 spp on the CPU); and
    the twin's tables equal the JAX Scene's."""
    import torch
    import vision_tpu_torch as vt
    from tests import torch_scenes as ts
    from tests.test_torch_scene import _assert_same_scene
    from tests.torch_parity import jax_scene_arrays
    from vision_tpu.scene.scene import Scene as JScene
    kw = dict(sub_div=8) if name.startswith("env") else {}
    a = vt.load_scene(getattr(ts, ref)(64, **kw), device="cpu")
    desc = getattr(ts, name)(64, **kw)
    b = vt.load_scene(desc, device="cpu")
    assert torch.equal(a.data.atlas.data, b.data.atlas.data)
    assert torch.equal(vt.render(a, spp=1), vt.render(b, spp=1))
    _assert_same_scene(b.data, b.camera, b.filter,
                       jax_scene_arrays(JScene(desc)))


def test_no_module_names_7e7c():
    """No module of the port names slice 7e.7c, and none raises for CAP,
    CPF or the HT code-block bit: HTJ2K decodes, or is refused as the
    libraries refuse it."""
    import vision_tpu_torch
    root = pathlib.Path(vision_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        assert not re.search(r"7e\.7c", path.read_text()), path
    assert not hasattr(j2k, "uses_ht")
