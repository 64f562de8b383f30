"""Slice 7e.3b: TIFF and GIF files under .hdr / .exr names, which the JAX
package reads through the pip cv2 5.0's own TIFF (libtiff 4.7.1) and GIF
readers (`vision_tpu.scene.texture.load_image`), decoded by the port
(`vision_tpu_torch/scene/cvtiff.py`, `cvread.read_gif_cv`) bit for bit:
the committed files of `tools/gen_torch_cvtiff.py` against
`load_image` on the spot in both colour spaces and against their committed
decodes; the files cv2 refuses refused (ValueError) by the port; seeded
header edits; the twin scenes against the JAX Scene and their
references. The tolerance is exact everywhere (float data compared as its
bits). ROADMAP C27 lists where the port refuses a file cv2 reads from
memory it never wrote."""
import hashlib
import io
import os
import struct
import warnings

import cv2
import numpy as np
import pytest

from tests.torch_scenes import ASSETS, gen_assets as ga
from vision_tpu.scene import texture as jtex
from vision_tpu_torch.scene import cvread, cvtiff
from vision_tpu_torch.scene import imageio as tio
from vision_tpu_torch.scene import texture as ttex

DECODES = np.load(os.path.join(ASSETS, "cvtiff_decodes.npz"))
FILES = sorted(k for k in DECODES.files if ":" not in k)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _cv2(path):
    """What the JAX package's loader gets through the pip cv2, or None
    where it raises."""
    try:
        return jtex.load_image(path)
    except Exception:     # IOError for None, cv2.error for OpenCV's raises
        return None


def _assert_same(tmp_path, data, name="f.exr"):
    """The port's decode of `data` under `name` equals the pip cv2's
    (through the JAX package's loader), or both refuse it (the port with
    ValueError)."""
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    want = _cv2(p)
    if want is None:
        with pytest.raises(ValueError):
            tio.read_image(p)
        return
    got, kind = tio.read_image(p)
    assert kind == "hdr" and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fn", FILES)
def test_committed_files_match_their_cv2_decodes(fn):
    """Each file decodes to the pip cv2's stored decode."""
    got, kind = tio.read_image(os.path.join(ASSETS, fn))
    assert kind == "hdr"
    np.testing.assert_array_equal(_bits(got), _bits(DECODES[fn]))


@pytest.mark.parametrize("fn", FILES)
@pytest.mark.parametrize("color_space", ["srgb", "linear"])
def test_load_image_matches_jax(fn, color_space):
    """`texture.load_image` of each committed file: the JAX package's,
    through the pip cv2 on the spot, bit for bit."""
    p = os.path.join(ASSETS, fn)
    np.testing.assert_array_equal(_bits(ttex.load_image(p, color_space)),
                                  _bits(jtex.load_image(p, color_space)))


def test_timing_file():
    """The 2048 x 2048 float32 TIFF built from its seed (LZW, the
    floating-point predictor) decodes to the pip cv2's decode (its sha256
    and corner)."""
    gen = ga._cvtiff_module()
    got = cvtiff.read_tiff_cv(gen.float_timing())
    img = np.ascontiguousarray(got[..., ::-1], np.float32)
    np.testing.assert_array_equal(_bits(img[:128, :128]),
                                  _bits(DECODES["sky_2048.exr:corner"]))
    assert hashlib.sha256(img.tobytes()).digest() == \
        DECODES["sky_2048.exr:sha256"].tobytes()


G = np.random.default_rng(5)
RGB = G.integers(0, 256, (6, 9, 3))
A4 = G.integers(0, 256, (6, 9, 4))
IDX = G.integers(0, 16, (6, 9))
PAL = G.integers(0, 256, (16, 3))


def _retag(data, tag, value=None):
    """A TIFF of `tiff_bytes` with `tag` set to the SHORT `value`, or
    dropped (None)."""
    d = bytearray(data)
    off, = struct.unpack("<I", d[4:8])
    n, = struct.unpack("<H", d[off:off + 2])
    for k in range(n):
        e = off + 2 + 12 * k
        if struct.unpack("<H", d[e:e + 2])[0] == tag:
            if value is None:
                d[e:e + 2] = struct.pack("<H", 65000)   # an unknown tag
            else:
                d[e + 2:e + 12] = struct.pack("<HIH", 3, 1, value) + bytes(2)
    return bytes(d)


def _gif_edit(data, at, value):
    d = bytearray(data)
    d[at] = value
    return bytes(d)


# files the pip cv2 refuses (imread returns None, or raises)
REFUSED = {
    "no_photometric": lambda: _retag(ga.tiff_bytes(RGB, 8, 2), 262),
    "grey_4bit": lambda: ga.tiff_bytes(RGB[..., :1] >> 4, 4, 1),
    "palette_2bit": lambda: ga.tiff_bytes(RGB[..., :1] & 3, 2, 3,
                                          colormap=PAL[:4] * 257),
    "cmyk_16bit": lambda: ga.tiff_bytes(A4 * 257, 16, 5),
    "palette_16bit": lambda: ga.tiff_bytes(
        RGB[..., :1] * 257, 16, 3,
        colormap=np.random.default_rng(1).integers(0, 65536, (65536, 3))),
    "half_floats": lambda: ga.tiff_bytes(
        RGB[..., :1].astype(np.float16), 16, 1, sampleformat=3),
    "float_8bit": lambda: ga.tiff_bytes(RGB[..., :1], 8, 1, sampleformat=3),
    "five_samples": lambda: ga.tiff_bytes(np.concatenate(
        [A4, RGB[..., :1]], -1), 8, 2, extra=(2, 0)),
    "rgba_float": lambda: ga.tiff_bytes(A4.astype(np.float32), 32, 2,
                                        extra=(2,), sampleformat=3),
    "rgb_4bit": lambda: ga.tiff_bytes(RGB >> 4, 4, 2),
    "rgb_two_channels": lambda: ga.tiff_bytes(A4[..., :2] * 257, 16, 2),
    "tile_bytes_wrong": lambda: _retag(ga.tiff_bytes(RGB, 8, 2, tile=(16,
                                                                     16)),
                                       325, 700),
    "lzma": lambda: _retag(ga.tiff_bytes(RGB, 8, 2), 259, 34925),
    "orientation_turned_not_square": lambda: ga._cvtiff_module()._with_tag(
        ga.tiff_bytes(RGB, 8, 2, rows_per_strip=2), 274, 6),
    "gif_frame_outside_screen": lambda: ga.gif_bytes(IDX, PAL, screen=(4, 3),
                                                     offset=(2, 1)),
    "gif_background_past_table": lambda: _gif_edit(
        ga.gif_bytes(IDX & 3, PAL[:4]), 11, 9),
    "gif_index_past_table": lambda: ga.gif_bytes(IDX, PAL[:4], min_bits=4),
    "gif_control_block_of_5": lambda: ga.gif_bytes(IDX, PAL).replace(
        b",", b"!\xf9\x05\x01\x00\x00\x03\x00\x00,", 1),
    "gif_code_size_12": lambda: _gif_edit(
        ga.gif_bytes(IDX, PAL, min_bits=4),
        _gif_data_start(ga.gif_bytes(IDX, PAL, min_bits=4)), 12),
    "gif_signature": lambda: b"GIF88a" + ga.gif_bytes(IDX, PAL)[6:],
    "gif_without_trailer": lambda: ga.gif_bytes(IDX, PAL)[:-1],
    "gif_junk_block": lambda: ga.gif_bytes(IDX, PAL).replace(
        b",", b"\x00,", 1),
    "gif_pixels_short": lambda: ga.gif_bytes(IDX, PAL, min_bits=4,
                                             lzw=ga.lzw_encode(IDX.reshape(
                                                 -1)[:-1].astype(np.uint8)
                                                 .tobytes(), 4, msb=False)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_mirror_cv2(tmp_path, case):
    """Each file the pip cv2 refuses, the port refuses (ValueError), so a
    scene's slot takes its default as in the JAX package."""
    data = REFUSED[case]()
    p = str(tmp_path / "r.exr")
    with open(p, "wb") as f:
        f.write(data)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert _cv2(p) is None
    with pytest.raises(ValueError):
        tio.read_image(p)


@pytest.mark.parametrize("case", ["planar_16bit", "planar_float",
                                  "samples_tag_missing"])
def test_undefined_reads_are_refused_c27(tmp_path, case):
    """ROADMAP C27: OpenCV's direct TIFF route reads a planar file's first
    plane as chunky samples, and a file without SamplesPerPixel as three,
    so most of its image comes from a buffer it never wrote (it differs
    from run to run). cv2 returns an image; the port refuses the file,
    naming C27."""
    data = {"planar_16bit": lambda: ga.tiff_bytes(RGB * 257, 16, 2,
                                                  planar=True),
            "planar_float": lambda: ga.tiff_bytes(
                RGB.astype(np.float32), 32, 2, planar=True, sampleformat=3),
            "samples_tag_missing": lambda: _retag(ga.tiff_bytes(
                RGB * 257, 16, 2), 277)}[case]()
    p = str(tmp_path / "u.exr")
    with open(p, "wb") as f:
        f.write(data)
    assert _cv2(p) is not None
    with pytest.raises(ValueError, match="C27"):
        tio.read_image(p)


def _edits(g, data, n, lo, hi):
    """n seeded single-byte edits of data[lo:hi] (tests/test_torch_pilread
    .py's rule)."""
    out = []
    for _ in range(n):
        d = bytearray(data)
        i = int(g.integers(lo, min(hi, len(data))))
        d[i] = (0, 1, 255, d[i] ^ 1 << int(g.integers(8)))[int(g.integers(4))]
        out.append(bytes(d))
    return out


def _gif_data_start(data):
    """The offset of a one-frame GIF's LZW code size byte."""
    pos = data.index(b",")
    fl = data[pos + 9]
    return pos + 10 + (3 * (2 << (fl & 7)) if fl & 0x80 else 0)


def _edit_bases():
    """name -> (file, first and last byte edited): the TIFFs' headers,
    strip tables and data (OpenCV's libtiff decodes a broken strip as far
    as it goes, C27), the GIFs' blocks before their LZW data."""
    from PIL import Image
    b = io.BytesIO()
    Image.fromarray(RGB.astype(np.uint8)).save(b, "TIFF",
                                               compression="tiff_lzw")
    gif = ga.gif_bytes(IDX, PAL, transparency=3, screen=(11, 7),
                       offset=(1, 1))
    gif_pil = io.BytesIO()
    Image.fromarray(RGB.astype(np.uint8)).convert("P").save(gif_pil, "GIF")
    gif_pil = gif_pil.getvalue()
    return {
        "tiff_rgb8_strips": (ga.tiff_bytes(RGB, 8, 2, 5, predictor=2,
                                           rows_per_strip=2), 0, 400),
        "tiff_rgb8_single": (ga.tiff_bytes(RGB, 8, 2), 0, 400),
        "tiff_pil_lzw": (b.getvalue(), 0, 400),
        "tiff_rgb16_deflate": (ga.tiff_bytes(RGB * 257, 16, 2, 8), 0, 400),
        "tiff_float_packbits": (ga.tiff_bytes(
            RGB[..., :1].astype(np.float32) / 3, 32, 1, 32773,
            sampleformat=3), 0, 400),
        "tiff_rgba8_unassoc": (ga.tiff_bytes(A4, 8, 2, extra=(2,),
                                             rows_per_strip=3), 0, 400),
        "tiff_palette_tiles": (ga.tiff_bytes(
            IDX[..., None], 4, 3, colormap=PAL * 257, tile=(16, 16)), 0, 400),
        "gif": (gif, 0, _gif_data_start(gif) + 1),
        "gif_pil": (gif_pil, 0, _gif_data_start(gif_pil) + 1)}


EDIT_BASES = _edit_bases()
# the edits whose GIF code stream runs past the frame's last pixel, which
# the port does not decide yet (C27: NotImplementedError)
C27_EDITS = {"gif_pil": 1}


@pytest.mark.parametrize("name", sorted(EDIT_BASES))
def test_edits_match_cv2(tmp_path, name):
    """Seeded single-byte edits: the port decodes each edited file as the
    pip cv2 does, or refuses it where cv2 does; a GIF whose codes run past
    the frame's last pixel raises NotImplementedError naming C27, and
    those edits are counted."""
    data, lo, hi = EDIT_BASES[name]
    g = np.random.default_rng(sum(map(ord, name)))
    c27 = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for d in _edits(g, data, 40, lo, hi):
            try:
                _assert_same(tmp_path, d)
            except NotImplementedError as e:
                assert "C27" in str(e)
                c27 += 1
    assert c27 == C27_EDITS.get(name, 0)


@pytest.mark.parametrize("name", ["cbox_sky_cvtiff", "env_sphere_cvgif"])
def test_twin_scenes_load_as_jax(name):
    """`cbox_sky_cvtiff` (a float32 TIFF sky named .exr) and
    `env_sphere_cvgif` (a GIF projector named .hdr) load in the port as
    the JAX Scene loads them through the pip cv2: the same arrays."""
    from tests import torch_scenes as ts
    from tests.test_torch_scene import _assert_same_scene
    from tests.torch_parity import jax_scene_arrays
    from vision_tpu.scene.scene import Scene as JScene
    import vision_tpu_torch as vt
    kw = dict(sub_div=8) if name.startswith("env") else {}
    s = getattr(ts, name)(16, **kw)
    ps = vt.load_scene(s, device="cpu")
    _assert_same_scene(ps.data, ps.camera, ps.filter, jax_scene_arrays(
        JScene(s)))


@pytest.mark.parametrize("name", ["cbox_sky_cvtiff", "env_sphere_cvgif"])
def test_twin_scenes_render_as_their_references(name):
    """Each twin renders as its reference (the pip cv2's decode of its
    file read from a FLOAT OpenEXR file, or a PFM named .hdr): the same
    atlas, the same render, bit for bit (32^2, 1 spp on the CPU)."""
    import torch
    import vision_tpu_torch as vt
    from tests import torch_scenes as ts
    kw = dict(sub_div=8) if name.startswith("env") else {}
    a = vt.load_scene(getattr(ts, name)(32, **kw), device="cpu")
    b = vt.load_scene(getattr(ts, name + "_ref")(32, **kw), device="cpu")
    assert torch.equal(a.data.atlas.data, b.data.atlas.data)
    assert torch.equal(vt.render(a, spp=1), vt.render(b, spp=1))


def test_gif_without_a_table_reads_a_ramp_with_white_one():
    """OpenCV's GIF reader, given no colour table, reads each index as its
    grey level but index 1 as white."""
    idx = np.arange(256).reshape(16, 16)
    got = cvread.read_gif_cv(ga.gif_bytes(idx, None, min_bits=8))
    want = np.where(idx == 1, 255, idx)
    np.testing.assert_array_equal(got, np.repeat(want[..., None], 3, -1))
    assert cv2.__version__.startswith("5.")


@pytest.mark.parametrize("seed, cv2_decodes", [(1, True), (0, False)])
def test_gif_codes_past_the_frame_name_c27(tmp_path, seed, cv2_decodes):
    """A GIF whose codes give one pixel more than its frame holds: the pip
    cv2 decodes some such streams (the frame's pixels, the extra one
    dropped) and refuses others, by a rule not modelled yet, so the port
    raises NotImplementedError naming ROADMAP C27 for both. Codes that give
    one pixel fewer are refused by both (`gif_pixels_short`)."""
    g = np.random.default_rng(seed)
    idx = g.integers(0, 4, (6, 9))
    codes = np.append(idx.reshape(-1), g.integers(0, 4)).astype(np.uint8)
    data = ga.gif_bytes(idx, PAL, min_bits=4,
                        lzw=ga.lzw_encode(codes.tobytes(), 4, msb=False))
    p = str(tmp_path / "o.hdr")
    with open(p, "wb") as f:
        f.write(data)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _cv2(p)
    assert (want is not None) == cv2_decodes
    if cv2_decodes:
        np.testing.assert_array_equal(want, PAL[idx].astype(np.float32))
    with pytest.raises(NotImplementedError, match="C27"):
        tio.read_image(p)
