"""Slice 7e.2: OpenEXR files whose reference is OpenCV's own conversion.
The pip `cv2` the JAX package imports reads no EXR (its build says
`OpenEXR: NO`), so the reference is the system OpenCV 4.6.0, linked to
libOpenEXR 3.1 (ROADMAP C22): `tools/gen_torch_exr.py` writes each file
with libOpenEXR (`tools/exr_tool.cpp`) and keeps `cv::imread(p,
IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`'s decode (`tools/cv_read.cpp`) as the
JAX package's loader returns it, in `tests/assets_torch/exr_cv_decodes.npz`.
The files: luminance-chroma files (RgbaOutputFile's Y, RY, BY) under every
compression and with their own chromaticities, other sub-samplings,
channel sets (R and G; G; Z; Y and Z; Y and RY; ...), UINT channels alone
and mixed with HALF and FLOAT, deep scanlines of 0-4 samples a pixel with
Z, ZBack and A (ties and samples out of depth order), B44 and DWA
channels marked perceptually linear, DWA blocks of version 1, and B44's
log table over every 16-bit value. The tolerance is exact everywhere."""
import hashlib
import os
import struct
import warnings

import numpy as np
import pytest

from tests.torch_scenes import ASSETS
from vision_tpu_torch.scene import imageio as tio

CV = np.load(os.path.join(ASSETS, "exr_cv_decodes.npz"))
FILES = sorted(k for k in CV.files if ":" not in k)
TIMING = sorted({k.split(":")[0] for k in CV.files if ":" in k})


def _read(fn):
    with open(os.path.join(ASSETS, fn), "rb") as f:
        return f.read()


def _same(got, want):
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("fn", FILES)
def test_exr_matches_opencv(fn):
    """Every file decodes bit for bit (NaN payloads included) to OpenCV
    4.6.0's decode, through `read_exr` and through `read_image`."""
    _same(tio.read_exr(_read(fn)), CV[fn])
    img, kind = tio.read_image(os.path.join(ASSETS, fn))
    assert kind == "hdr"
    _same(img, CV[fn])


@pytest.mark.parametrize("fn", TIMING)
def test_exr_opencv_large_files(fn):
    """`yc_2048.exr` (2048 x 1024 luminance-chroma, PIZ), `deep_512.exr`
    (512^2, 1-4 samples a pixel, ZIPS) and `b44a_log_table.exr` (every
    16-bit value through B44's log table): each decode's sha256 and
    128 x 128 corner are OpenCV's."""
    got = tio.read_exr(_read(fn))
    np.testing.assert_array_equal(got[:128, :128].view(np.uint32),
                                  CV[fn + ":corner"].view(np.uint32))
    assert hashlib.sha256(got.tobytes()).digest() == \
        CV[fn + ":sha256"].tobytes()


def _channels(fn):
    attrs, _, _ = tio._exr_part0(_read(fn))
    linear, sampling = set(), {}
    chans = tio._exr_channels(attrs["channels"][1], linear, sampling)
    return attrs, chans, linear, sampling


def test_files_cover_slice_7e2():
    """The files hold what slice 7e.2 decodes: RY and BY sub-sampled 2 x 2
    under every compression, other samplings, UINT channels, deep parts
    under NONE, RLE and ZIPS, perceptually linear B44, B44A, DWAA and
    DWAB channels, a chromaticities attribute."""
    yc, linear_comps, deep_comps, uint, other = set(), set(), set(), 0, set()
    for fn in FILES + TIMING:
        attrs, chans, linear, sampling = _channels(fn)
        comp = attrs["compression"][1][0]
        if sampling.get("RY") == (2, 2) and sampling.get("BY") == (2, 2):
            yc.add(comp)
        other |= {s for s in sampling.values() if s not in ((1, 1), (2, 2))}
        if linear:
            linear_comps.add(comp)
        if attrs.get("type", ("", b""))[1].startswith(b"deep"):
            deep_comps.add(comp)
        uint += any(dt.kind == "u" for _, dt in chans)
    assert yc == set(range(10))
    assert other >= {(2, 1), (1, 2)} and uint >= 4
    assert linear_comps >= {tio._EXR_B44, tio._EXR_B44A, tio._EXR_DWAA,
                            tio._EXR_DWAB}
    assert deep_comps == {tio._EXR_NONE, tio._EXR_RLE, tio._EXR_ZIPS}
    assert "chromaticities" in _channels("yc_chroma.exr")[0]


def _dwa_versions(fn):
    """The version field of each compressed block of a DWA file (a block
    stored raw, no smaller than its pixels, has none)."""
    data = _read(fn)
    attrs, pos = tio._exr_header(data)
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    lines = tio._EXR_LINES[attrs["compression"][1][0]]
    line = (x1 - x0 + 1) * sum(dt.itemsize for _, dt in tio._exr_channels(
        attrs["channels"][1]))
    n = -(-(y1 - y0 + 1) // lines)
    versions = []
    for off in struct.unpack(f"<{n}Q", data[pos:pos + 8 * n]):
        y, size = struct.unpack("<ii", data[off:off + 8])
        if size < line * min(lines, y1 - y + 1):
            versions.append(struct.unpack("<Q", data[off + 8:off + 16])[0])
    return versions


@pytest.mark.parametrize("fn", ["dwaa_v1.exr", "dwab_v1_y.exr"])
def test_dwa_version_1_blocks(fn):
    """The version-1 files carry no channel rules (the legacy set applies):
    every compressed block says version 1, and the decode is OpenCV's."""
    versions = _dwa_versions(fn)
    assert versions and set(versions) == {1}
    _same(tio.read_exr(_read(fn)), CV[fn])


def test_dwa_version_3_is_refused():
    """A DWA block of a version past 2 raises ValueError, as libOpenEXR
    throws on it."""
    data = bytearray(_read("dwaa_v1.exr"))
    attrs, pos = tio._exr_header(bytes(data))
    off, = struct.unpack("<Q", data[pos:pos + 8])
    data[off + 8:off + 16] = struct.pack("<Q", 3)
    with pytest.raises(ValueError, match="version 3"):
        tio.read_exr(bytes(data))


@pytest.mark.parametrize("fn", ["ch_layer.exr", "ch_a.exr"])
def test_channel_sets_opencv_refuses(fn):
    """Without R, G, B, Y or Z (layer-prefixed names, A alone) OpenCV
    returns no image and the JAX package raises: the port raises
    ValueError, so a scene's slot takes its default."""
    with pytest.raises(ValueError, match="R, G, B, Y or Z"):
        tio.read_exr(_read(fn))
    with pytest.raises(ValueError):
        tio.read_image(os.path.join(ASSETS, fn))


def test_y_and_a_decode_to_zeros():
    """C22: OpenCV 4.6.0 reads a {Y, A} file's Y into one of its three
    slots and converts the two it never wrote, so its image is its row
    buffer's old content (zeros in fresh memory); the port gives zeros.
    Libimf's InputFile alone would give Y."""
    got = tio.read_exr(_read("ch_ya.exr"))
    assert got.shape == (8, 300, 3) and not got.any()
    attrs, chans, _, _ = _channels("ch_ya.exr")
    assert [c for c, _ in chans] == ["A", "Y"]


def _patch_window(data, box, y_from=None, y_to=None):
    """`data` with its dataWindow set to `box` (and a chunk's y moved)."""
    tag = b"dataWindow\0box2i\0" + struct.pack("<i", 16)
    at = data.index(tag) + len(tag)
    out = bytearray(data)
    out[at:at + 16] = struct.pack("<iiii", *box)
    if y_from is not None:
        attrs, pos = tio._exr_header(bytes(out))
        off, = struct.unpack("<Q", out[pos:pos + 8])
        assert struct.unpack("<i", out[off:off + 4])[0] == y_from
        out[off:off + 4] = struct.pack("<i", y_to)
    return bytes(out)


def test_sub_sampled_off_the_grid_is_refused():
    """A luminance-chroma file whose width its 2 x 2 sampling does not
    divide: InputFile refuses its header (OpenCV returns no image), so the
    port raises ValueError."""
    data = _read("yc.exr")
    with pytest.raises(ValueError, match="grid"):
        tio.read_exr(_patch_window(data, (0, 0, 10, 9)))


def test_sub_sampled_away_from_the_origin_is_refused():
    """C22: OpenCV 4.6.0 places a sub-sampled channel's samples from the
    data window's corner without dividing it by the sampling, so a window
    not at (0, 0) crashes it (positive corner) or writes outside its image
    (negative corner). The port raises ValueError."""
    data = _patch_window(_read("yc.exr"), (-2, -2, 9, 7), 0, -2)
    with pytest.raises(ValueError, match=r"not at \(0, 0\)"):
        tio.read_exr(data)


def _deep_chunk(data):
    """A single-part deep scanline file -> (offset of its first chunk,
    its sizes)."""
    attrs, pos = tio._exr_header(data)
    off, = struct.unpack("<Q", data[pos:pos + 8])
    return off, struct.unpack("<iQQQ", data[off:off + 28])


def test_corrupt_deep_sample_counts_are_refused():
    """A cumulative sample count that falls (a negative count) makes
    libOpenEXR throw: ValueError."""
    data = bytearray(_read("deep_k4_none.exr"))
    off, (_, n_table, _, _) = _deep_chunk(bytes(data))
    table = np.frombuffer(data, "<i4", n_table // 4, off + 28).copy()
    k = int(np.flatnonzero(np.diff(table) > 0)[0]) + 1
    table[k] = table[k - 1] - 1
    data[off + 28:off + 28 + n_table] = table.tobytes()
    with pytest.raises(ValueError, match="sample counts"):
        tio.read_exr(bytes(data))


@pytest.mark.parametrize("fn", ["deep_k4_none.exr", "deep_k4_zips.exr"])
def test_truncated_deep_files_are_refused(fn):
    """A deep file cut inside its last chunk raises ValueError."""
    data = _read(fn)
    with pytest.raises(ValueError):
        tio.read_exr(data[:len(data) - 30])


def test_deep_zip_compression_is_refused():
    """libOpenEXR takes deep data only under NONE, RLE and ZIPS: a deep
    header naming ZIP (or any other) raises ValueError."""
    data = _read("deep_k4_zips.exr")
    tag = b"compression\0compression\0" + struct.pack("<i", 1)
    at = data.index(tag) + len(tag)
    for comp in (tio._EXR_ZIP, tio._EXR_PIZ):
        bad = data[:at] + bytes([comp]) + data[at + 1:]
        with pytest.raises(ValueError, match="deep"):
            tio.read_exr(bad)


def test_deep_composite_stops_at_full_alpha():
    """The compositing rule on a hand-built pixel set: samples in file
    order, a pixel stops at the first sample met with alpha >= 1, no
    samples give 0 (ImfDeepCompositing.cpp with one source)."""
    counts = np.array([[3, 0, 2]])
    a = np.float32([0.5, 1.0, 0.5, 1.0, 0.25])
    r = np.float32([2.0, 4.0, 8.0, 1.0, 3.0])
    z = np.float32([9.0, 1.0, 5.0, 0.0, 0.0])
    chans = [("A", np.dtype("<f4")), ("R", np.dtype("<f4")),
             ("Z", np.dtype("<f4"))]
    body = a.tobytes() + r.tobytes() + z.tobytes()    # one line: each
    table = np.cumsum(counts, axis=1).astype("<i4").tobytes()
    chunk = struct.pack("<iQQQ", 0, len(table), len(body), len(body)) + \
        table + body
    planes = tio._exr_read_deep(struct.pack("<Q", 8) + chunk, 0, 0,
                                tio._EXR_NONE, chans, 0, 0, 3, 1)
    f = np.float32
    # pixel 0: 1 * 2 (alpha 0.5), + 0.5 * 4 (alpha 1), then it stops
    assert planes["R"][0, 0] == f(1) * f(2) + (f(1) - f(0.5)) * f(4)
    assert planes["A"][0, 0] == 1.0 and planes["R"][0, 1] == 0
    # pixel 2: 1.0 * 1 first (alpha 1), the second sample hidden
    assert planes["R"][0, 2] == 1.0


# ---------------------------------------------------------------------------
# the twin scenes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("twin, original", [
    ("sky_a_pfm.hdr", "sky_a.hdr"), ("sky_b_deep.exr", "sky_b.hdr"),
    ("sky_yc_ref.exr", "sky_yc.exr")])
def test_twin_files_hold_the_same_arrays(twin, original):
    """Each twin scene's file decodes to the very array of the file it
    stands for: the PFM and the deep file to the .hdr skies' decodes, the
    plain FLOAT file to OpenCV's decode of the luminance-chroma sky."""
    a = tio.read_image(os.path.join(ASSETS, twin))[0]
    b = tio.read_image(os.path.join(ASSETS, original))[0]
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("name", ["cbox_sky_yc", "env_sphere_cv"])
def test_twin_scenes_render_as_their_references(name):
    """`cbox_sky_yc` renders as `cbox_sky_yc_ref`, `env_sphere_cv` as
    `env_sphere`: the same lights and atlas, the same render, bit for bit
    (16^2, 1 spp on the CPU); every image loads, none falling back to its
    slot's default."""
    import torch
    import vision_tpu_torch as vt
    from tests import torch_scenes as ts
    make = {"cbox_sky_yc": (ts.cbox_sky_yc_ref, ts.cbox_sky_yc, {}),
            "env_sphere_cv": (ts.env_sphere, ts.env_sphere_cv,
                              dict(sub_div=8))}[name]
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # an image that fails to load warns
        a = vt.load_scene(make[0](16, **make[2]), device="cpu")
        b = vt.load_scene(make[1](16, **make[2]), device="cpu")
    assert torch.equal(a.data.atlas.data, b.data.atlas.data)
    assert torch.equal(vt.render(a, spp=1), vt.render(b, spp=1))
