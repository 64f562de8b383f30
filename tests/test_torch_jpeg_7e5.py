"""Slice 7e.5: the JPEG files PIL (libjpeg-turbo 3.1) decodes that the
port refused before, and the one it must refuse.

  * Progressive files whose scans leave any of coefficients 1-9
    unfinished (a file cut between its scans, or meeting EOI inside one):
    libjpeg-turbo's block smoothing (jdcoefct.c decompress_smooth_data)
    estimates them from the DC values of the 5x5 blocks around each
    block, with the coefficient bits of the scan that last passed each
    iMCU row; the port's model is `imageio._block_smoothing`. Huffman-
    (PIL's and the pip cv2's writers, 4:4:0 and 4:1:1 and restart
    intervals among them) and arithmetic-coded files
    (`tools/gen_torch_assets.py` `arith_jpeg_bytes`), cut at every SOS
    and inside scans, at sizes of 1, 2, 3 and 8+ block rows and columns.
  * Lossless files with subsampled components (`lossless_jpeg_bytes`'
    sampling and per-component scans): libjpeg's MCUs of h x v samples,
    its undifferencing an iMCU row at a time, the components replicated
    up to full size.
  * Arithmetic-coded lossless files (SOF11), which libjpeg-turbo refuses
    whatever their data: ValueError on PIL's and OpenCV's routes, and a
    scene naming one loads with the slot's default as the JAX Scene does.
  * The routes that embed a JPEG stream: TIFF compression 7 (libtiff's
    JPEG codec on both routes), BLP1 JPEG and IPTC.
  * The committed files (`jpeg_7e5_decodes.npz`) and the twins
    `cbox_tex_smooth` / `env_sphere_lossless`.

Every decode is held against PIL's by path (or `cv2.imread` through the
JAX package's loader under a .exr name), bit for bit."""
import hashlib
import os
import warnings

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.torch_scenes import ASSETS, gen_assets as ga, gen_pil as gp
from vision_tpu.scene import texture as jtex
from vision_tpu_torch.scene import imageio as tio
from vision_tpu_torch.scene import texture as ttex

warnings.filterwarnings("ignore", category=UserWarning, module="PIL")


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


def _same(tmp_path, data, name="f.jpg", decodes=True):
    """The port's decode of `data` named `name` equals PIL's (a .jpg, .tif,
    .blp or .iim name) or the JAX loader's through cv2 (a .exr name), or
    (decodes False) both refuse it; decodes None: either, as they agree.
    Returns whether it decoded."""
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    if name.endswith(".exr"):
        try:
            want = jtex.load_image(p)
        except Exception:
            want = None
        try:
            got = ttex.load_image(p)
        except ValueError:
            got = None
    else:
        want, got = _pil(p), _port(p)
    if decodes is None:     # either outcome, so long as both agree
        decodes = want is not None and got is not None
    if not decodes:
        assert want is None and got is None, (want is None, got is None)
        return False
    assert want is not None, "the reference refuses it"
    assert got is not None, "the port refuses it"
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return True


def _image(g, h, w):
    """Smooth waves with a little noise, uint8 [h, w, 3]."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7 + c) * np.cos(y / 5 - c)
                     for c in range(3)], -1)
    return np.clip(base + g.normal(0, 10, base.shape), 0,
                   255).astype(np.uint8)


def _sos(data):
    return [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]


def _cuts(g, data, n_inside=4):
    """`data` cut at each of its SOS markers but the first (EOI in its
    place) and inside `n_inside` seeded scans (EOI appended)."""
    sos = _sos(data)
    out = [data[:s] + b"\xff\xd9" for s in sos[1:]]
    for _ in range(n_inside):
        k = int(g.integers(len(sos)))
        lo = sos[k] + 8 + 2 * data[sos[k] + 4]       # the scan's data
        hi = next(i for i in range(lo, len(data) - 1) if data[i] == 0xFF
                  and data[i + 1] != 0 and not 0xD0 <= data[i + 1] <= 0xD7)
        if hi > lo + 1:
            out.append(data[:int(g.integers(lo + 1, hi))] + b"\xff\xd9")
    return out


# sizes of 1, 2, 3 and 8+ iMCU rows and block columns
SIZES = [(8, 8), (16, 9), (17, 24), (20, 28), (5, 70), (70, 3), (33, 47),
         (80, 130)]
PIL_SAMPLING = {"grey": None, "444": 0, "422": 1, "420": 2}


@pytest.mark.parametrize("kind", sorted(PIL_SAMPLING))
def test_cut_progressive_files_match_pil(tmp_path, kind):
    """PIL-written progressive files at every size of SIZES and qualities
    50-95, cut at every SOS and inside scans, as PIL decodes them: the
    coefficients left unfinished estimated by libjpeg's block smoothing."""
    g = np.random.default_rng(sorted(PIL_SAMPLING).index(kind))
    for h, w in SIZES:
        a = _image(g, h, w)
        kw = dict(progressive=True, quality=int(g.integers(50, 96)))
        if kind == "grey":
            data = ga._pil_jpeg(a[..., 0], **kw)
        else:
            data = ga._pil_jpeg(a, subsampling=PIL_SAMPLING[kind], **kw)
        for c in _cuts(g, data):
            _same(tmp_path, c)


CV_SAMPLING = {"440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
               "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
               "420_rst": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


@pytest.mark.parametrize("kind", sorted(CV_SAMPLING))
def test_cut_cv2_progressive_files_match_pil(tmp_path, kind):
    """Progressive files the pip cv2 writes (4:4:0, 4:1:1, and 4:2:0 with a
    restart interval), cut at every SOS and inside scans, as PIL decodes
    them; a few under a .exr name as the pip cv2 decodes them."""
    g = np.random.default_rng(len(kind))
    for h, w in SIZES[1::2]:
        rst = int(g.integers(1, 4)) if "rst" in kind else 0
        data = ga._cv_jpeg(_image(g, h, w), CV_SAMPLING[kind], rst)
        cuts = _cuts(g, data)
        for c in cuts:
            _same(tmp_path, c)
        _same(tmp_path, cuts[-1], "f.exr")


@pytest.mark.parametrize("sampling", [((1, 1),), ((2, 2), (1, 1), (1, 1)),
                                      ((2, 1), (1, 1), (1, 1)),
                                      ((1, 2), (1, 1), (1, 1))],
                         ids=["grey", "420", "422", "440"])
def test_cut_arithmetic_progressive_files_match_pil(tmp_path, sampling):
    """Arithmetic-coded progressive files (SOF10) of 1-4 MCU rows and
    columns, restart intervals on and off, cut at every SOS and inside
    scans, as PIL decodes them (libjpeg smooths them as Huffman ones)."""
    g = np.random.default_rng(len(sampling) * 3 + sampling[0][0])
    for mcus, restart in (((1, 1), 0), ((2, 3), 1), ((4, 1), 0),
                          ((3, 4), 2)):
        q = int(g.integers(2, 12))
        coef = ga._coefficients(sampling, mcus, q, int(g.integers(1000)))
        data = ga.arith_jpeg_bytes(coef, sampling, q=q, progressive=True,
                                   restart=restart)
        for c in _cuts(g, data, 3):
            _same(tmp_path, c)


def test_smoothing_window_at_the_edges():
    """The model's neighbours: the 5x5 window's columns repeat the first
    and last block column (a picture one or two blocks wide too), and its
    rows follow decompress_smooth_data's arithmetic, where the last iMCU
    row's block count stands in for v (two iMCU rows of a 4:2:0 luma plane
    three blocks high: the third row reads the first as two above)."""
    np.testing.assert_array_equal(tio._smooth_cols(1), [[0] * 5])
    np.testing.assert_array_equal(tio._smooth_cols(2), [[0, 0, 0, 1, 1],
                                                        [0, 0, 1, 1, 1]])
    rows = tio._smooth_rows(2, 2, 3)
    np.testing.assert_array_equal(rows, [[0, 0, 0, 0, 1, 2],
                                         [0, 0, 0, 1, 2, 3],
                                         [1, 1, 1, 2, 2, 2]])


# ---------------------------------------------------------------------------
# subsampled lossless
# ---------------------------------------------------------------------------

LOSSLESS_SAMPLING = [((2, 2), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1)),
                     ((1, 2), (1, 1), (1, 1)), ((1, 1), (2, 2), (1, 1)),
                     ((4, 1), (1, 1), (2, 1)), ((2, 2),),
                     ((2, 2), (1, 1), (1, 1), (2, 2))]


@pytest.mark.parametrize("per_component", [False, True],
                         ids=["interleaved", "planes"])
@pytest.mark.parametrize("psv", range(1, 8))
def test_subsampled_lossless_matches_pil(tmp_path, psv, per_component):
    """Lossless files of 1, 3 and 4 components at odd sizes, sampled 2x2,
    2x1, 1x2, 4x1 and so on, in one interleaved scan or one scan a
    component, point transforms 0-2, with and without restart intervals,
    as PIL decodes them (the undifferencers reset on the first row of an
    iMCU row in which a restart was read, as libjpeg's are)."""
    g = np.random.default_rng(psv * 2 + per_component)
    decoded = 0
    for k, sampling in enumerate(LOSSLESS_SAMPLING * 2):
        h, w = int(g.integers(1, 30)), int(g.integers(1, 30))
        a = _image(g, h, w)
        a = np.concatenate([a, a[..., :1]], -1)[..., :len(sampling)]
        # a restart interval of whole rows of the first scan may not be
        # whole rows of the others': then both refuse the file
        decoded += _same(tmp_path, ga.lossless_jpeg_bytes(
            a, psv, k % 3, k % 3, sampling=sampling,
            per_component=per_component), decodes=None)
    assert decoded >= len(LOSSLESS_SAMPLING)


@pytest.mark.parametrize("sampling", LOSSLESS_SAMPLING[:3],
                         ids=["420", "422", "440"])
def test_subsampled_lossless_matches_cv2(tmp_path, sampling):
    """The same under a .exr name, against the JAX loader's `cv2.imread`
    (its libjpeg-turbo 3.1.2 decodes them as PIL's does)."""
    g = np.random.default_rng(len(sampling))
    for per, rst in ((False, 0), (False, 2), (True, 0)):
        a = _image(g, int(g.integers(2, 30)), int(g.integers(2, 30)))
        _same(tmp_path, ga.lossless_jpeg_bytes(
            a, int(g.integers(1, 8)), 0, rst, sampling=sampling,
            per_component=per), "f.exr")


def test_lossless_refusals_as_pil(tmp_path):
    """An interleaved scan of more than 10 samples an MCU, and a restart
    interval that is not whole MCU rows of a one-component scan, are
    refused as PIL refuses them."""
    a = _image(np.random.default_rng(3), 10, 9)
    _same(tmp_path, ga.lossless_jpeg_bytes(
        a, 1, sampling=((4, 2), (2, 1), (1, 1))), decodes=False)
    # a restart every 9 MCUs: whole rows of the first scan, not of the
    # second's 5 samples a row
    _same(tmp_path, ga.lossless_jpeg_bytes(a, 1, 0, 1, sampling=(
        (2, 1), (1, 1), (1, 1)), per_component=True), decodes=False)


@pytest.mark.parametrize("name", ["f.jpg", "f.exr"])
def test_arithmetic_lossless_is_refused(tmp_path, name):
    """SOF11 (arithmetic-coded lossless) is refused with ValueError on PIL's
    and OpenCV's routes whatever its data: libjpeg-turbo's lossless
    decoder takes Huffman coding only."""
    d = bytearray(ga.lossless_jpeg_bytes(_image(np.random.default_rng(4),
                                                12, 9)))
    d[d.index(b"\xff\xc3") + 1] = 0xCB
    s = d.index(b"\xff\xda")
    zeros = bytes(d[:s + 14]) + bytes(200) + b"\xff\xd9"
    for data in (bytes(d), zeros):
        with pytest.raises(ValueError, match="arithmetic-coded lossless"):
            tio.read_jpeg(data)
        _same(tmp_path, data, name, decodes=False)


@pytest.mark.parametrize("name", ["cbox_tex", "env_sphere"])
def test_scene_naming_an_arithmetic_lossless_file_loads_as_jax(name):
    """A scene whose texture (`cbox_tex`'s checker, K1) or projector image
    (`env_sphere`'s, K2) is an SOF11 file loads in both packages: the slot
    takes its default with a warning, and the port's tables equal the JAX
    Scene's."""
    from tests import torch_scenes as ts
    from tests.test_torch_scene import _assert_same_scene
    from tests.torch_parity import jax_scene_arrays
    from vision_tpu.scene.scene import Scene as JScene
    import vision_tpu_torch as vt
    fn = {"cbox_tex": "checker.png", "env_sphere": "projector.png"}[name]
    s = ts._swap_files(getattr(ts, name)(16), {fn: "ll_arith.jpg"})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ps = vt.load_scene(s, device="cpu")
    assert any("ll_arith.jpg" in str(w.message) or "arithmetic" in
               str(w.message) for w in caught)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_scene_arrays(JScene(s))
    _assert_same_scene(ps.data, ps.camera, ps.filter, ref)


# ---------------------------------------------------------------------------
# the routes that embed a JPEG stream
# ---------------------------------------------------------------------------

def _prog_cut(a, mode=None, **kw):
    """PIL's progressive JPEG of `a` (converted to `mode`) cut inside its
    third scan and before its fifth."""
    data = ga._pil_jpeg(a, mode, progressive=True, quality=85, **kw)
    s = _sos(data)[2]
    lo = s + 8 + 2 * data[s + 4]
    hi = next(i for i in range(lo, len(data) - 1) if data[i] == 0xFF
              and data[i + 1] != 0 and not 0xD0 <= data[i + 1] <= 0xD7)
    return ga.cut_jpeg(data, 2, (hi - lo) // 2), ga.cut_jpeg(data, 4)


@pytest.mark.parametrize("name", ["t.tif", "t.exr"])
def test_tiff_jpeg_strips_read_as_libtiff(tmp_path, name):
    """TIFF compression 7 on PIL's route and OpenCV's (both libtiff's JPEG
    codec): a YCbCr strip of a cut progressive stream, with and without
    its EOI (libtiff's data source feeds EOI markers past a strip's end,
    so a stream cut inside a marker segment reads on into them), decodes
    as libtiff gives it; an RGB strip of a JFIF (YCbCr) stream gives its
    samples unconverted (JCS_UNKNOWN), and one sampled 2x2 is refused; a
    lossless stream under YCbCr (colour conversion asked) is refused,
    under RGB it decodes."""
    g = np.random.default_rng(5)
    a = _image(g, 24, 30)
    decoded = 0
    for sub in (0, 2):
        sf = (1, 1) if sub == 0 else (2, 2)
        for cut in _prog_cut(a, subsampling=sub):
            for strip in (cut, cut[:-2], cut[:-40]):
                decoded += _same(tmp_path, ga.tiff_bytes(
                    a, 8, 6, 7, jpeg_chunks=[strip], ycbcr_sub=sf), name,
                    decodes=None)
    assert decoded >= 10
    data = ga._pil_jpeg(a, quality=90, subsampling=0)
    _same(tmp_path, ga.tiff_bytes(a, 8, 2, 7, jpeg_chunks=[data]), name)
    data = ga._pil_jpeg(a, quality=90, subsampling=2)
    _same(tmp_path, ga.tiff_bytes(a, 8, 2, 7, jpeg_chunks=[data]), name,
          decodes=False)
    ll = ga.lossless_jpeg_bytes(a, 1, sampling=((2, 2), (1, 1), (1, 1)))
    _same(tmp_path, ga.tiff_bytes(a, 8, 6, 7, jpeg_chunks=[ll],
                                  ycbcr_sub=(2, 2)), name, decodes=False)
    _same(tmp_path, ga.tiff_bytes(a, 8, 2, 7, jpeg_chunks=[
        ga.lossless_jpeg_bytes(a, 4)]), name)


@pytest.mark.parametrize("mode", ["L", "RGB", "CMYK"])
def test_blp1_jpeg_levels_as_pil(tmp_path, mode):
    """BLP1 JPEG (PIL's JPEG plugin on the header and level): a cut
    progressive stream, smoothed, and a subsampled lossless one."""
    g = np.random.default_rng(len(mode))
    h, w = 21, 26
    streams = list(_prog_cut(_image(g, h, w), mode))
    if mode != "CMYK":
        rgb = _image(g, h, w)
        streams.append(ga.lossless_jpeg_bytes(
            rgb[..., :1] if mode == "L" else rgb, 2,
            sampling=((2, 2),) if mode == "L" else ((2, 1), (1, 1), (1, 1))))
    for js in streams:
        s = js.index(b"\xff\xda")
        _same(tmp_path, gp.blp_bytes(w, h, js[s:], 1, comp=0,
                                     jpeg_header=js[:s]), "x.blp")


def test_iptc_jpeg_images_as_pil(tmp_path):
    """IPTC's JPEG image (comp 5) through PIL's JPEG plugin: a cut
    progressive stream and a subsampled lossless one, as a grey file's
    image."""
    g = np.random.default_rng(9)
    h, w = 19, 33
    a = _image(g, h, w)
    for js in (*_prog_cut(a), *_prog_cut(a, "L"),
               ga.lossless_jpeg_bytes(a, 7, sampling=(
                   (2, 2), (1, 1), (1, 1)))):
        _same(tmp_path, gp.iptc_bytes(w, h, js, comp=5), "x.iim")


# ---------------------------------------------------------------------------
# the committed files, the twins
# ---------------------------------------------------------------------------

DECODES = np.load(os.path.join(ASSETS, "jpeg_7e5_decodes.npz"))
FILES = sorted(k for k in DECODES.files if ":" not in k)


@pytest.mark.parametrize("fn", FILES)
def test_committed_files_match_their_pil_decodes(fn):
    """Each file of `tools/gen_torch_assets.py` `jpeg_7e5_files` decodes
    to PIL's stored decode (the files `chip_smoke.py` holds on the card's
    host)."""
    got, kind = tio.read_image(os.path.join(ASSETS, fn))
    assert kind == "ldr"
    np.testing.assert_array_equal(got, DECODES[fn])


def test_smooth_2048_cuts_match_their_pil_decodes():
    """`smooth_2048.jpg` cut after its DC scan and after its first AC scan
    (`smooth_cuts`, as `chip_smoke.py` cuts it) decodes to PIL's decodes:
    their sha256 and corners."""
    with open(os.path.join(ASSETS, "smooth_2048.jpg"), "rb") as f:
        big = f.read()
    assert len(big) <= 400 * 1024
    for fn, data in ga.smooth_cuts(big).items():
        got = tio.read_jpeg(data)
        np.testing.assert_array_equal(got[:128, :128],
                                      DECODES[fn + ":corner"])
        assert hashlib.sha256(got.tobytes()).digest() == \
            DECODES[fn + ":sha256"].tobytes(), fn


def test_twins_files():
    """The twins' PNGs hold PIL's decodes of their JPEGs, and the SOF11
    file is refused."""
    for a, b in (("checker_smooth.jpg", "checker_smooth_pil.png"),
                 ("projector_lossless.jpg", "projector_lossless_pil.png")):
        np.testing.assert_array_equal(
            tio.read_image(os.path.join(ASSETS, a))[0],
            tio.read_image(os.path.join(ASSETS, b))[0])
    with pytest.raises(ValueError):
        tio.read_image(os.path.join(ASSETS, "ll_arith.jpg"))


@pytest.mark.parametrize("name", ["cbox_tex_smooth", "env_sphere_lossless"])
def test_twin_scenes_render_as_their_references(name):
    """`cbox_tex_smooth` (K1) renders as `cbox_tex_smooth_ref`,
    `env_sphere_lossless` (K2) as `env_sphere_lossless_ref`: the same
    atlas, the same render, bit for bit (64^2, 1 spp on the CPU); and the
    twin's tables equal the JAX Scene's."""
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


def test_no_reader_names_7e5():
    """No module of the port names slice 7e.5 any more."""
    import pathlib
    root = pathlib.Path(tio.__file__).parent.parent
    assert not [p for p in root.rglob("*") if p.suffix in (
        ".py", ".cpp", ".cu", ".cuh", ".h") and "7e.5" in p.read_text()]
