"""ROADMAP C28: TIFF files PIL opens that the port said no plugin
identifies. Every key of PIL 12.1.0's `TiffImagePlugin.OPEN_INFO` (its
modes, by byte order, photometric, sample format, fill order, bits and
extra samples) has a kind in the port (`imageio._tiff_mode`), and a file
of each key's layout, written by `tools/gen_torch_assets.py`'s
`tiff_bytes`, decodes bit for bit as `PIL.Image.open(p).convert("RGB")`
decodes it, or is refused where PIL refuses it. Then C28's repairs one by
one: 8-bit CIELab (PIL's raw mode LAB, LittleCMS's LAB -> sRGB), 12-bit
little-endian grey (raw mode I;12), PIL's two odd headers ("MM*\\0" and
"II\\0*") and BigTIFF as PIL reads them. The tolerance is exact."""
import warnings

import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

from tests.torch_scenes import gen_assets as ga
from vision_tpu_torch.scene import imageio as tio
from vision_tpu_torch.scene import pilread

warnings.filterwarnings("ignore", category=UserWarning, module="PIL")

KEYS = sorted(TiffImagePlugin.OPEN_INFO, key=repr)


def _pil(path):
    """PIL's decode, or None where PIL raises."""
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except Exception:     # the JAX package's loader catches every error
        return None


def _assert_same(tmp_path, data, decodes=None):
    """The port's decode of `data` (a .tif) equals PIL's, or both refuse
    it (the port with ValueError); `decodes`: whether PIL must decode."""
    p = str(tmp_path / "t.tif")
    with open(p, "wb") as f:
        f.write(data)
    want = _pil(p)
    if decodes is not None:
        assert (want is not None) == decodes, "PIL's outcome"
    if want is None:
        with pytest.raises(ValueError):
            tio.read_image(p)
        return
    got, kind = tio.read_image(p)
    assert kind == "ldr" and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _key_file(key, g):
    """A 6 x 9 uncompressed TIFF of an OPEN_INFO key's layout, random
    samples of its bits (floats for sample format 3), a random colour map
    for a palette."""
    bo, photo, sf, fill, bps, extra = key
    bits = bps[0]
    shape = (6, 9, len(bps))
    if sf[0] == 3:
        v = (g.random(shape) * 300 - 20).astype(np.float32)
    else:
        v = g.integers(0, 1 << min(bits, 31), shape)
    cmap = g.integers(0, 65536, (1 << bits, 3)) if photo == 3 else None
    return ga.tiff_bytes(v, bits, photo, fill=fill,
                         bo="<" if bo == b"II" else ">", extra=extra,
                         sampleformat=sf[0] if sf != (1,) else None,
                         colormap=cmap)


@pytest.mark.parametrize("key", KEYS, ids=lambda k: "-".join(
    str(x) for x in (k[0].decode(), k[1], k[2], k[3], k[4], k[5])))
def test_open_info_key_has_a_kind(tmp_path, key):
    """Each of PIL's 120 TIFF layouts has a kind in the port, and a file
    of that layout decodes as PIL decodes it (or both refuse it)."""
    bo, photo, sf, fill, bps, extra = key
    assert tio._tiff_mode("<" if bo == b"II" else ">", photo, sf, fill, bps,
                          extra) is not None
    if len(set(bps)) == 1:
        g = np.random.default_rng(len(KEYS) + KEYS.index(key))
        _assert_same(tmp_path, _key_file(key, g))


def test_open_info_and_prefixes_are_pil_12_1s():
    """The walk above is over PIL 12.1.0's table, and the port's TIFF
    headers are PIL's six (byte order from bytes 0-1, BigTIFF where byte
    2 is 43)."""
    assert len(KEYS) == 120
    assert set(pilread.TIFF_PREFIXES) == set(TiffImagePlugin.PREFIXES)


LAB = np.random.default_rng(28).integers(0, 256, (13, 21, 3))


@pytest.mark.parametrize("bo", ["<", ">"])
@pytest.mark.parametrize("comp, planar", [(1, False), (5, False), (8, False),
                                          (32773, False), (1, True),
                                          (5, True)])
def test_cielab_matches_pil(tmp_path, bo, comp, planar):
    """8-bit CIELab in both byte orders, uncompressed or through libtiff,
    chunky (PIL's raw mode LAB flips a* and b*'s sign bits) or planar (its
    A and B bands copy the bytes)."""
    _assert_same(tmp_path, ga.tiff_bytes(LAB, 8, 8, comp, bo=bo, planar=planar,
                                         rows_per_strip=5), decodes=True)


def test_cielab_triples_match_pil(tmp_path):
    """A seeded share of the 2^24 Lab triples and the cube's corners and
    edges, through PIL's LAB -> RGB (LittleCMS) and the port's."""
    g = np.random.default_rng(24)
    ends = np.array([0, 1, 127, 128, 129, 254, 255])
    corners = np.stack(np.meshgrid(ends, ends, ends, indexing="ij"),
                       -1).reshape(-1, 3)
    triples = np.concatenate([corners, g.integers(0, 256, (65536 - len(
        corners), 3))])
    _assert_same(tmp_path, ga.tiff_bytes(triples.reshape(256, 256, 3), 8, 8),
                 decodes=True)


@pytest.mark.parametrize("comp", [1, 5, 8, 32773])
def test_grey12_matches_pil(tmp_path, comp):
    """12-bit little-endian grey: PIL's raw mode I;12 (the samples packed
    most significant bit first) into I;16, clipped at 255 by
    convert("RGB"); big-endian 12-bit has no mode, so PIL identifies no
    file."""
    v = np.random.default_rng(12).integers(0, 4096, (7, 11, 1))
    v[0, :5, 0] = (0, 100, 255, 256, 4095)
    _assert_same(tmp_path, ga.tiff_bytes(v, 12, 1, comp, rows_per_strip=3),
                 decodes=True)
    _assert_same(tmp_path, ga.tiff_bytes(v, 12, 1, comp, bo=">"),
                 decodes=False)


@pytest.mark.parametrize("comp", [1, 5, 8])
@pytest.mark.parametrize("head", [b"MM*\0", b"II\0*"])
def test_odd_headers_as_pil_reads_them(tmp_path, head, comp):
    """PIL takes "MM*\\0" as big-endian and "II\\0*" as little-endian TIFF
    and reads an uncompressed file itself; libtiff refuses both headers
    (a bad version number), so a compressed file is refused. OpenCV's
    reader knows neither header: both are refused under a .exr name."""
    rgb = np.random.default_rng(3).integers(0, 256, (5, 7, 3))
    data = head + ga.tiff_bytes(rgb, 8, 2, comp,
                                bo=">" if head[:2] == b"MM" else "<")[4:]
    _assert_same(tmp_path, data, decodes=comp == 1)
    p = str(tmp_path / "t.exr")
    with open(p, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError):
        tio.read_image(p)


@pytest.mark.parametrize("bo", ["<", ">"])
@pytest.mark.parametrize("comp, tile, long8", [(1, None, True),
                                               (5, None, False),
                                               (8, (16, 16), True),
                                               (1, (16, 16), False)])
def test_bigtiff_as_pil_reads_it(tmp_path, bo, comp, tile, long8):
    """BigTIFF on PIL's route: little-endian files decode (PIL's own reader
    for uncompressed strips and tiles, libtiff's for compressed ones);
    big-endian ones, whose byte 2 is 0, PIL reads as classic TIFF and
    identifies no file in them."""
    rgb = np.random.default_rng(43).integers(0, 256, (19, 23, 3))
    data = ga.bigtiff(ga.tiff_bytes(rgb, 8, 2, comp, bo=bo, tile=tile,
                                    rows_per_strip=6), long8=long8)
    _assert_same(tmp_path, data, decodes=bo == "<")


def test_short_headers_pass_the_file_on(tmp_path):
    """A TIFF or BigTIFF header cut before its first directory's offset
    ends: PIL's struct.error, so no plugin identifies the file."""
    for data in (b"II*\0\x08\0", b"II+\0\x08\0\0\0\x10\0"):
        with pytest.raises(pilread._PassOn):
            tio.read_tiff(data)
        _assert_same(tmp_path, data, decodes=False)
