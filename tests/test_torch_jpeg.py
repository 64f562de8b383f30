"""The port's JPEG decoder (`vision_tpu_torch/scene/imageio.py` `read_jpeg`,
entropy decoding in `csrc/jpeg_huff.cpp`) against PIL (libjpeg-turbo) on
files PIL writes here from a numpy seed: 4:4:4, 4:2:2, 4:2:0 and
greyscale; qualities 50 and 95, optimized Huffman tables, restart
intervals; sizes 1x1, 17x9, 33x65 and 64x48. The tolerance is exact: the
decoder follows libjpeg's integer arithmetic (ISLOW IDCT, fancy
upsampling, the YCbCr tables) and lands on PIL's bytes. Also: the
committed assets against their stored PIL decodes, a JPEG texture in a
scene against the JAX package's (which reads it through PIL), and the
progressive and CMYK files that slice 7c added (its other variants:
tests/test_torch_image_files.py)."""
import hashlib
import io
import os

import numpy as np
import pytest
from PIL import Image

from tests.torch_scenes import ASSETS
from vision_tpu.scene import texture as jtex
from vision_tpu_torch.scene import imageio as tio
from vision_tpu_torch.scene import texture as ttex

SIZES = [(1, 1), (9, 17), (65, 33), (48, 64)]   # (height, width)


def _image(h, w, grey, seed):
    """Smooth waves under noise (so every coefficient band is used)."""
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    ch = 1 if grey else 3
    base = np.stack([128 + 100 * np.sin(x * 0.31 + c) * np.cos(y * 0.23 - c)
                     for c in range(ch)], -1)
    img = np.clip(base + g.integers(-40, 41, base.shape), 0, 255)
    img = img.astype(np.uint8)
    return img[..., 0] if grey else img


def _jpeg(img, mode=None, **opts):
    b = io.BytesIO()
    im = Image.fromarray(img)
    (im.convert(mode) if mode else im).save(b, "JPEG", **opts)
    return b.getvalue()


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("sampling", ["444", "422", "420", "grey"])
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("variant", ["plain", "optimize", "restart"])
def test_decode_matches_pil(size, sampling, quality, variant):
    """Exact (0 levels) against PIL's decode."""
    h, w = size
    opts = dict(quality=quality)
    if sampling != "grey":
        opts["subsampling"] = {"444": 0, "422": 1, "420": 2}[sampling]
    if variant == "optimize":
        opts["optimize"] = True
    elif variant == "restart":
        opts["restart_marker_blocks"] = 1
    data = _jpeg(_image(h, w, sampling == "grey", h * w + quality), **opts)
    if variant == "restart":
        assert b"\xff\xdd" in data  # a DRI segment
    got = tio.read_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, _pil(data))


def test_committed_assets_match_their_pil_decodes():
    """Every JPEG of tests/assets_torch/ (`tools/gen_torch_assets.py`)
    decodes to its stored PIL decode (the 2048^2 file: its corner and the
    sha256 of the whole)."""
    dec = np.load(os.path.join(ASSETS, "jpeg_decodes.npz"))
    names = sorted(k for k in dec.files if "." not in k)
    assert names == ["grain_2048", "grey", "strip", "tiles"]
    for k in names:
        got, kind = tio.read_image(os.path.join(ASSETS, k + ".jpg"))
        assert kind == "ldr"
        np.testing.assert_array_equal(got[:dec[k].shape[0], :dec[k].shape[1]],
                                      dec[k])
        if k + ".sha256" in dec:
            assert tuple(got.shape) == tuple(dec[k + ".shape"])
            assert hashlib.sha256(got.tobytes()).digest() == \
                dec[k + ".sha256"].tobytes()


@pytest.mark.parametrize("color_space", ["srgb", "linear"])
def test_load_image_matches_jax(color_space):
    """`load_image` of a JPEG: the JAX package's PIL decode, linearised
    the same way, bit for bit."""
    p = os.path.join(ASSETS, "tiles.jpg")
    np.testing.assert_array_equal(ttex.load_image(p, color_space),
                                  jtex.load_image(p, color_space))


@pytest.mark.parametrize("kind", ["progressive", "cmyk"])
def test_refused_files_name_7c(tmp_path, kind):
    """Progressive and CMYK (Adobe) files raised NotImplementedError naming
    ROADMAP queue A, 7c, until slice 7c ported them: they now decode bit
    for bit as PIL decodes them, through `read_image` and `load_image`
    (every variant: tests/test_torch_image_files.py)."""
    img = _image(16, 16, False, 3)
    if kind == "progressive":
        data = _jpeg(img, progressive=True)
    else:
        data = _jpeg(img, "CMYK")
    p = tmp_path / "x.jpg"
    p.write_bytes(data)
    np.testing.assert_array_equal(tio.read_image(str(p))[0], _pil(data))
    np.testing.assert_array_equal(ttex.load_image(str(p)),
                                  jtex.load_image(str(p)))


@pytest.mark.parametrize("cut", ["scan", "header"])
def test_truncated_file_raises_value_error(cut):
    """A file cut inside its scan or its headers raises ValueError."""
    data = _jpeg(_image(32, 32, False, 5), quality=90)
    sos = data.index(b"\xff\xda")
    with pytest.raises(ValueError):
        tio.read_jpeg(data[:sos + 40] if cut == "scan" else data[:sos - 30])
