"""Slice 7d: OpenEXR files decoded by the port
(`vision_tpu_torch/scene/imageio.py` `read_exr`) as Imf::InputFile, the
class OpenCV's EXR decoder (and so the JAX package's `load_image`) reads
through, decodes them. The files and their InputFile decodes
(`tests/assets_torch/exr_decodes.npz`) come from `tools/gen_torch_exr.py`,
which writes them with libOpenEXR 3.1: every compression (RLE, PIZ, PXR24,
B44, B44A, DWAA, DWAB) on HALF and FLOAT channels, tiled files (one level,
mip- and ripmaps, partial edge tiles, every line order), multi-part files,
and the deep files InputFile refuses; the luminance-chroma, UINT and deep
composite files of slice 7e.2 against OpenCV 4.6.0's decodes
(`exr_cv_decodes.npz`; `tests/test_torch_exr_opencv.py` holds the rest).
The tolerance is exact everywhere, DWA included (the port's inverse DCT
sums its products in the order libOpenEXR's AVX code does)."""
import hashlib
import os
import struct

import numpy as np
import pytest

from tests.torch_scenes import ASSETS
from vision_tpu_torch import native
from vision_tpu_torch.scene import imageio as tio

DEC = np.load(os.path.join(ASSETS, "exr_decodes.npz"))
FILES = sorted(k for k in DEC.files if ":" not in k)


def _read(fn):
    with open(os.path.join(ASSETS, fn), "rb") as f:
        return f.read()


@pytest.mark.parametrize("fn", FILES)
def test_exr_matches_inputfile(fn):
    """Every committed file decodes bit for bit (NaN payloads included) to
    libOpenEXR's InputFile decode, through `read_image` as through
    `read_exr`."""
    want = DEC[fn]
    got = tio.read_exr(_read(fn))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    img, kind = tio.read_image(os.path.join(ASSETS, fn))
    assert kind == "hdr"
    np.testing.assert_array_equal(img.view(np.uint32), want.view(np.uint32))


def test_exr_files_cover_every_codec_and_layout():
    """The files hold every compression and tiled level mode, multi-part
    files whose part 0 is scanline and tiled, and DWA's three schemes."""
    comps, modes, parts = set(), set(), 0
    for fn in FILES:
        data = _read(fn)
        attrs, _, multipart = tio._exr_part0(data)
        comps.add(attrs["compression"][1][0])
        if "tiles" in attrs:
            modes.add(attrs["tiles"][1][8] & 15)
        parts += multipart
    assert comps >= {tio._EXR_RLE, tio._EXR_PIZ, tio._EXR_PXR24, tio._EXR_B44,
                     tio._EXR_B44A, tio._EXR_DWAA, tio._EXR_DWAB, tio._EXR_ZIP}
    assert modes == {0, 1, 2} and parts == 2


def test_exr_timing_file():
    """`piz_2048.exr` (2048 x 1024 HALF, PIZ): its decode's sha256 and
    corner are InputFile's."""
    got = tio.read_exr(_read("piz_2048.exr"))
    assert got.shape == (1024, 2048, 3)
    np.testing.assert_array_equal(got[:128, :128], DEC["piz_2048.exr:corner"])
    assert hashlib.sha256(got.tobytes()).digest() == \
        DEC["piz_2048.exr:sha256"].tobytes()


@pytest.mark.parametrize("fn", ["deep_scanline.exr", "deep_tiled.exr"])
def test_deep_files_are_refused(fn):
    """InputFile throws on deep tiles and on deep scanlines without Z and
    A: the port raises ValueError, so the slot takes its default as in the
    JAX package."""
    with pytest.raises(ValueError, match="deep"):
        tio.read_exr(_read(fn))


CV = np.load(os.path.join(ASSETS, "exr_cv_decodes.npz"))


@pytest.mark.parametrize("fn, what", [
    ("yc.exr", "luminance-chroma"), ("uint.exr", "pixel type 0"),
    ("deep_composite.exr", "compositing deep")])
def test_files_for_7e_name_it(fn, what):
    """Luminance-chroma files, UINT channels and deep scanlines InputFile
    composites, which OpenCV converts with its own code (slice 7e.2): each
    decodes bit for bit to OpenCV 4.6.0's decode (ROADMAP C22)."""
    got = tio.read_exr(_read(fn))
    assert got.shape == CV[fn].shape, what
    np.testing.assert_array_equal(got.view(np.uint32), CV[fn].view(np.uint32))


def test_other_channel_sets_name_7e():
    """A file of R and G only (B renamed Q, which OpenCV ignores) decodes
    with B 0, as OpenCV 4.6.0 fills a missing channel (slice 7e.2)."""
    data = _read("rle_half.exr")
    assert data.count(b"B\0\x01\0\0\0") == 1
    bad = data.replace(b"B\0\x01\0\0\0", b"Q\0\x01\0\0\0")
    want = DEC["rle_half.exr"].copy()
    want[..., 2] = 0
    np.testing.assert_array_equal(tio.read_exr(bad).view(np.uint32),
                                  want.view(np.uint32))


def _multipart(single):
    """A single-part scanline file -> a two-part file by hand: its part
    as part 0 ("type", "name" and "chunkCount" added) and a copy of it as
    part 1; chunks carry their part number."""
    attrs, pos = tio._exr_header(single)
    comp = attrs["compression"][1][0]
    _, y0, _, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    n = -(-(y1 - y0 + 1) // tio._EXR_LINES[comp])
    offsets = struct.unpack(f"<{n}Q", single[pos:pos + 8 * n])
    chunks = [single[o:o + 8 + struct.unpack("<i", single[o + 4:o + 8])[0]]
              for o in offsets]
    head_end = pos - 1                  # the header's terminating null

    def header(name):
        return (single[8:head_end]
                + tio._attr("chunkCount", "int", struct.pack("<i", n))
                + tio._attr("name", "string", name.encode())
                + tio._attr("type", "string", b"scanlineimage") + b"\0")
    head = (struct.pack("<ii", tio.EXR_MAGIC, 2 | 0x1000) + header("a")
            + header("b") + b"\0")
    at = len(head) + 16 * n
    tables, body = [], b""
    for part in range(2):
        offs = []
        for c in chunks:
            offs.append(at + len(body))
            body += struct.pack("<i", part) + c
        tables.append(struct.pack(f"<{n}Q", *offs))
    return head + b"".join(tables) + body


@pytest.mark.parametrize("fn", ["piz_half.exr", "pxr24_float.exr"])
def test_hand_built_multipart_reads_part_0(fn):
    """A multi-part file built here decodes to its part 0, as InputFile
    opens a multi-part file."""
    single = _read(fn)
    got = tio.read_exr(_multipart(single))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  DEC[fn].view(np.uint32))


def test_huffman_and_rle_refuse_corrupt_data():
    """The host codecs (`csrc/image_codecs.cpp`) raise ValueError on
    corrupt data, as libOpenEXR throws: a Huffman table whose range is out
    of bounds, and a run-length stream longer than its block."""
    with pytest.raises(ValueError):
        native.exr_huf_decode(struct.pack("<5I", 70000, 3, 0, 8, 0) + b"\0" * 8,
                              4)
    with pytest.raises(ValueError):
        native.exr_rle_decode(bytes([5, 7]), 3)
    np.testing.assert_array_equal(native.exr_rle_decode(bytes([2, 7, 0xFE, 1,
                                                               2]), 5),
                                  [7, 7, 7, 1, 2])


@pytest.mark.parametrize("fn", ["piz_half.exr", "b44_half.exr",
                                "dwaa_half.exr"])
def test_truncated_files_are_refused(fn):
    """A file cut inside its last chunk raises ValueError, as InputFile
    throws on it."""
    data = _read(fn)
    with pytest.raises(ValueError):
        tio.read_exr(data[:len(data) - 40])
