"""ROADMAP C26: single-byte edits of the headers of the common formats on
PIL's route (JPEG baseline and progressive, PNG, BMP, TGA uncompressed
and run-length, GIF, TIFF uncompressed, LZW, Deflate and PackBits),
drawn from a seed: the port (`vision_tpu_torch/scene/imageio.py`,
`tiffdir.py`, `pilread.py`) decodes each edited file as
`PIL.Image.open(p).convert("RGB")` decodes it, by path, bit for bit, or
refuses it (ValueError) where PIL raises; never NotImplementedError.
PIL's libjpeg-turbo runs a SIMD integer IDCT in 16-bit lanes, which
wraps for dequantised coefficients past 8-bit JPEG's range (|c| > 1023,
as an edited quantisation table or Huffman symbol makes them); the port
computes that IDCT as the SIMD code does (ROADMAP C19), so no edit is
left whose pixels differ inside the blocks that hold such a coefficient
(the count of such edits, once 2 a JPEG, is 0). Also the bitmap plugins' handing on (CUR, ICO and DIB pass
a file on to the next plugin where PIL's `_bitmap` raises struct.error or
finds no pixels): a TGA whose first bytes read as a cursor directory
decodes as PIL's TGA. And edits of restart markers inside the scans of
Huffman-coded, arithmetic-coded and lossless files, which libjpeg
resynchronises (ROADMAP C26)."""
import io
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

from vision_tpu_torch.scene import imageio as tio

warnings.filterwarnings("ignore", category=UserWarning, module="PIL")
warnings.filterwarnings("ignore", category=Image.DecompressionBombWarning)


def _pil(path):
    """PIL's decode, or None where PIL raises."""
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except Exception:     # the JAX package's loader catches every error
        return None


def _save(img, fmt, **kw):
    b = io.BytesIO()
    img.save(b, fmt, **kw)
    return b.getvalue()


def _edits(g, data, n, hi):
    """n seeded single-byte edits of data[:hi]: a byte set to 0, 1 or 255,
    or one of its bits flipped (tests/test_torch_pilread.py's rule)."""
    hi = min(hi, len(data))
    out = []
    for _ in range(n):
        d = bytearray(data)
        i = int(g.integers(0, hi))
        d[i] = (0, 1, 255, d[i] ^ 1 << int(g.integers(8)))[int(g.integers(4))]
        out.append(bytes(d))
    return out


def _files():
    """format -> (file, the header bytes edited, edits, suffix)."""
    g = np.random.default_rng(0)
    a = g.integers(0, 256, (6, 9, 3), np.uint8)
    a[:, :4] = a[:, :1]                     # runs for the run-length coders
    rgb = Image.fromarray(a)
    big = g.integers(0, 256, (20, 28, 3), np.uint8)
    big[:, :14] = big[:, :1]
    jpg = Image.fromarray(big)
    return {
        "jpeg": (_save(jpg, "JPEG", quality=90), 640, 48, ".jpg"),
        "jpeg_progressive": (_save(jpg, "JPEG", quality=90,
                                   progressive=True), 640, 48, ".jpg"),
        "png": (_save(rgb, "PNG"), 60, 24, ".png"),
        "bmp": (_save(rgb, "BMP"), 54, 24, ".bmp"),
        "tga": (_save(rgb, "TGA"), 18, 24, ".tga"),
        "tga_rle": (_save(rgb, "TGA", compression="tga_rle"), 18, 24, ".tga"),
        "gif": (_save(rgb.convert("P"), "GIF"), 240, 32, ".gif"),
        "tiff": (_save(rgb, "TIFF"), 400, 48, ".tif"),
        "tiff_lzw": (_save(rgb, "TIFF", compression="tiff_lzw"), 400, 48,
                     ".tif"),
        "tiff_deflate": (_save(rgb, "TIFF", compression="tiff_adobe_deflate"),
                         400, 48, ".tif"),
        "tiff_packbits": (_save(rgb, "TIFF", compression="packbits"), 400, 48,
                          ".tif")}


FILES = _files()
# the edits of each JPEG whose decode shows C19 (PIL's wrapping SIMD IDCT,
# which the port now computes as PIL does)
C19_EDITS = {"jpeg": 0, "jpeg_progressive": 0}


def _wide_blocks(data, shape):
    """The pixels an IDCT block past 8-bit JPEG's coefficient range can
    reach: its 8 x 8 samples scaled by the component's upsampling, one
    pixel more each way for the triangle filter (C19)."""
    comps = tio.jpeg_coefficients(data)
    hmax = max(hv[0] for hv, _ in comps)
    vmax = max(hv[1] for hv, _ in comps)
    foot = np.zeros(shape, bool)
    for (h, v), c in comps:
        sy, sx = vmax // v, hmax // h
        for by, bx in zip(*np.nonzero(np.abs(c).max(-1) > 1023)):
            y0, x0 = by * 8 * sy, bx * 8 * sx
            foot[max(0, y0 - 1):y0 + 8 * sy + 1,
                 max(0, x0 - 1):x0 + 8 * sx + 1] = True
    return foot


@pytest.mark.parametrize("fmt", sorted(FILES))
def test_header_edits_match_pil(tmp_path, fmt):
    """Each seeded edit: the port's decode equals PIL's, or both refuse
    it (the port with ValueError); a JPEG whose decodes differ differs
    only inside blocks of coefficients past 8-bit range (C19), and the
    number of such edits is the one counted."""
    data, head, n, suffix = FILES[fmt]
    g = np.random.default_rng(sum(map(ord, fmt)))
    p = str(tmp_path / ("f" + suffix))
    c19 = 0
    for k, d in enumerate(_edits(g, data, n, head)):
        with open(p, "wb") as f:
            f.write(d)
        want = _pil(p)
        if want is None:
            with pytest.raises(ValueError):
                tio.read_image(p)
            continue
        got, kind = tio.read_image(p)
        assert kind == "ldr" and got.shape == want.shape, k
        if fmt.startswith("jpeg") and not np.array_equal(got, want):
            c19 += 1
            diff = (got != want).any(-1)
            foot = _wide_blocks(d, diff.shape)
            assert foot.any() and not (diff & ~foot).any(), k
            continue
        np.testing.assert_array_equal(got, want, err_msg=f"edit {k}")
    assert c19 == C19_EDITS.get(fmt, 0)


def _restart_files():
    """name -> a JPEG with a restart marker after every MCU row (or every
    MCU), Huffman-coded baseline and progressive (PIL), arithmetic-coded
    and lossless (tools/gen_torch_assets.py's encoders)."""
    from tests.torch_scenes import gen_assets as ga
    g = np.random.default_rng(0)
    big = g.integers(0, 256, (20, 28, 3), np.uint8)
    img = Image.fromarray(big)
    sampling = ((2, 2), (1, 1), (1, 1))
    return {
        "baseline": _save(img, "JPEG", quality=90, restart_marker_blocks=1),
        "progressive": _save(img, "JPEG", quality=90, progressive=True,
                             restart_marker_blocks=1),
        "arithmetic": ga.arith_jpeg_bytes(
            ga._coefficients(sampling, (3, 4), 8, 2), sampling, q=8,
            restart=1),
        "lossless": ga.lossless_jpeg_bytes(big[:10, :12], 1, 0, 1)}


RESTART_FILES = _restart_files()
# marker codes an edit puts in place of an RSTn: the other RSTn, markers
# below SOF0, others that are not RSTn, a stuffed zero and a fill byte
RESTART_CODES = [0xD0 + k for k in range(8)] + [0x01, 0xBF, 0xC4, 0xD9,
                                                0xDA, 0xFE, 0x00, 0xFF]


@pytest.mark.parametrize("name", sorted(RESTART_FILES))
def test_restart_marker_edits_match_pil(tmp_path, name):
    """Seeded edits of the code of an RSTn marker inside the scans: the
    port resynchronises as libjpeg's read_restart_marker and
    jpeg_resync_to_restart do (the expected RSTn swallowed, an earlier one
    or a marker below SOF0 passed over, one of the next two or another
    marker left in place for the intervals to decode from no data, a far
    one taken as expected) and decodes each file as PIL does, or refuses
    it where PIL raises; a progressive file ended inside a scan (an RSTn
    made EOI) too, through libjpeg's block smoothing."""
    data = RESTART_FILES[name]
    sos = data.index(b"\xff\xda")
    rst = [i for i in range(sos, len(data) - 1)
           if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    assert len(rst) >= 3
    g = np.random.default_rng(sum(map(ord, name)))
    p = str(tmp_path / "r.jpg")
    for k in range(48):
        d = bytearray(data)
        d[rst[int(g.integers(len(rst)))] + 1] = \
            RESTART_CODES[int(g.integers(len(RESTART_CODES)))]
        with open(p, "wb") as f:
            f.write(d)
        want = _pil(p)
        if want is None:
            with pytest.raises(ValueError):
                tio.read_image(p)
            continue
        got, _ = tio.read_image(p)
        np.testing.assert_array_equal(got, want, err_msg=f"edit {k}")


def test_unfinished_progressive_files_name_7e5(tmp_path):
    """A progressive file cut after each of its scans but the last (an EOI
    put in place of the next SOS), which named 7e.5 until it was done:
    libjpeg estimates the coefficients left unfinished from the
    neighbouring blocks (block smoothing), and so does the port; each cut
    and the whole file decode as PIL's."""
    data = _save(Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (20, 28, 3), np.uint8)), "JPEG", quality=90, progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    assert len(sos) == 10
    p = tmp_path / "p.jpg"
    for cut in sos[1:]:
        p.write_bytes(data[:cut] + b"\xff\xd9")
        np.testing.assert_array_equal(tio.read_image(str(p))[0],
                                      _pil(str(p)), err_msg=f"cut {cut}")
    p.write_bytes(data)
    np.testing.assert_array_equal(tio.read_image(str(p))[0], _pil(str(p)))


@pytest.mark.parametrize("count", [1, 2, 5, 255, 0x101])
def test_tga_read_as_a_cursor_passes_on(tmp_path, count):
    """An uncompressed true-colour TGA starts \\0\\0\\2\\0, CUR's magic; a
    non-zero byte 4 makes a directory whose entry points past the file,
    so PIL's `_bitmap` meets a short read (struct.error) and hands the
    file to the TGA plugin: the port decodes it as PIL's TGA."""
    a = np.random.default_rng(count).integers(0, 256, (6, 9, 3), np.uint8)
    d = bytearray(_save(Image.fromarray(a), "TGA"))
    assert d[:4] == b"\0\0\2\0"
    d[4:6] = struct.pack("<H", count)
    p = tmp_path / "t.tga"
    p.write_bytes(bytes(d))
    want = _pil(str(p))
    assert want is not None
    np.testing.assert_array_equal(tio.read_image(str(p))[0], want)


def _cursor(entry_at, hsize, w, h, bits=24, tail=b""):
    """A cursor of one entry whose bitmap header (of `hsize` bytes, of w x
    h pixels) starts at `entry_at` (0: right after the directory)."""
    head = struct.pack("<HHH", 0, 2, 1) + struct.pack("<BBBBHHII", w, h, 0,
                                                      0, 0, 0, 0, entry_at)
    info = struct.pack("<IiiHHIIiiII", hsize, w, h, 1, bits, 0, 0, 0, 0, 0,
                       0)[:hsize]
    return head + info + tail


@pytest.mark.parametrize("case", ["header_past_end", "no_pixels",
                                  "masks_past_end", "half_height_zero",
                                  "header_cut", "whole"])
def test_bitmap_plugins_hand_files_on_as_pil(tmp_path, case):
    """CUR, ICO and DIB read their bitmap through PIL's `_bitmap`: a short
    read of the header's size or of its bitfield masks (struct.error) and
    an image of no pixels pass the file on, a header cut inside
    (`_safe_read`'s OSError) is refused. Each crafted file against PIL,
    under its CUR, ICO and DIB magic."""
    px = bytes(range(256)) * 2
    cur = {"header_past_end": _cursor(4096, 40, 4, 4),
           "no_pixels": _cursor(0, 40, 0, 4, tail=px),
           "masks_past_end": _cursor(0, 40, 4, 4, bits=32)[:-24] +
           struct.pack("<I", 3) + bytes(20),
           "half_height_zero": _cursor(0, 40, 4, 1, tail=px),
           "header_cut": _cursor(0, 40, 4, 4)[:40],
           "whole": _cursor(0, 40, 4, 8, tail=px)}[case]
    for magic in (b"\0\0\2\0", b"\0\0\1\0"):
        p = tmp_path / "c.img"
        p.write_bytes(magic + cur[4:])
        want = _pil(str(p))
        if want is None:
            with pytest.raises(ValueError):
                tio.read_image(str(p))
        else:
            np.testing.assert_array_equal(tio.read_image(str(p))[0], want)
    dib = cur[6 + 16:]
    p = tmp_path / "d.img"
    p.write_bytes(dib)
    want = _pil(str(p))
    if want is None:
        with pytest.raises(ValueError):
            tio.read_image(str(p))
    else:
        np.testing.assert_array_equal(tio.read_image(str(p))[0], want)
