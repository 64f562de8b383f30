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
resynchronises (ROADMAP C26); and C26's tail: the segments that follow a
file's last scan, cut by its end or wrong, which libjpeg reads in
jpeg_finish_decompress."""
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


def _tail_sources():
    """name -> a JPEG of PIL's without its EOI: whole single-scan baseline
    (RGB and grey) and progressive."""
    g = np.random.default_rng(0)
    big = g.integers(0, 256, (20, 28, 3), np.uint8)
    out = {"baseline": _save(Image.fromarray(big), "JPEG", quality=90),
           "grey": _save(Image.fromarray(big[..., 0]), "JPEG", quality=90),
           "progressive": _save(Image.fromarray(big), "JPEG", quality=90,
                                progressive=True)}
    return {k: v[:-2] for k, v in out.items()}


TAIL_SOURCES = _tail_sources()
# what follows the last scan, and whether PIL keeps its image: after a
# whole single scan libjpeg reads these in jpeg_finish_decompress, where
# running out of data suspends (PIL keeps the image) and an error in the
# bytes read so far refuses the file; a progressive file keeps nothing
TAILS = [
    ("dqt_cut", b"\xff\xdb\x00\x43\x00" + bytes(10), True),
    ("dqt_length_only", b"\xff\xdb\x00\x43", True),
    ("dqt_half_length", b"\xff\xdb\x00", True),
    ("dqt_bad_id_cut", b"\xff\xdb\x00\x43\x04", False),
    ("dqt_16bit_cut", b"\xff\xdb\x00\x43\x10", True),
    ("dqt_short_then_eoi", b"\xff\xdb\x00\x03\x00\xff\xd9", True),
    ("dqt_length_1", b"\xff\xdb\x00\x01", False),
    ("dht_cut", b"\xff\xc4\x00\x1f\x00" + bytes(5), True),
    ("dht_bad_id_cut", b"\xff\xc4\x00\x1f\x04", True),
    ("dht_bad_id_read", b"\xff\xc4\x00\x2f\x05" + bytes(15) + b"\x02\x01\x02",
     False),
    ("dht_counts_past_length", b"\xff\xc4\x00\x1f\x00" + bytes([1] * 16),
     False),
    ("dht_length_16", b"\xff\xc4\x00\x10\x00\x00\x00", False),
    ("dri_cut", b"\xff\xdd\x00\x04\x00", True),
    ("dri_bad_length", b"\xff\xdd\x00\x05", False),
    ("dac_cut", b"\xff\xcc\x00\x06\x09", True),
    ("dac_bad_value", b"\xff\xcc\x00\x06\x00\x01", False),
    ("dac_odd_then_eoi", b"\xff\xcc\x00\x05\x00\x10\x01\xff\xd9", False),
    ("sof_marker_only", b"\xff\xc0", False),
    ("sof_cut", b"\xff\xc2\x00\x11\x08", False),
    ("jpg_cut", b"\xff\xc8\x00", False),
    ("sos_cut", b"\xff\xda\x00\x0c\x03\x01", True),
    ("sos_bad_length", b"\xff\xda\x00\x0b\x03", False),
    ("sos_id_cut", b"\xff\xda\x00\x0c\x03\x07", True),
    ("sos_length_1", b"\xff\xda\x00\x01", True),
    ("rst", b"\xff\xd0", True),
    ("rst_then_zero", b"\xff\xd0\x00", True),
    ("com_cut", b"\xff\xfe\x00\x10ab", True),
]


@pytest.mark.parametrize("source", sorted(TAIL_SOURCES))
@pytest.mark.parametrize("case", [t[0] for t in TAILS])
def test_segments_after_the_last_scan_match_pil(tmp_path, source, case):
    """C26's tail: a JPEG whose last scan is followed by a DQT, DHT, DRI,
    DAC, frame or scan header cut by the file's end (or short, or
    wrong), an RST, or a cut COM, in place of its EOI. After a whole
    single scan PIL keeps its image where libjpeg runs out of data first
    and refuses it where libjpeg meets an error in what it read (the
    outcome recorded here); a progressive file is refused. The port
    gives PIL's outcome and image."""
    tail, kept = next((t, k) for n, t, k in TAILS if n == case)
    p = str(tmp_path / "t.jpg")
    with open(p, "wb") as f:
        f.write(TAIL_SOURCES[source] + tail)
    want = _pil(p)
    assert (want is not None) == (kept and source != "progressive")
    if want is None:
        with pytest.raises(ValueError):
            tio.read_image(p)
    else:
        np.testing.assert_array_equal(tio.read_image(p)[0], want)


def _random_tail(g):
    """Up to two segments of parsed or skipped markers, of right or wrong
    lengths and ids, most cut short, some followed by an EOI."""
    tail = b""
    for _ in range(int(g.integers(1, 3))):
        m = int(g.choice([0xDB, 0xC4, 0xDD, 0xCC, 0xDA, 0xC0, 0xC8, 0xDC,
                          0xFE, 0xE1, 0xD0, 0xD9]))
        if m == 0xDB:
            body = bytes([int(g.choice([0, 1, 0x10, 3, 4, 0x13]))]) + bytes(
                g.integers(1, 256, 128 if g.random() < .3 else 64, np.uint8))
        elif m == 0xC4:
            counts = np.zeros(16, np.uint8)
            counts[int(g.integers(16))] = int(g.integers(0, 20))
            body = bytes([int(g.choice([0, 1, 0x10, 0x13, 4, 0x20]))]) + \
                bytes(counts) + bytes(g.integers(0, 256, int(counts.sum()),
                                                 np.uint8))
        elif m == 0xCC:
            body = b"".join(bytes([int(g.choice([0, 1, 16, 31, 32])),
                                   int(g.integers(256))])
                            for _ in range(int(g.integers(1, 4))))
        elif m == 0xDA:
            ns = int(g.integers(1, 4))
            body = bytes([ns]) + b"".join(bytes([int(g.integers(1, 5)), 0])
                                          for _ in range(ns)) + b"\0\x3f\0"
        else:
            body = bytes(g.integers(0, 256, int(g.integers(0, 20)), np.uint8))
        n = len(body) + 2 + (int(g.integers(-3, 4)) if g.random() < .25
                             else 0)
        tail += bytes([0xFF, m]) + (b"" if m in (0xD0, 0xD9) else
                                    struct.pack(">H", max(n, 0)) + body)
    if g.random() < .7:
        tail = tail[:int(g.integers(1, len(tail) + 1))]
    return tail + (b"\xff\xd9" if g.random() < .2 else b"")


@pytest.mark.parametrize("source", sorted(TAIL_SOURCES))
def test_random_tails_match_pil(tmp_path, source):
    """Sixty seeded tails after the last scan (`_random_tail`): the port
    decodes each file as PIL does, or refuses it where PIL raises."""
    g = np.random.default_rng(sum(map(ord, source)) + 26)
    p = str(tmp_path / "t.jpg")
    for k in range(60):
        with open(p, "wb") as f:
            f.write(TAIL_SOURCES[source] + _random_tail(g))
        want = _pil(p)
        if want is None:
            with pytest.raises(ValueError):
                tio.read_image(p)
        else:
            np.testing.assert_array_equal(tio.read_image(p)[0], want,
                                          err_msg=f"tail {k}")
