"""Slice 7e.3a: what OpenCV's own readers decode under a .hdr / .exr name,
held against the JAX package's loader itself (`vision_tpu.scene.texture.
load_image`, which calls the pip `cv2` 5.0 for such a name) on files
written here from seeds and crafted: PNM (P1-P6), PAM (P7), PFM, Sun
raster, OpenCV's BMP reader (its rules, not PIL's) and CMYK / YCCK JPEG
through OpenCV's conversion. The port (`vision_tpu_torch/scene/cvread.py`)
must give the same float32 array bit for bit, or raise ValueError where
the reference raises (OpenCV returns no image or throws). AVIF, which the
pip `cv2` and PIL decode and the port does not yet, raises
NotImplementedError naming ROADMAP 7e under either kind of name."""
import io
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.torch_scenes import ASSETS, gen_assets as ga
from vision_tpu.scene import texture as jtex
from vision_tpu_torch.scene import imageio as tio
from vision_tpu_torch.scene import texture as ttex


def _both(tmp_path, data, name="x.hdr"):
    """(the JAX package's load_image or None where it raises, the port's
    or None where it raises ValueError) of `data` named `name`."""
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    try:
        want = jtex.load_image(p)
    except Exception:           # IOError (no image) or cv2.error
        want = None
    try:
        got = ttex.load_image(p)
    except ValueError:
        got = None
    return want, got


def _assert_same(tmp_path, data, decodes=True, name="x.hdr"):
    want, got = _both(tmp_path, data, name)
    if not decodes:
        assert want is None, "the reference decodes it"
        assert got is None, "the port decodes it"
        return
    assert want is not None, "the reference refuses it"
    assert got is not None, "the port refuses it"
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _mutants(g, data, n):
    """n seeded mutants of `data`: a byte set, the file cut, a byte put in
    or taken out; the first 3 bytes kept, so OpenCV picks the same
    reader."""
    out = []
    for _ in range(n):
        d = bytearray(data)
        for _ in range(int(g.integers(1, 3))):
            i = int(g.integers(3, len(d)))
            k = int(g.integers(0, 4))
            if k == 0:
                d[i] = int(g.integers(0, 256))
            elif k == 1:
                del d[i:]
            elif k == 2:
                d.insert(i, int(g.choice(list(b" \n#0129xP\t-"))))
            else:
                del d[i]
            if len(d) <= 4:
                break
        out.append(bytes(d))
    return out


# ---------------------------------------------------------------------------
# PNM
# ---------------------------------------------------------------------------

def _pnm(g, kind, w, h, maxval, sep=b"\n", comment=False, over=False):
    """A P1-P6 file of seeded samples (`over`: some past maxval)."""
    nch = 3 if kind in (3, 6) else 1
    head = b"P%d" % kind + sep + (b"# a comment\n" if comment else b"") + \
        b"%d %d" % (w, h) + sep
    if kind not in (1, 4):
        head += b"%d" % maxval + sep
    if kind == 4:
        return head + g.integers(0, 256, -(-w // 8) * h,
                                 dtype=np.uint8).tobytes()
    if kind == 1:
        return head + b" ".join(b"%d" % v for v in g.integers(0, 2, w * h)) \
            + b"\n"
    top = min(maxval + (40 if over else 1), 65536 if maxval > 255 else 256)
    v = g.integers(0, top, w * h * nch)
    if kind in (2, 3):
        return head + b" ".join(b"%d" % x for x in v) + b"\n"
    return head + (v.astype(">u2").tobytes() if maxval > 255
                   else v.astype(np.uint8).tobytes())


PNM_CASES = [(k, m) for k in (1, 4) for m in (1,)] + \
    [(k, m) for k in (2, 3, 5, 6) for m in (7, 255, 256, 1000, 65535)]


@pytest.mark.parametrize("sep", [b"\n", b" ", b"\r\n"], ids=["lf", "sp",
                                                             "crlf"])
@pytest.mark.parametrize("kind, maxval", PNM_CASES,
                         ids=[f"P{k}-m{m}" for k, m in PNM_CASES])
def test_pnm_matches_jax(tmp_path, kind, maxval, sep):
    """P1-P6, ASCII and binary, maxval 1-65535: 8-bit binary samples as
    they are (past maxval too), ASCII ones scaled by 255 / maxval and
    clipped, 16-bit ones whole, PBM's 1 black."""
    g = np.random.default_rng(kind * 1000 + maxval)
    data = _pnm(g, kind, int(g.integers(1, 14)), int(g.integers(1, 9)),
                maxval, sep, comment=sep == b" ", over=True)
    _assert_same(tmp_path, data)


@pytest.mark.parametrize("data, decodes", [
    (b"P2\n# c\r3 1\n#x\n9\n1 2 99\n", True),        # comments, clipping
    (b"P2 3 1 9 1 2 3", False),                       # EOF after a number
    (b"P2\n3 1\n9\n1 2 -3\n", False),                 # a stray byte
    (b"P1\n4 1\n0101\n", True),                        # one digit a pixel
    (b"P5\n2 1\n0\n\x01\x02", False),                 # maxval 0
    (b"P5\n2 1\n65536\n\x01\x02\x03\x04", False),     # maxval past 16 bits
    (b"P5\n2 1\n255\n\x01", False),                   # cut short
    (b"P6\n0 1\n255\n", False),                        # no width
    (b"P5\n2 1\n100\n\xff\xfe", True),                 # past maxval, kept
    (b"P3\n1 1 255 300 0 1 ", True),                  # clipped at maxval
])
def test_pnm_crafted_match_jax(tmp_path, data, decodes):
    """Crafted PNM files: each decoded as OpenCV decodes it, or refused
    where it refuses."""
    _assert_same(tmp_path, data, decodes)


# ---------------------------------------------------------------------------
# PFM
# ---------------------------------------------------------------------------

def _pfm(img, scale):
    h, w = img.shape[:2]
    head = (b"PF" if img.ndim == 3 else b"Pf") + b"\n%d %d\n%s\n" % (
        w, h, scale)
    order = "<" if scale.startswith(b"-") else ">"
    return head + np.ascontiguousarray(img[::-1]).astype(order
                                                        + "f4").tobytes()


@pytest.mark.parametrize("scale", [b"-1.0", b"1.0", b"-3.0", b"0.25",
                                   b"-1e0", b"-inf"])
@pytest.mark.parametrize("nch", [1, 3])
def test_pfm_matches_jax(tmp_path, nch, scale):
    """PFM: the scale's sign the byte order, rows bottom-up, samples times
    float(1 / |scale|); a signalling NaN, infinities and denormals among
    them."""
    g = np.random.default_rng(nch)
    img = (g.standard_normal((5, 7, nch)) * 100).astype(np.float32)
    img.view(np.uint32)[0, 0, 0] = 0x7FA00001          # a signalling NaN
    img[1, 1, 0], img[2, 2, 0] = np.inf, 1e-42
    _assert_same(tmp_path, _pfm(img if nch == 3 else img[..., 0], scale))


@pytest.mark.parametrize("head, decodes", [
    (b"PF\n4 3 -1.0\n", True), (b"PF\n4\t3\r-1x\n", True),
    (b"PF\n+4 3.7\n-1\n", True), (b"PF\n4 3\n0x1p0\n", True),
    (b"PF\n4  3\n-1.0\n", False), (b"PF\r\n4 3\n-1.0\n", False),
    (b"PF\n4 3\n-0.0\n", False), (b"PF\n4 3\nnan\n", False),
    (b"PF\n4 3\n\n-1\n", False), (b"PF\n-4 3\n-1\n", False)])
def test_pfm_headers_match_jax(tmp_path, head, decodes):
    """PFM headers as grfmt_pfm.cpp reads them: each field the text up to
    a whitespace byte through atoi / strtod; a second space is an empty
    field; a zero or NaN scale and a size of 0 refuse."""
    img = np.arange(36, dtype=np.float32).reshape(3, 4, 3)
    _assert_same(tmp_path, head + img[::-1].astype("<f4").tobytes(), decodes)


# ---------------------------------------------------------------------------
# PAM
# ---------------------------------------------------------------------------

def _pam(g, w, h, depth, maxval, tupl=None, sep=b"\n"):
    n = w * h * depth
    body = g.integers(0, 256, n, dtype=np.uint8).tobytes() if maxval < 256 \
        else g.integers(0, 65536, n).astype(">u2").tobytes()
    head = sep.join([b"P7", b"WIDTH %d" % w, b"HEIGHT %d" % h,
                     b"DEPTH %d" % depth, b"MAXVAL %d" % maxval]) + sep
    if tupl is not None:
        head += b"TUPLTYPE " + tupl + sep
    return head + b"ENDHDR\n" + body


PAM_CASES = [(1, m, t) for m in (1, 9, 255) for t in (None, b"GRAYSCALE")] + \
    [(1, m, b"GRAYSCALE") for m in (256, 65535)] + \
    [(1, 1, b"BLACKANDWHITE")] + \
    [(3, m, t) for m in (1, 100, 255) for t in (None, b"RGB")] + \
    [(3, m, b"RGB") for m in (300, 65535)]


@pytest.mark.parametrize("sep", [b"\n", b"\r"], ids=["lf", "cr"])
@pytest.mark.parametrize("depth, maxval, tupl", PAM_CASES,
                         ids=[f"d{d}-m{m}-{t}" for d, m, t in PAM_CASES])
def test_pam_matches_jax(tmp_path, depth, maxval, tupl, sep):
    """PAM of DEPTH 1 and 3 under each TUPLTYPE and MAXVAL: samples as
    they are (RGB left in OpenCV's B, G, R slots: C23), 16-bit ones
    big-endian, MAXVAL 1 read as bits."""
    g = np.random.default_rng(depth * 100000 + maxval)
    _assert_same(tmp_path, _pam(g, int(g.integers(1, 12)),
                                int(g.integers(1, 6)), depth, maxval, tupl,
                                sep))


@pytest.mark.parametrize("head, decodes", [
    (b"P7\r\nWIDTH 4\r\nHEIGHT 2\r\nDEPTH 1\r\nMAXVAL 255\r\nENDHDR\r\n",
     True),                       # the LF after ENDHDR's CR is a sample
    (b"P7\n# c\nMAXVAL 255\nDEPTH 1\nHEIGHT  2\nWIDTH\t004 \nENDHDR\n", True),
    (b"P7\nWIDTH 4\nWIDTH 4\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n", False),
    (b"P7\nwidth 4\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n", False),
    (b"P7\nWIDTH +4\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n", False),
    (b"P7\nWIDTH 4\nHEIGHT 2\nDEPTH 1\nENDHDR\n", False),
    (b"P7\nWIDTH 4\nHEIGHT 2\nDEPTH 1\nMAXVAL 300\nENDHDR\n", False),
    (b"P7\nWIDTH 4\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nTUPLTYPE GRAYSCALE\n"
     b"ENDHDR\n", False),
    (b"P7\nWIDTH 4\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nTUPLTYPE FOO\nENDHDR\n",
     False),
    (b"P7 WIDTH 4\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n", False),
    (b"P7\nWIDTH 4\nHEIGHT 2\nDEPTH 5\nMAXVAL 255\nENDHDR\n", False)])
def test_pam_headers_match_jax(tmp_path, head, decodes):
    """PAM headers as grfmt_pam.cpp reads them: fields in any order, each
    once, comments, digits only (leading zeros kept), a TUPLTYPE naming
    DEPTH's channels."""
    _assert_same(tmp_path, head + bytes(range(7, 7 + 24)), decodes)


@pytest.mark.parametrize("depth, tupl", [(2, b"GRAYSCALE_ALPHA"),
                                         (4, b"RGB_ALPHA")])
def test_pam_with_alpha_is_refused(tmp_path, depth, tupl):
    """C23: OpenCV 5.0 converts a DEPTH 2 or 4 PAM into 3 channels reading
    past its row buffer (the reference decodes garbage); the port raises
    ValueError."""
    g = np.random.default_rng(depth)
    want, got = _both(tmp_path, _pam(g, 6, 3, depth, 255, tupl))
    assert want is not None and got is None


# ---------------------------------------------------------------------------
# Sun raster
# ---------------------------------------------------------------------------

def _sun(w, h, bpp, body, typ=1, maptype=0, cmap=b""):
    return struct.pack(">8I", 0x59A66A95, w, h, bpp, len(body), typ, maptype,
                       len(cmap)) + cmap + body


def _assert_like_jax(tmp_path, data):
    """The port decodes `data` as the reference does, or refuses it where
    the reference raises."""
    want, got = _both(tmp_path, data)
    assert (want is None) == (got is None), data[:48]
    if want is not None:
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


SUN_CASES = [(b, m) for b in (1, 8) for m in ("none", "grey", "colour",
                                                "short")] + \
    [(24, "none"), (32, "none")]


@pytest.mark.parametrize("typ", [0, 1])
@pytest.mark.parametrize("bpp, cmap", SUN_CASES,
                         ids=[f"{b}-{m}" for b, m in SUN_CASES])
def test_sunras_matches_jax(tmp_path, bpp, cmap, typ):
    """Sun rasters of 1, 8, 24 and 32 bits, old and standard types, with no
    map (1 and 8 bits read as 0: OpenCV's grey table stays empty), a grey
    one, a colour one and one shorter than 2^depth entries; rows padded
    to 16 bits; 32 bits X, B, G, R."""
    g = np.random.default_rng(bpp * 10 + typ)
    w, h = int(g.integers(1, 15)), int(g.integers(1, 6))
    pitch = ((w * bpp + 7) // 8 + 1) & -2
    body = g.integers(0, 256, pitch * h, dtype=np.uint8).tobytes()
    n = {"none": 0, "short": max(1, (1 << bpp) // 2 - 1)}.get(cmap,
                                                             1 << bpp)
    m = g.integers(0, 256, (3, n), dtype=np.uint8)
    if cmap == "grey":
        m[1] = m[2] = m[0]
    maptype = 1 if n else 0
    _assert_same(tmp_path, _sun(w, h, bpp, body, typ, maptype, m.tobytes()
                                if n else b""))


@pytest.mark.parametrize("bpp, typ, maptype, maplen, cut", [
    (8, 2, 0, 0, 0), (8, 3, 0, 0, 0), (24, 3, 0, 0, 0), (24, 1, 1, 6, 0),
    (8, 1, 1, 771, 0), (8, 1, 0, 6, 0), (8, 1, 2, 6, 0), (16, 1, 0, 0, 0),
    (8, 1, 0, 0, 1)])
def test_sunras_refusals_match_jax(tmp_path, bpp, typ, maptype, maplen, cut):
    """What OpenCV 5.0 refuses: the run-length type 2 and the RGB type 3,
    a map on 24 bits, more than 2^depth entries, a map type other than
    the length says, 16 bits, a file cut short."""
    pitch = ((5 * bpp + 7) // 8 + 1) & -2
    data = _sun(5, 2, bpp, bytes(range(pitch * 2)), typ, maptype,
                bytes(i % 256 for i in range(maplen)))
    _assert_same(tmp_path, data[:len(data) - cut], decodes=False)


# ---------------------------------------------------------------------------
# BMP (OpenCV's reader)
# ---------------------------------------------------------------------------

def _bmp_case(g, bpp, comp, header, top, grey, clrused):
    """A BMP of seeded pixels (or a seeded RLE stream with runs, absolute
    stretches, deltas and early ends of line) -> bytes."""
    w, h = int(g.integers(1, 14)), int(g.integers(1, 7))
    pal, n = None, 0
    if bpp <= 8:
        n = clrused or 1 << bpp
        p = g.integers(0, 256, (n, 4), dtype=np.uint8)
        p[:, 3] = 0
        if grey:
            p[:, 1] = p[:, 2] = p[:, 0]
        pal = p
    masks = {(16, 3): (0xF800, 0x7E0, 0x1F), (32, 3): (0xFF0000, 0xFF00, 0xFF)
             }.get((bpp, comp))
    if comp in (1, 2):
        s = bytearray()
        for _ in range(h):
            x = 0
            while x < w:
                r = g.random()
                if r < 0.5:
                    k = int(g.integers(1, w - x + 1))
                    s += bytes([k, int(g.integers(0, 256))])
                elif r < 0.8 and w - x >= 3:
                    k = int(g.integers(3, w - x + 1))
                    nb = (k + 1) // 2 if comp == 2 else k
                    s += bytes([0, k]) + g.integers(0, 256, nb,
                                                    dtype=np.uint8).tobytes()
                    s += bytes(((nb + 1) & ~1) - nb)
                elif r < 0.9:
                    dx = int(g.integers(0, w - x + 1))
                    s += bytes([0, 2, dx, 0])
                    x += dx
                    continue
                else:
                    break
                x += k
            s += b"\0\0"
        return ga.bmp_bytes(w, h, bpp, None, pal, comp, header=header,
                            top_down=top, data=bytes(s + b"\0\1"))
    pitch = -(-(w * bpp) // 8)
    rows = [g.integers(0, 256, pitch, dtype=np.uint8).tobytes()
            for _ in range(h)]
    return ga.bmp_bytes(w, h, bpp, rows, pal, comp, masks, header, top)


BMP_CASES = [(1, 0), (4, 0), (8, 0), (16, 0), (16, 3), (24, 0), (32, 0),
             (32, 3), (4, 2), (8, 1)]


@pytest.mark.parametrize("variant", ["bottom_up", "top_down", "grey",
                                     "v5_header", "few_colours"])
@pytest.mark.parametrize("bpp, comp", BMP_CASES,
                         ids=[f"{b}-c{c}" for b, c in BMP_CASES])
def test_bmp_matches_jax(tmp_path, bpp, comp, variant):
    """OpenCV's BMP reader: 1-32 bits, 555 and 565, bitfields, RLE4 and
    RLE8 (runs, absolute stretches, deltas, early ends of line filled with
    entry 0), top-down files, grey palettes (grey output by OpenCV's luma),
    palettes shorter than 2^bits."""
    g = np.random.default_rng(bpp * 100 + comp * 10 + len(variant))
    clrused = max(2, (1 << bpp) // 3) if variant == "few_colours" and \
        bpp <= 8 else 0
    data = _bmp_case(g, bpp, comp, 124 if variant == "v5_header" else 40,
                     variant == "top_down", variant == "grey", clrused)
    if variant == "v5_header" and comp == 3:
        # OpenCV reads bitfields after the header, where a V5 header has
        # none: the pixel data's first bytes
        _assert_like_jax(tmp_path, data)
    else:
        _assert_same(tmp_path, data)


def test_bmp_core_header_reads_grey(tmp_path):
    """A BITMAPCOREHEADER file (12 bytes), palette or 24 bits: OpenCV reads
    it as grey whatever its colours."""
    g = np.random.default_rng(12)
    pal = g.integers(0, 256, (256, 3), dtype=np.uint8).tobytes()
    rows = g.integers(0, 256, (3, 8), dtype=np.uint8)
    for bpp, body, p in ((8, rows, pal), (24, np.repeat(rows, 3, 1), b"")):
        head = struct.pack("<IHHHH", 12, 8, 3, 1, bpp)
        off = 14 + 12 + len(p)
        data = b"BM" + struct.pack("<IHHI", off + body.size, 0, 0, off) + \
            head + p + body.tobytes()
        want, got = _both(tmp_path, data)
        assert want is not None and np.array_equal(want[..., 0], want[..., 2])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["masks", "compression", "rle_past_row",
                                  "cut", "rle_cut", "clrused"])
def test_bmp_refusals_match_jax(tmp_path, case):
    """What OpenCV's BMP reader refuses: bitfields other than 555 / 565 on
    16 bits, an unknown compression, an RLE run past its row, pixel data
    or an RLE stream cut short, more than 256 palette entries."""
    rows = [bytes(range(6))] * 2
    pal = np.zeros((256, 4), np.uint8)
    data = {
        "masks": lambda: ga.bmp_bytes(3, 2, 16, rows, None, 3,
                                      (0xF00, 0xF0, 0xF)),
        "compression": lambda: ga.bmp_bytes(6, 2, 8, rows, pal, 4),
        "rle_past_row": lambda: ga.bmp_bytes(4, 2, 8, None, pal, 1,
                                             data=b"\x05\x01\0\0\0\1"),
        "cut": lambda: ga.bmp_bytes(6, 2, 24, [bytes(18)] * 2)[:-5],
        "rle_cut": lambda: ga.bmp_bytes(4, 2, 8, None, pal, 1,
                                        data=b"\x04\x01\0\0"),
    }
    if case == "clrused":
        d = bytearray(ga.bmp_bytes(6, 2, 8, rows, pal))
        d[46:50] = struct.pack("<I", 300)
        data = bytes(d)
    else:
        data = data[case]()
    _assert_same(tmp_path, data, decodes=False)


# ---------------------------------------------------------------------------
# CMYK and YCCK JPEG
# ---------------------------------------------------------------------------

def _cmyk_jpeg(img4, **opts):
    b = io.BytesIO()
    Image.fromarray(img4, "CMYK").save(b, "JPEG", **opts)
    return b.getvalue()


@pytest.mark.parametrize("kind", ["cmyk.jpg", "ycck.jpg", "pil_444",
                                  "pil_420", "pil_ycck", "progressive"])
def test_cmyk_jpeg_matches_jax(tmp_path, kind):
    """A 4-component JPEG named .hdr: libjpeg-turbo's CMYK samples (a YCCK
    file converted to CMYK) through OpenCV's own CMYK -> BGR, one level
    off PIL's in places, without /255."""
    if kind.endswith(".jpg"):
        with open(os.path.join(ASSETS, kind), "rb") as f:
            data = f.read()
    else:
        g = np.random.default_rng(len(kind))
        img4 = g.integers(0, 256, (19, 27, 4), dtype=np.uint8)
        img4[4:12, 5:20] = g.integers(0, 256, 4, dtype=np.uint8)
        data = _cmyk_jpeg(img4, quality=85, progressive=kind == "progressive",
                          subsampling=2 if kind == "pil_420" else 0)
        if kind == "pil_ycck":
            data = ga._adobe_transform(data, 2)
    _assert_same(tmp_path, data)


# ---------------------------------------------------------------------------
# mutations, AVIF
# ---------------------------------------------------------------------------

def _seed_file(fmt, g):
    if fmt == "pnm":
        return _pnm(g, int(g.integers(1, 7)), 7, 4, 255)
    if fmt == "pfm":
        return _pfm(g.standard_normal((4, 5, 3)).astype(np.float32), b"-1.0")
    if fmt == "pam":
        return _pam(g, 5, 3, 3, 255, b"RGB")
    if fmt == "sunras":
        return _sun(6, 3, 8, g.integers(0, 256, 18, dtype=np.uint8).tobytes(),
                    1, 1, g.integers(0, 256, 48, dtype=np.uint8).tobytes())
    return _bmp_case(g, 8, 1, 40, False, False, 0)


@pytest.mark.parametrize("fmt", ["pnm", "pfm", "pam", "sunras", "bmp"])
def test_mutated_files_match_jax(tmp_path, fmt):
    """A seeded share of the mutation sweep: bytes set, put in, taken out
    and files cut across each format's header and data; the port decodes
    each as the reference does, or refuses it where the reference
    raises."""
    g = np.random.default_rng(sum(map(ord, fmt)))
    for data in _mutants(g, _seed_file(fmt, g), 40):
        if fmt == "pam" and (b"DEPTH 2" in data or b"DEPTH 4" in data):
            continue                                  # C23
        _assert_like_jax(tmp_path, data)


@pytest.mark.parametrize("name", ["x.hdr", "x.exr", "x.png", "x.avif"])
def test_avif_names_7e(tmp_path, name):
    """An AVIF file (written here by OpenCV): the reference decodes it
    under a .hdr / .exr name (the pip cv2's AVIF reader) and under any
    other (PIL's); the port raises NotImplementedError naming AVIF and
    ROADMAP 7e, never ValueError (which would make a scene's slot quietly
    take its default)."""
    p = str(tmp_path / "a.avif")
    img = np.random.default_rng(5).integers(0, 256, (16, 16, 3), np.uint8)
    assert cv2.imwrite(p, img)
    with open(p, "rb") as f:
        data = f.read()
    q = tmp_path / name
    q.write_bytes(data)
    assert jtex.load_image(str(q)).shape == (16, 16, 3)
    with pytest.raises(NotImplementedError, match="AVIF.*7e"):
        tio.read_image(str(q))


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

CV = np.load(os.path.join(ASSETS, "cv_decodes.npz"))


@pytest.mark.parametrize("fn", sorted(CV.files))
def test_committed_files_match_their_decodes(fn):
    """The committed 7e.3a files (`tools/gen_torch_assets.py`): the port's
    decode is their committed one, and the JAX package's loader still
    gives it."""
    p = os.path.join(ASSETS, fn)
    got, kind = tio.read_image(p)
    assert kind == "hdr"
    np.testing.assert_array_equal(got.view(np.uint32), CV[fn].view(np.uint32))
    np.testing.assert_array_equal(jtex.load_image(p), CV[fn])
