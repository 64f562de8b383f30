"""Slice 7e.1: WebP files (`vision_tpu_torch/scene/webp.py`, the container;
`csrc/webp_codec.cpp`, the VP8L, ALPH and VP8 bitstreams) against what
the JAX package's libraries give: PIL's `Image.open(p).convert("RGB")`
under any name but .hdr / .exr, `cv2.imread` under those; both libwebp.

Every decode is held bit for bit against the library's decode of the same
file, read by path; what the library refuses, the port refuses
(ValueError). Images are random (numpy, seeded) at odd sizes, written by
PIL, or built by `tools/gen_torch_webp.py` where PIL's encoder cannot
write them (raw and filtered ALPH chunks, VP8 frames written again with the
simple loop filter, sharpness, several token partitions, a skip
probability, loop-filter deltas and delta-coded segments; VP8L streams of
every predictor mode and transform).
"""
import hashlib
import io
import itertools
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.torch_scenes import ASSETS, gen_webp as gw
from vision_tpu.scene import texture as jtex
from vision_tpu_torch import native
from vision_tpu_torch.scene import imageio as tio
from vision_tpu_torch.scene import texture as ttex
from vision_tpu_torch.scene import webp

SIZES = [(1, 1), (1, 37), (17, 33), (45, 61), (300, 7)]


def _pil(path):
    """PIL's (RGB, alpha or None) of a file, or None where it refuses."""
    try:
        im = Image.open(path)
        rgb = np.asarray(im.convert("RGB"))
        return rgb, (np.asarray(im)[..., 3] if im.mode == "RGBA" else None)
    except Exception:
        return None


def _opencv(path):
    try:
        img = cv2.imread(str(path), cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    except cv2.error:
        return None
    return None if img is None else img[..., :3][..., ::-1]


def _check(tmp_path, data, name="x.webp"):
    """The port's decode of `data` against PIL's (RGB and alpha); both
    refuse or both give the same. Returns whether PIL decodes it."""
    p = tmp_path / name
    p.write_bytes(data)
    want = _pil(p)
    if want is None:
        with pytest.raises(ValueError):
            tio.read_image(str(p))
        return False
    got, kind = tio.read_image(str(p))
    assert kind == "ldr"
    np.testing.assert_array_equal(got, want[0])
    _, alpha = webp.decode(data)
    assert (alpha is None) == (want[1] is None)
    if alpha is not None:
        np.testing.assert_array_equal(alpha, want[1])
    return True


def _check_opencv(tmp_path, data, name="x.hdr"):
    """The port's decode of `data` under a .hdr name against OpenCV's."""
    p = tmp_path / name
    p.write_bytes(data)
    want = _opencv(p)
    if want is None:
        with pytest.raises(ValueError):
            tio.read_image(str(p))
        return False
    got, kind = tio.read_image(str(p))
    assert kind == "hdr" and got.dtype == np.float32
    np.testing.assert_array_equal(got, want.astype(np.float32))
    return True


def _image(kind, h, w, seed):
    g = np.random.default_rng(seed)
    if kind == "noise":
        return g.integers(0, 256, (h, w, 3), np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7 + k) * np.cos(y / 5 - k)
                    for k in range(3)], -1)
    return np.clip(img + g.integers(-4, 5, img.shape), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# PIL-written files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["smooth", "noise"])
@pytest.mark.parametrize("size", SIZES)
def test_lossless_random(tmp_path, size, kind):
    """VP8L at every method (0-6) and quality 0 / 50 / 100: the predictor,
    cross-colour and subtract-green transforms, colour caches, entropy
    images and LZ77 copies the encoder picks."""
    img = _image(kind, *size, seed=sum(size))
    for method, quality in itertools.product(range(7), (0, 50, 100)):
        assert _check(tmp_path, gw.pil_webp(img, lossless=True, method=method,
                                            quality=quality))


@pytest.mark.parametrize("size", [(17, 33), (300, 7)])
@pytest.mark.parametrize("colours", [2, 3, 16, 17, 256])
def test_lossless_palette(tmp_path, colours, size):
    """Images of 2, 3, 16, 17 and 256 colours: the colour-indexing
    transform with 8, 4, 2 and 1 pixels a byte."""
    g = np.random.default_rng(colours)
    pal = g.integers(0, 256, (colours, 3), np.uint8)
    img = pal[g.integers(0, colours, size)]
    for method in (0, 4, 6):
        assert _check(tmp_path, gw.pil_webp(img, lossless=True, method=method))


@pytest.mark.parametrize("kind", ["smooth", "noise"])
@pytest.mark.parametrize("size", SIZES)
def test_lossy_random(tmp_path, size, kind):
    """VP8 at every method (0-6) and quality 0 / 30 / 80 / 100: segments,
    the normal loop filter at many levels, every intra mode."""
    img = _image(kind, *size, seed=sum(size) + 1)
    for method, quality in itertools.product(range(7), (0, 30, 80, 100)):
        assert _check(tmp_path, gw.pil_webp(img, method=method,
                                            quality=quality))


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("alpha_quality", [0, 50, 100])
@pytest.mark.parametrize("size", SIZES)
def test_alpha(tmp_path, size, alpha_quality, exact):
    """RGBA: lossy with an ALPH chunk (VP8L-coded, levels quantised below
    alpha_quality 100, filtered) and lossless, exact or not (the encoder
    flattens RGB under alpha 0 unless exact): RGB and alpha as PIL's."""
    g = np.random.default_rng(alpha_quality + 7 * exact + sum(size))
    a = g.integers(0, 256, size + (1,)) * (g.random(size + (1,)) < 0.6)
    rgba = np.concatenate([_image("smooth", *size, 3), a.astype(np.uint8)], -1)
    assert _check(tmp_path, gw.pil_webp(rgba, quality=70, exact=exact,
                                        alpha_quality=alpha_quality))
    assert _check(tmp_path, gw.pil_webp(rgba, lossless=True, exact=exact,
                                        quality=alpha_quality))


@pytest.mark.parametrize("opts", [dict(lossless=True), dict(quality=60)])
def test_animated_frame0(tmp_path, opts):
    """Frame 0 of an animation on its canvas: PIL's own animated files
    (frame 0 whole) and ones whose frame 0 is a sub-rectangle at an offset
    (black around it), each as PIL gives it."""
    a, b = gw.smooth(40, 46), gw.smooth(40, 46, 1.3)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "WEBP", save_all=True, duration=50,
                            append_images=[Image.fromarray(b)], **opts)
    assert _check(tmp_path, buf.getvalue())
    for offset in [(12, 10), (0, 22), (18, 0)]:
        data = gw.anim_file(a[3:21, 5:33], b, offset, **opts)
        assert _check(tmp_path, data)
        rgb, _ = webp.decode(data)
        x, y = offset
        assert not rgb[:y].any() and not rgb[:, :x].any()


# ---------------------------------------------------------------------------
# Written by hand: what PIL's encoder does not write
# ---------------------------------------------------------------------------

def _alph_file(payload, h=40, w=46):
    frame = gw.pil_payload(gw.smooth(h, w), quality=75)
    return gw.riff([gw.vp8x(16, w, h), gw.chunk(b"ALPH", payload),
                    gw.chunk(b"VP8 ", frame)])


@pytest.mark.parametrize("coding", ["raw", "vp8l", "vp8l_palette"])
@pytest.mark.parametrize("filt", [0, 1, 2, 3])
def test_alph_by_hand(tmp_path, filt, coding):
    """ALPH chunks raw, VP8L-coded (the 32-bit path) and VP8L-coded through
    the colour-indexing transform alone (the 8-bit path), under each filter
    (none, horizontal, vertical, gradient): the alpha as PIL's."""
    g = np.random.default_rng(filt)
    if coding == "raw":
        payload = gw.alph_raw(g.integers(0, 256, (40, 46)), filt)
    elif coding == "vp8l":
        payload = gw.alph_vp8l(g.integers(0, 256, (40, 46)), filt)
    else:
        payload = gw.alph_vp8l(g.integers(0, 11, (40, 46)), filt,
                               palette=g.integers(0, 256, 11))
    assert _check(tmp_path, _alph_file(payload))


VP8_REWRITES = {
    "simple": dict(simple=1),
    "simple_sharp": dict(simple=1, sharpness=5),
    "sharp": dict(sharpness=2),
    "sharp7": dict(sharpness=7),
    "parts2": dict(log2_parts=1),
    "parts8": dict(log2_parts=3),
    "lf_delta": dict(lf_delta=(-9, 12)),
    "skip": dict(skip_p=60),
    "delta_segments": dict(delta_segments=True),
}


@pytest.mark.parametrize("variant", sorted(VP8_REWRITES))
def test_vp8_rewritten(tmp_path, variant):
    """PIL-written VP8 frames written again with what PIL's encoder never
    writes: the simple loop filter, sharpness 1-7, 2 and 8 token
    partitions, loop-filter deltas, a skip probability, delta-coded
    segments. The rewrite's tokens are PIL's, so the image differs from
    the original only through the filter."""
    flat = np.repeat(np.repeat(np.random.default_rng(8).integers(
        0, 256, (5, 6, 3)), 16, 0), 16, 1)
    for img, q in ((gw.smooth(70, 90), 50), ((flat + gw.smooth(80, 96) // 16)
                                             .astype(np.uint8), 30)):
        parsed = gw.parse_vp8(gw.pil_payload(img, quality=q))
        data = gw.riff([gw.chunk(b"VP8 ", gw.write_vp8(
            parsed, **VP8_REWRITES[variant]))])
        assert _check(tmp_path, data)


def test_vp8_rewrite_is_identity(tmp_path):
    """Written again unchanged, a PIL-written frame decodes (by PIL) to the
    same pixels: the rewriter keeps every decision."""
    img = gw.smooth(33, 47)
    payload = gw.pil_payload(img, quality=60)
    a = gw.riff([gw.chunk(b"VP8 ", payload)])
    b = gw.riff([gw.chunk(b"VP8 ", gw.write_vp8(gw.parse_vp8(payload)))])
    (tmp_path / "a.webp").write_bytes(a)
    (tmp_path / "b.webp").write_bytes(b)
    np.testing.assert_array_equal(_pil(tmp_path / "a.webp")[0],
                                  _pil(tmp_path / "b.webp")[0])


@pytest.mark.parametrize("case", ["predictors2", "predictors4", "predictors9",
                                  "transforms", "green_cross", "palette256"])
def test_vp8l_by_hand(tmp_path, case):
    """VP8L streams over random content: every predictor mode (0-15, 14 and
    15 libwebp's padding) with tiles of 4, 16 and 512 pixels; colour
    indexing (bundled and not), subtract-green and cross-colour."""
    g = np.random.default_rng(len(case))
    if case.startswith("predictors"):
        data = gw.vp8l_predictors(seed=len(case), bits=int(case[10:]))
    elif case == "transforms":
        data = gw.vp8l_transforms()
    elif case == "green_cross":
        h, w = 21, 50
        data = gw.vp8l_bitstream(w, h, g.integers(0, 1 << 32, (h, w)), [
            ("cross", 2, g.integers(0, 1 << 32, (6, 13))), ("green",)])
    else:
        h, w = 9, 31
        data = gw.vp8l_bitstream(w, h, (g.integers(0, 256, (h, w)) << 8), [
            ("palette", g.integers(0, 1 << 32, 200))])
    assert _check(tmp_path, gw.riff([gw.chunk(b"VP8L", data)]))


def test_paths_covered(tmp_path):
    """The committed files and a few generated ones reach every VP8 intra
    mode (4 luma, 10 sub-block, 4 chroma), no, the simple and the normal
    loop filter, sharpness,
    several partitions, segments, loop-filter deltas and skips; every ALPH
    filter and coding, the 8-bit ALPH path; every VP8L transform, all 16
    predictor modes, every bundling, simple and normal prefix codes, colour
    caches, entropy images and backward references."""
    native.webp_coverage(reset=True)
    for fn in sorted(os.listdir(ASSETS)):
        if fn.endswith(".webp") and "2048" not in fn:
            tio.read_image(os.path.join(ASSETS, fn))
    for filt in range(4):
        webp.decode(_alph_file(gw.alph_raw(np.zeros((40, 46)), filt)))
    webp.decode(gw.pil_webp(_image("smooth", 40, 46, 0), quality=100))
    webp.decode(gw.pil_webp(gw.smooth(64, 64), lossless=True))
    c = native.webp_coverage()
    names = ["i16"] * 4 + ["i4"] * 10 + ["uv"] * 4 + ["filter"] * 3 + [
        "sharpness", "parts1", "parts2", "parts4", "parts8", "segments",
        "lf_delta", "skip"] + ["alph_filter"] * 4 + ["alph_coding"] * 2 + [
        "alph_8bit"] + ["transform"] * 4 + [
        "simple_code", "normal_code", "cache", "entropy_image", "backref",
        "cache_hit"] + ["predictor"] * 16 + ["bundle"] * 4
    assert len(names) == len(c) == 66
    missing = [f"{n}[{i}]" for i, n in enumerate(names) if c[i] == 0
               and n not in ("parts2", "parts8")]
    assert not missing, missing


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def _bases():
    sm = gw.smooth(23, 29)
    a = ((np.arange(29)[None] * 9 + np.arange(23)[:, None] * 5) % 256)
    rgba = np.concatenate([sm, a[..., None].astype(np.uint8)], -1)
    return {
        "vp8l": gw.pil_webp(sm, lossless=True),
        "vp8": gw.pil_webp(sm, quality=70),
        "vp8_alpha": gw.pil_webp(rgba, quality=70),
        "vp8l_alpha": gw.pil_webp(rgba, lossless=True),
        "anim": gw.anim_file(sm[:10, :12], sm, (6, 4), lossless=True),
        "parts4": gw.riff([gw.chunk(b"VP8 ", gw.write_vp8(gw.parse_vp8(
            gw.pil_payload(gw.smooth(40, 50), quality=60)), log2_parts=2))]),
    }


@pytest.mark.parametrize("base", ["vp8l", "vp8", "vp8_alpha", "vp8l_alpha",
                                  "anim", "parts4"])
def test_truncations(tmp_path, base):
    """The file cut at every length from 12 bytes (the RIFF and WEBP tags
    that name the format), its RIFF size kept or made to fit:
    where PIL (libwebp's demuxer and decoder) refuses, so does the port;
    where it decodes, the same image (a cut VP8L stream may still decode
    when the bits lost are its padding)."""
    d = _bases()[base]
    step = 1 if len(d) < 600 else 3
    for n in range(12, len(d), step):   # shorter: no RIFF / WEBP to name it
        _check(tmp_path, d[:n])
        if n >= 8:
            _check(tmp_path, d[:4] + struct.pack("<I", n - 8) + d[8:n])


@pytest.mark.parametrize("base", ["vp8l", "vp8", "vp8_alpha", "anim"])
def test_corrupt_bytes(tmp_path, base):
    """Single bytes set to 0, 1, 255 or flipped in the headers, and random
    bytes in the data: the port refuses and decodes as PIL does (corrupt
    prefix codes, sizes, flags, partition sizes, ANMF fields)."""
    d = _bases()[base]
    g = np.random.default_rng(len(base))
    for pos in [4, 5, 6, 7] + list(range(12, min(len(d), 64))):
        for v in {0, 1, 255, d[pos] ^ 1, d[pos] ^ 0x80}:
            t = bytearray(d)
            t[pos] = v
            _check(tmp_path, bytes(t))
    for pos in g.integers(12, len(d), 60):
        t = bytearray(d)
        t[pos] = g.integers(0, 256)
        _check(tmp_path, bytes(t))


def _craft():
    """Crafted containers: (name, bytes) of what the demuxer and the
    decoder accept and refuse."""
    ch, rf, x = gw.chunk, gw.riff, gw.vp8x
    h, w = 23, 29
    sm = gw.smooth(h, w)
    lossy = gw.pil_payload(sm, quality=70)
    ll = gw.pil_payload(sm, b"VP8L", lossless=True)
    small = gw.pil_payload(sm[:10, :12], b"VP8L", lossless=True)
    raw = gw.alph_raw(((np.arange(w)[None] + np.arange(h)[:, None]) * 5) % 256,
                      0)
    bad = b"\x07\0\0"

    def anim(frames, flags=18, cw=w, chh=h, anim_chunk=True):
        cs = [x(flags, cw, chh)] + ([ch(b"ANIM", bytes(6))] if anim_chunk
                                    else [])
        return rf(cs + [gw.anmf(*f) for f in frames])

    body = b"WEBP" + b"VP8 " + struct.pack("<I", len(lossy) + 1) + lossy + b"\7"
    return {
        "plain": rf([ch(b"VP8 ", lossy)]),
        "vp8x_size_12": rf([ch(b"VP8X", x(0, w, h)[8:] + b"\0\0"),
                            ch(b"VP8 ", lossy)]),
        "alph_vp8l": rf([x(16, w, h), ch(b"ALPH", raw), ch(b"VP8L", ll)]),
        "no_alpha_flag_bad_alph": rf([x(0, w, h), ch(b"ALPH", bad),
                                      ch(b"VP8 ", lossy)]),
        "bad_alph": rf([x(16, w, h), ch(b"ALPH", bad), ch(b"VP8 ", lossy)]),
        "raw_alph": rf([x(16, w, h), ch(b"ALPH", raw), ch(b"VP8 ", lossy)]),
        "short_raw_alph": rf([x(16, w, h), ch(b"ALPH", raw[:-1]),
                              ch(b"VP8 ", lossy)]),
        "empty_alph": rf([x(16, w, h), ch(b"ALPH", b""), ch(b"VP8 ", lossy)]),
        "alpha_flag_no_alph": rf([x(16, w, h), ch(b"VP8 ", lossy)]),
        "two_alph": rf([x(16, w, h), ch(b"ALPH", bad), ch(b"ALPH", raw),
                        ch(b"VP8 ", lossy)]),
        "alph_exif_vp8": rf([x(16, w, h), ch(b"ALPH", raw), ch(b"EXIF", b"abc"),
                             ch(b"VP8 ", lossy)]),
        "exif_alph_vp8": rf([x(16, w, h), ch(b"EXIF", b"abc"), ch(b"ALPH", raw),
                             ch(b"VP8 ", lossy)]),
        "vp8_exif": rf([x(0, w, h), ch(b"VP8 ", lossy), ch(b"EXIF", b"abc")]),
        "iccp_no_flag": rf([x(0, w, h), ch(b"ICCP", b"abcd"),
                            ch(b"VP8 ", lossy)]),
        "flag_bit0": rf([x(1, w, h), ch(b"VP8 ", lossy)]),
        "flag_bit6": rf([x(0x40, w, h), ch(b"VP8 ", lossy)]),
        "anim_flag_still": rf([x(2, w, h), ch(b"VP8 ", lossy)]),
        "canvas_mismatch": rf([x(0, w + 1, h), ch(b"VP8 ", lossy)]),
        "vp8x_two_images": rf([x(0, w, h), ch(b"VP8 ", lossy),
                               ch(b"VP8 ", lossy)]),
        "two_images": rf([ch(b"VP8 ", lossy), ch(b"VP8 ", lossy)]),
        "vp8_junk_chunk": rf([ch(b"VP8 ", lossy), ch(b"JUNK", b"12345")]),
        "vp8l_then_alph": rf([ch(b"VP8L", ll), ch(b"ALPH", raw)]),
        "alph_first": rf([ch(b"ALPH", raw), ch(b"VP8 ", lossy)]),
        "odd_no_pad": b"RIFF" + struct.pack("<I", len(body)) + body,
        "odd_pad": b"RIFF" + struct.pack("<I", len(body) + 1) + body + b"\0",
        "riff_short_data": rf([ch(b"VP8 ", lossy)])[:-3],
        "riff_longer": rf([ch(b"VP8 ", lossy)]) + b"\0" * 5,
        "not_key_frame": rf([ch(b"VP8 ", bytes([lossy[0] | 1]) + lossy[1:])]),
        "hidden_frame": rf([ch(b"VP8 ", bytes([lossy[0] & ~16]) + lossy[1:])]),
        "partition_overrun": rf([ch(b"VP8 ", _overrun(lossy))]),
        "vp8l_version": rf([ch(b"VP8L", ll[:4] + bytes([ll[4] | 0x20])
                               + ll[5:])]),
        "anim_offset": anim([(6, 4, 12, 10, ch(b"VP8L", small))]),
        "anim_beyond_canvas": anim([(18, 14, 12, 10, ch(b"VP8L", small))]),
        "anmf_size_ignored": anim([(6, 4, 20, 10, ch(b"VP8L", small))]),
        "anim_no_anim_chunk": anim([(6, 4, 12, 10, ch(b"VP8L", small))],
                                   anim_chunk=False),
        "anim_no_flag": anim([(6, 4, 12, 10, ch(b"VP8L", small))], flags=16),
        "anim_no_frames": anim([]),
        "anim_two_frames": anim([(6, 4, 12, 10, ch(b"VP8L", small)),
                                 (0, 0, w, h, ch(b"VP8L", ll))]),
        "anim_alph_vp8": anim([(0, 0, w, h, ch(b"ALPH", raw) + ch(b"VP8 ", lossy))]),
        "anim_bad_alph": anim([(0, 0, w, h, ch(b"ALPH", bad) + ch(b"VP8 ", lossy))]),
        "anim_junk_in_frame": anim([(0, 0, w, h, ch(b"VP8 ", lossy)
                                     + ch(b"JUNK", b"ab"))]),
        "anim_empty_frame": anim([(0, 0, w, h, b"")]),
        "anim_no_alpha_flag": anim([(6, 4, 12, 10, ch(b"VP8L", small))],
                                   flags=2),
        "huge_canvas": anim([(6, 4, 12, 10, ch(b"VP8L", small))],
                            cw=1 << 23, chh=h),
        "incomplete_code": rf([ch(b"VP8L", _vp8l_incomplete(w, h))]),
    }


def _overrun(payload):
    """The frame written again in four token partitions, the first's size
    past the end of the data."""
    p4 = gw.write_vp8(gw.parse_vp8(payload), log2_parts=2)
    at = 10 + ((p4[0] | p4[1] << 8 | p4[2] << 16) >> 5)
    return p4[:at] + b"\xff\xff\x0f" + p4[at + 3:]


def _vp8l_incomplete(w, h):
    """A VP8L stream whose green code lacks one symbol (an incomplete
    tree, which libwebp refuses)."""
    bw = gw.LsbWriter()
    for v, n in ((0x2F, 8), (w - 1, 14), (h - 1, 14), (0, 1), (0, 3), (0, 1),
                 (0, 1), (0, 1)):
        bw.put(v, n)
    bw.put(0, 1)
    bw.put(len(gw._CL_ORDER) - 4, 4)
    for s in gw._CL_ORDER:
        bw.put(1 if s in (0, 8) else 0, 3)
    bw.put(0, 1)
    for s in range(280):
        bw.put(1 if s < 255 else 0, 1)
    return bw.bytes() + bytes(64)


CRAFTED = sorted(_craft())


@pytest.mark.parametrize("case", CRAFTED)
def test_crafted_containers(tmp_path, case):
    """Each crafted container as PIL reads it and, under a .hdr name, as
    OpenCV reads it (the two libwebp routes part: ROADMAP C21)."""
    data = _craft()[case]
    _check(tmp_path, data)
    _check_opencv(tmp_path, data)


# the crafted files on which PIL's route (WebPAnimDecoder: the demuxer's
# rules) and OpenCV's (WebPDecode of a still file: no demuxer, its ALPH
# decoded whatever VP8X's flags say) part
ROUTES_PART = {"alph_vp8l": (False, True), "no_alpha_flag_bad_alph": (True, False),
               "two_alph": (False, True), "alph_exif_vp8": (False, True),
               "flag_bit0": (False, True), "flag_bit6": (False, True),
               "vp8x_two_images": (False, True), "odd_no_pad": (False, True)}


@pytest.mark.parametrize("case", sorted(ROUTES_PART))
def test_routes_part(tmp_path, case):
    """ROADMAP C21: where libwebp's two routes disagree, the JAX package
    (PIL under a .webp name, OpenCV under .hdr) and the port disagree the
    same way: (PIL decodes, OpenCV decodes) as listed."""
    data = _craft()[case]
    assert (_check(tmp_path, data), _check_opencv(tmp_path, data)) == \
        ROUTES_PART[case]


# ---------------------------------------------------------------------------
# The committed files
# ---------------------------------------------------------------------------

DECODES = np.load(os.path.join(ASSETS, "webp_decodes.npz"))
FILES = sorted(k for k in DECODES.files if ":" not in k)


def test_committed_files():
    """Every committed WebP file against its PIL decode
    (`webp_decodes.npz`), the timing files by their decodes' sha256 and
    corner."""
    assert len(FILES) == 15 and "projector.webp" in FILES
    for fn in FILES:
        got, kind = tio.read_image(os.path.join(ASSETS, fn))
        assert kind == "ldr"
        np.testing.assert_array_equal(got, DECODES[fn], err_msg=fn)
    for fn in ("grain_2048.webp", "smooth_2048.webp"):
        got, _ = tio.read_image(os.path.join(ASSETS, fn))
        assert got.shape == (2048, 2048, 3)
        np.testing.assert_array_equal(got[:128, :128], DECODES[fn + ":corner"])
        assert hashlib.sha256(got.tobytes()).digest() == \
            DECODES[fn + ":sha256"].tobytes()


def test_scene_twins_hold_their_pixels():
    """The twins' lossless files hold the PNGs' pixels;
    checker_lossy_pil.png holds PIL's decode of checker_lossy.webp."""
    for a, b in (("checker.webp", "checker.png"), ("bumps.webp", "bumps.png"),
                 ("projector.webp", "projector.png"),
                 ("checker_lossy.webp", "checker_lossy_pil.png")):
        np.testing.assert_array_equal(tio.read_image(os.path.join(ASSETS, a))[0],
                                      tio.read_image(os.path.join(ASSETS, b))[0])


@pytest.mark.parametrize("fn", FILES)
def test_opencv_route(tmp_path, fn):
    """Each committed file under a .hdr name: `cv2.imread`'s samples as
    float32, no /255 (animated files: frame 0)."""
    data = open(os.path.join(ASSETS, fn), "rb").read()
    assert _check_opencv(tmp_path, data)


@pytest.mark.parametrize("fn", ["checker_lossy.webp", "projector.webp",
                                "anim.webp", "lossy_alpha.webp",
                                "vp8_parts.webp", "alph_vp8l_v.webp"])
@pytest.mark.parametrize("color_space", ["srgb", "linear"])
def test_load_image_matches_jax(tmp_path, fn, color_space):
    """`load_image` of WebP files, under their name and under a .hdr name:
    the JAX package's, bit for bit."""
    p = os.path.join(ASSETS, fn)
    np.testing.assert_array_equal(ttex.load_image(p, color_space),
                                  jtex.load_image(p, color_space))
    q = tmp_path / (fn + ".hdr")
    q.write_bytes(open(p, "rb").read())
    np.testing.assert_array_equal(ttex.load_image(str(q), color_space),
                                  jtex.load_image(str(q), color_space))


@pytest.mark.parametrize("name", ["cbox_tex", "env_sphere"])
def test_webp_twin_scenes(name):
    """`cbox_tex_webp` (a lossy checker, a lossless normal map) renders as
    `cbox_tex` reading PIL's decode of the lossy file; `env_sphere_webp`
    (lossless checker and projector with alpha) as `env_sphere`: the same
    atlas, the same render, bit for bit (64^2, 1 spp on the CPU)."""
    import torch
    import vision_tpu_torch as vt
    from tests import torch_scenes as ts
    ref, twin, kw = {"cbox_tex": (ts.cbox_tex_webp_ref, ts.cbox_tex_webp, {}),
                     "env_sphere": (ts.env_sphere, ts.env_sphere_webp,
                                    dict(sub_div=8))}[name]
    a = vt.load_scene(ref(64, **kw), device="cpu")
    b = vt.load_scene(twin(64, **kw), device="cpu")
    assert torch.equal(a.data.atlas.data, b.data.atlas.data)
    assert torch.equal(vt.render(a, spp=1), vt.render(b, spp=1))
