"""The files of slice 7e.3b: TIFF and GIF files under .hdr / .exr names,
which the JAX package reads through the pip cv2's own TIFF (libtiff 4.7.1)
and GIF readers, and `cvtiff_decodes.npz`, what its loader gets for each
(`cv2.imread(p, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`, float32 [H, W, 3]
RGB, no /255):

  * `cv_*.exr` / `cv_*.hdr`: both of OpenCV's TIFF routes (16-, 32- and
    64-bit samples read whole; 8-bit and smaller through libtiff's RGBA
    reader or by scanlines: palette, bilevel, CMYK, unassociated alpha,
    planar, tiles, orientation) and its GIF reader (a frame smaller than
    the screen, transparency, a local table, interlacing, no table);
  * the twins: `sky_a_f32.exr` (sky_a's floats as an LZW TIFF with the
    floating-point predictor) and `sky_a_f32_ref.exr` (the pip cv2's
    decode of it, a FLOAT OpenEXR file: `tests/torch_scenes.py`
    `cbox_sky_cvtiff` / `cbox_sky_cvtiff_ref`); `projector_gif.hdr` (the
    projector image as a GIF) and `projector_gif_pfm.hdr` (the pip cv2's
    decode of it as a PFM file: `env_sphere_cvgif` / `_ref`);
  * the timing file `sky_2048.exr` (`float_timing`: a 2048^2 float32 RGB
    TIFF, LZW with the floating-point predictor, built from a seed; the
    .npz keeps its decode's sha256 and 128 x 128 corner).

The TIFFs' LZW streams here hold literal codes only, a clear code every
253 of them (`lzw_literals`), so that numpy writes them at once; libtiff
and the port decode them as any other stream. Run
`python tools/gen_torch_cvtiff.py [out_dir]` (or `gen_torch_assets.py`,
which calls it, after the files it reads); it rewrites every file byte
for byte. Needs the pip cv2 and numpy.
"""
import hashlib
import importlib.util
import os
import struct
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "assets_torch")
TIMING_SEED = 2048
CORNER = 128


def _assets_module():
    """`tools/gen_torch_assets.py` (its TIFF and GIF writers), by path."""
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_assets_cv", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_assets.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lzw_literals(raw):
    """TIFF LZW (most significant bit first) of `raw` as literal codes: a
    clear code, then up to 253 bytes, again and again, then the end code;
    every code 9 bits wide (libtiff widens the codes at its 254th new
    entry)."""
    raw = np.frombuffer(raw, np.uint8).astype(np.uint16)
    n_groups = -(-len(raw) // 253)
    body = np.full(n_groups * 253, 0xFFFF, np.uint16)
    body[:len(raw)] = raw
    codes = np.concatenate([np.full((n_groups, 1), 256, np.uint16),
                            body.reshape(n_groups, 253)], 1).reshape(-1)
    codes = np.append(codes[codes != 0xFFFF], np.uint16(257))
    bits = np.unpackbits((codes << 7).astype(">u2").view(np.uint8)
                         .reshape(-1, 2), axis=1)[:, :9]
    return np.packbits(bits.reshape(-1)).tobytes()


def fp_predict(rows):
    """The floating-point predictor on float32 rows [h, w, spp]: each
    row's samples as big-endian byte planes, most significant first, then
    each byte less the one spp bytes before it (libtiff's fpDiff)."""
    h, w, spp = rows.shape
    b = rows.astype(">f4").view(np.uint8).reshape(h, w * spp, 4)
    planes = b.transpose(0, 2, 1).reshape(h, 4 * w, spp).astype(np.int64)
    d = planes.copy()
    d[:, 1:] -= planes[:, :-1]
    return (d & 0xFF).astype(np.uint8).reshape(h, -1)


def float_tiff(img, rows_per_strip=8, bo="<"):
    """A float32 RGB TIFF of img [h, w, 3]: strips of LZW-coded (literal
    codes) samples under the floating-point predictor."""
    img = np.asarray(img, np.float32)
    h, w, spp = img.shape
    strips = [lzw_literals(fp_predict(img[y:y + rows_per_strip]).tobytes())
              for y in range(0, h, rows_per_strip)]
    body = bytearray(b"II*\0" if bo == "<" else b"MM\0*") + bytes(4)
    offsets = []
    for s in strips:
        offsets.append(len(body))
        body += s + b"\0" * (len(s) % 2)
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [32] * spp), (259, 3, [5]),
            (262, 3, [2]), (273, 4, offsets), (277, 3, [spp]),
            (278, 3, [rows_per_strip]), (279, 4, [len(s) for s in strips]),
            (284, 3, [1]), (317, 3, [3]), (339, 3, [3] * spp)]
    ifd = len(body)
    end = ifd + 2 + 12 * len(tags) + 4
    entries, blobs = b"", bytearray()
    for tag, typ, vals in tags:
        data = struct.pack(bo + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        if len(data) <= 4:
            field = data.ljust(4, b"\0")
        else:
            field = struct.pack(bo + "I", end + len(blobs))
            blobs += data
        entries += struct.pack(bo + "HHI", tag, typ, len(vals)) + field
    body[4:8] = struct.pack(bo + "I", ifd)
    return bytes(body + struct.pack(bo + "H", len(tags)) + entries + bytes(4)
                 + blobs)


def float_timing(n=2048, seed=TIMING_SEED):
    """`sky_2048.exr`: an n x n float32 RGB TIFF of smooth HDR content
    with noise from the seed (OpenCV's direct route, LZW, predictor 3)."""
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / np.float32(n)
    base = np.stack([np.exp(3 * np.sin(6 * x + k) * np.cos(4 * y - k))
                     for k in range(3)], -1).astype(np.float32)
    noise = g.random((n, n, 3), np.float32) * np.float32(0.01)
    return float_tiff(base + noise, rows_per_strip=16)


def _pfm(img):
    """A PFM (colour, little-endian, bottom-up rows) of float32 RGB."""
    h, w = img.shape[:2]
    return (f"PF\n{w} {h}\n-1.0\n".encode() +
            np.ascontiguousarray(img[::-1], "<f4").tobytes())


def cv_files(ga, out=OUT):
    """name -> bytes of the files read through OpenCV's TIFF and GIF
    readers (the twins' references excepted)."""
    g = np.random.default_rng(37)
    h, w = 13, 21
    rgb = g.integers(0, 256, (h, w, 3))
    rgb[:, :6] = rgb[:, :1]
    a4 = g.integers(0, 256, (h, w, 4))
    idx = g.integers(0, 16, (h, w))
    pal = g.integers(0, 256, (16, 3))
    cmap = g.integers(0, 65536, (256, 3))
    f32 = (g.random((h, w, 3)) * 50 - 5).astype(np.float32)
    f32[0, :3] = [np.inf, -np.inf, 1e-40]
    t = ga.tiff_bytes
    files = {
        "cv_grey16_lzw.exr": t(rgb[..., :1] * 257 + 3, 16, 1, 5, predictor=2,
                               bo=">", rows_per_strip=5),
        "cv_rgb16_tiles.hdr": t(rgb * 251, 16, 2, 32946, tile=(16, 16)),
        "cv_rgba16.exr": t(a4 * 257, 16, 2, 32773, extra=(2,)),
        "cv_grey3_16.hdr": t(rgb * 257, 16, 1),
        "cv_i16.exr": t(rgb[..., :1] * 200 - 25000, 16, 1, sampleformat=2),
        "cv_u32.hdr": t(rgb[..., :1] * 70001, 32, 1, 8),
        "cv_i32_rgb.exr": t(rgb * 1000 - 100000, 32, 2, sampleformat=2),
        "cv_f32_pred3.hdr": t(f32, 32, 2, 8, predictor=3, sampleformat=3,
                              rows_per_strip=4),
        "cv_f64.exr": t(f32[..., :1].astype(np.float64) / 3, 64, 1,
                        sampleformat=3),
        "cv_rgb8_strips.hdr": t(rgb, 8, 2, 5, predictor=2, rows_per_strip=4),
        "cv_rgb8_single.exr": t(rgb, 8, 2, 32773),
        "cv_rgba8_unassoc.hdr": t(a4, 8, 2, 8, extra=(2,), rows_per_strip=6),
        "cv_rgb8_planar.exr": t(rgb, 8, 2, 32773, planar=True,
                                rows_per_strip=5),
        "cv_cmyk8.hdr": t(a4, 8, 5, 5),
        "cv_pal4_tiles.exr": t(idx[..., None], 4, 3, colormap=cmap[:16],
                               tile=(16, 16)),
        "cv_pal8_cmap8.hdr": t(rgb[..., :1], 8, 3, colormap=cmap % 256),
        "cv_pal1.exr": t(idx[..., None] & 1, 1, 3, colormap=cmap[:2]),
        "cv_white1.hdr": t(idx[..., None] & 1, 1, 0, 32773),
        "cv_white8_strips.exr": t(rgb[..., :1], 8, 0, rows_per_strip=3),
        "cv_la16.hdr": t(a4[..., :2] * 257 + 1, 16, 1, extra=(2,),
                         rows_per_strip=7),
        "cv_i8_rgb.exr": t(rgb - 128, 8, 2, sampleformat=2, rows_per_strip=4),
        "cv_gif_offset.hdr": ga.gif_bytes(idx, pal, transparency=3,
                                          screen=(w + 5, h + 2), offset=(3, 1)),
        "cv_gif_interlaced.exr": ga.gif_bytes(idx, pal, interlace=True,
                                              local=True),
        "cv_gif_code3.hdr": ga.gif_bytes(idx & 7, pal[:8], min_bits=3),
        "cv_gif_notable.exr": ga.gif_bytes(idx, None, min_bits=4),
    }
    # the Orientation tag (a square image: OpenCV 5.0 turns only those)
    for o in (3, 6):
        files[f"cv_orient{o}.hdr"] = _with_tag(t(rgb[:13, :13], 8, 2), 274, o)
    with open(os.path.join(out, "jpeg_ycbcr.tif"), "rb") as f:
        files["cv_jpeg_ycbcr.exr"] = f.read()
    files["sky_a_f32.exr"] = float_tiff(ga.sky("a"), rows_per_strip=8)
    i, p = ga._palette_of(ga.projector()[..., :3])
    files["projector_gif.hdr"] = ga.gif_bytes(i, p)
    return files


def _with_tag(data, tag, value):
    """A little-endian TIFF of `tiff_bytes` with a SHORT tag added to its
    directory (the values stored past the directory moved along)."""
    d = bytearray(data)
    off, = struct.unpack("<I", d[4:8])
    n, = struct.unpack("<H", d[off:off + 2])
    end = off + 2 + 12 * n + 4
    entries = []
    for k in range(n):
        e = bytearray(d[off + 2 + 12 * k:off + 14 + 12 * k])
        typ, count = struct.unpack("<HI", e[2:8])
        if {3: 2, 4: 4, 7: 1}[typ] * count > 4:
            at, = struct.unpack("<I", e[8:12])
            if at >= end:
                e[8:12] = struct.pack("<I", at + 12)
        entries.append(bytes(e))
    entries.append(struct.pack("<HHIH", tag, 3, 1, value) + bytes(2))
    entries.sort(key=lambda e: struct.unpack("<H", e[:2])[0])
    return bytes(d[:off] + struct.pack("<H", n + 1) + b"".join(entries)
                 + d[off + 2 + 12 * n:])


def _load(p):
    """What the JAX package's loader gets through the pip cv2."""
    import cv2
    a = cv2.imread(p, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    assert a is not None, p
    a = a.astype(np.float32)
    if a.ndim == 2:
        a = np.stack([a] * 3, -1)
    return np.ascontiguousarray(a[..., :3][..., ::-1])


def write_cv_files(out):
    """Every file of the module docstring and `cvtiff_decodes.npz`."""
    ga = _assets_module()
    dec = {}
    for fn, data in cv_files(ga, out).items():
        p = os.path.join(out, fn)
        with open(p, "wb") as f:
            f.write(data)
        dec[fn] = _load(p)
    assert np.array_equal(dec["sky_a_f32.exr"], ga.sky("a").astype(
        np.float32)), "the float TIFF holds sky_a's floats"
    sys.path.insert(0, ROOT)
    from vision_tpu_torch.scene import imageio   # its FLOAT OpenEXR writer
    imageio.write_exr(dec["sky_a_f32.exr"], os.path.join(
        out, "sky_a_f32_ref.exr"))
    with open(os.path.join(out, "projector_gif_pfm.hdr"), "wb") as f:
        f.write(_pfm(dec["projector_gif.hdr"]))
    p = os.path.join(out, "sky_2048.exr")
    with open(p, "wb") as f:
        f.write(float_timing())
    full = _load(p)
    os.remove(p)
    dec["sky_2048.exr:sha256"] = np.frombuffer(
        hashlib.sha256(full.tobytes()).digest(), np.uint8)
    dec["sky_2048.exr:corner"] = full[:CORNER, :CORNER]
    np.savez_compressed(os.path.join(out, "cvtiff_decodes.npz"), **dec)


if __name__ == "__main__":
    write_cv_files(sys.argv[1] if len(sys.argv) > 1 else OUT)
