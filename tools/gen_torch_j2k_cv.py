"""JPEG 2000 files for slice 7e.7b (OpenCV's route), in
`tests/assets_torch/`, with `j2k_cv_decodes.npz`: what the JAX package's
loader gets for each under a .hdr / .exr name, `cv2.imread(p,
IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)` through the pip cv2 5.0.0 (OpenJPEG
2.5.3), cast to float32, grey stacked to three channels, B, G, R flipped to
R, G, B: float32 [H, W, 3].

    python tools/gen_torch_j2k_cv.py [out_dir]

Run it after `tools/gen_torch_j2k.py` (`tools/gen_torch_assets.py` calls
both): it reads that script's files and uses its writers (PIL's encoder in
a child process, `J2kWriter`, the JP2 box helpers). It writes

  * `j2kcv_*`: the cases OpenCV's rules need that slice 7e.7a's files do
    not hold: 9-16-bit unsigned grey and RGB (5/3 and 9/7, mixed
    precisions); palette JP2 files with cmap boxes (direct and palette
    mappings, four columns, 16-bit columns, the mapping OpenJPEG corrects,
    a palette over two or three components, cdef over the palette's
    channels); cdef-reordered and alpha-first RGB; sYCC 4:4:4 with and
    without alpha at 12 and 16 bits and of one component; grey colr boxes
    over two and three components; CIELab and an ignored colr box; tiled
    files at the origin (PIL's encoder, and several tile-parts); POC
    stops on one tile and on several; trailing bytes; and `j2kcv_bad_*`,
    files the pip cv2 refuses for OpenCV's own reasons (one or two
    channels where it wants three, an incomplete or out-of-range cdef, a
    tile-part count OpenJPEG 2.5.3 holds the stream to);
  * the twins: `sky_a_j2kcv.exr` (sky_a times 1600, rounded: a lossless
    5/3 16-bit three-component JP2 with RCT, its wavelet coefficients
    computed here and written by `J2kWriter`) with `sky_a_j2kcv_ref.exr`
    (the pip cv2's decode, a FLOAT OpenEXR file), and
    `projector_j2kcv.hdr` (the projector's RGB, an 8-bit 9/7 JP2 with an
    sRGB colr box and no image offset, PIL's encoder) with
    `projector_j2kcv_pfm.hdr` (the pip cv2's decode, a PFM), and slice
    7e.7d's `projector_j2kp2cv.exr` (tiles with different MCOs,
    `tools/gen_torch_j2k_p2.py`) with `projector_j2kp2cv_pfm.hdr`, and
    slice 7e.7c's `projector_htj2kcv.exr` (9/7 HT code-blocks refined in a
    second layer, `tools/gen_torch_j2k_ht.py`) with
    `projector_htj2kcv_pfm.hdr`;
  * `j2k_cv_decodes.npz`: the decode of every file above and of every
    committed JPEG 2000 file of slice 7e.7a (`j2k_*`, `checker_j2k.jp2`,
    `projector_j2k.j2k`), read under a .exr name; the names the pip cv2
    refuses under ":refused"; the sha256 and 128 x 128 corner of its
    decode of `j2k_2048.jp2` under "j2k_2048.jp2:sha256" / ":corner";
    under "edits:sha256" the outcome of each seeded edit of `edit_cases()`
    (the sha256 of `_digest`, zeros where the pip cv2 refuses); and slice
    7e.7d's edit outcomes and tile-resolution runs ("p2edits:sha256",
    "<name>:runs"); slice 7e.7c's HT files (`htj2k_*`,
    `checker_htj2k.jp2`), their edits' outcomes ("htedits:sha256") and
    `htj2k_2048.jp2` as `j2k_2048.jp2`.

Needs PIL, numpy and the pip cv2 (run in a child process, one for all the
files: a broken file could crash it). The output is deterministic:
running it again writes the same bytes.
"""
import hashlib
import importlib.util
import os
import shutil
import struct
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "assets_torch")
CORNER = 128
SEED = 25
SKY_SCALE = 1600          # sky_a's floats times this, rounded, in 16 bits

sys.path.insert(0, ROOT)
from vision_tpu_torch.scene import j2k as J  # noqa: E402


def _j2k_module():
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_j2k_cv_base", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_j2k.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


G = _j2k_module()


# ---------------------------------------------------------------------------
# lossless coefficients: RCT and the forward 5/3 wavelet
# ---------------------------------------------------------------------------

def _fdwt53(w):
    """The forward 5/3 lifting along axis 0 (OpenJPEG's layout, the
    signal's first sample at an even coordinate) -> [lows | highs]: the
    exact inverse of the port's `j2k._idwt53`."""
    w = np.array(w, np.int64)
    if len(w) == 1:
        return w
    t, side = J._neighbours(w, 1)
    t -= side >> 1
    t, side = J._neighbours(w, 0)
    t += (side + 2) >> 2
    return np.concatenate([w[0::2], w[1::2]])


def lossless_coefs(img, prec, numres, mct):
    """An image (int [H, W, C] of `prec`-bit unsigned samples) -> the
    `coefs` source of `J2kWriter` for a one-tile reversible codestream at
    the origin: the DC level shift, RCT where `mct`, then `numres` - 1
    levels of the forward 5/3 wavelet (rows of each level, then its
    columns, the inverse's order reversed) in OpenJPEG's Mallat layout."""
    a = img.astype(np.int64) - (1 << (prec - 1))
    if mct:
        r, g, b = a[..., 0], a[..., 1], a[..., 2]
        a = np.stack([(r + 2 * g + b) >> 2, b - g, r - g], -1)
    h, w = a.shape[:2]
    planes = []
    for c in range(a.shape[2]):
        m = a[..., c].copy()
        for lev in range(numres - 1):
            rh, rw = -(-h // (1 << lev)), -(-w // (1 << lev))
            m[:rh, :rw] = _fdwt53(m[:rh, :rw])
            m[:rh, :rw] = _fdwt53(m[:rh, :rw].T).T
        planes.append(m)

    def coefs(comp, resno, band, cb):
        x, y = cb.x0 - band.x0, cb.y0 - band.y0
        lev = numres - resno        # the band's level, 1 = the finest
        if band.bandno & 1:
            x += -(-w // (1 << lev))
        if band.bandno & 2:
            y += -(-h // (1 << lev))
        return planes[comp][y:y + cb.y1 - cb.y0, x:x + cb.x1 - cb.x0]
    return coefs


def lossless_jp2(img, prec, numres=3, cblk=(5, 5), mct=1):
    """A lossless 5/3 JP2 (sRGB colr for three components, grey for one)
    of `img` (uint [H, W, C]), one tile, at the origin."""
    h, w, nc = img.shape
    hdr = G.cod(numres, cblk=cblk, mct=mct) + \
        G.qcd(0, 3, G.rev_steps(numres, prec))
    cs = G.J2kWriter(w, h, [(prec, 0, 1, 1)] * nc, hdr, 0,
                     coefs=lossless_coefs(img, prec, numres, mct)).build()
    return G.jp2(cs, w, h, nc, bpc=prec - 1,
                 colr=(1, 16 if nc >= 3 else 17))


# ---------------------------------------------------------------------------
# the files
# ---------------------------------------------------------------------------

def cdef(entries):
    """A cdef box's payload: [(channel, type, association)]."""
    return struct.pack(">H", len(entries)) + b"".join(
        struct.pack(">HHH", *e) for e in entries)


def cmap(entries):
    """A cmap box's payload: [(component, mapping type, palette column)]."""
    return b"".join(struct.pack(">HBB", *e) for e in entries)


def _colr(enumcs):
    return (b"colr", bytes([1, 0, 0]) + struct.pack(">I", enumcs))


def cv_files(assets):
    """The `j2kcv_*` files (the module docstring's list): name -> bytes."""
    def read(fn):
        with open(os.path.join(assets, fn), "rb") as f:
            return f.read()
    g = np.random.default_rng(SEED)
    f = {}
    one, rgb = [(8, 0, 1, 1)], [(8, 0, 1, 1)] * 3
    # 9-16-bit unsigned samples: CV_16U, kept as they are
    for prec in (9, 12, 16):
        f[f"j2kcv_grey{prec}.j2k"] = G.J2kWriter(
            24, 20, [(prec, 0, 1, 1)], G._rev(3, prec, cblk=(4, 4)),
            200 + prec, bits=min(prec, 12)).build()
    cs = G.J2kWriter(24, 20, [(10, 0, 1, 1)] * 3,
                     G._rev(3, 10, cblk=(4, 4), mct=1), 210, bits=9).build()
    f["j2kcv_rgb10.jp2"] = G.jp2(cs, 24, 20, 3, bpc=9, colr=(1, 16))
    steps16 = [(11, 100)] + [(11, 50), (11, 60), (12, 10)] * 2
    f["j2kcv_rgb16_irr.j2k"] = G.J2kWriter(
        24, 20, [(16, 0, 1, 1)] * 3, G.cod(3, qmf=0, mct=1) +
        G.qcd(2, 2, steps16), 211, bits=10).build()
    f["j2kcv_prec_mixed.j2k"] = G.J2kWriter(
        24, 20, [(12, 0, 1, 1), (8, 0, 1, 1), (10, 0, 1, 1)],
        G._rev(3, 12, cblk=(4, 4)), 212).build()
    f["j2kcv_grey2_16.jp2"] = G.jp2(G.J2kWriter(
        24, 20, [(16, 0, 1, 1)] * 2, G._rev(3, 16, cblk=(4, 4)), 213,
        bits=12).build(), 24, 20, 2, bpc=15, colr=(1, 17))
    # palettes: applied by OpenJPEG where a cmap box maps them
    c1 = G.codestream_of(read("j2k_p3.jp2"))
    c2 = G.codestream_of(read("j2k_la_rev.jp2"))
    c3 = G.codestream_of(read("j2k_sycc.jp2"))
    c4 = G.codestream_of(read("j2k_sycca.jp2"))
    pal3 = [(10, 20, 30), (40, 50, 60), (10, 20, 30), (200, 0, 0),
            (0, 200, 0)]
    pal4 = [(10, 20, 30, 40), (40, 50, 60, 255), (10, 20, 30, 40),
            (200, 0, 0, 0)]
    ramp = [(i, 255 - i, (i * 7) & 255) for i in range(256)]

    def p1(extra, enumcs=16):
        return G.jp2(c1, 16, 12, 1, colr=(1, enumcs), extra=extra)
    f["j2kcv_pal4_cmap.jp2"] = p1([(b"pclr", G.pclr(pal4)),
                                   (b"cmap", G.cmap(4))])
    f["j2kcv_pal16.jp2"] = p1([(b"pclr", G.pclr(
        [(300, 1000, 65535), (5, 6, 700), (256, 4095, 1), (1, 2, 3),
         (4, 5, 6), (7, 8, 9), (10, 11, 12)], [15, 11, 15])),
        (b"cmap", G.cmap(3))])
    f["j2kcv_pal_grey.jp2"] = p1([(b"pclr", G.pclr(pal3)),
                                  (b"cmap", G.cmap(3))], 17)
    f["j2kcv_pal_sycc.jp2"] = p1([(b"pclr", G.pclr(pal3)),
                                  (b"cmap", G.cmap(3))], 18)
    f["j2kcv_pal_cdef.jp2"] = p1([(b"pclr", G.pclr(pal3)),
                                  (b"cmap", G.cmap(3)),
                                  (b"cdef", cdef([(0, 0, 3), (1, 0, 2),
                                                  (2, 0, 1)]))])
    f["j2kcv_pal_corrected.jp2"] = p1([(b"pclr", G.pclr(pal3)),
                                       (b"cmap", cmap([(0, 0, 0)] * 3))])
    f["j2kcv_pal_on2.jp2"] = G.jp2(c2, 37, 40, 2, colr=(1, 16), extra=[
        (b"pclr", G.pclr(ramp)),
        (b"cmap", cmap([(0, 1, 0), (1, 1, 1), (0, 1, 2)]))])
    f["j2kcv_pal_mixed.jp2"] = G.jp2(c3, 45, 33, 3, colr=(1, 16), extra=[
        (b"pclr", G.pclr(ramp)),
        (b"cmap", cmap([(2, 1, 0), (0, 0, 0), (1, 1, 2)]))])
    f["j2kcv_bad_pal_one.jp2"] = G.jp2(c3, 45, 33, 3, colr=(1, 16), extra=[
        (b"pclr", G.pclr([(255 - i,) for i in range(256)])),
        (b"cmap", cmap([(1, 1, 0)]))])
    f["j2kcv_bad_pal_two_sycc.jp2"] = G.jp2(c3, 45, 33, 3, colr=(1, 18),
                                            extra=[
        (b"pclr", G.pclr([(255 - i, i) for i in range(256)])),
        (b"cmap", cmap([(1, 1, 0), (2, 1, 1)]))])
    # channel definitions
    f["j2kcv_cdef_swap.jp2"] = G.jp2(c3, 45, 33, 3, colr=(1, 16), extra=[
        (b"cdef", cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1)]))])
    f["j2kcv_cdef_alpha_first.jp2"] = G.jp2(c4, 31, 29, 4, colr=(1, 16),
                                            extra=[
        (b"cdef", cdef([(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)]))])
    f["j2kcv_cdef_two_alpha.jp2"] = G.jp2(c4, 31, 29, 4, colr=(1, 16),
                                          extra=[
        (b"cdef", cdef([(0, 0, 1), (1, 0, 2), (2, 1, 0), (3, 1, 0)]))])
    f["j2kcv_bad_cdef_incomplete.jp2"] = G.jp2(c3, 45, 33, 3, colr=(1, 16),
                                               extra=[
        (b"cdef", cdef([(0, 0, 1), (1, 0, 2)]))])
    f["j2kcv_bad_cdef_asoc.jp2"] = G.jp2(c3, 45, 33, 3, colr=(1, 16), extra=[
        (b"cdef", cdef([(0, 0, 1), (1, 0, 2), (2, 0, 7)]))])
    # sYCC 4:4:4, grey, other colr boxes
    for name, prec, nc in (("sycc12", 12, 3), ("sycca16", 16, 4)):
        cs = G.J2kWriter(24, 20, [(prec, 0, 1, 1)] * nc,
                         G._rev(3, prec, cblk=(4, 4)), 220 + prec,
                         bits=min(prec - 2, 12)).build()
        f[f"j2kcv_{name}.jp2"] = G.jp2(cs, 24, 20, nc, bpc=prec - 1,
                                       colr=(1, 18))
    f["j2kcv_sycc1.jp2"] = G.jp2(c1, 16, 12, 1, colr=(1, 18))
    f["j2kcv_bad_sycc2.jp2"] = G.jp2(c2, 37, 40, 2, colr=(1, 18))
    f["j2kcv_grey3.jp2"] = G.jp2(c3, 45, 33, 3, colr=(1, 17))
    f["j2kcv_lab.jp2"] = G.jp2(c3, 45, 33, 3, colr=(1, 14))
    f["j2kcv_colr_meth3.jp2"] = G.jp2(c3, 45, 33, 3,
                                      colr=(3, b"\0\0\0\x11"),
                                      extra=[_colr(17)])
    # tiles at the origin, tile-parts, POC stops
    img = G._smooth(g, 45, 52, 3)
    f["j2kcv_tiles_rgb.j2k"] = G.pil_encode(img, tile_size=(16, 16), mct=1,
                                            no_jp2=True)
    hdr = G._rev(3, 16, cblk=(4, 4), layers=2)
    f["j2kcv_tiles16.j2k"] = G.J2kWriter(
        30, 26, [(16, 0, 1, 1)], hdr, 230, tile=(16, 12), parts=2,
        layers_split=True, bits=12).build()
    hdr8 = G._rev(3, cblk=(4, 4), layers=2)
    w = G.J2kWriter(24, 20, one, hdr8, 231, parts=2)
    w.tnsot = 1               # one tile, a second tile-part it does not count
    f["j2kcv_one_tile_tnsot1.j2k"] = w.build()
    w = G.J2kWriter(24, 20, one, hdr8, 232, tile=(16, 16), parts=2)
    w.tnsot = 1
    f["j2kcv_bad_tnsot1.j2k"] = w.build()
    f["j2kcv_poc_stop.j2k"] = G.J2kWriter(
        23, 19, rgb, G._rev(3, cblk=(4, 4), mct=1) +
        G.poc([(0, 0, 1, 2, 3, 0)]), 233).build()
    f["j2kcv_poc_stop_c1.j2k"] = G.J2kWriter(
        23, 19, rgb, G._rev(3, cblk=(4, 4)) +
        G.poc([(0, 0, 1, 3, 1, 0), (0, 1, 1, 1, 2, 0), (0, 2, 1, 3, 3, 0)]),
        234, tile=(12, 10)).build()
    f["j2kcv_trailing.jp2"] = read("j2k_rgb_rev_mct.jp2") + b"junk" * 3
    return f


def twin_files(sky, projector_rgb):
    """`sky_a_j2kcv.exr`, `projector_j2kcv.hdr`, `projector_j2kp2cv.exr`
    and `projector_htj2kcv.exr` (the module docstring)."""
    q = np.clip(np.round(sky.astype(np.float64) * SKY_SCALE), 0,
                65535).astype(np.uint16)
    return {"sky_a_j2kcv.exr": lossless_jp2(q, 16, numres=3),
            "projector_j2kcv.hdr": G.pil_encode(projector_rgb,
                                                irreversible=True, mct=1),
            "projector_j2kp2cv.exr": G._p2_module().projector_twin(
                projector_rgb),
            "projector_htj2kcv.exr": G._ht_module().projector_twin(
                projector_rgb)}


def committed_files(assets):
    """The committed JPEG 2000 files of slices 7e.7a, 7e.7d and 7e.7c."""
    return sorted(fn for fn in os.listdir(assets)
                  if (fn.startswith(("j2k_", "htj2k_")) and
                      fn.endswith((".j2k", ".jp2"))
                      and fn not in ("j2k_2048.jp2", "htj2k_2048.jp2"))
                  or fn in ("checker_j2k.jp2", "projector_j2k.j2k",
                            "checker_htj2k.jp2"))


EDIT_SOURCES = ("j2k_rgb_irr_mct.jp2", "j2k_tiles_irr.jp2", "j2k_ppt.j2k",
                "j2k_sty_all.j2k", "j2k_p3.jp2", "j2k_sycc.jp2",
                "j2k_parts.j2k", "j2k_poc_reduced.j2k", "j2k_prec12.j2k",
                "j2k_la_rev.jp2", "j2kcv_pal_cdef.jp2", "j2kcv_tiles16.j2k")
EDITS_EACH = 25


def edit_cases(assets):
    """EDITS_EACH seeded cuts, byte replacements or bit flips of each file
    of EDIT_SOURCES -> [(source, bytes)], in order."""
    out = []
    for si, fn in enumerate(EDIT_SOURCES):
        with open(os.path.join(assets, fn), "rb") as fh:
            src = fh.read()
        g = np.random.default_rng(SEED * 1000 + si)
        for _ in range(EDITS_EACH):
            d = bytearray(src)
            kind = int(g.integers(3))
            if kind == 0:
                d = d[:int(g.integers(1, len(d)))]
            else:
                for _ in range(int(g.integers(1, 3))):
                    i = int(g.integers(0, len(d)))
                    d[i] = int(g.integers(0, 256)) if kind == 1 else \
                        d[i] ^ (1 << int(g.integers(8)))
            out.append((fn, bytes(d)))
    return out


def _digest(img):
    """The sha256 of a decode (its shape, then its float32 samples), or
    32 zero bytes for a refusal."""
    if img is None:
        return bytes(32)
    img = np.ascontiguousarray(img, np.float32)
    return hashlib.sha256(str(img.shape).encode() + img.tobytes()).digest()


_READ = (
    "import os, sys\n"
    "import numpy as np\n"
    "import cv2\n"
    "d = sys.argv[1]\n"
    "for fn in sorted(os.listdir(d)):\n"
    "    try:\n"
    "        a = cv2.imread(os.path.join(d, fn), cv2.IMREAD_ANYCOLOR | "
    "cv2.IMREAD_ANYDEPTH)\n"
    "    except cv2.error:\n"
    "        a = None\n"
    "    if a is not None:\n"
    "        np.save(os.path.join(d, fn + '.npy'), a)\n")


def cv2_decodes(named):
    """{name: bytes} -> {name: what the JAX package's loader gets through
    the pip cv2 under a .exr name (float32 [H, W, 3] RGB), or None where
    imread returns None or raises (an image past OpenCV's size limits),
    one child process for all."""
    tmp = tempfile.mkdtemp()
    try:
        keys = sorted(named)
        for i, k in enumerate(keys):
            with open(os.path.join(tmp, f"{i:05d}.exr"), "wb") as fh:
                fh.write(named[k])
        subprocess.run([sys.executable, "-c", _READ, tmp], check=True,
                       capture_output=True)
        out = {}
        for i, k in enumerate(keys):
            p = os.path.join(tmp, f"{i:05d}.exr.npy")
            if not os.path.exists(p):
                out[k] = None
                continue
            a = np.load(p).astype(np.float32)
            if a.ndim == 2:
                a = np.stack([a] * 3, -1)
            out[k] = np.ascontiguousarray(a[..., :3][..., ::-1])
        return out
    finally:
        shutil.rmtree(tmp)


def write_j2k_cv_files(out, sky, projector_rgb):
    """Every file of the module docstring and `j2k_cv_decodes.npz`."""
    from vision_tpu_torch.scene import imageio   # its FLOAT OpenEXR writer
    pfm = _assets_module()._cvtiff_module()._pfm
    files = cv_files(out)
    files.update(twin_files(sky, projector_rgb))
    for fn, data in files.items():
        with open(os.path.join(out, fn), "wb") as fh:
            fh.write(data)
    named = dict(files)
    for fn in committed_files(out):
        with open(os.path.join(out, fn), "rb") as fh:
            named[fn] = fh.read()
    for fn in ("j2k_2048.jp2", "htj2k_2048.jp2"):
        with open(os.path.join(out, fn), "rb") as fh:
            named[fn] = fh.read()
    edits = edit_cases(out)
    for i, (_, d) in enumerate(edits):
        named[f":edit{i:04d}"] = d
    dec = cv2_decodes(named)
    for fn in files:
        assert (dec[fn] is None) == fn.startswith("j2kcv_bad_"), fn
    keep = {fn: a for fn, a in dec.items()
            if a is not None and not fn.startswith(":")
            and fn not in ("j2k_2048.jp2", "htj2k_2048.jp2")}
    keep[":refused"] = np.array(sorted(fn for fn, a in dec.items()
                                       if a is None
                                       and not fn.startswith(":")))
    for fn in ("j2k_2048.jp2", "htj2k_2048.jp2"):
        full = dec[fn]
        keep[fn + ":sha256"] = np.frombuffer(
            hashlib.sha256(full.tobytes()).digest(), np.uint8)
        keep[fn + ":corner"] = full[:CORNER, :CORNER]
    keep["edits:sha256"] = np.array(
        [np.frombuffer(_digest(dec[f":edit{i:04d}"]), np.uint8)
         for i in range(len(edits))])
    imageio.write_exr(dec["sky_a_j2kcv.exr"],
                      os.path.join(out, "sky_a_j2kcv_ref.exr"))
    for fn in ("projector_j2kcv.hdr", "projector_j2kp2cv.exr",
               "projector_htj2kcv.exr"):
        with open(os.path.join(out, fn.split(".")[0] + "_pfm.hdr"),
                  "wb") as fh:
            fh.write(pfm(dec[fn]))
    p2 = G._p2_module()
    p2_files = {fn: named[fn] for fn in named if fn.startswith("j2k_")}
    keep["p2edits:sha256"] = p2.edit_digests(p2_files, "cv")
    for fn, runs in p2.res_runs(p2_files, "cv").items():
        keep[fn + ":runs"] = runs
    ht = G._ht_module()
    ht_named = {fn: named[fn] for fn in named if fn.startswith("htj2k_")}
    ht.once_per_process(ht_named, "cv")
    keep["htedits:sha256"] = ht.edit_digests(ht_named, "cv")
    np.savez_compressed(os.path.join(out, "j2k_cv_decodes.npz"), **keep)


def _assets_module():
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_assets_j2k_cv", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_assets.py"))
    ga = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ga)
    return ga


def main():
    ga = _assets_module()
    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    write_j2k_cv_files(out, ga.sky("a"), ga.projector()[..., :3])


if __name__ == "__main__":
    main()
