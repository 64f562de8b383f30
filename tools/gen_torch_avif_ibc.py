"""AVIF files with intra block copy for `tests/assets_torch/` (slice
7e.8a.2c.1): AV1 key frames with `allow_intrabc` 1, as PIL 12.1.0's
encoder (libavif 1.3.0 over aom 3.12.1) writes them for flat and
screen-like images, and PIL's decode of each.

    python tools/gen_torch_avif_ibc.py [out_dir]

(`tools/gen_torch_avif_lossy.py` `write_lossy_files` calls
`write_ibc_files`, after `gen_torch_avif.py` has checked av1_codec.cpp's
tables against the library.)

  * The files (`ibc_files`), each asserted to carry `allow_intrabc` 1 and
    the header fields it is meant to (`gen_torch_avif_lossy.frame_fields`),
    and, through the port's path
    counters, to hold intra block copy blocks (`check_files`):
    `avifibc_*` of flat and screen-like content (crops of
    `gen_torch_avif.timing_image`, the twins' checker, a page of glyphs,
    repeated tiles under smooth bumps) at PIL's defaults, at qualities 0-99
    (the four quantiser contexts), at speeds 0-7, coded lossless at 4:2:0
    and 4:4:4, at 4:2:2 and 4:0:0, at odd sizes, in several tiles and
    autotiled, with 128x128 superblocks, `reduced_tx_set` 1, an alpha
    item, limited range, and each intra tool switched off through
    `advanced=` where aom keeps intra block copy.
  * The twins' `checker_avifibc.avif` (the checker's colours at 256^2)
    and `projector_avifibc.avif` (a screen-like RGBA projector), at PIL's
    defaults, with PIL's decodes as PNGs; the timing file
    `avifibc_2048.avif` (`timing_image(2048)`, PIL's defaults, autotiled).
  * `avifibc_decodes.npz`: PIL's `convert("RGB")` of each file (decoded in a
    child process), the timing file's sha256 and 128 x 128 corner, and
    under "edits:sha256" the digest of PIL's outcome on each of
    `edit_cases` (seeded edits of `EDIT_SOURCES`: a third in the
    container, a third in the AV1 headers, a third in the tile data).

Needs PIL and numpy. The output is deterministic.
"""
import hashlib
import importlib.util
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SEED = 31
_spec = importlib.util.spec_from_file_location(
    "vt_gen_torch_avif_for_ibc", os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "gen_torch_avif.py"))
G = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(G)
_save = G._save
_spec = importlib.util.spec_from_file_location(
    "vt_gen_torch_avif_lossy_for_ibc", os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "gen_torch_avif_lossy.py"))
L = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(L)
# the header fields of a file's colour frame (and its alpha frame's) as
# the port reads them, allow_intrabc among them
frame_fields = L.frame_fields


def checker(n=256, square=8):
    """The twins' checker (`gen_torch_assets.checker`'s colours)."""
    y, x = np.mgrid[0:n, 0:n]
    on = ((x // square + y // square) % 2).astype(bool)
    return np.where(on[..., None], [235, 225, 205],
                    [40, 70, 160]).astype(np.uint8)


def projector(h=128, w=256):
    """A screen-like projector: three bands of squares 16 samples wide
    under an alpha ramp."""
    y, x = np.mgrid[0:h, 0:w]
    bands = np.array([[230, 60, 50], [60, 200, 80], [60, 90, 230]])
    rgb = bands[np.minimum(x * 3 // w, 2)]
    stripe = (x // 16 + y // 16) % 2 == 0
    rgb = np.where(stripe[..., None], rgb, rgb // 3 + 40)
    alpha = (255 - x * 255 // w)[..., None]
    return np.concatenate([rgb, alpha], -1).astype(np.uint8)


def page(g, h, w):
    """Lines of eight seeded glyphs (8 x 10 boxes, 10 samples apart) on
    white."""
    glyphs = g.integers(0, 3, (8, 10, 8)) == 0
    img = np.full((h, w, 3), 255, np.uint8)
    for y in range(4, h - 10, 14):
        for x in range(4, w - 8, 10):
            if g.random() < 0.85:
                img[y:y + 10, x:x + 8][glyphs[g.integers(8)]] = 0
    return img


def bumps(g, h, w, t=32, n=1, amp=20, colours=3):
    """Tiles of `t` samples, each a copy of one seeded tile of 4x4 cells in
    `colours` colours under `n` smooth bumps of its own: aom copies the
    tiles and codes the bumps with the inter transform types."""
    pal = g.integers(0, 256, (colours, 3))
    base = pal[g.integers(0, colours, (t // 4, t // 4))].repeat(
        4, 0).repeat(4, 1).astype(float)
    img = np.zeros((h + t, w + t, 3)) + pal[0]
    yy, xx = np.mgrid[0:t, 0:t]
    for y in range(0, h, t):
        for x in range(0, w, t):
            tile = base.copy()
            for _ in range(n):
                cy, cx = g.integers(0, t, 2)
                s = g.uniform(1.5, 5)
                kind = g.integers(3)
                if kind == 0:
                    b = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) /
                               (2 * s * s))
                elif kind == 1:
                    b = np.clip(1 - np.abs(xx - cx) / (3 * s), 0, 1) * \
                        (np.abs(yy - cy) < s)
                else:
                    b = np.clip(1 - np.abs(yy - cy) / (3 * s), 0, 1) * \
                        (np.abs(xx - cx) < s)
                tile += amp * g.uniform(-1, 1, 3) * b[..., None]
            img[y:y + t, x:x + t] = tile
    return np.clip(img[:h, :w], 0, 255).astype(np.uint8)


def glyph_tiles(g, h, w, t=24, colours=3):
    """Tiles of `t` samples, each a copy of one seeded tile of single
    samples in `colours` colours with two samples of its own changed: the
    identity transforms of the inter sets."""
    pal = g.integers(0, 256, (colours, 3))
    base = pal[g.integers(0, colours, (t, t))]
    img = np.zeros((h + t, w + t, 3), int) + pal[0]
    for y in range(0, h, t):
        for x in range(0, w, t):
            tile = base.copy()
            for _ in range(2):
                yy, xx = g.integers(0, t, 2)
                tile[yy, xx] = pal[g.integers(colours)]
            img[y:y + t, x:x + t] = tile
    return img[:h, :w].astype(np.uint8)


def images():
    """The source images, from SEED."""
    g = np.random.default_rng(SEED)
    t512 = G.timing_image(512)
    out = {"timing": G.timing_image(256), "timing_wide": t512[:192, :512],
           "checker": checker(), "page": page(g, 144, 256),
           "bumps": bumps(g, 128, 256), "bumps3": bumps(g, 128, 256, n=3),
           "bumps_big": bumps(g, 128, 256, amp=60),
           "page_big": page(g, 256, 384)}
    mask = page(g, 144, 256)[..., 0] == 0
    out["rgba"] = np.dstack([out["page"], np.where(mask, 55, 255).astype(
        np.uint8)])
    for h, w in SIZES:
        out[f"page_{h}x{w}"] = page(g, h, w)
    out["glyph_tiles"] = glyph_tiles(np.random.default_rng(SEED + 3), 128,
                                     256)
    out["bumps_square"] = bumps(np.random.default_rng(SEED + 4), 256, 256,
                                n=3)
    return out


_SS = {"444": "4:4:4", "422": "4:2:2", "420": "4:2:0", "400": "4:0:0"}
# (`enable-angle-delta` 0 writes the same file as the defaults here)
_TOOLS = {"nofilterintra": {"enable-filter-intra": "0"},
          "nosmooth": {"enable-smooth-intra": "0"},
          "nopaeth": {"enable-paeth-intra": "0"},
          "nocfl": {"enable-cfl-intra": "0"},
          "noedge": {"enable-intra-edge-filter": "0"},
          "nopalette": {"enable-palette": "0"}}
# (quality, base_q_idx) as aom maps them: the four quantiser contexts
QUALITIES = ((0, 255), (1, 249), (20, 200), (40, 152), (60, 100), (75, 64),
             (90, 24), (99, 4))
# odd sizes (h, w) and their subsamplings: the right and bottom edges
SIZES = ((133, 197), (201, 131), (97, 301))
_SIZE_SS = {(133, 197): ("420", "422"), (201, 131): ("420", "444"),
            (97, 301): ("420", "400")}


def ibc_files(im=None):
    """name -> (bytes, {header field: value it must carry}) of every file
    of the slice but the twins and the timing file."""
    im = im or images()
    out = {}
    for name in ("timing", "timing_wide", "checker", "page", "bumps"):
        out[f"avifibc_{name}.avif"] = (_save(im[name]),
                                       {"base_q": 64, "reduced_tx_set": 0})
    for q, qidx in QUALITIES:
        out[f"avifibc_q{q}.avif"] = (_save(im["bumps3"], quality=q),
                                     {"base_q": qidx})
    for sp in range(8):
        out[f"avifibc_s{sp}.avif"] = (_save(im["page"], speed=sp), {})
    out["avifibc_glyphtiles.avif"] = (
        _save(im["glyph_tiles"], quality=50, speed=2), {})
    # speed 0 splits the var-tx tree to depth 2 (loop restoration off, as
    # aom would write it without intra block copy)
    out["avifibc_vartx_s0.avif"] = (
        _save(im["bumps_square"], quality=60, speed=0,
              advanced={"enable-restoration": "0"}), {})
    for ss in ("420", "444"):
        out[f"avifibc_lossless_{ss}.avif"] = (
            _save(im["page"], quality=100, subsampling=_SS[ss]),
            {"lossless": 1})
    for ss, sub in _SS.items():
        out[f"avifibc_{ss}.avif"] = (
            _save(im["bumps_big"], quality=60, subsampling=sub),
            {"mono": int(ss == "400")})
    for h, w in SIZES:
        for ss in _SIZE_SS[(h, w)]:
            out[f"avifibc_size_{h}x{w}_{ss}.avif"] = (
                _save(im[f"page_{h}x{w}"], subsampling=_SS[ss]), {})
    # tile_rows / tile_cols are log2; 384 samples are six superblocks
    for r, c, tiles in ((1, 1, (2, 2)), (0, 2, (3, 1)), (2, 0, (1, 4))):
        out[f"avifibc_tiles_{r}{c}.avif"] = (
            _save(im["page_big"], tile_rows=r, tile_cols=c),
            {"tiles": tiles})
    out["avifibc_autotile.avif"] = (_save(im["page_big"], autotiling=True),
                                    {})
    out["avifibc_sb128.avif"] = (
        _save(im["page_big"], advanced={"sb-size": "128"}), {"sb128": 1})
    out["avifibc_rts.avif"] = (
        _save(im["bumps"], advanced={"reduced-tx-type-set": "1"}),
        {"reduced_tx_set": 1})
    out["avifibc_rgba.avif"] = (_save(im["rgba"]), {"alpha_intrabc": 1})
    out["avifibc_limited.avif"] = (_save(im["bumps"], range="limited"),
                                   {"full_range": 0})
    for tool, adv in _TOOLS.items():
        out[f"avifibc_{tool}.avif"] = (_save(im["timing_wide"], advanced=adv),
                                       {})
    return out


def ibc_blocks(data):
    """The intra block copy blocks the port decodes in a file."""
    sys.path.insert(0, ROOT)
    from vision_tpu_torch import native
    from vision_tpu_torch.scene import pilread
    native.av1_coverage(reset=True)
    pilread.read(data, "x.avif")
    return int(native.av1_coverage()[131])


def check_files(files):
    """Each file carries allow_intrabc 1 and its own fields, and holds
    intra block copy blocks."""
    for fn, (data, want) in files.items():
        got = frame_fields(data)
        for k, v in dict(want, allow_intrabc=1).items():
            if got[k] != v:
                raise RuntimeError(f"{fn}: {k} is {got[k]}, not {v}")
        if not ibc_blocks(data):
            raise RuntimeError(f"{fn}: no block uses intra block copy")


def twin_files():
    """The twins' files at PIL's defaults: the checker (the checker's
    colours at 256^2) and the screen-like projector, each with intra block
    copy blocks."""
    return {"checker_avifibc.avif": _save(checker()),
            "projector_avifibc.avif": _save(projector())}


def timing_file():
    """The 2048^2 timing file: `timing_image(2048)` at PIL's defaults,
    autotiled."""
    return _save(G.timing_image(2048), autotiling=True)


EDIT_SOURCES = ("avifibc_page.avif", "avifibc_bumps.avif", "avifibc_q20.avif",
                "avifibc_s0.avif", "avifibc_lossless_420.avif",
                "avifibc_444.avif", "avifibc_400.avif",
                "avifibc_tiles_11.avif", "avifibc_rgba.avif",
                "avifibc_size_133x197_420.avif")


def edit_cases(files):
    return G.edit_cases(files, EDIT_SOURCES, 30, SEED)


def write_ibc_files(out):
    """Write the files, the twins, the timing file and avifibc_decodes.npz
    into `out`."""
    from PIL import Image
    files = ibc_files()
    check_files(files)
    twins = twin_files()
    timing = timing_file()
    check_files({k: (v, {}) for k, v in twins.items()})
    check_files({"avifibc_2048.avif": (timing, {"tx_mode": 2})})
    every = {k: v for k, (v, _) in files.items()}
    every.update(twins)
    every["avifibc_2048.avif"] = timing
    for fn, data in every.items():
        with open(os.path.join(out, fn), "wb") as fh:
            fh.write(data)
    dec = G.pil_decodes(every)
    for fn in twins:
        Image.fromarray(dec[fn]).save(os.path.join(
            out, fn.replace(".avif", "_pil.png")))
    t = dec.pop("avifibc_2048.avif")
    if any(a is None for a in dec.values()):
        raise RuntimeError("PIL refuses a file of the slice")
    arrays = dict(dec)
    arrays["avifibc_2048.avif:sha256"] = np.frombuffer(
        hashlib.sha256(t.tobytes()).digest(), np.uint8)
    arrays["avifibc_2048.avif:corner"] = t[:128, :128]
    edits = edit_cases(every)
    ed = G.pil_decodes({f"{i:04d}": d for i, (_, d) in enumerate(edits)})
    arrays["edits:sha256"] = np.array([np.frombuffer(
        G.digest(ed[f"{i:04d}"]), np.uint8) for i in range(len(edits))])
    np.savez_compressed(os.path.join(out, "avifibc_decodes.npz"), **arrays)


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else G.OUT
    G.check_tables()
    write_ibc_files(out)


if __name__ == "__main__":
    main()
