"""Lossy AVIF files for `tests/assets_torch/` (slice 7e.8a.2a): AV1 key
frames at the quantisers, transform sizes and types and deblocking levels
that PIL 12.1.0's encoder (libavif 1.3.0 over aom 3.12.1) writes at speeds
5-10, and PIL's decode of each.

    python tools/gen_torch_avif_lossy.py [out_dir]

(`tools/gen_torch_avif.py` `write_avif_files` calls `write_lossy_files`,
after checking av1_codec.cpp's tables against the library.)

  * The files (`lossy_files`), every one asserted to carry the header
    fields it is meant to (`frame_fields`): `avifq_q*` at qualities 0-99
    (base_q_idx 255 .. 4, the four quantiser contexts), `avifq_s*` at
    speeds 5-10 (TX_MODE_SELECT up to 7, TX_MODE_LARGEST from 8), 4:4:4,
    4:2:2 and 4:0:0, odd sizes, tiles, 128x128 superblocks (a 512^2
    image, where aom picks them), reduced_tx_set, sharpness, a lossy alpha
    item, limited range, each intra tool switched off through `advanced=`,
    screen content without intra block copy, and at speed 3 with loop
    restoration switched off the 4:1 and 64-point transform sizes that the
    faster speeds never pick; `avif_later_*` that PIL decodes and the port
    sends to 7e.8a.2b (CDEF, quantiser matrices, loop restoration).
  * The twins' `texture_avifq.avif` (a seeded natural image) and
    `projector_avifq.avif` (the projector's RGBA, a lossy alpha item), at
    PIL's defaults, with PIL's decodes as PNGs; the timing file
    `avif_lossy_2048.avif` (2048^2, autotiled, PIL's defaults, under 1 MB).
  * `avifq_decodes.npz`: PIL's `convert("RGB")` of each file (decoded in a
    child process), the timing file's sha256 and 128 x 128 corner, and
    under "edits:sha256" the digest of PIL's outcome on each of
    `edit_cases` (seeded edits of `EDIT_SOURCES`: a third in the
    container, a third in the AV1 headers, a third in the tile data).

`write_lossy_files` then calls `tools/gen_torch_avif_ibc.py` for slice
7e.8a.2c.1's files with intra block copy.

Needs PIL and numpy. The output is deterministic.
"""
import hashlib
import importlib.util
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SEED = 30
_spec = importlib.util.spec_from_file_location(
    "vt_gen_torch_avif_for_lossy", os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "gen_torch_avif.py"))
G = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(G)
_save = G._save


def _scene(g, h, w):
    """A smooth field under rectangles of stripes, noise and waves."""
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    img = np.zeros((h, w, 3)) + g.uniform(60, 200, 3)
    img += (xx / w * 60)[..., None] * g.uniform(-1, 1, 3)
    img += (yy / h * 60)[..., None] * g.uniform(-1, 1, 3)
    for _ in range(12):
        y0, x0 = g.integers(0, max(h - 8, 1)), g.integers(0, max(w - 8, 1))
        sl = (slice(y0, y0 + g.integers(4, max(5, h // 3))),
              slice(x0, x0 + g.integers(4, max(5, w // 3))))
        kind, f = g.integers(4), g.uniform(0.3, 1.5)
        if kind == 0:
            pat = np.sin(yy[sl] * f) * 50
        elif kind == 1:
            pat = np.sin(xx[sl] * f) * 50
        elif kind == 2:
            pat = g.normal(0, 25, yy[sl].shape)
        else:
            pat = np.sin((xx[sl] + yy[sl]) * f / 2) * 40
        img[sl] += pat[..., None] * g.uniform(0.3, 1, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _smooth(g, n):
    """Low-frequency waves: 64-point transforms."""
    yy, xx = np.mgrid[0:n, 0:n].astype(float)
    img = np.stack([128 + 60 * np.sin(xx / 40 + yy / 70),
                    128 + 50 * np.cos(yy / 35),
                    128 + 40 * np.sin((xx - yy) / 50)], -1)
    return np.clip(img + g.normal(0, 1.5, img.shape), 0, 255).astype(
        np.uint8)


def _bars(g, n):
    """Bars 4 samples wide across a flat field: the 4:1 blocks."""
    img = np.full((n, n, 3), 100.0)
    for k in range(n // 6):
        at = g.integers(0, n - 4)
        if k % 2:
            img[at:at + 4] += g.uniform(-60, 60, 3)
        else:
            img[:, at:at + 4] += g.uniform(-60, 60, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def images():
    """The source images, from SEED."""
    g = np.random.default_rng(SEED)
    out = {"scene": _scene(g, 64, 96), "photo": _scene(g, 80, 112),
           "tiles": _scene(g, 128, 192), "smooth": _smooth(g, 128),
           "bars": _bars(g, 256), "sb128": _smooth(g, 512),
           "alpha": np.dstack([_scene(g, 48, 80), _scene(g, 48, 80)[..., 1]])}
    cols = g.integers(0, 256, (6, 3)).astype(np.uint8)
    out["screen"] = cols[g.integers(0, 6, (16, 24)).repeat(4, 0).repeat(
        4, 1)]
    out["g"] = g
    return out


_TOOLS = {"nofilterintra": {"enable-filter-intra": "0"},
          "nosmooth": {"enable-smooth-intra": "0"},
          "nopaeth": {"enable-paeth-intra": "0"},
          "nocfl": {"enable-cfl-intra": "0"},
          "noedge": {"enable-intra-edge-filter": "0"},
          "noangle": {"enable-angle-delta": "0"}}
_SLOW = {"enable-restoration": "0", "enable-intrabc": "0"}
_SS = {"444": "4:4:4", "422": "4:2:2", "420": "4:2:0", "400": "4:0:0"}
# (quality, base_q_idx) as aom maps them
QUALITIES = ((0, 255), (1, 249), (20, 200), (40, 152), (60, 100), (75, 64),
             (90, 24), (99, 4))


def lossy_files(im=None):
    """name -> (bytes, {header field: value it must carry}) of every file
    of the slice but the twins and the timing file."""
    im = im or images()
    g = im["g"]
    out = {}
    for q, qidx in QUALITIES:
        out[f"avifq_q{q}.avif"] = (_save(im["scene"], quality=q),
                                   {"base_q": qidx, "tx_mode": 2})
    for sp in (5, 6, 7, 8, 9, 10):
        out[f"avifq_s{sp}.avif"] = (_save(im["photo"], speed=sp),
                                    {"tx_mode": 2 if sp < 9 else 1})
    for ss, sub in _SS.items():
        for sp in (6, 9):
            out[f"avifq_{ss}_s{sp}.avif"] = (
                _save(im["photo"], quality=50, speed=sp, subsampling=sub),
                {"mono": int(ss == "400"), "tx_mode": 2 if sp < 9 else 1})
    for i, (h, w) in enumerate(((1, 1), (3, 5), (65, 1), (7, 130),
                                (37, 53))):
        a = _scene(g, h, w)
        for ss in (("420", "422", "444", "400") if (h, w) == (37, 53)
                   else (("420", "422", "444", "400")[i % 4],)):
            out[f"avifq_size_{h}x{w}_{ss}.avif"] = (
                _save(a, quality=60, subsampling=_SS[ss]), {})
    # tile_rows / tile_cols are log2; 192 samples are three superblocks
    for r, c, tiles in ((1, 1, (2, 2)), (0, 2, (3, 1))):
        out[f"avifq_tiles_{r}{c}.avif"] = (
            _save(im["tiles"], quality=60, tile_rows=r, tile_cols=c,
                  advanced={"enable-intrabc": "0"}), {"tiles": tiles})
    out["avifq_sb128.avif"] = (_save(im["sb128"]), {"sb128": 1})
    out["avifq_rts.avif"] = (_save(im["photo"], advanced={
        "reduced-tx-type-set": "1"}), {"reduced_tx_set": 1})
    for sh, q in ((4, 75), (7, 30)):
        out[f"avifq_sharp{sh}.avif"] = (
            _save(im["photo"], quality=q, advanced={"sharpness": str(sh)}),
            {"sharpness": sh})
    out["avifq_alpha.avif"] = (_save(im["alpha"]), {"alpha_base_q": 64})
    out["avifq_alpha_444.avif"] = (
        _save(im["alpha"], quality=40, subsampling="4:4:4"), {})
    out["avifq_limited.avif"] = (_save(im["scene"], range="limited"),
                                 {"full_range": 0})
    for tool, adv in _TOOLS.items():
        out[f"avifq_{tool}.avif"] = (_save(im["photo"], quality=60,
                                           advanced=adv), {})
    out["avifq_screen.avif"] = (
        _save(im["screen"], quality=60, advanced={
            "tune-content": "screen", "enable-intrabc": "0"}),
        {"allow_sc": 1})
    out["avifq_smooth.avif"] = (_save(im["smooth"], quality=40, speed=5),
                                {})
    bars_t = im["bars"].transpose(1, 0, 2).copy()
    for name, a, ss, sp in (("bars", im["bars"], "420", 0),
                            ("bars_t", bars_t, "420", 0),
                            ("bars", im["bars"], "444", 2),
                            ("bars_t", bars_t, "444", 2)):
        out[f"avifq_{name}_{ss}_s{sp}.avif"] = (
            _save(a, quality=80, speed=sp, subsampling=_SS[ss],
                  advanced=_SLOW), {})
    # PIL decodes these; the port sends them to 7e.8a.2b
    out["avif_later_cdef.avif"] = (
        _save(im["scene"], advanced={"enable-cdef": "1"}), None)
    out["avif_later_qm.avif"] = (
        _save(im["scene"], advanced={"enable-qm": "1"}), None)
    out["avif_later_lr.avif"] = (_save(im["scene"], speed=0), None)
    return out


LATER = {"avif_later_cdef.avif": "7e.8a.2b", "avif_later_qm.avif": "7e.8a.2b",
         "avif_later_lr.avif": "7e.8a.2b"}


def frame_fields(data):
    """The header fields of a file's colour frame (and its alpha frame's
    base_q_idx and allow_intrabc) as the port reads them."""
    sys.path.insert(0, ROOT)
    from vision_tpu_torch.scene import avif
    meta = avif._parse(data)
    out = {}
    for it in meta.items.values():
        if it.id != meta.primary and it.aux_for != meta.primary:
            continue
        item = avif._item_data(data, meta, it)
        seq = hdr = None
        for typ, tid, sid, s, e in avif._obus(item):
            if typ == avif.OBU_SEQUENCE_HEADER:
                seq = avif._sequence_header(avif._Bits(item, s, e))
            elif typ in (avif.OBU_FRAME, avif.OBU_FRAME_HEADER) and \
                    hdr is None:
                hdr = avif._frame_header(avif._Bits(item, s, e), seq, tid,
                                         sid)
        if it.id != meta.primary:
            out["alpha_base_q"] = hdr["base_q"]
            out["alpha_intrabc"] = hdr["allow_intrabc"]
            continue
        out.update(base_q=hdr["base_q"], tx_mode=hdr["tx_mode"],
                   allow_intrabc=hdr["allow_intrabc"],
                   reduced_tx_set=hdr["reduced_tx_set"],
                   sharpness=hdr["lf"][4], mono=seq["mono"],
                   sb128=seq["sb128"], full_range=seq["full_range"],
                   allow_sc=hdr["allow_sc"], lossless=hdr["lossless"],
                   cdef=seq["enable_cdef"], lr=seq["enable_restoration"],
                   tiles=(len(hdr["col_starts"]) - 1,
                          len(hdr["row_starts"]) - 1))
    return out


def check_fields(files):
    """Each file carries the fields it is meant to: lossy, no intra block
    copy (the port would raise), no CDEF or loop restoration in the
    sequence header, and its own."""
    for fn, (data, want) in files.items():
        if want is None:
            continue
        got = frame_fields(data)
        for k, v in dict(want, lossless=0, cdef=0, lr=0).items():
            if got[k] != v:
                raise RuntimeError(f"{fn}: {k} is {got[k]}, not {v}")


def twin_files(projector):
    """The twins' files at PIL's defaults: a seeded natural texture (aom
    codes the checker as screen content, with intra block copy) and the
    projector's RGBA."""
    g = np.random.default_rng(SEED + 1)
    return {"texture_avifq.avif": _save(_scene(g, 64, 64)),
            "projector_avifq.avif": _save(projector)}


def timing_file():
    """The 2048^2 timing file: `_scene` under a grain (about 0.5 MB)."""
    g = np.random.default_rng(SEED + 2)
    img = _scene(g, 2048, 2048) + g.normal(0, 6, (2048, 2048, 3))
    return _save(np.clip(img, 0, 255).astype(np.uint8), autotiling=True)


EDIT_SOURCES = ("avifq_q20.avif", "avifq_q75.avif", "avifq_444_s6.avif",
                "avifq_422_s9.avif", "avifq_400_s6.avif",
                "avifq_alpha.avif", "avifq_tiles_11.avif",
                "avifq_size_37x53_420.avif", "avifq_s9.avif",
                "avifq_bars_420_s0.avif")


def edit_cases(files):
    return G.edit_cases(files, EDIT_SOURCES, 30, SEED)


def write_lossy_files(out, projector):
    """Write the files, the twins, the timing file and avifq_decodes.npz
    into `out`."""
    from PIL import Image
    files = lossy_files()
    check_fields(files)
    twins = twin_files(projector)
    check_fields({k: (v, {}) for k, v in twins.items()})
    timing = timing_file()
    if len(timing) >= 1 << 20:
        raise RuntimeError("the timing file is not under 1 MB")
    check_fields({"avif_lossy_2048.avif": (timing, {})})
    every = {k: v for k, (v, _) in files.items()}
    every.update(twins)
    every["avif_lossy_2048.avif"] = timing
    for fn, data in every.items():
        with open(os.path.join(out, fn), "wb") as fh:
            fh.write(data)
    dec = G.pil_decodes(every)
    for fn in twins:
        Image.fromarray(dec[fn]).save(os.path.join(
            out, fn.replace(".avif", "_pil.png")))
    t = dec.pop("avif_lossy_2048.avif")
    if any(a is None for a in dec.values()):
        raise RuntimeError("PIL refuses a file of the slice")
    arrays = dict(dec)
    arrays["avif_lossy_2048.avif:sha256"] = np.frombuffer(
        hashlib.sha256(t.tobytes()).digest(), np.uint8)
    arrays["avif_lossy_2048.avif:corner"] = t[:128, :128]
    edits = edit_cases(every)
    ed = G.pil_decodes({f"{i:04d}": d for i, (_, d) in enumerate(edits)})
    arrays["edits:sha256"] = np.array([np.frombuffer(
        G.digest(ed[f"{i:04d}"]), np.uint8) for i in range(len(edits))])
    np.savez_compressed(os.path.join(out, "avifq_decodes.npz"), **arrays)
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_avif_ibc", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_avif_ibc.py"))
    ibc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ibc)
    ibc.write_ibc_files(out)


def main():
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_assets_avifq", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_assets.py"))
    ga = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ga)
    out = sys.argv[1] if len(sys.argv) > 1 else G.OUT
    G.check_tables()
    write_lossy_files(out, ga.projector())


if __name__ == "__main__":
    main()
