"""SGILog TIFF files (LogL and LogLuv, compressions 34676 / 34677) for
slice 7e.4b on OpenCV's route, in `tests/assets_torch/`, under .hdr / .exr
names, with `sgilog_decodes.npz`: what the JAX package's loader gets for
each through the pip cv2 (`cv2.imread(p, IMREAD_ANYCOLOR |
IMREAD_ANYDEPTH)`, float32 [H, W, 3] RGB, no /255); and libtiff's uv
table (uvcode.h's `uv_row`) as `vision_tpu_torch/data/sgilog_uv.npz`.

    python tools/gen_torch_sgilog.py [out_dir]

(`tools/gen_torch_assets.py` calls it after writing the scenes' images,
which it reads.) The files are laid out here: `sgilog_tiff` writes the
directory (`gen_torch_assets.tiff_bytes`), `rle_rows` libtiff's SGILog
run-length code (each byte plane of each row on its own: a byte >= 128 is
a run of `byte - 126` copies of the next byte, a byte below 128 a count of
literal bytes after it), with both runs and literals.

  * `sl_*.exr` / `sl_*.hdr`: LogLuv32 (the sign bit, L = 0, runs and
    literals across 127 / 128 / 129 bytes, 1 to H rows a strip, tiles,
    widths 1-9, 61 and 130), LogLuv24 (every one of the 16,384 uv codes at
    a fixed L, and random pixels), LogL16 (read by OpenCV as libtiff's
    8-bit grey), orientation;
  * the twins: `sky_a_logluv.exr` (sky_a as LogLuv32, strips of 5 rows)
    and `sky_a_logluv_ref.exr` (the pip cv2's decode of it, a FLOAT
    OpenEXR file: `tests/torch_scenes.py` `cbox_sky_logluv` / `_ref`);
    `projector_luv24.hdr` (the projector's RGB at a scale its floats need,
    as LogLuv24) and `projector_luv24_pfm.hdr` (the pip cv2's decode as a
    PFM: `env_sphere_luv24` / `_ref`);
  * the timing file `luv_2048.exr` (`logluv_timing`: a 2048^2 LogLuv32
    file of 128 strips built from a seed; the .npz keeps its decode's
    sha256 and 128 x 128 corner).

The uv table is recovered from the pip cv2's decodes of LogLuv24 files
that hold all 16,384 codes at a fixed L (`recover_uv_table`): each code's
u' and v' from the decoded XYZ, its row from v', the row's first code and
count from the codes it holds, its start u rounded to uvcode.h's six
decimals; a second pass decodes every code through the port's model and
holds it bit for bit against the pip cv2. Needs the pip cv2, PIL and
numpy. The output is deterministic: running it again writes the same
bytes.
"""
import hashlib
import importlib.util
import os
import struct
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "assets_torch")
UV_TABLE = os.path.join(ROOT, "vision_tpu_torch", "data", "sgilog_uv.npz")
TIMING_SEED = 23
CORNER = 128
LOGL, LOGLUV = 32844, 32845
SGILOG, SGILOG24 = 34676, 34677


def _assets_module():
    """`tools/gen_torch_assets.py` (its TIFF writer and images), by path."""
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_assets_sgilog", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_assets.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the SGILog run-length code
# ---------------------------------------------------------------------------

def _within(counts):
    """For groups of `counts` items in a row: each item's group and its
    place in the group."""
    group = np.repeat(np.arange(counts.size), counts)
    return group, np.arange(group.size) - np.repeat(np.cumsum(counts) - counts,
                                                    counts)


def rle_rows(rows, max_run=129, max_lit=127, min_run=4):
    """libtiff's SGILog byte code of rows [m, n] uint8, each row on its
    own, concatenated: a run of `min_run` or more equal bytes (at most
    `max_run`, <= 129) as two bytes (126 + length, the byte), the bytes
    between runs as literals of at most `max_lit` (<= 127) bytes, each
    after a count byte. Vectorised: a 2048^2 LogLuv image codes in about
    two seconds."""
    rows = np.ascontiguousarray(rows, np.uint8)
    n = rows.shape[1]
    flat = rows.ravel()
    row_start = np.arange(flat.size) % n == 0
    start = row_start.copy()
    start[1:] |= flat[1:] != flat[:-1]
    starts = np.flatnonzero(start)
    lengths = np.diff(np.append(starts, flat.size))
    # each equal run cut into pieces of max_run, a remainder of min_run or
    # more a run piece of its own, a shorter one literal bytes
    full = lengths // max_run
    rem = lengths % max_run
    run_of, k = _within(full + (rem >= min_run))
    run_pos = starts[run_of] + k * max_run
    run_len = np.where(k < full[run_of], max_run, rem[run_of])
    covered = np.zeros(flat.size + 1, np.int64)
    covered[run_pos] += 1
    covered[run_pos + run_len] -= 1
    lit = np.cumsum(covered[:-1]) == 0
    # literal stretches, ended by a run or a row's end, cut into chunks of
    # max_lit
    lstarts = np.flatnonzero(lit & (row_start | ~np.concatenate(
        [[False], lit[:-1]])))
    ends = np.flatnonzero(np.append(~lit | row_start, True))
    llen = ends[np.searchsorted(ends, lstarts, side="right")] - lstarts
    chunk_of, kk = _within(-(-llen // max_lit))
    lit_pos = lstarts[chunk_of] + kk * max_lit
    lit_len = np.minimum(llen[chunk_of] - kk * max_lit, max_lit)
    # the tokens in stream order
    order = np.argsort(np.concatenate([run_pos, lit_pos]), kind="stable")
    pos = np.concatenate([run_pos, lit_pos])[order]
    ln = np.concatenate([run_len, lit_len])[order]
    is_run = (np.arange(order.size) < run_pos.size)[order]
    size = np.where(is_run, 2, ln + 1)
    off = np.cumsum(size) - size
    out = np.zeros(int(size.sum()), np.uint8)
    out[off] = np.where(is_run, 126 + ln, ln)
    out[off[is_run] + 1] = flat[pos[is_run]]
    lit_tok = np.flatnonzero(~is_run)
    tok, within = _within(ln[lit_tok])
    tok = lit_tok[tok]
    out[off[tok] + 1 + within] = flat[pos[tok] + within]
    return out.tobytes()


def luv32_planes(p):
    """LogLuv32 pixels uint32 [r, w] -> the byte planes libtiff codes,
    [4 r, w]: each row's bits 31-24, 23-16, 15-8, 7-0 in turn."""
    p = np.asarray(p, np.uint32)
    r, w = p.shape
    sh = np.array([24, 16, 8, 0], np.uint32)[None, :, None]
    return ((p[:, None, :] >> sh) & 0xFF).astype(np.uint8).reshape(4 * r, w)


def l16_planes(p):
    """LogL16 pixels uint16 [r, w] -> [2 r, w]: high bytes, then low."""
    p = np.asarray(p, np.uint16)
    r, w = p.shape
    return np.stack([p >> 8, p & 0xFF], 1).astype(np.uint8).reshape(2 * r, w)


def luv24_bytes(p):
    """LogLuv24 pixels [r, w] (24-bit codes) -> 3 bytes each, big-endian."""
    p = np.asarray(p, np.uint32)
    return np.stack([p >> 16, p >> 8, p], -1).astype(np.uint8).tobytes()


def sgilog_chunks(p, kind, rows_per_strip=None, tile=None, **rle):
    """The coded strips (or tiles, edge tiles padded with zeros) of pixels
    p [h, w]: kind "luv32" / "l16" run-length coded a row at a time,
    "luv24" raw."""
    p = np.asarray(p)
    h, w = p.shape
    tw, th = tile if tile else (w, rows_per_strip or h)
    out = []
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            v = p[y0:y0 + th, x0:x0 + tw]
            if tile:
                pad = np.zeros((th, tw), v.dtype)
                pad[:v.shape[0], :v.shape[1]] = v
                v = pad
            if kind == "luv24":
                out.append(luv24_bytes(v))
            else:
                planes = luv32_planes(v) if kind == "luv32" else l16_planes(v)
                out.append(rle_rows(planes, **rle))
    return out


def sgilog_tiff(p, kind, rows_per_strip=None, tile=None, bits=None,
                spp=None, photometric=None, compression=None, tags=None,
                drop=(), chunks=None, ga=None, **rle):
    """A little-endian SGILog TIFF of pixels p [h, w] (uint32 LogLuv32 /
    24-bit LogLuv24 codes, or uint16 LogL16): compression 34676 (34677 for
    "luv24"), photometric LogLuv (LogL for "l16"), BitsPerSample 16 and
    three samples (one for LogL) unless given; `chunks` replace the coded
    strips; `tags` {tag: (type, values)} added or replacing the writer's;
    the tags in `drop` left out."""
    ga = ga or _assets_module()
    p = np.asarray(p)
    h, w = p.shape
    if spp is None:
        spp = 1 if kind == "l16" else 3
    if chunks is None:
        chunks = sgilog_chunks(p, kind, rows_per_strip, tile, **rle)
    data = ga.tiff_bytes(
        np.zeros((h, w, spp), np.int64), bits or 16,
        photometric or (LOGL if kind == "l16" else LOGLUV),
        compression or (SGILOG24 if kind == "luv24" else SGILOG),
        rows_per_strip=rows_per_strip, tile=tile, chunks=chunks, tags=tags)
    return _without_tags(data, drop) if drop else data


def _without_tags(data, drop):
    """A little-endian classic TIFF with the entries of the tags in `drop`
    left out of its directory: the rest written again as a new directory
    at the file's end, the header pointing at it (the values stay where
    they are)."""
    off, = struct.unpack("<I", data[4:8])
    n, = struct.unpack("<H", data[off:off + 2])
    keep = [data[off + 2 + 12 * k:off + 14 + 12 * k] for k in range(n)]
    keep = [e for e in keep if struct.unpack("<H", e[:2])[0] not in drop]
    body = bytearray(data) + b"\0" * (len(data) % 2)
    at = len(body)
    body += struct.pack("<H", len(keep)) + b"".join(keep) + bytes(4)
    body[4:8] = struct.pack("<I", at)
    return bytes(body)


# ---------------------------------------------------------------------------
# uvcode.h's table, recovered from the pip cv2's decodes
# ---------------------------------------------------------------------------

UV_L10 = 768            # the LogL10 code of the uv sweep: Y = 2^(1 / 128)


def uv_sweep(l10=UV_L10):
    """LogLuv24 codes of every uv code 0-16383 at LogL10 code l10, as a
    128 x 128 image in code order."""
    return ((np.uint32(l10) << 14) | np.arange(1 << 14, dtype=np.uint32)) \
        .reshape(128, 128)


def _cv_rgb(data, ga):
    """What the JAX package's loader gets through the pip cv2 for `data`
    under a .exr name (`gen_torch_cvtiff._load`), via a temporary file."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "t.exr")
        with open(p, "wb") as f:
            f.write(data)
        return ga._cvtiff_module()._load(p)


def recover_uv_table(ga=None):
    """uvcode.h's `uv_row` (ustart, nus, ncum) from the pip cv2's decode of
    `uv_sweep`: XYZ from OpenCV's BGR by the inverse of its XYZ2BGR matrix
    (float64), each code's u' = 4X / (X + 15Y + 3Z) and v' = 9Y / (X + 15Y +
    3Z), its row vi from v' = UV_VSTART + (vi + .5) UV_SQSIZ, each row's
    first code and count from the codes whose row it is (the neutral codes
    past UV_NDIVS left out), its ustart the mean of u' - (ui + .5) UV_SQSIZ
    rounded to six decimals."""
    sys.path.insert(0, ROOT)
    from vision_tpu_torch.scene import cvtiff, sgilog
    ga = ga or _assets_module()
    rgb = _cv_rgb(sgilog_tiff(uv_sweep(), "luv24", ga=ga), ga)
    rgb = rgb.reshape(-1, 3).astype(np.float64)
    xyz = rgb @ np.linalg.inv(cvtiff._XYZ2RGB.astype(np.float64)).T
    den = xyz[:, 0] + 15 * xyz[:, 1] + 3 * xyz[:, 2]
    u, v = 4 * xyz[:, 0] / den, 9 * xyz[:, 1] / den
    codes = np.arange(sgilog.UV_NDIVS)
    vi = np.rint((v[codes] - sgilog.UV_VSTART) / sgilog.UV_SQSIZ - 0.5) \
        .astype(np.int64)
    n_rows = int(vi.max()) + 1
    assert (np.diff(vi) >= 0).all() and vi[0] == 0, "rows in code order"
    ncum = np.searchsorted(vi, np.arange(n_rows))
    nus = np.diff(np.append(ncum, sgilog.UV_NDIVS))
    ui = codes - ncum[vi]
    ustart = np.array([np.mean(u[codes][vi == r] - (ui[vi == r] + 0.5)
                               * sgilog.UV_SQSIZ) for r in range(n_rows)])
    return np.round(ustart, 6), nus, ncum


def check_uv_table(ustart, nus, ncum, ga=None):
    """Every uv code, at two L codes, through the port's model against the
    pip cv2's decode, bit for bit: the rows whose codes differ (none)."""
    from vision_tpu_torch.scene import cvtiff, sgilog
    ga = ga or _assets_module()
    sgilog._tables["uv"] = (np.float32(ustart), nus.astype(np.int16),
                            ncum.astype(np.int16))
    bad = set()
    for l10 in (UV_L10, 301):
        codes = uv_sweep(l10)
        want = _cv_rgb(sgilog_tiff(codes, "luv24", ga=ga), ga)
        got = cvtiff._xyz2bgr(sgilog.logluv24_to_xyz(codes))[..., ::-1]
        diff = (want.view(np.uint32) != got.view(np.uint32)).any(-1).ravel()
        c = np.flatnonzero(diff)
        bad |= set(np.searchsorted(ncum, c[c < sgilog.UV_NDIVS],
                                   side="right") - 1)
        assert not diff[sgilog.UV_NDIVS:].any(), "the neutral codes"
    sgilog._tables.pop("uv")
    return sorted(int(r) for r in bad)


def write_uv_table(path=UV_TABLE, ga=None):
    """Recover uvcode.h's table, prove it on every code (a row that fails
    tries its ustart one millionth either side) and write it."""
    ustart, nus, ncum = recover_uv_table(ga)
    for r in check_uv_table(ustart, nus, ncum, ga):
        for step in (1e-6, -1e-6):
            trial = ustart.copy()
            trial[r] = round(trial[r] + step, 6)
            if r not in check_uv_table(trial, nus, ncum, ga):
                ustart = trial
                break
    assert not check_uv_table(ustart, nus, ncum, ga), "the uv table"
    np.savez_compressed(path, ustart=np.float32(ustart),
                        nus=nus.astype(np.int16), ncum=ncum.astype(np.int16))


# ---------------------------------------------------------------------------
# the files
# ---------------------------------------------------------------------------

def luv32_from_rgb(rgb):
    """float RGB [h, w, 3] -> LogLuv32 codes (libtiff's LogLuv32fromXYZ
    without dithering): XYZ by the inverse of OpenCV's XYZ2BGR matrix, L
    as 256 (log2 Y + 64) truncated (sign bit for Y < 0), u' and v' as 410
    u' and 410 v' truncated to 0-255."""
    sys.path.insert(0, ROOT)
    from vision_tpu_torch.scene import cvtiff
    xyz = np.asarray(rgb, np.float64) @ np.linalg.inv(
        cvtiff._XYZ2RGB.astype(np.float64)).T
    y = xyz[..., 1]
    with np.errstate(all="ignore"):
        le = np.clip(np.trunc(256 * (np.log2(np.abs(y)) + 64)), 0, 0x7FFF)
        le = np.where(np.abs(y) > 5.4136769e-20, le, 0).astype(np.uint32)
        den = xyz[..., 0] + 15 * y + 3 * xyz[..., 2]
        ok = den > 0
        u = np.where(ok, 4 * xyz[..., 0] / np.where(ok, den, 1), 0.2105)
        v = np.where(ok, 9 * y / np.where(ok, den, 1), 0.4737)
    ub = np.clip(np.trunc(410 * u), 0, 255).astype(np.uint32)
    vb = np.clip(np.trunc(410 * v), 0, 255).astype(np.uint32)
    return (np.where(y < 0, 0x8000, 0) | le) << 16 | ub << 8 | vb


def luv24_from_rgb(rgb):
    """float RGB [h, w, 3] -> LogLuv24 codes (libtiff's LogLuv24fromXYZ
    without dithering): L as 64 (log2 Y + 12) truncated (0 below
    0.00024283, 1023 from 15.742), uv by uvcode.h's table (uv_encode),
    the neutral point's code where u', v' lie outside it."""
    sys.path.insert(0, ROOT)
    from vision_tpu_torch.scene import cvtiff, sgilog
    xyz = np.asarray(rgb, np.float64) @ np.linalg.inv(
        cvtiff._XYZ2RGB.astype(np.float64)).T
    y = xyz[..., 1]
    with np.errstate(all="ignore"):
        l10 = np.trunc(64 * (np.log2(np.maximum(y, 1e-30)) + 12))
    l10 = np.where(y >= 15.742, 0x3FF, np.where(y <= 0.00024283, 0, l10))
    den = xyz[..., 0] + 15 * y + 3 * xyz[..., 2]
    ok = den > 0
    u = np.where(ok, 4 * xyz[..., 0] / np.where(ok, den, 1), sgilog.U_NEU)
    v = np.where(ok, 9 * y / np.where(ok, den, 1), sgilog.V_NEU)

    def encode(u, v):
        ustart, nus, ncum = sgilog.uv_table()
        vi = np.trunc((v - sgilog.UV_VSTART) / sgilog.UV_SQSIZ)
        good = (vi >= 0) & (vi < len(ncum))
        vi = np.clip(vi, 0, len(ncum) - 1).astype(np.int64)
        ui = np.trunc((u - ustart[vi]) / sgilog.UV_SQSIZ)
        good &= (ui >= 0) & (ui < nus[vi])
        return np.where(good, ncum[vi] + np.clip(ui, 0, None), -1)

    c = encode(u, v)
    c = np.where(c < 0, encode(np.float64(sgilog.U_NEU),
                               np.float64(sgilog.V_NEU)), c)
    return (l10.astype(np.uint32) << 14) | c.astype(np.uint32)


def _random_luv32(g, h, w):
    """Random LogLuv32 codes with the sign bit, L = 0 and row runs."""
    p = g.integers(0, 1 << 32, (h, w), dtype=np.uint64).astype(np.uint32)
    p[g.random((h, w)) < 0.1] &= np.uint32(0x0000FFFF)        # L = 0
    p[g.random((h, w)) < 0.5] &= np.uint32(0x7FFFFFFF)        # sign clear
    for r in range(h):
        a = int(g.integers(0, w))
        p[r, a:a + int(g.integers(4, 60))] = p[r, a]
    return p


def sgilog_files(ga):
    """name -> bytes: the SGILog files of the module docstring (the twins
    and the timing file excepted). `sl_bad_*` are the ones the pip cv2
    refuses."""
    g = np.random.default_rng(2300)
    t = sgilog_tiff
    f = {}
    f["sl_luv32_strips.exr"] = t(_random_luv32(g, 17, 37), "luv32",
                                 rows_per_strip=4, ga=ga)
    f["sl_luv32_rows1.hdr"] = t(_random_luv32(g, 9, 61), "luv32",
                                rows_per_strip=1, ga=ga)
    # runs of 127 to 130 equal bytes and literals of 127 bytes and more
    runs = _random_luv32(g, 6, 130)
    for r, n in enumerate((127, 128, 129, 130)):
        runs[r, :n] = runs[r, 0]
    f["sl_luv32_runs.exr"] = t(runs, "luv32", ga=ga)
    f["sl_luv32_short.exr"] = t(runs, "luv32", rows_per_strip=4, ga=ga,
                                max_run=5, max_lit=1)
    for w in (1, 5, 9):
        f[f"sl_luv32_w{w}.hdr"] = t(_random_luv32(g, 7, w), "luv32",
                                    rows_per_strip=3, ga=ga)
    f["sl_luv32_tiles.exr"] = t(_random_luv32(g, 20, 35), "luv32",
                                tile=(16, 16), ga=ga)
    f["sl_luv32_orient6.hdr"] = t(_random_luv32(g, 12, 12), "luv32",
                                  rows_per_strip=5, ga=ga,
                                  tags={274: (3, [6])})
    f["sl_luv32_nostrips.exr"] = t(_random_luv32(g, 10, 14), "luv32", ga=ga,
                                   drop=(278,))
    f["sl_luv24_uv.exr"] = t(uv_sweep(), "luv24", rows_per_strip=16, ga=ga)
    p = g.integers(0, 1 << 24, (11, 29)).astype(np.uint32)
    p[0, :5] &= 0x3FFF                                    # L = 0
    p[1, :5] = (p[1, :5] & 0xFFC000) | 16300              # neutral codes
    f["sl_luv24_rand.hdr"] = t(p, "luv24", rows_per_strip=4, ga=ga)
    p16 = g.integers(0, 1 << 16, (13, 27)).astype(np.uint16)
    p16[:, 4:20] = p16[:, 4:5]
    f["sl_logl_strips.exr"] = t(p16, "l16", rows_per_strip=3, ga=ga)
    f["sl_logl_tiles.hdr"] = t(p16, "l16", tile=(16, 16), ga=ga)
    f["sl_logl_i8.exr"] = t(p16, "l16", rows_per_strip=5, ga=ga,
                            tags={339: (3, [2])})
    # a LogL strip cut short: libtiff's RGBA reader keeps the rows before
    # the error and zeros after
    ch = sgilog_chunks(p16, "l16", rows_per_strip=5)
    ch[1] = ch[1][:len(ch[1]) // 2]
    f["sl_logl_cut.exr"] = t(p16, "l16", rows_per_strip=5, chunks=ch, ga=ga)
    # refused: a LogLuv strip cut short, planar LogLuv, LogL of SGILog24 or
    # of three samples, LogLuv of other than SGILog compression
    luv = _random_luv32(g, 8, 10)
    ch = sgilog_chunks(luv, "luv32", rows_per_strip=4)
    ch[1] = ch[1][:len(ch[1]) - 3]
    f["sl_bad_cut.exr"] = t(luv, "luv32", rows_per_strip=4, chunks=ch, ga=ga)
    f["sl_bad_planar.exr"] = t(luv, "luv32", rows_per_strip=4, ga=ga,
                               tags={284: (3, [2])})
    f["sl_bad_logl24.exr"] = t(p16, "l16", compression=SGILOG24, ga=ga)
    f["sl_bad_logl_rgb.exr"] = t(p16, "l16", spp=3, ga=ga)
    f["sl_bad_luv_lzw.exr"] = t(luv, "luv32", compression=5, ga=ga)
    return f


def logluv_timing(n=2048, strips=128, seed=TIMING_SEED):
    """`luv_2048.exr`: an n x n LogLuv32 file of `strips` strips, its codes
    made from integers alone (the same bytes on any machine): L a smooth
    ramp in x and y, u and v slow bands, each with a little seeded noise;
    so the high byte planes code as runs and the low ones as literals."""
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n].astype(np.int64)
    le = 14000 + (x * 3 + y * 2) % 4000 + g.integers(0, 4, (n, n))
    ub = 70 + (x // 64) % 30 + g.integers(0, 2, (n, n))
    vb = 150 + (y // 64) % 25 + g.integers(0, 2, (n, n))
    p = (le << 16 | ub << 8 | vb).astype(np.uint32)
    return sgilog_tiff(p, "luv32", rows_per_strip=n // strips)


def write_sgilog_files(out=OUT):
    """The uv table, every file of the module docstring and
    `sgilog_decodes.npz` (the refused files have no entry)."""
    ga = _assets_module()
    cv = ga._cvtiff_module()          # the pip cv2's loader, the PFM writer
    write_uv_table(ga=ga)
    sys.path.insert(0, ROOT)
    from vision_tpu_torch.scene import imageio   # its FLOAT OpenEXR writer
    files = sgilog_files(ga)
    files["sky_a_logluv.exr"] = sgilog_tiff(luv32_from_rgb(ga.sky("a")),
                                            "luv32", rows_per_strip=5, ga=ga)
    proj = ga.projector()[..., :3].astype(np.float64) / 255
    files["projector_luv24.hdr"] = sgilog_tiff(luv24_from_rgb(proj), "luv24",
                                               rows_per_strip=8, ga=ga)
    dec = {}
    for fn, data in files.items():
        p = os.path.join(out, fn)
        with open(p, "wb") as f:
            f.write(data)
        if fn.startswith("sl_bad_"):
            import cv2
            assert cv2.imread(p, cv2.IMREAD_ANYCOLOR |
                              cv2.IMREAD_ANYDEPTH) is None, fn
        else:
            dec[fn] = cv._load(p)
    imageio.write_exr(dec["sky_a_logluv.exr"],
                      os.path.join(out, "sky_a_logluv_ref.exr"))
    with open(os.path.join(out, "projector_luv24_pfm.hdr"), "wb") as f:
        f.write(cv._pfm(dec["projector_luv24.hdr"]))
    p = os.path.join(out, "luv_2048.exr")
    with open(p, "wb") as f:
        f.write(logluv_timing())
    full = cv._load(p)
    os.remove(p)
    dec["luv_2048.exr:sha256"] = np.frombuffer(
        hashlib.sha256(full.tobytes()).digest(), np.uint8)
    dec["luv_2048.exr:corner"] = full[:CORNER, :CORNER]
    np.savez_compressed(os.path.join(out, "sgilog_decodes.npz"), **dec)


if __name__ == "__main__":
    write_sgilog_files(sys.argv[1] if len(sys.argv) > 1 else OUT)
