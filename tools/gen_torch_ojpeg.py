"""Old-style JPEG TIFF files (compression 6) for slice 7e.4b on PIL's
route, in `tests/assets_torch/`, with `ojpeg_decodes.npz`: what PIL
12.1.0 (libtiff 4.7.1's OJPEG codec and RGBA reader) decodes from each
(`Image.open(p).convert("RGB")`, by path, uint8 [H, W, 3]).

    python tools/gen_torch_ojpeg.py [out_dir]

(`tools/gen_torch_assets.py` calls it after writing the scenes' images,
which it reads.) The JPEG streams are PIL's (libjpeg-turbo's writer); the
TIFF around them is laid out here (`ojpeg_tiff`) in the two layouts old
writers used:

  * interchange: JPEGInterchangeFormat / Length (513 / 514) point at a
    whole JFIF stream, and the strip is its entropy-coded data (or the
    stream itself, or a copy of the data after it);
  * tables-only: JPEGProc (512) 1; JPEGQTables, JPEGDCTables and
    JPEGACTables (519-521) hold one offset a component, pointing at the raw
    64-byte quantisation tables and the DHT bodies (16 counts, then the
    values); each strip or tile is a bare run of entropy-coded data, one
    restart interval of the stream (`restart_split`).

Needs PIL and numpy. The output is deterministic: running it again writes
the same bytes.
"""
import hashlib
import io
import os
import struct
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "assets_torch")
TIMING_SEED = 22
CORNER = 128
_CODES = {1: "B", 3: "H", 4: "I", 5: "I", 7: "B"}


def pil_jpeg(img, quality=85, subsampling=2, **opts):
    """PIL's baseline JPEG of img (uint8 [H, W, 3] RGB, or [H, W] grey):
    `subsampling` 0, 1, 2 (4:4:4, 4:2:2, 4:2:0; 4:1:1 and 4:4:0 are the
    pip cv2's, `cv_jpeg`), PIL's writer options (`restart_marker_rows`,
    `restart_marker_blocks`)."""
    from PIL import Image
    b = io.BytesIO()
    im = Image.fromarray(np.asarray(img, np.uint8))
    if im.mode == "RGB":
        opts["subsampling"] = subsampling
    im.save(b, "JPEG", quality=quality, **opts)
    return b.getvalue()


def cv_jpeg(img, factor, quality=85):
    """The pip cv2's baseline JPEG of img (RGB), its chroma sampled as
    `factor` (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_*: 4:1:1, 4:4:0 and the
    rest)."""
    import cv2
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]
    return cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]),
                        params)[1].tobytes()


# JPEG's example tables (T.81 K.1, K.2: natural order) and standard
# Huffman tables (K.3: the DC tables 0, 1, the AC tables 0, 1), which
# libjpeg's writer uses unless told otherwise
_K1 = (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
       14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
       18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
       49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99)
_K2 = (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
       24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99) + \
    (99,) * 32
_STD_DC = (bytes.fromhex("00010501010101010100000000000000000102030405060708"
                         "090a0b"),
           bytes.fromhex("00030101010101010101010000000000000102030405060708"
                         "090a0b"))
_STD_AC = (bytes.fromhex(
    "0002010303020403050504040000017d01020300041105122131410613516107"
    "227114328191a1082342b1c11552d1f02433627282090a161718191a25262728"
    "292a3435363738393a434445464748494a535455565758595a63646566676869"
    "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
    "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
    "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"), bytes.fromhex(
    "0002010204040304070504040001027700010203110405213106124151076171"
    "1322328108144291a1b1c109233352f0156272d10a162434e125f11718191a26"
    "2728292a35363738393a434445464748494a535455565758595a636465666768"
    "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5"
    "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
    "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))
_ZZ = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12,
                19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
                35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
                51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55,
                62, 63])


def quant_tables(quality):
    """libjpeg's jpeg_set_quality: K.1 and K.2 scaled, 1..255, zig-zag
    order."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [bytes(np.clip((np.array(t)[_ZZ] * scale + 50) // 100, 1, 255)
                  .astype(np.uint8)) for t in (_K1, _K2)]


def _codes(body):
    """A DHT body (16 counts, then the values) -> {symbol: (code, bits)}."""
    codes, code, k = {}, 0, 16
    for n in range(1, 17):
        for _ in range(body[n - 1]):
            codes[body[k]] = (code, n)
            code += 1
            k += 1
        code <<= 1
    return codes


def _entropy(blocks, tables, restart):
    """Baseline Huffman coding of quantised blocks in coding order: blocks
    int [n, 64] (zig-zag order), tables [n] the block's component (0, or 1
    for chroma: its DC / AC tables and DC predictor), restart: blocks an
    interval (0: none), -> the scan's entropy-coded data, RSTn included."""
    dc = [_codes(t) for t in _STD_DC]
    ac = [_codes(t) for t in _STD_AC]
    out = bytearray()
    acc, n = 0, 0

    def flush():
        nonlocal acc, n
        if n % 8:
            acc, n = acc << (8 - n % 8) | (1 << (8 - n % 8)) - 1, n + 8 - n % 8
        raw = acc.to_bytes(n // 8, "big") if n else b""
        out.extend(raw.replace(b"\xff", b"\xff\x00"))
        acc, n = 0, 0

    pred = {}
    for i, (blk, t) in enumerate(zip(blocks.tolist(), tables)):
        if restart and i and i % restart == 0:
            flush()
            out.extend(bytes([0xFF, 0xD0 + (i // restart - 1) % 8]))
            pred = {}
        d = blk[0] - pred.get(t[1], 0)
        pred[t[1]] = blk[0]
        c = abs(d).bit_length()
        code, ln = dc[t[0]][c]
        acc = (acc << ln | code) << c | (d if d >= 0 else d - 1) & (1 << c) - 1
        n += ln + c
        run = 0
        for v in blk[1:]:
            if v == 0:
                run += 1
                continue
            while run > 15:
                code, ln = ac[t[0]][0xF0]
                acc, n, run = acc << ln | code, n + ln, run - 16
            c = abs(v).bit_length()
            code, ln = ac[t[0]][run << 4 | c]
            acc = (acc << ln | code) << c | (v if v >= 0 else v - 1) & \
                (1 << c) - 1
            n += ln + c
            run = 0
        if run:
            code, ln = ac[t[0]][0]
            acc, n = acc << ln | code, n + ln
        if n > 4096:        # keep the accumulator short: whole bytes out
            k = n - n % 8
            raw = (acc >> (n - k)).to_bytes(k // 8, "big")
            out.extend(raw.replace(b"\xff", b"\xff\x00"))
            acc, n = acc & (1 << (n - k)) - 1, n - k
    flush()
    return bytes(out)


def baseline_jpeg(img, quality=85, sampling=(0x22, 0x11, 0x11), restart=0,
                  interleaved=True):
    """A baseline JPEG of img (uint8 [H, W, 3] RGB) written here, without
    PIL: JFIF's YCbCr, each component sampled as `sampling` (hv bytes;
    chroma averaged), libjpeg's tables at `quality`, one interleaved scan
    or (`interleaved` False) one scan a component, as a planar old-style
    JPEG TIFF holds it; a restart interval of `restart` MCUs (a block is a
    one-component scan's MCU)."""
    from scipy.fft import dctn
    h, w, _ = img.shape
    f = img.astype(np.float64)
    ycc = np.stack([0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2],
                    128 - 0.168736 * f[..., 0] - 0.331264 * f[..., 1] +
                    0.5 * f[..., 2],
                    128 + 0.5 * f[..., 0] - 0.418688 * f[..., 1] -
                    0.081312 * f[..., 2]], -1)
    hmax = max(hv >> 4 for hv in sampling)
    vmax = max(hv & 15 for hv in sampling)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    q = quant_tables(quality)
    coefs = []
    for k, hv in enumerate(sampling):
        fy, fx = vmax // (hv & 15), hmax // (hv >> 4)
        ch, cw = -(-h // fy), -(-w // fx)
        pad = np.pad(ycc[..., k], ((0, ch * fy - h), (0, cw * fx - w)),
                     mode="edge")
        plane = pad.reshape(ch, fy, cw, fx).mean((1, 3))
        bh, bw = (my * (hv & 15), mx * (hv >> 4)) if interleaved else \
            (-(-ch // 8), -(-cw // 8))
        plane = np.pad(plane, ((0, bh * 8 - ch), (0, bw * 8 - cw)),
                       mode="edge") - 128
        blocks = dctn(plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3),
                      axes=(2, 3), norm="ortho").reshape(bh, bw, 64)[..., _ZZ]
        coefs.append(np.round(blocks / np.frombuffer(
            q[k > 0], np.uint8)).astype(np.int64))
    out = bytearray(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01"
                    b"\x00\x01\x00\x00")
    for t in (0, 1):
        out += b"\xff\xdb\x00\x43" + bytes([t]) + q[t]
    out += b"\xff\xc0" + struct.pack(">HBHHB", 17, 8, h, w, 3) + b"".join(
        bytes([k + 1, hv, k > 0]) for k, hv in enumerate(sampling))
    for t in (0, 1):
        out += b"\xff\xc4" + struct.pack(">HB", len(_STD_DC[t]) + 3, t) + \
            _STD_DC[t]
        out += b"\xff\xc4" + struct.pack(">HB", len(_STD_AC[t]) + 3,
                                         16 | t) + _STD_AC[t]
    if restart:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart)
    if interleaved:
        order, tabs = [], []
        for k, hv in enumerate(sampling):
            c = coefs[k].reshape(my, hv & 15, mx, hv >> 4, 64).transpose(
                0, 2, 1, 3, 4).reshape(my, mx, -1, 64)
            order.append(c)
            tabs += [(min(k, 1), k)] * c.shape[2]
        blocks = np.concatenate(order, 2).reshape(-1, 64)
        out += b"\xff\xda" + struct.pack(">HB", 12, 3) + b"".join(
            bytes([k + 1, 0 if k == 0 else 0x11]) for k in range(3)) + \
            bytes([0, 63, 0])
        per_mcu = len(tabs)
        out += _entropy(blocks, tabs * (my * mx), restart * per_mcu)
    else:
        for k in range(3):
            out += b"\xff\xda" + struct.pack(">HBB", 8, 1, k + 1) + \
                bytes([0 if k == 0 else 0x11, 0, 63, 0])
            c = coefs[k].reshape(-1, 64)
            out += _entropy(c, [(min(k, 1), k)] * len(c), restart)
    return bytes(out + b"\xff\xd9")


def segments(data):
    """A JPEG's marker segments up to and including SOS: [(marker, offset,
    body)], then the offset of the entropy-coded data after the SOS
    header and the offset of the EOI that ends it."""
    pos, out = 2, []
    while True:
        m = data[pos + 1]
        n, = struct.unpack(">H", data[pos + 2:pos + 4])
        out.append((m, pos, data[pos + 4:pos + 2 + n]))
        pos += 2 + n
        if m == 0xDA:
            return out, pos, data.rindex(b"\xff\xd9")


def jpeg_parts(data):
    """A baseline JPEG -> dict: `q` {table id: 64 bytes (zig-zag order)},
    `dc` / `ac` {table id: DHT body (16 counts + values)}, `sof` (height,
    width, [(id, hv, tq)]), `sos` [(id, tables)], `dri`, `scan` (the
    entropy-coded data, RSTn markers included)."""
    segs, start, end = segments(data)
    p = dict(q={}, dc={}, ac={}, dri=0)
    for m, _, body in segs:
        if m == 0xDB:
            i = 0
            while i < len(body):
                p["q"][body[i] & 15] = body[i + 1:i + 65]
                i += 65
        elif m == 0xC4:
            i = 0
            while i < len(body):
                n = sum(body[i + 1:i + 17])
                key = "ac" if body[i] >> 4 else "dc"
                p[key][body[i] & 15] = body[i + 1:i + 17 + n]
                i += 17 + n
        elif 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            h, w, nc = struct.unpack(">HHB", body[1:6])
            p["sof"] = (h, w, [tuple(body[6 + 3 * k:9 + 3 * k])
                               for k in range(nc)])
        elif m == 0xDD:
            p["dri"], = struct.unpack(">H", body)
        elif m == 0xDA:
            nc = body[0]
            p["sos"] = [tuple(body[1 + 2 * k:3 + 2 * k]) for k in range(nc)]
    p["scan"] = data[start:end]
    return p


def restart_split(scan):
    """A scan's entropy-coded data -> its restart intervals, each without
    the RSTn marker that ends it."""
    out, pos = [], 0
    i = 0
    while True:
        i = scan.find(b"\xff", i)
        if i < 0 or i + 1 >= len(scan):
            out.append(scan[pos:])
            return out
        if 0xD0 <= scan[i + 1] <= 0xD7:
            out.append(scan[pos:i])
            pos = i = i + 2
        else:
            i += 2


def ojpeg_tiff(jpeg, layout="interchange", rows_per_strip=None, tile=None,
               chunks=None, strip_at="scan", drop=(), tags=None, bo="<",
               photometric=6, proc=1):
    """An old-style JPEG TIFF around the JPEG stream `jpeg` (its size the
    image's): `layout` "interchange" (tags 513 / 514 at the whole stream;
    the strips, `strip_at` "scan": the entropy-coded data inside it, "soi":
    the stream itself, "after": a copy of the data after it) or "tables"
    (tags 512, 515 (the stream's DRI), 519-521; the strips are `chunks`,
    or the stream's restart intervals, one a strip or tile); rows a strip
    or (tile width, length); `drop` tags left out; `tags` {tag: (type,
    values)} added or replacing the writer's."""
    p = jpeg_parts(jpeg)
    h, w, comps = p["sof"]
    spp = len(comps)
    body = bytearray(b"II*\0" if bo == "<" else b"MM\0*") + bytes(4)

    def put(b):
        at = len(body)
        body.extend(b)
        if len(body) % 2:
            body.append(0)
        return at

    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [6]),
         262: (3, [photometric]), 277: (3, [spp]), 284: (3, [1])}
    if len(comps) == 3:
        hv = comps[0][1]
        t[530] = (3, [hv >> 4, hv & 15])
    if layout == "interchange":
        at = put(jpeg)
        t[513], t[514] = (4, [at]), (4, [len(jpeg)])
        _, start, end = segments(jpeg)
        if chunks is None:
            if strip_at == "scan":
                offs, counts = [at + start], [end - start]
            elif strip_at == "soi":
                offs, counts = [at], [len(jpeg)]
            else:
                offs = [put(jpeg[start:end])]
                counts = [end - start]
        else:
            offs = [put(c) for c in chunks]
            counts = [len(c) for c in chunks]
    else:
        t[512] = (3, [proc])
        if p["dri"]:
            t[515] = (3, [p["dri"]])
        ids = [(c[2], s[1] >> 4, s[1] & 15) for c, s in zip(comps,
                                                             p["sos"])]
        qo, do, ao, seen = [], [], [], {}
        for tq, td, ta in ids:
            for lst, key, k in ((qo, "q", tq), (do, "dc", td),
                                (ao, "ac", ta)):
                if (key, k) not in seen:
                    seen[key, k] = put(p[key][k])
                lst.append(seen[key, k])
        t[519], t[520], t[521] = (4, qo), (4, do), (4, ao)
        if chunks is None:
            chunks = restart_split(p["scan"])
        offs = [put(c) for c in chunks]
        counts = [len(c) for c in chunks]
    if tile:
        t[322], t[323] = (3, [tile[0]]), (3, [tile[1]])
        t[324], t[325] = (4, offs), (4, counts)
    else:
        t[273], t[279] = (4, offs), (4, counts)
        t[278] = (3, [rows_per_strip or h])
    t.update(tags or {})
    for k in drop:
        t.pop(k, None)
    blobs = {}
    for tag, (typ, vals) in t.items():
        unit = {1: 1, 3: 2, 4: 4, 5: 4, 7: 1}[typ]
        if unit * len(vals) > 4:
            blobs[tag] = put(struct.pack(bo + _CODES[typ] * len(vals), *vals))
    ifd = len(body)
    body[4:8] = struct.pack(bo + "I", ifd)
    body += struct.pack(bo + "H", len(t))
    for tag in sorted(t):
        typ, vals = t[tag]
        raw = struct.pack(bo + _CODES[typ] * len(vals), *vals)
        field = struct.pack(bo + "I", blobs[tag]) if tag in blobs else \
            raw.ljust(4, b"\0")
        count = len(vals) // 2 if typ == 5 else len(vals)
        body += struct.pack(bo + "HHI", tag, typ, count) + field
    body += bytes(4)
    return bytes(body)


# ---------------------------------------------------------------------------
# the files
# ---------------------------------------------------------------------------

def waves(h, w, seed):
    """Smooth colour waves with a little grain, from a seed: uint8 [h, w,
    3]."""
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    a = np.stack([np.sin(x / (2 + k) + y / (3 + k) + g.random() * 6)
                  for k in range(3)], -1)
    return np.clip(128 + 100 * a + g.integers(-20, 20, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _tiles(img, tw, th):
    """img's tiles of tw x th (edge tiles padded with zeros), stacked top
    to bottom in TIFF's order: the image an old-style JPEG TIFF's tiles
    hold as one stream."""
    h, w, _ = img.shape
    out = []
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            t = np.zeros((th, tw, 3), np.uint8)
            part = img[y0:y0 + th, x0:x0 + tw]
            t[:part.shape[0], :part.shape[1]] = part
            out.append(t)
    return np.concatenate(out)


def _scans(data):
    """The entropy-coded data of each scan of a JPEG: [(start, end)]."""
    out, pos = [], 2
    while data[pos + 1] != 0xD9:
        n, = struct.unpack(">H", data[pos + 2:pos + 4])
        if data[pos + 1] != 0xDA:
            pos += 2 + n
            continue
        a = b = pos + 2 + n
        while not (data[b] == 0xFF and data[b + 1] not in (
                0, *range(0xD0, 0xD8))):
            b += 1
        out.append((a, b))
        pos = b
    return out


def _edit(data, at, value):
    """data with its SOF's byte `at` (from the marker) set to value."""
    d = bytearray(data)
    d[d.index(b"\xff\xc0") + at] = value
    return bytes(d)


def ojpeg_files(checker_rgb, projector_rgb):
    """name -> bytes: slice 7e.4b's old-style JPEG TIFF files (each layout,
    sampling and case of `tests/test_torch_ojpeg.py`; the ones PIL refuses
    are named `oj_bad_*`) and the twins `checker_ojpeg.tif` (the checker,
    interchange, 4:2:0) and `projector_ojpeg.tif` (the projector's RGB,
    tables-only, 4:2:0, a strip and a restart interval each MCU row)."""
    import cv2
    t = ojpeg_tiff
    f = {}
    w = waves(21, 13, 1)
    for sub, k in ((0, "444"), (1, "422"), (2, "420")):
        j = pil_jpeg(w if sub != 1 else waves(17, 30, 2), 80, sub)
        f[f"oj_{k}.tif"] = t(j)
        f[f"oj_tb_{k}.tif"] = t(j, "tables")
    for fac, k in ((cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, "411"),
                   (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440, "440")):
        j = cv_jpeg(waves(21, 37, 3), fac)
        f[f"oj_{k}.tif"] = t(j)
        f[f"oj_tb_{k}.tif"] = t(j, "tables")
    # strips: each a restart interval of whole MCU rows
    img = waves(50, 37, 4)
    j = pil_jpeg(img, 85, 2, restart_marker_rows=1)
    f["oj_tb_strips.tif"] = t(j, "tables", rows_per_strip=16)
    j2 = pil_jpeg(img, 85, 2, restart_marker_rows=2)
    f["oj_ic_strips.tif"] = t(j2, "interchange", rows_per_strip=32,
                              chunks=restart_split(jpeg_parts(j2)["scan"]))
    j1 = pil_jpeg(waves(24, 30, 5), 85, 1, restart_marker_rows=1)
    f["oj_tb_strips_422.tif"] = t(j1, "tables", rows_per_strip=8)
    jr = pil_jpeg(waves(40, 30, 6), 85, 2, restart_marker_blocks=2)
    f["oj_ic_rst.tif"] = t(jr)
    j = pil_jpeg(waves(30, 27, 7), 85, 2)
    f["oj_ic_soi.tif"] = t(j, strip_at="soi")
    f["oj_ic_after.tif"] = t(j, strip_at="after")
    # tiles: the tiles' JPEG is one stream a tile wide, a restart interval
    # a tile; libtiff's frame is one column of tiles high
    img = waves(40, 60, 8)
    jt = pil_jpeg(_tiles(img, 32, 16), 85, 2, restart_marker_rows=1)
    size = {256: (4, [60]), 257: (4, [40])}
    f["oj_tb_tiles.tif"] = t(jt, "tables", tile=(32, 16), tags=size)
    f["oj_ic_tiles.tif"] = t(jt, tile=(32, 16), tags=size,
                             chunks=restart_split(jpeg_parts(jt)["scan"]))
    jt0 = pil_jpeg(_tiles(img, 32, 16), 85, 0, restart_marker_rows=2)
    f["oj_tb_tiles_444.tif"] = t(jt0, "tables", tile=(32, 16), tags=size)
    row = waves(16, 60, 9)
    jrow = pil_jpeg(_tiles(row, 32, 16), 85, 2, restart_marker_rows=1)
    f["oj_tb_tiles_row.tif"] = t(jrow, "tables", tile=(32, 16),
                                 tags={256: (4, [60]), 257: (4, [16])})
    # planar: one scan a plane (Cb and Cr read as zeros where libtiff finds
    # no SOS for them); one planar strip libtiff takes as contiguous
    img = waves(40, 27, 10)
    jp = baseline_jpeg(img, 85, (0x11,) * 3, interleaved=False)
    plan = {284: (3, [2])}
    f["oj_planar.tif"] = t(jp, chunks=[jp[a:b] for a, b in _scans(jp)],
                           tags=plan)
    jps = baseline_jpeg(img, 85, (0x11,) * 3, restart=8, interleaved=False)
    f["oj_planar_strips.tif"] = t(
        jps, rows_per_strip=16, tags=plan, chunks=[
            c for a, b in _scans(jps) for c in restart_split(jps[a:b])])
    j444 = pil_jpeg(waves(24, 24, 11), 85, 0)
    sc = jpeg_parts(j444)["scan"]
    f["oj_tb_planar.tif"] = t(j444, "tables", chunks=[sc] * 3, tags=plan)
    f["oj_planar_one.tif"] = t(j444, tags=plan)
    # one grey sample, read strip by strip (photometric 6: refused)
    grey = waves(20, 17, 12)[..., 0]
    jg = pil_jpeg(grey, 85)
    f["oj_grey.tif"] = t(jg, photometric=1)
    f["oj_grey_white.tif"] = t(jg, "tables", photometric=0)
    jgs = pil_jpeg(waves(48, 27, 13)[..., 0], 85, restart_marker_rows=1)
    f["oj_grey_strips.tif"] = t(jgs, "tables", photometric=1,
                                rows_per_strip=8)
    f["oj_bad_grey_ycbcr.tif"] = t(jg)
    # the tags left out, and libtiff's OJPEG directory hacks
    j = pil_jpeg(waves(30, 27, 14), 85, 2)
    for tags in ((277,), (262,), (262, 277), (279,), (273,), (530,)):
        f["oj_no" + "_".join(map(str, tags)) + ".tif"] = t(j, drop=tags)
    f["oj_tb_no530.tif"] = t(pil_jpeg(waves(13, 21, 15), 85, 0), "tables",
                             drop=(530,))
    f["oj_bad_no258.tif"] = t(j, drop=(258,))
    f["oj_bad_tb_no279.tif"] = t(j, "tables", drop=(279,))
    f["oj_bad_no_tables.tif"] = t(j, "tables", drop=(519,))
    f["oj_rgb.tif"] = t(j, photometric=2)
    f["oj_bad_photo1.tif"] = t(j, photometric=1)
    f["oj_mm.tif"] = t(j, "tables", bo=">")
    f["oj_rbw.tif"] = t(j, tags={532: (5, [10, 1, 250, 1, 128, 1, 250, 1,
                                            120, 1, 240, 1])})
    f["oj_coeffs.tif"] = t(j, "tables", tags={529: (5, [2126, 10000, 7152,
                                                         10000, 722, 10000])})
    f["oj_tag_off.tif"] = t(j, tags={530: (3, [1, 1])})
    f["oj_bad_tag44.tif"] = t(j, "tables", tags={530: (3, [4, 4])})
    f["oj_bad_fill2.tif"] = t(j, tags={266: (3, [2])})
    f["oj_proc14.tif"] = t(j, "tables", proc=14)
    f["oj_sof1.tif"] = t(_edit(j, 1, 0xC1))
    for m, k in ((0xC2, "sof2"), (0xC3, "sof3")):
        f[f"oj_bad_{k}.tif"] = t(_edit(j, 1, m))
    f["oj_bad_12bit.tif"] = t(_edit(j, 4, 12))
    f["oj_bad_upsampled.tif"] = t(_edit(j, 14, 0x12))    # Cb 1x2
    # strips cut short or broken
    img = waves(64, 37, 16)
    j = pil_jpeg(img, 85, 2, restart_marker_rows=1)
    iv = restart_split(jpeg_parts(j)["scan"])
    cut = list(iv)
    cut[2] = cut[2][:len(cut[2]) // 3]
    f["oj_strip_cut.tif"] = t(j, "tables", rows_per_strip=16, chunks=cut)
    f["oj_last_fail.tif"] = t(j, "tables", rows_per_strip=16,
                              chunks=iv[:3] + [iv[3] + b"\xff\xd5"])
    f["oj_bad_mid_fail.tif"] = t(j, "tables", rows_per_strip=16,
                                 chunks=iv[:1] + [iv[1] + b"\xff\xd3"] +
                                 iv[2:])
    f["oj_bad_rps.tif"] = t(j, "tables", rows_per_strip=17, chunks=iv)
    sc = jpeg_parts(j)["scan"]
    j0 = pil_jpeg(img, 85, 2)
    f["oj_cut.tif"] = t(j0, "tables", chunks=[jpeg_parts(j0)["scan"][:900]])
    f["oj_bad_tile_narrow.tif"] = t(pil_jpeg(waves(16, 20, 17), 85, 2),
                                    tile=(32, 16), chunks=[sc[:400]])
    # the twins
    f["checker_ojpeg.tif"] = t(pil_jpeg(checker_rgb, 90, 2))
    f["projector_ojpeg.tif"] = t(pil_jpeg(projector_rgb, 90, 2,
                                          restart_marker_rows=1),
                                 "tables", rows_per_strip=16)
    return f


def ojpeg_timing(n=2048, seed=TIMING_SEED):
    """An n x n old-style JPEG TIFF, tables-only, 4:2:0, a strip of 16
    rows and a restart interval each MCU row, of smooth waves from a seed,
    written without PIL (`baseline_jpeg`; about 1.6 s at 2048^2)."""
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / n
    ph = g.random(3) * 6
    v = np.stack([np.sin(7 * x + 3 * y + ph[0]), np.cos(5 * y - 2 * x + ph[1]),
                  np.sin(11 * x * y + ph[2])], -1)
    img = np.clip(np.round(128 + 90 * v), 0, 255).astype(np.uint8)
    return ojpeg_tiff(baseline_jpeg(img, 85, restart=n // 16), "tables",
                      rows_per_strip=16)


def write_ojpeg_files(out, checker_rgb, projector_rgb):
    """Slice 7e.4b's files (`ojpeg_files`), the twins' PIL decodes
    `checker_ojpeg_pil.png` and `projector_ojpeg_pil.png`, and
    `ojpeg_decodes.npz`: PIL's decode of each file it decodes (by path),
    and the sha256 and 128 x 128 corner of its decode of `ojpeg_timing`'s
    file under "ojpeg_2048.tif:sha256" / ":corner"."""
    from PIL import Image
    dec = {}
    for fn, data in ojpeg_files(checker_rgb, projector_rgb).items():
        p = os.path.join(out, fn)
        with open(p, "wb") as fh:
            fh.write(data)
        try:
            dec[fn] = np.asarray(Image.open(p).convert("RGB"))
        except OSError:
            assert fn.startswith("oj_bad_"), fn
            continue
        assert not fn.startswith("oj_bad_"), fn
    for fn in ("checker_ojpeg", "projector_ojpeg"):
        Image.fromarray(dec[fn + ".tif"]).save(os.path.join(
            out, fn + "_pil.png"))
    full = np.asarray(Image.open(io.BytesIO(ojpeg_timing())).convert("RGB"))
    dec["ojpeg_2048.tif:sha256"] = np.frombuffer(
        hashlib.sha256(full.tobytes()).digest(), np.uint8)
    dec["ojpeg_2048.tif:corner"] = full[:CORNER, :CORNER]
    np.savez_compressed(os.path.join(out, "ojpeg_decodes.npz"), **dec)


def main():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_assets_ojpeg", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_assets.py"))
    ga = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ga)
    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    write_ojpeg_files(out, ga.checker(), ga.projector()[..., :3])


if __name__ == "__main__":
    main()
