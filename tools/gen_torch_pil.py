"""Write the files of slice 7e.6a (the small formats PIL opens) that PIL
cannot write, or writes in one variant only, into `tests/assets_torch/`,
with `pil_decodes.npz`: what PIL decodes from each
(`Image.open(p).convert("RGB")`, by path). The port decodes them with
`vision_tpu_torch/scene/pilread.py`.

    python tools/gen_torch_pil.py [out_dir]

(`tools/gen_torch_assets.py` calls it after writing the scenes' PNGs,
which it reads.) The encoders here are the tests' too
(`tests/torch_scenes.py` `gen_pil`):

  * `pcx_bytes`: PCX at 1 bit in 1, 2 or 4 planes, 8 bits (grey, or a
    256-colour palette at the end) and 24 bits in 3 planes, run-length
    coded a line at a time;
  * `sgi_bytes`: SGI raw or run-length coded, 8 or 16 bits, 1-4 channels;
  * `msp_bytes`: Windows Paint version 1 (raw) and 2 (run-length rows);
  * `psd_bytes`: Photoshop's merged image, raw or PackBits, any mode;
  * `xpm_bytes`: X11 pixmaps (PIL has no XPM writer);
  * `dds_bytes` / `dds_dx10`: DirectDraw surfaces of any pixel format;
    `bc7_encode`, a BC7 encoder (mode 6: one subset, 7-bit endpoints and
    a p-bit each, 4-bit indices);
  * `sun_bytes`, `icns_bytes`, `cur_bytes`, `im_bytes`.

The files: `pcx_*`, `sgi_*`, `msp_*`, `psd_*`, `xpm_*`, `dds_*` (every
DDS pixel format; `dds_bc6h*` and `dds_bc7_random` of random blocks, so
every BC6H and BC7 mode), `sun_*`, `icns_*`, `cur_*`, `im_*` (IM's N-bit,
RGB3 / RYB3 and YCC types), `psd_lab_*`; the twins of the
scenes' PNGs (`tests/torch_scenes.py`): `checker.qoi`, `bumps.ppm`,
`checker_rle.sgi`, `projector_bmp.ico` (the same pixels), `checker_bc7.dds`
(lossy) and `checker_bc7_pil.png` (PIL's decode of it); and
`bc7_2048.dds:sha256` / `:corner`: PIL's decode of the 2048 x 2048 BC7
file `bc7_timing()` builds from a seed (not committed: 4 MB).

The output is deterministic: running it again writes the same bytes.
"""
import hashlib
import io
import os
import struct
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "assets_torch")
BC7_TIMING_SEED = 2048
CORNER = 128


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

def _pcx_rle(raw):
    """PCX run-length coding of one line: runs of up to 63 bytes as
    0xC0 | n and the byte; a byte of 0xC0 or more as a run of 1."""
    out = bytearray()
    i = 0
    while i < len(raw):
        j = i
        while j < len(raw) and raw[j] == raw[i] and j - i < 63:
            j += 1
        if j - i > 1 or raw[i] >= 0xC0:
            out += bytes((0xC0 | (j - i), raw[i]))
        else:
            out.append(raw[i])
        i = j
    return bytes(out)


def pcx_bytes(v, bits, planes, palette16=None, palette256=None, version=5,
              stride=None):
    """PCX bytes: v uint8 [h, w] indices (1 bit in 1, 2 or 4 planes; 8
    bits in 1) or [h, w, 3] RGB (8 bits in 3 planes); `stride` the bytes a
    plane's line (default even), `palette16` the header's 48 bytes,
    `palette256` the 768 bytes after 0x0C at the end."""
    h, w = v.shape[:2]
    line = (w * bits + 7) // 8
    stride = stride or line + line % 2
    rows = []
    for y in range(h):
        if bits == 8:
            parts = [v[y, :, c] for c in range(3)] if planes == 3 else [v[y]]
        else:
            parts = [np.packbits((v[y] >> k) & 1) for k in range(planes)]
        raw = b"".join(bytes(p)[:stride].ljust(stride, b"\0") for p in parts)
        rows.append(_pcx_rle(raw))
    head = struct.pack("<4B6H", 10, version, 1, bits, 0, 0, w - 1, h - 1,
                       72, 72)
    head += (palette16 if palette16 is not None else bytes(48))
    head += bytes((0, planes)) + struct.pack("<HH", stride, 1)
    body = b"".join(rows)
    if palette256 is not None:
        body += b"\x0c" + palette256
    return head.ljust(128, b"\0") + body


def _sgi_rle(values, bpc):
    """SGI run-length coding of one row: a count byte (or the low byte of
    a 16-bit atom) n < 0x80 and one value repeated n times, 0x80 | n and n
    values; a zero atom ends the row."""
    out = bytearray()
    put = (lambda x: out.extend(bytes((x,)))) if bpc == 1 else \
        (lambda x: out.extend(struct.pack(">H", x)))
    i = 0
    v = [int(x) for x in values]
    while i < len(v):
        j = i
        while j < len(v) and v[j] == v[i] and j - i < 127:
            j += 1
        if j - i >= 3:
            put(j - i)
            put(v[i])
            i = j
            continue
        k = i
        while k < len(v) and k - i < 127 and not (
                k + 2 < len(v) and v[k] == v[k + 1] == v[k + 2]):
            k += 1
        put(0x80 | (k - i))
        for x in v[i:k]:
            put(x)
        i = k
    put(0)
    return bytes(out)


def sgi_bytes(img, bpc=1, rle=True):
    """SGI bytes of img [h, w, z] (uint8, or uint16 with bpc 2), rows
    bottom-up, channels planar; raw or run-length coded."""
    h, w, z = img.shape
    dim = 3 if z > 1 else (1 if h == 1 else 2)
    head = struct.pack(">hBBHHHHii", 474, int(rle), bpc, dim, w, h, z, 0,
                       255 if bpc == 1 else 65535)
    head = (head + bytes(4) + b"vision_tpu".ljust(80, b"\0")).ljust(512, b"\0")
    fmt = np.uint8 if bpc == 1 else ">u2"
    rows = [[img[h - 1 - y, :, c].astype(fmt) for y in range(h)]
            for c in range(z)]
    if not rle:
        return head + b"".join(r.tobytes() for ch in rows for r in ch)
    coded = [[_sgi_rle(r, bpc) for r in ch] for ch in rows]
    pos = 512 + 8 * z * h
    starts, lengths, body = [], [], []
    for ch in coded:
        for r in ch:
            starts.append(pos)
            lengths.append(len(r))
            body.append(r)
            pos += len(r)
    return head + struct.pack(f">{z * h}I", *starts) + \
        struct.pack(f">{z * h}I", *lengths) + b"".join(body)


def msp_bytes(bits, v2=True):
    """Windows Paint bytes of bits [h, w] (bool, True white): version 2
    with run-length rows (an all-white row stored as none), or version 1
    raw."""
    h, w = bits.shape
    rows = np.packbits(bits, axis=1)
    words = [0] * 16
    words[0], words[1] = struct.unpack("<HH", b"LinS" if v2 else b"DanM")
    words[2], words[3], words[4], words[5] = w, h, 1, 1
    x = 0
    for v in words[:15]:
        x ^= v
    words[15] = x
    head = struct.pack("<16H", *words)
    if not v2:
        return head + rows.tobytes()
    enc = []
    for r in rows:
        if (r == 0xFF).all():                # an all-white row: length 0
            enc.append(b"")
            continue
        e = bytearray()
        i = 0
        while i < len(r):
            j = i
            while j < len(r) and r[j] == r[i] and j - i < 255:
                j += 1
            if j - i >= 3:
                e += bytes((0, j - i, r[i]))
                i = j
            else:
                k = min(len(r), i + 3)
                e += bytes((k - i,)) + bytes(r[i:k])
                i = k
        enc.append(bytes(e))
    return head + struct.pack(f"<{h}H", *map(len, enc)) + b"".join(enc)


def _packbits(row):
    out = bytearray()
    i = 0
    while i < len(row):
        j = i
        while j < len(row) and row[j] == row[i] and j - i < 128:
            j += 1
        if j - i >= 2:
            out += bytes((257 - (j - i),)) + row[i:i + 1]
            i = j
            continue
        k = i
        while k < len(row) and k - i < 128 and not (
                k + 1 < len(row) and row[k] == row[k + 1]):
            k += 1
        k = max(k, i + 1)
        out += bytes((k - i - 1,)) + row[i:k]
        i = k
    return bytes(out)


def psd_bytes(mode, bits, planes, w, h, comp=0, cmd=b"", res=b"",
              layers=b"", channels=None):
    """Photoshop bytes: mode (0 bitmap, 1 grey, 2 indexed, 3 RGB, 4 CMYK,
    7 multichannel, 8 duotone, 9 Lab), planes uint8 [h, line] each, raw
    (comp 0) or PackBits (comp 1) with its byte counts."""
    n = len(planes) if channels is None else channels
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, n, h, w, bits, mode)
    body = struct.pack(">I", len(cmd)) + cmd + struct.pack(">I", len(res)) \
        + res + struct.pack(">I", len(layers)) + layers
    if comp == 0:
        return head + body + struct.pack(">H", 0) + \
            b"".join(p.tobytes() for p in planes)
    rows = [_packbits(bytes(r)) for p in planes for r in p]
    return head + body + struct.pack(">H", 1) + \
        b"".join(struct.pack(">H", len(r)) for r in rows) + b"".join(rows)


def xpm_bytes(idx, colours, bpp=1):
    """X11 pixmap bytes: idx [h, w] into `colours` (0xRRGGBB, or None for
    `None`), `bpp` characters a pixel."""
    h, w = idx.shape
    chars = [chr(c) for c in range(35, 127) if chr(c) not in '"\\']
    keys = [(chars[i % len(chars)] + chars[i // len(chars)])[:bpp].encode()
            if bpp > 1 else chars[i].encode() for i in range(len(colours))]
    lines = [b"/* XPM */", b"static char *image[] = {",
             b"/* columns rows colors chars-per-pixel */",
             b'"%d %d %d %d ",' % (w, h, len(colours), bpp)]
    for k, c in zip(keys, colours):
        lines.append(b'"' + k + (b" c None" if c is None else
                                 b" c #%06X" % c) + b'",')
    lines.append(b"/* pixels */")
    lines += [b'"' + b"".join(keys[i] for i in r) + b'",' for r in idx]
    return b"\n".join(lines) + b"\n};\n"


def dds_bytes(w, h, pfflags, body, fourcc=b"\0\0\0\0", bitcount=0,
              masks=(0, 0, 0, 0)):
    """DDS bytes: the 128-byte header (DDS_PIXELFORMAT's flags, fourcc,
    bit count and masks) and `body`."""
    return b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 0) + \
        bytes(44) + struct.pack("<2I4sI4I", 32, pfflags, fourcc, bitcount,
                                *masks) + \
        struct.pack("<5I", 0x1000, 0, 0, 0, 0) + body


def dds_dx10(w, h, dxgi, body):
    """A DDS file with the DX10 header naming DXGI format `dxgi`."""
    return dds_bytes(w, h, 4, struct.pack("<5I", dxgi, 3, 0, 1, 0) + body,
                     b"DX10")


def bc7_encode(img):
    """RGBA uint8 [h, w, 4] (h, w multiples of 4) -> BC7 blocks, mode 6:
    each block's per-channel minimum and maximum as its endpoints, each
    pixel's nearest of 16 steps between them."""
    h, w = img.shape[:2]
    blk = img.reshape(h // 4, 4, w // 4, 4, 4).transpose(0, 2, 1, 3, 4)
    blk = blk.reshape(-1, 16, 4).astype(np.int64)
    out = bytearray()
    weights = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55,
                        60, 64])
    for b in blk:
        e0 = b.min(0) >> 1 << 1              # p-bit 0
        e1 = b.max(0) | 1                    # p-bit 1
        e1 = np.minimum(e1, 255)
        d = e1 - e0
        t = ((b - e0) * d).sum(1) / max(1, (d * d).sum())
        idx = np.abs(np.clip(t, 0, 1)[:, None] * 64 - weights).argmin(1)
        if idx[0] >= 8:                      # the anchor's top bit is 0
            e0, e1 = e1, e0
            idx = 15 - idx
        bits, n = 1 << 6, 7
        for c in range(4):
            for e in (e0, e1):
                bits |= int(e[c] >> 1) << n
                n += 7
        bits |= int(e0[0] & 1) << n
        bits |= int(e1[0] & 1) << (n + 1)
        n += 2
        for i, v in enumerate(idx):
            bits |= int(v) << n
            n += 3 if i == 0 else 4
        out += bits.to_bytes(16, "little")
    return bytes(out)


def bc7_timing(n=2048, seed=BC7_TIMING_SEED):
    """A BC7 DDS of n x n pixels of random blocks (any 16 bytes are a BC7
    block), from the PCG64 stream of `seed`."""
    raw = np.random.PCG64(seed).random_raw(n * n // 8)
    return dds_dx10(n, n, 98, raw.astype("<u8").tobytes())


def sun_bytes(w, h, depth, body, typ=1, cmap=b""):
    """Sun raster bytes: the 32-byte header, an RGB colour map, `body`."""
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), typ,
                       1 if cmap else 0, len(cmap)) + cmap + body


def icns_bytes(resources):
    """ICNS bytes of (type, data) resources."""
    body = b"".join(k + struct.pack(">I", 8 + len(v)) + v
                    for k, v in resources)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def icns_rle(plane):
    """IcnsImagePlugin's run-length coding of one channel plane."""
    out = bytearray()
    i = 0
    while i < len(plane):
        j = i
        while j < len(plane) and plane[j] == plane[i] and j - i < 130:
            j += 1
        if j - i >= 3:
            out += bytes((0x80 + j - i - 3, plane[i]))
            i = j
            continue
        k = i
        while k < len(plane) and k - i < 128 and not (
                k + 2 < len(plane)
                and plane[k] == plane[k + 1] == plane[k + 2]):
            k += 1
        k = max(k, i + 1)
        out += bytes((k - i - 1,)) + bytes(plane[i:k])
        i = k
    return bytes(out)


def cur_bytes(img, mode):
    """A Windows cursor: PIL's icon of `img` in `mode` with a BMP inside,
    its type set to 2."""
    from PIL import Image
    b = io.BytesIO()
    Image.fromarray(img).convert(mode).save(
        b, "ICO", sizes=[img.shape[1::-1]], bitmap_format="bmp")
    d = bytearray(b.getvalue())
    d[2] = 2
    return bytes(d)


# ---------------------------------------------------------------------------
# the files
# ---------------------------------------------------------------------------

def im_bytes(itype, w, h, body):
    """An IFUNC IM file of type `itype` (its header text to 0x1A) and the
    pixel bytes `body`."""
    head = f"Image type: {itype}\r\nImage size (x*y): {w}*{h}\r\n".encode()
    return head.ljust(511, b"\0") + b"\x1a" + body


def _save(img, fmt, **kw):
    from PIL import Image
    b = io.BytesIO()
    img.save(b, fmt, **kw)
    return b.getvalue()


def pil_files(checker, bumps, projector):
    """name -> bytes of the committed files (the module docstring lists
    them)."""
    from PIL import Image
    g = np.random.default_rng(76)
    files = {}
    h, w = 7, 13
    # PCX: each depth and plane count, odd and even widths
    v1 = g.integers(0, 2, (h, w), np.uint8)
    v1[:, :6] = 1
    files["pcx_1bit.pcx"] = pcx_bytes(v1, 1, 1)
    pal16 = g.integers(0, 256, 48, np.uint8).tobytes()
    for planes in (2, 4):
        v = g.integers(0, 1 << planes, (h, 16), np.uint8)
        files[f"pcx_{planes}planes.pcx"] = pcx_bytes(v, 1, planes, pal16)
        v = g.integers(0, 1 << planes, (h, 21), np.uint8)
        files[f"pcx_{planes}planes_odd.pcx"] = pcx_bytes(v, 1, planes, pal16)
    v8 = g.integers(0, 256, (h, w), np.uint8)
    v8[:, 2:9] = v8[:, 2:3]
    ramp = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    files["pcx_grey.pcx"] = pcx_bytes(v8, 8, 1, palette256=ramp)
    files["pcx_pal8.pcx"] = pcx_bytes(v8, 8, 1, palette256=g.integers(
        0, 256, 768, np.uint8).tobytes())
    rgb = g.integers(0, 256, (h, w, 3), np.uint8)
    rgb[:, 3:10] = rgb[:, 3:4]
    files["pcx_rgb.pcx"] = pcx_bytes(rgb, 8, 3)
    files["pcx_rgb_even.pcx"] = pcx_bytes(rgb[:, :12], 8, 3)
    # SGI: run-length coded, 8 and 16 bits, 1-4 channels
    for z in (1, 3, 4):                      # PIL has no 2-channel mode
        for bpc in (1, 2):
            img = g.integers(0, 256 if bpc == 1 else 65536, (h, w, z))
            img[:, 4:11] = img[:, 4:5]
            files[f"sgi_rle_{z}ch_{8 * bpc}.sgi"] = sgi_bytes(
                img.astype(np.uint8 if bpc == 1 else np.uint16), bpc)
    files["sgi_raw_16.sgi"] = sgi_bytes(g.integers(0, 65536, (h, w, 3))
                                        .astype(np.uint16), 2, rle=False)
    # MSP
    bits = g.random((h, 27)) > 0.5
    bits[:, 8:24] = True
    bits[2] = True
    files["msp_v2.msp"] = msp_bytes(bits)
    files["msp_v1.msp"] = msp_bytes(bits, v2=False)
    # PSD: every mode PIL maps but Lab (below), raw and PackBits
    for pmode, nb, nch, name in ((0, 1, 1, "bitmap"), (1, 8, 1, "grey"),
                                 (2, 8, 1, "indexed"), (3, 8, 3, "rgb"),
                                 (3, 8, 4, "rgba"), (3, 8, 5, "rgb5"),
                                 (4, 8, 4, "cmyk"), (4, 8, 5, "cmyk5"),
                                 (7, 8, 2, "multichannel"),
                                 (8, 8, 1, "duotone")):
        line = (w + 7) // 8 if nb == 1 else w
        planes = [g.integers(0, 256, (h, line), np.uint8) for _ in range(nch)]
        for p in planes:
            p[:, :5] = p[:, :1]
        cmd = g.integers(0, 256, 768, np.uint8).tobytes() if pmode == 2 \
            else b""
        res = b"8BIM" + struct.pack(">HH", 1005, 0) + struct.pack(">I", 3) + \
            b"abc\0"
        for comp in (0, 1) if name != "cmyk5" else (0,):
            # (PIL reads a 5-channel CMYK file's byte counts as 4
            # channels', so its PackBits data as cut short)
            files[f"psd_{name}_{('raw', 'packbits')[comp]}.psd"] = psd_bytes(
                pmode, nb, planes, w, h, comp, cmd, res)
    # XPM
    cols = [int(c) for c in g.integers(0, 1 << 24, 300)]
    files["xpm_16.xpm"] = xpm_bytes(g.integers(0, 16, (h, w)), cols[:16])
    files["xpm_300.xpm"] = xpm_bytes(g.integers(0, 300, (h, w)), cols, 2)
    files["xpm_none.xpm"] = xpm_bytes(np.array([[0, 2, 2], [2, 0, 0]]),
                                      [cols[0], None, cols[1]])
    # DDS: every pixel format
    a = g.integers(0, 256, (h, w, 4), np.uint8)
    nbk = ((w + 3) // 4) * ((h + 3) // 4)
    for bc, masks, name in ((16, (0xF800, 0x7E0, 0x1F, 0), "565"),
                            (16, (0x7C00, 0x3E0, 0x1F, 0x8000), "1555"),
                            (32, (0x3FF, 0xFFC00, 0x3FF00000, 0), "10_10_10"),
                            (24, (0xFF, 0xFF00, 0xFF0000, 0), "rgb24"),
                            (8, (0xE0, 0x1C, 0x3, 0), "332")):
        files[f"dds_{name}.dds"] = dds_bytes(
            w, h, 0x41 if masks[3] else 0x40, g.integers(
                0, 256, w * h * bc // 8, np.uint8).tobytes(),
            bitcount=bc, masks=masks)
    files["dds_l8.dds"] = dds_bytes(w, h, 0x20000, a[..., 0].tobytes(),
                                    bitcount=8)
    files["dds_la8.dds"] = dds_bytes(w, h, 0x20001, a[..., :2].tobytes(),
                                     bitcount=16)
    files["dds_p8.dds"] = dds_bytes(w, h, 0x20, g.integers(
        0, 256, 1024, np.uint8).tobytes() + a[..., 0].tobytes(), bitcount=8)
    for fourcc, size in ((b"DXT1", 8), (b"DXT3", 16), (b"DXT5", 16),
                         (b"BC4U", 8), (b"ATI2", 16), (b"BC5S", 16)):
        files[f"dds_{fourcc.decode().lower()}.dds"] = dds_bytes(
            w, h, 4, g.integers(0, 256, nbk * size, np.uint8).tobytes(),
            fourcc)
    files["dds_rgba_dx10.dds"] = dds_dx10(w, h, 28, a.tobytes())
    for dxgi, name in ((95, "bc6h"), (96, "bc6h_signed"), (98, "bc7_random")):
        blocks = g.integers(0, 256, (64, 16), np.uint8)
        if name != "bc7_random":   # every mode, the reserved ones included
            modes = [0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23,
                     27, 31]
            for i, m in enumerate(modes * 4):
                keep = 0xFC if m < 2 else 0xE0
                blocks[i % 64, 0] = (int(blocks[i % 64, 0]) & keep) | m
        else:                      # every mode, and no mode bit
            for i in range(64):
                m = i % 9
                blocks[i, 0] = 0 if m == 8 else \
                    (int(blocks[i, 0]) & (0xFF ^ ((2 << m) - 1))) | 1 << m
        files[f"dds_{name}.dds"] = dds_dx10(32, 32, dxgi, blocks.tobytes())
    # Sun raster, by PIL's rules
    body = g.integers(0, 256, h * 16, np.uint8).tobytes()
    files["sun_8_cmap.ras"] = sun_bytes(w, h, 8, body, cmap=g.integers(
        0, 256, 3 * 200, np.uint8).tobytes())
    files["sun_4.ras"] = sun_bytes(w, h, 4, body)
    files["sun_24_rle.ras"] = sun_bytes(
        5, 3, 24, b"\x80\x10\x07\x01\x80\x00\x02" + bytes(range(40)), typ=2)
    # ICNS: packed RGB with its mask, raw and run-length coded
    px = g.integers(0, 256, (16 * 16, 3), np.uint8)
    px[:60] = px[0]
    files["icns_is32.icns"] = icns_bytes([(b"is32", px.tobytes()),
                                          (b"s8mk", bytes(256))])
    files["icns_is32_rle.icns"] = icns_bytes(
        [(b"is32", b"".join(icns_rle(px[:, c].tobytes()) for c in range(3))),
         (b"s8mk", bytes(256))])
    # CUR
    for mode in ("RGB", "P", "1"):
        files[f"cur_{mode.lower()}.cur"] = cur_bytes(a[:6, :10], mode)
    # the scenes' twins
    files["checker.qoi"] = _save(Image.fromarray(checker), "QOI")
    files["bumps.ppm"] = _save(Image.fromarray(bumps), "PPM")
    files["checker_rle.sgi"] = sgi_bytes(checker)
    files["projector_bmp.ico"] = _save(Image.fromarray(projector, "RGBA"),
                                       "ICO", sizes=[(128, 64)],
                                       bitmap_format="bmp")
    rgba = np.concatenate([checker, np.full(checker.shape[:2] + (1,), 255,
                                            np.uint8)], -1)
    files["checker_bc7.dds"] = dds_dx10(64, 64, 98, bc7_encode(rgba))
    # IM: the types PIL reads through its bit decoder, the three-plane and
    # the YCC ones (their own seed, after the files above)
    gi = np.random.default_rng(1701)
    for itype, name, nbytes in (("L*12 image", "l12", (w * 12 + 7) // 8 * h),
                                ("L*5 image", "l5", (w * 5 + 7) // 8 * h),
                                ("L*24 image", "l24", w * 3 * h),
                                ("RGB3 image", "rgb3", 3 * w * h),
                                ("RYB3 image", "ryb3", 3 * w * h),
                                ("YCC image", "ycc", 3 * w * h)):
        files[f"im_{name}.im"] = im_bytes(itype, w, h, gi.integers(
            0, 256, nbytes, np.uint8).tobytes())
    # PSD in Lab mode (PIL converts it through LittleCMS)
    lab = [gi.integers(0, 256, (h, w), np.uint8) for _ in range(3)]
    for comp in (0, 1):
        files[f"psd_lab_{('raw', 'packbits')[comp]}.psd"] = psd_bytes(
            9, 8, lab, w, h, comp)
    return files


def write_pil_files(out, checker, bumps, projector):
    """The files of `pil_files`, `checker_bc7_pil.png` and
    `pil_decodes.npz`: PIL's decode of each (by path), and the sha256 and
    corner of PIL's decode of `bc7_timing()`."""
    from PIL import Image
    dec = {}
    for fn, data in pil_files(checker, bumps, projector).items():
        p = os.path.join(out, fn)
        with open(p, "wb") as f:
            f.write(data)
        with Image.open(p) as im:
            dec[fn] = np.asarray(im.convert("RGB"))
    for fn, want in (("checker.qoi", checker), ("bumps.ppm", bumps),
                     ("checker_rle.sgi", checker),
                     ("projector_bmp.ico", projector[..., :3])):
        assert np.array_equal(dec[fn], want), fn
    Image.fromarray(dec["checker_bc7.dds"]).save(
        os.path.join(out, "checker_bc7_pil.png"))
    with Image.open(io.BytesIO(bc7_timing())) as im:
        full = np.asarray(im.convert("RGB"))
    dec["bc7_2048.dds:sha256"] = np.frombuffer(
        hashlib.sha256(full.tobytes()).digest(), np.uint8)
    dec["bc7_2048.dds:corner"] = full[:CORNER, :CORNER]
    np.savez_compressed(os.path.join(out, "pil_decodes.npz"), **dec)


def main():
    from PIL import Image
    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    os.makedirs(out, exist_ok=True)
    with Image.open(os.path.join(out, "checker.png")) as im:
        checker = np.asarray(im.convert("RGB"))
    with Image.open(os.path.join(out, "bumps.png")) as im:
        bumps = np.asarray(im.convert("RGB"))
    with Image.open(os.path.join(out, "projector.png")) as im:
        projector = np.asarray(im)
    write_pil_files(out, checker, bumps, projector)


if __name__ == "__main__":
    main()
