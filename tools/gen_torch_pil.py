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
BLP_TIMING_SEED = 2049
PCD_SEED = 7607
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
# encoders of slice 7e.6b's formats (PIL writes none of them but BLP's
# palette files)
# ---------------------------------------------------------------------------

def blp_bytes(w, h, level, version=2, comp=1, enc=1, alpha=0, alpha_enc=0,
              palette=None, offset=None, length=None, jpeg_header=None):
    """BLP bytes: the header (BLP1's 28 or BLP2's 20 bytes; `alpha` the
    alpha depth), the 16 mip offsets and lengths (the first `offset` /
    `length`, by default where `level` lies and its size), BLP2's or a
    palette BLP1's 256 BGRA palette entries (`palette` bytes), or BLP1
    JPEG's header size and `jpeg_header`; then `level`."""
    if version == 1:
        head = b"BLP1" + struct.pack("<iIIIii", comp, alpha, w, h, enc, 0)
    else:
        head = b"BLP2" + struct.pack("<ibbbbII", comp, enc, alpha, alpha_enc,
                                     0, w, h)
    if jpeg_header is not None:
        mid = struct.pack("<I", len(jpeg_header)) + jpeg_header
    else:
        mid = palette if palette is not None else bytes(1024)
    at = len(head) + 128 + len(mid)
    offsets = [at if offset is None else offset] + [0] * 15
    lengths = [len(level) if length is None else length] + [0] * 15
    return head + struct.pack("<16I", *offsets) + \
        struct.pack("<16I", *lengths) + mid + level


def blp_dxt_timing(n=2048, seed=BLP_TIMING_SEED):
    """A BLP2 DXT5 file of n x n pixels of random blocks, from the PCG64
    stream of `seed` (PIL decodes it with its Python decoder)."""
    raw = np.random.PCG64(seed).random_raw(n * n // 8)
    return blp_bytes(n, n, raw.astype("<u8").tobytes(), enc=2, alpha=8,
                     alpha_enc=7)


def fli_chunk(kind, body):
    """A FLI subchunk: its size (6 + the body), its type, the body."""
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_colour(entries, six_bit=False, skip=0):
    """A colour chunk (11 at 6 bits, else 4) of one packet: `skip`
    entries, then the RGB rows `entries` (uint8 [n, 3], n <= 256)."""
    body = struct.pack("<HBB", 1, skip, len(entries) % 256) + \
        np.asarray(entries, np.uint8).tobytes()
    return fli_chunk(11 if six_bit else 4, body)


def fli_brun(img):
    """A BRUN chunk (15) of img uint8 [h, w]: each line runs of one value
    (n < 128) and literal runs (256 - n bytes), its packet count 0."""
    body = bytearray()
    for row in img:
        body.append(0)
        x = 0
        while x < len(row):
            j = x
            while j < len(row) and row[j] == row[x] and j - x < 127:
                j += 1
            if j - x >= 3:
                body += bytes((j - x, row[x]))
                x = j
                continue
            k = x
            while k < len(row) and k - x < 128 and not (
                    k + 2 < len(row) and row[k] == row[k + 1] == row[k + 2]):
                k += 1
            k = max(k, x + 1)
            body += bytes((256 - (k - x),)) + bytes(row[x:k])
            x = k
    return fli_chunk(15, bytes(body))


def fli_lc(img, y0, base):
    """An LC chunk (12): the lines of img from y0 on as byte deltas from
    `base` (skips over equal bytes, literal copies of the rest)."""
    body = bytearray(struct.pack("<HH", y0, len(img) - y0))
    for y in range(y0, len(img)):
        packets = bytearray()
        n = 0
        x = 0
        row, old = img[y], base[y]
        while x < len(row):
            s = x
            while s < len(row) and row[s] == old[s] and s - x < 255:
                s += 1
            if s == len(row):
                break
            k = s
            while k < len(row) and row[k] != old[k] and k - s < 127:
                k += 1
            packets += bytes((s - x, k - s)) + bytes(row[s:k])
            n += 1
            x = k
        body += bytes((n,)) + packets
    return fli_chunk(12, bytes(body))


def fli_ss2(img, base):
    """An SS2 chunk (7): each line (of an even width) as word deltas from
    `base` (skips of byte pairs, literal words)."""
    h, w = img.shape
    body = bytearray(struct.pack("<H", h))
    for y in range(h):
        packets = bytearray()
        n = 0
        x = 0
        while x < w:
            s = x
            while s < w and (img[y, s:s + 2] == base[y, s:s + 2]).all() and \
                    s - x < 254:
                s += 2
            if s >= w:
                break
            k = s
            while k < w and k - s < 254:
                k += 2
            packets += bytes((s - x, (k - s) // 2)) + bytes(img[y, s:k])
            n += 1
            x = k
        body += struct.pack("<H", n) + packets
    return fli_chunk(7, bytes(body))


def fli_bytes(w, h, chunks, magic=0xAF12, prefix=None, frames=()):
    """A FLI (0xAF11) or FLC (0xAF12) file: the 128-byte header, an
    optional 0xF100 prefix chunk of `prefix` bytes, the first frame of
    `chunks`, then `frames` (more frames' chunk lists)."""
    def frame(cs):
        body = b"".join(cs)
        return struct.pack("<IHH8x", 16 + len(body), 0xF1FA, len(cs)) + body
    body = b""
    if prefix is not None:
        body = struct.pack("<IH", 6 + len(prefix), 0xF100) + prefix
    body += frame(chunks) + b"".join(frame(cs) for cs in frames)
    head = bytearray(128)
    struct.pack_into("<IHHHHHH", head, 0, 128 + len(body), magic,
                     1 + len(frames), w, h, 8, 0)
    return bytes(head) + body


def fits_bytes(bits, x, cards=(), naxis=2):
    """A FITS file: SIMPLE, BITPIX, NAXIS (NAXIS1 = x's width, NAXIS2 its
    height), `cards` ((key, value) pairs), END, padded to 2880 bytes;
    then x's bytes as they are (big-endian as FITS stores them) in file
    order, padded."""
    h, w = x.shape[:2]
    keys = [("SIMPLE", "T"), ("BITPIX", str(bits)), ("NAXIS", str(naxis))]
    keys += [("NAXIS1", str(w)), ("NAXIS2", str(h))][:naxis]
    keys += list(cards)
    head = b"".join(f"{k:8s}= {v:>20s}".ljust(80).encode() for k, v in keys)
    head += b"END".ljust(80)
    body = np.ascontiguousarray(x).tobytes()
    return head.ljust(-(-len(head) // 2880) * 2880) + \
        body.ljust(-(-len(body) // 2880) * 2880, b"\0")


def fits_gzip_bytes(zbits, values, table_rows=1, level=6):
    """A FITS file of an empty primary header and a compressed image
    extension (BINTABLE, ZIMAGE = T, ZCMPTYPE GZIP_1): a table of
    `table_rows` 8-byte rows, then the gzip of `values` (big-endian int32
    [h, w], 4 bytes a sample as PIL's decoder reads them)."""
    import gzip
    h, w = values.shape
    prim = [("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "0")]
    ext = [("XTENSION", "'BINTABLE'"), ("BITPIX", "8"), ("NAXIS", "2"),
           ("NAXIS1", "8"), ("NAXIS2", str(table_rows)),
           ("ZIMAGE", "T"), ("ZCMPTYPE", "'GZIP_1  '"),
           ("ZBITPIX", str(zbits)), ("ZNAXIS", "2"),
           ("ZNAXIS1", str(w)), ("ZNAXIS2", str(h))]

    def unit(keys):
        s = b"".join(f"{k:8s}= {v:>20s}".ljust(80).encode() for k, v in keys)
        s += b"END".ljust(80)
        return s.ljust(-(-len(s) // 2880) * 2880)
    z = gzip.compress(values.astype(">i4").tobytes(), level, mtime=0)
    return unit(prim) + unit(ext) + bytes(8 * table_rows) + z


def ftex_bytes(fmt, w, h, payload, size=None):
    """A FTEX file of one format (0 DXT1, 1 raw RGB) and one mip level."""
    return b"FTEX" + struct.pack("<7i", 1, w, h, 1, 1, fmt, 32) + \
        struct.pack("<i", len(payload) if size is None else size) + payload


def gbr_bytes(img, version=2, comment=b"brush\0", spacing=10):
    """A GIMP brush of img (uint8 [h, w] grey, or [h, w, 4] RGBA)."""
    h, w = img.shape[:2]
    depth = 1 if img.ndim == 2 else 4
    if version == 1:
        head = struct.pack(">5I", 20 + len(comment), 1, w, h, depth)
    else:
        head = struct.pack(">5I", 28 + len(comment), 2, w, h, depth) + \
            b"GIMP" + struct.pack(">I", spacing)
    return head + comment + np.ascontiguousarray(img, np.uint8).tobytes()


def imt_bytes(v, fields=None):
    """An IM Tools file of grey pixels v (uint8 [h, w])."""
    h, w = v.shape
    head = fields if fields is not None else \
        b"* IM Tools\nwidth %d\nheight %d\npixel n8\n" % (w, h)
    return head + b"\x0c" + v.tobytes()


def iptc_field(rec, tag, data, ext=None):
    """An IPTC field: 0x1C, record, tag, its size (16 bits, or `ext` bytes
    of an extended size), the data."""
    if ext:
        return bytes((0x1C, rec, tag, 0x80 + ext)) + \
            len(data).to_bytes(ext, "big") + data
    return bytes((0x1C, rec, tag)) + struct.pack(">H", len(data)) + data


def iptc_bytes(w, h, image, layers=1, component=0, comp=1, band=None,
               split=3000):
    """An IPTC/NAA file: the image's layers, size and compression fields,
    then `image` in (8, 10) records of at most `split` bytes."""
    f = iptc_field(2, 0, b"\0\2") + iptc_field(3, 60, bytes((layers,
                                                             component)))
    f += iptc_field(3, 20, struct.pack(">I", w)) + \
        iptc_field(3, 30, struct.pack(">H", h)) + \
        iptc_field(3, 120, bytes((comp,)))
    if band is not None:
        f += iptc_field(3, 65, bytes((band,)))
    return f + b"".join(iptc_field(8, 10, image[i:i + split])
                        for i in range(0, max(len(image), 1), split))


def mcidas_bytes(x, prefix=0, offset=256):
    """A McIdas area file of x (uint8, >u2 or >i4 [h, w]): each line
    behind `prefix` bytes, the data at `offset`."""
    h, w = x.shape
    nb = x.dtype.itemsize
    v = [0] * 65
    v[2] = 4
    v[9], v[10], v[11], v[14], v[15], v[34] = h, w, nb, 1, prefix, offset
    head = struct.pack(">64i", *v[1:])
    lines = b"".join(bytes(prefix) + r.tobytes() for r in x)
    return head.ljust(offset, b"\0") + lines


def pcd_bytes(seed, orientation=0, ycc=None):
    """A PhotoCD file of 96 x 2048 + 256 x 2304 bytes: its "PCD_IPI"
    signature, the orientation byte, the base image's luma rows and half
    chroma rows (PcdDecode.c's layout) from `ycc` (uint8 [256, 2304]) or
    the PCG64 stream of `seed`."""
    g = np.random.Generator(np.random.PCG64(seed))
    body = g.integers(0, 256, (256, 2304), np.uint8) if ycc is None else ycc
    head = bytearray(96 * 2048)
    head[2048:2055] = b"PCD_IPI"
    head[2048 + 1538] = orientation
    return bytes(head) + body.tobytes()


def pixar_bytes(img):
    """A PIXAR raster file of RGB pixels img (uint8 [h, w, 3])."""
    h, w = img.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\0\0"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, 14, 2)
    return bytes(head) + np.ascontiguousarray(img, np.uint8).tobytes()


def xvthumb_bytes(v, comments=(b"#XVVERSION:Version 2.28",)):
    """An XV thumbnail of 3-3-2 indices v (uint8 [h, w])."""
    h, w = v.shape
    return b"P7 332\n" + b"".join(c + b"\n" for c in comments) + \
        b"#END_OF_COMMENTS\n%d %d 255\n" % (w, h) + v.tobytes()


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


def _jpeg(img, mode, **kw):
    """PIL's JPEG of img converted to `mode` -> (the bytes before the first
    scan, the rest)."""
    from PIL import Image
    data = _save(Image.fromarray(img).convert(mode), "JPEG", **kw)
    k = data.index(b"\xff\xda")
    return data[:k], data[k:]


def _palette_of(img):
    """img uint8 [h, w, 3] of at most 256 colours -> (uint8 [n, 3] its
    colours, uint8 [h, w] each pixel's index)."""
    cols, idx = np.unique(img.reshape(-1, 3), axis=0, return_inverse=True)
    return cols.astype(np.uint8), idx.reshape(img.shape[:2]).astype(np.uint8)


def pcd_file(seed=PCD_SEED):
    """The PhotoCD file `chip_smoke.py` and the tests build (786,432 bytes:
    a base image of random PhotoYCC samples), turned 90 degrees."""
    return pcd_bytes(seed, 1)


def pil_rare_files(checker, bumps, projector):
    """name -> bytes of slice 7e.6b's committed files (each format's
    variants at odd sizes, from seed 7606, and the twins of the scenes'
    PNGs)."""
    g = np.random.default_rng(7606)
    files = {}
    h, w = 7, 13
    pal = g.integers(0, 256, 1024, np.uint8).tobytes()
    idx = g.integers(0, 256, w * h, np.uint8).tobytes()
    # BLP: BLP2 palettes at each alpha depth, BLP1 palette encodings 4 / 5
    for alpha in (0, 1, 8):
        files[f"blp2_pal_a{alpha}.blp"] = blp_bytes(w, h, idx, alpha=alpha,
                                                    palette=pal)
    for enc, alpha in ((4, 0), (5, 8)):
        files[f"blp1_pal{enc}.blp"] = blp_bytes(w, h, idx, 1, enc=enc,
                                                alpha=alpha, palette=pal)
    # BLP2 DXT1 / 3 / 5 through PIL's Python decoders, with and without
    # alpha (RGBA blocks read as RGB where the header sets no alpha)
    for ae, size in ((0, 8), (1, 16), (7, 16)):
        for alpha in (0, 8):
            n = ((w + 3) // 4) * ((h + 3) // 4) * size
            files[f"blp2_dxt{(1, 3, 5)[size // 16 + ae // 7]}_a{alpha}.blp"] = blp_bytes(
                w, h, g.integers(0, 256, n, np.uint8).tobytes(), enc=2,
                alpha=alpha, alpha_enc=ae, palette=pal)
    # BLP1 JPEG: PIL's JPEG split into the header and the level; grey,
    # colour, and CMYK (read as CMYK, its samples inverted, then as BGR)
    img = g.integers(0, 256, (16, 24, 3), np.uint8)
    img[:, :12] = img[:, :1]
    for mode in ("L", "RGB", "CMYK"):
        head, level = _jpeg(img, mode, quality=90)
        files[f"blp1_jpeg_{mode.lower()}.blp"] = blp_bytes(
            24, 16, level, 1, comp=0, jpeg_header=head)
    head, level = _jpeg(img, "RGB", quality=90)
    files["blp1_jpeg_w20.blp"] = blp_bytes(20, 15, level, 1, comp=0,
                                           alpha=1, jpeg_header=head)
    # FLI / FLC: the first frame's chunks, the palette search
    fh, fw = 9, 14
    a = g.integers(0, 256, (fh, fw), np.uint8)
    a[:, 3:11] = a[:, 3:4]
    b = a.copy()
    b[2:6, 4:10] = g.integers(0, 256, (4, 6))
    p8 = g.integers(0, 256, (256, 3), np.uint8)
    files["fli_brun_6bit.fli"] = fli_bytes(fw, fh, [
        fli_colour(p8 // 4, six_bit=True), fli_brun(a)], 0xAF11)
    files["flc_lc.flc"] = fli_bytes(fw, fh, [
        fli_brun(a), fli_lc(b, 2, a), fli_colour(p8[:40], skip=7)])
    files["flc_ss2.flc"] = fli_bytes(fw, fh, [
        fli_colour(p8), fli_chunk(16, a.tobytes()), fli_ss2(b, a),
        fli_chunk(18, bytes(12))])
    files["flc_black.flc"] = fli_bytes(fw, fh, [
        fli_colour(p8), fli_brun(a), fli_chunk(13, b""), fli_lc(b, 3, a)],
        frames=[[fli_lc(a, 0, b)]])
    # FITS: every BITPIX, gzip tiles
    for bits, dt in ((8, np.uint8), (16, ">i2"), (32, ">i4"), (-32, ">f4"),
                     (-64, ">f8")):
        if bits > 8:
            x = g.integers(-400, 400, (h, w)).astype(dt)
        elif bits == 8:
            x = g.integers(0, 256, (h, w)).astype(dt)
        else:
            x = g.normal(100, 150, (h, w)).astype(dt)
        files[f"fits_{bits}.fits".replace("-", "f")] = fits_bytes(
            bits, x, [("BZERO", "32768"), ("BSCALE", "2")])
    for zb in (16, 32):
        files[f"fits_gz{zb}.fits"] = fits_gzip_bytes(
            zb, g.integers(-70000, 70000, (h, w)))
    # FTEX, GBR, IMT, McIdas, PIXAR, XV thumbnails
    nbk = ((w + 3) // 4) * ((h + 3) // 4)
    files["ftex_dxt1.ftc"] = ftex_bytes(0, w, h, g.integers(
        0, 256, 8 * nbk, np.uint8).tobytes())
    files["ftex_rgb.ftu"] = ftex_bytes(1, w, h, g.integers(
        0, 256, 3 * w * h, np.uint8).tobytes())
    files["gbr_v1_grey.gbr"] = gbr_bytes(g.integers(0, 256, (h, w),
                                                    np.uint8), 1)
    files["gbr_v2_rgba.gbr"] = gbr_bytes(g.integers(0, 256, (h, w, 4),
                                                    np.uint8))
    files["imt_grey.imt"] = imt_bytes(g.integers(0, 256, (h, w), np.uint8))
    for dt in (np.uint8, ">u2", ">i4"):
        nb = np.dtype(dt).itemsize
        x = g.integers(0, 300, (h, w)) if nb < 4 else \
            g.integers(-200, 400, (h, w))
        files[f"mcidas_{8 * nb}.area"] = mcidas_bytes(x.astype(dt), 2 * nb)
    files["pixar_rgb.pxr"] = pixar_bytes(g.integers(0, 256, (h, w, 3),
                                                    np.uint8))
    files["xvthumb.xvt"] = xvthumb_bytes(g.integers(0, 256, (h, w),
                                                    np.uint8))
    # IPTC: raw grey, raw into a CMYK file's band, a grey JPEG into an RGB
    # file's band, a colour JPEG as a grey file's image
    v = g.integers(0, 256, (h, w), np.uint8)
    files["iptc_raw_grey.iim"] = iptc_bytes(w, h, v.tobytes(), split=40)
    files["iptc_raw_cmyk.iim"] = iptc_bytes(w, h, v.tobytes(), 4, 1, band=2)
    head, level = _jpeg(img, "L", quality=90)
    files["iptc_jpeg_rgb.iim"] = iptc_bytes(24, 16, head + level, 3, 1,
                                            comp=5, band=3, split=300)
    head, level = _jpeg(img, "RGB", quality=90)
    files["iptc_jpeg_grey.iim"] = iptc_bytes(24, 16, head + level, comp=5)
    # the twins of the scenes' PNGs: the same pixels
    cols, ci = _palette_of(checker)
    bgra = np.zeros((256, 4), np.uint8)
    bgra[:len(cols), :3] = cols[:, ::-1]
    files["checker.blp"] = blp_bytes(checker.shape[1], checker.shape[0],
                                     ci.tobytes(), palette=bgra.tobytes())
    files["checker.flc"] = fli_bytes(checker.shape[1], checker.shape[0],
                                     [fli_colour(cols), fli_brun(ci)])
    files["bumps.gbr"] = gbr_bytes(np.concatenate(
        [bumps, np.full(bumps.shape[:2] + (1,), 255, np.uint8)], -1))
    files["projector.pxr"] = pixar_bytes(projector[..., :3])
    return files


def write_pil_rare_files(out, checker, bumps, projector):
    """The files of `pil_rare_files` and `pil_rare_decodes.npz`: PIL's
    decode of each (by path), and the sha256 and corner of PIL's decodes
    of `blp_dxt_timing()` and `pcd_file()` (built at run time, not
    committed)."""
    from PIL import Image
    dec = {}
    for fn, data in pil_rare_files(checker, bumps, projector).items():
        p = os.path.join(out, fn)
        with open(p, "wb") as f:
            f.write(data)
        with Image.open(p) as im:
            dec[fn] = np.asarray(im.convert("RGB"))
    for fn, want in (("checker.blp", checker), ("checker.flc", checker),
                     ("bumps.gbr", bumps),
                     ("projector.pxr", projector[..., :3])):
        assert np.array_equal(dec[fn], want), fn
    for fn, make in (("blp_2048.blp", blp_dxt_timing),
                     ("photocd.pcd", pcd_file)):
        with Image.open(io.BytesIO(make())) as im:
            full = np.asarray(im.convert("RGB"))
        dec[fn + ":sha256"] = np.frombuffer(
            hashlib.sha256(full.tobytes()).digest(), np.uint8)
        dec[fn + ":corner"] = full[:CORNER, :CORNER]
    np.savez_compressed(os.path.join(out, "pil_rare_decodes.npz"), **dec)


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


def pcd_ycc_tables():
    """PIL's "YCC;P" unpacker (PhotoCD's PhotoYCC -> RGB) read back as its
    five tables: every (Y, C1, C2) triple through PIL, then R = L[Y] +
    CR[C2], B = L[Y] + CB[C1] and G = L[Y] + GB[C1] + GR[C2] (each clipped
    to 0..255) solved on the unclipped samples, L[0] and GB[156] taken as
    0 (a constant moved between tables changes no sum). Checked against
    all 2^24 triples."""
    from PIL import Image
    i = np.arange(1 << 24, dtype=np.uint32)
    trip = np.stack([i >> 16, (i >> 8) & 255, i & 255], -1).astype(np.uint8)
    out = np.asarray(Image.frombytes("RGB", (4096, 4096), trip.tobytes(),
                                     "raw", "YCC;P")).reshape(256, 256, 256, 3)
    out = out.astype(np.int64)

    none = np.iinfo(np.int64).min

    def split(t, ok):
        """t[a, b] = A[a] + B[b] where ok -> (A, B), A[0] = 0."""
        a = np.full(256, none)
        b = a.copy()
        a[0] = 0
        while True:
            was = (a.copy(), b.copy())
            got = np.where(ok & (a != none)[:, None], t - a[:, None], none)
            b = np.where(b == none, got.max(0), b)
            got = np.where(ok & (b != none)[None, :], t - b[None, :], none)
            a = np.where(a == none, got.max(1), a)
            if (a == was[0]).all() and (b == was[1]).all():
                break
        assert (a != none).all() and (b != none).all()
        return a, b

    def unclipped(t):
        return (t > 0) & (t < 255)

    lum, cr = split(out[:, 0, :, 0], unclipped(out[:, 0, :, 0]))
    lum_b, cb = split(out[:, :, 0, 2], unclipped(out[:, :, 0, 2]))
    assert (lum == lum_b).all()
    g = out[..., 1] - lum[:, None, None]
    pair = np.where(unclipped(out[..., 1]), g, none).max(0)   # [c1, c2]
    gb, gr = split(pair, pair != none)
    gb, gr = gb - gb[156], gr + gb[156]
    t = dict(L=lum, CB=cb, GB=gb, CR=cr, GR=gr)
    y = lum[:, None, None]
    rgb = np.stack(np.broadcast_arrays(
        y + cr[None, None, :], y + gb[None, :, None] + gr[None, None, :],
        y + cb[None, :, None]), -1)
    assert (np.clip(rgb, 0, 255) == out).all()
    return {k: v.astype(np.int16) for k, v in t.items()}


def write_pcd_ycc(path=os.path.join(ROOT, "vision_tpu_torch", "data",
                                    "pcd_ycc.npz")):
    np.savez_compressed(path, **pcd_ycc_tables())


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
    write_pil_rare_files(out, checker, bumps, projector)


if __name__ == "__main__":
    main()
