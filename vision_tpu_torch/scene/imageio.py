"""Image files without PIL, OpenCV or OpenEXR: the standard library's zlib
and struct, and numpy.

The JAX package reads PNG and JPEG through PIL and Radiance .hdr and
OpenEXR through OpenCV (`vision_tpu/scene/texture.py` `load_image`). This
module decodes what those libraries give for the files a scene names:

  * PNG (`read_png`): non-interlaced; bit depth 8 for colour types 0
    (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA), bit depth
    16 for types 2 and 6; every filter type; any number of IDAT chunks.
    The result is `PIL.Image.open(p).convert("RGB")`: alpha dropped (not
    composited), a palette expanded, grey replicated to three channels,
    16-bit samples cut to their high byte. Any other kind of PNG raises
    NotImplementedError.
  * Radiance .hdr (`read_hdr`): the `#?RADIANCE` / `#?RGBE` header, the
    `-Y H +X W` orientation, new-style run-length and flat scanlines,
    decoded as OpenCV decodes them: m * 2^(e - 136), no +0.5, e = 0 is 0;
    RGB order.
  * OpenEXR (`read_exr`): single-part scanline files, compression NONE,
    ZIPS and ZIP, HALF and FLOAT channels; R, G, B (A dropped) or Y
    (replicated). PIZ and the other compressions, tiled, deep and
    multi-part files raise NotImplementedError.
  * `write_exr`: a single-part scanline OpenEXR of uncompressed FLOAT B, G,
    R channels.

JPEG raises NotImplementedError: a baseline JPEG decoder is ROADMAP queue
A, slice 7b.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
EXR_MAGIC = 20000630


def _not_ported(what, slice_):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP queue A, slice {slice_}")


def read_image(path):
    """Decode `path` by its content: (array, kind) where kind is "ldr" (a
    uint8 [H, W, 3] RGB array) or "hdr" (float32 [H, W, 3] RGB). Raises
    FileNotFoundError for a missing file, NotImplementedError for a format
    or a variant this module does not decode, ValueError for a corrupt
    file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        return read_png(data), "ldr"
    if data[:2] == b"#?":
        return read_hdr(data), "hdr"
    if len(data) >= 4 and struct.unpack("<i", data[:4])[0] == EXR_MAGIC:
        return read_exr(data), "hdr"
    if data[:3] == b"\xff\xd8\xff":
        raise _not_ported(f"decoding the JPEG '{os.path.basename(path)}' "
                          "(a baseline JPEG decoder)", "7b")
    raise NotImplementedError(
        f"'{os.path.basename(path)}': not a PNG, Radiance .hdr or OpenEXR "
        "file; no other image format is decoded")


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

# colour type -> samples per pixel
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (8,), 2: (8, 16), 3: (8,), 4: (8,), 6: (8, 16)}


def _png_chunks(data):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n


def _unfilter(raw, h, stride, bpp):
    """Undo the per-row PNG filters of `raw` (h rows of 1 + stride bytes).
    A byte depends on the bytes of its left, upper and upper-left
    neighbour pixels, so every pixel of one anti-diagonal (x + y = d)
    reconstructs at once: h + w - 1 vectorised steps, whatever each row's
    filter (None, Sub, Up, Average or Paeth)."""
    rows = raw.reshape(h, 1 + stride)
    ft = rows[:, 0].astype(np.int64)
    if (ft > 4).any():
        raise ValueError(f"PNG filter type {int(ft.max())}")
    w = stride // bpp
    F = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    X = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row above, column left
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, c = X[y + 1, x], X[y, x + 1], X[y, x]  # left, up, up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        preds = np.stack([np.zeros_like(a), a, b, (a + b) >> 1, paeth])
        X[y + 1, x + 1] = (F[y, x] + preds[ft[y], np.arange(len(y))]) & 0xFF
    return X[1:, 1:].reshape(h, stride).astype(np.uint8)


def read_png(data):
    """PNG bytes -> uint8 [H, W, 3], as PIL's convert("RGB") gives them."""
    ihdr, plte, idat = None, None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if interlace != 0:
        raise NotImplementedError("interlaced (Adam7) PNG files are not decoded")
    if ctype not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[ctype]:
        raise NotImplementedError(
            f"PNG colour type {ctype} at bit depth {depth} is not decoded")
    if comp != 0 or filt != 0:
        raise ValueError("PNG compression or filter method")
    nch = _PNG_CHANNELS[ctype]
    bpp = nch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (1 + w * bpp):
        raise ValueError("truncated PNG image data")
    px = _unfilter(raw[:h * (1 + w * bpp)], h, w * bpp, bpp)
    if depth == 16:
        px = px.reshape(h, w, nch, 2)[..., 0]  # the high byte of each sample
    px = px.reshape(h, w, nch)
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte[:256]
        return pal[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


# ---------------------------------------------------------------------------
# Radiance .hdr (RGBE)
# ---------------------------------------------------------------------------

def _rgbe_scanline(data, pos, w):
    """One scanline at `pos` -> (uint8 [w, 4], next pos): new-style
    run-length (2, 2, w >> 8, w & 255, then four runs of channels) or flat."""
    head = data[pos:pos + 4]
    if (8 <= w < 0x8000 and len(head) == 4 and head[0] == 2 and head[1] == 2
            and not head[2] & 0x80):
        if (head[2] << 8 | head[3]) != w:
            raise ValueError("RGBE scanline width mismatch")
        pos += 4
        line = np.empty((4, w), np.uint8)
        for c in range(4):
            x = 0
            while x < w:
                n = data[pos]
                pos += 1
                if n > 128:  # a run
                    n -= 128
                    if x + n > w:
                        raise ValueError("bad RGBE run")
                    line[c, x:x + n] = data[pos]
                    pos += 1
                else:        # a dump
                    if n == 0 or x + n > w:
                        raise ValueError("bad RGBE dump")
                    line[c, x:x + n] = np.frombuffer(data, np.uint8, n, pos)
                    pos += n
                x += n
        return line.T, pos
    if pos + 4 * w > len(data):
        raise ValueError("truncated RGBE data")
    return np.frombuffer(data, np.uint8, 4 * w, pos).reshape(w, 4), pos + 4 * w


def read_hdr(data):
    """Radiance .hdr bytes -> float32 [H, W, 3] RGB, decoded as OpenCV
    decodes RGBE: m * 2^(e - 136), 0 where e == 0."""
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance .hdr file")
    pos = 0
    while True:  # header lines up to the empty line
        end = data.index(b"\n", pos)
        line = data[pos:end].strip()
        pos = end + 1
        if line.startswith(b"FORMAT=") and line != b"FORMAT=32-bit_rle_rgbe":
            raise NotImplementedError(f"Radiance {line.decode()} is not decoded")
        if not line and end > 0:
            break
    end = data.index(b"\n", pos)
    dims = data[pos:end].split()
    pos = end + 1
    if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
        raise NotImplementedError(
            f"Radiance orientation {b' '.join(dims).decode()!r}: only "
            "'-Y H +X W' is decoded")
    h, w = int(dims[1]), int(dims[3])
    rgbe = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        rgbe[y], pos = _rgbe_scanline(data, pos, w)
    e = rgbe[..., 3].astype(np.int32)
    f = np.ldexp(1.0, e - 136).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * f[..., None]
    return np.where((e > 0)[..., None], out, np.float32(0.0)).astype(np.float32)


# ---------------------------------------------------------------------------
# OpenEXR
# ---------------------------------------------------------------------------

_EXR_NONE, _EXR_ZIPS, _EXR_ZIP = 0, 2, 3
_EXR_HALF, _EXR_FLOAT = 1, 2
_EXR_DTYPE = {_EXR_HALF: np.dtype("<f2"), _EXR_FLOAT: np.dtype("<f4")}
_EXR_LINES = {_EXR_NONE: 1, _EXR_ZIPS: 1, _EXR_ZIP: 16}


def _cstr(data, pos):
    end = data.index(b"\0", pos)
    return data[pos:end].decode("latin-1"), end + 1


def _exr_header(data):
    magic, version = struct.unpack("<ii", data[:8])
    if magic != EXR_MAGIC:
        raise ValueError("not an OpenEXR file")
    if version & 0x200:
        raise NotImplementedError("tiled OpenEXR files are not decoded")
    if version & 0x1800:
        raise NotImplementedError("deep or multi-part OpenEXR files are "
                                  "not decoded")
    pos, attrs = 8, {}
    while data[pos] != 0:
        name, pos = _cstr(data, pos)
        typ, pos = _cstr(data, pos)
        size, = struct.unpack("<i", data[pos:pos + 4])
        attrs[name] = (typ, data[pos + 4:pos + 4 + size])
        pos += 4 + size
    return attrs, pos + 1


def _exr_channels(body):
    chans, pos = [], 0
    while body[pos] != 0:
        name, pos = _cstr(body, pos)
        ptype, _, xs, ys = struct.unpack("<iB3xii", body[pos:pos + 16])
        pos += 16
        if ptype not in _EXR_DTYPE:
            raise NotImplementedError(f"OpenEXR channel '{name}' of pixel "
                                      f"type {ptype}: only HALF and FLOAT")
        if (xs, ys) != (1, 1):
            raise NotImplementedError("sub-sampled OpenEXR channels are not "
                                      "decoded")
        chans.append((name, _EXR_DTYPE[ptype]))
    return chans


def _exr_unzip(block, n_bytes):
    """A ZIP / ZIPS block -> its raw bytes: inflate, undo the predictor,
    then the interleave of the two halves."""
    if len(block) >= n_bytes:  # stored raw: it did not compress
        return block
    d = np.frombuffer(zlib.decompress(block), np.uint8).astype(np.int64)
    if d.size != n_bytes:
        raise ValueError("OpenEXR ZIP block size")
    # the predictor: t[0] = d[0], t[i] = t[i-1] + d[i] - 128 (mod 256)
    d[1:] -= 128
    t = (np.cumsum(d) & 0xFF).astype(np.uint8)
    half = (n_bytes + 1) // 2
    out = np.empty(n_bytes, np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def read_exr(data):
    """OpenEXR bytes (single part, scanlines, NONE / ZIPS / ZIP) -> float32
    [H, W, 3] RGB; A is dropped, Y alone is replicated."""
    attrs, pos = _exr_header(data)
    comp = attrs["compression"][1][0]
    if comp not in _EXR_LINES:
        raise NotImplementedError(
            f"OpenEXR compression {comp}: only NONE, ZIPS and ZIP are decoded")
    chans = _exr_channels(attrs["channels"][1])
    names = [c for c, _ in chans]
    if set(names) - {"A"} == {"R", "G", "B"}:
        pick = ("R", "G", "B")
    elif set(names) - {"A"} == {"Y"}:
        pick = ("Y", "Y", "Y")
    else:
        raise NotImplementedError(
            f"OpenEXR channels {names}: only R, G, B or Y (and A) are decoded")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    lines = _EXR_LINES[comp]
    n_chunks = (h + lines - 1) // lines
    offsets = struct.unpack(f"<{n_chunks}Q", data[pos:pos + 8 * n_chunks])
    planes = {c: np.zeros((h, w), np.float32) for c, _ in chans}
    for off in offsets:
        y, size = struct.unpack("<ii", data[off:off + 8])
        block = data[off + 8:off + 8 + size]
        ny = min(lines, y1 - y + 1)
        row_bytes = sum(w * dt.itemsize for _, dt in chans)
        raw = block if comp == _EXR_NONE else _exr_unzip(block, ny * row_bytes)
        if len(raw) != ny * row_bytes:
            raise ValueError("OpenEXR block size")
        p = 0
        for r in range(ny):
            for c, dt in chans:
                planes[c][y - y0 + r] = np.frombuffer(raw, dt, w, p)
                p += w * dt.itemsize
    return np.ascontiguousarray(np.stack([planes[c] for c in pick], -1))


def _attr(name, typ, body):
    return name.encode() + b"\0" + typ.encode() + b"\0" + \
        struct.pack("<i", len(body)) + body


def write_exr(img, path):
    """Write float32 img [H, W, 3] (RGB) as a single-part scanline OpenEXR:
    uncompressed FLOAT channels B, G, R (a channel list is sorted by name),
    INCREASING_Y, one scanline per chunk behind its offset table."""
    arr = np.ascontiguousarray(np.asarray(img, np.float32)[..., :3])
    h, w = arr.shape[:2]
    chlist = b"".join(c.encode() + b"\0" + struct.pack("<iB3xii", _EXR_FLOAT,
                                                       0, 1, 1)
                      for c in ("B", "G", "R")) + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (struct.pack("<ii", EXR_MAGIC, 2)
              + _attr("channels", "chlist", chlist)
              + _attr("compression", "compression", bytes([_EXR_NONE]))
              + _attr("dataWindow", "box2i", box)
              + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder", bytes([0]))
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    # per scanline: y, byte count, then B, G, R planes of w floats each
    bgr = arr[..., ::-1].transpose(0, 2, 1).astype("<f4")  # [H, 3, W]
    size = 3 * w * 4
    first = len(header) + 8 * h
    offsets = struct.pack(f"<{h}Q", *(first + y * (8 + size) for y in range(h)))
    with open(path, "wb") as f:
        f.write(header + offsets)
        for y in range(h):
            f.write(struct.pack("<ii", y, size) + bgr[y].tobytes())
