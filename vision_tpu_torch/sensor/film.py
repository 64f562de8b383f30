"""Film post: accumulation, tonemap, gamma, PNG and OpenEXR output.

Counterpart of `vision_tpu/sensor/film.py` (the running average, linear /
ACES Narkowicz / Reinhard tone mappers, then linear -> sRGB). The PNG and EXR writers use
the standard library's zlib and struct and numpy, nothing else.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ..scene.imageio import write_exr


def accumulate(accum_prev, frame_value, frame_index):
    """Running average: prev + (new - prev) / (n + 1) for frame n."""
    a = 1.0 / (frame_index + 1.0)
    return accum_prev + (frame_value - accum_prev) * a


def tonemap(x, mode="linear", exposure=1.0):
    x = x * exposure
    if mode == "aces":
        a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
        return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)
    if mode == "reinhard":
        return x / (x + 1.0)
    return x


def linear_to_srgb(x):
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * torch.pow(torch.clamp_min(x, 1e-8), 1.0 / 2.4)
                       - 0.055)


def _png_chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def to_png(img, path):
    """Write img [H, W, 3] in [0, 1] as an 8-bit RGB PNG: the signature,
    IHDR, one IDAT (every row with filter byte 0), IEND."""
    arr = np.asarray(img)
    arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w = arr.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(arr[..., :3]).reshape(h, w * 3)],
                         axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def to_exr(img, path):
    """Write linear img [H, W, 3] as a single-part, uncompressed scanline
    OpenEXR of FLOAT channels B, G, R (`scene/imageio.py` write_exr)."""
    write_exr(np.asarray(img, np.float32), path)
