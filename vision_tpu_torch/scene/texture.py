"""Texture atlas: all scene images packed into one flat tensor.

Counterpart of `vision_tpu/scene/texture.py`. Image files are decoded by
`imageio.py` (standard library, numpy and, for the serial stages of the
codecs, the port's host library; no PIL, no OpenCV, no OpenEXR) into the
arrays the JAX package's PIL / OpenCV loader gives, then linearised in
its numpy operation order, so both packages build the same atlas bit for
bit.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..core.rows import gather_rows
from .imageio import read_image


def _srgb_to_linear(x):
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def load_image(path, color_space="srgb"):
    """Load an image -> float32 RGB [H, W, 3], linearised. As the JAX
    package, the extension picks the reader (`imageio.read_image`): a
    .hdr / .exr name is taken as OpenCV reads it, whatever the content
    (no /255, no linearisation); any other name as PIL reads it, 8-bit
    data /255 and, for `color_space` "srgb", decoded from sRGB."""
    img, kind = read_image(path)
    if kind == "hdr":
        return np.ascontiguousarray(img, np.float32)
    img = np.asarray(img, np.float32) / 255.0
    if color_space == "srgb":
        img = _srgb_to_linear(img)
    return img.astype(np.float32)


class AtlasBuilder:
    """Host-side accumulation of textures; dedup by path or content."""

    def __init__(self):
        self.images = []      # list of np [H, W, 3]
        self.by_key = {}

    def add_image(self, path, color_space="srgb"):
        key = (os.path.abspath(path), color_space)
        if key in self.by_key:
            return self.by_key[key]
        idx = self.add_array(load_image(path, color_space))
        self.by_key[key] = idx
        return idx

    def add_array(self, img):
        img = np.ascontiguousarray(np.asarray(img, np.float32))
        key = ("arr", img.shape, hash(img.tobytes()))
        if key in self.by_key:
            return self.by_key[key]
        idx = len(self.images)
        self.images.append(img)
        self.by_key[key] = idx
        return idx

    def build(self, device):
        n_real = len(self.images)
        # one white dummy texel so an empty atlas keeps its shapes
        images = self.images or [np.ones((1, 1, 3), np.float32)]
        offsets, widths, heights = [], [], []
        off = 0
        for img in images:
            h, w = img.shape[:2]
            offsets.append(off)
            widths.append(w)
            heights.append(h)
            off += h * w
        data = np.concatenate([img.reshape(-1, 3) for img in images], axis=0)
        return TextureAtlas(
            data=torch.as_tensor(data, device=device),
            offset=torch.as_tensor(offsets, dtype=torch.int64, device=device),
            width=torch.as_tensor(widths, dtype=torch.int64, device=device),
            height=torch.as_tensor(heights, dtype=torch.int64, device=device),
            n_real=n_real,
        )


@dataclass
class TextureAtlas:
    data: torch.Tensor     # [N, 3] f32
    offset: torch.Tensor   # [T] int64
    width: torch.Tensor    # [T]
    height: torch.Tensor   # [T]
    n_real: int = 0

    @property
    def has_textures(self):
        return self.n_real > 0

    def sample(self, tex_id, uv):
        """Bilinear sample, repeat wrap. tex_id [...] int, uv [..., 2].
        V flipped (image row 0 = top, uv v=0 = bottom)."""
        tid = torch.clamp(tex_id.long(), 0, self.offset.shape[0] - 1)
        w = self.width[tid]
        h = self.height[tid]
        off = self.offset[tid]
        u = uv[..., 0] - torch.floor(uv[..., 0])
        v = uv[..., 1] - torch.floor(uv[..., 1])
        v = 1.0 - v
        x = u * w.float() - 0.5
        y = v * h.float() - 0.5
        x0 = torch.floor(x).long()
        y0 = torch.floor(y).long()
        fx = (x - x0.float())[..., None]
        fy = (y - y0.float())[..., None]

        def texel(xi, yi):
            # floor-mod, as jnp.mod: the result takes the divisor's sign
            return gather_rows(self.data, off + torch.remainder(yi, h) * w
                               + torch.remainder(xi, w))

        c00 = texel(x0, y0)
        c10 = texel(x0 + 1, y0)
        c01 = texel(x0, y0 + 1)
        c11 = texel(x0 + 1, y0 + 1)
        return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
                + c01 * (1 - fx) * fy + c11 * fx * fy)
