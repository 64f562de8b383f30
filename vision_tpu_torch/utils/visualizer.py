"""Debug visualizer: line, normal and frame overlays on rendered images.

Counterpart of `vision_tpu/utils/visualizer.py`: world-space primitives
collected on the host, projected through `sensor/gbuffer.raster_coord`
and drawn as hard lines over a numpy image.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sensor.gbuffer import raster_coord


def _project(camera, pts):
    """World points [N, 3] -> raster xy [N, 2] + in-front mask."""
    c2w = camera.c2w
    r = raster_coord(camera, torch.as_tensor(np.asarray(pts, np.float32),
                                             device=c2w.device))
    c2w = c2w.detach().cpu().numpy()
    local = (np.asarray(pts) - c2w[:3, 3]) @ c2w[:3, :3]
    return r.cpu().numpy(), local[..., 2] > 1e-4


def draw_line(img, p0, p1, color=(1.0, 0.0, 0.0)):
    """Rasterize one 2D segment into img [H, W, 3] (in-place)."""
    H, W = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    xs = np.linspace(p0[0], p1[0], n).astype(int)
    ys = np.linspace(p0[1], p1[1], n).astype(int)
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[ok], xs[ok]] = color
    return img


class Visualizer:
    """Collects world-space debug primitives; overlays onto an image."""

    def __init__(self, camera):
        self.camera = camera
        self.segments = []   # (a, b, color)

    def add_line_segment(self, a, b, color=(1.0, 0.2, 0.2)):
        self.segments.append((np.asarray(a, np.float64),
                              np.asarray(b, np.float64), color))

    def add_normal(self, pos, normal, scale=0.1, color=(0.2, 1.0, 0.2)):
        self.add_line_segment(pos, np.asarray(pos) + np.asarray(normal) * scale,
                              color)

    def add_frame(self, pos, t, b, n, scale=0.1):
        self.add_line_segment(pos, np.asarray(pos) + np.asarray(t) * scale,
                              (1.0, 0.2, 0.2))
        self.add_line_segment(pos, np.asarray(pos) + np.asarray(b) * scale,
                              (0.2, 1.0, 0.2))
        self.add_line_segment(pos, np.asarray(pos) + np.asarray(n) * scale,
                              (0.2, 0.2, 1.0))

    def overlay(self, img):
        """Draw all primitives onto a copy of img [H, W, 3]."""
        out = np.asarray(img).copy()
        if not self.segments:
            return out
        a = np.stack([s[0] for s in self.segments])
        b = np.stack([s[1] for s in self.segments])
        pa, va = _project(self.camera, a)
        pb, vb = _project(self.camera, b)
        for i, (_, _, color) in enumerate(self.segments):
            if va[i] and vb[i]:
                draw_line(out, pa[i], pb[i], color)
        return out

    def clear(self):
        self.segments = []
