"""Light-field frame buffer: an S x S grid of sub-aperture views.

Counterpart of `vision_tpu/sensor/light_field.py`. Each view pins the
thin lens's aperture sample to the centre of one cell of the lens's unit
square (through the camera's square-to-disk warp), so the grid sweeps the
aperture: every tile is a parallax-shifted view through another part of
the lens, and the set refocuses afterwards by shift-and-sum (`refocus`).

All views render in one wavefront: the camera presents the stacked
resolution (W, S*S*H) to the integrator (lane = (view, pixel)) and decodes
the view from the raster row.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .camera import Camera


@dataclass
class SubApertureCamera(Camera):
    """A camera over the stacked (W, S*S*H) lane space: the raster row
    encodes (view, local row); each view's aperture sample is pinned to its
    cell's centre and the `u_lens` the integrator passes is ignored.
    `base` is the per-view camera at (W, H), made once."""
    grid: int = 1
    base_h: int = 0
    base: Camera = None

    def generate_ray(self, p_film, u_lens=None):
        S, H = self.grid, self.base_h
        py = p_film[..., 1]
        view = torch.clamp(torch.floor(py / H), 0, S * S - 1)
        local = py - view * H
        v = view.to(torch.int32)
        ui = ((v % S).to(torch.float32) + 0.5) / S
        uj = ((v // S).to(torch.float32) + 0.5) / S
        pf = torch.stack([p_film[..., 0], local], -1)
        return self.base.generate_ray(pf, torch.stack([ui, uj], -1))


def light_field_camera(camera, grid):
    """Wrap a (thin-lens) camera into the stacked S x S sub-aperture lane
    space: resolution (W, grid * grid * H), one view per band of H rows."""
    W, H = camera.resolution
    S = int(grid)
    base = Camera(c2w=camera.c2w, tan_half_fov=camera.tan_half_fov,
                  lens_radius=camera.lens_radius,
                  focal_distance=camera.focal_distance, resolution=(W, H))
    return SubApertureCamera(
        c2w=camera.c2w, tan_half_fov=camera.tan_half_fov,
        lens_radius=camera.lens_radius, focal_distance=camera.focal_distance,
        resolution=(W, S * S * H), grid=S, base_h=H, base=base)


def film_to_tiles(img, base_resolution, grid):
    """Stacked film [S*S*H, W, 3] -> [S, S, H, W, 3] view tiles."""
    W, H = base_resolution
    S = int(grid)
    return img.reshape(S, S, H, W, img.shape[-1])


def mosaic(tiles):
    """[S, S, H, W, 3] -> one [S*H, S*W, 3] contact sheet."""
    S, _, H, W, C = tiles.shape
    return tiles.permute(0, 2, 1, 3, 4).reshape(S * H, S * W, C)


def refocus(tiles, shift):
    """Shift-and-sum refocus: the mean of the views, each translated by
    `shift` pixels per unit of aperture offset (0 keeps the lens's focal
    plane). Returns [H, W, 3]."""
    S = tiles.shape[0]
    out = torch.zeros(tiles.shape[2:], dtype=tiles.dtype, device=tiles.device)
    for j in range(S):
        for i in range(S):
            dx = int(round(((i + 0.5) / S - 0.5) * shift))
            dy = int(round(((j + 0.5) / S - 0.5) * shift))
            out = out + torch.roll(tiles[j, i], (dy, dx), dims=(0, 1))
    return out / (S * S)
