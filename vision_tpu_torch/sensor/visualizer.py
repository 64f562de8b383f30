"""Debug visualizer: host-side line overlays on rendered frames.

Counterpart of `vision_tpu/sensor/visualizer.py`: world-space segments
are projected through the camera's raster transform and drawn as hard
lines over a numpy image (host numpy, as there). The normal whiskers and
the ray paths trace on the scene's device through `integrator/pt.py`
(the dense sweep K1, or the BVH walks K2 / K3).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rng, warp
from ..core.math import coordinate_system, to_world
from ..core.types import Ray
from ..integrator import pt


def world_to_raster(camera, pts):
    """Project world points [N, 3] -> raster xy [N, 2] + in-front mask.
    Inverts Camera.generate_ray's raster -> camera-ray mapping."""
    c2w = camera.c2w.detach().cpu().numpy()
    W, H = camera.resolution
    R = c2w[:3, :3]
    t = c2w[:3, 3]
    local = (np.asarray(pts, np.float64) - t) @ R  # world -> camera space
    z = local[..., 2]
    front = z > 1e-6
    zs = np.where(front, z, 1.0)
    sx = local[..., 0] / zs
    sy = local[..., 1] / zs
    thf = float(camera.tan_half_fov)
    (lx, ly), (ux, uy) = camera.screen_window()
    px = (sx / thf - lx) / (ux - lx) * W
    py = (uy - sy / thf) / (uy - ly) * H
    return np.stack([px, py], -1), front


def draw_segments(img, p0, p1, camera, color=(1.0, 0.2, 0.2)):
    """Draw world-space segments [N, 3]->[N, 3] over img [H, W, 3]
    (in place; returns img). Segments behind the camera are dropped."""
    H, W = img.shape[:2]
    a, fa = world_to_raster(camera, np.atleast_2d(p0))
    b, fb = world_to_raster(camera, np.atleast_2d(p1))
    col = np.asarray(color, img.dtype)
    for (ax, ay), (bx, by), ok in zip(a, b, fa & fb):
        if not ok:
            continue
        n = int(max(abs(bx - ax), abs(by - ay), 1)) + 1
        xs = np.linspace(ax, bx, n).round().astype(int)
        ys = np.linspace(ay, by, n).round().astype(int)
        m = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        img[ys[m], xs[m]] = col
    return img


def _host(x):
    return x.detach().cpu().numpy()


def overlay_normals(img, scene, camera, stride=8, scale=0.1,
                    color=(0.2, 1.0, 0.2)):
    """Draw shading-normal whiskers at every stride-th pixel's primary
    hit."""
    W, H = camera.resolution
    dev = camera.c2w.device
    xs, ys = np.meshgrid(np.arange(0, W, stride), np.arange(0, H, stride))
    p_film = torch.as_tensor(
        np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5],
                 -1).astype(np.float32), device=dev)
    ray = camera.generate_ray(p_film, torch.zeros_like(p_film))
    hit = pt.trace_closest(scene, ray)
    pos, ng, ns, uv, inst, mat_id, light_id = pt.compute_interaction(scene,
                                                                     hit)
    ok = _host(hit.prim_id) >= 0
    p0 = _host(pos)[ok]
    p1 = p0 + _host(ns)[ok] * scale
    return draw_segments(img, p0, p1, camera, color)


def overlay_rays(img, scene, camera, pixels, rng_seed=0, max_depth=3,
                 color=(1.0, 0.3, 0.1)):
    """Trace the paths of the given pixels (flat indices) and draw every
    bounce segment; paths continue diffusely (cosine hemisphere about the
    shading normal), for display only."""
    W, H = camera.resolution
    dev = camera.c2w.device
    pix = torch.as_tensor(np.asarray(pixels, np.int64), device=dev)
    px = (pix % W).to(torch.float32) + 0.5
    py = (pix // W).to(torch.float32) + 0.5
    ray = camera.generate_ray(torch.stack([px, py], -1),
                              torch.zeros((len(pix), 2), device=dev))
    st = rng.seed(pix, rng_seed & 0xFFFFFFFF)
    o = ray.origin
    d = ray.direction
    alive = np.ones(len(pix), bool)
    for depth in range(max_depth):
        hit = pt.trace_closest(scene, Ray.make(o, d))
        pos, ngs, nss, uvs, inst, mat_id, light_id = pt.compute_interaction(
            scene, hit)
        seg_ok = alive & (_host(hit.prim_id) >= 0)
        if seg_ok.any():
            draw_segments(img, _host(o)[seg_ok], _host(pos)[seg_ok], camera,
                          color)
        alive = seg_ok
        if not alive.any():
            break
        st, u = rng.next_2d(st)
        wi_l = warp.square_to_cosine_hemisphere(u)
        t_, b_ = coordinate_system(nss)
        d = to_world(t_, b_, nss, wi_l)
        o = pt.spawn_origin(pos, ngs, d)
    return img
