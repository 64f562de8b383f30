"""G-buffer pass: primary visibility AOVs + motion vectors.

Counterpart of `vision_tpu/sensor/gbuffer.py`: one primary ray per pixel
giving position, depth, shading normal, albedo, emission, material id, uv,
and raster-space motion vectors against the previous frame's camera. The
real-time loop's ReSTIR passes read the surface data, SVGF the
reprojection.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import rng
from ..core.math import coordinate_system, to_local
from ..integrator import pt
from ..lights import lights as lt
from ..shading import bsdf as ub
from ..shading.materials import gather_params


@dataclass
class GBuffer:
    pos: torch.Tensor       # [N, 3]
    depth: torch.Tensor     # [N]
    normal: torch.Tensor    # [N, 3]
    albedo: torch.Tensor    # [N, 3]
    emission: torch.Tensor  # [N, 3]
    mat_id: torch.Tensor    # [N] int32
    inst_id: torch.Tensor   # [N] int32
    uv: torch.Tensor        # [N, 2]
    wo: torch.Tensor        # [N, 3]
    valid: torch.Tensor     # [N] bool (primary hit)
    motion: torch.Tensor    # [N, 2] raster-space motion vector


def raster_coord(camera, pos):
    """World position -> raster xy under `camera`."""
    W, H = camera.resolution
    R = camera.c2w[:3, :3]
    t = camera.c2w[:3, 3]
    local = (pos - t) @ R  # R^T: world to camera
    z = torch.clamp_min(local[..., 2], 1e-6)
    sx = local[..., 0] / (z * camera.tan_half_fov)
    sy = local[..., 1] / (z * camera.tan_half_fov)
    (lx, ly), (ux, uy) = camera.screen_window()
    px = (sx - lx) / (ux - lx) * W
    py = (uy - sy) / (uy - ly) * H
    return torch.stack([px, py], -1)


def compute_gbuffer(scene, camera, frame_index, prev_camera=None,
                    jitter=True):
    """One primary-visibility pass of `frame_index` (an int or a 0-dim int
    tensor). Returns a GBuffer with flat [N] layout, N = W * H."""
    W, H = camera.resolution
    n = W * H
    dev = camera.c2w.device
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    px = (pix % W).to(torch.float32)
    py = (pix // W).to(torch.float32)
    frame = torch.as_tensor(frame_index, dtype=torch.int64, device=dev)
    st = rng.seed(pix, (frame & 0xFFFFFFFF) ^ 0x51A7B0D1)
    if jitter:
        st, u = rng.next_2d(st)
    else:
        u = torch.full((n, 2), 0.5, device=dev)
    ray = camera.generate_ray(torch.stack([px, py], -1) + u)
    hit = pt.trace_closest(scene, ray)
    pos, ng, ns, uv, inst, mat_id, light_id = pt.compute_interaction(scene,
                                                                     hit)
    valid = hit.is_hit

    st, swl = pt._sample_wavelengths(scene, st)
    params, _ = gather_params(scene.materials, scene.atlas, mat_id, uv,
                              scene.spectrum, swl)
    t, b = coordinate_system(ns)
    wo = -ray.direction
    albedo = ub.albedo(params, to_local(t, b, ns, wo))
    if albedo.shape[-1] != 3:
        albedo = torch.mean(albedo, -1, keepdim=True).expand(
            albedo.shape[:-1] + (3,))

    Le, _ = lt.eval_hit_area(scene.lights, light_id, ray.origin, pos, ng, uv,
                             scene.atlas)
    emission = torch.where((light_id >= 0)[..., None], Le, 0.0)

    prev_cam = prev_camera if prev_camera is not None else camera
    prev_px = raster_coord(prev_cam, pos)
    cur_px = torch.stack([px + 0.5, py + 0.5], -1)
    motion = torch.where(valid[..., None], prev_px - cur_px, 0.0)

    return GBuffer(pos=pos, depth=torch.where(valid, hit.t, 1e30),
                   normal=torch.where(valid[..., None], ns, 0.0),
                   albedo=torch.where(valid[..., None], albedo, 0.0),
                   emission=emission, mat_id=mat_id, inst_id=inst,
                   uv=uv, wo=wo, valid=valid, motion=motion)
