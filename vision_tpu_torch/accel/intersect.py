"""Ray-triangle intersection by dense sweep: the plain versions of K1.

Counterpart of `vision_tpu/accel/intersect.py` (`_mt_batch`,
`recompute_bary`, `intersect_brute`, `occluded_brute`). Every ray is tested
against every triangle in blocks of 128, so [R, 128] is the largest
intermediate. prim_id indexes the original triangle array; a closest-hit
tie on t keeps the lower id. `accel/dense_isect.py` holds the CUDA kernels
that replace these on the card.
"""
from __future__ import annotations

import torch

from ..core.types import Hit

_EPS = 1e-9


def _mt_batch(o, d, p0, e1, e2):
    """Möller-Trumbore: rays [R,3] vs tris broadcastable to [R,B,3].
    Returns (t, u, v, hit_mask), each [R, B]. Component form: every
    intermediate is an [R, B] tensor."""
    def comp(a):
        return a[..., 0], a[..., 1], a[..., 2]

    ox, oy, oz = (c[..., None] for c in comp(o))
    dx, dy, dz = (c[..., None] for c in comp(d))
    p0x, p0y, p0z = comp(p0)
    e1x, e1y, e1z = comp(e1)
    e2x, e2y, e2z = comp(e2)

    # pv = d x e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    big = torch.abs(det) > _EPS
    inv_det = torch.where(
        big, 1.0 / torch.where(det == 0, torch.ones_like(det), det), 0.0)
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    # qv = tv x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    # 1e-6 barycentric slack closes shared-edge cracks
    ok = big & (u >= -1e-6) & (v >= -1e-6) & (u + v <= 1.0 + 1e-6) & (t > 0.0)
    return t, u, v, ok


def _mt_rows(ray, prim_id, tri_p0, tri_e1, tri_e2, with_t):
    """u, v (and with `with_t` t) of each ray against its own triangle
    prim_id (clamped to 0), in the sweep's arithmetic."""
    pid = torch.clamp_min(prim_id.long(), 0)
    p0x, p0y, p0z = (tri_p0[:, i][pid] for i in range(3))
    e1x, e1y, e1z = (tri_e1[:, i][pid] for i in range(3))
    e2x, e2y, e2z = (tri_e2[:, i][pid] for i in range(3))
    ox, oy, oz = ray.origin[:, 0], ray.origin[:, 1], ray.origin[:, 2]
    dx, dy, dz = (ray.direction[:, 0], ray.direction[:, 1],
                  ray.direction[:, 2])
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = torch.where(
        torch.abs(det) > _EPS,
        1.0 / torch.where(det == 0, torch.ones_like(det), det), 0.0)
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det if with_t else None
    return u, v, t


def recompute_bary(ray, prim_id, tri_p0, tri_e1, tri_e2):
    """Per-ray barycentrics of an already-found prim: one [R]-wide MT redo
    with the sweep's own arithmetic. 0 on a miss."""
    if tri_p0.shape[0] == 0:  # no triangles: every ray missed
        return torch.zeros((prim_id.shape[0], 2), dtype=ray.origin.dtype,
                           device=ray.origin.device)
    u, v, _ = _mt_rows(ray, prim_id, tri_p0, tri_e1, tri_e2, False)
    uv = torch.stack([u, v], dim=-1)
    return torch.where((prim_id >= 0)[..., None], uv, 0.0)


def recompute_hit(ray, prim_id, tri_p0, tri_e1, tri_e2):
    """(t, bary) of an already-found prim as functions of the ray, for
    autograd: `recompute_bary` plus the winner's t, t_max on a miss (as
    the sweep's where(miss, t_max, t) gives it)."""
    if tri_p0.shape[0] == 0:
        return ray.t_max, torch.zeros((prim_id.shape[0], 2),
                                      dtype=ray.origin.dtype,
                                      device=ray.origin.device)
    u, v, t = _mt_rows(ray, prim_id, tri_p0, tri_e1, tri_e2, True)
    hit = prim_id >= 0
    uv = torch.where(hit[..., None], torch.stack([u, v], dim=-1), 0.0)
    return torch.where(hit, t, ray.t_max), uv


def intersect_brute(ray, tri_p0, tri_e1, tri_e2, block=128):
    """Closest hit by dense sweep. ray fields [R, ...]; tris [T, 3].
    The sweep carries (best_t, best_id); barycentrics are recomputed for
    the winner afterwards."""
    R = ray.origin.shape[0]
    best_t = ray.t_max
    best_id = torch.full((R,), -1, dtype=torch.int32, device=ray.origin.device)
    for base in range(0, tri_p0.shape[0], block):
        sl = slice(base, base + block)
        t, _, _, ok = _mt_batch(ray.origin, ray.direction, tri_p0[sl][None],
                                tri_e1[sl][None], tri_e2[sl][None])
        t = torch.where(ok, t, torch.inf)
        tj, j = torch.min(t, dim=-1)   # first index among equal minima
        better = tj < best_t
        best_id = torch.where(better, (base + j).to(torch.int32), best_id)
        best_t = torch.where(better, tj, best_t)
    uv = recompute_bary(ray, best_id, tri_p0, tri_e1, tri_e2)
    return Hit(t=best_t, prim_id=best_id, bary=uv)


def occluded_brute(ray, tri_p0, tri_e1, tri_e2, block=128):
    """Any hit with 0 < t < t_max (shadow rays) -> [R] bool."""
    occ = torch.zeros(ray.origin.shape[0], dtype=torch.bool,
                      device=ray.origin.device)
    for base in range(0, tri_p0.shape[0], block):
        sl = slice(base, base + block)
        t, _, _, ok = _mt_batch(ray.origin, ray.direction, tri_p0[sl][None],
                                tri_e1[sl][None], tri_e2[sl][None])
        occ = occ | torch.any(ok & (t < ray.t_max[..., None]), dim=-1)
    return occ
