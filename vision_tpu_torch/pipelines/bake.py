"""Lightmap bake pipeline: UV unwrap -> texel rasterization -> hemisphere
radiance bake -> dilate, and the display pass that reads the bake.

Counterpart of `vision_tpu/pipelines/bake.py`:

  * unwrap (`unwrap_charts`, `unwrap_triangles`) and texel rasterization
    (`rasterize_texels`) are host numpy, the JAX package's calls one for
    one, so charts and texel maps are bit for bit the same (the unstable
    `np.argsort`, the edge map's insertion order and the float64
    projection included);
  * bake: per-texel cosine-hemisphere rays through `pt.radiance` on the
    scene's device (the dense sweep K1, or the BVH K2 above 2048
    triangles), `spp` passes accumulated in float32 in the JAX order;
  * the texel scatter (`np.add.at`) and the gutter dilation (`dilate`,
    with `np.roll`'s wrap-around) stay on the host as in the JAX package:
    a device scatter would order its atomics otherwise and change bits
    where charts meet;
  * `render_baked`: primary visibility, then emission + albedo / pi x the
    bilinear lightmap fetch (`sample_lightmap`).

Deliberate difference: for a scene without triangles `unwrap_charts`
returns four values like any other call, so the bake is an all-zero
lightmap (the JAX package's returns two, which its caller cannot unpack:
ROADMAP C4).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..core import rng, warp
from ..core.math import coordinate_system, cross, to_local, to_world
from ..core.types import Ray
from ..integrator import pt
from ..lights import lights as lt
from ..shading import bsdf as ub
from ..shading.materials import gather_params


def unwrap_charts(p0, e1, e2, lightmap_res=256, gutter=1, cos_thresh=0.88):
    """Chart-based unwrap: greedily grow charts of edge-adjacent,
    normal-aligned triangles, orthographically project each chart onto its
    seed plane, resolve projection overlaps by evicting the offending
    triangles into their own charts, and shelf-pack the chart bounding
    boxes. Returns (uv0, uv1, uv2 [T, 2] texel units, (W, H)); for T = 0
    three empty charts and (lightmap_res, 4)."""
    T = len(p0)
    if T == 0:
        return (np.zeros((0, 2), np.float32),) * 3 + ((lightmap_res, 4),)
    v0 = np.asarray(p0, np.float64)
    v1 = v0 + np.asarray(e1, np.float64)
    v2 = v0 + np.asarray(e2, np.float64)
    n = np.cross(v1 - v0, v2 - v0)
    area2 = np.linalg.norm(n, axis=-1)
    n = n / np.maximum(area2[:, None], 1e-18)

    # --- edge adjacency over the soup (vertices matched by rounding) ---
    def vkey(v):
        return tuple(np.round(v * 1e5).astype(np.int64))
    edge_map = {}
    adj = [[] for _ in range(T)]
    for t in range(T):
        vs = (vkey(v0[t]), vkey(v1[t]), vkey(v2[t]))
        for a, b in ((0, 1), (1, 2), (2, 0)):
            k = (min(vs[a], vs[b]), max(vs[a], vs[b]))
            o = edge_map.get(k)
            if o is not None and o != t:
                adj[t].append(o)
                adj[o].append(t)
            else:
                edge_map[k] = t
    # --- greedy normal-aligned chart growth (BFS) ---
    chart_of = np.full(T, -1, np.int64)
    charts = []
    order = np.argsort(-area2)  # big triangles seed first
    for seed in order:
        if chart_of[seed] >= 0:
            continue
        cid = len(charts)
        members = [seed]
        chart_of[seed] = cid
        nref = n[seed]
        queue = [seed]
        while queue:
            t = queue.pop()
            for o in adj[t]:
                if chart_of[o] < 0 and float(n[o] @ nref) > cos_thresh:
                    chart_of[o] = cid
                    members.append(o)
                    queue.append(o)
        charts.append(members)

    # --- project each chart onto its seed plane; evict overlaps ---
    uv = np.zeros((T, 3, 2), np.float64)
    final_members = []
    for members in charts:
        while members:
            nref = n[members[0]]
            t_ax = np.zeros(3)
            t_ax[np.argmin(np.abs(nref))] = 1.0
            bx = np.cross(nref, t_ax)
            bx /= max(np.linalg.norm(bx), 1e-12)
            by = np.cross(nref, bx)
            P = np.stack([bx, by], -1)        # [3, 2]
            tri2 = np.stack([v0[members] @ P, v1[members] @ P,
                             v2[members] @ P], 1)   # [m, 3, 2]
            # coarse occupancy: evict tris whose projected bbox overlaps
            # an earlier member's (folded geometry with equal normals)
            keep, evict = [], []
            boxes = []
            for i, t in enumerate(members):
                lo = tri2[i].min(0)
                hi = tri2[i].max(0)
                clash = False
                for (lo2, hi2) in boxes:
                    ol = np.minimum(hi, hi2) - np.maximum(lo, lo2)
                    if (ol > 1e-9).all() and (
                            min(ol[0], ol[1])
                            > 0.25 * max(1e-12, min(hi[0] - lo[0],
                                                    hi[1] - lo[1]))):
                        clash = True
                        break
                if clash and len(keep):
                    evict.append(t)
                else:
                    keep.append(t)
                    boxes.append((lo, hi))
            idx = [members.index(t) for t in keep]
            uv[keep] = tri2[idx] - tri2[idx].min(axis=(0, 1))
            final_members.append(keep)
            members = evict  # evicted tris re-chart among themselves

    # --- scale to texels + shelf-pack chart boxes ---
    sizes = np.array([[uv[m].reshape(-1, 2)[:, k].max() for k in (0, 1)]
                      for m in final_members])
    total_area = float(np.sum(np.maximum(sizes[:, 0], 1e-6)
                              * np.maximum(sizes[:, 1], 1e-6)))
    usable = (lightmap_res ** 2) * 0.7
    scale = np.sqrt(usable / max(total_area, 1e-12))
    wt = np.maximum(np.ceil(sizes[:, 0] * scale).astype(int)
                    + 2 * gutter, 2)
    ht = np.maximum(np.ceil(sizes[:, 1] * scale).astype(int)
                    + 2 * gutter, 2)
    corder = np.argsort(-ht)
    x = y = shelf_h = 0
    pos = np.zeros((len(final_members), 2), int)
    for i in corder:
        if x + wt[i] > lightmap_res:
            x = 0
            y += shelf_h
            shelf_h = 0
        pos[i] = (x, y)
        x += wt[i]
        shelf_h = max(shelf_h, ht[i])
    res_y = int(2 ** np.ceil(np.log2(max(y + shelf_h, 4))))

    out = np.zeros((T, 3, 2), np.float32)
    for ci, m in enumerate(final_members):
        out[m] = (uv[m] * scale + pos[ci] + gutter).astype(np.float32)
    return out[:, 0], out[:, 1], out[:, 2], (lightmap_res, res_y)


def unwrap_triangles(p0, e1, e2, lightmap_res=256, gutter=1):
    """Shelf-pack per-triangle planar charts. Returns per-triangle chart
    data: uv0/uv1/uv2 [T, 2] in texel units, plus the atlas resolution."""
    T = len(p0)
    # planar basis per triangle
    l1 = np.linalg.norm(e1, axis=-1)
    u1 = e1 / np.maximum(l1[:, None], 1e-12)
    e2_par = np.sum(e2 * u1, -1)
    e2_perp_v = e2 - e2_par[:, None] * u1
    l2p = np.linalg.norm(e2_perp_v, axis=-1)
    # 2D verts: (0,0), (l1, 0), (e2_par, l2p)
    w = np.maximum(l1, np.maximum(e2_par, 1e-6))
    h = np.maximum(l2p, 1e-6)

    # scale world units -> texels so total area fits the atlas
    total_area = float(np.sum(w * h))
    usable = (lightmap_res ** 2) * 0.5
    scale = np.sqrt(usable / max(total_area, 1e-12))
    wt = np.maximum(np.ceil(w * scale).astype(int) + 2 * gutter, 2)
    ht = np.maximum(np.ceil(h * scale).astype(int) + 2 * gutter, 2)

    # shelf packing (sorted by height)
    order = np.argsort(-ht)
    x = y = shelf_h = 0
    pos = np.zeros((T, 2), int)
    for i in order:
        if x + wt[i] > lightmap_res:
            x = 0
            y += shelf_h
            shelf_h = 0
        pos[i] = (x, y + 0)
        x += wt[i]
        shelf_h = max(shelf_h, ht[i])
    needed_h = y + shelf_h
    res_y = int(2 ** np.ceil(np.log2(max(needed_h, 4))))

    base = pos + gutter
    uv0 = base.astype(np.float32)
    uv1 = uv0 + np.stack([l1 * scale, np.zeros(T)], -1).astype(np.float32)
    uv2 = uv0 + np.stack([e2_par * scale, l2p * scale], -1).astype(np.float32)
    return uv0, uv1, uv2, (lightmap_res, res_y)


def rasterize_texels(uv0, uv1, uv2, atlas_res):
    """Texel -> (tri, b1, b2) maps, host numpy; returns flat arrays
    (tri, tx, ty, b1, b2) of the covered texels."""
    W, H = atlas_res
    tri_ids, txs, tys, b1s, b2s = [], [], [], [], []
    for t in range(len(uv0)):
        a, b, c = uv0[t], uv1[t], uv2[t]
        lo = np.floor(np.minimum(np.minimum(a, b), c)).astype(int) - 1
        hi = np.ceil(np.maximum(np.maximum(a, b), c)).astype(int) + 1
        lo = np.maximum(lo, 0)
        hi = np.minimum(hi, [W - 1, H - 1])
        if (hi < lo).any():
            continue
        xs = np.arange(lo[0], hi[0] + 1)
        ys = np.arange(lo[1], hi[1] + 1)
        gx, gy = np.meshgrid(xs, ys)
        px = gx.ravel() + 0.5
        py = gy.ravel() + 0.5
        d = np.stack([px - a[0], py - a[1]], -1)
        m = np.stack([b - a, c - a], -1)  # [2, 2] columns
        det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
        if abs(det) < 1e-9:
            continue
        inv = np.array([[m[1, 1], -m[0, 1]], [-m[1, 0], m[0, 0]]]) / det
        bb = d @ inv.T
        b1, b2 = bb[:, 0], bb[:, 1]
        inside = (b1 >= -0.05) & (b2 >= -0.05) & (b1 + b2 <= 1.05)
        if not inside.any():
            continue
        tri_ids.append(np.full(inside.sum(), t))
        txs.append(gx.ravel()[inside])
        tys.append(gy.ravel()[inside])
        b1s.append(np.clip(b1[inside], 0, 1))
        b2s.append(np.clip(b2[inside], 0, 1))
    if not tri_ids:
        return (np.zeros(0, int),) * 3 + (np.zeros(0),) * 2
    return (np.concatenate(tri_ids), np.concatenate(txs),
            np.concatenate(tys), np.concatenate(b1s), np.concatenate(b2s))


def _texel_rays(scene, tri, b1, b2):
    """(origin, normal) per texel on the scene's device: the point at
    barycentrics (b1, b2) of triangle `tri` of `tri_geom`, and the
    triangle's unit geometric normal."""
    dev = scene.tri_geom.device
    g = scene.tri_geom[torch.as_tensor(tri, dtype=torch.int64, device=dev)]
    b1_t = torch.as_tensor(b1, dtype=torch.float32, device=dev)
    b2_t = torch.as_tensor(b2, dtype=torch.float32, device=dev)
    e1, e2 = g[:, 3:6], g[:, 6:9]
    pos = g[:, 0:3] + b1_t[:, None] * e1 + b2_t[:, None] * e2
    ng = cross(e1, e2)
    ng = ng / torch.clamp_min(torch.sqrt(torch.sum(ng * ng, -1, keepdim=True)),
                              1e-12)
    return pos, ng


def _bake_pass(scene, pos, ng, s, max_depth):
    """One cosine-hemisphere sample per texel, RNG keyed (texel, s):
    (pi x the radiance [n, 3], traced rays)."""
    n = pos.shape[0]
    st = rng.seed(torch.arange(n, dtype=torch.int64, device=pos.device),
                  s & 0xFFFFFFFF)
    st, u2 = rng.next_2d(st)
    d_local = warp.square_to_cosine_hemisphere(u2)
    t, b = coordinate_system(ng)
    d = to_world(t, b, ng, d_local)
    ray = Ray.make(pos + ng * 1e-3, d)
    # cosine-weighted: irradiance estimate = pi * mean(Li)
    L, aovs = pt.radiance(scene, ray, st, max_depth=max_depth)
    return L * math.pi, aovs["nrays"]


def bake_lightmap(scene, lightmap_res=128, spp=16, max_depth=4, seed=0,
                  stats=None):
    """Bake irradiance lightmaps for the whole scene's triangles.
    Returns (lightmap [H, W, 3] numpy float32, per-tri uv charts). If
    `stats` is a dict, the host seconds of unwrap + rasterization
    (`host_s`), the seconds of the `spp` device passes up to their copy to
    the host (`bake_s`), the covered texels (`lanes`) and the traced rays
    (`nrays`) are put in it."""
    t0 = time.perf_counter()
    g = scene.tri_geom.detach().cpu().numpy()
    p0, e1, e2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    uv0, uv1, uv2, (W, H) = unwrap_charts(p0, e1, e2, lightmap_res)
    tri, tx, ty, b1, b2 = rasterize_texels(uv0, uv1, uv2, (W, H))
    n = len(tri)
    t1 = time.perf_counter()
    if stats is not None:
        stats.update(host_s=t1 - t0, bake_s=0.0, lanes=n, nrays=0)
    if n == 0:
        return np.zeros((H, W, 3), np.float32), (uv0, uv1, uv2)

    pos, ng = _texel_rays(scene, tri, b1, b2)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=pos.device)
    nrays = 0
    for s in range(spp):
        L, nr = _bake_pass(scene, pos, ng, seed * 131 + s, max_depth)
        acc = acc + L
        nrays = nrays + nr
    acc = (acc / spp).cpu().numpy()
    if stats is not None:
        stats.update(bake_s=time.perf_counter() - t1, nrays=int(nrays))

    lm = np.zeros((H, W, 3), np.float32)
    cnt = np.zeros((H, W), np.float32)
    np.add.at(lm, (ty, tx), acc)
    np.add.at(cnt, (ty, tx), 1.0)
    lm = lm / np.maximum(cnt[..., None], 1.0)
    lm = dilate(lm, cnt > 0)
    return lm, (uv0, uv1, uv2)


def dilate(lm, covered, iterations=2):
    """Gutter dilation: fill uncovered texels from covered neighbours
    (`np.roll` wraps around the atlas edges, as in the JAX package)."""
    lm = lm.copy()
    cov = covered.copy()
    for _ in range(iterations):
        acc = np.zeros_like(lm)
        cnt = np.zeros(lm.shape[:2], np.float32)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                sh = np.roll(np.roll(lm, dy, 0), dx, 1)
                sc = np.roll(np.roll(cov, dy, 0), dx, 1)
                acc += sh * sc[..., None]
                cnt += sc
        fill = (~cov) & (cnt > 0)
        lm[fill] = acc[fill] / cnt[fill][:, None]
        cov = cov | fill
    return lm


def sample_lightmap(lm, uv0, uv1, uv2, tri_id, b1, b2):
    """Baked irradiance at a surface point, bilinear (the display shader's
    fetch). Tensors on one device; tri_id is clamped by the caller."""
    H, W = lm.shape[:2]
    tri_id = tri_id.long()
    u0 = uv0[tri_id]
    uv = (u0 + b1[..., None] * (uv1[tri_id] - u0)
          + b2[..., None] * (uv2[tri_id] - u0))
    sx = uv[..., 0] - 0.5
    sy = uv[..., 1] - 0.5
    x0 = torch.floor(sx).to(torch.int64)
    y0 = torch.floor(sy).to(torch.int64)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]

    def tap(xi, yi):
        return lm[torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]

    return (tap(x0, y0) * (1 - fx) * (1 - fy)
            + tap(x0 + 1, y0) * fx * (1 - fy)
            + tap(x0, y0 + 1) * (1 - fx) * fy
            + tap(x0 + 1, y0 + 1) * fx * fy)


class BakedLightmap:
    """The bake's product as tensors on `device`, read by `render_baked`.
    Geometry is a flattened world-space triangle soup, so the triangle id
    is the chart key."""

    def __init__(self, lm, charts, device):
        uv0, uv1, uv2 = charts
        self.lm = torch.as_tensor(np.asarray(lm, np.float32), device=device)
        self.uv0 = torch.as_tensor(uv0, device=device)
        self.uv1 = torch.as_tensor(uv1, device=device)
        self.uv2 = torch.as_tensor(uv2, device=device)


def bake_scene(scene, lightmap_res=128, spp=16, max_depth=4, seed=0,
               stats=None):
    """Full bake: a BakedLightmap on the scene's device, ready for
    render_baked."""
    lm, charts = bake_lightmap(scene, lightmap_res, spp, max_depth, seed,
                               stats)
    return BakedLightmap(lm, charts, scene.tri_geom.device)


def render_baked(scene, camera, baked, frame_index=0):
    """Display pass reading the bake: primary visibility through pixel
    centres, then emission + albedo / pi x the baked irradiance (the
    environment on a miss). Returns linear HDR [H, W, 3] on the camera's
    device."""
    W, H = camera.resolution
    dev = camera.c2w.device
    pix = torch.arange(W * H, dtype=torch.int64, device=dev)
    px = (pix % W).to(torch.float32)
    py = (pix // W).to(torch.float32)
    st = rng.seed(pix, int(frame_index) & 0xFFFFFFFF)
    st, u_film = rng.next_2d(st)  # drawn as the JAX package draws it; unused
    ray = camera.generate_ray(torch.stack([px + 0.5, py + 0.5], -1))
    hit = pt.trace_closest(scene, ray)
    pos, ng, ns, uv, inst, mat_id, light_id = pt.compute_interaction(scene,
                                                                     hit)
    params, _ = gather_params(scene.materials, scene.atlas, mat_id, uv)
    t, b = coordinate_system(ns)
    albedo = ub.albedo(params, to_local(t, b, ns, -ray.direction))

    E = sample_lightmap(baked.lm, baked.uv0, baked.uv1, baked.uv2,
                        torch.clamp_min(hit.prim_id, 0), hit.bary[..., 0],
                        hit.bary[..., 1])
    Le, _ = lt.eval_hit_area(scene.lights, light_id, ray.origin, pos, ng, uv,
                             scene.atlas)
    L = Le + albedo * E / math.pi
    env = lt.env_radiance(scene.lights, scene.atlas, ray.direction)
    L = torch.where(hit.is_hit[..., None], L, env)
    return L.reshape(H, W, 3)
