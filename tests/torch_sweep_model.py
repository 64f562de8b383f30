"""A numpy model of the K1 kernels' loop order (`csrc/dense_isect.cu`).

It runs the sweep the way the CUDA kernels schedule it, with the constants
read from the source: `blocks` persistent blocks take chunks of 32 rays
interleaved across the grid, kChunksPerPass chunks a pass; dead rays
(t_max <= 0 or NaN) are answered at once and the live ones packed in order
into the threads' kRays slots; a warp sweeps the slots in which some lane
holds a ray, over the scene resident in shared memory (<= kTileTris
triangles) or over tiles of kTileTris re-staged per pass; the any-hit
sweep votes after every kChunk triangles and leaves once no lane of the
warp has an open ray.

The arithmetic is Möller-Trumbore in float32, one rounding per operation in
`csrc/mt.cuh`'s order, so the model's results equal the plain versions'
(`accel/intersect.py`) bit for bit. It also returns how often each ray was
written (once, for every ray) and the lane-tests the warps issued.
"""
from __future__ import annotations

import os
import re

import numpy as np

CU = os.path.join(os.path.dirname(__file__), "..", "vision_tpu_torch", "csrc",
                  "dense_isect.cu")
F = np.float32


def constants():
    """kThreads, kRays, kTileTris and kChunk as dense_isect.cu sets them."""
    with open(CU) as f:
        src = f.read()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("kThreads", "kRays", "kTileTris", "kChunk")}


def shared_bytes(n_tris):
    """Dynamic shared memory of a launch: the resident scene or one tile,
    three float4 per triangle."""
    return 48 * min(n_tris, constants()["kTileTris"])


def mt(o, d, tri):
    """Rays o, d [L, 3] against triangles tri [n, 9]: t, u, v, ok [L, n]."""
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = (tri[None, :, k]
                                                    for k in range(9))
    with np.errstate(all="ignore"):
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        big = np.abs(det) > F(1e-9)
        inv_det = np.where(big, F(1.0) / np.where(big, det, F(1.0)), F(0.0))
        tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        ok = (big & (u >= F(-1e-6)) & (v >= F(-1e-6))
              & (u + v <= F(1.000001)) & (t > F(0.0)))
    return t, u, v, ok


def sweep(o, d, tmax, tris, any_hit=False, resident=8):
    """K1 over rays o, d [R, 3], tmax [R] and triangles tris [T, 9]
    (float32), with `resident` blocks fitting on the card. Returns a dict:
    t, id, uv (closest) or occ (any hit); cover [R], the writes per ray;
    lane_tests, 32 per warp slot and triangle swept; blocks; smem."""
    c = constants()
    threads, n_rays, tile = c["kThreads"], c["kRays"], c["kTileTris"]
    warps = threads // 32
    per_pass = warps * n_rays
    o, d, tmax, tris = (np.asarray(x, F) for x in (o, d, tmax, tris))
    R, T = tmax.shape[0], tris.shape[0]
    n_chunks = (R + 31) // 32
    blocks = min(resident, n_chunks)
    out = dict(t=np.full(R, np.nan, F), id=np.full(R, -2, np.int32),
               uv=np.full((R, 2), np.nan, F), occ=np.zeros(R, bool))
    cover = np.zeros(R, np.int64)
    lane_tests = 0
    # slot k, warp w, lane: the order of the packed list
    k_, w_, lane_ = (a.ravel() for a in np.meshgrid(
        np.arange(n_rays), np.arange(warps), np.arange(32), indexing="ij"))
    for b in range(blocks):
        p = 0
        while p * per_pass * blocks + b < n_chunks:
            i = ((p * per_pass + k_ * warps + w_) * blocks + b) * 32 + lane_
            inr = i < R
            tm = np.where(inr, tmax[np.minimum(i, R - 1)], F(0.0))
            live = inr & (tm > F(0.0))
            dead = i[inr & ~live]
            out["t"][dead], out["id"][dead] = tmax[dead], -1
            out["uv"][dead], out["occ"][dead] = 0.0, False
            cover[dead] += 1
            packed = i[live]
            n_live = packed.shape[0]
            for w in range(warps):
                # slot k of lane l holds entry k * threads + 32 w + l
                m = sum(k * threads + 32 * w < n_live for k in range(n_rays))
                e = (np.arange(m)[:, None] * threads + 32 * w
                     + np.arange(32)[None]).ravel()
                rays = np.where(e < n_live, packed[np.minimum(e, n_live - 1)]
                                if n_live else -1, -1)
                lane_tests += _sweep_warp(o, d, tmax, tris, rays, any_hit,
                                          tile, c["kChunk"], out)
                cover[rays[rays >= 0]] += 1
            p += 1
    res = dict(cover=cover, lane_tests=lane_tests, blocks=blocks,
               smem=shared_bytes(T))
    if any_hit:
        res["occ"] = out["occ"]
    else:
        res.update(t=out["t"], id=out["id"], uv=out["uv"])
    return res


def _sweep_warp(o, d, tmax, tris, rays, any_hit, tile, chunk, out):
    """One warp's slots `rays` ([32 m], -1 empty) over every tile; writes
    the results into `out` and returns the lane-tests issued."""
    if rays.shape[0] == 0:
        return 0
    ok_ray = rays >= 0
    r = np.where(ok_ray, rays, 0)
    ro, rd = o[r], d[r]
    tm = np.where(ok_ray, tmax[r], F(0.0))
    best_t, best_id = tm.copy(), np.full(rays.shape, -1, np.int32)
    best_uv = np.zeros((rays.shape[0], 2), F)
    occ = ~ok_ray
    issued = 0
    for first in range(0, tris.shape[0], tile):
        tri = tris[first:first + tile]
        n = tri.shape[0]
        if any_hit:
            if occ.all():
                break
            j, done = 0, False
            while j < n:
                step = chunk if j + chunk <= n else n - j
                t, _, _, ok = mt(ro, rd, tri[j:j + step])
                occ = occ | (ok & (t < tm[:, None])).any(1)
                issued += rays.shape[0] * step
                j += step
                if step == chunk and occ.all():
                    done = True
                    break
            if done:
                break
        else:
            t, u, v, ok = mt(ro, rd, tri)
            issued += rays.shape[0] * n
            tt = np.where(ok, t, np.inf)
            j = np.argmin(tt, axis=1)  # the first of equal minima: lower id
            tj = tt[np.arange(tt.shape[0]), j]
            better = tj < best_t
            rows = np.nonzero(better)[0]
            best_t[rows] = tj[rows]
            best_id[rows] = first + j[rows]
            best_uv[rows, 0] = u[rows, j[rows]]
            best_uv[rows, 1] = v[rows, j[rows]]
    sel = rays[ok_ray]
    if any_hit:
        out["occ"][sel] = occ[ok_ray]
    else:
        out["t"][sel], out["id"][sel] = best_t[ok_ray], best_id[ok_ray]
        out["uv"][sel] = best_uv[ok_ray]
    return issued
