"""ReSTIR DI: reservoir-based spatiotemporal importance resampling.

Counterpart of `vision_tpu/integrator/restir.py`: per-pixel RIS over M light
candidates (streaming reservoir, p_hat = luminance of the unshadowed
contribution), temporal reuse validated by surface similarity, spatial
reuse over K ring neighbours, then the final visibility ray and shading.
Reservoirs are dataclass records of [N] tensors over the pixel wavefront;
weights use the unbiased 1/M RIS estimator with the JAX package's clamps.
RNG draws follow the JAX package's order.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..core import rng
from ..core.math import (coordinate_system, luminance, normalize, safe_div,
                         to_local)
from ..core.types import Ray, take
from ..lights import lights as lt
from ..shading import bsdf as ub
from ..shading.materials import gather_params
from . import pt


@dataclass
class Reservoir:
    p_light: torch.Tensor  # [N, 3] winning sample position
    Le: torch.Tensor       # [N, 3] its (unshadowed) emitted radiance
    dist: torch.Tensor     # [N] distance (occlusion t_max)
    delta: torch.Tensor    # [N] bool: delta light
    wsum: torch.Tensor     # [N]
    M: torch.Tensor        # [N] candidate count
    W: torch.Tensor        # [N] final RIS weight
    p_hat: torch.Tensor    # [N] target value of the winner at this surface

    @classmethod
    def empty(cls, n, device="cuda"):
        def z(*shape):
            return torch.zeros((n,) + shape, device=device)
        return cls(p_light=z(3), Le=z(3),
                   dist=torch.full((n,), 1e30, device=device),
                   delta=torch.zeros((n,), dtype=torch.bool, device=device),
                   wsum=z(), M=z(), W=z(), p_hat=z())


def _target_phat(gb, params, wo_l, frame, p_light, Le):
    """p_hat = luminance of the unshadowed contribution f |cos| Le."""
    t, b, ns = frame
    wi_l = to_local(t, b, ns, normalize(p_light - gb.pos))
    ev = ub.evaluate(params, wo_l, wi_l)
    contrib = ev.f * torch.abs(wi_l[..., 2])[..., None] * Le
    return torch.clamp_min(luminance(contrib), 0.0)


def _update(res, u, w, p_light, Le, dist, delta, p_hat):
    """Streaming reservoir update: take the candidate with probability
    w / wsum."""
    wsum = res.wsum + w
    take_ = (u * wsum < w) & (w > 0.0)
    tk = take_[..., None]
    return replace(
        res, p_light=torch.where(tk, p_light, res.p_light),
        Le=torch.where(tk, Le, res.Le),
        dist=torch.where(take_, dist, res.dist),
        delta=torch.where(take_, delta, res.delta),
        p_hat=torch.where(take_, p_hat, res.p_hat),
        wsum=wsum, M=res.M + 1.0)


def _finalize(res):
    """W = wsum / (M p_hat), non-finite to 0, clamped to [0, 1e6]."""
    W = safe_div(res.wsum, res.M * res.p_hat)
    W = torch.where(torch.isfinite(W), W, 0.0)
    return replace(res, W=torch.clamp(W, 0.0, 1e6))


def initial_candidates(scene, gb, state, m_light=8):
    """RIS over m_light light candidates per pixel. The wavelengths are
    drawn (under a hero spectrum) but the shading stays RGB, as in the JAX
    package. Returns (state, reservoir, (params, wo_l, frame))."""
    n = gb.pos.shape[0]
    state, _ = pt._sample_wavelengths(scene, state)
    params, _ = gather_params(scene.materials, scene.atlas, gb.mat_id, gb.uv)
    t, b = coordinate_system(gb.normal)
    wo_l = to_local(t, b, gb.normal, gb.wo)
    frame = (t, b, gb.normal)

    res = Reservoir.empty(n, gb.pos.device)
    for _ in range(m_light):
        state, u_sel = rng.next_1d(state)
        state, u2 = rng.next_2d(state)
        ls = lt.sample_wi(scene.lights, scene.atlas, scene.tri_pack,
                          gb.pos, gb.normal, u_sel, u2, scene.world_radius)
        is_delta = ls.pdf < 0.0
        pdf = torch.where(is_delta, -ls.pdf, ls.pdf)
        p_hat = _target_phat(gb, params, wo_l, frame, ls.p_light, ls.L)
        w = safe_div(p_hat, pdf)
        state, u_r = rng.next_1d(state)
        res = _update(res, u_r, w, ls.p_light, ls.L, ls.dist, is_delta, p_hat)
    return state, _finalize(res), (params, wo_l, frame)


def surface_similar(gb_a, idx_a, gb_b, idx_b, depth_tol=0.1, normal_tol=0.9):
    """Surface similarity test for reuse validation: relative depth and
    normal agreement, and a valid surface at idx_b."""
    da = gb_a.depth[idx_a]
    rel = torch.abs(da - gb_b.depth[idx_b]) / torch.clamp_min(da, 1e-3)
    nd = torch.sum(gb_a.normal[idx_a] * gb_b.normal[idx_b], -1)
    return (rel < depth_tol) & (nd > normal_tol) & gb_b.valid[idx_b]


def _merge(res, other, gb, params, wo_l, frame, u):
    """Merge another reservoir as one weighted candidate."""
    p_hat_here = _target_phat(gb, params, wo_l, frame, other.p_light,
                              other.Le)
    w = p_hat_here * other.W * other.M
    new = _update(res, u, w, other.p_light, other.Le,
                  torch.linalg.norm(other.p_light - gb.pos, dim=-1),
                  other.delta, p_hat_here)
    return replace(new, M=res.M + other.M)


def _reproject(gb, W, H):
    """(previous-frame pixel index, in-bounds mask) of each pixel through
    its motion vector."""
    pix = torch.arange(gb.pos.shape[0], device=gb.pos.device)
    px = (pix % W).to(torch.float32) + 0.5 + gb.motion[..., 0]
    py = (pix // W).to(torch.float32) + 0.5 + gb.motion[..., 1]
    ix = torch.clamp(px.to(torch.int32), 0, W - 1)
    iy = torch.clamp(py.to(torch.int32), 0, H - 1)
    in_b = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    return pix, (iy * W + ix).long(), in_b


def _ring_neighbour(state, n, W, H, radius, device):
    """(state, neighbour index) of one spatial tap: a uniform disk offset
    of `radius` pixels, truncated toward zero, clamped to the image."""
    state, u2 = rng.next_2d(state)
    ang = u2[..., 0] * 6.2831853
    rad = torch.sqrt(u2[..., 1]) * radius
    dx = (torch.cos(ang) * rad).to(torch.int32)
    dy = (torch.sin(ang) * rad).to(torch.int32)
    pix = torch.arange(n, device=device)
    nx = torch.clamp(pix % W + dx, 0, W - 1)
    ny = torch.clamp(pix // W + dy, 0, H - 1)
    return state, pix, ny * W + nx


def _shadow_ray(gb, target, dist):
    wi = normalize(target - gb.pos)
    return wi, Ray.make(pt.spawn_origin(gb.pos, gb.normal, wi), wi,
                        t_max=dist * (1.0 - 1e-3))


def restir_di(scene, gb, state, prev=None, frame_index=0, m_light=8,
              spatial_taps=4, spatial_radius=16.0, resolution=None,
              history_limit=20.0):
    """Full DI pass: candidates -> visibility -> temporal -> spatial ->
    shade. prev: (prev_reservoir, prev_gbuffer) or None (first frame).
    Returns (state, L_direct [N, 3], reservoir for the next frame: the
    temporal one; spatial reuse is shade-only)."""
    n = gb.pos.shape[0]
    W, H = resolution
    dev = gb.pos.device
    state, res, (params, wo_l, frame) = initial_candidates(
        scene, gb, state, m_light)

    # visibility of the initial winner; lanes with no surface or no winner
    # trace nothing
    _, ray = _shadow_ray(gb, res.p_light, res.dist)
    occ = pt.trace_occluded(scene, ray, act=gb.valid & (res.W > 0.0))
    res = replace(res, W=torch.where(occ, 0.0, res.W))

    if prev is not None:
        prev_res, prev_gb = prev
        pix, pidx, in_b = _reproject(gb, W, H)
        ok = in_b & surface_similar(gb, pix, prev_gb, pidx)
        pr = take(prev_res, pidx)
        pr = replace(pr, M=torch.clamp_max(pr.M, history_limit),
                     W=torch.where(ok, pr.W, 0.0))
        state, u = rng.next_1d(state)
        res = _finalize(_merge(res, pr, gb, params, wo_l, frame, u))
    res_persist = res

    for _ in range(spatial_taps):
        state, pix, nidx = _ring_neighbour(state, n, W, H, spatial_radius,
                                           dev)
        ok = surface_similar(gb, pix, gb, nidx)
        nb = take(res, nidx)
        nb = replace(nb, W=torch.where(ok, nb.W, 0.0),
                     M=torch.where(ok, nb.M, 0.0))
        state, u = rng.next_1d(state)
        res = _merge(res, nb, gb, params, wo_l, frame, u)
    res = _finalize(res)

    # final visibility + shade: L = f |cos| Le W
    wi, ray = _shadow_ray(gb, res.p_light, res.dist)
    occ = pt.trace_occluded(scene, ray, act=gb.valid & (res.W > 0.0))
    t, b, ns = frame
    wi_l = to_local(t, b, ns, wi)
    ev = ub.evaluate(params, wo_l, wi_l)
    L = ev.f * torch.abs(wi_l[..., 2])[..., None] * res.Le * res.W[..., None]
    L = torch.where((gb.valid & ~occ)[..., None], L, 0.0)
    return state, L + gb.emission, res_persist
