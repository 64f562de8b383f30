"""ReSTIR GI: reservoir resampling of one-bounce indirect paths.

Counterpart of `vision_tpu/integrator/restir_gi.py` (initial path sample ->
temporal -> spatial): a reservoir holds the reconnection vertex (sample
point, its normal, the radiance it sends toward the receiver); reuse
re-targets p_hat at the receiving surface with the solid-angle
reconnection Jacobian. Shading: L = f(wi) |cos| L_s W. A radiance cache
(SHARC or the surfel pool) replaces the traced radiance at the sample
point where it has converged.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..caches import sharc as sh
from ..caches import surfel as sf
from ..core import rng
from ..core.math import (coordinate_system, luminance, normalize, safe_div,
                         to_local, to_world)
from ..core.types import Ray, take
from ..shading import bsdf as ub
from ..shading.materials import gather_params
from . import pt
from .restir import _reproject, _ring_neighbour, surface_similar


@dataclass
class GIReservoir:
    x_s: torch.Tensor   # [N, 3] sample (reconnection) point
    n_s: torch.Tensor   # [N, 3] its normal
    L_s: torch.Tensor   # [N, 3] radiance leaving x_s toward the receiver
    wsum: torch.Tensor
    M: torch.Tensor
    W: torch.Tensor
    p_hat: torch.Tensor

    @classmethod
    def empty(cls, n, device="cuda"):
        def z(*shape):
            return torch.zeros((n,) + shape, device=device)
        return cls(x_s=z(3), n_s=z(3), L_s=z(3), wsum=z(), M=z(), W=z(),
                   p_hat=z())


def _phat(gb, params, wo_l, frame, x_s, L_s):
    t, b, ns = frame
    wi_l = to_local(t, b, ns, normalize(x_s - gb.pos))
    ev = ub.evaluate(params, wo_l, wi_l)
    f_cos = ev.f * torch.abs(wi_l[..., 2])[..., None]
    return torch.clamp_min(luminance(f_cos * L_s), 0.0)


def initial_samples(scene, gb, state, bounce_depth=2, sharc=None,
                    cam_pos=None, surfel=None):
    """One BSDF-sampled indirect path per pixel. The path's radiance
    leaves out what its first segment sees directly (the DI pass's
    estimand). With `sharc` (a SharcCache) or `surfel` (a SurfelPool) the
    cache's value replaces it where the cache has converged. Returns
    (state, reservoir, shading context, cache-update samples)."""
    n = gb.pos.shape[0]
    params, _ = gather_params(scene.materials, scene.atlas, gb.mat_id, gb.uv)
    t, b = coordinate_system(gb.normal)
    wo_l = to_local(t, b, gb.normal, gb.wo)
    frame = (t, b, gb.normal)

    state, bs = ub.sample(params, wo_l, state)
    wi = to_world(t, b, gb.normal, bs.wi)
    ray = Ray.make(pt.spawn_origin(gb.pos, gb.normal, wi), wi)
    hit = pt.trace_closest(scene, ray)
    pos, _, ns2, _, _, _, _ = pt.compute_interaction(scene, hit)
    is_hit = hit.is_hit[..., None]
    x_s = torch.where(is_hit, pos, gb.pos + wi * (2.0 * scene.world_radius))
    n_s = torch.where(is_hit, ns2, -wi)

    L_path, _ = pt.radiance(scene, ray, state, max_depth=bounce_depth,
                            include_primary=False)
    L_s = L_path
    if sharc is not None:
        L_q, ok = sh.query(sharc, x_s, n_s, cam_pos)
        L_s = torch.where((ok & hit.is_hit)[..., None], L_q, L_path)
    elif surfel is not None:
        val, wq = sf.query(surfel, x_s, n_s)
        L_q = safe_div(val, wq[..., None])
        L_s = torch.where(((wq > 0.25) & hit.is_hit)[..., None], L_q, L_path)

    p_hat = _phat(gb, params, wo_l, frame, x_s, L_s)
    src_pdf = torch.clamp_min(bs.ev.pdf, 1e-8)
    w = safe_div(p_hat, src_pdf) * bs.valid.to(torch.float32)
    ones = torch.ones((n,), device=gb.pos.device)
    res = _finalize(GIReservoir(x_s=x_s, n_s=n_s, L_s=L_s, wsum=w, M=ones,
                                W=torch.zeros_like(ones), p_hat=p_hat))
    cache_samples = (x_s, n_s, L_path, hit.is_hit & gb.valid & bs.valid)
    return state, res, (params, wo_l, frame), cache_samples


def _finalize(res):
    # W capped at 100: near-zero p_hat samples would otherwise become
    # fireflies that SVGF smears over many frames
    W = safe_div(res.wsum, res.M * res.p_hat)
    return replace(res, W=torch.clamp(torch.where(torch.isfinite(W), W, 0.0),
                                      0.0, 100.0))


def _jacobian(gb_from_pos, res_n_s, res_x_s, gb_to_pos):
    """Reconnection Jacobian between receivers: the ratio of
    |cos at the sample toward the receiver| / d^2, clamped to [0, 10]."""
    def geo(p):
        v = p - res_x_s
        d2 = torch.clamp_min(torch.sum(v * v, -1), 1e-8)
        c = torch.abs(torch.sum(normalize(v) * res_n_s, -1))
        return safe_div(c, d2)
    return torch.clamp(safe_div(geo(gb_to_pos), geo(gb_from_pos)), 0.0, 10.0)


def _merge(res, other, other_origin_pos, gb, params, wo_l, frame, u):
    p_hat_here = _phat(gb, params, wo_l, frame, other.x_s, other.L_s)
    jac = _jacobian(other_origin_pos, other.n_s, other.x_s, gb.pos)
    w = p_hat_here * other.W * other.M * jac
    wsum = res.wsum + w
    take_ = (u * wsum < w) & (w > 0.0)
    tk = take_[..., None]
    return replace(
        res, x_s=torch.where(tk, other.x_s, res.x_s),
        n_s=torch.where(tk, other.n_s, res.n_s),
        L_s=torch.where(tk, other.L_s, res.L_s),
        p_hat=torch.where(take_, p_hat_here, res.p_hat),
        wsum=wsum, M=res.M + other.M)


def restir_gi(scene, gb, state, prev=None, resolution=None, spatial_taps=2,
              spatial_radius=12.0, history_limit=16.0, bounce_depth=2,
              sharc=None, cam_pos=None, surfel=None):
    """Full GI pass. prev: (prev_reservoir, prev_gbuffer) or None.
    Returns (state, L_indirect [N, 3], reservoir for the next frame: the
    temporal one, cache-update samples (x_s, n_s, L_path, mask))."""
    n = gb.pos.shape[0]
    W_, H_ = resolution
    dev = gb.pos.device
    state, res, (params, wo_l, frame), cache_samples = initial_samples(
        scene, gb, state, bounce_depth, sharc=sharc, cam_pos=cam_pos,
        surfel=surfel)

    if prev is not None:
        prev_res, prev_gb = prev
        pix, pidx, in_b = _reproject(gb, W_, H_)
        ok = in_b & surface_similar(gb, pix, prev_gb, pidx)
        pr = take(prev_res, pidx)
        pr = replace(pr, M=torch.clamp_max(pr.M, history_limit),
                     W=torch.where(ok, pr.W, 0.0))
        state, u = rng.next_1d(state)
        res = _finalize(_merge(res, pr, prev_gb.pos[pidx], gb, params, wo_l,
                               frame, u))

    # the persistent reservoir is the temporal one: feeding spatially
    # merged reservoirs back through temporal reuse counts shared
    # neighbour history again, and the energy compounds frame over frame
    res_persist = res

    for _ in range(spatial_taps):
        state, pix, nidx = _ring_neighbour(state, n, W_, H_, spatial_radius,
                                           dev)
        ok = surface_similar(gb, pix, gb, nidx)
        nb = take(res, nidx)
        nb = replace(nb, W=torch.where(ok, nb.W, 0.0),
                     M=torch.where(ok, nb.M, 0.0))
        state, u = rng.next_1d(state)
        res = _merge(res, nb, gb.pos[nidx], gb, params, wo_l, frame, u)
    res = _finalize(res)

    # shade + reconnection visibility
    d = res.x_s - gb.pos
    wi = normalize(d)
    ray = Ray.make(pt.spawn_origin(gb.pos, gb.normal, wi), wi,
                   t_max=torch.linalg.norm(d, dim=-1) * (1.0 - 1e-3))
    occ = pt.trace_occluded(scene, ray, act=gb.valid & (res.W > 0.0))
    t, b, ns = frame
    wi_l = to_local(t, b, ns, wi)
    ev = ub.evaluate(params, wo_l, wi_l)
    L = ev.f * torch.abs(wi_l[..., 2])[..., None] * res.L_s * res.W[..., None]
    L = torch.where((gb.valid & ~occ)[..., None], L, 0.0)
    return state, L, res_persist, cache_samples
