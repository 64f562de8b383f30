"""Wavefront path-tracing integrator.

Counterpart of `vision_tpu/integrator/pt.py` for surface transport. Per
bounce, over a whole wavefront of lanes with masks in place
of divergent control flow:

  trace closest -> [miss: env MIS, deactivate]
               -> emissive-hit MIS (weight vs previous scatter pdf)
               -> NEE: light sample + shadow ray + MIS combine
               -> BSDF sample -> Russian roulette -> next ray

MIS is the balance heuristic; primary rays carry scatter_pdf = 1e16 so
primary emission is unweighted. Every RNG draw happens in the JAX package's
order, so both packages follow the same path on a lane up to float
rounding. Python loops replace `lax.fori_loop` / `lax.while_loop`.

Traces take the kernel the scene's geometry calls for: the dense sweep
(K1) up to 2048 triangles, the BVH (K2) above, the TLAS over instances
(K3) for an instanced scene. Dead lanes trace with t_max = 0 on every
path, as the JAX package's packet path does (its dense path sweeps them,
which changes no result `_bounce` reads).

Under a hero spectrum the carry holds each lane's wavelengths (`lam`,
`lpdf`, `alive`), radiance and throughput are [R, S], a dispersive
interaction kills the secondary wavelengths, and a finished path converts
to sRGB with its own wavelengths. A scene with media (`has_media`, a
Python switch) carries each lane's medium (`med`): distance sampling
before the emissive hit, phase-function NEE with shadow transmittance,
the HG phase sample after the BSDF's, and the medium change when a path
crosses a surface (`inst_in_medium` / `inst_out_medium`); the camera
starts in the global medium.

`radiance(remat=True)` runs each bounce under
`torch.utils.checkpoint` (non-reentrant): the backward replays a bounce
instead of keeping its activations, as `jax.checkpoint` does in the JAX
package. The tables a bounce would otherwise build at its first use (the
hero rows of the material and medium tables) are built before the loop,
so the replay recomputes exactly what the forward saved; the counter RNG
is stateless and the kernels deterministic, so the replay is exact.

Differences from the JAX package, none of which changes an image:
  * lane = pixel always: the tile order and lane re-binning of the packet
    path (`_tile_order`, `_rebin_perm`) are not ported;
  * `nrays` is counted exactly in int64 (the JAX package sums in float32);
  * an srgb scene's carry has no lam / lpdf / alive entries, and a scene
    without media no `med`: those scenes issue no spectral or medium
    operation.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..accel import dense_isect, packet_isect
from ..core import rng, warp
from ..core.math import (coordinate_system, cross, dot, face_forward,
                         normalize, safe_div, to_local, to_world)
from ..core.types import Hit, Ray
from ..lights import lights as lt
from ..shading import bsdf as ub
from ..shading import medium as md
from ..shading.materials import gather_params
from ..spectra.spectrum import SampledWavelengths

RAY_OFFSET = 2e-4


def _gated(ray, act):
    """t_max, 0 on lanes outside `act` (every kernel answers them at once
    with a miss)."""
    t_max = ray.t_max if act is None else torch.where(act, ray.t_max, 0.0)
    return ray.origin.contiguous(), ray.direction.contiguous(), t_max.contiguous()


def trace_closest(scene, ray, act=None):
    """Closest hit through K3 (instanced scene), K2 (BVH) or K1 (dense
    sweep). Lanes outside `act` trace with t_max = 0 and miss; `_bounce`
    reads no result of theirs."""
    rays = _gated(ray, act)
    if scene.ipbvh is not None:
        t, pid, bary, inst = packet_isect.closest_inst(*rays, scene.ipbvh)
        return Hit(t=t, prim_id=pid, bary=bary, inst=inst)
    if scene.pbvh is not None:
        return Hit(*packet_isect.closest(*rays, scene.pbvh))
    return Hit(*dense_isect.closest(*rays, scene.tri_geom))


def trace_occluded(scene, ray, act=None):
    """Shadow-ray occlusion: [R] bool, through the any-hit kernel of the
    path `trace_closest` takes (lanes outside `act` are unoccluded)."""
    rays = _gated(ray, act)
    if scene.ipbvh is not None:
        return packet_isect.anyhit_inst(*rays, scene.ipbvh)
    if scene.pbvh is not None:
        return packet_isect.anyhit(*rays, scene.pbvh)
    return dense_isect.anyhit(*rays, scene.tri_geom)


def compute_interaction(scene, hit):
    """Surface interaction from a hit: barycentric lerp of position / uv /
    normal from the packed triangle row; shading normal aligned with the
    geometric one. On an instanced scene the row is in the winning
    instance's object space and goes to world space by its o2w (normals by
    the inverse transpose); the residual instance's transform is the
    identity and its rows carry their own ids."""
    pid = torch.clamp_min(hit.prim_id.long(), 0)
    b1 = hit.bary[..., 0]
    b2 = hit.bary[..., 1]
    b0 = 1.0 - b1 - b2
    a = scene.tri_pack[pid]
    p0 = a[..., 0:3]
    e1 = a[..., 3:6]
    e2 = a[..., 6:9]
    ns_raw = (b0[..., None] * a[..., 9:12]
              + b1[..., None] * a[..., 12:15]
              + b2[..., None] * a[..., 15:18])
    inst = a[..., 24].to(torch.int32)
    mat_id = a[..., 25].to(torch.int32)
    light_id = a[..., 26].to(torch.int32)
    if scene.ipbvh is not None:
        ti = torch.clamp_min(hit.inst.long(), 0)
        x = scene.inst_xform[ti]
        L0, L1, L2 = x[..., 0:3], x[..., 3:6], x[..., 6:9]
        N0, N1, N2 = x[..., 12:15], x[..., 15:18], x[..., 18:21]

        def lin(v):
            return v[..., 0:1] * L0 + v[..., 1:2] * L1 + v[..., 2:3] * L2

        p0 = lin(p0) + x[..., 9:12]
        e1 = lin(e1)
        e2 = lin(e2)
        ns_raw = (ns_raw[..., 0:1] * N0 + ns_raw[..., 1:2] * N1
                  + ns_raw[..., 2:3] * N2)
        si = scene.inst_scene[ti].long()
        res = si < 0
        sic = torch.clamp_min(si, 0)
        inst = torch.where(res, inst, si.to(torch.int32))
        mat_id = torch.where(res, mat_id, scene.inst_mat[sic])
        light_id = torch.where(res, light_id, scene.inst_light[sic])
    pos = p0 + b1[..., None] * e1 + b2[..., None] * e2
    ng = normalize(cross(e1, e2))
    ns = normalize(ns_raw)
    # degenerate vertex normals -> geometric
    ns_ok = torch.sum(ns_raw * ns_raw, -1) > 1e-12
    ns = torch.where(ns_ok[..., None], ns, ng)
    ns = face_forward(ns, ng)
    uv = (b0[..., None] * a[..., 18:20]
          + b1[..., None] * a[..., 20:22]
          + b2[..., None] * a[..., 22:24])
    if "nmap" in scene.materials.feats:
        ns = _normal_map(scene, a, e1, e2, ng, ns, uv, mat_id)
    return pos, ng, ns, uv, inst, mat_id, light_id


def _normal_map(scene, a, e1, e2, ng, ns, uv, mat_id):
    """The shading normal through the lane's material's tangent-space
    normal map (`normal_tex`, strength `bump_scale`) in a uv-aligned
    tangent frame (the map's x follows u; an arbitrary tangent on a
    degenerate chart), facing the geometric normal's side; lanes without a
    map keep `ns`."""
    mt = scene.materials
    mid = torch.clamp(mat_id.long(), 0, mt.normal_tex.shape[0] - 1)
    nt = mt.normal_tex[mid]
    s = mt.bump_scale[mid]
    texn = scene.atlas.sample(torch.clamp_min(nt, 0), uv) * 2.0 - 1.0
    nx = texn[..., 0] * s
    ny = texn[..., 1] * s
    nz = (1.0 - s) + s * texn[..., 2]
    duv1 = a[..., 20:22] - a[..., 18:20]
    duv2 = a[..., 22:24] - a[..., 18:20]
    det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
    T = (e1 * duv2[..., 1:2] - e2 * duv1[..., 1:2]) * torch.sign(det)[..., None]
    t_ok = (torch.abs(det) > 1e-12) & (torch.sum(T * T, -1) > 1e-16)
    T = torch.where(t_ok[..., None], T, coordinate_system(ns)[0])
    T = normalize(T - ns * dot(T, ns)[..., None])
    B = cross(ns, T)
    ns_m = normalize(T * nx[..., None] + B * ny[..., None]
                     + ns * nz[..., None])
    return torch.where((nt >= 0)[..., None], face_forward(ns_m, ng), ns)


def spawn_origin(pos, ng, w, factor=1.0):
    """Offset a ray origin along the geometric normal, proportionally to
    the position's magnitude, scaled by ray_offset_factor."""
    s = torch.sign(dot(w, ng))[..., None]
    mag = torch.clamp_min(torch.amax(torch.abs(pos), dim=-1), 1.0)
    return pos + ng * s * (RAY_OFFSET * factor * mag)[..., None]


def _bounce(scene, off_factor, min_depth, rr_threshold, depth, c,
            include_primary=True):
    """One wavefront bounce: trace + [medium] + shade + NEE + BSDF / phase
    sample + RR. `depth` is a per-lane int tensor; all depth comparisons
    are elementwise. Without `include_primary`, emission and environment
    seen directly by the first segment weigh 0 (ReSTIR GI's paths: that
    light is the DI pass's estimand). Returns a new carry dict."""
    r = Ray.make(c["o"], c["d"])
    act = c["act"]
    hit = trace_closest(scene, r, act)
    nrays = c["nrays"] + act.sum()
    L = c["L"]
    thr = c["thr"]
    st = c["st"]
    lights = scene.lights
    first = depth == 0
    S = thr.shape[-1]
    has_media = scene.has_media
    sp, swl = None, None
    if scene.spectrum.hero:
        sp = scene.spectrum
        swl = SampledWavelengths(lam=c["lam"], pdf=c["lpdf"],
                                 secondary_alive=c["alive"])

    # ---------------- miss: environment ----------------
    miss = act & hit.is_miss
    env_L = lt.env_radiance(lights, scene.atlas, c["d"], sp, swl)
    env_pdf = lt.env_pdf_wi(lights, c["d"])
    w_first = 1.0 if include_primary else 0.0
    w_env = torch.where(first, w_first, warp.mis_weight(c["spdf"], env_pdf))
    L = L + torch.where(miss[..., None], thr * env_L * w_env[..., None], 0.0)

    act = act & hit.is_hit
    pos, ng, ns, uv, inst, mat_id, light_id = compute_interaction(scene, hit)
    wo = -c["d"]

    # ---------------- medium distance sampling ----------------
    # medium-scatter lanes take phase NEE and an HG sample instead of the
    # surface's emission and material
    act_surface = act
    if has_media:
        med_id = c["med"]
        in_med = med_id >= 0
        sigma_t, sigma_s, g_med = md.gather_spectral(scene.mediums, med_id,
                                                     sp, swl)
        sigma_t = torch.where(in_med[..., None], sigma_t, 0.0)
        sigma_s = torch.where(in_med[..., None], sigma_s, 0.0)
        st, t_med, samp_raw, w_surf, w_med = md.sample_distance(
            st, sigma_t, hit.t, S)
        samp_med = act & in_med & samp_raw
        w = torch.where(samp_med[..., None], w_med * sigma_s,
                        torch.where((act & in_med)[..., None], w_surf, 1.0))
        thr = thr * w
        pos_med = r.at(t_med)
        act_surface = act & ~samp_med

    # ---------------- emissive hit MIS ----------------
    Le, l_pdf = lt.eval_hit_area(lights, light_id, c["o"], pos, ng, uv,
                                 scene.atlas, sp, swl)
    w_hit = torch.where(first, w_first, warp.mis_weight(c["spdf"], l_pdf))
    hit_light = act_surface & (light_id >= 0)
    L = L + torch.where(hit_light[..., None], thr * Le * w_hit[..., None], 0.0)

    # ---------------- material params + shading frame ----------------
    # |n.wo| only for a fresnel-driven colour: other scenes issue no op
    cos_wo = (torch.abs(dot(ns, wo)) if "fresmix" in scene.materials.feats
              else None)
    params, dispersive = gather_params(scene.materials, scene.atlas, mat_id,
                                       uv, sp, swl, cos_wo=cos_wo)
    if sp is not None:
        # dispersion: a dispersive interaction kills the secondaries
        swl = swl.terminate_secondary(act & dispersive)
    t, b = coordinate_system(ns)
    wo_l = to_local(t, b, ns, wo)

    # first-bounce AOVs (a spectral albedo enters as its mean)
    aov = (first & act)[..., None]
    alb3 = ub.albedo(params, wo_l)
    if alb3.shape[-1] != 3:
        alb3 = torch.mean(alb3, -1, keepdim=True).expand(
            alb3.shape[:-1] + (3,))
    alb = torch.where(aov, alb3, c["alb"])
    nrm = torch.where(aov, ns, c["nrm"])

    # ---------------- NEE ----------------
    nee_pos = pos
    if has_media:
        nee_pos = torch.where(samp_med[..., None], pos_med, pos)
    st, u_sel = rng.next_1d(st)
    st, u_l2 = rng.next_2d(st)
    ls = lt.sample_wi(lights, scene.atlas, scene.tri_pack, nee_pos, ns, u_sel,
                      u_l2, scene.world_radius, sp, swl)
    shadow_o = spawn_origin(pos, ng, ls.wi, off_factor)
    if has_media:
        shadow_o = torch.where(samp_med[..., None], pos_med, shadow_o)
    shadow_ray = Ray.make(shadow_o, ls.wi, t_max=ls.dist * (1.0 - 1e-3))
    wi_l_nee = to_local(t, b, ns, ls.wi)
    nee_eval = ub.evaluate(params, wo_l, wi_l_nee)
    f_nee = nee_eval.f * torch.abs(wi_l_nee[..., 2])[..., None]
    nee_pdf = nee_eval.pdf
    if has_media:
        # phase-function NEE on medium-scatter lanes (no cosine)
        p_hg = md.hg_phase(dot(wo, ls.wi), g_med)
        f_nee = torch.where(samp_med[..., None], p_hg[..., None], f_nee)
        nee_pdf = torch.where(samp_med, p_hg, nee_pdf)
    if any(lights.has(k) for k in ("point", "spot", "proj", "dir")):
        # a delta light's sample carries pdf = -pmf: no MIS for it
        is_delta = ls.pdf < 0.0
        l_pdf_pos = torch.where(is_delta, -ls.pdf, ls.pdf)
        w_nee = torch.where(is_delta, 1.0, warp.mis_weight(l_pdf_pos, nee_pdf))
    else:
        l_pdf_pos = ls.pdf
        w_nee = warp.mis_weight(l_pdf_pos, nee_pdf)
    nee_pre = (act & (l_pdf_pos > 0.0) & (nee_pdf >= 0.0)
               & (torch.amax(torch.abs(ls.L * f_nee), dim=-1) > 0.0))
    occ = trace_occluded(scene, shadow_ray, nee_pre)
    # ray accounting as the JAX package's: its BVH paths skip gated shadow
    # lanes, its dense sweep counts every active lane
    dense = scene.pbvh is None and scene.ipbvh is None
    nrays = nrays + (act if dense else nee_pre).sum()
    nee_ok = nee_pre & ~occ
    Ld = ls.L * f_nee * safe_div(w_nee, l_pdf_pos)[..., None]
    if has_media:
        Ld = Ld * md.transmittance(sigma_t, ls.dist, in_med)
    L = L + torch.where(nee_ok[..., None], thr * Ld, 0.0)

    # ---------------- BSDF / phase sample ----------------
    st, bs = ub.sample(params, wo_l, st)
    wi_world = to_world(t, b, ns, bs.wi)
    f_cos = bs.ev.f * torch.abs(bs.wi[..., 2])[..., None]
    ratio = torch.where(bs.valid[..., None],
                        f_cos * safe_div(1.0, bs.ev.pdf)[..., None], 0.0)
    spdf = bs.ev.pdf
    valid = bs.valid
    if has_media:
        st, u_hg = rng.next_2d(st)
        wi_hg, pdf_hg = md.hg_sample(wo, g_med, u_hg)
        wi_world = torch.where(samp_med[..., None], wi_hg, wi_world)
        ratio = torch.where(samp_med[..., None], 1.0, ratio)  # f == pdf
        spdf = torch.where(samp_med, pdf_hg, spdf)
        valid = valid | samp_med
    new_thr = thr * ratio
    act = act & valid & (torch.amax(new_thr, dim=-1) > 0.0)

    # ---------------- russian roulette ----------------
    eta = c["eta"] * bs.eta_scale
    lum = torch.amax(thr, dim=-1)
    st, u_rr = rng.next_1d(st)
    do_rr = (eta * lum < rr_threshold) & (depth >= min_depth)
    q = torch.clamp_max(lum, 0.95)
    kill = do_rr & (q < u_rr)
    new_thr = torch.where((do_rr & ~kill)[..., None],
                          new_thr * safe_div(1.0, q)[..., None], new_thr)
    act = act & ~kill

    out = dict(c)  # pass through keys owned by the caller
    new_o = spawn_origin(pos, ng, wi_world, off_factor)
    if has_media:
        new_o = torch.where(samp_med[..., None], pos_med, new_o)
        # the medium changes where the path crosses the surface
        crossed = ~samp_med & (dot(wi_world, ng) * dot(wo, ng) < 0.0)
        entering = dot(wi_world, ng) < 0.0
        il = inst.long()
        trans_med = torch.where(entering, scene.inst_in_medium[il],
                                scene.inst_out_medium[il])
        out["med"] = torch.where(act & crossed, trans_med, med_id)
    if sp is not None:
        out["alive"] = swl.secondary_alive
    out.update(o=new_o, d=wi_world, L=L, thr=new_thr, spdf=spdf, act=act,
               eta=eta, st=st, alb=alb, nrm=nrm, nrays=nrays)
    return out


def _init_carry(scene, ray, state, swl):
    """The wavefront's starting carry: throughput 1 and radiance 0 over
    S channels, the wavelengths under a hero spectrum, the camera's
    medium in a scene with media."""
    R = ray.origin.shape[0]
    S = scene.spectrum.dims
    dev = ray.origin.device
    f32 = dict(dtype=torch.float32, device=dev)
    c = dict(o=ray.origin, d=ray.direction,
             L=torch.zeros((R, S), **f32), thr=torch.ones((R, S), **f32),
             spdf=torch.full((R,), 1e16, **f32),
             act=torch.ones((R,), dtype=torch.bool, device=dev),
             eta=torch.ones((R,), **f32), st=state,
             alb=torch.zeros((R, 3), **f32), nrm=torch.zeros((R, 3), **f32),
             nrays=torch.zeros((), dtype=torch.int64, device=dev))
    if swl is not None:
        c.update(alive=swl.secondary_alive, lam=swl.lam, lpdf=swl.pdf)
    if scene.has_media:
        c["med"] = torch.full((R,), scene.camera_medium, dtype=torch.int64,
                              device=dev)
    return c


def _prepare(scene):
    """Build the row tables a bounce reads that are made at first use (the
    hero rows), from the scene's current parameter leaves."""
    if scene.spectrum.hero:
        scene.materials.hero_rows(scene.spectrum)
        if scene.has_media:
            scene.mediums.hero_rows(scene.spectrum)


def _sample_wavelengths(scene, state):
    """(state, SampledWavelengths or None): one draw under a hero
    spectrum, none in the srgb mode."""
    if not scene.spectrum.hero:
        return state, None
    return scene.spectrum.sample_wavelengths(state)


def _to_srgb(scene, c):
    """A carry's radiance as linear sRGB with its lanes' own wavelengths;
    non-finite values to 0."""
    if scene.spectrum.hero:
        L = scene.spectrum.to_srgb(c["L"], SampledWavelengths(
            lam=c["lam"], pdf=c["lpdf"], secondary_alive=c["alive"]))
    else:
        L = c["L"]
    return torch.where(torch.isfinite(L), L, 0.0)


def radiance(scene, ray, state, max_depth=16, min_depth=0, rr_threshold=1.0,
             remat=False, include_primary=True):
    """Estimate L for a wavefront of rays, bounce-major: the wavelengths
    are drawn first (hero spectrum). With `remat`, each bounce is
    checkpointed: the backward replays it instead of keeping its
    activations. `include_primary=False` leaves out the light that the
    first segment sees directly (see `_bounce`). Returns (L [R, 3] linear
    sRGB, aovs dict)."""
    state, swl = _sample_wavelengths(scene, state)
    _prepare(scene)
    c = _init_carry(scene, ray, state, swl)
    R = ray.origin.shape[0]
    for k in range(max_depth):
        depth = torch.full((R,), k, dtype=torch.int64, device=ray.origin.device)
        args = (scene, scene.ray_offset, min_depth, rr_threshold, depth, c,
                include_primary)
        if remat:
            c = checkpoint(_bounce, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            c = _bounce(*args)
    return _to_srgb(scene, c), dict(albedo=c["alb"], normal=c["nrm"],
                                    nrays=c["nrays"])


def render_wave(scene, camera, filt, frame0, spp, max_depth=16, min_depth=0,
                rr_threshold=1.0, spp_budget=None):
    """Regeneration-wavefront renderer: one persistent lane per pixel; a
    finished path's lane is refilled with that pixel's next sample at once
    (new wavelengths after its film and lens samples, the camera's medium).

    `spp_budget` is an optional per-pixel [R] int sample budget <= spp
    (adaptive sampling: a converged pixel gets 0, its lane starts dead and
    costs nothing); `spp` stays the loop bound.

    The loop runs until no lane is live, bounded by
    max_iters = spp * max_depth + 4 (one lane running spp paths of
    max_depth bounces). Its condition is read on the host every iteration,
    one device sync per bounce; iterations over all-dead lanes would leave
    film and smp unchanged.

    Returns (mean radiance [H, W, 3], aovs dict incl. the traced-ray count,
    per-pixel film sum and sample counts).
    """
    W, H = camera.resolution
    R = W * H
    dev = camera.c2w.device
    pix = torch.arange(R, dtype=torch.int64, device=dev)
    px = (pix % W).to(torch.float32)
    py = (pix // W).to(torch.float32)
    p_center = torch.stack([px + 0.5, py + 0.5], dim=-1)
    frame_key = (int(frame0) * 0x9E3779B9) & 0xFFFFFFFF
    hero = scene.spectrum.hero

    def new_path(sample_idx):
        # decorrelate (pixel, frame0 + sample) streams
        st = rng.seed(pix, (frame_key + sample_idx) & 0xFFFFFFFF)
        st, u_film = rng.next_2d(st)
        offset, fw = filt.sample(u_film)
        st, u_lens = rng.next_2d(st)
        ray = camera.generate_ray(p_center + offset, u_lens)
        st, swl = _sample_wavelengths(scene, st)
        return st, ray, swl, fw

    smp = torch.zeros((R,), dtype=torch.int64, device=dev)
    st0, ray0, swl0, fw0 = new_path(smp)
    c = _init_carry(scene, ray0, st0, swl0)
    budget = spp
    if spp_budget is not None:
        budget = spp_budget.to(device=dev, dtype=torch.int64)
        c["act"] = c["act"] & (budget > 0)
    c.update(dep=torch.zeros((R,), dtype=torch.int64, device=dev), fw=fw0,
             smp=smp, film=torch.zeros((R, 3), dtype=torch.float32, device=dev))

    max_iters = spp * max_depth + 4
    it = 0
    while it < max_iters and bool(c["act"].any()):
        act_in = c["act"]
        c = _bounce(scene, scene.ray_offset, min_depth, rr_threshold,
                    c["dep"], c)
        dep = c["dep"] + 1
        act = c["act"] & (dep < max_depth)
        done = act_in & ~act

        # finished paths splat into their pixel (lane == pixel), converted
        # with their own wavelengths
        Lrgb = _to_srgb(scene, c)
        film = c["film"] + torch.where(done[..., None],
                                       Lrgb * c["fw"][..., None], 0.0)
        smp = c["smp"] + done.to(torch.int64)

        # regenerate lanes that still owe samples
        regen = done & (smp < budget)
        st_n, ray_n, swl_n, fw_n = new_path(smp)
        m = regen[..., None]
        c.update(
            o=torch.where(m, ray_n.origin, c["o"]),
            d=torch.where(m, ray_n.direction, c["d"]),
            L=torch.where(m, 0.0, c["L"]),
            thr=torch.where(m, 1.0, c["thr"]),
            spdf=torch.where(regen, 1e16, c["spdf"]),
            act=act | regen,
            eta=torch.where(regen, 1.0, c["eta"]),
            st=torch.where(regen, st_n, c["st"]),
            dep=torch.where(regen, 0, dep),
            fw=torch.where(regen, fw_n, c["fw"]),
            smp=smp, film=film)
        if hero:
            c.update(alive=torch.where(regen, swl_n.secondary_alive,
                                       c["alive"]),
                     lam=torch.where(m, swl_n.lam, c["lam"]),
                     lpdf=torch.where(m, swl_n.pdf, c["lpdf"]))
        if scene.has_media:
            c["med"] = torch.where(regen, scene.camera_medium, c["med"])
        it += 1

    img = (c["film"] / torch.clamp_min(c["smp"].to(torch.float32), 1.0)[..., None]
           ).reshape(H, W, 3)
    aovs = dict(albedo=c["alb"].reshape(H, W, 3),
                normal=c["nrm"].reshape(H, W, 3),
                nrays=c["nrays"], iters=it, film=c["film"], smp=c["smp"])
    return img, aovs


def render_sample(scene, camera, filt, frame_index, max_depth=16, min_depth=0,
                  rr_threshold=1.0):
    """One sample per pixel through the bounce-major `radiance`.
    Returns (radiance [H, W, 3], aovs)."""
    W, H = camera.resolution
    dev = camera.c2w.device
    pix = torch.arange(W * H, dtype=torch.int64, device=dev)
    p_center = torch.stack([(pix % W).to(torch.float32) + 0.5,
                            (pix // W).to(torch.float32) + 0.5], dim=-1)
    st = rng.seed(pix, int(frame_index) & 0xFFFFFFFF)
    st, u_film = rng.next_2d(st)
    offset, fw = filt.sample(u_film)
    st, u_lens = rng.next_2d(st)
    ray = camera.generate_ray(p_center + offset, u_lens)
    L, aovs = radiance(scene, ray, st, max_depth, min_depth, rr_threshold)
    img = (L * fw[..., None]).reshape(H, W, 3)
    nrays = aovs.pop("nrays")
    out_aovs = {k: v.reshape(H, W, -1) for k, v in aovs.items()}
    out_aovs["nrays"] = nrays
    return img, out_aovs
