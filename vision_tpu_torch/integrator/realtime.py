"""Real-time integrator: G-buffer + ReSTIR DI + ReSTIR GI + radiance cache +
SVGF.

Counterpart of `vision_tpu/integrator/realtime.py`: one frame is the
G-buffer pass, ReSTIR DI, ReSTIR GI (its paths query the radiance cache,
SHARC or the surfel pool), the joint-bilateral upsampling of GI when it
runs on a reduced lattice, the cache's update and resolve, then SVGF on the
surface illumination, with emission and the environment added back after
filtering. The state carried from frame to frame (DI and GI reservoirs,
the cache, SVGF's history, the previous G-buffer, the frame counter) is a
dataclass record on the scene's device.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..caches import sharc as sharc_mod
from ..caches import surfel as surfel_mod
from ..core import rng
from ..lights import lights as lt
from ..post import svgf as svgf_mod
from ..post.upsample import bilateral_upsample
from ..sensor.gbuffer import compute_gbuffer
from . import restir, restir_gi


def _gi_lattice(W, H, gi_scale):
    return max(int(W * gi_scale), 1), max(int(H * gi_scale), 1)


@dataclass
class RealTimeState:
    reservoir: object      # restir.Reservoir (DI)
    gi_reservoir: object   # restir_gi.GIReservoir
    sharc: object          # caches.sharc.SharcCache or caches.surfel.SurfelPool
    gbuffer: object        # GBuffer of the previous frame (None at first)
    svgf: object           # SVGFState
    frame: torch.Tensor    # 0-dim int64
    # the previous low-res G-buffer when GI runs on a reduced lattice
    # (gi_scale < 1): GI's temporal reuse validates against the lattice it
    # renders on
    gbuffer_gi: object = None

    @classmethod
    def initial(cls, resolution, sharc_capacity=1 << 16, base_voxel=0.05,
                cache="sharc", gi_scale=1.0, device="cuda"):
        """The state before the first frame at `resolution` (W, H) on
        `device`. cache: "sharc" (hash grid) or "surfel"; the `sharc`
        field holds whichever was chosen. gi_scale must be the one the
        frames will be rendered with."""
        W, H = resolution
        if cache == "surfel":
            c = surfel_mod.SurfelPool.create(
                sharc_capacity, cell_size=base_voxel * 3.0, device=device)
        else:
            c = sharc_mod.SharcCache.create(sharc_capacity, base_voxel,
                                            device=device)
        Wg, Hg = _gi_lattice(W, H, gi_scale)
        return cls(reservoir=restir.Reservoir.empty(W * H, device),
                   gi_reservoir=restir_gi.GIReservoir.empty(Wg * Hg, device),
                   sharc=c, gbuffer=None,
                   svgf=svgf_mod.init_state(H, W, device),
                   frame=torch.zeros((), dtype=torch.int64, device=device))


def _lane_seeds(n, salt, frame):
    pix = torch.arange(n, dtype=torch.int64, device=frame.device)
    return rng.seed(pix ^ salt, frame & 0xFFFFFFFF)


def render_realtime(scene, camera, rt_state, m_light=8, spatial_taps=2,
                    svgf_passes=3, gi=True, use_sharc=True,
                    gi_bounce_depth=2, prev_camera=None, gi_scale=1.0):
    """One real-time frame on the scene's device. Returns (display image
    [H, W, 3], new state). Pass prev_camera when the camera moved, so
    motion vectors reproject correctly.

    gi_scale < 1 renders ReSTIR GI on a reduced lattice and
    joint-bilaterally upsamples it against the full-res G-buffer; build
    the state with RealTimeState.initial(gi_scale=...) so the GI
    reservoirs match. Bilateral bleed at GI texel edges biases the energy
    (+15% on a 64^2 cbox in the JAX package), so the default stays at full
    resolution."""
    W, H = camera.resolution
    frame = rt_state.frame
    prev_cam = prev_camera if prev_camera is not None else camera

    gb = compute_gbuffer(scene, camera, frame, prev_camera=prev_cam)
    n = W * H
    st = _lane_seeds(n, 0x9E3779B9, frame)

    Wg, Hg = _gi_lattice(W, H, gi_scale)
    lowres_gi = (Wg, Hg) != (W, H)
    if lowres_gi:
        gb_gi = compute_gbuffer(scene, replace(camera, resolution=(Wg, Hg)),
                                frame, prev_camera=replace(
                                    prev_cam, resolution=(Wg, Hg)))
    else:
        gb_gi = gb
    st_gi = _lane_seeds(Wg * Hg, 0x7F4A7C15, frame)

    prev_di = prev_gi = None
    if rt_state.gbuffer is not None:
        prev_di = (rt_state.reservoir, rt_state.gbuffer)
        prev_gb_gi = rt_state.gbuffer_gi if lowres_gi else rt_state.gbuffer
        if prev_gb_gi is not None:
            prev_gi = (rt_state.gi_reservoir, prev_gb_gi)

    # ---- ReSTIR DI ----
    st, L_direct, new_res = restir.restir_di(
        scene, gb, st, prev=prev_di, frame_index=frame, m_light=m_light,
        spatial_taps=spatial_taps, resolution=(W, H))

    # ---- ReSTIR GI with the radiance cache ----
    new_gi = rt_state.gi_reservoir
    new_cache = rt_state.sharc
    cam_pos = camera.c2w[:3, 3]
    L = L_direct
    if gi:
        is_surfel = isinstance(rt_state.sharc, surfel_mod.SurfelPool)
        cache = rt_state.sharc if use_sharc else None
        _, L_ind, new_gi, cache_samples = restir_gi.restir_gi(
            scene, gb_gi, st_gi, prev=prev_gi, resolution=(Wg, Hg),
            spatial_taps=spatial_taps, bounce_depth=gi_bounce_depth,
            sharc=None if is_surfel else cache, cam_pos=cam_pos,
            surfel=cache if is_surfel else None)
        if lowres_gi:
            L_ind = bilateral_upsample(
                L_ind.reshape(Hg, Wg, 3), gb.normal.reshape(H, W, 3),
                gb.depth.reshape(H, W)).reshape(n, 3)
        if use_sharc:
            x_s, n_s, L_path, ok = cache_samples
            if is_surfel:
                new_cache = surfel_mod.spawn(rt_state.sharc, x_s, n_s, ok)
                new_cache = surfel_mod.accumulate(new_cache, x_s, L_path, ok)
            else:
                new_cache = sharc_mod.resolve(sharc_mod.update(
                    rt_state.sharc, x_s, n_s, L_path, cam_pos, ok))
        L = L_direct + L_ind

    # SVGF filters the demodulated surface illumination only: emissive
    # pixels (albedo 0) would explode under demodulation and primary-miss
    # environment pixels are not illumination; both are added back after
    # filtering
    env = lt.env_radiance(scene.lights, scene.atlas, -gb.wo)
    v3 = gb.valid[..., None]
    L_surf = torch.where(v3, L - gb.emission, 0.0)
    filtered, new_svgf = svgf_mod.svgf_filter(
        L_surf.reshape(H, W, 3), gb.albedo.reshape(H, W, 3),
        gb.normal.reshape(H, W, 3), gb.depth.reshape(H, W),
        gb.motion.reshape(H, W, 2), rt_state.svgf, n_passes=svgf_passes)
    filtered = filtered + torch.where(v3, gb.emission, env).reshape(H, W, 3)

    return filtered, RealTimeState(
        reservoir=new_res, gi_reservoir=new_gi, sharc=new_cache, gbuffer=gb,
        svgf=new_svgf, frame=frame + 1,
        gbuffer_gi=gb_gi if lowres_gi else None)
