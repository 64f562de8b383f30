"""High-level rendering entry points.

Counterpart of `vision_tpu/render.py`: regeneration-wavefront passes of up to
WAVE_CHUNK samples, accumulated into a running-average film, then tonemap +
gamma for output; adaptive sampling between passes (`render_adaptive`);
the light-field frame buffer (`render_light_field`); one sample per pixel
(`_render_pass`, the SDK's progressive pass); PNG and OpenEXR output.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .integrator import adaptive as ad
from .integrator import pt
from .scene.scene import load_scene
from .sensor import film
from .sensor import light_field as lf

# samples folded into one regeneration wavefront per pass (the JAX
# package's dense-path chunk)
WAVE_CHUNK = 32


def _render_pass(scene_data, camera, filt, frame_index, max_depth, min_depth,
                 rr_threshold):
    """One sample per pixel of frame `frame_index`: (radiance [H, W, 3],
    aovs)."""
    return pt.render_sample(scene_data, camera, filt, frame_index,
                            max_depth=max_depth, min_depth=min_depth,
                            rr_threshold=rr_threshold)


def _accumulate(scene, camera, spp, verbose, stats, label="spp"):
    """Passes of up to WAVE_CHUNK samples through `camera`, averaged."""
    t0 = time.time()
    accum = None
    done = 0
    while done < spp:
        n = min(WAVE_CHUNK, spp - done)
        img, aovs = pt.render_wave(scene.data, camera, scene.filter, done, n,
                                   scene.max_depth, scene.min_depth,
                                   scene.rr_threshold)
        if stats is not None:
            stats["nrays"] = stats.get("nrays", 0) + int(aovs["nrays"])
            stats["iters"] = stats.get("iters", 0) + aovs["iters"]
        w = n / float(done + n)
        accum = img if accum is None else accum * (1.0 - w) + img * w
        done += n
        if verbose:
            dt = time.time() - t0
            print(f"  {label} {done}/{spp}  ({dt:.2f}s, {done / dt:.2f} spp/s)")
    return accum


def render(scene, spp=None, verbose=False, adaptive=False, stats=None):
    """Render `spp` samples (default: the scene's output spp, else 64).
    Returns linear HDR [H, W, 3] as a float32 tensor on the scene's device;
    for the light-field frame buffer, the [S*H, S*W, 3] mosaic of its
    views. `adaptive=True` takes `render_adaptive`. If `stats` is a dict,
    the traced-ray count ("nrays") and the number of wavefront iterations
    ("iters") are added to it (and, adaptive, its other figures)."""
    spp = spp or scene.output_spp or 64
    if scene.framebuffer_type == "light_field":
        return lf.mosaic(render_light_field(scene, spp=spp, verbose=verbose,
                                            stats=stats))
    if adaptive:
        img, st = render_adaptive(scene, spp, verbose)
        if stats is not None:
            stats.update(st)
        return img
    return _accumulate(scene, scene.camera, spp, verbose, stats)


def render_light_field(scene, spp=16, grid=None, verbose=False, stats=None):
    """The light-field frame buffer: one wavefront over the stacked
    (W, S*S*H) lane space. Returns view tiles [S, S, H, W, 3] (linear
    HDR)."""
    grid = grid or scene.lf_grid
    cam = lf.light_field_camera(scene.camera, grid)
    accum = _accumulate(scene, cam, spp, verbose, stats, "light-field spp")
    return lf.film_to_tiles(accum, scene.camera.resolution, grid)


def render_adaptive(scene, spp, verbose=False, chunk=8, min_chunks=3,
                    threshold=0.02):
    """Adaptive sampling: chunks of `chunk` samples; after `min_chunks`
    chunks a pixel whose relative standard error over its chunk means is
    below `threshold` takes no more samples. Returns (image [H, W, 3],
    stats: nrays (an exact int), mean_spp, active_frac, iters)."""
    W, H = scene.camera.resolution
    R = W * H
    dev = scene.camera.c2w.device
    state = ad.InspectorState.initial(R, dev)
    film_sum = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    smp_tot = torch.zeros((R,), dtype=torch.int64, device=dev)
    nrays, iters, done = 0, 0, 0
    t0 = time.time()
    active_frac = 1.0
    while done < spp:
        n = min(chunk, spp - done)
        conv = ad.is_converged(state, threshold, min_samples=float(min_chunks))
        budget = torch.where(conv, 0, n)
        img, aovs = pt.render_wave(scene.data, scene.camera, scene.filter,
                                   done, n, scene.max_depth, scene.min_depth,
                                   scene.rr_threshold, spp_budget=budget)
        film_sum = film_sum + aovs["film"]
        smp_tot = smp_tot + aovs["smp"]
        nrays += int(aovs["nrays"])
        iters += aovs["iters"]
        # the inspector sees chunk means, and only where a pixel sampled
        took = aovs["smp"] > 0
        chunk_mean = aovs["film"] / torch.clamp_min(
            aovs["smp"].to(torch.float32), 1.0)[..., None]
        state = ad.update_where(state, chunk_mean, took)
        done += n
        active_frac = 1.0 - float(torch.mean(conv.to(torch.float32)))
        if verbose:
            print(f"  spp {done}/{spp}  active {active_frac * 100:.1f}%  "
                  f"({time.time() - t0:.2f}s)")
    img = (film_sum / torch.clamp_min(smp_tot, 1)[..., None]).reshape(H, W, 3)
    return img, dict(nrays=nrays, iters=iters,
                     mean_spp=float(smp_tot.to(torch.float64).mean()),
                     active_frac=active_frac)


def postprocess(scene, hdr):
    """tonemap + gamma -> display image [H, W, 3] in [0, 1] (a tensor)."""
    x = film.tonemap(hdr, scene.tone_mapper, scene.exposure)
    return film.linear_to_srgb(x)


def render_to_file(scene_path, out_path=None, spp=None, verbose=True, *,
                   device="cuda"):
    """Load, render and write the image: the linear HDR render as OpenEXR
    for a `.exr` path, else the tonemapped render as an 8-bit PNG; returns
    the output path. The arguments are the JAX package's, in its order, and
    `device` (the card unless the caller asks for another)."""
    scene = load_scene(scene_path, device)
    out = out_path or scene.output_fn
    hdr = render(scene, spp=spp, verbose=verbose)
    if out.lower().endswith(".exr"):
        film.to_exr(np.asarray(hdr.cpu()), out)
    else:
        film.to_png(np.asarray(postprocess(scene, hdr).cpu()), out)
    return out
