"""High-level rendering entry points.

Counterpart of `vision_tpu/render.py`: regeneration-wavefront passes of up to
WAVE_CHUNK samples, accumulated into a running-average film, then tonemap +
gamma for output.
"""
from __future__ import annotations

import time

import numpy as np

from .integrator import pt
from .scene.scene import load_scene
from .sensor import film

# samples folded into one regeneration wavefront per pass (the JAX
# package's dense-path chunk)
WAVE_CHUNK = 32


def render(scene, spp=None, verbose=False, adaptive=False, stats=None):
    """Render `spp` samples (default: the scene's output spp, else 64).
    Returns linear HDR [H, W, 3] as a float32 tensor on the scene's device.
    If `stats` is a dict, the traced-ray count ("nrays") and the number of
    wavefront iterations ("iters") are added to it.
    Adaptive sampling raises NotImplementedError (ROADMAP queue A, slice 4d).
    """
    if adaptive:
        raise NotImplementedError(
            "adaptive sampling is not ported yet: ROADMAP queue A, slice 4d")
    spp = spp or scene.output_spp or 64
    t0 = time.time()
    accum = None
    done = 0
    while done < spp:
        n = min(WAVE_CHUNK, spp - done)
        img, aovs = pt.render_wave(scene.data, scene.camera, scene.filter,
                                   done, n, scene.max_depth, scene.min_depth,
                                   scene.rr_threshold)
        if stats is not None:
            stats["nrays"] = stats.get("nrays", 0) + int(aovs["nrays"])
            stats["iters"] = stats.get("iters", 0) + aovs["iters"]
        w = n / float(done + n)
        accum = img if accum is None else accum * (1.0 - w) + img * w
        done += n
        if verbose:
            dt = time.time() - t0
            print(f"  spp {done}/{spp}  ({dt:.2f}s, {done / dt:.2f} spp/s)")
    return accum


def postprocess(scene, hdr):
    """tonemap + gamma -> display image [H, W, 3] in [0, 1] (a tensor)."""
    x = film.tonemap(hdr, scene.tone_mapper, scene.exposure)
    return film.linear_to_srgb(x)


def render_to_file(scene_path, out_path=None, spp=None, verbose=True, *,
                   device="cuda"):
    """Load, render and write an 8-bit PNG; returns the output path. The
    arguments are the JAX package's, in its order, and `device` (the card
    unless the caller asks for another). EXR output raises
    NotImplementedError (ROADMAP queue A, slice 7a)."""
    scene = load_scene(scene_path, device)
    out = out_path or scene.output_fn
    if out.lower().endswith(".exr"):
        raise NotImplementedError(
            "EXR output is not ported yet: ROADMAP queue A, slice 7a")
    img = postprocess(scene, render(scene, spp=spp, verbose=verbose))
    film.to_png(np.asarray(img.cpu()), out)
    return out
